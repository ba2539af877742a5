"""Image undistortion without OpenCV, as the EDS converter needs it.

  - `optimal_new_camera_matrix(K, D, size, alpha=0)` is
    `cv2.getOptimalNewCameraMatrix(K, D, size, alpha)`: the intrinsics
    that map the undistorted image's inscribed (alpha = 0) or
    circumscribed (alpha = 1) rectangle onto the image, and the valid
    pixels' rectangle (x, y, width, height) under them. The rectangles
    come from OpenCV's 9 x 9 grid of points, undistorted by
    `events._undistort_plumb_bob` (OpenCV's fixed-point inverse).
  - `undistort_image(img, K, D, new_K)` is `cv2.undistort(img, K, D,
    newCameraMatrix=new_K)`: each output pixel's source by the forward
    radial-tangential model with the thin prism and the tilt, rounded to
    OpenCV's 1/32 pixel, then a bilinear remap with constant-zero borders;
    8-bit images with OpenCV's 15-bit fixed-point weights, 16-bit ones in
    float32 as OpenCV remaps them. 1 or 3 channels.

The distortion is plumb_bob (radtan): 0 (none), 4, 5, 8, 12 (the thin
prism) or 14 (the tilted sensor) coefficients, as cv2 takes them.
"""

import numpy as np

from .events import (_undistort_plumb_bob, apply_homography,
                     plumb_bob_coefficients, tilt_matrices)

_GRID = 9                 # OpenCV's points per side of the image
_TAB_BITS = 5             # OpenCV's INTER_BITS: 1/32 pixel
_COEF_BITS = 15           # OpenCV's INTER_REMAP_COEF_BITS (8-bit remap)


def _undistort_rectangles(K, D, size, new_K=None):
    """OpenCV's getUndistortRectangles: the inscribed and circumscribed
    rectangles (x, y, width, height) of the undistorted 9 x 9 grid, in
    normalized coordinates (new_K None) or in pixels under new_K."""
    width, height = size
    K = np.asarray(K, np.float64)
    x, y = np.meshgrid(np.arange(_GRID) * (width - 1) / (_GRID - 1),
                       np.arange(_GRID) * (height - 1) / (_GRID - 1))
    pts = np.stack([x.ravel(), y.ravel()], axis=1)
    und = _undistort_plumb_bob(pts, K, plumb_bob_coefficients(D))
    # back to normalized coordinates (K's own projection undone)
    ny = (und[:, 1] - K[1, 2]) / K[1, 1]
    nx = (und[:, 0] - K[0, 2] - K[0, 1] * ny) / K[0, 0]
    if new_K is not None:
        P = np.asarray(new_K, np.float64)
        nx, ny = (P[0, 0] * nx + P[0, 1] * ny + P[0, 2],
                  P[1, 1] * ny + P[1, 2])
    nx, ny = nx.reshape(_GRID, _GRID), ny.reshape(_GRID, _GRID)
    inner_x0, inner_x1 = nx[:, 0].max(), nx[:, -1].min()
    inner_y0, inner_y1 = ny[0, :].max(), ny[-1, :].min()
    inner = (inner_x0, inner_y0, inner_x1 - inner_x0, inner_y1 - inner_y0)
    outer = (nx.min(), ny.min(), nx.max() - nx.min(), ny.max() - ny.min())
    return inner, outer


def optimal_new_camera_matrix(K, D, size, alpha=0.0):
    """cv2.getOptimalNewCameraMatrix(K, D, size, alpha) (new size = size,
    principal point not centred): (new K in K's dtype, valid pixels'
    rectangle (x, y, width, height) as ints)."""
    width, height = size
    K = np.asarray(K)
    inner, outer = _undistort_rectangles(K, D, size)
    M = K.astype(np.float64)
    f0 = ((width - 1) / inner[2], (height - 1) / inner[3])
    f1 = ((width - 1) / outer[2], (height - 1) / outer[3])
    M[0, 0] = f0[0] * (1 - alpha) + f1[0] * alpha
    M[1, 1] = f0[1] * (1 - alpha) + f1[1] * alpha
    M[0, 2] = -f0[0] * inner[0] * (1 - alpha) - f1[0] * outer[0] * alpha
    M[1, 2] = -f0[1] * inner[1] * (1 - alpha) - f1[1] * outer[1] * alpha
    # cv::Rect from the pixel inscribed rectangle (rounded, as cvRound),
    # clipped to the image
    inner, _ = _undistort_rectangles(K, D, size, M)
    x, y, w, h = (int(np.rint(v)) for v in inner)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, width), min(y + h, height)
    roi = (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0))
    if roi[2] == 0 or roi[3] == 0:
        roi = (0, 0, 0, 0)
    return M.astype(K.dtype), roi


def undistortion_map(K, D, new_K, size):
    """OpenCV's initUndistortRectifyMap(K, D, I, new_K, size, CV_16SC2):
    each output pixel's source position in 1/32 pixels (int64, (H, W)
    each), rounded half to even as cvRound."""
    width, height = size
    K = np.asarray(K, np.float64)
    k = plumb_bob_coefficients(D)
    inv = np.linalg.inv(np.asarray(new_K, np.float64))
    j, i = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    xh = j * inv[0, 0] + i * inv[0, 1] + inv[0, 2]
    yh = j * inv[1, 0] + i * inv[1, 1] + inv[1, 2]
    wh = j * inv[2, 0] + i * inv[2, 1] + inv[2, 2]
    x, y = xh / wh, yh / wh
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    xd = (x * kr + k[2] * xy2 + k[3] * (r2 + 2 * x2) + k[8] * r2
          + k[9] * r2 * r2)
    yd = (y * kr + k[2] * (r2 + 2 * y2) + k[3] * xy2 + k[10] * r2
          + k[11] * r2 * r2)
    if np.any(k[12:]):
        xd, yd = apply_homography(tilt_matrices(k[12], k[13])[0], xd, yd)
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    scale = 1 << _TAB_BITS
    return (np.rint(u * scale).astype(np.int64),
            np.rint(v * scale).astype(np.int64))


def remap_bilinear(img, iu, iv):
    """OpenCV's remap(img, map, INTER_LINEAR, BORDER_CONSTANT 0) on a
    fixed-point map (1/32 pixel): uint8 with 15-bit integer weights and
    round-half-up, uint16 with float32 weights and cvRound."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"undistort takes uint8 or uint16 images, got "
                         f"{img.dtype}")
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in
                                  (1, 3)):
        raise ValueError(f"undistort takes 1 or 3 channels, got shape "
                         f"{img.shape}")
    height, width = img.shape[:2]
    mask = (1 << _TAB_BITS) - 1
    x0, y0 = iu >> _TAB_BITS, iv >> _TAB_BITS
    fx, fy = iu & mask, iv & mask
    # zero border: pad one pixel, and send any source wholly outside to it
    src = np.pad(img.reshape(height, width, -1),
                 ((1, 1), (1, 1), (0, 0)))
    outside = (x0 < -1) | (x0 >= width) | (y0 < -1) | (y0 >= height)
    xp = np.where(outside, 0, x0 + 1)
    yp = np.where(outside, 0, y0 + 1)
    taps = [src[yp + dy, xp + dx] for dy in (0, 1) for dx in (0, 1)]
    scale = 1 << _TAB_BITS
    wx = ((scale - fx), fx)
    wy = ((scale - fy), fy)
    if img.dtype == np.uint8:
        # (32 - a)(32 - b) * 32 sums to 2^15 exactly: OpenCV's table
        weights = [(wy[dy] * wx[dx] * (1 << (_COEF_BITS - 2 * _TAB_BITS)))
                   [..., None] for dy in (0, 1) for dx in (0, 1)]
        acc = sum(w * t.astype(np.int64) for w, t in zip(weights, taps))
        out = (acc + (1 << (_COEF_BITS - 1))) >> _COEF_BITS
    else:
        weights = [(wy[dy] * wx[dx]).astype(np.float32)[..., None]
                   / np.float32(scale * scale)
                   for dy in (0, 1) for dx in (0, 1)]
        acc = np.zeros(taps[0].shape, np.float32)
        for w, t in zip(weights, taps):
            acc = acc + w * t.astype(np.float32)
        out = np.rint(acc)
    out = np.where(outside[..., None], 0, out)
    return out.astype(img.dtype).reshape(img.shape)


def undistort_image(img, K, D, new_K):
    """cv2.undistort(img, K, D, newCameraMatrix=new_K) for a uint8 or
    uint16 image of 1 or 3 channels."""
    height, width = np.asarray(img).shape[:2]
    iu, iv = undistortion_map(K, D, new_K, (width, height))
    return remap_bilinear(img, iu, iv)
