"""Event stream loading and packed event intervals (counterpart of
deblur_e_nerf_tpu/data/events.py).

For each event i at pixel p the packed interval is {position=pos_i,
start_ts=prev_ts(p), end_ts=t_i, num_pos=pol_i, num_neg=1-pol_i}; it is
valid iff an earlier event at p exists with a strictly smaller timestamp.
The maximum refractory period is the minimum inter-event interval over
all per-pixel substreams after de-duplicating equal timestamps. Datasets
pack with the native one-pass packer (data/native_evpack.py, C++ built at
first use) unless the caller asks for numpy (`native=False`), whose stable
sort by pixel turns the per-pixel windows into shifted-array operations;
the two agree exactly.

Event positions are undistorted in float64 numpy, following OpenCV's
`cv2.undistortPoints` (plumb_bob) and `cv2.fisheye.undistortPoints`
(equidistant) with their default criteria and P = K, which the JAX package
calls. The port's cache files are named apart from the JAX package's.
"""

import os
import time

import numpy as np

from . import native_evpack

RAW_EVENTS_FILENAME = "raw_events.npz"
CAMERA_CALIBRATION_FILENAME = "camera_calibration.npz"
PACKED_EVENTS_FILENAME = "events_torch.npz"
MAX_REFRACTORY_PERIOD_FILENAME = "max_refractory_period_torch.npy"

RAW_EVENT_POSITION_KEY = "position"
RAW_EVENT_TIMESTAMP_KEY = "timestamp"
RAW_EVENT_POLARITY_KEY = "polarity"
IMG_HEIGHT_KEY = "img_height"
IMG_WIDTH_KEY = "img_width"
DISTORTION_MODEL_KEY = "distortion_model"
DISTORTION_PARAMS_KEY = "distortion_params"
INTRINSICS_KEY = "intrinsics"
BAYER_PATTERN_KEY = "bayer_pattern"
NULL_BAYER_PATTERN = ""
COLOR_CHANNEL_NAME_TO_INDEX = {"R": 0, "G": 1, "B": 2}


def load_raw_events(root_directory):
    return np.load(os.path.join(root_directory, RAW_EVENTS_FILENAME))


def load_camera_calibration(root_directory):
    return np.load(os.path.join(root_directory, CAMERA_CALIBRATION_FILENAME),
                   allow_pickle=False)


def _pixel_runs(positions, img_width):
    """Stable-sort event indices by pixel id; (order, run-start mask)."""
    pixel_id = (positions[:, 1].astype(np.int64) * np.int64(img_width)
                + positions[:, 0].astype(np.int64))
    order = np.argsort(pixel_id, kind="stable")
    sorted_pid = pixel_id[order]
    run_start = np.empty(len(order), dtype=bool)
    if len(order):
        run_start[0] = True
        run_start[1:] = sorted_pid[1:] != sorted_pid[:-1]
    return order, run_start


def pack_events(positions, timestamps, polarities, img_height, img_width):
    """Packed intervals of a time-ordered raw (x, y, t, p) stream, in
    stream order (valid events only)."""
    if not len(positions) == len(timestamps) == len(polarities):
        raise ValueError("positions, timestamps, polarities differ in length")
    positions = positions.astype(np.int64)
    polarities = polarities.astype(np.int64)
    order, run_start = _pixel_runs(positions, img_width)
    sorted_ts = timestamps[order]
    prev_ts = np.empty_like(sorted_ts)
    if len(sorted_ts):
        prev_ts[1:] = sorted_ts[:-1]
        prev_ts[0] = sorted_ts[0]
    valid_sorted = (~run_start) & (prev_ts != sorted_ts)
    start_ts = np.empty_like(timestamps)
    start_ts[order] = prev_ts
    valid = np.empty(len(timestamps), dtype=bool)
    valid[order] = valid_sorted
    return {
        "position": positions[valid],
        "start_ts": start_ts[valid],
        "end_ts": timestamps[valid],
        "num_pos": polarities[valid],
        "num_neg": 1 - polarities[valid],
    }


def extract_max_refractory_period(positions, timestamps, img_height,
                                  img_width):
    """Min inter-event interval across per-pixel substreams (distinct ts)."""
    order, run_start = _pixel_runs(positions, img_width)
    sorted_ts = timestamps[order]
    distinct = np.empty(len(sorted_ts), dtype=bool)
    if len(sorted_ts):
        distinct[0] = True
        distinct[1:] = run_start[1:] | (sorted_ts[1:] != sorted_ts[:-1])
    dedup_ts = sorted_ts[distinct]
    dedup_run_start = run_start[distinct]
    if len(dedup_ts) < 2:
        return np.array(float("inf"))
    intervals = dedup_ts[1:] - dedup_ts[:-1]
    same_pixel = ~dedup_run_start[1:]
    if not np.any(same_pixel):
        return np.array(float("inf"))
    return np.asarray(intervals[same_pixel].min())


def colorize_events(events, bayer_pattern):
    """Bayer color-channel index per event from pixel parity."""
    if bayer_pattern == NULL_BAYER_PATTERN:
        return events
    if len(bayer_pattern) != 4 or set(bayer_pattern) != set(
            COLOR_CHANNEL_NAME_TO_INDEX):
        raise ValueError(f"invalid bayer pattern {bayer_pattern!r}")
    channel_of_quadrant = np.array(
        [COLOR_CHANNEL_NAME_TO_INDEX[c] for c in bayer_pattern],
        dtype=np.uint8)
    is_x_odd = (events["position"][:, 0] % 2).astype(np.int64)
    is_y_odd = (events["position"][:, 1] % 2).astype(np.int64)
    events = dict(events)
    events["channel_idx"] = channel_of_quadrant[is_y_odd * 2 + is_x_odd]
    return events


PLUMB_BOB_COUNTS = (4, 5, 8, 12, 14)  # the coefficient counts cv2 takes


def tilt_matrices(tau_x, tau_y):
    """OpenCV's computeTiltProjectionMatrix(tauX, tauY): (the tilted
    sensor's projection matrix, its inverse), both (3, 3) float64."""
    c_x, s_x = np.cos(tau_x), np.sin(tau_x)
    c_y, s_y = np.cos(tau_y), np.sin(tau_y)
    rot_x = np.array([[1, 0, 0], [0, c_x, s_x], [0, -s_x, c_x]])
    rot_y = np.array([[c_y, 0, -s_y], [0, 1, 0], [s_y, 0, c_y]])
    rot = rot_y @ rot_x
    proj = np.array([[rot[2, 2], 0, -rot[0, 2]],
                     [0, rot[2, 2], -rot[1, 2]], [0, 0, 1]])
    inv = 1.0 / rot[2, 2]
    inv_proj = np.array([[inv, 0, inv * rot[0, 2]],
                         [0, inv, inv * rot[1, 2]], [0, 0, 1]])
    return proj @ rot, rot.T @ inv_proj


def apply_homography(m, x, y):
    """(x, y) through the (3, 3) matrix m and back to z = 1, as OpenCV
    applies the tilt (a zero z leaves the point unscaled)."""
    vx = m[0, 0] * x + m[0, 1] * y + m[0, 2]
    vy = m[1, 0] * x + m[1, 1] * y + m[1, 2]
    vz = m[2, 0] * x + m[2, 1] * y + m[2, 2]
    inv = 1.0 / np.where(vz != 0, vz, 1.0)
    return inv * vx, inv * vy


def plumb_bob_coefficients(dist):
    """The 14 coefficients (k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4 tauX tauY)
    of a plumb_bob vector of 0, 4, 5, 8, 12 or 14, zero-padded."""
    dist = np.asarray(dist, np.float64).ravel()
    if dist.size not in (0,) + PLUMB_BOB_COUNTS:
        raise ValueError(f"plumb_bob takes 0, 4, 5, 8, 12 or 14 distortion "
                         f"coefficients, got {dist.size}")
    k = np.zeros(14)
    k[:dist.size] = dist
    return k


def _undistort_plumb_bob(pts, intrinsics, dist, iterations=5):
    """cv2.undistortPoints(pts, K, dist, P=K): radial-tangential with the
    thin prism (12 coefficients) and the tilted sensor (14), OpenCV's
    fixed-point inverse with its default 5 iterations: the inverse tilt
    first, then the iteration on the untilted point."""
    k = plumb_bob_coefficients(dist)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u, v = pts[:, 0], pts[:, 1]
    xn = (u - cx) * (1.0 / fx)
    yn = (v - cy) * (1.0 / fy)
    if np.any(k[12:]):
        x0, y0 = apply_homography(tilt_matrices(k[12], k[13])[1], xn, yn)
    else:
        x0, y0 = xn, yn
    x, y = x0, y0
    done = np.zeros(len(pts), bool)
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # OpenCV falls back to the distorted (and still tilted) point
        # where the model folds
        bad = ~done & (icdist < 0)
        x = np.where(bad, xn, x)
        y = np.where(bad, yn, y)
        done |= bad
        dx = (2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2
              + k[9] * r2 * r2)
        dy = (k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2
              + k[11] * r2 * r2)
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    return _project(intrinsics, x, y)


def _undistort_equidistant(pts, intrinsics, dist, iterations=10, eps=1e-8):
    """cv2.fisheye.undistortPoints(pts, K, D, P=K): Newton's method on
    theta with OpenCV's default criteria (10 iterations or a step below
    1e-8); a point that does not converge, or whose theta changes sign,
    becomes (-1e6, -1e6), as in OpenCV."""
    k = np.zeros(4)
    k[:len(dist)] = dist
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    pw_x = (pts[:, 0] - cx) / fx
    pw_y = (pts[:, 1] - cy) / fy
    theta_d = np.clip(np.sqrt(pw_x * pw_x + pw_y * pw_y), -np.pi / 2,
                      np.pi / 2)
    theta = theta_d.copy()
    converged = theta_d <= 1e-8
    for _ in range(iterations):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t6 * t2
        k0, k1, k2, k3 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
        fix = ((theta * (1 + k0 + k1 + k2 + k3) - theta_d)
               / (1 + 3 * k0 + 5 * k1 + 7 * k2 + 9 * k3))
        theta = np.where(converged, theta, theta - fix)
        converged |= np.abs(fix) < eps
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(theta_d > 1e-8, np.tan(theta) / theta_d, 1.0)
    flipped = (theta_d < 0) & (theta > 0) | (theta_d > 0) & (theta < 0)
    ok = converged & ~flipped
    return np.where(ok[:, None], _project(intrinsics, pw_x * scale,
                                          pw_y * scale), -1000000.0)


def _project(intrinsics, x, y):
    """(N, 2) points (x, y, 1) through P = K, as OpenCV's final
    reprojection."""
    K = intrinsics
    xx = K[0, 0] * x + K[0, 1] * y + K[0, 2]
    yy = K[1, 0] * x + K[1, 1] * y + K[1, 2]
    ww = 1.0 / (K[2, 0] * x + K[2, 1] * y + K[2, 2])
    return np.stack([xx * ww, yy * ww], axis=-1)


def undistort_events(events, distortion_model, distortion_params,
                     intrinsics):
    """Undistorted float64 positions; identity for an empty distortion."""
    events = dict(events)
    events["position"] = events["position"].astype(np.float64)
    if distortion_params is None or len(distortion_params) == 0:
        return events
    pts = events["position"]
    K = np.asarray(intrinsics, dtype=np.float64)
    dist = np.asarray(distortion_params, dtype=np.float64).reshape(-1)
    if str(distortion_model) == "plumb_bob":
        events["position"] = _undistort_plumb_bob(pts, K, dist)
    elif str(distortion_model) == "equidistant":
        events["position"] = _undistort_equidistant(pts, K, dist)
    else:
        raise NotImplementedError(
            f"distortion model {distortion_model!r} not supported")
    return events


class EventDataset:
    """Packed event intervals, cached next to the raw stream; an optional
    permutation seed reshuffles the dataset deterministically. `native`
    packs with the native packer (a failed build raises), else numpy."""

    def __init__(self, root_directory, permutation_seed=None, native=True):
        self.root_directory = root_directory
        self.events = self._load_or_build(root_directory, native)
        if permutation_seed is not None:
            n = len(self.events["position"])
            rng = np.random.Generator(np.random.Philox(permutation_seed))
            indices = rng.permutation(n)
            self.events = {k: v[indices] for k, v in self.events.items()}

    @staticmethod
    def _load_or_build(root_directory, native=True):
        cache_path = os.path.join(root_directory, PACKED_EVENTS_FILENAME)
        if os.path.isfile(cache_path):
            with np.load(cache_path) as f:
                return {k: f[k] for k in f.files}
        calib = load_camera_calibration(root_directory)
        raw = load_raw_events(root_directory)
        t0 = time.perf_counter()
        pack = native_evpack.pack_events if native else pack_events
        events = pack(
            raw[RAW_EVENT_POSITION_KEY], raw[RAW_EVENT_TIMESTAMP_KEY],
            raw[RAW_EVENT_POLARITY_KEY], int(calib[IMG_HEIGHT_KEY]),
            int(calib[IMG_WIDTH_KEY]))
        print(f"events: packed {len(events['end_ts'])} intervals of "
              f"{len(raw[RAW_EVENT_TIMESTAMP_KEY])} raw events with the "
              f"{'native' if native else 'numpy'} packer in "
              f"{time.perf_counter() - t0:.3f} s",
              flush=True)
        events = colorize_events(events, str(calib[BAYER_PATTERN_KEY]))
        events = undistort_events(
            events, calib[DISTORTION_MODEL_KEY],
            calib[DISTORTION_PARAMS_KEY], calib[INTRINSICS_KEY])
        np.savez(cache_path, **events)
        return events

    def __len__(self):
        return len(self.events["position"])


def load_max_refractory_period(root_directory, native=True):
    """Load (or extract, with the native or the numpy packer, and cache)
    the dataset's max refractory period."""
    cache_path = os.path.join(root_directory, MAX_REFRACTORY_PERIOD_FILENAME)
    if os.path.isfile(cache_path):
        return np.load(cache_path)
    calib = load_camera_calibration(root_directory)
    raw = load_raw_events(root_directory)
    extract = (native_evpack.max_refractory_period if native
               else extract_max_refractory_period)
    max_rp = extract(
        raw[RAW_EVENT_POSITION_KEY], raw[RAW_EVENT_TIMESTAMP_KEY],
        int(calib[IMG_HEIGHT_KEY]), int(calib[IMG_WIDTH_KEY]))
    np.save(cache_path, max_rp)
    return max_rp
