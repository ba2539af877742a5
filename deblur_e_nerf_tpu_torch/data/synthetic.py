"""Synthetic ESIM-layout dataset generation (counterpart of
deblur_e_nerf_tpu/data/synthetic.py), numpy and scipy only.

Writes raw_events.npz, camera_calibration.npz, camera_poses.npz and
renderer_params.npz for a textured unit sphere seen from an orbiting
camera. Events come from an ideal event-camera simulation (per-pixel
log-intensity threshold crossings with interpolated timestamps) or, with
`simulate_events=False`, are random with plausible statistics. The posed
image views (float32 TIFFs through `image_io`, without OpenCV, and the
`views/transforms_{train,val,test}.json` files) are written only when
`write_views` is set.

Motion blur: `bandwidth_tau_ns` low-pass filters each pixel's log
intensity with a first-order IIR; `pixel_filter='full'` runs it through
the full 4th-order pixel circuit of the deblurring model
(`filter_log_frames_full`, in torch, float32, on `filter_device`, the CPU
by default as in the JAX generator). `bandwidth_scale` scales every
circuit time constant (and inversely every cutoff frequency) in the
calibration the dataset is written with, which the full filter reads.
"""

import json
import os

import numpy as np
import torch

from . import image_io


def orbit_poses(n, radius=3.0, height=0.8, t_end_ns=2_000_000_000,
                orbits=1):
    from scipy.spatial.transform import Rotation

    ts = np.linspace(0, t_end_ns * orbits, n).astype(np.int64)
    angle = np.linspace(0, 2 * np.pi * orbits, n)
    pos = np.stack([radius * np.cos(angle), radius * np.sin(angle),
                    np.full(n, height)], axis=1).astype(np.float32)
    z = -pos / np.linalg.norm(pos, axis=1, keepdims=True)
    up = np.array([0, 0, -1.0], dtype=np.float32)
    x = np.cross(z, np.broadcast_to(up, z.shape))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=-1)  # columns = camera axes in world
    quat = Rotation.from_matrix(R).as_quat().astype(np.float32)
    return pos, quat, R, ts


def filter_log_frames_full(log_frames, frame_ts_ns, calib, device="cpu"):
    """Filter per-pixel log intensity through the full 4th-order pixel
    circuit, the generator-side twin of the deblurring model: each frame
    interval linearizes the photoreceptor at the interval-end intensity
    (models/pixel_bandwidth.py `linearize_sys`) and propagates the 4-dim
    state exactly under a linearly interpolated input (ops/control.py
    `foh_cont2discrete`, state-preserving, efficient form), from the DC
    steady state of the first frame (v = 0, p = s = d = log I_0). Float32
    throughout, with explicit multiply-adds (no TF32).

    Args:
        log_frames: (T, P) float32 per-pixel log intensity.
        frame_ts_ns: (T,) int64 strictly increasing timestamps.
        calib: camera_calibration dict with the pixel-circuit constants.
        device: where the chain runs ("cpu" or "cuda").
    Returns:
        (T, P) float32 numpy: the diff-amp output's log intensity.
    """
    from ..models import pixel_bandwidth
    from ..ops import control, linalg

    params, consts = pixel_bandwidth.init_pixel_bandwidth(
        calib, min_ts=0, f_c_dominant_min=1.0,
        target_cumprob_max_sample_lifetime=0.5, device=device)
    dts_s = (np.diff(np.asarray(frame_ts_ns, np.int64)).astype(np.float64)
             * 1e-9).astype(np.float32)
    lf = torch.as_tensor(np.asarray(log_frames, np.float32), device=device)
    out = [lf[0]]
    with torch.no_grad():
        x = torch.stack([torch.zeros_like(lf[0]), lf[0], lf[0], lf[0]],
                        dim=-1)[..., None]  # (P, 4, 1)
        for t in range(1, len(lf)):
            u0, u1 = lf[t - 1], lf[t]
            sysd = control.foh_cont2discrete(
                pixel_bandwidth.linearize_sys(params, consts,
                                              torch.exp(u1)),
                torch.tensor(dts_s[t - 1], device=device),
                is_state_preserved=True, is_efficient=True)
            x = (linalg.matmul(sysd.A, x) + sysd.B * u0[:, None, None]
                 + sysd.B_tilde * u1[:, None, None])
            out.append(x[:, 3, 0])
    return torch.stack(out).cpu().numpy()


def simulate_event_stream(analytic_image_fn, R, pos_w, pose_ts, H, W,
                          contrast_threshold, log_eps=1e-3,
                          num_frames=None, bandwidth_tau_ns=None,
                          pixel_filter=None, calib=None,
                          filter_device="cpu"):
    """Ideal event simulation against the analytic scene, after the
    optional blur (`bandwidth_tau_ns` first-order, or `pixel_filter=
    'full'` with the circuit constants in `calib`); returns (positions
    (N,2) u16, timestamps (N,) i64 sorted, polarities)."""
    num_frames = num_frames or len(pose_ts)
    frame_idx = np.linspace(0, len(pose_ts) - 1, num_frames)
    positions, timestamps, polarities = [], [], []
    ys, xs = np.mgrid[0:H, 0:W]
    flat_x = xs.reshape(-1).astype(np.uint16)
    flat_y = ys.reshape(-1).astype(np.uint16)
    used = [int(frame_idx[0])]
    for fi in frame_idx[1:]:
        i = int(round(fi))
        if float(pose_ts[i]) > float(pose_ts[used[-1]]):
            used.append(i)
    frames = np.stack([
        np.log(analytic_image_fn(R[i], pos_w[i]) + log_eps).reshape(-1)
        for i in used
    ]).astype(np.float32)
    frame_ts = np.asarray([pose_ts[i] for i in used], np.int64)
    if pixel_filter == "full":
        if calib is None:
            raise ValueError("pixel_filter='full' needs the calibration")
        frames = filter_log_frames_full(frames, frame_ts, calib,
                                        filter_device)
    elif pixel_filter not in (None, "none", "first_order"):
        raise ValueError(f"unknown pixel_filter {pixel_filter!r}")
    elif bandwidth_tau_ns is not None:  # first-order low-pass blur
        filt = frames[0].copy()
        for t in range(1, len(frames)):
            alpha = 1.0 - np.exp(-float(frame_ts[t] - frame_ts[t - 1])
                                 / float(bandwidth_tau_ns))
            filt = filt + alpha * (frames[t] - filt)
            frames[t] = filt

    ref_log = frames[0].copy()
    prev_log = frames[0].copy()
    prev_ts = float(frame_ts[0])
    C = contrast_threshold
    for t in range(1, len(frames)):
        cur_log = frames[t]
        cur_ts = float(frame_ts[t])
        delta = cur_log - ref_log
        n_events = np.floor(np.abs(delta) / C).astype(np.int64)
        max_n = int(n_events.max()) if len(n_events) else 0
        for k in range(1, max_n + 1):
            fire = n_events >= k
            if not np.any(fire):
                break
            pol = delta[fire] > 0
            level = ref_log[fire] + np.where(pol, k * C, -k * C)
            slope = cur_log[fire] - prev_log[fire]
            frac = np.where(
                np.abs(slope) > 1e-12,
                np.clip((level - prev_log[fire]) / np.where(
                    np.abs(slope) > 1e-12, slope, 1.0), 0.0, 1.0),
                0.5)
            ts = (prev_ts + frac * (cur_ts - prev_ts)).astype(np.int64)
            positions.append(np.stack([flat_x[fire], flat_y[fire]], axis=1))
            timestamps.append(ts)
            polarities.append(pol)
        ref_log = ref_log + np.sign(delta) * n_events * C
        prev_log = cur_log
        prev_ts = cur_ts
    if not positions:
        return (np.zeros((0, 2), np.uint16), np.zeros(0, np.int64),
                np.zeros(0, bool))
    positions = np.concatenate(positions)
    timestamps = np.concatenate(timestamps)
    polarities = np.concatenate(polarities)
    order = np.argsort(timestamps, kind="stable")
    return positions[order], timestamps[order], polarities[order]


def _write_views(root, analytic_image, R, pos_w, num_poses, num_views, W,
                 focal):
    views_dir = os.path.join(root, "views")
    os.makedirs(views_dir, exist_ok=True)
    n_eval = min(2, num_poses)
    val_idx = [int(i) for i in np.linspace(
        num_poses // 8, 3 * num_poses // 8, n_eval)]
    test_idx = [int(i) for i in np.linspace(
        5 * num_poses // 8, 7 * num_poses // 8, n_eval)]
    for stage, indices in (("train", range(0, min(num_views, num_poses))),
                           ("val", val_idx), ("test", test_idx)):
        frames = []
        for i in indices:
            name = f"{stage}_{i:03d}"
            image_io.imwrite(os.path.join(views_dir, name + ".tiff"),
                             analytic_image(R[i], pos_w[i]))
            T = np.eye(4)
            # stored pose is OpenGL convention (loader right-multiplies
            # by diag(1,-1,-1))
            T[:3, :3] = R[i] @ np.diag([1.0, -1.0, -1.0])
            T[:3, 3] = pos_w[i]
            frames.append({"file_path": name,
                           "transform_matrix": T.tolist()})
        with open(os.path.join(views_dir, f"transforms_{stage}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan((W / 2)
                                                             / focal)),
                       "frames": frames}, f)


def make_dataset(root, img_height=64, img_width=64, num_events=200_000,
                 num_poses=61, bayer=False, seed=0, contrast_threshold=0.25,
                 refractory_ns=100, num_views=4, simulate_events=True,
                 num_frames=None, orbits=1, bandwidth_tau_ns=None,
                 pixel_filter=None, bandwidth_scale=1.0, write_views=False,
                 filter_device="cpu"):
    """Write a synthetic dataset into `root` and return `root`. The same
    arguments as the JAX generator give the same files (views aside; the
    full pixel filter's float32 chain agrees to ~1e-6, so an event at a
    threshold crossing may flip). `filter_device` runs the full filter
    ("cpu" or "cuda")."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = img_height, img_width
    pos_w, quat, R, pose_ts = orbit_poses(num_poses, orbits=orbits)
    np.savez(os.path.join(root, "camera_poses.npz"), T_wc_position=pos_w,
             T_wc_orientation=quat, T_wc_timestamp=pose_ts)
    focal = 0.8 * W
    K = np.array([[focal, 0, W / 2 - 0.5], [0, focal, H / 2 - 0.5],
                  [0, 0, 1]])
    s = float(bandwidth_scale)
    calib = dict(
        img_height=H, img_width=W, intrinsics=K,
        distortion_model="plumb_bob", distortion_params=np.zeros(0),
        bayer_pattern="RGGB" if bayer else "",
        pos_contrast_threshold=np.asarray(contrast_threshold),
        neg_contrast_threshold=np.asarray(contrast_threshold),
        refractory_period=np.asarray(float(refractory_ns)),
        input_time_const_eff_it_prod=np.asarray(1e-4 * s),
        miller_time_const_eff_it_prod=np.asarray(2e-5 * s),
        amplifier_gain=np.asarray(50.0),
        closed_loop_gain=np.asarray(10.0),
        output_time_const=np.asarray(1e-4 * s),
        sf_cutoff_freq=np.asarray(500.0 / s),
        diff_amp_cutoff_freq=np.asarray(200.0 / s),
    )
    np.savez(os.path.join(root, "camera_calibration.npz"), **calib)
    np.savez(os.path.join(root, "renderer_params.npz"),
             interm_color_space="linear", log_eps=np.asarray(1e-3))
    Kinv = np.linalg.inv(K)

    def analytic_image(R_wc, p_wc):
        """Ray-traced textured unit sphere at the origin."""
        ys, xs = np.mgrid[0:H, 0:W]
        pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(
            np.float64)
        d = (Kinv @ pix[..., None])[..., 0]
        d = (R_wc @ d[..., None])[..., 0]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = p_wc.astype(np.float64)
        b = d @ o
        c = float(o @ o) - 1.0
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= t > 0
        p = o[None, None, :] + d * t[..., None]
        tex = (0.55
               + 0.15 * np.sin(6.0 * p[..., 0]) * np.sin(6.0 * p[..., 1])
               + 0.12 * np.sin(4.0 * p[..., 2])
               + 0.10 * np.sin(14.0 * p[..., 0] + 7.0 * p[..., 2])
               * np.sin(11.0 * p[..., 1])
               + 0.06 * np.sin(23.0 * p[..., 0]) * np.sin(19.0 * p[..., 2]))
        return np.where(hit, tex, 0.15).astype(np.float32)

    if simulate_events:
        positions, timestamps, polarities = simulate_event_stream(
            analytic_image, R, pos_w, pose_ts, H, W, contrast_threshold,
            num_frames=num_frames or num_poses,
            bandwidth_tau_ns=bandwidth_tau_ns, pixel_filter=pixel_filter,
            calib=calib, filter_device=filter_device)
    else:
        positions = np.stack([rng.integers(0, W, num_events),
                              rng.integers(0, H, num_events)],
                             axis=1).astype(np.uint16)
        timestamps = np.sort(rng.integers(0, pose_ts[-1], num_events)
                             ).astype(np.int64)
        polarities = rng.integers(0, 2, num_events).astype(bool)
    np.savez(os.path.join(root, "raw_events.npz"), position=positions,
             timestamp=timestamps, polarity=polarities)
    if write_views:
        _write_views(root, analytic_image, R, pos_w, num_poses, num_views,
                     W, focal)
    return root
