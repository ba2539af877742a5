"""Convert a raw EDS ("Event-aided Direct Sparse Odometry") sequence into
the pre-processed ESIM dataset layout (counterpart of
scripts/eds_to_esim.py), without jax, h5py, OpenCV or PyYAML:

    python -m deblur_e_nerf_tpu_torch.data.eds_to_esim CALIB RAW OUT \\
        [--start_timestamp NS] [--end_timestamp NS] [--device cuda|cpu]

Inputs: the EDS Kalibr calibration folder (its camera chain YAML, read by
`utils/config.yaml_load`), and a raw sequence folder with `events.h5`
(x/y/t[us]/p, read by `data/hdf5.py`), `stamped_groundtruth.txt` (t[s] xyz
xyzw), `images/` + `times.txt` (id, t[s], exposure[ms], gain[dB],
filename; images read and written by `data/image_io.py`).

Outputs, in OUT, as the script writes them:
  - `camera_calibration.npz`: the event camera's intrinsics and
    distortion, with the *assumed* DVS pixel-bandwidth constants and the
    Prophesee bias-derived contrast-threshold ratio and refractory period;
  - `camera_poses.npz`: the trimmed, re-zeroed event-camera trajectory;
  - `raw_events.npz`: the events within the pose window;
  - `views/transforms_train.json` and the undistorted RGB images
    (`data/undistort.py`): the RGB camera's poses, slerped from the event
    trajectory by the port's `models/trajectory.py` on `--device` (the
    card unless `--device cpu`), composed with the cam-to-cam extrinsic,
    in OpenGL convention, with each image's `exposure_time` (ns) and
    linear `gain`.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..models import trajectory as trajectory_lib
from ..utils.config import yaml_load
from ..utils.device import resolve_device
from . import hdf5, image_io, undistort

S_TO_NS = 10 ** 9
MS_TO_NS = 10 ** 6
US_TO_NS = 10 ** 3
MV_TO_V = 1e-3

# right-multiply: common (x right, y down, z forward) <- OpenGL camera
T_CCOMMON_COPENGL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)

CALIBRATION_CONFIG_FILENAME = (
    "camchain-mediajaviJAVISdatasetshwdscalibratione2kalibr.yaml"
)
RGB_CAMERA_ID = "cam0"
EVENT_CAMERA_ID = "cam1"

RAW_EVENTS_FILENAME = "events.h5"
RAW_EVENT_CAMERA_POSES_FILENAME = "stamped_groundtruth.txt"
DISTORTED_IMAGES_FOLDER_NAME = "images"
TIMES_FILENAME = "times.txt"

EVENTS_FILENAME = "raw_events.npz"
CAMERA_POSES_FILENAME = "camera_poses.npz"
CAMERA_CALIBRATION_FILENAME = "camera_calibration.npz"
VIEWS_FOLDER_NAME = "views"
STAGE = "train"

# Prophesee Gen 3.1 (PPS3MVCD) bias presets, in mV (docs.prophesee.ai bias
# tables)
BIAS_DIFF_OFF = 194
BIAS_DIFF_ON = 414
BIAS_DIFF = 300
BIAS_REFR = 1500

ASSUMED_NEG_CONTRAST_THRESHOLD = 0.25

# DVS128 "fast biases" pixel-circuit constants
ASSUMED_PHYSICS = {
    "input_time_const_eff_it_prod": (35e-12 * 25e-3) / 2000e-12,
    "miller_time_const_eff_it_prod": (0.6e-12 * 25e-3) / 2000e-12,
    "amplifier_gain": 140.0,
    "closed_loop_gain": 1 / 0.7,
    "output_time_const": 25e-6,
    "lower_cutoff_freq": 0.01,
    "sf_cutoff_freq": 16400.0,
    "diff_amp_cutoff_freq": 82000.0,
}
ASSUMED_BLACK_LEVEL = 4e-12 / 2000e-12

KALIBR_TO_CALIB_DISTORTION_MODEL = {
    "radtan": "plumb_bob",
    "equi": "equidistant",
    "fov": "fov",
    "none": "plumb_bob",
}


def bias_refr_voltage_to_ns(voltage_v):
    """Empirical refractory period of the Prophesee Gen 3.1 refr bias."""
    return S_TO_NS * 4e-23 * np.exp(27.64 * voltage_v)


def db_to_linear(db_values):
    return 10 ** (np.asarray(db_values) / 20)


def kalibr_intrinsics(cam):
    fx, fy, cx, cy = cam["intrinsics"]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def event_camera_calibration(event_calibration):
    """The event camera's `camera_calibration.npz` entries."""
    if event_calibration["camera_model"] != "pinhole":
        raise ValueError(f"event camera model "
                         f"{event_calibration['camera_model']!r}: only "
                         f"pinhole is supported")
    width, height = event_calibration["resolution"]
    ct_ratio = (BIAS_DIFF_ON - BIAS_DIFF) / (BIAS_DIFF - BIAS_DIFF_OFF)
    neg_ct = ASSUMED_NEG_CONTRAST_THRESHOLD
    return {
        "intrinsics": kalibr_intrinsics(event_calibration),
        "distortion_params": np.array(
            event_calibration["distortion_coeffs"], np.float32),
        "distortion_model": np.array(KALIBR_TO_CALIB_DISTORTION_MODEL[
            event_calibration["distortion_model"]]),
        "img_height": np.array(height, np.uint16),
        "img_width": np.array(width, np.uint16),
        "pos_contrast_threshold": np.float32(ct_ratio * neg_ct),
        "neg_contrast_threshold": np.float32(neg_ct),
        "refractory_period": np.float32(
            bias_refr_voltage_to_ns(BIAS_REFR * MV_TO_V)),
        "bayer_pattern": "",
        "black_level": np.array([ASSUMED_BLACK_LEVEL], np.float32),
        **{k: np.float32(v) for k, v in ASSUMED_PHYSICS.items()},
    }


def load_trimmed_poses(raw_dataset_path, start_timestamp, end_timestamp):
    """stamped_groundtruth.txt -> re-zeroed (position, quat, ts, t0)."""
    raw = np.loadtxt(
        os.path.join(raw_dataset_path, RAW_EVENT_CAMERA_POSES_FILENAME))
    ts = (S_TO_NS * raw[:, 0]).astype(np.int64)
    valid = (start_timestamp <= ts) & (ts < end_timestamp)
    ts = ts[valid]
    t0 = ts[0]
    return (raw[valid, 1:4].astype(np.float32),
            raw[valid, 4:8].astype(np.float32), ts - t0, t0)


def load_events(raw_dataset_path, t0, T_wc_timestamp):
    """events.h5 -> (position u16, timestamp i64 ns, polarity bool) within
    the pose window."""
    with hdf5.File(os.path.join(raw_dataset_path, RAW_EVENTS_FILENAME)) as f:
        position = np.stack((f["x"], f["y"]), axis=1).astype(np.uint16)
        timestamp = US_TO_NS * f["t"].astype(np.int64) - t0
        polarity = f["p"].astype(bool)
    valid = (T_wc_timestamp[0] <= timestamp) \
        & (timestamp <= T_wc_timestamp[-1])
    return position[valid], timestamp[valid], polarity[valid]


def rgb_poses_from_event_trajectory(T_wc_position, T_wc_orientation,
                                    T_wc_timestamp, image_timestamp,
                                    T_event_rgb, device="cuda"):
    """Slerp the event camera's poses to the image timestamps (the port's
    trajectory model, as the training loop uses it) on `device`, compose
    the cam-to-cam extrinsic and convert to OpenGL convention: (N, 4, 4)
    float32."""
    device = resolve_device(device)
    traj = trajectory_lib.make_trajectory({
        "T_wc_position": T_wc_position,
        "T_wc_orientation": T_wc_orientation,
        "T_wc_timestamp": T_wc_timestamp,
    }, device)
    with torch.no_grad():
        pos, rot = trajectory_lib.interpolate_pose(
            traj, torch.as_tensor(np.asarray(image_timestamp, np.int64),
                                  device=device))
    pos, rot = pos.cpu().numpy(), rot.cpu().numpy()

    T_w_event = np.zeros((len(pos), 4, 4), np.float32)
    T_w_event[:, :3, 3] = pos
    T_w_event[:, :3, :3] = rot
    T_w_event[:, 3, 3] = 1
    return T_w_event @ T_event_rgb @ T_CCOMMON_COPENGL


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert EDS datasets to the pre-processed ESIM format.")
    parser.add_argument("calibration_path",
                        help="Path to the EDS calibration results folder.")
    parser.add_argument("raw_dataset_path",
                        help="Path to the raw EDS dataset.")
    parser.add_argument("preprocessed_dataset_path",
                        help="Desired path to the pre-processed EDS "
                             "dataset.")
    parser.add_argument("--start_timestamp", type=int, default=0,
                        help="Trim start (ns, inclusive).")
    parser.add_argument("--end_timestamp", type=float, default=float("inf"),
                        help="Trim end (ns, exclusive).")
    parser.add_argument("--device", default="cuda",
                        help="Where the poses are slerped: cuda (default) "
                             "or cpu.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = args.preprocessed_dataset_path
    os.makedirs(out, exist_ok=True)

    with open(os.path.join(args.calibration_path,
                           CALIBRATION_CONFIG_FILENAME)) as f:
        calibration = yaml_load(f.read())
    rgb_calibration = calibration[RGB_CAMERA_ID]
    event_calibration = calibration[EVENT_CAMERA_ID]

    np.savez(os.path.join(out, CAMERA_CALIBRATION_FILENAME),
             **event_camera_calibration(event_calibration))

    T_wc_position, T_wc_orientation, T_wc_timestamp, t0 = \
        load_trimmed_poses(args.raw_dataset_path, args.start_timestamp,
                           args.end_timestamp)
    np.savez(os.path.join(out, CAMERA_POSES_FILENAME),
             T_wc_position=T_wc_position,
             T_wc_orientation=T_wc_orientation,
             T_wc_timestamp=T_wc_timestamp)

    position, timestamp, polarity = load_events(
        args.raw_dataset_path, t0, T_wc_timestamp)
    np.savez(os.path.join(out, EVENTS_FILENAME),
             position=position, timestamp=timestamp, polarity=polarity)

    # RGB camera: undistortion target intrinsics
    if rgb_calibration["camera_model"] != "pinhole" \
            or rgb_calibration["distortion_model"] not in ("radtan", "none"):
        raise ValueError(f"RGB camera {rgb_calibration['camera_model']!r} "
                         f"with {rgb_calibration['distortion_model']!r} "
                         f"distortion: only pinhole radtan or none is "
                         f"supported")
    rgb_intrinsics = kalibr_intrinsics(rgb_calibration)
    rgb_distortion = np.array(rgb_calibration["distortion_coeffs"],
                              np.float32)
    rgb_width, rgb_height = rgb_calibration["resolution"]
    new_rgb_intrinsics, roi = undistort.optimal_new_camera_matrix(
        rgb_intrinsics, rgb_distortion, (rgb_width, rgb_height), alpha=0)
    if roi != (0, 0, rgb_width - 1, rgb_height - 1):
        raise ValueError(f"the undistorted RGB image's valid region {roi} "
                         f"is not the whole image")

    # image timestamps / exposure / gain / filenames
    times_path = os.path.join(args.raw_dataset_path, TIMES_FILENAME)
    image_timestamp = (
        S_TO_NS * np.loadtxt(times_path, usecols=1)).astype(np.int64) - t0
    valid = (0 <= image_timestamp) & (image_timestamp <= T_wc_timestamp[-1])
    image_timestamp = image_timestamp[valid]
    exposure_ns = (MS_TO_NS * np.loadtxt(times_path, usecols=2)
                   ).astype(np.int64)[valid]
    gain = db_to_linear(np.loadtxt(times_path, usecols=3)
                        ).astype(np.float32)[valid]
    filenames = np.loadtxt(times_path, dtype=str, usecols=4)[valid]

    T_event_rgb = np.array(event_calibration["T_cn_cnm1"], np.float32)
    T_w_rgb = rgb_poses_from_event_trajectory(
        T_wc_position, T_wc_orientation, T_wc_timestamp, image_timestamp,
        T_event_rgb, device)

    views_path = os.path.join(out, VIEWS_FOLDER_NAME)
    os.makedirs(views_path, exist_ok=True)
    transforms = {
        "intrinsics": new_rgb_intrinsics.tolist(),
        "frames": [
            {
                "file_path": os.path.join(".", STAGE,
                                          os.path.splitext(name)[0]),
                "exposure_time": int(exp),
                "gain": float(g),
                "transform_matrix": tf.tolist(),
            }
            for name, exp, g, tf in zip(filenames, exposure_ns, gain,
                                        T_w_rgb)
        ],
    }
    with open(os.path.join(views_path, f"transforms_{STAGE}.json"),
              "w") as f:
        json.dump(transforms, f, indent=4)

    # undistort & save the RGB images
    stage_path = os.path.join(views_path, STAGE)
    os.makedirs(stage_path, exist_ok=True)
    for name in filenames:
        img = image_io.imread(os.path.join(
            args.raw_dataset_path, DISTORTED_IMAGES_FOLDER_NAME, name))
        undistorted = undistort.undistort_image(
            img, rgb_intrinsics, rgb_distortion, new_rgb_intrinsics)
        image_io.imwrite(os.path.join(stage_path, name), undistorted)
    print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
