"""Camera pose dataset (counterpart of
deblur_e_nerf_tpu/data/camera_poses.py): camera_poses.npz with
T_wc_position (C, 3), T_wc_orientation (C, 4) XYZW, T_wc_timestamp (C,)
int64 ns."""

import os

import numpy as np

CAMERA_POSES_FILENAME = "camera_poses.npz"
CAMERA_POSES_KEYS = {"T_wc_position", "T_wc_orientation", "T_wc_timestamp"}


def load_camera_poses(root_directory):
    path = os.path.join(root_directory, CAMERA_POSES_FILENAME)
    with np.load(path) as f:
        camera_poses = {k: f[k] for k in f.files}
    if set(camera_poses) != CAMERA_POSES_KEYS:
        raise ValueError(f"{path}: keys {sorted(camera_poses)}, expected "
                         f"{sorted(CAMERA_POSES_KEYS)}")
    return camera_poses

