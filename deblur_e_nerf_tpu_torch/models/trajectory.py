"""Continuous-time camera trajectory (counterpart of
deblur_e_nerf_tpu/models/trajectory.py).

Timestamps stay int64 nanoseconds: the bin search and the subtraction of
the bin's left edge are exact integer math, and only the within-bin
remainder becomes float32. A differentiable float32 `timestamp_delta`
(learnable refractory shift, sampled interval offsets) rides beside the
integer base. Positions are lerped, orientations slerped with full-angle
rotation vectors.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops import quat


class Trajectory(NamedTuple):
    T_wc_position: torch.Tensor          # (C, 3) float32
    T_wc_orientation_quat: torch.Tensor  # (C, 4) float32 XYZW
    T_wc_timestamp: torch.Tensor         # (C,) int64 ns
    bin_width: torch.Tensor              # (C-1,) float32 ns


def make_trajectory(camera_poses, device):
    ts = np.asarray(camera_poses["T_wc_timestamp"], dtype=np.int64)
    return Trajectory(
        T_wc_position=torch.as_tensor(
            np.asarray(camera_poses["T_wc_position"], np.float32),
            device=device),
        T_wc_orientation_quat=torch.as_tensor(
            np.asarray(camera_poses["T_wc_orientation"], np.float32),
            device=device),
        T_wc_timestamp=torch.as_tensor(ts, device=device),
        bin_width=torch.as_tensor(np.diff(ts).astype(np.float32),
                                  device=device),
    )


def interpolate_pose(trajectory, timestamp, timestamp_delta=None):
    """Pose at int64 ns `timestamp` (+ optional f32 `timestamp_delta`).

    Returns position (..., 3) float32 and orientation (..., 3, 3) float32.
    Timestamps outside the timeline extrapolate from the clamped end bin.
    """
    ts_line = trajectory.T_wc_timestamp
    C = ts_line.shape[0]
    if timestamp.dtype != torch.int64:
        timestamp = timestamp.to(torch.int64)
    right = torch.searchsorted(ts_line, timestamp)  # side='left'
    left = torch.where(timestamp == ts_line[0], right, right - 1)
    right = right.clamp(0, C - 1)
    left = left.clamp(0, C - 1)

    remainder = (timestamp - ts_line[left]).to(torch.float32)
    if timestamp_delta is not None:
        remainder = remainder + timestamp_delta
    weight = remainder / trajectory.bin_width[left.clamp(0, C - 2)]

    p0 = trajectory.T_wc_position[left]
    p1 = trajectory.T_wc_position[right]
    position = p0 + weight[..., None] * (p1 - p0)
    q = quat.unitquat_slerp(
        trajectory.T_wc_orientation_quat[left],
        trajectory.T_wc_orientation_quat[right],
        weight, shortest_path=True,
    )
    return position, quat.unitquat_to_rotmat(q)
