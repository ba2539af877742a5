"""Quaternion operations in XYZW convention (counterpart of
deblur_e_nerf_tpu/ops/quat.py): Hamilton product, rotation matrices and
slerp with full-angle rotation vectors in [0, 2*pi] and per-element steps.
All functions broadcast over leading dims and keep the input dtype. Sums
over the components are written out in a fixed order (`_dot`), so an
element's bits do not depend on the batch it is computed in.
"""

import torch


def _dot(a, b):
    """Sum of a * b over the last dim, left to right, elementwise ops
    only (a reduction kernel may order the sum by the batch's shape)."""
    a, b = a.unbind(-1), b.unbind(-1)
    total = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        total = total + x * y
    return total


def quat_product(p, q):
    px, py, pz, pw = p.unbind(-1)
    qx, qy, qz, qw = q.unbind(-1)
    return torch.stack([
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
        pw * qw - px * qx - py * qy - pz * qz,
    ], dim=-1)


def quat_conjugation(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def unitquat_to_rotmat(q):
    """Unit quaternion (..., 4) XYZW -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    m = torch.stack([
        one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def rotvec_to_unitquat(rotvec):
    """Rotation vector (..., 3) -> unit quaternion (..., 4), gradient-safe
    at zero rotation (the sqrt input is guarded on both sides)."""
    sq = _dot(rotvec, rotvec)[..., None]
    small = sq <= 1e-6
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.where(small, torch.zeros_like(sq), torch.sqrt(safe_sq))
    angle_sq = torch.where(small, sq, angle * angle)
    safe_angle = torch.where(small, torch.ones_like(angle), angle)
    scale = torch.where(
        small,
        0.5 - angle_sq / 48 + angle_sq * angle_sq / 3840,
        torch.sin(safe_angle / 2) / safe_angle,
    )
    w = torch.where(
        small,
        1.0 - angle_sq / 8 + angle_sq * angle_sq / 384,
        torch.cos(angle / 2),
    )
    return torch.cat([scale * rotvec, w], dim=-1)


def unitquat_to_full_rotvec(q):
    """Unit quaternion -> rotation vector with the angle in [0, 2*pi], so
    slerp without shortest-path flipping follows the arc the pair spans."""
    xyz = q[..., :3]
    w = q[..., 3]
    sq = _dot(xyz, xyz)
    small_norm = sq <= 1e-12
    safe_sq = torch.where(small_norm, torch.ones_like(sq), sq)
    norm_xyz = torch.where(
        small_norm, torch.zeros_like(sq), torch.sqrt(safe_sq)
    )
    angle = 2 * torch.atan2(norm_xyz, w)
    small = torch.abs(angle) <= 1e-3
    angle_sq = angle * angle
    safe_angle = torch.where(small, torch.ones_like(angle), angle)
    scale = torch.where(
        small,
        2 + angle_sq / 12 + 7 * angle_sq * angle_sq / 2880,
        safe_angle / torch.sin(safe_angle / 2),
    )
    return scale[..., None] * xyz


def unitquat_slerp(q0, q1, steps, shortest_path=False):
    """Spherical linear interpolation with per-element steps (0 -> q0,
    1 -> q1); `shortest_path` flips q1 when <q0, q1> < 0."""
    if shortest_path:
        dot = _dot(q0, q1)[..., None]
        q1 = torch.where(dot < 0, -q1, q1)
    rel = quat_product(quat_conjugation(q0), q1)
    rel_rotvec = unitquat_to_full_rotvec(rel)
    rots = rotvec_to_unitquat(steps[..., None] * rel_rotvec)
    return quat_product(q0, rots)
