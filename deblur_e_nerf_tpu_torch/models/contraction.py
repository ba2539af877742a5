"""Scene contraction (counterpart of deblur_e_nerf_tpu/models/contraction.py).

World positions map into the unit cube [0, 1]^3, and back:
  - AABB: plain normalization (points outside fall outside the cube);
  - SPHERE: identity inside the unit ball of the normalized aabb, radially
    contracted to |v| < 2 outside it, then mapped by v / 4 + 0.5;
  - TANH: elementwise tanh around the aabb center.
The inverses map occupancy-grid cells back to world space. The clamps
(`eps`) are the JAX package's.
"""

import enum

import torch


class ContractionType(enum.Enum):
    AABB = "aabb"
    UN_BOUNDED_SPHERE = "sphere"
    UN_BOUNDED_TANH = "tanh"


def _norm(v):
    # sqrt of the plain sum of squares, as jnp.linalg.norm computes it,
    # summed left to right in elementwise ops: a reduction kernel may order
    # the sum by the batch's shape, and a sample's bits must not depend on
    # the batch it is marched in
    x, y, z = v.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)[..., None]


def contract(x, aabb, contraction_type, eps=1e-6):
    """World position -> contracted [0, 1]^3 coordinate. `aabb` is a (6,)
    tensor."""
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    if contraction_type == ContractionType.AABB:
        return u
    if contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        v = u * 2 - 1
        mag = _norm(v)
        safe_mag = torch.clamp(mag, min=eps)
        v = torch.where(mag > 1, (2 - 1 / safe_mag) * (v / safe_mag), v)
        return v / 4 + 0.5
    if contraction_type == ContractionType.UN_BOUNDED_TANH:
        return (torch.tanh(u - 0.5) + 1) / 2
    raise NotImplementedError(contraction_type)


def contract_inv(u, aabb, contraction_type, eps=1e-6):
    """Contracted [0, 1]^3 coordinate -> world position."""
    aabb_min, aabb_max = aabb[:3], aabb[3:]
    extent = aabb_max - aabb_min
    if contraction_type == ContractionType.AABB:
        return aabb_min + u * extent
    if contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        w = (u - 0.5) * 4
        mag = torch.clamp(_norm(w), max=2 - eps)
        safe_mag = torch.clamp(mag, min=eps)
        # inverse of v -> (2 - 1/|v|) v/|v| for |v| > 1: |v| = 1/(2 - mag)
        v = torch.where(mag > 1, w / safe_mag / (2 - mag), w)
        return aabb_min + (v + 1) / 2 * extent
    if contraction_type == ContractionType.UN_BOUNDED_TANH:
        t = torch.clamp(u * 2 - 1, -1 + eps, 1 - eps)
        return aabb_min + (torch.atanh(t) + 0.5) * extent
    raise NotImplementedError(contraction_type)
