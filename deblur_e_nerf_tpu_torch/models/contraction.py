"""Scene contraction (counterpart of deblur_e_nerf_tpu/models/contraction.py).

This slice ports the AABB contraction only: world positions map to the unit
cube by plain normalization, and back. The unbounded sphere and tanh
contractions are still to be ported (ROADMAP Queue A 12).
"""

import enum


class ContractionType(enum.Enum):
    AABB = "aabb"
    UN_BOUNDED_SPHERE = "sphere"
    UN_BOUNDED_TANH = "tanh"


def _check(contraction_type):
    if contraction_type != ContractionType.AABB:
        raise NotImplementedError(
            f"{contraction_type} contraction is not ported yet "
            "(ROADMAP Queue A 12: sphere/tanh contraction)"
        )


def contract(x, aabb, contraction_type):
    """World position -> contracted [0, 1]^3 coordinate (points outside the
    aabb fall outside the unit cube). `aabb` is a (6,) tensor."""
    _check(contraction_type)
    return (x - aabb[:3]) / (aabb[3:] - aabb[:3])


def contract_inv(u, aabb, contraction_type):
    """Contracted [0, 1]^3 coordinate -> world position."""
    _check(contraction_type)
    return aabb[:3] + u * (aabb[3:] - aabb[:3])
