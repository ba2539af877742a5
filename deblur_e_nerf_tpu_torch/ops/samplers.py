"""Normalized interval samplers (counterpart of
deblur_e_nerf_tpu/ops/samplers.py).

The draws are inputs: a sampler takes its uniform variates `u`, so tests
can hand the port the same numbers the JAX package drew from its PRNG
key.
"""

import torch


def triangular(u, low=0.0, high=1.0, mode=0.0):
    """Triangular distribution by the inverse CDF of uniform variates `u`."""
    mode_cum_prob = (mode - low) / (high - low)
    k1 = (high - low) * (mode - low)
    k2 = (high - low) * (high - mode)
    return torch.where(
        u <= mode_cum_prob,
        low + torch.sqrt(u * k1),
        high - torch.sqrt((1 - u) * k2),
    )


def dirac_delta(shape, center, device, dtype=torch.float32):
    return torch.full(shape, center, device=device, dtype=dtype)
