"""Density / radiance activations (counterpart of
deblur_e_nerf_tpu/ops/activations.py).

`trunc_exp` is exp with its gradient clamped at exp(15), which keeps the
density head from overflowing f32 early in training.
"""

import torch
import torch.nn.functional as F


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def shifted_trunc_exp(x, shift=1.0):
    return trunc_exp(x - shift)


def softplus(x, beta=1.0, threshold=20.0):
    """torch-semantics softplus: linear above `threshold` for stability."""
    return F.softplus(x, beta=beta, threshold=threshold)


def softplus_inverse(y, beta=1.0, threshold=20.0):
    """Right-inverse of `softplus` (bijector parameter initialization)."""
    y = torch.as_tensor(y)
    scaled = y * beta
    return torch.where(
        scaled > threshold, y,
        torch.log(torch.expm1(torch.clamp(scaled, max=threshold))) / beta,
    )


def shifted_softplus(x, shift=1.0, beta=1.0, threshold=20.0):
    """mip-NeRF density activation."""
    return softplus(x - shift, beta, threshold)


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": lambda x: softplus(x, beta=1.0),
    "softplus100": lambda x: softplus(x, beta=100.0),
    "shifted_trunc_exp": shifted_trunc_exp,
    "shifted_softplus": shifted_softplus,
    "identity": lambda x: x,
}


def _lookup(kind, table, name):
    if name not in table:
        raise ValueError(f"unknown {kind} activation {name!r} (known: "
                         f"{sorted(table)})")
    return table[name]


def hidden_activation(name):
    """'softplus' hidden layers use beta=100 (reference registry)."""
    return _lookup("hidden", {"softplus": ACTIVATIONS["softplus100"],
                              "relu": ACTIVATIONS["relu"]}, name)


def density_activation(name):
    return _lookup("density", {
        "shifted_trunc_exp": shifted_trunc_exp,
        "softplus": ACTIVATIONS["softplus"],
        "shifted_softplus": shifted_softplus,
    }, name)


def radiance_activation(name):
    return _lookup("radiance", {"softplus": ACTIVATIONS["softplus"],
                                "sigmoid": ACTIVATIONS["sigmoid"]}, name)
