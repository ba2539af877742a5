"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly;
without a GPU they raise — they never fall back to the CPU quietly.
"""

import functools

import torch


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype).to(device)


def constant(values, dtype, device):
    """A small constant tensor (numbers, nested lists or tuples) on
    `device`, copied there once per process: torch.tensor(..., device=
    "cuda") would copy from the host on every call, and a blocking copy
    waits for the device. Callers must not write to it."""
    if hasattr(values, "tolist"):  # a CPU tensor or numpy array
        values = values.tolist()
    return _constant(_frozen(values), dtype, torch.device(device))


def resolve_device(device=None):
    """`None` or "cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU; a torch.device passes through after the same check."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
