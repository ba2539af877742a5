"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly;
without a GPU they raise — they never fall back to the CPU quietly.
"""

import torch


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
