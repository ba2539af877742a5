"""Trilinear corner sum of a hash-grid level: features (N, F) =
sum over the 8 cell corners of weight * row, in float32, from the rows
that `gather_rows` returns (bfloat16 on the flagship). The JAX package
leaves it to XLA inside the encode
(deblur_e_nerf_tpu/models/hash_encoding.py `_batched_vertex_group`,
`jnp.sum(rows.astype(acc_dtype) * w[..., None], axis=-2)`); there is no
Pallas kernel.

On a CUDA tensor `corner_sum` launches the hand-written kernel in
`csrc/corner_sum.cu` (one pass over the rows and weights; see the note
there) or raises; it never falls back. On a CPU tensor it runs the plain
PyTorch version, `corner_sum_reference`. `LAUNCHES` counts kernel
launches. `corner_sum_sequential` is the plain model of the kernel's
summation order (corners in order, no fused multiply-add): the card tests
hold the kernel to it bit for bit.
"""

import torch

LAUNCHES = 0  # kernel launches since the last reset (plain int)


def corner_sum_reference(rows, w):
    """Plain PyTorch version: sum over the corners of rows * w, with the
    rows promoted to w's dtype."""
    return torch.sum(rows * w[..., None], dim=1)


def corner_sum_sequential(rows, w):
    """The kernel's order: each product rounded, then summed over the
    corners k = 0..7 one at a time."""
    prod = rows.to(w.dtype) * w[..., None]
    acc = prod[:, 0]
    for k in range(1, prod.shape[1]):
        acc = acc + prod[:, k]
    return acc


def corner_sum(rows, w):
    """sum_k w[n, k] * rows[n, k, :] over the 8 corners.

    Args:
        rows: (N, 8, F), float32 or bfloat16 (float64 on the CPU only).
            F in {1, 2, 4, 8} on the card.
        w: (N, 8) weights in the accumulation dtype (float32 on the card).
    Returns:
        (N, F) in w's dtype.
    """
    global LAUNCHES
    if rows.dim() != 3 or w.dim() != 2:
        raise ValueError(f"expected rows (N, 8, F) and w (N, 8), got "
                         f"{tuple(rows.shape)}, {tuple(w.shape)}")
    if rows.shape[1] != 8 or tuple(w.shape) != tuple(rows.shape[:2]):
        raise ValueError(f"rows {tuple(rows.shape)} and w {tuple(w.shape)} "
                         f"do not hold 8 corners along dim 1")
    if w.device != rows.device:
        raise ValueError(f"w on {w.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return corner_sum_reference(rows, w)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 rows and "
                        f"float32 weights, got {rows.dtype} and {w.dtype}")
    n, f = rows.shape[0], rows.shape[2]
    if f not in (1, 2, 4, 8):
        raise ValueError(f"the CUDA kernel takes F in (1, 2, 4, 8), got {f}")
    if not (rows.is_contiguous() and w.is_contiguous()):
        raise ValueError("rows and w must be contiguous")
    if rows.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rows and w must be 16-byte aligned")
    from . import _cuda_build

    lib = _cuda_build.library()
    out = torch.empty((n, f), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.corner_sum_f32(
            rows.data_ptr(), w.data_ptr(), out.data_ptr(), n, f,
            int(rows.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"corner_sum_f32 launch failed: CUDA {err}")
    LAUNCHES += 1
    return out
