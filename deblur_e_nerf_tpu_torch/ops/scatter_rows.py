"""Row scatter-add `out[idx[i], :] += val[i, :]` into a fresh zero table
(counterpart of deblur_e_nerf_tpu/ops/pallas_scatter.py, the Pallas TPU
kernel K1).

On a CUDA tensor `scatter_add_rows` launches the hand-written kernel in
`csrc/scatter_rows.cu` (one thread per element, f32 atomicAdd into device
memory; see the note there for what bounds it) or raises; it never falls
back. On a CPU tensor it runs the plain PyTorch version,
`scatter_add_rows_reference`. `LAUNCHES` counts kernel launches.

The hash-grid table backward (models/hash_encoding.py) calls this once per
level: dense levels with (res^3, 8F) packed cell rows, cellhash levels with
(size/8, 8F) rows, vertex-hash levels with (size, F) rows.
"""

import torch

LAUNCHES = 0  # kernel launches since the last reset (plain int)


def scatter_add_rows_reference(idx, val, n_rows, dtype=None):
    """Plain PyTorch version: zeros(n_rows, W).index_add_(0, idx, val), in
    `dtype` (default: val's dtype; float64 for exactness tests)."""
    dtype = val.dtype if dtype is None else dtype
    out = torch.zeros((int(n_rows), val.shape[1]), dtype=dtype,
                      device=val.device)
    return out.index_add_(0, idx.to(torch.int64), val.to(dtype))


def scatter_add_rows(idx, val, n_rows):
    """out[idx[i], :] += val[i, :] over a fresh (n_rows, W) zero table.

    Args:
        idx: (N,) int32 row indices in [0, n_rows), contiguous.
        val: (N, W) float32 contribution rows, contiguous (float64 is
            accepted on the CPU only).
        n_rows: output row count.
    """
    global LAUNCHES
    if idx.dim() != 1 or val.dim() != 2 or idx.shape[0] != val.shape[0]:
        raise ValueError(
            f"expected idx (N,) and val (N, W), got {tuple(idx.shape)} and "
            f"{tuple(val.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != val.device:
        raise ValueError(f"idx on {idx.device}, val on {val.device}")
    if val.device.type == "cpu":
        if val.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"val must be float32/64, got {val.dtype}")
        return scatter_add_rows_reference(idx, val, n_rows)
    if val.device.type != "cuda":
        raise ValueError(f"unsupported device {val.device}")
    if val.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 val, got {val.dtype}")
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("idx and val must be contiguous")
    from . import _cuda_build

    lib = _cuda_build.library()
    n, width = val.shape
    out = torch.zeros((int(n_rows), width), dtype=torch.float32,
                      device=val.device)
    if n == 0 or width == 0:
        return out
    with torch.cuda.device(val.device):
        stream = torch.cuda.current_stream(val.device).cuda_stream
        err = lib.scatter_add_rows_f32(
            idx.data_ptr(), val.data_ptr(), out.data_ptr(), n, width,
            int(n_rows), stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows_f32 launch failed: CUDA {err}")
    LAUNCHES += 1
    return out
