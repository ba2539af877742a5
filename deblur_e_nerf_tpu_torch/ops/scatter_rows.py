"""Row scatter-add `out[idx[i], :] += val[i, :]` into a fresh zero table
(counterpart of deblur_e_nerf_tpu/ops/pallas_scatter.py, the Pallas TPU
kernel K1).

On a CUDA tensor `scatter_add_rows` launches the hand-written kernel in
`csrc/scatter_rows.cu` (vector atomics over 16-byte row chunks, zero
contributions skipped, runs of equal indices combined in registers; see
the note there for what bounds it) or raises; it never falls back. On a
CPU tensor it runs the plain PyTorch version, `scatter_add_rows_reference`.
`scatter_add_rows_combined` is a plain model of the kernel's summation
order, for tests. `LAUNCHES` counts kernel launches.

No path of the port calls it since the hash-grid table backward was fused
(ops/hash_encode.py); chip_smoke.py holds it to its plain version at the
shapes the per-level backward gave it, and perf_microbench.py at the
Pallas probe's.
"""

import torch

LAUNCHES = 0  # kernel launches since the last reset (plain int)
KERNEL_ROWS = 8  # consecutive rows one kernel thread combines (kRows)

_launch = None  # the kernel library's C entry point, bound at first use


def scatter_add_rows_reference(idx, val, n_rows, dtype=None):
    """Plain PyTorch version: zeros(n_rows, W).index_add_(0, idx, val), in
    `dtype` (default: val's dtype; float64 for exactness tests)."""
    dtype = val.dtype if dtype is None else dtype
    out = torch.zeros((int(n_rows), val.shape[1]), dtype=dtype,
                      device=val.device)
    return out.index_add_(0, idx.to(torch.int64), val.to(dtype))


def scatter_add_rows_combined(idx, val, n_rows, rows=KERNEL_ROWS):
    """Plain model of the kernel's order: the rows are cut into groups of
    `rows` consecutive rows; in each group, every run of equal adjacent
    indices is summed; runs whose sum is 0 in every column, or whose index
    lies outside [0, n_rows), are dropped; the remaining run sums are
    index_add_-ed into a zero table. Equal to `scatter_add_rows_reference`
    up to summation order."""
    n = idx.shape[0]
    out = torch.zeros((int(n_rows), val.shape[1]), dtype=val.dtype,
                      device=val.device)
    if n == 0:
        return out
    idx = idx.to(torch.int64)
    pos = torch.arange(n, device=idx.device)
    head = (pos % rows == 0)
    head[1:] |= idx[1:] != idx[:-1]
    run = torch.cumsum(head.to(torch.int64), dim=0) - 1
    sums = torch.zeros((int(run[-1]) + 1, val.shape[1]), dtype=val.dtype,
                       device=val.device).index_add_(0, run, val)
    run_idx = idx[head]
    keep = (sums != 0).any(dim=1) & (run_idx >= 0) & (run_idx < n_rows)
    return out.index_add_(0, run_idx[keep], sums[keep])


def _bind():
    global _launch
    from . import _cuda_build

    _launch = _cuda_build.library().scatter_add_rows_f32
    return _launch


def scatter_add_rows(idx, val, n_rows):
    """out[idx[i], :] += val[i, :] over a fresh (n_rows, W) zero table.

    Args:
        idx: (N,) int32 row indices, contiguous; indices outside
            [0, n_rows) add nothing on the card (the plain version raises).
        val: (N, W) float32 contribution rows, contiguous, and on the card
            aligned to 16 bytes when W % 4 == 0, to 8 when W is even
            (float64 is accepted on the CPU only).
        n_rows: output row count.
    """
    global LAUNCHES
    if idx.dim() != 1 or val.dim() != 2 or idx.shape[0] != val.shape[0]:
        raise ValueError(
            f"expected idx (N,) and val (N, W), got {tuple(idx.shape)} and "
            f"{tuple(val.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not val.is_cuda:
        if val.device.type != "cpu":
            raise ValueError(f"unsupported device {val.device}")
        if idx.device != val.device:
            raise ValueError(f"idx on {idx.device}, val on {val.device}")
        if val.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"val must be float32/64, got {val.dtype}")
        return scatter_add_rows_reference(idx, val, n_rows)
    # the card: checks kept cheap, this path's host time is the call's at
    # small N
    device = val.device
    if idx.device != device:
        raise ValueError(f"idx on {idx.device}, val on {device}")
    if val.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 val, got {val.dtype}")
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("idx and val must be contiguous")
    n, width = val.shape
    n_rows = int(n_rows)
    # the kernel's vector: a float4 chunk for W % 4 == 0, float2 for even W
    align = 16 if width % 4 == 0 else (8 if width % 2 == 0 else 4)
    val_ptr = val.data_ptr()
    if val_ptr % align:
        raise ValueError(f"val is not {align}-byte aligned (a view at an "
                         f"offset?); the kernel's W={width} rows need it")
    if n == 0 or width == 0:
        return torch.zeros((n_rows, width), dtype=torch.float32,
                           device=device)
    # the entry point zeroes `out` itself (one PyTorch call fewer)
    out = torch.empty((n_rows, width), dtype=torch.float32, device=device)
    launch = _launch or _bind()
    index = device.index
    args = (idx.data_ptr(), val_ptr, out.data_ptr(), n, width, n_rows,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows_f32 launch failed: CUDA {err}")
    LAUNCHES += 1
    return out
