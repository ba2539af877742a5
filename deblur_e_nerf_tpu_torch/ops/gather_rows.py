"""Row gather `out[i, :] = table[idx[i], :]`, optionally rounded to
bfloat16 rows (counterpart of the Pallas TPU kernel K3,
scripts/perf_microbench.py `case_pallas_gather_probe`, and of the gathers
in deblur_e_nerf_tpu/models/hash_encoding.py `_encode_impl`,
`jnp.take(table.astype(compute_dtype), idx)`).

On a CUDA tensor `gather_rows` launches the hand-written kernel in
`csrc/gather_rows.cu` (one instance per main-path width and output type;
see the note there for what bounds it) or raises; it never falls back. On
a CPU tensor it runs the plain PyTorch version, `gather_rows_reference`.
`LAUNCHES` counts kernel launches.

The kernel does not check indices on the card (that would need a host
sync): the caller builds them in [0, T). An index out of range reads
nothing and yields a zero row on the card; the plain version raises.

No path of the port calls it since the hash-grid encode was fused
(ops/hash_encode.py); chip_smoke.py holds it to its plain version at the
shapes the per-level encode gave it, and perf_microbench.py at the Pallas
probe's.
"""

import torch

LAUNCHES = 0  # kernel launches since the last reset (plain int)


def gather_rows_reference(table, idx, round_to=None):
    """Plain PyTorch version: table.index_select(0, idx), converted to
    `round_to` (e.g. torch.bfloat16: round to nearest even) when given."""
    out = table.index_select(0, idx.to(torch.int64))
    return out if round_to is None else out.to(round_to)


def gather_rows(table, idx, round_to=None):
    """out[i, :] = table[idx[i], :].

    Args:
        table: (T, W) float32 rows, contiguous (float64 is accepted on the
            CPU only).
        idx: (N,) int32 row indices in [0, T), contiguous.
        round_to: None, or a floating dtype to round each gathered value
            to (the kernel takes torch.bfloat16: round to nearest even).
    Returns:
        (N, W) in `round_to`, or in table's dtype when it is None.
    """
    global LAUNCHES
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(
            f"expected table (T, W) and idx (N,), got {tuple(table.shape)} "
            f"and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")
    if round_to is not None and not round_to.is_floating_point:
        raise TypeError(f"round_to must be a floating dtype, got {round_to}")
    if table.device.type == "cpu":
        if table.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"table must be float32/64, got {table.dtype}")
        return gather_rows_reference(table, idx, round_to)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernel takes a float32 table, got {table.dtype}")
    if round_to not in (None, torch.bfloat16):
        raise TypeError(f"the CUDA kernel rounds to torch.bfloat16 only, "
                        f"got {round_to}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    from . import _cuda_build

    lib = _cuda_build.library()
    n_rows, width = table.shape
    n = idx.shape[0]
    out = torch.empty((n, width), dtype=round_to or torch.float32,
                      device=table.device)
    if n == 0 or width == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.gather_rows_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, width,
            n_rows, int(round_to is not None), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows_f32 launch failed: CUDA {err}")
    LAUNCHES += 1
    return out
