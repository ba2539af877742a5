"""Microbenchmarks of the port's kernels at the Pallas probe shapes
(counterpart of scripts/perf_microbench.py's two Pallas cases):

    python -m deblur_e_nerf_tpu_torch.perf_microbench [case ...]

  pallas_probe         K2: the row scatter-add (csrc/scatter_rows.cu) of
                       65,536 x 16 float32 rows into 4,096 rows, checked
                       against an accumulating index_put_ (`.at[idx].add`)
  pallas_gather_probe  K3: the row gather (csrc/gather_rows.cu) of 65,536
                       rows from a 4,096 x 16 float32 table, checked
                       against index_select (`jnp.take`)

Each case prints one JSON line: the kernel's time, its error against the
check the JAX case makes (with the tolerance), the plain version's time,
the library call's time (`index_add_`, `index_select`) and the least time
the card could take (bytes over 3.35 TB/s). It runs on a CUDA card only
and fails without one; the JAX script's XLA-only cases (scatter_baseline,
scatter_rows, scatter_bf16, sort_boundary_diff, gather_rows) are not
ported yet.
"""

import json
import subprocess
import sys

import torch

from .ops import gather_rows, scatter_rows
from .utils.device import resolve_device

# H100 SXM published peaks at the full 700 W power limit: HBM bytes/s and
# dense float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PROBE_ROWS = 1 << 16      # contributions / gathered rows
PROBE_TABLE_ROWS = 4096   # table rows
PROBE_WIDTH = 16


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, nops=0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def gather_bytes(table, idx, out_dtype=torch.float32):
    """Bytes a gather must move: each touched table row and each index
    read once, each output row written once in `out_dtype`."""
    n_rows, width = table.shape
    touched = int((torch.bincount(idx.long(), minlength=n_rows) > 0).sum())
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return (touched * width * table.element_size()
            + idx.numel() * idx.element_size()
            + idx.numel() * width * out_size)


def probe_inputs(device, seed=0):
    """K2/K3's inputs: int32 indices in [0, 4096) and float32 normal
    values, both (65536, ...), and a (4096, 16) table."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randint(0, PROBE_TABLE_ROWS, (PROBE_ROWS,), generator=gen,
                        device=device, dtype=torch.int32)
    val = torch.randn((PROBE_ROWS, PROBE_WIDTH), generator=gen,
                      device=device)
    tbl = torch.randn((PROBE_TABLE_ROWS, PROBE_WIDTH), generator=gen,
                      device=device)
    return idx, val, tbl


def case_pallas_probe(device="cuda"):
    """K2: the K1 kernel at the probe's shapes."""
    device = resolve_device(device)
    idx, val, _ = probe_inputs(device)
    n_rows = PROBE_TABLE_ROWS
    out = scatter_rows.scatter_add_rows(idx, val, n_rows)
    want = torch.zeros((n_rows, PROBE_WIDTH), device=device).index_put_(
        (idx.long(),), val, accumulate=True)
    err = float((out - want).abs().max())
    # both sum each row's k contributions in some order: each is within
    # (k-1) eps sum|x| of the exact sum
    counts = torch.bincount(idx.long(), minlength=n_rows)
    abs_sum = scatter_rows.scatter_add_rows_reference(idx, val.abs(),
                                                      n_rows)
    tol = 2.0 * max(int(counts.max()) - 1, 1) \
        * torch.finfo(torch.float32).eps * float(abs_sum.max())
    row = {"case": "pallas_probe", "kernel": "scatter_add_rows",
           "n": PROBE_ROWS, "n_rows": n_rows, "width": PROBE_WIDTH,
           "max_abs_err": err, "tolerance": tol}
    if device.type == "cuda":
        idx64 = idx.long()
        row["ms"] = time_ms(
            lambda: scatter_rows.scatter_add_rows(idx, val, n_rows))
        row["plain_ms"] = time_ms(
            lambda: scatter_rows.scatter_add_rows_reference(idx, val,
                                                            n_rows))
        row["library_ms"] = time_ms(lambda: torch.zeros(
            (n_rows, PROBE_WIDTH), device=device).index_add_(0, idx64, val))
        row["bound_ms"], row["bound_by"] = bound(
            val.numel() * 4 + idx.numel() * 4 + n_rows * PROBE_WIDTH * 4,
            val.numel())
    return row


def case_pallas_gather_probe(device="cuda"):
    """K3: the gather kernel at the probe's shapes (no rounding)."""
    device = resolve_device(device)
    idx, _, tbl = probe_inputs(device)
    out = gather_rows.gather_rows(tbl, idx)
    err = float((out - torch.index_select(tbl, 0, idx.long())).abs().max())
    row = {"case": "pallas_gather_probe", "kernel": "gather_rows",
           "n": PROBE_ROWS, "n_rows": PROBE_TABLE_ROWS,
           "width": PROBE_WIDTH, "max_abs_err": err, "tolerance": 0.0}
    if device.type == "cuda":
        idx64 = idx.long()
        row["ms"] = time_ms(lambda: gather_rows.gather_rows(tbl, idx))
        row["plain_ms"] = time_ms(
            lambda: gather_rows.gather_rows_reference(tbl, idx))
        row["library_ms"] = time_ms(
            lambda: torch.index_select(tbl, 0, idx64))
        row["bound_ms"], row["bound_by"] = bound(gather_bytes(tbl, idx))
    return row


CASES = {
    "pallas_probe": case_pallas_probe,
    "pallas_gather_probe": case_pallas_gather_probe,
}


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(CASES)
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: "
          f"{smi.stdout.strip()}", flush=True)
    ok = True
    for name in names:
        row = CASES[name](device)
        ok &= row["max_abs_err"] <= row["tolerance"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
