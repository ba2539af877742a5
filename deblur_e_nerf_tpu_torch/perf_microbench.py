"""Microbenchmarks of the port's kernels and their library yardsticks
(counterpart of every case of scripts/perf_microbench.py):

    python -m deblur_e_nerf_tpu_torch.perf_microbench [case ...]

The two Pallas probes, at their shapes:

  pallas_probe         K2: the row scatter-add (csrc/scatter_rows.cu) of
                       65,536 x 16 float32 rows into 4,096 rows, checked
                       against an accumulating index_put_ (`.at[idx].add`)
  pallas_gather_probe  K3: the row gather (csrc/gather_rows.cu) of 65,536
                       rows from a 4,096 x 16 float32 table, checked
                       against index_select (`jnp.take`)

The five library baselines of the hash table's forward and backward (the
JAX script's XLA-only cases, at its sizes: N = 2^24 contributions, T =
2^19 table rows, int32 indices uniform in the table; PyTorch's own calls,
by design: they are the yardsticks of the encode's and K1/K3's rows):

  scatter_baseline     index_add_ of N float32 values into T rows, held to
                       a float64 index_add_ row by row within (k - 1) eps
                       sum|x| of the row's k values
  scatter_rows         index_add_ of N / 8 rows of width 2, 8, 16 and 32
                       into T / 8 rows, held the same way
  scatter_bf16         index_add_ of N bfloat16 values into a bfloat16
                       table, held to a float64 index_add_ of the same
                       values within 8 eps_bf16 sum|x| of each row
                       (BF16_EPS)

Each scatter is held once more with its largest contribution sent to the
next row, and that check must fail (`scatter_check`).
  sort_boundary_diff   the exact segment sum of 2 channels without a
                       scatter: torch.sort by index, cumsum, searchsorted
                       of every row's bounds, the bounds' difference; the
                       same algorithm in float64 held to a float64
                       index_add_ within 2 N eps64 sum|x| (a bound on the
                       two prefix sums' rounding in any order), and the
                       float32 version's error against a float32
                       index_add_ printed as the JAX case prints it
  gather_rows          index_select of N / 8 rows of width 2 and 16 from a
                       (T, W) float32 table, held bit for bit to tbl[idx]

Each case prints one JSON line: the time (ms, and ns per element; CUDA
events over 20 calls after 3), its error and tolerance, the least time the
card could take (`bound`: each input read once and each output written
once over 3.35 TB/s, or the float32 operations over 67 TFLOP/s) and, for
the probes, the plain version's and the library call's times. Every case
runs on a CUDA card only: the library baselines raise without one, and the
probes run their plain versions when given device="cpu". Nothing of the
JAX script is left without a counterpart.
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
# the library baselines' sizes (scripts/perf_microbench.py:26-27)
N = 1 << 24               # contributions
T = 1 << 19               # table rows
SCATTER_ROW_WIDTHS = (2, 8, 16, 32)
GATHER_ROW_WIDTHS = (2, 16)
# the bfloat16 scatter's tolerance, in bfloat16 eps of each row's sum|x|:
# its k additions round in bfloat16 in an unknown order, a random walk
# that reached 1.8-2.4 eps sum|x| over the 2^19 rows in 24 calls on an
# H100 (0.22-0.30 of this tolerance), where the largest contribution sent
# to the next row read 2.9-3.0 of it; at the median row's sum|x| of 25 it
# is 1.6, against a median |value| of 3.8
BF16_EPS = 8


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


def _card(device):
    """The library baselines time the card: they refuse anything else."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the library baselines run on a CUDA card only, "
                         f"not on {device}")
    return device


def _generator(device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _indices(n, n_rows, gen, device):
    return torch.randint(0, n_rows, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def _scatter_tolerance(idx, val, n_rows):
    """Each row's tolerance, (n_rows, ...) in float64. float32: (k - 1)
    eps sum|x| of the row's k values (any order of k additions is within
    (k - 1) u sum|x| of the exact sum, u = eps / 2, and eps covers
    rounding the result once more). bfloat16: BF16_EPS eps sum|x| (that
    bound would exceed a typical row's value)."""
    abs_sum = torch.zeros((n_rows, *val.shape[1:]), dtype=torch.float64,
                          device=val.device).index_add_(
        0, idx.long(), val.double().abs())
    eps = torch.finfo(val.dtype).eps
    if val.dtype == torch.bfloat16:
        return BF16_EPS * eps * abs_sum
    counts = torch.bincount(idx.long(), minlength=n_rows).reshape(
        -1, *[1] * (val.dim() - 1))
    return (counts - 1).clamp_min(1) * eps * abs_sum


def scatter_check(idx, val, n_rows, call):
    """`call(idx)` (the scatter of `val` into n_rows rows by `idx`) held
    to a float64 index_add_ of the same values row by row
    (`_scatter_tolerance`), and the same with the contribution of the
    largest magnitude sent to the next row, which must fail: (the
    largest |error|, the largest error over its row's tolerance, the
    misrouted scatter's largest error over tolerance)."""
    want = torch.zeros((n_rows, *val.shape[1:]), dtype=torch.float64,
                       device=val.device).index_add_(0, idx.long(),
                                                     val.double())
    tol = _scatter_tolerance(idx, val, n_rows)

    def reading(got):
        err = (got.double() - want).abs()
        return float(err.max()), float((err / tol.clamp_min(
            torch.finfo(torch.float64).tiny)).max())

    err, ratio = reading(call(idx))
    j = int(val.double().abs().reshape(idx.numel(), -1).amax(1).argmax())
    wrong = idx.clone()
    wrong[j] = (int(idx[j]) + 1) % n_rows
    return err, ratio, reading(call(wrong))[1]


def _scatter_row(label, idx, val, n_rows, elements):
    """Time `torch.zeros(n_rows, ...).index_add_(0, idx, val)`, and hold it
    to a float64 index_add_ (`scatter_check`)."""
    def call(idx=idx):
        return torch.zeros((n_rows, *val.shape[1:]), dtype=val.dtype,
                           device=val.device).index_add_(0, idx, val)

    ms = time_ms(call)
    err, ratio, misrouted = scatter_check(idx, val, n_rows, call)
    nbytes = idx.numel() * idx.element_size() \
        + val.numel() * val.element_size() \
        + n_rows * (val.numel() // idx.numel()) * val.element_size()
    bound_ms, bound_by = bound(nbytes, val.numel())
    return {"label": label, "ms": ms, "ns_per_element": ms * 1e6 / elements,
            "ns_per_row": ms * 1e6 / idx.numel(), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err,
            "error_over_tolerance": ratio,
            "misrouted_error_over_tolerance": misrouted}


def case_scatter_baseline(device="cuda"):
    """index_add_ of N float32 values into T rows (one channel): the
    encode backward's per-channel library primitive."""
    device = _card(device)
    gen = _generator(device)
    idx = _indices(N, T, gen, device)
    val = torch.randn((N,), generator=gen, device=device)
    row = _scatter_row("scatter_1ch", idx, val, T, N)
    return dict(row, case="scatter_baseline", call="index_add_", n=N,
                n_rows=T)


def case_scatter_rows(device="cuda"):
    """index_add_ of N / 8 rows of each width into T / 8 rows (the
    cell-row candidates)."""
    device = _card(device)
    gen = _generator(device)
    idx = _indices(N // 8, T // 8, gen, device)
    rows = []
    for width in SCATTER_ROW_WIDTHS:
        val = torch.randn((N // 8, width), generator=gen, device=device)
        rows.append(dict(_scatter_row(f"scatter_row w={width}", idx, val,
                                      T // 8, val.numel()), width=width))
        del val
    return {"case": "scatter_rows", "call": "index_add_", "n": N // 8,
            "n_rows": T // 8, "rows": rows}


def case_scatter_bf16(device="cuda"):
    """index_add_ of N bfloat16 values into a bfloat16 table of T rows."""
    device = _card(device)
    gen = _generator(device)
    idx = _indices(N, T, gen, device)
    val = torch.randn((N,), generator=gen, device=device).to(torch.bfloat16)
    row = _scatter_row("scatter_1ch_bf16", idx, val, T, N)
    return dict(row, case="scatter_bf16", call="index_add_ (bfloat16)",
                n=N, n_rows=T)


def sort_boundary_diff(idx, values, n_rows):
    """Each row's sum of its values per channel, without a scatter: sort
    by index, cumsum each channel, find every row's [lo, hi) by
    searchsorted, and take csum[hi - 1] - csum[lo - 1] (0 for an empty
    row). `values` is a list of (N,) tensors; returns a list of (n_rows,)
    tensors in their dtype."""
    sidx, order = torch.sort(idx)
    bounds = torch.searchsorted(sidx, torch.arange(
        n_rows + 1, dtype=sidx.dtype, device=sidx.device))
    lo, hi = bounds[:-1], bounds[1:]
    out = []
    for v in values:
        c = torch.cumsum(v[order], 0)
        upper = c[(hi - 1).clamp_min(0)]
        lower = torch.where(lo > 0, c[(lo - 1).clamp_min(0)],
                            torch.zeros((), dtype=c.dtype, device=c.device))
        out.append(torch.where(hi > lo, upper - lower,
                               torch.zeros((), dtype=c.dtype,
                                           device=c.device)))
    return out


def case_sort_boundary_diff(device="cuda"):
    """The exact segment sum of 2 float32 channels by sort + cumsum +
    boundary difference (no scatter), timed; held in float64."""
    device = _card(device)
    gen = _generator(device)
    idx = _indices(N, T, gen, device)
    v0 = torch.randn((N,), generator=gen, device=device)
    v1 = torch.randn((N,), generator=gen, device=device)
    ms = time_ms(lambda: sort_boundary_diff(idx, [v0, v1], T))
    # the algorithm's check, in float64 against a float64 index_add_: in
    # any order each prefix sum is within (N - 1) u sum|x| of exact (u =
    # eps / 2), so a difference of two within (N - 1) eps sum|x|, plus its
    # own rounding and the reference's (each at most N u sum|x|): 2 N
    # eps64 sum|x| bounds it
    z64 = sort_boundary_diff(idx, [v0.double()], T)[0]
    want64 = torch.zeros((T,), dtype=torch.float64, device=device) \
        .index_add_(0, idx.long(), v0.double())
    err = float((z64 - want64).abs().max())
    tol = 2 * N * torch.finfo(torch.float64).eps \
        * float(v0.double().abs().sum())
    # the JAX case's print: float32 against a float32 scatter
    z0 = sort_boundary_diff(idx, [v0], T)[0]
    err32 = float((z0 - torch.zeros((T,), device=device)
                   .index_add_(0, idx, v0)).abs().max())
    nbytes = idx.numel() * 4 + 2 * N * 4 + 2 * T * 4
    bound_ms, bound_by = bound(nbytes)
    return {"case": "sort_boundary_diff",
            "call": "torch.sort + cumsum + searchsorted (2 channels)",
            "n": N, "n_rows": T, "ms": ms,
            "ns_per_element": ms * 1e6 / (2 * N), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "tolerance": tol,
            "float32_err_vs_index_add": err32}


def case_gather_rows(device="cuda"):
    """index_select of N / 8 rows of each width from a (T, W) float32
    table (the forward's cost model)."""
    device = _card(device)
    gen = _generator(device)
    rows = []
    for width in GATHER_ROW_WIDTHS:
        tbl = torch.randn((T, width), generator=gen, device=device)
        idx = _indices(N // 8, T, gen, device)
        ms = time_ms(lambda: torch.index_select(tbl, 0, idx))
        out = torch.index_select(tbl, 0, idx)
        err = float((out - tbl[idx.long()]).abs().max())
        bound_ms, bound_by = bound(gather_bytes(tbl, idx))
        rows.append({"label": f"gather_row w={width}", "width": width,
                     "ms": ms, "ns_per_row": ms * 1e6 / idx.numel(),
                     "ns_per_element": ms * 1e6 / out.numel(),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err, "tolerance": 0.0})
        del tbl, idx, out
    return {"case": "gather_rows", "call": "index_select", "n": N // 8,
            "n_rows": T, "rows": rows}


def within(row):
    """Whether a case's row (or each of its widths' rows) is within its
    tolerance: the scatters' largest error over their rows' tolerances at
    most 1 and their misrouted scatter's above 1 (`scatter_check`), the
    other rows' largest error at most their tolerance."""
    def held(r):
        if "error_over_tolerance" in r:
            return r["error_over_tolerance"] <= 1 \
                < r["misrouted_error_over_tolerance"]
        return r["max_abs_err"] <= r["tolerance"]

    return all(held(r) for r in row.get("rows", [row]))


CASES = {
    "scatter_baseline": case_scatter_baseline,
    "scatter_rows": case_scatter_rows,
    "scatter_bf16": case_scatter_bf16,
    "sort_boundary_diff": case_sort_boundary_diff,
    "gather_rows": case_gather_rows,
    "pallas_probe": case_pallas_probe,
    "pallas_gather_probe": case_pallas_gather_probe,
}
LIBRARY_CASES = ("scatter_baseline", "scatter_rows", "scatter_bf16",
                 "sort_boundary_diff", "gather_rows")


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
        ok &= within(row)
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
