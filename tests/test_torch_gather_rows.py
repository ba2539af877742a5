"""The row gather (ops/gather_rows.py) on the CPU, where it runs its plain
version: against jnp.take at the Pallas probe K3's shapes and the
flagship encode's, float32 rows and bfloat16 rows (the JAX encode's
gather from its cast table), its argument errors, the port's
microbenchmark checks at the K2/K3 shapes, and the hash-grid encode of
all five otypes (now one fused encode, ops/hash_encode.py, with no
per-level gather) against the JAX encode and the per-level gather's
encode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import hash_encoding as jhe
from deblur_e_nerf_tpu_torch import perf_microbench
from deblur_e_nerf_tpu_torch.models import hash_encoding
from deblur_e_nerf_tpu_torch.ops import gather_rows, hash_encode


def _k3_inputs(n_rows=4096, width=16, n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n).astype(np.int32)
    tbl = rng.normal(size=(n_rows, width)).astype(np.float32)
    return idx, tbl


# (table rows, W, N): the Pallas probe's, then the flagship encode's
# tables (cellhash view, packed dense level 0, vertex-hash level) at a
# smaller N
K3_SHAPES = {
    "probe": (4096, 16, 1 << 16),
    "cellhash": (65536, 16, 1 << 16),
    "dense0": (16 ** 3, 16, 1 << 16),
    "vertex_hash": (524288, 2, 8 << 16),
}


@pytest.mark.parametrize("shape", sorted(K3_SHAPES))
@pytest.mark.parametrize("round_to", [None, torch.bfloat16])
def test_plain_gather_matches_jnp_take_at_k3_shapes(round_to, shape):
    n_rows, width, n = K3_SHAPES[shape]
    idx, tbl = _k3_inputs(n_rows, width, n)
    got = gather_rows.gather_rows(torch.from_numpy(tbl),
                                  torch.from_numpy(idx), round_to)
    jtbl = jnp.asarray(tbl)
    if round_to is not None:  # the JAX encode's gather from its cast table
        jtbl = jtbl.astype(jnp.bfloat16)
    want = np.asarray(jnp.take(jtbl, jnp.asarray(idx), axis=0))
    assert got.dtype == (round_to or torch.float32)
    assert got.shape == (n, width)
    # a copy (and round to nearest even): bit for bit
    np.testing.assert_array_equal(got.view(torch.int16 if round_to else
                                           torch.int32).numpy(),
                                  want.view(np.int16 if round_to else
                                            np.int32))


def test_gather_argument_errors():
    tbl = torch.zeros((8, 2))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_rows.gather_rows(tbl, idx.long())
    with pytest.raises(ValueError):
        gather_rows.gather_rows(tbl[:, 0], idx)
    with pytest.raises(ValueError):
        gather_rows.gather_rows(tbl, idx[None])
    with pytest.raises(TypeError):
        gather_rows.gather_rows(tbl.half(), idx)
    with pytest.raises(IndexError):  # the plain version checks its range
        gather_rows.gather_rows(tbl, torch.tensor([8], dtype=torch.int32))
    with pytest.raises(TypeError):  # rounding needs a floating dtype
        gather_rows.gather_rows(tbl, idx, torch.int32)
    launches = gather_rows.LAUNCHES
    gather_rows.gather_rows(tbl, idx)
    assert gather_rows.LAUNCHES == launches  # no kernel on the CPU


@pytest.mark.parametrize("case", sorted(set(perf_microbench.CASES)
                                        - set(perf_microbench.LIBRARY_CASES)))
def test_microbench_checks_hold_on_cpu(case):
    """The microbenchmark's probes' own checks, on their plain versions."""
    row = perf_microbench.CASES[case]("cpu")
    assert row["max_abs_err"] <= row["tolerance"]
    assert perf_microbench.within(row)
    assert "ms" not in row  # no time from a CPU run


@pytest.mark.parametrize("case", perf_microbench.LIBRARY_CASES)
def test_microbench_library_baselines_refuse_to_run_without_a_card(case):
    """The library baselines (the JAX script's XLA-only cases) time the
    card and nothing else: without one they raise, by default and when
    given the CPU, before any work."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_microbench.CASES[case]()
    with pytest.raises(ValueError, match="CUDA card only"):
        perf_microbench.CASES[case]("cpu")


def test_sort_boundary_diff_is_the_segment_sum():
    """The sort_boundary_diff baseline's algorithm (sort by index, cumsum,
    searchsorted bounds, difference) on the CPU at a small size, with
    empty rows among the table's, against index_add_ in float64 within
    its stated 2 N eps sum|x|, and bit for bit on integer-valued data."""
    gen = torch.Generator().manual_seed(0)
    n, n_rows = 5000, 3000  # many rows get no contribution
    idx = torch.randint(0, n_rows, (n,), generator=gen, dtype=torch.int32)
    v = torch.randn((n,), generator=gen, dtype=torch.float64)
    got, = perf_microbench.sort_boundary_diff(idx, [v], n_rows)
    want = torch.zeros(n_rows, dtype=torch.float64).index_add_(
        0, idx.long(), v)
    tol = 2 * n * torch.finfo(torch.float64).eps * float(v.abs().sum())
    assert float((got - want).abs().max()) <= tol
    assert bool((got[torch.bincount(idx.long(), minlength=n_rows) == 0]
                 == 0).all())
    ints = torch.randint(-50, 50, (n,), generator=gen).float()
    a, b = perf_microbench.sort_boundary_diff(idx, [ints, 2 * ints], n_rows)
    exact = torch.zeros(n_rows).index_add_(0, idx.long(), ints)
    assert torch.equal(a, exact) and torch.equal(b, 2 * exact)


def test_microbench_within_reads_every_width():
    """`within` holds a case with one row or with rows by width."""
    ok = {"max_abs_err": 1.0, "tolerance": 1.0}
    bad = {"max_abs_err": 2.0, "tolerance": 1.0}
    assert perf_microbench.within(ok) and not perf_microbench.within(bad)
    assert perf_microbench.within({"rows": [ok, ok]})
    assert not perf_microbench.within({"rows": [ok, bad]})


def _pack_dense_segment(segment, res):
    """((res+1)^3, F) vertex segment -> (res^3, 8F) cell-corner rows (the
    packed view the per-level gather read dense levels from)."""
    F = segment.shape[-1]
    g = segment.reshape(res + 1, res + 1, res + 1, F)  # (z, y, x, F)
    parts = [g[dz:dz + res, dy:dy + res, dx:dx + res]
             for dx, dy, dz in hash_encode.CORNER_OFFSETS.tolist()]
    return torch.stack(parts, dim=-2).reshape(res ** 3, 8 * F)


def _old_encode(table, u, levels, compute_dtype):
    """The encode as it gathered before the fused encode: one row gather
    per level from the table cast to compute_dtype (dense levels from the
    packed (res^3, 8F) cell-corner view, cellhash levels from the
    (T/8, 8F) view, vertex-hash levels 8 vertex rows), then the weighted
    corner sum."""
    uc = torch.clamp(u, 0.0, 1.0)
    T, F = table.shape
    tbl = table.to(compute_dtype or table.dtype)
    acc = table.dtype if compute_dtype is None else torch.float32
    features = []
    for res, size, offset, mode in levels:
        rows, w = hash_encode.level_rows_weights(uc, res, size, offset, mode,
                                                 acc)
        if mode == "dense":
            packed = _pack_dense_segment(
                tbl[offset:offset + (res + 1) ** 3], res)
            cell = torch.clamp(torch.floor(uc * res), 0, res - 1).long()
            flat = (cell[:, 2] * res + cell[:, 1]) * res + cell[:, 0]
            values = packed[flat].reshape(-1, 8, F)
        elif mode == "cellhash":
            values = tbl.reshape(T // 8, 8 * F)[rows[:, 0] // 8].reshape(
                -1, 8, F)
        else:
            values = tbl[rows]
        features.append(torch.sum(values.to(acc) * w[..., None], dim=-2))
    return torch.cat(features, dim=-1)


# (n_levels, base_resolution, per_level_scale, log2_hashmap_size) per otype
ENCODE_LAYOUTS = {
    "HybridHashGrid": (8, 4, 2.0, 12),  # dense, hash and cellhash levels
    "HashGrid": (8, 4, 2.0, 12),
    "TiledGrid": (8, 4, 2.0, 12),
    "CellHashGrid": (8, 4, 2.0, 12),
    "DenseGrid": (3, 4, 2.0, 12),
}


@pytest.mark.parametrize("otype", ["HybridHashGrid", "HashGrid",
                                   "TiledGrid", "CellHashGrid",
                                   "DenseGrid"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_encode_unchanged_with_gather_routed(otype, compute_dtype,
                                             monkeypatch):
    levels, total = hash_encoding.grid_layout(otype,
                                              *ENCODE_LAYOUTS[otype])
    if otype == "HybridHashGrid":  # all three gathers of the flagship
        assert {m for *_, m in levels} == {"dense", "hash", "cellhash"}
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.uniform(-1, 1, (total, 2)).astype(
        np.float32))
    u = torch.from_numpy(rng.uniform(-0.05, 1.05, (3000, 3)).astype(
        np.float32))
    gathers, encodes = [], []
    real_gather, real_encode = gather_rows.gather_rows, \
        hash_encode.encode_forward

    def counting_gather(*args, **kwargs):
        gathers.append(args)
        return real_gather(*args, **kwargs)

    def counting_encode(*args, **kwargs):
        encodes.append(args[1].shape)
        return real_encode(*args, **kwargs)

    monkeypatch.setattr(gather_rows, "gather_rows", counting_gather)
    monkeypatch.setattr(hash_encode, "encode_forward", counting_encode)
    got = hash_encoding._encode_impl(table, u, levels, compute_dtype)
    want = jhe.encode(jnp.asarray(table.numpy()), jnp.asarray(u.numpy()),
                      levels, differentiable_positions=False,
                      compute_dtype=None if compute_dtype is None
                      else jnp.bfloat16)
    # the JAX encode gathers the same (rounded) values and sums the 8
    # float32 products in its own order: the tolerances of
    # tests/test_torch_hash_encoding.py
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the same values (dense levels now read from the vertex rows, not a
    # packed view), rounded elementwise, summed in the order of the
    # per-level gather's encode: bit for bit
    torch.testing.assert_close(got, _old_encode(table, u, levels,
                                                compute_dtype),
                               rtol=0, atol=0)
    # one fused encode over all levels, no per-level gather
    assert encodes == [(3000, 3)] and gathers == []


def test_vertex_hash_orders_gather_the_same_rows():
    """chip_smoke's vertex-hash index generator (ray-ordered runs of
    samples through the encode's index function): the corner-major
    indices are the sample-major ones transposed, in range, and their
    gathers hold the same rows in the two orders."""
    import chip_smoke

    n, size = 5000, 524288
    sample = chip_smoke.vertex_hash_indices(torch, n, size, False,
                                            device="cpu")
    corner = chip_smoke.vertex_hash_indices(torch, n, size, True,
                                            device="cpu")
    assert sample.dtype == corner.dtype == torch.int32
    assert torch.equal(sample.reshape(n, 8).T.reshape(-1), corner)
    assert int(corner.min()) >= 0 and int(corner.max()) < size
    # ray-ordered runs: consecutive samples share a cell, so one corner
    # of 128 consecutive samples asks for far fewer than 128 rows
    assert len(set(corner[:128].tolist())) < 64
    tbl = torch.from_numpy(np.random.default_rng(2).normal(
        size=(size, 2)).astype(np.float32))
    rows_s = gather_rows.gather_rows(tbl, sample, torch.bfloat16)
    rows_c = gather_rows.gather_rows(tbl, corner, torch.bfloat16)
    assert torch.equal(rows_s.reshape(n, 8, 2).transpose(0, 1),
                       rows_c.reshape(8, n, 2))


@pytest.mark.parametrize("dtype,width", [(torch.float32, 1),
                                         (torch.float32, 8),
                                         (torch.bfloat16, 1)])
def test_microbench_scatter_check_holds_each_row(dtype, width):
    """The scatter baselines' check (`scatter_check`) on index_add_ on the
    CPU, at the cases' 32 contributions a row (2^20 into 2^15 rows): within
    every row's tolerance ((k - 1) eps sum|x| in float32, BF16_EPS eps
    sum|x| in bfloat16), and refused with the largest
    contribution misrouted to the next row, or with one row's sum off by
    the largest contribution."""
    gen = torch.Generator().manual_seed(0)
    n, n_rows = 1 << 20, 1 << 15
    idx = torch.randint(0, n_rows, (n,), generator=gen, dtype=torch.int32)
    val = torch.randn((n, width) if width > 1 else (n,), generator=gen
                      ).to(dtype)

    def call(i):
        return torch.zeros((n_rows, *val.shape[1:]), dtype=dtype) \
            .index_add_(0, i, val)

    err, ratio, misrouted = perf_microbench.scatter_check(idx, val, n_rows,
                                                          call)
    print(dtype, width, err, ratio, misrouted)
    assert 0 <= ratio <= 1 < misrouted
    assert perf_microbench.within({"max_abs_err": err,
                                   "error_over_tolerance": ratio,
                                   "misrouted_error_over_tolerance":
                                   misrouted})
    if dtype == torch.bfloat16:
        # far inside the tolerance: a random walk of roundings
        assert ratio <= 0.5
    big = float(val.double().abs().max())

    def off(i):
        out = call(i)
        out[7] += big
        return out

    assert perf_microbench.scatter_check(idx, val, n_rows, off)[1] > 1
