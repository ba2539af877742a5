"""The row gather (ops/gather_rows.py) on the CPU, where it runs its plain
version: against jnp.take at the Pallas probe K3's shapes, with and
without bfloat16 rounding, its argument errors, the port's
microbenchmark checks at the K2/K3 shapes, and the hash-grid encode with
every level's gather routed through it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu_torch import perf_microbench
from deblur_e_nerf_tpu_torch.models import hash_encoding
from deblur_e_nerf_tpu_torch.ops import gather_rows


def _k3_inputs(seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4096, 1 << 16).astype(np.int32)
    tbl = rng.normal(size=(4096, 16)).astype(np.float32)
    return idx, tbl


@pytest.mark.parametrize("round_to", [None, torch.bfloat16])
def test_plain_gather_matches_jnp_take_at_k3_shapes(round_to):
    idx, tbl = _k3_inputs()
    got = gather_rows.gather_rows(torch.from_numpy(tbl),
                                  torch.from_numpy(idx), round_to)
    jtbl = jnp.asarray(tbl)
    if round_to is not None:
        jtbl = jtbl.astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jnp.take(jtbl, jnp.asarray(idx), axis=0))
    assert got.dtype == torch.float32 and got.shape == (1 << 16, 16)
    # a copy (and round to nearest even): bit for bit
    np.testing.assert_array_equal(got.numpy(), want)


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
    launches = gather_rows.LAUNCHES
    gather_rows.gather_rows(tbl, idx)
    assert gather_rows.LAUNCHES == launches  # no kernel on the CPU


@pytest.mark.parametrize("case", sorted(perf_microbench.CASES))
def test_microbench_checks_hold_on_cpu(case):
    """The microbenchmark's own checks, on its plain versions."""
    row = perf_microbench.CASES[case]("cpu")
    assert row["max_abs_err"] <= row["tolerance"]
    assert "ms" not in row  # no time from a CPU run


def _old_encode(table, u, levels, compute_dtype):
    """The encode as it gathered before the gather was routed through
    ops/gather_rows.py: the whole table cast to compute_dtype, then
    indexed."""
    uc = torch.clamp(u, 0.0, 1.0)
    T, F = table.shape
    tbl = table.to(compute_dtype or table.dtype)
    acc = table.dtype if compute_dtype is None else torch.float32
    features = []
    for res, size, offset, mode in levels:
        if mode == "dense":
            packed = hash_encoding._pack_dense_segment(
                tbl[offset:offset + (res + 1) ** 3], res)
            flat, w = hash_encoding._dense_cell_index_weights(uc, res, acc)
            rows = packed[flat].reshape(-1, 8, F)
        elif mode == "cellhash":
            h, w = hash_encoding._cellhash_index_weights(uc, res, size, acc)
            rows = tbl.reshape(T // 8, 8 * F)[h + offset // 8].reshape(
                -1, 8, F)
        else:
            idx, w = hash_encoding._level_indices_weights(
                uc, res, size, offset, mode, acc)
            rows = tbl[idx]
        features.append(torch.sum(rows.to(acc) * w[..., None], dim=-2))
    return torch.cat(features, dim=-1)


@pytest.mark.parametrize("otype", ["HybridHashGrid", "HashGrid",
                                   "TiledGrid"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_encode_unchanged_with_gather_routed(otype, compute_dtype,
                                             monkeypatch):
    levels, total = hash_encoding.grid_layout(otype, 8, 4, 2.0, 12)
    if otype == "HybridHashGrid":  # all three gathers of the flagship
        assert {m for *_, m in levels} == {"dense", "hash", "cellhash"}
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.uniform(-1, 1, (total, 2)).astype(
        np.float32))
    u = torch.from_numpy(rng.uniform(-0.05, 1.05, (3000, 3)).astype(
        np.float32))
    calls = []
    real = gather_rows.gather_rows

    def counting(tbl, idx, round_to=None):
        calls.append((tuple(tbl.shape), idx.numel(), round_to))
        return real(tbl, idx, round_to)

    monkeypatch.setattr(gather_rows, "gather_rows", counting)
    got = hash_encoding._encode_impl(table, u, levels, compute_dtype)
    want = _old_encode(table, u, levels, compute_dtype)
    # the same values, rounded elementwise, summed in the same order
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(calls) == len(levels)  # one gather per level
    for (shape, n, round_to), (res, size, _, mode) in zip(calls, levels):
        assert round_to == compute_dtype
        if mode == "dense":
            assert shape == (res ** 3, 16) and n == 3000
        elif mode == "cellhash":
            assert shape == (size // 8, 16) and n == 3000
        else:
            assert shape == (size, 2) and n == 8 * 3000
