"""Row scatter-add (K1): the port's plain version against the Pallas
kernel in interpret mode and the numpy `np.add.at` oracle, the plain model
of the CUDA kernel's summation order (`scatter_add_rows_combined`) against
both, and the wrapper's checks. The CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from deblur_e_nerf_tpu.ops import pallas_scatter as ps
from deblur_e_nerf_tpu_torch.ops import scatter_rows

K1_KINDS = ["uniform", "empty_tail", "ray_runs", "one_run", "all_zero",
            "signed_zeros", "nonfinite", "out_of_range"]


def _inputs(seed, n, n_rows, width):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n).astype(np.int32)
    val = rng.normal(size=(n, width)).astype(np.float32)
    return idx, val


@pytest.mark.parametrize("n,n_rows,width", [
    (5000, 512, 16),    # cellhash / dense packed rows
    (1025, 64, 16),     # not a multiple of the Pallas chunk
    (4096, 2048, 2),    # vertex-hash rows
])
def test_plain_matches_pallas_interpret_and_numpy(n, n_rows, width):
    idx, val = _inputs(0, n, n_rows, width)
    want = np.zeros((n_rows, width), np.float32)
    np.add.at(want, idx, val)
    pallas = np.asarray(ps.scatter_add_rows(
        jnp.asarray(idx), jnp.asarray(val), n_rows, interpret=True))
    before = scatter_rows.LAUNCHES
    out = scatter_rows.scatter_add_rows(
        torch.from_numpy(idx), torch.from_numpy(val), n_rows).numpy()
    # the CPU path is the plain version: no kernel launch is counted
    assert scatter_rows.LAUNCHES == before
    # f32 sums of <= ~40 N(0,1) terms in different orders
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=1e-5)


def test_plain_float64_option_is_exact_against_numpy():
    idx, val = _inputs(1, 3000, 128, 16)
    want = np.zeros((128, 16), np.float64)
    np.add.at(want, idx, val.astype(np.float64))
    out = scatter_rows.scatter_add_rows_reference(
        torch.from_numpy(idx), torch.from_numpy(val), 128,
        dtype=torch.float64).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_wrapper_rejects_bad_inputs():
    idx, val = _inputs(2, 16, 8, 2)
    i, v = torch.from_numpy(idx), torch.from_numpy(val)
    with pytest.raises(TypeError):
        scatter_rows.scatter_add_rows(i.long(), v, 8)
    with pytest.raises(ValueError):
        scatter_rows.scatter_add_rows(i[:8], v, 8)
    with pytest.raises(TypeError):
        scatter_rows.scatter_add_rows(i, v.half(), 8)


@pytest.mark.parametrize("width", [1, 2, 3, 16])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_combined_model_matches_plain_and_numpy(kind, width):
    """The model of the kernel's order (zero-sum runs and out-of-range
    indices dropped, runs of equal indices within 8-row groups summed,
    then index_add_) against index_add_ and np.add.at in float64, through
    chip_smoke's check (the tolerance it states: 2 (k - 1) eps sum|x| for
    a row of k non-zero contributions; non-finite entries exactly)."""
    n, n_rows = 3001, 97  # 3001 is not a multiple of the 8-row groups
    idx, val = chip_smoke.k1_inputs(kind, n, n_rows, width, seed=3)
    i, v = torch.from_numpy(idx), torch.from_numpy(val)
    got = scatter_rows.scatter_add_rows_combined(i, v, n_rows)
    errs, tol = chip_smoke.k1_check(torch, got, i, v, n_rows, kind)
    assert errs[1] == 0.0  # the model against itself
    keep = (idx >= 0) & (idx < n_rows)
    want = np.zeros((n_rows, width), np.float64)
    np.add.at(want, idx[keep], val[keep].astype(np.float64))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_array_equal(got.numpy()[~fin], want[~fin])
    assert np.abs(got.numpy()[fin] - want[fin]).max() <= tol


@pytest.mark.parametrize("kind,runs", [
    ("empty_tail", lambda idx, val: 0),    # the zero tail adds nothing
    ("one_run", lambda idx, val: -(-idx.size // 8)),  # one per 8-row group
])
def test_combined_model_drops_zero_runs_and_combines_equal_indices(
        kind, runs, monkeypatch):
    """What the kernel saves: the model's index_add_ sees no zero run and
    one sum per run of equal indices in an 8-row group."""
    n, n_rows, width = 4001, 50, 16
    idx, val = chip_smoke.k1_inputs(kind, n, n_rows, width, seed=4)
    tail = idx[int(round(0.6 * n)):] if kind == "empty_tail" else idx
    seen = []
    real = torch.Tensor.index_add_

    def spy(self, dim, index, source):
        seen.append(index.clone())
        return real(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    scatter_rows.scatter_add_rows_combined(
        torch.from_numpy(tail.copy()),
        torch.from_numpy(val[-tail.size:].copy()), n_rows)
    assert seen[-1].numel() == runs(tail, val)


def test_cuda_wrapper_on_cpu_tensor_takes_plain_version():
    """On a CPU tensor the wrapper is the plain version (index_add_)
    whatever the index structure: no launch is counted."""
    idx, val = chip_smoke.k1_inputs("ray_runs", 2000, 64, 16, seed=5)
    before = scatter_rows.LAUNCHES
    out = scatter_rows.scatter_add_rows(torch.from_numpy(idx),
                                        torch.from_numpy(val), 64)
    assert scatter_rows.LAUNCHES == before
    assert torch.equal(out, scatter_rows.scatter_add_rows_reference(
        torch.from_numpy(idx), torch.from_numpy(val), 64))
