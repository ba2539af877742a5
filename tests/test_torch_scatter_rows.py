"""Row scatter-add (K1): the port's plain version against the Pallas
kernel in interpret mode and the numpy `np.add.at` oracle, and the
wrapper's checks. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deblur_e_nerf_tpu.ops import pallas_scatter as ps
from deblur_e_nerf_tpu_torch.ops import scatter_rows


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
