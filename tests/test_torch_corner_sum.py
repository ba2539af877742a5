"""The trilinear corner sum (ops/corner_sum.py) on the CPU, where it runs
its plain version: against the JAX encode's expression
(`jnp.sum(rows.astype(float32) * w[..., None], axis=-2)`) on the same
bf16 or float32 rows, the plain model of the kernel's summation order
against float64, and its argument errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu_torch.ops import corner_sum

EPS = np.finfo(np.float32).eps


def _inputs(n=5000, f=2, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, 8, f)).astype(np.float32)
    w = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    return rows, w


def _order_bound(rows, w):
    """Any order of the 8 float32 terms is within 7 eps sum|x| of the
    exact sum; two orders differ by at most twice that."""
    return 2 * 7 * EPS * np.sum(np.abs(rows.astype(np.float64))
                                * w[..., None], axis=1)


@pytest.mark.parametrize("rows_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("f", [2, 8])
def test_plain_corner_sum_matches_jax_expression(f, rows_dtype):
    rows, w = _inputs(f=f)
    jrows = jnp.asarray(rows).astype(rows_dtype)
    want = np.asarray(jnp.sum(jrows.astype(jnp.float32)
                              * jnp.asarray(w)[..., None], axis=-2))
    trows = torch.from_numpy(rows).to(getattr(torch, rows_dtype))
    got = corner_sum.corner_sum(trows, torch.from_numpy(w))
    assert got.dtype == torch.float32
    assert got.shape == (rows.shape[0], f)
    exact_rows = trows.float().numpy()
    bound = _order_bound(exact_rows, w)
    assert np.all(np.abs(got.numpy() - want) <= bound)


@pytest.mark.parametrize("f", [2, 8])
def test_sequential_model_is_within_the_order_bound(f):
    """The plain model of the kernel's order (products rounded, corners
    summed in order) against float64 and the plain version."""
    rows, w = _inputs(f=f, seed=1)
    t_rows, t_w = torch.from_numpy(rows), torch.from_numpy(w)
    model = corner_sum.corner_sum_sequential(t_rows, t_w)
    plain = corner_sum.corner_sum_reference(t_rows, t_w)
    exact = corner_sum.corner_sum_reference(t_rows.double(), t_w.double())
    bound = torch.from_numpy(_order_bound(rows, w))
    assert model.dtype == torch.float32
    assert bool(((model.double() - exact).abs() <= bound / 2).all())
    assert bool(((model - plain).double().abs() <= bound).all())


def test_corner_sum_argument_errors():
    rows, w = torch.zeros((4, 8, 2)), torch.zeros((4, 8))
    with pytest.raises(ValueError):  # 8 corners along dim 1
        corner_sum.corner_sum(rows.transpose(0, 1), w.T)
    with pytest.raises(ValueError):  # w must match rows' first two axes
        corner_sum.corner_sum(rows, w[:3])
    with pytest.raises(ValueError):
        corner_sum.corner_sum(rows[..., 0], w)
    launches = corner_sum.LAUNCHES
    out = corner_sum.corner_sum(rows, w)
    assert out.shape == (4, 2)
    assert corner_sum.LAUNCHES == launches  # no kernel on the CPU
