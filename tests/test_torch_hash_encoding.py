"""Hash-grid encoding: the port against the JAX package on the same table
and positions — layout, hash arithmetic, the forward features and the
table gradient for dense, hash, cellhash and HybridHashGrid layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import hash_encoding as jhe
from deblur_e_nerf_tpu_torch.models import hash_encoding as the
from deblur_e_nerf_tpu_torch.ops import hash_encode

# (otype, n_levels, base_resolution, per_level_scale, log2_hashmap_size)
LAYOUTS = {
    "DenseGrid": ("DenseGrid", 3, 4, 2.0, 12),
    "HashGrid": ("HashGrid", 4, 8, 2.0, 12),
    "CellHashGrid": ("CellHashGrid", 4, 8, 2.0, 12),
    # dense 4, 8; hash 16; cellhash 32, 64, 128
    "HybridHashGrid": ("HybridHashGrid", 6, 4, 2.0, 12),
}


def _setup(name, n=3000, seed=0):
    levels, total = jhe.grid_layout(*LAYOUTS[name])
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=0.1, size=(total, 2)).astype(np.float32)
    # include points outside the unit cube (clamped) and on its faces
    u = rng.uniform(-0.05, 1.05, size=(n, 3)).astype(np.float32)
    u[:10] = np.round(u[:10])
    cot = rng.normal(size=(n, len(levels) * 2)).astype(np.float32)
    return levels, table, u, cot


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_grid_layout_matches(name):
    assert the.grid_layout(*LAYOUTS[name]) == jhe.grid_layout(
        *LAYOUTS[name])


def test_flagship_layout_matches():
    args = ("HybridHashGrid", 16, 16, 1.4472692012786865, 19)
    levels, total = the.grid_layout(*args)
    assert (levels, total) == jhe.grid_layout(*args)
    assert total == 6301184
    assert [m for *_, m in levels] == ["dense"] * 5 + ["hash"] * 2 \
        + ["cellhash"] * 9


def test_hash_arithmetic_matches_uint32_wrapping():
    rng = np.random.default_rng(1)
    cell = rng.integers(0, 4096, size=(5000, 3)).astype(np.int32)
    want = np.asarray(jhe._corner_indices(jnp.asarray(cell), 4095, 1 << 19,
                                          "hash"))
    c = torch.from_numpy(cell).long()
    got = (hash_encode._hash(c[:, 0], c[:, 1], c[:, 2])
           % (1 << 19)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_encode_and_grad(levels, table, u, cot, compute_dtype):
    def loss(t):
        out = jhe.encode(t, jnp.asarray(u), levels,
                         differentiable_positions=False,
                         compute_dtype=compute_dtype)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(table))
    return np.asarray(out), np.asarray(grad)


def _torch_encode_and_grad(levels, table, u, cot, compute_dtype):
    t = torch.from_numpy(table).requires_grad_(True)
    out = the.encode(t, torch.from_numpy(u), levels,
                     compute_dtype=compute_dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("name,bf16", [
    ("DenseGrid", False), ("HashGrid", False), ("CellHashGrid", False),
    ("HybridHashGrid", False), ("HybridHashGrid", True),
    ("CellHashGrid", True),
])
def test_forward_and_table_grad_match_jax(name, bf16):
    levels, table, u, cot = _setup(name)
    out_j, grad_j = _jax_encode_and_grad(
        levels, table, u, cot, jnp.bfloat16 if bf16 else None)
    out_t, grad_t = _torch_encode_and_grad(
        levels, table, u, cot, torch.bfloat16 if bf16 else None)
    # features: the same 8 products summed in another order (f32); bf16
    # rounds the same table values in both packages
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    # table grad: the JAX sort path sums each row near-exactly, the port's
    # index_add_ in f32 in index order: error <= (k-1) eps sum|x| per row
    scale = float(np.abs(grad_j).max())
    np.testing.assert_allclose(grad_t, grad_j, rtol=1e-4,
                               atol=1e-5 * scale)
    assert np.count_nonzero(grad_t) > 0


def test_position_cotangent_is_zero():
    levels, table, u, cot = _setup("HybridHashGrid", n=64)
    uu = torch.from_numpy(u).requires_grad_(True)
    out = the.encode(torch.from_numpy(table), uu, levels)
    (out * torch.from_numpy(cot)).sum().backward()
    assert torch.count_nonzero(uu.grad) == 0
