"""Marching, compositing and the occupancy update: the port against the
JAX package on the same rays, occupancy masks, densities and (injected)
random draws. The stratified jitter and the occupancy cell samples are the
JAX package's own draws from its PRNG key, handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import occupancy as jocc
from deblur_e_nerf_tpu.models import renderer as jr
from deblur_e_nerf_tpu.models.contraction import ContractionType as JCT
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.models import renderer as tr
from deblur_e_nerf_tpu_torch.models.contraction import ContractionType

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
RES = 16


def make_rcs(**kwargs):
    cfg = dict(aabb=AABB, grid_resolution=RES, near_plane=0.0,
               far_plane=None, render_step_size=0.02, cone_angle=0.0,
               early_stop_eps=1e-4, alpha_thre=0.0, stratified=True,
               max_samples_per_ray=256, sample_budget=8192)
    cfg.update(kwargs)
    return (jr.RenderConfig(contraction_type=JCT.AABB, **cfg),
            tr.RenderConfig(contraction_type=ContractionType.AABB, **cfg))


def rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, -2, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n // 3] = False   # one inactive ray
    return o, d, mask


def sparse_binary(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=RES ** 3) < 0.4


def gaussian(x):
    sigma = 20.0 * np.exp(-10.0 * np.sum(x ** 2, axis=-1, keepdims=True))
    rgb = np.stack([0.5 + 0.5 * np.tanh(x[..., 0]),
                    0.5 + 0.5 * np.tanh(x[..., 1]),
                    np.full_like(x[..., 0], 0.25)], axis=-1)
    return rgb, sigma


def jax_field(x, d):
    sigma = 20.0 * jnp.exp(-10.0 * jnp.sum(x ** 2, axis=-1, keepdims=True))
    rgb = jnp.stack([0.5 + 0.5 * jnp.tanh(x[..., 0]),
                     0.5 + 0.5 * jnp.tanh(x[..., 1]),
                     jnp.full_like(x[..., 0], 0.25)], axis=-1)
    return rgb, sigma


def torch_field(x, d):
    sigma = 20.0 * torch.exp(-10.0 * torch.sum(x ** 2, dim=-1,
                                               keepdim=True))
    rgb = torch.stack([0.5 + 0.5 * torch.tanh(x[..., 0]),
                       0.5 + 0.5 * torch.tanh(x[..., 1]),
                       torch.full_like(x[..., 0], 0.25)], dim=-1)
    return rgb, sigma


def _march_both(rc_j, rc_t, o, d, mask, binary, key):
    a = jax.jit(jr.march_rays, static_argnums=5)(
        jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask), key, rc_j)
    jitter = np.asarray(jax.random.uniform(key, (len(o),), jnp.float32))
    b = tr.march_rays(torch.from_numpy(binary), torch.from_numpy(o),
                      torch.from_numpy(d), torch.from_numpy(mask),
                      torch.tensor(jitter), rc_t)
    return a, b


@pytest.mark.parametrize("budgets", [
    {},                                            # ample
    {"sample_budget": 1024},                       # sample truncation
    {"block_budget": 96},                          # block truncation
    {"block_budget": 1024, "superblock_budget": 24},
    {"superblock_budget": 0},                      # dense block pass
])
def test_march_sample_sets_match_jax(budgets):
    rc_j, rc_t = make_rcs(**budgets)
    o, d, mask = rays(0, 24)
    a, b = _march_both(rc_j, rc_t, o, d, mask, sparse_binary(1),
                       jax.random.PRNGKey(2))
    # the same float32 timeline and tests: identical sample sets
    for name in ("ray_idx", "counts", "offsets", "num_samples",
                 "num_blocks", "coarse_complete"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)),
                                      err_msg=name)
    assert (a.num_superblocks is None) == (b.num_superblocks is None)
    if a.num_superblocks is not None:
        assert int(b.num_superblocks) == int(a.num_superblocks)
    # t_k = t_near + k * step may be one fused multiply-add in XLA: t
    # agrees to an ulp, and dt = t_{k+1} - t_k to a few ulp of t (t < 8)
    np.testing.assert_allclose(b.t_mid.numpy(), np.asarray(a.t_mid),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.dt.numpy(), np.asarray(a.dt), rtol=0,
                               atol=2e-6)
    assert int(a.num_samples) > 0


def _samples_to_torch(s):
    return tr.RaySamples(
        t_mid=torch.tensor(np.asarray(s.t_mid)),
        dt=torch.tensor(np.asarray(s.dt)),
        ray_idx=torch.tensor(np.asarray(s.ray_idx)).long(),
        counts=torch.tensor(np.asarray(s.counts)).long(),
        offsets=torch.tensor(np.asarray(s.offsets)).long(),
        num_samples=torch.tensor(int(s.num_samples)),
        num_blocks=torch.tensor(int(s.num_blocks)),
        num_superblocks=None,
        coarse_complete=torch.tensor(np.asarray(s.coarse_complete)))


@pytest.mark.parametrize("alpha_thre", [0.0, 0.01])
def test_composite_and_its_gradient_match_jax(alpha_thre):
    rc_j, rc_t = make_rcs(alpha_thre=alpha_thre)
    o, d, mask = rays(3, 16)
    R = len(o)
    s = jax.jit(jr.march_rays, static_argnums=5)(
        jnp.ones(RES ** 3, bool), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask), jax.random.PRNGKey(4), rc_j)
    rng = np.random.default_rng(5)
    K1 = s.t_mid.shape[0]
    sigma = rng.uniform(0, 40, K1).astype(np.float32)
    sigma[7] = np.inf        # an overflowed density is clamped at 25
    rgb = rng.uniform(0, 1, (K1, 3)).astype(np.float32)
    bkgd = np.array([1.0, 0.5, 0.25], np.float32)
    w = rng.normal(size=(R, 5)).astype(np.float32)

    def loss_j(sig, col):
        c, op, dep, n = jr.composite(sig, col, s, R, rc_j, bkgd)
        return (jnp.sum(c * w[:, :3]) + jnp.sum(op * w[:, 3])
                + jnp.sum(dep * w[:, 4])), (c, op, dep, n)

    (_, out_j), (gs_j, gc_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(jnp.asarray(sigma),
                                               jnp.asarray(rgb))
    sig_t = torch.tensor(sigma, requires_grad=True)
    col_t = torch.tensor(rgb, requires_grad=True)
    c, op, dep, n = tr.composite(sig_t, col_t, _samples_to_torch(s), R,
                                 rc_t, torch.from_numpy(bkgd))
    wt = torch.from_numpy(w)
    ((c * wt[:, :3]).sum() + (op * wt[:, 3]).sum()
     + (dep * wt[:, 4]).sum()).backward()
    # optical depth: a float64 cumsum here, the JAX package's double-f32
    # blocked sums there. The JAX value is off by up to ~3e-6 relative
    # (~27 ulp at an optical depth of 44, measured on these inputs), which
    # reaches the transmittance of live samples (optical depth < 9.2) as
    # up to ~3e-5 relative: outputs to 1e-4 relative
    for got, want in zip((c, op, dep), out_j[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    # the port's optical depth itself is the exact sum rounded to f32
    st = _samples_to_torch(s)
    _, sdt, _ = tr._sigma_dt_alpha(sig_t.detach(), st, R, rc_t)
    safe = st.ray_idx.clamp(0, R - 1)
    exact = tr._excl_optical_depth(sdt.double(), st.offsets, safe)
    port = tr._excl_optical_depth(sdt.double(), st.offsets, safe).float()
    ulp = np.spacing(np.abs(exact.numpy()).astype(np.float32))
    assert (np.abs(port.double().numpy() - exact.numpy()) <= ulp).all()
    assert int(n) == int(out_j[3])
    # the gradient runs through the float32 global cumsum in both
    # packages (by design); its transpose sums the cotangents of the whole
    # buffer in another order, so an element's error scales with eps x
    # the buffer's running total: 3e-4 of the largest gradient here
    for got, want in ((sig_t.grad, gs_j), (col_t.grad, gc_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=3e-4 * np.abs(want).max())


def test_render_rays_matches_jax_and_names_the_overflow_divergence():
    # superblock_budget set: the port's superblock_overflow_rate divides
    # by it, the JAX package divides by block_budget // 2 regardless
    rc_j, rc_t = make_rcs(block_budget=1024, superblock_budget=24)
    o, d, mask = rays(6, 24)
    binary = sparse_binary(7)
    key = jax.random.PRNGKey(8)
    out_j = jax.jit(jr.render_rays, static_argnums=(0, 6))(
        jax_field, jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask), key, rc_j)
    jitter = np.asarray(jax.random.uniform(key, (len(o),), jnp.float32))
    out_t = tr.render_rays(torch_field, torch.from_numpy(binary),
                           torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(mask), torch.tensor(jitter),
                           rc_t)
    for k in ("radiance", "opacity", "depth"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("ray_complete", "counts", "num_marched_samples",
              "num_rendering_samples"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]),
                                      err_msg=k)
    assert not out_t["ray_complete"].all()  # superblock truncation
    assert float(out_t["block_overflow_rate"]) == pytest.approx(
        float(out_j["block_overflow_rate"]))
    n_sb = float(out_j["superblock_overflow_rate"]) * (1024 // 2)
    assert float(out_t["superblock_overflow_rate"]) == pytest.approx(
        n_sb / 24)


def _jax_update_draws(key, num_cells, warmup):
    """The draws jax occupancy.update makes from `key`, for the port."""
    k_sample, k_jitter, _ = jax.random.split(key, 3)
    n = num_cells // 4
    if warmup:
        return {"jitter": torch.tensor(np.asarray(jax.random.uniform(
            k_jitter, (num_cells, 3), jnp.float32)))}
    k_uniform, k_occ = jax.random.split(k_sample)
    k_fallback, k_occ2 = jax.random.split(k_occ)
    return {
        "uniform_cells": torch.tensor(np.asarray(jax.random.randint(
            k_uniform, (n,), 0, num_cells, dtype=jnp.int32))),
        "occupied": {
            "fallback_cells": torch.tensor(np.asarray(jax.random.randint(
                k_fallback, (n,), 0, num_cells, dtype=jnp.int32))),
            "u": torch.tensor(np.asarray(jax.random.uniform(
                k_occ2, (n,), jnp.float32))),
        },
        "jitter": torch.tensor(np.asarray(jax.random.uniform(
            k_jitter, (2 * n, 3), jnp.float32))),
    }


def test_occupancy_warmup_and_sampled_updates_match_jax():
    kw = dict(resolution=RES, aabb=AABB, occ_thre=0.01, ema_decay=0.95)
    num_cells = RES ** 3
    j_eval = jocc.make_occ_eval_fn(lambda x: jax_field(x, None)[1], 0.02,
                                   0.0, None, None)
    t_eval = tocc.make_occ_eval_fn(lambda x: torch_field(x, None)[1], 0.02,
                                   0.0)
    j_update = jax.jit(lambda state, key, step: jocc.update(
        state, key, j_eval, jnp.zeros((1, 3)), step,
        contraction_type=JCT.AABB, warmup_steps=2, **kw))
    js = jocc.init_state(RES)
    ts = tocc.init_state(RES, "cpu")
    for i, (step, warmup) in enumerate([(0, True), (1, True), (5, False),
                                        (6, False)]):
        key = jax.random.PRNGKey(10 + i)
        js = j_update(js, key, jnp.asarray(step))
        ts = tocc.update(ts, t_eval, warmup,
                         _jax_update_draws(key, num_cells, warmup),
                         contraction_type=ContractionType.AABB, **kw)
        occs_j = np.asarray(js.occs)
        np.testing.assert_allclose(ts.occs.numpy(), occs_j, rtol=1e-6,
                                   atol=1e-9)
        # the threshold min(mean, occ_thre) from sums in another order:
        # cells within 1e-6 of it may flip
        thre = min(occs_j.mean(), 0.01)
        differ = ts.binary.numpy() != np.asarray(js.binary)
        assert not differ[np.abs(occs_j - thre) > 1e-6 * thre].any()
        assert 0 < ts.binary.float().mean() < 1
        # carry the JAX state forward so the draws stay comparable
        ts = tocc.OccupancyGridState(torch.tensor(occs_j),
                                     torch.tensor(np.asarray(js.binary)))


def test_sample_occupied_cells_matches_jax():
    binary = sparse_binary(9)
    state = jocc.OccupancyGridState(occs=None, binary=jnp.asarray(binary))
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jocc.sample_occupied_cells, static_argnums=2)(
        key, state, 5000))
    k_fallback, k_occ = jax.random.split(key)
    draws = {"fallback_cells": torch.tensor(np.asarray(jax.random.randint(
                 k_fallback, (5000,), 0, RES ** 3, dtype=jnp.int32))),
             "u": torch.tensor(np.asarray(jax.random.uniform(
                 k_occ, (5000,), jnp.float32)))}
    got = tocc.sample_occupied_cells(torch.from_numpy(binary), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert binary[got.numpy()].all()
