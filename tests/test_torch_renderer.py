"""Marching, compositing and the occupancy update: the port against the
JAX package on the same rays, occupancy masks, densities and (injected)
random draws. The stratified jitter and the occupancy cell samples are the
JAX package's own draws from its PRNG key, handed to the port."""

import dataclasses

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


def make_rcs(contraction="aabb", **kwargs):
    cfg = dict(aabb=AABB, grid_resolution=RES, near_plane=0.0,
               far_plane=None, render_step_size=0.02, cone_angle=0.0,
               early_stop_eps=1e-4, alpha_thre=0.0, stratified=True,
               max_samples_per_ray=256, sample_budget=8192)
    cfg.update(kwargs)
    return (jr.RenderConfig(contraction_type=JCT(contraction), **cfg),
            tr.RenderConfig(contraction_type=ContractionType(contraction),
                            **cfg))


# the real-data (EDS) configs' march: sphere contraction, cone angle 0.004,
# near 0.01, far 13; uniform steps to t = 1, geometric beyond
EDS_MARCH = dict(contraction="sphere", cone_angle=0.004,
                 render_step_size=0.004, near_plane=0.01, far_plane=13.0,
                 max_samples_per_ray=1024, sample_budget=1 << 15)


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
    EDS_MARCH,                                     # no superblock pass
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


def test_march_cone_angle_case_reaches_the_geometric_timeline():
    """The EDS case above marches past t_cross = step / cone = 1 into the
    geometric part of the timeline, out to far distances."""
    _, rc_t = make_rcs(**EDS_MARCH)
    o, d, mask = rays(0, 24)
    b = tr.march_rays(torch.from_numpy(sparse_binary(1)),
                      torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(mask), torch.rand(24), rc_t)
    live = b.ray_idx < 24
    assert b.num_superblocks is None
    assert float(b.t_mid[live].max()) > 6.0
    assert float(b.dt[live].max()) > 5 * rc_t.render_step_size


def test_long_cone_angle_rays_composite_against_float64():
    """Names a divergence (ROADMAP Queue C 1): on the EDS configs' long
    cone-angle rays (sphere contraction, far 13, ~600 samples a ray) with
    dense media, the JAX composite's float32 weight sums drift from a
    float64 evaluation of the same samples by far more than the port's,
    which takes each ray's optical depth from a float64 cumsum. Measured
    here: JAX 5.1e-5, port 1.3e-6 in opacity."""
    rc_j, rc_t = make_rcs(**EDS_MARCH)
    o, d, mask = rays(5, 64)
    binary = np.ones(RES ** 3, bool)
    a, b = _march_both(rc_j, rc_t, o, d, mask, binary, jax.random.PRNGKey(6))
    R = len(o)
    ray_idx = np.asarray(a.ray_idx)
    assert np.bincount(ray_idx[ray_idx < R]).max() > 500
    rng = np.random.default_rng(7)
    sigma = rng.uniform(0, 3, ray_idx.shape).astype(np.float32)
    rgb = rng.uniform(0, 1, (len(sigma), 1)).astype(np.float32)
    rc_j = dataclasses.replace(rc_j, early_stop_eps=0.0)
    rc_t = dataclasses.replace(rc_t, early_stop_eps=0.0)
    opac_j = np.asarray(jax.jit(
        lambda s, c: jr.composite(s, c, a, R, rc_j))(sigma, rgb)[1])
    opac_t = tr.composite(torch.from_numpy(sigma), torch.from_numpy(rgb),
                          _samples_to_torch(a), R, rc_t)[1].numpy()
    sdt = np.minimum(sigma.astype(np.float64) * np.asarray(a.dt)
                     * (ray_idx < R), 25.0)
    exact = np.zeros(R)
    for r in range(R):
        s = sdt[ray_idx == r]
        exact[r] = np.sum(np.exp(-(np.cumsum(s) - s)) * -np.expm1(-s))
    err_j = np.abs(opac_j - exact).max()
    err_t = np.abs(opac_t - exact).max()
    assert err_t < 1e-5 < err_j, (err_t, err_j)


@pytest.mark.parametrize("t_start", [0.01, 0.6, 2.5])
def test_cone_angle_timeline_matches_jax(t_start):
    """The closed-form cone-angle timeline against the JAX package's, from
    starts before and after t_cross = 1 (rtol 1e-6): uniform steps, then
    t_m (1 + cone)^(k - m)."""
    rc_j, rc_t = make_rcs(**EDS_MARCH)
    k = np.arange(1025, dtype=np.float32)
    t0 = np.full((3, 1), t_start, np.float32) + np.float32([[0], [1e-3],
                                                            [0.37]])
    want = np.asarray(jax.jit(jr._timeline_at, static_argnums=2)(
        jnp.asarray(k), jnp.asarray(t0), rc_j))
    got = tr._timeline_at(torch.from_numpy(k), torch.from_numpy(t0),
                          rc_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(np.diff(got, axis=-1) >= rc_t.render_step_size * 0.999)
    assert got[0, -1] > 10.0


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


CAMERAS = np.random.default_rng(7).uniform(-2.5, 2.5, (9, 3)).astype(
    np.float32)


@pytest.mark.parametrize("march", ["aabb", "sphere_cone"])
def test_occupancy_warmup_and_sampled_updates_match_jax(march):
    """Warmup and sampled updates against the JAX package's, with its cell
    draws handed over: on the aabb grid, and under the EDS configs' sphere
    contraction with the cone-angle step, which draws one camera per
    evaluated cell (JAX's `cam_ids`, handed over too)."""
    cone = march == "sphere_cone"
    contraction = "sphere" if cone else "aabb"
    kw = dict(resolution=RES, aabb=AABB, occ_thre=0.01, ema_decay=0.95)
    num_cells = RES ** 3
    near, far = (0.01, 3.0) if cone else (None, None)
    j_eval = jocc.make_occ_eval_fn(lambda x: jax_field(x, None)[1], 0.02,
                                   0.2 if cone else 0.0, near, far)
    t_eval = tocc.make_occ_eval_fn(lambda x: torch_field(x, None)[1], 0.02,
                                   0.2 if cone else 0.0, near, far)
    j_update = jax.jit(lambda state, key, step: jocc.update(
        state, key, j_eval, jnp.asarray(CAMERAS), step,
        contraction_type=JCT(contraction), warmup_steps=2, **kw))
    js = jocc.init_state(RES)
    ts = tocc.init_state(RES, "cpu")
    for i, (step, warmup) in enumerate([(0, True), (1, True), (5, False),
                                        (6, False)]):
        key = jax.random.PRNGKey(10 + i)
        js = j_update(js, key, jnp.asarray(step))
        draws = _jax_update_draws(key, num_cells, warmup)
        if cone:
            _, _, k_eval = jax.random.split(key, 3)
            draws["cam_ids"] = torch.tensor(np.asarray(jax.random.randint(
                k_eval, (draws["jitter"].shape[0],), 0, len(CAMERAS))))
        ts = tocc.update(ts, t_eval, warmup, draws,
                         contraction_type=ContractionType(contraction),
                         camera_positions=torch.from_numpy(CAMERAS), **kw)
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


def test_cone_angle_occupancy_eval_matches_jax():
    """make_occ_eval_fn under a cone angle against the JAX package's, with
    its `cam_ids` handed over: step max(|o - x| cone, step), zeroed
    outside (near, far); rtol 1e-6."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-4, 4, (2000, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    # a polynomial density, so that only the step is under test
    j_eval = jocc.make_occ_eval_fn(
        lambda p: 0.5 + jnp.sum(p * p, axis=-1, keepdims=True), 0.02, 0.05,
        0.5, 5.0)
    want = np.asarray(jax.jit(j_eval)(key, jnp.asarray(x),
                                      jnp.asarray(CAMERAS)))
    cam_ids = np.array(jax.random.randint(key, (len(x),), 0, len(CAMERAS)))
    t_eval = tocc.make_occ_eval_fn(
        lambda p: 0.5 + torch.sum(p * p, dim=-1, keepdim=True), 0.02, 0.05,
        0.5, 5.0)
    got = t_eval(torch.from_numpy(x),
                 torch.from_numpy(CAMERAS)[torch.from_numpy(cam_ids)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    dist = np.linalg.norm(CAMERAS[cam_ids] - x, axis=-1)
    assert np.all(got.numpy()[(dist <= 0.5) | (dist >= 5.0)] == 0)
    inside = (dist > 0.5) & (dist < 5.0)
    assert inside.any() and np.any(dist[inside] * 0.05 > 0.02)


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
