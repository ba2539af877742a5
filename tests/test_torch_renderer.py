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
from deblur_e_nerf_tpu_torch.ops import composite as composite_ops

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


def _long_ray_samples(n_rays, lo, hi, tail, seed):
    """A ray-contiguous buffer of `n_rays` rays of lo..hi-1 samples each
    (dt ~ U[0.005, 0.02]), then `tail` empty slots."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi, n_rays)
    n = int(counts.sum())
    dt = np.concatenate([rng.uniform(0.005, 0.02, n), np.zeros(tail)])
    return tr.RaySamples(
        t_mid=torch.tensor(rng.uniform(1.0, 5.0, n + tail),
                           dtype=torch.float32),
        dt=torch.tensor(dt, dtype=torch.float32),
        ray_idx=torch.tensor(np.concatenate([
            np.repeat(np.arange(n_rays), counts), np.full(tail, n_rays)])),
        counts=torch.tensor(counts),
        offsets=torch.tensor(np.cumsum(counts) - counts),
        num_samples=torch.tensor(n), num_blocks=torch.tensor(0),
        num_superblocks=None,
        coarse_complete=torch.ones(n_rays, dtype=torch.bool))


def _composite_grads(samples, n_rays, sigma, rgb, w, rc):
    sig = torch.tensor(sigma, requires_grad=True)
    col = torch.tensor(rgb, requires_grad=True)
    c, op, dep, n = tr.composite(sig, col, samples, n_rays, rc)
    wt = torch.from_numpy(w)
    ((c * wt[:, :3]).sum() + (op * wt[:, 3]).sum()
     + (dep * wt[:, 4]).sum()).backward()
    return (c.detach(), op.detach(), dep.detach(), n), sig.grad, col.grad


def test_optical_depth_gradient_is_identical_across_thread_counts():
    """ROADMAP Queue C 8: composite's backward on a buffer of 2^17 slots
    (~82k samples of 400 rays, then empty slots), where a gather's
    accumulating index backward takes torch's parallel CPU path, gives
    bit-identical gradients at 1 and 4 intra-op threads (tolerance 0),
    and again at 4."""
    R, K1 = 400, 1 << 17
    samples = _long_ray_samples(R, 150, 260, 0, seed=11)
    n = int(samples.num_samples)
    samples = _long_ray_samples(R, 150, 260, K1 - n, seed=11)
    assert samples.dt.shape[0] == K1 and n > 1 << 16
    rng = np.random.default_rng(12)
    sigma = rng.uniform(0, 3, K1).astype(np.float32)
    rgb = rng.uniform(0, 1, (K1, 3)).astype(np.float32)
    w = rng.normal(size=(R, 5)).astype(np.float32)
    _, rc = make_rcs()
    threads = torch.get_num_threads()
    results = []
    try:
        for t in (1, 4, 4):
            torch.set_num_threads(t)
            results.append(_composite_grads(samples, R, sigma, rgb, w, rc))
    finally:
        torch.set_num_threads(threads)
    (out1, gs1, gc1) = results[0]
    assert float(gs1.abs().max()) > 0
    for out, gs, gc in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[:3], out1[:3]))
        assert torch.equal(gs, gs1) and torch.equal(gc, gc1)


def test_composite_on_long_dense_rays_matches_a_float64_composite():
    """ROADMAP Queue C 7: on rays of 500-700 samples of a dense field (the
    optical depth reaches the early stop on some, up to ~9), composite's
    value and gradient against the same composite evaluated wholly in
    float64, ray by ray (`_composite_float64`, the EDS step's oracle).
    Tolerances: colors, opacities and depths (up to 5) within 1e-5 (the
    float32 weights over ~600 samples; 9.5e-7 measured); the density
    and color gradients within 1e-5 of their largest entry (4e-7 and 7e-7
    measured)."""
    from test_torch_train_step import _composite_float64

    R = 180
    samples = _long_ray_samples(R, 500, 700, 5, seed=21)
    K1 = samples.dt.shape[0]
    rng = np.random.default_rng(22)
    sigma = rng.uniform(0, 2.5, K1).astype(np.float32)
    rgb = rng.uniform(0, 1, (K1, 3)).astype(np.float32)
    w = rng.normal(size=(R, 5)).astype(np.float32)
    _, rc = make_rcs()
    got, gs, gc = _composite_grads(samples, R, sigma, rgb, w, rc)
    sig64 = torch.tensor(sigma, dtype=torch.float64, requires_grad=True)
    col64 = torch.tensor(rgb, dtype=torch.float64, requires_grad=True)
    c, op, dep, n = _composite_float64(sig64, col64, samples, R, rc)
    wt = torch.from_numpy(w).double()
    ((c.double() * wt[:, :3]).sum() + (op.double() * wt[:, 3]).sum()
     + (dep.double() * wt[:, 4]).sum()).backward()
    assert int(got[3]) == int(n) < int(samples.num_samples)
    for a, b in zip(got[:3], (c, op, dep)):
        assert float((a.double() - b.detach().double()).abs().max()) <= 1e-5
    for a, b in ((gs, sig64.grad), (gc, col64.grad)):
        scale = float(b.abs().max())
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale


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
    _, sdt, _ = composite_ops.sigma_dt_alpha(sig_t.detach(), st.dt,
                                             st.ray_idx, R, rc_t.alpha_thre)
    safe = st.ray_idx.clamp(0, R - 1)
    port = composite_ops.optical_depth(sdt, st.offsets, st.counts, safe)
    exact = np.zeros(sdt.shape[0])
    sdt64 = sdt.double().numpy()
    for start, count in zip(st.offsets.tolist(), st.counts.tolist()):
        seg = sdt64[start:start + count]
        exact[start:start + count] = np.cumsum(seg) - seg
    valid = (st.ray_idx < R).numpy()
    ulp = np.spacing(np.abs(exact).astype(np.float32))
    assert port.dtype == torch.float32
    assert (np.abs(port.double().numpy() - exact) <= ulp)[valid].all()
    assert int(n) == int(out_j[3])
    # the JAX gradient runs through a float32 global cumsum, whose
    # transpose leaves an element an error of eps x the buffer's running
    # total (3e-4 of the largest gradient here); the port's runs in
    # float64 (ROADMAP Queue C 7)
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


# the occlusion prepass: the JAX package's own cases (its soft gaussian
# field at div 2, the same field made opaque at div 2 and 4, and a nearly
# transparent one (opacity ~0.1) whose live demand overflows a div-16
# buffer)
PREPASS_CASES = {"gaussian div 2": (1.0, 2, 1e-4),
                 "saturating div 2": (50.0, 2, 1e-4),
                 "saturating div 4": (50.0, 4, 1e-4),
                 "thin div 16 (overflow)": (1e-2, 16, 1e-6)}


def _scaled_fields(scale):
    def jf(x, d):
        rgb, sigma = jax_field(x, d)
        return rgb, sigma * scale

    def tf(x, d):
        rgb, sigma = torch_field(x, d)
        return rgb, sigma * scale
    return jf, tf


@pytest.mark.parametrize("case", sorted(PREPASS_CASES))
def test_prepass_render_matches_jax(case):
    """render_rays with the occlusion prepass against the JAX package's on
    the same rays, occupancy and jitter, and occlusion_prepass itself on
    the same marched samples: equal per-ray counts, live counts, ray
    completeness, live demand (prepass_overflow_rate) and compacted
    buffers; outputs within rtol 1e-5 and atol 1e-6 (the JAX package's
    double-f32 optical depth against the port's float64 one)."""
    scale, div, eps = PREPASS_CASES[case]
    rc_j, rc_t = make_rcs(early_stop_eps=eps, sample_budget=4096,
                          prepass_div=div)
    o, d, mask = rays(11, 16)
    binary = np.ones(RES ** 3, bool)
    key = jax.random.PRNGKey(0)
    jf, tf = _scaled_fields(scale)
    out_j = jax.jit(lambda b, o, d, m: jr.render_rays(
        jf, b, o, d, m, key, rc_j,
        density_only_fn=lambda x: jf(x, None)[1]))(
        jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask))
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (len(o),),
                                                        jnp.float32)))
    args = (torch.from_numpy(binary), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(mask))
    out_t = tr.render_rays(tf, *args, jitter, rc_t,
                           density_only_fn=lambda x: tf(x, None)[1])
    for k in ("radiance", "opacity", "depth"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("counts", "ray_complete", "num_marched_samples",
              "num_rendering_samples"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]),
                                      err_msg=k)
    assert float(out_t["prepass_overflow_rate"]) \
        == float(out_j["prepass_overflow_rate"])
    if scale > 1:  # opaque: rays terminate and the live set shrinks
        assert int(out_t["num_rendering_samples"]) \
            < int(out_t["num_marched_samples"])
    if "overflow" in case:
        assert float(out_t["prepass_overflow_rate"]) > 1.0
        complete = out_t["ray_complete"].numpy()
        assert complete[0] and not complete.all()
    # occlusion_prepass itself, on the JAX march's samples
    a = jax.jit(jr.march_rays, static_argnums=5)(
        jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask), key, rc_j)
    pj, demand_j, live_j = jax.jit(lambda s, o, d: jr.occlusion_prepass(
        lambda x: jf(x, None)[1], s, o, d, len(o), rc_j))(
        a, jnp.asarray(o), jnp.asarray(d))
    pt, demand_t, live_t = tr.occlusion_prepass(
        lambda x: tf(x, None)[1], _samples_to_torch(a), args[1], args[2],
        len(o), rc_t)
    assert int(demand_t) == int(demand_j)
    np.testing.assert_array_equal(live_t.numpy(), np.asarray(live_j))
    for name in ("ray_idx", "counts", "offsets", "t_mid", "dt"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)
    assert pt.ray_idx.shape[0] == rc_t.prepass_budget + 1
    assert int(pt.num_samples) == int(a.num_samples)


def test_prepass_overflow_on_a_fresh_field_names_the_divergence():
    """ROADMAP Queue C 9, a divergence from the JAX package (Queue C 1): on
    one marched set at div 2 with a field that culls nothing (a fresh
    field's case; the thin field of PREPASS_CASES), the live demand
    overflows the K / 2 buffer, and the JAX package's fixed buffer drops
    the tail rays (ray_complete False). The port's trainer renders such a
    step without the prepass (no density function): every ray complete,
    the outputs within rtol 1e-5 and atol 1e-6 of the JAX render without
    the prepass, and the same live demand in prepass_overflow_rate."""
    rc_j, rc_t = make_rcs(early_stop_eps=1e-6, sample_budget=4096,
                          prepass_div=2)
    o, d, mask = rays(11, 32)
    binary = np.ones(RES ** 3, bool)
    key = jax.random.PRNGKey(0)
    jf, tf = _scaled_fields(1e-2)

    def jax_render(rc, density):
        return jax.jit(lambda b, o, d, m: jr.render_rays(
            jf, b, o, d, m, key, rc, density_only_fn=density))(
            jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(mask))

    out_j = jax_render(rc_j, lambda x: jf(x, None)[1])
    full_j = jax_render(dataclasses.replace(rc_j, prepass_div=0), None)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (len(o),),
                                                        jnp.float32)))
    out_t = tr.render_rays(tf, torch.from_numpy(binary), torch.from_numpy(o),
                           torch.from_numpy(d), torch.from_numpy(mask),
                           jitter, rc_t, density_only_fn=None)
    marched = int(out_t["num_marched_samples"])
    assert rc_t.prepass_budget < marched <= rc_t.sample_budget
    assert int(out_j["num_marched_samples"]) == marched
    assert float(out_j["prepass_overflow_rate"]) > 1.0
    assert not np.asarray(out_j["ray_complete"])[mask].all()
    assert float(out_t["prepass_ran"]) == 0.0
    assert out_t["ray_complete"].numpy()[mask].all()
    assert float(out_t["prepass_overflow_rate"]) \
        == float(out_j["prepass_overflow_rate"])
    for k in ("radiance", "opacity", "depth"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(full_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_occlusion_prepass_matches_full_render():
    """The port's prepass against its own full render, the JAX package's
    exactness case (its rays, no jitter): on the soft gaussian (div 2) and
    on the opaque field (div 4, which the live set fits), the outputs
    within rtol 1e-5 and atol 1e-6; the gradient of a field scale within
    1e-5 relative on the JAX case (the gaussian at div 2, the loss the sum
    of the radiance). With the field's outputs in float64 (the same
    renderer code, whose float32 sums, in another order once the culled
    samples are gone, then run in float64), the scale's gradient within
    1e-9 relative on both fields. Without a density function the prepass
    does not run (`prepass_ran` 0): the radiance is the un-prepassed
    render's, and `prepass_overflow_rate` reports the live demand over the
    prepass buffer (ROADMAP Queue C 9)."""
    rng = np.random.default_rng(11)
    o = rng.uniform(-3, -2, (16, 3)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (16, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    args = (torch.ones(RES ** 3, dtype=torch.bool), torch.from_numpy(o),
            torch.from_numpy(d), torch.ones(16, dtype=torch.bool), None)

    def run(div, scale, dtype=torch.float32, with_density=True):
        _, rc = make_rcs(early_stop_eps=1e-4, sample_budget=4096,
                         prepass_div=div, stratified=False)
        s = torch.tensor(scale, dtype=dtype, requires_grad=True)

        def field(x, dd):
            rgb, sigma = torch_field(x, dd)
            return rgb.to(dtype) * s, sigma.to(dtype) * s

        out = tr.render_rays(
            field, *args, rc,
            density_only_fn=(lambda x: field(x, None)[1]) if with_density
            else None)
        out["radiance"].sum().backward()
        return out, float(s.grad)

    for scale, div in ((1.0, 2), (50.0, 4)):
        out_f, g_f = run(0, scale)
        out_p, g_p = run(div, scale)
        for k in ("radiance", "opacity", "depth"):
            np.testing.assert_allclose(out_p[k].detach().numpy(),
                                       out_f[k].detach().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert int(out_p["num_rendering_samples"]) \
            == int(out_f["num_rendering_samples"])
        assert float(out_p["prepass_overflow_rate"]) < 1.0
        if scale == 1.0:
            assert g_p == pytest.approx(g_f, rel=1e-5)
        _, g64_f = run(0, scale, torch.float64)
        _, g64_p = run(div, scale, torch.float64)
        assert g64_p == pytest.approx(g64_f, rel=1e-9)
    assert int(out_p["num_rendering_samples"]) \
        < int(out_p["num_marched_samples"])  # the opaque field culls
    out_n, _ = run(2, 1.0, with_density=False)
    np.testing.assert_array_equal(out_n["radiance"].detach().numpy(),
                                  run(0, 1.0)[0]["radiance"].detach().numpy())
    assert float(out_n["prepass_ran"]) == 0.0
    assert float(out_p["prepass_ran"]) == 1.0
    assert float(out_n["prepass_overflow_rate"]) == int(
        out_n["num_rendering_samples"]) / (4096 // 2)


def _small_ngp_field():
    from deblur_e_nerf_tpu_torch.models import fields

    gen = torch.Generator().manual_seed(4)
    field = fields.NGPField(
        aabb=AABB, contraction_type=ContractionType.AABB, radiance_dim=3,
        pos_otype="HybridHashGrid", n_levels=6, base_resolution=4,
        per_level_scale=2.0, log2_hashmap_size=10, base_n_neurons=16,
        head_n_neurons=16, generator=gen)
    with torch.no_grad():
        field.table.uniform_(-1.0, 1.0, generator=gen)
    return field


@pytest.mark.parametrize("prepass_div", [0, 2])
def test_chunked_training_render_matches_whole_buffer(prepass_div):
    """rc.field_chunk runs the field chunk by chunk, keeping each chunk's
    encode output and recomputing its MLPs and SH encoding in the backward
    (torch.utils.checkpoint): the outputs within 1e-6 and every field
    gradient within 2e-4 of its largest entry of the whole-buffer render's,
    with and without the prepass, and the encode runs once per chunk (not
    again in the backward)."""
    from deblur_e_nerf_tpu_torch.models import hash_encoding

    field = _small_ngp_field()
    o, d, mask = rays(12, 24)
    binary = torch.from_numpy(sparse_binary(13))
    jitter = torch.rand(24, generator=torch.Generator().manual_seed(1))
    w = torch.randn((24, 5), generator=torch.Generator().manual_seed(2))
    encodes = []
    real_encode = hash_encoding._encode_impl

    def counting_encode(*a, **k):
        encodes.append(a[1].shape[0])
        return real_encode(*a, **k)

    results = {}
    for chunk in (0, 1000):
        _, rc = make_rcs(field_chunk=chunk, prepass_div=prepass_div)
        field.zero_grad(set_to_none=True)
        encodes.clear()
        hash_encoding._encode_impl = counting_encode
        try:
            out = tr.render_rays(
                tr.SplitField(field.encode, field.decode), binary,
                torch.from_numpy(o), torch.from_numpy(d),
                torch.from_numpy(mask), jitter, rc,
                density_only_fn=field.density)
            n_forward = len(encodes)
            ((out["radiance"] * w[:, :3]).sum()
             + (out["opacity"] * w[:, 3]).sum()
             + (out["depth"] * w[:, 4]).sum()).backward()
        finally:
            hash_encoding._encode_impl = real_encode
        assert len(encodes) == n_forward  # nothing re-encoded
        results[chunk] = (out, {n: p.grad.clone()
                                for n, p in field.named_parameters()},
                          encodes[:])
    (out_c, grads_c, enc_c), (out_w, grads_w, enc_w) = (results[1000],
                                                        results[0])
    n_slots = rc.sample_budget // (prepass_div or 1) + 1
    assert max(enc_c) == 1000 and sum(enc_c) == sum(enc_w)
    assert n_slots in enc_w
    for k in ("radiance", "opacity", "depth"):
        np.testing.assert_allclose(out_c[k].detach().numpy(),
                                   out_w[k].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    for name, g in grads_w.items():
        scale = float(g.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(grads_c[name].numpy(), g.numpy(), rtol=0,
                                   atol=2e-4 * scale, err_msg=name)
