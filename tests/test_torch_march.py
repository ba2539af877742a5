"""The march's stages (ops/march.py) on the CPU: the plain versions
against the JAX package's own functions stage by stage, the per-lane model
of the kernels' operation order bit for bit against the plain versions,
the wrappers on CPU tensors, and a card call that cannot launch raising.

Three geometries, cut to a few rays and a small grid: the flagship's
(AABB contraction, the superblock stage), EDS's (sphere contraction, cone
angle 0.004 marched past t_cross = step / cone = 1, the dense block
stage) and r5fix's (AABB, superblock_budget 0: the dense block stage),
each at ample budgets and at budgets that drop lanes at every coarse
stage and at the sample stage. The inputs are made with numpy from seeds;
the stratified jitter is the same array on both sides."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import contraction as jcontraction
from deblur_e_nerf_tpu.models import occupancy as jocc
from deblur_e_nerf_tpu.models import renderer as jr
from deblur_e_nerf_tpu_torch.models import renderer as tr
from deblur_e_nerf_tpu_torch.models.contraction import ContractionType
from deblur_e_nerf_tpu_torch.ops import compact as compact_ops
from deblur_e_nerf_tpu_torch.ops import march as mo

RES = 16
N_RAYS = 24

GEOMETRIES = {
    "flagship": dict(contraction="aabb", aabb=(-1.0,) * 3 + (1.0,) * 3,
                     render_step_size=0.02, near_plane=0.0,
                     far_plane=None, cone_angle=0.0,
                     max_samples_per_ray=256),
    "eds": dict(contraction="sphere", aabb=(-1.0,) * 3 + (1.0,) * 3,
                render_step_size=0.004, near_plane=0.01, far_plane=13.0,
                cone_angle=0.004, max_samples_per_ray=1024),
    "r5fix": dict(contraction="aabb", aabb=(-1.0,) * 3 + (1.0,) * 3,
                  render_step_size=0.02, near_plane=0.5, far_plane=5.0,
                  cone_angle=0.0, max_samples_per_ray=256,
                  superblock_budget=0),
}
# ample budgets, and budgets below every stage's demand (the coarse
# cutoffs and coarse_complete, the sample budget's truncation)
BUDGETS = {"ample": dict(sample_budget=1 << 15),
           "overflow": dict(sample_budget=60, block_budget=30,
                            superblock_budget=12)}


def make_rcs(geometry, budgets):
    cfg = dict(GEOMETRIES[geometry], grid_resolution=RES, stratified=True,
               **BUDGETS[budgets])
    if geometry == "r5fix":
        cfg["superblock_budget"] = 0
    contraction = cfg.pop("contraction")
    return (jr.RenderConfig(contraction_type=jcontraction.ContractionType(
                contraction), **cfg),
            tr.RenderConfig(contraction_type=ContractionType(contraction),
                            **cfg))


def inputs(seed, n=N_RAYS):
    """Rays from outside the unit box towards points inside it (unit
    directions), one of them masked off, a 40% occupied grid and the
    jitter."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, -2, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n // 3] = False
    binary = rng.uniform(size=RES ** 3) < 0.4
    jitter = rng.uniform(size=n).astype(np.float32)
    return o, d, mask, binary, jitter


def torch_inputs(seed):
    return tuple(torch.from_numpy(x) for x in inputs(seed))


def plain_stages(rc, o, d, mask, binary, jitter):
    """Every stage of the plain march on the CPU: {stage: its outputs},
    with the compactions' buffers between them."""
    R = o.shape[0]
    n_blocks = mo.n_blocks_of(rc)
    sb = tr.uses_superblocks(rc)
    out = {"masks": mo.masks_reference(binary, rc, sb)}
    dilated, pooled = out["masks"]
    out["sb_cut"] = None
    if sb:
        out["superblocks"] = mo.coarse_reference(
            mo.SUPERBLOCKS, o, d, mask, jitter, pooled, rc)
        flags, codes, t_near, t_far = out["superblocks"]
        out["sb_buf"], _, out["sb_cut"] = tr._compact(
            flags, codes, rc.superblock_capacity, R * (n_blocks // 4), True)
        out["blocks"] = mo.coarse_reference(
            mo.BLOCKS_AFTER, o, d, mask, jitter, dilated, rc, t_near, t_far,
            out["sb_buf"])
    else:
        out["blocks"] = mo.coarse_reference(
            mo.BLOCKS_DENSE, o, d, mask, jitter, dilated, rc)
        t_near, t_far = out["blocks"][2:]
    out["t_near"], out["t_far"] = t_near, t_far
    out["blk_buf"], _, out["blk_cut"] = tr._compact(
        *out["blocks"][:2], rc.block_capacity, R * n_blocks, True)
    out["samples"] = mo.samples_reference(o, d, binary, t_near, t_far,
                                          out["blk_buf"], rc)
    out["code_buf"], _ = tr._compact(
        *out["samples"][:2], rc.sample_budget,
        R * rc.max_samples_per_ray)
    out["decode"] = mo.decode_reference(out["code_buf"], t_near,
                                        out["sb_cut"], out["blk_cut"], R, rc)
    return out


CASES = [(g, b) for g in GEOMETRIES for b in BUDGETS]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package


@pytest.mark.parametrize("res", [16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_masks_match_jax_bit_for_bit(res, seed):
    """The one-cell dilation, the 4^3 pool and the two pooled dilations:
    equal to JAX `_dilate_binary` / `_maxpool_binary` cell for cell
    (booleans: no tolerance), at 16^3 and 32^3; the masks kernel's form
    (`masks_model`: one radius-2 dilation for the two) equal too."""
    rng = np.random.default_rng(seed)
    # occupied cells in one corner, so that the pooled mask is not full
    g = rng.uniform(size=(res,) * 3) < 0.3
    g[res // 8:] = g[:, res // 8:] = g[:, :, res // 8:] = False
    binary = g.reshape(-1)
    dil_j = np.asarray(jr._dilate_binary(jnp.asarray(binary), res))
    pooled_j = jr._maxpool_binary(jnp.asarray(dil_j), res, 4)
    pooled_j = jr._dilate_binary(jr._dilate_binary(pooled_j, res // 4),
                                 res // 4)
    rc = dataclasses.replace(make_rcs("flagship", "ample")[1],
                             grid_resolution=res)
    t = torch.from_numpy(binary)
    dil, pooled = mo.masks_reference(t, rc, True)
    np.testing.assert_array_equal(dil.numpy(), dil_j)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(pooled_j))
    assert 0 < int(pooled.sum()) < pooled.numel()
    dil_m, pooled_m = mo.masks_model(t, rc, True)
    assert torch.equal(dil_m, dil) and torch.equal(pooled_m, pooled)
    assert mo.masks_reference(t, rc, False)[1] is None


def _jax_bounds(rc_j, o, d, jitter):
    t_near, t_far = jr._ray_t_bounds(jnp.asarray(o), jnp.asarray(d), rc_j)
    return t_near + jnp.asarray(jitter) * rc_j.render_step_size, t_far


def _jax_coarse(rc_j, o, d, t_near, t_far, mask_j, res, k_mid, k_lo, k_hi,
                ray):
    """Flags of lanes (ray, k) as the JAX march forms them: the midpoint's
    contraction, the clamped grid lookup, the bounds."""
    tn, tf = t_near[ray], t_far[ray]
    t_mid = jr._timeline_at(k_mid, tn, rc_j)
    pos = jnp.asarray(o)[ray] + jnp.asarray(d)[ray] * t_mid[..., None]
    u = jcontraction.contract(pos, jnp.asarray(rc_j.aabb, jnp.float32),
                              rc_j.contraction_type)
    cell, _ = jocc.grid_index(jnp.clip(u, 0.0, 1.0 - 1e-7), res)
    return (mask_j[cell] & (jr._timeline_at(k_lo, tn, rc_j) < tf)
            & (jr._timeline_at(k_hi, tn, rc_j) > tn))


@pytest.mark.parametrize("geometry,budgets", CASES)
def test_stages_match_the_jax_functions(geometry, budgets):
    """Each plain stage's flags and codes against the same stage's arrays
    formed by the JAX package's `_ray_t_bounds`, `_timeline_at`,
    `contract`, `grid_index` and `query` on the same buffers: flags and
    codes equal (the same float32 operations; XLA may fuse t + k * step,
    which no lane's test here notices), the bounds within 1e-6 relative;
    the decode's t_mid within 1e-6 and dt within 2e-6 absolute (t < 8,
    a few ulp), ray_idx and coarse_complete equal."""
    rc_j, rc = make_rcs(geometry, budgets)
    o, d, mask, binary, jitter = inputs(3)
    out = plain_stages(rc, *torch_inputs(3))
    R = o.shape[0]
    n_blocks = mo.n_blocks_of(rc)
    n_sb = n_blocks // 4
    t_near, t_far = _jax_bounds(rc_j, o, d, jitter)
    np.testing.assert_allclose(out["t_near"].numpy(), np.asarray(t_near),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["t_far"].numpy(), np.asarray(t_far))
    dil_j = jr._dilate_binary(jnp.asarray(binary), RES)
    mask_j = jnp.asarray(mask)
    if "superblocks" in out:
        assert geometry == "flagship"
        pooled_j = jr._dilate_binary(jr._dilate_binary(
            jr._maxpool_binary(dil_j, RES, 4), RES // 4), RES // 4)
        ray = jnp.repeat(jnp.arange(R), n_sb)
        sb = jnp.tile(jnp.arange(n_sb, dtype=jnp.float32), R)
        flags = _jax_coarse(rc_j, o, d, t_near, t_far, pooled_j, RES // 4,
                            sb * 32 + 16.0, sb * 32, (sb + 1) * 32, ray)
        flags = flags & mask_j[ray]
        np.testing.assert_array_equal(out["superblocks"][0].numpy(),
                                      np.asarray(flags))
        np.testing.assert_array_equal(out["superblocks"][1].numpy(),
                                      np.arange(R * n_sb))
        buf = np.asarray(out["sb_buf"].numpy())
        ray = np.repeat(np.minimum(buf // n_sb, R - 1), 4)
        blk = ((buf % n_sb)[:, None] * 4 + np.arange(4)).reshape(-1)
        active = np.repeat(buf < R * n_sb, 4)
    else:
        assert geometry != "flagship"
        ray = np.repeat(np.arange(R), n_blocks)
        blk = np.tile(np.arange(n_blocks), R)
        active = mask[ray]
    b = jnp.asarray(blk, jnp.float32)
    flags = _jax_coarse(rc_j, o, d, t_near, t_far, dil_j, RES, b * 8 + 4.0,
                        b * 8, (b + 1) * 8, jnp.asarray(ray))
    np.testing.assert_array_equal(out["blocks"][0].numpy(),
                                  np.asarray(flags) & active)
    np.testing.assert_array_equal(out["blocks"][1].numpy(),
                                  ray * n_blocks + blk)
    # the sample stage on the block buffer
    buf = out["blk_buf"].numpy()
    S = rc.max_samples_per_ray
    ray = np.repeat(np.minimum(buf // n_blocks, R - 1), 8)
    step = ((buf % n_blocks)[:, None] * 8 + np.arange(8)).reshape(-1)
    k = jnp.asarray(step, jnp.float32)
    tn, tf = t_near[ray], t_far[ray]
    t_mid = 0.5 * (jr._timeline_at(k, tn, rc_j)
                   + jr._timeline_at(k + 1.0, tn, rc_j))
    pos = jnp.asarray(o)[ray] + jnp.asarray(d)[ray] * t_mid[..., None]
    u = jcontraction.contract(pos, jnp.asarray(rc_j.aabb, jnp.float32),
                              rc_j.contraction_type)
    occ = jocc.query(jocc.OccupancyGridState(occs=None,
                                             binary=jnp.asarray(binary)),
                     u, RES)
    valid = np.asarray(occ & (t_mid < tf) & (t_mid >= tn)) & (step < S) \
        & np.repeat(buf < R * n_blocks, 8)
    flags, codes, counts = out["samples"]
    np.testing.assert_array_equal(flags.numpy(), valid)
    np.testing.assert_array_equal(codes.numpy(), ray * S + step)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(ray[valid], minlength=R))
    # the decode, against the JAX march's own formulas on the code buffer
    code = out["code_buf"].numpy()
    live = code < R * S
    ray_idx = np.where(live, code // S, R)
    k = jnp.asarray(code % S, jnp.float32)
    tn = t_near[np.minimum(ray_idx, R - 1)]
    t0, t1 = jr._timeline_at(k, tn, rc_j), jr._timeline_at(k + 1.0, tn, rc_j)
    t_mid, dt, got_ray, complete = out["decode"]
    np.testing.assert_array_equal(got_ray.numpy(), ray_idx)
    np.testing.assert_allclose(t_mid.numpy(),
                               np.where(live, 0.5 * (t0 + t1), 0.0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.where(live, t1 - t0, 0.0),
                               rtol=0, atol=2e-6)
    first_bad = R
    if out["sb_cut"] is not None:
        first_bad = int(out["sb_cut"]) // n_sb
    first_bad = min(first_bad, int(out["blk_cut"]) // n_blocks)
    np.testing.assert_array_equal(complete.numpy(),
                                  np.arange(R) < first_bad)
    if budgets == "overflow":
        # every coarse stage and the sample stage dropped lanes
        assert first_bad < R and not complete.all()
        assert int(out["blocks"][0].sum()) > rc.block_capacity
        assert int(out["samples"][0].sum()) > rc.sample_budget
        if "superblocks" in out:
            assert int(out["superblocks"][0].sum()) \
                > rc.superblock_capacity
    else:
        assert complete.all() and int(counts.sum()) <= rc.sample_budget


@pytest.mark.parametrize("geometry,budgets", CASES)
def test_march_matches_jax_march(geometry, budgets):
    """The whole plain march (`march_reference`, the same code as
    `march_rays` on the CPU) against JAX `march_rays`: identical sample
    sets (ray_idx, counts, offsets, the demands, coarse_complete), t_mid
    within 1e-6 and dt within 2e-6."""
    rc_j, rc = make_rcs(geometry, budgets)
    o, d, mask, binary, _ = inputs(5)
    key = jax.random.PRNGKey(0)
    # the JAX march draws its jitter from the key: give the port the same
    jitter_j = np.array(jax.random.uniform(key, (len(o),), jnp.float32))
    a = jax.jit(jr.march_rays, static_argnums=5)(
        jnp.asarray(binary), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mask), key, rc_j)
    b = tr.march_reference(*[torch.from_numpy(x) for x in (
        binary, o, d, mask, jitter_j)], rc)
    for name in ("ray_idx", "counts", "offsets", "num_samples",
                 "num_blocks", "coarse_complete"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)),
                                      err_msg=name)
    np.testing.assert_allclose(b.t_mid.numpy(), np.asarray(a.t_mid),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.dt.numpy(), np.asarray(a.dt), rtol=0,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# the per-lane model of the kernels against the plain versions


def _assert_equal(got, want, name):
    # float values equal (-0 == +0: no zero's sign reaches an output),
    # integers and booleans equal, the same dtypes
    assert got.dtype == want.dtype, name
    assert torch.equal(got, want), name


def _assert_stage(got, want, names, stage):
    """A stage's outputs equal but the codes, which are defined where the
    flags are set (the model gives -1 elsewhere, as no kernel writes
    there): equal at the plain version's flagged lanes."""
    flags = want[0]
    for g, w, n in zip(got, want, names):
        if n == "codes":
            assert g.dtype == w.dtype, f"{stage} codes"
            assert torch.equal(g[flags], w[flags]), f"{stage} codes"
            assert bool((g[~flags] == -1).all()), f"{stage} codes"
        else:
            _assert_equal(g, w, f"{stage} {n}")


@pytest.mark.parametrize("geometry,budgets", CASES)
@pytest.mark.parametrize("seed", [3, 4])
def test_lane_model_matches_plain_bit_for_bit(geometry, budgets, seed):
    """The kernels' order (`coarse_model`, `samples_model`,
    `decode_model`: each lane's index decode by the kernels' multiply-high
    division, each ray's bounds once, timeline values carried from lane to
    lane, the per-ray counts summed from the flagged lanes, the
    host-formed float32 parameters) equals the plain version output for
    output on the same inputs, the codes where the flags are set: no
    tolerance. On the CPU the
    plain version divides by the step where the card's multiplies by its
    reciprocal; the model takes the CPU's form here
    (cuda_division=False) and the kernel's on the card."""
    _, rc = make_rcs(geometry, budgets)
    o, d, mask, binary, jitter = torch_inputs(seed)
    out = plain_stages(rc, o, d, mask, binary, jitter)
    dilated, pooled = out["masks"]
    coarse_names = ("flags", "codes", "t_near", "t_far")
    if "superblocks" in out:
        got = mo.coarse_model(mo.SUPERBLOCKS, o, d, mask, jitter, pooled, rc)
        _assert_stage(got, out["superblocks"], coarse_names, "superblocks")
        got = mo.coarse_model(mo.BLOCKS_AFTER, o, d, mask, jitter, dilated,
                              rc, out["t_near"], out["t_far"], out["sb_buf"])
    else:
        got = mo.coarse_model(mo.BLOCKS_DENSE, o, d, mask, jitter, dilated,
                              rc)
    _assert_stage(got, out["blocks"], coarse_names, "blocks")
    got = mo.samples_model(o, d, binary, out["t_near"], out["t_far"],
                           out["blk_buf"], rc)
    _assert_stage(got, out["samples"], ("flags", "codes", "counts"),
                  "samples")
    assert int(got[0].sum()) > 0
    got = mo.decode_model(out["code_buf"], out["t_near"], out["sb_cut"],
                          out["blk_cut"], o.shape[0], rc)
    for g, w, n in zip(got, out["decode"], ("t_mid", "dt", "ray_idx",
                                            "coarse_complete")):
        _assert_equal(g, w, f"decode {n}")


def test_lane_model_reaches_the_geometric_timeline():
    """On EDS's geometry the decoded samples reach past t_cross = 1 into
    the geometric part of the timeline, where the model's pow and ceil
    are exercised, and the model's card form (a product with the
    reciprocal of the step) differs from the quotient nowhere it would
    change a sample's step count here."""
    _, rc = make_rcs("eds", "ample")
    o, d, mask, binary, jitter = torch_inputs(3)
    out = plain_stages(rc, o, d, mask, binary, jitter)
    t_mid, dt, ray_idx, _ = out["decode"]
    live = ray_idx < o.shape[0]
    assert float(t_mid[live].max()) > 4.0
    assert float(dt[live].max()) > 3 * rc.render_step_size
    card = mo.decode_model(out["code_buf"], out["t_near"], None,
                           out["blk_cut"], o.shape[0], rc,
                           cuda_division=True)
    assert torch.equal(card[2], ray_idx)
    np.testing.assert_allclose(card[0].numpy(), t_mid.numpy(), rtol=1e-6)


def test_params_struct_layout_matches_the_kernels():
    """csrc/march.cu MarchParams: 15 floats and 3 int32 (72 bytes), then
    6 int64 (120 bytes) and the two divisors' multipliers and shifts (4
    uint32), 136 bytes; the numbers formed as the plain version forms
    them (float32 roundings of the render config's doubles), the
    multipliers as `divisor` forms them."""
    assert ctypes.sizeof(mo._Params) == 136
    assert mo._Params.n_rays.offset == 72
    assert mo._Params.sb_mul.offset == 120
    assert mo._Params.blk_shr.offset == 132
    _, rc = make_rcs("eds", "ample")
    p = mo._params(rc, 7)
    f32 = np.float32
    assert p.step == f32(0.004) and p.inv_step == f32(1) / f32(0.004)
    assert p.t_cross == f32(0.004 / 0.004) and p.growth == f32(1.004)
    assert p.clamp_hi == f32(1.0 - 1e-7) and p.far_plane == f32(13.0)
    assert (p.contraction, p.cone, p.stratified, p.n_rays) == (1, 1, 1, 7)
    assert (p.max_samples, p.n_blocks, p.n_superblocks, p.resolution,
            p.pooled_resolution) == (1024, 128, 32, RES, RES // 4)
    assert (p.sb_mul, p.sb_shr) == mo.divisor(32) == (1 << 31, 4)
    assert (p.blk_mul, p.blk_shr) == mo.divisor(128) == (1 << 31, 6)


def _config_divisors():
    """Every divisor the repo's training configs give the kernels (S,
    n_blocks, n_superblocks), and the tests' geometries'."""
    import glob

    import chip_smoke

    found = set()
    rcs = [chip_smoke.march_render_config(path)
           for path in sorted(glob.glob("configs/train/*.yaml"))]
    rcs += [make_rcs(g, "ample")[1] for g in GEOMETRIES]
    for rc in rcs:
        n_blocks = mo.n_blocks_of(rc)
        found |= {rc.max_samples_per_ray, n_blocks, n_blocks // mo.SB_BLOCKS}
    return sorted(found)


def test_fast_divisor_is_exact_near_every_boundary():
    """csrc/march.cu `fast_div` (modelled by `fast_div_model` on numpy
    uint64) against integer division for every divisor of the repo's
    configs (S, n_blocks, n_superblocks) and a few others: at 0, at every
    multiple of the divisor and one either side of it among the first and
    the last 2^16 multiples below 2^31, at 2^31 - 1 and 2^31 - 2, and at
    2^18 seeded random dividends; the quotient and the remainder both."""
    divisors = _config_divisors()
    assert {32, 128, 1024} <= set(divisors)
    rng = np.random.default_rng(0)
    top = (1 << 31) - 1
    for d in divisors + [1, 2, 3, 7, 1000, 12345, top]:
        mul, shr = mo.divisor(d)
        assert 0 <= mul < 1 << 32 and 0 <= shr < 32
        k = np.arange(1 << 16, dtype=np.uint64)
        last = np.uint64(top // d)
        mults = np.concatenate([k, last - np.minimum(k, last)]) * np.uint64(d)
        n = np.concatenate([mults - np.uint64(1), mults, mults + 1,
                            np.array([0, 1, top - 1, top], np.uint64),
                            rng.integers(0, top, 1 << 18, dtype=np.uint64)])
        n = n[n <= top]  # mults - 1 at 0 wraps around
        quot = mo.fast_div_model(n, np.uint64(mul), np.uint64(shr))
        np.testing.assert_array_equal(quot, n // np.uint64(d), err_msg=d)
        np.testing.assert_array_equal(n - quot * np.uint64(d),
                                      n % np.uint64(d), err_msg=d)
    assert mo.divisor(1) == mo.divisor(1 << 31) == (0, 0)


@pytest.mark.parametrize("per", [1, 8, 128, 8192, 20000])
def test_lane_decode_takes_whole_rays_a_block(per):
    """Stages 0 and 2 give each block of the kernel `run_rays(per)` whole
    rays (one to 256, 8,192 lanes' worth where a ray has fewer lanes)
    and decode a lane's (ray, index) from its offset in that run by
    `fast_div` (`lane_of`): the row-major (lane // per, lane % per) for
    every lane of rays that end in a short last run."""
    rays = mo.run_rays(per)
    assert 1 <= rays <= 256
    assert rays == 1 or rays * per <= 8192 < (rays + 1) * per or rays == 256
    R = 2 * rays + 1 if rays * per <= 1 << 16 else 3
    lane = torch.arange(R * per, dtype=torch.int64)
    mul, shr = mo.divisor(per)
    ray, index = mo.lane_of(lane, per, mul, shr)
    assert torch.equal(ray, lane // per)
    assert torch.equal(index, lane % per)


def test_carried_timeline_equals_the_timeline_at_k_plus_one():
    """The sample kernel carries a step's t1 = timeline(float32(k) + 1)
    forward as the next step's t0 = timeline(float32(k + 1)) where the two
    steps are equal, and the block stage a block's upper value (float32(b)
    + 1) x 8 as the next block's lower float32(b + 1) x 8: for every k and
    b below 2^24 they are equal (so every value is carried and is the
    timeline at k + 1 bit for bit, with and without a cone angle: the same
    function at the same float32 argument, `samples_model` against
    evaluating both directly on a strided grid of k)."""
    k = np.arange(1 << 24, dtype=np.int64)
    kf = k.astype(np.float32)
    assert np.array_equal(kf + np.float32(1), (k + 1).astype(np.float32))
    eight = np.float32(8)
    assert np.array_equal((kf + np.float32(1)) * eight,
                          (k + 1).astype(np.float32) * eight)
    for geometry in ("flagship", "eds"):
        _, rc = make_rcs(geometry, "ample")
        q = mo._model_tensors(rc, 1, "cpu")
        kt = torch.arange(0, 1 << 24, 4099, dtype=torch.int64)
        t0 = torch.full(kt.shape, 0.37, dtype=torch.float32)
        terms = mo._model_timeline_of(t0, q, False)
        assert (terms is not None) == (geometry == "eds")
        carried = mo._model_timeline_at(kt.float() + 1.0, t0, terms, q)
        direct = mo._model_timeline_at((kt + 1).float(), t0, terms, q)
        assert torch.equal(carried.view(torch.int32),
                           direct.view(torch.int32))
        if geometry == "eds":  # the geometric part is reached
            assert bool((kt.float() > terms[0]).any())


def test_chip_smoke_holds_codes_only_where_flagged():
    """chip_smoke's check follows the stages' contract: `march_compare`
    holds a stage's codes where the flags of its reference are set (other
    lanes' codes may be anything, as no reader takes them) and every other
    output in full; `march_bound`'s least work writes a flag byte a lane
    and an int64 code a flagged lane, the first design a code every lane."""
    import chip_smoke
    from deblur_e_nerf_tpu_torch import perf_microbench

    _, rc = make_rcs("flagship", "ample")
    o, d, mask, binary, jitter = torch_inputs(3)
    out = plain_stages(rc, o, d, mask, binary, jitter)
    want = out["samples"]
    flags = want[0]
    assert 0 < int(flags.sum()) < flags.numel()
    got = (flags.clone(), torch.where(flags, want[1], -7), want[2].clone())
    assert chip_smoke.march_compare(torch, "march_samples", got, want,
                                    False)[:2] == (True, True)
    bad = got[1].clone()
    bad[int(torch.nonzero(flags)[0])] += 1
    assert chip_smoke.march_compare(torch, "march_samples",
                                    (got[0], bad, got[2]), want,
                                    False)[:2] == (False, False)
    flipped = got[0].clone()
    flipped[int(torch.nonzero(~flags)[0])] = True
    assert not chip_smoke.march_compare(torch, "march_samples",
                                        (flipped, got[1], got[2]), want,
                                        False)[0]
    args = (o, d, binary, out["t_near"], out["t_far"], out["blk_buf"], rc)
    least, _, every, least_bytes = chip_smoke.march_bound(
        "march_samples", args, rc, want)
    R, n, k = o.shape[0], flags.numel(), int(flags.sum())
    read = 8 * out["blk_buf"].numel() + 32 * R + RES ** 3
    assert least_bytes == perf_microbench.bound(read + n + 8 * k + 8 * R)[0]
    assert least <= every


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_march_bound_counts_the_lanes_that_pass_their_bounds(geometry):
    """`chip_smoke.march_lanes` counts from the plain version's values
    the lanes that test their bounds and those that pass them, which the
    least work's operations count: with every grid cell occupied the
    passing lanes are the flagged ones; they are at least the flagged
    lanes and at most the tested ones; and the least work lies below the
    every-code bound of the first design's count."""
    import chip_smoke

    _, rc = make_rcs(geometry, "ample")
    o, d, mask, binary, jitter = torch_inputs(4)
    calls, _ = chip_smoke.march_stage_calls((binary, o, d, mask, jitter), rc)
    stages = 0
    for kernel, stage, args, want in calls:
        if kernel not in ("march_coarse", "march_samples"):
            continue
        stages += 1
        grid = 2 if kernel == "march_samples" else 5
        full = list(args)
        full[grid] = torch.ones_like(args[grid])
        plain = mo.samples_reference if kernel == "march_samples" \
            else mo.coarse_reference
        started, tested, passing = chip_smoke.march_lanes(kernel, args, rc)
        assert passing == int(plain(*full)[0].sum()), stage
        assert 0 < int(want[0].sum()) <= passing <= tested, stage
        assert tested <= want[0].numel() and started <= tested, stage
        least, _, every, _ = chip_smoke.march_bound(kernel, args, rc, want)
        assert least <= every, stage
    assert stages == (3 if tr.uses_superblocks(rc) else 2)


# ---------------------------------------------------------------------------
# the wrappers


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_wrappers_on_cpu_tensors_are_the_plain_version(geometry):
    """On CPU tensors every wrapper returns its plain version's outputs,
    launches nothing, and `march_rays` equals `march_reference`."""
    _, rc = make_rcs(geometry, "overflow")
    o, d, mask, binary, jitter = torch_inputs(6)
    counts = (mo.MASKS_LAUNCHES, mo.COARSE_LAUNCHES, mo.SAMPLES_LAUNCHES,
              mo.DECODE_LAUNCHES)
    sb = tr.uses_superblocks(rc)
    for got, want in zip(mo.masks(binary, rc, sb),
                         mo.masks_reference(binary, rc, sb)):
        assert (got is None and want is None) or torch.equal(got, want)
    stage = mo.SUPERBLOCKS if sb else mo.BLOCKS_DENSE
    mask_in = mo.masks_reference(binary, rc, sb)[1 if sb else 0]
    for got, want in zip(
            mo.coarse(stage, o, d, mask, jitter, mask_in, rc),
            mo.coarse_reference(stage, o, d, mask, jitter, mask_in, rc)):
        assert torch.equal(got, want)
    a = tr.march_rays(binary, o, d, mask, jitter, rc)
    b = tr.march_reference(binary, o, d, mask, jitter, rc)
    for name, x in a._asdict().items():
        y = getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    assert counts == (mo.MASKS_LAUNCHES, mo.COARSE_LAUNCHES,
                      mo.SAMPLES_LAUNCHES, mo.DECODE_LAUNCHES)


class _NotOnTheCpu(torch.Tensor):
    """A CPU tensor that reports itself on the card: the wrappers must take
    their kernel path for it and fail there."""

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return torch.Tensor._make_subclass(_NotOnTheCpu, t)


def test_a_card_call_raises_rather_than_falling_back(monkeypatch):
    """With tensors that claim the card and no way to launch (no nvcc, no
    card here), each march wrapper raises, launches nothing and never
    reaches its plain version; where a card is present, skipped
    (tests/test_torch_cuda.py runs the kernels)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "kernels")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    for name in ("masks_reference", "coarse_reference", "samples_reference",
                 "decode_reference"):
        monkeypatch.setattr(mo, name, plain)
    monkeypatch.setattr(compact_ops, "compact_reference", plain)
    _, rc = make_rcs("flagship", "ample")
    o, d, mask, binary, jitter = (_fake(t) for t in torch_inputs(0))
    counts = (mo.MASKS_LAUNCHES, mo.COARSE_LAUNCHES, mo.SAMPLES_LAUNCHES,
              mo.DECODE_LAUNCHES)
    errors = (RuntimeError, ValueError, OSError)
    with pytest.raises(errors):
        mo.masks(binary, rc, True)
    with pytest.raises(errors):
        mo.coarse(mo.SUPERBLOCKS, o, d, mask, jitter,
                  _fake(torch.ones((RES // 4) ** 3, dtype=torch.bool)), rc)
    t = _fake(torch.zeros(N_RAYS))
    blk_buf = _fake(torch.zeros(5, dtype=torch.int64))
    with pytest.raises(errors):
        mo.samples(o, d, binary, t, t, blk_buf, rc)
    with pytest.raises(errors):
        mo.decode(_fake(torch.zeros(9, dtype=torch.int64)), t, None,
                  _fake(torch.zeros((), dtype=torch.int64)), N_RAYS, rc)
    with pytest.raises(errors):
        tr.march_rays(binary, o, d, mask, jitter, rc)
    assert counts == (mo.MASKS_LAUNCHES, mo.COARSE_LAUNCHES,
                      mo.SAMPLES_LAUNCHES, mo.DECODE_LAUNCHES)
