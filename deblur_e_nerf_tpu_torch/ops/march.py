"""The occupancy-gated march's per-lane stages (counterpart of the rest of
the JAX package's `march_rays`, deblur_e_nerf_tpu/models/renderer.py:226:
`_ray_t_bounds` :117, `_timeline_at` :136, `_dilate_binary` :164,
`_maxpool_binary` :189, the stages' flags and codes, the per-ray demand
counts and the decode). models/renderer.py `march_rays` runs them with
the stream compactions of ops/compact.py between them:

  - `masks(binary, rc, superblocks)` -> (the one-cell dilation of the
    occupancy mask, and with `superblocks` its 4^3 max-pool dilated by
    two pooled cells, else None);
  - `coarse(stage, rays_o, rays_d, ray_mask, jitter, mask, rc, t_near,
    t_far, buf)` -> (flags, codes, t_near, t_far): stage SUPERBLOCKS
    over R x n_superblocks lanes, BLOCKS_DENSE over R x n_blocks lanes
    (both compute each ray's bounds and jitter and return them), or
    BLOCKS_AFTER over the superblock buffer `buf`'s (KSB + 1) x 4 lanes
    (with the given bounds); a lane's code is its ray x n + its index;
  - `samples(rays_o, rays_d, binary, t_near, t_far, blk_buf, rc)` ->
    (flags, codes, counts): the exact per-sample test over the block
    buffer's (KB + 1) x 8 lanes, codes ray x S + step, and each ray's
    number of flagged lanes (its demand before the budget);
  - `decode(code_buf, t_near, sb_cut, blk_cut, n_rays, rc)` -> (t_mid,
    dt, ray_idx, coarse_complete): the compacted sample codes' timeline
    values (0 in empty slots, whose ray index is n_rays) and whether each
    ray lost nothing to a coarse budget (the cutoffs of the superblock
    and block compactions).

Flags and codes are flat, in the plain version's row-major lane order
(ray-major), which the compactions keep. On a CUDA tensor each wrapper
launches its kernel of `csrc/march.cu` (`masks` one to three times) or
raises; on a CPU tensor it runs its plain version (`*_reference`, the
renderer's former code, held to the JAX package by the tests). The
`*_model` functions are a per-lane model of the kernels' operation order
in plain float32 torch (each lane's index decode, bounds and tests as
the kernel forms them, one rounding an operation), which the CPU tests
hold bit for bit to the plain version. The kernels allocate nothing:
each wrapper makes one allocation for its outputs (typed views of one
buffer), since every allocator call is an operator call, but for the
per-ray outputs that outlive the march in RaySamples (the demand counts,
coarse_complete), which have their own, so that they do not keep a
stage's lane buffers alive.

`MASKS_LAUNCHES`, `COARSE_LAUNCHES`, `SAMPLES_LAUNCHES` and
`DECODE_LAUNCHES` count the kernels' launches.
"""

import ctypes
import math

import numpy as np
import torch

from ..models import contraction as contraction_lib
from ..models import occupancy
from ..utils.device import constant
from ._cuda_build import carve as _carve, launch as _launch

BLOCK_STEPS = 8   # timeline steps per block (~one grid cell)
SB_BLOCKS = 4     # blocks per superblock
POOL = 4          # occupancy pooling factor for the superblock mask

# the coarse stages (the kernel's `stage`)
SUPERBLOCKS, BLOCKS_AFTER, BLOCKS_DENSE = 0, 1, 2

MASKS_LAUNCHES = 0    # march_masks_kernel launches since the last reset
COARSE_LAUNCHES = 0   # march_coarse_kernel launches
SAMPLES_LAUNCHES = 0  # march_samples_kernel launches
DECODE_LAUNCHES = 0   # march_decode_kernel launches

_CONTRACTIONS = {contraction_lib.ContractionType.AABB: 0,
                 contraction_lib.ContractionType.UN_BOUNDED_SPHERE: 1,
                 contraction_lib.ContractionType.UN_BOUNDED_TANH: 2}

_lib = None  # the kernel library, bound at first use


def n_blocks_of(rc):
    return -(-rc.max_samples_per_ray // BLOCK_STEPS)


# ---------------------------------------------------------------------------
# the plain version


def ray_t_bounds(rays_o, rays_d, rc):
    """Per-ray [t_near, t_far] from the scene AABB and near/far planes."""
    near = 0.0 if rc.near_plane is None else rc.near_plane
    far = float("inf") if rc.far_plane is None else rc.far_plane
    shape = rays_o.shape[:-1]
    t_near = torch.full(shape, near, dtype=torch.float32,
                        device=rays_o.device)
    t_far = torch.full(shape, far, dtype=torch.float32, device=rays_o.device)
    if rc.contraction_type == contraction_lib.ContractionType.AABB:
        aabb = _aabb(rc, rays_o.device)
        safe_d = torch.where(rays_d.abs() < 1e-10,
                             torch.full_like(rays_d, 1e-10), rays_d)
        inv_d = 1.0 / safe_d
        t0 = (aabb[:3] - rays_o) * inv_d
        t1 = (aabb[3:] - rays_o) * inv_d
        t_in = torch.minimum(t0, t1).amax(dim=-1)
        t_out = torch.maximum(t0, t1).amin(dim=-1)
        t_near = torch.maximum(t_near, t_in)
        t_far = torch.minimum(t_far, t_out)
    return t_near, t_far


def timeline_at(k, t_start, rc):
    """Closed-form march timeline t_k (k float32, broadcast against
    t_start): uniform steps of render_step_size without a cone angle;
    with one, uniform up to t_cross = step / cone, then geometric,
    t_{k+1} = t_k * (1 + cone), the closed form of nerfacc's
    dt = clamp(t * cone, min=step) recurrence."""
    step = rc.render_step_size
    if rc.cone_angle <= 0.0:
        return t_start + k * step
    cone = rc.cone_angle
    m = torch.ceil(torch.clamp(step / cone - t_start, min=0.0) / step)
    t_uniform = t_start + k * step
    t_geom = (t_start + m * step) * torch.pow(
        1.0 + cone, torch.clamp(k - m, min=0.0))
    return torch.where(k <= m, t_uniform, t_geom)


def dilate_binary(binary, resolution):
    """3^3 max-pool (one-cell dilation) of a flat occupancy mask."""
    g = binary.reshape(resolution, resolution, resolution)
    for axis in range(3):
        lo = torch.zeros_like(g)
        hi = torch.zeros_like(g)
        lo.narrow(axis, 0, resolution - 1).copy_(
            g.narrow(axis, 1, resolution - 1))
        hi.narrow(axis, 1, resolution - 1).copy_(
            g.narrow(axis, 0, resolution - 1))
        g = g | lo | hi
    return g.reshape(-1)


def maxpool_binary(binary, resolution, pool):
    r = resolution // pool
    g = binary.reshape(r, pool, r, pool, r, pool)
    return g.any(dim=5).any(dim=3).any(dim=1).reshape(-1)


def _aabb(rc, device):
    return constant(rc.aabb, torch.float32, device)


def masks_reference(binary, rc, superblocks):
    res = rc.grid_resolution
    dilated = dilate_binary(binary, res)
    if not superblocks:
        return dilated, None
    pooled_res = res // POOL
    pooled = maxpool_binary(dilated, res, POOL)
    return dilated, dilate_binary(dilate_binary(pooled, pooled_res),
                                  pooled_res)


def bounds_reference(rays_o, rays_d, jitter, rc):
    """Each ray's [t_near, t_far], t_near jittered when rc.stratified."""
    t_near, t_far = ray_t_bounds(rays_o, rays_d, rc)
    if rc.stratified:
        t_near = t_near + jitter * rc.render_step_size
    return t_near, t_far


def coarse_reference(stage, rays_o, rays_d, ray_mask, jitter, mask, rc,
                     t_near=None, t_far=None, buf=None):
    device = rays_o.device
    R = rays_o.shape[0]
    n_blocks = n_blocks_of(rc)
    n_sb = n_blocks // SB_BLOCKS
    res = rc.grid_resolution
    aabb = _aabb(rc, device)
    ray_ids = torch.arange(R, device=device)
    if stage != BLOCKS_AFTER:
        t_near, t_far = bounds_reference(rays_o, rays_d, jitter, rc)
    if stage == SUPERBLOCKS:
        pooled_res = res // POOL
        sb = torch.arange(n_sb, dtype=torch.float32, device=device)
        sb_steps = SB_BLOCKS * BLOCK_STEPS
        tn = t_near[:, None]
        t_sb_mid = timeline_at(sb * sb_steps + sb_steps / 2, tn, rc)
        t_sb_lo = timeline_at(sb * sb_steps, tn, rc)
        t_sb_hi = timeline_at((sb + 1) * sb_steps, tn, rc)
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t_sb_mid[..., None]
        u = contraction_lib.contract(pos, aabb, rc.contraction_type)
        cell, _ = occupancy.grid_index(u.clamp(0.0, 1.0 - 1e-7), pooled_res)
        sb_valid = (mask[cell] & (t_sb_lo < t_far[:, None])
                    & (t_sb_hi > tn) & ray_mask[:, None])
        sb_code = ray_ids[:, None] * n_sb + torch.arange(n_sb, device=device)
        return sb_valid.reshape(-1), sb_code.reshape(-1), t_near, t_far
    if stage == BLOCKS_AFTER:
        sb_ray = torch.clamp(buf // n_sb, max=R - 1)
        cand_ray = sb_ray[:, None].expand(buf.shape[0], SB_BLOCKS)
        cand_blk = ((buf % n_sb)[:, None] * SB_BLOCKS
                    + torch.arange(SB_BLOCKS, device=device))
        cand_active = (buf < R * n_sb)[:, None]
    else:
        cand_ray = ray_ids[:, None].expand(R, n_blocks)
        cand_blk = torch.arange(n_blocks, device=device)[None, :].expand(
            R, n_blocks)
        cand_active = ray_mask[:, None]
    tn_c = t_near[cand_ray]
    tf_c = t_far[cand_ray]
    blk_f = cand_blk.to(torch.float32)
    t_blk_mid = timeline_at(blk_f * BLOCK_STEPS + BLOCK_STEPS / 2, tn_c, rc)
    t_blk_lo = timeline_at(blk_f * BLOCK_STEPS, tn_c, rc)
    t_blk_hi = timeline_at((blk_f + 1) * BLOCK_STEPS, tn_c, rc)
    pos = rays_o[cand_ray] + rays_d[cand_ray] * t_blk_mid[..., None]
    u = contraction_lib.contract(pos, aabb, rc.contraction_type)
    cell, _ = occupancy.grid_index(u.clamp(0.0, 1.0 - 1e-7), res)
    blk_valid = (mask[cell] & (t_blk_lo < tf_c) & (t_blk_hi > tn_c)
                 & cand_active)
    blk_code = cand_ray * n_blocks + cand_blk
    return blk_valid.reshape(-1), blk_code.reshape(-1), t_near, t_far


def samples_reference(rays_o, rays_d, binary, t_near, t_far, blk_buf, rc):
    device = rays_o.device
    R = rays_o.shape[0]
    S = rc.max_samples_per_ray
    n_blocks = n_blocks_of(rc)
    res = rc.grid_resolution
    aabb = _aabb(rc, device)
    blk_ray = torch.clamp(blk_buf // n_blocks, max=R - 1)
    step_k = ((blk_buf % n_blocks)[:, None] * BLOCK_STEPS
              + torch.arange(BLOCK_STEPS, device=device))  # (KB+1, 8)
    tn_b = t_near[blk_ray][:, None]
    tf_b = t_far[blk_ray][:, None]
    step_f = step_k.to(torch.float32)
    t_mid = 0.5 * (timeline_at(step_f, tn_b, rc)
                   + timeline_at(step_f + 1.0, tn_b, rc))
    pos = rays_o[blk_ray][:, None, :] + rays_d[blk_ray][:, None, :] \
        * t_mid[..., None]
    u = contraction_lib.contract(pos, aabb, rc.contraction_type)
    occ = occupancy.query(binary, u, res)
    sample_valid = (occ & (t_mid < tf_b) & (t_mid >= tn_b) & (step_k < S)
                    & (blk_buf < R * n_blocks)[:, None])
    sample_code = blk_ray[:, None] * S + step_k
    # per-ray demand counts (every valid sample, before the budget). The
    # lanes are in ray order (blk_ray never decreases: both compactions
    # keep the ray-major lane order, and the fill lanes sit at the end as
    # ray R - 1), so each ray's lanes are one segment and its count is a
    # difference of the lanes' valid-flag cumsum at the segment bounds.
    # (torch.bincount would read its output size back to the host.)
    csum = torch.cumsum(sample_valid.reshape(-1).to(torch.int64), dim=0)
    csum = torch.cat([csum.new_zeros(1), csum])
    lane_ray = blk_ray[:, None].expand(-1, BLOCK_STEPS).reshape(-1)
    bounds = torch.searchsorted(lane_ray, torch.arange(R + 1, device=device))
    counts = csum[bounds[1:]] - csum[bounds[:-1]]
    return sample_valid.reshape(-1), sample_code.reshape(-1), counts


def decode_reference(code_buf, t_near, sb_cut, blk_cut, n_rays, rc):
    R = n_rays
    S = rc.max_samples_per_ray
    n_blocks = n_blocks_of(rc)
    first_bad_ray = torch.full((), R, dtype=torch.int64,
                               device=code_buf.device)
    if sb_cut is not None:
        first_bad_ray = sb_cut // (n_blocks // SB_BLOCKS)
    first_bad_ray = torch.minimum(first_bad_ray, blk_cut // n_blocks)
    live = code_buf < R * S
    ray_idx = torch.where(live, code_buf // S, torch.full_like(code_buf, R))
    step = (code_buf % S).to(torch.float32)
    tn_s = t_near[torch.clamp(ray_idx, max=R - 1)]
    s_t0 = timeline_at(step, tn_s, rc)
    s_t1 = timeline_at(step + 1.0, tn_s, rc)
    zero = torch.zeros_like(s_t0)
    t_buf = torch.where(live, 0.5 * (s_t0 + s_t1), zero)
    dt_buf = torch.where(live, s_t1 - s_t0, zero)
    coarse_complete = torch.arange(R, device=code_buf.device) < first_bad_ray
    return t_buf, dt_buf, ray_idx, coarse_complete


# ---------------------------------------------------------------------------
# the kernels' parameters and the per-lane model of the kernels


def _values(rc, n_rays):
    """The kernels' parameters (csrc/march.cu MarchParams), each number
    formed as the plain version forms it from the render config: the
    float32 rounding of the Python double it hands PyTorch."""
    f32 = np.float32
    n_blocks = n_blocks_of(rc)
    step = f32(rc.render_step_size)
    cone = rc.cone_angle > 0.0
    return dict(
        aabb_lo=[f32(v) for v in rc.aabb[:3]],
        aabb_hi=[f32(v) for v in rc.aabb[3:]],
        near_plane=f32(0.0 if rc.near_plane is None else rc.near_plane),
        far_plane=f32(math.inf if rc.far_plane is None else rc.far_plane),
        step=step, inv_step=f32(1.0) / step,
        t_cross=f32(rc.render_step_size / rc.cone_angle) if cone else f32(0),
        growth=f32(1.0 + rc.cone_angle), clamp_hi=f32(1.0 - 1e-7),
        min_dir=f32(1e-10), min_mag=f32(1e-6),
        contraction=_CONTRACTIONS[rc.contraction_type], cone=int(cone),
        stratified=int(bool(rc.stratified)), n_rays=int(n_rays),
        max_samples=int(rc.max_samples_per_ray), n_blocks=n_blocks,
        n_superblocks=n_blocks // SB_BLOCKS,
        resolution=int(rc.grid_resolution),
        pooled_resolution=int(rc.grid_resolution) // POOL)


def _model_timeline(k, t0, q, cuda_division):
    """The kernel's `timeline`. `cuda_division`: the plain version's
    `x / step` as torch's CUDA kernel computes it for a Python divisor, a
    product with the float32 reciprocal (the kernel's form); else as the
    CPU's, a quotient."""
    uniform = t0 + k * q["step"]
    if not q["cone"]:
        return uniform
    x = torch.clamp(q["t_cross"] - t0, min=0.0)
    m = torch.ceil(x * q["inv_step"] if cuda_division else x / q["step"])
    geom = (t0 + m * q["step"]) * torch.pow(
        q["growth"], torch.clamp(k - m, min=0.0))
    return torch.where(k <= m, uniform, geom)


def _model_tensors(rc, n_rays, device):
    """`_values` with its float32 numbers as tensors on `device`."""
    return {k: (torch.tensor(np.asarray(x, np.float32), device=device)
                if isinstance(x, (np.floating, list)) else x)
            for k, x in _values(rc, n_rays).items()}


def _model_bounds(q, o, d, jitter):
    """The kernel's `ray_bounds` for each lane's ray (o, d: (n, 3))."""
    tn = q["near_plane"].expand(o.shape[0])
    tf = q["far_plane"].expand(o.shape[0])
    if q["contraction"] == 0:
        t_in = t_out = None
        for i in range(3):
            safe = torch.where(d[:, i].abs() < q["min_dir"], q["min_dir"],
                               d[:, i])
            inv = torch.div(torch.ones_like(safe), safe)
            t0 = (q["aabb_lo"][i] - o[:, i]) * inv
            t1 = (q["aabb_hi"][i] - o[:, i]) * inv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            if t_in is None:
                t_in, t_out = lo, hi
            else:
                t_in = torch.where(t_in.isnan() | (t_in > lo), t_in, lo)
                t_out = torch.where(t_out.isnan() | (t_out < hi), t_out, hi)
        tn = torch.maximum(tn, t_in)
        tf = torch.minimum(tf, t_out)
    if q["stratified"]:
        tn = tn + jitter * q["step"]
    return tn, tf


def _model_contract(q, x):
    u = [(x[:, i] - q["aabb_lo"][i]) / (q["aabb_hi"][i] - q["aabb_lo"][i])
         for i in range(3)]
    if q["contraction"] == 1:
        v = [ui * 2.0 - 1.0 for ui in u]
        mag = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
        safe = torch.clamp(mag, min=q["min_mag"])
        scale = 2.0 - torch.div(torch.ones_like(safe), safe)
        v = [torch.where(mag > 1.0, scale * (vi / safe), vi) for vi in v]
        u = [vi * 0.25 + 0.5 for vi in v]
    elif q["contraction"] == 2:
        u = [(torch.tanh(ui - 0.5) + 1.0) * 0.5 for ui in u]
    return u


def _model_cells(u, res, clamp_hi=None):
    """(flat cell, in-grid) of the contracted coordinates u, clamped to
    [0, clamp_hi] first when given (the coarse stages' lookup)."""
    cells, in_grid = [], None
    for ui in u:
        if clamp_hi is not None:
            ui = ui.clamp(0.0, float(clamp_hi))
        c = torch.floor(ui * float(res)).to(torch.int64)
        inside = (c >= 0) & (c < res)
        in_grid = inside if in_grid is None else in_grid & inside
        cells.append(c.clamp(0, res - 1))
    return (cells[2] * res + cells[1]) * res + cells[0], in_grid


def _model_position(q, o, d, t):
    return torch.stack([o[:, i] + d[:, i] * t for i in range(3)], -1)


def masks_model(binary, rc, superblocks):
    """The masks kernel's form: each cell the OR of its (2 radius + 1)^3
    neighbourhood cut at the faces (radius 2 at the pooled resolution in
    place of two one-cell dilations), and the 4^3 pool cell by cell."""
    def dilate(g, res, radius):
        g = g.reshape(res, res, res)
        out = torch.zeros_like(g)
        for dz in range(-radius, radius + 1):
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    src = g[max(dz, 0):res + min(dz, 0),
                            max(dy, 0):res + min(dy, 0),
                            max(dx, 0):res + min(dx, 0)]
                    out[max(-dz, 0):res + min(-dz, 0),
                        max(-dy, 0):res + min(-dy, 0),
                        max(-dx, 0):res + min(-dx, 0)] |= src
        return out.reshape(-1)

    res = rc.grid_resolution
    dilated = dilate(binary, res, 1)
    if not superblocks:
        return dilated, None
    r = res // POOL
    pooled = torch.zeros(r ** 3, dtype=torch.bool, device=binary.device)
    g = dilated.reshape(res, res, res)
    for k in range(POOL):
        for j in range(POOL):
            for i in range(POOL):
                pooled |= g[k::POOL, j::POOL, i::POOL].reshape(-1)
    return dilated, dilate(pooled, r, 2)


def coarse_model(stage, rays_o, rays_d, ray_mask, jitter, mask, rc,
                 t_near=None, t_far=None, buf=None, cuda_division=False):
    """The coarse kernel lane by lane (see `_model_timeline` for
    `cuda_division`)."""
    device = rays_o.device
    R = rays_o.shape[0]
    q = _model_tensors(rc, R, device)
    if stage == BLOCKS_AFTER:
        lane = torch.arange(buf.shape[0] * SB_BLOCKS, device=device)
        c = buf[lane // SB_BLOCKS]
        ray = torch.clamp(c // q["n_superblocks"], max=R - 1)
        blk = (c % q["n_superblocks"]) * SB_BLOCKS + lane % SB_BLOCKS
        active = c < R * q["n_superblocks"]
        tn, tf = t_near[ray], t_far[ray]
        code = ray * q["n_blocks"] + blk
    else:
        per = q["n_superblocks"] if stage == SUPERBLOCKS else q["n_blocks"]
        lane = torch.arange(R * per, device=device)
        ray, blk = lane // per, lane % per
        active = ray_mask[ray]
        tn, tf = _model_bounds(q, rays_o[ray], rays_d[ray],
                               None if jitter is None else jitter[ray])
        first = blk == 0
        t_near = torch.empty(R, dtype=torch.float32, device=device)
        t_far = torch.empty(R, dtype=torch.float32, device=device)
        t_near[ray[first]] = tn[first]
        t_far[ray[first]] = tf[first]
        code = lane
    b = blk.to(torch.float32)
    if stage == SUPERBLOCKS:
        steps = float(SB_BLOCKS * BLOCK_STEPS)
        res = q["pooled_resolution"]
    else:
        steps = float(BLOCK_STEPS)
        res = q["resolution"]
    k_lo = b * steps
    k_mid = k_lo + steps / 2
    k_hi = (b + 1.0) * steps
    t_mid = _model_timeline(k_mid, tn, q, cuda_division)
    t_lo = _model_timeline(k_lo, tn, q, cuda_division)
    t_hi = _model_timeline(k_hi, tn, q, cuda_division)
    u = _model_contract(q, _model_position(q, rays_o[ray], rays_d[ray],
                                           t_mid))
    cell, _ = _model_cells(u, res, q["clamp_hi"])
    flags = mask[cell] & (t_lo < tf) & (t_hi > tn) & active
    return flags, code, t_near, t_far


def samples_model(rays_o, rays_d, binary, t_near, t_far, blk_buf, rc,
                  cuda_division=False):
    """The sample kernel lane by lane; each ray's count as a sum of its
    flagged lanes (the kernel's atomic adds)."""
    device = rays_o.device
    R = rays_o.shape[0]
    q = _model_tensors(rc, R, device)
    lane = torch.arange(blk_buf.shape[0] * BLOCK_STEPS, device=device)
    c = blk_buf[lane // BLOCK_STEPS]
    ray = torch.clamp(c // q["n_blocks"], max=R - 1)
    step = (c % q["n_blocks"]) * BLOCK_STEPS + lane % BLOCK_STEPS
    tn, tf = t_near[ray], t_far[ray]
    k = step.to(torch.float32)
    t0 = _model_timeline(k, tn, q, cuda_division)
    t1 = _model_timeline(k + 1.0, tn, q, cuda_division)
    t_mid = 0.5 * (t0 + t1)
    u = _model_contract(q, _model_position(q, rays_o[ray], rays_d[ray],
                                           t_mid))
    cell, in_grid = _model_cells(u, q["resolution"])
    flags = (binary[cell] & in_grid & (t_mid < tf) & (t_mid >= tn)
             & (step < q["max_samples"]) & (c < R * q["n_blocks"]))
    counts = torch.zeros(R, dtype=torch.int64, device=device).index_add_(
        0, ray[flags], torch.ones_like(ray[flags]))
    return flags, ray * q["max_samples"] + step, counts


def decode_model(code_buf, t_near, sb_cut, blk_cut, n_rays, rc,
                 cuda_division=False):
    """The decode kernel slot by slot and ray by ray."""
    R = n_rays
    q = _model_tensors(rc, R, code_buf.device)
    S = q["max_samples"]
    live = code_buf < R * S
    ray = torch.where(live, code_buf // S, R)
    k = (code_buf % S).to(torch.float32)
    tn = t_near[torch.clamp(ray, max=R - 1)]
    t0 = _model_timeline(k, tn, q, cuda_division)
    t1 = _model_timeline(k + 1.0, tn, q, cuda_division)
    t_mid = torch.where(live, 0.5 * (t0 + t1), 0.0)
    dt = torch.where(live, t1 - t0, 0.0)
    first_bad = (int(sb_cut) // q["n_superblocks"] if sb_cut is not None
                 else R)
    first_bad = min(first_bad, int(blk_cut) // q["n_blocks"])
    return (t_mid, dt, ray,
            torch.arange(R, device=code_buf.device) < first_bad)


# ---------------------------------------------------------------------------
# the kernels


class _Params(ctypes.Structure):
    """csrc/march.cu MarchParams."""
    _fields_ = ([("aabb_lo", ctypes.c_float * 3),
                 ("aabb_hi", ctypes.c_float * 3)]
                + [(name, ctypes.c_float) for name in (
                    "near_plane", "far_plane", "step", "inv_step", "t_cross",
                    "growth", "clamp_hi", "min_dir", "min_mag")]
                + [(name, ctypes.c_int32) for name in (
                    "contraction", "cone", "stratified")]
                + [(name, ctypes.c_int64) for name in (
                    "n_rays", "max_samples", "n_blocks", "n_superblocks",
                    "resolution", "pooled_resolution")])


def _params(rc, n_rays):
    v = _values(rc, n_rays)
    p = _Params()
    for name, _ in _Params._fields_:
        value = v[name]
        if isinstance(value, list):
            value = (ctypes.c_float * 3)(*[float(x) for x in value])
        setattr(p, name, value)
    return p


def _library():
    global _lib
    if _lib is None:
        from . import _cuda_build

        _lib = _cuda_build.library()
    return _lib


def _require(t, name, dtype, numel, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the rays on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, want {numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rays(rays_o, rays_d):
    R = rays_o.shape[0] if rays_o.dim() == 2 else 0
    if R == 0 or tuple(rays_o.shape) != (R, 3):
        raise ValueError(f"rays_o must be (R, 3) with R > 0, got "
                         f"{tuple(rays_o.shape)}")
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        _require(t, name, torch.float32, 3 * R, rays_o.device)
    return R


def masks(binary, rc, superblocks):
    """(dilated, pooled or None); see the module docstring."""
    global MASKS_LAUNCHES
    if not binary.is_cuda:
        return masks_reference(binary, rc, superblocks)
    device, res = binary.device, rc.grid_resolution
    _require(binary, "binary", torch.bool, res ** 3, device)
    fn = _library().march_masks
    if not superblocks:
        (dilated,) = _carve(device, (res ** 3, torch.bool))
        _launch(fn, device, binary.data_ptr(), dilated.data_ptr(), res, 0, 1)
        MASKS_LAUNCHES += 1
        return dilated, None
    if res % POOL:
        raise ValueError(f"resolution {res} is not a multiple of {POOL}")
    r = res // POOL
    dilated, pooled_once, pooled = _carve(
        device, (res ** 3, torch.bool), (r ** 3, torch.bool),
        (r ** 3, torch.bool))
    # the dilation, the pool, then two pooled dilations as one of radius 2
    for src, dst, size, pool, radius in (
            (binary, dilated, res, 0, 1), (dilated, pooled_once, r, 1, 0),
            (pooled_once, pooled, r, 0, 2)):
        _launch(fn, device, src.data_ptr(), dst.data_ptr(), size, pool,
                radius)
        MASKS_LAUNCHES += 1
    return dilated, pooled


def coarse(stage, rays_o, rays_d, ray_mask, jitter, mask, rc, t_near=None,
           t_far=None, buf=None):
    """(flags, codes, t_near, t_far) of a coarse stage; see the module
    docstring."""
    global COARSE_LAUNCHES
    if not rays_o.is_cuda:
        return coarse_reference(stage, rays_o, rays_d, ray_mask, jitter,
                                mask, rc, t_near, t_far, buf)
    device = rays_o.device
    R = _check_rays(rays_o, rays_d)
    n_blocks = n_blocks_of(rc)
    n_sb = n_blocks // SB_BLOCKS
    res = rc.grid_resolution
    if stage == BLOCKS_AFTER:
        if buf is None or buf.dim() != 1:
            raise ValueError("the block stage after superblocks takes the "
                             "superblock buffer")
        _require(buf, "buf", torch.int64, buf.shape[0], device)
        for name, t in (("t_near", t_near), ("t_far", t_far)):
            _require(t, name, torch.float32, R, device)
        n = buf.shape[0] * SB_BLOCKS
        codes, flags = _carve(device, (n, torch.int64), (n, torch.bool))
        mask_res = res
    elif stage in (SUPERBLOCKS, BLOCKS_DENSE):
        _require(ray_mask, "ray_mask", torch.bool, R, device)
        if rc.stratified:
            if jitter is None:
                raise ValueError("a stratified march takes the jitter")
            _require(jitter, "jitter", torch.float32, R, device)
        n = R * (n_sb if stage == SUPERBLOCKS else n_blocks)
        codes, t_near, t_far, flags = _carve(
            device, (n, torch.int64), (R, torch.float32),
            (R, torch.float32), (n, torch.bool))
        mask_res = res // POOL if stage == SUPERBLOCKS else res
    else:
        raise ValueError(f"unknown coarse stage {stage}")
    _require(mask, "mask", torch.bool, mask_res ** 3, device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    params = _params(rc, R)
    _launch(_library().march_coarse, device, ctypes.addressof(params),
            stage, rays_o.data_ptr(), rays_d.data_ptr(),
            ptr(ray_mask) if stage != BLOCKS_AFTER else None,
            ptr(jitter) if stage != BLOCKS_AFTER and rc.stratified else None,
            mask.data_ptr(), ptr(buf) if stage == BLOCKS_AFTER else None, n,
            t_near.data_ptr(), t_far.data_ptr(), flags.data_ptr(),
            codes.data_ptr())
    COARSE_LAUNCHES += 1
    return flags, codes, t_near, t_far


def samples(rays_o, rays_d, binary, t_near, t_far, blk_buf, rc):
    """(flags, codes, counts) of the sample stage; see the module
    docstring."""
    global SAMPLES_LAUNCHES
    if not rays_o.is_cuda:
        return samples_reference(rays_o, rays_d, binary, t_near, t_far,
                                 blk_buf, rc)
    device = rays_o.device
    R = _check_rays(rays_o, rays_d)
    _require(binary, "binary", torch.bool, rc.grid_resolution ** 3, device)
    for name, t in (("t_near", t_near), ("t_far", t_far)):
        _require(t, name, torch.float32, R, device)
    if blk_buf.dim() != 1:
        raise ValueError("blk_buf must be 1-D")
    _require(blk_buf, "blk_buf", torch.int64, blk_buf.shape[0], device)
    n = blk_buf.shape[0] * BLOCK_STEPS
    codes, flags = _carve(device, (n, torch.int64), (n, torch.bool))
    counts = torch.zeros(R, dtype=torch.int64, device=device)
    params = _params(rc, R)
    _launch(_library().march_samples, device, ctypes.addressof(params),
            rays_o.data_ptr(), rays_d.data_ptr(), binary.data_ptr(),
            t_near.data_ptr(), t_far.data_ptr(), blk_buf.data_ptr(), n,
            flags.data_ptr(), codes.data_ptr(), counts.data_ptr())
    SAMPLES_LAUNCHES += 1
    return flags, codes, counts


def decode(code_buf, t_near, sb_cut, blk_cut, n_rays, rc):
    """(t_mid, dt, ray_idx, coarse_complete); see the module docstring."""
    global DECODE_LAUNCHES
    if not code_buf.is_cuda:
        return decode_reference(code_buf, t_near, sb_cut, blk_cut, n_rays,
                                rc)
    device, R = code_buf.device, int(n_rays)
    if code_buf.dim() != 1 or R < 1:
        raise ValueError("code_buf must be 1-D, with n_rays > 0")
    _require(code_buf, "code_buf", torch.int64, code_buf.shape[0], device)
    _require(t_near, "t_near", torch.float32, R, device)
    for name, t in (("sb_cut", sb_cut), ("blk_cut", blk_cut)):
        if t is not None:
            _require(t, name, torch.int64, 1, device)
    if blk_cut is None:
        raise ValueError("the decode takes the block stage's cutoff")
    n = code_buf.shape[0]
    ray_idx, t_mid, dt = _carve(device, (n, torch.int64), (n, torch.float32),
                                (n, torch.float32))
    coarse_complete = torch.empty(R, dtype=torch.bool, device=device)
    params = _params(rc, R)
    _launch(_library().march_decode, device, ctypes.addressof(params),
            code_buf.data_ptr(), n, t_near.data_ptr(),
            None if sb_cut is None else sb_cut.data_ptr(),
            blk_cut.data_ptr(), t_mid.data_ptr(), dt.data_ptr(),
            ray_idx.data_ptr(), coarse_complete.data_ptr())
    DECODE_LAUNCHES += 1
    return t_mid, dt, ray_idx, coarse_complete
