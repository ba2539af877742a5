"""Occupancy-gated volumetric rendering (counterpart of
deblur_e_nerf_tpu/models/renderer.py).

The march keeps the JAX package's fixed-budget design, so the sample set
and the per-ray completeness flag mean the same in both packages:

  0. superblock pass (32-step superblocks against a 4x max-pooled, twice
     dilated occupancy mask), when the geometry allows it (a uniform
     timeline: never under a cone angle);
  1. block pass (8-step blocks against the one-cell-dilated mask);
  2. exact per-sample pass (occupancy at the sample midpoint and the
     [t_near, t_far) bounds).

Each pass stream-compacts packed (ray, index) codes into a buffer of fixed
capacity, keeping the first flagged codes in ray order; the sample buffer
holds K + 1 slots, slot K being an always-empty trash slot. A ray is
complete when its whole demand segment fits the sample budget and none of
its blocks or superblocks was dropped by a coarse buffer.

The occlusion prepass (`rc.prepass_div`, `occlusion_prepass`) runs a
density-only forward without gradients over the marched buffer, cuts each
ray's dead suffix (exclusive transmittance at or below `early_stop_eps`,
the samples composite gives zero weight and zero cotangent) and compacts
the survivors into a (K / prepass_div + 1)-slot buffer, in place of
nerfacc's in-loop early stop. Its buffers have fixed sizes, so it reads
nothing back to the host.

The march's stages (the masks, the coarse stages' and the sample
stage's flags and codes, the demand counts, the decode) go through
ops/march.py, the stream compactions (the march's stages and the
prepass's three payloads) through ops/compact.py, and compositing, with
the prepass's density-only live mask, through ops/composite.py: on CUDA
tensors the hand-written kernels of csrc/march.cu, csrc/compact.cu and
csrc/composite.cu, on CPU tensors their plain versions
(`march_reference` runs the plain march on any device). Each ray's
exclusive optical depth (sigma dt clamped at 25 per sample) is a float64
sum rounded to float32 (the JAX package's double-f32 blocked sums exist
because the TPU has no fast f64), and the prepass's live mask comes from
the same code as composite's.
The stratified jitter is an input (`jitter`, (R,) uniforms).

With `rc.field_chunk`, the training render runs the field `field_chunk`
samples at a time: each chunk's encode output is kept for the backward
(the encode forward never runs again) and only the MLPs and the SH
encoding are recomputed there, under torch.utils.checkpoint (the JAX
package's `save_only_these_names("hash_encode_out")`).

`render_rays_eval` is the evaluation render: the same march, prepass and
composite without gradients, with the density pass and the field run only
on the filled sample slots, in `field_chunk` pieces (the JAX package runs
them on every slot of the worst-case eval buffer, where the empty ones get
no weight).
"""

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint

from . import contraction as contraction_lib
from ..ops import compact as compact_ops
from ..ops import composite as composite_ops
from ..ops import march as march_ops


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    aabb: Tuple[float, ...]
    contraction_type: contraction_lib.ContractionType
    grid_resolution: int
    near_plane: Optional[float]
    far_plane: Optional[float]
    render_step_size: float
    cone_angle: float = 0.0
    early_stop_eps: float = 1e-4
    alpha_thre: float = 0.0
    stratified: bool = False
    max_samples_per_ray: int = 1024          # S_max
    sample_budget: int = 1 << 17             # K
    block_budget: Optional[int] = None       # KB (None = K // 4)
    superblock_budget: Optional[int] = None  # KSB (None = KB // 2; 0 = off)
    # samples per field call (0 = all): the training render checkpoints
    # each chunk's MLPs and keeps its encode output; the eval render and
    # the prepass's density pass run chunk by chunk without gradients
    field_chunk: int = 0
    # occlusion prepass: the post-cull buffer holds sample_budget //
    # prepass_div samples (0 = off)
    prepass_div: int = 0
    opacity_eps: float = 1e-10

    @property
    def block_capacity(self):
        return self.block_budget or max(self.sample_budget // 4, 1)

    @property
    def superblock_capacity(self):
        return self.superblock_budget or max(self.block_capacity // 2, 1)

    @property
    def prepass_budget(self):
        if not self.prepass_div:
            return None
        return max(self.sample_budget // self.prepass_div, 1)


class SplitField(NamedTuple):
    """A field as `encode(positions) -> tuple of tensors` and
    `decode(*encoded, directions) -> (rgb, density)`: the form the chunked
    training render needs (it keeps `encode`'s output, recomputes
    `decode`)."""
    encode: Callable
    decode: Callable

    def __call__(self, positions, directions):
        return self.decode(*self.encode(positions), directions)


class RaySamples(NamedTuple):
    """Flat compacted samples (capacity K + 1; slot K is trash)."""
    t_mid: torch.Tensor        # (K+1,) float32
    dt: torch.Tensor           # (K+1,) float32
    ray_idx: torch.Tensor      # (K+1,) int64; == R for empty slots
    counts: torch.Tensor       # (R,) int64 valid samples per ray (demand)
    offsets: torch.Tensor      # (R,) int64 exclusive cumsum of counts
    num_samples: torch.Tensor  # () int64 total demand (may exceed K)
    num_blocks: torch.Tensor   # () int64 block demand
    num_superblocks: Optional[torch.Tensor]  # () int64, None without stage 0
    coarse_complete: torch.Tensor  # (R,) bool


BLOCK_STEPS = march_ops.BLOCK_STEPS   # timeline steps per block
SB_BLOCKS = march_ops.SB_BLOCKS       # blocks per superblock
POOL = march_ops.POOL                 # the superblock mask's pooling
_timeline_at = march_ops.timeline_at  # the closed-form march timeline


def _compact(flags, payload, budget, fill, return_cutoff=False,
             plain=False):
    """Stream-compact `payload[flags]` (in lane order) into a (budget + 1,)
    buffer whose slot `budget` holds `fill` (ops/compact.py; its plain
    version with `plain`). Returns (buffer, number of flagged lanes[, the
    smallest dropped payload, == fill if none])."""
    fn = compact_ops.compact_reference if plain else compact_ops.compact
    out = fn(flags.reshape(-1), (payload.reshape(-1),), budget, (fill,),
             return_cutoff)
    return (out[0][0], *out[1:])


def uses_superblocks(rc):
    """Whether the march runs its superblock stage (three compactions, else
    two): the geometry must allow it."""
    res = rc.grid_resolution
    n_blocks = march_ops.n_blocks_of(rc)
    min_cell_extent = min((rc.aabb[3 + i] - rc.aabb[i]) / res
                          for i in range(3))
    sb_reach = ((SB_BLOCKS * BLOCK_STEPS / 2 + BLOCK_STEPS / 2)
                * rc.render_step_size)
    # the superblock reach assumes the uniform timeline
    return (rc.cone_angle <= 0.0
            and res % POOL == 0
            and n_blocks % SB_BLOCKS == 0
            and n_blocks >= 2 * SB_BLOCKS
            and sb_reach <= 2 * POOL * min_cell_extent
            and rc.superblock_budget != 0)


def _march(binary, rays_o, rays_d, ray_mask, jitter, rc, plain):
    """The march's stages (ops/march.py) and the compactions between them;
    with `plain`, every stage's plain version whatever the device."""
    if plain:
        masks, coarse, samples, decode = (
            march_ops.masks_reference, march_ops.coarse_reference,
            march_ops.samples_reference, march_ops.decode_reference)
    else:
        masks, coarse, samples, decode = (
            march_ops.masks, march_ops.coarse, march_ops.samples,
            march_ops.decode)
    R = rays_o.shape[0]
    S = rc.max_samples_per_ray
    n_blocks = march_ops.n_blocks_of(rc)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    if jitter is not None:
        jitter = jitter.contiguous()
    ray_mask = ray_mask.contiguous()

    dilated, pooled = masks(binary, rc, uses_superblocks(rc))
    num_superblocks = sb_cut = None
    if pooled is not None:
        n_sb = n_blocks // SB_BLOCKS
        flags, codes, t_near, t_far = coarse(
            march_ops.SUPERBLOCKS, rays_o, rays_d, ray_mask, jitter, pooled,
            rc)
        sb_buf, num_superblocks, sb_cut = _compact(
            flags, codes, rc.superblock_capacity, R * n_sb, True, plain)
        flags, codes, _, _ = coarse(
            march_ops.BLOCKS_AFTER, rays_o, rays_d, ray_mask, jitter,
            dilated, rc, t_near, t_far, sb_buf)
    else:
        flags, codes, t_near, t_far = coarse(
            march_ops.BLOCKS_DENSE, rays_o, rays_d, ray_mask, jitter,
            dilated, rc)
    blk_buf, num_blocks, blk_cut = _compact(
        flags, codes, rc.block_capacity, R * n_blocks, True, plain)
    flags, codes, counts = samples(rays_o, rays_d, binary, t_near, t_far,
                                   blk_buf, rc)
    code_buf, num_samples = _compact(flags, codes, rc.sample_budget, R * S,
                                     False, plain)
    t_mid, dt, ray_idx, coarse_complete = decode(code_buf, t_near, sb_cut,
                                                 blk_cut, R, rc)
    return RaySamples(
        t_mid=t_mid, dt=dt, ray_idx=ray_idx, counts=counts,
        offsets=torch.cumsum(counts, dim=0) - counts,
        num_samples=num_samples, num_blocks=num_blocks,
        num_superblocks=num_superblocks, coarse_complete=coarse_complete)


@torch.no_grad()
def march_rays(binary, rays_o, rays_d, ray_mask, jitter, rc):
    """Occupancy-gated marching with fixed-budget compaction: on CUDA
    tensors the kernels of ops/march.py and ops/compact.py, on CPU tensors
    their plain versions.

    Args:
        binary: (grid_resolution**3,) bool occupancy mask.
        rays_o, rays_d: (R, 3) float32; unit directions.
        ray_mask: (R,) bool; inactive rays produce no samples.
        jitter: (R,) float32 uniforms for stratified sampling (ignored
            unless rc.stratified).
        rc: RenderConfig.
    Returns:
        RaySamples.
    """
    return _march(binary, rays_o, rays_d, ray_mask, jitter, rc, plain=False)


@torch.no_grad()
def march_reference(binary, rays_o, rays_d, ray_mask, jitter, rc):
    """`march_rays` through every stage's and compaction's plain version,
    on any device."""
    return _march(binary, rays_o, rays_d, ray_mask, jitter, rc, plain=True)


def composite(sigma, rgb, samples, n_rays, rc, render_bkgd=None):
    """Differentiable compositing over flat ray-contiguous samples (K is
    the buffer's own: the prepass's buffer is K / prepass_div + 1 slots).

    Returns colors (R, ch), opacities (R,), depths (R,) and
    num_rendering_samples () — samples contributing before early stop.
    """
    colors, opacities, depths, live_counts = composite_ops.composite(
        sigma, rgb, samples.t_mid, samples.dt, samples.ray_idx,
        samples.offsets, samples.counts, n_rays, rc.early_stop_eps,
        rc.alpha_thre)
    num_rendering_samples = live_counts.sum()
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities[:, None])
    return colors, opacities, depths, num_rendering_samples


def _chunks(n, chunk):
    chunk = chunk or max(n, 1)
    return [slice(start, min(start + chunk, n))
            for start in range(0, n, chunk)]


def _positions(samples, rays_o, rays_d, n_rays):
    safe_idx = samples.ray_idx.clamp(0, n_rays - 1)
    return (rays_o[safe_idx] + rays_d[safe_idx] * samples.t_mid[:, None],
            rays_d[safe_idx])


@torch.no_grad()
def occlusion_prepass(density_only_fn, samples, rays_o, rays_d, n_rays, rc,
                      budget=None):
    """Early-termination compaction (see RenderConfig.prepass_div).

    A density-only forward over every slot of `samples` (in
    `rc.field_chunk` pieces) -> the exclusive transmittance composite
    computes -> each ray's dead suffix cut -> the survivors compacted in
    ray order into a (budget + 1,) buffer (`budget` defaults to
    rc.prepass_budget). `trans > eps` is a per-ray prefix (transmittance
    never rises along a ray), so the cut removes only samples whose
    weights, and whose cotangents to every earlier sample, are zero.

    Returns (compacted RaySamples, live demand () int64 — may exceed the
    budget, which then drops ray tails — and live samples per ray (R,)).
    The compacted samples keep the march's num_samples, num_blocks,
    num_superblocks and coarse_complete: the batch controller must see the
    marched demand.
    """
    budget = rc.prepass_budget if budget is None else budget
    positions, _ = _positions(samples, rays_o, rays_d, n_rays)
    sigma = torch.cat([density_only_fn(positions[sl])[..., 0]
                       for sl in _chunks(positions.shape[0],
                                         rc.field_chunk)])
    live, live_counts = composite_ops.live_mask(
        sigma, samples.dt, samples.ray_idx, samples.offsets, samples.counts,
        n_rays, rc.early_stop_eps, rc.alpha_thre)
    (t_mid, dt, ray_idx), demand = compact_ops.compact(
        live, (samples.t_mid, samples.dt, samples.ray_idx), budget,
        (0.0, 0.0, n_rays))
    # the buffer keeps the first `budget` live samples in ray order: ray r
    # keeps those of its live samples that come before the budget
    live_before = torch.cumsum(live_counts, dim=0) - live_counts
    counts = torch.minimum((budget - live_before).clamp(min=0), live_counts)
    compacted = samples._replace(
        t_mid=t_mid, dt=dt, ray_idx=ray_idx, counts=counts,
        offsets=torch.cumsum(counts, dim=0) - counts)
    return compacted, demand, live_counts


def _run_field(field_fn, positions, directions, chunk):
    """The field on the whole buffer, or `chunk` samples at a time with
    each chunk's `encode` output kept and its `decode` recomputed in the
    backward (`field_fn` a SplitField)."""
    n = positions.shape[0]
    if not chunk or chunk >= n:
        return field_fn(positions, directions)
    rgbs, densities = [], []
    for sl in _chunks(n, chunk):
        encoded = field_fn.encode(positions[sl])
        # decode draws no random numbers: no RNG state to stash
        rgb, density = checkpoint.checkpoint(
            field_fn.decode, *encoded, directions[sl], use_reentrant=False,
            preserve_rng_state=False)
        rgbs.append(rgb)
        densities.append(density)
    return torch.cat(rgbs), torch.cat(densities)


def render_rays(field_fn, binary, rays_o, rays_d, ray_mask, jitter, rc,
                render_bkgd=None, density_only_fn=None):
    """March -> [occlusion prepass] -> field on the compacted samples ->
    composite.

    `field_fn(positions (N,3), directions (N,3)) -> (rgb (N,ch), density
    (N,1))`, a SplitField when `rc.field_chunk` is set;
    `density_only_fn(positions) -> density (N,1)` runs the prepass when
    `rc.prepass_div` is set and `rc.early_stop_eps > 0`. Returns the JAX
    package's output dict; `ray_complete` is False for rays that lost
    samples to the sample, block or superblock budget or the prepass
    buffer. With the prepass configured, `prepass_overflow_rate` is the
    live demand over the prepass buffer whether or not it ran
    (`prepass_ran`): without a `density_only_fn` the field runs on the
    marched buffer and the demand is composite's live count, the same
    mask the prepass reads.
    """
    R = rays_o.shape[0]
    samples = march_rays(binary, rays_o.detach(), rays_d.detach(),
                         ray_mask, jitter, rc)
    ray_complete = _ray_complete(samples, rc)
    zero = torch.zeros((), dtype=torch.float32, device=rays_o.device)
    prepass_overflow_rate = zero
    configured = bool(rc.prepass_div and rc.early_stop_eps > 0)
    ran = configured and density_only_fn is not None
    if ran:
        samples, demand, live_counts = occlusion_prepass(
            density_only_fn, samples, rays_o.detach(), rays_d.detach(), R,
            rc)
        ray_complete = ray_complete & (samples.counts == live_counts)
        # live demand over capacity: > 1 means visible samples were dropped
        prepass_overflow_rate = demand.float() / rc.prepass_budget

    positions, directions = _positions(samples, rays_o, rays_d, R)
    rgb, density = _run_field(field_fn, positions, directions,
                              rc.field_chunk)
    colors, opacities, depths, num_rendering_samples = composite(
        density[..., 0], rgb, samples, R, rc, render_bkgd)
    if configured and not ran:
        prepass_overflow_rate = (num_rendering_samples.float()
                                 / rc.prepass_budget)
    # coarse-stage demand over capacity (> 1: whole ray segments were
    # dropped before the sample stage). The superblock rate divides by the
    # configured superblock capacity; the JAX package divides by KB // 2
    # whatever `superblock_budget` says.
    return {
        "radiance": colors,
        "opacity": opacities,
        "depth": depths / (opacities + rc.opacity_eps),
        "num_rendering_samples": num_rendering_samples,
        "num_marched_samples": samples.num_samples,
        "counts": samples.counts,
        "ray_complete": ray_complete,
        "block_overflow_rate": samples.num_blocks.float() / rc.block_capacity,
        "superblock_overflow_rate": (
            samples.num_superblocks.float() / rc.superblock_capacity
            if samples.num_superblocks is not None else zero),
        "prepass_overflow_rate": prepass_overflow_rate,
        "prepass_ran": torch.full((), float(ran), device=rays_o.device),
    }


def _ray_complete(samples, rc):
    return (samples.offsets + samples.counts <= rc.sample_budget) \
        & samples.coarse_complete


def _cut(samples, n):
    """The buffer's first n slots plus one empty slot (the march and the
    prepass fill a prefix)."""
    return samples._replace(t_mid=samples.t_mid[:n + 1],
                            dt=samples.dt[:n + 1],
                            ray_idx=samples.ray_idx[:n + 1])


@torch.no_grad()
def render_rays_eval(field_fn, binary, rays_o, rays_d, ray_mask, rc,
                     radiance_dim, render_bkgd=None, density_only_fn=None):
    """March -> [prepass] -> field on the filled slots -> composite,
    without gradients.

    The march fills the buffer's first min(num_samples, K) slots, so one
    host read of the demand bounds the field's work: it runs on those
    slots only, `rc.field_chunk` at a time (all at once when 0), and the
    buffer is cut to them plus one empty slot, which composites to the same
    image as the whole buffer with zero density in its empty slots. With
    `rc.prepass_div` (and `density_only_fn`, and `early_stop_eps > 0`), a
    density pass over those slots culls each ray's dead suffix and the
    full field runs on the survivors only (at most rc.prepass_budget;
    live demand beyond it truncates rays), after a second host read.

    Returns {"radiance": colors (R, ch), "counts": marched samples per ray
    (R,)} and the host ints "num_marched_samples" (filled march slots),
    "num_live_samples" (the samples the full field ran on),
    "num_density_chunks" and "num_field_chunks" (calls of the density pass
    and of the field) and "num_truncated" (masked rays that lost samples
    to a budget or to the prepass buffer).
    """
    R = rays_o.shape[0]
    samples = march_rays(binary, rays_o, rays_d, ray_mask, None, rc)
    marched_counts = samples.counts
    ray_complete = _ray_complete(samples, rc)
    demand = int(samples.num_samples)
    n_marched = min(demand, rc.sample_budget)
    samples = _cut(samples, n_marched)
    n_live, n_density = n_marched, 0
    if rc.prepass_div and density_only_fn is not None \
            and rc.early_stop_eps > 0:
        # the cut buffer holds at most n_marched live samples, so a budget
        # above it truncates nothing the prepass budget would keep
        samples, live_demand, live_counts = occlusion_prepass(
            density_only_fn, samples, rays_o, rays_d, R, rc,
            budget=min(rc.prepass_budget, n_marched))
        ray_complete = ray_complete & (samples.counts == live_counts)
        n_live = min(int(live_demand), rc.prepass_budget)
        samples = _cut(samples, n_live)
        n_density = len(_chunks(n_marched + 1, rc.field_chunk))
    n_truncated = int((~ray_complete & ray_mask).sum())
    positions, directions = _positions(samples, rays_o, rays_d, R)
    rgbs, sigmas = [], []
    for sl in _chunks(n_live, rc.field_chunk):
        rgb, density = field_fn(positions[sl], directions[sl])
        rgbs.append(rgb)
        sigmas.append(density[..., 0])
    n_field = len(rgbs)
    rgbs.append(torch.zeros((1, radiance_dim), dtype=torch.float32,
                            device=rays_o.device))
    sigmas.append(torch.zeros(1, dtype=torch.float32, device=rays_o.device))
    colors, _, _, _ = composite(torch.cat(sigmas), torch.cat(rgbs), samples,
                                R, rc, render_bkgd)
    return {
        "radiance": colors,
        "counts": marched_counts,
        "num_marched_samples": n_marched,
        "num_live_samples": n_live,
        "num_density_chunks": n_density,
        "num_field_chunks": n_field,
        "num_truncated": n_truncated,
    }
