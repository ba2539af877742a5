"""Volumetric compositing over a ray-contiguous sample buffer
(counterpart of the JAX package's `composite`, `_sigma_dt_alpha` and
`excl_segment_cumsum_precise`, deblur_e_nerf_tpu/models/renderer.py:613,
:503 and :456).

The buffer: per slot a density `sigma`, a radiance row `rgb`, `t_mid`,
`dt` and `ray_idx` (== n_rays for an empty slot); per ray its `offsets`
and `counts` (the ray's slots are offsets .. offsets + counts - 1, cut at
the buffer's end: a ray truncated by the budget keeps its first slots).

  - `composite(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
    early_stop_eps, alpha_thre)` -> (colors (R, ch), opacities (R,),
    depths (R,), live samples per ray (R,) int64), differentiable in
    sigma and rgb: the raw weighted sums (no background, no depth
    normalisation). On CUDA tensors an autograd function whose forward
    and backward are the kernels of `csrc/composite.cu`; on CPU tensors
    `composite_reference`, differentiated by autograd.
  - `live_mask(sigma, dt, ray_idx, offsets, counts, n_rays,
    early_stop_eps, alpha_thre)` -> (live (n,) bool, live samples per ray
    (R,) int64), without gradients: the occlusion prepass's density-only
    call, the same kernel (or the same plain code) as `composite`'s, so
    both agree at the early-stop boundary.
  - `composite_reference`, `live_mask_reference` and their parts
    (`sigma_dt_alpha`, `ExclusiveOpticalDepth`, `SegmentSum`): the plain
    versions, as the renderer ran them before the kernels.

Each ray's exclusive optical depth is an exact sum rounded to the working
type (float64 running sums; the JAX package's double-f32 blocked sums
exist because the TPU has no fast float64), and the per-ray sums are
float64 with no atomics, so the outputs are deterministic.
`FORWARD_LAUNCHES` and `BACKWARD_LAUNCHES` count the kernels' launches.
"""

import torch

FORWARD_LAUNCHES = 0   # forward kernel launches since the last reset
BACKWARD_LAUNCHES = 0  # backward kernel launches since the last reset

MAX_CHANNELS = 4

_lib = None  # the kernel library, bound at first use


# ---------------------------------------------------------------------------
# the plain version


def sigma_dt_alpha(sigma, dt, ray_idx, n_rays, alpha_thre):
    """(slot_valid, clamped sigma * dt, alpha), masked by alpha_thre."""
    slot_valid = ray_idx < n_rays
    # per-sample optical depth clamp: exp(-25) is far below any
    # early-stop eps, and an overflowed density (inf) would poison the
    # global cumsum with inf - inf
    sigma_dt = torch.clamp(sigma * dt * slot_valid, max=25.0)
    alpha = 1.0 - torch.exp(-sigma_dt)
    if alpha_thre > 0:
        keep = alpha >= alpha_thre
        sigma_dt = sigma_dt * keep
        alpha = alpha * keep
    return slot_valid, sigma_dt, alpha


class ExclusiveOpticalDepth(torch.autograd.Function):
    """Per-ray exclusive prefix sums of a ray-contiguous buffer (each ray's
    samples at offsets .. offsets + counts - 1, empty slots after the last
    ray), in float64 both ways, rounded to the input's type.

    Forward: a float64 cumsum less each ray's segment base. Backward: the
    cotangent of sample j is the sum of the cotangents after it in its
    ray, C[e] - C[j + 1] with C the exclusive float64 cumsum of the
    cotangent and e the ray's segment end: gathers only, so it is
    deterministic whatever the thread count (the transpose of a gather is
    an accumulating index write, whose CPU and CUDA versions add in the
    order threads finish), and a sample's cotangent carries no error of
    the buffer's running total (a float32 cumsum's transpose would).
    Empty slots get a zero cotangent."""

    @staticmethod
    def forward(ctx, sigma_dt, offsets, counts, safe_ray_idx):
        x = sigma_dt.detach().double()
        n = x.shape[0]
        cum = torch.cumsum(x, dim=0)
        seg_base = torch.where(
            offsets > 0, cum[(offsets - 1).clamp(0, n - 1)],
            torch.zeros((), dtype=cum.dtype, device=cum.device))
        ctx.save_for_backward((offsets + counts).clamp(max=n)[safe_ray_idx])
        return (cum - x - seg_base[safe_ray_idx]).to(sigma_dt.dtype)

    @staticmethod
    def backward(ctx, grad):
        (ends,) = ctx.saved_tensors
        g = grad.double()
        csum = torch.cat([g.new_zeros(1), torch.cumsum(g, dim=0)])
        pos = torch.arange(g.shape[0], device=g.device)
        out = torch.where(ends > pos, csum[ends] - csum[1:], 0.0)
        return out.to(grad.dtype), None, None, None


def optical_depth(sigma_dt, offsets, counts, safe_ray_idx):
    """Exclusive optical depth (`ExclusiveOpticalDepth`)."""
    return ExclusiveOpticalDepth.apply(sigma_dt, offsets, counts,
                                       safe_ray_idx)


class SegmentSum(torch.autograd.Function):
    """Per-ray sums of a buffer whose ray ids never decrease, with no
    atomics: the forward takes differences of a float64 cumsum at the
    segment bounds (rounded to the input's type), the backward gives each
    slot its ray's cotangent (a gather; zero for slots of id n_rays). An
    `index_add` adds on the card in the order threads finish, so its
    sums, and the step's loss, differed run to run."""

    @staticmethod
    def forward(ctx, values, bounds, seg_ids):
        csum = torch.cumsum(values.detach().double(), dim=0)
        csum = torch.cat([csum.new_zeros((1, *csum.shape[1:])), csum])
        ctx.save_for_backward(seg_ids)
        return (csum[bounds[1:]] - csum[bounds[:-1]]).to(values.dtype)

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1, *grad.shape[1:]))])
        return padded[seg_ids], None, None


def _live(sigma, dt, ray_idx, offsets, counts, n_rays, early_stop_eps,
          alpha_thre):
    slot_valid, sigma_dt, alpha = sigma_dt_alpha(sigma, dt, ray_idx, n_rays,
                                                 alpha_thre)
    safe_ray_idx = ray_idx.clamp(0, n_rays - 1)
    trans = torch.exp(-optical_depth(sigma_dt, offsets, counts,
                                     safe_ray_idx))
    seg_ids = torch.where(slot_valid, ray_idx,
                          torch.full_like(ray_idx, n_rays))
    bounds = torch.searchsorted(
        seg_ids, torch.arange(n_rays + 1, device=seg_ids.device))
    return slot_valid, alpha, trans, trans > early_stop_eps, seg_ids, bounds


def _segment_counts(flags, bounds):
    """Per-ray counts of `flags`: a difference of their int64 cumsum at the
    segment bounds, with no read to the host."""
    csum = torch.cumsum(flags.to(torch.int64), dim=0)
    csum = torch.cat([csum.new_zeros(1), csum])
    return csum[bounds[1:]] - csum[bounds[:-1]]


def composite_reference(sigma, rgb, t_mid, dt, ray_idx, offsets, counts,
                        n_rays, early_stop_eps, alpha_thre):
    """Plain version of `composite` (autograd differentiates it)."""
    slot_valid, alpha, trans, live, seg_ids, bounds = _live(
        sigma, dt, ray_idx, offsets, counts, n_rays, early_stop_eps,
        alpha_thre)
    weights = trans * alpha * live * slot_valid

    def segment_sum(values):
        return SegmentSum.apply(values, bounds, seg_ids)

    colors = segment_sum(weights[:, None] * rgb)
    opacities = segment_sum(weights)
    depths = segment_sum(weights * t_mid)
    return colors, opacities, depths, _segment_counts(slot_valid & live,
                                                      bounds)


@torch.no_grad()
def live_mask_reference(sigma, dt, ray_idx, offsets, counts, n_rays,
                        early_stop_eps, alpha_thre):
    """Plain version of `live_mask`."""
    slot_valid, _, _, live, _, bounds = _live(
        sigma, dt, ray_idx, offsets, counts, n_rays, early_stop_eps,
        alpha_thre)
    live = live & slot_valid
    return live, _segment_counts(live, bounds)


def composite_backward_model(sigma, rgb, t_mid, dt, ray_idx, offsets,
                             counts, n_rays, early_stop_eps, alpha_thre,
                             g_colors, g_opacities, g_depths):
    """The backward kernel's arithmetic in plain PyTorch, all slots at once:
    (the cotangent of sigma, of rgb) from the outputs' cotangents, with
    g = gC . rgb + gO + gD t_mid a valid slot and the optical depth's
    transpose a float64 sum over the ray's later slots. Held to autograd
    through `composite_reference` by the tests."""
    slot_valid = ray_idx < n_rays
    vf = slot_valid.to(sigma.dtype)
    x = sigma * dt * vf
    clamp_passes = x <= 25.0
    e = torch.exp(-torch.clamp(x, max=25.0))
    _, sigma_dt, alpha = sigma_dt_alpha(sigma, dt, ray_idx, n_rays,
                                        alpha_thre)
    keep = (1.0 - e) >= alpha_thre if alpha_thre > 0 else None
    safe = ray_idx.clamp(0, n_rays - 1)
    trans = torch.exp(-optical_depth(sigma_dt, offsets, counts, safe))
    live = (trans > early_stop_eps).to(sigma.dtype)
    gc = torch.where(slot_valid[:, None], g_colors[safe], 0.0)
    g = torch.where(slot_valid, (gc * rgb).sum(-1) + g_opacities[safe]
                    + g_depths[safe] * t_mid, 0.0)
    w = trans * alpha * live * vf
    ga3 = g * vf * live
    g_od = -(ga3 * alpha * trans)
    g_alpha = ga3 * trans
    # the sum of g_od over the ray's slots after j
    n = g_od.shape[0]
    csum = torch.cat([g_od.new_zeros(1, dtype=torch.float64),
                      torch.cumsum(g_od.double(), dim=0)])
    ends = (offsets + counts).clamp(max=n)[safe]
    pos = torch.arange(n, device=g_od.device)
    suffix = torch.where(ends > pos, csum[ends] - csum[1:], 0.0).to(
        sigma.dtype)
    g_sdt = suffix + g_alpha * e
    if keep is not None:
        g_sdt = g_sdt * keep
    g_x = torch.where(clamp_passes, g_sdt, 0.0)
    return g_x * vf * dt, w[:, None] * gc


# ---------------------------------------------------------------------------
# the kernels


def _library():
    global _lib
    if _lib is None:
        from . import _cuda_build

        _lib = _cuda_build.library()
    return _lib


def _check(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays):
    """The kernels' argument checks; returns the working dtype."""
    n = dt.shape[0]
    dtype = sigma.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sigma must be float32 or float64, got {dtype}")
    slots = [sigma, dt, ray_idx] + ([] if t_mid is None else [t_mid])
    if any(t.shape != (n,) for t in slots):
        raise ValueError(f"expected sigma, dt, ray_idx (and t_mid) of "
                         f"({n},), got {[tuple(t.shape) for t in slots]}")
    if offsets.shape != (n_rays,) or counts.shape != (n_rays,) \
            or n_rays < 1 or n < 1:
        raise ValueError(f"expected offsets and counts of ({n_rays},) and at "
                         f"least one ray and one slot")
    if any(t.dtype != torch.float32 for t in slots[3:] + [dt]):
        raise TypeError("t_mid and dt must be float32")
    if not all(t.dtype == torch.int64 for t in (ray_idx, offsets, counts)):
        raise TypeError("ray_idx, offsets and counts must be int64")
    tensors = slots + [offsets, counts]
    if rgb is not None:
        if t_mid is None:
            raise ValueError("the shading call needs t_mid")
        if rgb.dim() != 2 or rgb.shape[0] != n \
                or not 1 <= rgb.shape[1] <= MAX_CHANNELS:
            raise ValueError(f"expected rgb of ({n}, 1-{MAX_CHANNELS}), got "
                             f"{tuple(rgb.shape)}")
        if rgb.dtype != dtype:
            raise TypeError(f"rgb is {rgb.dtype}, sigma {dtype}")
        tensors.append(rgb)
    if any(t.device != sigma.device for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")
    return dtype


def _common(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
            early_stop_eps, alpha_thre):
    """The arguments both entry points share, up to the stream."""
    return (int(sigma.dtype == torch.float64), sigma.data_ptr(),
            None if rgb is None else rgb.data_ptr(),
            0 if rgb is None else rgb.shape[1],
            None if t_mid is None else t_mid.data_ptr(), dt.data_ptr(),
            ray_idx.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
            dt.shape[0], n_rays,
            float(early_stop_eps), float(alpha_thre))


def composite_forward(sigma, rgb, t_mid, dt, ray_idx, offsets, counts,
                      n_rays, early_stop_eps, alpha_thre, save_trans=False,
                      want_live=False):
    """The forward kernel (CUDA tensors only; rgb and t_mid None for the
    density-only call). Returns (colors, opacities, depths, live counts,
    trans or None, live or None); colors, opacities and depths are None
    without rgb."""
    global FORWARD_LAUNCHES
    if not sigma.is_cuda:
        raise ValueError(f"the composite kernel takes CUDA tensors, got "
                         f"{sigma.device}")
    n_rays = int(n_rays)
    dtype = _check(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays)
    device, n = sigma.device, dt.shape[0]

    def empty(*shape, dtype=dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if rgb is not None:
        colors, opacities, depths = (empty(n_rays, rgb.shape[1]),
                                     empty(n_rays), empty(n_rays))
    else:
        colors = opacities = depths = None
    live_counts = empty(n_rays, dtype=torch.int64)
    trans = empty(n) if save_trans else None
    live = empty(n, dtype=torch.bool) if want_live else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        err = _library().composite_fwd(
            *_common(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
                     early_stop_eps, alpha_thre),
            ptr(colors), ptr(opacities), ptr(depths), live_counts.data_ptr(),
            ptr(trans), ptr(live),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd failed: CUDA error {err}")
    FORWARD_LAUNCHES += 1
    return colors, opacities, depths, live_counts, trans, live


def composite_backward(sigma, rgb, t_mid, dt, ray_idx, offsets, counts,
                       n_rays, early_stop_eps, alpha_thre, trans, g_colors,
                       g_opacities, g_depths):
    """The backward kernel (CUDA tensors only): (the cotangent of sigma
    (n,), of rgb (n, ch)) from the forward's inputs, its trans and the
    outputs' cotangents."""
    global BACKWARD_LAUNCHES
    if not sigma.is_cuda:
        raise ValueError(f"the composite kernel takes CUDA tensors, got "
                         f"{sigma.device}")
    n_rays = int(n_rays)
    dtype = _check(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays)
    ch = rgb.shape[1]
    cotangents = [g.to(dtype).contiguous() for g in (g_colors, g_opacities,
                                                     g_depths)]
    if cotangents[0].shape != (n_rays, ch) \
            or any(g.shape != (n_rays,) for g in cotangents[1:]) \
            or trans.shape != t_mid.shape or trans.dtype != dtype \
            or not trans.is_contiguous():
        raise ValueError("cotangents or trans of the wrong shape or type")
    n = t_mid.shape[0]
    g_sigma = torch.empty(n, dtype=dtype, device=sigma.device)
    g_rgb = torch.empty((n, ch), dtype=dtype, device=sigma.device)
    with torch.cuda.device(sigma.device):
        err = _library().composite_bwd(
            *_common(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
                     early_stop_eps, alpha_thre),
            trans.data_ptr(), *(g.data_ptr() for g in cotangents),
            g_sigma.data_ptr(), g_rgb.data_ptr(),
            torch.cuda.current_stream(sigma.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    return g_sigma, g_rgb


class _CompositeKernels(torch.autograd.Function):
    """The kernels as an autograd function: the forward saves T a slot, the
    backward reads it."""

    @staticmethod
    def forward(ctx, sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
                early_stop_eps, alpha_thre):
        colors, opacities, depths, live_counts, trans, _ = composite_forward(
            sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
            early_stop_eps, alpha_thre, save_trans=True)
        ctx.save_for_backward(sigma, rgb, t_mid, dt, ray_idx, offsets,
                              counts, trans)
        ctx.args = (n_rays, early_stop_eps, alpha_thre)
        ctx.mark_non_differentiable(live_counts)
        return colors, opacities, depths, live_counts

    @staticmethod
    def backward(ctx, g_colors, g_opacities, g_depths, _):
        sigma, rgb, t_mid, dt, ray_idx, offsets, counts, trans = \
            ctx.saved_tensors
        n_rays, early_stop_eps, alpha_thre = ctx.args
        g_sigma, g_rgb = composite_backward(
            sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
            early_stop_eps, alpha_thre, trans, g_colors, g_opacities,
            g_depths)
        return (g_sigma, g_rgb) + (None,) * 8


def composite(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
              early_stop_eps, alpha_thre):
    """(colors (R, ch), opacities (R,), depths (R,), live samples per ray
    (R,) int64); see the module docstring."""
    args = (sigma, rgb, t_mid, dt, ray_idx, offsets, counts, int(n_rays),
            early_stop_eps, alpha_thre)
    if sigma.is_cuda:
        if torch.is_grad_enabled() and (sigma.requires_grad
                                        or rgb.requires_grad):
            return _CompositeKernels.apply(*args)
        return composite_forward(*args)[:4]
    if sigma.device.type != "cpu":
        raise ValueError(f"unsupported device {sigma.device}")
    return composite_reference(*args)


@torch.no_grad()
def live_mask(sigma, dt, ray_idx, offsets, counts, n_rays, early_stop_eps,
              alpha_thre):
    """(live (n,) bool: the valid slots whose exclusive transmittance
    exceeds early_stop_eps, their count per ray (R,) int64)."""
    if sigma.is_cuda:
        _, _, _, live_counts, _, live = composite_forward(
            sigma, None, None, dt, ray_idx, offsets, counts, n_rays,
            early_stop_eps, alpha_thre, want_live=True)
        return live, live_counts
    if sigma.device.type != "cpu":
        raise ValueError(f"unsupported device {sigma.device}")
    return live_mask_reference(sigma, dt, ray_idx, offsets, counts,
                               int(n_rays), early_stop_eps, alpha_thre)
