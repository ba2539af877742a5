"""The training step: event physics -> renders -> loss -> update
(counterpart of deblur_e_nerf_tpu/training/step.py).

All interval endpoints of a step (diff start/end, subdiff start/end) are
rendered as one batch of R*N rays; with the pixel-bandwidth filter on,
each endpoint is S lifetime samples, so one render of S*R*N rays feeds
`pixel_bandwidth.forward_fused`. Timestamps are split: exact int64 ns
bases plus small float32 differentiable deltas (the learnable refractory
shift, the sampled interval offsets), renormalized with a straight-through
round before use.

Every random draw of the step is an input (`draws`): the normalized
interval samples (with the filter on, also the (S-1, N) interval
generator), the stratified-march jitter (one per rendered ray) and the
sparsity-prior cells. `draw_step` makes them from a torch.Generator; tests
hand in the JAX package's draws instead.

Batch layout (capacity N, prefix-active):
  position (N, 2) f32, start_ts (N,) i64, end_ts (N,) i64,
  num_pos (N,) f32, num_neg (N,) f32, [channel_idx (N,) i64], valid (N,) bool
"""

from typing import NamedTuple

import torch
from torch import nn

from ..models import (contraction as contraction_lib, event_gen,
                      nerf_model, occupancy as occupancy_lib,
                      pixel_bandwidth, trajectory as trajectory_lib)
from ..ops import samplers
from ..utils.device import constant
from . import loss as loss_lib


class StaticConfig(NamedTuple):
    pixel_bandwidth_enabled: bool
    it_sample_size: int
    has_bayer: bool
    min_modeled_intensity: float
    loss_weight_diff: float
    loss_weight_tv: float
    loss_error_fn_diff: str
    loss_error_fn_tv: str
    loss_normalize_diff: bool
    loss_normalize_tv: bool
    # density sparsity prior: L1 on per-step opacity at aabb points
    loss_weight_sparsity: float = 0.0
    sparsity_samples: int = 4096
    sparsity_targeted_fraction: float = 0.5


class TrainParams(nn.Module):
    """The trainable parameters, keyed like the JAX package's param tree:
    `nerf`, `contrast_threshold`, `refractory_period` and, with the filter
    on, `pixel_bandwidth`."""

    def __init__(self, nerf, contrast_threshold, refractory_period,
                 pixel_bandwidth=None):
        super().__init__()
        self.nerf = nerf
        self.contrast_threshold = contrast_threshold
        self.refractory_period = refractory_period
        if pixel_bandwidth is not None:
            self.pixel_bandwidth = pixel_bandwidth


def derive_intervals(start_base, start_delta, end_base, normalized,
                     weight_diff, weight_tv):
    """Supervision intervals as deltas relative to `start_base`; returns
    (diff, subdiff) dicts with ts_diff, start_delta, end_delta."""
    gap = torch.clamp(
        (end_base - start_base).to(torch.float32) - start_delta, min=0.0)
    diff = None
    if weight_diff > 0:
        ts_diff = gap * normalized["ts_diff"]
        start = start_delta + normalized["diff_start_ts"] * torch.clamp(
            gap - ts_diff, min=0.0)
        end = torch.minimum(start + ts_diff, start_delta + gap)
        diff = {"ts_diff": ts_diff, "start_delta": start, "end_delta": end}
        tv_start, tv_end = start, end
    else:
        tv_start, tv_end = start_delta, start_delta + gap
    subdiff = None
    if weight_tv > 0:
        ts_sub = (tv_end - tv_start) * normalized["ts_subdiff"]
        start = tv_start + normalized["subdiff_start_ts"] * (
            torch.maximum(tv_end - ts_sub, tv_start) - tv_start)
        end = torch.minimum(start + ts_sub, tv_end)
        subdiff = {"ts_diff": ts_sub, "start_delta": start, "end_delta": end}
    return diff, subdiff


def draw_normalized_samples(n, generator, device, sc=None):
    """ts_diff ~ dirac(1), diff_start_ts ~ U[0,1], ts_subdiff ~
    triangular(mode 0), subdiff_start_ts ~ U[0,1]; with the filter on,
    interval_gen ~ dirac(0.5) of shape (S-1, n)."""
    def u():
        return torch.rand(n, generator=generator, device=device)

    normalized = {
        "ts_diff": samplers.dirac_delta((n,), 1.0, device),
        "diff_start_ts": u(),
        "ts_subdiff": samplers.triangular(u(), mode=0.0),
        "subdiff_start_ts": u(),
    }
    if sc is not None and sc.pixel_bandwidth_enabled:
        normalized["interval_gen"] = samplers.dirac_delta(
            (sc.it_sample_size - 1, n), 0.5, device)
    return normalized


def n_render_slices(sc):
    return 2 * (sc.loss_weight_diff > 0) + 2 * (sc.loss_weight_tv > 0)


def n_rendered_rays(sc, n):
    """Rays of one step's render: R*N, times S with the filter on."""
    s = sc.it_sample_size if sc.pixel_bandwidth_enabled else 1
    return s * n_render_slices(sc) * n


def draw_step(sc, n, occ_state, generator, device):
    """All random draws of one step (see the module docstring)."""
    draws = {
        "normalized": draw_normalized_samples(n, generator, device, sc),
        "jitter": torch.rand(n_rendered_rays(sc, n), generator=generator,
                             device=device),
    }
    if sc.loss_weight_sparsity > 0.0:
        n_tgt = int(round(sc.sparsity_samples
                          * sc.sparsity_targeted_fraction))
        num_cells = occ_state.binary.shape[0]
        draws["sparsity"] = {
            "uniform_cells": torch.randint(
                0, num_cells, (sc.sparsity_samples - n_tgt,),
                generator=generator, device=device),
            "occupied": occupancy_lib.draw_occupied_cells(
                generator, num_cells, n_tgt, device),
            "jitter": torch.rand((sc.sparsity_samples, 3),
                                 generator=generator, device=device),
        }
    return draws


def render_train_pixels(params, consts, occ_state, sc, ts, ts_delta,
                        pixel_position, channel_idx, valid, jitter,
                        level_mask=None, prepass=True):
    """Render the pixels at split timestamps `ts`/`ts_delta` of shape
    ([S,] R*N); per-pixel inputs are (R*N, ...) and broadcast over S.
    Returns (intensity, stats, is_valid, complete), each shaped like
    `ts`."""
    model = params.nerf
    batch_shape = ts.shape
    pos, orient = trajectory_lib.interpolate_pose(
        consts["trajectory"], ts, ts_delta)
    pixel = pixel_position.to(torch.float32).expand(*batch_shape, 2)
    rays_o, rays_d = nerf_model.pixel_params_to_ray(
        consts["train_intrinsics_inv"], pixel, pos, orient)
    mask = valid.expand(batch_shape)
    if len(batch_shape) == 2:
        # Event-major ray order for the S lifetime samples: the march keeps
        # the first samples in ray order when the buffer overflows, so an
        # overflow drops whole events at the tail. The JAX package renders
        # sample-major, where an overflow truncates the last lifetime
        # sample of every event, and `complete` (all over S) then masks
        # every event of the step (ROADMAP Queue C). `jitter` stays in the
        # sample-major order of the JAX package's draws.
        def flat(x):
            return x.transpose(0, 1).reshape(-1, *x.shape[2:])

        def unflat(x):
            return x.reshape(batch_shape[1], batch_shape[0],
                             *x.shape[1:]).transpose(0, 1)
        if jitter is not None:
            jitter = flat(jitter.reshape(batch_shape))
    else:
        def flat(x):
            return x

        def unflat(x):
            return x
    out = nerf_model.render(model, occ_state, flat(rays_o).reshape(-1, 3),
                            flat(rays_d).reshape(-1, 3),
                            flat(mask).reshape(-1), jitter=jitter,
                            level_mask=level_mask, prepass=prepass)
    opacity = unflat(out["opacity"])
    intensity = unflat(out["radiance"]) + sc.min_modeled_intensity
    if sc.has_bayer:
        ch = channel_idx.to(torch.int64).expand(batch_shape)
        intensity = torch.gather(intensity, -1, ch[..., None])[..., 0]
    else:
        intensity = intensity[..., 0]
    if model.render_bkgd_mode is None:
        is_valid = opacity > 0
    else:
        is_valid = torch.ones_like(opacity, dtype=torch.bool)
    # buffer-truncated rays leave the loss through `complete`, which the
    # filter all-reduces over S (is_valid is any-reduced)
    complete = unflat(out["ray_complete"])
    validf = mask.to(torch.float32)
    stats = {
        "mean_ray_occ_rate": loss_lib.masked_mean(
            (opacity > 0).to(torch.float32), validf),
        "ray_truncation_rate": loss_lib.masked_mean(
            (~complete).to(torch.float32), validf),
        "num_rendering_samples": out["num_rendering_samples"],
        # pre-budget demand: the batch-size controller must see it
        "num_marched_samples": out["num_marched_samples"],
        "block_overflow_rate": out["block_overflow_rate"],
        "superblock_overflow_rate": out["superblock_overflow_rate"],
        "prepass_overflow_rate": out["prepass_overflow_rate"],
        "prepass_ran": out["prepass_ran"],
        "num_rays": valid.sum() * (batch_shape[0] if len(batch_shape) == 2
                                   else 1),
    }
    return intensity, stats, is_valid, complete


def _sparsity_prior(params, occ_state, draws, level_mask):
    """Mean per-step opacity 1 - exp(-sigma * step) at uniform and
    occupied-targeted aabb points."""
    model = params.nerf
    rc = model.render_config
    parts = []
    if draws["uniform_cells"].numel():
        parts.append(draws["uniform_cells"].to(torch.int64))
    if draws["occupied"]["u"].numel():
        parts.append(occupancy_lib.sample_occupied_cells(
            occ_state.binary, draws["occupied"]))
    cells = torch.cat(parts)
    res = rc.grid_resolution
    device = cells.device
    coords = occupancy_lib.cell_coords(res, device, cells).to(torch.float32)
    u = (coords + draws["jitter"]) / res
    aabb = constant(rc.aabb, torch.float32, device)
    x = contraction_lib.contract_inv(u, aabb, rc.contraction_type)
    sigma = nerf_model.density_fn(model, x, level_mask)
    return torch.mean(1.0 - torch.exp(-sigma[..., 0] * rc.render_step_size))


def compute_loss(params, consts, occ_state, batch, draws, sc, loss_config,
                 level_mask=None, prepass=True):
    """Forward pass: (scalar loss, metrics dict of tensors). `prepass`
    False renders without the configured occlusion prepass."""
    valid = batch["valid"]
    n = valid.shape[0]
    ct_params = params.contrast_threshold
    ct_consts = consts["contrast_threshold"]
    log_intensity_diff = event_gen.apply_contrast_threshold(
        ct_params, ct_consts, batch["num_pos"].to(torch.float32),
        batch["num_neg"].to(torch.float32))
    start_base = batch["start_ts"]
    end_base = batch["end_ts"]
    tau = event_gen.refractory_period(
        params.refractory_period, consts["refractory_period"]
    ).to(torch.float32)
    start_delta = tau.expand(start_base.shape)
    event = {
        "log_intensity_diff": log_intensity_diff,
        "dt": torch.clamp(
            (end_base - start_base).to(torch.float32) - tau, min=1e-6),
    }
    diff, subdiff = derive_intervals(
        start_base, start_delta, end_base, draws["normalized"],
        sc.loss_weight_diff, sc.loss_weight_tv)

    delta_slices = []
    if diff is not None:
        delta_slices += [diff["start_delta"], diff["end_delta"]]
    if subdiff is not None:
        delta_slices += [subdiff["start_delta"], subdiff["end_delta"]]
    R = len(delta_slices)
    ts_all, delta_all = pixel_bandwidth.split_time(
        start_base.repeat(R), torch.cat(delta_slices))
    channel_idx = batch.get("channel_idx")
    pixel_all = batch["position"].repeat(R, 1)
    channel_all = None if channel_idx is None else channel_idx.repeat(R)
    valid_all = valid.repeat(R)

    def sampling_fn(sample_ts, sample_ts_delta):
        return render_train_pixels(
            params, consts, occ_state, sc, sample_ts, sample_ts_delta,
            pixel_all, channel_all, valid_all, draws.get("jitter"),
            level_mask, prepass)

    if sc.pixel_bandwidth_enabled:
        interval_gen_all = draws["normalized"]["interval_gen"].repeat(1, R)
        log_it_all, aux, _ = pixel_bandwidth.forward_fused(
            params.pixel_bandwidth, consts["pixel_bandwidth"],
            interval_gen_all, ts_all, delta_all, sampling_fn, n)
        stats, is_valid_s, complete_s = aux
        is_valid_all = is_valid_s.any(dim=0)
        # ALL blur samples must be complete: the filtered log intensity
        # integrates every sample, so one truncated render corrupts it
        complete_all = complete_s.all(dim=0)
    else:
        intensity, stats, is_valid_all, complete_all = sampling_fn(
            ts_all, delta_all)
        log_it_all = torch.log(intensity)

    outs = log_it_all.reshape(R, n)
    valids = is_valid_all.reshape(R, n)
    completes = complete_all.reshape(R, n)
    i = 0
    if diff is not None:
        diff["log_intensity_diff"] = outs[i + 1] - outs[i]
        diff["is_valid"] = ((valids[i] | valids[i + 1]) & valid
                            & completes[i] & completes[i + 1])
        i += 2
    if subdiff is not None:
        subdiff["log_intensity_diff"] = outs[i + 1] - outs[i]
        subdiff["is_valid"] = ((valids[i] | valids[i + 1]) & valid
                               & completes[i] & completes[i + 1])

    _, _, mean_ct = event_gen.contrast_thresholds(ct_params, ct_consts)
    mean_losses = loss_lib.compute(loss_config, event, diff, subdiff,
                                   mean_ct)
    weights = {"log_intensity_diff": sc.loss_weight_diff,
               "log_intensity_tv": sc.loss_weight_tv}
    total = sum(v * weights[k] for k, v in mean_losses.items())
    if sc.loss_weight_sparsity > 0.0:
        sparsity = _sparsity_prior(params, occ_state, draws["sparsity"],
                                   level_mask)
        total = total + sc.loss_weight_sparsity * sparsity
        mean_losses = dict(mean_losses, density_sparsity=sparsity)

    num_rays = stats["num_rays"].to(torch.float32)
    marched = stats["num_marched_samples"].to(torch.float32)
    metrics = {
        "loss": total,
        **{f"loss_{k}": v for k, v in mean_losses.items()},
        "mean_num_samples_per_ray": marched / torch.clamp(num_rays, min=1),
        "sample_overflow_rate": (
            marched / float(params.nerf.render_config.sample_budget)),
        "block_overflow_rate": stats["block_overflow_rate"],
        "superblock_overflow_rate": stats["superblock_overflow_rate"],
        "prepass_overflow_rate": stats["prepass_overflow_rate"],
        "prepass_ran": stats["prepass_ran"],
        "mean_ray_occ_rate": stats["mean_ray_occ_rate"],
        "ray_truncation_rate": stats["ray_truncation_rate"],
        "mean_valid_rate": loss_lib.masked_mean(
            (diff or subdiff)["is_valid"].to(torch.float32),
            valid.to(torch.float32)),
        "batch_size": valid.sum(),
        "num_rays": stats["num_rays"],
        "num_marched_samples": stats["num_marched_samples"],
    }
    if "pb_min_abs_weight_sum" in stats:
        metrics["pb_min_abs_weight_sum"] = stats["pb_min_abs_weight_sum"]
    return total, metrics


def make_train_step(params, consts, optimizer, sc, loss_config):
    """Build step_fn(occ_state, batch, draws, level_mask=None,
    prepass=True) -> metrics.

    One micro-step: loss -> backward -> optimizer step (the gradients go
    into the running mean with accumulation; the Adam update is committed
    on the device at an accumulation boundary) -> refractory-logit
    projection, which runs after every micro-step as after each JAX step.
    The optimizer may skip a micro-step whose loss or gradients are not
    finite; `metrics["update_skipped"]` is that decision as a device bool,
    so the step reads nothing back to the host."""

    def step_fn(occ_state, batch, draws, level_mask=None, prepass=True):
        optimizer.zero_grad()
        loss, metrics = compute_loss(params, consts, occ_state, batch,
                                     draws, sc, loss_config, level_mask,
                                     prepass)
        loss.backward()
        taken = optimizer.step(loss)
        event_gen.clamp_refractory_logit(params.refractory_period,
                                         consts["refractory_period"])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["update_skipped"] = ~taken
        return metrics

    return step_fn
