"""NeRF model assembly (counterpart of deblur_e_nerf_tpu/models/nerf_model.py):
resolves `auto` aabb and step size, builds the NGP or vanilla-NeRF field and
the render configuration (with the occlusion prepass and the field chunk),
owns the learnable softplus background, and exposes density,
occupancy-update, ray-generation, render and eval-render entry points.
"""

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..ops import activations
from . import contraction as contraction_lib
from . import fields, occupancy, renderer

NUM_DIM = 3
MAX_NUM_SAMPLES_PER_RAY = 1024  # bounds `render_step_size: auto`


class NeRFModel(nn.Module):
    """Field + optional raw background parameter + static configuration."""

    def __init__(self, field, render_config, occ_grid_config,
                 render_bkgd_mode, radiance_dim, test_chunk_size,
                 curriculum=None, table_decay=None, device=None):
        super().__init__()
        self.field = field
        self.render_config = render_config
        self.occ_grid_config = occ_grid_config
        self.render_bkgd_mode = render_bkgd_mode
        self.radiance_dim = radiance_dim
        self.test_chunk_size = test_chunk_size
        # (start_levels, steps_per_level, max_levels) or None
        self.curriculum = curriculum
        # (start_table_row, weight) decoupled fine-table decay, or None
        self.table_decay = table_decay
        if render_bkgd_mode == "parameter":
            # softplus-parametrized positive background, initialized to 1
            self.render_bkgd_raw = nn.Parameter(torch.full(
                (radiance_dim,),
                float(activations.softplus_inverse(torch.tensor(1.0))),
                dtype=torch.float32, device=device))


def resolve_aabb(nerf_config, camera_positions):
    if nerf_config.aabb == "auto":
        lo = np.asarray(camera_positions).min(axis=0)
        hi = np.asarray(camera_positions).max(axis=0)
        return tuple(np.concatenate([lo, hi]).tolist())
    return tuple(float(v) for v in nerf_config.aabb)


def resolve_render_step_size(nerf_config, aabb):
    if nerf_config.render_step_size == "auto":
        extent = np.asarray(aabb[NUM_DIM:]) - np.asarray(aabb[:NUM_DIM])
        return float(math.sqrt(NUM_DIM) * float(extent.max())
                     / MAX_NUM_SAMPLES_PER_RAY)
    return float(nerf_config.render_step_size)


def _ngp_field(nerf_config, aabb, contraction_type, radiance_dim,
               generator, device):
    arch = nerf_config.ngp
    pe = arch.pos_encoding
    return fields.NGPField(
        aabb=aabb, contraction_type=contraction_type,
        radiance_dim=radiance_dim,
        pos_otype=pe.otype, n_levels=pe.n_levels,
        n_features_per_level=pe.n_features_per_level,
        log2_hashmap_size=pe.get("log2_hashmap_size", 19),
        base_resolution=pe.base_resolution,
        per_level_scale=pe.per_level_scale,
        cellhash_min_load=float(pe.get("cellhash_min_load") or 8.0),
        grid_compute_dtype=str(pe.get("compute_dtype") or "float32"),
        sh_degree=arch.dir_encoding.degree,
        base_hidden_activation=arch.mlp_base.hidden_activation,
        density_activation=arch.mlp_base.density_activation,
        base_n_neurons=arch.mlp_base.n_neurons,
        base_n_hidden_layers=arch.mlp_base.n_hidden_layers,
        geo_feat_dim=arch.mlp_base.geo_feat_dim,
        base_weight_norm=arch.mlp_base.weight_norm,
        head_hidden_activation=arch.mlp_head.hidden_activation,
        radiance_activation=arch.mlp_head.radiance_activation,
        head_n_neurons=arch.mlp_head.n_neurons,
        head_n_hidden_layers=arch.mlp_head.n_hidden_layers,
        head_weight_norm=arch.mlp_head.weight_norm,
        generator=generator, device=device,
    )


def _vanilla_field(nerf_config, aabb, contraction_type, radiance_dim,
                   generator, device):
    arch = nerf_config.mlp
    return fields.VanillaNeRFField(
        aabb=aabb, contraction_type=contraction_type,
        radiance_dim=radiance_dim, net_depth=arch.net_depth,
        net_width=arch.net_width, skip_layer=arch.skip_layer,
        net_depth_condition=arch.net_depth_condition,
        net_width_condition=arch.net_width_condition,
        hidden_activation=arch.hidden_activation,
        density_activation=arch.density_activation,
        radiance_activation=arch.radiance_activation,
        pos_encoder_max_deg=arch.pos_encoder_max_deg,
        view_encoder_max_deg=arch.view_encoder_max_deg,
        weight_norm=arch.weight_norm, generator=generator, device=device,
    )


FIELDS = {"ngp": _ngp_field, "mlp": _vanilla_field}


def build(nerf_config, camera_positions, radiance_dim, render_bkgd,
          sample_budget, field_chunk=0, stratified=True, generator=None,
          device=None):
    """Build the NeRF module from a reference-schema nerf config; weights
    are drawn from `generator`. `field_chunk` > 0 runs the training
    render's field that many samples at a time (renderer.py)."""
    if nerf_config.arch not in FIELDS:
        raise ValueError(f"unknown nerf arch {nerf_config.arch!r} (known: "
                         f"{sorted(FIELDS)})")
    aabb = resolve_aabb(nerf_config, camera_positions)
    render_step_size = resolve_render_step_size(nerf_config, aabb)
    contraction_type = contraction_lib.ContractionType(
        nerf_config.contraction_type)
    field = FIELDS[nerf_config.arch](
        nerf_config, aabb, contraction_type, radiance_dim, generator, device)
    render_config = renderer.RenderConfig(
        aabb=aabb, contraction_type=contraction_type,
        grid_resolution=int(nerf_config.occ_grid.resolution),
        near_plane=nerf_config.get("near_plane"),
        far_plane=nerf_config.get("far_plane"),
        render_step_size=render_step_size,
        cone_angle=float(nerf_config.cone_angle),
        early_stop_eps=float(nerf_config.early_stop_eps),
        alpha_thre=float(nerf_config.alpha_thre),
        stratified=stratified,
        max_samples_per_ray=MAX_NUM_SAMPLES_PER_RAY,
        sample_budget=int(sample_budget),
        block_budget=(int(nerf_config.block_budget)
                      if nerf_config.get("block_budget") else None),
        superblock_budget=(int(nerf_config.superblock_budget)
                           if nerf_config.get("superblock_budget")
                           is not None else None),
        field_chunk=int(field_chunk),
        prepass_div=int(nerf_config.get("occlusion_prepass_div") or 0),
    )
    if render_bkgd not in (None, "parameter"):
        raise NotImplementedError(
            f"render_bkgd {render_bkgd!r}: the port takes None or "
            "'parameter', the modes setup.build derives from "
            "data.alpha_over_white_bg")
    bkgd_mode = render_bkgd

    curriculum = None
    table_decay = None
    if nerf_config.arch == "ngp":
        pe = nerf_config.ngp.pos_encoding
        cur_cfg = pe.get("curriculum")
        if cur_cfg and bool(cur_cfg.get("enable", True)):
            curriculum = (int(cur_cfg.get("start_levels", 5)),
                          int(cur_cfg.get("steps_per_level", 500)),
                          int(cur_cfg.get("max_levels") or int(pe.n_levels)))
        decay_w = pe.get("fine_table_decay")
        if decay_w:
            start_level = min(
                int(pe.get("fine_table_decay_start_level", 8)),
                len(field.levels) - 1)
            table_decay = (int(field.levels[start_level][2]), float(decay_w))
    return NeRFModel(
        field, render_config, nerf_config.occ_grid, bkgd_mode, radiance_dim,
        int(nerf_config.test_chunk_size), curriculum=curriculum,
        table_decay=table_decay, device=device,
    )


def init_params(model, generator=None):
    """Redraw the model's parameters in place from `generator` (the field
    weights as `fields` initializes them, the raw background at
    softplus^-1(1)); `build` already draws them once."""
    model.field.reset_parameters(generator)
    if model.render_bkgd_mode == "parameter":
        with torch.no_grad():
            model.render_bkgd_raw.fill_(
                float(activations.softplus_inverse(torch.tensor(1.0))))
    return model


def render_bkgd_value(model):
    if model.render_bkgd_mode is None:
        return None
    return activations.softplus(model.render_bkgd_raw)


def init_occupancy(model, device):
    return occupancy.init_state(model.render_config.grid_resolution, device)


def level_mask_for_step(model, step, device):
    """(n_levels,) 0/1 curriculum mask for a step count, or None (no
    curriculum; always for the vanilla field, which has no levels)."""
    if model.curriculum is None:
        return None
    start_levels, steps_per_level, max_levels = model.curriculum
    active = min(start_levels + int(step) // steps_per_level, max_levels)
    return (torch.arange(model.field.n_levels, device=device)
            < active).to(torch.float32)


def density_fn(model, x, level_mask=None):
    """The field's density-only call (the prepass's and the occupancy
    update's)."""
    return model.field.density(x, level_mask=level_mask)


def update_occupancy(model, occ_state, step, generator, camera_positions,
                     level_mask=None):
    """One occupancy update at optimizer step `step` (full grid during
    warmup), with draws from `generator`; under a cone angle each
    evaluated cell's step is taken at the distance of one of
    `camera_positions` (the trajectory's, (C, 3))."""
    rc = model.render_config
    cfg = model.occ_grid_config
    warmup = int(step) < int(cfg.warmup_steps)
    draws = occupancy.draw_update(
        generator, rc.grid_resolution, warmup, occ_state.occs.device,
        num_cameras=camera_positions.shape[0] if rc.cone_angle > 0.0 else 0)
    occ_eval = occupancy.make_occ_eval_fn(
        lambda x: density_fn(model, x, level_mask),
        rc.render_step_size, rc.cone_angle, rc.near_plane, rc.far_plane)
    return occupancy.update(
        occ_state, occ_eval, warmup, draws,
        resolution=rc.grid_resolution, aabb=rc.aabb,
        contraction_type=rc.contraction_type,
        occ_thre=float(cfg.occ_thre), ema_decay=float(cfg.ema_decay),
        thre_floor=float(cfg.get("thre_floor", 0.0)),
        max_occupied_fraction=float(cfg.get("max_occupied_fraction", 1.0)),
        thre_rel_max=float(cfg.get("thre_rel_max", 0.0)),
        camera_positions=camera_positions,
    )


def pixel_params_to_ray(intrinsics_inverse, pixel_position, T_wc_position,
                        T_wc_orientation):
    """Unproject pixels (..., 2) to world-space unit rays."""
    ones = torch.ones_like(pixel_position[..., :1])
    homog = torch.cat([pixel_position, ones], dim=-1)[..., None]
    direction = (T_wc_orientation @ (intrinsics_inverse @ homog))[..., 0]
    direction = direction / torch.linalg.norm(direction, dim=-1,
                                              keepdim=True)
    return T_wc_position, direction


def render(model, occ_state, rays_o, rays_d, ray_mask, jitter,
           level_mask=None, prepass=True):
    """Render a flat ray bundle; `jitter` (R,) uniforms for stratified
    sampling. The occlusion prepass runs when the config sets it, unless
    `prepass` is False (the field then runs on the marched buffer)."""
    field = model.field
    field_fn = renderer.SplitField(
        lambda x: field.encode(x, level_mask), field.decode)
    return renderer.render_rays(
        field_fn, occ_state.binary, rays_o, rays_d, ray_mask, jitter,
        model.render_config, render_bkgd=render_bkgd_value(model),
        density_only_fn=((lambda x: density_fn(model, x, level_mask))
                         if prepass else None))


def eval_render_config(model, eval_sample_budget, field_chunk, prepass_div):
    """The eval render's configuration: no jitter, the worst-case budget
    (every ray of a `test_chunk_size` chunk at S_max samples, unless
    `eval_sample_budget` is given, so an eval image never truncates), both
    coarse budgets reset to their defaults for it (the JAX package keeps
    the training `superblock_budget` at eval, which can truncate rays
    there), `field_chunk` samples per field call, and the occlusion
    prepass at `prepass_div` (model.nerf.eval_occlusion_prepass_div; None
    keeps the training divisor, 0 turns it off)."""
    rc = model.render_config
    return dataclasses.replace(
        rc, stratified=False,
        sample_budget=int(eval_sample_budget or model.test_chunk_size
                          * rc.max_samples_per_ray),
        block_budget=None, superblock_budget=None,
        field_chunk=int(field_chunk),
        prepass_div=(rc.prepass_div if prepass_div is None
                     else int(prepass_div)))


def render_eval(model, occ_state, rays_o, rays_d, ray_mask, render_config):
    """Render a flat ray bundle for evaluation (no gradients, no jitter, no
    level mask) under `render_config` (see `eval_render_config`)."""
    return renderer.render_rays_eval(
        model.field, occ_state.binary, rays_o, rays_d, ray_mask,
        render_config, model.radiance_dim,
        render_bkgd=render_bkgd_value(model),
        density_only_fn=lambda x: density_fn(model, x))
