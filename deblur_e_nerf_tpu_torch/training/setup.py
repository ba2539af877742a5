"""Model assembly from a dataset directory and a config (counterpart of
deblur_e_nerf_tpu/training/setup.py)."""

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..data import camera_poses as camera_poses_data
from ..data import events as events_data
from ..models import (event_gen, nerf_model, pixel_bandwidth,
                      trajectory as trajectory_lib)
from . import step as step_lib


class ModelBundle(NamedTuple):
    consts: Dict            # non-learnable tensors
    static_config: Any      # step_lib.StaticConfig
    loss_config: Any
    camera_calibration: Dict


def build(config, dataset_directory=None, sample_budget=None, device=None,
          field_chunk=0):
    """Build (ModelBundle, TrainParams) on `device` (a torch.device).

    sample_budget defaults to train_eff_ray_sample_batch_size x S (the
    filter's it_sample_size, 1 with the filter off) x the number of render
    slices (2 per enabled loss term) x data.train_sample_budget_margin.
    Weights are drawn from a generator seeded with config.seed.
    `field_chunk` > 0 runs the training render's field that many samples
    at a time (models/renderer.py).
    """
    mc = config.model
    pb_enabled = bool(mc.pixel_bandwidth.enable)
    S = int(mc.pixel_bandwidth.get("it_sample_size", 1))
    root = dataset_directory or config.data.dataset_directory
    calib = dict(np.load(f"{root}/camera_calibration.npz",
                         allow_pickle=False))
    camera_poses = camera_poses_data.load_camera_poses(root)
    bayer = (str(calib[events_data.BAYER_PATTERN_KEY])
             != events_data.NULL_BAYER_PATTERN)
    radiance_dim = 3 if bayer else 1

    if sample_budget is None:
        slices = (2 * (float(config.loss.weight.log_intensity_diff) > 0)
                  + 2 * (float(config.loss.weight.log_intensity_tv) > 0))
        sample_budget = int(
            int(config.data.train_eff_ray_sample_batch_size)
            * (S if pb_enabled else 1) * max(slices, 1)
            * float(config.data.get("train_sample_budget_margin", 1.0)))

    generator = torch.Generator(device=device)
    generator.manual_seed(int(config.get("seed") or 0))
    render_bkgd = "parameter" if config.data.alpha_over_white_bg else None
    model = nerf_model.build(
        mc.nerf, camera_poses["T_wc_position"], radiance_dim, render_bkgd,
        sample_budget, field_chunk=field_chunk, generator=generator,
        device=device)

    ct_params, ct_consts = event_gen.init_contrast_threshold(
        calib, bool(mc.contrast_threshold.parameterize_mean_ct),
        device=device)
    max_rp = events_data.load_max_refractory_period(root)
    rp_params, rp_consts = event_gen.init_refractory_period(
        calib, max_rp, device=device)
    consts = {
        "contrast_threshold": ct_consts,
        "refractory_period": rp_consts,
        "trajectory": trajectory_lib.make_trajectory(camera_poses, device),
        "train_intrinsics_inv": torch.as_tensor(
            np.linalg.inv(calib[events_data.INTRINSICS_KEY]),
            dtype=torch.float32, device=device),
    }
    pb_params = None
    if pb_enabled:
        pb_params, consts["pixel_bandwidth"] = (
            pixel_bandwidth.init_pixel_bandwidth(
                calib, min_ts=int(camera_poses["T_wc_timestamp"].min()),
                f_c_dominant_min=float(mc.pixel_bandwidth.f_c_dominant_min),
                target_cumprob_max_sample_lifetime=float(
                    mc.pixel_bandwidth.target_cumprob.max_sample_lifetime),
                device=device))
    params = step_lib.TrainParams(model, ct_params, rp_params, pb_params)
    static_config = step_lib.StaticConfig(
        pixel_bandwidth_enabled=pb_enabled,
        it_sample_size=S,
        has_bayer=bayer,
        min_modeled_intensity=float(mc.min_modeled_intensity),
        loss_weight_diff=float(config.loss.weight.log_intensity_diff),
        loss_weight_tv=float(config.loss.weight.log_intensity_tv),
        loss_error_fn_diff=str(config.loss.error_fn.log_intensity_diff),
        loss_error_fn_tv=str(config.loss.error_fn.log_intensity_tv),
        loss_normalize_diff=bool(config.loss.normalize.log_intensity_diff),
        loss_normalize_tv=bool(config.loss.normalize.log_intensity_tv),
        loss_weight_sparsity=float(
            config.loss.weight.get("density_sparsity", 0.0)),
        sparsity_samples=int(config.loss.get("density_sparsity_samples",
                                             4096)),
        sparsity_targeted_fraction=float(
            config.loss.get("density_sparsity_targeted_fraction", 0.5)),
    )
    bundle = ModelBundle(consts=consts, static_config=static_config,
                         loss_config=config.loss, camera_calibration=calib)
    return bundle, params
