"""Evaluation (counterpart of deblur_e_nerf_tpu/training/evaluation.py):
full-image rendering + log-affine / offset-gamma correction + metrics +
artifacts.

The image render runs on the model's device, chunk by chunk, through the
port's eval render (models/renderer.py `render_rays_eval`): each chunk of
`test_chunk_size` rays marches into a worst-case buffer and runs the field
only on its filled slots, `field_chunk` samples per call, so every field
call runs the hash encode's kernels once per level. With the occlusion
prepass (`eval_prepass_div`, the config's
model.nerf.eval_occlusion_prepass_div, else the training divisor), a
density pass over the filled slots culls each ray's dead suffix first and
the field runs on the survivors only. Everything downstream
(the float64 least-squares affine correction, the GN/LM black-level
refinement, L1/PSNR/SSIM, the correction-error and prediction files) runs
on the host in numpy, as in the JAX package; LPIPS runs on the device the
evaluator is given.

Differences from the JAX package:
  - the eval render configuration resets the training `block_budget` and
    `superblock_budget` both (the JAX package keeps `superblock_budget`),
    and any masked ray that a budget truncates is reported, with or
    without an occlusion prepass (the JAX package reports it only with
    one); the prepass itself raises (ROADMAP Queue B 6);
  - no TensorBoard image logs: the port's log is scalar JSONL.
"""

import os

import numpy as np
import torch

from ..data import image_io
from ..data import posed_images as posed_images_data
from ..models import nerf_model, offset_gamma
from . import metrics as metrics_lib

CORRECTION_ERRORS_FOLDER_NAME = "correction-errors"
PREDICTIONS_FOLDER_NAME = "predictions"
PREDICTION_BIT_DEPTH = 8
DEFAULT_FIELD_CHUNK = 1 << 20


def make_render_image_fn(model, eval_sample_budget=None,
                         field_chunk=DEFAULT_FIELD_CHUNK,
                         eval_prepass_div=None):
    """Build a chunked full-image renderer for `model` (a NeRFModel).

    Returns render_image(occ_state, intrinsics_inv (3, 3), pixel_pos
    (H, W, 2), T_wc_position (3,), T_wc_orientation (3, 3)) -> intensity
    image ([C,] H, W) float32 on the model's device, without
    min_modeled_intensity (the caller adds it). `render_image.stats` holds
    the totals of the last call (ray chunks, marched samples, live samples
    the field ran on after the prepass, density-pass and field calls,
    truncated rays) and its marched samples per pixel ("counts", (H*W,) on
    the device).
    """
    chunk = model.test_chunk_size
    rc = nerf_model.eval_render_config(model, eval_sample_budget,
                                       field_chunk, eval_prepass_div)

    @torch.no_grad()
    def render_image(occ_state, intrinsics_inv, pixel_pos, T_wc_position,
                     T_wc_orientation):
        H, W = pixel_pos.shape[:2]
        device = occ_state.binary.device
        flat_pix = pixel_pos.reshape(-1, 2).to(device, torch.float32)
        n = H * W
        pos = T_wc_position.to(device, torch.float32).expand(n, 3)
        orient = T_wc_orientation.to(device, torch.float32).expand(n, 3, 3)
        rays_o, rays_d = nerf_model.pixel_params_to_ray(
            intrinsics_inv.to(device, torch.float32), flat_pix, pos, orient)
        n_pad = -(-n // chunk) * chunk
        pad = n_pad - n
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
            rays_d = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
        mask = torch.arange(n_pad, device=device) < n
        outs, counts = [], []
        stats = {"ray_chunks": 0, "marched_samples": 0, "live_samples": 0,
                 "density_chunks": 0, "field_chunks": 0, "truncated_rays": 0}
        for i in range(0, n_pad, chunk):
            out = nerf_model.render_eval(
                model, occ_state, rays_o[i:i + chunk], rays_d[i:i + chunk],
                mask[i:i + chunk], rc)
            outs.append(out["radiance"])
            counts.append(out["counts"])
            stats["ray_chunks"] += 1
            stats["marched_samples"] += out["num_marched_samples"]
            stats["live_samples"] += out["num_live_samples"]
            stats["density_chunks"] += out["num_density_chunks"]
            stats["field_chunks"] += out["num_field_chunks"]
            stats["truncated_rays"] += out["num_truncated"]
        stats["counts"] = torch.cat(counts)[:n]  # marched samples per ray
        render_image.stats = stats
        if stats["truncated_rays"] and rc.prepass_div:
            print(f"WARNING: eval prepass truncated "
                  f"{stats['truncated_rays']} rays (live demand exceeded "
                  f"sample_budget/{rc.prepass_div}); raise the budget or "
                  "lower eval_occlusion_prepass_div", flush=True)
        elif stats["truncated_rays"]:
            print(f"WARNING: eval render truncated {stats['truncated_rays']} "
                  f"rays (demand exceeded the eval sample budget "
                  f"{rc.sample_budget} or a coarse budget); raise the "
                  "budget", flush=True)
        img = torch.cat(outs)[:n].reshape(H, W, -1)
        if img.shape[-1] == 1:
            return img[..., 0]  # (H, W)
        return img.permute(2, 0, 1)  # (C, H, W)

    render_image.render_config = rc
    render_image.stats = {}
    return render_image


def affine_log_correction(pred_log, target_log,
                          is_eff_per_channel_log_it_scale):
    """Least-squares affine correction of log intensities in float64.

    Args:
        pred_log, target_log: (B, C, H, W) float64.
    Returns:
        corrected_pred_log (B, C, H, W), intensity_gamma (1/C,),
        intensity_scale (1/C,)
    """
    B, C, H, W = pred_log.shape
    if is_eff_per_channel_log_it_scale:
        X = pred_log.transpose(1, 0, 2, 3).reshape(C, -1)  # (C, BHW)
        Y = target_log.transpose(1, 0, 2, 3).reshape(C, -1)
        corrected = np.empty_like(X)
        gamma = np.empty(C)
        scale = np.empty(C)
        for c in range(C):
            A = np.stack([X[c], np.ones_like(X[c])], axis=1)
            beta, *_ = np.linalg.lstsq(A, Y[c], rcond=None)
            corrected[c] = A @ beta
            gamma[c] = beta[0]
            scale[c] = np.exp(beta[1])
        corrected = corrected.reshape(C, B, H, W).transpose(1, 0, 2, 3)
        return corrected, gamma, scale
    # shared gamma, per-channel offsets
    N = B * H * W
    X = np.zeros((C * N, 1 + C))
    x_flat = pred_log.transpose(1, 0, 2, 3).reshape(C, N)
    y_flat = target_log.transpose(1, 0, 2, 3).reshape(C, N)
    for c in range(C):
        X[c * N:(c + 1) * N, 0] = x_flat[c]
        X[c * N:(c + 1) * N, 1 + c] = 1.0
    beta, *_ = np.linalg.lstsq(X, y_flat.reshape(-1), rcond=None)
    corrected = (X @ beta).reshape(C, B, H, W).transpose(1, 0, 2, 3)
    gamma = beta[:1]
    scale = np.exp(beta[1:])
    return corrected, gamma, scale


class Evaluator:
    """Carries warm-started correction parameters across eval epochs."""

    def __init__(self, correction_config, has_bayer, log_dir=None,
                 save_pred_intensity_img=False, device="cpu"):
        self.config = correction_config
        self.has_bayer = has_bayer
        self.log_dir = log_dir
        self.save_pred = save_pred_intensity_img
        self.device = device  # LPIPS's
        radiance_dim = 3 if has_bayer else 1
        self.is_eff_per_channel = (
            not has_bayer or bool(correction_config.per_channel_log_it_scale)
        )
        c = radiance_dim if self.is_eff_per_channel else 1
        self.init_scale = np.ones((radiance_dim, 1, 1, 1), np.float64)
        self.init_gamma = np.ones((c, 1, 1, 1), np.float64)
        self.init_offset = np.zeros((radiance_dim, 1, 1, 1), np.float64)

    def epoch_end(self, outputs, min_normalized_pixel_value,
                  max_normalized_pixel_value, epoch=0,
                  sanity_checking=False, lpips_net="alex",
                  lpips_weights_path=None):
        """Full epoch-end pipeline; `outputs` is a list of dicts with
        sample_id, pred_intensity_img, target_intensity_img,
        exposure_time, gain (host numpy). Returns the metrics dict."""
        sample_ids = [
            posed_images_data.sample_id_to_str(o["sample_id"])
            for o in outputs
        ]
        pred = np.stack([np.asarray(o["pred_intensity_img"], np.float64)
                         for o in outputs])
        target = np.stack([np.asarray(o["target_intensity_img"], np.float64)
                           for o in outputs])
        exposure = np.asarray(
            [float(o.get("exposure_time", 1)) for o in outputs])
        gain = np.asarray([float(o.get("gain", 1.0)) for o in outputs])

        if pred.ndim == 3:  # monochrome -> (B, 1, H, W)
            pred = pred[:, None]
            target = target[:, None]
        B, C, H, W = pred.shape

        gep = (gain * exposure).reshape(B, 1, 1, 1)
        normalized_gep = gep / gep.mean()
        log_gep = np.log(normalized_gep)

        pred_log = np.log(pred)
        target_log = np.log(target) - log_gep

        corrected_log, gamma, scale = affine_log_correction(
            pred_log, target_log, self.is_eff_per_channel)

        if not self.config.black_level_offset:
            pred_img = np.exp(corrected_log + log_gep)
            target_img = np.exp(target_log + log_gep)
        else:
            pred_int = np.exp(corrected_log)[..., None]  # (B,C,H,W,1)
            target_int = target[..., None]
            correction = offset_gamma.OffsetGammaCorrection(
                normalized_gep[..., None], self.init_scale,
                self.init_gamma, self.init_offset)
            errors = offset_gamma.optimize(
                correction, pred_int, target_int,
                algo=self.config.optimizer.algo,
                max_steps=int(self.config.optimizer.max_steps))
            if not sanity_checking:
                self.init_scale = correction.scale.copy()
                self.init_gamma = correction.gamma.copy()
                self.init_offset = correction.offset.copy()
            pred_img = correction(pred_int)[..., 0]
            target_img = target
            if self.log_dir is not None:
                folder = os.path.join(self.log_dir,
                                      CORRECTION_ERRORS_FOLDER_NAME)
                os.makedirs(folder, exist_ok=True)
                np.savetxt(os.path.join(folder, f"{epoch}.csv"), errors,
                           fmt="%.14f")

        per_image = [
            metrics_lib.compute_all(
                pred_img[i], target_img[i], min_normalized_pixel_value,
                max_normalized_pixel_value, lpips_net, lpips_weights_path,
                self.device)
            for i in range(B)
        ]
        metric = {k: float(np.mean([m[k] for m in per_image]))
                  for k in per_image[0]}
        if self.save_pred and self.log_dir is not None:
            self._save_predictions(sample_ids, pred_img,
                                   min_normalized_pixel_value,
                                   max_normalized_pixel_value)
        return metric

    def _save_predictions(self, sample_ids, pred_img, min_val, max_val):
        folder = os.path.join(self.log_dir, PREDICTIONS_FOLDER_NAME)
        os.makedirs(folder, exist_ok=True)
        max_pixel = 2 ** PREDICTION_BIT_DEPTH - 1
        norm = np.clip((pred_img - min_val) / (max_val - min_val), 0, 1)
        quantized = np.round(max_pixel * norm).astype(np.uint8)
        imgs = quantized.transpose(0, 2, 3, 1)  # (B, H, W, C)
        for sid, img in zip(sample_ids, imgs):
            if img.shape[-1] == 3:
                img = img[..., ::-1]  # RGB -> OpenCV's BGR file order
            image_io.imwrite(os.path.join(folder, sid + ".png"), img)
