"""Training losses: log-intensity difference and temporal total variation
(counterpart of deblur_e_nerf_tpu/training/loss.py), as masked means."""

import torch

LOSS_NAMES = ("log_intensity_diff", "log_intensity_tv")


def l1(pred, target):
    return torch.abs(pred - target)


def huber(pred, target, delta=1.0):
    err = torch.abs(pred - target)
    return torch.where(err <= delta, 0.5 * torch.square(err),
                       delta * (err - 0.5 * delta))


ERROR_FNS = {"l1": l1, "huber": huber}


def masked_mean(values, mask, count=None):
    """sum(values * mask) / max(count, 1); `count` defaults to the mask's
    own count (a data-parallel rank passes the global one)."""
    denom = torch.clamp(mask.sum() if count is None else count, min=1)
    return torch.sum(values * mask) / denom


def compute(loss_config, event, diff, subdiff, mean_contrast_threshold,
            counts=None):
    """Per-term mean losses (unweighted).

    event: log_intensity_diff and dt (f32 ns, end - (start + tau));
    diff: log_intensity_diff, ts_diff, is_valid (or None);
    subdiff: log_intensity_diff, is_valid (or None);
    counts: optional {term name: its mean's denominator} (default: the
    term's own mask count).
    """
    counts = counts or {}
    out = {}
    log_intensity_grad = event["log_intensity_diff"] / event["dt"].to(
        event["log_intensity_diff"].dtype)
    if loss_config.weight.log_intensity_diff > 0:
        err_fn = ERROR_FNS[loss_config.error_fn.log_intensity_diff]
        norm = (mean_contrast_threshold
                if loss_config.normalize.log_intensity_diff else 1.0)
        target = diff["ts_diff"].to(log_intensity_grad.dtype) \
            * log_intensity_grad / norm
        err = err_fn(diff["log_intensity_diff"] / norm, target)
        out["log_intensity_diff"] = masked_mean(
            err, diff["is_valid"], counts.get("log_intensity_diff"))
    if loss_config.weight.log_intensity_tv > 0:
        err_fn = ERROR_FNS[loss_config.error_fn.log_intensity_tv]
        norm = (mean_contrast_threshold
                if loss_config.normalize.log_intensity_tv else 1.0)
        err = err_fn(subdiff["log_intensity_diff"] / norm,
                     torch.zeros_like(subdiff["log_intensity_diff"]))
        out["log_intensity_tv"] = masked_mean(
            err, subdiff["is_valid"], counts.get("log_intensity_tv"))
    return out
