"""Learnable event-generation parameters: contrast thresholds and the
refractory period (counterpart of deblur_e_nerf_tpu/models/event_gen.py).

Raw parameters live in `nn.ParameterDict`s; bijectors (softplus, scaled
shifted sigmoid) apply on read. The refractory logit is float64
(ns-scale precision) and `clamp_refractory_logit` projects it after every
optimizer update so the sigmoid gradient never vanishes.
"""

import warnings

import numpy as np
import torch
from torch import nn

from ..ops import activations

POS_CONTRAST_THRESHOLD_KEY = "pos_contrast_threshold"
NEG_CONTRAST_THRESHOLD_KEY = "neg_contrast_threshold"
REFRACTORY_PERIOD_KEY = "refractory_period"
REDEFINED_CALIBRATED_REFRACTORY_PERIOD_FACTOR = 0.999
MIN_SCALED_SHIFTED_SIGMOID_GRAD_MAGNITUDE = 1e-4


def init_contrast_threshold(camera_calibration, parameterize_mean_ct,
                            device=None):
    """(ParameterDict of raw params, dict of constants)."""
    pos_ct = float(camera_calibration[POS_CONTRAST_THRESHOLD_KEY])
    neg_ct = float(camera_calibration[NEG_CONTRAST_THRESHOLD_KEY])
    p2n = pos_ct / neg_ct
    mean_ct = (pos_ct + neg_ct) / 2
    if not (p2n > 0 and mean_ct > 0):
        raise ValueError(f"invalid contrast thresholds {pos_ct}, {neg_ct}")

    def raw(v):
        return nn.Parameter(activations.softplus_inverse(
            torch.tensor(v, dtype=torch.float32, device=device)))

    params = nn.ParameterDict(
        {"p2n_contrast_threshold_ratio_raw": raw(p2n)})
    consts = {"parameterize_mean_ct": parameterize_mean_ct}
    if parameterize_mean_ct:
        params["mean_contrast_threshold_raw"] = raw(mean_ct)
    else:
        consts["neg_contrast_threshold"] = torch.tensor(
            neg_ct, dtype=torch.float32, device=device)
    return params, consts


def contrast_thresholds(params, consts):
    """Derived (pos, neg, mean) contrast thresholds."""
    p2n = activations.softplus(params["p2n_contrast_threshold_ratio_raw"])
    if consts["parameterize_mean_ct"]:
        mean_ct = activations.softplus(params["mean_contrast_threshold_raw"])
        neg = 2 * mean_ct / (p2n + 1)
        pos = p2n * neg
    else:
        neg = consts["neg_contrast_threshold"]
        pos = p2n * neg
        mean_ct = (pos + neg) / 2
    return pos, neg, mean_ct


def apply_contrast_threshold(params, consts, num_pos, num_neg):
    """Event counts -> effective log-intensity change."""
    pos, neg, _ = contrast_thresholds(params, consts)
    return num_pos * pos - num_neg * neg


def init_refractory_period(camera_calibration, max_refractory_period,
                           device=None):
    """(ParameterDict with the float64 raw logit, dict of constants)."""
    calibrated = float(camera_calibration[REFRACTORY_PERIOD_KEY])
    max_rp = float(max_refractory_period)
    if not (0 <= calibrated < max_rp):
        warnings.warn(
            f"Calibrated refractory period ({calibrated}) >= max possible"
            f" refractory period ({max_rp}); redefining to"
            f" {REDEFINED_CALIBRATED_REFRACTORY_PERIOD_FACTOR} * max.")
        calibrated = REDEFINED_CALIBRATED_REFRACTORY_PERIOD_FACTOR * max_rp
    max_logit_mag = float(np.abs(np.log(
        MIN_SCALED_SHIFTED_SIGMOID_GRAD_MAGNITUDE
        / (1 - MIN_SCALED_SHIFTED_SIGMOID_GRAD_MAGNITUDE))))
    p = np.clip(calibrated / max_rp, 1e-12, 1 - 1e-12)
    raw = max_rp * float(np.log(p / (1 - p)))

    def f64(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    consts = {
        "init_refractory_period": f64(calibrated),
        "max_refractory_period": f64(max_rp),
        "max_scaled_logit_magnitude": f64(max_logit_mag),
    }
    params = nn.ParameterDict({"refractory_period_logit": nn.Parameter(
        clamp_refractory_logit_value(f64(raw), consts))})
    return params, consts


def clamp_refractory_logit_value(raw, consts):
    max_rp = consts["max_refractory_period"]
    limit = consts["max_scaled_logit_magnitude"]
    scaled = raw / max_rp
    # exact no-op when the clamp does not bind
    return torch.where(scaled.abs() > limit,
                       max_rp * torch.clamp(scaled, -limit, limit), raw)


@torch.no_grad()
def clamp_refractory_logit(params, consts):
    """Project the raw logit in place into its non-vanishing-gradient
    band; apply after every optimizer update."""
    logit = params["refractory_period_logit"]
    logit.copy_(clamp_refractory_logit_value(logit, consts))


def refractory_period(params, consts):
    """Scaled-shifted sigmoid read of tau in [0, max_refractory_period)."""
    max_rp = consts["max_refractory_period"]
    return max_rp * torch.sigmoid(params["refractory_period_logit"] / max_rp)
