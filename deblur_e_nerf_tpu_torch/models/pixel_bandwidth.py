"""Pixel-bandwidth (motion-blur) model: the 4th-order non-linear
low-pass filter of the event pixel (counterpart of
deblur_e_nerf_tpu/models/pixel_bandwidth.py).

A cascade of a 2nd-order non-linear photoreceptor LPF, a 1st-order
source-follower LPF and a 1st-order differencing-amplifier LPF,
linearized at per-sample steady states, FOH-discretized and collapsed
into per-sample output weights. The differencing-amplifier reset is a
`ResetState` value: the reset render produces it, the other renders of
the step consume it.

Timestamps are split (int64 ns base, float32 differentiable delta), as in
training/step.py; all state-space math is float32.

Six learnable softplus-positive parameters (`init_pixel_bandwidth` makes
them an `nn.ParameterDict` keyed like the JAX parameter tree):
tau_mil_it_eff_prod, A_amp_inv, A_loop_inv, tau_out, tau_sf, tau_diff.
`tau_in_it_eff_prod` is a constant: tau_in = tau_in_it_eff_prod / it.
"""

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops import activations, control, linalg, pb_weight
from ..utils.device import constant

TAU_IN_IT_EFF_PROD_KEY = "input_time_const_eff_it_prod"
TAU_MIL_IT_EFF_PROD_KEY = "miller_time_const_eff_it_prod"
A_AMP_KEY = "amplifier_gain"
A_CL_KEY = "closed_loop_gain"
TAU_OUT_KEY = "output_time_const"
F_C_SF_KEY = "sf_cutoff_freq"
F_C_DIFF_KEY = "diff_amp_cutoff_freq"
NS_TO_S = 1e-9
PARAM_NAMES = ("tau_mil_it_eff_prod", "A_amp_inv", "A_loop_inv", "tau_out",
               "tau_sf", "tau_diff")
# FOH needs dt > 0: consecutive samples clamped to the dataset start get
# this step (ns). Large enough that ||A dt|| >= ~1e-3 for every modeled
# circuit, so the float32 FOH backward (1/dt^2-scale factors) stays
# finite; ~1e6x shorter than any sampled lifetime interval.
MIN_SAMPLE_DT_NS = 100.0


class ResetState(NamedTuple):
    """Differencing-amp reset state, produced by the reset render."""
    reset_delta_log_it: torch.Tensor  # (N,) float32
    reset_ts: torch.Tensor            # (N,) int64 ns base
    reset_ts_delta: torch.Tensor      # (N,) float32 ns offset


def init_pixel_bandwidth(camera_calibration, min_ts, f_c_dominant_min,
                         target_cumprob_max_sample_lifetime, device=None):
    """(ParameterDict of the six raw params, dict of constants) from the
    calibrated pixel-circuit constants."""
    cal = {k: float(camera_calibration[k]) for k in (
        TAU_IN_IT_EFF_PROD_KEY, TAU_MIL_IT_EFF_PROD_KEY, A_AMP_KEY,
        A_CL_KEY, TAU_OUT_KEY, F_C_SF_KEY, F_C_DIFF_KEY)}

    def raw(v):
        return nn.Parameter(activations.softplus_inverse(
            torch.tensor(v, dtype=torch.float32, device=device)))

    params = nn.ParameterDict({
        "tau_mil_it_eff_prod_raw": raw(cal[TAU_MIL_IT_EFF_PROD_KEY]),
        "A_amp_inv_raw": raw(1.0 / cal[A_AMP_KEY]),
        "A_loop_inv_raw": raw(cal[A_CL_KEY] / cal[A_AMP_KEY]),
        "tau_out_raw": raw(cal[TAU_OUT_KEY]),
        "tau_sf_raw": raw(1.0 / (2 * math.pi * cal[F_C_SF_KEY])),
        "tau_diff_raw": raw(1.0 / (2 * math.pi * cal[F_C_DIFF_KEY])),
    })
    consts = {
        "tau_in_it_eff_prod": torch.tensor(
            cal[TAU_IN_IT_EFF_PROD_KEY], dtype=torch.float32, device=device),
        "min_ts": torch.tensor(int(min_ts), dtype=torch.int64,
                               device=device),
        "omega_c_dominant_min": torch.tensor(
            2 * math.pi * float(f_c_dominant_min), dtype=torch.float64,
            device=device),  # rad/s
        "target_cumprob_max_sample_lifetime": torch.tensor(
            float(target_cumprob_max_sample_lifetime), dtype=torch.float64,
            device=device),
    }
    return params, consts


def effective_params(params):
    """Softplus-positive reads of the six learnable parameters."""
    return {name: activations.softplus(params[f"{name}_raw"])
            for name in PARAM_NAMES}


def packed_params(params, consts):
    """The chain's parameters as one (7,) float32 tensor on their device:
    the six effective values in PARAM_NAMES order, then
    `tau_in_it_eff_prod` (no device value is read)."""
    eff = effective_params(params)
    return torch.stack([eff[name] for name in PARAM_NAMES]
                       + [consts["tau_in_it_eff_prod"]])


def _packed_sys_params(packed, steady_state_intensity):
    lin = pb_weight.linearization(packed.unbind(), steady_state_intensity)
    return lin["tzw"], lin["wn2"], lin["sf"], lin["df"]


def linearized_sys_params(params, consts, steady_state_intensity):
    """Linearized 2nd-order sub-system parameters at the given steady
    states: (2 zeta omega_n, omega_n^2, omega_c_sf, omega_c_diff)."""
    return _packed_sys_params(packed_params(params, consts),
                              steady_state_intensity)


def _packed_linearize(packed, steady_state_intensity, output_sf_log_it):
    two_zeta_omega_n, omega_n_square, omega_c_sf, omega_c_diff = (
        _packed_sys_params(packed, steady_state_intensity))
    shape = steady_state_intensity.shape
    dtype = steady_state_intensity.dtype
    device = steady_state_intensity.device
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    ones = torch.ones(shape, dtype=dtype, device=device)
    sf = omega_c_sf.to(dtype).expand(shape)
    diff = omega_c_diff.to(dtype).expand(shape)
    A = torch.stack([
        torch.stack([-two_zeta_omega_n, -omega_n_square, zeros, zeros], -1),
        torch.stack([ones, zeros, zeros, zeros], -1),
        torch.stack([zeros, sf, -sf, zeros], -1),
        torch.stack([zeros, zeros, diff, -diff], -1),
    ], dim=-2)
    B = torch.stack([omega_n_square, zeros, zeros, zeros], dim=-1)[..., None]
    rows = [[0, 0, 1, 0], [0, 0, 0, 1]] if output_sf_log_it \
        else [[0, 0, 0, 1]]
    C = constant(rows, dtype, device).expand(
        *shape, len(rows), 4)
    D = torch.zeros((*shape, len(rows), 1), dtype=dtype, device=device)
    return control.StateSpace(A=A, B=B, C=C, D=D)


def linearize_sys(params, consts, steady_state_intensity,
                  output_sf_log_it=False):
    """The batched linearized 4x4 continuous state space."""
    return _packed_linearize(packed_params(params, consts),
                             steady_state_intensity, output_sf_log_it)


def linearized_sys_omega_c_dominant(params, consts, steady_state_intensity,
                                    reset_diff=False):
    """Approximate dominant cutoff angular frequency."""
    two_zeta_omega_n, omega_n_square, omega_c_sf, omega_c_diff = (
        linearized_sys_params(params, consts, steady_state_intensity))
    zeta_omega_n = two_zeta_omega_n / 2
    disc = zeta_omega_n ** 2 - omega_n_square
    j_omega_d = torch.sqrt(torch.clamp(disc, min=0.0))
    omega_n = torch.sqrt(omega_n_square)
    omega_c_nlti = torch.where(zeta_omega_n >= omega_n,
                               zeta_omega_n - j_omega_d, omega_n)
    omega_c = torch.minimum(omega_c_nlti, omega_c_sf)
    if not reset_diff:
        omega_c = torch.minimum(omega_c, omega_c_diff)
    return omega_c


def discretized_sys_to_weight(sysd, x0_dir=None):
    """Collapse the LTV discrete system into per-sample output weights.

    sysd.A/B/B_tilde are (S-1, ..., n, n|m), C and D (S-1, ..., o, n|m).
    y[S-1] = sum_i w[i] u[i] with
      w[0]   = C phi(1, S-1) B[0]            [+ C phi(0, S-1) x0_dir]
      w[i]   = C phi(i+1, S-1) B[i] + C phi(i, S-1) Bt[i-1]
      w[S-1] = C Bt[S-2] + D
    by a reverse recursion over i carrying C phi(i+1, S-1).

    x0_dir: optional (n, m) initial-state direction: the system starts at
    x[0] = x0_dir u[0] (the steady state for the first input), so the
    weights sum to the DC gain for any window length (a window clamped to
    the dataset start, all dts at the floor, would otherwise leave the
    weights summing to float32 noise).
    Returns (S, ..., o, m).
    """
    A, B, Bt = sysd.A, sysd.B, sysd.B_tilde
    S = A.shape[0] + 1
    C = sysd.C[0].expand(*A.shape[1:-2], *sysd.C.shape[-2:])
    D = sysd.D[0]
    mm = linalg.matmul
    w_last = mm(C, Bt[S - 2]) + D
    c_phi = C  # C phi(i+1, S-1)
    w_mid = []
    for i in range(S - 2, 0, -1):
        c_phi_i = mm(c_phi, A[i])  # C phi(i, S-1)
        w_mid.append(mm(c_phi, B[i]) + mm(c_phi_i, Bt[i - 1]))
        c_phi = c_phi_i
    w_first = mm(c_phi, B[0])
    if x0_dir is not None:
        # C phi(0, S-1) x0_dir = (C phi(1, S-1)) A[0] x0_dir
        w_first = w_first + mm(c_phi, mm(A[0], x0_dir))
    return torch.stack([w_first, *reversed(w_mid), w_last], dim=0)


def split_time(base, delta):
    """Move the integer part of `delta` into the int64 `base` with a
    straight-through gradient, leaving a sub-ns float32 remainder."""
    r = torch.round(delta).detach()
    return base + r.to(torch.int64), delta - r


def sample_lifetimes(params, consts, normalized_interval_gen):
    """Input-sample lifetimes (ns before the output timestamp) by the
    exponential distribution's inverse CDF; no gradient flows through
    them. Returns (S, ...) float32, descending to 0 at the output."""
    S = normalized_interval_gen.shape[0] + 1
    batch_ndim = normalized_interval_gen.dim() - 1
    device = normalized_interval_gen.device
    # linspace(1, 0, S) as the JAX package's jnp.linspace evaluates it:
    # 1 - i * (1 / (S - 1)), then an exact 0
    step = torch.arange(S - 1, dtype=torch.float32, device=device) \
        * torch.full((), 1.0 / (S - 1), dtype=torch.float32, device=device)
    boundary = torch.cat([1.0 - step, step.new_zeros(1)])
    boundary = boundary.reshape(-1, *([1] * batch_ndim))
    gen = normalized_interval_gen.to(torch.float32)
    interval = boundary[:-1] + gen * (boundary[1:] - boundary[:-1])
    mid = 0.5 * (interval[:-1] + interval[1:])  # (S-2, ...)
    ones = torch.ones_like(interval[:1])
    normalized_lifetime = torch.cat([ones, mid, torch.zeros_like(ones)])
    rate = NS_TO_S * consts["omega_c_dominant_min"].to(torch.float32)
    p = consts["target_cumprob_max_sample_lifetime"].to(torch.float32) \
        * normalized_lifetime
    lifetime = -torch.log1p(-p) / rate  # exponential ICDF, in ns
    return lifetime.detach()


def weight_chain(packed, intensity_sample, sample_dt, output_sf_log_it):
    """The plain chain, in the packed parameters of `packed_params`:
    linearize at intensity_sample[1:], FOH-discretize (efficient, state
    preserving) and collapse to (S, ..., o) weights with the x0_dir term.
    The CUDA kernels' plain version (ops/pb_weight.py)."""
    lin_sys = _packed_linearize(packed, intensity_sample[1:],
                                output_sf_log_it)
    sysd = control.foh_cont2discrete(
        lin_sys, NS_TO_S * sample_dt, is_state_preserved=True,
        is_efficient=True)
    x0_dir = constant(pb_weight.X0_DIR, intensity_sample.dtype,
                      intensity_sample.device).reshape(4, 1)
    weight = discretized_sys_to_weight(sysd, x0_dir=x0_dir)  # (S,...,o,1)
    return weight[..., 0]


def intensity_sample_to_weight(params, consts, intensity_sample, sample_dt,
                               output_sf_log_it=False):
    """Linearize + FOH-discretize + collapse to (S, ..., o) weights;
    sample_dt (S-1, ...) in ns, float32.

    On the card, one kernel a direction (`ops.pb_weight.weight`); on the
    CPU the plain chain, rematerialized (torch.utils.checkpoint, the JAX
    package's jax.checkpoint): the backward recomputes the expm chain
    instead of keeping every squaring's residuals from forward to
    backward."""
    return pb_weight.weight(packed_params(params, consts), intensity_sample,
                            sample_dt, 2 if output_sf_log_it else 1)


def _collapse_weighted_log_it(weight, intensity_sample):
    """(S, ..., o) weights x (S, ...) intensities -> (..., o)
    weight-normalized output log-intensities."""
    normalized_weight = weight / weight.sum(dim=0, keepdim=True)
    log_it = torch.log(intensity_sample)[..., None]
    return (normalized_weight * log_it).sum(dim=0)


def _reset_decay(params, reset_state, ts, ts_delta):
    """Differencing-amp reset correction decayed from the reset timestamp
    to (ts, ts_delta)."""
    omega_c_diff = 1.0 / activations.softplus(params["tau_diff_raw"])
    dtype = reset_state.reset_delta_log_it.dtype
    reset_dt = ((ts - reset_state.reset_ts).to(dtype)
                + (ts_delta - reset_state.reset_ts_delta))
    return reset_state.reset_delta_log_it * torch.exp(
        -omega_c_diff * (NS_TO_S * reset_dt))


def weighted_samples_to_output_log_it(params, weight, intensity_sample,
                                      last_sample_ts, last_sample_delta,
                                      reset_state, reset_diff=False):
    """Weight-normalized log-intensity synthesis + differencing-amp reset.
    Returns (output_log_intensity, new_reset_state)."""
    out = _collapse_weighted_log_it(weight, intensity_sample)
    if reset_diff:
        sf_log_it = out[..., 0]
        new_state = ResetState(
            reset_delta_log_it=out[..., 1] - sf_log_it,
            reset_ts=last_sample_ts, reset_ts_delta=last_sample_delta)
        # resetting pins the diff-amp output to its input (the sf output)
        return sf_log_it, new_state
    decayed = _reset_decay(params, reset_state, last_sample_ts,
                           last_sample_delta)
    return out[..., 0] - decayed, reset_state


def _sample_times(params, consts, normalized_interval_gen, output_ts,
                  output_ts_delta):
    """Split sample timestamps (S, ...) from the lifetimes, clamped to the
    dataset start, and the float32 steps between them (ns), floored at
    MIN_SAMPLE_DT_NS."""
    lifetime = sample_lifetimes(params, consts, normalized_interval_gen)
    base, delta = split_time(output_ts.expand(lifetime.shape),
                             output_ts_delta - lifetime)
    min_ts = consts["min_ts"]
    rel = (base - min_ts).to(torch.float32) + delta
    below = rel < 0
    base = torch.where(below, min_ts, base)
    delta = torch.where(below, torch.zeros_like(delta), delta)
    # exact split-time differences
    dt = ((base[1:] - base[:-1]).to(torch.float32)
          + (delta[1:] - delta[:-1]))
    dt = torch.clamp(dt, min=MIN_SAMPLE_DT_NS)
    return base, delta, dt


def forward_fused(params, consts, normalized_interval_gen, output_ts,
                  output_ts_delta, intensity_sampling_fn, slice_size):
    """One pixel-bandwidth pass over all renders of a training step.

    The first `slice_size` entries are the reset (diff.start) slice, which
    produces the ResetState; the remaining slices consume it. Both the
    source-follower and the diff-amp outputs are computed for every
    sample (o = 2).

    Args:
        normalized_interval_gen: (S-1, R*N) in [0, 1].
        output_ts: (R*N,) int64 ns, R slices of N events each.
        output_ts_delta: (R*N,) float32 differentiable offset.
        intensity_sampling_fn: (sample_ts (S, R*N) int64, sample_ts_delta
            (S, R*N) float32) -> tuple whose first element is the sampled
            intensity (S, R*N); the rest pass through as `aux` (a dict
            first in it gains `pb_min_abs_weight_sum`).
        slice_size: N.
    Returns:
        (output_log_intensity (R*N,), aux, ResetState)
    """
    output_ts_delta = torch.as_tensor(
        output_ts_delta, dtype=torch.float32,
        device=output_ts.device).expand(output_ts.shape)
    sample_base, sample_delta, sample_dt = _sample_times(
        params, consts, normalized_interval_gen, output_ts, output_ts_delta)
    sampling_output = intensity_sampling_fn(sample_base, sample_delta)
    intensity_sample = sampling_output[0]
    aux = sampling_output[1:]
    weight = intensity_sample_to_weight(
        params, consts, intensity_sample, sample_dt, output_sf_log_it=True)
    if aux and isinstance(aux[0], dict):
        # the filter's health: with the x0_dir term every sample's weights
        # sum to the DC gain (1); a sum near 0 would blow up the
        # normalization
        aux = (dict(aux[0], pb_min_abs_weight_sum=weight.detach().sum(
            dim=0).abs().min()), *aux[1:])
    out = _collapse_weighted_log_it(weight, intensity_sample)  # (R*N, 2)
    sf_log_it, diff_log_it_bfr_reset = out[..., 0], out[..., 1]

    n = slice_size
    n_slices = out.shape[0] // n
    new_state = ResetState(
        reset_delta_log_it=diff_log_it_bfr_reset[:n] - sf_log_it[:n],
        reset_ts=output_ts[:n], reset_ts_delta=output_ts_delta[:n])
    tiled_state = ResetState(*(t.repeat(n_slices) for t in new_state))
    decayed = _reset_decay(params, tiled_state, output_ts, output_ts_delta)
    out_all = torch.cat([sf_log_it[:n],
                         (diff_log_it_bfr_reset - decayed)[n:]])
    return out_all, aux, new_state


def forward(params, consts, normalized_interval_gen, output_ts,
            intensity_sampling_fn, reset_state=None, reset_diff=False,
            output_ts_delta=0.0):
    """Full pixel-bandwidth forward pass of one render.

    Args:
        normalized_interval_gen: (S-1, ...) in [0, 1].
        output_ts: (...) int64 ns (floats are truncated to ns).
        intensity_sampling_fn: as in `forward_fused`.
        reset_state: ResetState from this step's reset render (required
            when reset_diff is False).
        reset_diff: produce (and return) a fresh ResetState.
        output_ts_delta: float32 differentiable ns offset on output_ts.
    Returns:
        (output_log_intensity (...), aux, reset_state)
    """
    output_ts = torch.as_tensor(output_ts)
    if output_ts.is_floating_point():
        output_ts = output_ts.to(torch.int64)
    output_ts_delta = torch.as_tensor(
        output_ts_delta, dtype=torch.float32,
        device=output_ts.device).expand(output_ts.shape)
    sample_base, sample_delta, sample_dt = _sample_times(
        params, consts, normalized_interval_gen, output_ts, output_ts_delta)
    sampling_output = intensity_sampling_fn(sample_base, sample_delta)
    intensity_sample = sampling_output[0]
    aux = sampling_output[1:]
    weight = intensity_sample_to_weight(
        params, consts, intensity_sample, sample_dt,
        output_sf_log_it=reset_diff)
    out_log_it, new_reset_state = weighted_samples_to_output_log_it(
        params, weight, intensity_sample, output_ts, output_ts_delta,
        reset_state, reset_diff)
    return out_log_it, aux, new_reset_state
