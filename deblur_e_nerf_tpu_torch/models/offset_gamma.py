"""Eval-time offset-gamma correction with analytic Jacobians + GN/LM
(counterpart of deblur_e_nerf_tpu/models/offset_gamma.py, the same
host-side float64 numpy code).

Host-side float64 numpy redesign of the reference's correction stack
(reference: deblur_e_nerf/models/offset_gamma_correction.py:4-167,
external/optimizer.py:21-111): aligns predicted intensities to targets under
the affine-log ambiguity plus a black-level offset,

    y = const_scale * (scale * x^gamma - offset)

with per-channel or scalar (scale, gamma, offset). The reference wraps
pypose Gauss-Newton / Levenberg-Marquardt with model-provided sparse
Jacobians; this implements the same analytic-Jacobian normal equations
directly (the problem has <= 9 parameters, so dense JtJ in f64 is exact and
tiny). Runs on host CPU like the reference (moved off-device at
deblur_e_nerf.py:713-717).
"""

import numpy as np


class OffsetGammaCorrection:
    def __init__(self, const_scale, init_scale, init_gamma, init_offset):
        """
        Shapes: const_scale (B, 1, 1, 1, 1); scale/gamma/offset (1/C, 1, 1, 1)
        operating on inputs (B, C, H, W, 1).
        """
        self.const_scale = np.asarray(const_scale, np.float64)
        self.scale = np.asarray(init_scale, np.float64).copy()
        self.gamma = np.asarray(init_gamma, np.float64).copy()
        self.offset = np.asarray(init_offset, np.float64).copy()

    def __call__(self, x):
        return self.const_scale * (
            self.scale * np.power(x, self.gamma) - self.offset
        )

    def params(self):
        return np.concatenate(
            [self.scale.ravel(), self.gamma.ravel(),
             self.offset.ravel()]
        )

    def set_params(self, theta):
        s, g, o = len(self.scale), len(self.gamma), len(self.offset)
        self.scale = theta[:s].reshape(self.scale.shape).copy()
        self.gamma = theta[s:s + g].reshape(self.gamma.shape).copy()
        self.offset = theta[s + g:].reshape(self.offset.shape).copy()

    def jacobian(self, x):
        """(N, S+G+O) Jacobian of the flattened output wrt parameters
        (reference: offset_gamma_correction.py:112-167)."""
        B, C = x.shape[0], x.shape[1]
        dense_scale = self.const_scale * np.power(x, self.gamma)
        dense_gamma = self.scale * np.log(x) * dense_scale
        dense_offset = np.broadcast_to(-self.const_scale, x.shape)

        N = x.size
        S, G, O = len(self.scale), len(self.gamma), len(self.offset)
        jac = np.zeros((N, S + G + O), np.float64)

        def fill(col_offset, P, dense):
            view = jac[:, col_offset:col_offset + P].reshape(
                *x.shape, P
            )
            if P == 1:
                view[..., 0] = dense
            else:
                for c in range(C):
                    view[:, c, ..., c] = dense[:, c]

        fill(0, S, dense_scale)
        fill(S, G, dense_gamma)
        fill(S + G, O, dense_offset)
        return jac


def _loss(correction, x, target):
    r = (correction(x) - target).ravel()
    return float(r @ r)


def gauss_newton_step(correction, x, target):
    J = correction.jacobian(x)
    r = (correction(x) - target).ravel()
    theta = correction.params()
    delta, *_ = np.linalg.lstsq(J, -r, rcond=None)
    correction.set_params(theta + delta)
    return _loss(correction, x, target)


def levenberg_marquardt_step(correction, x, target, lm_state,
                             min_diag=1e-6, max_diag=1e32,
                             damping_factor=2.0, max_rejects=16):
    """One LM step with diagonal damping and a reject loop
    (reference: external/optimizer.py:62-111 semantics)."""
    J = correction.jacobian(x)
    r = (correction(x) - target).ravel()
    A = J.T @ J
    g = -J.T @ r
    last = _loss(correction, x, target)
    theta = correction.params()
    lam = lm_state.get("damping", 1e-6)

    loss = last
    for _ in range(max_rejects + 1):
        A_damped = A.copy()
        diag = np.clip(np.diag(A_damped), min_diag, max_diag)
        A_damped[np.diag_indices_from(A_damped)] = diag * (1.0 + lam)
        try:
            delta = np.linalg.solve(A_damped, g)
        except np.linalg.LinAlgError:
            break
        correction.set_params(theta + delta)
        loss = _loss(correction, x, target)
        if loss < last:
            lam = max(lam / damping_factor, 1e-12)
            break
        correction.set_params(theta)  # reject
        lam *= damping_factor
        loss = last
    lm_state["damping"] = lam
    return loss


def optimize(correction, x, target, algo="lm", max_steps=10,
             rtol=1e-5, atol=1e-8):
    """Iterate GN/LM with the reference's early stop: both the error and
    the parameters converged (reference: deblur_e_nerf.py:874-905).

    Returns the per-step normalized error trace (len <= max_steps + 1).
    """
    n = target.size
    errors = [_loss(correction, x, target) / n]
    lm_state = {}
    for _ in range(max_steps):
        prev_params = correction.params()
        if algo == "gn":
            err = gauss_newton_step(correction, x, target) / n
        elif algo == "lm":
            err = levenberg_marquardt_step(
                correction, x, target, lm_state
            ) / n
        else:
            raise NotImplementedError(algo)
        errors.append(err)
        if np.allclose(errors[-1], errors[-2], rtol=rtol, atol=atol) \
                and np.allclose(correction.params(), prev_params,
                                rtol=rtol, atol=atol):
            break
    return np.asarray(errors)
