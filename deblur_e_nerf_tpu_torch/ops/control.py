"""Batched LTI state-space models and First-Order-Hold discretization
(counterpart of deblur_e_nerf_tpu/ops/control.py), in the plain
(..., n, n) layout, differentiable throughout.

  Continuous standard form:   x'(t) = A x(t) + B u(t);  y = C x + D u
  Discrete non-standard form: x[k+1] = A[k] x[k] + B[k] u[k] + Bt[k] u[k+1]
                              y[k]   = C x[k] + D u[k]

Follows scipy.signal.cont2discrete(method='foh').
"""

from typing import NamedTuple, Optional

import torch

from . import linalg


class StateSpace(NamedTuple):
    A: torch.Tensor  # (..., n, n)
    B: torch.Tensor  # (..., n, m)
    C: torch.Tensor  # (..., o, n)
    D: torch.Tensor  # (..., o, m)
    B_tilde: Optional[torch.Tensor] = None  # (..., n, m) non-standard form


def foh_cont2discrete(system, dt, is_state_preserved=False,
                      is_efficient=False):
    """First-Order-Hold discretization of a batched continuous LTI system.

    Args:
        system: StateSpace in standard continuous form, batch dims leading.
        dt: discretization steps, broadcastable to the batch dims.
        is_state_preserved: if True, the discrete state equals the
            continuous state (non-standard form with B_tilde); else scipy's
            standard FOH.
        is_efficient: use expm(A dt) + two linear solves (A must be
            invertible) instead of the (n+2m)x(n+2m) embedding exponential.
    Returns:
        StateSpace of the discretized system.
    """
    a, b, c, d = system.A, system.B, system.C, system.D
    n, m = a.shape[-1], b.shape[-1]
    b = b.expand(*a.shape[:-2], n, m)
    dt = torch.as_tensor(dt, dtype=a.dtype, device=a.device)

    if is_efficient:
        a_dt = a * dt[..., None, None]
        phi = linalg.expm(a_dt)
        a_inv_b = linalg.solve(a, b)
        eye = linalg.eye(n, a.dtype, a.device)
        gamma1 = linalg.matmul(phi - eye, a_inv_b)
        gamma2 = linalg.solve(a_dt, gamma1) - a_inv_b
    else:
        batch = torch.broadcast_shapes(a.shape[:-2], dt.shape)
        n2 = n + 2 * m
        em = torch.zeros((*batch, n2, n2), dtype=a.dtype, device=a.device)
        em[..., :n, :n] = a * dt[..., None, None]
        em[..., :n, n:n + m] = b * dt[..., None, None]
        em[..., n:n + m, n + m:] = linalg.eye(m, a.dtype, a.device)
        ms = linalg.expm(em)
        phi = ms[..., :n, :n]
        gamma1 = ms[..., :n, n:n + m]
        gamma2 = ms[..., :n, n + m:]

    if is_state_preserved:
        return StateSpace(A=phi, B=gamma1 - gamma2, C=c, D=d,
                          B_tilde=gamma2)
    return StateSpace(
        A=phi, B=gamma1 - gamma2 + linalg.matmul(phi, gamma2), C=c,
        D=d + linalg.matmul(c, gamma2), B_tilde=None)
