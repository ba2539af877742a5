"""The pixel-bandwidth weight chain, one CUDA kernel per direction
(counterpart of the JAX package's rematerialized `_weight_remat`,
deblur_e_nerf_tpu/models/pixel_bandwidth.py:282-301: `linearize_sys`,
ops/control.py `foh_cont2discrete` (efficient, state preserving),
ops/linalg.py `expm_ml` / `solve_ml` / `matmul_ml` and
`discretized_sys_to_weight` with `x0_dir`).

  - `weight(params, intensity, dt, n_out)` -> (S, ..., o) weights, with
    its gradient: on a CUDA tensor the autograd function whose forward
    and backward are the kernels of `csrc/pb_weight.cu`; on a CPU tensor
    the plain chain (`weight_reference`, models/pixel_bandwidth.py
    `weight_chain`) under torch.utils.checkpoint when a gradient is
    wanted.
  - `weight_forward` / `weight_backward`: the kernels' entries (CUDA
    tensors only; they raise on anything else). The forward also returns
    a finiteness byte a column and each system's Ad, which the backward
    takes: it skips a column whose cotangent is exactly 0 and whose byte
    is set, and reverses each live system from the saved Ad (its Bd and
    Bt from Ad by the FOH) without a second expm. `FORWARD_LAUNCHES` and
    `BACKWARD_LAUNCHES` count their launches.
  - `weight_forward_model` / `weight_backward_model`: plain PyTorch
    transcriptions of the kernels, step by step (the forward, its byte
    and saved systems; the reverse weight scan, each system's FOH and
    expm in reverse, the linearization in reverse, the skip), held to
    autograd and to JAX on the CPU.

`params` is the (7,) float32 tensor of `models.pixel_bandwidth
.packed_params`: tau_mil_it_eff_prod, A_amp_inv, A_loop_inv, tau_out,
tau_sf, tau_diff (effective, softplus-positive), then tau_in_it_eff_prod.
It is never read on the host. `intensity` is (S, ...), `dt` (S-1, ...) in
ns; system j (0 <= j < S - 1) is linearized at intensity[j + 1] over
dt[j], so intensity[0] gets no gradient. Output row 0 of the o = 2 form
is the source follower's (state 2), the last row the differencing
amplifier's (state 3).
"""

import torch
from torch.utils import checkpoint

from . import linalg
from .linalg import matmul as _mm

FORWARD_LAUNCHES = 0   # forward kernel launches since the last reset
BACKWARD_LAUNCHES = 0  # backward kernel launches since the last reset

MAX_SYSTEMS = 32  # S - 1 at most: one lane of a warp a system
N_PARAMS = 7
SYSTEM_FLOATS = 16  # a saved system: its Ad
NS_TO_S = 1e-9
# x_ss(u) = [0, u, u, u] at every linearization point (each stage has unit
# DC gain), so the initial-state direction is a constant vector
X0_DIR = (0.0, 1.0, 1.0, 1.0)


def weight_reference(params, intensity, dt, n_out):
    """The plain chain (models/pixel_bandwidth.py `weight_chain`; the model
    imports this module, so it is reached at call time)."""
    from ..models import pixel_bandwidth

    return pixel_bandwidth.weight_chain(params, intensity, dt, n_out == 2)


# ---------------------------------------------------------------------------
# the backward kernel's plain model


def _t(a):
    return a.transpose(-1, -2)


def linearization(p, u):
    """The linearized circuit at steady-state intensities u from the
    packed parameters p (the (7,) tensor or its unbind()), in the JAX
    package's float32 order (`linearized_sys_params`,
    models/pixel_bandwidth.py:106-121; the kernels' `linearize` computes
    the same): {tau_in, tau_mil, a_amp, a_loop, denom, tzw (2 zeta
    omega_n), wn2 (omega_n^2), sf (omega_c_sf), df (omega_c_diff)}."""
    tau_in = p[6] / u
    tau_mil = p[0] / u
    a_amp = 1.0 / p[1]
    a_loop = 1.0 / p[2]
    denom = (tau_in + tau_mil) * p[3]
    tzw = (tau_in + p[3] + (a_amp + 1) * tau_mil) / denom
    wn2 = (a_loop + 1) / denom
    sf = 1.0 / p[4]
    df = 1.0 / p[5]
    return dict(tau_in=tau_in, tau_mil=tau_mil, a_amp=a_amp, a_loop=a_loop,
                denom=denom, tzw=tzw, wn2=wn2, sf=sf, df=df)


def _linearize(params, u):
    """Per system: (A (..., 4, 4), B (..., 4, 1)) and the intermediates
    the reverse needs (`linearization`, and p)."""
    p = params.to(u.dtype)
    lin = linearization(p, u)
    A = u.new_zeros((*u.shape, 4, 4))
    A[..., 0, 0] = -lin["tzw"]
    A[..., 0, 1] = -lin["wn2"]
    A[..., 1, 0] = 1.0
    A[..., 2, 1] = lin["sf"]
    A[..., 2, 2] = -lin["sf"]
    A[..., 3, 2] = lin["df"]
    A[..., 3, 3] = -lin["df"]
    B = u.new_zeros((*u.shape, 4, 1))
    B[..., 0, 0] = lin["wn2"]
    return A, B, dict(lin, p=p)


def _expm_forward(a_dt):
    """expm(a_dt) as ops/linalg.py computes it, keeping what the reverse
    needs: the scaled powers, the Pade polynomials' inner sums, the
    factors of P = V - U and every squaring's input phi_k."""
    b = linalg._PADE13_B
    eye = linalg.eye(4, a_dt.dtype, a_dt.device)
    s = linalg.squaring_count(a_dt)  # no gradient
    scale = torch.exp2(-s.to(a_dt.dtype))
    a = a_dt * scale[..., None, None]
    a2 = _mm(a, a)
    a4 = _mm(a2, a2)
    a6 = _mm(a2, a4)
    x = b[13] * a6 + b[11] * a4 + b[9] * a2
    wu = _mm(a6, x) + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye
    u = _mm(a, wu)
    y = b[12] * a6 + b[10] * a4 + b[8] * a2
    v = _mm(a6, y) + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye
    fac_p = linalg.factor(v - u)
    phis = [linalg.solve_factored(fac_p, v + u)]
    n = int(s.max()) if s.numel() else 0  # the model's only host read
    for k in range(n):
        phi = phis[-1]
        phis.append(torch.where((k < s)[..., None, None], _mm(phi, phi),
                                phi))
    return dict(s=s, scale=scale, a=a, a2=a2, a4=a4, a6=a6, x=x, wu=wu,
                y=y, fac_p=fac_p, phis=phis)


def _expm_reverse(e, phi_bar):
    """The cotangent of a_dt from that of expm(a_dt): the squarings, the
    solve phi_0 = P^-1 Q (Q = V + U), the Pade polynomials and the 2^-s
    scaling in reverse (s carries no gradient)."""
    b = linalg._PADE13_B
    s = e["s"]
    for k in reversed(range(len(e["phis"]) - 1)):
        phi = e["phis"][k]
        back = _mm(phi_bar, _t(phi)) + _mm(_t(phi), phi_bar)
        phi_bar = torch.where((k < s)[..., None, None], back, phi_bar)
    q_bar = linalg.solve_transposed(e["fac_p"], phi_bar)
    p_bar = -_mm(q_bar, _t(e["phis"][0]))
    v_bar = q_bar + p_bar
    u_bar = q_bar - p_bar
    a, a2, a4, a6 = e["a"], e["a2"], e["a4"], e["a6"]
    # u = a wu;  wu = a6 x + b7 a6 + b5 a4 + b3 a2 + b1 I
    a_bar = _mm(u_bar, _t(e["wu"]))
    wu_bar = _mm(_t(a), u_bar)
    x_bar = _mm(_t(a6), wu_bar)
    a6_bar = _mm(wu_bar, _t(e["x"])) + b[7] * wu_bar + b[13] * x_bar
    a4_bar = b[5] * wu_bar + b[11] * x_bar
    a2_bar = b[3] * wu_bar + b[9] * x_bar
    # v = a6 y + b6 a6 + b4 a4 + b2 a2 + b0 I
    y_bar = _mm(_t(a6), v_bar)
    a6_bar = a6_bar + _mm(v_bar, _t(e["y"])) + b[6] * v_bar + b[12] * y_bar
    a4_bar = a4_bar + b[4] * v_bar + b[10] * y_bar
    a2_bar = a2_bar + b[2] * v_bar + b[8] * y_bar
    # a6 = a2 a4;  a4 = a2 a2;  a2 = a a
    a2_bar = a2_bar + _mm(a6_bar, _t(a4))
    a4_bar = a4_bar + _mm(_t(a2), a6_bar)
    a2_bar = a2_bar + _mm(a4_bar, _t(a2)) + _mm(_t(a2), a4_bar)
    a_bar = a_bar + _mm(a2_bar, _t(a)) + _mm(_t(a), a2_bar)
    return a_bar * e["scale"][..., None, None]


def _discretize(A, B, dt):
    """FOH (efficient, state preserving) of each system, keeping what the
    reverse needs. Returns (Ad, Bd, Bt) and the intermediates."""
    dt_s = NS_TO_S * dt
    a_dt = A * dt_s[..., None, None]
    e = _expm_forward(a_dt)
    phi = e["phis"][-1]
    fac_a = linalg.factor(A)
    z = linalg.solve_factored(fac_a, B)  # A^-1 B
    eye = linalg.eye(4, A.dtype, A.device)
    g1 = _mm(phi - eye, z)
    fac_a_dt = linalg.factor(a_dt)
    y = linalg.solve_factored(fac_a_dt, g1)
    g2 = y - z
    return (phi, g1 - g2, g2), dict(dt_s=dt_s, a_dt=a_dt, e=e, phi=phi, z=z,
                                    y=y, fac_a=fac_a, fac_a_dt=fac_a_dt)


def _rows(n_out):
    return (2, 3) if n_out == 2 else (3,)


def _scan(Ad, Bd, Bt, n_out):
    """The forward weight scan for each output row r (its C row the unit
    vector of state `_rows(n_out)[r]`): the carries c_i = C phi(i, S-1)
    for i = 1..S-1 ((S, ..., o, 4), c[0] unused) and the weights
    (S, ..., o):
      w[S-1] = c_{S-1} Bt[S-2]
      w[i]   = c_{i+1} Bd[i] + c_i Bt[i-1]       (1 <= i <= S-2)
      w[0]   = c_1 Bd[0] + c_1 Ad[0] x0_dir."""
    S = Ad.shape[0] + 1
    batch = Ad.shape[1:-2]
    c = Ad.new_zeros((S, *batch, n_out, 4))
    for r, state in enumerate(_rows(n_out)):
        c[S - 1, ..., r, state] = 1.0
    for i in range(S - 2, 0, -1):
        c[i] = _mm(c[i + 1], Ad[i])
    x0 = torch.tensor(X0_DIR, dtype=Ad.dtype, device=Ad.device)
    w = Ad.new_zeros((S, *batch, n_out))
    w[S - 1] = _mm(c[S - 1], Bt[S - 2])[..., 0]
    for i in range(S - 2, 0, -1):
        w[i] = (_mm(c[i + 1], Bd[i]) + _mm(c[i], Bt[i - 1]))[..., 0]
    w[0] = (_mm(c[1], Bd[0])[..., 0]
            + _mm(c[1], _mm(Ad[0], x0[:, None]))[..., 0])
    return c, w


def _scan_reverse(Ad, Bd, Bt, c, g):
    """Cotangents of (Ad, Bd, Bt) from those of the weights g (S, ..., o):
    the carries' cotangents cbar_i, from cbar_0 = g[0] x0_dir (the
    cotangent of c_0 = c_1 Ad[0]) up,
      cbar_i = g[i-1] Bd[i-1] + g[i] Bt[i-1] + Ad[i-1] cbar_{i-1},
    then per system j
      Ad_bar[j] = sum_r c_{j+1,r} cbar_{j,r}^T
      Bd_bar[j] = sum_r g[j,r] c_{j+1,r},  Bt_bar[j] = sum_r g[j+1,r]
      c_{j+1,r}."""
    S = Ad.shape[0] + 1
    x0 = torch.tensor(X0_DIR, dtype=Ad.dtype, device=Ad.device)
    gc = g[..., None]  # (S, ..., o, 1)
    cbar = torch.zeros_like(c)
    cbar[0] = gc[0] * x0
    for i in range(1, S - 1):
        cbar[i] = (gc[i - 1] * Bd[i - 1][..., None, :, 0]
                   + gc[i] * Bt[i - 1][..., None, :, 0]
                   + _mm(cbar[i - 1], _t(Ad[i - 1])))
    c_next = c[1:]  # c_{j+1}, j = 0..S-2
    Ad_bar = (c_next[..., :, None] * cbar[:-1][..., None, :]).sum(-3)
    Bd_bar = (gc[:-1] * c_next).sum(-2)[..., None]
    Bt_bar = (gc[1:] * c_next).sum(-2)[..., None]
    return Ad_bar, Bd_bar, Bt_bar


def _discretize_reverse(A, d, Ad_bar, Bd_bar, Bt_bar):
    """(A_bar, B_bar, dt_bar) of one FOH from its outputs' cotangents:
    Bd = g1 - g2, Bt = g2, g2 = y - z, y = a_dt^-1 g1, g1 = (phi - I) z,
    z = A^-1 B, phi = expm(a_dt), a_dt = A dt_s. A solve x = M^-1 b
    reverses as b_bar = M^-T x_bar, M_bar = -b_bar x^T, with M^-T through
    M's own factors (`linalg.solve_transposed`): the transpose of the
    forward's own arithmetic, which keeps the float32 gradients within
    the tests' tolerances of JAX's (tests/test_torch_pb_weight.py), where
    a fresh pivoted elimination of M^T strayed beyond them."""
    g1_bar = Bd_bar
    g2_bar = Bt_bar - Bd_bar
    z_bar = -g2_bar
    h = linalg.solve_transposed(d["fac_a_dt"], g2_bar)
    g1_bar = g1_bar + h
    a_dt_bar = -_mm(h, _t(d["y"]))
    phi_bar = Ad_bar + _mm(g1_bar, _t(d["z"]))
    eye = linalg.eye(4, A.dtype, A.device)
    z_bar = z_bar + _mm(_t(d["phi"] - eye), g1_bar)
    a_dt_bar = a_dt_bar + _expm_reverse(d["e"], phi_bar)
    B_bar = linalg.solve_transposed(d["fac_a"], z_bar)
    A_bar = -_mm(B_bar, _t(d["z"])) + a_dt_bar * d["dt_s"][..., None, None]
    dt_bar = NS_TO_S * (a_dt_bar * A).sum(dim=(-2, -1))
    return A_bar, B_bar, dt_bar


def _linearize_reverse(u, lin, A_bar, B_bar):
    """(u_bar, the 7 parameters' cotangents (7, ...)) of one system."""
    p = lin["p"]
    tzw_bar = -A_bar[..., 0, 0]
    wn2_bar = -A_bar[..., 0, 1] + B_bar[..., 0, 0]
    sf_bar = A_bar[..., 2, 1] - A_bar[..., 2, 2]
    df_bar = A_bar[..., 3, 2] - A_bar[..., 3, 3]
    denom = lin["denom"]
    num_bar = tzw_bar / denom
    denom_bar = -(tzw_bar * lin["tzw"] + wn2_bar * lin["wn2"]) / denom
    a_loop_bar = wn2_bar / denom
    tau_in_bar = num_bar + denom_bar * p[3]
    tau_mil_bar = num_bar * (lin["a_amp"] + 1) + denom_bar * p[3]
    a_amp_bar = num_bar * lin["tau_mil"]
    tau_out_bar = num_bar + denom_bar * (lin["tau_in"] + lin["tau_mil"])
    u_bar = -(tau_in_bar * lin["tau_in"] + tau_mil_bar * lin["tau_mil"]) / u
    p_bar = torch.stack([
        tau_mil_bar / u,
        -a_amp_bar * lin["a_amp"] * lin["a_amp"],
        -a_loop_bar * lin["a_loop"] * lin["a_loop"],
        tau_out_bar,
        -sf_bar * lin["sf"] * lin["sf"],
        -df_bar * lin["df"] * lin["df"],
        tau_in_bar / u,
    ])
    return u_bar, p_bar


def _finite(u, lin, d, w):
    """The forward kernel's finiteness byte (...) of each column: every
    divisor of its systems (u, the parameters' reciprocals, the
    linearization's denominator, the U diagonals of the three
    factorizations) and every weight finite. Where it holds, every value
    the column's reverse reads is finite (csrc/pb_weight.cu)."""
    divisors = [u, lin["denom"]] + [
        fac[0][i][..., i] for fac in (d["e"]["fac_p"], d["fac_a"],
                                      d["fac_a_dt"]) for i in range(4)]
    ok = torch.stack([torch.isfinite(x) for x in divisors]).all(0).all(0)
    ok = ok & torch.isfinite(lin["p"][[1, 2, 4, 5]]).all()
    return ok & torch.isfinite(w).all(-1).all(0)


def weight_backward_model(params, intensity, dt, g, n_out, finite=None,
                          systems=None):
    """The backward kernel's arithmetic in plain PyTorch: from the weights'
    cotangent g (S, ..., o), the cotangents (intensity (S, ...), dt
    (S-1, ...), params (7,)). Runs the forward (`_linearize`,
    `_discretize`; with `systems`, the forward's saved Ad in place of its
    own, the same values, with (Bd, Bt) from it by the FOH, as here),
    then the scan, each system's FOH and the linearization in reverse.
    With `finite` (the forward's byte, `weight_forward_model`), a column
    whose cotangent is exactly 0 and whose byte is set gets zeros, as the
    kernel skips it. No autograd; float32 or float64."""
    u = intensity[1:]
    A, B, lin = _linearize(params, u)
    (Ad, Bd, Bt), d = _discretize(A, B, dt)
    if systems is not None:
        Ad = d["phi"] = systems.movedim(-2, 0).unflatten(-1, (4, 4)).to(
            u.dtype)
    g = g.to(u.dtype)
    c, _ = _scan(Ad, Bd, Bt, n_out)
    Ad_bar, Bd_bar, Bt_bar = _scan_reverse(Ad, Bd, Bt, c, g)
    A_bar, B_bar, dt_bar = _discretize_reverse(A, d, Ad_bar, Bd_bar, Bt_bar)
    u_bar, p_bar = _linearize_reverse(u, lin, A_bar, B_bar)
    if finite is not None:
        dead = finite & (g == 0).all(-1).all(0)
        u_bar = torch.where(dead, 0.0, u_bar)
        dt_bar = torch.where(dead, 0.0, dt_bar)
        p_bar = torch.where(dead, 0.0, p_bar)
    g_intensity = torch.cat([torch.zeros_like(intensity[:1]), u_bar])
    return g_intensity, dt_bar, p_bar.reshape(N_PARAMS, -1).sum(-1)


def weight_forward_model(params, intensity, dt, n_out):
    """The forward kernel's arithmetic in plain PyTorch (the recompute of
    `weight_backward_model`): the (S, ..., o) weights, the finiteness
    byte (...) (bool) and the saved systems, each one's Ad
    (..., S-1, 16)."""
    u = intensity[1:]
    A, B, lin = _linearize(params, u)
    (Ad, Bd, Bt), d = _discretize(A, B, dt)
    w = _scan(Ad, Bd, Bt, n_out)[1]
    return w, _finite(u, lin, d, w), \
        Ad.flatten(-2).movedim(0, -2).contiguous()


# ---------------------------------------------------------------------------
# the kernels


def _check(params, intensity, dt, n_out, g=None, finite=None,
           systems=None):
    """The kernels' own limits, the device last; returns (S, M)."""
    if n_out not in (1, 2):
        raise ValueError(f"n_out must be 1 or 2, got {n_out}")
    if intensity.dim() < 1 or intensity.shape[0] < 2:
        raise ValueError(f"expected intensity (S, ...) with S >= 2, got "
                         f"{tuple(intensity.shape)}")
    S = intensity.shape[0]
    batch = tuple(intensity.shape[1:])
    if tuple(dt.shape) != (S - 1, *batch):
        raise ValueError(f"dt {tuple(dt.shape)} does not fit intensity "
                         f"{tuple(intensity.shape)}")
    if tuple(params.shape) != (N_PARAMS,):
        raise ValueError(f"expected params ({N_PARAMS},), got "
                         f"{tuple(params.shape)}")
    tensors = {"params": params, "intensity": intensity, "dt": dt}
    if g is not None:
        if tuple(g.shape) != (*intensity.shape, n_out):
            raise ValueError(f"g {tuple(g.shape)} does not fit weights "
                             f"{(*intensity.shape, n_out)}")
        tensors["g"] = g
    if g is not None and (finite is None or systems is None):
        raise ValueError("the backward takes the forward's finiteness byte "
                         "and saved systems")
    if finite is not None:
        if tuple(finite.shape) != batch or finite.dtype != torch.bool:
            raise ValueError(f"finite must be bool {batch}, got "
                             f"{finite.dtype} {tuple(finite.shape)}")
        tensors["finite"] = finite
    if systems is not None:
        if tuple(systems.shape) != (*batch, S - 1, SYSTEM_FLOATS):
            raise ValueError(f"systems {tuple(systems.shape)} does not fit "
                             f"{(*batch, S - 1, SYSTEM_FLOATS)}")
        tensors["systems"] = systems
    for name, t in tensors.items():
        if name != "finite" and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S - 1 > MAX_SYSTEMS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_SYSTEMS} "
                         f"systems (S - 1), got {S - 1}")
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                             f"{name} on {t.device}")
        if t.device != intensity.device:
            raise ValueError(f"{name} on {t.device}, intensity on "
                             f"{intensity.device}")
    return S, intensity[0].numel()


def _stream(device):
    return torch._C._cuda_getCurrentRawStream(device.index)


def _library():
    from . import _cuda_build

    return _cuda_build.library()


def kernel_attributes():
    """{kernel: (registers a thread, local-memory bytes a thread)} of the
    built forward and backward, read from the loaded binary
    (cudaFuncGetAttributes): local memory is a stack frame or spills."""
    import ctypes

    lib = _library()
    found = {}
    for backward, name in enumerate(("pb_weight_fwd_kernel",
                                     "pb_weight_bwd_kernel")):
        regs, local = ctypes.c_int32(), ctypes.c_int64()
        err = lib.pb_weight_attributes(backward, ctypes.byref(regs),
                                       ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"{name}: attributes unread: CUDA {err}")
        found[name] = (regs.value, local.value)
    return found


def weight_forward(params, intensity, dt, n_out):
    """The forward kernel: (the (S, ..., o) float32 weights, the
    finiteness byte (...) (bool; `weight_forward_model`), each system's
    Ad (..., S-1, 16) float32 for `weight_backward`)."""
    global FORWARD_LAUNCHES
    S, M = _check(params, intensity, dt, n_out)
    w = torch.empty((*intensity.shape, n_out), dtype=torch.float32,
                    device=intensity.device)
    finite = torch.empty(intensity.shape[1:], dtype=torch.bool,
                         device=intensity.device)
    systems = torch.empty((*intensity.shape[1:], S - 1, SYSTEM_FLOATS),
                          dtype=torch.float32, device=intensity.device)
    if M:
        err = _library().pb_weight_fwd(
            params.data_ptr(), intensity.data_ptr(), dt.data_ptr(),
            w.data_ptr(), finite.data_ptr(), systems.data_ptr(), S, M, n_out,
            _stream(intensity.device))
        if err != 0:
            raise RuntimeError(f"pb_weight_fwd launch failed: CUDA {err}")
        FORWARD_LAUNCHES += 1
    return w, finite, systems


def weight_backward(params, intensity, dt, g, n_out, finite, systems):
    """The backward kernel: the cotangents (intensity (S, ...), dt
    (S-1, ...), params (7,)) from the weights' cotangent g (S, ..., o),
    with the forward's finiteness byte and saved systems. A
    column whose cotangent is exactly 0 and whose byte is set gets zeros
    without any work. The kernel writes each event's parameter partials,
    summed over its systems in a fixed order, into an (M, 7) buffer; the
    sum over events is torch.sum's (deterministic)."""
    global BACKWARD_LAUNCHES
    S, M = _check(params, intensity, dt, n_out, g, finite, systems)
    g_intensity = torch.empty_like(intensity)
    g_dt = torch.empty_like(dt)
    partials = torch.empty((M, N_PARAMS), dtype=torch.float32,
                           device=intensity.device)
    if M:
        err = _library().pb_weight_bwd(
            params.data_ptr(), intensity.data_ptr(), dt.data_ptr(),
            g.data_ptr(), finite.data_ptr(), systems.data_ptr(),
            g_intensity.data_ptr(), g_dt.data_ptr(), partials.data_ptr(), S,
            M, n_out, _stream(intensity.device))
        if err != 0:
            raise RuntimeError(f"pb_weight_bwd launch failed: CUDA {err}")
        BACKWARD_LAUNCHES += 1
    return g_intensity, g_dt, partials.sum(dim=0)


class _Weight(torch.autograd.Function):

    @staticmethod
    def forward(ctx, params, intensity, dt, n_out):
        w, finite, systems = weight_forward(params, intensity, dt, n_out)
        ctx.save_for_backward(params, intensity, dt, finite, systems)
        ctx.n_out = n_out
        return w

    @staticmethod
    def backward(ctx, g):
        g_intensity, g_dt, g_params = weight_backward(
            *ctx.saved_tensors[:3], g.contiguous(), ctx.n_out,
            *ctx.saved_tensors[3:])
        return g_params, g_intensity, g_dt, None


def weight(params, intensity, dt, n_out):
    """The (S, ..., o) weights of the chain, differentiable in params,
    intensity and dt. CUDA tensors go through the kernels (each input made
    contiguous first; the forward keeps each system's Ad, 64 bytes, for
    the backward); CPU tensors through the plain chain,
    rematerialized when a gradient is wanted."""
    if intensity.device.type == "cpu":
        if torch.is_grad_enabled():
            return checkpoint.checkpoint(weight_reference, params, intensity,
                                         dt, n_out, use_reentrant=False)
        return weight_reference(params, intensity, dt, n_out)
    return _Weight.apply(params.contiguous(), intensity.contiguous(),
                         dt.contiguous(), n_out)
