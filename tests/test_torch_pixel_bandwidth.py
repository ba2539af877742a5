"""The port's pixel-bandwidth filter path (ops/linalg.py, ops/control.py,
models/pixel_bandwidth.py) against the JAX package on the CPU, on the
calibrations of tests/test_pixel_bandwidth.py and tests/test_control.py,
including the stiff one. Inputs come from a numpy seed and go through
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from deblur_e_nerf_tpu.models import pixel_bandwidth as jpb
from deblur_e_nerf_tpu.ops import control as jcontrol
from deblur_e_nerf_tpu.ops import linalg as jlinalg
from deblur_e_nerf_tpu_torch.models import pixel_bandwidth as tpb
from deblur_e_nerf_tpu_torch.ops import control as tcontrol
from deblur_e_nerf_tpu_torch.ops import linalg as tlinalg

# tests/test_pixel_bandwidth.py: CALIB (make_model) and the stiff
# calibration of its min-ts-clamped gradient test
CALIBS = {
    "default": ({
        "input_time_const_eff_it_prod": 1e-4,
        "miller_time_const_eff_it_prod": 2e-5,
        "amplifier_gain": 50.0, "closed_loop_gain": 10.0,
        "output_time_const": 1e-4, "sf_cutoff_freq": 500.0,
        "diff_amp_cutoff_freq": 200.0}, 0, 21.0),
    "stiff": ({
        "input_time_const_eff_it_prod": 8e-4,
        "miller_time_const_eff_it_prod": 1.6e-4,
        "amplifier_gain": 50.0, "closed_loop_gain": 10.0,
        "output_time_const": 8e-4, "sf_cutoff_freq": 62.5,
        "diff_amp_cutoff_freq": 25.0}, 1_000_000_000, 4.0),
}


def make_models(name):
    calib, min_ts, f_c = CALIBS[name]
    jp, jc = jpb.init_pixel_bandwidth(calib, min_ts=min_ts,
                                      f_c_dominant_min=f_c,
                                      target_cumprob_max_sample_lifetime=0.95)
    tp, tc = tpb.init_pixel_bandwidth(calib, min_ts=min_ts,
                                      f_c_dominant_min=f_c,
                                      target_cumprob_max_sample_lifetime=0.95)
    with torch.no_grad():
        for k, v in jp.items():
            # f32 log(expm1) of two libms: within an ulp; then the same
            # raw parameters in both packages, as convert.params_from_jax
            # hands them over
            assert float(tp[k]) == pytest.approx(float(v), rel=1e-6), k
            tp[k].copy_(torch.tensor(np.asarray(v)))
    return jp, jc, tp, tc


def random_stable_system(rng, n=4, m=1, o=1):
    """tests/test_control.py's stable systems."""
    a = rng.standard_normal((n, n))
    a = -(a @ a.T) - n * np.eye(n)
    return (a, rng.standard_normal((n, m)), rng.standard_normal((o, n)),
            rng.standard_normal((o, m)))


def circuit_matrices(name, rng, n=64):
    """Linearized pixel-circuit A dt at random intensities and steps
    (100 ns floor to 20 ms) of one calibration, float32."""
    jp, jc, _, _ = make_models(name)
    it = jnp.asarray(rng.uniform(0.001, 1.0, n), jnp.float32)
    dt = np.exp(rng.uniform(np.log(100.0), np.log(2e7), n))
    dt[:8] = 100.0  # the floor
    lin = jpb.linearize_sys(jp, jc, it, True)
    return (np.asarray(lin.A) * (1e-9 * dt)[:, None, None]).astype(
        np.float32)


def _assert_close_scaled(got, want, rtol, name=""):
    """|got - want| <= rtol * max|want| per matrix (a matrix's entries
    differ by many orders of magnitude; the error of each scales with the
    matrix's norm)."""
    want = np.asarray(want)
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    err = np.abs(np.asarray(got) - want)
    assert np.all(err <= rtol * scale + 1e-30), (name, float(
        (err / (scale + 1e-30)).max()))


@pytest.mark.parametrize("name", ["default", "stiff"])
def test_expm_and_solve_match_jax_on_pixel_circuits(name):
    a = circuit_matrices(name, np.random.default_rng(0))
    want = np.moveaxis(np.asarray(jlinalg.expm_ml(
        jnp.moveaxis(jnp.asarray(a), 0, -1))), -1, 0)
    got = tlinalg.expm(torch.from_numpy(a)).numpy()
    # float32 Pade-13 + up to ~20 squarings, the same algorithm summed in
    # another order: each squaring doubles a rounding difference. At
    # ||A dt|| ~ 1e6 each package is up to 7e-2 (of the matrix's largest
    # entry) from the float64 expm, and the two differ by <= 1.9e-4
    # (measured): the port must be as close to the truth as JAX is, and
    # within 5e-4 of it.
    _assert_close_scaled(got, want, 5e-4, "expm")
    true = np.stack([scipy.linalg.expm(x.astype(np.float64)) for x in a])
    scale = np.abs(true).max(axis=(-2, -1))
    err_t = np.abs(got - true).max(axis=(-2, -1)) / scale
    err_j = np.abs(want - true).max(axis=(-2, -1)) / scale
    assert np.all(err_t <= 1.5 * err_j + 1e-5), float(
        (err_t - 1.5 * err_j).max())
    b = np.random.default_rng(1).standard_normal((a.shape[0], 4, 2)).astype(
        np.float32)
    want = np.moveaxis(np.asarray(jlinalg.solve_ml(
        jnp.moveaxis(jnp.asarray(a), 0, -1),
        jnp.moveaxis(jnp.asarray(b), 0, -1))), -1, 0)
    got = tlinalg.solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    # the same pivots (first maximum) and elimination order: f32 rounding
    # of differently fused multiply-adds only
    _assert_close_scaled(got, want, 1e-5, "solve")


def test_expm_and_solve_match_jax_in_float64():
    rng = np.random.default_rng(2)
    a = np.stack([random_stable_system(rng)[0] * s
                  for s in (0.01, 0.3, 1.0, 7.0, 60.0)])
    want = np.moveaxis(np.asarray(jlinalg.expm_ml(
        jnp.moveaxis(jnp.asarray(a), 0, -1))), -1, 0)
    got = tlinalg.expm(torch.from_numpy(a)).numpy()
    _assert_close_scaled(got, want, 1e-12, "expm f64")
    b = rng.standard_normal((5, 4, 3))
    want = np.linalg.solve(a, b)
    got = tlinalg.solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("efficient", [False, True])
@pytest.mark.parametrize("preserved", [False, True])
def test_foh_matches_jax_on_random_systems(efficient, preserved):
    """tests/test_control.py's systems, float64 (the JAX tests run x64)."""
    rng = np.random.default_rng(0)
    systems = [random_stable_system(rng) for _ in range(5)]
    dts = rng.uniform(0.01, 0.5, 5)
    a, b, c, d = (np.stack(x) for x in zip(*systems))
    want = jcontrol.foh_cont2discrete(
        jcontrol.StateSpace(*(jnp.asarray(x) for x in (a, b, c, d))),
        jnp.asarray(dts), is_state_preserved=preserved,
        is_efficient=efficient)
    got = tcontrol.foh_cont2discrete(
        tcontrol.StateSpace(*(torch.from_numpy(x) for x in (a, b, c, d))),
        torch.from_numpy(dts), is_state_preserved=preserved,
        is_efficient=efficient)
    for field in ("A", "B", "C", "D", "B_tilde"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-12, err_msg=field)


@pytest.mark.parametrize("name", ["default", "stiff"])
def test_foh_efficient_matches_jax_on_pixel_circuits(name):
    """The filter's own discretization (float32, state preserved), with
    the steps at the 100 ns floor included, held to the float64 embedding
    discretization of the same float32 inputs: the port must be as close
    to it as the JAX package is."""
    rng = np.random.default_rng(3)
    jp, jc, tp, tc = make_models(name)
    it = rng.uniform(0.001, 1.0, 48).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(100.0), np.log(2e7), 48)).astype(
        np.float32)
    dt[:6] = 100.0
    jsys = jpb.linearize_sys(jp, jc, jnp.asarray(it), True)
    tsys = tpb.linearize_sys(tp, tc, torch.from_numpy(it), True)
    np.testing.assert_allclose(tsys.A.detach().numpy(), np.asarray(jsys.A),
                               rtol=1e-6)
    want = jcontrol.foh_cont2discrete(jsys, jpb.NS_TO_S * jnp.asarray(dt),
                                      is_state_preserved=True,
                                      is_efficient=True)
    got = tcontrol.foh_cont2discrete(tsys, tpb.NS_TO_S * torch.from_numpy(dt),
                                     is_state_preserved=True,
                                     is_efficient=True)
    f64 = jcontrol.StateSpace(*(jnp.asarray(np.asarray(x), jnp.float64)
                                for x in jsys[:4]))
    true = jcontrol.foh_cont2discrete(
        f64, jnp.asarray(jpb.NS_TO_S * dt.astype(np.float64)),
        is_state_preserved=True, is_efficient=False)
    for field in ("A", "B", "B_tilde"):
        g = getattr(got, field).detach().numpy().astype(np.float64)
        w = np.asarray(getattr(want, field), np.float64)
        t = np.asarray(getattr(true, field))
        # per matrix, relative to its largest entry: f32 squarings and the
        # gamma2 = solve(A dt, gamma1) - A^-1 B cancellation at the floor
        # leave both packages up to ~1e-2 from the float64 result
        scale = np.abs(t).max(axis=(-2, -1))
        err_t = np.abs(g - t).max(axis=(-2, -1)) / scale
        err_j = np.abs(w - t).max(axis=(-2, -1)) / scale
        assert np.all(err_t <= 1.5 * err_j + 1e-4), (field, float(
            (err_t - 1.5 * err_j).max()))


@pytest.mark.parametrize("name", ["default", "stiff"])
@pytest.mark.parametrize("n_clamped", [0, 5, 11])
def test_weights_with_x0_dir_match_jax(name, n_clamped):
    """intensity_sample_to_weight (linearize + FOH + the reverse weight
    recursion with the x0_dir steady-state term), windows partly or fully
    at the 100 ns floor included."""
    jp, jc, tp, tc = make_models(name)
    rng = np.random.default_rng(4)
    S, N = 12, 5
    it = rng.uniform(0.05, 1.1, (S, N)).astype(np.float32)
    dt = rng.uniform(1e5, 3e6, (S - 1, N)).astype(np.float32)
    dt[:n_clamped] = 100.0
    for sf in (False, True):
        want = np.asarray(jpb.intensity_sample_to_weight(
            jp, jc, jnp.asarray(it), jnp.asarray(dt), output_sf_log_it=sf))
        got = tpb.intensity_sample_to_weight(
            tp, tc, torch.from_numpy(it), torch.from_numpy(dt),
            output_sf_log_it=sf).detach().numpy()
        assert got.shape == want.shape == (S, N, 2 if sf else 1)
        # weights in [~1e-27, 1]: relative to the largest weight
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-5 * np.abs(want).max())
        # the x0_dir term makes the weights sum to the DC gain (= 1)
        np.testing.assert_allclose(got.sum(axis=0), 1.0, rtol=1e-3)


@pytest.mark.parametrize("name", ["default", "stiff"])
def test_sample_lifetimes_and_times_match_jax(name):
    """Lifetimes (exponential ICDF) and split sample times, with windows
    clamped to min_ts and floored steps."""
    jp, jc, tp, tc = make_models(name)
    rng = np.random.default_rng(5)
    S, N = 30, 8
    gen = rng.uniform(0.0, 1.0, (S - 1, N)).astype(np.float32)
    gen[:, :2] = 0.5
    lt_j = np.asarray(jpb.sample_lifetimes(jp, jc, jnp.asarray(gen)))
    lt_t = tpb.sample_lifetimes(tp, tc, torch.from_numpy(gen)).numpy()
    np.testing.assert_allclose(lt_t, lt_j, rtol=1e-6)
    min_ts = int(jc["min_ts"])
    # outputs from 1 us to 200 ms after min_ts: short ones clamp
    out_ts = min_ts + np.array([1_000, 1_000_000, 5_000_000, 20_000_000,
                                50_000_000, 100_000_000, 150_000_000,
                                200_000_000], np.int64)
    delta = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    jb, jd, jdt = jpb._sample_times(jp, jc, jnp.asarray(gen),
                                    jnp.asarray(out_ts), jnp.asarray(delta))
    tb, td, tdt = tpb._sample_times(tp, tc, torch.from_numpy(gen),
                                    torch.from_numpy(out_ts),
                                    torch.from_numpy(delta))
    # the same instants: lifetimes (up to 1.2e8 ns, an f32 ulp of 8 ns)
    # from two libms' log1p may differ by an ulp or two, and a delta may
    # round the other way between base and delta
    tol = 4 * float(np.spacing(np.float32(lt_j.max())))
    total = lambda b, d: (np.asarray(b) - min_ts).astype(np.float64) \
        + np.asarray(d)  # noqa: E731
    np.testing.assert_allclose(total(tb, td), total(jb, jd), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=0,
                               atol=2 * tol)
    clamped = np.asarray(jb) == min_ts
    np.testing.assert_array_equal(tb.numpy() == min_ts, clamped)
    assert tdt.min() >= tpb.MIN_SAMPLE_DT_NS
    assert (tdt == tpb.MIN_SAMPLE_DT_NS).any()  # some windows clamp
    assert tb.min() >= min_ts


def _sampling_fns(min_ts, x_j, x_t):
    """Analytic intensity at the split sample times, plus an additive
    (S, N) perturbation x whose gradient is d out / d intensity."""
    def jfn(ts, delta):
        t = (ts - min_ts).astype(jnp.float32) * 1e-9 + delta * 1e-9
        it = 0.3 + 0.2 * jnp.cos(40.0 * t) + 0.05 * jnp.sin(310.0 * t) + x_j
        return it, {"n": jnp.sum(it)}, it > 0

    def tfn(ts, delta):
        t = (ts - min_ts).to(torch.float32) * 1e-9 + delta * 1e-9
        it = 0.3 + 0.2 * torch.cos(40.0 * t) + 0.05 * torch.sin(310.0 * t) \
            + x_t
        return it, {"n": it.sum()}, it > 0
    return jfn, tfn


@pytest.mark.parametrize("name", ["default", "stiff"])
def test_forward_fused_outputs_and_grads_match_jax(name):
    jp, jc, tp, tc = make_models(name)
    rng = np.random.default_rng(6)
    S, N, R = 30, 3, 4
    min_ts = int(jc["min_ts"])
    # the R renders of a step share each event's base: the reset slice
    # (diff start) first, the consumer slices up to 2 ms later; event 0
    # sits 2 us after the dataset start, so its windows clamp
    base = min_ts + rng.integers(5_000_000, 300_000_000, N)
    base[0] = min_ts + 2_000
    out_ts = np.concatenate([base + off for off in
                             (0, 2_000_000, 500_000, 1_500_000)])
    gen = np.full((S - 1, R * N), 0.5, np.float32)
    gen[:, -1] = rng.uniform(0.0, 1.0, S - 1)
    delta = rng.uniform(-300.0, 300.0, R * N).astype(np.float32)
    x = np.zeros((S, R * N), np.float32)
    cot = rng.standard_normal(R * N).astype(np.float32)

    def jloss(p, d, xx):
        jfn, _ = _sampling_fns(min_ts, xx, None)
        out, aux, state = jpb.forward_fused(
            p, jc, jnp.asarray(gen), jnp.asarray(out_ts), d, jfn, N)
        return jnp.sum(out * cot), (out, state, aux[0]["n"])

    (_, (out_j, state_j, n_j)), g_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(delta),
                                                jnp.asarray(x))
    d_t = torch.from_numpy(delta).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    _, tfn = _sampling_fns(min_ts, None, x_t)
    out_t, aux_t, state_t = tpb.forward_fused(
        tp, tc, torch.from_numpy(gen), torch.from_numpy(out_ts), d_t, tfn, N)
    (out_t * torch.from_numpy(cot)).sum().backward()
    # aux passes through: the same intensities at the same sample times
    assert float(aux_t[0]["n"]) == pytest.approx(float(n_j), rel=1e-6)
    # log intensities ~ -1: f32 FOH and weight sums in another order
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state_t.reset_delta_log_it.detach().numpy(),
                               np.asarray(state_j.reset_delta_log_it),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(state_t.reset_ts.numpy(),
                                  np.asarray(state_j.reset_ts))
    _assert_grads(g_j, tp, d_t, x_t)


def _assert_grads(g_j, tp, d_t, x_t):
    """Gradients w.r.t. the six raw parameters, output_ts_delta and the
    sampled intensity.

    The parameter gradients are sums over every event and sample of
    float32 terms of both signs, through the expm chain: held to 1e-3 of
    the largest parameter gradient (a structurally zero one, such as
    tau_diff under the source-follower output, is rounding noise of that
    size in both packages; measured <= 1e-4).

    The output_ts_delta gradient of an event whose window clamps to the
    dataset start goes through the FOH backward at a last step of a few
    us, whose 1/dt^2-scale factors amplify float32 rounding: the two
    packages differ there by up to 1.5% of the largest gradient
    (measured), elsewhere by < 1e-5 relative. Held to 2e-2 of the
    largest."""
    g_params, g_delta, g_x = g_j
    scale = max(float(np.abs(np.asarray(v)).max()) for v in g_params.values())
    for k, v in g_params.items():
        got = tp[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=k)
    for got, want, tol in ((d_t.grad, g_delta, 2e-2), (x_t.grad, g_x, 1e-3)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("reset_diff", [True, False])
def test_forward_outputs_and_grads_match_jax(reset_diff):
    jp, jc, tp, tc = make_models("default")
    rng = np.random.default_rng(7)
    S, N = 12, 5
    out_ts = rng.integers(50_000_000, 400_000_000, N)
    gen = np.full((S - 1, N), 0.5, np.float32)  # the flagship's dirac
    gen[:, -1] = rng.uniform(0.0, 1.0, S - 1)
    delta = rng.uniform(-50.0, 50.0, N).astype(np.float32)
    x = np.zeros((S, N), np.float32)
    cot = rng.standard_normal(N).astype(np.float32)
    reset = (rng.normal(0, 0.1, N).astype(np.float32),
             out_ts - rng.integers(1_000, 5_000_000, N),
             rng.uniform(-0.5, 0.5, N).astype(np.float32))

    def jloss(p, d, xx):
        jfn, _ = _sampling_fns(0, xx, None)
        state = None if reset_diff else jpb.ResetState(
            *(jnp.asarray(r) for r in reset))
        out, _, state = jpb.forward(
            p, jc, jnp.asarray(gen), jnp.asarray(out_ts), jfn,
            reset_state=state, reset_diff=reset_diff, output_ts_delta=d)
        return jnp.sum(out * cot), (out, state)

    (_, (out_j, state_j)), g_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(delta),
                                                jnp.asarray(x))
    d_t = torch.from_numpy(delta).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    _, tfn = _sampling_fns(0, None, x_t)
    state = None if reset_diff else tpb.ResetState(
        *(torch.from_numpy(r) for r in reset))
    out_t, _, state_t = tpb.forward(
        tp, tc, torch.from_numpy(gen), torch.from_numpy(out_ts), tfn,
        reset_state=state, reset_diff=reset_diff, output_ts_delta=d_t)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        state_t.reset_delta_log_it.detach().numpy(),
        np.asarray(state_j.reset_delta_log_it), rtol=1e-4, atol=1e-6)
    _assert_grads(g_j, tp, d_t, x_t)


def test_effective_params_and_omega_c_dominant_match_jax():
    jp, jc, tp, tc = make_models("default")
    want = jpb.effective_params(jp)
    got = tpb.effective_params(tp)
    for k in tpb.PARAM_NAMES:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    it = np.random.default_rng(8).uniform(0.001, 1.0, 16).astype(np.float32)
    for reset_diff in (False, True):
        np.testing.assert_allclose(
            tpb.linearized_sys_omega_c_dominant(
                tp, tc, torch.from_numpy(it), reset_diff).detach().numpy(),
            np.asarray(jpb.linearized_sys_omega_c_dominant(
                jp, jc, jnp.asarray(it), reset_diff)), rtol=1e-5)
