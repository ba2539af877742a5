"""The pixel-bandwidth weight chain's kernel module (ops/pb_weight.py) on
the CPU: the plain model of the backward kernel (`weight_backward_model`,
the hand-derived reverse of linearize + FOH + expm + the weight scan)
against jax.vjp of the JAX package's `intensity_sample_to_weight` and
against autograd of the port's plain chain; the forward model against
both; the wrapper's checks and its CPU dispatch. Inputs come from a numpy
seed, on the calibrations of tests/test_torch_pixel_bandwidth.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import pixel_bandwidth as jpb
from deblur_e_nerf_tpu_torch.models import pixel_bandwidth as tpb
from deblur_e_nerf_tpu_torch.ops import pb_weight
from test_torch_pixel_bandwidth import make_models
from torch_pb_plant import PLANTS, planted_entry, planted_weight


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes the chains'
    small batched ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_vjp(n_out):
    """jax.vjp of the JAX chain, jitted (one compile a shape)."""
    def vjp(params, consts, it, dt, g):
        _, pull = jax.vjp(lambda p, i, d: jpb.intensity_sample_to_weight(
            p, consts, i, d, output_sf_log_it=n_out == 2), params, it, dt)
        return pull(g)
    return jax.jit(vjp)


@functools.lru_cache(maxsize=None)
def _jax_weight(n_out):
    return jax.jit(lambda params, consts, it, dt:
                   jpb.intensity_sample_to_weight(
                       params, consts, it, dt, output_sf_log_it=n_out == 2))


def window(S, n_clamped, n_out, seed=4, N=5):
    """(intensity (S, N), dt (S-1, N), weight cotangent (S, N, o)), float32,
    the first `n_clamped` steps at the 100 ns floor (a window clamped to
    the dataset start)."""
    rng = np.random.default_rng(seed)
    it = rng.uniform(0.05, 1.1, (S, N)).astype(np.float32)
    dt = rng.uniform(1e5, 3e6, (S - 1, N)).astype(np.float32)
    dt[:n_clamped] = tpb.MIN_SAMPLE_DT_NS
    g = rng.standard_normal((S, N, n_out)).astype(np.float32)
    return it, dt, g


def model_grads(tp, tc, it, dt, g, n_out, dtype=torch.float32, skip=False):
    """The model's cotangents of (intensity, dt) and, through softplus, of
    the six raw parameters (in tp's key order); with `skip`, from the
    forward model's finiteness byte and saved systems, as the kernels run
    it."""
    raw = {k: v.detach().to(dtype).requires_grad_() for k, v in tp.items()}
    consts = {"tau_in_it_eff_prod": tc["tau_in_it_eff_prod"].to(dtype)}
    packed = tpb.packed_params(raw, consts)
    args = [packed.detach(), torch.from_numpy(it).to(dtype),
            torch.from_numpy(dt).to(dtype)]
    record = pb_weight.weight_forward_model(*args, n_out)[1:] if skip \
        else ()
    gi, gd, gp = pb_weight.weight_backward_model(
        *args, torch.from_numpy(g).to(dtype), n_out, *record)
    g_raw = torch.autograd.grad(packed, list(raw.values()), gp)
    return [gi, gd, *g_raw]


def autograd_grads(tp, tc, it, dt, g, n_out, dtype=torch.float32):
    """Autograd of the plain chain: the same cotangents."""
    raw = {k: v.detach().to(dtype).requires_grad_() for k, v in tp.items()}
    consts = {"tau_in_it_eff_prod": tc["tau_in_it_eff_prod"].to(dtype)}
    i_t = torch.from_numpy(it).to(dtype).requires_grad_()
    d_t = torch.from_numpy(dt).to(dtype).requires_grad_()
    w = tpb.weight_chain(tpb.packed_params(raw, consts), i_t, d_t,
                         n_out == 2)
    loss = (w * torch.from_numpy(g).to(dtype)).sum()
    return list(torch.autograd.grad(loss, [i_t, d_t, *raw.values()]))


def assert_grads_close(got, want, time_atol=2e-2):
    """The tolerances of test_forward_fused_outputs_and_grads_match_jax:
    rtol 1e-3 with atol 1e-3 of the intensity gradient's largest entry and
    of the largest parameter gradient, and `time_atol` of the dt
    gradient's largest entry."""
    got = [np.asarray(x, np.float64) for x in got]
    want = [np.asarray(x, np.float64) for x in want]
    scale = max(np.abs(w).max() for w in want[2:])
    for k, (a, b) in enumerate(zip(got[2:], want[2:])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=f"parameter {k}")
    for name, a, b, tol in (("intensity", got[0], want[0], 1e-3),
                            ("dt", got[1], want[1], time_atol)):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=tol * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("n_out", [1, 2])
@pytest.mark.parametrize("n_clamped", [0, 5, 11])
@pytest.mark.parametrize("S", [4, 12])
@pytest.mark.parametrize("name", ["default", "stiff"])
def test_backward_model_matches_jax_vjp(name, S, n_clamped, n_out):
    """The model's cotangents against jax.vjp of the JAX chain, and against
    autograd of the port's plain chain, in float32; the forward model
    against both chains' weights.

    Measured worst differences from JAX, relative to each gradient's
    largest entry: 3.9e-4 (intensity, parameters) and 7.8e-3 (dt, the
    default calibration with 5 clamped steps); from autograd 7e-4. Where
    every step is clamped the float32 gradients of every version are
    rounding noise (1e8-1e14 times the float64 embedding FOH's, in both
    packages), but the same noise: the model reverses the forward's own
    arithmetic, solves included."""
    jp, jc, tp, tc = make_models(name)
    it, dt, g = window(S, n_clamped, n_out)
    args = (jp, jc, jnp.asarray(it), jnp.asarray(dt))
    w_j = _jax_weight(n_out)(*args)
    gp_j, gi_j, gd_j = _jax_vjp(n_out)(*args, jnp.asarray(g))
    want = [gi_j, gd_j, *(gp_j[k] for k in tp.keys())]
    got = model_grads(tp, tc, it, dt, g, n_out)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert_grads_close(got, want)
    assert_grads_close(got, autograd_grads(tp, tc, it, dt, g, n_out))
    # the forward: the model is the plain chain's arithmetic, bit for bit;
    # JAX's within the tolerance test_weights_with_x0_dir_match_jax holds
    packed = tpb.packed_params(tp, tc).detach()
    w_m, finite, _ = pb_weight.weight_forward_model(
        packed, torch.from_numpy(it), torch.from_numpy(dt), n_out)
    w_p = pb_weight.weight_reference(packed, torch.from_numpy(it),
                                     torch.from_numpy(dt), n_out)
    assert torch.equal(w_m, w_p) and bool(finite.all())
    w_j = np.asarray(w_j)
    np.testing.assert_allclose(w_m.numpy(), w_j, rtol=0,
                               atol=5e-5 * np.abs(w_j).max())


@pytest.mark.parametrize("name,n_clamped", [("default", 0), ("stiff", 5),
                                            ("stiff", 29)])
def test_plain_chain_matches_jax_at_the_step_shape(name, n_clamped):
    """The flagship step's shape, S = 30 and M = 4 x 429 events (chip_smoke
    PB_CASES's inputs): the port's plain chain, which is the forward
    model bit for bit, and the JAX package compute the same float32
    algorithm in two orders, and over 49,764 systems of up to ~20
    squarings the largest weight difference grows to 2.3e-4 of the
    largest weight (measured; 5e-5 at test_weights_with_x0_dir_match_jax's
    5 events), held here within 2.5e-4. (The card's kernel is held to the
    plain version, not to JAX: chip_smoke.PB_STEP_FORWARD_ATOL.)"""
    import chip_smoke

    jp, jc, tp, tc = make_models(name)
    S, M = chip_smoke.PB_STEP_SHAPE
    case = chip_smoke.pb_weight_inputs(torch, name, S, M, n_clamped, 2,
                                       device="cpu")
    it, dt = case["intensity"], case["dt"]
    packed = tpb.packed_params(tp, tc).detach()  # JAX's raw values
    w_p = pb_weight.weight_reference(packed, it, dt, 2)
    assert torch.equal(w_p, pb_weight.weight_forward_model(packed, it, dt,
                                                           2)[0])
    w_j = np.asarray(_jax_weight(2)(jp, jc, jnp.asarray(it.numpy()),
                                    jnp.asarray(dt.numpy())))
    np.testing.assert_allclose(
        w_p.numpy(), w_j, rtol=0,
        atol=2.5e-4 * np.abs(w_j).max())


@pytest.mark.parametrize("n_clamped", [0, 5])
@pytest.mark.parametrize("name", ["default", "stiff"])
def test_backward_model_is_the_exact_adjoint_in_float64(name, n_clamped):
    """In float64 the model and autograd of the plain chain compute one
    derivative in two orders: equal to 1e-9 of each gradient's scale
    (measured <= 1e-13; a fully clamped window is left out, where even
    float64 is rounding noise)."""
    _, _, tp, tc = make_models(name)
    for n_out in (1, 2):
        it, dt, g = window(12, n_clamped, n_out)
        got = model_grads(tp, tc, it, dt, g, n_out, torch.float64)
        want = autograd_grads(tp, tc, it, dt, g, n_out, torch.float64)
        scale = max(float(w.abs().max()) for w in want[2:])
        for k, (a, b) in enumerate(zip(got, want)):
            tol = 1e-9 * (scale if k >= 2 else float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol, k


def test_backward_model_keeps_nan_where_the_plain_chain_has_it():
    """A NaN intensity or step: every weight and gradient the plain chain
    makes NaN, the model makes NaN too (a pivot search takes a NaN as the
    largest magnitude, as argmax does)."""
    _, _, tp, tc = make_models("default")
    it, dt, g = window(12, 0, 2)
    it[4, 1] = np.nan
    dt[7, 3] = np.nan
    packed = tpb.packed_params(tp, tc).detach()
    w_m, finite, _ = pb_weight.weight_forward_model(
        packed, torch.from_numpy(it), torch.from_numpy(dt), 2)
    w_p = pb_weight.weight_reference(packed, torch.from_numpy(it),
                                     torch.from_numpy(dt), 2)
    assert bool(torch.isnan(w_p).any())
    assert finite.tolist() == [True, False, True, False, True]
    assert bool(torch.isnan(w_m)[torch.isnan(w_p)].all())
    got = model_grads(tp, tc, it, dt, g, 2)
    want = autograd_grads(tp, tc, it, dt, g, 2)
    for a, b in zip(got, want):
        assert bool(torch.isnan(a)[torch.isnan(b)].all())
    assert bool(torch.isnan(want[0]).any())


def dead_window(name, plant):
    """A (12, 8) window, 5 clamped steps, whose columns 1, 2, 5 and 6 have
    a zero cotangent (the padded batch's invalid events); with `plant`
    "nan", dead column 6 has a NaN intensity."""
    it, dt, g = window(12, 5, 2, N=8)
    g[:, [1, 2, 5, 6]] = 0.0
    if plant == "nan":
        it[4, 6] = np.nan
    return it, dt, g


@pytest.mark.parametrize("plant", ["none", "nan"])
@pytest.mark.parametrize("name", ["default", "stiff"])
def test_backward_model_skips_zero_cotangent_columns_as_autograd(name,
                                                                 plant):
    """The model with the forward's finiteness byte and saved systems, as
    the backward kernel runs: on a column whose cotangent is exactly 0 it
    gives exactly what autograd of the plain chain gives, 0 where the
    column is finite, NaN where a planted NaN intensity reaches the
    reverse (its byte is unset, so it is not skipped: 0 * NaN); the live
    columns and the parameters as before, within the CPU tolerances."""
    _, _, tp, tc = make_models(name)
    it, dt, g = dead_window(name, plant)
    packed = tpb.packed_params(tp, tc).detach()
    _, finite, _ = pb_weight.weight_forward_model(
        packed, torch.from_numpy(it), torch.from_numpy(dt), 2)
    assert finite.tolist() == [True] * 6 + [plant == "none", True]
    got = model_grads(tp, tc, it, dt, g, 2, skip=True)
    want = autograd_grads(tp, tc, it, dt, g, 2)
    for a, b in zip(got[:2], want[:2]):
        for col in (1, 2, 5):
            assert bool((a[:, col] == 0).all() and (b[:, col] == 0).all())
        nan = torch.isnan(b[:, 6])
        assert bool(nan.any()) == (plant == "nan")
        assert bool(torch.isnan(a[:, 6])[nan].all())
        if plant == "none":
            assert bool((a[:, 6] == 0).all() and (b[:, 6] == 0).all())
    live = [0, 3, 4, 7]
    if plant == "nan":  # the NaN column's partials reach every parameter
        assert all(bool(torch.isnan(a).all()) for a in got[2:] + want[2:])
        got[2:] = want[2:] = [torch.ones(1)]
    assert_grads_close([got[0][:, live], got[1][:, live], *got[2:]],
                       [want[0][:, live], want[1][:, live], *want[2:]])


@pytest.mark.parametrize("name", ["default", "stiff"])
def test_backward_model_with_the_skip_equals_the_model_without(name):
    """On a mix of live and dead columns, the model run as the kernel runs
    it (the byte, the saved systems, the skip) and the model recomputing
    every column give equal cotangents, entry for entry (a skipped zero is
    +0 where the full reverse may give -0)."""
    _, _, tp, tc = make_models(name)
    it, dt, g = dead_window(name, "none")
    for a, b in zip(model_grads(tp, tc, it, dt, g, 2, skip=True),
                    model_grads(tp, tc, it, dt, g, 2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_clamped", [0, 5])
@pytest.mark.parametrize("name", ["default", "stiff"])
def test_float32_chains_against_a_float64_chain(name, n_clamped,
                                                monkeypatch):
    """The weight chain's float32 error at the flagship step's shape
    (chip_smoke.PB_STEP_SHAPE), against the port's plain chain in float64
    (JAX's float64 chain agrees with it within 1e-6 of the largest weight;
    measured 1.1e-8 and 1.6e-8): the port's float32 plain chain, its
    step-by-step model (the same bits) and JAX's float32 chain are all
    1.487e-2 (default) and 5.00e-3 (stiff; JAX 5.01e-3, the farthest) of
    the largest weight from it, with or without clamped steps, while they
    differ from each other by at most 2.3e-4
    (test_plain_chain_matches_jax_at_the_step_shape). The error is the
    float32 expm's (Pade-13 at theta_13 with the 1-norm scaling, then its
    squarings): with the expm alone in float64 the float32 chain comes
    within 9.0e-7 (default) and 1.4e-5 (stiff; 1.9e-4 with the clamped
    steps, whose (A dt)^-1 rounds next). chip_smoke's phase 3 prints the
    kernel's error against the same float64 chain on the card."""
    import chip_smoke
    from deblur_e_nerf_tpu_torch.ops import linalg

    jp, jc, tp, tc = make_models(name)
    S, M = chip_smoke.PB_STEP_SHAPE
    case = chip_smoke.pb_weight_inputs(torch, name, S, M, n_clamped, 2,
                                       device="cpu")
    it, dt = case["intensity"], case["dt"]
    packed = tpb.packed_params(tp, tc).detach()
    exact = pb_weight.weight_reference(packed.double(), it.double(),
                                       dt.double(), 2).numpy()
    scale = np.abs(exact).max()

    def error(w):
        return np.abs(np.asarray(w, np.float64) - exact).max() / scale

    def jax_weight(dtype):
        cast = functools.partial(jax.tree_util.tree_map,
                                 lambda x: jnp.asarray(x, dtype))
        return np.asarray(_jax_weight(2)(cast(jp), cast(jc),
                                         jnp.asarray(it.numpy(), dtype),
                                         jnp.asarray(dt.numpy(), dtype)))

    w_j64 = jax_weight(jnp.float64)
    assert w_j64.dtype == np.float64 and error(w_j64) <= 1e-6
    readings = {
        "plain": pb_weight.weight_reference(packed, it, dt, 2),
        "model": pb_weight.weight_forward_model(packed, it, dt, 2)[0],
        "jax": jax_weight(jnp.float32)}
    errors = {k: error(w) for k, w in readings.items()}
    print(f"{name}, {n_clamped} clamped: float32 error of the largest "
          f"weight {errors}")
    bound = {"default": 1.6e-2, "stiff": 5.5e-3}[name]
    assert all(e <= bound for e in errors.values()), errors
    assert max(errors.values()) - min(errors.values()) <= 2.5e-4
    # the expm alone in float64: the float32 chain's error falls 25x or more
    real = linalg.expm
    monkeypatch.setattr(linalg, "expm",
                        lambda a, *k: real(a.double(), *k).to(a.dtype))
    rest = error(pb_weight.weight_reference(packed, it, dt, 2))
    print(f"  with the expm in float64: {rest}")
    assert rest <= min(errors.values()) / 25


def _inputs(S=12, N=5, dtype=torch.float32):
    _, _, tp, tc = make_models("default")
    it, dt, _ = window(S, 0, 1, N=N)
    return (tpb.packed_params(tp, tc).detach().to(dtype),
            torch.from_numpy(it).to(dtype), torch.from_numpy(dt).to(dtype))


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_kernel_entries_check_their_inputs(entry):
    """The kernels' own limits raise before any launch: S - 1 above 32, a
    dtype other than float32, a non-contiguous input, and (last) a tensor
    that is not on the card."""

    def call(params, it, dt, n_out=2):
        if entry == "forward":
            return pb_weight.weight_forward(params, it, dt, n_out)
        g = torch.zeros((*it.shape, n_out), dtype=it.dtype)
        finite = torch.ones(it.shape[1:], dtype=torch.bool)
        systems = torch.zeros((*it.shape[1:], it.shape[0] - 1,
                               pb_weight.SYSTEM_FLOATS), dtype=it.dtype)
        return pb_weight.weight_backward(params, it, dt, g, n_out, finite,
                                         systems)

    params, it, dt = _inputs()
    before = (pb_weight.FORWARD_LAUNCHES, pb_weight.BACKWARD_LAUNCHES)
    with pytest.raises(ValueError, match="at most 32 systems"):
        call(*_inputs(S=34))
    with pytest.raises(TypeError, match="float32"):
        call(*_inputs(dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        call(params, it.t().contiguous().t(), dt)
    with pytest.raises(ValueError, match="does not fit"):
        call(params, it, dt[1:])
    with pytest.raises(ValueError, match="n_out"):
        call(params, it, dt, n_out=3)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        call(params, it, dt)
    assert (pb_weight.FORWARD_LAUNCHES,
            pb_weight.BACKWARD_LAUNCHES) == before


def test_cpu_dispatch_runs_the_plain_chain(monkeypatch):
    """On CPU tensors `weight` (and the model's intensity_sample_to_weight)
    runs the plain chain, rematerialized under a gradient, and never
    reaches the kernel library."""
    def no_library():
        raise AssertionError("the kernel library was reached on the CPU")

    monkeypatch.setattr(pb_weight, "_library", no_library)
    calls = []
    real = pb_weight.weight_reference

    def counting(*args):
        calls.append(len(args))
        return real(*args)

    monkeypatch.setattr(pb_weight, "weight_reference", counting)
    before = (pb_weight.FORWARD_LAUNCHES, pb_weight.BACKWARD_LAUNCHES)
    _, _, tp, tc = make_models("stiff")
    it, dt, g = window(12, 5, 2)
    i_t = torch.from_numpy(it).requires_grad_()
    d_t = torch.from_numpy(dt).requires_grad_()
    w = tpb.intensity_sample_to_weight(tp, tc, i_t, d_t,
                                       output_sf_log_it=True)
    (w * torch.from_numpy(g)).sum().backward()
    # the forward, then the checkpoint's recompute in the backward
    assert len(calls) == 2
    want = autograd_grads(tp, tc, it, dt, g, 2)
    for a, b in zip([i_t.grad, d_t.grad, *(tp[k].grad for k in tp.keys())],
                    want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with torch.no_grad():
        pb_weight.weight(tpb.packed_params(tp, tc), torch.from_numpy(it),
                         torch.from_numpy(dt), 2)
    assert len(calls) == 3
    assert (pb_weight.FORWARD_LAUNCHES,
            pb_weight.BACKWARD_LAUNCHES) == before


@pytest.mark.parametrize("plant", ["none", "nan", "every nan", "inf",
                                   "nan in both", "inf in both"])
def test_chip_smoke_forward_comparison_refuses_nan_where_plain_is_finite(
        plant):
    """chip_smoke.pb_forward_error, the card's forward comparison: a NaN or
    an infinity in the kernel's weights where the plain chain's are finite
    is never within the tolerance; NaN and infinities in both, at the same
    entries, are left out of the error."""
    import chip_smoke

    want = torch.from_numpy(
        np.random.default_rng(0).uniform(0.1, 1.0, (12, 5, 2))
        .astype(np.float32))
    got = want + 1e-7
    if plant == "nan":
        got[3, 2, 0] = float("nan")
    elif plant == "every nan":
        got = got * float("nan")
    elif plant == "inf":
        got[3, 2, 0] = float("inf")
    elif plant.endswith("in both"):
        value = float("nan" if plant.startswith("nan") else "inf")
        want[3, 2, 0] = got[3, 2, 0] = value
    err, scale, same_nonfinite = chip_smoke.pb_forward_error(torch, got, want)
    within = err <= chip_smoke.PB_FORWARD_ATOL * scale and same_nonfinite
    assert within == (plant in ("none", "nan in both", "inf in both"))
    if within:
        assert 0 < err <= 2e-7 and scale == float(want[torch.isfinite(want)]
                                                   .max())


RULE_CASES = ("ill-conditioned", "step shape")


@pytest.fixture(scope="module", params=RULE_CASES)
def rule_case(request):
    """A reduced case of chip_smoke's step-scale rule on the CPU, with the
    plain chain's float32 and float64 references: "ill-conditioned" (S =
    30, 2,048 columns, the steps / 1000: 100-3,000 ns, where every column
    of the float32 chain is far from float64) or "step shape" (phase 3's
    default case, S = 30, at 512 columns, where some columns are
    well-conditioned)."""
    import chip_smoke

    if request.param == "ill-conditioned":
        case = chip_smoke.pb_conditioning_case(torch, "default", 1000,
                                               M=2048, device="cpu")
    else:
        case = chip_smoke.pb_weight_inputs(
            torch, "default", chip_smoke.PB_STEP_SHAPE[0], 512, 0, 2,
            device="cpu")
    return request.param, case, chip_smoke.pb_plain_references(torch, case)


def test_step_scale_rule_passes_the_float32_plain_chain(rule_case):
    """chip_smoke.pb_accuracy_check (ROADMAP C13) with the float32 plain
    chain in the kernels' place (`weight` runs it on CPU tensors): it
    passes, column by column within 1 / PB_STEP_FACTOR of each limit, and
    its own float32 gate, with no launch counted; on the ill-conditioned
    case, where that chain is itself far from float64 (the case the rule
    is for), and on the step's shape, where it is near float64 in some
    columns."""
    import chip_smoke

    name, case, references = rule_case
    c = chip_smoke.pb_accuracy_check(torch, case, references=references,
                                     float32_gate=True)
    print(chip_smoke.pb_accuracy_text(c))
    assert c["ok"] and c["float32_ok"], c
    assert c["launches"] == (0, 0)
    assert all(r <= 1 / chip_smoke.PB_STEP_FACTOR
               for r in [c["fwd_reading"], *c["bwd_readings"].values()])
    assert set(c["bwd"]) == {"intensity", "dt", "params"}
    assert c["fwd"]["columns"] == case["intensity"][0].numel()
    assert c["bwd"]["params"]["columns"] == 7
    if name == "ill-conditioned":
        # the float32 chain is far from float64 in every column: 2e-2 of
        # the largest weight, and hundreds of tolerances on each cotangent
        assert c["fwd"]["plain_max"] > 1e-2
        assert c["fwd"]["well_conditioned"] == 0
        assert min(d["plain_max"] for d in c["bwd"].values()) > 100
    else:
        assert c["fwd"]["well_conditioned"] > 0
        assert c["bwd"]["intensity"]["well_conditioned"] > 0


@pytest.mark.parametrize("plant", list(PLANTS))
def test_step_scale_rule_on_planted_errors(rule_case, monkeypatch, plant):
    """chip_smoke.pb_accuracy_check with one entry planted off the float64
    chain: beyond its column's limit (PB_STEP_FACTOR times the float32
    plain chain's column error plus the slack), in the column where that
    chain is farthest from float64 or in the one where it is nearest (on
    the step's shape a well-conditioned column, where the planted weight
    is 2e-4 of the largest beyond the plain chain's error: the entry the
    largest error over every column does not see), or a NaN where the
    plain chain is finite, is refused; half a slack within the limit
    passes."""
    import chip_smoke

    name, case, references = rule_case
    what, column, size = PLANTS[plant]
    _, _, e_plain, limit = planted_entry(references, what, column, size)
    monkeypatch.setattr(pb_weight, "weight", planted_weight(
        references, what, column, size))
    c = chip_smoke.pb_accuracy_check(torch, case, references=references)
    print(plant, chip_smoke.pb_accuracy_text(c))
    assert c["bitwise"] and c["launches"] == (0, 0)
    slack = chip_smoke.PB_STEP_FORWARD_ATOL if what == "forward" \
        else chip_smoke.PB_STEP_BACKWARD_SLACK
    if column == "best" and name == "step shape":
        # a well-conditioned column: the plain chain within the slack
        assert chip_smoke.PB_STEP_FACTOR * e_plain <= slack
        if what == "forward" and size > 0:
            assert limit + size * slack - e_plain >= 2e-4
    if size < 0:
        assert c["ok"], c
    elif what == "forward":
        assert not c["fwd_ok"] and c["bwd_ok"] and not c["ok"]
        assert size != size or c["fwd_reading"] > 1
        assert size == size or not c["same_nonfinite"]
    else:
        assert c["fwd_ok"] and not c["bwd_ok"] and not c["ok"]
        assert c["bwd_readings"]["intensity"] > 1
