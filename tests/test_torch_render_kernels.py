"""The render layer's two scans (ops/compact.py, ops/composite.py) on the
CPU, where the wrappers run their plain versions: the compaction against
the JAX package's `_compact` bit for bit, the composite against its
`composite` (value and VJP), the backward kernel's arithmetic
(`composite_backward_model`) against autograd, the prepass's live mask
against the composite's, and a kernel call that cannot launch raising
rather than falling back. Inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import renderer as jr
from deblur_e_nerf_tpu_torch.ops import compact as compact_ops
from deblur_e_nerf_tpu_torch.ops import composite as composite_ops

N_LANES = 5000


def _flags_and_payloads(seed, n=N_LANES, p=0.3):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < p
    codes = np.sort(rng.integers(0, 10 * n, n)).astype(np.int64)
    values = rng.normal(size=n).astype(np.float32)
    return flags, codes, values


@pytest.mark.parametrize("budget_kind", ["below", "at", "above"])
@pytest.mark.parametrize("cutoff", [False, True])
def test_compact_matches_jax_bit_for_bit(budget_kind, cutoff):
    """One int64 channel (the march's codes) with its cutoff, or two more
    channels beside it (float32 and int64, the prepass's put), at budgets
    below, at and above the flag count: every buffer, the total and the
    cutoff equal JAX `_compact` channel by channel."""
    flags, codes, values = _flags_and_payloads(3)
    n_flagged = int(flags.sum())
    budget = {"below": n_flagged // 3, "at": n_flagged,
              "above": n_flagged + 77}[budget_kind]
    fill = 10 * N_LANES
    payloads = [codes] if cutoff else [codes, values, codes[::-1].copy()]
    fills = [fill] if cutoff else [fill, 0.0, -1]
    out = compact_ops.compact(
        torch.from_numpy(flags), [torch.from_numpy(p) for p in payloads],
        budget, fills, return_cutoff=cutoff)
    for k, (p, f) in enumerate(zip(payloads, fills)):
        want = jax.jit(jr._compact, static_argnums=(2, 3, 4))(
            jnp.asarray(flags), jnp.asarray(p), budget, f, cutoff)
        got_buf = out[0][k]
        assert got_buf.shape == (budget + 1,)
        assert got_buf.dtype == torch.from_numpy(p).dtype
        assert np.array_equal(got_buf.numpy(), np.asarray(want[0]))
        assert int(out[1]) == int(want[1]) == n_flagged
        if cutoff:
            assert int(out[2]) == int(want[2])
            dropped = budget_kind == "below"
            assert (int(out[2]) < fill) == dropped


def test_compact_of_no_flag_and_all_flags():
    """No lane flagged: every slot holds the fill, total 0, cutoff the
    fill. Every lane flagged with a budget of half: the first half, in
    order, and the cutoff is the first dropped code."""
    n = 1000
    codes = torch.arange(n, dtype=torch.int64) * 3
    (buf,), total, cut = compact_ops.compact(
        torch.zeros(n, dtype=torch.bool), [codes], 40, [-5], True)
    assert torch.equal(buf, torch.full((41,), -5)) and int(total) == 0 \
        and int(cut) == -5
    (buf,), total, cut = compact_ops.compact(
        torch.ones(n, dtype=torch.bool), [codes], n // 2, [10 ** 6], True)
    assert torch.equal(buf[:-1], codes[:n // 2]) and int(buf[-1]) == 10 ** 6
    assert int(total) == n and int(cut) == int(codes[n // 2])


def _buffer(seed, alpha_case):
    """A ray-contiguous buffer of 9 rays and K + 1 = 401 slots: dense rays
    that reach the early stop, a clamped sigma dt (one overflowed density,
    one large one), rays of 0 and 1 samples, and a last ray truncated at
    K; the empty slots after it hold ray_idx R."""
    rng = np.random.default_rng(seed)
    counts = np.array([60, 0, 45, 1, 70, 33, 90, 40, 120], np.int64)
    R, K = len(counts), 400
    offsets = np.cumsum(counts) - counts
    assert offsets[-1] < K < offsets[-1] + counts[-1]  # the last is cut
    n_in = K
    ray_idx = np.concatenate([np.repeat(np.arange(R), counts)[:n_in],
                              [R]]).astype(np.int64)
    dt = np.concatenate([rng.uniform(0.005, 0.02, n_in), [0.0]])
    t_mid = np.concatenate([np.sort(rng.uniform(1.0, 5.0, n_in)), [0.0]])
    sigma = rng.uniform(0.0, 8.0, K + 1)
    sigma[offsets[0]:offsets[0] + 60] = rng.uniform(60, 120, 60)  # stops
    sigma[offsets[4] + 3] = np.inf          # clamped at 25
    sigma[offsets[6] + 10] = 40000.0        # sigma dt above 25
    if alpha_case:
        sigma[offsets[5]:offsets[5] + 33:2] = 0.5  # alpha below 0.05
    rgb = rng.uniform(0, 1, (K + 1, 3))
    w = rng.normal(size=(R, 5))
    return dict(sigma=sigma.astype(np.float32), rgb=rgb.astype(np.float32),
                t_mid=t_mid.astype(np.float32), dt=dt.astype(np.float32),
                ray_idx=ray_idx, offsets=offsets, counts=counts, R=R,
                w=w.astype(np.float32))


def _port_args(b, sigma, rgb):
    return (sigma, rgb, torch.from_numpy(b["t_mid"]),
            torch.from_numpy(b["dt"]), torch.from_numpy(b["ray_idx"]),
            torch.from_numpy(b["offsets"]), torch.from_numpy(b["counts"]),
            b["R"])


def _jax_samples(b):
    n = len(b["dt"])
    return jr.RaySamples(
        t_mid=jnp.asarray(b["t_mid"]), dt=jnp.asarray(b["dt"]),
        ray_idx=jnp.asarray(b["ray_idx"], jnp.int32),
        counts=jnp.asarray(b["counts"], jnp.int32),
        offsets=jnp.asarray(b["offsets"], jnp.int32),
        num_samples=jnp.asarray(int(b["counts"].sum()), jnp.int32),
        num_blocks=jnp.zeros((), jnp.int32), num_superblocks=None,
        coarse_complete=jnp.ones(b["R"], bool)), n


def _loss(w, c, op, dep):
    return (c * w[:, :3]).sum() + (op * w[:, 3]).sum() + (dep * w[:, 4]).sum()


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
def test_composite_and_its_vjp_match_jax(alpha_thre):
    """ops.composite on CPU tensors (the plain version) against JAX
    `composite` and its VJP (the gradient of a weighted loss), at the
    tolerances of test_composite_and_its_gradient_match_jax (outputs rtol
    1e-4 atol 1e-6; gradients rtol 1e-4 atol 3e-4 of the largest entry:
    the JAX optical depth is a double-f32 sum, its gradient a float32
    cumsum's transpose), on a ray past the early stop, clamped samples,
    empty slots,
    a truncated ray and, with alpha_thre, masked samples; the live counts
    sum to JAX's num_rendering_samples, and the empty slots get exactly
    zero gradient."""
    b = _buffer(1, alpha_thre > 0)
    samples, _ = _jax_samples(b)
    R = b["R"]

    class RC:
        early_stop_eps = 1e-4

    RC.alpha_thre = alpha_thre

    def loss_j(sig, col):
        c, op, dep, n = jr.composite(sig, col, samples, R, RC)
        return _loss(b["w"], c, op, dep), (c, op, dep, n)

    (_, out_j), (gs_j, gc_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(jnp.asarray(b["sigma"]),
                                               jnp.asarray(b["rgb"]))
    sig = torch.tensor(b["sigma"], requires_grad=True)
    col = torch.tensor(b["rgb"], requires_grad=True)
    c, op, dep, live = composite_ops.composite(*_port_args(b, sig, col),
                                               1e-4, alpha_thre)
    _loss(torch.from_numpy(b["w"]), c, op, dep).backward()
    for got, want in zip((c, op, dep), out_j[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    assert int(live.sum()) == int(out_j[3])
    # the dense ray stopped early; the truncated ray kept its first slots
    assert int(live[0]) < b["counts"][0]
    for got, want in ((sig.grad, gs_j), (col.grad, gc_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=3e-4 * np.abs(want).max())
    empty = b["ray_idx"] == R
    assert not sig.grad[empty].any() and not col.grad[empty].any()
    clamped = ~np.isfinite(b["sigma"]) | (b["sigma"] * b["dt"] > 25)
    assert clamped.sum() == 2 and not sig.grad[clamped].any()


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
@pytest.mark.parametrize("precision", [torch.float32, torch.float64])
def test_backward_kernel_model_matches_autograd(alpha_thre, precision):
    """The backward kernel's arithmetic (`composite_backward_model`: the
    density cotangent as keep (g T e live - the ray's later w g) behind
    the clamp's and the validity's masks, the colour's as w gC) against
    autograd through `composite_reference`, in float32 (rtol 1e-5, atol
    1e-6 of the largest entry: products taken in another order) and float64
    (1e-12), with the cotangents nonzero everywhere."""
    b = _buffer(2, alpha_thre > 0)
    sig = torch.tensor(b["sigma"], dtype=precision, requires_grad=True)
    col = torch.tensor(b["rgb"], dtype=precision, requires_grad=True)
    args = _port_args(b, sig, col)
    c, op, dep, _ = composite_ops.composite_reference(*args, 1e-4, alpha_thre)
    rng = np.random.default_rng(4)
    gc, go, gd = (torch.tensor(rng.normal(size=t.shape), dtype=precision)
                  for t in (c, op, dep))
    torch.autograd.backward((c, op, dep), (gc, go, gd))
    ms, mc = composite_ops.composite_backward_model(
        sig.detach(), col.detach(), *args[2:], 1e-4, alpha_thre, gc, go, gd)
    tol = 1e-5 if precision == torch.float32 else 1e-12
    for got, want in ((ms, sig.grad), (mc, col.grad)):
        assert got.dtype == precision
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
def test_prepass_live_mask_is_the_composites(alpha_thre):
    """`live_mask` (the prepass's density-only call) slot by slot against
    the exclusive transmittance of each ray's float64 optical depth
    rounded to float32, and its per-ray counts against the composite's
    and JAX's occlusion prepass's live counts."""
    b = _buffer(5, alpha_thre > 0)
    sig = torch.from_numpy(b["sigma"])
    args = _port_args(b, sig, None)
    live, counts = composite_ops.live_mask(
        sig, *args[3:], 1e-4, alpha_thre)
    _, _, _, composite_counts = composite_ops.composite(
        sig, torch.from_numpy(b["rgb"]), *args[2:], 1e-4, alpha_thre)
    assert torch.equal(counts, composite_counts)
    R = b["R"]
    x = np.minimum(b["sigma"] * b["dt"] * (b["ray_idx"] < R), np.float32(25))
    alpha = 1 - np.exp(-x)
    if alpha_thre > 0:
        x = x * (alpha >= np.float32(alpha_thre))
    want = np.zeros(len(x), bool)
    for start, count in zip(b["offsets"], b["counts"]):
        end = min(start + count, len(x))
        seg = x[start:end].astype(np.float64)
        od = (np.cumsum(seg) - seg).astype(np.float32)
        want[start:end] = np.exp(-od) > np.float32(1e-4)
    want &= b["ray_idx"] < R
    assert np.array_equal(live.numpy(), want)
    assert np.array_equal(counts.numpy(), np.bincount(
        b["ray_idx"][want], minlength=R))

    samples, _ = _jax_samples(b)

    class RC:
        early_stop_eps = 1e-4
        prepass_budget = 300
        field_chunk = 0

    RC.alpha_thre = alpha_thre
    o = jnp.zeros((R, 3))
    _, demand, live_j = jr.occlusion_prepass(
        lambda p: jnp.asarray(b["sigma"])[:, None], samples, o, o, R, RC)
    assert np.array_equal(counts.numpy(), np.asarray(live_j))
    assert int(counts.sum()) == int(demand)


class _NotOnTheCpu(torch.Tensor):
    """A CPU tensor that reports itself on the card: the wrappers must take
    their kernel path for it and fail there."""

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return torch.Tensor._make_subclass(_NotOnTheCpu, t)


def test_a_card_call_raises_rather_than_falling_back(monkeypatch):
    """With a tensor that claims the card and no way to launch (no nvcc, no
    card here), compact and composite raise, launch nothing and never
    reach their plain versions; where a card is present, skipped."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "kernels")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    for module, name in ((compact_ops, "compact_reference"),
                         (composite_ops, "composite_reference"),
                         (composite_ops, "live_mask_reference")):
        monkeypatch.setattr(module, name, plain)
    counts = (compact_ops.LAUNCHES, composite_ops.FORWARD_LAUNCHES,
              composite_ops.BACKWARD_LAUNCHES)
    flags, codes, _ = _flags_and_payloads(0, n=100)
    with pytest.raises((RuntimeError, ValueError, OSError)):
        compact_ops.compact(_fake(torch.from_numpy(flags)),
                            [_fake(torch.from_numpy(codes))], 10, [0])
    b = _buffer(0, False)
    args = _port_args(b, _fake(torch.from_numpy(b["sigma"])),
                      _fake(torch.from_numpy(b["rgb"])))
    with pytest.raises((RuntimeError, ValueError, OSError)):
        composite_ops.composite(*args, 1e-4, 0.0)
    with pytest.raises((RuntimeError, ValueError, OSError)):
        composite_ops.live_mask(args[0], *args[3:], 1e-4, 0.0)
    assert counts == (compact_ops.LAUNCHES, composite_ops.FORWARD_LAUNCHES,
                      composite_ops.BACKWARD_LAUNCHES)
