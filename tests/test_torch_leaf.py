"""Leaf math of the port against the JAX package: quaternion slerp,
trajectory interpolation on split int64 timestamps, activations (with the
trunc-exp gradient clamp), SH encoding, contraction, samplers, the config
loader and the event packing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.data import events as jevents
from deblur_e_nerf_tpu.models import contraction as jcontraction
from deblur_e_nerf_tpu.models import sh_encoding as jsh
from deblur_e_nerf_tpu.models import trajectory as jtraj
from deblur_e_nerf_tpu.ops import activations as jact
from deblur_e_nerf_tpu.ops import quat as jquat
from deblur_e_nerf_tpu.ops import samplers as jsamplers
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch.data import events as tevents
from deblur_e_nerf_tpu_torch.models import contraction as tcontraction
from deblur_e_nerf_tpu_torch.models import sh_encoding as tsh
from deblur_e_nerf_tpu_torch.models import trajectory as ttraj
from deblur_e_nerf_tpu_torch.ops import activations as tact
from deblur_e_nerf_tpu_torch.ops import quat as tquat
from deblur_e_nerf_tpu_torch.ops import samplers as tsamplers
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict, load_config
from deblur_e_nerf_tpu_torch.utils.device import resolve_device


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shortest_path", [False, True])
def test_slerp_matches_jax(shortest_path):
    rng = np.random.default_rng(0)
    q0, q1 = _unit_quats(rng, 500), _unit_quats(rng, 500)
    q1[:5] = q0[:5]                      # zero relative rotation
    steps = rng.uniform(-0.2, 1.2, 500).astype(np.float32)
    want = np.asarray(jax.jit(jquat.unitquat_slerp, static_argnums=3)(
        jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(steps),
        shortest_path))
    got = tquat.unitquat_slerp(torch.from_numpy(q0), torch.from_numpy(q1),
                               torch.from_numpy(steps),
                               shortest_path=shortest_path).numpy()
    # f32 transcendental implementations differ by a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    rot_j = np.asarray(jax.jit(jquat.unitquat_to_rotmat)(want))
    rot_t = tquat.unitquat_to_rotmat(torch.tensor(want)).numpy()
    np.testing.assert_allclose(rot_t, rot_j, rtol=1e-6, atol=1e-6)


def test_trajectory_interpolation_matches_jax():
    rng = np.random.default_rng(1)
    C = 31
    ts = np.cumsum(rng.integers(10_000_000, 90_000_000, C)).astype(np.int64)
    poses = {"T_wc_position": rng.normal(size=(C, 3)).astype(np.float32),
             "T_wc_orientation": _unit_quats(rng, C),
             "T_wc_timestamp": ts}
    query = rng.integers(ts[0], ts[-1], 400).astype(np.int64)
    query[:3] = [ts[0], ts[-1], ts[7]]   # corners and an exact knot
    delta = rng.uniform(-0.5, 0.5, 400).astype(np.float32)
    jt = jtraj.make_trajectory(poses)
    pj, rj = jax.jit(jtraj.interpolate_pose)(jt, jnp.asarray(query),
                                             jnp.asarray(delta))
    tt = ttraj.make_trajectory(poses, "cpu")
    pt, rt = ttraj.interpolate_pose(tt, torch.from_numpy(query),
                                    torch.from_numpy(delta))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5,
                               atol=1e-5)


def test_activations_match_jax_with_trunc_exp_clamp():
    x = np.linspace(-30, 30, 601).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    tact.trunc_exp(xt).sum().backward()
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(jact.trunc_exp(v)))(
        jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-6)
    assert xt.grad.numpy().max() == pytest.approx(np.exp(15.0), rel=1e-6)
    for beta in (1.0, 100.0):
        np.testing.assert_allclose(
            tact.softplus(torch.from_numpy(x), beta=beta).numpy(),
            np.asarray(jact.softplus(jnp.asarray(x), beta=beta)),
            rtol=1e-6, atol=1e-7)
    y = np.linspace(0.01, 30, 50).astype(np.float32)
    np.testing.assert_allclose(
        tact.softplus_inverse(torch.from_numpy(y)).numpy(),
        np.asarray(jact.softplus_inverse(jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(
        tact.shifted_trunc_exp(torch.from_numpy(x[:400])).detach().numpy(),
        np.asarray(jact.shifted_trunc_exp(jnp.asarray(x[:400]))),
        rtol=1e-6)


@pytest.mark.parametrize("kind,name", [
    (kind, name) for kind, names in (
        ("hidden", ("softplus", "relu")),
        ("density", ("shifted_trunc_exp", "softplus", "shifted_softplus")),
        ("radiance", ("softplus", "sigmoid")),
        ("registry", ("relu", "sigmoid", "softplus", "softplus100",
                      "shifted_trunc_exp", "shifted_softplus", "identity")))
    for name in names])
def test_every_jax_activation_matches_jax(kind, name):
    """Each name of the JAX package's hidden, density and radiance
    registries and of its ACTIVATIONS table: values and gradients within
    1e-6 relative, over [-30, 30]."""
    x = np.linspace(-30, 30, 601).astype(np.float32)
    if kind == "registry":
        fj, ft = jact.ACTIVATIONS[name], tact.ACTIVATIONS[name]
    else:
        fj = getattr(jact, f"{kind}_activation")(name)
        ft = getattr(tact, f"{kind}_activation")(name)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = ft(xt)
    yt.sum().backward()
    yj, gj = jax.value_and_grad(lambda v: jnp.sum(fj(v)))(jnp.asarray(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(fj(
        jnp.asarray(x))), rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-30)
    with pytest.raises(ValueError, match="unknown"):
        tact.density_activation("gelu")


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encoding_matches_jax(degree):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.sh_encode(torch.from_numpy(d), degree).numpy(),
        np.asarray(jsh.sh_encode(jnp.asarray(d), degree)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["aabb", "sphere", "tanh"])
def test_aabb_contraction_matches_jax_and_others_raise(kind):
    """Each contraction and its inverse against the JAX package, on points
    inside and outside the aabb (rtol 1e-6), and the round trip (1e-5).
    (Before the sphere and tanh contractions were ported they raised.)"""
    aabb = np.array([-1.5, -1.0, -2.0, 1.5, 2.0, 2.0], np.float32)
    x = np.random.default_rng(3).uniform(-3, 3, (100, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.5, 0.0], [0.1, 0.4, 0.2], [1.4, 1.9, 1.9]]  # inside
    ct = tcontraction.ContractionType(kind)
    jct = jcontraction.ContractionType(kind)
    u = tcontraction.contract(torch.from_numpy(x), torch.from_numpy(aabb),
                              ct)
    u_j = np.asarray(jcontraction.contract(jnp.asarray(x),
                                           jnp.asarray(aabb), jct))
    np.testing.assert_allclose(u.numpy(), u_j, rtol=1e-6, atol=1e-7)
    back = tcontraction.contract_inv(u, torch.from_numpy(aabb), ct).numpy()
    np.testing.assert_allclose(back, np.asarray(jcontraction.contract_inv(
        jnp.asarray(u.numpy()), jnp.asarray(aabb), jct)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-5)
    if kind != "aabb":
        assert np.all((u.numpy() > 0) & (u.numpy() < 1))


def test_triangular_sampler_matches_jax():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jsamplers.triangular(key, (1000,), mode=0.0))
    u = np.asarray(jax.random.uniform(key, (1000,), jnp.float32))
    got = tsamplers.triangular(torch.tensor(u), mode=0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_config_loads_flagship_yaml_and_from_dict():
    cfg = load_config("configs/train/synthetic.yaml")
    assert cfg.to_dict() == jload_config(
        "configs/train/synthetic.yaml").to_dict()
    assert cfg.model.nerf.ngp.pos_encoding.otype == "HybridHashGrid"
    built = ConfigDict.from_dict(cfg.to_dict())
    assert built.model.nerf.occ_grid.resolution == 128
    built.model.nerf.occ_grid.resolution = 32  # a deep copy
    assert cfg.model.nerf.occ_grid.resolution == 128


def test_event_packing_matches_jax():
    rng = np.random.default_rng(5)
    n = 5000
    pos = rng.integers(0, 12, (n, 2)).astype(np.uint16)
    ts = np.sort(rng.integers(0, 10_000, n)).astype(np.int64)
    pol = rng.integers(0, 2, n).astype(bool)
    want = jevents.pack_events(pos, ts, pol, 12, 12)
    got = tevents.pack_events(pos, ts, pol, 12, 12)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tevents.extract_max_refractory_period(pos, ts, 12, 12) \
        == jevents.extract_max_refractory_period(pos, ts, 12, 12)
    col_w = jevents.colorize_events(want, "RGGB")["channel_idx"]
    col_t = tevents.colorize_events(got, "RGGB")["channel_idx"]
    np.testing.assert_array_equal(col_t, col_w)
    with pytest.raises(NotImplementedError, match="not supported"):
        tevents.undistort_events(got, "rational", np.array([0.1, 0.0]),
                                 np.eye(3))


@pytest.mark.parametrize("model,coeffs", [
    ("plumb_bob", [-0.1, 0.02, 1e-3, -1e-3]),
    ("plumb_bob", [-0.3, 0.1, 1e-3, -1e-3, 0.05]),
    ("plumb_bob", [-0.3, 0.1, 1e-3, -1e-3, 0.05, 0.01, 2e-3, 1e-3]),
    # the thin prism (s1-s4), then the tilted sensor (tauX, tauY)
    ("plumb_bob", [-0.3, 0.1, 1e-3, -1e-3, 0.05, 0.01, 2e-3, 1e-3, 2e-3,
                   -1e-3, 1.5e-3, 5e-4]),
    ("plumb_bob", [-0.3, 0.1, 1e-3, -1e-3, 0.05, 0.01, 2e-3, 1e-3, 2e-3,
                   -1e-3, 1.5e-3, 5e-4, 0.02, -0.015]),
    ("equidistant", [0.1, -0.05, 0.01, -2e-3]),
])
def test_undistort_events_matches_jax_cv2(model, coeffs):
    """The numpy undistortion against the JAX package's (cv2
    undistortPoints / fisheye.undistortPoints, P = K) on every pixel of a
    64x48 sensor: within 1e-6 px."""
    H, W = 48, 64
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.uint16)
    K = np.array([[50.0, 0.0, 31.5], [0.0, 52.0, 23.5], [0.0, 0.0, 1.0]])
    want = jevents.undistort_events({"position": pos}, model,
                                    np.array(coeffs), K)["position"]
    got = tevents.undistort_events({"position": pos}, model,
                                   np.array(coeffs), K)["position"]
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - pos).max() > 1.0  # a real distortion


def test_device_resolution_never_falls_back_quietly():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
