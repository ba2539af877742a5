"""NGPField and VanillaNeRFField: the port, loaded with the JAX package's
initial parameters through `convert.params_from_jax`, against the JAX
field — outputs and every parameter gradient, with bf16 gathers, the
in-aabb selector, the level-mask curriculum and weight-normalized MLPs;
and `nerf_model.build` for `arch: mlp`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.models import fields as jfields
from deblur_e_nerf_tpu.models.contraction import ContractionType as JCT
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.models import fields as tfields
from deblur_e_nerf_tpu_torch.models.contraction import ContractionType

KW = dict(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), radiance_dim=1,
          pos_otype="HybridHashGrid", n_levels=6, base_resolution=4,
          per_level_scale=2.0, log2_hashmap_size=12,
          grid_compute_dtype="bfloat16", base_n_neurons=16,
          head_n_neurons=16)


def _fields(weight_norm=False):
    kw = dict(KW, base_weight_norm=weight_norm, head_weight_norm=weight_norm)
    jf = jfields.NGPField(contraction_type=JCT.AABB, **kw)
    x0 = jnp.zeros((4, 3), jnp.float32)
    params = jax.jit(jf.init)(jax.random.PRNGKey(0), x0, x0)["params"]
    # a wider table than the 1e-4 init so the encode matters
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["table"] = rng.normal(scale=0.5, size=params["table"].shape
                                 ).astype(np.float32)
    tf = tfields.NGPField(contraction_type=ContractionType.AABB, **kw)
    tf.load_state_dict(convert.params_from_jax(params), strict=True)
    return jf, params, tf


def _inputs(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("level_mask", [None, [1, 1, 1, 1, 0, 0]])
def test_ngp_field_outputs_and_grads_match_jax(level_mask,
                                               weight_norm=False):
    jf, params, tf = _fields(weight_norm)
    if weight_norm:  # the JAX Dense's `scale` becomes the port's `g`
        assert "scale" in params["mlp_base"]["hidden_0"]
        assert isinstance(tf.mlp_base.hidden_0, tfields.WeightNormDense)
    x, d = _inputs()
    rng = np.random.default_rng(2)
    w_rgb = rng.normal(size=(len(x), 1)).astype(np.float32)
    w_sigma = rng.normal(size=(len(x), 1)).astype(np.float32)
    jmask = None if level_mask is None else jnp.asarray(level_mask,
                                                         jnp.float32)

    def loss(p):
        rgb, sigma = jf.apply({"params": p}, jnp.asarray(x), jnp.asarray(d),
                              level_mask=jmask)
        return jnp.sum(rgb * w_rgb) + jnp.sum(sigma * w_sigma), (rgb, sigma)

    (_, (rgb_j, sigma_j)), grads_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    tmask = None if level_mask is None else torch.tensor(
        level_mask, dtype=torch.float32)
    rgb_t, sigma_t = tf(torch.from_numpy(x), torch.from_numpy(d),
                        level_mask=tmask)
    ((rgb_t * torch.from_numpy(w_rgb)).sum()
     + (sigma_t * torch.from_numpy(w_sigma)).sum()).backward()

    # f32 matmuls and sums in another order
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma_t.detach().numpy(),
                               np.asarray(sigma_j), rtol=1e-5, atol=1e-6)
    assert (sigma_t.detach().numpy()[np.any(np.abs(x) >= 1.5, -1)]
            == 0).all()  # the selector gates points outside the aabb
    want = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(tf.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(
            got[name].grad.numpy(), g.numpy(), rtol=1e-4,
            atol=1e-5 * max(scale, 1e-12), err_msg=name)
    if level_mask is not None:  # masked levels get no table gradient
        masked_rows = tf.levels[4][2]
        assert torch.count_nonzero(tf.table.grad[masked_rows:]) == 0


def test_weight_norm_ngp_field_outputs_and_grads_match_jax():
    """The NGP field with weight-normalized MLPs (mlp_base and mlp_head
    `weight_norm: true`), as the test above."""
    test_ngp_field_outputs_and_grads_match_jax(None, weight_norm=True)


def test_init_params_redraws_from_the_generator():
    from deblur_e_nerf_tpu_torch.models import nerf_model
    _, _, tf = _fields()
    model = nerf_model.NeRFModel(tf, None, None, "parameter", 1, 0)
    nerf_model.init_params(model, torch.Generator().manual_seed(3))
    a = {k: v.clone() for k, v in model.state_dict().items()}
    nerf_model.init_params(model, torch.Generator().manual_seed(3))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, a[k], rtol=0, atol=0)
    with torch.no_grad():
        assert float(tf.table.abs().max()) <= 1e-4  # U(-1e-4, 1e-4)
        bound = 1 / np.sqrt(tf.mlp_base.hidden_0.in_features)
        assert float(tf.mlp_base.hidden_0.weight.abs().max()) <= bound
        assert float(nerf_model.render_bkgd_value(model)) == pytest.approx(
            1.0)


VANILLA_KW = dict(aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), radiance_dim=3,
                  net_depth=5, net_width=32, skip_layer=2,
                  net_depth_condition=1, net_width_condition=16,
                  pos_encoder_max_deg=6, view_encoder_max_deg=3)


@pytest.mark.parametrize("weight_norm,activations", [
    (False, ("softplus", "shifted_trunc_exp", "softplus")),
    (True, ("relu", "shifted_softplus", "sigmoid"))])
def test_vanilla_field_outputs_and_grads_match_jax(weight_norm,
                                                   activations):
    """VanillaNeRFField (sinusoidal encodings with identity passthrough,
    the [-pi, pi] input scaling, skip connections after every skip_layer-th
    hidden layer, the bottleneck and rgb MLPs), with and without weight
    norm, against the JAX field: outputs within rtol 1e-5 and atol 1e-6,
    every gradient within rtol 1e-4 and 1e-5 of its largest entry (the NGP
    field test's tolerances), and `density` equal to the forward's."""
    hidden, density, radiance = activations
    kw = dict(VANILLA_KW, weight_norm=weight_norm, hidden_activation=hidden,
              density_activation=density, radiance_activation=radiance)
    jf = jfields.VanillaNeRFField(contraction_type=JCT.AABB, **kw)
    x, d = _inputs()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jf.init)(
        jax.random.PRNGKey(1), jnp.zeros((4, 3)), jnp.zeros((4, 3)))[
            "params"])
    tf = tfields.VanillaNeRFField(contraction_type=ContractionType.AABB,
                                  **kw)
    tf.load_state_dict(convert.params_from_jax(params), strict=True)
    # skip concat after hidden layers 2 and 4: 32 + 39 inputs
    assert tf.base.hidden_3.in_features == 32 + 39
    assert tf.base.out_features == 32 + 39
    rng = np.random.default_rng(3)
    w_rgb = rng.normal(size=(len(x), 3)).astype(np.float32)
    w_sigma = rng.normal(size=(len(x), 1)).astype(np.float32)

    def loss(p):
        rgb, sigma = jf.apply({"params": p}, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(rgb * w_rgb) + jnp.sum(sigma * w_sigma), (rgb, sigma)

    (_, (rgb_j, sigma_j)), grads_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    rgb_t, sigma_t = tf(torch.from_numpy(x), torch.from_numpy(d))
    ((rgb_t * torch.from_numpy(w_rgb)).sum()
     + (sigma_t * torch.from_numpy(w_sigma)).sum()).backward()
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma_t.detach().numpy(),
                               np.asarray(sigma_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tf.density(torch.from_numpy(x)).detach().numpy(),
        sigma_t.detach().numpy())
    want = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(tf.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(
            got[name].grad.numpy(), g.numpy(), rtol=1e-4,
            atol=1e-5 * max(scale, 1e-12), err_msg=name)
    with pytest.raises(ValueError, match="no grid levels"):
        tf.density(torch.from_numpy(x), level_mask=torch.ones(1))


def test_weight_norm_dense_initializes_as_the_jax_dense():
    """`g` starts at the rows' norms (w = v), with the 1e-12 floor: a zero
    row gives a zero weight row, not NaN."""
    layer = tfields.WeightNormDense(5, 3, torch.Generator().manual_seed(0))
    x = torch.randn(4, 5)
    plain = torch.nn.functional.linear(x, layer.v, layer.bias)
    torch.testing.assert_close(layer(x), plain, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        layer.v[1].zero_()
    assert torch.isfinite(layer(x)).all()
    assert torch.equal(layer(x)[:, 1], layer.bias[1].expand(4))


def test_nerf_model_builds_the_vanilla_field():
    """`arch: mlp` builds VanillaNeRFField at the config's `mlp:` widths,
    with no curriculum or table decay (it has no levels), and renders."""
    from deblur_e_nerf_tpu_torch.models import nerf_model
    from deblur_e_nerf_tpu_torch.utils.config import load_config

    cfg = load_config("configs/train/quality_sphere_blur32_dense_r5fix.yaml")
    nerf = cfg.model.nerf
    nerf.arch = "mlp"
    cams = np.array([[3.0, 0.0, 0.8], [0.0, 3.0, 0.8]], np.float32)
    model = nerf_model.build(nerf, cams, 1, "parameter", 4096,
                             generator=torch.Generator().manual_seed(0))
    field = model.field
    assert isinstance(field, tfields.VanillaNeRFField)
    assert field.base.net_depth == nerf.mlp.net_depth == 8
    assert field.base.hidden_0.out_features == 256
    assert field.base.hidden_5.in_features == 256 + 63  # skip after 4
    assert field.rgb_layer.hidden_0.out_features == 128
    assert model.curriculum is None and model.table_decay is None
    assert nerf_model.level_mask_for_step(model, 10_000, "cpu") is None
    assert model.render_config.prepass_div == 2
    occ = nerf_model.init_occupancy(model, "cpu")
    occ = occ._replace(binary=torch.ones_like(occ.binary))
    gen = torch.Generator().manual_seed(1)
    o = torch.tensor([[3.0, 0.1, 0.2]]).expand(8, 3)
    d = torch.nn.functional.normalize(torch.randn(8, 3, generator=gen)
                                      - o, dim=-1)
    out = nerf_model.render(model, occ, o, d, torch.ones(8, dtype=bool),
                            torch.rand(8, generator=gen))
    assert torch.isfinite(out["radiance"]).all()
    assert float(out["opacity"].detach().max()) > 0
    with pytest.raises(ValueError, match="unknown nerf arch"):
        nerf.arch = "tcnn"
        nerf_model.build(nerf, cams, 1, None, 4096)
