"""NGPField: the port, loaded with the JAX package's initial parameters
through `convert.params_from_jax`, against the JAX field — outputs and
every parameter gradient, with bf16 gathers, the in-aabb selector and the
level-mask curriculum."""

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


def _fields():
    jf = jfields.NGPField(contraction_type=JCT.AABB, **KW)
    x0 = jnp.zeros((4, 3), jnp.float32)
    params = jax.jit(jf.init)(jax.random.PRNGKey(0), x0, x0)["params"]
    # a wider table than the 1e-4 init so the encode matters
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["table"] = rng.normal(scale=0.5, size=params["table"].shape
                                 ).astype(np.float32)
    tf = tfields.NGPField(contraction_type=ContractionType.AABB, **KW)
    tf.load_state_dict(convert.params_from_jax(params), strict=True)
    return jf, params, tf


def _inputs(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("level_mask", [None, [1, 1, 1, 1, 0, 0]])
def test_ngp_field_outputs_and_grads_match_jax(level_mask):
    jf, params, tf = _fields()
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
