"""One filter-off training step of the port against the JAX package: the
loss, its terms and every parameter gradient, from the same weights
(`convert.params_from_jax`), the same occupancy grid, the same event batch
and the same random draws (the JAX package's draws from its step key,
handed to the port). Also the optimizer's update against the JAX optax
chain, and the trainer loop on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.data import events as jevents
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.models import nerf_model as jnerf
from deblur_e_nerf_tpu.training import optim as joptim
from deblur_e_nerf_tpu.training import pipeline as jpipeline
from deblur_e_nerf_tpu.training import setup as jsetup
from deblur_e_nerf_tpu.training import step as jstep
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.training import optim as toptim
from deblur_e_nerf_tpu_torch.training import setup as tsetup
from deblur_e_nerf_tpu_torch.training import step as tstep
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict

CAPACITY, ACTIVE, BUDGET = 32, 24, 1 << 15


def small_config(root, sparsity=0.0):
    """The in-repo flagship config, filter off, cut to test size."""
    cfg = jload_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.pixel_bandwidth.enable = False
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12      # dense 4, 8; hash 16; cellhash 32-128
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 32
    cfg.data.train_init_eff_batch_size = ACTIVE
    if sparsity:
        cfg.loss.weight.density_sparsity = sparsity
        cfg.loss.density_sparsity_samples = 256
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_step_ds")
    jsynthetic.make_dataset(str(root), img_height=16, img_width=16,
                            num_poses=21)
    return root


def _jax_draws(key, n, sc, occ_binary, sparsity_cfg=None):
    """The draws jax compute_loss makes from `key`, as port inputs."""
    k_norm, k_render = jax.random.split(key)
    normalized = jstep.draw_normalized_samples(k_norm, n, sc)
    draws = {
        "normalized": {k: torch.tensor(np.asarray(v))
                       for k, v in normalized.items()},
        "jitter": torch.tensor(np.asarray(jax.random.uniform(
            k_render, (4 * n,), jnp.float32))),
    }
    if sc.loss_weight_sparsity > 0:
        k_cells, k_occ, k_jitter = jax.random.split(
            jax.random.fold_in(key, 0x5FA), 3)
        n_tgt = int(round(sc.sparsity_samples
                          * sc.sparsity_targeted_fraction))
        k_fallback, k_occ2 = jax.random.split(k_occ)
        num_cells = occ_binary.shape[0]
        draws["sparsity"] = {
            "uniform_cells": torch.tensor(np.asarray(jax.random.randint(
                k_cells, (sc.sparsity_samples - n_tgt,), 0, num_cells,
                dtype=jnp.int32))),
            "occupied": {
                "fallback_cells": torch.tensor(np.asarray(
                    jax.random.randint(k_fallback, (n_tgt,), 0, num_cells,
                                       dtype=jnp.int32))),
                "u": torch.tensor(np.asarray(jax.random.uniform(
                    k_occ2, (n_tgt,), jnp.float32))),
            },
            "jitter": torch.tensor(np.asarray(jax.random.uniform(
                k_jitter, (sc.sparsity_samples, 3), jnp.float32))),
        }
    return draws


def test_filter_off_step_loss_and_grads_match_jax(dataset):
    # the flagship's loss terms plus the density sparsity prior
    cfg = small_config(dataset, sparsity=0.01)
    bundle, params = jsetup.build(cfg, str(dataset), sample_budget=BUDGET,
                                  batch_capacity=CAPACITY)
    model, sc = bundle.model, bundle.static_config
    assert not sc.pixel_bandwidth_enabled
    occ = jax.jit(lambda p: jnerf.update_occupancy(
        model, p, jnerf.init_occupancy(model), jax.random.PRNGKey(1),
        bundle.consts["trajectory"].T_wc_position, jnp.asarray(0)))(
            params["nerf"])
    events = jevents.EventDataset(str(dataset)).events
    batch_np = jpipeline.EventBatcher(events, CAPACITY, seed=0).next_batch(
        ACTIVE)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jstep.compute_loss(model, p, bundle.consts, occ,
                                  {k: jnp.asarray(v)
                                   for k, v in batch_np.items()},
                                  key, sc, bundle.loss_config)

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    tbundle, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                                    str(dataset), sample_budget=BUDGET,
                                    device=torch.device("cpu"))
    tparams.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tocc_state = tocc.OccupancyGridState(
        torch.tensor(np.asarray(occ.occs)), torch.tensor(np.asarray(
            occ.binary)))
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}
    draws = _jax_draws(key, CAPACITY, sc, occ.binary)
    loss_t, metrics_t = tstep.compute_loss(
        tparams, tbundle.consts, tocc_state, batch, draws,
        tbundle.static_config, tbundle.loss_config)
    loss_t.backward()

    # the same sample sets: integer statistics agree exactly
    for k in ("batch_size", "num_rays"):
        assert int(metrics_t[k]) == ACTIVE * (4 if k == "num_rays" else 1)
    for k in ("mean_num_samples_per_ray", "ray_truncation_rate",
              "mean_valid_rate", "block_overflow_rate"):
        assert float(metrics_t[k]) == pytest.approx(float(metrics_j[k]),
                                                    rel=1e-6), k
    assert 0 < float(metrics_t["mean_valid_rate"])
    # loss terms: f32 renders summed in another order
    assert "loss_density_sparsity" in metrics_j
    for k in [k for k in metrics_j if k.startswith("loss")]:
        assert float(metrics_t[k].detach()) == pytest.approx(
            float(metrics_j[k]), rel=1e-5, abs=1e-7), k
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)

    # every parameter gradient. Table rows: the JAX sort path sums each
    # row near-exactly, the port's scatter-add in f32 index order; MLP and
    # physics grads: f32 sums over all samples in another order, whose
    # error scales with the sum of |terms|, not with the (cancelling)
    # result. Measured on these inputs: at most 4.4e-5 of each gradient's
    # largest entry.
    want = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(tparams.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        g = g.numpy()
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=2e-4,
                                   atol=2e-4 * scale + 1e-15, err_msg=name)
    assert float(np.abs(got["nerf.field.table"].grad.numpy()).max()) > 0


def test_pixel_bandwidth_on_raises_with_roadmap_item(dataset):
    cfg = ConfigDict.from_dict(small_config(dataset).to_dict())
    cfg.model.pixel_bandwidth.enable = True
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        tsetup.build(cfg, str(dataset), device=torch.device("cpu"))


def test_optimizer_matches_optax_chain():
    """Three updates with the flagship's groups, coupled MLP weight decay,
    a milestone inside the window, a frozen group and the decoupled table
    row decay, against the JAX package's optax chain."""
    cfg = jload_config("configs/train/synthetic.yaml")
    cfg.lr_scheduler.interval = "step"
    cfg.lr_scheduler.multi_step_lr.milestones = [2]
    rng = np.random.default_rng(0)
    tree = {
        "nerf": {"field": {
            "table": rng.normal(size=(256, 2)).astype(np.float32),
            "mlp_base": {"hidden_0": {
                "kernel": rng.normal(size=(12, 8)).astype(np.float32),
                "bias": rng.normal(size=(8,)).astype(np.float32)}}},
            "render_bkgd_raw": rng.normal(size=(1,)).astype(np.float32)},
        "contrast_threshold": {
            "p2n_contrast_threshold_ratio_raw": np.float32(0.3),
            "mean_contrast_threshold_raw": np.float32(-1.2)},
        "refractory_period": {"refractory_period_logit": np.float64(-4.0)},
    }
    model_configs = {"contrast_threshold": cfg.model.contrast_threshold,
                     "refractory_period": cfg.model.refractory_period,
                     "nerf": cfg.model.nerf, "pixel_bandwidth": {}}
    model_configs["contrast_threshold"]["freeze"] = {"default": False}
    table_decay = (128, 0.5)
    tx, mask = joptim.build(
        jax.tree_util.tree_map(jnp.asarray, tree), cfg.optimizer,
        cfg.lr_scheduler, 1e-2, 1000.0, 10, model_configs,
        table_decay=table_decay)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(p_j)

    class Params(torch.nn.Module):
        pass

    module = Params()
    for name, value in convert.params_from_jax(tree).items():
        *parents, leaf = name.split(".")
        node = module
        for p in parents:
            if not hasattr(node, p):
                node.add_module(p, Params())
            node = getattr(node, p)
        node.register_parameter(leaf, torch.nn.Parameter(value))
    opt, tmask = toptim.build(module, cfg.optimizer, cfg.lr_scheduler, 1e-2,
                              1000.0, 10, model_configs,
                              table_decay=table_decay)
    assert tmask["refractory_period.refractory_period_logit"] is False
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=np.shape(p)), p.dtype),
            p_j)
        updates, state = tx.update(grads, state, p_j)
        p_j = jax.tree_util.tree_map(lambda p, u: p + u, p_j, updates)
        opt.zero_grad()
        for name, g in convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, grads)).items():
            param = dict(module.named_parameters())[name]
            if param.requires_grad:
                param.grad = g.to(param.dtype)
        assert opt.step()
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_optimizer_skips_nonfinite_updates():
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("p", p)])], [], 1.0)
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert not opt.step()
    assert opt.count == 0 and torch.equal(p.detach(), torch.ones(3))
    p.grad = torch.ones(3)
    assert not opt.step(loss=torch.tensor(float("inf")))
    assert opt.step(loss=torch.tensor(1.0)) and opt.count == 1


def test_trainer_runs_on_cpu_and_logs(dataset, tmp_path):
    cfg = ConfigDict.from_dict(small_config(dataset).to_dict())
    cfg.model.nerf.occ_grid.warmup_steps = 2
    cfg.model.nerf.occ_grid.n = 2
    cfg.trainer.log_every_n_steps = 1
    trainer = Trainer(cfg, str(tmp_path / "log"), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    table0 = trainer.params.nerf.field.table.detach().clone()
    trainer.train(max_steps=4)
    assert trainer.global_step == 4
    assert trainer.last_metrics is not None
    assert np.isfinite(trainer.last_metrics["loss"])
    assert not torch.equal(table0, trainer.params.nerf.field.table)
    lines = (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4
    # frozen contrast thresholds and refractory period did not move
    assert not trainer.params.refractory_period[
        "refractory_period_logit"].requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.evaluate()
