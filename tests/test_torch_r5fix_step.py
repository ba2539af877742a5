"""The r5fix training step (configs/train/quality_sphere_blur32_dense_r5fix
.yaml: the occlusion prepass at div 2, the density-sparsity prior, the
curriculum, superblock_budget 0) of the port against the JAX package's at
cut widths, on the JAX step's sample set (the machinery of
test_torch_train_step.py), from the initial field and from a dense one on
which the prepass culls."""

import jax
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.training import setup as tsetup
from deblur_e_nerf_tpu_torch.training import step as tstep
from deblur_e_nerf_tpu_torch.training import trainer as trainer_lib
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict
from test_torch_train_step import (ACTIVE, FILTER_ON_CASES,
                                   _assert_port_step_matches,
                                   _hand_jax_samples_to_port, _jax_draws,
                                   _jax_step)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_r5fix_ds")
    jsynthetic.make_dataset(str(root), img_height=16, img_width=16,
                            num_poses=21)
    return root


def r5fix_small_config(root, it_sample_size):
    """configs/train/quality_sphere_blur32_dense_r5fix.yaml (the occlusion
    prepass at div 2, the sparsity prior, the curriculum and the fine-table
    decay, superblock_budget 0) cut to test size: the small_config field
    widths and grid, 256 sparsity samples, and the default block budget in
    place of its 4,194,304 (sized for its full batch)."""
    cfg = jload_config("configs/train/quality_sphere_blur32_dense_r5fix.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.pixel_bandwidth.it_sample_size = it_sample_size
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 32
    cfg.model.nerf.block_budget = None
    cfg.data.train_init_eff_batch_size = ACTIVE
    cfg.loss.density_sparsity_samples = 256
    return cfg


def _dense_field(params):
    """The JAX initial parameters with the density raised (the raw-density
    output bias + 5), so that rays terminate and the prepass culls."""
    params = jax.tree_util.tree_map(np.array, params)
    params["nerf"]["field"]["mlp_base"]["output"]["bias"][0] += 5.0
    return params


# the r5fix steps of the JAX package: the initial field at S = 4 and 30,
# and the dense field at S = 4
R5FIX_CASES = {("init", 4): None, ("init", 30): None,
               ("dense", 4): _dense_field}


@pytest.fixture(scope="module")
def r5fix_jax(dataset):
    return {(field, s): _jax_step(r5fix_small_config(dataset, s), dataset,
                                  *FILTER_ON_CASES[s], params_fn=fn)
            for (field, s), fn in R5FIX_CASES.items()}


def _live_demand(metrics, budget):
    return round(float(metrics["prepass_overflow_rate"]) * (budget // 2))


@pytest.mark.parametrize("it_sample_size", sorted(FILTER_ON_CASES))
def test_r5fix_step_with_prepass_matches_jax(dataset, r5fix_jax, monkeypatch,
                                             it_sample_size):
    """The r5fix step (the occlusion prepass at div 2 in both packages) on
    the JAX step's sample set, from the initial parameters: the loss
    within 1e-6 (its terms within the filter-on tests' 1e-5), every
    gradient within 2e-4 of its largest entry, the same live demand (live
    samples compacted in the prepass buffer, prepass_overflow_rate x K /
    2)."""
    j = r5fix_jax["init", it_sample_size]
    assert j["sc"].loss_weight_sparsity > 0
    _hand_jax_samples_to_port(monkeypatch, j, dataset)
    metrics_t, _ = _assert_port_step_matches(
        j, dataset, samples_rtol=1e-6, grad_atol=2e-4, pb_grad_atol=2e-4)
    assert float(metrics_t["loss"].detach()) == pytest.approx(
        float(j["loss"]), rel=1e-6)
    live = _live_demand(metrics_t, j["budget"])
    assert live == _live_demand(j["metrics"], j["budget"]) > 0


def test_r5fix_step_on_a_dense_field_names_the_optical_depth_divergence(
        dataset, r5fix_jax, monkeypatch):
    """Names a divergence (ROADMAP Queue C 1). On a dense field (the raw
    density bias + 5: rays terminate after ~35 samples, so the prepass
    culls) both packages keep the same live samples (the port's float64
    live mask and the JAX package's double-f32 one put no sample on the
    other side of early_stop_eps: equal live demands, below the marched),
    and the port's loss is the same with and without the prepass (1e-7
    relative), as exact culling must give. The JAX package's loss differs
    from the port's by 2.6e-5 (measured on these inputs; held between
    1e-6 and 1e-4): its optical depth is a plain float32 cumsum inside
    each 32k block, which the culled samples' 25-clamped depths inflate
    (the JAX package's own exactness test allows 5e-4 on this field,
    tests/test_renderer.py)."""
    j = r5fix_jax["dense", 4]
    _hand_jax_samples_to_port(monkeypatch, j, dataset)
    cfg = ConfigDict.from_dict(j["cfg"].to_dict())
    losses = {}
    for div in (2, 0):
        cfg.model.nerf.occlusion_prepass_div = div
        tbundle, tparams = tsetup.build(cfg, str(dataset),
                                        sample_budget=j["budget"],
                                        device=torch.device("cpu"))
        tparams.load_state_dict(convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, j["params"])), strict=True)
        occ = j["occ"]
        loss, metrics = tstep.compute_loss(
            tparams, tbundle.consts, tocc.OccupancyGridState(
                torch.tensor(np.asarray(occ.occs)),
                torch.tensor(np.asarray(occ.binary))),
            {k: torch.tensor(v) for k, v in j["batch_np"].items()},
            _jax_draws(j["key"], j["capacity"], j["sc"], occ.binary),
            tbundle.static_config, tbundle.loss_config)
        losses[div] = float(loss.detach())
        if div:
            live = _live_demand(metrics, j["budget"])
            assert live == _live_demand(j["metrics"], j["budget"])
            assert 0 < live < int(metrics["num_marched_samples"])
            assert float(metrics["mean_valid_rate"]) > 0.5
    assert losses[2] == pytest.approx(losses[0], rel=1e-7)
    err = abs(losses[2] - float(j["loss"])) / abs(float(j["loss"]))
    assert 1e-6 < err < 1e-4, err


def test_chip_smoke_r5fix_config_is_the_yaml_with_its_listed_cuts():
    """Phase 8's config (read with the port's YAML reader; the card machine
    has no PyYAML) equals configs/train/quality_sphere_blur32_dense_r5fix
    .yaml as PyYAML reads it, but for the cuts the phase prints on its
    `reduced` line (the dataset, the steps and epochs, the seed, the stub
    LPIPS weights; the batch capacity 1024 and the dataset's size are
    printed beside them), and the launches a step implies."""
    import yaml

    import chip_smoke
    from test_torch_real_data import _with_changes

    path = "configs/train/quality_sphere_blur32_dense_r5fix.yaml"
    assert chip_smoke.R5FIX_CONFIG == path
    with open(path) as f:
        want = yaml.safe_load(f)
    cuts = dict(chip_smoke.R5FIX_REDUCED, **{
        "data.dataset_directory": "/data/r5fix",
        "metric.lpips_weights_path": "stub.pt"})
    assert set(cuts) == {"data.dataset_directory", "trainer.max_epochs",
                         "trainer.limit_train_batches", "seed",
                         "metric.lpips_weights_path"}
    got = chip_smoke.r5fix_config("/data/r5fix", "stub.pt").to_dict()
    assert got == _with_changes(want, cuts)
    assert chip_smoke.R5FIX_BATCH_CAPACITY == 1024
    assert chip_smoke.R5FIX_RECIPE == {"img_height": 192, "img_width": 192,
                                       "num_poses": 1501}
    # the launches of a step at the config's sizes: K + 1 = 1,228,801
    # slots, the prepass buffer 614,401, a 64^3 grid, 16 levels
    model = type("M", (), {})()
    model.field = type("F", (), {"levels": [None] * 16})()
    model.render_config = type("RC", (), dict(
        sample_budget=1_228_800, prepass_budget=614_400, field_chunk=0,
        grid_resolution=64, aabb=tuple(want["model"]["nerf"]["aabb"]),
        max_samples_per_ray=1024, render_step_size=3 ** 0.5 * 3 / 1024,
        cone_angle=0.0, superblock_budget=0))()
    trainer = type("T", (), {})()
    trainer.params = type("P", (), {"nerf": model})()
    # the config's sparsity prior: 4096 uniform cells, none targeted
    loss = want["loss"]
    trainer.bundle = type("B", (), {"static_config": type("S", (), dict(
        loss_weight_sparsity=loss["weight"]["density_sparsity"],
        sparsity_samples=loss["density_sparsity_samples"],
        sparsity_targeted_fraction=loss[
            "density_sparsity_targeted_fraction"]))()})()
    # one fused encode forward a field call, one backward a field backward
    # (K1 and K3 launch on no path), one weight-chain forward and backward
    # a step; the render kernels: the march's two compactions (no
    # superblock stage at superblock_budget 0) and its kernels (one masks
    # launch, the dense block stage, the sample stage, the decode), one
    # composite forward and one backward, and with the prepass one more
    # compaction and one more composite forward (its live mask); the
    # occupancy kernels: the prior's points, and a warmup update's points,
    # EMA (one chunk of the 64^3 grid) and threshold

    def step_launches(forward, backward, filter_forward, prepass,
                      update=False):
        return chip_smoke.encode_launches(
            forward, backward, filter_forward, render={
                "compact": 2 + prepass, "composite_fwd": 1 + prepass,
                "composite_bwd": 1, "march_masks": 1, "march_coarse": 1,
                "march_samples": 1, "march_decode": 1,
                "occ_points": 1 + update, "occ_ema": int(update),
                "occ_threshold": int(update), "occ_sample_occupied": 0})

    assert chip_smoke.r5fix_step_launches(trainer, True) \
        == step_launches(4, 2, 1, True, True)
    assert chip_smoke.r5fix_step_launches(trainer, False) \
        == step_launches(3, 2, 1, True)
    # a step the trainer runs without the prepass: the field over K + 1
    assert chip_smoke.r5fix_step_launches(trainer, True, False) \
        == step_launches(3, 2, 1, False, True)
    assert chip_smoke.r5fix_step_launches(trainer, False, False) \
        == step_launches(2, 2, 1, False)
    model.render_config.field_chunk = 1 << 18
    assert chip_smoke.r5fix_step_launches(trainer, False) \
        == step_launches(5 + 3 + 1, 3 + 1, 1, True)
    assert chip_smoke.r5fix_step_launches(trainer, False, False) \
        == step_launches(5 + 1, 5 + 1, 1, False)
    launches = chip_smoke.encode_launches
    assert launches(5, 4, 1, 0) == {
        "hash_encode_fwd": 5, "hash_encode_bwd": 4, "scatter_add_rows": 0,
        "gather_rows": 0, "pb_weight_fwd": 1, "pb_weight_bwd": 0}


def test_trainer_runs_the_prepass_only_once_the_live_demand_fits(
        dataset, tmp_path):
    """ROADMAP Queue C 9 (the JAX package always runs the prepass into its
    fixed K / 2 buffer, and drops the tail rays while a fresh field culls
    nothing): the port's Trainer starts without the prepass, reads each
    step's live demand one step behind, and runs the prepass once the
    demand x train_sample_budget_margin (1.25) of each of the last
    PREPASS_WINDOW (16) read steps fits the buffer. At K = 2^15 the fresh
    field's demand overflows the buffer on steps 0-1 (prepass_overflow_rate
    > 1), which run without the prepass and drop no ray; with the density
    raised from step 2 (the output bias + 10) the demand of steps 2-17
    fits, and step 19 (their reads one step behind) runs the prepass
    within its buffer. A read that does not fit turns it off again, and a
    resumed trainer starts without it."""
    assert trainer_lib.PREPASS_WINDOW == 16
    cfg = ConfigDict.from_dict(r5fix_small_config(dataset, 4).to_dict())
    cfg.model.nerf.block_budget = 1 << 15  # no coarse truncation
    trainer = Trainer(cfg, str(tmp_path), batch_capacity=32,
                      sample_budget=1 << 15, device="cpu")
    assert trainer.prepass_margin == 1.25 and not trainer.prepass_on
    ran, rates = [], []
    for step in range(20):
        if step == 2:
            with torch.no_grad():
                trainer.params.nerf.field.mlp_base.output.bias[0] += 10.0
        m = trainer.train_step()
        ran.append(float(m["prepass_ran"]))
        rates.append(float(m["prepass_overflow_rate"]))
        if step < 2:
            assert rates[-1] > 1.0 and float(m["ray_truncation_rate"]) == 0
    assert ran == [0.0] * 19 + [1.0], (ran, rates)
    assert all(r * trainer.prepass_margin <= 1.0 for r in rates[2:])
    trainer._flush_pending_metrics()
    assert trainer.prepass_on
    trainer._consume_metrics(20, ["prepass_overflow_rate", "loss",
                                  "update_skipped",
                                  "mean_num_samples_per_ray"],
                             torch.tensor([1.0, 0.5, 0.0, 10.0]), None)
    assert not trainer.prepass_on  # 1.0 x 1.25 does not fit
    path = trainer.save_checkpoint(0)
    trainer._prepass_fits, trainer.prepass_on = 99, True
    assert trainer.resume(path) == 0 and not trainer.prepass_on
