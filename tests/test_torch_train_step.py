"""One training step of the port against the JAX package, with the
pixel-bandwidth filter off and on: the loss, its terms and every
parameter gradient, from the same weights (`convert.params_from_jax`), the
same occupancy grid, the same event batch and the same random draws (the
JAX package's draws from its step key, handed to the port). Also the
optimizer's update against the JAX optax chain, and the trainer loop on
the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur_e_nerf_tpu.data import events as jevents
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu.models import contraction as jcontraction
from deblur_e_nerf_tpu.models import nerf_model as jnerf
from deblur_e_nerf_tpu.models import pixel_bandwidth as jpb
from deblur_e_nerf_tpu.models import renderer as jrenderer
from deblur_e_nerf_tpu.models import trajectory as jtrajectory
from deblur_e_nerf_tpu.training import optim as joptim
from deblur_e_nerf_tpu.training import pipeline as jpipeline
from deblur_e_nerf_tpu.training import setup as jsetup
from deblur_e_nerf_tpu.training import step as jstep
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.models import nerf_model as tnerf
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.models import pixel_bandwidth as tpb
from deblur_e_nerf_tpu_torch.models import renderer as trenderer
from deblur_e_nerf_tpu_torch.models import trajectory as ttrajectory
from deblur_e_nerf_tpu_torch.training import checkpoint as tcheckpoint
from deblur_e_nerf_tpu_torch.training import evaluation as tevaluation
from deblur_e_nerf_tpu_torch.training import optim as toptim
from deblur_e_nerf_tpu_torch.training import setup as tsetup
from deblur_e_nerf_tpu_torch.training import step as tstep
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict

CAPACITY, ACTIVE, BUDGET = 32, 24, 1 << 15


def small_config(root, sparsity=0.0, it_sample_size=None):
    """The in-repo flagship config cut to test size: filter off, or on
    with `it_sample_size` lifetime samples."""
    cfg = jload_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.pixel_bandwidth.enable = it_sample_size is not None
    if it_sample_size is not None:
        cfg.model.pixel_bandwidth.it_sample_size = it_sample_size
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
            k_render, (tstep.n_rendered_rays(sc, n),), jnp.float32))),
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


def _jax_step(cfg, dataset, capacity, active, budget, params_fn=None):
    """The JAX step's loss, metrics and gradients, with its inputs
    (`params_fn` edits the initial parameters first)."""
    bundle, params = jsetup.build(cfg, str(dataset), sample_budget=budget,
                                  batch_capacity=capacity)
    if params_fn is not None:
        params = params_fn(params)
    model, sc = bundle.model, bundle.static_config
    occ = jax.jit(lambda p: jnerf.update_occupancy(
        model, p, jnerf.init_occupancy(model), jax.random.PRNGKey(1),
        bundle.consts["trajectory"].T_wc_position, jnp.asarray(0)))(
            params["nerf"])
    events = jevents.EventDataset(str(dataset)).events
    batch_np = jpipeline.EventBatcher(events, capacity, seed=0).next_batch(
        active)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jstep.compute_loss(model, p, bundle.consts, occ,
                                  {k: jnp.asarray(v)
                                   for k, v in batch_np.items()},
                                  key, sc, bundle.loss_config)

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return dict(cfg=cfg, sc=sc, params=params, occ=occ, batch_np=batch_np,
                key=key, loss=loss_j, metrics=metrics_j, grads=grads_j,
                capacity=capacity, active=active, budget=budget)


def _assert_port_step_matches(j, dataset, samples_rtol=1e-6, grad_atol=2e-4,
                              pb_grad_atol=None, loss_rtol=1e-5):
    """The port's compute_loss on the JAX step's inputs against it.

    samples_rtol: tolerance on the mean marched samples per ray (exact,
    1e-6, when both packages march the same sample set); loss_rtol: on
    the loss and its terms;
    grad_atol: each gradient's tolerance as a fraction of its largest
    entry; pb_grad_atol: the filter parameters' tolerance as a fraction of
    the largest filter-parameter gradient."""
    cfg, sc, capacity, active = j["cfg"], j["sc"], j["capacity"], \
        j["active"]
    tbundle, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                                    str(dataset), sample_budget=j["budget"],
                                    device=torch.device("cpu"))
    assert tuple(tbundle.static_config) == tuple(sc)
    tparams.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j["params"])), strict=True)
    occ = j["occ"]
    tocc_state = tocc.OccupancyGridState(
        torch.tensor(np.asarray(occ.occs)), torch.tensor(np.asarray(
            occ.binary)))
    batch = {k: torch.tensor(v) for k, v in j["batch_np"].items()}
    draws = _jax_draws(j["key"], capacity, sc, occ.binary)
    loss_t, metrics_t = tstep.compute_loss(
        tparams, tbundle.consts, tocc_state, batch, draws,
        tbundle.static_config, tbundle.loss_config)
    loss_t.backward()
    metrics_j = j["metrics"]

    # the same sample sets: integer statistics agree exactly
    s = sc.it_sample_size if sc.pixel_bandwidth_enabled else 1
    assert int(metrics_t["batch_size"]) == active
    assert int(metrics_t["num_rays"]) == active * 4 * s
    assert float(metrics_t["mean_num_samples_per_ray"]) == pytest.approx(
        float(metrics_j["mean_num_samples_per_ray"]), rel=samples_rtol)
    for k in ("ray_truncation_rate", "mean_valid_rate",
              "block_overflow_rate"):
        assert float(metrics_t[k]) == pytest.approx(float(metrics_j[k]),
                                                    rel=1e-6), k
    assert 0 < float(metrics_t["mean_valid_rate"])
    # loss terms: f32 renders summed in another order
    for k in [k for k in metrics_j if k.startswith("loss")]:
        assert float(metrics_t[k].detach()) == pytest.approx(
            float(metrics_j[k]), rel=loss_rtol, abs=1e-7), k
    assert float(loss_t.detach()) == pytest.approx(float(j["loss"]),
                                                   rel=loss_rtol)

    # every parameter gradient. Table rows: the JAX sort path sums each
    # row near-exactly, the port's scatter-add in f32 index order; MLP and
    # physics grads: f32 sums over all samples in another order, whose
    # error scales with the sum of |terms|, not with the (cancelling)
    # result. Measured on these inputs (filter off): at most 4.4e-5 of
    # each gradient's largest entry.
    want = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j["grads"]))
    got = dict(tparams.named_parameters())
    assert set(want) == set(got)
    pb_scale = max([float(g.abs().max()) for name, g in want.items()
                    if name.startswith("pixel_bandwidth.")], default=0.0)
    for name, g in want.items():
        g = g.numpy()
        if name.startswith("pixel_bandwidth."):
            atol = pb_grad_atol * pb_scale
        else:
            atol = grad_atol * float(np.abs(g).max()) + 1e-15
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=2e-4,
                                   atol=atol, err_msg=name)
    assert float(np.abs(got["nerf.field.table"].grad.numpy()).max()) > 0
    return metrics_t, got


def test_filter_off_step_loss_and_grads_match_jax(dataset):
    # the flagship's loss terms plus the density sparsity prior
    cfg = small_config(dataset, sparsity=0.01)
    j = _jax_step(cfg, dataset, CAPACITY, ACTIVE, BUDGET)
    assert not j["sc"].pixel_bandwidth_enabled
    assert "loss_density_sparsity" in j["metrics"]
    _assert_port_step_matches(j, dataset)


# (S, capacity, active events, sample budget): S = 4 at the filter-off
# test's batch, and the flagship's S = 30 at a handful of events
FILTER_ON_CASES = {4: (CAPACITY, ACTIVE, 4 * BUDGET), 30: (8, 4, 8 * BUDGET)}


@pytest.fixture(scope="module")
def filter_on_jax(dataset):
    """The JAX filter-on steps, compiled once for the module."""
    return {s: _jax_step(small_config(dataset, it_sample_size=s), dataset,
                         *case) for s, case in FILTER_ON_CASES.items()}


@pytest.mark.parametrize("it_sample_size", sorted(FILTER_ON_CASES))
def test_filter_on_step_loss_and_grads_match_jax(dataset, filter_on_jax,
                                                 it_sample_size):
    j = filter_on_jax[it_sample_size]
    assert j["sc"].pixel_bandwidth_enabled
    assert j["sc"].it_sample_size == it_sample_size
    # The S x 4 x N rays' poses go through slerp's transcendental
    # functions, whose float32 results differ by an ulp between XLA and
    # torch; with 384-480 rays one sample of ~1.3e5 lands on the other
    # side of a march boundary (measured: 1 sample, in both cases), which
    # moves one ray's intensity. Its effect, measured on these inputs: the
    # losses within 1e-6, the field gradients within 4.7e-4 of their
    # largest entry, and the filter-parameter gradients (sums over events
    # that cancel to ~1e-5) within 3e-3 of the largest of them; a 3e-7
    # perturbation of the jitter alone moves the latter by 2e-4.
    _, got = _assert_port_step_matches(j, dataset, samples_rtol=2e-5,
                                       grad_atol=1e-3, pb_grad_atol=5e-3)
    # the six filter parameters and the refractory period (whose gradient
    # reaches the timestamps through the sample steps and the reset decay)
    # get non-zero gradients
    for name in ("pixel_bandwidth.tau_diff_raw",
                 "pixel_bandwidth.tau_mil_it_eff_prod_raw",
                 "refractory_period.refractory_period_logit"):
        assert float(got[name].grad.abs()) > 0, name


def _hand_jax_samples_to_port(monkeypatch, j, dataset):
    """Make the port's filter-on step render the JAX step's sample set: the
    port's sample lifetimes, poses, ray directions and march take the JAX
    package's values (the poses and directions keep the port's gradient
    through a straight-through difference, which is exact when the two
    differ by ulps). What stays the port's own: the filter's weights
    (expm, FOH), the field, the compositing, the loss and every
    gradient."""
    jbundle, _ = jsetup.build(j["cfg"], str(dataset),
                              sample_budget=j["budget"],
                              batch_capacity=j["capacity"])
    jconsts = jbundle.consts

    def sample_lifetimes(params, consts, normalized_interval_gen):
        return torch.tensor(np.asarray(jax.jit(
            lambda g: jpb.sample_lifetimes(None, jconsts["pixel_bandwidth"],
                                           g))(
                normalized_interval_gen.numpy())))

    port_pose = ttrajectory.interpolate_pose

    def interpolate_pose(trajectory, timestamp, timestamp_delta=None):
        pos, orient = port_pose(trajectory, timestamp, timestamp_delta)
        pos_j, orient_j = jax.jit(
            lambda t, dt: jtrajectory.interpolate_pose(
                jconsts["trajectory"], t, dt))(
            timestamp.numpy(), timestamp_delta.detach().numpy())
        return (pos + (torch.tensor(np.asarray(pos_j)) - pos).detach(),
                orient + (torch.tensor(np.asarray(orient_j))
                          - orient).detach())

    port_ray = tnerf.pixel_params_to_ray

    def pixel_params_to_ray(intrinsics_inv, pixel, pos, orient):
        rays_o, rays_d = port_ray(intrinsics_inv, pixel, pos, orient)
        _, d_j = jax.jit(jnerf.pixel_params_to_ray)(
            intrinsics_inv.numpy(), pixel.numpy(), pos.detach().numpy(),
            orient.detach().numpy())
        return rays_o, rays_d + (torch.tensor(np.asarray(d_j))
                                 - rays_d).detach()

    def march_rays(binary, rays_o, rays_d, ray_mask, jitter, rc):
        fields = {f: getattr(rc, f)
                  for f in jrenderer.RenderConfig.__dataclass_fields__
                  if hasattr(rc, f)}
        fields["contraction_type"] = jcontraction.ContractionType[
            rc.contraction_type.name]
        jrc = jrenderer.RenderConfig(**fields)
        assert jrc.stratified
        # the JAX march draws its jitter from a key: hand it the port's
        with monkeypatch.context() as m:
            m.setattr(jax.random, "uniform",
                      lambda key, shape, dtype=None: jnp.asarray(
                          jitter.numpy()))
            samples = jax.jit(lambda b, o, d, mask: jrenderer.march_rays(
                b, o, d, mask, jax.random.PRNGKey(0), jrc))(
                binary.numpy(), rays_o.numpy(), rays_d.numpy(),
                ray_mask.numpy())
        return trenderer.RaySamples(**{
            f: None if getattr(samples, f) is None else torch.tensor(
                np.asarray(getattr(samples, f))).to(
                    torch.bool if f == "coarse_complete" else
                    torch.float32 if f in ("t_mid", "dt") else torch.int64)
            for f in trenderer.RaySamples._fields})

    monkeypatch.setattr(tpb, "sample_lifetimes", sample_lifetimes)
    monkeypatch.setattr(ttrajectory, "interpolate_pose", interpolate_pose)
    monkeypatch.setattr(tnerf, "pixel_params_to_ray", pixel_params_to_ray)
    monkeypatch.setattr(trenderer, "march_rays", march_rays)


@pytest.mark.parametrize("it_sample_size", sorted(FILTER_ON_CASES))
def test_filter_on_step_matches_jax_tightly_on_its_sample_set(
        dataset, filter_on_jax, monkeypatch, it_sample_size):
    """The filter-on step at the filter-off test's tolerances (marched
    samples 1e-6 relative, every gradient, the filter parameters' too,
    within 2e-4 of its largest entry), once the port renders the JAX
    step's sample set: the loose tolerances of the test above are then
    only the ulp-level differences of XLA's and torch's lifetimes
    (log1p), poses (slerp), ray directions and march arithmetic, which
    move single samples across a march or cell boundary."""
    j = filter_on_jax[it_sample_size]
    _hand_jax_samples_to_port(monkeypatch, j, dataset)
    _assert_port_step_matches(j, dataset, samples_rtol=1e-6, grad_atol=2e-4,
                              pb_grad_atol=2e-4)


def test_filter_on_overflow_masks_tail_events_and_names_the_divergence(
        dataset):
    """When the step's samples overflow the budget, the JAX package
    (sample-major ray order) truncates the last lifetime sample of every
    event and masks the whole step; the port renders event-major, so the
    overflow masks the trailing events only (ROADMAP Queue C)."""
    j = _jax_step(small_config(dataset, it_sample_size=4), dataset,
                  CAPACITY, ACTIVE, 100_000)  # demand ~126K samples
    assert float(j["metrics"]["ray_truncation_rate"]) > 0
    assert float(j["metrics"]["mean_valid_rate"]) == 0.0  # every event
    cfg, sc = j["cfg"], j["sc"]
    tbundle, tparams = tsetup.build(ConfigDict.from_dict(cfg.to_dict()),
                                    str(dataset), sample_budget=100_000,
                                    device=torch.device("cpu"))
    tparams.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j["params"])), strict=True)
    occ = j["occ"]
    loss, m = tstep.compute_loss(
        tparams, tbundle.consts, tocc.OccupancyGridState(
            torch.tensor(np.asarray(occ.occs)),
            torch.tensor(np.asarray(occ.binary))),
        {k: torch.tensor(v) for k, v in j["batch_np"].items()},
        _jax_draws(j["key"], CAPACITY, sc, occ.binary),
        tbundle.static_config, tbundle.loss_config)
    # (which coarse blocks survive an overflow depends on the ray order,
    # so the demand counts differ from the JAX package's here)
    # the tail rays are the last render slices' (subdiff end): the diff
    # term keeps its events
    assert float(m["ray_truncation_rate"]) > 0
    assert float(m["mean_valid_rate"]) > 0.3
    assert float(loss.detach()) > 0
    loss.backward()
    assert float(tparams.nerf.field.table.grad.abs().max()) > 0


def test_pixel_bandwidth_on_raises_with_roadmap_item(dataset, tmp_path):
    """The filter-on model builds (its six parameters keyed like the JAX
    tree, the budget sized x S), and its filter parameters load from a
    checkpoint through model.checkpoint_filepath (this raised, naming
    ROADMAP Queue A 9, until checkpoints were ported): the flagged
    component comes back, the others stay as built."""
    cfg = ConfigDict.from_dict(small_config(dataset, it_sample_size=4)
                               .to_dict())
    bundle, params = tsetup.build(cfg, str(dataset),
                                  device=torch.device("cpu"))
    assert bundle.static_config.pixel_bandwidth_enabled
    assert bundle.static_config.it_sample_size == 4
    assert sorted(n for n, _ in params.named_parameters()
                  if n.startswith("pixel_bandwidth.")) == sorted(
        f"pixel_bandwidth.{k}_raw" for k in (
            "A_amp_inv", "A_loop_inv", "tau_diff", "tau_mil_it_eff_prod",
            "tau_out", "tau_sf"))
    assert params.nerf.render_config.sample_budget == \
        131072 * 4 * 4  # train_eff_ray_sample_batch_size x S x 4 slices
    with torch.no_grad():
        for v in params.pixel_bandwidth.parameters():
            v.add_(0.25)
        params.nerf.field.table.add_(1.0)
    ckpt = tmp_path / "model.ckpt"
    tcheckpoint.save(str(ckpt), {
        "params": tcheckpoint.component_state(params)})
    cfg.model.checkpoint_filepath = str(ckpt)
    cfg.model.pixel_bandwidth.load_state_dict = True
    trainer = Trainer(cfg, str(tmp_path / "log"), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    for name, v in params.pixel_bandwidth.named_parameters():
        assert torch.equal(getattr(trainer.params.pixel_bandwidth, name),
                           v), name
    assert not torch.equal(trainer.params.nerf.field.table,
                           params.nerf.field.table)


def _optax_moments(state):
    """{port parameter name: (mu, nu)} from an optax state's Adam states
    (each group's moments live in its own masked tree)."""
    import optax

    def present(tree):
        if isinstance(tree, dict):
            kept = {k: present(v) for k, v in tree.items()}
            return {k: v for k, v in kept.items() if v is not None}
        return None if isinstance(tree, optax.MaskedNode) else np.asarray(
            tree)

    out = {}
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            mu = convert.params_from_jax(present(s.mu))
            nu = convert.params_from_jax(present(s.nu))
            out.update({n: (mu[n], nu[n]) for n in mu})
    return out


@pytest.mark.parametrize("accumulate", [1, 2, 8])
def test_optimizer_matches_optax_chain(accumulate):
    """Updates with the flagship's groups, coupled MLP weight decay, a
    milestone inside the window, a frozen group and the decoupled table
    row decay, against the JAX package's optax chain: three updates, or,
    with accumulation k, 3k + 2 micro-steps, one of them with a NaN
    gradient, against optax.apply_if_finite(optax.MultiSteps(chain, k)) as
    the JAX trainer wraps it (the NaN micro-step dropped whole, three
    updates, one micro-step left in the running mean). Parameters,
    moments and the running mean at rtol 1e-6."""
    import optax

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
    if accumulate > 1:
        tx = optax.apply_if_finite(
            optax.MultiSteps(tx, every_k_schedule=accumulate),
            max_consecutive_errors=10000)
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
                              table_decay=table_decay, accumulate=accumulate)
    assert tmask["refractory_period.refractory_period_logit"] is False
    n_micro = 3 if accumulate == 1 else 3 * accumulate + 2
    nan_at = accumulate + 1 if accumulate > 1 else None
    for i in range(n_micro):
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.normal(size=np.shape(p)), p.dtype), p_j)
        if i == nan_at:
            grads["nerf"]["field"]["table"][3, 1] = np.nan
        grads = jax.tree_util.tree_map(jnp.asarray, grads)
        updates, state = tx.update(grads, state, p_j)
        p_j = jax.tree_util.tree_map(lambda p, u: p + u, p_j, updates)
        opt.zero_grad()
        for name, g in convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, grads)).items():
            param = dict(module.named_parameters())[name]
            if param.requires_grad:
                param.grad = g.to(param.dtype)
        assert bool(opt.step()) == (i != nan_at)
    assert int(opt.count) == 3
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    moments = _optax_moments(state)
    named = dict(opt.named_params())
    # the frozen refractory logit is left out of the port's optimizer; the
    # JAX chain zeroes its gradient, so its moments stay zero
    frozen = set(moments) - set(named)
    assert frozen == {"refractory_period.refractory_period_logit"}
    for name in frozen:
        assert not np.any(moments[name][0].numpy())
    # moments at rtol 1e-6 of each moment's largest entry: XLA rounds
    # b1 m + (1 - b1) g as one fused multiply-add, torch in two steps, and
    # where the two terms cancel the small result differs by more than
    # 1e-6 of itself (measured: up to 6e-6 on 3 of 512 entries)
    for name in named:
        mu, nu = moments[name]
        m, v = opt.state[named[name]]
        for got, want in ((m, mu), (v, nu)):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-6,
                atol=1e-6 * float(np.abs(want.numpy()).max()), err_msg=name)
    if accumulate > 1:
        multi = state.inner_state
        assert int(opt.mini_step) == int(multi.mini_step) == 1
        acc_j = convert.params_from_jax(jax.tree_util.tree_map(
            np.asarray, multi.acc_grads))
        for name, p in named.items():
            np.testing.assert_allclose(opt.acc[p].numpy(),
                                       acc_j[name].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=name)
            assert float(opt.acc[p].abs().max()) > 0, name


def test_accumulation_skip_is_decided_on_the_device():
    """With accumulation, a NaN micro-step leaves the running mean, its
    count, the moments and the parameters as they were, decided without a
    host read; the update lands at the k-th taken micro-step."""
    p = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("p", p)])], [], 1.0,
                           accumulate=3)
    p0 = p.detach().clone()
    p.grad = torch.ones(6)
    assert bool(opt.step(loss=torch.tensor(1.0)))
    acc = opt.acc[p].clone()
    p.grad = torch.full((6,), float("nan"))
    taken = opt.step(loss=torch.tensor(1.0))
    assert torch.is_tensor(taken) and not bool(taken)
    assert torch.is_tensor(opt.mini_step) and int(opt.mini_step) == 1
    assert torch.equal(opt.acc[p], acc) and torch.equal(p.detach(), p0)
    for _ in range(2):
        p.grad = 3 * torch.ones(6)
        assert bool(opt.step(loss=torch.tensor(1.0)))
    assert int(opt.count) == 1 and int(opt.mini_step) == 0
    assert not torch.equal(p.detach(), p0)
    assert float(opt.acc[p].abs().max()) == 0.0
    # the mean of 1, 3, 3 went into Adam: m = (1 - B1) * 7 / 3
    np.testing.assert_allclose(opt.state[p][0].numpy(),
                               np.full(6, 0.1 * 7 / 3, np.float32),
                               rtol=1e-6)
    # without the skip, a NaN micro-step is folded in, and still only the
    # k-th micro-step updates
    q = torch.nn.Parameter(torch.ones(3))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("q", q)])], [], 1.0,
                           skip_nonfinite=False, accumulate=2)
    q.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert bool(opt.step(loss=torch.tensor(1.0)))
    assert torch.equal(q.detach(), torch.ones(3)) and int(opt.count) == 0
    q.grad = torch.ones(3)
    opt.step(loss=torch.tensor(1.0))
    assert int(opt.count) == 1 and bool(torch.isnan(q.detach()[1]))
    assert float(q.detach()[0]) == pytest.approx(0.9)


def test_optimizer_skips_nonfinite_updates():
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("p", p)])], [], 1.0)
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert not opt.step()
    assert opt.count == 0 and torch.equal(p.detach(), torch.ones(3))
    p.grad = torch.ones(3)
    assert not opt.step(loss=torch.tensor(float("inf")))
    assert opt.step(loss=torch.tensor(1.0)) and opt.count == 1


def _adam_with_moments():
    """An optimizer with non-zero moments and a count of 1, and its
    parameter."""
    p = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("p", p)])], [1], 0.5)
    p.grad = torch.linspace(0.5, -0.5, 6)
    assert bool(opt.step(loss=torch.tensor(1.0)))
    return opt, p


@pytest.mark.parametrize("fault", ["nan_grad", "inf_loss"])
def test_optimizer_skip_is_decided_on_the_device(fault):
    """A non-finite gradient or loss leaves the parameters, both Adam
    moments and the count as they were, decided without a host read: the
    step returns a device bool and the count is a device tensor."""
    opt, p = _adam_with_moments()
    before = [t.detach().clone() for t in (p, *opt.state[p])]
    p.grad = torch.ones(6)
    loss = torch.tensor(1.0)
    if fault == "nan_grad":
        p.grad[2] = float("nan")
    else:
        loss = torch.tensor(float("inf"))
    applied = opt.step(loss=loss)
    assert torch.is_tensor(applied) and applied.dtype == torch.bool
    assert not bool(applied)
    assert torch.is_tensor(opt.count) and int(opt.count) == 1
    for want, got in zip(before, (p, *opt.state[p])):
        assert torch.equal(got.detach(), want)
    p.grad = torch.ones(6)
    assert bool(opt.step(loss=torch.tensor(1.0))) and int(opt.count) == 2


def test_optimizer_without_skip_applies_nonfinite_update():
    """skip_nonfinite False (trainer.skip_nonfinite_updates: false): the
    non-finite update is applied, as in the JAX package."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.Optimizer([("default", 0.1, 0.0, [("p", p)])], [], 1.0,
                           skip_nonfinite=False)
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert bool(opt.step(loss=torch.tensor(1.0)))
    assert int(opt.count) == 1
    assert bool(torch.isnan(p.detach()[1]))
    assert float(p.detach()[0]) == pytest.approx(0.9)


def _trainer_with_nan_loss(dataset, tmp_path, monkeypatch, skip):
    """A filter-off trainer whose step losses are all NaN."""
    cfg = ConfigDict.from_dict(small_config(dataset).to_dict())
    cfg.trainer.log_every_n_steps = 1
    cfg.trainer.skip_nonfinite_updates = skip
    trainer = Trainer(cfg, str(tmp_path / "log"), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    port_loss = tstep.compute_loss

    def nan_loss(*args, **kwargs):
        loss, metrics = port_loss(*args, **kwargs)
        loss = loss * float("nan")
        return loss, dict(metrics, loss=loss)

    monkeypatch.setattr(tstep, "compute_loss", nan_loss)
    return trainer


def test_trainer_skips_nonfinite_update_and_reads_it_a_step_behind(
        dataset, tmp_path, monkeypatch):
    """trainer.skip_nonfinite_updates (default true): the NaN step's update
    is skipped on the device (the table and the count stay), its
    `update_skipped` is a device tensor, and the host reads it one step
    behind without stopping the run."""
    trainer = _trainer_with_nan_loss(dataset, tmp_path, monkeypatch, True)
    table0 = trainer.params.nerf.field.table.detach().clone()
    metrics = trainer.train_step()
    assert torch.is_tensor(metrics["update_skipped"])
    assert bool(metrics["update_skipped"])
    assert trainer.last_metrics is None  # nothing read yet
    trainer.train_step()
    assert trainer.last_metrics["update_skipped"] == 1.0
    assert trainer._nonfinite_streak == 1
    assert torch.equal(trainer.params.nerf.field.table.detach(), table0)
    assert int(trainer.optimizer.count) == 0


def test_trainer_without_skip_applies_update_and_stops_at_first_nan_loss(
        dataset, tmp_path, monkeypatch):
    """trainer.skip_nonfinite_updates: false, as the JAX package reads it:
    the non-finite update is applied and the run stops at the first
    non-finite loss (read one step behind)."""
    trainer = _trainer_with_nan_loss(dataset, tmp_path, monkeypatch, False)
    trainer.train_step()
    assert bool(torch.isnan(trainer.params.nerf.field.table).any())
    assert int(trainer.optimizer.count) == 1
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train_step()


def test_trainer_ema_decay_raises_naming_roadmap_item(dataset, tmp_path,
                                                     monkeypatch):
    """trainer.ema_decay (the evaluation EMA of the parameters; a positive
    decay raised, naming ROADMAP Queue A 9, until it was ported) trains:
    the EMA moves with the parameters but apart from them, and `evaluate`
    renders with the EMA's NeRF while the live parameters stay untouched;
    0 (the flagship's, by omission) keeps no EMA."""
    cfg = ConfigDict.from_dict(small_config(dataset).to_dict())
    cfg.trainer.ema_decay = 0.9
    trainer = Trainer(cfg, str(tmp_path / "log"), batch_capacity=CAPACITY,
                      sample_budget=BUDGET, device="cpu")
    ema_table = trainer.ema_params.nerf.field.table
    assert torch.equal(ema_table, trainer.params.nerf.field.table)
    assert not ema_table.requires_grad
    table0 = ema_table.detach().clone()
    trainer.train(max_steps=2)
    live = trainer.params.nerf.field.table.detach().clone()
    assert not torch.equal(ema_table, table0)
    assert not torch.equal(ema_table, live)
    rendered = []
    render_fn = tevaluation.make_render_image_fn

    def spy(model, *args, **kwargs):
        rendered.append(model)
        return render_fn(model, *args, **kwargs)

    monkeypatch.setattr(tevaluation, "make_render_image_fn", spy)
    trainer.build_evaluator("val")
    assert rendered == [trainer.ema_params.nerf]
    assert torch.equal(trainer.params.nerf.field.table, live)
    cfg.trainer.ema_decay = 0.0
    assert Trainer(cfg, str(tmp_path / "log0"), batch_capacity=CAPACITY,
                   sample_budget=BUDGET, device="cpu").ema_params is None


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
    # resume (which raised, naming ROADMAP Queue A 9, until checkpoints
    # were ported) restores the trained state into a fresh trainer
    path = trainer.save_checkpoint(0)
    fresh = Trainer(cfg, str(tmp_path / "log2"), batch_capacity=CAPACITY,
                    sample_budget=BUDGET, device="cpu")
    assert fresh.resume(path) == 0 and fresh.global_step == 4
    assert torch.equal(fresh.params.nerf.field.table,
                       trainer.params.nerf.field.table)


def test_trainer_takes_filter_on_steps_on_cpu(dataset, tmp_path):
    """Two flagship-shaped steps with the filter on (S = 4): finite
    losses, the frozen filter parameters unchanged, and their effective
    values in the scalar log."""
    cfg = ConfigDict.from_dict(small_config(dataset, it_sample_size=4)
                               .to_dict())
    cfg.trainer.log_every_n_steps = 1
    trainer = Trainer(cfg, str(tmp_path / "log"), batch_capacity=CAPACITY,
                      sample_budget=4 * BUDGET, device="cpu")
    pb0 = {k: v.detach().clone()
           for k, v in trainer.params.pixel_bandwidth.items()}
    table0 = trainer.params.nerf.field.table.detach().clone()
    trainer.train(max_steps=2)
    assert trainer.global_step == 2
    assert np.isfinite(trainer.last_metrics["loss"])
    assert not trainer.last_metrics["update_skipped"]
    assert not torch.equal(table0, trainer.params.nerf.field.table)
    for k, v in trainer.params.pixel_bandwidth.items():
        assert not v.requires_grad and torch.equal(v.detach(), pb0[k]), k
    lines = (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()
    logged = json.loads(lines[-1])
    for name in ("tau_out", "tau_diff", "A_amp_inv"):
        assert logged[f"train/pixel_bandwidth/{name}"] > 0, name


def test_chip_smoke_reference_step_harness_runs_on_cpu(tmp_path):
    """chip_smoke.py's card-vs-CPU filter-on step, with the CPU standing
    in for the card: the harness builds a non-degenerate step (some valid
    events, a positive loss) and compares every gradient."""
    import chip_smoke

    rows = chip_smoke.filter_on_step_card_vs_cpu(torch, str(tmp_path),
                                                 device="cpu")
    names = {name for name, _, _ in rows}
    assert {"loss", "samples per ray",
            "grad pixel_bandwidth.tau_diff_raw",
            "grad nerf.field.table"} <= names
    assert all(err == 0.0 for _, err, _ in rows)  # the same device
