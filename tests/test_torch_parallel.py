"""Data parallelism of the port (deblur_e_nerf_tpu_torch/parallel/) on the
CPU, over gloo ranks that `parallel.mesh.spawn` starts: a 4-rank step
against the JAX package's single-device step and its sharded step on a
4-device mesh, and against the port's single process; the replicas'
digests through a Trainer with accumulation and occupancy updates; the
sparsity prior counted once; the batcher's interleave against the JAX
package's; the draws' split; the K / W overflow divergence (ROADMAP Queue
C 1); checkpoints across mesh sizes; the CLI's --mesh; and num_nodes.

Sizes are those of tests/test_parallel.py's `dp_setup` (16x16 images, 21
poses, S = 4, 4 hash levels of 2^10 rows, a 16^3 grid, capacity 64), with
two changes so the step is not degenerate: the occupancy grid is the one
an update of the fresh field makes (dp_setup's all-occupied grid), and the
sample budget is 2^18 (dp_setup's 4096 truncates every ray at this size,
so its steps compare losses of 0). One spawn of 4 ranks runs every job of
the module (`ranks` fixture), a second checks num_nodes; the ranks run
tests/torch_parallel_workers.py, which imports no JAX."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from deblur_e_nerf_tpu.data import events as jevents
from deblur_e_nerf_tpu.models import nerf_model as jnerf
from deblur_e_nerf_tpu.parallel import data_parallel as jdp
from deblur_e_nerf_tpu.parallel import mesh as jmesh
from deblur_e_nerf_tpu.training import optim as joptim
from deblur_e_nerf_tpu.training import pipeline as jpipeline
from deblur_e_nerf_tpu.training import setup as jsetup
from deblur_e_nerf_tpu.training import step as jstep
from deblur_e_nerf_tpu.utils.config import load_config as jload_config
from deblur_e_nerf_tpu_torch import convert
from deblur_e_nerf_tpu_torch.data import synthetic
from deblur_e_nerf_tpu_torch.models import occupancy as tocc
from deblur_e_nerf_tpu_torch.parallel import data_parallel
from deblur_e_nerf_tpu_torch.parallel import mesh as mesh_lib
from deblur_e_nerf_tpu_torch.training import pipeline
from deblur_e_nerf_tpu_torch.training import step as tstep
from deblur_e_nerf_tpu_torch.training.trainer import Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict, save_config
from test_torch_train_step import (DENSITY_SIDE, _composite_float64,
                                   _jax_draws, _optax_moments)
from deblur_e_nerf_tpu_torch.models import renderer as trenderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CAPACITY, ACTIVE, BUDGET = 64, 48, 1 << 18
# with the occlusion prepass at div 2: 16 active events, whose ranks'
# shares of the fresh field's live samples fit a rank's K / 8 buffer
PREPASS_ACTIVE = 16
# the overflow case: 16 active events, all in rank 0's rows, whose
# ~75k marched samples fit the global 2^17 but not a rank's 2^15
OVERFLOW_ACTIVE, OVERFLOW_BUDGET = 16, 1 << 17
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as each rank has (the tier-1 run puts several
    test processes on the same cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dp_config(root, sparsity=False):
    """configs/train/synthetic.yaml at dp_setup's size; with `sparsity`,
    the r5fix config's density sparsity prior (weight 0.01, uniform
    cells only) and its occlusion prepass at div 2."""
    cfg = jload_config("configs/train/synthetic.yaml")
    cfg.seed = 0
    cfg.data.dataset_directory = str(root)
    cfg.model.pixel_bandwidth.it_sample_size = 4
    nerf = cfg.model.nerf
    nerf.aabb = [-4.0, -4.0, -4.0, 4.0, 4.0, 4.0]
    nerf.near_plane, nerf.far_plane = 0.1, 8.0
    nerf.occ_grid.resolution = 16
    nerf.occ_grid.warmup_steps = 2
    nerf.ngp.pos_encoding.n_levels = 4
    nerf.ngp.pos_encoding.log2_hashmap_size = 10
    nerf.test_chunk_size = 64
    cfg.data.train_init_eff_batch_size = ACTIVE
    cfg.metric.lpips_weights_path = None
    if sparsity:
        cfg.loss.weight.density_sparsity = 0.01
        cfg.loss.density_sparsity_samples = 256
        cfg.loss.density_sparsity_targeted_fraction = 0.0
        nerf["occlusion_prepass_div"] = 2
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp_ds")
    synthetic.make_dataset(str(root), img_height=16, img_width=16,
                           num_events=20_000, num_poses=21,
                           write_views=True)
    return root


def _port(tree):
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_case(root, cfg, budget, active, interleave, key_seed=7):
    """The JAX inputs of one step and its single-device step: parameters,
    an occupancy grid from one update of the fresh field, the batch, the
    key; plus the port's spec of the same step."""
    bundle, params = jsetup.build(cfg, str(root), sample_budget=budget,
                                  batch_capacity=CAPACITY)
    model, sc = bundle.model, bundle.static_config
    occ = jax.jit(lambda p: jnerf.update_occupancy(
        model, p, jnerf.init_occupancy(model), jax.random.PRNGKey(1),
        bundle.consts["trajectory"].T_wc_position, jnp.asarray(0)))(
            params["nerf"])
    events = jevents.EventDataset(str(root)).events
    batch_np = jpipeline.EventBatcher(
        events, CAPACITY, seed=0, interleave=interleave).next_batch(active)
    key = jax.random.PRNGKey(key_seed)
    spec = {
        "config": ConfigDict.from_dict(cfg.to_dict()).to_dict(),
        "budget": budget, "params": _port(params),
        "occ": {"occs": torch.tensor(np.asarray(occ.occs)),
                "binary": torch.tensor(np.asarray(occ.binary))},
        "batch": {k: torch.tensor(v) for k, v in batch_np.items()},
        "draws": _jax_draws(key, CAPACITY, sc, occ.binary),
    }
    return dict(bundle=bundle, params=params, occ=occ, batch_np=batch_np,
                key=key, spec=spec, cfg=cfg)


def _jax_tx(case):
    cfg, bundle = case["cfg"], case["bundle"]
    tx, _ = joptim.build(
        case["params"], cfg.optimizer, cfg.lr_scheduler,
        float(cfg.loss.weight.nerf_mlp_weight_decay),
        float(bundle.consts["refractory_period"]["max_refractory_period"]),
        steps_per_epoch=10,
        model_configs={c: cfg.model[c] for c in (
            "contrast_threshold", "refractory_period", "pixel_bandwidth",
            "nerf")})
    return tx


def _jax_step(case, sharded):
    """JAX's single-device step, or its step sharded over a 4-device mesh
    (deblur_e_nerf_tpu/parallel), from the case's state."""
    bundle, tx = case["bundle"], _jax_tx(case)
    args = (bundle.model, bundle.consts, tx, bundle.static_config,
            bundle.loss_config)
    state = jstep.TrainState(
        params=case["params"], opt_state=tx.init(case["params"]),
        occ_state=case["occ"], step=jnp.asarray(0, jnp.int32))
    batch = {k: jnp.asarray(v) for k, v in case["batch_np"].items()}
    if not sharded:
        return jax.jit(jstep.make_train_step(*args))(state, batch,
                                                     case["key"])
    mesh = jmesh.make_mesh(n_devices=WORLD)
    return jdp.make_sharded_train_step(*args, mesh)(
        jdp.replicate(mesh, state), jdp.shard_batch(mesh, batch),
        case["key"])


@pytest.fixture(scope="module")
def cases(dataset, tmp_path_factory):
    """Every job the ranks run: the flagship cut's step on JAX-made
    inputs, the sparsity config's and the overflow batch's steps on the
    same weights, and the trainer runs (a single-process checkpoint for
    the mesh to resume)."""
    tmp = tmp_path_factory.mktemp("torch_dp_jobs")
    flagship = _jax_case(dataset, dp_config(dataset), BUDGET, ACTIVE,
                         interleave=WORLD)
    # the same parameters and grid: the sparsity config with the port's
    # draws (its prior's among them), and a batch whose active events are
    # all in rank 0's rows
    spec = flagship["spec"]
    sparsity_cfg = ConfigDict.from_dict(
        dp_config(dataset, sparsity=True).to_dict())
    sc = tstep.StaticConfig(**dict(
        flagship["bundle"].static_config._asdict(),
        loss_weight_sparsity=0.01, sparsity_samples=256,
        sparsity_targeted_fraction=0.0))
    events = jevents.EventDataset(str(dataset)).events

    def batch(active, interleave):
        return {k: torch.tensor(v) for k, v in jpipeline.EventBatcher(
            events, CAPACITY, seed=0, interleave=interleave).next_batch(
                active).items()}

    sparsity = dict(spec, config=sparsity_cfg.to_dict(),
                    batch=batch(PREPASS_ACTIVE, WORLD),
                    draws=tstep.draw_step(
                        sc, CAPACITY, tocc.OccupancyGridState(**spec["occ"]),
                        torch.Generator().manual_seed(5),
                        torch.device("cpu")))
    overflow = dict(spec, budget=OVERFLOW_BUDGET,
                    batch=batch(OVERFLOW_ACTIVE, 1))

    train_cfg = ConfigDict.from_dict(dp_config(dataset).to_dict())
    train_cfg.trainer.accumulate_grad_batches = 2
    train_cfg.trainer.max_epochs = 1
    train_cfg.trainer.limit_train_batches = 4
    train_cfg.trainer.log_every_n_steps = 1
    single = Trainer(train_cfg, str(tmp / "single"), batch_capacity=CAPACITY,
                     sample_budget=BUDGET, device="cpu",
                     interleave=WORLD)  # the mesh's global batches
    single.train()
    single_ckpt = os.path.join(single.log_dir, "checkpoints", "epoch_0000")
    train = {"config": train_cfg.to_dict(), "capacity": CAPACITY,
             "budget": BUDGET}
    jobs = {
        "flagship": ("step", flagship["spec"]),
        "sparsity": ("step", sparsity),
        "overflow": ("step", overflow),
        "train": ("train", dict(train, log_dir=str(tmp / "mesh"))),
        "resume": ("train", dict(train, log_dir=str(tmp / "mesh_resumed"),
                                 resume=single_ckpt, max_steps=0)),
    }
    jobs_path = str(tmp / "jobs.pt")
    torch.save(jobs, jobs_path)
    return dict(flagship=flagship, jobs=jobs, jobs_path=jobs_path, tmp=tmp,
                single=single, single_ckpt=single_ckpt, train_cfg=train_cfg)


def _spawn(cases, out_dir, num_nodes=1, names=None):
    """Run the jobs (all, or `names`) on 4 gloo ranks; returns each
    rank's outputs."""
    jobs_path = cases["jobs_path"]
    if names is not None:
        jobs_path = os.path.join(out_dir, "jobs.pt")
        torch.save({n: cases["jobs"][n] for n in names}, jobs_path)
    mesh_lib.spawn(workers.run_jobs, WORLD, args=(jobs_path, str(out_dir)),
                   num_nodes=num_nodes, device="cpu",
                   init_method=f"file://{out_dir}/rendezvous",
                   timeout_s=120, join_timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return [torch.load(os.path.join(out_dir, f"rank_{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    return _spawn(cases, tmp_path_factory.mktemp("torch_dp_ranks"))


def _single(spec):
    """The port's single-process step of a spec."""
    return workers.run_step(spec)


def _assert_replicated(ranks, name):
    """Every rank ended the job with the same replica, bit for bit."""
    digests = {r[name]["digest"] for r in ranks}
    assert len(digests) == 1, (name, digests)
    for key in ("params", "grads", "m"):
        for rank in ranks[1:]:
            for k, v in ranks[0][name][key].items():
                assert torch.equal(v, rank[name][key][k]), (name, key, k)


# the port-vs-JAX filter-on step tolerances of tests/test_torch_train_step.py
# (S = 4): loss terms 1e-5 relative; gradients 1e-3 of each tensor's
# largest entry (the filter parameters 5e-3 of their largest), here read
# from Adam's first moments after the first step (m = 0.1 g), with the
# DENSITY_SIDE ones held to the port's step with a float64 composite, as
# there (JAX's float32 optical-depth gradient is off, ROADMAP Queue C 7);
# marched samples per ray 2e-5 relative
LOSS_RTOL, GRAD_ATOL, PB_GRAD_ATOL, SAMPLES_RTOL = 1e-5, 1e-3, 5e-3, 2e-5
# parameters after the step: the JAX sharded-vs-single test's tolerances
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
# Adam's first step moves a parameter by lr g / (|g| + 1e-8): below
# |g| = 1e-6 (100 x Adam's eps), a gradient difference within tolerance
# moves it by more than PARAM_ATOL
ADAM_NEAR_ZERO = 1e-6


def _float64_density_moments(spec):
    """The port's single-process step with the composite in float64: the
    DENSITY_SIDE parameters' first moments."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(trenderer, "composite", _composite_float64)
        out = workers.run_step(spec)
    return {n: v.numpy() for n, v in out["m"].items()
            if n.startswith(DENSITY_SIDE)}


def _assert_params_close(got, want, grad, grad_tol):
    """Parameters after Adam's first step, which moves each by ~lr x
    sign(g): where two gradients differ within `grad_tol` near 0, the
    parameters may differ by up to 2 lr. Those entries (|g| <=
    max(grad_tol, ADAM_NEAR_ZERO)) are counted; every other entry is held
    to PARAM_RTOL / PARAM_ATOL. Returns the count."""
    off = ~np.isclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert np.all(np.abs(grad[off]) <= max(grad_tol, ADAM_NEAR_ZERO))
    return int(off.sum())


def _assert_matches_jax(out, jax_step, name, oracle):
    new_state, metrics_j = jax_step
    metrics = out["metrics"]
    for k in ("loss", "loss_log_intensity_diff", "loss_log_intensity_tv"):
        assert metrics[k] == pytest.approx(float(metrics_j[k]),
                                           rel=LOSS_RTOL, abs=1e-7), (name, k)
    assert metrics["loss"] > 0
    assert metrics["batch_size"] == float(metrics_j["batch_size"])
    for k in ("mean_num_samples_per_ray", "sample_overflow_rate",
              "block_overflow_rate"):
        assert metrics[k] == pytest.approx(float(metrics_j[k]),
                                           rel=SAMPLES_RTOL), (name, k)
    for k in ("ray_truncation_rate", "mean_valid_rate", "mean_ray_occ_rate"):
        assert metrics[k] == pytest.approx(float(metrics_j[k]),
                                           rel=1e-6), (name, k)
    moments = _optax_moments(new_state.opt_state)
    # the port's optimizer holds the trainable parameters only
    assert set(out["m"]) <= set(moments)
    pb_scale = max([float(np.abs(moments[n][0]).max()) for n in out["m"]
                    if n.startswith("pixel_bandwidth.")], default=0.0)
    want_params = _port(new_state.params)
    loose = 0
    for n in out["m"]:
        mu = oracle.get(n, np.asarray(moments[n][0]))
        scale = (pb_scale * PB_GRAD_ATOL if n.startswith("pixel_bandwidth.")
                 else GRAD_ATOL * float(np.abs(mu).max())) + 1e-15
        np.testing.assert_allclose(out["m"][n].numpy(), mu, rtol=2e-4,
                                   atol=scale, err_msg=str((name, n)))
        if n not in oracle:
            loose += _assert_params_close(out["params"][n].numpy(),
                                          want_params[n].numpy(), mu, scale)
    return loose


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["jax_single_device", "jax_sharded"])
def test_four_ranks_match_the_jax_step(cases, ranks, sharded):
    """4 gloo ranks, each with its rows of the batch and its share of the
    JAX step's draws (`shard_draws`), against jax.jit(make_train_step) on
    the whole batch, and against JAX's data-parallel program over a
    4-device mesh: the tolerances of the port-vs-JAX step tests."""
    _assert_replicated(ranks, "flagship")
    out = ranks[0]["flagship"]
    loose = _assert_matches_jax(
        out, _jax_step(cases["flagship"], sharded),
        "sharded" if sharded else "single device",
        _float64_density_moments(cases["flagship"]["spec"]))
    n = sum(v.numel() for n_, v in out["params"].items()
            if not n_.startswith(DENSITY_SIDE))
    print(f"parameters off the JAX tolerances where their gradient is "
          f"within its tolerance of 0: {loose} of {n}")
    assert loose <= 1e-3 * n, loose


# the port's mesh against its single process on the same global batch and
# draws, where only the summation order differs: the loss 1e-6 relative,
# the gradients 1e-4 of each tensor's largest entry (chip_smoke.py phase
# 10's). The float32 MLP weight gradients sum ~2e5 samples' terms: the
# single process against itself at 1 and 8 threads differs by 3.0e-5 of
# the largest entry on mlp_base.output.weight, and the mesh by 4.5e-5.
PORT_LOSS_RTOL, PORT_GRAD_ATOL = 1e-6, 1e-4


def _assert_matches_single(out, single, name):
    """The mesh's step against the single process's: metrics and
    gradients at the tolerances above, parameters after the step as in
    `_assert_params_close` with each gradient's tolerance."""
    for k, v in single["metrics"].items():
        if k == "prepass_overflow_rate":
            # the worst rank's demand over its own buffer, K / (W div)
            assert out["metrics"][k] >= v * (1 - 1e-6), name
            continue
        rel = PORT_LOSS_RTOL if k.startswith("loss") else 1e-6
        assert out["metrics"][k] == pytest.approx(v, rel=rel, abs=1e-9), \
            (name, k)
    assert set(out["grads"]) == set(single["grads"])
    loose = 0
    for n, g in single["grads"].items():
        atol = PORT_GRAD_ATOL * float(g.abs().max()) + 1e-15
        np.testing.assert_allclose(out["grads"][n].numpy(), g.numpy(),
                                   rtol=0, atol=atol, err_msg=str((name, n)))
        loose += _assert_params_close(out["params"][n].numpy(),
                                      single["params"][n].numpy(),
                                      g.numpy(), atol)
    print(f"{name}: parameters off the tolerances where their gradient is "
          f"near 0: {loose}")


def test_four_ranks_match_the_port_single_process(cases, ranks):
    _assert_matches_single(ranks[0]["flagship"],
                           _single(cases["flagship"]["spec"]), "flagship")


def test_sparsity_prior_is_counted_once(cases, ranks):
    """The replicated prior's gradient enters each rank's loss at 1 / W,
    so the summed gradient holds it once: the 4-rank step with the prior
    (and the occlusion prepass) equals the single process's, and the
    reported prior is the unscaled one."""
    _assert_replicated(ranks, "sparsity")
    spec = cases["jobs"]["sparsity"][1]
    single = _single(spec)
    assert single["metrics"]["loss_density_sparsity"] > 0
    assert single["metrics"]["prepass_ran"] == 1.0
    _assert_matches_single(ranks[0]["sparsity"], single, "sparsity")
    # counted W times, the prior would weigh 4 x 0.01: a step the
    # tolerances above tell apart
    config = ConfigDict.from_dict(spec["config"])
    config.loss.weight.density_sparsity = 0.01 * WORLD
    heavy = _single(dict(spec, config=config.to_dict()))["grads"]
    assert any(
        float((heavy[n] - g).abs().max())
        > 10 * PORT_GRAD_ATOL * float(g.abs().max())
        for n, g in single["grads"].items()), "the prior does not show"
    for rank in ranks:
        assert rank["sparsity"]["metrics"]["loss_density_sparsity"] == \
            single["metrics"]["loss_density_sparsity"]


def test_k_over_w_overflow_truncates_a_rank_and_names_the_divergence(
        cases, ranks):
    """ROADMAP Queue C 1: a rank's sample buffer is K / W. Here every
    active event lies in rank 0's rows (no interleave): the global buffer
    of the single process (and of the JAX package, which compacts over
    the whole mesh) holds the step's samples, rank 0's quarter does not,
    and its tail events leave the loss (its block and superblock budgets
    shrink by W too). `sample_overflow_rate` stays the global marched
    over the global budget, below 1 on both; the metrics gain nothing."""
    single = _single(cases["jobs"]["overflow"][1])["metrics"]
    mesh = ranks[0]["overflow"]["metrics"]
    demand = single["num_marched_samples"]
    assert OVERFLOW_BUDGET / WORLD < demand <= OVERFLOW_BUDGET
    assert single["ray_truncation_rate"] == 0.0
    assert single["sample_overflow_rate"] < 1
    assert mesh["sample_overflow_rate"] < 1
    assert set(mesh) == set(single)
    assert mesh["ray_truncation_rate"] > 0.0
    assert mesh["mean_valid_rate"] < single["mean_valid_rate"]
    assert mesh["loss"] != pytest.approx(single["loss"], rel=1e-3)


def _rank_lines(log_dir, rank):
    with open(os.path.join(log_dir, f"rank_{rank}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_replicas_stay_identical_and_checkpoints_cross_mesh_sizes(
        cases, ranks):
    """A Trainer with mesh_devices 4 (accumulation 2, occupancy updates
    at both optimizer steps) trains one epoch of 4 micro-steps with the
    replica check; every rank's digest is equal at every step, rank 0
    alone writes metrics.jsonl and the checkpoint, which resumes bit for
    bit in one process; a single-process checkpoint resumes under the
    mesh bit for bit."""
    log_dir = cases["jobs"]["train"][1]["log_dir"]
    lines = [_rank_lines(log_dir, r) for r in range(WORLD)]
    assert [line["step"] for line in lines[0][1:]] == [0, 1, 2, 3]
    for rank_lines in lines[1:]:
        assert [line["digest"] for line in rank_lines] == \
            [line["digest"] for line in lines[0]]
        assert [line["loss"] for line in rank_lines[1:]] == \
            [line["loss"] for line in lines[0][1:]]
    assert len({line["digest"] for line in lines[0]}) == 5  # each step moved
    for step in range(1, 5):
        assert sum(rank_lines[step]["local_batch_size"]
                   for rank_lines in lines) == lines[0][step]["batch_size"]
    assert {r["train"]["digest"] for r in ranks} == {lines[0][-1]["digest"]}
    assert ranks[0]["train"]["global_step"] == 4
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 4
    ckpt = os.path.join(log_dir, "checkpoints", "epoch_0000")
    fresh = Trainer(cases["train_cfg"], str(cases["tmp"] / "one"),
                    batch_capacity=CAPACITY, sample_budget=BUDGET,
                    device="cpu")
    fresh.resume(ckpt)
    assert int(data_parallel.digest(fresh.replica_tensors())) == \
        lines[0][-1]["digest"]
    # the single-process run of the same epoch (the same global batches):
    # the same losses, within 1e-6 before the first update (micro-steps 0
    # and 1) and 1e-4 after it, where the parameters Adam's first step
    # moved by +-lr at near-zero gradients (see _assert_params_close)
    # have changed the renders (6.7e-5 measured at micro-step 3)
    with open(os.path.join(cases["single"].log_dir, "metrics.jsonl")) as f:
        single = [json.loads(line)["train/loss"] for line in f]
    mesh = [line["loss"] for line in lines[0][1:]]
    np.testing.assert_allclose(mesh[:2], single[:2], rtol=1e-6)
    np.testing.assert_allclose(mesh[2:], single[2:], rtol=1e-4)
    # the other way round
    want = int(data_parallel.digest(cases["single"].replica_tensors()))
    resumed = cases["jobs"]["resume"][1]["log_dir"]
    for rank in range(WORLD):
        assert _rank_lines(resumed, rank)[0]["digest"] == want


def test_ray_generation_is_bit_equal_over_the_ranks_shares(cases):
    """A rank computes its share of a step's rays alone, so every ray's
    position, orientation and direction must be bit-equal to the whole
    batch's (chip_smoke.ray_split_mismatches at a step's (S, R x events)
    shapes, 1024 events over 4 ranks)."""
    import chip_smoke

    trainer = cases["single"]
    sc = trainer.bundle.static_config
    counts = chip_smoke.ray_split_mismatches(
        torch, trainer.bundle.consts, 1024,
        sc.it_sample_size if sc.pixel_bandwidth_enabled else 1,
        tstep.n_render_slices(sc), WORLD)
    assert counts == {"position": 0, "orientation": 0, "direction": 0}


def test_num_nodes_two_by_two_is_mesh_four(cases, tmp_path):
    """num_nodes 2 x 2 local ranks (the JAX package's ('replica', 'data')
    mesh): rank r is local rank r % 2, and the step is mesh 4's."""
    two = _spawn(cases, tmp_path, num_nodes=2, names=["flagship"])
    assert [r["mesh"]["local_rank"] for r in two] == [0, 1, 0, 1]
    assert all(r["mesh"]["num_nodes"] == 2 for r in two)
    one = _single(cases["flagship"]["spec"])
    _assert_matches_single(two[0]["flagship"], one, "num_nodes 2")
    _assert_replicated(two, "flagship")


def test_cli_mesh_two_on_the_cpu(dataset, tmp_path, capsys):
    """python -m deblur_e_nerf_tpu_torch train ... --mesh 2 --device cpu,
    through chip_smoke.py phase 10's harness on the CPU: two gloo ranks
    train 2 steps with the replica check (digests equal at every step),
    rank 0 alone prints, evaluates, logs and saves; the steps match a
    single-process trainer over the same global batches, and a second
    invocation resumes the last checkpoint under the mesh as a single
    process resumes it (the digest bit for bit)."""
    import chip_smoke

    config = ConfigDict.from_dict(dp_config(dataset).to_dict())
    config.trainer.log_every_n_steps = 1
    launches = chip_smoke.mesh_vs_single(
        torch, str(tmp_path), config, "cpu_mesh", world=2, steps=2,
        capacity=CAPACITY, sample_budget=2 * BUDGET, device="cpu")
    assert set(launches) == {"rank 0", "rank 1"}  # no kernel on the CPU
    out = capsys.readouterr().out
    assert "rank 0 printed: epoch 1: val" in out
    assert out.count("cpu_mesh single process step") == 2
    log = tmp_path / "log_cpu_mesh_mesh"
    with open(log / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines if "train/loss" in line] == [1, 2]
    assert any("val/psnr" in line for line in lines)
    assert sorted(os.listdir(log / "checkpoints")) == [
        "config.yaml", "epoch_0000", "epoch_0001"]


def test_cli_mesh_one_runs_one_process_whatever_the_config_says(
        dataset, tmp_path):
    """`--mesh 1` trains in this process even where the config sets
    trainer.mesh_devices 4 (the CLI's mesh size reaches the Trainer)."""
    from deblur_e_nerf_tpu_torch import cli

    config = ConfigDict.from_dict(dp_config(dataset).to_dict())
    config.trainer.mesh_devices = WORLD
    config.trainer.max_epochs = 1
    config.trainer.limit_train_batches = 1
    config.trainer.check_val_every_n_epoch = 10**9
    path = str(tmp_path / "run.yaml")
    save_config(config, path)
    log = tmp_path / "log"
    assert cli.main(["train", path, "--mesh", "1", "--device", "cpu",
                     "--batch-capacity", str(CAPACITY), "--sample-budget",
                     str(BUDGET), "--log-dir", str(log)]) == 0
    assert sorted(os.listdir(log / "checkpoints")) == [
        "config.yaml", "epoch_0000"]


def test_torchrun_ranks_join_the_group(dataset, tmp_path):
    """Under torchrun (WORLD_SIZE set) each process joins the group as its
    rank (parallel.mesh.from_env); a null seed, drawn in each process,
    becomes rank 0's on every rank, so the replicas agree."""
    config = ConfigDict.from_dict(dp_config(dataset).to_dict())
    config.seed = None
    config.trainer.max_epochs = 1
    config.trainer.limit_train_batches = 1
    config.trainer.check_val_every_n_epoch = 10**9
    config.trainer.replica_check = True
    path = str(tmp_path / "run.yaml")
    save_config(config, path)
    log = tmp_path / "log"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "deblur_e_nerf_tpu_torch", "train",
         path, "--mesh", "2", "--device", "cpu", "--batch-capacity",
         str(CAPACITY), "--sample-budget", str(BUDGET), "--log-dir",
         str(log), "--dist-timeout", "120"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [_rank_lines(log, rank) for rank in range(2)]
    assert [line["digest"] for line in lines[0]] == \
        [line["digest"] for line in lines[1]]
    assert len(lines[0]) == 2 and lines[0][1]["loss"] > 0
    assert (log / "checkpoints" / "epoch_0000").exists()


def test_interleave_places_rows_as_the_jax_batcher():
    """EventBatcher(interleave=4): the active rows go round-robin over the
    4 shards, row for row as the JAX package's; the shards re-joined in
    rank order are the global batch."""
    rng = np.random.default_rng(0)
    n = 500
    events = {"position": rng.random((n, 2), np.float32),
              "start_ts": rng.integers(0, 10**6, n),
              "end_ts": rng.integers(10**6, 2 * 10**6, n),
              "num_pos": rng.integers(0, 3, n).astype(np.float32),
              "num_neg": rng.integers(0, 3, n).astype(np.float32)}
    ours = pipeline.EventBatcher(events, 64, seed=3, interleave=WORLD)
    theirs = jpipeline.EventBatcher(events, 64, seed=3, interleave=WORLD)
    for active in (1, 13, 48, 64):
        a, b = ours.next_batch(active), theirs.next_batch(active)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        shards = [data_parallel.shard_batch(a, r, WORLD)
                  for r in range(WORLD)]
        for k in a:
            np.testing.assert_array_equal(
                np.concatenate([s[k] for s in shards]), a[k])
        counts = [int(s["valid"].sum()) for s in shards]
        assert max(counts) - min(counts) <= 1 and sum(counts) == active
        for s in shards:  # each shard's active rows are its prefix
            assert not s["valid"][int(s["valid"].sum()):].any()
    with pytest.raises(ValueError, match="divide"):
        pipeline.EventBatcher(events, 30, interleave=WORLD)


@pytest.mark.parametrize("filter_on", [False, True])
def test_shard_draws_rejoin_to_the_global_draws(filter_on):
    """`shard_draws` splits each draw by event: the normalized samples on
    their last axis, the (S, R, n) jitter on n; re-joined, the shards are
    the undivided draws, and a rank's jitter is the one its rays get in
    the global render's layout."""
    sc = tstep.StaticConfig(
        pixel_bandwidth_enabled=filter_on, it_sample_size=3,
        has_bayer=False, min_modeled_intensity=1e-3, loss_weight_diff=1.0,
        loss_weight_tv=1e-3, loss_error_fn_diff="huber",
        loss_error_fn_tv="l1", loss_normalize_diff=True,
        loss_normalize_tv=True, loss_weight_sparsity=0.01,
        sparsity_samples=16)
    occ = tocc.init_state(8, torch.device("cpu"))
    n = 12
    draws = tstep.draw_step(sc, n, occ, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    shards = [data_parallel.shard_draws(draws, r, WORLD)
              for r in range(WORLD)]
    S = 3 if filter_on else 1
    R = tstep.n_render_slices(sc)
    for k, v in draws["normalized"].items():
        assert torch.equal(torch.cat([s["normalized"][k] for s in shards],
                                     dim=-1), v), k
    jitter = torch.stack([s["jitter"].view(S, R, n // WORLD)
                          for s in shards], dim=2).reshape(-1)
    assert torch.equal(jitter, draws["jitter"])
    # event i of rank r, slice q, lifetime sample s
    r, i, q, s = 2, 1, R - 1, S - 1
    local = shards[r]["jitter"].view(S, R, n // WORLD)[s, q, i]
    assert local == draws["jitter"].view(S, R, n)[s, q, r * 3 + i]
    for s_ in shards:
        assert s_["sparsity"] is draws["sparsity"]
