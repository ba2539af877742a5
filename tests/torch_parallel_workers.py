"""The ranks' side of tests/test_torch_parallel.py: functions that
`parallel.mesh.spawn` runs in each rank, importing torch and the port only
(a spawned process must not import the test module, which imports JAX).
Inputs and outputs go through files: `torch.save` dicts of tensors and
plain values."""

import os

import torch

from deblur_e_nerf_tpu_torch.models import occupancy
from deblur_e_nerf_tpu_torch.parallel import data_parallel
from deblur_e_nerf_tpu_torch.training import optim, setup, step as step_lib
from deblur_e_nerf_tpu_torch.training.trainer import COMPONENTS, Trainer
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict


def build_step(spec, mesh=None):
    """The step of a `spec` (config, sample budget, parameters): returns
    (step_fn, params, optimizer), sharded over `mesh` when given."""
    cfg = ConfigDict.from_dict(spec["config"])
    bundle, params = setup.build(cfg, cfg.data.dataset_directory,
                                 sample_budget=spec["budget"],
                                 device=torch.device("cpu"))
    params.load_state_dict(spec["params"])
    optimizer, _ = optim.build(
        params, cfg.optimizer, cfg.lr_scheduler,
        float(cfg.loss.weight.nerf_mlp_weight_decay),
        float(bundle.consts["refractory_period"]["max_refractory_period"]),
        steps_per_epoch=10,
        model_configs={c: cfg.model[c] for c in COMPONENTS},
        table_decay=params.nerf.table_decay)
    args = (params, bundle.consts, optimizer, bundle.static_config,
            bundle.loss_config)
    if mesh is None:
        return step_lib.make_train_step(*args), params, optimizer
    params.nerf.render_config = data_parallel.shard_render_config(
        params.nerf.render_config, mesh.world)
    step_fn, _ = data_parallel.make_sharded_train_step(*args, mesh.world)
    return step_fn, params, optimizer


def run_step(spec, mesh=None):
    """One step of `spec` on its global batch and draws (the rank's share
    of them under `mesh`): the metrics, the (summed) gradients, the
    parameters and Adam's first moments after the step, and the replica
    digest."""
    step_fn, params, optimizer = build_step(spec, mesh)
    occ = occupancy.OccupancyGridState(**spec["occ"])
    batch, draws = spec["batch"], spec["draws"]
    if mesh is not None:
        batch = data_parallel.shard_batch(batch, mesh.rank, mesh.world)
        draws = data_parallel.shard_draws(draws, mesh.rank, mesh.world)
    metrics = step_fn(occ, batch, draws, prepass=spec.get("prepass", True))
    opt = optimizer.state_dict()
    tensors = [t for t in params.state_dict().values()] + list(
        opt["m"].values()) + list(opt["v"].values())
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.clone() for n, p in params.named_parameters()
                  if p.grad is not None},
        "params": {k: v.clone() for k, v in params.state_dict().items()},
        "m": dict(opt["m"]),
        "digest": int(data_parallel.digest(tensors)),
    }


def train(spec, mesh):
    """A Trainer of `spec["config"]` on the mesh with the replica check:
    resumes `spec["resume"]` if given, trains `spec["max_steps"]`
    micro-steps (train() saves at its epoch end) and returns the final
    replica digest."""
    cfg = ConfigDict.from_dict(spec["config"])
    cfg.trainer.replica_check = True
    trainer = Trainer(cfg, spec["log_dir"], batch_capacity=spec["capacity"],
                      sample_budget=spec["budget"], device="cpu",
                      mesh_devices=mesh.world)
    if spec.get("resume"):
        trainer.resume(spec["resume"])
    trainer.train(max_steps=spec.get("max_steps"))
    return {"digest": int(data_parallel.digest(trainer.replica_tensors())),
            "global_step": trainer.global_step,
            "occ_fraction": float(trainer.occ_state.binary.float().mean())}


def run_jobs(mesh, jobs_path, out_dir):
    """Run each job of `jobs_path` ({name: (kind, spec)}) on this rank and
    save {name: output} to <out_dir>/rank_<r>.pt, with this rank's mesh
    record."""
    jobs = torch.load(jobs_path, weights_only=False)
    out = {"mesh": {"rank": mesh.rank, "local_rank": mesh.local_rank,
                    "world": mesh.world, "num_nodes": mesh.num_nodes}}
    for name, (kind, spec) in jobs.items():
        out[name] = {"step": run_step, "train": train}[kind](spec, mesh)
    torch.save(out, os.path.join(out_dir, f"rank_{mesh.rank}.pt"))
