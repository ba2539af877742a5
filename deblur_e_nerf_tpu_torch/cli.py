"""Command line: python -m deblur_e_nerf_tpu_torch {train,val,test} <config.yaml>
(`__main__.py` calls `main`; the ranks of a mesh run `run`, which a
spawned process imports from here).

Mirrors the JAX package's scripts/run.py: loads the YAML config, draws a
seed when `seed` is null (recorded in the config copy) and builds the
Trainer (`--field-chunk N` runs the training render's field N samples
at a time, keeping each chunk's encode output for the backward). `train`
trains and evaluates the val views every
`trainer.check_val_every_n_epoch` epochs and saves a checkpoint per epoch
under `<log dir>/checkpoints/`; `val` and `test` evaluate the stage's views
and write `metrics.yaml` into the log directory.
`trainer.resume_from_checkpoint` resumes a run from one of its checkpoints
and trains from the next epoch; `model.checkpoint_filepath` loads the
components whose `load_state_dict` is set (for example to evaluate a
trained model with a `configs/test/*.yaml`).

`--mesh N` trains data-parallel over N ranks (trainer.mesh_devices; the
JAX package's scripts/run.py --mesh): the CLI spawns them on this host,
one per card with NCCL, or on the CPU with gloo (`--device cpu`);
`--dist-backend gloo` runs gloo over CUDA tensors, whose ranks may share a
card. Under torchrun (WORLD_SIZE set) each process joins the group as its
rank instead: `torchrun --nproc-per-node N -m deblur_e_nerf_tpu_torch
train cfg.yaml --mesh N`, with trainer.num_nodes nodes of N / num_nodes
ranks each. Rank 0 prints, evaluates and saves.

`--step-hook MODULE:NAME` imports NAME from MODULE in every process and
calls it with the built Trainer; what it returns becomes the trainer's
`step_hook` (called around every micro-step; chip_smoke.py measures the
ranks' steps with one).
"""

import argparse
import importlib
import os
import random

STAGES = ("train", "val", "test")
METRICS_FILENAME = "metrics.yaml"


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m deblur_e_nerf_tpu_torch")
    parser.add_argument("stage", choices=STAGES)
    parser.add_argument("config")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--batch-capacity", type=int, default=8192)
    parser.add_argument("--sample-budget", type=int, default=None)
    parser.add_argument("--field-chunk", type=int, default=0,
                        help="samples per field call of the training "
                             "render (0 = the whole buffer)")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--max-eval-images", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--mesh", type=int, default=None,
                        help="data-parallel ranks (default: "
                             "trainer.mesh_devices, else 1)")
    parser.add_argument("--dist-backend", default=None,
                        choices=("nccl", "gloo"),
                        help="the ranks' backend (default nccl on CUDA, "
                             "gloo on the CPU)")
    parser.add_argument("--dist-timeout", type=float, default=None,
                        help="seconds a collective may wait (default "
                             "1800)")
    parser.add_argument("--step-hook", default=None,
                        help="MODULE:NAME, called with the trainer; "
                             "returns its step hook")
    args = parser.parse_args(argv)

    from .parallel import mesh as mesh_lib
    from .utils.config import load_config

    config = load_config(args.config)
    if config.get("seed") is None:
        config.seed = random.SystemRandom().randrange(1 << 31)
    log_dir = args.log_dir or os.path.join(
        config.logger.get("save_dir", "./logs"),
        config.logger.get("name", "run"))
    mesh = int(args.mesh or config.trainer.get("mesh_devices") or 1)
    num_nodes = int(config.trainer.get("num_nodes") or 1)
    device = "cuda" if args.device is None else args.device
    timeout_s = args.dist_timeout or mesh_lib.DEFAULT_TIMEOUT_S
    if "WORLD_SIZE" in os.environ:  # a torchrun rank
        rank = mesh_lib.from_env(args.mesh, num_nodes, device,
                                 args.dist_backend, timeout_s)
        try:
            config.seed = _rank0_seed(int(config.seed), rank)
            if rank.rank == 0:
                _save_config(config, log_dir, args.config)
            return run(rank, args, config.to_dict(), log_dir)
        finally:
            mesh_lib.destroy()
    _save_config(config, log_dir, args.config)
    if mesh > 1:
        threads = (max(1, (os.cpu_count() or 1) // mesh)
                   if device == "cpu" else None)
        mesh_lib.spawn(run, mesh, args=(args, config.to_dict(), log_dir),
                       num_nodes=num_nodes, device=device,
                       backend=args.dist_backend, timeout_s=timeout_s,
                       threads=threads)
        return 0
    return run(None, args, config.to_dict(), log_dir)


def _save_config(config, log_dir, path):
    from .utils.config import save_config

    os.makedirs(log_dir, exist_ok=True)
    save_config(config, os.path.join(log_dir, os.path.basename(path)))


def _rank0_seed(seed, rank):
    """Rank 0's seed on every torchrun rank (a null `seed` is drawn in
    each process)."""
    import torch
    import torch.distributed as dist

    value = torch.tensor([seed], dtype=torch.int64, device=rank.device)
    dist.broadcast(value, 0)
    return int(value)


def run(rank, args, config, log_dir):
    """One process's stage: the single-device run (`rank` None) or one
    rank of a mesh (`rank` its parallel.mesh.Mesh)."""
    from .training.trainer import Trainer
    from .utils.config import ConfigDict

    config = ConfigDict.from_dict(config)
    main = rank is None or rank.rank == 0
    trainer = Trainer(config, log_dir, batch_capacity=args.batch_capacity,
                      sample_budget=args.sample_budget, device=args.device,
                      field_chunk=args.field_chunk,
                      mesh_devices=1 if rank is None else rank.world)
    if args.step_hook:
        module, name = args.step_hook.split(":")
        trainer.step_hook = getattr(importlib.import_module(module),
                                    name)(trainer)
    start_epoch = 0
    resume_path = config.trainer.get("resume_from_checkpoint")
    if resume_path:
        start_epoch = trainer.resume(resume_path) + 1
        if main:
            print(f"resumed from {resume_path} at epoch {start_epoch}",
                  flush=True)
    if args.stage == "train":
        every = int(config.trainer.get("check_val_every_n_epoch", 1))

        def on_epoch_end(tr, epoch):
            if (epoch + 1) % every == 0:
                metric = tr.evaluate("val", epoch,
                                     max_images=args.max_eval_images)
                if main:
                    print(f"epoch {epoch}: val {metric}", flush=True)

        elapsed = trainer.train(max_steps=args.max_steps,
                                on_epoch_end=on_epoch_end,
                                start_epoch=start_epoch)
        if main:
            print(f"training finished in {elapsed:.1f}s "
                  f"({trainer.global_step} steps)", flush=True)
    else:
        metric = trainer.evaluate(args.stage, epoch=0,
                                  max_images=args.max_eval_images)
        if main:
            trainer.dump_metrics([metric], METRICS_FILENAME)
            print(metric, flush=True)
    return 0
