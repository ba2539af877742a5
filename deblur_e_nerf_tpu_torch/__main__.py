"""Command line: python -m deblur_e_nerf_tpu_torch train <config.yaml>.

Mirrors the JAX package's scripts/run.py for the training stage: loads the
YAML config, draws a seed when `seed` is null (recorded in the config
copy), builds the Trainer and trains. The val and test stages raise until
evaluation is ported (ROADMAP Queue A 11).
"""

import argparse
import os
import random
import sys

STAGES = ("train", "val", "test")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m deblur_e_nerf_tpu_torch")
    parser.add_argument("stage", choices=STAGES)
    parser.add_argument("config")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--batch-capacity", type=int, default=8192)
    parser.add_argument("--sample-budget", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from .training.trainer import EVAL_TODO, Trainer
    from .utils.config import load_config, save_config

    if args.stage != "train":
        raise NotImplementedError(EVAL_TODO)
    config = load_config(args.config)
    if config.get("seed") is None:
        config.seed = random.SystemRandom().randrange(1 << 31)
    log_dir = args.log_dir or os.path.join(
        config.logger.get("save_dir", "./logs"),
        config.logger.get("name", "run"))
    os.makedirs(log_dir, exist_ok=True)
    save_config(config, os.path.join(log_dir,
                                     os.path.basename(args.config)))
    trainer = Trainer(config, log_dir, batch_capacity=args.batch_capacity,
                      sample_budget=args.sample_budget, device=args.device)
    elapsed = trainer.train(max_steps=args.max_steps)
    print(f"training finished in {elapsed:.1f}s "
          f"({trainer.global_step} steps)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
