"""Command line: python -m deblur_e_nerf_tpu_torch {train,val,test} <config.yaml>.

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
"""

import argparse
import os
import random
import sys

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
    args = parser.parse_args(argv)

    from .training.trainer import Trainer
    from .utils.config import load_config, save_config

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
                      sample_budget=args.sample_budget, device=args.device,
                      field_chunk=args.field_chunk)
    start_epoch = 0
    resume_path = config.trainer.get("resume_from_checkpoint")
    if resume_path:
        start_epoch = trainer.resume(resume_path) + 1
        print(f"resumed from {resume_path} at epoch {start_epoch}",
              flush=True)
    if args.stage == "train":
        every = int(config.trainer.get("check_val_every_n_epoch", 1))

        def on_epoch_end(tr, epoch):
            if (epoch + 1) % every == 0:
                metric = tr.evaluate("val", epoch,
                                     max_images=args.max_eval_images)
                print(f"epoch {epoch}: val {metric}", flush=True)

        elapsed = trainer.train(max_steps=args.max_steps,
                                on_epoch_end=on_epoch_end,
                                start_epoch=start_epoch)
        print(f"training finished in {elapsed:.1f}s "
              f"({trainer.global_step} steps)", flush=True)
    else:
        metric = trainer.evaluate(args.stage, epoch=0,
                                  max_images=args.max_eval_images)
        trainer.dump_metrics([metric], METRICS_FILENAME)
        print(metric, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
