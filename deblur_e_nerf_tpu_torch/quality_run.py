"""Quality-parity harness on the port: event-only training to a reported
PSNR/SSIM (counterpart of scripts/quality_run.py, with the same arguments
and outputs; `--device` in place of `--platform`).

Trains a config from simulated events alone on a dense textured-sphere
scene (generated when the data root has no `raw_events.npz`), evaluating
novel-view PSNR/SSIM every epoch against the FLAT-FIELD BASELINE (the
best constant-image PSNR: the score of the known training-collapse
minimum). Emits:

  <log_dir>/psnr_vs_steps.csv   step, psnr, ssim, flat_psnr per epoch
  <log_dir>/metrics.yaml        final val+test metrics, the flat-field
                                PSNR, the learned and initial filter
                                parameters, the best checkpoint's metrics

Run on the card (default) or on the CPU (`--device cpu`):

  python -m deblur_e_nerf_tpu_torch.quality_run \\
      --config configs/train/quality_sphere_blur32_dense_r5fix.yaml \\
      --data-root DATA --log-dir LOG --img-size 192 \\
      --contrast-threshold 0.05 --orbits 3 --pixel-filter full \\
      --bandwidth-scale 32 --batch-capacity 1024

A run continues from one of its checkpoints with `--resume
LOG/checkpoints/epoch_NNNN` (the next epoch on; the CSV is appended to).
LPIPS is NaN unless the config names local weights
(`metric.lpips_weights_path`).
"""

import argparse
import csv
import os

import numpy as np


def flat_field_psnr(dataset):
    """Best-constant-image PSNR per eval view (mean over views).

    The flat minimum renders a constant intensity; after the eval
    pipeline's affine log correction the best it can score is the
    per-image-mean constant, whose PSNR this computes directly (float64).
    """
    from .training import metrics as metrics_lib

    data = dataset.posed_imgs
    rng = (dataset.max_normalized_pixel_value
           - dataset.min_normalized_pixel_value)
    vals = []
    for img in np.asarray(data["img"], np.float64):
        if img.ndim == 2:
            img = img[None]
        const = np.full_like(img, img.mean())
        vals.append(metrics_lib.psnr(const[None], img[None], rng))
    return float(np.mean(vals))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deblur_e_nerf_tpu_torch.quality_run")
    parser.add_argument("--config",
                        default="configs/train/quality_sphere.yaml")
    parser.add_argument("--data-root", default="/tmp/denerf_quality_ds")
    parser.add_argument("--log-dir", default="/tmp/denerf_quality_log")
    parser.add_argument("--img-size", type=int, default=128)
    # the event simulation renders at pose timestamps, so num_frames is
    # capped at num_poses: event-timestamp density comes from dense poses
    parser.add_argument("--num-poses", type=int, default=1501)
    parser.add_argument("--num-frames", type=int, default=1501)
    parser.add_argument("--contrast-threshold", type=float, default=0.1)
    parser.add_argument("--orbits", type=int, default=2)
    parser.add_argument(
        "--bandwidth-tau-ns", type=float, default=None,
        help=("simulate motion-blurred events: 1st-order pixel-bandwidth "
              "LPF time constant in ns (for blur-model quality runs)"))
    parser.add_argument(
        "--pixel-filter", default=None, choices=["none", "full"],
        help=("'full': simulate events through the reference's full "
              "4th-order pixel circuit (the deblurring model's class)"))
    parser.add_argument(
        "--bandwidth-scale", type=float, default=1.0,
        help=("scale every pixel-circuit time constant (heavier blur); "
              "written into the dataset calibration so the model "
              "calibrates to the generator"))
    parser.add_argument("--batch-capacity", type=int, default=8192)
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--max-eval-images", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without one) or "
                             "'cpu'")
    parser.add_argument("--resume", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from .data import synthetic
    from .models import pixel_bandwidth
    from .training.trainer import Trainer
    from .utils.config import load_config
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.data_root, "raw_events.npz")):
        print("generating dataset...", flush=True)
        synthetic.make_dataset(
            args.data_root, img_height=args.img_size,
            img_width=args.img_size, num_poses=args.num_poses,
            num_frames=args.num_frames, num_views=8,
            contrast_threshold=args.contrast_threshold,
            orbits=args.orbits, bandwidth_tau_ns=args.bandwidth_tau_ns,
            pixel_filter=args.pixel_filter,
            bandwidth_scale=args.bandwidth_scale, write_views=True,
            filter_device=device.type)
    n_events = len(np.load(
        os.path.join(args.data_root, "raw_events.npz"))["timestamp"])
    print(f"dataset: {n_events} events", flush=True)

    config = load_config(args.config)
    config.data.dataset_directory = args.data_root
    if args.max_epochs is not None:
        config.trainer.max_epochs = args.max_epochs
    if args.steps_per_epoch is not None:
        config.trainer.limit_train_batches = args.steps_per_epoch

    trainer = Trainer(config, args.log_dir,
                      batch_capacity=args.batch_capacity, device=device)
    init_filter = None
    if hasattr(trainer.params, "pixel_bandwidth"):
        init_filter = {k: float(v.detach()) for k, v in pixel_bandwidth
                       .effective_params(trainer.params.pixel_bandwidth)
                       .items()}

    targets, _ = trainer.build_evaluator("val")
    _, val_dataset = next(iter(targets.values()))
    flat_psnr = flat_field_psnr(val_dataset)
    print(f"flat-field baseline PSNR: {flat_psnr:.2f} dB", flush=True)

    csv_path = os.path.join(args.log_dir, "psnr_vs_steps.csv")
    write_header = not os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as csv_f:
        writer = csv.writer(csv_f)
        if write_header:
            writer.writerow(["step", "psnr", "ssim", "flat_psnr"])

        def on_epoch_end(tr, epoch):
            metric = tr.evaluate("val", epoch,
                                 max_images=args.max_eval_images)
            writer.writerow([tr.global_step, metric.get("psnr"),
                             metric.get("ssim"), flat_psnr])
            csv_f.flush()
            print(f"epoch {epoch} step {tr.global_step}: "
                  f"psnr={metric.get('psnr'):.2f} (flat {flat_psnr:.2f}) "
                  f"ssim={metric.get('ssim'):.4f}", flush=True)

        start_epoch = 0
        if args.resume:
            start_epoch = trainer.resume(args.resume) + 1
            print(f"resumed at epoch {start_epoch}", flush=True)
        elapsed = trainer.train(on_epoch_end=on_epoch_end,
                                start_epoch=start_epoch)
    print(f"training finished in {elapsed:.0f}s", flush=True)

    max_epochs = config.trainer.max_epochs
    final_val = trainer.evaluate("val", epoch=max_epochs)
    final_test = trainer.evaluate("test", epoch=max_epochs)
    rows = [
        {"stage": "val", **{k: float(v) for k, v in final_val.items()}},
        {"stage": "test", **{k: float(v) for k, v in final_test.items()}},
        {"flat_field_psnr": flat_psnr},
    ]
    if init_filter is not None:
        # learned vs calibrated-init circuit parameters: the evidence
        # that the blur model is identifying the generator's filter
        learned = pixel_bandwidth.effective_params(
            trainer.params.pixel_bandwidth)
        rows.append({
            "pixel_bandwidth_learned":
                {k: float(v.detach()) for k, v in learned.items()},
            "pixel_bandwidth_init": init_filter,
        })
    # supplementary: metrics at the best monitored checkpoint (when
    # checkpoint.monitor is set); the final rows above stay the protocol
    # numbers. Runs after the learned-params row: resume overwrites the
    # final-step state.
    best = trainer.best_checkpoint
    if best and os.path.exists(best):
        best_name = os.path.basename(best)
        if best_name != f"epoch_{max_epochs - 1:04d}":
            trainer.resume(best)
            best_val = trainer.evaluate("val", epoch=max_epochs + 1)
            best_test = trainer.evaluate("test", epoch=max_epochs + 1)
            rows.append({"stage": "val_best", "checkpoint": best_name,
                         **{k: float(v) for k, v in best_val.items()}})
            rows.append({"stage": "test_best", "checkpoint": best_name,
                         **{k: float(v) for k, v in best_test.items()}})
            print("best-checkpoint val:", best_name, best_val, flush=True)
    trainer.dump_metrics(rows, "metrics.yaml")
    print("final val:", final_val, flush=True)
    print("final test:", final_test, flush=True)
    print(f"PSNR margin over flat field: "
          f"{final_val['psnr'] - flat_psnr:+.2f} dB", flush=True)
    return rows


if __name__ == "__main__":
    main()
