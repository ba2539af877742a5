"""Training loop (counterpart of deblur_e_nerf_tpu/training/trainer.py),
training only:

  - occupancy updates: every optimizer step during warmup, then every
    `occ_grid.n` steps;
  - the dynamic active-batch-size controller;
  - metrics consumed one step behind: each step queues one non-blocking
    device-to-host copy of its scalars (and, on a logged step, of the
    physics scalars), and the host waits for step s-1's copy after step s
    is queued, so the loop itself never synchronizes the device;
  - with `trainer.skip_nonfinite_updates` (default true) an update whose
    loss or gradients are not finite is skipped on the device, and the run
    stops after 25 consecutive skipped updates. (The JAX package skips on
    non-finite gradients but counts non-finite losses, so a finite loss
    with NaN gradients is skipped without counting; here both count.)
    With it false the update is applied and the run stops at the first
    non-finite loss, as in the JAX package;
  - scalars go to `metrics.jsonl` in the log directory, one JSON object
    per logged step (and the eval metrics, as "<stage>/<name>", at the
    step they were taken);
  - evaluation (`evaluate`): the posed views of each `eval_target`
    (`event_view`: the train views, `novel_view`: the stage's), rendered
    on the trainer's device, corrected and scored as in the JAX package
    (training/evaluation.py); `train(on_epoch_end=...)` calls a hook at
    every epoch end, and `dump_metrics` writes `metrics.yaml` without
    PyYAML.

Checkpoints, resume, gradient accumulation and the evaluation EMA of the
parameters (`trainer.ema_decay`) are still to be ported (ROADMAP Queue
A 9).
"""

import json
import math
import os
import time

import numpy as np
import torch

from ..data import events as events_data
from ..data import posed_images as posed_images_data
from ..models import event_gen, nerf_model, pixel_bandwidth
from ..utils.device import resolve_device
from . import evaluation, optim, pipeline, setup as setup_lib, step as step_lib

NONFINITE_STREAK_LIMIT = 25
CHECKPOINT_TODO = ("checkpoints and resume are not ported yet "
                   "(ROADMAP Queue A 9)")
EVAL_TARGETS = ("event_view", "novel_view")


class JsonlWriter:
    """Scalar log: one JSON object per line."""

    def __init__(self, path):
        self.path = path

    def write(self, step, scalars):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), **scalars}) + "\n")


def _set_matmul_precision(precision):
    if precision is None:
        return
    torch.set_float32_matmul_precision(str(precision))
    if str(precision) == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class Trainer:
    def __init__(self, config, log_dir, batch_capacity=8192,
                 sample_budget=None, device=None):
        self.config = config
        self.log_dir = log_dir
        self.device = resolve_device(device)
        os.makedirs(log_dir, exist_ok=True)
        if config.model.get("checkpoint_filepath"):
            raise NotImplementedError(
                f"model.checkpoint_filepath: {CHECKPOINT_TODO}")
        if config.trainer.get("resume_from_checkpoint"):
            raise NotImplementedError(
                f"trainer.resume_from_checkpoint: {CHECKPOINT_TODO}")
        if int(config.trainer.get("accumulate_grad_batches") or 1) != 1:
            raise NotImplementedError(
                "gradient accumulation is not ported yet (ROADMAP Queue A 9)")
        if float(config.trainer.get("ema_decay") or 0.0) > 0.0:
            raise NotImplementedError(
                "trainer.ema_decay (the evaluation EMA of the parameters) "
                "is not ported yet (ROADMAP Queue A 9)")
        self.skip_nonfinite = bool(
            config.trainer.get("skip_nonfinite_updates", True))
        _set_matmul_precision(config.get("float32_matmul_precision"))

        root = config.data.dataset_directory
        self.bundle, self.params = setup_lib.build(
            config, root, sample_budget=sample_budget, device=self.device)
        self.batch_capacity = batch_capacity
        trainer_cfg = config.trainer
        self.max_epochs = int(trainer_cfg.max_epochs)
        self.steps_per_epoch = int(trainer_cfg.limit_train_batches)
        model = self.params.nerf
        self.optimizer, self.trainable_mask = optim.build(
            self.params, config.optimizer, config.lr_scheduler,
            float(config.loss.weight.nerf_mlp_weight_decay),
            float(self.bundle.consts["refractory_period"]
                  ["max_refractory_period"]),
            steps_per_epoch=self.steps_per_epoch,
            model_configs={c: config.model[c] for c in
                           ("contrast_threshold", "refractory_period",
                            "nerf", "pixel_bandwidth")},
            table_decay=model.table_decay,
            skip_nonfinite=self.skip_nonfinite,
        )
        self.step_fn = step_lib.make_train_step(
            self.params, self.bundle.consts, self.optimizer,
            self.bundle.static_config, self.bundle.loss_config)
        self.occ_state = nerf_model.init_occupancy(model, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.get("seed") or 0))

        events = events_data.EventDataset(
            root, config.data.get("train_dataset_perm_seed")).events
        ratio = config.data.train_dataset_ratio
        if isinstance(ratio, float):
            dataset_len = int(ratio * len(events["position"]))
        else:
            dataset_len = int(ratio) * int(
                config.data.train_init_eff_batch_size)
        self.batcher = pipeline.EventBatcher(
            events, capacity=batch_capacity,
            seed=int(config.get("seed") or 0), dataset_len=dataset_len,
            has_bayer=self.bundle.static_config.has_bayer)
        self.batch_controller = pipeline.BatchSizeController(
            target_ray_samples=int(
                config.data.train_eff_ray_sample_batch_size),
            init_batch_size=int(config.data.train_init_eff_batch_size),
            capacity=batch_capacity,
            min_batch=int(config.data.get("train_min_eff_batch_size", 1)),
        )
        self.writer = JsonlWriter(os.path.join(log_dir, "metrics.jsonl"))
        self.log_every = int(trainer_cfg.get("log_every_n_steps") or 100)
        self.global_step = 0
        self._pending_metrics = None
        self._nonfinite_streak = 0
        self.last_metrics = None

    def update_occupancy(self, step=None):
        """One occupancy update at optimizer step `step` (default: the
        current step); a step below occ_grid.warmup_steps updates the
        full grid."""
        step = self.global_step if step is None else int(step)
        model = self.params.nerf
        self.occ_state = nerf_model.update_occupancy(
            model, self.occ_state, step, self.generator,
            level_mask=nerf_model.level_mask_for_step(model, step,
                                                      self.device))
        return self.occ_state

    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _logs(self, step):
        return step % self.log_every == 0 or step == 1

    def _physics_scalars(self):
        """The physical quantities behind the parameters, as tensors."""
        p, c = self.params, self.bundle.consts
        _, _, mean_ct = event_gen.contrast_thresholds(
            p.contrast_threshold, c["contrast_threshold"])
        tau = event_gen.refractory_period(p.refractory_period,
                                          c["refractory_period"])
        physics = {"train/mean_contrast_threshold": mean_ct,
                   "train/refractory_period": tau}
        if hasattr(p, "pixel_bandwidth"):
            eff = pixel_bandwidth.effective_params(p.pixel_bandwidth)
            physics.update({f"train/pixel_bandwidth/{k}": v
                            for k, v in eff.items()})
        return physics

    @torch.no_grad()
    def _stage_metrics(self, step, metrics):
        """Queue the copy of step `step`'s scalars to the host; returns
        what `_consume_metrics` reads."""
        scalars = {k: v for k, v in metrics.items()
                   if torch.is_tensor(v) and v.numel() == 1}
        if self._logs(step):
            scalars.update(self._physics_scalars())
        stacked = torch.stack([
            torch.as_tensor(v, device=self.device).detach().reshape(())
            .to(torch.float64) for v in scalars.values()])
        event = None
        if stacked.device.type == "cuda":
            # a pinned host buffer, filled when the device reaches here
            stacked = stacked.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return step, list(scalars), stacked, event

    def _consume_metrics(self, step, names, values, event):
        """Host-side processing of one step's metrics (one step behind)."""
        if event is not None:
            event.synchronize()
        scalars = dict(zip(names, values.tolist()))
        physics = {k: scalars.pop(k) for k in list(scalars)
                   if k.startswith("train/")}
        self.last_metrics = scalars
        self.batch_controller.update(scalars["mean_num_samples_per_ray"])
        if self.skip_nonfinite:
            bad = bool(scalars["update_skipped"])
            limit = NONFINITE_STREAK_LIMIT
        else:
            bad = not math.isfinite(scalars["loss"])
            limit = 1
        if bad:
            self._nonfinite_streak += 1
            print(f"WARNING: non-finite update at step {step} (loss "
                  f"{scalars['loss']}, update "
                  f"{'skipped' if self.skip_nonfinite else 'APPLIED'}, "
                  f"streak {self._nonfinite_streak})", flush=True)
            if self._nonfinite_streak >= limit:
                raise FloatingPointError(
                    f"{self._nonfinite_streak} consecutive non-finite "
                    f"updates (at step {step}); metrics: {scalars}")
        else:
            self._nonfinite_streak = 0
        if self._logs(step):
            self.writer.write(step, {
                **{f"train/{k}": v for k, v in scalars.items()
                   if math.isfinite(v)},
                **physics,
            })

    def _flush_pending_metrics(self):
        if self._pending_metrics is not None:
            prev, self._pending_metrics = self._pending_metrics, None
            self._consume_metrics(*prev)

    def train_step(self):
        """One optimizer step (with its occupancy update, if due)."""
        model = self.params.nerf
        occ_cfg = model.occ_grid_config
        step = self.global_step
        if step < int(occ_cfg.warmup_steps) or step % int(occ_cfg.n) == 0:
            self.update_occupancy(step)
        batch = self._to_device(
            self.batcher.next_batch(self.batch_controller.active))
        draws = step_lib.draw_step(
            self.bundle.static_config, self.batch_capacity, self.occ_state,
            self.generator, self.device)
        metrics = self.step_fn(
            self.occ_state, batch, draws,
            level_mask=nerf_model.level_mask_for_step(model, step,
                                                      self.device))
        self.global_step += 1
        prev = self._pending_metrics
        self._pending_metrics = self._stage_metrics(self.global_step,
                                                    metrics)
        if prev is not None:
            self._consume_metrics(*prev)
        return metrics

    def train(self, max_steps=None, on_epoch_end=None):
        """Train for max_epochs x limit_train_batches steps (or
        `max_steps`), calling `on_epoch_end(trainer, epoch)` after each
        epoch's last step; returns the elapsed seconds."""
        total = self.max_epochs * self.steps_per_epoch
        if max_steps is not None:
            total = min(total, int(max_steps))
        t_start = time.time()
        while self.global_step < total:
            self.train_step()
            if self.global_step % self.steps_per_epoch == 0:
                self._flush_pending_metrics()
                if on_epoch_end is not None:
                    on_epoch_end(self, self.global_step
                                 // self.steps_per_epoch - 1)
        self._flush_pending_metrics()
        return time.time() - t_start

    def build_evaluator(self, stage="val"):
        """{target: (Evaluator, PosedImageDataset)} for `eval_target`, and
        the image renderer. `event_view` evaluates the train views,
        `novel_view` the stage's; with both, each has its own evaluator,
        artifact directory and metric names."""
        config = self.config
        eval_target = list(config.get("eval_target", ["novel_view"]))
        if not eval_target or not set(eval_target) <= set(EVAL_TARGETS):
            raise NotImplementedError(
                f"unsupported eval_target {eval_target!r}; supported "
                f"subsets of {list(EVAL_TARGETS)}")
        multi = len(set(eval_target)) > 1
        targets = {}
        for target in dict.fromkeys(eval_target):
            dataset = posed_images_data.PosedImageDataset(
                config.data.dataset_directory,
                "train" if target == "event_view" else stage,
                config.data.get("eval_dataset_perm_seed"),
                bool(config.data.alpha_over_white_bg))
            evaluator = evaluation.Evaluator(
                config.model.correction, self.bundle.static_config.has_bayer,
                log_dir=(os.path.join(self.log_dir, target) if multi
                         else self.log_dir),
                save_pred_intensity_img=bool(config.model.get(
                    "eval_save_pred_intensity_img", False)),
                device=self.device)
            targets[target] = (evaluator, dataset)
        render_image = evaluation.make_render_image_fn(
            self.params.nerf, eval_prepass_div=config.model.nerf.get(
                "eval_occlusion_prepass_div"))
        return targets, render_image

    def evaluate(self, stage="val", epoch=0, max_images=None):
        """Evaluate the current parameters on `stage`'s views; returns
        {name: value} (with several targets, "<target>/<name>")."""
        self._flush_pending_metrics()
        targets, render_image = self.build_evaluator(stage)
        multi = len(targets) > 1
        merged = {}
        for target, (evaluator, dataset) in targets.items():
            tag = f"{stage}/{target}" if multi else stage
            metric = self._evaluate_dataset(evaluator, dataset, render_image,
                                            tag, epoch, max_images)
            for name, value in metric.items():
                merged[f"{target}/{name}" if multi else name] = value
        return merged

    def _evaluate_dataset(self, evaluator, dataset, render_image, stage,
                          epoch, max_images=None):
        data = dataset.posed_imgs
        intrinsics_inv = torch.as_tensor(
            np.linalg.inv(data["intrinsics"]), dtype=torch.float32)
        H, W = data["img"].shape[-2:]
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        pixel_pos = torch.as_tensor(np.stack([xs, ys], axis=-1),
                                    dtype=torch.float32)
        n = len(data["img"])
        if max_images is not None:
            n = min(n, max_images)
        min_intensity = self.bundle.static_config.min_modeled_intensity
        outputs = []
        for i in range(n):
            img = render_image(
                self.occ_state, intrinsics_inv, pixel_pos,
                torch.as_tensor(data["T_wc_position"][i]),
                torch.as_tensor(data["T_wc_orientation"][i]))
            out = {
                "sample_id": data["sample_id"][i],
                "pred_intensity_img": img.cpu().numpy() + min_intensity,
                "target_intensity_img": data["img"][i],
            }
            for key in ("exposure_time", "gain"):
                if key in data:
                    out[key] = data[key][i]
            outputs.append(out)
        metric = evaluator.epoch_end(
            outputs, dataset.min_normalized_pixel_value,
            dataset.max_normalized_pixel_value, epoch=epoch,
            lpips_net=str(self.config.metric.lpips_net),
            lpips_weights_path=self.config.metric.get("lpips_weights_path"))
        self.writer.write(self.global_step, {
            f"{stage}/{name}": value for name, value in metric.items()
            if math.isfinite(value)})
        return metric

    def dump_metrics(self, metrics_list, filename="metrics.yaml"):
        """Write a list of flat {name: float} maps as YAML (no PyYAML on
        the card machine); PyYAML loads it back to the same values."""
        with open(os.path.join(self.log_dir, filename), "w") as f:
            f.write(yaml_metrics(metrics_list))

    def resume(self, path):
        raise NotImplementedError(f"resume: {CHECKPOINT_TODO}")


def _yaml_float(value):
    """A float as a YAML 1.1 float scalar that reads back exactly."""
    value = float(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value)
    mantissa, _, exponent = text.partition("e")
    if "." not in mantissa:  # YAML 1.1 floats need a dot
        mantissa += ".0"
    return mantissa + ("e" + exponent if exponent else "")


def yaml_metrics(metrics_list):
    """The YAML text of a list of flat {name: float} maps, names sorted."""
    lines = []
    for metrics in metrics_list:
        if not metrics:
            lines.append("- {}")
        for i, name in enumerate(sorted(metrics)):
            lines.append(f"{'- ' if i == 0 else '  '}{json.dumps(str(name))}: "
                         f"{_yaml_float(metrics[name])}")
    return "\n".join(lines) + "\n" if lines else "[]\n"
