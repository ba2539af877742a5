"""Training loop (counterpart of deblur_e_nerf_tpu/training/trainer.py):

  - gradient accumulation (`trainer.accumulate_grad_batches` k): each
    `train_step` is one micro-step; the optimizer keeps the running mean
    of k micro-batch gradients and updates at the k-th (optim.py), and the
    lr schedule counts optimizer steps;
  - occupancy updates at accumulation-window starts, on optimizer step
    `global_step // k`: every optimizer step during warmup, then every
    `occ_grid.n`-th, with the curriculum level mask at `opt_step * k`;
  - the dynamic active-batch-size controller, refreshed only where the
    next window starts, so the micro-batches of one window have equal
    sizes;
  - metrics consumed one step behind: each step queues one non-blocking
    device-to-host copy of its scalars (and, on a logged step, of the
    physics scalars), and the host waits for step s-1's copy after step s
    is queued, so the loop itself never synchronizes the device;
  - with `trainer.skip_nonfinite_updates` (default true) a micro-step
    whose loss or gradients are not finite is dropped on the device, and
    the run stops after 25 consecutive dropped micro-steps. (The JAX
    package skips on non-finite gradients but counts non-finite losses,
    so a finite loss with NaN gradients is skipped without counting; here
    both count.) With it false the update is applied and the run stops at
    the first non-finite loss, as in the JAX package;
  - the evaluation EMA of the parameters (`trainer.ema_decay` d > 0):
    ema = ema * d + p * (1 - d) after every micro-step, on the device;
    `evaluate` renders with it;
  - checkpoints (training/checkpoint.py) under `<log_dir>/checkpoints/`:
    `epoch_%04d` at the end of every `checkpoint.every_n_epochs`-th and
    of the last epoch, `config.yaml` once, the monitored score in
    `monitor_scores.json`, pruned to `save_top_k` with Lightning's
    semantics; `resume` restores a run, and `model.checkpoint_filepath`
    loads the components whose `load_state_dict` is set at construction
    (the occupancy grid with `nerf`);
  - `trainer.profile_steps: [start, stop]`: a torch.profiler trace of
    those micro-steps in `<log_dir>/profile`;
  - scalars go to `metrics.jsonl` in the log directory, one JSON object
    per logged step (and the eval metrics, as "<stage>/<name>", at the
    step they were taken);
  - the occlusion prepass (model.nerf.occlusion_prepass_div) runs on a
    step only once the live demand of each of the last PREPASS_WINDOW
    read steps fits its K / div buffer with the sample budget's margin
    (data.train_sample_budget_margin m: prepass_overflow_rate x m <= 1),
    and stops at the first read step that does not fit; a fresh or
    resumed trainer starts without it. A step without it runs the field
    on the marched buffer and drops no live sample; the JAX package
    always runs it, and a fresh field's demand overflows the buffer
    (ROADMAP Queue C 9). The scalar `prepass_ran` logs the path a step
    took;
  - evaluation (`evaluate`): the posed views of each `eval_target`
    (`event_view`: the train views, `novel_view`: the stage's), rendered
    on the trainer's device, corrected and scored as in the JAX package
    (training/evaluation.py); `train(on_epoch_end=...)` calls a hook at
    every epoch end, and `dump_metrics` writes `metrics.yaml` without
    PyYAML.
"""

import copy
import json
import math
import os
import shutil
import time

import numpy as np
import torch

from ..data import events as events_data
from ..data import posed_images as posed_images_data
from ..models import event_gen, nerf_model, occupancy, pixel_bandwidth
from ..utils import config as config_lib
from ..utils.device import resolve_device
from . import (checkpoint as checkpoint_lib, evaluation, optim, pipeline,
               setup as setup_lib, step as step_lib)

NONFINITE_STREAK_LIMIT = 25
# consecutive read steps whose live demand must fit the prepass buffer
# before the prepass runs: early in training the occupancy grid and the
# batch controller swing a step's demand by far more than the margin (on
# the r5fix config at full width, an H100 run marched 139k samples on one
# step and 9.27M two steps later)
PREPASS_WINDOW = 16
EVAL_TARGETS = ("event_view", "novel_view")
COMPONENTS = ("contrast_threshold", "refractory_period", "nerf",
              "pixel_bandwidth")
CHECKPOINT_DIR = "checkpoints"
SCORES_FILENAME = "monitor_scores.json"


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
                 sample_budget=None, device=None, field_chunk=0):
        for key in ("mesh_devices", "num_nodes"):
            if int(config.trainer.get(key) or 1) > 1:
                raise NotImplementedError(
                    f"trainer.{key} {config.trainer.get(key)}: data "
                    "parallelism is not ported yet (ROADMAP Queue A 12b); "
                    "the port trains on one device")
        self.config = config
        self.log_dir = log_dir
        self.device = resolve_device(device)
        os.makedirs(log_dir, exist_ok=True)
        self.skip_nonfinite = bool(
            config.trainer.get("skip_nonfinite_updates", True))
        _set_matmul_precision(config.get("float32_matmul_precision"))

        root = config.data.dataset_directory
        self.bundle, self.params = setup_lib.build(
            config, root, sample_budget=sample_budget, device=self.device,
            field_chunk=field_chunk)
        restored_occ = self._selective_restore()
        self.batch_capacity = batch_capacity
        trainer_cfg = config.trainer
        self.max_epochs = int(trainer_cfg.max_epochs)
        self.steps_per_epoch = int(trainer_cfg.limit_train_batches)
        self.accumulate = int(trainer_cfg.get("accumulate_grad_batches")
                              or 1)
        model = self.params.nerf
        self.optimizer, self.trainable_mask = optim.build(
            self.params, config.optimizer, config.lr_scheduler,
            float(config.loss.weight.nerf_mlp_weight_decay),
            float(self.bundle.consts["refractory_period"]
                  ["max_refractory_period"]),
            steps_per_epoch=self.steps_per_epoch // self.accumulate,
            model_configs={c: config.model[c] for c in COMPONENTS},
            table_decay=model.table_decay,
            skip_nonfinite=self.skip_nonfinite,
            accumulate=self.accumulate,
        )
        self.step_fn = step_lib.make_train_step(
            self.params, self.bundle.consts, self.optimizer,
            self.bundle.static_config, self.bundle.loss_config)
        self.occ_state = nerf_model.init_occupancy(model, self.device)
        if restored_occ is not None:
            self.occ_state = occupancy.OccupancyGridState(
                occs=restored_occ["occs"].to(torch.float32),
                binary=restored_occ["binary"].to(torch.bool))
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
        # the evaluation EMA, seeded from the parameters after any
        # selective restore
        self.ema_decay = float(trainer_cfg.get("ema_decay") or 0.0)
        self.ema_params = None
        if self.ema_decay > 0.0:
            self.ema_params = copy.deepcopy(self.params).requires_grad_(
                False)
        self.writer = JsonlWriter(os.path.join(log_dir, "metrics.jsonl"))
        self.log_every = int(trainer_cfg.get("log_every_n_steps") or 100)
        self.global_step = 0
        self._pending_metrics = None
        self.prepass_margin = float(
            config.data.get("train_sample_budget_margin", 1.0))
        self.prepass_on = False
        self._prepass_fits = 0
        self._nonfinite_streak = 0
        self.last_metrics = None
        # monitored checkpoints: the last eval's "<stage>/<name>" values,
        # each kept checkpoint's score, and the best checkpoint's path
        self._last_eval = {}
        self._ckpt_scores = {}
        self.best_checkpoint = None
        self._profiler = None

    def _selective_restore(self):
        """Load the components flagged by model.<component>.load_state_dict
        from model.checkpoint_filepath; returns the checkpoint's occupancy
        grid when the NeRF was loaded (it rides with the NeRF component),
        else None."""
        mc = self.config.model
        path = mc.get("checkpoint_filepath")
        flags = {c: bool(mc[c].get("load_state_dict", False))
                 for c in COMPONENTS if hasattr(self.params, c)}
        if not (path and any(flags.values())):
            return None
        restored = checkpoint_lib.restore(path, self.device)
        checkpoint_lib.selective_restore_params(
            self.params, restored["params"], flags)
        if flags.get("nerf") and "occ_state" in restored:
            return restored["occ_state"]
        return None

    def update_occupancy(self, step=None):
        """One occupancy update at optimizer step `step` (default: the
        current one); a step below occ_grid.warmup_steps updates the full
        grid. The curriculum level mask is the one at micro-step
        step x accumulate."""
        step = self.global_step // self.accumulate if step is None \
            else int(step)
        model = self.params.nerf
        self.occ_state = nerf_model.update_occupancy(
            model, self.occ_state, step, self.generator,
            self.bundle.consts["trajectory"].T_wc_position,
            level_mask=nerf_model.level_mask_for_step(
                model, step * self.accumulate, self.device))
        return self.occ_state

    @torch.no_grad()
    def _update_ema(self):
        d = self.ema_decay
        ema = list(self.ema_params.parameters())
        live = [p.detach() for p in self.params.parameters()]
        scaled = torch._foreach_mul(live, 1.0 - d)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, scaled)

    def eval_params(self):
        """The parameters evaluation renders with: the EMA when there is
        one, else the live ones."""
        return self.ema_params if self.ema_params is not None \
            else self.params

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
        # step s's metrics are read after step s + 1 is queued, so a
        # refresh takes effect at step s + 2: refresh only where that
        # starts an accumulation window
        if (step + 1) % self.accumulate == 0:
            self.batch_controller.update(
                scalars["mean_num_samples_per_ray"])
        if self.params.nerf.render_config.prepass_div:
            fits = scalars["prepass_overflow_rate"] * self.prepass_margin \
                <= 1.0
            self._prepass_fits = self._prepass_fits + 1 if fits else 0
            self.prepass_on = self._prepass_fits >= PREPASS_WINDOW
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
        """One micro-step (with its occupancy update, if due at this
        window start)."""
        model = self.params.nerf
        occ_cfg = model.occ_grid_config
        step = self.global_step
        if step % self.accumulate == 0:
            opt_step = step // self.accumulate
            if opt_step < int(occ_cfg.warmup_steps) \
                    or opt_step % int(occ_cfg.n) == 0:
                self.update_occupancy(opt_step)
        batch = self._to_device(
            self.batcher.next_batch(self.batch_controller.active))
        draws = step_lib.draw_step(
            self.bundle.static_config, self.batch_capacity, self.occ_state,
            self.generator, self.device)
        metrics = self.step_fn(
            self.occ_state, batch, draws,
            level_mask=nerf_model.level_mask_for_step(model, step,
                                                      self.device),
            prepass=self.prepass_on)
        if self.ema_params is not None:
            self._update_ema()
        self.global_step += 1
        prev = self._pending_metrics
        self._pending_metrics = self._stage_metrics(self.global_step,
                                                    metrics)
        if prev is not None:
            self._consume_metrics(*prev)
        return metrics

    def _profile(self, window, before_step):
        """trainer.profile_steps [start, stop]: trace micro-steps start..
        stop-1 with torch.profiler into <log_dir>/profile; the device is
        synchronized only at the window's end."""
        if not window:
            return
        start, stop = int(window[0]), int(window[1])
        if before_step and self.global_step == start \
                and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
        elif not before_step and self.global_step == stop \
                and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            out = os.path.join(self.log_dir, "profile")
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(out, f"trace_{start}_{stop}.json"))
            with open(os.path.join(out, f"ops_{start}_{stop}.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(row_limit=50))

    def train(self, max_steps=None, on_epoch_end=None, start_epoch=None):
        """Train epochs start_epoch..max_epochs-1 (default: from the
        epoch `global_step` is in) of limit_train_batches micro-steps,
        stopping once `global_step` reaches `max_steps`. After each whole
        epoch: `on_epoch_end(trainer, epoch)`, then the checkpoint when
        due. Returns the elapsed seconds."""
        total = self.max_epochs * self.steps_per_epoch
        if max_steps is not None:
            total = min(total, int(max_steps))
        first = self.global_step // self.steps_per_epoch \
            if start_epoch is None else int(start_epoch)
        window = self.config.trainer.get("profile_steps")
        t_start = time.time()
        for epoch in range(first, self.max_epochs):
            for _ in range(self.steps_per_epoch):
                if self.global_step >= total:
                    break
                self._profile(window, before_step=True)
                self.train_step()
                self._profile(window, before_step=False)
            else:
                self._flush_pending_metrics()
                if on_epoch_end is not None:
                    on_epoch_end(self, epoch)
                self._checkpoint_epoch(epoch)
                continue
            break
        self._flush_pending_metrics()
        return time.time() - t_start

    # ---------------------------------------------------------------- ckpt
    def _checkpoint_dir(self):
        return os.path.join(self.log_dir, CHECKPOINT_DIR)

    def _checkpoint_epoch(self, epoch):
        """Save at the end of every every_n_epochs-th epoch and of the
        last; record the monitored score; prune to save_top_k."""
        ckpt_cfg = self.config.get("checkpoint") or {}
        every_n = int(ckpt_cfg.get("every_n_epochs") or 1)
        if not ((epoch + 1) % every_n == 0 or epoch == self.max_epochs - 1):
            return
        path = self.save_checkpoint(epoch)
        monitor = ckpt_cfg.get("monitor")
        if monitor:
            score = self._last_eval.get(str(monitor))
            if score is not None and math.isfinite(score):
                self._ckpt_scores[os.path.basename(path)] = float(score)
                self._persist_ckpt_scores()
        self._prune_checkpoints(int(ckpt_cfg.get("save_top_k", -1)),
                                monitor=monitor,
                                mode=str(ckpt_cfg.get("mode") or "min"))

    def save_checkpoint(self, epoch):
        """Write `<log_dir>/checkpoints/epoch_%04d` (and, once,
        config.yaml beside it); returns its path. The payload is
        training/checkpoint.py's."""
        self._flush_pending_metrics()
        ckpt_dir = self._checkpoint_dir()
        config_path = os.path.join(ckpt_dir, "config.yaml")
        if not os.path.isfile(config_path):
            os.makedirs(ckpt_dir, exist_ok=True)
            config_lib.save_config(self.config, config_path)
        payload = {
            "params": checkpoint_lib.component_state(self.params),
            "opt_state": self.optimizer.state_dict(),
            "occ_state": {"occs": self.occ_state.occs,
                          "binary": self.occ_state.binary},
            "step": self.global_step,
            "epoch": int(epoch),
            "global_step": self.global_step,
        }
        if self.ema_params is not None:
            payload["ema_params"] = checkpoint_lib.component_state(
                self.ema_params)
        path = os.path.join(ckpt_dir, f"epoch_{int(epoch):04d}")
        checkpoint_lib.save(path, payload)
        return path

    def _scores_path(self):
        return os.path.join(self._checkpoint_dir(), SCORES_FILENAME)

    def _persist_ckpt_scores(self):
        os.makedirs(self._checkpoint_dir(), exist_ok=True)
        with open(self._scores_path(), "w") as f:
            json.dump(self._ckpt_scores, f)

    def _load_ckpt_scores(self):
        """Rebuild the monitored scores from the sidecar, keeping the
        checkpoints that still exist, and the best checkpoint."""
        path = self._scores_path()
        if not os.path.isfile(path):
            return
        try:
            with open(path) as f:
                scores = json.load(f)
        except (ValueError, OSError):
            return
        ckpt_dir = self._checkpoint_dir()
        self._ckpt_scores.update({
            name: float(score) for name, score in scores.items()
            if os.path.exists(os.path.join(ckpt_dir, name))})
        ckpt_cfg = self.config.get("checkpoint") or {}
        if ckpt_cfg.get("monitor") and self._ckpt_scores:
            sign = -1.0 if str(ckpt_cfg.get("mode") or "min") == "max" \
                else 1.0
            best = min(self._ckpt_scores,
                       key=lambda d: sign * self._ckpt_scores[d])
            self.best_checkpoint = os.path.join(ckpt_dir, best)

    def _prune_checkpoints(self, save_top_k, monitor=None, mode="min"):
        """Keep `save_top_k` epoch checkpoints: the most recent without a
        `monitor`, the best scored under mode min/max with one; the latest
        epoch always stays (for resume), and k <= 0 keeps all
        (Lightning's -1). Updates `best_checkpoint`."""
        ckpt_dir = self._checkpoint_dir()
        if not os.path.isdir(ckpt_dir):
            return
        epochs = sorted(d for d in os.listdir(ckpt_dir)
                        if d.startswith("epoch_") and not d.endswith(".tmp"))
        if not epochs:
            return
        if monitor and self._ckpt_scores:
            sign = -1.0 if str(mode) == "max" else 1.0
            ranked = sorted((d for d in epochs if d in self._ckpt_scores),
                            key=lambda d: sign * self._ckpt_scores[d])
            if ranked:
                self.best_checkpoint = os.path.join(ckpt_dir, ranked[0])
            if save_top_k <= 0:
                return
            keep = set(ranked[:save_top_k]) | {epochs[-1]}
            stale = [d for d in epochs if d not in keep]
        else:
            if save_top_k <= 0:
                return
            stale = epochs[:-save_top_k]
        for name in stale:
            target = os.path.join(ckpt_dir, name)
            if os.path.isdir(target):
                shutil.rmtree(target, ignore_errors=True)
            elif os.path.exists(target):
                os.remove(target)
            self._ckpt_scores.pop(name, None)
        if stale:
            self._persist_ckpt_scores()

    def resume(self, path):
        """Restore a run from a checkpoint of `save_checkpoint`: the
        parameters, the optimizer's moments, counts and running mean, the
        occupancy grid, `global_step`, the EMA (re-seeded from the
        parameters when the checkpoint has none) and the monitored
        scores. Returns the checkpoint's epoch; `train()` continues from
        the next. The generator and the batcher restart from `seed`, as
        the JAX package restarts its PRNG key."""
        self._load_ckpt_scores()
        restored = checkpoint_lib.restore(path, self.device)
        if restored.get("opt_state") is None:
            raise ValueError(
                f"{path} has no optimizer moments (a checkpoint converted "
                "from the JAX package): load it through "
                "model.checkpoint_filepath instead of resuming it")
        for name, child in self.params.named_children():
            child.load_state_dict(restored["params"][name])
        self.optimizer.load_state_dict(restored["opt_state"])
        occ = restored["occ_state"]
        self.occ_state = occupancy.OccupancyGridState(
            occs=occ["occs"].to(torch.float32),
            binary=occ["binary"].to(torch.bool))
        self.global_step = int(restored["global_step"])
        self.prepass_on = False
        self._prepass_fits = 0
        if self.ema_params is not None:
            source = restored.get("ema_params") or restored["params"]
            for name, child in self.ema_params.named_children():
                child.load_state_dict(source[name])
        return int(restored["epoch"])

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
            self.eval_params().nerf, eval_prepass_div=config.model.nerf.get(
                "eval_occlusion_prepass_div"))
        return targets, render_image

    def evaluate(self, stage="val", epoch=0, max_images=None):
        """Evaluate the current parameters (the EMA, when there is one)
        on `stage`'s views; returns {name: value} (with several targets,
        "<target>/<name>")."""
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
        for name, value in merged.items():
            self._last_eval[f"{stage}/{name}"] = float(value)
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
        """Write a list of {name: value} maps as YAML (no PyYAML on the
        card machine); PyYAML loads it back to the same values."""
        with open(os.path.join(self.log_dir, filename), "w") as f:
            f.write(yaml_metrics(metrics_list))


def _metric_value(value):
    if isinstance(value, dict):
        return {name: _metric_value(value[name]) for name in sorted(value)}
    return value if isinstance(value, str) else float(value)


def yaml_metrics(metrics_list):
    """The YAML text of a list of {name: value} maps (a value a number,
    written as a float, a string, or such a map), names sorted as
    PyYAML's safe_dump sorts them."""
    return config_lib.yaml_text([_metric_value(m) for m in metrics_list])
