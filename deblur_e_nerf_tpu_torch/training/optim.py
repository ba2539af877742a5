"""Optimizer (counterpart of deblur_e_nerf_tpu/training/optim.py): Adam
with per-group learning rates, coupled weight decay on the NeRF MLPs, the
refractory period's relative lr, a MultiStepLR schedule, freeze masks and
the optional decoupled fine-table row decay.

The update equals the JAX package's optax chain per parameter:
  g' = g + wd * p                       (nerf_mlp group only)
  m, v = Adam moments of g' (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
  p <- p - lr * sched(t) * m_hat / (sqrt(v_hat) + eps)
       [- default_lr * sched(t) * table_wd * p on table rows >= start_row]
where sched(t) = gamma ** (number of milestones <= t), t counting applied
updates from 0. Frozen parameters are left out of the optimizer and get
no gradient. With `skip_nonfinite` (the default, the JAX package's
`trainer.skip_nonfinite_updates`), an update whose loss or gradients are
not finite is skipped whole: parameters, moments and the step count stay
as they were. The skip is decided on the device (`torch.where` on a
device bool), so a step reads nothing back to the host; the count and the
schedule scale are device tensors.

Gradient accumulation (`accumulate` k > 1, the JAX package's
`optax.MultiSteps` inside `optax.apply_if_finite`): `step` folds each
micro-step's gradients into a running mean, acc + (g - acc) / (n + 1), and
runs the Adam chain on that mean at the k-th micro-step and zeroes it. A
skipped micro-step moves neither the mean nor its count n, so the boundary
is decided on the device too: the update is computed at every micro-step
and committed only there. The schedule counts optimizer steps.
"""

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
_PB_NAMES = ("tau_mil_it_eff_prod", "A_amp_inv", "A_loop_inv", "tau_out",
             "tau_sf", "tau_diff")


def _jax_path(name):
    """'nerf.field.mlp_base.hidden_0.weight' -> the JAX package's path
    'nerf/field/mlp_base/hidden_0/kernel'."""
    return name.replace(".", "/").replace("/weight", "/kernel")


def _is_nerf_mlp(path):
    return (("mlp_base" in path or "mlp_head" in path
             or "sigma_layer" in path or "bottleneck_layer" in path
             or "rgb_layer" in path or "/base/" in path)
            and "table" not in path)


def _label_for_path(path):
    if path.startswith("refractory_period/"):
        return "refractory_period"
    if path.startswith("contrast_threshold/"):
        if "p2n_contrast_threshold_ratio" in path:
            return "ct_p2n"
        if "mean_contrast_threshold" in path:
            return "ct_mean"
        return "default"
    if path.startswith("pixel_bandwidth/"):
        for name in _PB_NAMES:
            if name in path:
                return f"pb_{name}"
        return "default"
    return "default"


def param_label(name, table_decay=None):
    path = _jax_path(name)
    if (table_decay is not None and path.startswith("nerf/")
            and path.endswith("/table")):
        return "hash_table"
    return "nerf_mlp" if _is_nerf_mlp(path) else _label_for_path(path)


def trainable(name, model_configs):
    """False where the component's `freeze` config (bool or
    {param_name: bool, default: bool}) freezes the parameter."""
    path = _jax_path(name)
    cfg = model_configs.get(path.split("/")[0])
    if cfg is None:
        return True
    freeze = cfg.get("freeze", False)
    if isinstance(freeze, bool):
        return not freeze
    for param_name, freeze_param in freeze.items():
        if param_name != "default" and param_name in path:
            return not freeze_param
    return not freeze.get("default", False)


class Optimizer:
    """Per-group Adam over the trainable parameters of a module."""

    def __init__(self, groups, milestones, gamma, table_decay=None,
                 default_lr=None, skip_nonfinite=True, accumulate=1):
        """groups: [(label, lr, weight_decay, [(name, param), ...])];
        table_decay: (start_row, wd) for the 'hash_table' group;
        accumulate: micro-steps per update."""
        self.groups = groups
        self.gamma = gamma
        self.table_decay = table_decay
        self.default_lr = default_lr
        self.skip_nonfinite = skip_nonfinite
        self.accumulate = int(accumulate)
        self.state = {}
        self.acc = {}
        for _, _, _, named in groups:
            for _, p in named:
                self.state[p] = (torch.zeros_like(p), torch.zeros_like(p))
                if self.accumulate > 1:
                    self.acc[p] = torch.zeros_like(p)
        params = self.params()
        device = params[0].device if params else torch.device("cpu")
        self.milestones = torch.tensor(list(milestones), dtype=torch.int64,
                                       device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        # micro-steps folded into the running mean since the last update
        self.mini_step = torch.zeros((), dtype=torch.int64, device=device)

    def params(self):
        return [p for _, _, _, named in self.groups for _, p in named]

    def named_params(self):
        return [(n, p) for _, _, _, named in self.groups for n, p in named]

    def zero_grad(self):
        for p in self.params():
            p.grad = None

    @staticmethod
    def _commit(where, dst, new):
        dst.copy_(new if where is None else torch.where(where, new, dst))

    @torch.no_grad()
    def step(self, loss=None):
        """One micro-step: check its gradients (and `loss`) with
        `skip_nonfinite`, fold them into the running mean with
        accumulation, and commit the Adam update on the device where it is
        due. Returns a device bool: True where the micro-step was taken,
        False where it was skipped (a non-finite loss or gradient)."""
        ok = torch.ones((), dtype=torch.bool, device=self.count.device)
        if self.skip_nonfinite:
            checks = [torch.isfinite(p.grad).all() for p in self.params()
                      if p.grad is not None]
            if loss is not None:
                checks.append(torch.isfinite(loss).all())
            if checks:
                ok = torch.stack(checks).all()
        emit = ok
        if self.accumulate > 1:
            n1 = self.mini_step + 1
            taken = ok if self.skip_nonfinite else None
            for p in self.params():
                acc = self.acc[p]
                # a parameter the loss did not reach folds in a zero
                # gradient
                g = -acc if p.grad is None else p.grad - acc
                self._commit(taken, acc, acc + g / n1)
            emit = ok & (self.mini_step == self.accumulate - 1)
            self._commit(taken, self.mini_step, n1 % self.accumulate)
        # without the skip and without accumulation every update lands
        where = emit if self.skip_nonfinite or self.accumulate > 1 else None
        # sched(t) and the bias corrections in float64 on the device,
        # rounded to float32 once
        n_passed = (self.count >= self.milestones).sum()
        sched = (self.gamma ** n_passed.to(torch.float64)).float()
        t = (self.count + 1).to(torch.float64)
        bc1 = (1.0 - B1 ** t).float()
        bc2 = (1.0 - B2 ** t).float()
        for label, lr, wd, named in self.groups:
            for _, p in named:
                if self.accumulate > 1:
                    g = self.acc[p]
                elif p.grad is None:
                    continue
                else:
                    g = p.grad
                if wd:
                    g = g + wd * p
                m, v = self.state[p]
                m_new = m.mul(B1).add_(g, alpha=1.0 - B1)
                v_new = v.mul(B2).addcmul_(g, g, value=1.0 - B2)
                upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
                p_new = p.clone()
                if label == "hash_table" and self.table_decay is not None:
                    start_row, table_wd = self.table_decay
                    p_new[start_row:].sub_(
                        (self.default_lr * table_wd) * sched
                        * p_new[start_row:])
                p_new.sub_((lr * sched) * upd)
                self._commit(where, m, m_new)
                self._commit(where, v, v_new)
                self._commit(where, p, p_new)
        if self.accumulate > 1:
            # optax.MultiSteps: acc * (1 - emit)
            for acc in self.acc.values():
                acc.mul_((~emit).to(acc.dtype))
        self.count.add_(emit.to(torch.int64))
        return ok

    def state_dict(self):
        """Moments, running mean and counts, keyed by parameter name."""
        named = self.named_params()
        return {
            "count": self.count, "mini_step": self.mini_step,
            "m": {n: self.state[p][0] for n, p in named},
            "v": {n: self.state[p][1] for n, p in named},
            "acc": {n: self.acc[p] for n, p in named if p in self.acc},
        }

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy a `state_dict` in place (same names and shapes)."""
        self.count.copy_(state["count"])
        self.mini_step.copy_(state["mini_step"])
        for n, p in self.named_params():
            self.state[p][0].copy_(state["m"][n])
            self.state[p][1].copy_(state["v"][n])
            if p in self.acc:
                self.acc[p].copy_(state["acc"][n])


def build(params, optimizer_config, lr_scheduler_config,
          nerf_mlp_weight_decay, max_refractory_period, steps_per_epoch,
          model_configs, table_decay=None, skip_nonfinite=True,
          accumulate=1):
    """Build the Optimizer over `params` (an nn.Module) and freeze the
    parameters the config freezes (requires_grad False).
    `steps_per_epoch` counts optimizer steps (for epoch milestones).

    Returns (optimizer, {name: trainable})."""
    if optimizer_config.algo != "adam":
        raise NotImplementedError(f"optimizer {optimizer_config.algo!r}")
    if lr_scheduler_config.algo != "multi_step_lr":
        raise NotImplementedError(f"lr scheduler {lr_scheduler_config.algo!r}")
    scale = steps_per_epoch if lr_scheduler_config.interval == "epoch" else 1
    milestones = [int(m) * scale
                  for m in lr_scheduler_config.multi_step_lr.milestones]
    gamma = float(lr_scheduler_config.multi_step_lr.gamma)

    lr_cfg = optimizer_config.lr
    default_lr = float(lr_cfg.default)
    ct_lr = lr_cfg.get("contrast_threshold", {})
    group_lrs = {
        "default": default_lr,
        "nerf_mlp": default_lr,
        "hash_table": default_lr,
        "refractory_period": float(max_refractory_period)
        * float(optimizer_config.relative_lr.refractory_period),
        "ct_p2n": float(ct_lr.get("p2n_contrast_threshold_ratio",
                                  default_lr)),
        "ct_mean": float(ct_lr.get("mean_contrast_threshold", default_lr)),
    }
    pb_lrs = lr_cfg.get("pixel_bandwidth", {})
    for name in _PB_NAMES:
        group_lrs[f"pb_{name}"] = float(pb_lrs.get(name, default_lr))

    mask = {}
    grouped = {}
    for name, p in params.named_parameters():
        mask[name] = trainable(name, model_configs)
        p.requires_grad_(mask[name])
        if mask[name]:
            grouped.setdefault(param_label(name, table_decay), []).append(
                (name, p))
    groups = [
        (label, group_lrs[label],
         nerf_mlp_weight_decay if label == "nerf_mlp" else 0.0, named)
        for label, named in grouped.items()
    ]
    return Optimizer(groups, milestones, gamma, table_decay=table_decay,
                     default_lr=default_lr, skip_nonfinite=skip_nonfinite,
                     accumulate=accumulate), mask
