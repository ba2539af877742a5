"""Checkpoints with per-component selective restore (counterpart of
deblur_e_nerf_tpu/training/checkpoint.py).

A checkpoint is one file written by `torch.save`: a dict of tensors,
numbers, strings, None and nested dicts of them, so `torch.load` reads it
with `weights_only=True`. The trainer's payload is
  {"params": {component: state dict}, "opt_state": Optimizer.state_dict()
   or None, "occ_state": {"occs", "binary"}, "step", "epoch",
   "global_step"[, "ema_params": {component: state dict}]},
with the components `nerf`, `contrast_threshold`, `refractory_period` and,
with the filter on, `pixel_bandwidth`. Selective restore swaps whole
components of a freshly built model, so an evaluation config can take the
trained NeRF (or the physics parameters) out of a training checkpoint.
"""

import os

import torch


def save(path, payload):
    """Write `payload` to `path` (creates parent directories), through a
    temporary file so that a crash never leaves a partial checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore(path, device):
    """Read a checkpoint with its tensors on `device`."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def component_state(module):
    """{component: state dict} of a TrainParams-like module."""
    return {name: child.state_dict()
            for name, child in module.named_children()}


def selective_restore_params(module, checkpoint_params, component_flags):
    """Load the components of `module` whose flag
    (model.<component>.load_state_dict) is set from `checkpoint_params`
    ({component: state dict}), in place. A flagged component that the
    checkpoint lacks raises KeyError. Returns `module`."""
    for component, load in component_flags.items():
        if not load:
            continue
        if component not in checkpoint_params:
            raise KeyError(f"component {component!r} not in checkpoint")
        getattr(module, component).load_state_dict(
            checkpoint_params[component])
        print(f"Loaded the state of {component!r} from checkpoint",
              flush=True)
    return module
