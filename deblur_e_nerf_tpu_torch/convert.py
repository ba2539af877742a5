"""Parameter exchange with the JAX package.

`params_from_jax` turns the JAX package's parameter tree, given as nested
dicts of numpy arrays, into a state dict of the port's `TrainParams`
(training/step.py). Paths keep their names, joined with '.':
  - a flax `Dense` kernel (in, out) becomes a torch weight (out, in);
  - a weight-normalized `Dense` (a `scale` beside its kernel) becomes a
    `WeightNormDense`: the kernel its `v` (out, in), the scale its `g`;
  - the hash table is copied row for row (both packages share the
    `grid_layout` table layout);
  - the contrast-threshold and refractory raw parameters and the raw
    background carry over unchanged.

`checkpoint_from_jax` turns a JAX checkpoint's payload (the restored orbax
tree of the JAX `Trainer.save_checkpoint`, as nested dicts of numpy
arrays) into the port's checkpoint (training/checkpoint.py): the
parameters, the EMA parameters, the occupancy grid and the counters. The
optax optimizer state is left out (`opt_state` None), so a converted
checkpoint serves `model.checkpoint_filepath` (evaluation, fine-tuning)
and `Trainer.resume` refuses it.
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def params_from_jax(numpy_tree):
    """Nested dict of numpy arrays (JAX param tree) -> torch state dict."""
    flat = dict(_flatten(numpy_tree))
    state = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        layer, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            normed = f"{layer}.scale" in flat
            path = f"{layer}.{'v' if normed else 'weight'}"
            arr = arr.T
        elif leaf == "scale" and f"{layer}.kernel" in flat:
            path = f"{layer}.g"
        state[path] = torch.from_numpy(np.array(arr, copy=True))
    return state


def _components(numpy_tree):
    """JAX param tree -> {component: state dict} of the port."""
    out = {}
    for path, value in params_from_jax(numpy_tree).items():
        component, _, name = path.partition(".")
        out.setdefault(component, {})[name] = value
    return out


def checkpoint_from_jax(payload):
    """JAX checkpoint payload (nested dicts of numpy arrays) -> the port's
    checkpoint payload."""
    occ = payload["occ_state"]
    out = {
        "params": _components(payload["params"]),
        "opt_state": None,
        "occ_state": {
            "occs": torch.from_numpy(np.array(occ["occs"], np.float32)),
            "binary": torch.from_numpy(np.array(occ["binary"], bool)),
        },
        "step": int(np.asarray(payload["step"])),
        "epoch": int(np.asarray(payload["epoch"])),
        "global_step": int(np.asarray(payload["global_step"])),
    }
    if payload.get("ema_params") is not None:
        out["ema_params"] = _components(payload["ema_params"])
    return out
