"""Parameter exchange with the JAX package.

`params_from_jax` turns the JAX package's parameter tree, given as nested
dicts of numpy arrays, into a state dict of the port's `TrainParams`
(training/step.py). Paths keep their names, joined with '.':
  - a flax `Dense` kernel (in, out) becomes a torch weight (out, in);
  - the hash table is copied row for row (both packages share the
    `grid_layout` table layout);
  - the contrast-threshold and refractory raw parameters and the raw
    background carry over unchanged.
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
    state = {}
    for path, value in _flatten(numpy_tree):
        arr = np.asarray(value)
        if path.endswith(".kernel"):
            path = path[: -len(".kernel")] + ".weight"
            arr = arr.T
        state[path] = torch.from_numpy(np.array(arr, copy=True))
    return state

