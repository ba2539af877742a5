"""Operator calls by layer: how many PyTorch operators (ATen calls that
are not views) each layer of the training step runs, forward and
backward, so that the next kernel to write is chosen from counts. Each
such call is at least one launch on the card. `count_ops(fn)` counts one
call of fn (a training step, an occupancy update); chip_smoke.py phase 4
prints a steady flagship step's and its occupancy updates' on the card.

The layers (LAYERS) are counted by wrapping their entry functions: an
operator runs in the innermost layer whose call is in progress; in the
backward, in the layer whose forward made the autograd node being run
(the nodes a layer's operators and its own result carry are recorded).
The occupancy update's density field calls count under "B7 occupancy
update: field" (the field's operators within the update, but the hash
encode's own, counted under "B1/B2 encode"); "B7 occupancy update" counts
its operators outside the field and, under "launches", the launches of
its kernels' wrapper calls (ops/occupancy.py) made within it. The port's
own CUDA kernels are not operators: their wrappers count their calls.
Another checkout of the port imported under another name (a parent
commit's) is counted by the same layers with `count_ops(fn, packages)`.
"""

import contextlib
import functools
import importlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# layer: (module of the port, function[, the layer it counts within]),
# ROADMAP Queue B's names; a layer with an outer layer is a layer only
# while that one runs
LAYERS = {
    "B1/B2 encode": ("ops.hash_encode", "encode_forward"),
    "B1/B2 encode ": ("ops.hash_encode", "encode_backward"),
    "B4 march": ("models.renderer", "march_rays"),
    "B5 composite": ("models.renderer", "composite"),
    "B7 occupancy update": ("models.occupancy", "update"),
    "B7 occupancy update: field": ("models.nerf_model", "density_fn",
                                   "B7 occupancy update"),
    "B8 weight chain": ("ops.pb_weight", "weight"),
}
# layer: (module of the port, its kernels' call counts)
LAUNCHES = {
    "B7 occupancy update": ("ops.occupancy", (
        "POINTS_LAUNCHES", "EMA_LAUNCHES", "THRESHOLD_LAUNCHES",
        "SAMPLE_LAUNCHES")),
}


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


class _Census:
    def __init__(self):
        self.stack = []
        self.nodes = {}  # autograd node -> the layer that made it
        self.counts = {}

    def count(self):
        node = torch._C._current_autograd_node()
        layer = self.stack[-1] if self.stack else self.nodes.get(node)
        key = (layer or "other").strip()
        by_phase = self.counts.setdefault(key, {"forward": 0, "backward": 0})
        by_phase["forward" if node is None else "backward"] += 1

    def mark(self, value):
        if self.stack:
            for t in _tensors(value):
                if t.grad_fn is not None:
                    self.nodes.setdefault(t.grad_fn, self.stack[-1])


class _Dispatch(TorchDispatchMode):
    def __init__(self, census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.census.count()
        return func(*args, **(kwargs or {}))


class _Function(TorchFunctionMode):
    def __init__(self, census):
        super().__init__()
        self.census = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.census.mark(out)
        return out


def _module(package, name):
    """package.name, or None where another checkout has no such module."""
    try:
        return importlib.import_module(f"{package}.{name}")
    except ModuleNotFoundError:
        if package == __package__:
            raise
        return None


def _entries(packages):
    """(layer, module, function name, outer layers, (counters' module,
    their names) or None) of each layer in each package."""
    for package in (__package__, *packages):
        for layer, (module_name, name, *outer) in LAYERS.items():
            module = _module(package, module_name)
            if module is None or (package != __package__
                                  and not hasattr(module, name)):
                continue
            counted = None
            if layer in LAUNCHES:
                counters = _module(package, LAUNCHES[layer][0])
                if counters is not None:
                    counted = (counters, LAUNCHES[layer][1])
            yield layer, module, name, outer, counted


@contextlib.contextmanager
def _wrapped(census, packages):
    saved = []
    for layer, module, name, outer, counted in _entries(packages):
        real = getattr(module, name)

        def wrapper(*args, _real=real, _layer=layer, _outer=outer,
                    _counted=counted, **kwargs):
            if _outer and _outer[0] not in census.stack:
                return _real(*args, **kwargs)
            census.stack.append(_layer)
            if _counted:
                before = [getattr(_counted[0], n) for n in _counted[1]]
            try:
                out = _real(*args, **kwargs)
                census.mark(out)
            finally:
                census.stack.pop()
                if _counted:
                    launches = census.counts.setdefault(
                        _layer, {"forward": 0, "backward": 0}).setdefault(
                            "launches", dict.fromkeys(_counted[1], 0))
                    for n, b in zip(_counted[1], before):
                        launches[n] += getattr(_counted[0], n) - b
            return out

        functools.update_wrapper(wrapper, real)
        setattr(module, name, wrapper)
        saved.append((module, name, real))
    try:
        yield
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def count_ops(fn, packages=()):
    """({layer: {"forward": n, "backward": n}}, fn's result) of one call
    of fn (its backward runs inside it: a training step). Operators that
    run in no layer count under "other"; a layer of LAUNCHES has its
    kernels' wrapper calls under "launches". `packages`: the names of
    other imported checkouts of the port whose layers count too (those of
    their modules and functions that exist)."""
    census = _Census()
    with _wrapped(census, packages), _Function(census), _Dispatch(census):
        out = fn()
    return census.counts, out
