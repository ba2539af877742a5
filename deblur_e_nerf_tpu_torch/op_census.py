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
The occupancy update's count includes its density field calls, except
the hash encode's own (counted under "B1/B2 encode"). The port's own
CUDA kernels are not operators: their wrappers count their launches.
"""

import contextlib
import functools
import importlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# layer: (module of the port, function), ROADMAP Queue B's names
LAYERS = {
    "B1/B2 encode": ("ops.hash_encode", "encode_forward"),
    "B1/B2 encode ": ("ops.hash_encode", "encode_backward"),
    "B4 march": ("models.renderer", "march_rays"),
    "B5 composite": ("models.renderer", "composite"),
    "B7 occupancy update": ("models.occupancy", "update"),
    "B8 weight chain": ("ops.pb_weight", "weight"),
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


@contextlib.contextmanager
def _wrapped(census):
    from . import __name__ as package

    saved = []
    for layer, (module_name, name) in LAYERS.items():
        module = importlib.import_module(f"{package}.{module_name}")
        real = getattr(module, name)

        def wrapper(*args, _real=real, _layer=layer, **kwargs):
            census.stack.append(_layer)
            try:
                out = _real(*args, **kwargs)
                census.mark(out)
            finally:
                census.stack.pop()
            return out

        functools.update_wrapper(wrapper, real)
        setattr(module, name, wrapper)
        saved.append((module, name, real))
    try:
        yield
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def count_ops(fn):
    """({layer: {"forward": n, "backward": n}}, fn's result) of one call
    of fn (its backward runs inside it: a training step). Operators that
    run in no layer count under "other"."""
    census = _Census()
    with _wrapped(census), _Function(census), _Dispatch(census):
        out = fn()
    return census.counts, out
