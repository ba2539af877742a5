"""The port and chip_smoke.py import nothing that the GPU machine lacks:
no jax, flax, optax, orbax, yaml, cv2, h5py, tensorboard or
deblur_e_nerf_tpu (checked in a fresh interpreter)."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "yaml", "cv2", "h5py",
             "tensorboard", "tensorboardX", "deblur_e_nerf_tpu", "triton",
             "torch.utils.cpp_extension")

SCRIPT = f"""
import importlib, pkgutil, sys
import deblur_e_nerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the filter path, the kernels' and the evaluation stack's modules, the
# quality harness, the command line and data parallelism are among them
for name in ("ops.linalg", "ops.control", "ops.gather_rows",
             "ops.hash_encode", "ops.pb_weight", "ops.compact",
             "ops.composite", "models.pixel_bandwidth",
             "perf_microbench",
             "data.image_io", "data.posed_images", "models.offset_gamma",
             "training.metrics", "training.evaluation",
             "training.checkpoint", "quality_run", "cli", "parallel",
             "parallel.mesh", "parallel.data_parallel", "data.eds_to_esim",
             "data.hdf5", "data.undistort"):
    assert pkg.__name__ + "." + name in names, name
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r}
                or m in {FORBIDDEN!r})
print(len(names), loaded)
"""


def test_port_and_chip_smoke_import_no_forbidden_module():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, loaded = proc.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 30  # every module of the package was imported
    assert loaded == "[]", loaded


def test_sources_use_neither_torch_builders_nor_top_level_imports():
    """No PyTorch extension builder or torch.compile anywhere, and yaml /
    cv2 / jax never imported at module top (only inside functions)."""
    pkg = os.path.join(REPO, "deblur_e_nerf_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    top_level_import = re.compile(
        r"^(import|from)\s+(jax|yaml|cv2|h5py|tensorboard\w*)\b", re.M)
    for path in paths:
        with open(path) as f:
            text = f.read()
        for banned in ("torch/extension.h", "cpp_extension",
                       "torch.compile"):
            assert banned not in text, f"{banned!r} in {path}"
        assert not top_level_import.search(text), path


CONVERTER = f"""
import sys
from deblur_e_nerf_tpu_torch.data import eds_to_esim, hdf5, undistort
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""


def test_eds_converter_imports_no_forbidden_module():
    """The EDS converter and its HDF5 reader and undistortion, alone in a
    fresh interpreter, import none of jax, deblur_e_nerf_tpu, h5py, cv2
    and yaml (the GPU machine has none of them)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", CONVERTER], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
