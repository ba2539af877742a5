"""Deblur e-NeRF in PyTorch for one NVIDIA Hopper GPU (H100).

A port of `deblur_e_nerf_tpu` (JAX/XLA/Pallas on a TPU) that keeps the JAX
package's module names and layout (`ops/`, `models/`, `training/`,
`data/`, `utils/`), so each module here has a counterpart of the same name
there. The port imports torch, numpy, scipy and the standard library only:
never jax, and nothing of `deblur_e_nerf_tpu`.

Slice status: the event-supervised NGP training step with the
pixel-bandwidth filter off. The one TPU kernel on that path, the Pallas
row scatter-add (`deblur_e_nerf_tpu/ops/pallas_scatter.py`), is the CUDA
kernel in `csrc/scatter_rows.cu`, built with nvcc at first use and loaded
with ctypes (`ops/_cuda_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU they raise instead of falling back to the CPU
(`utils/device.py`).
"""

__version__ = "0.1.0"
