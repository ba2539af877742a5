"""Deblur e-NeRF in PyTorch for one NVIDIA Hopper GPU (H100).

A port of `deblur_e_nerf_tpu` (JAX/XLA/Pallas on a TPU) that keeps the JAX
package's module names and layout (`ops/`, `models/`, `training/`,
`data/`, `utils/`), so each module here has a counterpart of the same name
there. The port imports torch, numpy, scipy and the standard library only:
never jax, and nothing of `deblur_e_nerf_tpu`.

Slice status: the event-supervised NGP training step of the flagship
config, with the pixel-bandwidth filter on (S lifetime samples per
endpoint) or off. Both TPU kernels on that path have hand-written CUDA
counterparts in `csrc/`, built with nvcc at first use and loaded with
ctypes (`ops/_cuda_build.py`): the row scatter-add of the hash-grid table
backward (`ops/scatter_rows.py`, for the Pallas kernel of
`deblur_e_nerf_tpu/ops/pallas_scatter.py`) and the row gather of every
hash-grid level's forward (`ops/gather_rows.py`, for the Pallas gather
probe of `scripts/perf_microbench.py`). `perf_microbench.py` times both
at the Pallas probes' shapes.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU they raise instead of falling back to the CPU
(`utils/device.py`).
"""

__version__ = "0.1.0"
