"""Deblur e-NeRF in PyTorch for one NVIDIA Hopper GPU (H100).

A port of `deblur_e_nerf_tpu` (JAX/XLA/Pallas on a TPU) that keeps the JAX
package's module names and layout (`ops/`, `models/`, `training/`,
`data/`, `utils/`), so each module here has a counterpart of the same name
there. The port imports torch, numpy, scipy and the standard library only:
never jax, and nothing of `deblur_e_nerf_tpu`.

Slice status: every module of the JAX package has a counterpart here. The
hand-written CUDA kernels live in `csrc/`, built with nvcc at first use
and loaded with ctypes (`ops/_cuda_build.py`): the hash-grid encode, one
fused kernel a direction over all levels (`ops/hash_encode.py`, for the
JAX package's custom-VJP `_encode_frozen_pos`), on every training and
eval path; and the counterparts of the Pallas kernels, the row
scatter-add (`ops/scatter_rows.py`, for
`deblur_e_nerf_tpu/ops/pallas_scatter.py`) and the row gather
(`ops/gather_rows.py`, for the Pallas gather probe of
`scripts/perf_microbench.py`), which `perf_microbench.py` times at the
Pallas probes' shapes.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU they raise instead of falling back to the CPU
(`utils/device.py`).
"""

__version__ = "0.1.0"
