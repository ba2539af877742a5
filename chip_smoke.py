#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deblur_e_nerf_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing a start and an end line with elapsed seconds:
  1. environment: torch/CUDA versions, device, nvidia-smi name and power
     limit, nvcc, triton;
  2. build: the CUDA kernels, with nvcc from the sources in this checkout,
     and the atomics the compiler emitted for each scatter-add instance
     (cuobjdump -sass): the main path's widths must use vector reductions;
     for each gather instance of the main path, its registers and spills
     (-Xptxas -v) and its SASS load and store forms: its stores must be
     16-byte vectors; the corner sum's main instances' registers and
     spills;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes (and the Pallas probes K2/K3's), with times of
     the kernel, the plain version and the PyTorch library calls computing
     the same function; the scatter-add also against the plain model of
     its summation order, on uniform indices and on the training step's
     index structures (the empty-slot tail, ray-ordered runs), and its
     wrapper's host time per call beside its profiled kernel time; the
     gather bit for bit in both output types (float32 rows, bf16 rows),
     on uniform indices and ray-ordered runs, the vertex-hash level's in
     sample-major and corner-major order, beside index_select and
     advanced indexing (tbl[idx64]), each with its bound by output type;
     the corner sum bit for bit against the plain model of its order and
     within the summation-order bound of the plain version, in both row
     types, beside torch.bmm for float32 rows; the gather and the corner
     sum also at an eval field call's N = 2^20 samples, under no_grad;
  4. training, two paths of configs/train/synthetic.yaml at full width on
     a synthetic dataset, each with the kernels' launch counts set to 0
     just before it and read just after:
       a. filter off: the port's Trainer takes 2 steps, then one forced
          occupancy update;
       b. the flagship as written (pixel-bandwidth filter on, S = 30, the
          default sample budget K = 15,728,640): 3 steps (with --profile,
          each profiled, then 3 more past the occupancy warmup, with the
          per-call device times of each kernel), then one steady step
          (past the warmup) under torch.cuda.set_sync_debug_mode("warn"),
          whose host syncs are counted by source line (none may come from
          the optimizer) and whose kernel launches must be 16 of each
          (one per hash level);
  5. reference: on small inputs, the card (through the kernels) against
     the plain version on the CPU: the NGP field's outputs and table
     gradient, and one filter-on step's loss and gradients;
  6. eval, on phase 4's flagship trainer: Trainer.evaluate("val") on the
     synthetic dataset's views (written by the port's image writer) with
     seeded stub LPIPS weights (every metric finite), its kernel launches
     counted; one 346x260 frame (6 chunks of 16,384 rays) through
     make_render_image_fn, timed (ms per image, rays/s, live marched
     samples, field calls per ray chunk, peak device memory) and
     profiled, whose gathers and corner sums must be 16 per field call
     (one per hash level); and the eval render of a small model on the
     card against the CPU (equal marched samples per pixel, the image
     within 1e-5);
  7. the real-data (EDS) path: configs/train/07_ziggy_and_fuzz_hdr.yaml
     at full width (HashGrid 16 levels, float32 gathers, 256^3 grid,
     sphere contraction, cone angle 0.004, the trainable filter at S = 30,
     accumulation 8), cut only as EDS_REDUCED says, on a 64x64 synthetic
     dataset with a distorted calibration: one epoch of 16 micro-steps
     through Trainer.train (each micro-step's launches, occupancy update
     and parameter change checked; a checkpoint at its end), the host
     syncs of one steady micro-step (none from the optimizer, the EMA or
     the accumulation), a fresh trainer resuming the checkpoint bit for
     bit and training epoch 1 (pruning keeps one checkpoint), a third
     built from configs/test/07_ziggy_and_fuzz_hdr.yaml's values that
     evaluates the kept checkpoint, one 640x480 frame timed (16 launches
     of the gather and the corner sum per field call), and a small EDS
     step on the card against the CPU;
  8. the repaired round-5 (r5fix) path:
     configs/train/quality_sphere_blur32_dense_r5fix.yaml at full width
     (HashGrid 16 levels, float32 gathers, 64^3 grid, S = 30, K =
     1,228,800, the occlusion prepass at div 2 for training and eval, the
     sparsity prior, the EMA), cut only as R5FIX_REDUCED says, with batch
     capacity 1024, on a dataset the port generates with the config's
     recipe (the full pixel filter, on the card; fewer poses,
     R5FIX_DATASET) and packs with its native packer (the numpy packer
     may not run): one epoch of steps through Trainer.train, each with its
     launches checked against `r5fix_step_launches` for the path it took
     (the trainer runs the occlusion prepass only once the live demand
     fits its buffer: a step that ran it may not overflow it); the host
     syncs of one steady step (none from training/ or the renderer); the
     prepass against the full render on one marched sample set with the
     density raised (outputs on the training path; field gradients of
     both, each within 1e-3 of its largest entry of the float64 render's
     and of each other); one step with field_chunk 2^18 against one
     without (loss, gradients; no gather in the backward);
     evaluate("val") with the eval prepass, one frame at the dataset's
     size timed and profiled, and a small eval render with the prepass on
     the card against the CPU; the density raised until the trainer turns
     the prepass on; two steps of the vanilla NeRF field
     (model.nerf.arch mlp) at the config's widths;
  9. the quality harness (python -m deblur_e_nerf_tpu_torch.quality_run)
     on the r5fix config at full width, on phase 8's dataset, cut as
     QUALITY_REDUCED says: epoch 0, then a fresh invocation resuming its
     checkpoint for epoch 1 and the final rows; each step's launches
     checked for its path and its prepass overflow, the CSV's two rows,
     the flat-field PSNR and every row of metrics.yaml.

Any failed check raises and the script exits non-zero. The line before
the last is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result. It writes nothing into the checkout except
the kernels' build directory (deblur_e_nerf_tpu_torch/_build).
"""

import argparse
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

BUDGET_S = 15 * 60
SCATTER_SOURCE = "deblur_e_nerf_tpu_torch/csrc/scatter_rows.cu"
SCATTER_REPLACES = "deblur_e_nerf_tpu/ops/pallas_scatter.py:46"
GATHER_SOURCE = "deblur_e_nerf_tpu_torch/csrc/gather_rows.cu"
GATHER_REPLACES = "scripts/perf_microbench.py:190"
# no Pallas kernel: the weighted corner sum XLA fuses into the JAX encode
CORNER_SUM_SOURCE = "deblur_e_nerf_tpu_torch/csrc/corner_sum.cu"
CORNER_SUM_REPLACES = "deblur_e_nerf_tpu/models/hash_encoding.py:290"
# the flagship's default sample budget K: train_eff_ray_sample_batch_size
# (131072) x S (30 with the filter on) x 4 render slices (diff and subdiff
# start/end)
MAIN_PATH_SAMPLE_BUDGET = 131072 * 30 * 4
FILTER_OFF_SAMPLE_BUDGET = 131072 * 4
# one DAVIS346 frame, the size of the reference's real data
EVAL_FRAME_HEIGHT, EVAL_FRAME_WIDTH = 260, 346


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S} s budget")


@contextmanager
def phase(name):
    print(f"[phase] {name}: start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: done in {time.perf_counter() - t0:.2f} s",
          flush=True)


def flagship_config(dataset_directory, filter_on=True):
    """configs/train/synthetic.yaml's values (with `filter_on` False, the
    pixel-bandwidth filter off)."""
    from deblur_e_nerf_tpu_torch.utils.config import ConfigDict

    return ConfigDict.from_dict({
        "seed": 0,
        "float32_matmul_precision": "highest",
        "eval_target": ["novel_view"],
        "data": {
            "dataset_directory": dataset_directory,
            "train_dataset_ratio": 1.0, "val_dataset_ratio": 1.0,
            "test_dataset_ratio": 1.0, "train_dataset_perm_seed": None,
            "eval_dataset_perm_seed": 9, "alpha_over_white_bg": True,
            "train_init_eff_batch_size": 256,
            "train_eff_ray_sample_batch_size": 131072,
            "val_eff_batch_size": 1, "test_eff_batch_size": 1,
            "num_workers_per_node": 0,
        },
        "model": {
            "min_modeled_intensity": 0.001,
            "eval_save_pred_intensity_img": False,
            "checkpoint_filepath": None,
            "contrast_threshold": {
                "parameterize_mean_ct": True, "load_state_dict": False,
                "freeze": {"p2n_contrast_threshold_ratio": True,
                           "mean_contrast_threshold": True,
                           "default": True},
            },
            "refractory_period": {"load_state_dict": False, "freeze": True},
            "correction": {
                "per_channel_log_it_scale": False,
                "black_level_offset": True,
                "optimizer": {"algo": "lm", "max_steps": 10,
                              "lm": {"radius": 1000000.0}},
            },
            "pixel_bandwidth": {
                "enable": filter_on, "it_sample_size": 30,
                "f_c_dominant_min": 21,
                "target_cumprob": {"max_sample_lifetime": 0.95},
                "load_state_dict": False,
                "freeze": {"tau_mil_it_eff_prod": True, "A_amp_inv": True,
                           "A_loop_inv": True, "tau_out": True,
                           "tau_sf": True, "tau_diff": True,
                           "default": True},
            },
            "nerf": {
                "aabb": [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                "contraction_type": "aabb",
                "occ_grid": {"resolution": 128, "occ_thre": 0.01,
                             "ema_decay": 0.95, "warmup_steps": 256,
                             "n": 16},
                "near_plane": 1.43, "far_plane": 6.63,
                "render_step_size": "auto", "cone_angle": 0,
                "early_stop_eps": 0.0001, "alpha_thre": 0,
                "test_chunk_size": 16384, "arch": "ngp",
                "load_state_dict": False, "freeze": False,
                "ngp": {
                    "pos_encoding": {
                        "otype": "HybridHashGrid", "n_levels": 16,
                        "n_features_per_level": 2, "log2_hashmap_size": 19,
                        "base_resolution": 16,
                        "per_level_scale": 1.4472692012786865,
                        "interpolation": "Linear",
                        "compute_dtype": "bfloat16",
                    },
                    "dir_encoding": {"degree": 4},
                    "mlp_base": {
                        "hidden_activation": "softplus",
                        "density_activation": "shifted_trunc_exp",
                        "n_neurons": 64, "n_hidden_layers": 1,
                        "geo_feat_dim": 15, "weight_norm": False,
                    },
                    "mlp_head": {
                        "hidden_activation": "softplus",
                        "radiance_activation": "softplus",
                        "n_neurons": 64, "n_hidden_layers": 2,
                        "weight_norm": False,
                    },
                },
            },
        },
        "loss": {
            "error_fn": {"log_intensity_diff": "huber",
                         "log_intensity_tv": "l1"},
            "weight": {"log_intensity_diff": 1.0,
                       "log_intensity_tv": 0.001,
                       "nerf_mlp_weight_decay": 1.0e-06},
            "normalize": {"log_intensity_diff": True,
                          "log_intensity_tv": True},
        },
        "metric": {"lpips_net": "alex"},
        "optimizer": {
            "algo": "adam",
            "lr": {"contrast_threshold": {
                       "p2n_contrast_threshold_ratio": 0.1,
                       "mean_contrast_threshold": 0.1},
                   "default": 0.01},
            "relative_lr": {"refractory_period": 50},
        },
        "lr_scheduler": {"algo": "multi_step_lr", "interval": "epoch",
                         "multi_step_lr": {"milestones": [20, 30, 36],
                                           "gamma": 0.33}},
        "logger": {"save_dir": "logs", "name": "chip_smoke"},
        "trainer": {"max_epochs": 40, "log_every_n_steps": 1,
                    "limit_train_batches": 1000,
                    "check_val_every_n_epoch": 1},
    })


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    from deblur_e_nerf_tpu_torch import perf_microbench

    return perf_microbench.time_ms(fn, iters, warmup)


def bound(nbytes, nops=0):
    from deblur_e_nerf_tpu_torch import perf_microbench

    return perf_microbench.bound(nbytes, nops)


def write_lpips_stub(torch, path, net="alex", seed=0):
    """Seeded stand-in LPIPS weights (no real checkpoint is in the repo) in
    the lpips package's state-dict layout: the scaling layer's constants,
    backbone weights N(0, 0.1^2) and non-negative linear heads U(0, 1)."""
    from deblur_e_nerf_tpu_torch.training import metrics

    gen = torch.Generator().manual_seed(seed)
    constants = {
        "scaling_layer.shift": [-0.030, -0.088, -0.188],
        "scaling_layer.scale": [0.458, 0.448, 0.450]}
    state = {}
    for name, value in metrics.lpips_module(net).state_dict().items():
        if name in constants:
            state[name] = torch.tensor(constants[name]).view(1, 3, 1, 1)
        elif name.startswith("lin"):
            state[name] = torch.rand(value.shape, generator=gen)
        else:
            state[name] = 0.1 * torch.randn(value.shape, generator=gen)
    torch.save(state, path)
    return path


def phase_environment(torch):
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}", flush=True)
    print(f"device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    print(f"nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc?'}",
          flush=True)
    try:
        import triton
        print(f"triton {triton.__version__}", flush=True)
    except ImportError:
        print("triton: not importable", flush=True)
    return card


def phase_build():
    from deblur_e_nerf_tpu_torch.ops import _cuda_build

    _cuda_build.library()
    info = _cuda_build.build_info
    print(f"kernel library {info['path']} built in {info['seconds']:.2f} s "
          f"(reused: {info['reused']})", flush=True)
    if info["log"]:
        print(info["log"], flush=True)
    check_scatter_sass(_cuda_build.sass_instructions(info["path"]))
    ptxas = _cuda_build.ptxas_summary(info["log"])
    check_gather_build(
        _cuda_build.sass_instructions(info["path"], ("LDG", "STG"),
                                      operands=True), ptxas)
    for fn, summary in sorted(ptxas.items()):
        if "corner_sum_kernel" in fn and "Li2E" in fn:  # F = 2
            print(f"corner_sum ({fn}): ptxas [{summary}]", flush=True)
    return info


# the scatter-add instances of the main path's widths, by their mangled
# template arguments <VEC, CPR, index type>
SCATTER_MAIN_INSTANCES = {"W=16 (float4 chunks)": "ILi4ELi4EiE",
                          "W=2 (float2 rows)": "ILi2ELi1EiE"}


def check_scatter_sass(atomics):
    """Print each scatter-add instance's atomic SASS instructions; fail
    unless the main path's widths use vector reductions (a RED whose
    opcode names a 2- or 4-float vector) and no returning ATOM."""
    for fn, ops in sorted(atomics.items()):
        if "scatter_add_rows_kernel" in fn:
            print(f"sass {fn}: {sorted(set(ops))}", flush=True)
    for width, args in SCATTER_MAIN_INSTANCES.items():
        ops = [op for fn, o in atomics.items()
               if f"scatter_add_rows_kernel{args}" in fn for op in o]
        vector = [op for op in ops if op.startswith("RED")
                  and re.search(r"(x2|x4|V2|V4|\.64|\.128)", op)]
        print(f"sass scatter_add_rows {width}: vector reductions "
              f"{sorted(set(vector))}", flush=True)
        if not vector or any(op.startswith("ATOM") for op in ops):
            raise AssertionError(f"scatter_add_rows {width}: no vector RED "
                                 f"in the SASS ({sorted(set(ops))})")


# the gather instances of the main path, by their mangled names and
# template arguments <W, bf16 rows, ...>
GATHER_MAIN_INSTANCES = {
    "W=2, bf16 rows": "gather_rows_kernel_w2ILb1E",
    "W=2, float32 rows": "gather_rows_kernel_w2ILb0E",
    "W=16, bf16 rows": "gather_rows_kernel_wideILi16ELb1E",
    "W=16, float32 rows": "gather_rows_kernel_wideILi16ELb0E",
}


def check_gather_build(sass, ptxas):
    """Print each main-path gather instance's registers and spills (from
    the -Xptxas -v log) and its SASS load and store forms, each with the
    operands of its first occurrence; fail unless the instance exists and
    stores 16-byte vectors."""
    for label, key in GATHER_MAIN_INSTANCES.items():
        fns = [fn for fn in sass if key in fn]
        if not fns:
            raise AssertionError(f"gather_rows {label}: no such instance")
        for fn in fns:
            first = {}
            for ins in sass[fn]:
                first.setdefault(ins.split()[0], ins)
            loads = [first[op] for op in sorted(first) if op.startswith("LDG")]
            stores = sorted(op for op in first if op.startswith("STG"))
            print(f"gather_rows {label} ({fn}): ptxas "
                  f"[{ptxas.get(fn, 'not in the log (build reused)')}]; "
                  f"sass loads "
                  f"{loads}, stores {[first[op] for op in stores]}",
                  flush=True)
            if not any(op.endswith(".128") for op in stores):
                raise AssertionError(f"gather_rows {label}: no 16-byte "
                                     f"store in the SASS ({stores})")


def k1_inputs(kind, n, n_rows, width, seed=0):
    """K1's inputs as numpy arrays, idx (n,) int32 and val (n, width)
    float32 (standard normal), with the index structure `kind`:
      uniform       indices uniform in [0, n_rows);
      empty_tail    the training step's empty sample slots: the last 40%
                    of the rows are zero rows at one index, after uniform
                    rows;
      ray_runs      runs of equal indices (a ray's adjacent samples in one
                    cell), run lengths geometric with mean 8;
      one_run       every row at one index;
      all_zero      uniform, every row zero (the kernel's reads alone);
      signed_zeros  uniform, a quarter of the rows +0.0, a quarter -0.0;
      nonfinite     uniform, some rows holding a NaN, +inf or -inf;
      out_of_range  uniform, a tenth of the indices -1 or n_rows (they
                    add nothing)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n, dtype=np.int32)
    val = rng.standard_normal((n, width), dtype=np.float32)
    if kind == "empty_tail":
        tail = n - int(round(0.6 * n))
        idx[n - tail:] = n_rows - 1
        val[n - tail:] = 0.0
    elif kind == "ray_runs":
        starts = rng.random(n) < 1.0 / 8.0
        starts[0] = True
        idx = idx[np.cumsum(starts) - 1]
    elif kind == "one_run":
        idx[:] = n_rows // 2
    elif kind == "all_zero":
        val[:] = 0.0
    elif kind == "signed_zeros":
        rows = rng.permutation(n)
        val[rows[:n // 4]] = 0.0
        val[rows[n // 4:n // 2]] = -0.0
    elif kind == "nonfinite":
        rows = rng.choice(n, size=3 * max(n // 1000, 1), replace=False)
        for part, value in zip(np.array_split(rows, 3),
                               (np.nan, np.inf, -np.inf)):
            val[part, rng.integers(0, width, part.size)] = value
    elif kind == "out_of_range":
        rows = rng.choice(n, size=max(n // 10, 1), replace=False)
        idx[rows] = np.where(rng.random(rows.size) < 0.5, -1, n_rows)
    elif kind != "uniform":
        raise ValueError(f"unknown K1 index structure {kind!r}")
    return idx, val


def k1_check(torch, out, idx, val, n_rows, label):
    """K1's result against the plain version and the plain model of the
    kernel's summation order (scatter_rows.scatter_add_rows_combined), all
    on out's device; the in-range rows only reach index_add_. Returns
    (max abs error against each and against float64, tolerance): any
    summation order of k terms is within (k - 1) eps sum|x| of the exact
    sum, and the two sides each are, hence 2x, with k the largest count of
    non-zero contributions to one row. Non-finite results must agree
    exactly (NaN where the plain version has NaN, the same infinities)."""
    from deblur_e_nerf_tpu_torch.ops import scatter_rows

    keep = (idx >= 0) & (idx < n_rows)
    i_in, v_in = idx[keep], val[keep]
    plain = scatter_rows.scatter_add_rows_reference(i_in, v_in, n_rows)
    model = scatter_rows.scatter_add_rows_combined(idx, val, n_rows)
    exact = scatter_rows.scatter_add_rows_reference(i_in, v_in, n_rows,
                                                    dtype=torch.float64)
    nonzero = (v_in != 0).any(dim=1)
    counts = torch.bincount(i_in[nonzero].long(), minlength=n_rows)
    finite = torch.isfinite(v_in).all(dim=1)
    abs_sum = scatter_rows.scatter_add_rows_reference(
        i_in[finite], v_in[finite].abs(), n_rows, dtype=torch.float64)
    eps = torch.finfo(torch.float32).eps
    tol = 2.0 * max(int(counts.max()) - 1, 1) * eps * float(abs_sum.max())
    errs = []
    for name, want in (("plain", plain), ("model", model),
                       ("float64", exact)):
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(out)) or not torch.equal(
                out[~fin].double().nan_to_num(),
                want[~fin].double().nan_to_num()):
            raise AssertionError(f"K1 {label}: non-finite entries differ "
                                 f"from the {name} version")
        errs.append(float((out.double() - want.double())[fin].abs().max())
                    if bool(fin.any()) else 0.0)
    if not max(errs) <= tol:
        raise AssertionError(f"K1 {label}: error {errs} above {tol}")
    return errs, tol


def scatter_case(torch, scatter_rows, name, width, n_rows, n,
                 kind="uniform", seed=0):
    """K1 against its plain version and the model of its order at one
    shape and index structure; returns the row."""
    idx_np, val_np = k1_inputs(kind, n, n_rows, width, seed)
    idx = torch.from_numpy(idx_np).to("cuda")
    val = torch.from_numpy(val_np).to("cuda")
    del idx_np, val_np
    out = scatter_rows.scatter_add_rows(idx, val, n_rows)
    torch.cuda.synchronize()
    (err, err_model, err_exact), tol = k1_check(torch, out, idx, val, n_rows,
                                                name)
    del out
    counts = torch.bincount(idx.long(), minlength=n_rows)
    idx64 = idx.long()
    ms = time_ms(lambda: scatter_rows.scatter_add_rows(idx, val, n_rows))
    plain_ms = time_ms(
        lambda: scatter_rows.scatter_add_rows_reference(idx, val, n_rows))
    library_ms = time_ms(lambda: torch.zeros(
        (n_rows, width), device="cuda").index_add_(0, idx64, val))
    bound_ms, bound_by = bound(n * width * 4 + n * 4 + n_rows * width * 4,
                               n * width)
    row = {
        "shape": name, "index_structure": kind, "width": width,
        "n_rows": n_rows, "n": n, "max_abs_err": err,
        "max_abs_err_vs_model": err_model, "max_abs_err_vs_f64": err_exact,
        "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "max_row_count": int(counts.max()),
    }
    print(f"K1 {name} ({kind}): W={width} n_rows={n_rows} N={n} "
          f"max_abs_err {err:.3e} (vs model {err_model:.3e}, vs f64 "
          f"{err_exact:.3e}, tolerance {tol:.3e}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return row


def _call_split(torch, fn, calls):
    """fn's host time per call (enqueue only: `calls` calls without a
    sync), its time per call by CUDA events, and {kernel: device ms per
    call} from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    event_ms = time_ms(fn, iters=calls, warmup=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = {e.key: e.self_device_time_total / calls / 1e3
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    return host_ms, event_ms, device


def k1_call_split(torch, scatter_rows, name, width, n_rows, n, calls=200):
    """The K1 wrapper's host time per call beside its time by CUDA events
    and the device time of its kernel and of the output's zero fill; the
    same for the library call (torch.zeros + index_add_)."""
    idx_np, val_np = k1_inputs("uniform", n, n_rows, width)
    idx = torch.from_numpy(idx_np).to("cuda")
    val = torch.from_numpy(val_np).to("cuda")
    idx64 = idx.long()
    host_ms, event_ms, device = _call_split(
        torch, lambda: scatter_rows.scatter_add_rows(idx, val, n_rows), calls)
    kernel_ms = sum(ms for k, ms in device.items()
                    if KERNEL_NAMES["scatter_add_rows"] in k)
    fill_ms = sum(device.values()) - kernel_ms
    lib_host_ms, lib_event_ms, lib_device = _call_split(
        torch, lambda: torch.zeros((n_rows, width), device="cuda")
        .index_add_(0, idx64, val), calls)
    row = {"shape": name, "n": n, "n_rows": n_rows, "width": width,
           "host_ms_per_call": host_ms, "event_ms_per_call": event_ms,
           "kernel_device_ms": kernel_ms, "zero_fill_device_ms": fill_ms,
           "library_host_ms_per_call": lib_host_ms,
           "library_event_ms_per_call": lib_event_ms,
           "library_device_ms": sum(lib_device.values())}
    print(f"K1 call split, {name}: wrapper host {host_ms:.4f} ms per call "
          f"(enqueue), {event_ms:.4f} ms per call by CUDA events; device: "
          f"kernel {kernel_ms:.4f} ms, zero fill {fill_ms:.4f} ms. "
          f"index_add_ (with its torch.zeros): host {lib_host_ms:.4f} ms, "
          f"CUDA events {lib_event_ms:.4f} ms, device "
          f"{row['library_device_ms']:.4f} ms", flush=True)
    if kernel_ms <= 0:
        raise AssertionError(f"K1 call split {name}: no kernel time")
    return row


def k3_indices(torch, kind, n, n_rows, seed=0, device="cuda"):
    """K3's (n,) int32 indices on `device`: "uniform" in [0, n_rows), or
    "ray_runs", K1's runs of equal indices (k1_inputs)."""
    idx, _ = k1_inputs(kind, n, n_rows, 0, seed)
    return torch.from_numpy(idx).to(device)


def vertex_hash_indices(torch, n_samples, size, corner_major, seed=0,
                        device="cuda"):
    """The (8 n_samples,) corner rows that the encode gathers at the
    flagship's vertex-hash level 6 for samples in ray-ordered runs: K1's
    runs of equal indices (k1_inputs) over the level's cells, each sample
    at a uniform position in its cell, through the encode's own index
    function, sample-major or corner-major."""
    from deblur_e_nerf_tpu_torch.models import hash_encoding

    res = hash_encoding.level_resolutions(7, 16, 1.4472692012786865)[6]
    cells, _ = k1_inputs("ray_runs", n_samples, res ** 3, 0, seed)
    c = torch.from_numpy(cells).to(device).long()
    del cells
    xyz = torch.stack([c % res, c // res % res, c // (res * res)], dim=-1)
    del c
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = (xyz + torch.rand(xyz.shape, generator=gen, device=device)) / res
    del xyz
    idx, _ = hash_encoding._level_indices_weights(
        u, res, size, 0, "hash", torch.float32, corner_major=corner_major)
    return idx.reshape(-1).to(torch.int32)


def _bits(torch, t):
    """t's bits as integers of its width (a bit-for-bit comparison)."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def gather_case(torch, gather_rows, name, width, n_rows, idx, kind, gen):
    """The gather kernel against its plain version at one shape and index
    structure, in both output types: bit for bit (a copy, rounded to
    nearest even for bf16 rows); returns the two rows. The library calls
    (index_select, advanced indexing) gather float32 rows of the same
    table; each row's library_ms is the faster."""
    from deblur_e_nerf_tpu_torch import perf_microbench

    tbl = torch.randn((n_rows, width), generator=gen, device="cuda")
    idx64 = idx.long()
    library = {"index_select": time_ms(
                   lambda: torch.index_select(tbl, 0, idx64), iters=10),
               "tbl[idx64]": time_ms(lambda: tbl[idx64], iters=10)}
    del idx64
    rows = []
    for round_to in (torch.bfloat16, None):
        out_dtype = round_to or torch.float32
        out = gather_rows.gather_rows(tbl, idx, round_to)
        plain = gather_rows.gather_rows_reference(tbl, idx, round_to)
        torch.cuda.synchronize()
        exact = out.dtype == plain.dtype == out_dtype and bool(
            torch.equal(_bits(torch, out), _bits(torch, plain)))
        err = float((out.float() - plain.float()).abs().max())
        del out, plain
        ms = time_ms(lambda: gather_rows.gather_rows(tbl, idx, round_to))
        plain_ms = time_ms(lambda: gather_rows.gather_rows_reference(
            tbl, idx, round_to), iters=10)
        bound_ms, bound_by = bound(perf_microbench.gather_bytes(
            tbl, idx, out_dtype))
        call = min(library, key=library.get)
        out_name = str(out_dtype).replace("torch.", "")
        row = {
            "shape": name, "index_structure": kind, "width": width,
            "n_rows": n_rows, "n": idx.numel(), "out_dtype": out_name,
            "max_abs_err": err, "bit_exact": exact, "tolerance": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[call],
            "library_call": call,
            "index_select_ms": library["index_select"],
            "advanced_indexing_ms": library["tbl[idx64]"],
        }
        print(f"gather_rows {name} ({kind}, {out_name} rows): W={width} "
              f"n_rows={n_rows} N={idx.numel()} max_abs_err {err:.3e} "
              f"(bit exact: {exact}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_select "
              f"{library['index_select']:.4f} ms, tbl[idx64] "
              f"{library['tbl[idx64]']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        if not exact:
            raise AssertionError(f"gather_rows {name} ({kind}, {out_name}): "
                                 f"differs from plain")
        rows.append(row)
    return rows


def corner_sum_case(torch, corner_sum, name, n, rows_dtype, gen):
    """The corner-sum kernel at one shape and row type: bit for bit
    against the plain model of its order, and within the summation order
    bound of the plain version (any order of 8 terms is within 7 eps
    sum|x| of the exact sum, and each side is: hence 2x); returns the row.
    With float32 rows one PyTorch call computes the same function,
    torch.bmm(w[:, None, :], rows) (library_ms); with bf16 rows none does
    (bmm and einsum take no mixed dtypes), so library_ms is null there."""
    rows = torch.randn((n, 8, 2), generator=gen, device="cuda").to(rows_dtype)
    w = torch.rand((n, 8), generator=gen, device="cuda")
    out = corner_sum.corner_sum(rows, w)
    model = corner_sum.corner_sum_sequential(rows, w)
    plain = corner_sum.corner_sum_reference(rows, w)
    abs_sum = corner_sum.corner_sum_reference(rows.abs(), w)
    torch.cuda.synchronize()
    exact = bool(torch.equal(_bits(torch, out), _bits(torch, model)))
    err = float((out - plain).abs().max())
    tol = 2 * 7 * torch.finfo(torch.float32).eps * float(abs_sum.max())
    library_ms = None
    if rows_dtype == torch.float32:
        lib_out = torch.bmm(w[:, None, :], rows)[:, 0]
        lib_err = float((lib_out - plain).abs().max())
        if not lib_err <= tol:
            raise AssertionError(f"corner_sum {name}: torch.bmm differs "
                                 f"from plain by {lib_err:.3e}")
        del lib_out
        library_ms = time_ms(lambda: torch.bmm(w[:, None, :], rows), iters=10)
    del out, model, plain, abs_sum
    ms = time_ms(lambda: corner_sum.corner_sum(rows, w))
    plain_ms = time_ms(lambda: corner_sum.corner_sum_reference(rows, w),
                       iters=10)
    bound_ms, bound_by = bound(
        rows.numel() * rows.element_size() + w.numel() * 4 + n * 2 * 4,
        2 * rows.numel())
    rows_name = str(rows_dtype).replace("torch.", "")
    row = {
        "shape": name, "rows_dtype": rows_name, "n": n,
        "max_abs_err": err, "bit_exact_vs_model": exact, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }
    library = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"corner_sum {name} ({rows_name} rows): N={n} max_abs_err "
          f"{err:.3e} vs plain (tolerance {tol:.3e}), bit exact vs the model "
          f"of its order: {exact}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.bmm {library}, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    if not (exact and err <= tol):
        raise AssertionError(f"corner_sum {name} ({rows_name}): differs "
                             f"from its plain versions")
    return row


def probe_case(case):
    """K2/K3 through the port's microbenchmark (the JAX script's check)."""
    from deblur_e_nerf_tpu_torch import perf_microbench

    row = perf_microbench.CASES[case]("cuda")
    print(f"{case} ({row['kernel']}): {json.dumps(row)}", flush=True)
    if not row["max_abs_err"] <= row["tolerance"]:
        raise AssertionError(f"{case}: error {row['max_abs_err']} above "
                             f"{row['tolerance']}")
    return dict(row, shape=f"{case} probe")


def phase_kernels(torch):
    from deblur_e_nerf_tpu_torch.ops import (corner_sum, gather_rows,
                                             scatter_rows)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = 131072
    k1 = MAIN_PATH_SAMPLE_BUDGET + 1
    k1_off = FILTER_OFF_SAMPLE_BUDGET + 1
    scatter_cases = [
        # the filter-on step's calls: one per level, on all K + 1 slots
        ("main path: cellhash levels 7-15", 16, 65536, k1),
        ("main path: dense level 0", 16, 4096, k1),
        ("main path: vertex-hash levels 5-6", 2, 524288, 8 * k1),
        # the step's index structures: a warmup step's ~6.3M empty slots
        # (zero rows at one index) after the marched samples, and the
        # ray-ordered runs of samples sharing a cell
        ("main path: cellhash levels 7-15", 16, 65536, k1, "empty_tail"),
        ("main path: cellhash levels 7-15", 16, 65536, k1, "ray_runs"),
        ("main path: dense level 0", 16, 4096, k1, "ray_runs"),
        # the reads alone: every row zero, no atomic issued
        ("main path: cellhash levels 7-15", 16, 65536, k1, "all_zero"),
        ("main path: vertex-hash levels 5-6", 2, 524288, 8 * k1,
         "all_zero"),
        # the filter-off step's
        ("filter off: cellhash levels 7-15", 16, 65536, k1_off),
        ("filter off: dense level 0", 16, 4096, k1_off),
        ("filter off: vertex-hash levels 5-6", 2, 524288, 8 * k1_off),
        # the same tables at N = 131072 rows
        ("cellhash table, N=131072", 16, 65536, n),
        ("dense level 0 table, N=131072", 16, 4096, n),
        ("vertex-hash table, N=131072", 2, 524288, n),
    ]
    scatter = []
    for case in scatter_cases:
        scatter.append(scatter_case(torch, scatter_rows, *case))
        torch.cuda.empty_cache()
    from deblur_e_nerf_tpu_torch import perf_microbench

    splits = [k1_call_split(torch, scatter_rows, *c) for c in (
        ("cellhash table, N=131072", 16, 65536, n),
        ("pallas_probe", perf_microbench.PROBE_WIDTH,
         perf_microbench.PROBE_TABLE_ROWS, perf_microbench.PROBE_ROWS))]
    # the filter-on step's encode (and the occupancy update's): one gather
    # per level over all K + 1 slots, on uniform rows and on ray-ordered
    # runs; the vertex-hash level's 8 corners per sample in both orders
    vertex = "main path: vertex-hash levels 5-6"
    gather_inputs = [
        (name, width, n_rows, kind,
         lambda n_rows=n_rows, kind=kind: k3_indices(torch, kind, k1, n_rows))
        for name, width, n_rows in (
            ("main path: cellhash view, levels 7-15", 16, 65536),
            ("main path: packed dense level 0", 16, 16 ** 3),
            ("main path: packed dense level 4", 16, 70 ** 3))
        for kind in ("uniform", "ray_runs")]
    gather_inputs += [
        (vertex, 2, 524288, "uniform",
         lambda: k3_indices(torch, "uniform", 8 * k1, 524288)),
        (vertex, 2, 524288, "ray_runs, sample-major",
         lambda: vertex_hash_indices(torch, k1, 524288, False)),
        (vertex, 2, 524288, "ray_runs, corner-major",
         lambda: vertex_hash_indices(torch, k1, 524288, True)),
    ]
    # the eval render's field calls (no gradient): N = 2^20 samples
    from deblur_e_nerf_tpu_torch.training.evaluation import (
        DEFAULT_FIELD_CHUNK as n_eval)
    gather_inputs += [
        ("eval field chunk: cellhash view, levels 7-15", 16, 65536, "uniform",
         lambda: k3_indices(torch, "uniform", n_eval, 65536)),
        ("eval field chunk: vertex-hash levels 5-6", 2, 524288, "uniform",
         lambda: k3_indices(torch, "uniform", 8 * n_eval, 524288)),
    ]
    gather = []
    for name, width, n_rows, kind, make_idx in gather_inputs:
        with torch.no_grad():
            gather += gather_case(torch, gather_rows, name, width, n_rows,
                                  make_idx(), kind, gen)
        torch.cuda.empty_cache()
    # the encode's weighted sum over each level's gathered rows, (N, 8, 2),
    # in the training step and in an eval field call
    with torch.no_grad():
        sums = [corner_sum_case(torch, corner_sum, name, n, rows_dtype, gen)
                for name, n in (("main path: every level", k1),
                                ("eval field chunk: every level", n_eval))
                for rows_dtype in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()
    scatter.append(probe_case("pallas_probe"))
    gather.append(probe_case("pallas_gather_probe"))
    return {"scatter_add_rows": scatter, "gather_rows": gather,
            "corner_sum": sums, "scatter_add_rows_call_split": splits}


KERNEL_NAMES = {"scatter_add_rows": "scatter_add_rows_kernel",
                "gather_rows": "gather_rows_kernel",
                "corner_sum": "corner_sum_kernel"}


def _device_table(prof, label, n):
    """Print kernel (device) time and the operators that launched it;
    returns (busy ms per call, {kernel: ms per call} of the port's
    kernels)."""
    from torch.autograd import DeviceType

    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    ops = [e for e in avgs if e.device_type != DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    print(f"profile {label}: kernels busy {total / n / 1e3:.3f} ms per "
          f"call", flush=True)
    for kind, events in (("kernel", kernels), ("op", ops)):
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"profile {label} {kind}: "
                  f"{e.self_device_time_total / n / 1e3:8.3f} ms "
                  f"{100 * e.self_device_time_total / total:5.1f}% "
                  f"x{e.count / n:<6.1f} {e.key[:80]}", flush=True)
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if key in e.key) / n / 1e3
            for name, key in KERNEL_NAMES.items()}
    return total / n / 1e3, ours


def _kernel_calls(prof, name):
    """Device ms of each launch of the port's kernel `name`, in launch
    order (for the scatter-add, one per hash level)."""
    from torch.autograd import DeviceType

    key = KERNEL_NAMES[name]
    calls = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA and key in e.name),
                   key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in calls]


def _per_call(prof):
    """The port's kernels' device ms per launch, in launch order (one per
    hash level in the encode; the warmup occupancy update's gathers
    follow the step's)."""
    return "; ".join(
        f"{name} per call (ms) "
        f"{[round(t, 4) for t in _kernel_calls(prof, name)]}"
        for name in KERNEL_NAMES)


def profile_steps(torch, trainer, n_steps=3):
    """Device time by kernel (torch.profiler) of steady-state steps and of
    one warmup (full-grid) occupancy update, with their wall times; per
    profiled step, the marched samples and the empty sample slots beside
    the port's kernels' device times."""
    from torch.profiler import ProfilerActivity, profile

    # past the warmup and off the occupancy schedule: these steps run no
    # occupancy update
    trainer.global_step = int(trainer.params.nerf.occ_grid_config
                              .warmup_steps) + 1
    for _ in range(2):
        trainer.train_step()
    K = trainer.params.nerf.render_config.sample_budget

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    runs = (("step", trainer.train_step, n_steps),
            ("warmup occupancy update",
             lambda: trainer.update_occupancy(step=0), 1))
    for label, fn, n in runs:
        wall = timed(fn, n)
        for i in range(n):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            busy, ours = _device_table(prof, f"{label} {i}", 1)
            kernels = ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items())
            if label == "step":
                marched = int(out["num_marched_samples"])
                print(f"profile step {i}: marched samples {marched}, empty "
                      f"slots {K + 1 - min(marched, K)} of K + 1 = {K + 1}; "
                      f"{kernels}; {_per_call(prof)}", flush=True)
            else:
                print(f"profile {label}: {kernels}", flush=True)
        print(f"profile {label}: wall {wall:.3f} ms per call without the "
              f"profiler, device busy {100 * busy / wall:.1f}% of the last "
              f"profiled call's wall", flush=True)


def _kernel_modules():
    from deblur_e_nerf_tpu_torch.ops import (corner_sum, gather_rows,
                                             scatter_rows)

    return {"scatter_add_rows": scatter_rows, "gather_rows": gather_rows,
            "corner_sum": corner_sum}


def reset_launches():
    for module in _kernel_modules().values():
        module.LAUNCHES = 0


def read_launches():
    return {name: module.LAUNCHES
            for name, module in _kernel_modules().items()}


def run_steps(torch, trainer, n_steps, label, profile=False):
    """Take `n_steps` training steps; print and check each. With
    `profile`, each step runs under torch.profiler (its step time then
    includes the profiler's overhead) and its device time by kernel is
    printed beside its marched samples and empty slots."""
    from torch.profiler import ProfilerActivity, profile as profiler

    field = trainer.params.nerf.field
    K = trainer.params.nerf.render_config.sample_budget
    card = torch.cuda.get_device_name(0)
    for i in range(n_steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if profile:
            with profiler(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                m = trainer.train_step()
                torch.cuda.synchronize()
        else:
            m = trainer.train_step()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        marched = int(m["num_marched_samples"])
        wsum = (f"{float(m['pb_min_abs_weight_sum']):.6f}"
                if "pb_min_abs_weight_sum" in m else "n/a (filter off)")
        print(f"{label} step {i}: loss {loss:.6f}, active events "
              f"{int(m['batch_size'])}, rays {int(m['num_rays'])}, marched "
              f"samples {marched} (empty slots "
              f"{K + 1 - min(marched, K)} of {K + 1}), samples/ray "
              f"{float(m['mean_num_samples_per_ray']):.2f}, truncated "
              f"rays {float(m['ray_truncation_rate']):.4f}, valid "
              f"{float(m['mean_valid_rate']):.3f}, min |weight sum| {wsum}, "
              f"skipped {bool(m['update_skipped'])}, step time {dt:.3f} s, "
              f"peak device memory {peak:.2f} GiB on {card}", flush=True)
        if not torch.isfinite(m["loss"]) or bool(m["update_skipped"]):
            raise AssertionError(f"{label} step {i}: non-finite loss or "
                                 f"skip")
        grad = field.table.grad
        if grad is None or not bool(torch.isfinite(grad).all()) \
                or float(grad.abs().max()) == 0.0:
            raise AssertionError(f"{label} step {i}: table gradient "
                                 f"missing/zero")
        print(f"{label} step {i}: table grad max |g| "
              f"{float(grad.abs().max()):.3e}, nonzero rows "
              f"{int((grad != 0).any(dim=1).sum())}", flush=True)
        if profile:
            _, ours = _device_table(prof, f"{label} step {i}", 1)
            print(f"profile {label} step {i} (profiled): marched samples "
                  f"{marched}, empty slots {K + 1 - min(marched, K)}; "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items())
                  + f"; {_per_call(prof)}", flush=True)


def count_step_syncs(torch, trainer, label="flagship",
                     forbidden=("training/optim.py",), expected=None):
    """One steady step (past the occupancy warmup, off the occupancy
    schedule) under torch.cuda.set_sync_debug_mode("warn"): returns
    {source line: host syncs}, each sync attributed to the innermost line
    of the port on the stack, and prints it. A sync in one of the
    `forbidden` files (the optimizer's) fails the run, and so do kernel
    launches other than `expected` (default: each kernel once per hash
    level)."""
    import traceback
    import warnings

    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "deblur_e_nerf_tpu_torch" in f.filename]
        if ours:
            site = f"{ours[-1].filename}:{ours[-1].lineno}".split(
                "deblur_e_nerf_tpu_torch/")[-1]
        else:  # no frame of the port: name the callers
            site = " <- ".join(f"{f.filename.split('/')[-1]}:{f.lineno}"
                               f" {f.name}" for f in reversed(stack[-4:]))
        sites[site] = sites.get(site, 0) + 1

    trainer.global_step = int(trainer.params.nerf.occ_grid_config
                              .warmup_steps) + 1
    torch.cuda.synchronize()
    reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"host syncs in one steady {label} step: {sum(sites.values())} "
          f"({sites}); kernel launches {launches}", flush=True)
    if expected is None:
        n_levels = len(trainer.params.nerf.field.levels)
        expected = {name: n_levels for name in launches}
    if launches != expected:
        raise AssertionError(f"a steady {label} step launches {launches}, "
                             f"want {expected}")
    if any(f in site for site in sites for f in forbidden):
        raise AssertionError(f"{label}: a sync in {forbidden}: {sites}")
    if not any("ops/linalg.py" in site for site in sites):
        # the expm's squaring count is read on the host every step
        raise AssertionError(f"the sync counter missed ops/linalg.py's "
                             f"known sync: {sites}")
    return sites


def build_trainer(torch, root, tmp, filter_on):
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    config = flagship_config(root, filter_on=filter_on)
    t0 = time.perf_counter()
    trainer = Trainer(config, f"{tmp}/log_{int(filter_on)}", device="cuda")
    field = trainer.params.nerf.field
    sc = trainer.bundle.static_config
    print(f"trainer (filter {'on' if filter_on else 'off'}) built in "
          f"{time.perf_counter() - t0:.2f} s: table "
          f"{tuple(field.table.shape)}, levels "
          f"{[(r, m) for r, _, _, m in field.levels]}, batch capacity "
          f"{trainer.batch_capacity}, pixel bandwidth "
          f"{sc.pixel_bandwidth_enabled} (S {sc.it_sample_size}), sample "
          f"budget {trainer.params.nerf.render_config.sample_budget}",
          flush=True)
    return trainer


def phase_training(torch, tmp, profile=False):
    """Both paths; returns ({path: {kernel: launches}}, the flagship
    trainer, the dataset directory)."""
    from deblur_e_nerf_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    root = synthetic.make_dataset(f"{tmp}/dataset", img_height=64,
                                  img_width=64, num_poses=61,
                                  write_views=True)
    print(f"synthetic dataset in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches = {}

    trainer = build_trainer(torch, root, tmp, filter_on=False)
    if trainer.params.nerf.render_config.sample_budget \
            != FILTER_OFF_SAMPLE_BUDGET:
        raise AssertionError("filter-off sample budget is not the default")
    reset_launches()
    run_steps(torch, trainer, 2, "filter off")
    t0 = time.perf_counter()
    occ = trainer.update_occupancy(step=int(
        trainer.params.nerf.occ_grid_config.warmup_steps))
    torch.cuda.synchronize()
    print(f"filter off: forced (post-warmup) occupancy update in "
          f"{time.perf_counter() - t0:.3f} s: occupied fraction "
          f"{float(occ.binary.float().mean()):.4f}", flush=True)
    launches["filter off"] = read_launches()
    trainer._flush_pending_metrics()
    del trainer, occ
    torch.cuda.empty_cache()

    trainer = build_trainer(torch, root, tmp, filter_on=True)
    sc = trainer.bundle.static_config
    if not (sc.pixel_bandwidth_enabled and sc.it_sample_size == 30
            and trainer.params.nerf.render_config.sample_budget
            == MAIN_PATH_SAMPLE_BUDGET):
        raise AssertionError("the flagship step is not the one configured")
    reset_launches()
    run_steps(torch, trainer, 3, "flagship (filter on)", profile=profile)
    launches["filter on"] = read_launches()
    trainer._flush_pending_metrics()
    count_step_syncs(torch, trainer)
    trainer._flush_pending_metrics()
    if profile:
        profile_steps(torch, trainer)
    for path, counts in launches.items():
        print(f"training, {path}: launches {counts}", flush=True)
        for name, count in counts.items():
            if count <= 0:
                raise AssertionError(f"{path}: {name} never launched")
    return launches, trainer, root


def _field_reference(torch):
    """NGP field outputs and table gradient: card (kernels) vs CPU."""
    from deblur_e_nerf_tpu_torch.models import contraction, fields

    def make(device):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1)
        field = fields.NGPField(
            aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
            contraction_type=contraction.ContractionType.AABB,
            radiance_dim=1, pos_otype="HybridHashGrid", n_levels=8,
            log2_hashmap_size=12, base_resolution=4, per_level_scale=2.0,
            grid_compute_dtype="bfloat16", generator=gen)
        with torch.no_grad():
            field.table.uniform_(-1.0, 1.0, generator=gen)
        return field.to(device)

    gen = torch.Generator(device="cpu")
    gen.manual_seed(2)
    x = torch.rand((4096, 3), generator=gen) * 3.2 - 1.6
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen),
                                      dim=-1)
    outs = {}
    for device in ("cpu", "cuda"):
        field = make(device)
        rgb, sigma = field(x.to(device), d.to(device))
        (rgb.sum() + sigma.sum()).backward()
        outs[device] = [t.detach().double().cpu()
                        for t in (rgb, sigma, field.table.grad)]
    names = ("radiance", "density", "table grad")
    for name, a, b in zip(names, outs["cpu"], outs["cuda"]):
        err = float((a - b).abs().max())
        tol = 1e-4 * max(float(a.abs().max()), 1.0)
        print(f"reference {name}: max abs err {err:.3e} (tolerance "
              f"{tol:.3e})", flush=True)
        if not (torch.isfinite(b).all() and err <= tol):
            raise AssertionError(f"{name}: card and CPU disagree ({err})")


def small_config(root, filter_on):
    """The flagship config at the reference checks' small size: 6 hash
    levels (dense, vertex-hash and cellhash ones), 16-wide MLPs, a 32^3
    occupancy grid."""
    config = flagship_config(root, filter_on=filter_on)
    pe = config.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    config.model.nerf.ngp.mlp_base.n_neurons = 16
    config.model.nerf.ngp.mlp_head.n_neurons = 16
    config.model.nerf.occ_grid.resolution = 32
    return config


def _to(value, device):
    if isinstance(value, dict):
        return {k: _to(v, device) for k, v in value.items()}
    return value.to(device)


def filter_on_step_card_vs_cpu(torch, tmp, device="cuda"):
    """One filter-on step (S = 30) of a small flagship model on the card
    (`device`) and on the CPU (see `step_card_vs_cpu`)."""
    from deblur_e_nerf_tpu_torch.data import synthetic

    root = synthetic.make_dataset(f"{tmp}/small", img_height=16,
                                  img_width=16, num_poses=21)
    return step_card_vs_cpu(torch, small_config(root, filter_on=True),
                            "filter-on step", device)


def step_card_vs_cpu(torch, config, label, device="cuda"):
    """One filter-on step (S = 30) of a small model on the card (`device`)
    and on the CPU, from the same weights, occupancy grid, batch and
    draws.
    Returns [(name, max abs err, tolerance)]; raises on a disagreement.

    The card differs from the CPU in its libm (an ulp in the poses'
    transcendental functions, which can move a sample across a march
    boundary) and in summation order (atomics): the marched samples agree
    within 1e-4, the loss within 1e-4, each field gradient within 2e-3 of
    its largest entry, and the filter-parameter gradients (sums over
    events that cancel) within 1e-2 of the largest of them."""
    from deblur_e_nerf_tpu_torch.data import events as events_data
    from deblur_e_nerf_tpu_torch.models import nerf_model
    from deblur_e_nerf_tpu_torch.training import pipeline, setup
    from deblur_e_nerf_tpu_torch.training import step as step_lib

    root = config.data.dataset_directory
    # ~300 samples per ray x 6 events x 4 x 30 rays fit K = 2^19; the EDS
    # march takes ~600 a ray: 2 events in K = 2^18 (the training render
    # runs the field on every slot, which the CPU side pays)
    capacity, active, budget = ((4, 2, 1 << 18) if config.model.nerf.cone_angle
                                else (8, 6, 1 << 19))
    cpu = torch.device("cpu")
    bundle_c, params_c = setup.build(config, root, sample_budget=budget,
                                     device=cpu)
    bundle_g, params_g = setup.build(config, root, sample_budget=budget,
                                     device=torch.device(device))
    params_g.load_state_dict(params_c.state_dict())
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    occ_c = nerf_model.update_occupancy(
        params_c.nerf, nerf_model.init_occupancy(params_c.nerf, cpu), 0,
        gen, bundle_c.consts["trajectory"].T_wc_position)
    occ_g = type(occ_c)(*(t.to(device) for t in occ_c))
    events = events_data.EventDataset(root).events
    batch_np = pipeline.EventBatcher(events, capacity, seed=0).next_batch(
        active)
    batch_c = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    sc = bundle_c.static_config
    draws_c = step_lib.draw_step(sc, capacity, occ_c, gen, cpu)
    results = {}
    for name, bundle, params, occ, batch, draws in (
            ("cpu", bundle_c, params_c, occ_c, batch_c, draws_c),
            ("card", bundle_g, params_g, occ_g, _to(batch_c, device),
             _to(draws_c, device))):
        loss, metrics = step_lib.compute_loss(
            params, bundle.consts, occ, batch, draws, sc,
            bundle.loss_config)
        loss.backward()
        results[name] = (float(loss.detach()), metrics, {
            n: p.grad.detach().double().cpu()
            for n, p in params.named_parameters()})
    loss_c, metrics_c, grads_c = results["cpu"]
    loss_g, metrics_g, grads_g = results["card"]
    rows = []

    def check(name, err, tol):
        rows.append((name, err, tol))
        print(f"reference {label} {name}: max abs err {err:.3e} "
              f"(tolerance {tol:.3e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{label} {name}: card and CPU "
                                 f"disagree ({err} > {tol})")

    if not (loss_c > 0 and float(metrics_c["mean_valid_rate"]) > 0.5):
        raise AssertionError(f"{label}: the reference step is degenerate")
    spr = [float(m["mean_num_samples_per_ray"])
           for m in (metrics_c, metrics_g)]
    check("samples per ray", abs(spr[1] - spr[0]), 1e-4 * spr[0])
    check("loss", abs(loss_g - loss_c), 1e-4 * abs(loss_c))
    pb_scale = max(float(g.abs().max()) for n, g in grads_c.items()
                   if n.startswith("pixel_bandwidth."))
    for n, g in grads_c.items():
        err = float((grads_g[n] - g).abs().max())
        if not bool(torch.isfinite(grads_g[n]).all()):
            raise AssertionError(f"{label} grad {n} not finite")
        tol = (1e-2 * pb_scale if n.startswith("pixel_bandwidth.")
               else 2e-3 * float(g.abs().max()) + 1e-12)
        check(f"grad {n}", err, tol)
    return rows


def phase_reference(torch, tmp):
    _field_reference(torch)
    filter_on_step_card_vs_cpu(torch, tmp)


def _pixel_grid(torch, height, width):
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1).to(torch.float32)


def eval_render_card_vs_cpu(torch, tmp, device="cuda", prepass_div=0):
    """The eval render of a small model (a wide random table) on the card
    (`device`) and on the CPU, from the same weights and occupancy grid,
    for one val view of a 32x24 synthetic dataset: 3 chunks of 256 rays,
    field calls of 4096 samples. With `prepass_div`, through the occlusion
    prepass, with the density raised (the output bias + 4) so that rays
    terminate and the prepass culls. Returns [(name, error, tolerance)];
    raises on a disagreement: the marched samples of every pixel must be
    equal and the image within 1e-5."""
    import numpy as np
    from deblur_e_nerf_tpu_torch.data import posed_images, synthetic
    from deblur_e_nerf_tpu_torch.models import nerf_model
    from deblur_e_nerf_tpu_torch.training import evaluation, setup

    root = synthetic.make_dataset(f"{tmp}/eval_small", img_height=24,
                                  img_width=32, num_poses=21,
                                  write_views=True)
    config = small_config(root, filter_on=False)
    config.model.nerf.test_chunk_size = 256
    cpu = torch.device("cpu")
    bundle_c, params_c = setup.build(config, root, sample_budget=4096,
                                     device=cpu)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    with torch.no_grad():
        params_c.nerf.field.table.uniform_(-1.0, 1.0, generator=gen)
        if prepass_div:
            params_c.nerf.field.mlp_base.output.bias[0] += 4.0
    _, params_g = setup.build(config, root, sample_budget=4096,
                              device=torch.device(device))
    params_g.load_state_dict(params_c.state_dict())
    occ_c = nerf_model.update_occupancy(
        params_c.nerf, nerf_model.init_occupancy(params_c.nerf, cpu), 0,
        gen, bundle_c.consts["trajectory"].T_wc_position)
    occ_g = type(occ_c)(*(t.to(device) for t in occ_c))
    view = posed_images.PosedImageDataset(root, "val").posed_imgs
    args = (torch.as_tensor(np.linalg.inv(view["intrinsics"]),
                            dtype=torch.float32),
            _pixel_grid(torch, 24, 32),
            torch.as_tensor(view["T_wc_position"][0]),
            torch.as_tensor(view["T_wc_orientation"][0]))
    out = {}
    for name, params, occ in (("cpu", params_c, occ_c),
                              ("card", params_g, occ_g)):
        render = evaluation.make_render_image_fn(
            params.nerf, field_chunk=4096, eval_prepass_div=prepass_div)
        img = render(occ, *args)
        out[name] = (img.double().cpu(), render.stats["counts"].cpu(),
                     render.stats)
    (img_c, counts_c, stats_c), (img_g, counts_g, stats_g) = \
        out["cpu"], out["card"]
    culled = stats_c["live_samples"] < stats_c["marched_samples"]
    if not (stats_c["live_samples"] > 0 and culled == bool(prepass_div)
            and stats_c["field_chunks"] >= stats_c["ray_chunks"] == 3
            and float(img_c.max() - img_c.min()) > 0):
        raise AssertionError(f"eval reference render is degenerate "
                             f"({stats_c})")
    rows = [("marched samples per pixel (pixels differing)",
             int((counts_g != counts_c).sum()), 0),
            ("image", float((img_g - img_c).abs().max()), 1e-5)]
    label = f" with the prepass (div {prepass_div})" if prepass_div else ""
    for name, err, tol in rows:
        print(f"reference eval render{label} {name}: {err} (tolerance "
              f"{tol}); marched samples {stats_g['marched_samples']}, live "
              f"samples {stats_g['live_samples']} (CPU "
              f"{stats_c['live_samples']}), field calls "
              f"{stats_g['field_chunks']}", flush=True)
        if not (bool(torch.isfinite(img_g).all()) and err <= tol):
            raise AssertionError(f"eval render {name}: card and CPU "
                                 f"disagree ({err} > {tol})")
    return rows


def phase_eval(torch, tmp, trainer, root):
    """Evaluation on the full-width flagship trainer that phase 4 stepped:
    Trainer.evaluate("val") with seeded stub LPIPS weights (every metric
    finite), one 346x260 frame through make_render_image_fn, timed and
    profiled, with its kernel launches (16 per field call: one gather and
    one corner sum per hash level), then the card-vs-CPU eval render.
    Returns {"eval": launches of evaluate("val"), "eval frame": launches
    of one frame}."""

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deblur_e_nerf_tpu_torch.data import posed_images
    from deblur_e_nerf_tpu_torch.training import evaluation

    card = torch.cuda.get_device_name(0)
    n_levels = len(trainer.params.nerf.field.levels)
    trainer.config.metric.lpips_weights_path = write_lpips_stub(
        torch, f"{tmp}/lpips_alex.pt")
    trainer._flush_pending_metrics()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metric = trainer.evaluate("val")
    torch.cuda.synchronize()
    val_launches = read_launches()
    print(f"eval val: {json.dumps(metric)} in "
          f"{time.perf_counter() - t0:.3f} s; kernel launches "
          f"{val_launches}", flush=True)
    if not all(math.isfinite(metric[k]) for k in ("l1", "psnr", "ssim",
                                                  "lpips")):
        raise AssertionError(f"eval val: a metric is not finite: {metric}")
    if not (val_launches["gather_rows"] == val_launches["corner_sum"] > 0
            and val_launches["gather_rows"] % n_levels == 0
            and val_launches["scatter_add_rows"] == 0):
        raise AssertionError(f"eval val launches: {val_launches}")

    H, W = EVAL_FRAME_HEIGHT, EVAL_FRAME_WIDTH
    focal = 0.8 * W
    intrinsics = np.array([[focal, 0, W / 2 - 0.5], [0, focal, H / 2 - 0.5],
                           [0, 0, 1]])
    view = posed_images.PosedImageDataset(root, "val").posed_imgs
    args = (torch.as_tensor(np.linalg.inv(intrinsics), dtype=torch.float32),
            _pixel_grid(torch, H, W),
            torch.as_tensor(view["T_wc_position"][0]),
            torch.as_tensor(view["T_wc_orientation"][0]))
    render = evaluation.make_render_image_fn(trainer.params.nerf)
    render(trainer.occ_state, *args)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        img = render(trainer.occ_state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    stats = render.stats
    ms = sum(times) / len(times)
    print(f"eval frame {W}x{H}: {ms:.3f} ms per image (runs "
          f"{[round(t, 3) for t in times]}), {H * W / ms * 1e3:.1f} rays/s, "
          f"{stats['ray_chunks']} ray chunks of "
          f"{trainer.params.nerf.test_chunk_size}, live marched samples "
          f"{stats['live_samples']} ({stats['live_samples'] / (H * W):.2f} "
          f"per ray), field calls {stats['field_chunks']} "
          f"({stats['field_chunks'] / stats['ray_chunks']:.2f} per ray "
          f"chunk), truncated rays {stats['truncated_rays']}, peak device "
          f"memory {peak:.3f} GiB above the trainer's "
          f"{base / 2**30:.3f} GiB; kernel launches {frame_launches} on "
          f"{card}", flush=True)
    want = n_levels * stats["field_chunks"]
    if not (frame_launches["gather_rows"] == frame_launches["corner_sum"]
            == want > 0 and frame_launches["scatter_add_rows"] == 0):
        raise AssertionError(f"eval frame launches {frame_launches}, want "
                             f"{want} of the gather and the corner sum")
    if img.shape != (H, W) or not bool(torch.isfinite(img).all()) \
            or stats["truncated_rays"]:
        raise AssertionError(f"eval frame: shape {tuple(img.shape)}, "
                             f"finite {bool(torch.isfinite(img).all())}, "
                             f"truncated {stats['truncated_rays']}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(trainer.occ_state, *args)
        torch.cuda.synchronize()
    busy, ours = _device_table(prof, "eval frame", 1)
    print(f"profile eval frame: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ours.items())
        + f"; device busy {100 * busy / ms:.1f}% of the unprofiled "
        f"frame's wall", flush=True)
    eval_render_card_vs_cpu(torch, tmp)
    return {"eval": val_launches, "eval frame": frame_launches}


# phase 7's configs, read with the port's own YAML reader (the card
# machine has no PyYAML)
EDS_TRAIN_CONFIG = "configs/train/07_ziggy_and_fuzz_hdr.yaml"
EDS_TEST_CONFIG = "configs/test/07_ziggy_and_fuzz_hdr.yaml"
# phase 7's cuts of the train config, printed on its `reduced` line (the
# dataset directory is the run's own); trainer.ema_decay is added, as 19
# of the repo's 27 train configs set it, so the phase drives the EMA
EDS_REDUCED = {
    "data.dataset_directory": "a 64x64 synthetic ESIM-layout dataset with "
                              "a plumb_bob distortion",
    "trainer.limit_train_batches": 16,
    "trainer.max_epochs": 2,
    "seed": 0,
    "trainer.ema_decay": 0.999,
}
EDS_DISTORTION = [-0.1, 0.02, 1e-3, -1e-3]
# the EDS sequences' event camera (640x480)
EDS_FRAME_HEIGHT, EDS_FRAME_WIDTH = 480, 640


def load_with_changes(path, changes):
    """The repo config at `path` (relative to this script), read with the
    port's YAML reader, with dotted-key `changes` set."""
    from deblur_e_nerf_tpu_torch.utils.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    config = load_config(os.path.join(here, path))
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = config
        for part in parents:
            node = node[part]
        node[leaf] = value
    return config


def eds_config(dataset_directory, test=False, checkpoint=None):
    """configs/train/07_ziggy_and_fuzz_hdr.yaml with phase 7's cuts
    (EDS_REDUCED); with `test`, configs/test/07_ziggy_and_fuzz_hdr.yaml
    with its dataset directory and seed cut the same way and `checkpoint`
    as model.checkpoint_filepath."""
    changes = ({"seed": 0, "model.checkpoint_filepath": checkpoint} if test
               else dict(EDS_REDUCED))
    changes["data.dataset_directory"] = dataset_directory
    return load_with_changes(EDS_TEST_CONFIG if test else EDS_TRAIN_CONFIG,
                             changes)


def make_eds_dataset(root, height, width, num_poses, write_views=True):
    """A synthetic ESIM-layout dataset whose calibration carries a
    plumb_bob distortion (the EDS calibrations are distorted), so the
    events go through the undistortion."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import synthetic

    synthetic.make_dataset(root, img_height=height, img_width=width,
                           num_poses=num_poses, write_views=write_views)
    path = f"{root}/camera_calibration.npz"
    calib = dict(np.load(path))
    calib["distortion_model"] = np.array("plumb_bob")
    calib["distortion_params"] = np.array(EDS_DISTORTION)
    np.savez(path, **calib)
    return root


def eds_small_config(root):
    """The EDS config at the reference checks' small size: 6 HashGrid
    levels (dense and vertex-hash ones) of <= 2^12 rows, float32 gathers,
    16-wide MLPs, a 32^3 grid; sphere, cone 0.004 and the trainable
    filter as written."""
    config = eds_config(root)
    pe = config.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    config.model.nerf.ngp.mlp_base.n_neurons = 16
    config.model.nerf.ngp.mlp_head.n_neurons = 16
    config.model.nerf.occ_grid.resolution = 32
    return config


def eds_step_card_vs_cpu(torch, tmp, device="cuda"):
    """One EDS step (sphere, cone 0.004, HashGrid float32, the trainable
    filter, S = 30, a distorted calibration) of a small model on the card
    (`device`) and on the CPU (see `step_card_vs_cpu`)."""
    root = make_eds_dataset(f"{tmp}/small_eds", 16, 16, 21,
                            write_views=False)
    return step_card_vs_cpu(torch, eds_small_config(root), "EDS step",
                            device)


def _state_tensors(trainer):
    """{name: tensor} of everything a resume restores."""
    opt = trainer.optimizer
    out = {f"param {n}": p.detach() for n, p in
           trainer.params.named_parameters()}
    for n, p in opt.named_params():
        out[f"m {n}"], out[f"v {n}"] = opt.state[p]
        if p in opt.acc:
            out[f"acc {n}"] = opt.acc[p]
    if trainer.ema_params is not None:
        out.update({f"ema {n}": p for n, p in
                    trainer.ema_params.named_parameters()})
    out.update(count=opt.count, mini_step=opt.mini_step,
               occs=trainer.occ_state.occs, binary=trainer.occ_state.binary)
    return out


def _saved_tensors(torch, trainer, path):
    """The same names as `_state_tensors`, read from the checkpoint file
    on the card."""
    saved = torch.load(path, map_location=trainer.device, weights_only=True)
    out = {}
    for comp, state in saved["params"].items():
        out.update({f"param {comp}.{k}": v for k, v in state.items()})
    for key in ("m", "v", "acc"):
        out.update({f"{key} {n}": v for n, v in
                    saved["opt_state"][key].items()})
    for comp, state in saved.get("ema_params", {}).items():
        out.update({f"ema {comp}.{k}": v for k, v in state.items()})
    out.update(count=saved["opt_state"]["count"],
               mini_step=saved["opt_state"]["mini_step"],
               occs=saved["occ_state"]["occs"],
               binary=saved["occ_state"]["binary"])
    names = set(_state_tensors(trainer))
    return {k: v for k, v in out.items() if k in names}, saved


def train_eds_epoch(torch, trainer, card):
    """Epoch 0 of the EDS trainer through Trainer.train (16 micro-steps, 2
    optimizer steps, a checkpoint at its end), each micro-step timed and
    checked: its kernel launches, whether it ran the occupancy update and
    whether the parameters changed. Returns the per-micro-step records,
    the occupancy updates' (global step, ms) and the checkpoint save's
    seconds."""
    params = list(trainer.params.parameters())
    records, occ_calls, saves = [], [], []
    step_fn, occ_fn, save_fn = (trainer.train_step, trainer.update_occupancy,
                                trainer.save_checkpoint)

    def timed_occ(step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = occ_fn(step)
        torch.cuda.synchronize()
        occ_calls.append((trainer.global_step,
                          (time.perf_counter() - t0) * 1e3))
        return out

    def timed_step():
        before = [p.detach().clone() for p in params]
        counts = read_launches()
        n_occ = len(occ_calls)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step_fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        records.append({
            "step": trainer.global_step - 1, "ms": ms,
            "launches": {k: after[k] - counts[k] for k in after},
            "occupancy": len(occ_calls) > n_occ,
            "changed": any(not torch.equal(b, p.detach())
                           for b, p in zip(before, params)),
            "ema_differs": not torch.equal(
                trainer.ema_params.nerf.field.table,
                trainer.params.nerf.field.table),
            "loss": float(metrics["loss"]),
            "skipped": bool(metrics["update_skipped"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "samples_per_ray": float(metrics["mean_num_samples_per_ray"]),
            "truncated": float(metrics["ray_truncation_rate"]),
            "valid": float(metrics["mean_valid_rate"]),
        })
        r = records[-1]
        print(f"EDS micro-step {r['step']}: loss {r['loss']:.6f}, samples/"
              f"ray {r['samples_per_ray']:.2f}, truncated rays "
              f"{r['truncated']:.4f}, valid {r['valid']:.3f}, occupancy "
              f"update {r['occupancy']}, parameters changed {r['changed']}, "
              f"{ms:.3f} ms, peak {r['peak_gib']:.2f} GiB, launches "
              f"{r['launches']} on {card}", flush=True)
        return metrics

    def timed_save(epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_fn(epoch)
        saves.append(time.perf_counter() - t0)
        return path

    trainer.train_step, trainer.update_occupancy = timed_step, timed_occ
    trainer.save_checkpoint = timed_save
    try:
        trainer.train(max_steps=int(EDS_REDUCED["trainer.limit_train_batches"]))
    finally:
        del trainer.train_step, trainer.update_occupancy
        del trainer.save_checkpoint
    return records, occ_calls, saves


def check_eds_epoch(records, occ_calls, n_levels, accumulate, resolution):
    """Phase 7's checks of epoch 0's micro-steps."""
    # the warmup update's field calls, of 2^19 cells each
    chunks = -(-(resolution ** 3) // (1 << 19))
    for r in records:
        occ = r["occupancy"]
        want = n_levels * (1 + (chunks if occ else 0))
        got = r["launches"]
        if not (got["scatter_add_rows"] == n_levels
                and got["gather_rows"] == got["corner_sum"] == want):
            raise AssertionError(f"EDS micro-step {r['step']}: launches "
                                 f"{got}, want K1 {n_levels} and K3 and the "
                                 f"corner sum {want} each")
        if occ != (r["step"] % accumulate == 0):
            raise AssertionError(f"EDS micro-step {r['step']}: occupancy "
                                 f"update {occ}")
        if r["changed"] != (r["step"] % accumulate == accumulate - 1):
            raise AssertionError(f"EDS micro-step {r['step']}: parameters "
                                 f"changed {r['changed']}")
        if r["skipped"] or not math.isfinite(r["loss"]):
            raise AssertionError(f"EDS micro-step {r['step']}: loss "
                                 f"{r['loss']}, skipped {r['skipped']}")
        if r["step"] >= accumulate - 1 and not r["ema_differs"]:
            raise AssertionError(f"EDS micro-step {r['step']}: the EMA "
                                 f"equals the parameters")
    if [g for g, _ in occ_calls] != [0, accumulate]:
        raise AssertionError(f"EDS occupancy updates at {occ_calls}")


def check_eds_trainer(torch, trainer):
    """The EDS trainer is the configured one: HashGrid levels 0-4 dense and
    5-15 vertex-hash, float32 gathers, accumulation 8, the six filter
    parameters trainable, the default sample budget."""
    field = trainer.params.nerf.field
    pb = dict(trainer.params.pixel_bandwidth.named_parameters())
    if not ([m for _, _, _, m in field.levels] == ["dense"] * 5 + ["hash"] * 11
            and trainer.accumulate == 8 and len(pb) == 6
            and all(p.requires_grad for p in pb.values())
            and trainer.params.nerf.render_config.sample_budget
            == MAIN_PATH_SAMPLE_BUDGET
            and field.compute_dtype in (None, torch.float32)):
        raise AssertionError("the EDS trainer is not the one configured")


def profile_eds_step(torch, trainer):
    """Device time by kernel of one steady EDS micro-step (off the
    occupancy schedule, mid-window), with its wall time."""
    from torch.profiler import ProfilerActivity, profile

    trainer.global_step = int(trainer.params.nerf.occ_grid_config
                              .warmup_steps) + 2
    trainer.train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step()
        torch.cuda.synchronize()
    busy, ours = _device_table(prof, "EDS micro-step", 1)
    print(f"profile EDS micro-step: wall {wall:.3f} ms without the "
          f"profiler, kernels busy {busy:.3f} ms ({100 * busy / wall:.1f}%); "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items())
          + f"; {_per_call(prof)}", flush=True)


def phase_eds(torch, tmp, card, profile=False):
    """Phase 7: the real-data (EDS) path at full width. Returns
    {path: launches} for its training, resumed training, evaluation and
    640x480 frame. With `profile`, one steady micro-step's device time
    by kernel too."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import posed_images
    from deblur_e_nerf_tpu_torch.training import evaluation
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    root = make_eds_dataset(f"{tmp}/eds", 64, 64, 61)
    print(f"EDS dataset (distortion {EDS_DISTORTION}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("reduced: " + json.dumps(EDS_REDUCED), flush=True)
    config = eds_config(root)
    log_dir = f"{tmp}/log_eds"
    launches = {}

    t0 = time.perf_counter()
    trainer = Trainer(config, log_dir, device="cuda")
    field = trainer.params.nerf.field
    n_levels = len(field.levels)
    accumulate = trainer.accumulate
    pb = dict(trainer.params.pixel_bandwidth.named_parameters())
    print(f"EDS trainer built in {time.perf_counter() - t0:.2f} s: levels "
          f"{[(r, m) for r, _, _, m in field.levels]}, table "
          f"{tuple(field.table.shape)} {field.table.dtype}, gathers "
          f"{field.compute_dtype}, contraction "
          f"{trainer.params.nerf.render_config.contraction_type.value}, cone "
          f"{trainer.params.nerf.render_config.cone_angle}, step "
          f"{trainer.params.nerf.render_config.render_step_size:.6f}, grid "
          f"{trainer.params.nerf.render_config.grid_resolution}^3, sample "
          f"budget {trainer.params.nerf.render_config.sample_budget}, "
          f"accumulate {accumulate}, trainable filter parameters "
          f"{sorted(n for n, p in pb.items() if p.requires_grad)}",
          flush=True)
    check_eds_trainer(torch, trainer)
    torch.cuda.synchronize()
    reset_launches()
    t_epoch = time.perf_counter()
    records, occ_calls, saves = train_eds_epoch(torch, trainer, card)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t_epoch
    launches["eds train"] = read_launches()
    check_eds_epoch(records, occ_calls, n_levels, accumulate,
                    trainer.params.nerf.render_config.grid_resolution)
    ckpt0 = f"{log_dir}/checkpoints/epoch_0000"
    size_mib = os.path.getsize(ckpt0) / 2**20
    steady = sorted(r["ms"] for r in records
                    if not r["occupancy"] and not r["changed"])
    window = records[accumulate:2 * accumulate]
    peak = max(r["peak_gib"] for r in records)
    print(f"EDS epoch 0: {len(records)} micro-steps, "
          f"{int(trainer.optimizer.count)} optimizer steps in {epoch_s:.3f} "
          f"s; launches {launches['eds train']}", flush=True)
    print(f"EDS first micro-step: {records[0]['ms']:.3f} ms (with the "
          f"warmup occupancy update)", flush=True)
    print(f"EDS steady micro-step: {steady[len(steady) // 2]:.3f} ms median "
          f"(min {steady[0]:.3f}, max {steady[-1]:.3f}, of {len(steady)})",
          flush=True)
    print(f"EDS optimizer step ({accumulate} micro-steps, "
          f"{window[0]['step']}-{window[-1]['step']}, with its occupancy "
          f"update): {sum(r['ms'] for r in window):.3f} ms", flush=True)
    res = config.model.nerf.occ_grid.resolution
    print(f"EDS warmup occupancy updates at {res}^3: "
          f"{[round(ms, 3) for _, ms in occ_calls]} ms", flush=True)
    print(f"EDS checkpoint: {size_mib:.2f} MiB, saved in {saves[0]:.3f} s",
          flush=True)
    print(f"EDS peak device memory: {peak:.2f} GiB on {card}", flush=True)
    trainer._flush_pending_metrics()
    count_step_syncs(torch, trainer, "EDS",
                     ("training/optim.py", "training/trainer.py",
                      "training/step.py"))
    if profile:
        profile_eds_step(torch, trainer)
    del trainer
    torch.cuda.empty_cache()

    # a fresh trainer resumes epoch_0000 in the same log directory
    resumed = Trainer(config, log_dir, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = resumed.resume(ckpt0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want, _ = _saved_tensors(torch, resumed, ckpt0)
    got = _state_tensors(resumed)
    differ = [k for k in got if k not in want
              or got[k].dtype != want[k].dtype
              or not torch.equal(got[k], want[k])]
    print(f"EDS resume: epoch {epoch}, global step {resumed.global_step}, "
          f"restored in {restore_s:.3f} s; {len(got)} tensors, "
          f"{len(differ)} differing from the checkpoint", flush=True)
    if differ or epoch != 0 or resumed.global_step != len(records) \
            or set(want) != set(got):
        raise AssertionError(f"EDS resume is not bit for bit: {differ[:8]}")
    if resumed.eval_params() is not resumed.ema_params:
        raise AssertionError("EDS: evaluation does not read the EMA")
    torch.cuda.synchronize()
    reset_launches()
    resumed.train()
    torch.cuda.synchronize()
    launches["eds resume"] = read_launches()
    loss = resumed.last_metrics["loss"]
    kept = sorted(f for f in os.listdir(f"{log_dir}/checkpoints")
                  if f.startswith("epoch_"))
    print(f"EDS resumed epoch 1: global step {resumed.global_step}, loss "
          f"{loss:.6f}, checkpoints kept {kept}; launches "
          f"{launches['eds resume']}", flush=True)
    if not (math.isfinite(loss) and kept == ["epoch_0001"]
            and resumed.global_step == 2 * len(records)):
        raise AssertionError("EDS resumed epoch failed")
    del resumed
    torch.cuda.empty_cache()

    # evaluate the kept checkpoint with the test config's flags
    ckpt1 = f"{log_dir}/checkpoints/epoch_0001"
    test_config = eds_config(root, test=True, checkpoint=ckpt1)
    test_config.metric.lpips_weights_path = write_lpips_stub(
        torch, f"{tmp}/lpips_alex.pt")
    evaluator = Trainer(test_config, f"{tmp}/log_eds_test", device="cuda")
    saved = torch.load(ckpt1, map_location=evaluator.device,
                       weights_only=True)
    differ = [f"{comp}.{k}" for comp, state in saved["params"].items()
              for k, v in state.items()
              if not torch.equal(getattr(evaluator.params, comp)
                                 .state_dict()[k], v)]
    differ += [k for k in ("occs", "binary") if not torch.equal(
        getattr(evaluator.occ_state, k), saved["occ_state"][k])]
    if differ:
        raise AssertionError(f"EDS eval: restored state differs: {differ}")
    del saved
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metric = evaluator.evaluate("test")
    torch.cuda.synchronize()
    launches["eds eval"] = read_launches()
    print(f"EDS eval test (event_view, from {os.path.basename(ckpt1)}, "
          f"EMA {'yes' if evaluator.ema_params is not None else 'none'}): "
          f"{json.dumps(metric)} in {time.perf_counter() - t0:.3f} s; "
          f"launches {launches['eds eval']}", flush=True)
    if not all(math.isfinite(metric[k]) for k in ("l1", "psnr", "ssim",
                                                  "lpips")):
        raise AssertionError(f"EDS eval: a metric is not finite: {metric}")

    H, W = EDS_FRAME_HEIGHT, EDS_FRAME_WIDTH
    focal = 0.8 * W
    intrinsics = np.array([[focal, 0, W / 2 - 0.5], [0, focal, H / 2 - 0.5],
                           [0, 0, 1]])
    view = posed_images.PosedImageDataset(root, "val").posed_imgs
    args = (torch.as_tensor(np.linalg.inv(intrinsics), dtype=torch.float32),
            _pixel_grid(torch, H, W),
            torch.as_tensor(view["T_wc_position"][0]),
            torch.as_tensor(view["T_wc_orientation"][0]))
    render = evaluation.make_render_image_fn(evaluator.eval_params().nerf)
    render(evaluator.occ_state, *args)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        img = render(evaluator.occ_state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches["eds frame"] = read_launches()
    frame_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    stats = render.stats
    ms = sum(times) / len(times)
    print(f"EDS eval frame {W}x{H}: {ms:.3f} ms per image (runs "
          f"{[round(t, 3) for t in times]}), {H * W / ms * 1e3:.1f} rays/s, "
          f"{stats['ray_chunks']} ray chunks, live marched samples "
          f"{stats['live_samples']} ({stats['live_samples'] / (H * W):.2f} "
          f"per ray), field calls {stats['field_chunks']} "
          f"({stats['field_chunks'] / stats['ray_chunks']:.2f} per ray "
          f"chunk), truncated rays {stats['truncated_rays']}, peak device "
          f"memory {frame_peak:.3f} GiB above the evaluator's "
          f"{base / 2**30:.3f} GiB; launches {launches['eds frame']} on "
          f"{card}", flush=True)
    want = n_levels * stats["field_chunks"]
    frame = launches["eds frame"]
    if not (frame["gather_rows"] == frame["corner_sum"] == want > 0
            and frame["scatter_add_rows"] == 0):
        raise AssertionError(f"EDS frame launches {frame}, want {want}")
    if img.shape != (H, W) or not bool(torch.isfinite(img).all()) \
            or stats["truncated_rays"]:
        raise AssertionError(f"EDS frame: shape {tuple(img.shape)}, "
                             f"truncated {stats['truncated_rays']}")
    del evaluator, render
    torch.cuda.empty_cache()
    eds_step_card_vs_cpu(torch, tmp)
    for path, counts in launches.items():
        for name in ("gather_rows", "corner_sum") + (
                ("scatter_add_rows",) if "eval" not in path
                and "frame" not in path else ()):
            if counts[name] <= 0:
                raise AssertionError(f"{path}: {name} never launched")
    return launches


# phase 8: configs/train/quality_sphere_blur32_dense_r5fix.yaml, read with
# the port's own YAML reader
R5FIX_CONFIG = "configs/train/quality_sphere_blur32_dense_r5fix.yaml"
# the dataset recipe the config's header names (scripts/quality_run.py
# --pixel-filter full --bandwidth-scale 32, C = 0.05, 3 orbits): 192x192,
# 1501 poses and frames; the phase generates fewer poses (R5FIX_DATASET)
R5FIX_RECIPE = {"img_height": 192, "img_width": 192, "num_poses": 1501}
R5FIX_DATASET = {"img_height": 192, "img_width": 192, "num_poses": 301}
# phase 8's cuts of the train config, printed on its `reduced` line with
# the dataset's
R5FIX_REDUCED = {
    "data.dataset_directory": "a synthetic blur dataset of the config's "
                              "recipe, fewer poses (dataset below)",
    "trainer.limit_train_batches": 4,
    "trainer.max_epochs": 1,
    "seed": 0,
    "metric.lpips_weights_path": "seeded stub LPIPS weights",
}
# the config's own run trained with batch capacity 1024
# (scripts/round5_experiments.sh), R = 1024 x 30 x 4 = 122,880 rays
R5FIX_BATCH_CAPACITY = 1024
R5FIX_FIELD_CHUNK = 1 << 18
# phase 9's cuts of the quality harness's run of the r5fix config, printed
# on its `reduced` line; every other argument is the config recipe's
QUALITY_REDUCED = {
    "data_root": "phase 8's dataset (its poses cut as R5FIX_DATASET says)",
    "max_epochs": 2,
    "steps_per_epoch": 20,
    "max_eval_images": 1,
}


def r5fix_config(dataset_directory, lpips_weights_path=None):
    """configs/train/quality_sphere_blur32_dense_r5fix.yaml with phase 8's
    cuts (R5FIX_REDUCED)."""
    return load_with_changes(R5FIX_CONFIG, dict(
        R5FIX_REDUCED, **{"data.dataset_directory": dataset_directory,
                          "metric.lpips_weights_path": lpips_weights_path}))


def make_r5fix_dataset(torch, root):
    """The config's dataset recipe (the full pixel filter at bandwidth
    scale 32, C = 0.05, 3 orbits, views written) at R5FIX_DATASET's size,
    the filter's float32 chain on the card; its events then packed by the
    native packer (the numpy packer is made to raise). Prints the seconds
    of each, the event count and the size on disk."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import events as events_data
    from deblur_e_nerf_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    synthetic.make_dataset(
        root, **R5FIX_DATASET, pixel_filter="full", bandwidth_scale=32,
        contrast_threshold=0.05, orbits=3, write_views=True,
        filter_device="cuda")
    gen_s = time.perf_counter() - t0
    n_raw = len(np.load(f"{root}/raw_events.npz")["timestamp"])
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)

    def numpy_packer(*args, **kwargs):
        raise AssertionError("the numpy event packer ran")

    saved = (events_data.pack_events,
             events_data.extract_max_refractory_period)
    events_data.pack_events = numpy_packer
    events_data.extract_max_refractory_period = numpy_packer
    try:
        t0 = time.perf_counter()
        n_packed = len(events_data.EventDataset(root))
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        max_rp = float(events_data.load_max_refractory_period(root))
        rp_s = time.perf_counter() - t0
    finally:
        (events_data.pack_events,
         events_data.extract_max_refractory_period) = saved
    print(f"r5fix dataset {R5FIX_DATASET} (recipe {R5FIX_RECIPE}; full "
          f"pixel filter on the card): generated in {gen_s:.3f} s, "
          f"{n_raw} raw events, {size / 2**20:.2f} MiB; native packer: "
          f"{n_packed} intervals in {pack_s:.3f} s, max refractory period "
          f"{max_rp:.0f} ns in {rp_s:.3f} s", flush=True)
    if n_packed <= 0:
        raise AssertionError("r5fix dataset: no events")
    return {"generate_s": gen_s, "raw_events": n_raw, "pack_s": pack_s}


def r5fix_step_launches(trainer, occupancy_update, prepass=True):
    """The kernel launches one r5fix step implies: each field call runs
    one gather and one corner sum per hash level, each field backward one
    scatter-add per level. A step with the prepass calls the field in the
    prepass's density pass (over K + 1 slots), the full field (over the
    prepass's K / 2 + 1 slots) and the sparsity prior; one without it
    (`prepass` False) the full field over K + 1 slots and the prior; each
    in field_chunk pieces when set; the backward runs through the full
    field and the prior; a warmup occupancy update adds one density call
    per 2^19 cells."""
    model = trainer.params.nerf
    rc = model.render_config
    n_levels = len(model.field.levels)

    def calls(n):
        return -(-n // rc.field_chunk) if rc.field_chunk else 1

    if prepass:
        field_calls = calls(rc.prepass_budget + 1)
        gathers = calls(rc.sample_budget + 1) + field_calls + 1
    else:
        field_calls = calls(rc.sample_budget + 1)
        gathers = field_calls + 1
    if occupancy_update:
        gathers += -(-(rc.grid_resolution ** 3) // (1 << 19))
    return {"scatter_add_rows": n_levels * (field_calls + 1),
            "gather_rows": n_levels * gathers,
            "corner_sum": n_levels * gathers}


def timed_r5fix_step(torch, trainer, card, step_fn, records,
                     label="r5fix"):
    """One trainer step (`step_fn`), timed and checked: its kernel launches
    against `r5fix_step_launches` for the path it took (`prepass_ran`), a
    finite loss, and no overflow of the prepass buffer on a step that ran
    the prepass; prints its live samples (live demand =
    prepass_overflow_rate x K / 2) beside the marched ones. Appends a
    record to `records`; returns the step's metrics."""
    rc = trainer.params.nerf.render_config
    occ_cfg = trainer.params.nerf.occ_grid_config
    step = trainer.global_step
    occupancy_update = step % trainer.accumulate == 0 and (
        step // trainer.accumulate < int(occ_cfg.warmup_steps)
        or (step // trainer.accumulate) % int(occ_cfg.n) == 0)
    counts = read_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step_fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = read_launches()
    marched = int(m["num_marched_samples"])
    live = round(float(m["prepass_overflow_rate"]) * rc.prepass_budget)
    r = {"step": step, "ms": ms,
         "launches": {k: after[k] - counts[k] for k in after},
         "loss": float(m["loss"]), "marched": marched, "live": live,
         "overflow": float(m["prepass_overflow_rate"]),
         "prepass": bool(float(m["prepass_ran"])),
         "valid": float(m["mean_valid_rate"]),
         "truncated": float(m["ray_truncation_rate"]),
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    records.append(r)
    print(f"{label} step {r['step']}: loss {r['loss']:.6f}, {ms:.3f} ms, "
          f"prepass {'on' if r['prepass'] else 'off'}, marched samples "
          f"{marched}, live {live} (ratio {live / max(marched, 1):.4f}), "
          f"prepass_overflow_rate {r['overflow']:.4f}, truncated rays "
          f"{r['truncated']:.4f}, valid events {r['valid']:.3f}, peak "
          f"{r['peak_gib']:.2f} GiB, launches {r['launches']} on {card}",
          flush=True)
    want = r5fix_step_launches(trainer, occupancy_update, r["prepass"])
    if r["launches"] != want:
        raise AssertionError(f"{label} step {r['step']}: launches "
                             f"{r['launches']}, want {want}")
    if not math.isfinite(r["loss"]):
        raise AssertionError(f"{label} step {r['step']}: loss {r['loss']}")
    if r["prepass"] and r["overflow"] > 1.0:
        raise AssertionError(f"{label} step {r['step']}: the prepass "
                             f"dropped live samples (prepass_overflow_rate "
                             f"{r['overflow']})")
    return m


def train_r5fix_epoch(torch, trainer, card):
    """Epoch 0 through Trainer.train, each step checked by
    `timed_r5fix_step`."""
    records = []
    step_fn = trainer.train_step
    trainer.train_step = lambda: timed_r5fix_step(torch, trainer, card,
                                                  step_fn, records)
    try:
        trainer.train(max_steps=int(
            R5FIX_REDUCED["trainer.limit_train_batches"]))
    finally:
        del trainer.train_step
    return records


def r5fix_prepass_switch(torch, trainer, card):
    """The density raised (the output bias + 10, so that rays terminate
    early) until the trainer's reads of the live demand turn the prepass
    on: steps through Trainer.train_step, each checked by
    `timed_r5fix_step`, until one runs the prepass (within
    PREPASS_WINDOW + 3 steps); the bias is restored after. Returns the
    steps' records."""
    from deblur_e_nerf_tpu_torch.training.trainer import PREPASS_WINDOW

    max_steps = PREPASS_WINDOW + 3
    bias = trainer.params.nerf.field.mlp_base.output.bias
    records = []
    with torch.no_grad():
        bias[0] += 10.0
    try:
        for _ in range(max_steps):
            timed_r5fix_step(torch, trainer, card, trainer.train_step,
                             records, label="r5fix dense")
            if records[-1]["prepass"]:
                break
    finally:
        trainer._flush_pending_metrics()
        with torch.no_grad():
            bias[0] -= 10.0
    if not records[-1]["prepass"]:
        raise AssertionError("r5fix: the trainer never turned the prepass "
                             f"on: {records}")
    return records


def _random_rays(torch, trainer, n, seed):
    """`n` rays from the trajectory's camera positions towards points of
    the central [-0.5, 0.5]^3, with stratified-march jitter."""
    device = trainer.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cams = trainer.bundle.consts["trajectory"].T_wc_position
    o = cams[torch.randint(0, cams.shape[0], (n,), generator=gen,
                           device=device)]
    target = torch.rand((n, 3), generator=gen, device=device) - 0.5
    d = torch.nn.functional.normalize(target - o, dim=-1)
    jitter = torch.rand(n, generator=gen, device=device)
    w = torch.randn((n, 2), generator=gen, device=device)
    return o, d, torch.ones(n, dtype=torch.bool, device=device), jitter, w


def r5fix_prepass_exactness(torch, trainer, card):
    """The stepped trainer's field with its density raised (the output
    bias + 5, so that rays terminate) renders one marched sample set of
    the step's R rays and K slots twice: with the prepass (div 2) and
    without.

    Through nerf_model.render (the training path): outputs within rtol
    1e-5 and atol 1e-6, the live demand below the marched one (the full
    field runs on fewer samples), both times printed. Gradient exactness
    is held with the field's outputs in float64 (the same renderer, prepass
    and composite code, without that rounding): every field gradient
    within 2e-4 of its largest entry. The training path's float32
    gradients (the optical depth's backward in float64, ROADMAP Queue C
    7), with the prepass and without, are each within 1e-3 of their
    largest entry of the float64 render's, and of each other."""
    import dataclasses

    from deblur_e_nerf_tpu_torch.models import nerf_model, renderer
    from deblur_e_nerf_tpu_torch.training import step as step_lib

    model = trainer.params.nerf
    rc = model.render_config
    field = model.field
    sc = trainer.bundle.static_config
    R = step_lib.n_rendered_rays(sc, trainer.batch_capacity)
    o, d, mask, jitter, w = _random_rays(torch, trainer, R, seed=7)
    bias = field.mlp_base.output.bias
    field_params = dict(field.named_parameters())

    def as_double(fn):
        return lambda *args: tuple(t.double() for t in fn(*args))

    def render(div, precision):
        model.render_config = dataclasses.replace(rc, prepass_div=div)
        if precision == "float32":
            return nerf_model.render(model, trainer.occ_state, o, d, mask,
                                     jitter)
        return renderer.render_rays(
            renderer.SplitField(field.encode, as_double(field.decode)),
            trainer.occ_state.binary, o, d, mask, jitter,
            model.render_config,
            render_bkgd=nerf_model.render_bkgd_value(model),
            density_only_fn=lambda x: field.density(x).double())

    results = {}
    with torch.no_grad():
        bias[0] += 5.0
    try:
        for precision in ("float32", "float64"):
            for div in (rc.prepass_div, 0):
                field.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = render(div, precision)
                loss = ((out["radiance"][:, 0] * w[:, 0]).sum()
                        + (out["opacity"] * w[:, 1]).sum())
                loss.backward()
                torch.cuda.synchronize()
                results[precision, div] = (
                    {k: out[k].detach() for k in ("radiance", "opacity",
                                                    "depth")},
                    {n: p.grad.detach().clone()
                     for n, p in field_params.items()},
                    (time.perf_counter() - t0) * 1e3,
                    int(out["num_marched_samples"]),
                    float(out["prepass_overflow_rate"]))
    finally:
        model.render_config = rc
        field.zero_grad(set_to_none=True)
        with torch.no_grad():
            bias[0] -= 5.0
    out_p, grad_p, ms_p, marched, overflow = results["float32",
                                                     rc.prepass_div]
    out_f, grad_f, ms_f, _, _ = results["float32", 0]
    live = round(overflow * rc.prepass_budget)
    print(f"r5fix prepass exactness: {R} rays, marched samples {marched} "
          f"(K + 1 = {rc.sample_budget + 1}), live after the prepass {live} "
          f"(prepass_overflow_rate {overflow:.4f}); render + backward "
          f"{ms_p:.3f} ms with the prepass (field on "
          f"{rc.prepass_budget + 1} slots), {ms_f:.3f} ms without (field "
          f"on {rc.sample_budget + 1}) on {card}", flush=True)
    if not (live < marched and overflow < 1.0):
        raise AssertionError("r5fix prepass: nothing culled, or the "
                             "prepass buffer overflowed")
    for k in out_f:
        err = float(((out_p[k] - out_f[k]).abs()
                     - 1e-5 * out_f[k].abs()).max())
        print(f"r5fix prepass vs full {k}: max(|diff| - 1e-5 |full|) "
              f"{err:.3e} (tolerance 1e-6)", flush=True)
        if not (bool(torch.isfinite(out_p[k]).all()) and err <= 1e-6):
            raise AssertionError(f"r5fix prepass: {k} differs")
    grad_p64, grad_f64 = (results["float64", rc.prepass_div][1],
                          results["float64", 0][1])
    worst = {}
    for n, g in grad_f64.items():
        scale = float(g.abs().max())
        err = float((grad_p64[n] - g).abs().max())

        def rel(a, b):
            return float((a[n] - b[n]).abs().max()) / scale

        f32 = {"prepass vs full": rel(grad_p, grad_f),
               "prepass vs float64": rel(grad_p, grad_p64),
               "full vs float64": rel(grad_f, grad_f64)}
        worst[n] = max(f32.values())
        print(f"r5fix prepass vs full grad {n}: float64 outputs "
              f"{err / scale:.3e} of the largest entry (tolerance 2e-4); "
              f"float32 training path {f32['prepass vs full']:.3e} "
              f"(against float64: with the prepass "
              f"{f32['prepass vs float64']:.3e}, without "
              f"{f32['full vs float64']:.3e}; tolerance 1e-3)", flush=True)
        if not (math.isfinite(scale) and scale > 0 and err <= 2e-4 * scale):
            raise AssertionError(f"r5fix prepass: grad {n} differs")
        if not all(e <= 1e-3 for e in f32.values()):
            raise AssertionError(f"r5fix prepass: the float32 training "
                                 f"path's grad {n} is off: {f32}")
    return ms_p, ms_f, worst


def r5fix_chunked_step(torch, trainer, card):
    """One step's loss and gradients (step_lib.compute_loss, then
    backward; no update) on the same batch and draws with the training
    render's field_chunk at R5FIX_FIELD_CHUNK and without. Loss within
    1e-6 relative, every gradient within 2e-4 of its largest entry; the
    gather and the corner sum launch in the forward only (each chunk's
    encode output is kept), with the counts `r5fix_step_launches`
    implies. Prints each one's peak device memory."""
    import dataclasses

    from deblur_e_nerf_tpu_torch.models import nerf_model
    from deblur_e_nerf_tpu_torch.training import step as step_lib

    params = trainer.params
    model = params.nerf
    rc = model.render_config
    sc = trainer.bundle.static_config
    batch = trainer._to_device(trainer.batcher.next_batch(
        trainer.batch_controller.active))
    draws = step_lib.draw_step(sc, trainer.batch_capacity,
                               trainer.occ_state, trainer.generator,
                               trainer.device)
    level_mask = nerf_model.level_mask_for_step(model, trainer.global_step,
                                                trainer.device)
    results = {}
    try:
        for chunk in (R5FIX_FIELD_CHUNK, 0):
            model.render_config = dataclasses.replace(rc, field_chunk=chunk)
            want = r5fix_step_launches(trainer, occupancy_update=False)
            params.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            loss, _ = step_lib.compute_loss(
                params, trainer.bundle.consts, trainer.occ_state, batch,
                draws, sc, trainer.bundle.loss_config, level_mask)
            forward = read_launches()
            reset_launches()
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            backward = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            results[chunk] = (float(loss.detach()), {
                n: p.grad.detach().clone()
                for n, p in params.named_parameters()
                if p.grad is not None})
            print(f"r5fix step, field_chunk {chunk}: loss "
                  f"{results[chunk][0]:.9f}, {ms:.3f} ms (forward and "
                  f"backward), "
                  f"peak device memory {peak:.2f} GiB, launches forward "
                  f"{forward}, backward {backward} on {card}", flush=True)
            if not (forward["gather_rows"] == forward["corner_sum"]
                    == want["gather_rows"]
                    and forward["scatter_add_rows"] == 0
                    and backward["gather_rows"] == backward["corner_sum"]
                    == 0 and backward["scatter_add_rows"]
                    == want["scatter_add_rows"]):
                raise AssertionError(f"r5fix field_chunk {chunk}: launches "
                                     f"{forward}, {backward}, want {want}")
    finally:
        model.render_config = rc
        params.zero_grad(set_to_none=True)
    (loss_c, grads_c), (loss_f, grads_f) = (results[R5FIX_FIELD_CHUNK],
                                            results[0])
    err = abs(loss_c - loss_f) / abs(loss_f)
    print(f"r5fix chunked vs whole-buffer step: loss relative error "
          f"{err:.3e} (tolerance 1e-6)", flush=True)
    if not (math.isfinite(loss_f) and err <= 1e-6
            and set(grads_c) == set(grads_f)):
        raise AssertionError("r5fix chunked step: the loss differs")
    for n, g in grads_f.items():
        gerr = float((grads_c[n] - g).abs().max())
        tol = 2e-4 * float(g.abs().max())
        if not gerr <= tol:
            raise AssertionError(f"r5fix chunked step: grad {n} differs "
                                 f"({gerr} > {tol})")
    print(f"r5fix chunked vs whole-buffer step: {len(grads_f)} gradients "
          f"within 2e-4 of their largest entry", flush=True)


def r5fix_eval(torch, tmp, trainer, root, card):
    """Trainer.evaluate("val") with the eval prepass (every metric
    finite), then one frame at the dataset's size through
    make_render_image_fn, timed and profiled (launches: 16 per density
    and per field call), then the card's eval render with the prepass
    against the CPU's. Returns {path: launches}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deblur_e_nerf_tpu_torch.data import posed_images
    from deblur_e_nerf_tpu_torch.training import evaluation

    launches = {}
    n_levels = len(trainer.params.nerf.field.levels)
    eval_div = trainer.config.model.nerf.eval_occlusion_prepass_div
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metric = trainer.evaluate("val")
    torch.cuda.synchronize()
    launches["r5fix eval"] = read_launches()
    print(f"r5fix eval val (eval prepass div {eval_div}, EMA "
          f"{trainer.ema_params is not None}): {json.dumps(metric)} in "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{launches['r5fix eval']}", flush=True)
    if not all(math.isfinite(metric[k]) for k in ("l1", "psnr", "ssim",
                                                  "lpips")):
        raise AssertionError(f"r5fix eval: a metric is not finite: "
                             f"{metric}")
    view = posed_images.PosedImageDataset(root, "val").posed_imgs
    H, W = view["img"].shape[-2:]
    args = (torch.as_tensor(np.linalg.inv(view["intrinsics"]),
                            dtype=torch.float32),
            _pixel_grid(torch, H, W),
            torch.as_tensor(view["T_wc_position"][0]),
            torch.as_tensor(view["T_wc_orientation"][0]))
    render = evaluation.make_render_image_fn(
        trainer.eval_params().nerf, eval_prepass_div=eval_div)
    render(trainer.occ_state, *args)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        img = render(trainer.occ_state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches["r5fix frame"] = frame = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    stats = render.stats
    ms = sum(times) / len(times)
    print(f"r5fix eval frame {W}x{H} (prepass div {eval_div}): {ms:.3f} ms "
          f"per image (runs {[round(t, 3) for t in times]}), "
          f"{H * W / ms * 1e3:.1f} rays/s, marched samples "
          f"{stats['marched_samples'] / (H * W):.2f} a ray, live "
          f"{stats['live_samples'] / (H * W):.2f} a ray, "
          f"{stats['ray_chunks']} ray chunks, density calls "
          f"{stats['density_chunks']}, field calls {stats['field_chunks']}, "
          f"truncated rays {stats['truncated_rays']}, peak device memory "
          f"{peak:.3f} GiB above the trainer's {base / 2**30:.3f} GiB; "
          f"launches {frame} on {card}", flush=True)
    want = n_levels * (stats["density_chunks"] + stats["field_chunks"])
    if not (frame["gather_rows"] == frame["corner_sum"] == want > 0
            and frame["scatter_add_rows"] == 0):
        raise AssertionError(f"r5fix frame launches {frame}, want {want}")
    if img.shape != (H, W) or not bool(torch.isfinite(img).all()) \
            or stats["truncated_rays"]:
        raise AssertionError(f"r5fix frame: shape {tuple(img.shape)}, "
                             f"truncated {stats['truncated_rays']}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(trainer.occ_state, *args)
        torch.cuda.synchronize()
    busy, ours = _device_table(prof, "r5fix eval frame", 1)
    print("profile r5fix eval frame: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ours.items())
        + f"; device busy {100 * busy / ms:.1f}% of the unprofiled "
        f"frame's wall", flush=True)
    eval_render_card_vs_cpu(torch, tmp, prepass_div=eval_div)
    return launches


def r5fix_vanilla_steps(torch, root, tmp, card):
    """Two steps of the same config with model.nerf.arch mlp at the
    config's `mlp:` widths (8 x 256, skip 4, condition 1 x 128): finite
    losses; prints each step's time and peak memory."""
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    config = r5fix_config(root)
    config.model.nerf.arch = "mlp"
    trainer = Trainer(config, f"{tmp}/log_r5fix_mlp",
                      batch_capacity=R5FIX_BATCH_CAPACITY, device="cuda")
    mlp = config.model.nerf.mlp
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.train_step()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"r5fix vanilla field ({mlp.net_depth} x {mlp.net_width}, "
              f"skip {mlp.skip_layer}, condition {mlp.net_depth_condition} "
              f"x {mlp.net_width_condition}) step {i}: loss {loss:.6f}, "
              f"{ms:.3f} ms, marched samples "
              f"{int(m['num_marched_samples'])}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
              f"{card}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"r5fix vanilla step {i}: loss {loss}")
    del trainer
    torch.cuda.empty_cache()


def phase_r5fix(torch, tmp, card):
    """Phase 8: the repaired round-5 pair's path at full width. Returns
    {path: launches}."""
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    root = f"{tmp}/r5fix"
    data = make_r5fix_dataset(torch, root)
    print("reduced: " + json.dumps(dict(
        R5FIX_REDUCED, batch_capacity=R5FIX_BATCH_CAPACITY,
        dataset=dict(R5FIX_DATASET, recipe=R5FIX_RECIPE,
                     raw_events=data["raw_events"]))), flush=True)
    config = r5fix_config(root, write_lpips_stub(torch,
                                                 f"{tmp}/lpips_alex.pt"))
    t0 = time.perf_counter()
    trainer = Trainer(config, f"{tmp}/log_r5fix",
                      batch_capacity=R5FIX_BATCH_CAPACITY, device="cuda")
    model = trainer.params.nerf
    rc = model.render_config
    print(f"r5fix trainer built in {time.perf_counter() - t0:.2f} s: levels "
          f"{[(r, m) for r, _, _, m in model.field.levels]}, gathers "
          f"{model.field.compute_dtype}, grid {rc.grid_resolution}^3, S "
          f"{trainer.bundle.static_config.it_sample_size}, sample budget "
          f"{rc.sample_budget}, prepass div {rc.prepass_div} (buffer "
          f"{rc.prepass_budget}), block budget {rc.block_budget}, "
          f"superblock budget {rc.superblock_budget}, EMA "
          f"{trainer.ema_decay}", flush=True)
    if not ([m for _, _, _, m in model.field.levels]
            == ["dense"] * 5 + ["hash"] * 11
            and rc.sample_budget == 8192 * 30 * 4 * 5 // 4
            and rc.prepass_budget == rc.sample_budget // 2
            and rc.superblock_budget == 0 and rc.field_chunk == 0):
        raise AssertionError("the r5fix trainer is not the one configured")
    launches = {}
    torch.cuda.synchronize()
    reset_launches()
    records = train_r5fix_epoch(torch, trainer, card)
    launches["r5fix train"] = read_launches()
    steady = sorted(r["ms"] for r in records[1:])
    print(f"r5fix steady step (with its warmup occupancy update): "
          f"{steady[len(steady) // 2]:.3f} ms median (min {steady[0]:.3f}, "
          f"max {steady[-1]:.3f}); first step {records[0]['ms']:.3f} ms; "
          f"peak {max(r['peak_gib'] for r in records):.2f} GiB; prepass "
          f"on {sum(r['prepass'] for r in records)} of {len(records)} "
          f"steps", flush=True)
    trainer._flush_pending_metrics()
    count_step_syncs(torch, trainer, "r5fix",
                     forbidden=("training/", "models/renderer.py"),
                     expected=r5fix_step_launches(trainer, False,
                                                  trainer.prepass_on))
    trainer._flush_pending_metrics()
    r5fix_prepass_exactness(torch, trainer, card)
    r5fix_chunked_step(torch, trainer, card)
    launches.update(r5fix_eval(torch, tmp, trainer, root, card))
    # last, as its steps train a dense field
    switch = r5fix_prepass_switch(torch, trainer, card)
    print(f"r5fix prepass switch: on at the {len(switch)}th step with the "
          f"density raised, {switch[-1]['ms']:.3f} ms with it against "
          f"{switch[0]['ms']:.3f} ms without", flush=True)
    del trainer
    torch.cuda.empty_cache()
    r5fix_vanilla_steps(torch, root, tmp, card)
    for path, counts in launches.items():
        for name in ("gather_rows", "corner_sum") + (
                ("scatter_add_rows",) if path == "r5fix train" else ()):
            if counts[name] <= 0:
                raise AssertionError(f"{path}: {name} never launched")
    return launches


def quality_argv(root, log, max_epochs, device="cuda"):
    """The quality harness's arguments for phase 9: the r5fix config and
    its dataset recipe (scripts/quality_run.py's flags the config's header
    names) with batch capacity 1024, `max_epochs` epochs, cut as
    QUALITY_REDUCED says."""
    return ["--config", R5FIX_CONFIG, "--data-root", root, "--log-dir", log,
            "--img-size", str(R5FIX_RECIPE["img_height"]),
            "--contrast-threshold", "0.05", "--orbits", "3",
            "--pixel-filter", "full", "--bandwidth-scale", "32",
            "--batch-capacity", str(R5FIX_BATCH_CAPACITY),
            "--max-epochs", str(max_epochs),
            "--steps-per-epoch", str(QUALITY_REDUCED["steps_per_epoch"]),
            "--max-eval-images", str(QUALITY_REDUCED["max_eval_images"]),
            "--device", device]


def check_quality_outputs(log, rows, steps_per_epoch, n_epochs):
    """psnr_vs_steps.csv: the JAX harness's columns and one row for each of
    `n_epochs` (steps increasing, finite PSNR and SSIM, one flat-field
    PSNR);
    metrics.yaml (read without PyYAML): `rows`, in the JAX harness's
    order and keys. Returns the CSV rows."""
    import csv

    from deblur_e_nerf_tpu_torch.utils import config as config_lib

    with open(os.path.join(log, "psnr_vs_steps.csv")) as f:
        table = list(csv.reader(f))
    epochs = [[float(x) for x in r] for r in table[1:]]
    if not (table[0] == ["step", "psnr", "ssim", "flat_psnr"]
            and [int(r[0]) for r in epochs]
            == [steps_per_epoch * (i + 1) for i in range(len(epochs))]
            and len(epochs) == n_epochs
            and all(math.isfinite(x) for r in epochs for x in r)
            and len({r[3] for r in epochs}) == 1):
        raise AssertionError(f"quality: psnr_vs_steps.csv is {table}")
    with open(os.path.join(log, "metrics.yaml")) as f:
        written = config_lib.yaml_load(f.read())
    metrics = {"l1", "lpips", "psnr", "ssim"}
    stages = [r.get("stage") for r in written]
    if not (len(written) == len(rows)
            and [set(r) for r in written] == [set(r) for r in rows]
            and stages[:4] == ["val", "test", None, None]
            and set(written[0]) == set(written[1]) == metrics | {"stage"}
            and written[2] == {"flat_field_psnr": epochs[0][3]}
            and set(written[3]) == {"pixel_bandwidth_learned",
                                    "pixel_bandwidth_init"}
            and stages[4:] in ([], ["val_best", "test_best"])
            and all(math.isfinite(written[i][k]) for i in (0, 1)
                    for k in ("l1", "psnr", "ssim"))):
        raise AssertionError(f"quality: metrics.yaml is {written}")
    return epochs


def phase_quality(torch, tmp, card, device="cuda"):
    """Phase 9: the quality harness on the r5fix config at full width, on
    phase 8's dataset: an invocation of one epoch less than
    QUALITY_REDUCED's (and its final rows), then a fresh one resuming its
    last checkpoint for the last epoch and the final rows. Every step through
    `timed_r5fix_step` (launches for the path taken, no overflow of a
    prepass that ran). Returns {path: launches}."""
    from deblur_e_nerf_tpu_torch import quality_run
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    root, log = f"{tmp}/r5fix", f"{tmp}/log_quality"
    steps = QUALITY_REDUCED["steps_per_epoch"]
    print("reduced: " + json.dumps(dict(
        QUALITY_REDUCED, batch_capacity=R5FIX_BATCH_CAPACITY)), flush=True)
    n_epochs = QUALITY_REDUCED["max_epochs"]
    records = []
    train_step = Trainer.train_step
    Trainer.train_step = lambda self: timed_r5fix_step(
        torch, self, card, lambda: train_step(self), records,
        label="quality")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        quality_run.main(quality_argv(root, log, n_epochs - 1, device))
        t1 = time.perf_counter()
        rows = quality_run.main(quality_argv(root, log, n_epochs, device) + [
            "--resume", f"{log}/checkpoints/epoch_{n_epochs - 2:04d}"])
    finally:
        Trainer.train_step = train_step
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"quality": read_launches()}
    epochs = check_quality_outputs(log, rows, steps, n_epochs)
    if [r["step"] for r in records] != list(range(n_epochs * steps)):
        raise AssertionError(f"quality: steps {[r['step'] for r in records]}")
    steady = sorted(r["ms"] for r in records[1:steps] + records[steps + 1:])
    print(f"quality harness: epoch 0 invocation {t1 - t0:.2f} s, resumed "
          f"invocation (epoch 1 and the final rows) {t2 - t1:.2f} s; steady "
          f"step {steady[len(steady) // 2]:.3f} ms median (min "
          f"{steady[0]:.3f}, max {steady[-1]:.3f}); prepass on "
          f"{sum(r['prepass'] for r in records)} of {len(records)} steps, "
          f"max overflow {max(r['overflow'] for r in records):.4f}; PSNR "
          f"{[round(r[1], 4) for r in epochs]} against the flat field's "
          f"{epochs[0][3]:.4f}; launches {launches['quality']} on {card}",
          flush=True)
    for name, count in launches["quality"].items():
        if count <= 0:
            raise AssertionError(f"quality: {name} never launched")
    return launches


def kernel_line(name, source, replaces, rows, launches, main_shape):
    main = next(r for r in rows if r["shape"] == main_shape
                and r.get("index_structure", "uniform") == "uniform")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["filter on"][name],
        "launches_by_path": {p: c[name] for p, c in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "timed_shape": main_shape, "shapes": rows,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the flagship steps, then print the "
                             "device time by kernel over 3 more filter-on "
                             "steps past the warmup, and over one steady "
                             "EDS micro-step")
    args = parser.parse_args()
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import deblur_e_nerf_tpu_torch  # noqa: F401  (fails outside the repo)

    with phase("1 environment"):
        card = phase_environment(torch)
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain"):
        rows = phase_kernels(torch)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("4 training"):
            launches, trainer, root = phase_training(torch, tmp,
                                                     profile=args.profile)
        with phase("5 reference"):
            phase_reference(torch, tmp)
        with phase("6 eval"):
            launches.update(phase_eval(torch, tmp, trainer, root))
        del trainer
        torch.cuda.empty_cache()
        with phase("7 real-data (EDS) path"):
            launches.update(phase_eds(torch, tmp, card,
                                      profile=args.profile))
        torch.cuda.empty_cache()
        with phase("8 r5fix path (prepass, chunked render, vanilla field)"):
            launches.update(phase_r5fix(torch, tmp, card))
        torch.cuda.empty_cache()
        with phase("9 quality harness (r5fix config, resumed)"):
            launches.update(phase_quality(torch, tmp, card))

    kernels = [
        dict(kernel_line("scatter_add_rows", SCATTER_SOURCE,
                         SCATTER_REPLACES, rows["scatter_add_rows"],
                         launches, "main path: cellhash levels 7-15"),
             call_split=rows["scatter_add_rows_call_split"]),
        kernel_line("gather_rows", GATHER_SOURCE, GATHER_REPLACES,
                    rows["gather_rows"], launches,
                    "main path: cellhash view, levels 7-15"),
        kernel_line("corner_sum", CORNER_SUM_SOURCE, CORNER_SUM_REPLACES,
                    rows["corner_sum"], launches, "main path: every level"),
    ]
    for name in ("gather_rows", "corner_sum"):
        if launches["eval"][name] <= 0 or launches["eval frame"][name] <= 0:
            raise AssertionError(f"eval: {name} never launched")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
