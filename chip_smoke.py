#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deblur_e_nerf_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile] [--parent DIR]

Phases, each printing a start and an end line with elapsed seconds:
  1. environment: torch/CUDA versions, device, nvidia-smi name and power
     limit, nvcc, triton;
  2. build: the CUDA kernels, with nvcc from the sources in this checkout,
     and the atomics the compiler emitted for each scatter-add instance
     (cuobjdump -sass): the main path's widths must use vector reductions;
     for each gather instance of the main path, its registers and spills
     (-Xptxas -v) and its SASS load and store forms: its stores must be
     16-byte vectors; each fused-encode instance's registers, spills and
     stack frame, and the backward's atomic forms (vector and bulk
     reductions); the weight-chain kernels' registers and local memory,
     read from the loaded binary (local memory, a stack frame or spills,
     fails), and that they run float32 FMAs and no tensor-core
     instruction; the render kernels' registers and spills (the
     compaction's three, the composite's two in float and double, the
     march's four) and the occupancy update's (its ten: points, the EMA's
     tile and scatter passes, the threshold's finish, histogram, digit
     and mask passes, the sampler's count, scan and search);
  3. kernels: each kernel against its plain PyTorch version on the card
     (the Pallas probes K2/K3's shapes too), with times of the kernel, the
     plain version and the PyTorch library calls computing the same
     function: first the L2's rate of each reduction form the encode
     backward could issue (RED.F32x2, RED.F32x4, four F32x4 to a 64-byte
     row, one 64-byte bulk reduction) into a buffer of the flagship
     table's 50 MB; the fused encode (hash_encode_fwd, hash_encode_bwd)
     at the flagship step's N = K + 1 and an eval field call's N = 2^20,
     on the flagship layout (HybridHashGrid, bf16 rows) and the EDS/r5fix
     one (HashGrid, float32 rows), on uniform positions and ray-ordered
     samples with the step's empty-slot tail (and, after phase 7, "3b",
     on the step's own inputs: the positions and cotangent that phase 4's
     steady flagship step and phase 7's steady EDS micro-step fed the
     encode): the forward bit for bit against the plain model of its
     order and within the order bound of the plain version, one bf16
     table copy for all its calls on the bf16 layout, the backward within
     (k - 1) eps sum|x| (+ k FLT_MIN: the card's float32 reductions flush
     subnormals) of each row of a float64 plain version, with the
     reductions it issues by level mode (`backward_reductions`), with
     index_select + bmm (forward) and index_add_ (backward) of one level
     timed as context; with --parent DIR, the encode kernels of that
     checkout (the parent commit) on the same inputs, timed in turns
     (parent, change, change, parent) and held to the same checks; K1 and
     K3,
     which the encode launched per level before it was fused, at the
     shapes of that encode: the scatter-add also against the plain model
     of its summation order, on uniform indices and on the training
     step's index structures (the empty-slot tail, ray-ordered runs), and
     its wrapper's host time per call beside its profiled kernel time;
     the gather bit for bit in both output types (float32 rows, bf16
     rows), on uniform indices and ray-ordered runs, the vertex-hash
     level's in sample-major and corner-major order, beside index_select
     and advanced indexing (tbl[idx64]), each with its bound by output
     type; the pixel-bandwidth weight chain (pb_weight_fwd, pb_weight_bwd)
     at the flagship step's shape (S = 30, M = 4 x 429) on the default
     and the stiff calibration with 0, 5 and all 29 steps at the 100 ns
     floor (and, in "3b", on the parameters, intensities, steps and
     weight cotangent the steady flagship step and EDS micro-step fed
     it, and on these with a seeded normal cotangent in every column):
     the columns with a non-zero cotangent, the weights and the
     cotangents of intensity, dt and the packed parameters against
     autograd of the plain chain in float64, column by column
     (`pb_accuracy_check`: each column no farther from it than 1.25
     times the float32 plain chain's same column plus
     PB_STEP_FORWARD_ATOL of the largest weight forward and one
     tolerance backward; NaN where the float32 plain chain has it; on
     PB_CASES also within PB_STEP_FORWARD_ATOL and the CPU tests'
     tolerances of the float32 plain chain, elsewhere that comparison
     printed as a reading), two
     runs bit for bit, the kernels' times beside their
     bound (the backward's over the live columns, and over every
     column), each (with --parent) in turns with the parent's kernels,
     the plain chain's forward and forward + backward, weight() as the
     step runs it (in turns with the parent's chain with --parent) and
     torch.linalg.matrix_exp of the same matrices (the expm part alone)
     and its backward; then, at M = 32,768 on synthetic steps where the
     float32 chain is ill-conditioned (`PB_CONDITIONING_CASES`), the same
     rule, forward and backward; after "3b", each of these checks'
     largest reading over its limit (`pb_accuracy_summary`); and the
     library baselines of the encode's and K1/K3's rows
     (`perf_microbench.LIBRARY_CASES`: index_add_ in float32, by rows of
     2-32 and in bfloat16, sort + cumsum + searchsorted, index_select, at
     the JAX script's N = 2^24 and T = 2^19), each within its check; the
     render layer's scans: the stream compaction (compact, three kernels
     a call) at the flagship's sample and block stages and the r5fix
     prepass's three-channel put, each below and above its budget, every
     buffer, the total and the cutoff bit for bit against the plain
     version, with torch.masked_select timed beside it; the composite
     forward, its density-only call (the prepass's live mask) and its
     backward on a dense buffer of the flagship step's size with early
     stop, clamped samples and truncated rays, alpha_thre 0 and 0.05,
     against the plain version (forward within COMPOSITE_FWD_*, live
     counts and masks equal, backward within COMPOSITE_BWD_* of
     autograd), two runs bit for bit; the march's four kernels (masks,
     coarse stages, sample stage, decode) on the flagship's, EDS's and
     r5fix's render configs at full width on synthetic scenes, at the
     configs' budgets and cut below the demands (`march_cases`): each
     kernel call on its plain version's inputs, every output bit for bit
     (under a cone angle t_mid and dt within 2 ulp, with the differing
     elements counted), two runs bit for bit, march_rays against
     march_reference field for field, each kernel's ms a march beside
     its plain version's and its bound, max_pool3d beside the masks, the
     whole march in turns with the parent's (with --parent) and beside
     the plain march; the occupancy update's four kernels (occ_points,
     occ_ema, occ_threshold, occ_sample_occupied) on the flagship's
     (128^3, aabb), EDS's (256^3, sphere, cone angle 0.004) and r5fix's
     (64^3, thre_floor, max_occupied_fraction 0.125) grids at full size
     with a synthetic density (`occ_cases`: two warmup updates from an
     empty grid, a sampled update, a sampled update on an empty mask (the
     sampler's fallback), a warmup and a sampled update with NaN planted
     in the density): each kernel call on its plain version's inputs,
     points, steps, EMA and sampler bit for bit, the EMA's float64
     partials against their model, the threshold within OCC_MEAN_RTOL
     with the cells between the two thresholds counted, the quantile bit
     for bit against torch.quantile, two runs bit for bit, the whole
     update against the plain update, each kernel's ms an update beside
     its plain version's, its bound and the library call
     (scatter_reduce(amax), torch.quantile and torch.kthvalue,
     searchsorted over a cumsum); and, in "3b", all of them on the steps'
     own inputs (`capture_render_inputs`: each march stage's compaction
     at its budget and at half its flagged lanes, the composite's buffer
     and cotangents, the march's rays, mask, jitter and grid of phase 4's
     and phase 7's steady steps; `capture_occupancy`: the trainers' own
     grids and fields, a warmup and a sampled update each, with the whole
     update's wall and kernel ms, the field's share printed apart, its
     peak memory, in turns with the parent's update with --parent);
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
          whose host syncs are counted by source line (there may be none;
          one sync planted just before the step must be counted) and
          whose kernel launches must be one fused encode forward and one
          backward, one weight-chain forward and one backward (no K1, no
          K3), a compaction a march stage, the march's kernels (three
          masks launches, two coarse stages, one sample stage, one
          decode), one composite forward and one backward; then the
          operator calls by layer (op_census) of one more steady step
          (the weight chain's its wrapper's alone, the march's at most
          MARCH_MAX_OPS) and of a sampled and a warmup occupancy update
          (outside the field an allocation a kernel call at most, the
          occupancy kernels' launches `occupancy_launches`), and the host
          syncs of each update (there may be none);
  5. reference: on small inputs, the card (through the kernels) against
     the plain version on the CPU: the NGP field's outputs and table
     gradient, and one filter-on step's loss and gradients;
  6. eval, on phase 4's flagship trainer: Trainer.evaluate("val") on the
     synthetic dataset's views (written by the port's image writer) with
     seeded stub LPIPS weights (every metric finite), its kernel launches
     counted; one 346x260 frame (6 chunks of 16,384 rays) through
     make_render_image_fn, timed (ms per image, rays/s, live marched
     samples, field calls per ray chunk, peak device memory) and
     profiled, whose encode forwards must be one per field call; and the
     eval render of a small model on the
     card against the CPU (equal marched samples per pixel, the image
     within 1e-5);
  7. the real-data (EDS) path: configs/train/07_ziggy_and_fuzz_hdr.yaml
     at full width (HashGrid 16 levels, float32 gathers, 256^3 grid,
     sphere contraction, cone angle 0.004, the trainable filter at S = 30,
     accumulation 8), cut only as EDS_REDUCED says, on a 64x64 synthetic
     dataset with a distorted calibration: one epoch of 16 micro-steps
     through Trainer.train (each micro-step's launches, occupancy update
     and parameter change checked; a checkpoint at its end), the host
     syncs of one steady micro-step (none at all), a fresh trainer
     resuming the checkpoint bit for bit and training epoch 1 (pruning
     keeps one checkpoint), a third
     built from configs/test/07_ziggy_and_fuzz_hdr.yaml's values that
     evaluates the kept checkpoint, one 640x480 frame timed (one encode
     forward per field call), and a small EDS
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
     syncs of one steady step (none at all); the
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
     the flat-field PSNR and every row of metrics.yaml;
 10. data parallelism: the flagship at full width on phase 4's dataset
     (sample budget 1.5 K, so that no step truncates a ray) through
     `python -m deblur_e_nerf_tpu_torch train ... --mesh 2 --dist-backend
     gloo` (both ranks on this card; NCCL takes one card per rank): 3
     steps with the trainer's replica check (each rank's digest of its
     parameters, optimizer moments and occupancy grid, equal across
     ranks at every step), rank 0 evaluating 1 view and checkpointing
     every step; each rank's loss, active size, prepass_ran, launches,
     step time, peak memory and gradient all-reduce bytes and time
     printed (a step hook, MeshStepProbe); the ray generation of the
     step's shapes bit-equal over the ranks' shares; a single-process
     trainer over the same global batches takes each step from the
     mesh's own checkpoint of the step before: the active sizes, each
     rank's launches, the loss, every gradient and every parameter; a
     second invocation resuming the last checkpoint under the mesh for
     one step, against a single process resuming the same file (the
     digest bit for bit, then the same checks); `--mesh 2` without
     --dist-backend must raise on one card (NCCL), and runs one rank per
     card where there are 2;
 11. EDS conversion (host): a raw EDS sequence written at run time (a
     Kalibr camera chain as YAML text with `- [..]` rows, rotating poses,
     times.txt, 3 PNG images of 640x480, the committed events fixture
     tests/fixtures/eds_events.h5) converted by `python -m
     deblur_e_nerf_tpu_torch.data.eds_to_esim` on the card and in this
     process on the CPU: the poses within 1e-5 of each other, every other
     output equal, the events the fixture's within the pose window, the
     output read by the port's loaders.

Every path's launches are read with the counts set to 0 just before it
and must include the compaction, the march's four kernels and the
composite forward, and the composite backward and the occupancy update's
points, EMA and threshold kernels exactly on the paths that train (the
sampler where a sampled update ran); where a step's or a frame's counts
are known (`render_launches`: a compaction a march stage and a prepass,
the march's kernels a march, a composite forward a render and a prepass;
`occupancy_launches`: a points and an EMA launch a chunk of an update, a
threshold an update, the sampler a sampled update, a points launch a
sparsity prior) they must be those.

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
from contextlib import contextmanager, nullcontext

BUDGET_S = 15 * 60
SCATTER_SOURCE = "deblur_e_nerf_tpu_torch/csrc/scatter_rows.cu"
SCATTER_REPLACES = "deblur_e_nerf_tpu/ops/pallas_scatter.py:46"
GATHER_SOURCE = "deblur_e_nerf_tpu_torch/csrc/gather_rows.cu"
GATHER_REPLACES = "scripts/perf_microbench.py:190"
# no Pallas kernel: the JAX package's custom-VJP encode, which XLA compiles
# (`_encode_impl` and `_encode_frozen_pos_bwd`)
HASH_ENCODE_SOURCE = "deblur_e_nerf_tpu_torch/csrc/hash_encode.cu"
HASH_ENCODE_FWD_REPLACES = "deblur_e_nerf_tpu/models/hash_encoding.py:332"
HASH_ENCODE_BWD_REPLACES = "deblur_e_nerf_tpu/models/hash_encoding.py:420"
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
    check_encode_build(_cuda_build.sass_instructions(
        info["path"], ("RED", "ATOM", "UBLK")), ptxas)
    pb_build = check_pb_weight_build(_cuda_build.sass_instructions(
        info["path"], ("FFMA", "HMMA")), ptxas)
    check_render_build(ptxas)
    return dict(info, pb_build=pb_build)


def check_pb_weight_build(sass, ptxas):
    """Print the weight-chain kernels' registers and local memory, as the
    loaded binary states them (`pb_weight.kernel_attributes`), with the
    ptxas line where the build log holds it; fail unless both were built,
    both run float32 fused multiply-adds and no tensor-core instruction,
    and neither keeps local memory (a stack frame or spills, where the
    backward once kept its squarings' inputs). Returns {kernel:
    {registers, local_bytes}}."""
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    attrs = pb_weight.kernel_attributes()
    found = {}
    for kernel in ("pb_weight_fwd_kernel", "pb_weight_bwd_kernel"):
        fns = [fn for fn in sass if kernel in fn]
        if len(fns) != 1:
            raise AssertionError(f"{kernel}: {len(fns)} instances")
        ops = sass[fns[0]]
        info = ptxas.get(fns[0], "not in the log (build reused)")
        registers, local_bytes = attrs[kernel]
        found[kernel] = {"registers": registers, "local_bytes": local_bytes}
        print(f"{kernel}: {registers} registers, {local_bytes} bytes of "
              f"local memory a thread; ptxas [{info}], SASS FFMA "
              f"{ops.count('FFMA')}, HMMA "
              f"{sum(op.startswith('HMMA') for op in ops)}", flush=True)
        if "FFMA" not in ops or any(op.startswith("HMMA") for op in ops):
            raise AssertionError(f"{kernel}: not float32 FMAs alone")
        if local_bytes > 0:
            raise AssertionError(f"{kernel}: {local_bytes} bytes of local "
                                 f"memory a thread (a stack frame or "
                                 f"spills)")
    return found


def check_encode_build(atomics, ptxas):
    """Print each fused-encode instance's registers, spills and stack
    frame (-Xptxas -v) and the backward's atomic SASS instructions; fail
    unless both directions were built, the backward's atomics are vector
    reductions (a RED naming a 2- or 4-float vector, no returning ATOM)
    and it issues bulk reductions (UBLKRED, the cellhash rows')."""
    for kernel in ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel"):
        fns = [fn for fn in atomics if kernel in fn]
        if not fns:
            raise AssertionError(f"{kernel}: no such instance")
        for fn in fns:
            print(f"{kernel} ({fn}): ptxas "
                  f"[{ptxas.get(fn, 'not in the log (build reused)')}]",
                  flush=True)
    ops = [op for fn, o in atomics.items() if "hash_encode_bwd_kernel" in fn
           for op in o]
    vector = sorted({op for op in ops if op.startswith("RED")
                     and re.search(r"(x2|x4|V2|V4|\.64|\.128)", op)})
    print(f"sass hash_encode_bwd: atomics {sorted(set(ops))}, vector "
          f"reductions {vector}", flush=True)
    for fn, o in atomics.items():
        if "l2_reduction_kernel" in fn:
            print(f"sass {fn}: {sorted(set(o))}", flush=True)
    if not vector or any(op.startswith("ATOM") for op in ops) \
            or not any(op.startswith("UBLKRED") for op in ops):
        raise AssertionError(f"hash_encode_bwd: no vector RED or no bulk "
                             f"reduction in the SASS ({sorted(set(ops))})")


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
    """The (8 n_samples,) corner rows of the flagship's vertex-hash level 6
    (the rows the per-level gather read before the fused encode) for
    samples in ray-ordered runs: K1's runs of equal indices (k1_inputs)
    over the level's cells, each sample at a uniform position in its cell,
    through the encode's own row function, sample-major or corner-major."""
    from deblur_e_nerf_tpu_torch.models import hash_encoding
    from deblur_e_nerf_tpu_torch.ops import hash_encode

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
    idx, _ = hash_encode.level_rows_weights(u, res, size, 0, "hash",
                                            torch.float32)
    if corner_major:
        idx = idx.T
    return idx.reshape(-1).to(torch.int32)


def _bits(torch, t):
    """t's bits as integers of its width (a bit-for-bit comparison)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


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


def encode_layout(torch, config):
    """(levels, table rows, compute dtype) of a config's grid encode."""
    from deblur_e_nerf_tpu_torch.models import hash_encoding

    pe = config.model.nerf.ngp.pos_encoding
    levels, total = hash_encoding.grid_layout(
        pe.otype, pe.n_levels, pe.base_resolution, pe.per_level_scale,
        pe.get("log2_hashmap_size", 19),
        float(pe.get("cellhash_min_load") or 8.0))
    dtype = pe.get("compute_dtype") or "float32"
    return levels, total, None if dtype == "float32" else getattr(torch,
                                                                   dtype)


# phase 3's encode cases: (name, config) of the layouts whose step and eval
# shapes it runs, the flagship's (configs/train/synthetic.yaml) and
# EDS_TRAIN_CONFIG's (the r5fix config has the same encode)
ENCODE_CASES = (("flagship (HybridHashGrid, bf16 rows)",
                 lambda: flagship_config("unused")),
                ("EDS/r5fix (HashGrid, float32 rows)",
                 lambda: load_with_changes(EDS_TRAIN_CONFIG, {})))
RAY_SAMPLES = 128  # samples a ray in the ray-ordered encode inputs


def encode_positions(torch, kind, n, gen, device="cuda"):
    """(n, 3) positions on `device` and the (n,) live slots: "uniform" in
    [-0.02, 1.02]^3, every slot live; "rays": ray-ordered samples,
    RAY_SAMPLES a ray at step sqrt(3)/1024 from uniform origins in uniform
    directions (clipped to the cube by the encode), the last 40% of the
    slots empty as in a warmup step (zero cotangents, all at the last live
    sample's position)."""
    if kind == "uniform":
        u = torch.rand((n, 3), generator=gen, device=device) * 1.04 - 0.02
        return u, torch.ones(n, dtype=torch.bool, device=device)
    if kind != "rays":
        raise ValueError(f"unknown encode input {kind!r}")
    n_live = int(round(0.6 * n))
    n_rays = -(-n_live // RAY_SAMPLES)
    o = torch.rand((n_rays, 1, 3), generator=gen, device=device)
    d = torch.nn.functional.normalize(
        torch.randn((n_rays, 1, 3), generator=gen, device=device), dim=-1)
    t = torch.arange(RAY_SAMPLES, device=device)[None, :, None] \
        * (3 ** 0.5 / 1024)
    u = torch.empty((n, 3), device=device)
    u[:n_live] = (o + t * d).reshape(-1, 3)[:n_live]
    u[n_live:] = u[n_live - 1]
    live = torch.arange(n, device=device) < n_live
    return u, live


def check_encode_backward(torch, grad, g, u, levels):
    """The encode backward's table gradient `grad` against the float64 sum
    of the same float32 contributions (w * g in float32, as the kernel
    forms them): returns (max abs error, whether every row is within
    (k - 1) eps sum|x| + k FLT_MIN of it, the largest k, the vector
    atomics the contributions ask for after the zero skip and before
    combining), k a row's count of non-zero contributions. The first term
    bounds any order of k float32 additions; the second the card's float32
    reductions (RED .add.f32), which flush a subnormal addend or sum to
    zero, losing less than FLT_MIN (2^-126) each: the step's own
    cotangents reach subnormal products."""
    from deblur_e_nerf_tpu_torch.ops import hash_encode

    total = grad.shape[0]
    exact = hash_encode.encode_backward_reference(
        g, u, levels, total, sum_dtype=torch.float64)
    abs_sum = hash_encode.encode_backward_reference(
        g.abs(), u, levels, total, sum_dtype=torch.float64)
    uc = torch.clamp(u, 0.0, 1.0)
    k = torch.zeros(total, dtype=torch.int64, device=g.device)
    atomics = 0
    for li, level in enumerate(levels):
        g_level = g[:, 2 * li:2 * li + 2]
        rows, w = hash_encode.level_rows_weights(uc, *level, torch.float32)
        nz = (w[..., None] * g_level[:, None] != 0).any(-1)
        k += torch.bincount(rows[nz], minlength=total)
        atomics += int((g_level != 0).any(-1).sum()) * (
            4 if level[3] == "cellhash" else 8)
        del rows, w, nz
    err = (grad.double() - exact).abs()
    f32 = torch.finfo(torch.float32)
    within = bool((err <= (k - 1).clamp(min=0)[:, None] * f32.eps * abs_sum
                   + k[:, None] * f32.tiny).all())
    return float(err.max()), within, int(k.max()), atomics


def load_parent(torch, parent_dir):
    """Another checkout of the port (the parent commit), to time the change
    against it in turns on the same inputs: that checkout's package
    imported under the name `parent_port`, whose `ops.hash_encode` builds
    its own kernels from its own sources. Returns {"encode": its
    (encode_forward, encode_backward), "renderer", "compact" and
    "composite": its models.renderer, ops.compact and ops.composite (the
    render layer's scans), "pb": its models.pixel_bandwidth (whose
    intensity_sample_to_weight is the weight chain as the parent's step
    ran it), "pb_ops": its ops.pb_weight (the weight chain's
    kernels), "occupancy" and "contraction": its models.occupancy (the
    occupancy update) and models.contraction, "package": the name it is
    imported under}."""
    import importlib
    import importlib.util

    package = os.path.join(parent_dir, "deblur_e_nerf_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(package, "__init__.py"),
        submodule_search_locations=[package])
    sys.modules["parent_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["parent_port"])
    encode = importlib.import_module("parent_port.ops.hash_encode")
    t0 = time.perf_counter()
    encode._library()
    print(f"parent kernels ({parent_dir}) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"package": "parent_port",
            "encode": (encode.encode_forward, encode.encode_backward),
            "renderer": importlib.import_module(
                "parent_port.models.renderer"),
            "compact": importlib.import_module("parent_port.ops.compact"),
            "composite": importlib.import_module(
                "parent_port.ops.composite"),
            "pb": importlib.import_module(
                "parent_port.models.pixel_bandwidth"),
            "pb_ops": importlib.import_module("parent_port.ops.pb_weight"),
            "occupancy": importlib.import_module(
                "parent_port.models.occupancy"),
            "contraction": importlib.import_module(
                "parent_port.models.contraction")}


def in_turns(fn, parent_fn, iters=20, timer=None, parent_timer=None):
    """(ms of fn, [its two runs], ms of parent_fn or None, [its runs]):
    timed parent, change, change, parent (each run a mean over `iters`
    calls, by `timer` and `parent_timer`, time_ms unless given), so that
    both see the same drift of clocks and power."""
    timer = timer or time_ms
    parent_timer = parent_timer or time_ms
    if parent_fn is None:
        ms = timer(fn, iters)
        return ms, [ms], None, []
    runs = [parent_timer(parent_fn, iters), timer(fn, iters),
            timer(fn, iters), parent_timer(parent_fn, iters)]
    ours, theirs = runs[1:3], [runs[0], runs[3]]
    return sum(ours) / 2, ours, sum(theirs) / 2, theirs


def graph_ms(fn, iters=20):
    """Mean device milliseconds per call of fn, replayed from a CUDA graph
    (captured once after a warm-up call) between CUDA events: the kernels'
    time without the host's per-call work (argument checks, allocation,
    the launch), which at a small size exceeds a kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def encode_inputs(torch, kind, n, n_levels, seed=0):
    """(u, g) of a synthetic encode case: `encode_positions` and a normal
    cotangent, zero in the empty slots."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    u, live = encode_positions(torch, kind, n, gen)
    g = torch.randn((n, 2 * n_levels), generator=gen, device="cuda") \
        * live[:, None]
    return u, g


def _reductions_text(counts):
    return ", ".join(f"{m} " + " ".join(f"{k} {v}" for k, v in c.items()
                                        if v)
                     for m, c in counts.items())


def encode_case(torch, name, layout, u, g, kind, parent=None, seed=0):
    """The fused encode's two kernels at one layout on the positions u and
    cotangent g of input `kind`, against their plain versions; returns
    (forward row, backward row).

    Forward: bit for bit against `encode_forward_model` (the plain model
    of its order), and within 2 x 7 eps sum|w x| of the plain version
    (any order of the 8 rounded products is within 7 eps of the exact
    sum, and each side is); on bf16 layouts one bf16 copy of the table
    for every call (`hash_encode.BF16_COPIES`), its time beside. Backward:
    every row within (k - 1) eps sum|x| + k FLT_MIN of the float64 sum of
    the same float32 contributions, k the row's count of non-zero
    contributions (any order of k float32 additions, each of which may
    flush a subnormal to zero); the reductions it issues
    (`hash_encode.backward_reductions`) by level mode. With `parent`
    (`load_parent`), the parent's kernels on the same inputs, timed
    in turns with these, and its forward bit for bit with this one. No
    single PyTorch call computes a multi-level encode (library_ms null);
    one level's index_select + bmm (forward) and index_add_ (backward)
    are timed as context."""
    from deblur_e_nerf_tpu_torch.ops import hash_encode

    levels, total, compute_dtype = layout
    L = len(levels)
    n = u.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    table = torch.rand((total, 2), generator=gen, device="cuda") * 2 - 1
    eps = torch.finfo(torch.float32).eps
    rows_name = "bf16" if compute_dtype is not None else "float32"
    context = {"n": n, "index_structure": kind, "shape": name,
               "rows": rows_name, "levels": L, "table_rows": total}
    modes = [m for *_, m in levels]
    # each input read once (the positions, the table), each output
    # written once; float32 operations a sample and level: the cell and
    # weights (25), the 8 x F products and sums (31)
    io_bytes = n * 3 * 4 + n * 2 * L * 4 + total * 2 * 4
    parent_fwd, parent_bwd = parent or (None, None)

    # forward
    fwd = lambda: hash_encode.encode_forward(table, u, levels, compute_dtype)
    copies = hash_encode.BF16_COPIES
    out = fwd()
    model = hash_encode.encode_forward_model(table, u, levels, compute_dtype)
    torch.cuda.synchronize()
    exact = bool(torch.equal(_bits(torch, out), _bits(torch, model)))
    del model
    same_as_parent = None
    if parent_fwd is not None:
        same_as_parent = bool(torch.equal(_bits(torch, out), _bits(
            torch, parent_fwd(table, u, levels, compute_dtype))))
    plain = hash_encode.encode_forward_reference(table, u, levels,
                                                 compute_dtype)
    err = (out - plain).abs()
    del plain
    tol = 2 * 7 * eps * hash_encode.encode_forward_reference(
        table.abs(), u, levels, compute_dtype)
    within = bool((err <= tol).all())
    max_err, max_tol = float(err.max()), float(tol.max())
    del err, tol, out
    ms, ms_runs, parent_ms, parent_runs = in_turns(
        fwd, parent_fwd and (lambda: parent_fwd(table, u, levels,
                                                compute_dtype)))
    copies = hash_encode.BF16_COPIES - copies
    copy_ms = (time_ms(lambda: table.to(torch.bfloat16))
               if compute_dtype is not None else None)
    plain_ms = time_ms(lambda: hash_encode.encode_forward_reference(
        table, u, levels, compute_dtype), iters=3, warmup=1)
    ctx_level = modes.index("hash")
    ctx_idx, ctx_w = hash_encode.level_rows_weights(
        torch.clamp(u, 0.0, 1.0), *levels[ctx_level], torch.float32)
    ctx_idx = ctx_idx.reshape(-1)
    context_ms = time_ms(lambda: torch.bmm(
        ctx_w[:, None, :], table.index_select(0, ctx_idx).view(n, 8, 2)),
        iters=10)
    bound_ms, bound_by = bound(io_bytes, n * L * 56)
    forward = dict(context, **{
        "max_abs_err": max_err, "tolerance": max_tol,
        "bit_exact_vs_model": exact, "within_order_bound": within,
        "ms": ms, "ms_runs": ms_runs, "parent_ms": parent_ms,
        "parent_ms_runs": parent_runs, "bit_exact_vs_parent": same_as_parent,
        "bf16_copies": copies, "bf16_copy_ms": copy_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "one_level_index_select_bmm_ms": context_ms})
    print(f"hash_encode_fwd {name}, {kind}: N={n} L={L} {rows_name} rows; "
          f"bit exact vs the model of its order: {exact}, vs the parent: "
          f"{same_as_parent}; max_abs_err {max_err:.3e} vs plain (within "
          f"the order bound: {within}, largest bound {max_tol:.3e}); "
          f"kernel {ms:.4f} ms {[round(t, 4) for t in ms_runs]}, parent "
          f"{parent_ms} ms {[round(t, 4) for t in parent_runs]}, bf16 "
          f"copies {copies} ({copy_ms} ms each), plain {plain_ms:.4f} ms, "
          f"one level's index_select + bmm {context_ms:.4f} ms, library "
          f"none, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    if not (exact and within and same_as_parent is not False
            and copies == (compute_dtype is not None)):
        raise AssertionError(f"hash_encode_fwd {name} ({kind}): differs "
                             f"from its plain versions or the parent, or "
                             f"made {copies} bf16 copies")

    # backward
    bwd = lambda: hash_encode.encode_backward(g, u, levels, total)
    max_err, within, max_k, atomics_live = check_encode_backward(
        torch, bwd(), g, u, levels)
    parent_within = None
    if parent_bwd is not None:
        parent_within = check_encode_backward(
            torch, parent_bwd(g, u, levels, total), g, u, levels)[1]
    ms, ms_runs, parent_ms, parent_runs = in_turns(
        bwd, parent_bwd and (lambda: parent_bwd(g, u, levels, total)))
    plain_ms = time_ms(lambda: hash_encode.encode_backward_reference(
        g, u, levels, total), iters=3, warmup=1)
    contrib = (ctx_w[..., None] * g[:, None, 2 * ctx_level:2 * ctx_level + 2]
               ).reshape(-1, 2)
    context_ms = time_ms(lambda: torch.zeros(
        (total, 2), device="cuda").index_add_(0, ctx_idx, contrib), iters=10)
    del ctx_idx, ctx_w, contrib
    reductions = hash_encode.backward_reductions(g, u, levels)
    n_reductions = sum(sum(c.values()) for c in reductions.values())
    # levels 0-1 alone: the dense levels small enough (about 149 KB of
    # float32 rows) to keep in one block's shared memory
    coarse = sum(sum(c.values()) for li in (0, 1)
                 for c in hash_encode.backward_reductions(
                     g[:, 2 * li:2 * li + 2], u, levels[li:li + 1]).values())
    bound_ms, bound_by = bound(io_bytes, n * L * 41)
    backward = dict(context, **{
        "max_abs_err": max_err, "within_order_bound": within,
        "max_row_count": max_k, "ms": ms, "ms_runs": ms_runs,
        "parent_ms": parent_ms, "parent_ms_runs": parent_runs,
        "parent_within_order_bound": parent_within, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "one_level_index_add_ms": context_ms,
        "reductions": reductions, "reductions_total": n_reductions,
        "reductions_levels_0_1": coarse,
        "reductions_per_s": n_reductions / (ms * 1e-3),
        "atomics_after_zero_skip_before_combining": atomics_live})
    print(f"hash_encode_bwd {name}, {kind}: N={n} L={L}; max_abs_err "
          f"{max_err:.3e} vs the float64 plain version (each row within "
          f"(k - 1) eps sum|x| + k FLT_MIN: {within}, largest k {max_k}; "
          f"the parent: {parent_within}); kernel {ms:.4f} ms "
          f"{[round(t, 4) for t in ms_runs]}, parent {parent_ms} ms "
          f"{[round(t, 4) for t in parent_runs]}, plain {plain_ms:.4f} ms, "
          f"one level's index_add_ {context_ms:.4f} ms, library none, "
          f"bound {bound_ms:.4f} ms ({bound_by}); reductions issued "
          f"{n_reductions} ({_reductions_text(reductions)}; levels 0-1 "
          f"{coarse}; {n_reductions / (ms * 1e-3):.4g}/s), {atomics_live} "
          f"vertex-row contributions and cellhash chunks after the zero "
          f"skip, before combining", flush=True)
    if not within or parent_within is False:
        raise AssertionError(f"hash_encode_bwd {name} ({kind}): differs "
                             f"from the float64 plain version")
    return forward, backward


# the L2 reduction probe: (name, bytes an op, reductions an op) by mode of
# `l2_reduction_rate` (csrc/hash_encode.cu)
L2_REDUCTION_MODES = (("RED.F32x2, random 16-byte-aligned address", 8, 1),
                      ("RED.F32x4, random 16-byte-aligned address", 16, 1),
                      ("4 x RED.F32x4, random 64-byte row", 64, 4),
                      ("64-byte bulk reduction (cp.reduce.async.bulk "
                       ".add.f32), random 64-byte row", 64, 1))
L2_REDUCTION_OPS = 1 << 25


def l2_reduction_rates(torch, n_rows):
    """The L2's rate of each reduction form of L2_REDUCTION_MODES into a
    float32 buffer of `n_rows` 64-byte rows (the flagship table's 50 MB),
    L2_REDUCTION_OPS ops a launch, each adding 1.0 to every float it
    covers: after one launch into zeros the buffer must sum to the floats
    the ops covered (no reduction lost). Returns rows of reductions/s and
    bytes/s."""
    from deblur_e_nerf_tpu_torch.ops import _cuda_build, hash_encode

    lib = _cuda_build.library()
    buf = torch.zeros(n_rows * 16, device="cuda")
    stream = hash_encode._stream(buf.device)
    rows = []
    for mode, (name, nbytes, reds) in enumerate(L2_REDUCTION_MODES):
        def launch(mode=mode):
            err = lib.l2_reduction_rate(buf.data_ptr(), n_rows,
                                        L2_REDUCTION_OPS, mode, stream)
            if err:
                raise RuntimeError(f"l2_reduction_rate {mode}: CUDA {err}")

        buf.zero_()
        launch()
        total = float(buf.double().sum())
        want = float(L2_REDUCTION_OPS * nbytes // 4)
        ms = time_ms(launch)
        row = {"form": name, "ops": L2_REDUCTION_OPS, "bytes_per_op": nbytes,
               "reductions_per_op": reds, "ms": ms,
               "ops_per_s": L2_REDUCTION_OPS / (ms * 1e-3),
               "reductions_per_s": L2_REDUCTION_OPS * reds / (ms * 1e-3),
               "bytes_per_s": L2_REDUCTION_OPS * nbytes / (ms * 1e-3)}
        print(f"L2 reductions, {name}: {L2_REDUCTION_OPS} ops in {ms:.4f} ms:"
              f" {row['ops_per_s']:.4g} ops/s, {row['reductions_per_s']:.4g}"
              f" reductions/s, {row['bytes_per_s']:.4g} B/s into "
              f"{n_rows * 64} bytes; buffer sum {total} (want {want})",
              flush=True)
        if total != want:
            raise AssertionError(f"l2_reduction_rate {name}: lost "
                                 f"reductions ({total} of {want})")
        rows.append(row)
    return rows

# ---------------------------------------------------------------------------
# the render layer's scans (csrc/compact.cu, ops/compact.py; csrc/
# composite.cu, ops/composite.py)

# no Pallas kernel: the JAX package's `_compact` (with the prepass's
# `put`) and `composite`, which XLA compiles
COMPACT_SOURCE = "deblur_e_nerf_tpu_torch/csrc/compact.cu"
COMPACT_REPLACES = "deblur_e_nerf_tpu/models/renderer.py:196"
COMPOSITE_SOURCE = "deblur_e_nerf_tpu_torch/csrc/composite.cu"
COMPOSITE_REPLACES = "deblur_e_nerf_tpu/models/renderer.py:613"
# The composite kernels against their plain version on the card,
# |kernel - plain| <= RTOL |plain| + ATOL (backward: ATOL times the largest
# entry). Forward: both take each ray's optical depth as a float64 sum
# rounded to float32 and each ray's weighted sums in float64, in another
# order (the plain version differences global cumsums): an ulp of float32
# or so. Backward: the kernel forms each slot's weight cotangent with fused
# multiply-adds and adds the two paths of sigma dt (the optical depth's
# and alpha's) in another order than autograd, and the two can cancel.
COMPOSITE_FWD_RTOL, COMPOSITE_FWD_ATOL = 2e-6, 1e-8
COMPOSITE_BWD_RTOL, COMPOSITE_BWD_ATOL = 1e-4, 1e-5
# the flagship march's stage shapes (K = MAIN_PATH_SAMPLE_BUDGET, KB = K /
# 4, KSB = KB / 2): the sample stage's (KB + 1) x 8 lanes into K slots, the
# block stage's (KSB + 1) x 4 lanes into KB; the r5fix prepass's put of
# its K + 1 marched slots into K / 2 (phase 8 checks this K)
FLAGSHIP_BLOCK_BUDGET = MAIN_PATH_SAMPLE_BUDGET // 4
FLAGSHIP_SUPERBLOCK_BUDGET = FLAGSHIP_BLOCK_BUDGET // 2
R5FIX_SAMPLE_BUDGET = 8192 * 30 * 4 * 5 // 4
# the flagship step's rays at its batch capacity (429 events x S x 4)
FLAGSHIP_RAYS = 429 * 30 * 4


def check_render_build(ptxas):
    """Print the render and occupancy kernels' registers and spills
    (-Xptxas -v); fail unless each was built (the compaction by tile, the
    composite kernels in float and double, the forward by channel count,
    the march's four, the occupancy update's ten)."""
    kernels = ("compact_kernelILi128E", "compact_kernelILi256E",
               # the forward by type and channels (0: density-only)
               "composite_fwd_kernelIfLi0E", "composite_fwd_kernelIfLi1E",
               "composite_fwd_kernelIfLi3E", "composite_fwd_kernelIdLi0E",
               "composite_fwd_kernelIdLi3E",
               "composite_bwd_kernelIfE", "composite_bwd_kernelIdE",
               "march_masks_kernel", "march_coarse_kernel",
               "march_samples_kernel", "march_decode_kernel",
               "occ_points_kernel", "occ_ema_tiles_kernel",
               "occ_ema_scatter_kernel", "occ_threshold_finish_kernel",
               "occ_threshold_histogram_kernel",
               "occ_threshold_digit_kernel", "occ_threshold_binary_kernel",
               "occ_sample_count_kernel", "occ_sample_scan_kernel",
               "occ_sample_search_kernel")
    for kernel in kernels:
        fns = [fn for fn in ptxas if kernel in fn]
        if not fns and ptxas:
            raise AssertionError(f"{kernel}: no such instance in the build")
        for fn in fns:
            print(f"{kernel} ({fn}): ptxas [{ptxas[fn]}]", flush=True)


def compact_inputs(torch, n, fraction, prepass, seed=0):
    """Seeded flags (each lane with probability `fraction`) and payloads on
    the card: the march's ascending int64 codes, or the prepass's three
    channels (t_mid and dt float32, ascending int64 ray ids)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flags = torch.rand(n, generator=gen, device="cuda") < fraction
    if not prepass:
        codes = torch.arange(n, dtype=torch.int64, device="cuda") * 7 + 3
        return flags, [codes], [7 * n + 3]
    rays = torch.sort(torch.randint(0, FLAGSHIP_RAYS, (n,), generator=gen,
                                    device="cuda"))[0]
    return flags, [torch.rand(n, generator=gen, device="cuda") * 4,
                   torch.rand(n, generator=gen, device="cuda") * 0.02,
                   rays], [0.0, 0.0, FLAGSHIP_RAYS]


def compact_case(torch, label, kind, flags, payloads, budget, fills,
                 cutoff=False, parent=None, launches=False):
    """The compaction kernel against its plain version: every buffer bit
    for bit, the total and the cutoff equal, two runs bit for bit; the
    kernel's time beside the plain version's, torch.masked_select's of
    channel 0 (the library call nearest the function) and the bound (the
    flags read once, the kept lanes' payloads read once and, for the
    cutoff, the dropped lanes' channel 0, every output slot written
    once). With `parent` (the parent checkout's ops.compact) the kernel is
    timed in turns with the parent's on the same inputs; with `launches`
    each one's device launches a call are counted (`device_launches`: a
    captured call)."""
    from deblur_e_nerf_tpu_torch.ops import compact as compact_ops

    args = (flags, payloads, budget, fills, cutoff)
    got = compact_ops.compact(*args)
    again = compact_ops.compact(*args)
    plain = compact_ops.compact_reference(*args)
    torch.cuda.synchronize()

    def same(a, b):
        return (all(x.dtype == y.dtype and torch.equal(_bits(torch, x),
                                                       _bits(torch, y))
                    for x, y in zip(a[0], b[0]))
                and all(int(x) == int(y) for x, y in zip(a[1:], b[1:])))

    exact, repeat = same(got, plain), same(got, again)
    err = max([float((x.double() - y.double()).abs().max())
               for x, y in zip(got[0], plain[0])]
              + [abs(int(x) - int(y)) for x, y in zip(got[1:], plain[1:])])
    del got, again, plain
    total = int(flags.sum())
    kept = min(total, budget)
    ms, runs, parent_ms, parent_runs = in_turns(
        lambda: compact_ops.compact(*args),
        parent and (lambda: parent.compact(*args)))
    plain_ms = time_ms(lambda: compact_ops.compact_reference(*args),
                       iters=10)
    library_ms = time_ms(lambda: torch.masked_select(payloads[0], flags),
                         iters=10)
    size = sum(p.element_size() for p in payloads)
    nbytes = (flags.numel() + size * kept
              + (8 * (total - kept) if cutoff else 0)
              + size * (budget + 1) + 8 * (1 + int(cutoff)))
    bound_ms, bound_by = bound(nbytes)
    row = {"shape": label, "index_structure": kind, "n": flags.numel(),
           "budget": budget, "flagged": total, "overflow": total > budget,
           "channels": [str(p.dtype).replace("torch.", "")
                        for p in payloads],
           "cutoff": cutoff, "max_abs_err": err, "bit_exact": exact,
           "reproducible": repeat, "tolerance": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms,
           "library_call": "torch.masked_select (channel 0)"}
    text = ""
    if parent is not None:
        row.update(runs=runs, parent_ms=parent_ms, parent_runs=parent_runs)
        text += (f"; in turns with the parent's {parent_ms:.4f} ms (runs "
                 f"{[round(t, 4) for t in runs]} against "
                 f"{[round(t, 4) for t in parent_runs]})")
    if launches:
        row["device_launches"] = device_launches(
            torch, lambda: compact_ops.compact(*args))
        text += (f"; device launches a call (kernels, memsets, the "
                 f"captured call's replay ms) {row['device_launches']}")
        if parent is not None:
            row["parent_device_launches"] = device_launches(
                torch, lambda: parent.compact(*args))
            text += f", the parent's {row['parent_device_launches']}"
    print(f"compact {label} ({kind}): {flags.numel()} lanes, {total} "
          f"flagged into {budget} (overflow {total > budget}), channels "
          f"{row['channels']}, cutoff {cutoff}: bit exact {exact}, two runs "
          f"bit for bit {repeat}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, masked_select {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}){text}", flush=True)
    if launches and sum(row["device_launches"][:2]) > 2:
        raise AssertionError(f"compact {label} ({kind}): "
                             f"{row['device_launches']} device launches a "
                             f"call, more than 2")
    if not (exact and repeat):
        raise AssertionError(f"compact {label} ({kind}): differs from its "
                             f"plain version or from its own second run")
    return row


def composite_inputs(torch, n_slots, n_rays, channels, density, seed=0,
                     counts=None):
    """A seeded ray-contiguous buffer of `n_slots` slots on the card:
    `n_rays` rays of half to 3/2 their mean count (or the given `counts`),
    5% more samples than the slots hold (the last rays truncated, the last
    slot empty); sigma uniform below `density` (sigma dt ~ density / 80 a
    sample), 32 overflowed (inf) and 32 with sigma dt far above 25; rgb
    and t_mid uniform."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if counts is None:
        mean = n_slots * 21 // (20 * n_rays)
        counts = torch.randint(mean // 2, mean * 3 // 2 + 1, (n_rays,),
                               generator=gen, device="cuda")
    filled = min(int(counts.sum()), n_slots - 1)
    ray_idx = torch.full((n_slots,), n_rays, dtype=torch.int64,
                         device="cuda")
    ray_idx[:filled] = torch.repeat_interleave(
        torch.arange(n_rays, device="cuda"), counts)[:filled]
    valid = ray_idx < n_rays

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (n_slots,),
                                           generator=gen, device="cuda")

    sigma = uniform(0.0, density)
    if filled:
        extreme = torch.randint(0, filled, (64,), generator=gen,
                                device="cuda")
        sigma[extreme[:32]] = float("inf")
        sigma[extreme[32:]] = 1e5
    return {"sigma": sigma, "rgb": uniform(0.0, 1.0, n_slots, channels),
            "t_mid": torch.where(valid, uniform(1.0, 5.0), 0.0),
            "dt": torch.where(valid, uniform(0.005, 0.02), 0.0),
            "ray_idx": ray_idx, "offsets": torch.cumsum(counts, 0) - counts,
            "counts": counts, "n_rays": n_rays}


def composite_cotangents(torch, n_rays, channels, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for shape in ((n_rays, channels), (n_rays,), (n_rays,)))


def _excess(torch, got, want, rtol, atol, scaled):
    """(largest |got - want|, largest |got - want| - rtol |want| - tol)
    over the tensors, tol = atol (times the largest finite |want| where
    `scaled`); equal infinities and NaN in both count as no error, NaN or
    an infinity in one alone as an infinite one."""
    err, excess = 0.0, -math.inf
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        diff = torch.where(same, 0.0, (a - b).abs().nan_to_num(math.inf))
        finite = b[torch.isfinite(b)]
        tol = atol * (float(finite.abs().max()) if finite.numel() else 0.0) \
            if scaled else atol
        err = max(err, float(diff.max()))
        excess = max(excess, float(
            (diff - rtol * b.abs().nan_to_num(0.0, 0.0, 0.0) - tol).max()))
    return err, excess


def composite_case(torch, label, kind, case, early_stop_eps, alpha_thre,
                   cotangents, parent=None):
    """The composite kernels against their plain version on one buffer:
    the forward's colours, opacities and depths within COMPOSITE_FWD_*,
    its live counts equal, the density-only call's live mask and counts
    (the prepass's) equal to the plain version's and to the forward's; the
    backward's sigma and rgb cotangents within COMPOSITE_BWD_* of autograd
    through the plain version; every kernel output of two runs bit for
    bit. Times of each kernel, the plain forward (no gradient), the plain
    backward alone (torch.autograd.grad on a kept graph) and the bounds
    (the bytes of the slots in ray segments read once, every output
    written once; about 40 and 60 operations a slot). With `parent` (the
    parent checkout's ops.composite) the forward and the density-only
    call are timed in turns with the parent's on the same inputs. Returns
    the forward's and the backward's rows."""
    from deblur_e_nerf_tpu_torch.ops import composite as composite_ops

    c = case
    n_rays, n = c["n_rays"], c["dt"].shape[0]
    args = (c["sigma"], c["rgb"], c["t_mid"], c["dt"], c["ray_idx"],
            c["offsets"], c["counts"], n_rays, early_stop_eps, alpha_thre)
    density_args = (c["sigma"],) + args[3:]
    fwd = composite_ops.composite_forward(*args, save_trans=True)
    fwd2 = composite_ops.composite_forward(*args, save_trans=True)
    live = composite_ops.live_mask(*density_args)
    live2 = composite_ops.live_mask(*density_args)
    with torch.no_grad():
        plain = composite_ops.composite_reference(*args)
    plain_live = composite_ops.live_mask_reference(*density_args)
    bwd = composite_ops.composite_backward(*args, fwd[4], *cotangents)
    bwd2 = composite_ops.composite_backward(*args, fwd[4], *cotangents)
    sigma = c["sigma"].detach().requires_grad_()
    rgb = c["rgb"].detach().requires_grad_()
    outs = composite_ops.composite_reference(sigma, rgb, *args[2:])

    def plain_backward():
        return torch.autograd.grad(outs[:3], (sigma, rgb), cotangents,
                                   retain_graph=True)

    plain_grads = plain_backward()
    torch.cuda.synchronize()

    segment = min(int(c["offsets"][-1] + c["counts"][-1]), n)

    def bitwise(a, b):
        return all(torch.equal(_bits(torch, x), _bits(torch, y))
                   for x, y in zip(a, b) if x is not None)

    # T a slot is written for the slots of ray segments only
    repeat = (bitwise(fwd[:4] + (fwd[4][:segment],),
                      fwd2[:4] + (fwd2[4][:segment],))
              and bitwise(live, live2) and bitwise(bwd, bwd2))
    fwd_err, fwd_excess = _excess(torch, fwd[:3], plain[:3],
                                  COMPOSITE_FWD_RTOL, COMPOSITE_FWD_ATOL,
                                  False)
    bwd_err, bwd_excess = _excess(torch, bwd, plain_grads,
                                  COMPOSITE_BWD_RTOL, COMPOSITE_BWD_ATOL,
                                  True)
    live_equal = (torch.equal(fwd[3], plain[3])
                  and torch.equal(live[0], plain_live[0])
                  and torch.equal(live[1], plain_live[1])
                  and torch.equal(live[1], fwd[3]))
    n_live = int(fwd[3].sum())
    ch = c["rgb"].shape[1]
    width = c["sigma"].element_size()
    ms_f, runs_f, parent_f, parent_runs_f = in_turns(
        lambda: composite_ops.composite_forward(*args, save_trans=True),
        parent and (lambda: parent.composite_forward(*args,
                                                     save_trans=True)))
    ms_live, runs_live, parent_live, parent_runs_live = in_turns(
        lambda: composite_ops.live_mask(*density_args),
        parent and (lambda: parent.live_mask(*density_args)))
    ms_b = time_ms(lambda: composite_ops.composite_backward(
        *args, fwd[4], *cotangents))

    def plain_forward():
        with torch.no_grad():
            return composite_ops.composite_reference(*args)

    plain_f = time_ms(plain_forward, iters=5, warmup=1)
    plain_b = time_ms(plain_backward, iters=5, warmup=1)
    plain_live_ms = time_ms(
        lambda: composite_ops.live_mask_reference(*density_args), iters=5,
        warmup=1)
    # a slot of a ray segment reads sigma, rgb (width bytes each), dt,
    # t_mid (4) and ray_idx (8); the forward writes T, the backward reads
    # it. A ray: offsets and counts in (16), its ch + 2 outputs (or their
    # cotangents) and the forward's live count (8)
    slot_in = width * (1 + ch) + 16
    per_ray = 16 + (ch + 2) * width
    bound_f = bound(segment * (slot_in + width) + n_rays * (per_ray + 8),
                    40 * segment)
    bound_live = bound(segment * (width + 12) + n + n_rays * 24,
                       25 * segment)
    bound_b = bound(segment * (slot_in + width) + n_rays * per_ray
                    + n * width * (1 + ch), 60 * segment)
    common = {"shape": label, "index_structure": kind, "n": n,
              "n_rays": n_rays, "channels": ch,
              "dtype": str(c["sigma"].dtype).replace("torch.", ""),
              "segment_slots": segment, "live_samples": n_live,
              "early_stop_eps": early_stop_eps, "alpha_thre": alpha_thre,
              "reproducible": repeat, "library_ms": None}
    rows = (
        dict(common, max_abs_err=fwd_err, excess=fwd_excess,
             rtol=COMPOSITE_FWD_RTOL, atol=COMPOSITE_FWD_ATOL,
             live_equal=live_equal, ms=ms_f, plain_ms=plain_f,
             bound_ms=bound_f[0], bound_by=bound_f[1],
             density_only_ms=ms_live, density_only_plain_ms=plain_live_ms,
             density_only_bound_ms=bound_live[0]),
        dict(common, max_abs_err=bwd_err, excess=bwd_excess,
             rtol=COMPOSITE_BWD_RTOL, atol_of_largest=COMPOSITE_BWD_ATOL,
             ms=ms_b, plain_ms=plain_b, bound_ms=bound_b[0],
             bound_by=bound_b[1]))
    text = ""
    if parent is not None:
        rows[0].update(runs=runs_f, parent_ms=parent_f,
                       parent_runs=parent_runs_f,
                       density_only_runs=runs_live,
                       density_only_parent_ms=parent_live,
                       density_only_parent_runs=parent_runs_live)
        text = (f"; in turns with the parent's: forward {ms_f:.4f} against "
                f"{parent_f:.4f} ms (runs {[round(t, 4) for t in runs_f]} "
                f"against {[round(t, 4) for t in parent_runs_f]}), "
                f"density-only {ms_live:.4f} against {parent_live:.4f} ms "
                f"(runs {[round(t, 4) for t in runs_live]} against "
                f"{[round(t, 4) for t in parent_runs_live]})")
    print(f"composite {label} ({kind}): {n} slots, {n_rays} rays, {segment} "
          f"in ray segments, {n_live} live, ch {ch}, "
          f"{common['dtype']}, alpha_thre {alpha_thre}: forward max_abs_err "
          f"{fwd_err:.3e} (excess over rtol {COMPOSITE_FWD_RTOL:g} atol "
          f"{COMPOSITE_FWD_ATOL:g}: {fwd_excess:.3e}), live counts and the "
          f"prepass's mask equal {live_equal}; backward max_abs_err "
          f"{bwd_err:.3e} (excess over rtol {COMPOSITE_BWD_RTOL:g} atol "
          f"{COMPOSITE_BWD_ATOL:g} of the largest: {bwd_excess:.3e}); two "
          f"runs bit for bit {repeat}; forward {ms_f:.4f} ms (plain "
          f"{plain_f:.4f}, bound {bound_f[0]:.4f} {bound_f[1]}), "
          f"density-only {ms_live:.4f} ms (plain {plain_live_ms:.4f}, "
          f"bound {bound_live[0]:.4f}), backward {ms_b:.4f} ms (plain "
          f"{plain_b:.4f}, bound {bound_b[0]:.4f} {bound_b[1]}){text}",
          flush=True)
    if not (fwd_excess <= 0 and bwd_excess <= 0 and live_equal and repeat):
        raise AssertionError(f"composite {label} ({kind}): outside its "
                             f"tolerances, live counts or masks differ, or "
                             f"not reproducible")
    return rows


def render_kernel_cases(torch, parent=None):
    """Phase 3's synthetic cases of the render kernels: the compaction at
    the flagship's sample and block stages and the r5fix prepass's
    three-channel put, each below and above its budget, with its device
    launches a call; the composite on a dense buffer of the flagship
    step's size (K + 1 slots, its rays at full batch capacity) with early
    stop, clamped samples and truncated rays, with alpha_thre 0 and 0.05.
    With `parent` (load_parent) each is timed in turns with the parent
    checkout's kernel. Returns {kernel: rows}."""
    rows = {"compact": [], "composite_fwd": [], "composite_bwd": []}
    stages = (
        ("flagship sample stage", (FLAGSHIP_BLOCK_BUDGET + 1) * 8,
         MAIN_PATH_SAMPLE_BUDGET, False, False, (0.4, 0.6)),
        ("flagship block stage", (FLAGSHIP_SUPERBLOCK_BUDGET + 1) * 4,
         FLAGSHIP_BLOCK_BUDGET, False, True, (0.3, 0.7)),
        ("r5fix prepass put", R5FIX_SAMPLE_BUDGET + 1,
         R5FIX_SAMPLE_BUDGET // 2, True, False, (0.3, 0.7)))
    for label, n, budget, prepass, cutoff, fractions in stages:
        for seed, fraction in enumerate(fractions):
            flags, payloads, fills = compact_inputs(torch, n, fraction,
                                                    prepass, seed)
            rows["compact"].append(compact_case(
                torch, label, f"synthetic, {fraction:.0%} flagged", flags,
                payloads, budget, fills, cutoff, parent and parent["compact"],
                launches=True))
            del flags, payloads
            torch.cuda.empty_cache()
    # one channel, as the flagship's and EDS's event intensities
    for alpha_thre in (0.0, 0.05):
        case = composite_inputs(torch, MAIN_PATH_SAMPLE_BUDGET + 1,
                                FLAGSHIP_RAYS, 1, density=6.0)
        fwd, bwd = composite_case(
            torch, "flagship step size", "synthetic, dense", case, 1e-4,
            alpha_thre, composite_cotangents(torch, FLAGSHIP_RAYS, 1),
            parent and parent["composite"])
        rows["composite_fwd"].append(fwd)
        rows["composite_bwd"].append(bwd)
        del case
        torch.cuda.empty_cache()
    return rows


@contextmanager
def capture_render_inputs(store):
    """Record into `store` the inputs (clones on the card) of the render
    kernels' calls inside: every compaction's (flags, payloads, budget,
    fills, cutoff) in call order under "compact", the first composite's
    buffer under "composite" and its backward's cotangents under
    "cotangents", the first march's (binary, rays_o, rays_d, ray_mask,
    jitter) and render config under "march". Wrappers around
    ops.compact.compact, ops.composite.composite and .composite_backward
    and models.renderer.march_rays while the block runs."""
    from deblur_e_nerf_tpu_torch.models import renderer
    from deblur_e_nerf_tpu_torch.ops import compact as compact_ops
    from deblur_e_nerf_tpu_torch.ops import composite as composite_ops

    real = (compact_ops.compact, composite_ops.composite,
            composite_ops.composite_backward, renderer.march_rays)
    store.setdefault("compact", [])

    def march_rays(binary, rays_o, rays_d, ray_mask, jitter, rc):
        if "march" not in store:
            store["march"] = dict(
                inputs=[None if t is None else t.clone() for t in (
                    binary, rays_o, rays_d, ray_mask, jitter)], rc=rc)
        return real[3](binary, rays_o, rays_d, ray_mask, jitter, rc)

    def compact(flags, payloads, budget, fills, return_cutoff=False):
        store["compact"].append((flags.clone(),
                                 [p.clone() for p in payloads], budget,
                                 list(fills), return_cutoff))
        return real[0](flags, payloads, budget, fills, return_cutoff)

    def composite(sigma, rgb, t_mid, dt, ray_idx, offsets, counts, n_rays,
                  early_stop_eps, alpha_thre):
        if "composite" not in store:
            store["composite"] = dict(
                sigma=sigma.detach().clone(), rgb=rgb.detach().clone(),
                t_mid=t_mid.clone(), dt=dt.clone(), ray_idx=ray_idx.clone(),
                offsets=offsets.clone(), counts=counts.clone(),
                n_rays=int(n_rays), early_stop_eps=early_stop_eps,
                alpha_thre=alpha_thre)
        return real[1](sigma, rgb, t_mid, dt, ray_idx, offsets, counts,
                       n_rays, early_stop_eps, alpha_thre)

    def composite_backward(*args):
        if "cotangents" not in store:
            store["cotangents"] = tuple(g.clone() for g in args[-3:])
        return real[2](*args)

    compact_ops.compact = compact
    composite_ops.composite = composite
    composite_ops.composite_backward = composite_backward
    renderer.march_rays = march_rays
    try:
        yield store
    finally:
        (compact_ops.compact, composite_ops.composite,
         composite_ops.composite_backward, renderer.march_rays) = real


@contextmanager
def parent_render_scans(parent):
    """The parent checkout's compaction and composite (its autograd
    function, and the density-only call) in place of this checkout's
    while the block runs: the renderer looks them up at each call."""
    from deblur_e_nerf_tpu_torch.ops import compact as compact_ops
    from deblur_e_nerf_tpu_torch.ops import composite as composite_ops

    real = (compact_ops.compact, composite_ops.composite,
            composite_ops.live_mask)
    compact_ops.compact = parent["compact"].compact
    composite_ops.composite = parent["composite"].composite
    composite_ops.live_mask = parent["composite"].live_mask
    try:
        yield
    finally:
        (compact_ops.compact, composite_ops.composite,
         composite_ops.live_mask) = real


def steps_in_turns(torch, trainer, parent, label, per_turn=3):
    """A steady step's wall ms with this checkout's render scans in turns
    with the parent's in their place (parent, change, change, parent;
    each the median of `per_turn` steps): context for the two kernels'
    times, not a claim. Returns (change's runs, parent's runs)."""
    def median_step():
        times = []
        for _ in range(per_turn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        trainer._flush_pending_metrics()
        return sorted(times)[per_turn // 2]

    def parent_step():
        with parent_render_scans(parent):
            return median_step()

    runs = [parent_step(), median_step(), median_step(), parent_step()]
    ours, theirs = runs[1:3], [runs[0], runs[3]]
    print(f"{label} step in turns with the parent's render scans (median "
          f"of {per_turn} steps each; parent, change, change, parent): "
          f"change {[round(t, 3) for t in ours]} ms, parent "
          f"{[round(t, 3) for t in theirs]} ms", flush=True)
    return ours, theirs


def _to_device(value, device):
    if hasattr(value, "to"):
        return value.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(_to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return value


def render_step_cases(torch, label, captured, parent=None):
    """The render kernels on a step's own inputs (`capture_render_inputs`,
    moved to the host): each of the march's compactions at its own budget
    and at half its flagged lanes (an overflow), the composite on the
    step's buffer and cotangents, and the march's kernels on the step's
    rays, mask, jitter and grid at the step's budgets and cut below its
    demands (`march_cases`). With `parent`, the compactions and the
    composite forward are timed in turns with the parent checkout's and
    the compactions' device launches a call counted. Returns {kernel:
    rows}."""
    rows = {"compact": [], "composite_fwd": [], "composite_bwd": []}
    march = captured["march"]
    for kernel, found in march_cases(
            torch, f"{label} step's own inputs",
            _to_device(march["inputs"], "cuda"), march["rc"], parent,
            below=False).items():
        rows[kernel] = found
    torch.cuda.empty_cache()
    calls = captured["compact"]
    names = ("superblock stage", "block stage", "sample stage")[-len(calls):]
    for name, call in zip(names, calls):
        flags, payloads, budget, fills, cutoff = _to_device(call, "cuda")
        total = int(flags.sum())
        for kind, b in (("step", budget), ("step, overflow", total // 2)):
            rows["compact"].append(compact_case(
                torch, f"{label} step's own inputs: {name}", kind, flags,
                payloads, b, fills, cutoff, parent and parent["compact"],
                launches=kind == "step"))
        del flags, payloads
    case = _to_device(captured["composite"], "cuda")
    eps, alpha_thre = case.pop("early_stop_eps"), case.pop("alpha_thre")
    fwd, bwd = composite_case(
        torch, f"{label} step's own inputs", "step", case, eps, alpha_thre,
        _to_device(captured["cotangents"], "cuda"),
        parent and parent["composite"])
    rows["composite_fwd"].append(fwd)
    rows["composite_bwd"].append(bwd)
    del case
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the march's stages (csrc/march.cu, ops/march.py)

MARCH_SOURCE = "deblur_e_nerf_tpu_torch/csrc/march.cu"
# the JAX functions each kernel replaces (renderer.py's march_rays :226)
MARCH_REPLACES = {
    "march_masks": "deblur_e_nerf_tpu/models/renderer.py:164",
    "march_coarse": "deblur_e_nerf_tpu/models/renderer.py:294",
    "march_samples": "deblur_e_nerf_tpu/models/renderer.py:395",
    "march_decode": "deblur_e_nerf_tpu/models/renderer.py:425",
}
MARCH_KERNELS = tuple(MARCH_REPLACES)
MARCH_OUTPUTS = {"march_masks": ("dilated", "pooled"),
                 "march_coarse": ("flags", "codes", "t_near", "t_far"),
                 "march_samples": ("flags", "codes", "counts"),
                 "march_decode": ("t_mid", "dt", "ray_idx",
                                  "coarse_complete")}
# phase 3's full-width marches: (label, train config, rays a step): the
# flagship's and EDS's batch capacity 8,192 events x S = 30 x 4 render
# slices, r5fix's 1,024 x 30 x 4
MARCH_CONFIGS = (
    ("flagship", "configs/train/synthetic.yaml", 8192 * 30 * 4),
    ("EDS", "configs/train/07_ziggy_and_fuzz_hdr.yaml", 8192 * 30 * 4),
    ("r5fix", "configs/train/quality_sphere_blur32_dense_r5fix.yaml",
     1024 * 30 * 4))
# the synthetic scenes' occupied cells: (fraction, radius in contracted
# units around the grid's centre), sized so that every stage's demand
# fits the config's budgets
MARCH_SCENES = {"flagship": (0.3, 0.05), "EDS": (0.3, 0.06),
                "r5fix": (0.3, 0.11)}
# the float32 operations of a lane, counted from the plain version's
# operators (the bound's operation count; the bytes bound every stage)
MARCH_TIMELINE_OPS = {False: 2, True: 11}   # by cone angle
MARCH_CONTRACT_OPS = {"aabb": 6, "sphere": 35, "tanh": 15}
MARCH_BOUNDS_OPS = 30  # a ray's slab test and jitter
# the operator calls of a steady step's march (op_census "B4 march"): one
# allocation a stage and one more for each of the two per-ray outputs
# (the counts, zeroed, and coarse_complete), two a compaction, the
# offsets' cumsum and difference (15 with superblocks)
MARCH_MAX_OPS = 15


def march_render_config(path):
    """The render config the trainer builds for the train config at
    `path` (its own aabb; the default sample budget)."""
    from deblur_e_nerf_tpu_torch.models import nerf_model

    config = load_with_changes(path, {})
    nerf = config.model.nerf
    return nerf_model.make_render_config(
        nerf, nerf_model.resolve_aabb(nerf, None),
        flagship_sample_budget(config))


def march_inputs(torch, rc, n_rays, occupied, radius, seed=0,
                 device="cuda"):
    """Synthetic march inputs (binary, rays_o, rays_d, ray_mask, jitter)
    on `device`: for an AABB scene rays from 1.5 half-diagonals off the
    box's centre, for an unbounded one from inside the box, each towards
    a point of the box's middle half (unit directions); 3% of the rays
    masked off; the cells within `radius` of the contracted grid's centre
    occupied with probability `occupied`; uniform jitter."""
    from deblur_e_nerf_tpu_torch.models.contraction import ContractionType

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    lo = torch.tensor(rc.aabb[:3], device=device)
    hi = torch.tensor(rc.aabb[3:], device=device)
    center, half = (lo + hi) / 2, (hi - lo) / 2
    targets = center + (rand(n_rays, 3) * 2 - 1) * half * 0.5
    if rc.contraction_type == ContractionType.AABB:
        v = torch.randn((n_rays, 3), generator=gen, device=device)
        o = center + v / v.norm(dim=-1, keepdim=True) * half.norm() * 1.5
    else:
        o = center + (rand(n_rays, 3) * 2 - 1) * half
    d = targets - o
    d = d / d.norm(dim=-1, keepdim=True)
    res = rc.grid_resolution
    c = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    inside = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < radius ** 2
    binary = (inside & (rand(res, res, res) < occupied)).reshape(-1)
    return (binary, o.contiguous(), d.contiguous(), rand(n_rays) >= 0.03,
            rand(n_rays))


def march_stage_calls(inputs, rc):
    """The plain march stage by stage: ([(kernel, stage, its arguments,
    its plain outputs)], {stage: demand}); each kernel call takes its plain
    version's inputs, so that a kernel's error does not reach the next."""
    from deblur_e_nerf_tpu_torch.models import renderer
    from deblur_e_nerf_tpu_torch.ops import march as M
    from deblur_e_nerf_tpu_torch.ops.compact import compact_reference

    binary, o, d, mask, jitter = inputs
    R = o.shape[0]
    n_blocks = M.n_blocks_of(rc)
    sb = renderer.uses_superblocks(rc)
    calls, demand, sb_cut = [], {}, None
    args = (binary, rc, sb)
    dilated, pooled = out = M.masks_reference(*args)
    calls.append(("march_masks", "masks", args, out))
    if sb:
        args = (M.SUPERBLOCKS, o, d, mask, jitter, pooled, rc)
        out = M.coarse_reference(*args)
        calls.append(("march_coarse", "superblock stage", args, out))
        (sb_buf,), demand["superblocks"], sb_cut = compact_reference(
            out[0], [out[1]], rc.superblock_capacity,
            [R * (n_blocks // M.SB_BLOCKS)], True)
        args = (M.BLOCKS_AFTER, o, d, mask, jitter, dilated, rc, out[2],
                out[3], sb_buf)
        label = "block stage"
    else:
        args = (M.BLOCKS_DENSE, o, d, mask, jitter, dilated, rc)
        label = "dense block stage"
    out = M.coarse_reference(*args)
    calls.append(("march_coarse", label, args, out))
    t_near, t_far = out[2:]
    (blk_buf,), demand["blocks"], blk_cut = compact_reference(
        out[0], [out[1]], rc.block_capacity, [R * n_blocks], True)
    args = (o, d, binary, t_near, t_far, blk_buf, rc)
    out = M.samples_reference(*args)
    calls.append(("march_samples", "sample stage", args, out))
    (code_buf,), demand["samples"] = compact_reference(
        out[0], [out[1]], rc.sample_budget, [R * rc.max_samples_per_ray])
    args = (code_buf, t_near, sb_cut, blk_cut, R, rc)
    calls.append(("march_decode", "decode", args,
                  M.decode_reference(*args)))
    return calls, {k: int(v) for k, v in demand.items()}


def march_compare(torch, kernel, got, want, cone):
    """(bit exact, within the rule, largest |difference|, largest ulp
    distance, differing elements) of a march kernel's outputs against its
    plain version's: every output bit for bit (the coarse stage's bounds
    by value, -0 == +0: no zero's sign reaches a sample), except under a
    cone angle the decode's t_mid and dt, within 2 ulp (powf)."""
    exact = ok = True
    err, ulp, differ = 0.0, 0, 0
    for name, a, b in zip(MARCH_OUTPUTS[kernel], got, want):
        if a is None or b is None:
            exact = ok = exact and a is None and b is None
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            exact = ok = False
            continue
        if not a.is_floating_point():
            same = torch.equal(a, b)
            differ += int((a != b).sum())
        elif name in ("t_near", "t_far"):
            same = torch.equal(a, b)
            differ += int((a != b).sum())
        else:
            bits_a, bits_b = _bits(torch, a), _bits(torch, b)
            same = torch.equal(bits_a, bits_b)
            dist = (bits_a.long() - bits_b.long()).abs()
            differ += int((dist > 0).sum())
            ulp = max(ulp, int(dist.max()) if dist.numel() else 0)
            if not same:
                err = max(err, float((a.double() - b.double()).abs()
                                     .nan_to_num(math.inf).max()))
                if not (cone and kernel == "march_decode"
                        and name in ("t_mid", "dt")
                        and int(dist.max()) <= 2):
                    ok = False
                exact = False
                continue
        exact = exact and same
        ok = ok and same
    return exact, ok, err, ulp, differ


def march_bound(kernel, args, rc):
    """The least time of a kernel call: its inputs read once and its
    outputs written once over 3.35 TB/s, or its float32 operations
    (MARCH_*_OPS) over 67 TFLOP/s."""
    from deblur_e_nerf_tpu_torch.ops import march as M

    cone = rc.cone_angle > 0
    tl = MARCH_TIMELINE_OPS[cone]
    contract = MARCH_CONTRACT_OPS[rc.contraction_type.value]
    res = rc.grid_resolution
    if kernel == "march_masks":
        binary, _, sb = args
        n = binary.numel()
        return bound(2 * n + (n // M.POOL ** 3 if sb else 0))
    if kernel == "march_decode":
        code_buf, t_near = args[:2]
        n, R = code_buf.numel(), t_near.numel()
        return bound(8 * n + 4 * R + 16 + 16 * n + R, n * (2 * tl + 4))
    o = args[1] if kernel == "march_coarse" else args[0]
    R = o.shape[0]
    if kernel == "march_samples":
        blk_buf = args[5]
        n = blk_buf.numel() * M.BLOCK_STEPS
        return bound(8 * blk_buf.numel() + 32 * R + res ** 3 + 9 * n + 8 * R,
                     n * (2 * tl + 3 + 6 + contract + 12 + 6))
    mask = args[5]
    n_blocks = M.n_blocks_of(rc)
    lane_ops = 3 * tl + 3 + 6 + contract + 12 + 3
    if args[0] == M.BLOCKS_AFTER:
        buf = args[-1]
        n = buf.numel() * M.SB_BLOCKS
        return bound(8 * buf.numel() + 32 * R + mask.numel() + 9 * n,
                     n * lane_ops)
    n = R * (n_blocks // M.SB_BLOCKS if args[0] == M.SUPERBLOCKS
             else n_blocks)
    return bound(29 * R + mask.numel() + 9 * n + 8 * R,
                 n * lane_ops + R * MARCH_BOUNDS_OPS)


def _masks_library_ms(torch, binary, rc, sb):
    """torch.nn.functional.max_pool3d computing the masks on a float copy
    of the grid: the 3^3 dilation (kernel 3, stride 1, padding 1) and,
    with superblocks, the 4^3 pool (kernel 4, stride 4) and the pooled
    radius-2 dilation (kernel 5, stride 1, padding 2)."""
    import torch.nn.functional as F

    res = rc.grid_resolution
    g = binary.reshape(1, 1, res, res, res).float()
    ms = time_ms(lambda: F.max_pool3d(g, 3, 1, 1))
    if sb:
        p = F.max_pool3d(g, 4, 4)
        ms += time_ms(lambda: F.max_pool3d(g, 4, 4))
        ms += time_ms(lambda: F.max_pool3d(p, 5, 1, 2))
    return ms


def march_case(torch, label, kind, inputs, rc, parent=None, timed=True):
    """The march kernels against their plain versions on one input set:
    each kernel call on its plain version's inputs (`march_stage_calls`),
    every output held by `march_compare`, two runs bit for bit, one launch
    a call (the masks: one or three a march); then `march_rays` (the
    kernels and the compactions) against `march_reference` (the plain
    march) output for output. With `timed`, each kernel's ms a march
    beside its plain version's and its bound, max_pool3d's for the masks,
    and the whole march in turns with the parent checkout's `march_rays`
    (with `parent`) and the plain march's. Returns ({kernel: row}, the
    whole march's row, the demands)."""
    from deblur_e_nerf_tpu_torch.models import renderer
    from deblur_e_nerf_tpu_torch.ops import march as M

    cone = rc.cone_angle > 0
    calls, demand = march_stage_calls(inputs, rc)
    fns = {"march_masks": M.masks, "march_coarse": M.coarse,
           "march_samples": M.samples, "march_decode": M.decode}
    refs = {"march_masks": M.masks_reference,
            "march_coarse": M.coarse_reference,
            "march_samples": M.samples_reference,
            "march_decode": M.decode_reference}
    counters = {"march_masks": "MASKS_LAUNCHES",
                "march_coarse": "COARSE_LAUNCHES",
                "march_samples": "SAMPLES_LAUNCHES",
                "march_decode": "DECODE_LAUNCHES"}
    sb = renderer.uses_superblocks(rc)
    rows, failed = {}, []
    for kernel in MARCH_KERNELS:
        mine = [c for c in calls if c[0] == kernel]
        exact = ok = repeat = True
        err, ulp, differ, launches = 0.0, 0, 0, 0
        for _, stage, args, want in mine:
            before = getattr(M, counters[kernel])
            got = fns[kernel](*args)
            again = fns[kernel](*args)
            _sync(torch, str(inputs[1].device))
            launches += getattr(M, counters[kernel]) - before
            e, o_k, a, u, n = march_compare(torch, kernel, got, want, cone)
            exact, ok = exact and e, ok and o_k
            err, ulp, differ = max(err, a), max(ulp, u), differ + n
            repeat = repeat and march_compare(torch, kernel, again, got,
                                              False)[0]
            del got, again
        want_launches = 0 if not inputs[1].is_cuda else (
            2 * (3 if sb else 1) if kernel == "march_masks"
            else 2 * len(mine))
        row = {"shape": label, "index_structure": kind,
               "stages": [c[1] for c in mine], "bit_exact": exact,
               "within_rule": ok, "reproducible": repeat,
               "max_abs_err": err, "max_ulp": ulp, "differing": differ,
               "tolerance": ("bit for bit; t_mid and dt within 2 ulp"
                             if cone and kernel == "march_decode"
                             else "bit for bit"),
               "launches_a_march": launches // 2,
               "library_ms": None}
        if timed:
            row["ms"] = sum(time_ms(lambda a=args: fns[kernel](*a))
                            for _, _, args, _ in mine)
            row["plain_ms"] = sum(
                time_ms(lambda a=args: refs[kernel](*a), iters=3, warmup=1)
                for _, _, args, _ in mine)
            bounds = [march_bound(kernel, c[2], rc) for c in mine]
            row["bound_ms"] = sum(b[0] for b in bounds)
            row["bound_by"] = max(bounds)[1]
            if kernel == "march_masks":
                row["library_ms"] = _masks_library_ms(torch, inputs[0], rc,
                                                      sb)
                row["library_call"] = "torch.nn.functional.max_pool3d"
        rows[kernel] = row
        print(f"{kernel} {label} ({kind}): {row['stages']}, bit exact "
              f"{exact}, within its rule ({row['tolerance']}) {ok}, "
              f"largest ulp {ulp}, differing {differ}, two runs bit for "
              f"bit {repeat}, launches a march {row['launches_a_march']}"
              + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                 f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                 + (f", max_pool3d {row['library_ms']:.4f} ms"
                    if row["library_ms"] is not None else "")
                 if timed else ""), flush=True)
        if not (ok and repeat and launches == want_launches):
            failed.append(kernel)
    del calls
    # the whole march: the kernels with the compactions against the plain
    got = renderer.march_rays(*inputs, rc)
    want = renderer.march_reference(*inputs, rc)
    _sync(torch, str(inputs[1].device))
    fields = []
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            same = a is None and b is None
        elif name in ("t_mid", "dt"):
            dist = (_bits(torch, a).long() - _bits(torch, b).long()).abs()
            same = int(dist.max()) <= (2 if cone else 0)
        else:
            same = torch.equal(a, b)
        if not same:
            fields.append(name)
    del got, want
    whole = {"shape": label, "index_structure": kind, "demand": demand,
             "budgets": {"superblocks": rc.superblock_capacity if sb
                         else None, "blocks": rc.block_capacity,
                         "samples": rc.sample_budget},
             "overflow": {k: v > {"superblocks": rc.superblock_capacity,
                                  "blocks": rc.block_capacity,
                                  "samples": rc.sample_budget}[k]
                          for k, v in demand.items()},
             "equal_to_plain": not fields}
    if timed:
        parent_fn = None
        if parent is not None:
            # the parent's render config, with its own contraction enum
            import dataclasses

            p_rc = parent["renderer"].RenderConfig(**dict(
                {f.name: getattr(rc, f.name)
                 for f in dataclasses.fields(rc)},
                contraction_type=parent["renderer"].contraction_lib
                .ContractionType(rc.contraction_type.value)))

            def parent_fn():
                return parent["renderer"].march_rays(*inputs, p_rc)
        ms, runs, parent_ms, parent_runs = in_turns(
            lambda: renderer.march_rays(*inputs, rc), parent_fn, iters=5)
        whole.update(ms=ms, runs=runs, parent_ms=parent_ms,
                     parent_runs=parent_runs,
                     plain_ms=time_ms(lambda: renderer.march_reference(
                         *inputs, rc), iters=3, warmup=1))
    print(f"march {label} ({kind}): {inputs[1].shape[0]} rays, demand "
          f"{demand} against budgets {whole['budgets']} (overflow "
          f"{whole['overflow']}); march_rays equal to march_reference "
          f"{not fields} {fields or ''}"
          + (f"; march_rays {whole['ms']:.4f} ms {whole['runs']}, parent "
             f"{whole['parent_ms']} {whole['parent_runs']}, plain march "
             f"{whole['plain_ms']:.4f} ms" if timed else ""), flush=True)
    _empty_cache(torch, str(inputs[1].device))
    if failed or fields:
        raise AssertionError(f"march {label} ({kind}): {failed} differ from "
                             f"their plain versions, are not reproducible "
                             f"or launched otherwise; march fields {fields}")
    return rows, whole, demand


def cut_budgets(rc, demand):
    """`rc` with every coarse budget and the sample budget below the
    demands measured at its own budgets: the superblock budget half the
    superblock demand, the block budget a quarter of the block demand, the
    sample budget an eighth of the sample demand."""
    import dataclasses

    changes = {"block_budget": max(demand["blocks"] // 4, 1),
               "sample_budget": max(demand["samples"] // 8, 1)}
    if "superblocks" in demand:
        changes["superblock_budget"] = max(demand["superblocks"] // 2, 1)
    return dataclasses.replace(rc, **changes)


def march_cases(torch, label, inputs, rc, parent=None, below=True):
    """`march_case` at `rc`'s budgets (timed; with `below`, every stage's
    demand must fit them) and at `cut_budgets` (each coarse stage and the
    sample stage must drop lanes, so that the cutoffs and
    coarse_complete are exercised). Returns {kernel: rows}."""
    rows = {k: [] for k in MARCH_KERNELS + ("march",)}
    kind = "budgets" if below else "step"
    found, whole, demand = march_case(torch, label, kind, inputs, rc,
                                      parent)
    if below and any(whole["overflow"].values()):
        raise AssertionError(f"march {label}: the demand {demand} does not "
                             f"fit the budgets {whole['budgets']}")
    for k, row in found.items():
        rows[k].append(row)
    rows["march"].append(whole)
    found, whole, _ = march_case(torch, label, f"{kind}, cut budgets",
                                 inputs, cut_budgets(rc, demand),
                                 timed=False)
    if not all(whole["overflow"].values()):
        raise AssertionError(f"march {label}, cut budgets: not every stage "
                             f"overflowed: {whole['overflow']}")
    for k, row in found.items():
        rows[k].append(row)
    rows["march"].append(whole)
    return rows


def march_kernel_cases(torch, parent=None):
    """Phase 3's march cases: each of MARCH_CONFIGS at full width on
    synthetic inputs (`march_inputs`, MARCH_SCENES), at its budgets and
    cut below its demand. Returns {kernel: rows}."""
    rows = {k: [] for k in MARCH_KERNELS + ("march",)}
    for label, path, n_rays in MARCH_CONFIGS:
        rc = march_render_config(path)
        inputs = march_inputs(torch, rc, n_rays, *MARCH_SCENES[label])
        for k, found in march_cases(torch, f"{label} synthetic", inputs, rc,
                                    parent).items():
            rows[k] += found
        del inputs
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the occupancy update (csrc/occupancy.cu, ops/occupancy.py)

OCC_SOURCE = "deblur_e_nerf_tpu_torch/csrc/occupancy.cu"
# no Pallas kernel: the JAX package's occupancy update, which XLA compiles
OCC_REPLACES = {
    "occ_points": "deblur_e_nerf_tpu/models/occupancy.py:143",
    "occ_ema": "deblur_e_nerf_tpu/models/occupancy.py:152",
    "occ_threshold": "deblur_e_nerf_tpu/models/occupancy.py:180",
    "occ_sample_occupied": "deblur_e_nerf_tpu/models/occupancy.py:64"}
OCC_KERNELS = tuple(OCC_REPLACES)
OCC_COUNTERS = {"occ_points": "POINTS_LAUNCHES", "occ_ema": "EMA_LAUNCHES",
                "occ_threshold": "THRESHOLD_LAUNCHES",
                "occ_sample_occupied": "SAMPLE_LAUNCHES"}
# phase 3's grids: the flagship's (128^3, aabb), EDS's (256^3, sphere, cone
# angle 0.004) and r5fix's (64^3, thre_floor 1e-3, max_occupied_fraction
# 0.125), each with its train config's render and occupancy settings
OCC_CONFIGS = (("flagship", "configs/train/synthetic.yaml"),
               ("EDS", "configs/train/07_ziggy_and_fuzz_hdr.yaml"),
               ("r5fix", "configs/train/quality_sphere_blur32_dense_r5fix"
                         ".yaml"))
# the threshold's mean: float64 partials summed in a fixed order against
# torch.mean's float32 tree; the cells between the two thresholds flip
OCC_MEAN_RTOL = 1e-5
# the partial sums against partials_model's float64 sums in another order
OCC_PARTIALS_RTOL = 1e-12
# the quantile every grid is also held to (the threshold kernel with
# occ_thre = -inf returns it alone); r5fix's own cap
OCC_QUANTILE_FRACTION = 0.125
# the float32 operations of a point lane by contraction, and of the cone
# step (the bound's operation count; bytes bound every B7 kernel)
OCC_POINT_OPS = {"aabb": 12, "sphere": 35, "tanh": 30}
OCC_STEP_OPS = 12


def occ_keywords(occ):
    """models/occupancy.update's threshold and EMA keywords from an
    `occ_grid` config, as nerf_model.update_occupancy forms them."""
    return dict(occ_thre=float(occ.occ_thre), ema_decay=float(occ.ema_decay),
                thre_floor=float(occ.get("thre_floor", 0.0)),
                max_occupied_fraction=float(
                    occ.get("max_occupied_fraction", 1.0)),
                thre_rel_max=float(occ.get("thre_rel_max", 0.0)))


def occ_settings(path):
    """(render config, occupancy settings) of the train config at `path`:
    the render config the trainer builds and update()'s keywords."""
    config = load_with_changes(path, {})
    return march_render_config(path), occ_keywords(
        config.model.nerf.occ_grid)


def occ_density(torch, rc, scale=40.0, device="cuda"):
    """A synthetic density: a Gaussian blob of `scale` around the aabb's
    centre, 0.15 of its extent wide (N, 1)."""
    lo = torch.tensor(rc.aabb[:3], device=device)
    hi = torch.tensor(rc.aabb[3:], device=device)
    center, width = (lo + hi) / 2, (hi - lo) * 0.15

    def density(x):
        d = (x - center) / width
        return scale * torch.exp(-(d * d).sum(-1, keepdim=True))
    return density


def occ_eval_of(rc, density):
    from deblur_e_nerf_tpu_torch.models import occupancy

    return occupancy.make_occ_eval_fn(density, rc.render_step_size,
                                      rc.cone_angle, rc.near_plane,
                                      rc.far_plane)


def occ_draws(torch, rc, warmup, seed, n_cameras=21, device="cuda"):
    """One update's draws (occupancy.draw_update) and camera positions
    inside the aabb's middle half."""
    from deblur_e_nerf_tpu_torch.models import occupancy

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cone = rc.cone_angle > 0.0
    draws = occupancy.draw_update(gen, rc.grid_resolution, warmup, device,
                                  num_cameras=n_cameras if cone else 0)
    lo = torch.tensor(rc.aabb[:3], device=device)
    hi = torch.tensor(rc.aabb[3:], device=device)
    cams = (lo + hi) / 2 + (torch.rand((n_cameras, 3), generator=gen,
                                       device=device) - 0.5) * (hi - lo) / 2
    return draws, cams


@contextmanager
def plain_occupancy():
    """ops/occupancy.py's wrappers routed to their plain versions while
    the block runs: the plain update on the card."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    names = ("points", "ema", "threshold", "sample_occupied")
    real = [getattr(oo, n) for n in names]
    oo.points, oo.ema = oo.points_reference, oo.ema_reference
    oo.threshold = lambda occs, partials, *a: oo.threshold_reference(occs, *a)
    oo.sample_occupied = oo.sample_occupied_reference
    try:
        yield
    finally:
        for n, fn in zip(names, real):
            setattr(oo, n, fn)


def _nan_equal(torch, a, b):
    """Bit for bit, a NaN equal to any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        _bits(torch, torch.where(nan, 0.0, a)),
        _bits(torch, torch.where(nan, 0.0, b)))


def occ_update_inputs(torch, state, occ_eval, warmup, draws, rc, kw, cams,
                      chunk=1 << 19):
    """The plain update step by step on the card: {sampled cells, the
    chunks' points (start, count, x, step), densities, the EMA's occs, the
    threshold's (binary, thre)}, and the arguments each kernel takes
    there, so that a kernel's error does not reach the next."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    grid = oo.Grid(rc.grid_resolution, tuple(rc.aabb), rc.contraction_type)
    steps = occ_eval.steps
    out = {"grid": grid, "steps": steps, "cams": cams}
    if warmup:
        cells = ()
    else:
        out["sample_args"] = (state.binary, draws["occupied"])
        out["sampled"] = oo.sample_occupied_reference(*out["sample_args"])
        cells = (draws["uniform_cells"], out["sampled"])
    out["cells"] = cells
    n = draws["jitter"].shape[0]
    chunk = max(oo.TILE, chunk // oo.TILE * oo.TILE)
    out["points"], out["chunks"] = [], []
    for start in range(0, n, chunk):
        args = (grid, draws["jitter"], start, min(chunk, n - start), cells,
                steps, draws.get("cam_ids"), cams)
        x, step = oo.points_reference(*args)
        out["points"].append((args, (x, step)))
        with torch.no_grad():
            out["chunks"].append((start, occ_eval.density_fn(x), step))
    out["ema_args"] = (state.occs, kw["ema_decay"], out["chunks"],
                       cells if cells else None, steps.render_step_size)
    out["occs"], _ = oo.ema_reference(*out["ema_args"])
    out["thre_args"] = (kw["occ_thre"], kw["thre_floor"], kw["thre_rel_max"],
                        kw["max_occupied_fraction"])
    out["binary"], out["thre"] = oo.threshold_reference(out["occs"],
                                                        *out["thre_args"])
    return out


def occ_bounds(kernel, inputs, rc, n_cells):
    """The least time of a kernel's calls in an update: its inputs read
    once and its outputs written once over 3.35 TB/s (the sampled EMA's
    keys and the threshold's partials and select passes are scratch; the
    sampler reads its fallback cells only when no cell is occupied), or
    its float32 operations over 67 TFLOP/s."""
    lanes = sum(a[3] for a, _ in inputs["points"])
    listed = 8 * lanes if inputs["cells"] else 0
    cone = rc.cone_angle > 0
    step_bytes = 4 * lanes if cone else 0
    if kernel == "occ_points":
        ops = lanes * (OCC_POINT_OPS[rc.contraction_type.value]
                       + (OCC_STEP_OPS if cone else 0))
        return bound(listed + 24 * lanes + (8 * lanes if cone else 0)
                     + step_bytes, ops)
    if kernel == "occ_ema":
        return bound(8 * n_cells + 4 * lanes + step_bytes + listed,
                     3 * lanes)
    if kernel == "occ_threshold":
        return bound(5 * n_cells, 2 * n_cells)
    binary, draws = inputs["sample_args"]
    n = draws["u"].numel()
    # the mask, u (float32) and the cells out (int64)
    return bound(n_cells + 12 * n + (0 if bool(binary.any()) else 8 * n))


def occ_case(torch, label, kind, state, occ_eval, warmup, draws, rc, kw,
             cams, timed=True):
    """The four occupancy kernels against their plain versions on one
    update: each call on its plain version's inputs
    (`occ_update_inputs`), points, steps, EMA and sampler bit for bit
    (NaN equal to NaN), the EMA's partials within OCC_PARTIALS_RTOL of
    partials_model, the threshold within OCC_MEAN_RTOL of the plain one
    with the binary mask equal but for the cells between the two
    thresholds (counted), the quantile (the threshold kernel with occ_thre
    -inf at the config's fraction, else OCC_QUANTILE_FRACTION) bit for bit
    against torch.quantile; two runs bit for bit, one launch a call (the
    EMA one a chunk and one more for a sampled update); then the whole
    update (models/occupancy.update) against the plain update. With
    `timed`, each kernel's ms an update (its device time, replayed from a
    CUDA graph, and its calls' time with the wrappers' host work) beside
    its plain version's, its bound and the library call. Returns ({kernel:
    row}, the new state)."""
    from deblur_e_nerf_tpu_torch.models import occupancy
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    inputs = occ_update_inputs(torch, state, occ_eval, warmup, draws, rc, kw,
                               cams)
    n_cells = state.occs.numel()
    device = str(state.occs.device)
    on_card = state.occs.is_cuda
    rows, failed = {}, []

    def launches_of(kernel, fn):
        before = getattr(oo, OCC_COUNTERS[kernel])
        out = fn()
        _sync(torch, device)
        return out, getattr(oo, OCC_COUNTERS[kernel]) - before

    def row(kernel, exact, repeat, launches, want_launches, extra=None):
        want_launches *= on_card  # the plain versions launch nothing
        r = {"shape": label, "index_structure": kind, "bit_exact": exact,
             "within_rule": exact, "reproducible": repeat,
             "max_abs_err": 0.0, "launches_an_update": launches,
             "tolerance": "bit for bit (NaN equal to NaN)",
             "library_ms": None, **(extra or {})}
        rows[kernel] = r
        if not (r["within_rule"] and repeat and launches == want_launches):
            failed.append(kernel)
        return r

    # the sampler
    if not warmup:
        got, n1 = launches_of("occ_sample_occupied",
                              lambda: oo.sample_occupied(
                                  *inputs["sample_args"]))
        again = oo.sample_occupied(*inputs["sample_args"])
        row("occ_sample_occupied", torch.equal(got, inputs["sampled"]),
            torch.equal(got, again), n1, 1,
            {"fallback": not bool(state.binary.any())})
    # the points, chunk by chunk
    exact = repeat = True
    launches = 0
    for args, (x, step) in inputs["points"]:
        (gx, gs), n1 = launches_of("occ_points", lambda a=args: oo.points(*a))
        ax, as_ = oo.points(*args)
        exact = exact and _nan_equal(torch, gx, x) and (
            step is None and gs is None or _nan_equal(torch, gs, step))
        repeat = repeat and torch.equal(_bits(torch, gx), _bits(torch, ax))
        launches += n1
    row("occ_points", exact, repeat, launches, len(inputs["points"]))
    # the EMA on the plain densities
    (g_occs, partials), n1 = launches_of(
        "occ_ema", lambda: oo.ema(*inputs["ema_args"]))
    again, _ = oo.ema(*inputs["ema_args"])
    p_err, p_max = 0.0, True  # the plain version has no partials
    if partials is not None:
        psum, pmax = oo.partials_model(inputs["occs"])
        p_err = float(((partials[0] - psum).abs()
                       / psum.abs().clamp(min=1e-30)).nan_to_num(0.0).max())
        p_max = _nan_equal(torch, partials[1], pmax)
    ema_row = row("occ_ema", _nan_equal(torch, g_occs, inputs["occs"]),
                  _nan_equal(torch, again, g_occs), n1,
                  len(inputs["chunks"]) + (0 if warmup else 1),
                  {"partials_rel_err": p_err, "partials_max_equal": p_max})
    if not (p_err <= OCC_PARTIALS_RTOL and ema_row["partials_max_equal"]):
        failed.append("occ_ema partials")
    # the threshold on the kernel EMA's outputs
    (binary, thre), n1 = launches_of("occ_threshold", lambda: oo.threshold(
        g_occs, partials, *inputs["thre_args"]))
    b2, t2 = oo.threshold(g_occs, partials, *inputs["thre_args"])
    want_t = inputs["thre"]
    t_err = float((thre.double() - want_t.double()).abs()
                  / want_t.double().abs().clamp(min=1e-30))
    nan_t = bool(torch.isnan(want_t))
    flips = binary != inputs["binary"]
    lo = torch.minimum(thre, want_t)
    hi = torch.maximum(thre, want_t)
    between = (g_occs >= lo) & (g_occs <= hi)
    frac = kw["max_occupied_fraction"]
    q = 1.0 - (frac if frac < 1.0 else OCC_QUANTILE_FRACTION)
    qmode = (float("-inf"), 0.0, 0.0, 1.0 - q)
    (q_bin, q_got), _ = launches_of("occ_threshold", lambda: oo.threshold(
        g_occs, partials, *qmode))
    q_want = torch.quantile(inputs["occs"], q)
    thre_ok = (t_err <= OCC_MEAN_RTOL or (nan_t and bool(torch.isnan(thre))))
    trow = row("occ_threshold",
               thre_ok and not bool((flips & ~between).any())
               and _nan_equal(torch, q_got, q_want),
               torch.equal(binary, b2) and _nan_equal(torch, thre, t2),
               n1, 1,
               {"thre": float(thre), "plain_thre": float(want_t),
                "thre_rel_err": t_err, "flipped_cells": int(flips.sum()),
                "cells_between": int(between.sum()),
                "quantile_q": q, "quantile": float(q_got),
                "quantile_bit_exact": _nan_equal(torch, q_got, q_want),
                "tolerance": f"thre within {OCC_MEAN_RTOL:g} relative, the "
                             f"mask but the cells between the two "
                             f"thresholds, the quantile bit for bit"})
    trow["bit_exact"] = torch.equal(binary, inputs["binary"]) and \
        _nan_equal(torch, thre, want_t)
    trow["max_abs_err"] = abs(float(thre) - float(want_t)) if not nan_t \
        else 0.0
    # the whole update
    steps_kw = dict(resolution=rc.grid_resolution, aabb=rc.aabb,
                    contraction_type=rc.contraction_type,
                    camera_positions=cams, **kw)
    new = occupancy.update(state, occ_eval, warmup, draws, **steps_kw)
    with plain_occupancy():
        plain = occupancy.update(state, occ_eval, warmup, draws, **steps_kw)
    _sync(torch, device)
    whole_ok = _nan_equal(torch, new.occs, plain.occs) and not bool(
        ((new.binary != plain.binary) & ~between).any())
    if timed:
        import functools

        plain_fns = {"occ_points": oo.points_reference,
                     "occ_ema": oo.ema_reference,
                     "occ_sample_occupied": oo.sample_occupied_reference}
        fns = {"occ_points": oo.points, "occ_ema": oo.ema,
               "occ_sample_occupied": oo.sample_occupied}
        calls = {"occ_points": [a for a, _ in inputs["points"]],
                 "occ_ema": [inputs["ema_args"]],
                 "occ_sample_occupied": ([inputs["sample_args"]]
                                         if not warmup else [])}
        # the kernels' device time from a CUDA graph's replay ("ms"), and
        # their calls' time with the wrappers' host work ("call_ms")
        for kernel, r in rows.items():
            if kernel == "occ_threshold":
                call = functools.partial(oo.threshold, g_occs, partials,
                                         *inputs["thre_args"])
                r["ms"], r["call_ms"] = graph_ms(call), time_ms(call)
                r["plain_ms"] = time_ms(lambda: oo.threshold_reference(
                    inputs["occs"], *inputs["thre_args"]), iters=5)
                r["quantile_ms"] = graph_ms(lambda: oo.threshold(
                    g_occs, partials, *qmode))
                r["library_ms"] = time_ms(lambda: torch.quantile(
                    inputs["occs"], q), iters=5)
                r["library_call"] = "torch.quantile"
                k = int(q * (n_cells - 1)) + 1
                r["kthvalue_ms"] = time_ms(lambda: torch.kthvalue(
                    inputs["occs"], k), iters=5)
            else:
                r["ms"] = sum(graph_ms(functools.partial(fns[kernel], *a))
                              for a in calls[kernel])
                r["call_ms"] = sum(
                    time_ms(functools.partial(fns[kernel], *a))
                    for a in calls[kernel])
                r["plain_ms"] = sum(
                    time_ms(functools.partial(plain_fns[kernel], *a),
                            iters=5)
                    for a in calls[kernel])
            r["bound_ms"], r["bound_by"] = occ_bounds(kernel, inputs, rc,
                                                      n_cells)
        if not warmup:
            cells = torch.cat([c.to(torch.int64) for c in inputs["cells"]])
            occ = torch.cat([d.reshape(-1) * (s if s is not None
                                              else rc.render_step_size)
                             for _, d, s in inputs["chunks"]])
            rows["occ_ema"]["library_ms"] = time_ms(
                lambda: state.occs.scatter_reduce(0, cells, occ, "amax",
                                                  include_self=True))
            rows["occ_ema"]["library_call"] = "scatter_reduce(amax)"
            b, d = inputs["sample_args"]
            rows["occ_sample_occupied"]["library_ms"] = time_ms(
                lambda: torch.searchsorted(
                    torch.cumsum(b.to(torch.float32), 0), d["u"],
                    right=True))
            rows["occ_sample_occupied"]["library_call"] = \
                "torch.searchsorted over a cumsum"
    for kernel, r in rows.items():
        print(f"{kernel} {label} ({kind}): bit exact {r['bit_exact']}, "
              f"within its rule ({r['tolerance']}) {r['within_rule']}, two "
              f"runs bit for bit {r['reproducible']}, launches an update "
              f"{r['launches_an_update']}"
              + (f"; thre {r['thre']:.9g} against {r['plain_thre']:.9g} "
                 f"(relative {r['thre_rel_err']:.3e}), cells flipped "
                 f"{r['flipped_cells']} of {r['cells_between']} between "
                 f"the thresholds, quantile({r['quantile_q']:.3f}) "
                 f"{r['quantile']:.9g} bit for bit "
                 f"{r['quantile_bit_exact']}"
                 if kernel == "occ_threshold" else "")
              + (f"; partials relative error {r['partials_rel_err']:.2e}"
                 if kernel == "occ_ema" else "")
              + (f"; kernel {r['ms']:.4f} ms (graph replay; {r['call_ms']:.4f}"
                 f" ms a call with the host's work), plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']})"
                 + (f", {r['library_call']} {r['library_ms']:.4f} ms"
                    if r["library_ms"] is not None else "")
                 + (f", quantile alone {r['quantile_ms']:.4f} ms (graph "
                    f"replay), torch.kthvalue {r['kthvalue_ms']:.4f} ms"
                    if kernel == "occ_threshold" else "")
                 if timed else ""), flush=True)
    print(f"occupancy update {label} ({kind}): occupied fraction "
          f"{float(new.binary.float().mean()):.5f}, update equal to the "
          f"plain update {whole_ok} (cells flipped "
          f"{int((new.binary != plain.binary).sum())})", flush=True)
    del inputs
    if failed or not whole_ok:
        raise AssertionError(f"occupancy {label} ({kind}): {failed} differ "
                             f"from their plain versions, are not "
                             f"reproducible or launched otherwise; the "
                             f"whole update equal {whole_ok}")
    return rows, new


def capture_occupancy(trainer):
    """A trainer's grid (clones), its model (the field the update
    evaluates), camera positions and occupancy settings, for
    `occ_step_cases`."""
    from deblur_e_nerf_tpu_torch.models import occupancy

    model = trainer.params.nerf
    return dict(
        state=occupancy.OccupancyGridState(trainer.occ_state.occs.clone(),
                                           trainer.occ_state.binary.clone()),
        model=model,
        cams=trainer.bundle.consts["trajectory"].T_wc_position.clone(),
        kw=occ_keywords(model.occ_grid_config))


def _profiled_call(torch, fn, label="a call"):
    """The device records (torch.profiler's key averages) of one call of
    fn, after one call whose records are dropped: a profile that starts
    with the call loses the records of its first kernels (one to four of
    them on an H100 with torch 2.11), and one profile in some held no
    device record at all: such a profile is taken again, up to three
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        # the schedule's step annotation spans the step on the device too
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")]
        if kernels:
            return kernels
        print(f"profile {attempt + 1} of {label} held no device record",
              flush=True)
    return []


GRAPH_KERNEL_NODE = 0  # CUDA's CUgraphNodeType of a kernel node


def device_launches(torch, fn):
    """(kernel launches, memsets and other device work, their device ms)
    in one call of fn: the nodes of a CUDA graph captured from one call
    (after a warm-up call), by their CUgraphNodeType, and the graph's
    replay time between CUDA events. A capture holds every launch of the
    call, where a profile of one call often held no device record at all
    (`_profiled_call`); a call with no device work raises."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(kind.value)
    if not types:
        raise AssertionError("a captured call held no device work")
    kernels = types.count(GRAPH_KERNEL_NODE)
    ms = time_ms(graph.replay)
    del graph
    return kernels, len(types) - kernels, ms


def _profiled_update(torch, fn):
    """(device ms of all kernels, of the occupancy kernels, of the encode,
    {occupancy kernel: the device launches of its family (KERNEL_NAMES)},
    the memsets of every source) of one call of fn (`_profiled_call`)."""
    kernels = _profiled_call(torch, fn, "an update")

    def ms(match):
        return sum(e.self_device_time_total for e in kernels
                   if match(e.key)) / 1e3
    device = {k: sum(e.count for e in kernels if KERNEL_NAMES[k] in e.key)
              for k in OCC_KERNELS}
    return (ms(lambda k: True), ms(lambda k: "occ_" in k),
            ms(lambda k: KERNEL_NAMES["hash_encode_fwd"] in k), device,
            sum(e.count for e in kernels if "memset" in e.key.lower()))


def time_update(torch, label, fn, parent_fn):
    """A whole update timed: wall ms (a mean of 5 calls between
    synchronizations), in turns with the parent's update (parent,
    change, change, parent), its kernels' device ms from one profiled call
    (all, the occupancy kernels', the encode's, and the rest: the field's
    MLPs and the draws' RNG; the encode and the MLPs are not B7's) and
    its peak device memory above the memory held before it, and the
    occupancy kernels' device launches in that call beside their entry
    points' calls in another (ops/occupancy's counts); the parent's
    likewise, and its plain B7's device ms (its kernels less the change's
    other than the occupancy kernels'). Returns the row."""
    from deblur_e_nerf_tpu_torch.ops import occupancy as oo

    def wall(f):
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    def peak(f):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    ms, runs, parent_ms, parent_runs = in_turns(
        fn, parent_fn, iters=1, timer=lambda f, _: wall(f),
        parent_timer=lambda f, _: wall(f))
    total, occ, encode, device, memsets = _profiled_update(torch, fn)
    before = {k: getattr(oo, v) for k, v in OCC_COUNTERS.items()}
    fn()
    calls = {k: getattr(oo, v) - before[k] for k, v in OCC_COUNTERS.items()}
    row = {"shape": label, "wall_ms": ms, "wall_runs": runs,
           "kernel_ms": total, "occ_kernel_ms": occ,
           "encode_kernel_ms": encode,
           "other_kernel_ms": total - occ - encode, "peak_mib": peak(fn),
           "entry_point_calls": calls, "device_launches": device,
           "memsets": memsets}
    if parent_fn is not None:
        p_total, _, p_encode, _, _ = _profiled_update(torch, parent_fn)
        row.update(parent_wall_ms=parent_ms, parent_wall_runs=parent_runs,
                   parent_kernel_ms=p_total, parent_encode_kernel_ms=p_encode,
                   parent_b7_kernel_ms=p_total - (total - occ),
                   parent_peak_mib=peak(parent_fn))
    print(f"whole update {label}: the occupancy kernels' device launches "
          f"{device} from their entry points' calls {calls}, memsets (all "
          f"sources) {memsets}", flush=True)
    print(f"whole update {label}: wall {ms:.3f} ms {runs}, kernels "
          f"{total:.3f} ms (the occupancy kernels {occ:.3f}, the encode "
          f"{encode:.3f}, the rest {row['other_kernel_ms']:.3f}: the "
          f"field's MLPs and the draws), peak {row['peak_mib']:.1f} MiB "
          f"above the state"
          + (f"; parent: wall {parent_ms:.3f} ms {parent_runs}, kernels "
             f"{p_total:.3f} ms (the encode {p_encode:.3f}; its plain B7 "
             f"about {row['parent_b7_kernel_ms']:.3f}), peak "
             f"{row['parent_peak_mib']:.1f} MiB"
             if parent_fn is not None else ""), flush=True)
    return row


def occ_step_cases(torch, label, got, parent=None):
    """The occupancy kernels on a trainer's own grid and field
    (`capture_occupancy`, "3b"): a warmup and a sampled update from the
    grid, seeded draws, each kernel against its plain version (`occ_case`,
    timed), then the whole update timed (`time_update`) in turns with the
    parent's update (with `parent`), and with `parent` the operators
    outside the field (op_census "B7 occupancy update") of both updates.
    Returns {kernel: rows} and, under "occ_update", the whole updates'
    rows."""
    from deblur_e_nerf_tpu_torch import op_census
    from deblur_e_nerf_tpu_torch.models import nerf_model, occupancy

    model, state, cams, kw = (got["model"], got["state"], got["cams"],
                              got["kw"])
    rc = model.render_config
    cone = rc.cone_angle > 0.0

    def density(x):
        return nerf_model.density_fn(model, x, None)

    occ_eval = occ_eval_of(rc, density)
    steps_kw = dict(resolution=rc.grid_resolution, aabb=rc.aabb,
                    contraction_type=rc.contraction_type, **kw)
    rows = {k: [] for k in OCC_KERNELS + ("occ_update",)}
    for kind, warmup, seed in (("warmup", True, 11), ("sampled", False, 12)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        draws = occupancy.draw_update(gen, rc.grid_resolution, warmup,
                                      "cuda", cams.shape[0] if cone else 0)
        found, _ = occ_case(torch, f"{label} step's own grid", kind, state,
                            occ_eval, warmup, draws, rc, kw, cams)
        for k, r in found.items():
            rows[k].append(r)

        def fn():
            return occupancy.update(state, occ_eval, warmup, draws,
                                    camera_positions=cams, **steps_kw)

        parent_fn = None
        if parent is not None:
            p_occ = parent["occupancy"]
            p_eval = p_occ.make_occ_eval_fn(
                density, rc.render_step_size, rc.cone_angle, rc.near_plane,
                rc.far_plane)
            p_kw = dict(steps_kw, contraction_type=parent["contraction"]
                        .ContractionType(rc.contraction_type.value))

            def parent_fn():
                return p_occ.update(state, p_eval, warmup, draws,
                                    camera_positions=cams, **p_kw)

        row = time_update(torch, f"{label} {kind}", fn, parent_fn)
        rows["occ_update"].append(row)
        if parent is None:
            continue
        # the parent's update counted by the same layers: its field calls
        # run within its "B7 occupancy update"
        counts = {}
        for who, f, packages in (("change", fn, ()),
                                 ("parent", parent_fn, (parent["package"],))):
            found, _ = op_census.count_ops(f, packages)
            torch.cuda.synchronize()
            counts[who] = {k: found.get(k, {}).get("forward", 0) for k in (
                "B7 occupancy update", "B7 occupancy update: field")}
        row["operators"] = counts
        print(f"operators of one {kind} {label} update, outside the field "
              f"and the field's: {counts['change']} against the parent's "
              f"{counts['parent']}", flush=True)
    return rows

def occ_cases(torch, label, path, timed=True, scale=40.0, resolution=None,
              device="cuda"):
    """Phase 3's occupancy cases on one config's grid with the synthetic
    density (`occ_density`): two warmup updates from an empty grid, a
    sampled update, a sampled update on a grid with nothing occupied (the
    sampler's fallback) and a warmup and a sampled update with NaN planted
    in the density at the blob's core (NaN reaches the same cells, the
    same NaN threshold and an empty mask as in the plain version), at the
    config's resolution unless `resolution` is given. Returns {kernel:
    rows}."""
    import dataclasses

    from deblur_e_nerf_tpu_torch.models import occupancy

    rc, kw = occ_settings(path)
    if resolution is not None:
        rc = dataclasses.replace(rc, grid_resolution=resolution)
    density = occ_density(torch, rc, scale, device)
    occ_eval = occ_eval_of(rc, density)
    state = occupancy.init_state(rc.grid_resolution, device)
    rows = {k: [] for k in OCC_KERNELS}

    def run(kind, state, warmup, seed, timed=False, occ_eval=occ_eval):
        draws, cams = occ_draws(torch, rc, warmup, seed, device=device)
        found, new = occ_case(torch, f"{label} synthetic", kind, state,
                              occ_eval, warmup, draws, rc, kw, cams, timed)
        for k, r in found.items():
            rows[k].append(r)
        return new

    state = run("warmup from empty", state, True, 1)
    state = run("warmup", state, True, 2, timed)
    run("sampled", state, False, 3, timed)
    empty = occupancy.OccupancyGridState(state.occs,
                                         torch.zeros_like(state.binary))
    run("sampled, nothing occupied (fallback)", empty, False, 4)

    def nan_density(x):  # NaN in the blob's core
        d = density(x)
        return torch.where(d > 0.9 * scale, math.nan, d)

    nan_eval = occ_eval_of(rc, nan_density)
    nan_state = run("warmup, NaN density", state, True, 5, occ_eval=nan_eval)
    run("sampled, NaN density", nan_state, False, 6, occ_eval=nan_eval)
    _empty_cache(torch, device)
    return rows


def occ_kernel_cases(torch):
    """Phase 3's occupancy cases on each of OCC_CONFIGS. Returns {kernel:
    rows}."""
    rows = {k: [] for k in OCC_KERNELS + ("occ_update",)}
    for label, path in OCC_CONFIGS:
        for k, found in occ_cases(torch, label, path).items():
            rows[k] += found
    return rows


def probe_case(case):
    """A case of the port's microbenchmark: K2/K3 (the JAX script's check)
    or a library baseline (B11: its stated check); raises where it is not
    within its tolerance."""
    from deblur_e_nerf_tpu_torch import perf_microbench

    row = perf_microbench.CASES[case]("cuda")
    print(f"{case} ({row.get('kernel') or row['call']}): {json.dumps(row)}",
          flush=True)
    if not perf_microbench.within(row):
        raise AssertionError(f"{case}: an error above its tolerance: "
                             f"{json.dumps(row)}")
    return dict(row, shape=f"{case} probe")


def phase_kernels(torch, parent=None):
    from deblur_e_nerf_tpu_torch.ops import gather_rows, scatter_rows
    from deblur_e_nerf_tpu_torch.training.evaluation import (
        DEFAULT_FIELD_CHUNK as n_eval)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = 131072
    k1 = MAIN_PATH_SAMPLE_BUDGET + 1
    k1_off = FILTER_OFF_SAMPLE_BUDGET + 1
    # the L2's reduction rates, into a buffer of the flagship table's size
    flagship_rows = encode_layout(torch, ENCODE_CASES[0][1]())[1]
    l2_rates = l2_reduction_rates(torch, flagship_rows * 2 // 16)
    # the fused encode: the step's field call over all K + 1 slots, and an
    # eval field call (no gradient on that path; the backward timed there
    # too); the step's own inputs follow phase 7 (`phase_step_inputs`)
    encode = {"hash_encode_fwd": [], "hash_encode_bwd": []}
    for name, config in ENCODE_CASES:
        layout = encode_layout(torch, config())
        for n_enc, kind, label in ((k1, "uniform", "N = K + 1"),
                                   (k1, "rays", "N = K + 1"),
                                   (n_eval, "uniform", "eval N = 2^20")):
            u, g = encode_inputs(torch, kind, n_enc, len(layout[0]))
            rows = encode_case(torch, f"{label}: {name}", layout, u, g,
                               kind, parent and parent["encode"])
            del u, g
            encode["hash_encode_fwd"].append(rows[0])
            encode["hash_encode_bwd"].append(rows[1])
            torch.cuda.empty_cache()
    # K1 and K3 at the per-level encode's shapes (before it was fused)
    scatter_cases = [
        # the per-level encode's calls in a filter-on step: one a level, on
        # all K + 1 slots
        ("flagship step: cellhash levels 7-15", 16, 65536, k1),
        ("flagship step: dense level 0", 16, 4096, k1),
        ("flagship step: vertex-hash levels 5-6", 2, 524288, 8 * k1),
        # the step's index structures: a warmup step's ~6.3M empty slots
        # (zero rows at one index) after the marched samples, and the
        # ray-ordered runs of samples sharing a cell
        ("flagship step: cellhash levels 7-15", 16, 65536, k1, "empty_tail"),
        ("flagship step: cellhash levels 7-15", 16, 65536, k1, "ray_runs"),
        ("flagship step: dense level 0", 16, 4096, k1, "ray_runs"),
        # the reads alone: every row zero, no atomic issued
        ("flagship step: cellhash levels 7-15", 16, 65536, k1, "all_zero"),
        ("flagship step: vertex-hash levels 5-6", 2, 524288, 8 * k1,
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
    # the filter-on step's per-level encode (and the occupancy update's):
    # one gather per level over all K + 1 slots, on uniform rows and on
    # ray-ordered runs; the vertex-hash level's 8 corners per sample in
    # both orders
    vertex = "flagship step: vertex-hash levels 5-6"
    gather_inputs = [
        (name, width, n_rows, kind,
         lambda n_rows=n_rows, kind=kind: k3_indices(torch, kind, k1, n_rows))
        for name, width, n_rows in (
            ("flagship step: cellhash view, levels 7-15", 16, 65536),
            ("flagship step: packed dense level 0", 16, 16 ** 3),
            ("flagship step: packed dense level 4", 16, 70 ** 3))
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
    scatter.append(probe_case("pallas_probe"))
    gather.append(probe_case("pallas_gather_probe"))
    # the library baselines of the encode's and K1/K3's rows (B11): no
    # path runs them, but their times are the yardsticks of the kernels'
    # rows and are compared with them only within one call (a card below
    # its 700 W limit runs slower), so they run beside the kernels here;
    # `python -m deblur_e_nerf_tpu_torch.perf_microbench` runs them alone
    library = [probe_case(name) for name in perf_microbench.LIBRARY_CASES]
    torch.cuda.empty_cache()
    # the weight chain at the flagship step's shape; the step's own inputs
    # follow phase 7
    pb = {"pb_weight_fwd": [], "pb_weight_bwd": []}
    for calib, S, M, n_clamped in PB_CASES:
        fwd, bwd = pb_weight_case(
            torch, f"{calib}, {n_clamped} of {S - 1} steps at the floor",
            pb_weight_inputs(torch, calib, S, M, n_clamped, 2), parent,
            float32_gate=True)
        pb["pb_weight_fwd"].append(fwd)
        pb["pb_weight_bwd"].append(bwd)
    pb["pb_weight_conditioning"] = [
        pb_conditioning_check(torch, calib, div)
        for calib, div in PB_CONDITIONING_CASES]
    return dict(encode, **pb, **render_kernel_cases(torch, parent),
                **march_kernel_cases(torch, parent),
                **occ_kernel_cases(torch),
                scatter_add_rows=scatter, gather_rows=gather,
                scatter_add_rows_call_split=splits,
                l2_reduction_rates=l2_rates, library_baselines=library)


def phase_step_inputs(torch, rows, captured, parent=None):
    """Phase 3's encode and weight-chain cases on the step's own inputs:
    the positions and cotangent that the steady flagship step (phase 4)
    and the steady EDS micro-step (phase 7) fed the encode backward
    (`capture_encode_inputs`), at their layouts, and the parameters,
    intensities, steps and weight cotangent they fed the weight-chain
    backward (`capture_pb_inputs`), and these with a seeded normal
    cotangent in every column (the dense case: the zero-cotangent skip
    must not hide the full path); the render kernels on the
    compactions and the composite of the same steps
    (`render_step_cases`); and the occupancy kernels on the trainers' own
    grids and fields (`occ_step_cases`); the rows join phase 3's."""
    import numpy as np

    for (name, config), label in zip(ENCODE_CASES, ("flagship", "EDS")):
        layout = encode_layout(torch, config())
        got = captured[label]
        if tuple(got["levels"]) != tuple(layout[0]) \
                or got["table_rows"] != layout[1]:
            raise AssertionError(f"{label}: the step's encode layout "
                                 f"{got['levels']} is not phase 3's")
        u, g = got["u"].cuda(), got["g"].cuda()
        live = int((g != 0).any(-1).sum())
        print(f"{label} step's encode inputs: N = {u.shape[0]}, "
              f"{live} samples with a non-zero cotangent", flush=True)
        fwd, bwd = encode_case(torch, f"N = K + 1: {name}", layout, u, g,
                               "step", parent and parent["encode"])
        rows["hash_encode_fwd"].append(fwd)
        rows["hash_encode_bwd"].append(bwd)
        del u, g
        torch.cuda.empty_cache()
        case = {k: v.cuda() if hasattr(v, "cuda") else v
                for k, v in got["pb"].items()}
        dense = dict(case, g=torch.from_numpy(
            np.random.default_rng(0).standard_normal(tuple(case["g"].shape))
            .astype(np.float32)).cuda())
        for shape, inputs in ((f"{label} step's own inputs", case),
                              (f"{label} step's own inputs, every "
                               f"cotangent non-zero", dense)):
            fwd, bwd = pb_weight_case(torch, shape, inputs, parent)
            rows["pb_weight_fwd"].append(fwd)
            rows["pb_weight_bwd"].append(bwd)
        del case, dense
        for kernel, found in render_step_cases(torch, label, got["render"],
                                               parent).items():
            rows[kernel] += found
        for kernel, found in occ_step_cases(torch, label, got["occupancy"],
                                            parent).items():
            rows[kernel] += found
        del got["occupancy"]
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the pixel-bandwidth weight chain (csrc/pb_weight.cu, ops/pb_weight.py)

# no Pallas kernel: the JAX package's rematerialized weight chain, which
# XLA compiles, and its VJP
PB_WEIGHT_SOURCE = "deblur_e_nerf_tpu_torch/csrc/pb_weight.cu"
PB_WEIGHT_REPLACES = "deblur_e_nerf_tpu/models/pixel_bandwidth.py:282"
# tests/test_torch_pixel_bandwidth.py's calibrations: (calibration,
# min_ts, f_c_dominant_min)
PB_CALIBRATIONS = {
    "default": ({
        "input_time_const_eff_it_prod": 1e-4,
        "miller_time_const_eff_it_prod": 2e-5,
        "amplifier_gain": 50.0, "closed_loop_gain": 10.0,
        "output_time_const": 1e-4, "sf_cutoff_freq": 500.0,
        "diff_amp_cutoff_freq": 200.0}, 0, 21.0),
    "stiff": ({
        "input_time_const_eff_it_prod": 8e-4,
        "miller_time_const_eff_it_prod": 1.6e-4,
        "amplifier_gain": 50.0, "closed_loop_gain": 10.0,
        "output_time_const": 8e-4, "sf_cutoff_freq": 62.5,
        "diff_amp_cutoff_freq": 25.0}, 1_000_000_000, 4.0),
}
# S = 30 samples over R = 4 render slices of N = 429 events, the flagship
# step's active events at its default batch (the step itself runs the
# chain over its batch capacity, 4 x 8192 columns, phase "3b")
PB_STEP_SHAPE = (30, 4 * 429)
# the forward's tolerance against the plain chain, of its largest weight:
# 5e-5 as the plain port is held to JAX on a few events
# (test_weights_with_x0_dir_match_jax), and PB_STEP_FORWARD_ATOL on
# step-scale inputs: phase 3's PB_CASES are held to the float32 plain
# chain within it as well (their inputs are fixed; the kernel's worst
# reading on an H100 was 6.6e-5, stiff with 5 clamped steps), where the
# steps' own inputs, which change from run to run, read up to 1.049e-4
# (ROADMAP C13)
PB_FORWARD_ATOL = 5e-5
PB_STEP_FORWARD_ATOL = 1e-4
# on step-scale inputs (every case of `pb_accuracy_check`) the float32
# chain can be ill-conditioned, and two float32 roundings of it (the
# kernel's fused multiply-adds, the plain chain's separately rounded
# products) drift apart while both stay as far from the exact value
# (ROADMAP C13); there each column of the kernels' output (each column is
# a chain of its own; each of the 7 packed parameters' cotangents is a
# column) is held to the plain chain in float64, no farther from it than
# PB_STEP_FACTOR times the float32 plain chain's same column plus a slack:
# PB_STEP_FORWARD_ATOL of the largest weight (forward), or
# PB_STEP_BACKWARD_SLACK of the CPU tests' tolerance (backward, the error
# over tolerance of `pb_weight_errors`). A well-conditioned column (the
# float32 plain chain near exact) is thus held within the slack of the
# exact value, an ill-conditioned one within 25% of the plain chain's own
# error there
PB_STEP_FACTOR = 1.25
PB_STEP_BACKWARD_SLACK = 1.0
# phase 3's synthetic cases: (calibration, S, M, steps at the 100 ns floor)
PB_CASES = (("default", 30, 4 * 429, 0), ("stiff", 30, 4 * 429, 5),
            ("stiff", 30, 4 * 429, 29))
# synthetic cases of the step's 32,768 columns on which the float32 chain
# is ill-conditioned: (calibration, the divisor of pb_weight_inputs's
# steps): 12.5-375 us, 33-1,000 ns (partly below the 100 ns floor) and
# 100-3,000 ns
PB_CONDITIONING_CASES = (("default", 8), ("default", 3000),
                         ("default", 1000))
# float32 operations, counted by hand from csrc/pb_weight.cu (a fused
# multiply-add 2, a division 1): per system, fixed and per squaring; per
# system and output row, the scan's. The forward's; the backward's reverse
# passes alone (the scan's reverse, the FOH, expm and linearization in
# reverse). The reverse needs the forward's intermediates, which no input
# of the function holds, so the backward's bound counts PB_FWD_OPS +
# PB_REVERSE_OPS, over the columns whose cotangent is not zero (a zero
# column's cotangents are 0: no operation), and no bytes for the systems
# the forward saves: they are the design's, in place of that recompute,
# as is the finiteness byte. What the kernel
# adds beyond that (a..a6 built twice, the squarings rebuilt from their
# checkpoints when s > 5) is the design's, not the function's.
PB_FWD_OPS = (1530, 112, 43)
PB_REVERSE_OPS = (2400, 240, 92)
PB_BWD_OPS = tuple(f + r for f, r in zip(PB_FWD_OPS, PB_REVERSE_OPS))


def pb_weight_inputs(torch, calib, S, M, n_clamped, n_out, seed=0,
                     device="cuda"):
    """A synthetic weight-chain case from a numpy seed: {params (the
    packed (7,) parameters of the calibration), intensity (S, M) in
    [0.05, 1.1], dt (S-1, M) in [1e5, 3e6] ns with the first `n_clamped`
    steps at the 100 ns floor, g (S, M, o) normal, n_out}, float32 on
    `device`."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.models import pixel_bandwidth

    cal, min_ts, f_c = PB_CALIBRATIONS[calib]
    raw, consts = pixel_bandwidth.init_pixel_bandwidth(
        cal, min_ts, f_c, 0.95, device=device)
    rng = np.random.default_rng(seed)
    it = rng.uniform(0.05, 1.1, (S, M)).astype(np.float32)
    dt = rng.uniform(1e5, 3e6, (S - 1, M)).astype(np.float32)
    dt[:n_clamped] = pixel_bandwidth.MIN_SAMPLE_DT_NS
    g = rng.standard_normal((S, M, n_out)).astype(np.float32)
    with torch.no_grad():
        params = pixel_bandwidth.packed_params(raw, consts)
    return {"params": params, "n_out": n_out,
            **{k: torch.from_numpy(v).to(device)
               for k, v in (("intensity", it), ("dt", dt), ("g", g))}}


def pb_weight_run(torch, fn, case):
    """(weights, [the cotangents of intensity, dt and the packed
    parameters]) of fn(params, intensity, dt, o) on a case, by autograd
    from its cotangent g."""
    inputs = [case[k].detach().requires_grad_()
              for k in ("params", "intensity", "dt")]
    w = fn(*inputs, case["n_out"])
    grads = torch.autograd.grad(w, inputs, case["g"])
    return w.detach(), [grads[1], grads[2], grads[0]]


def pb_weight_errors(torch, got, want):
    """The cotangents of intensity, dt and the packed parameters in `got`
    against `want`, at the tolerances of the CPU tests
    (tests/test_torch_pb_weight.py): |a - b| <= rtol |b| + atol with rtol
    1e-3 and atol 1e-3 of the intensity or parameter gradient's largest
    entry, 2e-2 of the dt gradient's. Returns ({name: the largest
    |a - b| / (rtol |b| + atol)} (at most 1 passes; inf where an entry
    NaN in want is not NaN in got), the largest |a - b|), over the
    entries finite in want."""
    ratios, max_abs = {}, 0.0
    for name, a, b, tol in zip(("intensity", "dt", "params"), got, want,
                               (1e-3, 2e-2, 1e-3)):
        if not bool(torch.isnan(a)[torch.isnan(b)].all()):
            ratios[name] = math.inf
            continue
        finite = torch.isfinite(b)
        a, b = a[finite].double(), b[finite].double()
        if a.numel() == 0:
            continue
        diff = (a - b).abs()
        atol = tol * float(b.abs().max())
        ratios[name] = float((diff / (1e-3 * b.abs() + atol + 1e-300)).max())
        max_abs = max(max_abs, float(diff.max()))
    return ratios, max_abs


def pb_live_columns(torch, g):
    """The columns (M,) whose weight cotangent g (S, M, o) is not zero."""
    return (g != 0).any(0).any(-1).reshape(-1)


def pb_weight_bound(torch, case, backward):
    """(bound_ms, bound_by, squarings, the bound over every column) of one
    kernel call on a case: each of the function's inputs read once and
    each of its outputs written once (the forward reads the parameters,
    intensities and steps and writes the weights; the backward reads these
    and the weights' cotangent and writes the cotangents of the
    parameters, intensities and steps; the saved systems and the
    finiteness byte are the design's), and the float32 operations of
    PB_FWD_OPS (forward) or PB_FWD_OPS +
    PB_REVERSE_OPS (backward) with each system's own squaring count; the
    backward's over the live columns (`pb_live_columns`), its fourth value
    over every column."""
    from deblur_e_nerf_tpu_torch.models import pixel_bandwidth
    from deblur_e_nerf_tpu_torch.ops import linalg, pb_weight

    it, dt, o = case["intensity"], case["dt"], case["n_out"]
    S, M = it.shape[0], it[0].numel()
    with torch.no_grad():
        A, _, _ = pb_weight._linearize(case["params"], it[1:])
        s = linalg.squaring_count(
            A * (pixel_bandwidth.NS_TO_S * dt)[..., None, None]
        ).reshape(S - 1, M)
        live = pb_live_columns(torch, case["g"]) if backward \
            else torch.ones(M, dtype=torch.bool, device=s.device)
        n_live = int(live.sum())
        squarings, squarings_all = int(s[:, live].sum()), int(s.sum())
    ops = [PB_FWD_OPS] + ([PB_REVERSE_OPS] if backward else [])
    fixed, per_squaring, per_row = (sum(c) for c in zip(*ops))

    def count(n, n_sq):
        return fixed * (S - 1) * n + per_squaring * n_sq \
            + per_row * (S - 1) * n * o

    nbytes = 4 * (7 + S * M + (S - 1) * M + S * M * o)
    if backward:
        nbytes += 4 * (S * M + (S - 1) * M + 7)
    all_ms = bound(nbytes, count(M, squarings_all))[0]
    ms, by = bound(nbytes, count(n_live, squarings))
    return ms, by, squarings, all_ms


def pb_forward_error(torch, got, want):
    """The forward kernel's weights `got` against the plain chain's `want`:
    (the largest |got - want| over the entries finite in `want`, the
    largest |want| there, whether `got` is NaN exactly where `want` is and
    equal to it where it is infinite). A NaN or an infinity in `got`
    where `want` is finite makes the error NaN or infinite."""
    fin = torch.isfinite(want)
    err = float((got[fin].double() - want[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    inf = torch.isinf(want)
    same_nonfinite = bool(torch.equal(torch.isnan(got), torch.isnan(want))) \
        and bool(torch.equal(got[inf], want[inf]))
    return err, scale, same_nonfinite


def pb_kernel_runs(torch, case):
    """The two weight-chain kernels through `pb_weight.weight`, run twice
    on a case: (weights, cotangents (`pb_weight_run`), whether the two
    runs are equal bit for bit, (forward, backward) launches over both)."""
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    launches = (pb_weight.FORWARD_LAUNCHES, pb_weight.BACKWARD_LAUNCHES)
    w_k, g_k = pb_weight_run(torch, pb_weight.weight, case)
    w_k2, g_k2 = pb_weight_run(torch, pb_weight.weight, case)
    launches = (pb_weight.FORWARD_LAUNCHES - launches[0],
                pb_weight.BACKWARD_LAUNCHES - launches[1])
    bits = lambda t: t.view(torch.int32)  # noqa: E731  (NaN == NaN)
    bitwise = bool(torch.equal(bits(w_k), bits(w_k2))) and all(
        torch.equal(bits(a), bits(b)) for a, b in zip(g_k, g_k2))
    return w_k, g_k, bitwise, launches


def pb_weight_check(torch, case, fwd_atol=PB_FORWARD_ATOL):
    """The two weight-chain kernels (through `pb_weight.weight`, twice) on
    a case against the plain chain on the card: the weights within
    `fwd_atol` of the plain version's largest, NaN exactly where it has
    NaN (`pb_forward_error`); the cotangents by `pb_weight_errors`; the
    two runs bit for bit. Returns a dict of the findings, "ok" among
    them."""
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    w_k, g_k, bitwise, launches = pb_kernel_runs(torch, case)
    w_p, g_p = pb_weight_run(torch, pb_weight.weight_reference, case)
    torch.cuda.synchronize()
    fwd_err, fwd_scale, same_nonfinite = pb_forward_error(torch, w_k, w_p)
    fwd_ok = fwd_err <= fwd_atol * fwd_scale and same_nonfinite
    ratios, bwd_err = pb_weight_errors(torch, g_k, g_p)
    bwd_ok = all(r <= 1 for r in ratios.values())
    return {"fwd_err": fwd_err, "fwd_scale": fwd_scale,
            "fwd_tolerance": fwd_atol * fwd_scale, "fwd_ok": fwd_ok,
            "ratios": ratios, "bwd_err": bwd_err, "bwd_ok": bwd_ok,
            "bitwise": bitwise, "launches": launches,
            "ok": fwd_ok and bwd_ok and bitwise and launches == (2, 2)}


def pb_plain_references(torch, case):
    """(weights, cotangents) of the plain chain on a case in float32, then
    in float64 (`pb_weight_run`)."""
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    c64 = dict(case, **{k: case[k].double()
                        for k in ("params", "intensity", "dt", "g")})
    return (pb_weight_run(torch, pb_weight.weight_reference, case),
            pb_weight_run(torch, pb_weight.weight_reference, c64))


def pb_columns(t, M):
    """`t`'s entries by column, (rows, M, rest): the weights (S, *batch,
    o), the intensities' cotangent (S, *batch) and the steps' (S - 1,
    *batch) have M columns; the packed parameters' cotangent (7,) is 7
    columns of one entry (each sums over every column)."""
    return t.reshape(1, -1, 1) if t.dim() == 1 \
        else t.reshape(t.shape[0], M, -1)


def pb_column_errors(torch, got, exact, tol, M):
    """Each column's (`pb_columns`) largest |got - exact| / tol over the
    entries finite in `exact`, NaN where `got` is NaN there; `tol` a
    number or a tensor of exact's shape."""
    r = (got.double() - exact.double()).abs() / tol
    r = torch.where(torch.isfinite(exact), r, torch.zeros_like(r))
    return pb_columns(r, M).amax((0, 2))


def pb_column_rule(torch, kernel, plain, exact, tol, M, slack):
    """The kernel held to `exact` column by column (`pb_column_errors`
    over `tol`): e(kernel) <= PB_STEP_FACTOR e(plain) + slack in every
    column. Returns {reading: the largest e(kernel) / limit over the
    columns (at most 1 passes; inf where the kernel is NaN or infinite
    where `exact` is finite), kernel, plain, limit: at that column,
    kernel_max, plain_max: the largest e over every column, columns,
    well_conditioned: the columns where PB_STEP_FACTOR e(plain) <= slack
    (the kernel held within twice the slack of the exact value),
    well_reading: the largest reading among them}."""
    e_k = pb_column_errors(torch, kernel, exact, tol, M)
    e_p = pb_column_errors(torch, plain, exact, tol, M)
    limit = PB_STEP_FACTOR * e_p + slack
    reading = torch.nan_to_num(e_k / limit, nan=math.inf)
    j = int(reading.argmax())
    well = PB_STEP_FACTOR * e_p <= slack
    return {"reading": float(reading[j]), "kernel": float(e_k[j]),
            "plain": float(e_p[j]), "limit": float(limit[j]),
            "kernel_max": float(e_k.max()), "plain_max": float(e_p.max()),
            "columns": reading.numel(), "well_conditioned": int(well.sum()),
            "well_reading": float(reading[well].max()) if bool(well.any())
            else 0.0}


def pb_accuracy_check(torch, case, fwd_atol=PB_STEP_FORWARD_ATOL,
                      references=None, float32_gate=False):
    """The two weight-chain kernels (through `pb_weight.weight`, twice) on
    a step-scale case, held to the plain chain in float64 (the exact
    value) column by column, no farther than PB_STEP_FACTOR times the
    float32 plain chain's same column plus a slack (`pb_column_rule`;
    ROADMAP C13):
      - forward: each column's largest |w - w64| over the entries finite
        in w64, of w64's largest magnitude, within PB_STEP_FACTOR times
        the float32 plain chain's plus fwd_atol; NaN exactly where the
        float32 plain chain has NaN (`pb_forward_error`);
      - backward: for each cotangent (intensity, dt, the packed
        parameters), each column's largest error over the CPU tests'
        tolerance against the float64 chain's cotangent (that of
        `pb_weight_errors`) within PB_STEP_FACTOR times the float32 plain
        chain's plus PB_STEP_BACKWARD_SLACK, and no NaN or infinity where
        the float32 plain chain's cotangent has none;
      - the two runs bit for bit, and one launch of each kernel a run
        (none on CPU tensors, where `weight` runs the plain chain);
      - with `float32_gate` (phase 3's PB_CASES, whose inputs are fixed),
        also against the float32 plain chain as `pb_weight_check` holds
        it: the weights within fwd_atol of its largest, the cotangents
        within the CPU tests' tolerances.
    Without the gate the kernels against the float32 plain chain (the
    weights' error of its largest, the cotangents' error over tolerance)
    are readings. `references` (`pb_plain_references`) saves recomputing
    the plain chains. Returns a dict of the findings, "ok" among them."""
    expected = (2, 2) if case["intensity"].is_cuda else (0, 0)
    M = case["intensity"][0].numel()
    w_k, g_k, bitwise, launches = pb_kernel_runs(torch, case)
    (w_p, g_p), (w64, g64) = references or pb_plain_references(torch, case)
    # against the float32 plain chain: NaN placement, readings or the gate
    fwd_err, fwd_scale, same_nonfinite = pb_forward_error(torch, w_k, w_p)
    ratios, bwd_err = pb_weight_errors(torch, g_k, g_p)
    float32_ok = fwd_err <= fwd_atol * fwd_scale \
        and all(r <= 1 for r in ratios.values())
    # forward against float64, column by column
    fin = torch.isfinite(w64)
    scale64 = float(w64[fin].abs().max()) if bool(fin.any()) else 1.0
    fwd = pb_column_rule(torch, w_k, w_p, w64, scale64, M, fwd_atol)
    fwd_reading = fwd["reading"] if same_nonfinite else math.inf
    # backward against float64, column by column, at pb_weight_errors'
    # tolerances
    bwd = {}
    for name, k, p, b, atol in zip(("intensity", "dt", "params"), g_k, g_p,
                                   g64, (1e-3, 2e-2, 1e-3)):
        finite = torch.isfinite(b)
        if not bool(finite.any()):
            continue
        tol = 1e-3 * b.abs() + atol * float(b[finite].abs().max()) + 1e-300
        bwd[name] = pb_column_rule(torch, k, p, b, tol, M,
                                   PB_STEP_BACKWARD_SLACK)
    bwd_readings = {n: d["reading"] for n, d in bwd.items()}
    fwd_ok = fwd_reading <= 1
    bwd_ok = all(r <= 1 for r in bwd_readings.values()) \
        and all(math.isfinite(r) for r in ratios.values())
    return {"fwd": fwd, "fwd_reading": fwd_reading, "fwd_ok": fwd_ok,
            "bwd": bwd, "bwd_readings": bwd_readings, "bwd_ok": bwd_ok,
            "fwd_err": fwd_err, "fwd_scale": fwd_scale,
            "fwd_tolerance": fwd_atol * fwd_scale,
            "same_nonfinite": same_nonfinite, "ratios": ratios,
            "bwd_err": bwd_err, "float32_gate": float32_gate,
            "float32_ok": float32_ok, "bitwise": bitwise,
            "launches": launches,
            "reading": max([fwd_reading, *bwd_readings.values()]),
            "ok": fwd_ok and bwd_ok and bitwise and launches == expected
            and (float32_ok or not float32_gate)}


def pb_accuracy_text(c):
    """`pb_accuracy_check`'s readings and limits, for the log."""
    def rule(d):
        return (f"reading / limit {d['reading']:.6f} (column error kernel "
                f"{d['kernel']:.4e}, float32 plain chain {d['plain']:.4e}, "
                f"limit {d['limit']:.4e}); largest column error kernel "
                f"{d['kernel_max']:.4e}, plain {d['plain_max']:.4e}; "
                f"{d['well_conditioned']} of {d['columns']} columns "
                f"well-conditioned, their reading / limit "
                f"{d['well_reading']:.6f}")

    bwd = "; ".join(f"{n}: {rule(d)}" for n, d in c["bwd"].items())
    ratios = json.dumps({k: float(f"{v:.4g}") for k, v in
                         c["ratios"].items()})
    return (f"against the float64 plain chain, column by column: forward "
            f"(of the largest weight) {rule(c['fwd'])}; NaN as the float32 "
            f"plain chain: {c['same_nonfinite']}; backward (error / "
            f"tolerance) {bwd}; against the float32 plain chain "
            f"({'gate' if c['float32_gate'] else 'reading'}, within "
            f"{c['float32_ok']}): forward {c['fwd_err']:.3e} of "
            f"{c['fwd_scale']:.3e} ("
            f"{c['fwd_err'] / max(c['fwd_scale'], 1e-30):.4e}, limit "
            f"{c['fwd_tolerance'] / max(c['fwd_scale'], 1e-30):g} of the "
            f"largest), backward error / tolerance {ratios}; two runs bit "
            f"identical {c['bitwise']}; launches {c['launches']}; ok "
            f"{c['ok']}")


def pb_conditioning_case(torch, calib, div, M=32768, device="cuda"):
    """A synthetic weight-chain case of M columns (S = 30, default seed)
    on which the float32 chain is ill-conditioned: pb_weight_inputs's
    steps divided by `div`."""
    case = pb_weight_inputs(torch, calib, PB_STEP_SHAPE[0], M, 0, 2,
                            device=device)
    case["dt"] = case["dt"] / div
    return case


def pb_conditioning_check(torch, calib, div):
    """`pb_accuracy_check` on a conditioning case of the step's 32,768
    columns (`pb_conditioning_case`), printed; raises where it fails.
    Returns the check's findings."""
    case = pb_conditioning_case(torch, calib, div)
    S, M = case["intensity"].shape
    c = pb_accuracy_check(torch, case)
    print(f"pb_weight conditioning ({calib}, S={S} M={M}, steps "
          f"{float(case['dt'].min()):.1f}-{float(case['dt'].max()):.1f} "
          f"ns): {pb_accuracy_text(c)}", flush=True)
    if not c["ok"]:
        raise AssertionError(f"pb_weight conditioning ({calib}, steps / "
                             f"{div}): a column of the kernels is farther "
                             f"from the float64 chain than the float32 plain "
                             f"chain's allows, their NaNs differ, or the "
                             f"runs or launches differ")
    return c


def pb_accuracy_summary(rows):
    """Print each step-scale weight-chain check's largest reading over its
    limit (`pb_accuracy_check`; at most 1 passes), forward (also over the
    well-conditioned columns alone) and backward, and its kernels against
    the float32 plain chain (the forward's error over PB_STEP_FORWARD_ATOL
    of the largest weight, the backward's largest error over tolerance):
    phase 3's PB_CASES (held to both), "3b"'s cases and the conditioning
    cases."""
    readings = []
    for fwd, bwd in zip(rows["pb_weight_fwd"], rows["pb_weight_bwd"]):
        readings.append((fwd["shape"], fwd["float64_rule"],
                         bwd["float64_rule"], fwd["float32_gate"],
                         fwd["max_abs_err"] / fwd["float32_tolerance"],
                         max(bwd["error_ratios"].values())))
    for (calib, div), c in zip(PB_CONDITIONING_CASES,
                               rows["pb_weight_conditioning"]):
        readings.append((f"conditioning {calib}, steps / {div}", c["fwd"],
                         c["bwd"], c["float32_gate"],
                         c["fwd_err"] / c["fwd_tolerance"],
                         max(c["ratios"].values())))
    for name, fwd, bwd, gate, f32_fwd, f32_bwd in readings:
        print(f"pb_weight accuracy (C13) {name}: float64 rule, reading / "
              f"limit forward {fwd['reading']:.6f} (well-conditioned "
              f"columns {fwd['well_reading']:.6f}, {fwd['well_conditioned']}"
              f" of {fwd['columns']}), backward "
              f"{max(d['reading'] for d in bwd.values()):.4f}; against the "
              f"float32 plain chain ({'gate' if gate else 'reading'}) "
              f"forward {f32_fwd:.4f}, backward {f32_bwd:.4f}", flush=True)
    gated = [r for r in readings if r[3]]
    print(f"pb_weight accuracy (C13): largest reading / limit over "
          f"{len(readings)} step-scale checks: float64 rule forward "
          f"{max(r[1]['reading'] for r in readings):.6f} (well-conditioned "
          f"columns {max(r[1]['well_reading'] for r in readings):.6f}), "
          f"backward "
          f"{max(d['reading'] for r in readings for d in r[2].values()):.4f}"
          f"; float32 gate over {len(gated)} checks forward "
          f"{max(r[4] for r in gated):.4f}, backward "
          f"{max(r[5] for r in gated):.4f}", flush=True)


def pb_weight_case(torch, name, case, parent=None, float32_gate=False):
    """`pb_accuracy_check` on a step-scale case (the kernels held to the
    plain chain in float64 column by column, no farther than the float32
    plain chain, and with `float32_gate` to the float32 plain chain as
    well, else against it as readings), then times:
    the forward
    kernel in turns with the plain chain's forward, the backward kernel
    (on the forward's finiteness byte and saved systems) in turns with the
    plain chain's forward and backward by autograd, each kernel, with
    `parent` (load_parent), in turns with the parent commit's kernels on
    the same inputs, `weight` forward and backward as the step runs it (in turns
    with the parent's chain as its step ran it), and the library's
    torch.linalg.matrix_exp (the expm part only) and its backward on the
    same (S - 1) M matrices. Returns (forward row, backward row)."""
    from deblur_e_nerf_tpu_torch.models import pixel_bandwidth
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    it, dt, g, o = case["intensity"], case["dt"], case["g"], case["n_out"]
    S, M = it.shape[0], it[0].numel()
    live = int(pb_live_columns(torch, g).sum())
    c = pb_accuracy_check(torch, case, float32_gate=float32_gate)
    p_det = case["params"]
    with torch.no_grad():
        _, finite, systems = pb_weight.weight_forward(p_det, it, dt, o)
    # times
    it_r = it.detach().requires_grad_()
    dt_r = dt.detach().requires_grad_()
    p_r = p_det.clone().requires_grad_()

    def step_like():
        return torch.autograd.grad(pb_weight.weight(p_r, it_r, dt_r, o),
                                   [it_r, dt_r, p_r], g)

    parent_step = parent_fwd = parent_bwd = None
    if parent is not None:
        # the parent's chain takes the raw parameters and constants
        from deblur_e_nerf_tpu_torch.ops import activations

        raw = {f"{n}_raw": activations.softplus_inverse(p_det[i]).clone()
               .requires_grad_()
               for i, n in enumerate(pixel_bandwidth.PARAM_NAMES)}
        consts = {"tau_in_it_eff_prod": p_det[6]}

        def parent_step():
            w = parent["pb"].intensity_sample_to_weight(
                raw, consts, it_r, dt_r, output_sf_log_it=o == 2)
            return torch.autograd.grad(w, [it_r, dt_r, *raw.values()], g)

        def parent_fwd():
            return parent["pb_ops"].weight_forward(p_det, it, dt, o)

        # a parent whose forward saves the finiteness byte and the
        # systems hands them to its backward; an older one returned the
        # weights alone
        saved = parent_fwd()
        saved = saved[1:] if isinstance(saved, tuple) else ()

        def parent_bwd():
            return parent["pb_ops"].weight_backward(p_det, it, dt, g, o,
                                                    *saved)

    def plain_fwd():
        with torch.no_grad():
            return pb_weight.weight_reference(p_det, it, dt, o)

    def plain_fwd_bwd():
        return torch.autograd.grad(pb_weight.weight_reference(
            p_r, it_r, dt_r, o), [it_r, dt_r, p_r], g)

    def fwd():
        return pb_weight.weight_forward(p_det, it, dt, o)

    def bwd():
        return pb_weight.weight_backward(p_det, it, dt, g, o, finite,
                                         systems)

    # each kernel in turns (a, b, b, a) with the plain chain and with the
    # parent's kernel; weight() as the step runs it with the parent's chain
    # (the kernels by graph replay: device time, without the wrappers'
    # host work, which exceeds a kernel's at M = 1,716)
    fwd_ms, fwd_runs, plain_fwd_ms, plain_fwd_runs = in_turns(
        fwd, plain_fwd, iters=10, timer=graph_ms)
    bwd_ms, bwd_runs, plain_bwd_ms, plain_bwd_runs = in_turns(
        bwd, plain_fwd_bwd, iters=10, timer=graph_ms)
    parent_fwd_ms = in_turns(fwd, parent_fwd, iters=10, timer=graph_ms,
                             parent_timer=graph_ms)
    parent_bwd_ms = in_turns(bwd, parent_bwd, iters=10, timer=graph_ms,
                             parent_timer=graph_ms)
    host_ms = (time_ms(fwd, 10), time_ms(bwd, 10))
    step_ms, step_runs, parent_ms, parent_runs = in_turns(
        step_like, parent_step, iters=10)
    del systems
    with torch.no_grad():
        A, _, _ = pb_weight._linearize(p_det, it[1:])
        a_dt = (A * (pixel_bandwidth.NS_TO_S * dt)[..., None, None]
                ).reshape(-1, 4, 4).contiguous()
    lib_fwd_ms = time_ms(lambda: torch.linalg.matrix_exp(a_dt))
    a_req = a_dt.clone().requires_grad_()
    cot = torch.randn_like(a_dt)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        torch.linalg.matrix_exp(a_req), a_req, cot))
    del a_dt, a_req, cot
    rows = []
    for backward, ms, runs, err, plain_ms, plain_runs, lib_ms, par \
            in ((False, fwd_ms, fwd_runs, c["fwd_err"], plain_fwd_ms,
                 plain_fwd_runs, lib_fwd_ms, parent_fwd_ms),
                (True, bwd_ms, bwd_runs, c["bwd_err"], plain_bwd_ms,
                 plain_bwd_runs, lib_bwd_ms, parent_bwd_ms)):
        bound_ms, bound_by, squarings, all_ms = pb_weight_bound(
            torch, case, backward)
        rows.append({
            "shape": name, "S": S, "M": M, "n_out": o, "live_columns": live,
            "squarings": squarings, "max_abs_err": err, "ms": ms,
            "ms_runs": runs, "plain_ms": plain_ms,
            "plain_ms_runs": plain_runs,
            "plain": "the plain chain's forward" if not backward else
                     "the plain chain's forward and backward (autograd)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_every_column": all_ms, "library_ms": lib_ms,
            "library_call": "torch.linalg.matrix_exp"
                            + (" backward" if backward else "")
                            + " of the same matrices (the expm part only)",
            "parent_kernel_ms": par[2], "parent_kernel_ms_runs": par[3],
            "in_turns_with_parent_ms_runs": par[1],
            "host_inclusive_ms": host_ms[backward],
            "bit_identical_runs": c["bitwise"],
            "launches_per_check": c["launches"]})
    rows[0].update(weight_scale=c["fwd_scale"],
                   float32_tolerance=c["fwd_tolerance"],
                   float32_gate=c["float32_gate"],
                   float32_within=c["float32_ok"], within=c["fwd_ok"],
                   float64_rule=c["fwd"], reading_over_limit=c["fwd_reading"])
    rows[1].update(error_ratios=c["ratios"], within=c["bwd_ok"],
                   float64_rule=c["bwd"],
                   reading_over_limit=c["bwd_readings"],
                   step_ms=step_ms,
                   step_ms_runs=step_runs, parent_step_ms=parent_ms,
                   parent_step_ms_runs=parent_runs)

    def runs_of(t):
        return [round(x, 4) for x in t]

    print(f"pb_weight {name}: S={S} M={M} o={o}, {live} of {M} columns "
          f"with a non-zero cotangent, {rows[0]['squarings']} squarings "
          f"({rows[1]['squarings']} in live columns); "
          f"{pb_accuracy_text(c)}", flush=True)
    print(f"pb_weight {name} times (ms): kernel (graph replay) fwd "
          f"{fwd_ms:.4f} {runs_of(fwd_runs)} bwd {bwd_ms:.4f} "
          f"{runs_of(bwd_runs)}, with the wrappers' host work "
          f"{host_ms[0]:.4f} / {host_ms[1]:.4f}; bound "
          f"{rows[0]['bound_ms']:.5f} / {rows[1]['bound_ms']:.5f} "
          f"({rows[0]['bound_by']} / {rows[1]['bound_by']}; backward over "
          f"every column {all_ms:.5f}); parent's kernels in turns: fwd "
          f"{runs_of(parent_fwd_ms[1])} vs {runs_of(parent_fwd_ms[3])}, "
          f"bwd {runs_of(parent_bwd_ms[1])} vs "
          f"{runs_of(parent_bwd_ms[3])}; plain fwd {plain_fwd_ms:.3f} "
          f"{runs_of(plain_fwd_runs)}, fwd + bwd {plain_bwd_ms:.3f} "
          f"{runs_of(plain_bwd_runs)}; matrix_exp {lib_fwd_ms:.4f}, its "
          f"backward {lib_bwd_ms:.4f}; weight() fwd + bwd as the step runs "
          f"it {step_ms:.4f} {runs_of(step_runs)}, parent {parent_ms} "
          f"{runs_of(parent_runs)}", flush=True)
    if not c["ok"]:
        raise AssertionError(f"pb_weight {name}: a column farther from the "
                             f"float64 chain than the float32 plain chain's "
                             f"allows, NaN where it is finite, outside the "
                             f"float32 gate, not reproducible or launched "
                             f"{c['launches']}")
    return rows


KERNEL_NAMES = {"scatter_add_rows": "scatter_add_rows_kernel",
                "gather_rows": "gather_rows_kernel",
                "hash_encode_fwd": "hash_encode_fwd_kernel",
                "hash_encode_bwd": "hash_encode_bwd_kernel",
                "pb_weight_fwd": "pb_weight_fwd_kernel",
                "pb_weight_bwd": "pb_weight_bwd_kernel",
                # the compaction's kernel (the first design's three:
                # compact_count, compact_scan, compact_write)
                "compact": "compact_",
                "composite_fwd": "composite_fwd_kernel",
                "composite_bwd": "composite_bwd_kernel",
                "march_masks": "march_masks_kernel",
                "march_coarse": "march_coarse_kernel",
                "march_samples": "march_samples_kernel",
                "march_decode": "march_decode_kernel",
                # the occupancy kernels' families (csrc/occupancy.cu)
                "occ_points": "occ_points_kernel",
                "occ_ema": "occ_ema_",
                "occ_threshold": "occ_threshold_",
                "occ_sample_occupied": "occ_sample_"}


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
    order."""
    from torch.autograd import DeviceType

    key = KERNEL_NAMES[name]
    calls = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA and key in e.name),
                   key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in calls]


def _per_call(prof):
    """The port's kernels' device ms per launch, in launch order (the
    warmup occupancy update's encode forwards follow the step's)."""
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


def _launch_counters():
    """{kernel: (its wrapper's module, the name of its launch count)}."""
    from deblur_e_nerf_tpu_torch.ops import (compact, composite, gather_rows,
                                             hash_encode, march, occupancy,
                                             pb_weight, scatter_rows)

    return {"scatter_add_rows": (scatter_rows, "LAUNCHES"),
            "gather_rows": (gather_rows, "LAUNCHES"),
            "hash_encode_fwd": (hash_encode, "FORWARD_LAUNCHES"),
            "hash_encode_bwd": (hash_encode, "BACKWARD_LAUNCHES"),
            "pb_weight_fwd": (pb_weight, "FORWARD_LAUNCHES"),
            "pb_weight_bwd": (pb_weight, "BACKWARD_LAUNCHES"),
            "compact": (compact, "LAUNCHES"),
            "composite_fwd": (composite, "FORWARD_LAUNCHES"),
            "composite_bwd": (composite, "BACKWARD_LAUNCHES"),
            "march_masks": (march, "MASKS_LAUNCHES"),
            "march_coarse": (march, "COARSE_LAUNCHES"),
            "march_samples": (march, "SAMPLES_LAUNCHES"),
            "march_decode": (march, "DECODE_LAUNCHES"),
            **{k: (occupancy, n) for k, n in OCC_COUNTERS.items()}}


def reset_launches():
    for module, name in _launch_counters().values():
        setattr(module, name, 0)


def read_launches():
    return {kernel: getattr(module, name)
            for kernel, (module, name) in _launch_counters().items()}


def encode_launches(forward, backward, filter_forward=0,
                    filter_backward=None, render=None):
    """The launches of a path that calls the field `forward` times, runs
    `backward` encode backwards and `filter_forward` weight-chain forwards
    (one a filter-on training step) and `filter_backward` backwards
    (default: as many): one fused encode kernel each, one weight-chain
    kernel each, and neither K1 nor K3 (the per-level encode's kernels,
    off every path since the encode was fused); with `render` (a
    `render_launches` dict), the render layer's kernels too. Compare with
    `launches_match`: the keys left out are not compared."""
    return {"scatter_add_rows": 0, "gather_rows": 0,
            "hash_encode_fwd": forward, "hash_encode_bwd": backward,
            "pb_weight_fwd": filter_forward,
            "pb_weight_bwd": (filter_forward if filter_backward is None
                              else filter_backward), **(render or {})}


def render_launches(rc, renders=1, trains=True, prepasses=0):
    """The render layer's launches for `renders` marches under the render
    config `rc` (two stream compactions each, three with the superblock
    stage; the march's kernels: one masks launch, one coarse stage, one
    sample stage and one decode, or with superblocks three masks launches
    and two coarse stages) and composites (one forward each, one backward
    each if it `trains`), with `prepasses` occlusion prepasses (a
    density-only composite forward and one three-channel compaction
    each)."""
    from deblur_e_nerf_tpu_torch.models import renderer

    sb = renderer.uses_superblocks(rc)
    return {"compact": renders * (3 if sb else 2) + prepasses,
            "composite_fwd": renders + prepasses,
            "composite_bwd": renders if trains else 0,
            "march_masks": renders * (3 if sb else 1),
            "march_coarse": renders * (2 if sb else 1),
            "march_samples": renders, "march_decode": renders}


def occupancy_launches(rc, warmups=0, sampled=0, priors=0,
                       prior_targeted=False, chunk=1 << 19):
    """The occupancy kernels' launches of `warmups` warmup and `sampled`
    sampled updates under the render config `rc` (a points and an EMA
    launch a chunk of `chunk` evaluated cells, one more EMA launch a
    sampled update, a threshold an update, a sampler a sampled update) and
    of `priors` sparsity priors (a points launch each, and a sampler
    launch with targeted cells)."""
    n = rc.grid_resolution ** 3
    w, s = -(-n // chunk), -(-(2 * (n // 4)) // chunk)
    return {"occ_points": warmups * w + sampled * s + priors,
            "occ_ema": warmups * w + sampled * (s + 1),
            "occ_threshold": warmups + sampled,
            "occ_sample_occupied": sampled + (priors if prior_targeted
                                              else 0)}


def prior_launches(trainer, steps=1):
    """`occupancy_launches`' keywords of `steps` steps' sparsity priors."""
    sc = trainer.bundle.static_config
    on = sc.loss_weight_sparsity > 0.0
    return dict(priors=steps if on else 0,
                prior_targeted=on and round(sc.sparsity_samples
                                            * sc.sparsity_targeted_fraction)
                > 0)


def frame_render_launches(render):
    """The render kernels' launches of the last frame that `render` (a
    `make_render_image_fn` renderer) drew: a march and a composite a ray
    chunk, and a prepass a ray chunk where its density pass ran."""
    stats = render.stats
    return render_launches(
        render.render_config, renders=stats["ray_chunks"], trains=False,
        prepasses=stats["ray_chunks"] if stats["density_chunks"] else 0)


def launches_match(got, want):
    """Whether `got` has `want`'s count for every kernel `want` names."""
    return all(got.get(k) == v for k, v in want.items())


def check_path_launches(path, counts, trains, filter_steps=0,
                        sampled=False):
    """A path launches the fused forward, the backward if it `trains` (and
    not if it does not), one weight-chain forward and one backward for
    each of its `filter_steps` filter-on training steps (none on an eval
    or filter-off path), neither K1 nor K3, the stream compaction and the
    composite forward, each of the march's kernels, and the composite
    backward if it `trains` (and not if it does not); a training path
    updates the grid (the occupancy points, EMA and threshold kernels),
    and runs the occupied-cell sampler if it ran a `sampled` update; an
    eval path launches no occupancy kernel."""
    occ = [counts[k] for k in OCC_KERNELS[:3]]
    if not ((all(occ) if trains else not any(occ))
            and (counts["occ_sample_occupied"] > 0) == sampled):
        raise AssertionError(f"{path}: occupancy launches "
                             f"{ {k: counts[k] for k in OCC_KERNELS} }, "
                             f"want {'an update' if trains else 'none'}"
                             f"{' with the sampler' if sampled else ''}")
    if not (counts["hash_encode_fwd"] > 0
            and (counts["hash_encode_bwd"] > 0) == trains
            and counts["pb_weight_fwd"] == counts["pb_weight_bwd"]
            == filter_steps
            and counts["scatter_add_rows"] == counts["gather_rows"] == 0
            and counts["compact"] > 0 and counts["composite_fwd"] > 0
            and all(counts[k] > 0 for k in MARCH_KERNELS)
            and (counts["composite_bwd"] > 0) == trains):
        raise AssertionError(f"{path}: launches {counts}, want "
                             f"{filter_steps} weight-chain launches a "
                             f"direction, the render kernels launched "
                             f"(the composite backward "
                             f"{'' if trains else 'not '}among them)")


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


def _planted_sync(torch):
    """One host sync, made here on purpose: the sync counter must find it
    (its self-check)."""
    return torch.ones(1, device="cuda").item()


@contextmanager
def capture_pb_inputs(store):
    """Record into `store` the inputs (clones on the card) of the first
    weight-chain backward run inside: (params, intensity, dt, g, n_out),
    the step's own. A wrapper around `pb_weight.weight_backward` while the
    block runs."""
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    real = pb_weight.weight_backward

    def recording(params, intensity, dt, g, n_out, *record):
        if not store:
            store.update(params=params.detach().clone(),
                         intensity=intensity.detach().clone(),
                         dt=dt.detach().clone(), g=g.detach().clone(),
                         n_out=n_out)
        return real(params, intensity, dt, g, n_out, *record)

    pb_weight.weight_backward = recording
    try:
        yield store
    finally:
        pb_weight.weight_backward = real


@contextmanager
def capture_encode_inputs(store):
    """Record into `store` the positions and cotangent (clones on the card)
    of the first encode backward run inside, with its levels and table
    rows: the inputs the step really feeds the encode kernels. A wrapper
    around `hash_encode.encode_backward` while the block runs."""
    from deblur_e_nerf_tpu_torch.ops import hash_encode

    real = hash_encode.encode_backward

    def recording(g, u, levels, table_rows):
        if not store:
            store.update(u=u.detach().clone(), g=g.detach().clone(),
                         levels=tuple(levels), table_rows=int(table_rows))
        return real(g, u, levels, table_rows)

    hash_encode.encode_backward = recording
    try:
        yield store
    finally:
        hash_encode.encode_backward = real


@contextmanager
def sync_sites(torch):
    """{source line: host syncs} of the block, under
    torch.cuda.set_sync_debug_mode("warn"): each sync attributed to the
    innermost line of the port on the stack (else its callers)."""
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

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def count_step_syncs(torch, trainer, label="flagship",
                     forbidden=("training/optim.py",), expected=None,
                     capture=None):
    """One steady step (past the occupancy warmup, off the occupancy
    schedule) under torch.cuda.set_sync_debug_mode("warn"): returns
    {source line: host syncs}, each sync attributed to the innermost line
    of the port on the stack, and prints it. Any sync of the step fails
    the run (since the weight chain became a kernel, the step reads no
    device value), and so do kernel launches other than `expected`
    (default: one fused encode forward and one backward, one weight-chain
    forward and one backward). The counter's self-check: one sync planted
    just before the step (`_planted_sync`) must be counted, once. With a
    dict `capture`, the step's encode inputs go into it
    (`capture_encode_inputs`) and its weight-chain inputs into
    capture["pb"] (`capture_pb_inputs`), moved to the host after the
    step. `forbidden` names the files whose syncs the message singles
    out."""
    trainer.global_step = int(trainer.params.nerf.occ_grid_config
                              .warmup_steps) + 1
    torch.cuda.synchronize()
    reset_launches()
    pb, render = {}, {}
    with sync_sites(torch) as sites, \
            capture_encode_inputs({} if capture is None else capture), \
            capture_pb_inputs(pb), \
            (capture_render_inputs(render) if capture is not None
             else nullcontext()):
        _planted_sync(torch)
        trainer.train_step()
    torch.cuda.synchronize()
    if capture is not None:
        for key in ("u", "g"):
            capture[key] = capture[key].cpu()
        capture["pb"] = {k: v.cpu() if hasattr(v, "cpu") else v
                         for k, v in pb.items()}
        capture["render"] = _to_device(render, "cpu")
    launches = read_launches()
    planted = {site: n for site, n in sites.items() if "_planted_sync" in site}
    step_sites = {site: n for site, n in sites.items() if site not in planted}
    print(f"host syncs in one steady {label} step: "
          f"{sum(step_sites.values())} ({step_sites}); the planted sync "
          f"counted {sum(planted.values())} time(s); kernel launches "
          f"{launches}", flush=True)
    if expected is None:
        rc = trainer.params.nerf.render_config
        expected = encode_launches(1, 1, 1, render=dict(
            render_launches(rc), **occupancy_launches(
                rc, **prior_launches(trainer))))
    if not launches_match(launches, expected):
        raise AssertionError(f"a steady {label} step launches {launches}, "
                             f"want {expected}")
    if sum(planted.values()) != 1:
        raise AssertionError(f"the sync counter missed the planted sync: "
                             f"{sites}")
    if step_sites:
        raise AssertionError(
            f"{label}: a steady step made host syncs {step_sites}"
            + (f" (in {forbidden})" if any(f in site for site in step_sites
                                           for f in forbidden) else ""))
    return step_sites


def census_step(torch, trainer, label="flagship"):
    """Operator calls by layer (op_census.count_ops) of one steady step and
    of one occupancy update, sampled and warmup, printed; the step's
    weight chain must be its kernels' wrapper alone. Also printed: the
    operator calls of the plain chain that the kernels replace, forward
    and backward under torch.utils.checkpoint as the step ran it before,
    on the card at PB_STEP_SHAPE (default calibration)."""
    from torch.utils import checkpoint

    from deblur_e_nerf_tpu_torch import op_census
    from deblur_e_nerf_tpu_torch.ops import pb_weight

    warmup = int(trainer.params.nerf.occ_grid_config.warmup_steps)
    trainer.global_step = warmup + 1
    counts, _ = op_census.count_ops(trainer.train_step)
    torch.cuda.synchronize()
    print(f"operator calls by layer in one steady {label} step: "
          f"{json.dumps(counts)}", flush=True)
    chain = counts.get("B8 weight chain", {"forward": 0, "backward": 0})
    if sum(chain.values()) > 20:
        raise AssertionError(f"{label}: the weight chain ran {chain} "
                             f"operators")
    # the march: its kernels and compactions, with their allocations and
    # the offsets' cumsum
    march = counts.get("B4 march", {"forward": 0, "backward": 0})
    print(f"{label}: the march ran {march['forward']} operators forward "
          f"(at most {MARCH_MAX_OPS})", flush=True)
    if march["forward"] > MARCH_MAX_OPS or march["backward"]:
        raise AssertionError(f"{label}: the march ran {march} operators")
    rc = trainer.params.nerf.render_config
    for kind, step in (("sampled", warmup), ("warmup", 0)):
        occ, _ = op_census.count_ops(lambda: trainer.update_occupancy(step))
        torch.cuda.synchronize()
        print(f"operator calls by layer in one {kind} {label} occupancy "
              f"update: {json.dumps(occ)}", flush=True)
        b7 = occ.get("B7 occupancy update", {"forward": 0})
        launches = b7.get("launches", {})
        want = occupancy_launches(rc, **{("warmups" if kind == "warmup"
                                          else "sampled"): 1})
        ops_bound = want["occ_points"] + 2 + (kind == "sampled")
        print(f"{label} {kind} update: {b7['forward']} operators outside "
              f"the field (at most {ops_bound}: an allocation a kernel "
              f"call), the field's {occ.get('B7 occupancy update: field')}, "
              f"kernel entry-point calls {launches}", flush=True)
        if b7["forward"] > ops_bound or b7.get("backward") or {
                k: launches.get(v, 0) for k, v in OCC_COUNTERS.items()} \
                != want:
            raise AssertionError(f"{label} {kind} update: {b7} operators "
                                 f"and launches, want launches {want}")
        torch.cuda.synchronize()
        with sync_sites(torch) as sites:
            trainer.update_occupancy(step)
        torch.cuda.synchronize()
        print(f"host syncs in one {kind} {label} occupancy update: "
              f"{sum(sites.values())} ({sites})", flush=True)
        if sites:
            raise AssertionError(f"{label}: a {kind} occupancy update made "
                                 f"host syncs {sites}")
    case = pb_weight_inputs(torch, "default", *PB_STEP_SHAPE, 0, 2)
    plain, _ = op_census.count_ops(lambda: pb_weight_run(
        torch, lambda *a: checkpoint.checkpoint(
            pb_weight.weight_reference, *a, use_reentrant=False), case))
    torch.cuda.synchronize()
    print(f"operator calls of the plain weight chain, checkpointed, at "
          f"(S, M) = {PB_STEP_SHAPE}: {json.dumps(plain)}", flush=True)
    return counts


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


def phase_training(torch, tmp, profile=False, capture=None, parent=None):
    """Both paths; returns ({path: {kernel: launches}}, the flagship
    trainer, the dataset directory). The steady flagship step's encode
    inputs go into the dict `capture`. With `parent`, steady steps are
    timed in turns with the parent checkout's render scans."""
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
    count_step_syncs(torch, trainer, capture=capture)
    trainer._flush_pending_metrics()
    if capture is not None:
        capture["occupancy"] = capture_occupancy(trainer)
    census_step(torch, trainer)
    trainer._flush_pending_metrics()
    if parent is not None:
        steps_in_turns(torch, trainer, parent, "flagship (filter on)")
    if profile:
        profile_steps(torch, trainer)
    for path, counts in launches.items():
        print(f"training, {path}: launches {counts}", flush=True)
        check_path_launches(path, counts, trains=True,
                            filter_steps=3 if path == "filter on" else 0,
                            sampled=path == "filter off")
    rc = trainer.params.nerf.render_config
    for path, want in (("filter off", occupancy_launches(rc, 2, 1)),
                       ("filter on", occupancy_launches(rc, 3))):
        if not launches_match(launches[path], want):
            raise AssertionError(f"training, {path}: occupancy launches "
                                 f"{launches[path]}, want {want}")
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
    profiled, with its kernel launches (one fused encode forward per field
    call), then the card-vs-CPU eval render.
    Returns {"eval": launches of evaluate("val"), "eval frame": launches
    of one frame}."""

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deblur_e_nerf_tpu_torch.data import posed_images
    from deblur_e_nerf_tpu_torch.training import evaluation

    card = torch.cuda.get_device_name(0)
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
    check_path_launches("eval val", val_launches, trains=False)

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
    want = encode_launches(stats["field_chunks"], 0,
                           render=frame_render_launches(render))
    if not (launches_match(frame_launches, want)
            and stats["field_chunks"] > 0):
        raise AssertionError(f"eval frame launches {frame_launches}, want "
                             f"{want}")
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


def check_eds_epoch(records, occ_calls, accumulate, rc):
    """Phase 7's checks of epoch 0's micro-steps (`rc` the render
    config)."""
    # the warmup update's field calls, of 2^19 cells each
    chunks = -(-(rc.grid_resolution ** 3) // (1 << 19))
    for r in records:
        occ = r["occupancy"]
        want = encode_launches(1 + (chunks if occ else 0), 1, 1,
                               render=dict(render_launches(rc),
                                           **occupancy_launches(rc, int(occ))))
        if not launches_match(r["launches"], want):
            raise AssertionError(f"EDS micro-step {r['step']}: launches "
                                 f"{r['launches']}, want {want}")
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


def phase_eds(torch, tmp, card, profile=False, capture=None, parent=None):
    """Phase 7: the real-data (EDS) path at full width. Returns
    {path: launches} for its training, resumed training, evaluation and
    640x480 frame. With `profile`, one steady micro-step's device time
    by kernel too. The steady micro-step's encode inputs go into the dict
    `capture`. With `parent`, steady micro-steps are timed in turns with
    the parent checkout's render scans."""
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
    check_eds_epoch(records, occ_calls, accumulate,
                    trainer.params.nerf.render_config)
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
                      "training/step.py"), capture=capture)
    if capture is not None:
        capture["occupancy"] = capture_occupancy(trainer)
    if parent is not None:
        steps_in_turns(torch, trainer, parent, "EDS micro-step")
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
    want = encode_launches(stats["field_chunks"], 0,
                           render=frame_render_launches(render))
    if not (launches_match(launches["eds frame"], want)
            and stats["field_chunks"] > 0):
        raise AssertionError(f"EDS frame launches {launches['eds frame']}, "
                             f"want {want}")
    if img.shape != (H, W) or not bool(torch.isfinite(img).all()) \
            or stats["truncated_rays"]:
        raise AssertionError(f"EDS frame: shape {tuple(img.shape)}, "
                             f"truncated {stats['truncated_rays']}")
    del evaluator, render
    torch.cuda.empty_cache()
    eds_step_card_vs_cpu(torch, tmp)
    for path, counts in launches.items():
        trains = "eval" not in path and "frame" not in path
        check_path_launches(path, counts, trains=trains,
                            filter_steps=len(records) if trains else 0)
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


def r5fix_step_launches(trainer, occupancy_update, prepass=True,
                        warmup=True):
    """The kernel launches one r5fix step implies: each field call runs
    one fused encode forward, each field backward one fused encode
    backward. A step with the prepass calls the field in the
    prepass's density pass (over K + 1 slots), the full field (over the
    prepass's K / 2 + 1 slots) and the sparsity prior; one without it
    (`prepass` False) the full field over K + 1 slots and the prior; each
    in field_chunk pieces when set; the backward runs through the full
    field and the prior; a warmup occupancy update adds one density call
    per 2^19 cells (`warmup`; a sampled update one per 2^19 sampled
    cells); the occupancy kernels as `occupancy_launches` counts them."""
    rc = trainer.params.nerf.render_config

    def calls(n):
        return -(-n // rc.field_chunk) if rc.field_chunk else 1

    if prepass:
        field_calls = calls(rc.prepass_budget + 1)
        forwards = calls(rc.sample_budget + 1) + field_calls + 1
    else:
        field_calls = calls(rc.sample_budget + 1)
        forwards = field_calls + 1
    n = rc.grid_resolution ** 3
    if occupancy_update:
        forwards += -(-(n if warmup else 2 * (n // 4)) // (1 << 19))
    updates = {"warmups" if warmup else "sampled": int(occupancy_update)}
    return encode_launches(forwards, field_calls + 1, 1, render=dict(
        render_launches(rc, prepasses=int(prepass)),
        **occupancy_launches(rc, **updates, **prior_launches(trainer))))


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
    warmup = step // trainer.accumulate < int(occ_cfg.warmup_steps)
    occupancy_update = step % trainer.accumulate == 0 and (
        warmup or (step // trainer.accumulate) % int(occ_cfg.n) == 0)
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
    want = r5fix_step_launches(trainer, occupancy_update, r["prepass"],
                               warmup)
    if not launches_match(r["launches"], want):
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
    encode forward launches in the forward only (each chunk's encode
    output is kept) and the encode backward in the backward only, with
    the counts `r5fix_step_launches` implies. Prints each one's peak
    device memory."""
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
            # the render kernels: the march, prepass and composite
            # forward in the forward, the composite backward in the
            # backward
            render = {k: want[k] for k in ("compact", "composite_fwd",
                                           "composite_bwd") + MARCH_KERNELS}
            if not (launches_match(forward, encode_launches(
                        want["hash_encode_fwd"], 0, 1, 0,
                        render=dict(render, composite_bwd=0)))
                    and launches_match(backward, encode_launches(
                        0, want["hash_encode_bwd"], 0, 1,
                        render=dict({k: 0 for k in render},
                                    composite_bwd=render["composite_bwd"])))):
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
    make_render_image_fn, timed and profiled (launches: one encode
    forward per density and per field call), then the card's eval render
    with the prepass
    against the CPU's. Returns {path: launches}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deblur_e_nerf_tpu_torch.data import posed_images
    from deblur_e_nerf_tpu_torch.training import evaluation

    launches = {}
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
    want = encode_launches(stats["density_chunks"] + stats["field_chunks"],
                           0, render=frame_render_launches(render))
    if not (launches_match(frame, want) and stats["field_chunks"] > 0):
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
            and rc.sample_budget == R5FIX_SAMPLE_BUDGET
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
        check_path_launches(path, counts, trains=path == "r5fix train",
                            filter_steps=len(records)
                            if path == "r5fix train" else 0)
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
    check_path_launches("quality", launches["quality"], trains=True,
                        filter_steps=len(records))
    return launches

# phase 10: the flagship data parallel over MESH_WORLD ranks, through the
# command line, against a single-process trainer over the same global
# batches
MESH_WORLD = 2
MESH_STEPS = 3
MESH_BUDGET_S = 480  # the phase's own limit, inside BUDGET_S
# The phase's sample budget: the flagship's K x MESH_BUDGET_HEADROOM. The
# mesh equals the single process only where no buffer overflows: a rank
# whose K / W share overflows truncates its own tail events, the single
# process the global tail (ROADMAP C1; tests/test_torch_parallel.py shows
# it on the CPU). The batch controller sizes a step to fill K with the
# last step's demand, so at the flagship's K its steps 1 and 2 truncated
# 4-7% of their rays on an H100; with 1.5 K none may truncate, and a step
# that does fails the phase.
MESH_BUDGET_HEADROOM = 1.5
# The mesh against the single process, step by step: before step k the
# single process loads the mesh's checkpoint of step k - 1 (its replica
# digest must equal the ranks' bit for bit) and keeps its own batcher,
# generator and batch controller, which run in lockstep with the ranks';
# so every step starts from equal states on the same global batch and
# draws, and each is held to the same tolerances:
# - the loss: MESH_LOSS_RTOL relative;
# - the gradients, read from Adam's first moments (g = (m - b1 m_prev) /
#   (1 - b1) with m_prev equal): MESH_GRAD_ATOL of each tensor's largest
#   entry;
# - the parameters after the step: the JAX package's sharded-vs-single
#   rtol MESH_PARAM_RTOL / atol MESH_PARAM_ATOL, except at entries where
#   Adam itself moves two gradients within MESH_GRAD_ATOL further apart
#   (its eps makes lr g / (|g| + eps) ~ lr sign(g) near g = 0: the
#   caveat on Adam's first step). Those entries are counted and printed
#   with the largest gradient among them, and each must differ by exactly
#   what Adam makes of the two steps' moments (computed here in float64),
#   within the same rtol / atol.
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_ATOL = 1e-4
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 1e-4, 1e-6


def run_cli(argv, label, deadline):
    """python -m deblur_e_nerf_tpu_torch <argv> from this checkout, in its
    own process group, which is killed at `deadline` (time.monotonic())
    or if this script stops; returns (returncode, stdout, stderr)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "deblur_e_nerf_tpu_torch", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(
            timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: still running at the phase's "
                             "limit") from None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    return proc.returncode, out, err


def mesh_config(config, steps, evaluate, lpips_weights_path=None):
    """`config` trained for `steps` epochs of one step each, checkpointed
    after every step (all kept), evaluated after the last if `evaluate`,
    with the trainer's replica check."""
    from deblur_e_nerf_tpu_torch.utils.config import ConfigDict

    config = ConfigDict.from_dict(config.to_dict())
    config.trainer.max_epochs = steps
    config.trainer.limit_train_batches = 1
    config.trainer.check_val_every_n_epoch = steps if evaluate else 10**9
    config.trainer.replica_check = True
    config.checkpoint = {"monitor": None, "mode": "min", "save_top_k": -1,
                         "every_n_epochs": 1}
    config.metric.lpips_weights_path = lpips_weights_path
    return config


def _rank_lines(log, world, label, n_lines):
    """Each rank's replica-check lines; their digests must agree line by
    line."""
    lines = []
    for rank in range(world):
        with open(f"{log}/rank_{rank}.jsonl") as f:
            lines.append([json.loads(line) for line in f])
    if any(len(rank_lines) != n_lines for rank_lines in lines):
        raise AssertionError(f"{label}: {[len(r) for r in lines]} replica "
                             f"lines, want {n_lines} on each rank")
    for i in range(n_lines):
        digests = {rank_lines[i]["digest"] for rank_lines in lines}
        if len(digests) != 1:
            raise AssertionError(f"{label}: the replicas' digests differ "
                                 f"at line {i}: {digests}")
    return lines


class MeshStepProbe:
    """The step hook each rank of phase 10 runs (`--step-hook
    chip_smoke:MeshStepProbe`): per micro-step, the kernels' launches,
    the step's time and peak device memory between device
    synchronizations, the marched samples, sample overflow and truncated
    rays, and the gradient all-reduce's bytes and time (its call wrapped
    between synchronizations), one JSON line per step in
    <log dir>/probe_<rank>.jsonl."""

    def __init__(self, trainer):
        import torch

        self.torch = torch
        self.device = trainer.device
        rank = 0 if trainer.mesh is None else trainer.mesh.rank
        self.path = os.path.join(trainer.log_dir, f"probe_{rank}.jsonl")
        self.allreduce = (None, None)
        collectives = trainer.collectives
        if collectives is not None:
            all_reduce_grads = collectives.all_reduce_grads

            def timed(params):
                params = list(params)
                self._sync()
                t0 = time.perf_counter()
                all_reduce_grads(params)
                self._sync()
                self.allreduce = (
                    sum(p.grad.numel() * p.grad.element_size()
                        for p in params if p.grad is not None),
                    (time.perf_counter() - t0) * 1e3)

            collectives.all_reduce_grads = timed

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def before(self, trainer):
        self._sync()
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)
        self.launches = read_launches()
        self.t0 = time.perf_counter()

    def after(self, trainer, metrics):
        self._sync()
        ms = (time.perf_counter() - self.t0) * 1e3
        peak = (self.torch.cuda.max_memory_allocated(self.device) / 2**30
                if self.device.type == "cuda" else None)
        launches = {k: v - self.launches[k]
                    for k, v in read_launches().items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({
                "step": trainer.global_step - 1, "launches": launches,
                "step_ms": ms, "peak_memory_gib": peak,
                "num_marched_samples": int(metrics["num_marched_samples"]),
                "sample_overflow_rate": float(
                    metrics["sample_overflow_rate"]),
                "ray_truncation_rate": float(
                    metrics["ray_truncation_rate"]),
                "allreduce_bytes": self.allreduce[0],
                "allreduce_ms": self.allreduce[1]}) + "\n")


def _probe_lines(log, world, label, n_lines):
    """Each rank's MeshStepProbe lines."""
    lines = []
    for rank in range(world):
        with open(f"{log}/probe_{rank}.jsonl") as f:
            lines.append([json.loads(line) for line in f])
    if any(len(rank_lines) != n_lines for rank_lines in lines):
        raise AssertionError(f"{label}: {[len(r) for r in lines]} probe "
                             f"lines, want {n_lines} on each rank")
    return lines


def ray_split_mismatches(torch, consts, events, S, R, world, seed=0):
    """Ray generation (`trajectory.interpolate_pose`, then
    `nerf_model.pixel_params_to_ray`) at a step's shapes, (S, R x events)
    timestamps over the trajectory's timeline, for the whole batch and
    for each of `world` ranks' shares of its events (as
    `parallel.data_parallel.shard_draws` splits them): how many rays'
    positions, orientations and directions are not bit-equal between the
    two. A data-parallel rank computes its share alone, so every count
    must be 0."""
    from deblur_e_nerf_tpu_torch.models import nerf_model
    from deblur_e_nerf_tpu_torch.models import trajectory as trajectory_lib

    trajectory = consts["trajectory"]
    device = trajectory.T_wc_timestamp.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    line = trajectory.T_wc_timestamp
    first, last = int(line[0]), int(line[-1])
    shape = (S, R, events)
    ts = first + (torch.rand(shape, generator=gen, device=device,
                             dtype=torch.float64)
                  * (last - first)).to(torch.int64)
    ts_delta = torch.rand(shape, generator=gen, device=device) - 0.5
    pixel = torch.rand((R, events, 2), generator=gen, device=device) * 256

    def rays(rows):
        t = ts[:, :, rows].reshape(S, -1)
        pos, orient = trajectory_lib.interpolate_pose(
            trajectory, t, ts_delta[:, :, rows].reshape(S, -1))
        p = pixel[:, rows].reshape(-1, 2).expand(S, -1, 2)
        _, direction = nerf_model.pixel_params_to_ray(
            consts["train_intrinsics_inv"], p, pos, orient)
        return [x.reshape(S, R, -1, *x.shape[2:])
                for x in (pos, orient, direction)]

    whole = rays(slice(None))
    share = events // world
    counts = {"position": 0, "orientation": 0, "direction": 0}
    for r in range(world):
        rows = slice(r * share, (r + 1) * share)
        for name, got, want in zip(counts, rays(rows), whole):
            differ = got != want[:, :, rows]
            counts[name] += int(differ.reshape(S, R, share, -1)
                                .any(-1).sum())
    return counts


def _load_replica(torch, trainer, path):
    """Load a checkpoint's replicated state (parameters, optimizer,
    occupancy grid, EMA) into `trainer`, keeping its batcher, generator
    and batch controller where they are."""
    from deblur_e_nerf_tpu_torch.models import occupancy
    from deblur_e_nerf_tpu_torch.training import checkpoint as ckpt_lib

    restored = ckpt_lib.restore(path, trainer.device)
    for name, child in trainer.params.named_children():
        child.load_state_dict(restored["params"][name])
    trainer.optimizer.load_state_dict(restored["opt_state"])
    occ = restored["occ_state"]
    trainer.occ_state = occupancy.OccupancyGridState(
        occs=occ["occs"].to(torch.float32),
        binary=occ["binary"].to(torch.bool))
    if trainer.ema_params is not None:
        source = restored.get("ema_params") or restored["params"]
        for name, child in trainer.ema_params.named_children():
            child.load_state_dict(source[name])


def _host_state(trainer):
    """The optimizer's moments and count, the parameters and each trained
    parameter's lr x schedule, on the host."""
    opt = trainer.optimizer.state_dict()
    o = trainer.optimizer
    sched = o.gamma ** int((o.count >= o.milestones).sum())
    return {
        "m": {n: t.detach().cpu().clone() for n, t in opt["m"].items()},
        "v": {n: t.detach().cpu().clone() for n, t in opt["v"].items()},
        "count": int(o.count),
        "params": {name: {k: v.detach().cpu().clone()
                          for k, v in child.state_dict().items()}
                   for name, child in trainer.params.named_children()},
        "lr": {n: lr * sched for _, lr, _, named in o.groups
               for n, _ in named},
    }


def _step_against_single(torch, label, step, mesh_ckpt, before, after):
    """Step `step` of the mesh (its checkpoint `mesh_ckpt`) against the
    single process's step from the same state (`before`, `after`: its
    `_host_state` around the step): the gradients and the parameters, at
    the tolerances stated above MESH_LOSS_RTOL."""
    from deblur_e_nerf_tpu_torch.training import checkpoint as ckpt_lib
    from deblur_e_nerf_tpu_torch.training.optim import B1, B2, EPS

    mesh = ckpt_lib.restore(mesh_ckpt, "cpu")
    m_mesh, v_mesh = mesh["opt_state"]["m"], mesh["opt_state"]["v"]
    t = before["count"] + 1
    bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    worst, worst_name, off, total, off_grad = 0.0, None, 0, 0, 0.0

    def update(m, v):
        return (m / bc1) / (torch.sqrt(v / bc2) + EPS)

    for name, m_prev in before["m"].items():
        m_prev = m_prev.double()
        grad = (after["m"][name].double() - B1 * m_prev) / (1.0 - B1)
        grad_mesh = (m_mesh[name].double() - B1 * m_prev) / (1.0 - B1)
        scale = float(grad.abs().max())
        err = float((grad_mesh - grad).abs().max())
        if not err <= MESH_GRAD_ATOL * scale:
            raise AssertionError(
                f"{label} step {step}: gradient {name} off by {err:.3e} of "
                f"its largest entry {scale:.3e} (tolerance "
                f"{MESH_GRAD_ATOL:.0e} of it)")
        if scale and err / scale >= worst:
            worst, worst_name = err / scale, name
        component, key = name.split(".", 1)
        got = mesh["params"][component][key].double()
        want = after["params"][component][key].double()
        limit = MESH_PARAM_ATOL + MESH_PARAM_RTOL * want.abs()
        far = (got - want).abs() > limit
        total += want.numel()
        if not bool(far.any()):
            continue
        # what Adam makes of the two steps' moments at those entries
        moved = -before["lr"][name] * (
            update(m_mesh[name].double()[far], v_mesh[name].double()[far])
            - update(after["m"][name].double()[far],
                     after["v"][name].double()[far]))
        residual = ((got - want)[far] - moved).abs()
        if bool((residual > limit[far]).any()):
            raise AssertionError(
                f"{label} step {step}: parameter {name} off by "
                f"{float((got - want)[far].abs().max()):.3e} where Adam "
                f"accounts for {float(moved.abs().max()):.3e} of it")
        off += int(far.sum())
        off_grad = max(off_grad, float(grad[far].abs().max()))
    print(f"{label} step {step}: gradients within {worst:.3e} of each "
          f"tensor's largest entry (worst {worst_name}; tolerance "
          f"{MESH_GRAD_ATOL:.0e}); parameters: {off} of {total} trained "
          f"entries off rtol {MESH_PARAM_RTOL:.0e} / atol "
          f"{MESH_PARAM_ATOL:.0e}, each by what Adam makes of its "
          f"gradients, the largest of them {off_grad:.3e}", flush=True)
    return worst


def _single_step(torch, trainer, device):
    """One step of the single-process trainer, read at once (each step
    of the mesh's run is an epoch, whose end reads its metrics)."""
    _sync(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    m = trainer.train_step()
    loss = float(m["loss"])
    _sync(torch, device)
    ms = (time.perf_counter() - t0) * 1e3
    trainer._flush_pending_metrics()
    return {"loss": loss, "batch_size": int(m["batch_size"]),
            "launches": read_launches(), "ms": ms,
            "marched": int(m["num_marched_samples"]),
            "overflow": float(m["sample_overflow_rate"]),
            "truncated": float(m["ray_truncation_rate"])}


def _check_step(label, step, ranks, probes, single):
    """A mesh step's records (each rank's replica line and probe line)
    against the single process's: active sizes, launches, no truncated
    ray, the loss."""
    for rank, (line, probe) in enumerate(zip(ranks, probes)):
        if line["batch_size"] != single["batch_size"]:
            raise AssertionError(f"{label} rank {rank} step {step}: active "
                                 f"{line['batch_size']}, the single "
                                 f"process's {single['batch_size']}")
        if probe["launches"] != single["launches"]:
            raise AssertionError(
                f"{label} rank {rank} step {step}: launches "
                f"{probe['launches']}, the single process's "
                f"{single['launches']}")
        if probe["ray_truncation_rate"] or single["truncated"]:
            raise AssertionError(
                f"{label} step {step}: rays truncated (mesh "
                f"{probe['ray_truncation_rate']}, single process "
                f"{single['truncated']}): each rank drops its own tail "
                "events, the single process the global tail (ROADMAP C1), "
                "so the steps cannot be compared; raise the sample budget")
    loss = ranks[0]["loss"]
    err = abs(loss - single["loss"]) / abs(single["loss"])
    print(f"{label} step {step}: loss {loss:.8f}, single process "
          f"{single['loss']:.8f} (relative difference {err:.3e}, "
          f"tolerance {MESH_LOSS_RTOL:.0e})", flush=True)
    if not err <= MESH_LOSS_RTOL:
        raise AssertionError(f"{label} step {step}: the losses disagree")


def mesh_vs_single(torch, tmp, config, label, world=MESH_WORLD,
                   backend="gloo", steps=MESH_STEPS, capacity=8192,
                   sample_budget=None, evaluate=True, resume=True,
                   lpips_weights_path=None, deadline=None, device="cuda"):
    """`steps` steps of `config` (no gradient accumulation) through
    `python -m deblur_e_nerf_tpu_torch train --mesh world --dist-backend
    backend --step-hook chip_smoke:MeshStepProbe` (rank 0 evaluates 1
    view at the end if `evaluate`, and checkpoints every step), checked
    against a single-process trainer on the same device over the same
    global batches (`interleave=world`): the replicas' digests at every
    step, and each step from the mesh's own state before it (see the
    tolerances above MESH_LOSS_RTOL): active sizes, launches, loss,
    gradients and parameters. The ray generation of the step's shapes
    must be bit-equal over the ranks' shares (`ray_split_mismatches`).
    With `resume`, a second invocation resumes the last checkpoint under
    the mesh for one step, and a single process resuming the same file
    must have the ranks' digest bit for bit and take the same step.
    `device` "cpu" runs the same on the CPU (gloo). Returns {"rank r":
    launches over the first invocation}."""
    from deblur_e_nerf_tpu_torch.parallel import data_parallel
    from deblur_e_nerf_tpu_torch.training import step as step_lib
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer
    from deblur_e_nerf_tpu_torch.utils.config import save_config

    if int(config.trainer.get("accumulate_grad_batches") or 1) != 1:
        raise ValueError("mesh_vs_single reads each step's gradient from "
                         "Adam's moments: no gradient accumulation")
    deadline = deadline or time.monotonic() + MESH_BUDGET_S
    cfg = mesh_config(config, steps, evaluate, lpips_weights_path)
    path, log = f"{tmp}/{label}.yaml", f"{tmp}/log_{label}_mesh"
    save_config(cfg, path)
    argv = ["train", path, "--mesh", str(world), "--dist-backend", backend,
            "--batch-capacity", str(capacity), "--max-eval-images", "1",
            "--dist-timeout", "300", "--device", device,
            "--step-hook", "chip_smoke:MeshStepProbe"]
    if sample_budget:
        argv += ["--sample-budget", str(sample_budget)]
    t0 = time.perf_counter()
    rc, out, err = run_cli(argv + ["--log-dir", log], label, deadline)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: the mesh run failed ({rc}):\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    print(f"{label}: {world} ranks over {backend}, {steps} steps"
          f"{', evaluation and' if evaluate else ','} checkpoints in "
          f"{wall:.2f} s of command; rank 0 printed: "
          + " | ".join(line for line in out.splitlines()
                       if line.startswith(("epoch", "training"))),
          flush=True)
    if evaluate and "epoch" not in out:
        raise AssertionError(f"{label}: rank 0 did not evaluate")
    ranks = _rank_lines(log, world, label, steps + 1)
    probes = _probe_lines(log, world, label, steps)
    route = " through the host, not NCCL" if backend == "gloo" else ""
    for rank in range(world):
        for line, probe in zip(ranks[rank][1:], probes[rank]):
            peak = probe["peak_memory_gib"] or 0.0
            print(f"{label} rank {rank} step {line['step']}: loss "
                  f"{line['loss']:.8f}, active {line['batch_size']} "
                  f"(this rank {line['local_batch_size']}), prepass_ran "
                  f"{line['prepass_ran']}, marched samples "
                  f"{probe['num_marched_samples']}, sample overflow "
                  f"{probe['sample_overflow_rate']:.4f}, truncated rays "
                  f"{probe['ray_truncation_rate']:.4f}, launches "
                  f"{probe['launches']}, digest {line['digest']}, step "
                  f"{probe['step_ms']:.1f} ms, peak device memory "
                  f"{peak:.2f} GiB, gradient all-reduce "
                  f"{probe['allreduce_bytes']} bytes in "
                  f"{probe['allreduce_ms']:.1f} ms ({backend}{route})",
                  flush=True)

    single_cfg = mesh_config(config, steps, evaluate=False)
    single_cfg.trainer.replica_check = False
    trainer = Trainer(single_cfg, f"{tmp}/log_{label}_single",
                      batch_capacity=capacity, sample_budget=sample_budget,
                      device=device, interleave=world)
    sc = trainer.bundle.static_config
    mismatches = ray_split_mismatches(
        torch, trainer.bundle.consts, capacity,
        sc.it_sample_size if sc.pixel_bandwidth_enabled else 1,
        step_lib.n_render_slices(sc), world)
    print(f"{label}: ray generation at the step's shapes, the ranks' "
          f"shares against the whole batch: {mismatches} rays not "
          "bit-equal", flush=True)
    if any(mismatches.values()):
        raise AssertionError(f"{label}: ray generation depends on the "
                             f"batch it is computed in: {mismatches}")
    ckpt = f"{log}/checkpoints/epoch_{{:04d}}"
    for step in range(steps):
        if step:
            _load_replica(torch, trainer, ckpt.format(step - 1))
            digest = int(data_parallel.digest(trainer.replica_tensors()))
            if digest != ranks[0][step]["digest"]:
                raise AssertionError(
                    f"{label}: the single process loading the mesh's "
                    f"checkpoint of step {step - 1} has digest {digest}, "
                    f"the ranks' {ranks[0][step]['digest']}")
        before = _host_state(trainer)
        single = _single_step(torch, trainer, device)
        print(f"{label} single process step {step}: loss "
              f"{single['loss']:.8f}, active {single['batch_size']}, "
              f"marched samples {single['marched']}, sample overflow "
              f"{single['overflow']:.4f}, truncated rays "
              f"{single['truncated']:.4f}, launches {single['launches']}, "
              f"step {single['ms']:.1f} ms", flush=True)
        _check_step(label, step, [r[step + 1] for r in ranks],
                    [p[step] for p in probes], single)
        _step_against_single(torch, label, step, ckpt.format(step), before,
                             _host_state(trainer))
    del trainer
    _empty_cache(torch, device)
    launches = {f"rank {r}": {k: sum(line["launches"][k]
                                     for line in rank_probes)
                              for k in rank_probes[0]["launches"]}
                for r, rank_probes in enumerate(probes)}
    if not resume:
        return launches

    cfg.trainer.resume_from_checkpoint = ckpt.format(steps - 1)
    cfg.trainer.max_epochs = steps + 1
    save_config(cfg, path)
    rc, out, err = run_cli(argv + ["--log-dir", f"{log}_resumed"],
                           f"{label} resumed", deadline)
    if rc != 0:
        raise AssertionError(f"{label} resumed: failed ({rc}):\n"
                             f"{err[-4000:]}")
    resumed = _rank_lines(f"{log}_resumed", world, f"{label} resumed", 2)
    resumed_probes = _probe_lines(f"{log}_resumed", world,
                                  f"{label} resumed", 1)
    trainer = Trainer(single_cfg, f"{tmp}/log_{label}_single_resumed",
                      batch_capacity=capacity, sample_budget=sample_budget,
                      device=device, interleave=world)
    trainer.resume(ckpt.format(steps - 1))
    digest = int(data_parallel.digest(trainer.replica_tensors()))
    print(f"{label} resumed under the mesh: digest {resumed[0][0]['digest']}"
          f", a single process resuming the file {digest}", flush=True)
    if digest != resumed[0][0]["digest"]:
        raise AssertionError(f"{label}: the resumed replicas differ")
    before = _host_state(trainer)
    single = _single_step(torch, trainer, device)
    _check_step(f"{label} resumed", steps, [r[1] for r in resumed],
                [p[0] for p in resumed_probes], single)
    _step_against_single(
        torch, f"{label} resumed", steps,
        f"{log}_resumed/checkpoints/epoch_{steps:04d}", before,
        _host_state(trainer))
    del trainer
    _empty_cache(torch, device)
    return launches


def _sync(torch, device):
    if device != "cpu":
        torch.cuda.synchronize()


def _empty_cache(torch, device):
    if device != "cpu":
        torch.cuda.empty_cache()


def flagship_sample_budget(config):
    """The flagship's K, as training/setup.py sizes it by default."""
    slices = (2 * (float(config.loss.weight.log_intensity_diff) > 0)
              + 2 * (float(config.loss.weight.log_intensity_tv) > 0))
    S = int(config.model.pixel_bandwidth.get("it_sample_size", 1)) \
        if config.model.pixel_bandwidth.enable else 1
    return int(int(config.data.train_eff_ray_sample_batch_size) * S
               * max(slices, 1)
               * float(config.data.get("train_sample_budget_margin", 1.0)))


def phase_data_parallel(torch, tmp, root, card):
    """Phase 10: the flagship (configs/train/synthetic.yaml at full width,
    on phase 4's dataset) over MESH_WORLD ranks through the command line
    (see `mesh_vs_single`), over gloo with both ranks on this card; the
    NCCL mesh without a second card must raise; NCCL one rank per card
    where there are 2 cards. Returns {"data parallel rank r": launches}."""
    deadline = time.monotonic() + MESH_BUDGET_S
    config = flagship_config(root)
    lpips = write_lpips_stub(torch, f"{tmp}/lpips_alex.pt")
    budget = int(flagship_sample_budget(config) * MESH_BUDGET_HEADROOM)
    torch.cuda.synchronize()
    launches = mesh_vs_single(torch, tmp, config, "mesh", deadline=deadline,
                              sample_budget=budget, lpips_weights_path=lpips)
    count = torch.cuda.device_count()
    if count < MESH_WORLD:
        rc, _, err = run_cli(["train", f"{tmp}/mesh.yaml", "--mesh",
                              str(MESH_WORLD), "--log-dir",
                              f"{tmp}/log_nccl", "--device", "cuda"],
                             "nccl", deadline)
        if rc == 0 or "NCCL takes one card per rank" not in err:
            raise AssertionError(f"--mesh {MESH_WORLD} over NCCL on "
                                 f"{count} card(s) did not raise ({rc}): "
                                 f"{err[-2000:]}")
        print(f"--mesh {MESH_WORLD} without --dist-backend on {count} "
              f"card: raised as it must ({err.strip().splitlines()[-1]})",
              flush=True)
        print(f"NCCL mesh {MESH_WORLD} not run: this machine has {count} "
              f"card ({card}); NCCL takes one card per rank", flush=True)
    else:
        launches.update({f"nccl {k}": v for k, v in mesh_vs_single(
            torch, tmp, config, "mesh_nccl", backend="nccl",
            sample_budget=budget, deadline=deadline,
            lpips_weights_path=lpips,
            resume=False).items()})
    return {f"data parallel {k}": v for k, v in launches.items()}


# ---------------------------------------------------------------------------
# phase 11: the EDS converter (data/eds_to_esim.py) on a raw sequence

# the raw sequence's event stream, written by h5py (chunked, shuffle +
# gzip) from `eds_fixture_events` (tests/test_torch_eds_to_esim.py checks
# that the file holds what the generator writes); the card machine has no
# h5py to write one
EDS_EVENTS_FIXTURE = "tests/fixtures/eds_events.h5"
# EDS's RGB camera (cam0) and Prophesee Gen 3 event camera (cam1): both
# 640 x 480, radtan; the first pose at 1000 s, 21 poses over 1 s
EDS_RAW_SIZE = (640, 480)
EDS_RAW_T0_S = 1000.0
EDS_RAW_POSES = 21
EDS_RAW_EVENTS = 5000
EDS_RAW_IMAGE_TIMES = (0.0, 0.45, 1.0)  # s after the first pose
EDS_POSE_ATOL = 1e-5  # the card's slerped poses against the CPU's


def eds_fixture_events(seed=0):
    """The events of EDS_EVENTS_FIXTURE: x, y (uint16, 640 x 480), t
    (int64 microseconds, sorted, from 50 ms before the first pose to 50 ms
    after the last) and p (uint8 0/1), from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t0_us = int(EDS_RAW_T0_S * 1e6)
    width, height = EDS_RAW_SIZE
    return {
        "x": rng.integers(0, width, EDS_RAW_EVENTS).astype(np.uint16),
        "y": rng.integers(0, height, EDS_RAW_EVENTS).astype(np.uint16),
        "t": np.sort(rng.integers(t0_us - 50_000, t0_us + 1_050_000,
                                  EDS_RAW_EVENTS)).astype(np.int64),
        "p": rng.integers(0, 2, EDS_RAW_EVENTS).astype(np.uint8),
    }


def _rotation(axis, angle):
    """A rotation matrix (Rodrigues) of `angle` radians about `axis`."""
    import numpy as np

    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def eds_camchain_text():
    """A Kalibr camera chain (the EDS calibration's layout) as YAML text:
    the radtan RGB camera cam0 and the event camera cam1, whose
    T_cn_cnm1 (cam1 from cam0) is written as `- [..]` rows."""
    import numpy as np

    T = np.eye(4)
    T[:3, :3] = _rotation((0.2, -1.0, 0.3), 0.02)
    T[:3, 3] = (0.0512, -0.0031, 0.0074)
    rows = "\n".join(f"  - [{', '.join(repr(float(v)) for v in row)}]"
                     for row in T)
    return ("cam0:\n"
            "  cam_overlaps: [1]\n"
            "  camera_model: pinhole\n"
            "  distortion_coeffs: [-0.3622, 0.1358, 0.00062, 0.00051]\n"
            "  distortion_model: radtan\n"
            "  intrinsics: [560.24, 561.12, 320.51, 240.23]\n"
            "  resolution: [640, 480]\n"
            "  rostopic: /cam0/image_raw\n"
            "cam1:\n"
            f"  T_cn_cnm1:\n{rows}\n"
            "  cam_overlaps: [0]\n"
            "  camera_model: pinhole\n"
            "  distortion_coeffs: [-0.0951, 0.1702, 0.00031, -0.00022]\n"
            "  distortion_model: radtan\n"
            "  intrinsics: [548.81, 549.02, 313.24, 219.41]\n"
            "  resolution: [640, 480]\n"
            "  rostopic: /cam1/events\n")


def eds_rotating_poses():
    """(stamped_groundtruth.txt rows (t s, xyz, xyzw), EDS_RAW_POSES of
    them): a camera turning 0.6 rad about a tilted axis while it moves."""
    import numpy as np

    t = np.linspace(0.0, 1.0, EDS_RAW_POSES)
    angle = 0.6 * t
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    quat = np.concatenate([np.sin(angle / 2)[:, None] * axis,
                           np.cos(angle / 2)[:, None]], axis=1)
    pos = np.stack([np.sin(t), 0.3 * t, np.cos(t) - 1], axis=1)
    return np.concatenate([(EDS_RAW_T0_S + t)[:, None], pos, quat], axis=1)


def write_eds_sequence(root):
    """A raw EDS sequence under `root`: calib/ (the Kalibr camera chain,
    `eds_camchain_text`) and raw/ (events.h5 copied from
    EDS_EVENTS_FIXTURE, stamped_groundtruth.txt from
    `eds_rotating_poses`, times.txt and 3 PNG images written by the port's
    image writer). Returns (calibration dir, raw dir)."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import eds_to_esim, image_io

    repo = os.path.dirname(os.path.abspath(__file__))
    calib, raw = os.path.join(root, "calib"), os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "images"), exist_ok=True)
    os.makedirs(calib, exist_ok=True)
    with open(os.path.join(calib, eds_to_esim.CALIBRATION_CONFIG_FILENAME),
              "w") as f:
        f.write(eds_camchain_text())
    shutil.copyfile(os.path.join(repo, EDS_EVENTS_FIXTURE),
                    os.path.join(raw, eds_to_esim.RAW_EVENTS_FILENAME))
    np.savetxt(os.path.join(raw, eds_to_esim.RAW_EVENT_CAMERA_POSES_FILENAME),
               eds_rotating_poses(), fmt="%.9f")
    width, height = EDS_RAW_SIZE
    yy, xx = np.mgrid[0:height, 0:width]
    lines = []
    for i, dt in enumerate(EDS_RAW_IMAGE_TIMES):
        name = f"{i:06d}.png"
        img = np.stack([(xx * (i + 1) // 3) % 256, (yy * 2 + 40 * i) % 256,
                        ((xx + yy) // 4) % 256], axis=-1).astype(np.uint8)
        image_io.imwrite(os.path.join(raw, "images", name), img)
        lines.append(f"{i} {EDS_RAW_T0_S + dt:.6f} {5.0 + i} {6.0 - i} "
                     f"{name}")
    with open(os.path.join(raw, eds_to_esim.TIMES_FILENAME), "w") as f:
        f.write("\n".join(lines) + "\n")
    return calib, raw


def _npz_arrays(path):
    import numpy as np

    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def compare_eds_conversions(got, want):
    """Two conversions of one sequence: every npz array equal in dtype,
    shape and bytes, the images' bytes equal, transforms_train.json equal
    but for the poses, which are within EDS_POSE_ATOL; returns the largest
    pose difference. Raises AssertionError on any mismatch."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import eds_to_esim as conv

    for name in (conv.CAMERA_CALIBRATION_FILENAME, conv.CAMERA_POSES_FILENAME,
                 conv.EVENTS_FILENAME):
        a, b = _npz_arrays(os.path.join(got, name)), \
            _npz_arrays(os.path.join(want, name))
        if sorted(a) != sorted(b):
            raise AssertionError(f"{name}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape \
                    or a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"{name}[{k}] differs")
    views = os.path.join(conv.VIEWS_FOLDER_NAME,
                         f"transforms_{conv.STAGE}.json")
    with open(os.path.join(got, views)) as f:
        a = json.load(f)
    with open(os.path.join(want, views)) as f:
        b = json.load(f)
    pose_diff = max((float(np.abs(np.subtract(fa["transform_matrix"],
                                              fb["transform_matrix"])).max())
                     for fa, fb in zip(a["frames"], b["frames"])), default=0.0)
    strip = [{k: v for k, v in fr.items() if k != "transform_matrix"}
             for fr in a["frames"]], \
        [{k: v for k, v in fr.items() if k != "transform_matrix"}
         for fr in b["frames"]]
    if a["intrinsics"] != b["intrinsics"] or strip[0] != strip[1] \
            or pose_diff > EDS_POSE_ATOL:
        raise AssertionError(f"{views}: intrinsics, frames or poses differ "
                             f"(largest pose difference {pose_diff:.3e}, "
                             f"limit {EDS_POSE_ATOL:g})")
    stage = os.path.join(conv.VIEWS_FOLDER_NAME, conv.STAGE)
    names = sorted(os.listdir(os.path.join(want, stage)))
    if sorted(os.listdir(os.path.join(got, stage))) != names:
        raise AssertionError(f"{stage}: other image files")
    for name in names:
        with open(os.path.join(got, stage, name), "rb") as f, \
                open(os.path.join(want, stage, name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{stage}/{name} differs")
    return pose_diff


def phase_eds_conversion(tmp, device="cuda"):
    """Phase 11: a raw EDS sequence (`write_eds_sequence`) converted by
    `python -m deblur_e_nerf_tpu_torch.data.eds_to_esim` on `device` (a
    process of its own), then in this process on the CPU; the two held to
    each other (`compare_eds_conversions`: poses within EDS_POSE_ATOL,
    everything else equal), the events to the fixture's within the pose
    window, and the card's output loaded by the port's own loaders
    (events, poses, posed images). Returns the largest pose difference."""
    import numpy as np

    from deblur_e_nerf_tpu_torch.data import (camera_poses, eds_to_esim,
                                              events, posed_images)

    calib, raw = write_eds_sequence(os.path.join(tmp, "eds_raw"))
    card_out, cpu_out = (os.path.join(tmp, f"eds_{d}") for d in ("card",
                                                                 "cpu"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deblur_e_nerf_tpu_torch.data.eds_to_esim",
         calib, raw, card_out, "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    card_s = time.perf_counter() - t0
    if proc.returncode != 0 or "Done!" not in proc.stdout:
        raise AssertionError(f"eds_to_esim on {device} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    t0 = time.perf_counter()
    if eds_to_esim.main([calib, raw, cpu_out, "--device", "cpu"]) != 0:
        raise AssertionError("eds_to_esim on the CPU failed")
    cpu_s = time.perf_counter() - t0
    pose_diff = compare_eds_conversions(card_out, cpu_out)
    # the events: the fixture's within the pose window, re-zeroed
    fixture = eds_fixture_events()
    t0_ns = int(round(EDS_RAW_T0_S * 1e9))
    ts = 1000 * fixture["t"] - t0_ns
    keep = (ts >= 0) & (ts <= int(1e9))
    got = _npz_arrays(os.path.join(card_out, eds_to_esim.EVENTS_FILENAME))
    if not (np.array_equal(got["timestamp"], ts[keep])
            and np.array_equal(got["position"], np.stack(
                [fixture["x"], fixture["y"]], axis=1)[keep])
            and np.array_equal(got["polarity"], fixture["p"][keep] == 1)):
        raise AssertionError("the converted events are not the fixture's "
                             "within the pose window")
    # the port's loaders on the card's output
    poses = camera_poses.load_camera_poses(card_out)
    dataset = events.EventDataset(card_out, native=False)
    views = posed_images.PosedImageDataset(card_out, "train")
    n_views = len(views.posed_imgs["img"])
    if len(poses["T_wc_timestamp"]) != EDS_RAW_POSES or len(dataset) == 0 \
            or n_views != len(EDS_RAW_IMAGE_TIMES) \
            or views.posed_imgs["img"].shape[1:3] != EDS_RAW_SIZE[::-1]:
        raise AssertionError(f"the loaders read {len(poses['T_wc_timestamp'])}"
                             f" poses, {len(dataset)} event intervals, "
                             f"{n_views} views")
    print(f"eds conversion: {device} (python -m, its own process) "
          f"{card_s:.2f} "
          f"s, CPU (in process) {cpu_s:.2f} s; {int(keep.sum())} of "
          f"{EDS_RAW_EVENTS} events in the pose window, {len(dataset)} "
          f"event intervals, {n_views} views of "
          f"{EDS_RAW_SIZE[0]}x{EDS_RAW_SIZE[1]}; poses {device} against CPU "
          f"{pose_diff:.3e} (limit {EDS_POSE_ATOL:g})", flush=True)
    return pose_diff


def kernel_line(name, source, replaces, rows, launches, main_shape,
                main_kind="uniform", path="filter on"):
    main = next(r for r in rows if r["shape"] == main_shape
                and r.get("index_structure", "uniform") == main_kind)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[path][name],
        "launches_path": path,
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
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of the parent commit: phase 3 "
                             "also builds its kernels and times them in "
                             "turns with these on the same inputs, and "
                             "phases 4 and 7 time steps in turns with its "
                             "render scans (see load_parent)")
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
        pb_build = phase_build()["pb_build"]
    with phase("3 kernels vs plain"):
        parent = load_parent(torch, args.parent) if args.parent else None
        rows = phase_kernels(torch, parent)
    captured = {"flagship": {}, "EDS": {}}
    with tempfile.TemporaryDirectory() as tmp:
        with phase("4 training"):
            launches, trainer, root = phase_training(
                torch, tmp, profile=args.profile,
                capture=captured["flagship"], parent=parent)
        with phase("5 reference"):
            phase_reference(torch, tmp)
        with phase("6 eval"):
            launches.update(phase_eval(torch, tmp, trainer, root))
        del trainer
        torch.cuda.empty_cache()
        with phase("7 real-data (EDS) path"):
            launches.update(phase_eds(torch, tmp, card,
                                      profile=args.profile,
                                      capture=captured["EDS"],
                                      parent=parent))
        torch.cuda.empty_cache()
        with phase("3b kernels vs plain on the step's own inputs"):
            phase_step_inputs(torch, rows, captured, parent)
            pb_accuracy_summary(rows)
        del captured
        torch.cuda.empty_cache()
        with phase("8 r5fix path (prepass, chunked render, vanilla field)"):
            launches.update(phase_r5fix(torch, tmp, card))
        torch.cuda.empty_cache()
        with phase("9 quality harness (r5fix config, resumed)"):
            launches.update(phase_quality(torch, tmp, card))
        torch.cuda.empty_cache()
        with phase("10 data parallel (flagship, 2 ranks over gloo)"):
            launches.update(phase_data_parallel(torch, tmp, root, card))
        with phase("11 EDS conversion (host)"):
            phase_eds_conversion(tmp)

    step_shape = f"N = K + 1: {ENCODE_CASES[0][0]}"
    kernels = [
        dict(kernel_line("pb_weight_fwd", PB_WEIGHT_SOURCE,
                         PB_WEIGHT_REPLACES, rows["pb_weight_fwd"], launches,
                         "flagship step's own inputs"),
             build=pb_build.get("pb_weight_fwd_kernel")),
        dict(kernel_line("pb_weight_bwd", PB_WEIGHT_SOURCE,
                         PB_WEIGHT_REPLACES, rows["pb_weight_bwd"], launches,
                         "flagship step's own inputs"),
             build=pb_build.get("pb_weight_bwd_kernel")),
        kernel_line("hash_encode_fwd", HASH_ENCODE_SOURCE,
                    HASH_ENCODE_FWD_REPLACES, rows["hash_encode_fwd"],
                    launches, step_shape, "step"),
        dict(kernel_line("hash_encode_bwd", HASH_ENCODE_SOURCE,
                         HASH_ENCODE_BWD_REPLACES, rows["hash_encode_bwd"],
                         launches, step_shape, "step"),
             l2_reduction_rates=rows["l2_reduction_rates"]),
        dict(kernel_line("scatter_add_rows", SCATTER_SOURCE,
                         SCATTER_REPLACES, rows["scatter_add_rows"],
                         launches, "flagship step: cellhash levels 7-15"),
             call_split=rows["scatter_add_rows_call_split"]),
        kernel_line("gather_rows", GATHER_SOURCE, GATHER_REPLACES,
                    rows["gather_rows"], launches,
                    "flagship step: cellhash view, levels 7-15"),
        kernel_line("compact", COMPACT_SOURCE, COMPACT_REPLACES,
                    rows["compact"], launches,
                    "flagship step's own inputs: sample stage", "step"),
        kernel_line("composite_fwd", COMPOSITE_SOURCE, COMPOSITE_REPLACES,
                    rows["composite_fwd"], launches,
                    "flagship step's own inputs", "step"),
        kernel_line("composite_bwd", COMPOSITE_SOURCE, COMPOSITE_REPLACES,
                    rows["composite_bwd"], launches,
                    "flagship step's own inputs", "step"),
    ] + [kernel_line(name, MARCH_SOURCE, MARCH_REPLACES[name], rows[name],
                     launches, "flagship step's own inputs", "step")
         for name in MARCH_KERNELS]
    # the whole march (its kernels and compactions) beside its plain version
    kernels[-len(MARCH_KERNELS)]["whole_march"] = rows["march"]
    # the occupancy kernels: the main path (3 warmup updates) launches the
    # points, EMA and threshold kernels, phase 4a's path (2 warmup updates
    # and a sampled one) the sampler too; their counts are calls of the
    # entry points, each launching one or more kernels (the device
    # launches a call from 3b's profiled updates)
    for name, kind in (("occ_points", "warmup"), ("occ_ema", "sampled"),
                       ("occ_threshold", "warmup"),
                       ("occ_sample_occupied", "sampled")):
        kernels.append(dict(kernel_line(
            name, OCC_SOURCE, OCC_REPLACES[name], rows[name], launches,
            "flagship step's own grid", kind,
            "filter off" if name == "occ_sample_occupied" else "filter on"),
            launches_count="calls of the entry point",
            device_launches_per_call={
                r["shape"]: r["device_launches"][name]
                / r["entry_point_calls"][name]
                for r in rows["occ_update"]
                if r["entry_point_calls"][name]}))
    kernels[-len(OCC_KERNELS)]["whole_update"] = rows["occ_update"]
    for path in (p for p in launches if p.startswith("data parallel")):
        check_path_launches(path, launches[path], trains=True,
                            filter_steps=MESH_STEPS)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
