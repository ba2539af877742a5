#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deblur_e_nerf_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing a start and an end line with elapsed seconds:
  1. environment: torch/CUDA versions, device, nvidia-smi name and power
     limit, nvcc, triton;
  2. build: the CUDA kernels, with nvcc from the sources in this checkout;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with times of the kernel, the plain version
     and one PyTorch library call computing the same function;
  4. training: the port's Trainer takes 3 steps of the flagship
     configuration (configs/train/synthetic.yaml, pixel-bandwidth filter
     off) at full width on a synthetic dataset, then one forced occupancy
     update; the kernels' launch counts are read over this phase;
  5. reference: on a small input, the NGP field's outputs and table
     gradient computed on the card (through the kernels) agree with the
     plain version on the CPU.

Any failed check raises and the script exits non-zero. The line before
the last is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result. It writes nothing into the checkout except
the kernels' build directory (deblur_e_nerf_tpu_torch/_build).
"""

import argparse
import json
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

BUDGET_S = 15 * 60
# H100 SXM published peaks: HBM bytes/s, dense float32 FLOP/s (no tensor
# cores), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SCATTER_SOURCE = "deblur_e_nerf_tpu_torch/csrc/scatter_rows.cu"
SCATTER_REPLACES = "deblur_e_nerf_tpu/ops/pallas_scatter.py:46"
# the flagship's default sample budget K: train_eff_ray_sample_batch_size
# (131072) x 4 render slices (diff and subdiff start/end)
MAIN_PATH_SAMPLE_BUDGET = 4 * 131072


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S} s budget")


@contextmanager
def phase(name):
    print(f"[phase] {name}: start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: done in {time.perf_counter() - t0:.2f} s",
          flush=True)


def flagship_config(dataset_directory):
    """configs/train/synthetic.yaml's values, pixel-bandwidth filter off."""
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
            "pixel_bandwidth": {"enable": False, "it_sample_size": 30,
                                "load_state_dict": False, "freeze": True},
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
                    "limit_train_batches": 1000},
    })


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    return info


def scatter_case(torch, scatter_rows, name, width, n_rows, n, gen):
    """K1 against its plain version at one shape; returns the row."""
    dev = "cuda"
    idx = torch.randint(0, n_rows, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.randn((n, width), generator=gen, device=dev)
    out = scatter_rows.scatter_add_rows(idx, val, n_rows)
    plain = scatter_rows.scatter_add_rows_reference(idx, val, n_rows)
    exact = scatter_rows.scatter_add_rows_reference(idx, val, n_rows,
                                                    dtype=torch.float64)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    err_exact = float((out.double() - exact).abs().max())
    # any summation order of k terms is within (k-1) eps sum|x| of the
    # exact sum; the kernel and the plain version each are, hence 2x
    counts = torch.bincount(idx.long(), minlength=n_rows)
    abs_sum = scatter_rows.scatter_add_rows_reference(
        idx, val.abs(), n_rows, dtype=torch.float64)
    eps = torch.finfo(torch.float32).eps
    tol = 2.0 * max(int(counts.max()) - 1, 1) * eps * float(abs_sum.max())
    idx64 = idx.long()
    ms = time_ms(lambda: scatter_rows.scatter_add_rows(idx, val, n_rows))
    plain_ms = time_ms(
        lambda: scatter_rows.scatter_add_rows_reference(idx, val, n_rows))
    library_ms = time_ms(lambda: torch.zeros(
        (n_rows, width), device=dev).index_add_(0, idx64, val))
    nbytes = n * width * 4 + n * 4 + n_rows * width * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * width / PEAK_F32_FLOPS * 1e3
    row = {
        "shape": name, "width": width, "n_rows": n_rows, "n": n,
        "max_abs_err": err, "max_abs_err_vs_f64": err_exact,
        "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "max_row_count": int(counts.max()),
    }
    print(f"K1 {name}: W={width} n_rows={n_rows} N={n} max_abs_err "
          f"{err:.3e} (vs f64 {err_exact:.3e}, tolerance {tol:.3e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    if not (err <= tol and err_exact <= tol):
        raise AssertionError(f"K1 {name}: error {err} above {tol}")
    return row


def phase_kernels(torch):
    from deblur_e_nerf_tpu_torch.ops import scatter_rows

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, K1 = 131072, MAIN_PATH_SAMPLE_BUDGET + 1
    cases = [
        # the training step's calls: one per level, on all K + 1 slots
        ("main path: cellhash levels 7-15", 16, 65536, K1),
        ("main path: dense level 0", 16, 4096, K1),
        ("main path: vertex-hash levels 5-6", 2, 524288, 8 * K1),
        # the same tables at N = 131072 rows
        ("cellhash table, N=131072", 16, 65536, n),
        ("dense level 0 table, N=131072", 16, 4096, n),
        ("vertex-hash table, N=131072", 2, 524288, n),
    ]
    return [scatter_case(torch, scatter_rows, *c, gen) for c in cases]


def _device_table(prof, label, n):
    """Print kernel (device) time and the operators that launched it."""
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
    return total / n / 1e3


def profile_steps(torch, trainer, n_steps=3):
    """Device time by kernel (torch.profiler) of steady-state steps and of
    one warmup (full-grid) occupancy update, with their wall times."""
    from torch.profiler import ProfilerActivity, profile

    # past the warmup and off the occupancy schedule: these steps run no
    # occupancy update
    trainer.global_step = int(trainer.params.nerf.occ_grid_config
                              .warmup_steps) + 1
    for _ in range(2):
        trainer.train_step()

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        busy = _device_table(prof, label, n)
        print(f"profile {label}: wall {wall:.3f} ms without the profiler, "
              f"device busy {100 * busy / wall:.1f}% of it", flush=True)


def phase_training(torch, tmp, profile=False):
    from deblur_e_nerf_tpu_torch.data import synthetic
    from deblur_e_nerf_tpu_torch.ops import scatter_rows
    from deblur_e_nerf_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    root = synthetic.make_dataset(f"{tmp}/dataset", img_height=64,
                                  img_width=64, num_poses=61)
    print(f"synthetic dataset in {time.perf_counter() - t0:.2f} s",
          flush=True)
    config = flagship_config(root)
    t0 = time.perf_counter()
    trainer = Trainer(config, f"{tmp}/log", device="cuda")
    field = trainer.params.nerf.field
    print(f"trainer built in {time.perf_counter() - t0:.2f} s: table "
          f"{tuple(field.table.shape)}, levels "
          f"{[(r, m) for r, _, _, m in field.levels]}, batch capacity "
          f"{trainer.batch_capacity}, sample budget "
          f"{trainer.params.nerf.render_config.sample_budget}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    scatter_rows.LAUNCHES = 0
    losses = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        print(f"step {i}: loss {loss:.6f}, active events "
              f"{int(m['batch_size'])}, rays {int(m['num_rays'])}, marched "
              f"samples {int(m['num_marched_samples'])}, samples/ray "
              f"{float(m['mean_num_samples_per_ray']):.2f}, truncated "
              f"rays {float(m['ray_truncation_rate']):.3f}, valid "
              f"{float(m['mean_valid_rate']):.3f}, skipped "
              f"{m['update_skipped']}, step time {dt:.3f} s", flush=True)
        if not torch.isfinite(m["loss"]) or m["update_skipped"]:
            raise AssertionError(f"step {i}: non-finite loss or skip")
        grad = field.table.grad
        if grad is None or not bool(torch.isfinite(grad).all()) \
                or float(grad.abs().max()) == 0.0:
            raise AssertionError(f"step {i}: table gradient missing/zero")
        print(f"step {i}: table grad max |g| {float(grad.abs().max()):.3e}"
              f", nonzero rows {int((grad != 0).any(dim=1).sum())}",
              flush=True)
    t0 = time.perf_counter()
    occ = trainer.update_occupancy(
        step=int(config.model.nerf.occ_grid.warmup_steps))
    torch.cuda.synchronize()
    print(f"forced (post-warmup) occupancy update in "
          f"{time.perf_counter() - t0:.3f} s: occupied fraction "
          f"{float(occ.binary.float().mean()):.4f}", flush=True)
    launches = scatter_rows.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        profile_steps(torch, trainer)
    print(f"training phase: K1 launches {launches}, peak device memory "
          f"{peak:.2f} GiB", flush=True)
    if launches <= 0:
        raise AssertionError("the training phase never launched K1")
    trainer._flush_pending_metrics()
    return {"scatter_add_rows": launches}


def phase_reference(torch):
    """Field outputs and table gradient: card (kernels) vs CPU (plain)."""
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the training phase, print the device "
                             "time by kernel over 3 more steps")
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
            launches = phase_training(torch, tmp, profile=args.profile)
    with phase("5 reference"):
        phase_reference(torch)

    main_row = rows[0]
    kernel = {
        "name": "scatter_add_rows", "route": "cuda",
        "source": SCATTER_SOURCE, "replaces": SCATTER_REPLACES,
        "launches": launches["scatter_add_rows"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "timed_shape": main_row["shape"], "shapes": rows,
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
