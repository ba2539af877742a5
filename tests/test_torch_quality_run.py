"""The port's quality harness (deblur_e_nerf_tpu_torch/quality_run.py)
against scripts/quality_run.py: the flat-field baseline on the same
dataset, and a small CPU run that generates its dataset, trains, resumes
and writes the JAX harness's files with its columns and row keys."""

import csv
import importlib.util
import math
import os

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from deblur_e_nerf_tpu.data import posed_images as jposed
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu_torch import quality_run
from deblur_e_nerf_tpu_torch.data import posed_images as tposed
from deblur_e_nerf_tpu_torch.utils.config import load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5FIX = os.path.join(REPO, "configs/train/quality_sphere_blur32_dense_r5fix"
                     ".yaml")
METRICS = {"l1", "lpips", "psnr", "ssim"}
FILTER = {"A_amp_inv", "A_loop_inv", "tau_diff", "tau_mil_it_eff_prod",
          "tau_out", "tau_sf"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes these small
    ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_run", os.path.join(REPO, "scripts/quality_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_flat_field_psnr_matches_the_jax_harness(tmp_path):
    """flat_field_psnr on the val views of one dataset (written by the JAX
    generator, read by each package's posed-image loader) equals
    scripts/quality_run.py's within 1e-9 dB."""
    root = str(tmp_path / "ds")
    jsynthetic.make_dataset(root, img_height=24, img_width=32,
                            num_poses=21, num_views=3)
    want = _jax_harness().flat_field_psnr(
        jposed.PosedImageDataset(root, "val", 9, True))
    got = quality_run.flat_field_psnr(
        tposed.PosedImageDataset(root, "val", 9, True))
    assert math.isfinite(want) and want > 0
    assert abs(got - want) <= 1e-9


def test_quality_run_needs_cuda_unless_the_cpu_is_asked_for(tmp_path,
                                                           monkeypatch):
    """Without a CUDA device the default `--device cuda` raises before
    anything is generated or trained: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_run.main(["--device", "cuda", "--data-root",
                          str(tmp_path / "ds"), "--log-dir",
                          str(tmp_path / "log")])
    assert not os.path.exists(tmp_path / "ds")


def _small_r5fix(path):
    """The r5fix config (filter model on, the prepass at div 2, checkpoints
    monitored on val/psnr) at test size: S = 4, 6 hash levels of 2^12
    rows, 16-wide MLPs, a 32^3 grid, 512 ray samples a step."""
    cfg = load_config(R5FIX)
    cfg.model.pixel_bandwidth.it_sample_size = 4
    pe = cfg.model.nerf.ngp.pos_encoding
    pe.n_levels, pe.base_resolution, pe.per_level_scale = 6, 4, 2.0
    pe.log2_hashmap_size = 12
    cfg.model.nerf.ngp.mlp_base.n_neurons = 16
    cfg.model.nerf.ngp.mlp_head.n_neurons = 16
    cfg.model.nerf.occ_grid.resolution = 32
    cfg.model.nerf.block_budget = None
    cfg.model.nerf.test_chunk_size = 256
    cfg.data.train_init_eff_batch_size = 8
    cfg.data.train_eff_ray_sample_batch_size = 512
    cfg.data.train_min_eff_batch_size = 4
    cfg.loss.density_sparsity_samples = 256
    save_config(cfg, path)
    return path


def test_quality_run_trains_resumes_and_writes_the_jax_harness_files(
        tmp_path):
    """A 32x32 run on the CPU: the harness generates its dataset (8 views,
    as the JAX harness), trains 2 epochs of 2 steps, then a fresh
    invocation with --resume epoch_0001 trains a third. psnr_vs_steps.csv
    has the JAX columns and 3 rows (steps 2, 4, 6, finite PSNR and SSIM,
    one flat-field PSNR); metrics.yaml, read by PyYAML, has the JAX
    harness's rows in its order with its keys: the final val and test
    metrics, the flat-field PSNR, the learned and initial filter
    parameters, and the best checkpoint's rows when it is not the last
    epoch's."""
    config = _small_r5fix(str(tmp_path / "r5fix_small.yaml"))
    root, log = str(tmp_path / "ds"), str(tmp_path / "log")
    common = ["--config", config, "--data-root", root, "--log-dir", log,
              "--img-size", "32", "--num-poses", "21", "--num-frames", "21",
              "--contrast-threshold", "0.05", "--orbits", "3",
              "--batch-capacity", "16", "--steps-per-epoch", "2",
              "--max-eval-images", "1", "--device", "cpu"]
    first = quality_run.main(common + ["--max-epochs", "2"])
    assert os.path.exists(os.path.join(root, "views"))
    second = quality_run.main(common + [
        "--max-epochs", "3", "--resume",
        os.path.join(log, "checkpoints", "epoch_0001")])
    with open(os.path.join(log, "psnr_vs_steps.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "psnr", "ssim", "flat_psnr"]
    assert [int(r[0]) for r in rows[1:]] == [2, 4, 6]
    assert all(math.isfinite(float(x)) for r in rows[1:] for x in r[1:])
    assert len({r[3] for r in rows[1:]}) == 1
    flat = float(rows[1][3])
    with open(os.path.join(log, "metrics.yaml")) as f:
        written = yaml.safe_load(f)
    assert [set(r) for r in written] == [set(r) for r in second]
    assert len(first) >= 4
    stages = [r.get("stage") for r in written]
    assert stages[:4] == ["val", "test", None, None]
    assert set(written[0]) == set(written[1]) == METRICS | {"stage"}
    assert written[2] == {"flat_field_psnr": flat}
    assert set(written[3]) == {"pixel_bandwidth_learned",
                               "pixel_bandwidth_init"}
    for name in ("pixel_bandwidth_learned", "pixel_bandwidth_init"):
        assert set(written[3][name]) == FILTER
        assert all(v > 0 for v in written[3][name].values())
    assert written[3]["pixel_bandwidth_learned"] \
        != written[3]["pixel_bandwidth_init"]
    assert stages[4:] in ([], ["val_best", "test_best"])
    for row in written[4:]:
        assert set(row) == METRICS | {"stage", "checkpoint"}
        assert row["checkpoint"] in ("epoch_0000", "epoch_0001")
    for row in written[:2]:
        for name in ("l1", "psnr", "ssim"):
            assert math.isfinite(row[name]), name
    assert np.isnan(written[0]["lpips"])  # no LPIPS weights in the repo
    # chip_smoke.py phase 9's reading of the same files
    epochs = chip_smoke.check_quality_outputs(log, second, 2, 3)
    assert [r[0] for r in epochs] == [2.0, 4.0, 6.0]
