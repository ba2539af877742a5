"""The port's evaluation host code against the JAX package's: L1, PSNR,
SSIM, the log-affine correction, the GN/LM offset-gamma correction
(float64 numpy in both, rtol 1e-10), LPIPS with seeded stub weights (all
three nets, rtol 1e-5) and its NaN semantics, and Evaluator.epoch_end over
two epochs (warm start) with and without the black-level offset (metrics
and correction errors at rtol 1e-9; the saved predictions equal)."""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from deblur_e_nerf_tpu.data import posed_images as jposed
from deblur_e_nerf_tpu.models import offset_gamma as jog
from deblur_e_nerf_tpu.training import evaluation as jevaluation
from deblur_e_nerf_tpu.training import metrics as jmetrics
from deblur_e_nerf_tpu_torch.models import offset_gamma as tog
from deblur_e_nerf_tpu_torch.training import evaluation as tevaluation
from deblur_e_nerf_tpu_torch.training import metrics as tmetrics
from deblur_e_nerf_tpu_torch.utils.config import ConfigDict


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, where torch's spinning thread pool makes these small
    ops many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed, shape=(2, 3, 24, 20)):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.05, 1.0, shape)
    pred = np.clip(target * rng.uniform(0.7, 1.3, shape)
                   + rng.normal(0, 0.05, shape), 0.01, None)
    return pred, target


def test_l1_psnr_ssim_match_jax():
    pred, target = _pair(0)
    for name, args in (("l1", ()), ("psnr", (0.95,)), ("ssim", (1.0,))):
        got = getattr(tmetrics, name)(pred, target, *args)
        want = getattr(jmetrics, name)(pred, target, *args)
        assert got == pytest.approx(want, rel=1e-10, abs=0), name


@pytest.mark.parametrize("per_channel", [True, False])
def test_affine_log_correction_matches_jax(per_channel):
    pred, target = _pair(1)
    got = tevaluation.affine_log_correction(np.log(pred), np.log(target),
                                            per_channel)
    want = jevaluation.affine_log_correction(np.log(pred), np.log(target),
                                             per_channel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=0)


@pytest.mark.parametrize("algo", ["gn", "lm"])
@pytest.mark.parametrize("channels", [1, 3])
def test_offset_gamma_optimize_matches_jax(algo, channels):
    rng = np.random.default_rng(2)
    x = rng.uniform(0.05, 1.0, (2, 3, 8, 8, 1))
    target = 1.2 * (0.9 * x ** 1.1 - 0.02) + rng.normal(0, 1e-3, x.shape)
    const = np.array([0.8, 1.2]).reshape(2, 1, 1, 1, 1)
    init = (np.ones((3, 1, 1, 1)), np.ones((channels, 1, 1, 1)),
            np.zeros((3, 1, 1, 1)))
    corrections = [lib.OffsetGammaCorrection(const, *init)
                   for lib in (tog, jog)]
    errors = [lib.optimize(c, x, target, algo=algo, max_steps=10)
              for lib, c in zip((tog, jog), corrections)]
    assert len(errors[0]) == len(errors[1]) > 1
    np.testing.assert_allclose(errors[0], errors[1], rtol=1e-10, atol=0)
    np.testing.assert_allclose(corrections[0].params(),
                               corrections[1].params(), rtol=1e-10, atol=0)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    return {net: chip_smoke.write_lpips_stub(torch, str(root / f"{net}.pt"),
                                             net, seed=i)
            for i, net in enumerate(("alex", "vgg", "squeeze"))}


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
@pytest.mark.parametrize("channels", [1, 3])
def test_lpips_matches_jax_with_stub_weights(lpips_weights, net, channels):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.1, 0.9, (1, channels, 64, 48))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0.0, 1.0)
    got = tmetrics.lpips(a, b, 0.05, 0.95, net, lpips_weights[net])
    want = jmetrics.lpips(a, b, 0.05, 0.95, net, lpips_weights[net])
    assert got is not None and np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert tmetrics.lpips(a, a, 0.05, 0.95, net, lpips_weights[net]) \
        == pytest.approx(0.0, abs=1e-9)


def test_lpips_nan_without_weights_or_with_a_wrong_net(lpips_weights,
                                                       capsys):
    a = np.random.default_rng(4).uniform(0.1, 0.9, (1, 1, 64, 64))
    assert np.isnan(tmetrics.compute_all(a[0], a[0], 0.0, 1.0)["lpips"])
    for _ in range(2):
        out = tmetrics.compute_all(a[0], a[0], 0.0, 1.0, "resnet",
                                   lpips_weights["alex"])
        assert np.isnan(out["lpips"]) and out["psnr"] > 100
    assert capsys.readouterr().out.count("LPIPS unavailable") == 1


def _outputs(seed, channels, n=2, shape=(32, 40)):
    rng = np.random.default_rng(seed)
    outputs = []
    for i in range(n):
        target = rng.uniform(0.05, 0.95, (channels, *shape)).squeeze(0) \
            if channels == 1 else rng.uniform(0.05, 0.95, (channels, *shape))
        pred = np.clip(0.7 * target ** 1.3 + rng.normal(0, 0.02,
                                                        target.shape),
                       0.01, None)
        outputs.append({
            "sample_id": jposed.normalize_sample_id(f"val_{i:03d}"),
            "pred_intensity_img": pred.astype(np.float32),
            "target_intensity_img": target.astype(np.float32),
            "exposure_time": 1000 * (i + 1), "gain": 1.0 + 0.5 * i})
    return outputs


@pytest.mark.parametrize("black_level_offset", [True, False])
@pytest.mark.parametrize("has_bayer", [False, True])
def test_evaluator_epoch_end_matches_jax_over_two_epochs(
        tmp_path, lpips_weights, black_level_offset, has_bayer):
    cfg = ConfigDict({"per_channel_log_it_scale": False,
                      "black_level_offset": black_level_offset,
                      "optimizer": {"algo": "lm", "max_steps": 10}})
    channels = 3 if has_bayer else 1
    ev = {name: lib.Evaluator(cfg, has_bayer, log_dir=str(tmp_path / name),
                              save_pred_intensity_img=True)
          for name, lib in (("port", tevaluation), ("jax", jevaluation))}
    for epoch in (0, 1):
        outputs = _outputs(epoch, channels)
        got = ev["port"].epoch_end(outputs, 0.001, 0.999, epoch=epoch,
                                   lpips_weights_path=lpips_weights["alex"])
        want = ev["jax"].epoch_end(outputs, 0.001, 0.999, epoch=epoch,
                                   lpips_weights_path=lpips_weights["alex"])
        assert set(got) == set(want) == {"l1", "psnr", "ssim", "lpips"}
        for name in want:
            assert got[name] == pytest.approx(want[name], rel=1e-9), name
        for attr in ("init_scale", "init_gamma", "init_offset"):
            np.testing.assert_allclose(getattr(ev["port"], attr),
                                       getattr(ev["jax"], attr), rtol=1e-9)
        if black_level_offset:
            csv = f"correction-errors/{epoch}.csv"
            np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / csv),
                                       np.loadtxt(tmp_path / "jax" / csv),
                                       rtol=1e-9)
        else:
            assert not (tmp_path / "port" / "correction-errors").exists()
        for i in range(2):
            png = f"predictions/val_{i:03d}.png"
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "port" / png),
                           cv2.IMREAD_UNCHANGED),
                cv2.imread(str(tmp_path / "jax" / png),
                           cv2.IMREAD_UNCHANGED))
    if black_level_offset:  # the second epoch started from the first's fit
        assert not np.allclose(ev["port"].init_gamma, 1.0)
