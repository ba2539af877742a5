"""The port's PosedImageDataset (no OpenCV) against the JAX package's (OpenCV)
on the JAX generator's synthetic views (mono and Bayer), the RGBA
alpha-over-white case and quantized 8/16-bit PNG views, with and without a
permutation seed: images within rtol 1e-6 (OpenCV's float32 BGR->gray
sums in its own, CPU-dependent order: fused multiply-adds in its vector
lanes, plain products in each row's tail), and so the maximum of a float
view's normalized range; poses, intrinsics, ids, exposure, gain and the
rest of the range exact. The port's synthetic views load through the
JAX loader to the same arrays as the JAX generator's."""

import json
import os

import cv2
import numpy as np
import pytest

from deblur_e_nerf_tpu.data import posed_images as jposed
from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu_torch.data import posed_images as tposed
from deblur_e_nerf_tpu_torch.data import synthetic as tsynthetic

SYNTHETIC = dict(img_height=12, img_width=16, num_events=500, num_poses=13,
                 num_views=3, simulate_events=False)


def _assert_same(port, jax_ds):
    a, b = port.posed_imgs, jax_ds.posed_imgs
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        if key == "img":
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert port.min_normalized_pixel_value == jax_ds.min_normalized_pixel_value
    # the float views' maximum is a pixel of the image (the gray sum's
    # rtol); the quantized views' is exact
    assert port.max_normalized_pixel_value == pytest.approx(
        jax_ds.max_normalized_pixel_value, rel=1e-6, abs=0)
    assert len(port) == len(jax_ds)


@pytest.fixture(scope="module", params=[False, True], ids=["mono", "bayer"])
def synthetic_root(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("posed_ds")
    jsynthetic.make_dataset(str(root), bayer=request.param, **SYNTHETIC)
    return str(root)


@pytest.mark.parametrize("stage", ["train", "val", "test"])
@pytest.mark.parametrize("seed", [None, 5])
def test_synthetic_views_match_jax(synthetic_root, stage, seed):
    _assert_same(
        tposed.PosedImageDataset(synthetic_root, stage, seed, True),
        jposed.PosedImageDataset(synthetic_root, stage, seed, True))


def test_port_written_views_load_in_jax_loader(tmp_path):
    """The port's generator writes the views with its own TIFF writer; the
    JAX loader (OpenCV) reads them to the JAX generator's arrays."""
    tsynthetic.make_dataset(str(tmp_path / "port"), write_views=True,
                            **SYNTHETIC)
    jsynthetic.make_dataset(str(tmp_path / "jax"), **SYNTHETIC)
    for stage in ("train", "val", "test"):
        for name in os.listdir(tmp_path / "jax" / "views"):
            if name.endswith(".json"):
                assert json.loads((tmp_path / "port" / "views" / name)
                                  .read_text()) == json.loads(
                    (tmp_path / "jax" / "views" / name).read_text())
        want = jposed.PosedImageDataset(str(tmp_path / "jax"), stage)
        for port_ds in (
                jposed.PosedImageDataset(str(tmp_path / "port"), stage),
                tposed.PosedImageDataset(str(tmp_path / "port"), stage)):
            _assert_same(port_ds, want)


def _calibration(root, size, bayer=""):
    np.savez(root / "camera_calibration.npz",
             img_height=np.uint16(size), img_width=np.uint16(size),
             intrinsics=np.eye(3, dtype=np.float32),
             distortion_model="plumb_bob", distortion_params=np.zeros(0),
             bayer_pattern=bayer)


def _transforms(root, frames, **extra):
    with open(root / "views" / "transforms_train.json", "w") as f:
        json.dump({"intrinsics": (2.0 * np.eye(3)).tolist(),
                   "frames": frames, **extra}, f)


@pytest.mark.parametrize("bayer", ["", "RGGB"])
def test_rgba_alpha_over_white_matches_jax(tmp_path, bayer):
    """RGBA linear float views (as tests/test_posed_images.py builds
    them), composited over white or with the alpha dropped."""
    _calibration(tmp_path, 4, bayer)
    np.savez(tmp_path / "renderer_params.npz", interm_color_space="linear",
             log_eps=np.asarray(1e-3))
    (tmp_path / "views" / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        rgba = rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)
        cv2.imwrite(str(tmp_path / "views" / "train" / f"v{i}.tiff"), rgba)
        frames.append({"file_path": os.path.join("train", f"v{i}"),
                       "transform_matrix": np.eye(4).tolist()})
    _transforms(tmp_path, frames)
    for alpha_over in (True, False):
        for seed in (None, 3):
            _assert_same(
                tposed.PosedImageDataset(str(tmp_path), "train", seed,
                                         alpha_over),
                jposed.PosedImageDataset(str(tmp_path), "train", seed,
                                         alpha_over))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("bit_depth", [None, 10])
def test_quantized_views_match_jax(tmp_path, dtype, channels, bit_depth):
    """Real-data-like views: PNGs with explicit intrinsics, exposure and
    gain, no renderer_params (as tests/test_posed_images.py builds them),
    with the bit depth from the dtype or from the transforms."""
    _calibration(tmp_path, 8)
    (tmp_path / "views" / "train").mkdir(parents=True)
    rng = np.random.default_rng(channels)
    frames = []
    hi = 1 << (bit_depth or 8 * np.dtype(dtype).itemsize)
    for i in range(3):
        shape = (8, 8) if channels == 1 else (8, 8, channels)
        img = rng.integers(0, min(hi, np.iinfo(dtype).max + 1), shape,
                           dtype=dtype)
        cv2.imwrite(str(tmp_path / "views" / "train" / f"v{i}.png"), img)
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        frames.append({"file_path": os.path.join("train", f"v{i}"),
                       "transform_matrix": T.tolist(),
                       "exposure_time": 5_000_000 + i, "gain": 1.5 + i})
    extra = {} if bit_depth is None else {"bit_depth": bit_depth}
    _transforms(tmp_path, frames, **extra)
    for seed in (None, 7):
        _assert_same(
            tposed.PosedImageDataset(str(tmp_path), "train", seed, False),
            jposed.PosedImageDataset(str(tmp_path), "train", seed, False))


def test_color_conversions_match_cv2():
    """The channel flip and float32 gray sum against cv2.cvtColor."""
    rng = np.random.default_rng(1)
    bgr = rng.uniform(0, 2, (3, 17, 23, 3)).astype(np.float32)
    gray = rng.uniform(0, 2, (3, 17, 23)).astype(np.float32)
    np.testing.assert_array_equal(
        tposed.bgr_to_rgb(bgr),
        np.stack([cv2.cvtColor(s, cv2.COLOR_BGR2RGB) for s in bgr]))
    np.testing.assert_array_equal(
        tposed.bgr_to_rgb(gray),
        np.stack([cv2.cvtColor(s, cv2.COLOR_BGR2RGB) for s in gray]))
    want = np.stack([cv2.cvtColor(s, cv2.COLOR_BGR2GRAY) for s in bgr])
    got = tposed.bgr_to_gray(bgr)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
