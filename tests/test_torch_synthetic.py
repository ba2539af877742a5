"""The port's synthetic generator against the JAX package's with the full
pixel-circuit filter: `filter_log_frames_full` on the same log frames, and
`make_dataset(pixel_filter='full', bandwidth_scale=32)` (the generator of
the quality_sphere_blur30 / blur32_dense configs' datasets) on a small
scene."""

from collections import defaultdict

import numpy as np
import pytest

from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu_torch.data import synthetic as tsynthetic


def _calib(scale):
    s = float(scale)
    return dict(
        input_time_const_eff_it_prod=np.asarray(1e-4 * s),
        miller_time_const_eff_it_prod=np.asarray(2e-5 * s),
        amplifier_gain=np.asarray(50.0), closed_loop_gain=np.asarray(10.0),
        output_time_const=np.asarray(1e-4 * s),
        sf_cutoff_freq=np.asarray(500.0 / s),
        diff_amp_cutoff_freq=np.asarray(200.0 / s))


@pytest.mark.parametrize("bandwidth_scale", [1, 32])
def test_filter_log_frames_full_matches_jax(bandwidth_scale):
    """The float32 FOH chain from the first frame's DC steady state: the
    filtered log intensity within 1e-5 absolute of the JAX package's, over
    60 frames of 200 pixels with uneven frame intervals; it is a real
    blur (the output lags the input)."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.integers(2_000_000, 8_000_000, 60)).astype(np.int64)
    base = rng.uniform(-4.0, 0.0, 200)
    log_frames = (base[None] + 0.8 * np.sin(
        t[:, None] * 2e-9 * np.pi + rng.uniform(0, 6, 200)[None])
    ).astype(np.float32)
    calib = _calib(bandwidth_scale)
    want = jsynthetic.filter_log_frames_full(log_frames, t, calib)
    got = tsynthetic.filter_log_frames_full(log_frames, t, calib)
    assert got.shape == want.shape == log_frames.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], log_frames[0])
    assert np.abs(got - log_frames).max() > 1e-2


def _per_pixel(events):
    seqs = defaultdict(list)
    for (x, y), t, p in zip(events["position"].tolist(),
                            events["timestamp"].tolist(),
                            events["polarity"].tolist()):
        seqs[x, y].append((t, p))
    return seqs


def test_full_filter_dataset_matches_jax(tmp_path):
    """make_dataset(pixel_filter='full', bandwidth_scale=32, C = 0.05, 3
    orbits) in both packages: the same calibration, and the same events
    pixel by pixel (count and polarity sequence), with each crossing's
    timestamp moved by at most 1e-4 of a frame interval. The float32
    chains differ by ~1e-6 in log intensity, which shifts the interpolated
    crossing times; an event that flips at a threshold crossing (present
    in one stream only) may occur, and is bounded here by 0.1% of the
    stream (measured: none)."""
    kw = dict(img_height=20, img_width=20, num_poses=61,
              contrast_threshold=0.05, orbits=3, pixel_filter="full",
              bandwidth_scale=32)
    jroot = jsynthetic.make_dataset(str(tmp_path / "jax"), **kw)
    troot = tsynthetic.make_dataset(str(tmp_path / "port"), **kw)
    jcal = np.load(f"{jroot}/camera_calibration.npz")
    tcal = np.load(f"{troot}/camera_calibration.npz")
    assert set(jcal.files) == set(tcal.files)
    for k in jcal.files:
        np.testing.assert_array_equal(tcal[k], jcal[k], err_msg=k)
    want = dict(np.load(f"{jroot}/raw_events.npz"))
    got = dict(np.load(f"{troot}/raw_events.npz"))
    n = len(want["timestamp"])
    assert n > 5_000
    frame_interval = 2e9 * kw["orbits"] / (kw["num_poses"] - 1)
    seq_j, seq_t = _per_pixel(want), _per_pixel(got)
    flips, max_shift = 0, 0
    for pixel in set(seq_j) | set(seq_t):
        a, b = seq_j.get(pixel, []), seq_t.get(pixel, [])
        if [p for _, p in a] != [p for _, p in b]:
            flips += max(abs(len(a) - len(b)), 1)
            continue
        max_shift = max([max_shift] + [abs(x - y) for (x, _), (y, _)
                                       in zip(a, b)])
    assert flips <= 1e-3 * n, flips
    assert flips == 0  # measured on this scene
    assert max_shift <= 1e-4 * frame_interval, max_shift
    assert len(got["timestamp"]) == n
    assert np.all(np.diff(got["timestamp"]) >= 0)
