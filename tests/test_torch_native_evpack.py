"""The port's native event packer (data/native_evpack.py, native/evpack.cpp
built with the host compiler into the package's _build/) against the JAX
package's native packer and the port's numpy path: exactly equal packed
intervals and maximum refractory period, on the stream of
tests/test_events_native.py (with its duplicate timestamp at one pixel),
an empty stream and a one-event stream; a failed build raises with the
compiler's output; datasets pack natively unless asked otherwise."""

import os

import numpy as np
import pytest

from deblur_e_nerf_tpu.data import native_evpack as jnative
from deblur_e_nerf_tpu_torch.data import events as tevents
from deblur_e_nerf_tpu_torch.data import native_evpack as tnative
from deblur_e_nerf_tpu_torch.data import synthetic


@pytest.fixture(scope="module")
def stream():
    """tests/test_events_native.py's stream."""
    rng = np.random.default_rng(42)
    n = 50_000
    h = w = 32
    positions = np.stack(
        [rng.integers(0, w, n), rng.integers(0, h, n)], axis=1
    ).astype(np.uint16)
    timestamps = np.sort(rng.integers(0, 10 ** 7, n)).astype(np.int64)
    positions[1] = positions[0]
    timestamps[1] = timestamps[0]
    polarities = rng.integers(0, 2, n).astype(bool)
    return positions, timestamps, polarities, h, w


def _assert_packs_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_native_pack_equals_jax_native_and_numpy(stream):
    positions, timestamps, polarities, h, w = stream
    got = tnative.pack_events(positions, timestamps, polarities, h, w)
    _assert_packs_equal(got, jnative.pack_events(positions, timestamps,
                                                 polarities, h, w))
    _assert_packs_equal(got, tevents.pack_events(positions, timestamps,
                                                 polarities, h, w))
    # the duplicate timestamp at one pixel starts no interval
    assert 0 < len(got["end_ts"]) < len(timestamps)
    assert not np.any(got["start_ts"] == got["end_ts"])


def test_native_max_refractory_equals_jax_native_and_numpy(stream):
    positions, timestamps, _, h, w = stream
    got = tnative.max_refractory_period(positions, timestamps, h, w)
    assert got == jnative.max_refractory_period(positions, timestamps, h, w)
    assert got == tevents.extract_max_refractory_period(positions,
                                                        timestamps, h, w)
    assert got.dtype == np.int64 and 0 < got


@pytest.mark.parametrize("n", [0, 1])
def test_native_packer_on_streams_without_intervals(n):
    positions = np.zeros((n, 2), np.uint16)
    timestamps = np.full(n, 5, np.int64)
    polarities = np.ones(n, bool)
    got = tnative.pack_events(positions, timestamps, polarities, 4, 4)
    _assert_packs_equal(got, tevents.pack_events(positions, timestamps,
                                                 polarities, 4, 4))
    assert len(got["end_ts"]) == 0
    rp = tnative.max_refractory_period(positions, timestamps, 4, 4)
    assert np.isinf(float(rp))
    assert np.isinf(float(tevents.extract_max_refractory_period(
        positions, timestamps, 4, 4)))


def test_native_packer_checks_its_inputs():
    """The C code indexes a (height x width) table by pixel unchecked, so
    positions outside the sensor raise before the call."""
    ts = np.arange(3, dtype=np.int64)
    with pytest.raises(ValueError, match="outside the 4x4 sensor"):
        tnative.pack_events(np.array([[0, 0], [4, 1], [1, 1]], np.uint16),
                            ts, np.ones(3, bool), 4, 4)
    with pytest.raises(ValueError, match="polarities"):
        tnative.pack_events(np.zeros((3, 2), np.uint16), ts,
                            np.ones(2, bool), 4, 4)


def test_failed_native_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "evpack_broken.cpp"
    bad.write_text("int evpack_pack( { this is not C++ }\n")
    with pytest.raises(RuntimeError, match="building the event packer "
                                           "failed(.|\n)*error"):
        tnative.build(str(bad))
    with pytest.raises(RuntimeError, match="not found"):
        tnative.build(str(bad), cxx="no-such-compiler-here")
    # the library lands in the port's build directory, never in native/
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(path).startswith("evpack_")


def test_event_dataset_packs_natively_unless_asked(tmp_path, capsys):
    """EventDataset and load_max_refractory_period use the native packer by
    default and name it in one log line; `native=False` runs numpy, with
    the same events and period."""
    out = {}
    for native in (True, False):
        root = synthetic.make_dataset(str(tmp_path / str(native)),
                                      img_height=12, img_width=12,
                                      num_poses=11)
        out[native] = (tevents.EventDataset(root, native=native).events,
                       tevents.load_max_refractory_period(root,
                                                          native=native))
        log = capsys.readouterr().out
        assert f"with the {'native' if native else 'numpy'} packer" in log
    _assert_packs_equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
