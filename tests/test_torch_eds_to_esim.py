"""The port's EDS converter (deblur_e_nerf_tpu_torch/data/eds_to_esim.py)
and what it stands on, on the CPU, against the JAX package's script
(scripts/eds_to_esim.py) and the libraries it used, which this machine has
and the GPU machine has not: PyYAML (`utils/config.yaml_load`), h5py
(`data/hdf5.py`), OpenCV (`data/undistort.py`) and jax (the pose slerp).
Inputs come from numpy seeds."""

import json
import os

import cv2
import h5py
import numpy as np
import pytest
import yaml

import chip_smoke
import test_preprocess
from deblur_e_nerf_tpu_torch.data import eds_to_esim, hdf5, undistort
from deblur_e_nerf_tpu_torch.utils.config import yaml_load
from test_preprocess import raw_eds  # noqa: F401  (the script's fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = test_preprocess.eds_to_esim  # scripts/eds_to_esim.py
EVENTS_CHUNK = 1024  # the events fixture's chunk, in events


# ----------------------------------------------------------------- YAML
def test_yaml_reader_reads_both_camchain_forms_as_pyyaml():
    """A Kalibr camera chain with `- [..]` rows, and the nested `- - 1.0`
    form yaml.safe_dump writes (the fixture of tests/test_preprocess.py),
    read as yaml.safe_load reads them; items outside the subset raise."""
    kalibr = chip_smoke.eds_camchain_text()
    dumped = yaml.safe_dump({
        "cam0": {"camera_model": "pinhole", "intrinsics": [40.0, 40.0, 16.0,
                                                           12.0],
                 "distortion_model": "none",
                 "distortion_coeffs": [0.0, 0.0, 0.0, 0.0],
                 "resolution": [32, 24]},
        "cam1": {"camera_model": "pinhole",
                 "intrinsics": [30.0, 30.0, 8.0, 8.0],
                 "distortion_model": "radtan",
                 "distortion_coeffs": [0.01, 0.0, 0.0, 0.0],
                 "resolution": [16, 16], "T_cn_cnm1": np.eye(4).tolist()}})
    assert "- - 1.0" in dumped and "  - [" in kalibr
    for text in (kalibr, dumped,
                 "a:\n  - - 1\n    - - 2\n      - 3\n  - [4, {b: 5}]\nc: x\n",
                 "- 1\n- - 2\n  - 3\n"):
        assert yaml_load(text) == yaml.safe_load(text), text
    for text in ("a:\n- b: 1\n", "a:\n-\n  - 1\n", "- 1\n  - 2\n",
                 "a:\n  - 1\n - 2\n"):
        with pytest.raises(ValueError):
            yaml_load(text)


# ----------------------------------------------------------------- HDF5
def _dataset_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "uint8": rng.integers(0, 256, 1000).astype(np.uint8),
        "uint16": rng.integers(0, 65536, (37, 29)).astype(np.uint16),
        "int64": np.sort(rng.integers(-2 ** 40, 2 ** 40, 5000)),
        "float64": rng.standard_normal((13, 7, 5)),
        "bool": rng.integers(0, 2, 777).astype(bool),
        "int32_be": rng.integers(-2 ** 31, 2 ** 31 - 1, 300).astype(">i4"),
        "float32_be": rng.standard_normal(300).astype(">f4"),
        "float16": rng.standard_normal(100).astype(np.float16),
    }


# (h5py create_dataset keywords, chunk shape from the data shape)
HDF5_LAYOUTS = {
    "contiguous": ({}, None),
    "chunked": ({}, lambda s: tuple(max(1, d // 3 - 1) for d in s)),
    "gzip": ({"compression": "gzip"}, lambda s: tuple(max(1, d // 4)
                                                      for d in s)),
    "shuffle_gzip": ({"compression": "gzip", "shuffle": True},
                     lambda s: tuple(max(1, d // 3 - 1) for d in s)),
    "lzf": ({"compression": "lzf"}, lambda s: tuple(max(1, d // 2 + 1)
                                                    for d in s)),
    "one_gzip_chunk": ({"compression": "gzip", "shuffle": True},
                       lambda s: s),
}


def _write_layouts(path, libver):
    """Every layout of HDF5_LAYOUTS for every array of _dataset_arrays (a
    group a layout: at most 8 links a group), partial edge chunks in
    every chunked one; under misc/: a compact dataset, an empty one, a
    scalar, a nested group and 2,250 gzip chunks (a paged fixed array
    under libver latest). Returns {path: array}."""
    want = {}
    rng = np.random.default_rng(1)
    with h5py.File(path, "w", libver=libver) as f:
        for layout, (kw, chunk_of) in HDF5_LAYOUTS.items():
            for name, a in _dataset_arrays().items():
                extra = {"chunks": chunk_of(a.shape)} if chunk_of else {}
                f.create_dataset(f"{layout}/{name}", data=a, **kw, **extra)
                want[f"{layout}/{name}"] = a
        misc = f.create_group("misc")
        compact = np.arange(20, dtype="<u2") * 3
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(misc.id, b"compact",
                             h5py.h5t.py_create(compact.dtype),
                             h5py.h5s.create_simple(compact.shape),
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, compact)
        want["misc/compact"] = compact
        want["misc/empty"] = np.zeros((0, 3), np.int64)
        misc.create_dataset("empty", data=want["misc/empty"])
        want["misc/scalar"] = np.float64(3.5)
        misc.create_dataset("scalar", data=want["misc/scalar"])
        want["misc/nested/deeper/x"] = np.arange(10, dtype=np.uint16)
        misc.create_group("nested/deeper")["x"] = want["misc/nested/deeper/x"]
        want["misc/many_chunks"] = rng.integers(0, 1000, 9000).astype(
            np.int32)
        misc.create_dataset("many_chunks", data=want["misc/many_chunks"],
                            chunks=(4,), compression="gzip")
    return want


@pytest.mark.parametrize("libver", ["earliest", "v108", "latest"])
def test_hdf5_reader_matches_h5py(tmp_path, libver):
    """data/hdf5.py reads what h5py wrote, value for value and dtype for
    dtype (in native byte order), across contiguous, compact and chunked
    layouts (plain, gzip, shuffle + gzip, lzf, one filtered chunk, partial
    edge chunks, a paged fixed array), empty and scalar datasets, nested
    groups, and superblocks 0, 2 and 3."""
    path = str(tmp_path / f"{libver}.h5")
    want = _write_layouts(path, libver)
    with open(path, "rb") as f:
        assert f.read(9)[8] == {"earliest": 0, "v108": 2, "latest": 3}[libver]
    with hdf5.File(path) as f, h5py.File(path, "r") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        assert sorted(f["misc"].keys()) == sorted(g["misc"].keys())
        assert "misc" in f and "nothing" not in f
        for name, a in want.items():
            got = f[name]
            ref = g[name][()]
            assert got.shape == ref.shape == np.shape(a), name
            assert got.dtype == ref.dtype.newbyteorder("="), name
            assert np.array_equal(got, ref) and np.array_equal(got, a), name
        assert f["misc"]["nested"]["deeper"]["x"].tolist() == list(range(10))
        with pytest.raises(KeyError):
            f["misc/nothing"]


@pytest.mark.parametrize("case", ["scaleoffset", "fletcher32", "extensible",
                                  "dense_links", "string", "missing_chunk"])
def test_hdf5_reader_refuses_what_it_does_not_read(tmp_path, case):
    """An unsupported filter, chunk index, link storage or datatype, or a
    chunk never written, raises ValueError naming it: never zeros."""
    path = str(tmp_path / "x.h5")
    data = np.arange(100, dtype=np.int32)
    match = {"scaleoffset": "scaleoffset", "fletcher32": "fletcher32",
             "extensible": "extensible array", "dense_links": "dense link",
             "string": "datatype class", "missing_chunk": "never"}[case]
    with h5py.File(path, "w", libver="latest") as f:
        if case == "scaleoffset":
            f.create_dataset("d", data=data, chunks=(10,), scaleoffset=0)
        elif case == "fletcher32":
            f.create_dataset("d", data=data, chunks=(10,), fletcher32=True)
        elif case == "extensible":
            f.create_dataset("d", data=data, chunks=(10,), maxshape=(None,))
        elif case == "dense_links":
            for k in range(12):
                f.create_dataset(f"d{k}", data=data)
        elif case == "string":
            f.create_dataset("d", data=np.array([b"ab", b"cd"]))
        else:
            ds = f.create_dataset("d", shape=(100,), dtype=np.int32,
                                  chunks=(10,))
            ds[:30] = data[:30]
    with hdf5.File(path) as f, pytest.raises(ValueError, match=match):
        f["d"]


def test_hdf5_lzf_and_shuffle_helpers():
    """unshuffle against a byte-plane loop, and lzf_decompress on a stream
    with literal runs, a long back reference and an overlapping one (a
    repeating pattern)."""
    rng = np.random.default_rng(3)
    for itemsize in (1, 2, 4, 8):
        raw = rng.integers(0, 256, 12 * itemsize + 3).astype(np.uint8)
        shuffled = bytearray()
        n = len(raw) // itemsize
        for b in range(itemsize):
            shuffled += bytes(raw[b:n * itemsize:itemsize])
        shuffled += bytes(raw[n * itemsize:])
        assert hdf5.unshuffle(bytes(shuffled), itemsize) == raw.tobytes()
    # "abcabcabcabc" + "xyz" * 4: literal "abc", back ref len 9 at offset
    # 3 (overlapping), literal "xyz", back ref len 9 at offset 3
    stream = bytes([2]) + b"abc" + bytes([(7 << 5), 9 - 2 - 7, 2]) \
        + bytes([2]) + b"xyz" + bytes([(7 << 5), 9 - 2 - 7, 2])
    assert hdf5.lzf_decompress(stream) == b"abc" * 4 + b"xyz" * 4
    # a short back reference (length 3) to the start
    stream = bytes([3]) + b"wxyz" + bytes([1 << 5, 3])
    assert hdf5.lzf_decompress(stream) == b"wxyzwxy"


def write_eds_events_h5(path, chunk=EVENTS_CHUNK):
    """The generator of tests/fixtures/eds_events.h5: the arrays of
    chip_smoke.eds_fixture_events, chunked, shuffled and gzipped by
    h5py."""
    with h5py.File(path, "w") as f:
        for name, a in chip_smoke.eds_fixture_events().items():
            f.create_dataset(name, data=a, chunks=(chunk,),
                             compression="gzip", shuffle=True)


def test_committed_eds_events_fixture_is_what_its_generator_writes(
        tmp_path):
    """tests/fixtures/eds_events.h5 holds what `write_eds_events_h5`
    writes (datasets, dtypes, chunks and filters, by h5py), is at most 64
    KiB, and the port's reader reads it as h5py does."""
    fixture = os.path.join(REPO, chip_smoke.EDS_EVENTS_FIXTURE)
    assert os.path.getsize(fixture) <= 64 * 1024
    fresh = str(tmp_path / "fresh.h5")
    write_eds_events_h5(fresh)
    want = chip_smoke.eds_fixture_events()
    with h5py.File(fixture, "r") as a, h5py.File(fresh, "r") as b, \
            hdf5.File(fixture) as port:
        assert sorted(a.keys()) == sorted(b.keys()) == sorted(want)
        for name in want:
            for attr in ("dtype", "shape", "chunks", "compression",
                         "shuffle"):
                assert getattr(a[name], attr) == getattr(b[name], attr), \
                    (name, attr)
            assert a[name].chunks and a[name].compression == "gzip" \
                and a[name].shuffle
            assert np.array_equal(a[name][()], want[name])
            assert np.array_equal(port[name], want[name])
            assert port[name].dtype == want[name].dtype


# ------------------------------------------------------------ undistortion
CAMERAS = [
    # (size, K, D): the EDS RGB camera's, a DAVIS346-sized one with k3,
    # the same with the thin prism (12) and with the tilted sensor (14),
    # the test_preprocess fixture's, and no distortion
    ((640, 480), [[560.24, 0, 320.51], [0, 561.12, 240.23], [0, 0, 1]],
     [-0.3622, 0.1358, 0.00062, 0.00051]),
    ((346, 260), [[300., 0, 170.], [0, 300., 130.], [0, 0, 1]],
     [-0.1, 0.02, 0.0005, -0.0003, 0.001]),
    ((346, 260), [[300., 0, 170.], [0, 300., 130.], [0, 0, 1]],
     [-0.1, 0.02, 0.0005, -0.0003, 0.001, 0.01, 0.002, 0.001, 1e-3, -5e-4,
      8e-4, -2e-4]),
    ((346, 260), [[300., 0, 170.], [0, 300., 130.], [0, 0, 1]],
     [-0.1, 0.02, 0.0005, -0.0003, 0.001, 0.01, 0.002, 0.001, 1e-3, -5e-4,
      8e-4, -2e-4, 0.01, -0.02]),
    ((32, 24), [[40., 0, 16.], [0, 40., 12.], [0, 0, 1]],
     [0.1, -0.05, 0.001, -0.002]),
    ((64, 48), [[50., 0, 31.5], [0, 50., 23.5], [0, 0, 1]], [0, 0, 0, 0]),
]


@pytest.mark.parametrize("size,K,D", CAMERAS)
def test_undistortion_matches_opencv(size, K, D):
    """optimal_new_camera_matrix within 1e-3 px of
    cv2.getOptimalNewCameraMatrix (alpha 0, 1 and 0.3) with the same
    valid rectangle, and undistort_image within 1 code value of
    cv2.undistort on every pixel: 8-bit colour and 16-bit grey."""
    K, D = np.array(K, np.float32), np.array(D, np.float32)
    width, height = size
    for alpha in (0.0, 1.0, 0.3):
        want, roi = cv2.getOptimalNewCameraMatrix(K, D, size, alpha=alpha)
        got, got_roi = undistort.optimal_new_camera_matrix(K, D, size, alpha)
        assert got.dtype == K.dtype
        assert np.abs(got.astype(np.float64) - want).max() <= 1e-3
        assert got_roi == tuple(roi)
    new_K, _ = cv2.getOptimalNewCameraMatrix(K, D, size, alpha=0)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:height, 0:width]
    for img in (rng.integers(0, 256, (height, width, 3)).astype(np.uint8),
                ((xx * 7 + yy * 3) % 256).astype(np.uint8)[..., None]
                .repeat(3, -1),
                rng.integers(0, 65536, (height, width)).astype(np.uint16),
                (xx * 997 + yy * 4099).astype(np.uint16)):
        want = cv2.undistort(img, K, D, newCameraMatrix=new_K)
        got = undistort.undistort_image(img, K, D, new_K)
        assert got.dtype == img.dtype and got.shape == img.shape
        assert np.abs(got.astype(np.int64) - want).max() <= 1


# ------------------------------------------------------------------ poses
def test_pose_slerp_matches_the_jax_script():
    """rgb_poses_from_event_trajectory on the CPU within 1e-5 of the JAX
    script's, on a rotating trajectory, at image times inside the window,
    on pose times and at both ends, with a cam-to-cam extrinsic."""
    raw = chip_smoke.eds_rotating_poses()
    ts = (1e9 * raw[:, 0]).astype(np.int64)
    ts = ts - ts[0]
    pos, quat = raw[:, 1:4].astype(np.float32), raw[:, 4:8].astype(
        np.float32)
    image_ts = np.concatenate([[0, ts[-1], ts[3]], np.sort(
        np.random.default_rng(0).integers(0, ts[-1], 40))]).astype(np.int64)
    T = np.array(yaml_load(chip_smoke.eds_camchain_text())["cam1"][
        "T_cn_cnm1"], np.float32)
    got = eds_to_esim.rgb_poses_from_event_trajectory(
        pos, quat, ts, image_ts, T, device="cpu")
    want = SCRIPT.rgb_poses_from_event_trajectory(pos, quat, ts, image_ts, T)
    assert got.dtype == np.float32 and got.shape == (len(image_ts), 4, 4)
    assert np.abs(got - want).max() <= 1e-5
    # the card by default: this file imports jax, so it runs only where
    # there is no card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eds_to_esim.rgb_poses_from_event_trajectory(pos, quat, ts, image_ts,
                                                    T)


# ------------------------------------------------------------- converter
@pytest.mark.parametrize("sequence", ["test_preprocess", "chip_smoke"])
def test_converter_matches_the_jax_script(tmp_path, monkeypatch, request,
                                          sequence):
    """The whole converter on the CPU against scripts/eds_to_esim.py on
    one raw sequence (tests/test_preprocess.py's fixture: h5py events, cv2
    images, a yaml.safe_dump calibration; and chip_smoke's phase-11 one: a
    Kalibr text calibration with radtan on both cameras, a rotating
    trajectory, the committed events fixture, image_io PNGs): every npz
    array equal (dtype, shape and bytes), the transforms' intrinsics within
    1e-3 px and poses within 1e-5, the rest of each frame equal, every
    undistorted image within 1 code value of cv2's."""
    if sequence == "test_preprocess":
        calib, raw, _ = (str(p) for p in request.getfixturevalue("raw_eds"))
    else:
        calib, raw = chip_smoke.write_eds_sequence(str(tmp_path / "seq"))
    port_out, script_out = str(tmp_path / "port"), str(tmp_path / "script")
    assert eds_to_esim.main([calib, raw, port_out, "--device", "cpu"]) == 0
    monkeypatch.setattr("sys.argv", ["eds_to_esim.py", calib, raw,
                                     script_out])
    SCRIPT.main()
    for name in (eds_to_esim.CAMERA_CALIBRATION_FILENAME,
                 eds_to_esim.CAMERA_POSES_FILENAME,
                 eds_to_esim.EVENTS_FILENAME):
        with np.load(os.path.join(port_out, name)) as a, \
                np.load(os.path.join(script_out, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    views = os.path.join("views", "transforms_train.json")
    with open(os.path.join(port_out, views)) as f:
        got = json.load(f)
    with open(os.path.join(script_out, views)) as f:
        want = json.load(f)
    assert np.abs(np.subtract(got["intrinsics"], want["intrinsics"])
                  ).max() <= 1e-3
    assert len(got["frames"]) == len(want["frames"]) == 3
    for a, b in zip(got["frames"], want["frames"]):
        assert np.abs(np.subtract(a.pop("transform_matrix"),
                                  b.pop("transform_matrix"))).max() <= 1e-5
        assert a == b
    stage = os.path.join(port_out, "views", "train")
    names = sorted(os.listdir(stage))
    assert names == sorted(os.listdir(os.path.join(script_out, "views",
                                                   "train")))
    for name in names:
        a = cv2.imread(os.path.join(stage, name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(script_out, "views", "train", name),
                       cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1


def test_chip_smoke_eds_conversion_phase_on_cpu(tmp_path):
    """chip_smoke's phase 11 with the CPU in the card's place: the raw
    sequence written, converted by `python -m
    deblur_e_nerf_tpu_torch.data.eds_to_esim` in a process of its own and
    in this one, the two equal (poses within EDS_POSE_ATOL), the events
    the fixture's within the pose window, and the output read by the
    port's loaders."""
    pose_diff = chip_smoke.phase_eds_conversion(str(tmp_path), device="cpu")
    assert pose_diff <= chip_smoke.EDS_POSE_ATOL
