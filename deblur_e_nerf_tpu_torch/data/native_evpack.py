"""The native event packer (native/evpack.cpp), built with the host C++
compiler and loaded with ctypes (counterpart of
deblur_e_nerf_tpu/data/native_evpack.py).

The library is compiled at the first call, never at import, into the
package's `_build/` directory (listed in .gitignore), named by a hash of
the source and the flags, so a second process reuses it. A failed build
raises with the compiler's output: nothing falls back quietly to the numpy
path of `data/events.py`, which runs only when a caller asks for it. Both
give the same intervals and the same maximum refractory period.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops._cuda_build import BUILD_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "evpack.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib = None


def build(source=SOURCE, cxx=None):
    """Compile (or reuse) the packer library from `source`; return its
    path. Raises RuntimeError with the compiler's output if it fails."""
    cxx = cxx or os.environ.get("CXX") or "g++"
    with open(source, "rb") as f:
        code = f.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + code).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"evpack_{h}.so")
    if os.path.isfile(lib_path):
        return lib_path
    if shutil.which(cxx) is None:
        raise RuntimeError(f"the event packer's compiler {cxx!r} was not "
                           "found")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"building the event packer failed ({proc.returncode}): "
            f"{cxx} {' '.join(CXX_FLAGS)} {source}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library():
    """The loaded packer library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.evpack_pack.restype = ctypes.c_int64
            lib.evpack_pack.argtypes = [
                _U16P, _U16P, _I64P, _U8P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _I64P, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.evpack_max_refractory.restype = ctypes.c_int64
            lib.evpack_max_refractory.argtypes = [
                _U16P, _U16P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def _xyt(positions, timestamps, img_height, img_width):
    """The stream as the C functions read it, checked first: they index a
    (height x width) table by pixel without bounds checks."""
    positions = np.asarray(positions)
    if positions.ndim != 2 or positions.shape[1] != 2 \
            or len(positions) != len(timestamps):
        raise ValueError("positions must be (N, 2) beside N timestamps")
    if len(positions) and (positions.min() < 0
                           or positions[:, 0].max() >= img_width
                           or positions[:, 1].max() >= img_height):
        raise ValueError(f"event positions outside the {img_width}x"
                         f"{img_height} sensor")
    return (np.ascontiguousarray(positions[:, 0], np.uint16),
            np.ascontiguousarray(positions[:, 1], np.uint16),
            np.ascontiguousarray(timestamps, np.int64))


def pack_events(positions, timestamps, polarities, img_height, img_width):
    """One pass over the stream; the contract of `events.pack_events`."""
    lib = library()
    n = len(timestamps)
    x, y, t = _xyt(positions, timestamps, img_height, img_width)
    if len(polarities) != n:
        raise ValueError("polarities differ in length from the timestamps")
    p = np.ascontiguousarray(polarities, np.uint8)
    out = {"position": np.empty((n, 2), np.int64),
           **{k: np.empty(n, np.int64)
              for k in ("start_ts", "end_ts", "num_pos", "num_neg")}}
    v = lib.evpack_pack(
        x, y, t, p, n, int(img_width), int(img_height),
        out["position"].reshape(-1), out["start_ts"], out["end_ts"],
        out["num_pos"], out["num_neg"])
    return {k: a[:v].copy() for k, a in out.items()}


def max_refractory_period(positions, timestamps, img_height, img_width):
    """The contract of `events.extract_max_refractory_period`: inf when no
    pixel has two distinct timestamps."""
    x, y, t = _xyt(positions, timestamps, img_height, img_width)
    out = library().evpack_max_refractory(x, y, t, len(t), int(img_width),
                                          int(img_height))
    return np.array(float("inf")) if out < 0 else np.asarray(out)
