"""Build and load the port's CUDA kernels: plain nvcc into one shared
library with a C interface, loaded with ctypes.

All of `csrc/*.cu` compiles in one nvcc call for sm_90a (Hopper). Nothing
includes PyTorch's headers, so the build takes seconds. The library lands
in `_build/` under the package (listed in .gitignore), named by a hash of
the sources and flags, so a second run reuses it. The build happens at the
first kernel call, never at import.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info = {}  # path, seconds, reused, ptxas log of the last build


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build():
    """Compile (or reuse) the kernel library; return its path."""
    sources = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")
    if os.path.isfile(lib_path):
        build_info.update(path=lib_path, seconds=0.0, reused=True, log="")
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, sep="\n", flush=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=seconds, reused=False,
                      log=(proc.stdout + proc.stderr).strip())
    return lib_path


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.scatter_add_rows_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.gather_rows_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                       ctypes.c_int32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
