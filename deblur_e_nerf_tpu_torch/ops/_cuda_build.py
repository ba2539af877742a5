"""Build and load the port's CUDA kernels: plain nvcc into one shared
library with a C interface, loaded with ctypes.

Each of `csrc/*.cu` compiles in its own nvcc process for sm_90a
(Hopper), all started together, and one more nvcc call links the objects.
Nothing includes PyTorch's headers, so the build takes seconds. The
library lands in `_build/` under the package (listed in .gitignore),
named by a hash of the sources and flags, so a second run reuses it. The
build happens at the first kernel call, never at import.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    nvcc = _nvcc()
    units = [(src, f"{tmp}.{i}.o")
             for i, src in enumerate(s for s in sources if s.endswith(".cu"))]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                         for src, obj in units)]
    log = []
    try:
        for cmd, proc in procs:
            log.append(proc.communicate(timeout=120)[0])
            if proc.returncode != 0:
                print(log[-1], flush=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj in units]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", flush=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for _, obj in units:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=seconds, reused=False,
                      log="\n".join(log).strip())
    return lib_path


def _cuobjdump():
    path = shutil.which("cuobjdump")
    if path is None and os.path.isfile("/usr/local/cuda/bin/cuobjdump"):
        path = "/usr/local/cuda/bin/cuobjdump"
    if path is None:
        raise RuntimeError("cuobjdump not found: the SASS cannot be read")
    return path


def sass_instructions(lib_path=None, prefixes=("RED", "ATOM"),
                      operands=False):
    """{kernel function (mangled): [its SASS instructions whose opcode
    starts with one of `prefixes`, with their operands if `operands`]} of
    the built library, from `cuobjdump -sass`: the evidence of which
    atomics, loads and stores the compiler emitted."""
    lib_path = lib_path or build()
    proc = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, timeout=120,
                          check=True)
    found, current = {}, None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            current = line[len("Function : "):]
            found[current] = []
        elif current is not None and line.startswith("/*"):
            tokens = line.split("*/", 1)[-1].split(";")[0].split()
            if tokens and tokens[0].startswith("@"):  # a predicate
                tokens = tokens[1:]
            if tokens and tokens[0].startswith(tuple(prefixes)):
                found[current].append(" ".join(tokens) if operands
                                      else tokens[0])
    return found


def ptxas_summary(log):
    """{kernel function (mangled): "Used N registers, ...; S bytes spill
    stores, L bytes spill loads"} from the `-Xptxas -v` build log."""
    found, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            current = line.split("'")[1]
            found[current] = []
        elif current is not None and ("spill" in line
                                      or "Used " in line):
            found[current].append(line.split(":", 1)[-1].strip())
    return {fn: "; ".join(parts) for fn, parts in found.items()}


def carve(device, *specs):
    """One allocation holding tensors of (numel, dtype) each, every one
    16-byte aligned: typed views of one byte buffer (a wrapper's outputs
    and scratch in one allocator call)."""
    offsets, total = [], 0
    for n, dtype in specs:
        offsets.append(total)
        total += -(-n * dtype.itemsize // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf[o:o + n * dtype.itemsize].view(dtype)
            for o, (n, dtype) in zip(offsets, specs)]


def launch(fn, device, *args):
    """Call the library's entry point fn with args and the current stream
    of `device`; raise on the CUDA error it returns."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


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
        fn = lib.hash_encode_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.hash_encode_bwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pb_weight_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pb_weight_bwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.pb_weight_attributes
        fn.argtypes = [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.compact_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int32] * 3
                       + [ctypes.c_uint64] * 3
                       + [ctypes.c_int64, ctypes.c_int32]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        shared = ([ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int32]
                  + [ctypes.c_void_p] * 5
                  + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                     ctypes.c_double])
        fn = lib.composite_fwd
        fn.argtypes = shared + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        fn = lib.composite_bwd
        fn.argtypes = shared + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        fn = lib.march_masks
        fn.argtypes = [vp, vp, i64, i32, i32, vp]
        fn.restype = ctypes.c_int
        fn = lib.march_coarse
        fn.argtypes = [vp, i32] + [vp] * 6 + [i64] + [vp] * 5
        fn.restype = ctypes.c_int
        fn = lib.march_samples
        fn.argtypes = [vp] * 7 + [i64] + [vp] * 4
        fn.restype = ctypes.c_int
        fn = lib.march_decode
        fn.argtypes = [vp, vp, i64] + [vp] * 8
        fn.restype = ctypes.c_int
        f32 = ctypes.c_float
        fn = lib.occ_points
        fn.argtypes = [vp, vp, i64, vp, i64, i64, i64, vp, vp, vp, i64, vp,
                       vp, vp]
        fn.restype = ctypes.c_int
        fn = lib.occ_ema
        fn.argtypes = [i32, vp, vp, vp, i64, f32, vp, i64, vp, f32, vp, i64,
                       vp, i64, i64, i64, vp, vp, vp]
        fn.restype = ctypes.c_int
        fn = lib.occ_ema_begin
        fn.argtypes = [vp, i64, vp]
        fn.restype = ctypes.c_int
        fn = lib.occ_threshold
        fn.argtypes = [vp] * 9
        fn.restype = ctypes.c_int
        fn = lib.occ_sample_occupied
        fn.argtypes = [vp, i64, vp, vp, i64, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        fn = lib.l2_reduction_rate
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
