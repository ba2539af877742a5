// Row scatter-add for Hopper (sm_90a): out[idx[i], :] += val[i, :] into a
// fresh zero table.
//
// Replaces the Pallas TPU kernel deblur_e_nerf_tpu/ops/pallas_scatter.py:46
// (`_scatter_add_rows_pallas`, body `_kernel`), which walks the
// contribution rows serially into a destination table held in VMEM. On
// Hopper the rows are independent work items that add into the table in
// device memory with atomics; nothing of the serial walk carries over. It
// was the per-level hash-grid table backward until that was fused
// (hash_encode.cu); no path launches it now.
//
// Bound: device-memory bytes. The function must read val (N*W*4 bytes) and
// idx (N*4 bytes) once and write the output (n_rows*W*4 bytes) once; its
// arithmetic is one add per element. Every table of the per-level encode was
// at most 4 MB (65,536 x 16 or 524,288 x 2 floats), so the atomics resolve
// in the 50 MB L2 and the streamed reads of val and idx set the floor.
// Four mechanisms keep the kernel near that floor:
//
//  1. 16-byte work per thread, 32-bit index math. A thread owns one VEC-
//     float chunk of a row (a float4 when W % 4 == 0, a float2 for W = 2)
//     over kRows = 8 consecutive rows, and loads each row's index once. W is a
//     template parameter on the per-level encode's widths (16 and 2), so the
//     chunk arithmetic is shifts; other widths take a generic path with
//     the width at run time. Offsets are 32-bit when N*W and n_rows*W fit
//     (every per-level encode call: at most 252M elements), and the grid
//     is sized to the work, one thread per (row group, chunk).
//  2. Hopper's vector atomics. atomicAdd(float4*, float4) and
//     atomicAdd(float2*, float2) exist for compute capability 9.x on
//     global memory; with the result unused they compile to one vector
//     reduction (RED), so a W = 16 row takes 4 atomics instead of 16 and a
//     W = 2 row 1 instead of 2. The wrapper checks the 16- or 8-byte
//     alignment they need.
//  3. Zero contributions issue no atomic. A chunk whose sum compares equal
//     to 0 in every lane is skipped: `out` starts at +0.0 and x + (+-0) = x
//     for every x a round-to-nearest sum from +0 can reach, so the result
//     is bit-identical. NaN and inf compare unequal to 0 and always reach
//     the table. The training step's empty sample slots (exact zero
//     cotangents, all at one index) therefore cost reads only.
//  4. Runs of equal indices are combined in registers. Walking its 8
//     rows in order, a thread sums consecutive rows with the same index
//     and issues one atomic per run (samples of one ray are adjacent in
//     the buffer and share cells at the coarse levels). Uniformly random
//     indices cost one compare per row more than before.
//
// What still bounds it (chip_smoke.py phase 3, PERF.md): with no atomic to
// issue (all rows zero) it reads at about the byte bound; on uniformly
// random rows, where every row is its own run, the L2's rate of vector
// reductions on distinct 32-byte sectors sets its time instead, at about
// twice the bound for W = 16. Fewer reductions, not fewer bytes, is what
// would help there: a caller that orders its rows so that equal indices
// are adjacent (the per-level hash encoding laid its vertex-hash rows out
// corner-major for this) lets mechanism 4 remove them.
//
// The kernel's summation order: per thread, each run's rows summed in
// row order, then the runs' sums added atomically in any order.
// ops/scatter_rows.py `scatter_add_rows_combined` models it in PyTorch.
//
// The entry point zeroes `out` (cudaMemsetAsync) and launches the kernel
// on the stream it is given, PyTorch's current one; it allocates nothing
// and does not synchronise. Zeroing here rather than with torch.zeros in
// the wrapper saves the wrapper a PyTorch operator call per launch, about
// half its host time at small N. Indices outside [0, n_rows) are skipped.
// Returns the CUDA error of the memset or the launch, or
// cudaErrorInvalidValue for pointers misaligned for the chosen vector.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // consecutive rows per thread (run combining)

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float vload(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float2 vload(const float2* p) { return __ldcs(p); }
__device__ __forceinline__ float4 vload(const float4* p) { return __ldcs(p); }

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ bool all_zero(float a) { return a == 0.0f; }
__device__ __forceinline__ bool all_zero(float2 a) {
  return (a.x == 0.0f) & (a.y == 0.0f);
}
__device__ __forceinline__ bool all_zero(float4 a) {
  return (a.x == 0.0f) & (a.y == 0.0f) & (a.z == 0.0f) & (a.w == 0.0f);
}

// vector reductions: sm_90's atomicAdd overloads for float2 / float4
__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red_add(float2* p, float2 v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void red_add(float4* p, float4 v) {
  atomicAdd(p, v);
}

template <typename V, typename I>
__device__ __forceinline__ void flush(int32_t k, V acc, V* dst, I n_rows,
                                      int cpr) {
  if (k >= 0 && (I)k < n_rows && !all_zero(acc)) {
    red_add(dst + (I)k * cpr, acc);
  }
}

template <typename V, typename I>
__device__ __forceinline__ void take(int32_t k, V x, int32_t& cur, V& acc,
                                     V* dst, I n_rows, int cpr) {
  if (k == cur) {
    acc = vadd(acc, x);
  } else {
    flush(cur, acc, dst, n_rows, cpr);
    cur = k;
    acc = x;
  }
}

// One thread: chunk c (VEC floats) of rows [r0, r0 + kRows). CPR is the
// number of chunks per row when known at compile time (W / VEC), else 0
// and `cpr_rt` holds it.
template <int VEC, int CPR, typename I>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                            const float* __restrict__ val,
                            float* __restrict__ out, I n, I n_rows,
                            int cpr_rt) {
  using V = typename Vec<VEC>::T;
  const int cpr = CPR > 0 ? CPR : cpr_rt;
  const I t = (I)blockIdx.x * (I)kThreads + (I)threadIdx.x;
  const I g = t / cpr;
  const int c = (int)(t - g * cpr);
  const I r0 = g * kRows;
  if (r0 >= n) return;
  const V* src = reinterpret_cast<const V*>(val) + r0 * cpr + c;
  V* dst = reinterpret_cast<V*>(out) + c;
  int32_t cur;  // the index of the run being summed
  V acc;        // its sum so far
  if (r0 + kRows <= n) {
    // all loads first, so they are in flight together
    int32_t k[kRows];
    V x[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      k[j] = __ldg(idx + r0 + j);
      x[j] = vload(src + (I)j * cpr);
    }
    cur = k[0];
    acc = x[0];
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      take(k[j], x[j], cur, acc, dst, n_rows, cpr);
    }
  } else {
    cur = __ldg(idx + r0);
    acc = vload(src);
    for (I r = r0 + 1; r < n; ++r) {
      take(__ldg(idx + r), vload(src + (r - r0) * cpr), cur, acc, dst,
           n_rows, cpr);
    }
  }
  flush(cur, acc, dst, n_rows, cpr);
}

template <int VEC, int CPR, typename I>
void launch(const void* idx, const void* val, void* out, int64_t n,
            int64_t n_rows, int cpr, cudaStream_t stream) {
  const int64_t threads = (n + kRows - 1) / kRows * cpr;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  scatter_add_rows_kernel<VEC, CPR, I><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
      (const int32_t*)idx, (const float*)val, (float*)out, (I)n, (I)n_rows,
      cpr);
}

template <typename I>
void dispatch(const void* idx, const void* val, void* out, int64_t n,
              int32_t width, int64_t n_rows, cudaStream_t stream) {
  if (width == 16) {
    launch<4, 4, I>(idx, val, out, n, n_rows, 4, stream);
  } else if (width == 2) {
    launch<2, 1, I>(idx, val, out, n, n_rows, 1, stream);
  } else if (width % 4 == 0) {
    launch<4, 0, I>(idx, val, out, n, n_rows, width / 4, stream);
  } else if (width % 2 == 0) {
    launch<2, 0, I>(idx, val, out, n, n_rows, width / 2, stream);
  } else {
    launch<1, 0, I>(idx, val, out, n, n_rows, width, stream);
  }
}

}  // namespace

extern "C" int scatter_add_rows_f32(const void* idx, const void* val,
                                    void* out, int64_t n, int32_t width,
                                    int64_t n_rows, void* stream) {
  if (width <= 0) return (int)cudaErrorInvalidValue;
  // the vector dispatch() picks: float4, float2 or float
  const uintptr_t align = width % 4 == 0 ? 16 : (width % 2 == 0 ? 8 : 4);
  if (((uintptr_t)val % align) != 0 || ((uintptr_t)out % align) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(n_rows * width) * 4,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess || n <= 0) return (int)err;
  const int64_t limit = (int64_t)1 << 31;
  // 32-bit offsets while every element and thread index fits
  const bool small = n * width + (int64_t)kRows * width < limit &&
                     n_rows * width < limit;
  if (small) {
    dispatch<int32_t>(idx, val, out, n, width, n_rows, (cudaStream_t)stream);
  } else {
    dispatch<int64_t>(idx, val, out, n, width, n_rows, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
