// Trilinear corner sum for Hopper (sm_90a): a hash-grid level's features
//   out[n, f] = sum_k w[n, k] * rows[n, k, f]
// over the 8 cell corners k, in float32, from the bfloat16 (or float32)
// rows that the row gather (gather_rows.cu) returns.
//
// No Pallas kernel: on the TPU, XLA fuses this into the encode
// (deblur_e_nerf_tpu/models/hash_encoding.py `_batched_vertex_group`,
// `jnp.sum(rows.astype(acc_dtype) * w[..., None], axis=-2)`). In eager
// PyTorch the same expression is two passes, and the multiply of bf16
// rows by float32 weights takes the slow dynamic-cast elementwise path:
// it reads bf16 and writes the (8N, F) float32 products, which the sum
// reads again.
//
// Bound: bytes. The function reads the rows (8NF elements), the weights
// (8N floats) and writes N*F floats; 8NF multiply-adds are far below the
// card's rate. The design: one sample per thread, one pass. A sample's 8
// corner rows and 8 weights are contiguous (sample-major, the order in
// which the encode's forward gathers), so each is read once as 16-byte
// vectors, and the F sums are stored as one vector; a grid of the
// resident blocks (launch.cuh) walks the samples.
//
// The sum runs k = 0..7 in order, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no fused multiply-add), so
// `corner_sum_sequential` in ops/corner_sum.py reproduces it bit for bit.
//
// The kernel allocates nothing and does not synchronise. Returns
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using launch_grid::kThreads;
using launch_grid::launch;

template <typename T, int K>
struct alignas(sizeof(T) * K >= 16 ? 16 : sizeof(T) * K) Pack {
  T v[K];
};

template <typename T, int K>
__device__ __forceinline__ Pack<T, K> load(const T* p) {
  return *reinterpret_cast<const Pack<T, K>*>(p);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    corner_sum_kernel(const T* __restrict__ rows,
                      const float* __restrict__ w, float* __restrict__ out,
                      int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Pack<float, 8> wk = load<float, 8>(w + i * 8);
    const Pack<T, 8 * F> p = load<T, 8 * F>(rows + i * 8 * F);
    Pack<float, F> acc;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc.v[f] = __fmul_rn(wk.v[0], to_float(p.v[f]));
    }
#pragma unroll
    for (int k = 1; k < 8; ++k) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc.v[f] = __fadd_rn(acc.v[f],
                             __fmul_rn(wk.v[k], to_float(p.v[k * F + f])));
      }
    }
    *reinterpret_cast<Pack<float, F>*>(out + i * F) = acc;
  }
}

template <typename T>
int dispatch(const void* rows, const float* w, float* out, int64_t n,
             int32_t f, cudaStream_t s) {
  const T* r = (const T*)rows;
  switch (f) {
    case 1: launch<&corner_sum_kernel<T, 1>>(n, s, r, w, out, n); break;
    case 2: launch<&corner_sum_kernel<T, 2>>(n, s, r, w, out, n); break;
    case 4: launch<&corner_sum_kernel<T, 4>>(n, s, r, w, out, n); break;
    case 8: launch<&corner_sum_kernel<T, 8>>(n, s, r, w, out, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// rows: (n, 8, f), bfloat16 with rows_bf16 else float32; w: (n, 8)
// float32; out: (n, f) float32. All contiguous and 16-byte aligned; f in
// {1, 2, 4, 8}.
extern "C" int corner_sum_f32(const void* rows, const void* w, void* out,
                              int64_t n, int32_t f, int32_t rows_bf16,
                              void* stream) {
  if (n > 0) {
    const float* wp = (const float*)w;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const int err = rows_bf16 ? dispatch<__nv_bfloat16>(rows, wp, o, n, f, s)
                              : dispatch<float>(rows, wp, o, n, f, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
