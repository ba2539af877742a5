// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :], with an
// optional round-to-nearest-even trip through bfloat16.
//
// Replaces the Pallas TPU kernel of scripts/perf_microbench.py
// (`case_pallas_gather_probe`), which gathers VMEM-resident rows with
// scalar-prefetched indices; on the main path it is the gather at the
// heart of every hash-encode level (deblur_e_nerf_tpu/models/
// hash_encoding.py `_encode_impl`): vertex-hash levels gather 8 (F)-float
// vertex rows per sample, cellhash and dense levels one (8F)-float row.
//
// Bound: device-memory bytes. The function reads N*4 bytes of indices and
// N*W*4 bytes of rows and writes N*W*4 bytes; it does no arithmetic worth
// counting. Each level's table segment (at most 4 MB of float32) sits in
// the 50 MB L2, so the row reads mostly hit L2 and the index read and the
// output write stream through device memory. The design: one thread per
// VEC-float chunk of an output row (VEC = 4, a 16-byte float4, when W is a
// multiple of 4 and the pointers are 16-byte aligned; else 2 or 1), so
// consecutive threads write consecutive 4*VEC bytes and the stores
// coalesce; the threads of one row read the same index (one L1 line).
//
// With round_bf16 the kernel rounds each gathered value to bfloat16 with
// __float2bfloat16_rn and widens it back to float32, which equals
// `table.to(torch.bfloat16)[idx].float()` bit for bit on finite values:
// the encode no longer converts the whole table every forward.
//
// The kernel allocates nothing and does not synchronise. An index outside
// [0, n_rows) reads nothing and writes a zero row (the encode builds its
// indices in range). Returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float round_vec(float v) { return round_bf16(v); }
__device__ __forceinline__ float2 round_vec(float2 v) {
  return make_float2(round_bf16(v.x), round_bf16(v.y));
}
__device__ __forceinline__ float4 round_vec(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T zero_vec();
template <>
__device__ __forceinline__ float zero_vec<1>() { return 0.0f; }
template <>
__device__ __forceinline__ float2 zero_vec<2>() {
  return make_float2(0.0f, 0.0f);
}
template <>
__device__ __forceinline__ float4 zero_vec<4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int VEC, bool ROUND>
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int64_t n,
                                   int32_t width, int64_t n_rows) {
  using T = typename Vec<VEC>::T;
  const int32_t chunks = width / VEC;  // VEC-float chunks per row
  const int64_t total = n * (int64_t)chunks;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const T* tbl = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t i = e / chunks;
    const int32_t c = (int32_t)(e - i * chunks);
    const int64_t r = __ldg(idx + i);
    T v = zero_vec<VEC>();
    if (r >= 0 && r < n_rows) {
      v = __ldg(tbl + r * chunks + c);
      if (ROUND) v = round_vec(v);
    }
    dst[e] = v;
  }
}

template <int VEC>
void launch(const float* table, const int32_t* idx, float* out, int64_t n,
            int32_t width, int64_t n_rows, int round_bf16,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (int64_t)(width / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  // a grid-stride loop covers the rest: 132 SMs x 16 resident blocks
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (round_bf16) {
    gather_rows_kernel<VEC, true><<<(unsigned)blocks, threads, 0, stream>>>(
        table, idx, out, n, width, n_rows);
  } else {
    gather_rows_kernel<VEC, false><<<(unsigned)blocks, threads, 0, stream>>>(
        table, idx, out, n, width, n_rows);
  }
}

}  // namespace

extern "C" int gather_rows_f32(const void* table, const void* idx, void* out,
                               int64_t n, int32_t width, int64_t n_rows,
                               int32_t round_bf16, void* stream) {
  if (n > 0 && width > 0) {
    const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
    const float* t = (const float*)table;
    const int32_t* i = (const int32_t*)idx;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (width % 4 == 0 && align % 16 == 0) {
      launch<4>(t, i, o, n, width, n_rows, round_bf16, s);
    } else if (width % 2 == 0 && align % 8 == 0) {
      launch<2>(t, i, o, n, width, n_rows, round_bf16, s);
    } else {
      launch<1>(t, i, o, n, width, n_rows, round_bf16, s);
    }
  }
  return (int)cudaGetLastError();
}
