// Table loads shared by the kernels that read feature-table rows
// (gather_rows.cu, hash_encode.cu): the non-coherent path with an L2
// evict_last policy, so a table that fits the 50 MB L2 stays there against
// the kernels' streaming traffic (positions, indices, features, cotangents).
// The float forms read float32 rows, the u32 forms bf16 rows (two bf16 a
// 32-bit word, the lower address in the low half).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace table_load {

__device__ __forceinline__ uint64_t policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float ld1(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float2 ld2(const float* p, uint64_t policy) {
  float2 v;
  asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
      : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p, uint64_t policy) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint32_t ld_u32(const void* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint2 ld_u32x2(const void* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.b32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 ld_u32x4(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

}  // namespace table_load
