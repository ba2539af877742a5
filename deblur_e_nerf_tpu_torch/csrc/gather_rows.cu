// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :], float32
// rows out, or rounded to nearest even and written as bfloat16 rows.
//
// Replaces the Pallas TPU kernel of scripts/perf_microbench.py
// (`case_pallas_gather_probe`), which gathers VMEM-resident rows with
// scalar-prefetched indices. It was the gather of every hash-encode level
// (vertex-hash levels 8 (F = 2)-float vertex rows per sample; cellhash
// and packed dense levels one (8F = 16)-float row per sample) until the
// encode was fused (hash_encode.cu); no path launches it now.
//
// Bound: bytes. The function reads N*4 bytes of indices and each touched
// table row once, and writes N*W*2 (bf16) or N*W*4 (float32) bytes; it
// does no arithmetic worth counting. The table segment (4 MB for a
// vertex-hash or cellhash level, 22 MB for packed dense level 4) fits the
// 50 MB L2, so device memory sees the index and output streams. What the
// card loses time on instead:
//   - the L2's request rate: a random 8-byte row costs a whole 32-byte
//     sector, so 126M uniformly random vertex rows move ~4 GB between L2
//     and the SMs to deliver 1 GB;
//   - latency: one dependent row load per index load leaves few loads in
//     flight per thread.
// The design, against those:
//   - one instance per main-path width and output type (template
//     arguments, so no division or modulo by the width in the loop);
//   - W = 2: a warp owns 256 consecutive rows, a lane 8 of them. The warp
//     reads their indices as 16-byte int4 (scalar loads when the index
//     pointer is not 16-byte aligned) into shared memory; lane l then
//     issues its 8 row loads, rows l + 32k, before any store, so each
//     warp-wide row load covers 32 consecutive rows: the 8 corners of 4
//     consecutive samples, where a ray's samples in one cell ask for the
//     same rows and the load unit merges them. The rows go back through
//     shared memory so that every
//     store is 16 bytes a lane and 512 consecutive bytes a warp (4 bf16
//     rows or 2 float32 rows a lane): a partly written sector never
//     reaches device memory;
//   - W = 16 (and any W whose output row is a multiple of 16 bytes): a
//     lane owns one 16-byte output chunk of R rows (chunk = lane % C, row
//     = lane / C, C = row bytes / 16); it reads each row's index, then
//     issues all its row-chunk loads (float4) before its 16-byte stores.
//     A warp-wide store covers 512 consecutive bytes;
//   - L2 policy: the index and output streams load and store with the
//     streaming hint (__ldcs / __stcs, evict-first); the table is read
//     through the non-coherent path with an L2 evict_last policy
//     (createpolicy + ld.global.nc.L2::cache_hint), so the 4-22 MB table
//     segment stays in L2 against 0.5-1.5 GB of streaming traffic;
//   - a grid of the resident blocks the card holds (SM count x the
//     occupancy the runtime reports for the instance; launch.cuh),
//     walking the work with a grid-stride loop;
//   - other widths and unaligned tables take a scalar path (one row per
//     thread per step).
// What Hopper does not offer here: TMA has no row-gather mode on sm_90
// (its im2col and tiled modes copy boxes of a tensor, not rows by an
// index list), and the tensor cores have no role in a copy. The levers
// are the memory system's: vector width, L2 residency, sector sharing and
// loads in flight. The SASS forms of each instance's loads and stores
// (cuobjdump -sass) are printed by chip_smoke.py's phase 2: the index
// loads are LDG.E.EF (evict-first) and the stores STG.E.EF.128; the table
// loads are LDG.E.64/.128.CONSTANT (the non-coherent path) addressed
// through a memory descriptor (desc[URn]), which carries the createpolicy
// value on sm_90; the evict_last hint has no opcode suffix of its own. In
// a sweep on the card, the same kernel with an evict_normal policy ran
// the uniform cases markedly slower.
//
// Rounding: __float22bfloat162_rn / __float2bfloat16_rn round to nearest
// even, which equals `table.to(torch.bfloat16)` bit for bit on finite
// values and infinities (a NaN stays a NaN, its payload may differ).
//
// The kernel allocates nothing and does not synchronise. An index outside
// [0, n_rows) reads nothing and writes a zero row (the encode builds its
// indices in range). Returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "table_load.cuh"

namespace {

using launch_grid::kThreads;
using launch_grid::launch;
using table_load::ld1;
using table_load::ld2;
using table_load::ld4;
constexpr int kNarrowRows = 8;  // rows per thread in the W = 2 instances

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(a, b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ int64_t global_thread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * blockDim.x;
}

// W = 2: a warp owns a tile of 32 * G consecutive rows. It reads the
// tile's indices as 16-byte int4 (lane l the 4 at 4l + 128q) into shared
// memory, and lane l then gathers rows l + 32k (k < G): each warp-wide row
// load covers 32 consecutive rows. The rows go back through shared memory
// so that each lane stores 16 contiguous bytes (4 bf16 rows or 2 float32
// rows) and each warp-wide store covers 512 consecutive bytes.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel_w2(const float* __restrict__ table,
                          const int32_t* __restrict__ idx,
                          void* __restrict__ out, int64_t n,
                          uint32_t n_rows, bool idx_vec) {
  constexpr int G = kNarrowRows;
  constexpr int TILE = 32 * G;
  constexpr int WORDS = BF16 ? 1 : 2;  // 32-bit words per output row
  __shared__ __align__(16) uint32_t stage[kThreads / 32][2 * TILE];
  uint32_t* buf = stage[threadIdx.x / 32];
  const uint64_t policy = table_load::policy();
  const int lane = threadIdx.x & 31;
  const int64_t warps = grid_threads() / 32;
  const int64_t full = n / TILE * TILE;
  for (int64_t base = (global_thread() / 32) * TILE; base < full;
       base += warps * TILE) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const int32_t* ip = idx + base + 128 * q + 4 * lane;
      const int4 v = idx_vec ? __ldcs(reinterpret_cast<const int4*>(ip))
                             : make_int4(__ldcs(ip), __ldcs(ip + 1),
                                         __ldcs(ip + 2), __ldcs(ip + 3));
      reinterpret_cast<int4*>(buf)[32 * q + lane] = v;
    }
    __syncwarp();
    int32_t r[G];
#pragma unroll
    for (int k = 0; k < G; ++k) r[k] = (int32_t)buf[lane + 32 * k];
    __syncwarp();
    float2 v[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      v[k] = (uint32_t)r[k] < n_rows
                 ? ld2(table + 2 * (int64_t)r[k], policy)
                 : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if constexpr (BF16) {
        buf[lane + 32 * k] = bf16x2_bits(v[k].x, v[k].y);
      } else {
        reinterpret_cast<float2*>(buf)[lane + 32 * k] = v[k];
      }
    }
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out) + base * WORDS / 4;
#pragma unroll
    for (int m = 0; m < G * WORDS / 4; ++m) {
      __stcs(dst + lane + 32 * m,
             reinterpret_cast<const uint4*>(buf)[lane + 32 * m]);
    }
    __syncwarp();
  }
  // the last n % (32 G) rows, one per thread
  const int64_t i = full + global_thread();
  if (i < n) {
    const int32_t r = __ldcs(idx + i);
    const float2 v = (uint32_t)r < n_rows
                         ? ld2(table + 2 * (int64_t)r, policy)
                         : make_float2(0.0f, 0.0f);
    if constexpr (BF16) {
      __stcs(reinterpret_cast<unsigned int*>(out) + i, bf16x2_bits(v.x, v.y));
    } else {
      __stcs(reinterpret_cast<float2*>(out) + i, v);
    }
  }
}

// W floats per row, W * sizeof(out) a multiple of 16 bytes: a lane owns
// one 16-byte output chunk of R rows.
template <int W, bool BF16, int R>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel_wide(const float* __restrict__ table,
                            const int32_t* __restrict__ idx,
                            void* __restrict__ out, int64_t n,
                            uint32_t n_rows) {
  constexpr int OUT_BYTES = W * (BF16 ? 2 : 4);
  constexpr int C = OUT_BYTES / 16;        // 16-byte chunks per row
  constexpr int IN = 16 / (BF16 ? 2 : 4);  // floats read per chunk
  constexpr int STEP = 32 / C;             // rows per warp-wide step
  constexpr int TILE = R * STEP;           // rows per warp per iteration
  static_assert(OUT_BYTES % 16 == 0 && 32 % C == 0, "unsupported width");
  const uint64_t policy = table_load::policy();
  const int lane = threadIdx.x & 31;
  const int c = lane % C;
  const int j = lane / C;
  const int64_t warps = grid_threads() / 32;
  for (int64_t base = (global_thread() / 32) * TILE; base < n;
       base += warps * TILE) {
    int32_t r[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int64_t i = base + s * STEP + j;
      r[s] = i < n ? __ldcs(idx + i) : -1;
    }
    float4 v[R][IN / 4];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const bool ok = (uint32_t)r[s] < n_rows;
      const float* src = table + (int64_t)r[s] * W + c * IN;
#pragma unroll
      for (int q = 0; q < IN / 4; ++q) {
        v[s][q] = ok ? ld4(src + 4 * q, policy)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int64_t i = base + s * STEP + j;
      if (i >= n) continue;
      char* dst = reinterpret_cast<char*>(out) + i * OUT_BYTES + c * 16;
      if constexpr (BF16) {
        __stcs(reinterpret_cast<uint4*>(dst),
               make_uint4(bf16x2_bits(v[s][0].x, v[s][0].y),
                          bf16x2_bits(v[s][0].z, v[s][0].w),
                          bf16x2_bits(v[s][1].x, v[s][1].y),
                          bf16x2_bits(v[s][1].z, v[s][1].w)));
      } else {
        __stcs(reinterpret_cast<float4*>(dst), v[s][0]);
      }
    }
  }
}

// Any width and alignment: one row per thread per step.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel_generic(const float* __restrict__ table,
                               const int32_t* __restrict__ idx,
                               void* __restrict__ out, int64_t n,
                               int32_t width, uint32_t n_rows) {
  const uint64_t policy = table_load::policy();
  for (int64_t i = global_thread(); i < n; i += grid_threads()) {
    const int32_t r = __ldcs(idx + i);
    const bool ok = (uint32_t)r < n_rows;
    const float* src = table + (int64_t)r * width;
    for (int32_t k = 0; k < width; ++k) {
      const float v = ok ? ld1(src + k, policy) : 0.0f;
      if constexpr (BF16) {
        reinterpret_cast<__nv_bfloat16*>(out)[i * width + k] =
            __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(out)[i * width + k] = v;
      }
    }
  }
}

template <bool BF16>
void dispatch(const float* t, const int32_t* i, void* o, int64_t n,
              int32_t width, uint32_t rows, cudaStream_t s) {
  const uintptr_t t_align = (uintptr_t)t;
  const bool out_aligned = (uintptr_t)o % 16 == 0;
  if (width == 2 && t_align % 8 == 0 && out_aligned) {
    const bool idx_vec = (uintptr_t)i % 16 == 0;
    launch<&gather_rows_kernel_w2<BF16>>(n / kNarrowRows + 32, s, t, i, o, n,
                                         rows, idx_vec);
  } else if (width == 16 && t_align % 16 == 0 && out_aligned) {
    // rows per lane: 2 bf16 rows are 4 float4 loads in flight, 16 float32
    // rows 16 (the fastest of 2-16 in a sweep on the card)
    constexpr int R = BF16 ? 2 : 16;
    constexpr int C = 16 * (BF16 ? 2 : 4) / 16;
    launch<&gather_rows_kernel_wide<16, BF16, R>>((n + R - 1) / R * C, s, t,
                                                   i, o, n, rows);
  } else {
    launch<&gather_rows_kernel_generic<BF16>>(n, s, t, i, o, n, width, rows);
  }
}

}  // namespace

// out: (n, width) float32, or bfloat16 with out_bf16 (each value rounded
// to nearest even). n_rows above 2^31 - 1 counts as 2^31 - 1: an int32
// index cannot reach past it.
extern "C" int gather_rows_f32(const void* table, const void* idx, void* out,
                               int64_t n, int32_t width, int64_t n_rows,
                               int32_t out_bf16, void* stream) {
  if (n > 0 && width > 0) {
    const float* t = (const float*)table;
    const int32_t* i = (const int32_t*)idx;
    const uint32_t rows =
        (uint32_t)(n_rows < 0 ? 0 : (n_rows > 0x7fffffff ? 0x7fffffff
                                                          : n_rows));
    cudaStream_t s = (cudaStream_t)stream;
    if (out_bf16) {
      dispatch<true>(t, i, out, n, width, rows, s);
    } else {
      dispatch<false>(t, i, out, n, width, rows, s);
    }
  }
  return (int)cudaGetLastError();
}
