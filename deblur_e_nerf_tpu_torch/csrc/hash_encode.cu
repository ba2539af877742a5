// The multi-resolution grid encode for Hopper (sm_90a), one fused kernel
// per direction over all levels:
//   forward   out[n, l*F + f] = sum_k w_k(n, l) * table[row_k(n, l), f]
//   backward  grad[row_k(n, l), f] += w_k(n, l) * g[n, l*F + f]
// for the 8 cell corners k of sample n at level l, with F = 2 features a
// level.
//
// Neither replaces a Pallas kernel. They replace the JAX package's
// custom-VJP encode, deblur_e_nerf_tpu/models/hash_encoding.py
// `_encode_frozen_pos` (:372-555), which XLA compiles from plain array code:
//   - the forward replaces `_encode_impl` (:332-369) with `_corner_indices`
//     (:96-115), `_pack_dense_segment` (:125-143), `_cellhash_index_weights`
//     (:158-176), `_dense_cell_index_weights` (:179-194),
//     `_level_indices_weights` (:197-212), `_batched_vertex_group`
//     (:250-291) and `_batched_cellhash_group` (:294-329);
//   - the backward replaces `_encode_frozen_pos_bwd` (:420-552) with
//     `_rowwise_sorted_segment_grad` (:386-417) and
//     `_fold_dense_segment_grad` (:146-155). Their sorts and compensated
//     cumsums exist because the TPU has no fast atomics and no float64;
//     here the row sums are float32 atomics.
//
// What each level's corners are (the same device function,
// `level_corners`, serves both directions, so they cannot disagree):
//   uc = clip(u, 0, 1); scaled = uc * res (one rounding); cell = floor.
//   dense, cellhash: the cell clipped to [0, res - 1] (frac reaches 1.0 at
//     u = 1); hash, tiled: the cell unclipped, each corner clipped to
//     [0, res].
//   dense: the vertex row offset + (z (res+1) + y)(res+1) + x, read directly
//     (the JAX package's packed cell-corner view was a TPU device: a TPU
//     row gather costs the same for 2 or 16 floats);
//   hash: offset + (x ^ y * 2654435761 ^ z * 805459861 mod 2^32) mod size;
//   tiled: offset + ((z (res+1) + y)(res+1) + x mod 2^32) mod size;
//   cellhash: the cell's hash mod size / 8 picks one 8F-float row of the
//     level's segment, corner k at its k-th F floats.
//   Corner k = 4 dx + 2 dy + dz; its weight is (w_x * w_y) * w_z in
//   float32, w = frac for the upper corner, 1 - frac for the lower.
//
// Bound: bytes. Per sample the forward must read its 12 bytes of position
// and write L F floats (128 bytes at 16 levels); the backward reads the
// same position and L F floats of cotangent, and writes the (T, F)
// gradient once. The table (50 MB on the flagship) is read once in that
// count. The arithmetic (index math, 8 F multiply-adds a level) is far
// below the card's float32 rate. What the card loses time on instead is
// the table: 8 random row reads a sample and level (4 16-byte reads of
// one 64-byte row on cellhash levels), served by L2 and L1, and in the
// backward the L2's rate of atomic reductions.
//
// The design:
//   - work map: a block of 8 warps takes a tile of 32 consecutive samples
//     over all levels. Lane j holds sample j of the tile; warp w takes
//     levels w, w + 8, ..., so the mode branch is uniform across a warp.
//     A grid of the resident blocks (launch.cuh) walks the tiles;
//   - the level parameters (res, size, offset, mode) of up to 32 levels
//     are one struct kernel argument, __grid_constant__ so that indexing
//     it by level reads the constant bank instead of a per-thread copy;
//   - the tile's positions, and in the backward its cotangents, are read
//     coalesced into shared memory once per tile;
//   - table reads go through the non-coherent path with the L2 evict_last
//     policy (table_load.cuh), vertex rows as one 8-byte load, cellhash
//     rows as four 16-byte loads; all of a lane's loads of a level are
//     issued before the sum;
//   - forward: each gathered value is rounded to bf16 (round to nearest
//     even) when the encode computes in bf16, then k = 0..7 are summed in
//     order, every product and sum rounded on its own (__fmul_rn,
//     __fadd_rn: no fused multiply-add), so `encode_forward_model` in
//     ops/hash_encode.py reproduces the kernel bit for bit. Each lane
//     stages its level's F floats in shared memory (row stride = 2 mod 32
//     floats: conflict-free); the block then writes the tile's
//     32 x L F floats as 16-byte stores, 128 contiguous bytes a sample;
//   - backward: the entry point zeroes the gradient (cudaMemsetAsync). A
//     warp whose 32 cotangents of a level are all zero (the step's empty
//     sample slots) skips the level. Otherwise each lane recomputes its
//     rows and weights; lanes holding the same row (__match_any_sync) sum
//     their contributions in registers (a pairwise tree of shuffles) and
//     the lowest of them issues one vector reduction: atomicAdd(float2*)
//     for a vertex row, four atomicAdd(float4*) for a cellhash row. A
//     contribution that sums to zero issues no atomic (out starts at +0.0
//     and x + (+-0) = x); NaN and infinities always reach the table. The
//     atomics land in any order: the sums are float32, within
//     (k - 1) eps sum|x| of the exact ones for a row of k contributions.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given (PyTorch's current one). The entry points return
// cudaGetLastError() (or the memset's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "table_load.cuh"

namespace {

using launch_grid::kThreads;
using launch_grid::launch;

constexpr int kF = 2;                 // features a level
constexpr int kMaxLevels = 32;
constexpr int kTile = 32;             // samples a block tile, one a lane
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStride = kMaxLevels * kF + 2;  // staged floats a sample
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add

enum : int32_t { kDense = 0, kHash = 1, kTiled = 2, kCellHash = 3 };

// The level layout (models/hash_encoding.py `grid_layout`); mirrored by
// `_LevelParams` in ops/hash_encode.py.
struct Levels {
  int32_t n;
  int32_t mode[kMaxLevels];
  uint32_t res[kMaxLevels];
  uint32_t size[kMaxLevels];    // the level's table rows
  uint32_t offset[kMaxLevels];  // its first row
};

struct Corners {
  uint32_t row[8];  // table rows; a cellhash level's are row[0] + k
  float w[8];
};

__device__ __forceinline__ uint32_t spatial_hash(uint32_t x, uint32_t y,
                                                 uint32_t z) {
  return x ^ (y * 2654435761u) ^ (z * 805459861u);
}

__device__ __forceinline__ uint32_t mod(uint32_t v, uint32_t size) {
  return (size & (size - 1)) == 0 ? v & (size - 1) : v % size;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Sample (ux, uy, uz), already clipped to [0, 1], at level l.
__device__ __forceinline__ void level_corners(float ux, float uy, float uz,
                                              const Levels& lv, int l,
                                              Corners& c) {
  const int mode = lv.mode[l];
  const uint32_t res = lv.res[l];
  const float r = (float)res;
  const float s[3] = {__fmul_rn(ux, r), __fmul_rn(uy, r), __fmul_rn(uz, r)};
  const bool clip_cell = mode == kDense || mode == kCellHash;
  uint32_t cell[3];
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float f = floorf(s[a]);
    if (clip_cell) f = fminf(fmaxf(f, 0.0f), (float)(res - 1));
    hi[a] = __fsub_rn(s[a], f);
    lo[a] = __fsub_rn(1.0f, hi[a]);
    cell[a] = (uint32_t)f;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c.w[k] = __fmul_rn(__fmul_rn((k & 4) ? hi[0] : lo[0],
                                 (k & 2) ? hi[1] : lo[1]),
                       (k & 1) ? hi[2] : lo[2]);
  }
  const uint32_t offset = lv.offset[l];
  const uint32_t stride = res + 1;
  if (mode == kCellHash) {
    const uint32_t h = mod(spatial_hash(cell[0], cell[1], cell[2]),
                           lv.size[l] / 8);
#pragma unroll
    for (int k = 0; k < 8; ++k) c.row[k] = offset + 8 * h + k;
  } else if (mode == kDense) {
    const uint32_t base =
        offset + (cell[2] * stride + cell[1]) * stride + cell[0];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c.row[k] = base + ((k & 1) ? stride * stride : 0u)
                 + ((k & 2) ? stride : 0u) + ((k & 4) ? 1u : 0u);
    }
  } else {
    const uint32_t size = lv.size[l];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t x = min(cell[0] + ((k >> 2) & 1), res);
      const uint32_t y = min(cell[1] + ((k >> 1) & 1), res);
      const uint32_t z = min(cell[2] + (k & 1), res);
      const uint32_t v = mode == kHash ? spatial_hash(x, y, z)
                                       : (z * stride + y) * stride + x;
      c.row[k] = offset + mod(v, size);
    }
  }
}

template <bool BF16>
__device__ __forceinline__ float value(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The tile's positions into shared memory (zeros past n).
__device__ __forceinline__ void load_positions(const float* __restrict__ u,
                                               float* su, int64_t base,
                                               int count) {
  if (threadIdx.x < 3 * kTile) {
    su[threadIdx.x] = (int)threadIdx.x < 3 * count
                          ? __ldcs(u + base * 3 + threadIdx.x)
                          : 0.0f;
  }
}

// Staged floats a sample: width rounded up to 32, plus 2, so the 16 lanes
// of a half-warp's 8-byte accesses land on 16 distinct bank pairs.
__device__ __forceinline__ int stage_stride(int width) {
  return ((width + 31) & ~31) + 2;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const float* __restrict__ table,
                           const float* __restrict__ u,
                           float* __restrict__ out, int64_t n,
                           const __grid_constant__ Levels lv) {
  __shared__ float su[3 * kTile];
  __shared__ __align__(16) float stage[kTile * kMaxStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = lv.n * kF;
  const int stride = stage_stride(width);
  const uint64_t policy = table_load::policy();
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < n;
       base += (int64_t)gridDim.x * kTile) {
    const int count = (int)min((int64_t)kTile, n - base);
    load_positions(u, su, base, count);
    __syncthreads();
    const float ux = clip01(su[3 * lane]);
    const float uy = clip01(su[3 * lane + 1]);
    const float uz = clip01(su[3 * lane + 2]);
    for (int l = warp; l < lv.n; l += kWarps) {
      Corners c;
      level_corners(ux, uy, uz, lv, l, c);
      float v[8][kF];
      if (lv.mode[l] == kCellHash) {
        const float* row = table + (int64_t)c.row[0] * kF;
        float4 q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q[j] = table_load::ld4(row + 4 * j, policy);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j][0] = q[j].x;
          v[2 * j][1] = q[j].y;
          v[2 * j + 1][0] = q[j].z;
          v[2 * j + 1][1] = q[j].w;
        }
      } else {
        float2 q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          q[k] = table_load::ld2(table + (int64_t)c.row[k] * kF, policy);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[k][0] = q[k].x;
          v[k][1] = q[k].y;
        }
      }
      float acc[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        acc[f] = __fmul_rn(c.w[0], value<BF16>(v[0][f]));
      }
#pragma unroll
      for (int k = 1; k < 8; ++k) {
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          acc[f] = __fadd_rn(acc[f], __fmul_rn(c.w[k], value<BF16>(v[k][f])));
        }
      }
      *reinterpret_cast<float2*>(stage + lane * stride + l * kF) =
          make_float2(acc[0], acc[1]);
    }
    __syncthreads();
    // the tile's count x width floats are contiguous in `out`
    float* dst = out + base * width;
    if (width % 4 == 0) {
      const int per = width / 4;
      for (int i = threadIdx.x; i < count * per; i += kThreads) {
        const float* src = stage + (i / per) * stride + 4 * (i % per);
        const float2 a = *reinterpret_cast<const float2*>(src);
        const float2 b = *reinterpret_cast<const float2*>(src + 2);
        __stcs(reinterpret_cast<float4*>(dst) + i,
               make_float4(a.x, a.y, b.x, b.y));
      }
    } else {
      const int per = width / 2;
      for (int i = threadIdx.x; i < count * per; i += kThreads) {
        __stcs(reinterpret_cast<float2*>(dst) + i,
               *reinterpret_cast<const float2*>(
                   stage + (i / per) * stride + 2 * (i % per)));
      }
    }
  }
}

// Sums x over the lanes of `peers` (the lanes holding the same row) into
// the lowest of them, by a pairwise tree: at each round every lane adds
// the value of its next remaining peer, then the lanes of odd rank drop
// out. Every lane of the warp must call it.
template <int K>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&x)[K]) {
  const unsigned lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);  // peers above this lane
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest) - 1;
    float t[K];
#pragma unroll
    for (int i = 0; i < K; ++i) t[i] = __shfl_sync(kFull, x[i], next & 31);
    if (next >= 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] += t[i];
    }
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

__device__ __forceinline__ bool nonzero2(float a, float b) {
  return a != 0.0f || b != 0.0f;  // NaN compares unequal to 0
}

__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_kernel(const float* __restrict__ g,
                           const float* __restrict__ u,
                           float* __restrict__ grad, int64_t n,
                           const __grid_constant__ Levels lv) {
  __shared__ float su[3 * kTile];
  __shared__ __align__(16) float stage[kTile * kMaxStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = lv.n * kF;
  const int stride = stage_stride(width);
  const int per = width / 2;
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < n;
       base += (int64_t)gridDim.x * kTile) {
    const int count = (int)min((int64_t)kTile, n - base);
    load_positions(u, su, base, count);
    const float2* src = reinterpret_cast<const float2*>(g + base * width);
    for (int i = threadIdx.x; i < kTile * per; i += kThreads) {
      const float2 v = i < count * per ? __ldcs(src + i)
                                       : make_float2(0.0f, 0.0f);
      *reinterpret_cast<float2*>(stage + (i / per) * stride + 2 * (i % per)) =
          v;
    }
    __syncthreads();
    const float ux = clip01(su[3 * lane]);
    const float uy = clip01(su[3 * lane + 1]);
    const float uz = clip01(su[3 * lane + 2]);
    for (int l = warp; l < lv.n; l += kWarps) {
      const float2 gl =
          *reinterpret_cast<const float2*>(stage + lane * stride + l * kF);
      const bool live = nonzero2(gl.x, gl.y);
      if (!__any_sync(kFull, live)) continue;  // empty slots: nothing to add
      Corners c;
      level_corners(ux, uy, uz, lv, l, c);
      if (lv.mode[l] == kCellHash) {
        float p[8 * kF];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          p[2 * k] = __fmul_rn(c.w[k], gl.x);
          p[2 * k + 1] = __fmul_rn(c.w[k], gl.y);
        }
        const unsigned peers =
            __match_any_sync(kFull, live ? c.row[0] : kNoRow);
        reduce_peers(peers, p);
        if (live && lane == __ffs(peers) - 1) {
          float4* dst =
              reinterpret_cast<float4*>(grad + (int64_t)c.row[0] * kF);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 q = make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2],
                                         p[4 * j + 3]);
            if (nonzero2(q.x, q.y) || nonzero2(q.z, q.w)) {
              atomicAdd(dst + j, q);
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float p[kF] = {__fmul_rn(c.w[k], gl.x), __fmul_rn(c.w[k], gl.y)};
          const unsigned peers =
              __match_any_sync(kFull, live ? c.row[k] : kNoRow);
          reduce_peers(peers, p);
          if (live && lane == __ffs(peers) - 1 && nonzero2(p[0], p[1])) {
            atomicAdd(reinterpret_cast<float2*>(grad) + c.row[k],
                      make_float2(p[0], p[1]));
          }
        }
      }
    }
    __syncthreads();
  }
}

bool valid(const Levels* lv) {
  return lv != nullptr && lv->n >= 1 && lv->n <= kMaxLevels;
}

}  // namespace

// table: (T, 2) float32, 16-byte aligned; u: (n, 3) float32; out: (n, 2 L)
// float32, 16-byte aligned. With bf16, each gathered value is rounded to
// bfloat16 before the float32 sum.
extern "C" int hash_encode_fwd_f32(const void* table, const void* u,
                                   void* out, int64_t n, const void* levels,
                                   int32_t bf16, void* stream) {
  const Levels* lv = (const Levels*)levels;
  if (!valid(lv)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float* t = (const float*)table;
    const float* p = (const float*)u;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t threads = (n + kTile - 1) / kTile * kThreads;
    if (bf16) {
      launch<&hash_encode_fwd_kernel<true>>(threads, s, t, p, o, n, *lv);
    } else {
      launch<&hash_encode_fwd_kernel<false>>(threads, s, t, p, o, n, *lv);
    }
  }
  return (int)cudaGetLastError();
}

// g: (n, 2 L) float32, 8-byte aligned; u: (n, 3) float32; grad: (table_rows,
// 2) float32, 16-byte aligned, zeroed here, then the row sums added.
extern "C" int hash_encode_bwd_f32(const void* g, const void* u, void* grad,
                                   int64_t n, int64_t table_rows,
                                   const void* levels, void* stream) {
  const Levels* lv = (const Levels*)levels;
  if (!valid(lv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(grad, 0, (size_t)table_rows * kF * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int64_t threads = (n + kTile - 1) / kTile * kThreads;
    launch<&hash_encode_bwd_kernel>(threads, s, (const float*)g,
                                    (const float*)u, (float*)grad, n, *lv);
  }
  return (int)cudaGetLastError();
}
