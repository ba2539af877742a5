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
// gradient once. The table is read once in that count. The arithmetic
// (index math, 8 F multiply-adds a level) is far below the card's float32
// rate. What the card loses time on instead is the table: 8 random row
// reads a sample and level, served by L2 and L1, and in the backward the
// L2's rate of atomic reductions.
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
//   - x-neighbour pairs: corners k and k + 4 (dx = 0, 1; k < 4) often lie
//     in one aligned 16 bytes of the float32 table (8 of the bf16 one),
//     a "unit" of rows 2 i and 2 i + 1: on a dense or tiled level when
//     row_k is even (row_{k+4} = row_k + 1), on a hash level of
//     power-of-two size whenever x is even (row_{k+4} = row_k ^ 1, the
//     level offset being 128-row aligned). Both directions test it at run
//     time, per corner pair, as row_k / 2 == row_{k+4} / 2;
//   - forward: the table is read in the encode's compute type. With bf16
//     (the wrapper's cached `table.to(torch.bfloat16)`, rounded to nearest
//     even as the kernel once rounded each gathered value) a cellhash row
//     is 32 bytes (one sector, two 16-byte loads) and a vertex row 4
//     bytes; with float32, 64 and 8. A vertex pair reads its unit with one
//     load (16 bytes float32, 8 bf16) and row_{k+4} with a second only
//     where it lies outside. Loads go through the non-coherent path with
//     the L2 evict_last policy on every table line (table_load.cuh: the
//     25 MB bf16 table fits half the L2, the 50 MB float32 one all of it,
//     against the streamed positions and features); all of a lane's loads
//     of a level are issued before the sum. k = 0..7 are summed in order, every
//     product and sum rounded on its own (__fmul_rn, __fadd_rn: no fused
//     multiply-add), so `encode_forward_model` in ops/hash_encode.py
//     reproduces the kernel bit for bit. Each lane stages its level's F
//     floats in shared memory (row stride = 2 mod 32 floats:
//     conflict-free); the block then writes the tile's 32 x L F floats as
//     16-byte stores, 128 contiguous bytes a sample;
//   - backward: the entry point zeroes the gradient (cudaMemsetAsync). A
//     warp whose 32 cotangents of a level are all zero (the step's empty
//     sample slots) skips the level. Otherwise each lane recomputes its
//     rows and weights and forms its 8 F contributions; one
//     __match_any_sync finds the lanes that share a target, whose
//     contributions a pairwise tree of shuffles sums into the lowest of
//     them, which issues the reductions:
//       cellhash: lanes with the same row; one 64-byte bulk reduction of
//         the row (cp.reduce.async.bulk .add.f32 from the lane's 64-byte
//         slot in shared memory; two slots a thread, so that the next
//         row is written while the last is read). The L2 takes it at
//         twice the rows/s of four RED.F32x4 (chip_smoke phase 3);
//       vertex levels: lanes in the same cell (the same 8 rows; one
//         64-bit key: one match and one tree a level, where keying by
//         corner takes eight of each); per corner pair, one RED.F32x4
//         where both rows lie in one unit and both receive a non-zero
//         sum (RED.F32x2 where one does), otherwise a RED.F32x2 each.
//     `backward_reductions` in ops/hash_encode.py counts what this issues.
//     A contribution that sums to zero issues no reduction (out starts at
//     +0.0 and x + (+-0) = x); NaN and infinities always reach the table.
//     The reductions land in any order: the sums are float32, within
//     (k - 1) eps sum|x| of the exact ones for a row of k contributions,
//     and a RED .add.f32 flushes a subnormal addend or sum to zero (less
//     than FLT_MIN lost a reduction).
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
constexpr int kRowFloats = 8 * kF;    // floats of a cellhash row
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNoKey = ~0ull;  // a lane with nothing to add

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
  uint64_t cell;    // the cell (x, y, z) as 21-bit fields: its rows' key
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
  c.cell = cell[0] | ((uint64_t)cell[1] << 21) | ((uint64_t)cell[2] << 42);
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

// One row's F = 2 values of the table's element type T, as float32.
__device__ __forceinline__ float2 bf16_pair(uint32_t bits) {
  return make_float2(__uint_as_float(bits << 16),
                     __uint_as_float(bits & 0xffff0000u));
}

// Reads of the table in its element type T: a cellhash row's 8 corners,
// a unit's two rows (the aligned pair 2 i, 2 i + 1), one row.
template <typename T>
struct Table;

template <>
struct Table<float> {
  static __device__ __forceinline__ void cell_row(const float* t,
                                                  uint32_t row0,
                                                  uint64_t policy,
                                                  float2 (&v)[8]) {
    const float* p = t + (int64_t)row0 * kF;
    float4 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = table_load::ld4(p + 4 * j, policy);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = make_float2(q[j].x, q[j].y);
      v[2 * j + 1] = make_float2(q[j].z, q[j].w);
    }
  }
  using Unit = float4;
  static __device__ __forceinline__ Unit unit(const float* t, uint32_t u,
                                              uint64_t policy) {
    return table_load::ld4(t + (int64_t)u * 2 * kF, policy);
  }
  static __device__ __forceinline__ float2 pick(const Unit& q, uint32_t r) {
    return (r & 1) ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
  }
  static __device__ __forceinline__ float2 row(const float* t, uint32_t r,
                                               uint64_t policy) {
    return table_load::ld2(t + (int64_t)r * kF, policy);
  }
};

template <>
struct Table<__nv_bfloat16> {
  static __device__ __forceinline__ void cell_row(const __nv_bfloat16* t,
                                                  uint32_t row0,
                                                  uint64_t policy,
                                                  float2 (&v)[8]) {
    const __nv_bfloat16* p = t + (int64_t)row0 * kF;
    const uint4 a = table_load::ld_u32x4(p, policy);
    const uint4 b = table_load::ld_u32x4(p + 8, policy);
    v[0] = bf16_pair(a.x);
    v[1] = bf16_pair(a.y);
    v[2] = bf16_pair(a.z);
    v[3] = bf16_pair(a.w);
    v[4] = bf16_pair(b.x);
    v[5] = bf16_pair(b.y);
    v[6] = bf16_pair(b.z);
    v[7] = bf16_pair(b.w);
  }
  using Unit = uint2;
  static __device__ __forceinline__ Unit unit(const __nv_bfloat16* t,
                                              uint32_t u, uint64_t policy) {
    return table_load::ld_u32x2(t + (int64_t)u * 2 * kF, policy);
  }
  static __device__ __forceinline__ float2 pick(const Unit& q, uint32_t r) {
    return bf16_pair((r & 1) ? q.y : q.x);
  }
  static __device__ __forceinline__ float2 row(const __nv_bfloat16* t,
                                               uint32_t r, uint64_t policy) {
    return bf16_pair(table_load::ld_u32(t + (int64_t)r * kF, policy));
  }
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const T* __restrict__ table,
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
      float2 v[8];
      if (lv.mode[l] == kCellHash) {
        Table<T>::cell_row(table, c.row[0], policy, v);
      } else {
        typename Table<T>::Unit q[4];
        float2 b[4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          q[k] = Table<T>::unit(table, c.row[k] >> 1, policy);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((c.row[k] >> 1) != (c.row[k + 4] >> 1)) {
            b[k] = Table<T>::row(table, c.row[k + 4], policy);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = Table<T>::pick(q[k], c.row[k]);
          v[k + 4] = (c.row[k] >> 1) == (c.row[k + 4] >> 1)
                         ? Table<T>::pick(q[k], c.row[k + 4])
                         : b[k];
        }
      }
      float2 acc = make_float2(__fmul_rn(c.w[0], v[0].x),
                               __fmul_rn(c.w[0], v[0].y));
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        acc.x = __fadd_rn(acc.x, __fmul_rn(c.w[k], v[k].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(c.w[k], v[k].y));
      }
      *reinterpret_cast<float2*>(stage + lane * stride + l * kF) = acc;
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

// Sums x over the lanes of `peers` (the lanes holding the same target)
// into the lowest of them, by a pairwise tree: at each round every lane
// adds the value of its next remaining peer, then the lanes of odd rank
// drop out. Every lane of the warp must call it.
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

// The bulk reduction of 64 bytes at `src` (shared memory, written by this
// thread) into `dst` (global), in this thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add64(float* dst,
                                                  const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(src);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;" ::"l"(dst), "r"(s), "r"(64u) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read their
// source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// 16 floats into this thread's 64-byte slot.
__device__ __forceinline__ void write_slot(float* slot,
                                           const float (&p)[kRowFloats]) {
#pragma unroll
  for (int j = 0; j < kRowFloats / 4; ++j) {
    reinterpret_cast<float4*>(slot)[j] =
        make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  }
}

// One unit's combined contribution (rows 2 u and 2 u + 1): F32x4 where
// both halves are non-zero, F32x2 where one is.
__device__ __forceinline__ void reduce_unit(float* grad, uint32_t unit,
                                            const float (&q)[4]) {
  const bool lo = nonzero2(q[0], q[1]), hi = nonzero2(q[2], q[3]);
  float* dst = grad + (int64_t)unit * 2 * kF;
  if (lo && hi) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(q[0], q[1], q[2], q[3]));
  } else if (lo) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(q[0], q[1]));
  } else if (hi) {
    atomicAdd(reinterpret_cast<float2*>(dst + kF), make_float2(q[2], q[3]));
  }
}

// A vertex cell's corner pair k, k + 4 (rows ra, rb; contributions pa,
// pb): one reduction of their unit where both rows lie in it (ra == rb
// where a corner was clipped), otherwise one F32x2 each; zero
// contributions issue nothing.
__device__ __forceinline__ void reduce_pair(float* grad, uint32_t ra,
                                            uint32_t rb, float2 pa,
                                            float2 pb) {
  if ((ra >> 1) == (rb >> 1)) {
    const bool a_hi = ra & 1;
    float q[4] = {a_hi ? 0.0f : pa.x, a_hi ? 0.0f : pa.y,
                  a_hi ? pa.x : 0.0f, a_hi ? pa.y : 0.0f};
    if (rb & 1) {
      q[2] += pb.x;
      q[3] += pb.y;
    } else {
      q[0] += pb.x;
      q[1] += pb.y;
    }
    reduce_unit(grad, ra >> 1, q);
    return;
  }
  if (nonzero2(pa.x, pa.y)) {
    atomicAdd(reinterpret_cast<float2*>(grad) + ra, pa);
  }
  if (nonzero2(pb.x, pb.y)) {
    atomicAdd(reinterpret_cast<float2*>(grad) + rb, pb);
  }
}

__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd_kernel(const float* __restrict__ g,
                           const float* __restrict__ u,
                           float* __restrict__ grad, int64_t n,
                           const __grid_constant__ Levels lv) {
  __shared__ float su[3 * kTile];
  __shared__ __align__(16) float stage[kTile * kMaxStride];
  // each thread's two 64-byte slots for bulk reductions
  __shared__ __align__(128) float slots[2][kThreads][kRowFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = lv.n * kF;
  const int stride = stage_stride(width);
  const int per = width / 2;
  int next_slot = 0;
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
      float p[kRowFloats];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        p[2 * k] = __fmul_rn(c.w[k], gl.x);
        p[2 * k + 1] = __fmul_rn(c.w[k], gl.y);
      }
      // peers: lanes with the same cellhash row, or in the same cell of a
      // vertex level (the same 8 rows)
      const bool cellhash = lv.mode[l] == kCellHash;
      const unsigned peers = __match_any_sync(
          kFull, !live ? kNoKey : cellhash ? (uint64_t)c.row[0] : c.cell);
      reduce_peers(peers, p);
      if (!live || lane != __ffs(peers) - 1) continue;
      if (cellhash) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < 8; ++k) any |= nonzero2(p[2 * k], p[2 * k + 1]);
        if (any) {
          bulk_wait_read<1>();  // the slot's last reduction has read it
          float* slot = slots[next_slot][threadIdx.x];
          write_slot(slot, p);
          bulk_reduce_add64(grad + (int64_t)c.row[0] * kF, slot);
          next_slot ^= 1;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          reduce_pair(grad, c.row[k], c.row[k + 4],
                      make_float2(p[2 * k], p[2 * k + 1]),
                      make_float2(p[2 * k + 8], p[2 * k + 9]));
        }
      }
    }
    __syncthreads();
  }
  bulk_wait_read<0>();  // the slots live as long as the block
}

// The L2's rate of atomic reductions, for chip_smoke.py's phase 3 only:
// n_ops reductions of 1.0 into random rows of `buf` (n_rows 64-byte rows),
// each by `mode`:
//   0: RED.F32x2 at a random 16-byte-aligned address;
//   1: RED.F32x4 at a random 16-byte-aligned address;
//   2: four RED.F32x4 covering a random 64-byte row (a cellhash row as
//      four vector reductions; one op is one row);
//   3: one 64-byte bulk reduction of a random 64-byte row from shared
//      memory, written before each issue as the encode backward does.
__device__ __forceinline__ uint32_t mix32(uint64_t i) {
  uint32_t h = (uint32_t)(i ^ (i >> 32)) * 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  h ^= h >> 13;
  return h;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    l2_reduction_kernel(float* __restrict__ buf, uint32_t n_rows,
                        int64_t n_ops) {
  __shared__ __align__(128) float slots[2][kThreads][kRowFloats];
  float p[kRowFloats];
#pragma unroll
  for (int j = 0; j < kRowFloats; ++j) p[j] = 1.0f;
  int next_slot = 0;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_ops;
       i += (int64_t)gridDim.x * kThreads) {
    const uint32_t h = mix32((uint64_t)i);
    if (MODE == 0 || MODE == 1) {
      float* dst = buf + (int64_t)(h % (4ull * n_rows)) * 4;
      if (MODE == 0) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(1.0f, 1.0f));
      } else {
        atomicAdd(reinterpret_cast<float4*>(dst),
                  make_float4(1.0f, 1.0f, 1.0f, 1.0f));
      }
    } else {
      float* dst = buf + (int64_t)(h % n_rows) * kRowFloats;
      if (MODE == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          atomicAdd(reinterpret_cast<float4*>(dst) + j,
                    make_float4(1.0f, 1.0f, 1.0f, 1.0f));
        }
      } else {
        bulk_wait_read<1>();
        float* slot = slots[next_slot][threadIdx.x];
        write_slot(slot, p);
        bulk_reduce_add64(dst, slot);
        next_slot ^= 1;
      }
    }
  }
  bulk_wait_read<0>();
}

bool valid(const Levels* lv) {
  return lv != nullptr && lv->n >= 1 && lv->n <= kMaxLevels;
}

}  // namespace

// table: (T, 2), float32 (table_bf16 = 0) or bfloat16 (1), T even, 16-byte
// aligned; u: (n, 3) float32; out: (n, 2 L) float32, 16-byte aligned.
extern "C" int hash_encode_fwd(const void* table, const void* u, void* out,
                               int64_t n, const void* levels,
                               int32_t table_bf16, void* stream) {
  const Levels* lv = (const Levels*)levels;
  if (!valid(lv)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float* p = (const float*)u;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t threads = (n + kTile - 1) / kTile * kThreads;
    if (table_bf16) {
      launch<&hash_encode_fwd_kernel<__nv_bfloat16>>(
          threads, s, (const __nv_bfloat16*)table, p, o, n, *lv);
    } else {
      launch<&hash_encode_fwd_kernel<float>>(threads, s, (const float*)table,
                                             p, o, n, *lv);
    }
  }
  return (int)cudaGetLastError();
}

// g: (n, 2 L) float32, 8-byte aligned; u: (n, 3) float32; grad: (table_rows,
// 2) float32, 16-byte aligned, zeroed here, then the row sums added.
extern "C" int hash_encode_bwd(const void* g, const void* u, void* grad,
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

// buf: n_rows x 16 float32, 128-byte aligned; mode as l2_reduction_kernel.
extern "C" int l2_reduction_rate(void* buf, int64_t n_rows, int64_t n_ops,
                                 int32_t mode, void* stream) {
  if (n_rows < 1 || n_rows > (1ll << 28) || mode < 0 || mode > 3) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* b = (float*)buf;
  const uint32_t r = (uint32_t)n_rows;
  switch (mode) {
    case 0: launch<&l2_reduction_kernel<0>>(n_ops, s, b, r, n_ops); break;
    case 1: launch<&l2_reduction_kernel<1>>(n_ops, s, b, r, n_ops); break;
    case 2: launch<&l2_reduction_kernel<2>>(n_ops, s, b, r, n_ops); break;
    default: launch<&l2_reduction_kernel<3>>(n_ops, s, b, r, n_ops); break;
  }
  return (int)cudaGetLastError();
}
