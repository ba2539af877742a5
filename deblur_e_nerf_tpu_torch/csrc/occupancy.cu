// The occupancy grid's update for Hopper (sm_90a): the evaluated cells'
// world points (and, under a cone angle, their steps), the EMA-max of
// density x step into the grid, the threshold (min(mean, occ_thre) with
// the floor, max-relative and occupied-fraction caps, the last through an
// exact quantile) with the binary mask, and the inverse-CDF sampler of
// occupied cells.
//
// Replaces the JAX package's occupancy update
// (deblur_e_nerf_tpu/models/occupancy.py:128), which XLA compiles from
// elementwise passes, a scatter-max, reductions and a sort: `eval_cells`
// :143 and `make_occ_eval_fn` :103 (occ_points), `warmup_update` :152 and
// `sampled_update` :158 (occ_ema), the threshold :180-206
// (occ_threshold), and `sample_occupied_cells` :64 with `_sample_cells`
// :91 (occ_sample_occupied). ops/occupancy.py holds the plain versions
// (the port's former update code) and `*_model`, per-lane models of
// these kernels' operation order.
//
// Rounding: every float32 operation rounds where the plain version's
// PyTorch operator rounds, so points, steps, the EMA, the quantile and the
// mask are the plain version's bit for bit on the card: products and sums
// through __fmul_rn / __fadd_rn (no contraction into fused multiply-adds),
// quotients through __fdiv_rn, roots through __fsqrt_rn; a tensor divided
// by a Python number is a product with the float32 reciprocal (torch's
// div_true kernel for a CPU scalar divisor: `inv_res`), atanh is atanhf;
// torch.lerp is its two-branch form with the fused multiply-add that nvcc
// makes of PyTorch's own lerp. NaN propagates through clamps, minima and
// maxima as in PyTorch's kernels, and through the scatter-max as in
// gpuAtomicMax (a NaN contribution or a NaN cell wins). The mean is the
// one number that is not the plain version's: it is summed in float64 in
// a fixed order (per-tile partials, then one block), where torch.mean
// sums float32 in its own tree; the cells that flip with it are counted
// by the callers.
//
// Bound: device-memory bytes everywhere. A point lane reads its cell (8
// bytes on a list), its jitter (12) and, under a cone angle, its camera
// id (8), and writes its point (12) and step (4) against some 20-40
// float32 operations; the EMA reads a cell and a density (and a step) and
// writes the cell; the threshold must read the grid once and write the
// mask; the sampler must read the mask and its variates and write the
// cells. A sampled EMA lane's access to its cell's key is scattered: a
// 32-byte sector where the keys exceed the L2, and an L2 atomic even
// where they do not, so its scatter is bound by those (chip_smoke's
// sector-aware bound counts the sectors).
//
// The design, simple first:
//  - occ_points: one thread a lane of the evaluated cell list (a
//    contiguous range of cells for a warmup chunk, else the concatenation
//    of up to two int64 lists, read in place: no copy of the
//    concatenation), the cell's x-fastest coordinates, jitter, the
//    reciprocal product, contract_inv; the step from the lane's camera.
//  - occ_ema, a warmup update: one launch a chunk of the field's
//    densities (the update holds no concatenation of them), writing
//    max(occs x decay, density x step) over its contiguous range, one
//    block a tile of kTile cells, and each block its tile's float64 sum
//    and its maximum.
//  - occ_ema, a sampled update: two launches whatever the number of
//    chunks (up to kMaxChunks a scatter launch). The scatter takes every
//    chunk from a table of the chunks' pointers and lane ranges (a
//    __grid_constant__ argument: still no concatenation of densities),
//    a thread kScatterLanes lanes: an atomicMax of an order-preserving
//    uint32 key of density x step into its cell's key (0 is below every
//    float's key, so a non-zero key flags a sampled cell): integer maxima,
//    the same in any order. The keys are a buffer the wrapper keeps zeroed between
//    updates: the finish pass, which reads every key anyway, writes 0 back
//    where it found one set, so no update memsets them. On a grid whose
//    keys exceed the L2 cache (EDS's 256^3: 67 MB against 50 MB) a lane's
//    scattered access was a random device-memory sector read and written
//    back; the scatter's blocks are therefore ordered by cell range (the
//    grid's z, the slowest index: every chunk's blocks of range 0, then
//    of range 1, ...), each range's keys small enough to stay in L2 while
//    its blocks run, and the lanes' cells, densities and steps are read
//    with evict-first loads (__ldcs). A block reads its lanes' cells for
//    every range, a density only for a lane of its range. The finish pass
//    decays each flagged cell exactly
//    once and takes the max with its key's float, one block a tile, 4
//    cells a thread by 16-byte loads and stores, writing the partials
//    (each thread's 4 cells summed in order, then the block's tree).
//  - occ_threshold: one block finishes the partials in a fixed order (no
//    float atomics: two runs, and two data-parallel ranks, give the same
//    bits) into the threshold with its floor and max-relative caps; with
//    an occupied-fraction cap, a radix select over the order-preserving
//    keys (four 8-bit digits, most significant first; a histogram pass
//    over the grid, warp-aggregated shared atomics, then one block picks
//    the digit) finds the two order statistics that torch.quantile reads,
//    with no sort of the grid and no size limit; the rank is torch's
//    (float32 q x (n - 1), the last index where a NaN is present), its
//    floor and ceiling, the weight and the lerp; then one pass writes
//    binary = occs > thre. The threshold stays on the card.
//  - occ_sample_occupied, the count-and-scan of csrc/compact.cu: one
//    block a tile of kSampleTile cells counts its occupied cells (one
//    16-byte load a thread) into its 32 groups' exclusive offsets and its
//    total, one block scans the tile totals into inclusive offsets and
//    the grid's total, then one thread a variate: m = floor(u x max(total,
//    1)) (the float32 product the plain version searches for; its cumsum
//    holds integers, so the first cumsum entry above it is the first
//    above m), a binary search of the tile offsets, then of the tile's
//    group offsets, then the group's 128 bytes by 16-byte words; the
//    fallback cell where nothing is occupied, the last cell where m
//    reaches the total (searchsorted's clamp).
//
// Each entry point launches on the given stream and returns the CUDA
// error of its launches (cudaErrorInvalidValue for an argument it does not
// take). None allocates: the wrapper hands in its scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;              // cells a block of the EMA
constexpr int kPerThread = kTile / kThreads;
constexpr int kSampleTile = 4096;        // cells a block of the sampler
constexpr int kGroup = 128;              // cells a group of the sampler
constexpr int kScanThreads = 1024;
constexpr int kDigits = 4;               // 8-bit digits of a 32-bit key
constexpr unsigned kFull = 0xffffffffu;

enum Contraction : int32_t { kAabb = 0, kSphere = 1, kTanh = 2 };
constexpr int kMaxChunks = 64;          // chunks a scatter launch
constexpr int kScatterLanes = 4;        // lanes a thread of the scatter

// A sampled update's chunks of the field's densities: lanes start ..
// start + count of the evaluated cell list, density i at density + i x
// stride, its step at step + i (null: step_scalar).
struct EmaChunks {
  const float* density[kMaxChunks];
  const float* step[kMaxChunks];
  int64_t stride[kMaxChunks];
  int64_t start[kMaxChunks];
  int64_t count[kMaxChunks];
  int32_t n;
  float step_scalar;
};

// The points' parameters, each formed on the host as the plain version
// forms it (ops/occupancy.py `_values`): float32 roundings of the Python
// doubles it hands PyTorch.
struct PointsParams {
  float aabb_lo[3];
  float aabb_hi[3];
  float inv_res;     // float32(1) / float32(resolution)
  float sphere_max;  // float32(2 - 1e-6)
  float min_mag;     // float32(1e-6)
  float tanh_lo;     // float32(-1 + 1e-6)
  float tanh_hi;     // float32(1 - 1e-6)
  float step;        // float32(render_step_size)
  float cone;        // float32(cone_angle)
  float near_plane;
  float far_plane;
  int32_t contraction;
  int32_t cone_on;   // cone_angle > 0: the points kernel writes steps
  int32_t planes;    // near and far planes given
  int64_t resolution;
};

// The threshold's parameters.
struct ThresholdParams {
  float occ_thre;
  float thre_floor;
  float thre_rel_max;
  float q;            // float32(1 - max_occupied_fraction)
  int32_t use_floor;
  int32_t use_rel_max;
  int32_t use_quantile;
  int32_t pad;
  int64_t n_cells;
  int64_t n_tiles;
};

// The radix select's state between its passes (device memory).
struct SelectState {
  uint32_t prefix[2];  // the keys' digits found so far, for each rank
  uint32_t pad[2];
  int64_t rem[2];      // each rank within the cells matching its prefix
  float weight;        // the lerp's weight
  float base;          // the threshold before the quantile
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
// torch.clamp(x, min=lo) / torch.clamp(x, max=hi)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return is_nan(x) ? x : fminf(x, hi);
}

// An order-preserving key of a float: every NaN above +inf, -0 as +0, and
// every key at least 0x007fffff (-inf's), so 0 is below all of them.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (is_nan(f)) return 0xffffffffu;
  uint32_t bits = __float_as_uint(f);
  if (bits == 0x80000000u) bits = 0;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// sqrt((a0^2 + a1^2) + a2^2), contraction._norm's order
__device__ __forceinline__ float norm3(const float a[3]) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]),
                                        __fmul_rn(a[1], a[1])),
                              __fmul_rn(a[2], a[2])));
}

// contraction.contract_inv: contracted [0, 1]^3 -> world position
__device__ __forceinline__ void contract_inv(const PointsParams& p,
                                             const float u[3], float x[3]) {
  float ext[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ext[i] = __fsub_rn(p.aabb_hi[i], p.aabb_lo[i]);
  if (p.contraction == kSphere) {
    float w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = __fmul_rn(__fsub_rn(u[i], 0.5f), 4.f);
    const float mag = clamp_max(norm3(w), p.sphere_max);
    const float safe = clamp_min(mag, p.min_mag);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float v = mag > 1.f ? __fdiv_rn(__fdiv_rn(w[i], safe),
                                            __fsub_rn(2.f, mag))
                                : w[i];
      x[i] = __fadd_rn(p.aabb_lo[i],
                       __fmul_rn(__fmul_rn(__fadd_rn(v, 1.f), 0.5f), ext[i]));
    }
  } else if (p.contraction == kTanh) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float t = __fsub_rn(__fmul_rn(u[i], 2.f), 1.f);
      t = is_nan(t) ? t : fminf(fmaxf(t, p.tanh_lo), p.tanh_hi);
      x[i] = __fadd_rn(p.aabb_lo[i],
                       __fmul_rn(__fadd_rn(atanhf(t), 0.5f), ext[i]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      x[i] = __fadd_rn(p.aabb_lo[i], __fmul_rn(u[i], ext[i]));
  }
}

// lane g of the evaluated cell list: the cell g itself (no list), else
// the g-th of the concatenation of a (n_a cells) and b
__device__ __forceinline__ int64_t list_cell(const int64_t* __restrict__ a,
                                             int64_t n_a,
                                             const int64_t* __restrict__ b,
                                             int64_t g) {
  if (a == nullptr && b == nullptr) return g;
  return g < n_a ? __ldg(a + g) : __ldg(b + (g - n_a));
}

__global__ void __launch_bounds__(kThreads)
    occ_points_kernel(const PointsParams p, const int64_t* __restrict__ a,
                      int64_t n_a, const int64_t* __restrict__ b,
                      int64_t start, int64_t count,
                      const float* __restrict__ jitter,
                      const int64_t* __restrict__ cam_ids,
                      const float* __restrict__ cams,
                      float* __restrict__ x_out, float* __restrict__ step) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const int64_t g = start + i;
  const int64_t cell = list_cell(a, n_a, b, g);
  int64_t c[3];
  if (p.resolution <= 1625) {  // r^3 < 2^32: 32-bit divisions
    const uint32_t r = (uint32_t)p.resolution, k = (uint32_t)cell;
    c[0] = k % r;
    c[1] = (k / r) % r;
    c[2] = k / (r * r);
  } else {
    const int64_t r = p.resolution;
    c[0] = cell % r;
    c[1] = (cell / r) % r;
    c[2] = cell / (r * r);
  }
  float u[3], x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    u[k] = __fmul_rn(__fadd_rn((float)c[k], __ldg(jitter + 3 * g + k)),
                     p.inv_res);
  contract_inv(p, u, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) x_out[3 * i + k] = x[k];
  if (p.cone_on) {
    const int64_t cam = __ldg(cam_ids + g);
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = __fsub_rn(__ldg(cams + 3 * cam + k),
                                                 x[k]);
    const float t = norm3(v);
    float s = clamp_min(__fmul_rn(t, p.cone), p.step);
    if (p.planes && !(t > p.near_plane && t < p.far_plane)) s = 0.f;
    step[i] = s;
  }
}

// one block's float64 sum and NaN-propagating max of its threads' values,
// in a fixed order; thread 0 writes them
__device__ __forceinline__ void block_partials(double s, float m,
                                               double* __restrict__ psum,
                                               float* __restrict__ pmax,
                                               int64_t tile) {
  __shared__ double ssum[kThreads];
  __shared__ float smax[kThreads];
  ssum[threadIdx.x] = s;
  smax[threadIdx.x] = m;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      ssum[threadIdx.x] += ssum[threadIdx.x + w];
      smax[threadIdx.x] = max_nan(smax[threadIdx.x], smax[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    psum[tile] = ssum[0];
    pmax[tile] = smax[0];
  }
}

// a warmup chunk (cells start .. start + count, start a multiple of
// kTile), one block a tile
__global__ void __launch_bounds__(kThreads)
    occ_ema_tiles_kernel(const float* __restrict__ old,
                         float* __restrict__ out, float decay,
                         const float* __restrict__ density,
                         int64_t density_stride,
                         const float* __restrict__ step, float step_scalar,
                         int64_t start, int64_t count,
                         double* __restrict__ psum,
                         float* __restrict__ pmax) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  double s = 0.0;
  float m = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    if (i >= count) break;
    const int64_t c = start + i;
    const float decayed = __fmul_rn(__ldg(old + c), decay);
    const float occ = __fmul_rn(__ldg(density + i * density_stride),
                                step != nullptr ? __ldg(step + i)
                                                : step_scalar);
    const float v = max_nan(decayed, occ);
    out[c] = v;
    s += (double)v;
    m = max_nan(m, v);
  }
  block_partials(s, m, psum, pmax, start / kTile + blockIdx.x);
}

// the sampled update's finish, one block a tile, 4 cells a thread (16-byte
// loads and stores where `vec`): out = key ? max(old x decay, key's float)
// : old, the tile's partials, and the keys set zeroed again
__global__ void __launch_bounds__(kThreads)
    occ_ema_finish_kernel(const float* __restrict__ old,
                          float* __restrict__ out,
                          uint32_t* __restrict__ keys, float decay,
                          int64_t n, int32_t vec,
                          double* __restrict__ psum,
                          float* __restrict__ pmax) {
  const int64_t c0 = (int64_t)blockIdx.x * kTile + 4 * threadIdx.x;
  double s = 0.0;
  float m = -INFINITY;
  if (vec && c0 + 4 <= n) {
    const float4 o = __ldcs((const float4*)(old + c0));
    const uint4 k = *(const uint4*)(keys + c0);
    const float ov[4] = {o.x, o.y, o.z, o.w};
    const uint32_t kv[4] = {k.x, k.y, k.z, k.w};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = kv[i] != 0 ? max_nan(__fmul_rn(ov[i], decay), key_value(kv[i]))
                        : ov[i];
      s += (double)v[i];
      m = max_nan(m, v[i]);
    }
    if (k.x | k.y | k.z | k.w)
      *(uint4*)(keys + c0) = make_uint4(0u, 0u, 0u, 0u);
    __stcs((float4*)(out + c0), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    for (int64_t c = c0; c < c0 + 4 && c < n; ++c) {
      const uint32_t k = keys[c];
      const float o = __ldg(old + c);
      if (k != 0) keys[c] = 0;  // zero again for the next update
      const float v = k != 0 ? max_nan(__fmul_rn(o, decay), key_value(k))
                             : o;
      out[c] = v;
      s += (double)v;
      m = max_nan(m, v);
    }
  }
  block_partials(s, m, psum, pmax, blockIdx.x);
}

// a sampled update's scatter: blockIdx.y a chunk of the table, blockIdx.z
// a range of range_cells cells; kScatterLanes lanes of the chunk a thread
// (their cells loaded first, then the densities and steps of those in the
// block's range, then their atomics: more loads in flight a thread), each
// lane whose cell lies in the range putting density x step into its
// cell's key
__global__ void __launch_bounds__(kThreads)
    occ_ema_scatter_kernel(const __grid_constant__ EmaChunks t,
                           uint32_t* __restrict__ keys,
                           const int64_t* __restrict__ a, int64_t n_a,
                           const int64_t* __restrict__ b,
                           int64_t range_cells) {
  const int c = blockIdx.y;
  const int64_t count = t.count[c];
  const int64_t base =
      (int64_t)blockIdx.x * kThreads * kScatterLanes + threadIdx.x;
  const int64_t lo = (int64_t)blockIdx.z * range_cells;
  int64_t cell[kScatterLanes];
  bool in[kScatterLanes];
#pragma unroll
  for (int j = 0; j < kScatterLanes; ++j) {
    const int64_t i = base + j * kThreads;
    in[j] = i < count;
    if (in[j]) {
      const int64_t g = t.start[c] + i;
      cell[j] = g < n_a ? __ldcs((const long long*)a + g)
                        : __ldcs((const long long*)b + (g - n_a));
      in[j] = cell[j] >= lo && cell[j] < lo + range_cells;
    }
  }
  float occ[kScatterLanes];
#pragma unroll
  for (int j = 0; j < kScatterLanes; ++j) {
    const int64_t i = base + j * kThreads;
    if (in[j])
      occ[j] = __fmul_rn(__ldcs(t.density[c] + i * t.stride[c]),
                         t.step[c] != nullptr ? __ldcs(t.step[c] + i)
                                              : t.step_scalar);
  }
#pragma unroll
  for (int j = 0; j < kScatterLanes; ++j)
    if (in[j]) atomicMax(keys + cell[j], order_key(occ[j]));
}

// torch.lerp(self, end, weight)
__device__ __forceinline__ float torch_lerp(float self, float end, float w) {
  const float diff = __fsub_rn(end, self);
  return fabsf(w) < 0.5f ? __fmaf_rn(w, diff, self)
                         : __fmaf_rn(-diff, __fsub_rn(1.f, w), end);
}

// the partials into the threshold before the quantile; with a quantile,
// the select's ranks (one block of kScanThreads)
__global__ void __launch_bounds__(kScanThreads)
    occ_threshold_finish_kernel(const ThresholdParams p,
                                const double* __restrict__ psum,
                                const float* __restrict__ pmax,
                                SelectState* __restrict__ state,
                                float* __restrict__ thre) {
  __shared__ double ssum[kScanThreads];
  __shared__ float smax[kScanThreads];
  double s = 0.0;
  float m = -INFINITY;
  for (int64_t t = threadIdx.x; t < p.n_tiles; t += kScanThreads) {
    s += __ldg(psum + t);
    m = max_nan(m, __ldg(pmax + t));
  }
  ssum[threadIdx.x] = s;
  smax[threadIdx.x] = m;
  __syncthreads();
  for (int w = kScanThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      ssum[threadIdx.x] += ssum[threadIdx.x + w];
      smax[threadIdx.x] = max_nan(smax[threadIdx.x], smax[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float mean = (float)(ssum[0] / (double)p.n_cells);
  const float max = smax[0];
  float th = clamp_max(mean, p.occ_thre);
  if (p.use_floor) th = clamp_min(th, p.thre_floor);
  if (p.use_rel_max) th = max_nan(th, __fmul_rn(p.thre_rel_max, max));
  if (!p.use_quantile) {
    *thre = th;
    return;
  }
  // torch.quantile's rank: q x (n - 1) in float32, the last index where
  // the grid holds a NaN (its maximum is then NaN)
  const float last = (float)(p.n_cells - 1);
  const float rank = is_nan(max) ? last : __fmul_rn(p.q, last);
  const int64_t below = (int64_t)rank, above = (int64_t)ceilf(rank);
  state->prefix[0] = state->prefix[1] = 0;
  // (a float32 n - 1 above 2^24 may round past the last index)
  state->rem[0] = below < p.n_cells - 1 ? below : p.n_cells - 1;
  state->rem[1] = above < p.n_cells - 1 ? above : p.n_cells - 1;
  state->weight = __fsub_rn(rank, (float)below);
  state->base = th;
}

// one radix-select pass: the histogram of digit `pass` of the keys that
// match each rank's prefix (one histogram where the prefixes agree)
__global__ void __launch_bounds__(kThreads)
    occ_threshold_histogram_kernel(const float* __restrict__ occs, int64_t n,
                                int32_t pass,
                                const SelectState* __restrict__ state,
                                uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[2][256];
  for (int d = threadIdx.x; d < 512; d += kThreads) (&sh[0][0])[d] = 0;
  __syncthreads();
  const int shift = 24 - 8 * pass;
  const uint32_t prefix[2] = {state->prefix[0], state->prefix[1]};
  const int targets = prefix[0] == prefix[1] ? 1 : 2;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;  // a warp's lanes loop together
    const uint32_t key = i < n ? order_key(__ldg(occs + i)) : 0;
    const uint32_t digit = (key >> shift) & 0xffu;
    for (int t = 0; t < targets; ++t) {
      const bool match =
          i < n && ((uint64_t)(key ^ prefix[t]) >> (shift + 8)) == 0;
      if (!__any_sync(kFull, match)) continue;  // most lanes of later digits
      const unsigned peers =
          __match_any_sync(kFull, match ? digit : 0x100u + (unsigned)lane);
      if (match && lane == __ffs(peers) - 1)
        atomicAdd(&sh[t][digit], (uint32_t)__popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256 * targets; d += kThreads) {
    const uint32_t v = (&sh[0][0])[d];
    if (v) atomicAdd(hist + d, v);
  }
}

// one radix-select pass: each rank's digit from its histogram (one block
// of 256 threads, a digit each); after the last digit, the quantile and
// the threshold
__global__ void __launch_bounds__(256)
    occ_threshold_digit_kernel(int32_t pass, SelectState* __restrict__ state,
                            const uint32_t* __restrict__ hist,
                            float* __restrict__ thre) {
  __shared__ uint32_t scan[256];
  __shared__ uint32_t chosen[2];
  __shared__ int64_t chosen_rem[2];
  const int shift = 24 - 8 * pass;
  const bool same = state->prefix[0] == state->prefix[1];
  for (int t = 0; t < 2; ++t) {
    const uint32_t h = hist[(same ? 0 : t) * 256 + threadIdx.x];
    scan[threadIdx.x] = h;
    __syncthreads();
    for (int w = 1; w < 256; w <<= 1) {  // inclusive Hillis-Steele scan
      const uint32_t y = threadIdx.x >= w ? scan[threadIdx.x - w] : 0;
      __syncthreads();
      scan[threadIdx.x] += y;
      __syncthreads();
    }
    const int64_t incl = scan[threadIdx.x], excl = incl - h;
    const int64_t rem = state->rem[t];
    if (excl <= rem && rem < incl) {
      chosen[t] = state->prefix[t] | ((uint32_t)threadIdx.x << shift);
      chosen_rem[t] = rem - excl;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  for (int t = 0; t < 2; ++t) {
    state->prefix[t] = chosen[t];
    state->rem[t] = chosen_rem[t];
  }
  if (pass == kDigits - 1) {
    const float q = torch_lerp(key_value(chosen[0]), key_value(chosen[1]),
                               state->weight);
    *thre = max_nan(state->base, q);
  }
}

__global__ void __launch_bounds__(kThreads)
    occ_threshold_binary_kernel(const float* __restrict__ occs, int64_t n,
                      const float* __restrict__ thre,
                      uint8_t* __restrict__ binary) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  binary[i] = __ldg(occs + i) > __ldg(thre);
}

// the mask's 16 bytes (0 or 1 each) at cells c .. c + 16 of n, counted
__device__ __forceinline__ uint32_t count16(const uint8_t* __restrict__ m,
                                            int64_t c, int64_t n,
                                            bool aligned) {
  if (c + 16 <= n && aligned) {
    const uint4 w = __ldg((const uint4*)(m + c));
    return __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
  }
  uint32_t k = 0;
  for (int64_t i = c; i < c + 16 && i < n; ++i) k += __ldg(m + i) != 0;
  return k;
}

// one block a tile of kSampleTile cells, 16 cells a thread: each group of
// kGroup cells' count (8 lanes' shuffle sum), the tile's groups'
// exclusive offsets (one warp's scan) and the tile's count
__global__ void __launch_bounds__(kThreads)
    occ_sample_count_kernel(const uint8_t* __restrict__ binary, int64_t n,
                            uint32_t* __restrict__ group_excl,
                            uint32_t* __restrict__ tiles) {
  constexpr int kGroups = kSampleTile / kGroup;  // 32
  __shared__ uint32_t groups[kGroups];
  const int64_t c = (int64_t)blockIdx.x * kSampleTile + 16 * threadIdx.x;
  const bool aligned = ((uintptr_t)binary & 15) == 0;
  uint32_t k = count16(binary, c, n, aligned);
#pragma unroll
  for (int d = 4; d > 0; d >>= 1) k += __shfl_down_sync(kFull, k, d, 8);
  if ((threadIdx.x & 7) == 0) groups[threadIdx.x >> 3] = k;
  __syncthreads();
  if (threadIdx.x < 32) {
    const uint32_t g = groups[threadIdx.x];
    uint32_t incl = g;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, d);
      if ((int)threadIdx.x >= d) incl += y;
    }
    group_excl[(int64_t)blockIdx.x * kGroups + threadIdx.x] = incl - g;
    if (threadIdx.x == 31) tiles[blockIdx.x] = incl;
  }
}

// the tile counts into inclusive offsets, in place, and the total (one
// block of kScanThreads, a contiguous run of tiles a thread)
__global__ void __launch_bounds__(kScanThreads)
    occ_sample_scan_kernel(uint32_t* __restrict__ tiles, int64_t n_tiles,
                           int64_t* __restrict__ total) {
  __shared__ uint32_t scan[kScanThreads];
  const int64_t per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < n_tiles ? lo + per : n_tiles;
  uint32_t s = 0;
  for (int64_t t = lo; t < hi; ++t) s += tiles[t];
  scan[threadIdx.x] = s;
  __syncthreads();
  for (int w = 1; w < kScanThreads; w <<= 1) {
    const uint32_t y = threadIdx.x >= w ? scan[threadIdx.x - w] : 0;
    __syncthreads();
    scan[threadIdx.x] += y;
    __syncthreads();
  }
  uint32_t run = scan[threadIdx.x] - s;
  for (int64_t t = lo; t < hi; ++t) {
    run += tiles[t];
    tiles[t] = run;
  }
  if (threadIdx.x == kScanThreads - 1) *total = scan[kScanThreads - 1];
}

// one thread a variate: the tile, then the group, then the word of the
// (m + 1)-th occupied cell
__global__ void __launch_bounds__(kThreads)
    occ_sample_search_kernel(const uint8_t* __restrict__ binary,
                             int64_t n_cells,
                             const uint32_t* __restrict__ tiles,
                             const uint32_t* __restrict__ group_excl,
                             int64_t n_tiles,
                             const int64_t* __restrict__ total_ptr,
                             const float* __restrict__ u,
                             const int64_t* __restrict__ fallback, int64_t n,
                             int64_t* __restrict__ out) {
  constexpr int kGroups = kSampleTile / kGroup;
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t total = __ldg(total_ptr);
  if (total == 0) {
    out[j] = __ldg(fallback + j);
    return;
  }
  const float target = __fmul_rn(__ldg(u + j), fmaxf((float)total, 1.f));
  const int64_t m = (int64_t)floorf(target);
  if (m >= total) {  // searchsorted past the end, clamped to the last cell
    out[j] = n_cells - 1;
    return;
  }
  int64_t lo = 0, hi = n_tiles - 1;  // the first tile whose offset passes m
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if ((int64_t)__ldg(tiles + mid) > m) hi = mid; else lo = mid + 1;
  }
  uint32_t r = (uint32_t)(m - (lo > 0 ? (int64_t)__ldg(tiles + lo - 1) : 0));
  const uint32_t* excl = group_excl + lo * kGroups;
  int g = 0;  // the last group whose offset does not pass r
#pragma unroll
  for (int step = kGroups / 2; step > 0; step >>= 1)
    if (__ldg(excl + g + step) <= r) g += step;
  r -= __ldg(excl + g);
  const int64_t base = lo * kSampleTile + (int64_t)g * kGroup;
  int64_t cell = base;
  if (base + kGroup <= n_cells && ((uintptr_t)binary & 15) == 0) {
    const uint4* v = (const uint4*)(binary + base);
    for (int q = 0; q < kGroup / 16; ++q, cell += 16) {
      const uint4 w4 = __ldg(v + q);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
      const uint32_t k = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) +
                         __popc(w[3]);
      if (r >= k) {
        r -= k;
        continue;
      }
      for (int b = 0;; ++b) {  // the byte of the r-th set one
        if (((w[b >> 2] >> (8 * (b & 3))) & 0xffu) != 0 && r-- == 0) {
          cell += b;
          break;
        }
      }
      break;
    }
  } else {
    for (;; ++cell)
      if (__ldg(binary + cell) != 0 && r-- == 0) break;
  }
  out[j] = cell;
}

unsigned blocks_for(int64_t n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// x: (count, 3) points of lanes start .. start + count of the cell list
// (cells_a then cells_b, int64; both null: the cells start .. themselves);
// jitter (lanes, 3); with params->cone_on, cam_ids (lanes,) into cams
// (n_cams, 3) and step: (count,)
extern "C" int occ_points(const void* params, const void* cells_a,
                          int64_t n_a, const void* cells_b, int64_t n_b,
                          int64_t start, int64_t count, const void* jitter,
                          const void* cam_ids, const void* cams,
                          int64_t n_cams, void* x, void* step, void* stream) {
  const PointsParams* p = (const PointsParams*)params;
  if (p == nullptr || count < 1 || start < 0 || jitter == nullptr ||
      x == nullptr || p->resolution < 1 || p->contraction < kAabb ||
      p->contraction > kTanh || n_a < 0 || n_b < 0 ||
      ((cells_a != nullptr || cells_b != nullptr) &&
       start + count > n_a + n_b) ||
      (n_a > 0 && cells_a == nullptr) || (n_b > 0 && cells_b == nullptr) ||
      (p->cone_on && (cam_ids == nullptr || cams == nullptr || n_cams < 1 ||
                      step == nullptr)))
    return (int)cudaErrorInvalidValue;
  occ_points_kernel<<<blocks_for(count), kThreads, 0,
                      (cudaStream_t)stream>>>(
      *p, (const int64_t*)cells_a, n_a, (const int64_t*)cells_b, start,
      count, (const float*)jitter, (const int64_t*)cam_ids,
      (const float*)cams, (float*)x, (float*)step);
  return (int)cudaGetLastError();
}

// a warmup chunk: out[start + i] = max(old * decay, density_i x step_i)
// for i < count (start a multiple of kTile), with the chunk's tiles'
// partials; step null: step_scalar for every lane
extern "C" int occ_ema_warmup(const void* old, void* out, int64_t n_cells,
                              float decay, const void* density,
                              int64_t density_stride, const void* step,
                              float step_scalar, int64_t start,
                              int64_t count, void* psum, void* pmax,
                              void* stream) {
  if (n_cells < 1 || start < 0 || count < 1 || old == nullptr ||
      out == nullptr || density == nullptr || psum == nullptr ||
      pmax == nullptr || start % kTile != 0 || start + count > n_cells)
    return (int)cudaErrorInvalidValue;
  occ_ema_tiles_kernel<<<blocks_for(count, kTile), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)old, (float*)out, decay, (const float*)density,
      density_stride, (const float*)step, step_scalar, start, count,
      (double*)psum, (float*)pmax);
  return (int)cudaGetLastError();
}

// a sampled update's scatter of the chunks in `chunks` (an EmaChunks,
// host memory; lanes of the cell list cells_a then cells_b, int64) into
// keys (n_cells uint32, zero where no lane of this update has put a key),
// its blocks ordered by range of range_cells cells
extern "C" int occ_ema_scatter(const void* chunks, void* keys,
                               int64_t n_cells, const void* cells_a,
                               int64_t n_a, const void* cells_b,
                               int64_t n_b, int64_t range_cells,
                               void* stream) {
  const EmaChunks* t = (const EmaChunks*)chunks;
  if (t == nullptr || keys == nullptr || n_cells < 1 || t->n < 1 ||
      t->n > kMaxChunks || n_a < 0 || n_b < 0 ||
      (n_a > 0 && cells_a == nullptr) || (n_b > 0 && cells_b == nullptr) ||
      range_cells < 1)
    return (int)cudaErrorInvalidValue;
  int64_t most = 0;
  for (int c = 0; c < t->n; ++c) {
    if (t->density[c] == nullptr || t->count[c] < 1 || t->start[c] < 0 ||
        t->start[c] + t->count[c] > n_a + n_b)
      return (int)cudaErrorInvalidValue;
    most = t->count[c] > most ? t->count[c] : most;
  }
  const int64_t ranges = (n_cells + range_cells - 1) / range_cells;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(most, kThreads * kScatterLanes),
                  (unsigned)t->n, (unsigned)ranges);
  occ_ema_scatter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      *t, (uint32_t*)keys, (const int64_t*)cells_a, n_a,
      (const int64_t*)cells_b, range_cells);
  return (int)cudaGetLastError();
}

// a sampled update's finish over every cell: out = key ? max(old x decay,
// key's float) : old, every tile's partials, and the keys zeroed again
extern "C" int occ_ema_finish(const void* old, void* out, void* keys,
                              int64_t n_cells, float decay, void* psum,
                              void* pmax, void* stream) {
  if (n_cells < 1 || old == nullptr || out == nullptr || keys == nullptr ||
      psum == nullptr || pmax == nullptr)
    return (int)cudaErrorInvalidValue;
  const int32_t vec =
      (((uintptr_t)old | (uintptr_t)out | (uintptr_t)keys) & 15) == 0;
  occ_ema_finish_kernel<<<blocks_for(n_cells, kTile), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)old, (float*)out, (uint32_t*)keys, decay, n_cells, vec,
      (double*)psum, (float*)pmax);
  return (int)cudaGetLastError();
}

// the partials (params->n_tiles, of kTile cells) into thre (one float32)
// and binary (n_cells bytes); scratch: hist (kDigits x 2 x 256 uint32) and
// state (a SelectState), used with params->use_quantile
extern "C" int occ_threshold(const void* params, const void* occs,
                             const void* psum, const void* pmax, void* hist,
                             void* state, void* thre, void* binary,
                             void* stream) {
  const ThresholdParams* p = (const ThresholdParams*)params;
  if (p == nullptr || occs == nullptr || psum == nullptr || pmax == nullptr ||
      thre == nullptr || binary == nullptr || p->n_cells < 1 ||
      p->n_tiles != (p->n_cells + kTile - 1) / kTile ||
      (p->use_quantile && (hist == nullptr || state == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  occ_threshold_finish_kernel<<<1, kScanThreads, 0, s>>>(
      *p, (const double*)psum, (const float*)pmax, (SelectState*)state,
      (float*)thre);
  if (p->use_quantile) {
    cudaMemsetAsync(hist, 0, kDigits * 2 * 256 * sizeof(uint32_t), s);
    int sms = 132;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t want = blocks_for(p->n_cells);
    const unsigned blocks =
        (unsigned)(want < 8LL * sms ? want : 8LL * sms);
    for (int pass = 0; pass < kDigits; ++pass) {
      uint32_t* h = (uint32_t*)hist + pass * 2 * 256;
      occ_threshold_histogram_kernel<<<blocks, kThreads, 0, s>>>(
          (const float*)occs, p->n_cells, pass, (const SelectState*)state,
          h);
      occ_threshold_digit_kernel<<<1, 256, 0, s>>>(pass, (SelectState*)state,
                                                h, (float*)thre);
    }
  }
  occ_threshold_binary_kernel<<<blocks_for(p->n_cells), kThreads, 0, s>>>(
      (const float*)occs, p->n_cells, (const float*)thre, (uint8_t*)binary);
  return (int)cudaGetLastError();
}

// out: (n,) cells ~ the occupied cells of binary (n_cells bytes), by the
// variates u (n,), or fallback (n,) where none is occupied; scratch: tiles
// (ceil(n_cells / kSampleTile) uint32), group_excl (kSampleTile / kGroup
// uint32 a tile) and total (one int64)
extern "C" int occ_sample_occupied(const void* binary, int64_t n_cells,
                                   const void* u, const void* fallback,
                                   int64_t n, void* tiles, void* group_excl,
                                   void* total, void* out, void* stream) {
  if (binary == nullptr || u == nullptr || fallback == nullptr ||
      tiles == nullptr || group_excl == nullptr || total == nullptr ||
      out == nullptr || n_cells < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = (n_cells + kSampleTile - 1) / kSampleTile;
  occ_sample_count_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const uint8_t*)binary, n_cells, (uint32_t*)group_excl,
      (uint32_t*)tiles);
  occ_sample_scan_kernel<<<1, kScanThreads, 0, s>>>((uint32_t*)tiles,
                                                    n_tiles, (int64_t*)total);
  occ_sample_search_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const uint8_t*)binary, n_cells, (const uint32_t*)tiles,
      (const uint32_t*)group_excl, n_tiles, (const int64_t*)total,
      (const float*)u, (const int64_t*)fallback, n, (int64_t*)out);
  return (int)cudaGetLastError();
}
