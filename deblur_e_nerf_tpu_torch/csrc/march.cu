// The occupancy-gated march's per-lane stages for Hopper (sm_90a): the
// occupancy masks, the coarse stages' flags and codes, the sample stage's
// flags, codes and per-ray demand counts, and the decode of the compacted
// sample codes. The stream compactions between the stages are
// csrc/compact.cu's.
//
// Replaces the rest of the JAX package's `march_rays`
// (deblur_e_nerf_tpu/models/renderer.py:226), which XLA compiles from
// elementwise passes and gathers: `_dilate_binary` :164 and
// `_maxpool_binary` :189 (march_masks_kernel), `_ray_t_bounds` :117, the
// jitter :263, `_timeline_at` :136 and stages 0 and 1 :294-393
// (march_coarse_rays_kernel, march_coarse_slots_kernel), stage 2 :395-423
// and the per-ray counts :436-441 (march_samples_kernel), the decode
// :425-434 and `coarse_complete` :449 (march_decode_kernel). ops/march.py
// holds the plain versions (the port's former renderer code) and
// `*_model`, a model of these kernels' operation order.
//
// Every float32 operation is rounded where the plain version's PyTorch
// operator rounds it, so the outputs are the plain version's bit for bit
// on the card: products and sums through __fmul_rn / __fadd_rn (no
// contraction into fused multiply-adds), quotients through __fdiv_rn
// (the slab test's reciprocal, the contraction's divisions), square roots
// through __fsqrt_rn, and the two operations whose PyTorch CUDA kernels
// have a form of their own taken in that form: a tensor divided by a
// Python number is a product with the float32 reciprocal (torch's
// div_true kernel for a CPU scalar divisor; `inv_step` below), and
// `torch.pow` is powf. NaN propagates through clamps, minima and maxima
// as in PyTorch's kernels. Only where, and how often, a value is computed
// differs from the plain version: a ray's bounds once a ray, a timeline
// value carried from one lane to the next where both lanes take it at the
// same float32 step.
//
// The contract of the coarse and sample stages: flags for every lane,
// and codes defined where flags is set. The compaction (csrc/compact.cu)
// reads a lane's code only where its flag is set (the kept payloads, and
// the cutoff among the dropped flagged lanes), so an unflagged lane's
// code is never written.
//
// Bound: the larger of device-memory bytes and float32 operations, as the
// function needs them (chip_smoke.py `march_bound`): read each ray's
// origin, direction, mask and jitter (or each buffer slot and its ray's
// values) once, the mask cells it looks up, and write a flag byte a lane
// and an int64 code a flagged lane; a timeline value a lane, and a point,
// its contraction and its cell only where a lane passes its bounds. The
// first design wrote every lane's code, 8 of a lane's 9 bytes: 252 MB on
// the flagship's superblock stage, of which 3.1% were read. Without those
// bytes the coarse stages are bound by their instructions on the H100: a
// lane that passes its bounds contracts its point (three IEEE divisions,
// seven with the sphere contraction) and looks the grid up, some 170
// instructions a warp, and the superblock stage's warps (one ray's 32
// lanes) nearly all take that path.
//
// The design (each lever timed on the H100 against the others in turns,
// PERF.md):
//  - Each lane kernel is built for every contraction, with and without a
//    cone angle (`Geo`): no branch on either in a lane.
//  - Stages 0 and 2 (march_coarse_rays_kernel): a block takes a run of
//    whole rays (8,192 lanes, at most 256 rays). One thread a ray does the
//    slab test, near/far planes and jitter, writes t_near and t_far and
//    keeps the ray's values in shared memory, with the timeline's
//    per-ray terms (the cone's switch step m and t at m). The block's
//    threads then sweep the run's lanes, one lane a thread, in lane order;
//    a lane's (ray, index) is a multiply-high and a shift of its offset in
//    the run (`fast_div`), and its flag goes to a staged tile, stored as
//    16-byte vectors. A flagged lane writes its code alone (3-4% of the
//    lanes are flagged; writing a 4-code sector where any lane is flagged
//    was slower here). A queue of the lanes that pass their bounds, to
//    give the grid lookups whole warps, and 32-bit grid cells were slower
//    too, and so were runs of 2,048 lanes.
//  - With a cone angle a block first takes powf(growth, n) for every step
//    n of the timeline into shared memory (`fill_powers`): a lane's
//    exponent is integral, so the geometric part reads the same float the
//    plain version's torch.pow computes, once a block instead of at each
//    of its thousands of lanes.
//  - Stage 1 (march_coarse_slots_kernel): one thread a superblock slot,
//    its 4 block lanes; the slot's code c divided once (a 64-bit
//    division, once for 4 lanes), the ray's values loaded once, a
//    block's upper timeline value carried as the next block's lower one,
//    the 4 flags one 4-byte store, the codes 4c + j as the slot's whole
//    32-byte sector where any lane is flagged.
//  - The sample stage (march_samples_kernel): one thread a block slot,
//    its 8 step lanes, likewise: 9 timeline values for 8 steps (a step's
//    t1 is the next step's t0 where both are taken at the same float32
//    k), the 8 flags one 8-byte store, the codes by 32-byte sectors (half
//    the lanes are flagged: a sector written whole was faster than its
//    flagged codes alone), the demand counted by a segmented warp sum over
//    the slots' ray ids (head flags from a neighbour comparison and a
//    ballot) and one integer atomic add a ray segment and warp: integer
//    sums, exact in any order.
//  - A lane takes the cheap tests of its flag first (the ray mask or the
//    slot's liveness, the step count, the bounds) and contracts its point
//    and reads the grid only where they pass: the flag is their
//    conjunction either way.
// The decode writes t_mid, dt and the ray index of each slot (the timeline
// only in live slots) and each ray's `coarse_complete` from the stages'
// cutoffs. The masks kernel dilates (any radius; two one-cell dilations
// are one of radius 2) or 4^3-pools, one thread an output cell, or for
// the one-cell dilation of a grid whose side is a multiple of 4 four cells
// along x a thread from 32-bit row loads.
//
// Each entry point launches one kernel on the given stream and returns
// its CUDA error (cudaErrorInvalidValue for an argument it does not
// take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockSteps = 8;  // timeline steps a block
constexpr int kSbBlocks = 4;    // blocks a superblock
constexpr int kPool = 4;        // the superblock mask's pooling factor
constexpr int kTileLanes = 8192;       // lanes a block stages in stages 0, 2
constexpr int kTileRays = kThreads;    // at most, one thread a ray
constexpr int64_t kDivRange = 1LL << 31;  // `fast_div`'s dividends
constexpr int kPowers = 2048;  // growth^n a block keeps, n < kPowers

enum Contraction : int32_t { kAabb = 0, kSphere = 1, kTanh = 2 };
enum Stage : int32_t { kSuperblocks = 0, kBlocksAfter = 1, kBlocksDense = 2 };

// A launch's geometry as compile-time constants: each lane kernel is
// built for every contraction, with and without a cone angle, so that a
// lane takes no branch on either
template <int C, bool K>
struct Geo {
  static constexpr int kContraction = C;
  static constexpr bool kCone = K;
};

// The render configuration's numbers, each formed on the host as the
// plain version forms it (ops/march.py `_params`): float32 roundings of
// the Python doubles it hands PyTorch; and the divisors' multipliers.
struct MarchParams {
  float aabb_lo[3];
  float aabb_hi[3];
  float near_plane;
  float far_plane;
  float step;       // float32(render_step_size)
  float inv_step;   // float32(1) / step: torch's `x / step` on the card
  float t_cross;    // float32(step / cone), the double quotient
  float growth;     // float32(1 + cone)
  float clamp_hi;   // float32(1 - 1e-7)
  float min_dir;    // float32(1e-10)
  float min_mag;    // float32(1e-6)
  int32_t contraction;
  int32_t cone;     // cone_angle > 0
  int32_t stratified;
  int64_t n_rays;
  int64_t max_samples;  // S
  int64_t n_blocks;
  int64_t n_superblocks;
  int64_t resolution;
  int64_t pooled_resolution;
  uint32_t sb_mul, sb_shr;    // n_superblocks' `fast_div` (ops/march.py
  uint32_t blk_mul, blk_shr;  // `divisor`), n_blocks'
};

// n / d for 0 <= n < 2^31 and the divisor's (mul, shr) = (ceil(2^p / d),
// p - 32) with p = 31 + ceil(log2 d), or (0, 0) for d = 1: with mul =
// (2^p + e) / d, 0 <= e < d <= 2^(p - 31), n mul / 2^p = n / d + n e /
// (d 2^p) and n e < 2^p, so the floor is n / d's.
__device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t mul,
                                             uint32_t shr) {
  return mul == 0 ? n : __umulhi(n, mul) >> shr;
}

// the host's (mul, shr) of divisor d; (0, 0) for d = 1 and for divisors
// past the range, which no launch divides by
void host_divisor(int64_t d, uint32_t& mul, uint32_t& shr) {
  mul = shr = 0;
  if (d <= 1 || d >= kDivRange) return;
  int l = 0;
  while ((1LL << l) < d) ++l;
  const int p = 31 + l;
  mul = (uint32_t)((((unsigned __int128)1 << p) + d - 1) / d);
  shr = (uint32_t)(p - 32);
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.minimum / torch.maximum
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
// one step of amin / amax along the last dimension
__device__ __forceinline__ float amin_step(float a, float b) {
  return (is_nan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float amax_step(float a, float b) {
  return (is_nan(a) || a > b) ? a : b;
}
// torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// The plain version's `_timeline_at(k, t0)` split into the terms of t0
// alone (the cone's switch step m and t at m) and those of k
struct Timeline {
  float t0, m, at_m;
};

template <bool kCone>
__device__ __forceinline__ Timeline timeline_of(float t0,
                                                const MarchParams& p) {
  Timeline t{t0, 0.f, 0.f};
  if constexpr (kCone) {
    const float x = clamp_min(__fsub_rn(p.t_cross, t0), 0.f);
    t.m = ceilf(__fmul_rn(x, p.inv_step));
    t.at_m = __fadd_rn(t0, __fmul_rn(t.m, p.step));
  }
  return t;
}

// The powers of the cone's growth a block reads: powf(growth, n) for the
// integral n below the count `fill_powers` returns, each computed once a
// block where the timeline takes it at thousands of lanes (a lane's
// exponent k - m is integral: k and m are integral floats below 2^24)
// n at word n + n / 8: a warp's lanes take exponents 8 apart (a block's
// steps), which fall in 32 distinct banks so
__shared__ float g_powers[kPowers + kPowers / 8];

__device__ __forceinline__ int power_at(int n) { return n + (n >> 3); }

// every thread of the block: min(kPowers, the largest step + 1) entries
__device__ __forceinline__ int fill_powers(const MarchParams& p) {
  const int64_t top = p.n_blocks * kBlockSteps + 1;
  const int n = top < kPowers ? (int)top : kPowers;
  for (int i = threadIdx.x; i < n; i += kThreads)
    g_powers[power_at(i)] = powf(p.growth, (float)i);
  __syncthreads();
  return n;
}

// k <= m selects the uniform value, as torch.where does (NaN: geometric);
// with kTable, growth^x from the block's first n_pow powers where x is one
// of their exponents, else powf
template <bool kCone, bool kTable>
__device__ __forceinline__ float timeline_at(float k, const Timeline& t,
                                             const MarchParams& p,
                                             int n_pow = 0) {
  const float uniform = __fadd_rn(t.t0, __fmul_rn(k, p.step));
  if constexpr (!kCone) {
    return uniform;
  } else {
    if (k <= t.m) return uniform;
    const float x = clamp_min(__fsub_rn(k, t.m), 0.f);
    if constexpr (kTable) {
      if (x < (float)n_pow && x == truncf(x))
        return __fmul_rn(t.at_m, g_powers[power_at((int)x)]);
    }
    return __fmul_rn(t.at_m, powf(p.growth, x));
  }
}

// the decode's timeline, the cone taken at run time
__device__ __forceinline__ float timeline(float k, float t0,
                                          const MarchParams& p) {
  if (p.cone) return timeline_at<true, false>(k, timeline_of<true>(t0, p), p);
  return timeline_at<false, false>(k, timeline_of<false>(t0, p), p);
}

// `_ray_t_bounds` and the jitter: ray r's [t_near, t_far]
template <class G>
__device__ __forceinline__ void ray_bounds(const MarchParams& p,
                                           const float o[3],
                                           const float d[3],
                                           const float* __restrict__ jitter,
                                           int64_t r, float& t_near,
                                           float& t_far) {
  t_near = p.near_plane;
  t_far = p.far_plane;
  if constexpr (G::kContraction == kAabb) {
    float t_in = 0.f, t_out = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float safe = fabsf(d[i]) < p.min_dir ? p.min_dir : d[i];
      const float inv = __fdiv_rn(1.f, safe);
      const float t0 = __fmul_rn(__fsub_rn(p.aabb_lo[i], o[i]), inv);
      const float t1 = __fmul_rn(__fsub_rn(p.aabb_hi[i], o[i]), inv);
      const float lo = min_nan(t0, t1), hi = max_nan(t0, t1);
      t_in = i == 0 ? lo : amax_step(t_in, lo);
      t_out = i == 0 ? hi : amin_step(t_out, hi);
    }
    t_near = max_nan(t_near, t_in);
    t_far = min_nan(t_far, t_out);
  }
  if (p.stratified) t_near = __fadd_rn(t_near, __fmul_rn(__ldg(jitter + r),
                                                          p.step));
}

// contraction.contract: world position -> contracted [0, 1]^3
template <class G>
__device__ __forceinline__ void contract(const MarchParams& p,
                                         const float x[3], float u[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u[i] = __fdiv_rn(__fsub_rn(x[i], p.aabb_lo[i]),
                     __fsub_rn(p.aabb_hi[i], p.aabb_lo[i]));
  if constexpr (G::kContraction == kSphere) {
    float v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = __fsub_rn(__fmul_rn(u[i], 2.f), 1.f);
    const float mag = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
        __fmul_rn(v[2], v[2])));
    const float safe = clamp_min(mag, p.min_mag);
    if (mag > 1.f) {
      const float scale = __fsub_rn(2.f, __fdiv_rn(1.f, safe));
#pragma unroll
      for (int i = 0; i < 3; ++i)
        v[i] = __fmul_rn(scale, __fdiv_rn(v[i], safe));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = __fadd_rn(__fmul_rn(v[i], 0.25f), 0.5f);
  } else if constexpr (G::kContraction == kTanh) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      u[i] = __fmul_rn(__fadd_rn(tanhf(__fsub_rn(u[i], 0.5f)), 1.f), 0.5f);
  }
}

// occupancy.grid_index's cell along one axis, before its clamp
__device__ __forceinline__ long long cell_of(float u, int64_t res) {
  return (long long)floorf(__fmul_rn(u, (float)res));
}

__device__ __forceinline__ long long clamp_cell(long long c, int64_t res) {
  return c < 0 ? 0 : (c > res - 1 ? res - 1 : c);
}

// the ray's point at t
__device__ __forceinline__ void position(const float o[3], const float d[3],
                                         float t, float x[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = __fadd_rn(o[i], __fmul_rn(d[i], t));
}

// the coarse stages' test at the point of ray (o, d) at t: the clamped
// lookup grid_index(u.clamp(0, 1 - 1e-7))
template <class G>
__device__ __forceinline__ bool coarse_lookup(const MarchParams& p,
                                              const float o[3],
                                              const float d[3], float t,
                                              const uint8_t* __restrict__ mask,
                                              int64_t res) {
  float x[3], u[3];
  position(o, d, t, x);
  contract<G>(p, x, u);
  long long c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ui = is_nan(u[i]) ? u[i] : fminf(fmaxf(u[i], 0.f),
                                                 p.clamp_hi);
    c[i] = clamp_cell(cell_of(ui, res), res);
  }
  return __ldg(mask + (c[2] * res + c[1]) * res + c[0]) != 0;
}

// the sample stage's test: occupancy.query, out of the grid unoccupied
template <class G>
__device__ __forceinline__ bool sample_lookup(const MarchParams& p,
                                              const float o[3],
                                              const float d[3], float t,
                                              const uint8_t* __restrict__ bin) {
  float x[3], u[3];
  position(o, d, t, x);
  contract<G>(p, x, u);
  const int64_t res = p.resolution;
  long long cell[3];
  bool in_grid = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cell[i] = cell_of(u[i], res);
    in_grid = in_grid && cell[i] >= 0 && cell[i] < res;
    cell[i] = clamp_cell(cell[i], res);
  }
  return in_grid && __ldg(bin + (cell[2] * res + cell[1]) * res + cell[0]) != 0;
}

__device__ __forceinline__ void load3(const float* __restrict__ a, int64_t r,
                                      float v[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __ldg(a + 3 * r + i);
}

__global__ void __launch_bounds__(kThreads)
    march_masks_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int64_t res_out,
                       int32_t pool, int32_t radius, int32_t words) {
  const int64_t n = res_out * res_out * res_out;
  if (words) {
    // the one-cell dilation, four cells along x a thread: each of the 3^2
    // rows (y, z) around them one 32-bit load of the four cells' bytes,
    // shifted a byte each way, and the two bytes beside them
    const int64_t cell = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
    if (cell >= n) return;
    const int64_t x = cell % res_out, y = (cell / res_out) % res_out,
                  z = cell / (res_out * res_out);
    uint32_t any = 0;
    for (int64_t k = z > 0 ? z - 1 : 0; k <= z + 1 && k < res_out; ++k)
      for (int64_t j = y > 0 ? y - 1 : 0; j <= y + 1 && j < res_out; ++j) {
        const uint8_t* row = in + (k * res_out + j) * res_out;
        const uint32_t w = __ldg((const unsigned int*)(row + x));
        any |= w | (w << 8) | (w >> 8);
        if (x > 0) any |= __ldg(row + x - 1);
        if (x + 4 < res_out) any |= (uint32_t)__ldg(row + x + 4) << 24;
      }
    *(uint32_t*)(out + cell) = any;  // bytes of 0 or 1, as the input's
    return;
  }
  const int64_t cell = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= n) return;
  const int64_t x = cell % res_out, y = (cell / res_out) % res_out,
                z = cell / (res_out * res_out);
  uint8_t any = 0;
  if (pool) {  // the 4^3 block of a grid kPool times finer
    const int64_t res_in = res_out * kPool;
    for (int64_t k = z * kPool; k < (z + 1) * kPool; ++k)
      for (int64_t j = y * kPool; j < (y + 1) * kPool; ++j)
        for (int64_t i = x * kPool; i < (x + 1) * kPool; ++i)
          any |= __ldg(in + (k * res_in + j) * res_in + i);
  } else {  // the (2 radius + 1)^3 neighbourhood, cut at the grid's faces
    const int64_t z0 = z - radius < 0 ? 0 : z - radius;
    const int64_t z1 = z + radius > res_out - 1 ? res_out - 1 : z + radius;
    const int64_t y0 = y - radius < 0 ? 0 : y - radius;
    const int64_t y1 = y + radius > res_out - 1 ? res_out - 1 : y + radius;
    const int64_t x0 = x - radius < 0 ? 0 : x - radius;
    const int64_t x1 = x + radius > res_out - 1 ? res_out - 1 : x + radius;
    for (int64_t k = z0; k <= z1; ++k)
      for (int64_t j = y0; j <= y1; ++j)
        for (int64_t i = x0; i <= x1; ++i)
          any |= __ldg(in + (k * res_out + j) * res_out + i);
  }
  out[cell] = any != 0;
}

// a run's rays in shared memory, and its staged flags (byte l of the
// run's chunk at head + l, head the chunk's offset from a 16-byte boundary)
struct RayRun {
  float o[3][kTileRays];
  float d[3][kTileRays];
  float tn[kTileRays], tf[kTileRays], m[kTileRays], at_m[kTileRays];
  uint8_t active[kTileRays];
  __align__(16) uint8_t flags[kTileLanes + 32];
};

// src[head, head + len) to dst[head, head + len), dst 16-byte aligned: the
// whole 16-byte vectors as one store each, the two partial ones byte by
// byte (their other bytes are another block's)
__device__ __forceinline__ void store_staged(uint8_t* dst,
                                             const uint8_t* src, int head,
                                             int len) {
  const int end = head + len;
  for (int lo = threadIdx.x * 16; lo < end; lo += kThreads * 16) {
    if (lo >= head && lo + 16 <= end) {
      *(uint4*)(dst + lo) = *(const uint4*)(src + lo);
    } else {
      for (int j = lo > head ? lo : head; j < lo + 16 && j < end; ++j)
        dst[j] = src[j];
    }
  }
}

// stages 0 (superblocks) and 2 (dense blocks): rays [ray0, ray0 + nr) of
// a block, lanes ray x per + index
template <class G>
__global__ void __launch_bounds__(kThreads)
    march_coarse_rays_kernel(const MarchParams p, int32_t stage,
                             int32_t run_rays, const float* __restrict__ o,
                             const float* __restrict__ d,
                             const uint8_t* __restrict__ ray_mask,
                             const float* __restrict__ jitter,
                             const uint8_t* __restrict__ mask,
                             float* __restrict__ t_near_out,
                             float* __restrict__ t_far_out,
                             uint8_t* __restrict__ flags,
                             int64_t* __restrict__ codes) {
  __shared__ RayRun s;
  const bool sb = stage == kSuperblocks;
  const int per = (int)(sb ? p.n_superblocks : p.n_blocks);
  const uint32_t mul = sb ? p.sb_mul : p.blk_mul;
  const uint32_t shr = sb ? p.sb_shr : p.blk_shr;
  const int64_t ray0 = (int64_t)blockIdx.x * run_rays;
  const int64_t left = p.n_rays - ray0;
  const int nr = left < run_rays ? (int)left : run_rays;
  const int t = threadIdx.x;
  if (t < nr) {  // the ray's bounds, once
    const int64_t r = ray0 + t;
    float ro[3], rd[3], tn, tf;
    load3(o, r, ro);
    load3(d, r, rd);
    ray_bounds<G>(p, ro, rd, jitter, r, tn, tf);
    t_near_out[r] = tn;
    t_far_out[r] = tf;
    const Timeline tl = timeline_of<G::kCone>(tn, p);
    s.tn[t] = tn;
    s.tf[t] = tf;
    s.m[t] = tl.m;
    s.at_m[t] = tl.at_m;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.o[i][t] = ro[i];
      s.d[i][t] = rd[i];
    }
    s.active[t] = __ldg(ray_mask + r) != 0;
  }
  const int n_pow = G::kCone ? fill_powers(p) : 0;  // syncs when it fills
  __syncthreads();
  const float steps = sb ? (float)(kSbBlocks * kBlockSteps)
                         : (float)kBlockSteps;
  const int64_t res = sb ? p.pooled_resolution : p.resolution;
  const int64_t lane0 = ray0 * per;
  const int n = nr * per;
  for (int base = 0; base < n; base += kTileLanes) {
    const int len = n - base < kTileLanes ? n - base : kTileLanes;
    uint8_t* dst = flags + lane0 + base;
    const int head = (int)((uintptr_t)dst & 15);
    for (int l = t; l < len; l += kThreads) {
      const uint32_t local = (uint32_t)(base + l);
      const uint32_t r = fast_div(local, mul, shr);
      bool flag = false;
      if (s.active[r]) {
        const float b = (float)(int)(local - r * (uint32_t)per);
        const float k_lo = __fmul_rn(b, steps);
        const float k_mid = __fadd_rn(k_lo, 0.5f * steps);
        const float k_hi = __fmul_rn(__fadd_rn(b, 1.f), steps);
        const Timeline tl{s.tn[r], s.m[r], s.at_m[r]};
        flag = timeline_at<G::kCone, true>(k_lo, tl, p, n_pow) < s.tf[r] &&
               timeline_at<G::kCone, true>(k_hi, tl, p, n_pow) > tl.t0;
        if (flag) {  // the grid lookup only where the bounds let it pass
          const float ro[3] = {s.o[0][r], s.o[1][r], s.o[2][r]};
          const float rd[3] = {s.d[0][r], s.d[1][r], s.d[2][r]};
          flag = coarse_lookup<G>(
              p, ro, rd, timeline_at<G::kCone, true>(k_mid, tl, p, n_pow),
              mask,
              res);
        }
      }
      s.flags[head + l] = flag;
      if (flag) codes[lane0 + local] = lane0 + local;
    }
    __syncthreads();
    store_staged(dst - head, s.flags, head, len);
    __syncthreads();
  }
}

// stage 1 (blocks after superblocks): one thread a superblock slot of
// `buf`, lanes slot x 4 + block of the superblock
template <class G>
__global__ void __launch_bounds__(kThreads)
    march_coarse_slots_kernel(const MarchParams p,
                              const float* __restrict__ o,
                              const float* __restrict__ d,
                              const uint8_t* __restrict__ mask,
                              const int64_t* __restrict__ buf,
                              int64_t n_slots,
                              const float* __restrict__ t_near,
                              const float* __restrict__ t_far,
                              uint8_t* __restrict__ flags,
                              int64_t* __restrict__ codes) {
  const int64_t slot = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (slot >= n_slots) return;
  const int64_t n_sb = p.n_superblocks;
  const int64_t c = __ldg(buf + slot);
  uint32_t bits = 0;
  if (c < p.n_rays * n_sb) {  // a live superblock (the fill is not)
    const int64_t ray = c / n_sb;
    const int blk0 = (int)(c - ray * n_sb) * kSbBlocks;
    float ro[3], rd[3];
    load3(o, ray, ro);
    load3(d, ray, rd);
    const float tf = __ldg(t_far + ray);
    const Timeline tl = timeline_of<G::kCone>(__ldg(t_near + ray), p);
    const float steps = (float)kBlockSteps;
    float k_prev = __fmul_rn((float)blk0, steps);
    float t_prev = timeline_at<G::kCone, false>(k_prev, tl, p);
#pragma unroll
    for (int j = 0; j < kSbBlocks; ++j) {
      const float b = (float)(blk0 + j);
      const float k_lo = __fmul_rn(b, steps);
      const float k_hi = __fmul_rn(__fadd_rn(b, 1.f), steps);
      // the previous block's upper value where it is taken at the same k
      const float lo =
          k_lo == k_prev ? t_prev
                         : timeline_at<G::kCone, false>(k_lo, tl, p);
      const float hi = timeline_at<G::kCone, false>(k_hi, tl, p);
      bool flag = lo < tf && hi > tl.t0;
      if (flag)
        flag = coarse_lookup<G>(
            p, ro, rd,
            timeline_at<G::kCone, false>(__fadd_rn(k_lo, 0.5f * steps),
                                         tl, p),
            mask, p.resolution);
      bits |= (uint32_t)flag << (8 * j);
      k_prev = k_hi;
      t_prev = hi;
    }
    if (bits) {  // the slot's 32-byte sector of codes 4c + j (ray x
                 // n_blocks + block) where any lane is flagged
      longlong2* v = (longlong2*)(codes + 4 * slot);
      v[0] = make_longlong2(4 * c, 4 * c + 1);
      v[1] = make_longlong2(4 * c + 2, 4 * c + 3);
    }
  }
  *(uint32_t*)(flags + 4 * slot) = bits;
}

// the sample stage: one thread a block slot of `blk_buf`, lanes slot x 8 +
// step of the block; counts (R,) zero on entry
template <class G>
__global__ void __launch_bounds__(kThreads)
    march_samples_kernel(const MarchParams p, const float* __restrict__ o,
                         const float* __restrict__ d,
                         const uint8_t* __restrict__ binary,
                         const float* __restrict__ t_near,
                         const float* __restrict__ t_far,
                         const int64_t* __restrict__ blk_buf,
                         int64_t n_slots, uint8_t* __restrict__ flags,
                         int64_t* __restrict__ codes,
                         unsigned long long* __restrict__ counts) {
  const int64_t slot = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t R = p.n_rays, S = p.max_samples, nb = p.n_blocks;
  const int64_t c = slot < n_slots ? __ldg(blk_buf + slot) : R * nb;
  const bool live = c < R * nb;  // a live block (the fill is not)
  int n_pow = 0;  // the block's powers where a slot is live
  if (G::kCone && __syncthreads_or(live)) n_pow = fill_powers(p);
  unsigned long long bits = 0;
  long long ray = -1;  // slots past the end join no ray's count
  if (slot < n_slots) {
    const int64_t q = c / nb;
    ray = q < R - 1 ? q : R - 1;
    if (live) {
      const int64_t step0 = (c - q * nb) * kBlockSteps;
      float ro[3], rd[3];
      load3(o, ray, ro);
      load3(d, ray, rd);
      const float tn = __ldg(t_near + ray), tf = __ldg(t_far + ray);
      const Timeline tl = timeline_of<G::kCone>(tn, p);
      float k = (float)step0;
      float t0 = timeline_at<G::kCone, true>(k, tl, p, n_pow);
#pragma unroll
      for (int j = 0; j < kBlockSteps; ++j) {
        const int64_t step = step0 + j;
        if (step >= S) break;  // no later step of the block is below S
        const float k1 = __fadd_rn(k, 1.f);
        const float t1 = timeline_at<G::kCone, true>(k1, tl, p, n_pow);
        const float t_mid = __fmul_rn(0.5f, __fadd_rn(t0, t1));
        const bool flag = t_mid < tf && t_mid >= tn &&
                          sample_lookup<G>(p, ro, rd, t_mid, binary);
        bits |= (unsigned long long)flag << (8 * j);
        // the next step's t0 is this step's t1 where taken at the same k
        const float k_next = (float)(step + 1);
        t0 = k_next == k1 ? t1
                          : timeline_at<G::kCone, true>(k_next, tl, p,
                                                        n_pow);
        k = k_next;
      }
      // each 32-byte sector of 4 codes ray x S + step where any of its
      // lanes is flagged
      const long long code = ray * S + step0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((bits >> (32 * h)) & 0xffffffffu) {
          longlong2* v = (longlong2*)(codes + 8 * slot + 4 * h);
          v[0] = make_longlong2(code + 4 * h, code + 4 * h + 1);
          v[1] = make_longlong2(code + 4 * h + 2, code + 4 * h + 3);
        }
      }
    }
    *(unsigned long long*)(flags + 8 * slot) = bits;
  }
  // each ray's flagged lanes of this warp: a segmented sum over the slots'
  // ray ids (a segment starts where the ray differs from the previous
  // slot's), one atomic add a segment from its last slot
  const int n = __popcll(bits);  // the flag bytes are 0 or 1
  if (__ballot_sync(kFull, n != 0) == 0) return;
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(kFull, ray, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != ray);
  int sum = n;  // the warp's inclusive prefix sum
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int v = __shfl_up_sync(kFull, sum, k);
    if (lane >= k) sum += v;
  }
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int before = __shfl_sync(kFull, sum, (start + 31) & 31);
  const int segment = sum - (start > 0 ? before : 0);
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1);
  if (last && segment > 0)
    atomicAdd(counts + ray, (unsigned long long)segment);
}

__global__ void __launch_bounds__(kThreads)
    march_decode_kernel(const MarchParams p,
                        const int64_t* __restrict__ code_buf,
                        int64_t n_slots, const float* __restrict__ t_near,
                        const int64_t* __restrict__ sb_cut,
                        const int64_t* __restrict__ blk_cut,
                        float* __restrict__ t_mid, float* __restrict__ dt,
                        int64_t* __restrict__ ray_idx,
                        uint8_t* __restrict__ coarse_complete) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t R = p.n_rays, S = p.max_samples;
  if (i < n_slots) {
    const int64_t c = __ldg(code_buf + i);
    const bool live = c < R * S;
    float mid = 0.f, step = 0.f;  // an empty slot's
    if (live) {
      const float k = (float)(c % S);
      const float tn = __ldg(t_near + c / S);
      const float t0 = timeline(k, tn, p);
      const float t1 = timeline(__fadd_rn(k, 1.f), tn, p);
      mid = __fmul_rn(0.5f, __fadd_rn(t0, t1));
      step = __fsub_rn(t1, t0);
    }
    t_mid[i] = mid;
    dt[i] = step;
    ray_idx[i] = live ? c / S : R;
  }
  if (i < R) {
    // the first ray that lost a superblock or a block to a coarse budget
    int64_t first_bad = sb_cut != nullptr ? __ldg(sb_cut) / p.n_superblocks
                                          : R;
    const int64_t blk_bad = __ldg(blk_cut) / p.n_blocks;
    first_bad = blk_bad < first_bad ? blk_bad : first_bad;
    coarse_complete[i] = i < first_bad;
  }
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

bool params_ok(const MarchParams* p) {
  if (p == nullptr || p->n_rays <= 0 || p->max_samples <= 0 ||
      p->n_blocks <= 0 || p->resolution <= 0 ||
      p->contraction < kAabb || p->contraction > kTanh)
    return false;
  // the multipliers are the host's for these divisors
  uint32_t mul, shr;
  host_divisor(p->n_blocks, mul, shr);
  if (mul != p->blk_mul || shr != p->blk_shr) return false;
  host_divisor(p->n_superblocks, mul, shr);
  return p->n_superblocks < 1 || (mul == p->sb_mul && shr == p->sb_shr);
}

// f(Geo<contraction, cone>{}) for the launch's geometry
template <typename F>
int with_geometry(const MarchParams& p, F&& f) {
  switch (p.contraction * 2 + (p.cone ? 1 : 0)) {
    case 0: return f(Geo<kAabb, false>{});
    case 1: return f(Geo<kAabb, true>{});
    case 2: return f(Geo<kSphere, false>{});
    case 3: return f(Geo<kSphere, true>{});
    case 4: return f(Geo<kTanh, false>{});
    default: return f(Geo<kTanh, true>{});
  }
}

}  // namespace

// in: a (res_out * 4)^3 mask with pool, else res_out^3; out: res_out^3
// bytes. pool: 0 dilates by `radius` cells, 1 takes the 4^3 max-pool.
extern "C" int march_masks(const void* in, void* out, int64_t res_out,
                           int32_t pool, int32_t radius, void* stream) {
  if (in == nullptr || out == nullptr || res_out < 1 || radius < 0 ||
      res_out > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const int64_t n = res_out * res_out * res_out;
  const int32_t words = !pool && radius == 1 && res_out % 4 == 0 &&
                        (uintptr_t)in % 4 == 0 && (uintptr_t)out % 4 == 0;
  march_masks_kernel<<<blocks_for(words ? n / 4 : n), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, res_out, pool, radius, words);
  return (int)cudaGetLastError();
}

// stage 0 (superblocks) and 2 (dense blocks): lanes of R x n_superblocks
// or R x n_blocks; writes t_near and t_far (R,) besides the flags and
// codes. Stage 1 (blocks after superblocks, n_blocks = 4 n_superblocks):
// lanes of (KSB + 1) x 4 over `buf`, the superblock buffer; reads t_near
// and t_far. Flags for every lane; codes defined where flags is set.
// flags 4-byte aligned, codes 16-byte aligned. Stages 0 and 2 give each
// block `run_rays` whole rays (1 to 256, ops/march.py `run_rays`; any
// count is right, 8,192 lanes a block keeps its staged tile full);
// stage 1 ignores it.
extern "C" int march_coarse(const void* params, int32_t stage,
                            const void* rays_o, const void* rays_d,
                            const void* ray_mask, const void* jitter,
                            const void* mask, const void* buf,
                            int64_t n_lanes, int32_t run_rays, void* t_near,
                            void* t_far, void* flags, void* codes,
                            void* stream) {
  const MarchParams* p = (const MarchParams*)params;
  if (!params_ok(p) || stage < kSuperblocks || stage > kBlocksDense ||
      n_lanes < 1 || rays_o == nullptr || rays_d == nullptr ||
      mask == nullptr || t_near == nullptr || t_far == nullptr ||
      flags == nullptr || codes == nullptr ||
      (uintptr_t)flags % 4 != 0 || (uintptr_t)codes % 16 != 0 ||
      (stage == kBlocksAfter ? buf == nullptr : ray_mask == nullptr) ||
      (stage != kBlocksAfter && p->stratified && jitter == nullptr) ||
      (stage == kSuperblocks && p->n_superblocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == kBlocksAfter) {
    if (n_lanes % kSbBlocks != 0 ||
        p->n_blocks != kSbBlocks * p->n_superblocks)
      return (int)cudaErrorInvalidValue;
    const int64_t n_slots = n_lanes / kSbBlocks;
    return with_geometry(*p, [&](auto g) {
      march_coarse_slots_kernel<decltype(g)>
          <<<blocks_for(n_slots), kThreads, 0, s>>>(
          *p, (const float*)rays_o, (const float*)rays_d,
          (const uint8_t*)mask, (const int64_t*)buf, n_slots,
          (const float*)t_near, (const float*)t_far, (uint8_t*)flags,
          (int64_t*)codes);
      return (int)cudaGetLastError();
    });
  }
  const int64_t per = stage == kSuperblocks ? p->n_superblocks : p->n_blocks;
  if (n_lanes != p->n_rays * per || run_rays < 1 || run_rays > kTileRays ||
      run_rays * per >= kDivRange)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((p->n_rays + run_rays - 1) / run_rays);
  return with_geometry(*p, [&](auto g) {
    march_coarse_rays_kernel<decltype(g)><<<blocks, kThreads, 0, s>>>(
        *p, stage, run_rays, (const float*)rays_o, (const float*)rays_d,
        (const uint8_t*)ray_mask, (const float*)jitter,
        (const uint8_t*)mask, (float*)t_near, (float*)t_far,
        (uint8_t*)flags, (int64_t*)codes);
    return (int)cudaGetLastError();
  });
}

// lanes of (KB + 1) x 8 over the block buffer; counts: (R,) int64, zero on
// entry. Flags for every lane; codes defined where flags is set. flags
// and codes 16-byte aligned (flags 8-byte).
extern "C" int march_samples(const void* params, const void* rays_o,
                             const void* rays_d, const void* binary,
                             const void* t_near, const void* t_far,
                             const void* blk_buf, int64_t n_lanes,
                             void* flags, void* codes, void* counts,
                             void* stream) {
  const MarchParams* p = (const MarchParams*)params;
  if (!params_ok(p) || n_lanes < 1 || n_lanes % kBlockSteps != 0 ||
      rays_o == nullptr || rays_d == nullptr || binary == nullptr ||
      t_near == nullptr || t_far == nullptr || blk_buf == nullptr ||
      flags == nullptr || codes == nullptr || counts == nullptr ||
      (uintptr_t)flags % 8 != 0 || (uintptr_t)codes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_slots = n_lanes / kBlockSteps;
  return with_geometry(*p, [&](auto g) {
    march_samples_kernel<decltype(g)>
        <<<blocks_for(n_slots), kThreads, 0, (cudaStream_t)stream>>>(
        *p, (const float*)rays_o, (const float*)rays_d,
        (const uint8_t*)binary, (const float*)t_near, (const float*)t_far,
        (const int64_t*)blk_buf, n_slots, (uint8_t*)flags, (int64_t*)codes,
        (unsigned long long*)counts);
    return (int)cudaGetLastError();
  });
}

// n_slots sample codes (K + 1) -> t_mid, dt, ray_idx; R rays ->
// coarse_complete. sb_cut may be null (no superblock stage).
extern "C" int march_decode(const void* params, const void* code_buf,
                            int64_t n_slots, const void* t_near,
                            const void* sb_cut, const void* blk_cut,
                            void* t_mid, void* dt, void* ray_idx,
                            void* coarse_complete, void* stream) {
  const MarchParams* p = (const MarchParams*)params;
  if (!params_ok(p) || n_slots < 1 || code_buf == nullptr ||
      t_near == nullptr || blk_cut == nullptr || t_mid == nullptr ||
      dt == nullptr || ray_idx == nullptr || coarse_complete == nullptr ||
      (sb_cut != nullptr && p->n_superblocks < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t n = n_slots > p->n_rays ? n_slots : p->n_rays;
  march_decode_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      *p, (const int64_t*)code_buf, n_slots, (const float*)t_near,
      (const int64_t*)sb_cut, (const int64_t*)blk_cut, (float*)t_mid,
      (float*)dt, (int64_t*)ray_idx, (uint8_t*)coarse_complete);
  return (int)cudaGetLastError();
}
