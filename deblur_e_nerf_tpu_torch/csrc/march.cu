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
// cutoffs. The masks kernel takes the one-cell dilation and, with
// superblocks, the pool and its radius-2 dilation in one launch (its
// design at march_masks_kernel). Bound: device-memory bytes (the grid read
// once, the dilated grid written once); the first design's three
// dependent launches took a launch's floor each, and its 64-bit index
// division and byte-by-byte neighbourhood reads, not its bytes, set its
// time.
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
constexpr int kMaxMaskRes = 2048;  // the masks' largest side

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

// The masks, one launch a march. A block takes 4 rows (y) x `bz` planes
// (z) of the grid, whole rows along x, in chunks of C cells (C = 16: a
// 16-byte vector, 4: a 32-bit word, 1: a byte; the largest the side and the
// pointers' alignment allow). First each chunk's OR over the 3 x 3 rows
// around its row (the one-cell dilation along y and z; vector loads, most
// from L1, a plane's 3 at a time), then the OR along x, in registers: each
// 32-bit word ORs its bytes shifted one cell each way (funnel shifts
// across the chunk's words; the neighbouring chunks' edge bytes by warp
// shuffles where a block has a chunk a thread and a row's chunks share a
// warp, as on the flagship's, EDS's and r5fix's grids, else staged in
// shared memory between the two phases), stored as one vector. Cells are
// 3-D coordinates from the block and thread indices: no 64-bit division.
// Registers set the time more than bytes: the instances a chunk a thread
// keep to 64 so that 4 blocks fit an SM (the flagship's 512 in one wave).
//
// With superblocks (side a multiple of 4, r = side / 4): the block's rows
// cover whole pooled rows (4 y-rows, bz a multiple of 4 planes), so each
// 4-byte word of a dilated chunk is one pooled cell's 4 x-cells of one row
// and the 4^3 pool is an OR of bits: the block ORs them into bit rows (32
// pooled cells a word) in shared memory and writes its pooled rows' words
// to `rows`. The pooled radius-2 dilation needs every pooled row, so the
// last block to finish (a ticket from a counter that it resets) takes it:
// it stages the bit rows in shared memory, ORs the 5 x 5 bit rows around
// each row, then along x by shifts of 1 and 2 bits, and expands them to
// bytes. One launch: no second launch and no memset (the counter is zero
// between launches). The counter is the library's own, so masks calls
// must not run concurrently on one device (the port issues them on one
// stream).
constexpr int kMaskRowsY = kPool;  // y-rows a block (one pooled row's)
constexpr int kMaskBlocks = 256;  // the fewest blocks a launch aims at
constexpr int kMaskBlocksPerSm = 4;  // resident blocks an SM (64 registers)
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block, at most

__device__ unsigned int g_masks_ticket = 0;

template <int C>
struct MaskChunk {
  static constexpr int kWords = C >= 4 ? C / 4 : 1;
  uint32_t w[kWords];
};

template <int C>
__device__ __forceinline__ void or_chunk(MaskChunk<C>& acc,
                                         const uint8_t* __restrict__ p) {
  if constexpr (C == 16) {
    const uint4 v = __ldg((const uint4*)p);
    acc.w[0] |= v.x;
    acc.w[1] |= v.y;
    acc.w[2] |= v.z;
    acc.w[3] |= v.w;
  } else if constexpr (C == 4) {
    acc.w[0] |= __ldg((const unsigned int*)p);
  } else {
    acc.w[0] |= __ldg(p);
  }
}

template <int C>
__device__ __forceinline__ void store_chunk(uint8_t* p,
                                            const MaskChunk<C>& c) {
  if constexpr (C == 16) {
    *(uint4*)p = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else if constexpr (C == 4) {
    *(uint32_t*)p = c.w[0];
  } else {
    *p = (uint8_t)c.w[0];
  }
}

// the one-cell dilation along x of a chunk whose left neighbour ends in
// byte `left` and whose right neighbour starts with byte `right` (0 at
// the grid's faces): bytes of 0 or 1, as the input's
template <int C>
__device__ __forceinline__ MaskChunk<C> dilate_x(const MaskChunk<C>& c,
                                                 uint32_t left,
                                                 uint32_t right) {
  MaskChunk<C> out;
  if constexpr (C == 1) {
    out.w[0] = c.w[0] | left | right;
  } else {
    constexpr int K = MaskChunk<C>::kWords;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t prev = i > 0 ? c.w[i - 1] : left << 24;
      const uint32_t next = i < K - 1 ? c.w[i + 1] : right;
      out.w[i] = c.w[i] | __funnelshift_l(prev, c.w[i], 8) |
                 __funnelshift_r(c.w[i], next, 8);
    }
  }
  return out;
}

// one pooled bit row's OR of the 5 x 5 rows around (qy, qz), word w, of
// the bit rows staged in shared memory (a plane's 5 rows at a time: the
// last block's work is small, and unrolled whole it held the kernel's
// registers up)
__device__ __forceinline__ uint32_t pooled_rows_or(
    const uint32_t* __restrict__ rows, int r, int words, int qy, int qz,
    int w) {
  uint32_t acc = 0;
#pragma unroll 1
  for (int dz = -2; dz <= 2; ++dz) {
    const int z = qz + dz;
    if (z < 0 || z >= r) continue;
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
      const int y = qy + dy;
      if (y >= 0 && y < r) acc |= rows[((size_t)z * r + y) * words + w];
    }
  }
  return acc;
}

// the last block: the pooled radius-2 dilation of the staged bit rows into
// bytes
__device__ void pooled_dilation(const uint32_t* __restrict__ rows,
                                uint8_t* __restrict__ pooled, int r) {
  const int words = (r + 31) / 32;
  for (int row = threadIdx.x; row < r * r; row += blockDim.x) {
    const int qy = row % r, qz = row / r;
    uint32_t prev = 0, cur = pooled_rows_or(rows, r, words, qy, qz, 0);
    uint8_t* out = pooled + (size_t)row * r;
    for (int w = 0; w < words; ++w) {
      const uint32_t next =
          w + 1 < words ? pooled_rows_or(rows, r, words, qy, qz, w + 1) : 0;
      // cell x takes x - 2 .. x + 2: bits moved up take the lower cells
      const uint32_t d = cur | (cur << 1) | (cur << 2) | (prev >> 31) |
                         (prev >> 30) | (cur >> 1) | (cur >> 2) |
                         (next << 31) | (next << 30);
      const int x0 = 32 * w, n = r - x0 < 32 ? r - x0 : 32;
      if ((n & 3) == 0 && (r & 3) == 0) {
        for (int k = 0; k < n; k += 4)
          *(uint32_t*)(out + x0 + k) = ((d >> k) & 1u) |
                                       (((d >> (k + 1)) & 1u) << 8) |
                                       (((d >> (k + 2)) & 1u) << 16) |
                                       (((d >> (k + 3)) & 1u) << 24);
      } else {
        for (int k = 0; k < n; ++k) out[x0 + k] = (d >> k) & 1u;
      }
      prev = cur;
      cur = next;
    }
  }
}

// a chunk's OR over the 3 x 3 rows around its row (y, z) (0 where not live)
template <int C>
__device__ __forceinline__ MaskChunk<C> rows_or(const uint8_t* __restrict__ in,
                                                int res, int y, int z, int cx,
                                                bool live) {
  MaskChunk<C> acc;
#pragma unroll
  for (int i = 0; i < MaskChunk<C>::kWords; ++i) acc.w[i] = 0;
  if (!live) return acc;
  // a plane's 3 rows at a time: 3 loads in flight a thread keep the
  // registers low enough for 4 resident blocks an SM (the flagship's 512
  // blocks in one wave)
#pragma unroll 1
  for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int zz = z + dz, yy = y + dy;
      if (zz >= 0 && zz < res && yy >= 0 && yy < res)
        or_chunk<C>(acc, in + ((size_t)zz * res + yy) * res + (size_t)cx * C);
    }
  return acc;
}

// a chunk's OR along x (its neighbours' edge bytes `left` and `right`)
// stored, and with `pool` its pooled cells' bits ORed into the block's bit
// rows (row: the chunk's row within the block)
template <int C>
__device__ __forceinline__ void store_dilated(
    uint8_t* __restrict__ out, uint32_t* bits, bool pool, int res, int y,
    int z, int cx, int row, int per_row, int words, const MaskChunk<C>& c,
    uint32_t left, uint32_t right) {
  constexpr int K = MaskChunk<C>::kWords;
  const MaskChunk<C> d = dilate_x<C>(c, left, right);
  store_chunk<C>(out + ((size_t)z * res + y) * res + (size_t)cx * C, d);
  if constexpr (C >= 4) {
    if (pool) {
      uint32_t b = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) b |= (uint32_t)(d.w[i] != 0u) << i;
      if (b) {
        const int px = cx * K;  // the chunk's first pooled cell
        atomicOr(bits + (row / kMaskRowsY / kPool) * words + px / 32,
                 b << (px % 32));
      }
    }
  }
}

template <int C, bool kSingle>
__global__ void __launch_bounds__(kThreads, kSingle ? kMaskBlocksPerSm : 2)
    march_masks_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out,
                       uint32_t* __restrict__ rows,
                       uint8_t* __restrict__ pooled, int res, int bz) {
  extern __shared__ __align__(16) unsigned char masks_smem[];
  constexpr int K = MaskChunk<C>::kWords;
  const int per_row = res / C;  // chunks a row
  const int n_rows = kMaskRowsY * bz;
  const int items = n_rows * per_row;
  const int y0 = blockIdx.x * kMaskRowsY, z0 = blockIdx.y * bz;
  const int words = (res / kPool + 31) / 32;  // a pooled row's bit words
  // kSingle: one chunk a thread, a row's chunks on neighbouring lanes of
  // one warp: the x-neighbours' edge words by shuffles, no staging
  MaskChunk<C>* yz = (MaskChunk<C>*)masks_smem;
  uint32_t* bits = (uint32_t*)(masks_smem +
                               (kSingle ? 0 : sizeof(MaskChunk<C>) * items));
  if (pooled != nullptr)
    for (int i = threadIdx.x; i < bz / kPool * words; i += blockDim.x)
      bits[i] = 0;
  if constexpr (kSingle) {
    const int it = threadIdx.x;
    const int row = it / per_row, cx = it - row * per_row;
    const int y = y0 + row % kMaskRowsY, z = z0 + row / kMaskRowsY;
    const bool live = it < items && y < res && z < res;
    const MaskChunk<C> acc = rows_or<C>(in, res, y, z, cx, live);
    const uint32_t left = __shfl_up_sync(kFull, acc.w[K - 1], 1);
    const uint32_t right = __shfl_down_sync(kFull, acc.w[0], 1);
    if (pooled != nullptr) __syncthreads();  // the bits zeroed
    if (live)
      store_dilated<C>(out, bits, pooled != nullptr, res, y, z, cx, row,
                       per_row, words, acc,
                       cx > 0 ? left >> (C == 1 ? 0 : 24) : 0,
                       cx + 1 < per_row ? right & 0xffu : 0);
  } else {
    // phase A: the OR over the 3 x 3 rows around each chunk's row
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int row = it / per_row, cx = it - row * per_row;
      const int y = y0 + row % kMaskRowsY, z = z0 + row / kMaskRowsY;
      yz[it] = rows_or<C>(in, res, y, z, cx, y < res && z < res);
    }
    __syncthreads();
    // phase B: the OR along x, stored; the pooled bits
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int row = it / per_row, cx = it - row * per_row;
      const int y = y0 + row % kMaskRowsY, z = z0 + row / kMaskRowsY;
      if (y >= res || z >= res) continue;
      store_dilated<C>(
          out, bits, pooled != nullptr, res, y, z, cx, row, per_row, words,
          yz[it], cx > 0 ? yz[it - 1].w[K - 1] >> (C == 1 ? 0 : 24) : 0,
          cx + 1 < per_row ? yz[it + 1].w[0] & 0xffu : 0);
    }
  }
  if (pooled == nullptr) return;
  __syncthreads();
  const int r = res / kPool;
  const int py = blockIdx.x;  // y0 / 4
  for (int i = threadIdx.x; i < bz / kPool * words; i += blockDim.x) {
    const int pz = z0 / kPool + i / words;
    if (pz < r) rows[((size_t)pz * r + py) * words + i % words] = bits[i];
  }
  // the last block to finish takes the pooled dilation
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y;
    last = atomicAdd(&g_masks_ticket, 1u) == blocks - 1;
    if (last) g_masks_ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the bit rows into shared memory first: one L2 round trip
  uint32_t* staged = (uint32_t*)masks_smem;
  for (int i = threadIdx.x; i < r * r * words; i += blockDim.x)
    staged[i] = __ldcg(rows + i);
  __syncthreads();
  pooled_dilation(staged, pooled, r);
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

struct MaskArgs {
  const uint8_t* in;
  uint8_t* dilated;
  uint32_t* rows;
  uint8_t* pooled;
  int res, bz;
};

template <int C, bool kSingle>
int launch_masks(dim3 grid, size_t smem, cudaStream_t s, const MaskArgs& a) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(march_masks_kernel<C, kSingle>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  march_masks_kernel<C, kSingle><<<grid, kThreads, smem, s>>>(
      a.in, a.dilated, a.rows, a.pooled, a.res, a.bz);
  return (int)cudaGetLastError();
}

// in: a res^3 mask; dilated: res^3 bytes, its one-cell dilation. With
// superblocks (res a multiple of 4, r = res / 4): pooled, r^3 bytes, the
// 4^3 max-pool of dilated dilated by two pooled cells, and rows, r^2 x
// ceil(r / 32) uint32 of scratch (the pooled bit rows); else both null.
// One kernel launch.
extern "C" int march_masks(const void* in, void* dilated, void* pooled,
                           void* rows, int64_t res, void* stream) {
  const bool sb = pooled != nullptr;
  if (in == nullptr || dilated == nullptr || res < 1 || res > kMaxMaskRes ||
      (sb && (rows == nullptr || res % kPool != 0)) ||
      (!sb && rows != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n = (int)res;
  const uintptr_t a = (uintptr_t)in | (uintptr_t)dilated;
  const int C = n % 16 == 0 && a % 16 == 0 ? 16
                : n % 4 == 0 && a % 4 == 0 ? 4 : 1;
  if (sb && C == 1) return (int)cudaErrorInvalidValue;
  if (sb && (uintptr_t)pooled % 4 != 0) return (int)cudaErrorInvalidValue;
  // bz planes a block, a multiple of 4 (whole pooled rows): about one
  // chunk a thread, fewer where that leaves fewer than kMaskBlocks blocks
  const int per_row = n / C;
  const int y_blocks = (n + kMaskRowsY - 1) / kMaskRowsY;
  int bz = kThreads / (kMaskRowsY * per_row) / kPool * kPool;
  while (bz > kPool &&
         (int64_t)y_blocks * ((n + bz - 1) / bz) < kMaskBlocks)
    bz -= kPool;
  bz = bz < kPool ? kPool : bz;
  const int words = (n / kPool + 31) / 32;
  size_t smem = (size_t)kMaskRowsY * bz * per_row * (C >= 4 ? C : 4) +
                (sb ? (size_t)bz / kPool * words * 4 : 0);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // the last block stages the pooled bit rows (a 256^3 grid's 32 KB; more
  // than 48 KB takes the attribute, up to the SM's 227 KB)
  if (sb) {
    const size_t staged = (size_t)(n / kPool) * (n / kPool) * words * 4;
    smem = staged > smem ? staged : smem;
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(y_blocks, (n + bz - 1) / bz);
  const MaskArgs args{(const uint8_t*)in, (uint8_t*)dilated,
                      (uint32_t*)rows, (uint8_t*)pooled, n, bz};
  cudaStream_t s = (cudaStream_t)stream;
  // a chunk a thread where a block's chunks fit its threads and a row's
  // chunks one warp
  const bool single = kMaskRowsY * bz * per_row <= kThreads &&
                      32 % per_row == 0;
  if (C == 16)
    return single ? launch_masks<16, true>(grid, smem, s, args)
                  : launch_masks<16, false>(grid, smem, s, args);
  if (C == 4)
    return single ? launch_masks<4, true>(grid, smem, s, args)
                  : launch_masks<4, false>(grid, smem, s, args);
  return launch_masks<1, false>(grid, smem, s, args);
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
