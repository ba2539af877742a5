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
// (march_coarse_kernel), stage 2 :395-423 and the per-ray counts :436-441
// (march_samples_kernel), the decode :425-434 and `coarse_complete` :449
// (march_decode_kernel). ops/march.py holds the plain versions (the
// port's former renderer code) and `*_model`, a per-lane model of these
// kernels' operation order.
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
// as in PyTorch's kernels.
//
// Bound: device-memory bytes on every stage. A coarse or sample lane
// reads its ray's origin and direction (or its buffer slot and the ray's
// bounds), one mask byte, and writes a flag byte and an int64 code: 9
// bytes written a lane, against some 30-60 float32 operations (three
// timeline values, a contraction, a grid index), far below the 67
// TFLOP/s line. The codes are written as int64 (the compaction copies
// them): 252 MB written and read again on the flagship's sample stage.
//
// The design, simple first: one thread a lane, lanes in the plain
// version's row-major order (ray-major, then superblock, block or step),
// so that a warp's loads of a ray's origin, direction, bounds and buffer
// slot are a few cached lines. Stages 0 and the dense stage 1 compute
// each ray's bounds (the slab test, the near and far planes and the
// jitter) in every lane of the ray, and the lane of index 0 writes them
// for the later stages. A lane takes the cheap tests of its flag first
// (the ray mask or the buffer slot's liveness, the step count, the
// bounds) and contracts its point and reads the grid only where they
// pass: the flag is their conjunction either way, and most lanes of a
// step are empty slots or lie past t_far. The sample stage counts each
// ray's flagged lanes with one 64-bit atomic add a ray and warp
// (__match_any_sync groups a warp's lanes by ray): integer sums, exact in
// any order. The decode writes t_mid, dt and the ray index of each slot
// (the timeline only in live slots) and each ray's `coarse_complete` from
// the stages' cutoffs. The masks kernel dilates (any radius; two
// one-cell dilations are one of radius 2) or 4^3-pools, one thread an
// output cell, or for the one-cell dilation of a grid whose side is a
// multiple of 4 four cells along x a thread from 32-bit row loads.
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

enum Contraction : int32_t { kAabb = 0, kSphere = 1, kTanh = 2 };
enum Stage : int32_t { kSuperblocks = 0, kBlocksAfter = 1, kBlocksDense = 2 };

// The render configuration's numbers, each formed on the host as the
// plain version forms it (ops/march.py `_params`): float32 roundings of
// the Python doubles it hands PyTorch.
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
};

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

// the plain version's `_timeline_at(k, t0)`
__device__ __forceinline__ float timeline(float k, float t0,
                                          const MarchParams& p) {
  const float uniform = __fadd_rn(t0, __fmul_rn(k, p.step));
  if (!p.cone) return uniform;
  const float x = clamp_min(__fsub_rn(p.t_cross, t0), 0.f);
  const float m = ceilf(__fmul_rn(x, p.inv_step));
  const float at_m = __fadd_rn(t0, __fmul_rn(m, p.step));
  const float geom =
      __fmul_rn(at_m, powf(p.growth, clamp_min(__fsub_rn(k, m), 0.f)));
  return k <= m ? uniform : geom;
}

// `_ray_t_bounds` and the jitter: ray r's [t_near, t_far]
__device__ __forceinline__ void ray_bounds(const MarchParams& p,
                                           const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ jitter,
                                           int64_t r, float& t_near,
                                           float& t_far) {
  t_near = p.near_plane;
  t_far = p.far_plane;
  if (p.contraction == kAabb) {
    float t_in = 0.f, t_out = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float di = __ldg(d + 3 * r + i);
      const float oi = __ldg(o + 3 * r + i);
      const float safe = fabsf(di) < p.min_dir ? p.min_dir : di;
      const float inv = __fdiv_rn(1.f, safe);
      const float t0 = __fmul_rn(__fsub_rn(p.aabb_lo[i], oi), inv);
      const float t1 = __fmul_rn(__fsub_rn(p.aabb_hi[i], oi), inv);
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
__device__ __forceinline__ void contract(const MarchParams& p,
                                         const float x[3], float u[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u[i] = __fdiv_rn(__fsub_rn(x[i], p.aabb_lo[i]),
                     __fsub_rn(p.aabb_hi[i], p.aabb_lo[i]));
  if (p.contraction == kSphere) {
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
  } else if (p.contraction == kTanh) {
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

// the clamped lookup of the coarse stages: grid_index(u.clamp(0, 1 - 1e-7))
__device__ __forceinline__ bool coarse_lookup(const MarchParams& p,
                                              const float u[3],
                                              const uint8_t* __restrict__ mask,
                                              int64_t res) {
  long long c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ui = is_nan(u[i]) ? u[i] : fminf(fmaxf(u[i], 0.f),
                                                 p.clamp_hi);
    c[i] = clamp_cell(cell_of(ui, res), res);
  }
  return __ldg(mask + (c[2] * res + c[1]) * res + c[0]) != 0;
}

__device__ __forceinline__ void position(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         int64_t r, float t, float x[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = __fadd_rn(__ldg(o + 3 * r + i), __fmul_rn(__ldg(d + 3 * r + i), t));
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

__global__ void __launch_bounds__(kThreads)
    march_coarse_kernel(const MarchParams p, int32_t stage,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const uint8_t* __restrict__ ray_mask,
                        const float* __restrict__ jitter,
                        const uint8_t* __restrict__ mask,
                        const int64_t* __restrict__ buf, int64_t n_lanes,
                        float* __restrict__ t_near_out,
                        float* __restrict__ t_far_out,
                        uint8_t* __restrict__ flags,
                        int64_t* __restrict__ codes) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const int64_t R = p.n_rays;
  int64_t ray, blk = 0, code;
  bool active;
  float tn, tf;
  if (stage == kBlocksAfter) {
    // lane = superblock slot x 4 + block of the superblock
    const int64_t c = __ldg(buf + lane / kSbBlocks);
    ray = c / p.n_superblocks < R - 1 ? c / p.n_superblocks : R - 1;
    blk = (c % p.n_superblocks) * kSbBlocks + lane % kSbBlocks;
    active = c < R * p.n_superblocks;
    tn = __ldg(t_near_out + ray);
    tf = __ldg(t_far_out + ray);
    code = ray * p.n_blocks + blk;
  } else {
    // lane = ray x (superblocks or blocks a ray) + index
    const int64_t per = stage == kSuperblocks ? p.n_superblocks : p.n_blocks;
    ray = lane / per;
    blk = lane % per;
    active = __ldg(ray_mask + ray) != 0;
    ray_bounds(p, o, d, jitter, ray, tn, tf);
    if (blk == 0) {
      t_near_out[ray] = tn;
      t_far_out[ray] = tf;
    }
    code = lane;
  }
  float k_mid, k_lo, k_hi;
  const float b = (float)blk;
  int64_t res;
  if (stage == kSuperblocks) {
    constexpr float kSteps = kSbBlocks * kBlockSteps;
    k_lo = __fmul_rn(b, kSteps);
    k_mid = __fadd_rn(k_lo, kSteps / 2);
    k_hi = __fmul_rn(__fadd_rn(b, 1.f), kSteps);
    res = p.pooled_resolution;
  } else {
    k_lo = __fmul_rn(b, (float)kBlockSteps);
    k_mid = __fadd_rn(k_lo, kBlockSteps / 2.f);
    k_hi = __fmul_rn(__fadd_rn(b, 1.f), (float)kBlockSteps);
    res = p.resolution;
  }
  bool flag = active && timeline(k_lo, tn, p) < tf &&
              timeline(k_hi, tn, p) > tn;
  if (flag) {  // the grid lookup only where the bounds let the lane pass
    float x[3], u[3];
    position(o, d, ray, timeline(k_mid, tn, p), x);
    contract(p, x, u);
    flag = coarse_lookup(p, u, mask, res);
  }
  flags[lane] = flag;
  codes[lane] = code;
}

__global__ void __launch_bounds__(kThreads)
    march_samples_kernel(const MarchParams p, const float* __restrict__ o,
                         const float* __restrict__ d,
                         const uint8_t* __restrict__ binary,
                         const float* __restrict__ t_near,
                         const float* __restrict__ t_far,
                         const int64_t* __restrict__ blk_buf,
                         int64_t n_lanes, uint8_t* __restrict__ flags,
                         int64_t* __restrict__ codes,
                         unsigned long long* __restrict__ counts) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t R = p.n_rays, res = p.resolution;
  bool flag = false;
  int64_t ray = -1;  // lanes past the end join no ray's count
  if (lane < n_lanes) {
    // lane = block slot x 8 + step of the block
    const int64_t c = __ldg(blk_buf + lane / kBlockSteps);
    ray = c / p.n_blocks < R - 1 ? c / p.n_blocks : R - 1;
    const int64_t step = (c % p.n_blocks) * kBlockSteps + lane % kBlockSteps;
    if (c < R * p.n_blocks && step < p.max_samples) {  // a live block's step
      const float tn = __ldg(t_near + ray), tf = __ldg(t_far + ray);
      const float k = (float)step;
      const float t0 = timeline(k, tn, p);
      const float t1 = timeline(__fadd_rn(k, 1.f), tn, p);
      const float t_mid = __fmul_rn(0.5f, __fadd_rn(t0, t1));
      if (t_mid < tf && t_mid >= tn) {
        float x[3], u[3];
        position(o, d, ray, t_mid, x);
        contract(p, x, u);
        long long cell[3];
        bool in_grid = true;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          cell[i] = cell_of(u[i], res);
          in_grid = in_grid && cell[i] >= 0 && cell[i] < res;
          cell[i] = clamp_cell(cell[i], res);
        }
        flag = in_grid &&
               __ldg(binary + (cell[2] * res + cell[1]) * res + cell[0]) != 0;
      }
    }
    flags[lane] = flag;
    codes[lane] = ray * p.max_samples + step;
  }
  // each ray's flagged lanes of this warp, one atomic add
  const unsigned flagged = __ballot_sync(kFull, flag);
  if (flagged == 0) return;
  const unsigned peers =
      __match_any_sync(kFull, (unsigned long long)ray) & flagged;
  if (flag && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counts + ray, (unsigned long long)__popc(peers));
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
  return p != nullptr && p->n_rays > 0 && p->max_samples > 0 &&
         p->n_blocks > 0 && p->resolution > 0 &&
         p->contraction >= kAabb && p->contraction <= kTanh;
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
// codes. Stage 1 (blocks after superblocks): lanes of (KSB + 1) x 4 over
// `buf`, the superblock buffer; reads t_near and t_far.
extern "C" int march_coarse(const void* params, int32_t stage,
                            const void* rays_o, const void* rays_d,
                            const void* ray_mask, const void* jitter,
                            const void* mask, const void* buf,
                            int64_t n_lanes, void* t_near, void* t_far,
                            void* flags, void* codes, void* stream) {
  const MarchParams* p = (const MarchParams*)params;
  if (!params_ok(p) || stage < kSuperblocks || stage > kBlocksDense ||
      n_lanes < 1 || rays_o == nullptr || rays_d == nullptr ||
      mask == nullptr || t_near == nullptr || t_far == nullptr ||
      flags == nullptr || codes == nullptr ||
      (stage == kBlocksAfter ? buf == nullptr : ray_mask == nullptr) ||
      (stage != kBlocksAfter && p->stratified && jitter == nullptr) ||
      (stage == kSuperblocks && p->n_superblocks < 1))
    return (int)cudaErrorInvalidValue;
  march_coarse_kernel<<<blocks_for(n_lanes), kThreads, 0,
                        (cudaStream_t)stream>>>(
      *p, stage, (const float*)rays_o, (const float*)rays_d,
      (const uint8_t*)ray_mask, (const float*)jitter, (const uint8_t*)mask,
      (const int64_t*)buf, n_lanes, (float*)t_near, (float*)t_far,
      (uint8_t*)flags, (int64_t*)codes);
  return (int)cudaGetLastError();
}

// lanes of (KB + 1) x 8 over the block buffer; counts: (R,) int64, zero on
// entry
extern "C" int march_samples(const void* params, const void* rays_o,
                             const void* rays_d, const void* binary,
                             const void* t_near, const void* t_far,
                             const void* blk_buf, int64_t n_lanes,
                             void* flags, void* codes, void* counts,
                             void* stream) {
  const MarchParams* p = (const MarchParams*)params;
  if (!params_ok(p) || n_lanes < 1 || rays_o == nullptr ||
      rays_d == nullptr || binary == nullptr || t_near == nullptr ||
      t_far == nullptr || blk_buf == nullptr || flags == nullptr ||
      codes == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  march_samples_kernel<<<blocks_for(n_lanes), kThreads, 0,
                         (cudaStream_t)stream>>>(
      *p, (const float*)rays_o, (const float*)rays_d,
      (const uint8_t*)binary, (const float*)t_near, (const float*)t_far,
      (const int64_t*)blk_buf, n_lanes, (uint8_t*)flags, (int64_t*)codes,
      (unsigned long long*)counts);
  return (int)cudaGetLastError();
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
