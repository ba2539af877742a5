// Volumetric compositing over a ray-contiguous sample buffer for Hopper
// (sm_90a), one kernel per direction. Ray r owns the slots offsets[r] ..
// min(offsets[r] + counts[r], n) - 1; a slot is valid when its ray_idx is
// below n_rays (the buffer's empty slots hold n_rays). Per slot:
//   x      = sigma * dt * valid, sdt = x clamped at 25 (NaN stays NaN),
//   alpha  = 1 - exp(-sdt); with alpha_thre > 0, a slot whose alpha is
//            below it gets sdt = alpha = 0,
//   od     = the exclusive optical depth: the ray's earlier sdt summed in
//            float64, rounded to the working type,
//   T      = exp(-od), live = T > early_stop_eps,
//   w      = T * alpha * live * valid;
//   forward   colours (R, ch), opacities and depths (R,) as float64 sums
//             over the ray of w * rgb, w and w * t_mid, rounded; the live
//             valid slots of each ray (R,) int64; optionally T a slot for
//             the backward and the live flag a slot (the occlusion
//             prepass's density-only call passes no rgb);
//   backward  the cotangents of sigma (n,) and rgb (n, ch) from those of
//             the colours, opacities and depths, with g = gC . rgb + gO +
//             gD t_mid a slot and the optical depth's transpose a float64
//             suffix sum over the ray:
//             dsdt_k = keep_k (g_k T_k e_k live_k valid_k
//                              - sum_{i > k} w_i g_i),  e_k = exp(-sdt_k),
//             dsigma_k = dsdt_k [x_k <= 25] valid_k dt_k,
//             drgb_k = w_k gC.
//
// Replaces the JAX package's `composite` (deblur_e_nerf_tpu/models/
// renderer.py:613), with `_sigma_dt_alpha` (:503) and the precise optical
// depth `excl_segment_cumsum_precise` (:456): XLA code over the whole
// buffer (global cumsums, gathers of segment bases, three segment sums).
// nerfacc's `render_weight_from_density` and `accumulate_along_rays` are
// the reference implementation's CUDA kernels for the same thing.
// ops/composite.py `composite_reference` is the plain version: a float64
// global cumsum less each ray's base for the optical depth, float64
// cumsum differences for the sums, both rounded as here; the kernels'
// float64 running sums along a ray differ from those only in float64
// rounding, so their float32 results agree to an ulp or so.
//
// Bound: device-memory bytes. Forward: sigma, dt, t_mid (4 bytes each),
// ray_idx (8) and rgb (4 ch) a slot read once, 32 bytes a slot for ch =
// 3, and T written (4) when a gradient is wanted; per ray, two offsets in
// and ch + 3 values out. Backward: those inputs and T (36 bytes a slot)
// read, the two cotangents (16) written: 52 bytes a slot. A slot costs
// about 30 float operations and two exponentials each way, far below the
// card's rate for those bytes.
//
// The design: one warp a ray, 32 consecutive slots at a time, so every
// load is a coalesced run of the buffer. The optical depth is a float64
// inclusive warp scan (__shfl_up_sync) of each chunk plus the carry of
// the chunks before; the per-ray sums are float64 lane partials combined
// by a fixed xor butterfly at the end: no atomics, no order that depends
// on timing, so two runs give the same bits. The backward walks the ray's
// chunks last to first with a float64 suffix scan (__shfl_down_sync) and
// reads the forward's T instead of repeating the forward scan. Slots that
// belong to no ray (the buffer's empty tail) get zero cotangents and a
// false live flag. A warp idles on lanes past a short ray's end: rays of
// the flagship step carry tens to hundreds of samples, and a ray without
// samples (most of a training batch's R, which is sized for the largest
// batch) costs a warp two loads and its zero outputs. The types: float
// (the training and eval path) or double (the float64 check of the
// occlusion prepass); t_mid and dt are float32 in both. Every array is
// contiguous.
//
// The entry points launch on the given stream, allocate nothing, and
// return the CUDA error of the launch (cudaErrorInvalidValue for an
// argument the kernels do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
  const void* sigma;  // (n,) T
  const void* rgb;    // (n, channels) T; null: the density-only call
  int channels;
  const float* t_mid;
  const float* dt;
  const int64_t* ray_idx;
  const int64_t* offsets;
  const int64_t* counts;
  int64_t n;
  int64_t n_rays;
  double early_stop_eps;
  double alpha_thre;
};

__device__ __forceinline__ float exp_neg(float x) { return expf(-x); }
__device__ __forceinline__ double exp_neg(double x) { return exp(-x); }

// The per-slot terms of sigma * dt, as the plain version computes them.
template <typename T>
struct Slot {
  T sdt;      // clamped, then masked by keep: what the optical depth sums
  T alpha;    // masked by keep
  T e;        // exp(-sdt) before the keep mask
  bool valid;
  bool clamp_passes;  // x <= 25: torch.clamp's gradient mask
  bool keep;
};

template <typename T>
__device__ __forceinline__ Slot<T> slot_terms(const Inputs& in, int64_t j) {
  Slot<T> s;
  s.valid = __ldg((const long long*)in.ray_idx + j) < in.n_rays;
  const T sigma = __ldg(static_cast<const T*>(in.sigma) + j);
  const T dt = (T)__ldg(in.dt + j);
  const T x = sigma * dt * (s.valid ? T(1) : T(0));
  s.clamp_passes = x <= T(25);
  const T sdt = x > T(25) ? T(25) : x;
  s.e = exp_neg(sdt);
  const T alpha = T(1) - s.e;
  s.keep = true;
  if (in.alpha_thre > 0.0) {
    s.keep = alpha >= (T)in.alpha_thre;
    const T k = s.keep ? T(1) : T(0);
    s.sdt = sdt * k;
    s.alpha = alpha * k;
  } else {
    s.sdt = sdt;
    s.alpha = alpha;
  }
  return s;
}

__device__ __forceinline__ void ray_bounds(const Inputs& in, int64_t r,
                                           int64_t* begin, int64_t* end) {
  int64_t b = __ldg((const long long*)in.offsets + r);
  int64_t e = b + __ldg((const long long*)in.counts + r);
  if (e > in.n) e = in.n;
  if (b > e) b = e;
  *begin = b;
  *end = e;
}

// The first slot after the last ray's segment: the empty tail starts there.
__device__ __forceinline__ int64_t tail_start(const Inputs& in) {
  int64_t b, e;
  ray_bounds(in, in.n_rays - 1, &b, &e);
  return e;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    composite_fwd_kernel(const Inputs in, T* __restrict__ colors,
                         T* __restrict__ opacities, T* __restrict__ depths,
                         int64_t* __restrict__ live_counts,
                         T* __restrict__ trans, uint8_t* __restrict__ live) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * kThreads) >> 5;
  const T eps = (T)in.early_stop_eps;
  const bool shade = in.rgb != nullptr;
  for (int64_t r = warp0; r < in.n_rays; r += n_warps) {
    int64_t b, e;
    ray_bounds(in, r, &b, &e);
    if (b == e) {  // a ray without samples (most of a training batch's)
      if (lane == 0) {
        live_counts[r] = 0;
        if (shade) {
          for (int c = 0; c < in.channels; ++c)
            colors[r * in.channels + c] = T(0);
          opacities[r] = T(0);
          depths[r] = T(0);
        }
      }
      continue;
    }
    double carry = 0.0;
    double acc[kMaxChannels] = {0.0, 0.0, 0.0, 0.0};
    double acc_o = 0.0, acc_d = 0.0;
    int n_live = 0;
    for (int64_t base = b; base < e; base += 32) {
      const int64_t j = base + lane;
      const bool inside = j < e;
      Slot<T> s{};
      if (inside) s = slot_terms<T>(in, j);
      double incl = inside ? (double)s.sdt : 0.0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      double excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.0;
      if (inside) {
        const T od = (T)(carry + excl);
        const T tr = exp_neg(od);
        const bool lv = tr > eps;
        const bool counted = lv && s.valid;
        n_live += counted ? 1 : 0;
        if (trans != nullptr) trans[j] = tr;
        if (live != nullptr) live[j] = counted ? 1 : 0;
        if (shade) {
          const T w = tr * s.alpha * (lv ? T(1) : T(0))
                      * (s.valid ? T(1) : T(0));
          const T* row = static_cast<const T*>(in.rgb) + j * in.channels;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < in.channels) acc[c] += (double)(w * __ldg(row + c));
          acc_o += (double)w;
          acc_d += (double)(w * (T)__ldg(in.t_mid + j));
        }
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    const int total_live = __reduce_add_sync(kFull, n_live);
    if (shade) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < in.channels) acc[c] = warp_sum(acc[c]);
      acc_o = warp_sum(acc_o);
      acc_d = warp_sum(acc_d);
    }
    if (lane == 0) {
      live_counts[r] = total_live;
      if (shade) {
        for (int c = 0; c < in.channels; ++c)
          colors[r * in.channels + c] = (T)acc[c];
        opacities[r] = (T)acc_o;
        depths[r] = (T)acc_d;
      }
    }
  }
  if (live != nullptr) {
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t j = tail_start(in) + (int64_t)blockIdx.x * kThreads
                     + threadIdx.x;
         j < in.n; j += stride)
      live[j] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    composite_bwd_kernel(const Inputs in, const T* __restrict__ trans,
                         const T* __restrict__ g_colors,
                         const T* __restrict__ g_opacities,
                         const T* __restrict__ g_depths,
                         T* __restrict__ g_sigma, T* __restrict__ g_rgb) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * kThreads) >> 5;
  const T eps = (T)in.early_stop_eps;
  const int ch = in.channels;
  for (int64_t r = warp0; r < in.n_rays; r += n_warps) {
    int64_t b, e;
    ray_bounds(in, r, &b, &e);
    if (b == e) continue;
    T gc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      gc[c] = c < ch ? __ldg(g_colors + r * ch + c) : T(0);
    const T go = __ldg(g_opacities + r);
    const T gd = __ldg(g_depths + r);
    double carry = 0.0;  // sum of the later chunks' optical-depth cotangents
    const int64_t n_chunks = (e - b + 31) / 32;
    for (int64_t k = n_chunks - 1; k >= 0; --k) {
      const int64_t j = b + k * 32 + lane;
      const bool inside = j < e;
      Slot<T> s{};
      T tr = T(0), g = T(0), w = T(0), g_od = T(0), g_alpha = T(0);
      T rgb[kMaxChannels];
      if (inside) {
        s = slot_terms<T>(in, j);
        tr = __ldg(trans + j);
        const T* row = static_cast<const T*>(in.rgb) + j * in.channels;
        T dot = T(0);
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          rgb[c] = c < ch ? __ldg(row + c) : T(0);
          dot += gc[c] * rgb[c];
        }
        // an empty slot's ray gets no cotangent (the plain version's
        // segment sums route it to a dropped segment)
        g = s.valid ? dot + go + gd * (T)__ldg(in.t_mid + j) : T(0);
        const T lv = tr > eps ? T(1) : T(0);
        const T vf = s.valid ? T(1) : T(0);
        w = tr * s.alpha * lv * vf;
        const T ga3 = g * vf * lv;     // the cotangent of T * alpha
        g_od = -(ga3 * s.alpha * tr);  // through T = exp(-od)
        g_alpha = ga3 * tr;            // into alpha (kept)
      }
      double incl = inside ? (double)g_od : 0.0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double y = __shfl_down_sync(kFull, incl, d);
        if (lane + d < 32) incl += y;
      }
      double excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = 0.0;
      if (inside) {
        const T suffix = (T)(carry + excl);
        const T kf = s.keep ? T(1) : T(0);
        // sdt reaches the loss through the optical depth and through
        // alpha = 1 - exp(-sdt), each behind the keep mask
        const T g_sdt = in.alpha_thre > 0.0
                            ? suffix * kf + (g_alpha * kf) * s.e
                            : suffix + g_alpha * s.e;
        const T g_x = s.clamp_passes ? g_sdt : T(0);
        g_sigma[j] = g_x * (s.valid ? T(1) : T(0)) * (T)__ldg(in.dt + j);
        T* out = g_rgb + j * ch;
        for (int c = 0; c < ch; ++c)
          out[c] = w * (s.valid ? gc[c] : T(0));
      }
      carry += __shfl_sync(kFull, incl, 0);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = tail_start(in) + (int64_t)blockIdx.x * kThreads
                   + threadIdx.x;
       j < in.n; j += stride) {
    g_sigma[j] = T(0);
    for (int c = 0; c < ch; ++c) g_rgb[j * ch + c] = T(0);
  }
}

template <auto K>
int grid_for(int64_t n_rays, int64_t n) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads, 0);
    cached[dev] = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  // a warp a ray, and enough threads for the empty tail's grid-stride loop
  int64_t blocks = (n_rays + kWarps - 1) / kWarps;
  const int64_t tail = (n + kThreads - 1) / kThreads;
  if (blocks < tail) blocks = tail;
  if (blocks > cached[dev]) blocks = cached[dev];
  return blocks < 1 ? 1 : (int)blocks;
}

bool valid_inputs(const Inputs& in, bool need_rgb) {
  return in.sigma != nullptr && in.dt != nullptr && in.ray_idx != nullptr &&
         in.offsets != nullptr && in.counts != nullptr && in.n >= 1 &&
         in.n_rays >= 1 &&
         (!need_rgb || (in.rgb != nullptr && in.t_mid != nullptr &&
                        in.channels >= 1 && in.channels <= kMaxChannels));
}

Inputs make_inputs(const void* sigma, const void* rgb, int32_t channels,
                   const void* t_mid, const void* dt, const void* ray_idx,
                   const void* offsets, const void* counts, int64_t n,
                   int64_t n_rays, double early_stop_eps, double alpha_thre) {
  Inputs in;
  in.sigma = sigma;
  in.rgb = rgb;
  in.channels = rgb != nullptr ? channels : 0;
  in.t_mid = (const float*)t_mid;
  in.dt = (const float*)dt;
  in.ray_idx = (const int64_t*)ray_idx;
  in.offsets = (const int64_t*)offsets;
  in.counts = (const int64_t*)counts;
  in.n = n;
  in.n_rays = n_rays;
  in.early_stop_eps = early_stop_eps;
  in.alpha_thre = alpha_thre;
  return in;
}

template <typename T>
int forward(const Inputs& in, void* colors, void* opacities, void* depths,
            void* live_counts, void* trans, void* live, cudaStream_t s) {
  const int blocks = grid_for<composite_fwd_kernel<T>>(in.n_rays, in.n);
  composite_fwd_kernel<T><<<blocks, kThreads, 0, s>>>(
      in, (T*)colors, (T*)opacities, (T*)depths, (int64_t*)live_counts,
      (T*)trans, (uint8_t*)live);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const Inputs& in, const void* trans, const void* g_colors,
             const void* g_opacities, const void* g_depths, void* g_sigma,
             void* g_rgb, cudaStream_t s) {
  const int blocks = grid_for<composite_bwd_kernel<T>>(in.n_rays, in.n);
  composite_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
      in, (const T*)trans, (const T*)g_colors, (const T*)g_opacities,
      (const T*)g_depths, (T*)g_sigma, (T*)g_rgb);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward. double_precision: sigma, rgb and the outputs are float64
// (else float32). rgb null: the density-only call (no colours, opacities
// or depths; t_mid may be null). trans (n,) and live (n,) bytes are
// optional outputs.
extern "C" int composite_fwd(int32_t double_precision, const void* sigma,
                             const void* rgb, int32_t channels,
                             const void* t_mid, const void* dt,
                             const void* ray_idx, const void* offsets,
                             const void* counts, int64_t n, int64_t n_rays,
                             double early_stop_eps, double alpha_thre,
                             void* colors, void* opacities, void* depths,
                             void* live_counts, void* trans, void* live,
                             void* stream) {
  const Inputs in = make_inputs(sigma, rgb, channels, t_mid, dt, ray_idx,
                                offsets, counts, n, n_rays, early_stop_eps,
                                alpha_thre);
  if (!valid_inputs(in, false) || live_counts == nullptr ||
      (rgb != nullptr &&
       (!valid_inputs(in, true) || colors == nullptr ||
        opacities == nullptr || depths == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return double_precision
             ? forward<double>(in, colors, opacities, depths, live_counts,
                               trans, live, s)
             : forward<float>(in, colors, opacities, depths, live_counts,
                              trans, live, s);
}

// The backward: the forward's inputs and its trans, the cotangents of the
// colours (n_rays, channels), opacities and depths (n_rays,), contiguous;
// writes g_sigma (n,) and g_rgb (n, channels), contiguous.
extern "C" int composite_bwd(int32_t double_precision, const void* sigma,
                             const void* rgb, int32_t channels,
                             const void* t_mid, const void* dt,
                             const void* ray_idx, const void* offsets,
                             const void* counts, int64_t n, int64_t n_rays,
                             double early_stop_eps, double alpha_thre,
                             const void* trans, const void* g_colors,
                             const void* g_opacities, const void* g_depths,
                             void* g_sigma, void* g_rgb, void* stream) {
  const Inputs in = make_inputs(sigma, rgb, channels, t_mid, dt, ray_idx,
                                offsets, counts, n, n_rays, early_stop_eps,
                                alpha_thre);
  if (!valid_inputs(in, true) || trans == nullptr || g_colors == nullptr ||
      g_opacities == nullptr || g_depths == nullptr || g_sigma == nullptr ||
      g_rgb == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return double_precision
             ? backward<double>(in, trans, g_colors, g_opacities, g_depths,
                                g_sigma, g_rgb, s)
             : backward<float>(in, trans, g_colors, g_opacities, g_depths,
                               g_sigma, g_rgb, s);
}
