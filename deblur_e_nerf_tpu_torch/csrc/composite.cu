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
// The forward. What held its first design, one warp a ray, at 36% of its
// bound on the flagship step (H100 80GB HBM3, 700 W): the batch has 983,040
// ray slots of which about 51,480 hold samples, so most warps ran one
// iteration in which lane 0 alone wrote five scattered scalars; and a ray
// with samples walked its ~300 slots as a serial chain of 32-slot chunks,
// each paying a five-step float64 shuffle scan and a carry broadcast. The
// design now gives the work to warps by slots:
//  - A warp takes a span of 2048 consecutive slots and owns the rays that
//    start in it: it composites from the span's first ray start to the
//    first ray start at or past the span's end (or the segments' end),
//    so a ray that crosses into the next spans is finished by its owner,
//    and the slots before the span's first ray start are its
//    predecessor's. A slot starts a ray when it holds a sample and is its
//    ray's first (its ray's offset, read through L1, is the slot).
//  - It steps through them 128 at a time, 4 consecutive slots a lane,
//    each array loaded as 16-byte vectors (sigma, dt, t_mid, ray_idx, the
//    rgb rows). The optical depth is a float64 segmented scan with head
//    flags at ray starts: a lane's slots in order, then a segmented scan
//    over the warp's lanes (five shuffle steps), the open ray's value
//    carried from one step to the next. The per-ray sums (colours,
//    opacity, depth, live count) are float64 sums by piece: a ray whose
//    slots start and end in one lane is written by it; the pieces that
//    cross lanes and steps take a second segmented scan and carry, and
//    the lane holding a ray's last slot writes it. One warp, a fixed
//    order, no atomics: two runs give the same bits, a ray longer than a
//    span included (its owner carries it step by step).
//  - The rays without samples: each warp also takes a fixed share of the
//    rays and writes the zeros of those without samples as coalesced
//    per-ray stores. A ray has none when its segment is empty or its first
//    slot holds no sample of it: the march's counts are demands, so a ray
//    may start at the buffer's last slot, which is always empty. Warp 0
//    also owns any slots before the first ray start (slot 0 of a budget of
//    0), so every slot gets its T and live flag.
//  - No warp waits on another: there is no look-back and no scratch.
//    (Blocks of 2048 slots that carried a crossing ray's optical depth and
//    sums through decoupled look-backs were slower on the H100: each
//    block's chain of dependent steps, not its bytes, set the pace.)
//  - Rounding as the plain version: the float64 running sums rounded to
//    the working type, exp of that optical depth, the clamp at 25 with
//    NaN kept, each weight and product in the working type before its
//    float64 sum.
// A call is one launch. The backward keeps the first design (one warp a
// ray, at 51% of its bound on the H100): it walks the ray's chunks last
// to first with a float64 suffix scan (__shfl_down_sync) and reads the
// forward's T instead of repeating the forward scan; slots that belong to
// no ray (the buffer's empty tail) get zero cotangents. The types: float
// (the training and eval path) or double (the float64 check of the
// occlusion prepass); t_mid and dt are float32 in both. Every array is
// contiguous; ray segments tile the buffer's first slots in ray order
// (offsets the exclusive sum of the counts, as the march writes them),
// and a sample's slot holds its ray's id.
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
  bool aligned;  // the forward's slot arrays 16-byte aligned (live 8)
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
__device__ __forceinline__ Slot<T> slot_terms_of(const Inputs& in, T sigma,
                                                 float dt_in,
                                                 long long ray) {
  Slot<T> s;
  s.valid = ray < in.n_rays;
  const T dt = (T)dt_in;
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

template <typename T>
__device__ __forceinline__ Slot<T> slot_terms(const Inputs& in, int64_t j) {
  return slot_terms_of<T>(in, __ldg(static_cast<const T*>(in.sigma) + j),
                          __ldg(in.dt + j),
                          __ldg((const long long*)in.ray_idx + j));
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

// ---------------------------------------------------------------------------
// The forward: a warp a span of slots, each ray composited by the warp
// whose span holds its first slot.

constexpr int kSlots = 4;                  // consecutive slots a lane
constexpr int kChunk = 32 * kSlots;        // slots a warp step
constexpr int kSpan = 16 * kChunk;         // slots a warp's span

template <typename T>
struct Outputs {
  T* colors;
  T* opacities;
  T* depths;
  int64_t* live_counts;
  T* trans;      // or null
  uint8_t* live; // or null
};

__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, double* v) {
  v[0] = __hiloint2double((int)u.y, (int)u.x);
  v[1] = __hiloint2double((int)u.w, (int)u.z);
}
__device__ __forceinline__ void unpack(const uint4& u, long long* v) {
  v[0] = (long long)(((unsigned long long)u.y << 32) | u.x);
  v[1] = (long long)(((unsigned long long)u.w << 32) | u.z);
}

// N consecutive elements from p, 16-byte aligned, as 16-byte loads
template <typename E, int N>
__device__ __forceinline__ void load_vector(const E* p, E (&v)[N]) {
  constexpr int kPer = 16 / sizeof(E);
#pragma unroll
  for (int q = 0; q < N / kPer; ++q)
    unpack(__ldg(reinterpret_cast<const uint4*>(p) + q), v + q * kPer);
}

// N consecutive elements from p, those at or past `inside` as `none`
template <typename E, int N>
__device__ __forceinline__ void load_scalar(const E* p, int inside, E none,
                                            E (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < inside ? __ldg(p + i) : none;
}

// A lane's kSlots slots: sigma, dt, ray_idx, and t_mid and the rgb rows
// when shading; 16-byte loads when whole and aligned
template <typename T, int CH>
struct Slots {
  T sigma[kSlots];
  float dt[kSlots];
  long long ray[kSlots];
  float t_mid[kSlots];
  T rgb[CH > 0 ? kSlots * CH : 4];
  __device__ __forceinline__ void load(const Inputs& in, int64_t j,
                                       int inside) {
    const T* sg = static_cast<const T*>(in.sigma) + j;
    const long long* ry = (const long long*)in.ray_idx + j;
    const bool vec = in.aligned && inside == kSlots;
    if (vec) {
      load_vector(sg, sigma);
      load_vector(in.dt + j, dt);
      load_vector(ry, ray);
    } else {
      load_scalar(sg, inside, T(0), sigma);
      load_scalar(in.dt + j, inside, 0.f, dt);
      load_scalar(ry, inside, (long long)in.n_rays, ray);
    }
    if constexpr (CH > 0) {
      const T* rows = static_cast<const T*>(in.rgb) + j * CH;
      if (vec) {
        load_vector(in.t_mid + j, t_mid);
        load_vector(rows, rgb);
      } else {
        load_scalar(in.t_mid + j, inside, 0.f, t_mid);
        load_scalar(rows, inside * CH, T(0), rgb);
      }
    }
  }
};

// A segmented sum over a range of slots: whether a ray starts in it, the
// NV sums since the last ray start in it (or since its start), and the
// ray that starts last in it (-1: none).
template <int NV>
struct Seg {
  int f;
  double v[NV];
  int r;
};

template <int NV>
__device__ __forceinline__ Seg<NV> seg_identity() {
  Seg<NV> s;
  s.f = 0;
#pragma unroll
  for (int q = 0; q < NV; ++q) s.v[q] = 0.0;
  s.r = -1;
  return s;
}

// later := earlier followed by later
template <int NV>
__device__ __forceinline__ void seg_after(Seg<NV>& later,
                                          const Seg<NV>& earlier) {
  if (!later.f) {
#pragma unroll
    for (int q = 0; q < NV; ++q) later.v[q] = earlier.v[q] + later.v[q];
  }
  later.f = later.f | earlier.f;
  later.r = later.f && later.r >= 0 ? later.r : (later.r > earlier.r
                                                     ? later.r
                                                     : earlier.r);
}

template <int NV>
__device__ __forceinline__ Seg<NV> seg_shfl(const Seg<NV>& s, int src) {
  Seg<NV> y;
  y.f = __shfl_sync(kFull, s.f, src);
#pragma unroll
  for (int q = 0; q < NV; ++q) y.v[q] = __shfl_sync(kFull, s.v[q], src);
  y.r = __shfl_sync(kFull, s.r, src);
  return y;
}

template <int NV>
__device__ __forceinline__ Seg<NV> seg_shfl_up(const Seg<NV>& s, int d) {
  Seg<NV> y;
  y.f = __shfl_up_sync(kFull, s.f, d);
#pragma unroll
  for (int q = 0; q < NV; ++q) y.v[q] = __shfl_up_sync(kFull, s.v[q], d);
  y.r = __shfl_up_sync(kFull, s.r, d);
  return y;
}

// x := carry followed by the lanes before this one (their segmented sum
// in lane order), total := carry followed by every lane; shuffle steps in
// a fixed order, so two runs give the same bits.
template <int NV>
__device__ __forceinline__ void warp_seg_scan(Seg<NV>& x, Seg<NV>& total,
                                              const Seg<NV>& carry) {
  const int lane = threadIdx.x & 31;
  Seg<NV> incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<NV> y = seg_shfl_up(incl, d);
    if (lane >= d) seg_after(incl, y);
  }
  Seg<NV> ex = seg_shfl_up(incl, 1);
  total = seg_shfl(incl, 31);
  seg_after(total, carry);
  if (lane == 0) {
    ex = carry;
  } else {
    seg_after(ex, carry);
  }
  x = ex;
}

// a ray's outputs from its float64 sums (colours, opacity, depth, live)
template <typename T, int CH>
__device__ __forceinline__ void write_ray(const Outputs<T>& out, int64_t r,
                                          const double* acc) {
  constexpr int kLive = CH > 0 ? CH + 2 : 0;
  out.live_counts[r] = (int64_t)acc[kLive];
  if constexpr (CH > 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) out.colors[r * CH + c] = (T)acc[c];
    out.opacities[r] = (T)acc[CH];
    out.depths[r] = (T)acc[CH + 1];
  }
}

// T, the live flag and the weighted sums of one slot whose exclusive
// optical depth is `run` (float64, advanced by its sdt); its sums go to acc
template <typename T, int CH>
__device__ __forceinline__ void shade_slot(const Inputs& in,
                                           const Slots<T, CH>& sl, int i,
                                           const Slot<T>& s, double& run,
                                           double* acc, T& tr_out,
                                           uint8_t& live_out) {
  constexpr int kLive = CH > 0 ? CH + 2 : 0;
  const T tr = exp_neg((T)run);
  run += (double)s.sdt;
  const bool lv = tr > (T)in.early_stop_eps;
  const bool counted = lv && s.valid;
  tr_out = tr;
  live_out = counted ? 1 : 0;
  acc[kLive] += counted ? 1.0 : 0.0;
  if constexpr (CH > 0) {
    const T w = tr * s.alpha * (lv ? T(1) : T(0)) * (s.valid ? T(1) : T(0));
#pragma unroll
    for (int c = 0; c < CH; ++c)
      acc[c] += (double)(w * sl.rgb[i * CH + c]);
    acc[CH] += (double)w;
    acc[CH + 1] += (double)(w * (T)sl.t_mid[i]);
  }
}

// A warp takes the span of kSpan slots w kSpan .. (w + 1) kSpan - 1 and
// owns the rays that start in it: from its first ray start (warp 0: from
// slot 0) to the first ray start at or past its end (or the segments'
// end), kChunk slots a step, the open ray's optical depth and sums carried
// from step to step. It also writes the zeros of its share of the rays
// without samples and the empty tail's live flags in its span. Each ray is
// written once: by the lane holding its last slot when its first slot is
// a ray start, else (no sample of the ray in the buffer) as a ray without
// samples.
// (3 blocks an SM for the float shading instances, 4 for the
// density-only one: their registers held the first cut at 2 and 3, and
// the warps an SM, not the bytes a warp, set the pace)
template <typename T, int CH>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 ? (CH > 0 ? 3 : 4) : 1)
    composite_fwd_kernel(const Inputs in, const Outputs<T> out,
                         int64_t n_warps) {
  constexpr int NS = CH > 0 ? CH + 3 : 1;  // sums a ray
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (w >= n_warps) return;
  // ray segments tile slots 0 .. seg_end - 1; the warp's span s0 .. s1 - 1
  const int64_t seg_end = tail_start(in);
  const int64_t s0 = w * kSpan, s1 = s0 + kSpan;

  // the rays without samples in this warp's share of the rays: an empty
  // segment, or one whose first slot holds no sample of the ray (a ray
  // whose demand starts at the buffer's last slot, which is always empty)
  for (int64_t r = in.n_rays * w / n_warps + lane,
               r1 = in.n_rays * (w + 1) / n_warps;
       r < r1; r += 32) {
    int64_t b, e;
    ray_bounds(in, r, &b, &e);
    if (b == e || __ldg((const long long*)in.ray_idx + b) != r) {
      out.live_counts[r] = 0;
      if constexpr (CH > 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) out.colors[r * CH + c] = T(0);
        out.opacities[r] = T(0);
        out.depths[r] = T(0);
      }
    }
  }
  if (out.live != nullptr) {  // the empty tail's live flags
    const int64_t lo = s0 > seg_end ? s0 : seg_end;
    const int64_t hi = s1 < in.n ? s1 : in.n;
    for (int64_t j = lo + lane; j < hi; j += 32) out.live[j] = 0;
  }

  // the carried open ray: its optical depth and sums since its first
  // slot, and its id (-1: none yet). Warp 0 owns the slots before the
  // first ray start too (an empty slot 0: a budget of 0), as a piece of
  // no ray, so that every slot gets its T and live flag.
  Seg<1> c_od = seg_identity<1>();
  Seg<NS> c_sum = seg_identity<NS>();
  bool started = w == 0;
  for (int64_t x = s0; x < seg_end; x += kChunk) {
    const int64_t j0 = x + lane * kSlots;
    const int64_t left = seg_end - j0;
    const int inside = left <= 0 ? 0 : (left < kSlots ? (int)left : kSlots);
    Slots<T, CH> sl;
    sl.load(in, j0, inside);
    // ray starts: a sample's slot that is its ray's first
    unsigned heads = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i < inside && sl.ray[i] < in.n_rays &&
          __ldg((const long long*)in.offsets + sl.ray[i]) == j0 + i)
        heads |= 1u << i;
    }
    // the owned slots of this step, chunk positions begin .. end - 1: from
    // the span's first ray start, to the first ray start at or past s1 or
    // the segments' end
    int first_start = kChunk, first_past = kChunk;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if ((heads >> i) & 1u) {
        const int k = lane * kSlots + i;
        if (x + k < s1) {
          first_start = first_start < k ? first_start : k;
        } else {
          first_past = first_past < k ? first_past : k;
        }
      }
    }
    first_start = __reduce_min_sync(kFull, first_start);
    first_past = __reduce_min_sync(kFull, first_past);
    const int begin = started ? 0 : first_start;
    if (!started && begin == kChunk) {
      if (x + kChunk >= s1) break;  // no ray starts in the span
      continue;
    }
    const int seg_left = seg_end - x < kChunk ? (int)(seg_end - x) : kChunk;
    const int end = first_past < seg_left ? first_past : seg_left;
    const bool stop_here = end < kChunk || x + kChunk >= seg_end;
    if (started && c_od.r >= 0 &&
        (end == 0 || __shfl_sync(kFull, heads & 1u, 0) != 0)) {
      // the carried ray ended with the last step
      if (lane == 0) write_ray<T, CH>(out, c_od.r, c_sum.v);
      c_od = seg_identity<1>();
      c_sum = seg_identity<NS>();
    }
    if (end == 0) break;
    started = true;
    // this lane's owned slots: lo .. hi - 1 of its kSlots
    const int k0 = lane * kSlots;
    const int lo = begin - k0 < 0 ? 0 : (begin - k0 < kSlots ? begin - k0
                                                               : kSlots);
    const int hi = end - k0 < 0 ? 0 : (end - k0 < kSlots ? end - k0 : kSlots);

    // pass 1: the lane's optical depth since its last ray start
    Slot<T> st[kSlots];
    Seg<1> od = seg_identity<1>();
    int first_head = kSlots;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      st[i] = slot_terms_of<T>(in, sl.sigma[i], sl.dt[i], sl.ray[i]);
      if (i >= lo && i < hi) {
        if ((heads >> i) & 1u) {
          od.v[0] = 0.0;
          od.f = 1;
          od.r = (int)sl.ray[i];
          if (first_head == kSlots) first_head = i;
        }
        od.v[0] += (double)st[i].sdt;
      }
    }
    Seg<1> od_total;
    warp_seg_scan(od, od_total, c_od);

    // pass 2: T, the live flags and the sums by piece; a piece that
    // starts and ends in this lane is a whole ray, written now
    double run = od.v[0];
    double acc[NS], first_acc[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) acc[q] = first_acc[q] = 0.0;
    bool first_piece = true, first_final = false;
    int piece_ray = -1;
    T tr[kSlots];
    uint8_t live[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      tr[i] = T(0);
      live[i] = 0;
      if (i >= lo && i < hi) {
        if ((heads >> i) & 1u) {
          if (i > lo) {
            if (first_piece) {
#pragma unroll
              for (int q = 0; q < NS; ++q) first_acc[q] = acc[q];
              first_final = true;
            } else {
              write_ray<T, CH>(out, piece_ray, acc);
            }
          }
#pragma unroll
          for (int q = 0; q < NS; ++q) acc[q] = 0.0;
          first_piece = false;
          piece_ray = (int)sl.ray[i];
          run = 0.0;
        }
        shade_slot<T, CH>(in, sl, i, st[i], run, acc, tr[i], live[i]);
      }
    }
    // T and the live flags of the owned slots
    if (lo == 0 && hi == kSlots && in.aligned) {
      if (out.trans != nullptr) {
        constexpr int kPer = 16 / sizeof(T);
#pragma unroll
        for (int q = 0; q < kSlots / kPer; ++q) {
          union {
            uint4 u;
            T e[kPer];
          } v;
#pragma unroll
          for (int i = 0; i < kPer; ++i) v.e[i] = tr[q * kPer + i];
          reinterpret_cast<uint4*>(out.trans + j0)[q] = v.u;
        }
      }
      if (out.live != nullptr) {
        union {
          unsigned u;
          uint8_t b[kSlots];
        } v;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) v.b[i] = live[i];
        *reinterpret_cast<unsigned*>(out.live + j0) = v.u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i >= lo && i < hi) {
          if (out.trans != nullptr) out.trans[j0 + i] = tr[i];
          if (out.live != nullptr) out.live[j0 + i] = live[i];
        }
      }
    }
    // the lane's last piece ends its ray where the next slot starts one or
    // the owned slots end
    const bool next_head = __shfl_down_sync(kFull, heads & 1u, 1) != 0;
    Seg<NS> sums = seg_identity<NS>();
    if (hi > lo) {
      const bool next_is_head = hi < kSlots ? ((heads >> hi) & 1u) != 0
                                            : lane < 31 && next_head;
      const bool last_final = next_is_head || (k0 + hi == end && stop_here);
      if (last_final) {
        if (first_piece) {
#pragma unroll
          for (int q = 0; q < NS; ++q) first_acc[q] = acc[q];
          first_final = true;
        } else {
          write_ray<T, CH>(out, piece_ray, acc);
        }
      }
      sums.f = first_head < kSlots;
      sums.r = piece_ray;
#pragma unroll
      for (int q = 0; q < NS; ++q) sums.v[q] = acc[q];
    }
    // the pieces that continue across lanes and steps
    Seg<NS> sums_total;
    Seg<NS> carried = c_sum;
    carried.r = c_od.r;
    warp_seg_scan(sums, sums_total, carried);
    if (first_final && od.r >= 0) {
      // the lane's first piece ends a ray begun in an earlier lane or step
      double total[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) total[q] = sums.v[q] + first_acc[q];
      write_ray<T, CH>(out, od.r, total);
    }
    c_od = od_total;
    c_sum = sums_total;
    if (stop_here) break;  // the owned rays ended
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
  in.aligned = false;
  return in;
}

template <typename T, int CH>
int forward_channels(const Inputs& in, const Outputs<T>& out,
                     cudaStream_t s) {
  const int64_t n_warps = (in.n + kSpan - 1) / kSpan;
  const int64_t blocks = (n_warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<T, CH><<<(unsigned)blocks, kThreads, 0, s>>>(
      in, out, n_warps);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(Inputs in, void* colors, void* opacities, void* depths,
            void* live_counts, void* trans, void* live, cudaStream_t s) {
  const Outputs<T> out{(T*)colors, (T*)opacities, (T*)depths,
                       (int64_t*)live_counts, (T*)trans, (uint8_t*)live};
  const uintptr_t vec = (uintptr_t)in.sigma | (uintptr_t)in.dt |
                        (uintptr_t)in.ray_idx | (uintptr_t)in.t_mid |
                        (uintptr_t)in.rgb | (uintptr_t)trans;
  in.aligned = vec % 16 == 0 && (uintptr_t)live % 4 == 0;
  switch (in.channels) {
    case 0: return forward_channels<T, 0>(in, out, s);
    case 1: return forward_channels<T, 1>(in, out, s);
    case 2: return forward_channels<T, 2>(in, out, s);
    case 3: return forward_channels<T, 3>(in, out, s);
    case 4: return forward_channels<T, 4>(in, out, s);
  }
  return (int)cudaErrorInvalidValue;
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
