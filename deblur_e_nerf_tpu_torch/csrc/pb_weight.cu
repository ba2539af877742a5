// The pixel-bandwidth weight chain for Hopper (sm_90a), one kernel per
// direction: for every event column m of an (S, M) window of sampled
// intensities and the (S - 1, M) steps between them,
//   forward   w[i, m, r] = the weight of sample i in output r (S, M, o),
//             a finiteness byte a column, and optionally each system's Ad
//             for the backward (M, S - 1, 16);
//   backward  the cotangents of intensity (S, M), dt (S - 1, M) and the 7
//             packed parameters from that of w.
//
// Neither replaces a Pallas kernel. They replace the JAX package's
// rematerialized `_weight_remat` (deblur_e_nerf_tpu/models/
// pixel_bandwidth.py:282-301), which XLA compiles from plain array code:
//   - `linearized_sys_params` and `linearize_sys` (:106-154): system j is
//     the 4x4 circuit linearized at intensity[j + 1, m];
//   - ops/control.py `foh_cont2discrete`, efficient and state preserving
//     (:67-73): Ad = phi = expm(A dt), z = A^-1 B, g1 = (phi - I) z,
//     g2 = (A dt)^-1 g1 - z, Bd = g1 - g2, Bt = g2;
//   - ops/linalg.py `expm_ml`, `solve_ml`, `matmul_ml` (:39-131): float32
//     Pade-13 with the per-system 1-norm scaling 2^-s (s clipped to 0-32,
//     no gradient) and s squarings; the JAX package's fixed loop of 32
//     masked squarings is, per system, exactly its own s squarings, so no
//     count is read anywhere;
//   - `discretized_sys_to_weight` with x0_dir = [0, 1, 1, 1] (:178-241):
//     the reverse scan carrying c_i = C phi(i, S-1) for each output row.
// ops/pb_weight.py holds the plain model of both kernels
// (`weight_forward_model`, `weight_backward_model`), step by step as here.
//
// The gradient (the backward kernel), per system, from the cotangents of
// (Ad, Bd, Bt) that the scan's reverse gives each lane:
//   - a solve x = M^-1 b reverses as b_bar = M^-T x_bar and M_bar =
//     -b_bar x^T, with M^-T applied through the forward's own factors
//     (its pivots, multipliers and U): U^T t = x_bar, then each column's
//     elimination and swap transposed, last column first. A fresh pivoted
//     elimination of M^T is a different rounding of the same adjoint, and
//     on the stiff circuits it strayed beyond the tests' tolerances from
//     JAX's float32 gradients; the factors' transpose stays within them
//     (ops/linalg.py `solve_transposed`, tests/test_torch_pb_weight.py);
//   - the squarings in reverse, phi_bar_k = phi_bar_{k+1} phi_k^T +
//     phi_k^T phi_bar_{k+1}, from their inputs phi_k (below: shared-memory
//     checkpoints); then the Pade polynomials, the 2^-s scaling, A dt, and
//     the linearization.
// The 7 parameter partials of an event are summed over its systems by a
// fixed butterfly of warp shuffles into one row of an (M, 7) buffer: no
// atomics, so two runs give the same bits.
//
// Bound: operations. A system is about 1.7 kflop of linear algebra plus
// 128 flop a squaring (s is 0-25 on the pixel circuits), and its reverse
// about twice that; the bytes are a few floats a system. No tensor core:
// the card's float32 rate (67 TFLOP/s) is the bound, and no TF32 can
// enter. What the kernels lose time on instead is latency (each lane runs
// a long dependent chain of 4x4 products, each event's scan is serial
// over S) and, in the backward, the state a lane keeps.
//
// The design. One warp an event column, lane j < S - 1 system j (so
// S - 1 <= 32); each lane builds and discretizes its system in registers.
//   - Forward: each lane's (Ad, Bd, Bt) go to its warp's shared memory
//     and the column's Ad to device memory (`systems`) in coalesced
//     16-byte stores (64 bytes a system; saving Bd and Bt too cost the
//     forward more than the backward's FOH to rebuild them); lanes r < o
//     run the serial part of the scan alone, the carries c_i, and then
//     every lane computes one sample's weights from them.
//   - The finiteness byte: 1 where every divisor of the column's systems
//     (u, the parameters' reciprocals, the linearization's denominator,
//     the U diagonals of the three factorizations) and every weight is
//     finite. +, - and * give a finite result only from finite operands,
//     the weights multiply every entry of every (Ad, Bd, Bt) and carry,
//     and every intermediate reaches (Ad, Bd, Bt) by +, -, * or as a
//     dividend; so the byte says that every value the column's reverse
//     reads is finite, and with it that autograd of the plain chain gives
//     that column exactly 0 from a zero cotangent (else 0 * inf = NaN).
//   - Backward: a warp first reads its column's cotangent. If it is
//     exactly 0 everywhere (a vote) and the forward's byte is 1, the warp
//     writes zeros and exits: the padded batch's invalid events cost a
//     read of g and a write. (These zeros are +0 where the full reverse
//     could give -0.) A live column loads its Ad and rebuilds (Bd, Bt) by
//     the FOH, keeping the FOH's factors, z and y for the reverse (no
//     second expm: discretizing the live columns again timed slower a
//     step, PERF.md), runs the scan (carries c_i) and its reverse (cbar_i)
//     at once on 2o lanes, then each lane reverses its system once: the
//     FOH first,
//     then the expm rebuilt with a, a2, a4, a6 in shared memory, its
//     squarings' inputs in kSlots - 1 shared-memory slots a lane
//     (checkpoints every L = ceil(s / 5) squarings, each phi_k rebuilt
//     from its checkpoint in registers: none rebuilt for s <= 5), the
//     Pade polynomials in reverse with a..a6 rebuilt into the same slots,
//     and the linearization in reverse. No per-lane local-memory array is
//     left, and the launch bounds ask for 4 blocks (16 warps) an SM at
//     128 registers.
// float32 throughout; nvcc contracts products and sums into fused
// multiply-adds (the tests state the error this leaves). NaN propagates as
// in the plain chain: a pivot search takes the first NaN as the largest
// magnitude, as torch.argmax and jnp.argmax do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSystems = 32;
constexpr int kFwdWarps = 4;       // columns a forward block
constexpr int kFwdMinBlocks = 4;   // forward blocks an SM (<= 128 registers)
constexpr int kBwdWarps = 4;       // columns a backward block
constexpr int kBwdMinBlocks = 4;   // backward blocks an SM (<= 128 registers)
constexpr int kSlots = 6;          // shared 4x4 slots a backward lane
constexpr int kMaxSquarings = 32;
constexpr int kParams = 7;
constexpr int kSh = 32;            // stride of a lane's matrix in the slots
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNsToS = 1e-9f;
constexpr float kTheta13 = 5.371920351148152f;
__constant__ float kB[14] = {
    64764752532480000.0f, 32382376266240000.0f, 7771770303897600.0f,
    1187353796428800.0f,  129060195264000.0f,   10559470521600.0f,
    670442572800.0f,      33522128640.0f,       1323241920.0f,
    40840800.0f,          960960.0f,            16380.0f,
    182.0f,               1.0f};
__constant__ float kX0[4] = {0.0f, 1.0f, 1.0f, 1.0f};

// ---- 4x4 helpers (row-major, in registers) --------------------------------

__device__ __forceinline__ void mm(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = a[i * 4] * b[k];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc += a[i * 4 + j] * b[j * 4 + k];
      c[i * 4 + k] = acc;
    }
}

// c = a b^T
__device__ __forceinline__ void mm_nt(const float* a, const float* b,
                                      float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = a[i * 4] * b[k * 4];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc += a[i * 4 + j] * b[k * 4 + j];
      c[i * 4 + k] = acc;
    }
}

// c = a^T b
__device__ __forceinline__ void mm_tn(const float* a, const float* b,
                                      float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = a[i] * b[k];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc += a[j * 4 + i] * b[j * 4 + k];
      c[i * 4 + k] = acc;
    }
}

__device__ __forceinline__ void copy16(const float* a, float* c) {
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = a[i];
}

// phi <- phi phi, in registers
__device__ __forceinline__ void square(float* phi) {
  float sq[16];
  mm(phi, phi, sq);
  copy16(sq, phi);
}

// ---- pivoted elimination (ops/linalg.py `solve`) ---------------------------

struct Factors {
  float u[16];  // the eliminated rows; their upper triangle is U
  float f[6];   // multipliers: column 0 rows 1-3, column 1 rows 2-3, 2 row 3
  int piv[3];   // each column's pivot offset (column 3 has no choice)
};

__device__ __forceinline__ int fidx(int col, int row) {
  return (col == 0 ? 0 : col == 1 ? 3 : 5) + row - col - 1;
}

template <int N>
__device__ __forceinline__ void swap_rows(float* t, int col, int piv) {
#pragma unroll
  for (int off = 1; off < 4 - col; ++off) {
    const bool sw = piv == off;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = t[col * N + k], y = t[(col + off) * N + k];
      t[col * N + k] = sw ? y : x;
      t[(col + off) * N + k] = sw ? x : y;
    }
  }
}

__device__ __forceinline__ void factor(const float* a, Factors& F) {
#pragma unroll
  for (int i = 0; i < 16; ++i) F.u[i] = a[i];
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    if (col < 3) {
      // the first maximal magnitude, a NaN counting as the largest
      int piv = 0;
      float best = fabsf(F.u[col * 4 + col]);
#pragma unroll
      for (int r = col + 1; r < 4; ++r) {
        const float mag = fabsf(F.u[r * 4 + col]);
        if (mag > best || (isnan(mag) && !isnan(best))) {
          best = mag;
          piv = r - col;
        }
      }
      F.piv[col] = piv;
      swap_rows<4>(F.u, col, piv);
    }
    const float inv_p = 1.0f / F.u[col * 4 + col];
#pragma unroll
    for (int r = col + 1; r < 4; ++r) {
      const float f = F.u[r * 4 + col] * inv_p;
      F.f[fidx(col, r)] = f;
#pragma unroll
      for (int j = col + 1; j < 4; ++j) F.u[r * 4 + j] -= f * F.u[col * 4 + j];
    }
  }
}

// whether U's diagonal, the divisors of a solve, is finite
__device__ __forceinline__ bool diagonal_finite(const Factors& F) {
  return isfinite(F.u[0]) && isfinite(F.u[5]) && isfinite(F.u[10])
         && isfinite(F.u[15]);
}

// x = a^-1 b for b (4, N) row-major
template <int N>
__device__ __forceinline__ void solve(const Factors& F, const float* b,
                                      float* x) {
  float t[4 * N];
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) t[i] = b[i];
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    if (col < 3) swap_rows<N>(t, col, F.piv[col]);
#pragma unroll
    for (int r = col + 1; r < 4; ++r) {
      const float f = F.f[fidx(col, r)];
#pragma unroll
      for (int k = 0; k < N; ++k) t[r * N + k] -= f * t[col * N + k];
    }
  }
#pragma unroll
  for (int i = 3; i >= 0; --i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = t[i * N + k];
#pragma unroll
      for (int j = i + 1; j < 4; ++j) acc -= F.u[i * 4 + j] * x[j * N + k];
      x[i * N + k] = acc / F.u[i * 4 + i];
    }
}

// x = a^-T b from a's factors: U^T t = b, then each column's elimination
// and swap transposed, last column first
template <int N>
__device__ __forceinline__ void solve_t(const Factors& F, const float* b,
                                        float* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = b[i * N + k];
#pragma unroll
      for (int j = 0; j < i; ++j) acc -= F.u[j * 4 + i] * x[j * N + k];
      x[i * N + k] = acc / F.u[i * 4 + i];
    }
#pragma unroll
  for (int col = 2; col >= 0; --col) {
#pragma unroll
    for (int r = col + 1; r < 4; ++r) {
      const float f = F.f[fidx(col, r)];
#pragma unroll
      for (int k = 0; k < N; ++k) x[col * N + k] -= f * x[r * N + k];
    }
    swap_rows<N>(x, col, F.piv[col]);
  }
}

// ---- one system ------------------------------------------------------------

struct Lin {
  float u, tau_in, tau_mil, a_amp, a_loop, denom, tzw, wn2, sf, df;
};

__device__ __forceinline__ Lin linearize(const float* p, float u) {
  Lin L;
  L.u = u;
  L.tau_in = p[6] / u;
  L.tau_mil = p[0] / u;
  L.a_amp = 1.0f / p[1];
  L.a_loop = 1.0f / p[2];
  L.denom = (L.tau_in + L.tau_mil) * p[3];
  L.tzw = (L.tau_in + p[3] + (L.a_amp + 1.0f) * L.tau_mil) / L.denom;
  L.wn2 = (L.a_loop + 1.0f) / L.denom;
  L.sf = 1.0f / p[4];
  L.df = 1.0f / p[5];
  return L;
}

// whether the linearization's divisors are finite
__device__ __forceinline__ bool divisors_finite(const float* p,
                                                const Lin& L) {
  return isfinite(L.u) && isfinite(p[1]) && isfinite(p[2])
         && isfinite(p[4]) && isfinite(p[5]) && isfinite(L.denom);
}

// A from its four entries (the rest exact constants)
__device__ __forceinline__ void a_matrix(float tzw, float wn2, float sf,
                                         float df, float* A) {
#pragma unroll
  for (int i = 0; i < 16; ++i) A[i] = 0.0f;
  A[0] = -tzw;
  A[1] = -wn2;
  A[4] = 1.0f;
  A[9] = sf;
  A[10] = -sf;
  A[14] = df;
  A[15] = -df;
}

// A dt from A's four entries and dt in seconds
__device__ __forceinline__ void a_dt(float tzw, float wn2, float sf, float df,
                                     float dts, float* adt) {
  float A[16];
  a_matrix(tzw, wn2, sf, df, A);
#pragma unroll
  for (int i = 0; i < 16; ++i) adt[i] = A[i] * dts;
}

// x as a value the compiler cannot see through
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// the per-system squaring count: the 1-norm (largest column sum of
// magnitudes, NaN kept) over theta_13, clipped to 0-32; 0 for NaN
__device__ __forceinline__ int squaring_count(const float* adt) {
  float norm = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cs = ((fabsf(adt[c]) + fabsf(adt[4 + c]))
                      + fabsf(adt[8 + c])) + fabsf(adt[12 + c]);
    if (c == 0 || cs > norm || isnan(cs)) norm = isnan(norm) ? norm : cs;
  }
  if (norm < 1.17549435e-38f) norm = 1.17549435e-38f;
  const float sflt = ceilf(log2f(norm / kTheta13));
  return isnan(sflt) ? 0
                     : (int)fminf(fmaxf(sflt, 0.0f), (float)kMaxSquarings);
}

// P = V - U and Q = V + U of the Pade-13 approximant at a (a2 = a a,
// a4 = a2 a2, a6 = a2 a4): u = a wu, wu = a6 x + b7 a6 + b5 a4 + b3 a2 +
// b1 I, x = b13 a6 + b11 a4 + b9 a2; v = a6 y + b6 a6 + b4 a4 + b2 a2 +
// b0 I, y = b12 a6 + b10 a4 + b8 a2 (`pade_from_slots` computes the same,
// operation for operation)
__device__ __forceinline__ void pade(const float* a, float* pm, float* q) {
  float a2[16], a4[16], a6[16];
  mm(a, a, a2);
  mm(a2, a2, a4);
  mm(a2, a4, a6);
  float uu[16];
  {
    float x[16], wu[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = kB[13] * a6[i] + kB[11] * a4[i] + kB[9] * a2[i];
    mm(a6, x, wu);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wu[i] = wu[i] + kB[7] * a6[i] + kB[5] * a4[i] + kB[3] * a2[i]
              + (i % 5 == 0 ? kB[1] : 0.0f);
    mm(a, wu, uu);
  }
  float y[16], v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    y[i] = kB[12] * a6[i] + kB[10] * a4[i] + kB[8] * a2[i];
  mm(a6, y, v);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = v[i] + kB[6] * a6[i] + kB[4] * a4[i] + kB[2] * a2[i]
           + (i % 5 == 0 ? kB[0] : 0.0f);
    pm[i] = v[i] - uu[i];
    q[i] = v[i] + uu[i];
  }
}

// ---- a lane's shared slots -------------------------------------------------
//
// A slot is a 4x4 matrix of one lane in shared memory, element e at
// e * kSh from the lane's base, so that the warp's 32 lanes touch 32
// banks. Slots are read and written through volatile accesses: the
// compiler may then not keep a loaded slot in registers past its use
// (eliminating the reload), which would rebuild the register pressure the
// slots are there to relieve.

__device__ __forceinline__ void ld16(const float* slot, float* r) {
  const volatile float* s = slot;
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = s[i * kSh];
}

__device__ __forceinline__ void st16(const float* r, float* slot) {
  volatile float* s = slot;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i * kSh] = r[i];
}

__device__ __forceinline__ float ld1(const float* slot, int e) {
  return static_cast<const volatile float*>(slot)[e * kSh];
}

// a2 = a a, a4 = a2 a2, a6 = a2 a4 into the three consecutive slots at sp
__device__ __forceinline__ void powers_to_slots(const float* a, float* sp) {
  float a2[16], a4[16];
  mm(a, a, a2);
  st16(a2, sp);
  mm(a2, a2, a4);
  st16(a4, sp + 16 * kSh);
  float a6[16];
  mm(a2, a4, a6);
  st16(a6, sp + 32 * kSh);
}

// the Pade polynomials' inner sums x = b13 a6 + b11 a4 + b9 a2 (hi 13) and
// y = b12 a6 + b10 a4 + b8 a2 (hi 12), an entry at a time
__device__ __forceinline__ void inner_from_slots(const float* sp, int hi,
                                                 float* x) {
#pragma unroll
  for (int e = 0; e < 16; ++e)
    x[e] = kB[hi] * ld1(sp + 32 * kSh, e) + kB[hi - 2] * ld1(sp + 16 * kSh, e)
           + kB[hi - 4] * ld1(sp, e);
}

// the outer sums from the inner one: wu = a6 x + b7 a6 + b5 a4 + b3 a2 +
// b1 I (lo 1) and v = a6 y + b6 a6 + b4 a4 + b2 a2 + b0 I (lo 0)
__device__ __forceinline__ void outer_from_slots(const float* sp, int lo,
                                                 const float* inner,
                                                 float* out) {
  float a6[16];
  ld16(sp + 32 * kSh, a6);
  mm(a6, inner, out);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    out[e] = out[e] + kB[lo + 6] * a6[e] + kB[lo + 4] * ld1(sp + 16 * kSh, e)
             + kB[lo + 2] * ld1(sp, e) + (e % 5 == 0 ? kB[lo] : 0.0f);
}

// `pade` with a in the slot at `a` and a2, a4, a6 in the three at sp
__device__ __forceinline__ void pade_from_slots(const float* a,
                                                const float* sp, float* pm,
                                                float* q) {
  float uu[16];
  {
    float wu[16];
    {
      float x[16];
      inner_from_slots(sp, 13, x);
      outer_from_slots(sp, 1, x, wu);
    }
    float ar[16];
    ld16(a, ar);
    mm(ar, wu, uu);
  }
  float y[16], v[16];
  inner_from_slots(sp, 12, y);
  outer_from_slots(sp, 0, y, v);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pm[i] = v[i] - uu[i];
    q[i] = v[i] + uu[i];
  }
}

// the FOH's forward: z = A^-1 B, g1 = (phi - I) z, y = (A dt)^-1 g1;
// returns whether the factors' divisors are finite
__device__ __forceinline__ bool foh(const float* A, const float* adt,
                                    float wn2, const float* phi,
                                    Factors& fa, Factors& fadt, float* z,
                                    float* g1, float* y) {
  const float b[4] = {wn2, 0.0f, 0.0f, 0.0f};
  factor(A, fa);
  solve<1>(fa, b, z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = (phi[i * 4] - (i == 0 ? 1.0f : 0.0f)) * z[0];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      acc += (phi[i * 4 + j] - (i == j ? 1.0f : 0.0f)) * z[j];
    g1[i] = acc;
  }
  factor(adt, fadt);
  solve<1>(fadt, g1, y);
  return diagonal_finite(fa) && diagonal_finite(fadt);
}

// The FOH's (Bd, Bt) = (g1 - g2, g2), g2 = y - z, from phi; returns whether
// its factors' divisors are finite
__device__ __forceinline__ bool foh_b(const float* A, const float* adt,
                                      float wn2, const float* phi,
                                      float* bd, float* bt) {
  Factors fa, fadt;
  float z[4], g1[4], y[4];
  const bool ok = foh(A, adt, wn2, phi, fa, fadt, z, g1, y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float g2 = y[i] - z[i];
    bd[i] = g1[i] - g2;
    bt[i] = g2;
  }
  return ok;
}

// Build and discretize one system into (phi, bd, bt), in registers.
// Returns whether every divisor was finite.
__device__ bool discretize(const float* p, float u, float dt, float* phi,
                           float* bd, float* bt) {
  const Lin L = linearize(p, u);
  float A[16];
  a_matrix(L.tzw, L.wn2, L.sf, L.df, A);
  const float dts = kNsToS * dt;
  float adt[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) adt[i] = A[i] * dts;
  const int s = squaring_count(adt);
  Factors fp;
  {
    float pm[16], q[16];
    {
      float a[16];
      const float scale = ldexpf(1.0f, -s);
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = adt[i] * scale;
      pade(a, pm, q);
    }
    factor(pm, fp);
    solve<4>(fp, q, phi);
  }
  for (int k = 0; k < s; ++k) square(phi);
  return foh_b(A, adt, L.wn2, phi, bd, bt) && divisors_finite(p, L)
         && diagonal_finite(fp);
}

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) acc += a[j] * b[j];
  return acc;
}

// row x of a 16-byte aligned 4x4 matrix in shared memory, in one load
__device__ __forceinline__ void row4(const float* m, int x, float* r) {
  const float4 v = reinterpret_cast<const float4*>(m)[x];
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void transpose_to(const float* a, float* at) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) at[j * 4 + i] = a[i * 4 + j];
}

// ---- the forward -----------------------------------------------------------

struct __align__(16) ColumnSystems {
  float ad[kMaxSystems][16];
  float bd[kMaxSystems][4];
  float bt[kMaxSystems][4];
  float c[kMaxSystems + 1][2][4];  // c_i = C phi(i, S-1), i = 1..S-1
};

// The carries of output row r (state 2 or 3): c_{S-1} = e_state, then
// c_i = c_{i+1} Ad[i] down to c_1; the serial part of the scan, 16 FMAs
// (4 deep) a step.
__device__ __forceinline__ void carries(ColumnSystems& sh, int S, int o,
                                        int r) {
  const int state = (o == 2 && r == 0) ? 2 : 3;
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = k == state ? 1.0f : 0.0f;
    sh.c[S - 1][r][k] = c[k];
  }
#pragma unroll 4
  for (int i = S - 2; i >= 1; --i) {
    float cn[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float acc = c[0] * sh.ad[i][b];
#pragma unroll
      for (int a = 1; a < 4; ++a) acc += c[a] * sh.ad[i][a * 4 + b];
      cn[b] = acc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = cn[k];
      sh.c[i][r][k] = cn[k];
    }
  }
}

// The weight of sample i in output row r from the carries:
//   w[S-1] = c_{S-1} Bt[S-2]
//   w[i]   = c_{i+1} Bd[i] + c_i Bt[i-1]       (1 <= i <= S-2)
//   w[0]   = c_1 Bd[0] + c_1 Ad[0] x0_dir
__device__ __forceinline__ float weight_of(const ColumnSystems& sh, int S,
                                          int i, int r) {
  if (i == S - 1) return dot4(sh.c[S - 1][r], sh.bt[S - 2]);
  if (i > 0)
    return dot4(sh.c[i + 1][r], sh.bd[i]) + dot4(sh.c[i][r], sh.bt[i - 1]);
  float ax0[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) ax0[a] = dot4(&sh.ad[0][a * 4], kX0);
  return dot4(sh.c[1][r], sh.bd[0]) + dot4(sh.c[1][r], ax0);
}

__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
    pb_weight_fwd_kernel(const float* __restrict__ params,
                         const float* __restrict__ intensity,
                         const float* __restrict__ dt, float* __restrict__ w,
                         uint8_t* __restrict__ finite,
                         float* __restrict__ systems, int S, int64_t M,
                         int o) {
  __shared__ ColumnSystems shared[kFwdWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t m = (int64_t)blockIdx.x * kFwdWarps + warp;
  if (m >= M) return;  // the whole warp
  ColumnSystems& sh = shared[warp];
  bool ok = true;
  if (lane < S - 1) {
    float p[kParams];
#pragma unroll
    for (int k = 0; k < kParams; ++k) p[k] = __ldg(params + k);
    float phi[16], bd[4], bt[4];
    ok = discretize(p, __ldg(intensity + (lane + 1) * M + m),
                    __ldg(dt + lane * M + m), phi, bd, bt);
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.ad[lane][i] = phi[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sh.bd[lane][i] = bd[i];
      sh.bt[lane][i] = bt[i];
    }
  }
  __syncwarp();
  {
    // the column's Ad, 16 floats a system, in coalesced 16-byte stores
    float4* dst = reinterpret_cast<float4*>(systems + m * (S - 1) * 16);
    const float4* from = reinterpret_cast<const float4*>(sh.ad);
    for (int i = lane; i < (S - 1) * 4; i += 32) __stcs(dst + i, from[i]);
  }
  if (lane < o) carries(sh, S, o, lane);
  __syncwarp();
  // the weights, a sample a lane
  for (int i = lane; i < S; i += 32)
    for (int r = 0; r < o; ++r) {
      const float wv = weight_of(sh, S, i, r);
      ok = ok && isfinite(wv);
      w[(i * M + m) * o + r] = wv;
    }
  ok = __all_sync(kFull, ok);
  if (lane == 0) finite[m] = ok;
}

// ---- the backward ----------------------------------------------------------

struct __align__(16) ColumnScan {
  float ad[kMaxSystems][16];
  float adt[kMaxSystems][16];  // each Ad transposed: the scan reads rows
  float bd[kMaxSystems][4];
  float bt[kMaxSystems][4];
  float c[kMaxSystems + 1][2][4];  // c_i = C phi(i, S-1), i = 1..S-1
  float cbar[kMaxSystems][2][4];   // the carries' cotangents, i = 0..S-2
  float g[kMaxSystems + 1][2];     // the column's weight cotangent
};

// A backward warp's shared memory: its column's scan, then (once each lane
// holds what it needs of it) each lane's kSlots 4x4 slots, element e of
// lane l's slot k at slots[(k * 16 + e) * kSh + l].
union WarpShared {
  ColumnScan scan;
  float slots[kSlots * 16 * kSh];
};

// The scan (lanes r < o: the carries c for output row r) and its reverse
// (lanes o + r: cbar_0 = g[0] x0_dir, then cbar_i = g[i-1] Bd[i-1] +
// g[i] Bt[i-1] + Ad[i-1] cbar_{i-1}) as one loop: step k of each is
// out = add + M v, with M = Ad[S-2-k]^T (add 0) or Ad[k] (add the g
// terms), M's rows read as 16-byte loads.
__device__ __forceinline__ void scans(ColumnScan& sh, int S, int o,
                                      int lane) {
  const bool fwd = lane < o;
  const int r = fwd ? lane : lane - o;
  float v[4];
  if (fwd) {
    const int state = (o == 2 && r == 0) ? 2 : 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = k == state ? 1.0f : 0.0f;
      sh.c[S - 1][r][k] = v[k];
    }
  } else {
    const float g0 = sh.g[0][r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = g0 * kX0[k];
      sh.cbar[0][r][k] = v[k];
    }
  }
#pragma unroll 4
  for (int k = 0; k < S - 2; ++k) {
    const int i = fwd ? S - 2 - k : k + 1;
    const float* mat = fwd ? sh.adt[i] : sh.ad[i - 1];
    const float gp = sh.g[i - 1][r], gi = sh.g[i][r];
    float bd[4], bt[4];
    row4(sh.bd[i - 1], 0, bd);
    row4(sh.bt[i - 1], 0, bt);
    float out[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float row[4];
      row4(mat, x, row);
      float acc = fwd ? 0.0f : gp * bd[x] + gi * bt[x];
#pragma unroll
      for (int y = 0; y < 4; ++y) acc += row[y] * v[y];
      out[x] = acc;
    }
    float* dst = fwd ? sh.c[i][r] : sh.cbar[i][r];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      v[x] = out[x];
      dst[x] = out[x];
    }
  }
}

// The FOH of one system as the backward keeps it from before the scans to
// its reverse: A's four entries, dt in seconds, the factors of A and A dt,
// z = A^-1 B and y = (A dt)^-1 g1.
struct Foh {
  float tzw, wn2, sf, df, dts;
  Factors fa, fadt;
  float z[4], y[4];
};

// One system's reverse: (u_bar, dt_bar, the 7 parameter partials) from the
// cotangents of (Bd, Bt) and its FOH's state; `intensity` points at the
// system's u, `sl` is the lane's slots, slot 4 holding Ad and slot 5 Ad's
// cotangent on entry. Between its stages a lane keeps little in
// registers: A's four entries and dt; adt_bar = -(h y^T) + ... as h and y,
// with the FOH's B_bar and z, waits in slot 5, the matrices in the others,
// and the parameters and u are read again at the end. (Under the launch
// bounds' 128 registers, keeping more live spilled to a local-memory
// stack.)
__device__ __forceinline__ void system_reverse(
    const float* params, const float* intensity, const Foh& F,
    const float* bdb, const float* btb, float* sl, float& ubar, float& dtbar,
    float* pbar) {
  float* s0 = sl;
  float* s1 = sl + 16 * kSh;
  float* s2 = sl + 32 * kSh;
  float* s3 = sl + 48 * kSh;
  float* s4 = sl + 64 * kSh;
  float* s5 = sl + 80 * kSh;
  const float tzw = F.tzw, wn2 = F.wn2, sf = F.sf, df = F.df, dts = F.dts;
  // the FOH in reverse: Bd = g1 - g2, Bt = g2, g2 = y - z, y = adt^-1 g1,
  // g1 = (phi - I) z, z = A^-1 B; adt_bar = -(h y^T) is kept as h and y.
  // phi_bar goes to slot 4; h, y, B_bar and z (16 floats) to slot 5.
  {
    float phib[16], hybz[16];
    float* h = hybz;
    float* y = hybz + 4;
    float* bb = hybz + 8;
    float* z = hybz + 12;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[i] = F.z[i];
      y[i] = F.y[i];
    }
    {
      float g2b[4], zb[4], g1b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g2b[i] = btb[i] - bdb[i];
        zb[i] = -g2b[i];
      }
      solve_t<1>(F.fadt, g2b, h);
#pragma unroll
      for (int i = 0; i < 4; ++i) g1b[i] = bdb[i] + h[i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          phib[i * 4 + j] = ld1(s5, i * 4 + j) + g1b[i] * z[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = (ld1(s4, j) - (j == 0 ? 1.0f : 0.0f)) * g1b[0];
#pragma unroll
        for (int i = 1; i < 4; ++i)
          acc += (ld1(s4, i * 4 + j) - (i == j ? 1.0f : 0.0f)) * g1b[i];
        zb[j] += acc;
      }
      solve_t<1>(F.fa, zb, bb);
    }
    st16(phib, s4);
    st16(hybz, s5);
  }
  // the expm again: a, a2, a4, a6 in slots 0-3, then phi_0 = P^-1 Q
  int s;
  float scale;
  {
    float adt[16], a[16];
    a_dt(tzw, wn2, sf, df, dts, adt);
    s = squaring_count(adt);
    scale = ldexpf(1.0f, -s);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = adt[i] * scale;
    st16(a, s0);
    powers_to_slots(a, s1);
  }
  Factors fp;
  float cur[16];
  {
    float pm[16], q[16];
    pade_from_slots(s0, s1, pm, q);
    factor(pm, fp);
    solve<4>(fp, q, cur);
  }
  // the squarings: checkpoints phi_0, phi_L, phi_2L, ... in slot k / L
  // (slots 0-4; h, y, B_bar, z wait in slot 5); in reverse, each phi_k is
  // its checkpoint squared k mod L times
  constexpr int kCheckpoints = kSlots - 1;
  float phib[16];
  ld16(s4, phib);
  const int L = s > kCheckpoints ? (s + kCheckpoints - 1) / kCheckpoints : 1;
  st16(cur, s0);
  for (int k = 1; k < s; ++k) {
    square(cur);
    if (k % L == 0) st16(cur, sl + (k / L) * 16 * kSh);
  }
  for (int c = (s - 1) / L; c >= 0 && s > 0; --c) {
    const int lo = c * L, hi = min(lo + L, s);
    const float* ck = sl + c * 16 * kSh;
    for (int k = hi - 1; k >= lo; --k) {
      ld16(ck, cur);
      for (int t = lo; t < k; ++t) square(cur);
      float nb[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t1 = phib[i * 4] * cur[j * 4];
#pragma unroll
          for (int l = 1; l < 4; ++l) t1 += phib[i * 4 + l] * cur[j * 4 + l];
          float t2 = cur[i] * phib[j];
#pragma unroll
          for (int l = 1; l < 4; ++l) t2 += cur[l * 4 + i] * phib[l * 4 + j];
          nb[i * 4 + j] = t1 + t2;
        }
      copy16(nb, phib);
    }
  }
  // phi_0 = P^-1 Q: Q_bar = P^-T phi_bar, P_bar = -Q_bar phi_0^T;
  // V_bar = Q_bar + P_bar, U_bar = Q_bar - P_bar
  float ub[16], vb[16];
  {
    float qb[16], phi0[16];
    solve_t<4>(fp, phib, qb);
    ld16(s0, phi0);
    mm_nt(qb, phi0, ub);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float pb = -ub[i];
      vb[i] = qb[i] + pb;
      ub[i] = qb[i] - pb;
    }
  }
  // the Pade polynomials in reverse, a..a6 again in slots 0-3; U_bar
  // wu^T (a_bar's first term) to slot 4
  {
    // A dt built anew from opaque copies, so that the compiler keeps none
    // of the first build's products live across the squarings
    float adt[16], a[16];
    a_dt(opaque(tzw), opaque(wn2), opaque(sf), opaque(df), opaque(dts),
         adt);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = adt[i] * scale;
    st16(a, s0);
    powers_to_slots(a, s1);
  }
  float a6b[16], a4b[16], a2b[16];
  {
    // u = a wu; wu = a6 x + b7 a6 + b5 a4 + b3 a2 + b1 I; x = b13 a6 + ...
    {
      float wu[16];
      {
        float x[16];
        inner_from_slots(s1, 13, x);
        outer_from_slots(s1, 1, x, wu);
      }
      float ab[16];
      mm_nt(ub, wu, ab);
      st16(ab, s4);
    }
    float wub[16], xb[16];
    {
      float a[16];
      ld16(s0, a);
      mm_tn(a, ub, wub);
    }
    {
      float a6[16];
      ld16(s3, a6);
      mm_tn(a6, wub, xb);
    }
    {
      float x[16];
      inner_from_slots(s1, 13, x);
      mm_nt(wub, x, a6b);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      a6b[i] = a6b[i] + kB[7] * wub[i] + kB[13] * xb[i];
      a4b[i] = kB[5] * wub[i] + kB[11] * xb[i];
      a2b[i] = kB[3] * wub[i] + kB[9] * xb[i];
    }
  }
  {
    // v = a6 y + b6 a6 + b4 a4 + b2 a2 + b0 I; y = b12 a6 + b10 a4 + b8 a2
    {
      float yy[16];
      inner_from_slots(s1, 12, yy);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float t = vb[i * 4] * yy[k * 4];
#pragma unroll
          for (int j = 1; j < 4; ++j) t += vb[i * 4 + j] * yy[k * 4 + j];
          a6b[i * 4 + k] = a6b[i * 4 + k] + t;
        }
    }
    float yb[16];
    {
      float a6[16];
      ld16(s3, a6);
      mm_tn(a6, vb, yb);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      a6b[i] = a6b[i] + kB[6] * vb[i] + kB[12] * yb[i];
      a4b[i] = a4b[i] + kB[4] * vb[i] + kB[10] * yb[i];
      a2b[i] = a2b[i] + kB[2] * vb[i] + kB[8] * yb[i];
    }
  }
  float adtb[16];
  {
    // a6 = a2 a4; a4 = a2 a2; a2 = a a
    float t[16], t2[16], m[16];
    ld16(s2, m);
    mm_nt(a6b, m, t);
#pragma unroll
    for (int i = 0; i < 16; ++i) a2b[i] += t[i];
    ld16(s1, m);
    mm_tn(m, a6b, t);
#pragma unroll
    for (int i = 0; i < 16; ++i) a4b[i] += t[i];
    mm_nt(a4b, m, t);
    mm_tn(m, a4b, t2);
#pragma unroll
    for (int i = 0; i < 16; ++i) a2b[i] += t[i] + t2[i];
    ld16(s0, m);
    mm_nt(a2b, m, t);
    mm_tn(m, a2b, t2);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      adtb[i] = -(ld1(s5, i / 4) * ld1(s5, 4 + i % 4))
                + (ld1(s4, i) + (t[i] + t2[i])) * scale;
  }
  // A_bar = -B_bar z^T + adt_bar dts; dts_bar = sum adt_bar * A; the
  // parameters and u read again (volatile: not kept across the middle)
  float hybz[16], p[kParams];
  ld16(s5, hybz);
  const float* bb = hybz + 8;
  const float* z = hybz + 12;
#pragma unroll
  for (int k = 0; k < kParams; ++k)
    p[k] = static_cast<const volatile float*>(params)[k];
  const float u = static_cast<const volatile float*>(intensity)[0];
  const Lin L2 = linearize(p, u);
  float A[16];
  a_matrix(L2.tzw, L2.wn2, L2.sf, L2.df, A);
  float Ab[16];
  float dts_bar = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Ab[i * 4 + j] = -(bb[i] * z[j]) + adtb[i * 4 + j] * dts;
      dts_bar += adtb[i * 4 + j] * A[i * 4 + j];
    }
  dtbar = kNsToS * dts_bar;
  // the linearization in reverse
  const float tzw_b = -Ab[0];
  const float wn2_b = -Ab[1] + bb[0];
  const float sf_b = Ab[9] - Ab[10];
  const float df_b = Ab[14] - Ab[15];
  const float num_b = tzw_b / L2.denom;
  const float denom_b = -(tzw_b * L2.tzw + wn2_b * L2.wn2) / L2.denom;
  const float a_loop_b = wn2_b / L2.denom;
  const float tau_in_b = num_b + denom_b * p[3];
  const float tau_mil_b = num_b * (L2.a_amp + 1.0f) + denom_b * p[3];
  const float a_amp_b = num_b * L2.tau_mil;
  const float tau_out_b = num_b + denom_b * (L2.tau_in + L2.tau_mil);
  ubar = -(tau_in_b * L2.tau_in + tau_mil_b * L2.tau_mil) / L2.u;
  pbar[0] = tau_mil_b / L2.u;
  pbar[1] = -a_amp_b * L2.a_amp * L2.a_amp;
  pbar[2] = -a_loop_b * L2.a_loop * L2.a_loop;
  pbar[3] = tau_out_b;
  pbar[4] = -sf_b * L2.sf * L2.sf;
  pbar[5] = -df_b * L2.df * L2.df;
  pbar[6] = tau_in_b / L2.u;
}

__global__ void __launch_bounds__(32 * kBwdWarps, kBwdMinBlocks)
    pb_weight_bwd_kernel(const float* __restrict__ params,
                         const float* __restrict__ intensity,
                         const float* __restrict__ dt,
                         const float* __restrict__ g,
                         const uint8_t* __restrict__ finite,
                         const float* __restrict__ systems,
                         float* __restrict__ g_intensity,
                         float* __restrict__ g_dt,
                         float* __restrict__ partials, int S, int64_t M,
                         int o) {
  __shared__ WarpShared shared[kBwdWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t m = (int64_t)blockIdx.x * kBwdWarps + warp;
  if (m >= M) return;  // the whole warp
  ColumnScan& sh = shared[warp].scan;
  // the column's cotangent; a column with a zero cotangent (NaN is not
  // zero) and a finite forward has zero cotangents: write them and leave
  bool nonzero = false;
  for (int i = lane; i < S; i += 32)
    for (int r = 0; r < o; ++r) {
      const float gv = __ldg(g + (i * M + m) * o + r);
      sh.g[i][r] = gv;
      nonzero = nonzero || gv != 0.0f;
    }
  if (__all_sync(kFull, !nonzero) && __ldg(finite + m) != 0) {
    for (int i = lane; i < S; i += 32) g_intensity[i * M + m] = 0.0f;
    for (int i = lane; i < S - 1; i += 32) g_dt[i * M + m] = 0.0f;
    if (lane < kParams) partials[m * kParams + lane] = 0.0f;
    return;
  }
  float p[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) p[k] = __ldg(params + k);
  const bool active = lane < S - 1;
  const float u = active ? __ldg(intensity + (lane + 1) * M + m) : 1.0f;
  const float dtv = active ? __ldg(dt + lane * M + m) : 1.0f;
  // the column's (Ad, Bd, Bt): Ad saved by the forward (coalesced 16-byte
  // loads), (Bd, Bt) by its FOH, whose state each lane keeps for its
  // reverse
  {
    const float4* src = reinterpret_cast<const float4*>(systems
                                                        + m * (S - 1) * 16);
    float4* to = reinterpret_cast<float4*>(sh.ad);
    for (int i = lane; i < (S - 1) * 4; i += 32) to[i] = __ldg(src + i);
    __syncwarp();
  }
  Foh foh_state;
  if (active) {
    float phi[16], A[16], adt[16], g1[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) phi[i] = sh.ad[lane][i];
    transpose_to(phi, sh.adt[lane]);
    const Lin L = linearize(p, u);
    Foh& F = foh_state;
    F.tzw = L.tzw;
    F.wn2 = L.wn2;
    F.sf = L.sf;
    F.df = L.df;
    F.dts = kNsToS * dtv;
    a_matrix(F.tzw, F.wn2, F.sf, F.df, A);
    a_dt(F.tzw, F.wn2, F.sf, F.df, F.dts, adt);
    foh(A, adt, F.wn2, phi, F.fa, F.fadt, F.z, g1, F.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float g2 = F.y[i] - F.z[i];
      sh.bd[lane][i] = g1[i] - g2;
      sh.bt[lane][i] = g2;
    }
  }
  __syncwarp();
  if (lane < 2 * o) scans(sh, S, o, lane);
  __syncwarp();
  // this system's cotangents, summed over the output rows, and its Ad
  const int j = lane;
  float adb[16], bdb[4], btb[4], phi[16];
  if (active) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      adb[i] = 0.0f;
      phi[i] = sh.ad[j][i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) bdb[i] = btb[i] = 0.0f;
    for (int r = 0; r < o; ++r) {
      const float gj = sh.g[j][r], gj1 = sh.g[j + 1][r];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ca = sh.c[j + 1][r][a];
        bdb[a] += gj * ca;
        btb[a] += gj1 * ca;
#pragma unroll
        for (int b = 0; b < 4; ++b) adb[a * 4 + b] += ca * sh.cbar[j][r][b];
      }
    }
  }
  __syncwarp();  // the scan's memory becomes the lanes' slots
  float* sl = shared[warp].slots + lane;
  float pbar[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) pbar[k] = 0.0f;
  if (active) {
    st16(phi, sl + 64 * kSh);
    st16(adb, sl + 80 * kSh);
    float ubar, dtbar;
    system_reverse(params, intensity + (lane + 1) * M + m, foh_state, bdb,
                   btb, sl, ubar, dtbar, pbar);
    g_intensity[(j + 1) * M + m] = ubar;
    g_dt[j * M + m] = dtbar;
  }
  if (lane == 0) g_intensity[m] = 0.0f;  // intensity[0] is not read
  // the event's partials: a fixed butterfly over the warp's lanes
#pragma unroll
  for (int k = 0; k < kParams; ++k) {
    float v = pbar[k];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) partials[m * kParams + k] = v;
  }
}

}  // namespace

extern "C" int pb_weight_fwd(const float* params, const float* intensity,
                             const float* dt, float* w, uint8_t* finite,
                             float* systems, int32_t S, int64_t M, int32_t o,
                             cudaStream_t stream) {
  if (S < 2 || S - 1 > kMaxSystems || (o != 1 && o != 2) || M < 1 ||
      systems == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (M + kFwdWarps - 1) / kFwdWarps;
  pb_weight_fwd_kernel<<<(unsigned)blocks, 32 * kFwdWarps, 0, stream>>>(
      params, intensity, dt, w, finite, systems, S, M, o);
  return (int)cudaGetLastError();
}

extern "C" int pb_weight_bwd(const float* params, const float* intensity,
                             const float* dt, const float* g,
                             const uint8_t* finite, const float* systems,
                             float* g_intensity, float* g_dt, float* partials,
                             int32_t S, int64_t M, int32_t o,
                             cudaStream_t stream) {
  if (S < 2 || S - 1 > kMaxSystems || (o != 1 && o != 2) || M < 1 ||
      systems == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (M + kBwdWarps - 1) / kBwdWarps;
  pb_weight_bwd_kernel<<<(unsigned)blocks, 32 * kBwdWarps, 0, stream>>>(
      params, intensity, dt, g, finite, systems, g_intensity, g_dt, partials,
      S, M, o);
  return (int)cudaGetLastError();
}

// The built kernels' registers a thread and local memory a thread (stack
// frame and spills), as the loaded binary states them: the check that no
// local-memory stack is left needs no compiler log.
extern "C" int pb_weight_attributes(int32_t backward, int32_t* registers,
                                    int64_t* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      backward ? cudaFuncGetAttributes(&a, pb_weight_bwd_kernel)
               : cudaFuncGetAttributes(&a, pb_weight_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = a.numRegs;
  *local_bytes = (int64_t)a.localSizeBytes;
  return 0;
}
