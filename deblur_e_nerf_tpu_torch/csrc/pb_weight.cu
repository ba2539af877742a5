// The pixel-bandwidth weight chain for Hopper (sm_90a), one kernel per
// direction: for every event column m of an (S, M) window of sampled
// intensities and the (S - 1, M) steps between them,
//   forward   w[i, m, r] = the weight of sample i in output r (S, M, o)
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
//   - the squarings in reverse from their inputs phi_0..phi_{s-1}, kept
//     in local memory (at most 32 x 16 floats a lane): phi_bar_k =
//     phi_bar_{k+1} phi_k^T + phi_k^T phi_bar_{k+1}; then the Pade
//     polynomials, the 2^-s scaling, A dt, and the linearization.
// The 7 parameter partials of an event are summed over its systems by a
// fixed butterfly of warp shuffles into one row of an (M, 7) buffer: no
// atomics, so two runs give the same bits.
//
// Bound: operations. A system is about 1.7 kflop of linear algebra plus
// 128 flop a squaring (s is 10-25 on the pixel circuits), and the
// backward about three times that; the bytes are a few floats a system.
// No tensor core: the card's float32 rate (67 TFLOP/s) is the bound, and
// no TF32 can enter. What the kernels lose time on instead is latency:
// each lane runs a long dependent chain of 4x4 products, and each event's
// scan is serial over S.
//
// The design: one warp an event column, lane j < S - 1 system j (so
// S - 1 <= 32). Each lane builds and discretizes its system in registers
// and local memory and writes (Ad, Bd, Bt) to its warp's shared memory;
// lanes 0..o-1 then run the scan for output row r = lane. The backward
// recomputes the forward, stores the scan's carries c_i, runs the scan in
// reverse (the carries' cotangents cbar_i), and then each lane reads its
// system's cotangents from shared memory and recomputes its system once
// more, keeping what the reverse needs, so that little state lives across
// the scan. float32 throughout; nvcc contracts products and sums into
// fused multiply-adds (the tests state the error this leaves). NaN
// propagates as in the plain chain: a pivot search takes the first NaN
// as the largest magnitude, as torch.argmax and jnp.argmax do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSystems = 32;
constexpr int kWarps = 4;  // warps (events) a block
constexpr int kMaxSquarings = 32;
constexpr int kParams = 7;
constexpr float kNsToS = 1e-9f;
constexpr float kTheta13 = 5.371920351148152f;
__constant__ float kB[14] = {
    64764752532480000.0f, 32382376266240000.0f, 7771770303897600.0f,
    1187353796428800.0f,  129060195264000.0f,   10559470521600.0f,
    670442572800.0f,      33522128640.0f,       1323241920.0f,
    40840800.0f,          960960.0f,            16380.0f,
    182.0f,               1.0f};
__constant__ float kX0[4] = {0.0f, 1.0f, 1.0f, 1.0f};

// ---- 4x4 helpers (row-major) ----------------------------------------------

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

struct System {
  Lin lin;
  float A[16];
  float dts;
  float adt[16];
  int s;
  float scale;
  float a[16], a2[16], a4[16], a6[16];
  Factors fp;  // P = V - U
  float phi[16];
  Factors fa;  // A
  float z[4];
  Factors fadt;  // A dt
  float y[4];
  float bd[4], bt[4];
};

__device__ __forceinline__ void linearize(const float* p, float u, Lin& L,
                                          float* A) {
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
#pragma unroll
  for (int i = 0; i < 16; ++i) A[i] = 0.0f;
  A[0] = -L.tzw;
  A[1] = -L.wn2;
  A[4] = 1.0f;
  A[9] = L.sf;
  A[10] = -L.sf;
  A[14] = L.df;
  A[15] = -L.df;
}

// Build and discretize one system; with `phis`, keep each squaring's input.
__device__ void discretize(const float* p, float u, float dt, System& Y,
                           float (*phis)[16]) {
  linearize(p, u, Y.lin, Y.A);
  Y.dts = kNsToS * dt;
#pragma unroll
  for (int i = 0; i < 16; ++i) Y.adt[i] = Y.A[i] * Y.dts;
  // the per-system 1-norm (largest column sum of magnitudes), NaN kept
  float norm = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cs = ((fabsf(Y.adt[c]) + fabsf(Y.adt[4 + c]))
                      + fabsf(Y.adt[8 + c])) + fabsf(Y.adt[12 + c]);
    if (c == 0 || cs > norm || isnan(cs)) norm = isnan(norm) ? norm : cs;
  }
  if (norm < 1.17549435e-38f) norm = 1.17549435e-38f;
  const float sflt = ceilf(log2f(norm / kTheta13));
  Y.s = isnan(sflt) ? 0 : (int)fminf(fmaxf(sflt, 0.0f), (float)kMaxSquarings);
  Y.scale = ldexpf(1.0f, -Y.s);
#pragma unroll
  for (int i = 0; i < 16; ++i) Y.a[i] = Y.adt[i] * Y.scale;
  mm(Y.a, Y.a, Y.a2);
  mm(Y.a2, Y.a2, Y.a4);
  mm(Y.a2, Y.a4, Y.a6);
  float t[16], w[16], uu[16], v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    t[i] = kB[13] * Y.a6[i] + kB[11] * Y.a4[i] + kB[9] * Y.a2[i];
  mm(Y.a6, t, w);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = w[i] + kB[7] * Y.a6[i] + kB[5] * Y.a4[i] + kB[3] * Y.a2[i]
           + (i % 5 == 0 ? kB[1] : 0.0f);
  mm(Y.a, w, uu);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    t[i] = kB[12] * Y.a6[i] + kB[10] * Y.a4[i] + kB[8] * Y.a2[i];
  mm(Y.a6, t, v);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = v[i] + kB[6] * Y.a6[i] + kB[4] * Y.a4[i] + kB[2] * Y.a2[i]
           + (i % 5 == 0 ? kB[0] : 0.0f);
  float pm[16], q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pm[i] = v[i] - uu[i];
    q[i] = v[i] + uu[i];
  }
  factor(pm, Y.fp);
  solve<4>(Y.fp, q, Y.phi);
  for (int k = 0; k < Y.s; ++k) {
    if (phis != nullptr) {
#pragma unroll
      for (int i = 0; i < 16; ++i) phis[k][i] = Y.phi[i];
    }
    float sq[16];
    mm(Y.phi, Y.phi, sq);
#pragma unroll
    for (int i = 0; i < 16; ++i) Y.phi[i] = sq[i];
  }
  // the FOH: z = A^-1 B, g1 = (phi - I) z, y = (A dt)^-1 g1, g2 = y - z
  const float b[4] = {Y.lin.wn2, 0.0f, 0.0f, 0.0f};
  factor(Y.A, Y.fa);
  solve<1>(Y.fa, b, Y.z);
  float g1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = (Y.phi[i * 4] - (i == 0 ? 1.0f : 0.0f)) * Y.z[0];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      acc += (Y.phi[i * 4 + j] - (i == j ? 1.0f : 0.0f)) * Y.z[j];
    g1[i] = acc;
  }
  factor(Y.adt, Y.fadt);
  solve<1>(Y.fadt, g1, Y.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float g2 = Y.y[i] - Y.z[i];
    Y.bd[i] = g1[i] - g2;
    Y.bt[i] = g2;
  }
}

// ---- the warp's shared memory ---------------------------------------------

struct WarpShared {
  float ad[kMaxSystems][16];
  float bd[kMaxSystems][4];
  float bt[kMaxSystems][4];
  float c[kMaxSystems + 1][2][4];  // c_i = C phi(i, S-1), i = 1..S-1
  float cbar[kMaxSystems][2][4];   // the carries' cotangents, i = 0..S-2
};

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) acc += a[j] * b[j];
  return acc;
}

// The forward scan for output row r (lane r < o): the carries into
// shared memory and, with `w`, the weights (S, M, o).
__device__ void scan(WarpShared& sh, int S, int64_t M, int64_t m, int o,
                     int r, float* w) {
  const int state = (o == 2 && r == 0) ? 2 : 3;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  c[state] = 1.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) sh.c[S - 1][r][k] = c[k];
  if (w != nullptr) w[((S - 1) * M + m) * o + r] = dot4(c, sh.bt[S - 2]);
  for (int i = S - 2; i >= 1; --i) {
    float cn[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float acc = c[0] * sh.ad[i][b];
#pragma unroll
      for (int a = 1; a < 4; ++a) acc += c[a] * sh.ad[i][a * 4 + b];
      cn[b] = acc;
    }
    if (w != nullptr)
      w[(i * M + m) * o + r] = dot4(c, sh.bd[i]) + dot4(cn, sh.bt[i - 1]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = cn[k];
      sh.c[i][r][k] = cn[k];
    }
  }
  if (w != nullptr) {
    float ax0[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ax0[a] = dot4(&sh.ad[0][a * 4], kX0);
    w[m * o + r] = dot4(c, sh.bd[0]) + dot4(c, ax0);
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    pb_weight_fwd_kernel(const float* __restrict__ params,
                         const float* __restrict__ intensity,
                         const float* __restrict__ dt, float* __restrict__ w,
                         int S, int64_t M, int o) {
  __shared__ WarpShared shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  if (m >= M) return;  // the whole warp
  WarpShared& sh = shared[warp];
  float p[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) p[k] = __ldg(params + k);
  if (lane < S - 1) {
    System Y;
    discretize(p, __ldg(intensity + (lane + 1) * M + m),
               __ldg(dt + lane * M + m), Y, nullptr);
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.ad[lane][i] = Y.phi[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sh.bd[lane][i] = Y.bd[i];
      sh.bt[lane][i] = Y.bt[i];
    }
  }
  __syncwarp();
  if (lane < o) scan(sh, S, M, m, o, lane, w);
}

// The reverse of the scan for output row r: cbar_0 = g[0] x0_dir, then
// cbar_i = g[i-1] Bd[i-1] + g[i] Bt[i-1] + Ad[i-1] cbar_{i-1}.
__device__ void scan_reverse(WarpShared& sh, int S, int64_t M, int64_t m,
                             int o, int r, const float* g) {
  float cb[4];
  const float g0 = __ldg(g + m * o + r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cb[k] = g0 * kX0[k];
    sh.cbar[0][r][k] = cb[k];
  }
  float g_prev = g0;
  for (int i = 1; i <= S - 2; ++i) {
    const float gi = __ldg(g + (i * M + m) * o + r);
    float nb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      nb[a] = (g_prev * sh.bd[i - 1][a] + gi * sh.bt[i - 1][a])
              + dot4(&sh.ad[i - 1][a * 4], cb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cb[k] = nb[k];
      sh.cbar[i][r][k] = nb[k];
    }
    g_prev = gi;
  }
}

// The expm's reverse: a_dt's cotangent (added into adtb) from phi's.
__device__ void expm_reverse(const System& Y, const float (*phis)[16],
                             float* phib, float* adtb) {
  for (int k = Y.s - 1; k >= 0; --k) {
    float t1[16], t2[16];
    mm_nt(phib, phis[k], t1);
    mm_tn(phis[k], phib, t2);
#pragma unroll
    for (int i = 0; i < 16; ++i) phib[i] = t1[i] + t2[i];
  }
  // phi_0 = P^-1 Q: Q_bar = P^-T phi_bar, P_bar = -Q_bar phi_0^T
  const float* phi0 = Y.s > 0 ? phis[0] : Y.phi;
  float qb[16], pb[16], vb[16], ub[16];
  solve_t<4>(Y.fp, phib, qb);
  mm_nt(qb, phi0, pb);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pb[i] = -pb[i];
    vb[i] = qb[i] + pb[i];
    ub[i] = qb[i] - pb[i];
  }
  // recompute x, wu, y of the forward
  float x[16], wu[16], yy[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = kB[13] * Y.a6[i] + kB[11] * Y.a4[i] + kB[9] * Y.a2[i];
    yy[i] = kB[12] * Y.a6[i] + kB[10] * Y.a4[i] + kB[8] * Y.a2[i];
  }
  mm(Y.a6, x, wu);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    wu[i] = wu[i] + kB[7] * Y.a6[i] + kB[5] * Y.a4[i] + kB[3] * Y.a2[i]
            + (i % 5 == 0 ? kB[1] : 0.0f);
  // u = a wu; wu = a6 x + b7 a6 + b5 a4 + b3 a2 + b1 I; x = b13 a6 + ...
  float ab[16], wub[16], xb[16], a6b[16], a4b[16], a2b[16], t[16];
  mm_nt(ub, wu, ab);
  mm_tn(Y.a, ub, wub);
  mm_tn(Y.a6, wub, xb);
  mm_nt(wub, x, a6b);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    a6b[i] = a6b[i] + kB[7] * wub[i] + kB[13] * xb[i];
    a4b[i] = kB[5] * wub[i] + kB[11] * xb[i];
    a2b[i] = kB[3] * wub[i] + kB[9] * xb[i];
  }
  // v = a6 y + b6 a6 + b4 a4 + b2 a2 + b0 I; y = b12 a6 + b10 a4 + b8 a2
  float yb[16];
  mm_tn(Y.a6, vb, yb);
  mm_nt(vb, yy, t);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    a6b[i] = a6b[i] + t[i] + kB[6] * vb[i] + kB[12] * yb[i];
    a4b[i] = a4b[i] + kB[4] * vb[i] + kB[10] * yb[i];
    a2b[i] = a2b[i] + kB[2] * vb[i] + kB[8] * yb[i];
  }
  // a6 = a2 a4; a4 = a2 a2; a2 = a a
  mm_nt(a6b, Y.a4, t);
#pragma unroll
  for (int i = 0; i < 16; ++i) a2b[i] += t[i];
  mm_tn(Y.a2, a6b, t);
#pragma unroll
  for (int i = 0; i < 16; ++i) a4b[i] += t[i];
  float t2[16];
  mm_nt(a4b, Y.a2, t);
  mm_tn(Y.a2, a4b, t2);
#pragma unroll
  for (int i = 0; i < 16; ++i) a2b[i] += t[i] + t2[i];
  mm_nt(a2b, Y.a, t);
  mm_tn(Y.a, a2b, t2);
#pragma unroll
  for (int i = 0; i < 16; ++i) adtb[i] += (ab[i] + (t[i] + t2[i])) * Y.scale;
}

// One system's reverse: (u_bar, dt_bar, the 7 parameter partials) from the
// cotangents of (Ad, Bd, Bt).
__device__ void system_reverse(const float* p, const System& Y,
                               const float (*phis)[16], const float* adb,
                               const float* bdb, const float* btb,
                               float& ubar, float& dtbar, float* pbar) {
  float g1b[4], g2b[4], zb[4], h[4], adtb[16], phib[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g2b[i] = btb[i] - bdb[i];
    zb[i] = -g2b[i];
  }
  solve_t<1>(Y.fadt, g2b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) g1b[i] = bdb[i] + h[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      adtb[i * 4 + j] = -(h[i] * Y.y[j]);
      phib[i * 4 + j] = adb[i * 4 + j] + g1b[i] * Y.z[j];
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc = (Y.phi[j] - (j == 0 ? 1.0f : 0.0f)) * g1b[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      acc += (Y.phi[i * 4 + j] - (i == j ? 1.0f : 0.0f)) * g1b[i];
    zb[j] += acc;
  }
  expm_reverse(Y, phis, phib, adtb);
  float bb[4], Ab[16];
  solve_t<1>(Y.fa, zb, bb);
  float dts_bar = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Ab[i * 4 + j] = -(bb[i] * Y.z[j]) + adtb[i * 4 + j] * Y.dts;
      dts_bar += adtb[i * 4 + j] * Y.A[i * 4 + j];
    }
  dtbar = kNsToS * dts_bar;
  // the linearization in reverse
  const Lin& L = Y.lin;
  const float tzw_b = -Ab[0];
  const float wn2_b = -Ab[1] + bb[0];
  const float sf_b = Ab[9] - Ab[10];
  const float df_b = Ab[14] - Ab[15];
  const float num_b = tzw_b / L.denom;
  const float denom_b = -(tzw_b * L.tzw + wn2_b * L.wn2) / L.denom;
  const float a_loop_b = wn2_b / L.denom;
  const float tau_in_b = num_b + denom_b * p[3];
  const float tau_mil_b = num_b * (L.a_amp + 1.0f) + denom_b * p[3];
  const float a_amp_b = num_b * L.tau_mil;
  const float tau_out_b = num_b + denom_b * (L.tau_in + L.tau_mil);
  ubar = -(tau_in_b * L.tau_in + tau_mil_b * L.tau_mil) / L.u;
  pbar[0] = tau_mil_b / L.u;
  pbar[1] = -a_amp_b * L.a_amp * L.a_amp;
  pbar[2] = -a_loop_b * L.a_loop * L.a_loop;
  pbar[3] = tau_out_b;
  pbar[4] = -sf_b * L.sf * L.sf;
  pbar[5] = -df_b * L.df * L.df;
  pbar[6] = tau_in_b / L.u;
}

__global__ void __launch_bounds__(32 * kWarps)
    pb_weight_bwd_kernel(const float* __restrict__ params,
                         const float* __restrict__ intensity,
                         const float* __restrict__ dt,
                         const float* __restrict__ g,
                         float* __restrict__ g_intensity,
                         float* __restrict__ g_dt,
                         float* __restrict__ partials, int S, int64_t M,
                         int o) {
  __shared__ WarpShared shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  if (m >= M) return;  // the whole warp
  WarpShared& sh = shared[warp];
  float p[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) p[k] = __ldg(params + k);
  const bool active = lane < S - 1;
  const float u = active ? __ldg(intensity + (lane + 1) * M + m) : 1.0f;
  const float dtv = active ? __ldg(dt + lane * M + m) : 1.0f;
  // the forward once more: (Ad, Bd, Bt), the carries, their cotangents
  if (active) {
    System Y;
    discretize(p, u, dtv, Y, nullptr);
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.ad[lane][i] = Y.phi[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sh.bd[lane][i] = Y.bd[i];
      sh.bt[lane][i] = Y.bt[i];
    }
  }
  __syncwarp();
  if (lane < o) {
    scan(sh, S, M, m, o, lane, nullptr);
    scan_reverse(sh, S, M, m, o, lane, g);
  }
  __syncwarp();
  float pbar[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) pbar[k] = 0.0f;
  if (active) {
    const int j = lane;
    // this system's cotangents, summed over the output rows
    float adb[16], bdb[4], btb[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) adb[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) bdb[i] = btb[i] = 0.0f;
    for (int r = 0; r < o; ++r) {
      const float gj = __ldg(g + (j * M + m) * o + r);
      const float gj1 = __ldg(g + ((j + 1) * M + m) * o + r);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ca = sh.c[j + 1][r][a];
        bdb[a] += gj * ca;
        btb[a] += gj1 * ca;
#pragma unroll
        for (int b = 0; b < 4; ++b) adb[a * 4 + b] += ca * sh.cbar[j][r][b];
      }
    }
    // the system again, keeping what its reverse needs
    System Y;
    float phis[kMaxSquarings][16];
    discretize(p, u, dtv, Y, phis);
    float ubar, dtbar;
    system_reverse(p, Y, phis, adb, bdb, btb, ubar, dtbar, pbar);
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
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) partials[m * kParams + k] = v;
  }
}

}  // namespace

extern "C" int pb_weight_fwd(const float* params, const float* intensity,
                             const float* dt, float* w, int32_t S, int64_t M,
                             int32_t o, cudaStream_t stream) {
  if (S < 2 || S - 1 > kMaxSystems || (o != 1 && o != 2) || M < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (M + kWarps - 1) / kWarps;
  pb_weight_fwd_kernel<<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      params, intensity, dt, w, S, M, o);
  return (int)cudaGetLastError();
}

extern "C" int pb_weight_bwd(const float* params, const float* intensity,
                             const float* dt, const float* g,
                             float* g_intensity, float* g_dt, float* partials,
                             int32_t S, int64_t M, int32_t o,
                             cudaStream_t stream) {
  if (S < 2 || S - 1 > kMaxSystems || (o != 1 && o != 2) || M < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (M + kWarps - 1) / kWarps;
  pb_weight_bwd_kernel<<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      params, intensity, dt, g, g_intensity, g_dt, partials, S, M, o);
  return (int)cudaGetLastError();
}
