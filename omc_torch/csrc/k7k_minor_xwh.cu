// K7t and K7x — the PSD slots of the rank-k Shor relaxation.
//
// K7t replaces, per node slot, minor and term, omc/sdp/shor_k.py: the
// per-term 5x5 minor gather of _forward_shor_k (:349-371), its w/u-step
// (:748-750, project_psd_ns_small of omc/ops/polar.py:127-162) and the dual
// EMA (:830-832):
//   f5 = sS [1, x; x, W/V]  (the four Xt corners of term t, the four Wt of
//        term t at their coordinates, V1a/V1b/V2a/V2b/V3 of term t)
//   t5 = alpha f5 + (1 - alpha) w5 + u5,   w5 = proj_PSD(t5) (sign schedule)
//   u5 = (t5 - w5) minor_mask,   acc += beta (rho u5 - acc).
// K7x replaces the (k+1)x(k+1) XWH slots of the same loop (:373-392 gather,
// :751-753 w/u-step with the same sign schedule, :833-835 EMA):
//   fx = sS [[1, Xt'], [Xt, M]],  M_tt = Wt[t], M_t1t2 = H[(t1, t2)],
// and, with t given, projects an (N, k+1, k+1) batch (projection mode).
//
// What bounds them on the H100: bytes.  K7t's 5x5 projection is 43 x 75
// = 3,225 FMAs on upper triangles (omc::project_psd_small_sym, K7's code)
// against 300 bytes of w/u/acc traffic plus 60 gathered; K7x's 3x3 one 43 x
// 18 = 774 FMAs against 216 bytes plus 28 gathered (at k = 4, 3,225 FMAs
// against 600 + 64 bytes), below the card's 20 flops a byte.  At
// BASELINE config 3's shape (B = 32, M5 = 1024, k = 2) K7t projects 65,536
// matrices and K7x 131,072.
//
// K7t is K7's design (csrc/k7_minor_psd.cu): one thread per matrix, its
// triangles in registers, threads numbered (b, l, t) with the term fastest,
// the order of the (B, M5, k, 5, 5) layout, so a CTA's 128 matrices are one
// contiguous block of w5, u5 and the EMA, staged through shared memory with
// 16-byte accesses and read at an odd 25-word stride.  A minor's indices
// come as one 64-byte record packed once per visit (the corners' flat
// entries, their coordinates, the five v entries): four 16-byte loads, the
// same for the k threads of the minor, then the gathers of term t, all
// independent.  Every slot value is exactly symmetric, so u = t - w uses the
// symmetrised T.  K7x runs the same design on its (k+1)x(k+1) slots, a
// template on D = k + 1 (3, 4 or 5) so the matrices stay in registers: one
// thread per coordinate, threads numbered (b, c) in the (B, C, D, D)
// layout's order, a CTA's 128 matrices of wx, ux and the EMA staged with
// 16-byte accesses, the coordinate's entry coord_flat[c] then its k Xt
// entries gathered while the blocks arrive; its projection mode stages t
// and w the same way.
//
// The float64 builds (omc_k7t_minor_k_f64, omc_k7x_xwh_f64: the slot mode
// only) follow omc's float64 route, which projects both slot families
// exactly (project_psd, omc/sdp/shor_k.py:748-753): the sign schedule
// stops at ~1e-4 relative and would floor a float64 run.  Each is K7's
// float64 build (csrc/k7_minor_psd.cu) on its own slots: one thread per
// matrix gathers and mixes t as above, keeps t in the u block of the
// staging, projects it by K4s's cyclic Jacobi in registers (k4s_jacobi.cuh:
// A's upper triangle and V, D (D + 1) / 2 + D^2 doubles) and writes
// V max(w, 0) V', the u-step and the EMA.  The staging of three blocks of
// doubles stays static shared memory: K7t takes 64 minors a CTA (38,400
// bytes); K7x 128 slots at D = 3 (27,648) and 64 at D = 4 and 5 (26,112
// and 38,400).  A matrix sits at an odd stride of doubles, so that a
// half-warp's 8-byte accesses (one matrix a lane) fall in distinct banks:
// D^2 at D = 3 and 5, 17 at D = 4 (D = 4's swizzle of 16-byte rows does
// not carry over to rows of 32 bytes); at D = 4 a 16-byte word of global
// memory goes to two 8-byte stores, the words of a matrix to its 17
// slots.  CPU mirrors: minor_k_step_plain and xwh_step_plain with
// ops.jacobi.k4s_project_psd.
//
// Every rank: K7t's thread does nothing that depends on k (its term is its
// index), so it takes any k as it is.  K7x's register kernels here stop at
// D = 5; past it (and where forced) its wide kernel (csrc/k7x_wide.cu)
// gives a slot to a warp and its matrices to memory, at any D.
#include "common.cuh"
#include "k4s_jacobi.cuh"

namespace {

constexpr int kThreads7 = 128;
constexpr int kD = 5;
constexpr int kD5 = kD * kD;
constexpr int kNT = omc::kTri<kD>;

using omc::tri;

__global__ void __launch_bounds__(kThreads7) k7t_kernel(K7tParams p) {
  // the CTA's blocks of w5, u5 and acc, kThreads7 matrices each
  __shared__ float4 k7t_smem[3 * kThreads7 * kD5 / 4];
  float* sw = reinterpret_cast<float*>(k7t_smem);
  float* su = sw + kThreads7 * kD5;
  float* sa = su + kThreads7 * kD5;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads7;
  const int cnt = min(kThreads7, p.B * p.M5 * p.k - base);
  const int nf = cnt * kD5;
  const size_t off = (size_t)base * kD5;
  omc::load_block<kThreads7>(p.w + off, sw, nf);
  omc::load_block<kThreads7>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::load_block<kThreads7>(p.acc + off, sa, nf);
  // gather term t of the minor's 15 distinct entries while the blocks arrive
  const bool act = tid < cnt;
  float x11 = 0.f, x12 = 0.f, x21 = 0.f, x22 = 0.f, w11 = 0.f, w12 = 0.f, w21 = 0.f, w22 = 0.f;
  float V1a = 0.f, V1b = 0.f, V2a = 0.f, V2b = 0.f, V3 = 0.f, sS = 0.f, mask = 0.f, rho = 0.f;
  if (act) {
    const int g = base + tid;  // (b, l, t), t fastest
    const int t = g % p.k;
    const int bl = g / p.k;    // b * M5 + l
    const int b = bl / p.M5;
    const int4* rec = reinterpret_cast<const int4*>(p.rec) + (size_t)bl * 4;
    const int4 cf = __ldg(rec), mc = __ldg(rec + 1), iv = __ldg(rec + 2), iw = __ldg(rec + 3);
    const size_t bt = (size_t)b * p.k + t;
    const float* X = p.Xt + bt * p.nm;
    const float* Wt = p.Wt + bt * p.C;
    x11 = __ldg(X + cf.x), x12 = __ldg(X + cf.y), x21 = __ldg(X + cf.z), x22 = __ldg(X + cf.w);
    w11 = __ldg(Wt + mc.x), w12 = __ldg(Wt + mc.y), w21 = __ldg(Wt + mc.z), w22 = __ldg(Wt + mc.w);
    V1a = __ldg(p.v1 + bt * p.P1 + iv.x);
    V1b = __ldg(p.v1 + bt * p.P1 + iv.y);
    V2a = __ldg(p.v2 + bt * p.P2 + iv.z);
    V2b = __ldg(p.v2 + bt * p.P2 + iv.w);
    V3 = __ldg(p.v3 + bt * p.P3 + iw.x);
    sS = __ldg(p.sS + b), mask = __ldg(p.minor_mask + bl), rho = __ldg(p.rho + b);
  }
  __syncthreads();
  if (act) {
    float* mw = sw + tid * kD5;
    float* mu = su + tid * kD5;
    float* ma = sa + tid * kD5;
    const float F[kD][kD] = {
        {1.f, x11, x12, x21, x22},
        {x11, w11, V1a, V2a, V3},
        {x12, V1a, w12, V3, V2b},
        {x21, V2a, V3, w21, V1b},
        {x22, V3, V2b, V1b, w22},
    };
    const float alpha = p.alpha, om = 1.0f - p.alpha;
    float T[kNT], W[kNT];
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = i; j < kD; ++j) {
        const float tij = (alpha * (sS * F[i][j]) + om * mw[i * kD + j]) + mu[i * kD + j];
        const float tji = (alpha * (sS * F[j][i]) + om * mw[j * kD + i]) + mu[j * kD + i];
        T[tri<kD>(i, j)] = i == j ? tij : 0.5f * (tij + tji);
      }
    omc::project_psd_small_sym<kD>(T, W);
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int q = i * kD + j;
        const float u = (T[tri<kD>(i, j)] - W[tri<kD>(i, j)]) * mask;
        mw[q] = W[tri<kD>(i, j)];
        mu[q] = u;
        if (p.acc != nullptr) ma[q] = ma[q] + p.beta * (rho * u - ma[q]);
      }
  }
  __syncthreads();
  omc::store_block<kThreads7>(p.w + off, sw, nf);
  omc::store_block<kThreads7>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::store_block<kThreads7>(p.acc + off, sa, nf);
}

// K7x's staged block: a CTA's kThreads7 matrices of D x D floats, in
// order.  Where D * D is odd (D = 3, 5) a thread reads its matrix at an odd
// stride, so a warp's reads fall in distinct banks; at D = 4 each row is one
// 16-byte word, and row i of matrix r sits at word i ^ ((r >> 1) & 3) of the
// matrix, so that the eight lanes of each quarter-warp read distinct banks.
__device__ __forceinline__ int row_word(int r, int i) { return 4 * r + (i ^ ((r >> 1) & 3)); }

template <int D>
__device__ __forceinline__ void stage_in(const float* __restrict__ g, float* s, int nf) {
  if constexpr (D == 4) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int q = threadIdx.x; q < nf / 4; q += kThreads7) s4[row_word(q >> 2, q & 3)] = g4[q];
  } else {
    omc::load_block<kThreads7>(g, s, nf);
  }
}

template <int D>
__device__ __forceinline__ void stage_out(float* __restrict__ g, const float* s, int nf) {
  if constexpr (D == 4) {
    float4* __restrict__ g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int q = threadIdx.x; q < nf / 4; q += kThreads7) g4[q] = s4[row_word(q >> 2, q & 3)];
  } else {
    omc::store_block<kThreads7>(g, s, nf);
  }
}

template <int D>
__device__ __forceinline__ void read_mat(const float* s, int r, float (&A)[D][D]) {
  if constexpr (D == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(s)[row_word(r, i)];
      A[i][0] = v.x, A[i][1] = v.y, A[i][2] = v.z, A[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) A[i][j] = s[r * D * D + i * D + j];
  }
}

template <int D>
__device__ __forceinline__ void write_mat(float* s, int r, const float (&A)[D][D]) {
  if constexpr (D == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(s)[row_word(r, i)] = make_float4(A[i][0], A[i][1], A[i][2], A[i][3]);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) s[r * D * D + i * D + j] = A[i][j];
  }
}

// One thread per matrix, threads numbered (b, c) in the layout's order, so a
// CTA's matrices are one contiguous block of each of w, u and acc (or of t
// and w in projection mode), staged through shared memory with 16-byte
// accesses; the gathers of the coordinate's Xt, Wt and H are issued before
// the block barrier.
template <int D>
__global__ void __launch_bounds__(kThreads7) k7x_kernel(K7xParams p) {
  constexpr int K = D - 1, KP = K * (K - 1) / 2, DD = D * D, NT = omc::kTri<D>;
  __shared__ float4 k7x_smem[3 * kThreads7 * DD / 4];
  float* sw = reinterpret_cast<float*>(k7x_smem);
  float* su = sw + kThreads7 * DD;
  float* sa = su + kThreads7 * DD;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads7;
  const int cnt = min(kThreads7, p.N - base);
  const int nf = cnt * DD;
  const size_t off = (size_t)base * DD;
  const bool act = tid < cnt;
  float T[NT], W[NT];
  if (p.t != nullptr) {
    // projection mode: w = proj_PSD(sym(t))
    stage_in<D>(p.t + off, sw, nf);
    __syncthreads();
    if (act) {
      float A[D][D];
      read_mat<D>(sw, tid, A);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = i; j < D; ++j) T[tri<D>(i, j)] = i == j ? A[i][i] : 0.5f * (A[i][j] + A[j][i]);
      omc::project_psd_small_sym<D>(T, W);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) A[i][j] = W[tri<D>(i, j)];
      write_mat<D>(sw, tid, A);
    }
    __syncthreads();
    stage_out<D>(p.w + off, sw, nf);
    return;
  }

  // slot mode: thread (b, c) projects the XWH slot of coordinate c of slot b
  stage_in<D>(p.w + off, sw, nf);
  stage_in<D>(p.u + off, su, nf);
  if (p.acc != nullptr) stage_in<D>(p.acc + off, sa, nf);
  // the slot's values [[1, Xt'], [Xt, M]] while the blocks arrive
  float F[D][D];
  float sS = 0.f, mask = 0.f, rho = 0.f;
  if (act) {
    const int g = base + tid, b = g / p.C, c = g - b * p.C;
    const int f = __ldg(p.coord_flat + g);
    F[0][0] = 1.0f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const size_t bt = (size_t)b * K + t;
      const float x = __ldg(p.Xt + bt * p.nm + f);
      F[0][t + 1] = x;
      F[t + 1][0] = x;
      F[t + 1][t + 1] = __ldg(p.Wt + bt * p.C + c);
    }
    int q = 0;
#pragma unroll
    for (int t1 = 0; t1 < K; ++t1)
#pragma unroll
      for (int t2 = t1 + 1; t2 < K; ++t2, ++q) {
        const float h = __ldg(p.Hh + ((size_t)b * KP + q) * p.C + c);
        F[t1 + 1][t2 + 1] = h;
        F[t2 + 1][t1 + 1] = h;
      }
    sS = __ldg(p.sS + b), mask = __ldg(p.coord_mask + g), rho = __ldg(p.rho + b);
  }
  __syncthreads();
  if (act) {
    const float alpha = p.alpha, om = 1.0f - p.alpha;
    float Wm[D][D], Um[D][D];
    read_mat<D>(sw, tid, Wm);
    read_mat<D>(su, tid, Um);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        const float tij = (alpha * (sS * F[i][j]) + om * Wm[i][j]) + Um[i][j];
        const float tji = (alpha * (sS * F[j][i]) + om * Wm[j][i]) + Um[j][i];
        T[tri<D>(i, j)] = i == j ? tij : 0.5f * (tij + tji);
      }
    omc::project_psd_small_sym<D>(T, W);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        Wm[i][j] = W[tri<D>(i, j)];
        Um[i][j] = (T[tri<D>(i, j)] - W[tri<D>(i, j)]) * mask;
      }
    write_mat<D>(sw, tid, Wm);
    write_mat<D>(su, tid, Um);
    if (p.acc != nullptr) {
      float Am[D][D];
      read_mat<D>(sa, tid, Am);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) Am[i][j] = Am[i][j] + p.beta * (rho * Um[i][j] - Am[i][j]);
      write_mat<D>(sa, tid, Am);
    }
  }
  __syncthreads();
  stage_out<D>(p.w + off, sw, nf);
  stage_out<D>(p.u + off, su, nf);
  if (p.acc != nullptr) stage_out<D>(p.acc + off, sa, nf);
}

// ---- the float64 builds ----

constexpr int kThreads7t64 = 64;  // K7t's float64 build's minors a CTA

// The float64 build of K7t: the per-term minor slots' gather, mix, exact
// projection by Jacobi, u-step and EMA (see the header).
__global__ void __launch_bounds__(kThreads7t64) k7t_kernel_f64(K7tParamsT<double> p) {
  __shared__ double2 k7t_smem_d[3 * kThreads7t64 * kD5 / 2];
  double* sw = reinterpret_cast<double*>(k7t_smem_d);
  double* su = sw + kThreads7t64 * kD5;
  double* sa = su + kThreads7t64 * kD5;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads7t64;
  const int cnt = min(kThreads7t64, p.B * p.M5 * p.k - base);
  const int nf = cnt * kD5;
  const size_t off = (size_t)base * kD5;
  omc::load_block<kThreads7t64>(p.w + off, sw, nf);
  omc::load_block<kThreads7t64>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::load_block<kThreads7t64>(p.acc + off, sa, nf);
  // gather term t of the minor's 15 distinct entries while the blocks arrive
  const bool act = tid < cnt;
  double x11 = 0, x12 = 0, x21 = 0, x22 = 0, w11 = 0, w12 = 0, w21 = 0, w22 = 0;
  double V1a = 0, V1b = 0, V2a = 0, V2b = 0, V3 = 0, sS = 0, mask = 0, rho = 0;
  if (act) {
    const int g = base + tid;  // (b, l, t), t fastest
    const int t = g % p.k;
    const int bl = g / p.k;    // b * M5 + l
    const int b = bl / p.M5;
    const int4* rec = reinterpret_cast<const int4*>(p.rec) + (size_t)bl * 4;
    const int4 cf = __ldg(rec), mc = __ldg(rec + 1), iv = __ldg(rec + 2), iw = __ldg(rec + 3);
    const size_t bt = (size_t)b * p.k + t;
    const double* X = p.Xt + bt * p.nm;
    const double* Wt = p.Wt + bt * p.C;
    x11 = __ldg(X + cf.x), x12 = __ldg(X + cf.y), x21 = __ldg(X + cf.z), x22 = __ldg(X + cf.w);
    w11 = __ldg(Wt + mc.x), w12 = __ldg(Wt + mc.y), w21 = __ldg(Wt + mc.z), w22 = __ldg(Wt + mc.w);
    V1a = __ldg(p.v1 + bt * p.P1 + iv.x);
    V1b = __ldg(p.v1 + bt * p.P1 + iv.y);
    V2a = __ldg(p.v2 + bt * p.P2 + iv.z);
    V2b = __ldg(p.v2 + bt * p.P2 + iv.w);
    V3 = __ldg(p.v3 + bt * p.P3 + iw.x);
    sS = __ldg(p.sS + b), mask = __ldg(p.minor_mask + bl), rho = __ldg(p.rho + b);
  }
  __syncthreads();
  if (act) {
    double* mw = sw + tid * kD5;
    double* mu = su + tid * kD5;
    double* ma = sa + tid * kD5;
    const double F[kD][kD] = {
        {1.0, x11, x12, x21, x22},
        {x11, w11, V1a, V2a, V3},
        {x12, V1a, w12, V3, V2b},
        {x21, V2a, V3, w21, V1b},
        {x22, V3, V2b, V1b, w22},
    };
    const double alpha = p.alpha, om = 1.0 - p.alpha;
    // t5 = sym(alpha f5 + (1 - alpha) w5 + u5): A's upper triangle, and in
    // the u5 block for the u-step
    double A[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = i; j < kD; ++j) {
        const double tij = (alpha * (sS * F[i][j]) + om * mw[i * kD + j]) + mu[i * kD + j];
        const double tji = (alpha * (sS * F[j][i]) + om * mw[j * kD + i]) + mu[j * kD + i];
        const double t = i == j ? tij : 0.5 * (tij + tji);
        A[i][j] = t;
        mu[i * kD + j] = t;
        mu[j * kD + i] = t;
      }
    const double beta = p.beta;
    const bool ema = p.acc != nullptr;
    k4s::project_psd<kD>(A, [&](int i, int j, double w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && i == j) break;
        const int q = h == 0 ? i * kD + j : j * kD + i;
        const double u = (mu[q] - w) * mask;
        mw[q] = w;
        mu[q] = u;
        if (ema) ma[q] = ma[q] + beta * (rho * u - ma[q]);
      }
    });
  }
  __syncthreads();
  omc::store_block<kThreads7t64>(p.w + off, sw, nf);
  omc::store_block<kThreads7t64>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::store_block<kThreads7t64>(p.acc + off, sa, nf);
}

// K7x's float64 build: slots a CTA and the odd stride (in doubles) of a
// staged D x D matrix
template <int D>
struct K7x64 {
  static constexpr int kThreads = D == 3 ? 128 : 64;
  static constexpr int kLd = (D * D) | 1;
};

// nf doubles of a CTA's D x D matrices from global g (16-byte aligned) into
// shared s at stride kLd, and back: contiguous where kLd = D^2; at D = 4
// each 16-byte word of g (two doubles of one matrix, one of its 8 words)
// goes to two 8-byte slots, consecutive lanes on consecutive words
template <int D>
__device__ __forceinline__ void stage_in_f64(const double* __restrict__ g, double* s, int nf) {
  constexpr int NT = K7x64<D>::kThreads, LD = K7x64<D>::kLd, DD = D * D;
  if constexpr (LD == DD) {
    omc::load_block<NT>(g, s, nf);
  } else {
    const double2* __restrict__ g2 = reinterpret_cast<const double2*>(g);
    for (int q = threadIdx.x; q < nf / 2; q += NT) {
      const double2 v = g2[q];
      double* d = s + (q / (DD / 2)) * LD + 2 * (q % (DD / 2));
      d[0] = v.x, d[1] = v.y;
    }
  }
}

template <int D>
__device__ __forceinline__ void stage_out_f64(double* __restrict__ g, const double* s, int nf) {
  constexpr int NT = K7x64<D>::kThreads, LD = K7x64<D>::kLd, DD = D * D;
  if constexpr (LD == DD) {
    omc::store_block<NT>(g, s, nf);
  } else {
    double2* __restrict__ g2 = reinterpret_cast<double2*>(g);
    for (int q = threadIdx.x; q < nf / 2; q += NT) {
      const double* d = s + (q / (DD / 2)) * LD + 2 * (q % (DD / 2));
      g2[q] = make_double2(d[0], d[1]);
    }
  }
}

// The float64 build of K7x's slot mode: the XWH slots' gather, mix, exact
// projection by Jacobi, u-step and EMA, one thread per coordinate (see the
// header)
template <int D>
__global__ void __launch_bounds__(K7x64<D>::kThreads) k7x_kernel_f64(K7xParamsT<double> p) {
  constexpr int K = D - 1, KP = K * (K - 1) / 2;
  constexpr int NT = K7x64<D>::kThreads, LD = K7x64<D>::kLd;
  __shared__ double2 k7x_smem_d[(3 * NT * LD + 1) / 2];
  double* sw = reinterpret_cast<double*>(k7x_smem_d);
  double* su = sw + NT * LD;
  double* sa = su + NT * LD;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * NT;
  const int cnt = min(NT, p.N - base);
  const int nf = cnt * D * D;
  const size_t off = (size_t)base * D * D;
  const bool act = tid < cnt;
  stage_in_f64<D>(p.w + off, sw, nf);
  stage_in_f64<D>(p.u + off, su, nf);
  if (p.acc != nullptr) stage_in_f64<D>(p.acc + off, sa, nf);
  // the slot's values [[1, Xt'], [Xt, M]] while the blocks arrive
  double F[D][D];
  double sS = 0, mask = 0, rho = 0;
  if (act) {
    const int g = base + tid, b = g / p.C, c = g - b * p.C;
    const int f = __ldg(p.coord_flat + g);
    F[0][0] = 1.0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const size_t bt = (size_t)b * K + t;
      const double x = __ldg(p.Xt + bt * p.nm + f);
      F[0][t + 1] = x;
      F[t + 1][0] = x;
      F[t + 1][t + 1] = __ldg(p.Wt + bt * p.C + c);
    }
    int q = 0;
#pragma unroll
    for (int t1 = 0; t1 < K; ++t1)
#pragma unroll
      for (int t2 = t1 + 1; t2 < K; ++t2, ++q) {
        const double h = __ldg(p.Hh + ((size_t)b * KP + q) * p.C + c);
        F[t1 + 1][t2 + 1] = h;
        F[t2 + 1][t1 + 1] = h;
      }
    sS = __ldg(p.sS + b), mask = __ldg(p.coord_mask + g), rho = __ldg(p.rho + b);
  }
  __syncthreads();
  if (act) {
    double* mw = sw + tid * LD;
    double* mu = su + tid * LD;
    double* ma = sa + tid * LD;
    const double alpha = p.alpha, om = 1.0 - p.alpha;
    // tx = sym(alpha fx + (1 - alpha) wx + ux): A's upper triangle, and in
    // the ux block for the u-step
    double A[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        const double tij = (alpha * (sS * F[i][j]) + om * mw[i * D + j]) + mu[i * D + j];
        const double tji = (alpha * (sS * F[j][i]) + om * mw[j * D + i]) + mu[j * D + i];
        const double t = i == j ? tij : 0.5 * (tij + tji);
        A[i][j] = t;
        mu[i * D + j] = t;
        mu[j * D + i] = t;
      }
    const double beta = p.beta;
    const bool ema = p.acc != nullptr;
    k4s::project_psd<D>(A, [&](int i, int j, double w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && i == j) break;
        const int q = h == 0 ? i * D + j : j * D + i;
        const double u = (mu[q] - w) * mask;
        mw[q] = w;
        mu[q] = u;
        if (ema) ma[q] = ma[q] + beta * (rho * u - ma[q]);
      }
    });
  }
  __syncthreads();
  stage_out_f64<D>(p.w + off, sw, nf);
  stage_out_f64<D>(p.u + off, su, nf);
  if (p.acc != nullptr) stage_out_f64<D>(p.acc + off, sa, nf);
}

}  // namespace

OMC_EXPORT int omc_k7t_minor_k(const K7tParams* params, void* stream) {
  const K7tParams p = *params;
  const int N = p.B * p.M5 * p.k;
  if (N > 0) k7t_kernel<<<(N + kThreads7 - 1) / kThreads7, kThreads7, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

OMC_EXPORT int omc_k7x_xwh(const K7xParams* params, void* stream) {
  const K7xParams p = *params;
  // the staged blocks move as 16-byte words
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (odd(p.w) || odd(p.t) || (p.t == nullptr && (odd(p.u) || odd(p.acc))))
    return (int)cudaErrorInvalidValue;
  if (p.N > 0) {
    const int grid = (p.N + kThreads7 - 1) / kThreads7;
    cudaStream_t s = (cudaStream_t)stream;
    switch (p.k) {
      case 2: k7x_kernel<3><<<grid, kThreads7, 0, s>>>(p); break;
      case 3: k7x_kernel<4><<<grid, kThreads7, 0, s>>>(p); break;
      case 4: k7x_kernel<5><<<grid, kThreads7, 0, s>>>(p); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// minors (threads) a CTA of K7t and its static staging bytes, for the
// operands' element size (4, or 8 for the float64 build), and K7x's at
// D = k + 1 (sdp.shor_k.k7t_plan and k7x_plan plan with them, chip_smoke.py
// holds the plans against them)
OMC_EXPORT int omc_k7t_threads(int elem) { return elem == 8 ? kThreads7t64 : kThreads7; }

OMC_EXPORT long long omc_k7t_smem_bytes(int elem) {
  return 3LL * omc_k7t_threads(elem) * kD5 * elem;
}

OMC_EXPORT int omc_k7x_threads(int elem, int D) {
  if (elem != 8) return kThreads7;
  return D == 3 ? K7x64<3>::kThreads : D == 4 ? K7x64<4>::kThreads : K7x64<5>::kThreads;
}

OMC_EXPORT long long omc_k7x_smem_bytes(int elem, int D) {
  const int ld = elem == 8 ? (D * D) | 1 : D * D;
  return 3LL * omc_k7x_threads(elem, D) * ld * elem;
}

OMC_EXPORT int omc_k7t_minor_k_f64(const K7tParamsT<double>* params, void* stream) {
  const K7tParamsT<double> p = *params;
  const int N = p.B * p.M5 * p.k;
  if (N > 0)
    k7t_kernel_f64<<<(N + kThreads7t64 - 1) / kThreads7t64, kThreads7t64, 0,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

namespace {

template <int D>
void launch_k7x_f64(const K7xParamsT<double>& p, cudaStream_t s) {
  constexpr int NT = K7x64<D>::kThreads;
  k7x_kernel_f64<D><<<(p.N + NT - 1) / NT, NT, 0, s>>>(p);
}

}  // namespace

OMC_EXPORT int omc_k7x_xwh_f64(const K7xParamsT<double>* params, void* stream) {
  const K7xParamsT<double> p = *params;
  // no projection mode in float64 (K4s's float64 build serves it); the
  // staged blocks move as 16-byte words
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (p.t != nullptr || odd(p.w) || odd(p.u) || odd(p.acc)) return (int)cudaErrorInvalidValue;
  if (p.N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (p.k) {
      case 2: launch_k7x_f64<3>(p, s); break;
      case 3: launch_k7x_f64<4>(p, s); break;
      case 4: launch_k7x_f64<5>(p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
