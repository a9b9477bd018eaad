// K7t and K7x — the PSD slots of the rank-k Shor relaxation.
//
// K7t replaces, per node slot, minor and term, omc/sdp/shor_k.py: the
// per-term 5x5 minor gather of _forward_shor_k (:349-371), its w/u-step
// (:748-750, project_psd_ns_small of omc/ops/polar.py:127-162) and the dual
// EMA (:830-832):
//   f5 = sS [1, x; x, W/V]  (the four Xt corners of term t through
//        coord_flat[mc], the four Wt of term t through mc, V1a/V1b/V2a/V2b/V3
//        of term t through iv*)
//   t5 = alpha f5 + (1 - alpha) w5 + u5,   w5 = proj_PSD(t5) (sign schedule)
//   u5 = (t5 - w5) minor_mask,   acc += beta (rho u5 - acc).
// K7x replaces the (k+1)x(k+1) XWH slots of the same loop (:373-392 gather,
// :751-753 w/u-step with the same sign schedule, :833-835 EMA):
//   fx = sS [[1, Xt'], [Xt, M]],  M_tt = Wt[t], M_t1t2 = H[(t1, t2)],
// and, with t given, projects an (N, k+1, k+1) batch (projection mode).
//
// What bounds them on the H100: fp32 FMAs.  One 5x5 projection is 43 x 125
// = 5,375 FMAs against 300 bytes of w/u/acc traffic plus 60 gathered; a 3x3
// one 43 x 27 = 1,161 FMAs against 108 + 16 bytes.  At BASELINE config 3's
// shape (B = 32, M5 = 1024, k = 2) K7t projects 65,536 matrices and K7x
// 131,072.  Design: one thread per matrix with the working matrices in
// registers (omc::project_psd_small<D> in common.cuh, the code K7 runs):
// no shared memory, no synchronisation, no tensor cores.  K7t numbers its
// threads (b, l, t) with the term fastest, the order of the (B, M5, k, 5, 5)
// layout, so neighbouring threads touch neighbouring w5/u5/acc matrices; K7x
// is a template on D = k + 1 (3, 4 or 5) so the matrices stay in registers.
// Every slot value is exactly symmetric, so u = t - w uses the symmetrised T.
#include "common.cuh"

namespace {

constexpr int kThreads7 = 128;

__global__ void __launch_bounds__(kThreads7) k7t_kernel(K7tParams p) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // (b, l, t), t fastest
  if (g >= p.B * p.M5 * p.k) return;
  const int t = g % p.k;
  const int bl = g / p.k;  // b * M5 + l
  const int b = bl / p.M5;
  const size_t bt = (size_t)b * p.k + t;
  const int* mc = p.mc + (size_t)bl * 4;
  const int* cf = p.coord_flat + (size_t)b * p.C;
  const float* X = p.Xt + bt * p.nm;
  const float* Wt = p.Wt + bt * p.C;
  const float x11 = X[cf[mc[0]]], x12 = X[cf[mc[1]]], x21 = X[cf[mc[2]]], x22 = X[cf[mc[3]]];
  const float w11 = Wt[mc[0]], w12 = Wt[mc[1]], w21 = Wt[mc[2]], w22 = Wt[mc[3]];
  const float V1a = p.v1[bt * p.P1 + p.iv1a[bl]];
  const float V1b = p.v1[bt * p.P1 + p.iv1b[bl]];
  const float V2a = p.v2[bt * p.P2 + p.iv2a[bl]];
  const float V2b = p.v2[bt * p.P2 + p.iv2b[bl]];
  const float V3 = p.v3[bt * p.P3 + p.iv3[bl]];
  const float F[5][5] = {
      {1.f, x11, x12, x21, x22},
      {x11, w11, V1a, V2a, V3},
      {x12, V1a, w12, V3, V2b},
      {x21, V2a, V3, w21, V1b},
      {x22, V3, V2b, V1b, w22},
  };
  const size_t off = (size_t)g * 25;
  const float sS = p.sS[b], alpha = p.alpha, om = 1.0f - p.alpha;
  float T[5][5], W[5][5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const size_t q = off + i * 5 + j;
      T[i][j] = (alpha * (sS * F[i][j]) + om * p.w[q]) + p.u[q];
    }
  omc::project_psd_small<5>(T, W);
  const float mask = p.minor_mask[bl], rho = p.rho[b];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const size_t q = off + i * 5 + j;
      const float u = (T[i][j] - W[i][j]) * mask;
      p.w[q] = W[i][j];
      p.u[q] = u;
      if (p.acc != nullptr) p.acc[q] = p.acc[q] + p.beta * (rho * u - p.acc[q]);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads7) k7x_kernel(K7xParams p) {
  constexpr int K = D - 1;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.N) return;
  const size_t off = (size_t)g * D * D;
  float T[D][D], W[D][D];
  if (p.t != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) T[i][j] = p.t[off + i * D + j];
    omc::project_psd_small<D>(T, W);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) p.w[off + i * D + j] = W[i][j];
    return;
  }

  // slot mode: one thread per (b, coordinate c)
  const int b = g / p.C, c = g % p.C;
  const int f = p.coord_flat[g];
  float F[D][D];
  F[0][0] = 1.0f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float x = p.Xt[((size_t)b * K + t) * p.nm + f];
    F[0][t + 1] = x;
    F[t + 1][0] = x;
    F[t + 1][t + 1] = p.Wt[((size_t)b * K + t) * p.C + c];
  }
  int q = 0;
#pragma unroll
  for (int t1 = 0; t1 < K; ++t1)
#pragma unroll
    for (int t2 = t1 + 1; t2 < K; ++t2, ++q) {
      const float h = p.Hh[((size_t)b * (K * (K - 1) / 2) + q) * p.C + c];
      F[t1 + 1][t2 + 1] = h;
      F[t2 + 1][t1 + 1] = h;
    }
  const float sS = p.sS[b], alpha = p.alpha, om = 1.0f - p.alpha;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const size_t e = off + i * D + j;
      T[i][j] = (alpha * (sS * F[i][j]) + om * p.w[e]) + p.u[e];
    }
  omc::project_psd_small<D>(T, W);
  const float mask = p.coord_mask[g], rho = p.rho[b];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const size_t e = off + i * D + j;
      const float u = (T[i][j] - W[i][j]) * mask;
      p.w[e] = W[i][j];
      p.u[e] = u;
      if (p.acc != nullptr) p.acc[e] = p.acc[e] + p.beta * (rho * u - p.acc[e]);
    }
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
