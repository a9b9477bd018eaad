// K7 — sign-schedule PSD projection of the 5x5 Shor minor slots.
//
// Replaces omc/ops/polar.py: project_psd_ns_small (:127-162) and, in its
// fused mode, the minor-slot step of the Shor ADMM loop (omc/sdp/admm_shor.py
// :149-167 gather, :420-422 w/u-step, :492 EMA):
//   f5 = sS [1, x; x, W/V]  (15 distinct entries gathered from Xs, Ws, v1-v3)
//   t5 = alpha f5 + (1 - alpha) w5 + u5
//   w5 = (T + sign(T) T) / 2  (T = sym(t5); sign from 12 quintic + 2 cubic
//        odd-polynomial steps on T / ||T||_F, 43 5x5 products in series)
//   u5 = (t5 - w5) mask,   acc += beta (rho u5 - acc).
// Without the fused mode it projects a given (N, 5, 5) batch.
//
// What bounds it on the H100: fp32 FMAs.  One matrix is 43 x 125 = 5,375
// FMAs against 300 bytes of w5/u5/acc traffic (plus 60 gathered), ~18 FMAs
// per byte; at config 2 there are up to 32 x 4096 = 131,072 matrices, so the
// whole card is busy.  omc laid the batch along the TPU's lanes to keep the
// 5x5 products off the matrix unit; here the same idea is one thread per
// matrix with all four working matrices (T, S, S^2, S^4 / products) in
// registers (omc::project_psd_small in common.cuh, shared with K7t/K7x): no
// shared memory, no synchronisation, full fp32 FMAs, no tensor cores.  The t5 of a minor is exactly symmetric (every input slot
// is), so u5 = t5 - w5 uses the symmetrised T.
#include "common.cuh"

namespace {

constexpr int kD = 5;
constexpr int kThreads7 = 128;

typedef float Mat5[kD][kD];

__global__ void __launch_bounds__(kThreads7) k7_kernel(K7Params p) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.N) return;
  const size_t off = (size_t)g * kD * kD;
  Mat5 T, W;
  if (p.t != nullptr) {
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = 0; j < kD; ++j) T[i][j] = p.t[off + i * kD + j];
    omc::project_psd_small<kD>(T, W);
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = 0; j < kD; ++j) p.w[off + i * kD + j] = W[i][j];
    return;
  }

  // fused mode: gather the minor's 15 distinct entries (omc _forward_shor)
  const int b = g / p.M5;
  const int* mi = p.minor_idx + (size_t)g * 4;
  const int i1 = mi[0], i2 = mi[1], j1 = mi[2], j2 = mi[3];
  const float* X = p.Xs + (size_t)b * p.nm;
  const float* Wv = p.Ws + (size_t)b * p.nm;
  const int f11 = i1 * p.m + j1, f12 = i1 * p.m + j2;
  const int f21 = i2 * p.m + j1, f22 = i2 * p.m + j2;
  const float x11 = X[f11], x12 = X[f12], x21 = X[f21], x22 = X[f22];
  const float w11 = Wv[f11], w12 = Wv[f12], w21 = Wv[f21], w22 = Wv[f22];
  const float V1a = p.v1[(size_t)b * p.P1 + p.iv1a[g]];
  const float V1b = p.v1[(size_t)b * p.P1 + p.iv1b[g]];
  const float V2a = p.v2[(size_t)b * p.P2 + p.iv2a[g]];
  const float V2b = p.v2[(size_t)b * p.P2 + p.iv2b[g]];
  const float V3 = p.v3[(size_t)b * p.P3 + p.iv3[g]];
  const Mat5 F = {
      {1.f, x11, x12, x21, x22},
      {x11, w11, V1a, V2a, V3},
      {x12, V1a, w12, V3, V2b},
      {x21, V2a, V3, w21, V1b},
      {x22, V3, V2b, V1b, w22},
  };
  const float sS = p.sS[b], alpha = p.alpha, om = 1.0f - p.alpha;
#pragma unroll
  for (int i = 0; i < kD; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const size_t q = off + i * kD + j;
      T[i][j] = (alpha * (sS * F[i][j]) + om * p.w[q]) + p.u[q];
    }
  omc::project_psd_small<kD>(T, W);
  const float mask = p.minor_mask[g], rho = p.rho[b];
#pragma unroll
  for (int i = 0; i < kD; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const size_t q = off + i * kD + j;
      const float u = (T[i][j] - W[i][j]) * mask;
      p.w[q] = W[i][j];
      p.u[q] = u;
      if (p.acc != nullptr) p.acc[q] = p.acc[q] + p.beta * (rho * u - p.acc[q]);
    }
}

}  // namespace

OMC_EXPORT int omc_k7_minor_psd(const K7Params* params, void* stream) {
  const K7Params p = *params;
  if (p.N > 0) {
    const int grid = (p.N + kThreads7 - 1) / kThreads7;
    k7_kernel<<<grid, kThreads7, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
