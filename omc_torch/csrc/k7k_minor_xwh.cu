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
// What bounds them on the H100: fp32 FMAs.  K7t's 5x5 projection is 43 x 75
// = 3,225 FMAs on upper triangles (omc::project_psd_small_sym, K7's code)
// against 300 bytes of w/u/acc traffic plus 60 gathered; a 3x3 one of K7x
// 43 x 27 = 1,161 FMAs (full products, omc::project_psd_small) against 108
// + 16 bytes.  At BASELINE config 3's shape (B = 32, M5 = 1024, k = 2) K7t
// projects 65,536 matrices and K7x 131,072.
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
// symmetrised T.  K7x is a template on D = k + 1 (3, 4 or 5) so the matrices
// stay in registers, one thread per coordinate, no shared memory.
#include "common.cuh"

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
