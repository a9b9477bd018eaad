// K6 — altmin's masked ridge steps.
//
// Replaces omc/ops/linalg.py:15-50 (v_step, u_step_unconstrained), called
// by omc/altmin.py:53-152 once per altmin iteration each; in the port
// omc_torch.ops.linalg.v_step / u_step_unconstrained on CUDA.
//
// V-step: per node slot b and column j of V,
//   G_j = sum_i mask_ij u_i u_i' + (1/gamma) U'U + eps I,
//   rhs_j = sum_i mask_ij A_ij u_i,   G_j v_j = rhs_j   (u_i = U[b, i, :]).
// The U-step is the same with the roles of rows and columns exchanged:
// per row i of U, H_i = sum_j mask_ij v_j v_j' + (1/gamma) V V' + eps I and
// rhs_i = sum_j mask_ij A_ij v_j.  One kernel serves both: it reduces over
// index r and solves for output o, reading mask and A at r * s_r + o * s_o.
//
// Design: one CTA (one warp) per (slot, tile of 32 outputs); each CTA
// recomputes (1/gamma) F'F for its slot (R k^2 work, cheap beside the
// masked sums).  The reduction runs over chunks of 32 r: the chunk's 32 x 32
// tiles of mask and A are staged through shared memory (coalesced for both
// steps, so the U-step reads the row-major mask without a transpose) with
// the chunk's k-vectors of the factor; each lane then accumulates its own
// output's packed lower-triangular Gram and right-hand side, kept in shared
// memory as [entry][lane] (k <= 10: a 10 x 10 factor per lane does not fit
// registers), r in order, so the result does not depend on the launch.
// Then each lane factors its k x k system by Cholesky (SPD: the ridge) and
// solves; k = 1 divides, as the plain version does.  What bounds it on the
// H100: 2 (k^2 + k) flops per observed entry and slot against reading the
// n x m mask and A once, bytes-bound and launch-dominated at the headline's
// n = m = 50.
#include "common.cuh"

namespace {

constexpr int kTile = 32, kMaxK = 10, kTri = kMaxK * (kMaxK + 1) / 2;

struct Geom {
  int R, O;              // reduction length, outputs
  long long fB, fr, fl;  // factor (b, r, l) strides
  int sr, so;            // mask / A (r, o) strides
  long long oB, oo, ol;  // output (b, o, l) strides
};

__device__ __forceinline__ int tri(int a) { return a * (a + 1) / 2; }

__global__ void __launch_bounds__(kTile) k6_kernel(K6Params p, Geom g) {
  __shared__ float G[kTri][kTile];
  __shared__ float rhs[kMaxK][kTile];
  __shared__ float gram[kTri];
  __shared__ float fac[kTile][kMaxK];
  __shared__ float mt[kTile][kTile + 1], at[kTile][kTile + 1];
  const int lane = threadIdx.x, b = blockIdx.y, o0 = blockIdx.x * kTile;
  const int k = p.k, nt = tri(k);
  const float* F = p.F + b * g.fB;

  // (1/gamma) F'F, r in order
  for (int e = lane; e < nt; e += kTile) {
    int a = 0;
    while (tri(a + 1) <= e) ++a;
    const int c = e - tri(a);
    float s = 0.f;
    for (int r = 0; r < g.R; ++r) s = fmaf(F[r * g.fr + a * g.fl], F[r * g.fr + c * g.fl], s);
    gram[e] = p.inv_gamma * s;
  }
  for (int e = 0; e < nt; ++e) G[e][lane] = 0.f;
  for (int a = 0; a < k; ++a) rhs[a][lane] = 0.f;

  for (int r0 = 0; r0 < g.R; r0 += kTile) {
    __syncthreads();
    for (int e = 0; e < kTile; ++e) {
      // coalesced: lanes walk the stride-1 axis of the (n, m) arrays
      const int rl = g.so == 1 ? e : lane, ol = g.so == 1 ? lane : e;
      const int r = r0 + rl, o = o0 + ol;
      const bool in = r < g.R && o < g.O;
      const long long at_ = (long long)r * g.sr + (long long)o * g.so;
      mt[rl][ol] = in ? p.mask[at_] : 0.f;
      at[rl][ol] = in ? p.A[at_] : 0.f;
    }
    for (int e = lane; e < kTile * k; e += kTile) {
      const int rl = e / k, l = e - rl * k;
      fac[rl][l] = r0 + rl < g.R ? F[(r0 + rl) * g.fr + l * g.fl] : 0.f;
    }
    __syncthreads();
    const int rend = min(kTile, g.R - r0);
    for (int rl = 0; rl < rend; ++rl) {
      const float w = mt[rl][lane], aw = w * at[rl][lane];
      for (int a = 0; a < k; ++a) {
        const float ua = fac[rl][a];
        rhs[a][lane] = fmaf(aw, ua, rhs[a][lane]);
        const float wu = w * ua;
        for (int c = 0; c <= a; ++c) G[tri(a) + c][lane] = fmaf(wu, fac[rl][c], G[tri(a) + c][lane]);
      }
    }
  }
  const int o = o0 + lane;
  if (o >= g.O) return;
  for (int a = 0; a < k; ++a) {
    for (int c = 0; c <= a; ++c) G[tri(a) + c][lane] += gram[tri(a) + c];
    G[tri(a) + a][lane] += p.ridge_eps;
  }
  float* out = p.out + b * g.oB + o * g.oo;
  if (k == 1) {
    out[0] = rhs[0][lane] / G[0][lane];
    return;
  }
  // Cholesky G = L L' in place (packed lower), then L y = rhs, L' x = y
  for (int j = 0; j < k; ++j) {
    float djj = G[tri(j) + j][lane];
    for (int q = 0; q < j; ++q) djj -= G[tri(j) + q][lane] * G[tri(j) + q][lane];
    djj = sqrtf(djj);
    G[tri(j) + j][lane] = djj;
    for (int i = j + 1; i < k; ++i) {
      float v = G[tri(i) + j][lane];
      for (int q = 0; q < j; ++q) v -= G[tri(i) + q][lane] * G[tri(j) + q][lane];
      G[tri(i) + j][lane] = v / djj;
    }
  }
  for (int i = 0; i < k; ++i) {
    float v = rhs[i][lane];
    for (int q = 0; q < i; ++q) v -= G[tri(i) + q][lane] * rhs[q][lane];
    rhs[i][lane] = v / G[tri(i) + i][lane];
  }
  for (int i = k - 1; i >= 0; --i) {
    float v = rhs[i][lane];
    for (int q = i + 1; q < k; ++q) v -= G[tri(q) + i][lane] * rhs[q][lane];
    rhs[i][lane] = v / G[tri(i) + i][lane];
  }
  for (int l = 0; l < k; ++l) out[l * g.ol] = rhs[l][lane];
}

int launch(const K6Params& p, const Geom& g, void* stream) {
  if (p.k < 1 || p.k > kMaxK) return (int)cudaErrorInvalidValue;
  dim3 grid((g.O + kTile - 1) / kTile, p.B);
  k6_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(p, g);
  return (int)cudaGetLastError();
}

}  // namespace

// V-step: U (B, n, k) fixed, V (B, k, m) solved per column j; r = row i
OMC_EXPORT int omc_k6_vstep(const K6Params* params, void* stream) {
  const K6Params p = *params;
  const Geom g{p.n, p.m, (long long)p.n * p.k, p.k, 1, p.m, 1,
               (long long)p.k * p.m, 1, p.m};
  return launch(p, g, stream);
}

// U-step: V (B, k, m) fixed, U (B, n, k) solved per row i; r = column j
OMC_EXPORT int omc_k6_ustep(const K6Params* params, void* stream) {
  const K6Params p = *params;
  const Geom g{p.m, p.n, (long long)p.k * p.m, 1, p.m, 1, p.m,
               (long long)p.n * p.k, p.k, 1};
  return launch(p, g, stream);
}
