// K9s, K9a and K9b — the McCormick relaxation's factorisations, z-step and
// cone step (the use_disjunctive_cuts=False path).
//
// K9s replaces the rho-free factorisations of omc/sdp/mccormick.py
// (make_mccormick_solver, :385-417): per row i the Gram
//   M_i = R_i' R_i + diag(4 I_k, 0_q) + 1e-9 I   ((k+q) x (k+q), R_i the 4q
//   envelope rows (c1 e_j1 + c2 e_j2, s e_p) of row i),
// its lower Cholesky factor Mc_i, S_i = M_i^-1 E_t ((k+q) x q) and the lower
// Cholesky factor Gc of G = I_q + sum_i S_i[k:, :].  Run once per solve call.
//
// K9a replaces _mc_adjoint (:329-348), solve_ut / solve_z (:419-457) and the
// symmetrisation (:474-475):
//   y = w - u - offs over the eight slots; (gX, gY, gTh, gU, gt) = K' y with
//   the envelope duals scattered from pairs to coordinates;
//   X, Theta: diagonal divides; Y: (3 I + vec I vec I')^-1 through tr(rY);
//   (U, t) per row: z0_i = M_i^-1 rho (gU_i, gt_i), then the orthogonality
//   Woodbury tcorr = G^-1 sum_i z0_i[k:], z_i = z0_i - S_i tcorr;  / rho.
//
// K9b replaces _mc_forward (:295-326), the over-relaxed w/u-step of every
// slot but the PSD projections (:477-506) and the running mean of rho*umc and
// rho*uorth over the last quarter of the call (:517-536):
//   t = alpha f + (1 - alpha) w + u;  t1, t2, t3 written for K1;
//   w4 = max(t4, 0); wsoc = proj_SOC; wbox = clip(tbox, U_lo, U_hi);
//   wmc = max(tmc, 0); worth = 0 (equality rows);  u = t - w;
//   acc += beta (rho u - acc) for umc and uorth when acc is given.
//
// The envelope coefficients (s, c1, c2, d) are formed from U_lo / U_hi inside
// each kernel (four rows per (i, p), each a product of two box entries); no
// (B, 4, n, q) coefficient tensor exists in device memory.
//
// What bounds them on the H100: bytes.  K9a and K9b stream the slot blocks
// of one node slot ((n+m)^2 + (n+k)^2 + n^2 floats of w and u) once with a
// few flops per element; the (k+q)^2 per-row solves are O(n (k+q)^2).  K9s
// is a few hundred flops per row on (B, n, k) inputs and is launch-bound.
// Design: one CTA per node slot, so every cross-row sum (tr Y, sum_i z0_i[k:],
// sum_i t[i, p], the column norms of the SOC slots, G) is a reduction inside
// the CTA in a fixed order (warp shuffles, shared memory, sequential loops;
// no atomics) and two launches on the same input give the same bits.  Each
// row's (k+q) x (k+q) factor is held by one thread in registers (templated on
// k in {1, 2, 3}, so k+q <= 9).  K9a's two reductions (the trace and the
// Woodbury sum) are a second pass inside the CTA after a barrier, not a second
// launch: the pre-correction Y and z0 are kept in global and shared memory.
#include "common.cuh"

namespace {

// the four envelope rows  w_r = s t + c1 U[:, j1] + c2 U[:, j2] + d >= 0
// (omc/sdp/mccormick.py mccormick_coeffs, reference lines 1688-1723)
__device__ __forceinline__ void envelope(int r, float lo1, float lo2, float hi1, float hi2,
                                         float& s, float& c1, float& c2, float& d) {
  switch (r) {
    case 0: s = 1.f;  c1 = -lo2; c2 = -lo1; d = lo1 * lo2;    break;
    case 1: s = 1.f;  c1 = -hi2; c2 = -hi1; d = hi1 * hi2;    break;
    case 2: s = -1.f; c1 = hi2;  c2 = lo1;  d = -lo1 * hi2;   break;
    default: s = -1.f; c1 = lo2; c2 = hi1;  d = -hi1 * lo2;   break;
  }
}

// pair p -> (j1, j2), j1 <= j2, in omc's order (pair_indices)
template <int K>
__device__ __forceinline__ void pair_of(int p, int& j1, int& j2) {
  int a = 0;
#pragma unroll
  for (int x = 0; x < K; ++x)
#pragma unroll
    for (int y = x; y < K; ++y, ++a)
      if (a == p) j1 = x, j2 = y;
}

// lower Cholesky factor of a D x D matrix in registers (reads the lower
// triangle, writes zeros above the diagonal)
template <int D>
__device__ __forceinline__ void cholesky(const float (&M)[D][D], float (&L)[D][D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float s = M[j][j];
#pragma unroll
    for (int l = 0; l < j; ++l) s -= L[j][l] * L[j][l];
    L[j][j] = sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float t = M[i][j];
#pragma unroll
      for (int l = 0; l < j; ++l) t -= L[i][l] * L[j][l];
      L[i][j] = t / L[j][j];
    }
#pragma unroll
    for (int i = 0; i < j; ++i) L[i][j] = 0.f;
  }
}

// x <- (L L')^-1 x with L lower triangular in registers
template <int D>
__device__ __forceinline__ void cho_solve(const float (&L)[D][D], float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = x[i];
#pragma unroll
    for (int l = 0; l < i; ++l) s -= L[i][l] * x[l];
    x[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int l = i + 1; l < D; ++l) s -= L[l][i] * x[l];
    x[i] = s / L[i][i];
  }
}

// the lower triangle of a row-major D x D factor from global memory
template <int D>
__device__ __forceinline__ void load_lower(const float* g, float (&L)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) L[i][j] = (j <= i) ? g[i * D + j] : 0.f;
}

// ---------------------------------------------------------------------------
// K9s
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(omc::kThreads) k9s_kernel(K9sParams p) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
  extern __shared__ float smem[];
  float* stt = smem;          // n * Q * Q   S_i[k:, :] per row
  float* G = stt + p.n * Q * Q;  // Q * Q
  const int b = blockIdx.x, tid = threadIdx.x, n = p.n;
  const float* lo = p.U_lo + (size_t)b * n * K;
  const float* hi = p.U_hi + (size_t)b * n * K;

  for (int i = tid; i < n; i += blockDim.x) {
    float M[KQ][KQ];
#pragma unroll
    for (int a = 0; a < KQ; ++a)
#pragma unroll
      for (int c = 0; c < KQ; ++c) M[a][c] = 0.f;
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp) {
        const float lo1 = lo[i * K + j1], lo2 = lo[i * K + j2];
        const float hi1 = hi[i * K + j1], hi2 = hi[i * K + j2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float s, c1, c2, d;
          envelope(r, lo1, lo2, hi1, hi2, s, c1, c2, d);
          float a[KQ];
#pragma unroll
          for (int c = 0; c < KQ; ++c) a[c] = 0.f;
          a[j1] += c1;
          a[j2] += c2;
          a[K + pp] = s;
#pragma unroll
          for (int x = 0; x < KQ; ++x)
#pragma unroll
            for (int y = 0; y < KQ; ++y) M[x][y] = fmaf(a[x], a[y], M[x][y]);
        }
      }
#pragma unroll
    for (int c = 0; c < K; ++c) M[c][c] += 4.0f;
#pragma unroll
    for (int c = 0; c < KQ; ++c) M[c][c] += 1e-9f;
    float L[KQ][KQ];
    cholesky<KQ>(M, L);
    float* Mc = p.Mc + ((size_t)b * n + i) * KQ * KQ;
#pragma unroll
    for (int x = 0; x < KQ; ++x)
#pragma unroll
      for (int y = 0; y < KQ; ++y) Mc[x * KQ + y] = L[x][y];
    float* Si = p.Si + ((size_t)b * n + i) * KQ * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float x[KQ];
#pragma unroll
      for (int c = 0; c < KQ; ++c) x[c] = (c == K + q) ? 1.f : 0.f;
      cho_solve<KQ>(L, x);
#pragma unroll
      for (int c = 0; c < KQ; ++c) Si[c * Q + q] = x[c];
#pragma unroll
      for (int a = 0; a < Q; ++a) stt[(i * Q + a) * Q + q] = x[K + a];
    }
  }
  __syncthreads();
  // G = I_q + sum_i S_i[k:, :], rows summed in order
  for (int e = tid; e < Q * Q; e += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += stt[i * Q * Q + e];
    G[e] = ((e / Q == e % Q) ? 1.f : 0.f) + s;
  }
  __syncthreads();
  if (tid == 0) {
    float Gm[Q][Q], L[Q][Q];
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
      for (int c = 0; c < Q; ++c) Gm[a][c] = G[a * Q + c];
    cholesky<Q>(Gm, L);
    float* Gc = p.Gc + (size_t)b * Q * Q;
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
      for (int c = 0; c < Q; ++c) Gc[a * Q + c] = L[a][c];
  }
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(omc::kThreads) k9a_kernel(K9aParams p) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = p.n, m = p.m;
  const int D1 = n + m, D2 = n + K;
  float* red = smem;         // 32
  float* z0s = red + 32;     // n * KQ   z0 per row
  float* tc = z0s + n * KQ;  // Q        sum_i z0_i[k:], then tcorr

  const float rho = p.rho[b], sX = p.sX[b], sT = p.sT[b];
  const float* w1 = p.w1 + (size_t)b * D1 * D1;
  const float* u1 = p.u1 + (size_t)b * D1 * D1;
  const float* w2 = p.w2 + (size_t)b * D2 * D2;
  const float* u2 = p.u2 + (size_t)b * D2 * D2;
  const float* w3 = p.w3 + (size_t)b * n * n;
  const float* u3 = p.u3 + (size_t)b * n * n;
  const float* wsoc = p.wsoc + (size_t)b * K * (1 + n);
  const float* usoc = p.usoc + (size_t)b * K * (1 + n);
  const float* wbox = p.wbox + (size_t)b * n * K;
  const float* ubox = p.ubox + (size_t)b * n * K;
  const float* wmc = p.wmc + (size_t)b * 4 * n * Q;
  const float* umc = p.umc + (size_t)b * 4 * n * Q;
  const float* lo = p.U_lo + (size_t)b * n * K;
  const float* hi = p.U_hi + (size_t)b * n * K;
  float* Xs = p.Xs + (size_t)b * n * m;
  float* Y = p.Y + (size_t)b * n * n;
  float* Ths = p.Ths + (size_t)b * m * m;
  float* U = p.U + (size_t)b * n * K;
  float* t = p.t + (size_t)b * n * Q;
  const float y4 = p.w4[b] - p.u4[b] - (float)K;

  // X block: zX = (rho gX + sX mask A) / (mask sX^2 + 2 rho sX^2)
  for (int e = tid; e < n * m; e += blockDim.x) {
    const int i = e / m, j = e % m;
    const int q = i * D1 + n + j;
    const float gX = sX * 2.0f * (w1[q] - u1[q]);
    const float rX = rho * gX + sX * p.maskA[e];
    const float dX = p.mask[e] * (sX * sX) + rho * 2.0f * sX * sX;
    Xs[e] = rX / dX;
  }
  // Theta block, symmetrised directly
  const float cth = sT * 0.5f / p.gamma;
  for (int e = tid; e < m * m; e += blockDim.x) {
    const int i = e / m, j = e % m;
    const int q1 = (n + i) * D1 + n + j, q2 = (n + j) * D1 + n + i;
    const float dg = (i == j) ? cth : 0.f;
    const float za = (rho * (sT * (w1[q1] - u1[q1])) - dg) / (rho * sT * sT);
    const float zb = (rho * (sT * (w1[q2] - u1[q2])) - dg) / (rho * sT * sT);
    Ths[e] = 0.5f * (za + zb);
  }
  // Y before the trace correction: rho gY / 3
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    const int q1 = i * D1 + j, q2 = i * D2 + j;
    float gY = (w1[q1] - u1[q1]) + (w2[q2] - u2[q2]) -
               (w3[e] - u3[e] - (i == j ? 1.0f : 0.f));
    if (i == j) gY -= y4;
    Y[e] = (rho * gY) / 3.0f;
  }
  // (U, t) per row: r = rho (gU, gt), z0 = M_i^-1 r
  for (int i = tid; i < n; i += blockDim.x) {
    float r[KQ];
    float g1[K], g2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int q2 = i * D2 + n + j, qs = j * (1 + n) + 1 + i;
      r[j] = 2.0f * (w2[q2] - u2[q2]) + (wsoc[qs] - usoc[qs]) + (wbox[i * K + j] - ubox[i * K + j]);
      g1[j] = 0.f;
      g2[j] = 0.f;
    }
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp) {
        const float lo1 = lo[i * K + j1], lo2 = lo[i * K + j2];
        const float hi1 = hi[i * K + j1], hi2 = hi[i * K + j2];
        float mc1 = 0.f, mc2 = 0.f, gt = 0.f;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float s, c1, c2, d;
          envelope(rr, lo1, lo2, hi1, hi2, s, c1, c2, d);
          const size_t q = ((size_t)rr * n + i) * Q + pp;
          const float y = wmc[q] - umc[q] - d;
          mc1 += y * c1;
          mc2 += y * c2;
          gt += y * s;
        }
        g1[j1] += mc1;
        g2[j2] += mc2;
        const size_t qo = (size_t)b * Q + pp;
        const float delta = (j1 == j2) ? 1.0f : 0.f;
        r[K + pp] = rho * (gt + (p.worth[qo] - p.uorth[qo] + delta));
      }
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = rho * ((r[j] + g1[j]) + g2[j]);
    float L[KQ][KQ];
    load_lower<KQ>(p.Mc + ((size_t)b * n + i) * KQ * KQ, L);
    cho_solve<KQ>(L, r);
#pragma unroll
    for (int c = 0; c < KQ; ++c) z0s[i * KQ + c] = r[c];
  }
  __syncthreads();

  // second pass: tr(rY / 3) and sum_i z0_i[k:] (rows in order), tcorr
  float tr = 0.f;
  for (int i = tid; i < n; i += blockDim.x) tr += Y[i * n + i];
  tr = omc::block_sum(tr, red);
  if (tid < Q) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += z0s[i * KQ + K + tid];
    tc[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float L[Q][Q], x[Q];
    load_lower<Q>(p.Gc + (size_t)b * Q * Q, L);
#pragma unroll
    for (int a = 0; a < Q; ++a) x[a] = tc[a];
    cho_solve<Q>(L, x);
#pragma unroll
    for (int a = 0; a < Q; ++a) tc[a] = x[a];
  }
  __syncthreads();

  // Y = sym((zY - tr / (3 + n) I) / rho)
  const float ctr = tr / (3.0f + (float)n);
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    if (i > j) continue;
    const float dg = (i == j) ? ctr : 0.f;
    const float a = (Y[i * n + j] - dg) / rho;
    const float c = (Y[j * n + i] - dg) / rho;
    const float ys = 0.5f * (a + c);
    Y[i * n + j] = ys;
    Y[j * n + i] = ys;
  }
  // z = z0 - S_i tcorr;  U, t = z / rho
  for (int i = tid; i < n; i += blockDim.x) {
    const float* Si = p.Si + ((size_t)b * n + i) * KQ * Q;
#pragma unroll
    for (int c = 0; c < KQ; ++c) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < Q; ++a) s += Si[c * Q + a] * tc[a];
      const float z = (z0s[i * KQ + c] - s) / rho;
      if (c < K) U[i * K + c] = z;
      else t[i * Q + (c - K)] = z;
    }
  }
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(omc::kThreads) k9b_kernel(K9bParams p) {
  constexpr int Q = K * (K + 1) / 2;
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int n = p.n, m = p.m;
  const int D1 = n + m, D2 = n + K;
  const float alpha = p.alpha, om = 1.0f - p.alpha;
  float* red = smem;      // 32
  float* nx = red + 32;   // K   ||tsoc_j[1:]||
  float* ts0 = nx + K;    // K   tsoc_j[0]
  float* tsum = ts0 + K;  // Q   sum_i t[i, p]

  const float sX = p.sX[b], sT = p.sT[b], rho = p.rho[b];
  const float* Xs = p.Xs + (size_t)b * n * m;
  const float* Y = p.Y + (size_t)b * n * n;
  const float* Ths = p.Ths + (size_t)b * m * m;
  const float* U = p.U + (size_t)b * n * K;
  const float* t = p.t + (size_t)b * n * Q;
  const float* lo = p.U_lo + (size_t)b * n * K;
  const float* hi = p.U_hi + (size_t)b * n * K;
  float* wsoc = p.wsoc + (size_t)b * K * (1 + n);
  float* usoc = p.usoc + (size_t)b * K * (1 + n);

  // ---- reductions (read phase) ----
  float tr = 0.f;
  for (int i = tid; i < n; i += blockDim.x) tr += Y[i * n + i];
  tr = omc::block_sum(tr, red);
  for (int task = warp; task < K + Q; task += nwarps) {
    float s = 0.f;
    if (task < K) {
      const int j = task;
      for (int i = lane; i < n; i += 32) {
        const int q = j * (1 + n) + 1 + i;
        const float v = (alpha * U[i * K + j] + om * wsoc[q]) + usoc[q];
        s += v * v;
      }
      s = omc::warp_sum(s);
      if (lane == 0) {
        const int q = j * (1 + n);
        nx[j] = sqrtf(s);
        ts0[j] = (alpha * 1.0f + om * wsoc[q]) + usoc[q];
      }
    } else {
      const int pp = task - K;
      for (int i = lane; i < n; i += 32) s += t[i * Q + pp];
      s = omc::warp_sum(s);
      if (lane == 0) tsum[pp] = s;
    }
  }
  __syncthreads();

  // ---- PSD slots: t = alpha f + (1 - alpha) w + u ----
  {
    const float* w1 = p.w1 + (size_t)b * D1 * D1;
    const float* u1 = p.u1 + (size_t)b * D1 * D1;
    float* t1 = p.t1 + (size_t)b * D1 * D1;
    for (int e = tid; e < D1 * D1; e += blockDim.x) {
      const int i = e / D1, j = e % D1;
      float f;
      if (i < n && j < n) f = Y[i * n + j];
      else if (i < n) f = sX * Xs[i * m + (j - n)];
      else if (j < n) f = sX * Xs[j * m + (i - n)];
      else f = sT * Ths[(i - n) * m + (j - n)];
      t1[e] = (alpha * f + om * w1[e]) + u1[e];
    }
    const float* w2 = p.w2 + (size_t)b * D2 * D2;
    const float* u2 = p.u2 + (size_t)b * D2 * D2;
    float* t2 = p.t2 + (size_t)b * D2 * D2;
    for (int e = tid; e < D2 * D2; e += blockDim.x) {
      const int i = e / D2, j = e % D2;
      float f;
      if (i < n && j < n) f = Y[i * n + j];
      else if (i < n) f = U[i * K + (j - n)];
      else if (j < n) f = U[j * K + (i - n)];
      else f = (i == j) ? 1.0f : 0.f;
      t2[e] = (alpha * f + om * w2[e]) + u2[e];
    }
    const float* w3 = p.w3 + (size_t)b * n * n;
    const float* u3 = p.u3 + (size_t)b * n * n;
    float* t3 = p.t3 + (size_t)b * n * n;
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      const float f = (i == j ? 1.0f : 0.f) - Y[e];
      t3[e] = (alpha * f + om * w3[e]) + u3[e];
    }
  }

  // ---- trace slot ----
  if (tid == 0) {
    const float t4 = (alpha * ((float)K - tr) + om * p.w4[b]) + p.u4[b];
    const float w4 = fmaxf(t4, 0.f);
    p.w4[b] = w4;
    p.u4[b] = t4 - w4;
  }

  // ---- SOC slots (1, U_j) ----
  for (int e = tid; e < K * (1 + n); e += blockDim.x) {
    const int j = e / (1 + n), q = e % (1 + n);
    const float f = (q == 0) ? 1.0f : U[(q - 1) * K + j];
    const float v = (alpha * f + om * wsoc[e]) + usoc[e];
    const float tt = ts0[j], nj = nx[j];
    float w;
    if (nj <= tt) w = v;
    else if (nj <= -tt) w = 0.f;
    else if (q == 0) w = 0.5f * (tt + nj);
    else w = (nj > 0.f ? 0.5f * (1.0f + tt / nj) : 0.f) * v;
    wsoc[e] = w;
    usoc[e] = v - w;
  }

  // ---- box slot ----
  for (int e = tid; e < n * K; e += blockDim.x) {
    const size_t q = (size_t)b * n * K + e;
    const float v = (alpha * U[e] + om * p.wbox[q]) + p.ubox[q];
    const float w = fminf(fmaxf(v, p.U_lo[q]), p.U_hi[q]);
    p.wbox[q] = w;
    p.ubox[q] = v - w;
  }

  // ---- envelope rows (>= 0) and their running mean ----
  for (int e = tid; e < 4 * n * Q; e += blockDim.x) {
    const int rr = e / (n * Q), i = (e / Q) % n, pp = e % Q;
    int j1 = 0, j2 = 0;
    pair_of<K>(pp, j1, j2);
    float s, c1, c2, d;
    envelope(rr, lo[i * K + j1], lo[i * K + j2], hi[i * K + j1], hi[i * K + j2], s, c1, c2, d);
    const float f = ((s * t[i * Q + pp] + c1 * U[i * K + j1]) + c2 * U[i * K + j2]) + d;
    const size_t q = (size_t)b * 4 * n * Q + e;
    const float v = (alpha * f + om * p.wmc[q]) + p.umc[q];
    const float w = fmaxf(v, 0.f), u = v - w;
    p.wmc[q] = w;
    p.umc[q] = u;
    if (p.acc_mc) p.acc_mc[q] = p.acc_mc[q] + p.beta * (rho * u - p.acc_mc[q]);
  }

  // ---- orthogonality rows (= 0) and their running mean ----
  for (int pp = tid; pp < Q; pp += blockDim.x) {
    int j1 = 0, j2 = 0;
    pair_of<K>(pp, j1, j2);
    const size_t q = (size_t)b * Q + pp;
    const float f = tsum[pp] - ((j1 == j2) ? 1.0f : 0.f);
    const float v = (alpha * f + om * p.worth[q]) + p.uorth[q];
    p.worth[q] = 0.f;
    p.uorth[q] = v;
    if (p.acc_orth) p.acc_orth[q] = p.acc_orth[q] + p.beta * (rho * v - p.acc_orth[q]);
  }
}

template <typename Kernel, typename Params>
int launch_k(Kernel kern, const Params& p, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.B > 0) kern<<<p.B, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int q_of(int k) { return k * (k + 1) / 2; }

}  // namespace

OMC_EXPORT int omc_k9s_setup(const K9sParams* params, void* stream) {
  const K9sParams& p = *params;
  const int Q = q_of(p.k);
  const size_t smem = (size_t)(p.n + 1) * Q * Q * sizeof(float);
  switch (p.k) {
    case 1: return launch_k(k9s_kernel<1>, p, smem, stream);
    case 2: return launch_k(k9s_kernel<2>, p, smem, stream);
    case 3: return launch_k(k9s_kernel<3>, p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

OMC_EXPORT int omc_k9a_zstep(const K9aParams* params, void* stream) {
  const K9aParams& p = *params;
  const int Q = q_of(p.k);
  const size_t smem = (size_t)(32 + p.n * (p.k + Q) + Q) * sizeof(float);
  switch (p.k) {
    case 1: return launch_k(k9a_kernel<1>, p, smem, stream);
    case 2: return launch_k(k9a_kernel<2>, p, smem, stream);
    case 3: return launch_k(k9a_kernel<3>, p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

OMC_EXPORT int omc_k9b_cone(const K9bParams* params, void* stream) {
  const K9bParams& p = *params;
  const size_t smem = (size_t)(32 + 2 * p.k + q_of(p.k)) * sizeof(float);
  switch (p.k) {
    case 1: return launch_k(k9b_kernel<1>, p, smem, stream);
    case 2: return launch_k(k9b_kernel<2>, p, smem, stream);
    case 3: return launch_k(k9b_kernel<3>, p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
