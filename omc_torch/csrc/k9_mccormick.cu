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
// of every node slot ((n+m)^2 + (n+k)^2 + n^2 floats of w and u) once with a
// few flops per element; the (k+q)^2 per-row solves are O(n (k+q)^2).  K9s
// reads 2 n k floats a slot and writes n (k+q)(k+2q) floats of factors; at
// the McCormick shapes its bound is below a microsecond, so a launch's floor
// and each thread's dependent chain set its time.
//
// Design.  K9s: one CTA per node slot, its threads n rounded up to whole
// warps (128 to 256, rows in chunks of that many), a thread a row.  The
// row Gram is built from its structure (k9s_gram: each envelope row touches
// at most 3 x 3 entries, the t block is 4 I_q), factored with one
// reciprocal square root a pivot (chol_rcp), reused by the column and by
// the q two-sided solves for S_i e_q, whose forward pass starts at row
// k + q.  A chunk's Mc and Si rows are staged in shared memory and stored
// as the slot's contiguous blocks with 16-byte words (store_span); G's
// lower triangle is summed over each thread's rows in order, xor shuffles,
// then the warps in order (a lane of warp 0 an entry), and lane 0 of warp 0
// factors it.
// K9a and K9b split the work the way K8b and K8d do: what needs a sum over
// rows goes to one slot CTA a node slot, first in the grid; the rest goes
// to flat CTAs of 128 threads that wait on no sum (k9a_layout, k9b_layout;
// omc_torch.sdp.mccormick.k9_plan).
//  K9a slot CTA: the per-row (U, t) solves, z0 summed over the rows, the Gc
//      solve, tr(rho gY / 3) from the diagonals and Y's n diagonal entries
//      (the trace correction touches only those);
//  K9a flat CTAs (units a slot): X in chunks of 512 entries, then Theta's
//      and Y's off-diagonal entries as pairs of 16 x 16 tiles: tiles (I, J)
//      and (J, I) staged coalesced in shared memory (rows of 17 floats, so
//      the transposed read is free of bank conflicts), both symmetrised
//      tiles written coalesced; no thread reads w1 across rows.  Small
//      tiles keep each thread's loads few (a Y entry takes six), so a flat
//      CTA's chain is about a slot CTA's.
//  K9b slot CTA: tr Y, the k SOC column norms and sum_i t[i, p], then the
//      trace, SOC, box, envelope and orthogonality slots with the running
//      means;
//  K9b flat CTAs: t1, t2, t3 in 16-byte quads of the batch's flat entries,
//      qpc quads a CTA (the plan narrows qpc until the flat CTAs fill the
//      card); each entry of a quad resolves its own (slot, i, j) and block.
// Every sum is over a CTA's threads in a fixed order (each thread's rows in
// order, warp shuffles, then the warps in order): no atomics, so two
// launches on the same input give the same bits.  The flat entries' (i, j)
// come from a float reciprocal (omc::divmod), with no integer divide an
// entry; operands the kernels do not write are read through the read-only
// path (omc::RO).
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

// lower Cholesky factor, in place, of the D x D matrix whose lower triangle
// is in A (the upper triangle is not read or written), with one reciprocal
// square root a pivot: L[j][j] = d rsqrt(d) and inv[j] = rsqrt(d) = 1 /
// L[j][j], which the column below it and every later solve multiply by
template <int D>
__device__ __forceinline__ void chol_rcp(float (&A)[D][D], float (&inv)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float d = A[j][j];
#pragma unroll
    for (int l = 0; l < j; ++l) d = fmaf(-A[j][l], A[j][l], d);
    const float r = rsqrtf(d);
    A[j][j] = d * r;
    inv[j] = r;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int l = 0; l < j; ++l) t = fmaf(-A[i][l], A[j][l], t);
      A[i][j] = t * r;
    }
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

// the lower triangle of a row-major D x D factor at g[off], a read-only
// view of global memory
template <int D>
__device__ __forceinline__ void load_lower(omc::RO g, int off, float (&L)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) L[i][j] = (j <= i) ? g[off + i * D + j] : 0.f;
}

// ---------------------------------------------------------------------------
// K9s
// ---------------------------------------------------------------------------

// K9s's CTA: one a node slot, its threads n rounded up to whole warps, at
// least 128 (the warps past n's rows store and sum: at n = 50, k = 3 the
// stores drain 10% sooner) and at most 256 (a thread takes rows tid,
// tid + T, ... in chunks of T)
constexpr int kThreads9s = 256, kMinThreads9s = 128;

__host__ __device__ __forceinline__ int k9s_threads(int n) {
  const int t = 32 * omc::cdiv(n, 32);
  return t < kMinThreads9s ? kMinThreads9s : t < kThreads9s ? t : kThreads9s;
}

// dynamic shared memory of a K9s CTA, in floats: a chunk's Mc and Si rows
// staged for the coalesced stores (each with 4 floats of alignment slack),
// then each warp's partial sums of G's lower triangle
__host__ __device__ __forceinline__ int k9s_smem_floats(int n, int k) {
  const int q = k * (k + 1) / 2, kq = k + q, T = k9s_threads(n);
  return (4 + T * kq * kq) + (4 + T * kq * q) + (T / 32) * (q * (q + 1) / 2);
}

// nf floats from shared s to global g, where s and g agree modulo 16 bytes:
// scalars up to g's first 16-byte boundary, then 16-byte words, then the
// scalar tail, the CTA's threads on consecutive words
__device__ __forceinline__ void store_span(float* __restrict__ g, const float* s, int nf) {
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2);
  head = head < nf ? head : nf;
  const int n4 = (nf - head) >> 2;
  for (int q = threadIdx.x; q < head; q += blockDim.x) g[q] = s[q];
  float4* g4 = reinterpret_cast<float4*>(g + head);
  const float4* s4 = reinterpret_cast<const float4*>(s + head);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) g4[q] = s4[q];
  for (int q = head + 4 * n4 + threadIdx.x; q < nf; q += blockDim.x) g[q] = s[q];
}

// the place in a 16-byte aligned staging area at which a span bound for g
// starts, so that the span and g agree modulo 16 bytes
__device__ __forceinline__ float* staged_for(float* stage, const float* g) {
  return stage + ((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// The row Gram from its structure.  Envelope row r of pair p = (j1, j2) is
// a = c1 e_j1 + c2 e_j2 + s e_{k+p} with s = +-1, so it touches at most a
// 3 x 3 block, and summed over its four rows (envelope()):
//   j1 < j2:  M[j1][j1] += 2 (lo2^2 + hi2^2),  M[j2][j2] += 2 (lo1^2 + hi1^2),
//             M[j2][j1] += (lo1 + hi1)(lo2 + hi2),
//             M[k+p][j1] = -2 (lo2 + hi2),      M[k+p][j2] = -2 (lo1 + hi1);
//   j1 = j2 = j:  M[j][j] += 4 (lo^2 + hi^2) + 2 (lo + hi)^2,  M[k+p][j] = -4 (lo + hi);
// and the t block is 4 I_q (s^2 = 1 four times, each pair its own t), so
// M = that + diag(4 I_k, 0) + 1e-9 I.  Writes the lower triangle of A.
template <int K>
__device__ __forceinline__ void k9s_gram(const float (&l)[K], const float (&h)[K],
                                         float (&A)[K + K * (K + 1) / 2][K + K * (K + 1) / 2]) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
#pragma unroll
  for (int a = 0; a < KQ; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) A[a][c] = 0.f;
  int p = 0;
#pragma unroll
  for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
    for (int j2 = j1; j2 < K; ++j2, ++p) {
      if (j1 == j2) {
        const float sl = l[j1] + h[j1];
        A[j1][j1] += 4.f * (l[j1] * l[j1] + h[j1] * h[j1]) + 2.f * (sl * sl);
        A[K + p][j1] = -4.f * sl;
      } else {
        const float s1 = l[j1] + h[j1], s2 = l[j2] + h[j2];
        A[j1][j1] += 2.f * (l[j2] * l[j2] + h[j2] * h[j2]);
        A[j2][j2] += 2.f * (l[j1] * l[j1] + h[j1] * h[j1]);
        A[j2][j1] += s1 * s2;
        A[K + p][j1] = -2.f * s2;
        A[K + p][j2] = -2.f * s1;
      }
    }
  // + 4 on every diagonal entry: diag(4 I_k) on U's block, 4 I_q on t's
#pragma unroll
  for (int a = 0; a < KQ; ++a) A[a][a] = (A[a][a] + 4.f) + 1e-9f;
}

template <int K>
__global__ void __launch_bounds__(kThreads9s) k9s_kernel(K9sParams p) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q, NG = Q * (Q + 1) / 2;
  extern __shared__ float4 k9s_smem4[];
  float* const smem = reinterpret_cast<float*>(k9s_smem4);
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x, n = p.n;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  float* const stMc = smem;                      // 4 + T KQ^2
  float* const stSi = stMc + 4 + T * KQ * KQ;    // 4 + T KQ Q
  float* const red = stSi + 4 + T * KQ * Q;      // nw NG
  const omc::RO lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};

  // this thread's rows' S_i[k:, :], lower triangle, summed in row order
  float gs[NG];
#pragma unroll
  for (int e = 0; e < NG; ++e) gs[e] = 0.f;

  for (int r0 = 0; r0 < n; r0 += T) {
    const int rows = min(T, n - r0);
    float* const gMc = p.Mc + ((size_t)b * n + r0) * KQ * KQ;
    float* const gSi = p.Si + ((size_t)b * n + r0) * KQ * Q;
    float* const sMc = staged_for(stMc, gMc);
    float* const sSi = staged_for(stSi, gSi);
    if (tid < rows) {
      const int i = r0 + tid;
      float l[K], h[K];
#pragma unroll
      for (int j = 0; j < K; ++j) l[j] = lo[i * K + j], h[j] = hi[i * K + j];
      float A[KQ][KQ], inv[KQ];
      k9s_gram<K>(l, h, A);
      chol_rcp<KQ>(A, inv);
      float* const m = sMc + tid * KQ * KQ;
#pragma unroll
      for (int a = 0; a < KQ; ++a)
#pragma unroll
        for (int c = 0; c < KQ; ++c) m[a * KQ + c] = c <= a ? A[a][c] : 0.f;
      // S_i e_q = M_i^-1 e_{k+q}: the forward solve starts at row k + q
      // (the right-hand side is 0 above it), then the backward solve
      float* const si = sSi + tid * KQ * Q;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float x[KQ];
#pragma unroll
        for (int a = 0; a < K + q; ++a) x[a] = 0.f;
        x[K + q] = inv[K + q];
#pragma unroll
        for (int a = K + q + 1; a < KQ; ++a) {
          float t = 0.f;
#pragma unroll
          for (int c = K + q; c < a; ++c) t = fmaf(-A[a][c], x[c], t);
          x[a] = t * inv[a];
        }
#pragma unroll
        for (int a = KQ - 1; a >= 0; --a) {
          float t = x[a];
#pragma unroll
          for (int c = a + 1; c < KQ; ++c) t = fmaf(-A[c][a], x[c], t);
          x[a] = t * inv[a];
        }
#pragma unroll
        for (int a = 0; a < KQ; ++a) si[a * Q + q] = x[a];
        // G's lower triangle: entries (a, q) with a >= q
#pragma unroll
        for (int a = q; a < Q; ++a) gs[a * (a + 1) / 2 + q] += x[K + a];
      }
    }
    __syncthreads();
    store_span(gMc, sMc, rows * KQ * KQ);
    store_span(gSi, sSi, rows * KQ * Q);
    __syncthreads();  // the staging is free for the next chunk
  }

  // G = I_q + sum_i S_i[k:, :]: xor shuffles within each warp; lane e of
  // warp 0 adds entry e over the warps in order, the sums are gathered by
  // shuffles (no load on the factorisation's path) and lane 0 factors G
#pragma unroll
  for (int e = 0; e < NG; ++e) {
    float v = gs[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * NG + e] = v;
  }
  __syncthreads();
  if (warp == 0) {
    float g = 0.f;
    if (lane < NG)
      for (int w = 0; w < nw; ++w) g += red[w * NG + lane];
    float G[Q][Q], ginv[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
      for (int c = 0; c <= a; ++c)
        G[a][c] = (a == c ? 1.f : 0.f) + __shfl_sync(0xffffffffu, g, a * (a + 1) / 2 + c);
    if (lane == 0) {
      chol_rcp<Q>(G, ginv);
      float* const Gc = p.Gc + (size_t)b * Q * Q;
#pragma unroll
      for (int a = 0; a < Q; ++a)
#pragma unroll
        for (int c = 0; c < Q; ++c) Gc[a * Q + c] = c <= a ? G[a][c] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// K9a and K9b: the grid (omc_torch.sdp.mccormick.k9_plan; omc_k9a_grid_x,
// omc_k9b_grid_x)
// ---------------------------------------------------------------------------

constexpr int kThreads9 = 128, kWarps9 = kThreads9 / 32;
constexpr int kTile = 16;                      // side of K9a's Theta and Y tiles
constexpr int kTileRows = kThreads9 / kTile;   // tile rows a pass of a CTA
constexpr int kTilePasses = kTile / kTileRows; // passes over a tile
constexpr int kXItems = 4;                     // X entries a thread of an X CTA
constexpr int kXChunk = kThreads9 * kXItems;   // X entries an X CTA

// K9a: B slot CTAs, then `units` CTAs a slot (slot x / units): X chunks of
// kXChunk entries, the Theta tile pairs, the Y tile pairs
struct K9aLayout {
  int x, th, y, units, grid_x;
};

__host__ __device__ __forceinline__ K9aLayout k9a_layout(int B, int n, int m) {
  K9aLayout l;
  const int tn = omc::cdiv(n, kTile), tm = omc::cdiv(m, kTile);
  l.x = omc::cdiv(n * m, kXChunk);
  l.th = tm * (tm + 1) / 2;
  l.y = tn * (tn + 1) / 2;
  l.units = l.x + l.th + l.y;
  l.grid_x = B + B * l.units;
  return l;
}

// K9b: B slot CTAs, then CTAs of qpc quads of 4 consecutive entries of the
// batch's flat t1, t2, t3
struct K9bLayout {
  int t1, t2, t3, grid_x;
};

__host__ __device__ __forceinline__ K9bLayout k9b_layout(int B, int n, int m, int k, int qpc) {
  K9bLayout l;
  const int d1 = n + m, d2 = n + k;
  l.t1 = omc::cdiv(omc::cdiv(B * d1 * d1, 4), qpc);
  l.t2 = omc::cdiv(omc::cdiv(B * d2 * d2, 4), qpc);
  l.t3 = omc::cdiv(omc::cdiv(B * n * n, 4), qpc);
  l.grid_x = B + l.t1 + l.t2 + l.t3;
  return l;
}

// tile pair p of a T x T grid of tiles -> (I, J), I <= J, row by row
__device__ __forceinline__ void tile_pair(int p, int T, int& I, int& J) {
  I = 0;
  while (p >= T - I) p -= T - I, ++I;
  J = I + p;
}

// ---------------------------------------------------------------------------
// K9a
// ---------------------------------------------------------------------------

// The slot CTA of slot b: per row the (U, t) right-hand side and its Mc
// solve (a thread a row, every load of the row issued before its first
// FMA), z0 kept in shared memory; Y's diagonal before the trace correction;
// sum_i z0_i[k:] and tr(rho gY / 3) as each thread's rows in order, warp
// shuffles, then the warps in order; the Gc solve; then U, t = (z0 - S_i
// tcorr) / rho and Y's n diagonal entries, the only ones the trace
// correction touches.
template <int K>
__device__ __forceinline__ void k9a_slot(const K9aParams& p, int b, float* smem) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
  __shared__ float red[kWarps9][Q + 1];
  __shared__ float tot[Q + 1];  // tcorr, then tr(rho gY / 3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m, D1 = n + m, D2 = n + K;
  float* z0s = smem;          // n * KQ
  float* ydg = z0s + n * KQ;  // n     rho gY_ii / 3
  const float rho = __ldg(p.rho + b);
  const omc::RO w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::RO w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const omc::RO w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  const omc::RO wsoc{p.wsoc + (size_t)b * K * (1 + n)}, usoc{p.usoc + (size_t)b * K * (1 + n)};
  const omc::RO wbox{p.wbox + (size_t)b * n * K}, ubox{p.ubox + (size_t)b * n * K};
  const omc::RO wmc{p.wmc + (size_t)b * 4 * n * Q}, umc{p.umc + (size_t)b * 4 * n * Q};
  const omc::RO lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};
  const omc::RO Mc{p.Mc + (size_t)b * n * KQ * KQ}, Si{p.Si + (size_t)b * n * KQ * Q};
  float* __restrict__ U = p.U + (size_t)b * n * K;
  float* __restrict__ t = p.t + (size_t)b * n * Q;
  float* __restrict__ Y = p.Y + (size_t)b * n * n;
  const float y4 = __ldg(p.w4 + b) - __ldg(p.u4 + b) - (float)K;
  float yo[Q];  // the orthogonality rows' residual, the same for every row
#pragma unroll
  for (int pp = 0; pp < Q; ++pp) {
    int j1 = 0, j2 = 0;
    pair_of<K>(pp, j1, j2);
    yo[pp] = __ldg(p.worth + b * Q + pp) - __ldg(p.uorth + b * Q + pp) + (j1 == j2 ? 1.0f : 0.f);
  }

  // the S_i of the thread's first row and (thread 0) Gc, in flight across
  // the rows' solves and the sums
  float si[KQ * Q], G[Q][Q];
  if (tid < n) {
#pragma unroll
    for (int c = 0; c < KQ * Q; ++c) si[c] = Si[tid * KQ * Q + c];
  }
  if (tid == 0) load_lower<Q>(omc::RO{p.Gc + (size_t)b * Q * Q}, 0, G);

  float part[Q + 1];
#pragma unroll
  for (int a = 0; a <= Q; ++a) part[a] = 0.f;
  for (int i = tid; i < n; i += kThreads9) {
    float a2[K], as[K], ab[K], l[K], h[K], ym[4][Q], L[KQ][KQ];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int q2 = i * D2 + n + j, qs = j * (1 + n) + 1 + i;
      a2[j] = w2[q2] - u2[q2];
      as[j] = wsoc[qs] - usoc[qs];
      ab[j] = wbox[i * K + j] - ubox[i * K + j];
      l[j] = lo[i * K + j];
      h[j] = hi[i * K + j];
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int pp = 0; pp < Q; ++pp) {
        const int q = (rr * n + i) * Q + pp;
        ym[rr][pp] = wmc[q] - umc[q];
      }
    load_lower<KQ>(Mc, i * KQ * KQ, L);
    const float d1 = w1[i * D1 + i] - u1[i * D1 + i], d2 = w2[i * D2 + i] - u2[i * D2 + i];
    const float d3 = w3[i * n + i] - u3[i * n + i];

    float r[KQ], g1[K], g2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      r[j] = 2.0f * a2[j] + as[j] + ab[j];
      g1[j] = 0.f;
      g2[j] = 0.f;
    }
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp) {
        float mc1 = 0.f, mc2 = 0.f, gt = 0.f;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float s, c1, c2, d;
          envelope(rr, l[j1], l[j2], h[j1], h[j2], s, c1, c2, d);
          const float y = ym[rr][pp] - d;
          mc1 += y * c1;
          mc2 += y * c2;
          gt += y * s;
        }
        g1[j1] += mc1;
        g2[j2] += mc2;
        r[K + pp] = rho * (gt + yo[pp]);
      }
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = rho * ((r[j] + g1[j]) + g2[j]);
    cho_solve<KQ>(L, r);
#pragma unroll
    for (int c = 0; c < KQ; ++c) z0s[i * KQ + c] = r[c];
#pragma unroll
    for (int a = 0; a < Q; ++a) part[a] += r[K + a];
    // Y_ii before the trace correction: rho gY_ii / 3
    const float yp = (rho * ((d1 + d2 - (d3 - 1.0f)) - y4)) / 3.0f;
    ydg[i] = yp;
    part[Q] += yp;
  }
#pragma unroll
  for (int a = 0; a <= Q; ++a) {
    const float v = omc::warp_sum(part[a]);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float x[Q + 1];
#pragma unroll
    for (int a = 0; a <= Q; ++a) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps9; ++w) s += red[w][a];
      x[a] = s;
    }
    float z[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a) z[a] = x[a];
    cho_solve<Q>(G, z);
#pragma unroll
    for (int a = 0; a < Q; ++a) tot[a] = z[a];
    tot[Q] = x[Q];
  }
  __syncthreads();

  float tc[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) tc[a] = tot[a];
  const float ctr = tot[Q] / (3.0f + (float)n);
  for (int i = tid; i < n; i += kThreads9) {
    if (i != tid) {
#pragma unroll
      for (int c = 0; c < KQ * Q; ++c) si[c] = Si[i * KQ * Q + c];
    }
#pragma unroll
    for (int c = 0; c < KQ; ++c) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < Q; ++a) s += si[c * Q + a] * tc[a];
      const float z = (z0s[i * KQ + c] - s) / rho;
      if (c < K) U[i * K + c] = z;
      else t[i * Q + (c - K)] = z;
    }
    const float a = (ydg[i] - ctr) / rho;
    Y[i * n + i] = 0.5f * (a + a);
  }
}

// X chunk `chunk` of slot b: zX = (rho gX + sX mask A) / (mask sX^2 + 2 rho
// sX^2), kXItems entries a thread, every load before the first store
__device__ __forceinline__ void k9a_x(const K9aParams& p, int b, int chunk) {
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m;
  const omc::RO w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::RO maskA{p.maskA}, mask{p.mask};
  float* __restrict__ Xs = p.Xs + (size_t)b * nm;
  const float rho = __ldg(p.rho + b), sX = __ldg(p.sX + b);
  const float inv = 1.0f / (float)m;
  const int e0 = chunk * kXChunk + threadIdx.x;
  float d[kXItems], ma[kXItems], mk[kXItems];
#pragma unroll
  for (int u = 0; u < kXItems; ++u) {
    const int e = e0 + u * kThreads9;
    if (e < nm) {
      int i, j;
      omc::divmod(e, m, inv, i, j);
      const int q = i * D1 + n + j;
      d[u] = w1[q] - u1[q];
      ma[u] = maskA[e];
      mk[u] = mask[e];
    }
  }
#pragma unroll
  for (int u = 0; u < kXItems; ++u) {
    const int e = e0 + u * kThreads9;
    if (e < nm) {
      const float gX = sX * 2.0f * d[u];
      const float rX = rho * gX + sX * ma[u];
      const float dX = mk[u] * (sX * sX) + rho * 2.0f * sX * sX;
      Xs[e] = rX / dX;
    }
  }
}

// A tile pair of an N x N block whose entry (i, j) stages as v(i, j): tile
// (I, J) into sA and, for I < J, tile (J, I) into sB; thread x on column x %
// kTile of rows x / kTile, x / kTile + kTileRows, ... (a half-warp on a
// row's consecutive columns: coalesced); rows stride kTile + 1, so the
// transposed reads below fall in distinct banks
template <class V>
__device__ __forceinline__ void stage_pair(int N, int I, int J, V v, float (*sA)[kTile + 1],
                                           float (*sB)[kTile + 1]) {
  const int col = threadIdx.x % kTile, row = threadIdx.x / kTile;
  float a[kTilePasses], c[kTilePasses];
#pragma unroll
  for (int u = 0; u < kTilePasses; ++u) {
    const int r = row + kTileRows * u;
    a[u] = c[u] = 0.f;
    const int ia = I * kTile + r, ja = J * kTile + col, ib = J * kTile + r, jb = I * kTile + col;
    if (ia < N && ja < N) a[u] = v(ia, ja);
    if (I != J && ib < N && jb < N) c[u] = v(ib, jb);
  }
#pragma unroll
  for (int u = 0; u < kTilePasses; ++u) {
    const int r = row + kTileRows * u;
    sA[r][col] = a[u];
    if (I != J) sB[r][col] = c[u];
  }
  __syncthreads();
}

// Both tiles of the pair from the staged values: out(i, j) = sym(x_ij,
// x_ji) with x_ji read transposed from the other tile (or the same tile on
// the diagonal); sym is symmetric in its arguments, so tile (J, I) gets the
// same bits as the transpose of tile (I, J)
template <class S>
__device__ __forceinline__ void store_pair(int N, int I, int J, S sym, float* __restrict__ out,
                                           const float (*sA)[kTile + 1],
                                           const float (*sB)[kTile + 1]) {
  const int col = threadIdx.x % kTile, row = threadIdx.x / kTile;
  const float(*tB)[kTile + 1] = (I == J) ? sA : sB;
#pragma unroll
  for (int u = 0; u < kTilePasses; ++u) {
    const int r = row + kTileRows * u, i = I * kTile + r, j = J * kTile + col;
    if (i < N && j < N) sym(i, j, sA[r][col], tB[col][r], out);
  }
  if (I == J) return;
#pragma unroll
  for (int u = 0; u < kTilePasses; ++u) {
    const int r = row + kTileRows * u, i = J * kTile + r, j = I * kTile + col;
    if (i < N && j < N) sym(i, j, sB[r][col], sA[col][r], out);
  }
}

// Theta tile pair `pair` of slot b: Theta = sym((rho sT d - dg) / (rho sT^2)),
// d = w1 - u1 of the Theta block, dg = sT / (2 gamma) on the diagonal
__device__ __forceinline__ void k9a_theta(const K9aParams& p, int b, int pair,
                                          float (*sA)[kTile + 1], float (*sB)[kTile + 1]) {
  const int n = p.n, m = p.m, D1 = n + m;
  int I, J;
  tile_pair(pair, omc::cdiv(m, kTile), I, J);
  const omc::RO w1{p.w1 + (size_t)b * D1 * D1 + (size_t)n * D1 + n};
  const omc::RO u1{p.u1 + (size_t)b * D1 * D1 + (size_t)n * D1 + n};
  stage_pair(m, I, J, [&](int i, int j) { return w1[i * D1 + j] - u1[i * D1 + j]; }, sA, sB);
  const float rho = __ldg(p.rho + b), sT = __ldg(p.sT + b);
  const float cth = sT * 0.5f / p.gamma, den = rho * sT * sT;
  store_pair(m, I, J, [&](int i, int j, float x, float y, float* __restrict__ out) {
    const float dg = (i == j) ? cth : 0.f;
    const float za = (rho * (sT * x) - dg) / den;
    const float zb = (rho * (sT * y) - dg) / den;
    out[i * m + j] = 0.5f * (za + zb);
  }, p.Ths + (size_t)b * m * m, sA, sB);
}

// Y tile pair `pair` of slot b, off the diagonal (the slot CTA writes the
// diagonal): Y = sym((rho gY / 3) / rho), gY = (w1 - u1) + (w2 - u2) -
// (w3 - u3) of the Y blocks
template <int K>
__device__ __forceinline__ void k9a_y(const K9aParams& p, int b, int pair, float (*sA)[kTile + 1],
                                      float (*sB)[kTile + 1]) {
  const int n = p.n, m = p.m, D1 = n + m, D2 = n + K;
  int I, J;
  tile_pair(pair, omc::cdiv(n, kTile), I, J);
  const omc::RO w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::RO w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const omc::RO w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  stage_pair(n, I, J, [&](int i, int j) {
    return (w1[i * D1 + j] - u1[i * D1 + j]) + (w2[i * D2 + j] - u2[i * D2 + j]) -
           (w3[i * n + j] - u3[i * n + j] - 0.f);
  }, sA, sB);
  const float rho = __ldg(p.rho + b);
  store_pair(n, I, J, [&](int i, int j, float x, float y, float* __restrict__ out) {
    if (i == j) return;
    const float a = ((rho * x) / 3.0f - 0.f) / rho;
    const float c = ((rho * y) / 3.0f - 0.f) / rho;
    out[i * n + j] = 0.5f * (a + c);
  }, p.Y + (size_t)b * n * n, sA, sB);
}

// (k9a_layout; omc_torch.sdp.mccormick.k9_plan)
template <int K>
__global__ void __launch_bounds__(kThreads9) k9a_kernel(K9aParams p) {
  extern __shared__ float smem[];
  __shared__ float sA[kTile][kTile + 1], sB[kTile][kTile + 1];
  const K9aLayout l = k9a_layout(p.B, p.n, p.m);
  int x = blockIdx.x;
  if (x < p.B) {
    k9a_slot<K>(p, x, smem);
    return;
  }
  x -= p.B;
  const int b = x / l.units;
  int u = x - b * l.units;
  if (u < l.x) {
    k9a_x(p, b, u);
    return;
  }
  u -= l.x;
  if (u < l.th) {
    k9a_theta(p, b, u, sA, sB);
    return;
  }
  k9a_y<K>(p, b, u - l.th, sA, sB);
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

// The slot CTA of slot b: per row (a thread a row, the row's loads first)
// the box slot and the envelope rows with their running mean, the SOC
// slots' t kept in shared memory, and each thread's parts of tr Y, the k
// SOC column norms and sum_i t[i, p] in row order; the sums by warp
// shuffles, then the warps in order; then the trace, SOC and orthogonality
// slots.
template <int K>
__device__ __forceinline__ void k9b_slot(const K9bParams& p, int b, float* smem) {
  constexpr int Q = K * (K + 1) / 2, NS = 1 + K + Q;  // tr Y, |tsoc_j[1:]|^2, sum_i t
  __shared__ float red[kWarps9][NS];
  __shared__ float tot[NS];
  __shared__ float head[K];  // tsoc_j[0]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  const float alpha = p.alpha, om = 1.0f - p.alpha;
  const float rho = __ldg(p.rho + b);
  const omc::RO Y{p.Y + (size_t)b * n * n}, U{p.U + (size_t)b * n * K}, t{p.t + (size_t)b * n * Q};
  const omc::RO lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};
  float* __restrict__ wsoc = p.wsoc + (size_t)b * K * (1 + n);
  float* __restrict__ usoc = p.usoc + (size_t)b * K * (1 + n);
  float* __restrict__ wbox = p.wbox + (size_t)b * n * K;
  float* __restrict__ ubox = p.ubox + (size_t)b * n * K;
  float* __restrict__ wmc = p.wmc + (size_t)b * 4 * n * Q;
  float* __restrict__ umc = p.umc + (size_t)b * 4 * n * Q;
  float* __restrict__ acc = p.acc_mc ? p.acc_mc + (size_t)b * 4 * n * Q : nullptr;
  float* sv = smem;  // K * (1 + n): tsoc

  if (tid < K) head[tid] = (alpha * 1.0f + om * wsoc[tid * (1 + n)]) + usoc[tid * (1 + n)];
  // the trace and orthogonality slots' w and u, in flight across the sums
  const size_t qo = (size_t)b * Q + min(tid, Q - 1);
  const float w4 = p.w4[b], u4 = p.u4[b], wo = p.worth[qo], uo = p.uorth[qo];
  const float ao = p.acc_orth ? p.acc_orth[qo] : 0.f;
  float part[NS];
#pragma unroll
  for (int a = 0; a < NS; ++a) part[a] = 0.f;
  for (int i = tid; i < n; i += kThreads9) {
    float Ui[K], ti[Q], ws[K], us[K], wb[K], ub[K], l[K], h[K], wm[4][Q], um[4][Q], am[4][Q];
    const float yii = Y[i * n + i];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      Ui[j] = U[i * K + j];
      ws[j] = wsoc[j * (1 + n) + 1 + i];
      us[j] = usoc[j * (1 + n) + 1 + i];
      wb[j] = wbox[i * K + j];
      ub[j] = ubox[i * K + j];
      l[j] = lo[i * K + j];
      h[j] = hi[i * K + j];
    }
#pragma unroll
    for (int pp = 0; pp < Q; ++pp) ti[pp] = t[i * Q + pp];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int pp = 0; pp < Q; ++pp) {
        const int q = (rr * n + i) * Q + pp;
        wm[rr][pp] = wmc[q];
        um[rr][pp] = umc[q];
        am[rr][pp] = acc ? acc[q] : 0.f;
      }

    part[0] += yii;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = (alpha * Ui[j] + om * ws[j]) + us[j];
      sv[j * (1 + n) + 1 + i] = v;
      part[1 + j] += v * v;
    }
#pragma unroll
    for (int pp = 0; pp < Q; ++pp) part[1 + K + pp] += ti[pp];
    // box slot
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = (alpha * Ui[j] + om * wb[j]) + ub[j];
      const float w = fminf(fmaxf(v, l[j]), h[j]);
      wbox[i * K + j] = w;
      ubox[i * K + j] = v - w;
    }
    // envelope rows (>= 0) and their running mean
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float s, c1, c2, d;
          envelope(rr, l[j1], l[j2], h[j1], h[j2], s, c1, c2, d);
          const float f = ((s * ti[pp] + c1 * Ui[j1]) + c2 * Ui[j2]) + d;
          const int q = (rr * n + i) * Q + pp;
          const float v = (alpha * f + om * wm[rr][pp]) + um[rr][pp];
          const float w = fmaxf(v, 0.f), u = v - w;
          wmc[q] = w;
          umc[q] = u;
          if (acc) acc[q] = am[rr][pp] + p.beta * (rho * u - am[rr][pp]);
        }
  }
#pragma unroll
  for (int a = 0; a < NS; ++a) {
    const float v = omc::warp_sum(part[a]);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (tid < NS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps9; ++w) s += red[w][tid];
    tot[tid] = s;
  }
  __syncthreads();

  // trace slot
  if (tid == 0) {
    const float t4 = (alpha * ((float)K - tot[0]) + om * w4) + u4;
    const float w = fmaxf(t4, 0.f);
    p.w4[b] = w;
    p.u4[b] = t4 - w;
  }
  // SOC slots (1, U_j)
  for (int e = tid; e < K * (1 + n); e += kThreads9) {
    int j = 0, q = e;
    while (q >= 1 + n) q -= 1 + n, ++j;
    const float tt = head[j], nj = sqrtf(tot[1 + j]);
    const float v = (q == 0) ? tt : sv[e];
    float w;
    if (nj <= tt) w = v;
    else if (nj <= -tt) w = 0.f;
    else if (q == 0) w = 0.5f * (tt + nj);
    else w = (nj > 0.f ? 0.5f * (1.0f + tt / nj) : 0.f) * v;
    wsoc[e] = w;
    usoc[e] = v - w;
  }
  // orthogonality rows (= 0) and their running mean
  if (tid < Q) {
    int j1 = 0, j2 = 0;
    pair_of<K>(tid, j1, j2);
    const float f = tot[1 + K + tid] - ((j1 == j2) ? 1.0f : 0.f);
    const float v = (alpha * f + om * wo) + uo;
    p.worth[qo] = 0.f;
    p.uorth[qo] = v;
    if (p.acc_orth) p.acc_orth[qo] = ao + p.beta * (rho * v - ao);
  }
}

// t1 (kind 0), t2 (1) or t3 (2) on the quads [quad0, quad0 + qpc) of the
// batch's flat B D^2: t = alpha f + (1 - alpha) w + u, a quad of 4
// consecutive entries a thread, w, u and t as 16-byte words; a quad may
// straddle a row, a block or a slot, so each entry resolves its own (b, i,
// j) and block of f; every load before the store
template <int K>
__device__ __forceinline__ void k9b_t(const K9bParams& p, int kind, int quad0) {
  const int n = p.n, m = p.m;
  const int D = kind == 0 ? n + m : kind == 1 ? n + K : n, DD = D * D, tot = p.B * DD;
  const int q0 = 4 * (quad0 + (int)threadIdx.x);
  if ((int)threadIdx.x >= p.qpc || q0 >= tot) return;
  const float* __restrict__ w = kind == 0 ? p.w1 : kind == 1 ? p.w2 : p.w3;
  const float* __restrict__ u = kind == 0 ? p.u1 : kind == 1 ? p.u2 : p.u3;
  float* __restrict__ tt = kind == 0 ? p.t1 : kind == 1 ? p.t2 : p.t3;
  const int rem = min(4, tot - q0);
  float4 w4 = {}, u4 = {};
  if (rem == 4) {
    w4 = __ldg(reinterpret_cast<const float4*>(w + q0));
    u4 = __ldg(reinterpret_cast<const float4*>(u + q0));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < rem) omc::lane4(w4, c) = __ldg(w + q0 + c), omc::lane4(u4, c) = __ldg(u + q0 + c);
  }
  const int b0 = q0 / DD;
  const float inv = 1.0f / (float)D;
  float f[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = 0.f;
    if (c >= rem) continue;
    const int e = q0 + c, b = b0 + (e >= (b0 + 1) * DD);
    int i, j;
    omc::divmod(e - b * DD, D, inv, i, j);
    const omc::RO Y{p.Y + (size_t)b * n * n};
    if (kind == 2) {
      f[c] = (i == j ? 1.0f : 0.f) - Y[i * n + j];
    } else if (i < n && j < n) {
      f[c] = Y[i * n + j];
    } else if (kind == 0) {
      const omc::RO Xs{p.Xs + (size_t)b * n * m}, Ths{p.Ths + (size_t)b * m * m};
      if (i < n) f[c] = __ldg(p.sX + b) * Xs[i * m + (j - n)];
      else if (j < n) f[c] = __ldg(p.sX + b) * Xs[j * m + (i - n)];
      else f[c] = __ldg(p.sT + b) * Ths[(i - n) * m + (j - n)];
    } else {
      const omc::RO U{p.U + (size_t)b * n * K};
      if (i < n) f[c] = U[i * K + (j - n)];
      else if (j < n) f[c] = U[j * K + (i - n)];
      else f[c] = (i == j) ? 1.0f : 0.f;
    }
  }
  const float alpha = p.alpha, om = 1.0f - p.alpha;
  float4 t4;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    omc::lane4(t4, c) = (alpha * f[c] + om * omc::lane4(w4, c)) + omc::lane4(u4, c);
  if (rem == 4) {
    *reinterpret_cast<float4*>(tt + q0) = t4;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < rem) tt[q0 + c] = omc::lane4(t4, c);
  }
}

// (k9b_layout; omc_torch.sdp.mccormick.k9_plan)
template <int K>
__global__ void __launch_bounds__(kThreads9) k9b_kernel(K9bParams p) {
  extern __shared__ float smem[];
  const K9bLayout l = k9b_layout(p.B, p.n, p.m, K, p.qpc);
  int x = blockIdx.x;
  if (x < p.B) {
    k9b_slot<K>(p, x, smem);
    return;
  }
  x -= p.B;
  if (x < l.t1) {
    k9b_t<K>(p, 0, x * p.qpc);
    return;
  }
  x -= l.t1;
  if (x < l.t2) {
    k9b_t<K>(p, 1, x * p.qpc);
    return;
  }
  k9b_t<K>(p, 2, (x - l.t2) * p.qpc);
}

template <typename Kernel, typename Params>
int launch_k(Kernel kern, const Params& p, int grid, int threads, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (grid > 0) kern<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int q_of(int k) { return k * (k + 1) / 2; }

// the shapes K9a and K9b take: the flat entries' (i, j) come from a float
// reciprocal (omc::divmod), exact below 2^24 entries a block, and a quad of
// t3 spans at most two slots (n >= 2)
bool k9_shape_ok(int B, int n, int m, int k) {
  return B >= 1 && n >= 2 && m >= 1 && k >= 1 && k <= 3 && n + m <= 4096;
}

}  // namespace

// K9s's CTA (omc_torch.sdp.mccormick.k9s_plan plans with them; chip_smoke.py
// holds the plan against them)
OMC_EXPORT int omc_k9s_threads(int n, int k) { return k9s_threads(n); }

OMC_EXPORT int omc_k9s_smem_bytes(int n, int k) { return 4 * k9s_smem_floats(n, k); }

OMC_EXPORT int omc_k9s_setup(const K9sParams* params, void* stream) {
  const K9sParams& p = *params;
  if (p.B < 1 || p.n < 1) return (int)cudaErrorInvalidValue;
  const int threads = k9s_threads(p.n);
  const size_t smem = (size_t)4 * k9s_smem_floats(p.n, p.k);
  switch (p.k) {
    case 1: return launch_k(k9s_kernel<1>, p, p.B, threads, smem, stream);
    case 2: return launch_k(k9s_kernel<2>, p, p.B, threads, smem, stream);
    case 3: return launch_k(k9s_kernel<3>, p, p.B, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9a's and K9b's grid widths (omc_torch.sdp.mccormick.k9_plan plans with
// them; chip_smoke.py holds the plan against them)
OMC_EXPORT int omc_k9a_grid_x(int B, int n, int m) { return k9a_layout(B, n, m).grid_x; }

OMC_EXPORT int omc_k9b_grid_x(int B, int n, int m, int k, int qpc) {
  return k9b_layout(B, n, m, k, qpc).grid_x;
}

OMC_EXPORT int omc_k9a_zstep(const K9aParams* params, void* stream) {
  const K9aParams& p = *params;
  if (!k9_shape_ok(p.B, p.n, p.m, p.k)) return (int)cudaErrorInvalidValue;
  // the slot CTA's z0 and Y diagonal
  const size_t smem = (size_t)p.n * (p.k + q_of(p.k) + 1) * sizeof(float);
  const int grid = k9a_layout(p.B, p.n, p.m).grid_x;
  switch (p.k) {
    case 1: return launch_k(k9a_kernel<1>, p, grid, kThreads9, smem, stream);
    case 2: return launch_k(k9a_kernel<2>, p, grid, kThreads9, smem, stream);
    default: return launch_k(k9a_kernel<3>, p, grid, kThreads9, smem, stream);
  }
}

OMC_EXPORT int omc_k9b_cone(const K9bParams* params, void* stream) {
  const K9bParams& p = *params;
  // w1-w3, u1-u3 and t1-t3 move as 16-byte words
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (!k9_shape_ok(p.B, p.n, p.m, p.k) || p.qpc < 32 || p.qpc > kThreads9 || p.qpc % 32 ||
      odd(p.w1) || odd(p.u1) || odd(p.w2) || odd(p.u2) || odd(p.w3) || odd(p.u3) ||
      odd(p.t1) || odd(p.t2) || odd(p.t3))
    return (int)cudaErrorInvalidValue;
  // the slot CTA's SOC slots
  const size_t smem = (size_t)p.k * (1 + p.n) * sizeof(float);
  const int grid = k9b_layout(p.B, p.n, p.m, p.k, p.qpc).grid_x;
  switch (p.k) {
    case 1: return launch_k(k9b_kernel<1>, p, grid, kThreads9, smem, stream);
    case 2: return launch_k(k9b_kernel<2>, p, grid, kThreads9, smem, stream);
    default: return launch_k(k9b_kernel<3>, p, grid, kThreads9, smem, stream);
  }
}
