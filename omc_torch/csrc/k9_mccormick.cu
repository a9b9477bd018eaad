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
// of every node slot ((n+m)^2 + (n+k)^2 + n^2 values of w and u) once with a
// few flops per element; the (k+q)^2 per-row solves are O(n (k+q)^2).  K9s
// reads 2 n k values a slot and writes n (k+q)(k+2q) values of factors; at
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
//      and (J, I) staged coalesced in shared memory (rows of 17 values, so
//      the transposed read is free of bank conflicts), both symmetrised
//      tiles written coalesced; no thread reads w1 across rows.  Small
//      tiles keep each thread's loads few (a Y entry takes six), so a flat
//      CTA's chain is about a slot CTA's.
//  K9b slot CTA: tr Y, the k SOC column norms and sum_i t[i, p], then the
//      trace, SOC, box, envelope and orthogonality slots with the running
//      means;
//  K9b flat CTAs: t1, t2, t3 in 16-byte words of the batch's flat entries
//      (quads of floats), qpc words a CTA (the plan narrows qpc until the
//      flat CTAs fill the card); each entry of a word resolves its own
//      (slot, i, j) and block.
// Every sum is over a CTA's threads in a fixed order (each thread's rows in
// order, warp shuffles, then the warps in order): no atomics, so two
// launches on the same input give the same bits.  The flat entries' (i, j)
// come from a float reciprocal (omc::divmod), with no integer divide an
// entry; operands the kernels do not write are read through the read-only
// path (omc::ROT).
//
// The wide kernels (omc_k9s_setup_wide, omc_k9a_zstep_wide,
// omc_k9b_cone_wide and their _f64 builds) take every rank and width: see
// their section below.
//
// Indices.  Every slot's blocks start at a 64-bit offset.  K9b's flat
// CTAs index the batch's B D^2 entries in int, with an int divide, where they
// fit in int (k9b_kernel, k9b_wide_kernel), and in 64 bits past it
// (k9b_kernel64, k9b_wide_kernel64: k9b_flat64, slot_of): a batch of 128
// slots at n + m = 4096 already holds 2^31.  Inside a slot the unrolled kernels' entries
// fit in int (n + m <= 4096); the wide kernels index X's, Theta's, Y's and
// w1's rows in 64 bits, since (n + m)^2 passes 2^31 past n + m = 46,340.
//
// The float64 builds (omc_k9s_setup_f64, omc_k9a_zstep_f64,
// omc_k9b_cone_f64) are the same kernels on doubles, with these changes.
// Every divide is omc::quot's (the hardware reciprocal refined, not the IEEE
// divide's slow path, around which ptxas spills), cho_solve's included; the
// pivots' reciprocal square roots are rsqrt's and the SOC norms n2 rsqrt(n2)
// (project_rsoc1's float64 form).  A 16-byte word holds a pair of doubles:
// K9s's staging keeps one word of alignment slack and stores pairs, and
// K9b's flat CTAs take a pair a thread.  K9s's CTA narrows where a chunk's
// staged doubles would pass 227 KB (k = 3 above 192 rows: 192 threads).
// A double takes two registers, so the slot CTAs hold less in flight than
// the float build does (which keeps, for K9a at k = 3, 254 registers):
// K9a's slot thread reads each row's factor Mc_i from memory as its solve
// uses it, S_i as the correction uses it and Gc as the Gc solve uses it,
// where the float build holds Mc_i, its first S_i and (thread 0) Gc in
// registers across the loads; K9b's reads a pair's four envelope rows of
// wmc, umc and acc as it updates them, where the float build loads all 4q
// of each first.  The float builds are unchanged.
#include "common.cuh"

#include <climits>

namespace {

// a pivot's reciprocal square root: the float build's rsqrtf, the float64
// build's rsqrt
__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

// a b + c, rounded once
__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

// the four envelope rows  w_r = s t + c1 U[:, j1] + c2 U[:, j2] + d >= 0
// (omc/sdp/mccormick.py mccormick_coeffs, reference lines 1688-1723)
template <class T>
__device__ __forceinline__ void envelope(int r, T lo1, T lo2, T hi1, T hi2, T& s, T& c1, T& c2,
                                         T& d) {
  switch (r) {
    case 0: s = T(1);  c1 = -lo2; c2 = -lo1; d = lo1 * lo2;    break;
    case 1: s = T(1);  c1 = -hi2; c2 = -hi1; d = hi1 * hi2;    break;
    case 2: s = T(-1); c1 = hi2;  c2 = lo1;  d = -lo1 * hi2;   break;
    default: s = T(-1); c1 = lo2; c2 = hi1;  d = -hi1 * lo2;   break;
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
template <int D, class T>
__device__ __forceinline__ void chol_rcp(T (&A)[D][D], T (&inv)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T d = A[j][j];
#pragma unroll
    for (int l = 0; l < j; ++l) d = fmadd(-A[j][l], A[j][l], d);
    const T r = rsq(d);
    A[j][j] = d * r;
    inv[j] = r;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T t = A[i][j];
#pragma unroll
      for (int l = 0; l < j; ++l) t = fmadd(-A[i][l], A[j][l], t);
      A[i][j] = t * r;
    }
  }
}

// x <- (L L')^-1 x with L lower triangular in registers
template <int D, class T>
__device__ __forceinline__ void cho_solve(const T (&L)[D][D], T (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = x[i];
#pragma unroll
    for (int l = 0; l < i; ++l) s -= L[i][l] * x[l];
    x[i] = omc::quot(s, L[i][i]);
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    T s = x[i];
#pragma unroll
    for (int l = i + 1; l < D; ++l) s -= L[l][i] * x[l];
    x[i] = omc::quot(s, L[i][i]);
  }
}

// the same solve with L row-major at g[off] in memory (read-only), each
// entry loaded where the solve uses it (the float64 builds' slot CTA)
template <int D, class T>
__device__ __forceinline__ void cho_solve_at(omc::ROT<T> g, int off, T (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = x[i];
#pragma unroll
    for (int l = 0; l < i; ++l) s -= g[off + i * D + l] * x[l];
    x[i] = omc::quot(s, g[off + i * D + i]);
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    T s = x[i];
#pragma unroll
    for (int l = i + 1; l < D; ++l) s -= g[off + l * D + i] * x[l];
    x[i] = omc::quot(s, g[off + i * D + i]);
  }
}

// the lower triangle of a row-major D x D factor at g[off], a read-only
// view of global memory
template <int D, class T>
__device__ __forceinline__ void load_lower(omc::ROT<T> g, int off, T (&L)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) L[i][j] = (j <= i) ? g[off + i * D + j] : T(0);
}

// ---------------------------------------------------------------------------
// K9s
// ---------------------------------------------------------------------------

// K9s's CTA: one a node slot, its threads n rounded up to whole warps, at
// least 128 (the warps past n's rows store and sum: at n = 50, k = 3 the
// stores drain 10% sooner) and at most 256 (a thread takes rows tid,
// tid + T, ... in chunks of T), fewer where a chunk's staging would not fit
constexpr int kThreads9s = 256, kMinThreads9s = 128;
constexpr int kMaxSmem = 227 * 1024;  // a CTA's shared memory on the H100

// dynamic shared memory of a K9s CTA of T threads, in values of elem bytes:
// a chunk's Mc and Si rows staged for the coalesced stores (each with one
// 16-byte word of alignment slack), then each warp's partial sums of G's
// lower triangle
__host__ __device__ __forceinline__ int k9s_smem_values(int T, int k, int elem) {
  const int q = k * (k + 1) / 2, kq = k + q, slack = 16 / elem;
  return (slack + T * kq * kq) + (slack + T * kq * q) + (T / 32) * (q * (q + 1) / 2);
}

__host__ __device__ __forceinline__ int k9s_threads(int n, int k, int elem) {
  int t = 32 * omc::cdiv(n, 32);
  t = t < kMinThreads9s ? kMinThreads9s : t < kThreads9s ? t : kThreads9s;
  while (t > kMinThreads9s && elem * k9s_smem_values(t, k, elem) > kMaxSmem) t -= 32;
  return t;
}

// nf values of T from shared s to global g, where s and g agree modulo 16
// bytes: scalars up to g's first 16-byte boundary, then 16-byte words (four
// floats, two doubles), then the scalar tail, the CTA's threads on
// consecutive words
template <class T>
__device__ __forceinline__ void store_span(T* __restrict__ g, const T* s, int nf) {
  using V = omc::Vec16<T>;
  constexpr int kSh = sizeof(T) == 8 ? 1 : 2;  // log2 of the values a word
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(T));
  head = head < nf ? head : nf;
  const int n4 = (nf - head) >> kSh;
  for (int q = threadIdx.x; q < head; q += blockDim.x) g[q] = s[q];
  V* g4 = reinterpret_cast<V*>(g + head);
  const V* s4 = reinterpret_cast<const V*>(s + head);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) g4[q] = s4[q];
  for (int q = head + (n4 << kSh) + threadIdx.x; q < nf; q += blockDim.x) g[q] = s[q];
}

// the place in a 16-byte aligned staging area at which a span bound for g
// starts, so that the span and g agree modulo 16 bytes
template <class T>
__device__ __forceinline__ T* staged_for(T* stage, const T* g) {
  return stage + ((reinterpret_cast<uintptr_t>(g) / sizeof(T)) & (16 / sizeof(T) - 1));
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
template <int K, class T>
__device__ __forceinline__ void k9s_gram(const T (&l)[K], const T (&h)[K],
                                         T (&A)[K + K * (K + 1) / 2][K + K * (K + 1) / 2]) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
#pragma unroll
  for (int a = 0; a < KQ; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) A[a][c] = T(0);
  int p = 0;
#pragma unroll
  for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
    for (int j2 = j1; j2 < K; ++j2, ++p) {
      if (j1 == j2) {
        const T sl = l[j1] + h[j1];
        A[j1][j1] += T(4) * (l[j1] * l[j1] + h[j1] * h[j1]) + T(2) * (sl * sl);
        A[K + p][j1] = T(-4) * sl;
      } else {
        const T s1 = l[j1] + h[j1], s2 = l[j2] + h[j2];
        A[j1][j1] += T(2) * (l[j2] * l[j2] + h[j2] * h[j2]);
        A[j2][j2] += T(2) * (l[j1] * l[j1] + h[j1] * h[j1]);
        A[j2][j1] += s1 * s2;
        A[K + p][j1] = T(-2) * s2;
        A[K + p][j2] = T(-2) * s1;
      }
    }
  // + 4 on every diagonal entry: diag(4 I_k) on U's block, 4 I_q on t's
#pragma unroll
  for (int a = 0; a < KQ; ++a) A[a][a] = (A[a][a] + T(4)) + T(1e-9);
}

template <int K, class T>
__global__ void __launch_bounds__(kThreads9s) k9s_kernel(K9sParamsT<T> p) {
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q, NG = Q * (Q + 1) / 2, S = 16 / sizeof(T);
  extern __shared__ float4 k9s_smem4[];
  T* const smem = reinterpret_cast<T*>(k9s_smem4);
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x, n = p.n;
  const int lane = tid & 31, warp = tid >> 5, nw = NT >> 5;
  T* const stMc = smem;                       // S + NT KQ^2
  T* const stSi = stMc + S + NT * KQ * KQ;    // S + NT KQ Q
  T* const red = stSi + S + NT * KQ * Q;      // nw NG
  const omc::ROT<T> lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};

  // this thread's rows' S_i[k:, :], lower triangle, summed in row order
  T gs[NG];
#pragma unroll
  for (int e = 0; e < NG; ++e) gs[e] = T(0);

  for (int r0 = 0; r0 < n; r0 += NT) {
    const int rows = min(NT, n - r0);
    T* const gMc = p.Mc + ((size_t)b * n + r0) * KQ * KQ;
    T* const gSi = p.Si + ((size_t)b * n + r0) * KQ * Q;
    T* const sMc = staged_for(stMc, gMc);
    T* const sSi = staged_for(stSi, gSi);
    if (tid < rows) {
      const int i = r0 + tid;
      T l[K], h[K];
#pragma unroll
      for (int j = 0; j < K; ++j) l[j] = lo[i * K + j], h[j] = hi[i * K + j];
      T A[KQ][KQ], inv[KQ];
      k9s_gram<K>(l, h, A);
      chol_rcp<KQ>(A, inv);
      T* const m = sMc + tid * KQ * KQ;
#pragma unroll
      for (int a = 0; a < KQ; ++a)
#pragma unroll
        for (int c = 0; c < KQ; ++c) m[a * KQ + c] = c <= a ? A[a][c] : T(0);
      // S_i e_q = M_i^-1 e_{k+q}: the forward solve starts at row k + q
      // (the right-hand side is 0 above it), then the backward solve
      T* const si = sSi + tid * KQ * Q;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        T x[KQ];
#pragma unroll
        for (int a = 0; a < K + q; ++a) x[a] = T(0);
        x[K + q] = inv[K + q];
#pragma unroll
        for (int a = K + q + 1; a < KQ; ++a) {
          T t = T(0);
#pragma unroll
          for (int c = K + q; c < a; ++c) t = fmadd(-A[a][c], x[c], t);
          x[a] = t * inv[a];
        }
#pragma unroll
        for (int a = KQ - 1; a >= 0; --a) {
          T t = x[a];
#pragma unroll
          for (int c = a + 1; c < KQ; ++c) t = fmadd(-A[c][a], x[c], t);
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
    T v = gs[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * NG + e] = v;
  }
  __syncthreads();
  if (warp == 0) {
    T g = T(0);
    if (lane < NG)
      for (int w = 0; w < nw; ++w) g += red[w * NG + lane];
    T G[Q][Q], ginv[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
      for (int c = 0; c <= a; ++c)
        G[a][c] = (a == c ? T(1) : T(0)) + __shfl_sync(0xffffffffu, g, a * (a + 1) / 2 + c);
    if (lane == 0) {
      chol_rcp<Q>(G, ginv);
      T* const Gc = p.Gc + (size_t)b * Q * Q;
#pragma unroll
      for (int a = 0; a < Q; ++a)
#pragma unroll
        for (int c = 0; c < Q; ++c) Gc[a * Q + c] = c <= a ? G[a][c] : T(0);
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
  l.x = (int)(((long long)n * m + kXChunk - 1) / kXChunk);
  l.th = tm * (tm + 1) / 2;
  l.y = tn * (tn + 1) / 2;
  l.units = l.x + l.th + l.y;
  l.grid_x = B + B * l.units;
  return l;
}

// K9b: B slot CTAs, then CTAs of qpc 16-byte words (E = 4 floats or 2
// doubles) of consecutive entries of the batch's flat t1, t2, t3
struct K9bLayout {
  int t1, t2, t3, grid_x;
};

// I: the type of the flat entries' indices, int (the old kernels) or long
// long past 2^31 (k9b_kernel64, k9b_wide_kernel64)
template <class I = int>
__host__ __device__ __forceinline__ K9bLayout k9b_layout(int B, int n, int m, int k, int qpc,
                                                         int E) {
  K9bLayout l;
  const int d1 = n + m, d2 = n + k;
  l.t1 = (int)((((I)B * d1 * d1 + E - 1) / E + qpc - 1) / qpc);
  l.t2 = (int)((((I)B * d2 * d2 + E - 1) / E + qpc - 1) / qpc);
  l.t3 = (int)((((I)B * n * n + E - 1) / E + qpc - 1) / qpc);
  l.grid_x = B + l.t1 + l.t2 + l.t3;
  return l;
}

// whether K9b indexes the batch's flat entries past int: where any kind's
// B D^2 entries, or a word a CTA of qpc <= kThreads9 words could take, pass
// INT_MAX
__host__ __device__ __forceinline__ bool k9b_flat64(int B, int n, int m, int k, int E) {
  const long long D = n + (m > k ? m : k);
  return B * D * D > INT_MAX - E * kThreads9;
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
// correction touches.  The float build holds the row's factor, the thread's
// first S_i and (thread 0) Gc in registers; the float64 build reads them
// where they are used (kHold).
template <int K, class T>
__device__ __forceinline__ void k9a_slot(const K9aParamsT<T>& p, int b, T* smem) {
  using omc::quot;
  using RO = omc::ROT<T>;
  constexpr int Q = K * (K + 1) / 2, KQ = K + Q;
  constexpr bool kHold = sizeof(T) == 4;
  __shared__ T red[kWarps9][Q + 1];
  __shared__ T tot[Q + 1];  // tcorr, then tr(rho gY / 3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m, D1 = n + m, D2 = n + K;
  T* z0s = smem;          // n * KQ
  T* ydg = z0s + n * KQ;  // n     rho gY_ii / 3
  const T rho = __ldg(p.rho + b);
  const RO w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const RO w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const RO w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  const RO wsoc{p.wsoc + (size_t)b * K * (1 + n)}, usoc{p.usoc + (size_t)b * K * (1 + n)};
  const RO wbox{p.wbox + (size_t)b * n * K}, ubox{p.ubox + (size_t)b * n * K};
  const RO wmc{p.wmc + (size_t)b * 4 * n * Q}, umc{p.umc + (size_t)b * 4 * n * Q};
  const RO lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};
  const RO Mc{p.Mc + (size_t)b * n * KQ * KQ}, Si{p.Si + (size_t)b * n * KQ * Q};
  const RO Gcg{p.Gc + (size_t)b * Q * Q};
  T* __restrict__ U = p.U + (size_t)b * n * K;
  T* __restrict__ t = p.t + (size_t)b * n * Q;
  T* __restrict__ Y = p.Y + (size_t)b * n * n;
  const T y4 = __ldg(p.w4 + b) - __ldg(p.u4 + b) - T(K);
  T yo[Q];  // the orthogonality rows' residual, the same for every row
#pragma unroll
  for (int pp = 0; pp < Q; ++pp) {
    int j1 = 0, j2 = 0;
    pair_of<K>(pp, j1, j2);
    yo[pp] = __ldg(p.worth + b * Q + pp) - __ldg(p.uorth + b * Q + pp) + (j1 == j2 ? T(1) : T(0));
  }

  // (float build) the S_i of the thread's first row and (thread 0) Gc, in
  // flight across the rows' solves and the sums
  T si[kHold ? KQ * Q : 1], G[kHold ? Q : 1][kHold ? Q : 1];
  if constexpr (kHold) {
    if (tid < n) {
#pragma unroll
      for (int c = 0; c < KQ * Q; ++c) si[c] = Si[tid * KQ * Q + c];
    }
    if (tid == 0) load_lower<Q>(Gcg, 0, G);
  }

  T part[Q + 1];
#pragma unroll
  for (int a = 0; a <= Q; ++a) part[a] = T(0);
  for (int i = tid; i < n; i += kThreads9) {
    T a2[K], as[K], ab[K], l[K], h[K], ym[4][Q], L[kHold ? KQ : 1][kHold ? KQ : 1];
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
    if constexpr (kHold) load_lower<KQ>(Mc, i * KQ * KQ, L);
    const T d1 = w1[i * D1 + i] - u1[i * D1 + i], d2 = w2[i * D2 + i] - u2[i * D2 + i];
    const T d3 = w3[i * n + i] - u3[i * n + i];

    T r[KQ], g1[K], g2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      r[j] = T(2) * a2[j] + as[j] + ab[j];
      g1[j] = T(0);
      g2[j] = T(0);
    }
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp) {
        T mc1 = T(0), mc2 = T(0), gt = T(0);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          T s, c1, c2, d;
          envelope(rr, l[j1], l[j2], h[j1], h[j2], s, c1, c2, d);
          const T y = ym[rr][pp] - d;
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
    if constexpr (kHold) cho_solve<KQ>(L, r);
    else cho_solve_at<KQ>(Mc, i * KQ * KQ, r);
#pragma unroll
    for (int c = 0; c < KQ; ++c) z0s[i * KQ + c] = r[c];
#pragma unroll
    for (int a = 0; a < Q; ++a) part[a] += r[K + a];
    // Y_ii before the trace correction: rho gY_ii / 3
    const T yp = quot(rho * ((d1 + d2 - (d3 - T(1))) - y4), T(3));
    ydg[i] = yp;
    part[Q] += yp;
  }
#pragma unroll
  for (int a = 0; a <= Q; ++a) {
    const T v = omc::warp_sum(part[a]);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (tid == 0) {
    T x[Q + 1];
#pragma unroll
    for (int a = 0; a <= Q; ++a) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kWarps9; ++w) s += red[w][a];
      x[a] = s;
    }
    T z[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a) z[a] = x[a];
    if constexpr (kHold) cho_solve<Q>(G, z);
    else cho_solve_at<Q>(Gcg, 0, z);
#pragma unroll
    for (int a = 0; a < Q; ++a) tot[a] = z[a];
    tot[Q] = x[Q];
  }
  __syncthreads();

  T tc[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) tc[a] = tot[a];
  const T ctr = quot(tot[Q], T(3) + T(n));
  for (int i = tid; i < n; i += kThreads9) {
    if constexpr (kHold) {
      if (i != tid) {
#pragma unroll
        for (int c = 0; c < KQ * Q; ++c) si[c] = Si[i * KQ * Q + c];
      }
    }
#pragma unroll
    for (int c = 0; c < KQ; ++c) {
      T s = T(0);
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        if constexpr (kHold) s += si[c * Q + a] * tc[a];
        else s += Si[i * KQ * Q + c * Q + a] * tc[a];
      }
      const T z = quot(z0s[i * KQ + c] - s, rho);
      if (c < K) U[i * K + c] = z;
      else t[i * Q + (c - K)] = z;
    }
    const T a = quot(ydg[i] - ctr, rho);
    Y[i * n + i] = T(0.5) * (a + a);
  }
}

// (i, j) = divmod(e, W) for every e >= 0 of type I (int, or long long
// where a slot's entries pass 2^31), the wide kernels' split of the flat
// entries at any width: omc::divmod's float estimate, corrected until j
// lies in [0, W) (one step at most while e / W < 2^21: the estimate's
// error is a few float ulps of e / W)
template <class I>
__device__ __forceinline__ void k9_split(I e, int W, float inv, int& i, int& j) {
  i = __float2int_rz(((float)e + 0.5f) * inv);
  I r = e - (I)i * W;
  while (r < 0) --i, r += W;
  while (r >= W) ++i, r -= W;
  j = (int)r;
}

// X chunk `chunk` of slot b: zX = (rho gX + sX mask A) / (mask sX^2 + 2 rho
// sX^2), kXItems entries a thread, every load before the first store; the
// wide kernel (kExact) splits the entries with k9_split and indexes them,
// and w1's, in 64 bits (n (n + m) passes 2^31 past n + m = 46,340)
template <class T, bool kExact = false>
__device__ __forceinline__ void k9a_x(const K9aParamsT<T>& p, int b, int chunk) {
  using I = typename std::conditional<kExact, long long, int>::type;
  const int n = p.n, m = p.m, D1 = n + m;
  const I nm = (I)n * m;
  const omc::ROT<T> w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::ROT<T> maskA{p.maskA}, mask{p.mask};
  T* __restrict__ Xs = p.Xs + (size_t)b * nm;
  const T rho = __ldg(p.rho + b), sX = __ldg(p.sX + b);
  const float inv = 1.0f / (float)m;
  const I e0 = (I)chunk * kXChunk + threadIdx.x;
  T d[kXItems], ma[kXItems], mk[kXItems];
#pragma unroll
  for (int u = 0; u < kXItems; ++u) {
    const I e = e0 + u * kThreads9;
    if (e < nm) {
      int i, j;
      if constexpr (kExact) k9_split(e, m, inv, i, j);
      else omc::divmod(e, m, inv, i, j);
      const I q = (I)i * D1 + n + j;
      d[u] = w1[q] - u1[q];
      ma[u] = maskA[e];
      mk[u] = mask[e];
    }
  }
#pragma unroll
  for (int u = 0; u < kXItems; ++u) {
    const I e = e0 + u * kThreads9;
    if (e < nm) {
      const T gX = sX * T(2) * d[u];
      const T rX = rho * gX + sX * ma[u];
      const T dX = mk[u] * (sX * sX) + rho * T(2) * sX * sX;
      Xs[e] = omc::quot(rX, dX);
    }
  }
}

// A tile pair of an N x N block whose entry (i, j) stages as v(i, j): tile
// (I, J) into sA and, for I < J, tile (J, I) into sB; thread x on column x %
// kTile of rows x / kTile, x / kTile + kTileRows, ... (a half-warp on a
// row's consecutive columns: coalesced); rows stride kTile + 1 values, so
// the transposed reads below fall in distinct banks (floats) or distinct
// bank pairs (doubles) for a half-warp
template <class T, class V>
__device__ __forceinline__ void stage_pair(int N, int I, int J, V v, T (*sA)[kTile + 1],
                                           T (*sB)[kTile + 1]) {
  const int col = threadIdx.x % kTile, row = threadIdx.x / kTile;
  T a[kTilePasses], c[kTilePasses];
#pragma unroll
  for (int u = 0; u < kTilePasses; ++u) {
    const int r = row + kTileRows * u;
    a[u] = c[u] = T(0);
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
template <class T, class S>
__device__ __forceinline__ void store_pair(int N, int I, int J, S sym, T* __restrict__ out,
                                           const T (*sA)[kTile + 1], const T (*sB)[kTile + 1]) {
  const int col = threadIdx.x % kTile, row = threadIdx.x / kTile;
  const T(*tB)[kTile + 1] = (I == J) ? sA : sB;
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
// d = w1 - u1 of the Theta block, dg = sT / (2 gamma) on the diagonal.  Ix:
// the in-slot index type (the wide kernel's long long: m (n + m) passes
// 2^31 past n + m = 46,340)
template <class T, class Ix = int>
__device__ __forceinline__ void k9a_theta(const K9aParamsT<T>& p, int b, int pair,
                                          T (*sA)[kTile + 1], T (*sB)[kTile + 1]) {
  using omc::quot;
  const int n = p.n, m = p.m, D1 = n + m;
  int I, J;
  tile_pair(pair, omc::cdiv(m, kTile), I, J);
  const omc::ROT<T> w1{p.w1 + (size_t)b * D1 * D1 + (size_t)n * D1 + n};
  const omc::ROT<T> u1{p.u1 + (size_t)b * D1 * D1 + (size_t)n * D1 + n};
  stage_pair(m, I, J, [&](int i, int j) {
    const Ix q = (Ix)i * D1 + j;
    return w1[q] - u1[q];
  }, sA, sB);
  const T rho = __ldg(p.rho + b), sT = __ldg(p.sT + b);
  const T cth = quot(sT * T(0.5), p.gamma), den = rho * sT * sT;
  store_pair(m, I, J, [&](int i, int j, T x, T y, T* __restrict__ out) {
    const T dg = (i == j) ? cth : T(0);
    const T za = quot(rho * (sT * x) - dg, den);
    const T zb = quot(rho * (sT * y) - dg, den);
    out[(Ix)i * m + j] = T(0.5) * (za + zb);
  }, p.Ths + (size_t)b * m * m, sA, sB);
}

// Y tile pair `pair` of slot b, off the diagonal (the slot CTA writes the
// diagonal): Y = sym((rho gY / 3) / rho), gY = (w1 - u1) + (w2 - u2) -
// (w3 - u3) of the Y blocks (w2's order n + K); Ix as k9a_theta's
template <class T, class Ix = int>
__device__ __forceinline__ void k9a_y(const K9aParamsT<T>& p, int b, int pair, T (*sA)[kTile + 1],
                                      T (*sB)[kTile + 1], int K) {
  using omc::quot;
  const int n = p.n, m = p.m, D1 = n + m, D2 = n + K;
  int I, J;
  tile_pair(pair, omc::cdiv(n, kTile), I, J);
  const omc::ROT<T> w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::ROT<T> w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const omc::ROT<T> w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  stage_pair(n, I, J, [&](int i, int j) {
    const Ix q1 = (Ix)i * D1 + j, q2 = (Ix)i * D2 + j, q3 = (Ix)i * n + j;
    return (w1[q1] - u1[q1]) + (w2[q2] - u2[q2]) - (w3[q3] - u3[q3] - T(0));
  }, sA, sB);
  const T rho = __ldg(p.rho + b);
  store_pair(n, I, J, [&](int i, int j, T x, T y, T* __restrict__ out) {
    if (i == j) return;
    const T a = quot(quot(rho * x, T(3)) - T(0), rho);
    const T c = quot(quot(rho * y, T(3)) - T(0), rho);
    out[(Ix)i * n + j] = T(0.5) * (a + c);
  }, p.Y + (size_t)b * n * n, sA, sB);
}

// (k9a_layout; omc_torch.sdp.mccormick.k9_plan)
template <int K, class T>
__global__ void __launch_bounds__(kThreads9) k9a_kernel(K9aParamsT<T> p) {
  extern __shared__ float smem[];
  __shared__ T sA[kTile][kTile + 1], sB[kTile][kTile + 1];
  const K9aLayout l = k9a_layout(p.B, p.n, p.m);
  int x = blockIdx.x;
  if (x < p.B) {
    k9a_slot<K>(p, x, reinterpret_cast<T*>(smem));
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
  k9a_y(p, b, u - l.th, sA, sB, K);
}

// ---------------------------------------------------------------------------
// K9b
// ---------------------------------------------------------------------------

// The slot CTA of slot b: per row (a thread a row, the row's loads first)
// the box slot and the envelope rows with their running mean, the SOC
// slots' t kept in shared memory, and each thread's parts of tr Y, the k
// SOC column norms and sum_i t[i, p] in row order; the sums by warp
// shuffles, then the warps in order; then the trace, SOC and orthogonality
// slots.  The float build loads the row's 4q envelope rows of wmc, umc and
// acc before it updates any; the float64 build a pair's four as it updates
// them (kHold).
template <int K, class T>
__device__ __forceinline__ void k9b_slot(const K9bParamsT<T>& p, int b, T* smem) {
  constexpr int Q = K * (K + 1) / 2, NS = 1 + K + Q;  // tr Y, |tsoc_j[1:]|^2, sum_i t
  constexpr bool kHold = sizeof(T) == 4;
  constexpr int QH = kHold ? Q : 1;
  __shared__ T red[kWarps9][NS];
  __shared__ T tot[NS];
  __shared__ T head[K];  // tsoc_j[0]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  const T alpha = p.alpha, om = T(1) - p.alpha;
  const T rho = __ldg(p.rho + b);
  const omc::ROT<T> Y{p.Y + (size_t)b * n * n}, U{p.U + (size_t)b * n * K};
  const omc::ROT<T> t{p.t + (size_t)b * n * Q};
  const omc::ROT<T> lo{p.U_lo + (size_t)b * n * K}, hi{p.U_hi + (size_t)b * n * K};
  T* __restrict__ wsoc = p.wsoc + (size_t)b * K * (1 + n);
  T* __restrict__ usoc = p.usoc + (size_t)b * K * (1 + n);
  T* __restrict__ wbox = p.wbox + (size_t)b * n * K;
  T* __restrict__ ubox = p.ubox + (size_t)b * n * K;
  T* __restrict__ wmc = p.wmc + (size_t)b * 4 * n * Q;
  T* __restrict__ umc = p.umc + (size_t)b * 4 * n * Q;
  T* __restrict__ acc = p.acc_mc ? p.acc_mc + (size_t)b * 4 * n * Q : nullptr;
  T* sv = smem;  // K * (1 + n): tsoc

  if (tid < K) head[tid] = (alpha * T(1) + om * wsoc[tid * (1 + n)]) + usoc[tid * (1 + n)];
  // the trace and orthogonality slots' w and u, in flight across the sums
  const size_t qo = (size_t)b * Q + min(tid, Q - 1);
  const T w4 = p.w4[b], u4 = p.u4[b], wo = p.worth[qo], uo = p.uorth[qo];
  const T ao = p.acc_orth ? p.acc_orth[qo] : T(0);
  T part[NS];
#pragma unroll
  for (int a = 0; a < NS; ++a) part[a] = T(0);
  for (int i = tid; i < n; i += kThreads9) {
    T Ui[K], ti[Q], ws[K], us[K], wb[K], ub[K], l[K], h[K], wm[4][QH], um[4][QH], am[4][QH];
    const T yii = Y[i * n + i];
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
    if constexpr (kHold) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int pp = 0; pp < Q; ++pp) {
          const int q = (rr * n + i) * Q + pp;
          wm[rr][pp] = wmc[q];
          um[rr][pp] = umc[q];
          am[rr][pp] = acc ? acc[q] : T(0);
        }
    }

    part[0] += yii;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const T v = (alpha * Ui[j] + om * ws[j]) + us[j];
      sv[j * (1 + n) + 1 + i] = v;
      part[1 + j] += v * v;
    }
#pragma unroll
    for (int pp = 0; pp < Q; ++pp) part[1 + K + pp] += ti[pp];
    // box slot
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const T v = (alpha * Ui[j] + om * wb[j]) + ub[j];
      const T w = fmin(fmax(v, l[j]), h[j]);
      wbox[i * K + j] = w;
      ubox[i * K + j] = v - w;
    }
    // envelope rows (>= 0) and their running mean
    int pp = 0;
#pragma unroll
    for (int j1 = 0; j1 < K; ++j1)
#pragma unroll
      for (int j2 = j1; j2 < K; ++j2, ++pp) {
        const int ph = kHold ? pp : 0;  // the pair's place in wm, um, am
        if constexpr (!kHold) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int q = (rr * n + i) * Q + pp;
            wm[rr][0] = wmc[q];
            um[rr][0] = umc[q];
            am[rr][0] = acc ? acc[q] : T(0);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          T s, c1, c2, d;
          envelope(rr, l[j1], l[j2], h[j1], h[j2], s, c1, c2, d);
          const T f = ((s * ti[pp] + c1 * Ui[j1]) + c2 * Ui[j2]) + d;
          const int q = (rr * n + i) * Q + pp;
          const T v = (alpha * f + om * wm[rr][ph]) + um[rr][ph];
          const T w = fmax(v, T(0)), u = v - w;
          wmc[q] = w;
          umc[q] = u;
          if (acc) acc[q] = am[rr][ph] + p.beta * (rho * u - am[rr][ph]);
        }
      }
  }
#pragma unroll
  for (int a = 0; a < NS; ++a) {
    const T v = omc::warp_sum(part[a]);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (tid < NS) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps9; ++w) s += red[w][tid];
    tot[tid] = s;
  }
  __syncthreads();

  // trace slot
  if (tid == 0) {
    const T t4 = (alpha * (T(K) - tot[0]) + om * w4) + u4;
    const T w = fmax(t4, T(0));
    p.w4[b] = w;
    p.u4[b] = t4 - w;
  }
  // SOC slots (1, U_j): nj = |tsoc_j[1:]|, sqrtf in the float build, n2
  // rsqrt(n2) in the float64 build (whose scale takes tt rsqrt(n2) for tt /
  // nj)
  for (int e = tid; e < K * (1 + n); e += kThreads9) {
    int j = 0, q = e;
    while (q >= 1 + n) q -= 1 + n, ++j;
    const T tt = head[j], n2 = tot[1 + j];
    T nj, inv = T(0);
    if constexpr (kHold) {
      nj = sqrtf(n2);
    } else {
      inv = n2 > T(0) ? rsq(n2) : T(0);
      nj = n2 * inv;
    }
    const T v = (q == 0) ? tt : sv[e];
    T w;
    if (nj <= tt) w = v;
    else if (nj <= -tt) w = T(0);
    else if (q == 0) w = T(0.5) * (tt + nj);
    else if constexpr (kHold) w = (nj > 0.f ? 0.5f * (1.0f + tt / nj) : 0.f) * v;
    else w = (T(0.5) * (T(1) + tt * inv)) * v;  // nj > |tt| >= 0 here
    wsoc[e] = w;
    usoc[e] = v - w;
  }
  // orthogonality rows (= 0) and their running mean
  if (tid < Q) {
    int j1 = 0, j2 = 0;
    pair_of<K>(tid, j1, j2);
    const T f = tot[1 + K + tid] - ((j1 == j2) ? T(1) : T(0));
    const T v = (alpha * f + om * wo) + uo;
    p.worth[qo] = T(0);
    p.uorth[qo] = v;
    if (p.acc_orth) p.acc_orth[qo] = ao + p.beta * (rho * v - ao);
  }
}

// the slot e / DD of flat entry e: an int divide, or in 64 bits a float
// estimate corrected until it brackets e (no 64-bit divide; the estimate is
// off by a few float ulps of the slot, one slot at most below 2^21 slots)
__device__ __forceinline__ int slot_of(int e, int DD) { return e / DD; }
__device__ __forceinline__ int slot_of(long long e, long long DD) {
  int b = __float2int_rz(__fdividef((float)e, (float)DD));
  while ((long long)b * DD > e) --b;
  while ((long long)(b + 1) * DD <= e) ++b;
  return b;
}

// t1 (kind 0), t2 (1) or t3 (2) on the words [word0, word0 + qpc) of the
// batch's flat B D^2: t = alpha f + (1 - alpha) w + u, a 16-byte word of E
// consecutive entries a thread (4 floats, 2 doubles), w, u and t as 16-byte
// words; a word may straddle a row, a block or a slot, so each entry
// resolves its own (b, i, j) and block of f (the wide kernel, kExact, with
// k9_split); every load before the store.  I indexes the flat entries and a
// slot's: int, or long long where they pass it (k9b_flat64)
template <class T, bool kExact, class I>
__device__ __forceinline__ void k9b_t(const K9bParamsT<T>& p, int kind, I word0, int K) {
  using V = omc::Vec16<T>;
  constexpr int E = 16 / sizeof(T);
  using omc::lane4;
  const int n = p.n, m = p.m;
  const int D = kind == 0 ? n + m : kind == 1 ? n + K : n;
  const I DD = (I)D * D, tot = (I)p.B * DD;
  const I q0 = E * (word0 + (I)threadIdx.x);
  if ((int)threadIdx.x >= p.qpc || q0 >= tot) return;
  const T* __restrict__ w = kind == 0 ? p.w1 : kind == 1 ? p.w2 : p.w3;
  const T* __restrict__ u = kind == 0 ? p.u1 : kind == 1 ? p.u2 : p.u3;
  T* __restrict__ tt = kind == 0 ? p.t1 : kind == 1 ? p.t2 : p.t3;
  const int rem = (int)(tot - q0 < E ? tot - q0 : E);
  V w4 = {}, u4 = {};
  if (rem == E) {
    w4 = __ldg(reinterpret_cast<const V*>(w + q0));
    u4 = __ldg(reinterpret_cast<const V*>(u + q0));
  } else {
#pragma unroll
    for (int c = 0; c < E; ++c)
      if (c < rem) lane4(w4, c) = __ldg(w + q0 + c), lane4(u4, c) = __ldg(u + q0 + c);
  }
  const int b0 = slot_of(q0, DD);
  const float inv = 1.0f / (float)D;
  T f[E];
#pragma unroll
  for (int c = 0; c < E; ++c) {
    f[c] = T(0);
    if (c >= rem) continue;
    const I e = q0 + c;
    const int b = b0 + (e >= (I)(b0 + 1) * DD);
    int i, j;
    if constexpr (kExact) k9_split(e - (I)b * DD, D, inv, i, j);
    else omc::divmod((int)(e - (I)b * DD), D, inv, i, j);
    const omc::ROT<T> Y{p.Y + (size_t)b * n * n};
    if (kind == 2) {
      f[c] = (i == j ? T(1) : T(0)) - Y[(I)i * n + j];
    } else if (i < n && j < n) {
      f[c] = Y[(I)i * n + j];
    } else if (kind == 0) {
      const omc::ROT<T> Xs{p.Xs + (size_t)b * n * m}, Ths{p.Ths + (size_t)b * m * m};
      if (i < n) f[c] = __ldg(p.sX + b) * Xs[(I)i * m + (j - n)];
      else if (j < n) f[c] = __ldg(p.sX + b) * Xs[(I)j * m + (i - n)];
      else f[c] = __ldg(p.sT + b) * Ths[(I)(i - n) * m + (j - n)];
    } else {
      const omc::ROT<T> U{p.U + (size_t)b * n * K};
      if (i < n) f[c] = U[i * K + (j - n)];
      else if (j < n) f[c] = U[j * K + (i - n)];
      else f[c] = (i == j) ? T(1) : T(0);
    }
  }
  const T alpha = p.alpha, om = T(1) - p.alpha;
  V t4;
#pragma unroll
  for (int c = 0; c < E; ++c) lane4(t4, c) = (alpha * f[c] + om * lane4(w4, c)) + lane4(u4, c);
  if (rem == E) {
    *reinterpret_cast<V*>(tt + q0) = t4;
  } else {
#pragma unroll
    for (int c = 0; c < E; ++c)
      if (c < rem) tt[q0 + c] = lane4(t4, c);
  }
}

// (k9b_layout; omc_torch.sdp.mccormick.k9_plan)
template <int K, class T, class I>
__device__ __forceinline__ void k9b_body(const K9bParamsT<T>& p) {
  extern __shared__ float smem[];
  const K9bLayout l = k9b_layout<I>(p.B, p.n, p.m, K, p.qpc, 16 / sizeof(T));
  int x = blockIdx.x;
  if (x < p.B) {
    k9b_slot<K>(p, x, reinterpret_cast<T*>(smem));
    return;
  }
  x -= p.B;
  if (x < l.t1) {
    k9b_t<T, false, I>(p, 0, (I)x * p.qpc, K);
    return;
  }
  x -= l.t1;
  if (x < l.t2) {
    k9b_t<T, false, I>(p, 1, (I)x * p.qpc, K);
    return;
  }
  k9b_t<T, false, I>(p, 2, (I)(x - l.t2) * p.qpc, K);
}

template <int K, class T>
__global__ void __launch_bounds__(kThreads9) k9b_kernel(K9bParamsT<T> p) {
  k9b_body<K, T, int>(p);
}

// past 2^31 flat entries (k9b_flat64)
template <int K, class T>
__global__ void __launch_bounds__(kThreads9) k9b_kernel64(K9bParamsT<T> p) {
  k9b_body<K, T, long long>(p);
}

// ---------------------------------------------------------------------------
// The wide kernels (any k >= 1, any n + m): K9s's, K9a's and K9b's work at
// a runtime rank, for k >= 4, n + m > 4096 or a slot CTA's staging past
// shared memory (omc_torch.sdp.mccormick.k9s_plan, k9_plan).  A row's
// (k+q) x (k+q) system is held in memory, not in registers: K9s builds
// M_i in its output Mc_i and factors it there, a warp a row
// (omc::warp_cholesky); K9a solves a row's system in place in its outputs
// (U_i, t_i), reading Mc_i and S_i where it uses them; K9b's slot CTA takes
// its k column norms, 4q envelope rows a row and q row sums as loops over
// the entries.  Every sum is in a fixed order (a warp's lanes over the rows
// in order, then xor shuffles; the warps' sums each its own), so two
// launches give the same bits; K9a's and K9b's flat CTAs split the entries
// exactly at any width (k9_split).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int tri_of(int k) { return k * (k + 1) / 2; }

// pair p of rank k -> (j1, j2), j1 <= j2, in omc's order (pair_indices),
// and back
__device__ __forceinline__ void pair_at(int p, int k, int& j1, int& j2) {
  j1 = 0;
  while (p >= k - j1) p -= k - j1, ++j1;
  j2 = j1 + p;
}
__device__ __forceinline__ int pair_index(int j1, int j2, int k) {
  return j1 * k - j1 * (j1 - 1) / 2 + (j2 - j1);
}

// entry (a, c), c <= a, of row i's Gram M_i from the box entries l, h of
// the row (k9s_gram's structure and order of sums)
template <class T>
__device__ __forceinline__ T k9s_gram_entry(const T* l, const T* h, int k, int a, int c) {
  if (a < k) {
    if (c < a) return (l[c] + h[c]) * (l[a] + h[a]);
    T s = T(0);
    for (int o = 0; o < k; ++o) {
      if (o == a) {
        const T sl = l[a] + h[a];
        s += T(4) * (l[a] * l[a] + h[a] * h[a]) + T(2) * (sl * sl);
      } else {
        s += T(2) * (l[o] * l[o] + h[o] * h[o]);
      }
    }
    return (s + T(4)) + T(1e-9);
  }
  if (c >= k) return c == a ? (T(0) + T(4)) + T(1e-9) : T(0);
  int j1, j2;
  pair_at(a - k, k, j1, j2);
  if (j1 == j2) return c == j1 ? T(-4) * (l[j1] + h[j1]) : T(0);
  return c == j1 ? T(-2) * (l[j2] + h[j2]) : c == j2 ? T(-2) * (l[j1] + h[j1]) : T(0);
}

// K9s, rows: a warp a row (kWarps9 rows a CTA): M_i's entries over the
// lanes into Mc_i (zero above the diagonal), its Cholesky factor in place,
// then S_i e_c = M_i^-1 e_{k+c} for each c, in place in Si_i's column c
template <class T>
__global__ void __launch_bounds__(kThreads9) k9s_rows_wide(K9sParamsT<T> p) {
  const int k = p.k, q = tri_of(k), kq = k + q, n = p.n, R = omc::cdiv(n, kWarps9);
  const int b = blockIdx.x / R, i = (blockIdx.x - b * R) * kWarps9 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const T* l = p.U_lo + ((size_t)b * n + i) * k;
  const T* h = p.U_hi + ((size_t)b * n + i) * k;
  T* const M = p.Mc + ((size_t)b * n + i) * kq * kq;
  for (int e = lane; e < kq * kq; e += 32) {
    const int a = e / kq, c = e - a * kq;
    M[e] = c <= a ? k9s_gram_entry(l, h, k, a, c) : T(0);
  }
  __syncwarp();
  const auto ix = [kq](int r, int c) { return r * kq + c; };
  omc::warp_cholesky(M, kq, ix);
  T* const S = p.Si + ((size_t)b * n + i) * kq * q;
  for (int c = 0; c < q; ++c) {
    for (int a = lane; a < kq; a += 32) S[a * q + c] = a == k + c ? T(1) : T(0);
    __syncwarp();
    omc::warp_cho_solve(M, kq, ix, [S, q, c](int a) -> T& { return S[a * q + c]; }, k + c);
  }
}

// K9s, G: a CTA a slot; G = I + sum_i S_i[k:, :], entry (a, c) by warp (a q
// + c) % kWarps9 (its rows over the lanes in order, xor shuffles), into Gc
// (zero above the diagonal), then warp 0 factors Gc in place
template <class T>
__global__ void __launch_bounds__(kThreads9) k9s_g_wide(K9sParamsT<T> p) {
  const int k = p.k, q = tri_of(k), kq = k + q, n = p.n, b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* const Gc = p.Gc + (size_t)b * q * q;
  const T* S = p.Si + (size_t)b * n * kq * q;
  for (int e = warp; e < q * q; e += kWarps9) {
    const int a = e / q, c = e - a * q;
    T s = T(0);
    if (c <= a)
      for (int i = lane; i < n; i += 32) s += S[((size_t)i * kq + k + a) * q + c];
    s = omc::warp_sum(s);
    if (lane == 0) Gc[e] = c <= a ? (a == c ? T(1) : T(0)) + s : T(0);
  }
  __syncthreads();
  if (warp == 0) omc::warp_cholesky(Gc, q, [q](int r, int c) { return r * q + c; });
}

// K9a, row i of slot b (a warp): the (U, t) right-hand side over the lanes
// into U_i and t_i (k9a_slot's sums in its order), Y_ii before the trace
// correction (rho gY_ii / 3), then z0_i = M_i^-1 r in place
template <class T>
__device__ __forceinline__ void k9a_row_wide(const K9aParamsT<T>& p, int b, int i) {
  using omc::quot;
  using RO = omc::ROT<T>;
  const int k = p.k, q = tri_of(k), kq = k + q, n = p.n, m = p.m, D1 = n + m, D2 = n + k;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const RO w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const RO w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const RO w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  const RO wsoc{p.wsoc + (size_t)b * k * (1 + n)}, usoc{p.usoc + (size_t)b * k * (1 + n)};
  const RO wbox{p.wbox + ((size_t)b * n + i) * k}, ubox{p.ubox + ((size_t)b * n + i) * k};
  const RO wmc{p.wmc + (size_t)b * 4 * n * q}, umc{p.umc + (size_t)b * 4 * n * q};
  const RO lo{p.U_lo + ((size_t)b * n + i) * k}, hi{p.U_hi + ((size_t)b * n + i) * k};
  T* const U = p.U + ((size_t)b * n + i) * k;
  T* const t = p.t + ((size_t)b * n + i) * q;
  const T rho = __ldg(p.rho + b);
  // pair (j1, j2)'s envelope duals summed against c1 (which = 1), c2 (2) or s (0)
  const auto pair_sum = [&](int j1, int j2, int which) {
    const int pp = pair_index(j1, j2, k);
    const T l1 = lo[j1], l2 = lo[j2], h1 = hi[j1], h2 = hi[j2];
    T acc = T(0);
    for (int rr = 0; rr < 4; ++rr) {
      T s, c1, c2, d;
      envelope(rr, l1, l2, h1, h2, s, c1, c2, d);
      const size_t qi = ((size_t)rr * n + i) * q + pp;
      const T y = (wmc[qi] - umc[qi]) - d;
      acc += y * (which == 1 ? c1 : which == 2 ? c2 : s);
    }
    return acc;
  };
  for (int c = lane; c < kq; c += 32) {
    if (c < k) {
      const size_t q2 = (size_t)i * D2 + n + c;
      const int qs = c * (1 + n) + 1 + i;
      const T r = T(2) * (w2[q2] - u2[q2]) + (wsoc[qs] - usoc[qs]) + (wbox[c] - ubox[c]);
      T g1 = T(0), g2 = T(0);
      for (int j2 = c; j2 < k; ++j2) g1 += pair_sum(c, j2, 1);
      for (int j1 = 0; j1 <= c; ++j1) g2 += pair_sum(j1, c, 2);
      U[c] = rho * ((r + g1) + g2);
    } else {
      const int pp = c - k;
      int j1, j2;
      pair_at(pp, k, j1, j2);
      const T yo = __ldg(p.worth + (size_t)b * q + pp) - __ldg(p.uorth + (size_t)b * q + pp) +
                   (j1 == j2 ? T(1) : T(0));
      t[pp] = rho * (pair_sum(j1, j2, 0) + yo);
    }
  }
  if (lane == 0) {
    const T y4 = __ldg(p.w4 + b) - __ldg(p.u4 + b) - T(k);
    const size_t q1 = (size_t)i * D1 + i, q2 = (size_t)i * D2 + i, q3 = (size_t)i * n + i;
    const T d1 = w1[q1] - u1[q1], d2 = w2[q2] - u2[q2];
    const T d3 = w3[q3] - u3[q3];
    p.Y[(size_t)b * n * n + (size_t)i * n + i] = quot(rho * ((d1 + d2 - (d3 - T(1))) - y4), T(3));
  }
  __syncwarp();
  const T* L = p.Mc + ((size_t)b * n + i) * kq * kq;
  omc::warp_cho_solve(L, kq, [kq](int r, int c) { return r * kq + c; },
                      [U, t, k](int c) -> T& { return c < k ? U[c] : t[c - k]; });
}

// K9a's wide grid: B ceil(n / kWarps9) row CTAs, then k9a_layout's flat
// CTAs (X chunks, Theta and Y tile pairs)
__host__ __device__ __forceinline__ int k9a_wide_grid_x(int B, int n, int m) {
  return B * omc::cdiv(n, kWarps9) + B * k9a_layout(B, n, m).units;
}

template <class T>
__global__ void __launch_bounds__(kThreads9) k9a_wide_kernel(K9aParamsT<T> p) {
  __shared__ T sA[kTile][kTile + 1], sB[kTile][kTile + 1];
  const int R = omc::cdiv(p.n, kWarps9);
  int x = blockIdx.x;
  if (x < p.B * R) {
    const int b = x / R;
    k9a_row_wide(p, b, (x - b * R) * kWarps9 + (int)(threadIdx.x >> 5));
    return;
  }
  x -= p.B * R;
  const K9aLayout l = k9a_layout(p.B, p.n, p.m);
  const int b = x / l.units;
  int u = x - b * l.units;
  if (u < l.x) {
    k9a_x<T, true>(p, b, u);
    return;
  }
  u -= l.x;
  if (u < l.th) {
    k9a_theta<T, long long>(p, b, u, sA, sB);
    return;
  }
  k9a_y<T, long long>(p, b, u - l.th, sA, sB, p.k);
}

// K9a's second launch, a CTA a slot: sum_i z0_i[k:] and tr(rho gY / 3) (a
// warp a sum, its lanes over the rows in order), the Gc solve by warp 0,
// then U, t = (z0 - S_i tcorr) / rho a thread an entry and Y's diagonal
template <class T>
__global__ void __launch_bounds__(kThreads9) k9a_fix_wide(K9aParamsT<T> p) {
  using omc::quot;
  extern __shared__ float smem[];
  T* const tot = reinterpret_cast<T*>(smem);  // q + 1: the sums, tcorr in place
  const int k = p.k, q = tri_of(k), kq = k + q, n = p.n, b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* const U = p.U + (size_t)b * n * k;
  T* const t = p.t + (size_t)b * n * q;
  T* const Y = p.Y + (size_t)b * n * n;
  const T* Si = p.Si + (size_t)b * n * kq * q;
  const T rho = __ldg(p.rho + b);
  for (int a = warp; a <= q; a += kWarps9) {
    T s = T(0);
    for (int i = lane; i < n; i += 32) s += a < q ? t[(size_t)i * q + a] : Y[(size_t)i * n + i];
    s = omc::warp_sum(s);
    if (lane == 0) tot[a] = s;
  }
  __syncthreads();
  if (warp == 0)
    omc::warp_cho_solve(p.Gc + (size_t)b * q * q, q, [q](int r, int c) { return r * q + c; },
                        [tot](int a) -> T& { return tot[a]; });
  __syncthreads();
  const T ctr = quot(tot[q], T(3) + T(n));
  for (int e = threadIdx.x; e < n * kq; e += kThreads9) {
    const int i = e / kq, c = e - i * kq;
    const T* S = Si + (size_t)e * q;
    T s = T(0);
    for (int a = 0; a < q; ++a) s += S[a] * tot[a];
    T& z = c < k ? U[(size_t)i * k + c] : t[(size_t)i * q + (c - k)];
    z = quot(z - s, rho);
  }
  for (int i = threadIdx.x; i < n; i += kThreads9) {
    const T a = quot(Y[(size_t)i * n + i] - ctr, rho);
    Y[(size_t)i * n + i] = T(0.5) * (a + a);
  }
}

// K9b's wide slot CTA of slot b: the SOC slots' t (kept in usoc until the
// norms), the box slot and the envelope rows with their running mean, an
// entry a thread; then tr Y, the k column norms and sum_i t[i, p] (a warp a
// sum, its lanes over the rows in order); then the trace, SOC and
// orthogonality slots (k9b_slot's arithmetic)
template <class T>
__device__ __forceinline__ void k9b_slot_wide(const K9bParamsT<T>& p, int b, T* smem) {
  const int k = p.k, q = tri_of(k), n = p.n, NS = 1 + k + q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T alpha = p.alpha, om = T(1) - p.alpha;
  const T rho = __ldg(p.rho + b);
  T* const tot = smem;       // NS: tr Y, |tsoc_j[1:]|^2, sum_i t
  T* const head = smem + NS;  // k: tsoc_j[0]
  const omc::ROT<T> Y{p.Y + (size_t)b * n * n}, U{p.U + (size_t)b * n * k};
  const omc::ROT<T> t{p.t + (size_t)b * n * q};
  const omc::ROT<T> lo{p.U_lo + (size_t)b * n * k}, hi{p.U_hi + (size_t)b * n * k};
  T* const wsoc = p.wsoc + (size_t)b * k * (1 + n);
  T* const usoc = p.usoc + (size_t)b * k * (1 + n);
  T* const wbox = p.wbox + (size_t)b * n * k;
  T* const ubox = p.ubox + (size_t)b * n * k;
  T* const wmc = p.wmc + (size_t)b * 4 * n * q;
  T* const umc = p.umc + (size_t)b * 4 * n * q;
  T* const acc = p.acc_mc ? p.acc_mc + (size_t)b * 4 * n * q : nullptr;
  for (int j = tid; j < k; j += kThreads9)
    head[j] = (alpha * T(1) + om * wsoc[j * (1 + n)]) + usoc[j * (1 + n)];
  for (int e = tid; e < k * n; e += kThreads9) {
    const int j = e / n, i = e - j * n, qs = j * (1 + n) + 1 + i;
    usoc[qs] = (alpha * U[i * k + j] + om * wsoc[qs]) + usoc[qs];
  }
  for (int e = tid; e < n * k; e += kThreads9) {
    const T v = (alpha * U[e] + om * wbox[e]) + ubox[e];
    const T w = fmin(fmax(v, lo[e]), hi[e]);
    wbox[e] = w;
    ubox[e] = v - w;
  }
  for (int e = tid; e < n * q; e += kThreads9) {
    const int i = e / q, pp = e - i * q;
    int j1, j2;
    pair_at(pp, k, j1, j2);
    const T l1 = lo[i * k + j1], l2 = lo[i * k + j2], h1 = hi[i * k + j1], h2 = hi[i * k + j2];
    const T ti = t[e], U1 = U[i * k + j1], U2 = U[i * k + j2];
    for (int rr = 0; rr < 4; ++rr) {
      T s, c1, c2, d;
      envelope(rr, l1, l2, h1, h2, s, c1, c2, d);
      const T f = ((s * ti + c1 * U1) + c2 * U2) + d;
      const size_t qi = ((size_t)rr * n + i) * q + pp;
      const T v = (alpha * f + om * wmc[qi]) + umc[qi];
      const T w = fmax(v, T(0)), u = v - w;
      wmc[qi] = w;
      umc[qi] = u;
      if (acc) acc[qi] = acc[qi] + p.beta * (rho * u - acc[qi]);
    }
  }
  __syncthreads();
  for (int a = warp; a < NS; a += kWarps9) {
    T s = T(0);
    for (int i = lane; i < n; i += 32) {
      if (a == 0) {
        s += Y[(size_t)i * n + i];
      } else if (a <= k) {
        const T v = usoc[(a - 1) * (1 + n) + 1 + i];
        s += v * v;
      } else {
        s += t[(size_t)i * q + (a - 1 - k)];
      }
    }
    s = omc::warp_sum(s);
    if (lane == 0) tot[a] = s;
  }
  __syncthreads();
  if (tid == 0) {  // trace slot
    const T t4 = (alpha * (T(k) - tot[0]) + om * p.w4[b]) + p.u4[b];
    const T w = fmax(t4, T(0));
    p.w4[b] = w;
    p.u4[b] = t4 - w;
  }
  for (int e = tid; e < k * (1 + n); e += kThreads9) {  // SOC slots (1, U_j)
    const int j = e / (1 + n), qq = e - j * (1 + n);
    const T tt = head[j], n2 = tot[1 + j];
    T nj, inv = T(0);
    if constexpr (sizeof(T) == 4) {
      nj = sqrtf(n2);
    } else {
      inv = n2 > T(0) ? rsq(n2) : T(0);
      nj = n2 * inv;
    }
    const T v = (qq == 0) ? tt : usoc[e];
    T w;
    if (nj <= tt) w = v;
    else if (nj <= -tt) w = T(0);
    else if (qq == 0) w = T(0.5) * (tt + nj);
    else if constexpr (sizeof(T) == 4) w = (nj > 0.f ? 0.5f * (1.0f + tt / nj) : 0.f) * v;
    else w = (T(0.5) * (T(1) + tt * inv)) * v;
    wsoc[e] = w;
    usoc[e] = v - w;
  }
  for (int pp = tid; pp < q; pp += kThreads9) {  // orthogonality rows (= 0)
    int j1, j2;
    pair_at(pp, k, j1, j2);
    const size_t qo = (size_t)b * q + pp;
    const T f = tot[1 + k + pp] - ((j1 == j2) ? T(1) : T(0));
    const T v = (alpha * f + om * p.worth[qo]) + p.uorth[qo];
    p.worth[qo] = T(0);
    p.uorth[qo] = v;
    if (p.acc_orth) p.acc_orth[qo] = p.acc_orth[qo] + p.beta * (rho * v - p.acc_orth[qo]);
  }
}

// (k9b_layout at the runtime k; omc_torch.sdp.mccormick.k9_plan)
template <class T, class I>
__device__ __forceinline__ void k9b_wide_body(const K9bParamsT<T>& p) {
  extern __shared__ float smem[];
  const K9bLayout l = k9b_layout<I>(p.B, p.n, p.m, p.k, p.qpc, 16 / sizeof(T));
  int x = blockIdx.x;
  if (x < p.B) {
    k9b_slot_wide(p, x, reinterpret_cast<T*>(smem));
    return;
  }
  x -= p.B;
  if (x < l.t1) {
    k9b_t<T, true, I>(p, 0, (I)x * p.qpc, p.k);
    return;
  }
  x -= l.t1;
  if (x < l.t2) {
    k9b_t<T, true, I>(p, 1, (I)x * p.qpc, p.k);
    return;
  }
  k9b_t<T, true, I>(p, 2, (I)(x - l.t2) * p.qpc, p.k);
}

template <class T>
__global__ void __launch_bounds__(kThreads9) k9b_wide_kernel(K9bParamsT<T> p) {
  k9b_wide_body<T, int>(p);
}

// past 2^31 flat entries (k9b_flat64)
template <class T>
__global__ void __launch_bounds__(kThreads9) k9b_wide_kernel64(K9bParamsT<T> p) {
  k9b_wide_body<T, long long>(p);
}

template <typename Kernel, typename Params>
int launch_k(Kernel kern, const Params& p, int grid, int threads, size_t smem, void* stream) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
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
// reciprocal (omc::divmod), exact below 2^24 entries a block, and a word of
// t3 spans at most two slots (n >= 2)
bool k9_shape_ok(int B, int n, int m, int k) {
  return B >= 1 && n >= 2 && m >= 1 && k >= 1 && k <= 3 && n + m <= 4096;
}

template <class T>
int k9s_launch(const K9sParamsT<T>& p, void* stream) {
  if (p.B < 1 || p.n < 1) return (int)cudaErrorInvalidValue;
  const int threads = k9s_threads(p.n, p.k, sizeof(T));
  const size_t smem = sizeof(T) * (size_t)k9s_smem_values(threads, p.k, sizeof(T));
  switch (p.k) {
    case 1: return launch_k(k9s_kernel<1, T>, p, p.B, threads, smem, stream);
    case 2: return launch_k(k9s_kernel<2, T>, p, p.B, threads, smem, stream);
    case 3: return launch_k(k9s_kernel<3, T>, p, p.B, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int k9a_launch(const K9aParamsT<T>& p, void* stream) {
  if (!k9_shape_ok(p.B, p.n, p.m, p.k)) return (int)cudaErrorInvalidValue;
  // the slot CTA's z0 and Y diagonal
  const size_t smem = (size_t)p.n * (p.k + q_of(p.k) + 1) * sizeof(T);
  const int grid = k9a_layout(p.B, p.n, p.m).grid_x;
  switch (p.k) {
    case 1: return launch_k(k9a_kernel<1, T>, p, grid, kThreads9, smem, stream);
    case 2: return launch_k(k9a_kernel<2, T>, p, grid, kThreads9, smem, stream);
    default: return launch_k(k9a_kernel<3, T>, p, grid, kThreads9, smem, stream);
  }
}

template <class T>
int k9b_launch(const K9bParamsT<T>& p, void* stream) {
  // w1-w3, u1-u3 and t1-t3 move as 16-byte words
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (!k9_shape_ok(p.B, p.n, p.m, p.k) || p.qpc < 32 || p.qpc > kThreads9 || p.qpc % 32 ||
      odd(p.w1) || odd(p.u1) || odd(p.w2) || odd(p.u2) || odd(p.w3) || odd(p.u3) ||
      odd(p.t1) || odd(p.t2) || odd(p.t3))
    return (int)cudaErrorInvalidValue;
  // the slot CTA's SOC slots
  const size_t smem = (size_t)p.k * (1 + p.n) * sizeof(T);
  constexpr int E = 16 / sizeof(T);
  if (k9b_flat64(p.B, p.n, p.m, p.k, E)) {
    const int grid = k9b_layout<long long>(p.B, p.n, p.m, p.k, p.qpc, E).grid_x;
    switch (p.k) {
      case 1: return launch_k(k9b_kernel64<1, T>, p, grid, kThreads9, smem, stream);
      case 2: return launch_k(k9b_kernel64<2, T>, p, grid, kThreads9, smem, stream);
      default: return launch_k(k9b_kernel64<3, T>, p, grid, kThreads9, smem, stream);
    }
  }
  const int grid = k9b_layout(p.B, p.n, p.m, p.k, p.qpc, E).grid_x;
  switch (p.k) {
    case 1: return launch_k(k9b_kernel<1, T>, p, grid, kThreads9, smem, stream);
    case 2: return launch_k(k9b_kernel<2, T>, p, grid, kThreads9, smem, stream);
    default: return launch_k(k9b_kernel<3, T>, p, grid, kThreads9, smem, stream);
  }
}

// the shapes the wide kernels take: any k >= 1, any batch and width (the
// flat entries and a slot's index in 64 bits past 2^31); a word of t3 spans
// at most two slots (n >= 2)
bool k9_wide_shape_ok(int B, int n, int m, int k) {
  return B >= 1 && n >= 2 && m >= 1 && k >= 1;
}

// the wide K9a's second launch: the slot's q + 1 sums in shared memory
__host__ __device__ __forceinline__ long long k9a_fix_smem(int k, int elem) {
  return (long long)elem * (tri_of(k) + 1);
}

// the wide K9b's slot CTA: tr Y, the k norms and q row sums, then the k SOC heads
__host__ __device__ __forceinline__ long long k9b_wide_smem(int k, int elem) {
  return (long long)elem * (1 + 2 * k + tri_of(k));
}

template <class T>
int k9s_wide_launch(const K9sParamsT<T>& p, void* stream) {
  if (p.B < 1 || p.n < 1 || p.k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  k9s_rows_wide<T><<<p.B * omc::cdiv(p.n, kWarps9), kThreads9, 0, st>>>(p);
  k9s_g_wide<T><<<p.B, kThreads9, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int k9a_wide_launch(const K9aParamsT<T>& p, void* stream) {
  if (!k9_wide_shape_ok(p.B, p.n, p.m, p.k)) return (int)cudaErrorInvalidValue;
  const int err = launch_k(k9a_wide_kernel<T>, p, k9a_wide_grid_x(p.B, p.n, p.m), kThreads9, 0,
                           stream);
  if (err) return err;
  return launch_k(k9a_fix_wide<T>, p, p.B, kThreads9, (size_t)k9a_fix_smem(p.k, sizeof(T)),
                  stream);
}

template <class T>
int k9b_wide_launch(const K9bParamsT<T>& p, void* stream) {
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (!k9_wide_shape_ok(p.B, p.n, p.m, p.k) || p.qpc < 32 || p.qpc > kThreads9 || p.qpc % 32 ||
      odd(p.w1) || odd(p.u1) || odd(p.w2) || odd(p.u2) || odd(p.w3) || odd(p.u3) ||
      odd(p.t1) || odd(p.t2) || odd(p.t3))
    return (int)cudaErrorInvalidValue;
  constexpr int E = 16 / sizeof(T);
  const size_t smem = (size_t)k9b_wide_smem(p.k, sizeof(T));
  if (k9b_flat64(p.B, p.n, p.m, p.k, E))
    return launch_k(k9b_wide_kernel64<T>, p,
                    k9b_layout<long long>(p.B, p.n, p.m, p.k, p.qpc, E).grid_x, kThreads9, smem,
                    stream);
  return launch_k(k9b_wide_kernel<T>, p, k9b_layout(p.B, p.n, p.m, p.k, p.qpc, E).grid_x,
                  kThreads9, smem, stream);
}

}  // namespace

// K9s's CTA at elem bytes a value (4, or 8 in the float64 build;
// omc_torch.sdp.mccormick.k9s_plan plans with them; chip_smoke.py holds the
// plan against them)
OMC_EXPORT int omc_k9s_threads(int n, int k, int elem) { return k9s_threads(n, k, elem); }

OMC_EXPORT int omc_k9s_smem_bytes(int n, int k, int elem) {
  return elem * k9s_smem_values(k9s_threads(n, k, elem), k, elem);
}

OMC_EXPORT int omc_k9s_setup(const K9sParams* params, void* stream) {
  return k9s_launch(*params, stream);
}

OMC_EXPORT int omc_k9s_setup_f64(const K9sParamsT<double>* params, void* stream) {
  return k9s_launch(*params, stream);
}

// K9a's and K9b's grid widths, K9b's at elem bytes a value
// (omc_torch.sdp.mccormick.k9_plan plans with them; chip_smoke.py holds the
// plan against them)
OMC_EXPORT int omc_k9a_grid_x(int B, int n, int m) { return k9a_layout(B, n, m).grid_x; }

OMC_EXPORT int omc_k9b_grid_x(int B, int n, int m, int k, int qpc, int elem) {
  return k9b_layout<long long>(B, n, m, k, qpc, 16 / elem).grid_x;
}

OMC_EXPORT int omc_k9a_zstep(const K9aParams* params, void* stream) {
  return k9a_launch(*params, stream);
}

OMC_EXPORT int omc_k9a_zstep_f64(const K9aParamsT<double>* params, void* stream) {
  return k9a_launch(*params, stream);
}

OMC_EXPORT int omc_k9b_cone(const K9bParams* params, void* stream) {
  return k9b_launch(*params, stream);
}

OMC_EXPORT int omc_k9b_cone_f64(const K9bParamsT<double>* params, void* stream) {
  return k9b_launch(*params, stream);
}

// the wide kernels (any k; n + m > 4096): K9s's two launches (rows, then G),
// K9a's two (rows and flat CTAs, then the per-slot sums and corrections),
// K9b's one; their grids and shared memory, held against k9s_plan /
// k9_plan by the smoke
OMC_EXPORT int omc_k9a_wide_grid_x(int B, int n, int m) { return k9a_wide_grid_x(B, n, m); }

OMC_EXPORT long long omc_k9a_fix_smem_bytes(int k, int elem) { return k9a_fix_smem(k, elem); }

OMC_EXPORT long long omc_k9b_wide_smem_bytes(int k, int elem) { return k9b_wide_smem(k, elem); }

OMC_EXPORT int omc_k9s_setup_wide(const K9sParams* params, void* stream) {
  return k9s_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k9s_setup_wide_f64(const K9sParamsT<double>* params, void* stream) {
  return k9s_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k9a_zstep_wide(const K9aParams* params, void* stream) {
  return k9a_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k9a_zstep_wide_f64(const K9aParamsT<double>* params, void* stream) {
  return k9a_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k9b_cone_wide(const K9bParams* params, void* stream) {
  return k9b_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k9b_cone_wide_f64(const K9bParamsT<double>* params, void* stream) {
  return k9b_wide_launch(*params, stream);
}
