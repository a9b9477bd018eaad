// K2 — fused adjoint + rho-free Woodbury z-step of the ADMM iteration.
//
// Replaces, per node slot, omc/sdp/admm.py: _adjoint (:169-188), the
// solve_z closure (:324-340) with _Vt_apply / _V_apply (:234-263) and the
// symmetrisation (:375-376):
//   r = w - u - offs  (nine slots; cut slots masked)
//   (gX, gY, gTh, gU) = K' r
//   z = D^-1 (rho K' r - c)  per block,   s = V' z,
//   t = rho G1^-1 s,   z -= D^-1 V t,   Y = sym(zY), Ths = sym(zTh).
// In the Shor loop (Xs and Ths null) it writes Y and U only: the Shor
// relaxation shares their z-step, and K8a writes X and Theta.
//
// What bounds it on the H100: memory traffic — each slot reads its
// (n+m)^2 + (n+k)^2 + n^2 residual blocks once and writes n m + n^2 + m^2
// + n k outputs; the arithmetic is O(L n^2) for the cut contractions plus
// O(p^2), p = 1 + L + L k, for t.
//
// Design: one thread-block cluster of C CTAs per node slot (C from
// omc_torch.sdp.admm.k2k3_plan, up to 16, so that small batches still spread
// over many SMs).  CTA r owns a band of rows of Y and U; X's entries and
// Theta's 16 x 16 tile pairs are spread over the whole cluster.  Every large
// loop runs over flat (row, column) items, consecutive threads on
// consecutive columns, each thread loading a few items before it stores
// any, so its loads are in flight together.
// * Phase 1: two global round trips.  The CTA forms its band of Y's
//   residual r + r' in shared memory: the (i, j) half row by row, then the
//   (j, i) half from the inputs' column band (a contiguous run of each row),
//   so every global read is coalesced and nothing of Y is written yet.
//   G1^-1 and the cut-slot duals are staged beside it.  Operands the kernel
//   does not write are read through the non-coherent path, so loads may run
//   ahead of stores.
// * Each thread then forms its entries of the band's sym(zY) and sums its
//   partials of s = V'z — the trace, the chord sums x_l' zY x_l in float64 —
//   and the CTA its x_l' zU_j.  The CTA arrives at a cluster barrier and,
//   before it waits, writes its share of X and of Theta, which need no
//   Woodbury correction: a warp loads a tile pair (I, J), (J, I) of Theta,
//   coalesced, transposes it through its own shared memory and writes
//   (z + z') / 2 to both.  The partials are added across the cluster in rank
//   order through distributed shared memory: no atomics, so two launches
//   give the same bits.
// * Phase 2.  Every CTA forms t = rho G1^-1 s as one p x p product with the
//   inverse that make_consts forms once per solve call (G1 = I + V'D^-1 V
//   >= I, so ||G1^-1|| <= 1) — no dependent substitution steps — then writes
//   its rows of Y and U once, corrected.
// Y and Theta are exactly symmetric: both halves of an entry are formed
// from the same commutative sums and products.  Where a band of sym(zY)
// outgrows shared memory (n beyond ~900), it lives in the CTA's own rows of
// Y instead (band = 0), at the cost of passes through L2.  Where even one
// CTA's partials of s and its p- and L k-sized vectors outgrow it (a deep
// tree's 2048 cuts at rank 5 and beyond), they live in a global workspace
// (ws): each rank's partials are fenced before the cluster barrier and read
// through L2, and t's rows are spread over the cluster, a warp a row of
// G1^-1 (coalesced), and gathered through the workspace behind one more
// cluster barrier.
//
// The float64 build (omc_k2_zstep_f64) is the same kernel on doubles (T):
// its float section of shared memory (and of the workspace) is counted in
// doubles, so the plan's bytes come from k2_smem at 8 bytes a value, and it
// runs one CTA an SM where the float build runs three (the registers of
// the double values).
#include <cooperative_groups.h>

#include "common.cuh"

#include <climits>

namespace cg = cooperative_groups;

namespace {

// sqrt(2) rounded to T
template <class T>
__host__ __device__ constexpr T sqrt2_of() { return T(1.41421356237309515); }
constexpr int kWarps = omc::kThreads / 32;
constexpr int kChunk = 8;    // chord sums a lane keeps in registers at once
constexpr int kT = 16;       // Theta's tile edge
constexpr int kGiMax = 112;  // G1^-1 is staged in shared memory up to p = kGiMax
constexpr int kU = 4;        // items a thread loads before it stores any

// Shared memory of one CTA: doubles first (per-warp partials, the CTA's
// partials of s, their cluster sums), then values of T (floats, or doubles
// in the float64 build: elem bytes each).  Offsets in elements of their
// type from the start; omc_torch.sdp.admm.k2_smem_bytes mirrors it.  With
// ws, part and tot (doubles) and cl, coef, sv and tv (values of T) are
// counted from the start of the rank's region of wsr doubles in the slot's
// wss doubles of workspace instead; t's gathered rows (T) start at wst.
struct K2Smem {
  int wpart, part, stage, tot;                     // doubles
  int xs, cms, cl, yc, coef, sv, tv, ub, gi, tt, buf;  // floats
  size_t bytes;
  int wsr, wst, wss;
};

__host__ __device__ inline K2Smem k2_smem(int n, int m, int k, int L, int C, int band,
                                          int xsmem, int ws, int elem = 4, int usmem = 1) {
  K2Smem s;
  const int P = 1 + L + L * k, bw = omc::cdiv(n, C);
  int d = 0, g = 0;  // doubles: shared memory, the rank's workspace region
  s.wpart = d, d += kWarps * (1 + kChunk);  // a warp's trace and chunk of chords
  if (ws) {
    s.part = g, g += P;
    s.stage = -1;
    s.tot = g, g += P;
  } else {
    s.part = d, d += P;
    // the cluster's partials, gathered, and their sums (one CTA: its own)
    s.stage = C > 1 ? d : s.part, d += C > 1 ? C * P : 0;
    s.tot = C > 1 ? d : s.part, d += C > 1 ? P : 0;
  }
  const int per = 8 / elem;         // values of T a double
  int f = per * d, h = per * g;     // values of T
  int& v = ws ? h : f;       // where the p- and L k-sized vectors go
  s.xs = f, f += xsmem ? L * n : 0;  // masked cut vectors
  s.cms = f, f += L;          // the cut mask
  s.cl = v, v += L * k;       // (lo + hi) cm
  s.yc = f, f += L;           // chord-slot duals
  s.coef = v, v += L * k;     // interval-slot dual combination
  s.sv = v, v += P;           // s = V'z
  s.tv = v, v += P;           // t = rho G1^-1 s
  s.ub = f, f += usmem ? bw * k : 0;  // the band's zU (else in U's rows)
  s.gi = f, f += P <= kGiMax ? P * P : 0;        // G1^-1
  s.tt = f, f += kWarps * 2 * kT * (kT + 1);     // a Theta tile pair a warp
  s.buf = f, f += band ? bw * omc::odd_ld(n) : 0;  // the band of sym(zY)
  s.bytes = (size_t)f * elem;
  s.wsr = ws ? (h + per - 1) / per : 0;
  s.wst = C * s.wsr;
  s.wss = ws ? s.wst + (P + per - 1) / per : 0;
  return s;
}

// The masked cut vectors x_l[j]: staged in shared memory (s), or, where
// they do not fit, read from the input g and masked by cm[l]
template <class T>
struct CutX {
  const T* s;
  omc::ROT<T> g;
  const T* cm;
  int n;
  __device__ __forceinline__ T operator()(int l, int j) const {
    return s ? s[l * n + j] : g[l * n + j] * cm[l];
  }
};

// One warp's share of the 16 x 16 tile pairs (I, J), (J, I), J <= I, of an
// N x N matrix: pairs cw, cw + CW, ...  f(a, c) is entry (a, c)'s value; for
// every entry out(a, c, v(a, c) + v(c, a)) takes the symmetric sum, the two
// tiles' entries loaded (coalesced, 16 columns a row) before either is
// stored, and transposed through the warp's 2 x 16 x 17 floats at t.
template <class T, class F, class O>
__device__ __forceinline__ void tile_pairs(int N, int cw, int CW, T* t, F f, O out) {
  constexpr int R = kT / 2, ld = kT + 1;
  const int lane = threadIdx.x & 31, nt = omc::cdiv(N, kT), cc = lane & (kT - 1), r0 = lane >> 4;
  T* ta = t;
  T* tb = t + kT * ld;
  for (int pr = cw; pr < nt * (nt + 1) / 2; pr += CW) {
    int I = 0;
    while ((I + 1) * (I + 2) / 2 <= pr) ++I;
    const int J = pr - I * (I + 1) / 2;
    T va[R], vb[R];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int rr = r0 + 2 * h;
      if (I * kT + rr < N && J * kT + cc < N) va[h] = f(I * kT + rr, J * kT + cc);
      if (I != J && J * kT + rr < N && I * kT + cc < N) vb[h] = f(J * kT + rr, I * kT + cc);
    }
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int rr = r0 + 2 * h;
      if (I * kT + rr < N && J * kT + cc < N) ta[rr * ld + cc] = va[h];
      if (I != J && J * kT + rr < N && I * kT + cc < N) tb[rr * ld + cc] = vb[h];
    }
    __syncwarp();
    const T* tt = I != J ? tb : ta;  // v at (J-block rows, I-block columns)
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int rr = r0 + 2 * h;
      if (I * kT + rr < N && J * kT + cc < N)
        out(I * kT + rr, J * kT + cc, ta[rr * ld + cc] + tt[cc * ld + rr]);
      if (I != J && J * kT + rr < N && I * kT + cc < N)
        out(J * kT + rr, I * kT + cc, tb[rr * ld + cc] + ta[cc * ld + rr]);
    }
    __syncwarp();
  }
}

// K2's body.  I: the type of a slot's own offsets (the products i D1,
// (n + a) D1, i D2, i n): int where (n + m)^2 fits in int, size_t past n +
// m = 46,340 (k2_kernel64).  kUg: the band's zU kept in the output U's own
// rows, where its ceil(n / C) k values do not fit shared memory (with the
// band of sym(zY) in Y's rows; K2Params.usmem = 0): the same values in the
// same order, so the same bits
template <class T, bool kBand, bool kWs, class I, bool kUg>
__device__ __forceinline__ void k2_body(const K2ParamsT<T>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const dsm = reinterpret_cast<double*>(smem_raw);
  T* const fsm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m, k = p.k, L = p.L;
  const int D1 = n + m, D2 = n + k, P = 1 + L + L * k;
  const K2Smem S = k2_smem(n, m, k, L, C, kBand, p.xsmem, kWs, sizeof(T), !kUg);
  // the slot's workspace, and where part, tot, cl, coef, sv and tv live
  double* const wsd = kWs ? p.ws + (size_t)b * S.wss : nullptr;
  double* const rd = kWs ? wsd + (size_t)rank * S.wsr : dsm;
  T* const rf = reinterpret_cast<T*>(rd);
  double* wpart = dsm + S.wpart;
  double* part = rd + S.part;
  double* tot = rd + S.tot;
  const T y4 = p.w4[b] - p.u4[b] - (T)k;
  T* xs = fsm + S.xs;
  T* cms = fsm + S.cms;
  T* cl = rf + S.cl;
  T* yc = fsm + S.yc;
  T* coef = rf + S.coef;
  T* sv = rf + S.sv;
  T* tv = rf + S.tv;
  // this CTA's rows [i0, i0 + nb) of Y and U
  const int i0 = omc::band_lo(n, C, rank), nb = omc::band_lo(n, C, rank + 1) - i0;
  T* Ub = kUg ? p.U + (size_t)b * n * k + (size_t)i0 * k : fsm + S.ub;

  const T rho = p.rho[b], sX = p.sX[b], sT = p.sT[b];
  // every operand K2 reads it does not write
  const omc::ROT<T> w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::ROT<T> w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const omc::ROT<T> w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  const omc::ROT<T> cx{p.cut_x + (size_t)b * L * n}, clo{p.cut_lo + (size_t)b * L * k};
  const omc::ROT<T> chi{p.cut_hi + (size_t)b * L * k}, cm{p.cut_mask + (size_t)b * L};
  const omc::ROT<T> maskA{p.maskA}, mask{p.mask};
  const T* G1i = p.G1i + (size_t)b * P * P;
  const T* Gi = P <= kGiMax ? fsm + S.gi : G1i;
  T* Y = p.Y + (size_t)b * n * n;
  T* U = p.U + (size_t)b * n * k;
  T* Yb = kBand ? fsm + S.buf : Y + (size_t)i0 * n;
  const int ldY = kBand ? omc::odd_ld(n) : n;

  // ======== phase 1: the loads the sums of s need
  // the cuts: masked vectors; per interval slot (l, j) the chord-slot dual
  // yc_l = (wc - uc - bconst_l) cm_l and coef_lj = ya - yb + yc_l (lo + hi),
  // ya = (wa - ua + lo) cm, yb = (wb - ub - hi) cm
  for (int l = tid; l < L; l += blockDim.x) cms[l] = cm[l];
  if (p.xsmem)
    for (int l = warp; l < L; l += kWarps) {
      const T c = cm[l];
      for (int j = lane; j < n; j += 32) xs[l * n + j] = cx[l * n + j] * c;
    }
  const CutX<T> X{p.xsmem ? xs : nullptr, cx, cms, n};
  for (int e = tid; e < L * k; e += blockDim.x) {
    const int l = e / k;
    T bc = T(0);
    for (int j = 0; j < k; ++j) bc += -clo[l * k + j] * chi[l * k + j];
    const T ycl = (__ldg(p.wc + b * L + l) - __ldg(p.uc + b * L + l) - bc) * cm[l];
    if (e == l * k) yc[l] = ycl;
    const size_t q = (size_t)b * L * k + e;
    const T lo = clo[e], hi = chi[e];
    const T ya = (__ldg(p.wa + q) - __ldg(p.ua + q) - (-lo)) * cm[l];
    const T yb = (__ldg(p.wb + q) - __ldg(p.ub + q) - hi) * cm[l];
    coef[e] = ya - yb + ycl * (lo + hi);
    cl[e] = (lo + hi) * cm[l];
  }
  if (P <= kGiMax)
    for (int q = tid; q < P * P; q += blockDim.x) fsm[S.gi + q] = __ldg(G1i + q);
  // the band's residual part of gU = 2 (w2 - u2) + (wsoc - usoc) + (wbox - ubox)
  for (int e = tid; e < nb * k; e += blockDim.x) {
    const int ii = e / k, j = e - ii * k, i = i0 + ii;
    const I q2 = (I)i * D2 + n + j;
    const int qs = j * (1 + n) + 1 + i;
    const size_t ws = (size_t)b * k * (1 + n) + qs, wb = (size_t)b * n * k + i * k + j;
    Ub[e] = T(2) * (w2[q2] - u2[q2]) + (__ldg(p.wsoc + ws) - __ldg(p.usoc + ws)) +
            (__ldg(p.wbox + wb) - __ldg(p.ubox + wb));
  }
  // the band's residual r = (w1 - u1) + (w2 - u2) - (w3 - u3): r(i, j) row
  // by row, then (second round trip) r(j, i) from the inputs' column band,
  // read as runs of nb, added (r + r', the same bits at (j, i) in its band)
  const auto resid = [&](int i, int j) {
    const I q1 = (I)i * D1 + j, q2 = (I)i * D2 + j, q3 = (I)i * n + j;
    return (w1[q1] - u1[q1]) + (w2[q2] - u2[q2]) - (w3[q3] - u3[q3]);
  };
  omc::grid_items<kU>(
      nb, n, tid, blockDim.x, [&](int ii, int j) { return resid(i0 + ii, j); },
      [&](int ii, int j, T v) { Yb[ii * ldY + j] = v; });
  __syncthreads();
  omc::grid_items<kU>(
      n, nb, tid, blockDim.x, [&](int j, int ii) { return resid(j, i0 + ii); },
      [&](int j, int ii, T v) { Yb[ii * ldY + j] += v; });
  __syncthreads();

  // zY = rho gY / (3 rho), gY = r - y4 I + I - sum_l yc_l x_l x_l' (the
  // product x_l[i] x_l[j] first, so the (i, j) and (j, i) entries are the
  // same bits), the band's entries spread over the CTA's threads; each
  // thread sums zY(i, j) x_l[i] x_l[j] over its entries in float64, then one
  // warp sum per chunk of cuts
  double tr = 0.0;
  const float inv_n = 1.0f / (float)n;
  for (int l0 = 0; l0 == 0 || l0 < L; l0 += kChunk) {
    double acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = 0.0;
    for (int e = tid; e < nb * n; e += blockDim.x) {
      int ii, j;
      omc::divmod(e, n, inv_n, ii, j);
      const int i = i0 + ii;
      T z;
      if (l0 == 0) {
        T cc = T(0);
        for (int l = 0; l < L; ++l) cc += yc[l] * (X(l, i) * X(l, j));
        T g = T(0.5) * Yb[ii * ldY + j] - cc;
        if (j == i) g += T(1) - y4;
        z = (rho * g) / (T(3) * rho);
        Yb[ii * ldY + j] = z;
        if (j == i) tr += z;
      } else {
        z = Yb[ii * ldY + j];
      }
      const double zd = z;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (l0 + c < L)
          acc[c] = fma(zd * (double)X(l0 + c, i), (double)X(l0 + c, j), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (l0 + c >= L) break;
      const double s = omc::warp_sum_d(acc[c]);
      if (lane == 0) wpart[warp * (1 + kChunk) + 1 + c] = s;
    }
    __syncthreads();  // this chunk's chord partials, in warp order
    for (int c = tid; c < kChunk && l0 + c < L; c += blockDim.x) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += wpart[w * (1 + kChunk) + 1 + c];
      part[1 + l0 + c] = s;
    }
    __syncthreads();
  }
  tr = omc::warp_sum_d(tr);
  if (lane == 0) wpart[warp * (1 + kChunk)] = tr;
  // the band's zU = rho gU / (4 rho), gU = r + sum_l x_l coef_l
  for (int e = tid; e < nb * k; e += blockDim.x) {
    const int ii = e / k, j = e - ii * k, i = i0 + ii;
    double ct = 0.0;  // U's few entries sum over every cut: float64
    for (int l = 0; l < L; ++l) ct = fma((double)X(l, i), (double)coef[l * k + j], ct);
    Ub[e] = (rho * (Ub[e] + (T)ct)) / (T(4) * rho);
  }
  __syncthreads();

  // ---- this CTA's partials of s: trace and chords in warp order, x_l' zU_j
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wpart[w * (1 + kChunk)];
    part[0] = s;
  }
  for (int e = tid; e < L * k; e += blockDim.x) {
    const int l = e / k, j = e - l * k;
    double v = 0.0;
    for (int ii = 0; ii < nb; ++ii) v = fma((double)X(l, i0 + ii), (double)Ub[ii * k + j], v);
    part[1 + L + e] = v;
  }
  if (kWs) __threadfence();  // the partials reach L2 before the barrier
  omc::cluster_arrive();
  // ---- while the other CTAs reach the barrier: X over the cluster's
  // threads, zX = (rho gX + sX mask A) / (mask sX^2 + 2 rho sX^2)
  // (X from rank 0 up, Theta's pairs from the last rank down: at small
  // batches no CTA holds both)
  const int cw = (C - 1 - rank) * kWarps + warp, CW = C * kWarps;
  if (p.Xs) {
    T* Xs = p.Xs + (size_t)b * n * m;
    omc::grid_items<kU>(
        n, m, rank * blockDim.x + tid, C * blockDim.x,
        [&](int i, int j) {
          const I q = (I)i * D1 + n + j;
          const int e = i * m + j;
          const T gX = sX * T(2) * (w1[q] - u1[q]);
          const T rX = rho * gX + sX * maskA[e];
          const T dX = mask[e] * (sX * sX) + rho * T(2) * sX * sX;
          return rX / dX;
        },
        [&](int i, int j, T v) { Xs[i * m + j] = v; });
  }
  // Theta (no Woodbury correction) over the cluster's warps, a tile pair at
  // a time: Ths = (z + z') / 2
  T* ta = fsm + S.tt + warp * 2 * kT * (kT + 1);
  if (p.Ths) {
    T* Ths = p.Ths + (size_t)b * m * m;
    const T cth = sT * T(0.5) / p.gamma, den = rho * sT * sT;
    tile_pairs(
        m, cw, CW, ta,
        [&](int a, int j) {
          const I q = (I)(n + a) * D1 + n + j;
          return (rho * (sT * (w1[q] - u1[q])) - (a == j ? cth : T(0))) / den;
        },
        [&](int a, int j, T s) { Ths[(size_t)a * m + j] = T(0.5) * s; });
  }
  omc::cluster_wait();
  // the partials' sums over the cluster, in rank order
  if (kWs) {
    omc::cluster_sum_global(wsd + S.part, S.wsr, tot, P, C);
  } else {
    omc::cluster_sum(cluster, part, dsm + S.stage, tot, P, C);
    omc::cluster_arrive();  // this CTA reads no other CTA's memory from here
  }
  // s = V'z: [trace | -x_l'zY x_l + sum_j c_lj x_l'zU_j | sqrt2 x_l'zU_j]
  for (int q = tid; q < P; q += blockDim.x) {
    T s;
    if (q == 0) {
      s = (T)tot[0];
    } else if (q <= L) {
      double ch = -tot[q];
      for (int j = 0; j < k; ++j) ch += (double)cl[(q - 1) * k + j] * tot[1 + L + (q - 1) * k + j];
      s = (T)ch;
    } else {
      s = sqrt2_of<T>() * (T)tot[q];
    }
    sv[q] = s;
  }
  __syncthreads();

  // ======== phase 2: t = rho G1^-1 s
  if (kWs) {
    // the rows of t spread over the cluster, a warp a row of G1^-1 read
    // coalesced, four independent sums a lane, then gathered from the
    // workspace behind a cluster barrier (L2 reads)
    T* tg = reinterpret_cast<T*>(wsd + S.wst);
    const int q1 = omc::band_lo(P, C, rank + 1);
    for (int q = omc::band_lo(P, C, rank) + warp; q < q1; q += kWarps) {
      const T* g = p.G1i + (size_t)b * P * P + (size_t)q * P;
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      int r = lane;
      for (; r + 96 < P; r += 128)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          s[h] = fma((double)__ldg(g + r + 32 * h), (double)sv[r + 32 * h], s[h]);
      for (; r < P; r += 32) s[0] = fma((double)__ldg(g + r), (double)sv[r], s[0]);
      const double t = omc::warp_sum_d((s[0] + s[1]) + (s[2] + s[3]));
      if (lane == 0) tg[q] = rho * (T)t;
    }
    __threadfence();
    omc::cluster_arrive();
    omc::cluster_wait();
    for (int q = tid; q < P; q += blockDim.x) tv[q] = __ldcg(tg + q);
    __syncthreads();
    omc::cluster_arrive();  // pairs with the wait at the end
  } else {
    // a thread per entry (p is odd: the rows' reads fall in distinct banks),
    // four independent sums a thread
    for (int q = tid; q < P; q += blockDim.x) {
      const T* g = Gi + q * P;
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      int r = 0;
      for (; r + 4 <= P; r += 4)
#pragma unroll
        for (int h = 0; h < 4; ++h) s[h] = fma((double)g[r + h], (double)sv[r + h], s[h]);
      for (; r < P; ++r) s[0] = fma((double)g[r], (double)sv[r], s[0]);
      tv[q] = rho * (T)((s[0] + s[1]) + (s[2] + s[3]));
    }
    __syncthreads();
  }

  // z -= D^-1 V t: Y (3 rho) and U (4 rho), each entry written once
  const T t0 = tv[0];
  for (int e = tid; e < nb * n; e += blockDim.x) {
    int ii, j;
    omc::divmod(e, n, inv_n, ii, j);
    const int i = i0 + ii;
    T vy = T(0);
    for (int l = 0; l < L; ++l) vy += tv[1 + l] * (X(l, i) * X(l, j));
    vy = (i == j ? t0 : T(0)) - vy;
    Y[(size_t)i * n + j] = Yb[ii * ldY + j] - vy / (T(3) * rho);
  }
  for (int e = tid; e < nb * k; e += blockDim.x) {
    const int ii = e / k, j = e - ii * k, i = i0 + ii;
    double a = 0.0, d = 0.0;
    for (int l = 0; l < L; ++l) {
      const double xli = X(l, i);
      a = fma((double)tv[1 + l] * xli, (double)cl[l * k + j], a);
      d = fma(xli, (double)tv[1 + L + l * k + j], d);
    }
    const T vu = (T)a + sqrt2_of<T>() * (T)d;
    U[i * k + j] = Ub[e] - vu / (T(4) * rho);
  }
  omc::cluster_wait();  // no CTA leaves while another may read its partials
}

// three CTAs an SM (80 registers, no spill): at 250 x 250 nodes the bands
// need the occupancy more than the registers.  kWs: the partials in the
// global workspace (two CTAs an SM: its t rows need the registers).  The
// float64 build: one CTA an SM.
template <class T, bool kBand, bool kWs, bool kUg>
__global__ void __launch_bounds__(omc::kThreads, sizeof(T) == 8 ? 1 : (kWs ? 2 : 3))
    k2_kernel(K2ParamsT<T> p) {
  k2_body<T, kBand, kWs, int, kUg>(p);
}

// past n + m = 46,340: a slot's offsets in 64 bits, two CTAs an SM in float
// (the float build's 64-bit offsets spill within 80 registers)
template <class T, bool kBand, bool kWs, bool kUg>
__global__ void __launch_bounds__(omc::kThreads, sizeof(T) == 8 ? 1 : 2)
    k2_kernel64(K2ParamsT<T> p) {
  k2_body<T, kBand, kWs, size_t, kUg>(p);
}

// a failed runtime call also sets the thread's last error: clear it, so a
// later launch's cudaGetLastError() does not report it again
int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <class T, bool kBand, bool kWs, bool kUg>
int launch(const K2ParamsT<T>& p, cudaStream_t stream) {
  // per kernel (int offsets, then 64-bit ones): its max dynamic shared
  // memory, and the largest smem a cluster of C was shown to fit
  static int smem_attr[2] = {-1, -1};
  static int schedulable[2][17] = {};
  const long long D = p.n + (p.m > p.k ? p.m : p.k);
  const int w = D * D > INT_MAX;
  void (*const kern)(K2ParamsT<T>) =
      w ? k2_kernel64<T, kBand, kWs, kUg> : k2_kernel<T, kBand, kWs, kUg>;
  const int smem =
      (int)k2_smem(p.n, p.m, p.k, p.L, p.C, kBand, p.xsmem, kWs, sizeof(T), !kUg).bytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.B, 1, 1);
  cfg.blockDim = dim3(omc::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (smem_attr[w] < 0) {  // clusters of 16 are beyond the portable size of 8
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return fail(err);
    smem_attr[w] = 0;
  }
  if (smem > smem_attr[w]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return fail(err);
    smem_attr[w] = smem;
  }
  if (smem > schedulable[w][p.C]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
    if (err != cudaSuccess) return fail(err);
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    schedulable[w][p.C] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return fail(err);
  return (int)cudaGetLastError();
}

}  // namespace

// this file is the float build's translation unit; k2_zstep_f64.cu includes
// it with OMC_K2_F64 defined for the float64 build's (one nvcc each, run
// side by side)
#ifndef OMC_K2_F64

// the shared memory omc_torch.sdp.admm.k2k3_plan plans with, at elem bytes
// a value (4, or 8 for the float64 build; chip_smoke.py holds the plan
// against it at every K2 row); usmem 0: the band's zU in U's rows
OMC_EXPORT long long omc_k2_smem_bytes(int n, int m, int k, int L, int C, int band, int xsmem,
                                       int ws, int elem, int usmem) {
  return (long long)k2_smem(n, m, k, L, C, band, xsmem, ws, elem, usmem).bytes;
}

// the doubles of global workspace a slot takes where the partials of s live
// there (K2Params.ws)
OMC_EXPORT long long omc_k2_ws_doubles(int n, int m, int k, int L, int C, int elem) {
  return (long long)k2_smem(n, m, k, L, C, 0, 0, 1, elem).wss;
}

#endif  // OMC_K2_F64

template <class T>
int k2_entry(const K2ParamsT<T>& p, void* stream) {
  if (p.C < 1 || p.C > 16 || p.B < 1 || p.n < 1 || p.m < 1 || p.k < 1 || p.L < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!p.usmem) {  // zU in U's rows: only beside the sym(zY) band in Y's rows
    if (p.band) return (int)cudaErrorInvalidValue;
    return p.ws ? launch<T, false, true, true>(p, st) : launch<T, false, false, true>(p, st);
  }
  if (p.ws)
    return p.band ? launch<T, true, true, false>(p, st) : launch<T, false, true, false>(p, st);
  return p.band ? launch<T, true, false, false>(p, st) : launch<T, false, false, false>(p, st);
}

#ifndef OMC_K2_F64
OMC_EXPORT int omc_k2_zstep(const K2Params* params, void* stream) {
  return k2_entry(*params, stream);
}

#else

// the float64 build: double operands and outputs
OMC_EXPORT int omc_k2_zstep_f64(const K2ParamsT<double>* params, void* stream) {
  return k2_entry(*params, stream);
}

#endif  // OMC_K2_F64
