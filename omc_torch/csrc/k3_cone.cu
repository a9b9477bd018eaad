// K3 — fused forward map and cone step for every ADMM slot except the PSD
// projections.
//
// Replaces, per node slot, omc/sdp/admm.py: _forward (:133-166), the
// over-relaxed w/u-step of the non-PSD slots (:378-427, with project_soc
// from omc/ops/cones.py:30-46) and the dual EMA of rho*ua, rho*ub, rho*uc
// (:510-521):
//   f = K(Xs, Y, Ths, U) + b;   t = alpha f + (1 - alpha) w + u
//   t1, t2, t3 written for K1 (the blocks [Y X; X' Th], [Y U; U' I], I - Y
//   assembled on the fly, no concatenated copies);
//   w4 = max(t4, 0); wsoc = proj_SOC(tsoc); wbox = clip(tbox, U_lo, U_hi);
//   wa, wb, wc = max(., 0) (cut slots masked);  u = t - w;
//   acc += beta (rho u - acc) for ua, ub, uc.
//
// What bounds it on the H100: bytes.  Per slot it reads Xs, Y, Ths, U and
// the w/u blocks of the three PSD slots and writes t1, t2, t3 — about
// 3 (n+m)^2 floats — with a few flops per element; the reductions (tr Y,
// ||U_j||, x_l' U, x_l' Y x_l) are O(L n^2).
//
// Design: one thread-block cluster of C CTAs per node slot (C from
// omc_torch.sdp.admm.k2k3_plan, as K2's).  CTA r owns a band of the rows of
// Y and of Theta; X's 16 x 16 tiles go to every warp of the cluster in turn.
// * First the band's Y entries, spread over the CTA's threads (consecutive
//   threads on consecutive columns, a few entries loaded before any is
//   stored), each read once for the entry's t1, t2 and t3; each thread sums
//   tr Y and Y(i, j) x_l[i] x_l[j] over its entries in float64 (in float32
//   the chord slots of 250 x 250 nodes sat ~1e-6 from the float64 sum,
//   relative), the cut vectors staged in float64 (no conversion an entry).  The CTA keeps its SOC entries' t and sums its partials of
//   ||tsoc_j[1:]||^2 and x_l' U_j; rank 0 stages the trace, interval and
//   chord slots.  Operands the kernel does not write are read through the
//   non-coherent path, so loads may run ahead of stores.
// * The CTA then arrives at a cluster barrier and, before it waits, does the
//   work no sum needs: a warp per X tile reads it once and writes it to t1's
//   upper right and, through shared memory, transposed to t1's lower left
//   (coalesced both ways); the Theta band gives t1's lower right; the box
//   slot of the band's rows.  The partials are then added across the cluster
//   in rank order through distributed shared memory (no atomics: two
//   launches give the same bits), each CTA projects its SOC entries, and
//   rank 0 updates the trace, the SOC heads, the cut interval and chord
//   slots and their EMAs, in the order of operations of
//   omc_torch.sdp.admm.cone_step_plain, from shared memory.  Every slot
//   entry is read by the CTA that writes it, or before the barrier.
// Where even one CTA's partials outgrow shared memory (a deep tree's 2048
// cuts at n = 1000, rank 10), they live in a global workspace (ws): each
// rank's are fenced before the cluster barrier and read through L2.  Where
// U's n k values do not fit beside the rest (n k past 52,509 in float32,
// 25,230 in float64: (1, 6000, 6000, 10, 8) takes 240 KB of U alone), every
// CTA reads U from the input through the non-coherent path instead
// (K3Params.usmem = 0, the kernels' kUg instantiations), in the same order
// of sums: the same bits.
//
// Halpern mode (omc/sdp/admm.py:342-425; K3Params.h1..hc non-null): every
// pre-projection entry t is blended with its anchor, the slot's w + u at the
// solve call's start, as t <- b s0 + (1 - b) t with b = 1 / (it + 2) and it
// the iteration's index in the call (K3Params.hal_it, set on the packed
// block at each launch), before it is stored, projected or summed.  The
// normal mode is the kernel's other instantiation and loads no anchor.
//
// The float64 build (omc_k3_cone_f64) is the same kernel on doubles (T):
// its float section of shared memory is counted in doubles (k3_smem at 8
// bytes a value), and it runs one CTA an SM.
#include <cooperative_groups.h>

#include "common.cuh"

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = omc::kThreads / 32;
constexpr int kChunk = 8;  // chord sums a lane keeps in registers at once
constexpr int kT = 16;     // X's tile edge
constexpr int kU = 4;      // items a thread loads before it stores any

// three values of T loaded together (t1's lower right)
template <class T>
struct Triple {
  T x, y, z;
};
template <class T>
__device__ __forceinline__ Triple<T> make_triple(T x, T y, T z) { return {x, y, z}; }

// Shared memory of one CTA: doubles first (per-warp partials, the CTA's
// partials, their cluster sums: tr Y, x_l'Y x_l, ||tsoc_j[1:]||^2, x_l'U_j),
// then floats.  omc_torch.sdp.admm.k3_smem_bytes mirrors it.  With ws, part
// and tot are counted from the start of the rank's region of wsr doubles in
// the slot's wss doubles of workspace instead.
struct K3Smem {
  int wpart, part, stage, tot, xd;  // doubles
  int us, ts0, tsb, tt, sl;         // floats
  size_t bytes;
  int wsr, wss;
};

__host__ __device__ inline K3Smem k3_smem(int n, int m, int k, int L, int C, int xsmem,
                                          int slsmem, int ws, int elem = 4, int usmem = 1) {
  K3Smem s;
  const int NP = 1 + L + k + L * k;
  int d = 0;
  s.wpart = d, d += kWarps * (1 + kChunk);  // a warp's trace and chunk of chords
  if (ws) {
    s.part = 0, s.stage = -1, s.tot = NP;
  } else {
    s.part = d, d += NP;
    // the cluster's partials, gathered, and their sums (one CTA: its own)
    s.stage = C > 1 ? d : s.part, d += C > 1 ? C * NP : 0;
    s.tot = C > 1 ? d : s.part, d += C > 1 ? NP : 0;
  }
  s.wsr = ws ? 2 * NP : 0;
  s.wss = C * s.wsr;
  s.xd = d, d += xsmem ? L * n : 0;  // the cut vectors, in float64 for x'Yx and x'U
  int f = (8 / elem) * d;  // values of T (elem bytes each)
  s.us = f, f += usmem ? n * k : 0;       // U (where it fits)
  s.ts0 = f, f += k;                      // tsoc_j[0]
  s.tsb = f, f += usmem ? k * omc::cdiv(n, C) : 0;  // the band's tsoc_j[1 + i]
  s.tt = f, f += kWarps * kT * (kT + 1);  // an X tile a warp
  // rank 0's staged slots (where they fit): wa, ua, wb, ub, acc_a, acc_b,
  // lo, hi (L k each); wc, uc, acc_c, cm (L each); w4, u4
  s.sl = f, f += slsmem ? 8 * L * k + 4 * L + 2 : 0;
  s.bytes = (size_t)f * elem;
  return s;
}

// K3's body.  Ix: the type of a slot's own offsets (the products i D1,
// (n + a) D1, i D2, i n, a m): int where (n + m)^2 fits in int, size_t past
// n + m = 46,340 (k3_kernel64).  kUg: U read from global memory (through
// the non-coherent path) where its n k values do not fit shared memory
// beside the rest (K3Params.usmem = 0), and the band's tsoc entries kept
// in their own wsoc entries between the phases (this CTA alone reads and
// writes them); the same values in the same order of sums, so the same
// bits as the staged copies
template <class T, bool kWs, bool kHal, class Ix, bool kUg>
__device__ __forceinline__ void k3_body(const K3ParamsT<T>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const dsm = reinterpret_cast<double*>(smem_raw);
  T* const fsm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = (int)cluster.block_rank(), b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, m = p.m, k = p.k, L = p.L;
  const int D1 = n + m, D2 = n + k, NP = 1 + L + k + L * k, Lk = L * k;
  const T alpha = p.alpha, om = T(1) - p.alpha;
  // the Halpern blend of a slot entry q with its anchor (the normal mode:
  // t as it is)
  const T hbeta = kHal ? T(1) / ((T)p.hal_it + T(2)) : T(0), hom = T(1) - hbeta;
  const auto hal = [&](T t, const T* h, size_t q) -> T {
    if constexpr (kHal)
      return hbeta * __ldg(h + q) + hom * t;
    else
      return t;
  };
  const K3Smem S = k3_smem(n, m, k, L, C, p.xsmem, p.slsmem, kWs, sizeof(T), !kUg);
  // the slot's workspace, and where part and tot live
  double* const wsd = kWs ? p.ws + (size_t)b * S.wss : nullptr;
  double* const rd = kWs ? wsd + (size_t)rank * S.wsr : dsm;
  double* wpart = dsm + S.wpart;
  double* part = rd + S.part;
  double* tot = rd + S.tot;
  double* xd = dsm + S.xd;
  T* us = fsm + S.us;
  T* ts0 = fsm + S.ts0;
  T* tsb = fsm + S.tsb;
  T* sl = fsm + S.sl;
  // this CTA's rows of Y [i0, i0 + nb) and of Theta [a0, a0 + nbT)
  const int i0 = omc::band_lo(n, C, rank), nb = omc::band_lo(n, C, rank + 1) - i0;
  const int a0 = omc::band_lo(m, C, rank), nbT = omc::band_lo(m, C, rank + 1) - a0;

  const T sX = p.sX[b], sT = p.sT[b], rho = p.rho[b];
  // the operands K3 reads and does not write
  const omc::ROT<T> Xs{p.Xs + (size_t)b * n * m}, Y{p.Y + (size_t)b * n * n};
  const omc::ROT<T> Ths{p.Ths + (size_t)b * m * m}, U{p.U + (size_t)b * n * k};
  const omc::ROT<T> w1{p.w1 + (size_t)b * D1 * D1}, u1{p.u1 + (size_t)b * D1 * D1};
  const omc::ROT<T> w2{p.w2 + (size_t)b * D2 * D2}, u2{p.u2 + (size_t)b * D2 * D2};
  const omc::ROT<T> w3{p.w3 + (size_t)b * n * n}, u3{p.u3 + (size_t)b * n * n};
  const omc::ROT<T> cx{p.cut_x + (size_t)b * L * n}, Ulo{p.U_lo}, Uhi{p.U_hi};
  T* t1 = p.t1 + (size_t)b * D1 * D1;
  T* t2 = p.t2 + (size_t)b * D2 * D2;
  T* t3 = p.t3 + (size_t)b * n * n;
  T* wsoc = p.wsoc + (size_t)b * k * (1 + n);
  T* usoc = p.usoc + (size_t)b * k * (1 + n);
  // the slot's anchors of the PSD and SOC slots (Halpern mode)
  const T* h1 = kHal ? p.h1 + (size_t)b * D1 * D1 : nullptr;
  const T* h2 = kHal ? p.h2 + (size_t)b * D2 * D2 : nullptr;
  const T* h3 = kHal ? p.h3 + (size_t)b * n * n : nullptr;
  const T* hsoc = kHal ? p.hsoc + (size_t)b * k * (1 + n) : nullptr;

  if (p.xsmem)
    for (int l = warp; l < L; l += kWarps)
      for (int j = lane; j < n; j += 32) xd[l * n + j] = (double)cx[l * n + j];
  // the cut vectors: staged, or where they do not fit read from the input
  const auto X = [&](int l, int j) { return p.xsmem ? xd[l * n + j] : (double)cx[l * n + j]; };
  // U: staged, or where it does not fit read from the input
  const auto Uv = [&](int e) -> T {
    if constexpr (kUg)
      return U[e];
    else
      return us[e];
  };
  if (!kUg)
    for (int e = tid; e < n * k; e += blockDim.x) us[e] = U[e];
  for (int j = tid; j < k; j += blockDim.x) {
    const int q = j * (1 + n);
    ts0[j] = hal(alpha * T(1) + om * wsoc[q] + usoc[q], hsoc, q);
  }
  if (rank == 0 && p.slsmem) {  // the slots rank 0 updates after the cluster sums
    const size_t qk = (size_t)b * Lk, ql = (size_t)b * L;
    for (int e = tid; e < Lk; e += blockDim.x) {
      sl[e] = p.wa[qk + e], sl[Lk + e] = p.ua[qk + e];
      sl[2 * Lk + e] = p.wb[qk + e], sl[3 * Lk + e] = p.ub[qk + e];
      sl[4 * Lk + e] = p.acc_a[qk + e], sl[5 * Lk + e] = p.acc_b[qk + e];
      sl[6 * Lk + e] = p.cut_lo[qk + e], sl[7 * Lk + e] = p.cut_hi[qk + e];
    }
    for (int l = tid; l < L; l += blockDim.x) {
      sl[8 * Lk + l] = p.wc[ql + l], sl[8 * Lk + L + l] = p.uc[ql + l];
      sl[8 * Lk + 2 * L + l] = p.acc_c[ql + l], sl[8 * Lk + 3 * L + l] = p.cut_mask[ql + l];
    }
    if (tid == 0) sl[8 * Lk + 4 * L] = p.w4[b], sl[8 * Lk + 4 * L + 1] = p.u4[b];
  }
  __syncthreads();

  // ---- PSD slots, t = alpha f + (1 - alpha) w + u.  The band's rows of
  // t1, t2 and t3 from its Y rows, the entries spread over the CTA's
  // threads, with tr Y and, per thread over its entries, Y(i, j) x_l[i]
  // x_l[j]; one warp sum per chunk of cuts
  const float inv_n = 1.0f / (float)n;
  const int nbn = nb * n;
  double tr = 0.0;
  for (int l0 = 0; l0 == 0 || l0 < L; l0 += kChunk) {
    double acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = 0.0;
    for (int e0 = tid; e0 < nbn; e0 += kU * blockDim.x) {
      T y[kU], a1[kU], b1[kU], a2[kU], b2[kU], a3[kU], b3[kU];
      int iv[kU], jv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < nbn) {
          int ii, j;
          omc::divmod(e, n, inv_n, ii, j);
          const int i = i0 + ii;
          const Ix q1 = (Ix)i * D1 + j, q2 = (Ix)i * D2 + j, q3 = (Ix)i * n + j;
          iv[u] = i, jv[u] = j;
          y[u] = Y[q3];
          if (l0 == 0) {
            a1[u] = w1[q1], b1[u] = u1[q1], a2[u] = w2[q2], b2[u] = u2[q2];
            a3[u] = w3[q3], b3[u] = u3[q3];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (e0 + u * blockDim.x >= nbn) break;
        const int i = iv[u], j = jv[u];
        if (l0 == 0) {
          const Ix q1 = (Ix)i * D1 + j, q2 = (Ix)i * D2 + j, q3 = (Ix)i * n + j;
          t1[q1] = hal((alpha * y[u] + om * a1[u]) + b1[u], h1, q1);
          t2[q2] = hal((alpha * y[u] + om * a2[u]) + b2[u], h2, q2);
          t3[q3] = hal((alpha * ((i == j ? T(1) : T(0)) - y[u]) + om * a3[u]) + b3[u], h3, q3);
          if (j == i) tr += y[u];
        }
        const double yd = y[u];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (l0 + c < L)
            acc[c] = fma(yd * X(l0 + c, i), X(l0 + c, j), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (l0 + c >= L) break;
      const double s = omc::warp_sum_d(acc[c]);
      if (lane == 0) wpart[warp * (1 + kChunk) + 1 + c] = s;
    }
    __syncthreads();  // this chunk's x'Yx partials, in warp order
    for (int c = tid; c < kChunk && l0 + c < L; c += blockDim.x) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += wpart[w * (1 + kChunk) + 1 + c];
      part[1 + l0 + c] = s;
    }
    __syncthreads();
  }
  tr = omc::warp_sum_d(tr);
  if (lane == 0) wpart[warp * (1 + kChunk)] = tr;
  // t2's U columns of the band's rows
  for (int e = tid; e < nb * k; e += blockDim.x) {
    const int ii = e / k, c = e - ii * k;
    const Ix q = (Ix)(i0 + ii) * D2 + n + c;
    t2[q] = hal((alpha * Uv((i0 + ii) * k + c) + om * w2[q]) + u2[q], h2, q);
  }

  // ---- the band's SOC entries tsoc_j[1 + i], kept, with ||.||^2 (a warp
  // per j), and x_l' U_j over the band
  for (int j = warp; j < k; j += kWarps) {
    double s = 0.0;
    for (int ii = lane; ii < nb; ii += 32) {
      const int i = i0 + ii, q = j * (1 + n) + 1 + i;
      const T t = hal((alpha * Uv(i * k + j) + om * wsoc[q]) + usoc[q], hsoc, q);
      if (kUg)  // kept in the slot's own entry until the projection
        wsoc[q] = t;
      else
        tsb[j * nb + ii] = t;
      s = fma((double)t, (double)t, s);
    }
    s = omc::warp_sum_d(s);
    if (lane == 0) part[1 + L + j] = s;
  }
  for (int e = tid; e < Lk; e += blockDim.x) {
    const int l = e / k, j = e - l * k;
    double v = 0.0;
    for (int i = i0; i < i0 + nb; ++i) v = fma(X(l, i), (double)Uv(i * k + j), v);
    part[1 + L + k + e] = v;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wpart[w * (1 + kChunk)];
    part[0] = s;
  }
  if (kWs) __threadfence();  // the partials reach L2 before the barrier
  omc::cluster_arrive();
  // ---- while the other CTAs reach the barrier, the work no sum needs.
  // X's tiles, every warp of the cluster in turn: t1's upper right as read,
  // its lower left through the warp's tile in shared memory
  {
    T* tt = fsm + S.tt + warp * kT * (kT + 1);
    const int ntn = omc::cdiv(n, kT), ntm = omc::cdiv(m, kT), cc = lane & (kT - 1),
              r0 = lane >> 4;
    constexpr int R = kT / 2;  // rows of a tile a lane takes
    // (from the last rank down: at small batches rank 0 has the small slots)
    for (int tl = (C - 1 - rank) * kWarps + warp; tl < ntn * ntm; tl += C * kWarps) {
      const int I = tl / ntm, J = tl - I * ntm;
      // every load of the tile pair's entries first, then the stores
      T x[R], wu[R], uu[R], wl[R], ul[R];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int rr = r0 + 2 * h, i = I * kT + rr, a = J * kT + cc;
        if (i < n && a < m) {
          const Ix q = (Ix)i * D1 + n + a;
          x[h] = Xs[i * m + a], wu[h] = w1[q], uu[h] = u1[q];
        }
        const int a2 = J * kT + rr, j2 = I * kT + cc;
        if (a2 < m && j2 < n) {
          const Ix q = (Ix)(n + a2) * D1 + j2;
          wl[h] = w1[q], ul[h] = u1[q];
        }
      }
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int rr = r0 + 2 * h, i = I * kT + rr, a = J * kT + cc;
        if (i < n && a < m) {
          tt[rr * (kT + 1) + cc] = x[h];
          const Ix q = (Ix)i * D1 + n + a;
          t1[q] = hal((alpha * (sX * x[h]) + om * wu[h]) + uu[h], h1, q);
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int rr = r0 + 2 * h, a = J * kT + rr, j = I * kT + cc;
        if (a < m && j < n) {
          const Ix q = (Ix)(n + a) * D1 + j;
          t1[q] = hal((alpha * (sX * tt[cc * (kT + 1) + rr]) + om * wl[h]) + ul[h], h1, q);
        }
      }
      __syncwarp();
    }
  }
  // t1's lower right from the Theta band's rows
  omc::grid_items<kU>(
      nbT, m, tid, blockDim.x,
      [&](int aa, int j) {
        const int a = a0 + aa;
        const Ix q = (Ix)(n + a) * D1 + n + j;
        return make_triple(Ths[(Ix)a * m + j], w1[q], u1[q]);
      },
      [&](int aa, int j, Triple<T> v) {
        const Ix q = (Ix)(n + a0 + aa) * D1 + n + j;
        t1[q] = hal((alpha * (sT * v.x) + om * v.y) + v.z, h1, q);
      });
  // t2's rows n + c: [U', I], row c by CTA c mod C
  for (int c = rank + C * warp; c < k; c += C * kWarps) {
    const int r = n + c;
    for (int j = lane; j < n; j += 32) {
      const Ix q = (Ix)r * D2 + j;
      t2[q] = hal((alpha * Uv(j * k + c) + om * w2[q]) + u2[q], h2, q);
    }
    for (int j = lane; j < k; j += 32) {
      const Ix q = (Ix)r * D2 + n + j;
      t2[q] = hal((alpha * (c == j ? T(1) : T(0)) + om * w2[q]) + u2[q], h2, q);
    }
  }

  // ---- box slot of the band's rows
  for (int e = tid; e < nb * k; e += blockDim.x) {
    const size_t q = (size_t)b * n * k + (size_t)i0 * k + e;
    const T t = hal((alpha * Uv(i0 * k + e) + om * p.wbox[q]) + p.ubox[q], p.hbox, q);
    const T w = fmin(fmax(t, Ulo[q]), Uhi[q]);
    p.wbox[q] = w;
    p.ubox[q] = t - w;
  }

  omc::cluster_wait();
  if (kWs)
    omc::cluster_sum_global(wsd + S.part, S.wsr, tot, NP, C);
  else
    omc::cluster_sum(cluster, part, dsm + S.stage, tot, NP, C);
  omc::cluster_arrive();  // this CTA reads no other CTA's memory from here

  // ---- SOC slots (1, U_j): the band's entries, and the heads on rank 0
  for (int j = 0; j < k; ++j) {
    const T tt = ts0[j], nj = (T)sqrt(tot[1 + L + j]);
    const bool inside = nj <= tt, polar = nj <= -tt;
    const T scale = nj > T(0) ? T(0.5) * (T(1) + tt / nj) : T(0);
    for (int ii = tid; ii < nb; ii += blockDim.x) {
      const int q = j * (1 + n) + 1 + i0 + ii;
      const T t = kUg ? wsoc[q] : tsb[j * nb + ii];
      const T w = inside ? t : (polar ? T(0) : scale * t);
      wsoc[q] = w;
      usoc[q] = t - w;
    }
    if (rank == 0 && tid == 0) {
      const int q = j * (1 + n);
      const T w = inside ? tt : (polar ? T(0) : T(0.5) * (tt + nj));
      wsoc[q] = w;
      usoc[q] = tt - w;
    }
  }
  if (rank == 0) {
    // the slots as staged, or in place where they did not fit
    const bool stg = p.slsmem;
    const size_t qk = (size_t)b * Lk, ql = (size_t)b * L;
    const T* wa0 = stg ? sl : p.wa + qk;
    const T* ua0 = stg ? sl + Lk : p.ua + qk;
    const T* wb0 = stg ? sl + 2 * Lk : p.wb + qk;
    const T* ub0 = stg ? sl + 3 * Lk : p.ub + qk;
    const T* aa0 = stg ? sl + 4 * Lk : p.acc_a + qk;
    const T* ab0 = stg ? sl + 5 * Lk : p.acc_b + qk;
    const T* lo_ = stg ? sl + 6 * Lk : p.cut_lo + qk;
    const T* hi_ = stg ? sl + 7 * Lk : p.cut_hi + qk;
    const T* wc0 = stg ? sl + 8 * Lk : p.wc + ql;
    const T* uc0 = stg ? sl + 8 * Lk + L : p.uc + ql;
    const T* ac0 = stg ? sl + 8 * Lk + 2 * L : p.acc_c + ql;
    const T* cm = stg ? sl + 8 * Lk + 3 * L : p.cut_mask + ql;
    // ---- trace slot
    if (tid == 0) {
      const T tr_y = (T)tot[0];
      const T w40 = stg ? sl[8 * Lk + 4 * L] : p.w4[b];
      const T u40 = stg ? sl[8 * Lk + 4 * L + 1] : p.u4[b];
      const T t4 = hal((alpha * ((T)k - tr_y) + om * w40) + u40, p.h4, b);
      const T w4 = fmax(t4, T(0));
      p.w4[b] = w4;
      p.u4[b] = t4 - w4;
    }
    // ---- cut interval slots and the dual EMA
    const double* v = tot + 1 + L + k;
    for (int e = tid; e < Lk; e += blockDim.x) {
      const size_t q = qk + e;
      const T lo = lo_[e], hi = hi_[e], c = cm[e / k], ve = (T)v[e];
      const T ta = hal((alpha * (ve - lo) + om * wa0[e]) + ua0[e], p.ha, q);
      const T wa = fmax(ta, T(0)), ua = (ta - wa) * c;
      const T aa = aa0[e];
      p.wa[q] = wa;
      p.ua[q] = ua;
      p.acc_a[q] = aa + p.beta * (rho * ua - aa);
      const T tb = hal((alpha * (hi - ve) + om * wb0[e]) + ub0[e], p.hb, q);
      const T wb = fmax(tb, T(0)), ub = (tb - wb) * c;
      const T ab = ab0[e];
      p.wb[q] = wb;
      p.ub[q] = ub;
      p.acc_b[q] = ab + p.beta * (rho * ub - ab);
    }
    // chord slots
    for (int l = tid; l < L; l += blockDim.x) {
      T cv = T(0), bc = T(0);
      for (int j = 0; j < k; ++j) {
        const T lo = lo_[l * k + j], hi = hi_[l * k + j];
        cv += (lo + hi) * (T)v[l * k + j];
        bc += -lo * hi;
      }
      const T f = cv + bc - (T)tot[1 + l];
      const size_t q = ql + l;
      const T tc = hal((alpha * f + om * wc0[l]) + uc0[l], p.hc, q);
      const T wc = fmax(tc, T(0)), uc = (tc - wc) * cm[l];
      const T ac = ac0[l];
      p.wc[q] = wc;
      p.uc[q] = uc;
      p.acc_c[q] = ac + p.beta * (rho * uc - ac);
    }
  }
  omc::cluster_wait();  // no CTA leaves while another may read its partials
}

// kWs: the partials in the global workspace; kHal: the Halpern mode; kUg:
// U read from global memory; T: float, or double (the float64 build, one
// CTA an SM)
template <class T, bool kWs, bool kHal, bool kUg>
__global__ void __launch_bounds__(omc::kThreads, sizeof(T) == 8 ? 1 : 2)
    k3_kernel(K3ParamsT<T> p) {
  k3_body<T, kWs, kHal, int, kUg>(p);
}

// past n + m = 46,340: a slot's offsets in 64 bits
template <class T, bool kWs, bool kHal, bool kUg>
__global__ void __launch_bounds__(omc::kThreads, sizeof(T) == 8 ? 1 : 2)
    k3_kernel64(K3ParamsT<T> p) {
  k3_body<T, kWs, kHal, size_t, kUg>(p);
}

int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <class T, bool kWs, bool kHal, bool kUg>
int launch(const K3ParamsT<T>& p, cudaStream_t stream) {
  // per kernel (int offsets, then 64-bit ones): its max dynamic shared
  // memory, and the largest smem a cluster of C was shown to fit
  static int smem_attr[2] = {-1, -1};
  static int schedulable[2][17] = {};
  const long long D = p.n + (p.m > p.k ? p.m : p.k);
  const int w = D * D > INT_MAX;
  void (*const kern)(K3ParamsT<T>) =
      w ? k3_kernel64<T, kWs, kHal, kUg> : k3_kernel<T, kWs, kHal, kUg>;
  const int smem =
      (int)k3_smem(p.n, p.m, p.k, p.L, p.C, p.xsmem, p.slsmem, kWs, sizeof(T), !kUg).bytes;
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

// this file is the float build's translation unit; k3_cone_f64.cu includes
// it with OMC_K3_F64 defined for the float64 build's (one nvcc each, run
// side by side)
#ifndef OMC_K3_F64

// the shared memory omc_torch.sdp.admm.k2k3_plan plans with, at elem bytes
// a value (4, or 8 for the float64 build; chip_smoke.py holds the plan
// against it at every K3 row); usmem 0: U read from global memory
OMC_EXPORT long long omc_k3_smem_bytes(int n, int m, int k, int L, int C, int xsmem,
                                       int slsmem, int ws, int elem, int usmem) {
  return (long long)k3_smem(n, m, k, L, C, xsmem, slsmem, ws, elem, usmem).bytes;
}

// the doubles of global workspace a slot takes where the partials live
// there (K3Params.ws)
OMC_EXPORT long long omc_k3_ws_doubles(int n, int m, int k, int L, int C) {
  return (long long)k3_smem(n, m, k, L, C, 0, 0, 1).wss;
}

#endif  // OMC_K3_F64

template <class T>
int k3_entry(const K3ParamsT<T>& p, void* stream) {
  if (p.C < 1 || p.C > 16 || p.B < 1 || p.n < 1 || p.m < 1 || p.k < 1 || p.L < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool hal = p.h1 != nullptr;
  if (hal && (!p.h2 || !p.h3 || !p.h4 || !p.hsoc || !p.hbox || !p.ha || !p.hb || !p.hc ||
              p.hal_it < 0))
    return (int)cudaErrorInvalidValue;
  if (p.usmem) {
    if (p.ws) return hal ? launch<T, true, true, false>(p, st) : launch<T, true, false, false>(p, st);
    return hal ? launch<T, false, true, false>(p, st) : launch<T, false, false, false>(p, st);
  }
  if (p.ws) return hal ? launch<T, true, true, true>(p, st) : launch<T, true, false, true>(p, st);
  return hal ? launch<T, false, true, true>(p, st) : launch<T, false, false, true>(p, st);
}

#ifndef OMC_K3_F64
OMC_EXPORT int omc_k3_cone(const K3Params* params, void* stream) {
  return k3_entry(*params, stream);
}

#else

// the float64 build: double operands and outputs
OMC_EXPORT int omc_k3_cone_f64(const K3ParamsT<double>* params, void* stream) {
  return k3_entry(*params, stream);
}

#endif  // OMC_K3_F64
