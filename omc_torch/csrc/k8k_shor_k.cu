// K8c and K8d — the rank-k Shor slots outside the PSD blocks, and the z-step.
//
// K8c replaces, per node slot, the Shor part of the z-step of
// omc/sdp/shor_k.py: _adjoint_shor_k (:413-485, the scatter-add of the
// per-term minor, XWH, RSOC, W-link and Theta-link duals onto Xt, W, Wt, H,
// v1-v3), the W >= 0 / Wt >= 0 adjoints (:635-636), the Sherman-Morrison X
// solve per matrix entry with the proximal term tau_x Xt_prev (:653-659),
// the diagonal solves (:660-668), the link Woodbury on (Theta, W, Wt, H)
// (:679-700), sym(Theta) and the clip of Xt to +-R_X/sX (:702-705).  It
// also writes X = sum_t Xt, which K3 and the cone steps read.  The base
// slots' share of Xt and Theta comes from w1 - u1 here (K2 runs in its Shor
// mode and writes Y and U only).
//
// K8d replaces the cone step of the RSOC rows on the complement (:754-757,
// project_rsoc of omc/ops/cones.py in closed form), the Theta-link and
// W-link rows (:758-763, zero cones), the W >= 0 and Wt >= 0 slots
// (:764-769) and the EMAs of rho*ur, rho*ul, rho*uwl (:836-838).
//
// What bounds both on the H100: bytes.  Per slot K8c streams w1/u1's X and
// Theta blocks, the k terms of Xt and the W, W >= 0, D1x/c1x/D1w arrays of
// the n*m entries once, and gathers the k (5x5) minor duals and the
// (k+1)x(k+1) XWH duals of each coordinate through the inverse tables, with
// tens of flops per entry; K8d streams W, wp/up and the RSOC, link and Wt
// slots once.
//
// K8c's design (sdp.shor_k.k8c_plan picks the tile):
// - A CTA of 256 threads owns `cols` whole columns of one node slot (8 at
//   config 3's B = 32, m = 75: 320 CTAs), as 256 / cols row groups; every
//   coupling of the link Woodbury is column-local, so one launch finishes
//   the step (no atomics, no second pass).
// - Phase 1, per entry (i, j): the adjoint, the Sherman-Morrison X solve,
//   the uncorrected W, Wt and H, and the entry's W-link residual q_c, all in
//   registers.  The minor duals are two loads away: fm_ptr[f] (coalesced)
//   and fm_ent[e] = 4 l + corner give the 5x5 record of minor l directly.
//   The uncorrected values and q_c are kept in shared memory for phase 3;
//   each thread adds its entries' W and B_jc q_c / D_c to two column sums.
// - Phase 2: the row groups' column sums are added in row-group order (so
//   two launches give the same bits); one thread a column finishes Theta's
//   diagonal and the Woodbury coefficient a_j.
// - Phase 3, per entry: the link corrections of W, Wt and H from the kept
//   values, then Theta off the diagonal, whose transposed half was staged
//   through shared memory by coalesced row reads at the start.
// - The v1-v3 solves are diagonal and the padded coordinates need no link
//   term, so both are spread over all of the slot's CTAs by index range,
//   one table walk serving a v entry's k terms.
// All sums run in a fixed order through tables built on the host once per
// visit.
//
// K8d's grid is sized to the card (omc_torch.sdp.shor_k.k8d_plan, export
// omc_k8d_grid_x), one dimension, four kinds of CTA of 128 threads:
//  (l) x < B ceil(m / 32): the Theta-link rows of 32 columns of a slot
//      (omc::link_rows, K8b's: 4 row groups summing sW W in row order, the
//      groups in order; no atomics, the same bits every run);
//  (w) then W >= 0 over the batch's flat B n m, a quad of 4 entries a thread
//      in 16-byte words;
//  (r) then the RSOC rows of the batch's flat B Ms, a quad a thread: its
//      entries and masks one 16-byte word each, then W and X gathered at
//      the entries, the warp's triples staged through shared memory;
//  (c) then the coordinates of the batch's flat B C, one a thread: its
//      W-link row and its k Wt >= 0 slots, so Wt and H are read once.
// Each flat kind takes ipc items a CTA (128, 64 or 32; the plan narrows it
// until the flat CTAs fill the card's SMs), each lane issues all of its
// loads before its first store, and the operands are __restrict__.
//
// The register kernels above are templates on K = k, instantiated for k =
// 2..4.  The wide kernels take any k: k8c_kernel<0> (omc_k8c_shor_k_zstep
// _wide) walks the terms at run time, its kept values in shared memory or
// a global workspace, and also takes the k <= 4 shapes whose kept values
// pass k8c_kernel's shared memory; k8d_kernel<0> (omc_k8d_shor_k_cone_wide)
// is K8d with its coordinates' CTAs at a run-time rank.
//
// The float64 builds (omc_k8c_shor_k_zstep_f64, omc_k8d_shor_k_cone_f64)
// are the same kernels on doubles.  K8c keeps its values and the row
// groups' column sums (still added in row-group order) in doubles, so its
// tile narrows where they outgrow a CTA's shared memory (k8c_plan at 8
// bytes a value); its divides are omc::quot's (the hardware reciprocal
// refined, not the IEEE divide's slow path, around which ptxas spills).
// K8d's thread takes a pair of doubles where the float build takes a quad
// (one 16-byte word of each of W, wp, up, the RSOC mask; its 6 RSOC values
// 3 words of the warp's staging, at the float build's 48-byte stride; two
// soc_flat entries one 8-byte word), as K8b's float64 build does.
#include "common.cuh"

namespace {

constexpr int kCols = 32;  // K8c's widest tile

// K8c's dynamic shared memory (values of T): the kept per-entry values
// (W, q_c, c, Wt, H: k + k(k-1)/2 + 3 fields of n x cols), two column sums
// per row group, a_j, and Theta's staged block rows (cols x (m + 1))
__host__ __device__ inline int k8c_smem_values(int n, int m, int k, int cols) {
  const int nf = k + k * (k - 1) / 2 + 3, rg = omc::kThreads / cols;
  return nf * n * cols + 2 * rg * cols + cols + cols * (m + 1);
}

// a coordinate index kept in a value slot of T (its bits), and back
__device__ __forceinline__ float int_in(float, int c) { return __int_as_float(c); }
__device__ __forceinline__ double int_in(double, int c) { return __longlong_as_double(c); }
__device__ __forceinline__ int int_of(float x) { return __float_as_int(x); }
__device__ __forceinline__ int int_of(double x) { return (int)__double_as_longlong(x); }

// The register kernels, k8c_kernel<k, T> for k = 2..4, hold an entry's k
// terms and k(k-1)/2 H in registers.  The wide kernel, k8c_kernel<0, T>,
// takes any k, and the shapes whose kept values pass a CTA's shared memory:
// the same column-owning CTA and the same three phases, with the rank a
// run-time value.  Its phase 1 walks the terms in turn (each term's minor
// duals, XWH duals and Wt solve, its X right-hand side summed into the
// Sherman-Morrison sum), then walks them again for the X solve and the clip
// (the same operations, so the same values), so that no per-term array
// lives in registers.  Its kept values (NF = 3 + k + k(k-1)/2 per entry)
// sit in shared memory where n x cols of them fit, else in a global
// workspace of (B, NF, n, m) values (p.ws; sdp.shor_k.k8c_plan); it reads
// Theta's transposed half from w1/u1 directly (no staged rows) and walks a
// v entry's table once a term.  Every sum runs in the register kernels'
// order.

// the wide kernel's dynamic shared memory (values of T): the kept values
// (none where they are in the workspace), two column sums a row group, a_j
__host__ __device__ inline long long k8c_wide_smem_values(int n, int k, int cols, bool global) {
  const long long nf = k + (long long)k * (k - 1) / 2 + 3, rg = omc::kThreads / cols;
  return (global ? 0 : nf * n * cols) + 2 * rg * cols + cols;
}

// (one CTA an SM at least: ptxas may then give k = 4 the registers it
// needs, and without it ptxas spilled the wide float build)
template <int KR, class T>
__global__ void __launch_bounds__(omc::kThreads, 1) k8c_kernel(K8cParamsT<T> p) {
  using omc::quot;
  constexpr bool kWide = KR == 0;
  constexpr int KPR = KR * (KR - 1) / 2;  // the register kernels' extents
  const int K = kWide ? p.k : KR, KP = K * (K - 1) / 2;
  const int D = K + 1, DD = D * D;
  // fields of the kept per-entry values
  const int fW = 0, fQ = 1, fC = 2, fWt = 3, fH = 3 + K, NF = 3 + K + KP;
  extern __shared__ __align__(16) unsigned char k8c_smem_raw[];
  T* const sm = reinterpret_cast<T*>(k8c_smem_raw);
  const int cols = p.cols, RG = omc::kThreads / cols;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int col = tid % cols, rg = tid / cols;
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m, C = p.C;
  const int j0 = blockIdx.x * cols, j = j0 + col;
  const bool live = j < m;
  // kept value (field, row i) of this thread's column: [NF][n][cols] in
  // shared memory, or [B][NF][n][m] in the wide kernel's workspace
  const bool glob = kWide && p.ws != nullptr;
  T* kept = glob ? p.ws + (size_t)b * NF * nm + j : sm;
  T* part = sm + (glob ? 0 : NF * n * cols);  // [2][RG][cols]
  T* a_s = part + 2 * RG * cols;              // [cols]
  T* thb = a_s + cols;                        // [cols][m + 1] (register kernels)
#define KEPT(fld, i) \
  (glob ? kept[(size_t)(fld) * nm + (size_t)(i) * m] : kept[((fld) * n + (i)) * cols + col])
  const T rho = p.rho[b], sX = p.sX[b], sT = p.sT[b], sS = p.sS[b];
  const T sW = sX * sX;
  const T* __restrict__ w1 = p.w1 + (size_t)b * D1 * D1;
  const T* __restrict__ u1 = p.u1 + (size_t)b * D1 * D1;
  const T* __restrict__ w5 = p.w5 + (size_t)b * p.M5 * K * 25;
  const T* __restrict__ u5 = p.u5 + (size_t)b * p.M5 * K * 25;
  const T* __restrict__ wx = p.wx + (size_t)b * C * DD;
  const T* __restrict__ ux = p.ux + (size_t)b * C * DD;
  const T* __restrict__ wr = p.wr + (size_t)b * p.Ms * 3;
  const T* __restrict__ ur = p.ur + (size_t)b * p.Ms * 3;
  const T* __restrict__ socm = p.soc_mask + (size_t)b * p.Ms;
  const T* __restrict__ cdm = p.coord_mask + (size_t)b * C;
  const T* __restrict__ wwl = p.wwl + (size_t)b * C;
  const T* __restrict__ uwl = p.uwl + (size_t)b * C;
  const T* __restrict__ wq = p.wq + (size_t)b * K * C;
  const T* __restrict__ uq = p.uq + (size_t)b * K * C;
  const int* __restrict__ fm_ptr = p.fm_ptr + (size_t)b * (nm + 1);
  const int* __restrict__ fm_ent = p.fm_ent + (size_t)b * 4 * p.M5;
  const int* __restrict__ flat_coord = p.flat_coord + (size_t)b * nm;
  const int* __restrict__ flat_soc = p.flat_soc + (size_t)b * nm;
  const T* __restrict__ D1x = p.D1x + (size_t)b * nm;
  const T* __restrict__ c1x = p.c1x + (size_t)b * nm;
  const T* __restrict__ D1w = p.D1w + (size_t)b * nm;
  const T* __restrict__ D1wt = p.D1wt + (size_t)b * C;
  const T* __restrict__ D1h = p.D1h + (size_t)b * C;
  const T* __restrict__ D_c = p.D_c + (size_t)b * C;
  const T* __restrict__ B_jc = p.B_jc + (size_t)b * C;
  T* __restrict__ Xt = p.Xt + (size_t)b * K * nm;
  T* __restrict__ Xs = p.Xs + (size_t)b * nm;
  T* __restrict__ Ws = p.Ws + (size_t)b * nm;
  T* __restrict__ Wt = p.Wt + (size_t)b * K * C;
  T* __restrict__ Hh = p.Hh + (size_t)b * KP * C;
  T* __restrict__ Ths = p.Ths + (size_t)b * m * m;
  const T R_Xs = quot(p.R_X, sX);
  const T yl = live ? p.wl[b * m + j] - p.ul[b * m + j] : T(0);

  // ---- Theta's block rows n + j0 .. n + j0 + cols - 1, read along rows ----
  if constexpr (!kWide) {
    for (int e = tid; e < cols * m; e += omc::kThreads) {
      const int cl = e / m, i = e - cl * m;
      if (j0 + cl < m) {
        const size_t qb = (size_t)(n + j0 + cl) * D1 + n + i;
        thb[cl * (m + 1) + i] = quot(rho * (sT * (w1[qb] - u1[qb])), rho * sT * sT);
      }
    }
  }

  // ---- per entry: adjoint, X solve, uncorrected W / Wt / H, q_c ----
  T csum = 0, bsum = 0;
  if (live) {
    for (int i = rg; i < n; i += RG) {
      const int f = i * m + j;
      if constexpr (!kWide) {
        T gx[KR], zWt[KR], zH[KPR];
#pragma unroll
        for (int t = 0; t < K; ++t) gx[t] = T(0), zWt[t] = T(0);
#pragma unroll
        for (int q = 0; q < KP; ++q) zH[q] = T(0);
        T gw = 0, ywl = 0;
        const int c = flat_coord[f];
        if (c >= 0) {
          const T cm = cdm[c];
          T gwt[KR], gh[KPR];
#pragma unroll
          for (int t = 0; t < K; ++t) gwt[t] = T(0);
          // per-term 5x5 minor duals of the entry's minors: (0, cc), (cc, cc)
          const int e1 = fm_ptr[f + 1];
          for (int e = fm_ptr[f]; e < e1; ++e) {
            const int ent = fm_ent[e], l = ent >> 2, cc = (ent & 3) + 1;
#pragma unroll
            for (int t = 0; t < K; ++t) {
              const size_t q = ((size_t)l * K + t) * 25;
              gx[t] += T(2) * (sS * (w5[q + cc] - u5[q + cc]));
              gwt[t] += sS * (w5[q + cc * 6] - u5[q + cc * 6]);
            }
          }
          // XWH duals of this coordinate
          const size_t qx = (size_t)c * DD;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            gx[t] += T(2) * ((sS * (wx[qx + t + 1] - ux[qx + t + 1])) * cm);
            const size_t qd = qx + (t + 1) * (D + 1);
            gwt[t] = gwt[t] + (sS * (wx[qd] - ux[qd])) * cm;
          }
          int qp = 0;
#pragma unroll
          for (int t1 = 0; t1 < K; ++t1)
#pragma unroll
            for (int t2 = t1 + 1; t2 < K; ++t2, ++qp) {
              const size_t qa = qx + (t1 + 1) * D + t2 + 1, qb = qx + (t2 + 1) * D + t1 + 1;
              gh[qp] = (sS * (wx[qa] - ux[qa])) * cm + (sS * (wx[qb] - ux[qb])) * cm;
            }
          // W-link row: +ywl on W_c, -ywl on Wt, -2 ywl on H; then Wt >= 0
          ywl = (sS * (wwl[c] - uwl[c])) * cm;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            gwt[t] = gwt[t] - ywl;
            gwt[t] = gwt[t] + sS * (wq[(size_t)t * C + c] - uq[(size_t)t * C + c]);
            zWt[t] = quot(quot(rho * gwt[t], rho), D1wt[c]);
          }
#pragma unroll
          for (int q = 0; q < KP; ++q) {
            gh[q] = gh[q] - T(2) * ywl;
            zH[q] = quot(quot(rho * gh[q], rho), D1h[c]);
          }
        }
        // RSOC row (0.5, W, sum_t Xt): its X slot lands on every term
        const int s = flat_soc[f];
        if (s >= 0) {
          const T sm_ = socm[s];
          gw += (sS * (wr[3 * s + 1] - ur[3 * s + 1])) * sm_;
          const T y2 = (sS * (wr[3 * s + 2] - ur[3 * s + 2])) * sm_;
#pragma unroll
          for (int t = 0; t < K; ++t) gx[t] += y2;
        }
        gw += ywl;
        gw = gw - sW * yl;
        const size_t qe = (size_t)b * nm + f;
        gw = gw + sS * (p.wp[qe] - p.up[qe]);

        // X block: (D1x I_k + c1x J_k)^-1 by Sherman-Morrison, proximal term
        // tau_x Xt_prev (read before it is overwritten), clip
        const size_t q1 = (size_t)i * D1 + n + j;
        const T rX = sX * T(2) * (w1[q1] - u1[q1]);
        const T cX = -sX * p.maskA[f];
        T rx[KR], rs = 0;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T RX = rho * (rX + gx[t]) - cX;
          rx[t] = quot(RX, rho) + (sX * sX) * Xt[(size_t)t * nm + f];
          rs = t == 0 ? rx[0] : rs + rx[t];
        }
        const T d = D1x[f], e1 = c1x[f];
        const T corr = quot(e1 * rs, d * (d + T(K) * e1));
        T xs = 0;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T z = fmin(fmax(quot(rx[t], d) - corr, -R_Xs), R_Xs);
          Xt[(size_t)t * nm + f] = z;
          xs = t == 0 ? z : xs + z;
        }
        Xs[f] = xs;
        const T zW = quot(quot(rho * gw - (T(0.5) * sW) * p.mask[f], rho), D1w[f]);
        csum += zW;
        // the W-link row at the uncorrected values:
        // q_c = cdm sS (W_c - sum_t Wt - 2 sum_p H)
        T qc = 0;
        if (c >= 0) {
          T sw = zWt[0], sh = zH[0];
#pragma unroll
          for (int t = 1; t < K; ++t) sw += zWt[t];
#pragma unroll
          for (int q = 1; q < KP; ++q) sh += zH[q];
          qc = (cdm[c] * sS) * (zW - sw - T(2) * sh);
          bsum += B_jc[c] * quot(qc, D_c[c]);
        }
        KEPT(fW, i) = zW;
        KEPT(fQ, i) = qc;
        KEPT(fC, i) = int_in(T(0), c);
#pragma unroll
        for (int t = 0; t < K; ++t) KEPT(fWt + t, i) = zWt[t];
#pragma unroll
        for (int q = 0; q < KP; ++q) KEPT(fH + q, i) = zH[q];
      } else {
        const int c = flat_coord[f], s = flat_soc[f];
        T cm = 0, ywl = 0, sw = 0, sh = 0, y2 = 0;
        size_t qx = 0;
        int e0 = 0, e1 = 0;
        if (c >= 0) {
          cm = cdm[c];
          qx = (size_t)c * DD;
          e0 = fm_ptr[f], e1 = fm_ptr[f + 1];
          // W-link row: -ywl on Wt, -2 ywl on H; the H pairs
          ywl = (sS * (wwl[c] - uwl[c])) * cm;
          int qp = 0;
          for (int t1 = 0; t1 < K; ++t1)
            for (int t2 = t1 + 1; t2 < K; ++t2, ++qp) {
              const size_t qa = qx + (t1 + 1) * D + t2 + 1, qb = qx + (t2 + 1) * D + t1 + 1;
              T gh = (sS * (wx[qa] - ux[qa])) * cm + (sS * (wx[qb] - ux[qb])) * cm;
              gh = gh - T(2) * ywl;
              const T zH = quot(quot(rho * gh, rho), D1h[c]);
              KEPT(fH + qp, i) = zH;
              sh = qp == 0 ? zH : sh + zH;
            }
        }
        // RSOC row (0.5, W, sum_t Xt): its X slot lands on every term
        T gw = 0;
        if (s >= 0) {
          const T sm_ = socm[s];
          gw += (sS * (wr[3 * s + 1] - ur[3 * s + 1])) * sm_;
          y2 = (sS * (wr[3 * s + 2] - ur[3 * s + 2])) * sm_;
        }
        gw += ywl;
        gw = gw - sW * yl;
        const size_t qe = (size_t)b * nm + f;
        gw = gw + sS * (p.wp[qe] - p.up[qe]);

        // X block: (D1x I_k + c1x J_k)^-1 by Sherman-Morrison, proximal term
        // tau_x Xt_prev, clip.  Pass 1: each term's Wt (kept) and its X
        // right-hand side, summed over the terms in order
        const size_t q1 = (size_t)i * D1 + n + j;
        const T rX = sX * T(2) * (w1[q1] - u1[q1]);
        const T cX = -sX * p.maskA[f];
        T rs = 0;
        for (int t = 0; t < K; ++t) {
          T gx = 0, gwt = 0;
          for (int e = e0; e < e1; ++e) {
            const int ent = fm_ent[e], l = ent >> 2, cc = (ent & 3) + 1;
            const size_t q = ((size_t)l * K + t) * 25;
            gx += T(2) * (sS * (w5[q + cc] - u5[q + cc]));
            gwt += sS * (w5[q + cc * 6] - u5[q + cc * 6]);
          }
          if (c >= 0) {
            gx += T(2) * ((sS * (wx[qx + t + 1] - ux[qx + t + 1])) * cm);
            const size_t qd = qx + (t + 1) * (D + 1);
            gwt = gwt + (sS * (wx[qd] - ux[qd])) * cm;
            gwt = gwt - ywl;
            gwt = gwt + sS * (wq[(size_t)t * C + c] - uq[(size_t)t * C + c]);
            const T zWt = quot(quot(rho * gwt, rho), D1wt[c]);
            KEPT(fWt + t, i) = zWt;
            sw = t == 0 ? zWt : sw + zWt;
          }
          if (s >= 0) gx += y2;
          const T rx = quot(rho * (rX + gx) - cX, rho) + (sX * sX) * Xt[(size_t)t * nm + f];
          rs = t == 0 ? rx : rs + rx;
        }
        const T d = D1x[f], ex = c1x[f];
        const T corr = quot(ex * rs, d * (d + T(K) * ex));
        // pass 2: each term's right-hand side again, its solve and clip
        T xs = 0;
        for (int t = 0; t < K; ++t) {
          T gx = 0;
          for (int e = e0; e < e1; ++e) {
            const int ent = fm_ent[e], l = ent >> 2, cc = (ent & 3) + 1;
            const size_t q = ((size_t)l * K + t) * 25;
            gx += T(2) * (sS * (w5[q + cc] - u5[q + cc]));
          }
          if (c >= 0) gx += T(2) * ((sS * (wx[qx + t + 1] - ux[qx + t + 1])) * cm);
          if (s >= 0) gx += y2;
          const T rx = quot(rho * (rX + gx) - cX, rho) + (sX * sX) * Xt[(size_t)t * nm + f];
          const T z = fmin(fmax(quot(rx, d) - corr, -R_Xs), R_Xs);
          Xt[(size_t)t * nm + f] = z;
          xs = t == 0 ? z : xs + z;
        }
        Xs[f] = xs;
        const T zW = quot(quot(rho * gw - (T(0.5) * sW) * p.mask[f], rho), D1w[f]);
        csum += zW;
        // the W-link row at the uncorrected values:
        // q_c = cdm sS (W_c - sum_t Wt - 2 sum_p H)
        T qc = 0;
        if (c >= 0) {
          qc = (cm * sS) * (zW - sw - T(2) * sh);
          bsum += B_jc[c] * quot(qc, D_c[c]);
        }
        KEPT(fW, i) = zW;
        KEPT(fQ, i) = qc;
        KEPT(fC, i) = int_in(T(0), c);
      }
    }
  }
  part[rg * cols + col] = csum;
  part[(RG + rg) * cols + col] = bsum;
  __syncthreads();

  // ---- per column, row groups in order: Theta's diagonal and a_j ----
  if (rg == 0 && live) {
    T sw = 0, bq = 0;
    for (int r = 0; r < RG; ++r) sw += part[r * cols + col];
    for (int r = 0; r < RG; ++r) bq += part[(RG + r) * cols + col];
    const size_t qd = (size_t)(n + j) * D1 + n + j;
    const T RT = rho * (sT * (w1[qd] - u1[qd]) + sT * yl) - quot(sT * T(0.5), p.gamma);
    const T zTh = quot(RT, rho * sT * sT);
    const T pj = sT * zTh - sW * sw;
    const T a = quot(pj - bq, p.S_th[b * m + j]);
    Ths[(size_t)j * m + j] = zTh - quot(a, sT);
    a_s[col] = a;
  }
  __syncthreads();

  // ---- per entry: link corrections of W, Wt, H; Theta off the diagonal ----
  if (live) {
    const T a = a_s[col];
    for (int i = rg; i < n; i += RG) {
      const int f = i * m + j;
      T zW = KEPT(fW, i) - quot((-sW) * a, D1w[f]);
      const int c = int_of(KEPT(fC, i));
      if (c >= 0) {
        const T cm = cdm[c];
        const T bc = quot(KEPT(fQ, i) - B_jc[c] * a, D_c[c]);
        zW = zW + quot(-((sS * bc) * cm), D1w[f]);
#pragma unroll
        for (int t = 0; t < K; ++t)
          Wt[(size_t)t * C + c] = KEPT(fWt + t, i) - quot((-(sS * bc)) * cm, D1wt[c]);
#pragma unroll
        for (int q = 0; q < KP; ++q)
          Hh[(size_t)q * C + c] = KEPT(fH + q, i) - quot(((-(T(2) * sS)) * bc) * cm, D1h[c]);
      }
      Ws[f] = zW;
    }
    for (int i = rg; i < m; i += RG) {
      if (i == j) continue;
      const size_t qa = (size_t)(n + i) * D1 + n + j;
      const T za = quot(rho * (sT * (w1[qa] - u1[qa])), rho * sT * sT);
      T zt;
      if constexpr (kWide) {
        const size_t qt = (size_t)(n + j) * D1 + n + i;
        zt = quot(rho * (sT * (w1[qt] - u1[qt])), rho * sT * sT);
      } else {
        zt = thb[col * (m + 1) + i];
      }
      Ths[(size_t)i * m + j] = T(0.5) * (za + zt);
    }
  }
#undef KEPT

  // ---- strided over the slot's CTAs: padded coordinates, v1 | v2 | v3,
  // one item a coordinate or v entry with its k terms (one table walk in
  // the register kernels, one a term in the wide one) ----
  const int P1 = p.P1, P2 = p.P2, P3 = p.P3;
  for (int e = blockIdx.x * blockDim.x + tid; e < C + P1 + P2 + P3;
       e += gridDim.x * blockDim.x) {
    if (e < C) {
      // a padded coordinate carries only its Wt >= 0 slot (H = 0)
      if (cdm[e] != T(0)) continue;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const T g = sS * (wq[(size_t)t * C + e] - uq[(size_t)t * C + e]);
        Wt[(size_t)t * C + e] = quot(quot(rho * g, rho), D1wt[e]);
      }
#pragma unroll
      for (int q = 0; q < KP; ++q) Hh[(size_t)q * C + e] = T(0);
      continue;
    }
    // v1 entry 2 l + c reads (1, 2) (c = 0) or (3, 4) of minor l, v2 (1, 3)
    // or (2, 4), v3 entry l (1, 4) + (2, 3)
    const int r = e - C, kind = r < P1 ? 1 : r < P1 + P2 ? 2 : 3;
    const int v = kind == 1 ? r : kind == 2 ? r - P1 : r - P1 - P2;
    const int P = kind == 1 ? P1 : kind == 2 ? P2 : P3;
    const int* __restrict__ ptr = (kind == 1 ? p.v1_ptr : kind == 2 ? p.v2_ptr : p.v3_ptr) +
                                  (size_t)b * (P + 1);
    const int* __restrict__ ent = kind == 1 ? p.v1_ent + (size_t)b * 2 * p.M5
                                : kind == 2 ? p.v2_ent + (size_t)b * 2 * p.M5
                                            : p.v3_ent + (size_t)b * p.M5;
    if constexpr (!kWide) {
      T g[KR];
#pragma unroll
      for (int t = 0; t < K; ++t) g[t] = T(0);
      for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
        const int en = ent[h], l = kind == 3 ? en : en >> 1;
        const int o = kind == 1 ? ((en & 1) ? 19 : 7) : ((en & 1) ? 14 : 8);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const size_t q = ((size_t)l * K + t) * 25;
          g[t] += kind == 3
                      ? T(2) * (sS * (w5[q + 9] - u5[q + 9]) + sS * (w5[q + 13] - u5[q + 13]))
                      : T(2) * (sS * (w5[q + o] - u5[q + o]));
        }
      }
      const T dv = (kind == 1 ? p.D1v1 : kind == 2 ? p.D1v2 : p.D1v3)[(size_t)b * P + v];
      T* out = (kind == 1 ? p.v1 : kind == 2 ? p.v2 : p.v3) + (size_t)b * K * P + v;
#pragma unroll
      for (int t = 0; t < K; ++t) out[(size_t)t * P] = quot(quot(rho * g[t], rho), dv);
    } else {
      const T dv = (kind == 1 ? p.D1v1 : kind == 2 ? p.D1v2 : p.D1v3)[(size_t)b * P + v];
      T* out = (kind == 1 ? p.v1 : kind == 2 ? p.v2 : p.v3) + (size_t)b * K * P + v;
      for (int t = 0; t < K; ++t) {
        T g = 0;
        for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
          const int en = ent[h], l = kind == 3 ? en : en >> 1;
          const int o = kind == 1 ? ((en & 1) ? 19 : 7) : ((en & 1) ? 14 : 8);
          const size_t q = ((size_t)l * K + t) * 25;
          g += kind == 3 ? T(2) * (sS * (w5[q + 9] - u5[q + 9]) + sS * (w5[q + 13] - u5[q + 13]))
                         : T(2) * (sS * (w5[q + o] - u5[q + o]));
        }
        out[(size_t)t * P] = quot(quot(rho * g, rho), dv);
      }
    }
  }
}

// K8d's CTA (every kind); its link CTAs are omc::link_rows's
constexpr int kThreads8d = 128;
static_assert(kThreads8d == omc::kLinkCols * omc::kLinkRows, "a link CTA is 32 x 4 threads");

struct K8dLayout {
  int links, nonneg, rsoc, coords, grid_x;
};

// E = 16 / elem consecutive W >= 0 entries or RSOC rows a thread (quads;
// pairs in the float64 build), ipc of them (or coordinates) a flat CTA
__host__ __device__ __forceinline__ K8dLayout k8d_layout(int B, int n, int m, int C, int Ms,
                                                         int ipc, int E) {
  K8dLayout l;
  l.links = B * omc::cdiv(m, omc::kLinkCols);
  l.nonneg = omc::cdiv(omc::cdiv(B * n * m, E), ipc);
  l.rsoc = omc::cdiv(omc::cdiv(B * Ms, E), ipc);
  l.coords = omc::cdiv(B * C, ipc);
  l.grid_x = l.links + l.nonneg + l.rsoc + l.coords;
  return l;
}

using omc::lane4;

// E consecutive int32 table entries (E = 4: one 16-byte word, E = 2: one
// 8-byte word)
template <int E>
struct IntVec;
template <>
struct IntVec<4> {
  using V = int4;
};
template <>
struct IntVec<2> {
  using V = int2;
};
__device__ __forceinline__ int& lane_i(int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ int& lane_i(int2& v, int c) { return c == 0 ? v.x : v.y; }

// (w): the W >= 0 slots of the groups [quad0, quad0 + ipc) of E = 16 /
// sizeof(T) consecutive entries of the batch's flat B n m (quads of floats,
// pairs of doubles), a group a thread in 16-byte words (fewer at the ragged
// end; a group spans at most two slots, n m >= 4)
template <class T>
__device__ __forceinline__ void k8d_nonneg(const K8dParamsT<T>& p, int quad0) {
  using V = omc::Vec16<T>;
  constexpr int E = 16 / sizeof(T);
  const T* __restrict__ W = p.Ws;
  T* __restrict__ wp = p.wp;
  T* __restrict__ up = p.up;
  const int nm = p.n * p.m, tot = p.B * nm;
  const int q0 = E * (quad0 + (int)threadIdx.x);
  if ((int)threadIdx.x >= p.ipc || q0 >= tot) return;
  const int rem = min(E, tot - q0);
  const int b0 = q0 / nm, b1 = min(b0 + 1, p.B - 1), bnd = (b0 + 1) * nm;
  const T sS0 = __ldg(p.sS + b0), sS1 = __ldg(p.sS + b1);
  V w4 = {}, p4 = {}, u4 = {};
  if (rem == E) {
    w4 = __ldg(reinterpret_cast<const V*>(W + q0));
    p4 = *reinterpret_cast<const V*>(wp + q0);
    u4 = *reinterpret_cast<const V*>(up + q0);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < rem) lane4(w4, e) = W[q0 + e], lane4(p4, e) = wp[q0 + e], lane4(u4, e) = up[q0 + e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e < rem) omc::nonneg_slot(lane4(w4, e), q0 + e >= bnd ? sS1 : sS0, p.alpha,
                                  lane4(p4, e), lane4(u4, e));
  if (rem == E) {
    *reinterpret_cast<V*>(wp + q0) = p4;
    *reinterpret_cast<V*>(up + q0) = u4;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < rem) wp[q0 + e] = lane4(p4, e), up[q0 + e] = lane4(u4, e);
  }
}

// (r): the RSOC rows of the groups [quad0, quad0 + ipc) of E consecutive
// rows of the batch's flat B Ms (quads; pairs in the float64 build), a group
// a thread, a warp 32 groups: a group's entries (soc_flat) and masks are
// one word each, then the rows' W and X are gathered; the warp's triples of
// wr, ur and acc_r are staged through its shared memory (omc::triples_in),
// each lane's loads issued before any store (a group spans at most two
// slots, Ms >= 4)
template <class T>
__device__ __forceinline__ void k8d_rsoc(const K8dParamsT<T>& p, int quad0) {
  using V = omc::Vec16<T>;
  constexpr int E = 16 / sizeof(T);
  using IV = typename IntVec<E>::V;
  __shared__ V k8d_smem[3 * 3 * 32 * (kThreads8d / 32)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* __restrict__ X = p.Xs;
  const T* __restrict__ W = p.Ws;
  const int* __restrict__ F = p.soc_flat;
  const T* __restrict__ M = p.soc_mask;
  const int nm = p.n * p.m, Ms = p.Ms, tot = p.B * Ms;
  const int c0 = E * (quad0 + 32 * warp);  // the warp's first row
  if (32 * warp >= p.ipc || c0 >= tot) return;
  const int cnt = min(32 * E, tot - c0);
  const size_t off = 3 * (size_t)c0;
  V* s = k8d_smem + 3 * 3 * 32 * warp;
  const int q0 = c0 + E * lane;
  const int rem = q0 < tot ? min(E, tot - q0) : 0;
  const int b0 = rem > 0 ? q0 / Ms : 0, b1 = min(b0 + 1, p.B - 1), bnd = (b0 + 1) * Ms;
  const T sS0 = __ldg(p.sS + b0), rho0 = __ldg(p.rho + b0);
  const T sS1 = __ldg(p.sS + b1), rho1 = __ldg(p.rho + b1);
  IV f4 = {};
  V m4 = {};
  if (rem == E) {
    f4 = __ldg(reinterpret_cast<const IV*>(F + q0));
    m4 = __ldg(reinterpret_cast<const V*>(M + q0));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < rem) {
        lane_i(f4, e) = F[q0 + e];
        lane4(m4, e) = M[q0 + e];
      }
  }
  T x[E] = {}, w[E] = {};
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e < rem) {
      const size_t q = (size_t)(q0 + e >= bnd ? b1 : b0) * nm + lane_i(f4, e);
      x[e] = __ldg(X + q), w[e] = __ldg(W + q);
    }
  omc::triples_in(p.wr, p.ur, p.acc_r, off, 3 * cnt, s, lane);
  __syncwarp();
  if (rem > 0)
    omc::triples_update(s, lane, rem, [&](int e, T (&r)[3], T (&u)[3], T (&a)[3]) {
      const bool hi = q0 + e >= bnd;
      omc::rsoc_row(x[e], w[e], lane4(m4, e), hi ? sS1 : sS0, hi ? rho1 : rho0, p.alpha, p.beta,
                    r, u, a);
    });
  __syncwarp();
  omc::triples_out(p.wr, p.ur, p.acc_r, off, 3 * cnt, s, lane);
}

// (c): the coordinates [g0, g0 + ipc) of the batch's flat B C, one a
// thread: its W-link row (a zero cone: W_c - sum_t Wt - 2 sum_p H, masked)
// and its K Wt >= 0 slots, so that Wt and H are read once
template <int K, class T>
__device__ __forceinline__ void k8d_coords(const K8dParamsT<T>& p, int g0) {
  constexpr int KP = K * (K - 1) / 2;
  const int g = g0 + threadIdx.x, C = p.C;
  if ((int)threadIdx.x >= p.ipc || g >= p.B * C) return;
  const int b = g / C, c = g - b * C;
  const size_t q = (size_t)b * K * C + c;  // term 0 of the (B, K, C) arrays
  const T* __restrict__ Wt = p.Wt;
  const T* __restrict__ Hh = p.Hh + (size_t)b * KP * C + c;
  T* __restrict__ wq = p.wq;
  T* __restrict__ uq = p.uq;
  const int fc = __ldg(p.coord_flat + g);
  const T cm = __ldg(p.coord_mask + g), uwl = p.uwl[g], awl = p.acc_wl[g];
  const T sS = __ldg(p.sS + b), rho = __ldg(p.rho + b);
  T wt[K], pq[K], vq[K], h[KP];
#pragma unroll
  for (int t = 0; t < K; ++t)
    wt[t] = __ldg(Wt + q + (size_t)t * C), pq[t] = wq[q + (size_t)t * C], vq[t] = uq[q + (size_t)t * C];
#pragma unroll
  for (int r = 0; r < KP; ++r) h[r] = __ldg(Hh + (size_t)r * C);
  const T w = __ldg(p.Ws + (size_t)b * p.n * p.m + fc);
  T sw = wt[0], sh = h[0];
#pragma unroll
  for (int t = 1; t < K; ++t) sw += wt[t];
#pragma unroll
  for (int r = 1; r < KP; ++r) sh += h[r];
  const T fwl = (sS * (w - sw - T(2) * sh)) * cm;
  const T tw = (p.alpha * fwl + uwl) * cm;
  p.wwl[g] = T(0);
  p.uwl[g] = tw;
  p.acc_wl[g] = awl + p.beta * (rho * tw - awl);
#pragma unroll
  for (int t = 0; t < K; ++t) {
    omc::nonneg_slot(wt[t], sS, p.alpha, pq[t], vq[t]);
    wq[q + (size_t)t * C] = pq[t];
    uq[q + (size_t)t * C] = vq[t];
  }
}

// (c) of the wide kernel (any k): the same row and slots with the rank a
// run-time value; Sum_t Wt and Sum_p H streamed in the register kernel's
// order, then each term's Wt >= 0 slot in turn (its Wt read again), so no
// per-term array lives in registers (the loops not unrolled: unrolled, the
// float64 build spilled)
template <class T>
__device__ __forceinline__ void k8d_coords_wide(const K8dParamsT<T>& p, int g0) {
  const int K = p.k, KP = K * (K - 1) / 2;
  const int g = g0 + threadIdx.x, C = p.C;
  if ((int)threadIdx.x >= p.ipc || g >= p.B * C) return;
  const int b = g / C, c = g - b * C;
  const size_t q = (size_t)b * K * C + c;  // term 0 of the (B, K, C) arrays
  const T* __restrict__ Wt = p.Wt;
  const T* __restrict__ Hh = p.Hh + (size_t)b * KP * C + c;
  T* __restrict__ wq = p.wq;
  T* __restrict__ uq = p.uq;
  const int fc = __ldg(p.coord_flat + g);
  const T cm = __ldg(p.coord_mask + g), uwl = p.uwl[g], awl = p.acc_wl[g];
  const T sS = __ldg(p.sS + b), rho = __ldg(p.rho + b);
  const T w = __ldg(p.Ws + (size_t)b * p.n * p.m + fc);
  T sw = __ldg(Wt + q), sh = KP > 0 ? __ldg(Hh) : T(0);
#pragma unroll 1
  for (int t = 1; t < K; ++t) sw += __ldg(Wt + q + (size_t)t * C);
#pragma unroll 1
  for (int r = 1; r < KP; ++r) sh += __ldg(Hh + (size_t)r * C);
  const T fwl = (sS * (w - sw - T(2) * sh)) * cm;
  const T tw = (p.alpha * fwl + uwl) * cm;
  p.wwl[g] = T(0);
  p.uwl[g] = tw;
  p.acc_wl[g] = awl + p.beta * (rho * tw - awl);
#pragma unroll 1
  for (int t = 0; t < K; ++t) {
    const size_t qt = q + (size_t)t * C;
    T pq = wq[qt], vq = uq[qt];
    omc::nonneg_slot(__ldg(Wt + qt), sS, p.alpha, pq, vq);
    wq[qt] = pq;
    uq[qt] = vq;
  }
}

// one dimension: the link CTAs, then the W >= 0, RSOC and coordinates' CTAs
// (k8d_layout; omc_torch.sdp.shor_k.k8d_plan); K = 0: the wide kernel
// (k8d_coords_wide)
template <int K, class T>
__global__ void __launch_bounds__(kThreads8d) k8d_kernel(K8dParamsT<T> p) {
  const K8dLayout l = k8d_layout(p.B, p.n, p.m, p.C, p.Ms, p.ipc, 16 / sizeof(T));
  int x = blockIdx.x;
  if (x < l.links) {
    const int tiles = omc::cdiv(p.m, omc::kLinkCols);
    omc::link_rows(p, x / tiles, x % tiles);
    return;
  }
  x -= l.links;
  if (x < l.nonneg) {
    k8d_nonneg(p, x * p.ipc);
    return;
  }
  x -= l.nonneg;
  if (x < l.rsoc) {
    k8d_rsoc(p, x * p.ipc);
    return;
  }
  if constexpr (K == 0)
    k8d_coords_wide(p, (x - l.rsoc) * p.ipc);
  else
    k8d_coords<K>(p, (x - l.rsoc) * p.ipc);
}

template <int K, class T>
int launch_k8c(const K8cParamsT<T>& p, void* stream) {
  const size_t smem = sizeof(T) * k8c_smem_values(p.n, p.m, K, p.cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k8c_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.B > 0 && p.m > 0) {
    const dim3 grid((p.m + p.cols - 1) / p.cols, p.B);
    k8c_kernel<K, T><<<grid, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <class T>
int k8c_launch(const K8cParamsT<T>& p, void* stream) {
  // a tile is a power of two of at most 32 columns (whole row groups)
  const int cols = p.cols;
  if (cols < 1 || cols > kCols || (cols & (cols - 1))) return (int)cudaErrorInvalidValue;
  switch (p.k) {
    case 2: return launch_k8c<2>(p, stream);
    case 3: return launch_k8c<3>(p, stream);
    case 4: return launch_k8c<4>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int k8c_wide_launch(const K8cParamsT<T>& p, void* stream) {
  // a tile is a power of two of at most 32 columns (whole row groups)
  const int cols = p.cols;
  if (p.k < 1 || cols < 1 || cols > kCols || (cols & (cols - 1))) return (int)cudaErrorInvalidValue;
  const long long smem = sizeof(T) * k8c_wide_smem_values(p.n, p.k, cols, p.ws != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k8c_kernel<0, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.B > 0 && p.m > 0) {
    const dim3 grid((p.m + cols - 1) / cols, p.B);
    k8c_kernel<0, T><<<grid, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// wide: K8d's wide kernel (any k >= 1), else the register kernels (2..4)
template <class T>
int k8d_launch(const K8dParamsT<T>& p, void* stream, bool wide = false) {
  // W, wp, up, the RSOC triples, soc_flat and soc_mask move as 16-byte words
  const auto odd = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (p.B < 1 || p.n < 1 || p.m < 1 || p.n * p.m < 4 || p.C < 1 || p.Ms < 4 || p.ipc < 32 ||
      p.ipc > kThreads8d || p.ipc % 32 || odd(p.Ws) || odd(p.wp) || odd(p.up) || odd(p.wr) ||
      odd(p.ur) || odd(p.acc_r) || odd(p.soc_flat) || odd(p.soc_mask))
    return (int)cudaErrorInvalidValue;
  const int grid = k8d_layout(p.B, p.n, p.m, p.C, p.Ms, p.ipc, 16 / (int)sizeof(T)).grid_x;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    if (p.k < 1) return (int)cudaErrorInvalidValue;
    k8d_kernel<0, T><<<grid, kThreads8d, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  switch (p.k) {
    case 2: k8d_kernel<2, T><<<grid, kThreads8d, 0, s>>>(p); break;
    case 3: k8d_kernel<3, T><<<grid, kThreads8d, 0, s>>>(p); break;
    case 4: k8d_kernel<4, T><<<grid, kThreads8d, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

OMC_EXPORT int omc_k8c_shor_k_zstep(const K8cParams* params, void* stream) {
  return k8c_launch(*params, stream);
}

OMC_EXPORT int omc_k8c_shor_k_zstep_f64(const K8cParamsT<double>* params, void* stream) {
  return k8c_launch(*params, stream);
}

// the wide kernel (any k; the kept values in shared memory, or in p.ws)
OMC_EXPORT int omc_k8c_shor_k_zstep_wide(const K8cParams* params, void* stream) {
  return k8c_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k8c_shor_k_zstep_wide_f64(const K8cParamsT<double>* params, void* stream) {
  return k8c_wide_launch(*params, stream);
}

// the wide kernel's shared memory for a tile of `cols` columns, the kept
// values in the workspace (global != 0) or not, at elem bytes a value; held
// against sdp.shor_k.k8c_plan by the smoke
OMC_EXPORT long long omc_k8c_wide_smem_bytes(int n, int k, int cols, int global, int elem) {
  return (long long)elem * k8c_wide_smem_values(n, k, cols, global != 0);
}

// K8c's shared memory for a tile of `cols` columns at elem bytes a value
// (4, or 8 in the float64 build), held against sdp.shor_k.k8c_plan by the
// smoke
OMC_EXPORT long long omc_k8c_smem_bytes(int n, int m, int k, int cols, int elem) {
  return (long long)elem * k8c_smem_values(n, m, k, cols);
}

// K8d's grid width at elem bytes a value (omc_torch.sdp.shor_k.k8d_plan
// plans with it; chip_smoke.py holds the plan against it)
OMC_EXPORT int omc_k8d_grid_x(int B, int n, int m, int C, int Ms, int ipc, int elem) {
  return k8d_layout(B, n, m, C, Ms, ipc, 16 / elem).grid_x;
}

OMC_EXPORT int omc_k8d_shor_k_cone(const K8dParams* params, void* stream) {
  return k8d_launch(*params, stream);
}

OMC_EXPORT int omc_k8d_shor_k_cone_f64(const K8dParamsT<double>* params, void* stream) {
  return k8d_launch(*params, stream);
}

// the wide kernel: the coordinates' CTAs at a run-time rank (any k)
OMC_EXPORT int omc_k8d_shor_k_cone_wide(const K8dParams* params, void* stream) {
  return k8d_launch(*params, stream, true);
}

OMC_EXPORT int omc_k8d_shor_k_cone_wide_f64(const K8dParamsT<double>* params, void* stream) {
  return k8d_launch(*params, stream, true);
}
