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
// visit.  K8d keeps one CTA per (slot, 32 columns), 8 row groups.
#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kRows = omc::kThreads / kCols;  // 8

// K8c's dynamic shared memory (floats): the kept per-entry values
// (W, q_c, c, Wt, H: k + k(k-1)/2 + 3 fields of n x cols), two column sums
// per row group, a_j, and Theta's staged block rows (cols x (m + 1))
__host__ __device__ inline int k8c_smem_floats(int n, int m, int k, int cols) {
  const int nf = k + k * (k - 1) / 2 + 3, rg = omc::kThreads / cols;
  return nf * n * cols + 2 * rg * cols + cols + cols * (m + 1);
}

// (one CTA an SM at least: ptxas may then give k = 4 the registers it needs)
template <int K>
__global__ void __launch_bounds__(omc::kThreads, 1) k8c_kernel(K8cParams p) {
  constexpr int KP = K * (K - 1) / 2;
  constexpr int D = K + 1, DD = D * D;
  // fields of the kept per-entry values
  constexpr int fW = 0, fQ = 1, fC = 2, fWt = 3, fH = 3 + K, NF = 3 + K + KP;
  extern __shared__ __align__(16) float sm[];
  const int cols = p.cols, RG = omc::kThreads / cols;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int col = tid % cols, rg = tid / cols;
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m, C = p.C;
  const int j0 = blockIdx.x * cols, j = j0 + col;
  const bool live = j < m;
  float* kept = sm;                            // [NF][n][cols]
  float* part = kept + NF * n * cols;          // [2][RG][cols]
  float* a_s = part + 2 * RG * cols;           // [cols]
  float* thb = a_s + cols;                     // [cols][m + 1]
#define KEPT(fld, i) kept[((fld) * n + (i)) * cols + col]
  const float rho = p.rho[b], sX = p.sX[b], sT = p.sT[b], sS = p.sS[b];
  const float sW = sX * sX;
  const float* __restrict__ w1 = p.w1 + (size_t)b * D1 * D1;
  const float* __restrict__ u1 = p.u1 + (size_t)b * D1 * D1;
  const float* __restrict__ w5 = p.w5 + (size_t)b * p.M5 * K * 25;
  const float* __restrict__ u5 = p.u5 + (size_t)b * p.M5 * K * 25;
  const float* __restrict__ wx = p.wx + (size_t)b * C * DD;
  const float* __restrict__ ux = p.ux + (size_t)b * C * DD;
  const float* __restrict__ wr = p.wr + (size_t)b * p.Ms * 3;
  const float* __restrict__ ur = p.ur + (size_t)b * p.Ms * 3;
  const float* __restrict__ socm = p.soc_mask + (size_t)b * p.Ms;
  const float* __restrict__ cdm = p.coord_mask + (size_t)b * C;
  const float* __restrict__ wwl = p.wwl + (size_t)b * C;
  const float* __restrict__ uwl = p.uwl + (size_t)b * C;
  const float* __restrict__ wq = p.wq + (size_t)b * K * C;
  const float* __restrict__ uq = p.uq + (size_t)b * K * C;
  const int* __restrict__ fm_ptr = p.fm_ptr + (size_t)b * (nm + 1);
  const int* __restrict__ fm_ent = p.fm_ent + (size_t)b * 4 * p.M5;
  const int* __restrict__ flat_coord = p.flat_coord + (size_t)b * nm;
  const int* __restrict__ flat_soc = p.flat_soc + (size_t)b * nm;
  const float* __restrict__ D1x = p.D1x + (size_t)b * nm;
  const float* __restrict__ c1x = p.c1x + (size_t)b * nm;
  const float* __restrict__ D1w = p.D1w + (size_t)b * nm;
  const float* __restrict__ D1wt = p.D1wt + (size_t)b * C;
  const float* __restrict__ D1h = p.D1h + (size_t)b * C;
  const float* __restrict__ D_c = p.D_c + (size_t)b * C;
  const float* __restrict__ B_jc = p.B_jc + (size_t)b * C;
  float* __restrict__ Xt = p.Xt + (size_t)b * K * nm;
  float* __restrict__ Xs = p.Xs + (size_t)b * nm;
  float* __restrict__ Ws = p.Ws + (size_t)b * nm;
  float* __restrict__ Wt = p.Wt + (size_t)b * K * C;
  float* __restrict__ Hh = p.Hh + (size_t)b * KP * C;
  float* __restrict__ Ths = p.Ths + (size_t)b * m * m;
  const float R_Xs = p.R_X / sX;
  const float yl = live ? p.wl[b * m + j] - p.ul[b * m + j] : 0.f;

  // ---- Theta's block rows n + j0 .. n + j0 + cols - 1, read along rows ----
  for (int e = tid; e < cols * m; e += omc::kThreads) {
    const int cl = e / m, i = e - cl * m;
    if (j0 + cl < m) {
      const int qb = (n + j0 + cl) * D1 + n + i;
      thb[cl * (m + 1) + i] = (rho * (sT * (w1[qb] - u1[qb]))) / (rho * sT * sT);
    }
  }

  // ---- per entry: adjoint, X solve, uncorrected W / Wt / H, q_c ----
  float csum = 0.f, bsum = 0.f;
  if (live) {
    for (int i = rg; i < n; i += RG) {
      const int f = i * m + j;
      float gx[K], zWt[K], zH[KP];
#pragma unroll
      for (int t = 0; t < K; ++t) gx[t] = 0.f, zWt[t] = 0.f;
#pragma unroll
      for (int q = 0; q < KP; ++q) zH[q] = 0.f;
      float gw = 0.f, ywl = 0.f;
      const int c = flat_coord[f];
      if (c >= 0) {
        const float cm = cdm[c];
        float gwt[K], gh[KP];
#pragma unroll
        for (int t = 0; t < K; ++t) gwt[t] = 0.f;
        // per-term 5x5 minor duals of the entry's minors: (0, cc), (cc, cc)
        const int e1 = fm_ptr[f + 1];
        for (int e = fm_ptr[f]; e < e1; ++e) {
          const int ent = fm_ent[e], l = ent >> 2, cc = (ent & 3) + 1;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const size_t q = ((size_t)l * K + t) * 25;
            gx[t] += 2.0f * (sS * (w5[q + cc] - u5[q + cc]));
            gwt[t] += sS * (w5[q + cc * 6] - u5[q + cc * 6]);
          }
        }
        // XWH duals of this coordinate
        const size_t qx = (size_t)c * DD;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          gx[t] += 2.0f * ((sS * (wx[qx + t + 1] - ux[qx + t + 1])) * cm);
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
          zWt[t] = ((rho * gwt[t]) / rho) / D1wt[c];
        }
#pragma unroll
        for (int q = 0; q < KP; ++q) {
          gh[q] = gh[q] - 2.0f * ywl;
          zH[q] = ((rho * gh[q]) / rho) / D1h[c];
        }
      }
      // RSOC row (0.5, W, sum_t Xt): its X slot lands on every term
      const int s = flat_soc[f];
      if (s >= 0) {
        const float sm_ = socm[s];
        gw += (sS * (wr[3 * s + 1] - ur[3 * s + 1])) * sm_;
        const float y2 = (sS * (wr[3 * s + 2] - ur[3 * s + 2])) * sm_;
#pragma unroll
        for (int t = 0; t < K; ++t) gx[t] += y2;
      }
      gw += ywl;
      gw = gw - sW * yl;
      const size_t qe = (size_t)b * nm + f;
      gw = gw + sS * (p.wp[qe] - p.up[qe]);

      // X block: (D1x I_k + c1x J_k)^-1 by Sherman-Morrison, proximal term
      // tau_x Xt_prev (read before it is overwritten), clip
      const int q1 = i * D1 + n + j;
      const float rX = sX * 2.0f * (w1[q1] - u1[q1]);
      const float cX = -sX * p.maskA[f];
      float rx[K], rs = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float RX = rho * (rX + gx[t]) - cX;
        rx[t] = RX / rho + (sX * sX) * Xt[(size_t)t * nm + f];
        rs = t == 0 ? rx[0] : rs + rx[t];
      }
      const float d = D1x[f], e1 = c1x[f];
      const float corr = e1 * rs / (d * (d + (float)K * e1));
      float xs = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float z = fminf(fmaxf(rx[t] / d - corr, -R_Xs), R_Xs);
        Xt[(size_t)t * nm + f] = z;
        xs = t == 0 ? z : xs + z;
      }
      Xs[f] = xs;
      const float zW = ((rho * gw - (0.5f * sW) * p.mask[f]) / rho) / D1w[f];
      csum += zW;
      // the W-link row at the uncorrected values:
      // q_c = cdm sS (W_c - sum_t Wt - 2 sum_p H)
      float qc = 0.f;
      if (c >= 0) {
        float sw = zWt[0], sh = zH[0];
#pragma unroll
        for (int t = 1; t < K; ++t) sw += zWt[t];
#pragma unroll
        for (int q = 1; q < KP; ++q) sh += zH[q];
        qc = (cdm[c] * sS) * (zW - sw - 2.0f * sh);
        bsum += B_jc[c] * (qc / D_c[c]);
      }
      KEPT(fW, i) = zW;
      KEPT(fQ, i) = qc;
      KEPT(fC, i) = __int_as_float(c);
#pragma unroll
      for (int t = 0; t < K; ++t) KEPT(fWt + t, i) = zWt[t];
#pragma unroll
      for (int q = 0; q < KP; ++q) KEPT(fH + q, i) = zH[q];
    }
  }
  part[rg * cols + col] = csum;
  part[(RG + rg) * cols + col] = bsum;
  __syncthreads();

  // ---- per column, row groups in order: Theta's diagonal and a_j ----
  if (rg == 0 && live) {
    float sw = 0.f, bq = 0.f;
    for (int r = 0; r < RG; ++r) sw += part[r * cols + col];
    for (int r = 0; r < RG; ++r) bq += part[(RG + r) * cols + col];
    const int qd = (n + j) * D1 + n + j;
    const float RT = rho * (sT * (w1[qd] - u1[qd]) + sT * yl) - sT * 0.5f / p.gamma;
    const float zTh = RT / (rho * sT * sT);
    const float pj = sT * zTh - sW * sw;
    const float a = (pj - bq) / p.S_th[b * m + j];
    Ths[j * m + j] = zTh - a / sT;
    a_s[col] = a;
  }
  __syncthreads();

  // ---- per entry: link corrections of W, Wt, H; Theta off the diagonal ----
  if (live) {
    const float a = a_s[col];
    for (int i = rg; i < n; i += RG) {
      const int f = i * m + j;
      float zW = KEPT(fW, i) - ((-sW) * a) / D1w[f];
      const int c = __float_as_int(KEPT(fC, i));
      if (c >= 0) {
        const float cm = cdm[c];
        const float bc = (KEPT(fQ, i) - B_jc[c] * a) / D_c[c];
        zW = zW + (-((sS * bc) * cm)) / D1w[f];
#pragma unroll
        for (int t = 0; t < K; ++t)
          Wt[(size_t)t * C + c] = KEPT(fWt + t, i) - ((-(sS * bc)) * cm) / D1wt[c];
#pragma unroll
        for (int q = 0; q < KP; ++q)
          Hh[(size_t)q * C + c] = KEPT(fH + q, i) - (((-(2.0f * sS)) * bc) * cm) / D1h[c];
      }
      Ws[f] = zW;
    }
    for (int i = rg; i < m; i += RG) {
      if (i == j) continue;
      const int qa = (n + i) * D1 + n + j;
      const float za = (rho * (sT * (w1[qa] - u1[qa]))) / (rho * sT * sT);
      Ths[i * m + j] = 0.5f * (za + thb[col * (m + 1) + i]);
    }
  }
#undef KEPT

  // ---- strided over the slot's CTAs: padded coordinates, v1 | v2 | v3,
  // one item a coordinate or v entry with its k terms (one table walk) ----
  const int P1 = p.P1, P2 = p.P2, P3 = p.P3;
  for (int e = blockIdx.x * blockDim.x + tid; e < C + P1 + P2 + P3;
       e += gridDim.x * blockDim.x) {
    if (e < C) {
      // a padded coordinate carries only its Wt >= 0 slot (H = 0)
      if (cdm[e] != 0.f) continue;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float g = sS * (wq[(size_t)t * C + e] - uq[(size_t)t * C + e]);
        Wt[(size_t)t * C + e] = ((rho * g) / rho) / D1wt[e];
      }
#pragma unroll
      for (int q = 0; q < KP; ++q) Hh[(size_t)q * C + e] = 0.f;
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
    float g[K];
#pragma unroll
    for (int t = 0; t < K; ++t) g[t] = 0.f;
    for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
      const int en = ent[h], l = kind == 3 ? en : en >> 1;
      const int o = kind == 1 ? ((en & 1) ? 19 : 7) : ((en & 1) ? 14 : 8);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const size_t q = ((size_t)l * K + t) * 25;
        g[t] += kind == 3
                    ? 2.0f * (sS * (w5[q + 9] - u5[q + 9]) + sS * (w5[q + 13] - u5[q + 13]))
                    : 2.0f * (sS * (w5[q + o] - u5[q + o]));
      }
    }
    const float dv = (kind == 1 ? p.D1v1 : kind == 2 ? p.D1v2 : p.D1v3)[(size_t)b * P + v];
    float* out = (kind == 1 ? p.v1 : kind == 2 ? p.v2 : p.v3) + (size_t)b * K * P + v;
#pragma unroll
    for (int t = 0; t < K; ++t) out[(size_t)t * P] = ((rho * g[t]) / rho) / dv;
  }
}

__global__ void __launch_bounds__(omc::kThreads) k8d_kernel(K8dParams p) {
  __shared__ float part[kRows][kCols];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % kCols, ty = tid / kCols;
  const int n = p.n, m = p.m, nm = n * m, C = p.C, Ms = p.Ms, k = p.k;
  const int kp = k * (k - 1) / 2;
  const int j = blockIdx.x * kCols + lane;
  const bool col = j < m;
  const float rho = p.rho[b], sX = p.sX[b], sS = p.sS[b];
  const float sW = sX * sX, alpha = p.alpha, om = 1.0f - p.alpha, beta = p.beta;
  const float* Xs = p.Xs + (size_t)b * nm;
  const float* Ws = p.Ws + (size_t)b * nm;

  // ---- per entry: W >= 0; column sums of sW W for the Theta-link ----
  float csum = 0.f;
  if (col) {
    for (int i = ty; i < n; i += kRows) {
      const size_t q = (size_t)b * nm + i * m + j;
      const float w = p.Ws[q];
      csum += sW * w;
      const float tp = (alpha * (sS * w) + om * p.wp[q]) + p.up[q];
      const float wp = fmaxf(tp, 0.f);
      p.wp[q] = wp;
      p.up[q] = tp - wp;
    }
  }
  part[ty][lane] = csum;
  __syncthreads();
  if (ty == 0 && col) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += part[r][lane];
    const size_t ql = (size_t)b * m + j;
    const float f_link = p.sT[b] * p.Ths[(size_t)b * m * m + j * m + j] - s;
    const float tl = alpha * f_link + p.ul[ql];
    p.wl[ql] = 0.f;
    p.ul[ql] = tl;
    p.acc_l[ql] = p.acc_l[ql] + beta * (rho * tl - p.acc_l[ql]);
  }

  // ---- strided over the slot's CTAs: RSOC rows | W-link rows | Wt >= 0 ----
  const float* Wt = p.Wt + (size_t)b * k * C;
  const float* Hh = p.Hh + (size_t)b * kp * C;
  for (int e = blockIdx.x * blockDim.x + tid; e < Ms + C + k * C; e += gridDim.x * blockDim.x) {
    if (e < Ms) {
      const size_t q = (size_t)b * Ms + e;
      const int fl = p.soc_flat[q];
      const float fr[3] = {sS * 0.5f, sS * Ws[fl], sS * Xs[fl]};
      float t[3], pr[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] = (alpha * fr[c] + om * p.wr[3 * q + c]) + p.ur[3 * q + c];
      omc::project_rsoc1(t[0], t[1], t[2], pr[0], pr[1], pr[2]);
      const float sm = p.soc_mask[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float u = (t[c] - pr[c]) * sm;
        p.wr[3 * q + c] = pr[c];
        p.ur[3 * q + c] = u;
        p.acc_r[3 * q + c] = p.acc_r[3 * q + c] + beta * (rho * u - p.acc_r[3 * q + c]);
      }
    } else if (e < Ms + C) {
      const int c = e - Ms;
      const size_t q = (size_t)b * C + c;
      float sw = Wt[c];
      for (int t = 1; t < k; ++t) sw += Wt[(size_t)t * C + c];
      float sh = Hh[c];
      for (int t = 1; t < kp; ++t) sh += Hh[(size_t)t * C + c];
      const float cm = p.coord_mask[q];
      const float fwl = (sS * (Ws[p.coord_flat[q]] - sw - 2.0f * sh)) * cm;
      const float tw = (alpha * fwl + p.uwl[q]) * cm;
      p.wwl[q] = 0.f;
      p.uwl[q] = tw;
      p.acc_wl[q] = p.acc_wl[q] + beta * (rho * tw - p.acc_wl[q]);
    } else {
      const size_t q = (size_t)b * k * C + (e - Ms - C);
      const float tq = (alpha * (sS * p.Wt[q]) + om * p.wq[q]) + p.uq[q];
      const float wq = fmaxf(tq, 0.f);
      p.wq[q] = wq;
      p.uq[q] = tq - wq;
    }
  }
}

template <typename Kernel, typename Params>
int launch_tiles(Kernel kernel, const Params& p, void* stream) {
  if (p.B > 0 && p.m > 0) {
    const dim3 grid((p.m + kCols - 1) / kCols, p.B);
    kernel<<<grid, omc::kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int K>
int launch_k8c(const K8cParams& p, void* stream) {
  const size_t smem = sizeof(float) * k8c_smem_floats(p.n, p.m, K, p.cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k8c_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.B > 0 && p.m > 0) {
    const dim3 grid((p.m + p.cols - 1) / p.cols, p.B);
    k8c_kernel<K><<<grid, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

OMC_EXPORT int omc_k8c_shor_k_zstep(const K8cParams* params, void* stream) {
  // a tile is a power of two of at most 32 columns (whole row groups)
  const int cols = params->cols;
  if (cols < 1 || cols > kCols || (cols & (cols - 1))) return (int)cudaErrorInvalidValue;
  switch (params->k) {
    case 2: return launch_k8c<2>(*params, stream);
    case 3: return launch_k8c<3>(*params, stream);
    case 4: return launch_k8c<4>(*params, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8c's shared memory for a tile of `cols` columns, held against
// sdp.shor_k.k8c_plan by the smoke
OMC_EXPORT long long omc_k8c_smem_bytes(int n, int m, int k, int cols) {
  return (long long)sizeof(float) * k8c_smem_floats(n, m, k, cols);
}

OMC_EXPORT int omc_k8d_shor_k_cone(const K8dParams* params, void* stream) {
  return launch_tiles(k8d_kernel, *params, stream);
}
