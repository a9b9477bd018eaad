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
// slots once.  Design: one CTA per (node slot, tile of 32 columns), 8 row
// groups of 32 threads, consecutive threads on consecutive columns.  Each
// (i, j) thread holds all k terms of its entry (the Sherman-Morrison solve
// of D1x I_k + c1x J_k is per entry).  Every coupling of the link Woodbury
// is column-local: p_j sums zW over column j, S_th and B q sum over the
// coordinates of column j (table b), b_c needs a at coord_j[c], and the
// corrections touch W, Wt and H of that column only; a CTA owns whole
// columns, so the sums are shared-memory reductions in the CTA and one
// launch finishes the step (no atomics, no second pass).  The v1-v3 solves
// are diagonal and the padded coordinates need no link term, so both are
// spread over the slot's CTAs by index range.  All sums run in a fixed
// order through tables built on the host once per visit, so two launches on
// the same input give the same bits.
#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kRows = omc::kThreads / kCols;  // 8

// q_c = cdm sS (W_c - sum_t Wt - 2 sum_p H): the W-link row at the z-step's
// uncorrected values (read back by the thread or CTA that wrote them)
template <int K>
__device__ __forceinline__ float wlink_q(const float* Ws, const float* Wt, const float* Hh,
                                         int C, int c, int f, float cm, float sS) {
  constexpr int KP = K * (K - 1) / 2;
  float sw = Wt[c];
#pragma unroll
  for (int t = 1; t < K; ++t) sw += Wt[(size_t)t * C + c];
  float sh = Hh[c];
#pragma unroll
  for (int q = 1; q < KP; ++q) sh += Hh[(size_t)q * C + c];
  return (cm * sS) * (Ws[f] - sw - 2.0f * sh);
}

template <int K>
__global__ void __launch_bounds__(omc::kThreads) k8c_kernel(K8cParams p) {
  constexpr int KP = K * (K - 1) / 2;
  constexpr int D = K + 1, DD = D * D;
  __shared__ float part[kRows][kCols];
  __shared__ float a_s[kCols];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % kCols, ty = tid / kCols;
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m, C = p.C;
  const int j = blockIdx.x * kCols + lane;
  const bool col = j < m;
  const float rho = p.rho[b], sX = p.sX[b], sT = p.sT[b], sS = p.sS[b];
  const float sW = sX * sX;
  const float* w1 = p.w1 + (size_t)b * D1 * D1;
  const float* u1 = p.u1 + (size_t)b * D1 * D1;
  const float* w5 = p.w5 + (size_t)b * p.M5 * K * 25;
  const float* u5 = p.u5 + (size_t)b * p.M5 * K * 25;
  const float* wx = p.wx + (size_t)b * C * DD;
  const float* ux = p.ux + (size_t)b * C * DD;
  const float* wr = p.wr + (size_t)b * p.Ms * 3;
  const float* ur = p.ur + (size_t)b * p.Ms * 3;
  const float* socm = p.soc_mask + (size_t)b * p.Ms;
  const float* cdm = p.coord_mask + (size_t)b * C;
  const float* wwl = p.wwl + (size_t)b * C;
  const float* uwl = p.uwl + (size_t)b * C;
  const float* wq = p.wq + (size_t)b * K * C;
  const float* uq = p.uq + (size_t)b * K * C;
  const int* cf = p.coord_flat + (size_t)b * C;
  const int* cm_ptr = p.cm_ptr + (size_t)b * (C + 1);
  const int* cm_ent = p.cm_ent + (size_t)b * 4 * p.M5;
  const int* flat_coord = p.flat_coord + (size_t)b * nm;
  const int* flat_soc = p.flat_soc + (size_t)b * nm;
  const float* D1x = p.D1x + (size_t)b * nm;
  const float* c1x = p.c1x + (size_t)b * nm;
  const float* D1w = p.D1w + (size_t)b * nm;
  const float* D1wt = p.D1wt + (size_t)b * C;
  const float* D1h = p.D1h + (size_t)b * C;
  const float* D_c = p.D_c + (size_t)b * C;
  const float* B_jc = p.B_jc + (size_t)b * C;
  float* Xt = p.Xt + (size_t)b * K * nm;
  float* Xs = p.Xs + (size_t)b * nm;
  float* Ws = p.Ws + (size_t)b * nm;
  float* Wt = p.Wt + (size_t)b * K * C;
  float* Hh = p.Hh + (size_t)b * KP * C;
  const float R_Xs = p.R_X / sX;
  const float yl = col ? p.wl[b * m + j] - p.ul[b * m + j] : 0.f;

  // ---- per entry: adjoint, X solve, uncorrected W / Wt / H; column sums ----
  float csum = 0.f;
  if (col) {
    for (int i = ty; i < n; i += kRows) {
      const int f = i * m + j;
      float gx[K];
#pragma unroll
      for (int t = 0; t < K; ++t) gx[t] = 0.f;
      float gw = 0.f, ywl = 0.f;
      const int c = flat_coord[f];
      if (c >= 0) {
        const float cm = cdm[c];
        float gwt[K], gh[KP];
#pragma unroll
        for (int t = 0; t < K; ++t) gwt[t] = 0.f;
        // per-term 5x5 minor duals through table (a): (0, cc) and (cc, cc)
        for (int e = cm_ptr[c]; e < cm_ptr[c + 1]; ++e) {
          const int ent = cm_ent[e], l = ent >> 2, cc = (ent & 3) + 1;
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
          Wt[(size_t)t * C + c] = ((rho * gwt[t]) / rho) / D1wt[c];
        }
#pragma unroll
        for (int q = 0; q < KP; ++q) {
          gh[q] = gh[q] - 2.0f * ywl;
          Hh[(size_t)q * C + c] = ((rho * gh[q]) / rho) / D1h[c];
        }
      }
      // RSOC row (0.5, W, sum_t Xt): its X slot lands on every term
      const int s = flat_soc[f];
      if (s >= 0) {
        const float sm = socm[s];
        gw += (sS * (wr[3 * s + 1] - ur[3 * s + 1])) * sm;
        const float y2 = (sS * (wr[3 * s + 2] - ur[3 * s + 2])) * sm;
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
      Ws[f] = zW;
      csum += zW;
    }
  }
  part[ty][lane] = csum;
  __syncthreads();

  // ---- per column: Theta diagonal and the link Woodbury's a_j ----
  float* Ths = p.Ths + (size_t)b * m * m;
  if (ty == 0 && col) {
    float sw = 0.f;
    for (int r = 0; r < kRows; ++r) sw += part[r][lane];
    const int qd = (n + j) * D1 + n + j;
    const float RT = rho * (sT * (w1[qd] - u1[qd]) + sT * yl) - sT * 0.5f / p.gamma;
    float zTh = RT / (rho * sT * sT);
    const float pj = sT * zTh - sW * sw;
    // B q over the coordinates of column j (table b), ascending c
    const int* col_ptr = p.col_ptr + (size_t)b * (m + 1);
    const int* col_ent = p.col_ent + (size_t)b * C;
    float bq = 0.f;
    for (int e = col_ptr[j]; e < col_ptr[j + 1]; ++e) {
      const int c = col_ent[e];
      const float qc = wlink_q<K>(Ws, Wt, Hh, C, c, cf[c], cdm[c], sS);
      bq += B_jc[c] * (qc / D_c[c]);
    }
    const float a = (pj - bq) / p.S_th[b * m + j];
    Ths[j * m + j] = zTh - a / sT;
    a_s[lane] = a;
  }
  __syncthreads();

  // ---- per entry: link corrections of W, Wt, H; Theta off the diagonal ----
  if (col) {
    const float a = a_s[lane];
    for (int i = ty; i < n; i += kRows) {
      const int f = i * m + j;
      float zW = Ws[f] - ((-sW) * a) / D1w[f];
      const int c = flat_coord[f];
      if (c >= 0) {
        const float cm = cdm[c];
        const float qc = wlink_q<K>(Ws, Wt, Hh, C, c, f, cm, sS);
        const float bc = (qc - B_jc[c] * a) / D_c[c];
        zW = zW + (-((sS * bc) * cm)) / D1w[f];
#pragma unroll
        for (int t = 0; t < K; ++t)
          Wt[(size_t)t * C + c] = Wt[(size_t)t * C + c] - ((-(sS * bc)) * cm) / D1wt[c];
#pragma unroll
        for (int q = 0; q < KP; ++q)
          Hh[(size_t)q * C + c] = Hh[(size_t)q * C + c] - (((-(2.0f * sS)) * bc) * cm) / D1h[c];
      }
      Ws[f] = zW;
    }
    for (int i = ty; i < m; i += kRows) {
      if (i == j) continue;
      const int qa = (n + i) * D1 + n + j, qb = (n + j) * D1 + n + i;
      const float za = (rho * (sT * (w1[qa] - u1[qa]))) / (rho * sT * sT);
      const float zb = (rho * (sT * (w1[qb] - u1[qb]))) / (rho * sT * sT);
      Ths[i * m + j] = 0.5f * (za + zb);
    }
  }

  // ---- strided over the slot's CTAs: padded coordinates, v1 | v2 | v3 ----
  const int P1 = p.P1, P2 = p.P2, P3 = p.P3;
  const int nv = K * (P1 + P2 + P3);
  for (int e = blockIdx.x * blockDim.x + tid; e < C + nv; e += gridDim.x * blockDim.x) {
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
    const int r = e - C;
    float g = 0.f, dv;
    float* out;
    if (r < K * P1) {
      const int t = r / P1, v = r % P1;
      const int* ptr = p.v1_ptr + (size_t)b * (P1 + 1);
      const int* ent = p.v1_ent + (size_t)b * 2 * p.M5;
      for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
        const size_t q = ((size_t)(ent[h] >> 1) * K + t) * 25;
        g += (ent[h] & 1) ? 2.0f * (sS * (w5[q + 19] - u5[q + 19]))    // (3, 4)
                          : 2.0f * (sS * (w5[q + 7] - u5[q + 7]));     // (1, 2)
      }
      dv = p.D1v1[(size_t)b * P1 + v];
      out = p.v1 + ((size_t)b * K + t) * P1 + v;
    } else if (r < K * (P1 + P2)) {
      const int r2 = r - K * P1, t = r2 / P2, v = r2 % P2;
      const int* ptr = p.v2_ptr + (size_t)b * (P2 + 1);
      const int* ent = p.v2_ent + (size_t)b * 2 * p.M5;
      for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
        const size_t q = ((size_t)(ent[h] >> 1) * K + t) * 25;
        g += (ent[h] & 1) ? 2.0f * (sS * (w5[q + 14] - u5[q + 14]))    // (2, 4)
                          : 2.0f * (sS * (w5[q + 8] - u5[q + 8]));     // (1, 3)
      }
      dv = p.D1v2[(size_t)b * P2 + v];
      out = p.v2 + ((size_t)b * K + t) * P2 + v;
    } else {
      const int r3 = r - K * (P1 + P2), t = r3 / P3, v = r3 % P3;
      const int* ptr = p.v3_ptr + (size_t)b * (P3 + 1);
      const int* ent = p.v3_ent + (size_t)b * p.M5;
      for (int h = ptr[v]; h < ptr[v + 1]; ++h) {
        const size_t q = ((size_t)ent[h] * K + t) * 25;
        g += 2.0f * (sS * (w5[q + 9] - u5[q + 9]) + sS * (w5[q + 13] - u5[q + 13]));  // (1,4)+(2,3)
      }
      dv = p.D1v3[(size_t)b * P3 + v];
      out = p.v3 + ((size_t)b * K + t) * P3 + v;
    }
    *out = ((rho * g) / rho) / dv;
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

}  // namespace

OMC_EXPORT int omc_k8c_shor_k_zstep(const K8cParams* params, void* stream) {
  switch (params->k) {
    case 2: return launch_tiles(k8c_kernel<2>, *params, stream);
    case 3: return launch_tiles(k8c_kernel<3>, *params, stream);
    case 4: return launch_tiles(k8c_kernel<4>, *params, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

OMC_EXPORT int omc_k8d_shor_k_cone(const K8dParams* params, void* stream) {
  return launch_tiles(k8d_kernel, *params, stream);
}
