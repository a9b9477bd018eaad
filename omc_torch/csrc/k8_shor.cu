// K8 — the Shor slots outside the 5x5 minors, in two launches.
//
// K8a replaces, per node slot, the Shor part of the z-step of
// omc/sdp/admm_shor.py: _adjoint_shor (:178-218, the scatter-add of the
// minor, RSOC and link duals onto X, W, v1, v2, v3), the W >= 0 adjoint
// (:331), the diagonal solves of X, Theta, W, v (:336-353), the Theta-link
// Woodbury correction (:363-371), sym(Theta) and the clip of X to +-R_X/sX
// (:374-376).  The base slots' share of X and Theta comes from w1 - u1 here
// (K2 runs in its Shor mode and writes Y and U only).
//
// K8b replaces the cone step of the RSOC rows (:423-427, project_rsoc of
// omc/ops/cones.py:49-66 in closed form per coordinate), the Theta-link
// rows (:429-431) and the W >= 0 slot (:433-435), with the dual EMAs of
// rho*ur and rho*ul (:493-494).
//
// What bounds both on the H100: bytes.  Per slot they stream the n*m
// coordinates' X, W, RSOC (3 floats), W >= 0 and count arrays once, plus
// the minor duals through the inverse tables, with a few flops each.
// Design: one CTA per (node slot, tile of 32 columns), 8 row groups of 32
// threads, consecutive threads on consecutive columns (coalesced rows).
// The link rows need column sums over i of W; a CTA owns whole columns, so
// the sums are a shared-memory reduction inside the CTA (no atomics, no
// second pass).  The adjoint gathers each coordinate's minor duals through
// the CSR inverse tables built on the host once per visit, in ascending
// minor order, so every sum is deterministic (no atomics).
#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kRows = omc::kThreads / kCols;  // 8
constexpr int kD5 = 25;                        // floats per 5x5 minor slot

__device__ __forceinline__ float y5(const float* w5, const float* u5, int l, int i, int j) {
  const int q = l * kD5 + i * 5 + j;
  return w5[q] - u5[q];
}

__global__ void __launch_bounds__(omc::kThreads) k8a_kernel(K8aParams p) {
  __shared__ float part[kRows][kCols];
  __shared__ float tl_s[kCols];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % kCols, ty = tid / kCols;
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m;
  const int j = blockIdx.x * kCols + lane;
  const bool col = j < m;
  const float rho = p.rho[b], sX = p.sX[b], sT = p.sT[b], sS = p.sS[b];
  const float sW = sX * sX, sS2 = sS * sS;
  const float* w1 = p.w1 + (size_t)b * D1 * D1;
  const float* u1 = p.u1 + (size_t)b * D1 * D1;
  const float* w5 = p.w5 + (size_t)b * p.M5 * kD5;
  const float* u5 = p.u5 + (size_t)b * p.M5 * kD5;
  const int* xw_ptr = p.xw_ptr + (size_t)b * (nm + 1);
  const int* xw_ent = p.xw_ent + (size_t)b * 4 * p.M5;
  const float R_Xs = p.R_X / sX;
  const float yl = col ? p.wl[b * m + j] - p.ul[b * m + j] : 0.f;

  // ---- X and W entries of this CTA's columns; column sums of zW ----
  float csum = 0.f;
  if (col) {
    for (int i = ty; i < n; i += kRows) {
      const int f = i * m + j;
      const size_t q = (size_t)b * nm + f;
      float gx = 0.f, gw = 0.f;
      for (int e = xw_ptr[f]; e < xw_ptr[f + 1]; ++e) {
        const int ent = xw_ent[e], l = ent >> 2, c = (ent & 3) + 1;
        gx += 2.0f * (sS * y5(w5, u5, l, 0, c));
        gw += sS * y5(w5, u5, l, c, c);
      }
      const float sm = p.soc_mask[q];
      gw += sS * (p.wr[3 * q + 1] - p.ur[3 * q + 1]) * sm;
      gx += sS * (p.wr[3 * q + 2] - p.ur[3 * q + 2]) * sm;
      gw = gw - sW * yl;
      gw = gw + sS * (p.wp[q] - p.up[q]);
      const int q1 = i * D1 + n + j;
      const float rX = sX * 2.0f * (w1[q1] - u1[q1]);
      const float RX = rho * (rX + gx) + sX * p.maskA[f];
      const float dX1 = 2.0f * sX * sX + sS2 * p.cnt_X[q];
      const float zX = RX / (rho * dX1);
      p.Xs[q] = fminf(fmaxf(zX, -R_Xs), R_Xs);
      const float RW = rho * gw - 0.5f * sW * p.mask[f];
      const float dW1 = sS2 * fmaxf(p.cnt_W[q], 1.0f);
      const float zW = RW / (rho * dW1);
      p.Ws[q] = zW;
      csum += zW;
    }
  }
  part[ty][lane] = csum;
  __syncthreads();

  // ---- Theta diagonal with the link correction ----
  float* Ths = p.Ths + (size_t)b * m * m;
  if (ty == 0 && col) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += part[r][lane];
    const int qd = (n + j) * D1 + n + j;
    const float RT = rho * (sT * (w1[qd] - u1[qd]) + sT * yl) - sT * 0.5f / p.gamma;
    float zTh = RT / (rho * sT * sT);
    const float t_l = rho * (sT * zTh - sW * s) / p.g_link[b * m + j];
    zTh = zTh - t_l / (rho * sT);
    Ths[j * m + j] = zTh;
    tl_s[lane] = t_l;
  }
  __syncthreads();

  if (col) {
    const float t_l = tl_s[lane];
    for (int i = ty; i < n; i += kRows) {
      const size_t q = (size_t)b * nm + i * m + j;
      const float dW1 = sS2 * fmaxf(p.cnt_W[q], 1.0f);
      p.Ws[q] = p.Ws[q] + sW * t_l / (rho * dW1);
    }
    // Theta off the diagonal: sym of the base slots' share (no link term)
    for (int i = ty; i < m; i += kRows) {
      if (i == j) continue;
      const int qa = (n + i) * D1 + n + j, qb = (n + j) * D1 + n + i;
      const float za = (rho * (sT * (w1[qa] - u1[qa]))) / (rho * sT * sT);
      const float zb = (rho * (sT * (w1[qb] - u1[qb]))) / (rho * sT * sT);
      Ths[i * m + j] = 0.5f * (za + zb);
    }
  }

  // ---- shared v entries: v1 | v2 | v3, strided over the slot's CTAs ----
  const int P1 = p.P1, P2 = p.P2, P3 = p.P3;
  for (int e = blockIdx.x * blockDim.x + tid; e < P1 + P2 + P3;
       e += gridDim.x * blockDim.x) {
    float g = 0.f, cnt;
    float* out;
    if (e < P1) {
      const int* ptr = p.v1_ptr + (size_t)b * (P1 + 1);
      const int* ent = p.v1_ent + (size_t)b * 2 * p.M5;
      for (int t = ptr[e]; t < ptr[e + 1]; ++t) {
        const int l = ent[t] >> 1;
        g += (ent[t] & 1) ? 2.0f * (sS * y5(w5, u5, l, 3, 4))
                          : 2.0f * (sS * y5(w5, u5, l, 1, 2));
      }
      cnt = p.cnt_v1[(size_t)b * P1 + e];
      out = p.v1 + (size_t)b * P1 + e;
    } else if (e < P1 + P2) {
      const int r = e - P1;
      const int* ptr = p.v2_ptr + (size_t)b * (P2 + 1);
      const int* ent = p.v2_ent + (size_t)b * 2 * p.M5;
      for (int t = ptr[r]; t < ptr[r + 1]; ++t) {
        const int l = ent[t] >> 1;
        g += (ent[t] & 1) ? 2.0f * (sS * y5(w5, u5, l, 2, 4))
                          : 2.0f * (sS * y5(w5, u5, l, 1, 3));
      }
      cnt = p.cnt_v2[(size_t)b * P2 + r];
      out = p.v2 + (size_t)b * P2 + r;
    } else {
      const int r = e - P1 - P2;
      const int* ptr = p.v3_ptr + (size_t)b * (P3 + 1);
      const int* ent = p.v3_ent + (size_t)b * p.M5;
      for (int t = ptr[r]; t < ptr[r + 1]; ++t) {
        const int l = ent[t];
        g += 2.0f * (sS * y5(w5, u5, l, 1, 4) + sS * y5(w5, u5, l, 2, 3));
      }
      cnt = p.cnt_v3[(size_t)b * P3 + r];
      out = p.v3 + (size_t)b * P3 + r;
    }
    *out = (rho * g) / (rho * (sS2 * fmaxf(cnt, 1.0f)));
  }
}

__global__ void __launch_bounds__(omc::kThreads) k8b_kernel(K8bParams p) {
  __shared__ float part[kRows][kCols];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % kCols, ty = tid / kCols;
  const int n = p.n, m = p.m, nm = n * m;
  const int j = blockIdx.x * kCols + lane;
  const bool col = j < m;
  const float rho = p.rho[b], sX = p.sX[b], sS = p.sS[b];
  const float sW = sX * sX, alpha = p.alpha, om = 1.0f - p.alpha, beta = p.beta;

  float csum = 0.f;
  if (col) {
    for (int i = ty; i < n; i += kRows) {
      const size_t q = (size_t)b * nm + i * m + j;
      const float x = p.Xs[q], w = p.Ws[q];
      csum += sW * w;
      // RSOC row (0.5, W, X) scaled by sS
      const float fr[3] = {sS * 0.5f, sS * w, sS * x};
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
      // W >= 0 slot
      const float tp = (alpha * (sS * w) + om * p.wp[q]) + p.up[q];
      const float wp = fmaxf(tp, 0.f);
      p.wp[q] = wp;
      p.up[q] = tp - wp;
    }
  }
  part[ty][lane] = csum;
  __syncthreads();

  // Theta-link rows Theta_jj - sum_i W_ij: zero cone, the dual accumulates
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

OMC_EXPORT int omc_k8a_shor_zstep(const K8aParams* params, void* stream) {
  return launch_tiles(k8a_kernel, *params, stream);
}

OMC_EXPORT int omc_k8b_shor_cone(const K8bParams* params, void* stream) {
  return launch_tiles(k8b_kernel, *params, stream);
}
