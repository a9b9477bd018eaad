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
// ||U_j||, x_l' U, x_l' Y x_l) are O(L n^2).  Design: one CTA per node slot
// makes every per-slot reduction a block reduction (no atomics, no second
// pass); the reductions run first and are kept in shared memory, then one
// elementwise pass writes each output exactly once, so the in-place slot
// updates never race with the reads they depend on.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(omc::kThreads) k3_kernel(K3Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int n = p.n, m = p.m, k = p.k, L = p.L;
  const int D1 = n + m, D2 = n + k;
  const float alpha = p.alpha, om = 1.0f - p.alpha;
  float* red = smem;          // 32
  float* v = red + 32;        // L * k   x_l' U
  float* xyx = v + L * k;     // L       x_l' Y x_l
  float* nx = xyx + L;        // k       ||tsoc_j[1:]||
  float* ts0 = nx + k;        // k       tsoc_j[0]

  const float sX = p.sX[b], sT = p.sT[b], rho = p.rho[b];
  const float* Xs = p.Xs + (size_t)b * n * m;
  const float* Y = p.Y + (size_t)b * n * n;
  const float* Ths = p.Ths + (size_t)b * m * m;
  const float* U = p.U + (size_t)b * n * k;
  const float* cx = p.cut_x + (size_t)b * L * n;
  const float* clo = p.cut_lo + (size_t)b * L * k;
  const float* chi = p.cut_hi + (size_t)b * L * k;
  const float* cm = p.cut_mask + (size_t)b * L;
  float* wsoc = p.wsoc + (size_t)b * k * (1 + n);
  float* usoc = p.usoc + (size_t)b * k * (1 + n);

  // ---- reductions (read phase) ----
  float tr = 0.f;
  for (int i = tid; i < n; i += blockDim.x) tr += Y[i * n + i];
  tr = omc::block_sum(tr, red);
  for (int q = warp; q < L * k; q += nwarps) {
    const int l = q / k, j = q % k;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += cx[l * n + i] * U[i * k + j];
    s = omc::warp_sum(s);
    if (lane == 0) v[q] = s;
  }
  // x_l' Y x_l: n^2 terms that largely cancel, summed in float64 (in
  // float32 the chord slots of 250 x 250 nodes sat ~1e-6 from the float64
  // sum, relative)
  for (int l = warp; l < L; l += nwarps) {
    double s = 0.0;
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e % n;
      s = fma((double)cx[l * n + i] * Y[e], (double)cx[l * n + j], s);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) xyx[l] = (float)s;
  }
  for (int j = warp; j < k; j += nwarps) {
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int q = j * (1 + n) + 1 + i;
      const float t = alpha * U[i * k + j] + om * wsoc[q] + usoc[q];
      s += t * t;
    }
    s = omc::warp_sum(s);
    if (lane == 0) {
      const int q = j * (1 + n);
      nx[j] = sqrtf(s);
      ts0[j] = alpha * 1.0f + om * wsoc[q] + usoc[q];
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
      else if (i < n) f = U[i * k + (j - n)];
      else if (j < n) f = U[j * k + (i - n)];
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
    const float t4 = (alpha * ((float)k - tr) + om * p.w4[b]) + p.u4[b];
    const float w4 = fmaxf(t4, 0.f);
    p.w4[b] = w4;
    p.u4[b] = t4 - w4;
  }

  // ---- SOC slots (1, U_j) ----
  for (int e = tid; e < k * (1 + n); e += blockDim.x) {
    const int j = e / (1 + n), q = e % (1 + n);
    const float f = (q == 0) ? 1.0f : U[(q - 1) * k + j];
    const float t = (alpha * f + om * wsoc[e]) + usoc[e];
    const float tt = ts0[j], nj = nx[j];
    const bool inside = nj <= tt, polar = nj <= -tt;
    float w;
    if (inside) w = t;
    else if (polar) w = 0.f;
    else if (q == 0) w = 0.5f * (tt + nj);
    else w = (nj > 0.f ? 0.5f * (1.0f + tt / nj) : 0.f) * t;
    wsoc[e] = w;
    usoc[e] = t - w;
  }

  // ---- box slot ----
  for (int e = tid; e < n * k; e += blockDim.x) {
    const size_t q = (size_t)b * n * k + e;
    const float t = (alpha * U[e] + om * p.wbox[q]) + p.ubox[q];
    const float w = fminf(fmaxf(t, p.U_lo[q]), p.U_hi[q]);
    p.wbox[q] = w;
    p.ubox[q] = t - w;
  }

  // ---- cut interval slots and the dual EMA ----
  for (int e = tid; e < L * k; e += blockDim.x) {
    const int l = e / k;
    const size_t q = (size_t)b * L * k + e;
    const float lo = clo[e], hi = chi[e], c = cm[l];
    const float ta = (alpha * (v[e] - lo) + om * p.wa[q]) + p.ua[q];
    const float wa = fmaxf(ta, 0.f), ua = (ta - wa) * c;
    p.wa[q] = wa;
    p.ua[q] = ua;
    p.acc_a[q] = p.acc_a[q] + p.beta * (rho * ua - p.acc_a[q]);
    const float tb = (alpha * (hi - v[e]) + om * p.wb[q]) + p.ub[q];
    const float wb = fmaxf(tb, 0.f), ub = (tb - wb) * c;
    p.wb[q] = wb;
    p.ub[q] = ub;
    p.acc_b[q] = p.acc_b[q] + p.beta * (rho * ub - p.acc_b[q]);
  }
  // chord slots
  for (int l = tid; l < L; l += blockDim.x) {
    float cv = 0.f, bc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float lo = clo[l * k + j], hi = chi[l * k + j];
      cv += (lo + hi) * v[l * k + j];
      bc += -lo * hi;
    }
    const float f = cv + bc - xyx[l];
    const size_t q = (size_t)b * L + l;
    const float tc = (alpha * f + om * p.wc[q]) + p.uc[q];
    const float wc = fmaxf(tc, 0.f), uc = (tc - wc) * cm[l];
    p.wc[q] = wc;
    p.uc[q] = uc;
    p.acc_c[q] = p.acc_c[q] + p.beta * (rho * uc - p.acc_c[q]);
  }
}

}  // namespace

OMC_EXPORT int omc_k3_cone(const K3Params* params, void* stream) {
  K3Params p = *params;
  const size_t smem = (size_t)(32 + p.L * p.k + p.L + 2 * p.k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k3_kernel<<<p.B, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
