// K2 — fused adjoint + rho-free Woodbury z-step of the ADMM iteration.
//
// Replaces, per node slot, omc/sdp/admm.py: _adjoint (:169-188), the
// solve_z closure (:324-340) with _Vt_apply / _V_apply (:234-263) and the
// symmetrisation (:375-376):
//   r = w - u - offs  (nine slots; cut slots masked)
//   (gX, gY, gTh, gU) = K' r
//   z = D^-1 (rho K' r - c)  per block,   s = V' z,
//   t = rho G1^-1 s  (two triangular solves with the Cholesky factor of G1),
//   z -= D^-1 V t,   Y = sym(zY), Ths = sym(zTh).
// In the Shor loop (Xs and Ths null) it writes Y and U only: the Shor
// relaxation shares their z-step, and K8a writes X and Theta.
//
// What bounds it on the H100: memory traffic — each slot reads its
// (n+m)^2 + (n+k)^2 + n^2 residual blocks once and writes n m + n^2 + m^2
// + n k outputs; the arithmetic is O(L n^2) for the cut contractions plus
// O(p^2) for the p = 1 + L + L k triangular solves, which are sequential.
// Design: one CTA per node slot; the block residuals are read straight from
// w and u (no r tensors in device memory), the z blocks are written to the
// output tensors and corrected in place, and the triangular solves run in
// one warp with the right-hand side in shared memory (no block-wide
// barrier per column; the factor's rows come through L1/L2).
#include "common.cuh"

namespace {

constexpr float kSqrt2 = 1.41421356237309515f;

__global__ void __launch_bounds__(omc::kThreads) k2_kernel(K2Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int n = p.n, m = p.m, k = p.k, L = p.L;
  const int D1 = n + m, D2 = n + k, P = 1 + L + L * k;
  float* red = smem;              // 32
  float* yc = red + 32;           // L
  float* coef = yc + L;           // L * k
  float* sv = coef + L * k;       // P

  const float rho = p.rho[b], sX = p.sX[b], sT = p.sT[b];
  const float* w1 = p.w1 + (size_t)b * D1 * D1;
  const float* u1 = p.u1 + (size_t)b * D1 * D1;
  const float* w2 = p.w2 + (size_t)b * D2 * D2;
  const float* u2 = p.u2 + (size_t)b * D2 * D2;
  const float* w3 = p.w3 + (size_t)b * n * n;
  const float* u3 = p.u3 + (size_t)b * n * n;
  const float* wsoc = p.wsoc + (size_t)b * k * (1 + n);
  const float* usoc = p.usoc + (size_t)b * k * (1 + n);
  const float* wbox = p.wbox + (size_t)b * n * k;
  const float* ubox = p.ubox + (size_t)b * n * k;
  const float* cx = p.cut_x + (size_t)b * L * n;
  const float* clo = p.cut_lo + (size_t)b * L * k;
  const float* chi = p.cut_hi + (size_t)b * L * k;
  const float* cm = p.cut_mask + (size_t)b * L;
  float* Xs = p.Xs ? p.Xs + (size_t)b * n * m : nullptr;
  float* Y = p.Y + (size_t)b * n * n;
  float* Ths = p.Ths ? p.Ths + (size_t)b * m * m : nullptr;
  float* U = p.U + (size_t)b * n * k;

  // cut-slot duals: yc_l = (wc - uc - bconst_l) cm_l,
  // coef_lj = ya - yb + yc_l c_lj with ya = (wa - ua + lo) cm, yb = (wb - ub - hi) cm
  for (int l = tid; l < L; l += blockDim.x) {
    float bc = 0.f;
    for (int j = 0; j < k; ++j) bc += -clo[l * k + j] * chi[l * k + j];
    yc[l] = (p.wc[b * L + l] - p.uc[b * L + l] - bc) * cm[l];
  }
  __syncthreads();
  for (int e = tid; e < L * k; e += blockDim.x) {
    const int l = e / k;
    const size_t q = (size_t)b * L * k + e;
    const float lo = clo[e], hi = chi[e];
    const float ya = (p.wa[q] - p.ua[q] - (-lo)) * cm[l];
    const float yb = (p.wb[q] - p.ub[q] - hi) * cm[l];
    coef[e] = ya - yb + yc[l] * (lo + hi);
  }
  const float y4 = p.w4[b] - p.u4[b] - (float)k;
  __syncthreads();

  // X block: zX = (rho gX + sX mask A) / (mask sX^2 + 2 rho sX^2)
  for (int e = tid; Xs && e < n * m; e += blockDim.x) {
    const int i = e / m, j = e % m;
    const int q = i * D1 + n + j;
    const float gX = sX * 2.0f * (w1[q] - u1[q]);
    const float rX = rho * gX + sX * p.maskA[e];
    const float dX = p.mask[e] * (sX * sX) + rho * 2.0f * sX * sX;
    Xs[e] = rX / dX;
  }
  // Theta block (no Woodbury correction): symmetrised directly
  const float cth = sT * 0.5f / p.gamma;
  for (int e = tid; Ths && e < m * m; e += blockDim.x) {
    const int i = e / m, j = e % m;
    const int q1 = (n + i) * D1 + n + j, q2 = (n + j) * D1 + n + i;
    const float dg = (i == j) ? cth : 0.f;
    const float za = (rho * (sT * (w1[q1] - u1[q1])) - dg) / (rho * sT * sT);
    const float zb = (rho * (sT * (w1[q2] - u1[q2])) - dg) / (rho * sT * sT);
    Ths[e] = 0.5f * (za + zb);
  }
  // U block before correction: zU = rho gU / (4 rho)
  for (int e = tid; e < n * k; e += blockDim.x) {
    const int i = e / k, j = e % k;
    const int q2 = i * D2 + n + j;
    const int qs = j * (1 + n) + 1 + i;
    float gU = 2.0f * (w2[q2] - u2[q2]) + (wsoc[qs] - usoc[qs]) + (wbox[e] - ubox[e]);
    float ct = 0.f;
    for (int l = 0; l < L; ++l) ct += cx[l * n + i] * coef[l * k + j];
    gU += ct;
    U[e] = (rho * gU) / (4.0f * rho);
  }
  // Y block before correction: zY = rho gY / (3 rho)
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    const int q1 = i * D1 + j, q2 = i * D2 + j;
    float gY = (w1[q1] - u1[q1]) + (w2[q2] - u2[q2]) -
               (w3[e] - u3[e] - (i == j ? 1.0f : 0.f));
    if (i == j) gY -= y4;
    float cc = 0.f;
    for (int l = 0; l < L; ++l) cc += yc[l] * cx[l * n + i] * cx[l * n + j];
    gY -= cc;
    Y[e] = (rho * gY) / (3.0f * rho);
  }
  __syncthreads();

  // s = V' z: trace, chord rows, interval directions (masked cuts)
  float tr = 0.f;
  for (int i = tid; i < n; i += blockDim.x) tr += Y[i * n + i];
  tr = omc::block_sum(tr, red);
  if (tid == 0) sv[0] = tr;
  for (int l = warp; l < L; l += nwarps) {
    const float cml = cm[l];
    float xr = 0.f;
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e % n;
      xr += (cx[l * n + i] * cml) * Y[e] * (cx[l * n + j] * cml);
    }
    xr = omc::warp_sum(xr);
    float chord = -xr;
    for (int j = 0; j < k; ++j) {
      float v = 0.f;
      for (int i = lane; i < n; i += 32) v += (cx[l * n + i] * cml) * U[i * k + j];
      v = omc::warp_sum(v);
      chord += (clo[l * k + j] + chi[l * k + j]) * cml * v;
      if (lane == 0) sv[1 + L + l * k + j] = kSqrt2 * v;
    }
    if (lane == 0) sv[1 + l] = chord;
  }
  __syncthreads();

  // t = rho G1^-1 s: forward then backward substitution in warp 0
  if (warp == 0) {
    const float* Lf = p.G1c + (size_t)b * P * P;
    for (int jj = 0; jj < P; ++jj) {
      const float yj = sv[jj] / Lf[jj * P + jj];
      __syncwarp();
      if (lane == 0) sv[jj] = yj;
      for (int i = jj + 1 + lane; i < P; i += 32) sv[i] -= Lf[i * P + jj] * yj;
      __syncwarp();
    }
    for (int jj = P - 1; jj >= 0; --jj) {
      const float tj = sv[jj] / Lf[jj * P + jj];
      __syncwarp();
      if (lane == 0) sv[jj] = tj;
      for (int i = lane; i < jj; i += 32) sv[i] -= Lf[jj * P + i] * tj;
      __syncwarp();
    }
    for (int i = lane; i < P; i += 32) sv[i] *= rho;
  }
  __syncthreads();

  // z -= D^-1 V t, then Y = sym(zY)
  const float t0 = sv[0];
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    if (i > j) continue;
    float vy = 0.f;
    for (int l = 0; l < L; ++l)
      vy += sv[1 + l] * (cx[l * n + i] * cm[l]) * (cx[l * n + j] * cm[l]);
    vy = (i == j ? t0 : 0.f) - vy;
    const float a = Y[i * n + j] - vy / (3.0f * rho);
    const float c = Y[j * n + i] - vy / (3.0f * rho);
    const float ys = 0.5f * (a + c);
    Y[i * n + j] = ys;
    Y[j * n + i] = ys;
  }
  for (int e = tid; e < n * k; e += blockDim.x) {
    const int i = e / k, j = e % k;
    float a = 0.f, d = 0.f;
    for (int l = 0; l < L; ++l) {
      const float xli = cx[l * n + i] * cm[l];
      a += sv[1 + l] * xli * ((clo[l * k + j] + chi[l * k + j]) * cm[l]);
      d += xli * sv[1 + L + l * k + j];
    }
    const float vu = a + kSqrt2 * d;
    U[e] = U[e] - vu / (4.0f * rho);
  }
}

}  // namespace

OMC_EXPORT int omc_k2_zstep(const K2Params* params, void* stream) {
  K2Params p = *params;
  const int P = 1 + p.L + p.L * p.k;
  const size_t smem = (size_t)(32 + p.L + p.L * p.k + P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k2_kernel<<<p.B, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
