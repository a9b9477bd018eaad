// Shared helpers and the C parameter blocks of the omc_torch kernels.
//
// Every entry point takes a pointer to its parameter block (laid out like
// the ctypes.Structure of the same name in omc_torch/kernels.py), launches
// on the given stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#define OMC_EXPORT extern "C" __attribute__((visibility("default")))

namespace omc {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; every thread gets the result.  `red` holds >= 32 floats
// of shared memory; the call contains two __syncthreads().
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  const int nw = (blockDim.x + 31) >> 5;
  for (int i = 0; i < nw; ++i) r += red[i];
  __syncthreads();
  return r;
}

}  // namespace omc

struct K1Params {
  const float* t[3];   // (B, D_g, D_g) pre-projection blocks
  float* w[3];         // (B, D_g, D_g) projections
  float* u[3];         // (B, D_g, D_g) u = t - w, or null
  float* acc[3];       // (B, D_g, D_g) EMA of rho*u, or null
  float* scratch[3];   // (B, 4, Dp, Dp) workspace for D_g > kSmemMaxD, or null
  int D[3];
  int G;
  int B;
  const float* rho;    // (B,), needed when some acc is given
  float beta;
};

struct K2Params {
  const float *w1, *u1, *w2, *u2, *w3, *u3, *w4, *u4, *wsoc, *usoc, *wbox,
      *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  const float *cut_x, *cut_lo, *cut_hi, *cut_mask;
  const float *maskA, *mask;  // (n, m): mask * A and the 0/1 mask
  const float *sX, *sT, *rho;  // (B,)
  const float* G1c;            // (B, p, p) lower Cholesky factor of G1
  float *Xs, *Y, *Ths, *U;     // outputs
  int B, n, m, k, L;
  float gamma;
};

struct K3Params {
  const float *Xs, *Y, *Ths, *U;
  const float *w1, *u1, *w2, *u2, *w3, *u3;
  float *t1, *t2, *t3;
  float *w4, *u4, *wsoc, *usoc, *wbox, *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  float *acc_a, *acc_b, *acc_c;
  const float *cut_x, *cut_lo, *cut_hi, *cut_mask, *U_lo, *U_hi;
  const float *sX, *sT, *rho;
  int B, n, m, k, L;
  float alpha, beta;
};
