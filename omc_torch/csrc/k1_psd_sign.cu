// K1 — sign-schedule PSD projection of the three ADMM PSD blocks.
//
// Replaces omc/ops/polar.py: matrix_sign_poly / project_psd_ns /
// project_psd_ns_merged (the merged call of omc/sdp/admm.py:393-408):
//   P = (T + sign(T) T) / 2,  sign(T) from 12 quintic + 2 cubic odd-
//   polynomial steps on T / ||T||_F  (43 matmuls in series),
// followed by the ADMM epilogue w = sym(P), u = t - w and the dual EMA
// acc += beta (rho u - acc) of the first two blocks (omc admm.py:513-516).
//
// What bounds it on the H100: the 43 dependent d x d products of one matrix.
// At d = 100 one projection is ~86 MFLOP, far too little for the whole card,
// and the chain cannot be split across CTAs without a grid-wide sync per
// product.  Design: one CTA per matrix runs the whole chain (grid = B x 3
// blocks, each CTA reads its own d, so no padding to the largest block), so
// the batch and the three blocks fill the SMs in parallel and the chain
// costs no launches.  For d <= kSmemMaxD the four working matrices (S, S^2,
// S^4/M, T) stay in shared memory and each thread accumulates a strided
// TM x TM register tile (operands broadcast from shared memory, no bank
// conflicts thanks to an odd leading dimension); larger blocks (100x100 and
// 250x250 instances: d = 200, 500) keep them in a global workspace and stage
// 64x32 / 32x64 tiles through shared memory.  Plain fp32 FMA throughout —
// TF32 would floor ADMM accuracy at ~1e-2; wgmma/TMA tiles are later work.
#include "common.cuh"

namespace {

// largest d whose four (Dp x (Dp+1)) buffers fit in shared memory, Dp = d
// rounded up to 16: 4 * 112 * 113 * 4 B = 202,496 B of the 227 KB a block
// may use
constexpr int kSmemMaxD = 112;
constexpr int kRed = 32;  // reduction scratch (floats) ahead of the buffers
constexpr int kTileM = 64, kTileK = 32;
constexpr int kTileFloats = kTileM * (kTileK + 1) + kTileK * (kTileM + 1);

__host__ __device__ inline int round_up(int x, int r) { return (x + r - 1) / r * r; }

__host__ __device__ inline size_t smem_floats(int D) {
  if (D <= kSmemMaxD) {
    const int Dp = round_up(D, 16);
    return kRed + 4 * (size_t)Dp * (Dp + 1);
  }
  return kRed + kTileFloats;
}

// C = ca * (A . B) + ce * E over a Dp x Dp matrix held in shared memory
// (leading dimension ld); E may be null.  Thread (ty, tx) of the 16 x 16
// layout owns rows ty + 16 i and columns tx + 16 j, i, j < TM = Dp / 16;
// the k-loop runs over the dk real columns only (the padding is zero).
template <int TM>
__device__ void mm_smem(const float* __restrict__ A, const float* __restrict__ Bm,
                        float* __restrict__ C, const float* __restrict__ E,
                        float ca, float ce, int ld, int dk) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < dk; ++kk) {
    float a[TM], b[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * ld + kk];
#pragma unroll
    for (int j = 0; j < TM; ++j) b[j] = Bm[kk * ld + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int idx = (ty + 16 * i) * ld + tx + 16 * j;
      float v = ca * acc[i][j];
      if (E) v += ce * E[idx];
      C[idx] = v;
    }
}

__device__ void mm_smem_dispatch(int TM, const float* A, const float* Bm, float* C,
                                 const float* E, float ca, float ce, int ld, int dk) {
  switch (TM) {
    case 1: mm_smem<1>(A, Bm, C, E, ca, ce, ld, dk); break;
    case 2: mm_smem<2>(A, Bm, C, E, ca, ce, ld, dk); break;
    case 3: mm_smem<3>(A, Bm, C, E, ca, ce, ld, dk); break;
    case 4: mm_smem<4>(A, Bm, C, E, ca, ce, ld, dk); break;
    case 5: mm_smem<5>(A, Bm, C, E, ca, ce, ld, dk); break;
    case 6: mm_smem<6>(A, Bm, C, E, ca, ce, ld, dk); break;
    default: mm_smem<7>(A, Bm, C, E, ca, ce, ld, dk); break;
  }
}

// Same product for matrices in global memory (ld a multiple of 64, padding
// zero): 64 x 64 output tiles, k in chunks of 32 staged through `tile`.
__device__ void mm_global(const float* __restrict__ A, const float* __restrict__ Bm,
                          float* __restrict__ C, const float* __restrict__ E,
                          float ca, float ce, int ld, int dk, float* tile) {
  float* As = tile;                             // 64 x 33
  float* Bs = tile + kTileM * (kTileK + 1);     // 32 x 65
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nt = ld / kTileM;
  const int kend = round_up(dk, kTileK);
  for (int tile_id = 0; tile_id < nt * nt; ++tile_id) {
    const int r0 = (tile_id / nt) * kTileM, c0 = (tile_id % nt) * kTileM;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += kTileK) {
      __syncthreads();
      for (int e = tid; e < kTileM * kTileK; e += blockDim.x) {
        const int r = e / kTileK, kk = e % kTileK;
        As[r * (kTileK + 1) + kk] = A[(size_t)(r0 + r) * ld + k0 + kk];
      }
      for (int e = tid; e < kTileK * kTileM; e += blockDim.x) {
        const int kk = e / kTileM, cc = e % kTileM;
        Bs[kk * (kTileM + 1) + cc] = Bm[(size_t)(k0 + kk) * ld + c0 + cc];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTileK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * (kTileK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk * (kTileM + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t idx = (size_t)(r0 + ty + 16 * i) * ld + c0 + tx + 16 * j;
        float v = ca * acc[i][j];
        if (E) v += ce * E[idx];
        C[idx] = v;
      }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(omc::kThreads) k1_kernel(K1Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int D = p.D[g];
  const bool small = D <= kSmemMaxD;
  const int Dp = small ? round_up(D, 16) : round_up(D, kTileM);
  const int ld = small ? Dp + 1 : Dp;
  const size_t msz = (size_t)Dp * ld;
  float* red = smem;
  float* base = small ? smem + kRed : p.scratch[g] + (size_t)b * 4 * msz;
  float* tile = smem + kRed;
  float* bufT = base;
  float* S = base + msz;
  float* X1 = base + 2 * msz;
  float* X2 = base + 3 * msz;
  const float* tin = p.t[g] + (size_t)b * D * D;
  const int tid = threadIdx.x;

  // T = sym(t) zero-padded to Dp x Dp, and ||T||_F
  float ss = 0.f;
  for (int e = tid; e < Dp * Dp; e += blockDim.x) {
    const int i = e / Dp, j = e % Dp;
    float v = 0.f;
    if (i < D && j < D) v = 0.5f * (tin[i * D + j] + tin[j * D + i]);
    bufT[i * ld + j] = v;
    ss += v * v;
  }
  const float s = sqrtf(omc::block_sum(ss, red)) + 1e-30f;
  for (int e = tid; e < Dp * Dp; e += blockDim.x) {
    const int i = e / Dp, j = e % Dp;
    S[i * ld + j] = bufT[i * ld + j] / s;
  }
  __syncthreads();

  const int TM = Dp / 16;
  auto mm = [&](const float* A, const float* Bm, float* C, const float* E,
                float ca, float ce) {
    if (small) {
      mm_smem_dispatch(TM, A, Bm, C, E, ca, ce, ld, D);
      __syncthreads();
    } else {
      mm_global(A, Bm, C, E, ca, ce, ld, D, tile);
    }
  };

  for (int step = 0; step < omc::kSignSteps; ++step) {
    const float a = omc::kSignSched[step][0], bq = omc::kSignSched[step][1],
                c = omc::kSignSched[step][2];
    mm(S, S, X1, nullptr, 1.f, 0.f);                 // X1 = S^2
    if (c != 0.f) {
      mm(X1, X1, X2, X1, c, bq);                     // X2 = c S^4 + b S^2
      mm(S, X2, X1, S, 1.f, a);                      // X1 = a S + S X2
      float* t = S; S = X1; X1 = t;
    } else {
      mm(S, X1, X2, S, bq, a);                       // X2 = a S + b S S^2
      float* t = S; S = X2; X2 = t;
    }
  }
  mm(S, bufT, X1, bufT, 0.5f, 0.5f);                 // X1 = (T + S T) / 2

  // epilogue: w = sym(P), u = t - w, acc += beta (rho u - acc)
  float* wout = p.w[g] + (size_t)b * D * D;
  float* uout = p.u[g] ? p.u[g] + (size_t)b * D * D : nullptr;
  float* aout = p.acc[g] ? p.acc[g] + (size_t)b * D * D : nullptr;
  const float rho = aout ? p.rho[b] : 0.f;
  for (int e = tid; e < D * D; e += blockDim.x) {
    const int i = e / D, j = e % D;
    const float w = 0.5f * (X1[i * ld + j] + X1[j * ld + i]);
    wout[e] = w;
    if (uout) {
      const float u = tin[e] - w;
      uout[e] = u;
      if (aout) aout[e] = aout[e] + p.beta * (rho * u - aout[e]);
    }
  }
}

}  // namespace

OMC_EXPORT int omc_k1_smem_max_d() { return kSmemMaxD; }

OMC_EXPORT int omc_k1_psd_sign(const K1Params* params, void* stream) {
  K1Params p = *params;
  size_t smem = 0;
  for (int g = 0; g < p.G; ++g) {
    const size_t f = smem_floats(p.D[g]) * sizeof(float);
    if (f > smem) smem = f;
  }
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.B, p.G);
  k1_kernel<<<grid, omc::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

OMC_EXPORT const char* omc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
