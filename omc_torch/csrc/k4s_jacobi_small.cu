// K4s — PSD projection of large batches of tiny symmetric matrices by
// cyclic Jacobi, one thread per matrix, in registers.
//
// Replaces the chunked batched eigh of the Shor safe bounds' small slots:
// omc/sdp/admm_shor.py:786-807 (the (B, M5, 5, 5) minor duals) and
// omc/sdp/shor_k.py:947-1165 (the (B, M5, k, 5, 5) per-term minors and the
// (B, C, k+1, k+1) XWH slots), i.e. omc_torch.ops.cones.project_psd for
// d <= 8 on CUDA.  cuSOLVER rejects batches of 32,768 or more such
// matrices, so the torch version chunks; this kernel takes any N in one
// launch.
//
// Each thread loads its D x D matrix (symmetrised), runs cyclic-by-row
// Jacobi sweeps with the rotation and stopping rule of K4
// (omc::jacobi_rotation, common.cuh) until a sweep rotates no pair or the
// cap, and writes V max(w, 0) V'.  Templated on D in 1..8 so that A and V
// live in registers (2 D^2 floats).  What bounds it on the H100: at D = 5,
// ~6 sweeps x 10 rotations x ~60 flops plus the 125-flop epilogue per
// matrix, against 200 bytes in and out: compute-bound on paper, but at
// 131,072 matrices a launch it is a few microseconds either way, so the
// launch dominates.
#include "common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(128) k4s_kernel(K4sParams p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.N) return;
  const float* tin = p.t + (size_t)idx * D * D;
  float A[D][D], V[D][D];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      A[i][j] = 0.5f * (tin[i * D + j] + tin[j * D + i]);
      ss += A[i][j] * A[i][j];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  const float normF = sqrtf(ss);
  const float floor_ = omc::jacobi_floor(normF, D);
  int sweep = 1;
  for (; sweep <= omc::kJacobiMaxSweeps; ++sweep) {
    bool any = false;
#pragma unroll
    for (int pi = 0; pi < D - 1; ++pi)
#pragma unroll
      for (int qi = pi + 1; qi < D; ++qi) {
        float t, s, r;
        if (!omc::jacobi_rotation(A[pi][pi], A[qi][qi], A[pi][qi], floor_, t, s, r)) continue;
        any = true;
        const float apq = A[pi][qi];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k == pi || k == qi) continue;
          float x = A[k][pi], y = A[k][qi];
          omc::jacobi_rot(x, y, s, r);
          A[k][pi] = x;
          A[pi][k] = x;
          A[k][qi] = y;
          A[qi][k] = y;
        }
        A[pi][pi] -= t * apq;
        A[qi][qi] += t * apq;
        A[pi][qi] = 0.f;
        A[qi][pi] = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) omc::jacobi_rot(V[k][pi], V[k][qi], s, r);
      }
    if (!any) break;
  }
  const bool bad = !isfinite(normF);
  const float qnan = __int_as_float(0x7fffffff);
  float wpos[D];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const float w = A[r][r];
    wpos[r] = bad ? qnan : (w > 0.f ? w : (isnan(w) ? w : 0.f));
  }
  float* out = p.w + (size_t)idx * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < D; ++r) acc = fmaf(V[i][r] * wpos[r], V[j][r], acc);
      out[i * D + j] = acc;
      out[j * D + i] = acc;
    }
  if (p.sweeps) p.sweeps[idx] = sweep;
}

}  // namespace

OMC_EXPORT int omc_k4s_jacobi_small(const K4sParams* params, void* stream) {
  const K4sParams p = *params;
  const int threads = 128, blocks = (p.N + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.D) {
    case 1: k4s_kernel<1><<<blocks, threads, 0, s>>>(p); break;
    case 2: k4s_kernel<2><<<blocks, threads, 0, s>>>(p); break;
    case 3: k4s_kernel<3><<<blocks, threads, 0, s>>>(p); break;
    case 4: k4s_kernel<4><<<blocks, threads, 0, s>>>(p); break;
    case 5: k4s_kernel<5><<<blocks, threads, 0, s>>>(p); break;
    case 6: k4s_kernel<6><<<blocks, threads, 0, s>>>(p); break;
    case 7: k4s_kernel<7><<<blocks, threads, 0, s>>>(p); break;
    case 8: k4s_kernel<8><<<blocks, threads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
