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
// Each warp stages its 32 matrices through shared memory: 16-byte loads and
// stores of the warp's contiguous floats (scalar ones for the ragged tail,
// or where the tensors are not 16-byte aligned), each matrix at a row of
// D^2 | 1 floats, an odd stride, so that the threads' reads and writes of
// their own matrix are free of bank conflicts.  The warp waits for its own
// loads only (no CTA barrier), so one warp's sweeps overlap another's
// loads.  Each thread symmetrises its matrix from the staged copy (each
// staged float read once), scales it by a power of two, runs cyclic-by-row
// Jacobi sweeps with K4's order and
// stopping rule until a sweep rotates no pair or the cap, on the upper
// triangle of A only, with K4s's rotation (k4s_rotation.cuh: no square root
// in the skip test, one reciprocal), and writes V max(w, 0) V' back through
// the staging.  Templated on D in 1..8 so that A and V live in registers.
// What bounds it on the H100: at D = 5, ~6 sweeps x 10 pairs of a skip test
// and ~40 flops a rotation plus the 125-flop epilogue a matrix, against 200
// bytes in and out: at 131,072 matrices a single wave of CTAs, so the
// instruction chain of the slowest lane's sweeps sets the time.
#include "common.cuh"
#include "k4s_rotation.cuh"

namespace {

constexpr int kThreads4s = 128;  // matrices (threads) a CTA

template <int D>
struct Stage {
  static constexpr int DD = D * D, LD = DD | 1;
  // the staged slot of the CTA's float f (matrix f / DD, entry f % DD)
  static __device__ __forceinline__ int slot(int f) { return (f / DD) * LD + f % DD; }
};

// a warp's nf floats at g to its staging st (or back): quads while they
// last where g is 16-byte aligned, then one float a lane
template <int D>
__device__ __forceinline__ void stage_in(const float* g, float* st, int nf, int lane) {
  using S = Stage<D>;
  const int n4 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? nf / 4 : 0;
  for (int q = lane; q < n4; q += 32) {
    const float4 v = reinterpret_cast<const float4*>(g)[q];
    if (S::LD == S::DD) {
      reinterpret_cast<float4*>(st)[q] = v;
    } else {
      st[S::slot(4 * q)] = v.x;
      st[S::slot(4 * q + 1)] = v.y;
      st[S::slot(4 * q + 2)] = v.z;
      st[S::slot(4 * q + 3)] = v.w;
    }
  }
  for (int f = 4 * n4 + lane; f < nf; f += 32) st[S::slot(f)] = g[f];
}

template <int D>
__device__ __forceinline__ void stage_out(const float* st, float* g, int nf, int lane) {
  using S = Stage<D>;
  const int n4 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? nf / 4 : 0;
  for (int q = lane; q < n4; q += 32) {
    float4 v;
    if (S::LD == S::DD) {
      v = reinterpret_cast<const float4*>(st)[q];
    } else {
      v.x = st[S::slot(4 * q)];
      v.y = st[S::slot(4 * q + 1)];
      v.z = st[S::slot(4 * q + 2)];
      v.w = st[S::slot(4 * q + 3)];
    }
    reinterpret_cast<float4*>(g)[q] = v;
  }
  for (int f = 4 * n4 + lane; f < nf; f += 32) g[f] = st[S::slot(f)];
}

// A's upper triangle: A[i][j] with i <= j (indices are constants after
// unrolling, so A stays in registers)
#define AU(i, j) A[(i) < (j) ? (i) : (j)][(i) < (j) ? (j) : (i)]

template <int D>
__global__ void __launch_bounds__(kThreads4s) k4s_kernel(K4sParams p) {
  using S = Stage<D>;
  __shared__ __align__(16) float st[kThreads4s * S::LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m0 = (long long)blockIdx.x * kThreads4s + 32 * warp;  // the warp's first
  const int nm = (int)max(0LL, min(32LL, (long long)p.N - m0));
  float* sw = st + 32 * warp * S::LD;
  stage_in<D>(p.t + m0 * S::DD, sw, nm * S::DD, lane);
  __syncwarp();
  if (lane < nm) {
    float* sm = sw + lane * S::LD;
    float A[D][D], V[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
        A[i][j] = i == j ? sm[i * D + i] : 0.5f * (sm[i * D + j] + sm[j * D + i]);
    // ||A||_F summed in K4's order (every entry, row by row)
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) ss += AU(i, j) * AU(i, j);
    const float normF = sqrtf(ss);
    const bool bad = !isfinite(normF);
    // scale by 2^k so that ||A||_F lies in [1, 2); the rotations are
    // invariant under it, so the pairs and the angles are K4's
    int ex = 0;
    frexpf(normF, &ex);
    const int kx = bad || normF == 0.f ? 0 : max(-126, min(126, 1 - ex));
    const float sc = ldexpf(1.f, kx), unsc = ldexpf(1.f, -kx);
    const float fs = omc::jacobi_floor(normF * sc, D), floor2 = fs * fs;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = i; j < D; ++j) A[i][j] *= sc;
#pragma unroll
      for (int j = 0; j < D; ++j) V[i][j] = i == j ? 1.f : 0.f;
    }
    int sweep = 1;
    for (; sweep <= omc::kJacobiMaxSweeps; ++sweep) {
      bool any = false;
#pragma unroll
      for (int pi = 0; pi < D - 1; ++pi)
#pragma unroll
        for (int qi = pi + 1; qi < D; ++qi) {
          float t, s, r;
          if (!k4s::rotation(A[pi][pi], A[qi][qi], A[pi][qi], floor2, t, s, r)) continue;
          any = true;
          const float apq = A[pi][qi];
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k == pi || k == qi) continue;
            omc::jacobi_rot(AU(k, pi), AU(k, qi), s, r);
          }
          A[pi][pi] -= t * apq;
          A[qi][qi] += t * apq;
          A[pi][qi] = 0.f;
#pragma unroll
          for (int k = 0; k < D; ++k) omc::jacobi_rot(V[k][pi], V[k][qi], s, r);
        }
      if (!any) break;
    }
    const float qnan = __int_as_float(0x7fffffff);
    float wpos[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const float w = A[r][r];
      wpos[r] = bad ? qnan : (w > 0.f ? w * unsc : (isnan(w) ? w : 0.f));
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < D; ++r) acc = fmaf(V[i][r] * wpos[r], V[j][r], acc);
        sm[i * D + j] = acc;
        sm[j * D + i] = acc;
      }
    if (p.sweeps) p.sweeps[m0 + lane] = sweep;
  }
  __syncwarp();
  stage_out<D>(sw, p.w + m0 * S::DD, nm * S::DD, lane);
}

#undef AU

}  // namespace

OMC_EXPORT long long omc_k4s_smem_bytes(int D) {
  return (long long)kThreads4s * ((D * D) | 1) * (long long)sizeof(float);
}

OMC_EXPORT int omc_k4s_grid_x(int N) { return (N + kThreads4s - 1) / kThreads4s; }

OMC_EXPORT int omc_k4s_jacobi_small(const K4sParams* params, void* stream) {
  const K4sParams p = *params;
  const int blocks = omc_k4s_grid_x(p.N);
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.D) {
    case 1: k4s_kernel<1><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 2: k4s_kernel<2><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 3: k4s_kernel<3><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 4: k4s_kernel<4><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 5: k4s_kernel<5><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 6: k4s_kernel<6><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 7: k4s_kernel<7><<<blocks, kThreads4s, 0, s>>>(p); break;
    case 8: k4s_kernel<8><<<blocks, kThreads4s, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
