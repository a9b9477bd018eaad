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
// the staging (k4s_jacobi.cuh, which K7's float64 build shares).
// Templated on D in 1..8 so that A and V live in registers.
// What bounds it on the H100: at D = 5, ~6 sweeps x 10 pairs of a skip test
// and ~40 flops a rotation plus the 125-flop epilogue a matrix, against 200
// bytes in and out: at 131,072 matrices a single wave of CTAs, so the
// instruction chain of the slowest lane's sweeps sets the time.
//
// The float64 build (omc_k4s_jacobi_small_f64) is the same kernel on
// doubles: 16-byte copies of two doubles, the staging at the same odd
// stride in doubles (twice the bytes: dynamic shared memory, beyond 48 KB
// at D >= 7), the scaling clamped to double's range, and K4s's rotation
// on doubles (k4s_rotation.cuh: DBL_EPSILON's skip test, one square root,
// rsqrt and one divide); the CPU mirror is ops.jacobi.k4s_eigh in float64.
#include "common.cuh"
#include "k4s_jacobi.cuh"

namespace {

constexpr int kThreads4s = 128;  // matrices (threads) a CTA

template <int D>
struct Stage {
  static constexpr int DD = D * D, LD = DD | 1;
  // the staged slot of the CTA's value f (matrix f / DD, entry f % DD)
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

// the float64 build's: pairs of doubles (16 bytes) while they last where g
// is 16-byte aligned, then one double a lane
template <int D>
__device__ __forceinline__ void stage_in(const double* g, double* st, int nf, int lane) {
  using S = Stage<D>;
  const int n2 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? nf / 2 : 0;
  for (int q = lane; q < n2; q += 32) {
    const double2 v = reinterpret_cast<const double2*>(g)[q];
    st[S::slot(2 * q)] = v.x;
    st[S::slot(2 * q + 1)] = v.y;
  }
  for (int f = 2 * n2 + lane; f < nf; f += 32) st[S::slot(f)] = g[f];
}

template <int D>
__device__ __forceinline__ void stage_out(const double* st, double* g, int nf, int lane) {
  using S = Stage<D>;
  const int n2 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? nf / 2 : 0;
  for (int q = lane; q < n2; q += 32)
    reinterpret_cast<double2*>(g)[q] = make_double2(st[S::slot(2 * q)], st[S::slot(2 * q + 1)]);
  for (int f = 2 * n2 + lane; f < nf; f += 32) g[f] = st[S::slot(f)];
}

// the CTA's staging: static shared memory in the float build, dynamic in
// the float64 build (omc_k4s_smem_bytes at 8 bytes a value)
template <int D, class T>
__device__ __forceinline__ T* stage_buffer() {
  if constexpr (sizeof(T) == 4) {
    __shared__ __align__(16) float st[kThreads4s * Stage<D>::LD];
    return st;
  } else {
    extern __shared__ __align__(16) double k4s_dyn[];
    return k4s_dyn;
  }
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads4s) k4s_kernel(K4sParamsT<T> p) {
  using S = Stage<D>;
  T* const st = stage_buffer<D, T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m0 = (long long)blockIdx.x * kThreads4s + 32 * warp;  // the warp's first
  const int nm = (int)max(0LL, min(32LL, (long long)p.N - m0));
  T* sw = st + 32 * warp * S::LD;
  stage_in<D>(p.t + m0 * S::DD, sw, nm * S::DD, lane);
  __syncwarp();
  if (lane < nm) {
    T* sm = sw + lane * S::LD;
    T A[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
        A[i][j] = i == j ? sm[i * D + i] : T(0.5) * (sm[i * D + j] + sm[j * D + i]);
    const int sweep = k4s::project_psd<D>(A, [&](int i, int j, T v) {
      sm[i * D + j] = v;
      sm[j * D + i] = v;
    });
    if (p.sweeps) p.sweeps[m0 + lane] = sweep;
  }
  __syncwarp();
  stage_out<D>(sw, p.w + m0 * S::DD, nm * S::DD, lane);
}

template <int D, class T>
int launch_d(const K4sParamsT<T>& p, int blocks, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    k4s_kernel<D, T><<<blocks, kThreads4s, 0, s>>>(p);
  } else {
    static bool attr = false;
    const int smem = kThreads4s * Stage<D>::LD * (int)sizeof(T);
    if (!attr) {
      const cudaError_t err =
          cudaFuncSetAttribute(k4s_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      attr = true;
    }
    k4s_kernel<D, T><<<blocks, kThreads4s, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <class T>
int k4s_entry(const K4sParamsT<T>& p, void* stream) {
  const int blocks = (p.N + kThreads4s - 1) / kThreads4s;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.D) {
    case 1: return launch_d<1>(p, blocks, s);
    case 2: return launch_d<2>(p, blocks, s);
    case 3: return launch_d<3>(p, blocks, s);
    case 4: return launch_d<4>(p, blocks, s);
    case 5: return launch_d<5>(p, blocks, s);
    case 6: return launch_d<6>(p, blocks, s);
    case 7: return launch_d<7>(p, blocks, s);
    case 8: return launch_d<8>(p, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a CTA's staging at the operands' element size (4, or 8 for the float64 build)
OMC_EXPORT long long omc_k4s_smem_bytes(int D, int elem) {
  return (long long)kThreads4s * ((D * D) | 1) * (long long)elem;
}

OMC_EXPORT int omc_k4s_grid_x(int N) { return (N + kThreads4s - 1) / kThreads4s; }

OMC_EXPORT int omc_k4s_jacobi_small(const K4sParams* params, void* stream) {
  return k4s_entry(*params, stream);
}

OMC_EXPORT int omc_k4s_jacobi_small_f64(const K4sParamsT<double>* params, void* stream) {
  return k4s_entry(*params, stream);
}
