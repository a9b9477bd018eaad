// K7x's wide kernel -- the (k+1)x(k+1) XWH slots of the rank-k Shor
// relaxation at any D = k + 1 (omc/sdp/shor_k.py: the gather :373-392, the
// w/u-step :751-753, the EMA :833-835; csrc/k7k_minor_xwh.cu's register
// kernels take D <= 5).
//
// The register kernels hold a slot's triangles in registers, which grow
// with D^2.  The wide kernel gives a slot to a warp and its matrices to
// memory: shared memory, `warps` slots a CTA, or, where one warp's matrices
// pass a CTA's shared memory, a global workspace of `ctas` x `warps`
// regions (sdp.shor_k.k7x_plan).  A warp loops over the slots g = its
// global warp, + ctas x warps, ...; each lane owns a strided share of the
// slot's upper-triangle entries.
// - It gathers and mixes t (the slot mode: [[1, Xt'], [Xt, M]] of
//   coordinate c, alpha f + (1 - alpha) w + u; or t itself in the
//   projection mode), symmetrised, as a full symmetric D x D matrix.
// - Float32: the sign schedule of omc::project_psd_small_sym (43 products
//   of commuting symmetric matrices, the upper triangle of each, every
//   entry summed in order of k by one lane, mirrored), on T / ||T||_F; the
//   same order of work (CPU mirror: ops.polar.project_psd_ns with
//   symmetric_matmul()).
// - Float64: an exact projection by K4s's cyclic Jacobi (k4s_jacobi.cuh:
//   the power-of-two scaling, the row-cyclic pairs, K4s's rotation and
//   stopping rule), each rotation's rows and columns p and q spread over
//   the lanes (CPU mirror: ops.jacobi.k4s_project_psd at any D), then V
//   max(w, 0) V'.
// - Then w, the u-step and the EMA, as the register kernels.
// Every lane reads the same pivots, so the warp takes the same branches;
// a __syncwarp separates each product and each rotation from the next.
//
// What bounds it on the H100: a slot's float32 schedule is 43 D (D + 1) / 2
// D FMAs against 6 D^2 values of w/u/acc traffic, 12 flops a byte at D = 6
// (bytes, below the card's 20) and 25 at D = 13 (operations); float64's
// Jacobi runs ~6 sweeps of D (D - 1) / 2 rotations.  A warp a slot leaves
// lanes idle at small D (21 upper entries for 32 lanes at D = 6), and each
// product and rotation waits on a __syncwarp.
#include "common.cuh"
#include "k4s_jacobi.cuh"

namespace {

constexpr int kWideWarps7x = 4;  // at most, a CTA

// values of T a warp works in: float32 T, S, S^2 and a scratch M (D^2
// each); float64 A, V, T (D^2 each) and max(w, 0) (D)
template <class T>
__host__ __device__ inline long long k7x_wide_values(int D) {
  return sizeof(T) == 8 ? 3LL * D * D + D : 4LL * D * D;
}

// (i, j), i <= j, of upper-triangle entry e (row by row)
__device__ __forceinline__ void upper_ij(int e, int D, int& i, int& j) {
  i = 0;
  while (e >= D - i) e -= D - i, ++i;
  j = i + e;
}

// C = A B for commuting symmetric D x D matrices in full storage: the
// upper triangle, each entry one lane's FMAs in order of k, mirrored
__device__ __forceinline__ void warp_mm_sym(const float* A, const float* B, float* C, int D,
                                            int lane) {
  const int NT = D * (D + 1) / 2;
  for (int e = lane; e < NT; e += 32) {
    int i, j;
    upper_ij(e, D, i, j);
    float c = 0.f;
    for (int k = 0; k < D; ++k) c = fmaf(A[i * D + k], B[k * D + j], c);
    C[i * D + j] = c;
    C[j * D + i] = c;
  }
  __syncwarp();
}

// the sign-schedule projection of the symmetric Tm: W = (T + sign(T) T) / 2
// left as 0.5 (Tm + M) (omc::project_psd_small_sym's order of work)
__device__ __forceinline__ void warp_sign_psd(const float* Tm, float* S, float* S2, float* M,
                                              int D, int lane) {
  const int DD = D * D;
  float ss = 0.f;  // ||T||_F^2 over the full matrix, row by row (every lane)
  for (int q = 0; q < DD; ++q) ss = fmaf(Tm[q], Tm[q], ss);
  const float s = sqrtf(ss) + 1e-30f;
  for (int q = lane; q < DD; q += 32) S[q] = Tm[q] / s;
  __syncwarp();
  for (int step = 0; step < omc::kSignSteps; ++step) {
    const float a = omc::kSignSched[step][0], b = omc::kSignSched[step][1],
                c = omc::kSignSched[step][2];
    warp_mm_sym(S, S, S2, D, lane);
    if (c != 0.f) {
      warp_mm_sym(S2, S2, M, D, lane);  // S^4
      for (int q = lane; q < DD; q += 32) M[q] = b * S2[q] + c * M[q];
      __syncwarp();
      warp_mm_sym(S, M, S2, D, lane);   // S (b S^2 + c S^4)
      for (int q = lane; q < DD; q += 32) S[q] = a * S[q] + S2[q];
    } else {
      warp_mm_sym(S, S2, M, D, lane);   // S^3
      for (int q = lane; q < DD; q += 32) S[q] = a * S[q] + b * M[q];
    }
    __syncwarp();
  }
  warp_mm_sym(S, Tm, M, D, lane);
}

// K4s's Jacobi projection of the symmetric A (full storage, overwritten)
// by one warp; V (D^2) and wp (D) its scratch; out(i, j, v) receives entry
// (i, j), i <= j, of V max(w, 0) V' on the lane that forms it
template <class Out>
__device__ __forceinline__ void warp_jacobi_psd(double* A, double* V, double* wp, int D,
                                                int lane, Out out) {
  const int DD = D * D;
  double ss = 0;  // ||A||_F summed in K4's order (every entry, row by row)
  for (int q = 0; q < DD; ++q) ss += A[q] * A[q];
  const double normF = sqrt(ss);
  const bool bad = !isfinite(normF);
  const int ex = k4s::exponent_of(normF);
  const int kx = bad || normF == 0.0 ? 0 : max(-1022, min(1022, 1 - ex));
  const double sc = k4s::pow2(0.0, kx), unsc = k4s::pow2(0.0, -kx);
  const double fs = omc::jacobi_floor(normF * sc, D), floor2 = fs * fs;
  __syncwarp();
  for (int q = lane; q < DD; q += 32) {
    A[q] *= sc;
    V[q] = q / D == q % D ? 1.0 : 0.0;
  }
  __syncwarp();
  for (int sweep = 1; sweep <= omc::kJacobiMaxSweeps; ++sweep) {
    bool any = false;
    for (int pi = 0; pi < D - 1; ++pi)
      for (int qi = pi + 1; qi < D; ++qi) {
        const double app = A[pi * D + pi], aqq = A[qi * D + qi], apq = A[pi * D + qi];
        double t, s, r;
        if (!k4s::rotation(app, aqq, apq, floor2, t, s, r)) continue;
        any = true;
        __syncwarp();  // every lane has read the pivots
        for (int k = lane; k < D; k += 32) {
          if (k != pi && k != qi) {
            double x = A[k * D + pi], y = A[k * D + qi];
            omc::jacobi_rot(x, y, s, r);
            A[k * D + pi] = x, A[pi * D + k] = x;
            A[k * D + qi] = y, A[qi * D + k] = y;
          }
          omc::jacobi_rot(V[k * D + pi], V[k * D + qi], s, r);
        }
        if (lane == 0) {
          A[pi * D + pi] = app - t * apq;
          A[qi * D + qi] = aqq + t * apq;
          A[pi * D + qi] = 0, A[qi * D + pi] = 0;
        }
        __syncwarp();
      }
    if (!any) break;
  }
  const double qnan = omc::qnan_of(0.0);
  for (int r = lane; r < D; r += 32) {
    const double w = A[r * D + r];
    wp[r] = bad ? qnan : (w > 0.0 ? w * unsc : (isnan(w) ? w : 0.0));
  }
  __syncwarp();
  const int NT = D * (D + 1) / 2;
  for (int e = lane; e < NT; e += 32) {
    int i, j;
    upper_ij(e, D, i, j);
    double acc = 0;
    for (int r = 0; r < D; ++r) acc = fma(V[i * D + r] * wp[r], V[j * D + r], acc);
    out(i, j, acc);
  }
}

template <class T>
__global__ void __launch_bounds__(32 * kWideWarps7x) k7x_wide_kernel(K7xWideParamsT<T> p) {
  extern __shared__ __align__(16) unsigned char k7x_wide_raw[];
  const int K = p.k, D = K + 1, DD = D * D, NT = D * (D + 1) / 2, KP = K * (K - 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const long long per = k7x_wide_values<T>(D);
  T* const mine = p.work != nullptr ? p.work + (size_t)(blockIdx.x * W + warp) * per
                                    : reinterpret_cast<T*>(k7x_wide_raw) + (size_t)warp * per;
  T* const Tm = mine;  // t, symmetrised
  const T alpha = p.alpha, om = T(1) - p.alpha, beta = p.beta;
  for (int g = blockIdx.x * W + warp; g < p.N; g += gridDim.x * W) {
    const size_t off = (size_t)g * DD;
    T sS = 0, mask = 0, rho = 0;
    if (p.t != nullptr) {
      for (int e = lane; e < NT; e += 32) {
        int i, j;
        upper_ij(e, D, i, j);
        const T v = i == j ? p.t[off + i * D + i]
                           : T(0.5) * (p.t[off + i * D + j] + p.t[off + j * D + i]);
        Tm[i * D + j] = v, Tm[j * D + i] = v;
      }
    } else {
      const int b = g / p.C, c = g - b * p.C;
      const int f = __ldg(p.coord_flat + g);
      sS = __ldg(p.sS + b), mask = __ldg(p.coord_mask + g), rho = __ldg(p.rho + b);
      for (int e = lane; e < NT; e += 32) {
        int i, j;
        upper_ij(e, D, i, j);
        // the slot's value [[1, Xt'], [Xt, M]] at (i, j)
        T F;
        if (i == 0)
          F = j == 0 ? T(1) : __ldg(p.Xt + ((size_t)b * K + j - 1) * p.nm + f);
        else if (i == j)
          F = __ldg(p.Wt + ((size_t)b * K + i - 1) * p.C + c);
        else  // the pair (i - 1, j - 1), pairs row by row
          F = __ldg(p.Hh + ((size_t)b * KP + (i - 1) * K - (i - 1) * i / 2 + (j - i - 1)) * p.C +
                    c);
        const T tij = (alpha * (sS * F) + om * p.w[off + i * D + j]) + p.u[off + i * D + j];
        const T tji = (alpha * (sS * F) + om * p.w[off + j * D + i]) + p.u[off + j * D + i];
        const T v = i == j ? tij : T(0.5) * (tij + tji);
        Tm[i * D + j] = v, Tm[j * D + i] = v;
      }
    }
    __syncwarp();
    // w at (i, j) and (j, i): the projection mode writes w; the slot mode w,
    // the u-step and the EMA
    const auto put = [&](int q, T w) {
      p.w[off + q] = w;
      if (p.t != nullptr) return;
      const T u = (Tm[q] - w) * mask;
      p.u[off + q] = u;
      if (p.acc != nullptr) p.acc[off + q] = p.acc[off + q] + beta * (rho * u - p.acc[off + q]);
    };
    if constexpr (sizeof(T) == 4) {
      float* S = Tm + DD;
      float* S2 = S + DD;
      float* M = S2 + DD;
      warp_sign_psd(Tm, S, S2, M, D, lane);
      for (int q = lane; q < DD; q += 32) put(q, 0.5f * (Tm[q] + M[q]));
    } else {
      double* A = Tm + DD;
      double* V = A + DD;
      double* wp = V + DD;
      for (int q = lane; q < DD; q += 32) A[q] = Tm[q];
      __syncwarp();
      warp_jacobi_psd(A, V, wp, D, lane, [&](int i, int j, double w) {
        put(i * D + j, w);
        if (i != j) put(j * D + i, w);
      });
    }
    __syncwarp();  // the slot's scratch is free for the next
  }
}

template <class T>
int k7x_wide_launch(const K7xWideParamsT<T>& p, void* stream) {
  // the float64 build has no projection mode
  if (p.k < 1 || p.warps < 1 || p.warps > kWideWarps7x || p.ctas < 1 ||
      (sizeof(T) == 8 && p.t != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      p.work != nullptr ? 0 : (long long)p.warps * k7x_wide_values<T>(p.k + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k7x_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.N > 0)
    k7x_wide_kernel<T><<<p.ctas, 32 * p.warps, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K7x's wide kernel, float32 (both modes) and float64 (the slot mode)
OMC_EXPORT int omc_k7x_xwh_wide(const K7xWideParams* params, void* stream) {
  return k7x_wide_launch(*params, stream);
}

OMC_EXPORT int omc_k7x_xwh_wide_f64(const K7xWideParamsT<double>* params, void* stream) {
  return k7x_wide_launch(*params, stream);
}

// the wide kernel's shared memory for `warps` slots a CTA at D (elem bytes
// a value), held against sdp.shor_k.k7x_plan by the smoke
OMC_EXPORT long long omc_k7x_wide_smem_bytes(int elem, int D, int warps) {
  return (long long)warps * elem *
         (elem == 8 ? k7x_wide_values<double>(D) : k7x_wide_values<float>(D));
}

