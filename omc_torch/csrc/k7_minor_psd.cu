// K7 — sign-schedule PSD projection of the 5x5 Shor minor slots.
//
// Replaces omc/ops/polar.py: project_psd_ns_small (:127-162) and, in its
// fused mode, the minor-slot step of the Shor ADMM loop (omc/sdp/admm_shor.py
// :149-167 gather, :420-422 w/u-step, :492 EMA):
//   f5 = sS [1, x; x, W/V]  (15 distinct entries gathered from Xs, Ws, v1-v3)
//   t5 = alpha f5 + (1 - alpha) w5 + u5
//   w5 = (T + sign(T) T) / 2  (T = sym(t5); sign from 12 quintic + 2 cubic
//        odd-polynomial steps on T / ||T||_F, 43 5x5 products in series)
//   u5 = (t5 - w5) mask,   acc += beta (rho u5 - acc).
// Without the fused mode it projects a given (N, 5, 5) batch.
//
// What bounds it on the H100: fp32 FMAs and bytes in nearly equal shares.
// One matrix is 43 x 75 = 3,225 FMAs (the upper triangles of products of
// commuting symmetric matrices, omc::project_psd_small_sym) against 300
// bytes of w5/u5/acc read and written, plus 60 gathered.  omc laid the batch
// along the TPU's lanes to keep the 5x5 products off the matrix unit; here
// it is one thread per matrix, four 15-float triangles in registers, no
// tensor cores (an mma tile would waste most of its area on a 5x5, and the
// fp32 bar needs 3xTF32, three times the issue count).  The 100-byte
// records of w5, u5 and acc are staged through shared memory: a CTA's
// matrices are one contiguous block of each array, read and written with
// 16-byte vector accesses by consecutive threads, and each thread reads its
// own matrix at a stride of 25 words (odd: no bank conflicts).  The t5 of a
// minor is exactly symmetric (every input slot is), so u5 = t5 - w5 uses the
// symmetrised T.  A CTA is 128 threads (smaller CTAs were never faster on
// the H100 at the Shor loop's shapes: a matrix's chain of products is the
// time, even where 128 leaves SMs idle).
//
// The float64 build (omc_k7_minor_psd_f64, the fused mode only) follows
// omc's float64 route, which projects the minors exactly (project_psd,
// omc/sdp/admm_shor.py:233-240): the sign schedule stops at ~1e-4 relative
// and would floor a float64 run.  Per minor one thread gathers and mixes
// t5 as above, projects it by K4s's cyclic Jacobi in registers
// (k4s_jacobi.cuh: K4s's power-of-two scaling and rotation, K4's floor at
// DBL_EPSILON; ~6 sweeps of 10 pairs and a 125-flop rebuild in FP64, about
// as many operations as the 43 float32 products), and writes V max(w, 0) V',
// the u-step and the EMA.  t5 waits in the u5 block of the staging while
// the thread projects (A, V: 40 doubles in registers).  A CTA is 64
// minors, so that the three staged blocks of doubles (38,400 bytes) stay
// static shared memory; a stride of 25 doubles is odd in 8-byte words (no
// bank conflicts).  CPU mirror: minor_step_plain with
// ops.jacobi.k4s_project_psd.
#include "common.cuh"
#include "k4s_jacobi.cuh"

namespace {

constexpr int kD = 5;
constexpr int kD5 = kD * kD;
constexpr int kNT = omc::kTri<kD>;
constexpr int kThreads7 = 128;
constexpr int kThreads7d = 64;  // the float64 build's minors a CTA

using omc::tri;

__global__ void __launch_bounds__(kThreads7) k7_kernel(K7Params p) {
  // the CTA's blocks of w5 (or t), u5 and acc, kThreads7 matrices each (a
  // multiple of 4 matrices: every block starts 16-byte aligned)
  __shared__ float4 k7_smem[3 * kThreads7 * kD5 / 4];
  float* sw = reinterpret_cast<float*>(k7_smem);
  float* su = sw + kThreads7 * kD5;
  float* sa = su + kThreads7 * kD5;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads7;
  const int cnt = min(kThreads7, p.N - base);
  const int nf = cnt * kD5;
  const size_t off = (size_t)base * kD5;
  float* mw = sw + tid * kD5;
  float* mu = su + tid * kD5;
  float* ma = sa + tid * kD5;
  float T[kNT], W[kNT];

  if (p.t != nullptr) {
    omc::load_block<kThreads7>(p.t + off, sw, nf);
    __syncthreads();
    if (tid < cnt) {
#pragma unroll
      for (int i = 0; i < kD; ++i)
#pragma unroll
        for (int j = i; j < kD; ++j)
          T[tri<kD>(i, j)] = i == j ? mw[i * kD + i] : 0.5f * (mw[i * kD + j] + mw[j * kD + i]);
      omc::project_psd_small_sym<kD>(T, W);
#pragma unroll
      for (int i = 0; i < kD; ++i)
#pragma unroll
        for (int j = 0; j < kD; ++j) mw[i * kD + j] = W[tri<kD>(i, j)];
    }
    __syncthreads();
    omc::store_block<kThreads7>(p.w + off, sw, nf);
    return;
  }

  omc::load_block<kThreads7>(p.w + off, sw, nf);
  omc::load_block<kThreads7>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::load_block<kThreads7>(p.acc + off, sa, nf);
  // fused mode: gather the minor's 15 distinct entries (omc _forward_shor)
  // while the blocks arrive
  const bool act = tid < cnt;
  float x11 = 0.f, x12 = 0.f, x21 = 0.f, x22 = 0.f, w11 = 0.f, w12 = 0.f, w21 = 0.f, w22 = 0.f;
  float V1a = 0.f, V1b = 0.f, V2a = 0.f, V2b = 0.f, V3 = 0.f, sS = 0.f, mask = 0.f, rho = 0.f;
  if (act) {
    const int g = base + tid;
    const int b = g / p.M5;
    const int4 mi = reinterpret_cast<const int4*>(p.minor_idx)[g];  // (i1, i2, j1, j2)
    const float* X = p.Xs + (size_t)b * p.nm;
    const float* Wv = p.Ws + (size_t)b * p.nm;
    const int f11 = mi.x * p.m + mi.z, f12 = mi.x * p.m + mi.w;
    const int f21 = mi.y * p.m + mi.z, f22 = mi.y * p.m + mi.w;
    x11 = X[f11], x12 = X[f12], x21 = X[f21], x22 = X[f22];
    w11 = Wv[f11], w12 = Wv[f12], w21 = Wv[f21], w22 = Wv[f22];
    V1a = p.v1[(size_t)b * p.P1 + p.iv1a[g]];
    V1b = p.v1[(size_t)b * p.P1 + p.iv1b[g]];
    V2a = p.v2[(size_t)b * p.P2 + p.iv2a[g]];
    V2b = p.v2[(size_t)b * p.P2 + p.iv2b[g]];
    V3 = p.v3[(size_t)b * p.P3 + p.iv3[g]];
    sS = p.sS[b], mask = p.minor_mask[g], rho = p.rho[b];
  }
  __syncthreads();
  if (act) {
    const float F[kD][kD] = {
        {1.f, x11, x12, x21, x22},
        {x11, w11, V1a, V2a, V3},
        {x12, V1a, w12, V3, V2b},
        {x21, V2a, V3, w21, V1b},
        {x22, V3, V2b, V1b, w22},
    };
    const float alpha = p.alpha, om = 1.0f - p.alpha;
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = i; j < kD; ++j) {
        const float tij = (alpha * (sS * F[i][j]) + om * mw[i * kD + j]) + mu[i * kD + j];
        const float tji = (alpha * (sS * F[j][i]) + om * mw[j * kD + i]) + mu[j * kD + i];
        T[tri<kD>(i, j)] = i == j ? tij : 0.5f * (tij + tji);
      }
    omc::project_psd_small_sym<kD>(T, W);
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int q = i * kD + j;
        const float u = (T[tri<kD>(i, j)] - W[tri<kD>(i, j)]) * mask;
        mw[q] = W[tri<kD>(i, j)];
        mu[q] = u;
        if (p.acc != nullptr) ma[q] = ma[q] + p.beta * (rho * u - ma[q]);
      }
  }
  __syncthreads();
  omc::store_block<kThreads7>(p.w + off, sw, nf);
  omc::store_block<kThreads7>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::store_block<kThreads7>(p.acc + off, sa, nf);
}

// The float64 build's fused mode: the minor slots' gather, mix, exact
// projection by Jacobi, u-step and EMA (t null; see the header).
__global__ void __launch_bounds__(kThreads7d) k7_kernel_f64(K7ParamsT<double> p) {
  __shared__ double2 k7d_smem[3 * kThreads7d * kD5 / 2];
  double* sw = reinterpret_cast<double*>(k7d_smem);
  double* su = sw + kThreads7d * kD5;
  double* sa = su + kThreads7d * kD5;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads7d;
  const int cnt = min(kThreads7d, p.N - base);
  const int nf = cnt * kD5;
  const size_t off = (size_t)base * kD5;
  double* mw = sw + tid * kD5;
  double* mu = su + tid * kD5;
  double* ma = sa + tid * kD5;

  omc::load_block<kThreads7d>(p.w + off, sw, nf);
  omc::load_block<kThreads7d>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::load_block<kThreads7d>(p.acc + off, sa, nf);
  const bool act = tid < cnt;
  double x11 = 0, x12 = 0, x21 = 0, x22 = 0, w11 = 0, w12 = 0, w21 = 0, w22 = 0;
  double V1a = 0, V1b = 0, V2a = 0, V2b = 0, V3 = 0, sS = 0, mask = 0, rho = 0;
  if (act) {
    const int g = base + tid;
    const int b = g / p.M5;
    const int4 mi = reinterpret_cast<const int4*>(p.minor_idx)[g];  // (i1, i2, j1, j2)
    const double* X = p.Xs + (size_t)b * p.nm;
    const double* Wv = p.Ws + (size_t)b * p.nm;
    const int f11 = mi.x * p.m + mi.z, f12 = mi.x * p.m + mi.w;
    const int f21 = mi.y * p.m + mi.z, f22 = mi.y * p.m + mi.w;
    x11 = X[f11], x12 = X[f12], x21 = X[f21], x22 = X[f22];
    w11 = Wv[f11], w12 = Wv[f12], w21 = Wv[f21], w22 = Wv[f22];
    V1a = p.v1[(size_t)b * p.P1 + p.iv1a[g]];
    V1b = p.v1[(size_t)b * p.P1 + p.iv1b[g]];
    V2a = p.v2[(size_t)b * p.P2 + p.iv2a[g]];
    V2b = p.v2[(size_t)b * p.P2 + p.iv2b[g]];
    V3 = p.v3[(size_t)b * p.P3 + p.iv3[g]];
    sS = p.sS[b], mask = p.minor_mask[g], rho = p.rho[b];
  }
  __syncthreads();
  if (act) {
    const double F[kD][kD] = {
        {1.0, x11, x12, x21, x22},
        {x11, w11, V1a, V2a, V3},
        {x12, V1a, w12, V3, V2b},
        {x21, V2a, V3, w21, V1b},
        {x22, V3, V2b, V1b, w22},
    };
    const double alpha = p.alpha, om = 1.0 - p.alpha;
    // t5 = sym(alpha f5 + (1 - alpha) w5 + u5): A's upper triangle, and in
    // the u5 block for the u-step
    double A[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = i; j < kD; ++j) {
        const double tij = (alpha * (sS * F[i][j]) + om * mw[i * kD + j]) + mu[i * kD + j];
        const double tji = (alpha * (sS * F[j][i]) + om * mw[j * kD + i]) + mu[j * kD + i];
        const double t = i == j ? tij : 0.5 * (tij + tji);
        A[i][j] = t;
        mu[i * kD + j] = t;
        mu[j * kD + i] = t;
      }
    const double beta = p.beta;
    const bool ema = p.acc != nullptr;
    k4s::project_psd<kD>(A, [&](int i, int j, double w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && i == j) break;
        const int q = h == 0 ? i * kD + j : j * kD + i;
        const double u = (mu[q] - w) * mask;
        mw[q] = w;
        mu[q] = u;
        if (ema) ma[q] = ma[q] + beta * (rho * u - ma[q]);
      }
    });
  }
  __syncthreads();
  omc::store_block<kThreads7d>(p.w + off, sw, nf);
  omc::store_block<kThreads7d>(p.u + off, su, nf);
  if (p.acc != nullptr) omc::store_block<kThreads7d>(p.acc + off, sa, nf);
}

}  // namespace

// minors (threads) a CTA and its static staging bytes, for the operands'
// element size (4, or 8 for the float64 build; sdp.admm_shor.k7_plan plans
// with them, chip_smoke.py holds the plan against them)
OMC_EXPORT int omc_k7_threads(int elem) { return elem == 8 ? kThreads7d : kThreads7; }

OMC_EXPORT long long omc_k7_smem_bytes(int elem) {
  return 3LL * omc_k7_threads(elem) * kD5 * elem;
}

OMC_EXPORT int omc_k7_minor_psd_f64(const K7ParamsT<double>* params, void* stream) {
  const K7ParamsT<double>& p = *params;
  if (p.t != nullptr) return (int)cudaErrorInvalidValue;  // no projection mode in float64
  if (p.N > 0) {
    const int grid = (p.N + kThreads7d - 1) / kThreads7d;
    k7_kernel_f64<<<grid, kThreads7d, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

OMC_EXPORT int omc_k7_minor_psd(const K7Params* params, void* stream) {
  const K7Params& p = *params;
  if (p.N > 0) {
    const int grid = (p.N + kThreads7 - 1) / kThreads7;
    k7_kernel<<<grid, kThreads7, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
