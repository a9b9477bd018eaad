// Shared helpers and the C parameter blocks of the omc_torch kernels.
//
// Every entry point takes a pointer to its parameter block (laid out like
// the ctypes.Structure of the same name in omc_torch/kernels.py), launches
// on the given stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#define OMC_EXPORT extern "C" __attribute__((visibility("default")))

namespace omc {

constexpr int kThreads = 256;

// (a, b, c) per step of the sign schedule (omc/ops/polar.py _SIGN_SCHEDULE):
// 12 quintic steps, then 2 cubic Newton-Schulz polish steps (c = 0); one
// table for device code; OMC_SIGN_SCHED also gives host code its copy
#define OMC_SIGN_SCHED                                                     \
  {                                                                        \
    {3.521451f, -7.154590f, 3.634029f}, {3.406982f, -6.751032f, 4.344051f}, \
    {4.115155f, -11.482394f, 8.367240f}, {3.562198f, -7.405884f, 3.849440f}, \
    {3.811135f, -9.095166f, 5.427381f}, {4.202972f, -12.190019f, 8.987046f}, \
    {4.176513f, -11.973807f, 8.797295f}, {4.110213f, -12.007850f, 8.897637f}, \
    {4.062958f, -11.075007f, 8.012057f}, {3.454039f, -6.995438f, 4.470346f}, \
    {2.364441f, -2.438842f, 1.074450f}, {2.135440f, -1.778817f, 0.643428f},  \
    {1.5f, -0.5f, 0.0f}, {1.5f, -0.5f, 0.0f},                              \
  }
static __constant__ float kSignSched[14][3] = OMC_SIGN_SCHED;
constexpr int kSignSteps = 14;

// (T: float, or double in the float64 builds)
template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; every thread gets the result.  `red` holds >= 32 values
// of shared memory; the call contains two __syncthreads().
template <class T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = 0;
  const int nw = (blockDim.x + 31) >> 5;
  for (int i = 0; i < nw; ++i) r += red[i];
  __syncthreads();
  return r;
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// A read-only view of a kernel input: loads go through the non-coherent
// path (ld.global.nc), which the compiler may schedule ahead of the
// kernel's own stores.  Only for data the kernel does not write.
template <class T>
struct ROT {
  const T* p;
  template <class I>
  __device__ __forceinline__ T operator[](I i) const { return __ldg(p + i); }
};
using RO = ROT<float>;

// the float64 builds' quiet NaN and infinity beside float32's
__device__ __forceinline__ float qnan_of(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double qnan_of(double) { return __longlong_as_double(0x7fffffffffffffffLL); }
__device__ __forceinline__ float inf_of(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double inf_of(double) { return __longlong_as_double(0x7ff0000000000000LL); }

// 16 bytes of T: four floats, or two doubles in the float64 builds
template <class T>
using Vec16 = typename std::conditional<sizeof(T) == 8, double2, float4>::type;

// nf values of T from global g (16-byte aligned at its start, or the copy
// goes a value at a time) into shared s, and back: a CTA's NT threads on
// consecutive 16-byte words (K7's and K7t's staged records)
template <int NT, class T>
__device__ __forceinline__ void load_block(const T* g, T* s, int nf) {
  constexpr int kSh = sizeof(T) == 8 ? 1 : 2, kPer = 1 << kSh;  // values a word
  const int n4 = (reinterpret_cast<uintptr_t>(g) & 15) ? 0 : nf >> kSh;
  for (int q = threadIdx.x; q < n4; q += NT)
    reinterpret_cast<Vec16<T>*>(s)[q] = reinterpret_cast<const Vec16<T>*>(g)[q];
  for (int q = kPer * n4 + threadIdx.x; q < nf; q += NT) s[q] = g[q];
}

template <int NT, class T>
__device__ __forceinline__ void store_block(T* g, const T* s, int nf) {
  constexpr int kSh = sizeof(T) == 8 ? 1 : 2, kPer = 1 << kSh;
  const int n4 = (reinterpret_cast<uintptr_t>(g) & 15) ? 0 : nf >> kSh;
  for (int q = threadIdx.x; q < n4; q += NT)
    reinterpret_cast<Vec16<T>*>(g)[q] = reinterpret_cast<const Vec16<T>*>(s)[q];
  for (int q = kPer * n4 + threadIdx.x; q < nf; q += NT) g[q] = s[q];
}

// 1 / x to the float64 rounding level: the hardware's approximate
// reciprocal refined by two Newton steps (no call to the IEEE divide's
// slow path, around which ptxas spilled in K4s's float64 build).  x is a
// normal nonzero number.
__device__ __forceinline__ double rcp(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
}

// a / b: the IEEE quotient in float; in double a * rcp(b) corrected once
// (within an ulp).  b is a normal nonzero number.
__device__ __forceinline__ float quot(float a, float b) { return a / b; }
__device__ __forceinline__ double quot(double a, double b) {
  const double q = rcp(b), y = a * q;
  return fma(q, fma(-b, y, a), y);
}

// x * y rounded to nearest, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }

// an odd row stride >= n for a shared-memory band: a column of it, read or
// written by consecutive lanes, then falls in distinct banks
__host__ __device__ __forceinline__ int odd_ld(int n) { return n | 1; }

// rows [lo, hi) of N split over C owners as evenly as possible: every
// owner gets floor(N / C) or cdiv(N, C) rows
__device__ __forceinline__ int band_lo(int N, int C, int r) { return (int)((long long)r * N / C); }

// (i, j) = divmod(e, W) for 0 <= e < 2^24 through a float reciprocal
// inv = 1 / W, corrected by one step: a few instructions, no division
__device__ __forceinline__ void divmod(int e, int W, float inv, int& i, int& j) {
  i = __float2int_rz(((float)e + 0.5f) * inv);
  j = e - i * W;
  if (j < 0) --i, j += W;
  else if (j >= W) ++i, j -= W;
}

// The items (i, j) of an R x W grid, e = i W + j from `start` in steps of
// `stride` (a CTA's threads, or a cluster's): consecutive threads take
// consecutive j, so a row-major operand is read coalesced (a column band of
// width W as runs of W).  ld(i, j) loads an item's values and st(i, j, v)
// uses them; a thread loads kB items before it uses any, so their loads are
// in flight together.
template <int kB, class Ld, class St>
__device__ __forceinline__ void grid_items(int R, int W, int start, int stride, Ld ld, St st) {
  const int tot = R * W;
  const float inv = 1.0f / (float)W;
  for (int e0 = start; e0 < tot; e0 += kB * stride) {
    decltype(ld(0, 0)) v[kB];
    int ii[kB], jj[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int e = e0 + u * stride;
      if (e < tot) {
        divmod(e, W, inv, ii[u], jj[u]);
        v[u] = ld(ii[u], jj[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u)
      if (e0 + u * stride < tot) st(ii[u], jj[u], v[u]);
  }
}

// The sum over the cluster's C CTAs, in rank order, of each CTA's part[q],
// q < NP, into tot[q]: one remote load a thread for each (q, rank) pair, all
// in flight together, gathered in stage[] (C NP doubles), then the sums.
// Ends with __syncthreads(); the caller has passed a cluster barrier since
// every CTA wrote its part.
template <class Cluster>
__device__ __forceinline__ void cluster_sum(Cluster& cluster, const double* part, double* stage,
                                            double* tot, int NP, int C) {
  for (int e = threadIdx.x; e < NP * C; e += blockDim.x) {
    const int r = e / NP;
    stage[e] = *cluster.map_shared_rank(part + (e - r * NP), r);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < NP; q += blockDim.x) {
    double s = 0.0;
    for (int r = 0; r < C; ++r) s += stage[r * NP + q];
    tot[q] = s;
  }
  __syncthreads();
}

// The same sum where each CTA's partials lie in global memory, rank r's at
// part0 + r * stride, each thread's writes fenced (__threadfence) before the
// cluster barrier the caller has passed: read through L2, in rank order (the
// same bits as cluster_sum).  Ends with __syncthreads().
__device__ __forceinline__ void cluster_sum_global(const double* part0, size_t stride,
                                                   double* tot, int NP, int C) {
  for (int q = threadIdx.x; q < NP; q += blockDim.x) {
    double s = 0.0;
    for (int r = 0; r < C; ++r) s += __ldcg(part0 + r * stride + q);
    tot[q] = s;
  }
  __syncthreads();
}

// the two halves of a thread-block cluster barrier (every thread of every
// CTA of the cluster calls both, in turn): arrive releases this CTA's
// shared-memory writes, wait acquires the others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The index of entry (i, j) of a symmetric D x D matrix held as its upper
// triangle, row by row (kTri<D> floats): (j, i) for i > j.
template <int D>
constexpr int kTri = D * (D + 1) / 2;
template <int D>
__host__ __device__ __forceinline__ constexpr int tri(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i) : j * D - j * (j - 1) / 2 + (i - j);
}

// C = A B for commuting symmetric D x D matrices held as upper triangles:
// the upper triangle of the product only (D (D + 1) / 2 entries of D FMAs,
// each summed in order of k), so C is exactly symmetric
template <int D>
__device__ __forceinline__ void mm_sym(const float (&A)[D * (D + 1) / 2],
                                       const float (&B)[D * (D + 1) / 2],
                                       float (&C)[D * (D + 1) / 2]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      float c = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) c = fmaf(A[tri<D>(i, k)], B[tri<D>(k, j)], c);
      C[tri<D>(i, j)] = c;
    }
}

// Sign-schedule PSD projection of one symmetric D x D matrix held by one
// thread as its upper triangle T (the caller symmetrises; K7, K7t, K7x;
// plain version: omc_torch.ops.polar.project_psd_ns_small): W = (T +
// sign(T) T) / 2, with sign(T) from the 12 quintic + 2 cubic steps of
// kSignSched on T / ||T||_F (43 products).  Every iterate is a polynomial in
// T, so every product is one of commuting symmetric matrices and takes its
// upper triangle only (mm_sym; 43 x 75 FMAs for D = 5, not 43 x 125), and W
// comes out exactly symmetric.  Four triangles of state.  CPU mirror:
// omc_torch.ops.polar.project_psd_ns with symmetric_matmul().
template <int D>
__device__ __forceinline__ void project_psd_small_sym(const float (&T)[D * (D + 1) / 2],
                                                      float (&W)[D * (D + 1) / 2]) {
  constexpr int NT = D * (D + 1) / 2;
  float ss = 0.f;  // ||T||_F^2 over the full matrix, row by row
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) ss = fmaf(T[tri<D>(i, j)], T[tri<D>(i, j)], ss);
  const float s = sqrtf(ss) + 1e-30f;
  float S[NT], S2[NT], M[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) S[q] = T[q] / s;
  for (int step = 0; step < kSignSteps; ++step) {
    const float a = kSignSched[step][0], b = kSignSched[step][1], c = kSignSched[step][2];
    mm_sym<D>(S, S, S2);
    if (c != 0.f) {
      mm_sym<D>(S2, S2, M);  // S^4
#pragma unroll
      for (int q = 0; q < NT; ++q) M[q] = b * S2[q] + c * M[q];
      mm_sym<D>(S, M, S2);   // S (b S^2 + c S^4)
#pragma unroll
      for (int q = 0; q < NT; ++q) S[q] = a * S[q] + S2[q];
    } else {
      mm_sym<D>(S, S2, M);   // S^3
#pragma unroll
      for (int q = 0; q < NT; ++q) S[q] = a * S[q] + b * M[q];
    }
  }
  mm_sym<D>(S, T, M);
#pragma unroll
  for (int q = 0; q < NT; ++q) W[q] = 0.5f * (T[q] + M[q]);
}

// projection onto {(u, v, x): 2 u v >= x^2, u, v >= 0} through the standard
// SOC of (t, s, x) = ((u+v)/sqrt2, (u-v)/sqrt2, x)  (omc/ops/cones.py
// project_rsoc in closed form)
__device__ __forceinline__ void project_rsoc1(float u, float v, float x, float& pu, float& pv,
                                              float& px) {
  const float s2 = sqrtf(2.0f);
  const float t = (u + v) / s2, s = (u - v) / s2;
  const float nz = sqrtf(s * s + x * x);
  float tp, zs, zx;
  if (nz <= t) {
    tp = t, zs = s, zx = x;
  } else if (nz <= -t) {
    tp = 0.f, zs = 0.f, zx = 0.f;
  } else {
    const float scale = nz > 0.f ? 0.5f * (1.0f + t / nz) : 0.f;
    tp = 0.5f * (t + nz), zs = scale * s, zx = scale * x;
  }
  pu = (tp + zs) / s2;
  pv = (tp - zs) / s2;
  px = zx;
}

// The float64 builds': the same cases, with 1/sqrt2 as a product, ||(s,
// x)|| as n2 rsqrt(n2) and t / ||(s, x)|| as t rsqrt(n2) (no IEEE divide or
// square root: their slow-path calls made ptxas spill in K4s's float64
// build)
__device__ __forceinline__ void project_rsoc1(double u, double v, double x, double& pu,
                                              double& pv, double& px) {
  constexpr double kInvS2 = 0.70710678118654752440;
  const double t = (u + v) * kInvS2, s = (u - v) * kInvS2;
  const double n2 = s * s + x * x;
  const double inv = n2 > 0.0 ? rsqrt(n2) : 0.0;
  const double nz = n2 * inv;
  double tp, zs, zx;
  if (nz <= t) {
    tp = t, zs = s, zx = x;
  } else if (nz <= -t) {
    tp = 0.0, zs = 0.0, zx = 0.0;
  } else {  // nz > |t| >= 0
    const double scale = 0.5 * (1.0 + t * inv);
    tp = 0.5 * (t + nz), zs = scale * s, zx = scale * x;
  }
  pu = (tp + zs) * kInvS2;
  pv = (tp - zs) * kInvS2;
  px = zx;
}

// ---- the cone steps' shared parts (K8b, K8d; T float, or double in K8b's
// float64 build) ----

// one RSOC row (0.5, W, X) at the primal (x, w), scaled by sS, against its
// slot r, dual u and EMA a (updated in place; sm the row's mask)
template <class T>
__device__ __forceinline__ void rsoc_row(T x, T w, T sm, T sS, T rho, T alpha, T beta,
                                         T (&r)[3], T (&u)[3], T (&a)[3]) {
  const T om = T(1) - alpha;
  const T fr[3] = {sS * T(0.5), sS * w, sS * x};
  T t[3], pr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] = (alpha * fr[c] + om * r[c]) + u[c];
  project_rsoc1(t[0], t[1], t[2], pr[0], pr[1], pr[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T uc = (t[c] - pr[c]) * sm;
    r[c] = pr[c];
    u[c] = uc;
    a[c] = a[c] + beta * (rho * uc - a[c]);
  }
}

// a nonnegative slot (wp, up) at the primal w scaled by sS, updated in place
template <class T>
__device__ __forceinline__ void nonneg_slot(T w, T sS, T alpha, T& wp, T& up) {
  const T tp = (alpha * (sS * w) + (T(1) - alpha) * wp) + up;
  const T wn = fmax(tp, T(0));
  wp = wn;
  up = tp - wn;
}

// value c of a 16-byte word
__device__ __forceinline__ float& lane4(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& lane4(double2& v, int c) { return c == 0 ? v.x : v.y; }

// The Theta-link rows of columns [32 tile, 32 tile + 32) of slot b, by a CTA
// of 128 threads: 4 row groups of 32 columns, group g summing sW W_ij over
// the rows i = g (mod 4) in row order, then the 4 partials in order (no
// atomics: the same bits every run); then, a zero cone, t_l = alpha (sT
// Theta_jj - sum) + ul, wl = 0, ul = t_l and the EMA of rho ul.  P is a
// parameter block with Ws, Ths, sX, sT, rho, wl, ul, acc_l, n, m, alpha,
// beta (of float, or double in K8b's float64 build).
constexpr int kLinkCols = 32, kLinkRows = 4;

template <class P>
__device__ __forceinline__ void link_rows(const P& p, int b, int tile) {
  using T = typename std::remove_cv<typename std::remove_pointer<decltype(P::Ws)>::type>::type;
  __shared__ T part[kLinkRows][kLinkCols];
  const int lane = threadIdx.x % kLinkCols, g = threadIdx.x / kLinkCols;
  const int n = p.n, m = p.m, j = tile * kLinkCols + lane;
  const T* __restrict__ W = p.Ws + (size_t)b * n * m;
  const T sW = __ldg(p.sX + b) * __ldg(p.sX + b);
  // the row's other operands, loaded while the sums' loads are in flight
  const size_t ql = (size_t)b * m + j;
  const bool own = g == 0 && j < m;
  T th = 0, ul = 0, al = 0;
  if (own) th = __ldg(p.Ths + (size_t)b * m * m + (size_t)j * m + j), ul = p.ul[ql], al = p.acc_l[ql];
  const T sT = __ldg(p.sT + b), rho = __ldg(p.rho + b);
  T s = 0;
  if (j < m) {
#pragma unroll 8
    for (int i = g; i < n; i += kLinkRows) s += mul_rn(sW, __ldg(W + (size_t)i * m + j));
  }
  part[g][lane] = s;
  __syncthreads();
  if (own) {
    T tot = 0;
#pragma unroll
    for (int r = 0; r < kLinkRows; ++r) tot += part[r][lane];
    const T tl = p.alpha * (sT * th - tot) + ul;
    p.wl[ql] = T(0);
    p.ul[ql] = tl;
    p.acc_l[ql] = al + p.beta * (rho * tl - al);
  }
}

// A warp's block of RSOC triples: the nf = 3 cnt values (cnt <= 32 E rows,
// E = 16 / sizeof(T) values a 16-byte word: 4 floats, 2 doubles) of wr, ur
// and acc_r from offset off (16-byte aligned), staged through the warp's
// shared block s (3 x 96 16-byte words: wr's, ur's, acc_r's) by consecutive
// lanes in 16-byte words, each lane's loads issued before its stores.  A
// lane then holds its E rows' 3 E values of each array as the words 3 lane
// .. 3 lane + 2 (a 48-byte stride: no bank conflicts).
template <class T>
__device__ __forceinline__ void triples_in(const T* __restrict__ wr, const T* __restrict__ ur,
                                           const T* __restrict__ ar, size_t off, int nf,
                                           Vec16<T>* s, int lane) {
  using V = Vec16<T>;
  constexpr int kW4 = 3 * 32, kSh = sizeof(T) == 8 ? 1 : 2, E = 1 << kSh;
  const int n4 = nf >> kSh;
  const V* gr = reinterpret_cast<const V*>(wr + off);
  const V* gu = reinterpret_cast<const V*>(ur + off);
  const V* ga = reinterpret_cast<const V*>(ar + off);
  V vr[3], vu[3], va[3];
#pragma unroll
  for (int h = 0; h < 3; ++h)
    if (lane + 32 * h < n4) vr[h] = gr[lane + 32 * h], vu[h] = gu[lane + 32 * h], va[h] = ga[lane + 32 * h];
#pragma unroll
  for (int h = 0; h < 3; ++h)
    if (lane + 32 * h < n4) s[lane + 32 * h] = vr[h], s[kW4 + lane + 32 * h] = vu[h],
                            s[2 * kW4 + lane + 32 * h] = va[h];
  T* fs = reinterpret_cast<T*>(s);
  for (int q = E * n4 + lane; q < nf; q += 32)
    fs[q] = wr[off + q], fs[E * kW4 + q] = ur[off + q], fs[2 * E * kW4 + q] = ar[off + q];
}

template <class T>
__device__ __forceinline__ void triples_out(T* __restrict__ wr, T* __restrict__ ur,
                                            T* __restrict__ ar, size_t off, int nf,
                                            const Vec16<T>* s, int lane) {
  using V = Vec16<T>;
  constexpr int kW4 = 3 * 32, kSh = sizeof(T) == 8 ? 1 : 2, E = 1 << kSh;
  const int n4 = nf >> kSh;
  V* gr = reinterpret_cast<V*>(wr + off);
  V* gu = reinterpret_cast<V*>(ur + off);
  V* ga = reinterpret_cast<V*>(ar + off);
#pragma unroll
  for (int h = 0; h < 3; ++h)
    if (lane + 32 * h < n4) gr[lane + 32 * h] = s[lane + 32 * h],
                            gu[lane + 32 * h] = s[kW4 + lane + 32 * h],
                            ga[lane + 32 * h] = s[2 * kW4 + lane + 32 * h];
  const T* fs = reinterpret_cast<const T*>(s);
  for (int q = E * n4 + lane; q < nf; q += 32)
    wr[off + q] = fs[q], ur[off + q] = fs[E * kW4 + q], ar[off + q] = fs[2 * E * kW4 + q];
}

// The RSOC rows e < rem of a lane's E rows from its staged words (s, the
// warp's block, as triples_in leaves it: float4 or double2 words), at the
// primal (x, w) of each row with its mask, scale and rho; the results back
// into the same words.
template <class V, class Row>
__device__ __forceinline__ void triples_update(V* s, int lane, int rem, Row row) {
  using T = decltype(V::x);
  constexpr int kW4 = 3 * 32, E = 16 / sizeof(T);
  V r4[3], v4[3], a4[3];
#pragma unroll
  for (int h = 0; h < 3; ++h) r4[h] = s[3 * lane + h], v4[h] = s[kW4 + 3 * lane + h],
                              a4[h] = s[2 * kW4 + 3 * lane + h];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e >= rem) continue;
    T r[3], u[3], a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = lane4(r4[(3 * e + c) / E], (3 * e + c) % E);
      u[c] = lane4(v4[(3 * e + c) / E], (3 * e + c) % E);
      a[c] = lane4(a4[(3 * e + c) / E], (3 * e + c) % E);
    }
    row(e, r, u, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lane4(r4[(3 * e + c) / E], (3 * e + c) % E) = r[c];
      lane4(v4[(3 * e + c) / E], (3 * e + c) % E) = u[c];
      lane4(a4[(3 * e + c) / E], (3 * e + c) % E) = a[c];
    }
  }
#pragma unroll
  for (int h = 0; h < 3; ++h) s[3 * lane + h] = r4[h], s[kW4 + 3 * lane + h] = v4[h],
                              s[2 * kW4 + 3 * lane + h] = a4[h];
}

// ---- Jacobi eigensolver core (K4, K4s, K5; mirror: omc_torch/ops/jacobi.py)

// sweeps before the loop gives up; a sweep count of kJacobiMaxSweeps + 1
// means the cap was hit
constexpr int kJacobiMaxSweeps = 30;

// The floor of the stopping rule: eps ||A||_F / (4 d), or NaN for a
// non-finite matrix, so that every pair then rotates until the cap.  eps is
// the operands' own: FLT_EPSILON, or DBL_EPSILON in the float64 builds
// (the CPU mirror's torch.finfo(dtype).eps).
__device__ __forceinline__ float jacobi_floor(float normF, int d) {
  return isfinite(normF) ? FLT_EPSILON * normF / (4.f * d) : __int_as_float(0x7fffffff);
}
__device__ __forceinline__ double jacobi_floor(double normF, int d) {
  return isfinite(normF) ? DBL_EPSILON * normF / (4.0 * d) : qnan_of(0.0);
}

// One rotation of the pair (p, q) of a symmetric matrix (Golub & Van Loan,
// sym.schur2): false when the pair is skipped, |a_pq| <= max(eps
// sqrt|a_pp| sqrt|a_qq|, floor) (a NaN fails the test, so it rotates);
// else t, s and r = s / (1 + c) of Rutishauser's update form.
__device__ __forceinline__ bool jacobi_rotation(float app, float aqq, float apq, float floor_,
                                                float& t, float& s, float& r) {
  const float rel = FLT_EPSILON * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq));
  const float thr = rel > floor_ ? rel : floor_;
  if (fabsf(apq) <= thr) return false;
  const float tau = (aqq - app) / (2.f * apq);
  t = copysignf(1.f, tau) / (fabsf(tau) + hypotf(1.f, tau));
  const float c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
  r = s / (1.f + c);
  return true;
}

__device__ __forceinline__ bool jacobi_rotation(double app, double aqq, double apq,
                                                double floor_, double& t, double& s, double& r) {
  const double rel = DBL_EPSILON * sqrt(fabs(app)) * sqrt(fabs(aqq));
  const double thr = rel > floor_ ? rel : floor_;
  if (fabs(apq) <= thr) return false;
  const double tau = (aqq - app) / (2.0 * apq);
  t = copysign(1.0, tau) / (fabs(tau) + hypot(1.0, tau));
  const double c = 1.0 / sqrt(1.0 + t * t);
  s = t * c;
  r = s / (1.0 + c);
  return true;
}

// (c x - s y, s x + c y) in Rutishauser's form: the rounding error is
// relative to the change, so small late-sweep angles keep V orthogonal
template <class T>
__device__ __forceinline__ void jacobi_rot(T& x, T& y, T s, T r) {
  const T x0 = x, y0 = y;
  x = x0 - s * (y0 + r * x0);
  y = y0 + s * (x0 - r * y0);
}

// The wide kernels' systems (K6's wide path, K9s/K9a's wide kernels), any
// order D, solved by one warp in memory (shared or global; ix(i, j) the
// offset of entry (i, j)), every sum in a fixed order.  warp_cholesky: the
// lower Cholesky factor in place of the lower triangle, by columns, column
// j's pivot from the lanes' partial sums (xor shuffles), then its rows over
// the lanes, each a sequential dot product.
template <class T, class Ix>
__device__ __forceinline__ void warp_cholesky(T* G, int D, Ix ix) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < D; ++j) {
    T s = 0;
    for (int l = lane; l < j; l += 32) s = fma(G[ix(j, l)], G[ix(j, l)], s);
    const T djj = sqrt(G[ix(j, j)] - warp_sum(s));
    __syncwarp();
    if (lane == 0) G[ix(j, j)] = djj;
    for (int i = j + 1 + lane; i < D; i += 32) {
      T v = G[ix(i, j)];
      for (int l = 0; l < j; ++l) v -= G[ix(i, l)] * G[ix(j, l)];
      G[ix(i, j)] = v / djj;
    }
    __syncwarp();
  }
}

// x <- (L L')^-1 x by one warp, L from warp_cholesky and x(i) a reference
// to entry i: L y = x from row `from` on (x is zero above it), each y_i's
// dot product over the lanes (xor shuffles), then L' x = y with x_i taken
// from the entries above it over the lanes
template <class T, class Ix, class Xs>
__device__ __forceinline__ void warp_cho_solve(const T* L, int D, Ix ix, Xs x, int from = 0) {
  const int lane = threadIdx.x & 31;
  for (int i = from; i < D; ++i) {
    T s = 0;
    for (int l = from + lane; l < i; l += 32) s = fma(L[ix(i, l)], x(l), s);
    const T v = (x(i) - warp_sum(s)) / L[ix(i, i)];
    __syncwarp();
    if (lane == 0) x(i) = v;
    __syncwarp();
  }
  for (int i = D - 1; i >= 0; --i) {
    const T v = x(i) / L[ix(i, i)];
    __syncwarp();
    if (lane == 0) x(i) = v;
    for (int l = lane; l < i; l += 32) x(l) -= L[ix(i, l)] * v;
    __syncwarp();
  }
}

}  // namespace omc

struct K1Params {
  const float* t[3];   // (B, D_g, D_g) pre-projection blocks
  float* w[3];         // (B, D_g, D_g) projections
  float* u[3];         // (B, D_g, D_g) u = t - w, or null
  float* acc[3];       // (B, D_g, D_g) EMA of rho*u, or null
  float* scratch[3];   // tiles path: (B, 4, Dp, ld) working matrices, then
                       // B x ceil(Dp / 64) partial sums (Dp = D_g rounded up
                       // to 16, ld its row stride); null on the cluster path
  long long scratch_floats[3];  // floats of scratch[g]: the launch refuses
                                // less than omc_k1_scratch_floats(D_g, B)
  int D[3];
  int G;
  int B;
  int C;               // CTAs per cluster (1..8, cluster path), 0 for the tiles path
  const float* rho;    // (B,), needed when some acc is given
  float beta;
};

// K2's, K3's, K7's, K8a's, K8b's, K4's, K5's, K4s's and K6's blocks (and
// K7t's, K7x's, K8c's, K8d's, K9s's, K9a's and K9b's below) are templates
// on the element type T: float, or double for the float64 builds (the entry points named
// ..._f64; the ctypes blocks of omc_torch/kernels.py with c_double
// scalars).  The float blocks keep their names.
template <class T>
struct K2ParamsT {
  const T *w1, *u1, *w2, *u2, *w3, *u3, *w4, *u4, *wsoc, *usoc, *wbox,
      *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  const T *cut_x, *cut_lo, *cut_hi, *cut_mask;
  const T *maskA, *mask;  // (n, m): mask * A and the 0/1 mask
  const T *sX, *sT, *rho;  // (B,)
  const T* G1i;            // (B, p, p) inverse of G1
  T *Xs, *Y, *Ths, *U;     // outputs (Xs, Ths null: Y and U only)
  double* ws;              // null, or the partials of s and the p- and L k-sized
                           // vectors in global memory (omc_k2_ws_doubles a slot)
  int B, n, m, k, L;
  int C;                   // CTAs per cluster, one cluster per slot (1..16)
  int band;                // 1: sym(zY) bands in shared memory; 0: in Y's rows
  int xsmem;               // 1: the cut vectors staged in shared memory
  int usmem;               // 1: the band's zU in shared memory; 0: in U's rows
  T gamma;
};
using K2Params = K2ParamsT<float>;

template <class T>
struct K3ParamsT {
  const T *Xs, *Y, *Ths, *U;
  const T *w1, *u1, *w2, *u2, *w3, *u3;
  T *t1, *t2, *t3;
  T *w4, *u4, *wsoc, *usoc, *wbox, *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  T *acc_a, *acc_b, *acc_c;
  const T *cut_x, *cut_lo, *cut_hi, *cut_mask, *U_lo, *U_hi;
  const T *sX, *sT, *rho;
  double* ws;              // null, or the partials in global memory
                           // (omc_k3_ws_doubles a slot)
  // the Halpern mode's anchors s0 = w + u of the nine slots at the solve
  // call's start (each shaped as its slot), or all null: the normal mode
  const T *h1, *h2, *h3, *h4, *hsoc, *hbox, *ha, *hb, *hc;
  int B, n, m, k, L;
  int C;                   // CTAs per cluster, one cluster per slot (1..16)
  int xsmem;               // 1: the cut vectors staged in shared memory
  int slsmem;              // 1: rank 0 stages the trace, interval and chord slots
  int hal_it;              // the Halpern mode's iteration index in the call
  int usmem;               // 1: U staged in shared memory; 0: read from the input
  T alpha, beta;
};
using K3Params = K3ParamsT<float>;

// K7: with t given, w = proj_PSD(t) for N 5x5 matrices; with t null, the
// Shor minor slots of B node slots (N = B * M5) are gathered from the
// primal, relax-mixed with w/u, projected, and u and the EMA updated (the
// float64 build: the fused mode only, projected exactly by Jacobi).
template <class T>
struct K7ParamsT {
  const T* t;                  // (N, 5, 5) or null
  T* w;                        // (N, 5, 5) projections (w5 in place)
  T* u;                        // (N, 5, 5) u5 (gather mode)
  T* acc;                      // (N, 5, 5) EMA of rho*u5, or null
  const T *Xs, *Ws;            // (B, n*m) scaled primal
  const T *v1, *v2, *v3;       // (B, P1), (B, P2), (B, P3)
  const int* minor_idx;        // (B, M5, 4)
  const int *iv1a, *iv1b, *iv2a, *iv2b, *iv3;  // (B, M5)
  const T* minor_mask;         // (B, M5)
  const T *sS, *rho;           // (B,)
  int N, M5, nm, P1, P2, P3, m;
  T alpha, beta;
};
using K7Params = K7ParamsT<float>;

// K8a: the Shor part of the z-step (adjoint of the minor, RSOC, link and
// W >= 0 slots, diagonal solves, Theta-link correction) -> Xs, Ths, W, v;
// per node slot Q clusters of C CTAs on the X/W coordinates, then CTAs on
// Theta's off-diagonal tile pairs and on the v entries (omc_k8a_grid_x).
template <class T>
struct K8aParamsT {
  const T *w1, *u1;                     // (B, n+m, n+m)
  const T *w5, *u5;                     // (B, M5, 5, 5)
  const T *wr, *ur, *soc_mask;          // (B, n*m, 3), (B, n*m)
  const T *wl, *ul;                     // (B, m)
  const T *wp, *up;                     // (B, n, m)
  const int *xw_ptr, *xw_ent, *v1_ptr, *v1_ent, *v2_ptr, *v2_ent, *v3_ptr, *v3_ent;
  const T *cnt_X, *cnt_W, *cnt_v1, *cnt_v2, *cnt_v3;
  const T* g_link;                      // (B, m) Theta-link Gram diagonal
  const T *maskA, *mask;                // (n, m)
  const T *sX, *sT, *sS, *rho;          // (B,)
  T *Xs, *Ths, *Ws, *v1, *v2, *v3;      // outputs
  int B, n, m, M5, P1, P2, P3;
  int C, Q;                             // the X/W coordinates' clusters of C CTAs
                                        // (1..8) over Q column groups
                                        // (omc_torch.sdp.admm_shor.k8a_plan)
  T gamma, R_X;                         // R_X = sqrt(2 gamma ub_bar)
};
using K8aParams = K8aParamsT<float>;

// K8b: cone step of the RSOC, Theta-link and W >= 0 slots with their EMAs;
// B ceil(m / 32) CTAs on the link rows, then CTAs of qpc groups of 16 / sizeof(T)
// consecutive coordinates of the batch (quads; pairs in the float64 build;
// omc_k8b_grid_x).
template <class T>
struct K8bParamsT {
  const T *Xs, *Ws, *Ths;        // (B, n, m), (B, n, m), (B, m, m)
  T *wr, *ur, *acc_r;            // (B, n*m, 3)
  const T* soc_mask;             // (B, n*m)
  T *wl, *ul, *acc_l;            // (B, m)
  T *wp, *up;                    // (B, n, m)
  const T *sX, *sT, *sS, *rho;
  int B, n, m;
  int qpc;                       // groups a coordinates' CTA: 32, 64 or 128
                                 // (sdp.admm_shor.k8b_plan)
  T alpha, beta;
};
using K8bParams = K8bParamsT<float>;

// K7t: the per-term 5x5 minor slots of the rank-k Shor relaxation, gathered
// from term t of Xt, Wt and v1-v3, relax-mixed, projected, u and EMA updated
// (the float64 build projects exactly by Jacobi).
template <class T>
struct K7tParamsT {
  T *w, *u, *acc;                        // (B, M5, k, 5, 5); acc may be null
  const T *Xt;                           // (B, k, n*m) scaled
  const T *Wt;                           // (B, k, C)
  const T *v1, *v2, *v3;                 // (B, k, P1), (B, k, P2), (B, k, P3)
  const int *rec;                        // (B, M5, 16) a minor's index record
                                         // (sdp.shor_k.minor_records): the flat
                                         // entries of its four corners, their
                                         // coordinates, iv1a, iv1b, iv2a, iv2b,
                                         // iv3, 3 pad; 16-byte aligned
  const T *minor_mask;                   // (B, M5)
  const T *sS, *rho;                     // (B,)
  int B, M5, k, nm, C, P1, P2, P3;
  T alpha, beta;
};
using K7tParams = K7tParamsT<float>;

// K7x: with t given, w = proj_PSD(t) for N (k+1)x(k+1) matrices; with t
// null, the XWH slots [[1, Xt'], [Xt, M]] of N = B * C coordinates (the
// float64 build: the slot mode only, projected exactly by Jacobi).
template <class T>
struct K7xParamsT {
  const T* t;                            // (N, D, D) or null
  T *w, *u, *acc;                        // (N, D, D); u, acc in the slot mode
  const T *Xt, *Wt, *Hh;                 // (B, k, n*m), (B, k, C), (B, kp, C)
  const int* coord_flat;                 // (B, C)
  const T* coord_mask;                   // (B, C)
  const T *sS, *rho;                     // (B,)
  int N, C, k, nm;
  T alpha, beta;
};
using K7xParams = K7xParamsT<float>;

// K7x's wide kernel (csrc/k7x_wide.cu, any D): K7x's fields, then its
// per-warp matrices in global memory, or null (shared memory), and its
// launch (sdp.shor_k.k7x_plan)
template <class T>
struct K7xWideParamsT {
  const T* t;
  T *w, *u, *acc;
  const T *Xt, *Wt, *Hh;
  const int* coord_flat;
  const T* coord_mask;
  const T *sS, *rho;
  int N, C, k, nm;
  T alpha, beta;
  T* work;
  int warps, ctas;
};
using K7xWideParams = K7xWideParamsT<float>;

// K8c: the rank-k Shor z-step (adjoint of every Shor slot, Sherman-Morrison
// X solve per entry, diagonal solves, link Woodbury, clip) -> Xt, X = sum_t
// Xt, Theta, W, Wt, H, v1-v3.
template <class T>
struct K8cParamsT {
  const T *w1, *u1;                      // (B, n+m, n+m)
  const T *w5, *u5;                      // (B, M5, k, 5, 5)
  const T *wx, *ux;                      // (B, C, k+1, k+1)
  const T *wr, *ur;                      // (B, Ms, 3)
  const T *wl, *ul;                      // (B, m)
  const T *wwl, *uwl;                    // (B, C)
  const T *wp, *up;                      // (B, n, m)
  const T *wq, *uq;                      // (B, k, C)
  const T *soc_mask, *coord_mask;        // (B, Ms), (B, C)
  const int *fm_ptr, *fm_ent;            // (B, n*m+1), (B, 4*M5) entry -> 4 l + corner
  const int *flat_coord, *flat_soc;      // (B, n*m) entry -> coordinate / RSOC slot or -1
  const int *v1_ptr, *v1_ent, *v2_ptr, *v2_ent, *v3_ptr, *v3_ent;
  const T *D1x, *c1x, *D1w;              // (B, n*m)
  const T *D1wt, *D1h, *D_c, *B_jc;      // (B, C)
  const T* S_th;                         // (B, m)
  const T *D1v1, *D1v2, *D1v3;           // (B, P*)
  const T *maskA, *mask;                 // (n, m)
  const T *sX, *sT, *sS, *rho;           // (B,)
  T *Xt, *Xs, *Ths, *Ws, *Wt, *Hh, *v1, *v2, *v3;  // outputs
  int B, n, m, k, M5, C, Ms, P1, P2, P3;
  int cols;                              // columns a CTA (sdp.shor_k.k8c_plan)
  T gamma, R_X;                          // R_X = sqrt(2 gamma ub_bar)
  T* ws;                                 // the wide kernel's kept values in global
                                         // memory, (B, NF, n, m), or null (shared
                                         // memory; the register kernels: null)
};
using K8cParams = K8cParamsT<float>;

// K9s: rho-free factorisations of the McCormick z-step (once per solve call)
template <class T>
struct K9sParamsT {
  const T *U_lo, *U_hi;       // (B, n, k) node boxes
  T* Mc;                      // (B, n, k+q, k+q) lower Cholesky factors of the row Grams
  T* Si;                      // (B, n, k+q, q) M_i^-1 E_t
  T* Gc;                      // (B, q, q) lower Cholesky factor of G = I + sum_i Si[i, k:, :]
  int B, n, k;
};
using K9sParams = K9sParamsT<float>;

// K9a: McCormick adjoint + z-step -> Xs, Y, Ths, U, t; B slot CTAs, then
// the X chunks and the Theta and Y tile pairs of every slot (omc_k9a_grid_x)
template <class T>
struct K9aParamsT {
  const T *w1, *u1, *w2, *u2, *w3, *u3, *w4, *u4, *wsoc, *usoc, *wbox, *ubox,
      *wmc, *umc, *worth, *uorth;
  const T *U_lo, *U_hi;       // (B, n, k)
  const T *maskA, *mask;      // (n, m)
  const T *sX, *sT, *rho;     // (B,)
  const T *Mc, *Si, *Gc;      // K9s
  T *Xs, *Y, *Ths, *U, *t;
  int B, n, m, k;
  T gamma;
};
using K9aParams = K9aParamsT<float>;

// K9b: McCormick forward map + cone step of every slot but the PSD blocks,
// with the running means of rho*umc and rho*uorth (acc null: none); B slot
// CTAs, then CTAs of qpc 16-byte words (quads; pairs in the float64 build)
// of the batch's t1, t2, t3 (omc_k9b_grid_x).
template <class T>
struct K9bParamsT {
  const T *Xs, *Y, *Ths, *U, *t;
  const T *w1, *u1, *w2, *u2, *w3, *u3;  // 16-byte aligned
  T *t1, *t2, *t3;                       // 16-byte aligned
  T *w4, *u4, *wsoc, *usoc, *wbox, *ubox, *wmc, *umc, *worth, *uorth;
  T *acc_mc, *acc_orth;
  const T *U_lo, *U_hi, *sX, *sT, *rho;
  int B, n, m, k;
  int qpc;  // words a flat CTA: 32, 64 or 128 (sdp.mccormick.k9_plan)
  T alpha, beta;
};
using K9bParams = K9bParamsT<float>;

// K8d: cone step of the RSOC, Theta-link, W-link, W >= 0 and Wt >= 0 slots
// of the rank-k Shor relaxation, with the EMAs of rho*ur, rho*ul, rho*uwl;
// B ceil(m / 32) CTAs on the link rows, then CTAs of ipc items of the
// batch's W >= 0 groups, RSOC groups and coordinates (groups of 16 /
// sizeof(T): quads, pairs in the float64 build; omc_k8d_grid_x).
template <class T>
struct K8dParamsT {
  const T *Xs, *Ws, *Ths, *Wt, *Hh;      // (B,n,m), (B,n,m), (B,m,m), (B,k,C), (B,kp,C)
  T *wr, *ur, *acc_r;                    // (B, Ms, 3)
  T *wl, *ul, *acc_l;                    // (B, m)
  T *wwl, *uwl, *acc_wl;                 // (B, C)
  T *wp, *up;                            // (B, n, m)
  T *wq, *uq;                            // (B, k, C)
  const int* soc_flat;                   // (B, Ms)
  const T* soc_mask;                     // (B, Ms)
  const int* coord_flat;                 // (B, C)
  const T* coord_mask;                   // (B, C)
  const T *sX, *sT, *sS, *rho;           // (B,)
  int B, n, m, k, C, Ms;
  int ipc;                               // items a flat CTA: 32, 64 or 128
                                         // (sdp.shor_k.k8d_plan)
  T alpha, beta;
};
using K8dParams = K8dParamsT<float>;

// K4 / K5: batched symmetric eigensolver, one CTA per matrix.  K4 reads M;
// K5 (M null) forms U U' - Y.  mode 0: the eigenvalues ascending into w
// (nout = d); mode 1: the PSD projection V max(w, 0) V' into P; mode 2: the
// nout smallest eigenpairs into w and V.
template <class T>
struct K4ParamsT {
  const T* M;          // (B, d, d), or null for K5
  const T *U, *Y;      // K5: (B, d, k), (B, d, d)
  T* w;                // (B, nout) or null
  T* V;                // (B, d, nout) or null
  T* P;                // (B, d, d) or null
  int* sweeps;         // (B,) sweeps run; kJacobiMaxSweeps + 1 at the cap
  T* work;             // omc_k4_workspace_floats(B, d, mode, path) values of T, or null
  int B, d, k, nout, mode;
  int path;            // 0: one CTA per matrix; 1: the block path; 2: the
                       // tridiagonal path (float64 only, M given)
};
using K4Params = K4ParamsT<float>;

// K5: the nout <= 2 smallest eigenpairs of sym(U U' - Y), one CTA per
// matrix (Householder tridiagonalisation, multisection, inverse iteration)
template <class T>
struct K5ParamsT {
  const T *U, *Y;      // (B, d, k), (B, d, d)
  T* w;                // (B, nout) ascending
  T* V;                // (B, d, nout) unit columns
  int* iters;          // (B,) inverse iterations run; kK5MaxIters + 1 at the cap
  int B, d, k, nout;
  int path;            // 0: the triangle in float64; 1: in float32 (float operands only)
};
using K5Params = K5ParamsT<float>;

// K4s: PSD projection of N tiny (D x D, D <= 8) symmetric matrices, one
// thread per matrix in registers
template <class T>
struct K4sParamsT {
  const T* t;          // (N, D, D)
  T* w;                // (N, D, D)
  int* sweeps;         // (N,) or null
  int N, D;
};
using K4sParams = K4sParamsT<float>;

// K6: altmin's masked ridge step; the V-step reads U (B, n, k) and writes
// V (B, k, m), the U-step reads V (B, k, m) and writes U (B, n, k)
template <class T>
struct K6ParamsT {
  const T* F;          // the fixed factor
  const T *A, *mask;   // (n, m)
  T* out;              // the solved factor
  T* gram;             // slots path: (B, k(k+1)/2) scratch for (1/gamma) F'F
  int B, n, m, k;
  int path, S, W, rpw;  // the plan (ops.linalg.k6_plan)
  T inv_gamma, ridge_eps;
};
using K6Params = K6ParamsT<float>;
