// K4s's per-thread Jacobi PSD projection of one tiny symmetric matrix, in
// registers: the body of K4s (csrc/k4s_jacobi_small.cu) and of K7's float64
// build (csrc/k7_minor_psd.cu, the 5x5 Shor minor slots).  CPU mirror:
// omc_torch/ops/jacobi.py k4s_eigh / k4s_project_psd.
//
// The matrix is scaled by a power of two so that its Frobenius norm lies
// in [1, 2) (the rotations are invariant under it, so the pairs and the
// angles are K4's), then cyclic-by-row sweeps with K4's order and stopping
// rule (K4's floor eps ||A||_F / (4 D), common.cuh jacobi_floor) run until a
// sweep rotates no pair or the cap, on the upper triangle of A only, with
// K4s's rotation (k4s_rotation.cuh: no square root in the skip test, one
// reciprocal), and V max(w, 0) V' is formed.  Templated on D in 1..8 so
// that A and V live in registers.
#pragma once

#include "common.cuh"
#include "k4s_rotation.cuh"

namespace k4s {

// frexp's exponent and 2^k in the operands' type; for a double from its
// bits (frexp and ldexp on doubles go through local memory), for a normal
// x and |k| <= 1022
__device__ __forceinline__ int exponent_of(float x) {
  int e = 0;
  frexpf(x, &e);
  return e;
}
__device__ __forceinline__ int exponent_of(double x) {
  return (int)((__double_as_longlong(x) >> 52) & 0x7ff) - 1022;
}
__device__ __forceinline__ float pow2(float, int k) { return ldexpf(1.f, k); }
__device__ __forceinline__ double pow2(double, int k) {
  return __longlong_as_double((long long)(k + 1023) << 52);
}

// A's upper triangle: A[i][j] with i <= j (indices are constants after
// unrolling, so A stays in registers)
#define K4S_AU(i, j) A[(i) < (j) ? (i) : (j)][(i) < (j) ? (j) : (i)]

// The PSD projection of the symmetric matrix whose upper triangle is A
// (A[i][j], i <= j, already symmetrised; A is overwritten): out(i, j, v)
// receives entry (i, j) of V max(w, 0) V' for every i <= j (NaN for a
// non-finite matrix; a NaN eigenvalue propagates).  Returns the sweeps run,
// kJacobiMaxSweeps + 1 at the cap.
template <int D, class T, class Out>
__device__ __forceinline__ int project_psd(T (&A)[D][D], Out out) {
  constexpr int kLim = sizeof(T) == 8 ? 1022 : 126;  // the type's normal exponents
  T V[D][D];
  // ||A||_F summed in K4's order (every entry, row by row)
  T ss = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) ss += K4S_AU(i, j) * K4S_AU(i, j);
  const T normF = sqrt(ss);
  const bool bad = !isfinite(normF);
  // scale by 2^k so that ||A||_F lies in [1, 2)
  const int ex = exponent_of(normF);
  const int kx = bad || normF == T(0) ? 0 : max(-kLim, min(kLim, 1 - ex));
  const T sc = pow2(T(0), kx), unsc = pow2(T(0), -kx);
  const T fs = omc::jacobi_floor(normF * sc, D), floor2 = fs * fs;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) A[i][j] *= sc;
#pragma unroll
    for (int j = 0; j < D; ++j) V[i][j] = i == j ? T(1) : T(0);
  }
  int sweep = 1;
  for (; sweep <= omc::kJacobiMaxSweeps; ++sweep) {
    bool any = false;
#pragma unroll
    for (int pi = 0; pi < D - 1; ++pi)
#pragma unroll
      for (int qi = pi + 1; qi < D; ++qi) {
        T t, s, r;
        if (!rotation(A[pi][pi], A[qi][qi], A[pi][qi], floor2, t, s, r)) continue;
        any = true;
        const T apq = A[pi][qi];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k == pi || k == qi) continue;
          omc::jacobi_rot(K4S_AU(k, pi), K4S_AU(k, qi), s, r);
        }
        A[pi][pi] -= t * apq;
        A[qi][qi] += t * apq;
        A[pi][qi] = 0;
#pragma unroll
        for (int k = 0; k < D; ++k) omc::jacobi_rot(V[k][pi], V[k][qi], s, r);
      }
    if (!any) break;
  }
  const T qnan = omc::qnan_of(T(0));
  T wpos[D];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const T w = A[r][r];
    wpos[r] = bad ? qnan : (w > T(0) ? w * unsc : (isnan(w) ? w : T(0)));
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      T acc = 0;
#pragma unroll
      for (int r = 0; r < D; ++r) acc = fma(V[i][r] * wpos[r], V[j][r], acc);
      out(i, j, acc);
    }
  return sweep;
}

#undef K4S_AU

}  // namespace k4s
