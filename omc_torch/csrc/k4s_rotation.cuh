// K4s's Jacobi rotation (csrc/k4s_jacobi_small.cu; CPU mirror:
// omc_torch/ops/jacobi.py k4s_eigh).  K4's own, omc::jacobi_rotation in
// common.cuh, takes two square roots for the skip test of every pair and,
// for a rotation, a hypotf, a sqrtf and four IEEE divides.  This one runs
// on a matrix scaled by a power of two (so that its Frobenius norm lies in
// [1, 2): the squares below neither overflow nor fall below the floor),
// and
//  - skips the pair when |a_pq|^2 <= max(eps^2 |a_pp| |a_qq|, floor^2),
//    omc::jacobi_rotation's test squared: the same pairs up to rounding.
//    A NaN fails the test, so the pair rotates;
//  - with h = a_qq - a_pp, g = 2 a_pq, g' = sign(h) g, e = |h| + sqrt(h^2
//    + g^2) and f = sqrt(e^2 + g^2), rotates by t = g' / e (tan theta), s =
//    g' / f and r = s / (1 + c) = g' / (e + f), t and r from the one
//    reciprocal 1 / (e (e + f)).  No IEEE divide or square root: the roots
//    come from rsqrtf, the reciprocal from the hardware's approximate one
//    (each within a few ulp; the rotation is held to float64 per matrix).
#pragma once

#include <cfloat>

#include "common.cuh"

namespace k4s {

constexpr float kEps2 = FLT_EPSILON * FLT_EPSILON;

__device__ __forceinline__ bool rotation(float app, float aqq, float apq, float floor2, float& t,
                                         float& s, float& r) {
  const float rel2 = kEps2 * (fabsf(app) * fabsf(aqq));
  const float thr2 = rel2 > floor2 ? rel2 : floor2;  // a NaN floor wins, as K4's
  if (apq * apq <= thr2) return false;
  const float h = aqq - app, g = 2.f * apq;
  const float gs = copysignf(1.f, h) * g;
  const float n1 = fmaf(h, h, g * g);
  const float e = fabsf(h) + n1 * rsqrtf(n1);
  const float n2 = fmaf(e, e, g * g);
  const float inv = rsqrtf(n2);  // 1 / f
  const float f = n2 * inv;
  const float q = __fdividef(1.f, e * (e + f));
  t = gs * (e + f) * q;
  r = gs * e * q;
  s = gs * inv;
  return true;
}

// The float64 build's: the same skip test at double's epsilon and the same
// parameters, the roots from rsqrt and q from the approximate reciprocal
// refined by two Newton steps (to the rounding level; no IEEE divide or
// square root, whose slow-path calls made ptxas spill around them at D = 2)
constexpr double kEps2d = DBL_EPSILON * DBL_EPSILON;

__device__ __forceinline__ bool rotation(double app, double aqq, double apq, double floor2,
                                         double& t, double& s, double& r) {
  const double rel2 = kEps2d * (fabs(app) * fabs(aqq));
  const double thr2 = rel2 > floor2 ? rel2 : floor2;
  if (apq * apq <= thr2) return false;
  const double h = aqq - app, g = 2.0 * apq;
  const double gs = copysign(1.0, h) * g;
  const double n1 = fma(h, h, g * g);
  const double e = fabs(h) + n1 * rsqrt(n1);
  const double n2 = fma(e, e, g * g);
  const double inv = rsqrt(n2);  // 1 / f
  const double f = n2 * inv;
  const double den = e * (e + f);
  const double q = omc::rcp(den);
  t = gs * (e + f) * q;
  r = gs * e * q;
  s = gs * inv;
  return true;
}

}  // namespace k4s
