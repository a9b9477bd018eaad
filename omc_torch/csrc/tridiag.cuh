// The symmetric tridiagonal eigensolver's steps that K5 (csrc/k5_separation.cu:
// the two smallest eigenpairs of U U' - Y) and K4's float64 tridiagonal path
// (csrc/k4_tridiag.cu: every eigenvalue, and the vectors a projection or the
// nout smallest eigenpairs need) share.  CPU mirror: omc_torch/ops/tridiag.py.
//
// * householder_lower: LAPACK dsytd2's lower reduction of the packed lower
//   triangle A (column-major, in S: double, or float in K5's path 1 with
//   every sum in double) by one CTA.  Step i reads the reflector H = I - tau
//   v v' of column i; p = A22 v, a power-of-two group of threads a row with
//   xor shuffles, each row's p_r v_r kept; a barrier; every warp sums p'v in
//   the same order, w = tau p - tau^2 (p'v) / 2 v, and the rank-2 update
//   A22 -= v w' + w v' runs a warp a column with its lanes down the rows
//   (each lane's v_r and w_r in registers): warp 0 takes column i + 1 and
//   then the next step's reflector from it (its norm, beta, tau, scale), off
//   the other warps' path; a barrier.  The reflector stays in the column it
//   zeroes, as the unscaled x with its scale beside tau.
// * sturm_multisection: eigenvalue t of T by a warp, its 32 lanes counting
//   at 32 shifts across the bracket (LAPACK dlaebz's count and pivmin), so
//   a round narrows it 33 times; kRounds rounds from the padded Gershgorin
//   interval reach the float64 rounding level.
// * inverse_iteration: LAPACK dstein's rules, by one warp: LU with partial
//   pivoting of T - lambda I (dlagtf's order), pivots below eps ||T||_1
//   replaced by it, a deterministic start vector, the right-hand side
//   rescaled before every solve, at most kMaxIters solves, kExtra more after
//   the growth test passes, each solve orthogonalised against given unit
//   vectors in order (modified Gram-Schmidt).  Zero off-diagonals (T
//   splits) need no case of their own: the perturbed zero pivot makes the
//   solve blow up in the block that holds the eigenvalue.
// No IEEE divide or sqrt in the solves: their slow paths are calls, around
// which ptxas spilled (omc::rcp, rsqrt_d).
#pragma once

#include "common.cuh"

namespace tri {

constexpr int kRounds = 11;   // 33^11 = 5.0e16: below eps of the bracket
constexpr int kMaxIters = 5;  // dstein's MAXITS
constexpr int kExtra = 2;     // dstein's EXTRA
constexpr unsigned kFull = 0xffffffffu;

using omc::rcp;

__host__ __device__ inline long long tri_len(int d) { return (long long)d * (d + 1) / 2; }

// (i, j), i >= j, of the packed lower triangle is at col0(j) + i
__device__ __forceinline__ int col0(int j, int d) { return j * d - (j * (j - 1)) / 2 - j; }

// entry j of start vector `seed`: splitmix64 of (2 j + seed + 1), uniform in [-1, 1)
__device__ __forceinline__ double start_entry(int j, int seed) {
  unsigned long long x = (unsigned long long)(2 * j + seed + 1) * 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x ^= x >> 31;
  return (double)(x >> 11) * 0x1.0p-52 - 1.0;
}

// 1 / sqrt(x) to the float64 rounding level: the hardware's approximate
// reciprocal square root refined by three Newton steps.  x is a normal
// positive number.
__device__ __forceinline__ double rsqrt_d(double x) {
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double h = 0.5 * x;
  r = r * fma(-h * r, r, 1.5);
  r = r * fma(-h * r, r, 1.5);
  return r * fma(-h * r, r, 1.5);
}

// dlarfg for x = (alpha, x'), ||x'||^2 = xn2: beta = -sign(alpha) ||x||,
// tau = (beta - alpha) / beta, scale = 1 / (alpha - beta), from one
// reciprocal; tau = scale = 0 and beta = alpha where x' = 0
__device__ __forceinline__ void reflector(double alpha, double xn2, double* beta, double* tau,
                                          double* scale) {
  if (xn2 == 0.0) {  // a NaN takes the other branch
    *beta = alpha, *tau = 0.0, *scale = 0.0;
    return;
  }
  const double bt = -copysign(sqrt(fma(alpha, alpha, xn2)), alpha), am = alpha - bt;
  const double r = rcp(bt * am);
  *beta = bt, *tau = -am * am * r, *scale = bt * r;
}

__device__ __forceinline__ double warp_max_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The reduction of the packed lower triangle A (order d) by the CTA, after
// its load (bad: this thread saw a non-finite entry).  Fills T's diagonal
// Dg and off-diagonal Eo (each reflector's beta), each reflector's tau and
// scale (vsc); pv, pw: d doubles each of scratch.  Returns the CTA's or of
// bad.  kQ: the most rows of A22 a lane holds in the update (d <= 32 kQ).
template <typename S, int kQ>
__device__ __forceinline__ int householder_lower(S* A, double* Dg, double* Eo, double* tau,
                                                 double* vsc, double* pv, double* pw, int d,
                                                 int bad) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  if (warp == 0 && d >= 2) {  // column 0's reflector (column 0 starts at 0)
    double s = 0.0;
    for (int r = 2 + lane; r < d; r += 32) s = fma((double)A[r], (double)A[r], s);
    s = omc::warp_sum_d(s);
    if (lane == 0) {
      Dg[0] = (double)A[0];
      reflector((double)A[1], s, Eo, tau, vsc);
    }
  }
  bad = __syncthreads_or(bad);
  for (int i = 0; i + 2 < d; ++i) {
    const int c0 = col0(i, d);
    const double tau_i = tau[i], scale = vsc[i];
    // p = A22 v: 2^sh threads a row of A22 (m rows), v(i+1) = 1
    const int m = d - i - 1;
    const int g = nt / m;
    const int sh = g >= 32 ? 5 : 31 - __clz(g);
    const int rr = tid >> sh, l = tid & ((1 << sh) - 1);
    const int r = i + 1 + rr;
    double acc = 0.0;
    if (rr < m) {  // four chains over the row's columns, summed in order
      const int cr = col0(r, d), st = 1 << sh;
      auto term = [&](int c) {
        const double vc = c == i + 1 ? 1.0 : (double)A[c0 + c] * scale;
        return (c <= r ? (double)A[col0(c, d) + r] : (double)A[cr + c]) * vc;
      };
      double s1 = 0.0, s2 = 0.0, s3 = 0.0;
      int c = i + 1 + l;
      for (; c + 3 * st < d; c += 4 * st) {
        acc += term(c);
        s1 += term(c + st);
        s2 += term(c + 2 * st);
        s3 += term(c + 3 * st);
      }
      for (; c < d; c += st) acc += term(c);
      acc = (acc + s1) + (s2 + s3);
    }
    for (int o = (1 << sh) >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (rr < m && l == 0) {
      pv[r] = acc;
      pw[r] = acc * (r == i + 1 ? 1.0 : (double)A[c0 + r] * scale);
    }
    __syncthreads();
    // w = tau p + a2 v, a2 = -tau^2 (p'v) / 2 (every warp sums p'v in the
    // same order); the lane's rows i + 1 + lane + 32 q of A22 hold their v
    // and w in registers
    double pvs = 0.0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int rw = i + 1 + lane + 32 * q;
      if (rw < d) pvs += pw[rw];
    }
    const double a2 = -0.5 * tau_i * tau_i * omc::warp_sum_d(pvs);
    double vr[kQ], wr[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int rw = i + 1 + lane + 32 * q;
      vr[q] = rw == i + 1 ? 1.0 : (rw < d ? (double)A[c0 + rw] * scale : 0.0);
      wr[q] = rw < d ? fma(tau_i, pv[rw], a2 * vr[q]) : 0.0;
    }
    // A22 -= v w' + w v': warp 0 takes column i + 1 and then the next
    // step's reflector while the other warps take the rest, a column each
    if (warp == 0) {
      const int cc = col0(i + 1, d);
      const double wc = fma(tau_i, pv[i + 1], a2);
      double nrm = 0.0, x0 = 0.0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int rw = i + 1 + lane + 32 * q;
        if (rw >= d) continue;
        const S x = (S)fma(-vr[q], wc, (double)A[cc + rw] - wr[q]);  // v(i+1) = 1
        A[cc + rw] = x;
        if (q == 0) x0 = (double)x;
        if (rw >= i + 3) nrm = fma((double)x, (double)x, nrm);
      }
      nrm = omc::warp_sum_d(nrm);
      const double dnext = __shfl_sync(kFull, x0, 0);  // A(i+1, i+1)
      const double alpha = __shfl_sync(kFull, x0, 1);  // A(i+2, i+1)
      if (lane == 0) {
        Dg[i + 1] = dnext;
        reflector(alpha, nrm, Eo + i + 1, tau + i + 1, vsc + i + 1);
      }
    } else {
#pragma unroll 2
      for (int c = i + 1 + warp; c < d; c += nw - 1) {
        const double vc = (double)A[c0 + c] * scale;
        const double wc = fma(tau_i, pv[c], a2 * vc);
        const int cc = col0(c, d);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int rw = i + 1 + lane + 32 * q;
          if (rw < c || rw >= d) continue;
          A[cc + rw] = (S)fma(-vr[q], wc, fma(-wr[q], vc, (double)A[cc + rw]));
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) Dg[d - 1] = (double)A[col0(d - 1, d) + d - 1];
  __syncthreads();
  return bad;
}

// Eigenvalue t (0-based, ascending) of the tridiagonal (Dg, Eo) by one warp
// from the bracket [lo, hi]: kRounds rounds of 32-shift multisection, the
// bracket kept between the last shift that counts <= t eigenvalues and the
// first that counts more; returns its midpoint.
__device__ __forceinline__ double sturm_multisection(const double* Dg, const double* Eo, int d,
                                                     double lo, double hi, double pivmin, int t,
                                                     int lane) {
  for (int round = 0; round < kRounds; ++round) {
    const double h = (hi - lo) * (1.0 / 33.0);
    const double x = fma((double)(lane + 1), h, lo);
    double q = Dg[0] - x;
    int cnt = 0;
    if (q <= pivmin) ++cnt, q = fmin(q, -pivmin);
#pragma unroll 4
    for (int j = 1; j < d; ++j) {
      const double e = Eo[j - 1];
      q = (Dg[j] - x) - e * e * rcp(q);
      if (q <= pivmin) ++cnt, q = fmin(q, -pivmin);
    }
    const unsigned above = __ballot_sync(kFull, cnt > t);
    const int l0 = above ? __ffs(above) - 1 : 32;
    const double xl = __shfl_sync(kFull, x, l0 & 31);
    const double xm = __shfl_sync(kFull, x, (l0 + 31) & 31);
    hi = l0 < 32 ? xl : hi;
    lo = l0 == 0 ? lo : xm;
  }
  return 0.5 * (lo + hi);
}

// Inverse iteration for the shift lam of the tridiagonal (Dg, Eo), by one
// warp: lane 0 factors T - lam I and runs the solves' recurrences, the lanes
// share the vector's scalings, norms and dot products; into x (unit 2-norm,
// the first of its largest entries positive).  f: 4 d doubles of LU
// factors; piv: d flags; zg: ng unit vectors (rows of d) each solve is
// orthogonalised against, in order.  Returns the solves run, or kMaxIters +
// 1 at the cap.
__device__ __forceinline__ int inverse_iteration(const double* __restrict__ Dg,
                                                 const double* __restrict__ Eo, int d, double lam,
                                                 double tn, int seed, double* __restrict__ x,
                                                 double* __restrict__ f,
                                                 unsigned char* __restrict__ piv,
                                                 const double* zg, int ng, int lane) {
  double* u0 = f;          // U's diagonal, then its reciprocal
  double* u1 = f + d;      // U's first superdiagonal
  double* u2 = f + 2 * d;  // U's second (the fill of an interchange)
  double* lm = f + 3 * d;  // the multipliers
  const double tol = DBL_EPSILON * tn;
  double unn = 0.0;
  if (lane == 0) {
    double r0 = Dg[0] - lam, r1 = d > 1 ? Eo[0] : 0.0;
    for (int j = 0; j + 1 < d; ++j) {
      const double bj = Eo[j], aj = Dg[j + 1] - lam, cj = j + 2 < d ? Eo[j + 1] : 0.0;
      if (fabs(r0) >= fabs(bj)) {  // no interchange
        const double l = r0 != 0.0 ? bj * rcp(r0) : 0.0;
        u0[j] = r0, u1[j] = r1, u2[j] = 0.0, lm[j] = l, piv[j] = 0;
        r0 = aj - l * r1;
        r1 = cj;
      } else {  // rows j and j + 1 interchanged
        const double l = r0 * rcp(bj);
        u0[j] = bj, u1[j] = aj, u2[j] = cj, lm[j] = l, piv[j] = 1;
        r0 = r1 - l * aj;
        r1 = -l * cj;
      }
    }
    u0[d - 1] = r0;
    unn = fabs(r0);
  }
  unn = __shfl_sync(kFull, unn, 0);
  __syncwarp();
  for (int j = lane; j < d; j += 32) {
    double u = u0[j];
    if (fabs(u) < tol) u = u < 0.0 ? -tol : tol;
    u0[j] = rcp(u);
    x[j] = start_entry(j, seed);
  }
  __syncwarp();
  const double crit2 = 0.1 * rcp((double)d);  // dstein's DTPCRT, squared
  int its = 0, checks = 0;
  while (++its <= kMaxIters) {
    double bmax = 0.0;
    for (int j = lane; j < d; j += 32) bmax = fmax(bmax, fabs(x[j]));
    bmax = warp_max_d(bmax);
    if (bmax == 0.0) {  // the orthogonalisation left nothing: a fresh start
      seed += 2;
      for (int j = lane; j < d; j += 32) bmax = fmax(bmax, fabs(x[j] = start_entry(j, seed)));
      bmax = warp_max_d(bmax);
    }
    const double scl = d * tn * fmax(DBL_EPSILON, unn) * rcp(bmax);
    for (int j = lane; j < d; j += 32) x[j] *= scl;
    __syncwarp();
    if (lane == 0) {
      double cur = x[0];  // P and L, the chain carried in registers
#pragma unroll 4
      for (int j = 0; j + 1 < d; ++j) {
        double nxt = x[j + 1];
        if (piv[j]) {
          const double tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
        x[j] = cur;
        cur = fma(-lm[j], cur, nxt);
      }
      double x1 = cur * u0[d - 1], x2 = 0.0;  // U (u2[d - 2] = 0)
      x[d - 1] = x1;
#pragma unroll 4
      for (int j = d - 2; j >= 0; --j) {
        const double xj = fma(-u2[j], x2, fma(-u1[j], x1, x[j])) * u0[j];
        x[j] = xj;
        x2 = x1;
        x1 = xj;
      }
    }
    __syncwarp();
    for (int gi = 0; gi < ng; ++gi) {  // modified Gram-Schmidt, in order
      const double* z = zg + (size_t)gi * d;
      double dt = 0.0;
      for (int j = lane; j < d; j += 32) dt = fma(x[j], z[j], dt);
      dt = omc::warp_sum_d(dt);
      for (int j = lane; j < d; j += 32) x[j] = fma(-dt, z[j], x[j]);
      __syncwarp();
    }
    double nrm = 0.0;
    for (int j = lane; j < d; j += 32) nrm = fmax(nrm, fabs(x[j]));
    nrm = warp_max_d(nrm);
    if (!(nrm * nrm >= crit2)) continue;
    if (++checks < kExtra + 1) continue;
    break;
  }
  // unit 2-norm, the first of the largest entries positive
  double s2 = 0.0, big = -1.0;
  int jm = d;
  for (int j = lane; j < d; j += 32) {
    s2 = fma(x[j], x[j], s2);
    if (fabs(x[j]) > big) big = fabs(x[j]), jm = j;
  }
  s2 = omc::warp_sum_d(s2);
  for (int o = 16; o > 0; o >>= 1) {
    const double ob = __shfl_xor_sync(kFull, big, o);
    const int oj = __shfl_xor_sync(kFull, jm, o);
    if (ob > big || (ob == big && oj < jm)) big = ob, jm = oj;
  }
  __syncwarp();
  double scl = rsqrt_d(s2);
  if (jm < d && x[jm] < 0.0) scl = -scl;
  __syncwarp();
  for (int j = lane; j < d; j += 32) x[j] *= scl;
  __syncwarp();
  return its;
}

}  // namespace tri
