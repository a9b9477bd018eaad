// K5 — the separation eigenpairs: the nout <= 2 smallest eigenvalues,
// ascending, and unit eigenvectors of sym(U U' - Y), one CTA per matrix.
//
// Replaces the separation eigh of omc/sdp/admm.py:576-578,
// admm_shor.py:543-546, shor_k.py:891-894 and mccormick.py:538-540 (eigh of
// U U' - Y sliced to two).  In the port this is
// omc_torch.sdp.relax.separation_eigpairs; its k5_plan sends a matrix here
// while its packed triangle fits one CTA's shared memory, else to K4's
// Jacobi paths (csrc/k4_jacobi.cu).  The CPU mirror of the order of work is
// omc_torch/ops/tridiag.py.
//
// K4's Jacobi computes all d eigenpairs in ~10 sweeps of d - 1 rounds, two
// CTA barriers a round.  This kernel reduces A to tridiagonal form once and
// solves for two eigenpairs only:
//  1. Load: A = U U' - (Y + Y')/2 straight into shared memory as a packed
//     lower triangle (column-major), in float64 (path 0) or, for orders
//     whose float64 triangle does not fit, in float32 (path 1: d = 250 takes
//     125 KB) with every sum and norm in float64.
//  2. Householder tridiagonalisation in LAPACK dsytd2's order (lower,
//     unblocked).  Step i reads the reflector H = I - tau v v' of column i
//     (beta, tau and the scale 1 / (alpha - beta), from one reciprocal);
//     p = A22 v, a power-of-two group of threads a row with xor shuffles,
//     each row's p_r v_r kept; a barrier; every warp sums p'v in the same
//     order, w = tau p - tau^2 (p'v) / 2 v, and the rank-2 update A22 -= v
//     w' + w v' runs a warp a column with its lanes down the rows
//     (coalesced, each lane's v_r and w_r in registers): warp 0 takes
//     column i + 1 and then the next step's reflector from it (its norm,
//     beta, tau, scale), off the other warps' path; a barrier.  Two
//     barriers a step.  The reflector stays in the column it zeroes, as the
//     unscaled x with its scale beside tau, so the back-transform uses the
//     very v of the reduction in either storage type.
//  3. The nout smallest eigenvalues of the tridiagonal by Sturm-count
//     multisection in float64 (LAPACK dlaebz's count and pivmin; the
//     divisions by a reciprocal to the rounding level): a warp an
//     eigenvalue, its 32 lanes count at 32 shifts across the bracket, so a
//     round narrows it 33 times; kRounds rounds from the padded Gershgorin
//     interval reach the float64 rounding level.
//  4. Eigenvectors by inverse iteration on the tridiagonal (LAPACK dstein's
//     rules), a thread each: LU with partial pivoting of T - lambda I
//     (dlagtf's order), pivots below eps ||T||_1 replaced by it, a
//     deterministic start vector (splitmix64, uniform in [-1, 1)), the
//     right-hand side rescaled before every solve, at most kMaxIters
//     solves, kExtra more after the growth test passes.  When |lambda_1 -
//     lambda_0| <= 1e-3 ||T||_1 the second vector runs after the first and
//     is orthogonalised against it after every solve, so a repeated or
//     near-repeated pair still gives orthonormal columns.  Zero
//     off-diagonals (T splits: a diagonal or zero matrix, Y = U U') need no
//     case of their own: the perturbed zero pivot makes the solve blow up
//     in the block that holds the eigenvalue.
//  5. Back-transform through the stored reflectors (a warp a vector),
//     normalise, write w and V in the operands' type.  A non-finite input gives NaN
//     and the cap's count, as K4's Jacobi gives NaN and its sweep cap.
// The float64 build (omc_k5_separation_f64) reads U and Y and writes w and
// V in double, on the float64 triangle only: every step above is float64
// already, so it differs from the float build in its loads and stores.
// What bounds it: the chain, not the bytes (0.0011 ms of them at B=64,
// d=50) nor the card's FP64 rate: d - 2 steps of two barriers, kRounds
// Sturm recurrences of d dependent reciprocals, the solves' recurrences.
#include "common.cuh"

namespace {

constexpr size_t kSmemMax = 232448;  // the most one block may use on sm_90
constexpr int kRounds = 11;          // 33^11 = 5.0e16: below eps of the bracket
constexpr int kMaxIters = 5;         // dstein's MAXITS
constexpr int kExtra = 2;            // dstein's EXTRA
constexpr unsigned kFull = 0xffffffffu;

constexpr int kThreads5 = 512;        // 16 warps at every order
__host__ __device__ inline long long tri_len(int d) { return (long long)d * (d + 1) / 2; }
// doubles ahead of the triangle: diagonal, off-diagonal, tau and scale of
// each reflector, p and p_r v_r, two vectors and their LU factors (4 d
// each), 8 scalars
__host__ __device__ inline long long head_doubles(int d) { return 16LL * d + 8; }

// shared memory of one CTA, or 0 where it does not fit (k5_smem_bytes in
// omc_torch/sdp/relax.py).  The float32 triangle fits to d = 309, so every
// Householder step has a thread a row of A22 and kQ = 10 chunks of 32 rows
// cover it.
__host__ inline size_t k5_smem(int d, int path) {
  const long long b = 8 * head_doubles(d) + (path == 0 ? 8 : 4) * tri_len(d) + 2LL * d;
  const long long r = (b + 15) / 16 * 16;
  return r <= (long long)kSmemMax ? (size_t)r : 0;
}

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

// 1 / x to the float64 rounding level (omc::rcp; x is never 0 or
// subnormal here: Sturm pivots are at least pivmin, LU pivots at least
// eps ||T||_1)
using omc::rcp;

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

// Inverse iteration for the eigenvalue lam of the tridiagonal (Dg, Eo), by
// one warp: lane 0 factors T - lam I and runs the solves' recurrences, the
// lanes share the vector's scalings, norms and dot products; into x (unit
// 2-norm, largest entry positive).  f: 4 d doubles of LU factors; piv: d
// flags; z0: null, or the unit vector to orthogonalise against after every
// solve.  Returns the solves run, or kMaxIters + 1 at the cap.
__device__ int inverse_iteration(const double* __restrict__ Dg, const double* __restrict__ Eo,
                                 int d, double lam, double tn, int seed, double* __restrict__ x,
                                 double* __restrict__ f, unsigned char* __restrict__ piv,
                                 const double* __restrict__ z0, int lane) {
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
  const double crit = sqrt(0.1 / d);  // dstein's DTPCRT
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
    const double scl = d * tn * fmax(DBL_EPSILON, unn) / bmax;
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
    if (z0) {
      double dt = 0.0;
      for (int j = lane; j < d; j += 32) dt = fma(x[j], z0[j], dt);
      dt = omc::warp_sum_d(dt);
      for (int j = lane; j < d; j += 32) x[j] = fma(-dt, z0[j], x[j]);
    }
    double nrm = 0.0;
    for (int j = lane; j < d; j += 32) nrm = fmax(nrm, fabs(x[j]));
    nrm = warp_max_d(nrm);
    if (!(nrm >= crit)) continue;
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
  double scl = 1.0 / sqrt(s2);
  if (jm < d && x[jm] < 0.0) scl = -scl;
  __syncwarp();
  for (int j = lane; j < d; j += 32) x[j] *= scl;
  __syncwarp();
  return its;
}

// S: the triangle's storage type (double: path 0, float: path 1); kQ: the
// most rows of A22 a lane holds in the update (d <= 32 kQ); T: the
// operands' type (float, or double in the float64 build)
template <typename S, int kQ, typename T>
__global__ void __launch_bounds__(kThreads5) k5_kernel(K5ParamsT<T> p) {
  extern __shared__ __align__(16) unsigned char k5_smem_raw[];
  const int b = blockIdx.x, d = p.d, k = p.k, nout = p.nout;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  double* Dg = reinterpret_cast<double*>(k5_smem_raw);  // T's diagonal
  double* Eo = Dg + d;   // T's off-diagonal: each reflector's beta
  double* tau = Eo + d;  // each reflector's tau
  double* vsc = tau + d; // and its scale: v = x / (alpha - beta)
  double* pv = vsc + d;  // p = A22 v of the step
  double* pw = pv + d;   // p_r v_r of the step, summed into p'v
  double* z = pw + d;    // the vectors (2 d)
  double* lu = z + 2 * d;  // their LU factors (2 x 4 d)
  double* sc = lu + 8 * d; // lambda_0, lambda_1, ||T||_1, the second vector's count
  S* A = reinterpret_cast<S*>(sc + 8);
  unsigned char* piv = reinterpret_cast<unsigned char*>(A + tri_len(d));

  // ---- load: A = U U' - (Y + Y') / 2, rows by warps, columns by lanes ----
  const T* Ub = p.U + (size_t)b * d * k;
  const T* Yb = p.Y + (size_t)b * d * d;
  int bad = 0;
  for (int i = warp; i < d; i += nw)
    for (int j = lane; j <= i; j += 32) {
      double uu = 0.0;
      for (int l = 0; l < k; ++l) uu = fma((double)Ub[i * k + l], (double)Ub[j * k + l], uu);
      const double v = uu - (j == i ? 1.0 : 0.5) * (double)Yb[(size_t)i * d + j];
      bad |= !isfinite(v);
      A[col0(j, d) + i] = (S)v;
    }
  __syncthreads();
  for (int i = warp; i < d; i += nw)  // Y(i, j), j > i, into A(j, i)
    for (int j = i + 1 + lane; j < d; j += 32) {
      const double y = (double)Yb[(size_t)i * d + j];
      bad |= !isfinite(y);
      const int o = col0(i, d) + j;
      A[o] = (S)((double)A[o] - 0.5 * y);
    }
  __syncthreads();
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

  // ---- Householder tridiagonalisation (dsytd2, lower) ----
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
    // step's reflector (its norm, beta, tau, scale) while the other warps
    // take the rest, a column each in turn
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

  // ---- the nout smallest eigenvalues: Sturm-count multisection ----
  if (warp < nout) {
    double lo = 0.0, hi = 0.0, tn = 0.0, e2max = 0.0;
    for (int j = 0; j < d; ++j) {
      const double ej = j + 1 < d ? fabs(Eo[j]) : 0.0, off = (j > 0 ? fabs(Eo[j - 1]) : 0.0) + ej;
      lo = j ? fmin(lo, Dg[j] - off) : Dg[j] - off;
      hi = j ? fmax(hi, Dg[j] + off) : Dg[j] + off;
      tn = fmax(tn, fabs(Dg[j]) + off);
      e2max = fmax(e2max, ej * ej);
    }
    const double pivmin = DBL_MIN * fmax(1.0, e2max);
    const double pad = 2.1 * DBL_EPSILON * tn * d + 4.2 * pivmin;  // dstebz's fudge
    lo -= pad;
    hi += pad;
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
      // the eigenvalue lies between the last shift that counts <= warp
      // eigenvalues and the first that counts more
      const unsigned above = __ballot_sync(kFull, cnt > warp);
      const int l0 = above ? __ffs(above) - 1 : 32;
      const double xl = __shfl_sync(kFull, x, l0 & 31);
      const double xm = __shfl_sync(kFull, x, (l0 + 31) & 31);
      hi = l0 < 32 ? xl : hi;
      lo = l0 == 0 ? lo : xm;
    }
    if (lane == 0) {
      sc[warp] = 0.5 * (lo + hi);
      if (warp == 0) sc[2] = tn > 0.0 ? tn : 1.0;
    }
  }
  __syncthreads();

  // ---- eigenvectors of T by inverse iteration (a warp each) ----
  const double tn = sc[2];
  const bool close = nout == 2 && fabs(sc[1] - sc[0]) <= 1e-3 * tn;
  int its = 0;
  if (warp < nout && !(close && warp == 1))
    its = inverse_iteration(Dg, Eo, d, sc[warp], tn, warp, z + warp * d, lu + 4 * warp * d,
                            piv + warp * d, nullptr, lane);
  __syncthreads();
  if (close && warp == 1)
    its = inverse_iteration(Dg, Eo, d, sc[1], tn, 1, z + d, lu + 4 * d, piv + d, z, lane);
  if (tid == 32) sc[3] = its;
  __syncthreads();

  // ---- back-transform through the reflectors, a warp a vector ----
  if (warp < nout) {
    double* zt = z + warp * d;
    for (int i = d - 3; i >= 0; --i) {
      const double ti = tau[i];
      if (ti == 0.0) continue;
      const int c0 = col0(i, d);
      const double s = vsc[i];
      double dot = 0.0;
      for (int r = i + 1 + lane; r < d; r += 32)
        dot = fma(r == i + 1 ? 1.0 : (double)A[c0 + r] * s, zt[r], dot);
      dot = omc::warp_sum_d(dot) * ti;
      for (int r = i + 1 + lane; r < d; r += 32)
        zt[r] = fma(-dot, r == i + 1 ? 1.0 : (double)A[c0 + r] * s, zt[r]);
      __syncwarp();
    }
    double s2 = 0.0;
    for (int r = lane; r < d; r += 32) s2 = fma(zt[r], zt[r], s2);
    const double inv = 1.0 / sqrt(omc::warp_sum_d(s2));
    const T qnan = omc::qnan_of(T(0));
    T* Vb = p.V + (size_t)b * d * nout;
    for (int r = lane; r < d; r += 32) Vb[r * nout + warp] = bad ? qnan : (T)(zt[r] * inv);
    if (lane == 0) p.w[(size_t)b * nout + warp] = bad ? qnan : (T)sc[warp];
  }
  if (tid == 0) p.iters[b] = bad ? kMaxIters + 1 : (nout == 2 ? max(its, (int)sc[3]) : its);
}

template <typename S, int kQ, typename T>
int launch_k5(const K5ParamsT<T>& p, size_t smem, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        k5_kernel<S, kQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  k5_kernel<S, kQ, T><<<p.B, kThreads5, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int k5_entry(const K5ParamsT<T>& p, void* stream) {
  // float64 operands take the float64 triangle only
  if (p.nout < 1 || p.nout > 2 || p.nout > p.d || p.path < 0 || p.path > (sizeof(T) == 8 ? 0 : 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k5_smem(p.d, p.path);
  if (!smem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 8) {
    return p.d <= 128 ? launch_k5<double, 4>(p, smem, st) : launch_k5<double, 10>(p, smem, st);
  } else {
    if (p.d <= 128)
      return p.path == 0 ? launch_k5<double, 4>(p, smem, st) : launch_k5<float, 4>(p, smem, st);
    return p.path == 0 ? launch_k5<double, 10>(p, smem, st) : launch_k5<float, 10>(p, smem, st);
  }
}

}  // namespace

OMC_EXPORT long long omc_k5_smem_bytes(int d, int path) { return (long long)k5_smem(d, path); }

OMC_EXPORT int omc_k5_threads() { return kThreads5; }

// path 0: the triangle in float64; 1: in float32 (refused where it does not fit)
OMC_EXPORT int omc_k5_separation(const K5Params* params, void* stream) {
  return k5_entry(*params, stream);
}

// the float64 build: double U, Y, w and V, the float64 triangle (path 0)
OMC_EXPORT int omc_k5_separation_f64(const K5ParamsT<double>* params, void* stream) {
  return k5_entry(*params, stream);
}
