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
// solves for two eigenpairs only (steps 2 to 4 in tridiag.cuh, which K4's
// float64 tridiagonal path, csrc/k4_tridiag.cu, runs too):
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
#include "tridiag.cuh"

namespace {

using tri::col0;
using tri::kMaxIters;
using tri::tri_len;
constexpr size_t kSmemMax = 232448;  // the most one block may use on sm_90

constexpr int kThreads5 = 512;        // 16 warps at every order
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
  // ---- Householder tridiagonalisation (dsytd2, lower; tridiag.cuh) ----
  bad = tri::householder_lower<S, kQ>(A, Dg, Eo, tau, vsc, pv, pw, d, bad);

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
    const double lam = tri::sturm_multisection(Dg, Eo, d, lo, hi, pivmin, warp, lane);
    if (lane == 0) {
      sc[warp] = lam;
      if (warp == 0) sc[2] = tn > 0.0 ? tn : 1.0;
    }
  }
  __syncthreads();

  // ---- eigenvectors of T by inverse iteration (a warp each) ----
  const double tn = sc[2];
  const bool close = nout == 2 && fabs(sc[1] - sc[0]) <= 1e-3 * tn;
  int its = 0;
  if (warp < nout && !(close && warp == 1))
    its = tri::inverse_iteration(Dg, Eo, d, sc[warp], tn, warp, z + warp * d,
                                 lu + 4 * warp * d, piv + warp * d, nullptr, 0, lane);
  __syncthreads();
  if (close && warp == 1)
    its = tri::inverse_iteration(Dg, Eo, d, sc[1], tn, 1, z + d, lu + 4 * d, piv + d, z, 1,
                                 lane);
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
