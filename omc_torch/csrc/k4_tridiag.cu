// K4's tridiagonal path (float64): eigenvalues (mode 0), the PSD projection
// (mode 1) and the nout smallest eigenpairs (mode 2) of B symmetric d x d
// matrices, d <= kTriMaxD, by Householder reduction, Sturm-count
// multisection and inverse iteration.
//
// Replaces, beside K4's Jacobi paths (csrc/k4_jacobi.cu), the same
// eigendecompositions of omc's safe bounds (omc/sdp/relax.py:356-487,
// omc/sdp/admm_shor.py:786-807, omc/sdp/shor_k.py:947-1165) and the PSD
// projections of the float64 solves (omc/ops/cones.py project_psd, from
// omc/sdp/admm.py:524-560 and the Shor and McCormick loops).  In the port
// this is omc_torch.ops.cones.k4_jacobi(path="tri"); k4_plan sends a
// float64 call here where the card measured it faster.  The CPU mirror of
// the order of work is omc_torch/ops/tridiag.py (eigvalsh_tridiag,
// project_psd_tridiag, eigh_tridiag).
//
// Why: at small batches K4's CTA path is a chain of ~10 sweeps x (d - 1)
// rounds on one SM, two barriers a round, while the other SMs idle.  Here
// the chain is the reduction's d - 2 steps on one SM (two barriers each);
// everything after it spreads a warp an eigenvalue or a vector over the
// card.  One C call enqueues, on the caller's stream:
//  1. k4t_reduce (a CTA a matrix, 512 threads): A = (M + M') / 2 into
//     shared memory as a packed lower triangle in float64, then K5's
//     Householder tridiagonalisation in dsytd2's order (tridiag.cuh, the
//     code K5 runs); T's diagonal and
//     off-diagonal, each reflector's tau and (modes 1, 2) the reflectors
//     v_i, stored whole, to the workspace; warp 0 then puts ||T||_1, the
//     padded Gershgorin interval and pivmin beside them.
//  2. k4t_eigvals (a warp an eigenvalue, kWarpsE a CTA, over the card):
//     eigenvalue j by K5's 32-shift Sturm multisection from the interval
//     (tridiag.cuh: kRounds rounds to the float64 rounding level).
//  3. k4t_vectors (modes 1, 2; a warp an eigenvalue): which vectors the
//     call needs.  Mode 2: the nout smallest.  Mode 1: tau = d eps ||T||_1;
//     with na eigenvalues below -tau and nb above tau, the side with fewer,
//     P = A - sum_{lambda < -tau} lambda y y' (na < nb) or sum_{lambda >
//     tau} lambda y y'; an eigenvalue within tau of 0 is left out, which
//     moves P by at most tau in the 2-norm.  The needed eigenvalues, in
//     ascending order, form groups as in LAPACK dstein: a group continues
//     while the next is within 1e-3 ||T||_1 of the last.  The warp of a
//     group's first eigenvalue computes the group's vectors one after the
//     other by K5's inverse iteration (tridiag.cuh; dstein's rules, the
//     start vector seeded by the eigenvalue's index), each shift pushed at
//     least 10 eps |lambda| above the last and each solve orthogonalised
//     against the group's earlier vectors (modified Gram-Schmidt, in
//     order), so repeated and clustered eigenvalues get orthonormal
//     vectors.  The other warps of a group have nothing to do.
//  4. k4t_back (modes 1, 2; a warp a vector): y = Q z through the
//     reflectors, last first, z in registers, the reflector rows read
//     coalesced; normalised; mode 2 writes V, mode 1 keeps y.
//  5. k4t_assemble (mode 1; a CTA a 32 x 32 tile of the upper triangle):
//     P(r, c) = base + sum_s c_s y_s(r) y_s(c), r <= c, the sum over the
//     vectors in order, written to (r, c) and (c, r): P is exactly
//     symmetric.
// Every sum runs in a fixed order, so two launches give the same bits.  A
// non-finite input gives NaN outputs and a count of kJacobiMaxSweeps + 1,
// as on the Jacobi paths.  The count (K4Params.sweeps) is otherwise the
// most inverse-iteration solves of any of the matrix's vectors (0 in mode
// 0), and kJacobiMaxSweeps + 1 where a vector reached dstein's cap.
//
// What bounds it: the chain, not the card's rates.  At B = 1, d = 100 the
// bytes take 0.5 us and the O(d^3) operations 0.05 us at 34 TFLOP/s; the
// reduction's 98 steps of two barriers and a 99-row matrix-vector product
// on one SM, and the Sturm recurrences' dependent reciprocals (kRounds x d
// a warp), take the time.  The products (back-transform, V diag(c) V') are
// FP64 FMAs, not the FP64 tensor cores: they are a few microseconds of a
// call at these orders.
#include "common.cuh"
#include "tridiag.cuh"

namespace {

using tri::col0;
using tri::kFull;
using tri::kMaxIters;
using tri::tri_len;
constexpr size_t kSmemMax = 232448;  // the most one block may use on sm_90
constexpr int kTriMaxD = 234;        // the float64 triangle and head fit one CTA
constexpr int kThreadsR = 512;  // the reduction's CTA
constexpr int kWarpsE = 4;      // eigenvalue and vector CTAs: warps
constexpr int kWarpsB = 8;      // back-transform CTAs: warps
constexpr int kTile = 32;       // the assembly's output tile

// the workspace of one matrix, in doubles: T's diagonal (dg), off-diagonal
// (eo), each reflector's tau, the eigenvalues (w), each needed vector's
// eigenvalue (ls), eight control values (ctl: bad, ||T||_1, the padded
// interval lo and hi, pivmin, the vectors' count, the side), then (modes 1,
// 2) the reflectors R (row i: v_i) and the vectors Z (row s: vector s)
struct TGeom {
  long long dg, eo, tau, w, ls, ctl, R, Z, mat;
  __host__ __device__ TGeom(int d, int mode) {
    dg = 0, eo = d, tau = 2LL * d, w = 3LL * d, ls = 4LL * d, ctl = 5LL * d;
    R = ctl + 8;
    Z = R + (mode ? (long long)d * d : 0);
    mat = Z + (mode ? (long long)d * d : 0);
  }
};
enum { kBad = 0, kTn = 1, kLo = 2, kHi = 3, kPiv = 4, kCount = 5, kSide = 6 };

// the reduction's shared memory: Dg, Eo, tau, scale, p, p_r v_r (6 d
// doubles), 8 scalars, then the packed triangle; 0 where it does not fit
__host__ inline size_t reduce_smem(int d) {
  const long long b = 8 * (6LL * d + 8 + tri_len(d));
  return b <= (long long)kSmemMax ? (size_t)b : 0;
}

__device__ __forceinline__ double warp_min_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---- 1. the reduction ----
// kQ: the most rows of A22 a lane holds in the update (d <= 32 kQ)
template <int kQ>
__global__ void __launch_bounds__(kThreadsR) k4t_reduce(K4ParamsT<double> p) {
  extern __shared__ __align__(16) unsigned char k4t_smem_raw[];
  const int b = blockIdx.x, d = p.d;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  double* Dg = reinterpret_cast<double*>(k4t_smem_raw);
  double* Eo = Dg + d;
  double* tau = Eo + d;
  double* vsc = tau + d;
  double* pv = vsc + d;
  double* pw = pv + d;
  double* A = pw + d + 8;
  const TGeom g(d, p.mode);
  double* ws = p.work + (size_t)b * g.mat;

  // ---- load: A = (M + M') / 2, the lower triangle, rows by warps ----
  const omc::ROT<double> Mb{p.M + (size_t)b * d * d};
  int bad = 0;
  for (int i = warp; i < d; i += nw)
    for (int j = lane; j <= i; j += 32) {
      const double v = 0.5 * (Mb[(size_t)i * d + j] + Mb[(size_t)j * d + i]);
      bad |= !isfinite(v);
      A[col0(j, d) + i] = v;
    }
  __syncthreads();
  // ---- Householder tridiagonalisation (dsytd2, lower; tridiag.cuh) ----
  bad = tri::householder_lower<double, kQ>(A, Dg, Eo, tau, vsc, pv, pw, d, bad);

  // ---- out: T, tau, the reflectors; ||T||_1, the padded interval ----
  for (int j = tid; j < d; j += nt) {
    ws[g.dg + j] = Dg[j];
    ws[g.eo + j] = j + 1 < d ? Eo[j] : 0.0;
    ws[g.tau + j] = j + 2 < d ? tau[j] : 0.0;
  }
  if (p.mode)  // row i: v_i(r) for r > i (v_i(i + 1) = 1), rows i < d - 2
    for (int i = warp; i + 2 < d; i += nw) {
      const int c0 = col0(i, d);
      const double s = vsc[i];
      double* Ri = ws + g.R + (size_t)i * d;
      for (int r = i + 1 + lane; r < d; r += 32) Ri[r] = r == i + 1 ? 1.0 : A[c0 + r] * s;
    }
  if (warp == 0) {
    double lo = omc::inf_of(0.0), hi = -lo, tn = 0.0, e2 = 0.0;
    for (int j = lane; j < d; j += 32) {
      const double ej = j + 1 < d ? fabs(Eo[j]) : 0.0, off = (j > 0 ? fabs(Eo[j - 1]) : 0.0) + ej;
      lo = fmin(lo, Dg[j] - off);
      hi = fmax(hi, Dg[j] + off);
      tn = fmax(tn, fabs(Dg[j]) + off);
      e2 = fmax(e2, ej * ej);
    }
    lo = warp_min_d(lo);
    hi = tri::warp_max_d(hi), tn = tri::warp_max_d(tn), e2 = tri::warp_max_d(e2);
    if (lane == 0) {
      const double pivmin = DBL_MIN * fmax(1.0, e2);
      const double pad = 2.1 * DBL_EPSILON * tn * d + 4.2 * pivmin;  // dstebz's fudge
      double* ctl = ws + g.ctl;
      ctl[kBad] = bad ? 1.0 : 0.0;
      ctl[kTn] = tn > 0.0 ? tn : 1.0;
      ctl[kLo] = lo - pad;
      ctl[kHi] = hi + pad;
      ctl[kPiv] = pivmin;
    }
  }
}

// ---- 2. the eigenvalues: a warp each, K5's 32-shift multisection ----
// ne: the eigenvalues the call needs (the ne smallest)
__global__ void __launch_bounds__(kWarpsE * 32) k4t_eigvals(K4ParamsT<double> p, int ne) {
  extern __shared__ __align__(16) unsigned char k4t_smem_raw[];
  const int b = blockIdx.x, d = p.d, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kWarpsE + (threadIdx.x >> 5);
  const TGeom g(d, p.mode);
  double* ws = p.work + (size_t)b * g.mat;
  double* Dg = reinterpret_cast<double*>(k4t_smem_raw);
  double* Eo = Dg + d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) Dg[i] = ws[g.dg + i], Eo[i] = ws[g.eo + i];
  const double* ctl = ws + g.ctl;
  const bool bad = ctl[kBad] != 0.0;
  if (blockIdx.y == 0 && threadIdx.x == 0) p.sweeps[b] = bad ? omc::kJacobiMaxSweeps + 1 : 0;
  __syncthreads();
  if (j >= ne) return;
  const double lam = tri::sturm_multisection(Dg, Eo, d, ctl[kLo], ctl[kHi], ctl[kPiv], j, lane);
  if (lane == 0) {
    ws[g.w + j] = lam;
    if (p.mode != 1 && j < p.nout)
      p.w[(size_t)b * p.nout + j] = bad ? omc::qnan_of(0.0) : lam;
  }
}

// the side of the vectors a matrix needs in mode 1, from its eigenvalues
// w (ne of them, ascending up to rounding), by one warp: -1 where fewer
// lie below -tau than above tau (P = A minus the sum over lambda < -tau),
// else +1 (P = the sum over lambda > tau)
__device__ __forceinline__ int side_of(const double* w, int ne, double tau, int lane) {
  int na = 0, nb = 0;
  for (int j = lane; j < ne; j += 32) na += w[j] < -tau, nb += w[j] > tau;
  for (int o = 16; o > 0; o >>= 1) {
    na += __shfl_xor_sync(kFull, na, o);
    nb += __shfl_xor_sync(kFull, nb, o);
  }
  return na < nb ? -1 : 1;
}

// whether eigenvalue i's vector is needed: every one in mode 2; in mode 1
// those beyond tau on the side (an explicit function, not an object: a
// closure of these four values stayed in local memory)
__device__ __forceinline__ bool needed(const double* w, int i, int mode, int side, double tau) {
  return mode != 1 || (side < 0 ? w[i] < -tau : w[i] > tau);
}

// ---- 3. the vectors of T: a warp an eigenvalue, a group a warp ----
// (launched with kWarpsE warps; under a bound of that many threads ptxas
// kept this kernel at 56 registers and spilled, under 256 it takes 64 and
// spills nothing)
__global__ void __launch_bounds__(256) k4t_vectors(K4ParamsT<double> p, int ne) {
  extern __shared__ __align__(16) unsigned char k4t_smem_raw[];
  const int b = blockIdx.x, d = p.d, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.y * kWarpsE + warp;
  const TGeom g(d, p.mode);
  double* ws = p.work + (size_t)b * g.mat;
  double* Dg = reinterpret_cast<double*>(k4t_smem_raw);
  double* Eo = Dg + d;
  double* x = Eo + d + (size_t)warp * 5 * d;  // the warp's vector and LU factors
  unsigned char* piv = reinterpret_cast<unsigned char*>(Eo + d + (size_t)kWarpsE * 5 * d) + warp * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) Dg[i] = ws[g.dg + i], Eo[i] = ws[g.eo + i];
  __syncthreads();
  if (j >= ne) return;
  const double* w = ws + g.w;
  double* ctl = ws + g.ctl;
  const double tn = ctl[kTn], ortol = 1e-3 * tn;
  // which vectors the matrix needs: mode 2 the ne smallest; mode 1 those
  // beyond tau = d eps ||T||_1 on the side of zero with fewer
  const int mode = p.mode;
  const double tau = d * DBL_EPSILON * tn;
  const int side = mode == 1 ? side_of(w, ne, tau, lane) : 0;
  // the needed eigenvalues before j (j's slot), and the one just before
  int slot = 0;
  for (int i = lane; i < j; i += 32) slot += needed(w, i, mode, side, tau);
  for (int o = 16; o > 0; o >>= 1) slot += __shfl_xor_sync(kFull, slot, o);
  if (j == 0 && lane == 0) {  // the call's count and side, for steps 4 and 5
    int cnt = 0;
    for (int i = 0; i < ne; ++i) cnt += needed(w, i, mode, side, tau);
    ctl[kCount] = cnt;
    ctl[kSide] = side;
  }
  if (!needed(w, j, mode, side, tau)) return;
  int prev = j - 1;
  while (prev >= 0 && !needed(w, prev, mode, side, tau)) --prev;
  if (prev >= 0 && !(w[j] - w[prev] > ortol)) return;  // not the group's first
  // the group: j, then each next needed eigenvalue within ortol of the last
  double* Z = ws + g.Z;
  const int s0 = slot;
  int cur = j, s = slot, most = 0;
  double xs = w[j];
  for (;;) {
    const int its = tri::inverse_iteration(Dg, Eo, d, xs, tn, cur, x, x + d, piv,
                                           Z + (size_t)s0 * d, s - s0, lane);
    most = max(most, its);
    for (int i = lane; i < d; i += 32) Z[(size_t)s * d + i] = x[i];
    if (lane == 0) ws[g.ls + s] = w[cur];
    __syncwarp();
    int nx = cur + 1;
    while (nx < ne && !needed(w, nx, mode, side, tau)) ++nx;
    if (nx >= ne || w[nx] - w[cur] > ortol) break;
    // dstein: the next shift at least 10 eps |lambda| above the last
    const double pert = 10.0 * DBL_EPSILON * fabs(w[nx]);
    xs = w[nx] - xs < pert ? xs + pert : w[nx];
    cur = nx, ++s;
  }
  if (lane == 0) atomicMax(p.sweeps + b, most > kMaxIters ? omc::kJacobiMaxSweeps + 1 : most);
}

// ---- 4. y = Q z: a warp a vector, z in registers ----
template <int kQ>
__global__ void __launch_bounds__(kWarpsB * 32) k4t_back(K4ParamsT<double> p) {
  const int b = blockIdx.x, d = p.d, lane = threadIdx.x & 31;
  const int s = blockIdx.y * kWarpsB + (threadIdx.x >> 5);
  const TGeom g(d, p.mode);
  double* ws = p.work + (size_t)b * g.mat;
  const int cnt = (int)ws[g.ctl + kCount];
  if (s >= cnt) return;
  const bool bad = ws[g.ctl + kBad] != 0.0;
  double* zs = ws + g.Z + (size_t)s * d;
  double z[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int r = lane + 32 * q;
    z[q] = r < d ? zs[r] : 0.0;
  }
  for (int i = d - 3; i >= 0; --i) {
    const double ti = ws[g.tau + i];
    if (ti == 0.0) continue;
    const double* v = ws + g.R + (size_t)i * d;
    double vr[kQ], dot = 0.0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = lane + 32 * q;
      vr[q] = r > i && r < d ? v[r] : 0.0;
      dot = fma(vr[q], z[q], dot);
    }
    dot = omc::warp_sum_d(dot) * ti;
#pragma unroll
    for (int q = 0; q < kQ; ++q) z[q] = fma(-dot, vr[q], z[q]);
  }
  double s2 = 0.0;
#pragma unroll
  for (int q = 0; q < kQ; ++q) s2 = fma(z[q], z[q], s2);
  const double inv = 1.0 / sqrt(omc::warp_sum_d(s2));
  if (p.mode == 2) {
    double* Vb = p.V + (size_t)b * d * p.nout;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = lane + 32 * q;
      if (r < d) Vb[(size_t)r * p.nout + s] = bad ? omc::qnan_of(0.0) : z[q] * inv;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = lane + 32 * q;
      if (r < d) zs[r] = z[q] * inv;
    }
  }
}

// ---- 5. P = base + sum_s c_s y_s y_s' on the upper 32 x 32 tiles ----
__global__ void __launch_bounds__(256) k4t_assemble(K4ParamsT<double> p) {
  __shared__ double yr[kTile][kTile + 1], yc[kTile][kTile + 1], cs[kTile];
  const int b = blockIdx.x, d = p.d, tid = threadIdx.x;
  const TGeom g(d, p.mode);
  const double* ws = p.work + (size_t)b * g.mat;
  // the tile pair (I, J), I <= J, of blockIdx.y
  int I = 0, t = blockIdx.y;
  const int nt = omc::cdiv(d, kTile);
  while (t >= nt - I) t -= nt - I, ++I;
  const int J = I + t, r0 = I * kTile, c0 = J * kTile;
  const int cnt = (int)ws[g.ctl + kCount], side = (int)ws[g.ctl + kSide];
  const bool bad = ws[g.ctl + kBad] != 0.0;
  const int tc = tid & 31, tr = tid >> 5;  // column, and the first of 4 rows
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int s0 = 0; s0 < cnt; s0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += 256) {
      const int sl = e >> 5, i = e & 31, s = s0 + sl;
      const double* y = ws + g.Z + (size_t)s * d;
      yr[sl][i] = s < cnt && r0 + i < d ? y[r0 + i] : 0.0;
      yc[sl][i] = s < cnt && c0 + i < d ? y[c0 + i] : 0.0;
    }
    if (tid < kTile) cs[tid] = s0 + tid < cnt ? side * ws[g.ls + s0 + tid] : 0.0;
    __syncthreads();
    const int ns = min(kTile, cnt - s0);
    for (int sl = 0; sl < ns; ++sl) {
      const double ycs = yc[sl][tc];
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[h] = fma(cs[sl] * yr[sl][tr + 8 * h], ycs, acc[h]);
    }
  }
  const omc::ROT<double> Mb{p.M + (size_t)b * d * d};
  double* Pb = p.P + (size_t)b * d * d;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = r0 + tr + 8 * h, c = c0 + tc;
    if (r >= d || c >= d || (I == J && r > c)) continue;
    const double base = side < 0 ? 0.5 * (Mb[(size_t)r * d + c] + Mb[(size_t)c * d + r]) : 0.0;
    const double v = bad ? omc::qnan_of(0.0) : base + acc[h];
    Pb[(size_t)r * d + c] = v;
    Pb[(size_t)c * d + r] = v;
  }
}

int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <int kQ>
int launch_tri(const K4ParamsT<double>& p, cudaStream_t st) {
  static bool attr = false;
  const int d = p.d, B = p.B;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        k4t_reduce<kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return fail(err);
    attr = true;
  }
  k4t_reduce<kQ><<<B, kThreadsR, reduce_smem(d), st>>>(p);
  const int ne = p.mode == 1 ? d : p.nout;
  k4t_eigvals<<<dim3(B, omc::cdiv(ne, kWarpsE)), kWarpsE * 32, 16 * d, st>>>(p, ne);
  if (p.mode == 0) return (int)cudaGetLastError();
  const size_t vsmem = 16 * (size_t)d + (size_t)kWarpsE * (40 * (size_t)d + d);
  k4t_vectors<<<dim3(B, omc::cdiv(ne, kWarpsE)), kWarpsE * 32, vsmem, st>>>(p, ne);
  // at most d / 2 vectors in mode 1 (the side with fewer), nout in mode 2
  const int most = p.mode == 1 ? d / 2 + 1 : p.nout;
  k4t_back<kQ><<<dim3(B, omc::cdiv(most, kWarpsB)), kWarpsB * 32, 0, st>>>(p);
  if (p.mode == 1) {
    const int nt = omc::cdiv(d, kTile);
    k4t_assemble<<<dim3(B, nt * (nt + 1) / 2), 256, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// the tridiagonal path's workspace, in doubles (omc_k4_workspace_floats at
// path 2)
long long k4t_workspace_doubles(int B, int d, int mode) {
  return (long long)B * TGeom(d, mode).mat;
}

// path 2 of omc_k4_jacobi_f64 (csrc/k4_jacobi.cu): float64 operands, M
// given (not K5's U U' - Y), d <= kTriMaxD, the workspace given
int k4t_entry(const K4ParamsT<double>& p, void* stream) {
  if (!p.M || !p.work || !p.sweeps || p.d < 1 || p.d > kTriMaxD || p.B < 1 || p.mode < 0 ||
      p.mode > 2 || (p.mode != 1 && (p.nout < 1 || p.nout > p.d)) || !reduce_smem(p.d))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return p.d <= 128 ? launch_tri<4>(p, st) : launch_tri<8>(p, st);
}

// the reduction CTA's shared memory (omc_torch.ops.cones.k4_tri_smem_bytes)
OMC_EXPORT long long omc_k4_tri_smem_bytes(int d) { return (long long)reduce_smem(d); }
