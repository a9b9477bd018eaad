// Shared helpers and the C parameter blocks of the omc_torch kernels.
//
// Every entry point takes a pointer to its parameter block (laid out like
// the ctypes.Structure of the same name in omc_torch/kernels.py), launches
// on the given stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cfloat>

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; every thread gets the result.  `red` holds >= 32 floats
// of shared memory; the call contains two __syncthreads().
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  const int nw = (blockDim.x + 31) >> 5;
  for (int i = 0; i < nw; ++i) r += red[i];
  __syncthreads();
  return r;
}

// C = A B for D x D matrices in registers
template <int D>
__device__ __forceinline__ void mm_small(const float (&A)[D][D], const float (&B)[D][D],
                                         float (&C)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float c = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) c = fmaf(A[i][k], B[k][j], c);
      C[i][j] = c;
    }
}

// Sign-schedule PSD projection of one D x D matrix held by one thread in
// registers (plain version: omc_torch.ops.polar.project_psd_ns_small):
// T <- sym(T); W <- (T + sign(T) T) / 2, symmetrised, with sign(T) from the
// 12 quintic + 2 cubic steps of kSignSched on T / ||T||_F (43 products).
template <int D>
__device__ __forceinline__ void project_psd_small(float (&T)[D][D], float (&W)[D][D]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j > i) {
        const float a = 0.5f * (T[i][j] + T[j][i]);
        T[i][j] = a;
        T[j][i] = a;
      }
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) ss = fmaf(T[i][j], T[i][j], ss);
  const float s = sqrtf(ss) + 1e-30f;
  float S[D][D], S2[D][D], M[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) S[i][j] = T[i][j] / s;
  for (int step = 0; step < kSignSteps; ++step) {
    const float a = kSignSched[step][0], b = kSignSched[step][1], c = kSignSched[step][2];
    mm_small<D>(S, S, S2);
    if (c != 0.f) {
      mm_small<D>(S2, S2, M);  // S^4
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) M[i][j] = b * S2[i][j] + c * M[i][j];
      mm_small<D>(S, M, S2);   // S (b S^2 + c S^4)
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) S[i][j] = a * S[i][j] + S2[i][j];
    } else {
      mm_small<D>(S, S2, M);   // S^3
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) S[i][j] = a * S[i][j] + b * M[i][j];
    }
  }
  mm_small<D>(S, T, M);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) W[i][j] = 0.5f * (T[i][j] + M[i][j]);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i + 1; j < D; ++j) {
      const float a = 0.5f * (W[i][j] + W[j][i]);
      W[i][j] = a;
      W[j][i] = a;
    }
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

// ---- Jacobi eigensolver core (K4, K4s, K5; mirror: omc_torch/ops/jacobi.py)

// sweeps before the loop gives up; a sweep count of kJacobiMaxSweeps + 1
// means the cap was hit
constexpr int kJacobiMaxSweeps = 30;

// The floor of the stopping rule: eps ||A||_F / (4 d), or NaN for a
// non-finite matrix, so that every pair then rotates until the cap.
__device__ __forceinline__ float jacobi_floor(float normF, int d) {
  return isfinite(normF) ? FLT_EPSILON * normF / (4.f * d) : __int_as_float(0x7fffffff);
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

// (c x - s y, s x + c y) in Rutishauser's form: the rounding error is
// relative to the change, so small late-sweep angles keep V orthogonal
__device__ __forceinline__ void jacobi_rot(float& x, float& y, float s, float r) {
  const float x0 = x, y0 = y;
  x = x0 - s * (y0 + r * x0);
  y = y0 + s * (x0 - r * y0);
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

struct K2Params {
  const float *w1, *u1, *w2, *u2, *w3, *u3, *w4, *u4, *wsoc, *usoc, *wbox,
      *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  const float *cut_x, *cut_lo, *cut_hi, *cut_mask;
  const float *maskA, *mask;  // (n, m): mask * A and the 0/1 mask
  const float *sX, *sT, *rho;  // (B,)
  const float* G1c;            // (B, p, p) lower Cholesky factor of G1
  float *Xs, *Y, *Ths, *U;     // outputs
  int B, n, m, k, L;
  float gamma;
};

struct K3Params {
  const float *Xs, *Y, *Ths, *U;
  const float *w1, *u1, *w2, *u2, *w3, *u3;
  float *t1, *t2, *t3;
  float *w4, *u4, *wsoc, *usoc, *wbox, *ubox, *wa, *ua, *wb, *ub, *wc, *uc;
  float *acc_a, *acc_b, *acc_c;
  const float *cut_x, *cut_lo, *cut_hi, *cut_mask, *U_lo, *U_hi;
  const float *sX, *sT, *rho;
  int B, n, m, k, L;
  float alpha, beta;
};

// K7: with t given, w = proj_PSD(t) for N 5x5 matrices; with t null, the
// Shor minor slots of B node slots (N = B * M5) are gathered from the
// primal, relax-mixed with w/u, projected, and u and the EMA updated.
struct K7Params {
  const float* t;              // (N, 5, 5) or null
  float* w;                    // (N, 5, 5) projections (w5 in place)
  float* u;                    // (N, 5, 5) u5 (gather mode)
  float* acc;                  // (N, 5, 5) EMA of rho*u5, or null
  const float *Xs, *Ws;        // (B, n*m) scaled primal
  const float *v1, *v2, *v3;   // (B, P1), (B, P2), (B, P3)
  const int* minor_idx;        // (B, M5, 4)
  const int *iv1a, *iv1b, *iv2a, *iv2b, *iv3;  // (B, M5)
  const float* minor_mask;     // (B, M5)
  const float *sS, *rho;       // (B,)
  int N, M5, nm, P1, P2, P3, m;
  float alpha, beta;
};

// K8a: the Shor part of the z-step (adjoint of the minor, RSOC, link and
// W >= 0 slots, diagonal solves, Theta-link correction) -> Xs, Ths, W, v.
struct K8aParams {
  const float *w1, *u1;                 // (B, n+m, n+m)
  const float *w5, *u5;                 // (B, M5, 5, 5)
  const float *wr, *ur, *soc_mask;      // (B, n*m, 3), (B, n*m)
  const float *wl, *ul;                 // (B, m)
  const float *wp, *up;                 // (B, n, m)
  const int *xw_ptr, *xw_ent, *v1_ptr, *v1_ent, *v2_ptr, *v2_ent, *v3_ptr, *v3_ent;
  const float *cnt_X, *cnt_W, *cnt_v1, *cnt_v2, *cnt_v3;
  const float* g_link;                  // (B, m) Theta-link Gram diagonal
  const float *maskA, *mask;            // (n, m)
  const float *sX, *sT, *sS, *rho;      // (B,)
  float *Xs, *Ths, *Ws, *v1, *v2, *v3;  // outputs
  int B, n, m, M5, P1, P2, P3;
  float gamma, R_X;                     // R_X = sqrt(2 gamma ub_bar)
};

// K8b: cone step of the RSOC, Theta-link and W >= 0 slots with their EMAs.
struct K8bParams {
  const float *Xs, *Ws, *Ths;    // (B, n, m), (B, n, m), (B, m, m)
  float *wr, *ur, *acc_r;        // (B, n*m, 3)
  const float* soc_mask;         // (B, n*m)
  float *wl, *ul, *acc_l;        // (B, m)
  float *wp, *up;                // (B, n, m)
  const float *sX, *sT, *sS, *rho;
  int B, n, m;
  float alpha, beta;
};

// K7t: the per-term 5x5 minor slots of the rank-k Shor relaxation, gathered
// from term t of Xt, Wt and v1-v3, relax-mixed, projected, u and EMA updated.
struct K7tParams {
  float *w, *u, *acc;                    // (B, M5, k, 5, 5); acc may be null
  const float *Xt;                       // (B, k, n*m) scaled
  const float *Wt;                       // (B, k, C)
  const float *v1, *v2, *v3;             // (B, k, P1), (B, k, P2), (B, k, P3)
  const int *mc;                         // (B, M5, 4) coordinate of each corner
  const int *coord_flat;                 // (B, C)
  const int *iv1a, *iv1b, *iv2a, *iv2b, *iv3;  // (B, M5)
  const float *minor_mask;               // (B, M5)
  const float *sS, *rho;                 // (B,)
  int B, M5, k, nm, C, P1, P2, P3;
  float alpha, beta;
};

// K7x: with t given, w = proj_PSD(t) for N (k+1)x(k+1) matrices; with t
// null, the XWH slots [[1, Xt'], [Xt, M]] of N = B * C coordinates.
struct K7xParams {
  const float* t;                        // (N, D, D) or null
  float *w, *u, *acc;                    // (N, D, D); u, acc in the slot mode
  const float *Xt, *Wt, *Hh;             // (B, k, n*m), (B, k, C), (B, kp, C)
  const int* coord_flat;                 // (B, C)
  const float* coord_mask;               // (B, C)
  const float *sS, *rho;                 // (B,)
  int N, C, k, nm;
  float alpha, beta;
};

// K8c: the rank-k Shor z-step (adjoint of every Shor slot, Sherman-Morrison
// X solve per entry, diagonal solves, link Woodbury, clip) -> Xt, X = sum_t
// Xt, Theta, W, Wt, H, v1-v3.
struct K8cParams {
  const float *w1, *u1;                  // (B, n+m, n+m)
  const float *w5, *u5;                  // (B, M5, k, 5, 5)
  const float *wx, *ux;                  // (B, C, k+1, k+1)
  const float *wr, *ur;                  // (B, Ms, 3)
  const float *wl, *ul;                  // (B, m)
  const float *wwl, *uwl;                // (B, C)
  const float *wp, *up;                  // (B, n, m)
  const float *wq, *uq;                  // (B, k, C)
  const float *soc_mask, *coord_mask;    // (B, Ms), (B, C)
  const int* coord_flat;                 // (B, C)
  const int *cm_ptr, *cm_ent;            // coordinate -> 4 l + corner (table a)
  const int *col_ptr, *col_ent;          // column -> coordinates (table b)
  const int *flat_coord, *flat_soc;      // (B, n*m) entry -> coordinate / RSOC slot or -1
  const int *v1_ptr, *v1_ent, *v2_ptr, *v2_ent, *v3_ptr, *v3_ent;
  const float *D1x, *c1x, *D1w;          // (B, n*m)
  const float *D1wt, *D1h, *D_c, *B_jc;  // (B, C)
  const float* S_th;                     // (B, m)
  const float *D1v1, *D1v2, *D1v3;       // (B, P*)
  const float *maskA, *mask;             // (n, m)
  const float *sX, *sT, *sS, *rho;       // (B,)
  float *Xt, *Xs, *Ths, *Ws, *Wt, *Hh, *v1, *v2, *v3;  // outputs
  int B, n, m, k, M5, C, Ms, P1, P2, P3;
  float gamma, R_X;                      // R_X = sqrt(2 gamma ub_bar)
};

// K9s: rho-free factorisations of the McCormick z-step (once per solve call)
struct K9sParams {
  const float *U_lo, *U_hi;   // (B, n, k) node boxes
  float* Mc;                  // (B, n, k+q, k+q) lower Cholesky factors of the row Grams
  float* Si;                  // (B, n, k+q, q) M_i^-1 E_t
  float* Gc;                  // (B, q, q) lower Cholesky factor of G = I + sum_i Si[i, k:, :]
  int B, n, k;
};

// K9a: McCormick adjoint + z-step -> Xs, Y, Ths, U, t
struct K9aParams {
  const float *w1, *u1, *w2, *u2, *w3, *u3, *w4, *u4, *wsoc, *usoc, *wbox, *ubox,
      *wmc, *umc, *worth, *uorth;
  const float *U_lo, *U_hi;   // (B, n, k)
  const float *maskA, *mask;  // (n, m)
  const float *sX, *sT, *rho; // (B,)
  const float *Mc, *Si, *Gc;  // K9s
  float *Xs, *Y, *Ths, *U, *t;
  int B, n, m, k;
  float gamma;
};

// K9b: McCormick forward map + cone step of every slot but the PSD blocks,
// with the running means of rho*umc and rho*uorth (acc null: none)
struct K9bParams {
  const float *Xs, *Y, *Ths, *U, *t;
  const float *w1, *u1, *w2, *u2, *w3, *u3;
  float *t1, *t2, *t3;
  float *w4, *u4, *wsoc, *usoc, *wbox, *ubox, *wmc, *umc, *worth, *uorth;
  float *acc_mc, *acc_orth;
  const float *U_lo, *U_hi, *sX, *sT, *rho;
  int B, n, m, k;
  float alpha, beta;
};

// K8d: cone step of the RSOC, Theta-link, W-link, W >= 0 and Wt >= 0 slots
// of the rank-k Shor relaxation, with the EMAs of rho*ur, rho*ul, rho*uwl.
struct K8dParams {
  const float *Xs, *Ws, *Ths, *Wt, *Hh;  // (B,n,m), (B,n,m), (B,m,m), (B,k,C), (B,kp,C)
  float *wr, *ur, *acc_r;                // (B, Ms, 3)
  float *wl, *ul, *acc_l;                // (B, m)
  float *wwl, *uwl, *acc_wl;             // (B, C)
  float *wp, *up;                        // (B, n, m)
  float *wq, *uq;                        // (B, k, C)
  const int* soc_flat;                   // (B, Ms)
  const float* soc_mask;                 // (B, Ms)
  const int* coord_flat;                 // (B, C)
  const float* coord_mask;               // (B, C)
  const float *sX, *sT, *sS, *rho;       // (B,)
  int B, n, m, k, C, Ms;
  float alpha, beta;
};

// K4 / K5: batched symmetric eigensolver, one CTA per matrix.  K4 reads M;
// K5 (M null) forms U U' - Y.  mode 0: the eigenvalues ascending into w
// (nout = d); mode 1: the PSD projection V max(w, 0) V' into P; mode 2: the
// nout smallest eigenpairs into w and V.
struct K4Params {
  const float* M;      // (B, d, d), or null for K5
  const float *U, *Y;  // K5: (B, d, k), (B, d, d)
  float* w;            // (B, nout) or null
  float* V;            // (B, d, nout) or null
  float* P;            // (B, d, d) or null
  int* sweeps;         // (B,) sweeps run; kJacobiMaxSweeps + 1 at the cap
  float* work;         // (B, omc_k4_workspace_floats(d, mode)) or null
  int B, d, k, nout, mode;
};

// K4s: PSD projection of N tiny (D x D, D <= 8) symmetric matrices, one
// thread per matrix in registers
struct K4sParams {
  const float* t;      // (N, D, D)
  float* w;            // (N, D, D)
  int* sweeps;         // (N,) or null
  int N, D;
};

// K6: altmin's masked ridge step; the V-step reads U (B, n, k) and writes
// V (B, k, m), the U-step reads V (B, k, m) and writes U (B, n, k)
struct K6Params {
  const float* F;      // the fixed factor
  const float *A, *mask;  // (n, m)
  float* out;          // the solved factor
  int B, n, m, k;
  float inv_gamma, ridge_eps;
};
