// K8 — the Shor slots outside the 5x5 minors, in two launches.
//
// K8a replaces, per node slot, the Shor part of the z-step of
// omc/sdp/admm_shor.py: _adjoint_shor (:178-218, the scatter-add of the
// minor, RSOC and link duals onto X, W, v1, v2, v3), the W >= 0 adjoint
// (:331), the diagonal solves of X, Theta, W, v (:336-353), the Theta-link
// Woodbury correction (:363-371), sym(Theta) and the clip of X to +-R_X/sX
// (:374-376).  The base slots' share of X and Theta comes from w1 - u1 here
// (K2 runs in its Shor mode and writes Y and U only).
//
// K8b replaces the cone step of the RSOC rows (:423-427, project_rsoc of
// omc/ops/cones.py:49-66 in closed form per coordinate), the Theta-link
// rows (:429-431) and the W >= 0 slot (:433-435), with the dual EMAs of
// rho*ur and rho*ul (:493-494).
//
// What bounds both on the H100: bytes, and for K8a at small batches the
// latency of its dependent gathers.  Per slot they stream the n*m
// coordinates' X, W, RSOC (3 floats), W >= 0 and count arrays once, plus
// the minor duals through the inverse tables, with a few flops each.  The
// adjoint gathers each coordinate's and each v entry's minor duals through
// the CSR inverse tables built on the host once per visit, summed in the
// tables' (ascending minor) order, so every sum is deterministic (no
// atomics); four entries' loads are in flight at once.
//
// K8a's grid is sized to the card (omc_torch.sdp.admm_shor.k8a_plan), with
// three kinds of CTA per node slot (grid (omc_k8a_grid_x, B), clusters of C
// along x):
//  (a) x < Q C: Q clusters on the X/W coordinates, cluster k owning columns
//      [k m / Q, (k + 1) m / Q) and its CTA r rows [r n / C, (r + 1) n / C),
//      the tile's items (i, j) walked flat with consecutive threads on
//      consecutive j.  The link rows need the column sums of zW over every
//      row: each CTA keeps its tile of zW (and of W's diagonal) in shared
//      memory and sums its rows in order, the cluster adds the C partials
//      in rank order through distributed shared memory, every CTA forms t_l
//      and writes its W once, corrected, and rank 0 writes Theta's
//      diagonal.  One launch, no atomics, the same bits every run.
//  (b) then one CTA per 32 x 32 tile pair (I, J), I >= J, of Theta's
//      off-diagonal: both tiles of w1 - u1 read by rows into shared memory
//      and written as sym(Theta) by rows, so both reads are coalesced.
//  (c) then the 5 M5 v entries of the slot, one a thread.
// K8b's grid is sized to the card too (omc_torch.sdp.admm_shor.k8b_plan),
// one dimension, two kinds of CTA:
//  (l) x < B ceil(m / 32): the link rows of 32 columns of a slot, 4 row
//      groups of 32 threads, group g summing sW W_ij over the rows i = g
//      (mod 4) in row order, then the 4 partials in order: no atomics, the
//      same bits every run; then t_l, wl, ul and the EMA.  They re-read W,
//      4 of the ~96 bytes a coordinate.
//  (q) then the coordinates of the whole batch, walked flat: a thread takes
//      a quad of 4 consecutive coordinates with 16-byte loads and stores of
//      X, W, the mask, wp and up, a CTA qpc quads (the plan narrows the
//      CTAs until there are enough to fill the card), and a warp's RSOC
//      triples are staged through shared memory as whole 16-byte words.  No
//      coordinate depends on another, so a thread's loads are all in flight
//      at once (the operands are __restrict__: no load waits on a store).
//
// The float64 builds (omc_k8a_shor_zstep_f64, omc_k8b_shor_cone_f64) are
// the same kernels on doubles: K8a's shared memory and the cluster's
// partial column sums (still added in rank order) in doubles, K8b's thread
// taking a pair of coordinates (one 16-byte word of each of X, W, the mask,
// wp and up; its 6 RSOC values 3 words of the warp's staging, at the float
// build's stride), and every divide, square root and 1/sqrt2 of the float
// build done as omc::quot and project_rsoc1's float64 form do them (the
// hardware reciprocal or rsqrt refined, not the IEEE slow paths).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD5 = 25;                        // floats per 5x5 minor slot
constexpr int kTile = 32;                      // K8a's Theta tiles
constexpr int kClusterMax = 8;                 // K8a's clusters: the portable size
constexpr int kChunk = 4;                      // CSR entries whose loads fly together

template <class T>
__device__ __forceinline__ T y5(const T* w5, const T* u5, int l, int i, int j) {
  const int q = l * kD5 + i * 5 + j;
  return w5[q] - u5[q];
}

// The sum of term(ent[e]) over the CSR list e in [lo, hi), in list order:
// kChunk entries' loads are issued before any of them is added.
template <class T, class Term>
__device__ __forceinline__ T csr_sum(const int* ent, int lo, int hi, Term term) {
  T g = 0;
  for (int e0 = lo; e0 < hi; e0 += kChunk) {
    T v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = e0 + u < hi ? term(ent[e0 + u]) : T(0);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (e0 + u < hi) g += v[u];
  }
  return g;
}

// the tile pair (I, J), I >= J, of index pr = I (I + 1) / 2 + J
__device__ __forceinline__ void tile_pair(int pr, int& I, int& J) {
  I = (int)((sqrtf(8.0f * pr + 1.0f) - 1.0f) * 0.5f);
  while (I * (I + 1) / 2 > pr) --I;
  while ((I + 1) * (I + 2) / 2 <= pr) ++I;
  J = pr - I * (I + 1) / 2;
}

// (a): the X/W coordinates of rows [band_lo(n, C, r), band_lo(n, C, r + 1))
// and columns [band_lo(m, Q, k), band_lo(m, Q, k + 1)), the cluster's column
// sums, t_l, W's correction and Theta's diagonal there; shared memory holds
// the columns' partials and t_l, then the tile's zW and W's diagonal d_W
// (values of T; the divides are omc::quot's)
template <class T>
__device__ __forceinline__ void k8a_coords(const K8aParamsT<T>& p, int b, int k, T* smem) {
  using omc::quot;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = p.C;
  const int n = p.n, m = p.m, D1 = n + m, nm = n * m;
  const int lo = omc::band_lo(n, C, r), hi = omc::band_lo(n, C, r + 1);
  const int j0 = omc::band_lo(m, p.Q, k), mw = omc::band_lo(m, p.Q, k + 1) - j0;
  const int items = (hi - lo) * mw;
  const float inv_w = 1.0f / (float)mw;
  T* part = smem;
  T* tl_s = part + mw;
  T* zw_s = tl_s + mw;
  T* dw_s = zw_s + items;
  const T rho = p.rho[b], sX = p.sX[b], sT = p.sT[b], sS = p.sS[b];
  const T sW = sX * sX, sS2 = sS * sS;
  const T* w1 = p.w1 + (size_t)b * D1 * D1;
  const T* u1 = p.u1 + (size_t)b * D1 * D1;
  const T* w5 = p.w5 + (size_t)b * p.M5 * kD5;
  const T* u5 = p.u5 + (size_t)b * p.M5 * kD5;
  const int* xw_ptr = p.xw_ptr + (size_t)b * (nm + 1);
  const int* xw_ent = p.xw_ent + (size_t)b * 4 * p.M5;
  const T R_Xs = quot(p.R_X, sX);
  T* Ws = p.Ws + (size_t)b * nm;

  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    int il, jl;
    omc::divmod(e, mw, inv_w, il, jl);
    const int i = lo + il, j = j0 + jl, f = i * m + j;
    const size_t q = (size_t)b * nm + f;
    const T yl = p.wl[b * m + j] - p.ul[b * m + j];
    // the minors at this coordinate: 2 sS y5[0, c] on X, sS y5[c, c] on W
    T gx = 0, gw = 0;
    const int e1 = xw_ptr[f + 1];
    for (int e0 = xw_ptr[f]; e0 < e1; e0 += kChunk) {
      T vx[kChunk], vw[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        vx[u] = vw[u] = T(0);
        if (e0 + u < e1) {
          const int ent = xw_ent[e0 + u], l = ent >> 2, c = (ent & 3) + 1;
          vx[u] = T(2) * (sS * y5(w5, u5, l, 0, c));
          vw[u] = sS * y5(w5, u5, l, c, c);
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (e0 + u < e1) gx += vx[u], gw += vw[u];
    }
    const T sm = p.soc_mask[q];
    gw += sS * (p.wr[3 * q + 1] - p.ur[3 * q + 1]) * sm;
    gx += sS * (p.wr[3 * q + 2] - p.ur[3 * q + 2]) * sm;
    gw = gw - sW * yl;
    gw = gw + sS * (p.wp[q] - p.up[q]);
    const size_t q1 = (size_t)i * D1 + n + j;
    const T rX = sX * T(2) * (w1[q1] - u1[q1]);
    const T RX = rho * (rX + gx) + sX * p.maskA[f];
    const T dX1 = T(2) * sX * sX + sS2 * p.cnt_X[q];
    const T zX = quot(RX, rho * dX1);
    p.Xs[q] = fmin(fmax(zX, -R_Xs), R_Xs);
    const T RW = rho * gw - T(0.5) * sW * p.mask[f];
    const T dW1 = sS2 * fmax(p.cnt_W[q], T(1));
    zw_s[e] = quot(RW, rho * dW1);
    dw_s[e] = dW1;
  }
  __syncthreads();
  // this CTA's column sums of zW, its rows in order
  for (int jl = threadIdx.x; jl < mw; jl += blockDim.x) {
    T s = 0;
    for (int il = 0; il < hi - lo; ++il) s += zw_s[il * mw + jl];
    part[jl] = s;
  }
  omc::cluster_arrive();
  omc::cluster_wait();
  // the cluster's sums in rank order -> t_l; Theta's diagonal from rank 0
  T* Ths = p.Ths + (size_t)b * m * m;
  for (int jl = threadIdx.x; jl < mw; jl += blockDim.x) {
    const int j = j0 + jl;
    T v[kClusterMax];
#pragma unroll
    for (int rr = 0; rr < kClusterMax; ++rr)
      if (rr < C) v[rr] = *cluster.map_shared_rank(part + jl, rr);
    T s = 0;
#pragma unroll
    for (int rr = 0; rr < kClusterMax; ++rr)
      if (rr < C) s += v[rr];
    const T yl = p.wl[b * m + j] - p.ul[b * m + j];
    const size_t qd = (size_t)(n + j) * D1 + n + j;
    const T RT = rho * (sT * (w1[qd] - u1[qd]) + sT * yl) - quot(sT * T(0.5), p.gamma);
    const T zTh = quot(RT, rho * sT * sT);
    const T t_l = quot(rho * (sT * zTh - sW * s), p.g_link[b * m + j]);
    tl_s[jl] = t_l;
    if (r == 0) Ths[(size_t)j * m + j] = zTh - quot(t_l, rho * sT);
  }
  __syncthreads();
  omc::cluster_arrive();  // this CTA reads no peer's partials any more
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    int il, jl;
    omc::divmod(e, mw, inv_w, il, jl);
    Ws[(lo + il) * m + j0 + jl] = zw_s[e] + quot(sW * tl_s[jl], rho * dw_s[e]);
  }
  omc::cluster_wait();  // no CTA leaves while a peer may read its partials
}

// (b): Theta's off-diagonal on the tile pair (I, J), I >= J: sym of the base
// slots' share (no link term); the diagonal is (a)'s
template <class T>
__device__ __forceinline__ void k8a_theta(const K8aParamsT<T>& p, int b, int pr, T* tiles) {
  using omc::quot;
  int I, J;
  tile_pair(pr, I, J);
  T(*ta)[kTile + 1] = reinterpret_cast<T(*)[kTile + 1]>(tiles);
  T(*tb)[kTile + 1] = ta + kTile;
  const int n = p.n, m = p.m, D1 = n + m;
  const T* w1 = p.w1 + (size_t)b * D1 * D1;
  const T* u1 = p.u1 + (size_t)b * D1 * D1;
  const T rho = p.rho[b], sT = p.sT[b];
  const int lane = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int ny = blockDim.x / kTile;
  // ta[ii][jj] = z(I*32 + ii, J*32 + jj), tb[ii][jj] = z(J*32 + ii, I*32 + jj)
  for (int ii = ty; ii < kTile; ii += ny) {
    const int ra = I * kTile + ii, ca = J * kTile + lane;
    if (ra < m && ca < m) {
      const size_t q = (size_t)(n + ra) * D1 + n + ca;
      ta[ii][lane] = quot(rho * (sT * (w1[q] - u1[q])), rho * sT * sT);
    }
    const int rb = J * kTile + ii, cb = I * kTile + lane;
    if (I != J && rb < m && cb < m) {
      const size_t q = (size_t)(n + rb) * D1 + n + cb;
      tb[ii][lane] = quot(rho * (sT * (w1[q] - u1[q])), rho * sT * sT);
    }
  }
  __syncthreads();
  T* Ths = p.Ths + (size_t)b * m * m;
  for (int ii = ty; ii < kTile; ii += ny) {
    const int i = I * kTile + ii, j = J * kTile + lane;
    if (i < m && j < m && i != j)
      Ths[(size_t)i * m + j] = T(0.5) * (ta[ii][lane] + (I != J ? tb[lane][ii] : ta[lane][ii]));
    const int i2 = J * kTile + ii, j2 = I * kTile + lane;
    if (I != J && i2 < m && j2 < m)
      Ths[(size_t)i2 * m + j2] = T(0.5) * (tb[ii][lane] + ta[lane][ii]);
  }
}

// (c): the shared v entries v1 | v2 | v3, entry e of the slot
template <class T>
__device__ __forceinline__ void k8a_v(const K8aParamsT<T>& p, int b, int e) {
  const int P1 = p.P1, P2 = p.P2, P3 = p.P3;
  if (e >= P1 + P2 + P3) return;
  const T rho = p.rho[b], sS = p.sS[b], sS2 = sS * sS;
  const T* w5 = p.w5 + (size_t)b * p.M5 * kD5;
  const T* u5 = p.u5 + (size_t)b * p.M5 * kD5;
  T g, cnt;
  T* out;
  if (e < P1) {
    const int* ptr = p.v1_ptr + (size_t)b * (P1 + 1);
    g = csr_sum<T>(p.v1_ent + (size_t)b * 2 * p.M5, ptr[e], ptr[e + 1], [&](int ent) {
      const int l = ent >> 1;
      return (ent & 1) ? T(2) * (sS * y5(w5, u5, l, 3, 4)) : T(2) * (sS * y5(w5, u5, l, 1, 2));
    });
    cnt = p.cnt_v1[(size_t)b * P1 + e];
    out = p.v1 + (size_t)b * P1 + e;
  } else if (e < P1 + P2) {
    const int r = e - P1;
    const int* ptr = p.v2_ptr + (size_t)b * (P2 + 1);
    g = csr_sum<T>(p.v2_ent + (size_t)b * 2 * p.M5, ptr[r], ptr[r + 1], [&](int ent) {
      const int l = ent >> 1;
      return (ent & 1) ? T(2) * (sS * y5(w5, u5, l, 2, 4)) : T(2) * (sS * y5(w5, u5, l, 1, 3));
    });
    cnt = p.cnt_v2[(size_t)b * P2 + r];
    out = p.v2 + (size_t)b * P2 + r;
  } else {
    const int r = e - P1 - P2;
    const int* ptr = p.v3_ptr + (size_t)b * (P3 + 1);
    g = csr_sum<T>(p.v3_ent + (size_t)b * p.M5, ptr[r], ptr[r + 1], [&](int l) {
      return T(2) * (sS * y5(w5, u5, l, 1, 4) + sS * y5(w5, u5, l, 2, 3));
    });
    cnt = p.cnt_v3[(size_t)b * P3 + r];
    out = p.v3 + (size_t)b * P3 + r;
  }
  *out = omc::quot(rho * g, rho * (sS2 * fmax(cnt, T(1))));
}

// CTAs of each kind a slot takes: Q C on the coordinates, one per tile pair
// of Theta, one per kThreads v entries; the slot's row of the grid rounded
// up to whole clusters
struct K8aLayout {
  int coords, pairs, vctas, grid_x;
};

__host__ __device__ __forceinline__ K8aLayout k8a_layout(int m, int P, int C, int Q) {
  const int nt = omc::cdiv(m, kTile);
  K8aLayout l;
  l.coords = Q * C;
  l.pairs = nt * (nt + 1) / 2;
  l.vctas = omc::cdiv(P, omc::kThreads);
  l.grid_x = omc::cdiv(l.coords + l.pairs + l.vctas, C) * C;
  return l;
}

// the partials, t_l, zW and d_W of a coordinates' CTA (at most cdiv(n, C)
// rows of cdiv(m, Q) columns), or the two tiles, in values of elem bytes
// (4, or 8 in the float64 build)
__host__ __device__ __forceinline__ int k8a_smem(int n, int m, int C, int Q, int elem) {
  const int rows = omc::cdiv(n, C), cols = omc::cdiv(m, Q);
  const int tiles = 2 * kTile * (kTile + 1), coords = 2 * cols + 2 * rows * cols;
  return elem * (tiles > coords ? tiles : coords);
}

template <class T>
__global__ void __launch_bounds__(omc::kThreads) k8a_kernel(K8aParamsT<T> p) {
  extern __shared__ __align__(16) unsigned char k8a_smem_raw[];
  T* const smem = reinterpret_cast<T*>(k8a_smem_raw);
  const int b = blockIdx.y, x = blockIdx.x;
  const K8aLayout l = k8a_layout(p.m, p.P1 + p.P2 + p.P3, p.C, p.Q);
  if (x < l.coords) {
    k8a_coords(p, b, x / p.C, smem);
  } else if (x < l.coords + l.pairs) {
    k8a_theta(p, b, x - l.coords, smem);
  } else {
    k8a_v(p, b, (x - l.coords - l.pairs) * blockDim.x + threadIdx.x);
  }
}

// K8b's CTA (both kinds); its link CTAs are omc::link_rows's
constexpr int kThreads8b = 128;
static_assert(kThreads8b == omc::kLinkCols * omc::kLinkRows, "a link CTA is 32 x 4 threads");

struct K8bLayout {
  int links, coords, grid_x;
};

// E = 16 / elem consecutive coordinates a thread (quads; pairs in the
// float64 build), qpc of them a coordinates' CTA
__host__ __device__ __forceinline__ K8bLayout k8b_layout(int B, int n, int m, int qpc, int E) {
  K8bLayout l;
  l.links = B * omc::cdiv(m, omc::kLinkCols);
  l.coords = omc::cdiv(omc::cdiv(B * n * m, E), qpc);
  l.grid_x = l.links + l.coords;
  return l;
}

using omc::lane4;

// (q): the groups [quad0, quad0 + qpc) of E = 16 / sizeof(T) consecutive
// coordinates of the batch's flat B n m (quads of floats, pairs of
// doubles), a group a thread (fewer than E coordinates at the ragged end),
// a warp 32 groups.  The RSOC triples of a warp's coordinates are one
// contiguous block of each of wr, ur and acc_r (16-byte aligned: 3 E values
// a group), staged through the warp's own shared memory (omc::triples_in),
// each lane's loads issued before any store, no barrier but the warp's.  X,
// W, the mask, wp and up are 16-byte words a lane.
template <class T>
__device__ __forceinline__ void k8b_coords(const K8bParamsT<T>& p, int quad0) {
  using V = omc::Vec16<T>;
  constexpr int E = 16 / sizeof(T);
  __shared__ V k8b_smem[3 * 3 * 32 * (kThreads8b / 32)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* __restrict__ X = p.Xs;
  const T* __restrict__ W = p.Ws;
  const T* __restrict__ M = p.soc_mask;
  T* __restrict__ wp = p.wp;
  T* __restrict__ up = p.up;
  const int nm = p.n * p.m, tot = p.B * nm;
  const int c0 = E * (quad0 + 32 * warp);  // the warp's first coordinate
  if (32 * warp >= p.qpc || c0 >= tot) return;
  const int cnt = min(32 * E, tot - c0);
  const size_t off = 3 * (size_t)c0;
  V* s = k8b_smem + 3 * 3 * 32 * warp;
  const int q0 = c0 + E * lane;
  const int rem = q0 < tot ? min(E, tot - q0) : 0;
  // the group's slots: b0, and b0 + 1 from coordinate bnd on (n m >= 4)
  const int b0 = rem > 0 ? q0 / nm : 0, b1 = min(b0 + 1, p.B - 1), bnd = (b0 + 1) * nm;
  const T sS0 = __ldg(p.sS + b0), rho0 = __ldg(p.rho + b0);
  const T sS1 = __ldg(p.sS + b1), rho1 = __ldg(p.rho + b1);
  V x4 = {}, w4 = {}, m4 = {}, p4 = {}, u4 = {};
  if (rem == E) {
    x4 = __ldg(reinterpret_cast<const V*>(X + q0));
    w4 = __ldg(reinterpret_cast<const V*>(W + q0));
    m4 = __ldg(reinterpret_cast<const V*>(M + q0));
    p4 = *reinterpret_cast<const V*>(wp + q0);
    u4 = *reinterpret_cast<const V*>(up + q0);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < rem) {
        lane4(x4, e) = X[q0 + e], lane4(w4, e) = W[q0 + e], lane4(m4, e) = M[q0 + e];
        lane4(p4, e) = wp[q0 + e], lane4(u4, e) = up[q0 + e];
      }
  }
  omc::triples_in(p.wr, p.ur, p.acc_r, off, 3 * cnt, s, lane);
  __syncwarp();
  if (rem > 0) {
    // the RSOC row and the W >= 0 slot of each coordinate
    omc::triples_update(s, lane, rem, [&](int e, T (&r)[3], T (&u)[3], T (&a)[3]) {
      const bool hi = q0 + e >= bnd;
      const T sS = hi ? sS1 : sS0;
      omc::rsoc_row(lane4(x4, e), lane4(w4, e), lane4(m4, e), sS, hi ? rho1 : rho0, p.alpha,
                    p.beta, r, u, a);
      omc::nonneg_slot(lane4(w4, e), sS, p.alpha, lane4(p4, e), lane4(u4, e));
    });
    if (rem == E) {
      *reinterpret_cast<V*>(wp + q0) = p4;
      *reinterpret_cast<V*>(up + q0) = u4;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < rem) wp[q0 + e] = lane4(p4, e), up[q0 + e] = lane4(u4, e);
    }
  }
  __syncwarp();
  omc::triples_out(p.wr, p.ur, p.acc_r, off, 3 * cnt, s, lane);
}

template <class T>
__global__ void __launch_bounds__(kThreads8b) k8b_kernel(K8bParamsT<T> p) {
  const int x = blockIdx.x;
  const int tiles = omc::cdiv(p.m, omc::kLinkCols);
  if (x < p.B * tiles) {
    omc::link_rows(p, x / tiles, x % tiles);
  } else {
    k8b_coords(p, (x - p.B * tiles) * p.qpc);
  }
}

// a failed runtime call also sets the thread's last error: clear it, so a
// later launch's cudaGetLastError() does not report it again
int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

}  // namespace

// K8a's shared memory (values of elem bytes) and its grid's width a slot
// (omc_torch.sdp.admm_shor.k8a_plan plans with them; chip_smoke.py holds the
// plan against them)
OMC_EXPORT long long omc_k8a_smem_bytes(int n, int m, int C, int Q, int elem) {
  return k8a_smem(n, m, C, Q, elem);
}

OMC_EXPORT int omc_k8a_grid_x(int m, int P, int C, int Q) { return k8a_layout(m, P, C, Q).grid_x; }

namespace {

template <class T>
int k8a_launch(const K8aParamsT<T>& p, void* stream) {
  if (p.C < 1 || p.C > kClusterMax || p.C > p.n || p.Q < 1 || p.Q > p.m || p.B < 1 || p.n < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = k8a_smem(p.n, p.m, p.C, p.Q, (int)sizeof(T));
  static int smem_attr = 48 * 1024;
  cudaError_t err;
  if (smem > smem_attr) {
    err = cudaFuncSetAttribute(k8a_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return fail(err);
    smem_attr = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k8a_layout(p.m, p.P1 + p.P2 + p.P3, p.C, p.Q).grid_x, p.B, 1);
  cfg.blockDim = dim3(omc::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k8a_kernel<T>, p);
  if (err != cudaSuccess) return fail(err);
  return (int)cudaGetLastError();
}

template <class T>
int k8b_launch(const K8bParamsT<T>& p, void* stream) {
  if (p.B < 1 || p.n < 1 || p.m < 1 || p.n * p.m < 4 || p.qpc < 32 || p.qpc > kThreads8b ||
      p.qpc % 32)
    return (int)cudaErrorInvalidValue;
  const int grid = k8b_layout(p.B, p.n, p.m, p.qpc, 16 / (int)sizeof(T)).grid_x;
  k8b_kernel<T><<<grid, kThreads8b, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

OMC_EXPORT int omc_k8a_shor_zstep(const K8aParams* params, void* stream) {
  return k8a_launch(*params, stream);
}

OMC_EXPORT int omc_k8a_shor_zstep_f64(const K8aParamsT<double>* params, void* stream) {
  return k8a_launch(*params, stream);
}

// K8b's grid width at elem bytes a value (omc_torch.sdp.admm_shor.k8b_plan
// plans with it; chip_smoke.py holds the plan against it)
OMC_EXPORT int omc_k8b_grid_x(int B, int n, int m, int qpc, int elem) {
  return k8b_layout(B, n, m, qpc, 16 / elem).grid_x;
}

OMC_EXPORT int omc_k8b_shor_cone(const K8bParams* params, void* stream) {
  return k8b_launch(*params, stream);
}

OMC_EXPORT int omc_k8b_shor_cone_f64(const K8bParamsT<double>* params, void* stream) {
  return k8b_launch(*params, stream);
}
