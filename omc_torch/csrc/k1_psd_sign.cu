// K1 — sign-schedule PSD projection of the three ADMM PSD blocks.
//
// Replaces omc/ops/polar.py: matrix_sign_poly / project_psd_ns /
// project_psd_ns_merged (the merged call of omc/sdp/admm.py:393-408):
//   P = (T + sign(T) T) / 2,  sign(T) from 12 quintic + 2 cubic odd-
//   polynomial steps on T / ||T||_F  (43 matmuls in series),
// followed by the ADMM epilogue w = sym(P), u = t - w and the dual EMA
// acc += beta (rho u - acc) of the first two blocks (omc admm.py:513-516).
//
// What bounds it on the H100: the 43 dependent d x d products of each
// matrix.  At the headline's B = 1 (d = 100, 51, 50) the whole projection
// is ~0.1 GFLOP, so the time is the latency of the chain; at B = 16,
// d = 500 it is ~170 GFLOP, so the time is the products' arithmetic.  One
// CTA per matrix (the first design) made both worse: a d = 100 chain ran
// on one SM, and beyond shared memory every product went through a global
// workspace on one SM per matrix.  The design spreads each chain over many
// SMs instead:
//
// * Symmetry.  Every matrix of the chain (S, S^2, S^4, b S^2 + c S^4, T) is
//   a polynomial in T, so all are symmetric and commute.  A product is
//   computed as C = A B^T on 16-row strips, C[p, q] = A[p, :] B[q, :]^T,
//   for strip pairs p <= q only, and each block is written to C[p, q] and,
//   transposed, to C[q, p]: half the arithmetic, every operand read as
//   whole rows, and every product exactly symmetric (a product that is
//   not kept symmetric this way lets the rounding's skew part grow by the
//   steps' slope ~4 per step; tests/test_torch_k1_plan.py shows it).
// * Cluster path (the four working matrices fit in the shared memory of a
//   thread-block cluster of C <= 8 CTAs: d <= ~280).  One cluster per
//   matrix; CTA r holds strips [r S, (r + 1) S) of T, S, X1, X2.  Warps read
//   the operands of their strip pairs straight from the owners' shared
//   memory (ld.shared::cluster), write both halves of each block there, and
//   one cluster barrier per product orders the chain.  No buffer is both
//   read and written in one product, so one barrier suffices; the barrier
//   after the last product also keeps every CTA alive until its peers are
//   done with its memory.  ||T||_F is summed over the cluster in rank
//   order, so every CTA scales by the same s.  Remote reads are slow under
//   load, so clusters of more than 2 CTAs serve small batches only, where
//   the chain's latency is the time (omc_torch.ops.polar.k1_plan).
// * Tiles path (larger batches, and d beyond a cluster: 500 for 250 x 250
//   instances, 2000 for config 5).  The matrices live in a global
//   workspace; each product is one launch whose CTAs each take one 64 x 64
//   strip-pair tile of one matrix, so all matrices' tiles spread over all
//   SMs; the tile's rows stream through a 3-stage cp.async pipeline.
// * Inner product: 3xTF32 on the tensor cores (mma.sync m16n8k8): each
//   operand splits into big = tf32_rna(x) and small = tf32_rna(x - big),
//   and big*big + big*small + small*big is summed in fp32; big*big is
//   added to a float32 total every 16 columns, so the tensor cores never
//   add to a large partial sum (the chain then sits as close to the exact
//   projection as the float32 one, or closer; the CPU mirror
//   omc_torch.ops.polar.tf32x3_matmul shows the arithmetic).
// No atomics: repeated launches give the same bits.  A cluster that cannot
// be scheduled is an error, never a fallback.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStrip = 16;  // rows of a strip: one m16 MMA tile
constexpr int kTile = 64;   // the tiles path's CTA tile: 4 x 4 strips
constexpr int kWarps = omc::kThreads / 32;
constexpr int kRed = 32;    // reduction scratch (floats) ahead of the buffers

__host__ __device__ inline int round_up(int x, int r) { return (x + r - 1) / r * r; }

// row stride of a (Dp x Dp) working matrix, Dp a multiple of 16: 16 more
// than a multiple of 32 floats, so the float4 fragment loads of a quarter
// warp (two rows, four float4 each) hit 32 distinct banks
__host__ __device__ inline int row_stride(int Dp) { return Dp % 32 == 16 ? Dp : Dp + 16; }

// cluster path: strips per CTA and floats of one working matrix per CTA
__host__ __device__ inline int strips_per_cta(int D, int C) {
  return (round_up(D, kStrip) / kStrip + C - 1) / C;
}
__host__ __device__ inline int cluster_msz(int D, int C) {
  return strips_per_cta(D, C) * kStrip * row_stride(round_up(D, kStrip));
}
// cluster path: bytes of shared memory per CTA for a block of size D
inline size_t cluster_smem(int D, int C) {
  return (kRed + 4 * (size_t)cluster_msz(D, C)) * sizeof(float);
}

// x rounded to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32): the
// sign is a separate bit, so adding half a TF32 ulp to the bits and cutting
// the 13 low ones rounds the magnitude; two integer operations at full rate
// (the conversion instruction runs at a fraction of it)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x split for 3xTF32: big = tf32(x), small = tf32(x - big)
struct Split {
  uint32_t h, l;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t h = tf32(x);
  return {h, tf32(x - __uint_as_float(h))};
}

// Accessors of the working matrices.  On the tiles path a strip is a
// pointer into the global workspace; on the cluster path it is a 32-bit
// shared::cluster address (mapa of the owner's shared memory), read and
// written with ld/st.shared::cluster.  The asm is volatile with a memory
// clobber, so no access moves across the cluster barriers.
__device__ __forceinline__ float4 ld4(const float* p, int off) {
  return *reinterpret_cast<const float4*>(p + off);
}
__device__ __forceinline__ float ld1(const float* p, int off) { return p[off]; }
__device__ __forceinline__ void st1(float* p, int off, float v) { p[off] = v; }
__device__ __forceinline__ float4 ld4(uint32_t a, int off) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a + 4 * off)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld1(uint32_t a, int off) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a + 4 * off) : "memory");
  return v;
}
__device__ __forceinline__ void st1(uint32_t a, int off, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a + 4 * off), "f"(v) : "memory");
}

// One 16-column chunk of an (NA x NB) grid of 16 x 16 blocks of one warp,
// in 3xTF32.  v holds the lane's float4 of each row: v[i], i < 2 NA, row
// 8 i + g of the warp's A strips, then v[2 NA + n], n < 2 NB, row 8 n + g
// of its B strips, each at columns [4 t, 4 t + 4) of the chunk (g = lane /
// 4, t = lane % 4).  Columns 4 t, 4 t + 1 feed the chunk's first k8 step and
// 4 t + 2, 4 t + 3 its second: the same permutation of k for both operands
// leaves the sum unchanged, and every fragment comes from one float4 load.
// big*big goes to the chunk's own accumulator `big` (the caller adds it to
// its float32 total, so the tensor cores never add to a large partial sum);
// big*small + small*big, 2^-11 smaller, accumulate across chunks in
// small[s], by k8 step parity s when kP = 2.  Accumulator layout (m16n8):
// [a][n][i] is row 16 a + g + 8 (i >> 1), column 8 n + 2 t + (i & 1).
template <int NA, int NB, int kP>
__device__ __forceinline__ void x3_chunk(const float4 (&v)[2 * (NA + NB)],
                                         float (&big)[NA][2 * NB][4],
                                         float (&small)[kP][NA][2 * NB][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the chunk's k8 steps: (x, y), then (z, w)
    const int s = h % kP;
    Split b[2 * NB][2];
#pragma unroll
    for (int n = 0; n < 2 * NB; ++n) {
      const float4 r = v[2 * NA + n];
      b[n][0] = split(h ? r.z : r.x);
      b[n][1] = split(h ? r.w : r.y);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float4 r0 = v[2 * a], r1 = v[2 * a + 1];
      const Split av[4] = {split(h ? r0.z : r0.x), split(h ? r1.z : r1.x),
                           split(h ? r0.w : r0.y), split(h ? r1.w : r1.y)};
      const uint32_t ah[4] = {av[0].h, av[1].h, av[2].h, av[3].h};
      const uint32_t al[4] = {av[0].l, av[1].l, av[2].l, av[3].l};
#pragma unroll
      for (int n = 0; n < 2 * NB; ++n) {
        mma_tf32(small[s][a][n], al, b[n][0].h, b[n][1].h);
        mma_tf32(small[s][a][n], ah, b[n][0].l, b[n][1].l);
        mma_tf32(big[a][n], ah, b[n][0].h, b[n][1].h);
      }
    }
  }
}

// acc = total + the small terms, summed in float32
template <int NA, int NN, int kP>
__device__ __forceinline__ void x3_finish(const float (&total)[NA][NN][4],
                                          const float (&small)[kP][NA][NN][4],
                                          float (&acc)[NA][NN][4]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ss = small[0][a][n][i];
#pragma unroll
        for (int q = 1; q < kP; ++q) ss += small[q][a][n][i];
        acc[a][n][i] = total[a][n][i] + ss;
      }
}

template <int NA, int NN>
__device__ __forceinline__ void add_to(float (&total)[NA][NN][4], const float (&part)[NA][NN][4]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[a][n][i] += part[a][n][i];
}

// acc = A B^T for one 16 x 16 block of one warp straight from the strips
// (cluster path): A and Bm are the first rows of two strips (row stride ld,
// a multiple of 4), K a multiple of 16 (the padding columns are zero).  Two
// chunks are loaded ahead of the one that multiplies, and the small terms
// keep one accumulator per k8 step parity, so the chain of dependent MMAs is
// short: at small batches this block's latency is the product's.
template <class Addr>
__device__ __forceinline__ void strip_block(Addr A, Addr Bm, int ld, int K,
                                            float (&acc)[1][2][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int o0 = gq * ld + 4 * tq, o1 = o0 + 8 * ld;  // rows g and g + 8
  auto load = [&](int c, float4 (&v)[4]) {
    v[0] = ld4(A, o0 + 16 * c);
    v[1] = ld4(A, o1 + 16 * c);
    v[2] = ld4(Bm, o0 + 16 * c);
    v[3] = ld4(Bm, o1 + 16 * c);
  };
  float total[1][2][4] = {}, small[2][1][2][4] = {};
  const int nc = K / 16;
  float4 cur[4], nxt[4] = {};
  load(0, cur);
  if (nc > 1) load(1, nxt);
  for (int c = 0; c < nc; ++c) {
    float4 ahead[4] = {};
    if (c + 2 < nc) load(c + 2, ahead);
    float big[1][2][4] = {};
    x3_chunk<1, 1, 2>(cur, big, small);
    add_to(total, big);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cur[i] = nxt[i];
      nxt[i] = ahead[i];
    }
  }
  x3_finish(total, small, acc);
}

// C[p, q] = ca acc + ce E[p, q] and its mirror C[q, p]; on the diagonal
// (p == q) only the upper triangle is taken, so C is exactly symmetric.
// rows(buf, strip) is the first row of a strip of working matrix buf; E
// (buffer ei, or none for ei < 0) is exactly symmetric itself.
template <class Rows>
__device__ __forceinline__ void store_block(const Rows& rows, int ci, int ei, int p, int q,
                                            float ca, float ce, int ld,
                                            const float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const auto Cp = rows(ci, p), Cq = rows(ci, q);
  const auto Ep = rows(ei >= 0 ? ei : 0, p);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gq + 8 * (i >> 1), c = 8 * n + 2 * tq + (i & 1);
      if (p == q && r > c) continue;
      float v = ca * acc[n][i];
      if (ei >= 0) v += ce * ld1(Ep, r * ld + q * kStrip + c);
      st1(Cp, r * ld + q * kStrip + c, v);
      st1(Cq, c * ld + p * kStrip + r, v);
    }
}

// strips of the working matrices in the cluster's shared memory: strip s
// lives in CTA s / S at local strip s % S; base is the shared::cta address
// of this CTA's first buffer (the same offset in every CTA)
struct ClusterRows {
  uint32_t base;
  int msz, ld, S;
  __device__ uint32_t operator()(int buf, int strip) const {
    const int owner = strip / S;
    const uint32_t local = base + 4u * (buf * msz + (strip - owner * S) * kStrip * ld);
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(owner));
    return remote;
  }
};

// strips of the working matrices in the global workspace
struct GlobalRows {
  float* base;
  size_t msz;
  int ld;
  __device__ float* operator()(int buf, int strip) const {
    return base + buf * msz + (size_t)strip * kStrip * ld;
  }
};

// the sign schedule for the host code that drives the tiles path's launches
const float kSchedHost[omc::kSignSteps][3] = OMC_SIGN_SCHED;

// the 43 products of the schedule `sched` and the final (T + S T) / 2 over
// working buffers 0 = T, 1.. = S, X1, X2 (rotated identically everywhere);
// mm(ia, ib, ic, ie, ca, ce) is C = ca A B^T + ce E.  Returns P's buffer.
#pragma nv_exec_check_disable
template <class MM>
__host__ __device__ __forceinline__ int sign_chain(const float (*sched)[3], MM&& mm) {
  int iS = 1, iX1 = 2, iX2 = 3;
  for (int step = 0; step < omc::kSignSteps; ++step) {
    const float a = sched[step][0], bq = sched[step][1], c = sched[step][2];
    mm(iS, iS, iX1, -1, 1.f, 0.f);          // X1 = S^2
    if (c != 0.f) {
      mm(iX1, iX1, iX2, iX1, c, bq);        // X2 = c S^4 + b S^2
      mm(iS, iX2, iX1, iS, 1.f, a);         // X1 = a S + S X2
      const int t = iS; iS = iX1; iX1 = t;
    } else {
      mm(iS, iX1, iX2, iS, bq, a);          // X2 = a S + b S S^2
      const int t = iS; iS = iX2; iX2 = t;
    }
  }
  mm(iS, 0, iX1, 0, 0.5f, 0.5f);            // X1 = (S T + T) / 2
  return iX1;
}

// the (strip p, strip q) pair of index w in the row-major list of p <= q
__device__ __forceinline__ void pair_of(int w, int nt, int& p, int& q) {
  p = 0;
  while (w >= nt - p) {
    w -= nt - p;
    ++p;
  }
  q = p + w;
}

// epilogue of one row i of P (exactly symmetric, so w = sym(P) = P):
// w = P, u = t - w, acc += beta (rho u - acc)
__device__ __forceinline__ void epilogue_row(const K1Params& p, int g, int b, int i,
                                             const float* Prow, int j0, int dj) {
  const int D = p.D[g];
  const size_t off = (size_t)b * D * D + (size_t)i * D;
  const float* trow = p.t[g] + off;
  float* wout = p.w[g] + off;
  float* uout = p.u[g] ? p.u[g] + off : nullptr;
  float* aout = p.acc[g] ? p.acc[g] + off : nullptr;
  const float rho = aout ? p.rho[b] : 0.f;
  for (int j = j0; j < D; j += dj) {
    const float w = Prow[j];
    wout[j] = w;
    if (uout) {
      const float u = trow[j] - w;
      uout[j] = u;
      if (aout) aout[j] = aout[j] + p.beta * (rho * u - aout[j]);
    }
  }
}

// ---- cluster path: grid (C B, G), cluster (C, 1, 1), one cluster per matrix
__global__ void __launch_bounds__(omc::kThreads) k1_cluster_kernel(K1Params p) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C, g = blockIdx.y;
  const int D = p.D[g], Dp = round_up(D, kStrip), ld = row_stride(Dp), nt = Dp / kStrip;
  const int S = strips_per_cta(D, C), msz = cluster_msz(D, C);
  float* red = smem;
  float* base = smem + kRed;
  const ClusterRows rows{(uint32_t)__cvta_generic_to_shared(base), msz, ld, S};
  const float* tin = p.t[g] + (size_t)b * D * D;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = rank * S * kStrip;                       // first row held here
  const int nr = max(0, min(S * kStrip, Dp - r0));        // rows held here

  // T = sym(t) zero-padded, its share of ||T||_F^2, then S = T / ||T||_F
  float ss = 0.f;
  for (int e = tid; e < nr * Dp; e += blockDim.x) {
    const int i = e / Dp, j = e % Dp, gi = r0 + i;
    float v = 0.f;
    if (gi < D && j < D) v = 0.5f * (tin[gi * D + j] + tin[j * D + gi]);
    base[i * ld + j] = v;
    ss += v * v;
  }
  const float part = omc::block_sum(ss, red);
  if (tid == 0) red[kWarps] = part;
  cluster.sync();
  float tot = 0.f;
  for (int r = 0; r < C; ++r) tot += *cluster.map_shared_rank(red + kWarps, r);
  const float s = sqrtf(tot) + 1e-30f;
  for (int e = tid; e < nr * Dp; e += blockDim.x) {
    const int i = e / Dp, j = e % Dp;
    base[msz + i * ld + j] = base[i * ld + j] / s;
  }
  cluster.sync();

  const int npairs = nt * (nt + 1) / 2;
  const int iP = sign_chain(omc::kSignSched, [&](int ia, int ib, int ic, int ie, float ca,
                                                  float ce) {
    for (int w = rank * kWarps + warp; w < npairs; w += C * kWarps) {
      int pp, qq;
      pair_of(w, nt, pp, qq);
      float acc[1][2][4];
      strip_block(rows(ia, pp), rows(ib, qq), ld, Dp, acc);
      store_block(rows, ic, ie, pp, qq, ca, ce, ld, acc[0]);
    }
    cluster.sync();
  });

  // the rows of P held here; the last barrier saw every peer's writes
  const int nrows = max(0, min(S * kStrip, D - r0));
  for (int i = warp; i < nrows; i += kWarps)
    epilogue_row(p, g, b, r0 + i, base + iP * msz + i * ld, tid & 31, 32);
}

// ---- tiles path: workspace per block g = (B, 4, Dp, ld) then B x nrb
// partial sums of ||T||_F^2, Dp = d rounded up to 16, ld = row_stride(Dp),
// nrb = the 64-row blocks of Dp
struct TileGeom {
  int D, Dp, ld, nt, nrb;
  size_t msz;
  __host__ __device__ explicit TileGeom(int D_)
      : D(D_), Dp(round_up(D, kStrip)), ld(row_stride(Dp)), nt(Dp / kStrip),
        nrb((Dp + kTile - 1) / kTile), msz((size_t)Dp * ld) {}
  __device__ TileGeom(const K1Params& p, int g) : TileGeom(p.D[g]) {}
  // floats of the workspace of B matrices: four working matrices each, then
  // the partial sums of ||T||_F^2 of their row blocks
  size_t scratch_floats(int B) const { return (size_t)B * (4 * msz + nrb); }
  __device__ float* mats(const K1Params& p, int g, int b) const {
    return p.scratch[g] + (size_t)b * 4 * msz;
  }
  __device__ float* parts(const K1Params& p, int g, int b) const {
    return p.scratch[g] + (size_t)p.B * 4 * msz + (size_t)b * nrb;
  }
  // rows of row block x (the last may be short)
  __device__ int rows(int x) const { return min(kTile, Dp - x * kTile); }
};

// grid (row blocks, B, G): T = sym(t) for 64 rows and their sum of squares
__global__ void __launch_bounds__(omc::kThreads) k1_tiles_init(K1Params p) {
  __shared__ float red[kRed];
  const int x = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const TileGeom tg(p, g);
  if (x >= tg.nrb) return;
  const int D = tg.D;
  float* T = tg.mats(p, g, b);
  const float* tin = p.t[g] + (size_t)b * D * D;
  float ss = 0.f;
  for (int e = threadIdx.x; e < tg.rows(x) * tg.Dp; e += blockDim.x) {
    const int i = x * kTile + e / tg.Dp, j = e % tg.Dp;
    float v = 0.f;
    if (i < D && j < D) v = 0.5f * (tin[(size_t)i * D + j] + tin[(size_t)j * D + i]);
    T[(size_t)i * tg.ld + j] = v;
    ss += v * v;
  }
  const float part = omc::block_sum(ss, red);
  if (threadIdx.x == 0) tg.parts(p, g, b)[x] = part;
}

// grid (row blocks, B, G): S = T / ||T||_F (partials summed in order)
__global__ void __launch_bounds__(omc::kThreads) k1_tiles_scale(K1Params p) {
  const int x = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const TileGeom tg(p, g);
  if (x >= tg.nrb) return;
  const float* part = tg.parts(p, g, b);
  float tot = 0.f;
  for (int r = 0; r < tg.nrb; ++r) tot += part[r];
  const float s = sqrtf(tot) + 1e-30f;
  float* T = tg.mats(p, g, b);
  for (int e = threadIdx.x; e < tg.rows(x) * tg.Dp; e += blockDim.x) {
    const size_t idx = (size_t)(x * kTile + e / tg.Dp) * tg.ld + e % tg.Dp;
    T[tg.msz + idx] = T[idx] / s;
  }
}

// the tiles path's k pipeline: stages of 32 columns of the A and B tiles in
// shared memory (row stride 48 floats: 16 mod 32, so the float4 fragment
// loads of a quarter warp hit distinct banks), filled by cp.async
constexpr int kKc = 32;
constexpr int kSld = kKc + 16;
constexpr int kStages = 3;
constexpr int kStageFloats = 2 * kTile * kSld;
constexpr int kTilesSmem = kStages * kStageFloats * (int)sizeof(float);  // 73,728 B

// 16 bytes global -> shared, zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// grid (tile pairs, B, G), 4 warps: one 64 x 64 tile pair (P <= Q) of one
// product, C[P, Q] = ca A[P rows] B[Q rows]^T + ce E[P, Q] and its mirror.
// The rows of A and B stream through a 3-stage cp.async pipeline of
// 32-column stages; warp w takes the 2 x 2 blocks of 16 x 16 at block rows
// 2 (w / 2) + a and block columns 2 (w % 2) + j of the tile, so each A and B
// fragment feeds two blocks.  On a diagonal tile only blocks with p <= q
// are stored; rows past the matrix load as zeros.
constexpr int kTilesThreads = 128;

__global__ void __launch_bounds__(kTilesThreads)
    k1_tiles_mm(K1Params p, int ia, int ib, int ic, int ie, float ca, float ce) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y, g = blockIdx.z;
  const TileGeom tg(p, g);
  const int nT = tg.nrb;
  if ((int)blockIdx.x >= nT * (nT + 1) / 2) return;
  int P, Q;
  pair_of(blockIdx.x, nT, P, Q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int p0 = 4 * P + 2 * (warp >> 1), q0 = 4 * Q + 2 * (warp & 1);  // first strips
  auto ok = [&](int a, int j) { return q0 + j < tg.nt && p0 + a <= q0 + j; };
  const bool active = ok(0, 0) || ok(0, 1);  // (1, j) needs (0, j)
  const GlobalRows rows{tg.mats(p, g, b), tg.msz, tg.ld};
  const float* Ag = rows(ia, 4 * P);
  const float* Bg = rows(ib, 4 * Q);
  const int rowsA = min(kTile, tg.Dp - kTile * P), rowsB = min(kTile, tg.Dp - kTile * Q);
  const int nk = (tg.Dp + kKc - 1) / kKc;
  auto issue = [&](int kc) {
    float* st = sm + (kc % kStages) * kStageFloats;
    const int k0 = kc * kKc;
    for (int e = threadIdx.x; e < 2 * kTile * (kKc / 4); e += blockDim.x) {
      const int m = e / (kTile * (kKc / 4));  // 0: the A tile, 1: the B tile
      const int r = (e / (kKc / 4)) % kTile, col = k0 + 4 * (e % (kKc / 4));
      const bool valid = r < (m ? rowsB : rowsA) && col < tg.Dp;
      const float* src = (m ? Bg : Ag) + (valid ? (size_t)r * tg.ld + col : 0);
      cp_async16(st + (m * kTile + r) * kSld + col - k0, src, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  // the lane's rows g of the warp's first A and B strips in a stage
  const int oa = ((p0 - 4 * P) * kStrip + gq) * kSld + 4 * tq;
  const int ob = (kTile + (q0 - 4 * Q) * kStrip + gq) * kSld + 4 * tq;
  float total[2][4][4] = {}, small[1][2][4][4] = {};
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) issue(kc + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const float* st = sm + (kc % kStages) * kStageFloats;
    const int nsub = min(2, (tg.Dp - kc * kKc) / 16);
    float big[2][4][4] = {};
    for (int h = 0; h < nsub; ++h) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = ld4(st, oa + 8 * i * kSld + 16 * h);
        v[4 + i] = ld4(st, ob + 8 * i * kSld + 16 * h);
      }
      x3_chunk<2, 2, 1>(v, big, small);
    }
    add_to(total, big);
  }
  if (!active) return;
  float acc[2][4][4];
  x3_finish(total, small, acc);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (ok(a, j))
        store_block(rows, ic, ie, p0 + a, q0 + j, ca, ce, tg.ld,
                    *reinterpret_cast<const float(*)[2][4]>(&acc[a][2 * j][0]));
}

// grid (rows, B, G): the epilogue from the workspace's buffer iP
__global__ void __launch_bounds__(omc::kThreads) k1_tiles_epilogue(K1Params p, int iP) {
  const int i = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const TileGeom tg(p, g);
  if (i >= tg.D) return;
  epilogue_row(p, g, b, i, tg.mats(p, g, b) + iP * tg.msz + (size_t)i * tg.ld, threadIdx.x,
               blockDim.x);
}

// a failed runtime call also sets the thread's last error: clear it, so a
// later launch's cudaGetLastError() does not report it again
int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

int g_smem_attr = 0;        // the cluster kernel's max dynamic shared memory
int g_schedulable[9] = {};   // largest smem a cluster of C was shown to fit

int launch_cluster(const K1Params& p, cudaStream_t stream) {
  size_t smem = 0;
  for (int g = 0; g < p.G; ++g) smem = std::max(smem, cluster_smem(p.D[g], p.C));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.B, p.G, 1);
  cfg.blockDim = dim3(omc::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if ((int)smem > g_smem_attr) {
    err = cudaFuncSetAttribute(k1_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return fail(err);
    g_smem_attr = (int)smem;
  }
  if ((int)smem > g_schedulable[p.C]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)k1_cluster_kernel, &cfg);
    if (err != cudaSuccess) return fail(err);
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    g_schedulable[p.C] = (int)smem;
  }
  err = cudaLaunchKernelEx(&cfg, k1_cluster_kernel, p);
  if (err != cudaSuccess) return fail(err);
  return (int)cudaGetLastError();
}

int launch_tiles(const K1Params& p, cudaStream_t stream) {
  int nrb = 0, dmax = 0;
  for (int g = 0; g < p.G; ++g) {
    if (!p.scratch[g] || p.scratch_floats[g] < (long long)TileGeom(p.D[g]).scratch_floats(p.B))
      return (int)cudaErrorInvalidValue;
    nrb = std::max(nrb, (round_up(p.D[g], kStrip) + kTile - 1) / kTile);
    dmax = std::max(dmax, p.D[g]);
  }
  const dim3 blocks(nrb, p.B, p.G), pairs(nrb * (nrb + 1) / 2, p.B, p.G);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_tiles_mm, cudaFuncAttributeMaxDynamicSharedMemorySize, kTilesSmem);
    if (err != cudaSuccess) return fail(err);
    smem_set = true;
  }
  k1_tiles_init<<<blocks, omc::kThreads, 0, stream>>>(p);
  k1_tiles_scale<<<blocks, omc::kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int iP = sign_chain(kSchedHost, [&](int ia, int ib, int ic, int ie, float ca, float ce) {
    k1_tiles_mm<<<pairs, kTilesThreads, kTilesSmem, stream>>>(p, ia, ib, ic, ie, ca, ce);
  });
  k1_tiles_epilogue<<<dim3(dmax, p.B, p.G), omc::kThreads, 0, stream>>>(p, iP);
  return (int)cudaGetLastError();
}

}  // namespace

// The geometry that omc_torch.ops.polar.k1_plan plans with (chip_smoke.py
// holds the plan against these at every K1 shape).
OMC_EXPORT long long omc_k1_scratch_floats(int D, int B) {
  return (long long)TileGeom(D).scratch_floats(B);
}
OMC_EXPORT long long omc_k1_cluster_smem(int D, int C) { return (long long)cluster_smem(D, C); }

// 1 <= C <= 8 (the portable cluster sizes): the cluster path with clusters
// of C CTAs; C == 0: the tiles path (p.scratch sized by k1_plan; a smaller
// workspace than omc_k1_scratch_floats is refused)
OMC_EXPORT int omc_k1_psd_sign(const K1Params* params, void* stream) {
  const K1Params& p = *params;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.C < 0 || p.C > 8 || p.G < 1 || p.G > 3) return (int)cudaErrorInvalidValue;
  return p.C > 0 ? launch_cluster(p, st) : launch_tiles(p, st);
}

OMC_EXPORT const char* omc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
