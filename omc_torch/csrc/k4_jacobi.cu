// K4 — batched symmetric eigensolver of the safe dual bounds; K5 — the
// separation eigenpairs of U U' - Y.
//
// Replaces the eigendecompositions of omc's on-device safe bounds
// (omc/sdp/relax.py:356-487 safe_dual_bound2: the PSD projections of the
// masked S1 and of -y2, lambda_max of R1, the spectra of G_Y and G_Theta;
// omc/sdp/admm_shor.py:786-807 and omc/sdp/shor_k.py:947-1165, the same
// for the Shor bounds) and the separation eigh of omc/sdp/admm.py:576-578,
// admm_shor.py:543-546, shor_k.py:891-894 and mccormick.py:538-540.  In the
// port these are omc_torch.ops.cones.eigvalsh / project_psd (d > 8)
// and omc_torch.sdp.relax.separation_eigpairs.
//
// Two paths here (omc_torch.ops.cones.k4_plan picks one per call; the CPU
// mirror of both is omc_torch/ops/jacobi.py), and in float64 a third,
// the tridiagonal path of csrc/k4_tridiag.cu (path 2), behind the same
// entry point:
//
// * The CTA path (k4_kernel): cyclic two-sided Jacobi in parallel
//   (round-robin) order, one CTA per matrix.  A sweep is N - 1 rounds over
//   N = d players (d + 1 for odd d: the extra one is a bye, never a zero
//   row, which would add an eigenvalue 0 to "the k smallest"); a round
//   computes its N / 2 disjoint rotations (one thread per pair), then
//   applies A <- J' A J as independent 2x2 blocks (one thread computes
//   block (a, b) and writes its transpose, so A stays exactly symmetric)
//   and V <- V J.  A and V live in shared memory, so the path takes d up
//   to 168 with vectors (237 without) and refuses larger matrices (held in
//   a global workspace instead, through one SM's path to L2, d = 500 took
//   ~190 us a round, ~956 ms a matrix on an H100).  What bounds it: the
//   chain of ~10 sweeps x (d - 1) rounds on one SM, two barriers a round.
//   It wins where the batch fills the SMs.
//
// * The block path (k4_block_kernel): two-sided block Jacobi, every
//   matrix spread over many SMs.  The indices split into nb = ceil(d / W)
//   blocks of width W = 16 (a ragged last block is masked: its
//   missing indices are zero rows that never rotate, so they add nothing
//   to the spectrum), and an outer sweep is the same round robin over the
//   blocks, with a bye block when nb is odd.  A round has two phases:
//   (1) every block pair (I, J) loads its 2W x 2W subproblem [[A_II,
//       A_IJ], [A_JI, A_JJ]] into shared memory, in float64, and a group
//       of 1 to 8 warps (as many as leave every pair of the call a group)
//       runs ONE sweep of the CTA path's scalar schedule on it (the same
//       rotation from the float32 values, Rutishauser update and stopping
//       test, with the whole matrix's floor; each rotation applied whole,
//       in float64); it accumulates E = Q - I in float32, not Q (a
//       rotation adds J - I to rows p and q, c - 1 taken as -s r), so late
//       sweeps' small angles keep their relative precision; the rotated
//       subproblem, rounded to float32, is the pair's new diagonal tile.
//       (Float32 subproblems with the pair's exact zero put the block path
//       farther from the float64 spectrum than the CTA path; these nearer.)
//       Block form of
//       the stopping rule: a pair is skipped (E = 0) when every entry of
//       its subproblem passes omc::jacobi_rotation's test |a_pq| <=
//       max(eps sqrt|a_pp| sqrt|a_qq|, floor), which is exactly when its
//       inner sweep would rotate nothing (||A_IJ||_F <= floor implies it
//       for A_IJ); the outer sweeps stop after the first that rotates no
//       pair, as on the CTA path.
//   (2) J is block diagonal for the round, so every other tile is updated
//       on its own: the tile T between pairs a < c becomes X + E_a' X with
//       X = T + T E_c, written with its mirror (A stays exactly
//       symmetric), and V's columns of pair a become V_a + V_a E_a, 2W rows
//       at a time.  The products are 3xTF32 mma.sync tensor-core products
//       (K1's split, big*big summed into float32 every 16 columns).
//   Epilogues on the same tiles: the projection V max(w, 0) V' as 32 x 32
//   upper tiles of 3xTF32 products, mirrored; the eigenvalues and the nout
//   smallest eigenpairs by the rank sort (O(d^2), one thread an index).
//   Work items (pairs, tiles) of all matrices share one persistent
//   cooperative grid sized to the card's co-resident CTAs, with a grid
//   barrier between phases: 1 + 2 (nb' - 1) per outer sweep, nb' = nb
//   rounded up to even.  What bounds it: at small batches the chain of
//   ~12 x (nb' - 1) rounds, each a group's inner sweep of 2W - 1 scalar
//   steps (about 1 us each on an H100) plus two grid barriers (at most
//   ~5 us each with an empty phase); at
//   large batches also the bytes of A and V that each round reads and
//   writes (2 d^2 floats each way with vectors).
//   Why block Jacobi rather than a tridiagonalisation: it keeps the CTA
//   path's schedule, stopping rule, accuracy and CPU mirror, and its
//   update is dense tile products that spread over all SMs, where the
//   Householder reduction is a chain of d matrix-vector products.
//
// K1's accessors and MMA helpers are restated here, not shared: each
// source is its own translation unit.  The grid barrier is a counter and
// a generation word in the workspace (zeroed by the launcher), valid
// because the cooperative launch makes every CTA co-resident; a grid the
// card cannot co-schedule, or any refused launch, is an error.  Data that
// other CTAs wrote is read through L2 (cp.async.cg, __ldcg).
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

// the tridiagonal path (path 2, float64 only), in csrc/k4_tridiag.cu
int k4t_entry(const K4ParamsT<double>& p, void* stream);
long long k4t_workspace_doubles(int B, int d, int mode);

namespace {

constexpr size_t kSmemBytes = 232448;  // the most one block may use on sm_90

__host__ __device__ inline int ld_of(int d) { return d | 1; }  // odd: fewer bank conflicts

// shared floats ahead of A: per pair t, s, r (float) and p, q, rotated
// (int); 32 reduction floats; per index the diagonal, the clamped sorted
// eigenvalue and the sort order; 1 int (first positive rank)
__host__ __device__ inline size_t head_floats(int d) {
  const int P = (d + 1) / 2;
  return 6 * (size_t)P + 32 + 3 * (size_t)d + 1;
}

// the shared memory of one CTA-path launch, or 0 when A (and V) do not fit
// (every slot of the head and of A and V is one element of T: 4 bytes, or
// 8 in the float64 build, which so takes d up to 118 with vectors and 167
// without)
template <class T>
__host__ inline size_t cta_smem_bytes(int d, int mode) {
  const size_t mat = (size_t)d * ld_of(d);
  const size_t bytes = (head_floats(d) + mat * (mode != 0 ? 2 : 1)) * sizeof(T);
  return bytes <= kSmemBytes ? bytes : 0;
}

// kSep: K5 (A = sym(U U' - Y)); a template argument so that a profile
// tells the two apart.  T: float, or double (the float64 build: the same
// schedule, rotation and stopping rule at double's epsilon)
template <bool kSep, class T>
__global__ void __launch_bounds__(512) k4_kernel(K4ParamsT<T> p) {
  extern __shared__ __align__(16) unsigned char k4_smem_raw[];
  T* const smem = reinterpret_cast<T*>(k4_smem_raw);
  const int b = blockIdx.x, d = p.d, ld = ld_of(d);
  const int P = (d + 1) / 2, N = 2 * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* pt = smem;
  T* ps = pt + P;
  T* pr = ps + P;
  // the ints take slots of T (the same offsets as floats in the float build)
  int* pp = reinterpret_cast<int*>(pr + P);
  int* pq = reinterpret_cast<int*>(pr + 2 * P);
  int* prot = reinterpret_cast<int*>(pr + 3 * P);
  T* red = pr + 4 * P;
  T* wd = red + 32;   // diagonal at the end
  T* wp = wd + d;     // sorted eigenvalues, clamped at 0 (mode 1)
  int* order = reinterpret_cast<int*>(wp + d);
  int* first = reinterpret_cast<int*>(wp + 2 * d);
  T* A = wp + 2 * d + 1;
  T* V = p.mode != 0 ? A + (size_t)d * ld : nullptr;

  // ---- load: A = sym(M), or sym(U U' - Y); V = I ----
  T ss = 0;
  if (!kSep) {
    const T* Mb = p.M + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      const T v = T(0.5) * (Mb[i * d + j] + Mb[j * d + i]);
      A[i * ld + j] = v;
      ss += v * v;
    }
  } else {
    const T* Ub = p.U + (size_t)b * d * p.k;
    const T* Yb = p.Y + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      T uu = 0;
      for (int l = 0; l < p.k; ++l) uu = fma(Ub[i * p.k + l], Ub[j * p.k + l], uu);
      const T v = uu - T(0.5) * (Yb[i * d + j] + Yb[j * d + i]);
      A[i * ld + j] = v;
      ss += v * v;
    }
  }
  if (V)
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      V[i * ld + j] = i == j ? T(1) : T(0);
    }
  const T normF = sqrt(omc::block_sum(ss, red));  // (contains barriers)
  const T floor_ = omc::jacobi_floor(normF, d);

  // ---- sweeps ----
  int sweep = 1;
  for (; sweep <= omc::kJacobiMaxSweeps; ++sweep) {
    int any = 0;
    for (int r = 0; r < N - 1; ++r) {
      int mine = 0;
      for (int a = tid; a < P; a += nt) {
        const int x = a == 0 ? N - 1 : (r + a) % (N - 1);
        const int y = a == 0 ? r : (r - a + N - 1) % (N - 1);
        const int pi = min(x, y);
        int qi = max(x, y);
        T t = 0, s = 0, rr = 0;
        int rot = 0;
        if (qi < d) {
          rot = omc::jacobi_rotation(A[pi * ld + pi], A[qi * ld + qi], A[pi * ld + qi],
                                     floor_, t, s, rr);
        } else {
          qi = -1;  // the bye
        }
        pt[a] = rot ? t : T(0);
        ps[a] = rot ? s : T(0);
        pr[a] = rot ? rr : T(0);
        pp[a] = pi;
        pq[a] = qi;
        prot[a] = rot;
        mine |= rot;
      }
      if (!__syncthreads_or(mine)) continue;  // no rotation this round
      any = 1;
      // A <- J' A J, one 2x2 block (a <= b) and its transpose per thread
      for (int e = tid; e < P * P; e += nt) {
        const int a = e / P, c = e - a * P;
        if (a > c || !(prot[a] | prot[c])) continue;
        const int pa = pp[a], qa = pq[a];
        if (a == c) {  // the rotated pair's own block: diagonal exactly
          const T t = pt[a], apq = A[pa * ld + qa];
          A[pa * ld + pa] -= t * apq;
          A[qa * ld + qa] += t * apq;
          A[pa * ld + qa] = 0;
          A[qa * ld + pa] = 0;
          continue;
        }
        const int pc = pp[c], qc = pq[c];
        T x00 = A[pa * ld + pc];
        T x01 = qc >= 0 ? A[pa * ld + qc] : T(0);
        T x10 = qa >= 0 ? A[qa * ld + pc] : T(0);
        T x11 = (qa >= 0 && qc >= 0) ? A[qa * ld + qc] : T(0);
        if (prot[a]) {  // rows p_a, q_a
          omc::jacobi_rot(x00, x10, ps[a], pr[a]);
          omc::jacobi_rot(x01, x11, ps[a], pr[a]);
        }
        if (prot[c]) {  // columns p_c, q_c
          omc::jacobi_rot(x00, x01, ps[c], pr[c]);
          omc::jacobi_rot(x10, x11, ps[c], pr[c]);
        }
        A[pa * ld + pc] = x00;
        A[pc * ld + pa] = x00;
        if (qc >= 0) {
          A[pa * ld + qc] = x01;
          A[qc * ld + pa] = x01;
        }
        if (qa >= 0) {
          A[qa * ld + pc] = x10;
          A[pc * ld + qa] = x10;
        }
        if (qa >= 0 && qc >= 0) {
          A[qa * ld + qc] = x11;
          A[qc * ld + qa] = x11;
        }
      }
      if (V)  // V <- V J
        for (int e = tid; e < d * P; e += nt) {
          const int i = e / P, a = e - i * P;
          if (!prot[a]) continue;
          omc::jacobi_rot(V[i * ld + pp[a]], V[i * ld + pq[a]], ps[a], pr[a]);
        }
      __syncthreads();
    }
    if (!any) break;  // every thread saw the same rounds
  }

  // ---- sort: rank of each diagonal entry, ascending, ties by index, NaN last ----
  for (int i = tid; i < d; i += nt) wd[i] = A[i * ld + i];
  __syncthreads();
  for (int i = tid; i < d; i += nt) {
    const T ki = isnan(wd[i]) ? omc::inf_of(T(0)) : wd[i];
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const T kj = isnan(wd[j]) ? omc::inf_of(T(0)) : wd[j];
      rank += (kj < ki) || (kj == ki && j < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  const bool bad = !isfinite(normF);  // a non-finite input gives NaN out
  const T qnan = omc::qnan_of(T(0));
  if (tid == 0) p.sweeps[b] = sweep;

  if (p.mode == 1) {
    // P = V max(w, 0) V' over the positive (and NaN) eigenvalues, which the
    // sort put last
    for (int r = tid; r < d; r += nt) {
      const T w = wd[order[r]];
      wp[r] = bad ? qnan : (w > T(0) ? w : (isnan(w) ? w : T(0)));
    }
    __syncthreads();
    if (tid == 0) {
      int f = d;
      while (f > 0 && wp[f - 1] != T(0)) --f;
      *first = f;
    }
    __syncthreads();
    const int f = *first;
    T* Pb = p.P + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      if (j < i) continue;
      T acc = 0;
      for (int r = f; r < d; ++r) {
        const int o = order[r];
        acc = fma(V[i * ld + o] * wp[r], V[j * ld + o], acc);
      }
      Pb[i * d + j] = acc;
      Pb[j * d + i] = acc;
    }
    return;
  }
  const int nout = p.nout;
  for (int r = tid; r < nout; r += nt) p.w[(size_t)b * nout + r] = bad ? qnan : wd[order[r]];
  if (p.mode == 2) {
    T* Vb = p.V + (size_t)b * d * nout;
    for (int e = tid; e < d * nout; e += nt) {
      const int i = e / nout, r = e - i * nout;
      Vb[e] = bad ? qnan : V[i * ld + order[r]];
    }
  }
}

template <bool kSep, class T>
int launch_k4(const K4ParamsT<T>& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      k4_kernel<kSep, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = p.d <= 32 ? 128 : (p.d <= 64 ? 256 : 512);
  k4_kernel<kSep, T><<<p.B, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}


// ======================= the block path =======================

// floats of global control ahead of the matrices: the barrier's counter and
// generation (the count of grid barriers passed), the count of matrices
// still rotating after each sweep (two, by sweep parity), the nanoseconds
// CTA 0 spent in phases 1 and 2, each up to the end of the barrier after
// it (two 64-bit words), and the launch's grid and group size
constexpr int kCtl = 16;
constexpr int kBarCount = 0, kBarGen = 1, kActive = 2, kPhaseNs = 4, kShape = 8;

// The block path's geometry of one call (host and device): nb blocks of W,
// Nb = nb rounded up to even (a bye block of zero rows when nb is odd), P =
// Nb / 2 pairs a round, R = Nb - 1 rounds an outer sweep, D = Nb W the
// padded order of the stored A and V.  Per matrix: A (D x D), V (D x D,
// modes 1 and 2), each pair's E (2W x 2W), each row's sum of squares, then
// ints: each pair's rotated flag, the sweep at which the matrix converged
// (0 while rotating), its rotated-this-sweep flags (by sweep parity), the
// bits of ||A||_F.
struct BGeom {
  int d, W, nb, Nb, P, R, D, N2;
  size_t v_off, e_off, ss_off, fl_off, mat_floats;
  __host__ __device__ BGeom(int d_, int W_, int mode) : d(d_), W(W_) {
    nb = (d + W - 1) / W;
    Nb = nb + (nb & 1);
    P = Nb / 2;
    R = Nb - 1;
    D = Nb * W;
    N2 = 2 * W;
    v_off = (size_t)D * D;
    e_off = v_off + (mode != 0 ? (size_t)D * D : 0);
    ss_off = e_off + (size_t)P * N2 * N2;
    fl_off = ss_off + D;
    mat_floats = fl_off + (size_t)((P + 4 + 3) / 4 * 4);
  }
  // work items of phase 2 per matrix: the A tiles between pairs a < c, then
  // (with vectors) V's P row tiles x P pairs
  __host__ __device__ int a_tiles() const { return P * (P - 1) / 2; }
  __host__ __device__ int tiles(int mode) const { return a_tiles() + (mode ? P * P : 0); }
};

// T: the element type of A, V, E and the tiles (float; double in the
// float64 build, whose tile products are FP64 FMAs)
template <int W, class T = float>
struct BCfg {
  static constexpr int N2 = 2 * W;
  static constexpr int L = N2 + 4;  // smem row stride: fragment loads hit 32 banks
  static constexpr int TILE = N2 * L;
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int VW = 16 / sizeof(T);  // elements of a 16-byte copy
  static constexpr size_t SMEM = (size_t)WARPS * 3 * TILE * sizeof(T);
  // phase 1 in a warp's three tiles: the subproblem in float64 (row stride
  // N2 + 1), E, and the round's rotations (s, r, p, q, rot)
  static_assert(8 * N2 * (N2 + 1) + sizeof(T) * (TILE + 5 * W) <= sizeof(T) * 3 * TILE,
                "phase 1 does not fit");
};

// 16 bytes of T: a float4 or a double2, unpacked and packed
__device__ __forceinline__ void unpack16(const float4& v, float* o) {
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void unpack16(const double2& v, double* o) { o[0] = v.x, o[1] = v.y; }
__device__ __forceinline__ float4 pack16(const float* o) { return make_float4(o[0], o[1], o[2], o[3]); }
__device__ __forceinline__ double2 pack16(const double* o) { return make_double2(o[0], o[1]); }
using omc::Vec16;

// the bits kept of ||A||_F: only whether it is finite is read back (as a
// float), so the float64 build keeps 0 or the bits of +inf
__device__ __forceinline__ int norm_bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ int norm_bits(double x) { return isfinite(x) ? 0 : 0x7f800000; }

// pair c of round q of the round robin over N players (pi < qi): the
// block pairs of an outer round (N = Nb; qi == nb is the bye) and the index
// pairs of an inner one (N = 2W)
__device__ __forceinline__ void rr_pair(int q, int c, int N, int& pi, int& qi) {
  const int x = c == 0 ? N - 1 : (q + c) % (N - 1);
  const int y = c == 0 ? q : (q - c + N - 1) % (N - 1);
  pi = min(x, y);
  qi = max(x, y);
}

// ---- 3xTF32 warp products (K1's arithmetic) ----

__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
struct Split {
  uint32_t h, l;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t h = tf32(x);
  return {h, tf32(x - __uint_as_float(h))};
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out = op(A)[r0 : r0 + 16, :K] op(B)[:K, c0 : c0 + 32] from shared memory
// (row stride L; op(A)[i][k] = A[k][i] when kTA, op(B)[k][n] = B[n][k] when
// kTB).  big*big goes to a float32 total every 16 columns, big*small and
// small*big accumulate apart.  out[n][i] is row r0 + g + 8 (i >> 1), column
// c0 + 8 n + 2 t + (i & 1) (g = lane / 4, t = lane % 4).
template <int K, int L, bool kTA, bool kTB>
__device__ __forceinline__ void warp_mm(const float* A, const float* Bm, int r0, int c0,
                                        float (&out)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto opA = [&](int i, int k) { return kTA ? A[k * L + i] : A[i * L + k]; };
  auto opB = [&](int k, int n) { return kTB ? Bm[n * L + k] : Bm[k * L + n]; };
  float total[4][4] = {}, small[4][4] = {};
#pragma unroll
  for (int kc = 0; kc < K; kc += 16) {
    float big[4][4] = {};
#pragma unroll
    for (int k0 = kc; k0 < kc + 16; k0 += 8) {
      const Split a0 = split(opA(r0 + g, k0 + t)), a1 = split(opA(r0 + g + 8, k0 + t));
      const Split a2 = split(opA(r0 + g, k0 + t + 4)), a3 = split(opA(r0 + g + 8, k0 + t + 4));
      const uint32_t ah[4] = {a0.h, a1.h, a2.h, a3.h}, al[4] = {a0.l, a1.l, a2.l, a3.l};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const Split b0 = split(opB(k0 + t, c0 + 8 * n + g));
        const Split b1 = split(opB(k0 + t + 4, c0 + 8 * n + g));
        mma_tf32(small[n], al, b0.h, b1.h);
        mma_tf32(small[n], ah, b0.l, b1.l);
        mma_tf32(big[n], ah, b0.h, b1.h);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[n][i] += big[n][i];
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[n][i] = total[n][i] + small[n][i];
}

// dst = src + op(A) op(B) over the whole N2 x N2 tile (K = N2).  The
// products are held in registers until every lane has read its operands, so
// dst may be src, A or B.
template <int W, bool kTA>
__device__ __forceinline__ void tile_update(const float* src, const float* A, const float* Bm,
                                            float* dst) {
  constexpr int N2 = BCfg<W>::N2, L = BCfg<W>::L;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float out[N2 / 16][N2 / 32][4][4];
#pragma unroll
  for (int h = 0; h < N2 / 16; ++h)
#pragma unroll
    for (int q = 0; q < N2 / 32; ++q) warp_mm<N2, L, kTA, false>(A, Bm, 16 * h, 32 * q, out[h][q]);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < N2 / 16; ++h)
#pragma unroll
    for (int q = 0; q < N2 / 32; ++q)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = (16 * h + g + 8 * (i >> 1)) * L + 32 * q + 8 * n + 2 * t + (i & 1);
          dst[o] = src[o] + out[h][q][n][i];
        }
  __syncwarp();
}

// The float64 build's tile update, in FP64 FMAs: lane c forms column c of
// the product, every row, summed in order of k (N2 = 32 columns, one a
// lane), held in registers until every lane has read its operands.
template <int W, bool kTA>
__device__ __forceinline__ void tile_update(const double* src, const double* A, const double* Bm,
                                            double* dst) {
  constexpr int N2 = BCfg<W, double>::N2, L = BCfg<W, double>::L;
  static_assert(N2 == 32, "a lane a column");
  const int c = threadIdx.x & 31;
  double out[N2];
#pragma unroll
  for (int i = 0; i < N2; ++i) out[i] = 0.0;
#pragma unroll 4
  for (int k = 0; k < N2; ++k) {
    const double b = Bm[k * L + c];
#pragma unroll
    for (int i = 0; i < N2; ++i) out[i] = fma(kTA ? A[k * L + i] : A[i * L + k], b, out[i]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N2; ++i) dst[i * L + c] = src[i * L + c] + out[i];
  __syncwarp();
}

// ---- tiles between global memory and a warp's shared memory ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// A group of G warps (G = 1, 2, 4 or 8: the block path's phase 1 gives
// each pair one group) synchronises as one warp or through a named barrier
struct Group {
  int tid, nt, id;  // thread in the group, threads, named barrier (0: one warp)
  __device__ void sync() const {
    if (id == 0)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
  }
  // a barrier that also returns whether any thread's v is nonzero
  __device__ int any(int v) const {
    if (id == 0) return __any_sync(0xffffffffu, v);
    int out;
    asm volatile(
        "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n bar.red.or.pred q, %2, %3, p;\n"
        " selp.s32 %0, 1, 0, q;\n}"
        : "=r"(out)
        : "r"(v), "r"(id), "r"(nt)
        : "memory");
    return out;
  }
};

__device__ __forceinline__ Group warp_group() { return {(int)(threadIdx.x & 31), 32, 0}; }

// a 2W x 2W tile of a row-major matrix (row stride ld) whose rows are the
// two W-row segments starting at r[0], r[1] and whose columns the two
// W-column segments starting at c[0], c[1], into shared memory (stride L),
// copied by the group's threads
template <int W, class T>
__device__ __forceinline__ void tile_load(T* dst, const T* src, size_t ld,
                                          const int (&r)[2], const int (&c)[2],
                                          const Group& gr) {
  constexpr int N2 = BCfg<W, T>::N2, L = BCfg<W, T>::L, VW = BCfg<W, T>::VW, Q = N2 / VW;
  for (int e = gr.tid; e < N2 * Q; e += gr.nt) {
    const int i = e / Q, j = VW * (e - i * Q);
    const size_t gi = r[i / W] + i % W, gj = c[j / W] + j % W;
    cp_async16(dst + i * L + j, src + gi * ld + gj);
  }
}
__device__ __forceinline__ void tile_wait(const Group& gr) {
  cp_async_wait_all();
  gr.sync();
}

// the tile back (and, kMirror, its transpose at rows c, columns r)
template <int W, bool kMirror, class T>
__device__ __forceinline__ void tile_store(T* dst, const T* src, size_t ld,
                                           const int (&r)[2], const int (&c)[2],
                                           const Group& gr) {
  constexpr int N2 = BCfg<W, T>::N2, L = BCfg<W, T>::L, VW = BCfg<W, T>::VW, Q = N2 / VW;
  for (int e = gr.tid; e < N2 * Q; e += gr.nt) {
    const int i = e / Q, j = VW * (e - i * Q);
    const size_t gi = r[i / W] + i % W, gj = c[j / W] + j % W;
    *reinterpret_cast<Vec16<T>*>(dst + gi * ld + gj) =
        *reinterpret_cast<const Vec16<T>*>(src + i * L + j);
    if (kMirror) {  // row i of the transpose: column i of the tile
      const size_t ti = c[i / W] + i % W, tj = r[j / W] + j % W;
      T col[VW];
#pragma unroll
      for (int q = 0; q < VW; ++q) col[q] = src[(j + q) * L + i];
      *reinterpret_cast<Vec16<T>*>(dst + ti * ld + tj) = pack16(col);
    }
  }
}

// ---- the kernel ----

template <class T>
struct BView {
  const K4ParamsT<T>& p;
  const BGeom& g;
  __device__ T* mat(int b) const { return p.work + kCtl + (size_t)b * g.mat_floats; }
  __device__ T* A(int b) const { return mat(b); }
  __device__ T* V(int b) const { return mat(b) + g.v_off; }
  __device__ T* E(int b, int a) const {
    return mat(b) + g.e_off + (size_t)a * g.N2 * g.N2;
  }
  __device__ T* ss(int b) const { return mat(b) + g.ss_off; }
  __device__ int* flags(int b) const { return reinterpret_cast<int*>(mat(b) + g.fl_off); }
  // flags: [0, P) rotated per pair, P converged sweep, P + 1 + (s & 1)
  // rotated this sweep, P + 3 the bits of ||A||_F
};

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier of the cooperative launch.  A CTA that waits more than
// 10 s (no phase comes near it) traps: a fault becomes a launch error,
// never a hung card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + kBarGen;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar + kBarCount, 1u) == gridDim.x - 1) {
      atomicExch(bar + kBarCount, 0u);
      __threadfence();
      atomicAdd(bar + kBarGen, 1u);
    } else {
      const unsigned long long t0 = globaltimer_ns();
      while (*gen == g0) {
        __nanosleep(20);
        if (globaltimer_ns() - t0 > 10000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// load: A = sym(M) (or sym(U U' - Y)) padded with zero rows and columns to
// D, V = I on the d real indices, each row's sum of squares; one warp a row
template <bool kSep, class T>
__device__ void blk_load(const BView<T>& v, int gw, int nw) {
  const K4ParamsT<T>& p = v.p;
  const int d = v.g.d, D = v.g.D, lane = threadIdx.x & 31;
  for (long long it = gw; it < (long long)p.B * D; it += nw) {
    const int b = (int)(it / D), i = (int)(it - (long long)b * D);
    T* A = v.A(b) + (size_t)i * D;
    T* V = p.mode ? v.V(b) + (size_t)i * D : nullptr;
    T ss = 0;
    for (int j = lane; j < D; j += 32) {
      T x = 0;
      if (i < d && j < d) {
        if (!kSep) {
          const T* Mb = p.M + (size_t)b * d * d;
          x = T(0.5) * (Mb[(size_t)i * d + j] + Mb[(size_t)j * d + i]);
        } else {
          const T* Ub = p.U + (size_t)b * d * p.k;
          const T* Yb = p.Y + (size_t)b * d * d;
          T uu = 0;
          for (int l = 0; l < p.k; ++l) uu = fma(Ub[i * p.k + l], Ub[j * p.k + l], uu);
          x = uu - T(0.5) * (Yb[(size_t)i * d + j] + Yb[(size_t)j * d + i]);
        }
      }
      A[j] = x;
      ss += x * x;
      if (V) V[j] = (i == j && i < d) ? T(1) : T(0);
    }
    ss = omc::warp_sum(ss);
    if (lane == 0) {
      v.ss(b)[i] = ss;
      if (i == 0) {
        int* f = v.flags(b);
        f[v.g.P] = f[v.g.P + 1] = f[v.g.P + 2] = 0;
      }
    }
  }
}

// (c x - s y, s x + c y) in Rutishauser's form, in float64
__device__ __forceinline__ void jacobi_rot_d(double& x, double& y, double s, double r) {
  const double x0 = x, y0 = y;
  x = x0 - s * (y0 + r * x0);
  y = y0 + s * (x0 - r * y0);
}

// phase 1 of round r of sweep s: every active pair's inner sweep, one
// group of G warps a pair (the group's shared memory is its first warp's:
// the subproblem in float64, E in float32, the round's rotations)
template <int W, class T>
__device__ __noinline__ void blk_phase1(const BView<T>& vin, int s, int r, int G, T* smem) {
  using Cfg = BCfg<W, T>;
  constexpr int N2 = Cfg::N2, L = Cfg::L, LS = N2 + 1, H = W, VW = Cfg::VW;
  const K4ParamsT<T> p = vin.p;  // the caller's are in local memory
  const BGeom g = vin.g;
  const BView<T> v{p, g};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = g.d;
  const int per_cta = Cfg::WARPS / G;
  const Group gr{(int)threadIdx.x - (warp / G) * G * 32, 32 * G, G == 1 ? 0 : 1 + warp / G};
  double* S = reinterpret_cast<double*>(smem + (size_t)(warp / G) * G * 3 * Cfg::TILE);
  T* E = reinterpret_cast<T*>(S + N2 * LS);
  T* ps = E + Cfg::TILE;  // per pair of the inner round: s, r, p, q, rot
  T* pr = ps + H;
  int* pp = reinterpret_cast<int*>(pr + H);
  int* pq = reinterpret_cast<int*>(pr + 2 * H);
  int* prot = reinterpret_cast<int*>(pr + 3 * H);
  for (long long it = blockIdx.x * per_cta + warp / G; it < (long long)v.p.B * g.P;
       it += (long long)gridDim.x * per_cta) {
    const int b = (int)(it / g.P), a = (int)(it - (long long)b * g.P);
    int* f = v.flags(b);
    if (__ldcg(f + g.P) != 0) {  // converged: nothing rotates
      if (gr.tid == 0) f[a] = 0;
      continue;
    }
    T ss = 0;  // every warp sums all rows, in the same order
    for (int i = lane; i < g.D; i += 32) ss += __ldcg(v.ss(b) + i);
    const T normF = sqrt(omc::warp_sum(ss));
    const T floor_ = omc::jacobi_floor(normF, d);
    if (gr.tid == 0 && s == 1 && r == 0 && a == 0) f[g.P + 3] = norm_bits(normF);
    int I, J;
    rr_pair(r, a, g.Nb, I, J);
    T* Ab = v.A(b);
    auto gidx = [&](int l) { return l < W ? I * W + l : J * W + l - W; };
    for (int e = gr.tid; e < N2 * N2 / VW; e += gr.nt) {
      const int i = e / (N2 / VW), j = VW * (e - i * (N2 / VW));
      T x[VW];
      unpack16(__ldcg(reinterpret_cast<const Vec16<T>*>(Ab + (size_t)gidx(i) * g.D + gidx(j))), x);
#pragma unroll
      for (int q = 0; q < VW; ++q) S[i * LS + j + q] = x[q];
    }
    gr.sync();
    auto valid = [&](int l) { return gidx(l) < d; };
    // the block form of the stopping test: does any entry fail it?
    int need = 0;
    for (int e = gr.tid; e < N2 * N2; e += gr.nt) {
      const int i = e / N2, j = e - i * N2;
      if (i < j && valid(i) && valid(j)) {
        T t, s_, rr;
        need |= omc::jacobi_rotation((T)S[i * LS + i], (T)S[j * LS + j], (T)S[i * LS + j],
                                     floor_, t, s_, rr);
      }
    }
    if (!gr.any(need)) {
      if (gr.tid == 0) f[a] = 0;
      continue;
    }
    for (int e = gr.tid; e < N2 * N2; e += gr.nt) {
      const int i = e / N2, j = e - i * N2;
      E[i * L + j] = 0;
    }
    // one sweep of the scalar schedule over the 2W local indices
    for (int q = 0; q < N2 - 1; ++q) {
      int mine = 0;
      for (int c = gr.tid; c < H; c += gr.nt) {
        int pi, qi;
        rr_pair(q, c, N2, pi, qi);
        T t = 0, s_ = 0, rr = 0;
        int rot = 0;
        if (valid(pi) && valid(qi))
          rot = omc::jacobi_rotation((T)S[pi * LS + pi], (T)S[qi * LS + qi],
                                     (T)S[pi * LS + qi], floor_, t, s_, rr);
        ps[c] = rot ? s_ : T(0);
        pr[c] = rot ? rr : T(0);
        pp[c] = pi;
        pq[c] = qi;
        prot[c] = rot;
        mine |= rot;
      }
      if (!gr.any(mine)) continue;  // (a barrier: the rotations are written)
      for (int e = gr.tid; e < H * H; e += gr.nt) {
        const int x = e / H, c = e - x * H;
        if (x > c || !(prot[x] | prot[c])) continue;
        // block (x, c) and its transpose; on the pair's own block (x == c)
        // both off-diagonal cells take x10 (written last), so it stays
        // symmetric
        const int pa = pp[x], qa = pq[x];
        const int pc = pp[c], qc = pq[c];
        double x00 = S[pa * LS + pc], x01 = S[pa * LS + qc];
        double x10 = S[qa * LS + pc], x11 = S[qa * LS + qc];
        if (prot[x]) {
          jacobi_rot_d(x00, x10, ps[x], pr[x]);
          jacobi_rot_d(x01, x11, ps[x], pr[x]);
        }
        if (prot[c]) {
          jacobi_rot_d(x00, x01, ps[c], pr[c]);
          jacobi_rot_d(x10, x11, ps[c], pr[c]);
        }
        S[pa * LS + pc] = x00;
        S[pc * LS + pa] = x00;
        S[pa * LS + qc] = x01;
        S[qc * LS + pa] = x01;
        S[qa * LS + pc] = x10;
        S[pc * LS + qa] = x10;
        S[qa * LS + qc] = x11;
        S[qc * LS + qa] = x11;
      }
      // E <- (I + E) J - I in T
      for (int e = gr.tid; e < N2 * H; e += gr.nt) {
        const int i = e / H, c = e - i * H;
        if (!prot[c]) continue;
        const int pi = pp[c], qi = pq[c];
        const T sn = ps[c], rn = pr[c];
        T x = E[i * L + pi], y = E[i * L + qi];
        omc::jacobi_rot(x, y, sn, rn);
        if (i == pi) {
          x -= sn * rn;
          y += sn;
        } else if (i == qi) {
          x -= sn;
          y -= sn * rn;
        }
        E[i * L + pi] = x;
        E[i * L + qi] = y;
      }
      gr.sync();
    }
    for (int e = gr.tid; e < N2 * N2 / VW; e += gr.nt) {
      const int i = e / (N2 / VW), j = VW * (e - i * (N2 / VW));
      T x[VW];
#pragma unroll
      for (int q = 0; q < VW; ++q) x[q] = (T)S[i * LS + j + q];
      *reinterpret_cast<Vec16<T>*>(Ab + (size_t)gidx(i) * g.D + gidx(j)) = pack16(x);
    }
    const int er[2] = {0, W};
    tile_store<W, false>(v.E(b, a), E, N2, er, er, gr);
    if (gr.tid == 0) {
      f[a] = 1;
      f[g.P + 1 + (s & 1)] = 1;
    }
    gr.sync();
  }
}

// phase 2 of round r: the A tiles between pairs a < c and V's tiles; in the
// last round of a sweep, also each matrix's convergence bookkeeping
template <int W, class Tv>
__device__ __noinline__ void blk_phase2(const BView<Tv>& vin, int s, int r, bool last, Tv* sm,
                                        int gw, int nw) {
  constexpr int N2 = BCfg<W, Tv>::N2;
  const K4ParamsT<Tv> p = vin.p;  // the caller's are in local memory
  const BGeom g = vin.g;
  const BView<Tv> v{p, g};
  const int mode = v.p.mode;
  Tv* T = sm;
  Tv* Ec = sm + BCfg<W, Tv>::TILE;
  Tv* Ea = sm + 2 * BCfg<W, Tv>::TILE;
  const Group wg = warp_group();
  const int na = g.a_tiles(), per = g.tiles(mode);
  for (long long it = gw; it < (long long)v.p.B * per; it += nw) {
    const int b = (int)(it / per);
    int j = (int)(it - (long long)b * per);
    const int* f = v.flags(b);
    if (j < na) {  // A tile (a, c), a < c
      int a = 0;
      while (j >= g.P - 1 - a) j -= g.P - 1 - a++;
      const int c = a + 1 + j;
      const int ra = __ldcg(f + a), rcn = __ldcg(f + c);
      if (!ra && !rcn) continue;
      int Ia, Ja, Ic, Jc;
      rr_pair(r, a, g.Nb, Ia, Ja);
      rr_pair(r, c, g.Nb, Ic, Jc);
      const int rr[2] = {Ia * W, Ja * W}, cc[2] = {Ic * W, Jc * W}, er[2] = {0, W};
      Tv* Ab = v.A(b);
      // T, E_c and E_a in flight together; X = T + T E_c over E_c, then
      // T' = X + E_a' X over T
      tile_load<W>(T, Ab, g.D, rr, cc, wg);
      if (rcn) tile_load<W>(Ec, v.E(b, c), N2, er, er, wg);
      if (ra) tile_load<W>(Ea, v.E(b, a), N2, er, er, wg);
      tile_wait(wg);
      const Tv* cur = T;
      if (rcn) {
        tile_update<W, false>(T, T, Ec, Ec);
        cur = Ec;
      }
      if (ra) {
        tile_update<W, true>(cur, Ea, cur, T);
        cur = T;
      }
      tile_store<W, true>(Ab, cur, g.D, rr, cc, wg);
    } else {  // V tile: rows [t 2W, (t + 1) 2W), the columns of pair a
      j -= na;
      const int t = j / g.P, a = j - t * g.P;
      if (!__ldcg(f + a)) continue;
      int I, J;
      rr_pair(r, a, g.Nb, I, J);
      const int rr[2] = {t * N2, t * N2 + W}, cc[2] = {I * W, J * W}, er[2] = {0, W};
      Tv* Vb = v.V(b);
      tile_load<W>(T, Vb, g.D, rr, cc, wg);
      tile_load<W>(Ea, v.E(b, a), N2, er, er, wg);
      tile_wait(wg);
      tile_update<W, false>(T, T, Ea, T);
      tile_store<W, false>(Vb, T, g.D, rr, cc, wg);
    }
    __syncwarp();
  }
  if (!last) return;
  unsigned* ctl = reinterpret_cast<unsigned*>(v.p.work);
  const int gt = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  for (int b = gt; b < v.p.B; b += nt) {
    int* fb = v.flags(b);
    if (__ldcg(fb + g.P) == 0) {
      if (__ldcg(fb + g.P + 1 + (s & 1)) == 0)
        fb[g.P] = s;  // a sweep that rotated no pair
      else
        atomicAdd(ctl + kActive + (s & 1), 1u);
    }
    fb[g.P + 1 + ((s + 1) & 1)] = 0;
  }
  if (gt == 0) ctl[kActive + ((s + 1) & 1)] = 0;
}

// epilogues: mode 1 the projection as 32 x 32 upper tiles; modes 0 and 2
// the rank sort (ascending, ties by index, NaN last) and the nout smallest.
// The float build forms the tiles in 3xTF32 products; the float64 build in
// FP64 FMAs, a lane a column.
template <int W, class T>
__device__ __noinline__ void blk_epilogue(const BView<T>& vin, T* sm, int gw, int nw) {
  constexpr int L = BCfg<W, T>::L, VW = BCfg<W, T>::VW;
  const K4ParamsT<T> p = vin.p;  // the caller's are in local memory
  const BGeom g = vin.g;
  const BView<T> v{p, g};
  const int d = g.d, D = g.D, lane = threadIdx.x & 31;
  const T qnan = omc::qnan_of(T(0));
  const int gt = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  for (int b = gt; b < p.B; b += nt) {
    const int done = __ldcg(v.flags(b) + g.P);
    p.sweeps[b] = done ? done : omc::kJacobiMaxSweeps + 1;
  }
  if (p.mode == 1) {
    const int nt32 = D / 32, per = nt32 * (nt32 + 1) / 2;
    T* X = sm;
    T* Y = sm + BCfg<W, T>::TILE;
    T* Z = sm + 2 * BCfg<W, T>::TILE;
    for (long long it = gw; it < (long long)p.B * per; it += nw) {
      const int b = (int)(it / per);
      int j = (int)(it - (long long)b * per), I = 0;
      while (j >= nt32 - I) j -= nt32 - I++;
      const int J = I + j;
      const T* Vb = v.V(b);
      const T* Ab = v.A(b);
      const bool bad = !isfinite(__int_as_float(__ldcg(v.flags(b) + g.P + 3)));
      const int g4 = lane >> 2, t4 = lane & 3;
      float acc[2][4][4] = {};  // the float build's fragments
      double accd[32] = {};     // the float64 build's column of the tile
      for (int kc = 0; kc < D && !bad; kc += 32) {
        for (int e = lane; e < 32 * (32 / VW); e += 32) {
          const int i = e / (32 / VW), c = VW * (e - (32 / VW) * (e / (32 / VW)));
          cp_async16(X + i * L + c, Vb + (size_t)(I * 32 + i) * D + kc + c);
          cp_async16(Y + i * L + c, Vb + (size_t)(J * 32 + i) * D + kc + c);
        }
        cp_async_wait_all();
        const int k = kc + lane;
        const T dk = k < d ? __ldcg(Ab + (size_t)k * D + k) : T(0);
        const T wk = dk > T(0) ? dk : (isnan(dk) ? dk : T(0));
        __syncwarp();
        for (int i = 0; i < 32; ++i) X[i * L + lane] *= wk;
        __syncwarp();
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float out[4][4];
            warp_mm<32, L, false, true>(X, Y, 16 * h, 0, out);
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[h][n][i] += out[n][i];
          }
        } else {
#pragma unroll 4
          for (int kk = 0; kk < 32; ++kk) {
            const double y = Y[lane * L + kk];
#pragma unroll
            for (int i = 0; i < 32; ++i) accd[i] = fma(X[i * L + kk], y, accd[i]);
          }
        }
        __syncwarp();
      }
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              Z[(16 * h + g4 + 8 * (i >> 1)) * L + 8 * n + 2 * t4 + (i & 1)] =
                  bad ? qnan : acc[h][n][i];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) Z[i * L + lane] = bad ? qnan : accd[i];
      }
      __syncwarp();
      T* Pb = p.P + (size_t)b * d * d;
      for (int e = lane; e < 32 * 32; e += 32) {
        const int i = e / 32, c = e - 32 * i;
        const int gi = I * 32 + i, gj = J * 32 + c;
        if (gi >= d || gj >= d || (I == J && c < i)) continue;
        const T x = Z[i * L + c];
        Pb[(size_t)gi * d + gj] = x;
        Pb[(size_t)gj * d + gi] = x;
      }
      __syncwarp();
    }
    return;
  }
  for (long long it = gt; it < (long long)p.B * d; it += nt) {
    const int b = (int)(it / d), i = (int)(it - (long long)b * d);
    const T* Ab = v.A(b);
    const T wi = __ldcg(Ab + (size_t)i * D + i);
    const T ki = isnan(wi) ? omc::inf_of(T(0)) : wi;
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const T wj = __ldcg(Ab + (size_t)j * D + j);
      const T kj = isnan(wj) ? omc::inf_of(T(0)) : wj;
      rank += (kj < ki) || (kj == ki && j < i);
    }
    if (rank >= p.nout) continue;
    const bool bad = !isfinite(__int_as_float(__ldcg(v.flags(b) + g.P + 3)));
    p.w[(size_t)b * p.nout + rank] = bad ? qnan : wi;
    if (p.mode == 2) {
      const T* Vb = v.V(b);
      T* Vo = p.V + (size_t)b * d * p.nout;
      for (int r = 0; r < d; ++r)
        Vo[(size_t)r * p.nout + rank] = bad ? qnan : __ldcg(Vb + (size_t)r * D + i);
    }
  }
}

// The whole schedule in one persistent launch, with grid barriers between
// the phases (a cooperative launch).  The phases do not depend on kSep:
// they are compiled once per W and T (__noinline__) and shared by the K4
// and K5 kernels.
template <int W, bool kSep, class T>
__global__ void __launch_bounds__(BCfg<W, T>::THREADS) k4_block_kernel(K4ParamsT<T> p, int G) {
  extern __shared__ __align__(16) unsigned char k4b_smem_raw[];
  T* const smem = reinterpret_cast<T*>(k4b_smem_raw);
  const BGeom g(p.d, W, p.mode);
  const BView<T> v{p, g};
  const int warp = threadIdx.x >> 5;
  T* sm = smem + (size_t)warp * 3 * BCfg<W, T>::TILE;
  const int gw = blockIdx.x * BCfg<W, T>::WARPS + warp, nw = gridDim.x * BCfg<W, T>::WARPS;
  unsigned* ctl = reinterpret_cast<unsigned*>(p.work);
  blk_load<kSep>(v, gw, nw);
  grid_sync(ctl);
  const bool timer = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t0 = timer ? globaltimer_ns() : 0, ns1 = 0, ns2 = 0;
  for (int s = 1; s <= omc::kJacobiMaxSweeps; ++s) {
    for (int r = 0; r < g.R; ++r) {
      blk_phase1<W>(v, s, r, G, smem);
      grid_sync(ctl);
      const unsigned long long t1 = timer ? globaltimer_ns() : 0;
      blk_phase2<W>(v, s, r, r == g.R - 1, sm, gw, nw);
      grid_sync(ctl);
      if (timer) {
        const unsigned long long t2 = globaltimer_ns();
        ns1 += t1 - t0;
        ns2 += t2 - t1;
        t0 = t2;
      }
    }
    if (__ldcg(ctl + kActive + (s & 1)) == 0) break;
  }
  if (timer) {
    unsigned long long* ns = reinterpret_cast<unsigned long long*>(ctl + kPhaseNs);
    ns[0] = ns1;
    ns[1] = ns2;
    ctl[kShape] = gridDim.x;
    ctl[kShape + 1] = G;
  }
  blk_epilogue<W>(v, sm, gw, nw);
}

inline int fail(cudaError_t err) {
  cudaGetLastError();  // clear it, so that the next launch is not refused for it
  return (int)err;
}

// The block path's launch shape: as many CTAs as the card co-schedules (its
// occupancy at this shared memory), or fewer when the work items are fewer,
// and G, the warps of phase 1's group per pair: the most (up to a CTA's) that
// still give every pair of the call its own group
template <int W, bool kSep, class T>
int block_shape(const K4ParamsT<T>& p, int& grid, int& G) {
  using C = BCfg<W, T>;
  static int smem_set = 0;
  cudaError_t err;
  if (!smem_set) {
    err = cudaFuncSetAttribute(k4_block_kernel<W, kSep, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return fail(err);
    smem_set = 1;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return fail(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return fail(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k4_block_kernel<W, kSep, T>,
                                                      C::THREADS, C::SMEM);
  if (err != cudaSuccess) return fail(err);
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long most = (long long)per_sm * sms;
  const BGeom g(p.d, W, p.mode);
  const long long pairs = (long long)p.B * g.P;
  G = C::WARPS;
  while (G > 1 && pairs * G > most * C::WARPS) G /= 2;
  long long items = std::max<long long>(pairs * G, (long long)p.B * g.tiles(p.mode));
  if (p.mode == 1) items = std::max<long long>(items, (long long)p.B * (g.D / 32) * (g.D / 32 + 1) / 2);
  items = std::max<long long>(items, ((long long)p.B * std::max(g.D, p.d) + 31) / 32);
  grid = (int)std::max<long long>(1, std::min<long long>(most, (items + C::WARPS - 1) / C::WARPS));
  return 0;
}

template <int W, bool kSep, class T>
int launch_block(K4ParamsT<T> p, cudaStream_t stream) {
  using C = BCfg<W, T>;
  int grid = 0, G = 1;
  const int rc = block_shape<W, kSep>(p, grid, G);
  if (rc) return rc;
  cudaError_t err = cudaMemsetAsync(p.work, 0, kCtl * sizeof(T), stream);
  if (err != cudaSuccess) return fail(err);
  void* args[] = {&p, &G};
  err = cudaLaunchCooperativeKernel((const void*)k4_block_kernel<W, kSep, T>, dim3(grid),
                                    dim3(C::THREADS), args, C::SMEM, stream);
  if (err != cudaSuccess) return fail(err);
  return (int)cudaGetLastError();
}

constexpr int kBlockWidth = 16;

template <class T>
int k4_entry(const K4ParamsT<T>& p, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.path == 2) {  // the tridiagonal path: float64 operands only
    if constexpr (sizeof(T) == 8)
      return k4t_entry(p, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (p.path == 1)
    return p.M ? launch_block<kBlockWidth, false>(p, st) : launch_block<kBlockWidth, true>(p, st);
  const size_t smem = cta_smem_bytes<T>(p.d, p.mode);
  if (p.path != 0 || smem == 0) return (int)cudaErrorInvalidValue;
  return p.M ? launch_k4<false>(p, smem, stream) : launch_k4<true>(p, smem, stream);
}

}  // namespace

// the whole call's workspace in elements of the operands' type (floats, or
// doubles for omc_k4_jacobi_f64): none on the CTA path; the tridiagonal
// path's in doubles
OMC_EXPORT long long omc_k4_workspace_floats(int B, int d, int mode, int path) {
  if (path == 0) return 0;
  if (path == 2) return k4t_workspace_doubles(B, d, mode);
  return (long long)kCtl + (long long)B * BGeom(d, kBlockWidth, mode).mat_floats;
}

// the CTA path's shared memory at the operands' element size (4 or 8), or
// 0 where A (and V) do not fit
OMC_EXPORT long long omc_k4_cta_smem_bytes(int d, int mode, int elem) {
  return (long long)(elem == 8 ? cta_smem_bytes<double>(d, mode) : cta_smem_bytes<float>(d, mode));
}

// path 0: the CTA path (refused unless A, and V, fit in shared memory);
// path 1: the block path, one cooperative launch; path 2 (float64 only):
// the tridiagonal path, csrc/k4_tridiag.cu
OMC_EXPORT int omc_k4_jacobi(const K4Params* params, void* stream) {
  return k4_entry(*params, stream);
}

// the float64 build: double operands and outputs, the same paths
OMC_EXPORT int omc_k4_jacobi_f64(const K4ParamsT<double>* params, void* stream) {
  return k4_entry(*params, stream);
}
