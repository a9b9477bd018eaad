// K6 — altmin's masked ridge steps.
//
// Replaces omc/ops/linalg.py:15-50 (v_step, u_step_unconstrained), called
// by omc/altmin.py:53-152 once per altmin iteration each; in the port
// omc_torch.ops.linalg.v_step / u_step_unconstrained on CUDA.
//
// V-step: per node slot b and column j of V,
//   G_j = sum_i mask_ij u_i u_i' + (1/gamma) U'U + eps I,
//   rhs_j = sum_i mask_ij A_ij u_i,   G_j v_j = rhs_j   (u_i = U[b, i, :]).
// The U-step is the same with the roles of rows and columns exchanged:
// per row i of U, H_i = sum_j mask_ij v_j v_j' + (1/gamma) V V' + eps I and
// rhs_i = sum_j mask_ij A_ij v_j.  One kernel serves both: it reduces over
// index r and solves for output o, reading mask and A at r * s_r + o * s_o.
//
// What bounds it on the H100: fp32 operations.  Per (slot, output, r) the
// packed lower Gram and the right-hand side take k(k+1)/2 + 2k + 2 flops
// (77 at k = 10), against reading the n x m mask and A once; the tile path
// does them for every r, the slots path for the observed r only.
//
// Design: K is a template parameter (1..10); each lane keeps one (slot,
// output)'s packed lower Gram and right-hand side in registers (at most
// 55 + 10 floats), and every update, the Cholesky and both triangular solves
// unroll.  ops.linalg.k6_plan picks one of two paths and its tiling:
// - tile path (lanes = 32 outputs of one slot; small batches): a CTA serves
//   32 outputs of S slots with S x W warps, warp (s, w) summing the
//   contiguous r range [w rpw, (w + 1) rpw) of slot s.  The S warps of a
//   range stage its mask and A tiles through shared memory together
//   (coalesced for both steps, so the U-step reads the row-major mask
//   without a transpose), each with its own factor chunk.  (1/gamma) F'F
//   rides in the same sums (the Gram weight of r is mask + 1/gamma); the W
//   partials are added in warp order through shared memory.
// - slots path (lanes = 32 slots, one output a warp; batches of 32 and
//   more): the mask is the same for every slot, so a warp skips an r its
//   output does not observe as a whole, and does the Gram work of the
//   observed entries only.  A CTA of W warps (up to 16) serves W outputs of
//   32 slots; the 32 slots' factor rows (the U-step's wrapper hands V in as
//   (B, m, k)) stream in 16-byte cp.async pieces through two shared-memory
//   buffers of 32 rows, each shared by the W warps, so the copies per
//   output fall as W grows.  (1/gamma) F'F comes from a small kernel before
//   it (one CTA a slot, 16 r ranges added in order) into the wrapper's
//   scratch.
// Sums run in a fixed order, so two launches give the same bits; k = 1
// divides, as the plain version does.
//
// The float64 build (omc_k6_vstep_f64, omc_k6_ustep_f64) is the same
// kernels on doubles: the Gram and the right-hand side in registers at two
// registers a value, so both paths run at most 8 warps a CTA and one CTA
// an SM (255 registers a thread: k = 10 keeps its 55 + 10 doubles without a
// spill), 16-byte copies of two doubles, 8-byte cp.async for the mask and
// A; its plan is ops.linalg.k6_plan at dtype float64.
//
// Wide path (k > 10, both builds): a lane cannot hold a k x k Gram, so the
// packed Gram and right-hand side of a (slot, output), tri(k) + k values,
// lie in memory and are spread over a warp's lanes (entry e to lane e %
// 32).  A CTA of W warps serves W outputs of one slot: the slot's factor
// rows stream through shared memory in chunks of 32 rows (fewer where 32
// rows of k would not fit, k in the hundreds; the U-step's wrapper
// hands V in as (B, m, k), as on the slots path); each warp compacts the
// rows its output observes (a ballot of the mask, the same for every slot)
// and each lane adds them, in row order, into its own entries.  The
// entries sit in shared memory where W warps' fit beside the chunk (S =
// 1), else in a workspace in global memory behind the (1/gamma) F'F
// scratch (S = 0).  (1/gamma) F'F comes from k6_gram_wide_kernel (a
// thread an entry, r in order).  Then
// the warp factors the Gram (Cholesky by columns, the column's rows over
// the lanes) and solves L y = rhs (each y_i's dot product over the lanes,
// xor shuffles) and L' x = y (x_i subtracted from the entries above it,
// over the lanes), every sum in a fixed order: two launches give the same
// bits.  Bounded by the same operations as the register paths, and by
// shared-memory traffic: each observed (r, entry) reads two staged factor
// values.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32, kUnit = 8, kMaxWarps = 8, kMaxSlotsWarps = 16;
constexpr int kSmemMax = 232448;  // a CTA's shared memory on the H100

struct Geom {
  int R, O;              // reduction length, outputs
  long long fB, fr, fl;  // factor (b, r, l) strides
  int sr, so;            // mask / A (r, o) strides
  long long oB, oo, ol;  // output (b, o, l) strides
};

__host__ __device__ constexpr int tri(int a) { return a * (a + 1) / 2; }
__host__ __device__ constexpr int fstride(int k) { return (k + 3) & ~3; }
// the most warps of a slots-path CTA (the float64 build: 8, for its registers)
template <class T>
__host__ __device__ constexpr int max_slots_warps() {
  return sizeof(T) == 8 ? kMaxWarps : kMaxSlotsWarps;
}

// the slots path's slot stride: rpw rows of k values as they lie in the
// factor (so 16-byte copies land whole), rounded up to an odd number of
// 16-byte units (lanes read distinct bank groups: float4 rows for k % 4 ==
// 0, float2 rows two lanes a bank pair for even k); vw values a unit (4
// floats, or 2 doubles)
__host__ __device__ constexpr int slot_stride(int k, int rpw, int vw = 4) {
  return ((rpw * k + vw - 1) & ~(vw - 1)) +
         ((((rpw * k + vw - 1) & ~(vw - 1)) / vw) % 2 == 0 ? vw : 0);
}

template <class T>
using Pair = typename std::conditional<sizeof(T) == 8, double2, float2>::type;
__device__ __forceinline__ float2 make_pair2(float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ double2 make_pair2(double a, double b) { return make_double2(a, b); }

// 16 bytes global -> shared, of which `bytes` (0..16) are read and the rest
// zero-filled (src is not read when bytes == 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// dynamic shared memory (values of the operands' type; vw of them in 16
// bytes).  Tile path: per r range the padded mask and A tiles of min(32,
// rpw) rows, per warp its factor chunk; the combine reuses it for the S (W
// - 1) partials.  Slots path: two buffers (cp.async double buffering), each
// the 32 slots' factor chunk, then the W outputs' mask and A chunk.
__host__ __device__ inline int smem_floats(int path, int k, int S, int W, int rpw, int vw = 4) {
  if (path == 1) return 2 * (kTile * slot_stride(k, rpw, vw) + 2 * W * rpw);
  const int ch = rpw < kTile ? rpw : kTile;
  const int stage = W * 2 * ch * (kTile + 1) + S * W * ch * fstride(k);
  const int comb = S * (W - 1) * (tri(k) + k) * kTile;
  return stage > comb ? stage : comb;
}

// A thread's share of a staging copy: items i = 0 .. count - 1, U loads
// at a time started before their stores, so a thread's loads overlap instead
// of queueing (the item -> address maps are cheap: no division by a
// runtime value in the loop).  U = 4 on the tile path keeps k = 10 within
// the 128 registers of two CTAs an SM.
template <int U, typename T, typename Load, typename Store>
__device__ __forceinline__ void stage(int count, Load load, Store store) {
  for (int i0 = 0; i0 < count; i0 += U) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u < count) v[u] = load(i0 + u);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u < count) store(i0 + u, v[u]);
  }
}

// 4 bytes global -> shared, zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async_one(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// the float64 build's: 8 bytes
__device__ __forceinline__ void cp_async_one(double* dst, const double* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void range_barrier(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// G += w f f' (lower), rhs += aw f
template <int K, class T>
__device__ __forceinline__ void gram_update(T (&G)[tri(K)], T (&rhs)[K],
                                            const T (&f)[fstride(K)], T w, T aw) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    rhs[a] = fma(aw, f[a], rhs[a]);
    const T wu = w * f[a];
#pragma unroll
    for (int c = 0; c <= a; ++c) G[tri(a) + c] = fma(wu, f[c], G[tri(a) + c]);
  }
}

// f[0 .. K) = row[0 .. K): float4 pieces for K % 4 == 0, float2 for even
// K (the slots path's rows are K-float aligned); double2 pieces for even K
// in the float64 build
template <int K>
__device__ __forceinline__ void load_row(double (&f)[fstride(K)], const double* row) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int a = 0; a < K; a += 2) {
      const double2 v = *reinterpret_cast<const double2*>(row + a);
      f[a] = v.x, f[a + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int a = 0; a < K; ++a) f[a] = row[a];
  }
}

template <int K>
__device__ __forceinline__ void load_row(float (&f)[fstride(K)], const float* row) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int a = 0; a < K; a += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + a);
      f[a] = v.x, f[a + 1] = v.y, f[a + 2] = v.z, f[a + 3] = v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int a = 0; a < K; a += 2) {
      const float2 v = *reinterpret_cast<const float2*>(row + a);
      f[a] = v.x, f[a + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int a = 0; a < K; ++a) f[a] = row[a];
  }
}

// out[l * ol] = (G + eps I)^-1 rhs: k = 1 divides; else G = L L' in place
// (packed lower), then L y = rhs, L' x = y
template <int K, class T>
__device__ __forceinline__ void solve_store(T (&G)[tri(K)], T (&rhs)[K], T eps,
                                            T* out, long long ol) {
#pragma unroll
  for (int a = 0; a < K; ++a) G[tri(a) + a] += eps;
  if (K == 1) {
    out[0] = rhs[0] / G[0];
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T djj = G[tri(j) + j];
#pragma unroll
    for (int q = 0; q < j; ++q) djj -= G[tri(j) + q] * G[tri(j) + q];
    djj = sqrt(djj);
    G[tri(j) + j] = djj;
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      T v = G[tri(i) + j];
#pragma unroll
      for (int q = 0; q < j; ++q) v -= G[tri(i) + q] * G[tri(j) + q];
      G[tri(i) + j] = v / djj;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T v = rhs[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= G[tri(i) + q] * rhs[q];
    rhs[i] = v / G[tri(i) + i];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    T v = rhs[i];
#pragma unroll
    for (int q = i + 1; q < K; ++q) v -= G[tri(q) + i] * rhs[q];
    rhs[i] = v / G[tri(i) + i];
  }
#pragma unroll
  for (int l = 0; l < K; ++l) out[l * ol] = rhs[l];
}

// ---- tile path: lanes = 32 outputs of a slot ----
// two CTAs an SM in the float build; one in the float64 build (its Gram
// takes twice the registers)
template <int K, class T>
__global__ void __launch_bounds__(kMaxWarps * kTile, sizeof(T) == 8 ? 1 : 2)
    k6_kernel(K6ParamsT<T> p, Geom g) {
  constexpr int NT = tri(K), FS = fstride(K);
  extern __shared__ __align__(16) unsigned char k6_smem_raw[];
  T* const sm = reinterpret_cast<T*>(k6_smem_raw);
  const int S = p.S, W = p.W, CH = min(p.rpw, kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = warp % S, w = warp / S;
  const int b = blockIdx.y * S + s;
  const int o0 = blockIdx.x * kTile;
  const int lo = w * p.rpw, hi = min(g.R, lo + p.rpw);
  T* mt = sm + w * 2 * CH * (kTile + 1);
  T* at = mt + CH * (kTile + 1);
  T* fac = sm + W * 2 * CH * (kTile + 1) + warp * CH * FS;
  const T* F = p.F + (size_t)min(b, p.B - 1) * g.fB;
  const T ig = p.inv_gamma;
  const int nthr = S * kTile;
  // U-step staging: the lanes as per x CH (row, output offset) pairs
  const bool v_step = g.so == 1;
  const int per = kTile / CH, lane_r = lane % CH, lane_o = lane / CH;

  T G[NT], rhs[K];
#pragma unroll
  for (int e = 0; e < NT; ++e) G[e] = 0;
#pragma unroll
  for (int a = 0; a < K; ++a) rhs[a] = 0;

  for (int r0 = lo; r0 < hi; r0 += CH) {
    const int rows = min(CH, hi - r0);
    range_barrier(1 + w, nthr);  // the range's previous chunk is consumed
    // mask and A, coalesced: the lanes walk the stride-1 axis of (n, m)
    if (v_step) {  // outputs along the lanes, rows s, s + S, ...
      stage<4, Pair<T>>((CH - s + S - 1) / S,
                    [&](int i) {
                      const int rl = s + i * S;
                      if (rl >= rows || o0 + lane >= g.O) return make_pair2(T(0), T(0));
                      const long long q = (long long)(r0 + rl) * g.sr + o0 + lane;
                      return make_pair2(__ldg(p.mask + q), __ldg(p.A + q));
                    },
                    [&](int i, Pair<T> v) {
                      const int rl = s + i * S;
                      mt[rl * (kTile + 1) + lane] = v.x, at[rl * (kTile + 1) + lane] = v.y;
                    });
    } else if (lane < per * CH) {  // rows along the lanes, outputs lo_, lo_ + per, ...
      stage<4, Pair<T>>((kTile - lane_o - s * per + S * per - 1) / (S * per),
                    [&](int i) {
                      const int ol = lane_o + (s + i * S) * per;
                      if (lane_r >= rows || o0 + ol >= g.O) return make_pair2(T(0), T(0));
                      const long long q = (long long)(r0 + lane_r) * g.sr + (long long)(o0 + ol) * g.so;
                      return make_pair2(__ldg(p.mask + q), __ldg(p.A + q));
                    },
                    [&](int i, Pair<T> v) {
                      const int ol = lane_o + (s + i * S) * per;
                      mt[lane_r * (kTile + 1) + ol] = v.x, at[lane_r * (kTile + 1) + ol] = v.y;
                    });
    }
    // this warp's factor rows
    if (g.fl == 1) {  // the chunk's CH x K floats are contiguous
      stage<4, T>((CH * K - lane + kTile - 1) / kTile,
                   [&](int i) {
                     const int q = lane + i * kTile, rl = q / K;
                     return rl < rows ? __ldg(F + (size_t)r0 * g.fr + q) : T(0);
                   },
                   [&](int i, T v) {
                     const int q = lane + i * kTile, rl = q / K;
                     fac[rl * FS + q - rl * K] = v;
                   });
    } else if (lane < CH) {  // K rows of the chunk's CH contiguous floats
      stage<4, T>(K,
                   [&](int l) {
                     return lane < rows ? __ldg(F + (size_t)(r0 + lane) * g.fr + (size_t)l * g.fl)
                                        : T(0);
                   },
                   [&](int l, T v) { fac[lane * FS + l] = v; });
    }
    range_barrier(1 + w, nthr);
    for (int rl = 0; rl < rows; ++rl) {
      const T wv = mt[rl * (kTile + 1) + lane];
      T f[FS];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int a = 0; a < FS; a += 4) {
          const float4 v = *reinterpret_cast<const float4*>(fac + rl * FS + a);
          f[a] = v.x, f[a + 1] = v.y, f[a + 2] = v.z, f[a + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int a = 0; a < FS; a += 2) {
          const double2 v = *reinterpret_cast<const double2*>(fac + rl * FS + a);
          f[a] = v.x, f[a + 1] = v.y;
        }
      }
      gram_update<K>(G, rhs, f, wv + ig, wv * at[rl * (kTile + 1) + lane]);
    }
  }

  // ---- the W partials in warp order ----
  __syncthreads();
  if (w > 0) {
    T* dst = sm + ((w - 1) * S + s) * (NT + K) * kTile + lane;
#pragma unroll
    for (int e = 0; e < NT; ++e) dst[e * kTile] = G[e];
#pragma unroll
    for (int a = 0; a < K; ++a) dst[(NT + a) * kTile] = rhs[a];
  }
  __syncthreads();
  const int o = o0 + lane;
  if (w != 0 || b >= p.B || o >= g.O) return;
  for (int v = 1; v < W; ++v) {
    const T* src = sm + ((v - 1) * S + s) * (NT + K) * kTile + lane;
#pragma unroll
    for (int e = 0; e < NT; ++e) G[e] += src[e * kTile];
#pragma unroll
    for (int a = 0; a < K; ++a) rhs[a] += src[(NT + a) * kTile];
  }
  solve_store<K>(G, rhs, p.ridge_eps, p.out + b * g.oB + o * g.oo, g.ol);
}

// ---- slots path: (1/gamma) F'F per slot, kGramRanges r ranges added in order ----
constexpr int kGramRanges = 16;
template <int K, class T>
__global__ void __launch_bounds__(kGramRanges * 64) k6_gram_kernel(K6ParamsT<T> p, Geom g) {
  constexpr int NT = tri(K);
  __shared__ T part[kGramRanges][64];
  const int e = threadIdx.x & 63, q = threadIdx.x >> 6, b = blockIdx.x;
  const T* F = p.F + (size_t)b * g.fB;
  T s = 0;
  if (e < NT) {
    int a = 0;
    while (tri(a + 1) <= e) ++a;
    const int c = e - tri(a), len = (g.R + kGramRanges - 1) / kGramRanges;
    const int lo = q * len, hi = min(g.R, lo + len);
#pragma unroll 4
    for (int r = lo; r < hi; ++r) s = fma(F[r * g.fr + a * g.fl], F[r * g.fr + c * g.fl], s);
  }
  part[q][e] = s;
  __syncthreads();
  if (q == 0 && e < NT) {
    T t = part[0][e];
    for (int i = 1; i < kGramRanges; ++i) t += part[i][e];
    p.gram[(size_t)b * NT + e] = p.inv_gamma * t;
  }
}

// ---- slots path: lanes = 32 slots, warp = one output ----
template <int K, class T>
__global__ void __launch_bounds__(max_slots_warps<T>() * kTile, 1)
    k6_slots_kernel(K6ParamsT<T> p, Geom g) {
  constexpr int NT = tri(K), FS = fstride(K), VW = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char k6s_smem_raw[];
  T* const sm = reinterpret_cast<T*>(k6s_smem_raw);
  const int NW = p.W, CH = p.rpw, FSTR = slot_stride(K, CH, VW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * kTile, b = b0 + lane;
  const int o0 = blockIdx.x * NW, o = o0 + warp;
  // the (row, output) this thread stages: outputs along the threads for
  // the V-step's row-major mask, rows for the U-step's
  const int st_r = g.so == 1 ? threadIdx.x / NW : lane, st_o = g.so == 1 ? threadIdx.x % NW : warp;
  const int buf = kTile * FSTR + 2 * NW * CH;  // one buffer: [32][FSTR], [NW][CH] x 2

  T G[NT], rhs[K];
#pragma unroll
  for (int e = 0; e < NT; ++e) G[e] = 0;
#pragma unroll
  for (int a = 0; a < K; ++a) rhs[a] = 0;

  // chunk r0's copies into buffer bs: the 32 slots' rows r0 .. r0 + 31 of
  // the factor, (B, R, K) rows (32 K contiguous values a slot, 16 bytes a
  // copy), then one (row, output) of mask and A a thread
  constexpr int Q = kTile * K / VW;  // 16-byte pieces of a slot's chunk
  auto copy_chunk = [&](int r0, T* bs) {
    const int rows = min(CH, g.R - r0);
    for (int c = threadIdx.x; c < kTile * Q; c += blockDim.x) {
      const int sl = c / Q, q = c - sl * Q, bb = b0 + sl;
      const int bytes = bb < p.B ? (int)sizeof(T) * min(VW, max(0, rows * K - VW * q)) : 0;
      cp_async16(bs + sl * FSTR + VW * q,
                 bytes ? p.F + bb * g.fB + (size_t)r0 * K + VW * q : p.F, bytes);
    }
    const bool in = st_r < rows && o0 + st_o < g.O;
    const long long q = in ? (long long)(r0 + st_r) * g.sr + (long long)(o0 + st_o) * g.so : 0;
    T* ms = bs + kTile * FSTR;
    cp_async_one(ms + st_o * CH + st_r, p.mask + q, in);
    cp_async_one(ms + NW * CH + st_o * CH + st_r, p.A + q, in);
    cp_async_commit();
  };
  const int nch = (g.R + CH - 1) / CH;
  if (nch > 0) copy_chunk(0, sm);
  for (int c = 0; c < nch; ++c) {
    // the next chunk's copies fly while this one is summed
    if (c + 1 < nch) {
      copy_chunk((c + 1) * CH, sm + ((c + 1) & 1) * buf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* fs = sm + (c & 1) * buf;
    const T* ms = fs + kTile * FSTR;
    const T* as = ms + NW * CH;
    const int rows = min(CH, g.R - c * CH);
    for (int rl = 0; rl < rows; ++rl) {
      const T wv = ms[warp * CH + rl];  // the same for every lane
      if (wv == T(0)) continue;
      T f[FS];
      load_row<K>(f, fs + lane * FSTR + rl * K);
      gram_update<K>(G, rhs, f, wv, wv * as[warp * CH + rl]);
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
  if (b >= p.B || o >= g.O) return;
  const T* gr = p.gram + (size_t)b * NT;
#pragma unroll
  for (int e = 0; e < NT; ++e) G[e] += gr[e];
  solve_store<K>(G, rhs, p.ridge_eps, p.out + b * g.oB + o * g.oo, g.ol);
}

// ---- wide path: (1/gamma) F'F per slot, a thread an entry, r in order ----
constexpr int kGramWideThreads = 256;
template <class T>
__global__ void __launch_bounds__(kGramWideThreads) k6_gram_wide_kernel(K6ParamsT<T> p, Geom g) {
  const int k = p.k, NT = tri(k), b = blockIdx.x;
  const T* F = p.F + (size_t)b * g.fB;
  int a = 0, c = threadIdx.x;
  for (int e = threadIdx.x; e < NT; e += kGramWideThreads, c += kGramWideThreads) {
    while (c > a) c -= ++a;  // e = tri(a) + c, c <= a
    T s = 0;
    for (int r = 0; r < g.R; ++r) s = fma(F[(size_t)r * k + a], F[(size_t)r * k + c], s);
    p.gram[(size_t)b * NT + e] = p.inv_gamma * s;
  }
}

// the wide path's dynamic shared memory in bytes: the chunk's rpw factor
// rows, each warp's compacted weights and weighted A (32 each), its
// tri(k) + k entries where they are in shared memory (acc_smem), then each
// warp's 32 row indices
__host__ __device__ inline long long wide_smem_bytes(int k, int acc_smem, int W, int rpw,
                                                     int elem) {
  const long long E = tri(k) + k;
  return (long long)elem * ((long long)rpw * k + 2LL * W * kTile + (acc_smem ? W * E : 0)) +
         4LL * W * kTile;
}

// ---- wide path: a warp per (slot, output), W outputs of one slot a CTA ----
template <class T>
__global__ void __launch_bounds__(kMaxWarps * kTile) k6_wide_kernel(K6ParamsT<T> p, Geom g) {
  extern __shared__ __align__(16) unsigned char k6w_smem_raw[];
  T* const sm = reinterpret_cast<T*>(k6w_smem_raw);
  const int k = p.k, NT = tri(k), E = NT + k, NW = p.W, CH = p.rpw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, o = blockIdx.x * NW + warp;
  const bool live = o < g.O;  // warps past the last output still stage
  T* const fs = sm;                                 // [CH][k] the chunk's factor rows
  T* const wl = fs + CH * k + warp * 2 * kTile;     // the warp's observed rows: weight,
  T* const al = wl + kTile;                         // weight times A
  T* const acc = p.S ? fs + CH * k + NW * 2 * kTile + warp * E
                     : p.gram + (size_t)p.B * NT + ((size_t)b * g.O + min(o, g.O - 1)) * E;
  int* const rl = reinterpret_cast<int*>(fs + CH * k + NW * 2 * kTile + (p.S ? NW * E : 0)) +
                  warp * kTile;                     // and their rows in the chunk
  const T* const F = p.F + (size_t)b * g.fB;
  if (live)
    for (int e = lane; e < E; e += kTile) acc[e] = T(0);
  for (int r0 = 0; r0 < g.R; r0 += CH) {
    const int rows = min(CH, g.R - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int q = threadIdx.x; q < rows * k; q += blockDim.x) fs[q] = __ldg(F + (size_t)r0 * k + q);
    int cnt = 0;
    if (live) {
      T wv = 0, av = 0;
      if (lane < rows) {
        const long long q = (long long)(r0 + lane) * g.sr + (long long)o * g.so;
        wv = __ldg(p.mask + q);
        av = wv * __ldg(p.A + q);
      }
      const unsigned obs = __ballot_sync(0xffffffffu, wv != T(0));
      if (wv != T(0)) {
        const int at = __popc(obs & ((1u << lane) - 1u));
        wl[at] = wv, al[at] = av, rl[at] = lane;
      }
      cnt = __popc(obs);
    }
    __syncthreads();
    // lane's entries e = lane, lane + 32, ...: (a, c) of the packed lower
    // Gram (e = tri(a) + c), then (a = k) the right-hand side's c
    int a = 0, c = lane;
    for (int e = lane; e < E && cnt; e += kTile, c += kTile) {
      while (a < k && c > a) c -= ++a;
      T s = acc[e];
      if (a < k) {
        for (int t = 0; t < cnt; ++t) {
          const T* f = fs + rl[t] * k;
          s = fma(wl[t] * f[a], f[c], s);
        }
      } else {
        for (int t = 0; t < cnt; ++t) s = fma(al[t], fs[rl[t] * k + c], s);
      }
      acc[e] = s;
    }
  }
  if (!live) return;
  __syncwarp();
  const T* gr = p.gram + (size_t)b * NT;
  for (int e = lane; e < NT; e += kTile) acc[e] += gr[e];
  __syncwarp();
  for (int a = lane; a < k; a += kTile) acc[tri(a) + a] += p.ridge_eps;
  __syncwarp();
  const auto ix = [](int i, int j) { return tri(i) + j; };
  omc::warp_cholesky(acc, k, ix);
  T* const rhs = acc + NT;
  omc::warp_cho_solve(acc, k, ix, [rhs](int i) -> T& { return rhs[i]; });
  T* const out = p.out + b * g.oB + o * g.oo;
  for (int l = lane; l < k; l += kTile) out[l * g.ol] = rhs[l];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  // once per instantiation: the card's whole per-CTA shared memory
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  done = err == cudaSuccess;
  return err;
}

template <int K, class T>
int launch_k(const K6ParamsT<T>& p, const Geom& g, void* stream) {
  const size_t smem = sizeof(T) * smem_floats(p.path, K, p.S, p.W, p.rpw, 16 / sizeof(T));
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.path == 0) {
    static bool done = false;
    if (smem > 48 * 1024) {
      const cudaError_t err = allow_smem(k6_kernel<K, T>, done);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((g.O + kTile - 1) / kTile, (p.B + p.S - 1) / p.S);
    k6_kernel<K, T><<<grid, p.S * p.W * kTile, smem, st>>>(p, g);
    return (int)cudaGetLastError();
  }
  static bool done = false;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(k6_slots_kernel<K, T>, done);
    if (err != cudaSuccess) return (int)err;
  }
  k6_gram_kernel<K, T><<<p.B, kGramRanges * 64, 0, st>>>(p, g);
  const dim3 grid((g.O + p.W - 1) / p.W, (p.B + kTile - 1) / kTile);
  k6_slots_kernel<K, T><<<grid, p.W * kTile, smem, st>>>(p, g);
  return (int)cudaGetLastError();
}

// the wide path: any k; W warps a CTA (at most 8), chunks of rpw <= 32 rows
// of (B, R, k), the entries in shared memory (S = 1) or behind the (1/gamma) F'F
// scratch in gram (S = 0)
template <class T>
int launch_wide(const K6ParamsT<T>& p, const Geom& g, void* stream) {
  if (p.k < 1 || p.W < 1 || p.W > kMaxWarps || p.rpw < 1 || p.rpw > kTile ||
      (p.S != 0 && p.S != 1) || p.gram == nullptr || g.fl != 1 || g.fr != p.k)
    return (int)cudaErrorInvalidValue;
  if (p.B <= 0 || g.O <= 0) return (int)cudaSuccess;
  const long long smem = wide_smem_bytes(p.k, p.S, p.W, p.rpw, sizeof(T));
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  k6_gram_wide_kernel<T><<<p.B, kGramWideThreads, 0, st>>>(p, g);
  const dim3 grid((g.O + p.W - 1) / p.W, p.B);
  static bool done = false;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(k6_wide_kernel<T>, done);
    if (err != cudaSuccess) return (int)err;
  }
  k6_wide_kernel<T><<<grid, p.W * kTile, (size_t)smem, st>>>(p, g);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const K6ParamsT<T>& p, const Geom& g, void* stream) {
  const int R1 = g.R > 0 ? g.R : 1;
  if (p.path == 2) return launch_wide(p, g, stream);
  if (p.path == 0) {
    // W non-empty ranges of a multiple of kUnit rows cover every r once,
    // in at most kMaxWarps warps
    if (p.S < 1 || p.W < 1 || p.S * p.W > kMaxWarps || p.rpw < kUnit || p.rpw % kUnit ||
        (long long)(p.W - 1) * p.rpw >= R1 || (long long)p.W * p.rpw < R1)
      return (int)cudaErrorInvalidValue;
  } else if (p.path != 1 || p.W < 1 || p.W > max_slots_warps<T>() || p.rpw != kTile ||
             p.gram == nullptr || g.fl != 1 || g.fr != p.k ||
             (long long)g.R * p.k % (16 / (int)sizeof(T)) ||
             reinterpret_cast<uintptr_t>(p.F) % 16) {
    // the slots path stages 32 rows a chunk in 16-byte pieces of (B, R, k)
    // rows, one (row, output) of mask and A a thread
    return (int)cudaErrorInvalidValue;
  }
  if (p.B <= 0 || g.O <= 0) return (int)cudaSuccess;
  switch (p.k) {
    case 1: return launch_k<1>(p, g, stream);
    case 2: return launch_k<2>(p, g, stream);
    case 3: return launch_k<3>(p, g, stream);
    case 4: return launch_k<4>(p, g, stream);
    case 5: return launch_k<5>(p, g, stream);
    case 6: return launch_k<6>(p, g, stream);
    case 7: return launch_k<7>(p, g, stream);
    case 8: return launch_k<8>(p, g, stream);
    case 9: return launch_k<9>(p, g, stream);
    case 10: return launch_k<10>(p, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int vstep(const K6ParamsT<T>& p, void* stream) {
  const Geom g{p.n, p.m, (long long)p.n * p.k, p.k, 1, p.m, 1,
               (long long)p.k * p.m, 1, p.m};
  return launch(p, g, stream);
}

template <class T>
int ustep(const K6ParamsT<T>& p, void* stream) {
  const bool rows = p.path != 0;
  const Geom g{p.m, p.n, (long long)p.k * p.m, rows ? p.k : 1, rows ? 1 : p.m, 1, p.m,
               (long long)p.n * p.k, p.k, 1};
  return launch(p, g, stream);
}

}  // namespace

// V-step: U (B, n, k) fixed, V (B, k, m) solved per column j; r = row i
OMC_EXPORT int omc_k6_vstep(const K6Params* params, void* stream) {
  return vstep(*params, stream);
}

// U-step: V (B, k, m) fixed, U (B, n, k) solved per row i; r = column j.
// The slots path takes V transposed, (B, m, k): rows of k, as U is.
OMC_EXPORT int omc_k6_ustep(const K6Params* params, void* stream) {
  return ustep(*params, stream);
}

// the float64 build of both steps (double operands, outputs and scratch)
OMC_EXPORT int omc_k6_vstep_f64(const K6ParamsT<double>* params, void* stream) {
  return vstep(*params, stream);
}

OMC_EXPORT int omc_k6_ustep_f64(const K6ParamsT<double>* params, void* stream) {
  return ustep(*params, stream);
}

// the plan's shared memory at the operands' element size (4, or 8 for the
// float64 build), held against ops.linalg.k6_plan by the smoke; on the wide
// path (2) S says whether the entries are in shared memory
OMC_EXPORT long long omc_k6_smem_bytes(int path, int k, int S, int W, int rpw, int elem) {
  if (path == 2) return wide_smem_bytes(k, S, W, rpw, elem);
  return (long long)elem * smem_floats(path, k, S, W, rpw, 16 / elem);
}
