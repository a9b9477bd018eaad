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
// Algorithm: cyclic two-sided Jacobi in parallel (round-robin) order, the
// schedule of the CPU mirror omc_torch/ops/jacobi.py: a sweep is N - 1
// rounds over N = d players (d + 1 for odd d: the extra one is a bye, never
// a zero row, which would add an eigenvalue 0 to "the k smallest"); the
// N / 2 pairs of a round are disjoint and rotate together.  One CTA per
// matrix: a round computes every pair's rotation (one thread per pair),
// then applies A <- J' A J as independent 2x2 blocks (block (a, b) owns rows
// {p_a, q_a} x columns {p_b, q_b}; one thread computes it and writes its
// transpose, so A stays exactly symmetric) and V <- V J.  The stopping rule
// and rotation are omc::jacobi_rotation (common.cuh).  Epilogues: mode 0
// eigenvalues ascending (G_Y, G_Theta, R1: no V at all), mode 1 the PSD
// projection V max(w, 0) V' (S1, S2), mode 2 the nout smallest eigenpairs
// (K5: nout = 2; the smoke checks nout = d).
//
// What bounds it on the H100: the chain of ~10 sweeps x (d - 1) rounds per
// matrix, two barriers a round, each round ~d^2 / 2 rotated entries of A
// and d^2 / 2 of V (9 d^3 flops a sweep with vectors, 4 d^3 / 3 counted as
// the bound's eigendecomposition).  The batch's matrices run side by side,
// one per SM.  A and V stay in shared memory while they fit (d <= 168 with
// vectors, d <= 237 without); beyond that they live in a per-matrix global
// workspace (config 2's d = 200 S1: V there, A in shared memory; d = 500:
// both), where L2 serves the rounds.  Full fp32 on CUDA cores throughout.
#include "common.cuh"

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

struct Place {
  bool a_smem, v_smem;
  size_t smem_bytes, work_floats;
};

__host__ inline Place place(int d, int mode) {
  const size_t mat = (size_t)d * ld_of(d), head = head_floats(d);
  const bool vec = mode != 0;
  Place pl;
  if ((head + mat * (vec ? 2 : 1)) * sizeof(float) <= kSmemBytes) {
    pl = {true, vec, (head + mat * (vec ? 2 : 1)) * sizeof(float), 0};
  } else if ((head + mat) * sizeof(float) <= kSmemBytes) {
    pl = {true, false, (head + mat) * sizeof(float), vec ? mat : 0};
  } else {
    pl = {false, false, head * sizeof(float), mat * (vec ? 2 : 1)};
  }
  return pl;
}

// kSep: K5 (A = sym(U U' - Y)); a template argument so that a profile
// tells the two apart
template <bool kSep>
__global__ void __launch_bounds__(512) k4_kernel(K4Params p, int a_smem, int v_smem,
                                                 size_t work_floats) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, d = p.d, ld = ld_of(d);
  const int P = (d + 1) / 2, N = 2 * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* pt = smem;
  float* ps = pt + P;
  float* pr = ps + P;
  int* pp = reinterpret_cast<int*>(pr + P);
  int* pq = pp + P;
  int* prot = pq + P;
  float* red = reinterpret_cast<float*>(prot + P);
  float* wd = red + 32;   // diagonal at the end
  float* wp = wd + d;     // sorted eigenvalues, clamped at 0 (mode 1)
  int* order = reinterpret_cast<int*>(wp + d);
  int* first = order + d;
  float* base = reinterpret_cast<float*>(first + 1);
  float* work = p.work ? p.work + (size_t)b * work_floats : nullptr;
  const size_t mat = (size_t)d * ld;
  float* A = a_smem ? base : work;
  float* V = nullptr;
  if (p.mode != 0) V = v_smem ? base + mat : (a_smem ? work : work + mat);

  // ---- load: A = sym(M), or sym(U U' - Y); V = I ----
  float ss = 0.f;
  if (!kSep) {
    const float* Mb = p.M + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      const float v = 0.5f * (Mb[i * d + j] + Mb[j * d + i]);
      A[i * ld + j] = v;
      ss += v * v;
    }
  } else {
    const float* Ub = p.U + (size_t)b * d * p.k;
    const float* Yb = p.Y + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      float uu = 0.f;
      for (int l = 0; l < p.k; ++l) uu = fmaf(Ub[i * p.k + l], Ub[j * p.k + l], uu);
      const float v = uu - 0.5f * (Yb[i * d + j] + Yb[j * d + i]);
      A[i * ld + j] = v;
      ss += v * v;
    }
  }
  if (V)
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      V[i * ld + j] = i == j ? 1.f : 0.f;
    }
  const float normF = sqrtf(omc::block_sum(ss, red));  // (contains barriers)
  const float floor_ = omc::jacobi_floor(normF, d);

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
        float t = 0.f, s = 0.f, rr = 0.f;
        int rot = 0;
        if (qi < d) {
          rot = omc::jacobi_rotation(A[pi * ld + pi], A[qi * ld + qi], A[pi * ld + qi],
                                     floor_, t, s, rr);
        } else {
          qi = -1;  // the bye
        }
        pt[a] = rot ? t : 0.f;
        ps[a] = rot ? s : 0.f;
        pr[a] = rot ? rr : 0.f;
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
          const float t = pt[a], apq = A[pa * ld + qa];
          A[pa * ld + pa] -= t * apq;
          A[qa * ld + qa] += t * apq;
          A[pa * ld + qa] = 0.f;
          A[qa * ld + pa] = 0.f;
          continue;
        }
        const int pc = pp[c], qc = pq[c];
        float x00 = A[pa * ld + pc];
        float x01 = qc >= 0 ? A[pa * ld + qc] : 0.f;
        float x10 = qa >= 0 ? A[qa * ld + pc] : 0.f;
        float x11 = (qa >= 0 && qc >= 0) ? A[qa * ld + qc] : 0.f;
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
    const float ki = isnan(wd[i]) ? __int_as_float(0x7f800000) : wd[i];
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const float kj = isnan(wd[j]) ? __int_as_float(0x7f800000) : wd[j];
      rank += (kj < ki) || (kj == ki && j < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  const bool bad = !isfinite(normF);  // a non-finite input gives NaN out
  const float qnan = __int_as_float(0x7fffffff);
  if (tid == 0) p.sweeps[b] = sweep;

  if (p.mode == 1) {
    // P = V max(w, 0) V' over the positive (and NaN) eigenvalues, which the
    // sort put last
    for (int r = tid; r < d; r += nt) {
      const float w = wd[order[r]];
      wp[r] = bad ? qnan : (w > 0.f ? w : (isnan(w) ? w : 0.f));
    }
    __syncthreads();
    if (tid == 0) {
      int f = d;
      while (f > 0 && wp[f - 1] != 0.f) --f;
      *first = f;
    }
    __syncthreads();
    const int f = *first;
    float* Pb = p.P + (size_t)b * d * d;
    for (int e = tid; e < d * d; e += nt) {
      const int i = e / d, j = e - i * d;
      if (j < i) continue;
      float acc = 0.f;
      for (int r = f; r < d; ++r) {
        const int o = order[r];
        acc = fmaf(V[i * ld + o] * wp[r], V[j * ld + o], acc);
      }
      Pb[i * d + j] = acc;
      Pb[j * d + i] = acc;
    }
    return;
  }
  const int nout = p.nout;
  for (int r = tid; r < nout; r += nt) p.w[(size_t)b * nout + r] = bad ? qnan : wd[order[r]];
  if (p.mode == 2) {
    float* Vb = p.V + (size_t)b * d * nout;
    for (int e = tid; e < d * nout; e += nt) {
      const int i = e / nout, r = e - i * nout;
      Vb[e] = bad ? qnan : V[i * ld + order[r]];
    }
  }
}

template <bool kSep>
int launch_k4(const K4Params& p, const Place& pl, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      k4_kernel<kSep>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = p.d <= 32 ? 128 : (p.d <= 64 ? 256 : 512);
  k4_kernel<kSep><<<p.B, threads, pl.smem_bytes, (cudaStream_t)stream>>>(
      p, pl.a_smem, pl.v_smem, pl.work_floats);
  return (int)cudaGetLastError();
}

}  // namespace

OMC_EXPORT long long omc_k4_workspace_floats(int d, int mode) {
  return (long long)place(d, mode).work_floats;
}

OMC_EXPORT int omc_k4_jacobi(const K4Params* params, void* stream) {
  const K4Params p = *params;
  const Place pl = place(p.d, p.mode);
  return p.M ? launch_k4<false>(p, pl, stream) : launch_k4<true>(p, pl, stream);
}
