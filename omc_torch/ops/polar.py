"""Matmul-only PSD projection via a polynomial matrix-sign iteration (port
of ``omc/ops/polar.py``).

    proj_PSD(T) = (T + sign(T) T) / 2

with ``sign(T)`` from an odd-polynomial iteration on ``Z = T / ||T||_F``:
12 greedy-minimax quintic steps then 2 cubic Newton-Schulz polish steps
(the same ``_SIGN_SCHEDULE`` as ``omc``; 43 matmuls in series).  Every
eigenvalue with ``|lambda| / ||T||_F >= 1e-6`` is sent to ``+-1`` within
float32 rounding; smaller eigenvalues contribute at most ~2 |lambda|
relative error to the projection.  Certification does not depend on it:
the safe dual bound re-projects the multipliers exactly in float64 on the
host (``omc_torch/sdp/relax.py``).

The matmuls must be float32-accurate: one-pass TF32 products floor the
ADMM accuracy at ~1e-2 (K1's 3xTF32 products, below, are float32-grade).

``project_psd_ns_multi`` is the wrapper of kernel K1
(``omc_torch/csrc/k1_psd_sign.cu``): one call projects the three PSD
blocks of every node slot and can fuse the ADMM u-update and the dual EMA
into its epilogue.  K1 spreads each matrix's chain over several SMs: a
thread-block cluster per matrix while the working matrices fit in the
cluster's shared memory, else one launch per product over all matrices'
tiles (``k1_plan`` picks the path).  Its products are 3xTF32 tensor-core
products of exactly symmetric matrices: ``symmetric_matmul`` of
``tf32x3_matmul`` is their CPU mirror.  On a CPU tensor the wrapper runs the
plain ``project_psd_ns_merged`` with the same epilogue.

``project_psd_small`` is kernel K7 (``omc_torch/csrc/k7_minor_psd.cu``) on
batches of 5x5 matrices (the Shor minor slots), one thread per matrix;
its plain version is ``project_psd_ns_small``, and
``project_psd_ns`` with ``symmetric_matmul()`` mirrors its products (the
upper triangles of symmetric matrices).
"""

from __future__ import annotations

import numpy as np
import torch

from omc_torch import kernels

# (a, b, c) per step; derived for l0 = 1e-6 (see omc/ops/polar.py).
_SIGN_SCHEDULE = np.array([
    (3.521451, -7.154590, 3.634029),
    (3.406982, -6.751032, 4.344051),
    (4.115155, -11.482394, 8.367240),
    (3.562198, -7.405884, 3.849440),
    (3.811135, -9.095166, 5.427381),
    (4.202972, -12.190019, 8.987046),
    (4.176513, -11.973807, 8.797295),
    (4.110213, -12.007850, 8.897637),
    (4.062958, -11.075007, 8.012057),
    (3.454039, -6.995438, 4.470346),
    (2.364441, -2.438842, 1.074450),
    (2.135440, -1.778817, 0.643428),
    (1.5, -0.5, 0.0),  # cubic NS polish
    (1.5, -0.5, 0.0),
])


def matrix_sign_poly(Z, schedule=None, matmul=torch.matmul):
    """Polynomial matrix-sign of symmetric ``Z`` with spectrum in [-1, 1]:
    each step is ``a S + S (b S^2 + c S^4)`` (3 matmuls; cubic steps with
    c = 0 skip the S^4 product).  ``matmul`` computes every product (the
    tolerance controls pass a degraded one)."""
    sched = _SIGN_SCHEDULE if schedule is None else schedule
    S = Z
    for a, b, c in np.asarray(sched):
        S2 = matmul(S, S)
        if c == 0.0:
            S = float(a) * S + float(b) * matmul(S, S2)
        else:
            S4 = matmul(S2, S2)
            S = float(a) * S + matmul(S, float(b) * S2 + float(c) * S4)
    return S


def project_psd_ns(T, schedule=None, matmul=torch.matmul):
    """Project symmetric (..., d, d) matrices onto the PSD cone with the
    sign schedule (matmuls only)."""
    T = 0.5 * (T + T.transpose(-1, -2))
    s = torch.sqrt(torch.sum(T * T, dim=(-2, -1), keepdim=True)) + 1e-30
    S = matrix_sign_poly(T / s, schedule, matmul)
    P = 0.5 * (T + matmul(S, T))
    return 0.5 * (P + P.transpose(-1, -2))


def truncated_matmul(bits: int):
    """A float32 product of operands truncated to ``bits`` mantissa bits
    (float32 keeps 23, TF32 10): a deliberately degraded product, the
    control of the sign schedule's float32 tolerances."""
    keep = ~((1 << (23 - bits)) - 1)

    def cut(x):
        return (x.contiguous().view(torch.int32) & keep).view(torch.float32)

    def matmul(a, b):
        return torch.matmul(cut(a), cut(b))

    return matmul


def _tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds it (sign-magnitude bits, so adding
    half an ulp to the magnitude's bits and cutting rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def tf32x3_matmul(a, b):
    """The float32 product K1 forms on the tensor cores (3xTF32): each
    operand splits into ``big = tf32(x)`` and ``small = tf32(x - big)``
    (round to nearest), and ``big.big + big.small + small.big`` is summed in
    float32 (``small.small`` is below float32 rounding)."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    asm, bsm = _tf32_rna(a - ab), _tf32_rna(b - bb)
    return torch.matmul(asm, bb) + torch.matmul(ab, bsm) + torch.matmul(ab, bb)


def symmetric_matmul(matmul=torch.matmul):
    """The product of two commuting symmetric matrices as K1 forms it:
    ``C = A B^T`` (rows of both operands) for the upper triangle only,
    mirrored to the lower, so every product of the chain is exactly
    symmetric."""

    def mm(a, b):
        c = matmul(a, b.transpose(-1, -2))
        return torch.triu(c) + torch.triu(c, 1).transpose(-1, -2)

    return mm


def project_psd_ns_merged(mats):
    """Project several batches of symmetric matrices of different sizes in
    one padded sign-schedule run: each (B, d_i, d_i) batch is zero-embedded
    into (B, G, D, D) with D = max d_i (``proj(blockdiag(T, 0)) =
    blockdiag(proj(T), 0)``, so padding is exact)."""
    B = mats[0].shape[0]
    D = max(t.shape[-1] for t in mats)
    G = len(mats)
    Tm = torch.zeros((B, G, D, D), dtype=mats[0].dtype, device=mats[0].device)
    for g, t in enumerate(mats):
        d = t.shape[-1]
        Tm[:, g, :d, :d] = t
    P = project_psd_ns(Tm.reshape(B * G, D, D)).reshape(B, G, D, D)
    return [P[:, g, : t.shape[-1], : t.shape[-1]] for g, t in enumerate(mats)]


def psd_epilogue(ts, ws, w_out=None, u_out=None, acc=None, rho=None, beta=0.0):
    """The ADMM w/u-update and dual EMA that K1 fuses into its epilogue:
    ``w_out[g] = ws[g]``, ``u_out[g] = ts[g] - ws[g]`` and
    ``acc[g] += beta (rho u - acc[g])`` for every ``acc[g]`` given.
    Returns the list of w (``w_out`` where given)."""
    outs = []
    for g, (t, w) in enumerate(zip(ts, ws)):
        if w_out is not None:
            w_out[g].copy_(w)
            w = w_out[g]
        outs.append(w)
        if u_out is None:
            continue
        u_out[g].copy_(t - w)
        if acc is not None and acc[g] is not None:
            a = acc[g]
            a.copy_(a + beta * (rho[:, None, None] * u_out[g] - a))
    return outs


# K1's geometry (omc_torch/csrc/k1_psd_sign.cu): 16-row strips, 64 x 64
# tiles on the tiles path, and the H100's limits it is planned against
K1_STRIP, K1_TILE, K1_RED = 16, 64, 32
K1_SMEM_MAX = 232448   # bytes of shared memory one CTA may use
K1_CLUSTER_MAX = 8     # the portable cluster size
H100_SMS = 132
K1_CLUSTER_MATRICES = 32  # matrices per call from which clusters > 2 lose


def _round_up(x, r):
    return -(-x // r) * r


def k1_row_stride(dp):
    """Row stride (floats) of K1's (dp x dp) working matrices: 16 more than
    a multiple of 32, so the kernel's float4 fragment loads are free of bank
    conflicts."""
    return dp if dp % 32 == 16 else dp + 16


def k1_cluster_smem(dims, C):
    """Bytes of shared memory per CTA of K1's cluster path with clusters of
    ``C`` CTAs: each CTA holds its strips of the four working matrices."""
    per = []
    for d in dims:
        dp = _round_up(d, K1_STRIP)
        strips = -(-(dp // K1_STRIP) // C)
        per.append(4 * strips * K1_STRIP * k1_row_stride(dp))
    return 4 * (K1_RED + max(per))


def k1_plan(dims, B, cluster=None):
    """K1's path for blocks of sizes ``dims`` at batch ``B``.

    The cluster path needs the four working matrices of the largest block
    to fit in the shared memory of a cluster of at most 8 CTAs.  Its cluster
    size is the smallest power of two that fits and gives two CTAs per SM
    (``B * len(dims) * C >= 264``), or 8.  Clusters of more than 2 CTAs read
    most operands from their peers' shared memory, which loses to clusters
    of 2 and to the tiles path once ``K1_CLUSTER_MATRICES`` matrices or more
    share the card (H100 measurements in PERF.md); they serve the small
    batches, where the chain's latency is the time.  From that many matrices
    on the cluster is capped at 2 CTAs where the blocks fit.  Otherwise the
    tiles path runs, with a global workspace of ``scratch_floats[g]`` floats
    per block (``omc_k1_scratch_floats`` in the kernel's source; the launch
    refuses a smaller one).  ``cluster`` forces
    the cluster size, 0 the tiles path (timing sweeps).  Returns a dict:
    ``path`` ("cluster" or "tiles"), ``cluster`` (0 on the tiles path),
    ``smem`` (bytes per CTA) and ``scratch_floats``."""
    G = len(dims)
    if cluster is None:
        C = 1
        while C < K1_CLUSTER_MAX and k1_cluster_smem(dims, C) > K1_SMEM_MAX:
            C *= 2
        while C < K1_CLUSTER_MAX and B * G * C < 2 * H100_SMS:
            C *= 2
        if C > 2 and B * G >= K1_CLUSTER_MATRICES:
            C = 2 if k1_cluster_smem(dims, 2) <= K1_SMEM_MAX else 0
    else:
        C = int(cluster)
        if C not in (0, 1, 2, 4, 8):
            raise ValueError(f"K1 cluster size must be 0, 1, 2, 4 or 8, got {cluster}")
    if C and k1_cluster_smem(dims, C) <= K1_SMEM_MAX:
        return dict(path="cluster", cluster=C, smem=k1_cluster_smem(dims, C),
                    scratch_floats=[0] * G)
    if C and cluster is not None:
        raise ValueError(f"K1: blocks {list(dims)} do not fit clusters of {C} CTAs")
    scratch = []
    for d in dims:
        dp = _round_up(d, K1_STRIP)
        scratch.append(B * 4 * dp * k1_row_stride(dp) + B * -(-dp // K1_TILE))
    return dict(path="tiles", cluster=0, smem=0, scratch_floats=scratch)


def project_psd_ns_multi(ts, *, w_out=None, u_out=None, acc=None, rho=None,
                         beta=0.0, cluster=None):
    """K1: PSD-project every (B, d_g, d_g) batch in ``ts`` with the sign
    schedule on the GPU (one launch on the cluster path, one per product on
    the tiles path; ``k1_plan``).

    ``w_out`` (optional): tensors receiving the projections.  With
    ``u_out`` the ADMM scaled duals ``u = t - w`` are written too, and for
    each non-None ``acc[g]`` the dual EMA ``acc += beta (rho u - acc)`` is
    updated (``rho`` (B,) per-slot penalties).  Returns the projections.
    ``cluster`` forces the cluster size (timing sweeps).

    A CPU tensor runs the plain ``project_psd_ns_merged`` and
    ``psd_epilogue``; a CUDA tensor runs the kernel or raises."""
    dev = ts[0].device
    if dev.type == "cpu":
        return psd_epilogue(ts, project_psd_ns_merged(ts), w_out, u_out, acc,
                            rho, beta)
    if dev.type != "cuda":
        raise ValueError(f"project_psd_ns_multi: unsupported device {dev}")
    G = len(ts)
    if not 1 <= G <= 3:
        raise ValueError(f"K1 takes 1 to 3 blocks, got {G}")
    if acc is not None and u_out is None:
        raise ValueError("the dual EMA needs u_out")
    if w_out is None:
        w_out = [torch.empty_like(t) for t in ts]
    B = ts[0].shape[0]
    plan = k1_plan([t.shape[-1] for t in ts], B, cluster)
    p = kernels.K1Params()
    p.G, p.B, p.beta = G, B, float(beta)
    p.C = plan["cluster"]
    workspace = []  # held until the launch is queued
    for g, t in enumerate(ts):
        d = t.shape[-1]
        shape = (B, d, d)
        p.t[g] = kernels.check(f"t[{g}]", t, shape, dev)
        p.w[g] = kernels.check(f"w_out[{g}]", w_out[g], shape, dev)
        p.u[g] = kernels.check(f"u_out[{g}]", u_out[g], shape, dev) if u_out is not None else None
        a = acc[g] if acc is not None else None
        p.acc[g] = kernels.check(f"acc[{g}]", a, shape, dev) if a is not None else None
        p.D[g] = d
        p.scratch[g] = None
        p.scratch_floats[g] = plan["scratch_floats"][g]
        if plan["scratch_floats"][g]:
            # once freed, the caching allocator reuses the workspace only for
            # work queued after these launches on the same stream
            workspace.append(torch.empty(plan["scratch_floats"][g], dtype=torch.float32,
                                         device=dev))
            p.scratch[g] = workspace[-1].data_ptr()
    if acc is not None and any(a is not None for a in acc):
        p.rho = kernels.check("rho", rho, (B,), dev)
    kernels.launch("K1", "omc_k1_psd_sign", p, dev)
    return w_out


def _mm_lanes(X, Y):
    """(d, d, N) x (d, d, N) products with the batch along the last axis:
    a broadcast multiply and a reduction, as omc runs them."""
    return torch.sum(X[:, :, None, :] * Y[None, :, :, :], dim=1)


def project_psd_ns_small(T):
    """PSD projection of large batches of tiny symmetric (..., d, d)
    matrices (the (B, M5, 5, 5) Shor minor slots) with the sign schedule,
    the batch laid along the last axis as in ``omc`` (plain version of
    K7)."""
    T = 0.5 * (T + T.transpose(-1, -2))
    shape = T.shape
    d = shape[-1]
    Tb = T.reshape(-1, d, d).permute(1, 2, 0)  # (d, d, N)
    s = torch.sqrt(torch.sum(Tb * Tb, dim=(0, 1), keepdim=True)) + 1e-30
    S = Tb / s
    for a, b, c in np.asarray(_SIGN_SCHEDULE):
        S2 = _mm_lanes(S, S)
        if c == 0.0:
            S = float(a) * S + float(b) * _mm_lanes(S, S2)
        else:
            S = float(a) * S + _mm_lanes(S, float(b) * S2 + float(c) * _mm_lanes(S2, S2))
    P = 0.5 * (Tb + _mm_lanes(S, Tb))
    P = 0.5 * (P + P.transpose(0, 1))
    return P.permute(2, 0, 1).reshape(shape)


def project_psd_small(T, w_out=None):
    """K7 in its projection mode: the sign-schedule PSD projection of a
    (..., 5, 5) batch, one thread per matrix on the GPU.  A CPU tensor runs the plain
    ``project_psd_ns_small``; a CUDA tensor runs the kernel or raises.  The
    kernel's order of work (the upper triangles of symmetric products) has
    the CPU mirror ``project_psd_ns(T, matmul=symmetric_matmul())``."""
    dev = T.device
    if dev.type == "cpu":
        P = project_psd_ns_small(T)
        return P if w_out is None else w_out.copy_(P)
    if dev.type != "cuda":
        raise ValueError(f"project_psd_small: unsupported device {dev}")
    if T.shape[-2:] != (5, 5):
        raise ValueError(f"K7 takes 5x5 matrices, got {tuple(T.shape)}")
    if w_out is None:
        w_out = torch.empty_like(T)
    p = kernels.K7Params()
    p.t = kernels.check("t", T, T.shape, dev)
    p.w = kernels.check("w_out", w_out, T.shape, dev)
    p.N = T.numel() // 25
    kernels.launch("K7", "omc_k7_minor_psd", p, dev)
    return w_out


def project_psd_xwh(T, w_out=None):
    """K7x in its projection mode: the sign-schedule PSD projection of a
    (..., d, d) batch with d >= 3 (the rank-k Shor XWH slots are (k+1) x
    (k+1)).  At d <= 5 one thread per matrix on the GPU, a CTA's 128
    matrices staged through shared memory as 16-byte words; at d > 5 K7x's
    wide kernel, a warp per matrix (``sdp.shor_k.k7x_plan``, counted as
    "K7xw").  A CPU tensor runs the plain ``project_psd_ns_small``; a CUDA
    tensor runs the kernel or raises (also, on the register kernel, on
    storage that does not start 16-byte aligned).  Both kernels' order of
    work (the upper triangles of symmetric products) has the CPU mirror
    ``project_psd_ns(T, matmul=symmetric_matmul())``."""
    dev = T.device
    if dev.type == "cpu":
        P = project_psd_ns_small(T)
        return P if w_out is None else w_out.copy_(P)
    if dev.type != "cuda":
        raise ValueError(f"project_psd_xwh: unsupported device {dev}")
    d = T.shape[-1]
    if T.ndim < 2 or T.shape[-2] != d or d < 3:
        raise ValueError(f"K7x takes d x d matrices with d >= 3, got {tuple(T.shape)}")
    from omc_torch.sdp.shor_k import k7x_block, k7x_plan

    N = T.numel() // (d * d)
    p = k7x_block(k7x_plan(N, d), N, d, torch.float32, dev)
    if w_out is None:
        w_out = torch.empty_like(T)
    p.t = kernels.check("t", T, T.shape, dev)
    p.w = kernels.check("w_out", w_out, T.shape, dev)
    if not p.wide and (p.t % 16 or p.w % 16):
        raise ValueError("K7x stages t and w_out as 16-byte words: their storage must start "
                         "16-byte aligned")
    p.N, p.k = N, d - 1
    kernels.launch("K7xw" if p.wide else "K7x",
                   "omc_k7x_xwh_wide" if p.wide else "omc_k7x_xwh", p, dev)
    return w_out
