"""Batched ADMM solver for the McCormick-path node relaxation (port of
``omc/sdp/mccormick.py``; see that module's docstring for the relaxation
and the certification argument).

The relaxation (``use_disjunctive_cuts=False``, reference
`src/OptimalMatrixCompletion.jl:1686-1753`) is the core conic model plus
lifted bilinear variables ``t[i, p] ~ U[i, j1] U[i, j2]`` for the q =
k(k+1)/2 pairs p = (j1 <= j2), four McCormick envelope rows per (i, p) from
the node's U box, and the orthogonality rows ``sum_i t[i, p] = delta_p``.

The z-step is block separable: X, Theta diagonal; Y is ``3 I + vec(I)
vec(I)'`` (through the trace); (U, t) is block diagonal over the n rows —
a (k+q) x (k+q) Gram per row — plus a rank-q orthogonality correction.  The
row Grams and the q x q Woodbury matrix are rho-free, so they are factored
once per solve call (K9s).

One iteration on the GPU is three kernel launches in float32
(``csrc/k9_mccormick.cu`` and ``csrc/k1_psd_sign.cu``):

1. K9a ``mc_zstep``     — the adjoint of the eight slot residuals (the
   McCormick duals scattered from pairs to coordinates), the X/Theta
   divides, the Y solve through its trace, per-row triangular solves with
   the row factors, the orthogonality Woodbury through ``sum_i z0[i, k:]``,
   symmetrised Y and Theta;
2. K9b ``mc_cone_step`` — the forward map, over-relaxation, t1/t2/t3 for
   K1, and the w/u-step of the trace, SOC, box, envelope (>= 0) and
   orthogonality (= 0) slots, with the running dual mean of rho*umc and
   rho*uorth;
3. K1 ``project_psd_ns_multi`` — the PSD blocks (n+m)^2, (n+k)^2, n^2, with
   the running dual mean of rho*u1 and rho*u2.

In float64 (``omc``'s float64 route, ``psd_method="eigh"``) K9a and K9b
are their float64 builds and step 3 projects the three blocks exactly:
K4's float64 build (``ops.cones.project_psd``), then the torch epilogue
(``ops.polar.psd_epilogue``: u and the running means); K9s runs its
float64 build once per solve call.

The kernels take every batch, rank and width ``omc`` runs: K9a and K9b
at k <= 3 and n + m <= 4096 (their unrolled kernels, a batch's flat
entries indexed in 64 bits where they pass 2^31: 128 slots at n + m = 4096
already hold 2^31), their wide kernels elsewhere, a slot's entries too in
64 bits past n + m = 46,340.  The card's memory is the only limit: a
float32 solver call holds about 56 bytes a flat entry of the batch's
(n + m)^2 blocks, a float64 one about 104 (w1, u1, their solve-call
copies, t1, the running mean of rho u1, and K1's tiles-path workspace or
K4's; PERF.md), so on an 80 GB card a float32 batch (n + m)^2 stops near
1.5e9.

``omc`` averages rho*u over the last ``navg = max(1, iters // 4)``
iterations as a sum times 1/navg; the port keeps a running mean (the
epilogues' ``acc += beta (rho u - acc)`` with beta = 1/j on the j-th
iteration of the window), equal up to rounding.  On the CPU the same steps
run as plain torch (``mc_setup_plain``, ``mc_zstep_plain``,
``mc_cone_step_plain``, K1's plain version) in ``omc``'s order of
operations.

The host parts (feasibility screens, the envelope LP, the master check and
the float64 certificate) are numpy copies of ``omc``'s.
"""

from __future__ import annotations

import dataclasses
import math
import operator

import numpy as np
import torch

from omc_torch import kernels
from omc_torch.ops.cones import project_psd, project_soc
from omc_torch.ops.polar import H100_SMS, project_psd_ns_multi, psd_epilogue
from omc_torch.sdp.admm import _packed
from omc_torch.sdp.relax import separation_eigpairs

# ---------------------------------------------------------------------------
# Pairs, envelope coefficients, corner boxes (numpy arrays or torch tensors)
# ---------------------------------------------------------------------------


def pair_indices(k: int):
    """Upper-triangular pair index arrays (J1, J2), each (q,)."""
    pairs = [(j1, j2) for j1 in range(k) for j2 in range(j1, k)]
    J1 = np.asarray([p[0] for p in pairs], dtype=np.int32)
    J2 = np.asarray([p[1] for p in pairs], dtype=np.int32)
    return J1, J2


def _pair_cols(U_lo, U_hi, J1, J2):
    if isinstance(U_lo, torch.Tensor):
        J1 = torch.as_tensor(J1, dtype=torch.long, device=U_lo.device)
        J2 = torch.as_tensor(J2, dtype=torch.long, device=U_lo.device)
    return U_lo[..., :, J1], U_lo[..., :, J2], U_hi[..., :, J1], U_hi[..., :, J2]


def _stack(xs, axis):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, dim=axis)
    return np.stack(xs, axis=axis)


def mccormick_coeffs(U_lo, U_hi, J1, J2):
    """Per-row envelope coefficients (s, c1, c2, d), each (..., 4, n, q):
    the four rows  w_r = s_r t + c1_r U[:, j1] + c2_r U[:, j2] + d_r >= 0
    (reference lines 1688-1723)."""
    lo1, lo2, hi1, hi2 = _pair_cols(U_lo, U_hi, J1, J2)
    one = torch.ones_like(lo1) if isinstance(lo1, torch.Tensor) else np.ones_like(lo1)
    s = _stack([one, one, -one, -one], -3)
    c1 = _stack([-lo2, -hi2, hi2, lo2], -3)
    c2 = _stack([-lo1, -hi1, lo1, hi1], -3)
    d = _stack([lo1 * lo2, hi1 * hi2, -lo1 * hi2, -hi1 * lo2], -3)
    return s, c1, c2, d


def t_corner_box(U_lo, U_hi, J1, J2):
    """Valid kept-set box for t: corner products of the U box."""
    lo1, lo2, hi1, hi2 = _pair_cols(U_lo, U_hi, J1, J2)
    cands = _stack([lo1 * lo2, lo1 * hi2, hi1 * lo2, hi1 * hi2], 0)
    if isinstance(cands, torch.Tensor):
        return cands.amin(0), cands.amax(0)
    return cands.min(axis=0), cands.max(axis=0)


# ---------------------------------------------------------------------------
# Host feasibility screens and the master check (numpy, as in omc)
# ---------------------------------------------------------------------------


def mccormick_box_feasible(U_lower: np.ndarray, U_upper: np.ndarray,
                           tol: float = 0.0) -> bool:
    """Sound interval-arithmetic necessary condition for the reference's
    relaxation-feasibility model (lines 1294-1429): each orthogonality row
    must be attainable with every t[i, p] in its corner box, and the column
    SOC |U_j| <= 1 must hold at the box's point nearest 0.  False only when
    the node is certainly infeasible."""
    n, k = U_lower.shape
    J1, J2 = pair_indices(k)
    t_lo, t_hi = t_corner_box(U_lower, U_upper, J1, J2)
    delta = (J1 == J2).astype(np.float64)
    lo_sum = t_lo.sum(axis=0)
    hi_sum = t_hi.sum(axis=0)
    if np.any(lo_sum > delta + tol + 1e-12) or np.any(hi_sum < delta - tol - 1e-12):
        return False
    closest = np.clip(0.0, U_lower, U_upper)
    if np.any(np.sum(closest**2, axis=0) > 1.0 + 1e-12):
        return False
    return True


def mccormick_lp_feasible(U_lower: np.ndarray, U_upper: np.ndarray,
                          max_soc_rounds: int = 6) -> bool:
    """Exact feasibility of the reference's relaxation-feasibility model
    (lines 1294-1429) with the column SOCs by Kelley outer approximation:
    HiGHS solves the envelope LP (variables [U (n*k) | t (n*q)]: the four
    envelope rows per (i, p), the orthogonality equalities, the t corner
    box), every violated column norm adds the supporting cut
    ``(U_j*/|U_j*|)' U_j <= 1``, up to ``max_soc_rounds`` rounds.  An
    infeasible LP is a sound certificate; solver trouble or exhausted rounds
    return True (the sound direction)."""
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    U_lower = np.asarray(U_lower, np.float64)
    U_upper = np.asarray(U_upper, np.float64)
    n, k = U_lower.shape
    J1, J2 = pair_indices(k)
    q = len(J1)
    s, c1, c2, d = mccormick_coeffs(U_lower, U_upper, J1, J2)
    nv = n * k + n * q
    rows, cols, vals = [], [], []
    rhs = []
    r = 0
    for rr in range(4):  # four envelope rows, as -w_r <= 0
        for p in range(q):
            for i in range(n):
                rows += [r, r, r]
                cols += [n * k + p * n + i, i * k + int(J1[p]), i * k + int(J2[p])]
                vals += [-s[rr, i, p], -c1[rr, i, p], -c2[rr, i, p]]
                rhs.append(d[rr, i, p])
                r += 1
    b_ub = list(rhs)
    rows_e, cols_e, vals_e = [], [], []
    for p in range(q):
        for i in range(n):
            rows_e.append(p)
            cols_e.append(n * k + p * n + i)
            vals_e.append(1.0)
    A_eq = coo_matrix((vals_e, (rows_e, cols_e)), shape=(q, nv))
    b_eq = (J1 == J2).astype(np.float64)
    t_lo, t_hi = t_corner_box(U_lower, U_upper, J1, J2)
    bounds = [
        (U_lower[i, j], U_upper[i, j]) for i in range(n) for j in range(k)
    ] + [
        (t_lo[i, p] - 1e-9, t_hi[i, p] + 1e-9) for p in range(q) for i in range(n)
    ]
    cost = np.zeros(nv)
    for _ in range(max(0, max_soc_rounds) + 1):
        A_ub = coo_matrix((vals, (rows, cols)), shape=(r, nv))
        res = linprog(cost, A_ub=A_ub, b_ub=np.asarray(b_ub), A_eq=A_eq, b_eq=b_eq,
                      bounds=bounds, method="highs")
        if res.status == 2:  # infeasible: sound certificate
            return False
        if res.x is None:
            return True  # solver trouble: fail open
        U_star = np.asarray(res.x[: n * k]).reshape(n, k)
        norms = np.sqrt(np.sum(U_star * U_star, axis=0))
        viol = np.where(norms > 1.0 + 1e-7)[0]
        if viol.size == 0:
            return True
        for j in viol:  # supporting-hyperplane cut g' U_j <= 1
            g = U_star[:, j] / norms[j]
            for i in range(n):
                rows.append(r)
                cols.append(i * k + int(j))
                vals.append(g[i])
            b_ub.append(1.0)
            r += 1
    return True


def master_feasible_mccormick(Y, U, X, Th, *, orthogonality_tolerance=0.0,
                              projection_tolerance=1e-6,
                              lifted_variable_tolerance=1e-6) -> bool:
    """Host float64 master-feasibility check, McCormick branch of the
    reference's ``matrix_completion_master_feasible`` (lines 1278-1291).
    |U'U - I| <= tolerance + 1e-12 is never met by a float32 iterate (as in
    ``omc``; ROADMAP section 3)."""
    Y = np.asarray(Y, np.float64)
    U = np.asarray(U, np.float64)
    X = np.asarray(X, np.float64)
    Th = np.asarray(Th, np.float64)
    k = U.shape[1]
    if not np.all(np.abs(U.T @ U - np.eye(k)) <= orthogonality_tolerance + 1e-12):
        return False
    if np.trace(Y) > k + 1e-12:
        return False
    M = 0.5 * ((Y - U @ U.T) + (Y - U @ U.T).T)
    if np.linalg.eigvalsh(M)[0] < -projection_tolerance:
        return False
    M1 = np.block([[Y, X], [X.T, Th]])
    M1 = 0.5 * (M1 + M1.T)
    if np.linalg.eigvalsh(M1)[0] < -lifted_variable_tolerance:
        return False
    return True


# ---------------------------------------------------------------------------
# Batch, state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MCBatch:
    """Per-node data for the McCormick relaxation: the U box, (B, n, k)."""

    U_lo: object
    U_hi: object

    def fields(self) -> list:
        return [self.U_lo, self.U_hi]

    def map(self, fn) -> "MCBatch":
        return MCBatch(fn(self.U_lo), fn(self.U_hi))


@dataclasses.dataclass
class MCState:
    # cone-slot variables w, scaled duals u, last primal iterate; field
    # order matches omc.sdp.mccormick.MCState (warm slices, convert)
    w1: torch.Tensor  # (B, n+m, n+m)
    w2: torch.Tensor  # (B, n+k, n+k)
    w3: torch.Tensor  # (B, n, n)
    w4: torch.Tensor  # (B,)
    wsoc: torch.Tensor  # (B, k, 1+n)
    wbox: torch.Tensor  # (B, n, k)
    wmc: torch.Tensor  # (B, 4, n, q)
    worth: torch.Tensor  # (B, q)
    u1: torch.Tensor
    u2: torch.Tensor
    u3: torch.Tensor
    u4: torch.Tensor
    usoc: torch.Tensor
    ubox: torch.Tensor
    umc: torch.Tensor
    uorth: torch.Tensor
    X: torch.Tensor  # (B, n, m) scaled
    Y: torch.Tensor  # (B, n, n)
    Th: torch.Tensor  # (B, m, m) scaled
    U: torch.Tensor  # (B, n, k)
    t: torch.Tensor  # (B, n, q)
    rho: torch.Tensor  # (B,)
    sX: torch.Tensor  # (B,)
    sT: torch.Tensor  # (B,)

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "MCState":
        return cls(*leaves)

    def clone(self) -> "MCState":
        return MCState(*[
            x.clone(memory_format=torch.contiguous_format) for x in self.leaves()
        ])

    def replace(self, **kw) -> "MCState":
        return dataclasses.replace(self, **kw)


def init_mc_state(B, n, m, k, dtype=torch.float32, *, device, sX=1.0, sT=1.0,
                  X0=None, Y0=None, Th0=None, U0=None, rho: float = 0.02) -> MCState:
    q = k * (k + 1) // 2

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=device).expand(B).clone()

    def prim(val, shape, scale):
        if val is None:
            return z(*shape)
        s = torch.as_tensor(scale, dtype=dtype, device=device)
        if s.ndim:  # (B,) per-slot scales -> (B, 1, ..., 1)
            s = s.reshape(tuple(s.shape) + (1,) * (len(shape) - s.ndim))
        v = torch.as_tensor(val, dtype=dtype, device=device)
        return torch.broadcast_to(v / s, shape).clone()

    return MCState(
        w1=z(B, n + m, n + m), w2=z(B, n + k, n + k), w3=z(B, n, n), w4=z(B),
        wsoc=z(B, k, 1 + n), wbox=z(B, n, k), wmc=z(B, 4, n, q), worth=z(B, q),
        u1=z(B, n + m, n + m), u2=z(B, n + k, n + k), u3=z(B, n, n), u4=z(B),
        usoc=z(B, k, 1 + n), ubox=z(B, n, k), umc=z(B, 4, n, q), uorth=z(B, q),
        X=prim(X0, (B, n, m), sX), Y=prim(Y0, (B, n, n), 1.0),
        Th=prim(Th0, (B, m, m), sT), U=prim(U0, (B, n, k), 1.0),
        t=z(B, n, q), rho=torch.full((B,), rho, dtype=dtype, device=device),
        sX=vec(sX), sT=vec(sT),
    )


# ---------------------------------------------------------------------------
# Operators (plain torch, omc's order of operations)
# ---------------------------------------------------------------------------


def _mc_forward(coef, J1, J2, delta, Xs, Y, Ths, U, t, k, sX, sT):
    s, c1, c2, d = coef
    X = sX * Xs
    Th = sT * Ths
    Xt = X.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    n = Y.shape[-1]
    w1 = torch.cat([torch.cat([Y, X], dim=-1), torch.cat([Xt, Th], dim=-1)], dim=-2)
    eye_k = torch.eye(k, dtype=U.dtype, device=U.device)
    w2 = torch.cat(
        [
            torch.cat([Y, U], dim=-1),
            torch.cat([Ut, torch.broadcast_to(eye_k, Ut.shape[:-2] + (k, k))], dim=-1),
        ],
        dim=-2,
    )
    w3 = torch.eye(n, dtype=Y.dtype, device=Y.device) - Y
    w4 = k - torch.diagonal(Y, dim1=-2, dim2=-1).sum(-1)
    ones = torch.ones(U.shape[:-2] + (k, 1), dtype=U.dtype, device=U.device)
    wsoc = torch.cat([ones, Ut], dim=-1)
    wbox = U
    U1 = U[..., :, J1]  # (B, n, q)
    U2 = U[..., :, J2]
    wmc = s * t[..., None, :, :] + c1 * U1[..., None, :, :] + c2 * U2[..., None, :, :] + d
    worth = torch.sum(t, dim=-2) - delta  # (B, q); equality slot value is 0
    return w1, w2, w3, w4, wsoc, wbox, wmc, worth


def _mc_adjoint(coef, y1, y2, y3, y4, ysoc, ybox, ymc, yorth, n, m, k, sX, sT,
                seg_j1, seg_j2):
    """Adjoint: duals -> gradients on (Xs, Y, Ths, U, t)."""
    s, c1, c2, d = coef
    gX = sX * 2.0 * y1[..., :n, n:]
    gY = (
        y1[..., :n, :n]
        + y2[..., :n, :n]
        - y3
        - y4[..., None, None] * torch.eye(n, dtype=y3.dtype, device=y3.device)
    )
    gTh = sT * y1[..., n:, n:]
    gU = 2.0 * y2[..., :n, n:] + ysoc[..., 1:].transpose(-1, -2) + ybox
    mc1 = torch.sum(ymc * c1, dim=-3)  # (B, n, q) coefficient on U[:, J1]
    mc2 = torch.sum(ymc * c2, dim=-3)
    gU = gU + torch.einsum("bnq,qk->bnk", mc1, seg_j1)
    gU = gU + torch.einsum("bnq,qk->bnk", mc2, seg_j2)
    gt = torch.sum(ymc * s, dim=-3) + yorth[..., None, :]
    return gX, gY, gTh, gU, gt


@dataclasses.dataclass
class _MCConsts:
    """Per-solve-call constants shared by the three steps."""

    batch: MCBatch
    mask: torch.Tensor
    maskA: torch.Tensor
    Mc: torch.Tensor  # (B, n, k+q, k+q) lower Cholesky factors of the row Grams
    Si: torch.Tensor  # (B, n, k+q, q)  M_i^-1 E_t
    Gc: torch.Tensor  # (B, q, q)       lower Cholesky factor of G
    coef: tuple  # (s, c1, c2, d), plain versions only
    offs: tuple  # forward map at zero
    cX: torch.Tensor
    cTh: torch.Tensor
    J1: torch.Tensor
    J2: torch.Tensor
    delta: torch.Tensor
    seg_j1: torch.Tensor
    seg_j2: torch.Tensor
    n: int
    m: int
    k: int
    q: int
    gamma: float
    alpha: float


def _pairs_t(k, dtype, device):
    J1np, J2np = pair_indices(k)
    eye = np.eye(k)
    return (torch.as_tensor(J1np, dtype=torch.long, device=device),
            torch.as_tensor(J2np, dtype=torch.long, device=device),
            torch.as_tensor((J1np == J2np).astype(np.float64), dtype=dtype, device=device),
            torch.as_tensor(eye[J1np], dtype=dtype, device=device),
            torch.as_tensor(eye[J2np], dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# K9s: rho-free factorisations (once per solve call)
# ---------------------------------------------------------------------------


def mc_gram_plain(batch: MCBatch, k: int):
    """The per-row (U, t) Grams ``M_i = R_i'R_i + diag(4 I_k, 0_q) + 1e-9 I``
    of the z-step, (B, n, k+q, k+q), with R_i the 4q envelope rows of row
    i."""
    U_lo, U_hi = batch.U_lo, batch.U_hi
    dtype, dev = U_lo.dtype, U_lo.device
    B, n = U_lo.shape[0], U_lo.shape[1]
    q = k * (k + 1) // 2
    J1, J2, _, seg_j1, seg_j2 = _pairs_t(k, dtype, dev)
    s, c1, c2, d = mccormick_coeffs(U_lo, U_hi, J1, J2)
    aU = c1[..., None] * seg_j1 + c2[..., None] * seg_j2  # (B, 4, n, q, k)
    at = s[..., None] * torch.eye(q, dtype=dtype, device=dev)  # (B, 4, n, q, q)
    R = torch.cat([aU, at], dim=-1).transpose(1, 2).reshape(B, n, 4 * q, k + q)
    Mblk = torch.einsum("bnrc,bnrd->bncd", R, R)
    fixed = torch.cat([4.0 * torch.ones(k, dtype=dtype, device=dev),
                       torch.zeros(q, dtype=dtype, device=dev)])
    Mblk = Mblk + torch.diag(fixed)
    # a tiny Tikhonov term keeps the t block invertible when an envelope row
    # degenerates (lo = hi), as in omc
    return Mblk + 1e-9 * torch.eye(k + q, dtype=dtype, device=dev)


def mc_setup_plain(batch: MCBatch, k: int):
    """Plain version of K9s (``omc/sdp/mccormick.py:385-417``): the lower
    Cholesky factors Mc of the row Grams (``mc_gram_plain``), ``Si = M_i^-1
    E_t`` and the lower Cholesky factor Gc of ``G = I_q + sum_i Si[i, k:,
    :]``."""
    U_lo = batch.U_lo
    dtype, dev = U_lo.dtype, U_lo.device
    B, n = U_lo.shape[0], U_lo.shape[1]
    q = k * (k + 1) // 2
    Mc = torch.linalg.cholesky(mc_gram_plain(batch, k))
    Et = torch.cat([torch.zeros((k, q), dtype=dtype, device=dev),
                    torch.eye(q, dtype=dtype, device=dev)], dim=0)
    Si = torch.cholesky_solve(torch.broadcast_to(Et, (B, n, k + q, q)), Mc)
    G = torch.eye(q, dtype=dtype, device=dev) + torch.sum(Si[..., k:, :], dim=1)
    Gc = torch.linalg.cholesky(G)
    return Mc.contiguous(), Si.contiguous(), Gc.contiguous()


def _check_k(name, k):
    if k < 1:
        raise ValueError(f"{name}: the kernels take k >= 1, got k={k}")


def _check_path(name, path):
    if path not in (None, K9_WIDE):
        raise ValueError(f"{name}: path is None or {K9_WIDE!r}, got {path!r}")


# K9s's, K9a's and K9b's two builds of each kernel: the unrolled ones (k <=
# 3, a row's system in registers, n + m <= 4096) and the wide ones (any k
# and width, a row's system in memory; csrc/k9_mccormick.cu); the plans
# take the unrolled kernels wherever they fit
K9_UNROLLED_MAX_K, K9_UNROLLED_MAX_NM = 3, 4096
# the plans' ``path`` option: None picks by shape, "wide" forces the wide
# kernels at any (k, n, m) (timing)
K9_WIDE = "wide"
# the wide kernels' rows a CTA (a warp a row, 128 threads)
K9_WIDE_ROWS = 4


# K9s's CTA (csrc/k9_mccormick.cu): one a node slot, n threads rounded up to
# whole warps, 128 to 256 (a thread takes a row of each chunk of that many),
# fewer where a chunk's staging would pass a CTA's shared memory (227 KB)
K9S_THREADS, K9S_MIN_THREADS = 256, 128
K9_SMEM_MAX = 232448


def _k9s_smem_values(threads: int, k: int, itemsize: int) -> int:
    q = k * (k + 1) // 2
    kq, slack = k + q, 16 // itemsize
    return (slack + threads * kq * kq) + (slack + threads * kq * q) + (
        threads // 32) * (q * (q + 1) // 2)


def k9s_plan(B: int, n: int, k: int, dtype=torch.float32, path=None) -> dict:
    """K9s's launch at (B, n, k) on values of ``dtype``: B CTAs of
    ``threads``, the rows in ``chunks`` of that many, ``smem_bytes`` of
    dynamic shared memory (a chunk's Mc and Si rows staged with one 16-byte
    word of alignment slack each, then each warp's partials of G's
    q(q+1)/2 lower entries); in float64 the threads narrow by warps until
    that fits (k = 3: 192 threads).  At k > 3 the wide kernels:
    ``row_ctas`` CTAs of 128 threads, a warp a row (M_i built and factored
    in Mc, then S_i), then B CTAs summing G and factoring it; ``path`` =
    "wide" takes them at any k."""
    _check_k("K9s", k)
    _check_path("K9s", path)
    if B < 1 or n < 1:
        raise ValueError(f"K9s: B={B}, n={n}")
    if path == K9_WIDE or k > K9_UNROLLED_MAX_K:
        return dict(path=K9_WIDE, threads=K9_THREADS, row_ctas=B * _cdiv(n, K9_WIDE_ROWS),
                    g_ctas=B, smem_bytes=0)
    e = dtype.itemsize
    threads = min(K9S_THREADS, max(K9S_MIN_THREADS, 32 * _cdiv(n, 32)))
    while threads > K9S_MIN_THREADS and e * _k9s_smem_values(threads, k, e) > K9_SMEM_MAX:
        threads -= 32
    return dict(threads=threads, chunks=_cdiv(n, threads),
                smem_bytes=e * _k9s_smem_values(threads, k, e))


def _k9s_layout(B: int, n: int, k: int):
    """K9s's one output buffer: the (offset, shape) of Mc, Si and Gc in it,
    each on a boundary of 64 values (256 bytes in float32, 512 in float64),
    and its length in values."""
    q = k * (k + 1) // 2
    kq = k + q
    out, o = [], 0
    for shape in ((B, n, kq, kq), (B, n, kq, q), (B, q, q)):
        out.append((o, shape))
        o += _cdiv(math.prod(shape), 64) * 64
    return out, o


def _k9s_views(buf, B: int, n: int, k: int):
    """(Mc, Si, Gc) as views of ``buf`` (``mc_setup_buffer``)."""
    return tuple(buf[o:o + math.prod(shape)].view(shape)
                 for o, shape in _k9s_layout(B, n, k)[0])


def mc_setup_buffer(B: int, n: int, k: int, device, dtype=torch.float32) -> torch.Tensor:
    """One flat buffer of ``dtype`` (the batch's) holding K9s's three
    outputs."""
    return torch.empty(_k9s_layout(B, n, k)[1], dtype=dtype, device=device)


def mc_setup(batch: MCBatch, k: int, path=None):
    """K9s wrapper: returns (Mc, Si, Gc).  A CPU batch runs
    ``mc_setup_plain``; a CUDA batch launches ``csrc/k9_mccormick.cu``
    (``k9s_plan``: one CTA per slot, a thread a row with its factor in
    registers, the slot's factors stored coalesced, a fixed-order sum for
    G; at k > 3, or forced by ``path``, the wide kernels, counted as
    "K9sw") or raises.  The three
    outputs are views of one new buffer (``mc_setup_buffer``).  The wrapper
    runs once per solver call (``make_mc_consts``), each time into a new
    buffer, so its parameter block is packed at every call and kept by no
    cache.  A float64 batch takes the float64 build (``omc_k9s_setup_f64``)
    and a float64 buffer."""
    dev = batch.U_lo.device
    if dev.type == "cpu":
        return mc_setup_plain(batch, k)
    if dev.type != "cuda":
        raise ValueError(f"mc_setup: unsupported device {dev}")
    B, n = batch.U_lo.shape[:2]
    dt = batch.U_lo.dtype
    plan = k9s_plan(B, n, k, dt, path)  # refuses a rank or a shape before the allocation
    views = _k9s_views(mc_setup_buffer(B, n, k, dev, dt), B, n, k)
    wide = plan.get("path") == K9_WIDE
    kernels.launch("K9sw" if wide else "K9s",
                   kernels.entry("omc_k9s_setup_wide" if wide else "omc_k9s_setup", dt),
                   _k9s_params(batch, k, views, dev), dev)
    return views


def _k9s_params(batch: MCBatch, k: int, views, dev):
    """K9s's parameter block: the boxes and the three outputs ``views``
    ((Mc, Si, Gc), ``_k9s_views``), each operand checked at the boxes'
    dtype."""
    B, n = batch.U_lo.shape[:2]
    dt = batch.U_lo.dtype
    k9s_plan(B, n, k, dt)
    q = k * (k + 1) // 2
    kq = k + q
    prm = kernels.block(kernels.K9sParams, dt)
    prm.U_lo = kernels.check("U_lo", batch.U_lo, (B, n, k), dev, dt)
    prm.U_hi = kernels.check("U_hi", batch.U_hi, (B, n, k), dev, dt)
    prm.Mc = kernels.check("Mc", views[0], (B, n, kq, kq), dev, dt)
    prm.Si = kernels.check("Si", views[1], (B, n, kq, q), dev, dt)
    prm.Gc = kernels.check("Gc", views[2], (B, q, q), dev, dt)
    prm.B, prm.n, prm.k = B, n, k
    return prm


def mc_setup_structured(batch: MCBatch, k: int, threads: int = None):
    """K9s's order of work in torch, on the CPU (a mirror for the tests):
    the row Grams from their structure (``csrc/k9_mccormick.cu``
    ``k9s_gram``), Cholesky factors with one reciprocal square root a pivot
    (``chol_rcp``), the q solves for S_i e_q with the forward pass from row
    k + q, and G's lower triangle summed as the CTA of ``threads``
    (``k9s_plan``'s by default) sums it: each thread's rows in order, xor
    shuffles within each warp (lane 0's value), the warps in order.
    Returns (Mc, Si, Gc) like ``mc_setup_plain``."""
    lo, hi = batch.U_lo, batch.U_hi
    dtype = lo.dtype
    B, n = lo.shape[:2]
    q = k * (k + 1) // 2
    kq = k + q
    T = threads or k9s_plan(B, n, k, dtype)["threads"]
    A = torch.zeros((B, n, kq, kq), dtype=dtype)
    p = 0
    for j1 in range(k):
        for j2 in range(j1, k):
            l1, h1, l2, h2 = lo[..., j1], hi[..., j1], lo[..., j2], hi[..., j2]
            if j1 == j2:
                sl = l1 + h1
                A[..., j1, j1] += 4.0 * (l1 * l1 + h1 * h1) + 2.0 * (sl * sl)
                A[..., k + p, j1] = -4.0 * sl
            else:
                s1, s2 = l1 + h1, l2 + h2
                A[..., j1, j1] += 2.0 * (l2 * l2 + h2 * h2)
                A[..., j2, j2] += 2.0 * (l1 * l1 + h1 * h1)
                A[..., j2, j1] += s1 * s2
                A[..., k + p, j1] = -2.0 * s2
                A[..., k + p, j2] = -2.0 * s1
            p += 1
    eye = torch.arange(kq)
    A[..., eye, eye] = (A[..., eye, eye] + 4.0) + 1e-9

    def chol_rcp(A, D):
        inv = torch.empty(A.shape[:-2] + (D,), dtype=A.dtype)
        for j in range(D):
            d = A[..., j, j] - (A[..., j, :j] * A[..., j, :j]).sum(-1)
            r = torch.rsqrt(d)
            A[..., j, j] = d * r
            inv[..., j] = r
            for i in range(j + 1, D):
                A[..., i, j] = (A[..., i, j] - (A[..., i, :j] * A[..., j, :j]).sum(-1)) * r
        return torch.tril(A), inv

    L, inv = chol_rcp(A, kq)
    Si = torch.zeros((B, n, kq, q), dtype=dtype)
    for c in range(q):
        x = torch.zeros((B, n, kq), dtype=dtype)
        x[..., k + c] = inv[..., k + c]
        for a in range(k + c + 1, kq):
            x[..., a] = -(L[..., a, k + c:a] * x[..., k + c:a]).sum(-1) * inv[..., a]
        for a in range(kq - 1, -1, -1):
            x[..., a] = (x[..., a] - (L[..., a + 1:, a] * x[..., a + 1:]).sum(-1)) * inv[..., a]
        Si[..., c] = x
    # G: rows i = t, t + T, ... to thread t in order; xor shuffles; warps
    low = Si[..., k:, :]  # (B, n, q, q)
    Tn = _cdiv(n, T) * T
    rows = torch.zeros((B, Tn, q, q), dtype=dtype)
    rows[:, :n] = low
    per = rows.reshape(B, Tn // T, T, q, q)
    acc = torch.zeros((B, T, q, q), dtype=dtype)
    for c in range(Tn // T):
        acc = acc + per[:, c]
    lanes = acc.reshape(B, T // 32, 32, q, q)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, idx ^ o]
    G = torch.zeros((B, q, q), dtype=dtype)
    for w in range(T // 32):
        G = G + lanes[:, w, 0]
    G = torch.eye(q, dtype=dtype) + G
    Gc, _ = chol_rcp(G.clone(), q)
    return L.contiguous(), Si.contiguous(), Gc.contiguous()


def make_mc_consts(A, mask, batch: MCBatch, state: MCState, n, m, k, gamma, alpha,
                   dtype):
    """The per-call constants: the K9s factors, the linear objective
    coefficients and the constant slot offsets (forward map at zero)."""
    B = state.rho.shape[0]
    dev = state.rho.device
    q = k * (k + 1) // 2
    sX = state.sX[:, None, None]
    sT = state.sT[:, None, None]
    J1, J2, delta, seg_j1, seg_j2 = _pairs_t(k, dtype, dev)
    coef = mccormick_coeffs(batch.U_lo, batch.U_hi, J1, J2)
    Mc, Si, Gc = mc_setup(batch, k)
    cX = -sX * (mask * A)[None]
    cTh = (sT * 0.5 / gamma) * torch.eye(m, dtype=dtype, device=dev)[None]

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)

    offs = _mc_forward(coef, J1, J2, delta, z(B, n, m), z(B, n, n), z(B, m, m),
                       z(B, n, k), z(B, n, q), k, sX, sT)
    return _MCConsts(
        batch=batch, mask=mask, maskA=(mask * A).contiguous(), Mc=Mc, Si=Si, Gc=Gc,
        coef=coef, offs=offs, cX=cX, cTh=cTh, J1=J1, J2=J2, delta=delta,
        seg_j1=seg_j1, seg_j2=seg_j2, n=n, m=m, k=k, q=q, gamma=float(gamma),
        alpha=float(alpha),
    )


# ---------------------------------------------------------------------------
# K9a's and K9b's grid
# ---------------------------------------------------------------------------

# K9a's and K9b's geometry (csrc/k9_mccormick.cu): CTAs of 128 threads, one
# slot CTA a node slot first in the grid; K9a's flat CTAs take X in chunks of
# 512 entries and Theta's and Y's tile pairs of 16 x 16 tiles; K9b's take a
# 16-byte word of consecutive t1, t2 or t3 entries a thread (a quad of
# floats, a pair of doubles), qpc words a CTA, fewer until the flat CTAs
# fill the card's SMs
K9_THREADS, K9_TILE, K9_X_CHUNK = 128, 16, 512
K9B_TARGET_CTAS = H100_SMS


def _cdiv(a, b):
    return -(-a // b)


def k9_wide(n: int, m: int, k: int, dtype=torch.float32) -> bool:
    """Whether K9a and K9b take their wide kernels at (n, m, k): past the
    unrolled kernels' rank (3), width (n + m = 4096) or slot-CTA staging
    (n (k + q + 1) values within 227 KB)."""
    staged = dtype.itemsize * n * (k + k * (k + 1) // 2 + 1)
    return k > K9_UNROLLED_MAX_K or n + m > K9_UNROLLED_MAX_NM or staged > K9_SMEM_MAX


def k9_plan(B: int, n: int, m: int, k: int, dtype=torch.float32, path=None) -> dict:
    """K9a's and K9b's grids on values of ``dtype``, one dimension each.
    K9a (``k9a_grid``): B slot CTAs (slot x: the per-row (U, t) solves, the
    sums over rows, Y's diagonal; z0 and Y's diagonal staged, n (k + q + 1)
    values), then ``units`` CTAs a slot (slot x // units): ``x_chunks``
    chunks of 512 entries of X, ``th_pairs`` tile pairs (I <= J, row by
    row) of Theta's ceil(m / 16)^2 tiles, ``y_pairs`` of Y's ceil(n / 16)^2.
    K9b (``k9b_grid``): B slot CTAs, then ``t1_ctas``, ``t2_ctas`` and
    ``t3_ctas`` CTAs of ``qpc`` words of E = 16 / itemsize consecutive
    entries (quads in float32, pairs in float64) of the batch's flat t1,
    t2, t3; ``qpc`` halves from 128 to 32 while the flat CTAs are fewer
    than ``K9B_TARGET_CTAS``.  These are the unrolled kernels' (k <= 3,
    n + m <= 4096, the slot CTA's staging within 227 KB); elsewhere
    (``k9_wide``), or at any shape with ``path`` = "wide", the wide
    kernels' (``_k9_wide_plan``).  Raises on a rank or a shape no kernel
    takes."""
    _check_k("K9", k)
    _check_path("K9", path)
    if min(B, m) < 1 or n < 2:
        raise ValueError(f"K9: unsupported shape B={B}, n={n}, m={m} (B, m >= 1, n >= 2)")
    tn, tm = _cdiv(n, K9_TILE), _cdiv(m, K9_TILE)
    x, th, y = _cdiv(n * m, K9_X_CHUNK), tm * (tm + 1) // 2, tn * (tn + 1) // 2
    units = x + th + y
    E = 16 // dtype.itemsize
    quads = (_cdiv(B * (n + m) ** 2, E), _cdiv(B * (n + k) ** 2, E), _cdiv(B * n * n, E))
    qpc = K9_THREADS
    while qpc > 32 and sum(_cdiv(x, qpc) for x in quads) < K9B_TARGET_CTAS:
        qpc //= 2
    t1, t2, t3 = (_cdiv(x, qpc) for x in quads)
    plan = dict(threads=K9_THREADS, tile=K9_TILE, x_chunk=K9_X_CHUNK, slot_ctas=B, x_chunks=x,
                th_pairs=th, y_pairs=y, units=units, k9a_grid=B + B * units, qpc=qpc,
                t1_ctas=t1, t2_ctas=t2, t3_ctas=t3, k9b_grid=B + t1 + t2 + t3)
    wide = path == K9_WIDE or k9_wide(n, m, k, dtype)
    return _k9_wide_plan(plan, B, n, m, k, dtype) if wide else plan


def _k9_wide_plan(plan, B, n, m, k, dtype):
    """The wide K9a and K9b (any k, any n + m) from the unrolled kernels'
    ``plan``, whose flat CTAs and K9b slot CTAs they keep: K9a's
    ``row_ctas`` (a warp a row of a slot's (U, t) solves, ``K9_WIDE_ROWS``
    rows a CTA) take the place of its slot CTAs, then a second launch of B
    CTAs (``k9a_fix_smem`` bytes: the slot's q + 1 sums, the Gc solve, the
    corrections); K9b's slot CTA takes ``k9b_smem`` bytes.  The flat
    entries split exactly at any width and batch (in 64 bits past 2^31)."""
    q, e = k * (k + 1) // 2, dtype.itemsize
    fix, slot = e * (q + 1), e * (1 + 2 * k + q)
    if max(fix, slot) > K9_SMEM_MAX:
        raise ValueError(f"K9: k={k} takes {max(fix, slot)} bytes of a slot's sums, above "
                         f"{K9_SMEM_MAX}")
    rows = B * _cdiv(n, K9_WIDE_ROWS)
    return dict(plan, path=K9_WIDE, row_ctas=rows, k9a_grid=rows + B * plan["units"],
                k9a_fix_ctas=B, k9a_fix_smem=fix, k9b_smem=slot)


def tile_pairs(T: int) -> list:
    """The tile pairs (I, J), I <= J, of a T x T grid of tiles in K9a's
    order (row by row)."""
    return [(I, J) for I in range(T) for J in range(I, T)]


def cta_sum(x, threads: int = K9_THREADS):
    """The sum over dim -2 of x (B, n, F) in the order of a slot CTA of
    ``threads`` threads (K9a, K9b): thread r adds rows r, r + threads, ...
    in order, each warp of 32 adds its lanes by xor shuffles (offsets 16,
    8, 4, 2, 1), then the warps are added in order.  Returns (B, F)."""
    B, n, F = x.shape
    rows = _cdiv(n, threads) * threads
    xp = torch.zeros((B, rows, F), dtype=x.dtype, device=x.device)
    xp[:, :n] = x
    xp = xp.reshape(B, rows // threads, threads, F)
    part = torch.zeros((B, threads, F), dtype=x.dtype, device=x.device)
    for r in range(rows // threads):
        part = part + xp[:, r]
    lane = torch.arange(threads, device=x.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, (lane // 32) * 32 + ((lane % 32) ^ o)]
    tot = torch.zeros((B, F), dtype=x.dtype, device=x.device)
    for w in range(threads // 32):
        tot = tot + part[:, 32 * w]
    return tot


def _sym_tiles(z, T: int, tile: int):
    """0.5 (z + z') written tile pair by tile pair, both tiles of a pair
    from the same two staged tiles (K9a's order); entries no pair writes
    stay NaN."""
    out = torch.full_like(z, float("nan"))
    for I, J in tile_pairs(T):
        a, b = slice(I * tile, (I + 1) * tile), slice(J * tile, (J + 1) * tile)
        out[:, a, b] = 0.5 * (z[:, a, b] + z[:, b, a].transpose(-1, -2))
        out[:, b, a] = 0.5 * (z[:, b, a] + z[:, a, b].transpose(-1, -2))
    return out


# ---------------------------------------------------------------------------
# K9a: adjoint + z-step
# ---------------------------------------------------------------------------


def mc_zstep_plain(c: _MCConsts, st: MCState):
    """Plain version of K9a: the adjoint of the slot residuals and the
    z-step (``omc/sdp/mccormick.py:329-348,419-475``).  The orthogonality
    correction is ``z = z0 - Si tcorr`` (``omc``'s second ``cho_solve`` of
    ``[0; tcorr]``, through the factor K9s already applied).  Returns (Xs,
    Y, Ths, U, t) with Y and Ths symmetrised."""
    n, m, k = c.n, c.m, c.k
    offs = c.offs
    sX = st.sX[:, None, None]
    sT = st.sT[:, None, None]
    rho_b = st.rho
    r3 = rho_b[:, None, None]
    gX, gY, gTh, gU, gt = _mc_adjoint(
        c.coef,
        st.w1 - st.u1 - offs[0], st.w2 - st.u2 - offs[1],
        st.w3 - st.u3 - offs[2], st.w4 - st.u4 - offs[3],
        st.wsoc - st.usoc - offs[4], st.wbox - st.ubox - offs[5],
        st.wmc - st.umc - offs[6], st.worth - st.uorth - offs[7],
        n, m, k, sX, sT, c.seg_j1, c.seg_j2,
    )
    rX, rY, rTh, rU, rt = r3 * gX - c.cX, r3 * gY, r3 * gTh - c.cTh, r3 * gU, r3 * gt
    dX = c.mask[None] * (sX * sX) + r3 * 2.0 * sX * sX
    Xs = rX / dX
    # Y: (3 I + vec I vec I') per rho
    zY = rY / 3.0
    trz = torch.diagonal(zY, dim1=-2, dim2=-1).sum(-1)
    zY = zY - (trz / (3.0 + n))[:, None, None] * torch.eye(n, dtype=zY.dtype, device=zY.device)
    Y = zY / r3
    Ths = rTh / (r3 * sT * sT)
    # (U, t): per-row Cholesky solves, then the orthogonality Woodbury
    r = torch.cat([rU, rt], dim=-1)  # (B, n, k+q)
    z0 = torch.cholesky_solve(r[..., None], c.Mc)[..., 0]
    wz = torch.sum(z0[..., k:], dim=-2)  # (B, q)
    tcorr = torch.cholesky_solve(wz[..., None], c.Gc)[..., 0]
    z = z0 - torch.einsum("bnrq,bq->bnr", c.Si, tcorr)
    U = z[..., :k] / rho_b[:, None, None]
    t = z[..., k:] / rho_b[:, None, None]
    Y = 0.5 * (Y + Y.transpose(-1, -2))
    Ths = 0.5 * (Ths + Ths.transpose(-1, -2))
    return Xs, Y, Ths, U, t


def mc_zstep_tiled(c: _MCConsts, st: MCState, plan: dict):
    """Torch mirror of K9a's order of work (``plan`` from ``k9_plan``), for
    the tests: X entry by entry; Theta's and Y's entries tile pair by tile
    pair, each pair's two tiles from the same staged values; Y's diagonal
    from the slot CTA: tr(rho gY / 3) summed in its order (``cta_sum``) and
    the trace correction on the diagonal only; the per-row (U, t) solves
    with sum_i z0_i[k:] in the same order.  Returns (Xs, Y, Ths, U, t) as
    ``mc_zstep_plain``."""
    n, m, k, q = c.n, c.m, c.k, c.q
    tile = plan["tile"]
    rho_b = st.rho
    rho, sX, sT = rho_b[:, None, None], st.sX[:, None, None], st.sT[:, None, None]
    d1 = st.w1 - st.u1
    Xs = (rho * (sX * 2.0 * d1[:, :n, n:]) + sX * c.maskA) / (
        c.mask * (sX * sX) + rho * 2.0 * sX * sX)
    # Theta: dg on the diagonal of both terms
    eye_m = torch.eye(m, dtype=d1.dtype, device=d1.device)
    cth = sT * 0.5 / c.gamma
    za = (rho * (sT * d1[:, n:, n:]) - cth * eye_m) / (rho * sT * sT)
    Ths = _sym_tiles(za, _cdiv(m, tile), tile)
    # Y off the diagonal from the tile pairs, its diagonal from the slot CTA
    g = (d1[:, :n, :n] + (st.w2 - st.u2)[:, :n, :n]) - ((st.w3 - st.u3) - 0.0)
    Y = _sym_tiles(((rho * g) / 3.0 - 0.0) / rho, _cdiv(n, tile), tile)
    diag = lambda x: torch.diagonal(x, dim1=-2, dim2=-1)  # noqa: E731
    y4 = (st.w4 - st.u4) - float(k)
    dg = (diag(d1[:, :n, :n]) + diag(st.w2 - st.u2)[:, :n]) - (diag(st.w3 - st.u3) - 1.0)
    yp = (rho_b[:, None] * (dg - y4[:, None])) / 3.0
    ctr = cta_sum(yp[..., None], plan["threads"])[..., 0] / (3.0 + n)
    a = (yp - ctr[:, None]) / rho_b[:, None]
    diag(Y).copy_(0.5 * (a + a))
    # (U, t): the row's right-hand side, its Mc solve, the Woodbury sum
    s, c1, c2, d = c.coef
    ym = (st.wmc - st.umc) - d  # (B, 4, n, q)
    rU = 2.0 * (st.w2 - st.u2)[:, :n, n:] + (st.wsoc - st.usoc)[..., 1:].transpose(-1, -2) + (
        st.wbox - st.ubox)
    g1 = torch.zeros_like(rU)
    g2 = torch.zeros_like(rU)
    gt = torch.zeros_like(st.t)
    mc1 = torch.zeros_like(st.t)
    mc2 = torch.zeros_like(st.t)
    for rr in range(4):
        mc1 = mc1 + ym[:, rr] * c1[:, rr]
        mc2 = mc2 + ym[:, rr] * c2[:, rr]
        gt = gt + ym[:, rr] * s[:, rr]
    for pp, (j1, j2) in enumerate(zip(c.J1.tolist(), c.J2.tolist())):
        g1[..., j1] = g1[..., j1] + mc1[..., pp]
        g2[..., j2] = g2[..., j2] + mc2[..., pp]
    yo = (st.worth - st.uorth) + c.delta  # (B, q)
    r = torch.cat([rho * ((rU + g1) + g2), rho * (gt + yo[:, None, :])], dim=-1)
    z0 = torch.cholesky_solve(r[..., None], c.Mc)[..., 0]
    tcorr = torch.cholesky_solve(cta_sum(z0[..., k:], plan["threads"])[..., None], c.Gc)[..., 0]
    corr = torch.zeros_like(z0)
    for aa in range(q):
        corr = corr + c.Si[..., aa] * tcorr[:, None, None, aa]
    z = (z0 - corr) / rho
    return Xs, Y, Ths, z[..., :k], z[..., k:]


def _shapes(B, n, m, k):
    q = k * (k + 1) // 2
    return {
        "w1": (B, n + m, n + m), "u1": (B, n + m, n + m),
        "w2": (B, n + k, n + k), "u2": (B, n + k, n + k),
        "w3": (B, n, n), "u3": (B, n, n), "w4": (B,), "u4": (B,),
        "wsoc": (B, k, 1 + n), "usoc": (B, k, 1 + n),
        "wbox": (B, n, k), "ubox": (B, n, k),
        "wmc": (B, 4, n, q), "umc": (B, 4, n, q), "worth": (B, q), "uorth": (B, q),
        "X": (B, n, m), "Y": (B, n, n), "Th": (B, m, m), "U": (B, n, k), "t": (B, n, q),
    }


_SLOTS = ("w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc", "wbox",
          "ubox", "wmc", "umc", "worth", "uorth")


def mc_zstep(c: _MCConsts, st: MCState, path=None):
    """K9a wrapper: writes (Xs, Y, Ths, U, t) into ``st``.  A CPU state runs
    ``mc_zstep_plain``; a CUDA state launches ``csrc/k9_mccormick.cu``
    (``k9_plan``'s grid: a slot CTA a node slot, then the X chunks and the
    Theta and Y tile pairs; a float64 state the float64 build,
    ``omc_k9a_zstep_f64``; the wide kernels where the plan says so, or
    ``path`` forces them, counted as "K9aw") or raises.  The parameter
    block, and the plan's path with it, is packed once per operands
    (``admm._packed``)."""
    dev = st.w1.device
    if dev.type == "cpu":
        for dst, src in zip((st.X, st.Y, st.Th, st.U, st.t), mc_zstep_plain(c, st)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"mc_zstep: unsupported device {dev}")
    p = _k9a_params(c, st, dev, path)
    kernels.launch("K9aw" if p.wide else "K9a",
                   kernels.entry("omc_k9a_zstep_wide" if p.wide else "omc_k9a_zstep",
                                 st.rho.dtype), p, dev)


# K9a's and K9b's state operands, gathered cheaply for the reuse test of
# their packed blocks
_K9_ST = operator.attrgetter(*_SLOTS, "X", "Y", "Th", "U", "t", "sX", "sT", "rho")


def _k9a_tensors(c: _MCConsts, st: MCState) -> tuple:
    return _K9_ST(st) + (c.batch.U_lo, c.batch.U_hi, c.maskA, c.mask, c.Mc, c.Si, c.Gc)


def _k9a_operands(c: _MCConsts, st: MCState) -> list:
    """(field, tensor, shape) of every K9a operand (each of the state's
    dtype)."""
    B = st.rho.shape[0]
    n, m, k, q = c.n, c.m, c.k, c.q
    shapes = _shapes(B, n, m, k)
    return ([(name, getattr(st, name), shapes[name]) for name in _SLOTS]
            + [("U_lo", c.batch.U_lo, (B, n, k)), ("U_hi", c.batch.U_hi, (B, n, k)),
               ("maskA", c.maskA, (n, m)), ("mask", c.mask, (n, m)), ("sX", st.sX, (B,)),
               ("sT", st.sT, (B,)), ("rho", st.rho, (B,)), ("Mc", c.Mc, (B, n, k + q, k + q)),
               ("Si", c.Si, (B, n, k + q, q)), ("Gc", c.Gc, (B, q, q)),
               ("Xs", st.X, shapes["X"]), ("Y", st.Y, shapes["Y"]), ("Ths", st.Th, shapes["Th"]),
               ("U", st.U, shapes["U"]), ("t", st.t, shapes["t"])])


def _k9a_params(c: _MCConsts, st: MCState, dev, path=None):
    """K9a's parameter block (the float64 build's for a float64 state),
    packed once per operands and ``path`` (``admm._packed``); every operand
    checked at the state's dtype; ``wide`` says which kernel its plan
    takes."""
    dt = st.rho.dtype

    def build():
        B = st.rho.shape[0]
        # refuses a rank or a shape the kernels do not take
        plan = k9_plan(B, c.n, c.m, c.k, dt, path)
        p = kernels.block(kernels.K9aParams, dt)
        p.wide = plan.get("path") == K9_WIDE
        for name, t, shape in _k9a_operands(c, st):
            setattr(p, name, kernels.check(name, t, shape, dev, dt))
        p.B, p.n, p.m, p.k = B, c.n, c.m, c.k
        p.gamma = float(c.gamma)
        return p

    return _packed(("K9a", id(c), id(st), dt, path), _k9a_tensors(c, st), (c.gamma,), build)


# ---------------------------------------------------------------------------
# K9b: forward map + cone step
# ---------------------------------------------------------------------------

_REST = ("w4", "u4", "wsoc", "usoc", "wbox", "ubox", "wmc", "umc", "worth", "uorth")


def mc_cone_step_plain(c: _MCConsts, st: MCState, acc=None, beta: float = 0.0):
    """Plain version of K9b at the current (Xs, Y, Ths, U, t) of ``st``
    (``omc/sdp/mccormick.py:477-506``): returns ``(t1, t2, t3, rest,
    acc_new)`` with ``rest`` the new (w4, u4, wsoc, usoc, wbox, ubox, wmc,
    umc, worth, uorth) and, when ``acc`` = (acc_mc, acc_orth) is given, the
    running means ``acc += beta (rho u - acc)`` of rho*umc and rho*uorth."""
    alpha = c.alpha
    f = _mc_forward(c.coef, c.J1, c.J2, c.delta, st.X, st.Y, st.Th, st.U, st.t, c.k,
                    st.sX[:, None, None], st.sT[:, None, None])

    def relax_mix(fz, w):
        return alpha * fz + (1.0 - alpha) * w

    t1 = relax_mix(f[0], st.w1) + st.u1
    t2 = relax_mix(f[1], st.w2) + st.u2
    t3 = relax_mix(f[2], st.w3) + st.u3
    t4 = relax_mix(f[3], st.w4) + st.u4
    w4 = torch.clamp(t4, min=0.0)
    u4 = t4 - w4
    tsoc = relax_mix(f[4], st.wsoc) + st.usoc
    pt, pw = project_soc(tsoc[..., 0], tsoc[..., 1:])
    wsoc = torch.cat([pt[..., None], pw], dim=-1)
    usoc = tsoc - wsoc
    tbox = relax_mix(f[5], st.wbox) + st.ubox
    wbox = torch.minimum(torch.maximum(tbox, c.batch.U_lo), c.batch.U_hi)
    ubox = tbox - wbox
    tmc = relax_mix(f[6], st.wmc) + st.umc
    wmc = torch.clamp(tmc, min=0.0)
    umc = tmc - wmc
    tor = relax_mix(f[7], st.worth) + st.uorth
    worth = torch.zeros_like(tor)  # equality slot: projection onto {0}
    uorth = tor
    acc_new = None
    if acc is not None:
        acc_new = (acc[0] + beta * (st.rho[:, None, None, None] * umc - acc[0]),
                   acc[1] + beta * (st.rho[:, None] * uorth - acc[1]))
    rest = (w4, u4, wsoc, usoc, wbox, ubox, wmc, umc, worth, uorth)
    return t1, t2, t3, rest, acc_new


def mc_cone_step_tiled(c: _MCConsts, st: MCState, acc, beta: float, plan: dict):
    """Torch mirror of K9b's order of work (``plan`` from ``k9_plan``), for
    the tests: tr Y, the k SOC column norms and sum_i t[i, p] summed in the
    slot CTA's order (``cta_sum``), and the trace, SOC and orthogonality
    slots from them; t1, t2, t3, the box and the envelope rows entry by
    entry as ``mc_cone_step_plain`` (no entry depends on another).  Returns
    the plain version's tuple."""
    t1, t2, t3, rest, acc_new = mc_cone_step_plain(c, st, acc, beta)
    w4, u4, wsoc, usoc, wbox, ubox, wmc, umc, worth, uorth = rest
    alpha, om, k, nt = c.alpha, 1.0 - c.alpha, c.k, plan["threads"]
    tr = cta_sum(torch.diagonal(st.Y, dim1=-2, dim2=-1)[..., None], nt)[..., 0]
    t4 = (alpha * (k - tr) + om * st.w4) + st.u4
    w4 = torch.clamp(t4, min=0.0)
    u4 = t4 - w4
    v = (alpha * st.U.transpose(-1, -2) + om * st.wsoc[..., 1:]) + st.usoc[..., 1:]  # (B, k, n)
    tt = (alpha * 1.0 + om * st.wsoc[..., 0]) + st.usoc[..., 0]  # (B, k)
    nj = torch.sqrt(cta_sum((v * v).transpose(-1, -2), nt))  # (B, k)
    zero = torch.zeros_like(v)
    tail = torch.where(nj > 0, 0.5 * (1.0 + tt / nj), torch.zeros_like(nj))[..., None] * v
    tail = torch.where((nj <= -tt)[..., None], zero, tail)
    tail = torch.where((nj <= tt)[..., None], v, tail)
    head = torch.where(nj <= -tt, torch.zeros_like(tt), 0.5 * (tt + nj))
    head = torch.where(nj <= tt, tt, head)
    wsoc = torch.cat([head[..., None], tail], dim=-1)
    usoc = torch.cat([tt[..., None], v], dim=-1) - wsoc
    f = cta_sum(st.t, nt) - c.delta
    uorth = (alpha * f + om * st.worth) + st.uorth
    worth = torch.zeros_like(uorth)
    if acc is not None:
        acc_new = (acc_new[0], acc[1] + beta * (st.rho[:, None] * uorth - acc[1]))
    return t1, t2, t3, (w4, u4, wsoc, usoc, wbox, ubox, wmc, umc, worth, uorth), acc_new


def mc_cone_step(c: _MCConsts, st: MCState, ts, acc=None, beta: float = 0.0, path=None):
    """K9b wrapper: writes the pre-projection PSD slots into ``ts`` (t1,
    t2, t3), updates the non-PSD slots of ``st`` and, when given, the
    running means ``acc`` (rho umc, rho uorth) in place.  A CPU state runs
    ``mc_cone_step_plain``; a CUDA state launches ``csrc/k9_mccormick.cu``
    (``k9_plan``'s grid: a slot CTA a node slot, then the 16-byte words of
    t1, t2, t3; a float64 state the float64 build, ``omc_k9b_cone_f64``;
    the wide kernel where the plan says so, or ``path`` forces it, counted
    as "K9bw") or raises.  The parameter block, and the plan's path with
    it, is packed once per operands (``admm._packed``); ``beta`` is set on
    it at every launch."""
    dev = st.w1.device
    if dev.type == "cpu":
        t1, t2, t3, rest, acc_new = mc_cone_step_plain(c, st, acc, beta)
        for dst, src in zip(ts, (t1, t2, t3)):
            dst.copy_(src)
        for name, src in zip(_REST, rest):
            getattr(st, name).copy_(src)
        if acc is not None:
            for dst, src in zip(acc, acc_new):
                dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"mc_cone_step: unsupported device {dev}")
    p = _k9b_params(c, st, ts, acc, beta, dev, path)
    kernels.launch("K9bw" if p.wide else "K9b",
                   kernels.entry("omc_k9b_cone_wide" if p.wide else "omc_k9b_cone",
                                 st.rho.dtype), p, dev)


# the operands K9b reads and writes as 16-byte words
_K9B_WORDS = ("w1", "u1", "w2", "u2", "w3", "u3", "t1", "t2", "t3")


def _k9b_tensors(c: _MCConsts, st: MCState, ts, acc) -> tuple:
    return (_K9_ST(st) + (c.batch.U_lo, c.batch.U_hi) + tuple(ts)
            + (tuple(acc) if acc is not None else ()))


def _k9b_operands(c: _MCConsts, st: MCState, ts, acc) -> list:
    """(field, tensor, shape) of every K9b operand (each of the state's
    dtype; the running means only when ``acc`` is given)."""
    B = st.rho.shape[0]
    n, m, k = c.n, c.m, c.k
    shapes = _shapes(B, n, m, k)
    return ([("Xs", st.X, shapes["X"]), ("Y", st.Y, shapes["Y"]), ("Ths", st.Th, shapes["Th"]),
             ("U", st.U, shapes["U"]), ("t", st.t, shapes["t"])]
            + [(name, getattr(st, name), shapes[name]) for name in _SLOTS]
            + [("t1", ts[0], shapes["w1"]), ("t2", ts[1], shapes["w2"]),
               ("t3", ts[2], shapes["w3"])]
            + ([("acc_mc", acc[0], shapes["umc"]), ("acc_orth", acc[1], shapes["uorth"])]
               if acc is not None else [])
            + [("U_lo", c.batch.U_lo, (B, n, k)), ("U_hi", c.batch.U_hi, (B, n, k)),
               ("sX", st.sX, (B,)), ("sT", st.sT, (B,)), ("rho", st.rho, (B,))])


def _k9b_params(c: _MCConsts, st: MCState, ts, acc, beta: float, dev, path=None):
    """K9b's parameter block (the float64 build's for a float64 state),
    packed once per operands and ``path`` (``admm._packed``), every operand
    checked at the state's dtype; ``wide`` says which kernel its plan
    takes; the running means' weight ``beta``, which changes every
    iteration of the averaging window, is set on it at every call."""
    dt = st.rho.dtype

    def build():
        B = st.rho.shape[0]
        plan = k9_plan(B, c.n, c.m, c.k, dt, path)
        p = kernels.block(kernels.K9bParams, dt)
        p.wide = plan.get("path") == K9_WIDE
        for name, t, shape in _k9b_operands(c, st, ts, acc):
            setattr(p, name, kernels.check(name, t, shape, dev, dt))
        if any(getattr(p, name) % 16 for name in _K9B_WORDS):
            raise ValueError("K9b reads w1-w3 and u1-u3 and writes t1-t3 as 16-byte words: "
                             "their storage must start 16-byte aligned")
        p.B, p.n, p.m, p.k = B, c.n, c.m, c.k
        p.qpc = plan["qpc"]
        p.alpha = float(c.alpha)
        return p

    p = _packed(("K9b", id(c), id(st), acc is None, dt, path), _k9b_tensors(c, st, ts, acc),
                (c.alpha,), build)
    p.beta = float(beta)
    return p


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


def mc_iteration(c: _MCConsts, st: MCState, ts, acc, beta: float, psd_method: str):
    """One in-place McCormick ADMM iteration: K9a -> K9b -> K1 (float32,
    ``psd_method="ns"``), or K4 and the torch epilogue (``"eigh"``).  ``acc``
    holds the running means of (rho u1, rho u2, rho umc, rho uorth),
    updated with weight ``beta`` (none when beta is 0); ``ts`` the t1/t2/t3
    scratch.  Each step is its kernel's wrapper, so a CPU state runs the
    plain versions and a CUDA state the kernels."""
    avg = beta > 0.0
    mc_zstep(c, st)
    mc_cone_step(c, st, ts, acc[2:] if avg else None, beta)
    ws = (st.w1, st.w2, st.w3)
    us = (st.u1, st.u2, st.u3)
    accs = (acc[0], acc[1], None) if avg else None
    if psd_method == "ns":
        project_psd_ns_multi(list(ts), w_out=ws, u_out=us, acc=accs, rho=st.rho, beta=beta)
    else:
        psd_epilogue(ts, [project_psd(x) for x in ts], ws, us, accs, st.rho, beta)


def make_mccormick_solver(n: int, m: int, k: int, gamma: float, *, iters: int = 400,
                          dtype=torch.float32, alpha: float = 1.6,
                          psd_method: str = "auto"):
    """Build the batched McCormick-relaxation ADMM solver (port of
    ``omc.sdp.mccormick.make_mccormick_solver``; the penalty is each state's
    own ``rho``).

    solve(A, mask, batch: MCBatch, ub_bar, state, n_iters=None) -> (state,
    out): ``n_iters`` (default ``iters``) iterations from a clone of
    ``state``; ``out`` carries the unscaled primal blocks, the duals y1, y2,
    ymc, yorth averaged over the last quarter of the call, and the two
    separation eigenpairs of UU' - Y (reporting only: this path bisects the
    U box).  ``ub_bar`` is unused by the solve (the certificate takes it)."""
    if psd_method == "auto":
        psd_method = "eigh" if dtype == torch.float64 else "ns"
    if psd_method not in ("ns", "eigh"):
        raise ValueError(f"psd_method {psd_method!r}")

    def solve(A, mask, batch: MCBatch, ub_bar, state: MCState, n_iters=None):
        del ub_bar
        dev = state.rho.device
        if dev.type == "cuda":
            kernels.require_full_fp32()
            kernels.require_cuda_dtype("mccormick", dtype)
            want = "ns" if dtype == torch.float32 else "eigh"
            if psd_method != want:
                raise ValueError(f'the CUDA path projects {dtype} with psd_method="{want}"')
        ni = int(iters if n_iters is None else n_iters)
        A = torch.as_tensor(A, device=dev).to(dtype).contiguous()
        mask = torch.as_tensor(mask, device=dev).to(dtype).contiguous()
        batch_t = batch.map(lambda x: torch.as_tensor(x, device=dev).to(dtype).contiguous())
        B = state.rho.shape[0]
        st = state.clone()
        c = make_mc_consts(A, mask, batch_t, st, n, m, k, gamma, alpha, dtype)
        ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
        acc = [torch.zeros_like(x) for x in (st.u1, st.u2, st.umc, st.uorth)]
        navg = max(1, ni // 4)
        for it in range(ni):
            j = it - (ni - navg) + 1  # position inside the averaging window
            mc_iteration(c, st, ts, acc, 1.0 / j if j >= 1 else 0.0, psd_method)
        sep_w, sep_V = separation_eigpairs(st.U, st.Y)
        out = {
            "X": st.sX[:, None, None] * st.X, "Y": st.Y,
            "Th": st.sT[:, None, None] * st.Th, "U": st.U, "t": st.t,
            "y1": acc[0], "y2": acc[1], "ymc": acc[2], "yorth": acc[3],
            "iters_run": torch.full((B,), ni, dtype=torch.int32, device=dev),
            "sep_w": sep_w, "sep_V": sep_V,
        }
        return st, out

    return solve


# ---------------------------------------------------------------------------
# Float64 host certificate (numpy, as in omc)
# ---------------------------------------------------------------------------


def mccormick_safe_dual_bound(A, mask, U_lo, U_hi, y1, y2, ymc, yorth, gamma, k, ub_bar,
                              margin_rel=1e-10):
    """Closed-form partial Lagrangian dual of the McCormick relaxation, a
    valid node lower bound at any dual iterate (numpy; ``omc``'s
    ``mccormick_safe_dual_bound`` with ``xp=np``).  ``ymc`` (B, 4, n, q) are
    the envelope-row duals (-ymc the >= 0 multipliers), ``yorth`` (B, q) the
    free equality multipliers."""
    n, m = A.shape[-2], A.shape[-1]
    J1, J2 = pair_indices(k)
    delta = (J1 == J2).astype(A.dtype)

    def _psd(Mat):
        Mat = 0.5 * (Mat + np.swapaxes(Mat, -1, -2))
        w, V = np.linalg.eigh(Mat)
        # V max(w, 0) V' as one BLAS product (a three-operand einsum loops
        # in C: minutes at the order 4,200 of an n = m = 2,100 block)
        return (V * np.maximum(w, 0.0)[..., None, :]) @ np.swapaxes(V, -1, -2)

    S1in = -y1
    obs = mask > 0
    S1in = np.concatenate(
        [
            np.concatenate([S1in[..., :n, :n], np.where(obs, S1in[..., :n, n:], 0.0)], axis=-1),
            np.concatenate([np.where(obs.T, S1in[..., n:, :n], 0.0), S1in[..., n:, n:]],
                           axis=-1),
        ],
        axis=-2,
    )
    S1 = _psd(S1in)
    # structural off-support zeroing + delta-shift compensation (see
    # omc.sdp.relax.safe_dual_bound2)
    q_off = np.where(obs, 0.0, S1[..., :n, n:])
    dshift = np.sqrt(np.sum(q_off * q_off, axis=(-2, -1)))
    lmaxR1 = np.linalg.eigvalsh(S1[..., n:, n:])[..., -1] + dshift
    c_scale = np.minimum(1.0, (0.5 / gamma) / np.maximum(lmaxR1, 1e-30))
    S1 = S1 * c_scale[..., None, None]
    dshift = dshift * c_scale
    S2 = _psd(-y2)
    P1, qblk, R1 = S1[..., :n, :n], S1[..., :n, n:], S1[..., n:, n:]
    qblk = np.where(obs, qblk, 0.0)
    P2, E = S2[..., :n, :n], S2[..., n:, n:]
    D = S2[..., :n, n:]

    lam = np.maximum(-ymc, 0.0)  # (B, 4, n, q), >= 0 multipliers
    mu = -yorth  # (B, q), free
    s, c1, c2, d = mccormick_coeffs(U_lo, U_hi, J1, J2)

    G_Y = -(P1 + P2)
    G_Y = 0.5 * (G_Y + np.swapaxes(G_Y, -1, -2))
    wY = np.linalg.eigh(G_Y)[0]
    y_term = np.sum(np.minimum(wY[..., :k] - dshift[..., None], 0.0), axis=-1)

    T_th = 2.0 * gamma * ub_bar
    G_Th = (0.5 / gamma) * np.eye(m, dtype=A.dtype) - R1
    G_Th = 0.5 * (G_Th + np.swapaxes(G_Th, -1, -2))
    wT = np.linalg.eigh(G_Th)[0]
    th_term = T_th * np.minimum(wT[..., 0] - dshift, 0.0)

    R_X = np.sqrt(2.0 * gamma * ub_bar)
    x_star = np.clip(A + 2.0 * qblk, -R_X, R_X)
    obs_t = 0.5 * (x_star - A) ** 2 - 2.0 * qblk * x_star
    x_term = np.sum(np.where(mask > 0, obs_t, 0.0), axis=(-2, -1))

    mc1 = np.sum(lam * c1, axis=-3)  # (B, n, q)
    mc2 = np.sum(lam * c2, axis=-3)
    seg1 = np.eye(k, dtype=A.dtype)[J1]  # (q, k)
    seg2 = np.eye(k, dtype=A.dtype)[J2]
    W_U = -2.0 * D - np.einsum("bnq,qk->bnk", mc1, seg1) - np.einsum("bnq,qk->bnk", mc2, seg2)
    u_term = np.sum(np.minimum(W_U * U_lo, W_U * U_hi), axis=(-2, -1))

    zeta = -np.sum(lam * s, axis=-3) - mu[..., None, :]  # (B, n, q)
    t_lo, t_hi = t_corner_box(U_lo, U_hi, J1, J2)
    t_term = np.sum(np.minimum(zeta * t_lo, zeta * t_hi), axis=(-2, -1))

    const = (
        -np.sum(lam * d, axis=(-3, -2, -1))
        + np.sum(mu * delta, axis=-1)
        - np.trace(E, axis1=-2, axis2=-1)
    )
    lb = y_term + th_term + x_term + u_term + t_term + const
    scale = (
        1.0 + np.abs(lb) + ub_bar
        + np.sqrt(np.sum(S1 * S1, axis=(-2, -1)))
        + np.sqrt(np.sum(S2 * S2, axis=(-2, -1)))
        + np.sum(np.abs(lam), axis=(-3, -2, -1))
        + np.sum(np.abs(mu), axis=-1)
    )
    return lb - margin_rel * scale


def _np64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def host_certified_bound_mc(A, mask, U_lo, U_hi, out: dict, gamma, k, ub_bar):
    """Float64 host recertification of the solver's averaged duals (tensors
    on any device, or numpy arrays)."""
    return mccormick_safe_dual_bound(
        _np64(A), _np64(mask), _np64(U_lo), _np64(U_hi), _np64(out["y1"]),
        _np64(out["y2"]), _np64(out["ymc"]), _np64(out["yorth"]), float(gamma), k,
        float(ub_bar), margin_rel=1e-10,
    )


__all__ = [
    "pair_indices", "mccormick_coeffs", "t_corner_box", "mccormick_box_feasible",
    "mccormick_lp_feasible", "master_feasible_mccormick", "MCBatch", "MCState",
    "init_mc_state", "make_mccormick_solver", "mc_gram_plain", "mc_setup", "mc_setup_plain",
    "mc_zstep", "mc_zstep_plain", "mc_cone_step", "mc_cone_step_plain", "k9_plan", "k9_wide",
    "mc_zstep_tiled", "mc_cone_step_tiled", "cta_sum", "tile_pairs",
    "mccormick_safe_dual_bound", "host_certified_bound_mc",
]
