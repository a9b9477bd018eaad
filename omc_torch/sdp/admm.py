"""Batched ADMM node-relaxation solver — the production bound engine (port
of ``omc/sdp/admm.py``).

The z-step solves (Q + rho K'K) z = rhs with K'K = D + V V', D constant per
variable block (X: 2 sX^2, Y: 3, Theta: sT^2, U: 4) and V holding only
p = 1 + L + L*k structured columns (the trace row, one chord row per cut,
one interval direction per cut and coordinate).  The Woodbury Gram matrix
G1 = I + V' D1^-1 V does not depend on rho, so one Cholesky factor per
solve call serves every per-node penalty (``_gram1``).

One iteration on the GPU is three kernel launches (``omc_torch/csrc``):

1. K2 ``zstep``     — the adjoint of the slot residuals w - u - offs, the
   diagonal divides, V' r, the p x p product t = rho G1^-1 s with the
   inverse ``make_consts`` forms once per call, the V t correction, and the
   symmetrised (Xs, Y, Ths, U);
2. K3 ``cone_step`` — the forward map at (Xs, Y, Ths, U), over-relaxation
   alpha, the pre-projection PSD slots t1/t2/t3 (t = alpha f + (1-alpha) w
   + u), the w/u-update of the trace, SOC, box and cut slots, and the dual
   EMA of rho*ua, rho*ub, rho*uc;
3. K1 ``project_psd_ns_multi`` — the sign-schedule projection of t1, t2,
   t3 (``ops.polar.k1_plan``), w = P, u = t - w, and the dual EMA of rho*u1
   and rho*u2.

K2 and K3 each run one thread-block cluster of CTAs per node slot, each CTA
owning a band of rows (``k2k3_plan``), the per-slot sums added across the
cluster in rank order.

So the dual EMA of the JAX loop body (``admm.py:510-521`` there) lives in
the K3 and K1 epilogues, updated right after each u.  On the CPU the same
three steps run as plain torch (``zstep_plain``, ``cone_step_plain``,
``project_psd_ns_merged`` or ``project_psd`` plus ``psd_epilogue``), in the
order of operations of ``omc``, so float64 iterates match ``omc``.

With ``halpern`` (``omc``'s anchored scheme) K3 runs in its Halpern mode:
every pre-projection slot is blended with its anchor, the slot's w + u at
the call's start, as t <- b s0 + (1 - b) t with b = 1/(it + 2).

Every ``check_every`` iterations the bias-corrected EMA duals go through
the torch ``safe_dual_bound2`` (full fp32 matmuls), the best chunk by the
estimator is kept, and the early-exit flag is read on the host once.
The solver updates a clone of the state it is given in place.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import weakref

import torch

from omc_torch import kernels
from omc_torch.ops.cones import project_psd, project_soc
from omc_torch.ops.polar import project_psd_ns_multi, psd_epilogue
from omc_torch.sdp.relax import NodeBatch, safe_dual_bound2, separation_eigpairs


@dataclasses.dataclass
class ADMMState:
    # w: cone-slot variables; u: scaled duals (y = rho * u in the polar
    # cone).  Field order matches omc.sdp.admm.ADMMState (warm slices).
    w1: torch.Tensor  # (B, n+m, n+m)
    w2: torch.Tensor  # (B, n+k, n+k)
    w3: torch.Tensor  # (B, n, n)
    w4: torch.Tensor  # (B,)
    wsoc: torch.Tensor  # (B, k, 1+n)
    wbox: torch.Tensor  # (B, n, k)
    wa: torch.Tensor  # (B, L, k)
    wb: torch.Tensor  # (B, L, k)
    wc: torch.Tensor  # (B, L)
    u1: torch.Tensor
    u2: torch.Tensor
    u3: torch.Tensor
    u4: torch.Tensor
    usoc: torch.Tensor
    ubox: torch.Tensor
    ua: torch.Tensor
    ub: torch.Tensor
    uc: torch.Tensor
    X: torch.Tensor  # last primal iterate (scaled)
    Y: torch.Tensor
    Th: torch.Tensor
    U: torch.Tensor
    rho: torch.Tensor  # (B,) per-node ADMM penalty
    sX: torch.Tensor  # (B,) block scales: X = sX * Xs, Theta = sT * Ths
    sT: torch.Tensor
    sS: torch.Tensor  # (B,) Shor-row weight (unused by the base solver)

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "ADMMState":
        return cls(*leaves)

    def clone(self) -> "ADMMState":
        return ADMMState(*[
            x.clone(memory_format=torch.contiguous_format) for x in self.leaves()
        ])

    def replace(self, **kw) -> "ADMMState":
        return dataclasses.replace(self, **kw)


def init_admm_state(B, n, m, k, L, dtype=torch.float32, *, device,
                    sX=1.0, sT=1.0, sS=1.0, X0=None, Y0=None, Th0=None,
                    U0=None, rho: float = 0.02) -> ADMMState:
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

    return ADMMState(
        w1=z(B, n + m, n + m), w2=z(B, n + k, n + k), w3=z(B, n, n), w4=z(B),
        wsoc=z(B, k, 1 + n), wbox=z(B, n, k), wa=z(B, L, k), wb=z(B, L, k),
        wc=z(B, L),
        u1=z(B, n + m, n + m), u2=z(B, n + k, n + k), u3=z(B, n, n), u4=z(B),
        usoc=z(B, k, 1 + n), ubox=z(B, n, k), ua=z(B, L, k), ub=z(B, L, k),
        uc=z(B, L),
        X=prim(X0, (B, n, m), sX), Y=prim(Y0, (B, n, n), 1.0),
        Th=prim(Th0, (B, m, m), sT), U=prim(U0, (B, n, k), 1.0),
        rho=torch.full((B,), rho, dtype=dtype, device=device),
        sX=vec(sX), sT=vec(sT), sS=vec(sS),
    )


def set_slot_rho(state: ADMMState, rho_new) -> ADMMState:
    """Re-target per-slot penalties (the rho-portfolio path): the state
    stores scaled duals u = y / rho, so keeping y means u *= rho_old /
    rho_new.  The z-step is rho-free (``_gram1``): no refactorisation."""
    rho_new = torch.as_tensor(rho_new, dtype=state.rho.dtype, device=state.rho.device)
    r = state.rho / rho_new
    r3 = r[:, None, None]
    return state.replace(
        u1=state.u1 * r3, u2=state.u2 * r3, u3=state.u3 * r3,
        u4=state.u4 * r, usoc=state.usoc * r3, ubox=state.ubox * r3,
        ua=state.ua * r3, ub=state.ub * r3, uc=state.uc * r[:, None],
        rho=torch.broadcast_to(rho_new, state.rho.shape).clone(),
    )


def _outer_sum(w, x):
    """sum_l w_l x_l x_l' for w (B, L), x (B, L, n) -> (B, n, n)."""
    return (x * w[..., None]).transpose(-1, -2) @ x


def _forward(batch: NodeBatch, Xs, Y, Ths, U, k, sX, sT):
    """Affine slot map (with constants), including the U box slot."""
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
    v = torch.einsum("bln,bnk->blk", batch.cut_x, U)
    wa = v - batch.cut_lo
    wb = batch.cut_hi - v
    c = batch.cut_lo + batch.cut_hi
    bconst = torch.sum(-batch.cut_lo * batch.cut_hi, dim=-1)
    xYx = torch.sum((batch.cut_x @ Y) * batch.cut_x, dim=-1)
    wc = torch.sum(c * v, dim=-1) + bconst - xYx
    return w1, w2, w3, w4, wsoc, wbox, wa, wb, wc


def _adjoint(batch: NodeBatch, y1, y2, y3, y4, ysoc, ybox, ya, yb, yc,
             n, m, k, sX, sT):
    gX = sX * 2.0 * y1[..., :n, n:]
    gY = (
        y1[..., :n, :n]
        + y2[..., :n, :n]
        - y3
        - y4[..., None, None] * torch.eye(n, dtype=y3.dtype, device=y3.device)
        - _outer_sum(yc, batch.cut_x)
    )
    gTh = sT * y1[..., n:, n:]
    c = batch.cut_lo + batch.cut_hi
    coef = ya - yb + yc[..., None] * c
    gU = (
        2.0 * y2[..., :n, n:]
        + ysoc[..., 1:].transpose(-1, -2)
        + ybox
        + torch.einsum("bln,blk->bnk", batch.cut_x, coef)
    )
    return gX, gY, gTh, gU


def _gram1(batch: NodeBatch, k, dtype):
    """rho-independent Woodbury Gram G1 = I + V' D1^-1 V, (B, p, p) with
    p = 1 + L + L*k and D1 the per-block K'K diagonal (Y: 3, U: 4).
    Column order: [trace | chord rows l=1..L | interval directions (l, j)
    row-major].  Since Q is zero on the Y and U blocks, one Cholesky of G1
    serves every per-node penalty rho."""
    B, L = batch.cut_mask.shape
    n = batch.cut_x.shape[-1]
    dev = batch.cut_x.device
    cm = batch.cut_mask
    x = batch.cut_x * cm[..., None]  # zero padded cuts
    c = (batch.cut_lo + batch.cut_hi) * cm[..., None]
    XX = torch.einsum("bln,bpn->blp", x, x)
    CC = torch.einsum("blk,bpk->blp", c, c)
    p = 1 + L + L * k
    G = torch.zeros((B, p, p), dtype=dtype, device=dev)
    iY = 1.0 / 3.0
    iU = 1.0 / 4.0
    G[:, 0, 0] = n * iY
    tc = -torch.diagonal(XX, dim1=-2, dim2=-1) * iY
    G[:, 0, 1 : 1 + L] = tc
    G[:, 1 : 1 + L, 0] = tc
    G[:, 1 : 1 + L, 1 : 1 + L] = XX * XX * iY + XX * CC * iU
    cd = math.sqrt(2.0) * torch.einsum("blp,blk->blpk", XX, c) * iU
    G[:, 1 : 1 + L, 1 + L :] = cd.reshape(B, L, L * k)
    G[:, 1 + L :, 1 : 1 + L] = cd.reshape(B, L, L * k).transpose(-1, -2)
    eye_k = torch.eye(k, dtype=dtype, device=dev)
    dd = 2.0 * torch.einsum("blp,jk->bljpk", XX, eye_k) * iU
    G[:, 1 + L :, 1 + L :] = dd.reshape(B, L * k, L * k)
    G = G + torch.eye(p, dtype=dtype, device=dev)
    return G


def _Vt_apply(batch: NodeBatch, rY, rU, k):
    """V' r for the structured columns; rY (B,n,n), rU (B,n,k) -> (B,p)."""
    cm = batch.cut_mask
    x = batch.cut_x * cm[..., None]
    c = (batch.cut_lo + batch.cut_hi) * cm[..., None]
    B, L = cm.shape
    t0 = torch.diagonal(rY, dim1=-2, dim2=-1).sum(-1)[:, None]
    xrx = torch.sum((x @ rY) * x, dim=-1)
    xru = torch.einsum("bln,bnk->blk", x, rU)
    chord = -xrx + torch.einsum("blk,blk->bl", c, xru)
    dirs = math.sqrt(2.0) * xru.reshape(B, L * k)
    return torch.cat([t0, chord, dirs], dim=-1)


def _V_apply(batch: NodeBatch, s, n, k):
    """V s: (B,p) -> (rY (B,n,n), rU (B,n,k))."""
    cm = batch.cut_mask
    x = batch.cut_x * cm[..., None]
    c = (batch.cut_lo + batch.cut_hi) * cm[..., None]
    B, L = cm.shape
    s0 = s[:, 0]
    sch = s[:, 1 : 1 + L]
    sdir = s[:, 1 + L :].reshape(B, L, k)
    eye = torch.eye(n, dtype=s.dtype, device=s.device)
    rY = s0[:, None, None] * eye - _outer_sum(sch, x)
    rU = x.transpose(-1, -2) @ (sch[..., None] * c) + math.sqrt(2.0) * (
        x.transpose(-1, -2) @ sdir
    )
    return rY, rU


def solve_z(batch: NodeBatch, G1c, mask, sX, sT, rho_b, rY_rhs, rX_rhs,
            rTh_rhs, rU_rhs, n, k):
    """(Q + rho K'K)^{-1} rhs via the rho-free Woodbury identity (see
    ``_gram1``); rho_b is the per-node penalty (B,), sX/sT (B,1,1)."""
    r3 = rho_b[:, None, None]
    dX = mask[None] * (sX * sX) + r3 * 2.0 * sX * sX
    zX = rX_rhs / dX
    zY = rY_rhs / (3.0 * r3)
    zTh = rTh_rhs / (r3 * sT * sT)
    zU = rU_rhs / (4.0 * r3)
    s = _Vt_apply(batch, zY, zU, k)
    t = rho_b[:, None] * torch.cholesky_solve(s[..., None], G1c)[..., 0]
    vY, vU = _V_apply(batch, t, n, k)
    zY = zY - vY / (3.0 * r3)
    zU = zU - vU / (4.0 * r3)
    return zX, zY, zTh, zU


@dataclasses.dataclass
class _Consts:
    """Per-solve-call constants shared by the three steps."""

    batch: NodeBatch
    mask: torch.Tensor
    maskA: torch.Tensor
    G1c: torch.Tensor  # lower Cholesky factor of G1 (the plain z-step)
    G1i: torch.Tensor | None  # G1^-1 (K2; CUDA states only)
    offs: tuple
    cX: torch.Tensor
    cTh: torch.Tensor
    n: int
    m: int
    k: int
    L: int
    gamma: float
    alpha: float
    beta: float
    # Halpern mode: the anchors s0 = w + u of the nine slots at the call's
    # start (``ANCHOR_SLOTS`` order), or None
    anchors: tuple | None = None


# the slots a Halpern anchor blends, in omc's order: (w, u) field names
ANCHOR_SLOTS = (("w1", "u1"), ("w2", "u2"), ("w3", "u3"), ("w4", "u4"), ("wsoc", "usoc"),
                ("wbox", "ubox"), ("wa", "ua"), ("wb", "ub"), ("wc", "uc"))


def halpern_anchors(st: "ADMMState") -> tuple:
    """The Halpern anchors s0 = w + u of every slot of ``st``."""
    return tuple((getattr(st, w) + getattr(st, u)).contiguous() for w, u in ANCHOR_SLOTS)


# --------------------------------------------------------------------------
# K2 and K3: the plan
# --------------------------------------------------------------------------

# K2 and K3 run 256 threads a CTA and one cluster of C CTAs per node slot
K2K3_THREADS = 256
K2K3_WARPS = K2K3_THREADS // 32
# the cluster sizes (16 is beyond the portable 8; the kernels allow it)
K2K3_CLUSTERS = (1, 2, 4, 8, 16)
# K3's C is the largest with B C at most this many CTAs, so that small
# batches spread over the card's 132 SMs while large ones keep small
# clusters (on an H100, more CTAs measured slower at every batch of 32 and
# more: fewer large clusters fit a GPC at once); K2's the same where
# p = 1 + L + L k > K2_GI_MAX_FAST, else up to K2_TARGET_CTAS (three K2 CTAs
# fit an SM; each stages the p x p G1^-1)
K2K3_TARGET_CTAS = 128
K2_TARGET_CTAS = 256
K2_GI_MAX_FAST = 64
# then K2 doubles C until its band of sym(zY) takes at most this many bytes
# of shared memory, and K3 until a CTA has at most this many rows of Y
# (both measured at 250 x 250 nodes)
K2_BAND_MAX = 49152
K3_BAND_ROWS = 128
# shared memory a CTA may use on an H100 (227 KB)
K2K3_MAX_SMEM = 232448
# K2 stages G1^-1 in shared memory up to p = 1 + L + L k of this size
K2_GI_MAX = 112
# the edge of the tiles of Theta (K2) and X (K3) a warp transposes
K2K3_TILE = 16
# the chord sums a thread keeps in registers at once
K2K3_CHUNK = 8


def _cdiv(a, b):
    return -(-a // b)


def _odd(n):
    return n | 1


def k2_smem_bytes(n, m, k, L, C, band, xsmem=True, ws=False, dtype=torch.float32, usmem=True):
    """K2's dynamic shared memory (``omc_k2_smem_bytes``) at ``dtype``: per-
    warp partials of a chunk of chords, the CTA's partials of s, the
    cluster's gathered and their sums (one CTA: its own; float64), the
    masked cuts (``xsmem``), the mask, the cut-slot duals, s, t, the band's
    zU (``usmem``; else in U's own rows), G1^-1 (p <= K2_GI_MAX), a Theta
    tile pair a warp, and with ``band`` the band of sym(zY) at an odd row
    stride, each a value of ``dtype``.
    With ``ws`` the partials, their sums, s, t and the two L k interval-slot
    vectors are in the global workspace (``k2_ws_doubles``)."""
    e = dtype.itemsize
    per = 8 // e  # values a double's room holds
    P = 1 + L + L * k
    bw = _cdiv(n, C)
    sums = 0 if ws else per * (2 + C if C > 1 else 1) * P + 2 * L * k + 2 * P
    f = (per * K2K3_WARPS * (1 + K2K3_CHUNK) + sums + (L * n if xsmem else 0) + 2 * L
         + (bw * k if usmem else 0) + (P * P if P <= K2_GI_MAX else 0)
         + K2K3_WARPS * 2 * K2K3_TILE * (K2K3_TILE + 1))
    return e * (f + (bw * _odd(n) if band else 0))


def k2_ws_doubles(n, m, k, L, C, dtype=torch.float32):
    """K2's global workspace a slot (``omc_k2_ws_doubles``): for each of the
    C CTAs its partials of s and their sums (float64), the two interval-slot
    vectors, s and t (values of ``dtype``); then t's rows as the cluster
    forms them."""
    per = 8 // dtype.itemsize
    P = 1 + L + L * k
    return C * _cdiv(per * 2 * P + 2 * L * k + 2 * P, per) + _cdiv(P, per)


def k3_smem_bytes(n, m, k, L, C, xsmem=True, slsmem=True, ws=False, dtype=torch.float32,
                  usmem=True):
    """K3's dynamic shared memory (``omc_k3_smem_bytes``) at ``dtype``:
    per-warp partials of a chunk of chords, the CTA's partials (tr Y, x_l'Y
    x_l, ||tsoc_j[1:]||^2, x_l'U_j), the cluster's gathered and their sums
    (one CTA: its own; with ``ws`` in the global workspace,
    ``k3_ws_doubles``), the cuts (``xsmem``; all float64), then values of
    ``dtype``: U and the band's tsoc (``usmem``; else U read from the input
    and the tsoc entries kept in wsoc's), tsoc_j[0], an X tile a warp, and
    (``slsmem``) the trace, interval and chord slots rank 0 stages."""
    e = dtype.itemsize
    NP = 1 + L + k + L * k
    return e * ((8 // e) * (K2K3_WARPS * (1 + K2K3_CHUNK)
                            + (0 if ws else (2 + C if C > 1 else 1) * NP)
                            + (L * n if xsmem else 0))
                + ((n * k + k * _cdiv(n, C)) if usmem else 0) + k
                + K2K3_WARPS * K2K3_TILE * (K2K3_TILE + 1)
                + (8 * L * k + 4 * L + 2 if slsmem else 0))


def k3_ws_doubles(n, m, k, L, C):
    """K3's global workspace a slot (``omc_k3_ws_doubles``): each CTA's
    partials and their sums."""
    return 2 * C * (1 + L + k + L * k)


def k2k3_plan(B: int, n: int, m: int, k: int, L: int, cluster=None, band=None,
              dtype=torch.float32) -> dict:
    """K2's and K3's launches: one cluster of C CTAs per node slot (grid B C),
    CTA r owning rows [r n / C, (r + 1) n / C) of Y and U (and of t1-t3) and
    [r m / C, (r + 1) m / C) of Theta in K3; X's entries and the 16 x 16
    tiles of Theta (K2) and X (K3) go to the cluster's warps in turn.  C
    (``k2_cluster``, ``k3_cluster``) follows the rules beside
    ``K2K3_TARGET_CTAS``.
    K2 keeps its band of sym(zY) in shared memory ("smem") where it fits,
    else in the CTA's own rows of Y ("rows"); either kernel stages the cut
    vectors in shared memory where they fit ("smem"), else reads them from
    the input ("global"), and K3's rank 0 its small slots likewise; K3
    stages U and its band's SOC entries where some layout fits them
    ("smem"), else every CTA reads U from the input and keeps the entries
    in the slot's own (``k3_u`` "global"), and K2 keeps its band's zU in
    U's own rows where it does not fit beside the rest (``k2_u``
    "global"): the same bits either way.  ``cluster`` (both kernels) and ``band`` force a
    choice, for timing and checks.  Raises where a shape needs more shared
    memory than a CTA has.

    Where a CTA's partials (C p float64 gathered) would not fit
    (``k2_sums``/``k3_sums`` "global"), they go to a global workspace of
    ``k2_ws``/``k3_ws`` doubles a slot (K2 then spreads t's rows over the
    cluster).  ``dtype`` float64 plans the float64 builds: every byte count
    from the kernels' formulas at 8 bytes a value (the band rule too)."""
    if min(B, n, m, k) < 1 or L < 0:
        raise ValueError(f"K2/K3: unsupported shape B={B}, n={n}, m={m}, k={k}, L={L}")
    if band not in (None, "smem", "rows"):
        raise ValueError(f"K2: band {band!r} not in ('smem', 'rows')")
    if cluster is None:
        cap = min(n, m)

        def largest(target):
            return max([c for c in K2K3_CLUSTERS if B * c <= target and c <= cap] or [1])

        C3 = largest(K2K3_TARGET_CTAS)
        while C3 < K2K3_CLUSTERS[-1] and 2 * C3 <= cap and _cdiv(n, C3) > K3_BAND_ROWS:
            C3 *= 2
        C2 = largest(K2_TARGET_CTAS if 1 + L + L * k <= K2_GI_MAX_FAST else K2K3_TARGET_CTAS)
        while (C2 < K2K3_CLUSTERS[-1] and 2 * C2 <= cap
               and dtype.itemsize * _cdiv(n, C2) * _odd(n) > K2_BAND_MAX):
            C2 *= 2
    elif cluster in K2K3_CLUSTERS:
        C2 = C3 = cluster
    else:
        raise ValueError(f"K2/K3: cluster {cluster!r} not in {K2K3_CLUSTERS}")

    def fit2(C, ws, us):
        for bd in (band,) if band else ("smem", "rows"):
            if not us and bd == "smem":
                continue  # zU in U's rows only beside the band in Y's rows
            for xsm in (True, False):
                if k2_smem_bytes(n, m, k, L, C, bd == "smem", xsm, ws, dtype,
                                 us) <= K2K3_MAX_SMEM:
                    return bd, xsm
        return None

    def fit3(C, ws, us):
        for xsm, slm in ((True, True), (True, False), (False, True), (False, False)):
            if k3_smem_bytes(n, m, k, L, C, xsm, slm, ws, dtype, us) <= K2K3_MAX_SMEM:
                return xsm, slm
        return None

    # the partials in shared memory where they fit, else in the workspace;
    # K3's U staged where either fits it, else read from the input
    for us2 in (True, False):
        ws2 = fit2(C2, False, us2) is None
        f2 = fit2(C2, ws2, us2)
        if f2 is not None:
            break
    for us3 in (True, False):
        ws3 = fit3(C3, False, us3) is None
        f3 = fit3(C3, ws3, us3)
        if f3 is not None:
            break
    if f2 is None or f3 is None:
        raise ValueError(f"K2/K3: n={n}, m={m}, k={k}, L={L} needs more than {K2K3_MAX_SMEM} "
                         "bytes of shared memory a CTA")
    bd, xs2 = f2
    xs3, sl3 = f3
    where = {True: "smem", False: "global"}
    return dict(k2_cluster=C2, k3_cluster=C3, threads=K2K3_THREADS, k2_rows=_cdiv(n, C2),
                k3_rows=_cdiv(n, C3), band=bd, k2_xs=where[xs2], k3_xs=where[xs3],
                k3_slots=where[sl3], k2_u=where[us2], k3_u=where[us3],
                k2_sums=where[not ws2], k3_sums=where[not ws3],
                k2_smem=k2_smem_bytes(n, m, k, L, C2, bd == "smem", xs2, ws2, dtype, us2),
                k3_smem=k3_smem_bytes(n, m, k, L, C3, xs3, sl3, ws3, dtype, us3),
                k2_ws=k2_ws_doubles(n, m, k, L, C2, dtype) if ws2 else 0,
                k3_ws=k3_ws_doubles(n, m, k, L, C3) if ws3 else 0)


# The kernels' parameter blocks (K2, K3 and shor_k's K8c): the solve loop
# passes the same tensors every iteration, so their checks and the packing
# run once.  A block is reused only while every operand is the same live
# tensor object (held by a weak reference, so the cache keeps no memory
# alive) at the same address; the last few blocks are kept.
_PACKED: dict = {}
_PACKED_PER_SHARD = 16
_PACKED_MAX = _PACKED_PER_SHARD
_SLOTS = operator.attrgetter("w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc",
                             "wbox", "ubox", "wa", "ua", "wb", "ub", "wc", "uc")
_PRIMAL = operator.attrgetter("X", "Y", "Th", "U", "sX", "sT", "rho")
_CUTS = operator.attrgetter("cut_x", "cut_lo", "cut_hi", "cut_mask")


def _packed(key, tensors, scalars, build):
    """The block ``build()`` packed for ``key``, reused while ``tensors``
    (every operand) and ``scalars`` are those it was packed for."""
    ptrs = tuple(t.data_ptr() for t in tensors)
    hit = _PACKED.get(key)
    if (hit is not None and hit[1] == ptrs and hit[2] == scalars
            and all(r() is t for r, t in zip(hit[0], tensors))):
        return hit[3]
    prm = build()
    while len(_PACKED) >= _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    _PACKED[key] = (tuple(map(weakref.ref, tensors)), ptrs, scalars, prm)
    return prm


def reserve_packed_blocks(shards: int):
    """Keep the last blocks of ``shards`` solver calls (a mesh of that many
    shards), not of one."""
    global _PACKED_MAX
    _PACKED_MAX = max(_PACKED_MAX, _PACKED_PER_SHARD * int(shards))


# --------------------------------------------------------------------------
# K2: z-step
# --------------------------------------------------------------------------


def zstep_plain(c: _Consts, st: ADMMState):
    """Plain version of K2: the adjoint of the slot residuals and the
    Woodbury z-step, exactly as the ``omc`` loop body.  Returns (Xs, Y,
    Ths, U) with Y and Ths symmetrised."""
    cm = c.batch.cut_mask
    offs = c.offs
    sX = st.sX[:, None, None]
    sT = st.sT[:, None, None]
    rho_b = st.rho
    r3 = rho_b[:, None, None]
    rX, rY, rTh, rU = _adjoint(
        c.batch,
        st.w1 - st.u1 - offs[0], st.w2 - st.u2 - offs[1],
        st.w3 - st.u3 - offs[2], st.w4 - st.u4 - offs[3],
        st.wsoc - st.usoc - offs[4], st.wbox - st.ubox - offs[5],
        (st.wa - st.ua - offs[6]) * cm[..., None],
        (st.wb - st.ub - offs[7]) * cm[..., None],
        (st.wc - st.uc - offs[8]) * cm,
        c.n, c.m, c.k, sX, sT,
    )
    Xs, Y, Ths, U = solve_z(
        c.batch, c.G1c, c.mask, sX, sT, rho_b, r3 * rY, r3 * rX - c.cX,
        r3 * rTh - c.cTh, r3 * rU, c.n, c.k,
    )
    Y = 0.5 * (Y + Y.transpose(-1, -2))
    Ths = 0.5 * (Ths + Ths.transpose(-1, -2))
    return Xs, Y, Ths, U


def zstep(c: _Consts, st: ADMMState, shor: bool = False, cluster=None, band=None):
    """K2 wrapper: writes (Xs, Y, Ths, U) into ``st.X/Y/Th/U`` -- with
    ``shor`` only Y and U, whose z-step the Shor relaxation shares (its X
    and Theta come from K8a).  A CPU state runs ``zstep_plain``; a CUDA
    state launches ``csrc/k2_zstep.cu`` (``k2k3_plan``'s cluster per node
    slot; ``cluster`` and ``band`` force its choices) or raises."""
    dev = st.w1.device
    if dev.type == "cpu":
        for dst, src in zip((st.X, st.Y, st.Th, st.U), zstep_plain(c, st)):
            if not (shor and (dst is st.X or dst is st.Th)):
                dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"zstep: unsupported device {dev}")
    dt = st.w1.dtype
    prm = _packed(("K2", id(c), id(st), shor, cluster, band), _k2_tensors(c, st), (c.gamma,),
                  lambda: _k2_params(c, st, shor, k2k3_plan(st.rho.shape[0], c.n, c.m, c.k,
                                                              c.L, cluster, band, dt)))
    kernels.launch("K2", kernels.entry("omc_k2_zstep", dt), prm, dev)


def _k2_tensors(c: _Consts, st: ADMMState) -> tuple:
    """Every K2 operand, gathered cheaply for the reuse test."""
    return _SLOTS(st) + _PRIMAL(st) + _CUTS(c.batch) + (c.maskA, c.mask, c.G1i)


def _k2_params(c: _Consts, st: ADMMState, shor: bool, plan: dict):
    """Validate K2's operands and pack its parameter block (the build of
    the state's dtype)."""
    dev, dt = st.w1.device, st.w1.dtype
    B = st.rho.shape[0]
    n, m, k, L = c.n, c.m, c.k, c.L
    p = 1 + L + L * k
    shapes = _state_shapes(B, n, m, k, L)
    prm = kernels.block(kernels.K2Params, dt)

    def chk(name, t, shape):
        return kernels.check(name, t, shape, dev, dt)

    for name in ("w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc",
                 "usoc", "wbox", "ubox", "wa", "ua", "wb", "ub", "wc", "uc"):
        setattr(prm, name, chk(name, getattr(st, name), shapes[name]))
    b = c.batch
    prm.cut_x = chk("cut_x", b.cut_x, (B, L, n))
    prm.cut_lo = chk("cut_lo", b.cut_lo, (B, L, k))
    prm.cut_hi = chk("cut_hi", b.cut_hi, (B, L, k))
    prm.cut_mask = chk("cut_mask", b.cut_mask, (B, L))
    prm.maskA = chk("maskA", c.maskA, (n, m))
    prm.mask = chk("mask", c.mask, (n, m))
    prm.sX = chk("sX", st.sX, (B,))
    prm.sT = chk("sT", st.sT, (B,))
    prm.rho = chk("rho", st.rho, (B,))
    prm.G1i = chk("G1i", c.G1i, (B, p, p))
    prm.Y = chk("Y", st.Y, (B, n, n))
    prm.U = chk("U", st.U, (B, n, k))
    if not shor:
        prm.Xs = chk("X", st.X, (B, n, m))
        prm.Ths = chk("Th", st.Th, (B, m, m))
    prm.B, prm.n, prm.m, prm.k, prm.L = B, n, m, k, L
    prm.C, prm.band = plan["k2_cluster"], int(plan["band"] == "smem")
    prm.xsmem = int(plan["k2_xs"] == "smem")
    prm.usmem = int(plan["k2_u"] == "smem")
    prm.gamma = float(c.gamma)
    _workspace(prm, B * plan["k2_ws"], dev)
    return prm


def _workspace(prm, doubles, dev):
    """The block's global workspace of ``doubles`` float64 (none: null),
    kept alive by the block itself."""
    if doubles:
        prm.workspace = torch.empty(doubles, dtype=torch.float64, device=dev)
        prm.ws = prm.workspace.data_ptr()


# --------------------------------------------------------------------------
# K3: forward map + cone step
# --------------------------------------------------------------------------


def cone_step_plain(c: _Consts, st: ADMMState, acc, it: int = 0):
    """Plain version of K3 at the current (Xs, Y, Ths, U) of ``st``:
    returns ``(t1, t2, t3, rest, acc_new)`` where ``rest`` holds the new
    (w4, u4, wsoc, usoc, wbox, ubox, wa, ua, wb, ub, wc, uc) and
    ``acc_new`` the updated EMA of (rho ua, rho ub, rho uc).  With
    ``c.anchors`` (Halpern mode) every pre-projection slot is blended with
    its anchor, t <- b s0 + (1 - b) t with b = 1 / (it + 2), ``it`` the
    iteration's index in the call, in the compute dtype as ``omc``."""
    b = c.batch
    cm = b.cut_mask
    alpha = c.alpha
    f = _forward(b, st.X, st.Y, st.Th, st.U, c.k, st.sX[:, None, None],
                 st.sT[:, None, None])

    def relax_mix(fz, w):
        return alpha * fz + (1.0 - alpha) * w

    if c.anchors is not None:
        hb = 1.0 / (torch.tensor(it, dtype=st.rho.dtype, device=st.rho.device) + 2.0)

        def hal(t, j):
            return hb * c.anchors[j] + (1.0 - hb) * t
    else:
        def hal(t, j):
            return t

    t1 = hal(relax_mix(f[0], st.w1) + st.u1, 0)
    t2 = hal(relax_mix(f[1], st.w2) + st.u2, 1)
    t3 = hal(relax_mix(f[2], st.w3) + st.u3, 2)
    t4 = hal(relax_mix(f[3], st.w4) + st.u4, 3)
    w4 = torch.clamp(t4, min=0.0)
    u4 = t4 - w4
    tsoc = hal(relax_mix(f[4], st.wsoc) + st.usoc, 4)
    pt, pw = project_soc(tsoc[..., 0], tsoc[..., 1:])
    wsoc = torch.cat([pt[..., None], pw], dim=-1)
    usoc = tsoc - wsoc
    tbox = hal(relax_mix(f[5], st.wbox) + st.ubox, 5)
    wbox = torch.minimum(torch.maximum(tbox, b.U_lo), b.U_hi)
    ubox = tbox - wbox
    ta = hal(relax_mix(f[6], st.wa) + st.ua, 6)
    wa = torch.clamp(ta, min=0.0)
    ua = (ta - wa) * cm[..., None]
    tb = hal(relax_mix(f[7], st.wb) + st.ub, 7)
    wb = torch.clamp(tb, min=0.0)
    ub = (tb - wb) * cm[..., None]
    tc = hal(relax_mix(f[8], st.wc) + st.uc, 8)
    wc = torch.clamp(tc, min=0.0)
    uc = (tc - wc) * cm
    beta = c.beta
    rb3 = st.rho[:, None, None]
    acc_new = (
        acc[0] + beta * (rb3 * ua - acc[0]),
        acc[1] + beta * (rb3 * ub - acc[1]),
        acc[2] + beta * (st.rho[:, None] * uc - acc[2]),
    )
    rest = (w4, u4, wsoc, usoc, wbox, ubox, wa, ua, wb, ub, wc, uc)
    return t1, t2, t3, rest, acc_new


_REST = ("w4", "u4", "wsoc", "usoc", "wbox", "ubox", "wa", "ua", "wb", "ub",
         "wc", "uc")


def cone_step(c: _Consts, st: ADMMState, ts, acc, cluster=None, it: int = 0):
    """K3 wrapper: writes the pre-projection PSD slots into ``ts`` (t1, t2,
    t3), updates the non-PSD slots of ``st`` and the EMA accumulators
    ``acc`` (rho ua, rho ub, rho uc) in place; with ``c.anchors`` in the
    Halpern mode at the call's iteration ``it``.  A CPU state runs
    ``cone_step_plain``; a CUDA state launches ``csrc/k3_cone.cu``
    (``k2k3_plan``'s cluster per node slot; ``cluster`` forces a size, for
    timing) or raises."""
    dev = st.w1.device
    if dev.type == "cpu":
        t1, t2, t3, rest, acc_new = cone_step_plain(c, st, acc, it)
        for dst, src in zip(ts, (t1, t2, t3)):
            dst.copy_(src)
        for name, src in zip(_REST, rest):
            getattr(st, name).copy_(src)
        for dst, src in zip(acc, acc_new):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"cone_step: unsupported device {dev}")
    prm = _packed(("K3", id(c), id(st), cluster), _k3_tensors(c, st, ts, acc),
                  (c.alpha, c.beta), lambda: _k3_params(c, st, ts, acc, cluster))
    # the iteration index changes every launch: set on the block, not a key
    prm.hal_it = it
    kernels.launch("K3", kernels.entry("omc_k3_cone", st.w1.dtype), prm, dev)


def _k3_tensors(c: _Consts, st: ADMMState, ts, acc) -> tuple:
    """Every K3 operand, gathered cheaply for the reuse test."""
    b = c.batch
    return (_SLOTS(st) + _PRIMAL(st) + _CUTS(b) + (b.U_lo, b.U_hi) + tuple(ts) + tuple(acc)
            + tuple(c.anchors or ()))


def _k3_params(c: _Consts, st: ADMMState, ts, acc, cluster):
    """Validate K3's operands and pack its parameter block (the build of
    the state's dtype)."""
    dev, dt = st.w1.device, st.w1.dtype
    B = st.rho.shape[0]
    n, m, k, L = c.n, c.m, c.k, c.L
    plan = k2k3_plan(B, n, m, k, L, cluster, dtype=dt)
    shapes = _state_shapes(B, n, m, k, L)
    prm = kernels.block(kernels.K3Params, dt)

    def chk(name, t, shape):
        return kernels.check(name, t, shape, dev, dt)

    prm.Xs = chk("X", st.X, (B, n, m))
    prm.Y = chk("Y", st.Y, (B, n, n))
    prm.Ths = chk("Th", st.Th, (B, m, m))
    prm.U = chk("U", st.U, (B, n, k))
    for name in ("w1", "u1", "w2", "u2", "w3", "u3") + _REST:
        setattr(prm, name, chk(name, getattr(st, name), shapes[name]))
    prm.t1 = chk("t1", ts[0], shapes["w1"])
    prm.t2 = chk("t2", ts[1], shapes["w2"])
    prm.t3 = chk("t3", ts[2], shapes["w3"])
    prm.acc_a = chk("acc_a", acc[0], (B, L, k))
    prm.acc_b = chk("acc_b", acc[1], (B, L, k))
    prm.acc_c = chk("acc_c", acc[2], (B, L))
    b = c.batch
    prm.cut_x = chk("cut_x", b.cut_x, (B, L, n))
    prm.cut_lo = chk("cut_lo", b.cut_lo, (B, L, k))
    prm.cut_hi = chk("cut_hi", b.cut_hi, (B, L, k))
    prm.cut_mask = chk("cut_mask", b.cut_mask, (B, L))
    prm.U_lo = chk("U_lo", b.U_lo, (B, n, k))
    prm.U_hi = chk("U_hi", b.U_hi, (B, n, k))
    prm.sX = chk("sX", st.sX, (B,))
    prm.sT = chk("sT", st.sT, (B,))
    prm.rho = chk("rho", st.rho, (B,))
    prm.B, prm.n, prm.m, prm.k, prm.L = B, n, m, k, L
    prm.C, prm.xsmem = plan["k3_cluster"], int(plan["k3_xs"] == "smem")
    prm.slsmem = int(plan["k3_slots"] == "smem")
    prm.usmem = int(plan["k3_u"] == "smem")
    prm.alpha, prm.beta = float(c.alpha), float(c.beta)
    if c.anchors is not None:
        for (w, _), name, h in zip(ANCHOR_SLOTS, kernels.K3_ANCHORS, c.anchors):
            setattr(prm, name, chk(name, h, shapes[w]))
    _workspace(prm, B * plan["k3_ws"], dev)
    return prm


def _state_shapes(B, n, m, k, L):
    return {
        "w1": (B, n + m, n + m), "u1": (B, n + m, n + m),
        "w2": (B, n + k, n + k), "u2": (B, n + k, n + k),
        "w3": (B, n, n), "u3": (B, n, n), "w4": (B,), "u4": (B,),
        "wsoc": (B, k, 1 + n), "usoc": (B, k, 1 + n),
        "wbox": (B, n, k), "ubox": (B, n, k),
        "wa": (B, L, k), "ua": (B, L, k), "wb": (B, L, k), "ub": (B, L, k),
        "wc": (B, L), "uc": (B, L),
    }


def g1_factors(G1, cuda: bool):
    """G1's lower Cholesky factor (the plain z-step) and, for a CUDA state,
    G1^-1 (K2): both from one float64 factor.  G1 >= I, so ||G1^-1|| <= 1
    and K2 forms t = rho G1^-1 s as one product.  A CPU state factors in its
    own dtype and has no inverse."""
    if not cuda:
        return torch.linalg.cholesky(G1), None
    L64 = torch.linalg.cholesky(G1.double())  # column-major on CUDA
    return L64.to(G1.dtype).contiguous(), torch.cholesky_inverse(L64).to(G1.dtype).contiguous()


def make_consts(A, mask, batch: NodeBatch, state: ADMMState, n, m, k, gamma,
                alpha, beta, dtype):
    """The per-call constants: G1's Cholesky factor and, for a CUDA state,
    its inverse (``g1_factors``), linear objective coefficients and the
    constant slot offsets (forward map at zero)."""
    B, L = batch.cut_mask.shape
    dev = state.rho.device
    sX = state.sX[:, None, None]
    sT = state.sT[:, None, None]
    G1c, G1i = g1_factors(_gram1(batch, k, dtype), dev.type == "cuda")
    cX = -sX * (mask * A)[None]
    cTh = (sT * 0.5 / gamma) * torch.eye(m, dtype=dtype, device=dev)[None]
    zeros = (
        torch.zeros((B, n, m), dtype=dtype, device=dev),
        torch.zeros((B, n, n), dtype=dtype, device=dev),
        torch.zeros((B, m, m), dtype=dtype, device=dev),
        torch.zeros((B, n, k), dtype=dtype, device=dev),
    )
    offs = _forward(batch, *zeros, k, sX, sT)
    return _Consts(
        batch=batch, mask=mask, maskA=(mask * A).contiguous(), G1c=G1c, G1i=G1i,
        offs=offs, cX=cX, cTh=cTh, n=n, m=m, k=k, L=L, gamma=float(gamma),
        alpha=float(alpha), beta=float(beta),
    )


def iteration(c: _Consts, st: ADMMState, ts, acc, psd_method: str, it: int = 0):
    """One in-place ADMM iteration, the call's ``it``-th: K2 -> K3 -> K1
    (see the module docstring).  ``acc`` holds the five EMA accumulators
    (rho u1, rho u2, rho ua, rho ub, rho uc); ``ts`` the t1/t2/t3 scratch.
    Each step is its kernel's wrapper, so a CPU state runs the plain
    versions and a CUDA state the kernels."""
    ws = (st.w1, st.w2, st.w3)
    us = (st.u1, st.u2, st.u3)
    accs = (acc[0], acc[1], None)
    zstep(c, st)
    cone_step(c, st, ts, acc[2:], it=it)
    if psd_method == "ns":
        project_psd_ns_multi(list(ts), w_out=ws, u_out=us, acc=accs,
                             rho=st.rho, beta=c.beta)
    else:
        psd_epilogue(ts, [project_psd(t) for t in ts], ws, us, accs,
                     st.rho, c.beta)


def make_admm_solver(n: int, m: int, k: int, L: int, gamma: float, *,
                     iters: int = 400, dtype=torch.float32,
                     alpha: float = 1.6, psd_method: str = "auto",
                     check_every: int = 2000, halpern: bool = False,
                     ema_iters: int = 1500):
    """Build the batched ADMM solver (port of
    ``omc.sdp.admm.make_admm_solver`` without its unreachable ``adapt_rho``
    branch).

    ``psd_method``: "ns" (sign schedule, kernel K1 on the GPU; float32),
    "eigh" (exact: LAPACK on the CPU, K4's Jacobi and K4s on the GPU, where
    it runs in float64), or "auto" (ns for float32, eigh for float64).
    ``check_every``: iterations between on-device safe-bound evaluations
    and early-exit checks.  ``halpern``: the anchored scheme of ``omc``,
    s_{k+1} = b_k s_0 + (1 - b_k) T(s_k) with b_k = 1/(k + 2), the anchors
    s_0 = w + u of every slot taken at the call's start and k counted from
    the call's first iteration (K3's Halpern mode on the GPU).  The ADMM
    penalty is each state's own ``rho`` (``init_admm_state``,
    ``set_slot_rho``)."""
    if psd_method == "auto":
        psd_method = "eigh" if dtype == torch.float64 else "ns"
    if psd_method not in ("ns", "eigh"):
        raise ValueError(f"psd_method {psd_method!r}")

    def solve(A, mask, batch: NodeBatch, ub_bar, state: ADMMState,
              n_iters=None, target=None, group=None):
        """Run up to ``n_iters`` (default ``iters``) iterations from a clone
        of ``state``; returns ``(state, out)``.

        ``target`` (optional, (B,)): per-slot certified-bound target; the
        loop stops once every group's best on-device estimate clears its
        target (-inf slots count as cleared).  ``group`` ((B,) int): slot
        -> node grouping for the rho portfolio — a node is done when any of
        its replica slots clears."""
        dev = state.rho.device
        if dev.type == "cuda":
            kernels.require_full_fp32()
            kernels.require_cuda_dtype("halpern" if halpern else "base", dtype)
            want = "ns" if dtype == torch.float32 else "eigh"
            if psd_method != want:
                raise ValueError(f'the CUDA path projects {dtype} with psd_method="{want}"')
        ni = int(iters if n_iters is None else n_iters)
        A = torch.as_tensor(A, device=dev).to(dtype).contiguous()
        mask = torch.as_tensor(mask, device=dev).to(dtype).contiguous()
        batch_t = batch.map(lambda x: torch.as_tensor(x, device=dev).to(dtype).contiguous())
        B = batch_t.cut_mask.shape[0]
        st = state.clone()
        beta = 1.0 / max(ema_iters, 1)
        c = make_consts(A, mask, batch_t, st, n, m, k, gamma, alpha, beta, dtype)
        if halpern:
            c.anchors = halpern_anchors(st)
        ts = (torch.empty_like(st.w1), torch.empty_like(st.w2),
              torch.empty_like(st.w3))
        if group is None:
            group = torch.arange(B, device=dev)
        group = torch.as_tensor(group, device=dev).to(torch.int64)
        group = group - group.min()
        if target is not None:
            target = torch.as_tensor(target, device=dev).to(dtype)

        def zero_acc():
            return [torch.zeros_like(st.u1), torch.zeros_like(st.u2),
                    torch.zeros_like(st.ua), torch.zeros_like(st.ub),
                    torch.zeros_like(st.uc)]

        ema = zero_acc()
        b_ybar = zero_acc()
        b_lb = torch.full((B,), -math.inf, dtype=dtype, device=dev)
        b_est = b_lb.clone()
        beta_t = torch.tensor(beta, dtype=dtype, device=dev)
        it = 0
        done = False
        while it < ni and not done:
            chunk = min(check_every, ni - it)
            for i in range(chunk):
                iteration(c, st, ts, ema, psd_method, it + i)
            # bias correction (the EMA starts from zero duals), in the
            # compute dtype
            corr = 1.0 - (1.0 - beta_t) ** torch.tensor(float(it + chunk), dtype=dtype, device=dev)
            inv = 1.0 / torch.maximum(corr, beta_t)
            ybar = [inv * a for a in ema]
            lb, lb_est = safe_dual_bound2(
                A, mask, batch_t, ybar[0], ybar[1], ybar[2], ybar[3], ybar[4],
                gamma, k, ub_bar,
            )
            # per-slot best chunk by the estimator
            take = lb_est > b_est
            for j in range(5):
                shp = (B,) + (1,) * (ybar[j].ndim - 1)
                b_ybar[j] = torch.where(take.reshape(shp), ybar[j], b_ybar[j])
            b_lb = torch.where(take, lb, b_lb)
            b_est = torch.where(take, lb_est, b_est)
            it += chunk
            if target is not None:
                cleared = (b_est >= target).to(torch.int32)
                gmax = torch.zeros((B,), dtype=torch.int32, device=dev).scatter_reduce(
                    0, group, cleared, reduce="amax"
                )
                done = bool(torch.all((gmax[group] | cleared) > 0))

        sep_w, sep_V = separation_eigpairs(st.U, st.Y)
        sX = st.sX[:, None, None]
        sT = st.sT[:, None, None]
        out = {
            "X": sX * st.X, "Y": st.Y, "Th": sT * st.Th, "U": st.U,
            "y1": b_ybar[0], "y2": b_ybar[1],
            "ya": b_ybar[2], "yb": b_ybar[3], "yc": b_ybar[4],
            # the best chunk's margin-guarded on-device safe bound
            "lb_dev": b_lb,
            # float64-tracking estimator (not a sound bound)
            "lb_est": b_est,
            "iters_run": torch.full((B,), it, dtype=torch.int32, device=dev),
            "sep_w": sep_w, "sep_V": sep_V,
        }
        return st, out

    return solve


def to_numpy_out(out: dict) -> dict:
    """One host fetch of a solver output dict."""
    return {key: val.detach().cpu().numpy() for key, val in out.items()}


def apply_best_duals(state: ADMMState, out: dict) -> ADMMState:
    """The visit's best-chunk duals of the base slots as scaled duals
    (u = y / rho)."""
    r3 = state.rho[:, None, None]
    return state.replace(
        u1=out["y1"] / r3, u2=out["y2"] / r3, ua=out["ya"] / r3,
        ub=out["yb"] / r3, uc=out["yc"] / state.rho[:, None],
    )


__all__ = [
    "ADMMState", "init_admm_state", "set_slot_rho", "make_admm_solver",
    "zstep", "zstep_plain", "cone_step", "cone_step_plain", "solve_z",
    "apply_best_duals", "k2k3_plan",
]
