"""Node-batch data and certified safe dual bounds (port of the main-path
parts of ``omc/sdp/relax.py``; see that module's docstring for the
relaxation and the certification argument).

The node relaxation (disjunctive-cut path, reference lines 1491-1857):

    min  1/2 sum_Omega (X_ij - A_ij)^2 + 1/(2 gamma) tr(Theta)
    s.t. M1 = [Y X; X' Theta] PSD, M2 = [Y U; U' I_k] PSD, I - Y PSD,
         k - tr(Y) >= 0, U in [U_lo, U_hi], (1, U_j) in SOC,
         per cut l: lo_l <= U' x_l <= hi_l and the chord row.

``omc``'s PDHG (primal-dual hybrid gradient) solver of this relaxation,
its reference solver (``sdp_method="pdhg"``), is here too: ``PDHGState``,
``init_state``, its own operator pair ``_forward``/``_adjoint``,
``_estimate_opnorm`` and ``make_solver``.

Lower bounds do not come from the solver's objective: ``safe_dual_bound2``
evaluates the partial Lagrangian dual in closed form for any dual iterate
(multipliers re-projected onto their cones; Y, Theta, X, U minimised over a
compact kept set that contains every master-feasible point with objective
<= ub_bar).  It is written here in torch for the on-device screen;
``safe_dual_bound`` / ``host_certified_bound`` are the numpy float64 host
certification, as in ``omc``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omc_torch import kernels
from omc_torch.ops.cones import (
    K4_PATHS,
    _cuda,
    eigvalsh,
    k4_jacobi,
    k4_plan,
    project_psd,
    project_soc,
)


@dataclasses.dataclass
class NodeBatch:
    """Per-node constraint data, padded to fixed shapes.

    cut_x:    (B, L, n)   unit breakpoint vectors
    cut_lo:   (B, L, k)   region lower bounds on v = U' x   (0 when padded)
    cut_hi:   (B, L, k)   region upper bounds on v          (0 when padded)
    cut_mask: (B, L)      1.0 for real cuts
    U_lo:     (B, n, k)   box lower bounds on U
    U_hi:     (B, n, k)   box upper bounds on U
    """

    cut_x: object
    cut_lo: object
    cut_hi: object
    cut_mask: object
    U_lo: object
    U_hi: object

    def fields(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def map(self, fn) -> "NodeBatch":
        return NodeBatch(*[fn(x) for x in self.fields()])


def margin_rel_default(dtype):
    """The floating-point safety-margin constant: 1e-10 for float64 host
    certification, 3e-5 for compute-dtype on-device screening."""
    if dtype in (np.float64, torch.float64):
        return 1e-10
    return 3e-5


def safe_dual_bound2(A, mask, batch: NodeBatch, y1, y2, ya, yb, yc, gamma, k,
                     ub_bar, margin_rel=None):
    """``(lb_valid, lb_est)`` from one torch evaluation (port of
    ``omc.sdp.relax.safe_dual_bound2``).

    ``lb_valid`` is the margin-guarded safe bound; ``lb_est`` omits the
    floating-point margin and tracks what the float64 host evaluation of
    the same duals returns — an estimator for early-exit decisions, not a
    sound bound.  The off-support X-block of S1 is zeroed and compensated
    by a diagonal shift delta = ||q_off||_F (see the ``omc`` docstring)."""
    n, m = A.shape[-2], A.shape[-1]
    dt = A.dtype
    obs = mask > 0
    zero = torch.zeros((), dtype=dt, device=A.device)
    # pre-zero the off-support q block before projecting
    S1in = -y1
    S1in = torch.cat(
        [
            torch.cat([S1in[..., :n, :n], torch.where(obs, S1in[..., :n, n:], zero)], dim=-1),
            torch.cat([torch.where(obs.T, S1in[..., n:, :n], zero), S1in[..., n:, n:]], dim=-1),
        ],
        dim=-2,
    )
    S1 = project_psd(S1in)
    # zero the residual off-support q exactly; compensating shift delta
    q_full = S1[..., :n, n:]
    q_off = torch.where(obs, zero, q_full)
    delta = torch.sqrt(torch.sum(q_off * q_off, dim=(-2, -1)))
    # rescale so that R1 + delta I <= I/(2 gamma)
    lmaxR1 = eigvalsh(S1[..., n:, n:])[..., -1] + delta
    c_scale = torch.clamp((0.5 / gamma) / torch.clamp(lmaxR1, min=1e-30), max=1.0)
    S1 = S1 * c_scale[..., None, None]
    delta = delta * c_scale
    S2 = project_psd(-y2)
    P1, q, R1 = S1[..., :n, :n], S1[..., :n, n:], S1[..., n:, n:]
    q = torch.where(obs, q, zero)
    P2, E = S2[..., :n, :n], S2[..., n:, n:]
    D = S2[..., :n, n:]
    cmask = batch.cut_mask
    alpha = torch.clamp(-ya, min=0.0) * cmask[..., None]
    beta = torch.clamp(-yb, min=0.0) * cmask[..., None]
    lam = torch.clamp(-yc, min=0.0) * cmask

    lo, hi = batch.cut_lo, batch.cut_hi
    c = lo + hi
    bconst = torch.sum(-lo * hi, dim=-1)  # (B, L)

    # Y block: inf over {0 <= Y <= I, tr Y <= k} of <G_Y, Y>
    G_Y = -(P1 + P2) + (batch.cut_x * lam[..., None]).transpose(-1, -2) @ batch.cut_x
    G_Y = 0.5 * (G_Y + G_Y.transpose(-1, -2))
    wY = eigvalsh(G_Y)
    y_term = torch.sum(torch.clamp(wY[..., :k] - delta[..., None], max=0.0), dim=-1)

    # Theta block: inf over {Theta >= 0, tr Theta <= T} of <G_Th, Theta>
    T_th = 2.0 * gamma * ub_bar
    G_Th = (0.5 / gamma) * torch.eye(m, dtype=dt, device=A.device) - R1
    G_Th = 0.5 * (G_Th + G_Th.transpose(-1, -2))
    wT = eigvalsh(G_Th)
    th_term = T_th * torch.clamp(wT[..., 0] - delta, max=0.0)

    # X block: per-entry clamped quadratic over |X_ij| <= R_X on the support
    R_X = float(np.sqrt(2.0 * gamma * ub_bar))
    x_star = torch.clamp(A + 2.0 * q, -R_X, R_X)
    obs_val = 0.5 * (x_star - A) ** 2 - 2.0 * q * x_star
    x_term = torch.sum(torch.where(obs, obs_val, zero), dim=(-2, -1))

    # U block: linear over the box
    W_U = -2.0 * D - torch.einsum(
        "bln,blk->bnk", batch.cut_x, alpha - beta + lam[..., None] * c
    )
    u_term = torch.sum(torch.minimum(W_U * batch.U_lo, W_U * batch.U_hi), dim=(-2, -1))

    const = (
        torch.sum(alpha * lo, dim=(-2, -1))
        - torch.sum(beta * hi, dim=(-2, -1))
        - torch.sum(lam * bconst, dim=-1)
        - torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
    )

    lb = y_term + th_term + x_term + u_term + const
    if margin_rel is None:
        margin_rel = margin_rel_default(dt)
    scale = (
        1.0
        + torch.abs(lb)
        + ub_bar
        + torch.sqrt(torch.sum(S1 * S1, dim=(-2, -1)))
        + torch.sqrt(torch.sum(S2 * S2, dim=(-2, -1)))
    )
    return lb - margin_rel * scale, lb


# K5's geometry (csrc/k5_separation.cu): one CTA a matrix holds the packed
# lower triangle of U U' - Y in shared memory, in float64 ("tridiag64")
# where it fits, else in float32 ("tridiag32"), for the two smallest
# eigenpairs; K4's paths (``ops.cones.k4_plan``) take the rest
K5_SMEM_MAX = 232448
K5_THREADS = 512  # a tridiag-path CTA's threads (omc_k5_threads), at every order
K5_TRIDIAG = ("tridiag64", "tridiag32")
K5_PATHS = K5_TRIDIAG + K4_PATHS


def k5_smem_bytes(d, path):
    """Shared memory of one tridiag-path CTA (``omc_k5_smem_bytes``), or 0
    where it does not fit (d > 224 in float64, d > 309 in float32): 16 d + 8
    doubles (the tridiagonal, each reflector's tau and scale, the step's p
    and p_r v_r, two vectors and their LU factors, eight scalars), the
    packed triangle in the path's type, and two pivot-flag bytes an index,
    rounded up to 16."""
    size = 8 if path == "tridiag64" else 4
    b = 8 * (16 * d + 8) + size * (d * (d + 1) // 2) + 2 * d
    b = -(-b // 16) * 16
    return b if b <= K5_SMEM_MAX else 0


def k5_plan(B, d, path=None, dtype=torch.float32):
    """K5's path for ``B`` separations of order ``d``: the float64 triangle
    where it fits one CTA, else the float32 triangle, else K4's plan for
    the eigenpairs.  Float64 operands (``dtype``) never take the float32
    triangle: beyond the float64 one they go to K4's paths in float64.
    ``path`` (one of ``K5_PATHS``) forces one; a tridiag path raises
    ``ValueError`` where its triangle does not fit (or, "tridiag32", for
    float64 operands).  Returns a dict: ``path``, ``smem_bytes`` and
    ``threads`` a CTA (the kernel's exports; 0 on K4's paths)."""
    tridiag = K5_TRIDIAG[:1] if dtype == torch.float64 else K5_TRIDIAG
    if path is None:
        fits = [p for p in tridiag if k5_smem_bytes(d, p)]
        path = fits[0] if fits else k4_plan(B, d, 2, dtype=dtype, sep=True)["path"]
    if path not in K5_PATHS:
        raise ValueError(f"K5 path must be one of {K5_PATHS}, got {path!r}")
    if path in K4_PATHS:
        return dict(path=path, smem_bytes=0, threads=0, k4=k4_plan(B, d, 2, path, dtype))
    if path not in tridiag:
        raise ValueError(f"K5's {path} path takes float32 operands, not {dtype}")
    if not k5_smem_bytes(d, path):
        raise ValueError(f"K5's {path} path: d={d} does not fit")
    return dict(path=path, smem_bytes=k5_smem_bytes(d, path), threads=K5_THREADS)


def separation_eigpairs(U, Y):
    """The two smallest eigenpairs of the symmetrised U U' - Y, the
    branching separation of every family (``omc``: ``eigh(U U' - Y)``
    sliced to two).  ``U`` (B, n, k), ``Y`` (B, n, n); returns ``sep_w``
    (B, 2) ascending and ``sep_V`` (B, n, 2).  Kernel K5 on a CUDA tensor,
    on the path ``k5_plan`` gives; ``separation_eigpairs_plain`` on a CPU
    tensor (in its dtype: float32, or float64 through the float64 build).
    Neither fixes the eigenvectors' signs, as ``omc`` does not."""
    if U.device.type == "cpu":
        return separation_eigpairs_plain(U, Y)
    return _k5_launch(U, Y, k5_plan(Y.shape[0], Y.shape[-1], dtype=Y.dtype))


def _k5_launch(U, Y, plan, iters=None):
    """Launch K5 on ``plan``'s path (K4's kernel on K4's paths), with its
    count a matrix in ``iters`` (optional int32 (B,): inverse iterations on
    the tridiag paths, Jacobi sweeps on K4's)."""
    dev = _cuda("K5", Y)
    B, d = Y.shape[0], Y.shape[-1]
    nout = min(2, d)
    if plan["path"] in K4_PATHS:
        return k4_jacobi(None, 2, nout, U=U, Y=Y, sweeps=iters, path=plan["path"])
    U, Y = U.contiguous(), Y.contiguous()
    dt = Y.dtype
    p = kernels.block(kernels.K5Params, dt)
    p.B, p.d, p.k, p.nout = B, d, U.shape[-1], nout
    p.path = K5_TRIDIAG.index(plan["path"])
    p.U = kernels.check("U", U, (B, d, p.k), dev, dt)
    p.Y = kernels.check("Y", Y, (B, d, d), dev, dt)
    if iters is None:
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
    p.iters = kernels.check("iters", iters, (B,), dev, torch.int32)
    w = torch.empty((B, nout), dtype=dt, device=dev)
    V = torch.empty((B, d, nout), dtype=dt, device=dev)
    p.w, p.V = w.data_ptr(), V.data_ptr()
    if B:
        kernels.launch("K5", kernels.entry("omc_k5_separation", dt), p, dev)
    return w, V


def separation_eigpairs_plain(U, Y):
    """Plain version of K5: ``einsum``, ``torch.linalg.eigh`` and slice."""
    M = torch.einsum("bik,bjk->bij", U, U) - Y
    M = 0.5 * (M + M.transpose(-1, -2))
    w, V = torch.linalg.eigh(M)
    return w[..., :2], V[..., :, :2]


# ---------------------------------------------------------------------------
# PDHG relaxation solver (omc's reference solver, ``sdp_method="pdhg"``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PDHGState:
    """PDHG iterate; field order matches ``omc.sdp.relax.PDHGState`` (warm
    slices, the multi-process wire).  Primal matrices are stored scaled (X
    = sX * X, Theta = sT * Th internally)."""

    X: torch.Tensor  # (B, n, m)
    Y: torch.Tensor  # (B, n, n)
    Th: torch.Tensor  # (B, m, m)
    U: torch.Tensor  # (B, n, k)
    Xb: torch.Tensor  # extrapolated copies (z-bar)
    Yb: torch.Tensor
    Thb: torch.Tensor
    Ub: torch.Tensor
    y1: torch.Tensor  # (B, n+m, n+m)
    y2: torch.Tensor  # (B, n+k, n+k)
    y3: torch.Tensor  # (B, n, n)
    y4: torch.Tensor  # (B,)
    ysoc: torch.Tensor  # (B, k, 1+n)
    ya: torch.Tensor  # (B, L, k)
    yb: torch.Tensor  # (B, L, k)
    yc: torch.Tensor  # (B, L)

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "PDHGState":
        return cls(*leaves)

    def clone(self) -> "PDHGState":
        return PDHGState(*[x.clone(memory_format=torch.contiguous_format)
                           for x in self.leaves()])


def init_state(B, n, m, k, L, dtype=torch.float32, *, device, sX=1.0, sT=1.0,
               X0=None, Y0=None, Th0=None, U0=None) -> PDHGState:
    """Zero state, optionally warm-started from an (unscaled) primal point,
    e.g. the incumbent (U V, U U', V'V, U), feasible for every node's core
    cones."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def prim(val, shape, scale):
        if val is None:
            return z(*shape)
        v = torch.as_tensor(val, dtype=dtype, device=device) / scale
        return torch.broadcast_to(v, shape).clone()

    X = prim(X0, (B, n, m), sX)
    Y = prim(Y0, (B, n, n), 1.0)
    Th = prim(Th0, (B, m, m), sT)
    U = prim(U0, (B, n, k), 1.0)
    return PDHGState(
        X=X, Y=Y, Th=Th, U=U, Xb=X.clone(), Yb=Y.clone(), Thb=Th.clone(), Ub=U.clone(),
        y1=z(B, n + m, n + m), y2=z(B, n + k, n + k), y3=z(B, n, n), y4=z(B),
        ysoc=z(B, k, 1 + n), ya=z(B, L, k), yb=z(B, L, k), yc=z(B, L),
    )


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _forward(batch: NodeBatch, Xs, Y, Ths, U, k: int, sX, sT):
    """PDHG's constraint operator on the scaled primal: the values of the
    eight constraint slots (X = sX * Xs, Theta = sT * Ths; U's box is kept
    by a clip, so it has no slot)."""
    X = sX * Xs
    Th = sT * Ths
    Xt = X.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    n = Y.shape[-1]
    w1 = torch.cat([torch.cat([Y, X], dim=-1), torch.cat([Xt, Th], dim=-1)], dim=-2)
    eye_k = torch.broadcast_to(_eye(k, U), Ut.shape[:-2] + (k, k))
    w2 = torch.cat([torch.cat([Y, U], dim=-1), torch.cat([Ut, eye_k], dim=-1)], dim=-2)
    w3 = _eye(n, Y) - Y
    w4 = k - torch.diagonal(Y, dim1=-2, dim2=-1).sum(-1)
    ones = torch.ones(U.shape[:-2] + (k, 1), dtype=U.dtype, device=U.device)
    wsoc = torch.cat([ones, Ut], dim=-1)  # (B, k, 1+n)
    v = batch.cut_x @ U
    wa = v - batch.cut_lo
    wb = batch.cut_hi - v
    c = batch.cut_lo + batch.cut_hi
    bconst = torch.sum(-batch.cut_lo * batch.cut_hi, dim=-1)  # (B, L)
    xYx = torch.sum((batch.cut_x @ Y) * batch.cut_x, dim=-1)
    wc = torch.sum(c * v, dim=-1) + bconst - xYx
    return w1, w2, w3, w4, wsoc, wa, wb, wc


def _adjoint(batch: NodeBatch, y1, y2, y3, y4, ysoc, ya, yb, yc, n, m, k, sX, sT):
    """Adjoint of PDHG's scaled operator: duals -> gradients on (Xs, Y,
    Ths, U)."""
    gX = sX * 2.0 * y1[..., :n, n:]
    gY = (
        y1[..., :n, :n]
        + y2[..., :n, :n]
        - y3
        - y4[..., None, None] * _eye(n, y3)
        - (batch.cut_x * yc[..., None]).transpose(-1, -2) @ batch.cut_x
    )
    gTh = sT * y1[..., n:, n:]
    c = batch.cut_lo + batch.cut_hi
    coef = ya - yb + yc[..., None] * c  # (B, L, k)
    gU = (
        2.0 * y2[..., :n, n:]
        + ysoc[..., 1:].transpose(-1, -2)  # (B, n, k)
        + batch.cut_x.transpose(-1, -2) @ coef
    )
    return gX, gY, gTh, gU


def _estimate_opnorm(batch: NodeBatch, n, m, k, sX, sT, iters=20, seed=0):
    """Per-node power iteration on K'K for ||K|| of the scaled operator,
    from a normal start drawn by a ``torch.Generator`` seeded with ``seed``
    (``omc`` draws from ``jax.random.PRNGKey(seed)``: another start, so the
    two estimates agree to the iteration's accuracy, not to rounding)."""
    B, L = batch.cut_mask.shape
    dtype, dev = batch.cut_x.dtype, batch.cut_x.device
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)

    X = normal(B, n, m)
    Y = normal(B, n, n)
    Y = 0.5 * (Y + Y.transpose(-1, -2))
    Th = normal(B, m, m)
    Th = 0.5 * (Th + Th.transpose(-1, -2))
    U = normal(B, n, k)

    def nrm(*zs):
        return torch.sqrt(sum(torch.sum(a * a, dim=tuple(range(1, a.ndim))) for a in zs))

    z0 = (torch.zeros((B, n, m), dtype=dtype, device=dev),
          torch.zeros((B, n, n), dtype=dtype, device=dev),
          torch.zeros((B, m, m), dtype=dtype, device=dev),
          torch.zeros((B, n, k), dtype=dtype, device=dev))
    offs = _forward(batch, *z0, k, sX, sT)
    cm = batch.cut_mask
    for _ in range(iters):
        s = nrm(X, Y, Th, U)[:, None, None] + 1e-30
        X, Y, Th, U = X / s, Y / s, Th / s, U / s
        ws = _forward(batch, X, Y, Th, U, k, sX, sT)
        w1, w2, w3, w4, wsoc, wa, wb, wc = [w - o for w, o in zip(ws, offs)]
        wa, wb, wc = wa * cm[..., None], wb * cm[..., None], wc * cm
        X, Y, Th, U = _adjoint(batch, w1, w2, w3, w4, wsoc, wa, wb, wc, n, m, k, sX, sT)
        Y = 0.5 * (Y + Y.transpose(-1, -2))
        Th = 0.5 * (Th + Th.transpose(-1, -2))
    return torch.sqrt(nrm(X, Y, Th, U)) * 1.05 + 1e-3  # ||K'K z|| -> ||K||^2


def make_solver(n: int, m: int, k: int, L: int, gamma: float, *,
                iters: int = 400, dtype=torch.float32, omega: float = 1.0,
                sX: float = 1.0, sT: float = 1.0):
    """Build the batched PDHG relaxation solver (port of
    ``omc.sdp.relax.make_solver``).

    Returns ``solve(A, mask, batch, ub_bar, state, n_iters=None,
    opnorm=None) -> (state, out)``: ``out`` carries the unscaled primal (X,
    Y, Th, U), the dual blocks the host certificate needs and the
    separation eigenpairs of U U' - Y.  ``omega`` balances the primal and
    dual steps; ``sX``/``sT`` are the block scales.  ``opnorm`` ((B,),
    optional) replaces ``_estimate_opnorm``'s per-node estimate of ||K||.
    Its hot ops are the exact PSD projections (``ops.cones.project_psd``:
    K4, or K4s for d <= 8, on the GPU) and the separation (K5); the rest is
    plain tensor work, as in ``omc``."""

    def solve(A, mask, batch: NodeBatch, ub_bar, state: PDHGState, n_iters=None,
              opnorm=None):
        dev = state.Y.device
        if dev.type == "cuda":
            kernels.require_full_fp32()
            kernels.require_cuda_dtype("pdhg", dtype)
        ni = int(iters if n_iters is None else n_iters)
        A = torch.as_tensor(A, device=dev).to(dtype)
        mask = torch.as_tensor(mask, device=dev).to(dtype)
        b = batch.map(lambda x: torch.as_tensor(x, device=dev).to(dtype).contiguous())
        R_Xs = float(np.sqrt(2.0 * gamma * ub_bar)) / sX
        T_s = 2.0 * gamma * ub_bar / sT
        if opnorm is None:
            opnorm = _estimate_opnorm(b, n, m, k, sX, sT)
        opnorm = torch.as_tensor(opnorm, device=dev).to(dtype)
        tau = (omega / opnorm)[:, None, None]
        sig = 1.0 / (omega * opnorm)
        sig3 = sig[:, None, None]
        cm = b.cut_mask
        eye_m, eye_n = _eye(m, A), _eye(n, A)
        s = state
        for _ in range(ni):
            # ---- dual ascent at the extrapolated primal
            w1, w2, w3, w4, wsoc, wa, wb, wc = _forward(b, s.Xb, s.Yb, s.Thb, s.Ub, k, sX, sT)
            t1 = s.y1 + sig3 * w1
            y1 = t1 - project_psd(t1)
            t2 = s.y2 + sig3 * w2
            y2 = t2 - project_psd(t2)
            t3 = s.y3 + sig3 * w3
            y3 = t3 - project_psd(t3)
            y4 = torch.clamp(s.y4 + sig * w4, max=0.0)
            tsoc = s.ysoc + sig3 * wsoc
            pt, pw = project_soc(tsoc[..., 0], tsoc[..., 1:])
            ysoc = tsoc - torch.cat([pt[..., None], pw], dim=-1)
            ya = torch.clamp(s.ya + sig3 * wa, max=0.0) * cm[..., None]
            yb = torch.clamp(s.yb + sig3 * wb, max=0.0) * cm[..., None]
            yc = torch.clamp(s.yc + sig[:, None] * wc, max=0.0) * cm

            # ---- primal descent
            gX, gY, gTh, gU = _adjoint(b, y1, y2, y3, y4, ysoc, ya, yb, yc, n, m, k, sX, sT)
            Xn = s.X - tau * gX
            Yn = s.Y - tau * gY
            Thn = s.Th - tau * gTh
            Un = s.U - tau * gU
            Yn = 0.5 * (Yn + Yn.transpose(-1, -2))
            Thn = 0.5 * (Thn + Thn.transpose(-1, -2))
            # prox of the objective and the box keep-sets (all separable):
            # X, 1/2 (sX Xs - A)^2 per observed entry
            Xn = torch.where(mask > 0, (Xn + tau * sX * A) / (1.0 + tau * sX * sX), Xn)
            Xn = torch.clamp(Xn, -R_Xs, R_Xs)
            # Theta, the linear (sT / 2 gamma) tr(Ths)
            Thn = Thn - (tau * (sT * 0.5 / gamma)) * eye_m
            d_th = torch.diagonal(Thn, dim1=-2, dim2=-1)
            Thn = Thn + (torch.clamp(d_th, 0.0, T_s) - d_th)[..., None, :] * eye_m
            Thn = torch.clamp(Thn, -T_s, T_s)
            d_y = torch.diagonal(Yn, dim1=-2, dim2=-1)
            Yn = Yn + (torch.clamp(d_y, 0.0, 1.0) - d_y)[..., None, :] * eye_n
            Yn = torch.clamp(Yn, -1.0, 1.0)
            Un = torch.minimum(torch.maximum(Un, b.U_lo), b.U_hi)
            s = PDHGState(
                X=Xn, Y=Yn, Th=Thn, U=Un,
                Xb=2.0 * Xn - s.X, Yb=2.0 * Yn - s.Y, Thb=2.0 * Thn - s.Th, Ub=2.0 * Un - s.U,
                y1=y1, y2=y2, y3=y3, y4=y4, ysoc=ysoc, ya=ya, yb=yb, yc=yc,
            )
        sep_w, sep_V = separation_eigpairs(s.U, s.Y)
        out = {
            "X": sX * s.X, "Y": s.Y, "Th": sT * s.Th, "U": s.U,
            "y1": s.y1, "y2": s.y2, "ya": s.ya, "yb": s.yb, "yc": s.yc,
            "sep_w": sep_w, "sep_V": sep_V,
        }
        return s, out

    return solve


# ---------------------------------------------------------------------------
# float64 host certification (numpy, as in omc.sdp.relax)
# ---------------------------------------------------------------------------


def safe_dual_bound(A, mask, batch, y1, y2, ya, yb, yc, gamma, k, ub_bar,
                    margin_rel=1e-10):
    """Margin-guarded safe dual bound evaluated in numpy float64 (the
    numpy evaluation of ``omc.sdp.relax.safe_dual_bound2``)."""
    n, m = A.shape[-2], A.shape[-1]

    def _psd(Mat):
        Mat = 0.5 * (Mat + np.swapaxes(Mat, -1, -2))
        w, V = np.linalg.eigh(Mat)
        # V max(w, 0) V' as one BLAS product (a three-operand einsum loops
        # in C: minutes at the order 4,200 of an n = m = 2,100 block)
        return (V * np.maximum(w, 0.0)[..., None, :]) @ np.swapaxes(V, -1, -2)

    S1in = -y1
    obs = mask > 0
    obsT = obs.T
    S1in = np.concatenate(
        [
            np.concatenate(
                [S1in[..., :n, :n], np.where(obs, S1in[..., :n, n:], 0.0)], axis=-1
            ),
            np.concatenate(
                [np.where(obsT, S1in[..., n:, :n], 0.0), S1in[..., n:, n:]],
                axis=-1,
            ),
        ],
        axis=-2,
    )
    S1 = _psd(S1in)
    q_full = S1[..., :n, n:]
    q_off = np.where(obs, 0.0, q_full)
    delta = np.sqrt(np.sum(q_off * q_off, axis=(-2, -1)))
    lmaxR1 = np.linalg.eigvalsh(S1[..., n:, n:])[..., -1] + delta
    c_scale = np.minimum(1.0, (0.5 / gamma) / np.maximum(lmaxR1, 1e-30))
    S1 = S1 * c_scale[..., None, None]
    delta = delta * c_scale
    S2 = _psd(-y2)
    P1, q, R1 = S1[..., :n, :n], S1[..., :n, n:], S1[..., n:, n:]
    q = np.where(obs, q, 0.0)
    P2, E = S2[..., :n, :n], S2[..., n:, n:]
    D = S2[..., :n, n:]
    cmask = batch.cut_mask
    alpha = np.maximum(-ya, 0.0) * cmask[..., None]
    beta = np.maximum(-yb, 0.0) * cmask[..., None]
    lam = np.maximum(-yc, 0.0) * cmask

    lo, hi = batch.cut_lo, batch.cut_hi
    c = lo + hi
    bconst = np.sum(-lo * hi, axis=-1)

    G_Y = -(P1 + P2) + np.einsum("bl,bln,blp->bnp", lam, batch.cut_x, batch.cut_x)
    G_Y = 0.5 * (G_Y + np.swapaxes(G_Y, -1, -2))
    wY = np.linalg.eigh(G_Y)[0]
    y_term = np.sum(np.minimum(wY[..., :k] - delta[..., None], 0.0), axis=-1)

    T_th = 2.0 * gamma * ub_bar
    G_Th = (0.5 / gamma) * np.eye(m, dtype=A.dtype) - R1
    G_Th = 0.5 * (G_Th + np.swapaxes(G_Th, -1, -2))
    wT = np.linalg.eigh(G_Th)[0]
    th_term = T_th * np.minimum(wT[..., 0] - delta, 0.0)

    R_X = np.sqrt(2.0 * gamma * ub_bar)
    x_star = np.clip(A + 2.0 * q, -R_X, R_X)
    obs_val = 0.5 * (x_star - A) ** 2 - 2.0 * q * x_star
    x_term = np.sum(np.where(mask > 0, obs_val, 0.0), axis=(-2, -1))

    W_U = -2.0 * D - np.einsum(
        "bln,blk->bnk", batch.cut_x, alpha - beta + lam[..., None] * c
    )
    u_term = np.sum(np.minimum(W_U * batch.U_lo, W_U * batch.U_hi), axis=(-2, -1))

    const = (
        np.sum(alpha * lo, axis=(-2, -1))
        - np.sum(beta * hi, axis=(-2, -1))
        - np.sum(lam * bconst, axis=-1)
        - np.trace(E, axis1=-2, axis2=-1)
    )
    lb = y_term + th_term + x_term + u_term + const
    scale = (
        1.0
        + np.abs(lb)
        + ub_bar
        + np.sqrt(np.sum(S1 * S1, axis=(-2, -1)))
        + np.sqrt(np.sum(S2 * S2, axis=(-2, -1)))
    )
    return lb - margin_rel * scale


def host_certified_bound(A, mask, batch: NodeBatch, out: dict, gamma, k, ub_bar):
    """Recompute the safe bound on the host in float64 from solver outputs
    (tensors on any device, or numpy arrays)."""
    f = lambda a: _np(a).astype(np.float64)
    hb = NodeBatch(*[f(x) for x in batch.fields()])
    return safe_dual_bound(
        f(A), f(mask), hb, f(out["y1"]), f(out["y2"]), f(out["ya"]),
        f(out["yb"]), f(out["yc"]), float(gamma), k, float(ub_bar),
        margin_rel=1e-10,
    )


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# warm-start slices
# ---------------------------------------------------------------------------


def state_to_host(state, compress=np.float32) -> list:
    """Fetch a whole batch solver state to the host, one transfer per
    field (not per node).  Returns a flat list of (B, ...) host arrays in
    the state's field order."""
    return [_np(x).astype(compress) for x in state.leaves()]


def host_state_slice(host_leaves: list, i: int) -> list:
    """Node ``i``'s warm-start slice from ``state_to_host`` output."""
    return [x[i] for x in host_leaves]


def apply_warm_slices(base_leaves, slices):
    """Overwrite rows of host template leaves with per-node slice lists (in
    place).  A slice from a solve with a different cut capacity is copied
    row-truncated / zero-padded along its leading axis (rows past a node's
    real count are masked, so this is lossless); structurally incompatible
    slices keep the template's values."""
    for li, base in enumerate(base_leaves):
        tgt = base.shape[1:]  # per-node shape
        for i, sl in enumerate(slices):
            if sl is None or li >= len(sl):
                continue
            v = np.asarray(sl[li], dtype=base.dtype)
            if v.shape == tgt:
                base[i] = v
            elif v.ndim == len(tgt) and len(tgt) >= 1 and v.shape[1:] == tgt[1:]:
                r = min(tgt[0], v.shape[0])
                base[i][:r] = v[:r]
                if r < tgt[0]:
                    base[i][r:] = 0.0
    return base_leaves
