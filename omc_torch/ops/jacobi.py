"""A vectorised torch mirror of the parallel Jacobi schedule of kernels K4
and K5 (``omc_torch/csrc/k4_jacobi.cu``).

The kernels run on the GPU only; this mirror runs the same algorithm on any
device and dtype, so that the CPU tests can hold the schedule, the rotation
formula and the stopping rule against LAPACK.  It is not on any solver
path: there the CPU takes ``torch.linalg.eigh`` (``omc_torch.ops.cones``).

Schedule.  A sweep is ``N - 1`` rounds of the round-robin tournament over
``N = d`` players (``d + 1`` for odd ``d``: the extra player is a bye, never
a zero row, so no spurious eigenvalue 0 enters the spectrum).  In round
``r`` pair 0 is ``(N - 1, r)`` and pair ``a >= 1`` is
``((r + a) mod (N - 1), (r - a) mod (N - 1))``; the ``N / 2`` pairs of a
round are disjoint, so their rotations apply together: A <- J' A J with J
the product of the round's rotations, V <- V J.

Rotation (Golub & Van Loan, sym.schur2): tau = (a_qq - a_pp) / (2 a_pq),
t = sign(tau) / (|tau| + hypot(1, tau)), c = 1 / sqrt(1 + t^2), s = t c;
then a_pp -= t a_pq, a_qq += t a_pq, a_pq = a_qp = 0 exactly.  Rows and
columns rotate in Rutishauser's form x - s (y + r x), y + s (x - r y) with
r = s / (1 + c): the rounding error is relative to the change, so the late
sweeps' small angles do not erode the orthogonality of V (the plain form
c x - s y loses it linearly in d: 1.6e-4 against LAPACK's 9e-6 at d = 100
in float32, and the projection misses the 1e-5 bar).

Stopping rule.  A pair is skipped when |a_pq| <= max(eps sqrt|a_pp|
sqrt|a_qq|, eps ||A||_F / (4 d)); the sweep loop stops after the first
sweep that rotates no pair, or after ``MAX_SWEEPS`` sweeps.  The relative
term is Demmel and Veselic's high-accuracy test; the floor, at the rounding
level of the whole matrix, ends the sweeps on rank-deficient matrices
(projections of PSD matrices feed them) whose null block is rounding
noise, and moves no eigenvalue by more than eps ||A||_F / 4.  A non-finite
input makes the floor NaN, so every pair rotates until the cap and the
outputs are NaN.
"""

from __future__ import annotations

import torch

from omc_torch.ops.polar import tf32x3_matmul

# sweeps before the loop gives up (kJacobiMaxSweeps in csrc/common.cuh);
# a matrix whose sweep count is MAX_SWEEPS + 1 hit the cap.  Float32
# matrices up to d = 200, rank-deficient ones included, stop within 14
# sweeps in this mirror, float64 ones within 16.
MAX_SWEEPS = 30


def round_robin(d: int):
    """The rounds of one sweep: a list of (p, q) index tensors per round,
    with p < q and the bye's pair left out."""
    N = d + (d & 1)
    rounds = []
    for r in range(N - 1):
        ps, qs = [], []
        for a in range(N // 2):
            if a == 0:
                x, y = N - 1, r
            else:
                x, y = (r + a) % (N - 1), (r - a) % (N - 1)
            p, q = min(x, y), max(x, y)
            if q < d:
                ps.append(p)
                qs.append(q)
        rounds.append((torch.tensor(ps, dtype=torch.long), torch.tensor(qs, dtype=torch.long)))
    return rounds


def _rot0(x, y, s, tau):
    """c x - s y in Rutishauser's form x - s (y + tau x), tau = s / (1 + c):
    the rounding error is relative to the change, not to x."""
    return x - s * (y + tau * x)


def _rot1(x, y, s, tau):
    """s x + c y as y + s (x - tau y)."""
    return y + s * (x - tau * y)


def jacobi_eigh(M, max_sweeps: int = MAX_SWEEPS):
    """Eigenvalues (ascending), eigenvectors and sweep counts of a batch of
    symmetric (..., d, d) matrices by the K4 schedule.  ``M`` is
    symmetrised first.  Returns ``(w, V, sweeps)``: ``sweeps[b]`` is the
    sweep that rotated no pair, or ``max_sweeps + 1`` at the cap."""
    shape = M.shape
    d = shape[-1]
    A = M.reshape(-1, d, d)
    A = 0.5 * (A + A.transpose(-1, -2))
    Bn = A.shape[0]
    dt, dev = A.dtype, A.device
    eps = torch.finfo(dt).eps
    V = torch.eye(d, dtype=dt, device=dev).expand(Bn, d, d).clone()
    normF = torch.sqrt(torch.sum(A * A, dim=(-2, -1)))
    tiny = torch.where(torch.isfinite(normF), eps * normF / (4.0 * d),
                       torch.full_like(normF, float("nan")))
    sweeps = torch.full((Bn,), max_sweeps + 1, dtype=torch.int32, device=dev)
    active = torch.ones((Bn,), dtype=torch.bool, device=dev)
    rounds = [(p.to(dev), q.to(dev)) for p, q in round_robin(d)]
    bidx = torch.arange(Bn, device=dev)[:, None]
    for sweep in range(1, max_sweeps + 1):
        rotated = torch.zeros((Bn,), dtype=torch.bool, device=dev)
        for p, q in rounds:
            if p.numel() == 0:
                continue
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            rel = eps * torch.sqrt(torch.abs(app)) * torch.sqrt(torch.abs(aqq))
            # rel > tiny ? rel : tiny, with a NaN tiny winning (as the kernel)
            thr = torch.where(rel > tiny[:, None], rel, tiny[:, None].expand_as(rel))
            rot = ~(torch.abs(apq) <= thr) & active[:, None]
            safe = torch.where(rot, apq, torch.ones_like(apq))
            tau = (aqq - app) / (2.0 * safe)
            t = torch.copysign(torch.ones_like(tau), tau) / (
                torch.abs(tau) + torch.hypot(torch.ones_like(tau), tau))
            t = torch.where(rot, t, torch.zeros_like(t))
            c = torch.where(rot, 1.0 / torch.sqrt(1.0 + t * t), torch.ones_like(t))
            s = t * c
            tau_r = s / (1.0 + c)
            # rows, then columns, of the pairs of this round
            Ap, Aq = A[:, p, :], A[:, q, :]
            A = A.clone()
            A[:, p, :] = _rot0(Ap, Aq, s[..., None], tau_r[..., None])
            A[:, q, :] = _rot1(Ap, Aq, s[..., None], tau_r[..., None])
            Cp, Cq = A[:, :, p], A[:, :, q]
            A[:, :, p] = _rot0(Cp, Cq, s[:, None, :], tau_r[:, None, :])
            A[:, :, q] = _rot1(Cp, Cq, s[:, None, :], tau_r[:, None, :])
            # the 2x2 diagonal blocks exactly, from the values before the round
            A[bidx, p, p] = torch.where(rot, app - t * apq, A[bidx, p, p])
            A[bidx, q, q] = torch.where(rot, aqq + t * apq, A[bidx, q, q])
            zero = torch.zeros_like(apq)
            A[bidx, p, q] = torch.where(rot, zero, A[bidx, p, q])
            A[bidx, q, p] = torch.where(rot, zero, A[bidx, q, p])
            # keep A exactly symmetric, as the kernel does (it writes each
            # off-diagonal 2x2 block and its transpose from one computation)
            A = torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)
            Vp, Vq = V[:, :, p], V[:, :, q]
            V = V.clone()
            V[:, :, p] = _rot0(Vp, Vq, s[:, None, :], tau_r[:, None, :])
            V[:, :, q] = _rot1(Vp, Vq, s[:, None, :], tau_r[:, None, :])
            rotated = rotated | rot.any(dim=-1)
        newly = active & ~rotated
        sweeps = torch.where(newly, torch.full_like(sweeps, sweep), sweeps)
        active = active & rotated
        if not bool(active.any()):
            break
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    # ascending, ties by index, NaN last (the kernel's rank sort)
    key = torch.where(torch.isnan(w), torch.full_like(w, float("inf")), w)
    order = torch.sort(key, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(Bn, d, d))
    bad = ~torch.isfinite(normF)
    w = torch.where(bad[:, None], torch.full_like(w, float("nan")), w)
    V = torch.where(bad[:, None, None], torch.full_like(V, float("nan")), V)
    return w.reshape(shape[:-1]), V.reshape(shape), sweeps.reshape(shape[:-2])


def jacobi_project_psd(M, max_sweeps: int = MAX_SWEEPS):
    """The PSD projection V max(w, 0) V' through ``jacobi_eigh`` (the K4
    projection epilogue; NaN eigenvalues propagate)."""
    w, V, sweeps = jacobi_eigh(M, max_sweeps)
    wp = torch.where(w > 0, w, torch.where(torch.isnan(w), w, torch.zeros_like(w)))
    return (V * wp[..., None, :]) @ V.transpose(-1, -2), sweeps


# ---------------------------------------------------------------------------
# the block path of K4 and K5 (csrc/k4_jacobi.cu, k4_block_kernel)
# ---------------------------------------------------------------------------


def _block_matmul(dtype):
    """The block path's tile products: 3xTF32 on the tensor cores for
    float32 (``ops.polar.tf32x3_matmul``), plain products for float64."""
    return tf32x3_matmul if dtype == torch.float32 else torch.matmul


def block_tournament(nb: int):
    """The rounds of one outer sweep of the block path over ``nb`` blocks:
    per round a list of ``(I, J)`` block pairs, ``I < J``; ``J == nb`` is
    the bye when ``nb`` is odd (its pair is block ``I`` alone)."""
    N = nb + (nb & 1)
    rounds = []
    for r in range(N - 1):
        pairs = []
        for a in range(N // 2):
            x, y = (N - 1, r) if a == 0 else ((r + a) % (N - 1), (r - a) % (N - 1))
            pairs.append((min(x, y), max(x, y)))
        rounds.append(pairs)
    return rounds


def _inner_sweep(S, E, vmask, floor, active):
    """One sweep of the scalar parallel Jacobi on every pair's (2w x 2w)
    subproblem ``S`` (..., P, 2w, 2w; float64), accumulating ``E = Q - I``
    of its rotations in E's dtype, the input's.  Each rotation (test and
    parameters) is computed in the input dtype from S's values rounded to
    it, and applied whole to S in float64 (no exact zero on the pair's own
    block), as the kernel does.  ``vmask`` (P, 2w): the indices that exist
    (a ragged last block's tail and the bye's half never rotate).  Returns
    ``(S, E, rotated)``, ``rotated`` (..., P) true where a pair rotated."""
    n2 = S.shape[-1]
    dt = E.dtype
    eps = torch.finfo(dt).eps
    rotated = torch.zeros(S.shape[:-2], dtype=torch.bool, device=S.device)
    fl = floor[:, None, None]
    for p, q in round_robin(n2):
        p, q = p.to(S.device), q.to(S.device)
        app, aqq, apq = S[..., p, p].to(dt), S[..., q, q].to(dt), S[..., p, q].to(dt)
        rel = eps * torch.sqrt(torch.abs(app)) * torch.sqrt(torch.abs(aqq))
        thr = torch.where(rel > fl, rel, fl.expand_as(rel))
        rot = ~(torch.abs(apq) <= thr) & (vmask[:, p] & vmask[:, q]) & active[:, None, None]
        if not bool(rot.any()):
            continue
        safe = torch.where(rot, apq, torch.ones_like(apq))
        tau = (aqq - app) / (2.0 * safe)
        t = torch.copysign(torch.ones_like(tau), tau) / (
            torch.abs(tau) + torch.hypot(torch.ones_like(tau), tau))
        t = torch.where(rot, t, torch.zeros_like(t))
        c = torch.where(rot, 1.0 / torch.sqrt(1.0 + t * t), torch.ones_like(t))
        s = t * c
        r = s / (1.0 + c)
        s64, r64 = s.double(), r.double()
        Sp, Sq = S[..., p, :], S[..., q, :]
        S = S.clone()
        S[..., p, :] = _rot0(Sp, Sq, s64[..., None], r64[..., None])
        S[..., q, :] = _rot1(Sp, Sq, s64[..., None], r64[..., None])
        Cp, Cq = S[..., :, p], S[..., :, q]
        S[..., :, p] = _rot0(Cp, Cq, s64[..., None, :], r64[..., None, :])
        S[..., :, q] = _rot1(Cp, Cq, s64[..., None, :], r64[..., None, :])
        # the lower triangle from the upper, as the kernel writes each 2x2
        # block and its transpose from one computation
        S = torch.triu(S) + torch.triu(S, 1).transpose(-1, -2)
        # E <- (I + E) J - I: the rotation of E's columns in Rutishauser's
        # form, plus J - I on rows p and q (c - 1 = -s r, no cancellation)
        Ep, Eq = E[..., :, p], E[..., :, q]
        E = E.clone()
        E[..., :, p] = _rot0(Ep, Eq, s[..., None, :], r[..., None, :])
        E[..., :, q] = _rot1(Ep, Eq, s[..., None, :], r[..., None, :])
        E[..., p, p] -= s * r
        E[..., q, p] -= s
        E[..., p, q] += s
        E[..., q, q] -= s * r
        rotated = rotated | rot.any(dim=-1)
    return S, E, rotated


def jacobi_eigh_blocked(M, width: int = 16, max_sweeps: int = MAX_SWEEPS):
    """Eigenvalues (ascending), eigenvectors and sweep counts of a batch of
    symmetric (..., d, d) matrices by the schedule of K4's block path.

    The indices split into ``nb = ceil(d / width)`` blocks (a ragged last
    block is masked, never rotated); an outer sweep is the round robin of
    ``block_tournament(nb)``.  In each round every pair (I, J) runs ONE
    sweep of the scalar schedule (``jacobi_eigh``'s rotation and stopping
    test in the input dtype, with the whole matrix's floor) on its 2w x 2w
    subproblem [[A_II, A_IJ], [A_JI, A_JJ]] held in float64, each rotation
    applied whole (no exact zero), accumulating E = Q - I in the input
    dtype; the rotated subproblem, rounded back, is the pair's new diagonal
    tile.  A pair none of whose
    entries fails the test is skipped (E = 0).  Every other tile, between
    pairs a < c, becomes X + E_a' X with X = T + T E_c (T = the tile), and
    is mirrored below the diagonal, so A stays exactly symmetric; V's
    columns of pair a become V_a + V_a E_a.  The products are the kernel's
    3xTF32 ``tf32x3_matmul`` for float32 (``torch.matmul`` for float64).
    The outer sweeps stop after the first
    that rotates no pair, or at ``max_sweeps`` (``sweeps`` is then
    ``max_sweeps + 1``).  Returns ``(w, V, sweeps)``."""
    matmul = _block_matmul(M.dtype)
    shape = M.shape
    d, w = shape[-1], int(width)
    A0 = M.reshape(-1, d, d)
    A0 = 0.5 * (A0 + A0.transpose(-1, -2))
    Bn = A0.shape[0]
    dt, dev = A0.dtype, A0.device
    eps = torch.finfo(dt).eps
    nb = -(-d // w)
    nb2 = nb + (nb & 1)  # a bye block, all masked, when nb is odd
    D = nb2 * w
    A = torch.zeros((Bn, D, D), dtype=dt, device=dev)
    A[:, :d, :d] = A0
    valid = torch.arange(D, device=dev) < d
    V = torch.diag_embed(valid.to(dt)).expand(Bn, D, D).clone()
    normF = torch.sqrt(torch.sum(A0 * A0, dim=(-2, -1)))
    floor = torch.where(torch.isfinite(normF), eps * normF / (4.0 * d),
                        torch.full_like(normF, float("nan")))
    sweeps = torch.full((Bn,), max_sweeps + 1, dtype=torch.int32, device=dev)
    active = torch.ones((Bn,), dtype=torch.bool, device=dev)
    loc = torch.arange(w, device=dev)
    rounds = []
    for pairs in block_tournament(nb):
        idx = torch.stack([torch.cat([I * w + loc, J * w + loc]) for I, J in pairs])
        perm = idx.reshape(-1)
        tile = torch.arange(len(pairs), device=dev).repeat_interleave(2 * w)
        rounds.append((idx, perm, tile))
    for sweep in range(1, max_sweeps + 1):
        rotated = torch.zeros((Bn,), dtype=torch.bool, device=dev)
        for idx, perm, tile in rounds:
            P = idx.shape[0]
            S = A[:, idx[:, :, None], idx[:, None, :]]
            E = torch.zeros_like(S)
            S, E, rot = _inner_sweep(S.double(), E, valid[idx], floor, active)
            S = S.to(dt)
            rotated = rotated | rot.any(dim=-1)
            # the tiles in pair order: X = T + T E_c, then X + E_a' X
            Eb = torch.zeros((Bn, D, D), dtype=dt, device=dev)
            for a in range(P):
                Eb[:, 2 * w * a:2 * w * (a + 1), 2 * w * a:2 * w * (a + 1)] = E[:, a]
            Ap = A[:, perm[:, None], perm[None, :]]
            X = Ap + matmul(Ap, Eb)
            An = X + matmul(Eb.transpose(-1, -2), X)
            upper = tile[:, None] < tile[None, :]
            An = torch.where(upper, An, An.transpose(-1, -2))
            for a in range(P):
                An[:, 2 * w * a:2 * w * (a + 1), 2 * w * a:2 * w * (a + 1)] = S[:, a]
            A = A.clone()
            A[:, perm[:, None], perm[None, :]] = An
            Vp = V[:, :, perm]
            V = V.clone()
            V[:, :, perm] = Vp + matmul(Vp, Eb)
        newly = active & ~rotated
        sweeps = torch.where(newly, torch.full_like(sweeps, sweep), sweeps)
        active = active & rotated
        if not bool(active.any()):
            break
    wd = torch.diagonal(A, dim1=-2, dim2=-1)[:, :d]
    V = V[:, :d, :d]
    key = torch.where(torch.isnan(wd), torch.full_like(wd, float("inf")), wd)
    order = torch.sort(key, dim=-1, stable=True).indices
    wd = torch.gather(wd, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(Bn, d, d))
    bad = ~torch.isfinite(normF)
    wd = torch.where(bad[:, None], torch.full_like(wd, float("nan")), wd)
    V = torch.where(bad[:, None, None], torch.full_like(V, float("nan")), V)
    return wd.reshape(shape[:-1]), V.reshape(shape), sweeps.reshape(shape[:-2])


def jacobi_project_psd_blocked(M, width: int = 16, max_sweeps: int = MAX_SWEEPS):
    """The PSD projection of K4's block path: V max(w, 0) V' through
    ``jacobi_eigh_blocked``, formed as the kernel's epilogue does (the
    upper triangle, mirrored; NaN eigenvalues propagate)."""
    w, V, sweeps = jacobi_eigh_blocked(M, width, max_sweeps)
    wp = torch.where(w > 0, w, torch.where(torch.isnan(w), w, torch.zeros_like(w)))
    P = _block_matmul(M.dtype)(V * wp[..., None, :], V.transpose(-1, -2))
    return torch.triu(P) + torch.triu(P, 1).transpose(-1, -2), sweeps


# ---------------------------------------------------------------------------
# K4s (csrc/k4s_jacobi_small.cu): cyclic-by-row Jacobi, one thread a matrix
# ---------------------------------------------------------------------------


def k4s_scale(normF):
    """K4s's power of two 2^k, k = 1 - frexp exponent of ||A||_F (so that
    ||A||_F 2^k lies in [1, 2)), clamped to the dtype's normal range; 2^0
    for a zero or non-finite norm."""
    lim = 126 if normF.dtype == torch.float32 else 1022
    ex = torch.frexp(normF).exponent
    k = torch.clamp(1 - ex, -lim, lim)
    k = torch.where(torch.isfinite(normF) & (normF != 0), k, torch.zeros_like(k))
    return torch.ldexp(torch.ones_like(normF), k)


def k4s_rotation(app, aqq, apq, floor2):
    """K4s's skip test and rotation (``k4s_rotation.cuh``) on scaled
    values: ``rot`` where |a_pq|^2 > max(eps^2 |a_pp| |a_qq|, floor^2) (a
    NaN rotates); with h = a_qq - a_pp, g = 2 a_pq, g' = sign(h) g, e = |h| +
    sqrt(h^2 + g^2), f = sqrt(e^2 + g^2): t = g' / e, s = g' / f and r =
    g' / (e + f), t and r from the one reciprocal 1 / (e (e + f)).  Returns
    ``(rot, t, s, r)``, the parameters 0 where the pair is skipped."""
    eps = torch.finfo(app.dtype).eps
    rel2 = (eps * eps) * (torch.abs(app) * torch.abs(aqq))
    thr2 = torch.where(rel2 > floor2, rel2, floor2)
    rot = ~(apq * apq <= thr2)
    h, g = aqq - app, 2.0 * apq
    g = torch.where(rot, g, torch.ones_like(g))
    gs = torch.copysign(torch.ones_like(h), h) * g
    e = torch.abs(h) + torch.sqrt(h * h + g * g)
    n2 = e * e + g * g
    inv = torch.rsqrt(n2)
    f = n2 * inv
    q = 1.0 / (e * (e + f))
    zero = torch.zeros_like(g)
    t = torch.where(rot, gs * (e + f) * q, zero)
    r = torch.where(rot, gs * e * q, zero)
    s = torch.where(rot, gs * inv, zero)
    return rot, t, s, r


def k4s_eigh(M, max_sweeps: int = MAX_SWEEPS):
    """Eigenvalues (unsorted: the diagonal at the end), eigenvectors and
    sweep counts of a batch of symmetric (..., D, D) matrices by K4s's
    schedule: the matrix symmetrised and scaled by ``k4s_scale``,
    cyclic-by-row sweeps (pairs (p, q), p < q, row by row) with
    ``k4s_rotation`` and K4's floor eps ||A||_F / (4 D) (NaN for a
    non-finite matrix, which then rotates to the cap), each rotation applied
    to rows and columns p and q in Rutishauser's form, then a_pp -= t a_pq,
    a_qq += t a_pq, a_pq = 0; the sweeps stop after the first that rotates
    no pair, or at ``max_sweeps`` (``sweeps`` is then ``max_sweeps + 1``).
    Returns ``(w, V, sweeps)``, ``w`` unscaled (NaN for a non-finite
    input)."""
    shape = M.shape
    D = shape[-1]
    A = M.reshape(-1, D, D)
    A = 0.5 * (A + A.transpose(-1, -2))
    Bn = A.shape[0]
    dt, dev = A.dtype, A.device
    eps = torch.finfo(dt).eps
    normF = torch.sqrt(torch.sum(A * A, dim=(-2, -1)))
    bad = ~torch.isfinite(normF)
    sc = k4s_scale(normF)
    floor = torch.where(bad, torch.full_like(normF, float("nan")), eps * (normF * sc) / (4.0 * D))
    floor2 = floor * floor
    A = A * sc[:, None, None]
    V = torch.eye(D, dtype=dt, device=dev).expand(Bn, D, D).clone()
    sweeps = torch.full((Bn,), max_sweeps + 1, dtype=torch.int32, device=dev)
    active = torch.ones((Bn,), dtype=torch.bool, device=dev)
    for sweep in range(1, max_sweeps + 1):
        rotated = torch.zeros((Bn,), dtype=torch.bool, device=dev)
        for p in range(D - 1):
            for q in range(p + 1, D):
                app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
                rot, t, s, r = k4s_rotation(app, aqq, apq, floor2)
                rot = rot & active
                if not bool(rot.any()):
                    continue
                rotated = rotated | rot
                s, r, t = (torch.where(rot, x, torch.zeros_like(x)) for x in (s, r, t))
                ks = [k for k in range(D) if k not in (p, q)]
                A = A.clone()
                if ks:
                    x, y = A[:, ks, p], A[:, ks, q]
                    xn = _rot0(x, y, s[:, None], r[:, None])
                    yn = _rot1(x, y, s[:, None], r[:, None])
                    A[:, ks, p], A[:, p, ks] = xn, xn
                    A[:, ks, q], A[:, q, ks] = yn, yn
                A[:, p, p] = torch.where(rot, app - t * apq, app)
                A[:, q, q] = torch.where(rot, aqq + t * apq, aqq)
                apq0 = torch.where(rot, torch.zeros_like(apq), apq)
                A[:, p, q], A[:, q, p] = apq0, apq0
                Vp, Vq = V[:, :, p], V[:, :, q]
                V = V.clone()
                V[:, :, p] = _rot0(Vp, Vq, s[:, None], r[:, None])
                V[:, :, q] = _rot1(Vp, Vq, s[:, None], r[:, None])
        newly = active & ~rotated
        sweeps = torch.where(newly, torch.full_like(sweeps, sweep), sweeps)
        active = active & rotated
        if not bool(active.any()):
            break
    w = torch.diagonal(A, dim1=-2, dim2=-1) / sc[:, None]
    w = torch.where(bad[:, None], torch.full_like(w, float("nan")), w)
    return w.reshape(shape[:-1]), V.reshape(shape), sweeps.reshape(shape[:-2])


def k4s_project_psd(M, max_sweeps: int = MAX_SWEEPS):
    """The PSD projection V max(w, 0) V' of K4s through ``k4s_eigh`` (NaN
    eigenvalues propagate).  Returns ``(P, sweeps)``."""
    w, V, sweeps = k4s_eigh(M, max_sweeps)
    wp = torch.where(w > 0, w, torch.where(torch.isnan(w), w, torch.zeros_like(w)))
    return (V * wp[..., None, :]) @ V.transpose(-1, -2), sweeps


def k4s_staging(N: int, D: int, aligned: bool = True, threads: int = 128):
    """K4s's staging of a batch of ``N`` (D, D) matrices, as the kernel's
    ``stage_in`` walks it: warp g of the grid takes matrices [32 g, min(N,
    32 g + 32)), in 16-byte quads of its floats while they last (none where
    the tensor is not 16-byte aligned), the ragged tail one float at a time;
    float f of a CTA of ``threads`` matrices (warp g % (threads / 32) of CTA
    g // (threads / 32)) lands in its staging slot (f // D^2) (D^2 | 1) +
    f % D^2.  Returns ``(cta, flat, slot)`` int64 tensors, one entry per
    load, in the order each warp issues them."""
    DD = D * D
    LD = DD | 1
    per = threads // 32
    ctas, flats, slots = [], [], []
    for g in range(-(-N // 32)):
        nf = (min(N, 32 * g + 32) - 32 * g) * DD
        n4 = nf // 4 if aligned else 0
        f = torch.cat([torch.arange(4 * n4), torch.arange(4 * n4, nf)]) + (g % per) * 32 * DD
        ctas.append(torch.full_like(f, g // per))
        flats.append((g // per) * threads * DD + f)
        slots.append((f // DD) * LD + f % DD)
    return torch.cat(ctas), torch.cat(flats), torch.cat(slots)
