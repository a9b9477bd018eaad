"""A vectorised torch mirror of kernel K5's order of work
(``omc_torch/csrc/k5_separation.cu``): the ``nout <= 2`` smallest
eigenpairs of sym(U U' - Y) by Householder tridiagonalisation, Sturm-count
multisection and inverse iteration; and of K4's float64 tridiagonal path
(``csrc/k4_tridiag.cu``), which runs the same steps for every eigenvalue
of sym(M), and for the vectors it needs (end of this module).

The kernel runs on the GPU only; this mirror runs the same algorithm on any
device, so that the CPU tests can hold the reflectors, the 32-shift
multisection, the inverse iteration's start vector, cap and
reorthogonalisation rule, and the back-transform against LAPACK.  It is not
on any solver path: there the CPU takes ``torch.linalg.eigh``
(``omc_torch.sdp.relax.separation_eigpairs_plain``).  Sums are taken in
another order than the kernel's warps take them, so the two agree to
rounding, not bit for bit.

1. A = U U' - (Y + Y') / 2 in float64, stored in ``storage`` (the kernel's
   path 0 keeps float64, path 1 float32, rounding an off-diagonal entry
   after each of its two passes over Y).
2. dsytd2's lower reduction: for column i, alpha = A(i+1, i), x = A(i+2:,
   i); beta = -sign(alpha) sqrt(alpha^2 + ||x||^2), tau = (beta - alpha) /
   beta, v = (1, x / (alpha - beta)) (tau = 0 and v = e_1 where x = 0);
   p = A22 v, w = tau p - tau^2 (p'v) / 2 v, A22 -= v w' + w v', stored.
3. Multisection: the Gershgorin interval padded by dstebz's fudge (2.1 eps
   ||T||_1 d + 4.2 pivmin), then ``ROUNDS`` rounds, each counting (dlaebz:
   q <= pivmin counts, and q is then min(q, -pivmin)) at the 32 shifts lo +
   l (hi - lo) / 33, l = 1..32, and keeping the bracket between the last
   shift that counts <= t eigenvalues and the first that counts more.
4. Inverse iteration (dstein): LU with partial pivoting of T - lambda I,
   pivots below eps ||T||_1 replaced by it; start vector ``start_vector``;
   before every solve the right-hand side is scaled to max-norm d ||T||_1
   max(eps, |u_nn|); the solve passes the growth test when its max-norm
   reaches sqrt(0.1 / d), and the iteration stops ``EXTRA`` solves after
   the first pass, or at ``MAX_ITERS`` (the count is then ``MAX_ITERS +
   1``).  When |lambda_1 - lambda_0| <= 1e-3 ||T||_1 the second vector is
   orthogonalised against the first after every solve.  The vector is
   normalised with its largest entry positive.
5. Q z through the reflectors, last first; columns normalised.
"""

from __future__ import annotations

import torch

# multisection rounds, inverse-iteration cap and extra solves (kRounds,
# kMaxIters, kExtra in csrc/k5_separation.cu)
ROUNDS = 11
MAX_ITERS = 5
EXTRA = 2
_MASK = (1 << 64) - 1
_EPS = torch.finfo(torch.float64).eps
_TINY = torch.finfo(torch.float64).tiny


def start_vector(d: int, seed: int, device=None):
    """The kernel's deterministic start vector: entry j is splitmix64 of
    (2 j + seed + 1), its top 53 bits scaled to [-1, 1)."""
    out = []
    for j in range(d):
        x = ((2 * j + seed + 1) * 0x9E3779B97F4A7C15) & _MASK
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
        x ^= x >> 31
        out.append((x >> 11) * 2.0 ** -52 - 1.0)
    return torch.tensor(out, dtype=torch.float64, device=device)


def form(U, Y, storage=torch.float64):
    """sym(U U' - Y) as the kernel loads it: U U' - Y / 2 off the diagonal
    and U U' - Y on it, rounded to ``storage``, then - Y' / 2 off the
    diagonal, rounded again (B, d, d)."""
    U64, Y64 = U.double(), Y.double()
    Yd = torch.diag_embed(torch.diagonal(Y64, dim1=-2, dim2=-1))
    A1 = (U64 @ U64.transpose(-1, -2) - 0.5 * (Y64 + Yd)).to(storage)
    A = (A1.double() - 0.5 * (Y64.transpose(-1, -2) - Yd)).to(storage)
    return torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)


def tridiagonalise(A):
    """dsytd2's lower reduction of the symmetric (B, d, d) ``A`` in its own
    dtype (the storage), with float64 arithmetic.  Returns ``(diag, off,
    tau, R)``: T's diagonal (B, d) and off-diagonal (B, d - 1) in float64,
    each reflector's tau (B, d) and the reflectors R (B, d, d), column i
    holding v_i (v_i(i + 1) = 1)."""
    storage = A.dtype
    A = A.clone()
    Bn, d = A.shape[0], A.shape[-1]
    f64 = dict(dtype=torch.float64, device=A.device)
    diag = torch.zeros(Bn, d, **f64)
    off = torch.zeros(Bn, max(d - 1, 0), **f64)
    tau = torch.zeros(Bn, d, **f64)
    R = torch.zeros(Bn, d, d, **f64)
    for i in range(d - 2):
        alpha = A[:, i + 1, i].double()
        x = A[:, i + 2:, i].double()
        xn2 = torch.sum(x * x, dim=-1)
        nz = xn2 != 0
        beta = torch.where(nz, -torch.copysign(torch.sqrt(alpha * alpha + xn2), alpha), alpha)
        t = torch.where(nz, (beta - alpha) / beta, torch.zeros_like(alpha))
        scale = torch.where(nz, 1.0 / torch.where(nz, alpha - beta, torch.ones_like(alpha)),
                            torch.zeros_like(alpha))
        v = torch.cat([torch.ones_like(alpha)[:, None], x * scale[:, None]], dim=-1)
        A22 = A[:, i + 1:, i + 1:].double()
        p = (A22 @ v[..., None])[..., 0]
        a2 = -0.5 * t * t * torch.sum(p * v, dim=-1)
        w = t[:, None] * p + a2[:, None] * v
        A22 = A22 - w[:, :, None] * v[:, None, :] - v[:, :, None] * w[:, None, :]
        A[:, i + 1:, i + 1:] = A22.to(storage)
        diag[:, i], off[:, i], tau[:, i] = A[:, i, i].double(), beta, t
        R[:, i + 1:, i] = v
    if d >= 2:
        diag[:, d - 2] = A[:, d - 2, d - 2].double()
        off[:, d - 2] = A[:, d - 1, d - 2].double()
    diag[:, d - 1] = A[:, d - 1, d - 1].double()
    return diag, off, tau, R


def _sturm_counts(diag, off, x, pivmin):
    """dlaebz's count at the shifts x (B, S): eigenvalues <= x."""
    q = diag[:, :1] - x
    c = q <= pivmin
    cnt = c.to(torch.int64)
    q = torch.where(c, torch.minimum(q, -pivmin), q)
    for j in range(1, diag.shape[-1]):
        e = off[:, j - 1:j]
        q = (diag[:, j:j + 1] - x) - e * e / q
        c = q <= pivmin
        cnt = cnt + c
        q = torch.where(c, torch.minimum(q, -pivmin), q)
    return cnt


def gershgorin(diag, off):
    """The padded Gershgorin interval, ||T||_1 and pivmin of the kernel."""
    d = diag.shape[-1]
    a = torch.abs(off)
    z = torch.zeros_like(diag[:, :1])
    rad = torch.cat([z, a], -1) + torch.cat([a, z], -1)
    lo = torch.amin(diag - rad, -1)
    hi = torch.amax(diag + rad, -1)
    tn = torch.amax(torch.abs(diag) + rad, -1)
    e2max = torch.amax(torch.cat([z, a * a], -1), -1)
    pivmin = _TINY * torch.clamp(e2max, min=1.0)
    pad = 2.1 * _EPS * tn * d + 4.2 * pivmin
    return lo - pad, hi + pad, tn, pivmin


def multisection(diag, off, nout):
    """The ``nout`` smallest eigenvalues of T (B, nout) by ``ROUNDS``
    rounds of 32-shift multisection, and ||T||_1 (1 for a zero matrix)."""
    lo0, hi0, tn, pivmin = gershgorin(diag, off)
    Bn = diag.shape[0]
    lanes = torch.arange(1, 33, dtype=torch.float64, device=diag.device)
    lo = lo0[:, None].expand(Bn, nout).clone()
    hi = hi0[:, None].expand(Bn, nout).clone()
    t = torch.arange(nout, device=diag.device)[None, :, None]
    for _ in range(ROUNDS):
        h = (hi - lo) * (1.0 / 33.0)
        x = lo[..., None] + lanes * h[..., None]  # (B, nout, 32)
        cnt = _sturm_counts(diag, off, x.reshape(Bn, -1), pivmin[:, None]).reshape(Bn, nout, 32)
        above = cnt > t
        anyab = above.any(-1)
        l0 = torch.where(anyab, torch.argmax(above.to(torch.int8), -1), 32)
        xl = torch.gather(x, -1, (l0 % 32)[..., None])[..., 0]
        xm = torch.gather(x, -1, ((l0 + 31) % 32)[..., None])[..., 0]
        hi = torch.where(l0 < 32, xl, hi)
        lo = torch.where(l0 == 0, lo, xm)
    tn = torch.where(tn > 0, tn, torch.ones_like(tn))
    return 0.5 * (lo + hi), tn


def inverse_iteration(diag, off, lam, tn, seed, z0=None, zs=None):
    """dstein's inverse iteration for the eigenvalues ``lam`` (B,) of T,
    with the kernel's start vector ``seed`` (an int, or one a row) and,
    where ``z0`` (B, d) is given, its orthogonalisation after every solve;
    where ``zs`` (B, G, d) is given, the same against each of its G vectors
    in turn (modified Gram-Schmidt; K4's tridiagonal path).  Returns the
    unit vectors (B, d), largest entry positive, and the solves run (B,)
    (``MAX_ITERS + 1`` at the cap)."""
    Bn, d = diag.shape
    tol = _EPS * tn
    zero = torch.zeros_like(lam)
    r0, r1 = diag[:, 0] - lam, (off[:, 0] if d > 1 else zero)
    u0, u1, u2, lm, piv = [], [], [], [], []
    for j in range(d - 1):
        bj, aj = off[:, j], diag[:, j + 1] - lam
        cj = off[:, j + 1] if j + 2 < d else zero
        keep = torch.abs(r0) >= torch.abs(bj)
        ln = torch.where(r0 != 0, bj / torch.where(r0 != 0, r0, torch.ones_like(r0)), zero)
        ls = r0 / torch.where(keep, torch.ones_like(bj), bj)
        u0.append(torch.where(keep, r0, bj))
        u1.append(torch.where(keep, r1, aj))
        u2.append(torch.where(keep, zero, cj))
        lm.append(torch.where(keep, ln, ls))
        piv.append(~keep)
        r0, r1 = torch.where(keep, aj - ln * r1, r1 - ls * aj), torch.where(keep, cj, -ls * cj)
    u0.append(r0)
    unn = torch.abs(r0)
    ru = []
    for u in u0:
        u = torch.where(torch.abs(u) < tol, torch.where(u < 0, -tol, tol), u)
        ru.append(1.0 / u)
    seeds = [int(seed)] * Bn if isinstance(seed, int) else [int(t) for t in seed]
    x = torch.stack([start_vector(d, t, diag.device) for t in seeds]) if Bn else \
        torch.zeros(0, d, dtype=torch.float64, device=diag.device)
    crit = (0.1 / d) ** 0.5
    its = torch.full((Bn,), MAX_ITERS + 1, dtype=torch.int32, device=diag.device)
    checks = torch.zeros((Bn,), dtype=torch.int32, device=diag.device)
    done = torch.zeros((Bn,), dtype=torch.bool, device=diag.device)
    reseed = torch.tensor(seeds, dtype=torch.int64, device=diag.device)
    for it in range(1, MAX_ITERS + 1):
        y = x.clone()
        bmax = torch.amax(torch.abs(y), -1)
        empty = bmax == 0
        if bool(empty.any()):
            reseed = torch.where(empty, reseed + 2, reseed)
            fresh = torch.stack([start_vector(d, int(s), diag.device) for s in reseed])
            y = torch.where(empty[:, None], fresh, y)
            bmax = torch.amax(torch.abs(y), -1)
        y = y * (d * tn * torch.clamp(unn, min=_EPS) / bmax)[:, None]
        cols = list(y.unbind(-1))
        for j in range(d - 1):
            a, b = cols[j], cols[j + 1]
            a, b = torch.where(piv[j], b, a), torch.where(piv[j], a, b)
            cols[j], cols[j + 1] = a, b - lm[j] * a
        cols[d - 1] = cols[d - 1] * ru[d - 1]
        if d > 1:
            cols[d - 2] = (cols[d - 2] - u1[d - 2] * cols[d - 1]) * ru[d - 2]
        for j in range(d - 3, -1, -1):
            cols[j] = (cols[j] - u1[j] * cols[j + 1] - u2[j] * cols[j + 2]) * ru[j]
        y = torch.stack(cols, -1)
        if z0 is not None:
            y = y - torch.sum(y * z0, -1, keepdim=True) * z0
        if zs is not None:
            for g in range(zs.shape[1]):
                y = y - torch.sum(y * zs[:, g], -1, keepdim=True) * zs[:, g]
        passed = torch.amax(torch.abs(y), -1) >= crit
        live = ~done
        x = torch.where(live[:, None], y, x)
        checks = torch.where(live & passed, checks + 1, checks)
        stop = live & passed & (checks >= EXTRA + 1)
        its = torch.where(stop, torch.full_like(its, it), its)
        done = done | stop
        if bool(done.all()):
            break
    jm = torch.argmax(torch.abs(x), -1, keepdim=True)
    sgn = torch.where(torch.gather(x, -1, jm) < 0, -1.0, 1.0)
    x = x * (sgn / torch.sqrt(torch.sum(x * x, -1, keepdim=True)))
    return x, its


def back_transform(Z, R, tau):
    """Q Z through the reflectors (last first) for Z (B, d, nout)."""
    d = Z.shape[-2]
    for i in range(d - 3, -1, -1):
        v = R[:, :, i:i + 1]
        dot = torch.sum(v * Z, dim=-2, keepdim=True) * tau[:, i, None, None]
        Z = Z - v * dot
    return Z / torch.sqrt(torch.sum(Z * Z, dim=-2, keepdim=True))


def separation_tridiag(U, Y, nout: int = 2, storage=torch.float64):
    """The ``nout`` (<= 2, <= d) smallest eigenpairs of sym(U U' - Y) by
    K5's order of work, the triangle held in ``storage``.  ``U`` (B, d, k),
    ``Y`` (B, d, d).  Returns ``(w, V, iters)``: ``w`` (B, nout) ascending
    and ``V`` (B, d, nout) in U's dtype, and the solves of the slower
    vector (B,); a non-finite input gives NaN and ``MAX_ITERS + 1``."""
    A = form(U, Y, storage)
    d = A.shape[-1]
    bad = ~torch.isfinite(A.double()).all(-1).all(-1)
    diag, off, tau, R = tridiagonalise(A)
    lam, tn = multisection(diag, off, nout)
    close = (lam[:, -1] - lam[:, 0]).abs() <= 1e-3 * tn if nout == 2 else None
    z0, it0 = inverse_iteration(diag, off, lam[:, 0], tn, 0)
    zs, its = [z0], it0
    if nout == 2:
        z1a, it1a = inverse_iteration(diag, off, lam[:, 1], tn, 1)
        z1b, it1b = inverse_iteration(diag, off, lam[:, 1], tn, 1, z0=z0)
        zs.append(torch.where(close[:, None], z1b, z1a))
        its = torch.maximum(it0, torch.where(close, it1b, it1a))
    V = back_transform(torch.stack(zs, -1), R, tau)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=A.device)
    w = torch.where(bad[:, None], nan, lam)
    V = torch.where(bad[:, None, None], nan, V)
    its = torch.where(bad, MAX_ITERS + 1, its)
    return w.to(U.dtype), V.to(U.dtype), its


# ---- K4's tridiagonal path (float64; csrc/k4_tridiag.cu) ----
#
# The same reduction, multisection and inverse iteration for every
# eigenvalue of sym(M), and the kernel's choice of vectors: mode 2 the nout
# smallest; mode 1 (the PSD projection) those on the side of zero with
# fewer eigenvalues beyond tau = d eps ||T||_1 (A minus the negative part,
# or the positive part), an eigenvalue within tau of zero left out.  The
# needed eigenvalues form dstein's groups (the next within 1e-3 ||T||_1 of
# the last); a group's vectors run one after the other, each shift at least
# 10 eps |lambda| above the last, each solve orthogonalised against the
# group's earlier vectors; the start vector of eigenvalue j is seeded by j.


def _tri_of(M):
    """sym(M) in float64, T's diagonal and off-diagonal, the reflectors,
    their tau and the non-finite flag (B,)."""
    A = 0.5 * (M.double() + M.double().transpose(-1, -2))
    bad = ~torch.isfinite(A).all(-1).all(-1)
    diag, off, tau, R = tridiagonalise(torch.tril(A) + torch.tril(A, -1).transpose(-1, -2))
    return A, diag, off, tau, R, bad


def tri_needs(w, tn, mode, nout=None):
    """The vectors K4's tridiagonal path computes for one matrix of
    eigenvalues ``w`` (d,) and ||T||_1 ``tn``: a list of eigenvalue indices,
    ascending, and the side (+1: P = sum over them of lambda y y'; -1: P = A
    minus it; 0: mode 2's eigenpairs)."""
    d = w.shape[-1]
    if mode == 2:
        return list(range(nout)), 0
    tau = d * _EPS * float(tn)
    na, nb = int((w < -tau).sum()), int((w > tau).sum())
    if na < nb:
        return [j for j in range(d) if float(w[j]) < -tau], -1
    return [j for j in range(d) if float(w[j]) > tau], 1


def tri_groups(w, idx, tn):
    """dstein's groups of the needed eigenvalues ``idx``: runs in which each
    is within 1e-3 ||T||_1 of the one before."""
    groups = []
    for j in idx:
        if groups and not float(w[j]) - float(w[groups[-1][-1]]) > 1e-3 * float(tn):
            groups[-1].append(j)
        else:
            groups.append([j])
    return groups


def tri_vectors(diag, off, w, tn, groups):
    """The unit eigenvectors of one tridiagonal T (``diag`` (d,), ``off``
    (d - 1,)) for ``groups`` of eigenvalue indices into ``w``: the groups'
    p-th vectors together, each against its group's earlier ones.  Returns
    a dict index -> (vector (d,), solves)."""
    out, shift = {}, {}
    for pos in range(max((len(g) for g in groups), default=0)):
        live = [g for g in groups if len(g) > pos]
        js = [g[pos] for g in live]
        lam = []
        for g in live:
            x = float(w[g[pos]])
            if pos:  # dstein: at least 10 eps |lambda| above the last shift
                prev, pert = shift[g[pos - 1]], 10.0 * _EPS * abs(x)
                x = prev + pert if x - prev < pert else x
            shift[g[pos]] = x
            lam.append(x)
        G = len(live)
        zs = torch.stack([torch.stack([out[j][0] for j in g[:pos]]) for g in live]) if pos else None
        z, its = inverse_iteration(diag.expand(G, -1), off.expand(G, -1),
                                   torch.tensor(lam, dtype=torch.float64, device=diag.device),
                                   torch.full((G,), float(tn), dtype=torch.float64,
                                              device=diag.device), js, zs=zs)
        for t, j in enumerate(js):
            out[j] = (z[t], int(its[t]))
    return out


def _tri_eig(M, mode, nout=None):
    """K4's tridiagonal path in order of work on (B, d, d) ``M``: the
    eigenvalues (B, d), and for modes 1 and 2 per matrix the needed
    indices, side, back-transformed vectors (g, d) and the most solves."""
    A, diag, off, tau, R, bad = _tri_of(M)
    d = A.shape[-1]
    w, tn = multisection(diag, off, d if mode == 1 else (nout or d))
    per = []
    if mode:
        for b in range(A.shape[0]):
            idx, side = tri_needs(w[b], tn[b], mode, nout)
            vec = tri_vectors(diag[b], off[b, :max(d - 1, 0)], w[b], tn[b],
                              tri_groups(w[b], idx, tn[b]))
            Z = torch.stack([vec[j][0] for j in idx], -1) if idx else \
                torch.zeros(d, 0, dtype=torch.float64)
            Y = back_transform(Z[None], R[b:b + 1], tau[b:b + 1])[0] if idx else Z
            per.append((idx, side, Y, max((vec[j][1] for j in idx), default=0)))
    return A, w, bad, per


def eigvalsh_tridiag(M):
    """Eigenvalues (B, d), ascending to rounding, of sym(M) by K4's
    tridiagonal path (float64); NaN where M is not finite."""
    _, w, bad, _ = _tri_eig(M, 0)
    return torch.where(bad[:, None], torch.full_like(w, float("nan")), w)


def eigh_tridiag(M, nout):
    """The ``nout`` smallest eigenpairs of sym(M) by K4's tridiagonal path
    (mode 2): ``w`` (B, nout), ``V`` (B, d, nout) and the most solves of a
    matrix's vectors (B,)."""
    _, w, bad, per = _tri_eig(M, 2, nout)
    V = torch.stack([Y for _, _, Y, _ in per])
    its = torch.tensor([t for *_, t in per], dtype=torch.int32)
    nan = float("nan")
    return (torch.where(bad[:, None], nan, w), torch.where(bad[:, None, None], nan, V),
            torch.where(bad, MAX_ITERS + 1, its))


def project_psd_tridiag(M):
    """The PSD projection of sym(M) (B, d, d) by K4's tridiagonal path (mode
    1): A - sum_{lambda < -tau} lambda y y' or sum_{lambda > tau} lambda y
    y', the side with fewer vectors, the sum over the vectors in ascending
    order; NaN where M is not finite.  Returns ``(P, solves)``."""
    A, w, bad, per = _tri_eig(M, 1)
    Ps, its = [], []
    for b, (idx, side, Y, most) in enumerate(per):
        lam = w[b, idx] if idx else torch.zeros(0, dtype=torch.float64)
        S = (Y * (side * lam)[None, :]) @ Y.transpose(-1, -2)
        Ps.append(A[b] + S if side < 0 else S)
        its.append(most)
    P = torch.stack(Ps)
    return (torch.where(bad[:, None, None], float("nan"), P),
            torch.where(bad, MAX_ITERS + 1, torch.tensor(its, dtype=torch.int32)))
