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
