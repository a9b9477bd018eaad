"""Batched alternating minimisation — the upper-bound heuristic (port of
``omc/altmin.py``).

Both subproblems are closed-form batched ridge steps
(``omc_torch.ops.linalg``).  The U-step is the unconstrained ridge solution
followed by a projection: column-norm cap and pairwise SOC rows when no cuts
are given, or cyclic projections onto box ∩ per-cut v-intervals ∩ column
balls when the caller passes the node's cut tensors (the reference solves a
cut-constrained SOCP, lines 2048-2092).  Any rank-<=k iterate gives a valid
incumbent through the exact objective, so the projection only sets the
search's locality.

Convergence mirrors the reference (lines 2231-2245): relative objective
change < tol (1e-5), or the last 5 objectives all above the value 5 steps
earlier (oscillation), capped at ``max_iters``.

The JAX ``while_loop`` becomes a Python loop that reads the all-done flag
from the device once per iteration (one host sync per iteration).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from omc_torch.ops.linalg import u_step_unconstrained, v_step


class AltminResult(NamedTuple):
    U: torch.Tensor  # (B, n, k)
    V: torch.Tensor  # (B, k, m)
    objective: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    n_iters: torch.Tensor  # (B,) int32
    # per-iteration objective history, +inf past n_iters
    obj_trace: torch.Tensor  # (B, max_iters)


def _objective(U, V, A, mask, gamma):
    X = U @ V
    fit = 0.5 * torch.sum(
        torch.where(mask > 0, (X - A) ** 2, torch.zeros_like(X)), dim=(-2, -1)
    )
    reg = (0.5 / gamma) * torch.sum(X * X, dim=(-2, -1))
    return fit + reg


def _col_cap(U):
    nrm = torch.linalg.vector_norm(U, dim=-2, keepdim=True)
    return U * torch.clamp(1.0 / torch.clamp(nrm, min=1e-30), max=1.0)


def _project_pairs(U):
    """Project onto the pairwise SOC rows ``||U_j1 +- U_j2|| <= sqrt(2)``
    (j1 < j2; reference lines 2029-2045): in the rotated frame
    p = (a+b)/sqrt(2), q = (a-b)/sqrt(2) the two rows are independent norm
    clips.  No-op for k < 2."""
    k = U.shape[-1]
    if k < 2:
        return U
    U = U.clone()
    s2 = math.sqrt(2.0)
    for j1 in range(k):
        for j2 in range(j1 + 1, k):
            a = U[..., j1]
            b = U[..., j2]
            p = (a + b) / s2
            q = (a - b) / s2
            np_ = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
            nq_ = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
            p = p * torch.clamp(1.0 / torch.clamp(np_, min=1e-30), max=1.0)
            q = q * torch.clamp(1.0 / torch.clamp(nq_, min=1e-30), max=1.0)
            U[..., j1] = (p + q) / s2
            U[..., j2] = (p - q) / s2
    return U


def _project_U(U, U_lo, U_hi):
    """Cap column norms at 1, then the pairwise SOC rows.  The node box is
    deliberately not applied on this path (clipping can destroy mirrored-
    sign solutions; see ``omc.altmin._project_U``)."""
    del U_lo, U_hi
    return _project_pairs(_col_cap(U))


def _project_box(U, U_lo, U_hi, sweeps: int = 4):
    """Cyclic projections onto box ∩ column balls, ending on the box clip
    (the McCormick-path node-local projection, reference lines 2095-2171)."""
    for _ in range(sweeps):
        U = _col_cap(torch.clamp(U, U_lo, U_hi))
    return torch.clamp(U, U_lo, U_hi)


def _project_cuts(U, U_lo, U_hi, cut_x, cut_lo, cut_hi, cut_mask, sweeps=8):
    """Cyclic projections onto box ∩ per-cut v-intervals ∩ column balls ∩
    pairwise SOC rows (reference lines 2048-2092).

    U (B, n, k); cut_x (B, L, n); cut_lo/cut_hi (B, L, k); cut_mask (B, L)."""
    L = cut_x.shape[1]
    xx = torch.sum(cut_x * cut_x, dim=-1)  # (B, L)
    for _ in range(sweeps):
        U = torch.clamp(U, U_lo, U_hi)
        for l in range(L):
            x = cut_x[:, l]  # (B, n)
            v = torch.einsum("bn,bnk->bk", x, U)
            v_c = torch.clamp(v, cut_lo[:, l], cut_hi[:, l])
            dv = (v_c - v) * cut_mask[:, l][:, None]
            step = dv / torch.clamp(xx[:, l], min=1e-30)[:, None]
            U = U + x[:, :, None] * step[:, None, :]
        U = _project_pairs(_col_cap(U))
    return U


def make_altmin(n: int, m: int, k: int, gamma: float, *, max_iters: int = 100,
                tol: float = 1e-5, dtype=torch.float32):
    """Build a batched altmin: (A, mask, U_init, U_lo, U_hi) -> AltminResult.
    Tensors are used on the device they arrive on."""

    def run(A, mask, U_init, U_lo, U_hi, cut_x=None, cut_lo=None,
            cut_hi=None, cut_mask=None, box_on=None):
        """``box_on`` (optional, (B,)): slots with box_on > 0 project onto
        the node box ∩ column balls, the others keep the norm-cap
        projection."""
        with_cuts = cut_x is not None
        dev = U_init.device
        A = torch.as_tensor(A, device=dev).to(dtype)
        mask = torch.as_tensor(mask, device=dev).to(dtype)
        U = U_init.to(dtype)
        B = U.shape[0]
        V = torch.zeros((B, k, m), dtype=dtype, device=dev)
        hist = torch.full((B, 6), math.inf, dtype=dtype, device=dev)
        trace = torch.full((B, max_iters), math.inf, dtype=dtype, device=dev)
        obj_cur = torch.full((B,), 1e10, dtype=dtype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        conv = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        t = 0
        while t < max_iters and not bool(done.all()):
            V_new = v_step(U, A, mask, gamma)
            U_new = u_step_unconstrained(V_new, A, mask, gamma)
            if with_cuts:
                U_new = _project_cuts(
                    U_new, U_lo, U_hi, cut_x, cut_lo, cut_hi, cut_mask
                )
            elif box_on is not None:
                U_new = torch.where(
                    box_on[:, None, None] > 0,
                    _project_box(U_new, U_lo, U_hi),
                    _project_U(U_new, U_lo, U_hi),
                )
            else:
                U_new = _project_U(U_new, U_lo, U_hi)
            obj_new = _objective(U_new, V_new, A, mask, gamma)
            denom = torch.where(obj_cur == 0, torch.ones_like(obj_cur), obj_cur)
            rel = torch.abs((obj_new - obj_cur) / denom)
            hist_new = torch.cat([hist[:, 1:], obj_new[:, None]], dim=1)
            oscillating = (t >= 5) & torch.all(hist_new[:, 1:] > hist_new[:, 0:1], dim=1)
            newly_conv = (~done) & ((rel < tol) | oscillating)
            upd = ~done
            trace[:, t] = torch.where(upd, obj_new, torch.full_like(obj_new, math.inf))
            u3 = upd[:, None, None]
            U = torch.where(u3, U_new, U)
            V = torch.where(u3, V_new, V)
            hist = torch.where(upd[:, None], hist_new, hist)
            obj_cur = torch.where(upd, obj_new, obj_cur)
            done = done | newly_conv
            conv = conv | newly_conv
            iters = iters + upd.to(torch.int32)
            t += 1
        obj = _objective(U, V, A, mask, gamma)
        return AltminResult(U=U, V=V, objective=obj, converged=conv,
                            n_iters=iters, obj_trace=trace)

    return run
