"""Problem definition and exact metric oracles (port of ``omc/problem.py``).

- ``evaluate_objective``                 — reference lines 2330-2359
- ``compute_SDP_relaxation_objective``   — reference lines 1945-1977
- ``compute_MSE``                        — reference lines 2361-2409

Every function accepts numpy arrays or torch tensors and returns a 0-d
tensor on the device of ``X``.  ``indices`` is a boolean (n, m) observation
mask.
"""

from __future__ import annotations

import torch


def _t(a, like=None):
    if isinstance(a, torch.Tensor):
        return a
    t = torch.as_tensor(a)
    if like is not None:
        t = t.to(like.device)
    return t


def evaluate_objective(X, A, indices, U, gamma):
    """Exact master objective of a candidate completion ``X``:
    ``(1/2) sum_{(i,j) in indices} (X_ij - A_ij)^2 + (1/(2 gamma)) ||X||_F^2``.

    ``U`` is accepted for API parity with the reference (which validates its
    shape but does not use it in the value)."""
    X = _t(X)
    A = _t(A, X)
    mask = _t(indices, X).to(torch.bool)
    fit = 0.5 * torch.sum(torch.where(mask, (X - A) ** 2, torch.zeros_like(X)))
    reg = (0.5 / gamma) * torch.sum(X**2)
    return fit + reg


def compute_SDP_relaxation_objective(
    X, Y, Theta, U, A, indices, gamma, *, add_Shor_valid_inequalities=False, W=None
):
    """Recompute the node-relaxation objective from solution values
    (reference lines 1882-1896): ``(1/2) sum_Omega (A_ij - X_ij)^2 +
    (1/(2 gamma)) tr(Theta)``, or the W-linearised square with Shor
    inequalities."""
    X = _t(X)
    A = _t(A, X)
    mask = _t(indices, X).to(torch.bool)
    Theta = _t(Theta, X)
    reg = (0.5 / gamma) * torch.trace(Theta)
    zero = torch.zeros_like(X)
    if add_Shor_valid_inequalities:
        if W is None:
            raise ValueError("W is required when add_Shor_valid_inequalities=True")
        W = _t(W, X)
        fit = 0.5 * torch.sum(torch.where(mask, A**2 - 2.0 * A * X + W, zero))
    else:
        fit = 0.5 * torch.sum(torch.where(mask, (A - X) ** 2, zero))
    return fit + reg


def compute_MSE(X, A, indices, *, kind: str = "out"):
    """Mean-squared error of ``X`` vs ``A`` over "in" (observed), "out"
    (unobserved) or "all" entries, with the reference's 0.0 conventions for
    empty entry sets."""
    X = _t(X)
    A = _t(A, X)
    mask = _t(indices, X).to(X.dtype)
    sq = (X - A) ** 2
    total = mask.numel()
    n_obs = torch.sum(mask)
    if kind == "out":
        denom = total - n_obs
        val = torch.sum(sq * (1.0 - mask))
        return torch.where(denom == 0, torch.zeros_like(val), val / torch.clamp(denom, min=1.0))
    elif kind == "in":
        val = torch.sum(sq * mask)
        return torch.where(n_obs == 0, torch.zeros_like(val), val / torch.clamp(n_obs, min=1.0))
    elif kind == "all":
        return torch.sum(sq) / total
    else:
        raise ValueError(
            'Input argument `kind` not recognized! Must be one of "out", "in", or "all".'
        )
