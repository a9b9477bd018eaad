"""Batched cone projections (port of ``omc/ops/cones.py``).

Closed-form projections used by the ADMM w-step and the safe dual bound.
All functions accept leading batch dimensions.  ``project_rsoc`` waits for
the Shor relaxations (ROADMAP queue 1, items 10-11).
"""

from __future__ import annotations

import torch


def symmetrize(M):
    return 0.5 * (M + M.transpose(-1, -2))


def project_psd(M):
    """Project symmetric matrices (..., d, d) onto the PSD cone (eigh)."""
    M = symmetrize(M)
    w, V = torch.linalg.eigh(M)
    w = torch.clamp(w, min=0.0)
    return (V * w[..., None, :]) @ V.transpose(-1, -2)


def project_soc(t, x):
    """Project (t, x) onto the second-order cone {(t, x): ||x|| <= t}.

    ``t``: (...,); ``x``: (..., d).  Returns (t_proj, x_proj)."""
    nx = torch.linalg.vector_norm(x, dim=-1)
    # three cases: inside (nx <= t), polar (nx <= -t), else boundary blend
    inside = nx <= t
    polar = nx <= -t
    pos = nx > 0
    scale = torch.where(
        pos, 0.5 * (1.0 + t / torch.where(pos, nx, torch.ones_like(nx))),
        torch.zeros_like(nx),
    )
    t_b = 0.5 * (t + nx)
    x_b = scale[..., None] * x
    zero_t = torch.zeros_like(t)
    t_out = torch.where(inside, t, torch.where(polar, zero_t, t_b))
    x_out = torch.where(
        inside[..., None], x, torch.where(polar[..., None], torch.zeros_like(x), x_b)
    )
    return t_out, x_out
