"""Batched cone projections (port of ``omc/ops/cones.py``).

Closed-form projections used by the ADMM w-step and the safe dual bound.
All functions accept leading batch dimensions.
"""

from __future__ import annotations

import torch


# cuSOLVER's batched eigh rejects batches of 32768 or more small matrices
# (CUSOLVER_STATUS_INVALID_VALUE; measured with 5x5 float32 and float64
# batches on an H100, torch 2.11 + CUDA 12.8), and the Shor minor slots
# come in batches of up to B * 4096
_EIGH_CHUNK = 16384


def eigh(M):
    """``torch.linalg.eigh`` of a (..., d, d) batch of any size, in chunks
    of at most ``_EIGH_CHUNK`` matrices."""
    flat = M.reshape(-1, *M.shape[-2:])
    if flat.shape[0] <= _EIGH_CHUNK:
        return torch.linalg.eigh(M)
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)]
    w = torch.cat([p[0] for p in parts]).reshape(M.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(M.shape)
    return w, V


def symmetrize(M):
    return 0.5 * (M + M.transpose(-1, -2))


def project_psd(M):
    """Project symmetric matrices (..., d, d) onto the PSD cone (eigh)."""
    M = symmetrize(M)
    w, V = eigh(M)
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


def project_rsoc(u, v, x):
    """Project onto the rotated second-order cone
    {(u, v, x): 2 u v >= ||x||^2, u >= 0, v >= 0}, through the isometry
    (u, v) -> ((u+v)/sqrt2, (u-v)/sqrt2) onto the standard SOC
    {(t, (s, x)): ||(s, x)|| <= t}.  ``u``, ``v``: (...,); ``x``: (..., d)."""
    s2 = torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device))
    t = (u + v) / s2
    s = (u - v) / s2
    z = torch.cat([s[..., None], x], dim=-1)
    t_p, z_p = project_soc(t, z)
    s_p = z_p[..., 0]
    u_p = (t_p + s_p) / s2
    v_p = (t_p - s_p) / s2
    return u_p, v_p, z_p[..., 1:]
