"""Batched masked ridge least-squares primitives of alternating
minimisation (port of ``omc/ops/linalg.py``).

Both altmin subproblems are (masked) ridge least squares with a closed
form: batched k x k solves assembled by masked products.  The port writes
the batch dimension out: ``U`` (B, n, k), ``V`` (B, k, m), and ``A`` /
``mask`` (n, m) shared by the batch.
"""

from __future__ import annotations

import torch


def v_step(U, A, mask, gamma, ridge_eps=1e-10):
    """argmin_V  1/2 sum_Omega (UV - A)^2 + 1/(2 gamma) ||U V||_F^2.

    Column-separable: per column j of V,
      (U^T diag(w_j) U + (1/gamma) U^T U) v_j = U^T (w_j * a_j).
    U: (B, n, k).  Returns V: (B, k, m)."""
    k = U.shape[-1]
    G = torch.einsum("bnk,nm,bnl->bmkl", U, mask, U)  # (B, m, k, k)
    G = G + (1.0 / gamma) * (U.transpose(-1, -2) @ U)[:, None, :, :]
    G = G + ridge_eps * torch.eye(k, dtype=U.dtype, device=U.device)
    rhs = (U.transpose(-1, -2) @ (mask * A)).transpose(-1, -2)  # (B, m, k)
    if k == 1:  # scalar closed form
        V = rhs / G[..., 0]
    else:
        V = torch.linalg.solve(G, rhs[..., None])[..., 0]
    return V.transpose(-1, -2)


def u_step_unconstrained(V, A, mask, gamma, ridge_eps=1e-10):
    """argmin_U  1/2 sum_Omega (UV - A)^2 + 1/(2 gamma) ||U V||_F^2.

    Row-separable: per row i of U,
      (V diag(w_i) V^T + (1/gamma) V V^T) u_i = V (w_i * a_i).
    V: (B, k, m).  Returns U: (B, n, k)."""
    k = V.shape[-2]
    H = torch.einsum("bkm,nm,blm->bnkl", V, mask, V)  # (B, n, k, k)
    H = H + (1.0 / gamma) * (V @ V.transpose(-1, -2))[:, None, :, :]
    H = H + ridge_eps * torch.eye(k, dtype=V.dtype, device=V.device)
    rhs = (mask * A) @ V.transpose(-1, -2)  # (B, n, k)
    if k == 1:
        U = rhs / H[..., 0]
    else:
        U = torch.linalg.solve(H, rhs[..., None])[..., 0]
    return U
