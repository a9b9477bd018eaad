"""Batched masked ridge least-squares primitives of alternating
minimisation (port of ``omc/ops/linalg.py``).

Both altmin subproblems are (masked) ridge least squares with a closed
form: batched k x k solves assembled by masked products.  The port writes
the batch dimension out: ``U`` (B, n, k), ``V`` (B, k, m), and ``A`` /
``mask`` (n, m) shared by the batch.

``v_step`` and ``u_step_unconstrained`` are the wrappers of kernel K6
(``csrc/k6_altmin.cu``, k <= 10): a CPU tensor takes the plain version
(``v_step_plain``, ``u_step_unconstrained_plain``: batched LU solves), a
CUDA tensor takes the kernel (Cholesky solves of the same SPD, ridged
systems) or raises.
"""

from __future__ import annotations

import torch

from omc_torch import kernels

K6_MAX_K = 10


def _k6(fn_name, F, f_shape, A, mask, gamma, ridge_eps, k, out_shape):
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"K6: unsupported device {dev}")
    B, (n, m) = F.shape[0], A.shape
    if not 1 <= k <= K6_MAX_K:
        raise ValueError(f"K6 takes 1 <= k <= {K6_MAX_K}, got k = {k}")
    F, A, mask = F.contiguous(), A.contiguous(), mask.contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    p = kernels.K6Params()
    p.B, p.n, p.m, p.k = B, n, m, k
    p.F = kernels.check("factor", F, f_shape, dev)
    p.A = kernels.check("A", A, (n, m), dev)
    p.mask = kernels.check("mask", mask, (n, m), dev)
    p.out = out.data_ptr()
    p.inv_gamma, p.ridge_eps = 1.0 / gamma, ridge_eps
    if B:
        kernels.launch("K6", fn_name, p, dev)
    return out


def v_step(U, A, mask, gamma, ridge_eps=1e-10):
    """K6's V-step on a CUDA tensor, ``v_step_plain`` on a CPU tensor."""
    if U.device.type == "cpu":
        return v_step_plain(U, A, mask, gamma, ridge_eps)
    (B, _, k), (n, m) = U.shape, A.shape
    return _k6("omc_k6_vstep", U, (B, n, k), A, mask, gamma, ridge_eps, k, (B, k, m))


def u_step_unconstrained(V, A, mask, gamma, ridge_eps=1e-10):
    """K6's U-step on a CUDA tensor, ``u_step_unconstrained_plain`` on a
    CPU tensor."""
    if V.device.type == "cpu":
        return u_step_unconstrained_plain(V, A, mask, gamma, ridge_eps)
    (B, k, _), (n, m) = V.shape, A.shape
    return _k6("omc_k6_ustep", V, (B, k, m), A, mask, gamma, ridge_eps, k, (B, n, k))


def v_step_plain(U, A, mask, gamma, ridge_eps=1e-10):
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


def u_step_unconstrained_plain(V, A, mask, gamma, ridge_eps=1e-10):
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
