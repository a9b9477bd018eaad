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
systems, on the tiling ``k6_plan`` picks; a float64 tensor its float64
build) or raises.
"""

from __future__ import annotations

import functools

import torch

from omc_torch import kernels

K6_MAX_K = 10
# K6's tiling: lanes a warp, the tile path's r-range granularity, warps a
# CTA, the warps the tile path aims to have resident on the H100 (132 SMs,
# 16 warps each), the CTAs the slots path aims for, and the smallest batch
# and reduction length that take the slots path
K6_TILE, K6_UNIT, K6_MAX_WARPS, K6_TARGET_WARPS = 32, 8, 8, 132 * 16
K6_SLOTS_MAX_WARPS, K6_SLOTS_CTAS, K6_SLOTS_MIN_B, K6_SLOTS_MIN_R = 16, 100, 32, 512
K6_PATHS = ("tile", "slots")
# the float64 build's slots-path CTAs run at most 8 warps (its Gram takes
# twice the registers: 255 a thread at k = 10)
K6_SLOTS_MAX_WARPS_F64 = 8


def k6_smem_bytes(path: str, k: int, S: int, W: int, rpw: int, dtype=torch.float32) -> int:
    """K6's dynamic shared memory (``omc_k6_smem_bytes``) at ``dtype``'s
    element size.  Tile path: per r range the padded tiles of mask and A
    of min(32, rpw) rows, per warp a factor chunk; the combine reuses it for
    the S (W - 1) partial Grams.  Slots path: two buffers (cp.async double
    buffering), each the 32 slots' rpw factor rows as they lie in the
    factor (a slot stride of an odd number of 16-byte units), then the W
    outputs' mask and A rows."""
    e = dtype.itemsize
    if path == "slots":
        vw = 16 // e  # values of a 16-byte unit
        chunk = (rpw * k + vw - 1) & ~(vw - 1)
        return 2 * e * (K6_TILE * (chunk + (vw if (chunk // vw) % 2 == 0 else 0)) + 2 * W * rpw)
    ch = min(rpw, K6_TILE)
    stage = W * 2 * ch * (K6_TILE + 1) + S * W * ch * ((k + 3) & ~3)
    comb = S * (W - 1) * (k * (k + 1) // 2 + k) * K6_TILE
    return e * max(stage, comb)


@functools.lru_cache(maxsize=256)
def k6_plan(B: int, R: int, O: int, k: int, path: str | None = None,
            dtype=torch.float32) -> dict:
    """K6's path and tiling for B slots, R reduction indices (n for the
    V-step, m for the U-step) and O outputs.

    - ``tile`` (lanes = outputs): a CTA serves 32 outputs of ``S`` slots
      with S x W warps, warp (s, w) summing rows [w rpw, (w + 1) rpw) of
      slot s.  W grows until the grid has about ``K6_TARGET_WARPS`` warps
      (at most 8, each range at least 8 rows); the S slots of a CTA share
      its staged mask and A tiles where W leaves room.
    - ``slots`` (lanes = 32 slots, a warp per output; batches of at least
      ``K6_SLOTS_MIN_B``, R of at least ``K6_SLOTS_MIN_R`` and R k a
      multiple of 4, so each slot's rows copy in 16-byte pieces): a warp skips
      the r its output does not observe; a CTA of W warps serves W outputs
      (16, fewer where the grid would have under ``K6_SLOTS_CTAS`` CTAs),
      streaming the slots' factor rows in chunks of ``rpw`` = 32.

    ``dtype`` float64 plans the float64 build: the same rules, 16-byte
    pieces of two doubles (R k even), slots-path CTAs of at most
    ``K6_SLOTS_MAX_WARPS_F64`` warps, the shared memory at 8 bytes a value.

    ``path`` forces one (timing); the default picks by shape.  (Cached: the
    altmin loop asks for the same shapes every iteration; do not mutate the
    returned dict.)"""
    if not 1 <= k <= K6_MAX_K:
        raise ValueError(f"K6 takes 1 <= k <= {K6_MAX_K}, got k = {k}")
    vw = 16 // dtype.itemsize
    rows16 = R * k % vw == 0  # a slot's factor rows start on 16 bytes
    if path is None:
        big = B >= K6_SLOTS_MIN_B and R >= K6_SLOTS_MIN_R
        path = "slots" if big and rows16 else "tile"
    if path not in K6_PATHS:
        raise ValueError(f"K6: unknown path {path!r}, expected one of {K6_PATHS}")
    if path == "slots" and not rows16:
        raise ValueError(f"K6: the slots path copies 16-byte pieces; R k = {R * k} is not "
                         f"a multiple of {vw}")
    if path == "slots":
        groups = -(-B // K6_TILE)
        most = K6_SLOTS_MAX_WARPS_F64 if dtype == torch.float64 else K6_SLOTS_MAX_WARPS
        W = next((w for w in (16, 8, 4, 2) if w <= most and -(-O // w) * groups >= K6_SLOTS_CTAS),
                 1)
        S, rpw, grid = 1, K6_TILE, (-(-O // W), groups)
    else:
        tiles = -(-O // K6_TILE)
        units = max(1, -(-R // K6_UNIT))
        need = -(-K6_TARGET_WARPS // max(1, tiles * B))
        W = max(1, min(K6_MAX_WARPS, units, need))
        rpw = K6_UNIT * -(-units // W)
        W = -(-units // (rpw // K6_UNIT))
        S = max(1, min(B, K6_MAX_WARPS // W, 4))
        grid = (tiles, -(-B // S))
    return dict(path=path, S=S, W=W, rpw=rpw, threads=32 * S * W, grid=grid,
                smem_bytes=k6_smem_bytes(path, k, S, W, rpw, dtype))


def _k6(fn_name, F, f_shape, A, mask, gamma, ridge_eps, k, out_shape, R, O, path):
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"K6: unsupported device {dev}")
    B, (n, m) = F.shape[0], A.shape
    dt = F.dtype
    plan = k6_plan(B, R, O, k, path, dt)
    slots = plan["path"] == "slots"
    if slots and fn_name == "omc_k6_ustep":
        # the slots path copies rows of k: V (B, k, m) goes in as (B, m, k)
        F, f_shape = F.transpose(-1, -2), (B, m, k)
    F, A, mask = F.contiguous(), A.contiguous(), mask.contiguous()
    if slots and F.data_ptr() % 16:  # its copies start on 16 bytes
        F = F.clone()
    p = kernels.block(kernels.K6Params, dt)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    p.B, p.n, p.m, p.k = B, n, m, k
    p.path = K6_PATHS.index(plan["path"])
    p.S, p.W, p.rpw = plan["S"], plan["W"], plan["rpw"]
    p.F = kernels.check("factor", F, f_shape, dev, dt)
    p.A = kernels.check("A", A, (n, m), dev, dt)
    p.mask = kernels.check("mask", mask, (n, m), dev, dt)
    p.out = out.data_ptr()
    if slots:  # (1/gamma) F'F of each slot
        gram = torch.empty((B, k * (k + 1) // 2), dtype=dt, device=dev)
        p.gram = gram.data_ptr()
    p.inv_gamma, p.ridge_eps = 1.0 / gamma, ridge_eps
    if B:
        kernels.launch("K6", kernels.entry(fn_name, dt), p, dev)
    return out


def v_step(U, A, mask, gamma, ridge_eps=1e-10, *, path=None):
    """K6's V-step on a CUDA tensor (``path`` forces a ``k6_plan`` path),
    ``v_step_plain`` on a CPU tensor."""
    if U.device.type == "cpu":
        return v_step_plain(U, A, mask, gamma, ridge_eps)
    (B, _, k), (n, m) = U.shape, A.shape
    return _k6("omc_k6_vstep", U, (B, n, k), A, mask, gamma, ridge_eps, k, (B, k, m), n, m,
               path)


def u_step_unconstrained(V, A, mask, gamma, ridge_eps=1e-10, *, path=None):
    """K6's U-step on a CUDA tensor (``path`` forces a ``k6_plan`` path),
    ``u_step_unconstrained_plain`` on a CPU tensor."""
    if V.device.type == "cpu":
        return u_step_unconstrained_plain(V, A, mask, gamma, ridge_eps)
    (B, k, _), (n, m) = V.shape, A.shape
    return _k6("omc_k6_ustep", V, (B, k, m), A, mask, gamma, ridge_eps, k, (B, n, k), m, n,
               path)


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
