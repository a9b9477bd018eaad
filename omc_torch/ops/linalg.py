"""Batched masked ridge least-squares primitives of alternating
minimisation (port of ``omc/ops/linalg.py``).

Both altmin subproblems are (masked) ridge least squares with a closed
form: batched k x k solves assembled by masked products.  The port writes
the batch dimension out: ``U`` (B, n, k), ``V`` (B, k, m), and ``A`` /
``mask`` (n, m) shared by the batch.

``v_step`` and ``u_step_unconstrained`` are the wrappers of kernel K6
(``csrc/k6_altmin.cu``, any k): a CPU tensor takes the plain version
(``v_step_plain``, ``u_step_unconstrained_plain``: batched LU solves), a
CUDA tensor takes the kernel (Cholesky solves of the same SPD, ridged
systems, on the path and tiling ``k6_plan`` picks: the register paths to
k = 10, the wide path beyond; a float64 tensor its float64 build) or
raises.
"""

from __future__ import annotations

import functools

import torch

from omc_torch import kernels

# the register paths ("tile", "slots") hold a lane's Gram in registers up
# to k = K6_MAX_K; the wide path takes every k beyond (and any k forced)
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
# the wide path: warps a CTA (an output each, one slot), rows a chunk, and
# the shared memory a CTA may take
K6_WIDE, K6_WIDE_WARPS, K6_WIDE_SMEM = "wide", 8, 232448


def k6_smem_bytes(path: str, k: int, S: int, W: int, rpw: int, dtype=torch.float32) -> int:
    """K6's dynamic shared memory (``omc_k6_smem_bytes``) at ``dtype``'s
    element size.  Tile path: per r range the padded tiles of mask and A
    of min(32, rpw) rows, per warp a factor chunk; the combine reuses it for
    the S (W - 1) partial Grams.  Slots path: two buffers (cp.async double
    buffering), each the 32 slots' rpw factor rows as they lie in the
    factor (a slot stride of an odd number of 16-byte units), then the W
    outputs' mask and A rows."""
    e = dtype.itemsize
    if path == K6_WIDE:
        # the chunk's rpw rows of k, each warp's 32 weights and weighted A,
        # its tri(k) + k entries where they are in shared memory (S = 1),
        # then each warp's 32 int32 row indices
        return e * (rpw * k + 2 * W * K6_TILE + (S * W * (k * (k + 1) // 2 + k))) + 4 * W * K6_TILE
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

    - ``wide`` (k > ``K6_MAX_K``, or forced): a warp per output, W =
      ``K6_WIDE_WARPS`` outputs of one slot a CTA, the slot's rows in
      chunks of ``rpw`` = 32 (fewer past k ~ 200); a lane's share of the
      packed Gram and right-hand side (tri(k) + k values) in shared memory
      where the W warps' fit (``S`` = 1), else in a global workspace of
      ``ws_bytes`` (``S`` = 0) behind the (1/gamma) F'F scratch of
      ``gram_bytes``.  No rank limit of its own: the wrapper refuses a
      workspace the card has no room for.

    ``dtype`` float64 plans the float64 build: the same rules, 16-byte
    pieces of two doubles (R k even), slots-path CTAs of at most
    ``K6_SLOTS_MAX_WARPS_F64`` warps, the shared memory at 8 bytes a value.

    ``path`` forces one (timing); the default picks by shape.  (Cached: the
    altmin loop asks for the same shapes every iteration; do not mutate the
    returned dict.)"""
    if k < 1:
        raise ValueError(f"K6 takes k >= 1, got k = {k}")
    if path == K6_WIDE or (path is None and k > K6_MAX_K):
        return _k6_wide_plan(B, O, k, dtype)
    if k > K6_MAX_K:
        raise ValueError(f"K6's {path} path holds a Gram in registers: k <= {K6_MAX_K}, got "
                         f"k = {k} (the wide path takes it)")
    vw = 16 // dtype.itemsize
    rows16 = R * k % vw == 0  # a slot's factor rows start on 16 bytes
    if path is None:
        big = B >= K6_SLOTS_MIN_B and R >= K6_SLOTS_MIN_R
        path = "slots" if big and rows16 else "tile"
    if path not in K6_PATHS:
        raise ValueError(f"K6: unknown path {path!r}, expected one of "
                         f"{K6_PATHS + (K6_WIDE,)}")
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


def _k6_wide_plan(B, O, k, dtype):
    e, NT, W = dtype.itemsize, k * (k + 1) // 2, K6_WIDE_WARPS

    def smem(S, rpw):
        return k6_smem_bytes(K6_WIDE, k, S, W, rpw, dtype)

    ws = smem(1, K6_TILE) > K6_WIDE_SMEM
    S = 0 if ws else 1
    # chunks of 32 rows, fewer only where 32 rows of k pass a CTA's shared
    # memory (k in the hundreds)
    rpw = next((r for r in (32, 16, 8, 4, 2, 1) if smem(S, r) <= K6_WIDE_SMEM), None)
    if rpw is None:
        raise ValueError(f"K6's wide path: one row of k = {k} takes {smem(S, 1)} bytes of "
                         f"shared memory, above {K6_WIDE_SMEM}")
    return dict(path=K6_WIDE, S=S, W=W, rpw=rpw, threads=32 * W, grid=(-(-O // W), B),
                smem_bytes=smem(S, rpw), gram_bytes=e * B * NT,
                ws_bytes=e * B * O * (NT + k) if ws else 0)


def _k6(fn_name, F, f_shape, A, mask, gamma, ridge_eps, k, out_shape, R, O, path):
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"K6: unsupported device {dev}")
    B, (n, m) = F.shape[0], A.shape
    dt = F.dtype
    plan = k6_plan(B, R, O, k, path, dt)
    slots = plan["path"] != "tile"  # rows of k: the slots and wide paths
    if slots and fn_name == "omc_k6_ustep":
        # the slots path copies rows of k: V (B, k, m) goes in as (B, m, k)
        F, f_shape = F.transpose(-1, -2), (B, m, k)
    F, A, mask = F.contiguous(), A.contiguous(), mask.contiguous()
    if slots and F.data_ptr() % 16:  # its copies start on 16 bytes
        F = F.clone()
    p = kernels.block(kernels.K6Params, dt)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    p.B, p.n, p.m, p.k = B, n, m, k
    p.path = (K6_PATHS + (K6_WIDE,)).index(plan["path"])
    p.S, p.W, p.rpw = plan["S"], plan["W"], plan["rpw"]
    p.F = kernels.check("factor", F, f_shape, dev, dt)
    p.A = kernels.check("A", A, (n, m), dev, dt)
    p.mask = kernels.check("mask", mask, (n, m), dev, dt)
    p.out = out.data_ptr()
    if plan["path"] == "slots":  # (1/gamma) F'F of each slot
        gram = torch.empty((B, k * (k + 1) // 2), dtype=dt, device=dev)
        p.gram = gram.data_ptr()
    elif plan["path"] == K6_WIDE:  # and the wide path's workspace behind it
        need = plan["gram_bytes"] + plan["ws_bytes"]
        if plan["ws_bytes"]:
            free = torch.cuda.mem_get_info(dev)[0]
            if need > free:
                raise ValueError(f"K6's wide path at (B, R, O, k) = ({B}, {R}, {O}, {k}): its "
                                 f"workspace takes {need} bytes, the card has {free} free")
        gram = torch.empty(need // dt.itemsize, dtype=dt, device=dev)
        p.gram = gram.data_ptr()
    p.inv_gamma, p.ridge_eps = 1.0 / gamma, ridge_eps
    if B:
        kernels.launch("K6w" if plan["path"] == K6_WIDE else "K6", kernels.entry(fn_name, dt),
                       p, dev)
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
