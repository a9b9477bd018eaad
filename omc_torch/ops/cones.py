"""Batched cone projections and eigendecompositions (port of
``omc/ops/cones.py``).

Closed-form projections used by the ADMM w-step and the safe dual bound.
All functions accept leading batch dimensions.

``eigvalsh`` and ``project_psd`` are the wrappers of kernels K4
(``csrc/k4_jacobi.cu``: parallel Jacobi, one CTA per matrix, or block
Jacobi spread over all SMs; in float64 also the tridiagonal path of
``csrc/k4_tridiag.cu``; ``k4_plan`` picks the path) and K4s
(``csrc/k4s_jacobi_small.cu``: the PSD projection of matrices up to 8 x 8,
one thread each).  A CPU tensor takes the plain version, LAPACK through
``torch.linalg`` (the float64 host certificates of the Shor bounds go
through it); a CUDA tensor takes the kernel or raises.  Both kernels have a
float64 build, which a float64 CUDA tensor takes (``kernels.entry``): the
same schedules at double's epsilon, with outputs in float64.
"""

from __future__ import annotations

import torch

from omc_torch import kernels

# cuSOLVER's batched eigh rejects batches of 32768 or more small matrices
# (CUSOLVER_STATUS_INVALID_VALUE; measured with 5x5 float32 and float64
# batches on an H100, torch 2.11 + CUDA 12.8), and the Shor minor slots
# come in batches of up to B * 4096; the plain versions chunk on any device
_EIGH_CHUNK = 16384
# the largest matrices K4s takes (one thread per matrix, in registers)
K4S_MAX_D = 8


def eigh_plain(M):
    """``torch.linalg.eigh`` of a (..., d, d) batch of any size, in chunks
    of at most ``_EIGH_CHUNK`` matrices."""
    flat = M.reshape(-1, *M.shape[-2:])
    if flat.shape[0] <= _EIGH_CHUNK:
        return torch.linalg.eigh(M)
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)]
    w = torch.cat([p[0] for p in parts]).reshape(M.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(M.shape)
    return w, V


def project_psd_plain(M):
    """Project symmetric matrices (..., d, d) onto the PSD cone: symmetrise,
    eigh, clamp the eigenvalues at 0 (plain version of K4/K4s)."""
    M = symmetrize(M)
    w, V = eigh_plain(M)
    w = torch.clamp(w, min=0.0)
    return (V * w[..., None, :]) @ V.transpose(-1, -2)


def _cuda(name, M):
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if M.ndim < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"{name}: expected (..., d, d) matrices, got {tuple(M.shape)}")
    return dev


# K4's geometry (csrc/k4_jacobi.cu): the shared memory one CTA may use on
# the H100, the CTA path's head of per-pair and per-index scratch, and the
# block path's control words and block width
K4_SMEM_MAX = 232448
K4_CTL = 16
K4_WIDTH = 16
K4_PATHS = ("cta", "block16")
# where the CTA path beats the block path (H100 measurements of both at
# B = 1, 4, 32, 64 and d = 50 to 200, PERF.md): eigenvalues of matrices up
# to K4_CTA_EIGVALS_D at any batch; vectors of matrices up to
# K4_CTA_VECTORS_D at batches of K4_CTA_VECTORS_B or more (at B <= 4 the
# block path's chain of few rounds wins at d = 100 and ties at d = 51);
# each only while A (and V) fit in its shared memory
K4_CTA_EIGVALS_D = 150
K4_CTA_VECTORS_D, K4_CTA_VECTORS_B = 100, 64
# the float64 build's third path (csrc/k4_tridiag.cu): Householder
# reduction in one CTA a matrix, then a warp an eigenvalue or a vector over
# the card; it takes d up to K4_TRI_MAX_D (the float64 triangle fits one
# CTA's shared memory) and an explicit M (not K5's U U' - Y).  The plan
# sends every float64 mode of order K4_TRI_MIN_D..K4_TRI_MAX_D there at
# every batch, and below K4_TRI_MIN_D a batch of at most K4_TRI_SMALL_B
# matrices from d = K4_TRI_SMALL_D[mode] on.  H100 measurements of the
# three paths (chip_smoke.py, PERF.md): the tridiagonal path the fastest at
# every shape of d = 50 to 200 and B = 1 to 64, and below d = 32 at B <= 64
# in modes 0 and 1 from d = 9 and in mode 2 at d = 24 (the CTA path at d =
# 9 and 17 in mode 2); the CTA path the faster at d = 17 from 1,024
# matrices and at the Shor bounds' 131,072 XWH slots of d = 9 and 17
K4_TRI = "tri"
K4_F64_PATHS = K4_PATHS + (K4_TRI,)
K4_TRI_SMALL_B, K4_TRI_SMALL_D = 64, (9, 9, 24)
K4_TRI_MIN_D, K4_TRI_MAX_D = 32, 234
K4_PATH_CODES = {"cta": 0, "block16": 1, K4_TRI: 2}


def k4_cta_smem_bytes(d, mode, dtype=torch.float32):
    """The CTA path's shared memory (``cta_smem_bytes`` in the kernel's
    source, ``omc_k4_cta_smem_bytes``): the per-pair and per-index head and
    A (and, with vectors, V), every slot one value of ``dtype``."""
    ld = d | 1
    head = 6 * ((d + 1) // 2) + 32 + 3 * d + 1
    return dtype.itemsize * (head + d * ld * (2 if mode else 1))


def k4_cta_fits(d, mode, dtype=torch.float32):
    """Whether the CTA path holds A (and, with vectors, V) of order ``d``
    in one CTA's shared memory: in float32 up to d = 237 for eigenvalues,
    168 with vectors; in float64 up to 167 and 118."""
    return k4_cta_smem_bytes(d, mode, dtype) <= K4_SMEM_MAX


def k4_block_geometry(d, mode, dtype=torch.float32):
    """The block path's schedule and workspace (``BGeom`` in the kernel's
    source): ``nb`` blocks of ``K4_WIDTH``, ``rounds`` per outer sweep (with
    a bye block when ``nb`` is odd), ``pairs`` per round, the padded order
    ``D``, the workspace values per matrix (``mat_floats``, in ``dtype``)
    and their bytes."""
    nb = -(-d // K4_WIDTH)
    Nb = nb + (nb & 1)
    P, D, N2 = Nb // 2, Nb * K4_WIDTH, 2 * K4_WIDTH
    floats = D * D * (2 if mode else 1) + P * N2 * N2 + D + (P + 4 + 3) // 4 * 4
    return dict(nb=nb, rounds=Nb - 1, pairs=P, D=D, mat_floats=floats,
                mat_bytes=floats * dtype.itemsize)


def k4_tri_smem_bytes(d):
    """The tridiagonal path's reduction CTA (``reduce_smem`` in
    ``csrc/k4_tridiag.cu``): 6 d + 8 doubles of head, then the packed
    float64 triangle; 0 where it does not fit (d > ``K4_TRI_MAX_D``)."""
    b = 8 * (6 * d + 8 + d * (d + 1) // 2)
    return b if b <= K4_SMEM_MAX else 0


def k4_tri_workspace(B, d, mode):
    """The tridiagonal path's workspace in doubles (``TGeom`` in
    ``csrc/k4_tridiag.cu``): per matrix T's diagonal and off-diagonal, the
    reflectors' tau, the eigenvalues, each vector's eigenvalue, 8 control
    values, and (modes 1, 2) the reflectors and the vectors (d^2 each)."""
    return B * (5 * d + 8 + (2 * d * d if mode else 0))


def k4_plan(B, d, mode, path=None, dtype=torch.float32, sep=False):
    """K4's path for ``B`` matrices of order ``d`` in ``mode``: in float32
    the CTA path (one CTA per matrix) where it wins (``K4_CTA_*`` above),
    else the block path (blocks of 16); in float64 the tridiagonal path
    ("tri") at orders ``K4_TRI_MIN_D`` to ``K4_TRI_MAX_D`` and, at batches
    of at most ``K4_TRI_SMALL_B``, from ``K4_TRI_SMALL_D[mode]``, else the
    CTA path wherever A (and V) fit its shared memory, else the block path.
    ``path`` (one of ``K4_PATHS``, or in float64 ``K4_F64_PATHS``) forces
    it; the CTA path raises ``ValueError`` where A (and V) do not fit, the
    tridiagonal path past ``K4_TRI_MAX_D`` or on float32 operands.  ``sep``:
    the matrices are K5's U U' - Y, which the tridiagonal path does not
    form (the plan keeps the Jacobi paths).  Returns a dict: ``path``,
    ``workspace_floats`` (the whole call's values of ``dtype``, as
    ``omc_k4_workspace_floats`` reports it), ``workspace_bytes``,
    ``smem_bytes`` (a CTA's on the CTA path) and ``rounds`` per outer sweep
    on the block path (two grid barriers each; 0 on the CTA path)."""
    f64 = dtype == torch.float64
    if path is None and f64 and not sep and d <= K4_TRI_MAX_D and (
            d >= K4_TRI_MIN_D or (B <= K4_TRI_SMALL_B and d >= K4_TRI_SMALL_D[mode])):
        path = K4_TRI
    if path == K4_TRI:
        if not f64:
            raise ValueError(f"K4's tridiagonal path takes float64 operands, not {dtype}")
        if not k4_tri_smem_bytes(d):
            raise ValueError(f"K4's tridiagonal path: d={d} above {K4_TRI_MAX_D}")
        n = k4_tri_workspace(B, d, mode)
        return dict(path=path, workspace_floats=n, workspace_bytes=8 * n, rounds=0,
                    smem_bytes=k4_tri_smem_bytes(d))
    if path is None:
        if f64:
            cta = True
        elif mode == 0:
            cta = d <= K4_CTA_EIGVALS_D
        else:
            cta = d <= K4_CTA_VECTORS_D and B >= K4_CTA_VECTORS_B
        path = "cta" if cta and k4_cta_fits(d, mode, dtype) else "block16"
    if path not in K4_PATHS:
        raise ValueError(f"K4 path must be one of {K4_F64_PATHS if f64 else K4_PATHS}, "
                         f"got {path!r}")
    if path == "cta":
        if not k4_cta_fits(d, mode, dtype):
            raise ValueError(f"K4's CTA path: d={d} (mode {mode}, {dtype}) does not fit "
                             "shared memory")
        return dict(path=path, workspace_floats=0, workspace_bytes=0, rounds=0,
                    smem_bytes=k4_cta_smem_bytes(d, mode, dtype))
    geo = k4_block_geometry(d, mode, dtype)
    n = K4_CTL + B * geo["mat_floats"]
    return dict(path=path, workspace_floats=n, workspace_bytes=n * dtype.itemsize,
                rounds=geo["rounds"], smem_bytes=0)


def k4_jacobi(M=None, mode=0, nout=None, *, U=None, Y=None, sweeps=None, path=None,
              stats=None):
    """Launch K4 on a (..., d, d) batch ``M`` (or K5 on ``U`` (B, d, k) and
    ``Y`` (B, d, d), the matrices U U' - Y).  ``mode`` 0: eigenvalues
    ascending; 1: the PSD projection; 2: the ``nout`` smallest eigenpairs.
    Each matrix is symmetrised on load.  ``sweeps`` (optional int32, one per
    matrix) receives the sweeps run (``ops.jacobi.MAX_SWEEPS + 1``: the cap
    was hit).  ``path`` forces ``k4_plan``'s path (timing).  ``stats`` (a
    dict, block path): waits for the kernel and fills in its grid barriers,
    the milliseconds its first CTA spent in each phase, barrier included,
    its grid (CTAs) and group (phase 1's warps per block pair); on the
    tridiagonal path it waits and fills in ``vectors``, each matrix's count
    of eigenvectors computed.  Returns
    ``w``, ``P`` or ``(w, V)``, in the operands' dtype (float32, or
    float64 through the float64 build).  On the tridiagonal path (float64
    only) ``sweeps`` receives the most inverse-iteration solves of a
    matrix's vectors (0 in mode 0), and ``MAX_SWEEPS + 1`` where the input
    was not finite or a vector reached dstein's cap; one call is one
    counted launch whatever the kernels it enqueues."""
    key = "K4" if M is not None else "K5"
    if mode not in (0, 1, 2):
        raise ValueError(f"{key}: mode {mode!r} is not 0, 1 or 2")
    src = M if M is not None else Y
    dev = _cuda(key, src)
    lead, d = src.shape[:-2], src.shape[-1]
    Bn = 1
    for x in lead:
        Bn *= x
    nout = d if nout is None else nout
    if not 1 <= nout <= d:
        raise ValueError(f"{key}: nout {nout} outside 1..{d}")
    dt = src.dtype
    plan = k4_plan(Bn, d, mode, path, dt, sep=M is None)
    if plan["path"] == K4_TRI and M is None:
        raise ValueError("K4's tridiagonal path takes M, not K5's U U' - Y")
    p = kernels.block(kernels.K4Params, dt)
    p.B, p.d, p.nout, p.mode, p.k = Bn, d, nout, mode, 0
    p.path = K4_PATH_CODES[plan["path"]]
    if M is not None:
        M = M.contiguous()
        p.M = kernels.check("M", M, M.shape, dev, dt)
    else:
        U, Y = U.contiguous(), Y.contiguous()
        p.k = U.shape[-1]
        p.U = kernels.check("U", U, (Bn, d, p.k), dev, dt)
        p.Y = kernels.check("Y", Y, (Bn, d, d), dev, dt)
    if sweeps is None:
        sweeps = torch.empty(lead, dtype=torch.int32, device=dev)
    p.sweeps = kernels.check("sweeps", sweeps, lead, dev, torch.int32)
    w = V = P = None
    if mode == 1:
        P = torch.empty((*lead, d, d), dtype=dt, device=dev)
        p.P = P.data_ptr()
    else:
        w = torch.empty((*lead, nout), dtype=dt, device=dev)
        p.w = w.data_ptr()
        if mode == 2:
            V = torch.empty((*lead, d, nout), dtype=dt, device=dev)
            p.V = V.data_ptr()
    nwork = kernels.library().omc_k4_workspace_floats(Bn, d, mode, p.path)
    # held until the launch is queued; the caching allocator reuses it only
    # for work queued after this launch on the same stream
    work = torch.empty((nwork,), dtype=dt, device=dev) if nwork else None
    p.work = work.data_ptr() if work is not None else None
    if Bn:
        kernels.launch(key, kernels.entry("omc_k4_jacobi", dt), p, dev)
    if stats is not None and p.path == 1 and Bn:
        # the control words: 32-bit, whatever the workspace's dtype
        words = work[:K4_CTL].cpu().view(torch.int32)[:K4_CTL]  # synchronises
        ns = words[4:8].view(torch.int64)
        stats.update(grid_barriers=int(words[1]), phase1_ms=float(ns[0]) / 1e6,
                     phase2_ms=float(ns[1]) / 1e6, grid=int(words[8]), group=int(words[9]))
    if stats is not None and p.path == 2 and Bn:
        # each matrix's count of vectors (TGeom's ctl slot kCount; 0 in mode 0)
        per = k4_tri_workspace(1, d, mode)
        stats.update(vectors=work.view(Bn, per)[:, 5 * d + 5].cpu().long().tolist()
                     if mode else [0] * Bn)
    return P if mode == 1 else (w if mode == 0 else (w, V))


# K4s's geometry (csrc/k4s_jacobi_small.cu): matrices (threads) a CTA
K4S_THREADS = 128


def k4s_plan(N, D, dtype=torch.float32):
    """K4s's launch for ``N`` matrices of order ``D``: ``ctas`` of
    ``threads`` matrices each (the last one ragged), every matrix staged at
    a row of ``stride`` = D^2 | 1 values (odd) of ``dtype``, ``smem_bytes``
    a CTA (the kernel's ``omc_k4s_grid_x`` and ``omc_k4s_smem_bytes``;
    twice the float32 bytes in float64)."""
    stride = (D * D) | 1
    return dict(ctas=-(-N // K4S_THREADS), threads=K4S_THREADS, stride=stride,
                smem_bytes=dtype.itemsize * K4S_THREADS * stride)


def k4s_project_psd(M, sweeps=None):
    """Launch K4s: the PSD projection of a (..., d, d) batch, d <= 8, one
    thread per matrix, any batch size in one launch (float32, or float64
    through the float64 build)."""
    dev = _cuda("K4s", M)
    d = M.shape[-1]
    if d > K4S_MAX_D:
        raise ValueError(f"K4s takes d <= {K4S_MAX_D}, got {d}")
    M = M.contiguous()
    dt = M.dtype
    p = kernels.block(kernels.K4sParams, dt)
    out = torch.empty(M.shape, dtype=dt, device=dev)
    p.N, p.D = M.numel() // (d * d), d
    p.t = kernels.check("t", M, M.shape, dev, dt)
    p.w = out.data_ptr()
    p.sweeps = kernels.check("sweeps", sweeps, M.shape[:-2], dev, torch.int32) \
        if sweeps is not None else None
    if p.N:
        kernels.launch("K4s", kernels.entry("omc_k4s_jacobi_small", dt), p, dev)
    return out


def eigvalsh(M):
    """Eigenvalues, ascending, of symmetric (..., d, d) matrices: K4 on a
    CUDA tensor, ``torch.linalg.eigvalsh`` on a CPU tensor."""
    if M.device.type == "cpu":
        return torch.linalg.eigvalsh(M)
    return k4_jacobi(M, 0)


def symmetrize(M):
    return 0.5 * (M + M.transpose(-1, -2))


def project_psd(M):
    """Project symmetric matrices (..., d, d) onto the PSD cone: K4s
    (d <= 8) or K4 on a CUDA tensor, ``project_psd_plain`` on a CPU
    tensor."""
    if M.device.type == "cpu":
        return project_psd_plain(M)
    _cuda("project_psd", M)
    if M.shape[-1] <= K4S_MAX_D:
        return k4s_project_psd(M)
    return k4_jacobi(M, 1)


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
