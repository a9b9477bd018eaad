"""Batched ADMM node relaxation with Shor valid inequalities, rank-1 path
(port of ``omc/sdp/admm_shor.py``; see that module's docstring for the
model and the reference lines).

Beside the base slots of ``omc_torch.sdp.admm`` the relaxation carries:

- lifted variables ``W`` (n, m) >= 0 with the W-linearised objective, and
  pair-indexed ``v1 / v2 / v3`` shared across minors (``shor_encode``),
- per active minor (i1, i2, j1, j2) a 5x5 PSD slot on
  ``[1, X11, X12, X21, X22]`` against ``W``/``V`` entries, built from the
  scaled variables (Xs = X/sX, Ws = W/sX^2) and weighted by sS,
- rotated SOC rows ``W_ij >= X_ij^2`` on the uncovered coordinates,
- Theta-link rows ``Theta_jj = sum_i W_ij`` (m extra Woodbury columns with
  a diagonal Gram block), and the W >= 0 slot.

One iteration on the GPU is six kernel launches, each a wrapper with its
plain PyTorch version beside it (CPU tensors take the plain versions, in
``omc``'s order of operations, so float64 iterates match ``omc``):

1. K2  ``admm.zstep(shor=True)`` -- the base z-step of Y and U;
2. K8a ``shor_zstep``      -- adjoint of the Shor slots, the diagonal solves
   of X, Theta, W, v, the Theta-link correction, sym(Theta), clip(X);
3. K3  ``admm.cone_step``  -- forward map and cone step of the base slots;
4. K1  ``project_psd_ns_multi`` -- the three PSD blocks;
5. K7  ``minor_step``      -- gather, projection and u/EMA of the minors;
6. K8b ``shor_cone_step``  -- RSOC, Theta-link and W >= 0 slots with EMAs.

In float64 (``omc``'s float64 route, ``psd_method="eigh"``) the kernels
are their float64 builds and the projections exact: step 4 is three K4
Jacobi launches and the torch ``psd_epilogue``, step 5 K7's float64 build,
which projects each minor by K4s's Jacobi in registers.

Every ``check_every`` iterations the bias-corrected EMA duals go through
the torch ``safe_dual_bound_shor2`` (its eigendecompositions are kernels
K4 and K4s on the GPU, ``omc_torch.ops.cones``) and the best chunk is kept.
The host certificate ``host_certified_bound_shor`` evaluates the same
closed form in float64 on the CPU (LAPACK eigh, the wrappers' CPU branch).
"""

from __future__ import annotations

import dataclasses
import math
import operator

import torch

from omc_torch import kernels
from omc_torch.ops.cones import eigvalsh, project_psd, project_rsoc
from omc_torch.ops.polar import (
    H100_SMS,
    project_psd_ns_multi,
    project_psd_ns_small,
    psd_epilogue,
)
from omc_torch.sdp.admm import (
    ADMMState,
    _packed,
    cone_step,
    init_admm_state,
    make_consts,
    zstep,
)
from omc_torch.sdp.admm import apply_best_duals as apply_core_best_duals
from omc_torch.sdp.relax import NodeBatch, _np, margin_rel_default, separation_eigpairs
from omc_torch.sdp.shor_encode import INVERSE_FIELDS, ShorBatchHost

# the device form of a Shor batch: a ShorBatchHost whose fields are tensors
# (index tables int32, values in the compute dtype)
ShorBatch = ShorBatchHost
_INT_FIELDS = {"minor_idx", "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "soc_idx",
               *INVERSE_FIELDS}


def shor_batch_to_device(h: ShorBatchHost, dtype, *, device) -> ShorBatch:
    def conv(name, x):
        t = torch.as_tensor(x, device=device)
        return t.to(torch.int32 if name in _INT_FIELDS else dtype).contiguous()

    return ShorBatch(**{f.name: conv(f.name, getattr(h, f.name))
                        for f in dataclasses.fields(h)})


_SHOR_FIELDS = ("W", "v1", "v2", "v3", "w5", "u5", "wr", "ur", "wl", "ul",
                "wp", "up")


@dataclasses.dataclass
class ShorADMMState:
    """The base state plus the Shor slots; field order matches
    ``omc.sdp.admm_shor.ShorADMMState`` (warm slices)."""

    core: ADMMState
    W: torch.Tensor  # (B, n, m) scaled
    v1: torch.Tensor  # (B, P1) scaled
    v2: torch.Tensor
    v3: torch.Tensor
    w5: torch.Tensor  # (B, M5, 5, 5)
    u5: torch.Tensor
    wr: torch.Tensor  # (B, Ms, 3)
    ur: torch.Tensor
    wl: torch.Tensor  # (B, m) Theta-link rows
    ul: torch.Tensor
    wp: torch.Tensor  # (B, n, m) W >= 0 slot
    up: torch.Tensor

    def leaves(self) -> list:
        return self.core.leaves() + [getattr(self, f) for f in _SHOR_FIELDS]

    @classmethod
    def from_leaves(cls, leaves) -> "ShorADMMState":
        leaves = list(leaves)
        nc = len(dataclasses.fields(ADMMState))
        return cls(ADMMState.from_leaves(leaves[:nc]), *leaves[nc:])

    def clone(self) -> "ShorADMMState":
        return ShorADMMState.from_leaves([
            x.clone(memory_format=torch.contiguous_format) for x in self.leaves()
        ])

    def replace(self, **kw) -> "ShorADMMState":
        return dataclasses.replace(self, **kw)


def init_shor_state(B, n, m, k, L, M5, Ms, dtype=torch.float32, *, device,
                    sX=1.0, sT=1.0, rho=0.02, **kw) -> ShorADMMState:
    P1 = P2 = 2 * M5
    P3 = M5

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    core = init_admm_state(B, n, m, k, L, dtype, device=device, sX=sX, sT=sT, rho=rho, **kw)
    return ShorADMMState(
        core=core, W=z(B, n, m), v1=z(B, P1), v2=z(B, P2), v3=z(B, P3),
        w5=z(B, M5, 5, 5), u5=z(B, M5, 5, 5), wr=z(B, Ms, 3), ur=z(B, Ms, 3),
        wl=z(B, m), ul=z(B, m), wp=z(B, n, m), up=z(B, n, m),
    )


def _vec(x, ref):
    """A per-slot scale as a (B,) (or (1,)) tensor like ``ref``."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device).reshape(-1)


def _flat_idx(minor_idx, m):
    """Flat (n*m) int64 indices of the four X/W coordinates of each minor."""
    mi = minor_idx.long()
    i1, i2, j1, j2 = (mi[..., t] for t in range(4))
    return (i1 * m + j1, i1 * m + j2, i2 * m + j1, i2 * m + j2)


def _v_idx(sb: ShorBatch):
    return tuple(getattr(sb, f).long() for f in ("iv1a", "iv1b", "iv2a", "iv2b", "iv3"))


def _minor_blocks(fl, iv, Xf, Wf, v1s, v2s, v3s):
    """The unweighted 5x5 minor slots [1, x; x, W/V], (B, M5, 5, 5)."""
    x11, x12, x21, x22 = (torch.gather(Xf, 1, f) for f in fl)
    w11, w12, w21, w22 = (torch.gather(Wf, 1, f) for f in fl)
    V1a = torch.gather(v1s, 1, iv[0])
    V1b = torch.gather(v1s, 1, iv[1])
    V2a = torch.gather(v2s, 1, iv[2])
    V2b = torch.gather(v2s, 1, iv[3])
    V3 = torch.gather(v3s, 1, iv[4])
    one = torch.ones_like(x11)
    rows = [
        [one, x11, x12, x21, x22],
        [x11, w11, V1a, V2a, V3],
        [x12, V1a, w12, V3, V2b],
        [x21, V2a, V3, w21, V1b],
        [x22, V3, V2b, V1b, w22],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _forward_shor(sb: ShorBatch, Xs, Ws, v1s, v2s, v3s, m, sX, sW, sS=1.0):
    """Shor slot values: the 5x5 minors (sS-weighted, on the scaled
    variables), the RSOC rows (0.5, Ws, Xs) and the W part of the link rows
    ``sum_i sW Ws_ij`` (the caller adds the Theta part).  ``sX``/``sW``/
    ``sS`` are per-slot (B,) scales or python scalars."""
    B = Xs.shape[0]
    sW = _vec(sW, Xs)
    sS = _vec(sS, Xs)
    Xf = Xs.reshape(B, -1)
    Wf = Ws.reshape(B, -1)
    w5 = sS[:, None, None, None] * _minor_blocks(
        _flat_idx(sb.minor_idx, m), _v_idx(sb), Xf, Wf, v1s, v2s, v3s)
    # canonical RSOC layout: slot s is coordinate s, a plain reshape
    wr = sS[:, None, None] * torch.stack([0.5 * torch.ones_like(Wf), Wf, Xf], dim=-1)
    wcol = torch.sum(sW[:, None, None] * Ws, dim=-2)  # (B, m)
    return w5, wr, wcol


def _adjoint_shor(sb: ShorBatch, y5, yr, yl, B, n, m, sX, sW, sS=1.0):
    """Adjoint of the Shor slots -> gradients on (Xs, Ws, v1s, v2s, v3s);
    the Theta part of the link rows is the caller's."""
    sW = _vec(sW, y5)
    sS = _vec(sS, y5)
    y5 = sS[:, None, None, None] * y5
    yr = sS[:, None, None] * yr
    fl = _flat_idx(sb.minor_idx, m)
    iv1a, iv1b, iv2a, iv2b, iv3 = _v_idx(sb)
    y5 = y5 * sb.minor_mask[..., None, None]
    z = lambda P: torch.zeros((B, P), dtype=y5.dtype, device=y5.device)
    gXf = z(n * m)
    gWf = z(n * m)
    # X rows/cols of the symmetric 5x5 dual: coefficient 2 y5[0, c]
    for f, c in zip(fl, (1, 2, 3, 4)):
        gXf = gXf.scatter_add(1, f, 2.0 * y5[..., 0, c])
    for f, c in zip(fl, (1, 2, 3, 4)):
        gWf = gWf.scatter_add(1, f, y5[..., c, c])
    gv1 = z(sb.cnt_v1.shape[1])
    gv2 = z(sb.cnt_v2.shape[1])
    gv3 = z(sb.cnt_v3.shape[1])
    gv1 = gv1.scatter_add(1, iv1a, 2.0 * y5[..., 1, 2])
    gv1 = gv1.scatter_add(1, iv1b, 2.0 * y5[..., 3, 4])
    gv2 = gv2.scatter_add(1, iv2a, 2.0 * y5[..., 1, 3])
    gv2 = gv2.scatter_add(1, iv2b, 2.0 * y5[..., 2, 4])
    gv3 = gv3.scatter_add(1, iv3, 2.0 * (y5[..., 1, 4] + y5[..., 2, 3]))
    # RSOC rows (0.5, Ws, Xs), canonical layout: elementwise adds
    yr = yr * sb.soc_mask[..., None]
    gWf = gWf + yr[..., 1]
    gXf = gXf + yr[..., 2]
    # link rows r_j = Theta_jj - sum_i W_ij on the raw variables
    gW = gWf.reshape(B, n, m) - sW[:, None, None] * yl[:, None, :]
    return gXf.reshape(B, n, m), gW, gv1, gv2, gv3


@dataclasses.dataclass
class _ShorConsts:
    """Per-solve-call Shor constants (as ``omc`` computes them once before
    its loop)."""

    sb: ShorBatch
    fl: tuple  # int64 flat indices of the minors' coordinates
    iv: tuple  # int64 iv1a, iv1b, iv2a, iv2b, iv3
    offs5: torch.Tensor
    offsr: torch.Tensor
    g_link: torch.Tensor  # (B, m)
    cW: torch.Tensor
    dX1: torch.Tensor
    dW1: torch.Tensor
    dv: tuple
    R_X: float  # sqrt(2 gamma ub_bar); the X clip is R_X / sX
    M5: int


def make_shor_consts(c, sb: ShorBatch, core: ADMMState, ub_bar) -> _ShorConsts:
    B, n, m = core.X.shape
    dt = core.X.dtype
    sX_f = core.sX
    sW_f = sX_f * sX_f
    sX = sX_f[:, None, None]
    sW = sX * sX
    sS_f = core.sS
    sS2 = sS_f[:, None]
    sS3 = sS_f[:, None, None]
    # link-row Gram block: diagonal; the link row stays on the raw
    # variables (coefficient sW on W) while W's K'K diagonal is
    # sS^2 cnt_W, so the W share per entry is sW^2 / (sS^2 cnt_W)
    g_link = 2.0 + ((sW_f * sW_f) / (sS_f * sS_f))[:, None] * torch.sum(
        1.0 / torch.clamp(sb.cnt_W, min=1e-30), dim=1
    )
    ss2 = sS3 * sS3
    ss2f = sS2 * sS2
    z = lambda *s: torch.zeros(s, dtype=dt, device=core.X.device)
    offs5, offsr, _ = _forward_shor(sb, z(B, n, m), z(B, n, m), z(*sb.cnt_v1.shape),
                                    z(*sb.cnt_v2.shape), z(*sb.cnt_v3.shape), m,
                                    sX_f, sW_f, sS_f)
    return _ShorConsts(
        sb=sb, fl=_flat_idx(sb.minor_idx, m), iv=_v_idx(sb), offs5=offs5,
        offsr=offsr, g_link=g_link.contiguous(), cW=0.5 * sW * c.mask[None],
        dX1=2.0 * sX * sX + ss2 * sb.cnt_X,
        dW1=ss2 * torch.clamp(sb.cnt_W, min=1.0),
        dv=tuple(ss2f * torch.clamp(cv, min=1.0) for cv in (sb.cnt_v1, sb.cnt_v2, sb.cnt_v3)),
        R_X=math.sqrt(2.0 * c.gamma * ub_bar), M5=sb.minor_mask.shape[1],
    )


# --------------------------------------------------------------------------
# K8a: the Shor part of the z-step
# --------------------------------------------------------------------------


def shor_zstep_plain(c, sc: _ShorConsts, st: ShorADMMState):
    """Plain version of K8a, as the ``omc`` loop body: returns (Xs, Ths, W,
    v1, v2, v3) from the current w/u of every slot."""
    core = st.core
    sb = sc.sb
    B, n, m = core.X.shape
    sX_f = core.sX
    sW_f = sX_f * sX_f
    sX = sX_f[:, None, None]
    sT = core.sT[:, None, None]
    sW = sX * sX
    sS3 = core.sS[:, None, None]
    rho_b = core.rho
    r3 = rho_b[:, None, None]
    r2 = rho_b[:, None]
    y1 = core.w1 - core.u1 - c.offs[0]
    rX = sX * 2.0 * y1[..., :n, n:]
    rTh = sT * y1[..., n:, n:]
    gX5, gW5, gv1, gv2, gv3 = _adjoint_shor(
        sb, (st.w5 - st.u5 - sc.offs5) * sb.minor_mask[..., None, None],
        (st.wr - st.ur - sc.offsr) * sb.soc_mask[..., None],
        st.wl - st.ul, B, n, m, sX_f, sW_f, core.sS,
    )
    gW5 = gW5 + sS3 * (st.wp - st.up)
    yl = st.wl - st.ul
    eye = torch.eye(m, dtype=y1.dtype, device=y1.device)
    rTh_l = sT * yl[:, None, :] * eye
    RX = r3 * (rX + gX5) - c.cX
    RT = r3 * (rTh + rTh_l) - c.cTh
    RW = r3 * gW5 - sc.cW
    zX = RX / (r3 * sc.dX1)
    zTh = RT / (r3 * sT * sT)
    zW = RW / (r3 * sc.dW1)
    zv = tuple((r2 * g) / (r2 * d) for g, d in zip((gv1, gv2, gv3), sc.dv))
    # link columns: s_j = sT zTh[j, j] - sW sum_i zW[i, j]
    s_l = sT[..., 0] * torch.diagonal(zTh, dim1=-2, dim2=-1) - sW[..., 0] * torch.sum(zW, dim=1)
    t_l = rho_b[:, None] * s_l / sc.g_link
    zTh = zTh - (t_l / (rho_b[:, None] * sT[..., 0]))[:, None, :] * eye
    zW = zW + sW * t_l[:, None, :] / (r3 * sc.dW1)
    Ths = 0.5 * (zTh + zTh.transpose(-1, -2))
    R_Xs = sc.R_X / sX
    Xs = torch.minimum(torch.maximum(zX, -R_Xs), R_Xs)
    return (Xs, Ths, zW) + zv


# K8a's geometry (csrc/k8_shor.cu): CTAs of 256 threads, Theta's 32 x 32
# tile pairs, clusters of at most 8 CTAs (the portable size) on the X/W
# coordinates, and the H100's shared memory a CTA
K8A_THREADS, K8A_TILE, K8A_CLUSTER_MAX = 256, 32, 8
K8A_SMEM_MAX = 232448
# the coordinates' CTAs of all slots the plan widens the column groups to:
# four an SM
K8A_TARGET_CTAS = 4 * H100_SMS


def _cdiv(a, b):
    return -(-a // b)


def k8a_plan(B: int, n: int, m: int, M5: int, cluster=None, groups=None,
             dtype=torch.float32) -> dict:
    """K8a's grid: per node slot (grid row b) ``groups`` Q column groups of
    the X/W coordinates, each a cluster of C CTAs (``cluster``; CTA r owns
    rows [r n / C, (r + 1) n / C) of its group's columns [k m / Q, (k + 1) m
    / Q), and the cluster adds the link rows' column sums in rank order),
    then one CTA per 32 x 32 tile pair (I, J), I >= J, of Theta's
    off-diagonal (``pairs``), then one CTA per 256 of the slot's 5 M5 v
    entries (``v_ctas``); the row rounded up to whole clusters (``grid``).

    C is the largest power of two up to 8 and n: a slot's coordinates over
    as many SMs as a portable cluster has.  Q doubles while each CTA keeps
    at least a coordinate for every other thread and the coordinates' CTAs
    of all slots stay within ``K8A_TARGET_CTAS`` (the batches of 1 to 4
    split columns; on the H100 the Q this picks was the fastest, or within
    2%, at every shape the Shor loop runs), and beyond that until a CTA's
    tile of zW and W's diagonal, with its columns' partials and t_l, fits
    its shared memory (``smem``, or two tiles of Theta; values of
    ``dtype``, 8 bytes in the float64 build).  ``cluster`` and ``groups``
    force C and Q; a forced Q whose tile does not fit raises."""
    if min(B, n, m, M5) < 1:
        raise ValueError(f"K8a: unsupported shape B={B}, n={n}, m={m}, M5={M5}")
    if cluster is None:
        C = 1
        while 2 * C <= min(K8A_CLUSTER_MAX, n):
            C *= 2
    elif cluster in (1, 2, 4, 8) and cluster <= n:
        C = cluster
    else:
        raise ValueError(f"K8a: cluster {cluster!r} not a power of two up to 8 and n={n}")
    rows = _cdiv(n, C)

    def smem_of(Q):
        cols = _cdiv(m, Q)
        return dtype.itemsize * max(2 * K8A_TILE * (K8A_TILE + 1), 2 * cols + 2 * rows * cols)

    if groups is None:
        Q = 1
        while (2 * Q <= m and B * C * 2 * Q <= K8A_TARGET_CTAS
               and 2 * rows * _cdiv(m, 2 * Q) >= K8A_THREADS):
            Q *= 2
        while 2 * Q <= m and smem_of(Q) > K8A_SMEM_MAX:
            Q *= 2
    elif 1 <= groups <= m:
        Q = int(groups)
    else:
        raise ValueError(f"K8a: groups {groups!r} not in [1, m={m}]")
    if smem_of(Q) > K8A_SMEM_MAX:
        raise ValueError(f"K8a: {rows} x {_cdiv(m, Q)} coordinates a CTA need {smem_of(Q)} "
                         "bytes of shared memory")
    nt = _cdiv(m, K8A_TILE)
    pairs = nt * (nt + 1) // 2
    v_ctas = _cdiv(5 * M5, K8A_THREADS)
    grid_x = _cdiv(Q * C + pairs + v_ctas, C) * C
    smem = smem_of(Q)
    return dict(cluster=C, groups=Q, rows=rows, cols=_cdiv(m, Q), pairs=pairs, v_ctas=v_ctas,
                grid=(grid_x, B), threads=K8A_THREADS, smem=smem)


def shor_zstep_tiled(c, sc: _ShorConsts, st: ShorADMMState, plan: dict):
    """Torch mirror of K8a's order of work (``plan`` from ``k8a_plan``), for
    the tests: each coordinate's and v entry's adjoint summed along its CSR
    list in order, the column sums of zW per CTA band of rows in row order
    and added over the cluster in rank order, then t_l, Theta's diagonal and
    W's correction; Theta's off-diagonal as sym of the base slots' share.
    Returns (Xs, Ths, W, v1, v2, v3) like ``shor_zstep_plain``."""
    core = st.core
    sb = sc.sb
    B, n, m = core.X.shape
    nm = n * m
    dt = core.X.dtype
    sX, sT, sS, rho = core.sX[:, None], core.sT[:, None], core.sS[:, None], core.rho[:, None]
    sW, sS2 = sX * sX, sS * sS
    D1 = n + m
    y1 = (core.w1 - core.u1).reshape(B, D1, D1)
    y5 = (st.w5 - st.u5).reshape(B, -1)

    def csr(ptr, ent, term):
        """sum_e term(ent[e]) over each row's list of the CSR table, in list
        order: (B, rows)."""
        ptr = ptr.long()
        lo, hi = ptr[:, :-1], ptr[:, 1:]
        g = torch.zeros(lo.shape, dtype=dt, device=lo.device)
        for d in range(int((hi - lo).max()) if lo.numel() else 0):
            on = lo + d < hi
            e = torch.gather(ent.long(), 1, torch.where(on, lo + d, 0))
            g = torch.where(on, g + term(e), g)
        return g

    def y(l, i, j):
        return torch.gather(y5, 1, l * 25 + (i * 5 + j))

    c_of = lambda e: (e & 3) + 1  # noqa: E731
    gx = csr(sb.xw_ptr, sb.xw_ent, lambda e: 2.0 * (sS * torch.gather(
        y5, 1, (e >> 2) * 25 + c_of(e))))
    gw = csr(sb.xw_ptr, sb.xw_ent, lambda e: sS * torch.gather(
        y5, 1, (e >> 2) * 25 + c_of(e) * 6))
    yr = (st.wr - st.ur).reshape(B, nm, 3)
    sm = sb.soc_mask
    yl = (st.wl - st.ul)[:, None, :].expand(B, n, m).reshape(B, nm)
    gw = gw + sS * yr[..., 1] * sm
    gx = gx + sS * yr[..., 2] * sm
    gw = gw - sW * yl
    gw = gw + sS * (st.wp - st.up).reshape(B, nm)
    rX = sX * 2.0 * y1[:, :n, n:].reshape(B, nm)
    RX = rho * (rX + gx) + sX * c.maskA.reshape(1, nm)
    dX1 = 2.0 * sX * sX + sS2 * sb.cnt_X.reshape(B, nm)
    zX = RX / (rho * dX1)
    R_Xs = sc.R_X / sX
    Xs = torch.minimum(torch.maximum(zX, -R_Xs), R_Xs)
    RW = rho * gw - 0.5 * sW * c.mask.reshape(1, nm)
    dW1 = sS2 * torch.clamp(sb.cnt_W.reshape(B, nm), min=1.0)
    zW = (RW / (rho * dW1)).reshape(B, n, m)
    # the column sums: each CTA's rows in order, then the cluster's CTAs in
    # rank order
    C = plan["cluster"]
    tot = torch.zeros((B, m), dtype=dt, device=zW.device)
    for r in range(C):
        part = torch.zeros((B, m), dtype=dt, device=zW.device)
        for i in range(r * n // C, (r + 1) * n // C):
            part = part + zW[:, i]
        tot = tot + part
    yl_j = st.wl - st.ul
    dg = torch.diagonal(y1[:, n:, n:], dim1=-2, dim2=-1)
    RT = rho * (sT * dg + sT * yl_j) - sT * 0.5 / c.gamma
    zTh_d = RT / (rho * sT * sT)
    t_l = rho * (sT * zTh_d - sW * tot) / sc.g_link
    W = zW + sW[:, :, None] * t_l[:, None, :] / (rho[:, :, None] * dW1.reshape(B, n, m))
    zT = (rho[:, :, None] * (sT[:, :, None] * y1[:, n:, n:])) / (
        rho[:, :, None] * sT[:, :, None] * sT[:, :, None])
    Ths = 0.5 * (zT + zT.transpose(-1, -2))
    Ths = torch.diagonal_scatter(Ths, zTh_d - t_l / (rho * sT), dim1=-2, dim2=-1)
    vs = []
    for name, (ta, tb) in (("v1", ((1, 2), (3, 4))), ("v2", ((1, 3), (2, 4)))):
        ptr, ent = getattr(sb, f"{name}_ptr"), getattr(sb, f"{name}_ent")
        vs.append(csr(ptr, ent, lambda e, ta=ta, tb=tb: torch.where(
            (e & 1) == 1, 2.0 * (sS * y(e >> 1, *tb)), 2.0 * (sS * y(e >> 1, *ta)))))
    vs.append(csr(sb.v3_ptr, sb.v3_ent,
                  lambda e: 2.0 * (sS * y(e, 1, 4) + sS * y(e, 2, 3))))
    vs = [(rho * g) / (rho * (sS2 * torch.clamp(cv, min=1.0)))
          for g, cv in zip(vs, (sb.cnt_v1, sb.cnt_v2, sb.cnt_v3))]
    return (Xs.reshape(B, n, m), Ths, W) + tuple(vs)


def shor_zstep(c, sc: _ShorConsts, st: ShorADMMState):
    """K8a wrapper: writes Xs, Ths, W, v1, v2, v3 into ``st``.  A CPU state
    runs ``shor_zstep_plain``; a CUDA state launches ``csrc/k8_shor.cu``
    (``k8a_plan``'s grid) or raises.  The parameter block is packed once per operands
    (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    outs = (core.X, core.Th, st.W, st.v1, st.v2, st.v3)
    if dev.type == "cpu":
        for dst, src in zip(outs, shor_zstep_plain(c, sc, st)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"shor_zstep: unsupported device {dev}")
    scalars = (float(c.gamma), float(sc.R_X))
    dt = core.X.dtype

    def build():
        B, n, m = core.X.shape
        plan = k8a_plan(B, n, m, sc.M5, dtype=dt)
        p = kernels.block(kernels.K8aParams, dt)
        for name, t, shape, dtype in _k8a_operands(c, sc, st):
            setattr(p, name, kernels.check(name, t, shape, dev, dtype))
        p.B, p.n, p.m, p.M5 = B, n, m, sc.M5
        p.P1, p.P2, p.P3 = st.v1.shape[1], st.v2.shape[1], st.v3.shape[1]
        p.C, p.Q = plan["cluster"], plan["groups"]
        p.gamma, p.R_X = scalars
        return p

    prm = _packed(("K8a", id(c), id(sc), id(st)), _k8a_tensors(c, sc, st), scalars, build)
    kernels.launch("K8a", kernels.entry("omc_k8a_shor_zstep", dt), prm, dev)


# K7's and K8a's operands, gathered cheaply for the reuse test of their
# packed blocks (``admm._packed``)
_K8A_ST = operator.attrgetter("w5", "u5", "wr", "ur", "wl", "ul", "wp", "up", "W", "v1", "v2",
                              "v3")
_K8A_CORE = operator.attrgetter("w1", "u1", "sX", "sT", "sS", "rho", "X", "Th")
_K8A_SB = operator.attrgetter("soc_mask", "cnt_X", "cnt_W", "cnt_v1", "cnt_v2", "cnt_v3",
                              *INVERSE_FIELDS)
_K7_ST = operator.attrgetter("w5", "u5", "W", "v1", "v2", "v3")
_K7_CORE = operator.attrgetter("X", "sS", "rho")
_K7_SB = operator.attrgetter("minor_idx", "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "minor_mask")


def _k8a_tensors(c, sc: _ShorConsts, st: ShorADMMState) -> tuple:
    return _K8A_ST(st) + _K8A_CORE(st.core) + _K8A_SB(sc.sb) + (sc.g_link, c.maskA, c.mask)


def _k7_tensors(sc: _ShorConsts, st: ShorADMMState, acc5) -> tuple:
    return _K7_ST(st) + _K7_CORE(st.core) + _K7_SB(sc.sb) + (acc5,)


def _k8a_operands(c, sc: _ShorConsts, st: ShorADMMState) -> list:
    """(field, tensor, shape, dtype) of every K8a operand: values in the
    state's dtype, the index tables int32."""
    core, sb = st.core, sc.sb
    B, n, m = core.X.shape
    M5, D1, nm = sc.M5, n + m, n * m
    P = (2 * M5, 2 * M5, M5)
    fv, i32 = core.X.dtype, torch.int32
    ops = [("w1", core.w1, (B, D1, D1), fv), ("u1", core.u1, (B, D1, D1), fv)]
    ops += [(nm_, getattr(st, nm_), (B, M5, 5, 5), fv) for nm_ in ("w5", "u5")]
    ops += [(nm_, getattr(st, nm_), (B, nm, 3), fv) for nm_ in ("wr", "ur")]
    ops += [("soc_mask", sb.soc_mask, (B, nm), fv)]
    ops += [(nm_, getattr(st, nm_), (B, m), fv) for nm_ in ("wl", "ul")]
    ops += [(nm_, getattr(st, nm_), (B, n, m), fv) for nm_ in ("wp", "up")]
    for name, size, ents in (("xw", nm, 4 * M5), ("v1", P[0], 2 * M5), ("v2", P[1], 2 * M5),
                             ("v3", P[2], M5)):
        ops += [(f"{name}_ptr", getattr(sb, f"{name}_ptr"), (B, size + 1), i32),
                (f"{name}_ent", getattr(sb, f"{name}_ent"), (B, ents), i32)]
    ops += [("cnt_X", sb.cnt_X, (B, n, m), fv), ("cnt_W", sb.cnt_W, (B, n, m), fv)]
    ops += [(f"cnt_v{g + 1}", getattr(sb, f"cnt_v{g + 1}"), (B, P[g]), fv) for g in range(3)]
    ops += [("g_link", sc.g_link, (B, m), fv), ("maskA", c.maskA, (n, m), fv),
            ("mask", c.mask, (n, m), fv)]
    ops += [(nm_, getattr(core, nm_), (B,), fv) for nm_ in ("sX", "sT", "sS", "rho")]
    ops += [("Xs", core.X, (B, n, m), fv), ("Ths", core.Th, (B, m, m), fv),
            ("Ws", st.W, (B, n, m), fv)]
    ops += [(f"v{g + 1}", getattr(st, f"v{g + 1}"), (B, P[g]), fv) for g in range(3)]
    return ops


# --------------------------------------------------------------------------
# K7: the minor slots
# --------------------------------------------------------------------------


def minor_step_plain(c, sc: _ShorConsts, st: ShorADMMState, acc5, proj):
    """Plain version of K7's fused mode: the minor slots at the current
    primal, relax-mixed, projected with ``proj``; returns (w5, u5, acc5)."""
    core = st.core
    B = core.X.shape[0]
    sS = core.sS
    f5 = sS[:, None, None, None] * _minor_blocks(
        sc.fl, sc.iv, core.X.reshape(B, -1), st.W.reshape(B, -1), st.v1, st.v2, st.v3)
    t5 = (c.alpha * f5 + (1.0 - c.alpha) * st.w5) + st.u5
    w5 = proj(t5)
    u5 = (t5 - w5) * sc.sb.minor_mask[..., None, None]
    acc = acc5 + c.beta * (core.rho[:, None, None, None] * u5 - acc5)
    return w5, u5, acc


def minor_step(c, sc: _ShorConsts, st: ShorADMMState, acc5, psd_method: str):
    """K7 wrapper (fused mode): updates ``st.w5``, ``st.u5`` and the EMA
    ``acc5`` in place.  A CPU state runs ``minor_step_plain`` (the sign
    schedule, or ``eigh`` with ``psd_method="eigh"``); a CUDA state
    launches ``csrc/k7_minor_psd.cu`` (one thread per minor: the sign
    schedule in float32, ``psd_method="ns"``; K4s's exact Jacobi in the
    float64 build, ``psd_method="eigh"``) or raises.  The parameter block
    is packed once per operands (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        proj = project_psd_ns_small if psd_method == "ns" else project_psd
        for dst, src in zip((st.w5, st.u5, acc5), minor_step_plain(c, sc, st, acc5, proj)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"minor_step: unsupported device {dev}")
    dt = core.X.dtype
    want = "eigh" if dt == torch.float64 else "ns"
    if psd_method != want:
        raise ValueError(f'K7 projects {dt} with psd_method="{want}", not {psd_method!r}')
    scalars = (float(c.alpha), float(c.beta))

    def build():
        B, n, m = core.X.shape
        p = kernels.block(kernels.K7Params, dt)
        for name, t, shape, dtype in _k7_operands(sc, st, acc5):
            setattr(p, name, kernels.check(name, t, shape, dev, dtype))
        if p.minor_idx % 16:
            raise ValueError("minor_idx: K7 reads each minor's 4 indices as one 16-byte word")
        p.N, p.M5, p.nm, p.m = B * sc.M5, sc.M5, n * m, m
        p.P1, p.P2, p.P3 = st.v1.shape[1], st.v2.shape[1], st.v3.shape[1]
        p.alpha, p.beta = scalars
        return p

    prm = _packed(("K7", id(c), id(sc), id(st)), _k7_tensors(sc, st, acc5), scalars, build)
    kernels.launch("K7", kernels.entry("omc_k7_minor_psd", dt), prm, dev)


# K7's CTAs (csrc/k7_minor_psd.cu): 128 minors (threads) a CTA in float32,
# 64 in the float64 build, each CTA staging its minors' w5, u5 and acc (25
# values each) in static shared memory (at most 48 KB)
K7_THREADS = {torch.float32: 128, torch.float64: 64}


def k7_plan(N: int, dtype=torch.float32) -> dict:
    """K7's launch for ``N`` minors (the kernel's ``omc_k7_threads`` and
    ``omc_k7_smem_bytes``): ``threads`` minors a CTA, ``ctas`` CTAs, and
    the three staged blocks' ``smem`` bytes."""
    threads = K7_THREADS[dtype]
    return dict(threads=threads, ctas=_cdiv(N, threads), smem=3 * threads * 25 * dtype.itemsize)


def _k7_operands(sc: _ShorConsts, st: ShorADMMState, acc5) -> list:
    """(field, tensor, shape, dtype) of every K7 operand (fused mode):
    values in the state's dtype, the index tables int32."""
    core, sb = st.core, sc.sb
    B, n, m = core.X.shape
    M5 = sc.M5
    fv, i32 = core.X.dtype, torch.int32
    return ([("w", st.w5, (B, M5, 5, 5), fv), ("u", st.u5, (B, M5, 5, 5), fv),
             ("acc", acc5, (B, M5, 5, 5), fv), ("Xs", core.X, (B, n, m), fv),
             ("Ws", st.W, (B, n, m), fv), ("v1", st.v1, (B, 2 * M5), fv),
             ("v2", st.v2, (B, 2 * M5), fv), ("v3", st.v3, (B, M5), fv),
             ("minor_idx", sb.minor_idx, (B, M5, 4), i32)]
            + [(name, getattr(sb, name), (B, M5), i32)
               for name in ("iv1a", "iv1b", "iv2a", "iv2b", "iv3")]
            + [("minor_mask", sb.minor_mask, (B, M5), fv), ("sS", core.sS, (B,), fv),
               ("rho", core.rho, (B,), fv)])


# --------------------------------------------------------------------------
# K8b: RSOC, Theta-link and W >= 0 slots
# --------------------------------------------------------------------------


def shor_cone_step_plain(c, sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l):
    """Plain version of K8b: returns (wr, ur, wl, ul, wp, up, acc_r,
    acc_l)."""
    core = st.core
    B = core.X.shape[0]
    alpha = c.alpha
    sX_f = core.sX
    sS = core.sS
    sT = core.sT[:, None]
    Xf = core.X.reshape(B, -1)
    Wf = st.W.reshape(B, -1)
    fr = sS[:, None, None] * torch.stack([0.5 * torch.ones_like(Wf), Wf, Xf], dim=-1)
    fw_col = torch.sum((sX_f * sX_f)[:, None, None] * st.W, dim=-2)
    f_link = sT * torch.diagonal(core.Th, dim1=-2, dim2=-1) - fw_col
    tr_ = (alpha * fr + (1.0 - alpha) * st.wr) + st.ur
    ru, rv, rx = project_rsoc(tr_[..., 0], tr_[..., 1], tr_[..., 2:])
    wr = torch.cat([ru[..., None], rv[..., None], rx], dim=-1)
    ur = (tr_ - wr) * sc.sb.soc_mask[..., None]
    # link rows: zero cone, w = 0 and the dual accumulates
    ul = alpha * f_link + st.ul
    wl = torch.zeros_like(ul)
    tp = (alpha * (sS[:, None, None] * st.W) + (1.0 - alpha) * st.wp) + st.up
    wp = torch.clamp(tp, min=0.0)
    up = tp - wp
    rho = core.rho
    acc_r = acc_r + c.beta * (rho[:, None, None] * ur - acc_r)
    acc_l = acc_l + c.beta * (rho[:, None] * ul - acc_l)
    return wr, ur, wl, ul, wp, up, acc_r, acc_l


# K8b's geometry (csrc/k8_shor.cu): CTAs of 128 threads; a link CTA sums a
# tile of 32 columns in 4 row groups; a coordinates' CTA takes up to 128
# groups of coordinates (quads of 4 in float32, pairs in the float64 build:
# a 16-byte word of each operand a thread), fewer until the grid has a CTA
# for every SM; a warp stages its groups' RSOC values (3 words a thread)
K8B_THREADS, K8B_LINK_COLS, K8B_LINK_ROWS = 128, 32, 4
K8B_TARGET_CTAS = H100_SMS


def k8b_plan(B: int, n: int, m: int, dtype=torch.float32) -> dict:
    """K8b's grid, one dimension: ``link_ctas`` = B ceil(m / 32) CTAs on the
    link rows (slot x // ceil(m / 32), columns [32 t, 32 t + 32) for t = x %
    ceil(m / 32); row group g of 4 sums rows g, g + 4, ... in order, then
    the groups in order), then ``coord_ctas`` CTAs of ``qpc`` groups of
    ``per_thread`` = 16 / itemsize consecutive coordinates of the batch's
    flat B n m (``grid``; quads in float32, pairs in float64).  ``qpc``
    halves from 128 to 32 while there are fewer coordinates' CTAs than
    ``K8B_TARGET_CTAS``.  ``smem``: the static staging of a CTA's warps,
    3 arrays x 3 words x 32 lanes of 16 bytes each."""
    if min(B, n, m) < 1 or n * m < 4:
        raise ValueError(f"K8b: unsupported shape B={B}, n={n}, m={m}")
    E = 16 // dtype.itemsize
    groups = _cdiv(B * n * m, E)
    qpc = K8B_THREADS
    while qpc > 32 and _cdiv(groups, qpc) < K8B_TARGET_CTAS:
        qpc //= 2
    links, coords = B * _cdiv(m, K8B_LINK_COLS), _cdiv(groups, qpc)
    return dict(qpc=qpc, per_thread=E, link_ctas=links, coord_ctas=coords,
                grid=links + coords, threads=K8B_THREADS, link_rows=K8B_LINK_ROWS,
                smem=3 * 3 * K8B_THREADS * 16)


def link_sums_tiled(sWW, G: int):
    """The column sums of sWW (B, n, m) over its rows in the order of the
    link CTAs of K8b and K8d: row group g of G sums rows g, g + G, ... in
    order, then the G groups are added in order."""
    tot = torch.zeros_like(sWW[:, 0])
    for g in range(G):
        part = torch.zeros_like(tot)
        for i in range(g, sWW.shape[1], G):
            part = part + sWW[:, i]
        tot = tot + part
    return tot


def shor_cone_step_tiled(c, sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l, plan: dict):
    """Torch mirror of K8b's order of work (``plan`` from ``k8b_plan``), for
    the tests: the link rows' column sums of sW W per row group (rows g, g +
    G, ... in order), the G groups added in order; every coordinate's slots
    as ``shor_cone_step_plain`` (no coordinate depends on another).  Returns
    the plain version's tuple."""
    out = list(shor_cone_step_plain(c, sc, st, acc_r, acc_l))
    core = st.core
    tot = link_sums_tiled((core.sX * core.sX)[:, None, None] * st.W, plan["link_rows"])
    f_link = core.sT[:, None] * torch.diagonal(core.Th, dim1=-2, dim2=-1) - tot
    ul = c.alpha * f_link + st.ul
    out[2], out[3] = torch.zeros_like(ul), ul
    out[7] = acc_l + c.beta * (core.rho[:, None] * ul - acc_l)
    return tuple(out)


def shor_cone_step(c, sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l):
    """K8b wrapper: updates the RSOC, link and W >= 0 slots of ``st`` and
    the EMAs ``acc_r``, ``acc_l`` in place.  A CPU state runs
    ``shor_cone_step_plain``; a CUDA state launches ``csrc/k8_shor.cu``
    (``k8b_plan``'s grid) or raises.  The parameter block is packed once per
    operands (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        outs = (st.wr, st.ur, st.wl, st.ul, st.wp, st.up, acc_r, acc_l)
        for dst, src in zip(outs, shor_cone_step_plain(c, sc, st, acc_r, acc_l)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"shor_cone_step: unsupported device {dev}")
    kernels.launch("K8b", kernels.entry("omc_k8b_shor_cone", st.core.X.dtype),
                   _k8b_params(c, sc, st, acc_r, acc_l, dev), dev)


# the operands K8b reads and writes as 16-byte words
_K8B_WORDS = ("Xs", "Ws", "wr", "ur", "acc_r", "soc_mask", "wp", "up")
# K8b's operands, gathered cheaply for the reuse test of its packed block
_K8B_ST = operator.attrgetter("W", "wr", "ur", "wl", "ul", "wp", "up")
_K8B_CORE = operator.attrgetter("X", "Th", "sX", "sT", "sS", "rho")


def _k8b_tensors(sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l) -> tuple:
    return _K8B_ST(st) + _K8B_CORE(st.core) + (sc.sb.soc_mask, acc_r, acc_l)


def _k8b_operands(sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l) -> list:
    """(field, tensor, shape) of every K8b operand (all of the state's
    dtype)."""
    core = st.core
    B, n, m = core.X.shape
    nm = n * m
    return ([("Xs", core.X, (B, n, m)), ("Ws", st.W, (B, n, m)), ("Ths", core.Th, (B, m, m)),
             ("wr", st.wr, (B, nm, 3)), ("ur", st.ur, (B, nm, 3)), ("acc_r", acc_r, (B, nm, 3)),
             ("soc_mask", sc.sb.soc_mask, (B, nm)), ("wl", st.wl, (B, m)), ("ul", st.ul, (B, m)),
             ("acc_l", acc_l, (B, m)), ("wp", st.wp, (B, n, m)), ("up", st.up, (B, n, m))]
            + [(name, getattr(core, name), (B,)) for name in ("sX", "sT", "sS", "rho")])


def _k8b_params(c, sc: _ShorConsts, st: ShorADMMState, acc_r, acc_l, dev):
    """K8b's parameter block, packed once per operands (``admm._packed``)."""
    scalars = (float(c.alpha), float(c.beta))
    dt = st.core.X.dtype

    def build():
        B, n, m = st.core.X.shape
        p = kernels.block(kernels.K8bParams, dt)
        for name, t, shape in _k8b_operands(sc, st, acc_r, acc_l):
            setattr(p, name, kernels.check(name, t, shape, dev, dt))
        if any(getattr(p, name) % 16 for name in _K8B_WORDS):
            raise ValueError("K8b reads X, W, the RSOC slots, the mask and the W >= 0 slot as "
                             "16-byte words: their storage must start 16-byte aligned")
        p.B, p.n, p.m = B, n, m
        p.qpc = k8b_plan(B, n, m, dt)["qpc"]
        p.alpha, p.beta = scalars
        return p

    return _packed(("K8b", id(c), id(sc), id(st)), _k8b_tensors(sc, st, acc_r, acc_l), scalars,
                   build)


def shor_iteration(c, sc: _ShorConsts, st: ShorADMMState, ts, acc, psd_method: str):
    """One in-place Shor ADMM iteration: K2 (Y, U) -> K8a -> K3 -> K1 ->
    K7 -> K8b (see the module docstring).  ``acc`` holds the eight EMA
    accumulators (rho u1, u2, ua, ub, uc, u5, ur, ul); ``ts`` the t1/t2/t3
    scratch."""
    core = st.core
    zstep(c, core, shor=True)
    shor_zstep(c, sc, st)
    cone_step(c, core, ts, acc[2:5])
    ws = (core.w1, core.w2, core.w3)
    us = (core.u1, core.u2, core.u3)
    accs = (acc[0], acc[1], None)
    if psd_method == "ns":
        project_psd_ns_multi(list(ts), w_out=ws, u_out=us, acc=accs, rho=core.rho,
                             beta=c.beta)
    else:
        psd_epilogue(ts, [project_psd(t) for t in ts], ws, us, accs, core.rho, c.beta)
    minor_step(c, sc, st, acc[5], psd_method)
    shor_cone_step(c, sc, st, acc[6], acc[7])


def make_shor_solver(n: int, m: int, L: int, M5: int, Ms: int, gamma: float, *,
                     iters: int = 400, dtype=torch.float32, alpha: float = 1.6,
                     psd_method: str = "auto", check_every: int = 2000,
                     ema_iters: int = 1500):
    """Batched ADMM solver for the rank-1 relaxation with Shor valid
    inequalities (port of ``omc.sdp.admm_shor.make_shor_solver``).  The
    interface mirrors ``make_admm_solver`` with the extra per-batch
    ``ShorBatch``; ``out`` also carries W and the Shor duals."""
    k = 1
    if psd_method == "auto":
        psd_method = "eigh" if dtype == torch.float64 else "ns"
    if psd_method not in ("ns", "eigh"):
        raise ValueError(f"psd_method {psd_method!r}")

    def solve(A, mask, batch: NodeBatch, sb, ub_bar, state: ShorADMMState,
              n_iters=None, target=None, group=None):
        """Run up to ``n_iters`` (default ``iters``) iterations from a clone
        of ``state``; ``target``/``group`` as in ``make_admm_solver``."""
        dev = state.core.rho.device
        if dev.type == "cuda":
            kernels.require_full_fp32()
            kernels.require_cuda_dtype("shor", dtype)
            want = "ns" if dtype == torch.float32 else "eigh"
            if psd_method != want:
                raise ValueError(f'the CUDA path projects {dtype} with psd_method="{want}"')
        ni = int(iters if n_iters is None else n_iters)
        A = torch.as_tensor(A, device=dev).to(dtype).contiguous()
        mask = torch.as_tensor(mask, device=dev).to(dtype).contiguous()
        batch_t = batch.map(lambda x: torch.as_tensor(x, device=dev).to(dtype).contiguous())
        sb_t = shor_batch_to_device(sb, dtype, device=dev)
        B = batch_t.cut_mask.shape[0]
        st = state.clone()
        core = st.core
        beta = 1.0 / max(ema_iters, 1)
        c = make_consts(A, mask, batch_t, core, n, m, k, gamma, alpha, beta, dtype)
        sc = make_shor_consts(c, sb_t, core, ub_bar)
        ts = (torch.empty_like(core.w1), torch.empty_like(core.w2),
              torch.empty_like(core.w3))
        if group is None:
            group = torch.arange(B, device=dev)
        group = torch.as_tensor(group, device=dev).to(torch.int64)
        group = group - group.min()
        if target is not None:
            target = torch.as_tensor(target, device=dev).to(dtype)

        def zero_acc():
            return [torch.zeros_like(x) for x in
                    (core.u1, core.u2, core.ua, core.ub, core.uc, st.u5, st.ur, st.ul)]

        ema = zero_acc()
        b_ybar = zero_acc()
        b_lb = torch.full((B,), -math.inf, dtype=dtype, device=dev)
        b_est = b_lb.clone()
        beta_t = torch.tensor(beta, dtype=dtype, device=dev)
        it = 0
        done = False
        while it < ni and not done:
            chunk = min(check_every, ni - it)
            for _ in range(chunk):
                shor_iteration(c, sc, st, ts, ema, psd_method)
            corr = 1.0 - (1.0 - beta_t) ** torch.tensor(float(it + chunk), dtype=dtype, device=dev)
            inv = 1.0 / torch.maximum(corr, beta_t)
            ybar = [inv * a for a in ema]
            lb, lb_est = safe_dual_bound_shor2(
                A, mask, batch_t, sb_t, *ybar, gamma, ub_bar,
                sX=state.core.sX, sS=state.core.sS,
            )
            take = lb_est > b_est
            for j in range(len(ybar)):
                shp = (B,) + (1,) * (ybar[j].ndim - 1)
                b_ybar[j] = torch.where(take.reshape(shp), ybar[j], b_ybar[j])
            b_lb = torch.where(take, lb, b_lb)
            b_est = torch.where(take, lb_est, b_est)
            it += chunk
            if target is not None:
                cleared = (b_est >= target).to(torch.int32)
                gmax = torch.zeros((B,), dtype=torch.int32, device=dev).scatter_reduce(
                    0, group, cleared, reduce="amax"
                )
                done = bool(torch.all((gmax[group] | cleared) > 0))

        sep_w, sep_V = separation_eigpairs(core.U, core.Y)
        sX = core.sX[:, None, None]
        out = {
            "X": sX * core.X, "Y": core.Y, "Th": core.sT[:, None, None] * core.Th,
            "U": core.U, "W": sX * sX * st.W,
            "sX": core.sX, "sS": core.sS,  # minor-slot scales (certification)
            "y1": b_ybar[0], "y2": b_ybar[1], "ya": b_ybar[2], "yb": b_ybar[3],
            "yc": b_ybar[4], "y5": b_ybar[5], "yr": b_ybar[6], "yl": b_ybar[7],
            "lb_dev": b_lb, "lb_est": b_est,
            "iters_run": torch.full((B,), it, dtype=torch.int32, device=dev),
            "sep_w": sep_w, "sep_V": sep_V,
        }
        return st, out

    return solve


# ---------------------------------------------------------------------------
# Safe dual bounds of the Shor-strengthened relaxation
# ---------------------------------------------------------------------------


def _col(s, ref):
    """A per-slot scale as (B, 1), or a 0-d tensor for a scalar."""
    s = torch.as_tensor(s, dtype=ref.dtype, device=ref.device)
    return s.reshape(-1, 1) if s.ndim else s


def safe_dual_bound_shor(A, mask, batch: NodeBatch, sb: ShorBatch, y1, y2, ya, yb,
                         yc, y5, yr, yl, gamma, ub_bar, margin_rel=None, sX=1.0,
                         sS=1.0):
    """Closed-form safe Lagrangian dual bound of the rank-1 Shor relaxation,
    valid for any dual iterate (multipliers are cone-projected here; the
    kept sets are |X| <= R_X, X^2 <= W <= 2 gamma ub, |V| <= 2 gamma ub, Y
    in the spectrahedron, U in the box, Theta PSD with trace <= 2 gamma
    ub).  Torch, on any device and dtype: float32 on the GPU for the
    early-exit screen, float64 on the CPU for the host certificate.
    ``sX``/``sS``: the minor slots are sS D M D with D = diag(1, 1/sX, ..),
    so the raw-constraint multipliers divide the X/W/V coefficients by sX /
    sX^2 (see ``omc.sdp.admm_shor.safe_dual_bound_shor``)."""
    n, m = A.shape[-2], A.shape[-1]
    B = y1.shape[0]
    k = 1
    T_th = 2.0 * gamma * ub_bar
    R_X = math.sqrt(T_th)
    Wmax = T_th
    Vmax = T_th

    S1 = project_psd(-y1)
    S2 = project_psd(-y2)
    P1, q, R1 = S1[:, :n, :n], S1[:, :n, n:], S1[:, n:, n:]
    P2, D, E = S2[:, :n, :n], S2[:, :n, n:], S2[:, n:, n:]

    cmask = batch.cut_mask
    alpha = torch.clamp(-ya, min=0.0) * cmask[..., None]
    beta = torch.clamp(-yb, min=0.0) * cmask[..., None]
    lam = torch.clamp(-yc, min=0.0) * cmask
    cut_x = batch.cut_x
    lo, hi = batch.cut_lo, batch.cut_hi
    c = lo + hi
    bconst = torch.sum(-lo * hi, dim=-1)

    S5 = project_psd(-y5) * sb.minor_mask[..., None, None]
    socm = sb.soc_mask
    dr = -yr
    a_r, b_r, c_r = project_rsoc(dr[..., 0], dr[..., 1], dr[..., 2:])
    c_r = c_r[..., 0]
    a_r, b_r, c_r = a_r * socm, b_r * socm, c_r * socm
    mu = -yl  # (B, m), free
    sX = _col(sX, A)
    sS = _col(sS, A)
    # the solver slot is sS * D M D: raw multiplier = sS * D S5 D
    inv_x = sS / sX
    inv_w = sS / (sX * sX)

    # ---- Y / U / cut terms (as in the base bound) ----
    G_Y = -(P1 + P2) + torch.einsum("bl,bln,blp->bnp", lam, cut_x, cut_x)
    G_Y = 0.5 * (G_Y + G_Y.transpose(-1, -2))
    y_term = torch.sum(torch.clamp(eigvalsh(G_Y)[..., :k], max=0.0), dim=-1)
    W_U = -2.0 * D - torch.einsum("bln,blk->bnk", cut_x, alpha - beta + lam[..., None] * c)
    u_term = torch.sum(torch.minimum(W_U * batch.U_lo, W_U * batch.U_hi), dim=(-2, -1))
    cut_const = (
        torch.sum(alpha * lo, dim=(-2, -1))
        - torch.sum(beta * hi, dim=(-2, -1))
        - torch.sum(lam * bconst, dim=-1)
    )

    # ---- Theta ----
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    G_Th = (0.5 / gamma) * eye_m[None] - R1 - mu[:, None, :] * eye_m[None]
    G_Th = 0.5 * (G_Th + G_Th.transpose(-1, -2))
    th_term = T_th * torch.clamp(eigvalsh(G_Th)[..., 0], max=0.0)

    # ---- X / W / V coefficients (scatter the minor duals) ----
    fl = _flat_idx(sb.minor_idx, m)
    iv1a, iv1b, iv2a, iv2b, iv3 = _v_idx(sb)
    coef_X = (-mask * A)[None].expand(B, n, m).reshape(B, -1) - 2.0 * q.reshape(B, -1)
    coef_W = ((0.5 * mask)[None] + mu[:, None, :]).reshape(B, -1)
    for fi, col in zip(fl, (1, 2, 3, 4)):
        coef_X = coef_X.scatter_add(1, fi, -2.0 * inv_x * S5[..., 0, col])
        coef_W = coef_W.scatter_add(1, fi, -inv_w * S5[..., col, col])
    sflat = (sb.soc_idx[..., 0] * m + sb.soc_idx[..., 1]).long()
    coef_X = coef_X.scatter_add(1, sflat, -inv_x * c_r)
    coef_W = coef_W.scatter_add(1, sflat, -inv_w * b_r)
    zz = lambda P: torch.zeros((B, P), dtype=A.dtype, device=A.device)
    coef_v1 = zz(sb.cnt_v1.shape[1]).scatter_add(1, iv1a, -2.0 * inv_w * S5[..., 1, 2])
    coef_v1 = coef_v1.scatter_add(1, iv1b, -2.0 * inv_w * S5[..., 3, 4])
    coef_v2 = zz(sb.cnt_v2.shape[1]).scatter_add(1, iv2a, -2.0 * inv_w * S5[..., 1, 3])
    coef_v2 = coef_v2.scatter_add(1, iv2b, -2.0 * inv_w * S5[..., 2, 4])
    coef_v3 = zz(sb.cnt_v3.shape[1]).scatter_add(
        1, iv3, -2.0 * inv_w * (S5[..., 1, 4] + S5[..., 2, 3]))

    # joint per-coordinate infimum of coef_W W + coef_X X over the kept set
    # {|X| <= R_X, X^2 <= W <= Wmax} (W >= X^2 holds at every coordinate:
    # RSOC rows off the minors, the [1 X; X W] minor on them)
    aW, bX = coef_W, coef_X
    denom = torch.clamp(aW, min=1e-30)
    Xstar = torch.clamp(-bX / (2.0 * denom), -R_X, R_X)
    val_pos = aW * Xstar * Xstar + bX * Xstar
    val_neg = aW * Wmax - torch.abs(bX) * R_X
    xw_term = torch.sum(torch.where(aW > 0, val_pos, val_neg), dim=-1)
    v_term = -Vmax * (
        torch.sum(torch.abs(coef_v1), dim=-1)
        + torch.sum(torch.abs(coef_v2), dim=-1)
        + torch.sum(torch.abs(coef_v3), dim=-1)
    )

    sS1 = sS[..., 0] if sS.ndim else sS
    const = (
        0.5 * torch.sum(mask * A * A)
        - sS1 * torch.sum(S5[..., 0, 0], dim=-1)
        - 0.5 * sS1 * torch.sum(a_r, dim=-1)
        - torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
        + cut_const
    )

    lb = y_term + u_term + th_term + xw_term + v_term + const
    if margin_rel is None:
        margin_rel = margin_rel_default(A.dtype)
    scale = (
        1.0 + torch.abs(lb) + ub_bar
        + torch.sqrt(torch.sum(S1 * S1, dim=(-2, -1)))
        + torch.sqrt(torch.sum(S2 * S2, dim=(-2, -1)))
        + torch.sqrt(torch.sum(S5 * S5, dim=(-3, -2, -1)))
    )
    return lb - margin_rel * scale


def safe_dual_bound_shor2(A, mask, batch, sb, y1, y2, ya, yb, yc, y5, yr, yl,
                          gamma, ub_bar, sX=1.0, sS=1.0):
    """``(lb_valid, lb_est)``: the margined bound with a conservative scale
    from the raw duals (||proj_PSD(-y)||_F <= ||y||_F), and the unmargined
    value as the float64-tracking early-exit estimator (not a sound
    bound; the driver re-certifies in float64 before acting)."""
    lb = safe_dual_bound_shor(A, mask, batch, sb, y1, y2, ya, yb, yc, y5, yr,
                              yl, gamma, ub_bar, margin_rel=0.0, sX=sX, sS=sS)
    scale = (
        1.0 + torch.abs(lb) + ub_bar
        + torch.sqrt(torch.sum(y1 * y1, dim=(-2, -1)))
        + torch.sqrt(torch.sum(y2 * y2, dim=(-2, -1)))
        + torch.sqrt(torch.sum(y5 * y5, dim=(-3, -2, -1)))
    )
    return lb - margin_rel_default(A.dtype) * scale, lb


def host_certified_bound_shor(A, mask, batch: NodeBatch, sbh: ShorBatchHost,
                              out: dict, gamma, ub_bar, margin_rel=1e-10):
    """Float64 safe dual bound of the rank-1 Shor relaxation on the host
    (CPU, LAPACK eigh) from solver outputs (tensors on any device or numpy
    arrays).  Returns a numpy (B,) array."""
    f = lambda a: torch.as_tensor(_np(a), dtype=torch.float64)
    hb = batch.map(f)
    sb = shor_batch_to_device(sbh, torch.float64, device="cpu")
    lb = safe_dual_bound_shor(
        f(A), f(mask), hb, sb, f(out["y1"]), f(out["y2"]), f(out["ya"]),
        f(out["yb"]), f(out["yc"]), f(out["y5"]), f(out["yr"]), f(out["yl"]),
        float(gamma), float(ub_bar), margin_rel=margin_rel,
        sX=f(out.get("sX", 1.0)), sS=f(out.get("sS", 1.0)),
    )
    return lb.numpy()


def apply_best_duals(state: ShorADMMState, out: dict) -> ShorADMMState:
    """The visit's best-chunk duals as scaled duals (u = y / rho).  The Shor
    family applies them to the continuation state as well as to children
    (see ``omc.solve``: growth-heavy re-visits behave like child solves)."""
    rho = state.core.rho
    return state.replace(core=apply_core_best_duals(state.core, out),
                         u5=out["y5"] / rho[:, None, None, None],
                         ur=out["yr"] / rho[:, None, None], ul=out["yl"] / rho[:, None])


__all__ = [
    "ShorBatch", "shor_batch_to_device", "ShorADMMState", "init_shor_state",
    "make_shor_solver", "shor_zstep", "shor_zstep_plain", "shor_zstep_tiled", "k8a_plan",
    "k8b_plan", "k7_plan", "shor_cone_step_tiled",
    "minor_step",
    "minor_step_plain", "shor_cone_step", "shor_cone_step_plain",
    "safe_dual_bound_shor", "safe_dual_bound_shor2", "host_certified_bound_shor",
    "apply_best_duals",
]
