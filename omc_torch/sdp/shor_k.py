"""Batched ADMM node relaxation with Shor valid inequalities, rank k > 1
(port of ``omc/sdp/shor_k.py``; see that module's docstring for the model
and the reference lines).

X splits into per-term variables ``Xt`` (k, n, m) with X = sum_t Xt.  Beside
the base slots of ``omc_torch.sdp.admm`` the relaxation carries:

- per active minor (i1, i2, j1, j2) and term t a 5x5 PSD slot on
  ``[1, Xt corners]`` against ``Wt``/``v1``/``v2``/``v3`` entries of term t,
- per minor coordinate (i, j) a (k+1)x(k+1) ``XWH`` PSD slot
  ``[[1, Xt'], [Xt, M]]`` with ``M_tt = Wt[t]`` and ``M_t1t2 = H[(t1, t2)]``,
- the W-link rows ``W_c = sum_t Wt + 2 sum_p H`` on the coordinates, the
  rotated SOC rows ``W >= X^2`` on the complement, the Theta-link rows
  ``Theta_jj = sum_i W_ij``, and the slots ``W >= 0`` and ``Wt >= 0``.

The Shor state is indexed by coordinate (capacity C = 4 M5) as in ``omc``,
the 5x5 and XWH slots are built from the scaled variables (Xt/sX, Wt/sX^2,
H/sX^2) and weighted by sS, and the z-step stays closed form: a
Sherman-Morrison solve per matrix entry for the k terms of X, diagonal
solves for the rest, and a link Woodbury whose Gram is diagonal after a
diagonal Schur complement.

One iteration on the GPU is seven kernel launches, each a wrapper with its
plain PyTorch version beside it (CPU tensors take the plain versions, in
``omc``'s order of operations, so float64 iterates match ``omc``):

1. K2  ``admm.zstep(shor=True)`` -- the base z-step of Y and U;
2. K8c ``shor_k_zstep``    -- the Shor-k adjoint, the X solve, the diagonal
   solves, the link Woodbury, the clip; writes Xt, X = sum_t Xt, Theta, W,
   Wt, H, v1-v3;
3. K3  ``admm.cone_step``  -- the base slots at X = sum_t Xt;
4. K1  ``project_psd_ns_multi`` -- the three PSD blocks;
5. K7t ``minor_k_step``    -- the per-term 5x5 minor slots;
6. K7x ``xwh_step``        -- the (k+1)x(k+1) XWH slots;
7. K8d ``shor_k_cone_step`` -- RSOC, Theta-link, W-link, W >= 0, Wt >= 0.

In float64 (``omc``'s float64 route, ``psd_method="eigh"``) the kernels
are their float64 builds and the projections exact: step 4 is three K4
Jacobi launches and the torch ``psd_epilogue``, steps 5 and 6 K7t's and
K7x's float64 builds, which project each 5x5 minor slot and each XWH slot
by K4s's Jacobi in registers.

Every rank k >= 2 runs on the card.  K7t loops over the terms at run time
and takes any k.  K7x, K8c and K8d have register kernels for k = 2..4 and
"wide" kernels for any k (the plans' ``path="wide"``, counted as "K7xw",
"K8cw", "K8dw"): K7x's gives an XWH slot to a warp, its matrices in shared
memory (or a global workspace); K8c's walks the terms at run time, its kept
values in shared memory or a global workspace (also where the register
kernel's do not fit, at any k); K8d's coordinate CTAs take the rank at run
time.

The kernels sum through inverse tables built on the host once per visit
(``inverse_tables_k``), so every sum is deterministic (no atomics).  Every
``check_every`` iterations the bias-corrected EMA duals of the ten dual
blocks go through the torch ``safe_dual_bound_shor_k2``; the host
certificate ``host_certified_bound_shor_k`` evaluates the same closed form
in float64 on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from omc_torch import kernels
from omc_torch.ops.cones import eigvalsh, project_psd, project_rsoc
from omc_torch.ops.polar import H100_SMS, project_psd_ns_multi, project_psd_ns_small, psd_epilogue
from omc_torch.sdp.admm import (
    ADMMState,
    _cdiv,
    _packed,
    cone_step,
    init_admm_state,
    make_consts,
    zstep,
)
from omc_torch.sdp.admm import apply_best_duals as apply_core_best_duals
from omc_torch.sdp.admm_shor import link_sums_tiled
from omc_torch.sdp.relax import NodeBatch, _np, margin_rel_default, separation_eigpairs
from omc_torch.sdp.shor_encode import _csr, fill_v_inverse, v_inverse_tables

# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

# omc's ShorKBatchHost fields, in its order
OMC_FIELDS = (
    "minor_idx", "minor_mask", "mc", "coord_flat", "coord_j", "coord_mask",
    "coord_minor_cnt", "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "soc_flat",
    "soc_mask", "cnt_minor", "is_coord", "is_soc", "cnt_v1", "cnt_v2", "cnt_v3",
)
INVERSE_FIELDS = (
    "fm_ptr", "fm_ent", "flat_coord", "flat_soc",
    "v1_ptr", "v1_ent", "v2_ptr", "v2_ent", "v3_ptr", "v3_ent",
)
_INT_FIELDS = {"minor_idx", "mc", "coord_flat", "coord_j", "iv1a", "iv1b", "iv2a",
               "iv2b", "iv3", "soc_flat", *INVERSE_FIELDS}


@dataclasses.dataclass
class ShorKBatchHost:
    """Numpy rank-k Shor batch: ``omc``'s fields (see
    ``omc.sdp.shor_k.ShorKBatchHost``), then the inverse tables:

    fm_ptr/fm_ent:   (B, n*m+1), (B, 4*M5) int32  flat entry f -> entries
                     4*l + corner of the active minors with a corner at f,
                     ascending l (so K8c reads a minor's 5x5 record one
                     load after the entry's pointer)
    flat_coord:      (B, n*m) int32             flat entry -> c, or -1
    flat_soc:        (B, n*m) int32             flat entry -> RSOC slot, or -1
    v*_ptr/v*_ent:   the v1/v2/v3 lists of ``shor_encode.inverse_tables``
    """

    minor_idx: np.ndarray
    minor_mask: np.ndarray
    mc: np.ndarray
    coord_flat: np.ndarray
    coord_j: np.ndarray
    coord_mask: np.ndarray
    coord_minor_cnt: np.ndarray
    iv1a: np.ndarray
    iv1b: np.ndarray
    iv2a: np.ndarray
    iv2b: np.ndarray
    iv3: np.ndarray
    soc_flat: np.ndarray
    soc_mask: np.ndarray
    cnt_minor: np.ndarray
    is_coord: np.ndarray
    is_soc: np.ndarray
    cnt_v1: np.ndarray
    cnt_v2: np.ndarray
    cnt_v3: np.ndarray
    fm_ptr: np.ndarray
    fm_ent: np.ndarray
    flat_coord: np.ndarray
    flat_soc: np.ndarray
    v1_ptr: np.ndarray
    v1_ent: np.ndarray
    v2_ptr: np.ndarray
    v2_ent: np.ndarray
    v3_ptr: np.ndarray
    v3_ent: np.ndarray

    def omc_leaves(self) -> list:
        """The fields ``omc``'s ShorKBatchHost has, in its order."""
        return [getattr(self, f) for f in OMC_FIELDS]


# the device form: a ShorKBatchHost whose fields are tensors (index tables
# int32, values in the compute dtype)
ShorKBatch = ShorKBatchHost


def inverse_tables_k(n, m, mc, minor_mask, coord_flat, coord_mask,
                     iv1a, iv1b, iv2a, iv2b, iv3, soc_flat, soc_mask,
                     P1, P2, P3) -> dict:
    """The kernels' inverse tables from the forward tables (active minors,
    coordinates and RSOC slots only: padded ones are masked to zero)."""
    B, M5 = minor_mask.shape
    out = {
        "fm_ptr": np.zeros((B, n * m + 1), np.int32),
        "fm_ent": np.zeros((B, 4 * M5), np.int32),
        "flat_coord": np.full((B, n * m), -1, np.int32),
        "flat_soc": np.full((B, n * m), -1, np.int32),
        **v_inverse_tables(B, M5, P1, P2, P3),
    }
    for b in range(B):
        act = np.flatnonzero(np.asarray(minor_mask[b]) > 0)
        # the flat entry of each active minor's corners
        keys = np.asarray(coord_flat[b], np.int64)[np.asarray(mc[b], np.int64)[act]]
        ents = 4 * act[:, None] + np.arange(4)[None]
        ptr, ent = _csr(keys.reshape(-1), ents.reshape(-1), n * m)
        out["fm_ptr"][b], out["fm_ent"][b, : ent.size] = ptr, ent
        actc = np.flatnonzero(np.asarray(coord_mask[b]) > 0)
        acts = np.flatnonzero(np.asarray(soc_mask[b]) > 0)
        for name, idx, sel in (("flat_coord", coord_flat, actc), ("flat_soc", soc_flat, acts)):
            flat = np.asarray(idx[b], np.int64)[sel]
            if np.unique(flat).size != flat.size:
                raise ValueError(f"{name}: an entry appears twice in slot {b}")
            out[name][b, flat] = sel
        fill_v_inverse(out, b, act, iv1a, iv1b, iv2a, iv2b, iv3, P1, P2, P3)
    return out


def _with_inverse(n, m, kw) -> ShorKBatchHost:
    inv = inverse_tables_k(
        n, m, kw["mc"], kw["minor_mask"], kw["coord_flat"], kw["coord_mask"], kw["iv1a"],
        kw["iv1b"], kw["iv2a"], kw["iv2b"], kw["iv3"], kw["soc_flat"], kw["soc_mask"],
        kw["cnt_v1"].shape[1], kw["cnt_v2"].shape[1], kw["cnt_v3"].shape[1],
    )
    return ShorKBatchHost(**kw, **inv)


def pack_shor_k_batch(
    n: int,
    m: int,
    minors_per_node: List[Sequence[Tuple[int, int, int, int]]],
    soc_per_node: List[Sequence[Tuple[int, int]]],
    M5: int,
    Msoc: int,
) -> ShorKBatchHost:
    """Pack per-node minor and RSOC lists; ``omc``'s fields come out equal
    to ``omc.sdp.shor_k.pack_shor_k_batch``'s.  Coordinates are numbered in
    order of first appearance, so appending minors keeps every earlier
    coordinate's index (prefix-stable warm starts)."""
    B = len(minors_per_node)
    C = 4 * M5
    P1 = P2 = 2 * M5
    P3 = M5
    kw = dict(
        minor_idx=np.zeros((B, M5, 4), dtype=np.int32), minor_mask=np.zeros((B, M5)),
        mc=np.zeros((B, M5, 4), dtype=np.int32),
        coord_flat=np.zeros((B, C), dtype=np.int32), coord_j=np.zeros((B, C), dtype=np.int32),
        coord_mask=np.zeros((B, C)), coord_minor_cnt=np.zeros((B, C)),
        **{name: np.zeros((B, M5), dtype=np.int32)
           for name in ("iv1a", "iv1b", "iv2a", "iv2b", "iv3")},
        soc_flat=np.zeros((B, Msoc), dtype=np.int32), soc_mask=np.zeros((B, Msoc)),
        cnt_minor=np.zeros((B, n, m)), is_coord=np.zeros((B, n, m)), is_soc=np.zeros((B, n, m)),
        cnt_v1=np.zeros((B, P1)), cnt_v2=np.zeros((B, P2)), cnt_v3=np.zeros((B, P3)),
    )
    for b in range(B):
        minors = list(minors_per_node[b])
        if len(minors) > M5:
            raise ValueError(f"node has {len(minors)} Shor minors > capacity {M5}")
        cmap: Dict[Tuple[int, int], int] = {}
        v1_map: Dict[Tuple[int, int, int], int] = {}
        v2_map: Dict[Tuple[int, int, int], int] = {}
        v3_map: Dict[Tuple[int, int, int, int], int] = {}

        def get(mapping, key, cap, name):
            if key not in mapping:
                if len(mapping) >= cap:
                    raise ValueError(f"{name} capacity exceeded")
                mapping[key] = len(mapping)
            return mapping[key]

        for l, (i1, i2, j1, j2) in enumerate(minors):
            kw["minor_idx"][b, l] = (i1, i2, j1, j2)
            kw["minor_mask"][b, l] = 1.0
            for corner, (i, j) in enumerate(((i1, j1), (i1, j2), (i2, j1), (i2, j2))):
                ci = get(cmap, (i, j), C, "coord")
                kw["mc"][b, l, corner] = ci
                kw["coord_flat"][b, ci] = i * m + j
                kw["coord_j"][b, ci] = j
                kw["coord_mask"][b, ci] = 1.0
                kw["coord_minor_cnt"][b, ci] += 1.0
                kw["cnt_minor"][b, i, j] += 1.0
                kw["is_coord"][b, i, j] = 1.0
            iv = (get(v1_map, (i1, j1, j2), P1, "v1"), get(v1_map, (i2, j1, j2), P1, "v1"),
                  get(v2_map, (i1, i2, j1), P2, "v2"), get(v2_map, (i1, i2, j2), P2, "v2"),
                  get(v3_map, (i1, i2, j1, j2), P3, "v3"))
            for name, val in zip(("iv1a", "iv1b", "iv2a", "iv2b", "iv3"), iv):
                kw[name][b, l] = val
            kw["cnt_v1"][b, iv[0]] += 2.0
            kw["cnt_v1"][b, iv[1]] += 2.0
            kw["cnt_v2"][b, iv[2]] += 2.0
            kw["cnt_v2"][b, iv[3]] += 2.0
            kw["cnt_v3"][b, iv[4]] += 4.0

        socs = list(soc_per_node[b])
        if len(socs) > Msoc:
            raise ValueError(f"node has {len(socs)} RSOC rows > capacity {Msoc}")
        for s, (i, j) in enumerate(socs):
            kw["soc_flat"][b, s] = i * m + j
            kw["soc_mask"][b, s] = 1.0
            kw["is_soc"][b, i, j] = 1.0
    return _with_inverse(n, m, kw)


def shor_k_batch_host_from_omc_leaves(leaves) -> ShorKBatchHost:
    """``omc``'s 20 ShorKBatchHost leaves (field order) plus the inverse
    tables built from them."""
    leaves = [np.asarray(x) for x in leaves]
    if len(leaves) != len(OMC_FIELDS):
        raise ValueError(f"expected {len(OMC_FIELDS)} leaves, got {len(leaves)}")
    kw = dict(zip(OMC_FIELDS, leaves))
    n, m = kw["cnt_minor"].shape[1:]
    return _with_inverse(n, m, kw)


def shor_k_batch_to_device(h: ShorKBatchHost, dtype, *, device) -> ShorKBatch:
    def conv(name, x):
        t = torch.as_tensor(x, device=device)
        return t.to(torch.int32 if name in _INT_FIELDS else dtype).contiguous()

    return ShorKBatch(**{f.name: conv(f.name, getattr(h, f.name))
                         for f in dataclasses.fields(h)})


# ---------------------------------------------------------------------------
# Solver state
# ---------------------------------------------------------------------------

_SHOR_K_FIELDS = ("Xt", "W", "Wt", "Hh", "v1", "v2", "v3", "w5", "u5", "wx", "ux",
                  "wr", "ur", "wl", "ul", "wwl", "uwl", "wp", "up", "wq", "uq")


@dataclasses.dataclass
class ShorKState:
    """The base state (``core.X`` holds sum_t Xt) plus the Shor-k slots;
    field order matches ``omc.sdp.shor_k.ShorKState`` (warm slices)."""

    core: ADMMState
    Xt: torch.Tensor  # (B, k, n, m) scaled by sX
    W: torch.Tensor  # (B, n, m) scaled by sW = sX^2
    Wt: torch.Tensor  # (B, k, C) scaled
    Hh: torch.Tensor  # (B, kp, C) scaled
    v1: torch.Tensor  # (B, k, P1)
    v2: torch.Tensor  # (B, k, P2)
    v3: torch.Tensor  # (B, k, P3)
    w5: torch.Tensor  # (B, M5, k, 5, 5)
    u5: torch.Tensor
    wx: torch.Tensor  # (B, C, k+1, k+1)
    ux: torch.Tensor
    wr: torch.Tensor  # (B, Ms, 3)
    ur: torch.Tensor
    wl: torch.Tensor  # (B, m) Theta-link rows (zero cone)
    ul: torch.Tensor
    wwl: torch.Tensor  # (B, C) W-link rows (zero cone)
    uwl: torch.Tensor
    wp: torch.Tensor  # (B, n, m) W >= 0
    up: torch.Tensor
    wq: torch.Tensor  # (B, k, C) Wt >= 0
    uq: torch.Tensor

    def leaves(self) -> list:
        return self.core.leaves() + [getattr(self, f) for f in _SHOR_K_FIELDS]

    @classmethod
    def from_leaves(cls, leaves) -> "ShorKState":
        leaves = list(leaves)
        nc = len(dataclasses.fields(ADMMState))
        return cls(ADMMState.from_leaves(leaves[:nc]), *leaves[nc:])

    def clone(self) -> "ShorKState":
        return ShorKState.from_leaves([
            x.clone(memory_format=torch.contiguous_format) for x in self.leaves()
        ])

    def replace(self, **kw) -> "ShorKState":
        return dataclasses.replace(self, **kw)


def init_shor_k_state(B, n, m, k, L, M5, Ms, dtype=torch.float32, *, device,
                      sX=1.0, sT=1.0, sS=1.0, rho=0.02, X0=None, Y0=None,
                      Th0=None, U0=None) -> ShorKState:
    C = 4 * M5
    P1 = P2 = 2 * M5
    P3 = M5
    kp = (k * (k - 1)) // 2

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    core = init_admm_state(B, n, m, k, L, dtype, device=device, sX=sX, sT=sT, sS=sS,
                           rho=rho, X0=X0, Y0=Y0, Th0=Th0, U0=U0)
    Xt0 = z(B, k, n, m)
    if X0 is not None:
        # split the warm primal evenly across terms (any split with the
        # right sum is feasible for the core cones)
        s = torch.as_tensor(sX, dtype=dtype, device=device)
        if s.ndim:  # (B,) per-slot scales -> (B, 1, 1, 1)
            s = s.reshape(tuple(s.shape) + (1,) * (4 - s.ndim))
        X0t = torch.as_tensor(X0, dtype=dtype, device=device)
        Xt0 = torch.broadcast_to(X0t[:, None] / (s * k), (B, k, n, m)).clone()
    return ShorKState(
        core=core, Xt=Xt0, W=z(B, n, m), Wt=z(B, k, C), Hh=z(B, kp, C),
        v1=z(B, k, P1), v2=z(B, k, P2), v3=z(B, k, P3),
        w5=z(B, M5, k, 5, 5), u5=z(B, M5, k, 5, 5),
        wx=z(B, C, k + 1, k + 1), ux=z(B, C, k + 1, k + 1),
        wr=z(B, Ms, 3), ur=z(B, Ms, 3), wl=z(B, m), ul=z(B, m),
        wwl=z(B, C), uwl=z(B, C), wp=z(B, n, m), up=z(B, n, m),
        wq=z(B, k, C), uq=z(B, k, C),
    )


# ---------------------------------------------------------------------------
# Forward / adjoint of the Shor-k slots
# ---------------------------------------------------------------------------


def _vec(x, ref):
    """A per-slot scale as a (B,) (or (1,)) tensor like ``ref``."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device).reshape(-1)


def _gather_bk(flat_bk, idx_b):
    """flat_bk (B, k, N), idx_b (B, M) int64 -> (B, k, M)."""
    B, k, _ = flat_bk.shape
    return torch.gather(flat_bk, 2, idx_b[:, None, :].expand(B, k, idx_b.shape[1]))


def _scatter_add_bk(target, idx_b, val_bkM):
    """Accumulate val (B, k, M) into target (B, k, N) at idx (B, M) int64."""
    B, k, _ = target.shape
    M = idx_b.shape[1]
    return target.scatter_add(2, idx_b[:, None, :].expand(B, k, M), val_bkM.expand(B, k, M))


def _pair_indices(k: int):
    t1s, t2s = [], []
    for a in range(k):
        for b in range(a + 1, k):
            t1s.append(a)
            t2s.append(b)
    return t1s, t2s


def _corner_flat(sb: ShorKBatch):
    """(B, M5, 4) int64 flat entry of each minor corner."""
    B, M5 = sb.minor_mask.shape
    return torch.gather(sb.coord_flat.long(), 1, sb.mc.long().reshape(B, -1)).reshape(B, M5, 4)


def minor_records(sb: ShorKBatch, cf) -> torch.Tensor:
    """K7t's index records, (B, M5, 16) int32, one per (slot, minor), packed
    once per visit: the flat entries ``cf`` = coord_flat[mc] of its four
    corners, their coordinates ``mc``, then iv1a, iv1b, iv2a, iv2b, iv3 and
    three zeros.  The k threads of a minor read one record, so no thread
    gathers through coord_flat."""
    ivs = [getattr(sb, name).long()[..., None] for name in ("iv1a", "iv1b", "iv2a", "iv2b", "iv3")]
    pad = torch.zeros_like(ivs[0]).expand(*ivs[0].shape[:-1], 3)
    return torch.cat([cf, sb.mc.long(), *ivs, pad], dim=-1).to(torch.int32).contiguous()


def _minor_blocks_k(sb: ShorKBatch, cf, Xt_s, Wts, v1s, v2s, v3s):
    """The unweighted per-term 5x5 minor slots, (B, M5, k, 5, 5)."""
    B, k = Xt_s.shape[:2]
    Xf = Xt_s.reshape(B, k, -1)
    mc = sb.mc.long()
    xs = [_gather_bk(Xf, cf[..., c]) for c in range(4)]  # 4 x (B, k, M5)
    ws = [_gather_bk(Wts, mc[..., c]) for c in range(4)]
    V1a = _gather_bk(v1s, sb.iv1a.long())
    V1b = _gather_bk(v1s, sb.iv1b.long())
    V2a = _gather_bk(v2s, sb.iv2a.long())
    V2b = _gather_bk(v2s, sb.iv2b.long())
    V3 = _gather_bk(v3s, sb.iv3.long())
    one = torch.ones_like(xs[0])
    x11, x12, x21, x22 = xs
    w11, w12, w21, w22 = ws
    rows = [
        [one, x11, x12, x21, x22],
        [x11, w11, V1a, V2a, V3],
        [x12, V1a, w12, V3, V2b],
        [x21, V2a, V3, w21, V1b],
        [x22, V3, V2b, V1b, w22],
    ]
    w5 = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return w5.movedim(1, 2)  # (B, k, M5, 5, 5) -> (B, M5, k, 5, 5)


def _xwh_blocks(sb: ShorKBatch, Xt_s, Wts, Hs):
    """The unweighted (k+1)x(k+1) XWH slots [[1, Xt'], [Xt, M]], (B, C, k+1, k+1)."""
    B, k = Xt_s.shape[:2]
    C = sb.coord_mask.shape[1]
    Xc = _gather_bk(Xt_s.reshape(B, k, -1), sb.coord_flat.long()).transpose(1, 2)  # (B, C, k)
    wx = torch.zeros((B, C, k + 1, k + 1), dtype=Xt_s.dtype, device=Xt_s.device)
    wx[..., 0, 0] = 1.0
    wx[..., 0, 1:] = Xc
    wx[..., 1:, 0] = Xc
    tt = torch.arange(k, device=Xt_s.device)
    wx[..., tt + 1, tt + 1] = Wts.transpose(1, 2)
    if Hs.shape[1]:
        t1s, t2s = (torch.as_tensor(t, device=Xt_s.device) for t in _pair_indices(k))
        Hc = Hs.transpose(1, 2)  # (B, C, kp)
        wx[..., t1s + 1, t2s + 1] = Hc
        wx[..., t2s + 1, t1s + 1] = Hc
    return wx


def _wlink(sb: ShorKBatch, Ws, Wts, Hs, sS):
    """The W-link rows (sS-weighted, on the scaled variables), (B, C)."""
    B = Ws.shape[0]
    Wat = torch.gather(Ws.reshape(B, -1), 1, sb.coord_flat.long())
    return sS[:, None] * (Wat - torch.sum(Wts, dim=1) - 2.0 * torch.sum(Hs, dim=1)) * sb.coord_mask


def _rsoc_rows(sb: ShorKBatch, Xsum_s, Ws, sS):
    """The RSOC rows (0.5, Ws, sum_t Xt_s) at the complement slots, sS-weighted."""
    B = Ws.shape[0]
    sf = sb.soc_flat.long()
    return sS[:, None, None] * torch.stack([
        0.5 * torch.ones(sf.shape, dtype=Ws.dtype, device=Ws.device),
        torch.gather(Ws.reshape(B, -1), 1, sf),
        torch.gather(Xsum_s.reshape(B, -1), 1, sf),
    ], dim=-1)


def _forward_shor_k(sb: ShorKBatch, Xt_s, Ws, Wts, Hs, v1s, v2s, v3s, k: int, m: int,
                    sX, sW, sS=1.0):
    """Slot values: w5 (B,M5,k,5,5), wx (B,C,k+1,k+1), wr (B,Ms,3),
    wcol (B,m) = sum_i sW W_ij (raw scale, the Theta-link's W part), and
    wwl (B,C).  ``sX``/``sW``/``sS`` are per-slot (B,) scales or python
    scalars."""
    sW = _vec(sW, Xt_s)
    sS = _vec(sS, Xt_s)
    w5 = sS[:, None, None, None, None] * _minor_blocks_k(
        sb, _corner_flat(sb), Xt_s, Wts, v1s, v2s, v3s)
    wx = sS[:, None, None, None] * _xwh_blocks(sb, Xt_s, Wts, Hs)
    wr = _rsoc_rows(sb, torch.sum(Xt_s, dim=1), Ws, sS)
    wcol = torch.sum(sW[:, None, None] * Ws, dim=-2)
    wwl = _wlink(sb, Ws, Wts, Hs, sS)
    return w5, wx, wr, wcol, wwl


def _adjoint_shor_k(sb: ShorKBatch, y5, yx, yr, yl, ywl, B, n, m, k, kp, sX, sW, sS=1.0):
    """Adjoint: duals -> gradients on (Xt_s, Ws, Wts, Hs, v1s, v2s, v3s).
    The Theta-diagonal part of the Theta-link rows is the caller's."""
    sW = _vec(sW, y5)
    sS = _vec(sS, y5)
    y5 = sS[:, None, None, None, None] * y5
    yx = sS[:, None, None, None] * yx
    yr = sS[:, None, None] * yr
    ywl = sS[:, None] * ywl
    y5 = y5 * sb.minor_mask[..., None, None, None]
    yx = yx * sb.coord_mask[..., None, None]
    yr = yr * sb.soc_mask[..., None]
    ywl = ywl * sb.coord_mask
    C = sb.coord_mask.shape[1]
    y5k = y5.movedim(2, 1)  # (B, k, M5, 5, 5)
    cf = _corner_flat(sb)
    mc = sb.mc.long()
    z = lambda *s: torch.zeros(s, dtype=y5.dtype, device=y5.device)  # noqa: E731
    gXt = z(B, k, n * m)
    gWt = z(B, k, C)
    for c in range(4):
        gXt = _scatter_add_bk(gXt, cf[..., c], 2.0 * y5k[..., 0, c + 1])
        gWt = _scatter_add_bk(gWt, mc[..., c], y5k[..., c + 1, c + 1])
    gv1 = _scatter_add_bk(z(B, k, sb.cnt_v1.shape[1]), sb.iv1a.long(), 2.0 * y5k[..., 1, 2])
    gv1 = _scatter_add_bk(gv1, sb.iv1b.long(), 2.0 * y5k[..., 3, 4])
    gv2 = _scatter_add_bk(z(B, k, sb.cnt_v2.shape[1]), sb.iv2a.long(), 2.0 * y5k[..., 1, 3])
    gv2 = _scatter_add_bk(gv2, sb.iv2b.long(), 2.0 * y5k[..., 2, 4])
    gv3 = _scatter_add_bk(z(B, k, sb.cnt_v3.shape[1]), sb.iv3.long(),
                          2.0 * (y5k[..., 1, 4] + y5k[..., 2, 3]))

    # XWH adjoint
    cfl = sb.coord_flat.long()
    gXt = _scatter_add_bk(gXt, cfl, (2.0 * yx[..., 0, 1:]).transpose(1, 2))
    tt = torch.arange(k, device=y5.device)
    gWt = gWt + yx[..., tt + 1, tt + 1].transpose(1, 2)
    gH = z(B, kp, C)
    if kp:
        t1s, t2s = (torch.as_tensor(t, device=y5.device) for t in _pair_indices(k))
        gH = (yx[..., t1s + 1, t2s + 1] + yx[..., t2s + 1, t1s + 1]).transpose(1, 2)

    # RSOC rows: the X slot is sum_t Xt, so the gradient lands on every term
    sf = sb.soc_flat.long()
    gWf = z(B, n * m).scatter_add(1, sf, yr[..., 1])
    gXt = _scatter_add_bk(gXt, sf, yr[..., 2][:, None, :])

    # W-link: +ywl on W_c, -ywl on Wt[:, c], -2 ywl on H[:, c]
    gWf = gWf.scatter_add(1, cfl, ywl)
    gWt = gWt - ywl[:, None, :]
    gH = gH - 2.0 * ywl[:, None, :]

    # Theta-link rows: -sW yl_j on every W_ij (raw coefficient)
    gW = gWf.reshape(B, n, m) - sW[:, None, None] * yl[:, None, :]
    return gXt.reshape(B, k, n, m), gW, gWt, gH, gv1, gv2, gv3


# ---------------------------------------------------------------------------
# Per-solve-call constants
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShorKConsts:
    """Per-solve-call Shor-k constants: the rho-free K'K diagonals and the
    link-Woodbury constants, computed once before the loop as ``omc`` does
    (``omc/sdp/shor_k.py:545-609``)."""

    sb: ShorKBatch
    k: int
    kp: int
    cf: torch.Tensor  # (B, M5, 4) int64 flat entry of each minor corner
    rec: torch.Tensor  # (B, M5, 16) int32 K7t's index records (minor_records)
    offs5: torch.Tensor
    offsx: torch.Tensor
    offsr: torch.Tensor
    cW: torch.Tensor  # (B, n, m) W objective
    D1x: torch.Tensor  # (B, n, m): the X block per entry is D1x I_k + c1x J_k
    c1x: torch.Tensor
    D1w: torch.Tensor  # (B, n*m)
    D1wt: torch.Tensor  # (B, C)
    D1h: torch.Tensor  # (B, C)
    D1v: tuple  # (B, P1), (B, P2), (B, P3)
    D1w_c: torch.Tensor  # (B, C): D1w at each coordinate
    D_c: torch.Tensor  # (B, C): W-link Gram diagonal
    B_jc: torch.Tensor  # (B, C): Theta-link x W-link overlap at (coord_j[c], c)
    S_th: torch.Tensor  # (B, m): Theta-link Schur complement
    R_X: float  # sqrt(2 gamma ub_bar); the Xt clip is R_X / sX
    M5: int


def make_shor_k_consts(c, sb: ShorKBatch, core: ADMMState, ub_bar, k: int) -> _ShorKConsts:
    B, n, m = core.X.shape
    dt = core.X.dtype
    dev = core.X.device
    kp = (k * (k - 1)) // 2
    sX_f = core.sX
    sW_f = sX_f * sX_f
    sX = sX_f[:, None, None]
    sW = sX * sX
    sW2 = sW_f[:, None]
    sS_f = core.sS
    sS2 = sS_f[:, None]
    ss2 = (sS_f * sS_f)[:, None]
    ss2m = (sS_f * sS_f)[:, None, None]
    cdm = sb.coord_mask
    C = cdm.shape[1]
    # X block, per entry: D1x I_k + c1x J_k.  Entries outside every minor/XWH
    # block constrain only the sum over t, so a proximal term tau_x = sX^2
    # regularises the split (see omc)
    tau_x = sX * sX
    D1x = ss2m * (2.0 * sb.cnt_minor + 2.0 * sb.is_coord) + tau_x
    c1x = 2.0 * sX * sX + ss2m * sb.is_soc
    D1w = ss2 * (1.0 + sb.is_soc.reshape(B, -1))
    D1wt = ss2 * (sb.coord_minor_cnt + cdm + 1.0)
    D1h = ss2 * torch.clamp(2.0 * cdm, min=1.0)
    D1v = tuple(ss2 * torch.clamp(cv, min=1.0) for cv in (sb.cnt_v1, sb.cnt_v2, sb.cnt_v3))
    # link Woodbury (diagonal Schur complement)
    A_th = 2.0 + torch.sum((sW * sW) / D1w.reshape(B, n, m), dim=1)  # (B, m)
    D1w_c = torch.gather(D1w, 1, sb.coord_flat.long())
    D_c = 1.0 + cdm * ss2 * (1.0 / D1w_c + k / D1wt + kp * 4.0 / D1h)
    B_jc = -cdm * sW2 * sS2 / D1w_c
    S_th = A_th - torch.zeros_like(A_th).scatter_add(1, sb.coord_j.long(), B_jc * B_jc / D_c)
    z = lambda *s: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    offs5, offsx, offsr, _, _ = _forward_shor_k(
        sb, z(B, k, n, m), z(B, n, m), z(B, k, C), z(B, kp, C),
        z(B, k, sb.cnt_v1.shape[1]), z(B, k, sb.cnt_v2.shape[1]), z(B, k, sb.cnt_v3.shape[1]),
        k, m, sX_f, sW_f, sS_f)
    cont = lambda t: t.contiguous()  # noqa: E731
    cf = _corner_flat(sb)
    return _ShorKConsts(
        sb=sb, k=k, kp=kp, cf=cf, rec=minor_records(sb, cf), offs5=offs5, offsx=offsx, offsr=offsr,
        cW=0.5 * sW * c.mask[None], D1x=cont(D1x), c1x=cont(c1x), D1w=cont(D1w),
        D1wt=cont(D1wt), D1h=cont(D1h), D1v=tuple(cont(d) for d in D1v), D1w_c=D1w_c,
        D_c=cont(D_c), B_jc=cont(B_jc), S_th=cont(S_th),
        R_X=math.sqrt(2.0 * c.gamma * ub_bar), M5=sb.minor_mask.shape[1],
    )


def _shapes(st: ShorKState):
    B, n, m = st.core.X.shape
    k = st.Xt.shape[1]
    return B, n, m, k, st.Hh.shape[1], st.Wt.shape[2], st.wr.shape[1]


def _check_k(name, k):
    if k < 2:
        raise ValueError(f"{name}: the rank-k Shor kernels take k >= 2, got k={k}")


# the plans' path that forces (or, past k = 4, is) the wide kernels of K7x,
# K8c and K8d
WIDE = "wide"
# the register kernels' ranks (K7x at D = k + 1 <= 5, K8c, K8d)
REGISTER_MAX_K = 4


def _wide(name, k, path):
    """Whether ``name`` takes its wide kernel at rank ``k`` (``path`` None:
    past ``REGISTER_MAX_K``; "wide": always)."""
    if path not in (None, WIDE):
        raise ValueError(f"{name}: path must be None or {WIDE!r}, got {path!r}")
    return path == WIDE or k > REGISTER_MAX_K


# K8c's CTA (threads), the CTAs the plan aims for (two a streaming
# multiprocessor of the H100) and the shared memory a CTA may use
K8C_THREADS, K8C_TARGET_CTAS, K8C_MAX_SMEM = 256, 2 * 132, 232448


def k8c_smem_bytes(n: int, m: int, k: int, cols: int, dtype=torch.float32) -> int:
    """K8c's dynamic shared memory (``omc_k8c_smem_bytes``): the kept
    per-entry values (W, q_c, c, the k Wt, the k(k-1)/2 H) of n x cols
    entries, two column sums a row group, a_j, and Theta's staged block
    rows (cols x (m + 1)), values of ``dtype`` (8 bytes in the float64
    build)."""
    nf = k + k * (k - 1) // 2 + 3
    rg = K8C_THREADS // cols
    return dtype.itemsize * (nf * n * cols + 2 * rg * cols + cols + cols * (m + 1))


def k8c_wide_smem_bytes(n: int, k: int, cols: int, kept_global: bool,
                        dtype=torch.float32) -> int:
    """K8c's wide kernel's dynamic shared memory (``omc_k8c_wide_smem_bytes``):
    the kept values of n x cols entries (none where they are in the global
    workspace), two column sums a row group and a_j, values of ``dtype``."""
    nf = k + k * (k - 1) // 2 + 3
    rg = K8C_THREADS // cols
    return dtype.itemsize * ((0 if kept_global else nf * n * cols) + 2 * rg * cols + cols)


def k8c_plan(B: int, n: int, m: int, k: int, dtype=torch.float32, path=None,
             free_bytes=None) -> dict:
    """K8c's tile: a CTA of 256 threads owns ``cols`` whole columns of one
    slot as 256 / cols row groups (the link Woodbury couples only the
    entries of a column).  The widest of 32, 16 and 8 columns that still
    gives ``K8C_TARGET_CTAS`` CTAs, else 8; narrower where the kept values
    (of ``dtype``) outgrow shared memory.

    At 2 <= k <= 4, where one column's kept values fit, the register kernel
    (the dict has no ``path``).  Else, or with ``path="wide"``, the wide
    kernel (``path`` "wide"): the same tile rule on its own shared memory
    (``k8c_wide_smem_bytes``, no staged Theta rows), and where even one
    column's kept values do not fit, the widest tile with the kept values
    in a global workspace (``kept`` "global", ``ws_bytes`` = B NF n m values;
    else ``kept`` "smem", 0).  No rank or width is refused for shared
    memory; with ``free_bytes`` (the card's free memory) a workspace larger
    than it raises, with the byte count."""
    _check_k("K8c", k)
    cols0 = next((c for c in (32, 16, 8) if -(-m // c) * B >= K8C_TARGET_CTAS), 8)
    if not _wide("K8c", k, path):
        cols = cols0
        while cols > 1 and k8c_smem_bytes(n, m, k, cols, dtype) > K8C_MAX_SMEM:
            cols //= 2
        smem = k8c_smem_bytes(n, m, k, cols, dtype)
        if smem <= K8C_MAX_SMEM:
            return dict(cols=cols, row_groups=K8C_THREADS // cols, threads=K8C_THREADS,
                        grid=(-(-m // cols), B), smem_bytes=smem)
    cols = cols0
    while cols > 1 and k8c_wide_smem_bytes(n, k, cols, False, dtype) > K8C_MAX_SMEM:
        cols //= 2
    kept_global = k8c_wide_smem_bytes(n, k, cols, False, dtype) > K8C_MAX_SMEM
    if kept_global:
        cols = cols0
    nf = k + k * (k - 1) // 2 + 3
    ws = dtype.itemsize * B * nf * n * m if kept_global else 0
    if free_bytes is not None and ws > free_bytes:
        raise ValueError(f"K8c's wide kernel at (B, n, m, k) = ({B}, {n}, {m}, {k}): its "
                         f"workspace takes {ws} bytes, the card has {free_bytes} free")
    return dict(path=WIDE, cols=cols, row_groups=K8C_THREADS // cols, threads=K8C_THREADS,
                grid=(-(-m // cols), B),
                smem_bytes=k8c_wide_smem_bytes(n, k, cols, kept_global, dtype),
                kept="global" if kept_global else "smem", ws_bytes=ws)


# --------------------------------------------------------------------------
# K8c: the Shor-k z-step
# --------------------------------------------------------------------------


def shor_k_zstep_plain(c, sc: _ShorKConsts, st: ShorKState):
    """Plain version of K8c, as the ``omc`` loop body
    (``omc/sdp/shor_k.py:618-706``): returns (Xt, X = sum_t Xt, Ths, W,
    Wt, Hh, v1, v2, v3) from the current w/u of every slot."""
    core = st.core
    sb = sc.sb
    k, kp = sc.k, sc.kp
    B, n, m = core.X.shape
    sX_f = core.sX
    sW_f = sX_f * sX_f
    sX = sX_f[:, None, None]
    sT = core.sT[:, None, None]
    sT2 = core.sT[:, None]
    sW = sX * sX
    sW2 = sW_f[:, None]
    sS2 = core.sS[:, None]
    sS3 = core.sS[:, None, None]
    rho_b = core.rho
    r3 = rho_b[:, None, None]
    r4 = rho_b[:, None, None, None]
    cdm = sb.coord_mask
    y1 = core.w1 - core.u1 - c.offs[0]
    rX = sX * 2.0 * y1[..., :n, n:]
    rTh = sT * y1[..., n:, n:]
    gXt, gW, gWt, gH, gv1, gv2, gv3 = _adjoint_shor_k(
        sb, st.w5 - st.u5 - sc.offs5, st.wx - st.ux - sc.offsx, st.wr - st.ur - sc.offsr,
        st.wl - st.ul, st.wwl - st.uwl, B, n, m, k, kp, sX_f, sW_f, core.sS,
    )
    # W >= 0 and Wt >= 0 identity slots (sS-weighted)
    gW = gW + sS3 * (st.wp - st.up)
    gWt = gWt + sS3 * (st.wq - st.uq)
    yl = st.wl - st.ul
    eye = torch.eye(m, dtype=y1.dtype, device=y1.device)
    rTh_l = sT * yl[:, None, :] * eye

    RXt = r4 * (rX[:, None] + gXt) - c.cX[:, None]
    RT = r3 * (rTh + rTh_l) - c.cTh
    RW = r3 * gW - sc.cW
    # X block: (D1x I + c1x J)^{-1} per entry (Sherman-Morrison), with the
    # proximal term tau_x Xt_prev, tau_x = sX^2 per slot (B, 1, 1, 1)
    rx = RXt / r4 + (sX * sX)[:, None] * st.Xt
    rs = torch.sum(rx, dim=1)
    zXt = rx / sc.D1x[:, None] - (sc.c1x * rs / (sc.D1x * (sc.D1x + k * sc.c1x)))[:, None]
    zTh = RT / (r3 * sT * sT)
    zW = (RW / r3).reshape(B, -1) / sc.D1w
    zWt = ((r3 * gWt) / r3) / sc.D1wt[:, None, :]
    zH = ((r3 * gH) / r3) / sc.D1h[:, None, :]
    zv = tuple(((r3 * g) / r3) / d[:, None, :] for g, d in zip((gv1, gv2, gv3), sc.D1v))

    # link Woodbury on (Theta, W, Wt, H)
    cfl = sb.coord_flat.long()
    cj = sb.coord_j.long()
    zW_mat = zW.reshape(B, n, m)
    p = sT2 * torch.diagonal(zTh, dim1=-2, dim2=-1) - sW2 * torch.sum(zW_mat, dim=1)
    q = cdm * sS2 * (torch.gather(zW, 1, cfl) - torch.sum(zWt, dim=1) - 2.0 * torch.sum(zH, dim=1))
    q0 = q / sc.D_c
    Bq = torch.zeros_like(p).scatter_add(1, cj, sc.B_jc * q0)
    a = (p - Bq) / sc.S_th
    bb = (q - sc.B_jc * torch.gather(a, 1, cj)) / sc.D_c
    zTh = zTh - (a / sT2)[:, None, :] * eye
    zW_mat = zW_mat - ((-sW) * a[:, None, :]) / sc.D1w.reshape(B, n, m)
    zW_flat = zW_mat.reshape(B, -1).scatter_add(1, cfl, -(sS2 * bb * cdm) / sc.D1w_c)
    zWt = zWt - (-(sS2 * bb) * cdm / sc.D1wt)[:, None, :]
    zH = zH - (-(2.0 * sS2) * bb * cdm / sc.D1h)[:, None, :]

    Ths = 0.5 * (zTh + zTh.transpose(-1, -2))
    R_Xs4 = sc.R_X / sX[:, None]
    Xt = torch.minimum(torch.maximum(zXt, -R_Xs4), R_Xs4)
    return (Xt, torch.sum(Xt, dim=1), Ths, zW_flat.reshape(B, n, m), zWt, zH) + zv


def _k8c_operands(c, sc: _ShorKConsts, st: ShorKState):
    """(field, tensor, shape, dtype) of every operand of K8c's parameter
    block, in one fixed order: values in the state's dtype, the index tables
    int32."""
    core, sb = st.core, sc.sb
    B, n, m, k, kp, C, Ms = _shapes(st)
    M5, D1 = sc.M5, n + m
    P1, P2, P3 = st.v1.shape[2], st.v2.shape[2], st.v3.shape[2]
    fv, i32 = core.X.dtype, torch.int32
    ops = [("w1", core.w1, (B, D1, D1), fv), ("u1", core.u1, (B, D1, D1), fv)]
    ops += [(name, getattr(st, name), shape, fv) for name, shape in (
        ("w5", (B, M5, k, 5, 5)), ("u5", (B, M5, k, 5, 5)), ("wx", (B, C, k + 1, k + 1)),
        ("ux", (B, C, k + 1, k + 1)), ("wr", (B, Ms, 3)), ("ur", (B, Ms, 3)), ("wl", (B, m)),
        ("ul", (B, m)), ("wwl", (B, C)), ("uwl", (B, C)), ("wp", (B, n, m)), ("up", (B, n, m)),
        ("wq", (B, k, C)), ("uq", (B, k, C)))]
    ops += [("soc_mask", sb.soc_mask, (B, Ms), fv), ("coord_mask", sb.coord_mask, (B, C), fv)]
    # the inverse tables: batch B, each its own width
    ops += [(name, getattr(sb, name), (B,) + tuple(getattr(sb, name).shape[1:]), i32)
            for name in INVERSE_FIELDS]
    ops += [("D1x", sc.D1x, (B, n, m), fv), ("c1x", sc.c1x, (B, n, m), fv),
            ("D1w", sc.D1w, (B, n * m), fv)]
    ops += [(name, getattr(sc, name), (B, C), fv) for name in ("D1wt", "D1h", "D_c", "B_jc")]
    ops += [("S_th", sc.S_th, (B, m), fv)]
    ops += [(name, d, (B, P), fv) for name, d, P in zip(("D1v1", "D1v2", "D1v3"), sc.D1v,
                                                         (P1, P2, P3))]
    ops += [("maskA", c.maskA, (n, m), fv), ("mask", c.mask, (n, m), fv)]
    ops += [(name, getattr(core, name), (B,), fv) for name in ("sX", "sT", "sS", "rho")]
    ops += [("Xt", st.Xt, (B, k, n, m), fv), ("Xs", core.X, (B, n, m), fv),
            ("Ths", core.Th, (B, m, m), fv), ("Ws", st.W, (B, n, m), fv),
            ("Wt", st.Wt, (B, k, C), fv), ("Hh", st.Hh, (B, kp, C), fv)]
    ops += [(name, getattr(st, name), (B, k, P), fv) for name, P in (("v1", P1), ("v2", P2),
                                                                     ("v3", P3))]
    return ops


# K8c's parameter blocks by (c, sc, st), packed once per operands
# (``admm._packed``)
_K8C_ST = operator.attrgetter("w5", "u5", "wx", "ux", "wr", "ur", "wl", "ul", "wwl", "uwl",
                              "wp", "up", "wq", "uq", "Xt", "W", "Wt", "Hh", "v1", "v2", "v3")
_K8C_CORE = operator.attrgetter("w1", "u1", "sX", "sT", "sS", "rho", "X", "Th")
_K8C_SB = operator.attrgetter("soc_mask", "coord_mask", *INVERSE_FIELDS)
_K8C_SC = operator.attrgetter("D1x", "c1x", "D1w", "D1wt", "D1h", "D_c", "B_jc", "S_th")


def _k8c_tensors(c, sc: _ShorKConsts, st: ShorKState) -> tuple:
    """Every K8c operand, gathered cheaply for the reuse test."""
    return (_K8C_ST(st) + _K8C_CORE(st.core) + _K8C_SB(sc.sb) + _K8C_SC(sc) + tuple(sc.D1v)
            + (c.maskA, c.mask))


def _k8c_block(c, sc: _ShorKConsts, st: ShorKState, dev, plan: dict):
    """A fresh K8c parameter block for ``plan`` (``k8c_plan``): ``wide`` says
    which kernel it is for, ``workspace`` holds the wide kernel's kept values
    where they go to global memory (refused past the card's free memory)."""
    dt = st.core.X.dtype
    B, n, m, k, kp, C, Ms = _shapes(st)
    p = kernels.block(kernels.K8cParams, dt)
    for name, t, shape, dtype in _k8c_operands(c, sc, st):
        setattr(p, name, kernels.check(name, t, shape, dev, dtype))
    p.B, p.n, p.m, p.k, p.M5, p.C, p.Ms = B, n, m, k, sc.M5, C, Ms
    p.P1, p.P2, p.P3 = st.v1.shape[2], st.v2.shape[2], st.v3.shape[2]
    p.cols = plan["cols"]
    p.gamma, p.R_X = float(c.gamma), float(sc.R_X)
    p.wide = plan.get("path") == WIDE
    if p.wide and plan["ws_bytes"]:
        if dev.type == "cuda":
            k8c_plan(B, n, m, k, dt, WIDE, free_bytes=torch.cuda.mem_get_info(dev)[0])
        p.workspace = torch.empty(plan["ws_bytes"] // dt.itemsize, dtype=dt, device=dev)
        p.ws = p.workspace.data_ptr()
    return p


def _k8c_params(c, sc: _ShorKConsts, st: ShorKState, dev):
    """K8c's parameter block on ``k8c_plan``'s kernel, packed once per
    operands (``admm._packed``)."""

    def build():
        B, n, m, k, kp, C, Ms = _shapes(st)
        return _k8c_block(c, sc, st, dev, k8c_plan(B, n, m, k, st.core.X.dtype))

    return _packed(("K8c", id(c), id(sc), id(st)), _k8c_tensors(c, sc, st),
                   (float(c.gamma), float(sc.R_X)), build)


def shor_k_zstep(c, sc: _ShorKConsts, st: ShorKState):
    """K8c wrapper: writes Xt, X = sum_t Xt, Ths, W, Wt, Hh, v1, v2, v3 into
    ``st``.  A CPU state runs ``shor_k_zstep_plain``; a CUDA state launches
    ``csrc/k8k_shor_k.cu`` (one CTA per node slot and ``k8c_plan``'s
    columns: the register kernel, or the wide one, counted as "K8cw", past
    k = 4 or where the register kernel's kept values do not fit; the
    float64 builds for a float64 state) or raises."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        outs = (st.Xt, core.X, core.Th, st.W, st.Wt, st.Hh, st.v1, st.v2, st.v3)
        for dst, src in zip(outs, shor_k_zstep_plain(c, sc, st)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"shor_k_zstep: unsupported device {dev}")
    p = _k8c_params(c, sc, st, dev)
    kernels.launch("K8cw" if p.wide else "K8c",
                   kernels.entry("omc_k8c_shor_k_zstep_wide" if p.wide
                                 else "omc_k8c_shor_k_zstep", core.X.dtype), p, dev)


def shor_k_zstep_tiled(c, sc: _ShorKConsts, st: ShorKState, plan: dict):
    """Torch mirror of K8c's order of sums (both kernels; ``plan`` from
    ``k8c_plan``), for the tests: the Sherman-Morrison sum of the k
    right-hand sides, X = sum_t Xt and the W-link row's sums over the terms
    and the pairs, each in order of t (pair); Theta's diagonal column sums
    of the uncorrected W and of B_jc q_c / D_c per row group of
    ``plan["row_groups"]`` (rows g, g + G, ... in order), the groups added
    in order.  Every other value as ``shor_k_zstep_plain``.  Returns the
    plain version's tuple."""
    core = st.core
    sb = sc.sb
    k = sc.k
    B, n, m = core.X.shape
    G = plan["row_groups"]

    def seq(x):  # sum over dim 1 in order
        tot = x[:, 0]
        for t in range(1, x.shape[1]):
            tot = tot + x[:, t]
        return tot

    sX = core.sX[:, None, None]
    sT = core.sT[:, None, None]
    sT2 = core.sT[:, None]
    sW = sX * sX
    sW2 = (core.sX * core.sX)[:, None]
    sS2 = core.sS[:, None]
    r3 = core.rho[:, None, None]
    r4 = core.rho[:, None, None, None]
    cdm = sb.coord_mask
    y1 = core.w1 - core.u1 - c.offs[0]
    rX = sX * 2.0 * y1[..., :n, n:]
    rTh = sT * y1[..., n:, n:]
    gXt, gW, gWt, gH, gv1, gv2, gv3 = _adjoint_shor_k(
        sb, st.w5 - st.u5 - sc.offs5, st.wx - st.ux - sc.offsx, st.wr - st.ur - sc.offsr,
        st.wl - st.ul, st.wwl - st.uwl, B, n, m, k, sc.kp, core.sX, core.sX * core.sX,
        core.sS)
    sS3 = core.sS[:, None, None]
    gW = gW + sS3 * (st.wp - st.up)
    gWt = gWt + sS3 * (st.wq - st.uq)
    yl = st.wl - st.ul
    eye = torch.eye(m, dtype=y1.dtype, device=y1.device)
    RXt = r4 * (rX[:, None] + gXt) - c.cX[:, None]
    RT = r3 * (rTh + sT * yl[:, None, :] * eye) - c.cTh
    RW = r3 * gW - sc.cW
    rx = RXt / r4 + (sX * sX)[:, None] * st.Xt
    zXt = rx / sc.D1x[:, None] - (sc.c1x * seq(rx) / (sc.D1x * (sc.D1x + k * sc.c1x)))[:, None]
    zTh = RT / (r3 * sT * sT)
    zW = (RW / r3).reshape(B, -1) / sc.D1w
    zWt = ((r3 * gWt) / r3) / sc.D1wt[:, None, :]
    zH = ((r3 * gH) / r3) / sc.D1h[:, None, :]
    zv = tuple(((r3 * g) / r3) / d[:, None, :] for g, d in zip((gv1, gv2, gv3), sc.D1v))
    cfl = sb.coord_flat.long()
    cj = sb.coord_j.long()
    zW_mat = zW.reshape(B, n, m)
    p = sT2 * torch.diagonal(zTh, dim1=-2, dim2=-1) - sW2 * link_sums_tiled(zW_mat, G)
    q = cdm * sS2 * (torch.gather(zW, 1, cfl) - seq(zWt) - 2.0 * seq(zH))
    q0 = q / sc.D_c
    # B_jc q_c / D_c at each active coordinate's entry, summed down its column
    dense = torch.zeros_like(zW).scatter_add(1, cfl, sc.B_jc * q0 * (cdm > 0))
    Bq = link_sums_tiled(dense.reshape(B, n, m), G)
    a = (p - Bq) / sc.S_th
    bb = (q - sc.B_jc * torch.gather(a, 1, cj)) / sc.D_c
    zTh = zTh - (a / sT2)[:, None, :] * eye
    zW_mat = zW_mat - ((-sW) * a[:, None, :]) / sc.D1w.reshape(B, n, m)
    zW_flat = zW_mat.reshape(B, -1).scatter_add(1, cfl, -(sS2 * bb * cdm) / sc.D1w_c)
    zWt = zWt - (-(sS2 * bb) * cdm / sc.D1wt)[:, None, :]
    zH = zH - (-(2.0 * sS2) * bb * cdm / sc.D1h)[:, None, :]
    Ths = 0.5 * (zTh + zTh.transpose(-1, -2))
    R_Xs4 = sc.R_X / sX[:, None]
    Xt = torch.minimum(torch.maximum(zXt, -R_Xs4), R_Xs4)
    return (Xt, seq(Xt), Ths, zW_flat.reshape(B, n, m), zWt, zH) + zv


# --------------------------------------------------------------------------
# K7t: the per-term 5x5 minor slots
# --------------------------------------------------------------------------


def minor_k_step_plain(c, sc: _ShorKConsts, st: ShorKState, acc5, proj):
    """Plain version of K7t: the per-term minor slots at the current primal,
    relax-mixed, projected with ``proj``; returns (w5, u5, acc5)."""
    core = st.core
    B = core.X.shape[0]
    f5 = core.sS[:, None, None, None, None] * _minor_blocks_k(
        sc.sb, sc.cf, st.Xt, st.Wt, st.v1, st.v2, st.v3)
    t5 = (c.alpha * f5 + (1.0 - c.alpha) * st.w5) + st.u5
    w5 = proj(t5.reshape(B, -1, 5, 5)).reshape(t5.shape)
    u5 = (t5 - w5) * sc.sb.minor_mask[..., None, None, None]
    acc = acc5 + c.beta * (core.rho[:, None, None, None, None] * u5 - acc5)
    return w5, u5, acc


def minor_k_step(c, sc: _ShorKConsts, st: ShorKState, acc5, psd_method: str):
    """K7t wrapper: updates ``st.w5``, ``st.u5`` and the EMA ``acc5`` in
    place.  A CPU state runs ``minor_k_step_plain`` (the sign schedule, or
    ``eigh`` with ``psd_method="eigh"``); a CUDA state launches
    ``csrc/k7k_minor_xwh.cu`` (one thread per minor and term: the sign
    schedule in float32, ``psd_method="ns"``; K4s's exact Jacobi in the
    float64 build, ``psd_method="eigh"``) or raises.  The parameter block is
    packed once per operands (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        proj = project_psd_ns_small if psd_method == "ns" else project_psd
        for dst, src in zip((st.w5, st.u5, acc5), minor_k_step_plain(c, sc, st, acc5, proj)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"minor_k_step: unsupported device {dev}")
    dt = core.X.dtype
    _cuda_method("K7t", dt, psd_method)
    kernels.launch("K7t", kernels.entry("omc_k7t_minor_k", dt),
                   _k7t_params(c, sc, st, acc5, dev), dev)


def _cuda_method(name: str, dtype, psd_method: str):
    """The projection each CUDA build runs: the sign schedule in float32
    (``"ns"``), K4s's exact Jacobi in float64 (``"eigh"``); another method
    raises."""
    want = "eigh" if dtype == torch.float64 else "ns"
    if psd_method != want:
        raise ValueError(f'{name} projects {dtype} with psd_method="{want}", not {psd_method!r}')


# K7t's and K7x's CTAs (csrc/k7k_minor_xwh.cu): 128 matrices (threads) a
# CTA in float32; in the float64 builds 64 for K7t and for K7x at D = 4 and
# 5, 128 at D = 3, each CTA staging its matrices' w, u and acc in static
# shared memory (at most 48 KB), K7x's float64 matrices at an odd stride of
# doubles (D^2 | 1).  K7x's register kernels take D <= 5; its wide kernel
# any D: a warp a slot, at most K7X_WIDE_WARPS warps a CTA, their matrices
# in at most K8C_MAX_SMEM bytes of shared memory, else in a global
# workspace for K7X_WIDE_WS_CTAS CTAs
K7T_THREADS = {torch.float32: 128, torch.float64: 64}
K7X_THREADS = {torch.float32: {3: 128, 4: 128, 5: 128}, torch.float64: {3: 128, 4: 64, 5: 64}}
K7X_WIDE_WARPS, K7X_WIDE_WS_CTAS = 4, 2 * H100_SMS


def k7t_plan(N: int, dtype=torch.float32) -> dict:
    """K7t's launch for ``N`` (minor, term) matrices (the kernel's
    ``omc_k7t_threads`` and ``omc_k7t_smem_bytes``): ``threads`` matrices a
    CTA, ``ctas`` CTAs, the three staged blocks' ``smem`` bytes."""
    threads = K7T_THREADS[dtype]
    return dict(threads=threads, ctas=_cdiv(N, threads), smem=3 * threads * 25 * dtype.itemsize)


def k7x_wide_values(D: int, dtype=torch.float32) -> int:
    """The values one warp of K7x's wide kernel works in: float32 T, S,
    S^2 and a scratch (4 D^2); float64 A, V, T (3 D^2) and max(w, 0) (D)."""
    return 3 * D * D + D if dtype == torch.float64 else 4 * D * D


def k7x_plan(N: int, D: int, dtype=torch.float32, path=None, free_bytes=None) -> dict:
    """K7x's launch for ``N`` D x D slots.  At D <= 5 the register kernel
    (``omc_k7x_threads``, ``omc_k7x_smem_bytes``): ``threads`` slots a CTA,
    ``ctas`` CTAs, the staged matrix's stride ``ld`` in values and the three
    staged blocks' ``smem`` bytes.  At D > 5, or with ``path="wide"``, the
    wide kernel (``path`` "wide"): a warp a slot, ``warps`` of them a CTA
    (4, fewer where their matrices, ``k7x_wide_values`` each, pass
    ``K8C_MAX_SMEM``; ``omc_k7x_wide_smem_bytes``), ``ctas`` = ceil(N /
    warps) CTAs; where one warp's matrices pass it, ``K7X_WIDE_WS_CTAS`` CTAs
    of 4 warps working in a global workspace of ``work_bytes`` (``smem``
    0), each warp looping over the slots; with ``free_bytes`` (the card's
    free memory) a workspace larger than it raises, with the byte count."""
    if D < 3:
        raise ValueError(f"K7x takes D = k + 1 >= 3, got D = {D}")
    if not _wide("K7x", D - 1, path):
        threads = K7X_THREADS[dtype][D]
        ld = (D * D) | 1 if dtype == torch.float64 else D * D
        return dict(threads=threads, ctas=_cdiv(N, threads), ld=ld,
                    smem=3 * threads * ld * dtype.itemsize)
    per = k7x_wide_values(D, dtype) * dtype.itemsize
    warps = next((w for w in (K7X_WIDE_WARPS, 2, 1) if w * per <= K8C_MAX_SMEM), 0)
    if warps:
        return dict(path=WIDE, warps=warps, threads=32 * warps, ctas=max(1, _cdiv(N, warps)),
                    smem=warps * per, work_bytes=0)
    ctas = max(1, min(K7X_WIDE_WS_CTAS, _cdiv(N, K7X_WIDE_WARPS)))
    work = ctas * K7X_WIDE_WARPS * per
    if free_bytes is not None and work > free_bytes:
        raise ValueError(f"K7x's wide kernel at N = {N}, D = {D}: its workspace takes {work} "
                         f"bytes, the card has {free_bytes} free")
    return dict(path=WIDE, warps=K7X_WIDE_WARPS, threads=32 * K7X_WIDE_WARPS, ctas=ctas,
                smem=0, work_bytes=work)


def _k7t_operands(sc: _ShorKConsts, st: ShorKState, acc5) -> list:
    """(field, tensor, shape, dtype) of every K7t operand: values in the
    state's dtype, the records int32."""
    B, n, m, k, kp, C, Ms = _shapes(st)
    M5 = sc.M5
    fv, i32 = st.core.X.dtype, torch.int32
    return ([("w", st.w5, (B, M5, k, 5, 5), fv), ("u", st.u5, (B, M5, k, 5, 5), fv),
             ("acc", acc5, (B, M5, k, 5, 5), fv), ("Xt", st.Xt, (B, k, n, m), fv),
             ("Wt", st.Wt, (B, k, C), fv)]
            + [(name, getattr(st, name), (B, k, getattr(st, name).shape[2]), fv)
               for name in ("v1", "v2", "v3")]
            + [("rec", sc.rec, (B, M5, 16), i32), ("minor_mask", sc.sb.minor_mask, (B, M5), fv),
               ("sS", st.core.sS, (B,), fv), ("rho", st.core.rho, (B,), fv)])


# K7t's operands, gathered cheaply for the reuse test of its packed block
_K7T_ST = operator.attrgetter("w5", "u5", "Xt", "Wt", "v1", "v2", "v3")
# the per-slot scales K7t and K7x read
_SS_RHO = operator.attrgetter("sS", "rho")


def _k7t_tensors(sc: _ShorKConsts, st: ShorKState, acc5) -> tuple:
    return _K7T_ST(st) + _SS_RHO(st.core) + (sc.rec, sc.sb.minor_mask, acc5)


def _k7t_params(c, sc: _ShorKConsts, st: ShorKState, acc5, dev):
    """K7t's parameter block, packed once per operands (``admm._packed``)."""
    scalars = (float(c.alpha), float(c.beta))
    dt = st.core.X.dtype

    def build():
        B, n, m, k, kp, C, Ms = _shapes(st)
        _check_k("K7t", k)
        p = kernels.block(kernels.K7tParams, dt)
        for name, t, shape, dtype in _k7t_operands(sc, st, acc5):
            setattr(p, name, kernels.check(name, t, shape, dev, dtype))
        if p.rec % 16:
            raise ValueError("rec: K7t reads each minor's index record as 16-byte words")
        if B * sc.M5 * k >= 2 ** 31:
            raise ValueError(f"K7t numbers its B M5 k = {B * sc.M5 * k} matrices in int")
        p.B, p.M5, p.k, p.nm, p.C = B, sc.M5, k, n * m, C
        p.P1, p.P2, p.P3 = st.v1.shape[2], st.v2.shape[2], st.v3.shape[2]
        p.alpha, p.beta = scalars
        return p

    return _packed(("K7t", id(c), id(sc), id(st)), _k7t_tensors(sc, st, acc5), scalars, build)


# --------------------------------------------------------------------------
# K7x: the (k+1)x(k+1) XWH slots
# --------------------------------------------------------------------------


def xwh_step_plain(c, sc: _ShorKConsts, st: ShorKState, accx, proj):
    """Plain version of K7x: the XWH slots at the current primal, relax-
    mixed, projected with ``proj``; returns (wx, ux, accx)."""
    core = st.core
    fx = core.sS[:, None, None, None] * _xwh_blocks(sc.sb, st.Xt, st.Wt, st.Hh)
    tx = (c.alpha * fx + (1.0 - c.alpha) * st.wx) + st.ux
    wx = proj(tx)
    ux = (tx - wx) * sc.sb.coord_mask[..., None, None]
    acc = accx + c.beta * (core.rho[:, None, None, None] * ux - accx)
    return wx, ux, acc


def xwh_step(c, sc: _ShorKConsts, st: ShorKState, accx, psd_method: str):
    """K7x wrapper (slot mode): updates ``st.wx``, ``st.ux`` and the EMA
    ``accx`` in place.  A CPU state runs ``xwh_step_plain`` (the sign
    schedule, or ``eigh`` with ``psd_method="eigh"``); a CUDA state launches
    ``csrc/k7k_minor_xwh.cu`` (``k7x_plan``: at k <= 4 one thread per
    coordinate, a CTA's slots staged through shared memory; past k = 4 the
    wide kernel of ``csrc/k7x_wide.cu``, a warp per coordinate, counted as
    "K7xw"; the sign schedule in float32,
    ``psd_method="ns"``; K4s's exact Jacobi in the float64 builds,
    ``psd_method="eigh"``) or raises.  The parameter block is packed once
    per operands (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        proj = project_psd_ns_small if psd_method == "ns" else project_psd
        for dst, src in zip((st.wx, st.ux, accx), xwh_step_plain(c, sc, st, accx, proj)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"xwh_step: unsupported device {dev}")
    dt = core.X.dtype
    _cuda_method("K7x", dt, psd_method)
    p = _k7x_params(c, sc, st, accx, dev)
    kernels.launch("K7xw" if p.wide else "K7x",
                   kernels.entry("omc_k7x_xwh_wide" if p.wide else "omc_k7x_xwh", dt), p, dev)


def _k7x_operands(sc: _ShorKConsts, st: ShorKState, accx) -> list:
    """(field, tensor, shape, dtype) of every K7x (slot mode) operand:
    values in the state's dtype, coord_flat int32."""
    B, n, m, k, kp, C, Ms = _shapes(st)
    D = k + 1
    fv = st.core.X.dtype
    return [("w", st.wx, (B, C, D, D), fv), ("u", st.ux, (B, C, D, D), fv),
            ("acc", accx, (B, C, D, D), fv), ("Xt", st.Xt, (B, k, n, m), fv),
            ("Wt", st.Wt, (B, k, C), fv), ("Hh", st.Hh, (B, kp, C), fv),
            ("coord_flat", sc.sb.coord_flat, (B, C), torch.int32),
            ("coord_mask", sc.sb.coord_mask, (B, C), fv), ("sS", st.core.sS, (B,), fv),
            ("rho", st.core.rho, (B,), fv)]


# the operands K7x stages as 16-byte words
_K7X_WORDS = ("w", "u", "acc")
# K7x's operands, gathered cheaply for the reuse test of its packed block
_K7X_ST = operator.attrgetter("wx", "ux", "Xt", "Wt", "Hh")
_K7X_SB = operator.attrgetter("coord_flat", "coord_mask")


def _k7x_tensors(sc: _ShorKConsts, st: ShorKState, accx) -> tuple:
    return _K7X_ST(st) + _K7X_SB(sc.sb) + _SS_RHO(st.core) + (accx,)


def k7x_block(plan: dict, N: int, D: int, dtype, dev):
    """A fresh K7x parameter block for ``plan`` (``k7x_plan`` of N D x D
    matrices of ``dtype``) on ``dev``: the register kernels' block, or the
    wide kernel's (``K7xWideParams``) with its launch fields and, where the
    plan has one, its global workspace (held by the block; refused past the
    card's free memory).  ``p.wide`` says which kernel it is for."""
    wide = plan.get("path") == WIDE
    p = kernels.block(kernels.K7xWideParams if wide else kernels.K7xParams, dtype)
    p.wide = wide
    if wide:
        p.warps, p.ctas = plan["warps"], plan["ctas"]
        if plan["work_bytes"]:
            if dev.type == "cuda":
                k7x_plan(N, D, dtype, WIDE, free_bytes=torch.cuda.mem_get_info(dev)[0])
            p.workspace = torch.empty(plan["work_bytes"] // dtype.itemsize, dtype=dtype,
                                      device=dev)
            p.work = p.workspace.data_ptr()
    return p


def _k7x_block(c, sc: _ShorKConsts, st: ShorKState, accx, dev, plan: dict):
    """A fresh K7x parameter block (slot mode) for ``plan`` (``k7x_plan``)."""
    B, n, m, k, kp, C, Ms = _shapes(st)
    _check_k("K7x", k)
    p = k7x_block(plan, B * C, k + 1, st.core.X.dtype, dev)
    for name, t, shape, dtype in _k7x_operands(sc, st, accx):
        setattr(p, name, kernels.check(name, t, shape, dev, dtype))
    if not p.wide and any(getattr(p, name) % 16 for name in _K7X_WORDS):
        raise ValueError("K7x stages wx, ux and the EMA as 16-byte words: their storage "
                         "must start 16-byte aligned")
    p.t = None
    p.N, p.C, p.k, p.nm = B * C, C, k, n * m
    p.alpha, p.beta = float(c.alpha), float(c.beta)
    return p


def _k7x_params(c, sc: _ShorKConsts, st: ShorKState, accx, dev):
    """K7x's parameter block (slot mode) on ``k7x_plan``'s kernel, packed
    once per operands (``admm._packed``)."""

    def build():
        B, n, m, k, kp, C, Ms = _shapes(st)
        return _k7x_block(c, sc, st, accx, dev, k7x_plan(B * C, k + 1, st.core.X.dtype))

    return _packed(("K7x", id(c), id(sc), id(st)), _k7x_tensors(sc, st, accx),
                   (float(c.alpha), float(c.beta)), build)


# --------------------------------------------------------------------------
# K8d: RSOC, Theta-link, W-link, W >= 0 and Wt >= 0 slots
# --------------------------------------------------------------------------


def shor_k_cone_step_plain(c, sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl):
    """Plain version of K8d (``omc/sdp/shor_k.py:754-769``, EMAs
    ``:836-838``): returns (wr, ur, wl, ul, wwl, uwl, wp, up, wq, uq,
    acc_r, acc_l, acc_wl)."""
    core = st.core
    sb = sc.sb
    alpha = c.alpha
    sS = core.sS
    sS3 = sS[:, None, None]
    sT2 = core.sT[:, None]
    sW_f = core.sX * core.sX
    cdm = sb.coord_mask
    fr = _rsoc_rows(sb, core.X, st.W, sS)
    fw_col = torch.sum(sW_f[:, None, None] * st.W, dim=-2)
    f_link = sT2 * torch.diagonal(core.Th, dim1=-2, dim2=-1) - fw_col
    fwl = _wlink(sb, st.W, st.Wt, st.Hh, sS)
    tr_ = (alpha * fr + (1.0 - alpha) * st.wr) + st.ur
    ru, rv, rx = project_rsoc(tr_[..., 0], tr_[..., 1], tr_[..., 2:])
    wr = torch.cat([ru[..., None], rv[..., None], rx], dim=-1)
    ur = (tr_ - wr) * sb.soc_mask[..., None]
    # link rows: zero cone, w = 0 and the dual accumulates
    ul = alpha * f_link + st.ul
    wl = torch.zeros_like(ul)
    uwl = (alpha * fwl + st.uwl) * cdm
    wwl = torch.zeros_like(uwl)
    tp = (alpha * (sS3 * st.W) + (1.0 - alpha) * st.wp) + st.up
    wp = torch.clamp(tp, min=0.0)
    up = tp - wp
    tq = (alpha * (sS3 * st.Wt) + (1.0 - alpha) * st.wq) + st.uq
    wq = torch.clamp(tq, min=0.0)
    uq = tq - wq
    rho = core.rho
    acc_r = acc_r + c.beta * (rho[:, None, None] * ur - acc_r)
    acc_l = acc_l + c.beta * (rho[:, None] * ul - acc_l)
    acc_wl = acc_wl + c.beta * (rho[:, None] * uwl - acc_wl)
    return wr, ur, wl, ul, wwl, uwl, wp, up, wq, uq, acc_r, acc_l, acc_wl


# K8d's geometry (csrc/k8k_shor_k.cu): CTAs of 128 threads; a link CTA sums
# a tile of 32 columns in 4 row groups; a flat CTA takes up to 128 items (a
# group of W >= 0 entries, a group of RSOC rows or a coordinate a thread; a
# group is 16 bytes of values: a quad in float32, a pair in float64), fewer
# until the flat CTAs fill the card's SMs
K8D_THREADS, K8D_LINK_COLS, K8D_LINK_ROWS = 128, 32, 4
K8D_TARGET_CTAS = H100_SMS


def k8d_plan(B: int, n: int, m: int, k: int, C: int, Ms: int, dtype=torch.float32,
             path=None) -> dict:
    """K8d's grid, one dimension: ``link_ctas`` = B ceil(m / 32) CTAs on the
    Theta-link rows (slot x // ceil(m / 32), columns [32 t, 32 t + 32) for
    t = x % ceil(m / 32); row group g of 4 sums rows g, g + 4, ... in order,
    then the groups in order), then CTAs of ``ipc`` items: ``nonneg_ctas``
    on the groups of E = 16 / itemsize consecutive W >= 0 entries of the
    batch's flat B n m (quads in float32, pairs in float64), ``rsoc_ctas``
    on the groups of E consecutive RSOC rows of its flat B Ms,
    ``coord_ctas`` on the coordinates of its flat B C (``grid`` in all).
    ``ipc`` halves from 128 to 32 while there are fewer flat CTAs than
    ``K8D_TARGET_CTAS``.  Past k = 4, or with ``path="wide"``, the wide
    kernel on the same grid (``path`` "wide": its coordinates' CTAs take the
    rank at run time).  Raises on a rank or a shape the kernel does not
    take."""
    _check_k("K8d", k)
    wide = _wide("K8d", k, path)
    if min(B, n, m, C) < 1 or n * m < 4 or Ms < 4:
        raise ValueError(f"K8d: unsupported shape B={B}, n={n}, m={m}, C={C}, Ms={Ms}")
    E = 16 // dtype.itemsize
    items = (_cdiv(B * n * m, E), _cdiv(B * Ms, E), B * C)
    ipc = K8D_THREADS
    while ipc > 32 and sum(_cdiv(x, ipc) for x in items) < K8D_TARGET_CTAS:
        ipc //= 2
    links = B * _cdiv(m, K8D_LINK_COLS)
    nonneg, rsoc, coords = (_cdiv(x, ipc) for x in items)
    plan = dict(ipc=ipc, link_ctas=links, nonneg_ctas=nonneg, rsoc_ctas=rsoc,
                coord_ctas=coords, grid=links + nonneg + rsoc + coords, threads=K8D_THREADS,
                link_rows=K8D_LINK_ROWS)
    if wide:
        plan["path"] = WIDE
    return plan


def shor_k_cone_step_tiled(c, sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl,
                           plan: dict):
    """Torch mirror of K8d's order of work (``plan`` from ``k8d_plan``; both
    kernels), for the tests: the Theta-link rows' column sums of sW W per
    row group (rows g, g + G, ... in order), the G groups added in order;
    the W-link rows' sums of the k Wt and of the k(k-1)/2 H in order of t
    (pair); every other row and slot as ``shor_k_cone_step_plain`` (none
    depends on another).  Returns the plain version's tuple."""
    out = list(shor_k_cone_step_plain(c, sc, st, acc_r, acc_l, acc_wl))
    core = st.core
    tot = link_sums_tiled((core.sX * core.sX)[:, None, None] * st.W, plan["link_rows"])
    f_link = core.sT[:, None] * torch.diagonal(core.Th, dim1=-2, dim2=-1) - tot
    ul = c.alpha * f_link + st.ul
    out[2], out[3] = torch.zeros_like(ul), ul
    out[11] = acc_l + c.beta * (core.rho[:, None] * ul - acc_l)
    sw, sh = st.Wt[:, 0], st.Hh[:, 0]
    for t in range(1, st.Wt.shape[1]):
        sw = sw + st.Wt[:, t]
    for r in range(1, st.Hh.shape[1]):
        sh = sh + st.Hh[:, r]
    B = st.W.shape[0]
    cdm = sc.sb.coord_mask
    Wat = torch.gather(st.W.reshape(B, -1), 1, sc.sb.coord_flat.long())
    fwl = (core.sS[:, None] * (Wat - sw - 2.0 * sh)) * cdm
    uwl = (c.alpha * fwl + st.uwl) * cdm
    out[4], out[5] = torch.zeros_like(uwl), uwl
    out[12] = acc_wl + c.beta * (core.rho[:, None] * uwl - acc_wl)
    return tuple(out)


def shor_k_cone_step(c, sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl):
    """K8d wrapper: updates the RSOC, Theta-link, W-link, W >= 0 and
    Wt >= 0 slots of ``st`` and the EMAs ``acc_r``, ``acc_l``, ``acc_wl`` in
    place.  A CPU state runs ``shor_k_cone_step_plain``; a CUDA state
    launches ``csrc/k8k_shor_k.cu`` (``k8d_plan``'s grid: the register
    kernel at k <= 4, the wide one, counted as "K8dw", past it; the float64
    builds for a float64 state) or raises.  The
    parameter block is packed once per operands (``admm._packed``)."""
    core = st.core
    dev = core.w1.device
    if dev.type == "cpu":
        outs = (st.wr, st.ur, st.wl, st.ul, st.wwl, st.uwl, st.wp, st.up, st.wq, st.uq,
                acc_r, acc_l, acc_wl)
        for dst, src in zip(outs, shor_k_cone_step_plain(c, sc, st, acc_r, acc_l, acc_wl)):
            dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"shor_k_cone_step: unsupported device {dev}")
    p = _k8d_params(c, sc, st, acc_r, acc_l, acc_wl, dev)
    kernels.launch("K8dw" if p.wide else "K8d",
                   kernels.entry("omc_k8d_shor_k_cone_wide" if p.wide else "omc_k8d_shor_k_cone",
                                 core.X.dtype), p, dev)


def _k8d_operands(sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl) -> list:
    """(field, tensor, shape, dtype) of every K8d operand: values in the
    state's dtype, the index tables int32."""
    B, n, m, k, kp, C, Ms = _shapes(st)
    sb, core = sc.sb, st.core
    fv, i32 = core.X.dtype, torch.int32
    return ([("Xs", core.X, (B, n, m), fv), ("Ws", st.W, (B, n, m), fv),
             ("Ths", core.Th, (B, m, m), fv), ("Wt", st.Wt, (B, k, C), fv),
             ("Hh", st.Hh, (B, kp, C), fv), ("wr", st.wr, (B, Ms, 3), fv),
             ("ur", st.ur, (B, Ms, 3), fv), ("acc_r", acc_r, (B, Ms, 3), fv),
             ("wl", st.wl, (B, m), fv), ("ul", st.ul, (B, m), fv), ("acc_l", acc_l, (B, m), fv),
             ("wwl", st.wwl, (B, C), fv), ("uwl", st.uwl, (B, C), fv),
             ("acc_wl", acc_wl, (B, C), fv), ("wp", st.wp, (B, n, m), fv),
             ("up", st.up, (B, n, m), fv), ("wq", st.wq, (B, k, C), fv),
             ("uq", st.uq, (B, k, C), fv), ("soc_flat", sb.soc_flat, (B, Ms), i32),
             ("soc_mask", sb.soc_mask, (B, Ms), fv), ("coord_flat", sb.coord_flat, (B, C), i32),
             ("coord_mask", sb.coord_mask, (B, C), fv)]
            + [(name, getattr(core, name), (B,), fv) for name in ("sX", "sT", "sS", "rho")])


# the operands K8d reads and writes as 16-byte words
_K8D_WORDS = ("Ws", "wp", "up", "wr", "ur", "acc_r", "soc_flat", "soc_mask")
# K8d's operands, gathered cheaply for the reuse test of its packed block
_K8D_ST = operator.attrgetter("W", "Wt", "Hh", "wr", "ur", "wl", "ul", "wwl", "uwl", "wp", "up",
                              "wq", "uq")
_K8D_CORE = operator.attrgetter("X", "Th", "sX", "sT", "sS", "rho")
_K8D_SB = operator.attrgetter("soc_flat", "soc_mask", "coord_flat", "coord_mask")


def _k8d_tensors(sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl) -> tuple:
    return _K8D_ST(st) + _K8D_CORE(st.core) + _K8D_SB(sc.sb) + (acc_r, acc_l, acc_wl)


def _k8d_block(c, sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl, dev, plan: dict):
    """A fresh K8d parameter block for ``plan`` (``k8d_plan``); ``wide`` says
    which kernel it is for."""
    B, n, m, k, kp, C, Ms = _shapes(st)
    p = kernels.block(kernels.K8dParams, st.core.X.dtype)
    for name, t, shape, dtype in _k8d_operands(sc, st, acc_r, acc_l, acc_wl):
        setattr(p, name, kernels.check(name, t, shape, dev, dtype))
    if any(getattr(p, name) % 16 for name in _K8D_WORDS):
        raise ValueError("K8d reads W, the RSOC slots and tables and the W >= 0 slot as "
                         "16-byte words: their storage must start 16-byte aligned")
    p.B, p.n, p.m, p.k, p.C, p.Ms = B, n, m, k, C, Ms
    p.ipc = plan["ipc"]
    p.alpha, p.beta = float(c.alpha), float(c.beta)
    p.wide = plan.get("path") == WIDE
    return p


def _k8d_params(c, sc: _ShorKConsts, st: ShorKState, acc_r, acc_l, acc_wl, dev):
    """K8d's parameter block on ``k8d_plan``'s kernel, packed once per
    operands (``admm._packed``)."""

    def build():
        B, n, m, k, kp, C, Ms = _shapes(st)
        return _k8d_block(c, sc, st, acc_r, acc_l, acc_wl, dev,
                          k8d_plan(B, n, m, k, C, Ms, st.core.X.dtype))

    return _packed(("K8d", id(c), id(sc), id(st)), _k8d_tensors(sc, st, acc_r, acc_l, acc_wl),
                   (float(c.alpha), float(c.beta)), build)


def shor_k_iteration(c, sc: _ShorKConsts, st: ShorKState, ts, acc, psd_method: str):
    """One in-place Shor-k ADMM iteration: K2 (Y, U) -> K8c -> K3 -> K1 ->
    K7t -> K7x -> K8d (see the module docstring).  ``acc`` holds the ten
    EMA accumulators (rho u1, u2, ua, ub, uc, u5, ux, ur, ul, uwl); ``ts``
    the t1/t2/t3 scratch."""
    core = st.core
    zstep(c, core, shor=True)
    shor_k_zstep(c, sc, st)
    cone_step(c, core, ts, acc[2:5])
    ws = (core.w1, core.w2, core.w3)
    us = (core.u1, core.u2, core.u3)
    accs = (acc[0], acc[1], None)
    if psd_method == "ns":
        project_psd_ns_multi(list(ts), w_out=ws, u_out=us, acc=accs, rho=core.rho,
                             beta=c.beta)
    else:
        psd_epilogue(ts, [project_psd(t) for t in ts], ws, us, accs, core.rho, c.beta)
    minor_k_step(c, sc, st, acc[5], psd_method)
    xwh_step(c, sc, st, acc[6], psd_method)
    shor_k_cone_step(c, sc, st, acc[7], acc[8], acc[9])


def make_shor_k_solver(n: int, m: int, k: int, L: int, M5: int, Ms: int, gamma: float, *,
                       iters: int = 400, dtype=torch.float32, alpha: float = 1.6,
                       psd_method: str = "auto", check_every: int = 2000,
                       ema_iters: int = 1500):
    """Batched ADMM solver for the rank-k (k > 1) Shor relaxation (port of
    ``omc.sdp.shor_k.make_shor_k_solver``).

    solve(A, mask, batch, sb, ub_bar, state, n_iters, target, group) ->
    (state, out); ``out`` carries the unscaled primal (X = sum_t Xt, Xt, W,
    Y, Th, U), the best chunk's bias-corrected EMA duals of the ten dual
    blocks, ``lb_dev``/``lb_est`` and the two separation eigenpairs of
    UU' - Y.  ``target``/``group`` give the early exit of
    ``make_admm_solver``."""
    if k < 2:
        raise ValueError(f"the rank-k Shor solver needs k >= 2, got {k}")
    if psd_method == "auto":
        psd_method = "eigh" if dtype == torch.float64 else "ns"
    if psd_method not in ("ns", "eigh"):
        raise ValueError(f"psd_method {psd_method!r}")

    def solve(A, mask, batch: NodeBatch, sb, ub_bar, state: ShorKState,
              n_iters=None, target=None, group=None):
        """Run up to ``n_iters`` (default ``iters``) iterations from a clone
        of ``state``."""
        dev = state.core.rho.device
        if dev.type == "cuda":
            kernels.require_full_fp32()
            kernels.require_cuda_dtype("shor_k", dtype)
            want = "ns" if dtype == torch.float32 else "eigh"
            if psd_method != want:
                raise ValueError(f'the CUDA path projects {dtype} with psd_method="{want}"')
        ni = int(iters if n_iters is None else n_iters)
        A = torch.as_tensor(A, device=dev).to(dtype).contiguous()
        mask = torch.as_tensor(mask, device=dev).to(dtype).contiguous()
        batch_t = batch.map(lambda x: torch.as_tensor(x, device=dev).to(dtype).contiguous())
        sb_t = shor_k_batch_to_device(sb, dtype, device=dev)
        B = batch_t.cut_mask.shape[0]
        st = state.clone()
        core = st.core
        beta = 1.0 / max(ema_iters, 1)
        c = make_consts(A, mask, batch_t, core, n, m, k, gamma, alpha, beta, dtype)
        sc = make_shor_k_consts(c, sb_t, core, ub_bar, k)
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
                    (core.u1, core.u2, core.ua, core.ub, core.uc, st.u5, st.ux, st.ur,
                     st.ul, st.uwl)]

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
                shor_k_iteration(c, sc, st, ts, ema, psd_method)
            corr = 1.0 - (1.0 - beta_t) ** torch.tensor(float(it + chunk), dtype=dtype, device=dev)
            inv = 1.0 / torch.maximum(corr, beta_t)
            ybar = [inv * a for a in ema]
            lb, lb_est = safe_dual_bound_shor_k2(
                A, mask, batch_t, sb_t, *ybar, gamma, k, ub_bar,
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
        names = ("y1", "y2", "ya", "yb", "yc", "y5", "yx", "yr", "yl", "ywl")
        out = {
            "X": sX * core.X, "Xt": sX[:, None] * st.Xt, "Y": core.Y,
            "Th": core.sT[:, None, None] * core.Th, "U": core.U, "W": sX * sX * st.W,
            "sX": core.sX, "sS": core.sS,  # slot scales (certification)
            **dict(zip(names, b_ybar)),
            "lb_dev": b_lb, "lb_est": b_est,
            "iters_run": torch.full((B,), it, dtype=torch.int32, device=dev),
            "sep_w": sep_w, "sep_V": sep_V,
        }
        return st, out

    return solve


# ---------------------------------------------------------------------------
# Safe dual bounds of the rank-k Shor relaxation
# ---------------------------------------------------------------------------


def _col(s, ref):
    """A per-slot scale as (B, 1), or a 0-d tensor for a scalar."""
    s = torch.as_tensor(s, dtype=ref.dtype, device=ref.device)
    return s.reshape(-1, 1) if s.ndim else s


def safe_dual_bound_shor_k(A, mask, batch: NodeBatch, sb: ShorKBatch, y1, y2, ya, yb, yc,
                           y5, yx, yr, yl, ywl, gamma, k: int, ub_bar, margin_rel=None,
                           sX=1.0, sS=1.0):
    """Closed-form safe Lagrangian dual bound of the rank-k Shor relaxation,
    valid for any dual iterate (port of
    ``omc.sdp.shor_k.safe_dual_bound_shor_k``): multipliers are cone-
    projected here; the kept sets are |Xt| <= R_X, W, Wt in [0, 2 gamma
    ub], |H|, |V| <= 2 gamma ub, Y in the spectrahedron, U in the box and
    Theta PSD with trace <= 2 gamma ub.  Torch, on any device and dtype;
    every eigendecomposition goes through ``ops.cones`` (kernels K4 and K4s
    on the GPU, LAPACK on the CPU)."""
    n, m = A.shape[-2], A.shape[-1]
    B = y1.shape[0]
    kp = (k * (k - 1)) // 2
    T_th = 2.0 * gamma * ub_bar
    R_X = math.sqrt(T_th)
    Wmax = T_th
    Vmax = T_th
    dev = A.device

    S1 = project_psd(-y1)
    S2 = project_psd(-y2)
    q, R1 = S1[:, :n, n:], S1[:, n:, n:]
    P1_ = S1[:, :n, :n]
    P2_, D, E = S2[:, :n, :n], S2[:, :n, n:], S2[:, n:, n:]

    cmask = batch.cut_mask
    alpha = torch.clamp(-ya, min=0.0) * cmask[..., None]
    beta = torch.clamp(-yb, min=0.0) * cmask[..., None]
    lam = torch.clamp(-yc, min=0.0) * cmask
    cut_x = batch.cut_x
    lo, hi = batch.cut_lo, batch.cut_hi
    c = lo + hi
    bconst = torch.sum(-lo * hi, dim=-1)

    cdm = sb.coord_mask
    socm = sb.soc_mask
    S5 = project_psd(-y5) * sb.minor_mask[..., None, None, None]  # (B, M5, k, 5, 5)
    Sx = project_psd(-yx) * cdm[..., None, None]  # (B, C, k+1, k+1)
    dr = -yr
    a_r, b_r, c_r = project_rsoc(dr[..., 0], dr[..., 1], dr[..., 2:])
    c_r = c_r[..., 0]
    a_r, b_r, c_r = a_r * socm, b_r * socm, c_r * socm
    ywl = ywl * cdm  # free (W-link); yl free (Theta-link)
    # raw-constraint multipliers of the rescaled slots: the solver slot is
    # sS D M D with D = diag(1, 1/sX, ...), so X coefficients divide by sX
    # and W/Wt/H/V ones by sX^2
    sX = _col(sX, A)
    sS = _col(sS, A)
    inv_x2 = sS / sX
    inv_x3 = inv_x2[..., None] if inv_x2.ndim else inv_x2
    inv_w2 = sS / (sX * sX)
    inv_w3 = inv_w2[..., None] if inv_w2.ndim else inv_w2
    sS1 = sS[..., 0] if sS.ndim else sS

    # ---- Y / U / cut terms ----
    G_Y = -(P1_ + P2_) + torch.einsum("bl,bln,blp->bnp", lam, cut_x, cut_x)
    G_Y = 0.5 * (G_Y + G_Y.transpose(-1, -2))
    y_term = torch.sum(torch.clamp(eigvalsh(G_Y)[..., :k], max=0.0), dim=-1)
    W_U = -2.0 * D - torch.einsum("bln,blk->bnk", cut_x, alpha - beta + lam[..., None] * c)
    u_term = torch.sum(torch.minimum(W_U * batch.U_lo, W_U * batch.U_hi), dim=(-2, -1))
    cut_const = (
        torch.sum(alpha * lo, dim=(-2, -1))
        - torch.sum(beta * hi, dim=(-2, -1))
        - torch.sum(lam * bconst, dim=-1)
    )

    # ---- Theta: (1/2g) I - R1 + yl on the diagonal ----
    eye_m = torch.eye(m, dtype=A.dtype, device=dev)
    G_Th = (0.5 / gamma) * eye_m[None] - R1 + yl[:, None, :] * eye_m[None]
    G_Th = 0.5 * (G_Th + G_Th.transpose(-1, -2))
    th_term = T_th * torch.clamp(eigvalsh(G_Th)[..., 0], max=0.0)

    # ---- coefficient assembly (the Lagrangian adds <y, slot> per slot) ----
    cf = _corner_flat(sb)
    mc = sb.mc.long()
    cfl = sb.coord_flat.long()
    sf = sb.soc_flat.long()
    coef_Xt = ((-mask * A).reshape(1, 1, n * m).expand(B, k, n * m)
               - 2.0 * q.reshape(B, 1, n * m).expand(B, k, n * m)).contiguous()
    S5k = S5.movedim(2, 1)  # (B, k, M5, 5, 5)
    for corner in range(4):
        coef_Xt = _scatter_add_bk(coef_Xt, cf[..., corner],
                                  -2.0 * inv_x3 * S5k[..., 0, corner + 1])
    coef_Xt = _scatter_add_bk(coef_Xt, cfl, -2.0 * inv_x3 * Sx[..., 0, 1:].movedim(2, 1))
    coef_Xt = _scatter_add_bk(coef_Xt, sf, (-inv_x2 * c_r)[:, None, :])

    coef_W = ((0.5 * mask)[None].expand(B, n, m) - yl[:, None, :]).reshape(B, -1)
    coef_W = coef_W.scatter_add(1, sf, -inv_w2 * b_r)
    coef_W = coef_W.scatter_add(1, cfl, inv_w2 * ywl)

    C = cdm.shape[1]
    zz = lambda *s: torch.zeros(s, dtype=A.dtype, device=dev)  # noqa: E731
    coef_Wt = zz(B, k, C)
    for corner in range(4):
        coef_Wt = _scatter_add_bk(coef_Wt, mc[..., corner],
                                  -inv_w3 * S5k[..., corner + 1, corner + 1])
    tt = torch.arange(k, device=dev)
    coef_Wt = coef_Wt - inv_w3 * Sx[..., tt + 1, tt + 1].movedim(2, 1)
    coef_Wt = coef_Wt - (inv_w2 * ywl)[:, None, :]

    coef_H = zz(B, kp, C)
    if kp:
        t1s, t2s = (torch.as_tensor(t, device=dev) for t in _pair_indices(k))
        coef_H = coef_H - inv_w3 * (Sx[..., t1s + 1, t2s + 1] + Sx[..., t2s + 1, t1s + 1]).movedim(2, 1)
        coef_H = coef_H - 2.0 * (inv_w2 * ywl)[:, None, :]

    coef_v1 = _scatter_add_bk(zz(B, k, sb.cnt_v1.shape[1]), sb.iv1a.long(),
                              -2.0 * inv_w3 * S5k[..., 1, 2])
    coef_v1 = _scatter_add_bk(coef_v1, sb.iv1b.long(), -2.0 * inv_w3 * S5k[..., 3, 4])
    coef_v2 = _scatter_add_bk(zz(B, k, sb.cnt_v2.shape[1]), sb.iv2a.long(),
                              -2.0 * inv_w3 * S5k[..., 1, 3])
    coef_v2 = _scatter_add_bk(coef_v2, sb.iv2b.long(), -2.0 * inv_w3 * S5k[..., 2, 4])
    coef_v3 = _scatter_add_bk(zz(B, k, sb.cnt_v3.shape[1]), sb.iv3.long(),
                              -2.0 * inv_w3 * (S5k[..., 1, 4] + S5k[..., 2, 3]))

    x_term = -R_X * torch.sum(torch.abs(coef_Xt), dim=(-2, -1))
    w_term = Wmax * torch.sum(torch.clamp(coef_W, max=0.0), dim=-1)
    wt_term = Wmax * torch.sum(torch.clamp(coef_Wt, max=0.0), dim=(-2, -1))
    h_term = -Wmax * torch.sum(torch.abs(coef_H), dim=(-2, -1))
    v_term = -Vmax * (
        torch.sum(torch.abs(coef_v1), dim=(-2, -1))
        + torch.sum(torch.abs(coef_v2), dim=(-2, -1))
        + torch.sum(torch.abs(coef_v3), dim=(-2, -1))
    )

    const = (
        0.5 * torch.sum(mask * A * A)
        - sS1 * torch.sum(S5[..., 0, 0], dim=(-2, -1))
        - sS1 * torch.sum(Sx[..., 0, 0], dim=-1)
        - 0.5 * sS1 * torch.sum(a_r, dim=-1)
        - torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
        + cut_const
    )

    lb = (y_term + u_term + th_term + x_term + w_term + wt_term + h_term + v_term + const)
    if margin_rel is None:
        margin_rel = margin_rel_default(A.dtype)
    scale = (
        1.0 + torch.abs(lb) + ub_bar
        + torch.sqrt(torch.sum(S1 * S1, dim=(-2, -1)))
        + torch.sqrt(torch.sum(S2 * S2, dim=(-2, -1)))
        + torch.sqrt(torch.sum(S5 * S5, dim=(-4, -3, -2, -1)))
        + torch.sqrt(torch.sum(Sx * Sx, dim=(-3, -2, -1)))
    )
    return lb - margin_rel * scale


def safe_dual_bound_shor_k2(A, mask, batch, sb, y1, y2, ya, yb, yc, y5, yx, yr, yl, ywl,
                            gamma, k, ub_bar, sX=1.0, sS=1.0):
    """``(lb_valid, lb_est)``: the margined bound with a conservative scale
    from the raw duals (||proj_PSD(-y)||_F <= ||y||_F), and the unmargined
    value as the float64-tracking early-exit estimator (not a sound bound;
    the driver re-certifies in float64 before acting)."""
    lb = safe_dual_bound_shor_k(A, mask, batch, sb, y1, y2, ya, yb, yc, y5, yx, yr, yl,
                                ywl, gamma, k, ub_bar, margin_rel=0.0, sX=sX, sS=sS)
    scale = (
        1.0 + torch.abs(lb) + ub_bar
        + torch.sqrt(torch.sum(y1 * y1, dim=(-2, -1)))
        + torch.sqrt(torch.sum(y2 * y2, dim=(-2, -1)))
        + torch.sqrt(torch.sum(y5 * y5, dim=(-4, -3, -2, -1)))
        + torch.sqrt(torch.sum(yx * yx, dim=(-3, -2, -1)))
    )
    return lb - margin_rel_default(A.dtype) * scale, lb


def host_certified_bound_shor_k(A, mask, batch: NodeBatch, sbh: ShorKBatchHost, out: dict,
                                gamma, k: int, ub_bar, margin_rel=1e-10):
    """Float64 safe dual bound of the rank-k Shor relaxation on the host
    (CPU, LAPACK eigh) from solver outputs (tensors on any device or numpy
    arrays).  Returns a numpy (B,) array."""
    f = lambda a: torch.as_tensor(_np(a), dtype=torch.float64)  # noqa: E731
    sb = shor_k_batch_to_device(sbh, torch.float64, device="cpu")
    names = ("y1", "y2", "ya", "yb", "yc", "y5", "yx", "yr", "yl", "ywl")
    lb = safe_dual_bound_shor_k(
        f(A), f(mask), batch.map(f), sb, *[f(out[key]) for key in names],
        float(gamma), k, float(ub_bar), margin_rel=margin_rel,
        sX=f(out.get("sX", 1.0)), sS=f(out.get("sS", 1.0)),
    )
    return lb.numpy()


def apply_best_duals(state: ShorKState, out: dict) -> ShorKState:
    """The visit's best-chunk duals as scaled duals (u = y / rho), applied
    to the continuation state as well as to children, as for k = 1
    (``omc/solve.py:691-704``)."""
    rho = state.core.rho
    return state.replace(
        core=apply_core_best_duals(state.core, out),
        u5=out["y5"] / rho[:, None, None, None, None],
        ux=out["yx"] / rho[:, None, None, None],
        ur=out["yr"] / rho[:, None, None], ul=out["yl"] / rho[:, None],
        uwl=out["ywl"] / rho[:, None],
    )


__all__ = [
    "ShorKBatchHost", "ShorKBatch", "pack_shor_k_batch", "shor_k_batch_to_device",
    "inverse_tables_k", "k8c_plan", "k8c_smem_bytes", "k8c_wide_smem_bytes", "k7t_plan",
    "k7x_plan", "k7x_block", "k7x_wide_values", "shor_k_batch_host_from_omc_leaves",
    "shor_k_zstep_tiled", "WIDE",
    "ShorKState",
    "init_shor_k_state", "make_shor_k_consts", "make_shor_k_solver", "shor_k_iteration",
    "shor_k_zstep", "shor_k_zstep_plain", "minor_k_step", "minor_k_step_plain", "minor_records",
    "xwh_step", "xwh_step_plain", "shor_k_cone_step", "shor_k_cone_step_plain", "k8d_plan",
    "shor_k_cone_step_tiled", "safe_dual_bound_shor_k", "safe_dual_bound_shor_k2",
    "host_certified_bound_shor_k", "apply_best_duals",
]
