"""Host-side packing of the Shor valid-inequality state into fixed-shape
arrays (port of ``omc/sdp/shor_encode.py``, rank-1 path).

A node's Shor state is a set of 2x2 minors (i1, i2, j1, j2) plus the
complementary coordinate set that keeps the plain RSOC row
``W_ij >= X_ij^2``.  On the device this becomes:

- a (M5, 4) int32 minor table + mask,
- gather tables mapping each minor's lifted entries to indices into the
  per-node flat arrays v1 (entries V1[i, (j1, j2)]), v2 (V2[(i1,i2), j]),
  v3 (V3[(i1,i2), (j1,j2)]) -- shared across minors exactly as in the
  reference's JuMP model, and prefix-stable: appending minors keeps every
  earlier minor's indices, so a grown node warm-starts row for row,
- the RSOC coordinate list + mask in the canonical layout (slot s is
  coordinate (s // m, s % m), ``Msoc == n*m``),
- per-entry appearance counts for the ADMM z-step diagonal.

Beside ``omc``'s fields, ``ShorBatchHost`` carries the inverse tables of
the adjoint (``inverse_tables``): for every X/W coordinate and every v1,
v2, v3 entry, the CSR list of the minor slots that touch it.  The adjoint
kernel K8a sums over those lists instead of scattering with atomics, so its
sums are deterministic.  The minor set changes only between visits, so the
tables are built once per visit on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# omc's ShorBatchHost fields, in its order
OMC_FIELDS = (
    "minor_idx", "minor_mask", "iv1a", "iv1b", "iv2a", "iv2b", "iv3",
    "soc_idx", "soc_mask", "cnt_X", "cnt_W", "cnt_v1", "cnt_v2", "cnt_v3",
)
INVERSE_FIELDS = ("xw_ptr", "xw_ent", "v1_ptr", "v1_ent", "v2_ptr", "v2_ent",
                  "v3_ptr", "v3_ent")


@dataclasses.dataclass
class ShorBatchHost:
    """Numpy Shor batch.

    minor_idx:  (B, M5, 4) int32   (i1, i2, j1, j2), 0-padded
    minor_mask: (B, M5)
    iv1a/iv1b:  (B, M5) int32      index into v1 for V1[i1,.], V1[i2,.]
    iv2a/iv2b:  (B, M5) int32      index into v2 for V2[.,j1], V2[.,j2]
    iv3:        (B, M5) int32      index into v3
    soc_idx:    (B, Ms, 2) int32   RSOC coordinates (i, j)
    soc_mask:   (B, Ms)
    cnt_X:      (B, n, m)          appearances of X_ij in minor+RSOC slots
    cnt_W:      (B, n, m)          appearances of W_ij in minor+RSOC+W>=0
    cnt_v1/v2/v3: (B, P*)          appearances of each shared v entry
    xw_ptr/xw_ent: (B, n*m+1), (B, 4*M5) int32  coordinate -> entries
                   4*l + c-1 (minor slot l, 5x5 row/column c = 1..4)
    v1_ptr/v1_ent: (B, P1+1), (B, 2*M5) int32   v1 entry -> 2*l (iv1a) or
                   2*l+1 (iv1b); v2 likewise with iv2a/iv2b
    v3_ptr/v3_ent: (B, P3+1), (B, M5) int32     v3 entry -> l
    """

    minor_idx: np.ndarray
    minor_mask: np.ndarray
    iv1a: np.ndarray
    iv1b: np.ndarray
    iv2a: np.ndarray
    iv2b: np.ndarray
    iv3: np.ndarray
    soc_idx: np.ndarray
    soc_mask: np.ndarray
    cnt_X: np.ndarray
    cnt_W: np.ndarray
    cnt_v1: np.ndarray
    cnt_v2: np.ndarray
    cnt_v3: np.ndarray
    xw_ptr: np.ndarray
    xw_ent: np.ndarray
    v1_ptr: np.ndarray
    v1_ent: np.ndarray
    v2_ptr: np.ndarray
    v2_ent: np.ndarray
    v3_ptr: np.ndarray
    v3_ent: np.ndarray

    def omc_leaves(self) -> list:
        """The fields ``omc``'s ShorBatchHost has, in its order."""
        return [getattr(self, f) for f in OMC_FIELDS]


def _csr(keys, ents, size):
    """CSR lists of ``ents`` grouped by ``keys`` in [0, size), entries in
    ascending order within each key."""
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(size + 1, dtype=np.int32)
    np.cumsum(np.bincount(keys, minlength=size), out=ptr[1:])
    return ptr, ents[order].astype(np.int32)


def v_inverse_tables(B, M5, P1, P2, P3) -> dict:
    """Empty v1/v2/v3 inverse tables for B slots of M5 minors."""
    return {
        "v1_ptr": np.zeros((B, P1 + 1), np.int32),
        "v1_ent": np.zeros((B, 2 * M5), np.int32),
        "v2_ptr": np.zeros((B, P2 + 1), np.int32),
        "v2_ent": np.zeros((B, 2 * M5), np.int32),
        "v3_ptr": np.zeros((B, P3 + 1), np.int32),
        "v3_ent": np.zeros((B, M5), np.int32),
    }


def fill_v_inverse(out, b, act, iv1a, iv1b, iv2a, iv2b, iv3, P1, P2, P3):
    """Slot ``b``'s rows of the v inverse tables from its active minors
    ``act``: v1/v2 entry -> 2*l (the iv*a use) or 2*l+1 (iv*b), v3 -> l."""
    for name, ia, ib, P in (("v1", iv1a, iv1b, P1), ("v2", iv2a, iv2b, P2)):
        keys = np.stack([np.asarray(ia[b])[act], np.asarray(ib[b])[act]], axis=1)
        ents = 2 * act[:, None] + np.arange(2)[None]
        ptr, ent = _csr(keys.reshape(-1).astype(np.int64), ents.reshape(-1), P)
        out[f"{name}_ptr"][b], out[f"{name}_ent"][b, : ent.size] = ptr, ent
    ptr, ent = _csr(np.asarray(iv3[b])[act].astype(np.int64), act, P3)
    out["v3_ptr"][b], out["v3_ent"][b, : ent.size] = ptr, ent


def inverse_tables(n, m, minor_idx, minor_mask, iv1a, iv1b, iv2a, iv2b, iv3,
                   P1, P2, P3) -> dict:
    """The adjoint's inverse gather tables from the forward tables (active
    minors only: a padded slot's dual is masked to zero in the adjoint)."""
    B, M5 = minor_mask.shape
    out = {
        "xw_ptr": np.zeros((B, n * m + 1), np.int32),
        "xw_ent": np.zeros((B, 4 * M5), np.int32),
        **v_inverse_tables(B, M5, P1, P2, P3),
    }
    for b in range(B):
        act = np.flatnonzero(np.asarray(minor_mask[b]) > 0)
        mi = np.asarray(minor_idx[b], np.int64)[act]
        i1, i2, j1, j2 = mi[:, 0], mi[:, 1], mi[:, 2], mi[:, 3]
        # entry 4l + (c-1) at the coordinate of the minor's (0, c) slot
        flat = np.stack([i1 * m + j1, i1 * m + j2, i2 * m + j1, i2 * m + j2], axis=1)
        ents = 4 * act[:, None] + np.arange(4)[None]
        ptr, ent = _csr(flat.reshape(-1), ents.reshape(-1), n * m)
        out["xw_ptr"][b], out["xw_ent"][b, : ent.size] = ptr, ent
        fill_v_inverse(out, b, act, iv1a, iv1b, iv2a, iv2b, iv3, P1, P2, P3)
    return out


def pack_shor_batch(
    n: int,
    m: int,
    minors_per_node: List[Sequence[Tuple[int, int, int, int]]],
    soc_per_node: List[Sequence[Tuple[int, int]]],
    M5: int,
    Msoc: int,
) -> ShorBatchHost:
    """Pack per-node minor and RSOC lists; ``omc``'s fields come out equal
    to ``omc.sdp.shor_encode.pack_shor_batch``'s."""
    B = len(minors_per_node)
    P1 = 2 * M5
    P2 = 2 * M5
    P3 = M5
    if Msoc != n * m:
        raise ValueError(
            f"canonical SOC layout requires Msoc == n*m ({n * m}); got {Msoc}"
        )
    minor_idx = np.zeros((B, M5, 4), dtype=np.int32)
    minor_mask = np.zeros((B, M5), dtype=np.float64)
    iv1a = np.zeros((B, M5), dtype=np.int32)
    iv1b = np.zeros((B, M5), dtype=np.int32)
    iv2a = np.zeros((B, M5), dtype=np.int32)
    iv2b = np.zeros((B, M5), dtype=np.int32)
    iv3 = np.zeros((B, M5), dtype=np.int32)
    soc_idx = np.zeros((B, Msoc, 2), dtype=np.int32)
    soc_mask = np.zeros((B, Msoc), dtype=np.float64)
    cnt_X = np.zeros((B, n, m))
    cnt_W = np.zeros((B, n, m))
    cnt_v1 = np.zeros((B, P1))
    cnt_v2 = np.zeros((B, P2))
    cnt_v3 = np.zeros((B, P3))
    # canonical coordinate table (same for every node): slot s = i*m + j
    coords = np.arange(Msoc, dtype=np.int32)
    soc_idx[:, :, 0] = coords // m
    soc_idx[:, :, 1] = coords % m

    for b in range(B):
        minors = list(minors_per_node[b])
        if len(minors) > M5:
            raise ValueError(f"node has {len(minors)} Shor minors > capacity {M5}")
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
            minor_idx[b, l] = (i1, i2, j1, j2)
            minor_mask[b, l] = 1.0
            iv1a[b, l] = get(v1_map, (i1, j1, j2), P1, "v1")
            iv1b[b, l] = get(v1_map, (i2, j1, j2), P1, "v1")
            iv2a[b, l] = get(v2_map, (i1, i2, j1), P2, "v2")
            iv2b[b, l] = get(v2_map, (i1, i2, j2), P2, "v2")
            iv3[b, l] = get(v3_map, (i1, i2, j1, j2), P3, "v3")
            for (i, j) in ((i1, j1), (i1, j2), (i2, j1), (i2, j2)):
                cnt_X[b, i, j] += 2.0  # (0, c) and (c, 0) slots of the 5x5
                cnt_W[b, i, j] += 1.0  # diagonal slot
            cnt_v1[b, iv1a[b, l]] += 2.0
            cnt_v1[b, iv1b[b, l]] += 2.0
            cnt_v2[b, iv2a[b, l]] += 2.0
            cnt_v2[b, iv2b[b, l]] += 2.0
            cnt_v3[b, iv3[b, l]] += 4.0

        # canonical SOC layout: membership is carried by the mask alone
        for (i, j) in soc_per_node[b]:
            soc_mask[b, i * m + j] = 1.0
            cnt_X[b, i, j] += 1.0
            cnt_W[b, i, j] += 1.0

        # W >= 0 slot (reference: @variable W >= 0): +1 on every entry
        cnt_W[b] += 1.0
        # the Theta-link rows Theta_jj = sum_i W_ij live in the low-rank
        # part of K'K (see admm_shor.py), not in the diagonal counts

    inv = inverse_tables(n, m, minor_idx, minor_mask, iv1a, iv1b, iv2a, iv2b,
                         iv3, P1, P2, P3)
    return ShorBatchHost(
        minor_idx=minor_idx, minor_mask=minor_mask,
        iv1a=iv1a, iv1b=iv1b, iv2a=iv2a, iv2b=iv2b, iv3=iv3,
        soc_idx=soc_idx, soc_mask=soc_mask,
        cnt_X=cnt_X, cnt_W=cnt_W,
        cnt_v1=cnt_v1, cnt_v2=cnt_v2, cnt_v3=cnt_v3, **inv,
    )


def shor_batch_host_from_omc_leaves(leaves, n, m) -> ShorBatchHost:
    """``omc``'s 14 ShorBatchHost leaves (field order) plus the inverse
    tables built from them."""
    leaves = [np.asarray(x) for x in leaves]
    if len(leaves) != len(OMC_FIELDS):
        raise ValueError(f"expected {len(OMC_FIELDS)} leaves, got {len(leaves)}")
    kw = dict(zip(OMC_FIELDS, leaves))
    inv = inverse_tables(
        n, m, kw["minor_idx"], kw["minor_mask"], kw["iv1a"], kw["iv1b"],
        kw["iv2a"], kw["iv2b"], kw["iv3"], kw["cnt_v1"].shape[1],
        kw["cnt_v2"].shape[1], kw["cnt_v3"].shape[1],
    )
    return ShorBatchHost(**kw, **inv)
