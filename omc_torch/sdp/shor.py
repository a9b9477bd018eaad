"""Shor valid-inequality index machinery, host side (port of
``omc/sdp/shor.py``; numpy, output identical to ``omc``).

The reference's combinatorial enumeration of 2x2 minors classified by the
number of observed entries
(``generate_rank1_matrix_completion_Shor_constraints_indexes``, reference
lines 2545-2612), the violated-minor scoring and top-N selection
(``generate_violated_Shor_minors``, lines 2614-2640) and the RSOC
complement (lines 656-665).  The conic Shor blocks themselves (5x5 PSD
minors, RSOC rows) live in ``omc_torch.sdp.admm_shor``.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np

Minor = Tuple[int, int, int, int]


def generate_rank1_matrix_completion_Shor_constraints_indexes(
    indices: np.ndarray, num_entries_present_list: Sequence[int]
) -> List[Minor]:
    """All 2x2 minors (i1, i2, j1, j2), i1<i2, j1<j2, whose number of
    observed entries is in ``num_entries_present_list`` (0-based indices)."""
    indices = np.asarray(indices, dtype=bool)
    n, m = indices.shape
    out: List[Minor] = []
    for num in num_entries_present_list:
        for i1, i2 in itertools.combinations(range(n), 2):
            r1, r2 = indices[i1], indices[i2]
            both = np.flatnonzero(r1 & r2).tolist()
            xor = np.flatnonzero(r1 ^ r2).tolist()
            neither = np.flatnonzero(~(r1 | r2)).tolist()
            if num == 4:
                pairs = itertools.combinations(both, 2)
            elif num == 3:
                pairs = itertools.product(both, xor)
            elif num == 2:
                # one fully observed column with one fully unobserved one,
                # then two half-observed columns
                pairs = itertools.chain(itertools.product(both, neither),
                                        itertools.combinations(xor, 2))
            elif num == 1:
                pairs = itertools.product(xor, neither)
            elif num == 0:
                pairs = itertools.combinations(neither, 2)
            else:
                pairs = ()
            for j1, j2 in pairs:
                a, b = (j1, j2) if j1 < j2 else (j2, j1)
                out.append((i1, i2, a, b))
    return out


def generate_violated_Shor_minors(
    X: np.ndarray,
    indices: np.ndarray,
    num_entries_present_list: Sequence[int],
    existing: Sequence[Minor],
    n_minors: int,
) -> List[Tuple[float, Minor]]:
    """Top-``n_minors`` minors by determinant-violation score
    ``sum_t |X_t[i1,j1] X_t[i2,j2] - X_t[i1,j2] X_t[i2,j1]|`` among the
    candidates not already active.  ``X``: (k, n, m) or (n, m)."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 2:
        X = X[None]
    cand = generate_rank1_matrix_completion_Shor_constraints_indexes(
        indices, num_entries_present_list
    )
    existing_set = set(existing)
    cand = [c for c in cand if c not in existing_set]
    if not cand:
        return []
    idx = np.asarray(cand, dtype=np.int64)  # (M, 4)
    i1, i2, j1, j2 = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    score = np.sum(
        np.abs(X[:, i1, j1] * X[:, i2, j2] - X[:, i1, j2] * X[:, i2, j1]), axis=0
    )
    order = np.argsort(-score, kind="stable")[:n_minors]
    return [(float(score[o]), cand[o]) for o in order]


def shor_soc_complement(n: int, m: int, minors: Sequence[Minor]) -> List[Tuple[int, int]]:
    """Coordinates (i, j) covered by no active minor: these keep the plain
    RSOC row ``W_ij >= X_ij^2``."""
    covered = np.zeros((n, m), dtype=bool)
    for (i1, i2, j1, j2) in minors:
        covered[[i1, i1, i2, i2], [j1, j2, j1, j2]] = True
    return [(int(i), int(j)) for i, j in zip(*np.nonzero(~covered))]
