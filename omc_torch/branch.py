"""Separation oracle and child-node generation.

Mirrors ``create_matrix_cut_child_nodes`` (reference
`src/OptimalMatrixCompletion.jl:2411-2543`; ported from ``omc/branch.py``).
The eigen-decomposition of ``U U' - Y`` is computed on the device at the end
of the batched relaxation solve (batched ``eigh`` replaces the reference's
per-node ARPACK calls, lines 2466-2477); this module consumes those
eigenpairs on the host to enumerate direction tuples and build children.
On the McCormick path ``create_mccormick_child_nodes`` bisects the widest U
interval instead (reference lines 991-1029).
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from omc_torch.sdp.cuts import N_PIECES
from omc_torch.tree import BBNode, DisjunctiveCut


def breakpoint_vector(sep_w: np.ndarray, sep_V: np.ndarray, rule: str) -> np.ndarray:
    """Breakpoint vector from the smallest eigenpairs of U U' - Y.

    ``sep_w`` (2,) ascending eigenvalues, ``sep_V`` (n, 2) eigenvectors.
    ``smallest_2_eigvec`` blends the two most negative eigenvectors with
    weights |eig| / ||eig|| when the second is < -1e-10 (reference lines
    2466-2477); the blend is unit-norm since the eigenvectors are
    orthonormal."""
    if rule == "smallest_1_eigvec":
        return sep_V[:, 0]
    elif rule == "smallest_2_eigvec":
        if sep_w[1] < -1e-10:
            w = np.abs(sep_w[:2])
            w = w / np.sqrt(np.sum(w**2))
            return w[0] * sep_V[:, 0] + w[1] * sep_V[:, 1]
        return sep_V[:, 0]
    raise ValueError(
        "Invalid input for disjunctive cuts breakpoints. Must be either "
        f'"smallest_1_eigvec" or "smallest_2_eigvec"; {rule} supplied instead.'
    )


def direction_tuples(cuts_type: str, k: int):
    """All direction-code tuples — 2^k / 3^k / 4^k children
    (reference lines 2479-2493)."""
    return list(itertools.product(range(N_PIECES[cuts_type]), repeat=k))


def create_matrix_cut_child_nodes(
    node: BBNode,
    cuts_type: str,
    breakpoints_rule: str,
    *,
    sep_w: np.ndarray,
    sep_V: np.ndarray,
    U_relax: np.ndarray,
    counter: int,
    objective_relax: float,
    new_Shor_info=None,
) -> List[BBNode]:
    """Expand a node into one child per direction tuple, each inheriting the
    parent's cuts plus the new disjunction (reference lines 2520-2542)."""
    x = breakpoint_vector(np.asarray(sep_w), np.asarray(sep_V), breakpoints_rule)
    x = x / max(np.linalg.norm(x), 1e-30)
    vhat = np.asarray(U_relax).T @ x  # (k,)
    k = vhat.shape[0]
    children = []
    for ind, codes in enumerate(direction_tuples(cuts_type, k)):
        cut = DisjunctiveCut(x=x, vhat=vhat, code=np.asarray(codes, dtype=np.int32))
        children.append(
            BBNode(
                node_id=counter + ind + 1,
                parent_id=node.node_id,
                U_lower=node.U_lower,
                U_upper=node.U_upper,
                LB=objective_relax,
                depth=node.depth + 1,
                cuts=list(node.cuts) + [cut],
                Shor_info=new_Shor_info if new_Shor_info is not None else node.Shor_info,
            )
        )
    return children


def create_mccormick_child_nodes(node: BBNode, counter: int,
                                 objective_relax: float) -> List[BBNode]:
    """Bisect the widest U box interval into two children (reference lines
    991-1029); McCormick nodes carry no cuts."""
    diff = node.U_upper - node.U_lower
    ind = np.unravel_index(np.argmax(diff), diff.shape)
    branch_val = node.U_lower[ind] + diff[ind] / 2.0
    U_upper_left = node.U_upper.copy()
    U_upper_left[ind] = branch_val
    U_lower_right = node.U_lower.copy()
    U_lower_right[ind] = branch_val
    return [
        BBNode(node_id=counter + 1 + c, parent_id=node.node_id, U_lower=lo, U_upper=hi,
               LB=objective_relax, depth=node.depth + 1, cuts=None,
               Shor_info=node.Shor_info)
        for c, (lo, hi) in enumerate(((node.U_lower, U_upper_left),
                                      (U_lower_right, node.U_upper)))
    ]

