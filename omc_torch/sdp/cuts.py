"""Eigenvector-disjunction cut encoding.

A disjunctive cut in the reference is a tuple ``(breakpoint_vec, U_hat,
directions)`` with ``directions`` a vector of strings
(reference `src/OptimalMatrixCompletion.jl:2424-2432`).  Here a cut is
pure array data so a fixed-shape batch of nodes can carry ragged cut lists
as padded tensors:

- ``x``      (L, n)  — unit breakpoint vectors
- ``vhat``   (L, k)  — ``U_hat^T x`` per cut (all the model ever needs)
- ``code``   (L, k)  — int direction codes (see below)
- ``mask``   (L,)    — 1 for real cuts, 0 for padding

Direction codes, per cut family (reference lines 1581-1677):

- ``linear``  (2 pieces):  0 = left  [-1, vhat],       1 = right [vhat, 1]
- ``linear2`` (3 pieces):  0 = left  [-1, -|vhat|],    1 = middle
  [-|vhat|, |vhat|],       2 = right [|vhat|, 1]
- ``linear3`` (4 pieces):  0 = left  [-1, -|vhat|],    1 = inner_left
  [-|vhat|, 0], 2 = inner_right [0, |vhat|], 3 = right [|vhat|, 1]

Each region [lo, hi] contributes the interval constraints
``lo <= v_j <= hi`` on ``v = U^T x`` and the aggregated chord constraint
``sum_j ((lo_j + hi_j) v_j - lo_j hi_j) >= x^T Y x`` — the secant
overestimator of ``sum_j v_j^2`` on the region.

Deviation from the reference: for ``linear3``/``right`` the reference uses
the expression ``|vhat| * v`` (line 1675) instead of the correct secant
``(1 + |vhat|) v - |vhat|`` on [|vhat|, 1]; that expression *under*-estimates
``v^2`` at ``v = 1`` and can cut off master-feasible points.  We implement
the mathematically valid secant.
"""

from __future__ import annotations

import numpy as np

N_PIECES = {"linear": 2, "linear2": 3, "linear3": 4}

def region_bounds(cuts_type: str, code, vhat):
    """(lo, hi) arrays for direction ``code`` at breakpoint value ``vhat``.

    Works on numpy arrays of matching shape (vectorised over cuts and
    coordinates).
    """
    a = np.abs(vhat)
    one = np.ones_like(vhat)
    if cuts_type == "linear":
        lo = np.where(code == 0, -one, vhat)
        hi = np.where(code == 0, vhat, one)
    elif cuts_type == "linear2":
        lo = np.where(code == 0, -one, np.where(code == 1, -a, a))
        hi = np.where(code == 0, -a, np.where(code == 1, a, one))
    elif cuts_type == "linear3":
        lo = np.where(code == 0, -one, np.where(code == 1, -a, np.where(code == 2, 0.0 * one, a)))
        hi = np.where(code == 0, -a, np.where(code == 1, 0.0 * one, np.where(code == 2, a, one)))
    else:
        raise ValueError(
            "Invalid input for disjunctive cuts type. Disjunctive cuts type must be "
            f'either "linear" or "linear2" or "linear3"; {cuts_type} supplied instead.'
        )
    return lo, hi

