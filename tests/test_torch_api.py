"""Parity of the port's standalone entry points (omc_torch/api.py) with
omc.api on the same node, for the four relaxation families, in float64 on
the CPU."""

import numpy as np
import pytest
import torch

import omc.api as japi
import omc.sdp.shor as jshor
import omc.tree as jtree

import omc_torch.api as tapi
import omc_torch.sdp.shor as tshor
import omc_torch.tree as ttree
from omc_torch.data import generate_matrix_completion_data

torch.set_num_threads(2)

N = M = 6
GAMMA = 20.0


def _nodes(k, family):
    """The same node for both packages: the root box, one linear cut for
    the disjunctive families, the [4, 3]-minors for the Shor ones."""
    A, idx = generate_matrix_completion_data(k, N, M, 24, 3)
    lo, hi = ttree.root_box(N, k)
    rng = np.random.default_rng(k)
    x = rng.standard_normal(N)
    cut = dict(x=x / np.linalg.norm(x), vhat=rng.uniform(-0.3, 0.3, k),
               code=np.zeros(k, np.int32))
    nodes = []
    for tree_mod, shor_mod in ((jtree, jshor), (ttree, tshor)):
        shor = None
        if family == "shor":
            minors = shor_mod.generate_rank1_matrix_completion_Shor_constraints_indexes(
                idx, [4, 3])
            shor = tree_mod.ShorInfo(constraints_indexes=minors,
                                     SOC_constraints_indexes=shor_mod.shor_soc_complement(
                                         N, M, minors))
        cuts = None if family == "mccormick" else [tree_mod.DisjunctiveCut(**cut)]
        nodes.append(tree_mod.BBNode(node_id=2, parent_id=1, U_lower=lo, U_upper=hi,
                                     LB=-np.inf, depth=1, cuts=cuts, Shor_info=shor))
    return A, idx, nodes


@pytest.mark.parametrize("k,family", [(1, "base"), (2, "base"), (1, "shor"), (2, "shor"),
                                      (1, "mccormick"), (2, "mccormick")])
def test_relaxation_matches_omc(k, family):
    A, idx, (node_j, node_t) = _nodes(k, family)
    kw = dict(use_disjunctive_cuts=family != "mccormick", disjunctive_cuts_type="linear",
              add_Shor_valid_inequalities=family == "shor", iters=300, dtype="float64")
    rj = japi.matrix_completion_SDP_relaxation(node_j, N, k, A, idx, GAMMA, **kw)
    rt = tapi.matrix_completion_SDP_relaxation(node_t, N, k, A, idx, GAMMA, device="cpu", **kw)
    assert set(rt) == set(rj)
    lb, lb_j = rt["lower_bound"], rj["lower_bound"]
    assert np.isfinite(lb)
    assert abs(lb - lb_j) <= 1e-6 * max(1.0, abs(lb_j)), (lb, lb_j)
    assert abs(rt["objective"] - rj["objective"]) <= 1e-6 * max(1.0, abs(rj["objective"]))
    for key in ("X", "Y", "U", "Theta"):
        assert rt[key].shape == np.asarray(rj[key]).shape, key


@pytest.mark.parametrize("k,with_cut", [(1, False), (2, False), (2, True)])
def test_alternating_minimization_matches_omc(k, with_cut):
    A, idx, (node_j, node_t) = _nodes(k, "base")
    U0 = np.linalg.svd(A * idx, full_matrices=False)[0][:, :k]
    rj = japi.alternating_minimization(
        A, N, k, idx, GAMMA, disjunctive_cuts_type="linear", U_initial=U0,
        disjunctive_cuts=node_j.cuts if with_cut else ())
    rt = tapi.alternating_minimization(
        A, N, k, idx, GAMMA, disjunctive_cuts_type="linear", U_initial=U0,
        disjunctive_cuts=node_t.cuts if with_cut else (), device="cpu")
    assert set(rt) == set(rj)
    assert (rt["converged"], rt["n_iters"], rt["max_iters"]) == (
        rj["converged"], rj["n_iters"], rj["max_iters"])
    for key in ("U", "V"):
        assert np.max(np.abs(rt[key] - np.asarray(rj[key]))) <= 1e-9, key
    assert len(rt["objectives"]) == len(rj["objectives"])
    assert np.max(np.abs(np.subtract(rt["objectives"], rj["objectives"]))) <= 1e-9
