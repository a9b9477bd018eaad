"""The port's branch-and-bound main path end to end, on the CPU in float64:
the four certified fixture instances (tests/fixtures/instances.json, the
settings of tests/test_fixtures.py) and the 12x12 instance of
tests/test_e2e.py::test_bnb_certifies_small_instance, checked against the
recorded certificates and against omc on the same call."""

import json
import os

import numpy as np
import pytest
import torch

from omc.solve import matrix_completion_branchandbound as omc_bnb

from omc_torch.data import generate_matrix_completion_data
from omc_torch.solve import matrix_completion_branchandbound

torch.set_num_threads(2)

_FIXTURE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "instances.json"
)
with open(_FIXTURE_PATH) as fh:
    _FIXTURES = json.load(fh)

_RESOLVE_GAP = 1e-2
_MAIN = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec")


@pytest.mark.parametrize(
    "fx", _FIXTURES,
    ids=[f"k{f['k']}_n{f['n']}_seed{f['seed']}" for f in _FIXTURES],
)
def test_port_certifies_fixture(fx):
    A, idx = generate_matrix_completion_data(
        fx["k"], fx["n"], fx["m"], fx["n_indices"], fx["seed"]
    )
    sol, _, inst = matrix_completion_branchandbound(
        fx["k"], A, idx, fx["gamma"], device="cpu", **_MAIN,
        gap=_RESOLVE_GAP, batch_size=8, sdp_iters=1200, dtype="float64",
        time_limit=300, verbosity=0,
    )
    log = inst["run_log"][-1]
    assert log["gap"] <= _RESOLVE_GAP
    obj = float(sol["objective"])
    ref = fx["certified_objective"]
    # both runs certify optima of the same problem: the incumbents agree
    # within the sum of the two certified gaps (relative)
    tol = (fx["certified_gap"] + _RESOLVE_GAP) * max(1.0, abs(ref))
    assert abs(obj - ref) <= tol, (obj, ref, tol)
    # weak duality: the certified LB cannot exceed the fixture's optimum
    assert float(log["lower"]) <= ref * (1.0 + fx["certified_gap"]) + 1e-9
    assert inst["run_details"]["device"] == "cpu"


def test_port_certifies_small_instance_like_omc():
    n = m = 12
    A, idx = generate_matrix_completion_data(1, n, m, int(0.5 * n * m), seed=3)
    kw = dict(_MAIN, gap=1e-3, batch_size=4, sdp_iters=1500, sdp_rho=0.03,
              dtype="float64", time_limit=120, verbosity=0)
    sol, printlist, inst = matrix_completion_branchandbound(1, A, idx, 80.0, device="cpu", **kw)
    rd = inst["run_details"]
    log = inst["run_log"]
    assert log[-1]["gap"] <= 1e-3
    assert sol["objective"] <= sol["objective_initial"] + 1e-12
    assert np.linalg.matrix_rank(sol["X"], tol=1e-6) <= 1
    # census equality invariants (reference lines 411-454)
    assert (
        rd["nodes_dominated"] + rd["nodes_relax_infeasible"] + rd["nodes_relax_feasible"]
        == rd["nodes_explored"]
    )
    assert (
        rd["nodes_relax_feasible_pruned"] + rd["nodes_master_feasible"]
        + rd["nodes_relax_feasible_split"]
        == rd["nodes_relax_feasible"]
    )
    assert rd["nodes_master_feasible_improvement"] <= rd["nodes_master_feasible"]
    assert rd["nodes_relax_feasible_split_altmin"] <= rd["nodes_relax_feasible_split"]
    assert (
        rd["nodes_relax_feasible_split_altmin_improvement"]
        <= rd["nodes_relax_feasible_split_altmin"]
    )
    lowers = [r["lower"] for r in log if np.isfinite(r["lower"])]
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    for key in ["X", "Y", "U", "MSE_in", "MSE_out", "MSE_all",
                "objective_initial", "X_initial"]:
        assert key in sol
    assert rd["sdp_iters_total"] > 0 and rd["device_steps"] >= 1
    # omc on the same call: both certify the same problem to 1e-3
    sol_j, _, inst_j = omc_bnb(1, A, idx, 80.0, **kw)
    gap_j = inst_j["run_log"][-1]["gap"]
    tol = (log[-1]["gap"] + gap_j) * max(1.0, abs(sol_j["objective"]))
    assert abs(sol["objective"] - sol_j["objective"]) <= tol
    assert abs(sol["objective_initial"] - sol_j["objective_initial"]) <= 1e-9 * max(
        1.0, abs(sol_j["objective_initial"]))


def test_root_only_and_selective_certification():
    """root_only stops after the root; host_certify_max_batch below the
    batch bucket certifies only the binding slots and still reaches the
    fixture's certified optimum of this instance (seed 3)."""
    A, idx = generate_matrix_completion_data(1, 12, 12, 72, seed=3)
    _, _, inst = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", **_MAIN, root_only=True, batch_size=2,
        sdp_iters=500, dtype="float64", verbosity=0)
    assert inst["run_details"]["nodes_explored"] == 1
    sol, _, inst = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", **_MAIN, gap=1e-3, batch_size=4,
        sdp_iters=1500, sdp_rho=0.03, dtype="float64", time_limit=120,
        verbosity=0, host_certify_max_batch=1)
    # the refinement visit runs 4 portfolio slots > host_certify_max_batch
    assert inst["run_details"]["refinement_visits"] >= 1
    gap = inst["run_log"][-1]["gap"]
    assert gap <= 1e-3
    fx = _FIXTURES[0]
    assert (fx["n"], fx["seed"]) == (12, 3)
    ref = fx["certified_objective"]
    assert abs(sol["objective"] - ref) <= (gap + fx["certified_gap"]) * max(1.0, abs(ref))
