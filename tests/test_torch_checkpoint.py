"""Checkpoint / resume of the port's branch-and-bound driver
(omc_torch/utils/checkpoint.py and the driver's hooks), on the CPU."""

import os

import numpy as np
import pytest
import torch

from omc_torch.data import generate_matrix_completion_data
from omc_torch.solve import matrix_completion_branchandbound
from omc_torch.tree import BBNode, BBTree, root_box
from omc_torch.utils.checkpoint import CHECKPOINT_VERSION, load_checkpoint, save_checkpoint

torch.set_num_threads(2)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.pkl")
    lo, hi = root_box(4, 1)
    tree = BBTree(BBNode(1, 0, lo, hi, -np.inf, 0, cuts=[]), 3.5)
    save_checkpoint(p, {"a": np.arange(5), "b": {"x": 1.5}, "tree": tree})
    out = load_checkpoint(p)
    np.testing.assert_array_equal(out["a"], np.arange(5))
    assert out["b"]["x"] == 1.5
    assert isinstance(out["tree"], BBTree)
    assert out["tree"].best_upper_bound == 3.5
    assert list(out["tree"].nodes) == [1]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_version_mismatch_raises(tmp_path):
    import pickle

    p = str(tmp_path / "old.pkl")
    with open(p, "wb") as fh:
        pickle.dump({"__version__": CHECKPOINT_VERSION + 1}, fh)
    with pytest.raises(ValueError, match="version"):
        load_checkpoint(p)


_BASE = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec", batch_size=2, sdp_iters=600,
             dtype="float64", verbosity=0)


def test_resumed_run_ends_like_an_uninterrupted_one(tmp_path):
    """A run stopped after 3 nodes writes a checkpoint; resuming from it
    reaches the gap at the same objective as one uninterrupted run."""
    A, idx = generate_matrix_completion_data(1, 6, 6, 24, seed=0)
    sol0, _, inst0 = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", gap=1e-2, time_limit=60, **_BASE)
    ck = str(tmp_path / "solver.ckpt")
    kw = dict(_BASE, checkpoint_path=ck, checkpoint_every=0)
    sol1, _, inst1 = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", gap=1e-9, use_max_steps=True, max_steps=3, **kw)
    assert os.path.exists(ck)
    state = load_checkpoint(ck)
    assert isinstance(state["tree"], BBTree)
    assert state["tree"].nodes_explored >= 1
    assert set(state) == {"tree", "solution", "census", "run_log", "rng_state"}
    sol2, _, inst2 = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", gap=1e-2, time_limit=60, resume=True, **kw)
    gap0, gap2 = inst0["run_log"][-1]["gap"], inst2["run_log"][-1]["gap"]
    assert gap0 <= 1e-2 and gap2 <= 1e-2
    assert abs(sol2["objective"] - sol0["objective"]) <= (gap0 + gap2) * abs(sol0["objective"])
    assert sol2["objective"] <= sol1["objective"] + 1e-12
    # the resumed run continues the first one's log and census
    assert len(inst2["run_log"]) > len(inst1["run_log"])
    assert inst2["run_details"]["nodes_explored"] >= inst1["run_details"]["nodes_explored"]


def test_mccormick_run_checkpoints_and_resumes(tmp_path):
    """The McCormick path's nodes (cuts=None) pickle and resume: the resumed
    tree continues from the saved frontier with the saved incumbent."""
    A, idx = generate_matrix_completion_data(1, 6, 6, 14, 0)
    ck = str(tmp_path / "mc.ckpt")
    kw = dict(use_disjunctive_cuts=False, node_selection="bestfirst", batch_size=4,
              sdp_iters=200, sdp_iter_boost_max=1, max_refines=1, dtype="float64",
              verbosity=0, checkpoint_path=ck, checkpoint_every=0, gap=1e-4)
    sol1, _, inst1 = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", use_max_steps=True, max_steps=5, **kw)
    state = load_checkpoint(ck)
    assert state["tree"].counter >= 3
    assert all(nd.cuts is None for nd in state["tree"].nodes.values())
    sol2, pl2, inst2 = matrix_completion_branchandbound(
        1, A, idx, 80.0, device="cpu", use_max_steps=True, max_steps=9, resume=True, **kw)
    assert any("Resumed from checkpoint" in line for line in pl2)
    assert sol2["objective"] <= sol1["objective"] + 1e-12
    assert inst2["run_details"]["nodes_total"] >= state["tree"].counter
    lowers = [r["lower"] for r in inst2["run_log"] if np.isfinite(r["lower"])]
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
