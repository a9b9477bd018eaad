"""The driver's ``profile_dir`` option (port of omc/solve.py:648-663): a
torch.profiler trace of the first super-steps, written as a Chrome trace,
with omc's count (once a super-step; the trace stops once the count passes
``profile_steps``, or at the end).  Runs on the CPU in float64, where the
trace holds the CPU activity (on the card, the kernels' CUDA events too)."""

import glob
import json
import os

import numpy as np
import torch

from omc_torch.data import generate_matrix_completion_data
from omc_torch.solve import matrix_completion_branchandbound

torch.set_num_threads(2)

_KW = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
           disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=3e-2, batch_size=2,
           sdp_iters=100, sdp_iter_boost_max=1, max_refines=1, dtype="float64",
           time_limit=60, verbosity=0)


def _run(**kw):
    A, idx = generate_matrix_completion_data(1, 6, 6, 20, seed=0)
    return matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **_KW, **kw)


def test_profile_trace_written_and_stopped_after_profile_steps(tmp_path):
    """profile_steps=1: the trace covers omc's count of super-steps (it
    stops once the count passes 1, so after two), while the run goes on;
    the file holds the solver's events; the objective and the bounds are
    the unprofiled run's."""
    sol0, _, inst0 = _run()
    out = tmp_path / "prof"
    sol, _, inst = _run(profile_dir=str(out), profile_steps=1)
    rd = inst["run_details"]
    assert rd["device_steps"] > 2, rd["device_steps"]
    assert inst["run_log"][-1]["gap"] <= 3e-2
    assert rd["profile_super_steps"] == 2
    files = glob.glob(str(out / "*.json"))
    assert files == [rd["profile_trace"]]
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {ev.get("name", "") for ev in events}
    assert len(events) > 100
    assert any(nm.startswith("aten::") for nm in names)
    assert any("linalg_eigh" in nm for nm in names)  # the CPU path's exact projection
    assert sol["objective"] == sol0["objective"]
    assert [r["lower"] for r in inst["run_log"]] == [r["lower"] for r in inst0["run_log"]]
    assert rd["device_steps"] == inst0["run_details"]["device_steps"]


def test_profile_stops_at_the_end(tmp_path):
    """A run of fewer super-steps than profile_steps: the trace stops at
    the end (omc's forced stop), into a directory it creates."""
    out = os.path.join(str(tmp_path), "a", "b")
    sol, _, inst = _run(profile_dir=out, profile_steps=3, root_only=True)
    rd = inst["run_details"]
    assert rd["device_steps"] == 1 and rd["profile_super_steps"] == 1
    assert os.path.isfile(rd["profile_trace"]) and os.path.dirname(rd["profile_trace"]) == out
    assert np.isfinite(sol["objective"])
