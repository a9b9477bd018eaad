"""Parity of the port's host-side modules with omc: instance data
(bit-identical), configuration, cuts, tree, branching, oracles, logging,
public names; the entry points' device default."""

import dataclasses

import numpy as np
import pytest
import torch

import omc.branch as jbranch
import omc.config as jconfig
import omc.data as jdata
import omc.problem as jproblem
import omc.sdp.cuts as jcuts
import omc.tree as jtree
import omc.utils.logging as jlog

import omc_torch.branch as tbranch
import omc_torch.config as tconfig
import omc_torch.data as tdata
import omc_torch.problem as tproblem
import omc_torch.sdp.cuts as tcuts
import omc_torch.tree as ttree
import omc_torch.utils.logging as tlog

torch.set_num_threads(2)

_MAIN = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec")


@pytest.mark.parametrize("args", [
    (1, 50, 50, 1250, 0), (2, 10, 14, 70, 6),
    (3, 20, 30, 180, 11),  # sparse regime
])
def test_data_bit_identical(args):
    A_j, idx_j = jdata.generate_matrix_completion_data(*args)
    A_t, idx_t = tdata.generate_matrix_completion_data(*args)
    assert np.array_equal(A_j, A_t)
    assert np.array_equal(idx_j, idx_t)
    n, m = args[1], args[2]
    assert np.array_equal(jdata.generate_masked_bitmatrix(n, m, 40, 5),
                          tdata.generate_masked_bitmatrix(n, m, 40, 5))
    assert np.array_equal(jdata.generate_sparse_masked_bitmatrix(n, m, 40, 5),
                          tdata.generate_sparse_masked_bitmatrix(n, m, 40, 5))


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.SolverConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.SolverConfig)}
    # the port drops the per-call duration caps
    assert set(jf) - set(tf) == {"sdp_max_call_seconds", "sdp_first_call_iters"}
    assert set(tf) <= set(jf)
    for name, default in tf.items():
        assert default == jf[name], name
    kw = dict(_MAIN, gap=1e-3, altmin_flag=False)
    assert (tconfig.SolverConfig(**kw).run_details_params()
            == jconfig.SolverConfig(**kw).run_details_params())


@pytest.mark.parametrize("kw", [
    dict(disjunctive_cuts_type="bogus"),
    dict(node_selection="bogus"),
    dict(max_altmin_probability=2.0),
    dict(sdp_method="bogus"),
])
def test_config_invalid_values_raise_like_omc(kw):
    full = {**_MAIN, **kw}
    with pytest.raises(ValueError):
        jconfig.SolverConfig(**full)
    with pytest.raises(ValueError):
        tconfig.SolverConfig(**full)


@pytest.mark.parametrize("kw", [
    dict(add_Shor_valid_inequalities=True),
    dict(add_Shor_valid_inequalities=True, add_Shor_valid_inequalities_iterative=True,
         add_Shor_valid_inequalities_fraction=0.5, node_selection="breadthfirst"),
    dict(node_selection="breadthfirst"),
    dict(disjunctive_cuts_type="linear2"),
    dict(disjunctive_cuts_type="linear3"),
    dict(disjunctive_cuts_breakpoints="smallest_2_eigvec"),
    dict(node_selection="depthfirst"),
    dict(node_selection="bestfirst_depthfirst", bestfirst_depthfirst_cutoff=50),
    dict(use_disjunctive_cuts=False),
    dict(use_disjunctive_cuts=False, node_selection="breadthfirst", altmin_flag=False),
    dict(checkpoint_path="ckpt.pkl"),
    dict(checkpoint_path="ckpt.pkl", resume=True, checkpoint_every=5),
    dict(distributed=True, dist_rebalance_every=2),
    dict(distributed=True, dist_migrate_state=False),
    dict(mesh_shape=(2,)),
    dict(profile_dir="trace"),
    dict(sdp_halpern=True),
    dict(sdp_method="pdhg", sdp_omega=2.0),
])
def test_ported_options_configure_like_omc(kw):
    full = {**_MAIN, **kw}
    assert (tconfig.SolverConfig(**full).run_details_params()
            == jconfig.SolverConfig(**full).run_details_params())


def test_shor_with_k_above_one_runs_like_omc():
    """k = 2 with static Shor minors, one root visit: the same run details
    and the same certified root bound as omc (float64, eigh)."""
    from omc.solve import matrix_completion_branchandbound as omc_bnb
    from omc_torch.solve import matrix_completion_branchandbound

    A, idx = tdata.generate_matrix_completion_data(2, 6, 6, 24, 0)
    kw = dict(_MAIN, add_Shor_valid_inequalities=True,
              Shor_valid_inequalities_noisy_rank1_num_entries_present=[4, 3],
              root_only=True, batch_size=4, sdp_iters=400, sdp_iter_boost_max=1,
              dtype="float64", verbosity=0)
    sol, _, inst = matrix_completion_branchandbound(2, A, idx, 10.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(2, A, idx, 10.0, **kw)
    rd, rd_j = inst["run_details"], inst_j["run_details"]
    for key in tconfig.SolverConfig(**kw).run_details_params():
        assert rd[key] == rd_j[key], key
    assert rd["shor_minors_max"] > 0
    lb, lb_j = inst["run_log"][-1]["lower"], inst_j["run_log"][-1]["lower"]
    assert abs(lb - lb_j) <= 1e-6 * (1.0 + abs(lb_j)), (lb, lb_j)
    assert sol["objective"] == sol_j["objective"]


def test_rank2_config3_options_end_to_end_like_omc():
    """BASELINE config 3's driver options (linear3 cuts, smallest_2_eigvec,
    best-first/depth-first) at rank 2 on an 8x8 instance: the incumbents
    agree within the two runs' gaps, lower bounds are monotone, rank <= 2,
    and a split makes 4^k = 16 children."""
    from omc.solve import matrix_completion_branchandbound as omc_bnb
    from omc_torch.solve import matrix_completion_branchandbound

    A, idx = tdata.generate_matrix_completion_data(2, 8, 8, 40, 1)
    kw = dict(node_selection="bestfirst_depthfirst", bestfirst_depthfirst_cutoff=10,
              disjunctive_cuts_type="linear3", disjunctive_cuts_breakpoints="smallest_2_eigvec",
              gap=1e-2, batch_size=8, sdp_iters=600, dtype="float64", time_limit=15,
              verbosity=0)
    sol, _, inst = matrix_completion_branchandbound(2, A, idx, 20.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(2, A, idx, 20.0, **kw)
    gap, gap_j = inst["run_log"][-1]["gap"], inst_j["run_log"][-1]["gap"]
    obj, obj_j = sol["objective"], sol_j["objective"]
    assert abs(obj - obj_j) <= (gap + gap_j) * max(1.0, abs(obj_j)), (obj, obj_j, gap, gap_j)
    lowers = [r["lower"] for r in inst["run_log"] if np.isfinite(r["lower"])]
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    assert lowers[-1] <= obj_j * (1.0 + 1e-9)
    assert np.linalg.matrix_rank(sol["X"], tol=1e-6) <= 2
    rd = inst["run_details"]
    assert (rd["nodes_total"] - 1) % tcuts.N_PIECES["linear3"] ** 2 == 0, rd["nodes_total"]
    assert tcuts.N_PIECES["linear3"] == 4
    assert rd["disjunctive_cuts_type"] == "linear3"


def _device_helpers():
    from omc_torch import convert
    from omc_torch.sdp import admm, admm_shor, mccormick, shor_k

    return {
        "init_admm_state": lambda **kw: admm.init_admm_state(1, 3, 3, 1, 8, **kw),
        "init_mc_state": lambda **kw: mccormick.init_mc_state(1, 3, 3, 2, **kw),
        "init_shor_state": lambda **kw: admm_shor.init_shor_state(1, 3, 3, 1, 8, 4, 9, **kw),
        "init_shor_k_state": lambda **kw: shor_k.init_shor_k_state(1, 3, 3, 2, 8, 4, 9, **kw),
        "shor_batch_to_device": lambda **kw: admm_shor.shor_batch_to_device(
            None, torch.float32, **kw),
        "shor_k_batch_to_device": lambda **kw: shor_k.shor_k_batch_to_device(
            None, torch.float32, **kw),
        **{name: (lambda name: lambda **kw: getattr(convert, name)([], **kw))(name)
           for name in ("node_batch_from_numpy", "admm_state_from_numpy",
                        "shor_batch_from_numpy", "shor_state_from_numpy",
                        "shor_k_batch_from_numpy", "shor_k_state_from_numpy",
                        "mc_batch_from_numpy", "mc_state_from_numpy")},
    }


@pytest.mark.parametrize("name", sorted(_device_helpers()))
def test_helpers_that_allocate_require_a_device(name):
    """No public helper of the port chooses the CPU by itself: called
    without ``device`` it raises TypeError before doing anything."""
    with pytest.raises(TypeError, match="device"):
        _device_helpers()[name]()


def _entry_calls():
    import omc_torch.api as tapi
    from omc_torch.solve import matrix_completion_branchandbound

    A, idx = tdata.generate_matrix_completion_data(1, 5, 5, 15, 0)
    lo, hi = ttree.root_box(5, 1)
    node = ttree.BBNode(1, 0, lo, hi, -np.inf, 0, cuts=None)
    return {
        "matrix_completion_branchandbound": lambda: matrix_completion_branchandbound(
            1, A, idx, 20.0, **_MAIN),
        "matrix_completion_SDP_relaxation": lambda: tapi.matrix_completion_SDP_relaxation(
            node, 5, 1, A, idx, 20.0, use_disjunctive_cuts=False, dtype="float32"),
        "alternating_minimization": lambda: tapi.alternating_minimization(
            A, 5, 1, idx, 20.0, U_initial=np.ones((5, 1)) / np.sqrt(5.0), dtype="float32"),
    }


@pytest.mark.parametrize("name", sorted(_entry_calls()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """The entry points run on the GPU unless the caller asks for the CPU:
    without a GPU, a call that names no device raises before any solver or
    heuristic is built, so it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    import omc_torch.altmin
    import omc_torch.sdp.admm
    import omc_torch.sdp.mccormick
    import omc_torch.solve

    def ran(*a, **kw):
        raise AssertionError("ran on the CPU without being asked to")

    for mod, attr in ((omc_torch.solve, "make_altmin"), (omc_torch.altmin, "make_altmin"),
                      (omc_torch.sdp.mccormick, "make_mccormick_solver"),
                      (omc_torch.sdp.admm, "make_admm_solver")):
        monkeypatch.setattr(mod, attr, ran)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_calls()[name]()


def test_public_names_cover_omcs():
    import omc
    import omc_torch

    assert set(omc.__all__) <= set(omc_torch.__all__)
    for name in omc.__all__:
        assert getattr(omc_torch, name) is not None, name
    assert omc_torch.BBNodeDisjunctiveCuts is omc_torch.DisjunctiveCut
    assert omc_torch.BBNodeShorInfo is omc_torch.ShorInfo


def test_breadthfirst_end_to_end_like_omc():
    """The base path under breadth-first selection on the 12x12 instance of
    tests/test_e2e.py, against omc's same call."""
    from omc.solve import matrix_completion_branchandbound as omc_bnb
    from omc_torch.solve import matrix_completion_branchandbound

    A, idx = tdata.generate_matrix_completion_data(1, 12, 12, 72, seed=3)
    kw = dict(_MAIN, node_selection="breadthfirst", gap=1e-2, batch_size=4,
              sdp_iters=1500, sdp_rho=0.03, dtype="float64", time_limit=60, verbosity=0)
    sol, _, inst = matrix_completion_branchandbound(1, A, idx, 80.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 80.0, **kw)
    gap, gap_j = inst["run_log"][-1]["gap"], inst_j["run_log"][-1]["gap"]
    assert gap <= 1e-2
    assert inst["run_details"]["node_selection"] == "breadthfirst"
    assert abs(sol["objective"] - sol_j["objective"]) <= (gap + gap_j) * max(
        1.0, abs(sol_j["objective"]))


@pytest.mark.parametrize("cuts_type", ["linear", "linear2", "linear3"])
def test_region_bounds_match(cuts_type):
    rng = np.random.default_rng(0)
    vhat = rng.uniform(-1, 1, (6, 3))
    code = rng.integers(0, tcuts.N_PIECES[cuts_type], (6, 3))
    for a, b in zip(tcuts.region_bounds(cuts_type, code, vhat),
                    jcuts.region_bounds(cuts_type, code, vhat)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("k", [1, 2])
def test_children_match_on_same_cut(k):
    rng = np.random.default_rng(k)
    n = 9
    sep_V = np.linalg.qr(rng.standard_normal((n, 2)))[0]
    sep_w = np.array([-0.3, -0.1])
    U_relax = rng.standard_normal((n, k))
    lo, hi = ttree.root_box(n, k)
    assert all(np.array_equal(a, b) for a, b in zip((lo, hi), jtree.root_box(n, k)))
    old_cut = dict(x=np.ones(n) / 3.0, vhat=np.zeros(k), code=np.zeros(k, np.int32))
    kids = []
    for tree_mod, branch_mod in ((jtree, jbranch), (ttree, tbranch)):
        parent = tree_mod.BBNode(node_id=4, parent_id=1, U_lower=lo, U_upper=hi,
                                 LB=2.5, depth=2,
                                 cuts=[tree_mod.DisjunctiveCut(**old_cut)])
        kids.append(branch_mod.create_matrix_cut_child_nodes(
            parent, "linear", "smallest_1_eigvec", sep_w=sep_w, sep_V=sep_V,
            U_relax=U_relax, counter=7, objective_relax=2.75))
    assert len(kids[0]) == len(kids[1]) == 2**k
    for cj, ct in zip(*kids):
        assert (cj.node_id, cj.parent_id, cj.depth, cj.LB) == (
            ct.node_id, ct.parent_id, ct.depth, ct.LB)
        assert len(cj.cuts) == len(ct.cuts) == 2
        for a, b in zip(cj.cuts, ct.cuts):
            assert np.array_equal(a.x, b.x)
            assert np.array_equal(a.vhat, b.vhat)
            assert np.array_equal(a.code, b.code)


def test_tree_bestfirst_sequence_matches():
    out = []
    for mod in (jtree, ttree):
        lo, hi = mod.root_box(4, 1)
        t = mod.BBTree(mod.BBNode(1, 0, lo, hi, -np.inf, 0, cuts=[]), 10.0)
        popped = [nd.node_id for nd in t.retrieve_batch("bestfirst", 4)]
        kids = [mod.BBNode(i, 1, lo, hi, 1.0 + 0.1 * i, 1, cuts=[]) for i in range(2, 8)]
        t.add_nodes(kids[:3], 3.0)
        t.add_nodes(kids[3:], 2.0)
        t.requeue(kids[0], 1.5)
        t.best_upper_bound = 2.5
        pr = t.prune_dominated()
        t.update_lower_bound()
        popped += [nd.node_id for nd in t.retrieve_batch("bestfirst", 3)]
        out.append((popped, pr, t.best_lower_bound, t.nodes_explored,
                    t.refinement_visits, t.counter,
                    mod.compute_gap(t.best_lower_bound, 2.5)))
    assert out[0] == out[1]


def test_problem_oracles_match():
    rng = np.random.default_rng(3)
    A, idx = tdata.generate_matrix_completion_data(1, 8, 9, 40, 2)
    X = rng.standard_normal((8, 9))
    U = rng.standard_normal((8, 1))
    Th = rng.standard_normal((9, 9))
    W = rng.standard_normal((8, 9))
    pairs = [
        (tproblem.evaluate_objective(X, A, idx, U, 7.0),
         jproblem.evaluate_objective(X, A, idx, U, 7.0)),
        (tproblem.compute_SDP_relaxation_objective(X, None, Th, U, A, idx, 7.0),
         jproblem.compute_SDP_relaxation_objective(X, None, Th, U, A, idx, 7.0)),
        (tproblem.compute_SDP_relaxation_objective(
            X, None, Th, U, A, idx, 7.0, add_Shor_valid_inequalities=True, W=W),
         jproblem.compute_SDP_relaxation_objective(
            X, None, Th, U, A, idx, 7.0, add_Shor_valid_inequalities=True, W=W)),
    ]
    pairs += [(tproblem.compute_MSE(X, A, idx, kind=kind),
               jproblem.compute_MSE(X, A, idx, kind=kind))
              for kind in ("in", "out", "all")]
    for a, b in pairs:
        assert abs(float(a) - float(b)) <= 1e-12 * max(1.0, abs(float(b)))


def test_logging_rows_identical():
    lo, hi = ttree.root_box(3, 1)
    t = ttree.BBTree(ttree.BBNode(1, 0, lo, hi, -np.inf, 0, cuts=[]), 4.0)
    t.best_lower_bound, t.now_gap = 3.5, 4.0 / 3.5 - 1.0
    assert tlog.update_row(t, 1.25, altmin_flag=True) == jlog.update_row(
        t, 1.25, altmin_flag=True)
    assert tlog.UPDATE_HEADER == jlog.UPDATE_HEADER
    pl_t, pl_j = [], []
    for mod, pl in ((tlog, pl_t), (jlog, pl_j)):
        mod.alternating_minimization_printout(pl, 5, 0.5, True, 7, 100, 0.1,
                                              [3.0, 2.0, 1.5], 2)
    assert pl_t == pl_j


def test_driver_helpers_match_omc():
    import omc.solve as jsolve

    import omc_torch.solve as tsolve
    from omc_torch import convert

    for need in (1, 8, 9, 33, 129, 600):
        assert tsolve._l_bucket(need) == jsolve._l_bucket(need)
        for B in (1, 8, 64):
            assert tsolve._b_bucket(min(need, B), B) == jsolve._b_bucket(min(need, B), B)
    for depth in (0, 3, 60):
        assert tsolve._decayed_probability(depth, 1.0, 0.005, 1.1) == \
            jsolve._decayed_probability(depth, 1.0, 0.005, 1.1)
    A, idx = tdata.generate_matrix_completion_data(1, 10, 12, 70, 4)
    mask = idx.astype(np.float64)
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((10, 1)) @ rng.standard_normal((1, 12))
    for fn in ("_polish_incumbent", "_round_to_incumbent"):
        arg = X0 if fn == "_polish_incumbent" else X0 @ X0.T
        a = getattr(tsolve, fn)(arg, A, mask, 20.0, 1)
        b = getattr(jsolve, fn)(arg, A, mask, 20.0, 1)
        assert a[0] == b[0]
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    # two nodes with cuts: packed batches and interval arrays are identical
    lo, hi = ttree.root_box(10, 1)
    cut = dict(x=np.ones(10) / np.sqrt(10.0), vhat=np.array([0.2]),
               code=np.array([1], np.int32))
    nodes_t = [ttree.BBNode(2, 1, lo, hi, 1.0, 1, cuts=[ttree.DisjunctiveCut(**cut)]),
               ttree.BBNode(3, 1, lo, hi, 1.0, 1, cuts=[])]
    nodes_j = [jtree.BBNode(2, 1, lo, hi, 1.0, 1, cuts=[jtree.DisjunctiveCut(**cut)]),
               jtree.BBNode(3, 1, lo, hi, 1.0, 1, cuts=[])]
    bt = tsolve._pack_batch(nodes_t, 4, 8, 10, 1, "linear", np.float32)
    bj = jsolve._pack_batch(nodes_j, 4, 8, 10, 1, "linear", np.float32)
    for a, b in zip(convert.node_batch_to_numpy(bt), bj):
        assert np.array_equal(a, np.asarray(b))
    tb = convert.node_batch_from_numpy(convert.node_batch_to_numpy(bt), dtype=torch.float32, device="cpu")
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(tb.fields(), bt.fields()))
    for a, b in zip(tsolve._cut_interval_arrays(nodes_t[0].cuts, "linear", 10, 1),
                    jsolve._cut_interval_arrays(nodes_j[0].cuts, "linear", 10, 1)):
        assert np.array_equal(a, b)
