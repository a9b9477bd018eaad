"""The port's multi-process frontier (``omc_torch.parallel.dist``) against
``omc.parallel.dist``: the node wire format in both directions, the round
sync and the rebalancing deal on the same gathered inputs, the driver's
``distributed=True`` in a world of one, and two-rank gloo runs of
``python -m omc_torch.parallel.worker`` on the CPU."""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import omc.parallel.dist as J
import omc.tree as JT
from omc.sdp.shor import shor_soc_complement as j_soc

import omc_torch.parallel.dist as P
import omc_torch.solve as S
import omc_torch.tree as PT
from omc_torch.data import generate_matrix_completion_data
from omc_torch.solve import matrix_completion_branchandbound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


# ---- the wire round trips of tests/test_distributed.py, on the port ----


def test_node_wire_roundtrip():
    rng = np.random.default_rng(0)
    n, k, Lmax = 7, 2, 3
    lo, hi = PT.root_box(n, k)
    cuts = [
        PT.DisjunctiveCut(
            x=rng.standard_normal(n), vhat=rng.standard_normal(k),
            code=np.asarray(rng.integers(0, 2, k), np.int32),
        )
        for _ in range(2)
    ]
    node = PT.BBNode(
        node_id=17, parent_id=4, U_lower=lo, U_upper=hi, LB=1.25, depth=2,
        master_feasible=True, cuts=cuts, refines=3, lb_solver=1.2,
    )
    vec = P.serialize_node(node, prio_lb=1.1, n=n, k=k, Lmax=Lmax)
    assert vec.shape == (P.node_wire_size(n, k, Lmax),)
    prio, back, _ = P.deserialize_node(vec, n, k, Lmax, node_id=99)
    assert prio == 1.1
    assert back.node_id == 99
    assert back.LB == node.LB and back.depth == 2 and back.refines == 3
    assert back.master_feasible
    np.testing.assert_array_equal(back.U_lower, node.U_lower)
    np.testing.assert_array_equal(back.U_upper, node.U_upper)
    assert len(back.cuts) == 2
    for a, b in zip(back.cuts, cuts):
        np.testing.assert_allclose(a.x, b.x)
        np.testing.assert_allclose(a.vhat, b.vhat)
        np.testing.assert_array_equal(a.code, b.code)


def test_node_wire_roundtrip_shor():
    from omc_torch.sdp.shor import shor_soc_complement

    rng = np.random.default_rng(1)
    n, k, Lmax, Mmax, m = 6, 1, 2, 5, 8
    lo, hi = PT.root_box(n, k)
    minors = [(0, 2, 1, 3), (1, 4, 0, 5)]
    node = PT.BBNode(
        node_id=3, parent_id=1, U_lower=lo, U_upper=hi, LB=0.5, depth=1,
        cuts=[PT.DisjunctiveCut(
            x=rng.standard_normal(n), vhat=rng.standard_normal(k),
            code=np.asarray([1], np.int32),
        )],
        Shor_info=PT.ShorInfo(
            constraints_indexes=minors,
            SOC_constraints_indexes=shor_soc_complement(n, m, minors),
        ),
    )
    vec = P.serialize_node(node, prio_lb=0.4, n=n, k=k, Lmax=Lmax, Mmax=Mmax)
    assert vec.shape == (P.node_wire_size(n, k, Lmax, Mmax),)
    prio, back, _ = P.deserialize_node(vec, n, k, Lmax, node_id=9, Mmax=Mmax, m=m)
    assert back.Shor_info is not None
    assert back.Shor_info.constraints_indexes == minors
    assert back.Shor_info.SOC_constraints_indexes == shor_soc_complement(n, m, minors)
    # a Shor-less node on the same wire capacity round-trips to None
    node2 = PT.BBNode(
        node_id=4, parent_id=1, U_lower=lo, U_upper=hi, LB=0.5, depth=1, cuts=[],
    )
    vec2 = P.serialize_node(node2, prio_lb=0.4, n=n, k=k, Lmax=Lmax, Mmax=Mmax)
    _, back2, _ = P.deserialize_node(vec2, n, k, Lmax, node_id=10, Mmax=Mmax, m=m)
    assert back2.Shor_info is None


def test_node_wire_roundtrip_warm_state():
    """A node's float32 solver-state slice travels on the wire, including the
    leading-axis refit across cut-capacity buckets."""
    rng = np.random.default_rng(2)
    n, k, Lmax = 5, 1, 2
    lo, hi = PT.root_box(n, k)
    node = PT.BBNode(
        node_id=6, parent_id=2, U_lower=lo, U_upper=hi, LB=0.7, depth=1, cuts=[], refines=2,
    )
    spec = [(n, n), (4, k), (1,)]
    leaves = [
        rng.standard_normal((n, n)).astype(np.float32),
        rng.standard_normal((2, k)).astype(np.float32),  # smaller L bucket
        np.asarray([3.5], np.float32),
    ]
    vec = P.serialize_node(node, prio_lb=0.6, n=n, k=k, Lmax=Lmax, state=leaves, state_spec=spec)
    assert vec.shape == (P.node_wire_size(n, k, Lmax, 0, spec),)
    _, back, st = P.deserialize_node(vec, n, k, Lmax, node_id=11, state_spec=spec)
    assert st is not None and len(st) == 3
    np.testing.assert_allclose(st[0], leaves[0], rtol=1e-6)
    np.testing.assert_allclose(st[1][:2], leaves[1], rtol=1e-6)
    np.testing.assert_allclose(st[1][2:], 0.0)  # zero-padded rows
    np.testing.assert_allclose(st[2], leaves[2])
    vec2 = P.serialize_node(node, prio_lb=0.6, n=n, k=k, Lmax=Lmax, state=None, state_spec=spec)
    _, _, st2 = P.deserialize_node(vec2, n, k, Lmax, node_id=12, state_spec=spec)
    assert st2 is None


# ---- the wire across the two packages ----

N, M, K, LMAX, MMAX = 6, 8, 2, 3, 4
SPEC = [(N, N), (2, K), (1,)]


def _node(pkg, kind, rng, node_id=5):
    """A node of ``pkg`` (omc.tree or omc_torch.tree): "base" (two cuts),
    "shor" (one cut, three minors) or "mccormick" (no cuts: ``cuts=None``)."""
    lo = -rng.uniform(0.1, 1.0, (N, K))
    hi = rng.uniform(0.1, 1.0, (N, K))
    cuts = None
    if kind != "mccormick":
        cuts = [pkg.DisjunctiveCut(x=rng.standard_normal(N), vhat=rng.standard_normal(K),
                                   code=np.asarray(rng.integers(0, 3, K), np.int32))
                for _ in range(2 if kind == "base" else 1)]
    shor = None
    if kind == "shor":
        minors = [(0, 2, 1, 3), (1, 4, 0, 5), (2, 5, 6, 7)]
        shor = pkg.ShorInfo(constraints_indexes=minors,
                            SOC_constraints_indexes=j_soc(N, M, minors))
    return pkg.BBNode(node_id=node_id, parent_id=2, U_lower=lo, U_upper=hi,
                      LB=float(rng.normal()), depth=int(rng.integers(1, 9)),
                      master_feasible=bool(rng.integers(0, 2)), cuts=cuts,
                      refines=int(rng.integers(0, 5)), lb_solver=float(rng.normal()),
                      Shor_info=shor)


def _same_node(a, b):
    assert (a.node_id, a.parent_id, a.LB, a.depth, a.master_feasible, a.refines,
            a.lb_solver) == (b.node_id, b.parent_id, b.LB, b.depth, b.master_feasible,
                             b.refines, b.lb_solver)
    np.testing.assert_array_equal(a.U_lower, b.U_lower)
    np.testing.assert_array_equal(a.U_upper, b.U_upper)
    assert (a.cuts is None) == (b.cuts is None)
    assert len(a.cuts or []) == len(b.cuts or [])
    for x, y in zip(a.cuts or [], b.cuts or []):
        np.testing.assert_array_equal(x.x, y.x)
        np.testing.assert_array_equal(x.vhat, y.vhat)
        np.testing.assert_array_equal(x.code, y.code)
        assert x.code.dtype == y.code.dtype
    assert (a.Shor_info is None) == (b.Shor_info is None)
    if a.Shor_info is not None:
        assert a.Shor_info.constraints_indexes == b.Shor_info.constraints_indexes
        assert a.Shor_info.SOC_constraints_indexes == b.Shor_info.SOC_constraints_indexes


@pytest.mark.parametrize("kind", ["base", "shor", "mccormick"])
@pytest.mark.parametrize("direction", ["torch_to_omc", "omc_to_torch"])
def test_wire_crosses_packages(kind, direction):
    """A node serialised by one package deserialises in the other to the
    same node (header, box, cuts, minors and the SOC complement), and both
    packages write the same floats for it.  A McCormick node's ``cuts=None``
    travels as no cuts and comes back as ``[]`` in both."""
    src, dst = (P, J) if direction == "torch_to_omc" else (J, P)
    src_tree, dst_tree = (PT, JT) if direction == "torch_to_omc" else (JT, PT)
    rng = np.random.default_rng(7)
    node = _node(src_tree, kind, rng)
    state = [rng.standard_normal(s).astype(np.float32) for s in SPEC]
    vec = src.serialize_node(node, 0.25, N, K, LMAX, MMAX, state=state, state_spec=SPEC)
    twin = _node(dst_tree, kind, np.random.default_rng(7))
    np.testing.assert_array_equal(
        vec, dst.serialize_node(twin, 0.25, N, K, LMAX, MMAX, state=state, state_spec=SPEC))
    prio, back, st = dst.deserialize_node(vec, N, K, LMAX, node_id=41, Mmax=MMAX, m=M,
                                          state_spec=SPEC)
    p2, ref, st2 = src.deserialize_node(vec, N, K, LMAX, node_id=41, Mmax=MMAX, m=M,
                                        state_spec=SPEC)
    assert prio == p2 == 0.25
    assert isinstance(back, dst_tree.BBNode)
    _same_node(back, ref)
    assert back.cuts == [] if kind == "mccormick" else len(back.cuts) > 0
    for a, b in zip(st, st2):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32
    assert P.node_wire_size(N, K, LMAX, MMAX, SPEC) == J.node_wire_size(N, K, LMAX, MMAX, SPEC)
    assert P.state_spec_floats(SPEC) == J.state_spec_floats(SPEC)


# ---- sync_round, should_rebalance and rebalance on the same gathered inputs ----


def _contexts(P_hosts):
    """One (omc, port) DistContext pair per simulated host."""
    out = []
    for h in range(P_hosts):
        pair = (J.DistContext(rebalance_every=1), P.DistContext(rebalance_every=1))
        for c in pair:
            c.process_index, c.process_count = h, P_hosts
        out.append(pair)
    return out


def _trees(pkg, counts, kind, seed):
    """One tree a host with ``counts[h]`` queued nodes (ids from 2 up), the
    same nodes in both packages for the same seed."""
    rng = np.random.default_rng(seed)
    trees = []
    for h, c in enumerate(counts):
        root = _node(pkg, kind, rng, node_id=1)
        tree = pkg.BBTree(root, best_upper_bound=10.0)
        tree.nodes.clear()
        tree._heap_lb.clear()
        tree._fifo.clear()
        tree._heap.clear()
        nodes = [_node(pkg, kind, rng, node_id=2 + i) for i in range(c)]
        prios = [float(v) for v in rng.normal(size=c).round(1)]  # ties included
        (J if pkg is JT else P)._insert_migrated(tree, list(zip(prios, nodes)))
        tree.counter = 1 + c + 10 * h
        trees.append(tree)
    return trees


def _state_of(node_id):
    r = np.random.default_rng(node_id)
    return [r.standard_normal(s).astype(np.float32) for s in SPEC]


@pytest.mark.parametrize("hosts,counts", [(2, (9, 0)), (2, (12, 3)), (3, (11, 0, 2)),
                                          (3, (1, 0, 0))])
@pytest.mark.parametrize("kind", ["base", "shor", "mccormick"])
def test_sync_and_rebalance_match_omc(hosts, counts, kind):
    """Both packages' DistContexts fed the same stacked per-host vectors
    (``_allgather`` stubbed) give the same RoundStates, the same rebalancing
    decision, the same wire payloads and the same dealt nodes, with their
    warm-start states."""
    ctxs = _contexts(hosts)
    trees = {pkg: _trees(pkg, counts, kind, seed=3) for pkg in (JT, PT)}
    # ---- sync_round ----
    vecs = []
    for h in range(hosts):
        t = trees[PT][h]
        vecs.append(np.asarray([10.0 - 0.5 * h, min(t.min_queued_lb(), 1e300),
                                float(len(t)), 0.0,
                                float(max((len(nd.cuts or []) for nd in t.nodes.values()),
                                          default=0)),
                                float(max((len(nd.Shor_info.constraints_indexes)
                                           for nd in t.nodes.values()
                                           if nd.Shor_info is not None), default=0))]))
    stacked = np.stack(vecs)
    states = []
    for h, (cj, cp) in enumerate(ctxs):
        def gather(v, h=h):
            np.testing.assert_array_equal(v, vecs[h])
            return stacked

        cj._allgather = cp._allgather = gather
        t = trees[PT][h]
        args = (10.0 - 0.5 * h, t.min_queued_lb(), len(t), False,
                int(vecs[h][4]), int(vecs[h][5]))
        rj, rp = cj.sync_round(*args), cp.sync_round(*args)
        assert dataclasses_equal(rj, rp)
        assert cj.should_rebalance(rj) == cp.should_rebalance(rp)
        states.append((rj, rp))
    rs_j, rs_p = states[0]
    assert rs_j.total_nodes == sum(counts) and rs_p.global_ub == 9.5 - 0.5 * (hosts - 2)
    # ---- rebalance: each host's payload first, then the deal ----
    got = {}
    for pkg, idx in ((JT, 0), (PT, 1)):
        payloads, cnts = [], []
        for h in range(hosts):
            ctx = ctxs[h][idx]
            seen = []

            def record(v, seen=seen):
                seen.append(np.array(v))
                return np.zeros((hosts,) + np.shape(v))

            ctx._allgather = record
            ctx.rebalance(copy.deepcopy(trees[pkg][h]), states[h][idx], N, K, m=M,
                          state_spec=SPEC, state_get=_state_of)
            if seen:
                payloads.append(seen[0])
                cnts.append(seen[1])
        received = []
        for h in range(hosts):
            ctx = ctxs[h][idx]
            calls = iter([np.stack(payloads), np.stack(cnts)] if payloads else [])
            ctx._allgather = lambda v, calls=calls: next(calls)
            tree = trees[pkg][h]
            put = {}
            nrec = ctx.rebalance(tree, states[h][idx], N, K, m=M, state_spec=SPEC,
                                 state_get=_state_of, state_put=put.__setitem__)
            received.append((nrec, tree, put))
        got[pkg] = (payloads, received)
    pj, rj_ = got[JT]
    pp, rp_ = got[PT]
    assert len(pj) == len(pp)
    for a, b in zip(pj, pp):
        np.testing.assert_array_equal(a, b)
    moved = 0
    for h, ((nj, tj, putj), (np_, tp, putp)) in enumerate(zip(rj_, rp_)):
        assert nj == np_
        moved += nj
        assert tj.counter == tp.counter
        assert sorted(tj.nodes) == sorted(tp.nodes)
        assert tj._heap_lb == tp._heap_lb
        assert list(tj._fifo) == list(tp._fifo)
        for nid in tj.nodes:
            _same_node(tj.nodes[nid], tp.nodes[nid])
        assert sorted(putj) == sorted(putp)
        assert ctxs[h][1].states_installed == len(putp)
        assert ctxs[h][1].state_refit_leaves == 0
        for nid in putj:
            for a, b in zip(putj[nid], putp[nid]):
                np.testing.assert_array_equal(a, b)
    if states[0][0].counts.max() > int(np.ceil(sum(counts) / hosts)):
        assert moved > 0


@pytest.mark.parametrize("Lmax,Mmax", [(1, 1), (8, 64), (9, 65), (40, 300)])
@pytest.mark.parametrize("family,k", [("admm", 1), ("admm", 2), ("shor", 1), ("shor_k", 2),
                                      ("mccormick", 1), ("mccormick", 2)])
def test_wire_state_spec_matches_host_slices(family, k, Lmax, Mmax):
    """The driver's wire spec (a batch-of-one state on the meta device) has
    the leaf shapes of a node's host slice of a real batch state at the
    fused round's buckets, which packs onto it with no leaf refitted away.
    A slice from a solve at the smallest buckets packs as omc packs it:
    every leaf fits but, in the rank-k Shor family past the smallest minor
    bucket, the leaves whose minor axis is not the leading one (omc's
    layout too), which stay zero and are counted."""
    from omc_torch.sdp.relax import host_state_slice, state_to_host

    n, m = 6, 8
    shor = family in ("shor", "shor_k")
    spec = S.wire_state_spec(family, n, m, k, Lmax, Mmax, torch.float32)
    assert spec == S.wire_state_spec(family, n, m, k, Lmax, Mmax, torch.float32)
    buckets = [(S._l_bucket(Lmax), S._m5_bucket(Mmax) if shor else None), (8, 64 if shor else None)]
    for L, M5 in buckets:
        st = S.family_state(family, 3, n, m, k, L, M5, torch.float32, "cpu")
        sl = host_state_slice(state_to_host(st), 1)
        if (L, M5) == buckets[0]:
            assert [x.shape for x in sl] == spec
        vec, vec_j = np.zeros(P.state_spec_floats(spec)), np.zeros(J.state_spec_floats(spec))
        bad = P._pack_state(vec, 0, sl, spec)
        assert bad == J._pack_state(vec_j, 0, sl, spec)
        np.testing.assert_array_equal(vec, vec_j)
        misfit = sum(x.shape[1:] != s[1:] or x.ndim != len(s) for x, s in zip(sl, spec))
        assert bad == misfit
        if (L, M5) == buckets[0] or family != "shor_k" or M5 == buckets[0][1]:
            assert bad == 0
        assert vec[0] == 1.0
        back = P._unpack_state(vec, 0, spec)
        assert [x.shape for x in back] == spec


def dataclasses_equal(a, b):
    return (a.global_ub, a.global_lb, a.total_nodes, a.stop, a.Lmax, a.Mmax) == (
        b.global_ub, b.global_lb, b.total_nodes, b.stop, b.Lmax, b.Mmax
    ) and np.array_equal(a.counts, b.counts)


def test_world_of_one_without_a_group():
    """Without a process group the port's DistContext is a world of one, as
    omc's is under one jax process."""
    import torch.distributed as tdist

    assert not tdist.is_initialized()
    ctx = P.DistContext()
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    g = ctx._allgather(np.arange(3.0))
    assert g.shape == (1, 3) and g.dtype == np.float64
    rs = ctx.sync_round(5.0, 4.0, 3, False, 2)
    assert (rs.global_ub, rs.global_lb, rs.total_nodes, rs.Lmax) == (5.0, 4.0, 3, 2)
    assert not ctx.should_rebalance(rs)


# ---- the driver ----

_SMALL = dict(
    node_selection="bestfirst", disjunctive_cuts_type="linear",
    disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-2, batch_size=4,
    sdp_iters=600, dtype="float64", time_limit=150, verbosity=0,
)


def test_distributed_world_of_one_matches_single_process():
    """distributed=True with no process group gives the objective, gap and
    census of distributed=False on a 10 x 10 float64 CPU instance."""
    A, idx = generate_matrix_completion_data(1, 10, 10, 60, seed=2)
    # the root splits (no refinement visits, 200 iterations a visit): 5 nodes
    kw = dict(_SMALL, gap=2e-2, max_refines=0, sdp_iter_boost_max=1, sdp_iters=200,
              time_limit=60)
    s1, _, i1 = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **kw)
    s2, _, i2 = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu",
                                                 distributed=True, **kw)
    r1, r2 = i1["run_details"], i2["run_details"]
    assert r2["process_count"] == 1 and r2["process_index"] == 0
    assert s1["objective"] == s2["objective"]
    assert i1["run_log"][-1]["gap"] == i2["run_log"][-1]["gap"] <= 2e-2
    keys = [key for key in r1 if key.startswith("nodes_")] + ["refinement_visits"]
    assert {key: r1[key] for key in keys} == {key: r2[key] for key in keys}
    assert r2["census_global"]["nodes_explored"] == r1["nodes_explored"] > 1


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_ranks(*extra, timeout=180):
    """Two ranks of the port's worker on the CPU over gloo; their RESULTs."""
    env = {key: val for key, val in os.environ.items() if key != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "omc_torch.parallel.worker", "--coordinator",
           f"localhost:{_free_port()}", "--world", "2", "--timeout", "120", "--device", "cpu",
           *extra]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
            r = json.loads(line[len("RESULT "):])
            results[r["pid"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == {0, 1}
    r0, r1 = results[0], results[1]
    assert r0["process_count"] == r1["process_count"] == 2
    assert r0["objective"] == r1["objective"]
    assert r0["census_global"] == r1["census_global"]
    for key in ("nodes_explored", "refinement_visits"):
        assert r0["census_global"][key] == r0[f"{key}_local"] + r1[f"{key}_local"]
    assert r0["device"] == r1["device"] == "cpu"
    return results


def test_two_ranks_match_single_process():
    """Two gloo ranks on tests/dist_worker.py's instance certify the
    single-process objective within the gap."""
    res = _run_ranks()
    A, idx = generate_matrix_completion_data(1, 10, 10, 60, seed=2)
    sol, _, inst = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **_SMALL)
    gap = max(res[0]["gap"], res[1]["gap"], inst["run_log"][-1]["gap"])
    assert res[0]["gap"] <= 1e-2
    assert abs(res[0]["objective"] - sol["objective"]) <= gap * abs(sol["objective"])


def test_worker_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The worker's device is the card by default; without a GPU it raises
    before it joins a group, and on the card it loads the kernel library
    without building it."""
    from omc_torch import kernels
    from omc_torch.parallel import worker

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(kernels, "library", lambda **kw: calls.append(kw))
    argv = ["--coordinator", "localhost:1", "--rank", "0", "--world", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(P, "init_distributed", lambda *a, **kw: calls.append("init"))
    monkeypatch.setattr(S, "matrix_completion_branchandbound",
                        lambda *a, **kw: (_ for _ in ()).throw(_Stop(kw["device"])))
    with pytest.raises(_Stop, match="cuda"):
        worker.main(argv)
    assert calls == [{"build": False}, "init"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("family", ["base", "mccormick"])
def test_two_ranks_migrate_nodes(family):
    """With the root forced to split (one refinement visit a node, 100
    iterations a visit, 8 s) the frontier spreads: rank 1 starts empty and
    explores the nodes it received.  The migration is warm: nodes awaiting
    their refinement visit travel with their solver states, which are
    installed on arrival, and no leaf of any misses the wire's spec (the
    first rebalancing, in round 4, deals two such nodes).  McCormick nodes
    (``cuts=None``) arrive with ``cuts=[]``, as in omc, and the McCormick
    branch takes them."""
    extra = ()
    if family == "mccormick":
        extra = ("--set", "use_disjunctive_cuts=false", "--set", "disjunctive_cuts_type=null",
                 "--set", "disjunctive_cuts_breakpoints=null")
    res = _run_ranks(*extra, "--set", "max_refines=1", "--set", "sdp_iter_boost_max=1",
                     "--set", "sdp_iters=100", "--set", "time_limit=8")
    assert res[1]["nodes_explored_local"] > 0
    assert res[0]["nodes_explored_local"] > 0
    assert res[0]["lower_max"] <= res[0]["objective"]
    assert res[0]["state_refit_leaves"] == res[1]["state_refit_leaves"] == 0
    assert res[0]["states_installed"] + res[1]["states_installed"] > 0


@pytest.mark.slow
def test_two_ranks_match_omc_single_process():
    """Mirror of tests/test_distributed.py:66: the two-rank run of the port
    against omc's single-process run on the same instance."""
    from omc.solve import matrix_completion_branchandbound as j_solve

    res = _run_ranks(timeout=600)
    A, idx = generate_matrix_completion_data(1, 10, 10, 60, seed=2)
    sol, _, _ = j_solve(1, A, idx, 20.0, **_SMALL)
    assert res[0]["gap"] <= 1e-2 and res[1]["gap"] <= 1e-2
    assert res[0]["objective"] == pytest.approx(sol["objective"], rel=1e-2)


@pytest.mark.slow
def test_warm_migration_not_worse_than_cold():
    """Mirror of tests/test_distributed.py:226: warm migration certifies the
    same optimum as the cold-restart ablation without paying more
    refinement visits."""
    warm = _run_ranks(timeout=600)
    cold = _run_ranks("--mode", "coldmigrate", timeout=600)
    assert warm[0]["objective"] == pytest.approx(cold[0]["objective"], rel=1e-6)
    assert warm[0]["gap"] <= 1e-2 and cold[0]["gap"] <= 1e-2
    assert warm[0]["refinement_visits_global"] <= cold[0]["refinement_visits_global"]
    # the ablation ships no state; neither run refits a leaf
    assert cold[0]["states_installed"] == cold[1]["states_installed"] == 0
    assert all(r["state_refit_leaves"] == 0 for r in (*warm.values(), *cold.values()))


@pytest.mark.slow
def test_two_ranks_iterative_shor():
    """Mirror of tests/test_distributed.py:244: iterative Shor minors; both
    ranks certify the same optimum."""
    res = _run_ranks("--mode", "shor", timeout=600)
    assert res[0]["gap"] <= 1e-2 and res[1]["gap"] <= 1e-2
