"""Parity of the port's rank-1 Shor path (omc_torch.sdp.shor, shor_encode,
admm_shor, ops.cones.project_rsoc, ops.polar.project_psd_ns_small) with
omc on the same numpy-seeded inputs, and the Shor branch-and-bound end to
end against omc's same call.

In float64 both packages project with eigh, so the iterates agree to
rounding; in float32 the sign schedule is held to omc's own bar (within
1e-4 of the exact projection)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.ops import cones as jcones
from omc.ops import polar as jpolar
from omc.sdp import admm_shor as jshor
from omc.sdp import relax as jrelax
from omc.sdp import shor as jshor_idx
from omc.sdp import shor_encode as jenc
from omc.solve import matrix_completion_branchandbound as omc_bnb
from omc.tree import root_box

import omc_torch.solve as tsolve
from omc_torch import convert
from omc_torch.ops import cones as tcones
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import admm_shor as tshor
from omc_torch.sdp import relax as trelax
from omc_torch.sdp import shor as tshor_idx
from omc_torch.sdp import shor_encode as tenc

torch.set_num_threads(2)

N = M = 6
K = 1
B = 2
L = 4
M5 = 16
GAMMA = 20.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _mask(seed, n=7, m=9, frac=0.55):
    return np.random.default_rng(seed).random((n, m)) < frac


@pytest.mark.parametrize("nums", [[4], [3], [2], [1], [0], [1, 2, 3, 4]])
def test_minor_enumeration_bit_identical(nums):
    idx = _mask(len(nums) + nums[0])
    a = tshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, nums)
    b = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, nums)
    assert a == b and len(a) > 0


@pytest.mark.parametrize("terms", [0, 2])
def test_violated_minor_scoring_and_soc_complement_bit_identical(terms):
    idx = _mask(3)
    rng = np.random.default_rng(terms)
    X = rng.standard_normal(((terms,) if terms else ()) + idx.shape)
    existing = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])[:5]
    a = tshor_idx.generate_violated_Shor_minors(X, idx, [3, 4], existing, 20)
    b = jshor_idx.generate_violated_Shor_minors(X, idx, [3, 4], existing, 20)
    assert a == b and len(a) == 20
    minors = [mm for _, mm in a]
    assert tshor_idx.shor_soc_complement(7, 9, minors) == jshor_idx.shor_soc_complement(
        7, 9, minors)


def _node_minors(idx):
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
    return [allm[:12], allm[5:14:2], []]


def test_pack_shor_batch_fields_and_inverse_tables():
    n, m = 7, 9
    minors = _node_minors(_mask(5))
    socs = [jshor_idx.shor_soc_complement(n, m, mm) for mm in minors]
    a = tenc.pack_shor_batch(n, m, minors, socs, 16, n * m)
    b = jenc.pack_shor_batch(n, m, minors, socs, 16, n * m)
    for x, y in zip(a.omc_leaves(), b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the inverse tables sum exactly what the forward scatter adds
    rng = np.random.default_rng(0)
    for b_ in range(len(minors)):
        vals = rng.standard_normal((16, 4))
        dense = np.zeros(n * m)
        mi = a.minor_idx[b_].astype(np.int64)
        flats = np.stack([mi[:, 0] * m + mi[:, 2], mi[:, 0] * m + mi[:, 3],
                          mi[:, 1] * m + mi[:, 2], mi[:, 1] * m + mi[:, 3]], 1)
        np.add.at(dense, flats, vals * a.minor_mask[b_][:, None])
        ptr, ent = a.xw_ptr[b_], a.xw_ent[b_]
        via = np.array([vals.reshape(-1)[ent[ptr[f]:ptr[f + 1]]].sum() for f in range(n * m)])
        assert np.allclose(via, dense, rtol=0, atol=1e-12)
        for name, ia, ib in (("v1", "iv1a", "iv1b"), ("v2", "iv2a", "iv2b")):
            v = rng.standard_normal((16, 2))
            P = getattr(a, f"cnt_{name}").shape[1]
            dense = np.zeros(P)
            np.add.at(dense, getattr(a, ia)[b_], v[:, 0] * a.minor_mask[b_])
            np.add.at(dense, getattr(a, ib)[b_], v[:, 1] * a.minor_mask[b_])
            ptr, ent = getattr(a, f"{name}_ptr")[b_], getattr(a, f"{name}_ent")[b_]
            via = np.array([v.reshape(-1)[ent[ptr[p]:ptr[p + 1]]].sum() for p in range(P)])
            assert np.allclose(via, dense, rtol=0, atol=1e-12)
        assert a.v3_ptr[b_][-1] == len(minors[b_])
    # omc's 14 leaves through convert rebuild the same inverse tables
    sb = convert.shor_batch_from_numpy(list(b), device="cpu")
    for f in tenc.INVERSE_FIELDS:
        assert np.array_equal(getattr(sb, f).numpy(), getattr(a, f)), f


def test_project_rsoc_float64():
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(60) * 2.0, rng.standard_normal(60) * 2.0
    x = rng.standard_normal((60, 1))
    x[:4] = 0.0
    u[:2], v[:2] = 0.0, 0.0  # the origin (nz == 0 branch)
    a = tcones.project_rsoc(*[torch.as_tensor(t) for t in (u, v, x)])
    b = jcones.project_rsoc(*[jnp.asarray(t) for t in (u, v, x)])
    for p, q in zip(a, b):
        assert _rel(p.numpy(), q) <= 1e-12


def _spectral5(rng, n):
    Q = np.linalg.qr(rng.standard_normal((n, 5, 5)))[0]
    lam = rng.uniform(0.1, 1.0, (n, 5)) * rng.choice([-1.0, 1.0], (n, 5))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    return 0.5 * (T + np.swapaxes(T, -1, -2))


def test_project_psd_ns_small_parity_and_bar():
    T = _spectral5(np.random.default_rng(2), 600).reshape(4, 150, 5, 5)
    exact = tcones.project_psd(torch.as_tensor(T)).numpy()
    # float64: the same arithmetic as omc
    a = tpolar.project_psd_ns_small(torch.as_tensor(T)).numpy()
    assert _rel(a, np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T)))) <= 1e-12
    # float32: omc's bar, for the port and for omc
    T32 = T.astype(np.float32)
    a32 = tpolar.project_psd_ns_small(torch.as_tensor(T32)).numpy()
    b32 = np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32)))
    assert _rel(a32, exact) <= 1e-4 and _rel(b32, exact) <= 1e-4
    # the K7 wrapper on a CPU tensor is the plain version, exactly
    assert torch.equal(tpolar.project_psd_small(torch.as_tensor(T32)),
                       torch.as_tensor(a32))
    # control: products of operands cut to 16 mantissa bits fail the bar
    bad = tpolar.project_psd_ns(torch.as_tensor(T32),
                                matmul=tpolar.truncated_matmul(16)).numpy()
    assert not _rel(bad, exact) <= 1e-4


def _setup(dtype=np.float64, seed=0):
    """Two node slots of the tests/test_shor.py instance: 12 and 7 of its
    4-minors, random slot values and duals, per-slot rho."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(K, N, M, 24, seed=1)
    mask = idx.astype(np.float64)
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    minors = [allm[:12], allm[:7]]
    socs = [jshor_idx.shor_soc_complement(N, M, mm) for mm in minors]
    sbj = jenc.pack_shor_batch(N, M, minors, socs, M5, N * M)
    lo, hi = root_box(N, K)
    bl = [np.zeros((B, L, N)), np.zeros((B, L, K)), np.zeros((B, L, K)),
          np.zeros((B, L)), np.broadcast_to(lo, (B, N, K)).copy(),
          np.broadcast_to(hi, (B, N, K)).copy()]
    st = jshor.init_shor_state(B, N, M, K, L, M5, N * M, jnp.float64, rho=0.05,
                               sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 38)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.05, 0.02])  # per-slot rho
    leaves = [x.astype(dtype) for x in leaves]
    bl = [x.astype(dtype) for x in bl]
    return A.astype(dtype), mask.astype(dtype), bl, sbj, leaves, st


def _jax_state(leaves, like):
    return jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])


def test_forward_adjoint_shor_parity_and_adjoint_identity():
    A, mask, bl, sbj, leaves, _ = _setup()
    sbd = jshor.shor_batch_to_device(sbj, jnp.float64)
    sbt = convert.shor_batch_from_numpy(list(sbj), device="cpu")
    rng = np.random.default_rng(3)
    Xs, Ws = rng.standard_normal((2, B, N, M))
    vs = [rng.standard_normal(np.shape(c)) for c in (sbj.cnt_v1, sbj.cnt_v2, sbj.cnt_v3)]
    sX, sS = np.array([1.3, 2.0]), np.array([1.1, 0.7])
    fj = jshor._forward_shor(sbd, jnp.asarray(Xs), jnp.asarray(Ws), *map(jnp.asarray, vs),
                             M, jnp.asarray(sX), jnp.asarray(sX**2), jnp.asarray(sS))
    ft = tshor._forward_shor(sbt, torch.as_tensor(Xs), torch.as_tensor(Ws),
                             *map(torch.as_tensor, vs), M, torch.as_tensor(sX),
                             torch.as_tensor(sX**2), torch.as_tensor(sS))
    for a, b in zip(ft, fj):
        assert _rel(a.numpy(), b) <= 1e-12
    y5 = rng.standard_normal((B, M5, 5, 5))
    y5 = 0.5 * (y5 + np.swapaxes(y5, -1, -2)) * sbj.minor_mask[..., None, None]
    yr = rng.standard_normal((B, N * M, 3)) * sbj.soc_mask[..., None]
    yl = rng.standard_normal((B, M))
    gj = jshor._adjoint_shor(sbd, jnp.asarray(y5), jnp.asarray(yr), jnp.asarray(yl), B, N,
                             M, jnp.asarray(sX), jnp.asarray(sX**2), jnp.asarray(sS))
    gt = tshor._adjoint_shor(sbt, torch.as_tensor(y5), torch.as_tensor(yr),
                             torch.as_tensor(yl), B, N, M, torch.as_tensor(sX),
                             torch.as_tensor(sX**2), torch.as_tensor(sS))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= 1e-12
    # <y, F z> = <F' y, z> for the linear part (the forward at zero is the
    # constant offset)
    z0 = tshor._forward_shor(sbt, *[torch.zeros_like(torch.as_tensor(t)) for t in (Xs, Ws, *vs)],
                             M, torch.as_tensor(sX), torch.as_tensor(sX**2), torch.as_tensor(sS))
    lhs = (np.sum(y5 * (ft[0] - z0[0]).numpy()) + np.sum(yr * (ft[1] - z0[1]).numpy())
           - np.sum(yl * ft[2].numpy()))
    rhs = sum(np.sum(g.numpy() * z) for g, z in zip(gt, (Xs, Ws, *vs)))
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(rhs))


def _run_both(dtype, iters, psd_method):
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sbj, leaves, like = _setup(np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    kw = dict(iters=iters, psd_method=psd_method, check_every=100, ema_iters=100)
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshor.make_shor_solver(N, M, L, M5, N * M, GAMMA, dtype=jdt, **kw)
    fj, oj = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
                jshor.shor_batch_to_device(sbj, jdt), ub, _jax_state(leaves, like))
    st_t = convert.shor_state_from_numpy(leaves, dtype=tdt, device="cpu")
    st = tshor.make_shor_solver(N, M, L, M5, N * M, GAMMA, dtype=tdt, **kw)
    ft, ot = st(torch.as_tensor(A), torch.as_tensor(mask),
                convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"),
                convert.shor_batch_from_numpy(list(sbj), dtype=tdt, device="cpu"), ub, st_t)
    return fj, oj, ft, ot, st_t, leaves


def test_shor_solve_300_iterations_float64_parity():
    """300 iterations from the same state: iterates <= 1e-9 relative, the
    on-device bound and estimator <= 1e-8; the input state is untouched."""
    fj, oj, ft, ot, st_t, leaves = _run_both("float64", 300, "eigh")
    for a, b in zip(convert.admm_state_to_numpy(st_t), leaves):
        assert np.array_equal(a, b)
    for i, (a, b) in enumerate(zip(convert.admm_state_to_numpy(ft), jax.tree.leaves(fj))):
        assert _rel(a, b) <= 1e-9, i
    for key in ("y1", "y2", "ya", "yb", "yc", "y5", "yr", "yl", "X", "Y", "Th", "U", "W"):
        assert _rel(ot[key].numpy(), oj[key]) <= 1e-9, key
    for key in ("lb_dev", "lb_est"):
        a, b = ot[key].numpy(), np.asarray(oj[key])
        assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))), key
    assert np.array_equal(ot["iters_run"].numpy(), np.asarray(oj["iters_run"]))
    assert _rel(ot["sep_w"].numpy(), oj["sep_w"]) <= 1e-9


def test_shor_solve_float32_sign_schedule_bound():
    """float32 with the sign-schedule projections (the GPU path's algorithm,
    here through the plain versions): the estimator within 1e-4 relative."""
    _, oj, _, ot, _, _ = _run_both("float32", 300, "ns")
    a = ot["lb_est"].numpy().astype(np.float64)
    b = np.asarray(oj["lb_est"], np.float64)
    assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), (a, b)


def test_safe_dual_bounds_parity():
    """The closed-form bounds on the same duals: <= 1e-10 relative."""
    A, mask, bl, sbj, leaves, _ = _setup()
    rng = np.random.default_rng(4)
    shapes = [(B, N + M, N + M), (B, N + K, N + K), (B, L, K), (B, L, K), (B, L),
              (B, M5, 5, 5), (B, N * M, 3), (B, M)]
    duals = [rng.standard_normal(s) * 0.2 for s in shapes]
    sX, sS = np.array([1.7, 1.2]), np.array([1.7, 0.9])
    ub = 0.5 * float(np.sum(mask * A * A))
    jb = jrelax.NodeBatch(*bl)
    a = tshor.safe_dual_bound_shor(
        torch.as_tensor(A), torch.as_tensor(mask), convert.node_batch_from_numpy(bl, device="cpu"),
        convert.shor_batch_from_numpy(list(sbj), device="cpu"), *map(torch.as_tensor, duals), GAMMA, ub,
        margin_rel=1e-10, sX=torch.as_tensor(sX), sS=torch.as_tensor(sS)).numpy()
    b = jshor.safe_dual_bound_shor(np, A, mask, jb, sbj, *duals, GAMMA, ub,
                                   margin_rel=1e-10, sX=sX, sS=sS)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)
    a2 = tshor.safe_dual_bound_shor2(
        torch.as_tensor(A), torch.as_tensor(mask), convert.node_batch_from_numpy(bl, device="cpu"),
        convert.shor_batch_from_numpy(list(sbj), device="cpu"), *map(torch.as_tensor, duals), GAMMA, ub,
        sX=torch.as_tensor(sX), sS=torch.as_tensor(sS))
    b2 = jshor.safe_dual_bound_shor2(jnp, jnp.asarray(A), jnp.asarray(mask),
                                     jrelax.NodeBatch(*map(jnp.asarray, bl)),
                                     jshor.shor_batch_to_device(sbj, jnp.float64),
                                     *map(jnp.asarray, duals), GAMMA, ub,
                                     sX=jnp.asarray(sX), sS=jnp.asarray(sS))
    for x, y in zip(a2, b2):
        y = np.asarray(y)
        assert np.all(np.abs(x.numpy() - y) <= 1e-10 * np.maximum(1.0, np.abs(y)))
    names = ("y1", "y2", "ya", "yb", "yc", "y5", "yr", "yl")
    out = dict(zip(names, duals), sX=sX, sS=sS)
    sbh = tenc.shor_batch_host_from_omc_leaves(list(sbj), N, M)
    a = tshor.host_certified_bound_shor(A, mask, trelax.NodeBatch(*bl), sbh, out, GAMMA, ub)
    b = jshor.host_certified_bound_shor(A, mask, jb, sbj, out, GAMMA, ub)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)


def test_kernel_wrappers_cpu_path_is_plain():
    """On CPU tensors the K8a, K7 and K8b wrappers write exactly what
    their plain versions return."""
    A, mask, bl, sbj, leaves, _ = _setup(np.float32)
    from omc_torch.sdp.admm import make_consts

    st = convert.shor_state_from_numpy(leaves, dtype=torch.float32, device="cpu")
    sb = convert.shor_batch_from_numpy(list(sbj), dtype=torch.float32, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=torch.float32, device="cpu"), st.core,
                    N, M, K, GAMMA, 1.6, 0.01, torch.float32)
    sc = tshor.make_shor_consts(c, sb, st.core, 30.0)
    ref = tshor.shor_zstep_plain(c, sc, st)
    tshor.shor_zstep(c, sc, st)
    for a, b in zip((st.core.X, st.core.Th, st.W, st.v1, st.v2, st.v3), ref):
        assert torch.equal(a, b)
    acc5 = torch.ones_like(st.u5)
    ref = tshor.minor_step_plain(c, sc, st, acc5, tpolar.project_psd_ns_small)
    tshor.minor_step(c, sc, st, acc5, "ns")
    for a, b in zip((st.w5, st.u5, acc5), ref):
        assert torch.equal(a, b)
    acc_r, acc_l = torch.ones_like(st.ur), torch.ones_like(st.ul)
    ref = tshor.shor_cone_step_plain(c, sc, st, acc_r, acc_l)
    tshor.shor_cone_step(c, sc, st, acc_r, acc_l)
    for a, b in zip((st.wr, st.ur, st.wl, st.ul, st.wp, st.up, acc_r, acc_l), ref):
        assert torch.equal(a, b)


def test_warm_slices_across_minor_buckets():
    """A Shor state from the M5=16 bucket warm-starts an M5=64 template
    (leading rows of w5/u5/v, the rest zero) exactly as omc does it."""
    _, _, _, _, leaves, like = _setup()
    big = jshor.init_shor_state(B, N, M, K, L, 64, N * M, jnp.float64)
    tpl = [np.asarray(x, np.float32).copy() for x in jax.tree.leaves(big)]
    st_t = convert.shor_state_from_numpy(leaves, device="cpu")
    host_t = trelax.state_to_host(st_t)
    host_j = jrelax.state_to_host(_jax_state(leaves, like))
    slices_t = [trelax.host_state_slice(host_t, 1), None]
    slices_j = [jrelax.host_state_slice(host_j, 1), None]
    a = trelax.apply_warm_slices([x.copy() for x in tpl], slices_t)
    b = jrelax.apply_warm_slices([x.copy() for x in tpl], slices_j)
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, y)
    w5 = a[26 + 4]
    assert np.array_equal(w5[0, :M5], leaves[30][1].astype(np.float32))
    assert not np.any(w5[0, M5:])
    assert tshor.ShorADMMState.from_leaves([torch.as_tensor(x) for x in a]).w5.shape == (B, 64, 5, 5)


_SHOR_KW = dict(node_selection="breadthfirst", disjunctive_cuts_type="linear",
                disjunctive_cuts_breakpoints="smallest_1_eigvec",
                add_Shor_valid_inequalities=True,
                Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
                update_Shor_indices_n_minors=10, gap=1e-2, batch_size=4,
                sdp_iters=1000, sdp_rho=0.03, dtype="float64", verbosity=0)


def _check_against_omc(sol, inst, sol_j, inst_j):
    gap, gap_j = inst["run_log"][-1]["gap"], inst_j["run_log"][-1]["gap"]
    obj, obj_j = sol["objective"], sol_j["objective"]
    # both runs bound the optimum of the same problem from above, each
    # within its own certified gap
    assert abs(obj - obj_j) <= (gap + gap_j) * max(1.0, abs(obj_j)), (obj, obj_j, gap, gap_j)
    lowers = [r["lower"] for r in inst["run_log"] if np.isfinite(r["lower"])]
    assert all(b_ >= a_ - 1e-9 for a_, b_ in zip(lowers, lowers[1:]))
    # the port's certified lower bound never exceeds omc's incumbent
    assert lowers[-1] <= obj_j * (1.0 + 1e-9)
    assert obj <= sol["objective_initial"] + 1e-12
    assert inst["run_details"]["add_Shor_valid_inequalities"] is True


def test_shor_static_end_to_end_like_omc():
    """Static [4]-minors on a 10x10 instance: certifies gap 1e-2 like omc."""
    A, idx = generate_matrix_completion_data(1, 10, 10, 50, seed=5)
    kw = dict(_SHOR_KW, time_limit=60)
    sol, _, inst = tsolve.matrix_completion_branchandbound(1, A, idx, 80.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 80.0, **kw)
    assert inst["run_log"][-1]["gap"] <= 1e-2
    _check_against_omc(sol, inst, sol_j, inst_j)


def test_shor_iterative_end_to_end_like_omc(monkeypatch):
    """Iterative minors on a 12x12 instance, with growth at refinement
    stalls and at child creation forced early (one refinement per growth
    round): the minor sets grow, and the incumbent agrees with omc's within
    the two runs' gaps after a 20 s budget each."""
    grown = []
    score = tsolve.shor_mod.generate_violated_Shor_minors

    def counting(*a, **k):
        out = score(*a, **k)
        grown.append(len(out))
        return out

    monkeypatch.setattr(tsolve.shor_mod, "generate_violated_Shor_minors", counting)
    A, idx = generate_matrix_completion_data(1, 12, 12, 72, seed=1)
    kw = dict(_SHOR_KW, add_Shor_valid_inequalities_iterative=True, max_refines=1,
              sdp_iter_boost_max=1, update_Shor_max_growths=2, time_limit=20)
    sol, _, inst = tsolve.matrix_completion_branchandbound(1, A, idx, 80.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 80.0, **kw)
    assert len(grown) >= 2 and max(grown) > 0
    _check_against_omc(sol, inst, sol_j, inst_j)
