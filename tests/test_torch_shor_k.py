"""Parity of the port's rank-k Shor path (omc_torch.sdp.shor_k, the K7x
projection wrapper, the driver's Shor-k arm) with omc.sdp.shor_k on the same
numpy-seeded inputs.

In float64 both packages project with eigh, so the iterates agree to
rounding; in float32 the sign schedule is held to omc's own bar.  Sizes are
those of tests/test_shor_k.py: 8x8, k = 2 (k = 3 for the operator identity),
M5 = 8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.sdp import relax as jrelax
from omc.sdp import shor as jshor_idx
from omc.sdp import shor_k as jshk
from omc.solve import matrix_completion_branchandbound as omc_bnb
from omc.tree import root_box

import omc_torch.solve as tsolve
from omc_torch import convert
from omc_torch.ops import cones as tcones
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import relax as trelax
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

N = M = 8
K = 2
B = 2
L = 4
M5 = 8
C = 4 * M5
GAMMA = 20.0
NAMES = ("y1", "y2", "ya", "yb", "yc", "y5", "yx", "yr", "yl", "ywl")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _rel1(a, b):
    """Relative error with a floor of 1 on the scale: leaves of an O(1)
    state that sit at rounding level (u of a slot already in its cone)
    count absolutely."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0)


def _instance(seed=2):
    return generate_matrix_completion_data(K, N, M, int(0.7 * N * M), seed)


def _node_minors(idx):
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
    return [allm[:6], allm[3:16:2]]


def _packed(idx):
    minors = _node_minors(idx)
    socs = [jshor_idx.shor_soc_complement(N, M, mm) for mm in minors]
    return minors, socs, jshk.pack_shor_k_batch(N, M, minors, socs, M5, N * M)


def test_pack_shor_k_batch_fields_and_inverse_tables():
    """omc's 20 fields bit-identical; the entry-keyed minor table, the entry
    maps and the v lists reproduce the dense scatter of the forward
    tables."""
    _, idx = _instance()
    minors, socs, b = _packed(idx)
    a = tshk.pack_shor_k_batch(N, M, minors, socs, M5, N * M)
    for x, y in zip(a.omc_leaves(), b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    rng = np.random.default_rng(0)
    for s in range(B):
        act = a.minor_mask[s] > 0
        # flat entry -> 4 l + corner of the active minors with a corner there
        vals = rng.standard_normal((M5, 4))
        dense = np.zeros(N * M)
        np.add.at(dense, a.coord_flat[s][a.mc[s][act]], vals[act])
        ptr, ent = a.fm_ptr[s], a.fm_ent[s]
        via = np.array([vals.reshape(-1)[ent[ptr[f]:ptr[f + 1]]].sum() for f in range(N * M)])
        assert np.allclose(via, dense, rtol=0, atol=1e-12)
        # ascending minor order inside each entry's list
        assert all(np.all(np.diff(ent[ptr[f]:ptr[f + 1]]) > 0) for f in range(N * M))
        # entry -> coordinate / RSOC slot
        for name, idxs, msk in (("flat_coord", a.coord_flat, a.coord_mask),
                                ("flat_soc", a.soc_flat, a.soc_mask)):
            fm = getattr(a, name)[s]
            live = np.flatnonzero(msk[s] > 0)
            assert np.array_equal(np.sort(np.flatnonzero(fm >= 0)), np.sort(idxs[s][live]))
            assert np.array_equal(idxs[s][fm[fm >= 0]], np.flatnonzero(fm >= 0))
        for name, ia, ib in (("v1", "iv1a", "iv1b"), ("v2", "iv2a", "iv2b")):
            v = rng.standard_normal((M5, 2))
            P = getattr(a, f"cnt_{name}").shape[1]
            dense = np.zeros(P)
            np.add.at(dense, getattr(a, ia)[s], v[:, 0] * a.minor_mask[s])
            np.add.at(dense, getattr(a, ib)[s], v[:, 1] * a.minor_mask[s])
            ptr, ent = getattr(a, f"{name}_ptr")[s], getattr(a, f"{name}_ent")[s]
            via = np.array([v.reshape(-1)[ent[ptr[p]:ptr[p + 1]]].sum() for p in range(P)])
            assert np.allclose(via, dense, rtol=0, atol=1e-12)
        assert a.v3_ptr[s][-1] == len(minors[s])
    # omc's 20 leaves through convert rebuild the same tables
    sb = convert.shor_k_batch_from_numpy(list(b), device="cpu")
    for f in tshk.INVERSE_FIELDS:
        assert np.array_equal(getattr(sb, f).numpy(), getattr(a, f)), f


def _random_state(rng, k, *, dtype=np.float64):
    """omc's ShorKState leaves at (B, N, M, k, L, M5) with random slot
    values and duals (symmetric PSD-slot blocks), per-slot rho and scales."""
    st = jshk.init_shor_k_state(B, N, M, k, L, M5, N * M, jnp.float64, rho=0.05,
                                sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 47)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    # per-slot rho and sS; one sX for every slot, as the driver sets it
    # (omc's proximal term tau_x = sX^2 is (B, 1, 1) against (B, k, n, m))
    leaves[22] = np.array([0.05, 0.02])
    leaves[25] = np.array([1.7, 1.1])
    return [x.astype(dtype) for x in leaves], st


def _setup(dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    A, idx = _instance()
    mask = idx.astype(np.float64)
    _, _, sbj = _packed(idx)
    lo, hi = root_box(N, K)
    bl = [np.zeros((B, L, N)), np.zeros((B, L, K)), np.zeros((B, L, K)),
          np.zeros((B, L)), np.broadcast_to(lo, (B, N, K)).copy(),
          np.broadcast_to(hi, (B, N, K)).copy()]
    leaves, like = _random_state(rng, K, dtype=dtype)
    return (A.astype(dtype), mask.astype(dtype), [x.astype(dtype) for x in bl], sbj,
            leaves, like)


def _jax_state(leaves, like):
    return jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])


def test_init_shor_k_state_like_omc():
    """The even warm split of X0 over the k terms, per-slot scales."""
    rng = np.random.default_rng(5)
    X0 = rng.standard_normal((1, N, M))
    kw = dict(sX=np.array([1.5, 2.0]), sT=1.2, sS=0.8, rho=0.03, X0=X0)
    a = tshk.init_shor_k_state(B, N, M, K, L, M5, N * M, torch.float64, device="cpu", **kw)
    b = jshk.init_shor_k_state(B, N, M, K, L, M5, N * M, jnp.float64, **kw)
    la, lb = convert.admm_state_to_numpy(a), jax.tree.leaves(b)
    assert len(la) == len(lb) == 47
    for x, y in zip(la, lb):
        assert x.shape == np.shape(y) and np.allclose(x, y, rtol=1e-15, atol=0)


def test_forward_adjoint_shor_k_parity_and_adjoint_identity():
    """k = 3: both operators against omc to 1e-12, and <y, F z> = <F' y, z>
    to 1e-10."""
    k, kp = 3, 3
    rng = np.random.default_rng(3)
    _, idx = _instance()
    _, _, sbh = _packed(idx)
    sbd = jshk.shor_k_batch_to_device(sbh, jnp.float64)
    sbt = convert.shor_k_batch_from_numpy(list(sbh), device="cpu")
    P1, P3 = 2 * M5, M5
    z = [rng.standard_normal(s) for s in ((B, k, N, M), (B, N, M), (B, k, C), (B, kp, C),
                                          (B, k, P1), (B, k, P1), (B, k, P3))]
    sX, sS = np.array([1.3, 2.0]), np.array([1.1, 0.7])
    fj = jshk._forward_shor_k(sbd, *map(jnp.asarray, z), k, M, jnp.asarray(sX),
                              jnp.asarray(sX**2), jnp.asarray(sS))
    args = (torch.as_tensor(sX), torch.as_tensor(sX**2), torch.as_tensor(sS))
    ft = tshk._forward_shor_k(sbt, *map(torch.as_tensor, z), k, M, *args)
    for a, b in zip(ft, fj):
        assert _rel(a.numpy(), b) <= 1e-12

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    y5 = sym(rng.standard_normal((B, M5, k, 5, 5))) * sbh.minor_mask[..., None, None, None]
    yx = sym(rng.standard_normal((B, C, k + 1, k + 1))) * sbh.coord_mask[..., None, None]
    yr = rng.standard_normal((B, N * M, 3)) * sbh.soc_mask[..., None]
    yl = rng.standard_normal((B, M))
    ywl = rng.standard_normal((B, C)) * sbh.coord_mask
    ys = (y5, yx, yr, yl, ywl)
    gj = jshk._adjoint_shor_k(sbd, *map(jnp.asarray, ys), B, N, M, k, kp, jnp.asarray(sX),
                              jnp.asarray(sX**2), jnp.asarray(sS))
    gt = tshk._adjoint_shor_k(sbt, *map(torch.as_tensor, ys), B, N, M, k, kp, *args)
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= 1e-12
    zero = tshk._forward_shor_k(sbt, *[torch.zeros_like(torch.as_tensor(t)) for t in z], k, M,
                                *args)
    lhs = (np.sum(y5 * (ft[0] - zero[0]).numpy()) + np.sum(yx * (ft[1] - zero[1]).numpy())
           + np.sum(yr * (ft[2] - zero[2]).numpy()) - np.sum(yl * ft[3].numpy())
           + np.sum(ywl * ft[4].numpy()))
    rhs = sum(np.sum(g.numpy() * v) for g, v in zip(gt, z))
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(rhs))


def _run_both(dtype, iters, psd_method):
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sbj, leaves, like = _setup(np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    kw = dict(iters=iters, psd_method=psd_method, check_every=100, ema_iters=100)
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshk.make_shor_k_solver(N, M, K, L, M5, N * M, GAMMA, dtype=jdt, **kw)
    fj, oj = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
                jshk.shor_k_batch_to_device(sbj, jdt), ub, _jax_state(leaves, like))
    st_t = convert.shor_k_state_from_numpy(leaves, dtype=tdt, device="cpu")
    st = tshk.make_shor_k_solver(N, M, K, L, M5, N * M, GAMMA, dtype=tdt, **kw)
    ft, ot = st(torch.as_tensor(A), torch.as_tensor(mask),
                convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"),
                tshk.shor_k_batch_host_from_omc_leaves(list(sbj)), ub, st_t)
    return fj, oj, ft, ot, st_t, leaves


def test_shor_k_solve_300_iterations_float64_parity():
    """300 iterations from the same state (eigh): iterates <= 1e-9
    relative, the on-device bound and estimator <= 1e-8; the input state is
    untouched."""
    fj, oj, ft, ot, st_t, leaves = _run_both("float64", 300, "eigh")
    for a, b in zip(convert.admm_state_to_numpy(st_t), leaves):
        assert np.array_equal(a, b)
    for i, (a, b) in enumerate(zip(convert.admm_state_to_numpy(ft), jax.tree.leaves(fj))):
        assert _rel1(a, b) <= 1e-9, i
    for key in NAMES + ("X", "Xt", "Y", "Th", "U", "W"):
        assert _rel1(ot[key].numpy(), oj[key]) <= 1e-9, key
    for key in ("lb_dev", "lb_est"):
        a, b = ot[key].numpy(), np.asarray(oj[key])
        assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))), key
    assert np.array_equal(ot["iters_run"].numpy(), np.asarray(oj["iters_run"]))
    assert _rel(ot["sep_w"].numpy(), oj["sep_w"]) <= 1e-9
    assert ot["sep_V"].shape == (B, N, 2)


def test_shor_k_solve_float32_sign_schedule_bound():
    """float32 with the sign-schedule projections (the GPU path's algorithm,
    here through the plain versions): the estimator within 1e-4 relative."""
    _, oj, _, ot, _, _ = _run_both("float32", 300, "ns")
    a = ot["lb_est"].numpy().astype(np.float64)
    b = np.asarray(oj["lb_est"], np.float64)
    assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), (a, b)


def test_safe_dual_bounds_shor_k_parity():
    """The closed-form bounds on the same duals, and the host certificate,
    against omc's numpy: <= 1e-10 relative."""
    A, mask, bl, sbj, _, _ = _setup()
    rng = np.random.default_rng(4)
    shapes = [(B, N + M, N + M), (B, N + K, N + K), (B, L, K), (B, L, K), (B, L),
              (B, M5, K, 5, 5), (B, C, K + 1, K + 1), (B, N * M, 3), (B, M), (B, C)]
    duals = [rng.standard_normal(s) * 0.2 for s in shapes]
    sX, sS = np.array([1.7, 1.2]), np.array([1.7, 0.9])
    ub = 0.5 * float(np.sum(mask * A * A))
    tb = convert.node_batch_from_numpy(bl, device="cpu")
    sbt = convert.shor_k_batch_from_numpy(list(sbj), device="cpu")
    T = torch.as_tensor
    a = tshk.safe_dual_bound_shor_k(T(A), T(mask), tb, sbt, *map(T, duals), GAMMA, K, ub,
                                    margin_rel=1e-10, sX=T(sX), sS=T(sS)).numpy()
    b = jshk.safe_dual_bound_shor_k(np, A, mask, jrelax.NodeBatch(*bl), sbj, *duals, GAMMA,
                                    K, ub, margin_rel=1e-10, sX=sX, sS=sS)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)
    a2 = tshk.safe_dual_bound_shor_k2(T(A), T(mask), tb, sbt, *map(T, duals), GAMMA, K, ub,
                                      sX=T(sX), sS=T(sS))
    b2 = jshk.safe_dual_bound_shor_k2(jnp, jnp.asarray(A), jnp.asarray(mask),
                                      jrelax.NodeBatch(*map(jnp.asarray, bl)),
                                      jshk.shor_k_batch_to_device(sbj, jnp.float64),
                                      *map(jnp.asarray, duals), GAMMA, K, ub,
                                      sX=jnp.asarray(sX), sS=jnp.asarray(sS))
    for x, y in zip(a2, b2):
        y = np.asarray(y)
        assert np.all(np.abs(x.numpy() - y) <= 1e-10 * np.maximum(1.0, np.abs(y)))
    out = dict(zip(NAMES, duals), sX=sX, sS=sS)
    sbh = tshk.shor_k_batch_host_from_omc_leaves(list(sbj))
    a = tshk.host_certified_bound_shor_k(A, mask, trelax.NodeBatch(*bl), sbh, out, GAMMA, K, ub)
    b = jshk.host_certified_bound_shor_k(A, mask, jrelax.NodeBatch(*bl), sbj, out, GAMMA, K, ub)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)


def test_kernel_wrappers_cpu_path_is_plain():
    """On CPU tensors the K8c, K7t, K7x and K8d wrappers write exactly what
    their plain versions return, and the K7x projection wrapper is the
    plain sign schedule."""
    A, mask, bl, sbj, leaves, _ = _setup(np.float32)
    st = convert.shor_k_state_from_numpy(leaves, dtype=torch.float32, device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=torch.float32, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=torch.float32, device="cpu"),
                    st.core, N, M, K, GAMMA, 1.6, 0.01, torch.float32)
    sc = tshk.make_shor_k_consts(c, sb, st.core, 30.0, K)
    ref = tshk.shor_k_zstep_plain(c, sc, st)
    tshk.shor_k_zstep(c, sc, st)
    outs = (st.Xt, st.core.X, st.core.Th, st.W, st.Wt, st.Hh, st.v1, st.v2, st.v3)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    acc5 = torch.ones_like(st.u5)
    ref = tshk.minor_k_step_plain(c, sc, st, acc5, tpolar.project_psd_ns_small)
    tshk.minor_k_step(c, sc, st, acc5, "ns")
    for a, b in zip((st.w5, st.u5, acc5), ref):
        assert torch.equal(a, b)
    accx = torch.ones_like(st.ux)
    ref = tshk.xwh_step_plain(c, sc, st, accx, tpolar.project_psd_ns_small)
    tshk.xwh_step(c, sc, st, accx, "ns")
    for a, b in zip((st.wx, st.ux, accx), ref):
        assert torch.equal(a, b)
    accs = [torch.ones_like(x) for x in (st.ur, st.ul, st.uwl)]
    ref = tshk.shor_k_cone_step_plain(c, sc, st, *accs)
    tshk.shor_k_cone_step(c, sc, st, *accs)
    outs = (st.wr, st.ur, st.wl, st.ul, st.wwl, st.uwl, st.wp, st.up, st.wq, st.uq, *accs)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    T = torch.as_tensor(leaves[35][:, :7], dtype=torch.float32)  # (B, 7, 3, 3)
    assert torch.equal(tpolar.project_psd_xwh(T), tpolar.project_psd_ns_small(T))


def test_k8c_parameter_block_reused_only_for_the_same_operands():
    """K8c's packed parameter block (checked once, then reused by the solve
    loop) points at every operand, is reused for the same tensors and is
    packed anew when an operand is another tensor."""
    A, mask, bl, sbj, leaves, _ = _setup(np.float32)
    st = convert.shor_k_state_from_numpy(leaves, dtype=torch.float32, device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=torch.float32, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=torch.float32, device="cpu"),
                    st.core, N, M, K, GAMMA, 1.6, 0.01, torch.float32)
    sc = tshk.make_shor_k_consts(c, sb, st.core, 30.0, K)
    cpu = torch.device("cpu")
    p = tshk._k8c_params(c, sc, st, cpu)
    ops = tshk._k8c_operands(c, sc, st)
    for name, t, _, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    # the reuse test looks at every operand
    assert sorted(map(id, tshk._k8c_tensors(c, sc, st))) == sorted(id(t) for _, t, _, _ in ops)
    assert (p.B, p.n, p.m, p.k, p.cols) == (B, N, M, K, tshk.k8c_plan(B, N, M, K)["cols"])
    assert tshk._k8c_params(c, sc, st, cpu) is p
    st.Xt = st.Xt.clone()
    q = tshk._k8c_params(c, sc, st, cpu)
    assert q is not p and q.Xt == st.Xt.data_ptr()
    st.W = st.W.double()  # a wrong dtype is refused, not reused
    with pytest.raises(TypeError):
        tshk._k8c_params(c, sc, st, cpu)


def test_xwh_sign_schedule_meets_the_bar():
    """The 3x3 XWH projection in float32 (K7x's algorithm) is within 1e-4
    of the exact projection, like omc's; a 16-bit truncated-product
    control is not."""
    rng = np.random.default_rng(6)
    Q = np.linalg.qr(rng.standard_normal((600, 3, 3)))[0]
    lam = rng.uniform(0.1, 1.0, (600, 3)) * rng.choice([-1.0, 1.0], (600, 3))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    T = 0.5 * (T + np.swapaxes(T, -1, -2))
    exact = tcones.project_psd(torch.as_tensor(T)).numpy()
    T32 = torch.as_tensor(T.astype(np.float32))
    assert _rel(tpolar.project_psd_xwh(T32).numpy(), exact) <= 1e-4
    from omc.ops import polar as jpolar

    assert _rel(np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32.numpy()))), exact) <= 1e-4
    bad = tpolar.project_psd_ns(T32, matmul=tpolar.truncated_matmul(16)).numpy()
    assert not _rel(bad, exact) <= 1e-4


def test_apply_best_duals_like_omc():
    """The best-chunk duals become the scaled duals u = y / rho of the core
    and of the u5, ux, ur, ul, uwl slots (omc/solve.py _apply_best_duals)."""
    rng = np.random.default_rng(7)
    leaves, _ = _random_state(rng, K)
    st = convert.shor_k_state_from_numpy(leaves, device="cpu")
    shapes = {"y1": leaves[9].shape, "y2": leaves[10].shape, "ya": leaves[15].shape,
              "yb": leaves[16].shape, "yc": leaves[17].shape, "y5": leaves[34].shape,
              "yx": leaves[36].shape, "yr": leaves[38].shape, "yl": leaves[40].shape,
              "ywl": leaves[42].shape}
    out = {key: torch.as_tensor(rng.standard_normal(s)) for key, s in shapes.items()}
    new = convert.admm_state_to_numpy(tshk.apply_best_duals(st, out))
    rho = leaves[22]
    want = list(leaves)
    for key, li in (("y1", 9), ("y2", 10), ("ya", 15), ("yb", 16), ("yc", 17), ("y5", 34),
                    ("yx", 36), ("yr", 38), ("yl", 40), ("ywl", 42)):
        y = out[key].numpy()
        want[li] = y / rho.reshape((B,) + (1,) * (y.ndim - 1))
    for i, (a, b) in enumerate(zip(new, want)):
        assert np.allclose(a, b, rtol=1e-15, atol=0), i


def test_warm_slices_across_minor_buckets_like_omc():
    """A Shor-k state from the M5=8 bucket warm-starts an M5=64 template
    exactly as omc does it (w5/u5 keep their leading rows; the coordinate-
    axis leaves of other shapes keep the template's values)."""
    rng = np.random.default_rng(8)
    leaves, like = _random_state(rng, K)
    big = jshk.init_shor_k_state(B, N, M, K, L, 64, N * M, jnp.float64)
    tpl = [np.asarray(x, np.float32).copy() for x in jax.tree.leaves(big)]
    host_t = trelax.state_to_host(convert.shor_k_state_from_numpy(leaves, device="cpu"))
    host_j = jrelax.state_to_host(_jax_state(leaves, like))
    a = trelax.apply_warm_slices([x.copy() for x in tpl], [trelax.host_state_slice(host_t, 1),
                                                            None])
    b = jrelax.apply_warm_slices([x.copy() for x in tpl], [jrelax.host_state_slice(host_j, 1),
                                                            None])
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, y)
    assert np.array_equal(a[33][0, :M5], leaves[33][1].astype(np.float32))
    st = tshk.ShorKState.from_leaves([torch.as_tensor(x) for x in a])
    assert st.w5.shape == (B, 64, K, 5, 5) and st.Wt.shape == (B, K, 256)


def test_bnb_k2_shor_end_to_end_like_omc():
    """omc's test_bnb_k2_shor_e2e call through both packages: objectives
    within the two runs' gaps, monotone lower bounds, rank <= 2."""
    A, idx = _instance(seed=4)
    kw = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
              disjunctive_cuts_breakpoints="smallest_1_eigvec",
              add_Shor_valid_inequalities=True, add_Shor_valid_inequalities_iterative=True,
              update_Shor_indices_n_minors=8, gap=5e-2, batch_size=4, sdp_iters=800,
              dtype="float64", time_limit=240, verbosity=0)
    sol, _, inst = tsolve.matrix_completion_branchandbound(2, A, idx, 20.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(2, A, idx, 20.0, **kw)
    gap, gap_j = inst["run_log"][-1]["gap"], inst_j["run_log"][-1]["gap"]
    assert gap <= 5e-2
    obj, obj_j = sol["objective"], sol_j["objective"]
    assert abs(obj - obj_j) <= (gap + gap_j) * max(1.0, abs(obj_j)), (obj, obj_j, gap, gap_j)
    lowers = [r["lower"] for r in inst["run_log"] if np.isfinite(r["lower"])]
    assert all(b_ >= a_ - 1e-9 for a_, b_ in zip(lowers, lowers[1:]))
    assert lowers[-1] <= obj_j * (1.0 + 1e-9)
    assert obj <= sol["objective_initial"] + 1e-12
    assert np.linalg.matrix_rank(sol["X"], tol=1e-6) <= 2
    assert inst["run_details"]["nodes_explored"] >= 1
