"""Parity of the port's McCormick path (omc_torch/sdp/mccormick.py, the K9s,
K9a and K9b plain versions, the bisection driver) with omc's, on numpy-seeded
inputs in float64 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc.sdp.mccormick as J
from omc.tree import root_box

import omc_torch.sdp.mccormick as P
from omc_torch import convert

torch.set_num_threads(2)

# boxes found by seeded search in tests/test_mccormick.py: interval-feasible
# but LP-infeasible, and infeasible only through the column-SOC coupling
_LP_BOX = (
    np.array([[-0.438258, 0.461412], [0.136385, 0.799892], [-0.104283, -0.186774],
              [-0.386986, -0.537255]]),
    np.array([[0.017279, 0.646692], [0.739977, 0.989345], [0.367068, 0.210955],
              [0.052936, 0.089537]]),
)
_SOC_BOX = (
    np.array([[0.94132798, 0.27543202], [-0.00897417, -0.72854328],
              [0.30676366, -0.66333647], [-0.06671147, -0.85463007]]),
    np.array([[1.0, 0.38433154], [-0.00254134, -0.43549291], [0.53722121, -0.30952203],
              [0.47751114, -0.70474561]]),
)


def _boxes(rng, B, n, k):
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    return lo, hi


def _random_state(rng, B, n, m, k):
    """omc's MCState leaves with random slot values and duals (symmetric
    square blocks), penalties around 10 and block scales != 1."""
    st = J.init_mc_state(B, n, m, k, jnp.float64, sX=1.5, sT=1.2, rho=10.0)
    leaves = [np.asarray(x) for x in st]
    for i in range(21):  # w1 ... t
        x = rng.standard_normal(leaves[i].shape) * 0.3
        if x.ndim == 3 and x.shape[-1] == x.shape[-2]:
            x = 0.5 * (x + np.swapaxes(x, -1, -2))
        leaves[i] = x
    leaves[21] = rng.uniform(5.0, 15.0, B)
    return leaves


def _problem(rng, n, m):
    return rng.standard_normal((n, m)), (rng.random((n, m)) < 0.6).astype(np.float64)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_coefficients_and_corner_box_match(k):
    rng = np.random.default_rng(k)
    lo, hi = _boxes(rng, 3, 7, k)
    J1, J2 = P.pair_indices(k)
    assert all(np.array_equal(a, b) for a, b in zip((J1, J2), J.pair_indices(k)))
    for a, b in zip(P.mccormick_coeffs(lo, hi, J1, J2),
                    J.mccormick_coeffs(lo, hi, J1, J2, xp=np)):
        assert np.array_equal(a, b)
    for a, b in zip(P.t_corner_box(lo, hi, J1, J2), J.t_corner_box(lo, hi, J1, J2, xp=np)):
        assert np.array_equal(a, b)
    # the torch form gives the same numbers
    tlo, thi = torch.as_tensor(lo), torch.as_tensor(hi)
    for a, b in zip(P.mccormick_coeffs(tlo, thi, J1, J2),
                    J.mccormick_coeffs(lo, hi, J1, J2, xp=np)):
        assert np.array_equal(a.numpy(), b)


def _feasibility_boxes():
    rng = np.random.default_rng(7)
    boxes = [_LP_BOX, _SOC_BOX, root_box(6, 2), root_box(5, 1),
             (np.full((6, 1), 0.0), np.full((6, 1), 0.1)),
             (np.full((4, 1), 0.9), np.full((4, 1), 1.0))]
    for k in (1, 2, 3):
        for _ in range(4):
            lo, hi = _boxes(rng, 1, 4, k)
            boxes.append((lo[0], hi[0]))
    return boxes


@pytest.mark.parametrize("i", range(len(_feasibility_boxes())))
def test_feasibility_screens_match(i):
    lo, hi = _feasibility_boxes()[i]
    assert P.mccormick_box_feasible(lo, hi) == J.mccormick_box_feasible(lo, hi)
    for rounds in (0, 6):
        assert (P.mccormick_lp_feasible(lo, hi, max_soc_rounds=rounds)
                == J.mccormick_lp_feasible(lo, hi, max_soc_rounds=rounds))


def test_search_found_boxes_are_rejected():
    assert P.mccormick_box_feasible(*_LP_BOX) and not P.mccormick_lp_feasible(*_LP_BOX)
    assert P.mccormick_lp_feasible(*_SOC_BOX, max_soc_rounds=0)
    assert not P.mccormick_lp_feasible(*_SOC_BOX)


@pytest.mark.parametrize("k", [1, 2])
def test_master_feasibility_matches(k):
    rng = np.random.default_rng(3 + k)
    n, m = 7, 8
    U, _ = np.linalg.qr(rng.standard_normal((n, k)))
    V = rng.standard_normal((k, m))
    X, Y, Th = U @ V, U @ U.T, V.T @ V
    cases = [(Y, U, X, Th), (Y, 1.1 * U, X, Th), (0.5 * Y, U, X, Th),
             (Y, U.astype(np.float32), X, Th), (Y + 0.01, U, X, Th)]
    for args in cases:
        assert P.master_feasible_mccormick(*args) == J.master_feasible_mccormick(*args)
    assert P.master_feasible_mccormick(Y, U, X, Th)
    # a float32 iterate never passes |U'U - I| <= 1e-12 (as in omc)
    assert not P.master_feasible_mccormick(Y, U.astype(np.float32), X, Th)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_setup_plain_is_omcs_factorisation(k):
    """K9s's plain version against omc's factorisation recomputed in numpy
    from omc's envelope coefficients: M_i = R_i'R_i + diag(4 I_k, 0) +
    1e-9 I, its Cholesky factor, S_i = M_i^-1 E_t, chol(I + sum_i S_i[k:])."""
    rng = np.random.default_rng(10 + k)
    B, n = 2, 6
    q = k * (k + 1) // 2
    lo, hi = _boxes(rng, B, n, k)
    J1, J2 = J.pair_indices(k)
    s, c1, c2, _ = J.mccormick_coeffs(lo, hi, J1, J2, xp=np)
    eye_k = np.eye(k)
    R = np.concatenate([c1[..., None] * eye_k[J1] + c2[..., None] * eye_k[J2],
                        s[..., None] * np.eye(q)], axis=-1)  # (B, 4, n, q, k+q)
    R = np.swapaxes(R, 1, 2).reshape(B, n, 4 * q, k + q)
    M = np.einsum("bnrc,bnrd->bncd", R, R) + np.diag(np.r_[4.0 * np.ones(k), np.zeros(q)])
    M = M + 1e-9 * np.eye(k + q)
    Mc_ref = np.linalg.cholesky(M)
    Et = np.concatenate([np.zeros((k, q)), np.eye(q)])
    Si_ref = np.linalg.solve(M, np.broadcast_to(Et, (B, n, k + q, q)))
    Gc_ref = np.linalg.cholesky(np.eye(q) + Si_ref[..., k:, :].sum(axis=1))
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu")
    assert np.allclose(P.mc_gram_plain(batch, k).numpy(), M, rtol=0, atol=1e-12)
    for got, ref in zip(P.mc_setup_plain(batch, k), (Mc_ref, Si_ref, Gc_ref)):
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-12
    # the CPU wrapper is the plain version
    for a, b in zip(P.mc_setup(batch, k), P.mc_setup_plain(batch, k)):
        assert torch.equal(a, b)


def _both_solvers(k, iters, seed, n=6, m=7, B=2):
    rng = np.random.default_rng(seed)
    A, mask = _problem(rng, n, m)
    lo, hi = _boxes(rng, B, n, k)
    leaves = _random_state(rng, B, n, m, k)
    sj = J.make_mccormick_solver(n, m, k, 20.0, iters=iters, dtype=jnp.float64)
    fj, oj = sj(jnp.asarray(A), jnp.asarray(mask),
                J.MCBatch(jnp.asarray(lo), jnp.asarray(hi)), 5.0,
                J.MCState(*[jnp.asarray(x) for x in leaves]))
    st = P.make_mccormick_solver(n, m, k, 20.0, iters=iters, dtype=torch.float64)
    ft, ot = st(torch.as_tensor(A), torch.as_tensor(mask),
                convert.mc_batch_from_numpy([lo, hi], device="cpu"), 5.0,
                convert.mc_state_from_numpy(leaves, device="cpu"))
    return (A, mask, lo, hi), (fj, {key: np.asarray(v) for key, v in oj.items()}), (ft, ot)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_one_iteration_matches_omc(k):
    """One iteration from one random state: the z-step outputs (X, Y, Theta,
    U, t; the K9a plain version), the cone-step outputs (every non-PSD slot;
    the K9b plain version) and the PSD slots match omc to 1e-12."""
    _, (fj, _), (ft, _) = _both_solvers(k, 1, 20 + k)
    names = [f for f in P.MCState.__dataclass_fields__]
    for name, a, b in zip(names, ft.leaves(), fj):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1e-12, name


@pytest.mark.parametrize("k", [1, 2])
def test_300_iterations_match_omc(k):
    """300 float64 iterations of the port's solver from one state equal
    omc's within 1e-9: primal blocks, the duals y1, y2, ymc, yorth averaged
    over the last quarter, and the host certificate (1e-10)."""
    (A, mask, lo, hi), (fj, oj), (ft, ot) = _both_solvers(k, 300, 30 + k)
    for key in ("X", "Y", "Th", "U", "t", "y1", "y2", "ymc", "yorth", "sep_w"):
        a, b = ot[key].numpy(), oj[key]
        assert np.max(np.abs(a - b)) <= 1e-9 * max(1.0, np.max(np.abs(b))), key
    lb_t = P.host_certified_bound_mc(A, mask, lo, hi, ot, 20.0, k, 5.0)
    lb_j = J.host_certified_bound_mc(A, mask, lo, hi, oj, 20.0, k, 5.0)
    assert np.all(np.isfinite(lb_t))
    assert np.max(np.abs(lb_t - lb_j)) <= 1e-10 * max(1.0, np.max(np.abs(lb_j)))


@pytest.mark.parametrize("k", [1, 3])
def test_host_certificate_matches_omc(k):
    """The float64 certificate at random duals equals omc's numpy one."""
    rng = np.random.default_rng(40 + k)
    B, n, m = 3, 5, 6
    q = k * (k + 1) // 2
    A, mask = _problem(rng, n, m)
    lo, hi = _boxes(rng, B, n, k)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    out = {"y1": sym(rng.standard_normal((B, n + m, n + m))),
           "y2": sym(rng.standard_normal((B, n + k, n + k))),
           "ymc": rng.standard_normal((B, 4, n, q)), "yorth": rng.standard_normal((B, q))}
    lb_t = P.host_certified_bound_mc(A, mask, lo, hi, out, 20.0, k, 3.0)
    lb_j = J.host_certified_bound_mc(A, mask, lo, hi, out, 20.0, k, 3.0)
    assert np.max(np.abs(lb_t - lb_j)) <= 1e-10 * max(1.0, np.max(np.abs(lb_j)))
    # torch tensors are accepted too
    out_t = {key: torch.as_tensor(v) for key, v in out.items()}
    assert np.array_equal(P.host_certified_bound_mc(A, mask, lo, hi, out_t, 20.0, k, 3.0), lb_t)


@pytest.mark.parametrize("k", [1, 2])
def test_cpu_wrappers_are_the_plain_versions(k):
    """On CPU tensors mc_zstep and mc_cone_step write exactly what their
    plain versions return (with and without the running means)."""
    rng = np.random.default_rng(50 + k)
    B, n, m = 2, 5, 6
    A, mask = _problem(rng, n, m)
    lo, hi = _boxes(rng, B, n, k)
    st = convert.mc_state_from_numpy(_random_state(rng, B, n, m, k), device="cpu")
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu")
    c = P.make_mc_consts(torch.as_tensor(A), torch.as_tensor(mask), batch, st, n, m, k,
                         20.0, 1.6, torch.float64)
    s1 = st.clone()
    P.mc_zstep(c, s1)
    for a, b in zip((s1.X, s1.Y, s1.Th, s1.U, s1.t), P.mc_zstep_plain(c, st)):
        assert torch.equal(a, b)
    for beta, with_acc in ((0.0, False), (0.5, True)):
        acc = [torch.as_tensor(rng.standard_normal(tuple(x.shape))) for x in (st.umc, st.uorth)]
        s2 = s1.clone()
        acc2 = [a.clone() for a in acc] if with_acc else None
        ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
        P.mc_cone_step(c, s2, ts, acc2, beta)
        t1, t2, t3, rest, acc_p = P.mc_cone_step_plain(c, s1, acc if with_acc else None, beta)
        assert all(torch.equal(a, b) for a, b in zip(ts, (t1, t2, t3)))
        assert all(torch.equal(getattr(s2, name), v) for name, v in zip(P._REST, rest))
        if with_acc:
            assert all(torch.equal(a, b) for a, b in zip(acc2, acc_p))


def test_bisection_children_match():
    import omc.branch as jbranch
    import omc.tree as jtree

    import omc_torch.branch as tbranch
    import omc_torch.tree as ttree

    rng = np.random.default_rng(2)
    lo, hi = _boxes(rng, 1, 6, 2)
    kids = []
    for tree_mod, branch_mod in ((jtree, jbranch), (ttree, tbranch)):
        parent = tree_mod.BBNode(node_id=5, parent_id=2, U_lower=lo[0], U_upper=hi[0], LB=1.5,
                                 depth=3, cuts=None)
        kids.append(branch_mod.create_mccormick_child_nodes(parent, 9, 1.75))
    assert len(kids[0]) == len(kids[1]) == 2
    for cj, ct in zip(*kids):
        assert (cj.node_id, cj.parent_id, cj.depth, cj.LB, cj.cuts) == (
            ct.node_id, ct.parent_id, ct.depth, ct.LB, ct.cuts)
        assert np.array_equal(cj.U_lower, ct.U_lower)
        assert np.array_equal(cj.U_upper, ct.U_upper)


def test_mccormick_branch_and_bound_like_omc():
    """A McCormick B&B in float64 on a 6x6 instance that bisects: the same
    incumbent as omc within 1e-6, sound and monotone lower bounds, the same
    run_details keys and parameter echo."""
    from omc.solve import matrix_completion_branchandbound as omc_bnb
    from omc_torch.data import generate_matrix_completion_data
    from omc_torch.solve import matrix_completion_branchandbound

    A, idx = generate_matrix_completion_data(1, 6, 6, 14, 0)
    kw = dict(use_disjunctive_cuts=False, node_selection="bestfirst", gap=1e-4, batch_size=8,
              sdp_iters=300, sdp_iter_boost_max=1, max_refines=2, dtype="float64",
              time_limit=8, verbosity=0)
    sol, _, inst = matrix_completion_branchandbound(1, A, idx, 80.0, device="cpu", **kw)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 80.0, **kw)
    obj, obj_j = sol["objective"], sol_j["objective"]
    assert abs(obj - obj_j) <= 1e-6 * max(1.0, abs(obj_j)), (obj, obj_j)
    rd, rd_j = inst["run_details"], inst_j["run_details"]
    # the same keys (the census included), plus the port's device and Shor counters
    assert set(rd) - set(rd_j) == {"device", "shor_growths", "shor_minors_max"}
    assert set(rd_j) <= set(rd)
    for key in ("use_disjunctive_cuts", "disjunctive_cuts_type", "disjunctive_cuts_breakpoints"):
        assert rd[key] == rd_j[key], key
    assert rd["nodes_explored"] > 1
    lowers = [r["lower"] for r in inst["run_log"] if np.isfinite(r["lower"])]
    assert lowers and all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    assert all(lb <= obj_j * (1.0 + kw["gap"]) for lb in lowers)
