"""Parity of the port's Halpern-anchored ADMM (``sdp_halpern=True``;
omc_torch.sdp.admm with K3's Halpern mode, whose plain version
``cone_step_plain`` runs here) with omc.sdp.admm.

Inputs come from numpy seeds, float64, where both packages project onto the
PSD cone by an exact eigh.  ``omc`` restarts its anchors and beta at every
solver call of at most ``sdp_first_call_iters`` = 2,000 iterations; the port
runs a visit as one call, so the tests keep to visits of at most 2,000
iterations, where the two schemes are the same.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.sdp import admm as jadmm
from omc.sdp import relax as jrelax
from omc.sdp.cuts import region_bounds
from omc.solve import matrix_completion_branchandbound as omc_bnb
from omc.tree import root_box

from omc_torch import convert
from omc_torch.sdp import admm as tadmm
from omc_torch.sdp import relax as trelax
from omc_torch.solve import matrix_completion_branchandbound

torch.set_num_threads(2)

N = M = 8
K = 1
B = 4
L = 8
GAMMA = 40.0
_MAIN = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-6)


def _setup(seed=0):
    """A batch of four slots with two real cuts each and a warm state with
    random slot values and duals (nonzero anchors in every slot)."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(K, N, M, 40, seed)
    mask = idx.astype(np.float64)
    lo0, hi0 = root_box(N, K)
    cut_x = np.zeros((B, L, N))
    cut_lo = np.zeros((B, L, K))
    cut_hi = np.zeros((B, L, K))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(2):
            x = rng.standard_normal(N)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, K), rng.uniform(-0.6, 0.6, K))
            cut_mask[b, l] = 1.0
    leaves = [cut_x, cut_lo, cut_hi, cut_mask, np.broadcast_to(lo0, (B, N, K)).copy(),
              np.broadcast_to(hi0, (B, N, K)).copy()]
    u = rng.standard_normal(N)
    U0 = (u / np.linalg.norm(u))[:, None]
    V0 = U0.T @ (mask * A)
    st = jadmm.init_admm_state(B, N, M, K, L, jnp.float64, sX=2.0, sT=3.0, X0=(U0 @ V0)[None],
                               Y0=(U0 @ U0.T)[None], Th0=(V0.T @ V0)[None], U0=U0[None],
                               rho=0.05)
    sl = [np.asarray(x, np.float64).copy() for x in st]
    for i in range(18):  # w1..wc, u1..uc
        sl[i] = sl[i] + 0.1 * rng.standard_normal(sl[i].shape)
    for j in (6, 7, 15, 16):
        sl[j] = sl[j] * cut_mask[..., None]
    for j in (8, 17):
        sl[j] = sl[j] * cut_mask
    sl[22] = np.array([0.05, 0.02, 0.2, 0.0125])  # per-slot rho
    return A, mask, leaves, sl


@pytest.mark.parametrize("iters", [1, 600])
def test_halpern_solver_matches_omc(iters):
    """make_admm_solver(halpern=True) against omc's, one call of ``iters``
    iterations: every leaf of the final state, Y and the duals to 1e-8, the
    float64 host bound of the duals to 1e-8; the normal mode's iterates
    differ from the Halpern mode's."""
    A, mask, bl, sl = _setup()
    kw = dict(iters=iters, alpha=1.9, check_every=200, ema_iters=200)
    ub = 50.0
    solve_j = jadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=jnp.float64, halpern=True, **kw)
    fin_j, out_j = solve_j(jnp.asarray(A), jnp.asarray(mask),
                           jrelax.NodeBatch(*[jnp.asarray(x) for x in bl]), ub,
                           jadmm.ADMMState(*[jnp.asarray(x) for x in sl]))
    tb = convert.node_batch_from_numpy(bl, device="cpu")
    st = convert.admm_state_from_numpy(sl, device="cpu")
    solve_t = tadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=torch.float64, halpern=True, **kw)
    fin_t, out_t = solve_t(torch.as_tensor(A), torch.as_tensor(mask), tb, ub, st)
    names = [f.name for f in tadmm.dataclasses.fields(tadmm.ADMMState)]
    for name, a, b in zip(names, convert.admm_state_to_numpy(fin_t), fin_j):
        assert _rel(a, b) <= 1e-8, name
    for key in ("Y", "X", "U", "y1", "y2", "ya", "yb", "yc"):
        assert _rel(out_t[key].numpy(), out_j[key]) <= 1e-8, key
    lb_t = trelax.host_certified_bound(A, mask, tb, out_t, GAMMA, K, ub)
    lb_j = jrelax.host_certified_bound(A, mask, jrelax.NodeBatch(*bl),
                                       {kk: np.asarray(v) for kk, v in out_j.items()},
                                       GAMMA, K, ub)
    assert np.all(np.abs(lb_t - lb_j) <= 1e-8 * np.maximum(1.0, np.abs(lb_j)))
    plain = tadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=torch.float64, **kw)
    fin_p, _ = plain(torch.as_tensor(A), torch.as_tensor(mask), tb, ub, st)
    assert _rel(fin_p.w1.numpy(), fin_t.w1.numpy()) > 1e-6


def test_cone_step_halpern_mode():
    """The K3 wrapper's plain version in the Halpern mode: at iteration it
    every pre-projection slot is b s0 + (1 - b) t with b = 1/(it + 2), the
    projections and u-steps taken from the blended values; without anchors
    it is the normal mode."""
    A, mask, bl, sl = _setup(1)
    tb = convert.node_batch_from_numpy(bl, device="cpu")
    st = convert.admm_state_from_numpy(sl, device="cpu")
    c = tadmm.make_consts(torch.as_tensor(A), torch.as_tensor(mask), tb, st, N, M, K, GAMMA,
                          1.9, 1e-3, torch.float64)
    acc = [torch.zeros_like(st.ua), torch.zeros_like(st.ub), torch.zeros_like(st.uc)]
    t_n = tadmm.cone_step_plain(c, st, acc)
    anchors = tadmm.halpern_anchors(st)
    c.anchors = tuple(2.0 * a for a in anchors)  # anchors away from the iterate
    it = 5
    bh = 1.0 / (it + 2.0)
    t_h = tadmm.cone_step_plain(c, st, acc, it)
    for j in range(3):
        assert torch.allclose(t_h[j], bh * c.anchors[j] + (1 - bh) * t_n[j], rtol=1e-14,
                              atol=1e-14)
    # t4 = w4 + u4 after the split: the blend of the normal mode's t4
    t4_n = t_n[3][0] + t_n[3][1]
    t4_h = t_h[3][0] + t_h[3][1]
    assert torch.allclose(t4_h, bh * c.anchors[3] + (1 - bh) * t4_n, rtol=1e-14, atol=1e-14)
    # the wrapper on a CPU state runs the same plain version, in place
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    s2 = st.clone()
    acc2 = [a.clone() for a in acc]
    tadmm.cone_step(c, s2, ts, acc2, it=it)
    for j in range(3):
        assert torch.equal(ts[j], t_h[j])


def test_halpern_driver_matches_omc():
    """The driver with sdp_halpern=True and sdp_iter_boost_max=1 (visits of
    1,500 iterations, one omc call each): the same objective and root bound
    as omc, 1e-6 relative."""
    A, idx = generate_matrix_completion_data(1, 10, 10, 60, seed=2)
    kw = dict(_MAIN, gap=1e-2, batch_size=4, sdp_iters=1500, sdp_iter_boost_max=1,
              sdp_halpern=True, dtype="float64", time_limit=120, verbosity=0)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 20.0, **kw)
    sol_t, _, inst_t = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **kw)
    assert sol_t["objective"] == pytest.approx(sol_j["objective"], rel=1e-6)
    root_t, root_j = inst_t["run_log"][0]["lower"], inst_j["run_log"][0]["lower"]
    assert np.isfinite(root_j)
    assert root_t == pytest.approx(root_j, rel=1e-6)
    assert inst_t["run_log"][-1]["gap"] <= 1e-2
    assert inst_t["run_details"]["nodes_explored"] == inst_j["run_details"]["nodes_explored"]
