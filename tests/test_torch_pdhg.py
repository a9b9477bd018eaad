"""Parity of the port's PDHG relaxation (omc_torch.sdp.relax.make_solver,
``sdp_method="pdhg"``) with omc.sdp.relax.

Inputs come from numpy seeds, float64, where both packages project onto the
PSD cone by an exact eigh, so the iterates agree to rounding once both use
the same operator-norm estimate (``omc`` draws its power-iteration start
from ``jax.random``, the port from a ``torch.Generator``: the parity tests
pass ``omc``'s estimate in).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.sdp import relax as jrelax
from omc.sdp.cuts import region_bounds
from omc.solve import matrix_completion_branchandbound as omc_bnb
from omc.tree import root_box

from omc_torch import convert
from omc_torch.sdp import relax as trelax
from omc_torch.solve import matrix_completion_branchandbound

torch.set_num_threads(2)

GAMMA = 40.0
_MAIN = dict(node_selection="bestfirst", disjunctive_cuts_type="linear",
             disjunctive_cuts_breakpoints="smallest_1_eigvec")


def _rel(a, b):
    """Relative Frobenius distance (a dual block at rounding level in both,
    such as y3 at an interior point, is measured against 1e-6)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-6)


def _batch_leaves(n, k, L, B, n_cuts, seed):
    """Padded cut tensors and root boxes: slot b has ``n_cuts[b]`` real
    cuts (an int: every slot)."""
    rng = np.random.default_rng(seed)
    cut_x = np.zeros((B, L, n))
    cut_lo = np.zeros((B, L, k))
    cut_hi = np.zeros((B, L, k))
    cut_mask = np.zeros((B, L))
    counts = [n_cuts] * B if isinstance(n_cuts, int) else n_cuts
    for b in range(B):
        for l in range(counts[b]):
            x = rng.standard_normal(n)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, k), rng.uniform(-0.6, 0.6, k))
            cut_mask[b, l] = 1.0
    lo, hi = root_box(n, k)
    return [cut_x, cut_lo, cut_hi, cut_mask, np.broadcast_to(lo, (B, n, k)).copy(),
            np.broadcast_to(hi, (B, n, k)).copy()]


def _pair(n, m, k, L, B, n_cuts, seed=0):
    A, idx = generate_matrix_completion_data(k, n, m, int(0.75 * n * m), seed)
    leaves = _batch_leaves(n, k, L, B, n_cuts, seed + 1)
    jb = jrelax.NodeBatch(*[jnp.asarray(x) for x in leaves])
    tb = convert.node_batch_from_numpy(leaves, device="cpu")
    return A, idx.astype(np.float64), leaves, jb, tb


@pytest.mark.parametrize("k", [1, 2])
def test_pdhg_solver_matches_omc(k):
    """300 iterations from the incumbent-like warm start, omc's opnorm in,
    L = 4 with no cut in slot 0 and one in slot 1: every leaf of the final
    state (X, Y, Theta, U, their extrapolations and every dual) and every
    output to 1e-8 relative."""
    n = m = 6
    L, B = 4, 2
    A, mask, leaves, jb, tb = _pair(n, m, k, L, B, [0, 1])
    sX, sT = 1.7, 2.5
    U0 = np.linalg.svd(A * mask)[0][:, :k]
    V0 = U0.T @ (mask * A)
    kw = dict(X0=(U0 @ V0)[None], Y0=(U0 @ U0.T)[None], Th0=(V0.T @ V0)[None], U0=U0[None])
    ub = 0.5 * float(np.sum(mask * A * A))
    solve_j = jrelax.make_solver(n, m, k, L, GAMMA, iters=300, dtype=jnp.float64, omega=3.0,
                                 sX=sX, sT=sT)
    st_j = jrelax.init_state(B, n, m, k, L, jnp.float64, sX=sX, sT=sT, **kw)
    fin_j, out_j = solve_j(jnp.asarray(A), jnp.asarray(mask), jb, ub, st_j)
    opnorm = np.asarray(jrelax._estimate_opnorm(jb, n, m, k, sX, sT))
    solve_t = trelax.make_solver(n, m, k, L, GAMMA, iters=300, dtype=torch.float64, omega=3.0,
                                 sX=sX, sT=sT)
    st_t = trelax.init_state(B, n, m, k, L, torch.float64, device="cpu", sX=sX, sT=sT, **kw)
    for a, b in zip(st_t.leaves(), st_j):
        assert _rel(a.numpy(), b) <= 1e-15
    fin_t, out_t = solve_t(torch.as_tensor(A), torch.as_tensor(mask), tb, ub, st_t,
                           opnorm=torch.as_tensor(opnorm.copy()))
    for name, a, b in zip(jrelax.PDHGState._fields, fin_t.leaves(), fin_j):
        assert _rel(a.numpy(), b) <= 1e-8, name
    for key in ("X", "Y", "Th", "U", "y1", "y2", "ya", "yb", "yc"):
        assert _rel(out_t[key].numpy(), out_j[key]) <= 1e-8, key
    assert _rel(out_t["sep_w"].numpy(), out_j["sep_w"]) <= 1e-8
    # the host certificates of the two dual iterates agree
    lb_t = trelax.host_certified_bound(A, mask, tb, out_t, GAMMA, k, ub)
    lb_j = jrelax.host_certified_bound(A, mask, jb, {kk: np.asarray(v) for kk, v in
                                                      out_j.items()}, GAMMA, k, ub)
    assert np.all(np.abs(lb_t - lb_j) <= 1e-8 * np.maximum(1.0, np.abs(lb_j)))


def _dense_opnorm(tb, n, m, k, sX, sT):
    """The exact ||K|| of PDHG's operator on (X, symmetric Y, symmetric
    Theta, U), from its dense matrix in an orthonormal basis."""
    zeros = [torch.zeros(s, dtype=torch.float64) for s in ((1, n, m), (1, n, n), (1, m, m),
                                                           (1, n, k))]
    offs = trelax._forward(tb, *zeros, k, sX, sT)
    cm = tb.cut_mask

    def apply(z):
        ws = [w - o for w, o in zip(trelax._forward(tb, *z, k, sX, sT), offs)]
        ws[5], ws[6], ws[7] = ws[5] * cm[..., None], ws[6] * cm[..., None], ws[7] * cm
        return torch.cat([w.reshape(-1) for w in ws])

    cols = []
    for blk, d1, d2 in ((0, n, m), (1, n, n), (2, m, m), (3, n, k)):
        sym = blk in (1, 2)
        for i in range(d1):
            for j in range(i if sym else 0, d2):
                z = [t.clone() for t in zeros]
                if sym and i != j:
                    z[blk][0, i, j] = z[blk][0, j, i] = 2 ** -0.5
                else:
                    z[blk][0, i, j] = 1.0
                cols.append(apply(z))
    return float(torch.linalg.matrix_norm(torch.stack(cols, 1), ord=2))


@pytest.mark.parametrize("n_cuts", [0, 2])
def test_opnorm_estimate(n_cuts):
    """The port's power iteration (its own random start) is within 5% of
    omc's; at n = m = 4 it is at or above the exact ||K||."""
    n = m = 4
    k, L, B = 1, 4, 1
    sX, sT = 1.3, 2.0
    _, _, _, jb, tb = _pair(n, m, k, L, B, n_cuts, seed=3)
    est_t = trelax._estimate_opnorm(tb, n, m, k, sX, sT).numpy()
    est_j = np.asarray(jrelax._estimate_opnorm(jb, n, m, k, sX, sT))
    assert np.all(np.abs(est_t - est_j) <= 0.05 * est_j), (est_t, est_j)
    exact = _dense_opnorm(tb, n, m, k, sX, sT)
    assert est_t[0] >= exact, (est_t, exact)


def test_pdhg_weak_duality_root():
    """The certified bound of the port's PDHG duals lower-bounds a
    master-feasible objective (as tests/test_relax.py's PDHG case)."""
    n = m = 8
    k, L = 1, 4
    A, idx = generate_matrix_completion_data(k, n, m, int(round(0.6 * n * m)), 0)
    mask = idx.astype(np.float64)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(n)
    u /= np.linalg.norm(u)
    u = -u if u[-1] < 0 else u
    U = u[:, None]
    G = np.einsum("nk,nm,nl->mkl", U, mask, U) + (1 / GAMMA) * (U.T @ U)[None]
    V = np.linalg.solve(G, ((U.T @ (mask * A)).T)[..., None])[..., 0].T
    X = U @ V
    obj = 0.5 * float(np.sum(mask * (X - A) ** 2)) + (0.5 / GAMMA) * float(np.sum(X * X))
    ub_bar = obj * (1 + 1e-9)
    leaves = _batch_leaves(n, k, L, 1, 0, 0)
    tb = convert.node_batch_from_numpy(leaves, device="cpu")
    solve = trelax.make_solver(n, m, k, L, GAMMA, iters=300, dtype=torch.float64, omega=3.0)
    st = trelax.init_state(1, n, m, k, L, torch.float64, device="cpu")
    _, out = solve(torch.as_tensor(A), torch.as_tensor(mask), tb, ub_bar, st)
    lb = float(trelax.host_certified_bound(A, mask, tb, out, GAMMA, k, ub_bar)[0])
    assert -np.inf < lb <= obj + 1e-9


def _root_run(A, idx, **kw):
    kw = dict(_MAIN, sdp_method="pdhg", root_only=True, gap=1e-3, batch_size=4,
              sdp_iters=1500, sdp_iter_boost_max=1, dtype="float64", time_limit=120,
              verbosity=0, **kw)
    return kw


def test_pdhg_driver_root_matches_omc(monkeypatch):
    """A root-only driver run with sdp_method="pdhg" (1,500 iterations: one
    omc call).  With omc's operator-norm estimate patched into the port,
    the same objective and certified root bound as omc, 1e-6 relative;
    without the patch the bound is still sound (at or below the
    incumbent)."""
    A, idx = generate_matrix_completion_data(1, 8, 8, 40, seed=4)
    kw = _root_run(A, idx)
    sol_j, _, inst_j = omc_bnb(1, A, idx, 20.0, **kw)
    sol_u, _, inst_u = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **kw)
    lb_u = inst_u["run_log"][-1]["lower"]
    assert np.isfinite(lb_u) and lb_u <= sol_u["objective"] * (1 + 1e-9)
    assert inst_u["run_details"]["sdp_iters_total"] == 1500

    def omc_opnorm(batch, n, m, k, sX, sT, iters=20, seed=0):
        jb = jrelax.NodeBatch(*[jnp.asarray(x.numpy()) for x in batch.fields()])
        return torch.as_tensor(np.array(jrelax._estimate_opnorm(jb, n, m, k, sX, sT, iters,
                                                                seed)))

    monkeypatch.setattr(trelax, "_estimate_opnorm", omc_opnorm)
    sol_t, _, inst_t = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu", **kw)
    assert sol_t["objective"] == pytest.approx(sol_j["objective"], rel=1e-6)
    lb_t, lb_j = inst_t["run_log"][-1]["lower"], inst_j["run_log"][-1]["lower"]
    assert np.isfinite(lb_j)
    assert lb_t == pytest.approx(lb_j, rel=1e-6)


def test_pdhg_checkpoint_round_trip(tmp_path):
    """A PDHG branch-and-bound run that checkpoints after every super-step,
    resumed from its file: the resumed run continues the saved tree and
    certifies the same problem."""
    A, idx = generate_matrix_completion_data(1, 6, 6, 18, seed=1)
    path = str(tmp_path / "pdhg.ckpt")
    kw = dict(_MAIN, sdp_method="pdhg", gap=1e-2, batch_size=4, sdp_iters=300,
              sdp_iter_boost_max=1, dtype="float64", verbosity=0, checkpoint_path=path,
              checkpoint_every=0)
    _, _, inst1 = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu",
                                                   use_max_steps=True, max_steps=3, **kw)
    rd1 = inst1["run_details"]
    assert rd1["nodes_explored"] >= 1
    sol2, _, inst2 = matrix_completion_branchandbound(1, A, idx, 20.0, device="cpu",
                                                      resume=True, time_limit=60, **kw)
    rd2 = inst2["run_details"]
    assert rd2["nodes_explored"] >= rd1["nodes_explored"]
    assert inst2["run_log"][: len(inst1["run_log"])] == inst1["run_log"]
    lowers = [r["lower"] for r in inst2["run_log"] if np.isfinite(r["lower"])]
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    assert lowers[-1] <= sol2["objective"] * (1 + 1e-9)


def test_pdhg_state_family_and_wire_spec():
    """PDHG states take omc's leaf order in the warm-start slices and on
    the multi-process wire."""
    from omc_torch.solve import family_state, wire_state_spec

    st = family_state("pdhg", 3, 5, 6, 2, 4, None, torch.float64, "cpu", sX=1.5, sT=2.0,
                      sS=1.0, rho=0.1)
    assert isinstance(st, trelax.PDHGState)
    jst = jrelax.init_state(3, 5, 6, 2, 4, jnp.float64, sX=1.5, sT=2.0)
    assert [tuple(x.shape) for x in st.leaves()] == [tuple(np.shape(x)) for x in jst]
    spec = wire_state_spec("pdhg", 5, 6, 2, 3, 0, torch.float64)
    assert spec == [tuple(np.shape(x))[1:] for x in jrelax.init_state(1, 5, 6, 2, 8,
                                                                       jnp.float64)]
