"""The independent tightness oracle of tests/test_tightness.py, run against
the port: omc_torch's float64 CPU ADMM solvers and their float64 host
certificates must reach the interior-point optimum of the same node SDP
(base without cuts, base with one disjunctive cut, Shor k=1).

The interior-point solvers are imported from ``test_tightness`` (pytest
puts tests/ on ``sys.path``); they share no code with either ADMM solver.
The instances, iteration counts and tolerances are those of the originals.
"""

import numpy as np
import pytest
import torch

from test_tightness import solve_sdp_interior_point, solve_shor_sdp_interior_point

from omc_torch.data import generate_matrix_completion_data
from omc_torch.sdp.admm import init_admm_state, make_admm_solver
from omc_torch.sdp.admm_shor import (
    host_certified_bound_shor,
    init_shor_state,
    make_shor_solver,
    shor_batch_to_device,
)
from omc_torch.sdp.relax import NodeBatch, host_certified_bound
from omc_torch.sdp.shor import (
    generate_rank1_matrix_completion_Shor_constraints_indexes,
    shor_soc_complement,
)
from omc_torch.sdp.shor_encode import pack_shor_batch
from omc_torch.tree import root_box

torch.set_num_threads(2)
DT = torch.float64


def _batch(n, k, lo_box, hi_box, cuts):
    L = max(1, len(cuts))
    cut_x = np.zeros((1, L, n))
    cut_lo = np.zeros((1, L, k))
    cut_hi = np.zeros((1, L, k))
    cut_mask = np.zeros((1, L))
    for l, (cx, clo, chi) in enumerate(cuts):
        cut_x[0, l], cut_lo[0, l], cut_hi[0, l], cut_mask[0, l] = cx, clo, chi, 1.0
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=DT)  # noqa: E731
    return NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask), f(lo_box[None]),
                     f(hi_box[None])), L


def _admm_bound_and_primal(A, mask, gamma, k, cuts, iters=60000):
    """The port's float64 ADMM on the node, as tests/test_tightness.py runs
    omc's: (certified lower bound, primal objective of its iterate)."""
    n, m = A.shape
    lo_box, hi_box = root_box(n, k)
    batch, L = _batch(n, k, lo_box, hi_box, cuts)
    ub_bar = 0.5 * float(np.sum(mask * A * A))
    sX = max(1.0, float(np.abs(A).max()))
    # omc's rho=0.05 goes to the state here: the port's solver takes no rho
    solver = make_admm_solver(n, m, k, L, gamma, iters=iters, dtype=DT, check_every=iters,
                              ema_iters=4000)
    state = init_admm_state(1, n, m, k, L, DT, device="cpu", sX=sX, sT=1.0, rho=0.05)
    _, out = solver(torch.as_tensor(A, dtype=DT), torch.as_tensor(mask, dtype=DT), batch,
                    ub_bar, state)
    out = {key: val.numpy() for key, val in out.items()}
    lb = float(host_certified_bound(A, mask, batch, out, gamma, k, ub_bar)[0])
    X, Th = out["X"][0], out["Th"][0]
    primal = 0.5 * float(np.sum(mask * (X - A) ** 2)) + (0.5 / gamma) * float(np.trace(Th))
    return lb, primal


def _check_base(seed, cuts):
    n = m = 6
    k, gamma = 1, 10.0
    A, idx = generate_matrix_completion_data(k, n, m, 24, seed=seed)
    mask = idx.astype(np.float64)
    lo_box, hi_box = root_box(n, k)
    ip_obj, ip_gap = solve_sdp_interior_point(A, mask, gamma, k, lo_box, hi_box, cuts=cuts)
    lb, primal = _admm_bound_and_primal(A, mask, gamma, k, cuts)
    scale = max(1.0, abs(ip_obj))
    # soundness: the certified bound never exceeds the optimum (<= ip_obj)
    assert lb <= ip_obj + 1e-6 * scale
    # tightness: the bound reaches the optimum (catches silent weakening)
    assert lb >= ip_obj - ip_gap - 2e-3 * scale, (lb, ip_obj, ip_gap)
    assert abs(primal - ip_obj) <= 5e-3 * scale, (primal, ip_obj)


@pytest.mark.slow
def test_port_admm_bound_matches_interior_point_no_cuts():
    _check_base(0, [])


@pytest.mark.slow
def test_port_admm_bound_matches_interior_point_one_cut():
    n = 6
    rng = np.random.default_rng(0)
    cx = rng.standard_normal(n)
    cx /= np.linalg.norm(cx)
    # the strictly feasible cut region of the original (test_tightness.py)
    _check_base(1, [(cx, np.array([-1.0]), np.array([0.4]))])


@pytest.mark.slow
def test_port_shor_bound_matches_interior_point():
    n = m = 5
    gamma = 10.0
    A, idx = generate_matrix_completion_data(1, n, m, 20, seed=2)
    mask = idx.astype(np.float64)
    cand = generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    # minors disjoint in row pairs and column pairs, as the original picks
    minors, rows, cols = [], set(), set()
    for (i1, i2, j1, j2) in cand:
        if (i1, i2) in rows or (j1, j2) in cols:
            continue
        minors.append((i1, i2, j1, j2))
        rows.add((i1, i2))
        cols.add((j1, j2))
        if len(minors) == 2:
            break
    assert minors
    soc = shor_soc_complement(n, m, minors)
    lo_box, hi_box = root_box(n, 1)
    ip_obj, ip_gap = solve_shor_sdp_interior_point(A, mask, gamma, lo_box, hi_box, minors, soc)

    M5, Ms = 4, n * m
    batch, L = _batch(n, 1, lo_box, hi_box, [])
    sbh = pack_shor_batch(n, m, [minors], [soc], M5, Ms)
    sb = shor_batch_to_device(sbh, DT, device="cpu")
    ub_bar = 0.5 * float(np.sum(mask * A * A))
    solver = make_shor_solver(n, m, L, M5, Ms, gamma, iters=80000, dtype=DT,
                              check_every=80000, ema_iters=4000, psd_method="eigh")
    st0 = init_shor_state(1, n, m, 1, L, M5, Ms, DT, device="cpu",
                          sX=max(1.0, float(np.abs(A).max())), rho=0.05)
    _, out = solver(torch.as_tensor(A, dtype=DT), torch.as_tensor(mask, dtype=DT), batch, sb,
                    ub_bar, st0)
    out = {key: val.numpy() for key, val in out.items()}
    lb = float(host_certified_bound_shor(A, mask, batch, sbh, out, gamma, ub_bar)[0])
    scale = max(1.0, abs(ip_obj))
    assert lb <= ip_obj + 1e-6 * scale
    assert lb >= ip_obj - ip_gap - 5e-3 * scale, (lb, ip_obj, ip_gap)
