"""Standalone per-node entry points (port of ``omc/api.py``).

The reference exports ``alternating_minimization`` and
``matrix_completion_SDP_relaxation`` (`src/OptimalMatrixCompletion.jl:21-25`)
so a user can run the upper-bound heuristic or one node's relaxation outside
the branch-and-bound driver.  Each call packs one node (a batch of 1), runs
the batched solver of its family (base, Shor k = 1, Shor k > 1, McCormick)
and returns a dict with the reference's keys, as ``omc.api`` does.

Both run on the GPU (``device="cuda"``, the kernels) unless the caller
asks for ``device="cpu"`` (the plain versions); without a GPU the default
raises.  Their default dtype is ``omc``'s float64: on the GPU every
family (base, Shor k = 1 and k > 1, McCormick) runs it through the float64
builds of its kernels (K2-K6, K7, K8a, K8b, K7t, K7x, K8c, K8d, K9s, K9a,
K9b; exact Jacobi projections, as ``omc``'s eigh route).

What runs on the GPU, in float32 and float64: every family at every rank
and width ``omc`` takes, within the card's memory (CUDA's out-of-memory
error where a node does not fit; past shared memory K3 reads U from the
input and K2 keeps its band of zU in U's rows).  Altmin and the base family
(K6's wide path past k = 10), Shor k = 1, rank-k Shor at every k >= 2 (K7t
at any k, K7x's, K8c's and K8d's wide kernels past k = 4), and McCormick
at every rank (K9s, K9a and K9b's wide kernels at k >= 4 or n + m > 4096),
past n + m = 46,340 too, where a node's (n + m)^2 entries pass 2^31 and
the kernels index them in 64 bits.  ``kernels.require_cuda_shape`` refuses
only an unknown family or a shape below 1, before any allocation on the
card.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from omc_torch import kernels
from omc_torch.problem import compute_SDP_relaxation_objective
from omc_torch.solve import _cut_interval_arrays, _pack_batch, entry_device
from omc_torch.tree import BBNode, root_box


def _dtypes(dtype: str):
    return (torch.float64, np.float64) if dtype == "float64" else (torch.float32, np.float32)


def alternating_minimization(
    A: np.ndarray,
    n: int,
    k: int,
    indices: np.ndarray,
    gamma: float,
    use_disjunctive_cuts: bool = True,
    *,
    disjunctive_cuts_type: Optional[str] = None,
    U_initial: np.ndarray,
    U_lower: Optional[np.ndarray] = None,
    U_upper: Optional[np.ndarray] = None,
    disjunctive_cuts: Sequence = (),
    eps: float = 1e-5,
    max_iters: int = 100,
    dtype: str = "float64",
    device="cuda",
) -> dict:
    """Alternating minimisation from ``U_initial`` (reference lines
    1979-2279).  Returns ``{"converged", "U", "V", "solve_time", "n_iters",
    "max_iters", "objectives"}`` as the reference (lines 2249-2278).
    ``disjunctive_cuts`` entries are ``DisjunctiveCut``-like objects: the
    U-step then projects onto the node's cut intervals."""
    from omc_torch.altmin import make_altmin

    dev = entry_device(device, dtype)
    tdtype, _ = _dtypes(dtype)
    A = np.asarray(A, dtype=np.float64)
    mask = np.asarray(indices).astype(np.float64)
    m = A.shape[1]
    if dev.type == "cuda":  # before any allocation on the card
        kernels.require_cuda_shape("base", k, n, m)
    if U_lower is None or U_upper is None:
        lo_d, hi_d = root_box(n, k)
        U_lower = lo_d if U_lower is None else U_lower
        U_upper = hi_d if U_upper is None else U_upper

    def T(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev).to(tdtype)[None]

    t0 = time.time()
    cx, clo, chi, cmask = _cut_interval_arrays(list(disjunctive_cuts), disjunctive_cuts_type,
                                               n, k)
    fn = make_altmin(n, m, k, gamma, max_iters=max_iters, tol=eps, dtype=tdtype)
    res = fn(T(A)[0], T(mask)[0], T(U_initial), T(U_lower), T(U_upper),
             cut_x=T(cx), cut_lo=T(clo), cut_hi=T(chi), cut_mask=T(cmask))
    n_it = int(res.n_iters[0])
    trace = res.obj_trace[0].cpu().numpy().astype(np.float64)[:n_it]
    objectives = [float(v) for v in trace if np.isfinite(v)]
    if not objectives:
        objectives = [float(res.objective[0])]
    return {
        "converged": bool(res.converged[0]),
        "U": res.U[0].cpu().numpy().astype(np.float64),
        "V": res.V[0].cpu().numpy().astype(np.float64),
        "solve_time": time.time() - t0,
        "n_iters": n_it,
        "max_iters": max_iters,
        "objectives": objectives,
    }


def matrix_completion_SDP_relaxation(
    node: BBNode,
    n: int,
    k: int,
    A: np.ndarray,
    indices: np.ndarray,
    gamma: float,
    use_disjunctive_cuts: bool = True,
    *,
    disjunctive_cuts_type: Optional[str] = None,
    add_Shor_valid_inequalities: bool = False,
    iters: int = 2000,
    dtype: str = "float64",
    ub_bar: Optional[float] = None,
    device="cuda",
) -> dict:
    """Solve one node's SDP relaxation (reference lines 1431-1943).

    Returns ``{"feasible", "objective", "lower_bound", "Y", "U", "X",
    "Theta", "solve_time", "sep_w", "sep_V"}`` (and ``"W"`` with Shor):
    ``objective`` is the relaxation objective at the primal solution,
    ``lower_bound`` the certified safe Lagrangian dual bound (float64, on the
    host).  ``ub_bar`` caps the certification's kept sets; it defaults to
    the objective at X = 0."""
    dev = entry_device(device, dtype)
    tdtype, np_dtype = _dtypes(dtype)
    A = np.asarray(A, dtype=np.float64)
    mask = np.asarray(indices).astype(np.float64)
    m = A.shape[1]
    if dev.type == "cuda":  # before any allocation on the card
        family = ("mccormick" if not use_disjunctive_cuts
                  else ("shor" if k == 1 else "shor_k") if add_Shor_valid_inequalities
                  else "base")
        kernels.require_cuda_shape(family, k, n, m)
    if ub_bar is None:
        ub_bar = 0.5 * float(np.sum(mask * A * A))  # objective at X = 0
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = max(1.0, 2.0 * gamma * ub_bar / (4.0 * m))

    def T(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(tdtype)

    A_dev, mask_dev = T(A), T(mask)
    t0 = time.time()
    W = None
    if not use_disjunctive_cuts:
        from omc_torch.sdp.mccormick import (
            MCBatch,
            host_certified_bound_mc,
            init_mc_state,
            make_mccormick_solver,
        )

        solve = make_mccormick_solver(n, m, k, gamma, iters=iters, dtype=tdtype)
        state0 = init_mc_state(1, n, m, k, tdtype, device=dev, sX=sX, sT=sT, rho=10.0)
        batch = MCBatch(T(node.U_lower[None]), T(node.U_upper[None]))
        _, out = solve(A_dev, mask_dev, batch, ub_bar, state0)
        out = {key: val.cpu().numpy() for key, val in out.items()}
        lbs = host_certified_bound_mc(A, mask, node.U_lower[None], node.U_upper[None], out,
                                      gamma, k, ub_bar)
    else:
        L = max(1, len(node.cuts or []))
        batch = _pack_batch([node], 1, L, n, k, disjunctive_cuts_type, np_dtype)
        if add_Shor_valid_inequalities:
            M5 = max(1, len(node.Shor_info.constraints_indexes))
            minors = [node.Shor_info.constraints_indexes]
            socs = [node.Shor_info.SOC_constraints_indexes]
            if k == 1:
                from omc_torch.sdp.admm_shor import (
                    host_certified_bound_shor,
                    init_shor_state,
                    make_shor_solver,
                )
                from omc_torch.sdp.shor_encode import pack_shor_batch

                sbh = pack_shor_batch(n, m, minors, socs, M5, n * m)
                solve = make_shor_solver(n, m, L, M5, n * m, gamma, iters=iters, dtype=tdtype)
                state0 = init_shor_state(1, n, m, k, L, M5, n * m, tdtype, device=dev,
                                         sX=sX, sT=sT)
                _, out = solve(A_dev, mask_dev, batch, sbh, ub_bar, state0)
                out = {key: val.cpu().numpy() for key, val in out.items()}
                lbs = host_certified_bound_shor(A, mask, batch, sbh, out, gamma, ub_bar)
            else:
                # rank-k Xt-split path (reference lines 1491-1551, 1781-1828)
                from omc_torch.sdp.shor_k import (
                    host_certified_bound_shor_k,
                    init_shor_k_state,
                    make_shor_k_solver,
                    pack_shor_k_batch,
                )

                sbh = pack_shor_k_batch(n, m, minors, socs, M5, n * m)
                solve = make_shor_k_solver(n, m, k, L, M5, n * m, gamma, iters=iters,
                                           dtype=tdtype)
                state0 = init_shor_k_state(1, n, m, k, L, M5, n * m, tdtype, device=dev,
                                           sX=sX, sT=sT)
                _, out = solve(A_dev, mask_dev, batch, sbh, ub_bar, state0)
                out = {key: val.cpu().numpy() for key, val in out.items()}
                lbs = host_certified_bound_shor_k(A, mask, batch, sbh, out, gamma, k, ub_bar)
            W = out["W"][0].astype(np.float64)
        else:
            from omc_torch.sdp.admm import init_admm_state, make_admm_solver
            from omc_torch.sdp.relax import host_certified_bound

            solve = make_admm_solver(n, m, k, L, gamma, iters=iters, dtype=tdtype)
            state0 = init_admm_state(1, n, m, k, L, tdtype, device=dev, sX=sX, sT=sT,
                                     rho=0.03)
            _, out = solve(A_dev, mask_dev, batch, ub_bar, state0)
            out = {key: val.cpu().numpy() for key, val in out.items()}
            lbs = host_certified_bound(A, mask, batch, out, gamma, k, ub_bar)
    solve_time = time.time() - t0

    X = out["X"][0].astype(np.float64)
    Y = out["Y"][0].astype(np.float64)
    Th = out["Th"][0].astype(np.float64)
    U = out["U"][0].astype(np.float64)
    objective = float(compute_SDP_relaxation_objective(
        X, Y, Th, U, A, mask > 0, gamma,
        add_Shor_valid_inequalities=add_Shor_valid_inequalities, W=W,
    ))
    results = {
        "feasible": True,
        "objective": objective,
        "lower_bound": float(lbs[0]),
        "Y": Y,
        "U": U,
        "X": X,
        "Theta": Th,
        "solve_time": solve_time,
        "sep_w": out["sep_w"][0].astype(np.float64),
        "sep_V": out["sep_V"][0].astype(np.float64),
    }
    if W is not None:
        results["W"] = W
    return results


__all__ = ["alternating_minimization", "matrix_completion_SDP_relaxation"]
