"""Branch-and-bound driver — the public entry point (port of the
single-device and multi-process paths of ``omc/solve.py``).

Up to ``batch_size`` frontier nodes are popped per super-step (best-first
or breadth-first), relaxed together by the batched ADMM solver on one
device, certified on the host in float64, then closed, pruned, refined or
split into 2^k / 3^k / 4^k children (linear / linear2 / linear3 cuts)
along the most negative eigenvector of ``U U' - Y`` (or the blend of the
two most negative, ``smallest_2_eigvec``).  Alternating minimisation supplies upper bounds (multi-
restart at the root, probability-gated at tree nodes); master-feasible
relaxation points are rounded to exact rank-k incumbents.  With
``add_Shor_valid_inequalities`` every node also carries its 2x2 minors
(static, or grown from the top-scoring violated ones at refinement stalls
and at child creation, scored per term over the Xt split when k > 1) and
the Shor solver relaxes it: ``omc_torch.sdp.admm_shor`` for k = 1,
``omc_torch.sdp.shor_k`` for k > 1.  With ``use_disjunctive_cuts=False``
the McCormick path runs instead (``omc_torch.sdp.mccormick``): first visits
are screened for relaxation feasibility on the host (interval test, then
the envelope LP), master feasibility is the reference's oracle, and a split
bisects the widest U interval.  ``checkpoint_path`` saves the tree, the
incumbent, the census and the RNG state every ``checkpoint_every`` seconds
and at the end; ``resume=True`` continues from that file.  With
``distributed=True`` every process of the gloo group
(``omc_torch.parallel.dist.init_distributed``) runs this driver on its own
frontier shard: the root starts on process 0, bounds are fused every
super-step and surplus nodes migrate every ``dist_rebalance_every`` rounds,
warm with their solver-state slices unless ``dist_migrate_state=False``;
checkpoints go to one file a process (``<checkpoint_path>.proc<i>``).

Soundness notes (as in ``omc``):

- Lower bounds are safe Lagrangian dual bounds (valid at any solver
  accuracy), monotone down the tree via max(parent LB, computed LB).
- A node whose relaxation solution is master-feasible
  (lambda_min(UU' - Y) >= -1e-6, reference line 1274) is rounded to an
  exactly evaluated rank-k incumbent; it is closed only if its local gap is
  within the target, and its certified LB then caps the reported global
  lower bound (``tree.closed_lb_floor``).
- The 11-category node census (reference lines 411-454) keeps the
  reference's keys.

The device is chosen once, by the ``device`` argument, ``"cuda"`` unless
the caller asks for ``"cpu"``.  On a CUDA device the solver runs float32
through the hand-written kernels (``omc_torch/csrc``): K1-K3 on the base
path, K2, K8a, K3, K1, K7, K8b on the rank-1 Shor path, K2, K8c, K3, K1,
K7t, K7x, K8d on the rank-k Shor path, and K9s, K9a, K9b, K1 on the
McCormick path.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from omc_torch import kernels
from omc_torch.altmin import make_altmin
from omc_torch.branch import create_matrix_cut_child_nodes, create_mccormick_child_nodes
from omc_torch.config import SolverConfig
from omc_torch.problem import compute_MSE
from omc_torch.sdp import shor as shor_mod
from omc_torch.sdp.admm import (
    ADMMState,
    apply_best_duals,
    init_admm_state,
    make_admm_solver,
    set_slot_rho,
    to_numpy_out,
)
from omc_torch.sdp.admm_shor import (
    ShorADMMState,
    host_certified_bound_shor,
    init_shor_state,
    make_shor_solver,
)
from omc_torch.sdp.admm_shor import apply_best_duals as apply_shor_best_duals
from omc_torch.sdp.cuts import region_bounds
from omc_torch.sdp.mccormick import (
    MCBatch,
    MCState,
    host_certified_bound_mc,
    init_mc_state,
    make_mccormick_solver,
    master_feasible_mccormick,
    mccormick_box_feasible,
    mccormick_lp_feasible,
)
from omc_torch.sdp.relax import (
    NodeBatch,
    apply_warm_slices,
    host_certified_bound,
    host_state_slice,
    state_to_host,
)
from omc_torch.sdp.shor_encode import pack_shor_batch
from omc_torch.sdp.shor_k import (
    ShorKState,
    host_certified_bound_shor_k,
    init_shor_k_state,
    make_shor_k_solver,
    pack_shor_k_batch,
)
from omc_torch.sdp.shor_k import apply_best_duals as apply_shor_k_best_duals
from omc_torch.tree import BBNode, BBTree, ShorInfo, compute_gap, root_box
from omc_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from omc_torch.utils.logging import (
    UPDATE_HEADER,
    add_message,
    alternating_minimization_printout,
    update_row,
)

_L_BUCKETS = (8, 32, 128, 512, 2048)
_M5_BUCKETS = (64, 256, 1024, 4096)


def _l_bucket(need: int) -> int:
    for b in _L_BUCKETS:
        if need <= b:
            return b
    raise ValueError(f"cut count {need} exceeds the largest supported bucket")


def _m5_bucket(need: int) -> int:
    for b in _M5_BUCKETS:
        if need <= b:
            return b
    raise ValueError(f"Shor minor count {need} exceeds the largest bucket")


def family_state(family: str, Bb: int, n: int, m: int, k: int, L: int, M5, dtype, device,
                 **kw):
    """The initial solver state of ``family`` ("admm", "shor", "shor_k" or
    "mccormick") at batch ``Bb``, ``L`` cut rows and ``M5`` minor slots
    (the Shor families)."""
    if family == "mccormick":
        kw.pop("sS", None)
        return init_mc_state(Bb, n, m, k, dtype, device=device, **kw)
    if family == "shor_k":
        return init_shor_k_state(Bb, n, m, k, L, M5, n * m, dtype, device=device, **kw)
    if family == "shor":
        return init_shor_state(Bb, n, m, k, L, M5, n * m, dtype, device=device, **kw)
    return init_admm_state(Bb, n, m, k, L, dtype, device=device, **kw)


def wire_state_spec(family: str, n: int, m: int, k: int, Lmax: int, Mmax: int, dtype):
    """Per-node solver-state leaf shapes for the rebalancing wire (batch
    axis stripped), from a batch-of-one state on the meta device: no
    allocation.  Deterministic in (family, shapes, Lmax, Mmax), so every
    process derives the same spec from the fused RoundState."""
    Lb = _l_bucket(max(1, Lmax))
    M5b = _m5_bucket(max(1, Mmax)) if family in ("shor", "shor_k") else None
    st = family_state(family, 1, n, m, k, Lb, M5b, dtype, "meta")
    return [tuple(leaf.shape[1:]) for leaf in st.leaves()]


def _with_minors(n, m, minors) -> ShorInfo:
    return ShorInfo(constraints_indexes=minors,
                    SOC_constraints_indexes=shor_mod.shor_soc_complement(n, m, minors))


def _b_bucket(need: int, B: int) -> int:
    """Smallest batch bucket >= need (powers of 4 up to the configured batch
    size): when the frontier underfills the batch, the solve runs at the
    tight bucket."""
    for b in (1, 4, 16, 64, 256, 1024):
        if b >= B:
            break
        if need <= b:
            return b
    return B


def _cut_interval_arrays(cuts, cuts_type: Optional[str], n: int, k: int,
                         dtype=np.float64):
    """Pack one node's cut list into (x, lo, hi, mask) interval arrays with
    leading dim max(1, len(cuts)) — the altmin U-step projection's input
    (reference's per-cut v-interval constraints, lines 2048-2092)."""
    L = max(1, len(cuts))
    cx = np.zeros((L, n), dtype=dtype)
    clo = -np.ones((L, k), dtype=dtype)
    chi = np.ones((L, k), dtype=dtype)
    cm = np.zeros((L,), dtype=dtype)
    for l, cut in enumerate(cuts):
        cx[l] = cut.x
        lo, hi = region_bounds(cuts_type, cut.code, cut.vhat)
        clo[l], chi[l] = lo, hi
        cm[l] = 1.0
    return cx, clo, chi, cm


def _pack_batch(nodes: List[BBNode], B: int, L: int, n: int, k: int,
                cuts_type: Optional[str], dtype) -> NodeBatch:
    """Host (numpy) node batch: padded cut tensors and U boxes."""
    cut_x = np.zeros((B, L, n), dtype=dtype)
    cut_lo = np.zeros((B, L, k), dtype=dtype)
    cut_hi = np.zeros((B, L, k), dtype=dtype)
    cut_mask = np.zeros((B, L), dtype=dtype)
    U_lo = np.zeros((B, n, k), dtype=dtype)
    U_hi = np.zeros((B, n, k), dtype=dtype)
    for i, node in enumerate(nodes):
        U_lo[i] = node.U_lower
        U_hi[i] = node.U_upper
        if node.cuts:
            pc = node.packed_cuts
            if pc is None or pc[0].shape[0] != len(node.cuts):
                Lc = len(node.cuts)
                px = np.empty((Lc, n))
                plo = np.empty((Lc, k))
                phi = np.empty((Lc, k))
                for l, cut in enumerate(node.cuts):
                    px[l] = cut.x
                    lo, hi = region_bounds(cuts_type, cut.code, cut.vhat)
                    plo[l], phi[l] = lo, hi
                node.packed_cuts = pc = (px, plo, phi)
            Lc = pc[0].shape[0]
            cut_x[i, :Lc] = pc[0]
            cut_lo[i, :Lc] = pc[1]
            cut_hi[i, :Lc] = pc[2]
            cut_mask[i, :Lc] = 1.0
    return NodeBatch(cut_x, cut_lo, cut_hi, cut_mask, U_lo, U_hi)


def _np_objective(X, A, mask, gamma):
    """Exact objective in numpy float64."""
    fit = 0.5 * float(np.sum(mask * (X - A) ** 2))
    return fit + (0.5 / gamma) * float(np.sum(X * X))


def _polish_incumbent(X0, A, mask, gamma, k, iters=25):
    """Host float64 polish of an incumbent candidate: closed-form
    alternating ridge steps from X0, then SVD re-orthonormalisation and the
    exact objective.  At a 1e-4 target the incumbent's last ~1e-5 decides
    whether the root bound can close the gap, so this runs in float64."""
    X = np.asarray(X0, dtype=np.float64)
    if not np.all(np.isfinite(X)):
        # a diverged relaxation iterate is an unusable candidate
        return np.inf, np.zeros_like(np.asarray(A)), np.zeros(
            (np.asarray(A).shape[0], k)
        )
    U = np.linalg.svd(X, full_matrices=False)[0][:, :k]
    eye_k = 1e-12 * np.eye(k)
    best_obj, best_X = np.inf, X
    for _ in range(iters):
        G = np.einsum("nk,nm,nl->mkl", U, mask, U) + (1.0 / gamma) * (U.T @ U)[None]
        rhs = (U.T @ (mask * A)).T
        V = np.linalg.solve(G + eye_k, rhs[..., None])[..., 0].T  # (k, m)
        H = np.einsum("km,nm,lm->nkl", V, mask, V) + (1.0 / gamma) * (V @ V.T)[None]
        rhs_u = (mask * A) @ V.T
        U_new = np.linalg.solve(H + eye_k, rhs_u[..., None])[..., 0]  # (n, k)
        X = U_new @ V
        obj = _np_objective(X, A, mask, gamma)
        if obj < best_obj - 1e-14:
            best_obj, best_X = obj, X
        U = U_new
    best_U = np.linalg.svd(best_X, full_matrices=False)[0][:, :k]
    return best_obj, best_X, best_U


def _round_to_incumbent(Y, A, mask, gamma, k):
    """Orthonormal U from the top-k eigenvectors of Y + exact closed-form
    V-step -> (objective, X, U), a valid rank-k upper bound."""
    Y = np.asarray(Y, dtype=np.float64)
    if not np.all(np.isfinite(Y)):
        return np.inf, np.zeros_like(np.asarray(A)), np.zeros((Y.shape[0], k))
    w, V = np.linalg.eigh(0.5 * (Y + Y.T))
    U = V[:, ::-1][:, :k]  # top-k eigvecs
    G = np.einsum("nk,nm,nl->mkl", U, mask, U) + (1.0 / gamma) * (U.T @ U)[None]
    G += 1e-12 * np.eye(k)[None]
    rhs = (U.T @ (mask * A)).T
    Vv = np.linalg.solve(G, rhs[..., None])[..., 0]  # (m, k)
    X = U @ Vv.T
    obj = _np_objective(X, A, mask, gamma)
    return obj, X, U


def _decayed_probability(depth, max_p, min_p, decay):
    if depth > np.log(max_p / min_p) / np.log(decay):
        return min_p
    return max_p / (decay**depth)


def entry_device(device, dtype: str) -> torch.device:
    """The device of an entry point: ``"cuda"`` (the kernels; float32 only)
    unless the caller asks for ``"cpu"`` (the plain versions).  A CUDA
    request without a usable GPU raises; it never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but no CUDA device is available; "
                'pass device="cpu" to run the plain versions on the CPU'
            )
        if dtype != "float32":
            raise ValueError('the CUDA path runs dtype="float32" only')
        kernels.set_full_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def matrix_completion_branchandbound(
    k: int,
    A: np.ndarray,
    indices: np.ndarray,
    gamma: float,
    *,
    device="cuda",
    **kwargs,
):
    """Complete matrix ``A`` (observed mask ``indices``) with a rank-``k``
    matrix to certified optimality.  Returns ``(solution, printlist,
    instance)`` with the field contract of ``omc.solve``.

    ``device``: where the relaxations run, ``"cuda"`` (the default: the
    kernels; needs ``dtype="float32"``) or ``"cpu"`` (the plain versions,
    only when asked for).  Without a GPU the default raises."""
    cfg = SolverConfig(**kwargs)
    dev = entry_device(device, cfg.dtype)

    A = np.asarray(A, dtype=np.float64)
    indices = np.asarray(indices)
    if A.shape != indices.shape:
        raise ValueError(
            "Dimension mismatch. Input matrix A must have size (n, m); "
            "input matrix indices must have size (n, m)."
        )
    n, m = A.shape
    if not n <= m:
        raise ValueError(
            f"Input matrix A must have size (n, m) with n <= m. Current size is {A.shape}."
        )
    use_mccormick = not cfg.use_disjunctive_cuts
    # the McCormick path relaxes no Shor minors (omc's McCormick arm takes
    # precedence over its Shor arm)
    use_shor = cfg.add_Shor_valid_inequalities and not use_mccormick
    # k > 1 uses the Xt-split Shor relaxation (omc_torch.sdp.shor_k)
    use_shor_k = use_shor and k > 1
    family = ("mccormick" if use_mccormick else "shor_k" if use_shor_k
              else "shor" if use_shor else "admm")

    mask = indices.astype(np.float64)
    rng = np.random.default_rng(cfg.seed)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    np_dtype = np.float64 if cfg.dtype == "float64" else np.float32
    # ADMM penalty: explicit knob wins; otherwise size- and density-scaled
    # exactly as omc (solve.py:328-336 there, flagged in ROADMAP section 3:
    # the density factor has no floor at 1)
    frac_obs = float(mask.mean()) if mask.size else 1.0
    rho_base = (
        cfg.sdp_rho if cfg.sdp_rho is not None
        else min(
            0.05,
            (62.5 / float(n * m))
            * min(2.0, 0.5 / max(frac_obs, 1e-6)),
        )
    )
    verbosity = cfg.verbosity

    printlist: List[str] = []
    start_time = time.time()
    echo = verbosity >= 1
    add_message(printlist, [
        "Starting branch-and-bound on a matrix completion problem.\n",
        f"k:                                              {k:15d}\n",
        f"m:                                              {m:15d}\n",
        f"n:                                              {n:15d}\n",
        f"num_indices:                                    {int(indices.sum()):15d}\n",
        f"gamma:                                          {gamma:15g}\n",
        "\n",
        f"Node selection:                                 {cfg.node_selection:>15s}\n",
        f"Optimality gap:                                 {cfg.gap:15g}\n",
        f"Use disjunctive cuts?:                          {str(cfg.use_disjunctive_cuts):>15s}\n",
        f"Disjunctive cuts type:                          {str(cfg.disjunctive_cuts_type):>15s}\n",
        f"Disjunction breakpoints:                        {str(cfg.disjunctive_cuts_breakpoints):>15s}\n",
        f"Time limit (s):                                 {cfg.time_limit:15d}\n",
        f"{'Batch size (' + dev.type + '):':48s}{cfg.batch_size:15d}\n",
        f"{'ADMM iterations:':48s}{cfg.sdp_iters:15d}\n",
    ], echo=echo)

    run_log: List[dict] = []
    solve_time_altmin = 0.0
    solve_time_relaxation = 0.0
    solve_time_relaxation_feasibility = 0.0
    # phase split: device solver wall (incl. host<->device transfer), host
    # float64 certification, host incumbent polish, solver iterations issued
    solve_time_device = 0.0
    solve_time_certify = 0.0
    solve_time_polish = 0.0
    sdp_iters_total = 0
    device_steps = 0
    # Shor path: the largest active minor count of any relaxed node, and
    # the growth rounds applied (at refinement stalls and to children)
    shor_minors_max = 0
    shor_growths = 0
    nodes_closed_within_gap = 0
    dict_solve_times_altmin: List[dict] = []
    dict_num_iterations_altmin: List[dict] = []
    dict_solve_times_relaxation: List[dict] = []

    census = {
        "nodes_dominated": 0,
        "nodes_relax_infeasible": 0,
        "nodes_relax_feasible": 0,
        "nodes_relax_feasible_pruned": 0,
        "nodes_master_feasible": 0,
        "nodes_master_feasible_improvement": 0,
        "nodes_relax_feasible_split": 0,
        "nodes_relax_feasible_split_altmin": 0,
        "nodes_relax_feasible_split_altmin_improvement": 0,
    }

    A_dev = torch.as_tensor(A, dtype=dtype, device=dev)
    mask_dev = torch.as_tensor(mask, dtype=dtype, device=dev)

    def T(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    # ------------------------------------------------------------------
    # Root alternating-minimisation warm start (reference lines 521-601)
    # ------------------------------------------------------------------
    altmin_start = time.time()
    U_base = np.linalg.svd(A * mask, full_matrices=False)[0][:, :k]
    sc = float(np.max(np.abs(U_base)))
    n_runs = cfg.altmin_root_n_iters
    U_inits = np.stack(
        [U_base] + [U_base + sc * rng.standard_normal((n, k)) for _ in range(n_runs - 1)]
    )
    root_lo, root_hi = root_box(n, k)
    B = cfg.batch_size
    altmin_fn = make_altmin(
        n, m, k, gamma, max_iters=cfg.altmin_max_iters, tol=cfg.altmin_tol,
        dtype=dtype,
    )

    def _fetch(r, rows):
        return (r.U.cpu().numpy().astype(np.float64)[rows],
                r.V.cpu().numpy().astype(np.float64)[rows],
                r.converged.cpu().numpy()[rows],
                r.n_iters.cpu().numpy()[rows],
                r.obj_trace.cpu().numpy().astype(np.float64)[rows])

    def run_altmin(U_init_batch: np.ndarray):
        """Run altmin on the given initialisations, padding to the tight
        batch bucket (chunking if more than cfg.batch_size)."""
        outs = []
        total = U_init_batch.shape[0]
        for s0 in range(0, total, B):
            chunk = U_init_batch[s0 : s0 + B]
            Ba = _b_bucket(chunk.shape[0], B)
            pad = np.repeat(chunk[-1:], Ba - chunk.shape[0], axis=0)
            full = np.concatenate([chunk, pad], axis=0)
            lo_b = T(np.broadcast_to(root_lo, (Ba, n, k)))
            hi_b = T(np.broadcast_to(root_hi, (Ba, n, k)))
            r = altmin_fn(A_dev, mask_dev, T(full), lo_b, hi_b)
            outs.append(_fetch(r, slice(0, chunk.shape[0])))
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))

    res_U, res_V, _, _, _ = run_altmin(U_inits)
    t_root_altmin = time.time() - altmin_start
    solve_time_altmin += t_root_altmin
    dict_solve_times_altmin.append({"node_id": 0, "depth": 0, "solve_time": t_root_altmin})

    best_obj = np.inf
    X_initial = U_initial = None
    for i in range(n_runs):
        # float64 host polish: the device altmin runs in the compute dtype
        obj_i, X_i, U_i = _polish_incumbent(res_U[i] @ res_V[i], A, mask, gamma, k)
        if obj_i < best_obj:
            best_obj, X_initial, U_initial = obj_i, X_i, U_i
        add_message(printlist, [
            "Altmin run %02d: \t Objective %e in %3.3f s.\n"
            % (i + 1, obj_i, time.time() - altmin_start)
        ], echo=echo)

    Y_initial = U_initial @ U_initial.T
    objective_initial = best_obj
    MSE_in_initial = float(compute_MSE(X_initial, A, mask, kind="in"))
    MSE_out_initial = float(compute_MSE(X_initial, A, mask, kind="out"))
    MSE_all_initial = float(compute_MSE(X_initial, A, mask, kind="all"))
    objective_initial_time_found = time.time() - start_time

    solution: Dict = {
        "objective_initial": objective_initial,
        "objective_initial_time_found": objective_initial_time_found,
        "MSE_in_initial": MSE_in_initial,
        "MSE_out_initial": MSE_out_initial,
        "MSE_all_initial": MSE_all_initial,
        "Y_initial": Y_initial,
        "U_initial": U_initial,
        "X_initial": X_initial,
        "objective": objective_initial,
        "objective_time_found": objective_initial_time_found,
        "MSE_in": MSE_in_initial,
        "MSE_out": MSE_out_initial,
        "MSE_all": MSE_all_initial,
        "Y": Y_initial,
        "U": U_initial,
        "X": X_initial,
    }

    incumbent_ver = {"v": 0}

    def update_solution(obj, Y, U, X, t_found):
        solution["objective"] = obj
        solution["objective_time_found"] = t_found
        solution["Y"] = np.array(Y)
        solution["U"] = np.array(U)
        solution["X"] = np.array(X)
        incumbent_ver["v"] += 1  # invalidate warm-start templates

    # ------------------------------------------------------------------
    # Tree initialisation (reference lines 626-698)
    # ------------------------------------------------------------------
    root_shor = None
    if use_shor:
        if not cfg.add_Shor_valid_inequalities_iterative:
            all_minors = shor_mod.generate_rank1_matrix_completion_Shor_constraints_indexes(
                indices, list(cfg.Shor_valid_inequalities_noisy_rank1_num_entries_present),
            )
            frac = cfg.add_Shor_valid_inequalities_fraction
            if frac is not None and frac < 1.0:
                keep = rng.random(len(all_minors)) < frac
                all_minors = [mm for mm, kp in zip(all_minors, keep) if kp]
            root_shor = _with_minors(n, m, all_minors)
        else:
            root_shor = ShorInfo(
                constraints_indexes=[],
                SOC_constraints_indexes=[(i, j) for i in range(n) for j in range(m)],
            )
    root = BBNode(
        node_id=1, parent_id=0, U_lower=root_lo, U_upper=root_hi,
        LB=-np.inf, depth=0, cuts=[], Shor_info=root_shor,
    )
    tree = BBTree(root, best_upper_bound=objective_initial)
    # resume (not in the reference, which loses the tree on timeout):
    # warm-start states are not checkpointed, so resumed nodes get a fresh
    # refinement budget
    resumed = bool(cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path))
    if resumed:
        payload = load_checkpoint(cfg.checkpoint_path)
        tree = payload["tree"]
        for nd in tree.nodes.values():
            nd.refines = 0
            nd.behind_streak = 0
        solution.update(payload["solution"])
        census.update(payload["census"])
        run_log.extend(payload["run_log"])
        rng.bit_generator.state = payload["rng_state"]
        add_message(printlist, [
            f"Resumed from checkpoint {cfg.checkpoint_path}: "
            f"{tree.nodes_explored} nodes explored, "
            f"{tree.nodes_remaining} remaining, gap {tree.now_gap:g}.\n"
        ], echo=echo)
    last_checkpoint = time.time()

    # ------------------------------------------------------------------
    # Multi-process distribution (omc_torch/parallel/dist.py): the root
    # starts on process 0; the other processes begin with an empty shard
    # and receive nodes by rebalancing.  The deterministic warm start gives
    # every process the same incumbent, so bounds are shared from round one.
    # ------------------------------------------------------------------
    dist = None
    dist_stop = False
    if cfg.distributed:
        from omc_torch.parallel.dist import DistContext

        dist = DistContext(rebalance_every=cfg.dist_rebalance_every)
        if dist.process_index != 0 and not resumed:
            tree.nodes.clear()
            tree._heap_lb.clear()
            tree._fifo.clear()
            tree._heap.clear()

    def dist_sync():
        """Once-per-round collective: fuse bounds, maybe rebalance.
        Returns True when a process requested stop (time/steps): a GLOBAL
        decision, so every process exits the same round (collectives stay
        matched)."""
        nonlocal dist_stop
        lb_candidate = min(tree.min_queued_lb(), tree.closed_lb_floor)
        want_stop = (
            (cfg.use_max_steps and tree.counter >= cfg.max_steps)
            or time.time() - start_time > cfg.time_limit
        )
        max_cuts = max((len(nd.cuts or []) for nd in tree.nodes.values()), default=0)
        max_minors = max(
            (len(nd.Shor_info.constraints_indexes) for nd in tree.nodes.values()
             if nd.Shor_info is not None),
            default=0,
        )
        rs = dist.sync_round(
            tree.best_upper_bound, lb_candidate, len(tree), want_stop, max_cuts, max_minors,
        )
        tree.best_upper_bound = min(tree.best_upper_bound, rs.global_ub)
        # the process-local monotone lower bound can exceed the true global
        # bound (another process may hold worse nodes): the distributed
        # value is authoritative
        tree.best_lower_bound = rs.global_lb
        tree.now_gap = compute_gap(tree.best_lower_bound, tree.best_upper_bound)
        if dist.should_rebalance(rs):
            spec = None
            if cfg.sdp_warm_start and cfg.dist_migrate_state:
                # move device-resident states to the host cache so migrating
                # nodes' latest slices travel, then derive the wire spec (the
                # same on every process: a function of the fused RoundState's
                # Lmax/Mmax and the shared config)
                _flush_last_solve()
                spec = wire_state_spec(family, n, m, k, rs.Lmax, rs.Mmax, dtype)
            dist.rebalance(
                tree, rs, n, k, m=m, state_spec=spec,
                state_get=state_cache.get, state_put=_cache_put,
            )
        dist_stop = rs.stop
        return rs.stop

    def maybe_checkpoint(force=False):
        nonlocal last_checkpoint
        ckpt_path = cfg.checkpoint_path
        if dist is not None and ckpt_path:  # one frontier shard file per process
            ckpt_path = f"{ckpt_path}.proc{dist.process_index}"
        if ckpt_path and (
                force or time.time() - last_checkpoint >= cfg.checkpoint_every):
            save_checkpoint(ckpt_path, {
                "tree": tree, "solution": solution, "census": census,
                "run_log": run_log, "rng_state": rng.bit_generator.state,
            })
            last_checkpoint = time.time()

    # root_node_timeout bookkeeping (reference lines 774-776): the root is
    # resolved once it is pruned, closed, or split
    root_resolved = 1 not in tree.nodes

    add_message(printlist, UPDATE_HEADER, echo=echo)

    def add_update(altmin_flag=False, echo_row=True):
        tree.now_gap = compute_gap(tree.best_lower_bound, tree.best_upper_bound)
        msg = update_row(tree, time.time() - start_time, altmin_flag=altmin_flag)
        add_message(printlist, msg, echo=echo and echo_row)
        run_log.append({
            "explored": tree.nodes_explored, "total": tree.counter,
            "remaining": tree.nodes_remaining,
            "lower": tree.best_lower_bound, "upper": tree.best_upper_bound,
            "gap": tree.now_gap, "runtime": time.time() - start_time,
        })
        tree.last_updated_counter = tree.counter

    solvers: Dict[int, object] = {}
    iter_rate: Dict[tuple, float] = {}  # measured seconds per solver iteration
    iter_rate_samples: Dict[tuple, int] = {}

    # block variable scales, chosen once from the data and the root upper
    # bound (runtime state fields of the solver)
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = max(1.0, 2.0 * gamma * objective_initial / (4.0 * m))
    sS = sX ** cfg.shor_slot_pow

    def shor_probability(depth):
        return _decayed_probability(
            depth, cfg.max_update_Shor_indices_probability,
            cfg.min_update_Shor_indices_probability,
            cfg.update_Shor_indices_probability_decay_rate,
        )

    def violated_minors(out, sel, existing):
        """The top-scoring violated minors at slot ``sel``'s relaxation point
        (scored per term over the Xt split when k > 1), none of them in
        ``existing``."""
        X = out["Xt" if use_shor_k else "X"][sel]
        scored = shor_mod.generate_violated_Shor_minors(
            X.astype(np.float64), indices,
            list(cfg.Shor_valid_inequalities_noisy_rank1_num_entries_present),
            existing, cfg.update_Shor_indices_n_minors,
        )
        return [mm for _, mm in scored]

    def get_solver(L, M5=None):
        """The base solver per cut bucket; with Shor, per (cut, minor)
        bucket (omc's Shor solver keeps its own over-relaxation 1.6)."""
        key = (L, M5)
        if key not in solvers:
            if use_mccormick:
                solvers[key] = make_mccormick_solver(
                    n, m, k, gamma, iters=cfg.sdp_iters, dtype=dtype,
                    alpha=cfg.sdp_alpha_mccormick,
                )
            elif use_shor_k:
                solvers[key] = make_shor_k_solver(
                    n, m, k, L, M5, n * m, gamma, iters=cfg.sdp_iters, dtype=dtype,
                    check_every=cfg.sdp_check_every, ema_iters=cfg.sdp_ema_iters,
                )
            elif use_shor:
                solvers[key] = make_shor_solver(
                    n, m, L, M5, n * m, gamma, iters=cfg.sdp_iters, dtype=dtype,
                    check_every=cfg.sdp_check_every, ema_iters=cfg.sdp_ema_iters,
                )
            else:
                solvers[key] = make_admm_solver(
                    n, m, k, L, gamma, iters=cfg.sdp_iters, dtype=dtype,
                    alpha=cfg.sdp_alpha,
                    check_every=cfg.sdp_check_every, ema_iters=cfg.sdp_ema_iters,
                )
        return solvers[key]

    # Warm-start cache: node_id (raw final state, refinement continuation)
    # or ("bd", node_id) (best-chunk duals, child inheritance) -> float32
    # host slice of the solver state
    state_cache: "OrderedDict[object, list]" = OrderedDict()
    state_cache_max = 2048

    def _cache_put(key, sl):
        state_cache[key] = sl
        state_cache.move_to_end(key)
        while len(state_cache) > state_cache_max:
            state_cache.popitem(last=False)

    # template state (incumbent primal, zero duals), rebuilt only when the
    # incumbent moves; host leaves fetched lazily
    template_cache: Dict[tuple, tuple] = {}

    def _init_state(Bb, L, M5, device, **kw):
        """The solver family's initial state at batch ``Bb``."""
        kw.update(sX=sX, sT=sT, sS=sS, rho=rho_base)
        if use_mccormick:
            kw.update(rho=cfg.sdp_rho_mccormick)
        return family_state(family, Bb, n, m, k, L, M5, dtype, device, **kw)

    def _template_cached(Bb, L, M5=None):
        key = (Bb, L, M5)
        hit = template_cache.get(key)
        if hit is not None and hit[2] == incumbent_ver["v"]:
            return hit[0], hit[1]
        U0 = solution["U"]
        X0 = solution["X"]
        V0 = U0.T @ X0
        dev_state = _init_state(Bb, L, M5, dev, X0=X0[None], Y0=(U0 @ U0.T)[None],
                                Th0=(V0.T @ V0)[None], U0=U0[None])
        host_box = {"h": None}

        def host():
            if host_box["h"] is None:
                host_box["h"] = [
                    x.cpu().numpy().astype(np_dtype) for x in dev_state.leaves()
                ]
            return host_box["h"]

        template_cache[key] = (dev_state, host, incumbent_ver["v"])
        return dev_state, host

    # The previous super-step's final state stays on the device; a step that
    # re-visits exactly the same node set at the same shapes (the bound-
    # refinement loop) reuses it with no host round trip.  Otherwise it is
    # flushed to the host slice cache lazily.
    last_solve = {
        "key": None, "state": None, "slots": {}, "host": None,
        "state_bd": None, "host_bd": None,
    }

    def _flush_last_solve(skip_ids=()):
        if last_solve["state"] is None:
            return
        if last_solve["host"] is None:
            last_solve["host"] = state_to_host(last_solve["state"])
        if last_solve["state_bd"] is not None and last_solve["host_bd"] is None:
            last_solve["host_bd"] = state_to_host(last_solve["state_bd"])
        for nid, i in last_solve["slots"].items():
            if nid not in skip_ids:
                _cache_put(nid, host_state_slice(last_solve["host"], i))
                if last_solve["host_bd"] is not None:
                    _cache_put(("bd", nid), host_state_slice(last_solve["host_bd"], i))
        last_solve["slots"] = {}

    def warm_state(nodes: List[BBNode], Bb, L, M5=None):
        """Returns (state, fresh): ``fresh`` is False when the previous
        super-step's device state is reused verbatim."""
        key = (tuple(nd.node_id for nd in nodes), Bb, L, M5)
        if last_solve["key"] == key and last_solve["state"] is not None:
            return last_solve["state"], False
        slots = last_solve["slots"]
        if slots and any(nd.node_id in slots or nd.parent_id in slots for nd in nodes):
            _flush_last_solve()
        # own state (refinement visits) first; a child inherits the parent's
        # best-dual variant when available
        if cfg.sdp_warm_start:
            slices = [
                state_cache.get(nd.node_id)
                or state_cache.get(("bd", nd.parent_id))
                or state_cache.get(nd.parent_id)
                for nd in nodes
            ]
        else:
            slices = [None] * len(nodes)
        slices += [None] * (Bb - len(nodes))
        tpl_dev, tpl_host = _template_cached(Bb, L, M5)
        if all(sl is None for sl in slices):
            return tpl_dev, True
        base = [leaf.copy() for leaf in tpl_host()]
        # a slice from a smaller minor bucket fills the leading rows of
        # w5/u5/v: the minor tables are prefix-stable (shor_encode)
        apply_warm_slices(base, slices)
        state_cls = (MCState if use_mccormick else ShorKState if use_shor_k
                     else ShorADMMState if use_shor else ADMMState)
        return state_cls.from_leaves(
            [torch.as_tensor(b_, device=dev) for b_ in base]
        ), True

    def record_solve(slot_nodes: List[BBNode], fin_state, Bb, L, M5=None,
                     best_slot=None, state_bd=None):
        _flush_last_solve(skip_ids={nd.node_id for nd in slot_nodes})
        last_solve["key"] = (tuple(nd.node_id for nd in slot_nodes), Bb, L, M5)
        last_solve["state"] = fin_state
        last_solve["slots"] = (
            dict(best_slot) if best_slot is not None
            else {nd.node_id: i for i, nd in enumerate(slot_nodes)}
        )
        last_solve["host"] = None
        last_solve["state_bd"] = state_bd
        last_solve["host_bd"] = None

    # ------------------------------------------------------------------
    # Main batched branch-and-bound loop (reference lines 700-1073)
    # ------------------------------------------------------------------
    def _keep_running():
        if tree.now_gap <= cfg.gap:
            return False
        if dist is not None:
            # time/steps termination is the GLOBAL stop decision, so every
            # process exits on the same round (see dist_sync)
            return not dist_stop
        return (
            not (cfg.use_max_steps and tree.counter >= cfg.max_steps)
            and time.time() - start_time <= cfg.time_limit
        )

    while _keep_running():
        # a process whose shard is empty keeps syncing: it receives nodes
        # by rebalancing, and every process must join every round
        if len(tree) == 0 and dist is None:
            break
        popped = tree.retrieve_batch(
            cfg.node_selection, B, cfg.bestfirst_depthfirst_cutoff
        )
        if not popped and dist is None:
            break

        # dominance pre-check (reference lines 725-728)
        work: List[BBNode] = []
        for node in popped:
            if node.LB > tree.best_upper_bound:
                if node.refines == 0:
                    census["nodes_dominated"] += 1
                else:
                    census["nodes_relax_feasible_pruned"] += 1
                if node.node_id == 1:
                    root_resolved = True
            elif use_mccormick and node.refines == 0:
                # relaxation feasibility of a first visit (reference lines
                # 731-742, 1294-1429): the interval screen, then the exact
                # envelope LP; re-visits keep their box and skip it
                t_feas = time.time()
                feas = (mccormick_box_feasible(node.U_lower, node.U_upper)
                        and mccormick_lp_feasible(node.U_lower, node.U_upper))
                solve_time_relaxation_feasibility += time.time() - t_feas
                if feas:
                    work.append(node)
                else:
                    census["nodes_relax_infeasible"] += 1
            else:
                work.append(node)
        if not work:
            tree.update_lower_bound()
            if dist is not None:
                stop_now = dist_sync()
                add_update(echo_row=False)
                if stop_now:
                    break
                continue
            add_update(echo_row=False)
            continue

        # McCormick nodes carry no cuts (cuts=None)
        L = _l_bucket(1 if use_mccormick else max(1, max(len(nd.cuts) for nd in work)))
        # rho portfolio: on refinement visits, replicate live nodes into
        # otherwise-padded slots at different penalties; every replica bound
        # is valid, the per-node max is taken, and the winning replica's
        # state carries forward.  First visits run solo at the tight bucket.
        use_portfolio = (
            not use_shor and not use_mccormick and len(cfg.rho_portfolio) > 0
            and all(nd.refines > 0 for nd in work)
        )
        P = 1 + len(cfg.rho_portfolio)
        if use_portfolio:
            Bb = _b_bucket(min(len(work) * P, B), B)
        else:
            Bb = _b_bucket(len(work), B)
        if use_portfolio and Bb > len(work):
            slot_nodes = [work[s % len(work)] for s in range(Bb)]
            rho_mults = np.ones(Bb, dtype=np_dtype)
            for s in range(len(work), Bb):
                rho_mults[s] = cfg.rho_portfolio[
                    (s // len(work) - 1) % len(cfg.rho_portfolio)
                ]
        else:
            use_portfolio = False
            slot_nodes = work
            rho_mults = None
        batch = _pack_batch(slot_nodes, Bb, L, n, k, cfg.disjunctive_cuts_type, np_dtype)
        ub_bar = tree.best_upper_bound * (1.0 + 1e-9) + 1e-9

        # a starved frontier spends the freed batch slots on more iterations
        # for the live nodes, capped so one visit never eats more than a
        # quarter of the remaining time budget
        queue_slack = max(0, B - len(work) - len(tree))
        boost = min(
            cfg.sdp_iter_boost_max, max(1, queue_slack // max(1, len(work)))
        )
        visit_iters = cfg.sdp_iters * boost
        skey = ("mc" if use_mccormick else "shor" if use_shor else "dc", Bb)
        rate = iter_rate.get(skey)
        if rate is not None and rate > 0:
            remaining = max(cfg.time_limit - (time.time() - start_time), 0.0)
            affordable = int(max(5.0, 0.25 * remaining) / rate)
            visit_iters = max(
                min(visit_iters, affordable), max(cfg.sdp_iters // 4, 1)
            )

        t0 = time.time()
        M5 = sbh = None
        if use_shor:
            n_minors = max(len(nd.Shor_info.constraints_indexes) for nd in work)
            shor_minors_max = max(shor_minors_max, n_minors)
            M5 = _m5_bucket(max(1, n_minors))
            pad = [[]] * (Bb - len(work))
            sbh = (pack_shor_k_batch if use_shor_k else pack_shor_batch)(
                n, m, [nd.Shor_info.constraints_indexes for nd in work] + pad,
                [nd.Shor_info.SOC_constraints_indexes for nd in work] + pad,
                M5, n * m,
            )
        state0, fresh = warm_state(slot_nodes, Bb, L, M5)
        if use_portfolio and fresh:
            state0 = set_slot_rho(state0, state0.rho * T(rho_mults))
        batch_dev = batch.map(T)
        # on-device early exit: a slot is done when its chunk-averaged safe
        # bound clears the certification level; replicas of a node share a
        # group (any replica clearing finishes the node)
        nw = len(work)
        target_np = np.full(Bb, -np.inf, dtype=np_dtype)
        group_np = np.arange(Bb, dtype=np.int64)
        lvl = tree.best_upper_bound / (1.0 + cfg.gap)
        n_live = Bb if use_portfolio else nw
        target_np[:n_live] = lvl
        if use_portfolio:
            group_np = np.arange(Bb, dtype=np.int64) % nw
        target_dev = T(target_np)
        group_dev = torch.as_tensor(group_np, device=dev)
        state_bd = None
        if use_mccormick:
            # one call per visit: its duals are averaged over the last
            # quarter of the visit (omc averages its last <= 2,000-iteration
            # chunk; ROADMAP section 3)
            fin_state, out_dev = get_solver(L)(
                A_dev, mask_dev, MCBatch(T(batch.U_lo), T(batch.U_hi)), ub_bar, state0,
                visit_iters,
            )
        elif use_shor:
            fin_state, out_dev = get_solver(L, M5)(
                A_dev, mask_dev, batch_dev, sbh, ub_bar, state0, visit_iters,
                target_dev, group_dev,
            )
            # the Shor family continues from the best-chunk duals too: its
            # growth-heavy re-visits behave like child solves (omc.solve)
            if cfg.sdp_best_dual_warm:
                apply = apply_shor_k_best_duals if use_shor_k else apply_shor_best_duals
                fin_state = apply(fin_state, out_dev)
        else:
            fin_state, out_dev = get_solver(L)(
                A_dev, mask_dev, batch_dev, ub_bar, state0, visit_iters,
                target_dev, group_dev,
            )
            # the best-chunk duals are the warm start handed to CHILD nodes
            # only: a node's own refinement re-visits continue from the
            # exact final iterate (resetting their duals to the EMA midpoint
            # stalls the contraction; see ``omc.solve._apply_best_duals``)
            if cfg.sdp_best_dual_warm:
                state_bd = apply_best_duals(fin_state, out_dev)
        out = to_numpy_out(out_dev)  # one synchronised fetch
        iters_done = int(np.max(out["iters_run"]))
        t_dev_end = time.time()
        if use_mccormick:
            lbs = host_certified_bound_mc(A, mask, batch.U_lo, batch.U_hi, out, gamma, k, ub_bar)
        elif use_shor_k:
            lbs = host_certified_bound_shor_k(A, mask, batch, sbh, out, gamma, k, ub_bar)
        elif use_shor:
            lbs = host_certified_bound_shor(A, mask, batch, sbh, out, gamma, ub_bar)
        elif Bb > cfg.host_certify_max_batch:
            # scale path: f64-certify only the binding slots (prune/close
            # candidates by the estimator, and the lowest bounds, which
            # drive the global LB); the rest keep the on-device
            # margin-guarded bound
            lb_dev = out["lb_dev"].astype(np.float64)
            lb_scr = out["lb_est"].astype(np.float64)
            binding = lb_scr >= 0.98 * lvl
            order = np.argsort(lb_scr)
            binding[order[: min(8, Bb)]] = True
            sel = np.where(binding)[0]
            lbs = lb_dev.copy()
            if sel.size:
                sub_batch = batch.map(lambda x: np.asarray(x)[sel])
                sub_out = {
                    key: val[sel] for key, val in out.items()
                    if key in ("y1", "y2", "ya", "yb", "yc")
                }
                lbs[sel] = host_certified_bound(
                    A, mask, sub_batch, sub_out, gamma, k, ub_bar
                )
        else:
            lbs = host_certified_bound(A, mask, batch, out, gamma, k, ub_bar)

        # portfolio reduction: per node, the max certified bound over its
        # replica slots; the winning slot represents the node from here on
        best_slot = None
        sel_of = list(range(len(work)))
        if use_portfolio:
            lbs_nodes = np.empty(nw)
            best_slot = {}
            for i in range(nw):
                slots_i = np.arange(i, Bb, nw)
                j = int(slots_i[np.argmax(lbs[slots_i])])
                lbs_nodes[i] = lbs[j]
                sel_of[i] = j
                best_slot[work[i].node_id] = j
            lbs = lbs_nodes
        record_solve(slot_nodes, fin_state, Bb, L, M5, best_slot=best_slot,
                     state_bd=state_bd)
        t_relax = time.time() - t0
        solve_time_relaxation += t_relax
        solve_time_device += t_dev_end - t0
        solve_time_certify += t_relax - (t_dev_end - t0)
        sdp_iters_total += iters_done
        device_steps += 1
        new_rate = t_relax / max(iters_done, 1)
        old_rate = iter_rate.get(skey)
        # the first measurement includes warm-up costs — overwrite it on
        # the second, then smooth
        iter_rate[skey] = (
            new_rate if old_rate is None or iter_rate_samples[skey] < 2
            else 0.7 * old_rate + 0.3 * new_rate
        )
        iter_rate_samples[skey] = iter_rate_samples.get(skey, 0) + 1

        altmin_marked: List[int] = []  # indices into `work`
        split_nodes: List[int] = []

        for i, node in enumerate(work):
            lb_prev = node.LB
            computed = float(lbs[i])
            prev_solver = node.lb_solver
            node.lb_solver = computed
            lb_i = max(node.LB, computed)
            node.LB = lb_i
            # refinement re-visits are counted in tree.refinement_visits,
            # not in the per-node census
            if node.refines == 0:
                census["nodes_relax_feasible"] += 1
            dict_solve_times_relaxation.append({
                "node_id": node.node_id, "depth": node.depth,
                "solve_time": t_relax / max(len(work), 1),
            })
            if node.node_id == 1:
                tree.best_lower_bound = max(tree.best_lower_bound, lb_i)

            if lb_i > tree.best_upper_bound:
                census["nodes_relax_feasible_pruned"] += 1
                if node.node_id == 1:
                    root_resolved = True
                continue

            sel = sel_of[i]
            if use_mccormick:
                master_feasible = master_feasible_mccormick(
                    out["Y"][sel], out["U"][sel], out["X"][sel], out["Th"][sel])
            else:
                master_feasible = bool(out["sep_w"][sel, 0] >= -1e-6)
            if master_feasible:
                node.master_feasible = True
                t_pol = time.time()
                obj_r, X_r, U_r = _round_to_incumbent(out["Y"][sel], A, mask, gamma, k)
                obj_p, X_p, U_p = _polish_incumbent(X_r, A, mask, gamma, k, iters=8)
                solve_time_polish += time.time() - t_pol
                if obj_p < obj_r:
                    obj_r, X_r, U_r = obj_p, X_p, U_p
                improved = obj_r < tree.best_upper_bound
                if improved:
                    tree.best_upper_bound = obj_r
                    update_solution(obj_r, U_r @ U_r.T, U_r, X_r, time.time() - start_time)
                    add_update()
                # close the node if its local gap is within target; census
                # (7)/(8) count at close time (terminal-outcome partition)
                if obj_r <= lb_i * (1.0 + cfg.gap) or lb_i >= tree.best_upper_bound:
                    census["nodes_master_feasible"] += 1
                    if improved:
                        census["nodes_master_feasible_improvement"] += 1
                    tree.closed_lb_floor = min(tree.closed_lb_floor, lb_i)
                    if node.node_id == 1:
                        root_resolved = True
                    continue

            # gap-level close: a certified bound at ub/(1+gap) closes the
            # node with its bound as the floor of the global LB
            if lb_i >= tree.best_upper_bound / (1.0 + cfg.gap):
                tree.closed_lb_floor = min(tree.closed_lb_floor, lb_i)
                nodes_closed_within_gap += 1
                census["nodes_relax_feasible_pruned"] += 1
                if node.node_id == 1:
                    root_resolved = True
                continue

            # bound refinement: requeue this node to continue from its own
            # solver state while its computed bound is still behind the
            # inherited bound, or still moving by more than refine_frac of
            # the remaining local gap
            behind = computed < lb_prev - 1e-9 * max(1.0, abs(lb_prev))
            baseline = prev_solver if np.isfinite(prev_solver) else lb_prev
            movement = abs(computed - baseline) if np.isfinite(baseline) else np.inf
            local_gap = max(tree.best_upper_bound - lb_i, 0.0)
            improving = (not np.isfinite(prev_solver)) or (
                computed > prev_solver + 0.02 * local_gap
            )
            node.behind_streak = (
                node.behind_streak + 1 if (behind and not improving) else 0
            )
            if (
                node.refines < cfg.max_refines
                and node.behind_streak < cfg.max_behind_refines
                and (behind or movement > cfg.refine_frac * local_gap)
            ):
                node.refines += 1
                # incumbent candidate from the tightening relaxation, gated
                # like altmin
                if cfg.altmin_flag and rng.random() < _decayed_probability(
                    node.depth, cfg.max_altmin_probability,
                    cfg.min_altmin_probability,
                    cfg.altmin_probability_decay_rate,
                ):
                    t_pol = time.time()
                    obj_r, X_r, U_r = _round_to_incumbent(
                        out["Y"][sel], A, mask, gamma, k
                    )
                    obj_p, X_p, U_p = _polish_incumbent(
                        X_r, A, mask, gamma, k, iters=8
                    )
                    if obj_p < obj_r:
                        obj_r, X_r, U_r = obj_p, X_p, U_p
                    solve_time_polish += time.time() - t_pol
                    if obj_r < tree.best_upper_bound:
                        tree.best_upper_bound = obj_r
                        update_solution(
                            obj_r, U_r @ U_r.T, U_r, X_r,
                            time.time() - start_time,
                        )
                        add_update()
                tree.requeue(node, lb_i)
                continue

            # iterative Shor growth at a refinement stall (omc.solve): when
            # a node would split and still has growth rounds, strengthen the
            # same node with its top-scoring violated minors and continue
            # from its own warm state; the refinement budget restarts
            if (
                use_shor and cfg.add_Shor_valid_inequalities_iterative
                and node.growths < cfg.update_Shor_max_growths
                and node.Shor_info is not None
                and rng.random() < shor_probability(node.depth)
            ):
                have = node.Shor_info.constraints_indexes
                fresh_minors = violated_minors(out, sel, have)
                if fresh_minors:
                    node.Shor_info = _with_minors(n, m, list(have) + fresh_minors)
                    node.growths += 1
                    shor_growths += 1
                    node.refines = 0
                    node.behind_streak = 0
                    tree.requeue(node, lb_i)
                    continue

            # altmin probability gating (reference lines 856-870)
            if cfg.altmin_flag:
                p = _decayed_probability(
                    node.depth, cfg.max_altmin_probability,
                    cfg.min_altmin_probability, cfg.altmin_probability_decay_rate,
                )
                if rng.random() < p:
                    altmin_marked.append(i)
            if node.node_id == 1:
                root_resolved = True  # the root reached its split visit
            split_nodes.append(i)

        # ---- batched altmin heuristic at marked nodes ----
        if altmin_marked:
            t0 = time.time()
            U_init_m = np.zeros((len(altmin_marked), n, k), dtype=np.float64)
            for j, i in enumerate(altmin_marked):
                Yi = out["Y"][sel_of[i]].astype(np.float64)
                if not np.all(np.isfinite(Yi)):
                    continue  # diverged iterate: zero init
                w, V = np.linalg.eigh(0.5 * (Yi + Yi.T))
                U_init_m[j] = V[:, ::-1][:, :k]
            if use_mccormick:
                # node-box-local altmin (the reference's McCormick U-model,
                # lines 2095-2171) plus a global replica per node, the
                # better objective kept (both are valid incumbents); chunked
                # so the local + global pair fits one batch bucket
                parts = []
                half = max(1, B // 2)
                for s0 in range(0, len(altmin_marked), half):
                    ids = altmin_marked[s0 : s0 + half]
                    nc = len(ids)
                    Ba = _b_bucket(2 * nc, B)
                    paired = Ba >= 2 * nc
                    if paired:
                        sel_i = np.minimum(np.arange(Ba) % nc, nc - 1)
                        is_local = np.arange(Ba) < nc
                    else:  # batch_size 1: box-local only, as the reference
                        Ba = _b_bucket(nc, B)
                        sel_i = np.minimum(np.arange(Ba), nc - 1)
                        is_local = np.ones(Ba, dtype=bool)
                    r = altmin_fn(
                        A_dev, mask_dev, T(U_init_m[s0 + sel_i]),
                        T(np.stack([work[ids[t]].U_lower for t in sel_i])),
                        T(np.stack([work[ids[t]].U_upper for t in sel_i])),
                        box_on=T(is_local.astype(np_dtype)),
                    )
                    pick = np.arange(nc)
                    if paired:
                        r_obj = r.objective.cpu().numpy().astype(np.float64)
                        pick = np.where(r_obj[:nc] <= r_obj[nc : 2 * nc], pick, pick + nc)
                    parts.append(_fetch(r, pick))
                am_U, am_V, am_conv, am_iters, am_trace = (
                    np.concatenate(p, axis=0) for p in zip(*parts))
            elif all(not work[i].cuts for i in altmin_marked):
                am_U, am_V, am_conv, am_iters, am_trace = run_altmin(U_init_m)
            else:
                # cut-constrained U-step (reference lines 2048-2092): the
                # marked nodes' cut tensors are rows of the packed batch
                Ba = _b_bucket(len(altmin_marked), B)
                na = len(altmin_marked)
                idx = np.asarray(altmin_marked + [altmin_marked[-1]] * (Ba - na))
                r = altmin_fn(
                    A_dev, mask_dev,
                    T(U_init_m[np.minimum(np.arange(Ba), na - 1)]),
                    T(batch.U_lo[idx]), T(batch.U_hi[idx]),
                    cut_x=T(batch.cut_x[idx]), cut_lo=T(batch.cut_lo[idx]),
                    cut_hi=T(batch.cut_hi[idx]), cut_mask=T(batch.cut_mask[idx]),
                )
                am_U, am_V, am_conv, am_iters, am_trace = _fetch(r, slice(0, na))
            t_alt = time.time() - t0
            solve_time_altmin += t_alt
            for j, i in enumerate(altmin_marked):
                node = work[i]
                census["nodes_relax_feasible_split_altmin"] += 1
                dict_solve_times_altmin.append({
                    "node_id": node.node_id, "depth": node.depth,
                    "solve_time": t_alt / len(altmin_marked),
                })
                dict_num_iterations_altmin.append({
                    "node_id": node.node_id, "depth": node.depth,
                    "n_iters": int(am_iters[j]),
                })
                alternating_minimization_printout(
                    printlist, node.node_id,
                    _decayed_probability(
                        node.depth, cfg.max_altmin_probability,
                        cfg.min_altmin_probability,
                        cfg.altmin_probability_decay_rate,
                    ),
                    bool(am_conv[j]), int(am_iters[j]), cfg.altmin_max_iters,
                    t_alt / len(altmin_marked),
                    [float(v) for v in am_trace[j][: int(am_iters[j])]
                     if np.isfinite(v)]
                    or [_np_objective(am_U[j] @ am_V[j], A, mask, gamma)],
                    verbosity,
                )
                if am_conv[j]:
                    t_pol = time.time()
                    obj_local, X_local, U_local = _polish_incumbent(
                        am_U[j] @ am_V[j], A, mask, gamma, k, iters=8
                    )
                    solve_time_polish += time.time() - t_pol
                    if obj_local < tree.best_upper_bound:
                        census["nodes_relax_feasible_split_altmin_improvement"] += 1
                        tree.best_upper_bound = obj_local
                        update_solution(
                            obj_local, U_local @ U_local.T, U_local, X_local,
                            time.time() - start_time,
                        )
                        add_update(altmin_flag=True)

        # ---- branching (reference lines 951-1031) ----
        had_root = any(nd.node_id == 1 for nd in work)
        if not cfg.root_only:
            for i in split_nodes:
                node = work[i]
                census["nodes_relax_feasible_split"] += 1
                if use_mccormick:  # bisect the widest U interval
                    tree.add_nodes(
                        create_mccormick_child_nodes(node, tree.counter, node.LB), node.LB)
                    continue
                # iterative Shor growth at child creation (reference lines
                # 956-970, 2495-2518): with decaying probability the
                # children get the top-scoring violated minors
                new_shor = None
                if (use_shor and cfg.add_Shor_valid_inequalities_iterative
                        and rng.random() < shor_probability(node.depth)):
                    have = node.Shor_info.constraints_indexes
                    fresh_minors = violated_minors(out, sel_of[i], have)
                    shor_growths += bool(fresh_minors)
                    new_shor = _with_minors(n, m, list(have) + fresh_minors)
                children = create_matrix_cut_child_nodes(
                    node,
                    cfg.disjunctive_cuts_type,
                    cfg.disjunctive_cuts_breakpoints,
                    sep_w=out["sep_w"][sel_of[i]],
                    sep_V=out["sep_V"][sel_of[i]],
                    U_relax=out["U"][sel_of[i]],
                    counter=tree.counter,
                    objective_relax=node.LB,
                    new_Shor_info=new_shor,
                )
                tree.add_nodes(children, node.LB)

        # queued mid-refinement nodes killed by a better incumbent are
        # (5)-counted nodes whose terminal outcome is a bound prune -> (6)
        pruned_refining, pruned_ids = tree.prune_dominated()
        census["nodes_relax_feasible_pruned"] += pruned_refining
        if 1 in pruned_ids:
            root_resolved = True
        lower_bounds_updated = tree.update_lower_bound()
        tree.now_gap = compute_gap(tree.best_lower_bound, tree.best_upper_bound)
        if dist is not None:
            stop_now = dist_sync()  # overwrites the bounds with the global view
            lower_bounds_updated = True
            if stop_now:
                add_update(echo_row=verbosity >= 1)
                maybe_checkpoint()
                break

        print_now = (
            lower_bounds_updated
            or had_root
            or (tree.counter // cfg.update_step) > (tree.last_updated_counter // cfg.update_step)
            or tree.now_gap <= cfg.gap
            or (cfg.use_max_steps and tree.counter >= cfg.max_steps)
            or time.time() - start_time > cfg.time_limit
        )
        add_update(echo_row=print_now if verbosity >= 1 else verbosity >= 3)
        maybe_checkpoint()

        if cfg.root_only:
            break

    end_time = time.time()
    time_taken = end_time - start_time
    maybe_checkpoint(force=True)

    # terminal accounting for nodes still queued mid-refinement at a
    # gap-certified exit (their outcome is a within-gap bound prune -> (6))
    if compute_gap(tree.best_lower_bound, tree.best_upper_bound) <= cfg.gap:
        for nd in tree.nodes.values():
            if nd.refines > 0:
                census["nodes_relax_feasible_pruned"] += 1
        root_resolved = True

    census_global = None
    if dist is not None:
        # the best incumbent may live on another process; likewise the
        # GLOBAL node census (every process calls these collectives in the
        # same order, so they stay matched)
        obj_g, X_g, U_g = dist.gather_best_solution(
            solution["objective"], solution["X"], solution["U"]
        )
        if obj_g < solution["objective"]:
            update_solution(obj_g, U_g @ U_g.T, U_g, X_g, time_taken)
        census_global = dist.sum_counters({
            **census,
            "nodes_explored": tree.nodes_explored,
            "refinement_visits": tree.refinement_visits,
            "nodes_total": tree.counter,
        })

    root_node_timeout = bool(time_taken > cfg.time_limit and not root_resolved)

    solution["MSE_in"] = float(compute_MSE(solution["X"], A, mask, kind="in"))
    solution["MSE_out"] = float(compute_MSE(solution["X"], A, mask, kind="out"))
    solution["MSE_all"] = float(compute_MSE(solution["X"], A, mask, kind="all"))

    run_details = OrderedDict(
        [
            ("k", k), ("m", m), ("n", n), ("A", A), ("indices", indices),
            ("num_indices", int(indices.sum())), ("gamma", gamma),
        ]
    )
    run_details.update(cfg.run_details_params())
    run_details.update(
        {
            "log_time": start_time,
            "start_time": start_time,
            "end_time": end_time,
            "time_taken": time_taken,
            "solve_time_altmin": solve_time_altmin,
            "dict_solve_times_altmin": dict_solve_times_altmin,
            "dict_num_iterations_altmin": dict_num_iterations_altmin,
            "solve_time_relaxation_feasibility": solve_time_relaxation_feasibility,
            "solve_time_relaxation": solve_time_relaxation,
            "dict_solve_times_relaxation": dict_solve_times_relaxation,
            # phase split: device solver wall vs host float64 certification
            # vs host incumbent polish
            "solve_time_device": solve_time_device,
            "solve_time_certify": solve_time_certify,
            "solve_time_polish": solve_time_polish,
            "sdp_iters_total": sdp_iters_total,
            "device_steps": device_steps,
            "shor_minors_max": shor_minors_max,
            "shor_growths": shor_growths,
            "device": str(dev),
            # nodes closed because their certified bound reached ub/(1+gap)
            "nodes_closed_within_gap": nodes_closed_within_gap,
            "root_node_timeout": root_node_timeout,
            "nodes_explored": tree.nodes_explored,
            # bound-refinement re-visits (kept out of nodes_explored)
            "refinement_visits": tree.refinement_visits,
            "nodes_total": tree.counter,
        }
    )
    run_details.update(census)
    if dist is not None:
        run_details["process_count"] = dist.process_count
        run_details["process_index"] = dist.process_index
        run_details["census_global"] = census_global
        # wall-clock inside cross-process collectives
        run_details["dist_sync_seconds"] = dist.sync_seconds
        # warm migration: leaves that did not fit the wire spec, and the
        # migrated states installed into this process's warm-start cache
        run_details["dist_state_refit_leaves"] = dist.state_refit_leaves
        run_details["dist_states_installed"] = dist.states_installed

    instance = {"run_log": run_log, "run_details": run_details}

    add_message(printlist, [
        "\n\nRun details:\n",
        f"nodes_explored: {tree.nodes_explored:10d}\n",
        f"nodes_total:    {tree.counter:10d}\n",
        f"time_taken:     {time_taken:10.3f}\n",
        "\n--------------------------------\n",
        "\n\nInitial solution (warm start):\n%s" % repr(objective_initial),
        "\n\nBest incumbent solution:\n%s" % repr(solution["objective"]),
        "\n\nFinal gap:\n%s\n" % repr(tree.now_gap),
    ], echo=echo)

    return solution, printlist, instance
