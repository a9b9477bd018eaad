"""One rank of a multi-process branch-and-bound run.

    python -m omc_torch.parallel.worker --coordinator HOST:PORT --rank R \\
        --world W [--instance small|multinode] [--mode plain|shor|coldmigrate] \\
        [--device cuda|cpu] [--set KEY=JSON]... [--timeout S]

Joins the gloo group at ``HOST:PORT`` (rank 0 hosts the rendezvous), runs
``matrix_completion_branchandbound`` with ``distributed=True`` on an
instance made by ``omc_torch.data`` from a fixed seed, and prints one line
``RESULT {json}``: the certified objective and gap, the lowest and highest
lower bound of the run log, the rank's and the global ``nodes_explored``
and ``refinement_visits``, ``process_count``, the global census, the seconds
inside collectives, the warm migration's counts (state leaves that did not
fit the wire, states installed from other ranks), the wall seconds and the
rank's kernel launches.

Instances:

- ``small``: rank-1 10 x 10, 60 entries observed (seed 2), gamma 20,
  best-first, linear cuts at the most negative eigenvector, gap 1e-2, batch
  4, 600 iterations a visit, float64, 150 s, rebalancing every 2 rounds;
  ``--mode shor`` adds iterative [4]-minor Shor inequalities (10 a growth,
  500 iterations), ``--mode coldmigrate`` migrates nodes without their
  solver states.
- ``multinode``: rank-1 50 x 50, 30% observed (seed 0), gamma 80, gap 1e-4,
  2,000 iterations a visit, float32, the root's budget not boosted and at
  most two refinement visits a node (so that the root splits and the
  frontier spreads), rebalancing every round.

The ranks run on the card (``--device cuda``, the default; float32 only)
unless ``--device cpu`` asks for the host.  On the card a rank raises when
no GPU is present, and refuses to start unless the kernel library of these
sources is built already (``python -c "from omc_torch import kernels;
kernels.library()"``), so that ranks sharing a card never build it
themselves.  Every rank of a group must be given the same arguments but
``--rank``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def instance_kwargs(instance: str, mode: str) -> tuple:
    """(k, A, indices, gamma, solver keyword arguments) of an instance."""
    from omc_torch.data import generate_matrix_completion_data

    if instance == "small":
        A, idx = generate_matrix_completion_data(1, 10, 10, 60, seed=2)
        kw = dict(
            node_selection="bestfirst", disjunctive_cuts_type="linear",
            disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-2, batch_size=4,
            sdp_iters=600, dtype="float64", time_limit=150, verbosity=0,
            distributed=True, dist_rebalance_every=2,
        )
        gamma = 20.0
    elif instance == "multinode":
        n = 50
        A, idx = generate_matrix_completion_data(1, n, n, int(round(0.3 * n * n)), 0)
        kw = dict(
            node_selection="bestfirst", disjunctive_cuts_type="linear",
            disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-4, time_limit=60,
            batch_size=8, sdp_iters=2000, dtype="float32", altmin_root_n_iters=3,
            verbosity=0, sdp_iter_boost_max=1, max_refines=2,
            distributed=True, dist_rebalance_every=1,
        )
        gamma = 80.0
    else:
        raise ValueError(f"unknown instance {instance!r}")
    if mode == "shor":
        # iterative Shor: minor sets grow at tree nodes and migrate with them
        kw.update(
            add_Shor_valid_inequalities=True,
            add_Shor_valid_inequalities_iterative=True,
            Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
            update_Shor_indices_n_minors=10,
            sdp_iters=500,
        )
    elif mode == "coldmigrate":
        # ablation: rebalanced nodes restart from the incumbent template
        kw.update(dist_migrate_state=False)
    elif mode != "plain":
        raise ValueError(f"unknown mode {mode!r}")
    return 1, A, idx, gamma, kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0's rendezvous")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--instance", default="small", choices=("small", "multinode"))
    ap.add_argument("--mode", default="plain", choices=("plain", "shor", "coldmigrate"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="override one of the instance's solver arguments (repeatable)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for the other ranks")
    args = ap.parse_args(argv)

    t0 = time.time()
    import torch
    import torch.distributed

    from omc_torch import kernels
    from omc_torch.parallel.dist import init_distributed
    from omc_torch.solve import matrix_completion_branchandbound

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the machine's cores
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but no CUDA device is available")
        kernels.library(build=False)
    k, A, idx, gamma, kw = instance_kwargs(args.instance, args.mode)
    for item in args.set:
        key, _, val = item.partition("=")
        kw[key] = json.loads(val)
    init_distributed(args.coordinator, args.world, args.rank, timeout=args.timeout)
    kernels.reset_launches()
    t_solve = time.time()
    sol, _, inst = matrix_completion_branchandbound(k, A, idx, gamma, device=args.device, **kw)
    t_end = time.time()
    rd = inst["run_details"]
    lowers = [r["lower"] for r in inst["run_log"] if r["lower"] > -1e300]
    print("RESULT " + json.dumps({
        "pid": args.rank,
        "objective": float(sol["objective"]),
        "gap": float(inst["run_log"][-1]["gap"]),
        "lower_final": float(inst["run_log"][-1]["lower"]),
        "lower_max": max(lowers) if lowers else None,
        "nodes_explored_local": int(rd["nodes_explored"]),
        "nodes_explored_global": int(rd["census_global"]["nodes_explored"]),
        "refinement_visits_local": int(rd["refinement_visits"]),
        "refinement_visits_global": int(rd["census_global"]["refinement_visits"]),
        "process_count": int(rd["process_count"]),
        "census_global": rd["census_global"],
        "dist_sync_seconds": float(rd["dist_sync_seconds"]),
        "state_refit_leaves": int(rd["dist_state_refit_leaves"]),
        "states_installed": int(rd["dist_states_installed"]),
        "solve_seconds": t_end - t_solve,
        "wall_seconds": t_end - t0,
        "device": rd["device"],
        "launches": dict(kernels.LAUNCHES),
    }), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
