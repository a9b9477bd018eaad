"""Logging / telemetry channels.

Reproduces the reference's three observability channels
(reference `src/OptimalMatrixCompletion.jl`):

1. ``printlist`` — every message printed to stdout is also appended and
   returned to the caller (``add_message!``, lines 74-84).
2. ``run_log``   — one row per update event with columns
   (explored, total, remaining, lower, upper, gap, runtime)
   (lines 457-465, appended at 207-213).  Stored as a list of dicts.
3. ``run_details`` — full parameter echo + timings + node census
   (lines 466-519), an ordered dict.
"""

from __future__ import annotations

import sys
from typing import List


def add_message(printlist: List[str], messages, *, echo: bool = True):
    if isinstance(messages, str):
        messages = [messages]
    for message in messages:
        if echo:
            sys.stdout.write(message)
            sys.stdout.flush()
        printlist.append(message)


def update_row(tree, current_time_elapsed: float, *, altmin_flag: bool = False) -> str:
    """The 7-column update row, format-identical to the reference
    (lines 191-205), with the " - A" suffix marking altmin-driven
    incumbent updates."""
    message = "| %10d | %10d | %10d | %10f | %10f | %10f | %10.3f  s  |" % (
        tree.nodes_explored,
        tree.counter,
        tree.nodes_remaining,
        tree.best_lower_bound,
        tree.best_upper_bound,
        tree.now_gap,
        current_time_elapsed,
    )
    return message + (" - A\n" if altmin_flag else "\n")


UPDATE_HEADER = (
    "------------------------------------------------------------------------------------------------\n"
    "|   Explored |      Total |  Remaining |      Lower |      Upper |        Gap |    Runtime (s) |\n"
    "------------------------------------------------------------------------------------------------\n"
)


def alternating_minimization_printout(printlist, node_id: int,
                                      altmin_probability: float,
                                      converged: bool, n_iters: int,
                                      max_iters: int, solve_time: float,
                                      objectives, verbosity: int):
    """Verbosity-gated per-run altmin report, format-identical to the
    reference's ``alternating_minimization_printout`` (lines 2281-2328)."""
    if verbosity < 2:
        return
    word = "converged       " if converged else "did not converge"
    add_message(printlist, [
        "    Altmin at node %5d (w.p. %.3f) %s in %3d / %3d iterations: %5.2f seconds.\n"
        % (node_id, altmin_probability, word, n_iters, max_iters, solve_time)
    ])
    tail = list(objectives)[-6:]
    add_message(printlist, [
        "    Objective values:      %s\n" % ", ".join("%.4e" % o for o in tail),
        "\n",
    ])
