"""Branch-and-bound tree engine (host side).

Mirrors the reference's tree semantics
(reference `src/OptimalMatrixCompletion.jl`):

- ``BBNode`` / ``BBTree``                      — lines 42-71
- ``retrieve`` (four node-selection policies)  — lines 1164-1182
- ``add_nodes``                                — lines 1185-1205
- ``update_lower_bound``                       — lines 1207-1218
- ``prune_dominated``                          — lines 1220-1244

Difference from the reference: retrieval is *batched* — up to ``batch_size`` nodes
are popped per super-step and relaxed together on the device.  The
priority queue uses lazy deletion (heapq) instead of the reference's
re-built PriorityQueue, so pruning is O(pruned * log n).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DisjunctiveCut:
    """One eigenvector disjunction: unit breakpoint vector ``x`` (n,), fitted
    projections ``vhat = U_hat' x`` (k,), and per-coordinate direction codes
    (k,) int (see ``omc.sdp.cuts``)."""

    x: np.ndarray
    vhat: np.ndarray
    code: np.ndarray


@dataclasses.dataclass
class ShorInfo:
    """Per-node Shor valid-inequality state (reference lines 37-40)."""

    constraints_indexes: list  # list of (i1, i2, j1, j2)
    SOC_constraints_indexes: list  # list of (i, j)


@dataclasses.dataclass
class BBNode:
    node_id: int
    parent_id: int
    U_lower: np.ndarray  # (n, k)
    U_upper: np.ndarray  # (n, k)
    LB: float
    depth: int
    master_feasible: bool = False
    cuts: Optional[List[DisjunctiveCut]] = None  # None => McCormick path
    Shor_info: Optional[ShorInfo] = None
    refines: int = 0  # bound-refinement visits (not in the reference, see BBTree.requeue)
    # iterative-Shor growth rounds applied to THIS node at refinement
    # stalls (each growth resets the refinement budget; see omc/solve.py).
    # Host-local like the warm-start state: migration resets it.
    growths: int = 0
    # consecutive visits whose computed bound stayed BELOW the inherited
    # LB: refinement is only worth continuing while the solver is still
    # catching up; a persistent streak means the oscillating dual never
    # cleanly surpasses the parent and the node should just split
    behind_streak: int = 0
    # last bound actually computed by the solver for THIS node (-inf before
    # the first visit); distinct from LB, which is monotone and inherited
    lb_solver: float = -np.inf
    # lazily-built packed cut arrays (x (L,n), lo (L,k), hi (L,k)) — the
    # batch packer caches them so re-visits and large frontiers copy
    # contiguous blocks instead of looping per cut
    packed_cuts: Optional[tuple] = None


class BBTree:
    def __init__(self, root: BBNode, best_upper_bound: float):
        self.nodes = {root.node_id: root}
        self._fifo = deque([root.node_id])
        self._heap: List[Tuple[float, int]] = [(np.inf, root.node_id)]
        self._heap_lb = {root.node_id: np.inf}
        self.counter = 1
        self.last_updated_counter = 1
        self.nodes_explored = 0
        # bound-refinement re-visits (not in the reference; see ``requeue``).  Counted
        # separately so ``nodes_explored`` stays 1:1 with the reference's
        # one-solve-per-node census (reference lines 411-454).
        self.refinement_visits = 0
        self.best_upper_bound = best_upper_bound
        self.best_lower_bound = -np.inf
        self.now_gap = np.inf
        # floor from nodes closed as master-feasible with their certified LB;
        # the global lower bound may never exceed this (soundness of the
        # local-gap close rule, see solve.py)
        self.closed_lb_floor = np.inf

    # ------------------------------------------------------------------
    @property
    def nodes_remaining(self) -> int:
        return len(self.nodes)

    def __len__(self):
        return len(self.nodes)

    def _pop_policy(self, policy: str) -> Optional[int]:
        if policy == "breadthfirst":
            while self._fifo:
                nid = self._fifo.popleft()
                if nid in self.nodes:
                    return nid
            return None
        elif policy == "bestfirst":
            while self._heap:
                lb, nid = heapq.heappop(self._heap)
                if nid in self.nodes and self._heap_lb.get(nid) == lb:
                    return nid
            return None
        elif policy == "depthfirst":
            while self._fifo:
                nid = self._fifo.pop()
                if nid in self.nodes:
                    return nid
            return None
        raise ValueError(policy)

    def retrieve_batch(self, policy: str, batch_size: int,
                       bestfirst_depthfirst_cutoff: int = 10000) -> List[BBNode]:
        """Pop up to ``batch_size`` nodes under the given selection policy.

        ``bestfirst_depthfirst`` switches to depth-first while more than
        ``cutoff`` nodes remain (reference lines 709-717)."""
        out = []
        for _ in range(batch_size):
            if not self.nodes:
                break
            pol = policy
            if policy == "bestfirst_depthfirst":
                pol = (
                    "depthfirst"
                    if len(self.nodes) > bestfirst_depthfirst_cutoff
                    else "bestfirst"
                )
            nid = self._pop_policy(pol)
            if nid is None:
                break
            node = self.nodes.pop(nid)
            self._heap_lb.pop(nid, None)
            if node.refines == 0:
                self.nodes_explored += 1
            else:
                self.refinement_visits += 1
            out.append(node)
        return out

    def requeue(self, node: BBNode, lb: float):
        """Re-insert a node whose bound is still being refined (it keeps its
        node_id; its relaxation continues from its own warm-start state).
        Not in the reference — the reference solves each node relaxation
        exactly once because Mosek solves to high accuracy; a first-order
        solver instead refines across visits."""
        self.nodes[node.node_id] = node
        self._fifo.append(node.node_id)
        self._heap_lb[node.node_id] = lb
        heapq.heappush(self._heap, (lb, node.node_id))

    def add_nodes(self, children: List[BBNode], parent_objective: float):
        """Bulk-insert children; PQ priority is the parent's relaxation
        bound (reference lines 1185-1205)."""
        for node in children:
            self.nodes[node.node_id] = node
            self._fifo.append(node.node_id)
            self._heap_lb[node.node_id] = parent_objective
            heapq.heappush(self._heap, (parent_objective, node.node_id))
        self.counter += len(children)

    def prune_dominated(self) -> Tuple[int, List[int]]:
        """Remove every node whose queued LB exceeds the incumbent
        (reference lines 1220-1244).  Returns ``(pruned_refining,
        pruned_ids)``: how many of the pruned nodes were mid-refinement
        (already counted in census category (5) at their first visit) so
        the driver can record their terminal outcome as a bound prune —
        keeping the reference's (6)+(7)+(9)=(5) census equality (reference
        lines 435-446) — plus the pruned node ids (the driver flags the
        root as resolved when it is dominance-pruned)."""
        doomed = [
            nid for nid, lb in self._heap_lb.items() if lb > self.best_upper_bound
        ]
        pruned_refining = 0
        pruned_ids: List[int] = []
        for nid in doomed:
            node = self.nodes.pop(nid, None)
            self._heap_lb.pop(nid, None)
            if node is not None:
                pruned_ids.append(nid)
                if node.refines > 0:
                    pruned_refining += 1
        return pruned_refining, pruned_ids

    def min_queued_lb(self) -> float:
        while self._heap:
            lb, nid = self._heap[0]
            if nid in self.nodes and self._heap_lb.get(nid) == lb:
                return lb
            heapq.heappop(self._heap)
        return np.inf

    def update_lower_bound(self) -> bool:
        """Raise the global LB to min(queued LBs, closed-node floor);
        monotone like the reference (lines 1207-1218)."""
        if not self.nodes:
            candidate = min(self.closed_lb_floor, self.best_upper_bound)
        else:
            candidate = min(self.min_queued_lb(), self.closed_lb_floor)
        if candidate > self.best_lower_bound:
            self.best_lower_bound = candidate
            return True
        return False


def compute_gap(lower: float, upper: float) -> float:
    """Relative gap (upper/lower - 1); Inf when lower < 0
    (reference lines 173-179)."""
    if lower < 0:
        return np.inf
    if lower == 0:
        return np.inf if upper > 0 else 0.0
    return (upper / lower) - 1.0


def root_box(n: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Root node box with symmetry-breaking zeros: U_lower[n-k+i:, i] = 0
    (reference lines 627-631)."""
    U_lower = -np.ones((n, k))
    for i in range(k):
        U_lower[n - k + i :, i] = 0.0
    U_upper = np.ones((n, k))
    return U_lower, U_upper
