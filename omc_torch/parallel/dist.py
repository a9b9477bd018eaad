"""Multi-process frontier distribution (port of ``omc/parallel/dist.py``;
BASELINE config 5).

Every process runs the SAME batched branch-and-bound driver over its own
frontier shard, and the processes synchronise once per super-step round:

- **bound sync** — each round, the processes all-gather a small scalar
  vector (incumbent value, frontier lower-bound candidate, node count, stop
  flag, max cut count, max minor count); the global incumbent is the min
  over processes (pruning with a stale-but-valid incumbent is sound, so sync
  latency never threatens correctness), and the global lower bound is the
  monotone max of the min over processes of frontier candidates;
- **node rebalancing** — every ``rebalance_every`` rounds, processes with
  more than their share of the global frontier serialise surplus nodes into
  fixed-shape float64 vectors (a node IS array data: box, cut tensors,
  scalars) and all-gather them; every process deterministically re-deals
  the pooled nodes round-robin in lower-bound order, so each best-first
  queue stays stocked with good nodes;
- **final gather** — the process owning the best incumbent contributes the
  solution arrays.

Collectives are ``torch.distributed.all_gather`` on CPU float64 tensors over
the gloo backend: the wire is host data, and gloo runs any number of ranks
on one machine, several of them on one GPU.  Every payload's shape is global
(the fused ``RoundState`` fixes it), so every rank gathers the same shape.
Without a process group, ``DistContext`` is a world of one.

Node identity is process-local: a migrated node gets a fresh local id; its
monotone LB, refinement count, cut list, and (when the driver passes a
``state_spec``) its compressed float32 solver-state slice travel with it,
so the receiving process resumes the node's bound refinement warm from its
own duals instead of re-paying refinement visits from the incumbent
template.  Bound validity never depends on the migrated state (safe dual
bounds are valid at any solver state).

The wire format is ``omc.parallel.dist``'s, float for float: a vector
serialised here deserialises there to the same node, and the reverse.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import List, Optional, Tuple

import numpy as np

from omc_torch.tree import BBNode, BBTree, DisjunctiveCut, ShorInfo


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = 300.0) -> None:
    """Join the gloo process group (idempotent).

    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` URL) of
    rank 0's rendezvous; without it the group is read from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Every
    collective of the group fails after ``timeout`` seconds instead of
    waiting forever for a rank that does not come."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        return
    kwargs = dict(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    tdist.init_process_group(**kwargs)


# ---------------------------------------------------------------------------
# Node wire format: one node = one float64 vector
# ---------------------------------------------------------------------------

_HDR = 8  # prio_lb, LB, lb_solver, depth, master_feasible, refines,
# n_cuts, n_minors (-1 => node carries no Shor state)


def state_spec_floats(state_spec) -> int:
    """Wire capacity of a solver-state block: 1 presence flag + the flat
    size of every per-node state leaf (``state_spec`` is a list of
    per-node leaf shapes, batch axis stripped)."""
    if not state_spec:
        return 0
    return 1 + int(sum(int(np.prod(s, dtype=np.int64)) for s in state_spec))


def node_wire_size(n: int, k: int, Lmax: int, Mmax: int = 0,
                   state_spec=None) -> int:
    return (_HDR + 2 * n * k + Lmax * (n + 2 * k) + 4 * Mmax
            + state_spec_floats(state_spec))


def _pack_state(vec: np.ndarray, o: int, leaves, state_spec) -> int:
    """Write a warm-start state slice into the wire at offset ``o``.

    Each leaf is fitted to its spec shape: exact shapes copy verbatim; a
    leaf differing only in the LEADING axis (a smaller/larger cut or minor
    capacity bucket) is row-truncated / zero-padded — the same lossless
    convention as ``omc_torch.sdp.relax.apply_warm_slices``; structurally
    incompatible leaves stay zero (the cone-slot init value).  Returns the
    number of leaves that could NOT be fitted; when more than half the
    leaves are incompatible the presence flag is left 0 (ship no state at
    all): a receiver warm-starting from a mostly-zeroed dual state is worse
    off than starting from its own incumbent template."""
    flag_o = o
    o += 1
    n_bad = 0
    for li, shape in enumerate(state_spec):
        sz = int(np.prod(shape, dtype=np.int64))
        fitted_ok = False
        if li < len(leaves):
            v = np.asarray(leaves[li], np.float64)
            if v.shape == tuple(shape):
                vec[o : o + sz] = v.ravel()
                fitted_ok = True
            elif (
                v.ndim == len(shape) and len(shape) >= 1
                and v.shape[1:] == tuple(shape)[1:]
            ):
                fitted = np.zeros(shape)
                r = min(shape[0], v.shape[0])
                fitted[:r] = v[:r]
                vec[o : o + sz] = fitted.ravel()
                fitted_ok = True
        if not fitted_ok:
            n_bad += 1
        o += sz
    vec[flag_o] = 0.0 if 2 * n_bad > len(state_spec) else 1.0
    return n_bad


def _unpack_state(vec: np.ndarray, o: int, state_spec, compress=np.float32):
    if vec[o] <= 0.5:
        return None
    o += 1
    leaves = []
    for shape in state_spec:
        sz = int(np.prod(shape, dtype=np.int64))
        leaves.append(
            np.asarray(vec[o : o + sz], np.float64)
            .reshape(shape).astype(compress)
        )
        o += sz
    return leaves


def serialize_node(node: BBNode, prio_lb: float, n: int, k: int,
                   Lmax: int, Mmax: int = 0, state=None,
                   state_spec=None, count_refit: bool = False):
    cuts = node.cuts or []
    if len(cuts) > Lmax:
        raise ValueError(f"node has {len(cuts)} cuts > wire capacity {Lmax}")
    minors = (
        list(node.Shor_info.constraints_indexes)
        if node.Shor_info is not None else None
    )
    if minors is not None and len(minors) > Mmax:
        raise ValueError(
            f"node has {len(minors)} Shor minors > wire capacity {Mmax}"
        )
    vec = np.zeros(node_wire_size(n, k, Lmax, Mmax, state_spec))
    vec[0] = prio_lb
    vec[1] = node.LB
    vec[2] = node.lb_solver
    vec[3] = node.depth
    vec[4] = 1.0 if node.master_feasible else 0.0
    vec[5] = node.refines
    vec[6] = len(cuts)
    vec[7] = -1.0 if minors is None else float(len(minors))
    o = _HDR
    vec[o : o + n * k] = np.asarray(node.U_lower).ravel()
    o += n * k
    vec[o : o + n * k] = np.asarray(node.U_upper).ravel()
    o += n * k
    for cut in cuts:
        vec[o : o + n] = cut.x
        o += n
        vec[o : o + k] = cut.vhat
        o += k
        vec[o : o + k] = cut.code
        o += k
    if minors:
        o = _HDR + 2 * n * k + Lmax * (n + 2 * k)
        flat = np.asarray(minors, dtype=np.float64).ravel()
        vec[o : o + flat.size] = flat
    n_bad = 0
    if state_spec and state is not None:
        n_bad = _pack_state(
            vec, _HDR + 2 * n * k + Lmax * (n + 2 * k) + 4 * Mmax,
            state, state_spec,
        )
    return (vec, n_bad) if count_refit else vec


def deserialize_node(vec: np.ndarray, n: int, k: int, Lmax: int,
                     node_id: int, Mmax: int = 0,
                     m: Optional[int] = None,
                     state_spec=None) -> Tuple[float, BBNode, Optional[list]]:
    prio_lb = float(vec[0])
    n_cuts = int(round(vec[6]))
    n_minors = int(round(vec[7]))
    o = _HDR
    U_lower = vec[o : o + n * k].reshape(n, k).copy()
    o += n * k
    U_upper = vec[o : o + n * k].reshape(n, k).copy()
    o += n * k
    cuts = []
    for _ in range(n_cuts):
        x = vec[o : o + n].copy()
        o += n
        vhat = vec[o : o + k].copy()
        o += k
        code = np.asarray(np.round(vec[o : o + k]), dtype=np.int32)
        o += k
        cuts.append(DisjunctiveCut(x=x, vhat=vhat, code=code))
    shor_info = None
    if n_minors >= 0:
        # the SOC coordinate set is the deterministic complement of the
        # active minors (reference lines 656-665), so only minors travel
        from omc_torch.sdp.shor import shor_soc_complement

        if m is None:
            raise ValueError(
                "deserialize_node: `m` is required when the wire vector "
                "carries Shor state (the SOC complement is over the full "
                "n x m coordinate grid; defaulting m=n would build a wrong "
                "complement for rectangular problems)"
            )
        o = _HDR + 2 * n * k + Lmax * (n + 2 * k)
        flat = np.asarray(
            np.round(vec[o : o + 4 * n_minors]), dtype=np.int64
        ).reshape(n_minors, 4)
        minors = [tuple(int(v) for v in row) for row in flat]
        shor_info = ShorInfo(
            constraints_indexes=minors,
            SOC_constraints_indexes=shor_soc_complement(n, m, minors),
        )
    node = BBNode(
        node_id=node_id, parent_id=0, U_lower=U_lower, U_upper=U_upper,
        LB=float(vec[1]), depth=int(round(vec[3])),
        master_feasible=bool(vec[4] > 0.5), cuts=cuts,
        refines=int(round(vec[5])), lb_solver=float(vec[2]),
        Shor_info=shor_info,
    )
    state = None
    if state_spec:
        state = _unpack_state(
            vec, _HDR + 2 * n * k + Lmax * (n + 2 * k) + 4 * Mmax, state_spec
        )
    return prio_lb, node, state


def _extract_surplus(tree: BBTree, n_keep: int) -> List[Tuple[float, BBNode]]:
    """Remove every queued node beyond the best ``n_keep`` (by queued LB);
    returns (priority_lb, node) pairs."""
    items = sorted(tree._heap_lb.items(), key=lambda kv: (kv[1], kv[0]))
    out = []
    for nid, lb in items[n_keep:]:
        node = tree.nodes.pop(nid, None)
        if node is not None:
            tree._heap_lb.pop(nid, None)
            out.append((lb, node))
    return out


def _insert_migrated(tree: BBTree, pairs: List[Tuple[float, BBNode]]) -> None:
    import heapq

    for prio, node in pairs:
        tree.nodes[node.node_id] = node
        tree._fifo.append(node.node_id)
        tree._heap_lb[node.node_id] = prio
        heapq.heappush(tree._heap, (prio, node.node_id))


# ---------------------------------------------------------------------------
# Per-round synchronisation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundState:
    global_ub: float
    global_lb: float
    total_nodes: int
    stop: bool
    counts: np.ndarray  # (P,) per-process node counts
    Lmax: int
    Mmax: int = 0  # max Shor minor count across processes (wire capacity)


class DistContext:
    """Process-side distributed coordination (see module docstring)."""

    def __init__(self, rebalance_every: int = 4):
        import torch.distributed as tdist

        self._tdist = tdist
        self._group = tdist.is_available() and tdist.is_initialized()
        self.process_index = tdist.get_rank() if self._group else 0
        self.process_count = tdist.get_world_size() if self._group else 1
        self.rebalance_every = max(1, rebalance_every)
        self.round = 0
        self._global_lb = -np.inf
        # cumulative wall-clock inside collectives (bound sync +
        # rebalancing): the sync/compute breakdown of a scaling run
        self.sync_seconds = 0.0
        # observability: warm-migration state leaves that failed to fit the
        # wire spec (zero-filled or dropped); a nonzero count means the
        # migration benefit is silently degraded by shape mismatches
        self.state_refit_leaves = 0
        # migrated solver states installed by ``state_put`` on this process
        self.states_installed = 0

    # -- collectives -----------------------------------------------------
    def _allgather(self, vec: np.ndarray) -> np.ndarray:
        """(P, *vec.shape): every rank's ``vec``, in rank order (float64)."""
        import torch

        t0 = time.time()
        x = torch.as_tensor(np.ascontiguousarray(vec, dtype=np.float64))
        if self.process_count == 1:
            out = x[None].numpy().copy()
        else:
            parts = [torch.empty_like(x) for _ in range(self.process_count)]
            self._tdist.all_gather(parts, x)
            out = torch.stack(parts).numpy()
        self.sync_seconds += time.time() - t0
        return out

    def sync_round(self, best_ub: float, lb_candidate: float, n_nodes: int,
                   want_stop: bool, max_cuts: int,
                   max_minors: int = 0) -> RoundState:
        """All-gather per-process scalars; returns the fused global view.
        ``lb_candidate`` is min(queued LBs, closed floor): +inf when the
        process's frontier imposes no constraint."""
        BIG = 1e300
        vec = np.asarray([
            best_ub, min(lb_candidate, BIG), float(n_nodes),
            1.0 if want_stop else 0.0, float(max_cuts), float(max_minors),
        ])
        g = self._allgather(vec)  # (P, 6)
        self.round += 1
        global_ub = float(np.min(g[:, 0]))
        lb_min = float(np.min(g[:, 1]))
        candidate = global_ub if lb_min >= BIG else lb_min
        self._global_lb = max(self._global_lb, min(candidate, global_ub))
        counts = g[:, 2].astype(int)
        return RoundState(
            global_ub=global_ub, global_lb=self._global_lb,
            total_nodes=int(counts.sum()), stop=bool(np.any(g[:, 3] > 0.5)),
            counts=counts, Lmax=int(np.max(g[:, 4])),
            Mmax=int(np.max(g[:, 5])),
        )

    def should_rebalance(self, rs: RoundState) -> bool:
        if self.round % self.rebalance_every != 0:
            return False
        if rs.total_nodes < self.process_count:
            return bool(rs.counts.max() > 0 and rs.counts.min() == 0
                        and rs.total_nodes > 0)
        target = int(np.ceil(rs.total_nodes / self.process_count))
        return bool(rs.counts.max() > 2 * max(1, rs.counts.min())
                    or rs.counts.max() > target + 8)

    def rebalance(self, tree: BBTree, rs: RoundState, n: int, k: int,
                  m: Optional[int] = None, state_spec=None,
                  state_get=None, state_put=None) -> int:
        """All-gather surplus nodes and re-deal them round-robin in LB
        order.  Every process runs this deterministically from the same
        RoundState, so the exchange is collectively consistent.  Returns
        the number of nodes received.

        ``state_spec`` (list of per-node solver-state leaf shapes, derived
        identically on every process from the RoundState's Lmax/Mmax)
        enables WARM migration: each node's cached float32 solver-state
        slice (``state_get(node_id)``) travels on the wire and is installed
        into the receiver's warm-start cache (``state_put(new_node_id,
        leaves)``), so a migrated node resumes refinement from its own
        duals instead of the incumbent template."""
        P = self.process_count
        target = int(np.ceil(rs.total_nodes / P))
        surplus = np.maximum(rs.counts - target, 0)
        max_offer = int(surplus.max())
        if max_offer == 0:
            return 0
        Lmax = max(1, rs.Lmax)
        Mmax = rs.Mmax
        D = node_wire_size(n, k, Lmax, Mmax, state_spec)
        mine = _extract_surplus(tree, target)
        payload = np.zeros((max_offer, D))
        cnt = np.zeros((max_offer,))
        for i, (prio, node) in enumerate(mine):
            st = state_get(node.node_id) if (state_spec and state_get) else None
            payload[i], n_bad = serialize_node(
                node, prio, n, k, Lmax, Mmax, state=st, state_spec=state_spec,
                count_refit=True,
            )
            self.state_refit_leaves += n_bad
            cnt[i] = 1.0
        g_pay = self._allgather(payload)  # (P, max_offer, D)
        g_cnt = self._allgather(cnt)  # (P, max_offer)
        pool = []
        for p in range(P):
            for i in range(max_offer):
                if g_cnt[p, i] > 0.5:
                    pool.append(g_pay[p, i])
        # deterministic deal: sort by priority LB, deal round-robin so each
        # process's best-first queue gets an even slice of good nodes
        pool.sort(key=lambda v: (float(v[0]), float(v[1]), float(v[3])))
        received = []
        for j, vec in enumerate(pool):
            if j % P == self.process_index:
                tree.counter += 1
                prio, node, st = deserialize_node(
                    vec, n, k, Lmax, node_id=tree.counter, Mmax=Mmax, m=m,
                    state_spec=state_spec,
                )
                if st is not None and state_put is not None:
                    state_put(node.node_id, st)
                    self.states_installed += 1
                received.append((prio, node))
        _insert_migrated(tree, received)
        return len(received)

    # -- final solution --------------------------------------------------
    def gather_best_solution(self, objective: float, X: np.ndarray,
                             U: np.ndarray):
        """Return (objective, X, U) of the best incumbent across processes."""
        objs = self._allgather(np.asarray([objective]))[:, 0]
        owner = int(np.argmin(objs))
        gX = self._allgather(np.asarray(X))
        gU = self._allgather(np.asarray(U))
        return float(objs[owner]), gX[owner], gU[owner]

    def sum_counters(self, counters: dict) -> dict:
        """Element-wise sum of integer counters across processes."""
        keys = sorted(counters)
        vec = np.asarray([float(counters[key]) for key in keys])
        g = self._allgather(vec).sum(axis=0)
        return {key: int(val) for key, val in zip(keys, g)}
