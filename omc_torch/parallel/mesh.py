"""Node-batch split over devices (port of ``omc/parallel/mesh.py``;
BASELINE configs 4-5).

``omc`` shards the node axis of a batched solver call over a
``jax.sharding.Mesh`` with ``shard_map``: every device runs the same
batched program on its B/D contiguous slots, the problem data (A, the
observation mask, ``ub_bar`` and the iteration budget) is replicated, and
the host certifies the gathered outputs.  Its code has no device
collective (the ``pmin`` of its docstring is not in it), and neither has
this port:

- a mesh is an explicit list of ``torch.device``s (``make_mesh``): on the
  card it cycles over the visible CUDA devices, so ``mesh_shape=(2,)`` on
  one GPU runs two shards on ``cuda:0``; with ``device="cpu"`` it holds D
  CPU shards;
- ``shard_solver`` and ``shard_solver_shor`` wrap a batched solver with
  ``omc``'s argument order: each node-axis argument is split into D
  contiguous pieces, each piece goes to its shard's device, each shard's
  call runs with that shard's own CUDA stream current (its kernels, their
  parameter blocks and workspaces all live on that stream), and the
  outputs are joined with ``torch.cat`` on the first shard's device.

The shards' calls are issued one after another from this thread (each
call reads its on-device early-exit flag on the host), so on one card a
mesh checks the split and the gather, not a speed-up.  Each shard exits
early on its own slots, as each of ``omc``'s shards does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omc_torch.sdp import admm as _admm


def make_mesh(n_devices: int | None = None, devices=None, *, device="cuda") -> list:
    """``n_devices`` shard devices, cycling over ``devices`` (default: every
    visible CUDA device for ``device="cuda"``, the CPU for
    ``device="cpu"``).  A CUDA mesh without a GPU raises."""
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh needs a CUDA device; none is available")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif dev.type == "cpu":
            devices = [dev]
        else:
            raise ValueError(f"unsupported mesh device {device!r}")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    D = len(devices) if n_devices is None else int(n_devices)
    if D < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return [devices[i % len(devices)] for i in range(D)]


def _node_count(x) -> int:
    """The node-axis length of a batch, state or per-slot argument."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return int(x.shape[0])
    if hasattr(x, "leaves"):
        return _node_count(x.leaves()[0])
    return _node_count(getattr(x, dataclasses.fields(x)[0].name))


def _take(x, sl: slice, dev):
    """Slots ``sl`` of a node-axis argument, on ``dev``: tensors go to the
    device, host (numpy) tables stay on the host, states and batches are
    split leaf by leaf."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[sl].to(dev)
    if isinstance(x, np.ndarray):
        return x[sl]
    if hasattr(x, "from_leaves"):
        return type(x).from_leaves([_take(v, sl, dev) for v in x.leaves()])
    return type(x)(**{f.name: _take(getattr(x, f.name), sl, dev)
                      for f in dataclasses.fields(x)})


def _put(x, dev):
    """A replicated argument on ``dev`` (host values stay as they are)."""
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _join(parts, dev):
    """Concatenate the shards' outputs along the node axis on ``dev``."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(x, dict):
        return {key: _join([p[key] for p in parts], dev) for key in x}
    if isinstance(x, tuple):
        return tuple(_join(list(ps), dev) for ps in zip(*parts))
    return type(x).from_leaves([_join(list(ps), dev) for ps in zip(*(p.leaves() for p in parts))])


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "leaves"):
        for v in x.leaves():
            yield from _tensors(v)


def _sharded(mesh: list, solve, sharded: tuple):
    """``solve`` over the mesh: the arguments at positions ``sharded`` are
    split along the node axis, the others replicated; returns the joined
    ``(state, out)``."""
    D = len(mesh)
    # a shard's parameter blocks (admm._packed) live as long as its call
    _admm.reserve_packed_blocks(D)
    streams = {}

    def step(*args):
        B = _node_count(args[sharded[0]])
        if B % D:
            raise ValueError(f"batch {B} is not divisible by the mesh size {D}")
        Bs = B // D
        results = []
        for i, dev in enumerate(mesh):
            sl = slice(i * Bs, (i + 1) * Bs)
            shard_args = [_take(a, sl, dev) if j in sharded else _put(a, dev)
                          for j, a in enumerate(args)]
            if dev.type != "cuda":
                results.append(solve(*shard_args))
                continue
            if i not in streams:
                streams[i] = torch.cuda.Stream(device=dev)
            s = streams[i]
            caller = torch.cuda.current_stream(dev)
            s.wait_stream(caller)  # the shard's inputs are ready
            with torch.cuda.stream(s):
                res = solve(*shard_args)
            caller.wait_stream(s)
            for t in _tensors(res):  # read on the caller's stream from here
                if t.is_cuda:
                    t.record_stream(caller)
            results.append(res)
        return _join(results, mesh[0])

    return step


def shard_solver(mesh: list, solve, extra_sharded: int = 0):
    """Wrap a batched node solver ``solve(A, mask, batch, ub_bar, state,
    n_iters, ...) -> (state, out)`` so that ``batch``, ``state`` and the
    ``extra_sharded`` trailing per-slot arguments (the ADMM solver's
    ``target`` and ``group``) are split over the mesh, A, the mask,
    ``ub_bar`` and ``n_iters`` replicated.  Same signature as ``solve``."""
    return _sharded(mesh, solve, (2, 4) + tuple(6 + j for j in range(extra_sharded)))


def shard_solver_shor(mesh: list, solve):
    """``shard_solver`` for the Shor solver families' signature
    ``solve(A, mask, batch, shor_batch, ub_bar, state, n_iters, target,
    group)``: the Shor constraint tables are split alongside the batch."""
    return _sharded(mesh, solve, (2, 3, 5, 7, 8))


def put_sharded(mesh: list, tree):
    """A node-axis tensor, state or batch placed for a sharded call: whole,
    on the mesh's first device, where the sharded call splits it (and
    joins its outputs).  Raises unless the mesh size divides its node
    axis."""
    B = _node_count(tree)
    if B % len(mesh):
        raise ValueError(f"batch {B} is not divisible by the mesh size {len(mesh)}")
    return _take(tree, slice(None), mesh[0])


def shard_batch(mesh: list, batch, state):
    """A host-built batch and state placed for a sharded call."""
    return put_sharded(mesh, batch), put_sharded(mesh, state)
