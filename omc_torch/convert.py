"""Carry node batches and solver states across from the ``omc`` reference.

``omc`` keeps them as ``NamedTuple`` pytrees of jax arrays; the port as
dataclasses of torch tensors with the same fields in the same order.  These
helpers take / give the leaves as numpy arrays, so a test can feed both
packages the same state without this package importing jax::

    batch_t = node_batch_from_numpy([np.asarray(x) for x in omc_batch], device="cpu")
    state_t = admm_state_from_numpy([np.asarray(x) for x in omc_state], device="cpu")
    sb_t = shor_batch_from_numpy([np.asarray(x) for x in omc_shor_batch], device="cpu")

Every helper takes the target ``device`` as a required keyword.
"""

from __future__ import annotations

import numpy as np
import torch

from omc_torch.sdp.admm import ADMMState
from omc_torch.sdp.admm_shor import ShorADMMState, ShorBatch, shor_batch_to_device
from omc_torch.sdp.mccormick import MCBatch, MCState
from omc_torch.sdp.relax import NodeBatch
from omc_torch.sdp.shor_encode import OMC_FIELDS, shor_batch_host_from_omc_leaves
from omc_torch.sdp.shor_k import (
    ShorKBatch,
    ShorKState,
    shor_k_batch_host_from_omc_leaves,
    shor_k_batch_to_device,
)


def _tensors(leaves, n_expected, device, dtype):
    leaves = list(leaves)
    if len(leaves) != n_expected:
        raise ValueError(f"expected {n_expected} leaves, got {len(leaves)}")
    return [
        torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()
        for x in leaves
    ]


def node_batch_from_numpy(leaves, *, device, dtype=torch.float64) -> NodeBatch:
    """(cut_x, cut_lo, cut_hi, cut_mask, U_lo, U_hi) -> NodeBatch."""
    return NodeBatch(*_tensors(leaves, 6, device, dtype))


def node_batch_to_numpy(batch: NodeBatch) -> list:
    return [np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
            for x in batch.fields()]


def admm_state_from_numpy(leaves, *, device, dtype=torch.float64) -> ADMMState:
    """The 26 leaves of ``omc.sdp.admm.ADMMState`` (field order) -> ADMMState."""
    return ADMMState.from_leaves(_tensors(leaves, 26, device, dtype))


def admm_state_to_numpy(state) -> list:
    """The leaves of an ADMMState or ShorADMMState as numpy arrays."""
    return [x.detach().cpu().numpy() for x in state.leaves()]


def shor_batch_from_numpy(leaves, *, device, dtype=torch.float64) -> ShorBatch:
    """The 14 leaves of ``omc``'s ShorBatch / ShorBatchHost (field order:
    minor_idx ... cnt_v3) -> ShorBatch, with the adjoint's inverse tables
    built from them."""
    leaves = [np.asarray(x) for x in leaves]
    n, m = leaves[OMC_FIELDS.index("cnt_X")].shape[1:]
    host = shor_batch_host_from_omc_leaves(leaves, n, m)
    return shor_batch_to_device(host, dtype, device=device)


def shor_state_from_numpy(leaves, *, device, dtype=torch.float64) -> ShorADMMState:
    """The leaves of ``omc.sdp.admm_shor.ShorADMMState`` (the 26 core
    leaves, then W, v1, v2, v3, w5, u5, wr, ur, wl, ul, wp, up) ->
    ShorADMMState."""
    return ShorADMMState.from_leaves(_tensors(leaves, 38, device, dtype))


def shor_k_batch_from_numpy(leaves, *, device, dtype=torch.float64) -> ShorKBatch:
    """The 20 leaves of ``omc``'s ShorKBatch / ShorKBatchHost (field order:
    minor_idx ... cnt_v3) -> ShorKBatch, with the kernels' inverse tables
    built from them."""
    return shor_k_batch_to_device(shor_k_batch_host_from_omc_leaves(leaves), dtype,
                                  device=device)


def shor_k_state_from_numpy(leaves, *, device, dtype=torch.float64) -> ShorKState:
    """The 47 leaves of ``omc.sdp.shor_k.ShorKState`` (the 26 core leaves,
    then Xt, W, Wt, Hh, v1, v2, v3, w5, u5, wx, ux, wr, ur, wl, ul, wwl, uwl,
    wp, up, wq, uq) -> ShorKState."""
    return ShorKState.from_leaves(_tensors(leaves, 47, device, dtype))


def mc_batch_from_numpy(leaves, *, device, dtype=torch.float64) -> MCBatch:
    """(U_lo, U_hi) of ``omc.sdp.mccormick.MCBatch`` -> MCBatch."""
    return MCBatch(*_tensors(leaves, 2, device, dtype))


def mc_state_from_numpy(leaves, *, device, dtype=torch.float64) -> MCState:
    """The 24 leaves of ``omc.sdp.mccormick.MCState`` (field order: w1 ...
    uorth, X, Y, Th, U, t, rho, sX, sT) -> MCState."""
    return MCState.from_leaves(_tensors(leaves, 24, device, dtype))
