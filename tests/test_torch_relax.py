"""Parity of the port's safe dual bounds (omc_torch.sdp.relax) with
omc.sdp.relax on the same duals, and of the warm-slice helpers."""

import numpy as np
import pytest
import torch

from omc.data import generate_matrix_completion_data
from omc.sdp import relax as jrelax
from omc.sdp.cuts import region_bounds
from omc.tree import root_box

from omc_torch.sdp import relax as trelax

torch.set_num_threads(2)

N, M, K, B, L = 7, 9, 1, 3, 8
GAMMA = 30.0


def _inputs(seed):
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(K, N, M, 40, seed)
    mask = idx.astype(np.float64)
    lo, hi = root_box(N, K)
    cut_x = np.zeros((B, L, N))
    cut_lo = np.zeros((B, L, K))
    cut_hi = np.zeros((B, L, K))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(3):
            x = rng.standard_normal(N)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, K), rng.uniform(-0.5, 0.5, K))
            cut_mask[b, l] = 1.0
    leaves = [cut_x, cut_lo, cut_hi, cut_mask,
              np.broadcast_to(lo, (B, N, K)).copy(), np.broadcast_to(hi, (B, N, K)).copy()]

    def sym(d):
        S = rng.standard_normal((B, d, d))
        return 0.5 * (S + np.swapaxes(S, -1, -2))

    duals = dict(
        y1=-np.abs(sym(N + M)) * 0.1 + sym(N + M) * 0.05, y2=sym(N + K) * 0.1,
        ya=rng.standard_normal((B, L, K)) * 0.1, yb=rng.standard_normal((B, L, K)) * 0.1,
        yc=rng.standard_normal((B, L)) * 0.1,
    )
    return A, mask, leaves, duals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_safe_dual_bound2_torch_matches_omc_float64(seed):
    A, mask, leaves, d = _inputs(seed)
    ub = 40.0
    lb_j, est_j = jrelax.safe_dual_bound2(
        np, A, mask, jrelax.NodeBatch(*leaves), d["y1"], d["y2"], d["ya"],
        d["yb"], d["yc"], GAMMA, K, ub)
    t = lambda x: torch.as_tensor(x)
    lb_t, est_t = trelax.safe_dual_bound2(
        t(A), t(mask), trelax.NodeBatch(*[t(x) for x in leaves]), t(d["y1"]),
        t(d["y2"]), t(d["ya"]), t(d["yb"]), t(d["yc"]), GAMMA, K, ub)
    for a, b in ((lb_t, lb_j), (est_t, est_j)):
        assert np.all(np.abs(a.numpy() - b) <= 1e-10 * np.maximum(1.0, np.abs(b)))


def test_host_certified_bound_matches_omc():
    A, mask, leaves, d = _inputs(5)
    out32 = {key: val.astype(np.float32) for key, val in d.items()}
    a = trelax.host_certified_bound(A, mask, trelax.NodeBatch(*leaves), out32, GAMMA, K, 40.0)
    b = jrelax.host_certified_bound(A, mask, jrelax.NodeBatch(*leaves), out32, GAMMA, K, 40.0)
    assert np.all(np.abs(a - b) <= 1e-12 * np.maximum(1.0, np.abs(b)))
    assert trelax.margin_rel_default(np.float64) == jrelax.margin_rel_default(np, np.float64)
    assert trelax.margin_rel_default(torch.float32) == jrelax.margin_rel_default(np, np.float32)


def test_apply_warm_slices_matches_omc():
    rng = np.random.default_rng(0)
    base = [rng.standard_normal((4, 8, 2)), rng.standard_normal((4, 3))]
    slices = [None, [rng.standard_normal((32, 2)), rng.standard_normal(3)],
              [rng.standard_normal((5, 2)), rng.standard_normal(4)], None]
    a = trelax.apply_warm_slices([x.copy() for x in base], slices)
    b = jrelax.apply_warm_slices([x.copy() for x in base], slices)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
