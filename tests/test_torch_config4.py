"""BASELINE config 4's frontier step on the CPU, at a small size: rank 5
(k = 5, the shape of K2/K3's slots and of the chord slots' x'Yx sums that
chip_smoke.py's config4 phase runs at 250 x 250 on the card), the
synthetic depth-1 frontier of ``benchmarks/bench_configs.py``'s
``config4()`` (one random unit-vector cut a node, cut_lo = -1, cut_hi =
0.1), the port's ADMM solver against ``omc``'s on the same numpy inputs
in float64, and the float64 host certificate of the lowest slots against
the device bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.data import generate_matrix_completion_data as j_generate
from omc.sdp import admm as jadmm
from omc.sdp.relax import NodeBatch as JNodeBatch
from omc.tree import root_box as j_root_box

from omc_torch import convert
from omc_torch.data import generate_matrix_completion_data
from omc_torch.sdp import admm as tadmm
from omc_torch.sdp import relax as trelax
from omc_torch.tree import root_box

torch.set_num_threads(2)

N = M = 16
K = 5
L = 8
B = 4
GAMMA = 80.0


def _frontier(B, n, k, L):
    """config4()'s synthetic frontier (bench_configs.py:151-175)."""
    rng = np.random.default_rng(0)
    cut_x = rng.standard_normal((B, L, n))
    cut_x /= np.linalg.norm(cut_x, axis=-1, keepdims=True)
    cut_lo = np.tile(np.array([-1.0] * k), (B, L, 1))
    cut_hi = np.tile(np.array([0.1] * k), (B, L, 1))
    cut_mask = np.zeros((B, L))
    cut_mask[:, 0] = 1.0
    lo, hi = root_box(n, k)
    return [cut_x, cut_lo, cut_hi, cut_mask, np.broadcast_to(lo, (B, n, k)).copy(),
            np.broadcast_to(hi, (B, n, k)).copy()]


def test_config4_instance_and_box_match_omc():
    A, idx = generate_matrix_completion_data(K, N, M, int(0.7 * N * M), seed=1)
    Aj, idxj = j_generate(K, N, M, int(0.7 * N * M), seed=1)
    assert np.array_equal(A, Aj) and np.array_equal(idx, idxj)
    for a, b in zip(root_box(N, K), j_root_box(N, K)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("iters", [1, 200])
def test_config4_step_float64_matches_omc(iters):
    """One frontier step (config4()'s solver settings: rho 0.03, check_every
    = iters, from a zero state) in float64: the duals, the device bound and
    its estimator agree with omc's to rounding, and the float64 host
    certificate of the lowest slots is at least the margin-guarded bound."""
    A, idx = generate_matrix_completion_data(K, N, M, int(0.7 * N * M), seed=1)
    mask = idx.astype(np.float64)
    bl = _frontier(B, N, K, L)
    ub_bar = 0.5 * float(np.sum(mask * A * A))
    sX = max(1.0, float(np.abs(A).max()))
    kw = dict(iters=iters, check_every=iters)
    solve_j = jadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=jnp.float64, rho=0.03, **kw)
    st_j = jadmm.init_admm_state(B, N, M, K, L, dtype=jnp.float64, sX=sX, sT=1.0, rho=0.03)
    _, out_j = solve_j(jnp.asarray(A), jnp.asarray(mask),
                       JNodeBatch(*[jnp.asarray(x) for x in bl]), ub_bar, st_j)
    solve_t = tadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=torch.float64, **kw)
    st_t = tadmm.init_admm_state(B, N, M, K, L, torch.float64, device="cpu", sX=sX, sT=1.0,
                                 rho=0.03)
    tb = convert.node_batch_from_numpy(bl, device="cpu")
    _, out_t = solve_t(torch.as_tensor(A), torch.as_tensor(mask), tb, ub_bar, st_t)
    for key in ("y1", "y2", "ya", "yb", "yc", "U"):
        a, b = out_t[key].numpy(), np.asarray(out_j[key])
        assert np.linalg.norm(a - b) <= 1e-9 * max(np.linalg.norm(b), 1e-6), key
    for key in ("lb_dev", "lb_est"):
        a, b = out_t[key].numpy(), np.asarray(out_j[key])
        assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))), key
    lb_est = out_t["lb_est"].numpy()
    sel = np.argsort(lb_est)[:2]
    sub = trelax.NodeBatch(*[x[torch.as_tensor(sel)] for x in tb.fields()])
    sub_out = {key: out_t[key][torch.as_tensor(sel)] for key in ("y1", "y2", "ya", "yb", "yc")}
    lb_host = trelax.host_certified_bound(A, mask, sub, sub_out, GAMMA, K, ub_bar)
    assert np.all(np.isfinite(lb_host))
    assert np.all(out_t["lb_dev"].numpy()[sel] <= lb_host + 1e-9 * np.abs(lb_host))
