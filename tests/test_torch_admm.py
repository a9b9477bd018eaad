"""Parity of the port's ADMM solver (omc_torch.sdp.admm) with omc.sdp.admm.

Both packages get the same inputs, made with numpy from a seed: n = m = 8,
k = 1, B = 4 node slots, L = 8 cut capacity with two real cuts per slot.
In float64 the PSD projections take the exact eigh path in both, so the
iterates agree to rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.sdp import admm as jadmm
from omc.sdp.cuts import region_bounds
from omc.sdp.relax import NodeBatch as JNodeBatch
from omc.tree import root_box

from omc_torch import convert
from omc_torch.sdp import admm as tadmm

torch.set_num_threads(2)

N = M = 8
K = 1
B = 4
L = 8
GAMMA = 40.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _setup(dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(K, N, M, 40, seed)
    mask = idx.astype(np.float64)
    lo0, hi0 = root_box(N, K)
    cut_x = np.zeros((B, L, N))
    cut_lo = np.zeros((B, L, K))
    cut_hi = np.zeros((B, L, K))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(2):  # two real cuts per slot
            x = rng.standard_normal(N)
            cut_x[b, l] = x / np.linalg.norm(x)
            vhat = rng.uniform(-0.6, 0.6, size=K)
            code = rng.integers(0, 2, size=K)
            cut_lo[b, l], cut_hi[b, l] = region_bounds("linear", code, vhat)
            cut_mask[b, l] = 1.0
    leaves = [cut_x, cut_lo, cut_hi, cut_mask,
              np.broadcast_to(lo0, (B, N, K)).copy(),
              np.broadcast_to(hi0, (B, N, K)).copy()]
    leaves = [x.astype(dtype) for x in leaves]
    # incumbent-like primal warm start, then random slot values and duals
    u = rng.standard_normal(N)
    u /= np.linalg.norm(u)
    U0 = u[:, None]
    V0 = U0.T @ (mask * A)
    X0 = U0 @ V0
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = 3.0
    st = jadmm.init_admm_state(
        B, N, M, K, L, jnp.float64, sX=sX, sT=sT, X0=X0[None],
        Y0=(U0 @ U0.T)[None], Th0=(V0.T @ V0)[None], U0=U0[None], rho=0.05,
    )
    st_leaves = [np.asarray(x, np.float64).copy() for x in st]
    for i in range(18):  # w1..wc, u1..uc
        st_leaves[i] = st_leaves[i] + 0.1 * rng.standard_normal(st_leaves[i].shape)
    st_leaves[6:9] = [st_leaves[j] * cut_mask.reshape(B, L, *([1] * (st_leaves[j].ndim - 2)))
                      for j in range(6, 9)]
    st_leaves[15:18] = [st_leaves[j] * cut_mask.reshape(B, L, *([1] * (st_leaves[j].ndim - 2)))
                        for j in range(15, 18)]
    st_leaves[22] = np.array([0.05, 0.02, 0.2, 0.0125])  # per-slot rho
    st_leaves = [x.astype(dtype) for x in st_leaves]
    return A.astype(dtype), mask.astype(dtype), leaves, st_leaves


def _jax_batch(leaves):
    return JNodeBatch(*[jnp.asarray(x) for x in leaves])


def test_gram1_forward_adjoint_parity():
    A, mask, bl, sl = _setup()
    jb, tb = _jax_batch(bl), convert.node_batch_from_numpy(bl, device="cpu")
    G_j = np.asarray(jadmm._gram1(jb, K, jnp.float64))
    G_t = tadmm._gram1(tb, K, torch.float64).numpy()
    assert _rel(G_t, G_j) <= 1e-12
    rng = np.random.default_rng(1)
    prim = [rng.standard_normal(s) for s in ((B, N, M), (B, N, N), (B, M, M), (B, N, K))]
    prim[1] = prim[1] + prim[1].transpose(0, 2, 1)
    sX = rng.uniform(1, 2, (B, 1, 1))
    sT = rng.uniform(1, 2, (B, 1, 1))
    fj = jadmm._forward(jb, *[jnp.asarray(p) for p in prim], K, jnp.asarray(sX), jnp.asarray(sT))
    ft = tadmm._forward(tb, *[torch.as_tensor(p) for p in prim], K, torch.as_tensor(sX),
                        torch.as_tensor(sT))
    for a, b in zip(ft, fj):
        assert _rel(a.numpy(), b) <= 1e-12
    duals = [rng.standard_normal(np.shape(f)) for f in fj]
    gj = jadmm._adjoint(jb, *[jnp.asarray(d) for d in duals], N, M, K,
                        jnp.asarray(sX), jnp.asarray(sT))
    gt = tadmm._adjoint(tb, *[torch.as_tensor(d) for d in duals], N, M, K,
                        torch.as_tensor(sX), torch.as_tensor(sT))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= 1e-12


def test_solve_z_parity():
    """The rho-free Woodbury z-step, same right-hand sides: <= 1e-12."""
    A, mask, bl, sl = _setup()
    jb, tb = _jax_batch(bl), convert.node_batch_from_numpy(bl, device="cpu")
    rng = np.random.default_rng(2)
    rho = np.array([0.05, 0.02, 0.2, 0.0125])
    sX = rng.uniform(1, 2, (B, 1, 1))
    sT = rng.uniform(1, 2, (B, 1, 1))
    rhs = [rng.standard_normal(s) for s in ((B, N, N), (B, N, M), (B, M, M), (B, N, K))]
    # reference: the solve_z closure of omc's make_admm_solver, restated
    G1c = jnp.linalg.cholesky(jadmm._gram1(jb, K, jnp.float64))
    r3 = rho[:, None, None]
    zX_j = rhs[1] / (mask[None] * (sX * sX) + r3 * 2.0 * sX * sX)
    zY_j = rhs[0] / (3.0 * r3)
    zTh_j = rhs[2] / (r3 * sT * sT)
    zU_j = rhs[3] / (4.0 * r3)
    import jax.scipy.linalg as jsl

    s = jadmm._Vt_apply(jb, jnp.asarray(zY_j), jnp.asarray(zU_j), K)
    t = rho[:, None] * jsl.cho_solve((G1c, True), s[..., None])[..., 0]
    vY, vU = jadmm._V_apply(jb, t, N, K)
    zY_j = zY_j - np.asarray(vY) / (3.0 * r3)
    zU_j = zU_j - np.asarray(vU) / (4.0 * r3)
    G1c_t = torch.linalg.cholesky(tadmm._gram1(tb, K, torch.float64))
    out_t = tadmm.solve_z(
        tb, G1c_t, torch.as_tensor(mask), torch.as_tensor(sX), torch.as_tensor(sT),
        torch.as_tensor(rho), *[torch.as_tensor(r) for r in rhs], N, K,
    )
    for a, b in zip(out_t, (zX_j, zY_j, zTh_j, zU_j)):
        assert _rel(a.numpy(), b) <= 1e-12


def _run_both(dtype, iters, psd_method, check_every=100):
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sl = _setup(np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    kw = dict(iters=iters, alpha=1.9, psd_method=psd_method,
              check_every=check_every, ema_iters=100)
    solve_j = jadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=jdt, **kw)
    solve_t = tadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=tdt, **kw)
    ub = 50.0
    st_j = jadmm.ADMMState(*[jnp.asarray(x) for x in sl])
    fin_j, out_j = solve_j(jnp.asarray(A), jnp.asarray(mask), _jax_batch(bl), ub, st_j)
    st_t = convert.admm_state_from_numpy(sl, dtype=tdt, device="cpu")
    tb = convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu")
    fin_t, out_t = solve_t(torch.as_tensor(A), torch.as_tensor(mask), tb, ub, st_t)
    return fin_j, out_j, fin_t, out_t, st_t


def test_admm_solve_300_iterations_float64_parity():
    """300 iterations from the same state: iterates <= 1e-9 relative, the
    on-device bound and estimator <= 1e-8 relative, same iters_run; the
    input state is left untouched."""
    fin_j, out_j, fin_t, out_t, st_t = _run_both("float64", 300, "eigh")
    _, _, _, _, st_ref = _run_both("float64", 0, "eigh")
    for a, b in zip(st_t.leaves(), st_ref.leaves()):
        assert torch.equal(a, b)
    for name, a, b in zip(
        [f.name for f in tadmm.dataclasses.fields(tadmm.ADMMState)],
        convert.admm_state_to_numpy(fin_t), [np.asarray(x) for x in fin_j],
    ):
        assert _rel(a, b) <= 1e-9, name
    for key in ("y1", "y2", "ya", "yb", "yc", "X", "Y", "Th", "U"):
        assert _rel(out_t[key].numpy(), out_j[key]) <= 1e-9, key
    for key in ("lb_dev", "lb_est"):
        a, b = out_t[key].numpy(), np.asarray(out_j[key])
        assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))), key
    assert np.array_equal(out_t["iters_run"].numpy(), np.asarray(out_j["iters_run"]))
    assert _rel(np.abs(out_t["sep_w"].numpy()), np.abs(np.asarray(out_j["sep_w"]))) <= 1e-9


def test_admm_solve_float32_sign_schedule_bound():
    """float32 with the sign-schedule projection (the GPU path's algorithm,
    run here through the plain merged projection): bound <= 1e-4 relative."""
    fin_j, out_j, fin_t, out_t, _ = _run_both("float32", 300, "ns")
    for key in ("lb_est",):
        a = out_t[key].numpy().astype(np.float64)
        b = np.asarray(out_j[key], np.float64)
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), (a, b)


def test_admm_early_exit_and_groups_match():
    """target/group early exit: both packages stop at the same chunk."""
    A, mask, bl, sl = _setup()
    kw = dict(iters=2000, alpha=1.9, check_every=100, ema_iters=100)
    solve_j = jadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=jnp.float64, **kw)
    solve_t = tadmm.make_admm_solver(N, M, K, L, GAMMA, dtype=torch.float64, **kw)
    _, out0 = solve_t(torch.as_tensor(A), torch.as_tensor(mask),
                      convert.node_batch_from_numpy(bl, device="cpu"), 50.0,
                      convert.admm_state_from_numpy(sl, device="cpu"), 300)
    target = out0["lb_est"].numpy() - 1e-3
    target[2:] = -np.inf
    group = np.array([5, 6, 5, 6], dtype=np.int32)  # re-based to 0/1
    _, out_j = solve_j(jnp.asarray(A), jnp.asarray(mask), _jax_batch(bl), 50.0,
                       jadmm.ADMMState(*[jnp.asarray(x) for x in sl]), 2000,
                       jnp.asarray(target), jnp.asarray(group))
    _, out_t = solve_t(torch.as_tensor(A), torch.as_tensor(mask),
                       convert.node_batch_from_numpy(bl, device="cpu"), 50.0,
                       convert.admm_state_from_numpy(sl, device="cpu"), 2000,
                       torch.as_tensor(target), torch.as_tensor(group))
    assert int(out_t["iters_run"][0]) == int(np.asarray(out_j["iters_run"])[0]) < 2000


@pytest.mark.parametrize("fn", ["set_slot_rho", "init_admm_state"])
def test_state_helpers_parity(fn):
    A, mask, bl, sl = _setup()
    if fn == "set_slot_rho":
        new = np.array([0.1, 0.01, 0.3, 0.05])
        a = tadmm.set_slot_rho(convert.admm_state_from_numpy(sl, device="cpu"), torch.as_tensor(new))
        b = jadmm.set_slot_rho(jadmm.ADMMState(*[jnp.asarray(x) for x in sl]), new)
    else:
        sX = np.array([1.5, 2.0, 1.0, 3.0])
        X0 = np.arange(N * M, dtype=np.float64).reshape(1, N, M)
        a = tadmm.init_admm_state(B, N, M, K, L, torch.float64, sX=sX, sT=2.0,
                                  X0=X0, rho=0.03, device="cpu")
        b = jadmm.init_admm_state(B, N, M, K, L, jnp.float64, sX=sX, sT=2.0,
                                  X0=X0, rho=0.03)
    for x, y in zip(convert.admm_state_to_numpy(a), b):
        assert x.shape == np.shape(y)
        assert _rel(x, y) <= 1e-15
