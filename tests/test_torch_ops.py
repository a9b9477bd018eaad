"""Parity of the port's cone projections and sign-schedule PSD projection
(omc_torch.ops) with omc.ops, and of the K1 wrapper's CPU path with the
plain merged projection."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.ops import cones as jcones
from omc.ops import linalg as jlinalg
from omc.ops import polar as jpolar

from omc_torch.ops import cones as tcones
from omc_torch.ops import linalg as tlinalg
from omc_torch.ops import polar as tpolar

torch.set_num_threads(2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _sym(rng, *shape):
    M = rng.standard_normal(shape)
    return 0.5 * (M + np.swapaxes(M, -1, -2))


def _spectral(rng, B, d):
    """Symmetric (B, d, d) batches with eigenvalues +-[0.3, 1]."""
    Q = np.linalg.qr(rng.standard_normal((B, d, d)))[0]
    lam = rng.uniform(0.3, 1.0, (B, d)) * rng.choice([-1.0, 1.0], (B, d))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    return 0.5 * (T + np.swapaxes(T, -1, -2))


def test_project_psd_float64():
    M = _sym(np.random.default_rng(0), 5, 7, 7)
    a = tcones.project_psd(torch.as_tensor(M)).numpy()
    b = np.asarray(jcones.project_psd(jnp.asarray(M)))
    assert _rel(a, b) <= 1e-12


def test_project_soc_float64():
    rng = np.random.default_rng(1)
    t = rng.standard_normal(40) * 2.0
    x = rng.standard_normal((40, 6))
    x[:3] = 0.0  # nx == 0 branch
    a = tcones.project_soc(torch.as_tensor(t), torch.as_tensor(x))
    b = jcones.project_soc(jnp.asarray(t), jnp.asarray(x))
    for u, v in zip(a, b):
        assert _rel(u.numpy(), v) <= 1e-12


# Tolerances of the sign schedule.  In float64 the port runs the same
# arithmetic as omc (<= 1e-12).  In float32 two implementations agree only
# to the float32 accuracy of the schedule itself: rounding in the early
# quintic steps is amplified by their slopes (up to ~12 near 1) and the
# cubic polish does not damp errors that mix the two eigenspaces, so each
# float32 run sits 1e-6..3e-5 from the exact projection and two runs with
# different matmul summation orders (torch vs XLA) differ by up to ~6e-5
# on these inputs.  The float32 bar is omc's own (tests/test_cuts_cones.py:
# float32 within 1e-4 of the exact projection), for the port and for the
# port against omc.


@pytest.mark.parametrize("d", [6, 13])
def test_project_psd_ns_float64_same_arithmetic(d):
    T = _spectral(np.random.default_rng(d), 4, d)
    a = tpolar.project_psd_ns(torch.as_tensor(T)).numpy()
    b = np.asarray(jpolar.project_psd_ns(jnp.asarray(T)))
    assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("d", [6, 13, 40])
def test_project_psd_ns_float32(d):
    T = _spectral(np.random.default_rng(d), 4, d)
    exact = tcones.project_psd(torch.as_tensor(T)).numpy()
    a = tpolar.project_psd_ns(torch.as_tensor(T.astype(np.float32))).numpy()
    b = np.asarray(jpolar.project_psd_ns(jnp.asarray(T.astype(np.float32))))
    assert _rel(a, exact) <= 1e-4
    assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("d", [6, 13, 40])
def test_project_psd_ns_float32_bar_rejects_tf32_grade_products(d):
    """Control of the float32 bar above: the same schedule with TF32-grade
    products (operands cut to a 10-bit mantissa) must fail it."""
    T = _spectral(np.random.default_rng(d), 4, d)
    exact = tcones.project_psd(torch.as_tensor(T)).numpy()
    bad = tpolar.project_psd_ns(
        torch.as_tensor(T.astype(np.float32)), matmul=tpolar.truncated_matmul(10)
    ).numpy()
    assert not _rel(bad, exact) <= 1e-4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_project_psd_ns_merged(dtype):
    rng = np.random.default_rng(7)
    mats = [_spectral(rng, 3, d) for d in (12, 7, 6)]
    cast = [t.astype(dtype) for t in mats]
    a = tpolar.project_psd_ns_merged([torch.as_tensor(t) for t in cast])
    b = jpolar.project_psd_ns_merged([jnp.asarray(t) for t in cast])
    tol = 1e-12 if dtype == "float64" else 1e-4
    for u, v, t in zip(a, b, mats):
        assert _rel(u.numpy(), v) <= tol
        assert _rel(u.numpy(), tcones.project_psd(torch.as_tensor(t)).numpy()) <= max(tol, 1e-12)


def test_k1_wrapper_cpu_path_is_plain_merged():
    """The K1 wrapper on CPU tensors is the plain merged projection with the
    u/EMA epilogue — exactly, not within a tolerance."""
    rng = np.random.default_rng(3)
    ts = [torch.as_tensor(_sym(rng, 4, d, d).astype(np.float32)) for d in (11, 6, 5)]
    ref = tpolar.project_psd_ns_merged(ts)
    ws = tpolar.project_psd_ns_multi(ts)
    for w, r in zip(ws, ref):
        assert torch.equal(w, r)
    rho = torch.tensor([0.1, 0.2, 0.3, 0.4])
    beta = 0.01
    w_out = [torch.empty_like(t) for t in ts]
    u_out = [torch.empty_like(t) for t in ts]
    acc = [torch.ones_like(ts[0]), torch.ones_like(ts[1]), None]
    tpolar.project_psd_ns_multi(ts, w_out=w_out, u_out=u_out, acc=acc, rho=rho, beta=beta)
    for g in range(3):
        assert torch.equal(w_out[g], ref[g])
        assert torch.equal(u_out[g], ts[g] - ref[g])
    for g in range(2):
        one = torch.ones_like(ts[g])
        assert torch.equal(acc[g], one + beta * (rho[:, None, None] * u_out[g] - one))


def test_ridge_steps_float64():
    rng = np.random.default_rng(4)
    n, m, k, B = 7, 9, 2, 3
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.6).astype(np.float64)
    U = rng.standard_normal((B, n, k))
    Vt = tlinalg.v_step(torch.as_tensor(U), torch.as_tensor(A), torch.as_tensor(mask), 5.0)
    Ut = tlinalg.u_step_unconstrained(Vt, torch.as_tensor(A), torch.as_tensor(mask), 5.0)
    for b in range(B):
        Vj = jlinalg.v_step(jnp.asarray(U[b]), jnp.asarray(A), jnp.asarray(mask), 5.0)
        Uj = jlinalg.u_step_unconstrained(Vj, jnp.asarray(A), jnp.asarray(mask), 5.0)
        assert _rel(Vt[b].numpy(), Vj) <= 1e-12
        assert _rel(Ut[b].numpy(), Uj) <= 1e-12
