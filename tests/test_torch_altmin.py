"""Parity of the port's batched alternating minimisation (omc_torch.altmin)
with omc.altmin in float64: U, V, objective, convergence flags, iteration
counts and objective traces, with and without cut constraints."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc import altmin as jaltmin
from omc.data import generate_matrix_completion_data
from omc.sdp.cuts import region_bounds
from omc.tree import root_box

from omc_torch import altmin as taltmin

torch.set_num_threads(2)


def _inputs(k, seed, B=4, n=9, m=11, L=3):
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(k, n, m, int(0.6 * n * m), seed)
    mask = idx.astype(np.float64)
    U0 = rng.standard_normal((B, n, k))
    lo, hi = root_box(n, k)
    lo = np.broadcast_to(lo, (B, n, k)).copy()
    hi = np.broadcast_to(hi, (B, n, k)).copy()
    cut_x = np.zeros((B, L, n))
    cut_lo = np.zeros((B, L, k))
    cut_hi = np.zeros((B, L, k))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(2):
            x = rng.standard_normal(n)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, k), rng.uniform(-0.5, 0.5, k))
            cut_mask[b, l] = 1.0
    return A, mask, U0, lo, hi, (cut_x, cut_lo, cut_hi, cut_mask)


def _compare(rt, rj, tol=1e-9):
    for key in ("U", "V", "objective", "obj_trace"):
        a = getattr(rt, key).numpy()
        b = np.asarray(getattr(rj, key))
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), key
        assert np.all(np.abs(a[fin] - b[fin]) <= tol * np.maximum(1.0, np.abs(b[fin]))), key
    assert np.array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert np.array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("with_cuts", [False, True])
def test_altmin_matches_omc_float64(k, with_cuts):
    A, mask, U0, lo, hi, cuts = _inputs(k, seed=10 * k + with_cuts)
    n, m = A.shape
    fj = jaltmin.make_altmin(n, m, k, 20.0, max_iters=40, tol=1e-5, dtype=jnp.float64)
    ft = taltmin.make_altmin(n, m, k, 20.0, max_iters=40, tol=1e-5, dtype=torch.float64)
    kw_j, kw_t = {}, {}
    if with_cuts:
        names = ("cut_x", "cut_lo", "cut_hi", "cut_mask")
        kw_j = {nm: jnp.asarray(c) for nm, c in zip(names, cuts)}
        kw_t = {nm: torch.as_tensor(c) for nm, c in zip(names, cuts)}
    rj = fj(jnp.asarray(A), jnp.asarray(mask), jnp.asarray(U0), jnp.asarray(lo),
            jnp.asarray(hi), **kw_j)
    rt = ft(torch.as_tensor(A), torch.as_tensor(mask), torch.as_tensor(U0),
            torch.as_tensor(lo), torch.as_tensor(hi), **kw_t)
    _compare(rt, rj)


def test_altmin_box_mode_matches_omc():
    A, mask, U0, lo, hi, _ = _inputs(2, seed=3)
    n, m = A.shape
    box_on = np.array([1.0, 0.0, 1.0, 0.0])
    rj = jaltmin.make_altmin(n, m, 2, 20.0, max_iters=30, dtype=jnp.float64)(
        jnp.asarray(A), jnp.asarray(mask), jnp.asarray(U0), jnp.asarray(lo),
        jnp.asarray(hi), box_on=jnp.asarray(box_on))
    rt = taltmin.make_altmin(n, m, 2, 20.0, max_iters=30, dtype=torch.float64)(
        torch.as_tensor(A), torch.as_tensor(mask), torch.as_tensor(U0),
        torch.as_tensor(lo), torch.as_tensor(hi), box_on=torch.as_tensor(box_on))
    _compare(rt, rj)
