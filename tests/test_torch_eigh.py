"""The eigensolvers of the port's safe bounds and separation (kernels K4,
K4s, K5) and altmin's ridge steps (K6) on the CPU.

The kernels run on the GPU only (``chip_smoke.py`` holds them against their
plain versions there).  Here: (a) the torch mirror of K4's Jacobi schedule
(``omc_torch.ops.jacobi``: the same round robin with a bye, rotation and
stopping rule) against LAPACK and against ``omc``'s ``jnp.linalg.eigh``;
(b) the three safe bounds through the wrappers' CPU branch against
``omc``'s ``xp=jnp`` bounds; (c) ``separation_eigpairs`` against
``omc``'s ``jnp.linalg.eigh(UU' - Y)[..., :2]``; (d) the ridge steps
against ``omc.ops.linalg``; (e) a CUDA tensor without a GPU raises and
never takes the plain path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.ops import linalg as jlinalg
from omc.sdp import admm_shor as jshor
from omc.sdp import relax as jrelax
from omc.sdp import shor_k as jshk

from omc_torch import convert
from omc_torch.ops import cones as tcones
from omc_torch.ops import jacobi
from omc_torch.ops import linalg as tlinalg
from omc_torch.sdp import admm_shor as tshor
from omc_torch.sdp import relax as trelax
from omc_torch.sdp import shor_k as tshk

torch.set_num_threads(2)


def _spectra(rng, d, nb=4):
    """Symmetric (nb, d, d) matrices Q diag(lam) Q': a generic spectrum, a
    degenerate one (clusters of equal and of 1e-9-close eigenvalues, a
    negative cluster, repeated zeros), a rank-1 PSD one and a rank-deficient
    PSD one."""
    Q = np.linalg.qr(rng.standard_normal((nb, d, d)))[0]
    lam = rng.uniform(-1.0, 1.0, (nb, d))
    c = max(1, d // 4)
    lam[1, :c] = 0.5
    lam[1, c:2 * c] = -0.3 + 1e-9 * np.arange(c)
    lam[1, 2 * c:3 * c] = 0.0
    lam[2] = 0.0
    lam[2, 0] = 2.0
    lam[3] = np.abs(lam[3])
    lam[3, d // 2:] = 0.0
    return np.einsum("bik,bk,bjk->bij", Q, lam, Q)


def _psd_np(M):
    w, V = np.linalg.eigh(M)
    return np.einsum("bik,bk,bjk->bij", V, np.maximum(w, 0.0), V)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [5, 8, 9, 12, 13, 50, 51])
def test_jacobi_mirror_matches_lapack_and_omc(d, dtype):
    M = _spectra(np.random.default_rng(d), d).astype(dtype)
    w, V, sweeps = jacobi.jacobi_eigh(torch.as_tensor(M))
    M64 = M.astype(np.float64)
    w_np = np.linalg.eigh(M64)[0]
    w_jnp = np.asarray(jnp.linalg.eigh(jnp.asarray(M64))[0])
    scale = np.max(np.abs(w_np), axis=-1, keepdims=True)
    tol = 1e-12 if dtype == "float64" else 1e-5
    w = w.double().numpy()
    V = V.double().numpy()
    assert np.all(np.abs(w - w_np) <= tol * scale)
    assert np.all(np.abs(w - w_jnp) <= tol * scale)
    # vectors: eigenvectors of M (clusters make them unique only as a
    # subspace), orthonormal, and the projection they give
    res = np.einsum("bij,bjk->bik", M64, V) - V * w[:, None, :]
    assert np.all(np.linalg.norm(res, axis=(-2, -1)) <= tol * np.sqrt(d) * scale[:, 0])
    eye = np.eye(d)
    assert np.all(np.linalg.norm(np.swapaxes(V, -1, -2) @ V - eye, axis=(-2, -1))
                  <= tol * np.sqrt(d))
    P, _ = jacobi.jacobi_project_psd(torch.as_tensor(M))
    P_np = _psd_np(M64)
    rel = np.linalg.norm(P.double().numpy() - P_np, axis=(-2, -1)) / np.maximum(
        np.linalg.norm(P_np, axis=(-2, -1)), 1e-30)
    assert np.all(rel <= tol)
    assert np.all(sweeps.numpy() <= jacobi.MAX_SWEEPS)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_jacobi_mirror_non_finite_input_ends_at_the_cap(bad):
    M = _spectra(np.random.default_rng(0), 12)
    M[0, 3, 4] = bad
    w, V, sweeps = jacobi.jacobi_eigh(torch.as_tensor(M), max_sweeps=12)
    assert sweeps[0].item() == 13  # the cap plus one: it never converged
    assert torch.isnan(w[0]).all() and torch.isnan(V[0]).all()
    assert torch.all(sweeps[1:] <= 12) and torch.isfinite(w[1:]).all()


@pytest.mark.parametrize("d", [1, 2, 7, 10])
def test_round_robin_meets_every_pair_once_per_sweep(d):
    rounds = jacobi.round_robin(d)
    seen = [(int(p), int(q)) for ps, qs in rounds for p, q in zip(ps, qs)]
    assert sorted(seen) == [(p, q) for p in range(d) for q in range(p + 1, d)]
    for ps, qs in rounds:  # the pairs of a round are disjoint
        idx = ps.tolist() + qs.tolist()
        assert len(set(idx)) == len(idx)


# ---- (b) the safe bounds through the wrappers' CPU branch ----


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Count the calls of the ops.cones wrappers from the bound modules."""
    calls = {"eigvalsh": 0, "project_psd": 0}
    for mod in (trelax, tshor, tshk):
        for name in calls:
            if hasattr(mod, name):
                orig = getattr(tcones, name)

                def counted(*a, _name=name, _orig=orig, **kw):
                    calls[_name] += 1
                    return _orig(*a, **kw)

                monkeypatch.setattr(mod, name, counted)
    return calls


def _close(a, b, tol=1e-10):
    b = np.asarray(b, np.float64)
    return np.all(np.abs(np.asarray(a, np.float64) - b) <= tol * np.maximum(1.0, np.abs(b)))


def test_safe_dual_bound2_through_wrappers_matches_omc_jnp(wrapper_calls):
    from test_torch_relax import GAMMA, K, _inputs

    A, mask, leaves, d = _inputs(3)
    names = ("y1", "y2", "ya", "yb", "yc")
    J = jnp.asarray
    lb_j, est_j = jrelax.safe_dual_bound2(
        jnp, J(A), J(mask), jrelax.NodeBatch(*map(J, leaves)), *[J(d[x]) for x in names],
        GAMMA, K, 40.0)
    T = torch.as_tensor
    lb_t, est_t = trelax.safe_dual_bound2(
        T(A), T(mask), trelax.NodeBatch(*map(T, leaves)), *[T(d[x]) for x in names],
        GAMMA, K, 40.0)
    assert _close(lb_t, lb_j) and _close(est_t, est_j)
    # S1 and S2 projected, lambda_max(R1), G_Y, G_Theta
    assert wrapper_calls == {"eigvalsh": 3, "project_psd": 2}


def test_safe_dual_bound_shor2_through_wrappers_matches_omc_jnp(wrapper_calls):
    from test_torch_shor import GAMMA, B, K, L, M, M5, N, _setup

    A, mask, bl, sbj, _, _ = _setup()
    rng = np.random.default_rng(7)
    shapes = [(B, N + M, N + M), (B, N + K, N + K), (B, L, K), (B, L, K), (B, L),
              (B, M5, 5, 5), (B, N * M, 3), (B, M)]
    duals = [rng.standard_normal(s) * 0.2 for s in shapes]
    sX, sS = np.array([1.5, 1.1]), np.array([1.5, 0.8])
    ub = 0.5 * float(np.sum(mask * A * A))
    T = torch.as_tensor
    a = tshor.safe_dual_bound_shor2(
        T(A), T(mask), convert.node_batch_from_numpy(bl, device="cpu"),
        convert.shor_batch_from_numpy(list(sbj), device="cpu"), *map(T, duals), GAMMA, ub,
        sX=T(sX), sS=T(sS))
    b = jshor.safe_dual_bound_shor2(jnp, jnp.asarray(A), jnp.asarray(mask),
                                    jrelax.NodeBatch(*map(jnp.asarray, bl)),
                                    jshor.shor_batch_to_device(sbj, jnp.float64),
                                    *map(jnp.asarray, duals), GAMMA, ub,
                                    sX=jnp.asarray(sX), sS=jnp.asarray(sS))
    assert all(_close(x.numpy(), y) for x, y in zip(a, b))
    # S1, S2 and the 5x5 minor duals projected; G_Y and G_Theta
    assert wrapper_calls == {"eigvalsh": 2, "project_psd": 3}


def test_safe_dual_bound_shor_k2_through_wrappers_matches_omc_jnp(wrapper_calls):
    from test_torch_shor_k import GAMMA, B, C, K, L, M, M5, N, _setup

    A, mask, bl, sbj, _, _ = _setup()
    rng = np.random.default_rng(7)
    shapes = [(B, N + M, N + M), (B, N + K, N + K), (B, L, K), (B, L, K), (B, L),
              (B, M5, K, 5, 5), (B, C, K + 1, K + 1), (B, N * M, 3), (B, M), (B, C)]
    duals = [rng.standard_normal(s) * 0.2 for s in shapes]
    sX, sS = np.array([1.5, 1.1]), np.array([1.5, 0.8])
    ub = 0.5 * float(np.sum(mask * A * A))
    T = torch.as_tensor
    a = tshk.safe_dual_bound_shor_k2(
        T(A), T(mask), convert.node_batch_from_numpy(bl, device="cpu"),
        convert.shor_k_batch_from_numpy(list(sbj), device="cpu"), *map(T, duals), GAMMA, K, ub,
        sX=T(sX), sS=T(sS))
    b = jshk.safe_dual_bound_shor_k2(jnp, jnp.asarray(A), jnp.asarray(mask),
                                     jrelax.NodeBatch(*map(jnp.asarray, bl)),
                                     jshk.shor_k_batch_to_device(sbj, jnp.float64),
                                     *map(jnp.asarray, duals), GAMMA, K, ub,
                                     sX=jnp.asarray(sX), sS=jnp.asarray(sS))
    assert all(_close(x.numpy(), y) for x, y in zip(a, b))
    # S1, S2, the per-term minors and the XWH slots projected; G_Y, G_Theta
    assert wrapper_calls == {"eigvalsh": 2, "project_psd": 4}


# ---- (c) the separation ----


@pytest.mark.parametrize("n,k", [(6, 1), (9, 2), (12, 3)])
def test_separation_eigpairs_matches_omc(n, k):
    rng = np.random.default_rng(n)
    U = rng.standard_normal((3, n, k))
    Y = rng.standard_normal((3, n, n))
    Y = 0.5 * (Y + np.swapaxes(Y, -1, -2))
    w, V = trelax.separation_eigpairs(torch.as_tensor(U), torch.as_tensor(Y))
    Mj = jnp.einsum("bik,bjk->bij", jnp.asarray(U), jnp.asarray(U)) - jnp.asarray(Y)
    wj, Vj = jnp.linalg.eigh(0.5 * (Mj + jnp.swapaxes(Mj, -1, -2)))
    wj, Vj = np.asarray(wj[..., :2]), np.asarray(Vj[..., :, :2])
    assert w.shape == (3, 2) and V.shape == (3, n, 2)
    assert np.all(np.abs(w.numpy() - wj) <= 1e-12 * np.maximum(1.0, np.abs(wj)))
    # eigenvectors up to sign: neither package fixes it
    sign = np.sign(np.sum(V.numpy() * Vj, axis=-2, keepdims=True))
    assert np.all(np.abs(V.numpy() * sign - Vj) <= 1e-10)


# ---- (d) altmin's ridge steps ----


@pytest.mark.parametrize("k", [1, 2, 3, 5, 10])
def test_ridge_steps_match_omc(k):
    rng = np.random.default_rng(10 + k)
    # k <= 3 at 9 x 7; k = 5 and 10 (K6's config-4 and config-5 ranks) on
    # more rows and columns than k, so the ridged systems stay well posed
    n, m, B = (9, 7, 3) if k <= 3 else (3 * k, 2 * k + 5, 3)
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.6).astype(np.float64)
    U = rng.standard_normal((B, n, k))
    T = torch.as_tensor
    Vt = tlinalg.v_step(T(U), T(A), T(mask), 7.0)
    Ut = tlinalg.u_step_unconstrained(Vt, T(A), T(mask), 7.0)
    for b in range(B):
        Vj = np.asarray(jlinalg.v_step(jnp.asarray(U[b]), jnp.asarray(A), jnp.asarray(mask), 7.0))
        Uj = np.asarray(jlinalg.u_step_unconstrained(jnp.asarray(Vj), jnp.asarray(A),
                                                     jnp.asarray(mask), 7.0))
        assert np.linalg.norm(Vt[b].numpy() - Vj) <= 1e-12 * np.linalg.norm(Vj)
        assert np.linalg.norm(Ut[b].numpy() - Uj) <= 1e-12 * np.linalg.norm(Uj)


# ---- (e) no silent CPU path for a CUDA tensor ----


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


def _cuda_calls():
    f = lambda *s: torch.zeros(*s).as_subclass(_FakeCuda)  # noqa: E731
    return {
        "eigvalsh": lambda: tcones.eigvalsh(f(2, 12, 12)),
        "eigh": lambda: tcones.k4_jacobi(f(2, 12, 12), 2),
        "project_psd_k4": lambda: tcones.project_psd(f(2, 12, 12)),
        "project_psd_k4s": lambda: tcones.project_psd(f(2, 3, 5, 5)),
        "separation_eigpairs": lambda: trelax.separation_eigpairs(f(2, 6, 1), f(2, 6, 6)),
        "v_step": lambda: tlinalg.v_step(f(2, 6, 2), f(6, 5), f(6, 5), 5.0),
        "u_step_unconstrained": lambda: tlinalg.u_step_unconstrained(
            f(2, 2, 5), f(6, 5), f(6, 5), 5.0),
    }


@pytest.mark.parametrize("name", sorted(_cuda_calls()))
def test_cuda_tensor_without_gpu_raises(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled(name)

    for attr in ("eigh", "eigvalsh", "solve"):
        monkeypatch.setattr(torch.linalg, attr, plain)
    for mod, attr in ((tlinalg, "v_step_plain"), (tlinalg, "u_step_unconstrained_plain"),
                      (tcones, "project_psd_plain")):
        monkeypatch.setattr(mod, attr, plain)
    with pytest.raises((RuntimeError, AssertionError)):
        _cuda_calls()[name]()
