"""K5's and K4s's CPU side.

K5 (``omc_torch/csrc/k5_separation.cu``): its torch mirror
``omc_torch.ops.tridiag`` (the Householder reduction, the 32-shift
multisection, inverse iteration with its start vector, cap and
reorthogonalisation rule, the back-transform) against LAPACK in float64
and ``omc``'s ``jnp.linalg.eigh`` sliced to two, at orders 1 to 100, with
the triangle in float64 and in float32; on repeated and near-repeated
smallest pairs, on matrices whose tridiagonal splits (zero, diagonal, Y =
U U') and on non-finite input; ``k5_plan`` at every shape the smoke's rows
and the driving phases use.  K4s (``csrc/k4s_jacobi_small.cu``): its
mirror ``ops.jacobi.k4s_eigh`` (the cyclic-by-row schedule with K4s's
rotation) against LAPACK per matrix at D = 1..8, its skip test against
K4's, its staging (every float of every matrix loaded once, N ragged,
aligned or not) and ``k4s_plan``.  A CUDA-typed tensor without a GPU
raises on every path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc_torch.ops import cones as tcones
from omc_torch.ops import jacobi, tridiag
from omc_torch.sdp import relax as trelax

torch.set_num_threads(2)


def _smoke_inputs(rng, B, d, k, lam01=(-1.0, -0.6)):
    """U (B, d, k) and symmetric Y with U U' - Y = Q diag(lam) Q', lam
    uniform in [-0.3, 1] but for the two smallest (the smoke's K5 rows)."""
    U = rng.standard_normal((B, d, k))
    Q = np.linalg.qr(rng.standard_normal((B, d, d)))[0]
    lam = rng.uniform(-0.3, 1.0, (B, d))
    lam[:, 0] = lam01[0]
    if d > 1:
        lam[:, 1] = lam01[1]
    Y = U @ np.swapaxes(U, -1, -2) - np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    return U, 0.5 * (Y + np.swapaxes(Y, -1, -2))


def _reference(U, Y):
    M = U.astype(np.float64) @ np.swapaxes(U.astype(np.float64), -1, -2) - Y.astype(np.float64)
    return np.linalg.eigh(0.5 * (M + np.swapaxes(M, -1, -2))), M


def _aligned(V, R):
    return V * np.sign(np.sum(V * R, axis=-2, keepdims=True))


ORDERS = [1, 2, 3, 6, 9, 12, 50, 75, 100]


@pytest.mark.parametrize("d", ORDERS)
def test_k5_mirror_float64_matches_lapack_and_omc(d):
    rng = np.random.default_rng(d)
    U, Y = _smoke_inputs(rng, 3, d, 2)
    nout = min(2, d)
    w, V, iters = tridiag.separation_tridiag(torch.as_tensor(U), torch.as_tensor(Y), nout)
    w, V = w.numpy(), V.numpy()
    (w64, V64), M = _reference(U, Y)
    Mj = jnp.einsum("bik,bjk->bij", jnp.asarray(U), jnp.asarray(U)) - jnp.asarray(Y)
    wj = np.asarray(jnp.linalg.eigh(0.5 * (Mj + jnp.swapaxes(Mj, -1, -2)))[0])[:, :nout]
    scale = np.abs(w64).max(-1, keepdims=True)
    assert w.shape == (3, nout) and V.shape == (3, d, nout)
    assert np.all(np.abs(w - w64[:, :nout]) <= 1e-12 * scale)
    assert np.all(np.abs(w - wj) <= 1e-12 * scale)
    assert np.all(np.linalg.norm(_aligned(V, V64[..., :nout]) - V64[..., :nout], axis=-2) <= 1e-12)
    assert np.all(np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(nout)) <= 1e-13)
    assert int(iters.max()) <= tridiag.MAX_ITERS


@pytest.mark.parametrize("storage", ["float64", "float32"])
@pytest.mark.parametrize("d", ORDERS)
def test_k5_mirror_float32_input_meets_the_smoke_bars(d, storage):
    """Float32 U and Y (the kernel's inputs), the triangle in either
    storage: eigenvalues within 1e-5 max|lambda| and sign-aligned vectors
    within 1e-5 of a float64 eigh of the same float32 input."""
    rng = np.random.default_rng(100 + d)
    U, Y = _smoke_inputs(rng, 4, d, 1)
    U32, Y32 = U.astype(np.float32), Y.astype(np.float32)
    nout = min(2, d)
    w, V, _ = tridiag.separation_tridiag(torch.as_tensor(U32), torch.as_tensor(Y32), nout,
                                         getattr(torch, storage))
    assert w.dtype == torch.float32 and V.dtype == torch.float32
    w, V = w.double().numpy(), V.double().numpy()
    (w64, V64), _ = _reference(U32, Y32)
    assert np.all(np.abs(w - w64[:, :nout]).max(-1) / np.abs(w64).max(-1) <= 1e-5)
    assert np.all(np.linalg.norm(_aligned(V, V64[..., :nout]) - V64[..., :nout], axis=-2) <= 1e-5)


def _pair_checks(U, Y, w, V, tol):
    """Residual ||A v - lambda v||, V'V = I and, where the third eigenvalue
    stands apart, the pair's subspace against LAPACK's (the vectors of a
    (near-)repeated pair are not unique, nor is the pair's subspace when the
    third eigenvalue joins it)."""
    (w64, V64), M = _reference(U, Y)
    A = 0.5 * (M + np.swapaxes(M, -1, -2))
    nrm = np.linalg.norm(A, axis=(-2, -1))
    resid = np.linalg.norm(A @ V - V * w[:, None, :], axis=-2).max(-1)
    assert np.all(resid <= tol * np.maximum(nrm, 1.0))
    assert np.all(np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(2)) <= tol)
    P = V @ np.swapaxes(V, -1, -2)
    P64 = V64[..., :2] @ np.swapaxes(V64[..., :2], -1, -2)
    apart = w64[:, 2] - w64[:, 1] > 1e-3 * np.maximum(nrm, 1.0)
    assert np.all(np.linalg.norm(P - P64, axis=(-2, -1))[apart] <= 1e3 * tol)
    assert np.all(np.abs(w - w64[:, :2]) <= tol * np.maximum(nrm, 1.0)[:, None])


@pytest.mark.parametrize("gap", [0.0, 1e-9, 1e-5])
@pytest.mark.parametrize("d", [6, 50])
def test_k5_mirror_repeated_and_near_repeated_pairs(d, gap):
    rng = np.random.default_rng(7 + d)
    U, Y = _smoke_inputs(rng, 3, d, 1, lam01=(-1.0, -1.0 + gap))
    w, V, iters = tridiag.separation_tridiag(torch.as_tensor(U), torch.as_tensor(Y))
    _pair_checks(U, Y, w.numpy(), V.numpy(), 1e-12)
    assert int(iters.max()) <= tridiag.MAX_ITERS


@pytest.mark.parametrize("case", ["zero", "diagonal", "diagonal_repeated", "Y=UU'"])
@pytest.mark.parametrize("d", [3, 12, 50])
def test_k5_mirror_split_tridiagonals(d, case):
    """Matrices whose tridiagonal has zero off-diagonals: the zero matrix,
    a diagonal matrix (its smallest entry once, or twice), and Y = U U'
    (the zero matrix again, through U)."""
    rng = np.random.default_rng(d)
    B = 3
    U = np.zeros((B, d, 1))
    if case == "zero":
        Y = np.zeros((B, d, d))
    elif case == "Y=UU'":
        U = rng.standard_normal((B, d, 1))
        Y = U @ np.swapaxes(U, -1, -2)
    else:
        diag = rng.uniform(-1.0, 1.0, (B, d))
        if case == "diagonal_repeated":
            diag[:, d - 1] = diag[:, 0] = diag.min(-1) - 0.1
        Y = -np.einsum("bi,ij->bij", diag, np.eye(d))
    w, V, iters = tridiag.separation_tridiag(torch.as_tensor(U), torch.as_tensor(Y))
    w, V = w.numpy(), V.numpy()
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(V))
    _pair_checks(U, Y, w, V, 1e-12)
    assert int(iters.max()) <= tridiag.MAX_ITERS


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_k5_mirror_nonfinite_input_gives_nan(bad):
    rng = np.random.default_rng(3)
    U, Y = _smoke_inputs(rng, 2, 9, 1)
    Y[0, 1, 2] = bad
    w, V, iters = tridiag.separation_tridiag(torch.as_tensor(U), torch.as_tensor(Y))
    assert torch.isnan(w[0]).all() and torch.isnan(V[0]).all()
    assert torch.isfinite(w[1]).all() and torch.isfinite(V[1]).all()
    assert int(iters[0]) == tridiag.MAX_ITERS + 1 and int(iters[1]) <= tridiag.MAX_ITERS


def test_k5_start_vector_is_deterministic_and_spread():
    a, b = tridiag.start_vector(100, 0), tridiag.start_vector(100, 1)
    assert torch.equal(a, tridiag.start_vector(100, 0))
    assert bool((a.abs() < 1).all()) and bool((a != 0).all())
    # the two eigenvectors' starts are far from parallel
    assert float(torch.dot(a, b).abs() / (a.norm() * b.norm())) < 0.5


# ---- k5_plan ----

# (B, d, path) at every K5 row of the smoke and every driving phase's shape
K5_SHAPES = [(64, 50, "tridiag64"), (64, 75, "tridiag64"), (1, 50, "tridiag64"),
             (4, 50, "tridiag64"), (32, 75, "tridiag64"), (32, 100, "tridiag64"),
             (128, 250, "tridiag32")]


@pytest.mark.parametrize("B,d,path", K5_SHAPES)
def test_k5_plan_paths(B, d, path):
    plan = trelax.k5_plan(B, d)
    assert plan["path"] == path
    assert plan["smem_bytes"] == trelax.k5_smem_bytes(d, path) > 0
    assert plan["threads"] == trelax.K5_THREADS >= d


def test_k5_plan_limits_and_forced_paths():
    # the float64 triangle fits to d = 224, the float32 one to d = 309
    assert trelax.k5_smem_bytes(224, "tridiag64") and not trelax.k5_smem_bytes(225, "tridiag64")
    assert trelax.k5_smem_bytes(309, "tridiag32") and not trelax.k5_smem_bytes(310, "tridiag32")
    assert trelax.k5_plan(4, 400)["path"] == tcones.k4_plan(4, 400, 2)["path"]
    for path in trelax.K5_PATHS:
        assert trelax.k5_plan(64, 50, path)["path"] == path
    with pytest.raises(ValueError):
        trelax.k5_plan(4, 300, "tridiag64")
    with pytest.raises(ValueError):
        trelax.k5_plan(4, 310, "tridiag32")
    with pytest.raises(ValueError):
        trelax.k5_plan(4, 50, "tiles")


# ---- K4s ----


def _small_batch(rng, D, nb=40):
    """Symmetric (nb, D, D): generic, repeated eigenvalues, rank-1 PSD,
    rank-deficient PSD, zero."""
    Q = np.linalg.qr(rng.standard_normal((nb, D, D)))[0]
    lam = rng.uniform(-1.0, 1.0, (nb, D))
    lam[1::5, : (D + 1) // 2] = 0.5
    lam[2::5] = 0.0
    lam[2::5, 0] = 2.0
    lam[3::5] = np.abs(lam[3::5])
    lam[3::5, D // 2:] = 0.0
    lam[4::5] = 0.0
    return np.einsum("bik,bk,bjk->bij", Q, lam, Q)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("D", list(range(1, 9)))
def test_k4s_mirror_matches_lapack(D, dtype):
    M = _small_batch(np.random.default_rng(D), D).astype(dtype)
    P, sweeps = jacobi.k4s_project_psd(torch.as_tensor(M))
    M64 = M.astype(np.float64)
    w, V = np.linalg.eigh(M64)
    P64 = np.einsum("bik,bk,bjk->bij", V, np.maximum(w, 0.0), V)
    nrm = np.maximum(np.linalg.norm(M64, axis=(-2, -1)), 1e-300)
    per = np.linalg.norm(P.double().numpy() - P64, axis=(-2, -1)) / nrm
    assert np.all(per <= (1e-5 if dtype == "float32" else 1e-12))
    assert int(sweeps.max()) <= jacobi.MAX_SWEEPS


def test_k4s_mirror_nonfinite_runs_to_the_cap():
    M = _small_batch(np.random.default_rng(0), 5, nb=3)
    M[0, 1, 2], M[1, 0, 0] = np.nan, np.inf
    P, sweeps = jacobi.k4s_project_psd(torch.as_tensor(M))
    assert torch.isnan(P[:2]).all() and torch.isfinite(P[2]).all()
    assert sweeps[:2].tolist() == [jacobi.MAX_SWEEPS + 1] * 2


def test_k4s_skip_test_matches_k4s_up_to_rounding():
    """|a_pq|^2 <= max(eps^2 |a_pp a_qq|, floor^2) skips exactly the pairs
    that K4's |a_pq| <= max(eps sqrt|a_pp| sqrt|a_qq|, floor) skips, away
    from the boundary's rounding; a NaN rotates."""
    rng = np.random.default_rng(1)
    n = 20000
    app, aqq = (torch.as_tensor(rng.uniform(-2, 2, n)).float() for _ in range(2))
    eps = torch.finfo(torch.float32).eps
    rel = eps * torch.sqrt(app.abs()) * torch.sqrt(aqq.abs())
    floor = torch.full_like(app, 1e-6)
    thr = torch.maximum(rel, floor)
    apq = thr * torch.as_tensor(rng.uniform(0.5, 1.5, n)).float()
    rot, t, s, r = jacobi.k4s_rotation(app, aqq, apq, floor * floor)
    margin = (apq / thr - 1).abs() > 1e-5
    assert torch.equal(rot[margin], ~(apq.abs() <= thr)[margin])
    nan = torch.tensor([float("nan")])
    assert bool(jacobi.k4s_rotation(nan, nan, nan, torch.tensor([1.0]))[0])
    assert bool(jacobi.k4s_rotation(app[:1], aqq[:1], apq[:1], nan)[0])


def test_k4s_rotation_matches_k4s_parameters():
    """t, s and r of the one-reciprocal form against K4's tau / hypot form
    (``jacobi_eigh``'s), in float64."""
    rng = np.random.default_rng(2)
    app, aqq, apq = (torch.as_tensor(rng.standard_normal(5000)) for _ in range(3))
    rot, t, s, r = jacobi.k4s_rotation(app, aqq, apq, torch.zeros(5000, dtype=torch.float64))
    assert bool(rot.all())
    tau = (aqq - app) / (2.0 * apq)
    t0 = torch.copysign(torch.ones_like(tau), tau) / (tau.abs() + torch.hypot(torch.ones_like(tau),
                                                                              tau))
    c0 = 1.0 / torch.sqrt(1.0 + t0 * t0)
    for a, b in ((t, t0), (s, t0 * c0), (r, t0 * c0 / (1.0 + c0))):
        assert torch.allclose(a, b, rtol=1e-13, atol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", list(range(1, 9)))
@pytest.mark.parametrize("N", [1, 127, 129, 300, 1000])
def test_k4s_staging_owns_every_float_once(N, D, aligned):
    plan = tcones.k4s_plan(N, D)
    cta, flat, slot = jacobi.k4s_staging(N, D, aligned, plan["threads"])
    DD, LD = D * D, plan["stride"]
    assert LD % 2 == 1 and LD >= DD
    assert torch.equal(torch.sort(flat).values, torch.arange(N * DD))
    assert int(cta.max()) + 1 == plan["ctas"] == -(-N // 128)
    local = flat - cta * plan["threads"] * DD
    assert torch.equal(slot // LD, local // DD) and torch.equal(slot % LD, local % DD)
    assert int(slot.max()) < plan["smem_bytes"] // 4
    # within a CTA no two loads share a slot
    key = cta * plan["threads"] * LD + slot
    assert torch.unique(key).numel() == key.numel()


# ---- a CUDA-typed tensor without a GPU raises, on every path ----


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


@pytest.mark.parametrize("d", [6, 50, 250, 400])
@pytest.mark.parametrize("path", [None, *trelax.K5_PATHS])
def test_k5_cuda_tensor_takes_a_path_or_raises(path, d, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise _PlainCalled

    for mod, attr in ((torch.linalg, "eigh"), (trelax, "separation_eigpairs_plain"),
                      (tridiag, "separation_tridiag"), (jacobi, "jacobi_eigh"),
                      (jacobi, "jacobi_eigh_blocked")):
        monkeypatch.setattr(mod, attr, plain)
    f = lambda *s: torch.zeros(*s).as_subclass(_FakeCuda)  # noqa: E731
    U, Y = f(2, d, 1), f(2, d, d)
    if path is None:
        with pytest.raises((RuntimeError, AssertionError)):
            trelax.separation_eigpairs(U, Y)
        return
    try:
        plan = trelax.k5_plan(2, d, path)
    except ValueError:  # refused only where the forced path does not fit
        assert path in tcones.K4_PATHS or not trelax.k5_smem_bytes(d, path)
        return
    with pytest.raises((RuntimeError, AssertionError)):
        trelax._k5_launch(U, Y, plan)


def test_k4s_cuda_tensor_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise _PlainCalled

    for mod, attr in ((torch.linalg, "eigh"), (tcones, "project_psd_plain"),
                      (jacobi, "k4s_project_psd")):
        monkeypatch.setattr(mod, attr, plain)
    M = torch.zeros(300, 5, 5).as_subclass(_FakeCuda)
    with pytest.raises((RuntimeError, AssertionError)):
        tcones.k4s_project_psd(M)
    with pytest.raises(ValueError):
        tcones.k4s_project_psd(torch.zeros(3, 9, 9).as_subclass(_FakeCuda))
