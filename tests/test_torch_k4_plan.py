"""K4's block path on the CPU: its torch mirror
``omc_torch.ops.jacobi.jacobi_eigh_blocked`` (the block schedule of
``omc_torch/csrc/k4_jacobi.cu``'s ``k4_block_kernel``: one inner sweep of
the scalar schedule per block pair and round, the tile updates in 3xTF32
products for float32, the skip rule and the epilogues) against LAPACK in
float64 and float32 and against ``omc``'s ``jnp.linalg.eigh``, at ragged
orders and odd block counts, on degenerate and rank-deficient spectra and
on a non-finite input; and ``k4_plan``, which picks K4's path for every
shape the smoke's rows and BASELINE config 4's bound use."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc_torch.ops import cones as tcones
from omc_torch.ops import jacobi

torch.set_num_threads(2)


def _spectra(rng, d, nb=4):
    """Symmetric (nb, d, d) matrices Q diag(lam) Q': a generic spectrum, a
    degenerate one (clusters of equal and of 1e-9-close eigenvalues, a
    negative cluster, repeated zeros), a rank-1 PSD one and a rank-deficient
    PSD one (the recipe of chip_smoke.py's _eig_batch, at a CPU size)."""
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


# (d, width): one ragged block with a bye (13), an odd block count with a
# ragged last block (40 at 16; 96 at 32: three full blocks), an even count
# with a ragged last block (50), full blocks (96 at 16)
SHAPES = [(13, 16), (40, 16), (50, 16), (96, 16), (50, 32), (96, 32)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,width", SHAPES)
def test_blocked_mirror_matches_lapack_and_omc(d, width, dtype):
    M = _spectra(np.random.default_rng(d + width), d).astype(dtype)
    w, V, sweeps = jacobi.jacobi_eigh_blocked(torch.as_tensor(M), width)
    M64 = M.astype(np.float64)
    w_np = np.linalg.eigh(M64)[0]
    w_jnp = np.asarray(jnp.linalg.eigh(jnp.asarray(M64))[0])
    scale = np.max(np.abs(w_np), axis=-1, keepdims=True)
    # float64: eigenvalues to 1e-12 max|lambda|; float32: the smoke's bars
    tol = 1e-12 if dtype == "float64" else 1e-5
    w = w.double().numpy()
    V = V.double().numpy()
    assert np.all(np.abs(w - w_np) <= tol * scale)
    assert np.all(np.abs(w - w_jnp) <= tol * scale)
    res = np.einsum("bij,bjk->bik", M64, V) - V * w[:, None, :]
    assert np.all(np.linalg.norm(res, axis=(-2, -1)) <= tol * np.sqrt(d) * scale[:, 0])
    eye = np.eye(d)
    assert np.all(np.linalg.norm(np.swapaxes(V, -1, -2) @ V - eye, axis=(-2, -1))
                  <= tol * np.sqrt(d))
    assert np.all(sweeps.numpy() <= jacobi.MAX_SWEEPS)
    P, psw = jacobi.jacobi_project_psd_blocked(torch.as_tensor(M), width)
    P = P.double().numpy()
    P_np = _psd_np(M64)
    rel = np.linalg.norm(P - P_np, axis=(-2, -1)) / np.maximum(
        np.linalg.norm(P_np, axis=(-2, -1)), 1e-30)
    assert np.all(rel <= tol)
    # the epilogue writes the upper triangle and its mirror
    assert np.array_equal(P, np.swapaxes(P, -1, -2))
    assert torch.equal(psw, sweeps)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_blocked_mirror_non_finite_input_ends_at_the_cap(bad):
    M = _spectra(np.random.default_rng(1), 40).astype(np.float32)
    M[0, 3, 4] = bad
    w, V, sweeps = jacobi.jacobi_eigh_blocked(torch.as_tensor(M), 16, max_sweeps=12)
    assert sweeps[0].item() == 13  # the cap plus one: it never converged
    assert torch.isnan(w[0]).all() and torch.isnan(V[0]).all()
    assert torch.all(sweeps[1:] <= 12) and torch.isfinite(w[1:]).all()


def test_blocked_mirror_skips_a_diagonal_matrix():
    """No entry fails the stopping test, so no pair rotates: one sweep, the
    diagonal sorted, V the permutation that sorts it."""
    diag = torch.tensor([3.0, -1.0, 2.0, 0.5] * 10, dtype=torch.float64)
    w, V, sweeps = jacobi.jacobi_eigh_blocked(torch.diag(diag)[None], 16)
    assert sweeps.tolist() == [1]
    assert torch.equal(w[0], torch.sort(diag, stable=True).values)
    assert torch.equal(V[0].abs().sum(0), torch.ones(40, dtype=torch.float64))


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 16, 32])
def test_block_tournament_meets_every_block_pair_once_per_sweep(nb):
    rounds = jacobi.block_tournament(nb)
    real = [(I, J) for pairs in rounds for I, J in pairs if J < nb]
    assert sorted(real) == [(I, J) for I in range(nb) for J in range(I + 1, nb)]
    for pairs in rounds:  # every block once a round, the bye at most once
        blocks = [x for pair in pairs for x in pair]
        assert sorted(blocks) == list(range(nb + (nb & 1)))


# every (B, d, mode) that chip_smoke.py's K4/K5 rows, the headline's B=1
# and B=4 visits, configs 2-3 and BASELINE config 4's safe bound (S1 at d =
# n + m, S2 at n + k, R1, G_Y and G_Theta at 250, the separation at 250)
# run, and the path k4_plan picks there
PLAN_SHAPES = [
    ((64, 100, 1), "cta"), ((64, 100, 0), "cta"), ((64, 100, 2), "cta"),
    ((64, 50, 1), "cta"), ((64, 51, 1), "cta"), ((64, 150, 1), "block16"),
    ((64, 150, 0), "cta"), ((64, 77, 1), "cta"), ((64, 75, 0), "cta"),
    ((32, 200, 1), "block16"), ((32, 200, 0), "block16"), ((32, 200, 2), "block16"),
    ((32, 150, 1), "block16"), ((2, 500, 1), "block16"), ((2, 500, 0), "block16"),
    ((2, 500, 2), "block16"), ((128, 500, 1), "block16"), ((128, 255, 1), "block16"),
    ((128, 250, 0), "block16"), ((1, 1000, 1), "block16"), ((1, 1000, 0), "block16"),
    ((1, 100, 1), "block16"), ((1, 51, 1), "block16"), ((1, 50, 0), "cta"),
    ((4, 100, 1), "block16"), ((64, 50, 2), "cta"), ((64, 75, 2), "cta"),
    ((1, 50, 2), "block16"), ((128, 250, 2), "block16"),
]


@pytest.mark.parametrize("shape,path", PLAN_SHAPES, ids=[str(s) for s, _ in PLAN_SHAPES])
def test_k4_plan_path_shapes(shape, path):
    B, d, mode = shape
    plan = tcones.k4_plan(B, d, mode)
    assert plan["path"] == path
    if path == "cta":
        # the CTA path keeps A (and V) in shared memory: no workspace
        assert plan["workspace_floats"] == 0 and plan["rounds"] == 0
        assert tcones.k4_cta_fits(d, mode)
    else:
        geo = tcones.k4_block_geometry(d, mode)
        assert geo["D"] >= d and geo["D"] % (2 * tcones.K4_WIDTH) == 0
        assert plan["rounds"] == geo["rounds"] == 2 * geo["pairs"] - 1
        assert plan["workspace_floats"] == tcones.K4_CTL + B * geo["mat_floats"]


# the largest orders whose A (and V) fit one CTA's 227 KiB of shared memory
# (with its head of per-pair and per-index scratch): 237 for eigenvalues,
# 168 with vectors
CTA_LIMITS = [(237, 0, True), (238, 0, False), (168, 1, True), (169, 1, False),
              (168, 2, True), (169, 2, False)]


@pytest.mark.parametrize("d,mode,fits", CTA_LIMITS)
def test_k4_cta_path_takes_only_what_fits_shared_memory(d, mode, fits):
    assert tcones.k4_cta_fits(d, mode) == fits
    if fits:
        assert tcones.k4_plan(1, d, mode, "cta")["path"] == "cta"
    else:
        with pytest.raises(ValueError):
            tcones.k4_plan(1, d, mode, "cta")
    # the planner never picks a CTA path that does not fit
    assert tcones.k4_plan(1024, d, mode)["path"] == ("cta" if fits and (
        d <= (tcones.K4_CTA_EIGVALS_D if mode == 0 else tcones.K4_CTA_VECTORS_D)) else "block16")


def test_k4_plan_forced_paths():
    for path in tcones.K4_PATHS:
        assert tcones.k4_plan(64, 100, 1, path)["path"] == path
    for bad in ("block8", "block32", "tiles"):
        with pytest.raises(ValueError):
            tcones.k4_plan(64, 100, 1, bad)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrapper's CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


@pytest.mark.parametrize("path", [None, *tcones.K4_PATHS])
@pytest.mark.parametrize("d", [40, 300])
def test_k4_cuda_tensor_takes_a_path_or_raises(path, d, monkeypatch):
    """On a CUDA tensor K4 launches its planned or forced path or raises:
    neither LAPACK nor the mirror runs (here, without a GPU, it raises; at
    d = 300 the forced CTA path raises before any launch)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise _PlainCalled

    for mod, attr in ((torch.linalg, "eigh"), (torch.linalg, "eigvalsh"),
                      (jacobi, "jacobi_eigh"), (jacobi, "jacobi_eigh_blocked")):
        monkeypatch.setattr(mod, attr, plain)
    M = torch.zeros(2, d, d).as_subclass(_FakeCuda)
    # a CPU-only torch refuses the CUDA outputs with an AssertionError
    raises = ValueError if (path == "cta" and d == 300) else (RuntimeError, AssertionError)
    with pytest.raises(raises):
        tcones.k4_jacobi(M, 1, path=path)


def test_k4_bad_path_raises_before_any_launch():
    M = torch.zeros(2, 40, 40).as_subclass(_FakeCuda)
    for bad in ("tiles", "block32"):
        with pytest.raises(ValueError):
            tcones.k4_jacobi(M, 1, path=bad)
    M = torch.zeros(2, 200, 200).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="shared memory"):
        tcones.k4_jacobi(M, 1, path="cta")
