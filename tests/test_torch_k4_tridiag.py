"""The CPU side of K4's float64 tridiagonal path (``csrc/k4_tridiag.cu``).

The kernels run on the GPU only (``chip_smoke.py`` holds every mode on the
card against LAPACK, the plain versions and the other paths).  Here: the
torch mirror of the path's order of work (``omc_torch/ops/tridiag.py``:
Householder reduction, Sturm multisection of every eigenvalue, the side of
zero with fewer vectors, dstein's groups, inverse iteration with
reorthogonalisation inside a group, back-transform, assembly) against
LAPACK and ``omc``'s ``jnp.linalg.eigh`` (x64) from d = 9 to 150, on
generic, clustered and repeated spectra and on the PSD blocks of a late
ADMM iterate of the headline's root; ``k4_plan`` at float64 on every shape
the smoke runs; a float64 CUDA-typed call that raises without a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc_torch.api as tapi
import omc_torch.tree as ttree
from omc_torch.data import generate_matrix_completion_data
from omc_torch.ops import cones, tridiag
from omc_torch.sdp import admm

torch.set_num_threads(2)

F64 = torch.float64
SMEM = 232448  # the most shared memory one CTA may use on an H100


def _spectra(rng, d, kind):
    """(3, d, d) symmetric float64 matrices Q diag(lam) Q' with spectra of
    ``kind``: "generic" (uniform in [-1, 1]; a cluster of up to 6 equal,
    of 6 1e-9-close and of 6 zero eigenvalues; a rank-deficient PSD one),
    "clustered" (max|lambda| = 1, half within 1e-13 of 0, an eighth
    repeated at 0.7 and an eighth at -0.4: the smoke's clustered batch) or
    "repeated" (a rank-k slot's: k eigenvalues at 2, the rest equal at
    -0.5, then one matrix all zeros but one)."""
    Q = np.linalg.qr(rng.standard_normal((3, d, d)))[0]
    lam = rng.uniform(-1.0, 1.0, (3, d))
    if kind == "generic":
        c = max(1, min(d // 4, 6))
        lam[1, :c] = 0.5
        lam[1, c:2 * c] = -0.3 + 1e-9 * np.arange(c)
        lam[1, 2 * c:3 * c] = 0.0
        lam[2] = np.abs(lam[2])
        lam[2, d // 2:] = 0.0
    elif kind == "clustered":
        h, e = d // 2, d // 8
        lam[:, :h] = 1e-13 * rng.uniform(-1.0, 1.0, (3, h))
        lam[:, h:h + e] = 0.7
        lam[:, h + e:h + 2 * e] = -0.4
        lam[:, -1] = 1.0
    else:
        lam[0, :3] = 2.0
        lam[0, 3:] = -0.5
        lam[1, :d // 3] = 1.0
        lam[1, d // 3:] = 0.0
        lam[2] = 0.0
        lam[2, -1] = 3.0
    return np.einsum("bik,bk,bjk->bij", Q, lam, Q)


def _lapack_projection(M):
    w, V = np.linalg.eigh(M)
    return (V * np.clip(w, 0.0, None)[..., None, :]) @ np.swapaxes(V, -1, -2)


def _hold(M, nout=4):
    """The mirror's eigenvalues within 1e-12 max|lambda| of LAPACK's and of
    omc's jnp eigh; its projection within 1e-12 relative (Frobenius) of
    both references' (at least 1e-12 ||M||_F where the projection is 0);
    its nout smallest eigenpairs with a residual and an orthogonality
    within 1e-12 sqrt(d); no iteration cap."""
    d = M.shape[-1]
    Mt = torch.as_tensor(M)
    w_np = np.linalg.eigh(M)[0]
    w_jnp = np.asarray(jnp.linalg.eigh(jnp.asarray(M))[0])
    scale = np.max(np.abs(w_np), axis=-1, keepdims=True)
    w = tridiag.eigvalsh_tridiag(Mt).numpy()
    assert np.all(np.abs(w - w_np) <= 1e-12 * scale)
    assert np.all(np.abs(w - w_jnp) <= 1e-12 * scale)
    P, its = tridiag.project_psd_tridiag(Mt)
    V_j = np.asarray(jnp.linalg.eigh(jnp.asarray(M))[1])
    w_j = np.asarray(jnp.linalg.eigh(jnp.asarray(M))[0])
    for ref in (_lapack_projection(M),
                (V_j * np.clip(w_j, 0.0, None)[..., None, :]) @ np.swapaxes(V_j, -1, -2)):
        den = np.maximum(np.linalg.norm(ref, axis=(-2, -1)), np.linalg.norm(M, axis=(-2, -1)))
        assert np.all(np.linalg.norm(P.numpy() - ref, axis=(-2, -1)) <= 1e-12 * den)
    assert int(its.max()) <= tridiag.MAX_ITERS
    nout = min(nout, d)
    w2, V2, its2 = tridiag.eigh_tridiag(Mt, nout)
    w2, V2 = w2.numpy(), V2.numpy()
    assert np.all(np.abs(w2 - w_np[:, :nout]) <= 1e-12 * scale)
    res = np.einsum("bij,bjk->bik", M, V2) - V2 * w2[:, None, :]
    assert np.all(np.linalg.norm(res, axis=(-2, -1)) <= 1e-12 * np.sqrt(d) * scale[:, 0])
    assert np.all(np.linalg.norm(np.swapaxes(V2, -1, -2) @ V2 - np.eye(nout), axis=(-2, -1))
                  <= 1e-12 * np.sqrt(d))
    assert int(its2.max()) <= tridiag.MAX_ITERS


@pytest.mark.parametrize("d", [9, 24, 33, 64, 101, 150])
def test_tri_mirror_matches_lapack_and_omc(d):
    _hold(_spectra(np.random.default_rng(d), d, "generic"))


@pytest.mark.parametrize("kind", ["clustered", "repeated"])
@pytest.mark.parametrize("d", [16, 64])
def test_tri_mirror_on_clustered_and_repeated_spectra(d, kind):
    """Where inverse iteration loses orthogonality: the groups' solves
    reorthogonalised in order, the near-zero cluster left out of the
    projection (at most d eps ||T||_1 of it)."""
    _hold(_spectra(np.random.default_rng(300 + d), d, kind), nout=d // 2)


def test_tri_mirror_on_a_late_admm_iterate_of_the_headline_root(monkeypatch):
    """The three PSD blocks (orders 100, 51, 50) that the float64 eigh
    route projects in the last of 250 iterations of the headline's root
    (rank 1, 50 x 50, half observed, gamma 80), captured on the CPU."""
    A, idx = generate_matrix_completion_data(1, 50, 50, 1250, 0)
    lo, hi = ttree.root_box(50, 1)
    node = ttree.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0,
                        cuts=[])
    seen = []
    plain = admm.project_psd

    def capture(t):
        seen.append(t.detach().clone())
        return plain(t)

    monkeypatch.setattr(admm, "project_psd", capture)
    tapi.matrix_completion_SDP_relaxation(node, 50, 1, A, idx, 80.0, iters=250, device="cpu")
    blocks = sorted(seen[-3:], key=lambda t: -t.shape[-1])
    assert [t.shape[-1] for t in blocks] == [100, 51, 50]
    for t in blocks:
        M = t.reshape(-1, t.shape[-1], t.shape[-1]).numpy()
        _hold(M, nout=2)


def test_tri_needs_takes_the_smaller_side_and_groups_clusters():
    """Mode 1 keeps the side with fewer eigenvalues beyond d eps ||T||_1
    (ties: the positive side, no A needed); a group runs while each is
    within 1e-3 ||T||_1 of the last; mode 2 the nout smallest."""
    w = torch.tensor([-2.0, -1.0, -1e-17, 0.0, 1e-17, 0.5, 0.5 + 1e-4, 0.7, 3.0], dtype=F64)
    idx, side = tridiag.tri_needs(w, 3.0, 1)
    assert (idx, side) == ([0, 1], -1)
    idx, side = tridiag.tri_needs(-w.flip(0), 3.0, 1)
    assert (idx, side) == ([7, 8], 1)
    assert tridiag.tri_needs(torch.tensor([-1.0, 1.0], dtype=F64), 1.0, 1) == ([1], 1)
    assert tridiag.tri_groups(w, [5, 6, 7, 8], 3.0) == [[5, 6], [7], [8]]
    assert tridiag.tri_needs(w, 3.0, 2, nout=3) == ([0, 1, 2], 0)


def test_tri_mirror_non_finite_input_gives_nan():
    M = torch.as_tensor(_spectra(np.random.default_rng(5), 20, "generic"))
    M[1, 3, 4] = float("nan")
    w = tridiag.eigvalsh_tridiag(M)
    P, its = tridiag.project_psd_tridiag(M)
    assert torch.isnan(w[1]).all() and torch.isfinite(w[0]).all()
    assert torch.isnan(P[1]).all() and torch.isfinite(P[0]).all()
    assert int(its[1]) == tridiag.MAX_ITERS + 1


# the smoke's float64 K4 rows (B, d) and the float64 loops' K4 calls: the
# headline's three blocks (100, 51, 50) at B = 1 and 64, config 3's (150,
# 77, 75) at B = 4 and 64, config 2's (200, 101, 100) at B = 32, the
# McCormick blocks at n + m up to 4,200 (the block path), the Shor bounds'
# XWH slots (d = 9, 17 at 32 x 4096), d = 17 at 1024 and 8192, and d = 9,
# 17, 24 at B = 1, 64
SMOKE_F64 = [(B, d) for B in (1, 4, 32, 64) for d in (50, 51, 75, 77, 100, 101, 150, 200)] + [
    (1, 234), (1, 235), (1, 4200), (4, 31), (131072, 9), (131072, 17), (8192, 17), (1024, 17),
    (1, 9), (64, 9), (1, 17), (64, 17), (64, 24)]


@pytest.mark.parametrize("B,d", SMOKE_F64)
def test_k4_plan_float64_at_every_smoke_shape(B, d):
    """In float64 the tridiagonal path takes every mode of order 32..234
    (its reduction CTA fits; its workspace 5 d + 8 doubles a matrix, with
    vectors two d x d blocks more) and, at batches of at most 64, modes 0
    and 1 from d = 9 and mode 2 from d = 24; elsewhere below, the CTA path;
    above, the CTA path where it fits, else the block path; K5's form never
    takes it."""
    for mode in (0, 1, 2):
        plan = cones.k4_plan(B, d, mode, dtype=F64)
        if 32 <= d <= 234 or (B <= 64 and (24 if mode == 2 else 9) <= d < 32):
            assert plan["path"] == "tri"
            assert plan["smem_bytes"] == 8 * (6 * d + 8 + d * (d + 1) // 2) <= SMEM
            assert plan["workspace_floats"] == B * (5 * d + 8 + (2 * d * d if mode else 0))
        else:
            assert plan["path"] == ("cta" if cones.k4_cta_fits(d, mode, F64) else "block16")
        assert cones.k4_plan(B, d, mode, dtype=F64, sep=True)["path"] != "tri"
        assert cones.k4_plan(B, d, mode) == cones.k4_plan(B, d, mode, dtype=torch.float32)
        assert cones.k4_plan(B, d, mode)["path"] != "tri"
    if d > 234:
        with pytest.raises(ValueError):
            cones.k4_plan(B, d, 1, "tri", F64)
    with pytest.raises(ValueError):  # float32 has no tridiagonal path
        cones.k4_plan(B, min(d, 100), 1, "tri")


@pytest.mark.parametrize("B,d,mode,path", [
    (64, 9, 0, "tri"), (64, 8, 0, "cta"), (1, 9, 1, "tri"), (65, 17, 1, "cta"),
    (64, 31, 1, "tri"), (64, 24, 2, "tri"), (64, 23, 2, "cta"), (1, 17, 2, "cta")])
def test_k4_plan_float64_below_order_32(B, d, mode, path):
    """Below d = 32 the float64 plan's edges: the tridiagonal path at
    batches of at most 64, modes 0 and 1 from d = 9, mode 2 from d = 24;
    else the CTA path."""
    assert cones.k4_plan(B, d, mode, dtype=F64)["path"] == path


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrapper's CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_tri_cuda_tensor_launches_or_raises(monkeypatch):
    """A float64 CUDA-typed batch takes the tridiagonal path and, without a
    GPU, raises: neither LAPACK nor the mirror runs; K5's form is refused
    on that path before any launch."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise AssertionError("a plain version ran")

    for mod, attr in ((torch.linalg, "eigh"), (torch.linalg, "eigvalsh"),
                      (tridiag, "project_psd_tridiag"), (tridiag, "eigvalsh_tridiag")):
        monkeypatch.setattr(mod, attr, plain)
    M = torch.zeros(2, 60, 60, dtype=F64).as_subclass(_FakeCuda)
    for mode in (0, 1, 2):
        with pytest.raises((RuntimeError, AssertionError)) as err:
            cones.k4_jacobi(M, mode)
        assert "plain version" not in str(err.value)
    U = torch.zeros(2, 60, 1, dtype=F64).as_subclass(_FakeCuda)
    with pytest.raises(ValueError):
        cones.k4_jacobi(None, 2, 2, U=U, Y=M, path="tri")
