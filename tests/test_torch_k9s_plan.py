"""K9s on the CPU: the structured row Grams and factorisations of the
kernel's order of work (``omc_torch.sdp.mccormick.mc_setup_structured``)
against ``mc_gram_plain``, ``mc_setup_plain`` and ``omc``'s factorisation,
``k9s_plan``, and the wrapper's packed block and refusals.

K9s (``omc_torch/csrc/k9_mccormick.cu``) runs on the GPU only;
``chip_smoke.py`` holds it against ``mc_setup_plain`` there, with a
determinism check, Mc Mc' against the row Grams and ptxas's spill gate."""

import numpy as np
import pytest
import torch

import omc.sdp.mccormick as J

from omc_torch import convert, kernels
from omc_torch.sdp import mccormick as P

torch.set_num_threads(2)


def _boxes(rng, B, n, k, case):
    """Node boxes inside [-1, 1]: "random" widths 0.05 to 1, "degenerate"
    (lo = hi on a third of the entries, as deep bisection leaves them),
    "root" (the whole [-1, 1] box) and "point" (every entry lo = hi)."""
    if case == "root":
        return -np.ones((B, n, k)), np.ones((B, n, k))
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    if case == "degenerate":
        pick = rng.random((B, n, k)) < 1 / 3
        hi = np.where(pick, lo, hi)
    elif case == "point":
        hi = lo.copy()
    return lo, hi


def _omc_factors(lo, hi, k):
    """omc's rho-free factorisation (omc/sdp/mccormick.py, make_mccormick_solver)
    recomputed in numpy float64 from omc's envelope coefficients."""
    B, n = lo.shape[:2]
    q = k * (k + 1) // 2
    J1, J2 = J.pair_indices(k)
    s, c1, c2, _ = J.mccormick_coeffs(lo, hi, J1, J2, xp=np)
    eye_k = np.eye(k)
    R = np.concatenate([c1[..., None] * eye_k[J1] + c2[..., None] * eye_k[J2],
                        s[..., None] * np.eye(q)], axis=-1)
    R = np.swapaxes(R, 1, 2).reshape(B, n, 4 * q, k + q)
    M = np.einsum("bnrc,bnrd->bncd", R, R) + np.diag(np.r_[4.0 * np.ones(k), np.zeros(q)])
    M = M + 1e-9 * np.eye(k + q)
    Et = np.concatenate([np.zeros((k, q)), np.eye(q)])
    Si = np.linalg.solve(M, np.broadcast_to(Et, (B, n, k + q, q)))
    return M, np.linalg.cholesky(M), Si, np.linalg.cholesky(np.eye(q) + Si[..., k:, :].sum(1))


def _batch(lo, hi, dtype=torch.float64):
    return P.MCBatch(torch.as_tensor(lo, dtype=dtype), torch.as_tensor(hi, dtype=dtype))


@pytest.mark.parametrize("case", ["random", "degenerate", "root", "point"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_structured_factors_match_plain_and_omc(k, case):
    """float64: the structured Gram and the reciprocal-pivot factorisation
    equal mc_gram_plain, mc_setup_plain and omc's factors to 1e-12."""
    rng = np.random.default_rng(20 + k)
    B, n = 3, 11
    lo, hi = _boxes(rng, B, n, k, case)
    M, Mc, Si, Gc = _omc_factors(lo, hi, k)
    got = P.mc_setup_structured(_batch(lo, hi), k)
    plain = P.mc_setup_plain(_batch(lo, hi), k)
    # the structured Gram is Mc Mc'
    L = got[0].numpy()
    assert np.max(np.abs(L @ np.swapaxes(L, -1, -2) - M)) <= 1e-12 * max(1.0, np.abs(M).max())
    assert np.max(np.abs(P.mc_gram_plain(_batch(lo, hi), k).numpy() - M)) <= 1e-12
    for a, b, c in zip(got, plain, (Mc, Si, Gc)):
        assert a.dtype == torch.float64
        assert np.max(np.abs(a.numpy() - b.numpy())) <= 1e-12
        assert np.max(np.abs(a.numpy() - c)) <= 1e-12
    # Mc lower triangular with zeros above, like the kernel writes it
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n,threads", [(50, None), (75, None), (300, None), (40, 32),
                                       (97, 64)])
def test_structured_factors_over_chunks(k, n, threads):
    """Rows taken in chunks of the CTA's threads (one chunk at n = 50 and
    75, two at n = 300 with 256 threads, and forced small CTAs) sum G the
    same to 1e-12."""
    rng = np.random.default_rng(n + k)
    lo, hi = _boxes(rng, 2, n, k, "random")
    got = P.mc_setup_structured(_batch(lo, hi), k, threads)
    plain = P.mc_setup_plain(_batch(lo, hi), k)
    for a, b in zip(got, plain):
        assert np.max(np.abs(a.numpy() - b.numpy())) <= 1e-12


@pytest.mark.parametrize("k", [1, 2, 3])
def test_structured_factors_float32(k):
    """float32 inputs: within the card's bar, 1e-5 relative of the float64
    plain version."""
    rng = np.random.default_rng(40 + k)
    lo, hi = _boxes(rng, 4, 50, k, "degenerate")
    got = P.mc_setup_structured(_batch(lo, hi, torch.float32), k)
    ref = P.mc_setup_plain(_batch(lo, hi), k)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        rel = (a.double() - b).norm() / b.norm()
        assert rel <= 1e-5, rel


@pytest.mark.parametrize("B,n,k,threads,chunks", [
    (64, 50, 1, 128, 1), (64, 75, 2, 128, 1), (64, 50, 3, 128, 1), (1, 1, 1, 128, 1),
    (4, 150, 2, 160, 1), (16, 256, 2, 256, 1), (8, 257, 3, 256, 2), (2, 1000, 1, 256, 4),
])
def test_k9s_plan(B, n, k, threads, chunks):
    """One CTA a slot of n threads rounded up to whole warps, 128 to 256;
    its shared memory stages a chunk's Mc and Si rows (with 4 floats of
    alignment slack each) and each warp's partials of G."""
    plan = P.k9s_plan(B, n, k)
    q = k * (k + 1) // 2
    kq = k + q
    assert plan["threads"] == threads and plan["chunks"] == chunks
    assert plan["smem_bytes"] == 4 * ((4 + threads * kq * kq) + (4 + threads * kq * q)
                                      + threads // 32 * q * (q + 1) // 2)
    assert plan["smem_bytes"] <= 227 * 1024


def test_k9s_plan_refuses():
    """Ranks and shapes no kernel takes raise; k = 4, past the unrolled
    kernel, is planned on the wide kernels."""
    for args in ((4, 50, 0), (4, 50, 4), (0, 50, 1), (4, 0, 2)):
        if args == (4, 50, 4):
            assert P.k9s_plan(*args)["path"] == "wide"
        else:
            with pytest.raises(ValueError):
                P.k9s_plan(*args)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_output_views_share_one_buffer(k):
    """Mc, Si and Gc are views of one buffer, each on a 256-byte boundary."""
    B, n = 3, 7
    q = k * (k + 1) // 2
    buf = P.mc_setup_buffer(B, n, k, "cpu")
    Mc, Si, Gc = P._k9s_views(buf, B, n, k)
    assert Mc.shape == (B, n, k + q, k + q) and Si.shape == (B, n, k + q, q)
    assert Gc.shape == (B, q, q)
    for v in (Mc, Si, Gc):
        assert v.is_contiguous() and v.untyped_storage().data_ptr() == buf.data_ptr()
        assert (v.data_ptr() - buf.data_ptr()) % 256 == 0
    assert Si.data_ptr() >= Mc.data_ptr() + 4 * Mc.numel()
    assert Gc.data_ptr() + 4 * Gc.numel() <= buf.data_ptr() + 4 * buf.numel()


def _pointers(p):
    return [getattr(p, name) for name, ctype in type(p)._fields_
            if ctype is kernels.ctypes.c_void_p]


def test_k9s_block_points_at_the_operands_and_views():
    """K9s's parameter block points at the boxes and at the three views of
    the output buffer, and is packed anew for another buffer or batch (the
    wrapper packs it once a solver call, into a new buffer); a wrong dtype,
    a wrong shape and an unsupported rank are refused."""
    rng = np.random.default_rng(5)
    B, n, k = 2, 6, 2
    lo, hi = _boxes(rng, B, n, k, "random")
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu", dtype=torch.float32)
    cpu = torch.device("cpu")
    buf = P.mc_setup_buffer(B, n, k, cpu)
    views = P._k9s_views(buf, B, n, k)
    p = P._k9s_params(batch, k, views, cpu)
    assert (p.U_lo, p.U_hi) == (batch.U_lo.data_ptr(), batch.U_hi.data_ptr())
    assert (p.Mc, p.Si, p.Gc) == tuple(v.data_ptr() for v in views)
    assert sorted(_pointers(p)) == sorted([batch.U_lo.data_ptr(), batch.U_hi.data_ptr()]
                                          + [v.data_ptr() for v in views])
    assert (p.B, p.n, p.k) == (B, n, k)
    buf2 = P.mc_setup_buffer(B, n, k, cpu)
    q = P._k9s_params(batch, k, P._k9s_views(buf2, B, n, k), cpu)
    assert q is not p and q.Mc == buf2.data_ptr() and q.U_lo == p.U_lo
    b2 = P.MCBatch(batch.U_lo.clone(), batch.U_hi)
    assert P._k9s_params(b2, k, views, cpu).U_lo == b2.U_lo.data_ptr() != p.U_lo
    with pytest.raises(TypeError):
        P._k9s_params(P.MCBatch(batch.U_lo.double(), batch.U_hi), k, views, cpu)
    with pytest.raises(ValueError, match="shape"):
        P._k9s_params(batch, k, (views[0], views[1][:, :-1], views[2]), cpu)
    with pytest.raises(ValueError, match="not contiguous"):
        P._k9s_params(batch, k, (views[0].transpose(-1, -2), views[1], views[2]), cpu)
    # k = 0 is refused; k = 4 is planned (the wide kernels) and the rank-k
    # operands it then checks refused
    with pytest.raises(ValueError, match="k >= 1"):
        P._k9s_params(batch, 0, views, cpu)
    with pytest.raises(ValueError, match="shape"):
        P._k9s_params(batch, 4, views, cpu)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrapper's CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


def test_cuda_batch_takes_no_plain_version(monkeypatch):
    """On a CUDA-typed batch K9s's wrapper launches its kernel or raises: no
    plain version runs (here, without a GPU, it raises)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise _PlainCalled

    monkeypatch.setattr(P, "mc_setup_plain", plain)
    rng = np.random.default_rng(6)
    lo, hi = _boxes(rng, 2, 6, 1, "random")
    batch = P.MCBatch(*(torch.as_tensor(x, dtype=torch.float32).as_subclass(_FakeCuda)
                        for x in (lo, hi)))
    # allocating on a CUDA device raises without one (an AssertionError from a
    # CPU-only torch build)
    with pytest.raises((RuntimeError, AssertionError)):
        P.mc_setup(batch, 1)
    # the launch of a parameter block, without a GPU, raises too
    buf = P.mc_setup_buffer(2, 6, 1, "cpu").as_subclass(_FakeCuda)
    with pytest.raises(RuntimeError):
        kernels.launch("K9s", "omc_k9s_setup",
                       P._k9s_params(batch, 1, P._k9s_views(buf, 2, 6, 1), buf.device),
                       buf.device)
