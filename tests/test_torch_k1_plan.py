"""K1's arithmetic and plan on the CPU: the 3xTF32 symmetric products of the
sign schedule (the CPU mirror ``symmetric_matmul(tf32x3_matmul)`` of what
``omc_torch/csrc/k1_psd_sign.cu`` computes on the tensor cores) against a
float64 eigh projection and against omc's float32 ``project_psd_ns``, its
controls, and ``k1_plan``, which picks K1's path, cluster size and scratch
for every shape the solver's paths use."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.ops import polar as jpolar

from omc_torch.ops import polar as tpolar

torch.set_num_threads(2)

K1 = tpolar.symmetric_matmul(tpolar.tf32x3_matmul)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _spectral(rng, B, d):
    """Symmetric (B, d, d) batches with eigenvalues +-[0.1, 1], the spectra
    of chip_smoke.py's K1 rows."""
    Q = np.linalg.qr(rng.standard_normal((B, d, d)))[0]
    lam = rng.uniform(0.1, 1.0, (B, d)) * rng.choice([-1.0, 1.0], (B, d))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    return 0.5 * (T + np.swapaxes(T, -1, -2))


def _exact(T):
    lam, V = np.linalg.eigh(T)
    return np.einsum("bik,bk,bjk->bij", V, np.maximum(lam, 0.0), V)


def _one_pass_tf32(a, b):
    return torch.matmul(tpolar._tf32_rna(a), tpolar._tf32_rna(b))


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -20,
                      1.0 + 0.75 * ulp, 3.0], dtype=torch.float32)
    got = tpolar._tf32_rna(x).tolist()
    assert got == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 3.0]


def test_tf32x3_split_recovers_float32():
    """big + small carries x to within 2^-22 relative: the 3xTF32 product
    is float32-grade, the one-pass TF32 product is not."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = tpolar._tf32_rna(x)
    small = tpolar._tf32_rna(x - big)
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0 ** -22
    assert float(((big - x).abs() / x.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("d", [50, 100, 200])
def test_tf32x3_chain_meets_the_k1_bar(d):
    """The chain through K1's products stays within 1e-4 of the exact
    projection and of omc's float32 sign schedule, as chip_smoke.py holds
    the kernel on the card; the one-pass TF32 product misses the bar."""
    rng = np.random.default_rng(d)
    T = _spectral(rng, 4 if d < 200 else 2, d)
    exact = _exact(T)
    t32 = torch.as_tensor(T.astype(np.float32))
    got = tpolar.project_psd_ns(t32, matmul=K1).numpy()
    ref = np.asarray(jpolar.project_psd_ns(jnp.asarray(T.astype(np.float32))))
    assert _rel(got, exact) <= 1e-4
    assert _rel(got, ref) <= 1e-4
    # every product is exactly symmetric, so the projection is too
    assert np.array_equal(got, np.swapaxes(got, -1, -2))
    one_pass = tpolar.project_psd_ns(t32, matmul=tpolar.symmetric_matmul(_one_pass_tf32))
    assert not _rel(one_pass.numpy(), exact) <= 1e-4  # NaN fails too


def test_products_without_the_mirror_diverge():
    """Forming C = A B^T without mirroring the upper triangle lets the
    rounding's skew part grow by the steps' slope: the chain leaves the
    1e-4 bar by orders of magnitude.  K1 mirrors every product."""
    rng = np.random.default_rng(5)
    T = torch.as_tensor(_spectral(rng, 4, 100).astype(np.float32))
    exact = _exact(T.double().numpy())
    skew = tpolar.project_psd_ns(T, matmul=lambda a, b: torch.matmul(a, b.transpose(-1, -2)))
    assert _rel(skew.numpy(), exact) > 1e-2
    mirrored = tpolar.project_psd_ns(T, matmul=tpolar.symmetric_matmul())
    assert _rel(mirrored.numpy(), exact) <= 1e-4


# (B, dims) of the solver's paths: the headline root visit (B=1), its
# refinement portfolio (B=4), a base-path batch (B=64), BASELINE config 3
# (75x75, k=2) and its rank-k Shor batch (B=32), config 2 (100x100, k=1),
# the smoke's d=200 and d=500 rows and config 5's d=2000
PATH_SHAPES = [
    ((1, (100, 51, 50)), "cluster", 8),
    ((4, (100, 51, 50)), "cluster", 8),
    ((64, (100, 51, 50)), "cluster", 2),
    ((64, (150, 77, 75)), "cluster", 2),
    ((32, (150, 77, 75)), "cluster", 2),
    ((32, (200, 101, 100)), "tiles", 0),
    ((64, (200,)), "tiles", 0),
    ((8, (200, 101, 100)), "cluster", 8),
    ((16, (500,)), "tiles", 0),
    ((64, (500, 251, 250)), "tiles", 0),
    ((2, (2000,)), "tiles", 0),
    ((2, (2000, 1001, 1000)), "tiles", 0),
]


@pytest.mark.parametrize("shape,path,cluster", PATH_SHAPES,
                         ids=[f"B{b}-{'-'.join(map(str, d))}" for (b, d), _, _ in PATH_SHAPES])
def test_k1_plan_path_shapes(shape, path, cluster):
    B, dims = shape
    plan = tpolar.k1_plan(dims, B)
    assert plan["path"] == path and plan["cluster"] == cluster
    if path == "cluster":
        assert plan["smem"] == tpolar.k1_cluster_smem(dims, cluster) <= tpolar.K1_SMEM_MAX
        assert plan["scratch_floats"] == [0] * len(dims)
        # two CTAs per SM, unless the cluster is already the largest or is
        # capped at 2 for a large batch; clusters larger than 2 only for
        # small batches
        big = B * len(dims) >= tpolar.K1_CLUSTER_MATRICES
        assert B * len(dims) * cluster >= 2 * tpolar.H100_SMS or cluster == 8 or (
            cluster == 2 and big)
        assert cluster <= 2 or not big
    else:
        for d, n in zip(dims, plan["scratch_floats"]):
            dp = -(-d // 16) * 16
            assert n == B * 4 * dp * tpolar.k1_row_stride(dp) + B * -(-dp // 64)


def test_k1_plan_d2000_workspace():
    plan = tpolar.k1_plan((2000,), 2)
    assert plan["scratch_floats"] == [2 * 4 * 2000 * 2000 + 2 * 32]  # ld = 2000


@pytest.mark.parametrize("B", [1, 4, 32, 64])
def test_k1_plan_every_d_up_to_2000(B):
    """Every d from 1 to 2000 (odd ones too) gets a plan: a cluster whose
    strips fit in shared memory, else the tiles path; at B=1 the cluster
    path reaches at least d = 256."""
    largest_cluster_d = 0
    for d in range(1, 2001):
        plan = tpolar.k1_plan((d,), B)
        if plan["path"] == "cluster":
            assert plan["cluster"] in (1, 2, 4, 8)
            assert plan["smem"] <= tpolar.K1_SMEM_MAX
            largest_cluster_d = d
        else:
            assert plan["scratch_floats"][0] > 0
    assert B > 1 or largest_cluster_d >= 256


def test_k1_plan_forced_cluster():
    assert tpolar.k1_plan((100, 51, 50), 64, cluster=8)["cluster"] == 8
    assert tpolar.k1_plan((100, 51, 50), 1, cluster=0)["path"] == "tiles"
    with pytest.raises(ValueError):
        tpolar.k1_plan((200,), 1, cluster=1)  # four 200x200 matrices in one CTA
    with pytest.raises(ValueError):
        tpolar.k1_plan((100,), 1, cluster=3)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the K1 wrapper's
    CUDA branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


@pytest.mark.parametrize("B,dims", [(1, (12, 7, 6)), (2, (600,))], ids=["cluster", "tiles"])
def test_k1_cuda_tensor_takes_no_plain_or_library_path(B, dims, monkeypatch):
    """On a CUDA tensor the wrapper launches K1 or raises: neither the plain
    chain nor a torch product runs (here, without a GPU, it raises)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernel")

    def plain(*a, **kw):
        raise _PlainCalled

    for mod, attr in ((tpolar, "project_psd_ns_merged"), (tpolar, "project_psd_ns"),
                      (torch, "matmul"), (torch, "bmm")):
        monkeypatch.setattr(mod, attr, plain)
    ts = [torch.zeros(B, d, d).as_subclass(_FakeCuda) for d in dims]
    assert tpolar.k1_plan(dims, B)["path"] == ("cluster" if B == 1 else "tiles")
    # a CPU-only torch refuses the CUDA workspace with an AssertionError
    with pytest.raises((RuntimeError, AssertionError)):
        tpolar.project_psd_ns_multi(ts)
