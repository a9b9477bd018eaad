"""K7 and K8a on the CPU: the work split ``k8a_plan`` picks at the shapes the
Shor k=1 loop runs, K7's projection-mode block, torch mirrors of the kernels' order of
work against ``omc``, and the wrappers' refusals.

K7 (``omc_torch/csrc/k7_minor_psd.cu``) and K8a (``csrc/k8_shor.cu``) run on
the GPU only; ``chip_smoke.py`` holds them against their plain versions
there.  The ownership test repeats K8a's index arithmetic: per node slot Q
column groups, each a cluster of C CTAs on row bands [r n / C, (r + 1) n /
C), the band's items walked flat with a float reciprocal and one correction
step; Theta's 32 x 32 tile pairs decoded from a pair index; the v entries
one a thread.  The mirrors repeat the kernels' order of work: K8a's CSR
sums in list order, the column sums of zW per band in row order added over
the cluster in rank order, then t_l; K7's products as the upper triangles of
symmetric products (``symmetric_matmul``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.ops import polar as jpolar
from omc.sdp import admm_shor as jshor
from omc.sdp import relax as jrelax
from omc.sdp import shor as jshor_idx
from omc.sdp import shor_encode as jenc
from omc.tree import root_box

from omc_torch import convert, kernels
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import admm_shor as tshor
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

THREADS, TILE = tshor.K8A_THREADS, tshor.K8A_TILE


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _band(N, C, r):
    return r * N // C, (r + 1) * N // C


def _divmod_f32(e, W):
    """The kernels' divmod: trunc((e + 0.5) (1 / W)) in float32, corrected."""
    inv = np.float32(1.0) / np.float32(W)
    i = np.trunc((e.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    j = e - i * W
    lo, hi = j < 0, j >= W
    i = i - lo + hi
    j = j + W * lo - W * hi
    return i, j


def _tile_pair(pr):
    """K8a's tile_pair: a float32 square root, then integer corrections."""
    I = int((np.sqrt(np.float32(8 * pr + 1)) - np.float32(1)) * np.float32(0.5))
    while I * (I + 1) // 2 > pr:
        I -= 1
    while (I + 1) * (I + 2) // 2 <= pr:
        I += 1
    return I, pr - I * (I + 1) // 2


@pytest.mark.parametrize("n", [50, 75, 100])
@pytest.mark.parametrize("M5", [64, 256, 1024, 4096])
@pytest.mark.parametrize("B", [1, 4, 16, 32, 64])
def test_k8a_plan_owns_every_entry_once(B, M5, n):
    """Each X/W coordinate, each Theta entry and each v entry of a slot is
    owned by exactly one thread of K8a's grid; the grid is whole clusters of
    a portable size; the shared memory fits a CTA."""
    m = n
    p = tshor.k8a_plan(B, n, m, M5)
    C, Q = p["cluster"], p["groups"]
    assert C in (1, 2, 4, 8) and C <= n and 1 <= Q <= m
    assert p["grid"] == (p["grid"][0], B) and p["grid"][0] % C == 0
    assert p["smem"] <= tshor.K8A_SMEM_MAX and p["threads"] == THREADS
    # only small batches split the columns, and never below a coordinate for
    # every other thread
    assert Q == 1 or (B * C * Q <= tshor.K8A_TARGET_CTAS
                      and 2 * p["rows"] * p["cols"] >= THREADS)
    # (a) the coordinates: cluster k, rank r
    coord = np.zeros((n, m), np.int64)
    diag = np.zeros(m, np.int64)
    for k in range(Q):
        j0, j1 = _band(m, Q, k)
        for r in range(C):
            lo, hi = _band(n, C, r)
            e = np.arange((hi - lo) * (j1 - j0))  # every thread's e, tid + 256 u
            il, jl = _divmod_f32(e, j1 - j0)
            np.add.at(coord, (lo + il, j0 + jl), 1)
            if r == 0:
                diag[j0:j1] += 1
    assert np.all(coord == 1) and np.all(diag == 1)
    # (b) Theta's off-diagonal: one CTA a tile pair (I, J), I >= J
    theta = np.zeros((m, m), np.int64)
    np.fill_diagonal(theta, diag)
    nt = -(-m // TILE)
    assert p["pairs"] == nt * (nt + 1) // 2
    ii, jj = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    for pr in range(p["pairs"]):
        I, J = _tile_pair(pr)
        assert 0 <= J <= I < nt
        for r, s, on in ((I * TILE + ii, J * TILE + jj, True), (J * TILE + ii, I * TILE + jj, I != J)):
            ok = (r < m) & (s < m) & (r != s) & on
            np.add.at(theta, (r[ok], s[ok]), 1)
    assert np.all(theta == 1)
    # (c) the v entries: one a thread of the CTAs after the tile pairs
    P = 5 * M5
    v = np.zeros(P, np.int64)
    first = Q * C + p["pairs"]
    for x in range(first, p["grid"][0]):
        e = (x - first) * THREADS + np.arange(THREADS)
        np.add.at(v, e[e < P], 1)
    assert p["v_ctas"] == -(-P // THREADS) and np.all(v == 1)


@pytest.mark.parametrize("N", [64, 4096, 16384, 32768, 131072, 1000])
def test_k7_projection_block(N, monkeypatch):
    """K7's projection mode on N matrices of a CUDA-typed batch: one launch
    whose block points at the input and the output only (no fused operand)
    and counts the N matrices the kernel tiles in CTAs of 128."""
    launched = []
    monkeypatch.setattr(kernels, "launch", lambda key, fn, prm, dev: launched.append((key, fn,
                                                                                      prm)))
    T = _fake_cuda(torch.zeros((N, 5, 5)))
    w = _fake_cuda(torch.zeros((N, 5, 5)))
    assert tpolar.project_psd_small(T, w) is w
    ((key, fn, p),) = launched
    assert (key, fn, p.N) == ("K7", "omc_k7_minor_psd", N)
    assert (p.t, p.w) == (T.data_ptr(), w.data_ptr())
    assert all(getattr(p, name) is None for name in ("u", "acc", "Xs", "Ws", "minor_idx"))
    with pytest.raises(ValueError):
        tpolar.project_psd_small(_fake_cuda(torch.zeros((N, 4, 4))))


def test_k8a_plan_forced_and_refused_choices():
    p = tshor.k8a_plan(4, 50, 50, 4096, cluster=2, groups=3)
    assert (p["cluster"], p["groups"], p["rows"], p["cols"]) == (2, 3, 25, 17)
    for kw in (dict(cluster=16), dict(cluster=3), dict(groups=0), dict(groups=51)):
        with pytest.raises(ValueError):
            tshor.k8a_plan(4, 50, 50, 4096, **kw)
    with pytest.raises(ValueError):
        tshor.k8a_plan(1, 4, 4, 64, cluster=8)  # more CTAs than rows
    with pytest.raises(ValueError):  # a forced tile beyond a CTA's shared memory
        tshor.k8a_plan(1, 500, 500, 64, cluster=1, groups=1)
    # unforced, the columns split until the tile fits
    p = tshor.k8a_plan(1, 1000, 1000, 64)
    assert p["smem"] <= tshor.K8A_SMEM_MAX and p["groups"] > 1


# ---- the mirrors against omc ----

GAMMA = 20.0


def _setup(dtype, n=10, m=12, B=2, L=4, M5=64, seed=0):
    """Two node slots of a rank-1 instance with all its 4-minors split
    between them, random slot values and duals, per-slot rho and scales."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(1, n, m, int(0.5 * n * m), seed=3)
    A, mask = np.ascontiguousarray(A), np.ascontiguousarray(idx, dtype=np.float64)
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    minors = [allm[:M5 - 5], allm[M5 - 5:2 * M5 - 30]]
    socs = [jshor_idx.shor_soc_complement(n, m, mm) for mm in minors]
    sbj = jenc.pack_shor_batch(n, m, minors, socs, M5, n * m)
    lo, hi = root_box(n, 1)
    bl = [np.zeros((B, L, n)), np.zeros((B, L, 1)), np.zeros((B, L, 1)), np.zeros((B, L)),
          np.broadcast_to(lo, (B, n, 1)).copy(), np.broadcast_to(hi, (B, n, 1)).copy()]
    st = jshor.init_shor_state(B, n, m, 1, L, M5, n * m, jnp.float64, rho=0.05,
                               sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 38)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.05, 0.02])  # per-slot rho
    leaves = [x.astype(dtype) for x in leaves]
    return (A.astype(dtype), mask.astype(dtype), [x.astype(dtype) for x in bl], sbj, leaves,
            st, (n, m, B, L, M5))


@pytest.fixture(scope="module", params=["float64", "float32"])
def zstep_pair(request):
    """omc's Shor z-step (one iteration of its solver: the returned X, Theta,
    W and v are that iteration's z-step) and the port's constants on the
    same inputs."""
    dtype = request.param
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sbj, leaves, like, (n, m, B, L, M5) = _setup(np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshor.make_shor_solver(n, m, L, M5, n * m, GAMMA, dtype=jdt, iters=1,
                                psd_method="eigh" if dtype == "float64" else "ns",
                                check_every=1, ema_iters=100)
    state = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
               jshor.shor_batch_to_device(sbj, jdt), ub, state)
    ref = [np.asarray(x) for x in (fj.core.X, fj.core.Th, fj.W, fj.v1, fj.v2, fj.v3)]
    st = convert.shor_state_from_numpy(leaves, dtype=tdt, device="cpu")
    sb = convert.shor_batch_from_numpy(list(sbj), dtype=tdt, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"), st.core, n, m, 1,
                    GAMMA, 1.6, 0.01, tdt)
    sc = tshor.make_shor_consts(c, sb, st.core, ub)
    return dtype, ref, (c, sc, st), (B, n, m, M5)


@pytest.mark.parametrize("cluster,groups", [(None, None), (1, 1), (2, 3), (8, 1), (4, 12)])
def test_k8a_mirror_matches_omc_zstep(zstep_pair, cluster, groups):
    """K8a's order of work (row bands, rank-order cluster sums, t_l; CSR
    sums in list order) on omc's inputs: within 1e-12 of omc's z-step in
    float64 and within K8a's bar, 1e-5, in float32, for the plan's and
    forced cluster sizes and column groups; the input state is untouched."""
    dtype, ref, (c, sc, st), (B, n, m, M5) = zstep_pair
    before = [x.clone() for x in st.leaves()]
    plan = tshor.k8a_plan(B, n, m, M5, cluster, groups)
    got = tshor.shor_zstep_tiled(c, sc, st, plan)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for name, a, b in zip(("X", "Th", "W", "v1", "v2", "v3"), got, ref):
        assert _rel(a.numpy(), b) <= tol, (name, _rel(a.numpy(), b))
    assert torch.equal(got[1], got[1].transpose(-1, -2))  # sym(Theta), exactly
    assert all(torch.equal(x, y) for x, y in zip(st.leaves(), before))


def _spectral5(rng, count):
    Q = np.linalg.qr(rng.standard_normal((count, 5, 5)))[0]
    lam = rng.uniform(0.1, 1.0, (count, 5)) * rng.choice([-1.0, 1.0], (count, 5))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    return 0.5 * (T + np.swapaxes(T, -1, -2))


def _exact_psd(T):
    w, V = np.linalg.eigh(T)
    return np.einsum("...ik,...k,...jk->...ij", V, np.maximum(w, 0.0), V)


def test_k7_symmetric_mirror_matches_omc():
    """K7's products as the upper triangles of symmetric products: within
    1e-12 of omc's project_psd_ns_small in float64; in float32 within 1e-4
    of a float64 eigh projection, like omc's own float32 chain; the result
    exactly symmetric."""
    rng = np.random.default_rng(11)
    T = _spectral5(rng, 800).reshape(4, 200, 5, 5)
    # an asymmetric perturbation: both symmetrise first
    T = T + 1e-3 * rng.standard_normal(T.shape)
    mirror = lambda x: tpolar.project_psd_ns(x, matmul=tpolar.symmetric_matmul())  # noqa: E731
    a = mirror(torch.as_tensor(T))
    assert _rel(a.numpy(), np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T)))) <= 1e-12
    assert torch.equal(a, a.transpose(-1, -2))
    exact = _exact_psd(0.5 * (T + np.swapaxes(T, -1, -2)))
    T32 = T.astype(np.float32)
    a32 = mirror(torch.as_tensor(T32))
    b32 = np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32)))
    assert _rel(a32.numpy(), exact) <= 1e-4 and _rel(b32, exact) <= 1e-4
    assert torch.equal(a32, a32.transpose(-1, -2))
    # the fused step's plain version with the mirror as its projection
    # stays within 2e-4 of the sign schedule's (both within 1e-4 of exact)
    assert _rel(a32.numpy(), b32) <= 2e-4


# ---- the wrappers ----


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainCalled(Exception):
    pass


def _fake_cuda(x):
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.as_subclass(_FakeCuda)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _fake_cuda(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_fake_cuda(y) for y in x)
    return x


def _port_inputs(seed=2):
    A, mask, bl, sbj, leaves, _, (n, m, B, L, M5) = _setup(np.float32, seed=seed)
    st = convert.shor_state_from_numpy(leaves, dtype=torch.float32, device="cpu")
    sb = convert.shor_batch_from_numpy(list(sbj), dtype=torch.float32, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=torch.float32, device="cpu"),
                    st.core, n, m, 1, GAMMA, 1.6, 0.01, torch.float32)
    sc = tshor.make_shor_consts(c, sb, st.core, 30.0)
    return c, sc, st, torch.ones_like(st.u5)


def test_cuda_state_takes_no_plain_version(monkeypatch):
    """On a CUDA-typed state K7's and K8a's wrappers launch their kernels or
    raise: no plain version runs (here, without a GPU, they raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    for name in ("shor_zstep_plain", "minor_step_plain", "project_psd_ns_small"):
        monkeypatch.setattr(tshor, name, plain)
    monkeypatch.setattr(tpolar, "project_psd_ns_small", plain)
    c, sc, st, acc5 = (_fake_cuda(x) for x in _port_inputs())
    with pytest.raises(RuntimeError):
        tshor.shor_zstep(c, sc, st)
    with pytest.raises(RuntimeError):
        tshor.minor_step(c, sc, st, acc5, "ns")
    with pytest.raises(RuntimeError):
        tpolar.project_psd_small(st.w5)


def test_k7_k8a_blocks_packed_once_and_point_at_operands(monkeypatch):
    """K7's and K8a's parameter blocks are packed once per operands and
    point only at their operands; K8a's carries its plan's choices."""
    launched = []
    monkeypatch.setattr(kernels, "launch", lambda key, fn, prm, dev: launched.append((key, prm)))
    c, sc, st, acc5 = (_fake_cuda(x) for x in _port_inputs(seed=4))
    B, n, m = st.core.X.shape
    for _ in range(2):
        tshor.shor_zstep(c, sc, st)
        tshor.minor_step(c, sc, st, acc5, "ns")
    (k8, p8), (k7, p7), (_, p8b), (_, p7b) = launched
    assert (k8, k7) == ("K8a", "K7") and p8b is p8 and p7b is p7
    plan = tshor.k8a_plan(B, n, m, sc.M5)
    assert (p8.C, p8.Q, p8.M5) == (plan["cluster"], plan["groups"], sc.M5)
    assert p7.N == B * sc.M5
    for p, watched in ((p8, tshor._k8a_tensors(c, sc, st)), (p7, tshor._k7_tensors(sc, st, acc5))):
        watched = {t.data_ptr() for t in watched}
        ptrs = [getattr(p, name) for name, ctype in type(p)._fields_
                if ctype is kernels.ctypes.c_void_p]
        assert all(x is None or x in watched for x in ptrs)
    # another operand packs a new block, with the same plan
    st.W = _fake_cuda(st.W.clone())
    tshor.shor_zstep(c, sc, st)
    p8c = launched[-1][1]
    assert p8c is not p8 and p8c.Ws == st.W.data_ptr()
    assert (p8c.C, p8c.Q) == (plan["cluster"], plan["groups"])
