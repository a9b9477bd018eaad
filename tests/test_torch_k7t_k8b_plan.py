"""K7t and K8b on the CPU: the grid ``k8b_plan`` picks at the shapes the Shor
k=1 loop runs, K7t's index records, torch mirrors of both kernels' order of
work against ``omc``, and the wrappers' packed blocks and refusals.

K7t (``omc_torch/csrc/k7k_minor_xwh.cu``) and K8b (``csrc/k8_shor.cu``) run
on the GPU only; ``chip_smoke.py`` holds them against their plain versions
there.  The ownership test repeats K8b's index arithmetic: B ceil(m / 32)
link CTAs, each 32 columns of a slot in 4 row groups, then CTAs of ``qpc``
quads of 4 consecutive coordinates of the batch's flat B n m, whose RSOC
triples are one staged block a CTA.  The mirrors repeat the kernels' order
of work: K8b's link sums per row group in row order, the groups added in
order; K7t's products as the upper triangles of symmetric products
(``symmetric_matmul``) on the per-term minor slots."""

import dataclasses

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
from omc.sdp import shor_k as jshk
from omc.tree import root_box

from omc_torch import convert, kernels
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import admm_shor as tshor
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

GAMMA = 20.0
THREADS, COLS, ROWS = tshor.K8B_THREADS, 32, tshor.K8B_LINK_ROWS


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- K8b's plan ----


@pytest.mark.parametrize("n", [50, 75, 100])
@pytest.mark.parametrize("B", [1, 2, 4, 16, 32, 64])
def test_k8b_plan_owns_every_coordinate_and_link_column_once(B, n):
    """Each link column of each slot is summed over every row once and
    written once; each coordinate of the batch, and each float of its RSOC
    triple, is owned by exactly one thread of K8b's grid; a quad's slots are
    the two it can span; the CTAs fill the card where the batch allows."""
    m = n
    p = tshor.k8b_plan(B, n, m)
    qpc, tiles = p["qpc"], -(-m // COLS)
    assert qpc in (32, 64, 128) and p["threads"] == THREADS
    assert p["grid"] == p["link_ctas"] + p["coord_ctas"] and p["link_ctas"] == B * tiles
    assert qpc == 32 or p["coord_ctas"] >= tshor.K8B_TARGET_CTAS
    # (l) the link CTAs: slot x // tiles, columns 32 (x % tiles) + lane,
    # row group g of 4 summing rows g, g + 4, ...
    summed = np.zeros((B, n, m), np.int64)
    written = np.zeros((B, m), np.int64)
    lane, g = np.arange(THREADS) % COLS, np.arange(THREADS) // COLS
    for x in range(p["link_ctas"]):
        b, j = x // tiles, (x % tiles) * COLS + lane
        for gg, jj in zip(g, j):
            if jj < m:
                summed[b, gg::ROWS, jj] += 1
        written[b, j[(g == 0) & (j < m)]] += 1
    assert np.all(summed == 1) and np.all(written == 1)
    # (q) the coordinates' CTAs: quads [quad0, quad0 + qpc), the CTA's RSOC
    # floats one block [3 c0, 3 c0 + 3 cnt)
    nm, tot = n * m, B * n * m
    coord = np.zeros(tot, np.int64)
    rsoc = np.zeros(3 * tot, np.int64)
    t = np.arange(THREADS)
    for x in range(p["link_ctas"], p["grid"]):
        c0 = 4 * (x - p["link_ctas"]) * qpc
        cnt = min(4 * qpc, tot - c0)
        assert cnt > 0 and (3 * c0) % 4 == 0  # the block starts 16-byte aligned
        rsoc[3 * c0:3 * c0 + 3 * cnt] += 1
        q0 = c0 + 4 * t
        for q, rem in zip(q0, np.where((t < qpc) & (q0 < tot), np.minimum(4, tot - q0), 0)):
            coord[q:q + rem] += 1
            if rem:
                b0 = q // nm
                hi = np.arange(q, q + rem) >= (b0 + 1) * nm
                assert np.array_equal(b0 + hi, np.arange(q, q + rem) // nm)
    assert np.all(coord == 1) and np.all(rsoc == 1)


def test_k8b_plan_refuses_tiny_shapes():
    for shape in ((0, 50, 50), (1, 1, 3), (1, 0, 8)):
        with pytest.raises(ValueError):
            tshor.k8b_plan(*shape)
    assert tshor.k8b_plan(1, 2, 2)["grid"] == 2


# ---- the rank-1 Shor setup (K8b) ----


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


def _port(A, mask, bl, sbj, leaves, shape, tdt, ub=30.0):
    n, m, B, L, M5 = shape
    st = convert.shor_state_from_numpy(leaves, dtype=tdt, device="cpu")
    sb = convert.shor_batch_from_numpy(list(sbj), dtype=tdt, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"), st.core, n, m, 1,
                    GAMMA, 1.6, 0.01, tdt)
    return c, tshor.make_shor_consts(c, sb, st.core, ub), st


@pytest.fixture(scope="module", params=["float64", "float32"])
def cone_pair(request):
    """One iteration of omc's Shor solver (its returned RSOC, link and
    W >= 0 slots are that iteration's cone step, taken at its z-step's X,
    Theta and W) and the port's constants and state on the same inputs, with
    omc's X, Theta and W in place."""
    dtype = request.param
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sbj, leaves, like, shape = _setup(np_dt)
    n, m, B, L, M5 = shape
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshor.make_shor_solver(n, m, L, M5, n * m, GAMMA, dtype=jdt, iters=1,
                                psd_method="eigh" if dtype == "float64" else "ns",
                                check_every=1, ema_iters=100)
    state = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
               jshor.shor_batch_to_device(sbj, jdt), ub, state)
    c, sc, st = _port(A, mask, bl, sbj, leaves, shape, tdt, ub)
    st.core.X.copy_(torch.as_tensor(np.array(fj.core.X)))
    st.core.Th.copy_(torch.as_tensor(np.array(fj.core.Th)))
    st.W.copy_(torch.as_tensor(np.array(fj.W)))
    ref = [np.asarray(getattr(fj, name)) for name in ("wr", "ur", "wl", "ul", "wp", "up")]
    return dtype, ref, (c, sc, st), shape


@pytest.mark.parametrize("rows", [None, 1, 3])
def test_k8b_mirror_matches_omc_cone_step(cone_pair, rows):
    """K8b's order of work (the link sums per row group in row order, the
    groups in order) on omc's inputs: within 1e-12 of omc's cone step in
    float64 and within K8b's bar, 1e-5, in float32, for the plan's 4 row
    groups and other counts; the EMAs as omc's loop forms them; the input
    state untouched."""
    dtype, ref, (c, sc, st), (n, m, B, L, M5) = cone_pair
    plan = tshor.k8b_plan(B, n, m)
    if rows is not None:
        plan = dict(plan, link_rows=rows)
    before = [x.clone() for x in st.leaves()]
    acc_r, acc_l = torch.ones_like(st.ur), 0.5 * torch.ones_like(st.ul)
    got = tshor.shor_cone_step_tiled(c, sc, st, acc_r, acc_l, plan)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for name, a, b in zip(("wr", "ur", "wl", "ul", "wp", "up"), got, ref):
        assert _rel(a.numpy(), b) <= tol or np.abs(b).max() == 0 == a.abs().max(), name
    rho = st.core.rho.numpy()
    for a, u, acc in ((got[6], ref[1], 1.0), (got[7], ref[3], 0.5)):
        want = acc + c.beta * (rho.reshape((-1,) + (1,) * (u.ndim - 1)) * u - acc)
        assert _rel(a.numpy(), want) <= tol
    assert all(torch.equal(x, y) for x, y in zip(st.leaves(), before))
    # the link rows' only change from the plain version is the order of sums
    plain = tshor.shor_cone_step_plain(c, sc, st, acc_r, acc_l)
    assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(got, plain)) if k not in (3, 7))
    assert _rel(got[3].numpy(), plain[3].numpy()) <= tol


# ---- the rank-k Shor setup (K7t) ----

NK = MK = 8
M5K = 8


def _shor_k(k, dtype, seed=0):
    """omc's rank-k Shor batch and a random state (per-slot rho and sS) at
    8x8, M5 = 8, two node slots, as the port's constants and state (the
    instance is rank 2 at every k: the slots' rank is the state's)."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(2, NK, MK, int(0.7 * NK * MK), 2)
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
    minors = [allm[:6], allm[3:16:2]]
    socs = [jshor_idx.shor_soc_complement(NK, MK, mm) for mm in minors]
    sbj = jshk.pack_shor_k_batch(NK, MK, minors, socs, M5K, NK * MK)
    B, L = 2, 4
    st = jshk.init_shor_k_state(B, NK, MK, k, L, M5K, NK * MK, jnp.float64, rho=0.05,
                                sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 47)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.05, 0.02])
    leaves[25] = np.array([1.7, 1.1])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    lo, hi = root_box(NK, k)
    bl = [np.zeros((B, L, NK)), np.zeros((B, L, k)), np.zeros((B, L, k)), np.zeros((B, L)),
          np.broadcast_to(lo, (B, NK, k)).copy(), np.broadcast_to(hi, (B, NK, k)).copy()]
    tst = convert.shor_k_state_from_numpy([x.astype(dtype) for x in leaves], dtype=tdt,
                                          device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=tdt, device="cpu")
    c = make_consts(torch.as_tensor(A.astype(dtype)), torch.as_tensor(idx.astype(dtype)),
                    convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"), tst.core, NK,
                    MK, k, GAMMA, 1.6, 0.01, tdt)
    return c, tshk.make_shor_k_consts(c, sb, tst.core, 30.0, k), tst


def _slot_values(c, sc, st):
    """The per-term 5x5 slots K7t projects, t5 (B, M5 k, 5, 5)."""
    seen = []

    def keep(t):
        seen.append(t.clone())
        return t

    tshk.minor_k_step_plain(c, sc, st, torch.zeros_like(st.u5), keep)
    return seen[0]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k7t_symmetric_mirror_matches_omc(k):
    """K7t's products as the upper triangles of symmetric products on the
    per-term minor slots: within 1e-12 of omc's project_psd_ns_small in
    float64; in float32 within 1e-4 of a float64 eigh projection, like omc's
    own float32 chain, and exactly symmetric; the fused step with the mirror
    within 2e-4 of the sign schedule's."""
    mirror = lambda x: tpolar.project_psd_ns(x, matmul=tpolar.symmetric_matmul())  # noqa: E731
    c, sc, st = _shor_k(k, np.float64)
    T = _slot_values(c, sc, st)
    assert T.shape == (2, M5K * k, 5, 5)
    a = mirror(T)
    assert _rel(a.numpy(), np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T.numpy())))) <= 1e-12
    assert torch.equal(a, a.transpose(-1, -2))
    Tn = T.numpy()
    w, V = np.linalg.eigh(0.5 * (Tn + np.swapaxes(Tn, -1, -2)))
    exact = np.einsum("...ik,...k,...jk->...ij", V, np.maximum(w, 0.0), V)
    c32, sc32, st32 = _shor_k(k, np.float32)
    T32 = _slot_values(c32, sc32, st32)
    a32 = mirror(T32)
    b32 = np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32.numpy())))
    assert _rel(a32.numpy(), exact) <= 1e-4 and _rel(b32, exact) <= 1e-4
    assert torch.equal(a32, a32.transpose(-1, -2))
    acc5 = torch.zeros_like(st32.u5)
    got = tshk.minor_k_step_plain(c32, sc32, st32, acc5, mirror)
    ref = tshk.minor_k_step_plain(c32, sc32, st32, acc5, tpolar.project_psd_ns_small)
    assert _rel(got[0].numpy(), ref[0].numpy()) <= 2e-4


@pytest.mark.parametrize("k", [2, 3])
def test_minor_records_equal_corner_flat_and_iv_tables(k):
    """K7t's index record of each (slot, minor): coord_flat[mc] of its four
    corners, mc, the five iv tables, three zeros; int32, contiguous; the
    slot values gathered through it are _minor_blocks_k's."""
    c, sc, st = _shor_k(k, np.float64)
    sb, rec = sc.sb, sc.rec
    assert rec.dtype == torch.int32 and rec.shape == (2, M5K, 16) and rec.is_contiguous()
    cf = torch.gather(sb.coord_flat, 1, sb.mc.reshape(2, -1).long()).reshape(2, M5K, 4)
    assert torch.equal(rec[..., 0:4], cf) and torch.equal(rec[..., 4:8], sb.mc)
    for q, name in enumerate(("iv1a", "iv1b", "iv2a", "iv2b", "iv3")):
        assert torch.equal(rec[..., 8 + q], getattr(sb, name))
    assert not rec[..., 13:].any()
    # term t of each minor through the record, as K7t gathers it
    r = rec.long()
    B = r.shape[0]

    def at(x, idx):  # x (B, k, N), idx (B, M5) -> (B, k, M5)
        return torch.gather(x, 2, idx[:, None, :].expand(B, k, idx.shape[1]))

    Xf = st.Xt.reshape(B, k, -1)
    x = [at(Xf, r[..., q]) for q in range(4)]
    w = [at(st.Wt, r[..., 4 + q]) for q in range(4)]
    v1a, v1b, v2a, v2b, v3 = (at(v, r[..., q]) for v, q in ((st.v1, 8), (st.v1, 9), (st.v2, 10),
                                                             (st.v2, 11), (st.v3, 12)))
    one = torch.ones_like(x[0])
    rows = [[one, *x], [x[0], w[0], v1a, v2a, v3], [x[1], v1a, w[1], v3, v2b],
            [x[2], v2a, v3, w[2], v1b], [x[3], v3, v2b, v1b, w[3]]]
    f5 = torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2).movedim(1, 2)
    ref = tshk._minor_blocks_k(sb, sc.cf, st.Xt, st.Wt, st.v1, st.v2, st.v3)
    assert torch.equal(f5, ref)


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
    if isinstance(x, torch.Tensor):
        return x.as_subclass(_FakeCuda)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _fake_cuda(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_fake_cuda(y) for y in x)
    return x


def _k8b_inputs(seed=2):
    A, mask, bl, sbj, leaves, _, shape = _setup(np.float32, seed=seed)
    c, sc, st = _port(A, mask, bl, sbj, leaves, shape, torch.float32)
    return c, sc, st, torch.ones_like(st.ur), torch.ones_like(st.ul)


def _pointers(p):
    return [getattr(p, name) for name, ctype in type(p)._fields_ if ctype is kernels.ctypes.c_void_p]


def test_k8b_block_packed_once_and_for_the_same_operands():
    """K8b's packed parameter block points at every operand, carries its
    plan's quads a CTA, is reused for the same tensors and packed anew for
    another; a wrong dtype and storage that is not 16-byte aligned are
    refused."""
    c, sc, st, acc_r, acc_l = _k8b_inputs()
    cpu = torch.device("cpu")
    B, n, m = st.core.X.shape
    p = tshor._k8b_params(c, sc, st, acc_r, acc_l, cpu)
    ops = tshor._k8b_operands(sc, st, acc_r, acc_l)
    for name, t, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert sorted(_pointers(p)) == sorted(t.data_ptr() for _, t, _ in ops)
    # the reuse test looks at every operand
    assert sorted(map(id, tshor._k8b_tensors(sc, st, acc_r, acc_l))) == sorted(
        id(t) for _, t, _ in ops)
    assert (p.B, p.n, p.m, p.qpc) == (B, n, m, tshor.k8b_plan(B, n, m)["qpc"])
    assert tshor._k8b_params(c, sc, st, acc_r, acc_l, cpu) is p
    acc_r2 = acc_r.clone()
    q = tshor._k8b_params(c, sc, st, acc_r2, acc_l, cpu)
    assert q is not p and q.acc_r == acc_r2.data_ptr()
    st.W = st.W.double()
    with pytest.raises(TypeError):
        tshor._k8b_params(c, sc, st, acc_r, acc_l, cpu)
    st.W = st.W.float()
    shifted = torch.empty(st.wr.numel() + 1)[1:].view(st.wr.shape)  # 4 bytes off
    st.wr = shifted.copy_(st.wr)
    with pytest.raises(ValueError, match="16-byte"):
        tshor._k8b_params(c, sc, st, acc_r, acc_l, cpu)


def test_k7t_block_packed_once_and_for_the_same_operands():
    """K7t's packed parameter block points at every operand (the index
    records, not the tables they were packed from), is reused for the same
    tensors and packed anew for another; a wrong dtype and records that are
    not 16-byte aligned are refused; k = 5 packs as k = 2 does."""
    c, sc, st = _shor_k(2, np.float32)
    acc5 = torch.ones_like(st.u5)
    cpu = torch.device("cpu")
    p = tshk._k7t_params(c, sc, st, acc5, cpu)
    ops = tshk._k7t_operands(sc, st, acc5)
    for name, t, _, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert sorted(_pointers(p)) == sorted(t.data_ptr() for _, t, _, _ in ops)
    assert sorted(map(id, tshk._k7t_tensors(sc, st, acc5))) == sorted(id(t) for _, t, _, _ in ops)
    B, n, m, k, kp, C, Ms = tshk._shapes(st)
    assert (p.B, p.M5, p.k, p.nm, p.C) == (B, M5K, k, n * m, C)
    assert tshk._k7t_params(c, sc, st, acc5, cpu) is p
    st.Xt = st.Xt.clone()
    q = tshk._k7t_params(c, sc, st, acc5, cpu)
    assert q is not p and q.Xt == st.Xt.data_ptr()
    with pytest.raises(TypeError):
        tshk._k7t_params(c, sc, st, acc5.double(), cpu)
    rec = torch.empty(sc.rec.numel() + 1, dtype=torch.int32)[1:].view(sc.rec.shape)
    sc.rec = rec.copy_(sc.rec)
    with pytest.raises(ValueError, match="16-byte"):
        tshk._k7t_params(c, sc, st, acc5, cpu)
    # K7t takes every rank: k = 5 packs its block as k = 2 does
    c5, sc5, st5 = _shor_k(5, np.float32)
    p5 = tshk._k7t_params(c5, sc5, st5, torch.ones_like(st5.u5), cpu)
    assert (p5.k, p5.M5) == (5, M5K) and p5.w == st5.w5.data_ptr()


def test_cuda_state_takes_no_plain_version(monkeypatch):
    """On a CUDA-typed state K7t's and K8b's wrappers launch their kernels
    or raise: no plain version runs (here, without a GPU, they raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    monkeypatch.setattr(tshor, "shor_cone_step_plain", plain)
    monkeypatch.setattr(tshk, "minor_k_step_plain", plain)
    c, sc, st, acc_r, acc_l = (_fake_cuda(x) for x in _k8b_inputs())
    with pytest.raises(RuntimeError):
        tshor.shor_cone_step(c, sc, st, acc_r, acc_l)
    c, sc, st = (_fake_cuda(x) for x in _shor_k(2, np.float32))
    with pytest.raises(RuntimeError):
        tshk.minor_k_step(c, sc, st, _fake_cuda(torch.ones_like(st.u5)), "ns")
