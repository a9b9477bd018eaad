"""K7x and K8d on the CPU: the grid ``k8d_plan`` picks at the shapes the
rank-k Shor loop runs, torch mirrors of both kernels' order of work against
``omc``, and the wrappers' packed blocks and refusals.

K7x (``omc_torch/csrc/k7k_minor_xwh.cu``) and K8d (``csrc/k8k_shor_k.cu``)
run on the GPU only; ``chip_smoke.py`` holds them against their plain
versions there.  The ownership test repeats K8d's index arithmetic: B
ceil(m / 32) link CTAs, each 32 columns of a slot in 4 row groups, then CTAs
of ``ipc`` items: quads of 4 consecutive W >= 0 entries of the batch's flat
B n m, quads of 4 consecutive RSOC rows of its flat B Ms (a warp's triples
one staged block), and coordinates of its flat B C.  The mirrors repeat the
kernels' order of work: K8d's link sums per row group in row order, the
groups added in order; K7x's products as the upper triangles of symmetric
products (``symmetric_matmul``) on the XWH slots."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omc.data import generate_matrix_completion_data
from omc.ops import polar as jpolar
from omc.sdp import relax as jrelax
from omc.sdp import shor as jshor_idx
from omc.sdp import shor_k as jshk
from omc.tree import root_box

from omc_torch import convert, kernels
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

GAMMA = 20.0
THREADS, COLS, ROWS = tshk.K8D_THREADS, 32, tshk.K8D_LINK_ROWS
NK = MK = 8
M5K = 8
LK = 4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- K8d's plan ----


def _flat_cover(ctas, ipc, tot, width):
    """Each thread's run [start, start + rem) of a flat kind of K8d's grid
    (``ctas`` CTAs counted from the kind's first, ``ipc`` items a CTA,
    ``width`` elements an item: 4 for a quad, 1 for a coordinate) as a
    coverage count of the ``tot`` elements, and each run's start and
    length."""
    x = np.arange(ctas)[:, None]
    t = np.arange(THREADS)[None, :]
    start = width * ((x * ipc) + t)
    live = (t < ipc) & (start < tot)
    start = start[live]
    rem = np.minimum(width, tot - start)
    cover = np.zeros(tot + width, np.int64)
    for e in range(width):
        np.add.at(cover, (start + e)[rem > e], 1)
    return cover[:tot], start, rem


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("n", [50, 75, 100])
@pytest.mark.parametrize("B", [1, 4, 32, 64])
def test_k8d_plan_owns_every_item_once(B, n, k):
    """Each link column of each slot is summed over every row once and
    written once; each W >= 0 entry, each RSOC row (and each float of its
    staged triple), and each coordinate of the batch is owned by exactly
    one thread of K8d's grid; a quad's slots are the two it can span; the
    flat CTAs fill the card where the batch allows."""
    m = n
    C, Ms = 4 * {2: 64, 3: 1024, 4: 4096}[k], n * m
    p = tshk.k8d_plan(B, n, m, k, C, Ms)
    ipc, tiles = p["ipc"], -(-m // COLS)
    assert ipc in (32, 64, 128) and p["threads"] == THREADS
    flat = p["nonneg_ctas"] + p["rsoc_ctas"] + p["coord_ctas"]
    assert p["grid"] == p["link_ctas"] + flat and p["link_ctas"] == B * tiles
    assert ipc == 32 or flat >= tshk.K8D_TARGET_CTAS
    # (l) the link CTAs: slot x // tiles, columns 32 (x % tiles) + lane, row
    # group g of 4 summing rows g, g + 4, ...
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
    # (w) W >= 0 quads, (r) RSOC quads, (c) coordinates, in that order
    nm = n * m
    for ctas, per in ((p["nonneg_ctas"], nm), (p["rsoc_ctas"], Ms)):
        cover, start, rem = _flat_cover(ctas, ipc, B * per, 4)
        assert np.all(cover == 1)
        # the kernel's slots of a quad: b0 = start // per, and b0 + 1 from
        # entry (b0 + 1) per on; its last entry then has the right slot
        b0, last = start // per, start + rem - 1
        assert np.array_equal(b0 + (last >= (b0 + 1) * per), last // per)
    # a warp's RSOC floats: one block [3 c0, 3 c0 + 3 cnt), 16-byte aligned
    tot = B * Ms
    rsoc = np.zeros(3 * tot, np.int64)
    for x in range(p["rsoc_ctas"]):
        for w in range(THREADS // 32):
            c0 = 4 * (x * ipc + 32 * w)
            if 32 * w >= ipc or c0 >= tot:
                continue
            cnt = min(128, tot - c0)
            assert (3 * c0) % 4 == 0
            rsoc[3 * c0:3 * c0 + 3 * cnt] += 1
    assert np.all(rsoc == 1)
    cover, _, _ = _flat_cover(p["coord_ctas"], ipc, B * C, 1)
    assert np.all(cover == 1)


def test_k8d_plan_refuses_tiny_shapes_and_ranks():
    for shape in ((0, 50, 50, 2, 256, 2500), (1, 1, 3, 2, 256, 3), (1, 8, 8, 2, 0, 64),
                  (1, 8, 8, 2, 256, 3)):
        with pytest.raises(ValueError):
            tshk.k8d_plan(*shape)
    with pytest.raises(ValueError, match="k >= 2"):
        tshk.k8d_plan(4, 50, 50, 1, 256, 2500)
    # past k = 4 the wide kernel, on the register kernels' grid
    p4, p5 = tshk.k8d_plan(4, 50, 50, 4, 256, 2500), tshk.k8d_plan(4, 50, 50, 5, 256, 2500)
    assert "path" not in p4 and p5.pop("path") == "wide" and p5 == p4
    assert tshk.k8d_plan(1, 2, 2, 2, 4, 4)["grid"] == 4


# ---- the rank-k Shor setup ----


def _shor_k(k, dtype, seed=0):
    """omc's rank-k Shor batch and a random state (per-slot rho and sS) at
    8x8, M5 = 8, two node slots; returns the instance, omc's batch and state
    leaves, and the port's constants and state (the instance is rank 2 at
    every k: the slots' rank is the state's)."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(2, NK, MK, int(0.7 * NK * MK), 2)
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
    minors = [allm[:6], allm[3:16:2]]
    socs = [jshor_idx.shor_soc_complement(NK, MK, mm) for mm in minors]
    sbj = jshk.pack_shor_k_batch(NK, MK, minors, socs, M5K, NK * MK)
    B = 2
    st = jshk.init_shor_k_state(B, NK, MK, k, LK, M5K, NK * MK, jnp.float64, rho=0.05,
                                sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 47)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.05, 0.02])
    leaves[25] = np.array([1.7, 1.1])
    leaves = [x.astype(dtype) for x in leaves]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    lo, hi = root_box(NK, k)
    bl = [np.zeros((B, LK, NK)), np.zeros((B, LK, k)), np.zeros((B, LK, k)), np.zeros((B, LK)),
          np.broadcast_to(lo, (B, NK, k)).copy(), np.broadcast_to(hi, (B, NK, k)).copy()]
    bl = [x.astype(dtype) for x in bl]
    A, mask = A.astype(dtype), idx.astype(dtype)
    tst = convert.shor_k_state_from_numpy(leaves, dtype=tdt, device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=tdt, device="cpu")
    ub = 0.5 * float(np.sum(mask * A * A))
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"), tst.core, NK,
                    MK, k, GAMMA, 1.6, 0.01, tdt)
    return (A, mask, bl, sbj, leaves, st, ub), (c, tshk.make_shor_k_consts(c, sb, tst.core, ub, k),
                                                tst)


@pytest.fixture(scope="module", params=["float64", "float32"])
def cone_pair(request):
    """One iteration of omc's rank-k Shor solver at k = 2 (its returned
    RSOC, link, W >= 0 and Wt >= 0 slots are that iteration's cone step,
    taken at its z-step's X, Theta, W, Wt and H) and the port's constants
    and state on the same inputs, with omc's X, Theta, W, Wt and H in
    place."""
    dtype = request.param
    np_dt = np.float64 if dtype == "float64" else np.float32
    (A, mask, bl, sbj, leaves, like, ub), (c, sc, st) = _shor_k(2, np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    sj = jshk.make_shor_k_solver(NK, MK, 2, LK, M5K, NK * MK, GAMMA, dtype=jdt, iters=1,
                                 psd_method="eigh" if dtype == "float64" else "ns",
                                 check_every=1, ema_iters=100)
    state = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
               jshk.shor_k_batch_to_device(sbj, jdt), ub, state)
    st.core.X.copy_(torch.as_tensor(np.array(fj.core.X)))
    st.core.Th.copy_(torch.as_tensor(np.array(fj.core.Th)))
    for name in ("W", "Wt", "Hh"):
        getattr(st, name).copy_(torch.as_tensor(np.array(getattr(fj, name))))
    names = ("wr", "ur", "wl", "ul", "wwl", "uwl", "wp", "up", "wq", "uq")
    ref = [np.asarray(getattr(fj, name)) for name in names]
    return dtype, names, ref, (c, sc, st)


@pytest.mark.parametrize("rows", [None, 1, 3])
def test_k8d_mirror_matches_omc_cone_step(cone_pair, rows):
    """K8d's order of work (the link sums per row group in row order, the
    groups in order) on omc's inputs: within 1e-12 of omc's cone step in
    float64 and within K8d's bar, 1e-5, in float32, for the plan's 4 row
    groups and other counts; the EMAs as omc's loop forms them; the input
    state untouched."""
    dtype, names, ref, (c, sc, st) = cone_pair
    B, n, m, k, kp, C, Ms = tshk._shapes(st)
    plan = tshk.k8d_plan(B, n, m, k, C, Ms)
    if rows is not None:
        plan = dict(plan, link_rows=rows)
    before = [x.clone() for x in st.leaves()]
    accs = (torch.ones_like(st.ur), 0.5 * torch.ones_like(st.ul), 0.25 * torch.ones_like(st.uwl))
    got = tshk.shor_k_cone_step_tiled(c, sc, st, *accs, plan)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for name, a, b in zip(names, got, ref):
        assert _rel(a.numpy(), b) <= tol or np.abs(b).max() == 0 == a.abs().max(), name
    rho = st.core.rho.numpy()
    for a, u, acc in zip(got[10:], (ref[1], ref[3], ref[5]), (1.0, 0.5, 0.25)):
        want = acc + c.beta * (rho.reshape((-1,) + (1,) * (u.ndim - 1)) * u - acc)
        assert _rel(a.numpy(), want) <= tol
    assert all(torch.equal(x, y) for x, y in zip(st.leaves(), before))
    # the link rows' only change from the plain version is the order of sums
    plain = tshk.shor_k_cone_step_plain(c, sc, st, *accs)
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got, plain)) if i not in (3, 11))
    assert _rel(got[3].numpy(), plain[3].numpy()) <= tol


@pytest.mark.parametrize("k", [3, 4])
def test_k8d_mirror_matches_plain_at_higher_rank(k):
    """At k = 3 and 4 (omc's solver takes B = k or B = 1 only, so no
    iteration of it at B = 2): K8d's order of work against the plain
    version, bit for bit but for the link rows, those within 1e-12."""
    _, (c, sc, st) = _shor_k(k, np.float64)
    B, n, m, _, kp, C, Ms = tshk._shapes(st)
    accs = (torch.ones_like(st.ur), torch.ones_like(st.ul), torch.ones_like(st.uwl))
    got = tshk.shor_k_cone_step_tiled(c, sc, st, *accs, tshk.k8d_plan(B, n, m, k, C, Ms))
    plain = tshk.shor_k_cone_step_plain(c, sc, st, *accs)
    assert all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got, plain)) if i not in (3, 11))
    assert _rel(got[3].numpy(), plain[3].numpy()) <= 1e-12
    assert _rel(got[11].numpy(), plain[11].numpy()) <= 1e-12


def _slot_values(c, sc, st):
    """The XWH slots K7x projects, tx (B, C, k + 1, k + 1)."""
    seen = []

    def keep(t):
        seen.append(t.clone())
        return t

    tshk.xwh_step_plain(c, sc, st, torch.zeros_like(st.ux), keep)
    return seen[0]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k7x_symmetric_mirror_matches_omc(k):
    """K7x's products as the upper triangles of symmetric products on the
    XWH slot values: within 1e-12 of omc's project_psd_ns_small in float64;
    in float32 within 1e-4 of omc's float32 chain and of a float64 eigh
    projection, like omc's own chain, and exactly symmetric; the fused step
    with the mirror within 2e-4 of the sign schedule's."""
    mirror = lambda x: tpolar.project_psd_ns(x, matmul=tpolar.symmetric_matmul())  # noqa: E731
    _, (c, sc, st) = _shor_k(k, np.float64)
    T = _slot_values(c, sc, st)
    assert T.shape == (2, 4 * M5K, k + 1, k + 1)
    a = mirror(T)
    assert _rel(a.numpy(), np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T.numpy())))) <= 1e-12
    assert torch.equal(a, a.transpose(-1, -2))
    Tn = T.numpy()
    w, V = np.linalg.eigh(0.5 * (Tn + np.swapaxes(Tn, -1, -2)))
    exact = np.einsum("...ik,...k,...jk->...ij", V, np.maximum(w, 0.0), V)
    _, (c32, sc32, st32) = _shor_k(k, np.float32)
    T32 = _slot_values(c32, sc32, st32)
    a32 = mirror(T32)
    b32 = np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32.numpy())))
    assert _rel(a32.numpy(), b32) <= 1e-4
    assert _rel(a32.numpy(), exact) <= 1e-4 and _rel(b32, exact) <= 1e-4
    assert torch.equal(a32, a32.transpose(-1, -2))
    accx = torch.zeros_like(st32.ux)
    got = tshk.xwh_step_plain(c32, sc32, st32, accx, mirror)
    ref = tshk.xwh_step_plain(c32, sc32, st32, accx, tpolar.project_psd_ns_small)
    assert _rel(got[0].numpy(), ref[0].numpy()) <= 2e-4


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


def _pointers(p):
    return [getattr(p, name) for name, ctype in type(p)._fields_
            if ctype is kernels.ctypes.c_void_p]


def _shifted(t):
    """A copy of ``t`` whose storage starts 4 bytes past a 16-byte boundary."""
    return torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape).copy_(t)


def test_k7x_block_packed_once_and_for_the_same_operands():
    """K7x's packed parameter block (slot mode) points at every operand, is
    reused for the same tensors and packed anew for another; a wrong dtype,
    an unsupported rank and staged blocks that are not 16-byte aligned are
    refused."""
    _, (c, sc, st) = _shor_k(2, np.float32)
    accx = torch.ones_like(st.ux)
    cpu = torch.device("cpu")
    p = tshk._k7x_params(c, sc, st, accx, cpu)
    ops = tshk._k7x_operands(sc, st, accx)
    for name, t, _, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert p.t is None  # slot mode
    assert sorted(x for x in _pointers(p) if x is not None) == sorted(
        t.data_ptr() for _, t, _, _ in ops)
    assert sorted(map(id, tshk._k7x_tensors(sc, st, accx))) == sorted(id(t) for _, t, _, _ in ops)
    B, n, m, k, kp, C, Ms = tshk._shapes(st)
    assert (p.N, p.C, p.k, p.nm) == (B * C, C, k, n * m)
    assert tshk._k7x_params(c, sc, st, accx, cpu) is p
    st.Hh = st.Hh.clone()
    q = tshk._k7x_params(c, sc, st, accx, cpu)
    assert q is not p and q.Hh == st.Hh.data_ptr()
    with pytest.raises(TypeError):
        tshk._k7x_params(c, sc, st, accx.double(), cpu)
    with pytest.raises(ValueError, match="16-byte"):
        tshk._k7x_params(c, sc, st, _shifted(accx), cpu)
    st.ux = _shifted(st.ux)
    with pytest.raises(ValueError, match="16-byte"):
        tshk._k7x_params(c, sc, st, accx, cpu)
    assert not p.wide
    # k = 5 packs the wide kernel's block, its launch from k7x_plan; a rank
    # below 2 is refused
    _, (c5, sc5, st5) = _shor_k(5, np.float32)
    p5 = tshk._k7x_params(c5, sc5, st5, torch.ones_like(st5.ux), cpu)
    plan = tshk.k7x_plan(p5.N, 6)
    assert p5.wide and plan["path"] == "wide" and (p5.warps, p5.ctas, p5.k) == (
        plan["warps"], plan["ctas"], 5) and p5.work is None
    with pytest.raises(ValueError, match="D = k \\+ 1 >= 3"):
        tshk.k7x_plan(64, 2)


def test_k8d_block_packed_once_and_for_the_same_operands():
    """K8d's packed parameter block points at every operand, carries its
    plan's items a CTA, is reused for the same tensors and packed anew for
    another; a wrong dtype, an unsupported rank and operands it reads as
    16-byte words that are not 16-byte aligned are refused."""
    _, (c, sc, st) = _shor_k(3, np.float32)
    accs = [torch.ones_like(x) for x in (st.ur, st.ul, st.uwl)]
    cpu = torch.device("cpu")
    p = tshk._k8d_params(c, sc, st, *accs, cpu)
    ops = tshk._k8d_operands(sc, st, *accs)
    for name, t, _, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert sorted(_pointers(p)) == sorted(t.data_ptr() for _, t, _, _ in ops)
    assert sorted(map(id, tshk._k8d_tensors(sc, st, *accs))) == sorted(id(t) for _, t, _, _ in ops)
    B, n, m, k, kp, C, Ms = tshk._shapes(st)
    assert (p.B, p.n, p.m, p.k, p.C, p.Ms) == (B, n, m, k, C, Ms)
    assert p.ipc == tshk.k8d_plan(B, n, m, k, C, Ms)["ipc"]
    assert tshk._k8d_params(c, sc, st, *accs, cpu) is p
    acc_wl = accs[2].clone()
    q = tshk._k8d_params(c, sc, st, accs[0], accs[1], acc_wl, cpu)
    assert q is not p and q.acc_wl == acc_wl.data_ptr()
    st.Wt = st.Wt.double()
    with pytest.raises(TypeError):
        tshk._k8d_params(c, sc, st, *accs, cpu)
    st.Wt = st.Wt.float()
    for name in ("wr", "up"):
        good = getattr(st, name)
        setattr(st, name, _shifted(good))
        with pytest.raises(ValueError, match="16-byte"):
            tshk._k8d_params(c, sc, st, *accs, cpu)
        setattr(st, name, good)
    sc.sb.soc_flat = _shifted(sc.sb.soc_flat)
    with pytest.raises(ValueError, match="16-byte"):
        tshk._k8d_params(c, sc, st, *accs, cpu)
    assert not p.wide
    # k = 5 packs the wide kernel's block on the same plan; k = 1 is refused
    _, (c5, sc5, st5) = _shor_k(5, np.float32)
    p5 = tshk._k8d_params(c5, sc5, st5, *[torch.ones_like(x) for x in (st5.ur, st5.ul, st5.uwl)],
                          cpu)
    B5, n5, m5, k5, _, C5, Ms5 = tshk._shapes(st5)
    assert p5.wide and p5.k == 5 and p5.ipc == tshk.k8d_plan(B5, n5, m5, k5, C5, Ms5)["ipc"]
    with pytest.raises(ValueError, match="k >= 2"):
        tshk.k8d_plan(B5, n5, m5, 1, C5, Ms5)


def test_k7x_projection_refuses_unaligned_storage():
    """K7x's projection mode stages t and w_out as 16-byte words: on a
    CUDA-typed tensor whose storage is not 16-byte aligned it raises before
    any launch."""
    T = torch.eye(3).expand(4, 3, 3).contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        tpolar.project_psd_xwh(_fake_cuda(_shifted(T)))
    with pytest.raises(ValueError, match="16-byte"):
        tpolar.project_psd_xwh(_fake_cuda(T), _fake_cuda(_shifted(T)))


def test_cuda_state_takes_no_plain_version(monkeypatch):
    """On a CUDA-typed state K7x's (both modes) and K8d's wrappers launch
    their kernels or raise: no plain version runs (here, without a GPU, they
    raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    monkeypatch.setattr(tshk, "xwh_step_plain", plain)
    monkeypatch.setattr(tshk, "shor_k_cone_step_plain", plain)
    monkeypatch.setattr(tshk, "project_psd_ns_small", plain)
    monkeypatch.setattr(tpolar, "project_psd_ns_small", plain)
    _, state = _shor_k(2, np.float32)
    c, sc, st = (_fake_cuda(x) for x in state)
    with pytest.raises(RuntimeError):
        tshk.xwh_step(c, sc, st, _fake_cuda(torch.ones_like(st.ux)), "ns")
    with pytest.raises(RuntimeError):
        tshk.shor_k_cone_step(c, sc, st, *[_fake_cuda(torch.ones_like(x))
                                           for x in (st.ur, st.ul, st.uwl)])
    with pytest.raises(RuntimeError):
        tpolar.project_psd_xwh(_fake_cuda(torch.eye(4).expand(8, 4, 4).contiguous()))
