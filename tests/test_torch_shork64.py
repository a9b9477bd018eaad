"""The CPU side of the rank-k Shor family (k > 1) in float64 on the card (the
float64 builds of K7t, K7x, K8c and K8d beside those of K2-K6).

The kernels run on the GPU only (``chip_smoke.py`` holds each float64 build
against its plain version there).  Here: (a) the dtype-aware plans of K7t,
K7x, K8c and K8d hold every shape the rank-k loop runs (B in {1, 4, 16, 32,
64}, M5 in {256, 1024, 4096}, k in {2, 3, 4} at n = m = 75) within a CTA's
shared memory at 8 bytes a value, by recounts of the kernels' layouts, every
matrix, column, group and staged value owned once, and the float32 plans
are those of before; (b) K7t's and K7x's float64 plain versions, the fused
slot steps with K4s's Jacobi mirror (``ops.jacobi.k4s_project_psd``, the
order of work of the kernels' exact projections), against the same steps
with LAPACK and against one iteration of ``omc``'s float64 rank-k Shor
solver on its eigh route; (c) the wrappers: a float64 state packs the
float64 blocks and counts its launches under the ``..._f64`` keys, a
float64 projection-mode launch and a method that does not match the build
raise; (d) the api's rank-k Shor relaxation at its defaults (float64) on
the CPU against ``omc``'s."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import omc.api as japi
import omc.sdp.shor as jshor_idx
import omc.tree as jtree
from omc.data import generate_matrix_completion_data
from omc.sdp import relax as jrelax
from omc.sdp import shor_k as jshk

import omc_torch.api as tapi
import omc_torch.sdp.shor as tshor_idx
import omc_torch.tree as ttree
from omc_torch import convert, kernels
from omc_torch.ops import cones, jacobi, polar
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
SMEM = 232448  # the most shared memory one CTA may use on an H100
STATIC_SMEM = 48 * 1024  # the most static shared memory a CTA may declare
N75 = 75
# the rank-k loop's shapes at config 3's width: batch buckets x minor buckets x ranks
SHAPES = [(B, M5, k) for B in (1, 4, 16, 32, 64) for M5 in (256, 1024, 4096) for k in (2, 3, 4)]


def _cdiv(a, b):
    return -(-a // b)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- (a) the plans ----


def _staged_once(N, threads, D, ld, elem):
    """A recount of the float64 K7t/K7x staging: CTA x stages matrices
    [threads x, threads (x + 1)) of the batch, each matrix's D^2 values at
    slots [r ld, r ld + D^2) of its CTA's block (r its thread), its global
    block 16-byte aligned; every matrix of the batch is one thread's, every
    value lands in one slot of its own matrix, and a half-warp's 8-byte
    accesses (one matrix a lane, the same entry) fall in 16 distinct banks
    of 8 bytes."""
    ctas = _cdiv(N, threads)
    base = np.arange(ctas) * threads
    cnt = np.minimum(threads, N - base)
    assert cnt.sum() == N and np.all(cnt > 0)
    assert np.all((base * D * D * elem) % 16 == 0)
    # the staging of one full CTA: global value q of the block -> its slot
    q = np.arange(threads * D * D)
    r, f = q // (D * D), q % (D * D)
    slot = r * ld + f
    assert np.unique(slot).size == slot.size and slot.max() < threads * ld
    assert np.all(slot // ld == r)
    lanes = np.arange(16)
    for f0 in range(D * D):
        assert np.unique((lanes * ld + f0) % 16).size == 16
    return ctas


@pytest.mark.parametrize("B,M5,k", SHAPES)
def test_k7t_k7x_plans_float64_stage_each_matrix_once(B, M5, k):
    """K7t's float64 launch: 64 (minor, term) matrices a CTA, the three
    staged blocks 38,400 bytes of static shared memory at a stride of 25
    doubles; K7x's: 128 slots a CTA at D = 3, 64 at D = 4 and 5, a slot at an
    odd stride of doubles (9, 17, 25), the staging within the static limit;
    both own every matrix once; the float32 launches of before (128 a CTA,
    floats, K7x at D^2)."""
    N7 = B * M5 * k
    p = tshk.k7t_plan(N7, F64)
    assert p["threads"] == 64 and p["smem"] == 3 * 64 * 25 * 8 == 38400 <= STATIC_SMEM
    assert p["ctas"] == _staged_once(N7, 64, 5, 25, 8)
    assert tshk.k7t_plan(N7) == tshk.k7t_plan(N7, F32) == dict(
        threads=128, ctas=_cdiv(N7, 128), smem=38400)
    D, Nx = k + 1, B * 4 * M5
    px = tshk.k7x_plan(Nx, D, F64)
    want = {3: 128, 4: 64, 5: 64}[D]
    assert px["threads"] == want and px["ld"] == (D * D) | 1 and px["ld"] % 2 == 1
    assert px["smem"] == 3 * want * px["ld"] * 8 <= STATIC_SMEM
    assert px["ctas"] == _staged_once(Nx, want, D, px["ld"], 8)
    p32 = tshk.k7x_plan(Nx, D)
    assert p32 == dict(threads=128, ctas=_cdiv(Nx, 128), ld=D * D, smem=3 * 128 * D * D * 4)


def test_k7x_float64_staging_of_d4_moves_whole_words():
    """At D = 4 the float64 staging moves 16-byte words of global memory (a
    matrix's 8 words, two doubles each) into two 8-byte slots each at the
    odd stride 17: the words of a warp's 32 lanes fill each matrix's 16
    slots once, and the stores of a half-warp fall in distinct 8-byte
    banks."""
    D, ld, per = 4, 17, 8
    q = np.arange(64 * per)  # a CTA's words
    slot0 = (q // per) * ld + 2 * (q % per)
    slots = np.concatenate([slot0, slot0 + 1])
    assert np.unique(slots).size == 64 * D * D
    assert np.all(np.sort(slots) == np.sort((np.arange(64)[:, None] * ld
                                             + np.arange(16)[None]).ravel()))
    for h in range(0, 64 * per, 16):
        for off in (0, 1):
            assert np.unique((slot0[h:h + 16] + off) % 16).size == 16


def _k8c_bytes(n, m, k, cols, elem):
    """k8c_smem_values of csrc/k8k_shor_k.cu at elem bytes a value."""
    nf = k + k * (k - 1) // 2 + 3
    return elem * (nf * n * cols + 2 * (256 // cols) * cols + cols + cols * (m + 1))


def _k8c_plan_before(B, n, m, k):
    """K8c's float32 plan as it was before the float64 build (4 bytes a
    value), for the check that it is unchanged."""
    cols = next((c for c in (32, 16, 8) if _cdiv(m, c) * B >= 264), 8)
    while cols > 1 and _k8c_bytes(n, m, k, cols, 4) > SMEM:
        cols //= 2
    return dict(cols=cols, row_groups=256 // cols, threads=256, grid=(_cdiv(m, cols), B),
                smem_bytes=_k8c_bytes(n, m, k, cols, 4))


def _flat_cover(ctas, ipc, tot, width):
    """K8d's flat kind of ``ctas`` CTAs, ``ipc`` items a CTA of 128
    threads, ``width`` elements an item: a coverage count of the ``tot``
    elements, each item's start and length."""
    x = np.arange(ctas)[:, None]
    t = np.arange(128)[None, :]
    start = width * ((x * ipc) + t)
    live = (t < ipc) & (start < tot)
    start = start[live]
    rem = np.minimum(width, tot - start)
    cover = np.zeros(tot + width, np.int64)
    for e in range(width):
        np.add.at(cover, (start + e)[rem > e], 1)
    return cover[:tot], start, rem


@pytest.mark.parametrize("B,M5,k", SHAPES)
def test_k8c_k8d_plans_float64_own_every_entry_once(B, M5, k):
    """K8c's float64 tile: its shared memory is the kernel's layout at 8
    bytes a value and fits a CTA, whole columns of each slot a CTA, every
    column owned once; the float32 plan is the one of before.  K8d's float64
    grid: a thread takes a pair of W >= 0 entries or RSOC rows (one 16-byte
    word of each operand) or a coordinate; each entry, RSOC row (and each
    value of its staged triple, a warp's block 16-byte aligned) and
    coordinate is owned once, a pair's slots the two it can span; the
    float32 grid of before (quads)."""
    n = m = N75
    p = tshk.k8c_plan(B, n, m, k, F64)
    cols = p["cols"]
    assert cols in (1, 2, 4, 8, 16, 32) and p["row_groups"] * cols == 256
    assert p["smem_bytes"] == _k8c_bytes(n, m, k, cols, 8) <= SMEM
    assert p["grid"] == (_cdiv(m, cols), B)
    owned = np.zeros((B, m), np.int64)
    for x in range(p["grid"][0]):
        j = x * cols + np.arange(cols)
        owned[:, j[j < m]] += 1
    assert np.all(owned == 1)
    assert tshk.k8c_plan(B, n, m, k) == tshk.k8c_plan(B, n, m, k, F32) == _k8c_plan_before(
        B, n, m, k)
    assert tshk.k8c_smem_bytes(n, m, k, cols, F64) == 2 * tshk.k8c_smem_bytes(n, m, k, cols)

    C, Ms, nm = 4 * M5, n * m, n * m
    for dt, E in ((F64, 2), (F32, 4)):
        d = tshk.k8d_plan(B, n, m, k, C, Ms, dt)
        ipc = d["ipc"]
        assert ipc in (32, 64, 128) and d["threads"] == 128
        assert d["link_ctas"] == B * _cdiv(m, 32)
        assert (d["nonneg_ctas"], d["rsoc_ctas"], d["coord_ctas"]) == (
            _cdiv(_cdiv(B * nm, E), ipc), _cdiv(_cdiv(B * Ms, E), ipc), _cdiv(B * C, ipc))
        assert d["grid"] == d["link_ctas"] + d["nonneg_ctas"] + d["rsoc_ctas"] + d["coord_ctas"]
        flat = d["nonneg_ctas"] + d["rsoc_ctas"] + d["coord_ctas"]
        assert ipc == 32 or flat >= tshk.K8D_TARGET_CTAS
        if dt is F32:
            assert d == tshk.k8d_plan(B, n, m, k, C, Ms)
            continue
        for ctas, per in ((d["nonneg_ctas"], nm), (d["rsoc_ctas"], Ms)):
            cover, start, rem = _flat_cover(ctas, ipc, B * per, E)
            assert np.all(cover == 1)
            assert np.all((start * 8) % 16 == 0)  # a pair is one 16-byte word
            b0, last = start // per, start + rem - 1
            assert np.array_equal(b0 + (last >= (b0 + 1) * per), last // per)
        tot = B * Ms
        rsoc = np.zeros(3 * tot, np.int64)
        for x in range(d["rsoc_ctas"]):
            for w in range(4):
                c0 = E * (x * ipc + 32 * w)
                if 32 * w >= ipc or c0 >= tot:
                    continue
                cnt = min(32 * E, tot - c0)
                assert (3 * c0 * 8) % 16 == 0
                rsoc[3 * c0:3 * c0 + 3 * cnt] += 1
        assert np.all(rsoc == 1)
        cover, _, _ = _flat_cover(d["coord_ctas"], ipc, B * C, 1)
        assert np.all(cover == 1)


# ---- (b) K7t's and K7x's float64 plain versions ----

NK = MK = 8
M5K = 8
LK = 4
GAMMA = 20.0


def _shor_k(k, dtype=F64, seed=0):
    """omc's rank-k Shor batch and a random state (per-slot rho and sS) at
    8 x 8, M5 = 8, two node slots: the instance, omc's batch and float64
    state leaves, and the port's constants and state in ``dtype``."""
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
    lo, hi = jtree.root_box(NK, k)
    bl = [np.zeros((B, LK, NK)), np.zeros((B, LK, k)), np.zeros((B, LK, k)), np.zeros((B, LK)),
          np.broadcast_to(lo, (B, NK, k)).copy(), np.broadcast_to(hi, (B, NK, k)).copy()]
    mask = idx.astype(np.float64)
    tst = convert.shor_k_state_from_numpy(leaves, dtype=dtype, device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=dtype, device="cpu")
    ub = 0.5 * float(np.sum(mask * A * A))
    c = make_consts(torch.as_tensor(A, dtype=dtype), torch.as_tensor(mask, dtype=dtype),
                    convert.node_batch_from_numpy(bl, dtype=dtype, device="cpu"), tst.core, NK,
                    MK, k, GAMMA, 1.6, 0.01, dtype)
    return (A, mask, bl, sbj, leaves, st, ub), (c, tshk.make_shor_k_consts(c, sb, tst.core, ub, k),
                                                tst)


@functools.lru_cache(maxsize=None)
def _shor_k_cached(k, dtype=F64):
    """``_shor_k``'s port constants and state, made once per rank and dtype
    for the tests that only read them."""
    return _shor_k(k, dtype)[1]


def _mirror(seen):
    def proj(t):
        P, sweeps = jacobi.k4s_project_psd(t)
        seen.update(t=t, sweeps=sweeps)
        return P
    return proj


@pytest.mark.parametrize("step", ["minor", "xwh"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_k7t_k7x_float64_plain_versions_match_lapack(k, step):
    """The fused slot steps with K4s's Jacobi mirror (K7t's and K7x's
    float64 order of work) against the same steps with LAPACK's projection:
    w within 1e-12 max|lambda| of each slot's t, u and the EMA within 1e-12
    of the same scale; the sweeps within the cap."""
    c, sc, st = _shor_k_cached(k)
    fn, acc = ((tshk.minor_k_step_plain, torch.full_like(st.u5, 0.1)) if step == "minor"
               else (tshk.xwh_step_plain, torch.full_like(st.ux, 0.1)))
    seen = {}
    got = fn(c, sc, st, acc, _mirror(seen))
    ref = fn(c, sc, st, acc, cones.project_psd)
    t = seen["t"]
    lam = torch.linalg.eigvalsh(0.5 * (t + t.transpose(-1, -2))).abs().amax(-1)
    for a, b in zip(got, ref):
        err = (a - b).abs().reshape(t.shape).amax((-2, -1)) / lam
        assert float(err.max()) <= 1e-12
    assert int(seen["sweeps"].max()) <= jacobi.MAX_SWEEPS
    D = 5 if step == "minor" else k + 1
    assert t.shape[-2:] == (D, D)


@pytest.fixture(scope="module")
def omc_step():
    """One iteration of omc's float64 rank-k Shor solver at k = 2 on its
    eigh route (its returned w5, u5, wx and ux are that iteration's slot
    steps, at its z-step's Xt, Wt, H and v) and the port's constants and
    state on the same inputs, with omc's primal in place."""
    (A, mask, bl, sbj, leaves, like, ub), (c, sc, st) = _shor_k(2)
    sj = jshk.make_shor_k_solver(NK, MK, 2, LK, M5K, NK * MK, GAMMA, dtype=jnp.float64, iters=1,
                                 psd_method="eigh", check_every=1, ema_iters=100)
    state = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
               jshk.shor_k_batch_to_device(sbj, jnp.float64), ub, state)
    for name in ("Xt", "W", "Wt", "Hh", "v1", "v2", "v3"):
        getattr(st, name).copy_(torch.as_tensor(np.array(getattr(fj, name))))
    st.core.X.copy_(torch.as_tensor(np.array(fj.core.X)))
    return (c, sc, st), {name: np.asarray(getattr(fj, name)) for name in ("w5", "u5", "wx", "ux")}


@pytest.mark.parametrize("step", ["minor", "xwh"])
def test_k7t_k7x_float64_plain_versions_match_omc_step(omc_step, step):
    """K7t's and K7x's float64 order of work (the slot steps with K4s's
    Jacobi mirror) on omc's primal: w and u within 1e-12 relative of one
    iteration of omc's float64 rank-k Shor solver, which projects both slot
    families with eigh."""
    (c, sc, st), ref = omc_step
    seen = {}
    if step == "minor":
        w, u, _ = tshk.minor_k_step_plain(c, sc, st, torch.zeros_like(st.u5), _mirror(seen))
        names = ("w5", "u5")
    else:
        w, u, _ = tshk.xwh_step_plain(c, sc, st, torch.zeros_like(st.ux), _mirror(seen))
        names = ("wx", "ux")
    assert _rel(w.numpy(), ref[names[0]]) <= 1e-12
    assert _rel(u.numpy(), ref[names[1]]) <= 1e-12
    assert int(seen["sweeps"].max()) <= jacobi.MAX_SWEEPS


# ---- (c) the wrappers ----


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    if isinstance(x, torch.Tensor):
        return x.as_subclass(_FakeCuda)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _fake_cuda(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_fake_cuda(y) for y in x)
    return x


@pytest.fixture
def fake_lib(monkeypatch):
    """A kernel library whose every entry point returns 0 and records its
    call (entry point, block), so that ``kernels.launch`` runs and counts."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda prm, stream: calls.append((name, prm._obj)) or 0

    monkeypatch.setattr(kernels, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    return calls


def test_float64_state_launches_the_float64_builds(fake_lib):
    """A float64 CUDA-typed state at k = 3 packs the float64 blocks of K8c,
    K7t, K7x and K8d (double scalars), points them at the float64 operands
    and the int32 tables, calls the ..._f64 entry points with the float64
    plans, and counts the launches under K8c_f64, K7t_f64, K7x_f64 and
    K8d_f64 (the float32 keys untouched)."""
    c, sc, st = (_fake_cuda(x) for x in _shor_k_cached(3))
    acc5, accx, acc_r, acc_l, acc_wl = (torch.zeros_like(x)
                                        for x in (st.u5, st.ux, st.ur, st.ul, st.uwl))
    before = dict(kernels.LAUNCHES)
    tshk.shor_k_zstep(c, sc, st)
    tshk.minor_k_step(c, sc, st, acc5, "eigh")
    tshk.xwh_step(c, sc, st, accx, "eigh")
    tshk.shor_k_cone_step(c, sc, st, acc_r, acc_l, acc_wl)
    (f8c, p8c), (f7t, p7t), (f7x, p7x), (f8d, p8d) = fake_lib
    assert (f8c, f7t, f7x, f8d) == ("omc_k8c_shor_k_zstep_f64", "omc_k7t_minor_k_f64",
                                    "omc_k7x_xwh_f64", "omc_k8d_shor_k_cone_f64")
    assert isinstance(p8c, kernels.K8cParams64) and isinstance(p7t, kernels.K7tParams64)
    assert isinstance(p7x, kernels.K7xParams64) and isinstance(p8d, kernels.K8dParams64)
    got = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    assert all(got[key] == 1 for key in ("K8c_f64", "K7t_f64", "K7x_f64", "K8d_f64"))
    assert sum(got.values()) == 4
    B, n, m, k, kp, C, Ms = tshk._shapes(st)
    assert p8c.cols == tshk.k8c_plan(B, n, m, k, F64)["cols"]
    assert p8d.ipc == tshk.k8d_plan(B, n, m, k, C, Ms, F64)["ipc"]
    assert (p7t.w, p7t.u, p7t.acc, p7t.rec) == (st.w5.data_ptr(), st.u5.data_ptr(),
                                                acc5.data_ptr(), sc.rec.data_ptr())
    assert (p7x.w, p7x.acc, p7x.t, p7x.coord_flat) == (st.wx.data_ptr(), accx.data_ptr(), None,
                                                       sc.sb.coord_flat.data_ptr())
    assert (p8c.fm_ent, p8c.Xt) == (sc.sb.fm_ent.data_ptr(), st.Xt.data_ptr())
    assert (p8d.soc_flat, p8d.acc_wl) == (sc.sb.soc_flat.data_ptr(), acc_wl.data_ptr())
    assert (p7t.alpha, p7x.beta, p8c.R_X, p8d.alpha) == (c.alpha, c.beta, sc.R_X, c.alpha)


def test_float64_refuses_projection_mode_and_the_other_method(fake_lib):
    """K7x's float64 build has no projection mode (K4s's float64 build serves
    the XWH projections of the bound): a float64 batch raises; a float64
    state asks psd_method="eigh" of K7t and K7x and a float32 state "ns";
    nothing is launched."""
    with pytest.raises(TypeError):
        polar.project_psd_xwh(_fake_cuda(torch.zeros((4, 3, 3), dtype=F64)))
    c, sc, st = (_fake_cuda(x) for x in _shor_k_cached(2))
    with pytest.raises(ValueError, match='psd_method="eigh"'):
        tshk.minor_k_step(c, sc, st, torch.zeros_like(st.u5), "ns")
    with pytest.raises(ValueError, match='psd_method="eigh"'):
        tshk.xwh_step(c, sc, st, torch.zeros_like(st.ux), "ns")
    c32, sc32, st32 = (_fake_cuda(x) for x in _shor_k_cached(2, F32))
    with pytest.raises(ValueError, match='psd_method="ns"'):
        tshk.xwh_step(c32, sc32, st32, torch.zeros_like(st32.ux), "eigh")
    with pytest.raises(ValueError, match='psd_method="ns"'):
        tshk.minor_k_step(c32, sc32, st32, torch.zeros_like(st32.u5), "eigh")
    assert not fake_lib


# ---- (d) the api's rank-k Shor relaxation at its defaults ----


def test_rank_k_shor_relaxation_at_the_defaults_matches_omc():
    """api.matrix_completion_SDP_relaxation(..., k=2,
    add_Shor_valid_inequalities=True) with no dtype (float64) and its
    default 2,000 iterations on a 6 x 6 node with the first 24 of its [4,
    3]-minors, on the CPU, against omc's: bound and objective within 1e-8
    relative."""
    N = 6
    A, idx = generate_matrix_completion_data(2, N, N, 24, 3)
    lo, hi = ttree.root_box(N, 2)
    nodes = []
    for tree_mod, shor_mod in ((jtree, jshor_idx), (ttree, tshor_idx)):
        minors = shor_mod.generate_rank1_matrix_completion_Shor_constraints_indexes(
            idx, [4, 3])[:24]
        shor = tree_mod.ShorInfo(constraints_indexes=minors,
                                 SOC_constraints_indexes=shor_mod.shor_soc_complement(
                                     N, N, minors))
        nodes.append(tree_mod.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi,
                                     LB=-np.inf, depth=0, cuts=[], Shor_info=shor))
    rj = japi.matrix_completion_SDP_relaxation(nodes[0], N, 2, A, idx, 20.0,
                                               add_Shor_valid_inequalities=True)
    rt = tapi.matrix_completion_SDP_relaxation(nodes[1], N, 2, A, idx, 20.0,
                                               add_Shor_valid_inequalities=True, device="cpu")
    for key in ("lower_bound", "objective"):
        assert abs(rt[key] - rj[key]) <= 1e-8 * max(1.0, abs(rj[key])), key
    assert np.isfinite(rt["lower_bound"]) and rt["W"].shape == (N, N)
