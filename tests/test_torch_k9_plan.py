"""K9a and K9b on the CPU: the grids ``k9_plan`` picks at the shapes the
McCormick loop runs, torch mirrors of both kernels' order of work against
``omc``, and the wrappers' packed blocks and refusals.

K9a and K9b (``omc_torch/csrc/k9_mccormick.cu``) run on the GPU only;
``chip_smoke.py`` holds them against their plain versions there.  The
ownership test repeats the kernels' index arithmetic: K9a's B slot CTAs (the
rows' (U, t), Y's diagonal), then per slot the X chunks of 512 entries
(4 a thread) and the tile pairs (I <= J, row by row) of Theta's and Y's
16 x 16 tiles, thread x on column x % 16 of rows x // 16, x // 16 + 8;
K9b's B slot CTAs, then CTAs of ``qpc`` quads of 4 consecutive entries of
the batch's flat t1, t2, t3.  The mirrors repeat the kernels' order of work: the slot CTA's sums
(each thread's rows in order, xor shuffles, the warps in order), the trace
correction on Y's diagonal only, the tile-pair symmetrisation."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc.sdp.mccormick as J

from omc_torch import convert, kernels
from omc_torch.sdp import mccormick as P

torch.set_num_threads(2)

THREADS, TILE, CHUNK = P.K9_THREADS, P.K9_TILE, P.K9_X_CHUNK
WARPS, ROWS = THREADS // 32, THREADS // TILE
GAMMA = 20.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- k9_plan ----


def _tile_pair(p, T):
    """The kernel's tile_pair: pair p of a T x T grid -> (I, J), I <= J."""
    I = 0
    while p >= T - I:
        p -= T - I
        I += 1
    return I, I + p


def _pair_cover(cover, N, I, J, skip_diag=False):
    """Add the entries a tile-pair CTA writes (tile (I, J) and, for I < J,
    tile (J, I)) to ``cover`` (N x N)."""
    x = np.arange(THREADS)
    r = (x // TILE)[:, None] + ROWS * np.arange(TILE // ROWS)[None, :]
    col = np.broadcast_to((x % TILE)[:, None], r.shape)
    tiles = [(I, J)] if I == J else [(I, J), (J, I)]
    for a, b in tiles:
        i, j = a * TILE + r, b * TILE + col
        ok = (i < N) & (j < N)
        if skip_diag:
            ok &= i != j
        np.add.at(cover, (i[ok], j[ok]), 1)


def _quad_cover(ctas, qpc, per, B):
    """Each thread's quad of a flat kind of K9b's grid (``ctas`` CTAs from
    the kind's first, ``qpc`` quads a CTA) as a coverage count of the B
    ``per`` entries; checks each entry's slot as the kernel resolves it."""
    tot = B * per
    x = np.arange(ctas)[:, None]
    t = np.arange(THREADS)[None, :]
    q0 = 4 * (x * qpc + t)
    live = (t < qpc) & (q0 < tot)
    q0 = q0[live]
    cover = np.zeros(tot + 4, np.int64)
    b0 = q0 // per
    for c in range(4):
        e = q0 + c
        ok = e < tot
        np.add.at(cover, e[ok], 1)
        b = b0 + (e >= (b0 + 1) * per)
        assert np.array_equal(b[ok], e[ok] // per)
    return cover[:tot]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [50, 75])
@pytest.mark.parametrize("B", [1, 4, 16, 64])
def test_k9_plan_owns_every_entry_once(B, n, k):
    """Every entry of X, Theta, Y, U and t (K9a) and of t1, t2 and t3 (K9b)
    is written by exactly one thread of its kernel's grid; each slot has one
    slot CTA, first in the grid; K9b's flat CTAs fill the card where the
    batch allows."""
    m = n
    q = k * (k + 1) // 2
    p = P.k9_plan(B, n, m, k)
    assert p["threads"] == THREADS and p["slot_ctas"] == B
    units = p["units"]
    assert units == p["x_chunks"] + p["th_pairs"] + p["y_pairs"]
    assert p["k9a_grid"] == B + B * units
    X = np.zeros((B, n * m), np.int64)
    Th = np.zeros((B, m, m), np.int64)
    Y = np.zeros((B, n, n), np.int64)
    U = np.zeros((B, n, k), np.int64)
    t = np.zeros((B, n, q), np.int64)
    tid = np.arange(THREADS)
    for x in range(p["k9a_grid"]):
        if x < B:  # the slot CTA of slot x: a thread a row
            rows = np.concatenate([np.arange(r, n, THREADS) for r in tid])
            U[x, rows] += 1
            t[x, rows] += 1
            Y[x, rows, rows] += 1
            continue
        b, u = divmod(x - B, units)
        if u < p["x_chunks"]:
            e = (u * CHUNK + tid[:, None] + THREADS * np.arange(CHUNK // THREADS)[None, :]).ravel()
            np.add.at(X[b], e[e < n * m], 1)
            continue
        u -= p["x_chunks"]
        if u < p["th_pairs"]:
            _pair_cover(Th[b], m, *_tile_pair(u, -(-m // TILE)))
        else:
            _pair_cover(Y[b], n, *_tile_pair(u - p["th_pairs"], -(-n // TILE)), skip_diag=True)
    for a in (X, Th, Y, U, t):
        assert np.all(a == 1)
    # K9b: the slot CTAs, then the quads of t1, t2, t3 in that order
    qpc = p["qpc"]
    assert qpc in (32, 64, 128)
    flat = p["t1_ctas"] + p["t2_ctas"] + p["t3_ctas"]
    assert p["k9b_grid"] == B + flat
    assert qpc == 32 or flat >= P.K9B_TARGET_CTAS
    for ctas, d in ((p["t1_ctas"], n + m), (p["t2_ctas"], n + k), (p["t3_ctas"], n)):
        assert np.all(_quad_cover(ctas, qpc, d * d, B) == 1)


def test_k9_plan_refuses_ranks_and_shapes():
    """k = 0 and shapes no kernel takes are refused.  The unrolled kernels'
    old limits (k = 4, n + m = 4,097) are planned on the wide kernels."""
    for k in (0, 4):
        if k == 0:
            with pytest.raises(ValueError, match="k >= 1"):
                P.k9_plan(4, 50, 50, k)
        else:
            assert P.k9_wide(50, 50, k) and P.k9_plan(4, 50, 50, k)["path"] == "wide"
    for shape in ((0, 50, 50), (1, 1, 5), (1, 50, 0), (1, 2048, 2049)):
        if shape == (1, 2048, 2049):
            assert P.k9_wide(2048, 2049, 1) and P.k9_plan(*shape, 1)["path"] == "wide"
        else:
            with pytest.raises(ValueError, match="unsupported shape"):
                P.k9_plan(*shape, 1)
    p = P.k9_plan(1, 2, 1, 1)
    assert p["k9a_grid"] == 4 and p["k9b_grid"] == 4 and p["qpc"] == 32


def test_cta_sum_is_the_slot_ctas_order():
    """``cta_sum`` adds each thread's rows in order, then each warp's lanes
    by xor shuffles, then the warps in order: the same bits as a direct
    simulation of those steps, within float32 rounding of the exact sum."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 300, 3)), dtype=torch.float32)
    got = P.cta_sum(x)
    xs = x.numpy()
    for b in range(2):
        for f in range(3):
            part = np.zeros(THREADS, np.float32)
            for i in range(300):
                part[i % THREADS] = np.float32(part[i % THREADS] + xs[b, i, f])
            for o in (16, 8, 4, 2, 1):
                part = np.array([np.float32(part[ln] + part[(ln // 32) * 32 + ((ln % 32) ^ o)])
                                 for ln in range(THREADS)], np.float32)
            tot = np.float32(0.0)
            for w in range(WARPS):
                tot = np.float32(tot + part[32 * w])
            assert got[b, f].item() == tot
    assert _rel(got.numpy(), xs.astype(np.float64).sum(axis=1)) <= 1e-6


# ---- the McCormick setup ----


def _state(k, dtype, n=6, m=7, B=2, seed=0):
    """A random McCormick problem, boxes and state (omc's leaves), and the
    port's constants and state on the same inputs."""
    rng = np.random.default_rng(seed + 10 * k)
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.6).astype(np.float64)
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    st = J.init_mc_state(B, n, m, k, jnp.float64, sX=1.5, sT=1.2, rho=10.0)
    leaves = [np.asarray(x) for x in st]
    for i in range(21):  # w1 ... t
        x = rng.standard_normal(leaves[i].shape) * 0.3
        if x.ndim == 3 and x.shape[-1] == x.shape[-2]:
            x = 0.5 * (x + np.swapaxes(x, -1, -2))
        leaves[i] = x
    leaves[21] = rng.uniform(5.0, 15.0, B)
    leaves = [x.astype(dtype) for x in leaves]
    A, mask, lo, hi = (x.astype(dtype) for x in (A, mask, lo, hi))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tst = convert.mc_state_from_numpy(leaves, device="cpu", dtype=tdt)
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu", dtype=tdt)
    c = P.make_mc_consts(torch.as_tensor(A), torch.as_tensor(mask), batch, tst, n, m, k, GAMMA,
                         1.6, tdt)
    return (A, mask, lo, hi, leaves), (c, tst)


@pytest.fixture(scope="module", params=[(d, k) for d in ("float64", "float32") for k in (1, 2, 3)],
                ids=lambda v: f"{v[0]}-k{v[1]}")
def one_iter(request):
    """One iteration of omc's McCormick solver (its returned X, Y, Theta,
    U, t are that iteration's z-step; its non-PSD slots, and w + u of its
    PSD slots, its cone step at that z-step) and the port's constants and
    state on the same inputs."""
    dtype, k = request.param
    np_dt = np.float64 if dtype == "float64" else np.float32
    (A, mask, lo, hi, leaves), (c, st) = _state(k, np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    sj = J.make_mccormick_solver(6, 7, k, GAMMA, iters=1, dtype=jdt)
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), J.MCBatch(jnp.asarray(lo), jnp.asarray(hi)),
               5.0, J.MCState(*[jnp.asarray(x) for x in leaves]))
    return dtype, k, fj, (c, st)


@pytest.mark.parametrize("tile", [None, 4, 2])
def test_k9a_mirror_matches_omc_zstep(one_iter, tile):
    """K9a's order of work (the slot CTA's fixed-order sums, the trace
    correction on Y's diagonal only, the tile-pair symmetrisation) on omc's
    inputs: within 1e-12 of omc's z-step in float64 and within K9a's bar,
    1e-5, in float32, at the plan's 16 x 16 tiles and at tiles small
    enough that a 6 x 7 slot has several pairs; every entry written; the
    input state untouched."""
    dtype, k, fj, (c, st) = one_iter
    plan = P.k9_plan(2, 6, 7, k)
    if tile is not None:
        plan = dict(plan, tile=tile)
    before = [x.clone() for x in st.leaves()]
    got = P.mc_zstep_tiled(c, st, plan)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for name, a, b in zip(("X", "Y", "Th", "U", "t"), got, (fj.X, fj.Y, fj.Th, fj.U, fj.t)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a.numpy(), np.asarray(b)) <= tol, name
    # Y and Theta exactly symmetric, as the pairs write them
    assert torch.equal(got[1], got[1].transpose(-1, -2))
    assert torch.equal(got[2], got[2].transpose(-1, -2))
    for a, b in zip(got, P.mc_zstep_plain(c, st)):
        assert _rel(a.numpy(), b.numpy()) <= tol
    assert all(torch.equal(x, y) for x, y in zip(st.leaves(), before))


def test_k9b_mirror_matches_omc_cone_step(one_iter):
    """K9b's order of work (tr Y, the SOC column norms and sum_i t in the
    slot CTA's order) at omc's z-step: within 1e-12 of omc's cone step in
    float64 and within 1e-5 in float32 (t1-t3 against omc's w + u of the
    PSD slots); the running means as omc's loop forms them."""
    dtype, k, fj, (c, st) = one_iter
    for name in ("X", "Y", "Th", "U", "t"):
        getattr(st, name).copy_(torch.as_tensor(np.array(getattr(fj, name))))
    acc = [0.5 * torch.ones_like(st.umc), 0.25 * torch.ones_like(st.uorth)]
    beta = 0.4
    t1, t2, t3, rest, acc_new = P.mc_cone_step_tiled(c, st, acc, beta, P.k9_plan(2, 6, 7, k))
    tol = 1e-12 if dtype == "float64" else 1e-5
    for a, w, u in zip((t1, t2, t3), (fj.w1, fj.w2, fj.w3), (fj.u1, fj.u2, fj.u3)):
        assert _rel(a.numpy(), np.asarray(w) + np.asarray(u)) <= tol
    for name, a in zip(P._REST, rest):
        b = np.asarray(getattr(fj, name))
        assert _rel(a.numpy(), b) <= tol or np.abs(b).max() == 0 == a.abs().max(), name
    rho = st.rho.numpy()
    for a, u, a0 in zip(acc_new, (fj.umc, fj.uorth), (0.5, 0.25)):
        u = np.asarray(u)
        want = a0 + beta * (rho.reshape((-1,) + (1,) * (u.ndim - 1)) * u - a0)
        assert _rel(a.numpy(), want) <= tol
    plain = P.mc_cone_step_plain(c, st, acc, beta)
    for a, b in zip((t1, t2, t3) + tuple(rest) + tuple(acc_new),
                    plain[:3] + tuple(plain[3]) + tuple(plain[4])):
        assert _rel(a.numpy(), b.numpy()) <= tol or float(b.abs().max()) == 0 == float(
            a.abs().max())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_mirrors_match_plain_at_several_tiles(k):
    """At n = 40, m = 36 (ragged 16 x 16 tiles, six Y and six Theta
    pairs) and n = 150 > 128 (a slot CTA thread with two rows), the mirrors
    in float64 against the plain versions within 1e-12."""
    for n, m in ((40, 36), (150, 9)):
        _, (c, st) = _state(k, np.float64, n=n, m=m, seed=5)
        plan = P.k9_plan(2, n, m, k)
        for a, b in zip(P.mc_zstep_tiled(c, st, plan), P.mc_zstep_plain(c, st)):
            assert bool(torch.isfinite(a).all())
            assert _rel(a.numpy(), b.numpy()) <= 1e-12
        got = P.mc_cone_step_tiled(c, st, None, 0.0, plan)
        ref = P.mc_cone_step_plain(c, st, None, 0.0)
        for a, b in zip(got[:3] + tuple(got[3]), ref[:3] + tuple(ref[3])):
            assert _rel(a.numpy(), b.numpy()) <= 1e-12 or float(b.abs().max()) == 0 == float(
                a.abs().max())


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


def test_k9a_block_packed_once_and_for_the_same_operands():
    """K9a's packed parameter block points at every operand, is reused for
    the same tensors and packed anew for another; a wrong dtype, a wrong
    shape and an unsupported rank are refused."""
    _, (c, st) = _state(2, np.float32)
    cpu = torch.device("cpu")
    p = P._k9a_params(c, st, cpu)
    ops = P._k9a_operands(c, st)
    for name, t, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert sorted(_pointers(p)) == sorted(t.data_ptr() for _, t, _ in ops)
    assert sorted(map(id, P._k9a_tensors(c, st))) == sorted(id(t) for _, t, _ in ops)
    assert (p.B, p.n, p.m, p.k) == (2, 6, 7, 2)
    assert p.gamma == pytest.approx(GAMMA)
    assert P._k9a_params(c, st, cpu) is p
    st.t = st.t.clone()
    q = P._k9a_params(c, st, cpu)
    assert q is not p and q.t == st.t.data_ptr()
    st.Y = st.Y.double()
    with pytest.raises(TypeError):
        P._k9a_params(c, st, cpu)
    st.Y = st.Y.float()[:, :, :5]
    with pytest.raises(ValueError, match="shape"):
        P._k9a_params(c, st, cpu)
    # k = 4 packs (the wide kernels' plan); k = 0 is refused
    _, (c4, st4) = _state(4, np.float32)
    assert P._k9a_params(c4, st4, cpu).k == 4 and P.k9_plan(2, 6, 7, 4)["path"] == "wide"
    with pytest.raises(ValueError, match="k >= 1"):
        P._k9a_params(dataclasses.replace(c4, k=0), st4, cpu)


def test_k9b_block_packed_once_and_for_the_same_operands():
    """K9b's packed parameter block points at every operand (the running
    means only when given), carries its plan's quads a CTA, is reused for
    the same tensors with each call's beta and packed anew for another; a
    wrong dtype, an unsupported rank and operands it moves as 16-byte words
    that are not 16-byte aligned are refused."""
    _, (c, st) = _state(1, np.float32)
    cpu = torch.device("cpu")
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    acc = [torch.ones_like(st.umc), torch.ones_like(st.uorth)]
    p = P._k9b_params(c, st, ts, acc, 0.5, cpu)
    ops = P._k9b_operands(c, st, ts, acc)
    for name, t, _ in ops:
        assert getattr(p, name) == t.data_ptr(), name
    assert sorted(_pointers(p)) == sorted(t.data_ptr() for _, t, _ in ops)
    assert sorted(map(id, P._k9b_tensors(c, st, ts, acc))) == sorted(id(t) for _, t, _ in ops)
    assert (p.B, p.n, p.m, p.k) == (2, 6, 7, 1)
    assert p.qpc == P.k9_plan(2, 6, 7, 1)["qpc"]
    assert p.alpha == pytest.approx(1.6) and p.beta == pytest.approx(0.5)
    again = P._k9b_params(c, st, ts, acc, 0.25, cpu)
    assert again is p and p.beta == pytest.approx(0.25)
    bare = P._k9b_params(c, st, ts, None, 0.0, cpu)
    assert bare is not p and bare.acc_mc is None and bare.acc_orth is None
    acc2 = [acc[0], acc[1].clone()]
    q = P._k9b_params(c, st, ts, acc2, 0.5, cpu)
    assert q is not p and q.acc_orth == acc2[1].data_ptr()
    with pytest.raises(TypeError):
        P._k9b_params(c, st, ts, [acc[0].double(), acc[1]], 0.5, cpu)
    with pytest.raises(ValueError, match="16-byte"):
        P._k9b_params(c, st, (_shifted(ts[0]),) + ts[1:], acc, 0.5, cpu)
    st.u2 = _shifted(st.u2)
    with pytest.raises(ValueError, match="16-byte"):
        P._k9b_params(c, st, ts, acc, 0.5, cpu)
    _, (c4, st4) = _state(4, np.float32)
    ts4 = tuple(torch.empty_like(x) for x in (st4.w1, st4.w2, st4.w3))
    p4 = P._k9b_params(c4, st4, ts4, None, 0.0, cpu)
    assert p4.k == 4 and p4.qpc == P.k9_plan(2, 6, 7, 4)["qpc"]
    with pytest.raises(ValueError, match="k >= 1"):
        P._k9b_params(dataclasses.replace(c4, k=0), st4, ts4, None, 0.0, cpu)


def test_cuda_state_takes_no_plain_version(monkeypatch):
    """On a CUDA-typed state K9a's and K9b's wrappers launch their kernels
    or raise: no plain version runs (here, without a GPU, they raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    monkeypatch.setattr(P, "mc_zstep_plain", plain)
    monkeypatch.setattr(P, "mc_cone_step_plain", plain)
    _, state = _state(1, np.float32)
    c, st = (_fake_cuda(x) for x in state)
    with pytest.raises(RuntimeError):
        P.mc_zstep(c, st)
    ts = tuple(_fake_cuda(torch.empty_like(x)) for x in (st.w1, st.w2, st.w3))
    with pytest.raises(RuntimeError):
        P.mc_cone_step(c, st, ts, [_fake_cuda(torch.ones_like(st.umc)),
                                   _fake_cuda(torch.ones_like(st.uorth))], 0.5)
    with pytest.raises(RuntimeError):
        P.mc_cone_step(c, st, ts)
