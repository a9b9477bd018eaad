"""The CPU side of the McCormick family in float64 on the card (the float64
builds of K9s, K9a and K9b beside those of K4, K5 and K6).

The kernels run on the GPU only (``chip_smoke.py`` holds each float64 build
against its plain version there).  Here: (a) the dtype-aware plans of K9s,
K9a and K9b at every shape of B in {1, 4, 16, 64} x n = m in {12, 50, 75,
128, 160, 250} x k in {1, 2, 3}, against recounts of the kernels' layouts
at 8 bytes a value: every entry owned once (K9b's 16-byte pairs, K9a's X
chunks and tile pairs), K9s's staging within a CTA's shared memory at its
narrowed thread count, K9a's slot staging refused beyond it, the tiles'
transposed reads free of bank conflicts, and the float32 plans those of
before; (b) the float64 mirrors of the kernels' order of work at the
float64 plans' widths against the plain versions and against one iteration
of ``omc``'s float64 McCormick solver on its eigh route; (c) the wrappers: a
float64 state packs the float64 blocks, takes the ``..._f64`` entry points
and counts its launches under their keys, K9s's buffer is float64, and the
solver's CUDA guard asks "eigh" of float64 and "ns" of float32; (d) the
api's McCormick relaxation at its defaults (float64) on the CPU against
``omc``'s."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc.api as japi
import omc.sdp.mccormick as J
import omc.tree as jtree
from omc.data import generate_matrix_completion_data

import omc_torch.api as tapi
import omc_torch.tree as ttree
from omc_torch import convert, kernels
from omc_torch.sdp import mccormick as P

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
SMEM = 232448  # the most shared memory one CTA may use on an H100
THREADS, TILE, CHUNK = 128, 16, 512  # K9a's and K9b's CTA, tile side, X chunk
SHAPES = [(B, n, k) for B in (1, 4, 16, 64) for n in (12, 50, 75, 128, 160, 250)
          for k in (1, 2, 3)]
GAMMA = 20.0


def _cdiv(a, b):
    return -(-a // b)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- (a) the plans against recounts of the kernels' layouts ----


def _k9s_plan_before(B, n, k):
    """k9s_plan as it was before its float64 build (float32 only)."""
    q = k * (k + 1) // 2
    kq = k + q
    threads = min(256, max(128, 32 * _cdiv(n, 32)))
    floats = (4 + threads * kq * kq) + (4 + threads * kq * q) + (threads // 32) * (q * (q + 1) // 2)
    return dict(threads=threads, chunks=_cdiv(n, threads), smem_bytes=4 * floats)


def _k9_plan_before(B, n, m, k):
    """k9_plan as it was before its float64 build (float32 only)."""
    tn, tm = _cdiv(n, TILE), _cdiv(m, TILE)
    x, th, y = _cdiv(n * m, CHUNK), tm * (tm + 1) // 2, tn * (tn + 1) // 2
    units = x + th + y
    quads = (_cdiv(B * (n + m) ** 2, 4), _cdiv(B * (n + k) ** 2, 4), _cdiv(B * n * n, 4))
    qpc = THREADS
    while qpc > 32 and sum(_cdiv(x_, qpc) for x_ in quads) < P.K9B_TARGET_CTAS:
        qpc //= 2
    t1, t2, t3 = (_cdiv(x_, qpc) for x_ in quads)
    return dict(threads=THREADS, tile=TILE, x_chunk=CHUNK, slot_ctas=B, x_chunks=x,
                th_pairs=th, y_pairs=y, units=units, k9a_grid=B + B * units, qpc=qpc,
                t1_ctas=t1, t2_ctas=t2, t3_ctas=t3, k9b_grid=B + t1 + t2 + t3)


def _k9s_staging_bytes(T, k, elem):
    """K9s's dynamic shared memory as the kernel lays it out for a CTA of T
    threads at elem bytes a value: Mc's chunk and Si's chunk, each after one
    16-byte word of alignment slack, then each warp's partials of G's lower
    triangle; and the byte offsets of the second and third areas."""
    q = k * (k + 1) // 2
    kq, slack = k + q, 16 // elem
    mc = slack + T * kq * kq
    si = slack + T * kq * q
    return elem * (mc + si + (T // 32) * (q * (q + 1) // 2)), elem * mc, elem * (mc + si)


def _tile_pair(p, T):
    """The kernel's tile_pair: pair p of a T x T grid -> (I, J), I <= J."""
    I = 0
    while p >= T - I:
        p -= T - I
        I += 1
    return I, I + p


@functools.lru_cache(maxsize=None)
def _k9a_cover(n, m):
    """How many times K9a's CTAs of one slot write each entry of X, Theta and
    Y (the slot CTA: Y's diagonal, a thread a row; the X chunks: thread x on
    entries 512 u + x + 128 i; the tile pairs: thread x on column x % 16 of
    rows x // 16 and x // 16 + 8 of both tiles of pair (I, J)), counted over
    the plan's units."""
    p = P.k9_plan(1, n, m, 1, F64)
    tid = np.arange(THREADS)
    e = (np.arange(p["x_chunks"])[:, None, None] * CHUNK + tid[None, :, None]
         + THREADS * np.arange(CHUNK // THREADS)[None, None, :]).ravel()
    X = np.bincount(e[e < n * m], minlength=n * m)  # the kernel guards e < n m
    r = (tid // TILE)[:, None] + (THREADS // TILE) * np.arange(TILE // (THREADS // TILE))[None]
    col = np.broadcast_to((tid % TILE)[:, None], r.shape)

    def pairs(N, count, skip_diag):
        T = _cdiv(N, TILE)
        cover = np.zeros((N, N), np.int64)
        for u in range(count):
            I, J = _tile_pair(u, T)
            for a, b in ([(I, J)] if I == J else [(I, J), (J, I)]):
                i, j = a * TILE + r, b * TILE + col
                ok = (i < N) & (j < N) & ~((i == j) & skip_diag)
                np.add.at(cover, (i[ok], j[ok]), 1)
        return cover

    Y = pairs(n, p["y_pairs"], True)
    Y[np.arange(n), np.arange(n)] += 1  # the slot CTA
    return X, pairs(m, p["th_pairs"], False), Y


@pytest.mark.parametrize("B,n,k", SHAPES)
def test_k9_plans_float64_own_every_entry_once(B, n, k):
    """At 8 bytes a value: K9s's CTA narrows by warps until a chunk's staging
    fits a CTA's shared memory, its areas start 16-byte aligned; K9a's X
    chunks and tile pairs write every entry of X, Theta and Y once, its slot
    staging n (k + q + 1) doubles fits; K9b's flat CTAs take 16-byte pairs
    of doubles, each entry of t1, t2, t3 in one pair, no CTA idle, a pair
    resolving its slot at the boundaries the way the kernel does; the
    float32 plans are those of before."""
    m, q = n, k * (k + 1) // 2
    # K9s
    s64 = P.k9s_plan(B, n, k, F64)
    T = s64["threads"]
    nbytes, off_si, off_red = _k9s_staging_bytes(T, k, 8)
    assert s64["smem_bytes"] == nbytes <= SMEM
    t32 = min(256, max(128, 32 * _cdiv(n, 32)))  # the float32 CTA
    assert T % 32 == 0 and 128 <= T <= t32
    assert T == t32 or _k9s_staging_bytes(T + 32, k, 8)[0] > SMEM  # the widest that fits
    assert off_si % 16 == 0 and off_red % 16 == 0
    assert s64["chunks"] == _cdiv(n, T) and (s64["chunks"] - 1) * T < n
    assert P.k9s_plan(B, n, k) == _k9s_plan_before(B, n, k)
    # K9a
    p = P.k9_plan(B, n, m, k, F64)
    assert 8 * n * (k + q + 1) <= SMEM
    assert p["units"] == p["x_chunks"] + p["th_pairs"] + p["y_pairs"]
    assert p["k9a_grid"] == B + B * p["units"]
    X, Th, Y = _k9a_cover(n, m)
    assert np.all(X == 1)
    assert (p["x_chunks"] - 1) * CHUNK < n * m  # no chunk idle
    assert np.all(Th == 1) and np.all(Y == 1)
    # K9b: pairs of doubles, qpc pairs a CTA
    E = 2
    assert p["qpc"] in (32, 64, 128)
    flat = p["t1_ctas"] + p["t2_ctas"] + p["t3_ctas"]
    assert p["k9b_grid"] == B + flat
    assert p["qpc"] == 32 or flat >= P.K9B_TARGET_CTAS
    for ctas, d in ((p["t1_ctas"], n + m), (p["t2_ctas"], n + k), (p["t3_ctas"], n)):
        DD, tot = d * d, B * d * d
        # pair w (thread w % qpc of CTA w // qpc) holds entries E w .. E w + 1:
        # every entry lies in one pair of a live thread, no CTA is idle
        assert E * p["qpc"] * ctas >= tot > E * p["qpc"] * (ctas - 1)
        # a pair's entries at each slot boundary resolve their slot as the
        # kernel does: b = b0 + (e >= (b0 + 1) DD) for b0 the pair's first
        q0 = E * (np.arange(1, B) * DD // E)
        for c in range(E):
            e = q0 + c
            b0 = q0 // DD
            assert np.array_equal((b0 + (e >= (b0 + 1) * DD))[e < tot], (e // DD)[e < tot])
        if tot <= 200_000:  # the whole count where it is cheap
            w = np.arange(ctas * p["qpc"])
            ent = (E * w[:, None] + np.arange(E)[None]).ravel()
            cover = np.bincount(ent[ent < tot], minlength=tot)
            assert np.all(cover == 1)
    assert P.k9_plan(B, n, m, k) == _k9_plan_before(B, n, m, k)


def test_k9_plan_float64_refuses_a_slot_staging_past_shared_memory():
    """K9a's unrolled slot CTA stages z0 and Y's diagonal, n (k + q + 1)
    values: in float64 at k = 3 that passes 227 KB above n = 2,905 (n + m <=
    4096 lets n reach 4,095); float32 never does.  The unrolled kernels
    refuse it, so the plan takes the wide kernels there."""
    assert not P.k9_wide(2905, 1191, 3, F64) and "path" not in P.k9_plan(1, 2905, 1191, 3, F64)
    for n, m in ((2906, 1190), (4095, 1)):
        assert P.k9_wide(n, m, 3, F64) and P.k9_plan(4, n, m, 3, F64)["path"] == "wide"
    assert not P.k9_wide(4095, 1, 3) and "path" not in P.k9_plan(4, 4095, 1, 3)
    assert not P.k9_wide(4095, 1, 2, F64) and "path" not in P.k9_plan(4, 4095, 1, 2, F64)


@pytest.mark.parametrize("k,n,threads", [(3, 193, 192), (3, 250, 192), (3, 192, 192),
                                         (3, 160, 160), (2, 250, 256), (1, 1000, 256)])
def test_k9s_plan_float64_narrows_only_where_its_staging_must(k, n, threads):
    """K9s's float64 CTA: k = 3 stores 135 doubles a row, so 256 threads'
    staging (277,856 bytes) passes 227 KB and 192 threads' (208,400) fits;
    k <= 2 keeps the float32 CTA."""
    plan = P.k9s_plan(4, n, k, F64)
    assert plan["threads"] == threads
    assert plan["smem_bytes"] == _k9s_staging_bytes(threads, k, 8)[0] <= SMEM
    assert _k9s_staging_bytes(256, 3, 8)[0] == 277_856 > SMEM
    assert _k9s_staging_bytes(192, 3, 8)[0] == 208_400


@pytest.mark.parametrize("elem", [4, 8])
def test_k9a_tiles_read_transposed_without_bank_conflicts(elem):
    """K9a's 16 x 16 tiles sit in shared memory at a row stride of 17
    values.  A half-warp (16 consecutive threads: one tile row r, columns 0
    to 15) writes sA[r][col] and reads tB[col][r]; a float is one 4-byte
    bank, a double two consecutive ones.  Either access of either type
    touches 16 values in 16 disjoint banks (or bank pairs)."""
    words = elem // 4
    for r in range(TILE):
        for index in (lambda col: r * (TILE + 1) + col, lambda col: col * (TILE + 1) + r):
            banks = [(index(col) * words + h) % 32 for col in range(TILE) for h in range(words)]
            assert len(set(banks)) == len(banks) == TILE * words


# ---- (b) the float64 mirrors against the plain versions and omc ----


def _state(k, n=6, m=7, B=2, seed=0):
    """A random float64 McCormick problem, boxes and state (omc's leaves),
    and the port's constants and state on the same inputs."""
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
    tst = convert.mc_state_from_numpy(leaves, device="cpu", dtype=F64)
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu", dtype=F64)
    c = P.make_mc_consts(torch.as_tensor(A), torch.as_tensor(mask), batch, tst, n, m, k, GAMMA,
                         1.6, F64)
    return (A, mask, lo, hi, leaves), (c, tst)


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda k: f"k{k}")
def omc_iter(request):
    """One iteration of omc's float64 McCormick solver (psd_method "auto":
    its eigh route; its returned X, Y, Theta, U, t are the z-step, its
    non-PSD slots and w + u of its PSD slots the cone step at that z-step)
    and the port's constants and state on the same inputs."""
    k = request.param
    (A, mask, lo, hi, leaves), (c, st) = _state(k)
    sj = J.make_mccormick_solver(6, 7, k, GAMMA, iters=1, dtype=jnp.float64)
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), J.MCBatch(jnp.asarray(lo), jnp.asarray(hi)),
               5.0, J.MCState(*[jnp.asarray(x) for x in leaves]))
    return k, fj, (c, st)


def test_float64_mirrors_match_omc_iteration(omc_iter):
    """The mirrors of K9a's and K9b's order of work at the float64 plan's
    widths (the slot CTA's fixed-order sums, the tile pairs) against one
    float64 iteration of omc's McCormick solver on its eigh route at 1e-12,
    and against the plain versions; K9s's mirror at its float64 CTA against
    omc's factors."""
    k, fj, (c, st) = omc_iter
    plan = P.k9_plan(2, 6, 7, k, F64)
    zs = P.mc_zstep_tiled(c, st, plan)
    for name, a, b in zip(("X", "Y", "Th", "U", "t"), zs, (fj.X, fj.Y, fj.Th, fj.U, fj.t)):
        assert a.dtype == F64 and _rel(a.numpy(), np.asarray(b)) <= 1e-12, name
    for a, b in zip(zs, P.mc_zstep_plain(c, st)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-12
    for name, z in zip(("X", "Y", "Th", "U", "t"), zs):
        getattr(st, name).copy_(z)
    t1, t2, t3, rest, _ = P.mc_cone_step_tiled(c, st, None, 0.0, plan)
    for a, w, u in zip((t1, t2, t3), (fj.w1, fj.w2, fj.w3), (fj.u1, fj.u2, fj.u3)):
        assert _rel(a.numpy(), np.asarray(w) + np.asarray(u)) <= 1e-12
    for name, a in zip(P._REST, rest):
        b = np.asarray(getattr(fj, name))
        assert _rel(a.numpy(), b) <= 1e-12 or np.abs(b).max() == 0 == a.abs().max(), name
    threads = P.k9s_plan(2, 6, k, F64)["threads"]
    for a, b in zip(P.mc_setup_structured(c.batch, k, threads), P.mc_setup_plain(c.batch, k)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-12


@pytest.mark.parametrize("k,n", [(3, 200), (3, 250), (2, 160)])
def test_float64_setup_mirror_at_the_narrowed_cta(k, n):
    """K9s's order of work at its float64 CTA (k = 3, n = 200 and 250: 192
    threads, rows in chunks of 192, G summed over those threads' rows)
    against the plain version and omc's factorisation (numpy, from omc's
    envelope coefficients) at 1e-12, Mc Mc' against the row Grams."""
    rng = np.random.default_rng(n + k)
    B = 2
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    hi = np.where(rng.random((B, n, k)) < 0.2, lo, hi)  # degenerate rows, as deep nodes
    batch = P.MCBatch(torch.as_tensor(lo), torch.as_tensor(hi))
    threads = P.k9s_plan(B, n, k, F64)["threads"]
    assert threads == (192 if k == 3 else min(256, 32 * _cdiv(n, 32)))
    got = P.mc_setup_structured(batch, k, threads)
    for a, b in zip(got, P.mc_setup_plain(batch, k)):
        assert a.dtype == F64 and np.max(np.abs(a.numpy() - b.numpy())) <= 1e-12
    q = k * (k + 1) // 2
    J1, J2 = J.pair_indices(k)
    s, c1, c2, _ = J.mccormick_coeffs(lo, hi, J1, J2, xp=np)
    eye_k = np.eye(k)
    R = np.concatenate([c1[..., None] * eye_k[J1] + c2[..., None] * eye_k[J2],
                        s[..., None] * np.eye(q)], axis=-1)
    R = np.swapaxes(R, 1, 2).reshape(B, n, 4 * q, k + q)
    M = np.einsum("bnrc,bnrd->bncd", R, R) + np.diag(np.r_[4.0 * np.ones(k), np.zeros(q)])
    M = M + 1e-9 * np.eye(k + q)
    Si = np.linalg.solve(M, np.broadcast_to(np.concatenate([np.zeros((k, q)), np.eye(q)]),
                                            (B, n, k + q, q)))
    Gc = np.linalg.cholesky(np.eye(q) + Si[..., k:, :].sum(1))
    for a, b in zip(got, (np.linalg.cholesky(M), Si, Gc)):
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12
    L = got[0].numpy()
    assert np.max(np.abs(L @ np.swapaxes(L, -1, -2) - M)) <= 1e-12 * max(1.0, np.abs(M).max())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_float64_mirrors_match_plain_at_several_tiles(k):
    """At n = 40, m = 36 (ragged 16 x 16 tiles, six Y and six Theta pairs)
    and n = 150 > 128 (a slot CTA thread with two rows), the float64 plan's
    mirrors against the plain versions within 1e-12."""
    for n, m in ((40, 36), (150, 9)):
        _, (c, st) = _state(k, n=n, m=m, seed=5)
        plan = P.k9_plan(2, n, m, k, F64)
        for a, b in zip(P.mc_zstep_tiled(c, st, plan), P.mc_zstep_plain(c, st)):
            assert _rel(a.numpy(), b.numpy()) <= 1e-12
        got = P.mc_cone_step_tiled(c, st, None, 0.0, plan)
        ref = P.mc_cone_step_plain(c, st, None, 0.0)
        for a, b in zip(got[:3] + tuple(got[3]), ref[:3] + tuple(ref[3])):
            assert _rel(a.numpy(), b.numpy()) <= 1e-12 or float(b.abs().max()) == 0 == float(
                a.abs().max())


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
    call (entry point, block), so that ``kernels.launch`` runs and counts;
    K9s's output buffer allocated on the CPU (recording its dtype)."""
    calls, buffers = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda prm, stream: calls.append((name, prm._obj)) or 0

    real_buffer = P.mc_setup_buffer

    def buffer(B, n, k, device, dtype=F32):
        buf = real_buffer(B, n, k, "cpu", dtype)
        buffers.append(buf)
        return buf.as_subclass(_FakeCuda)

    monkeypatch.setattr(kernels, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(P, "mc_setup_buffer", buffer)
    return calls, buffers


def test_float64_state_launches_the_float64_builds(fake_lib):
    """A float64 CUDA-typed batch and state at k = 3 pack the float64 blocks
    of K9s, K9a and K9b (double gamma, alpha and beta), point them at the
    float64 operands (K9s at the three views of one float64 buffer), call
    the ..._f64 entry points with the float64 plan (K9b's pairs a CTA), and
    count the launches under K9s_f64, K9a_f64 and K9b_f64 (the float32 keys
    untouched)."""
    calls, buffers = fake_lib
    _, (c, st) = _state(3, n=9, m=10)
    c, st = _fake_cuda(c), _fake_cuda(st)
    ts = tuple(_fake_cuda(torch.empty_like(x)) for x in (st.w1, st.w2, st.w3))
    acc = [_fake_cuda(torch.zeros_like(x)) for x in (st.umc, st.uorth)]
    before = dict(kernels.LAUNCHES)
    views = P.mc_setup(c.batch, 3)
    P.mc_zstep(c, st)
    P.mc_cone_step(c, st, ts, acc, 0.25)
    (fs, ps), (fa, pa), (fb, pb) = calls
    assert (fs, fa, fb) == ("omc_k9s_setup_f64", "omc_k9a_zstep_f64", "omc_k9b_cone_f64")
    assert isinstance(ps, kernels.K9sParams64) and isinstance(pa, kernels.K9aParams64)
    assert isinstance(pb, kernels.K9bParams64)
    got = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    assert all(got[key] == 1 for key in ("K9s_f64", "K9a_f64", "K9b_f64"))
    assert sum(got.values()) == 3
    # K9s: one float64 buffer, its three views float64
    (buf,) = buffers
    assert buf.dtype == F64 and all(v.dtype == F64 for v in views)
    assert (ps.Mc, ps.Si, ps.Gc) == tuple(v.data_ptr() for v in views)
    assert (ps.U_lo, ps.B, ps.n, ps.k) == (c.batch.U_lo.data_ptr(), 2, 9, 3)
    # K9a and K9b: the float64 operands, double scalars, the float64 plan
    assert (pa.Mc, pa.Xs, pa.t) == (c.Mc.data_ptr(), st.X.data_ptr(), st.t.data_ptr())
    assert (pb.t1, pb.acc_mc, pb.U) == (ts[0].data_ptr(), acc[0].data_ptr(), st.U.data_ptr())
    assert (pa.gamma, pb.alpha, pb.beta) == (GAMMA, 1.6, 0.25)
    assert dict(pa._fields_)["gamma"] is kernels.ctypes.c_double
    assert pb.qpc == P.k9_plan(2, 9, 10, 3, F64)["qpc"]


def test_float64_blocks_refuse_a_float32_operand(fake_lib):
    """A float64 state with one float32 operand is refused before any
    launch (every operand is checked at the state's dtype)."""
    calls, _ = fake_lib
    _, (c, st) = _state(1)
    st.Y = st.Y.float()
    with pytest.raises(TypeError):
        P.mc_zstep(_fake_cuda(c), _fake_cuda(st))
    _, (c, st) = _state(2)
    acc = [torch.zeros_like(st.umc), torch.zeros_like(st.uorth).float()]
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    with pytest.raises(TypeError):
        P.mc_cone_step(_fake_cuda(c), _fake_cuda(st), _fake_cuda(ts), _fake_cuda(acc), 0.5)
    assert not calls


class _State:
    """Just what the solver's guard reads: a CUDA-typed rho."""

    def __init__(self, dtype):
        self.rho = torch.ones(1, dtype=dtype).as_subclass(_FakeCuda)


class _PastGuard(Exception):
    pass


@pytest.mark.parametrize("dtype,method,ok", [(F64, "eigh", True), (F64, "ns", False),
                                             (F32, "ns", True), (F32, "eigh", False)])
def test_cuda_guard_asks_eigh_of_float64_and_ns_of_float32(dtype, method, ok, monkeypatch):
    """On CUDA the McCormick solver projects float64 exactly ("eigh": K4's
    float64 build and the torch epilogue) and float32 by the sign schedule
    ("ns": K1); the other pairings raise before any work (a solve past the
    guard reaches its first tensor, here a sentinel)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    solve = P.make_mccormick_solver(6, 6, 1, 20.0, dtype=dtype, psd_method=method)

    def sentinel(*a, **kw):
        raise _PastGuard

    monkeypatch.setattr(torch, "as_tensor", sentinel)
    with pytest.raises(_PastGuard if ok else ValueError):
        solve(None, None, None, None, _State(dtype))
    auto = P.make_mccormick_solver(6, 6, 1, 20.0, dtype=dtype)  # "auto": the build's method
    with pytest.raises(_PastGuard):
        auto(None, None, None, None, _State(dtype))


# ---- (d) the api's McCormick relaxation at its defaults ----


@pytest.mark.parametrize("k,n,seed", [(1, 8, 3), (2, 8, 4)])
def test_mccormick_relaxation_at_the_defaults_matches_omc(k, n, seed):
    """api.matrix_completion_SDP_relaxation(..., use_disjunctive_cuts=False)
    with no dtype (float64) and its default 2,000 iterations on the root of
    an n x n rank-k instance, on the CPU, against omc's: bound and objective
    within 1e-8 relative (float64's rounding, summed in two orders over
    2,000 nonexpansive steps), Y within 1e-8 relative."""
    A, idx = generate_matrix_completion_data(k, n, n, n * n // 2, seed)
    lo, hi = ttree.root_box(n, k)
    nodes = [mod.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0,
                        cuts=None) for mod in (jtree, ttree)]
    rj = japi.matrix_completion_SDP_relaxation(nodes[0], n, k, A, idx, 20.0,
                                               use_disjunctive_cuts=False)
    rt = tapi.matrix_completion_SDP_relaxation(nodes[1], n, k, A, idx, 20.0,
                                               use_disjunctive_cuts=False, device="cpu")
    for key in ("lower_bound", "objective"):
        assert abs(rt[key] - rj[key]) <= 1e-8 * max(1.0, abs(rj[key])), key
    assert np.isfinite(rt["lower_bound"])
    assert _rel(rt["Y"], np.asarray(rj["Y"])) <= 1e-8
