"""Every rank ``omc`` runs through altmin and McCormick, on the CPU: the
plain ridge steps and altmin at k > 10 and the McCormick steps at k = 4, 5
against ``omc`` in float64; the plans of K6's wide path and of K9s's, K9a's
and K9b's wide kernels (``omc_torch/csrc/k6_altmin.cu``,
``csrc/k9_mccormick.cu``) owning every output once, their shared memory
against the kernels' formulas, the plans at the old ranks unchanged; a numpy
mirror of the wide kernels' exact (i, j) split of the flat entries; and the
CUDA shape gate, which admits rank-k Shor at every rank and McCormick past
2^31 flat entries (the driver and the api go on to the card).  The wide
kernels themselves run on the GPU only: ``chip_smoke.py``'s ``widerank``
phase holds them against their plain versions there (``mcflat`` past 2^31
flat entries)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc.sdp.mccormick as J
from omc import altmin as jaltmin
from omc.ops import linalg as jlinalg
from omc.tree import root_box

import omc_torch.api as tapi
from omc_torch import altmin as taltmin
from omc_torch import convert, kernels
from omc_torch.data import generate_matrix_completion_data
from omc_torch.ops import linalg as tlinalg
from omc_torch.sdp import mccormick as P

torch.set_num_threads(2)

F64 = torch.float64
SMEM = 232448


def _tri(a):
    return a * (a + 1) // 2


def _cdiv(a, b):
    return -(-a // b)


# ---- the plain ridge steps and altmin past k = 10 against omc ----


@pytest.mark.parametrize("k", [11, 16, 32])
def test_ridge_steps_match_omc_past_rank_10(k):
    """v_step and u_step_unconstrained (the plain versions a CPU tensor
    takes) against omc's jnp steps at 1e-10 relative, float64, on more rows
    and columns than k so the ridged systems stay well posed."""
    rng = np.random.default_rng(100 + k)
    n, m, B = 2 * k + 3, 2 * k + 7, 2
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.6).astype(np.float64)
    U = rng.standard_normal((B, n, k))
    T = torch.as_tensor
    Vt = tlinalg.v_step(T(U), T(A), T(mask), 7.0)
    Ut = tlinalg.u_step_unconstrained(Vt, T(A), T(mask), 7.0)
    for b in range(B):
        Vj = np.asarray(jlinalg.v_step(jnp.asarray(U[b]), jnp.asarray(A), jnp.asarray(mask), 7.0))
        Uj = np.asarray(jlinalg.u_step_unconstrained(jnp.asarray(Vj), jnp.asarray(A),
                                                     jnp.asarray(mask), 7.0))
        assert np.linalg.norm(Vt[b].numpy() - Vj) <= 1e-10 * np.linalg.norm(Vj)
        assert np.linalg.norm(Ut[b].numpy() - Uj) <= 1e-10 * np.linalg.norm(Uj)


def test_altmin_at_rank_12_matches_omc():
    """make_altmin at k = 12 (30 x 32, 80% observed) against omc.altmin in
    float64: U, V, objective and trace within 1e-9 (test_torch_altmin's
    bar), the same convergence flags and iteration counts."""
    k, n, m, B = 12, 30, 32, 2
    A, idx = generate_matrix_completion_data(k, n, m, int(0.8 * n * m), 5)
    mask = idx.astype(np.float64)
    U0 = np.random.default_rng(6).standard_normal((B, n, k))
    lo, hi = root_box(n, k)
    lo, hi = np.broadcast_to(lo, (B, n, k)).copy(), np.broadcast_to(hi, (B, n, k)).copy()
    rj = jaltmin.make_altmin(n, m, k, 20.0, max_iters=30, tol=1e-5, dtype=jnp.float64)(
        jnp.asarray(A), jnp.asarray(mask), jnp.asarray(U0), jnp.asarray(lo), jnp.asarray(hi))
    rt = taltmin.make_altmin(n, m, k, 20.0, max_iters=30, tol=1e-5, dtype=F64)(
        torch.as_tensor(A), torch.as_tensor(mask), torch.as_tensor(U0), torch.as_tensor(lo),
        torch.as_tensor(hi))
    for key in ("U", "V", "objective", "obj_trace"):
        a, b = getattr(rt, key).numpy(), np.asarray(getattr(rj, key))
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), key
        assert np.all(np.abs(a[fin] - b[fin]) <= 1e-9 * np.maximum(1.0, np.abs(b[fin]))), key
    assert np.array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert np.array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))


# ---- the McCormick steps at k = 4, 5 against omc ----


def _mc_problem(k, seed, B=3, n=7, m=9):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.6).astype(np.float64)
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    st = J.init_mc_state(B, n, m, k, jnp.float64, sX=1.5, sT=1.2, rho=10.0)
    leaves = [np.asarray(x) for x in st]
    for i in range(21):  # w1 ... t: slot values and duals, symmetric square blocks
        x = rng.standard_normal(leaves[i].shape) * 0.3
        if x.ndim == 3 and x.shape[-1] == x.shape[-2]:
            x = 0.5 * (x + np.swapaxes(x, -1, -2))
        leaves[i] = x
    leaves[21] = rng.uniform(5.0, 15.0, B)
    return A, mask, lo, hi, leaves


@pytest.mark.parametrize("k", [4, 5])
def test_mccormick_setup_matches_omcs_factorisation(k):
    """The setup's plain version (the factors K9s's wide kernels compute)
    against omc's factorisation recomputed in numpy from omc's envelope
    coefficients, at 1e-12: M_i's Cholesky factor, S_i = M_i^-1 E_t and
    chol(I + sum_i S_i[k:])."""
    A, mask, lo, hi, _ = _mc_problem(k, 200 + k)
    B, n = lo.shape[:2]
    q = _tri(k)
    J1, J2 = J.pair_indices(k)
    s, c1, c2, _ = J.mccormick_coeffs(lo, hi, J1, J2, xp=np)
    eye_k = np.eye(k)
    R = np.concatenate([c1[..., None] * eye_k[J1] + c2[..., None] * eye_k[J2],
                        s[..., None] * np.eye(q)], axis=-1)
    R = np.swapaxes(R, 1, 2).reshape(B, n, 4 * q, k + q)
    M = np.einsum("bnrc,bnrd->bncd", R, R) + np.diag(np.r_[4.0 * np.ones(k), np.zeros(q)])
    M = M + 1e-9 * np.eye(k + q)
    Si_ref = np.linalg.solve(M, np.broadcast_to(np.concatenate([np.zeros((k, q)), np.eye(q)]),
                                                (B, n, k + q, q)))
    refs = (np.linalg.cholesky(M), Si_ref,
            np.linalg.cholesky(np.eye(q) + Si_ref[..., k:, :].sum(axis=1)))
    batch = convert.mc_batch_from_numpy([lo, hi], device="cpu")
    for got, ref in zip(P.mc_setup(batch, k), refs):
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * max(1.0, np.max(np.abs(ref)))


@pytest.mark.parametrize("k", [4, 5])
def test_mccormick_zstep_and_cone_step_match_omc(k):
    """One McCormick iteration from one random state at k = 4, 5: the
    z-step's outputs (X, Y, Theta, U, t), the cone step's (every non-PSD
    slot) and the PSD slots against omc's at 1e-12."""
    A, mask, lo, hi, leaves = _mc_problem(k, 300 + k)
    B, n = lo.shape[:2]
    m = A.shape[1]
    sj = J.make_mccormick_solver(n, m, k, 20.0, iters=1, dtype=jnp.float64)
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), J.MCBatch(jnp.asarray(lo), jnp.asarray(hi)),
               5.0, J.MCState(*[jnp.asarray(x) for x in leaves]))
    st = P.make_mccormick_solver(n, m, k, 20.0, iters=1, dtype=F64)
    ft, _ = st(torch.as_tensor(A), torch.as_tensor(mask),
               convert.mc_batch_from_numpy([lo, hi], device="cpu"), 5.0,
               convert.mc_state_from_numpy(leaves, device="cpu"))
    for f, a, b in zip(dataclasses.fields(P.MCState), ft.leaves(), fj):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * max(1.0, np.max(np.abs(b))), f.name


# ---- K6's plans ----


def _k6_wide_smem(k, S, W, rpw, elem):
    """wide_smem_bytes of csrc/k6_altmin.cu: the chunk's rpw rows of k, each
    warp's 32 weights and weighted A, its tri(k) + k entries where S = 1,
    then each warp's 32 int32 row indices."""
    return elem * (rpw * k + 2 * W * 32 + (S * W * (_tri(k) + k))) + 4 * W * 32


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("k", [11, 12, 16, 20, 32, 33, 48, 64, 80, 120])
@pytest.mark.parametrize("B,n,m", [(1, 100, 100), (4, 250, 250), (64, 1000, 1000), (3, 40, 57)])
def test_k6_wide_plan_owns_each_output_once(B, n, m, k, dtype):
    """Past k = 10 the default plan is the wide path: a warp per (slot,
    output), W outputs of one slot a CTA, every (slot, output) of the grid
    owned once, in chunks of 32 rows; its shared memory is the kernel's
    formula, its entries in shared memory where they fit (else the global
    workspace of B O (tri(k) + k) values: float64 from k = 80, float32
    from k = 114), its (1/gamma) F'F scratch B tri(k) values."""
    e = dtype.itemsize
    for R, O in ((n, m), (m, n)):
        p = tlinalg.k6_plan(B, R, O, k, None, dtype)
        assert p["path"] == "wide" and p["threads"] == 32 * p["W"] and 1 <= p["W"] <= 8
        tiles, slots = p["grid"]
        assert slots == B
        own = np.zeros((B, O), np.int64)
        for x in range(tiles):
            o = x * p["W"] + np.arange(p["W"])
            own[:, o[o < O]] += 1
        assert np.all(own == 1)
        assert p["rpw"] == 32
        assert p["smem_bytes"] == _k6_wide_smem(k, p["S"], p["W"], p["rpw"], e) <= SMEM
        assert p["smem_bytes"] == tlinalg.k6_smem_bytes("wide", k, p["S"], p["W"], p["rpw"],
                                                         dtype)
        assert p["S"] == int(_k6_wide_smem(k, 1, p["W"], 32, e) <= SMEM)
        assert p["gram_bytes"] == e * B * _tri(k)
        assert p["ws_bytes"] == (0 if p["S"] else e * B * O * (_tri(k) + k))
        assert p["S"] == int(k < (80 if e == 8 else 114))


def test_k6_wide_plan_narrows_its_chunk_only_past_shared_memory():
    """A chunk of 32 rows of k values fits beside the warps' lists up to k
    in the hundreds; beyond, the chunk narrows (16, 8, ... rows), and only
    one row past a CTA's shared memory is refused."""
    assert tlinalg.k6_plan(4, 1000, 1000, 200, None, F64)["rpw"] == 32
    p = tlinalg.k6_plan(4, 1000, 1000, 1000, None, F64)
    assert p["rpw"] < 32 and p["S"] == 0 and p["smem_bytes"] <= SMEM
    with pytest.raises(ValueError, match="one row"):
        tlinalg.k6_plan(1, 70000, 70000, 60000)


def _k6_plan_before(B, R, O, k, path=None, dtype=torch.float32):
    """k6_plan before its wide path (k <= 10 only)."""
    L = tlinalg
    vw = 16 // dtype.itemsize
    rows16 = R * k % vw == 0
    if path is None:
        big = B >= L.K6_SLOTS_MIN_B and R >= L.K6_SLOTS_MIN_R
        path = "slots" if big and rows16 else "tile"
    if path == "slots" and not rows16:
        return None
    if path == "slots":
        groups = -(-B // L.K6_TILE)
        most = L.K6_SLOTS_MAX_WARPS_F64 if dtype == F64 else L.K6_SLOTS_MAX_WARPS
        W = next((w for w in (16, 8, 4, 2)
                  if w <= most and -(-O // w) * groups >= L.K6_SLOTS_CTAS), 1)
        S, rpw, grid = 1, L.K6_TILE, (-(-O // W), groups)
    else:
        tiles = -(-O // L.K6_TILE)
        units = max(1, -(-R // L.K6_UNIT))
        need = -(-L.K6_TARGET_WARPS // max(1, tiles * B))
        W = max(1, min(L.K6_MAX_WARPS, units, need))
        rpw = L.K6_UNIT * -(-units // W)
        W = -(-units // (rpw // L.K6_UNIT))
        S = max(1, min(B, L.K6_MAX_WARPS // W, 4))
        grid = (tiles, -(-B // S))
    return dict(path=path, S=S, W=W, rpw=rpw, threads=32 * S * W, grid=grid,
                smem_bytes=L.k6_smem_bytes(path, k, S, W, rpw, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("k", range(1, 11))
def test_k6_plans_at_rank_10_and_below_are_unchanged(k, dtype):
    """Every plan at k <= 10, on every path and at the smoke's and the
    solver's shapes, equals its value before the wide path."""
    for B in (1, 4, 32, 64, 128):
        for R, O in ((50, 50), (75, 75), (250, 250), (1000, 1000), (9, 7), (512, 50)):
            for path in (None,) + tlinalg.K6_PATHS:
                before = _k6_plan_before(B, R, O, k, path, dtype)
                if before is None:
                    with pytest.raises(ValueError):
                        tlinalg.k6_plan(B, R, O, k, path, dtype)
                else:
                    assert tlinalg.k6_plan(B, R, O, k, path, dtype) == before


# ---- K9s's, K9a's and K9b's wide plans ----


MC_WIDE = [(B, n, n, k) for B in (1, 4, 16, 64) for n in (50, 75) for k in (4, 5, 6, 10)] + [
    (1, 2048, 2049, 1), (1, 2048, 2049, 3), (2, 3000, 3000, 1), (1, 2000, 4000, 2),
    (4, 2100, 2100, 1), (64, 300, 5500, 1), (1, 8, 46334, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("B,n,m,k", MC_WIDE)
def test_k9_wide_plans_own_every_entry_once(B, n, m, k, dtype):
    """At k >= 4 or n + m > 4096 the wide kernels: K9s's row CTAs (a warp a
    row, 4 rows a CTA) and K9a's own each (slot, row) once; K9a's flat CTAs
    follow (X chunks of 512 entries, Theta's and Y's tile pairs, each tile
    of each slot once); K9b's B slot CTAs, then words of E = 16 / itemsize
    entries covering t1, t2, t3 once, a word spanning at most two slots
    (past 2^31 flat entries too: B = 64 at n + m = 5,800, B = 1 at n + m =
    46,342); the second launch's sums and the slot CTA's in shared memory
    as the kernel counts them."""
    e, q = dtype.itemsize, _tri(k)
    if k >= 4:
        s = P.k9s_plan(B, n, k, dtype)
        assert s["path"] == "wide" and s["g_ctas"] == B
        R = _cdiv(n, P.K9_WIDE_ROWS)
        own = np.zeros((B, n), np.int64)
        for x in range(s["row_ctas"]):
            i = (x % R) * P.K9_WIDE_ROWS + np.arange(P.K9_WIDE_ROWS)
            own[x // R, i[i < n]] += 1
        assert np.all(own == 1)
    p = P.k9_plan(B, n, m, k, dtype)
    assert p["path"] == "wide" and p["threads"] == P.K9_THREADS
    R = _cdiv(n, P.K9_WIDE_ROWS)
    assert p["row_ctas"] == B * R
    tn, tm = _cdiv(n, P.K9_TILE), _cdiv(m, P.K9_TILE)
    assert p["x_chunks"] == _cdiv(n * m, P.K9_X_CHUNK)
    assert p["units"] == p["x_chunks"] + p["th_pairs"] + p["y_pairs"]
    assert p["k9a_grid"] == B * R + B * p["units"]
    for T, pairs in ((tm, p["th_pairs"]), (tn, p["y_pairs"])):
        tiles = np.zeros((T, T), np.int64)
        for I in range(T):  # pair (I, J), I <= J: tiles (I, J) and (J, I)
            tiles[I, I:] += 1
            tiles[I + 1:, I] += 1
        assert pairs == T * (T + 1) // 2 and np.all(tiles == 1)
    assert p["k9a_fix_ctas"] == B and p["k9a_fix_smem"] == e * (q + 1)
    assert p["slot_ctas"] == B and p["k9b_smem"] == e * (1 + 2 * k + q)
    E = 16 // e
    qpc = p["qpc"]
    assert qpc in (32, 64, 128)
    for ctas, d in ((p["t1_ctas"], n + m), (p["t2_ctas"], n + k), (p["t3_ctas"], n)):
        tot = B * d * d
        assert (ctas - 1) * qpc * E < tot <= ctas * qpc * E and d * d >= E
    assert p["k9b_grid"] == B + p["t1_ctas"] + p["t2_ctas"] + p["t3_ctas"]


def _k9s_plan_before(B, n, k, dtype):
    """k9s_plan before the wide kernels (k <= 3 only)."""
    e, q = dtype.itemsize, _tri(k)
    kq, slack = k + q, 16 // e

    def vals(t):
        return (slack + t * kq * kq) + (slack + t * kq * q) + (t // 32) * _tri(q)

    threads = min(P.K9S_THREADS, max(P.K9S_MIN_THREADS, 32 * _cdiv(n, 32)))
    while threads > P.K9S_MIN_THREADS and e * vals(threads) > P.K9_SMEM_MAX:
        threads -= 32
    return dict(threads=threads, chunks=_cdiv(n, threads), smem_bytes=e * vals(threads))


def _k9_plan_before(B, n, m, k, dtype):
    """k9_plan before the wide kernels (k <= 3, n + m <= 4096)."""
    tn, tm = _cdiv(n, P.K9_TILE), _cdiv(m, P.K9_TILE)
    x, th, y = _cdiv(n * m, P.K9_X_CHUNK), tm * (tm + 1) // 2, tn * (tn + 1) // 2
    E = 16 // dtype.itemsize
    quads = (_cdiv(B * (n + m) ** 2, E), _cdiv(B * (n + k) ** 2, E), _cdiv(B * n * n, E))
    qpc = P.K9_THREADS
    while qpc > 32 and sum(_cdiv(w, qpc) for w in quads) < P.K9B_TARGET_CTAS:
        qpc //= 2
    t1, t2, t3 = (_cdiv(w, qpc) for w in quads)
    return dict(threads=P.K9_THREADS, tile=P.K9_TILE, x_chunk=P.K9_X_CHUNK, slot_ctas=B,
                x_chunks=x, th_pairs=th, y_pairs=y, units=x + th + y,
                k9a_grid=B + B * (x + th + y), qpc=qpc, t1_ctas=t1, t2_ctas=t2, t3_ctas=t3,
                k9b_grid=B + t1 + t2 + t3)


def test_k9_plans_at_rank_3_and_below_are_unchanged():
    """Where the unrolled kernels fit (k <= 3, n + m <= 4096, the slot
    CTA's staging within 227 KB) the plans equal their values before the
    wide kernels, with no path key."""
    for dtype in (torch.float32, F64):
        for B, n, k in ((64, 50, 1), (64, 75, 2), (1, 50, 1), (16, 50, 1), (64, 50, 3),
                        (4, 2048, 3), (2, 12, 2)):
            assert not P.k9_wide(n, n, k, dtype)
            assert P.k9_plan(B, n, n, k, dtype) == _k9_plan_before(B, n, n, k, dtype)
            assert P.k9s_plan(B, n, k, dtype) == _k9s_plan_before(B, n, k, dtype)


def test_k9_wide_plan_refuses_past_int_indices():
    """(Named when the wide plan refused B (n + m)^2 >= 2^31.)  The wide
    plan now plans such a batch (16 x 12,000^2 flat entries: K9a and K9b
    index them in 64 bits), its K9b CTAs covering the flat once; a rank
    below 1 is still refused."""
    p = P.k9_plan(16, 6000, 6000, 1)
    E, tot = 4, 16 * 12000 ** 2
    assert p["path"] == "wide" and tot >= 2 ** 31
    assert (p["t1_ctas"] - 1) * p["qpc"] * E < tot <= p["t1_ctas"] * p["qpc"] * E
    with pytest.raises(ValueError, match="k >= 1"):
        P.k9_plan(1, 50, 50, 0)


# ---- the wide kernels' exact (i, j) split ----


def _k9_split(e, W):
    """csrc/k9_mccormick.cu k9_split in numpy: a float32 estimate
    trunc((float(e) + 0.5f) * (1.0f / W)), corrected while j is out of [0,
    W).  Returns (i, j, the most correction steps any entry took)."""
    inv = np.float32(1.0) / np.float32(W)
    i = np.trunc((e.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    j = e - i * W
    steps = 0
    while np.any(j < 0) or np.any(j >= W):
        lo, hi = j < 0, j >= W
        i, j = i - lo + hi, j + W * lo - W * hi
        steps += 1
    return i, j, steps


@pytest.mark.parametrize("n,m", [(2048, 2049), (1, 4096), (4096, 1)])
def test_k9_split_matches_divmod_on_every_flat_entry(n, m):
    """At n + m = 4,097 (D^2 = 16,785,409 > 2^24 entries a block): every
    flat entry of a t1 block (W = D) and of X (W = m) splits as Python's
    divmod does, each within one correction step."""
    D = n + m
    for tot, W in ((D * D, D), (n * m, m)):
        for lo in range(0, tot, 1 << 22):
            e = np.arange(lo, min(tot, lo + (1 << 22)), dtype=np.int64)
            i, j, steps = _k9_split(e, W)
            qi, qj = np.divmod(e, W)
            assert np.array_equal(i, qi) and np.array_equal(j, qj)
            assert steps <= 1


# ---- the CUDA shape gate ----


def test_shape_gate_admits_rank_k_shor_at_every_rank():
    """kernels.require_cuda_shape admits the shor_k family at k = 5 and 12
    (K7x's, K8c's and K8d's wide kernels take any rank) as at k = 4, and
    every rank of the other families (K6 and the McCormick kernels take
    any); an unknown family and a rank below 1 raise."""
    kernels.require_cuda_shape("shor_k", 5, 75, 75)
    kernels.require_cuda_shape("shor_k", 12, 75, 75)
    kernels.require_cuda_shape("shor_k", 4, 75, 75)
    assert not hasattr(kernels, "SHOR_K_CUDA_MAX_K")
    for family in ("base", "pdhg", "halpern", "shor", "mccormick"):
        kernels.require_cuda_shape(family, 64, 1000, 1000)
    with pytest.raises(ValueError, match="unknown solver family"):
        kernels.require_cuda_shape("cuts", 1, 5, 5)
    with pytest.raises(ValueError, match="unsupported shape"):
        kernels.require_cuda_shape("base", 0, 5, 5)


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device that the entry points see but never reach: any
    allocation on it would fail on this machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "set_full_fp32", lambda: None)


class _ReachedCard(Exception):
    """The port's first call on the card (CUDA's lazy initialisation, which
    any allocation there makes first)."""


@pytest.mark.parametrize("entry", ["branchandbound", "relaxation"])
def test_entry_points_take_rank_5_shor_to_the_card(entry, fake_card, monkeypatch):
    """matrix_completion_branchandbound and the api's relaxation pass the
    gate with rank-k Shor at k = 5 on CUDA and go on to the card: the first
    thing they do there (here: CUDA's lazy initialisation, patched to raise)
    is reached, not the gate's ValueError."""
    from omc_torch.solve import matrix_completion_branchandbound

    def first_call():
        raise _ReachedCard

    monkeypatch.setattr(torch.cuda, "_lazy_init", first_call)
    A, idx = generate_matrix_completion_data(5, 10, 10, 100, 1)
    with pytest.raises(_ReachedCard):
        if entry == "branchandbound":
            matrix_completion_branchandbound(
                5, A, idx, 20.0, device="cuda", add_Shor_valid_inequalities=True,
                disjunctive_cuts_type="linear", disjunctive_cuts_breakpoints="smallest_1_eigvec",
                dtype="float32", verbosity=0)
        else:
            lo, hi = root_box(10, 5)
            node = tapi.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf,
                               depth=0, cuts=None)
            tapi.matrix_completion_SDP_relaxation(node, 10, 5, A, idx, 20.0,
                                                  add_Shor_valid_inequalities=True,
                                                  disjunctive_cuts_type="linear",
                                                  dtype="float32")


# (the two tests below keep the names they had when the gate refused
# McCormick at batch (n + m)^2 >= 2^31; K9a and K9b now index past it)
@pytest.mark.parametrize("n_plus_m,batch,past_2_31", [
    (5792, 64, False), (5793, 64, True), (46340, 1, False), (46341, 1, True),
    (1448, 1024, False), (1450, 1024, True)])
def test_shape_gate_refuses_mccormick_past_int_flat_entries(n_plus_m, batch, past_2_31):
    """kernels.require_cuda_shape admits the mccormick family on both sides
    of batch (n + m)^2 = 2^31 (K9a and K9b index the flat entries in 64
    bits past it), as every other family at the same shape, and the module
    keeps no flat limit."""
    n = n_plus_m // 2
    m = n_plus_m - n
    assert (batch * n_plus_m ** 2 >= 2 ** 31) == past_2_31
    for family in ("mccormick", "base", "shor", "shor_k"):
        kernels.require_cuda_shape(family, 1, n, m, batch)
        kernels.require_cuda_shape(family, 2, n, m, batch)
    assert not hasattr(kernels, "MCCORMICK_CUDA_MAX_FLAT")


def test_driver_refuses_a_mccormick_batch_past_int_flat_entries(fake_card, monkeypatch):
    """matrix_completion_branchandbound passes McCormick's gate at a
    batch_size of 1024 slots at n = m = 725 (1024 x 1450^2 >= 2^31) on CUDA
    and goes on to the card: its first call there (CUDA's lazy
    initialisation, patched to raise) is reached, not a ValueError."""
    from omc_torch.solve import matrix_completion_branchandbound

    def first_call():
        raise _ReachedCard

    monkeypatch.setattr(torch.cuda, "_lazy_init", first_call)
    rng = np.random.default_rng(7)
    A = rng.standard_normal((725, 725))
    idx = (rng.random((725, 725)) < 0.3).astype(np.int64)
    with pytest.raises(_ReachedCard):
        matrix_completion_branchandbound(1, A, idx, 20.0, device="cuda",
                                         use_disjunctive_cuts=False, batch_size=1024,
                                         dtype="float32", verbosity=0)


# ---- the wide K9 kernels forced at the unrolled ranks; the wrappers' dispatch ----


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_k9_plans_force_the_wide_kernels_at_the_unrolled_ranks(k, dtype):
    """k9s_plan and k9_plan with path="wide" plan the wide kernels at k <= 3
    (the unrolled plan's flat CTAs with the wide rows, as at k >= 4), the
    default stays on the unrolled kernels, and another path is refused."""
    B, n, m = 16, 50, 50
    base = P.k9_plan(B, n, m, k, dtype)
    assert "path" not in base and "path" not in P.k9s_plan(B, n, k, dtype)
    wide = P.k9_plan(B, n, m, k, dtype, path="wide")
    assert wide["path"] == "wide" and wide == P._k9_wide_plan(base, B, n, m, k, dtype)
    assert P.k9s_plan(B, n, k, dtype, path="wide") == dict(
        path="wide", threads=P.K9_THREADS, row_ctas=B * _cdiv(n, P.K9_WIDE_ROWS), g_ctas=B,
        smem_bytes=0)
    for bad in ("unrolled", "tile"):
        with pytest.raises(ValueError, match="path"):
            P.k9_plan(B, n, m, k, dtype, path=bad)
        with pytest.raises(ValueError, match="path"):
            P.k9s_plan(B, n, k, dtype, path=bad)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_k9_blocks_carry_their_plans_path(k):
    """K9a's and K9b's packed blocks say which kernel their plan takes
    (``wide``: at k >= 4, or forced), and a forced path packs a block of its
    own for the same operands; the wrappers launch by it."""
    A, mask, lo, hi, leaves = _mc_problem(k, 400 + k)
    B, n = lo.shape[:2]
    m = A.shape[1]
    st = convert.mc_state_from_numpy(leaves, device="cpu")
    c = P.make_mc_consts(torch.as_tensor(A), torch.as_tensor(mask),
                         convert.mc_batch_from_numpy([lo, hi], device="cpu"), st, n, m, k, 20.0,
                         1.6, F64)
    cpu = torch.device("cpu")
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    for path, wide in ((None, k > 3), ("wide", True)):
        pa = P._k9a_params(c, st, cpu, path)
        pb = P._k9b_params(c, st, ts, None, 0.0, cpu, path)
        assert pa.wide == wide and pb.wide == wide
        assert P._k9a_params(c, st, cpu, path) is pa
        assert P._k9b_params(c, st, ts, None, 0.0, cpu, path) is pb
    assert P._k9a_params(c, st, cpu) is not P._k9a_params(c, st, cpu, "wide")
