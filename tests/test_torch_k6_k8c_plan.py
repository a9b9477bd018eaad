"""K6 and K8c on the CPU: the tilings ``k6_plan`` and ``k8c_plan`` pick at
every shape the paths run, a torch mirror of K6's arithmetic against
``omc``'s ridge steps, and K8c's entry-keyed minor table against the
coordinate-keyed one it replaces.

K6 (``omc_torch/csrc/k6_altmin.cu``) and K8c (``csrc/k8k_shor_k.cu``) run on
the GPU only; ``chip_smoke.py`` holds them against their plain versions
there.  The mirror below repeats K6's order of operations on each path: on
the tile path per warp a fixed contiguous range of r from ``k6_plan``, the
Gram weight mask + 1/gamma (so (1/gamma) F'F rides in the same sums), the
partial Grams added in warp order; on the slots path the observed entries'
Gram plus (1/gamma) F'F from sixteen r ranges added in order; then eps on the
diagonal, a packed-lower Cholesky and two triangular solves (k = 1
divides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omc.ops import linalg as jlinalg

from omc_torch.ops import linalg as tlinalg
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.shor_encode import _csr

torch.set_num_threads(2)

# (B, n, m, k) of every K6 call the smoke's rows and the solver's altmin make
# (headline 50x50 k=1 restarts, config 3's 75x75 k=2, config 4's 250x250
# k=5, config 5's 1000x1000 k=10), plus ragged shapes
K6_SHAPES = [(B, n, n, k) for B in (1, 4, 64) for n, k in
             ((50, 1), (50, 2), (50, 10), (75, 2), (250, 5), (1000, 10))] + [
    (128, 250, 250, 5), (3, 9, 7, 3), (5, 33, 17, 10), (2, 1, 40, 1), (7, 200, 13, 4)]


def _covered_once(lo_hi, R):
    cnt = np.zeros(max(R, 1), np.int64)
    for lo, hi in lo_hi:
        assert lo < hi or R == 0
        cnt[lo:hi] += 1
    return bool(np.all(cnt[:R] == 1))


@pytest.mark.parametrize("path", [None, "tile", "slots"])
@pytest.mark.parametrize("B,n,m,k", K6_SHAPES)
def test_k6_plan_owns_each_output_and_row_once(B, n, m, k, path):
    for R, O in ((n, m), (m, n)):  # the V-step, then the U-step
        if path == "slots" and R * k % 4:
            # the slots path copies 16-byte pieces of each slot's rows
            with pytest.raises(ValueError):
                tlinalg.k6_plan(B, R, O, k, path)
            continue
        p = tlinalg.k6_plan(B, R, O, k, path)
        S, W, rpw = p["S"], p["W"], p["rpw"]
        cap = tlinalg.K6_MAX_WARPS if p["path"] == "tile" else tlinalg.K6_SLOTS_MAX_WARPS
        assert 1 <= S and 1 <= W and S * W <= cap
        assert p["threads"] == 32 * S * W
        tiles, groups = p["grid"]
        if p["path"] == "tile":
            # each output tile of 32 and each slot exactly once
            assert (tiles - 1) * 32 < O <= tiles * 32
            assert (groups - 1) * S < B <= groups * S
            # W non-empty ranges of a multiple of 8 rows cover [0, R) once
            assert rpw % tlinalg.K6_UNIT == 0 and rpw > 0
            assert _covered_once([(w * rpw, min(R, (w + 1) * rpw)) for w in range(W)], R)
        else:
            # a warp per output, W outputs a CTA; 32 slots a CTA; every r in
            # chunks of rpw rows by every warp
            assert S == 1 and (tiles - 1) * W < O <= tiles * W
            assert (groups - 1) * 32 < B <= groups * 32 and rpw == 32
        assert p["smem_bytes"] == tlinalg.k6_smem_bytes(p["path"], k, S, W, rpw) <= 232448
        if path is None:  # the default: batches of 32 or more over long sums
            big = B >= tlinalg.K6_SLOTS_MIN_B and R >= tlinalg.K6_SLOTS_MIN_R
            assert p["path"] == ("slots" if big and R * k % 4 == 0 else "tile")


def _tri(a):
    return a * (a + 1) // 2


def k6_mirror(F, A, mask, gamma, ridge_eps, step, path):
    """K6's arithmetic in torch on ``path``: ``step`` "v" solves V (B, k, m)
    from U (B, n, k), "u" solves U (B, n, k) from V (B, k, m)."""
    if step == "v":
        Fr, Wm, Am = F, mask, A                      # r = row i, o = column j
    else:
        Fr, Wm, Am = F.transpose(-1, -2), mask.T, A.T  # r = column j, o = row i
    B, R, k = Fr.shape
    O = Wm.shape[1]
    p = tlinalg.k6_plan(B, R, O, k, path)
    if p["path"] == "tile":
        G = rhs = None
        for w in range(p["W"]):  # fixed split, partial sums added in warp order
            lo, hi = w * p["rpw"], min(R, (w + 1) * p["rpw"])
            f = Fr[:, lo:hi]
            Gw = torch.einsum("brk,ro,brl->bokl", f, Wm[lo:hi] + 1.0 / gamma, f)
            rw = torch.einsum("ro,brk->bok", Wm[lo:hi] * Am[lo:hi], f)
            G, rhs = (Gw, rw) if G is None else (G + Gw, rhs + rw)
    else:
        # the observed entries' Gram, then (1/gamma) F'F from 16 r ranges
        # added in order
        G = torch.einsum("brk,ro,brl->bokl", Fr, Wm, Fr)
        rhs = torch.einsum("ro,brk->bok", Wm * Am, Fr)
        q = -(-R // 16)
        FF = [torch.einsum("brk,brl->bkl", x, x) for x in torch.split(Fr, q, dim=1)]
        for x in FF[1:]:
            FF[0] = FF[0] + x
        FF = FF[0]
        G = G + ((1.0 / gamma) * FF)[:, None]
    # the packed lower triangle, eps on the diagonal
    L = [G[..., a, c] + (ridge_eps if a == c else 0.0) for a in range(k) for c in range(a + 1)]
    y = [rhs[..., a] for a in range(k)]
    if k == 1:
        x = torch.stack([y[0] / L[0]], -1)
    else:
        for j in range(k):
            d = L[_tri(j) + j]
            for q in range(j):
                d = d - L[_tri(j) + q] * L[_tri(j) + q]
            d = torch.sqrt(d)
            L[_tri(j) + j] = d
            for i in range(j + 1, k):
                v = L[_tri(i) + j]
                for q in range(j):
                    v = v - L[_tri(i) + q] * L[_tri(j) + q]
                L[_tri(i) + j] = v / d
        for i in range(k):
            v = y[i]
            for q in range(i):
                v = v - L[_tri(i) + q] * y[q]
            y[i] = v / L[_tri(i) + i]
        for i in reversed(range(k)):
            v = y[i]
            for q in range(i + 1, k):
                v = v - L[_tri(q) + i] * y[q]
            y[i] = v / L[_tri(i) + i]
        x = torch.stack(y, -1)
    return x.transpose(-1, -2) if step == "v" else x


@pytest.mark.parametrize("path", ["tile", "slots"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [1, 2, 5, 10])
def test_k6_mirror_matches_omc(k, dtype, path):
    """The mirror's V-step and U-step against omc's jnp steps on the same
    inputs: 1e-12 relative in float64; in float32 2e-5, float32's own spread
    at these sums of ~40 terms through a k x k solve of condition ~1e2 (the
    smoke holds the kernel to 1e-5 of its float32 plain version)."""
    rng = np.random.default_rng(100 + k)
    B, n, m, gamma = 3, 40, 36, 7.0  # n k and m k multiples of 4 (slots path)
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.5).astype(np.float64)
    Q = np.linalg.qr(rng.standard_normal((B, n, k)))[0]
    U = Q * rng.uniform(0.5, 2.0, (B, 1, k)) * np.sqrt(n / k)
    A, mask, U = (x.astype(dtype) for x in (A, mask, U))
    T = torch.as_tensor
    V = k6_mirror(T(U), T(A), T(mask), gamma, 1e-10, "v", path)
    U2 = k6_mirror(V, T(A), T(mask), gamma, 1e-10, "u", path)
    if path == "tile":
        assert tlinalg.k6_plan(B, n, m, k, path)["W"] >= 2  # the combine is exercised
    tol = 1e-12 if dtype == "float64" else 2e-5
    for b in range(B):
        Vj = np.asarray(jlinalg.v_step(jnp.asarray(U[b]), jnp.asarray(A), jnp.asarray(mask),
                                       gamma))
        Uj = np.asarray(jlinalg.u_step_unconstrained(
            jnp.asarray(V[b].numpy()), jnp.asarray(A), jnp.asarray(mask), gamma))
        assert Vj.dtype == np.dtype(dtype)
        assert np.linalg.norm(V[b].numpy() - Vj) <= tol * np.linalg.norm(Vj)
        assert np.linalg.norm(U2[b].numpy() - Uj) <= tol * np.linalg.norm(Uj)


def test_unsupported_k_raises_before_any_launch():
    """k = 0 and an unknown path raise; k = 11, past the register paths, is
    planned on the wide path, and refused where a register path is
    forced."""
    for k in (0, 11):
        if k == 0:
            with pytest.raises(ValueError):
                tlinalg.k6_plan(4, 50, 50, k)
        else:
            assert tlinalg.k6_plan(4, 50, 50, k)["path"] == "wide"
            for path in tlinalg.K6_PATHS:
                with pytest.raises(ValueError, match="k <= 10"):
                    tlinalg.k6_plan(4, 50, 50, k, path)
    with pytest.raises(ValueError):
        tlinalg.k6_plan(4, 50, 50, 2, "cta")
    with pytest.raises(ValueError, match="k >= 2"):
        tshk.k8c_plan(32, 75, 75, 1)
    # k = 5 takes K8c's wide kernel; a shape whose one column's kept values
    # pass shared memory takes it too, with the kept values in its global
    # workspace, refused only where the workspace passes the card's free
    # memory
    assert tshk.k8c_plan(32, 75, 75, 5)["path"] == "wide"
    p = tshk.k8c_plan(2, 6000, 6000, 4)
    assert p["path"] == "wide" and p["kept"] == "global"
    assert p["ws_bytes"] == 4 * 2 * (4 + 6 + 3) * 6000 * 6000
    with pytest.raises(ValueError, match=f"{p['ws_bytes']} bytes"):
        tshk.k8c_plan(2, 6000, 6000, 4, free_bytes=p["ws_bytes"] - 1)


# (B, n, m, k): the shork path (config 3: B = 32 and its root visit at B = 1,
# k = 2), the smoke's k = 3 row, k = 4, larger batches and widths, the CPU
# tests' 8x8
K8C_SHAPES = [(32, 75, 75, 2), (1, 75, 75, 2), (32, 75, 75, 3), (32, 75, 75, 4),
              (64, 75, 75, 2), (4, 8, 8, 2), (2, 8, 8, 3), (32, 100, 100, 2),
              (8, 250, 250, 3), (32, 1000, 1000, 4), (3, 40, 7, 2)]


@pytest.mark.parametrize("B,n,m,k", K8C_SHAPES)
def test_k8c_plan_owns_each_column_and_row_once(B, n, m, k):
    p = tshk.k8c_plan(B, n, m, k)
    cols, rg = p["cols"], p["row_groups"]
    assert cols in (1, 2, 4, 8, 16, 32) and cols * rg == p["threads"] == tshk.K8C_THREADS
    tiles, slots = p["grid"]
    assert slots == B and (tiles - 1) * cols < m <= tiles * cols
    # every (row, column) entry by exactly one thread of one CTA
    owner = np.zeros((n, m), np.int64)
    for t in range(tiles):
        for tid in range(p["threads"]):
            j = t * cols + tid % cols
            if j < m:
                owner[tid // cols::rg, j] += 1
    assert np.all(owner == 1)
    # the tail (padded coordinates and v1-v3) strided over the slot's CTAs
    C, P = 4 * 256, 5 * 256
    items = np.zeros(C + k * P, np.int64)
    stride = tiles * p["threads"]
    for start in range(stride):
        items[start::stride] += 1
    assert np.all(items == 1)
    assert p["smem_bytes"] == tshk.k8c_smem_bytes(n, m, k, cols) <= tshk.K8C_MAX_SMEM
    # B = 32 at config 3's width fills the card: at least two CTAs an SM
    if (B, n, m) == (32, 75, 75):
        assert tiles * B >= tshk.K8C_TARGET_CTAS


def _random_minors(rng, n, m, count):
    i = np.sort(rng.choice(n, (4 * count, 2)), axis=1)
    j = np.sort(rng.choice(m, (4 * count, 2)), axis=1)
    ok = (i[:, 0] < i[:, 1]) & (j[:, 0] < j[:, 1])
    cand = dict.fromkeys(map(tuple, np.stack([i[:, 0], i[:, 1], j[:, 0], j[:, 1]], 1)[ok]))
    return [tuple(int(v) for v in mm) for mm in list(cand)[:count]]


@pytest.mark.parametrize("n,m,M5,counts", [(8, 8, 8, (6, 7)), (20, 17, 64, (60, 33, 0))])
def test_k8c_entry_table_agrees_with_the_coordinate_table(n, m, M5, counts):
    """fm_ptr/fm_ent (flat entry -> 4 l + corner) hold, for the entry of each
    active coordinate c, exactly the list the coordinate-keyed table
    (cm_ptr/cm_ent, coordinate -> 4 l + corner, which K8c read through
    flat_coord before) gives for c, in the same ascending order; every other
    entry's list is empty."""
    from omc_torch.sdp.shor import shor_soc_complement

    rng = np.random.default_rng(n + M5)
    minors = [_random_minors(rng, n, m, c) for c in counts]
    socs = [shor_soc_complement(n, m, mm) for mm in minors]
    h = tshk.pack_shor_k_batch(n, m, minors, socs, M5, n * m)
    C = h.coord_mask.shape[1]
    for s in range(len(minors)):
        act = np.flatnonzero(h.minor_mask[s] > 0)
        keys = h.mc[s][act].astype(np.int64)
        ents = 4 * act[:, None] + np.arange(4)[None]
        cm_ptr, cm_ent = _csr(keys.reshape(-1), ents.reshape(-1), C)
        fm_ptr, fm_ent = h.fm_ptr[s], h.fm_ent[s]
        assert fm_ptr[-1] == cm_ptr[-1] == 4 * act.size
        seen = np.zeros(n * m, bool)
        for c in np.flatnonzero(h.coord_mask[s] > 0):
            f = h.coord_flat[s][c]
            assert h.flat_coord[s][f] == c
            assert np.array_equal(fm_ent[fm_ptr[f]:fm_ptr[f + 1]],
                                  cm_ent[cm_ptr[c]:cm_ptr[c + 1]])
            seen[f] = True
        assert np.all(np.diff(fm_ptr)[~seen] == 0)
