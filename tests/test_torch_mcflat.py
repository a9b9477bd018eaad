"""McCormick past batch x (n + m)^2 >= 2^31 on the CPU: K9a's and K9b's
plans at the flats where their indices pass int (B = 64 at n + m = 5,800,
the driver's default batch; B = 128 at n + m = 4,096, the unrolled kernels
at exactly 2^31; B = 1 at n + m = 46,342, where a slot's own entries pass
2^31), with numpy mirrors of the kernels' index arithmetic
(``omc_torch/csrc/k9_mccormick.cu``: K9b's flat words, their slot and
(i, j), the choice of int or 64-bit indices; ``k9_split``), and the float
divmod of K2's and K3's flat loops (``omc_torch/csrc/common.cuh``) at the
widths past n + m = 46,340.  No test allocates a tensor of the batch's
flat size: the mirrors run on sampled entries.  The kernels themselves run
on the GPU only: ``chip_smoke.py``'s ``mcflat`` phase holds them against
their plain versions and their runs on the batch's halves there."""

import numpy as np
import pytest
import torch

from omc_torch.sdp import admm as tadmm
from omc_torch.sdp import mccormick as P

INT_MAX = 2 ** 31 - 1

# (B, n, m, k): the driver's default batch_size past 2^31 (64 x 5,800^2),
# the unrolled kernels' widest shape at 128 slots (exactly 2^31, k = 1 and
# 3), one node past n + m = 46,340 (its own (n + m)^2 > 2^31)
FLAT_SHAPES = [(64, 300, 5500, 1), (128, 64, 4032, 1), (128, 64, 4032, 3), (1, 8, 46334, 1)]


def _cdiv(a, b):
    return -(-a // b)


def _split_f32(e, W, exact):
    """The kernels' (i, j) = divmod(e, W): a float32 estimate trunc((float(e)
    + 0.5f) * (1.0f / W)), then omc::divmod's one correction step or, with
    ``exact``, k9_split's corrections until j lies in [0, W).  Returns (i,
    j, the most steps any entry took)."""
    inv = np.float32(1.0) / np.float32(W)
    i = np.trunc((e.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    j = e - i * W
    steps = 0
    while np.any(j < 0) or np.any(j >= W):
        lo, hi = j < 0, j >= W
        i, j = i - lo + hi, j + W * lo - W * hi
        steps += 1
        if not exact:
            break
    return i, j, steps


def _k9b_words(B, D, E, qpc, ctas, x, in_int):
    """K9b's flat CTAs ``x`` (indices among the kind's ``ctas``) as k9b_t
    resolves them, in int or (``in_int`` false: k9b_kernel64) 64 bits: each
    live thread's word of E entries, its slot b0 from the first entry (an
    int divide, or slot_of's float estimate corrected), each entry's slot
    (b0 or b0 + 1), in-slot offset and (i, j).  Returns (entries, slots, i,
    j) for every live entry."""
    tot = B * D * D
    t = np.arange(qpc)[None, :]
    q0 = E * (x[:, None] * qpc + t)
    if in_int:  # every word a CTA of the kind could take fits in int
        assert int(E * (ctas * qpc)) - 1 <= INT_MAX
    q0 = q0[q0 < tot]
    DD = D * D
    b0 = q0 // DD
    if not in_int:  # slot_of: a float estimate, corrected (one slot at most)
        est = np.trunc(q0.astype(np.float32) / np.float32(DD)).astype(np.int64)
        assert np.all(np.abs(est - b0) <= 1)
    es, bs, rs = [], [], []
    for c in range(E):
        e = q0 + c
        ok = e < tot
        b = b0 + (e >= (b0 + 1) * DD)
        es.append(e[ok]), bs.append(b[ok]), rs.append((e - b * DD)[ok])
    e, b, r = (np.concatenate(v) for v in (es, bs, rs))
    i, j, steps = _split_f32(r, D, exact=True)
    assert steps <= 1
    return e, b, i, j


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m,k", FLAT_SHAPES)
def test_k9_plans_own_every_word_past_int_flat(B, n, m, k, dtype):
    """At flats of 2^31 and past: k9_plan's K9b CTAs cover the batch's t1,
    t2 and t3 words once (the CTA count is the least whole number of
    ``qpc`` words of E entries), the sampled words (the first and last
    CTAs, those around entry 2^31 and around a slot boundary past it)
    resolve every entry's slot and (i, j) as divmod does, in int only where
    no kind's word a CTA could take passes int (k9b_flat64: the kernel
    indexes every kind in 64 bits past it); K9a's grid and K9b's are the
    unrolled kernels' at k <= 3 and n + m <= 4,096 and the wide ones' else,
    below 2^31 - 1 CTAs; k9s_plan plans the batch at any flat."""
    p = P.k9_plan(B, n, m, k, dtype)
    wide = n + m > P.K9_UNROLLED_MAX_NM
    assert (p.get("path") == "wide") == wide
    E, qpc = 16 // dtype.itemsize, p["qpc"]
    tn, tm = _cdiv(n, P.K9_TILE), _cdiv(m, P.K9_TILE)
    units = _cdiv(n * m, P.K9_X_CHUNK) + tm * (tm + 1) // 2 + tn * (tn + 1) // 2
    assert p["units"] == units
    rows = B * _cdiv(n, P.K9_WIDE_ROWS) if wide else B
    assert p["k9a_grid"] == rows + B * units < INT_MAX
    assert p["k9b_grid"] == B + p["t1_ctas"] + p["t2_ctas"] + p["t3_ctas"] < INT_MAX
    in_int = B * (n + max(m, k)) ** 2 <= INT_MAX - E * 128  # k9b_flat64
    assert in_int == (B * (n + m) ** 2 < 2 ** 31 - E * 128)
    for key, D in (("t1_ctas", n + m), ("t2_ctas", n + k), ("t3_ctas", n)):
        tot, ctas = B * D * D, p[key]
        assert (ctas - 1) * qpc * E < tot <= ctas * qpc * E
        DD = D * D
        # the CTAs to sample: first, last, around entry 2^31 and around the
        # first slot boundary at or past it
        marks = {0, ctas - 1, min(ctas - 1, 2 ** 31 // (E * qpc))}
        bnd = _cdiv(min(2 ** 31, tot - 1), DD) * DD
        marks.add(min(ctas - 1, bnd // (E * qpc)))
        x = np.array(sorted({c + d for c in marks for d in (-1, 0, 1) if 0 <= c + d < ctas}))
        e, b, i, j = _k9b_words(B, D, E, qpc, ctas, x, in_int)
        assert np.array_equal(b, e // DD)
        qi, qj = np.divmod(e % DD, D)
        assert np.array_equal(i, qi) and np.array_equal(j, qj)
        assert e.max() == tot - 1
    s = P.k9s_plan(B, n, k, dtype)  # K9s's CTA a slot at any flat (k <= 3)
    assert "path" not in s and s["threads"] >= 128


@pytest.mark.parametrize("D", [4096, 5800, 46342])
def test_k9_split_matches_divmod_past_2_31(D):
    """k9_split on 64-bit entries: sampled flat entries of a batch's t1 past
    2^31 (up to 2^34) split by D, and every in-slot offset band around 2^31
    at D = 46,342 (a slot's D^2 = 2,147,580,964 > 2^31), as divmod does,
    each within one correction step."""
    rng = np.random.default_rng(D)
    lo = [2 ** 31 - 4096, 2 ** 31, 2 ** 32 - 2048, 2 ** 33 + 17, 2 ** 34 - 4096]
    e = np.concatenate([np.arange(a, a + 4096, dtype=np.int64) for a in lo]
                       + [rng.integers(2 ** 31, 2 ** 34, 200_000, dtype=np.int64)])
    if D == 46342:  # in-slot offsets: up to D^2 - 1, past 2^31
        e = np.concatenate([e % (D * D), np.arange(D * D - 3 * D, D * D, dtype=np.int64)])
    i, j, steps = _split_f32(e, D, exact=True)
    qi, qj = np.divmod(e, D)
    assert np.array_equal(i, qi) and np.array_equal(j, qj) and steps <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(8, 46334), (2, 46340), (23171, 23171)])
def test_k2_k3_flat_loops_past_n_plus_m_46340(n, m, dtype):
    """K2's and K3's flat loops at one node past n + m = 46,340, where a
    slot's entries pass 2^31 (their in-slot products are 64-bit there):
    k2k3_plan plans the shape; the int flats of their loops (X's n m, the
    clusters' bands of Y, n ceil(n / C), and of Theta, m ceil(m / C3)) stay
    below 2^31; omc::divmod's one-step float split is exact on sampled items
    of each, and on every item of the last rows."""
    p = tadmm.k2k3_plan(1, n, m, 1, 8, dtype=dtype)
    C2, C3 = p["k2_cluster"], p["k3_cluster"]
    rng = np.random.default_rng(n + m)
    for R, W in ((n, m), (_cdiv(n, C2), n), (_cdiv(n, C3), n), (_cdiv(m, C3), m)):
        tot = R * W
        assert tot <= INT_MAX
        e = np.concatenate([rng.integers(0, tot, 100_000, dtype=np.int64),
                            np.arange(max(0, tot - 4 * W), tot, dtype=np.int64)])
        i, j, _ = _split_f32(e, W, exact=False)
        qi, qj = np.divmod(e, W)
        assert np.array_equal(i, qi) and np.array_equal(j, qj)
    # the products the kernels now take in 64 bits reach 2^31 here
    assert (n + m - 1) * (n + m) + n + m - 1 > INT_MAX
