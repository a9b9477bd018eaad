"""K2 and K3 on the CPU: the work split ``k2k3_plan`` picks at every shape the
paths run, torch mirrors of the kernels' order of work against ``omc``, and
the wrappers' refusals.

K2 (``omc_torch/csrc/k2_zstep.cu``) and K3 (``csrc/k3_cone.cu``) run on the
GPU only; ``chip_smoke.py`` holds them against their plain versions there.
Each runs one thread-block cluster of C CTAs per node slot.  The ownership
test below repeats the kernels' index arithmetic: the row bands
[r n / C, (r + 1) n / C), the flat (row, column) items walked with a float
reciprocal and one correction step, the 16 x 16 tile pairs (I, J), (J, I)
decoded from a pair index, and X's tiles.  The mirrors repeat the kernels'
order of work: the band of sym(zY) from r + r', the partials of s = V'z
summed per CTA band in float64 and added in rank order, t = rho G1^-1 s as
one product, the correction; for K3 tr Y, x_l'Y x_l, ||tsoc_j[1:]||^2 and
x_l'U_j the same way, then the cone step."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from omc.sdp import admm as jadmm
from omc.sdp.cuts import region_bounds
from omc.sdp.relax import NodeBatch as JNodeBatch

from omc_torch.sdp import admm as tadmm
from omc_torch.sdp.relax import NodeBatch

torch.set_num_threads(2)

T = tadmm.K2K3_TILE
THREADS = tadmm.K2K3_THREADS
WARPS = tadmm.K2K3_WARPS

# (B, n, k, L) the smoke and the cells run: batches of the root visits, the
# portfolio, configs 2-4 and the base path; widths of the headline, config 3,
# config 2 and config 4; ranks 1, 2, 5; cut capacities 8 and 32; and the
# deep trees' cut buckets 128, 512 and 2048 (the cut vectors, and at rank 10
# K3's staged slots, then outside shared memory; from rank 5 with 512 cuts
# the partials in the global workspace)
SHAPES = [(B, n, k, L) for B in (1, 4, 32, 64, 128) for n in (50, 75, 100, 250)
          for k in (1, 2, 5) for L in (8, 32)] + [
    (64, 50, 1, 128), (1, 50, 1, 512), (32, 75, 2, 512), (64, 250, 5, 512), (4, 100, 1, 128),
    (2, 250, 10, 512), (64, 1000, 10, 512), (4, 250, 5, 2048), (2, 250, 10, 2048),
    (1, 1000, 10, 2048), (4, 50, 1, 2048)]


def _expected_clusters(B, n, m, k, L):
    """The plan's rules as documented beside ``K2K3_TARGET_CTAS``."""
    cap = min(n, m)

    def largest(target):
        return max([c for c in tadmm.K2K3_CLUSTERS if B * c <= target and c <= cap] or [1])

    C3 = largest(tadmm.K2K3_TARGET_CTAS)
    while C3 < 16 and 2 * C3 <= cap and -(-n // C3) > tadmm.K3_BAND_ROWS:
        C3 *= 2
    P = 1 + L + L * k
    C2 = largest(tadmm.K2_TARGET_CTAS if P <= tadmm.K2_GI_MAX_FAST else tadmm.K2K3_TARGET_CTAS)
    while C2 < 16 and 2 * C2 <= cap and 4 * -(-n // C2) * (n | 1) > tadmm.K2_BAND_MAX:
        C2 *= 2
    return C2, C3


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


def _grid_items(R, W, start, stride):
    """The items (i, j) a thread walks in ``grid_items``."""
    e = np.arange(start, R * W, stride, dtype=np.int64)
    return _divmod_f32(e, W)


def _tile_pair(pr):
    I = 0
    while (I + 1) * (I + 2) // 2 <= pr:
        I += 1
    return I, pr - I * (I + 1) // 2


def _tile_pairs_cover(N, CW, count):
    """Every entry written by the tile pairs of all CW warps, as in
    ``tile_pairs``: pair pr by warp pr mod CW, 8 rows of 16 a lane pair."""
    nt = -(-N // T)
    pairs = nt * (nt + 1) // 2
    for w in range(CW):
        for pr in range(w, pairs, CW):
            I, J = _tile_pair(pr)
            assert 0 <= J <= I < nt
            a, c = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
            for r, s in ((I * T + a, J * T + c), (J * T + a, I * T + c)):
                ok = (r < N) & (s < N)
                np.add.at(count, (r[ok], s[ok]), 1)
                if I == J:
                    break


@pytest.mark.parametrize("B,n,k,L", SHAPES)
def test_k2k3_plan_owns_every_entry_once(B, n, k, L):
    m = n
    p = tadmm.k2k3_plan(B, n, m, k, L)
    C2, C3 = p["k2_cluster"], p["k3_cluster"]
    for C in (C2, C3):
        assert C in tadmm.K2K3_CLUSTERS and C <= min(n, m)
    # the rules at every shape; the partials in the global workspace only
    # where no shared-memory layout holds them
    assert (C2, C3) == _expected_clusters(B, n, m, k, L)
    if L <= 32:
        assert (p["k2_xs"] == p["k3_xs"] == p["k3_slots"] == p["k2_sums"] == p["k3_sums"]
                == "smem")
    g2, g3 = p["k2_sums"] == "global", p["k3_sums"] == "global"
    big = tadmm.K2K3_MAX_SMEM
    assert g2 == all(tadmm.k2_smem_bytes(n, m, k, L, C2, bd, xs) > big
                     for bd in (True, False) for xs in (True, False))
    assert g3 == all(tadmm.k3_smem_bytes(n, m, k, L, C3, xs, sl) > big
                     for xs in (True, False) for sl in (True, False))
    assert p["k2_ws"] == (tadmm.k2_ws_doubles(n, m, k, L, C2) if g2 else 0)
    assert p["k3_ws"] == (tadmm.k3_ws_doubles(n, m, k, L, C3) if g3 else 0)
    assert p["band"] == ("smem" if tadmm.k2_smem_bytes(
        n, m, k, L, C2, True, p["k2_xs"] == "smem", g2) <= big else "rows")
    assert max(p["k2_smem"], p["k3_smem"]) <= big
    assert p["k2_smem"] == tadmm.k2_smem_bytes(n, m, k, L, C2, p["band"] == "smem",
                                               p["k2_xs"] == "smem", g2)
    assert p["k3_smem"] == tadmm.k3_smem_bytes(n, m, k, L, C3, p["k3_xs"] == "smem",
                                               p["k3_slots"] == "smem", g3)
    if g2:  # t's p rows spread over the cluster, each once
        P = 1 + L + L * k
        assert sorted(q for r in range(C2) for q in range(*_band(P, C2, r))) == list(range(P))

    # K2: rows of Y and U by band; X's items over the cluster; Theta's pairs
    rows = np.zeros(n, np.int64)
    band = np.zeros((n, n), np.int64)
    for r in range(C2):
        lo, hi = _band(n, C2, r)
        rows[lo:hi] += 1
        for t in range(THREADS):  # the (i, j) half, then the (j, i) half
            i, j = _grid_items(hi - lo, n, t, THREADS)
            np.add.at(band, (lo + i, j), 1)
            jj, i = _grid_items(n, hi - lo, t, THREADS)
            np.add.at(band, (lo + i, jj), 1)
    assert np.all(rows == 1) and np.all(band == 2)
    X = np.zeros((n, m), np.int64)
    for t in range(C2 * THREADS):
        i, j = _grid_items(n, m, t, C2 * THREADS)
        np.add.at(X, (i, j), 1)
    assert np.all(X == 1)
    Th = np.zeros((m, m), np.int64)
    _tile_pairs_cover(m, C2 * WARPS, Th)
    assert np.all(Th == 1)

    # K3: t1/t2/t3 rows of the Y band, X's tiles, Theta's band, t2's U rows
    D1, D2 = n + m, n + k
    t1 = np.zeros((D1, D1), np.int64)
    t2 = np.zeros((D2, D2), np.int64)
    t3 = np.zeros((n, n), np.int64)
    soc = np.zeros((k, 1 + n), np.int64)
    for r in range(C3):
        lo, hi = _band(n, C3, r)
        a0, a1 = _band(m, C3, r)
        for t in range(THREADS):
            i, j = _grid_items(hi - lo, n, t, THREADS)
            for blk in (t1, t2, t3):
                np.add.at(blk, (lo + i, j), 1)
            i, j = _grid_items(a1 - a0, m, t, THREADS)
            np.add.at(t1, (n + a0 + i, n + j), 1)
        t2[lo:hi, n:] += 1
        soc[:, 1 + lo:1 + hi] += 1
        for c in range(r, k, C3):
            t2[n + c, :] += 1
    soc[:, 0] += 1  # rank 0's heads
    ntn, ntm = -(-n // T), -(-m // T)
    for tl in range(ntn * ntm):
        I, J = divmod(tl, ntm)
        i, a = np.meshgrid(np.arange(I * T, min(n, I * T + T)),
                           np.arange(J * T, min(m, J * T + T)), indexing="ij")
        t1[i, n + a] += 1
        t1[n + a, i] += 1
    for blk in (t1, t2, t3, soc):
        assert np.all(blk == 1)


@pytest.mark.parametrize("W", [1, 2, 5, 7, 50, 75, 100, 101, 250, 255, 1000, 2000])
def test_divmod_is_exact(W):
    """The float-reciprocal divmod of the flat loops is exact for every item
    of a 2000-row grid (and beyond 2^22 items)."""
    e = np.arange(0, 2000 * W, dtype=np.int64)
    i, j = _divmod_f32(e, W)
    assert np.array_equal(i, e // W) and np.array_equal(j, e % W)
    e = np.arange(2 ** 22, 2 ** 22 + 4 * W, dtype=np.int64)
    i, j = _divmod_f32(e, W)
    assert np.array_equal(i, e // W) and np.array_equal(j, e % W)


# ---- the mirrors ----

def _inputs(B, n, m, k, L, cuts, dtype, seed):
    """Random node slots (float64 numpy): slot values and duals of unit
    scale, ``cuts`` real cuts a slot, per-slot rho, sX, sT."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.5).astype(np.float64)
    cut_x = np.zeros((B, L, n))
    cut_lo = np.zeros((B, L, k))
    cut_hi = np.zeros((B, L, k))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(cuts):
            x = rng.standard_normal(n)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, k), rng.uniform(-0.5, 0.5, k))
            cut_mask[b, l] = 1.0
    lo = -np.ones((B, n, k))
    hi = np.ones((B, n, k))
    st = tadmm.init_admm_state(B, n, m, k, L, dtype, device="cpu")
    for name in ("w1", "w2", "w3", "w4", "wsoc", "wbox", "wa", "wb", "wc",
                 "u1", "u2", "u3", "u4", "usoc", "ubox", "ua", "ub", "uc", "X", "Y", "Th", "U"):
        v = rng.standard_normal(tuple(getattr(st, name).shape)) * 0.3
        if v.ndim == 3 and v.shape[-1] == v.shape[-2]:
            v = 0.5 * (v + np.swapaxes(v, -1, -2))
        if name in ("wa", "wb", "ua", "ub"):
            v = v * cut_mask[..., None]
        if name in ("wc", "uc"):
            v = v * cut_mask
        getattr(st, name).copy_(torch.as_tensor(v))
    st.rho.copy_(torch.as_tensor(rng.uniform(0.01, 0.1, B)))
    st.sX.copy_(torch.as_tensor(rng.uniform(1.0, 3.0, B)))
    st.sT.copy_(torch.as_tensor(rng.uniform(1.0, 3.0, B)))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    batch = NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask), f(lo), f(hi))
    c = tadmm.make_consts(f(A), f(mask), batch, st, n, m, k, 40.0, 1.7, 0.01, dtype)
    # G1^-1 as make_consts forms it for a CUDA state
    c.G1i = tadmm.g1_factors(tadmm._gram1(batch, k, dtype), True)[1]
    acc = [f(rng.standard_normal(tuple(x.shape)) * 0.1) for x in (st.ua, st.ub, st.uc)]
    return c, st, acc


def _bands(n, C):
    return [_band(n, C, r) for r in range(C)]


def k2_mirror(c, st, plan):
    """K2's order of work: (X, Y, Ths, U)."""
    b = c.batch
    n, m, k, L = c.n, c.m, c.k, c.L
    dt, f64 = st.w1.dtype, torch.float64
    cm = b.cut_mask
    x = b.cut_x * cm[..., None]
    rho = st.rho[:, None, None]
    sX, sT = st.sX[:, None, None], st.sT[:, None, None]
    bc = torch.sum(-b.cut_lo * b.cut_hi, dim=-1)
    yc = (st.wc - st.uc - bc) * cm
    lohi = b.cut_lo + b.cut_hi
    ya = (st.wa - st.ua - (-b.cut_lo)) * cm[..., None]
    yb = (st.wb - st.ub - b.cut_hi) * cm[..., None]
    coef = ya - yb + yc[..., None] * lohi
    cl = lohi * cm[..., None]
    y4 = st.w4 - st.u4 - k
    r1 = st.w1 - st.u1
    # X and Theta (no correction)
    X = (rho * (sX * 2.0 * r1[:, :n, n:]) + sX * c.maskA) / (
        c.mask * (sX * sX) + rho * 2.0 * sX * sX)
    eye_m = torch.eye(m, dtype=dt)
    z = (rho * (sT * r1[:, n:, n:]) - eye_m * (sT * 0.5 / c.gamma)) / (rho * sT * sT)
    Th = 0.5 * (z + z.transpose(-1, -2))
    # the band of sym(zY) from r + r'
    r = r1[:, :n, :n] + (st.w2 - st.u2)[:, :n, :n] - (st.w3 - st.u3)
    eye_n = torch.eye(n, dtype=dt)
    cc = torch.einsum("bl,bli,blj->bij", yc, x, x)
    g = 0.5 * (r + r.transpose(-1, -2)) - cc + eye_n * (1.0 - y4)[:, None, None]
    zY = (rho * g) / (3.0 * rho)
    gU = (2.0 * (st.w2 - st.u2)[:, :n, n:] + (st.wsoc - st.usoc)[..., 1:].transpose(-1, -2)
          + (st.wbox - st.ubox) + torch.einsum("bli,blj->bij", x.to(f64), coef.to(f64)).to(dt))
    zU = (rho * gU) / (4.0 * rho)
    # partials per CTA band in float64, added in rank order
    zd, xd, ud = zY.to(f64), x.to(f64), zU.to(f64)
    tot = 0.0
    for lo, hi in _bands(n, plan["k2_cluster"]):
        tr = torch.diagonal(zd, dim1=-2, dim2=-1)[:, lo:hi].sum(-1)
        ch = torch.einsum("bij,bli,blj->bl", zd[:, lo:hi], xd[:, :, lo:hi], xd)
        v = torch.einsum("bli,bij->blj", xd[:, :, lo:hi], ud[:, lo:hi])
        part = torch.cat([tr[:, None], ch, v.reshape(v.shape[0], -1)], dim=-1)
        tot = part if isinstance(tot, float) else tot + part
    B = zY.shape[0]
    vt = tot[:, 1 + L:].reshape(B, L, k)
    s = torch.cat([tot[:, :1].to(dt), (-tot[:, 1:1 + L] + torch.einsum(
        "blj,blj->bl", cl.to(f64), vt)).to(dt), math.sqrt(2.0) * tot[:, 1 + L:].to(dt)], dim=-1)
    t = st.rho[:, None] * torch.einsum("bpq,bq->bp", c.G1i.to(f64), s.to(f64)).to(dt)
    vY = t[:, :1, None] * eye_n - torch.einsum("bl,bli,blj->bij", t[:, 1:1 + L], x, x)
    Y = zY - vY / (3.0 * rho)
    vU = (torch.einsum("bl,bli,blj->bij", t[:, 1:1 + L].to(f64), xd, cl.to(f64)).to(dt)
          + math.sqrt(2.0) * torch.einsum("bli,blj->bij", xd, t[:, 1 + L:].reshape(B, L, k)
                                          .to(f64)).to(dt))
    U = zU - vU / (4.0 * rho)
    return X, Y, Th, U


def _omc_zstep(c, st):
    """omc's adjoint (``_adjoint``) and Woodbury z-step (``solve_z`` with
    ``_Vt_apply`` / ``_V_apply``, restated as in its make_admm_solver), then
    the symmetrisation."""
    J = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    b = c.batch
    jb = JNodeBatch(*[J(t) for t in b.fields()])
    n, m, k = c.n, c.m, c.k
    o = c.offs
    cm = J(b.cut_mask)
    sX, sT = J(st.sX)[:, None, None], J(st.sT)[:, None, None]
    rho = J(st.rho)
    r3 = rho[:, None, None]
    gX, gY, gTh, gU = jadmm._adjoint(
        jb, J(st.w1 - st.u1 - o[0]), J(st.w2 - st.u2 - o[1]), J(st.w3 - st.u3 - o[2]),
        J(st.w4 - st.u4 - o[3]), J(st.wsoc - st.usoc - o[4]), J(st.wbox - st.ubox - o[5]),
        J(st.wa - st.ua - o[6]) * cm[..., None], J(st.wb - st.ub - o[7]) * cm[..., None],
        J(st.wc - st.uc - o[8]) * cm, n, m, k, sX, sT)
    mask = J(c.mask)
    G1c = jnp.linalg.cholesky(jadmm._gram1(jb, k, gY.dtype))
    zX = (r3 * gX - J(c.cX)) / (mask[None] * (sX * sX) + r3 * 2.0 * sX * sX)
    zY = r3 * gY / (3.0 * r3)
    zTh = (r3 * gTh - J(c.cTh)) / (r3 * sT * sT)
    zU = r3 * gU / (4.0 * r3)
    s = jadmm._Vt_apply(jb, zY, zU, k)
    t = rho[:, None] * jsl.cho_solve((G1c, True), s[..., None])[..., 0]
    vY, vU = jadmm._V_apply(jb, t, n, k)
    zY = zY - vY / (3.0 * r3)
    zU = zU - vU / (4.0 * r3)
    sym = lambda a: 0.5 * (a + jnp.swapaxes(a, -1, -2))  # noqa: E731
    return [np.asarray(a) for a in (zX, sym(zY), sym(zTh), zU)]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# float64: the mirror's sums in another order than omc's; float32: the
# smoke's bar for K2 and K3 against their plain versions (1e-6)
TOL = {"float64": 1e-10, "float32": 1e-6}


@pytest.mark.parametrize("shor", [False, True], ids=["base", "shor"])
@pytest.mark.parametrize("cuts", [0, 3], ids=["no_cuts", "cuts"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n,m,k,L", [(3, 14, 11, 1, 6), (2, 20, 20, 2, 8), (4, 9, 13, 3, 5)])
def test_k2_mirror_matches_omc(B, n, m, k, L, dtype, cuts, shor):
    """K2's order of work at a forced cluster of 4 (three band widths, ragged
    tiles) against omc's adjoint and z-step; the shor variant's Y and U are
    the same z-step's."""
    tdt = getattr(torch, dtype)
    c, st, _ = _inputs(B, n, m, k, L, cuts, tdt, 7 + B + n)
    plan = tadmm.k2k3_plan(B, n, m, k, L, cluster=4)
    got = k2_mirror(c, st, plan)
    ref = _omc_zstep(c, st)
    pairs = list(zip(got, ref))
    if shor:  # Y and U only
        pairs = [pairs[1], pairs[3]]
    for a, b in pairs:
        assert _rel(a.numpy(), b) <= TOL[dtype]
    # the plain version the smoke holds the kernel to agrees too
    for a, b in zip(got, tadmm.zstep_plain(c, st)):
        assert _rel(a.numpy(), b.numpy()) <= TOL[dtype]


def k3_mirror(c, st, acc, plan):
    """K3's order of work: (t1, t2, t3, rest, acc_new) as cone_step_plain
    returns them, and the forward values (w4, wa, wb, wc) of its sums."""
    b = c.batch
    n, k, L = c.n, c.k, c.L
    dt, f64 = st.w1.dtype, torch.float64
    al, om = c.alpha, 1.0 - c.alpha
    f = tadmm._forward(b, st.X, st.Y, st.Th, st.U, k, st.sX[:, None, None],
                       st.sT[:, None, None])
    t1 = (al * f[0] + om * st.w1) + st.u1
    t2 = (al * f[1] + om * st.w2) + st.u2
    t3 = (al * f[2] + om * st.w3) + st.u3
    tsoc = (al * torch.cat([torch.ones_like(st.wsoc[..., :1]), st.U.transpose(-1, -2)], -1)
            + om * st.wsoc) + st.usoc
    # the partials per CTA band in float64, added in rank order
    Yd, xd, Ud = st.Y.to(f64), b.cut_x.to(f64), st.U.to(f64)
    tot = 0.0
    for lo, hi in _bands(n, plan["k3_cluster"]):
        tr = torch.diagonal(Yd, dim1=-2, dim2=-1)[:, lo:hi].sum(-1)
        xyx = torch.einsum("bij,bli,blj->bl", Yd[:, lo:hi], xd[:, :, lo:hi], xd)
        sq = torch.sum(tsoc[..., 1 + lo:1 + hi].to(f64) ** 2, dim=-1)
        v = torch.einsum("bli,bij->blj", xd[:, :, lo:hi], Ud[:, lo:hi])
        part = torch.cat([tr[:, None], xyx, sq, v.reshape(v.shape[0], -1)], dim=-1)
        tot = part if isinstance(tot, float) else tot + part
    B = st.Y.shape[0]
    tr = tot[:, 0].to(dt)
    xyx = tot[:, 1:1 + L].to(dt)
    nx = torch.sqrt(tot[:, 1 + L:1 + L + k]).to(dt)
    v = tot[:, 1 + L + k:].reshape(B, L, k).to(dt)
    w4f = k - tr
    waf, wbf = v - b.cut_lo, b.cut_hi - v
    wcf = torch.sum((b.cut_lo + b.cut_hi) * v, -1) + torch.sum(-b.cut_lo * b.cut_hi, -1) - xyx
    t4 = (al * w4f + om * st.w4) + st.u4
    w4 = torch.clamp(t4, min=0.0)
    tt = tsoc[..., :1]
    nj = nx[..., None]
    scale = torch.where(nj > 0, 0.5 * (1.0 + tt / torch.where(nj > 0, nj, 1.0)), 0.0)
    proj = torch.cat([0.5 * (tt + nj), scale * tsoc[..., 1:]], -1)
    wsoc = torch.where(nj <= tt, tsoc, torch.where(nj <= -tt, torch.zeros_like(tsoc), proj))
    tbox = (al * st.U + om * st.wbox) + st.ubox
    wbox = torch.minimum(torch.maximum(tbox, b.U_lo), b.U_hi)
    cm = b.cut_mask
    ta = (al * waf + om * st.wa) + st.ua
    wa = torch.clamp(ta, min=0.0)
    ua = (ta - wa) * cm[..., None]
    tb = (al * wbf + om * st.wb) + st.ub
    wb = torch.clamp(tb, min=0.0)
    ub = (tb - wb) * cm[..., None]
    tc = (al * wcf + om * st.wc) + st.uc
    wc = torch.clamp(tc, min=0.0)
    uc = (tc - wc) * cm
    r3 = st.rho[:, None, None]
    accn = (acc[0] + c.beta * (r3 * ua - acc[0]), acc[1] + c.beta * (r3 * ub - acc[1]),
            acc[2] + c.beta * (st.rho[:, None] * uc - acc[2]))
    rest = (w4, t4 - w4, wsoc, tsoc - wsoc, wbox, tbox - wbox, wa, ua, wb, ub, wc, uc)
    return (t1, t2, t3, rest, accn), (w4f, waf, wbf, wcf)


@pytest.mark.parametrize("cuts", [0, 3], ids=["no_cuts", "cuts"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n,m,k,L", [(3, 14, 11, 1, 6), (2, 20, 20, 2, 8), (4, 9, 13, 3, 5)])
def test_k3_mirror_matches_omc(B, n, m, k, L, dtype, cuts):
    """K3's sums by row bands (x'Yx in float64) against omc's forward map,
    and its whole step against the plain version the smoke holds it to."""
    tdt = getattr(torch, dtype)
    c, st, acc = _inputs(B, n, m, k, L, cuts, tdt, 11 + B + n)
    plan = tadmm.k2k3_plan(B, n, m, k, L, cluster=4)
    (t1, t2, t3, rest, accn), fwd = k3_mirror(c, st, acc, plan)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jb = JNodeBatch(*[J(t) for t in c.batch.fields()])
    ref = jadmm._forward(jb, J(st.X), J(st.Y), J(st.Th), J(st.U), k,
                         J(st.sX)[:, None, None], J(st.sT)[:, None, None])
    for a, r in zip(fwd, (ref[3], ref[6], ref[7], ref[8])):
        assert _rel(a.numpy(), r) <= TOL[dtype]
    p1, p2, p3, prest, pacc = tadmm.cone_step_plain(c, st, acc)
    for a, r in zip((t1, t2, t3) + rest + accn, (p1, p2, p3) + prest + pacc):
        if float(r.abs().max()) == 0.0:
            assert float(a.abs().max()) == 0.0
        else:
            assert _rel(a.numpy(), r.numpy()) <= TOL[dtype]


# one node whose U no longer fits one CTA beside the rest: K3 reads U from
# the input and keeps its band's SOC entries in the slot's own (k3_u
# "global"); the K2 band of zU stays in shared memory at rank 10
BIG_U = [(1, 6000, 6000, 10, 8, torch.float32), (1, 2600, 2600, 10, 8, torch.float64),
         (1, 20000, 20000, 10, 8, torch.float32)]


@pytest.mark.parametrize("B,n,m,k,L,dt", BIG_U)
def test_k2k3_plan_reads_u_from_the_input_past_shared_memory(B, n, m, k, L, dt):
    """k2k3_plan admits the shapes whose U outgrows a CTA (past n k =
    52,509 in float32, 25,230 in float64), with K3's U read from the input
    only where no layout with U staged fits; every U row, SOC entry, box
    entry and t2 row n + c is owned by one CTA of the cluster once."""
    p = tadmm.k2k3_plan(B, n, m, k, L, dtype=dt)
    big = tadmm.K2K3_MAX_SMEM
    C3 = p["k3_cluster"]
    assert p["k3_u"] == "global" and p["k2_u"] == "smem"
    assert all(tadmm.k3_smem_bytes(n, m, k, L, C3, xs, sl, ws, dt) > big
               for xs in (True, False) for sl in (True, False) for ws in (True, False))
    assert p["k3_smem"] == tadmm.k3_smem_bytes(n, m, k, L, C3, p["k3_xs"] == "smem",
                                               p["k3_slots"] == "smem",
                                               p["k3_sums"] == "global", dt, False) <= big
    assert p["k2_smem"] == tadmm.k2_smem_bytes(n, m, k, L, p["k2_cluster"], p["band"] == "smem",
                                               p["k2_xs"] == "smem", p["k2_sums"] == "global",
                                               dt) <= big
    # U's rows (t2's U columns, the SOC and box entries, x_l'U_j) by bands
    rows = np.zeros(n, np.int64)
    for r in range(C3):
        lo, hi = _band(n, C3, r)
        rows[lo:hi] += 1
    assert np.all(rows == 1)
    # t2's rows n + c (U' and I): row c by CTA c mod C, warp c // C
    owner = np.zeros(k, np.int64)
    for r in range(C3):
        for w in range(WARPS):
            for c in range(r + C3 * w, k, C3 * WARPS):
                owner[c] += 1
    assert np.all(owner == 1)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_k2k3_plan_refuses_no_node_whose_state_fits_the_card(dt):
    """At one node of n = m up to 46,000, ranks 1 to 400 and 8 to 2,048
    cuts, wherever the ADMM state's (n + m)^2, (n + k)^2 and n^2 blocks
    (w, u and t of each, X, Y and Theta) fit 80 GB, k2k3_plan admits the
    shape (U, K2's band of zU and the cut vectors leave shared memory
    first)."""
    e = dt.itemsize
    for k in (1, 2, 5, 10, 20, 32, 80, 400):
        for L in (8, 2048):
            for n in (100, 2600, 6000, 10000, 20000, 30000, 46000):
                D1, D2 = 2 * n, n + k
                if e * (3 * D1 * D1 + 3 * D2 * D2 + 3 * n * n + 3 * n * n) > 80e9:
                    continue
                p = tadmm.k2k3_plan(1, n, n, k, L, dtype=dt)
                assert max(p["k2_smem"], p["k3_smem"]) <= tadmm.K2K3_MAX_SMEM


def test_k2k3_plans_of_the_paths_keep_u_in_shared_memory():
    """Every shape the paths ran before keeps U (K3) and the band of zU
    (K2) staged: their plans are those of before."""
    for B, n, k, L in SHAPES:
        for dt in (torch.float32, torch.float64):
            p = tadmm.k2k3_plan(B, n, n, k, L, dtype=dt)
            assert p["k3_u"] == p["k2_u"] == "smem"


def k3_u_mirror(c, st, plan):
    """K3's reads of U in its order of work, CTA by CTA of the cluster:
    from a staged copy (``k3_u`` "smem") or from the input (``k3_u``
    "global", the band's SOC entries then kept in wsoc's own entries
    between the phases).  Returns the U parts of the forward map, f2's U
    columns (B, n, k) and rows (B, k, n), fsoc's (B, k, n), fbox and x_l'U_j
    (float64 partials by band, added in rank order), and the band's tsoc
    entries as the projection reads them back."""
    b = c.batch
    n, k, L = c.n, c.k, c.L
    B = st.U.shape[0]
    C = plan["k3_cluster"]
    glob = plan["k3_u"] == "global"
    al, om = c.alpha, 1.0 - c.alpha
    cols, urows = torch.empty(B, n, k, dtype=st.U.dtype), torch.empty(B, k, n, dtype=st.U.dtype)
    fsoc, fbox = torch.empty(B, k, n, dtype=st.U.dtype), torch.empty(B, n, k, dtype=st.U.dtype)
    tsoc = torch.empty(B, k, n, dtype=st.U.dtype)
    v = torch.zeros(B, L, k, dtype=torch.float64)
    wsoc = st.wsoc.clone()
    for r in range(C):
        flat = st.U.reshape(B, n * k)
        src = flat if glob else flat.clone()  # the staged copy: every CTA its own
        lo, hi = _band(n, C, r)
        for i in range(lo, hi):
            for j in range(k):
                cols[:, i, j] = src[:, i * k + j]
                fsoc[:, j, i] = src[:, i * k + j]
                fbox[:, i, j] = src[:, i * k + j]
                t = (al * src[:, i * k + j] + om * st.wsoc[:, j, 1 + i]) + st.usoc[:, j, 1 + i]
                if glob:
                    wsoc[:, j, 1 + i] = t
                else:
                    tsoc[:, j, i] = t
        part = torch.einsum("bli,bij->blj", b.cut_x[:, :, lo:hi].double(),
                            src.reshape(B, n, k)[:, lo:hi].double())
        v = v + part
        for w in range(WARPS):
            for cc in range(r + C * w, k, C * WARPS):
                for j in range(n):
                    urows[:, cc, j] = src[:, j * k + cc]
    if glob:  # read back after the cluster barrier
        tsoc = wsoc[..., 1:].clone()
    return cols, urows, fsoc, fbox, v, tsoc


@pytest.mark.parametrize("u", ["smem", "global"])
def test_k3_u_reads_match_omc_forward_map(u):
    """At a small shape with K3's U forced to either place: the U parts of
    K3's forward map against omc's, and the band's SOC entries against the
    plain cone step's (w + u)."""
    B, n, m, k, L = 2, 13, 9, 3, 5
    c, st, acc = _inputs(B, n, m, k, L, 3, torch.float64, 71)
    plan = dict(tadmm.k2k3_plan(B, n, m, k, L, cluster=4), k3_u=u)
    cols, urows, fsoc, fbox, v, tsoc = k3_u_mirror(c, st, plan)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jb = JNodeBatch(*[J(t) for t in c.batch.fields()])
    ref = jadmm._forward(jb, J(st.X), J(st.Y), J(st.Th), J(st.U), k,
                         J(st.sX)[:, None, None], J(st.sT)[:, None, None])
    f2 = np.asarray(ref[1])
    assert _rel(cols.numpy(), f2[:, :n, n:]) == 0.0
    assert _rel(urows.numpy(), f2[:, n:, :n]) == 0.0
    assert _rel(fsoc.numpy(), np.asarray(ref[4])[..., 1:]) == 0.0
    assert _rel(fbox.numpy(), np.asarray(ref[5])) == 0.0
    cm = c.batch.cut_mask.numpy()[..., None]
    va = (np.asarray(ref[6]) + c.batch.cut_lo.numpy()) * cm
    assert _rel(v.numpy() * cm, va) <= TOL["float64"]
    rest = tadmm.cone_step_plain(c, st, acc)[3]
    wsoc, usoc = rest[2], rest[3]
    assert _rel(tsoc.numpy(), (wsoc + usoc)[..., 1:].numpy()) <= 1e-15


def test_unsupported_shapes_raise_before_any_launch(monkeypatch):
    from omc_torch import kernels

    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    for shape in ((0, 50, 50, 1, 8), (4, 50, 50, 0, 8), (4, 0, 50, 1, 8), (4, 50, 50, 1, -1),
                  (1, 20000, 20000, 10, 8)):
        if shape[1] == 20000:  # U outgrows a CTA: K3 reads it from the input
            plan = tadmm.k2k3_plan(*shape)
            assert plan["k3_u"] == "global" and plan["k3_smem"] <= tadmm.K2K3_MAX_SMEM
            continue
        with pytest.raises(ValueError):
            tadmm.k2k3_plan(*shape)
    for cluster in (3, 32, 0):
        with pytest.raises(ValueError):
            tadmm.k2k3_plan(4, 50, 50, 1, 8, cluster=cluster)
    with pytest.raises(ValueError):
        tadmm.k2k3_plan(4, 50, 50, 1, 8, band="global")
    # through the wrappers, on a CUDA-typed state of that shape
    c, st, acc = _inputs(2, 12, 12, 1, 4, 2, torch.float32, 3)
    c, st, acc = _fake_cuda(c), _fake_cuda(st), _fake_cuda(acc)
    ts = tuple(_fake_cuda(torch.zeros_like(x)) for x in (st.w1, st.w2, st.w3))
    with pytest.raises(ValueError):
        tadmm.zstep(c, st, cluster=3)
    with pytest.raises(ValueError):
        tadmm.cone_step(c, st, ts, acc, cluster=32)


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


@pytest.mark.parametrize("shor", [False, True], ids=["base", "shor"])
def test_cuda_state_takes_no_plain_version(shor, monkeypatch):
    """On a CUDA-typed state K2's and K3's wrappers launch their kernels or
    raise: neither plain version runs (here, without a GPU, they raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    monkeypatch.setattr(tadmm, "zstep_plain", plain)
    monkeypatch.setattr(tadmm, "cone_step_plain", plain)
    c, st, acc = _inputs(2, 12, 12, 1, 4, 2, torch.float32, 5)
    c, st, acc = _fake_cuda(c), _fake_cuda(st), _fake_cuda(acc)
    ts = tuple(_fake_cuda(torch.zeros_like(x)) for x in (st.w1, st.w2, st.w3))
    with pytest.raises((RuntimeError, AssertionError)):
        tadmm.zstep(c, st, shor=shor)
    with pytest.raises((RuntimeError, AssertionError)):
        tadmm.cone_step(c, st, ts, acc)


def test_param_blocks_are_packed_once_per_operands():
    """K2's and K3's parameter blocks are packed once per operands: the same
    live tensors (and scalars) reuse the block; another tensor, or another
    scalar, packs a new one."""
    calls = []

    def build():
        calls.append(1)
        return object()

    ts = tuple(torch.zeros(3) for _ in range(4))
    a = tadmm._packed(("test", 1), ts, (1.0,), build)
    assert tadmm._packed(("test", 1), ts, (1.0,), build) is a and len(calls) == 1
    ts2 = ts[:2] + (torch.zeros(3),) + ts[3:]
    b = tadmm._packed(("test", 1), ts2, (1.0,), build)
    assert b is not a and len(calls) == 2
    assert tadmm._packed(("test", 1), ts2, (2.0,), build) is not b and len(calls) == 3


@pytest.mark.parametrize("shor", [False, True], ids=["base", "shor"])
def test_k2_k3_param_blocks_point_at_watched_operands(shor):
    """Every pointer in K2's and K3's parameter blocks is an operand the
    reuse test watches (``_k2_tensors``, ``_k3_tensors``): a block cannot
    outlive a tensor it points at.  The blocks carry the plan's choices."""
    from omc_torch import kernels

    B, n, m, k, L = 3, 14, 11, 1, 6
    c, st, acc = _inputs(B, n, m, k, L, 3, torch.float32, 9)
    ts = tuple(torch.zeros_like(x) for x in (st.w1, st.w2, st.w3))
    plan = tadmm.k2k3_plan(B, n, m, k, L)
    p2 = tadmm._k2_params(c, st, shor, plan)
    watched = {t.data_ptr() for t in tadmm._k2_tensors(c, st)}
    for name in kernels._K2_PTRS:
        ptr = getattr(p2, name)
        assert (ptr is None) == (shor and name in ("Xs", "Ths")), name
        assert ptr is None or ptr in watched, name
    assert (p2.C, p2.band, p2.xsmem, p2.ws) == (plan["k2_cluster"], 1, 1, None)
    p3 = tadmm._k3_params(c, st, ts, acc, None)
    watched = {t.data_ptr() for t in tadmm._k3_tensors(c, st, ts, acc)}
    assert all(getattr(p3, name) in watched for name in kernels._K3_PTRS)
    assert (p3.C, p3.xsmem, p3.slsmem, p3.ws) == (plan["k3_cluster"], 1, 1, None)


def test_workspace_is_held_by_its_block(monkeypatch):
    """Where the plan puts the partials in the global workspace, K2's block
    points at a float64 workspace of B ``k2_ws`` doubles that the block
    itself keeps alive (K3's likewise)."""
    import gc

    B, n, m, k, L = 3, 14, 11, 1, 6
    c, st, acc = _inputs(B, n, m, k, L, 3, torch.float32, 13)
    ts = tuple(torch.zeros_like(x) for x in (st.w1, st.w2, st.w3))
    plan = dict(tadmm.k2k3_plan(B, n, m, k, L), k2_ws=37, k3_ws=41)
    p2 = tadmm._k2_params(c, st, False, plan)
    gc.collect()
    assert p2.workspace.dtype == torch.float64 and p2.workspace.numel() == B * 37
    assert p2.ws == p2.workspace.data_ptr()
    monkeypatch.setattr(tadmm, "k2k3_plan", lambda *a, **kw: plan)
    p3 = tadmm._k3_params(c, st, ts, acc, None)
    assert p3.workspace.numel() == B * 41 and p3.ws == p3.workspace.data_ptr()
