"""The CPU side of the Shor k = 1 family in float64 on the card (the float64
builds of K7, K8a and K8b beside those of K2-K6).

The kernels run on the GPU only (``chip_smoke.py`` holds each float64 build
against its plain version there).  Here: (a) the dtype-aware plans of K8a,
K8b and K7 hold every shape the Shor k = 1 loop runs (the smoke's
``SHOR_SHAPES`` and config 2's batch and minor buckets) within a CTA's
shared memory at 8 bytes a value, by recounts of the kernels' layouts, and
the float32 plans are those of before; (b) K7's float64 plain version, the
fused minor step with K4s's Jacobi mirror (``ops.jacobi.k4s_project_psd``,
the order of work of the kernel's exact projection), against the same step
with LAPACK and against one step of ``omc``'s float64 Shor solver on its
eigh route; (c) the wrappers: a float64 state packs the float64 blocks, a
float64 projection-mode launch and a method that does not match the build
raise; (d) the api's Shor relaxation at its defaults (float64) on the CPU
against ``omc``'s."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import omc.api as japi
import omc.sdp.shor as jshor_idx
import omc.tree as jtree
from omc.data import generate_matrix_completion_data
from omc.sdp import admm_shor as jshor
from omc.sdp import relax as jrelax
from omc.sdp import shor_encode as jenc

import omc_torch.api as tapi
import omc_torch.sdp.shor as tshor_idx
import omc_torch.tree as ttree
from omc_torch import convert, kernels
from omc_torch.ops import cones, jacobi, polar
from omc_torch.sdp import admm_shor as tshor
from omc_torch.sdp.admm import make_consts

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
SMEM = 232448  # the most shared memory one CTA may use on an H100
STATIC_SMEM = 48 * 1024  # the most static shared memory a CTA may declare
TILE = tshor.K8A_TILE

# (B, n = m, M5): the smoke's SHOR_SHAPES, then config 2's batch buckets
# (1, 4, 16 and its batch of 32 at n = m = 100) at each minor bucket
SHOR_SHAPES = ((32, 100, 1024), (1, 100, 64), (32, 100, 4096), (1, 50, 4096), (4, 50, 4096))
CONFIG2 = tuple((B, 100, M5) for B in (1, 4, 16, 32) for M5 in (64, 256, 1024, 4096))


def _cdiv(a, b):
    return -(-a // b)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- (a) the plans ----


def _k8a_bytes(n, m, C, Q, elem):
    """k8a_smem of csrc/k8_shor.cu: a coordinates' CTA's column partials
    and t_l (cols each), its tile of zW and W's diagonal (rows x cols
    each), or Theta's two 32 x 33 tiles, whichever is larger, at elem
    bytes a value."""
    rows, cols = _cdiv(n, C), _cdiv(m, Q)
    return elem * max(2 * TILE * (TILE + 1), 2 * cols + 2 * rows * cols)


@pytest.mark.parametrize("B,n,M5", sorted(set(SHOR_SHAPES + CONFIG2)))
def test_k8a_plan_float64_fits_and_is_the_kernels_layout(B, n, M5):
    """At float64 the plan's shared memory is the kernel's layout at 8 bytes
    a value and fits a CTA (Theta's tile pair alone is 16,896 bytes); the
    clusters and column groups are the float32 plan's wherever both fit,
    and the float32 plan's bytes are its layout at 4."""
    p64 = tshor.k8a_plan(B, n, n, M5, dtype=F64)
    p32 = tshor.k8a_plan(B, n, n, M5)
    assert p64["smem"] == _k8a_bytes(n, n, p64["cluster"], p64["groups"], 8) <= SMEM
    assert p64["smem"] >= 2 * TILE * (TILE + 1) * 8 == 16896
    assert p32["smem"] == _k8a_bytes(n, n, p32["cluster"], p32["groups"], 4)
    assert {k: v for k, v in p64.items() if k != "smem"} == {
        k: v for k, v in p32.items() if k != "smem"}
    assert p32 == tshor.k8a_plan(B, n, n, M5, dtype=F32)


@pytest.mark.parametrize("B,n", sorted({(B, n) for B, n, _ in SHOR_SHAPES + CONFIG2}))
def test_k8b_plan_float64_owns_every_coordinate_once(B, n):
    """K8b's float64 grid: a thread takes a pair of coordinates (one 16-byte
    word of each operand), a warp's RSOC values one 16-byte aligned block;
    every coordinate and every RSOC value of the batch owned once, a pair's
    slots the two it can span, the staging within the static limit; the
    float32 plan of before (quads)."""
    m = n
    p = tshor.k8b_plan(B, n, m, F64)
    E, qpc = p["per_thread"], p["qpc"]
    assert E == 2 and qpc in (32, 64, 128) and p["threads"] == tshor.K8B_THREADS
    assert p["smem"] == 3 * 3 * p["threads"] * 16 <= STATIC_SMEM
    tot, nm = B * n * m, n * m
    assert p["coord_ctas"] == _cdiv(_cdiv(tot, E), qpc)
    assert p["grid"] == B * _cdiv(m, 32) + p["coord_ctas"]
    assert qpc == 32 or p["coord_ctas"] >= tshor.K8B_TARGET_CTAS
    coord = np.zeros(tot, np.int64)
    rsoc = np.zeros(3 * tot, np.int64)
    lane = np.arange(32)
    for x in range(p["coord_ctas"]):
        for warp in range(p["threads"] // 32):
            c0 = E * (x * qpc + 32 * warp)
            if 32 * warp >= qpc or c0 >= tot:
                continue
            cnt = min(32 * E, tot - c0)
            assert (3 * c0 * 8) % 16 == 0  # the warp's block starts 16-byte aligned
            rsoc[3 * c0:3 * c0 + 3 * cnt] += 1
            for q in c0 + E * lane:
                rem = min(E, tot - q) if q < tot else 0
                coord[q:q + rem] += 1
                if rem:
                    b0 = q // nm
                    hi = np.arange(q, q + rem) >= (b0 + 1) * nm
                    assert np.array_equal(b0 + hi, np.arange(q, q + rem) // nm)
                    assert (q * 8) % 16 == 0 or rem < E
    assert np.all(coord == 1) and np.all(rsoc == 1)
    p32 = tshor.k8b_plan(B, n, m)
    assert p32 == tshor.k8b_plan(B, n, m, F32) and p32["per_thread"] == 4
    assert p32["coord_ctas"] == _cdiv(_cdiv(tot, 4), p32["qpc"])


@pytest.mark.parametrize("B,n,M5", SHOR_SHAPES)
def test_k7_plan_float64_stages_each_minor_once(B, n, M5):
    """K7's float64 launch: 64 minors a CTA, the three staged blocks (w5,
    u5, acc; 25 doubles a minor) 38,400 bytes of static shared memory, each
    CTA's block 16-byte aligned, every minor of the batch one thread's; the
    float32 launch of before (128 minors, 38,400 bytes of floats)."""
    N = B * M5
    p = tshor.k7_plan(N, F64)
    assert p["threads"] == 64 and p["smem"] == 3 * 64 * 25 * 8 == 38400 <= STATIC_SMEM <= SMEM
    assert p["ctas"] == _cdiv(N, 64)
    owned = np.zeros(N, np.int64)
    for x in range(p["ctas"]):
        base = x * p["threads"]
        assert (base * 25 * 8) % 16 == 0
        owned[base:base + min(p["threads"], N - base)] += 1
    assert np.all(owned == 1)
    assert tshor.k7_plan(N) == dict(threads=128, ctas=_cdiv(N, 128), smem=38400)


# ---- (b) K7's float64 plain version ----


def _setup(n, m, M5, B=2, L=4, seed=0):
    """Two node slots of a rank-1 instance with its fully observed 2x2
    minors split between them, random slot values and duals, per-slot rho
    and scales, in float64 (omc's leaves)."""
    rng = np.random.default_rng(seed)
    A, idx = generate_matrix_completion_data(1, n, m, int(0.5 * n * m), seed=3)
    A, mask = np.ascontiguousarray(A), np.ascontiguousarray(idx, dtype=np.float64)
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    minors = [allm[:M5 - 5], allm[M5 - 5:2 * M5 - 30]]
    socs = [jshor_idx.shor_soc_complement(n, m, mm) for mm in minors]
    sbj = jenc.pack_shor_batch(n, m, minors, socs, M5, n * m)
    lo, hi = jtree.root_box(n, 1)
    bl = [np.zeros((B, L, n)), np.zeros((B, L, 1)), np.zeros((B, L, 1)), np.zeros((B, L)),
          np.broadcast_to(lo, (B, n, 1)).copy(), np.broadcast_to(hi, (B, n, 1)).copy()]
    like = jshor.init_shor_state(B, n, m, 1, L, M5, n * m, jnp.float64, rho=0.05,
                                 sX=1.7, sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(like)]
    for i in list(range(18)) + list(range(26, 38)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.05, 0.02])  # per-slot rho
    return A, mask, bl, sbj, leaves, like, (n, m, B, L, M5)


def _port(A, mask, bl, sbj, leaves, shape, ub):
    n, m, B, L, M5 = shape
    st = convert.shor_state_from_numpy(leaves, dtype=F64, device="cpu")
    sb = convert.shor_batch_from_numpy(list(sbj), dtype=F64, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=F64, device="cpu"), st.core, n, m, 1,
                    20.0, 1.6, 0.01, F64)
    return c, tshor.make_shor_consts(c, sb, st.core, ub), st


def _mirror(seen):
    def proj(t):
        P, sweeps = jacobi.k4s_project_psd(t)
        seen.update(t5=t, sweeps=sweeps)
        return P
    return proj


@pytest.mark.parametrize("M5", [64, 1024])
def test_k7_float64_plain_version_matches_lapack(M5):
    """The fused minor step with K4s's Jacobi mirror (K7's float64 order of
    work) against the same step with LAPACK's projection: w5 within
    1e-12 max|lambda| of each minor's t5, u5 and the EMA within 1e-12 of
    the same scale; the sweeps within the cap."""
    n = m = 10 if M5 == 64 else 30
    A, mask, bl, sbj, leaves, _, shape = _setup(n, m, M5)
    c, sc, st = _port(A, mask, bl, sbj, leaves, shape, 30.0)
    acc5 = 0.1 * torch.ones_like(st.u5)
    seen = {}
    got = tshor.minor_step_plain(c, sc, st, acc5, _mirror(seen))
    ref = tshor.minor_step_plain(c, sc, st, acc5, cones.project_psd)
    lam = torch.linalg.eigvalsh(0.5 * (seen["t5"] + seen["t5"].transpose(-1, -2)))
    scale = lam.abs().amax(-1)[..., None, None]
    for a, b in zip(got, ref):
        assert float(((a - b).abs() / scale).max()) <= 1e-12
    assert int(seen["sweeps"].max()) <= jacobi.MAX_SWEEPS
    assert seen["t5"].shape == (2, M5, 5, 5)


@pytest.fixture(scope="module")
def omc_step():
    """One iteration of omc's float64 Shor solver on its eigh route (its
    returned w5, u5 are that iteration's minor step, at its z-step's X, W
    and v) and the port's constants and state on the same inputs, with
    omc's primal in place."""
    A, mask, bl, sbj, leaves, like, shape = _setup(10, 12, 64)
    n, m, B, L, M5 = shape
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshor.make_shor_solver(n, m, L, M5, n * m, 20.0, dtype=jnp.float64, iters=1,
                                psd_method="eigh", check_every=1, ema_iters=100)
    state = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, _ = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
               jshor.shor_batch_to_device(sbj, jnp.float64), ub, state)
    c, sc, st = _port(A, mask, bl, sbj, leaves, shape, ub)
    for name in ("W", "v1", "v2", "v3"):
        getattr(st, name).copy_(torch.as_tensor(np.array(getattr(fj, name))))
    st.core.X.copy_(torch.as_tensor(np.array(fj.core.X)))
    return (c, sc, st), [np.asarray(fj.w5), np.asarray(fj.u5)]


def test_k7_float64_plain_version_matches_omc_step(omc_step):
    """K7's float64 order of work (the fused step with K4s's Jacobi mirror)
    on omc's primal: w5 and u5 within 1e-10 relative of one iteration of
    omc's float64 Shor solver, which projects the minors with eigh."""
    (c, sc, st), ref = omc_step
    seen = {}
    w5, u5, _ = tshor.minor_step_plain(c, sc, st, torch.zeros_like(st.u5), _mirror(seen))
    assert _rel(w5.numpy(), ref[0]) <= 1e-10
    assert _rel(u5.numpy(), ref[1]) <= 1e-10
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
def launched(monkeypatch):
    """The launches the wrappers make (key, entry point, block), none run."""
    got = []
    monkeypatch.setattr(kernels, "launch", lambda key, fn, prm, dev: got.append((key, fn, prm)))
    return got


def _state64():
    A, mask, bl, sbj, leaves, _, shape = _setup(10, 12, 64)
    return tuple(_fake_cuda(x) for x in _port(A, mask, bl, sbj, leaves, shape, 30.0))


def test_float64_state_launches_the_float64_builds(launched):
    """A float64 CUDA-typed state packs the float64 blocks of K8a, K7 and
    K8b (double scalars), points them at the float64 operands and the int32
    tables, and calls the ..._f64 entry points, with the float64 plans."""
    c, sc, st = _state64()
    acc5, acc_r, acc_l = (torch.zeros_like(x) for x in (st.u5, st.ur, st.ul))
    tshor.shor_zstep(c, sc, st)
    tshor.minor_step(c, sc, st, acc5, "eigh")
    tshor.shor_cone_step(c, sc, st, acc_r, acc_l)
    (k8a, f8a, p8a), (k7, f7, p7), (k8b, f8b, p8b) = launched
    assert (k8a, f8a) == ("K8a", "omc_k8a_shor_zstep_f64")
    assert (k7, f7) == ("K7", "omc_k7_minor_psd_f64")
    assert (k8b, f8b) == ("K8b", "omc_k8b_shor_cone_f64")
    assert isinstance(p8a, kernels.K8aParams64) and isinstance(p7, kernels.K7Params64)
    assert isinstance(p8b, kernels.K8bParams64)
    B, n, m = st.core.X.shape
    plan = tshor.k8a_plan(B, n, m, sc.M5, dtype=F64)
    assert (p8a.C, p8a.Q) == (plan["cluster"], plan["groups"])
    assert p8b.qpc == tshor.k8b_plan(B, n, m, F64)["qpc"]
    assert (p7.w, p7.u, p7.acc, p7.t) == (st.w5.data_ptr(), st.u5.data_ptr(),
                                          acc5.data_ptr(), None)
    assert p7.minor_idx == sc.sb.minor_idx.data_ptr() and p8a.xw_ent == sc.sb.xw_ent.data_ptr()
    assert (p7.alpha, p7.beta) == (c.alpha, c.beta) and p8a.R_X == sc.R_X


def test_float64_k7_refuses_projection_mode_and_the_other_method(launched):
    """K7's float64 build has no projection mode (K4s's float64 build serves
    5x5 projections): a float64 batch raises; a float64 state asks
    psd_method="eigh" and a float32 one "ns"; nothing is launched."""
    with pytest.raises(TypeError):
        polar.project_psd_small(_fake_cuda(torch.zeros((4, 5, 5), dtype=F64)))
    c, sc, st = _state64()
    with pytest.raises(ValueError, match='psd_method="eigh"'):
        tshor.minor_step(c, sc, st, torch.zeros_like(st.u5), "ns")
    assert not launched


# ---- (d) the api's Shor relaxation at its defaults ----


def test_shor_relaxation_at_the_defaults_matches_omc():
    """api.matrix_completion_SDP_relaxation(..., add_Shor_valid_inequalities
    =True) with no dtype (float64) and its default 2,000 iterations on a
    6 x 6 node with the [4, 3]-minors, on the CPU, against omc's: bound and
    objective within 1e-8 relative."""
    N = 6
    A, idx = generate_matrix_completion_data(1, N, N, 24, 3)
    lo, hi = ttree.root_box(N, 1)
    nodes = []
    for tree_mod, shor_mod in ((jtree, jshor_idx), (ttree, tshor_idx)):
        minors = shor_mod.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
        shor = tree_mod.ShorInfo(constraints_indexes=minors,
                                 SOC_constraints_indexes=shor_mod.shor_soc_complement(
                                     N, N, minors))
        nodes.append(tree_mod.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi,
                                     LB=-np.inf, depth=0, cuts=[], Shor_info=shor))
    rj = japi.matrix_completion_SDP_relaxation(nodes[0], N, 1, A, idx, 20.0,
                                               add_Shor_valid_inequalities=True)
    rt = tapi.matrix_completion_SDP_relaxation(nodes[1], N, 1, A, idx, 20.0,
                                               add_Shor_valid_inequalities=True, device="cpu")
    for key in ("lower_bound", "objective"):
        assert abs(rt[key] - rj[key]) <= 1e-8 * max(1.0, abs(rj[key])), key
    assert rt["W"].shape == (N, N)
