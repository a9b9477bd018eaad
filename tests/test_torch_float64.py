"""The CPU side of the float64 builds (K2, K3, K4, K4s, K5 and K6 in
``dtype="float64"`` on the card, the base family, PDHG and Halpern).

The kernels run on the GPU only (``chip_smoke.py`` holds each float64 build
against its plain version there).  Here: (a) the dtype-aware plans hold
every float64 shape the smoke runs within one CTA's shared memory, by
independent recounts of the kernels' layouts, and give the float32 plans
of before at float32; (b) the float64 Jacobi mirrors (``ops.jacobi``: the
CTA path's, the block path's, K4s's) against LAPACK and ``omc``'s
``jnp.linalg.eigh`` from d = 2 to 150; (c) the family gate: every family
(base, PDHG, Halpern, Shor k = 1 and k > 1, McCormick) runs float64 on
CUDA, through the gate, its solver's guard (with psd_method="eigh") and
``matrix_completion_branchandbound``'s gate; (d) the
float64 wrappers pick the float64 builds, and a float64
CUDA tensor without a GPU raises (no conversion, no plain path); (e) the
CPU path the card's float64 route mirrors (``psd_method="eigh"``) at the
api's new defaults against ``omc`` in float64."""

import ctypes
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omc.api as japi
import omc.tree as jtree

import omc_torch.api as tapi
import omc_torch.tree as ttree
from omc_torch import kernels
from omc_torch.data import generate_matrix_completion_data
from omc_torch.ops import cones, jacobi, linalg
from omc_torch.sdp import admm, relax

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
SMEM = 232448  # the most shared memory one CTA may use on an H100

# ---- (a) the plans ----

# the smoke's float64 shapes: K2/K3 (B, n, k, L), K4 (B, d, mode), K4s (N,
# D), K5 (B, n), K6 (B, R, O, k); config 3's base path and d = 150 beside
K2K3_F64 = ((64, 50, 1, 8), (1, 50, 1, 8), (8, 12, 1, 8), (8, 16, 1, 8), (8, 20, 1, 8),
            (8, 10, 2, 8), (64, 75, 2, 8))
K4_F64 = [(B, d, mode) for B in (1, 4, 64) for d in (50, 51, 100, 150) for mode in (0, 1, 2)]
K6_F64 = [(B, 50, 50, k) for B in (4, 64) for k in (1, 2, 10)]


def _cdiv(a, b):
    return -(-a // b)


def _k2_layout(n, m, k, L, C, band, xsmem, ws, elem):
    """K2Smem of csrc/k2_zstep.cu, entry by entry: doubles (the partials),
    then values of elem bytes; returns (bytes, workspace doubles a slot)."""
    P, bw, per = 1 + L + L * k, _cdiv(n, C), 8 // elem
    d = 8 * (1 + 8)  # a warp's trace and chunk of chords
    g = 0
    if ws:
        g += 2 * P
    else:
        d += P + (C * P + P if C > 1 else 0)
    f, h = per * d, per * g
    f += L * n if xsmem else 0
    f += L  # the cut mask
    vec = L * k + L * k + P + P  # cl, coef, s, t
    if ws:
        h += vec
    else:
        f += vec
    f += L + bw * k + (P * P if P <= 112 else 0) + 8 * 2 * 16 * 17
    f += bw * (n | 1) if band else 0
    wsr = _cdiv(h, per) if ws else 0
    return f * elem, (C * wsr + _cdiv(P, per) if ws else 0)


def _k3_layout(n, m, k, L, C, xsmem, slsmem, ws, elem):
    """K3Smem of csrc/k3_cone.cu: doubles, then values of elem bytes."""
    NP = 1 + L + k + L * k
    d = 8 * (1 + 8) + (0 if ws else NP + (C * NP + NP if C > 1 else 0))
    d += L * n if xsmem else 0
    f = (8 // elem) * d + n * k + k + k * _cdiv(n, C) + 8 * 16 * 17
    f += 8 * L * k + 4 * L + 2 if slsmem else 0
    return f * elem


@pytest.mark.parametrize("B,n,k,L", K2K3_F64)
def test_k2k3_plan_float64_fits_and_is_the_kernels_layout(B, n, k, L):
    plan = admm.k2k3_plan(B, n, n, k, L, dtype=F64)
    b2, ws2 = _k2_layout(n, n, k, L, plan["k2_cluster"], plan["band"] == "smem",
                         plan["k2_xs"] == "smem", plan["k2_sums"] == "global", 8)
    b3 = _k3_layout(n, n, k, L, plan["k3_cluster"], plan["k3_xs"] == "smem",
                    plan["k3_slots"] == "smem", plan["k3_sums"] == "global", 8)
    assert plan["k2_smem"] == b2 <= SMEM and plan["k3_smem"] == b3 <= SMEM
    assert plan["k2_ws"] == ws2
    # the float64 layout holds every value of T in 8 bytes: more than float32's
    p32 = admm.k2k3_plan(B, n, n, k, L)
    assert plan["k2_smem"] > p32["k2_smem"] or plan["k2_cluster"] != p32["k2_cluster"]


@pytest.mark.parametrize("n,k,L,C,band,xsmem,ws", [
    (n, k, L, C, band, xs, ws)
    for n, k, L, C in ((12, 1, 8, 8), (50, 1, 8, 16), (75, 2, 32, 4), (250, 5, 8, 8),
                       (250, 10, 512, 16), (1000, 10, 8, 16))
    for band, xs, ws in itertools.product((False, True), repeat=3)])
def test_k2_k3_smem_formulas_at_both_dtypes(n, k, L, C, band, xsmem, ws):
    """The plans' byte counts are the kernels' layouts at 4 and 8 bytes a
    value; at float32 they are the counts of before (4 bytes a float, two a
    double)."""
    for dt, elem in ((F32, 4), (F64, 8)):
        b2, ws2 = _k2_layout(n, n, k, L, C, band, xsmem, ws, elem)
        assert admm.k2_smem_bytes(n, n, k, L, C, band, xsmem, ws, dt) == b2
        assert admm.k2_ws_doubles(n, n, k, L, C, dt) == _k2_layout(n, n, k, L, C, False, False,
                                                                   True, elem)[1]
        assert admm.k3_smem_bytes(n, n, k, L, C, xsmem, band, ws, dt) == _k3_layout(
            n, n, k, L, C, xsmem, band, ws, elem)
    P = 1 + L + L * k
    sums = 0 if ws else 2 * (2 + C if C > 1 else 1) * P + 2 * L * k + 2 * P
    old = 4 * (2 * 8 * 9 + sums + (L * n if xsmem else 0) + 2 * L + _cdiv(n, C) * k
               + (P * P if P <= 112 else 0) + 8 * 2 * 16 * 17 + (_cdiv(n, C) * (n | 1) if band else 0))
    assert admm.k2_smem_bytes(n, n, k, L, C, band, xsmem, ws) == old
    assert admm.k2_ws_doubles(n, n, k, L, C) == C * (3 * P + L * k) + (P + 1) // 2


@pytest.mark.parametrize("B,d,mode", K4_F64)
def test_k4_plan_float64(B, d, mode):
    """In float64 the tridiagonal path takes every mode of order 32..234
    (its reduction CTA holds 6 d + 8 doubles and the packed float64
    triangle; its workspace 5 d + 8 doubles a matrix, and two d x d blocks
    with vectors), but never K5's U U' - Y; the CTA path takes what fits
    (d <= 118 with vectors, 167 without, the head and A, V at 8 bytes a
    slot), else the block path, whose workspace is counted at 8 bytes a
    value."""
    plan = cones.k4_plan(B, d, mode, dtype=F64)
    head = 6 * ((d + 1) // 2) + 32 + 3 * d + 1
    cta_bytes = 8 * (head + d * (d | 1) * (2 if mode else 1))
    assert cones.k4_cta_fits(d, mode, F64) == (cta_bytes <= SMEM)
    assert cones.k4_cta_fits(d, mode, F64) == (d <= (167 if mode == 0 else 118))
    assert plan["path"] == "tri"
    tri_bytes = 8 * (6 * d + 8 + d * (d + 1) // 2)
    assert plan["smem_bytes"] == tri_bytes <= SMEM
    assert plan["workspace_floats"] == B * (5 * d + 8 + (2 * d * d if mode else 0))
    assert plan["workspace_bytes"] == 8 * plan["workspace_floats"]
    sep = cones.k4_plan(B, d, mode, dtype=F64, sep=True)
    assert sep["path"] == ("cta" if cta_bytes <= SMEM else "block16")
    if sep["path"] == "cta":
        assert sep["smem_bytes"] == cta_bytes <= SMEM and sep["workspace_floats"] == 0
    else:
        geo = cones.k4_block_geometry(d, mode, F64)
        assert sep["workspace_floats"] == 16 + B * geo["mat_floats"]
        assert sep["workspace_bytes"] == 8 * sep["workspace_floats"]
        # the block path's CTA: 8 warps of three 32 x 36 tiles of doubles
        assert 8 * 3 * 32 * 36 * 8 <= SMEM


@pytest.mark.parametrize("B", [1, 4, 64, 128])
@pytest.mark.parametrize("d", [12, 50, 51, 100, 150, 200, 237, 238, 500])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_k4_plan_float32_unchanged(B, d, mode):
    """At float32 the plan is the one of before: the CTA path where it wins
    and A (and V) fit at 4 bytes a slot."""
    head = 6 * ((d + 1) // 2) + 32 + 3 * d + 1
    fits = 4 * (head + d * (d | 1) * (2 if mode else 1)) <= SMEM
    wins = d <= 150 if mode == 0 else (d <= 100 and B >= 64)
    plan = cones.k4_plan(B, d, mode)
    assert plan == cones.k4_plan(B, d, mode, dtype=F32)
    assert plan["path"] == ("cta" if wins and fits else "block16")
    assert cones.k4_cta_fits(d, mode) == fits


@pytest.mark.parametrize("D", range(1, 9))
def test_k4s_plan_doubles_its_staging(D):
    p32, p64 = cones.k4s_plan(4 * 4096, D), cones.k4s_plan(4 * 4096, D, F64)
    assert p32["smem_bytes"] == 4 * 128 * ((D * D) | 1)  # as before
    assert p64["smem_bytes"] == 2 * p32["smem_bytes"] <= SMEM
    assert p64["stride"] == p32["stride"] and p64["ctas"] == p32["ctas"]


@pytest.mark.parametrize("B,d", [(64, 50), (1, 50), (4, 100), (4, 224), (4, 225), (4, 250),
                                 (4, 309), (4, 400)])
def test_k5_plan_float64_never_takes_the_float32_triangle(B, d):
    plan = relax.k5_plan(B, d, dtype=F64)
    if relax.k5_smem_bytes(d, "tridiag64"):
        assert plan["path"] == "tridiag64" and plan["smem_bytes"] <= SMEM
    else:  # beyond d = 224: K4's paths in float64
        assert plan["path"] in cones.K4_PATHS
        assert plan["k4"] == cones.k4_plan(B, d, 2, plan["path"], F64)
    with pytest.raises(ValueError):
        relax.k5_plan(B, d, "tridiag32", F64)
    # float32 as before: the float64 triangle, else the float32 one
    p32 = relax.k5_plan(B, d)
    want = "tridiag64" if d <= 224 else ("tridiag32" if d <= 309 else p32["path"])
    assert p32["path"] == want


def _k6_smem(path, k, S, W, rpw, elem):
    """K6's smem_floats of csrc/k6_altmin.cu at elem bytes a value."""
    vw = 16 // elem
    if path == "slots":
        c = (rpw * k + vw - 1) // vw * vw
        return elem * 2 * (32 * (c + (vw if (c // vw) % 2 == 0 else 0)) + 2 * W * rpw)
    ch = min(rpw, 32)
    stage = W * 2 * ch * 33 + S * W * ch * ((k + 3) // 4 * 4)
    comb = S * (W - 1) * (k * (k + 1) // 2 + k) * 32
    return elem * max(stage, comb)


@pytest.mark.parametrize("B,R,O,k", K6_F64 + [(64, 1000, 1000, 10), (32, 512, 50, 3)])
def test_k6_plan_float64(B, R, O, k):
    for path in (None,) + linalg.K6_PATHS:
        try:
            p = linalg.k6_plan(B, R, O, k, path, F64)
        except ValueError:
            assert path == "slots" and R * k % 2
            continue
        assert p["smem_bytes"] == _k6_smem(p["path"], k, p["S"], p["W"], p["rpw"], 8) <= SMEM
        if p["path"] == "slots":
            assert p["W"] <= linalg.K6_SLOTS_MAX_WARPS_F64  # the float64 build's registers
        if path != "slots" or R * k % 4 == 0:  # the float32 slots path: 4 floats a piece
            p32 = linalg.k6_plan(B, R, O, k, path)
            assert p32["smem_bytes"] == _k6_smem(p32["path"], k, p32["S"], p32["W"],
                                                 p32["rpw"], 4)


# ---- (b) the float64 Jacobi mirrors against LAPACK and omc ----


def _spectra(rng, d, nb=3):
    """Symmetric (nb, d, d) float64 matrices Q diag(lam) Q': a generic
    spectrum, one with a cluster of equal, of 1e-9-close and of zero
    eigenvalues, and a rank-deficient PSD one."""
    Q = np.linalg.qr(rng.standard_normal((nb, d, d)))[0]
    lam = rng.uniform(-1.0, 1.0, (nb, d))
    c = max(1, d // 4)
    lam[1, :c] = 0.5
    lam[1, c:2 * c] = -0.3 + 1e-9 * np.arange(c)
    lam[1, 2 * c:3 * c] = 0.0
    lam[2] = np.abs(lam[2])
    lam[2, d // 2:] = 0.0
    return np.einsum("bik,bk,bjk->bij", Q, lam, Q)


def _hold(M, w, V, sweeps):
    """Eigenvalues within 1e-12 max|lambda| of LAPACK's and of omc's jnp
    eigh, eigenvectors with a residual and an orthogonality within 1e-12
    sqrt(d), no sweep cap."""
    d = M.shape[-1]
    w_np = np.linalg.eigh(M)[0]
    w_jnp = np.asarray(jnp.linalg.eigh(jnp.asarray(M))[0])
    scale = np.max(np.abs(w_np), axis=-1, keepdims=True)
    order = np.argsort(w, axis=-1, kind="stable")
    w = np.take_along_axis(w, order, -1)
    V = np.take_along_axis(V, order[:, None, :], -1)
    assert np.all(np.abs(w - w_np) <= 1e-12 * scale)
    assert np.all(np.abs(w - w_jnp) <= 1e-12 * scale)
    res = np.einsum("bij,bjk->bik", M, V) - V * w[:, None, :]
    assert np.all(np.linalg.norm(res, axis=(-2, -1)) <= 1e-12 * np.sqrt(d) * scale[:, 0])
    eye = np.eye(d)
    assert np.all(np.linalg.norm(np.swapaxes(V, -1, -2) @ V - eye, axis=(-2, -1))
                  <= 1e-12 * np.sqrt(d))
    assert np.all(sweeps <= jacobi.MAX_SWEEPS)


@pytest.mark.parametrize("d", [2, 3, 24, 64, 101, 118, 150])
def test_float64_cta_mirror_matches_lapack_and_omc(d):
    """K4's CTA path (and K5's Jacobi route) in float64: DBL_EPSILON's
    stopping rule, the kernel's cap of MAX_SWEEPS."""
    M = _spectra(np.random.default_rng(d), d)
    w, V, sweeps = jacobi.jacobi_eigh(torch.as_tensor(M))
    _hold(M, w.numpy(), V.numpy(), sweeps.numpy())


@pytest.mark.parametrize("d", [24, 150])
def test_float64_block_mirror_matches_lapack_and_omc(d):
    """K4's block path in float64 (FP64 tile products, E in float64)."""
    M = _spectra(np.random.default_rng(100 + d), d)
    w, V, sweeps = jacobi.jacobi_eigh_blocked(torch.as_tensor(M))
    _hold(M, w.numpy(), V.numpy(), sweeps.numpy())


@pytest.mark.parametrize("D", range(2, 9))
def test_float64_k4s_mirror_matches_lapack_and_omc(D):
    """K4s in float64: its rotation at double's epsilon, scaled by a power
    of two in double's range."""
    M = _spectra(np.random.default_rng(200 + D), D, nb=64)
    w, V, sweeps = jacobi.k4s_eigh(torch.as_tensor(M))
    _hold(M, w.numpy(), V.numpy(), sweeps.numpy())


# ---- (c) the family gate ----

ALL = ("base", "pdhg", "halpern", "shor", "shor_k", "mccormick")


@pytest.mark.parametrize("family", ALL)
def test_gate_float32_runs_every_family(family):
    kernels.require_cuda_dtype(family, F32)


@pytest.mark.parametrize("family", ALL)
def test_gate_float64(family):
    """Every family, McCormick included, has float64 builds of all its
    kernels: the gate passes float64."""
    assert family in kernels.FLOAT64_FAMILIES
    kernels.require_cuda_dtype(family, F64)


def test_gate_refuses_other_dtypes_and_families():
    with pytest.raises(ValueError):
        kernels.require_cuda_dtype("base", torch.float16)
    with pytest.raises(ValueError):
        kernels.require_cuda_dtype("nope", F32)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the CUDA branches
    on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def full_fp32(monkeypatch):
    """The solvers' CUDA guards first require TF32 off (as entry_device
    sets it on the card)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _solver(family):
    from omc_torch.sdp.admm_shor import make_shor_solver
    from omc_torch.sdp.mccormick import make_mccormick_solver
    from omc_torch.sdp.shor_k import make_shor_k_solver

    if family == "shor":
        return make_shor_solver(6, 6, 1, 4, 36, 20.0, dtype=F64)
    if family == "shor_k":
        return make_shor_k_solver(6, 6, 2, 1, 4, 36, 20.0, dtype=F64)
    return make_mccormick_solver(6, 6, 1, 20.0, dtype=F64)


class _State:
    """Just what a solver's guard reads: a CUDA-typed rho (and core)."""

    def __init__(self):
        self.rho = torch.ones(1, dtype=F64).as_subclass(_FakeCuda)
        self.core = self


class _PastGuard(Exception):
    pass


@pytest.mark.parametrize("family", ["shor", "shor_k", "mccormick"])
def test_shor_and_mccormick_solver_guards_admit_eigh_and_refuse_ns(family, full_fp32,
                                                                   monkeypatch):
    """The guards of Shor k = 1, Shor k > 1 and McCormick admit float64 on
    CUDA with psd_method="eigh" (their "auto" for float64; the solve then
    reaches its first tensor, here a sentinel) and refuse "ns" with the
    message that names the method."""
    from omc_torch.sdp.admm_shor import make_shor_solver
    from omc_torch.sdp.mccormick import make_mccormick_solver
    from omc_torch.sdp.shor_k import make_shor_k_solver

    solve = _solver(family)
    args = (None,) * (5 if family != "mccormick" else 4)

    def sentinel(*a, **kw):
        raise _PastGuard

    ns = (make_shor_solver(6, 6, 1, 4, 36, 20.0, dtype=F64, psd_method="ns")
          if family == "shor" else
          make_shor_k_solver(6, 6, 2, 1, 4, 36, 20.0, dtype=F64, psd_method="ns")
          if family == "shor_k" else
          make_mccormick_solver(6, 6, 1, 20.0, dtype=F64, psd_method="ns"))
    with pytest.raises(ValueError, match='psd_method="eigh"'):
        ns(*args, _State())
    monkeypatch.setattr(torch, "as_tensor", sentinel)
    with pytest.raises(_PastGuard):
        solve(*args, _State())


_CUTS = dict(disjunctive_cuts_type="linear", disjunctive_cuts_breakpoints="smallest_1_eigvec")


@pytest.mark.parametrize("kw", [dict(_CUTS, add_Shor_valid_inequalities=True),
                                dict(_CUTS, add_Shor_valid_inequalities=True, k=2),
                                dict(use_disjunctive_cuts=False, disjunctive_cuts_type=None,
                                     disjunctive_cuts_breakpoints=None)])
def test_driver_gates_a_float64_shor_or_mccormick_run_on_cuda_once(kw, monkeypatch, full_fp32):
    """matrix_completion_branchandbound's gate: a float64 Shor run on CUDA
    (k = 1 or k > 1) and a float64 McCormick run pass it, each gated once
    under its own family (the run is stopped right after it, at its first
    log message)."""
    import omc_torch.solve as tsolve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "set_full_fp32", lambda: None)
    kw = dict(kw)
    k = kw.pop("k", 1)
    A, idx = generate_matrix_completion_data(k, 8, 8, 40, 1)
    gated = []
    gate = kernels.require_cuda_dtype

    def spy(family, dtype):
        gate(family, dtype)
        gated.append((family, dtype))

    def sentinel(*a, **kw):
        raise _PastGuard

    monkeypatch.setattr(kernels, "require_cuda_dtype", spy)
    monkeypatch.setattr(tsolve, "add_message", sentinel)
    with pytest.raises(_PastGuard):
        tsolve.matrix_completion_branchandbound(k, A, idx, 20.0, dtype="float64", device="cuda",
                                                verbosity=0, **kw)
    family = ("mccormick" if not kw.get("add_Shor_valid_inequalities")
              else "shor" if k == 1 else "shor_k")
    assert gated == [(family, F64)]


# ---- (d) the float64 wrappers pick the float64 builds, or raise ----


def test_float64_blocks_and_entry_points():
    for cls, (cls64, names) in kernels.FLOAT64_BUILDS.items():
        got = kernels.block(cls, F64)
        assert isinstance(got, cls64) and isinstance(kernels.block(cls, F32), cls)
        f32, f64 = dict(cls._fields_), dict(cls64._fields_)
        assert list(f32) == list(f64)  # the same fields, in the same order
        for name, ctype in f32.items():
            want = ctypes.c_double if ctype is ctypes.c_float else ctype
            assert f64[name] is want, (cls.__name__, name)
        for name in names:
            assert kernels.entry(name, F64) == name + "_f64"
            assert kernels.entry(name, F32) == name
    with pytest.raises(TypeError):
        kernels.block(kernels.K1Params, F64)  # K1 has no float64 build
    with pytest.raises(TypeError):
        kernels.entry("omc_k1_psd_sign", F64)


def test_float64_launches_count_under_their_own_keys(monkeypatch):
    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(kernels, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    before = dict(kernels.LAUNCHES)
    kernels.launch("K4", "omc_k4_jacobi_f64", kernels.K4Params64(), torch.device("cuda", 0))
    kernels.launch("K4", "omc_k4_jacobi", kernels.K4Params(), torch.device("cuda", 0))
    assert kernels.LAUNCHES["K4_f64"] == before["K4_f64"] + 1
    assert kernels.LAUNCHES["K4"] == before["K4"] + 1


class _PlainCalled(Exception):
    pass


def _shor64(call):
    """A float64 Shor k = 1 step's wrapper (K7, K8a or K8b) on a small
    CUDA-typed state: 6 x 6, one node slot, its fully observed minors."""
    import dataclasses

    from omc_torch.sdp import admm_shor
    from omc_torch.sdp.admm import make_consts
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.sdp.shor import (
        generate_rank1_matrix_completion_Shor_constraints_indexes,
        shor_soc_complement,
    )
    from omc_torch.sdp.shor_encode import pack_shor_batch

    def fake(x):
        if isinstance(x, torch.Tensor):
            return x.as_subclass(_FakeCuda)
        if dataclasses.is_dataclass(x):
            return type(x)(**{fd.name: fake(getattr(x, fd.name)) for fd in dataclasses.fields(x)})
        return type(x)(fake(y) for y in x) if isinstance(x, (list, tuple)) else x

    n, L, M5 = 6, 2, 8
    A, idx = generate_matrix_completion_data(1, n, n, 30, 1)
    minors = generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])[:M5]
    sb = admm_shor.shor_batch_to_device(
        pack_shor_batch(n, n, [minors], [shor_soc_complement(n, n, minors)], M5, n * n), F64,
        device="cpu")
    st = admm_shor.init_shor_state(1, n, n, 1, L, M5, n * n, F64, device="cpu")
    lo, hi = ttree.root_box(n, 1)
    z = lambda *s: torch.zeros(s, dtype=F64)  # noqa: E731
    batch = NodeBatch(z(1, L, n), z(1, L, 1), z(1, L, 1), z(1, L), torch.as_tensor(lo[None]),
                      torch.as_tensor(hi[None]))
    c = make_consts(torch.as_tensor(np.ascontiguousarray(A)),
                    torch.as_tensor(np.ascontiguousarray(idx), dtype=F64), batch, st.core, n, n,
                    1, 20.0, 1.6, 0.01, F64)
    c, sc, st = fake((c, admm_shor.make_shor_consts(c, sb, st.core, 30.0), st))
    acc = [torch.zeros_like(x) for x in (st.u5, st.ur, st.ul)]
    if call == "minor_step":
        return admm_shor.minor_step(c, sc, st, acc[0], "eigh")
    if call == "shor_zstep":
        return admm_shor.shor_zstep(c, sc, st)
    return admm_shor.shor_cone_step(c, sc, st, acc[1], acc[2])


def _cuda64_calls():
    f = lambda *s: torch.zeros(*s, dtype=F64).as_subclass(_FakeCuda)  # noqa: E731
    return {
        "minor_step_k7": lambda: _shor64("minor_step"),
        "shor_zstep_k8a": lambda: _shor64("shor_zstep"),
        "shor_cone_step_k8b": lambda: _shor64("shor_cone_step"),
        "eigvalsh": lambda: cones.eigvalsh(f(2, 12, 12)),
        "eigh": lambda: cones.k4_jacobi(f(2, 12, 12), 2),
        "project_psd_k4_cta": lambda: cones.project_psd(f(2, 100, 100)),
        "project_psd_k4_block": lambda: cones.project_psd(f(2, 150, 150)),
        "project_psd_k4s": lambda: cones.project_psd(f(2, 3, 5, 5)),
        "separation_eigpairs": lambda: relax.separation_eigpairs(f(2, 6, 1), f(2, 6, 6)),
        "separation_eigpairs_k4": lambda: relax.separation_eigpairs(f(2, 250, 1), f(2, 250, 250)),
        "v_step": lambda: linalg.v_step(f(2, 6, 2), f(6, 5), f(6, 5), 5.0),
        "u_step_unconstrained": lambda: linalg.u_step_unconstrained(
            f(2, 2, 5), f(6, 5), f(6, 5), 5.0),
    }


@pytest.mark.parametrize("name", sorted(_cuda64_calls()))
def test_float64_cuda_tensor_takes_its_build_or_raises(name, monkeypatch):
    """A float64 CUDA tensor goes to the float64 build (here, without a GPU,
    it raises): never to LAPACK, the plain versions or a float32 copy."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled(name)

    for attr in ("eigh", "eigvalsh", "solve"):
        monkeypatch.setattr(torch.linalg, attr, plain)
    from omc_torch.sdp import admm_shor

    for mod, attr in ((linalg, "v_step_plain"), (linalg, "u_step_unconstrained_plain"),
                      (cones, "project_psd_plain"), (relax, "separation_eigpairs_plain"),
                      (admm_shor, "minor_step_plain"), (admm_shor, "shor_zstep_plain"),
                      (admm_shor, "shor_cone_step_plain")):
        monkeypatch.setattr(mod, attr, plain)
    blocks = []
    real_block = kernels.block

    def spy(cls, dtype):
        blocks.append(dtype)
        return real_block(cls, dtype)

    monkeypatch.setattr(kernels, "block", spy)
    with pytest.raises((RuntimeError, AssertionError)):
        _cuda64_calls()[name]()
    assert blocks and set(blocks) == {F64}


# ---- (e) the CPU route the card's float64 path mirrors, against omc ----

N12 = 12


def _root_nodes(k):
    A, idx = generate_matrix_completion_data(k, N12, N12, 72, 3)
    lo, hi = ttree.root_box(N12, k)
    nodes = [mod.BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0,
                        cuts=[]) for mod in (jtree, ttree)]
    return A, idx, nodes


def test_relaxation_at_the_new_defaults_matches_omc():
    """api.matrix_completion_SDP_relaxation with its defaults (float64,
    psd_method "auto" -> "eigh", 2,000 iterations) on a 12 x 12 root, on
    the CPU, against omc's: bound and objective within 1e-8 relative."""
    A, idx, (node_j, node_t) = _root_nodes(1)
    rj = japi.matrix_completion_SDP_relaxation(node_j, N12, 1, A, idx, 80.0)
    rt = tapi.matrix_completion_SDP_relaxation(node_t, N12, 1, A, idx, 80.0, device="cpu")
    for key in ("lower_bound", "objective"):
        assert abs(rt[key] - rj[key]) <= 1e-8 * max(1.0, abs(rj[key])), key
    assert np.max(np.abs(rt["Y"] - np.asarray(rj["Y"]))) <= 1e-8 * max(
        1.0, float(np.max(np.abs(rj["Y"]))))


def test_alternating_minimization_at_the_new_defaults_matches_omc():
    """api.alternating_minimization with its defaults (float64) on the same
    12 x 12 instance, on the CPU, against omc's within 1e-8 relative."""
    A, idx, _ = _root_nodes(1)
    U0 = np.linalg.svd(A * idx, full_matrices=False)[0][:, :1]
    rj = japi.alternating_minimization(A, N12, 1, idx, 80.0, U_initial=U0)
    rt = tapi.alternating_minimization(A, N12, 1, idx, 80.0, U_initial=U0, device="cpu")
    assert rt["n_iters"] == rj["n_iters"]
    X, Xj = rt["U"] @ rt["V"], np.asarray(rj["U"]) @ np.asarray(rj["V"])
    assert np.linalg.norm(X - Xj) <= 1e-8 * np.linalg.norm(Xj)
    assert abs(rt["objectives"][-1] - rj["objectives"][-1]) <= 1e-8 * abs(rj["objectives"][-1])
