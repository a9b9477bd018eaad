"""Rank-k Shor past k = 4 on the CPU: the port's solver, safe bounds, host
certificate and api relaxation against ``omc`` at k = 5 and 9 (the bound's
XWH slots past d = 8 at k = 9), the plans of K7x's, K8c's and K8d's wide
kernels (``omc_torch/csrc/k7x_wide.cu``, ``csrc/k8k_shor_k.cu``)
owning every output once at k = 5..32, their shared memory and workspace
against recounts of the kernels' formulas, every plan at k <= 4 as before,
the wide kernels' CPU mirrors against the plain versions, and the other
plans of the rank-k Shor path at k = 5..16.  The kernels run on the GPU
only: ``chip_smoke.py``'s ``shorkwide`` phase holds them against their
plain versions there.

Sizes are those of ``tests/test_torch_shor_k.py`` (8x8, M5 = 8), with one
node slot: ``omc``'s proximal term ``tau_x * Xt`` broadcasts a (B, 1, 1)
scale against (B, k, n, m), which holds for B = 1 (or B = k) only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import omc.api as japi
from omc.data import generate_matrix_completion_data
from omc.sdp import relax as jrelax
from omc.sdp import shor as jshor_idx
from omc.sdp import shor_k as jshk
from omc.tree import BBNode as JNode, ShorInfo as JShorInfo, root_box

import omc_torch.api as tapi
from omc_torch import convert
from omc_torch.ops import cones as tcones
from omc_torch.ops import jacobi as tjacobi
from omc_torch.ops import linalg as tlinalg
from omc_torch.ops import polar as tpolar
from omc_torch.sdp import admm as tadmm
from omc_torch.sdp import relax as trelax
from omc_torch.sdp import shor_k as tshk
from omc_torch.sdp.admm import make_consts
from omc_torch.tree import BBNode as TNode, ShorInfo as TShorInfo

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
N = M = 8
B = 1
L = 4
M5 = 8
C = 4 * M5
GAMMA = 20.0
SMEM = 232448
NAMES = ("y1", "y2", "ya", "yb", "yc", "y5", "yx", "yr", "yl", "ywl")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _rel1(a, b):
    """Relative error with a floor of 1 on the scale (leaves at rounding
    level count absolutely)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0)


def _instance(k):
    """The 8x8 instance of tests/test_torch_shor_k.py (rank 2: an 8x8
    instance of rank k > 3 is under-determined); the relaxation's rank is
    the solver's k."""
    return generate_matrix_completion_data(2, N, M, int(0.7 * N * M), 2)


def _minors(idx):
    allm = jshor_idx.generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4, 3])
    return [allm[:7]]


def _setup(k, dtype=np.float64, seed=0):
    """omc's rank-k batch (one slot, 7 minors), node batch and a random
    state with unit-scale slot values and duals (symmetric PSD blocks)."""
    rng = np.random.default_rng(seed + 10 * k)
    A, idx = _instance(k)
    mask = idx.astype(np.float64)
    minors = _minors(idx)
    socs = [jshor_idx.shor_soc_complement(N, M, mm) for mm in minors]
    sbj = jshk.pack_shor_k_batch(N, M, minors, socs, M5, N * M)
    lo, hi = root_box(N, k)
    bl = [np.zeros((B, L, N)), np.zeros((B, L, k)), np.zeros((B, L, k)), np.zeros((B, L)),
          np.broadcast_to(lo, (B, N, k)).copy(), np.broadcast_to(hi, (B, N, k)).copy()]
    st = jshk.init_shor_k_state(B, N, M, k, L, M5, N * M, jnp.float64, rho=0.05, sX=1.7,
                                sT=1.3, sS=1.7)
    leaves = [np.asarray(x, np.float64).copy() for x in jax.tree.leaves(st)]
    for i in list(range(18)) + list(range(26, 47)):
        leaves[i] = leaves[i] + 0.1 * rng.standard_normal(leaves[i].shape)
        if leaves[i].ndim >= 3 and leaves[i].shape[-1] == leaves[i].shape[-2]:
            leaves[i] = 0.5 * (leaves[i] + np.swapaxes(leaves[i], -1, -2))
    leaves[22] = np.array([0.04])
    leaves[25] = np.array([1.4])
    return (A.astype(dtype), mask.astype(dtype), [x.astype(dtype) for x in bl], sbj,
            [x.astype(dtype) for x in leaves], st)


def _run_both(k, dtype, iters, psd_method):
    np_dt = np.float64 if dtype == "float64" else np.float32
    A, mask, bl, sbj, leaves, like = _setup(k, np_dt)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = F64 if dtype == "float64" else F32
    kw = dict(iters=iters, psd_method=psd_method, check_every=100, ema_iters=100)
    ub = 0.5 * float(np.sum(mask * A * A))
    sj = jshk.make_shor_k_solver(N, M, k, L, M5, N * M, GAMMA, dtype=jdt, **kw)
    js = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(x) for x in leaves])
    fj, oj = sj(jnp.asarray(A), jnp.asarray(mask), jrelax.NodeBatch(*map(jnp.asarray, bl)),
                jshk.shor_k_batch_to_device(sbj, jdt), ub, js)
    st_t = convert.shor_k_state_from_numpy(leaves, dtype=tdt, device="cpu")
    st = tshk.make_shor_k_solver(N, M, k, L, M5, N * M, GAMMA, dtype=tdt, **kw)
    ft, ot = st(torch.as_tensor(A), torch.as_tensor(mask),
                convert.node_batch_from_numpy(bl, dtype=tdt, device="cpu"),
                tshk.shor_k_batch_host_from_omc_leaves(list(sbj)), ub, st_t)
    return fj, oj, ft, ot


# ---- the solver, the bounds and the api against omc past k = 4 ----


@pytest.mark.parametrize("k", [5, 9])
def test_shor_k_solve_300_iterations_float64_parity_past_rank_4(k):
    """300 iterations from the same state (eigh; at k = 9 the XWH slots are
    10 x 10): every iterate and output within 1e-9 relative (a floor of 1
    on the scale), the on-device bound and estimator within 1e-8, as
    ``test_shor_k_solve_300_iterations_float64_parity`` holds k = 2."""
    fj, oj, ft, ot = _run_both(k, "float64", 300, "eigh")
    for i, (a, b) in enumerate(zip(convert.admm_state_to_numpy(ft), jax.tree.leaves(fj))):
        assert _rel1(a, b) <= 1e-9, i
    for key in NAMES + ("X", "Xt", "Y", "Th", "U", "W"):
        assert _rel1(ot[key].numpy(), oj[key]) <= 1e-9, key
    for key in ("lb_dev", "lb_est"):
        a, b = ot[key].numpy(), np.asarray(oj[key])
        assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))), key
    assert ot["Xt"].shape == (B, k, N, M)


def test_shor_k_solve_float32_sign_schedule_past_rank_4():
    """k = 5 in float32 with the sign-schedule projections (the card's
    algorithm, here through the plain versions), 100 iterations: the
    estimator within ``omc``'s 1e-4 bar of ``omc``'s float32 run and of
    ``omc``'s float64 (eigh) run.  Two float32 runs drift apart as the
    iterations go on: at k = 5, by 200-300 iterations ``omc``'s own float32
    run lies 1.6e-4 to 3.1e-4 from its float64 run (the port's 4e-5 to
    8e-5, seeds 0-3), so 100 iterations hold the bar to the projections'
    accuracy, not to that drift."""
    _, oj, _, ot = _run_both(5, "float32", 100, "ns")
    _, oj64, _, _ = _run_both(5, "float64", 100, "eigh")
    a = ot["lb_est"].numpy().astype(np.float64)
    for ref in (oj, oj64):
        b = np.asarray(ref["lb_est"], np.float64)
        assert np.all(np.abs(a - b) <= 1e-4 * np.maximum(1.0, np.abs(b))), (a, b)


@pytest.mark.parametrize("D", [6, 9, 13])
def test_xwh_sign_schedule_meets_the_bar_past_d_5(D):
    """The D x D XWH projection in float32 (the wide K7x's algorithm; its
    order of work, the upper triangles of symmetric products, and the plain
    version's) within 1e-4 of the exact projection, like omc's; the 16-bit
    truncated-product control is not."""
    from omc.ops import polar as jpolar

    rng = np.random.default_rng(D)
    Q = np.linalg.qr(rng.standard_normal((400, D, D)))[0]
    lam = rng.uniform(0.1, 1.0, (400, D)) * rng.choice([-1.0, 1.0], (400, D))
    T = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    T = 0.5 * (T + np.swapaxes(T, -1, -2))
    exact = tcones.project_psd(torch.as_tensor(T)).numpy()
    T32 = torch.as_tensor(T.astype(np.float32))
    assert _rel(tpolar.project_psd_xwh(T32).numpy(), exact) <= 1e-4
    mirror = tpolar.project_psd_ns(T32, matmul=tpolar.symmetric_matmul())
    assert _rel(mirror.numpy(), exact) <= 1e-4
    assert _rel(np.asarray(jpolar.project_psd_ns_small(jnp.asarray(T32.numpy()))), exact) <= 1e-4
    bad = tpolar.project_psd_ns(T32, matmul=tpolar.truncated_matmul(16)).numpy()
    assert not _rel(bad, exact) <= 1e-4


def test_safe_dual_bounds_and_certificate_past_rank_4():
    """k = 5: the closed-form bound, the pair (valid, estimator) and the
    host certificate on the same duals against omc's, within 1e-10
    relative."""
    k = 5
    A, mask, bl, sbj, _, _ = _setup(k)
    rng = np.random.default_rng(4)
    shapes = [(B, N + M, N + M), (B, N + k, N + k), (B, L, k), (B, L, k), (B, L),
              (B, M5, k, 5, 5), (B, C, k + 1, k + 1), (B, N * M, 3), (B, M), (B, C)]
    duals = [rng.standard_normal(s) * 0.2 for s in shapes]
    sX, sS = np.array([1.7]), np.array([0.9])
    ub = 0.5 * float(np.sum(mask * A * A))
    tb = convert.node_batch_from_numpy(bl, device="cpu")
    sbt = convert.shor_k_batch_from_numpy(list(sbj), device="cpu")
    T = torch.as_tensor
    a = tshk.safe_dual_bound_shor_k(T(A), T(mask), tb, sbt, *map(T, duals), GAMMA, k, ub,
                                    margin_rel=1e-10, sX=T(sX), sS=T(sS)).numpy()
    b = jshk.safe_dual_bound_shor_k(np, A, mask, jrelax.NodeBatch(*bl), sbj, *duals, GAMMA,
                                    k, ub, margin_rel=1e-10, sX=sX, sS=sS)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)
    a2 = tshk.safe_dual_bound_shor_k2(T(A), T(mask), tb, sbt, *map(T, duals), GAMMA, k, ub,
                                      sX=T(sX), sS=T(sS))
    b2 = jshk.safe_dual_bound_shor_k2(jnp, jnp.asarray(A), jnp.asarray(mask),
                                      jrelax.NodeBatch(*map(jnp.asarray, bl)),
                                      jshk.shor_k_batch_to_device(sbj, jnp.float64),
                                      *map(jnp.asarray, duals), GAMMA, k, ub,
                                      sX=jnp.asarray(sX), sS=jnp.asarray(sS))
    for x, y in zip(a2, b2):
        y = np.asarray(y)
        assert np.all(np.abs(x.numpy() - y) <= 1e-10 * np.maximum(1.0, np.abs(y)))
    out = dict(zip(NAMES, duals), sX=sX, sS=sS)
    sbh = tshk.shor_k_batch_host_from_omc_leaves(list(sbj))
    a = tshk.host_certified_bound_shor_k(A, mask, trelax.NodeBatch(*bl), sbh, out, GAMMA, k, ub)
    b = jshk.host_certified_bound_shor_k(A, mask, jrelax.NodeBatch(*bl), sbj, out, GAMMA, k, ub)
    assert np.all(np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b))), (a, b)


def test_api_rank_k_shor_relaxation_past_rank_4():
    """The api's rank-k Shor relaxation at k = 5 on the CPU (float64, its
    default) against omc.api's on the same node: bound and objective within
    1e-8 relative, X within 1e-7."""
    k = 5
    A, idx = _instance(k)
    minors = _minors(idx)[0]
    socs = jshor_idx.shor_soc_complement(N, M, minors)
    lo, hi = root_box(N, k)
    kw = dict(add_Shor_valid_inequalities=True, iters=300)
    jn = JNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[],
               Shor_info=JShorInfo(constraints_indexes=minors, SOC_constraints_indexes=socs))
    tn = TNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[],
               Shor_info=TShorInfo(constraints_indexes=minors, SOC_constraints_indexes=socs))
    a = tapi.matrix_completion_SDP_relaxation(tn, N, k, A, idx, GAMMA, device="cpu", **kw)
    b = japi.matrix_completion_SDP_relaxation(jn, N, k, A, idx, GAMMA, **kw)
    for key in ("lower_bound", "objective"):
        assert abs(a[key] - b[key]) <= 1e-8 * max(1.0, abs(b[key])), (key, a[key], b[key])
    assert _rel1(a["X"], b["X"]) <= 1e-7


# ---- the wide kernels' plans ----

K_WIDE = [5, 6, 8, 12, 16, 24, 32]


def _k7x_wide_values(D, e):
    """The values a warp of K7x's wide kernel works in (the kernel's
    k7x_wide_values): float32 T, S, S^2, M; float64 A, V, T and max(w, 0)."""
    return 3 * D * D + D if e == 8 else 4 * D * D


def _k8c_wide_smem(n, k, cols, kept_global, e):
    """K8c's wide kernel's shared memory (the kernel's k8c_wide_smem_values):
    the kept values of n x cols entries unless they are in the workspace,
    two column sums a row group, a_j."""
    nf = k + k * (k - 1) // 2 + 3
    return e * ((0 if kept_global else nf * n * cols) + 2 * (256 // cols) * cols + cols)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("k", K_WIDE)
def test_k7x_wide_plan_owns_every_slot_once(k, dtype):
    """k7x_plan past k = 4: a warp a slot, every slot of the batch taken by
    exactly one warp of the grid-stride loop, the warps' matrices in shared
    memory at the kernel's count, as many warps (4, 2, 1) as fit."""
    D, e = k + 1, dtype.itemsize
    per = _k7x_wide_values(D, e) * e
    for N in (4 * 64, 32 * 4 * 1024, 7):
        p = tshk.k7x_plan(N, D, dtype)
        assert p["path"] == "wide" and p["work_bytes"] == 0
        W, G = p["warps"], p["ctas"]
        assert W == next(w for w in (4, 2, 1) if w * per <= SMEM)
        assert p["smem"] == W * per <= SMEM and p["threads"] == 32 * W
        owner = np.zeros(N, np.int64)
        for g0 in range(G * W):
            owner[g0::G * W] += 1
        assert np.all(owner == 1)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_k7x_wide_plan_takes_a_workspace_past_shared_memory(dtype):
    """Where one warp's matrices pass a CTA's shared memory (D = 130), the
    plan's 2 x 132 CTAs of 4 warps work in a global workspace of one
    region a warp, and still own every slot once; a workspace past the
    card's free memory is refused, naming its byte count."""
    D, e = 130, dtype.itemsize
    per = _k7x_wide_values(D, e) * e
    assert per > SMEM
    for N in (5, 4096):
        p = tshk.k7x_plan(N, D, dtype)
        W, G = p["warps"], p["ctas"]
        assert (p["path"], W, p["smem"]) == ("wide", 4, 0)
        assert G == max(1, min(264, -(-N // 4))) and p["work_bytes"] == G * W * per
        with pytest.raises(ValueError, match=str(p["work_bytes"])):
            tshk.k7x_plan(N, D, dtype, free_bytes=p["work_bytes"] - 1)
        owner = np.zeros(N, np.int64)
        for g0 in range(G * W):
            owner[g0::G * W] += 1
        assert np.all(owner == 1)


def _owners(p, n, m):
    """Each (row, column) entry's count of owners among K8c's CTAs (one
    slot): CTA t's thread tid takes column t cols + tid % cols, rows
    tid // cols, + row_groups, ..."""
    cols, rg = p["cols"], p["row_groups"]
    owner = np.zeros((n, m), np.int64)
    for tid in range(p["threads"]):
        js = np.arange(p["grid"][0]) * cols + tid % cols
        js = js[js < m]
        owner[tid // cols::rg][:, js] += 1
    return owner


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("k", K_WIDE)
def test_k8c_wide_plan_owns_every_entry_once(k, dtype):
    """k8c_plan past k = 4, both placements of the kept values: shared
    memory where one tile's fit (the widest tile of 32, 16, 8 columns that
    fills the card, narrowed until it fits), else the global workspace of B
    NF n m values at the widest tile; the shared memory at the kernel's
    count; every entry of a slot owned by exactly one thread."""
    e = dtype.itemsize
    nf = k + k * (k - 1) // 2 + 3
    for B, n, m in ((32, 75, 75), (1, 250, 250), (2, 4000, 40), (3, 40, 7)):
        p = tshk.k8c_plan(B, n, m, k, dtype)
        cols0 = next((c for c in (32, 16, 8) if -(-m // c) * B >= 264), 8)
        glob = _k8c_wide_smem(n, k, 1, False, e) > SMEM
        assert p["path"] == "wide" and p["kept"] == ("global" if glob else "smem")
        if glob:
            assert p["cols"] == cols0 and p["ws_bytes"] == e * B * nf * n * m
        else:
            assert p["ws_bytes"] == 0 and p["cols"] <= cols0
            assert p["cols"] == cols0 or _k8c_wide_smem(n, k, 2 * p["cols"], False, e) > SMEM
        assert p["smem_bytes"] == _k8c_wide_smem(n, k, p["cols"], glob, e) <= SMEM
        assert p["grid"] == (-(-m // p["cols"]), B) and p["cols"] * p["row_groups"] == 256
        assert np.all(_owners(p, n, m) == 1)
    # both placements occur over these shapes
    assert tshk.k8c_plan(1, 250, 250, 5, dtype)["kept"] == "smem"
    assert tshk.k8c_plan(2, 4000, 40, 5, dtype)["kept"] == "global"


def test_k8c_plan_sends_unplaceable_register_shapes_to_the_wide_kernel():
    """The k <= 4 shapes whose one column's kept values pass the register
    kernel's shared memory (float64 k = 2 from n ~ 4,100; float32 k = 4 at
    n = 6,000) take the wide kernel with its workspace instead of a
    refusal (its kept values in shared memory where its one column fits
    there, else in the workspace); the plan refuses only a workspace past
    the card's free memory, naming the byte count."""
    for B, n, k, dt in ((4, 4200, 2, F64), (2, 6000, 4, F32), (1, 3000, 3, F64)):
        assert tshk.k8c_smem_bytes(n, n, k, 1, dt) > SMEM
        p = tshk.k8c_plan(B, n, n, k, dt)
        # the wide kernel stages no Theta rows: one column of the float64
        # shapes fits its shared memory, float32 k = 4 at n = 6,000 does not
        glob = _k8c_wide_smem(n, k, 1, False, dt.itemsize) > SMEM
        assert p["path"] == "wide" and p["kept"] == ("global" if glob else "smem")
        assert glob == (n == 6000)
        if glob:
            with pytest.raises(ValueError, match=str(p["ws_bytes"])):
                tshk.k8c_plan(B, n, n, k, dt, free_bytes=p["ws_bytes"] - 1)
        assert tshk.k8c_plan(B, n, n, k, dt, free_bytes=p["ws_bytes"]) == p


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("k", K_WIDE)
def test_k8d_wide_plan_owns_every_coordinate_once(k, dtype):
    """k8d_plan past k = 4: the register kernels' grid (the link, W >= 0
    and RSOC CTAs do not depend on k), the wide path, and every coordinate
    of the batch's flat B C taken by one thread of one coordinates' CTA."""
    for B, n, M5 in ((32, 75, 1024), (1, 250, 2000), (4, 50, 64)):
        C, Ms = 4 * M5, n * n
        p = tshk.k8d_plan(B, n, n, k, C, Ms, dtype)
        ref = dict(tshk.k8d_plan(B, n, n, 2, C, Ms, dtype), path="wide")
        assert p == ref
        cover = np.zeros(B * C, np.int64)
        for x in range(p["coord_ctas"]):
            g = x * p["ipc"] + np.arange(p["ipc"])
            cover[g[g < B * C]] += 1
        assert np.all(cover == 1)


def _k8c_plan_before(B, n, m, k, dtype):
    """k8c_plan as it was before the wide kernel (the register kernel's
    tile, or a refusal)."""
    e = dtype.itemsize
    nf = k + k * (k - 1) // 2 + 3

    def smem(cols):
        return e * (nf * n * cols + 2 * (256 // cols) * cols + cols + cols * (m + 1))

    cols = next((c for c in (32, 16, 8) if -(-m // c) * B >= 264), 8)
    while cols > 1 and smem(cols) > SMEM:
        cols //= 2
    if smem(cols) > SMEM:
        return None
    return dict(cols=cols, row_groups=256 // cols, threads=256, grid=(-(-m // cols), B),
                smem_bytes=smem(cols))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_register_plans_unchanged_at_rank_4_and_below(k, dtype):
    """k8c_plan, k7x_plan and k8d_plan at k <= 4 give what they gave before
    the wide kernels (no ``path`` key) wherever the register kernels take
    the shape; ``path="wide"`` forces the wide kernels there."""
    D = k + 1
    for B, n, M5 in ((32, 75, 1024), (1, 75, 64), (64, 100, 256), (8, 250, 512)):
        C = 4 * M5
        before = _k8c_plan_before(B, n, n, k, dtype)
        assert before is not None and tshk.k8c_plan(B, n, n, k, dtype) == before
        assert tshk.k8c_plan(B, n, n, k, dtype, "wide")["path"] == "wide"
        threads = tshk.K7X_THREADS[dtype][D]
        ld = (D * D) | 1 if dtype == F64 else D * D
        assert tshk.k7x_plan(B * C, D, dtype) == dict(
            threads=threads, ctas=-(-(B * C) // threads), ld=ld,
            smem=3 * threads * ld * dtype.itemsize)
        assert tshk.k7x_plan(B * C, D, dtype, "wide")["path"] == "wide"
        p = tshk.k8d_plan(B, n, n, k, C, n * n, dtype)
        assert "path" not in p
        assert tshk.k8d_plan(B, n, n, k, C, n * n, dtype, "wide") == dict(p, path="wide")
    with pytest.raises(ValueError, match="path"):
        tshk.k8c_plan(4, 50, 50, k, dtype, "cta")


@pytest.mark.parametrize("k", [2, 4])
def test_forced_wide_plans_build_the_wide_blocks_at_rank_4_and_below(k):
    """At k <= 4 the wrappers' packed blocks are the register kernels'; a
    plan with ``path="wide"`` builds the wide kernels' blocks on the same
    operands (as chip_smoke.py does to time the wide kernels beside the
    register ones)."""
    c, sc, st = _port_state(k)
    cpu = torch.device("cpu")
    B_, n, m, _, _, C_, Ms = tshk._shapes(st)
    accx = torch.ones_like(st.ux)
    accs = [torch.ones_like(x) for x in (st.ur, st.ul, st.uwl)]
    assert not tshk._k8c_params(c, sc, st, cpu).wide
    assert not tshk._k7x_params(c, sc, st, accx, cpu).wide
    assert not tshk._k8d_params(c, sc, st, *accs, cpu).wide
    plan = tshk.k8c_plan(B_, n, m, k, F64, "wide")
    p = tshk._k8c_block(c, sc, st, cpu, plan)
    assert p.wide and (p.cols, p.k, p.ws) == (plan["cols"], k, None)
    assert p.Xt == st.Xt.data_ptr()
    plan = tshk.k7x_plan(B_ * C_, k + 1, F64, "wide")
    p = tshk._k7x_block(c, sc, st, accx, cpu, plan)
    assert p.wide and (p.warps, p.ctas, p.N, p.k) == (plan["warps"], plan["ctas"], B_ * C_, k)
    assert (p.w, p.acc) == (st.wx.data_ptr(), accx.data_ptr())
    plan = tshk.k8d_plan(B_, n, m, k, C_, Ms, F64, "wide")
    p = tshk._k8d_block(c, sc, st, *accs, cpu, plan)
    assert p.wide and (p.ipc, p.k, p.acc_wl) == (plan["ipc"], k, accs[2].data_ptr())


# ---- the wide kernels' CPU mirrors against the plain versions ----


def _port_state(k):
    """The port's constants and state from _setup's omc leaves (float64)."""
    A, mask, bl, sbj, leaves, _ = _setup(k)
    st = convert.shor_k_state_from_numpy(leaves, dtype=F64, device="cpu")
    sb = convert.shor_k_batch_from_numpy(list(sbj), dtype=F64, device="cpu")
    c = make_consts(torch.as_tensor(A), torch.as_tensor(mask),
                    convert.node_batch_from_numpy(bl, dtype=F64, device="cpu"), st.core, N, M, k,
                    GAMMA, 1.6, 0.01, F64)
    return c, tshk.make_shor_k_consts(c, sb, st.core, 30.0, k), st


@pytest.mark.parametrize("k", [5, 12])
def test_wide_kernels_mirrors_match_plain_float64(k):
    """At k = 5 and 12 in float64, 1e-12 relative: K8c's order of sums
    (``shor_k_zstep_tiled`` at the wide plan's row groups) against
    ``shor_k_zstep_plain``; K7x's float64 order of work (the warp's cyclic
    Jacobi, ``ops.jacobi.k4s_project_psd``, at D = k + 1) and its float32
    order of work (the upper triangles of symmetric products,
    ``project_psd_ns`` with ``symmetric_matmul()``, run here in float64)
    against the exact and the plain sign-schedule projections of the XWH
    slots; K8d's sums (``shor_k_cone_step_tiled``) against
    ``shor_k_cone_step_plain``."""
    c, sc, st = _port_state(k)
    B_, n, m, k_, kp, C_, Ms = tshk._shapes(st)
    got = tshk.shor_k_zstep_tiled(c, sc, st, tshk.k8c_plan(B_, n, m, k, F64))
    ref = tshk.shor_k_zstep_plain(c, sc, st)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel1(a.numpy(), b.numpy()) <= 1e-12, i
    rng = np.random.default_rng(k)
    accx = torch.as_tensor(rng.standard_normal(st.ux.shape) * 0.1)
    jac = tshk.xwh_step_plain(c, sc, st, accx, lambda t: tjacobi.k4s_project_psd(t)[0])
    exact = tshk.xwh_step_plain(c, sc, st, accx, tcones.project_psd_plain)
    for a, b in zip(jac, exact):
        assert _rel1(a.numpy(), b.numpy()) <= 1e-12
    sym = tshk.xwh_step_plain(c, sc, st, accx, lambda t: tpolar.project_psd_ns(
        t, matmul=tpolar.symmetric_matmul()))
    sign = tshk.xwh_step_plain(c, sc, st, accx, tpolar.project_psd_ns_small)
    for a, b in zip(sym, sign):
        assert _rel1(a.numpy(), b.numpy()) <= 1e-12
    accs = [torch.as_tensor(rng.standard_normal(x.shape) * 0.1) for x in (st.ur, st.ul, st.uwl)]
    got = tshk.shor_k_cone_step_tiled(c, sc, st, *accs, tshk.k8d_plan(B_, n, m, k, C_, Ms, F64))
    ref = tshk.shor_k_cone_step_plain(c, sc, st, *accs)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel1(a.numpy(), b.numpy()) <= 1e-12, i


# ---- the rest of the rank-k Shor path's plans past k = 4 ----


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("k", [5, 8, 12, 16])
def test_every_plan_of_the_rank_k_shor_path_takes_ranks_past_4(k, dtype):
    """Every other plan a rank-k Shor iteration and its bound make, at the
    smoke's shapes (config 3's frontier B = 32, n = m = 75, M5 = 1024; a
    root visit B = 1; config 4's root n = m = 250): K2's Shor mode and K3
    (k2k3_plan), K1 on the three PSD blocks (float32), K5 (the separation),
    K6 (altmin), K7t, K4s on the bound's 5x5 minor slots and, for its XWH
    slots, K4s at d <= 8 and K4 past it (the CTA path, one CTA a slot), and
    K4 on the bound's PSD blocks: none raises."""
    for B, n, M5, L in ((32, 75, 1024, 8), (1, 75, 256, 1), (1, 250, 2048, 1)):
        C = 4 * M5
        plan = tadmm.k2k3_plan(B, n, n, k, L, dtype=dtype)
        assert plan["k2_cluster"] >= 1 and plan["k3_cluster"] >= 1
        if dtype == F32:
            assert tpolar.k1_plan([2 * n, n + k, n], B)
        assert trelax.k5_plan(B, n, dtype=dtype)["path"]
        assert tlinalg.k6_plan(B, n, n, k, None, dtype)["path"] == (
            "wide" if k > 10 else tlinalg.k6_plan(B, n, n, k, None, dtype)["path"])
        assert tshk.k7t_plan(B * M5 * k, dtype)["ctas"] == -(-(B * M5 * k) //
                                                             tshk.K7T_THREADS[dtype])
        assert tcones.k4s_plan(B * M5 * k, 5, dtype)["ctas"] >= 1
        D = k + 1
        if D <= tcones.K4S_MAX_D:
            assert tcones.k4s_plan(B * C, D, dtype)["ctas"] >= 1
        else:
            assert tcones.k4_plan(B * C, D, 1, dtype=dtype)["path"] == "cta"
        for d in (2 * n, n + k, n):
            tcones.k4_plan(B, d, 1, dtype=dtype)
        tcones.k4_plan(B, n, 0, dtype=dtype)


@pytest.mark.parametrize("d", range(9, 18))
def test_k4_plan_on_the_bounds_xwh_slots_past_d_8(d):
    """The bound projects the XWH slots (B C, d, d) with K4 past d = 8 (k
    = 8..16): its CTA path in both dtypes at config 3's frontier batch."""
    for dt in (F32, F64):
        p = tcones.k4_plan(32 * 4 * 1024, d, 1, dtype=dt)
        assert p["path"] == "cta" and p["workspace_bytes"] == 0


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the wrappers' CUDA
    branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.as_subclass(_FakeCuda)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _fake_cuda(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_fake_cuda(y) for y in x)
    return x


class _PlainCalled(Exception):
    pass


def test_cuda_state_past_rank_4_takes_no_plain_version(monkeypatch):
    """At k = 5 on a CUDA-typed state K8c's, K7t's, K7x's and K8d's
    wrappers launch their kernels or raise: no plain version runs (here,
    without a GPU, they raise)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs the kernels")

    def plain(*a, **kw):
        raise _PlainCalled

    for name in ("shor_k_zstep_plain", "minor_k_step_plain", "xwh_step_plain",
                 "shor_k_cone_step_plain", "project_psd_ns_small", "project_psd"):
        monkeypatch.setattr(tshk, name, plain)
    c, sc, st = (_fake_cuda(x) for x in _port_state(5))
    with pytest.raises(RuntimeError):
        tshk.shor_k_zstep(c, sc, st)
    with pytest.raises(RuntimeError):
        tshk.minor_k_step(c, sc, st, _fake_cuda(torch.ones_like(st.u5)), "eigh")
    with pytest.raises(RuntimeError):
        tshk.xwh_step(c, sc, st, _fake_cuda(torch.ones_like(st.ux)), "eigh")
    with pytest.raises(RuntimeError):
        tshk.shor_k_cone_step(c, sc, st, *[_fake_cuda(torch.ones_like(x))
                                           for x in (st.ur, st.ul, st.uwl)])
