#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``omc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, about 8 minutes on an H100

Phases, in order (each prints its numbers on lines of its own):

1. device    — nvidia-smi name and power limit, torch/CUDA versions, TF32 off
2. build     — nvcc build of omc_torch/csrc into build/omc_torch, one nvcc
               per source in parallel (timed)
3. kernels   — K1, K2, K3, K7, K8a, K8b, K7t, K7x, K8c, K8d, K9s, K9a, K9b,
               K4, K4s, K5, K6 against their plain PyTorch versions on the
               card, at the main paths' shapes, with median CUDA-event times,
               the library call's time and each kernel's bound (the least
               time the card could take for the same work); K1 (B=1 to 64,
               d=50 to 2000, with its time on every path k1_plan could take)
               and the Jacobi kernels K4/K4s/K5 also against a float64 eigh,
               the latter with their sweep counts
4. admm      — one root ADMM solve (B=64, L=8, 2000 iterations) on the
               headline instance; device bound vs float64 host bound (the
               same bound through torch's eigh is logged as a reading)
5. fixtures  — the four certified instances of tests/fixtures/instances.json
6. headline  — rank-1 50x50, 50% observed, gamma 80, gap 1e-4 (cold, warm)
7. multinode — the 30%-observed instance, gap 1e-4
8. branch    — the 20%-observed instance, 45 s budget
9. shor      — the 30%-observed instance with static Shor minors
               (breadth-first, 60 s): the K7/K8a/K8b path
10. config2  — BASELINE config 2 (rank-1 100x100, iterative Shor, batch 32),
               60 s, with soundness checks
11. config3  — BASELINE config 3 (rank-2 75x75, linear3 cuts,
               smallest_2_eigvec, best-first/depth-first, batch 64), 75 s
12. shork    — the rank-k Shor path (K7t/K7x/K8c/K8d) on config 3's
               instance: a root visit held to omc's bound, then the full
               call (iterative Shor, batch 32), 75 s
13. mccormick — the McCormick path (K9s/K9a/K9b): the standalone relaxation
               entry point on the headline's root and a rank-2 root visit on
               config 3's instance, each held to omc's bound, then the full
               McCormick B&B on the headline instance, 45 s

Every phase that drives the solver asserts that the launch counts of the
kernels its path runs grew (K4 the on-device safe bound, K4s the Shor
bounds' small slots, K5 the separation, K6 altmin).

``--phases device,build,trace`` runs the optional ``trace`` phase: a
torch.profiler trace of the Shor loop at config 2's shape, of the rank-k
Shor loop at config 3's, of the McCormick loop at the headline's, of the
headline's root visit at B=1 (with the device's idle share) and of one
base-path root visit at B=64 with its safe-bound calls.

Any failed check raises; the script then exits non-zero and prints no
final line.  On success the line before the last is the per-kernel JSON
record and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits with code 2.  ``--phases a,b`` runs a
subset (for debugging; the final lines are printed only for a full run);
``--out FILE`` also writes every phase's numbers to a JSON file.
This script imports no jax and nothing of the ``omc`` package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "admm", "fixtures", "headline",
          "multinode", "branch", "shor", "config2", "config3", "shork", "mccormick")
EXTRA_PHASES = ("trace",)  # run only when named in --phases

# certified objectives of the three 50x50 instances (float64 host
# certificates recorded in BENCH_r05.json; they are facts about the
# instances, independent of the hardware)
HEADLINE_OBJ, HEADLINE_GAP = 13.431711265419487, 4.0e-5
MULTI_OBJ, MULTI_GAP = 12.948394910097942, 1.2e-5
# omc's incumbent for BASELINE config 3's instance (BENCH_CONFIGS_r05.json,
# certified to gap 1.02e-3): a fact about the instance, so no valid lower
# bound of it may exceed this value
CONFIG3_OBJ = 84.93227069198058
# omc's certified root bound for the shork phase's root-only call, float32 on
# a CPU (omc.solve.matrix_completion_branchandbound with SHORK_KW,
# root_only=True, sdp_iter_boost_max=1; 2,000 iterations in one call)
SHORK_ROOT_OMC = -168.05748086136975

# the card's peak rates for the bound of a kernel (NVIDIA's H100 SXM data
# sheet, at 700 W): fp32 outside the tensor cores, HBM3, and TF32 on the
# tensor cores (dense), of which a 3xTF32 product takes three passes
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12
# products in one sign-schedule projection: 3 per quintic step, 2 per cubic
# step, 1 for (T + sign(T) T) / 2
SIGN_PRODUCTS = 3 * 12 + 2 * 2 + 1


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` timed launches (CUDA
    events around each call, after ``warmup`` untimed calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, peak=PEAK_FP32_FLOPS):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak``, the rate of the
    kernel's arithmetic (fp32 unless given; ms, which)."""
    tb = 1e3 * nbytes / PEAK_BYTES
    tf = 1e3 * flops / peak
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def with_bound(row, nbytes, flops, peak=PEAK_FP32_FLOPS):
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peak)
    row["bound_bytes"], row["bound_flops"] = float(nbytes), float(flops)
    return row


def rel_fro(a, b):
    import torch

    a = a.double()
    b = b.double()
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-30))


def _errs(got, ref):
    """The largest relative Frobenius error and the largest absolute error
    over pairs of outputs; an all-zero reference (a masked or equality slot)
    must come out exactly zero."""
    rel = max(rel_fro(a, b) if float(b.abs().max()) > 0
              else (0.0 if float(a.abs().max()) == 0 else float("inf"))
              for a, b in zip(got, ref))
    return rel, max(float((a - b).abs().max()) for a, b in zip(got, ref))


def _same_bits(xs, ys):
    import torch

    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def phase_device(res):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from omc_torch import kernels

    kernels.set_full_fp32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    log(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    res["nvidia_smi"] = smi
    res["torch"] = torch.__version__
    res["cuda"] = torch.version.cuda


def phase_build(res):
    from omc_torch import kernels

    t0 = time.time()
    kernels.library()
    info = dict(kernels.BUILD_INFO)
    log(f"build: {time.time() - t0:.3f} s (nvcc {info['seconds']}, cached={info['cached']}) "
        f"-> {os.path.relpath(info['path'], HERE)}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    res["build_s"] = time.time() - t0


def _spectral_batch(B, d, gen, dev):
    """Symmetric (B, d, d) matrices with eigenvalues +-[0.1, 1] (so every
    |lambda| / ||T||_F >= 1e-4, inside the sign schedule's resolution)."""
    import torch

    Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=torch.float64))
    lam = torch.empty(B, d, dtype=torch.float64).uniform_(0.1, 1.0, generator=gen)
    sign = torch.where(torch.rand(B, d, generator=gen) < 0.5, -1.0, 1.0).double()
    T = (Q * (lam * sign)[:, None, :]) @ Q.transpose(-1, -2)
    T = 0.5 * (T + T.transpose(-1, -2))
    return T.float().to(dev).contiguous(), T


def phase_kernels(res):
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import (
        _SIGN_SCHEDULE,
        k1_plan,
        project_psd_ns,
        project_psd_ns_merged,
        project_psd_ns_multi,
        psd_epilogue,
        truncated_matmul,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {}
    checks = []  # (kernel, row, passed): every kernel is checked, then asserted

    # ---- K1, at the shapes of the paths: the base path at B=64 (the row of
    # the record), the headline's root visit (B=1) and refinement portfolio
    # (B=4), BASELINE config 3 (d=150) at its base-path batch (B=64) and
    # its rank-k Shor batch (B=32), config 2 (d=200), d=200 alone, d=500
    # (250x250 instances) and config 5's d=2000
    from omc_torch import kernels

    lib = kernels.library()
    k1 = []
    for B, dims in ((64, (100, 51, 50)), (1, (100, 51, 50)), (4, (100, 51, 50)),
                    (64, (150, 77, 75)), (32, (150, 77, 75)), (32, (200, 101, 100)),
                    (64, (200,)), (16, (500,)), (2, (2000,))):
        ts, ts64 = zip(*[_spectral_batch(B, d, gen, dev) for d in dims])
        ts = list(ts)
        rho = torch.rand(B, generator=gen).to(dev) * 0.05 + 0.01
        beta = 1e-3
        nacc = min(2, len(dims))

        def fresh():
            return ([torch.empty_like(t) for t in ts], [torch.empty_like(t) for t in ts],
                    [torch.ones_like(t) if g < nacc else None for g, t in enumerate(ts)])

        wk, uk, ak = fresh()
        project_psd_ns_multi(ts, w_out=wk, u_out=uk, acc=ak, rho=rho, beta=beta)
        torch.cuda.synchronize()
        wp, up, ap = fresh()
        psd_epilogue(ts, project_psd_ns_merged(ts), wp, up, ap, rho, beta)
        err = max(rel_fro(a, b) for a, b in zip(wk, wp))
        err_u = max(rel_fro(a, b) for a, b in zip(uk, up))
        err_acc = max(rel_fro(a, b) for a, b in zip(ak[:nacc], ap[:nacc]))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(wk, wp))
        # both float32 sign schedules against an exact float64 eigh projection
        exact = [project_psd_plain(t64.to(dev)) for t64 in ts64]
        err_eigh = max(rel_fro(p, e) for p, e in zip(wp, exact))
        err_k_eigh = max(rel_fro(w, e) for w, e in zip(wk, exact))
        err_ku_eigh = max(rel_fro(u, t - e) for u, t, e in zip(uk, ts, exact))
        # controls: the plain schedule with products of operands truncated
        # to 10 (TF32-grade) and 16 mantissa bits, and with its last cubic
        # polish step dropped
        ctl = {f"control_{b}bit_vs_eigh": max(
            rel_fro(project_psd_ns(t, matmul=truncated_matmul(b)), e)
            for t, e in zip(ts, exact)) for b in (10, 16)}
        ctl["control_drop_polish_vs_eigh"] = max(
            rel_fro(project_psd_ns(t, schedule=_SIGN_SCHEDULE[:-1]), e)
            for t, e in zip(ts, exact))
        w2, u2, a2 = fresh()
        ms = cuda_time_ms(lambda: project_psd_ns_multi(
            ts, w_out=w2, u_out=u2, acc=a2, rho=rho, beta=beta))
        ms_plain = cuda_time_ms(lambda: psd_epilogue(
            ts, project_psd_ns_merged(ts), w2, u2, a2, rho, beta))
        # the library yardstick: the same chain of products through
        # torch.bmm (cuBLAS), without the epilogue
        ms_lib = cuda_time_ms(lambda: project_psd_ns_merged(ts))
        # every path k1_plan could take here (0: the tiles path, else the
        # cluster size): the measurements behind its choice
        by_cluster = {}
        for C in (0, 1, 2, 4, 8):
            try:
                k1_plan(dims, B, cluster=C)
            except ValueError:
                continue  # the strips do not fit clusters of C
            by_cluster[C] = cuda_time_ms(lambda: project_psd_ns_multi(
                ts, w_out=w2, u_out=u2, acc=a2, rho=rho, beta=beta, cluster=C))
        # two launches on the same input give the same bits (no atomics)
        wb, _, _ = fresh()
        project_psd_ns_multi(ts, w_out=wb)
        project_psd_ns_multi(ts, w_out=w2)
        plan = k1_plan(dims, B)
        # the plan's shared memory and workspace are the kernel's own
        plan_ok = (plan["smem"] == max(lib.omc_k1_cluster_smem(d, plan["cluster"])
                                       for d in dims) if plan["cluster"] else
                   plan["scratch_floats"] == [lib.omc_k1_scratch_floats(d, B) for d in dims])
        row = dict(B=B, dims=list(dims), plan=plan, plan_matches_kernel=plan_ok, rel_err=err,
                   rel_err_u=err_u, rel_err_acc=err_acc, max_abs_err=abs_err,
                   plain_vs_eigh=err_eigh, kernel_vs_eigh=err_k_eigh,
                   kernel_u_vs_eigh=err_ku_eigh, **ctl, deterministic=_same_bits(wb, w2),
                   ms=ms, plain_ms=ms_plain, library_ms=ms_lib, ms_by_cluster=by_cluster)
        # t read, w and u written, acc read and written (first two blocks);
        # the operations the function needs: the upper triangle of each of
        # the SIGN_PRODUCTS symmetric products (d (d + 1) / 2 entries of 2 d
        # operations), and the scaling, polynomial sums and epilogue
        flops = sum(B * (SIGN_PRODUCTS * (d ** 3 + d * d) + 6 * d * d) for d in dims)
        # K1's route: 3xTF32 products on the tensor cores, three passes each
        with_bound(row, 4 * sum(B * d * d * (3 + (2 if g < nacc else 0))
                                for g, d in enumerate(dims)), 3 * flops, PEAK_TF32_FLOPS)
        row["bound_flops"] = float(flops)
        # the same operations at the fp32 rate outside the tensor cores
        row["bound_fp32_ms"] = bound(row["bound_bytes"], flops)[0]
        log("K1", json.dumps(row))
        # Each float32 run of the 43-matmul chain sits ~5e-5 (relative
        # Frobenius) from the exact projection: rounding in the early
        # quintic steps is amplified by their slope (~3.5) until the small
        # eigenvalues reach +-1, and the cubic polish does not damp errors
        # that mix the two eigenspaces.  Two float32 runs with different
        # summation orders therefore agree only to the sum of their own
        # errors: each must be within 1e-4 of the exact projection, so the
        # kernel and the plain version agree within 2e-4.  Both truncated-
        # product controls must fail the 1e-4 bar (a NaN from a diverged
        # TF32-grade chain fails it too).  The dropped polish step is
        # recorded, not asserted: at these spectra the remaining steps
        # already reach +-1, so it moves the result by less than float32
        # rounding.
        # The plain float32 chain's own distance grows with d (~sqrt(d)
        # rounding in each product): at d = 2000 it is ~3.5e-4, so there the
        # 1e-4 bar holds the kernel alone and the kernel must be no farther
        # from the exact projection than the plain version is.  The kernel's
        # u is held to the exact t - proj(t) at the same bar as its w.
        plain_ok = err_eigh <= 1e-4 and err <= 2e-4 and err_u <= 2e-4
        if max(dims) > 500:
            plain_ok = err_k_eigh <= err_eigh
        checks.append(("K1", row, plain_ok and err_k_eigh <= 1e-4 and err_ku_eigh <= 1e-4
                       and err_acc <= 2e-4 and plan_ok and row["deterministic"]
                       and not ctl["control_10bit_vs_eigh"] <= 1e-4
                       and not ctl["control_16bit_vs_eigh"] <= 1e-4))
        k1.append(row)
    out["K1"] = k1

    # ---- K2 / K3 ----
    k2, k3 = [], []
    for L in (8, 32):
        c, st, acc, ts = _admm_inputs(64, 50, 50, 1, L, gen, dev)
        r2, r3 = _check_k2_k3(c, st, acc, ts)
        log("K2", json.dumps(r2))
        log("K3", json.dumps(r3))
        checks.append(("K2", r2, r2["rel_err"] <= 1e-6))
        checks.append(("K3", r3, r3["rel_err"] <= 1e-6))
        k2.append(r2)
        k3.append(r3)
    # K2 and K3 at k = 2 (BASELINE config 3: B = 64, n = m = 75, L in {8, 32})
    for L in (8, 32):
        c, st, acc, ts = _admm_inputs(64, 75, 75, 2, L, gen, dev)
        r2, r3 = _check_k2_k3(c, st, acc, ts)
        log("K2", json.dumps(r2))
        log("K3", json.dumps(r3))
        checks.append(("K2", r2, r2["rel_err"] <= 1e-6))
        checks.append(("K3", r3, r3["rel_err"] <= 1e-6))
        k2.append(r2)
        k3.append(r3)
    out["K2"], out["K3"] = k2, k3

    # ---- K7, projection mode: (32, 4096, 5, 5), spectra +-[0.1, 1] ----
    from omc_torch.ops.polar import project_psd_ns_small, project_psd_small

    T, T64 = _spectral_batch(32 * 4096, 5, gen, dev)
    T, T64 = T.reshape(32, 4096, 5, 5), T64.reshape(32, 4096, 5, 5)
    wk = project_psd_small(T)
    torch.cuda.synchronize()
    wp = project_psd_ns_small(T)
    exact = project_psd_plain(T64.to(dev))
    # control: the plain schedule with operands truncated to 16 bits
    ctl16 = rel_fro(project_psd_ns(T, matmul=truncated_matmul(16)), exact)
    w2 = torch.empty_like(T)
    row = dict(shape=list(T.shape), rel_err=rel_fro(wk, wp),
               max_abs_err=float((wk - wp).abs().max()),
               plain_vs_eigh=rel_fro(wp, exact), kernel_vs_eigh=rel_fro(wk, exact),
               control_16bit_vs_eigh=ctl16,
               ms=cuda_time_ms(lambda: project_psd_small(T, w2)),
               plain_ms=cuda_time_ms(lambda: project_psd_ns_small(T)))
    with_bound(row, 4 * 2 * T.numel(), T.numel() // 25 * (SIGN_PRODUCTS * 250 + 75))
    log("K7", json.dumps(row))
    # the bars of K1 (see above): each within 1e-4 of the exact
    # projection, the two within 2e-4, the truncated control fails
    checks.append(("K7", row, row["plain_vs_eigh"] <= 1e-4 and row["kernel_vs_eigh"] <= 1e-4
                   and row["rel_err"] <= 2e-4 and not ctl16 <= 1e-4))
    out["K7"] = [row]

    # ---- K8a, K7 fused, K8b at config 2's shapes ----
    rows = _check_shor_kernels(32, 100, 100, 8, 1024, gen, dev)
    for name, row in rows.items():
        log(name, json.dumps(row))
    checks.append(("K8a", rows["K8a"], rows["K8a"]["rel_err"] <= 1e-5))
    checks.append(("K8b", rows["K8b"], rows["K8b"]["rel_err"] <= 1e-5))
    r7 = rows["K7fused"]
    checks.append(("K7fused", r7, r7["plain_vs_eigh"] <= 1e-4 and r7["kernel_vs_eigh"] <= 1e-4
                   and r7["rel_err"] <= 2e-4))
    out.update({name: [row] for name, row in rows.items()})

    # ---- K7x projection mode: (32, 4096, 3, 3), spectra +-[0.1, 1] ----
    from omc_torch.ops.polar import project_psd_xwh

    T, T64 = _spectral_batch(32 * 4096, 3, gen, dev)
    T, T64 = T.reshape(32, 4096, 3, 3), T64.reshape(32, 4096, 3, 3)
    wk = project_psd_xwh(T)
    torch.cuda.synchronize()
    wp = project_psd_ns_small(T)
    exact = project_psd_plain(T64.to(dev))
    ctl16 = rel_fro(project_psd_ns(T, matmul=truncated_matmul(16)), exact)
    w2 = torch.empty_like(T)
    row = dict(shape=list(T.shape), rel_err=rel_fro(wk, wp),
               max_abs_err=float((wk - wp).abs().max()),
               plain_vs_eigh=rel_fro(wp, exact), kernel_vs_eigh=rel_fro(wk, exact),
               control_16bit_vs_eigh=ctl16,
               ms=cuda_time_ms(lambda: project_psd_xwh(T, w2)),
               plain_ms=cuda_time_ms(lambda: project_psd_ns_small(T)))
    with_bound(row, 4 * 2 * T.numel(), T.numel() // 9 * (SIGN_PRODUCTS * 54 + 27))
    log("K7x", json.dumps(row))
    checks.append(("K7x", row, row["plain_vs_eigh"] <= 1e-4 and row["kernel_vs_eigh"] <= 1e-4
                   and row["rel_err"] <= 2e-4 and not ctl16 <= 1e-4))
    out["K7x"] = [row]

    # ---- K8c, K7t, K7x (slots), K8d at BASELINE config 3's shapes ----
    rows = _check_shor_k_kernels(32, 75, 75, 8, 1024, gen, dev)
    for name, row in rows.items():
        log(name, json.dumps(row))
    # K8c and K8d: float32 sums in another order than the plain version's
    # scatter-adds, so 1e-5 relative as K8a/K8b; two launches on the same
    # input must give the same bits (no atomics)
    for name in ("K8c", "K8d"):
        r = rows[name]
        checks.append((name, r, r["rel_err"] <= 1e-5 and r["deterministic"]))
    # K7t and the K7x slots: the bars of K1/K7 against a float64 eigh
    # projection of the same slot values
    for name in ("K7t", "K7xfused"):
        r = rows[name]
        checks.append((name, r, r["plain_vs_eigh"] <= 1e-4 and r["kernel_vs_eigh"] <= 1e-4
                       and r["rel_err"] <= 2e-4))
    out.update({name: [row] for name, row in rows.items()})

    # ---- K9s, K9a, K9b at the headline's shape and at config 3's ----
    for name in ("K9s", "K9a", "K9b"):
        out[name] = []
    for B, n, k in ((64, 50, 1), (64, 75, 2)):
        rows = _check_mc_kernels(B, n, n, k, gen, dev)
        for name, row in rows.items():
            log(name, json.dumps(row))
            # float32 sums in another order than the plain version's, so
            # 1e-5 relative as K8c/K8d; two launches give the same bits;
            # K9s's factors reproduce the row Grams
            checks.append((name, row, row["rel_err"] <= 1e-5 and row["deterministic"]
                           and row.get("gram_rel_err", 0.0) <= 1e-5))
            out[name].append(row)

    # ---- K4, K4s, K5, K6: the eigensolvers and altmin's ridge steps ----
    rows = _check_eig_kernels(gen, dev)
    for name, rs in rows.items():
        for row in rs:
            log(name, json.dumps(row))
            checks.append((name, row, row["ok"]))
    out.update(rows)
    res["kernels"] = out
    failed = [(name, row) for name, row, ok in checks if not ok]
    assert not failed, failed


def _shor_inputs(B, n, m, L, M5, gen, dev):
    """Random Shor ADMM state and node batch at a config-2 shape (float32
    on the card): ~M5 - 24 random distinct 2x2 minors per slot, the RSOC
    rows on the rest, slot values and duals of unit scale."""
    import numpy as np
    import torch

    from omc_torch.sdp import admm_shor
    from omc_torch.sdp.shor import shor_soc_complement
    from omc_torch.sdp.shor_encode import pack_shor_batch

    c, core, acc, ts = _admm_inputs(B, n, m, 1, L, gen, dev)
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    minors = []
    for _ in range(B):
        i = np.sort(rng.choice(n, (4 * M5, 2)), axis=1)
        j = np.sort(rng.choice(m, (4 * M5, 2)), axis=1)
        ok = (i[:, 0] < i[:, 1]) & (j[:, 0] < j[:, 1])
        cand = dict.fromkeys(map(tuple, np.stack([i[:, 0], i[:, 1], j[:, 0], j[:, 1]], 1)[ok]))
        minors.append([tuple(int(v) for v in mm) for mm in list(cand)[: M5 - 24]])
    socs = [shor_soc_complement(n, m, mm) for mm in minors]
    sbh = pack_shor_batch(n, m, minors, socs, M5, n * m)
    sb = admm_shor.shor_batch_to_device(sbh, torch.float32, device=dev)
    st = admm_shor.init_shor_state(B, n, m, 1, L, M5, n * m, torch.float32, device=dev)
    st = st.replace(core=core)
    core.sS.copy_(core.sX)
    for name in ("W", "v1", "v2", "v3", "w5", "u5", "wr", "ur", "wl", "ul", "wp", "up"):
        t = getattr(st, name)
        v = torch.tensor(rng.standard_normal(tuple(t.shape)) * 0.3, dtype=torch.float32, device=dev)
        if name in ("w5", "u5"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.minor_mask[..., None, None]
        t.copy_(v)
    sc = admm_shor.make_shor_consts(c, sb, core, 40.0)
    return c, sc, st


def _check_shor_kernels(B, n, m, L, M5, gen, dev):
    """K8a, K7 (fused) and K8b against their plain versions on the same
    inputs, each at the outputs of the step before it, with times."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns_small
    from omc_torch.sdp import admm_shor as S

    c, sc, st = _shor_inputs(B, n, m, L, M5, gen, dev)

    out = {}
    sk = st.clone()
    S.shor_zstep(c, sc, sk)
    torch.cuda.synchronize()
    ref = S.shor_zstep_plain(c, sc, st)
    rel, ab = _errs((sk.core.X, sk.core.Th, sk.W, sk.v1, sk.v2, sk.v3), ref)
    s2 = st.clone()
    out["K8a"] = dict(B=B, n=n, m=m, M5=M5, rel_err=rel, max_abs_err=ab,
                      ms=cuda_time_ms(lambda: S.shor_zstep(c, sc, s2)),
                      plain_ms=cuda_time_ms(lambda: S.shor_zstep_plain(c, sc, st)))
    A_ = float(sc.sb.minor_mask.sum())  # active minors over the batch
    P = sum(t.shape[1] for t in (st.v1, st.v2, st.v3))
    nm = n * m
    # per slot: X and Theta blocks of w1/u1, the RSOC X/W parts, W >= 0,
    # Theta-link, counts and tables; per active minor the 14 entries of w5/u5
    # the adjoint reads; out X, Theta, W, v
    rd = 2 * (nm + m * m) + 4 * nm + nm + 2 * m + 2 * nm + 2 * nm + (nm + 1) + P + 3 + m + 4
    with_bound(out["K8a"], 4 * (B * (rd + 2 * nm + m * m + P) + A_ * (2 * 14 + 9) + 2 * nm),
               B * 25 * nm + A_ * 40)

    # K7 fused at K8a's primal; the exact reference projects the same t5
    acc5 = torch.randn(st.u5.shape, generator=gen).to(dev) * 0.1
    s7 = sk.clone()
    a7 = acc5.clone()
    S.minor_step(c, sc, s7, a7, "ns")
    torch.cuda.synchronize()
    w5p, u5p, a5p = S.minor_step_plain(c, sc, sk, acc5, project_psd_ns_small)
    w5e, _, _ = S.minor_step_plain(c, sc, sk, acc5,
                                   lambda t: project_psd_plain(t.double()).float())
    rel, ab = _errs((s7.w5, s7.u5, a7), (w5p, u5p, a5p))
    s8 = sk.clone()
    a8 = acc5.clone()
    out["K7fused"] = dict(B=B, M5=M5, rel_err=rel, max_abs_err=ab,
                          plain_vs_eigh=rel_fro(w5p, w5e), kernel_vs_eigh=rel_fro(s7.w5, w5e),
                          ms=cuda_time_ms(lambda: S.minor_step(c, sc, s8, a8, "ns")),
                          plain_ms=cuda_time_ms(lambda: S.minor_step_plain(
                              c, sc, sk, acc5, project_psd_ns_small)))
    N = B * M5
    # w5/u5/acc read and written, X, W, v read once, the tables
    with_bound(out["K7fused"], 4 * (N * (6 * 25 + 10) + B * (2 * nm + P) + 2 * B),
               N * (SIGN_PRODUCTS * 250 + 75))

    # K8b at K8a's primal
    acc_r = torch.randn(st.ur.shape, generator=gen).to(dev) * 0.1
    acc_l = torch.randn(st.ul.shape, generator=gen).to(dev) * 0.1
    sb_ = sk.clone()
    ar, al = acc_r.clone(), acc_l.clone()
    S.shor_cone_step(c, sc, sb_, ar, al)
    torch.cuda.synchronize()
    ref = S.shor_cone_step_plain(c, sc, sk, acc_r, acc_l)
    rel, ab = _errs((sb_.wr, sb_.ur, sb_.wl, sb_.ul, sb_.wp, sb_.up, ar, al), ref)
    s9 = sk.clone()
    ar9, al9 = acc_r.clone(), acc_l.clone()
    out["K8b"] = dict(B=B, n=n, m=m, rel_err=rel, max_abs_err=ab,
                      ms=cuda_time_ms(lambda: S.shor_cone_step(c, sc, s9, ar9, al9)),
                      plain_ms=cuda_time_ms(lambda: S.shor_cone_step_plain(
                          c, sc, sk, acc_r, acc_l)))
    # per slot: X, W, the RSOC slots and their EMA (read and written), the
    # mask, W >= 0, Theta's diagonal and the link rows
    with_bound(out["K8b"], 4 * B * (2 * nm + 9 * nm + nm + 2 * nm + m + 3 * m + 9 * nm
                                    + 2 * nm + 3 * m + 4),
               B * 40 * nm)
    return out


def _shor_k_inputs(B, n, m, L, M5, gen, dev, k=2):
    """Random rank-k Shor ADMM state and node batch at a config-3 shape
    (float32 on the card): ~M5 - 24 random distinct 2x2 minors per slot, the
    RSOC rows on the rest, slot values and duals of unit scale."""
    import numpy as np
    import torch

    from omc_torch.sdp import shor_k as SK
    from omc_torch.sdp.shor import shor_soc_complement

    c, core, acc, ts = _admm_inputs(B, n, m, k, L, gen, dev)
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    minors = []
    for _ in range(B):
        i = np.sort(rng.choice(n, (4 * M5, 2)), axis=1)
        j = np.sort(rng.choice(m, (4 * M5, 2)), axis=1)
        ok = (i[:, 0] < i[:, 1]) & (j[:, 0] < j[:, 1])
        cand = dict.fromkeys(map(tuple, np.stack([i[:, 0], i[:, 1], j[:, 0], j[:, 1]], 1)[ok]))
        minors.append([tuple(int(v) for v in mm) for mm in list(cand)[: M5 - 24]])
    socs = [shor_soc_complement(n, m, mm) for mm in minors]
    sbh = SK.pack_shor_k_batch(n, m, minors, socs, M5, n * m)
    sb = SK.shor_k_batch_to_device(sbh, torch.float32, device=dev)
    st = SK.init_shor_k_state(B, n, m, k, L, M5, n * m, torch.float32, device=dev)
    st = st.replace(core=core)
    core.sS.copy_(core.sX)
    for name in ("Xt", "W", "Wt", "Hh", "v1", "v2", "v3", "w5", "u5", "wx", "ux", "wr", "ur",
                 "wl", "ul", "wwl", "uwl", "wp", "up", "wq", "uq"):
        t = getattr(st, name)
        v = torch.tensor(rng.standard_normal(tuple(t.shape)) * 0.3, dtype=torch.float32, device=dev)
        if name in ("w5", "u5"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.minor_mask[..., None, None, None]
        if name in ("wx", "ux"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.coord_mask[..., None, None]
        t.copy_(v)
    sc = SK.make_shor_k_consts(c, sb, core, 40.0, k)
    return c, sc, st


def _check_shor_k_kernels(B, n, m, L, M5, gen, dev):
    """K8c, K7t, K7x (slots) and K8d against their plain versions on the
    same inputs, each at the outputs of the step before it, with times,
    bounds and a determinism check of K8c and K8d."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns_small
    from omc_torch.sdp import shor_k as SK

    c, sc, st = _shor_k_inputs(B, n, m, L, M5, gen, dev)
    k, kp, C, Ms = st.Xt.shape[1], st.Hh.shape[1], st.Wt.shape[2], st.wr.shape[1]
    nm = n * m
    P = sum(t.shape[2] for t in (st.v1, st.v2, st.v3))
    sb = sc.sb
    A_ = float(sb.minor_mask.sum())   # active minors over the batch
    Ca = float(sb.coord_mask.sum())   # active coordinates
    Sa = float(sb.soc_mask.sum())     # active RSOC rows

    out = {}
    zs = lambda x: (x.Xt, x.core.X, x.core.Th, x.W, x.Wt, x.Hh, x.v1, x.v2, x.v3)  # noqa: E731
    sk = st.clone()
    SK.shor_k_zstep(c, sc, sk)
    s2 = st.clone()
    SK.shor_k_zstep(c, sc, s2)
    torch.cuda.synchronize()
    ref = SK.shor_k_zstep_plain(c, sc, st)
    rel, ab = _errs(zs(sk), ref)
    s3 = st.clone()
    out["K8c"] = dict(B=B, n=n, m=m, k=k, M5=M5, rel_err=rel, max_abs_err=ab,
                      deterministic=_same_bits(zs(sk), zs(s2)),
                      ms=cuda_time_ms(lambda: SK.shor_k_zstep(c, sc, s3)),
                      plain_ms=cuda_time_ms(lambda: SK.shor_k_zstep_plain(c, sc, st)))
    # per slot: X and Theta blocks of w1/u1, Xt_prev, W >= 0, Wt >= 0, the
    # link rows, the entry/coordinate constants and tables; per active minor
    # and term the 14 entries of w5/u5 the adjoint reads, per active
    # coordinate k^2 + k entries of wx/ux, per active RSOC row 2 of wr/ur;
    # out Xt, X, Theta, W, Wt, H, v
    rd = (2 * (nm + m * m) + k * nm + 2 * nm + 2 * k * C + 2 * m + 7 * nm + 5 * C + m + P
          + 2 * m + (C + 1) + (P + 3) + 4)
    wr = k * nm + nm + m * m + nm + (k + kp) * C + k * P
    per_act = A_ * k * 2 * 14 + A_ * 9 + Ca * (2 * (k * k + k) + 3) + Sa * 5
    with_bound(out["K8c"], 4 * (B * (rd + wr) + per_act + 2 * nm),
               B * nm * (12 * k + 25) + 30 * k * A_ + 20 * Ca)

    # K7t at K8c's primal; the exact reference projects the same t5
    acc5 = torch.randn(st.u5.shape, generator=gen).to(dev) * 0.1
    s7 = sk.clone()
    a7 = acc5.clone()
    SK.minor_k_step(c, sc, s7, a7, "ns")
    torch.cuda.synchronize()
    exact = lambda t: project_psd_plain(t.double()).float()  # noqa: E731
    w5p, u5p, a5p = SK.minor_k_step_plain(c, sc, sk, acc5, project_psd_ns_small)
    w5e, _, _ = SK.minor_k_step_plain(c, sc, sk, acc5, exact)
    rel, ab = _errs((s7.w5, s7.u5, a7), (w5p, u5p, a5p))
    s8, a8 = sk.clone(), acc5.clone()
    out["K7t"] = dict(B=B, M5=M5, k=k, rel_err=rel, max_abs_err=ab,
                      plain_vs_eigh=rel_fro(w5p, w5e), kernel_vs_eigh=rel_fro(s7.w5, w5e),
                      ms=cuda_time_ms(lambda: SK.minor_k_step(c, sc, s8, a8, "ns")),
                      plain_ms=cuda_time_ms(lambda: SK.minor_k_step_plain(
                          c, sc, sk, acc5, project_psd_ns_small)))
    N = B * M5 * k
    with_bound(out["K7t"], 4 * (N * 6 * 25 + B * M5 * 10 + B * k * (nm + C) + B * k * P
                                + B * C + 2 * B),
               N * (SIGN_PRODUCTS * 250 + 75))

    # K7x on the XWH slots at K8c's primal
    accx = torch.randn(st.ux.shape, generator=gen).to(dev) * 0.1
    sx_ = sk.clone()
    ax = accx.clone()
    SK.xwh_step(c, sc, sx_, ax, "ns")
    torch.cuda.synchronize()
    wxp, uxp, axp = SK.xwh_step_plain(c, sc, sk, accx, project_psd_ns_small)
    wxe, _, _ = SK.xwh_step_plain(c, sc, sk, accx, exact)
    rel, ab = _errs((sx_.wx, sx_.ux, ax), (wxp, uxp, axp))
    s9, a9 = sk.clone(), accx.clone()
    out["K7xfused"] = dict(B=B, C=C, k=k, rel_err=rel, max_abs_err=ab,
                           plain_vs_eigh=rel_fro(wxp, wxe), kernel_vs_eigh=rel_fro(sx_.wx, wxe),
                           ms=cuda_time_ms(lambda: SK.xwh_step(c, sc, s9, a9, "ns")),
                           plain_ms=cuda_time_ms(lambda: SK.xwh_step_plain(
                               c, sc, sk, accx, project_psd_ns_small)))
    D = k + 1
    with_bound(out["K7xfused"], 4 * (B * C * (6 * D * D + 2) + B * k * nm + B * (k + kp) * C
                                     + 2 * B),
               B * C * (SIGN_PRODUCTS * 2 * D ** 3 + 3 * D * D))

    # K8d at K8c's primal
    accs = [torch.randn(x.shape, generator=gen).to(dev) * 0.1 for x in (st.ur, st.ul, st.uwl)]
    kd = lambda x: (x.wr, x.ur, x.wl, x.ul, x.wwl, x.uwl, x.wp, x.up, x.wq, x.uq)  # noqa: E731
    sd = sk.clone()
    ad = [a.clone() for a in accs]
    SK.shor_k_cone_step(c, sc, sd, *ad)
    sd2 = sk.clone()
    ad2 = [a.clone() for a in accs]
    SK.shor_k_cone_step(c, sc, sd2, *ad2)
    torch.cuda.synchronize()
    ref = SK.shor_k_cone_step_plain(c, sc, sk, *accs)
    rel, ab = _errs(kd(sd) + tuple(ad), ref)
    s10 = sk.clone()
    a10 = [a.clone() for a in accs]
    out["K8d"] = dict(B=B, n=n, m=m, k=k, C=C, Ms=Ms, rel_err=rel, max_abs_err=ab,
                      deterministic=_same_bits(kd(sd) + tuple(ad), kd(sd2) + tuple(ad2)),
                      ms=cuda_time_ms(lambda: SK.shor_k_cone_step(c, sc, s10, *a10)),
                      plain_ms=cuda_time_ms(lambda: SK.shor_k_cone_step_plain(
                          c, sc, sk, *accs)))
    # per slot: X, W, Theta's diagonal, Wt, H, the RSOC rows with their EMA
    # and tables, the link rows with their EMAs, W >= 0, Wt >= 0; out the
    # same slots and EMAs
    rd = (2 * nm + m + (k + kp) * C + 9 * Ms + 2 * Ms + 2 * m + 2 * C + 2 * nm + 2 * k * C
          + 2 * C + 4)
    wr = 9 * Ms + 3 * m + 3 * C + 2 * nm + 2 * k * C
    with_bound(out["K8d"], 4 * B * (rd + wr),
               B * (40 * Ms + 6 * nm + (k + kp + 6) * C + 5 * k * C))
    return out


def _admm_inputs(B, n, m, k, L, gen, dev):
    """Random ADMM state and node batch at a main-path shape (float32 on
    the card): slot values and duals of unit scale, ~L/2 real cuts."""
    import numpy as np
    import torch

    from omc_torch.sdp.admm import init_admm_state, make_consts
    from omc_torch.sdp.cuts import region_bounds
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.tree import root_box

    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.5).astype(np.float64)
    cut_x = np.zeros((B, L, n))
    cut_lo = np.zeros((B, L, k))
    cut_hi = np.zeros((B, L, k))
    cut_mask = np.zeros((B, L))
    for b in range(B):
        for l in range(L // 2 + 1):
            x = rng.standard_normal(n)
            cut_x[b, l] = x / np.linalg.norm(x)
            cut_lo[b, l], cut_hi[b, l] = region_bounds(
                "linear", rng.integers(0, 2, k), rng.uniform(-0.5, 0.5, k))
            cut_mask[b, l] = 1.0
    lo, hi = root_box(n, k)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    batch = NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask),
                      f(np.broadcast_to(lo, (B, n, k))), f(np.broadcast_to(hi, (B, n, k))))
    st = init_admm_state(B, n, m, k, L, torch.float32, device=dev, sX=2.5, sT=1.7, rho=0.02)
    for name in ("w1", "w2", "w3", "w4", "wsoc", "wbox", "wa", "wb", "wc",
                 "u1", "u2", "u3", "u4", "usoc", "ubox", "ua", "ub", "uc",
                 "X", "Y", "Th", "U"):
        t = getattr(st, name)
        v = f(rng.standard_normal(tuple(t.shape)) * 0.3)
        if v.ndim == 3 and v.shape[-1] == v.shape[-2]:
            v = 0.5 * (v + v.transpose(-1, -2))
        if name in ("wa", "wb", "ua", "ub"):
            v = v * batch.cut_mask[..., None]
        if name in ("wc", "uc"):
            v = v * batch.cut_mask
        t.copy_(v)
    st.rho.copy_(f(rng.uniform(0.01, 0.1, B)))
    c = make_consts(f(A), f(mask), batch, st, n, m, k, 80.0, 1.9, 1e-3, torch.float32)
    acc = [torch.zeros_like(st.ua), torch.zeros_like(st.ub), torch.zeros_like(st.uc)]
    for a in acc:
        a.copy_(torch.randn(a.shape, generator=gen).to(dev) * 0.1)
    ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
    return c, st, acc, ts


def _check_k2_k3(c, st, acc, ts):
    import torch

    from omc_torch.sdp.admm import _REST, cone_step, cone_step_plain, zstep, zstep_plain

    s_k = st.clone()
    zstep(c, s_k)
    torch.cuda.synchronize()
    ref = zstep_plain(c, st)
    e2, a2 = _errs((s_k.X, s_k.Y, s_k.Th, s_k.U), ref)
    s_t = st.clone()
    ms2 = cuda_time_ms(lambda: zstep(c, s_t))
    ms2p = cuda_time_ms(lambda: zstep_plain(c, st))
    r2 = dict(B=c.batch.cut_mask.shape[0], n=c.n, m=c.m, k=c.k, L=c.L,
              rel_err=e2, max_abs_err=a2, ms=ms2, plain_ms=ms2p)
    B, n, m, k, L = r2["B"], c.n, c.m, c.k, c.L
    p = 1 + L + L * k
    # per slot: the residual blocks K2 reads (Y, X, Theta of w1/u1; Y, U of
    # w2/u2; w3/u3; the SOC, box and cut slots), the cuts, G1's lower
    # triangle; out X, Y, Theta, U; mask and mask*A once
    rd = (2 * (n * n + n * m + m * m) + 2 * (n * n + n * k) + 2 * n * n + 2 + 4 * k * n
          + 4 * L * k + 2 * L + L * n + 2 * L * k + L + 3 + p * (p + 1) // 2)
    wr = n * m + n * n + m * m + n * k
    with_bound(r2, 4 * (B * (rd + wr) + 2 * n * m),
               B * (8 * L * n * n + 4 * L * n * k + 2 * p * p + 10 * (n * m + n * n)))

    # K3 at the z-step's outputs
    s3 = s_k.clone()
    acc_k = [a.clone() for a in acc]
    ts_k = tuple(torch.empty_like(t) for t in ts)
    cone_step(c, s3, ts_k, acc_k)
    torch.cuda.synchronize()
    t1, t2, t3, rest, acc_p = cone_step_plain(c, s_k, acc)
    pairs = list(zip(ts_k, (t1, t2, t3)))
    pairs += [(getattr(s3, nm), v) for nm, v in zip(_REST, rest)]
    pairs += list(zip(acc_k, acc_p))
    e3, a3 = _errs(*zip(*pairs))
    s4 = s_k.clone()
    acc4 = [a.clone() for a in acc]
    ms3 = cuda_time_ms(lambda: cone_step(c, s4, ts_k, acc4))
    ms3p = cuda_time_ms(lambda: cone_step_plain(c, s_k, acc))
    r3 = dict(B=c.batch.cut_mask.shape[0], n=c.n, m=c.m, k=c.k, L=c.L,
              rel_err=e3, max_abs_err=a3, ms=ms3, plain_ms=ms3p)
    d1, d2 = n + m, n + k
    # per slot: X, Y, Theta, U and the w/u of every slot in; t1-t3 and the
    # non-PSD slots and the three EMAs out (the EMAs are read too)
    rd = (n * m + n * n + m * m + n * k + 2 * (d1 * d1 + d2 * d2 + n * n) + 2
          + 2 * k * (1 + n) + 2 * n * k + 4 * L * k + 2 * L + 2 * L * k + L + L * n
          + 3 * L * k + L + 2 * n * k + 3)
    wr = d1 * d1 + d2 * d2 + n * n + 2 + 2 * k * (1 + n) + 2 * n * k + 4 * L * k + 2 * L \
        + 2 * L * k + L
    with_bound(r3, 4 * B * (rd + wr),
               B * (2 * L * n * n + 2 * L * n * k + 5 * (d1 * d1 + d2 * d2 + n * n)))
    return r2, r3


def _mc_inputs(B, n, m, k, gen, dev):
    """Random McCormick ADMM state and node boxes at a main-path shape
    (float32 on the card): boxes inside [-1, 1] of widths 0.05 to 1, slot
    values and duals of unit scale, penalties around omc's 10."""
    import numpy as np
    import torch

    from omc_torch.sdp.mccormick import MCBatch, init_mc_state, make_mc_consts

    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    A = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.5).astype(np.float64)
    lo = rng.uniform(-1.0, 0.5, (B, n, k))
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, k)), 1.0)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    batch = MCBatch(f(lo), f(hi))
    st = init_mc_state(B, n, m, k, torch.float32, device=dev, sX=2.5, sT=1.7, rho=10.0)
    for name in ("w1", "w2", "w3", "w4", "wsoc", "wbox", "wmc", "worth", "u1", "u2", "u3",
                 "u4", "usoc", "ubox", "umc", "uorth", "X", "Y", "Th", "U", "t"):
        t = getattr(st, name)
        v = f(rng.standard_normal(tuple(t.shape)) * 0.3)
        if v.ndim == 3 and v.shape[-1] == v.shape[-2]:
            v = 0.5 * (v + v.transpose(-1, -2))
        t.copy_(v)
    st.rho.copy_(f(rng.uniform(5.0, 15.0, B)))
    c = make_mc_consts(f(A), f(mask), batch, st, n, m, k, 80.0, 1.6, torch.float32)
    return c, st


def _check_mc_kernels(B, n, m, k, gen, dev):
    """K9s, K9a and K9b against their plain versions on the same inputs
    (K9b at K9a's outputs), with times, bounds, a determinism check of each
    and, for K9s, Mc Mc' against the row Grams."""
    import torch

    from omc_torch.sdp import mccormick as MC

    c, st = _mc_inputs(B, n, m, k, gen, dev)
    q = k * (k + 1) // 2
    kq = k + q
    d1, d2 = n + m, n + k

    out = {}
    # ---- K9s ----
    got = MC.mc_setup(c.batch, k)
    got2 = MC.mc_setup(c.batch, k)
    torch.cuda.synchronize()
    ref = MC.mc_setup_plain(c.batch, k)
    gram = MC.mc_gram_plain(c.batch, k)
    rel, ab = _errs(got, ref)
    Et = torch.zeros((kq, q), dtype=torch.float32, device=dev)
    Et[k:] = torch.eye(q, dtype=torch.float32, device=dev)
    Etb = Et.expand(B, n, kq, q).contiguous()
    out["K9s"] = dict(B=B, n=n, k=k, rel_err=rel, max_abs_err=ab,
                      gram_rel_err=rel_fro(got[0] @ got[0].transpose(-1, -2), gram),
                      deterministic=_same_bits(got, got2),
                      ms=cuda_time_ms(lambda: MC.mc_setup(c.batch, k)),
                      plain_ms=cuda_time_ms(lambda: MC.mc_setup_plain(c.batch, k)),
                      # the library chain on the same Grams: cuSOLVER's
                      # batched Cholesky, then the triangular solves for S_i
                      library_ms=cuda_time_ms(
                          lambda: torch.cholesky_solve(Etb, torch.linalg.cholesky(gram))))
    # boxes in; Mc, Si, Gc out.  Per row: the Gram (4q rank-1 updates of
    # (k+q)^2), its Cholesky, q solves; per slot G's sum and Cholesky
    with_bound(out["K9s"], 4 * (B * n * (2 * k + kq * kq + kq * q) + B * q * q),
               B * n * (8 * q * kq * kq + kq ** 3 // 3 + 2 * q * kq * kq) + B * (n * q * q + q ** 3))

    # ---- K9a ----
    zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
    sk = st.clone()
    MC.mc_zstep(c, sk)
    s2 = st.clone()
    MC.mc_zstep(c, s2)
    torch.cuda.synchronize()
    rel, ab = _errs(zs(sk), MC.mc_zstep_plain(c, st))
    s3 = st.clone()
    out["K9a"] = dict(B=B, n=n, m=m, k=k, rel_err=rel, max_abs_err=ab,
                      deterministic=_same_bits(zs(sk), zs(s2)),
                      ms=cuda_time_ms(lambda: MC.mc_zstep(c, s3)),
                      plain_ms=cuda_time_ms(lambda: MC.mc_zstep_plain(c, st)),
                      library_ms=None)
    # per slot: the X, Theta, Y blocks of w1/u1, the Y and U blocks of
    # w2/u2, w3/u3, the trace, SOC, box, envelope and orthogonality slots,
    # the boxes, Mc, Si, Gc; out X, Y, Theta, U, t; mask and mask*A once
    rd = (2 * (n * m + m * m + n * n) + 2 * (n * n + n * k) + 2 * n * n + 2 + 2 * k * n
          + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + n * (kq * kq + kq * q) + q * q + 3)
    wr = n * m + n * n + m * m + n * k + n * q
    with_bound(out["K9a"], 4 * (B * (rd + wr) + 2 * n * m),
               B * (10 * (n * m + m * m + n * n) + n * (40 * q + 4 * kq * kq + 2 * kq * q)))

    # ---- K9b at K9a's outputs, with the running means ----
    acc = [torch.randn(x.shape, generator=gen).to(dev) * 0.1 for x in (st.umc, st.uorth)]
    beta = 0.25

    def run_k9b():
        sb_ = sk.clone()
        a_ = [a.clone() for a in acc]
        ts_ = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
        MC.mc_cone_step(c, sb_, ts_, a_, beta)
        return ts_ + tuple(getattr(sb_, name) for name in MC._REST) + tuple(a_)

    got = run_k9b()
    got2 = run_k9b()
    torch.cuda.synchronize()
    t1, t2, t3, rest, acc_p = MC.mc_cone_step_plain(c, sk, acc, beta)
    rel, ab = _errs(got, (t1, t2, t3) + tuple(rest) + tuple(acc_p))
    s4 = sk.clone()
    a4 = [a.clone() for a in acc]
    ts4 = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    out["K9b"] = dict(B=B, n=n, m=m, k=k, rel_err=rel, max_abs_err=ab,
                      deterministic=_same_bits(got, got2),
                      ms=cuda_time_ms(lambda: MC.mc_cone_step(c, s4, ts4, a4, beta)),
                      plain_ms=cuda_time_ms(lambda: MC.mc_cone_step_plain(c, sk, acc, beta)),
                      library_ms=None)
    # per slot: X, Y, Theta, U, t and the w/u of every slot in, the boxes and
    # both running means (read and written); t1-t3 and the non-PSD slots out
    rd = (n * m + n * n + m * m + n * k + n * q + 2 * (d1 * d1 + d2 * d2 + n * n) + 2
          + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + 4 * n * q + q + 3)
    wr = (d1 * d1 + d2 * d2 + n * n + 2 + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q
          + 4 * n * q + q)
    with_bound(out["K9b"], 4 * B * (rd + wr),
               B * (5 * (d1 * d1 + d2 * d2 + n * n) + 20 * n * q + 10 * n * k))
    return out


def _eig_batch(B, d, gen, dev):
    """Symmetric (B, d, d) float32 matrices Q diag(lam) Q' on the card, lam
    uniform in [-1, 1] with degenerate and negative clusters: for d >= 20
    five eigenvalues equal to 0.5, five within 1e-7 of -0.3 and five zeros;
    for small d a double eigenvalue in every second matrix and zeros in
    every fourth.  Returns the float32 batch and its float64 copy (the
    reference's input is the float32 matrix itself)."""
    import torch

    Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=torch.float64))
    lam = torch.empty(B, d, dtype=torch.float64).uniform_(-1.0, 1.0, generator=gen)
    if d >= 20:
        lam[:, :5] = 0.5
        lam[:, 5:10] = -0.3 + 1e-7 * torch.arange(5)
        lam[:, 10:15] = 0.0
    else:
        lam[1::2, :2] = 0.5
        lam[::4, 2:] = 0.0
    T = (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    T = (0.5 * (T + T.transpose(-1, -2))).float().to(dev).contiguous()
    return T, T.double()


def _check_eig_kernels(gen, dev):
    """K4 (three epilogues), K4s, K5 and K6 against float64 references and
    their plain versions on the card, with times, bounds and sweep counts.
    Bars: eigenvalues within 1e-5 max|lambda| and projections within 1e-5
    relative Frobenius of a float64 eigh of the same float32 input, K5's
    vectors within 1e-5 up to sign, K6 within 1e-5 relative of its plain
    version; no Jacobi hits its sweep cap.  Times: ``tm`` below."""
    import torch

    from omc_torch.ops import cones
    from omc_torch.ops.jacobi import MAX_SWEEPS
    from omc_torch.ops.linalg import (
        u_step_unconstrained,
        u_step_unconstrained_plain,
        v_step,
        v_step_plain,
    )
    from omc_torch.sdp.relax import separation_eigpairs, separation_eigpairs_plain

    out = {"K4": [], "K4s": [], "K5": [], "K6": [], "K4_nonfinite": []}
    i32 = dict(dtype=torch.int32, device=dev)

    def tm(fn):
        """Median of 20 timed calls; of 3 for a call over 20 ms (cuSOLVER
        at B=64), one call for a call over 200 ms (K4 at d=500)."""
        probe = cuda_time_ms(fn, reps=1, warmup=1)
        if probe > 200.0:
            return probe
        return cuda_time_ms(fn) if probe <= 20.0 else cuda_time_ms(fn, reps=3, warmup=0)

    # a NaN or an Inf runs to the sweep cap and gives NaN out (K4 and K4s)
    for D in (50, 5):
        T, _ = _eig_batch(2, D, gen, dev)
        T[0, 1, 2], T[1, 0, 0] = float("nan"), float("inf")
        sw = torch.empty(2, **i32)
        got = cones.k4_jacobi(T, 1, sweeps=sw) if D > 8 else cones.k4s_project_psd(T, sw)
        torch.cuda.synchronize()
        row = dict(D=D, sweeps=sw.tolist(), all_nan=bool(got.isnan().all()))
        row["ok"] = row["all_nan"] and row["sweeps"] == [MAX_SWEEPS + 1] * 2
        out["K4_nonfinite"].append(row)

    # ---- K4: the headline's S1 first (the row the record times) ----
    for B, d in ((64, 100), (64, 50), (64, 51), (64, 150), (32, 200), (2, 500)):
        T, T64 = _eig_batch(B, d, gen, dev)
        w64, V64 = torch.linalg.eigh(T64)
        P64 = (V64 * w64.clamp(min=0.0)[..., None, :]) @ V64.transpose(-1, -2)
        lam = w64.abs().amax(-1)
        # the plain eigenvalue and eigenpair versions are the library calls
        # themselves: each is timed once
        lib_eigvalsh = tm(lambda: torch.linalg.eigvalsh(T))
        lib_eigh = tm(lambda: torch.linalg.eigh(T))
        for mode in (1, 0, 2):
            sw = torch.empty(B, **i32)
            got = cones.k4_jacobi(T, mode, sweeps=sw)
            torch.cuda.synchronize()
            row = dict(B=B, d=d, mode=("eigvalsh", "projection", "eigh")[mode],
                       max_sweeps=int(sw.max()), min_sweeps=int(sw.min()))
            if mode == 1:
                row["rel_err_vs_f64"] = float(((got.double() - P64).norm(dim=(-2, -1))
                                               / P64.norm(dim=(-2, -1))).max())
                plain = cones.project_psd_plain(T)
                row["max_abs_err"] = float((got - plain).abs().max())
                times = (tm(lambda: cones.k4_jacobi(T, 1)), tm(lambda: cones.project_psd_plain(T)),
                         lib_eigh)
                ok = row["rel_err_vs_f64"] <= 1e-5
            else:
                w = got if mode == 0 else got[0]
                row["eig_err_vs_f64"] = float(((w.double() - w64).abs().amax(-1) / lam).max())
                if mode == 0:
                    row["max_abs_err"] = float((w - torch.linalg.eigvalsh(T)).abs().max())
                    times = (tm(lambda: cones.k4_jacobi(T, 0)), lib_eigvalsh, lib_eigvalsh)
                    ok = row["eig_err_vs_f64"] <= 1e-5
                else:
                    V = got[1].double()
                    resid = (T64 @ V - V * w.double()[..., None, :]).norm(dim=(-2, -1))
                    eye = torch.eye(d, dtype=torch.float64, device=dev)
                    row["residual"] = float((resid / T64.norm(dim=(-2, -1))).max())
                    row["orthogonality"] = float((V.transpose(-1, -2) @ V - eye)
                                                 .norm(dim=(-2, -1)).max())
                    # eigenvalues only: the vectors of a cluster are a basis
                    # of its subspace, not unique, and signs are free
                    row["max_abs_err"] = float((w - cones.eigh_plain(T)[0]).abs().max())
                    times = (tm(lambda: cones.k4_jacobi(T, 2)), lib_eigh, lib_eigh)
                    ok = (row["eig_err_vs_f64"] <= 1e-5 and row["residual"] <= 1e-5 * d ** 0.5
                          and row["orthogonality"] <= 1e-5 * d ** 0.5)
            row["ok"] = ok and row["max_sweeps"] <= MAX_SWEEPS
            row.update(ms=times[0], plain_ms=times[1], library_ms=times[2])
            # an eigendecomposition counts 9 d^3 flops with vectors and
            # 4 d^3 / 3 without, whatever the method; the projection adds
            # the symmetric half of V max(w, 0) V' (d^3)
            outf = (d, d * d, d * d + d)[mode]
            with_bound(row, 4 * B * (d * d + outf),
                       B * (4 * d ** 3 / 3, 10 * d ** 3, 9 * d ** 3)[mode])
            out["K4"].append(row)

    # ---- K4s: the Shor bounds' 5x5 minors and 3x3 XWH slots, 32 x 4096 ----
    for D in (5, 3):
        T, T64 = _eig_batch(32 * 4096, D, gen, dev)
        sw = torch.empty(T.shape[0], **i32)
        got = cones.k4s_project_psd(T, sw)
        torch.cuda.synchronize()
        P64 = cones.project_psd_plain(T64)
        plain = cones.project_psd_plain(T)
        per = ((got.double() - P64).norm(dim=(-2, -1)) / T64.norm(dim=(-2, -1))).max()
        row = dict(N=T.shape[0], D=D, rel_err_vs_f64=rel_fro(got, P64),
                   per_matrix_err_vs_f64=float(per), max_abs_err=float((got - plain).abs().max()),
                   max_sweeps=int(sw.max()), min_sweeps=int(sw.min()),
                   ms=tm(lambda: cones.k4s_project_psd(T)),
                   plain_ms=tm(lambda: cones.project_psd_plain(T)),
                   # cuSOLVER's batched eigh, chunked below its limit
                   library_ms=tm(lambda: cones.eigh_plain(T)))
        row["ok"] = (row["rel_err_vs_f64"] <= 1e-5 and row["per_matrix_err_vs_f64"] <= 1e-5
                     and row["max_sweeps"] <= MAX_SWEEPS)
        with_bound(row, 4 * 2 * T.numel(), T.shape[0] * 10 * D ** 3)
        out["K4s"].append(row)

    # ---- K5: U U' - Y with its two smallest eigenvalues -1 and -0.6 ----
    for B, n, k in ((64, 50, 1), (64, 75, 2)):
        U = torch.randn(B, n, k, generator=gen, dtype=torch.float64)
        Q, _ = torch.linalg.qr(torch.randn(B, n, n, generator=gen, dtype=torch.float64))
        lam = torch.empty(B, n, dtype=torch.float64).uniform_(-0.3, 1.0, generator=gen)
        lam[:, 0], lam[:, 1] = -1.0, -0.6
        Y = U @ U.transpose(-1, -2) - (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
        U32 = U.float().to(dev).contiguous()
        Y32 = (0.5 * (Y + Y.transpose(-1, -2))).float().to(dev).contiguous()
        M64 = U32.double() @ U32.double().transpose(-1, -2) - Y32.double()
        w64, V64 = torch.linalg.eigh(0.5 * (M64 + M64.transpose(-1, -2)))
        sw = torch.empty(B, **i32)
        w, V = cones.k4_jacobi(None, 2, 2, U=U32, Y=Y32, sweeps=sw)
        torch.cuda.synchronize()
        wp, Vp = separation_eigpairs_plain(U32, Y32)

        def aligned(X, R):  # X's columns with R's signs
            return X * torch.sign(torch.sum(X * R, dim=-2, keepdim=True))

        Va = aligned(V.double(), V64[..., :2])
        M32 = 0.5 * (M64 + M64.transpose(-1, -2)).float()
        row = dict(B=B, n=n, k=k, max_sweeps=int(sw.max()), min_sweeps=int(sw.min()),
                   eig_err_vs_f64=float(((w.double() - w64[:, :2]).abs().amax(-1)
                                         / w64.abs().amax(-1)).max()),
                   vec_err_vs_f64=float((Va - V64[..., :2]).norm(dim=-2).max()),
                   max_abs_err=max(float((w - wp).abs().max()),
                                   float((aligned(V, Vp) - Vp).abs().max())),
                   ms=tm(lambda: separation_eigpairs(U32, Y32)),
                   plain_ms=tm(lambda: separation_eigpairs_plain(U32, Y32)),
                   library_ms=tm(lambda: torch.linalg.eigh(M32)))
        row["ok"] = (row["eig_err_vs_f64"] <= 1e-5 and row["vec_err_vs_f64"] <= 1e-5
                     and row["max_sweeps"] <= MAX_SWEEPS)
        with_bound(row, 4 * B * (n * k + n * n + 2 + 2 * n), B * 9 * n ** 3)
        out["K5"].append(row)

    # ---- K6: one V-step + U-step at the headline's n = m = 50 ----
    n = m = 50
    A = torch.randn(n, m, generator=gen).to(dev)
    mask = (torch.rand(n, m, generator=gen) < 0.5).float().to(dev)
    for B, k in ((4, 1), (64, 1), (4, 2), (64, 2), (4, 10), (64, 10)):
        # well-conditioned factors, as altmin's SVD warm start gives
        Q, _ = torch.linalg.qr(torch.randn(B, n, k, generator=gen, dtype=torch.float64))
        U = (Q * torch.empty(B, 1, k, dtype=torch.float64).uniform_(0.5, 2.0, generator=gen))
        U = U.float().to(dev).contiguous()
        V = v_step(U, A, mask, 80.0)
        U2 = u_step_unconstrained(V, A, mask, 80.0)
        torch.cuda.synchronize()
        Vp = v_step_plain(U, A, mask, 80.0)
        U2p = u_step_unconstrained_plain(V, A, mask, 80.0)  # on the kernel's V
        G = torch.einsum("bnk,nm,bnl->bmkl", U, mask, U) + (1 / 80.0) * (
            U.transpose(-1, -2) @ U)[:, None] + 1e-10 * torch.eye(k, device=dev)
        r = (U.transpose(-1, -2) @ (mask * A)).transpose(-1, -2)[..., None]
        H = torch.einsum("bkm,nm,blm->bnkl", V, mask, V) + (1 / 80.0) * (
            V @ V.transpose(-1, -2))[:, None] + 1e-10 * torch.eye(k, device=dev)
        r2 = ((mask * A) @ V.transpose(-1, -2))[..., None]
        row = dict(B=B, n=n, m=m, k=k, rel_err=max(rel_fro(V, Vp), rel_fro(U2, U2p)),
                   max_abs_err=max(float((V - Vp).abs().max()), float((U2 - U2p).abs().max())),
                   ms=cuda_time_ms(lambda: u_step_unconstrained(v_step(U, A, mask, 80.0),
                                                                A, mask, 80.0)),
                   plain_ms=cuda_time_ms(lambda: u_step_unconstrained_plain(
                       v_step_plain(U, A, mask, 80.0), A, mask, 80.0)),
                   # the library's batched solves on the same Grams
                   library_ms=cuda_time_ms(lambda: (torch.linalg.solve(G, r),
                                                    torch.linalg.solve(H, r2))))
        row["ok"] = row["rel_err"] <= 1e-5
        # A and the mask read once, U in, V and U out; per observed entry
        # and slot, in each of the two steps, the lower triangle of the
        # masked k x k Gram term (k^2 + k flops) and the right-hand side (2k)
        nnz = float(mask.sum())
        with_bound(row, 4 * (2 * n * m + B * (2 * n * k + k * m)),
                   2 * B * nnz * (k * k + 3 * k))
        out["K6"].append(row)
    return out


def _bench_instance(frac, seed=0, n=50):
    from omc_torch.data import generate_matrix_completion_data

    return generate_matrix_completion_data(1, n, n, int(round(frac * n * n)), seed)


BENCH_KW = dict(
    node_selection="bestfirst", disjunctive_cuts_type="linear",
    disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-4,
    time_limit=600, batch_size=64, sdp_iters=2000, dtype="float32",
    altmin_root_n_iters=3, verbosity=0,
)


def _admm_root(B=64, L=8, iters=2000):
    """One root ADMM visit of the headline instance at a batch of B copies:
    the solver, its arguments and the problem's constants."""
    import numpy as np
    import torch

    from omc_torch.sdp.admm import init_admm_state, make_admm_solver
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.solve import _polish_incumbent
    from omc_torch.tree import root_box

    dev = torch.device("cuda", 0)
    A, idx = _bench_instance(0.5)
    mask = idx.astype(np.float64)
    n, m, k, gamma = 50, 50, 1, 80.0
    U0 = np.linalg.svd(A * mask, full_matrices=False)[0][:, :k]
    obj0, X0, U0 = _polish_incumbent(U0 @ (U0.T @ (A * mask)), A, mask, gamma, k)
    V0 = U0.T @ X0
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = max(1.0, 2.0 * gamma * obj0 / (4.0 * m))
    rho = min(0.05, (62.5 / (n * m)) * min(2.0, 0.5 / max(mask.mean(), 1e-6)))
    lo, hi = root_box(n, k)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    batch = NodeBatch(f(np.zeros((B, L, n))), f(np.zeros((B, L, k))), f(np.zeros((B, L, k))),
                      f(np.zeros((B, L))), f(np.broadcast_to(lo, (B, n, k))),
                      f(np.broadcast_to(hi, (B, n, k))))
    st = init_admm_state(B, n, m, k, L, torch.float32, device=dev, sX=sX, sT=sT,
                         X0=X0[None], Y0=(U0 @ U0.T)[None], Th0=(V0.T @ V0)[None],
                         U0=U0[None], rho=rho)
    solve = make_admm_solver(n, m, k, L, gamma, iters=iters, dtype=torch.float32,
                             alpha=1.9, check_every=1000, ema_iters=1000)
    ub_bar = obj0 * (1 + 1e-9) + 1e-9
    return solve, (f(A), f(mask), batch, ub_bar, st), dict(A=A, mask=mask, k=k, gamma=gamma,
                                                          ub_bar=ub_bar, obj0=obj0)


def phase_admm(res):
    """One root visit (B=64, L=8, 2,000 iterations: two safe-bound calls
    through K4 and one separation through K5); the device bound against the
    float64 host bound.  The same bound through torch's eigh is logged."""
    import numpy as np
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.sdp import relax

    solve, args, c = _admm_root(64)
    B, L = 64, 8
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    _, out = solve(*args)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    o = {kk: v.cpu().numpy() for kk, v in out.items()}
    batch = args[2]
    lb_host = relax.host_certified_bound(c["A"], c["mask"], batch, o, c["gamma"], c["k"],
                                         c["ub_bar"])
    lb_dev, lb_est = o["lb_dev"].astype(np.float64), o["lb_est"].astype(np.float64)
    worst = float(np.max(np.abs(lb_dev - lb_host) / (1.0 + np.abs(lb_host))))
    scale = (lb_est - lb_dev) / relax.margin_rel_default(torch.float32)
    # a reading, not a check: the same on-device bound on the same duals
    # through torch's float32 eigh (cuSOLVER), as the port ran it before K4,
    # and each bound's distance from the float64 certificate
    ys = [out[key] for key in ("y1", "y2", "ya", "yb", "yc")]
    saved = relax.project_psd, relax.eigvalsh
    relax.project_psd, relax.eigvalsh = cones.project_psd_plain, torch.linalg.eigvalsh
    try:
        lb_t, est_t = relax.safe_dual_bound2(args[0], args[1], batch, *ys, c["gamma"], c["k"],
                                             c["ub_bar"])
    finally:
        relax.project_psd, relax.eigvalsh = saved
    lb_t, est_t = lb_t.double().cpu().numpy(), est_t.double().cpu().numpy()
    d_lb = np.abs(lb_dev - lb_t)
    row = dict(B=B, L=L, iters=2000, seconds=dt, ms_per_iter=1e3 * dt / 2000,
               ub=c["obj0"], lb_dev=float(lb_dev[0]), lb_est=float(lb_est[0]),
               lb_host=float(lb_host[0]), worst_rel_dev_vs_host=worst, scale=float(scale[0]),
               lb_torch_eigh=float(lb_t[0]),
               worst_dlb_vs_torch_eigh_over_scale=float(np.max(d_lb / scale)),
               worst_k4_est_vs_host_over_scale=float(np.max(np.abs(lb_est - lb_host) / scale)),
               worst_torch_est_vs_host_over_scale=float(np.max(np.abs(est_t - lb_host) / scale)),
               launches=launches)
    log("admm", json.dumps(row))
    assert np.all(np.isfinite(lb_host))
    assert worst <= 1e-2, row
    # K4's margin-free bound sits within 1e-5 scale of the float64
    # certificate of the same duals (well inside the 3e-5 margin)
    assert np.all(np.abs(lb_est - lb_host) <= 1e-5 * scale), row
    assert launches["K4"] > 0 and launches["K5"] == 1, launches
    res["admm"] = row


# the launch counts every driver run must raise: the on-device safe bound
# (K4, not on the McCormick path), the separation (K5) and the root altmin (K6)
BOUND_KEYS = ("K4", "K5", "K6")


def _assert_launched(launches, keys):
    missing = [key for key in keys if not launches[key] > 0]
    assert not missing, (missing, launches)


def _solve(A, idx, gamma, k=1, **kw):
    from omc_torch.solve import matrix_completion_branchandbound

    t0 = time.time()
    sol, _, inst = matrix_completion_branchandbound(k, A, idx, gamma, device="cuda", **kw)
    return sol, inst, time.time() - t0


def _summary(sol, inst, secs):
    rd = inst["run_details"]
    log_ = inst["run_log"]
    return dict(
        seconds=secs, objective=float(sol["objective"]),
        objective_initial=float(sol["objective_initial"]),
        gap=float(log_[-1]["gap"]), lower=float(log_[-1]["lower"]),
        nodes_explored=int(rd["nodes_explored"]), nodes_total=int(rd["nodes_total"]),
        refinement_visits=int(rd["refinement_visits"]),
        sdp_iters_total=int(rd["sdp_iters_total"]), device_steps=int(rd["device_steps"]),
        device_s=rd["solve_time_device"], certify_s=rd["solve_time_certify"],
        polish_s=rd["solve_time_polish"], altmin_s=rd["solve_time_altmin"],
    )


def phase_fixtures(res):
    from omc_torch import kernels
    from omc_torch.data import generate_matrix_completion_data

    with open(os.path.join(HERE, "tests", "fixtures", "instances.json")) as fh:
        fixtures = json.load(fh)
    rows = []
    for fx in fixtures:
        kernels.reset_launches()
        A, idx = generate_matrix_completion_data(
            fx["k"], fx["n"], fx["m"], fx["n_indices"], fx["seed"])
        sol, inst, secs = _solve(
            A, idx, fx["gamma"], k=fx["k"], node_selection="bestfirst",
            disjunctive_cuts_type="linear",
            disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-2,
            batch_size=8, sdp_iters=1200, dtype="float32", time_limit=300,
            verbosity=0)
        row = dict(k=fx["k"], n=fx["n"], seed=fx["seed"], **_summary(sol, inst, secs))
        _assert_launched(kernels.LAUNCHES, BOUND_KEYS)
        ref = fx["certified_objective"]
        tol = (fx["certified_gap"] + 1e-2) * max(1.0, abs(ref))
        row.update(reference=ref, tol=tol)
        log("fixture", json.dumps(row))
        assert row["gap"] <= 1e-2, row
        assert abs(row["objective"] - ref) <= tol, row
        rows.append(row)
    res["fixtures"] = rows


def _certify(name, frac, ref, ref_gap, res):
    from omc_torch import kernels

    A, idx = _bench_instance(frac)
    rows = {}
    for run in ("cold", "warm") if name == "headline" else ("run",):
        before = dict(kernels.LAUNCHES)
        sol, inst, secs = _solve(A, idx, 80.0, **BENCH_KW)
        _assert_launched({key: kernels.LAUNCHES[key] - before[key] for key in before},
                         BOUND_KEYS)
        row = _summary(sol, inst, secs)
        rows[run] = row
        log(name, run, json.dumps(row))
        tol = (1e-4 + ref_gap) * abs(ref)
        assert row["gap"] <= 1e-4, row
        assert abs(row["objective"] - ref) <= tol, (row, ref, tol)
        lowers = [r["lower"] for r in inst["run_log"] if r["lower"] > -1e300]
        assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    res[name] = rows


def phase_headline(res):
    from omc_torch import kernels

    kernels.reset_launches()
    _certify("headline", 0.5, HEADLINE_OBJ, HEADLINE_GAP, res)
    launches = dict(kernels.LAUNCHES)
    log("headline launches", json.dumps(launches))
    _assert_launched(launches, ("K1", "K2", "K3") + BOUND_KEYS)
    res["launches"] = launches


def phase_multinode(res):
    _certify("multinode", 0.3, MULTI_OBJ, MULTI_GAP, res)


def phase_branch(res):
    from omc_torch import kernels

    A, idx = _bench_instance(0.2)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **{**BENCH_KW, "time_limit": 45})
    _assert_launched(kernels.LAUNCHES, BOUND_KEYS)
    row = _summary(sol, inst, secs)
    log_ = inst["run_log"]
    row["gap_first"] = float(log_[0]["gap"])
    row["gap_final"] = float(log_[-1]["gap"])
    row["nodes_per_s"] = row["nodes_explored"] / secs
    log("branch", json.dumps(row))
    lowers = [r["lower"] for r in log_ if r["lower"] > -1e300]
    assert row["nodes_explored"] > 1, row
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    assert row["gap_final"] < row["gap_first"], row
    assert row["objective"] <= row["objective_initial"] + 1e-12, row
    res["branch"] = row


SHOR_KW = dict(
    BENCH_KW, node_selection="breadthfirst", add_Shor_valid_inequalities=True,
    Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
    add_Shor_valid_inequalities_fraction=0.25, time_limit=60,
)
# the certified gap the shor phase must reach in its 60 s: 1e-4 is out of
# reach for this relaxation there (the card reaches ~3e-3 in 180 s and
# ~8e-3 by its second visit; PERF.md, "shor phase"), so the bar is 1e-2
SHOR_GAP = 1e-2


def phase_shor(res):
    """Static Shor ([4]-minors, a quarter of them) on the 30%-observed
    50x50 instance, breadth-first, 60 s: the K7/K8a/K8b path through the
    entry point."""
    from omc_torch import kernels

    A, idx = _bench_instance(0.3)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **SHOR_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    row = _summary(sol, inst, secs)
    lowers = [r["lower"] for r in inst["run_log"] if r["lower"] > -1e300]
    row.update(launches=launches, minors=int(rd["shor_minors_max"]),
               ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1),
               lowers=lowers)
    log("shor", json.dumps(row))
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert row["gap"] <= SHOR_GAP, row
    assert abs(row["objective"] - MULTI_OBJ) <= (row["gap"] + MULTI_GAP) * MULTI_OBJ, row
    assert row["minors"] > 0, row
    _assert_launched(launches, ("K1", "K2", "K3", "K7", "K8a", "K8b", "K4s") + BOUND_KEYS)
    res["shor"] = row
    res["shor_launches"] = launches


CONFIG2_KW = dict(
    node_selection="breadthfirst", disjunctive_cuts_type="linear",
    disjunctive_cuts_breakpoints="smallest_1_eigvec",
    add_Shor_valid_inequalities=True, add_Shor_valid_inequalities_iterative=True,
    Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
    update_Shor_indices_n_minors=100, gap=1e-2, time_limit=60, batch_size=32,
    sdp_iters=2000, dtype="float32", altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: one visit's budget is not boosted 8x
    sdp_iter_boost_max=1,
)


def phase_config2(res):
    """BASELINE config 2 at full width (rank-1 100x100, 30% observed, seed 1,
    iterative [4]-minor Shor, breadth-first, batch 32), 60 s."""
    import numpy as np

    from omc_torch import kernels
    from omc_torch.data import generate_matrix_completion_data

    n = 100
    A, idx = generate_matrix_completion_data(1, n, n, int(0.3 * n * n), seed=1)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **CONFIG2_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    log_ = inst["run_log"]
    lowers = [r["lower"] for r in log_ if r["lower"] > -1e300]
    row = _summary(sol, inst, secs)
    row.update(
        launches=launches, growths=int(rd["shor_growths"]),
        minors_max=int(rd["shor_minors_max"]),
        ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1),
        gap_first=float(log_[0]["gap"]), gap_final=float(log_[-1]["gap"]),
        lowers=lowers,
    )
    mask = idx.astype(np.float64)
    X = np.asarray(sol["X"], np.float64)
    obj64 = 0.5 * float(np.sum(mask * (X - A) ** 2)) + (0.5 / 80.0) * float(np.sum(X * X))
    row["objective_f64"] = obj64
    log("config2", json.dumps(row))
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert not lowers or lowers[-1] <= row["objective"] * (1 + 1e-12), row
    assert abs(obj64 - row["objective"]) <= 1e-9 * abs(obj64), row
    _assert_launched(launches, ("K7", "K8a", "K8b", "K4s") + BOUND_KEYS)
    res["config2"] = row


# BASELINE config 3 (benchmarks/bench_configs.py:96-108): rank-2 75x75, 50%
# observed, seed 1, gamma 80, linear3 cuts, smallest_2_eigvec breakpoints,
# best-first/depth-first, batch 64, 2000 iterations per visit, gap 1e-2
CONFIG3_KW = dict(
    node_selection="bestfirst_depthfirst", bestfirst_depthfirst_cutoff=10000,
    disjunctive_cuts_type="linear3", disjunctive_cuts_breakpoints="smallest_2_eigvec",
    gap=1e-2, time_limit=75, batch_size=64, sdp_iters=2000, dtype="float32",
    altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: the 8x boosted root visit (16,000 iterations
    # of K1's d=150 chain) does not fit the budget, and the budget is 75 s
    sdp_iter_boost_max=1,
)
# the rank-k Shor path on config 3's instance: config 2's Shor settings and
# batch (iterative [4]-minors, 100 per growth, batch 32)
SHORK_KW = dict(
    CONFIG3_KW, batch_size=32, add_Shor_valid_inequalities=True,
    add_Shor_valid_inequalities_iterative=True,
    Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
    update_Shor_indices_n_minors=100,
)


def _config3_instance():
    from omc_torch.data import generate_matrix_completion_data

    n = 75
    return generate_matrix_completion_data(2, n, n, int(0.5 * n * n), seed=1)


def _rank2_checks(name, sol, inst, secs, A, idx, launches, keys):
    """The soundness checks of a config-3 run: monotone lower bounds, none
    above omc's incumbent for the instance, the incumbent no worse than
    omc's, its float64 objective as reported, rank <= 2, the path's kernels
    launched."""
    import numpy as np

    rd = inst["run_details"]
    log_ = inst["run_log"]
    lowers = [r["lower"] for r in log_ if r["lower"] > -1e300]
    row = _summary(sol, inst, secs)
    mask = idx.astype(np.float64)
    X = np.asarray(sol["X"], np.float64)
    obj64 = 0.5 * float(np.sum(mask * (X - A) ** 2)) + (0.5 / 80.0) * float(np.sum(X * X))
    row.update(
        launches=launches, growths=int(rd["shor_growths"]),
        minors_max=int(rd["shor_minors_max"]),
        ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1),
        gap_first=float(log_[0]["gap"]), gap_final=float(log_[-1]["gap"]),
        lowers=lowers, objective_f64=obj64, rank=int(np.linalg.matrix_rank(X, tol=1e-6)),
    )
    log(name, json.dumps(row))
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert not lowers or lowers[-1] <= CONFIG3_OBJ * (1 + 1e-9), row
    assert not lowers or lowers[-1] <= row["objective"] * (1 + 1e-12), row
    assert row["objective"] <= CONFIG3_OBJ * (1 + 1e-6), row
    assert abs(obj64 - row["objective"]) <= 1e-9 * abs(obj64), row
    assert row["rank"] <= 2, row
    for key in keys:
        assert launches[key] > 0, launches
    return row


def phase_config3(res):
    """BASELINE config 3 at full width (rank-2 75x75, linear3 cuts,
    smallest_2_eigvec, best-first/depth-first, batch 64), 75 s: the base
    path at k = 2 through K1 (d = 150/77/75), K2 and K3."""
    from omc_torch import kernels

    A, idx = _config3_instance()
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, k=2, **CONFIG3_KW)
    launches = dict(kernels.LAUNCHES)
    res["config3"] = _rank2_checks("config3", sol, inst, secs, A, idx, launches,
                                   ("K1", "K2", "K3") + BOUND_KEYS)


def phase_shork(res):
    """The rank-k Shor path on config 3's instance: (i) one root visit of
    2,000 iterations, held to omc's bound for the same call; (ii) the full
    call (iterative Shor, batch 32), 75 s, through K1, K2, K3, K7t, K7x,
    K8c and K8d."""
    from omc_torch import kernels

    A, idx = _config3_instance()
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, k=2, **{**SHORK_KW, "root_only": True})
    _assert_launched(kernels.LAUNCHES, ("K4s",) + BOUND_KEYS)
    lb = float(inst["run_log"][-1]["lower"])
    root = dict(seconds=secs, lower=lb, omc_lower=SHORK_ROOT_OMC,
                rel_diff=abs(lb - SHORK_ROOT_OMC) / (1.0 + abs(SHORK_ROOT_OMC)),
                iters=int(inst["run_details"]["sdp_iters_total"]))
    log("shork root", json.dumps(root))
    # float32 sign-schedule runs drift apart over iterations (8e-6 at 2,000
    # iterations on config 2's root; PERF.md), so 1e-3 (1 + |b|)
    assert root["rel_diff"] <= 1e-3, root
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, k=2, **SHORK_KW)
    launches = dict(kernels.LAUNCHES)
    row = _rank2_checks("shork", sol, inst, secs, A, idx, launches,
                        ("K1", "K2", "K3", "K7t", "K7x", "K8c", "K8d", "K4s") + BOUND_KEYS)
    assert row["minors_max"] > 0, row
    res["shork_root"] = root
    res["shork"] = row
    res["shork_launches"] = launches


# the McCormick path (use_disjunctive_cuts=False): the headline's settings
# with one visit's budget not boosted 8x (a cut of depth, so that the root
# splits inside the budget)
MC_KW = dict(BENCH_KW, use_disjunctive_cuts=False, disjunctive_cuts_type=None,
             disjunctive_cuts_breakpoints=None, time_limit=45, sdp_iter_boost_max=1)
# config 3's instance and batch on the McCormick path, one root visit
MC3_KW = dict(node_selection="bestfirst", use_disjunctive_cuts=False, gap=1e-2,
              time_limit=120, batch_size=64, sdp_iters=2000, dtype="float32",
              altmin_root_n_iters=3, verbosity=0, sdp_iter_boost_max=1, root_only=True)
# omc's certified McCormick bounds for the same calls, float32 on a CPU:
# omc.api.matrix_completion_SDP_relaxation on the headline instance's root
# node (2,000 iterations), and omc.solve.matrix_completion_branchandbound
# with MC3_KW on config 3's instance (one 2,000-iteration call)
MC_API_OMC = -52.35261076808982
MC3_ROOT_OMC = -229.971577418594


def phase_mccormick(res):
    """The McCormick path (K9s/K9a/K9b with K1): (i) the standalone
    relaxation entry point on the headline's root node, held to omc's bound;
    (ii) a rank-2 root visit of the driver on config 3's instance, held to
    omc's bound; (iii) the full McCormick B&B on the headline instance,
    45 s."""
    import numpy as np

    from omc_torch import kernels
    from omc_torch.api import matrix_completion_SDP_relaxation
    from omc_torch.tree import BBNode, root_box

    A, idx = _bench_instance(0.5)
    lo, hi = root_box(50, 1)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0,
                  cuts=None)
    kernels.reset_launches()
    t0 = time.time()
    r = matrix_completion_SDP_relaxation(node, 50, 1, A, idx, 80.0, use_disjunctive_cuts=False,
                                         iters=2000, dtype="float32", device="cuda")
    assert kernels.LAUNCHES["K5"] == 1, kernels.LAUNCHES
    api = dict(seconds=time.time() - t0, lower=r["lower_bound"], objective=r["objective"],
               omc_lower=MC_API_OMC,
               rel_diff=abs(r["lower_bound"] - MC_API_OMC) / (1.0 + abs(MC_API_OMC)))
    log("mccormick api", json.dumps(api))
    # float32 sign-schedule runs drift apart over iterations, so 1e-3 (1 + |b|)
    assert api["rel_diff"] <= 1e-3, api
    assert api["lower"] <= HEADLINE_OBJ, api

    A3, idx3 = _config3_instance()
    sol, inst, secs = _solve(A3, idx3, 80.0, k=2, **MC3_KW)
    lb = float(inst["run_log"][-1]["lower"])
    root = dict(seconds=secs, lower=lb, omc_lower=MC3_ROOT_OMC,
                rel_diff=abs(lb - MC3_ROOT_OMC) / (1.0 + abs(MC3_ROOT_OMC)),
                iters=int(inst["run_details"]["sdp_iters_total"]),
                feasibility_s=inst["run_details"]["solve_time_relaxation_feasibility"])
    log("mccormick root k=2", json.dumps(root))
    assert root["rel_diff"] <= 1e-3, root
    assert root["lower"] <= CONFIG3_OBJ, root

    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **MC_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    row = _summary(sol, inst, secs)
    row.update(launches=launches, lowers=lowers,
               nodes_relax_infeasible=int(rd["nodes_relax_infeasible"]),
               solve_time_relaxation_feasibility=rd["solve_time_relaxation_feasibility"],
               ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1))
    log("mccormick", json.dumps(row))
    assert abs(row["objective"] - HEADLINE_OBJ) <= 1e-6 * HEADLINE_OBJ, row
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert all(x <= HEADLINE_OBJ * (1 + 1e-4) for x in lowers), lowers
    assert row["nodes_explored"] > 1, row
    # one K9a and one K9b per iteration, one K9s per visit, K1 per iteration
    iters, visits = row["sdp_iters_total"], row["device_steps"]
    assert launches["K9a"] == launches["K9b"] == launches["K1"] == iters > 0, (launches, row)
    assert launches["K9s"] == visits > 0, (launches, row)
    # one separation per visit, the root altmin; no on-device bound here
    assert launches["K5"] == visits and launches["K6"] > 0 and launches["K4"] == 0, launches
    res["mccormick_api"] = api
    res["mccormick_root"] = root
    res["mccormick"] = row
    res["mccormick_launches"] = launches


def _device_ms_by_kernel(prof, names, per=1):
    """Device milliseconds per kernel name in a profile (``names`` maps a
    substring of the CUDA name to a key; the rest under "other: ...")."""
    by = {}
    for ev in prof.key_averages():
        # kernels carry their own (self) device time; host ops carry none
        dt = getattr(ev, "self_device_time_total", 0) or 0
        if dt > 0:
            key = next((v for k_, v in names.items() if k_ in ev.key), "other: " + ev.key[:60])
            by[key] = by.get(key, 0.0) + dt / 1e3 / per
    return by


def _trace_loop(step, names, iters, **shape):
    """CUDA-event time per iteration of ``step`` and a torch.profiler trace
    over ``iters`` iterations: device time per kernel, busy and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ev_ms = cuda_time_ms(step, reps=iters)  # per iteration, without the profiler
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0) / iters
    by = _device_ms_by_kernel(prof, names, per=iters)  # ms per iteration
    busy = sum(by.values())
    # the idle share is taken against the unprofiled CUDA-event time: the
    # profiled wall includes the profiler's own start and stop
    return dict(**shape, iters=iters, event_ms_per_iter=ev_ms,
                profiled_wall_ms_per_iter=wall_ms, kernel_ms_per_iter=by,
                device_busy_ms_per_iter=busy, k1_share=by.get("K1", 0.0) / max(busy, 1e-30),
                idle_share=max(0.0, 1.0 - busy / ev_ms))


def phase_trace(res):
    """(Run on request only.)  torch.profiler traces of the Shor loop at
    config 2's shape (B=32, n=m=100, M5=1024, L=8) and of the rank-k Shor
    loop at config 3's (B=32, n=m=75, k=2, M5=1024, L=8), 20 iterations
    each, of the McCormick loop at the headline's shape (n=m=50, k=1; B=1
    and B=64), 50 iterations each, and of one base-path root visit at B=64
    with its two safe-bound calls (K4) and its separation (K5)."""
    import torch

    from omc_torch.sdp import admm_shor as S
    from omc_torch.sdp import shor_k as SK

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    names = {"k1_": "K1", "k2_kernel": "K2", "k3_kernel": "K3", "k7_kernel": "K7",
             "k8a_kernel": "K8a", "k8b_kernel": "K8b", "k7t_kernel": "K7t",
             "k7x_kernel": "K7x", "k8c_kernel": "K8c", "k8d_kernel": "K8d"}
    c, sc, st = _shor_inputs(32, 100, 100, 8, 1024, gen, dev)
    acc = [torch.zeros_like(x) for x in (st.core.u1, st.core.u2, st.core.ua, st.core.ub,
                                         st.core.uc, st.u5, st.ur, st.ul)]
    ts = (torch.empty_like(st.core.w1), torch.empty_like(st.core.w2),
          torch.empty_like(st.core.w3))
    row = _trace_loop(lambda: S.shor_iteration(c, sc, st, ts, acc, "ns"), names, 20,
                      B=32, n=100, m=100, M5=1024, L=8)
    log("trace", json.dumps(row))
    res["trace"] = row
    c, sc, st = _shor_k_inputs(32, 75, 75, 8, 1024, gen, dev)
    acc = [torch.zeros_like(x) for x in (st.core.u1, st.core.u2, st.core.ua, st.core.ub,
                                         st.core.uc, st.u5, st.ux, st.ur, st.ul, st.uwl)]
    ts = (torch.empty_like(st.core.w1), torch.empty_like(st.core.w2),
          torch.empty_like(st.core.w3))
    row = _trace_loop(lambda: SK.shor_k_iteration(c, sc, st, ts, acc, "ns"), names, 20,
                      B=32, n=75, m=75, k=2, M5=1024, L=8)
    log("trace shork", json.dumps(row))
    res["trace_shork"] = row
    # the McCormick loop (K9a -> K9b -> K1) at the headline's shape, with
    # the running means on, at B=1 (the root visit) and B=64
    from omc_torch.sdp import mccormick as MC

    names.update({"k9a_kernel": "K9a", "k9b_kernel": "K9b", "k4_kernel<false>": "K4",
                  "k4_kernel<true>": "K5", "k4s_kernel": "K4s", "k6_kernel": "K6"})
    for B in (1, 64):
        c, st = _mc_inputs(B, 50, 50, 1, gen, dev)
        acc = [torch.zeros_like(x) for x in (st.u1, st.u2, st.umc, st.uorth)]
        ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
        row = _trace_loop(lambda: MC.mc_iteration(c, st, ts, acc, 0.25, "ns"), names, 50,
                          B=B, n=50, m=50, k=1)
        log("trace mccormick", json.dumps(row))
        res[f"trace_mccormick_B{B}"] = row
    # the headline's root visit runs at B=1: the K1 chain's latency and the
    # host's launches set its iteration
    head, _ = _trace_root_visit(names, 1)
    log("trace headline visit", json.dumps(head))
    res["trace_headline_visit"] = head
    visit, call = _trace_visit(names)
    log("trace visit", json.dumps(visit))
    log("trace bound call", json.dumps(call))
    res["trace_visit"], res["trace_bound_call"] = visit, call


def _trace_root_visit(names, B):
    """One base-path root visit of the headline instance at a batch of B
    (2,000 iterations, two safe-bound calls, one separation) under the
    profiler, after one unprofiled warm-up visit: device time by kernel,
    busy and idle share.  Returns the row and the solver's (solve, args,
    constants, outputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solve, args, c = _admm_root(B)
    _, out = solve(*args)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, out = solve(*args)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    by = _device_ms_by_kernel(prof, names)
    busy = sum(by.values())
    visit = dict(B=B, n=50, m=50, k=1, L=8, iters=2000, bound_calls=2, separations=1,
                 profiled_wall_ms=wall, ms_per_iter=wall / 2000, device_busy_ms=busy,
                 kernel_ms=by, k1_share_of_busy=by.get("K1", 0.0) / max(busy, 1e-30),
                 k4_share_of_busy=by.get("K4", 0.0) / max(busy, 1e-30),
                 k5_share_of_busy=by.get("K5", 0.0) / max(busy, 1e-30),
                 idle_share=max(0.0, 1.0 - busy / wall))
    return visit, (solve, args, c, out)


def _trace_visit(names):
    """One base-path root visit at the headline's shape and B=64 (2,000
    iterations, two safe-bound calls, one separation) under the profiler,
    and one safe-bound call alone, split into the eigensolver (K4) and the
    torch terms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from omc_torch.sdp.relax import safe_dual_bound2

    visit, (solve, args, c, out) = _trace_root_visit(names, 64)
    ys = [out[key] for key in ("y1", "y2", "ya", "yb", "yc")]
    bound = lambda: safe_dual_bound2(args[0], args[1], args[2], *ys, c["gamma"],  # noqa: E731
                                     c["k"], c["ub_bar"])
    ev_ms = cuda_time_ms(bound)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            bound()
        torch.cuda.synchronize()
    bb = _device_ms_by_kernel(prof, names, per=5)
    k4 = bb.get("K4", 0.0)
    call = dict(B=64, n=50, m=50, k=1, L=8, event_ms=ev_ms, k4_device_ms=k4,
                torch_terms_device_ms=sum(bb.values()) - k4,
                host_and_gaps_ms=max(0.0, ev_ms - sum(bb.values())), kernel_ms=bb)
    return visit, call


KERNELS = (
    # key, rows of the kernels phase (the first is the one timed in the
    # record), the main path that counts its launches, name, source, replaces
    ("K1", ("K1",), "launches", "K1 sign-schedule PSD projection (B=64, d=100/51/50)",
     "omc_torch/csrc/k1_psd_sign.cu", "omc/ops/polar.py:102"),
    ("K2", ("K2",), "launches", "K2 adjoint + Woodbury z-step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k2_zstep.cu", "omc/sdp/admm.py:324"),
    ("K3", ("K3",), "launches", "K3 forward map + cone step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k3_cone.cu", "omc/sdp/admm.py:133"),
    ("K7", ("K7fused", "K7"), "shor_launches",
     "K7 5x5 minor-slot PSD projection, fused (B=32, M5=1024)",
     "omc_torch/csrc/k7_minor_psd.cu", "omc/ops/polar.py:127"),
    ("K8a", ("K8a",), "shor_launches", "K8a Shor adjoint + z-step (B=32, n=m=100, M5=1024)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:178"),
    ("K8b", ("K8b",), "shor_launches", "K8b Shor RSOC/link/W>=0 cone step (B=32, n=m=100)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:423"),
    ("K7t", ("K7t",), "shork_launches",
     "K7t per-term 5x5 minor slots, rank-k Shor (B=32, M5=1024, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:349"),
    ("K7x", ("K7xfused", "K7x"), "shork_launches",
     "K7x (k+1)x(k+1) XWH slots, rank-k Shor (B=32, C=4096, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:373"),
    ("K8c", ("K8c",), "shork_launches",
     "K8c rank-k Shor adjoint + z-step (B=32, n=m=75, k=2, M5=1024)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:618"),
    ("K8d", ("K8d",), "shork_launches",
     "K8d rank-k Shor RSOC/link/W>=0/Wt>=0 cone step (B=32, n=m=75, k=2)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:754"),
    ("K9s", ("K9s",), "mccormick_launches",
     "K9s McCormick row Grams, Cholesky factors, orthogonality Woodbury (B=64, n=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:385"),
    ("K9a", ("K9a",), "mccormick_launches",
     "K9a McCormick adjoint + z-step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:446"),
    ("K9b", ("K9b",), "mccormick_launches",
     "K9b McCormick forward map + cone step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:477"),
    ("K4", ("K4",), "launches",
     "K4 Jacobi eigensolver of the safe bounds, PSD projection (B=64, d=100)",
     "omc_torch/csrc/k4_jacobi.cu", "omc/sdp/relax.py:356"),
    ("K4s", ("K4s",), "shor_launches",
     "K4s Jacobi PSD projection of 5x5 minor duals, one thread each (32x4096)",
     "omc_torch/csrc/k4s_jacobi_small.cu", "omc/sdp/admm_shor.py:786"),
    ("K5", ("K5",), "launches",
     "K5 separation eigenpairs of UU'-Y, two smallest (B=64, n=50)",
     "omc_torch/csrc/k4_jacobi.cu", "omc/sdp/admm.py:576"),
    ("K6", ("K6",), "launches",
     "K6 altmin masked ridge V-step + U-step (B=4, n=m=50, k=1)",
     "omc_torch/csrc/k6_altmin.cu", "omc/ops/linalg.py:15"),
)


def kernel_record(res):
    """The per-kernel JSON record: launches on its main path, the largest
    absolute error against its plain version, the kernel, plain and library
    times and the bound of the row it was timed on."""
    rec = []
    for key, rows, path, name, source, replaces in KERNELS:
        all_rows = [r for rk in rows for r in res["kernels"][rk]]
        r = res["kernels"][rows[0]][0]
        rec.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": res[path][key],
            "max_abs_err": max(x["max_abs_err"] for x in all_rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        })
    return {"kernels": rec}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--out", help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES + EXTRA_PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import omc_torch  # noqa: F401  (fails here when run outside the repository)

    res = {}
    t_all = time.time()
    for p in phases:
        t0 = time.time()
        log(f"== {p}")
        globals()[f"phase_{p}"](res)
        log(f"== {p} done in {time.time() - t0:.1f} s")
    res["total_s"] = time.time() - t_all
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1, default=str)
    if phases != list(PHASES):
        return 0
    log(json.dumps(kernel_record(res)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
