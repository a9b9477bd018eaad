#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``omc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, about 10 minutes on an H100

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
               the latter with their sweep counts; K4 (d=50 to 1000, B=1 to
               128) on every path k4_plan could take, and the block path's
               grid barrier; K5 at every driving phase's (B, n, k) on every
               path k5_plan could take (its tridiagonal kernel with the
               triangle in float64 or float32, K4's Jacobi paths), K4s at
               the Shor bounds' batches, each with device times; K6
               (n=m=50, 250, 1000; k=1 to 10; B=4 and 64) on every path
               k6_plan could take, against the
               library's batched solve; K8c at k=2 (timed), 3 and 4; K2 and
               K3 (B=1 to 128, n=m=50 to 1000, up to 2048 cuts, K2's Shor
               variant) with their device times on every cluster size
               k2k3_plan could take; K8a, K7 (fused and projection mode)
               and K8b at every shape of the Shor k=1 loop (SHOR_SHAPES),
               K7t, K7x (fused) and K8d at k = 2, 3 and 4 and K7x's
               projection mode, K9a and K9b at (B, n=m, k) = (64, 50, 1),
               (64, 75, 2), (1, 50, 1), (16, 50, 1) (MC_SHAPES), with their
               device times, and K9s also at (64, 50, 3); the build fails if
               ptxas reports a spill in K2, K3, K6, K7, K7t, K7x, K8a, K8b,
               K8c, K8d, K9s, K9a or K9b
4. admm      — one root ADMM solve (B=64, L=8, 2000 iterations) on the
               headline instance; device bound vs float64 host bound (the
               same bound through torch's eigh is logged as a reading)
5. fixtures  — the four certified instances of tests/fixtures/instances.json
6. headline  — rank-1 50x50, 50% observed, gamma 80, gap 1e-4 (cold, warm)
7. multinode — the 30%-observed instance, gap 1e-4
8. dist      — the multi-process frontier: two ranks of
               omc_torch.parallel.worker on the card over gloo, the
               multinode instance at batch 8, 60 s
9. branch    — the 20%-observed instance, 30 s budget
10. shor     — the 30%-observed instance with static Shor minors
               (breadth-first, 60 s): the K7/K8a/K8b path
11. config2  — BASELINE config 2 (rank-1 100x100, iterative Shor, batch 32),
               45 s, with soundness checks
12. config3  — BASELINE config 3 (rank-2 75x75, linear3 cuts,
               smallest_2_eigvec, best-first/depth-first, batch 64), 60 s
13. shork    — the rank-k Shor path (K7t/K7x/K8c/K8d) on config 3's
               instance: a root visit held to omc's bound, then the full
               call (iterative Shor, batch 32), 60 s
14. mccormick — the McCormick path (K9s/K9a/K9b): the standalone relaxation
               entry point on the headline's root and a rank-2 root visit on
               config 3's instance, each held to omc's bound, then the full
               McCormick B&B on the headline instance, 30 s
15. config4  — BASELINE config 4's frontier step (rank-5 250x250, a device
               batch of 128 nodes, 400 iterations, one safe-bound call: K4 at
               d=500, 255 and 250, K5 at d=250): a warm-up step, then two
               timed sub-steps, the 8 lowest bounds certified in float64

Every phase that drives the solver asserts that the launch counts of the
kernels its path runs grew (K4 the on-device safe bound, K4s the Shor
bounds' small slots, K5 the separation, K6 altmin).  The record's launches
of a kernel are its launches over all those phases (``COUNTED``).

``--phases device,build,trace`` runs the optional ``trace`` phase: a
torch.profiler trace of the Shor loop at config 2's shape and at the shor
cell's (with K7's, K8a's and K8b's device ms per iteration), of the
rank-k Shor loop at config 3's (with K7t's, K7x's and K8d's), of the
McCormick loop at the headline's (B=1 and B=64, with K9a's and K9b's), of
the headline's root visit at B=1
(with the device's idle share), of one base-path root visit at B=64 with
its safe-bound calls, and of safe-bound calls at config 4's shape (B=128,
n=m=250, k=5), each split into K4 and the torch terms; K2's and K3's
device ms per iteration of the two Shor loops and the two root visits are
given on their own.

``--parent DIR`` (a checkout of an older tree, e.g. from ``git archive``)
builds that tree's K2, K3, K7, K8a, K8b, K7t, K7x, K8d, K9s, K9a, K9b, K4
and K4s and times them, with that tree's parameter blocks, beside every
K2/K3 row of the kernels phase up to 512 cuts and every K7/K8a/K8b/K7t/
K7x/K8d/K9s/K9a/K9b/K4s/K5 row (the parent's K5 is K4's Jacobi template on
the path k4_plan gives it), and reports ptxas's registers of its K7, K7t,
K7x, K8a, K8b, K8d, K9a and K9b.

Any failed check raises; the script then exits non-zero and prints no
final line.  On success the line before the last is the per-kernel JSON
record and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits with code 2, and outside a checkout of the
repository (no ``omc_torch`` beside it) with code 4.  ``--phases a,b`` runs a
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
          "multinode", "dist", "branch", "shor", "config2", "config3", "shork",
          "mccormick", "config4")
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


def with_path_bound(row, path, nbytes, flops):
    """K4's and K5's bound on the path the row's plan takes: the fp32 rate
    on the CTA path and on K5's tridiag paths, the 3xTF32 rate (three
    tensor-core passes) on the block path, whose tile products and
    projection epilogue are 3xTF32, with the fp32 reading beside it
    (``bound_fp32_ms``), as K1's rows have."""
    if path != "block16":
        return with_bound(row, nbytes, flops)
    with_bound(row, nbytes, 3 * flops, PEAK_TF32_FLOPS)
    row["bound_flops"] = float(flops)
    row["bound_fp32_ms"] = bound(nbytes, flops)[0]
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


# the kernels whose small arrays must stay in registers (no stack frame)
NO_FRAME = ("k7_kernel", "k7t_kernel", "k7x_kernel", "k8a_kernel", "k8b_kernel", "k8d_kernel",
            "k9s_kernel", "k9a_kernel", "k9b_kernel")


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
    report = _ptxas_report(info.get("ptxas", ""))
    res["spills"] = spills = {f: r["spill"] for f, r in report.items() if any(r["spill"])}
    log("build: kernels that spill", json.dumps(spills))
    keep = ("k6_", "k8c_kernel", "k2_kernel", "k3_kernel") + NO_FRAME
    res["registers"] = regs = {f: r["registers"] for f, r in report.items()
                               if any(x in f for x in keep)}
    log("build: K2, K3, K6, K7, K7t, K7x, K8a, K8b, K8c, K8d, K9s, K9a and K9b registers",
        json.dumps(regs))
    if PARENT:
        res["parent_ptxas"] = {f: r for f, r in PARENT["ptxas"].items()
                               if any(x in f for x in NO_FRAME)}
        log("build: the parent's K7, K7t, K7x, K8a, K8b, K8d, K9s, K9a and K9b",
            json.dumps(res["parent_ptxas"]))
    # K2's, K3's, K6's, K7's, K7t's, K7x's, K8a's, K8b's, K8c's, K8d's,
    # K9s's, K9a's and K9b's instantiations keep every value in registers;
    # K7's, K7t's, K7x's, K8a's, K8b's, K8d's, K9s's, K9a's and K9b's index
    # their small arrays only with constants (no stack frame: a 5x5 triangle
    # in local memory costs K7 ten times its time)
    assert not [f for f in spills if any(x in f for x in keep)], spills
    frames = {f: r["stack"] for f, r in report.items()
              if any(x in f for x in NO_FRAME) and r["stack"]}
    assert not frames, frames



def _ptxas_report(text):
    """{function: {"registers": n, "spill": [store bytes, load bytes],
    "stack": bytes}} from ptxas's report (``-Xptxas -v``)."""
    import re

    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": None, "spill": [0, 0], "stack": 0})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn]["stack"] = int(m.group(1))
            out[fn]["spill"] = [int(m.group(2)), int(m.group(3))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


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

    # ---- K2 / K3 at the shapes the cells run them: the base path at B=64
    # (the row of the record; L = 8 and 32), the headline's root visit (B=1)
    # and refinement portfolio (B=4), BASELINE config 3 at its base-path
    # batch (B=64, k=2) and its rank-k Shor batch (B=32), config 2's Shor
    # loop (B=32, n=m=100; K2's shor variant writes Y and U only), config
    # 4's (B=128, n=m=250, k=5), n=m=1000 (k=10, B=2), where K2's band of
    # sym(zY) lives in Y's rows, and a deep tree's 512 and 2048 cuts, whose
    # vectors both kernels read from the input (at rank 10 both kernels'
    # partials live in the global workspace; with 2048 cuts at B=1, since
    # the plain version's batched cholesky_solve raises on the card at p =
    # 12,289 and B=2)
    k2, k3 = [], []
    for B, n, k, L, shor in ((64, 50, 1, 8, False), (64, 50, 1, 32, False), (1, 50, 1, 8, False),
                             (4, 50, 1, 8, False), (64, 75, 2, 8, False), (64, 75, 2, 32, False),
                             (32, 75, 2, 8, False), (32, 100, 1, 8, True),
                             (C4["B"], C4["n"], C4["k"], C4["L"], False), (2, 1000, 10, 8, False),
                             (4, 50, 1, 512, False), (2, 250, 10, 512, False),
                             (1, 250, 10, 2048, False)):
        c, st, acc, ts = _admm_inputs(B, n, n, k, L, gen, dev)
        r2, r3 = _check_k2_k3(c, st, acc, ts, shor=shor, sweep=n <= 250 and L <= 32)
        del c, st, acc, ts
        for name, r in (("K2", r2), ("K3", r3)):
            log(name, json.dumps(r))
            # float32 sums in another order than the plain version's: 1e-6
            # relative.  At config 4's shape and beyond, the float32 plain
            # version is itself 1.1e-6 to 1.4e-6 from its float64 evaluation
            # (K3's uc: sums of n^2 = 62,500 terms; on an H100), and with 257
            # cuts K2's U 5e-7 to 9e-7 (sums over every cut), so there the
            # kernels are held to 1e-6 of the float64 one.  Two launches give
            # the same bits; the plan's shared memory is the kernel's own.
            err = r["rel_err_vs_f64"] if n >= 250 or L > 32 else r["rel_err"]
            checks.append((name, r, err <= 1e-6 and r["deterministic"]
                           and r["plan_matches_kernel"]))
        k2.append(r2)
        k3.append(r3)
    # K2's band in Y's rows at the headline's shape, against the same plain
    # version
    c, st, acc, ts = _admm_inputs(4, 50, 50, 1, 8, gen, dev)
    r2, _ = _check_k2_k3(c, st, acc, ts, band="rows", sweep=False)
    log("K2", json.dumps(r2))
    checks.append(("K2", r2, r2["rel_err"] <= 1e-6 and r2["deterministic"]
                   and r2["plan_matches_kernel"]))
    k2.append(r2)
    del c, st, acc, ts
    out["K2"], out["K3"] = k2, k3

    # ---- K8a, K7 (fused and projection mode) and K8b at every shape the
    # Shor k=1 loop runs them (the first row of each is the record's) ----
    for name in ("K8a", "K7fused", "K7", "K8b"):
        out[name] = []
    for B, n, M5 in SHOR_SHAPES:
        rows = _check_shor_kernels(B, n, n, 8, M5, gen, dev)
        rows["K7"] = _check_k7_projection(B, M5, gen, dev)
        for name, row in rows.items():
            log(name, json.dumps(row))
            out[name].append(row)
        r8, r7, rp = rows["K8a"], rows["K7fused"], rows["K7"]
        # K8a: float32 sums in another order than the plain version's
        # scatter-adds, 1e-5 relative, K8a's plan the kernel's; K7: the bars
        # of K1 (see above); both the same bits twice
        checks.append(("K8a", r8, r8["rel_err"] <= 1e-5 and r8["deterministic"]
                       and r8["plan_matches_kernel"]))
        checks.append(("K7fused", r7, r7["plain_vs_eigh"] <= 1e-4 and r7["kernel_vs_eigh"] <= 1e-4
                       and r7["rel_err"] <= 2e-4 and r7["deterministic"]))
        # the bars of K1 (see above): each within 1e-4 of the exact
        # projection, the two within 2e-4, the truncated control fails
        checks.append(("K7", rp, rp["plain_vs_eigh"] <= 1e-4 and rp["kernel_vs_eigh"] <= 1e-4
                       and rp["rel_err"] <= 2e-4 and rp["deterministic"]
                       and not rp["control_16bit_vs_eigh"] <= 1e-4))
        # K8b: float32 link sums in another order than the plain version's,
        # 1e-5 relative as K8a, the same bits twice, its plan the kernel's
        r8b = rows["K8b"]
        checks.append(("K8b", r8b, r8b["rel_err"] <= 1e-5 and r8b["deterministic"]
                       and r8b["plan_matches_kernel"]))

    # ---- K7x projection mode: (32, 4096, 3, 3), spectra +-[0.1, 1] ----
    row = _check_k7x_projection(32, 4096, 3, gen, dev)
    log("K7x", json.dumps(row))
    # the bars of K1/K7 (see above)
    checks.append(("K7x", row, row["plain_vs_eigh"] <= 1e-4 and row["kernel_vs_eigh"] <= 1e-4
                   and row["rel_err"] <= 2e-4 and row["deterministic"]
                   and not row["control_16bit_vs_eigh"] <= 1e-4))
    out["K7x"] = [row]

    # ---- K8c, K7t, K7x (slots), K8d at BASELINE config 3's shapes ----
    rows = _check_shor_k_kernels(32, 75, 75, 8, 1024, gen, dev)
    for name, row in rows.items():
        log(name, json.dumps(row))
    # K8c: float32 sums in another order than the plain version's
    # scatter-adds, so 1e-5 relative as K8a/K8b; two launches on the same
    # input must give the same bits (no atomics)
    r = rows["K8c"]
    checks.append(("K8c", r, r["rel_err"] <= 1e-5 and r["deterministic"]
                   and r["smem_matches_kernel"]))
    out.update({name: [row] for name, row in rows.items()})
    # K8c at k = 3 and 4: the same bars on the kernel's other instantiations;
    # K7t, K7x and K8d at k = 3 and 4 on K8c's primal
    for k in (3, 4):
        r, stepped = _check_k8c(32, 75, 75, 8, 1024, k, gen, dev)
        log("K8c", json.dumps(r))
        checks.append(("K8c", r, r["rel_err"] <= 1e-5 and r["deterministic"]
                       and r["smem_matches_kernel"]))
        out["K8c"].append(r)
        for name, fn in (("K7t", _check_k7t), ("K7xfused", _check_k7x), ("K8d", _check_k8d)):
            r = fn(*stepped, gen, dev)
            log(name, json.dumps(r))
            out[name].append(r)
    # K7x and K8d at a root visit's B=1 (M5=64): K8d's last W >= 0 and RSOC
    # quads are ragged (n m = 5,625)
    c, sc, st = _shor_k_inputs(1, 75, 75, 8, 64, gen, dev)
    for name, fn in (("K7xfused", _check_k7x), ("K8d", _check_k8d)):
        r = fn(c, sc, st, gen, dev)
        log(name, json.dumps(r))
        out[name].append(r)
    del c, sc, st
    # K8d: float32 link sums in another order than the plain version's, so
    # 1e-5 relative as K8c; the same bits twice; its plan the kernel's
    for r in out["K8d"]:
        checks.append(("K8d", r, r["rel_err"] <= 1e-5 and r["deterministic"]
                       and r["plan_matches_kernel"]))
    # the K7x slots: the bars of K1/K7 against a float64 eigh projection of
    # the same slot values, the truncated-product control failing them, the
    # same bits twice
    for r in out["K7xfused"]:
        checks.append(("K7xfused", r, r["plain_vs_eigh"] <= 1e-4 and r["kernel_vs_eigh"] <= 1e-4
                       and r["rel_err"] <= 2e-4 and r["deterministic"]
                       and not r["control_16bit_vs_eigh"] <= 1e-4))
    # K7t: the bars of K1/K7 against a float64 eigh projection of the same
    # slot values, the truncated-product control failing them, the same bits
    # twice
    for r in out["K7t"]:
        checks.append(("K7t", r, r["plain_vs_eigh"] <= 1e-4 and r["kernel_vs_eigh"] <= 1e-4
                       and r["rel_err"] <= 2e-4 and r["deterministic"]
                       and not r["control_16bit_vs_eigh"] <= 1e-4))

    # ---- K9s, K9a, K9b at the headline's shape and at config 3's; K9a
    # and K9b also at the root visit's batch and a mid-tree frontier's ----
    for name in ("K9s", "K9a", "K9b"):
        out[name] = []
    for B, n, k in MC_SHAPES + K9S_EXTRA_SHAPES:
        if (B, n, k) in K9S_EXTRA_SHAPES:
            rows = {"K9s": _check_k9s(_mc_inputs(B, n, n, k, gen, dev)[0], B, n, k, dev)}
        else:
            rows = _check_mc_kernels(B, n, n, k, gen, dev, k9s=B == 64)
        for name, row in rows.items():
            log(name, json.dumps(row))
            # float32 sums in another order than the plain version's, so
            # 1e-5 relative as K8c/K8d; two launches give the same bits;
            # K9s's factors reproduce the row Grams; the grids are k9s_plan's
            # and k9_plan's
            checks.append((name, row, row["rel_err"] <= 1e-5 and row["deterministic"]
                           and row.get("gram_rel_err", 0.0) <= 1e-5
                           and row["plan_matches_kernel"]))
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


# (B, n = m, M5) of the Shor k=1 loop's K7 and K8a launches: config 2's
# frontier (the record's row), its root visit's first minor bucket, its
# largest bucket after the growths, and the shor cell's root and frontier
SHOR_SHAPES = ((32, 100, 1024), (1, 100, 64), (32, 100, 4096), (1, 50, 4096), (4, 50, 4096))


def _check_shor_kernels(B, n, m, L, M5, gen, dev):
    """K8a, K7 (fused) and K8b against their plain versions on the same
    inputs, each at the outputs of the step before it: errors, the same bits
    from two launches, CUDA-event and device times (with ``--parent``, the
    parent tree's kernels on the same inputs)."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns_small
    from omc_torch.sdp import admm_shor as S

    from omc_torch import kernels

    lib = kernels.library()
    c, sc, st = _shor_inputs(B, n, m, L, M5, gen, dev)
    shape = dict(B=B, n=n, m=m, M5=M5)
    k8a_out = lambda x: (x.core.X, x.core.Th, x.W, x.v1, x.v2, x.v3)  # noqa: E731
    plan8 = S.k8a_plan(B, n, m, M5)
    P = sum(t.shape[1] for t in (st.v1, st.v2, st.v3))

    out = {}
    sk, s2 = st.clone(), st.clone()
    S.shor_zstep(c, sc, sk)
    S.shor_zstep(c, sc, s2)
    torch.cuda.synchronize()
    ref = S.shor_zstep_plain(c, sc, st)
    rel, ab = _errs(k8a_out(sk), ref)
    s3 = st.clone()
    fns = {"kernel": lambda: S.shor_zstep(c, sc, s3)}
    r8 = out["K8a"] = dict(
        **shape, plan=plan8, plan_matches_kernel=plan8["smem"] == lib.omc_k8a_smem_bytes(
            n, m, plan8["cluster"], plan8["groups"])
        and plan8["grid"][0] == lib.omc_k8a_grid_x(m, P, plan8["cluster"], plan8["groups"]),
        rel_err=rel, max_abs_err=ab, deterministic=_same_bits(k8a_out(sk), k8a_out(s2)),
        ms=cuda_time_ms(fns["kernel"]),
        plain_ms=cuda_time_ms(lambda: S.shor_zstep_plain(c, sc, st)))
    if PARENT:
        fns["parent"] = _parent_k8a(c, sc, st.clone())
        r8["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(r8, fns)
    A_ = float(sc.sb.minor_mask.sum())  # active minors over the batch
    nm = n * m
    # per slot: X and Theta blocks of w1/u1, the RSOC X/W parts, W >= 0,
    # Theta-link, counts and tables; per active minor the 14 entries of w5/u5
    # the adjoint reads; out X, Theta, W, v
    rd = 2 * (nm + m * m) + 4 * nm + nm + 2 * m + 2 * nm + 2 * nm + (nm + 1) + P + 3 + m + 4
    with_bound(r8, 4 * (B * (rd + 2 * nm + m * m + P) + A_ * (2 * 14 + 9) + 2 * nm),
               B * 25 * nm + A_ * 40)

    # K7 fused at K8a's primal; the exact reference projects the same t5
    acc5 = torch.randn(st.u5.shape, generator=gen).to(dev) * 0.1
    s7, s7b = sk.clone(), sk.clone()
    a7, a7b = acc5.clone(), acc5.clone()
    S.minor_step(c, sc, s7, a7, "ns")
    S.minor_step(c, sc, s7b, a7b, "ns")
    torch.cuda.synchronize()
    w5p, u5p, a5p = S.minor_step_plain(c, sc, sk, acc5, project_psd_ns_small)
    w5e, _, _ = S.minor_step_plain(c, sc, sk, acc5,
                                   lambda t: project_psd_plain(t.double()).float())
    rel, ab = _errs((s7.w5, s7.u5, a7), (w5p, u5p, a5p))
    s8, a8 = sk.clone(), acc5.clone()
    fns = {"kernel": lambda: S.minor_step(c, sc, s8, a8, "ns")}
    r7 = out["K7fused"] = dict(
        **shape, rel_err=rel, max_abs_err=ab, plain_vs_eigh=rel_fro(w5p, w5e),
        kernel_vs_eigh=rel_fro(s7.w5, w5e),
        deterministic=_same_bits((s7.w5, s7.u5, a7), (s7b.w5, s7b.u5, a7b)),
        ms=cuda_time_ms(fns["kernel"]),
        plain_ms=cuda_time_ms(lambda: S.minor_step_plain(c, sc, sk, acc5, project_psd_ns_small)))
    if PARENT:
        fns["parent"] = _parent_k7(c, sc, sk.clone(), acc5.clone())
        r7["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(r7, fns)
    N = B * M5
    xw, nv = _k7_gathered(sc.sb, st, n, m)
    # w5/u5/acc read and written, the tables, and once each the entries of
    # X, W and v that this batch's minors gather; the operations: the
    # symmetric schedule's products (the upper triangle, 15 entries of 5
    # FMAs) and the mixing, epilogue and EMA
    with_bound(r7, 4 * (N * (6 * 25 + 10) + 2 * xw + nv + 2 * B),
               N * (SIGN_PRODUCTS * 150 + 75))

    # K8b at K8a's primal
    acc_r = torch.randn(st.ur.shape, generator=gen).to(dev) * 0.1
    acc_l = torch.randn(st.ul.shape, generator=gen).to(dev) * 0.1
    k8b_out = lambda x, ar, al: (x.wr, x.ur, x.wl, x.ul, x.wp, x.up, ar, al)  # noqa: E731
    runs = [(sk.clone(), acc_r.clone(), acc_l.clone()) for _ in range(2)]
    for x, ar, al in runs:
        S.shor_cone_step(c, sc, x, ar, al)
    torch.cuda.synchronize()
    ref = S.shor_cone_step_plain(c, sc, sk, acc_r, acc_l)
    rel, ab = _errs(k8b_out(*runs[0]), ref)
    s9, ar9, al9 = sk.clone(), acc_r.clone(), acc_l.clone()
    plan8b = S.k8b_plan(B, n, m)
    fns = {"kernel": lambda: S.shor_cone_step(c, sc, s9, ar9, al9)}
    r8b = out["K8b"] = dict(
        **shape, plan=plan8b,
        plan_matches_kernel=plan8b["grid"] == lib.omc_k8b_grid_x(B, n, m, plan8b["qpc"]),
        rel_err=rel, max_abs_err=ab,
        deterministic=_same_bits(k8b_out(*runs[0]), k8b_out(*runs[1])),
        ms=cuda_time_ms(fns["kernel"]),
        plain_ms=cuda_time_ms(lambda: S.shor_cone_step_plain(c, sc, sk, acc_r, acc_l)))
    if PARENT:
        fns["parent"] = _parent_k8b(c, sc, sk.clone(), acc_r.clone(), acc_l.clone())
        r8b["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(r8b, fns)
    # per slot: X, W, the RSOC slots and their EMA (read and written), the
    # mask, W >= 0, Theta's diagonal and the link rows
    with_bound(r8b, 4 * B * (2 * nm + 9 * nm + nm + 2 * nm + m + 3 * m + 9 * nm
                             + 2 * nm + 3 * m + 4),
               B * 40 * nm)
    return out


def _k7_gathered(sb, st, n, m):
    """The distinct entries K7's fused gather reads in each slot, summed
    over the slots: of X (and as many of W: the same coordinates), and of
    v1, v2 and v3 together."""
    import torch

    B = sb.minor_idx.shape[0]
    mi = sb.minor_idx.long()
    b = torch.arange(B, device=mi.device)
    f = torch.stack([mi[..., i] * m + mi[..., 2 + j] for i in (0, 1) for j in (0, 1)], -1)
    xw = torch.unique(b[:, None, None] * (n * m) + f).numel()
    nv = sum(torch.unique(b[:, None] * v.shape[1] + torch.cat(
        [getattr(sb, name).long() for name in names], 1)).numel()
        for v, names in ((st.v1, ("iv1a", "iv1b")), (st.v2, ("iv2a", "iv2b")),
                         (st.v3, ("iv3",))))
    return xw, nv


def _check_k7_projection(B, M5, gen, dev):
    """K7's projection mode on B M5 5x5 matrices of spectra +-[0.1, 1]:
    against its plain version and a float64 eigh, with the truncated-product
    control, the same bits twice, CUDA-event and device times."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import (
        project_psd_ns,
        project_psd_ns_small,
        project_psd_small,
        truncated_matmul,
    )

    T, T64 = _spectral_batch(B * M5, 5, gen, dev)
    T, T64 = T.reshape(B, M5, 5, 5), T64.reshape(B, M5, 5, 5)
    wk, wb = project_psd_small(T), project_psd_small(T)
    torch.cuda.synchronize()
    wp = project_psd_ns_small(T)
    exact = project_psd_plain(T64.to(dev))
    # control: the plain schedule with operands truncated to 16 bits
    ctl16 = rel_fro(project_psd_ns(T, matmul=truncated_matmul(16)), exact)
    w2 = torch.empty_like(T)
    fns = {"kernel": lambda: project_psd_small(T, w2)}
    row = dict(B=B, M5=M5, shape=list(T.shape), rel_err=rel_fro(wk, wp),
               max_abs_err=float((wk - wp).abs().max()),
               plain_vs_eigh=rel_fro(wp, exact), kernel_vs_eigh=rel_fro(wk, exact),
               control_16bit_vs_eigh=ctl16, deterministic=torch.equal(wk, wb),
               ms=cuda_time_ms(fns["kernel"]),
               plain_ms=cuda_time_ms(lambda: project_psd_ns_small(T)))
    if PARENT:
        fns["parent"] = _parent_k7_projection(T, torch.empty_like(T))
    _device_rows(row, fns)
    with_bound(row, 4 * 2 * T.numel(), T.numel() // 25 * (SIGN_PRODUCTS * 150 + 75))
    return row


def _device_rows(row, fns):
    """``row``'s device ms per launch (``device_ms``; with ``--parent``,
    ``parent_device_ms``)."""
    dms = _k2k3_device_ms(fns)
    row["device_ms"] = dms.pop("kernel")
    if "parent" in dms:
        row["parent_device_ms"] = dms.pop("parent")


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


def _k8c_plan_row(B, n, m, k):
    """K8c's tile at this shape, its shared memory held against the
    kernel's own count (``omc_k8c_smem_bytes``)."""
    from omc_torch import kernels
    from omc_torch.sdp.shor_k import k8c_plan

    plan = k8c_plan(B, n, m, k)
    smem = kernels.library().omc_k8c_smem_bytes(n, m, k, plan["cols"])
    return dict(plan=plan, smem_matches_kernel=smem == plan["smem_bytes"])


def _check_k8c(B, n, m, L, M5, k, gen, dev):
    """K8c alone at rank k: within 1e-5 relative of its plain version, the
    same bits from two launches (no timing: a second instantiation of the
    kernel on the card).  Returns the row and (c, sc, the stepped state)."""
    import torch

    from omc_torch.sdp import shor_k as SK

    c, sc, st = _shor_k_inputs(B, n, m, L, M5, gen, dev, k=k)
    zs = lambda x: (x.Xt, x.core.X, x.core.Th, x.W, x.Wt, x.Hh, x.v1, x.v2, x.v3)  # noqa: E731
    sk, s2 = st.clone(), st.clone()
    SK.shor_k_zstep(c, sc, sk)
    SK.shor_k_zstep(c, sc, s2)
    torch.cuda.synchronize()
    rel, ab = _errs(zs(sk), SK.shor_k_zstep_plain(c, sc, st))
    return dict(B=B, n=n, m=m, k=k, M5=M5, rel_err=rel, max_abs_err=ab,
                deterministic=_same_bits(zs(sk), zs(s2)), **_k8c_plan_row(B, n, m, k)), (c, sc, sk)


def _check_shor_k_kernels(B, n, m, L, M5, gen, dev):
    """K8c, K7t, K7x (slots) and K8d against their plain versions on the
    same inputs, each at the outputs of the step before it, with times,
    bounds and a determinism check of each."""
    import torch

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
                      deterministic=_same_bits(zs(sk), zs(s2)), **_k8c_plan_row(B, n, m, k),
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

    out["K7t"] = _check_k7t(c, sc, sk, gen, dev)
    out["K7xfused"] = _check_k7x(c, sc, sk, gen, dev)
    out["K8d"] = _check_k8d(c, sc, sk, gen, dev)
    return out


def _check_k7x(c, sc, sk, gen, dev):
    """K7x (slot mode) at a K8c-stepped primal against its plain version and
    against a float64 eigh of the same slot values, with the plain schedule
    on 16-bit operands as the control; the same bits from two launches;
    CUDA-event and device times (with ``--parent``, the parent's kernel on
    the same inputs)."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns, project_psd_ns_small, truncated_matmul
    from omc_torch.sdp import shor_k as SK

    B, n, m, k, kp, C, Ms = SK._shapes(sk)
    accx = torch.randn(sk.ux.shape, generator=gen).to(dev) * 0.1
    runs = [(sk.clone(), accx.clone()) for _ in range(2)]
    for x, a in runs:
        SK.xwh_step(c, sc, x, a, "ns")
    torch.cuda.synchronize()
    plain = lambda proj: SK.xwh_step_plain(c, sc, sk, accx, proj)  # noqa: E731
    wxp, uxp, axp = plain(project_psd_ns_small)
    wxe = plain(lambda t: project_psd_plain(t.double()).float())[0]
    wxc = plain(lambda t: project_psd_ns(t, matmul=truncated_matmul(16)))[0]
    (s7, a7), (s7b, a7b) = runs
    rel, ab = _errs((s7.wx, s7.ux, a7), (wxp, uxp, axp))
    s8, a8 = sk.clone(), accx.clone()
    fns = {"kernel": lambda: SK.xwh_step(c, sc, s8, a8, "ns")}
    row = dict(B=B, C=C, k=k, rel_err=rel, max_abs_err=ab, plain_vs_eigh=rel_fro(wxp, wxe),
               kernel_vs_eigh=rel_fro(s7.wx, wxe), control_16bit_vs_eigh=rel_fro(wxc, wxe),
               deterministic=_same_bits((s7.wx, s7.ux, a7), (s7b.wx, s7b.ux, a7b)),
               ms=cuda_time_ms(fns["kernel"]),
               plain_ms=cuda_time_ms(lambda: plain(project_psd_ns_small)))
    if PARENT:
        fns["parent"] = _parent_k7x(c, sc, sk.clone(), accx.clone())
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # wx/ux/acc read and written, coord_flat and the mask, Wt and H, the
    # entries of Xt that this batch's coordinates gather for each term; the
    # operations: the symmetric schedule's products (the upper triangle,
    # D (D + 1) / 2 entries of D FMAs) and the mixing, epilogue and EMA.
    # bound_all_ms counts all of Xt and the full products instead.
    D = k + 1
    N = B * C
    fl = sc.sb.coord_flat.long()
    gathered = k * torch.unique(torch.arange(B, device=fl.device)[:, None] * (n * m) + fl).numel()
    with_bound(row, 4 * (N * (6 * D * D + 2) + gathered + B * (k + kp) * C + 2 * B),
               N * (SIGN_PRODUCTS * D * D * (D + 1) + 3 * D * D))
    row["bound_all_ms"] = bound(4 * (N * (6 * D * D + 2) + B * k * n * m + B * (k + kp) * C
                                     + 2 * B), N * (SIGN_PRODUCTS * 2 * D ** 3 + 3 * D * D))[0]
    return row


def _check_k7x_projection(B, C, D, gen, dev):
    """K7x's projection mode on B C D x D matrices of spectra +-[0.1, 1]:
    against its plain version and a float64 eigh, with the truncated-product
    control, the same bits twice, CUDA-event and device times."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import (
        project_psd_ns,
        project_psd_ns_small,
        project_psd_xwh,
        truncated_matmul,
    )

    T, T64 = _spectral_batch(B * C, D, gen, dev)
    T, T64 = T.reshape(B, C, D, D), T64.reshape(B, C, D, D)
    wk, wb = project_psd_xwh(T), project_psd_xwh(T)
    torch.cuda.synchronize()
    wp = project_psd_ns_small(T)
    exact = project_psd_plain(T64.to(dev))
    ctl16 = rel_fro(project_psd_ns(T, matmul=truncated_matmul(16)), exact)
    w2 = torch.empty_like(T)
    fns = {"kernel": lambda: project_psd_xwh(T, w2)}
    row = dict(shape=list(T.shape), rel_err=rel_fro(wk, wp),
               max_abs_err=float((wk - wp).abs().max()),
               plain_vs_eigh=rel_fro(wp, exact), kernel_vs_eigh=rel_fro(wk, exact),
               control_16bit_vs_eigh=ctl16, deterministic=torch.equal(wk, wb),
               ms=cuda_time_ms(fns["kernel"]),
               plain_ms=cuda_time_ms(lambda: project_psd_ns_small(T)))
    if PARENT:
        fns["parent"] = _parent_k7x_projection(T, torch.empty_like(T))
    _device_rows(row, fns)
    # t read, w written; the symmetric schedule's products (bound_all_ms:
    # the full products)
    N = T.numel() // (D * D)
    with_bound(row, 4 * 2 * T.numel(), N * (SIGN_PRODUCTS * D * D * (D + 1) + D * D))
    row["bound_all_ms"] = bound(4 * 2 * T.numel(), N * (SIGN_PRODUCTS * 2 * D ** 3 + D * D))[0]
    return row


def _check_k8d(c, sc, sk, gen, dev):
    """K8d at a K8c-stepped primal against its plain version: errors, the
    same bits from two launches, CUDA-event and device times (with
    ``--parent``, the parent's kernel on the same inputs)."""
    import torch

    from omc_torch import kernels
    from omc_torch.sdp import shor_k as SK

    B, n, m, k, kp, C, Ms = SK._shapes(sk)
    nm = n * m
    accs = [torch.randn(x.shape, generator=gen).to(dev) * 0.1 for x in (sk.ur, sk.ul, sk.uwl)]
    kd = lambda x: (x.wr, x.ur, x.wl, x.ul, x.wwl, x.uwl, x.wp, x.up, x.wq, x.uq)  # noqa: E731
    runs = [(sk.clone(), [a.clone() for a in accs]) for _ in range(2)]
    for x, a in runs:
        SK.shor_k_cone_step(c, sc, x, *a)
    torch.cuda.synchronize()
    ref = SK.shor_k_cone_step_plain(c, sc, sk, *accs)
    (sd, ad), (sd2, ad2) = runs
    rel, ab = _errs(kd(sd) + tuple(ad), ref)
    s10, a10 = sk.clone(), [a.clone() for a in accs]
    fns = {"kernel": lambda: SK.shor_k_cone_step(c, sc, s10, *a10)}
    plan = SK.k8d_plan(B, n, m, k, C, Ms)
    row = dict(B=B, n=n, m=m, k=k, C=C, Ms=Ms, plan=plan,
               plan_matches_kernel=plan["grid"] == kernels.library().omc_k8d_grid_x(
                   B, n, m, C, Ms, plan["ipc"]),
               rel_err=rel, max_abs_err=ab,
               deterministic=_same_bits(kd(sd) + tuple(ad), kd(sd2) + tuple(ad2)),
               ms=cuda_time_ms(fns["kernel"]),
               plain_ms=cuda_time_ms(lambda: SK.shor_k_cone_step_plain(c, sc, sk, *accs)))
    if PARENT:
        fns["parent"] = _parent_k8d(c, sc, sk.clone(), *[a.clone() for a in accs])
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # per slot: X, W, Theta's diagonal, Wt, H, the RSOC rows with their EMA
    # and tables, the link rows with their EMAs, W >= 0, Wt >= 0; out the
    # same slots and EMAs
    rd = (2 * nm + m + (k + kp) * C + 9 * Ms + 2 * Ms + 2 * m + 2 * C + 2 * nm + 2 * k * C
          + 2 * C + 4)
    wr = 9 * Ms + 3 * m + 3 * C + 2 * nm + 2 * k * C
    with_bound(row, 4 * B * (rd + wr), B * (40 * Ms + 6 * nm + (k + kp + 6) * C + 5 * k * C))
    return row


def _check_k7t(c, sc, sk, gen, dev):
    """K7t at a K8c-stepped primal against its plain version and against a
    float64 eigh of the same t5, with the plain schedule on 16-bit operands
    as the control; the same bits from two launches; CUDA-event and device
    times (with ``--parent``, the parent's kernel on the same inputs)."""
    import torch

    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns, project_psd_ns_small, truncated_matmul
    from omc_torch.sdp import shor_k as SK

    B, n, m, k, kp, C, Ms = SK._shapes(sk)
    M5 = sc.M5
    acc5 = torch.randn(sk.u5.shape, generator=gen).to(dev) * 0.1
    runs = [(sk.clone(), acc5.clone()) for _ in range(2)]
    for x, a in runs:
        SK.minor_k_step(c, sc, x, a, "ns")
    torch.cuda.synchronize()
    plain = lambda proj: SK.minor_k_step_plain(c, sc, sk, acc5, proj)  # noqa: E731
    w5p, u5p, a5p = plain(project_psd_ns_small)
    w5e = plain(lambda t: project_psd_plain(t.double()).float())[0]
    w5c = plain(lambda t: project_psd_ns(t, matmul=truncated_matmul(16)))[0]
    (s7, a7), (s7b, a7b) = runs
    rel, ab = _errs((s7.w5, s7.u5, a7), (w5p, u5p, a5p))
    s8, a8 = sk.clone(), acc5.clone()
    fns = {"kernel": lambda: SK.minor_k_step(c, sc, s8, a8, "ns")}
    row = dict(B=B, M5=M5, k=k, rel_err=rel, max_abs_err=ab, plain_vs_eigh=rel_fro(w5p, w5e),
               kernel_vs_eigh=rel_fro(s7.w5, w5e), control_16bit_vs_eigh=rel_fro(w5c, w5e),
               deterministic=_same_bits((s7.w5, s7.u5, a7), (s7b.w5, s7b.u5, a7b)),
               ms=cuda_time_ms(fns["kernel"]), plain_ms=cuda_time_ms(lambda: plain(
                   project_psd_ns_small)))
    if PARENT:
        fns["parent"] = _parent_k7t(c, sc, sk.clone(), acc5.clone())
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # w5/u5/acc read and written, the records and the mask, and once each
    # the entries of Xt, Wt and v that this batch's minors gather for each
    # term; the operations: the symmetric schedule's products (the upper
    # triangle, 15 entries of 5 FMAs) and the mixing, epilogue and EMA.
    # bound_all_ms counts all of Xt, Wt and v and the full products instead.
    N = B * M5 * k
    with_bound(row, 4 * (N * 6 * 25 + B * M5 * 17 + _k7t_gathered(sc, n * m) + 2 * B),
               N * (SIGN_PRODUCTS * 150 + 75))
    P = sum(t.shape[2] for t in (sk.v1, sk.v2, sk.v3))
    row["bound_all_ms"] = bound(4 * (N * 6 * 25 + B * M5 * 10 + B * k * (n * m + C) + B * k * P
                                     + B * C + 2 * B), N * (SIGN_PRODUCTS * 250 + 75))[0]
    return row


def _k7t_gathered(sc, nm):
    """The entries K7t's gather reads in each slot, summed over the slots
    and the k terms: the distinct corners' flat entries of Xt, coordinates
    of Wt and entries of v1, v2 and v3."""
    import torch

    rec = sc.rec.long()
    B, M5 = rec.shape[:2]
    C = sc.sb.coord_mask.shape[1]
    b = torch.arange(B, device=rec.device)[:, None, None]
    cnt = torch.unique(b * nm + rec[..., 0:4]).numel() + torch.unique(b * C + rec[..., 4:8]).numel()
    P = {name: getattr(sc.sb, f"cnt_{name}").shape[1] for name in ("v1", "v2", "v3")}
    for name, cols in (("v1", slice(8, 10)), ("v2", slice(10, 12)), ("v3", slice(12, 13))):
        cnt += torch.unique(b * P[name] + rec[..., cols]).numel()
    return sc.k * cnt


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


def _to64(x):
    """A float64 copy of the float32 tensors in a (nested) state or constants."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_to64(y) for y in x)
    return x


# The parent tree's K2, K3, K7, K8a, K8b, K7t, K7x, K8d, K9s-K9b, K4 and K4s (``--parent
# DIR``: a checkout of an older tree), built from DIR's sources and launched on the same inputs as
# the rows, for the records.  Their parameter blocks are DIR's own
# (``omc_torch/kernels.py`` there), each field filled by name: a field this
# script has no value for raises, so a tree whose blocks differ cannot be
# packed wrongly.  K2's and K3's plan fields come from DIR's own
# ``k2k3_plan`` (``omc_torch/sdp/admm.py`` there).
PARENT = {}
PARENT_SOURCES = ("k2_zstep", "k3_cone", "k7_minor_psd", "k8_shor", "k7k_minor_xwh", "k8k_shor_k",
                  "k9_mccormick", "k4_jacobi", "k4s_jacobi_small")


def _load_parent(src):
    """Build DIR's K2, K3, K7, K8, K7t/K7x, K8c/K8d, K9, K4 and K4s sources into
    one library (one nvcc each, in parallel), bind their entry points to DIR's
    blocks, take DIR's ``k2k3_plan`` and keep ptxas's report of DIR's
    kernels."""
    import ctypes
    import importlib.util

    from omc_torch import kernels

    root = os.path.abspath(src)
    csrc = os.path.join(root, "omc_torch", "csrc")

    def module(name, *path):
        spec = importlib.util.spec_from_file_location(name, os.path.join(root, "omc_torch", *path))
        mod = sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    mod = module("parent_kernels", "kernels.py")
    plan = module("parent_admm", "sdp", "admm.py").k2k3_plan
    out = os.path.join(HERE, "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = [(os.path.join(out, f"{name}.o"), subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-I", csrc, "-c", os.path.join(csrc, f"{name}.cu"), "-o",
         os.path.join(out, f"{name}.o")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for name in PARENT_SOURCES]
    logs = []
    for _, proc in jobs:
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        logs.append(err)
    so = os.path.join(out, "libparent_kernels.so")
    subprocess.run([nvcc, "-shared", "-o", so, *[o for o, _ in jobs]], check=True)
    lib = ctypes.CDLL(so)
    for fn, st in ((lib.omc_k2_zstep, mod.K2Params), (lib.omc_k3_cone, mod.K3Params),
                   (lib.omc_k7_minor_psd, mod.K7Params),
                   (lib.omc_k8a_shor_zstep, mod.K8aParams),
                   (lib.omc_k8b_shor_cone, mod.K8bParams),
                   (lib.omc_k7t_minor_k, mod.K7tParams), (lib.omc_k7x_xwh, mod.K7xParams),
                   (lib.omc_k8d_shor_k_cone, mod.K8dParams),
                   (lib.omc_k9s_setup, mod.K9sParams), (lib.omc_k9a_zstep, mod.K9aParams),
                   (lib.omc_k9b_cone, mod.K9bParams), (lib.omc_k4_jacobi, mod.K4Params),
                   (lib.omc_k4s_jacobi_small, mod.K4sParams)):
        fn.argtypes = [ctypes.POINTER(st), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.omc_k4_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.omc_k4_workspace_floats.restype = ctypes.c_longlong
    PARENT.update(lib=lib, P2=mod.K2Params, P3=mod.K3Params, P7=mod.K7Params,
                  P8a=mod.K8aParams, P8b=mod.K8bParams, P7t=mod.K7tParams, P7x=mod.K7xParams,
                  P8d=mod.K8dParams, P9s=mod.K9sParams, P9a=mod.K9aParams, P9b=mod.K9bParams,
                  P4=mod.K4Params, P4s=mod.K4sParams,
                  k2k3_plan=plan,
                  src=src,
                  ptxas=_ptxas_report("".join(logs)))


def _parent_block(cls, values):
    """DIR's parameter block ``cls`` with every field set from ``values``
    (name -> tensor, number or None)."""
    import torch

    prm = cls()
    for name, _ in cls._fields_:
        assert name in values, f"--parent: no value for its block's field {name!r}"
        v = values[name]
        setattr(prm, name, v.data_ptr() if isinstance(v, torch.Tensor) else v)
    return prm


def _parent_launch(fn, prm, *keep):
    """A launcher of the parent's ``fn`` with block ``prm`` (``keep``: the
    tensors the block points to that nothing else holds)."""
    import ctypes

    import torch

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(ctypes.byref(prm), stream)
        assert err == 0, f"parent kernel launch failed ({err})"
    run.keep = keep
    return run


def _parent_values(c, st):
    """The values a parent block's fields may name: the state's slots and
    primal blocks, the cuts, the per-call constants and the shape."""
    from omc_torch.sdp.admm import _SLOTS

    b = c.batch
    names = ("w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc", "wbox", "ubox",
             "wa", "ua", "wb", "ub", "wc", "uc")
    return dict(zip(names, _SLOTS(st)), cut_x=b.cut_x, cut_lo=b.cut_lo, cut_hi=b.cut_hi,
                cut_mask=b.cut_mask, U_lo=b.U_lo, U_hi=b.U_hi, maskA=c.maskA, mask=c.mask,
                G1c=c.G1c, sX=st.sX, sT=st.sT, rho=st.rho, Xs=st.X, Y=st.Y, Ths=st.Th, U=st.U,
                B=st.rho.shape[0], n=c.n, m=c.m, k=c.k, L=c.L, gamma=c.gamma, alpha=c.alpha,
                beta=c.beta)


def _parent_plan_values(c, st, kernel):
    """A parent K2 or K3 block's plan fields, from the parent's own
    k2k3_plan, with the global workspace that plan needs."""
    import torch

    B = st.rho.shape[0]
    plan = PARENT["k2k3_plan"](B, c.n, c.m, c.k, c.L)
    ws = B * plan[f"{kernel}_ws"]
    v = dict(C=plan[f"{kernel}_cluster"], xsmem=int(plan[f"{kernel}_xs"] == "smem"),
             band=int(plan["band"] == "smem"), slsmem=int(plan["k3_slots"] == "smem"),
             ws=torch.empty(ws, dtype=torch.float64, device=st.rho.device) if ws else None)
    return v


def _parent_k2(c, st, shor=False):
    """The parent's K2 on (c, st), writing into st: a launcher with its
    parameter block packed once (``shor``: Xs and Ths null)."""
    v = _parent_values(c, st)
    v.update(_parent_plan_values(c, st, "k2"), G1i=c.G1i)
    if shor:
        v.update(Xs=None, Ths=None)
    return _parent_launch(PARENT["lib"].omc_k2_zstep, _parent_block(PARENT["P2"], v), v["ws"])


def _parent_k3(c, st, ts, acc):
    """The parent's K3 on (c, st), writing into st, ts and acc."""
    v = _parent_values(c, st)
    v.update(_parent_plan_values(c, st, "k3"), t1=ts[0], t2=ts[1], t3=ts[2], acc_a=acc[0],
             acc_b=acc[1], acc_c=acc[2])
    return _parent_launch(PARENT["lib"].omc_k3_cone, _parent_block(PARENT["P3"], v), v["ws"])


def _parent_shor_values(c, sc, st):
    """The values a parent K7, K8a or K8b block's fields may name (K8a's
    cluster and column groups from this tree's ``k8a_plan``)."""
    from omc_torch.sdp.admm_shor import k8a_plan

    sb, core = sc.sb, st.core
    B, n, m = core.X.shape
    plan = k8a_plan(B, n, m, sc.M5)
    v = {name: getattr(sb, name) for name in (
        "minor_idx", "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "minor_mask", "soc_mask", "cnt_X",
        "cnt_W", "cnt_v1", "cnt_v2", "cnt_v3", "xw_ptr", "xw_ent", "v1_ptr", "v1_ent",
        "v2_ptr", "v2_ent", "v3_ptr", "v3_ent")}
    v.update({name: getattr(st, name) for name in (
        "w5", "u5", "wr", "ur", "wl", "ul", "wp", "up", "v1", "v2", "v3")})
    v.update(w1=core.w1, u1=core.u1, g_link=sc.g_link, maskA=c.maskA, mask=c.mask, sX=core.sX,
             sT=core.sT, sS=core.sS, rho=core.rho, Xs=core.X, Ths=core.Th, Ws=st.W, B=B, n=n,
             m=m, M5=sc.M5, nm=n * m, P1=st.v1.shape[1], P2=st.v2.shape[1],
             P3=st.v3.shape[1], gamma=c.gamma, R_X=sc.R_X, alpha=c.alpha, beta=c.beta,
             C=plan["cluster"], Q=plan["groups"])
    return v


def _parent_k8a(c, sc, st):
    """The parent's K8a on (c, sc, st), writing into st."""
    return _parent_launch(PARENT["lib"].omc_k8a_shor_zstep,
                          _parent_block(PARENT["P8a"], _parent_shor_values(c, sc, st)))


def _parent_k7(c, sc, st, acc5):
    """The parent's K7 (fused) on (c, sc, st), writing into st and acc5."""
    v = _parent_shor_values(c, sc, st)
    v.update(t=None, w=st.w5, u=st.u5, acc=acc5, N=v["B"] * v["M5"])
    return _parent_launch(PARENT["lib"].omc_k7_minor_psd, _parent_block(PARENT["P7"], v))


def _parent_k8b(c, sc, st, acc_r, acc_l):
    """The parent's K8b on (c, sc, st), writing into st, acc_r and acc_l (a
    block with a quads-a-CTA field takes this tree's ``k8b_plan``'s)."""
    from omc_torch.sdp.admm_shor import k8b_plan

    v = _parent_shor_values(c, sc, st)
    v.update(acc_r=acc_r, acc_l=acc_l, qpc=k8b_plan(v["B"], v["n"], v["m"])["qpc"])
    return _parent_launch(PARENT["lib"].omc_k8b_shor_cone, _parent_block(PARENT["P8b"], v))


def _parent_k7t(c, sc, st, acc5):
    """The parent's K7t on (c, sc, st), writing into st and acc5 (its block
    takes the minors' tables, or the index records)."""
    sb, core = sc.sb, st.core
    B, n, m = core.X.shape
    k = st.Xt.shape[1]
    v = {name: getattr(sb, name) for name in (
        "mc", "coord_flat", "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "minor_mask")}
    v.update(w=st.w5, u=st.u5, acc=acc5, Xt=st.Xt, Wt=st.Wt, v1=st.v1, v2=st.v2, v3=st.v3,
             rec=sc.rec, sS=core.sS, rho=core.rho, B=B, M5=sc.M5, k=k, nm=n * m,
             C=st.Wt.shape[2], P1=st.v1.shape[2], P2=st.v2.shape[2], P3=st.v3.shape[2],
             alpha=c.alpha, beta=c.beta)
    return _parent_launch(PARENT["lib"].omc_k7t_minor_k, _parent_block(PARENT["P7t"], v))


def _parent_shor_k_values(c, sc, st):
    """The values a parent K7x or K8d block's fields may name (a block with
    an items-a-CTA field takes this tree's ``k8d_plan``'s)."""
    from omc_torch.sdp.shor_k import k8d_plan

    sb, core = sc.sb, st.core
    B, n, m = core.X.shape
    v = {name: getattr(sb, name) for name in ("coord_flat", "coord_mask", "soc_flat", "soc_mask")}
    v.update({name: getattr(st, name) for name in (
        "Xt", "Wt", "Hh", "wr", "ur", "wl", "ul", "wwl", "uwl", "wp", "up", "wq", "uq")})
    v.update(Xs=core.X, Ws=st.W, Ths=core.Th, sX=core.sX, sT=core.sT, sS=core.sS, rho=core.rho,
             B=B, n=n, m=m, k=st.Xt.shape[1], nm=n * m, C=st.Wt.shape[2], Ms=st.wr.shape[1],
             alpha=c.alpha, beta=c.beta)
    v["ipc"] = k8d_plan(B, n, m, v["k"], v["C"], v["Ms"])["ipc"]
    return v


def _parent_k7x(c, sc, st, accx):
    """The parent's K7x (slot mode) on (c, sc, st), writing into st and accx."""
    v = _parent_shor_k_values(c, sc, st)
    v.update(t=None, w=st.wx, u=st.ux, acc=accx, N=v["B"] * v["C"])
    return _parent_launch(PARENT["lib"].omc_k7x_xwh, _parent_block(PARENT["P7x"], v))


def _parent_k7x_projection(T, w):
    """The parent's K7x (projection mode) of T into w: no slot operand."""
    d = T.shape[-1]
    v = dict.fromkeys(("u", "acc", "Xt", "Wt", "Hh", "coord_flat", "coord_mask", "sS", "rho"))
    v.update(C=0, nm=0, alpha=0.0, beta=0.0, t=T, w=w, N=T.numel() // (d * d), k=d - 1)
    return _parent_launch(PARENT["lib"].omc_k7x_xwh, _parent_block(PARENT["P7x"], v))


def _parent_k8d(c, sc, st, acc_r, acc_l, acc_wl):
    """The parent's K8d on (c, sc, st), writing into st and the three EMAs."""
    v = _parent_shor_k_values(c, sc, st)
    v.update(acc_r=acc_r, acc_l=acc_l, acc_wl=acc_wl)
    return _parent_launch(PARENT["lib"].omc_k8d_shor_k_cone, _parent_block(PARENT["P8d"], v))


def _parent_mc_values(c, st):
    """The values a parent K9a or K9b block's fields may name: the
    McCormick state's slots and primal blocks, the per-call constants and
    the shape."""
    v = {name: getattr(st, name) for name in (
        "w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc", "wbox", "ubox", "wmc",
        "umc", "worth", "uorth", "U", "t", "Y", "sX", "sT", "rho")}
    v.update(Xs=st.X, Ths=st.Th, U_lo=c.batch.U_lo, U_hi=c.batch.U_hi, maskA=c.maskA,
             mask=c.mask, Mc=c.Mc, Si=c.Si, Gc=c.Gc, B=st.rho.shape[0], n=c.n, m=c.m, k=c.k,
             gamma=c.gamma, alpha=c.alpha)
    return v


def _parent_k9s(batch, k):
    """The parent's K9s on ``batch``, writing into factors of its own."""
    import torch

    B, n = batch.U_lo.shape[:2]
    q = k * (k + 1) // 2
    out = [torch.empty(s, dtype=torch.float32, device=batch.U_lo.device)
           for s in ((B, n, k + q, k + q), (B, n, k + q, q), (B, q, q))]
    v = dict(U_lo=batch.U_lo, U_hi=batch.U_hi, Mc=out[0], Si=out[1], Gc=out[2], B=B, n=n, k=k)
    return _parent_launch(PARENT["lib"].omc_k9s_setup, _parent_block(PARENT["P9s"], v), *out)


def _parent_k9a(c, st):
    """The parent's K9a on (c, st), writing into st."""
    return _parent_launch(PARENT["lib"].omc_k9a_zstep,
                          _parent_block(PARENT["P9a"], _parent_mc_values(c, st)))


def _parent_k9b(c, st, ts, acc, beta):
    """The parent's K9b on (c, st), writing into st, ts and acc (a block
    with a quads-a-CTA field takes this tree's ``k9_plan``'s)."""
    from omc_torch.sdp.mccormick import k9_plan

    v = _parent_mc_values(c, st)
    v.update(t1=ts[0], t2=ts[1], t3=ts[2], acc_mc=acc[0], acc_orth=acc[1], beta=beta,
             qpc=k9_plan(v["B"], c.n, c.m, c.k)["qpc"])
    return _parent_launch(PARENT["lib"].omc_k9b_cone, _parent_block(PARENT["P9b"], v))


def _parent_k7_projection(T, w):
    """The parent's K7 (projection mode) of T into w: no fused operand."""
    v = dict.fromkeys(("u", "acc", "Xs", "Ws", "v1", "v2", "v3", "minor_idx", "iv1a", "iv1b",
                       "iv2a", "iv2b", "iv3", "minor_mask", "sS", "rho"))
    v.update(dict.fromkeys(("M5", "nm", "P1", "P2", "P3", "m"), 0), alpha=0.0, beta=0.0, t=T,
             w=w, N=T.numel() // 25)
    return _parent_launch(PARENT["lib"].omc_k7_minor_psd, _parent_block(PARENT["P7"], v))


def _parent_k5(U, Y, nout):
    """The parent's K5 (K4's Jacobi template on U U' - Y) on the path this
    tree's ``k4_plan`` gives the eigenpairs, which the parent's separation
    took: a launcher with its block and outputs (and the block path's
    workspace) allocated once."""
    import torch

    from omc_torch.ops.cones import k4_plan

    B, d, k = U.shape
    path = int(k4_plan(B, d, 2)["path"] != "cta")
    lib = PARENT["lib"]
    nwork = lib.omc_k4_workspace_floats(B, d, 2, path)
    f32 = dict(dtype=torch.float32, device=U.device)
    v = dict(M=None, U=U, Y=Y, w=torch.empty(B, nout, **f32), V=torch.empty(B, d, nout, **f32),
             P=None, sweeps=torch.empty(B, dtype=torch.int32, device=U.device),
             work=torch.empty(nwork, **f32) if nwork else None, B=B, d=d, k=k, nout=nout, mode=2,
             path=path)
    return _parent_launch(lib.omc_k4_jacobi, _parent_block(PARENT["P4"], v),
                          *[x for x in v.values() if isinstance(x, torch.Tensor)])


def _parent_k4s(T):
    """The parent's K4s on the (N, D, D) batch T into an output of its own."""
    import torch

    out = torch.empty_like(T)
    v = dict(t=T, w=out, sweeps=None, N=T.shape[0], D=T.shape[-1])
    return _parent_launch(PARENT["lib"].omc_k4s_jacobi_small, _parent_block(PARENT["P4s"], v), T,
                          out)


def _k2k3_device_ms(fns, reps=20, medians=("kernel", "parent")):
    """Device milliseconds per launch of each kernel call in ``fns`` (name ->
    function), read from torch.profiler traces: the calls' CUDA-event times
    include the host's launch, which sets them at B=1.  A trace now and then
    misses its events: a trace that saw none is taken again, and a call that
    no trace saw raises; the names in ``medians`` take the median of three
    traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "self_device_time_total", 0) or 0
                   for ev in prof.key_averages()) / 1e3 / reps

    def timed(fn, want):
        # the median of ``want`` traces that saw the kernel (at most 3 want
        # tries)
        got = []
        for _ in range(3 * want):
            t = traced(fn)
            if t > 0:
                got.append(t)
            if len(got) == want:
                break
        assert got, f"no trace of {3 * want} saw a device kernel"
        return statistics.median(got)

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    return {name: timed(fn, 3 if name in medians else 1) for name, fn in fns.items()}


def _check_k2_k3(c, st, acc, ts, shor=False, band=None, sweep=True):
    """K2 and K3 against their plain versions on the same inputs, in float32
    (``rel_err``) and in float64 (``rel_err_vs_f64``, with the float32 plain
    version's own distance ``plain_vs_f64``); the same bits from two
    launches; ``k2k3_plan`` and its shared memory against the kernels'
    exports; CUDA-event times and device times (``device_ms``; on every
    cluster size with ``sweep``, ``device_ms_by_cluster``) and, with
    ``--parent``, the parent tree's kernels' beside them.  ``shor``: K2's variant that writes Y and U
    only; ``band`` forces K2's band (K3 then runs unchecked)."""
    import torch

    from omc_torch import kernels
    from omc_torch.sdp.admm import (
        _REST,
        K2K3_CLUSTERS,
        cone_step,
        cone_step_plain,
        k2k3_plan,
        zstep,
        zstep_plain,
    )

    lib = kernels.library()
    B, n, m, k, L = c.batch.cut_mask.shape[0], c.n, c.m, c.k, c.L
    plan = k2k3_plan(B, n, m, k, L, band=band)
    shape = dict(B=B, n=n, m=m, k=k, L=L)
    outs = (lambda x: (x.Y, x.U)) if shor else (lambda x: (x.X, x.Y, x.Th, x.U))  # noqa: E731
    s_k, s_2 = st.clone(), st.clone()
    zstep(c, s_k, shor, band=band)
    zstep(c, s_2, shor, band=band)
    torch.cuda.synchronize()
    ref = zstep_plain(c, st)
    ref64 = zstep_plain(_to64(c), _to64(st))
    if shor:
        ref, ref64 = (ref[1], ref[3]), (ref64[1], ref64[3])
    e2, a2 = _errs(outs(s_k), ref)
    s_t = st.clone()
    k2fn = {"kernel": lambda: zstep(c, s_t, shor, band=band)}
    ws2, ws3 = plan["k2_sums"] == "global", plan["k3_sums"] == "global"
    r2 = dict(**shape, shor=shor, plan=plan,
              plan_matches_kernel=plan["k2_smem"] == lib.omc_k2_smem_bytes(
                  n, m, k, L, plan["k2_cluster"], int(plan["band"] == "smem"),
                  int(plan["k2_xs"] == "smem"), int(ws2))
              and plan["k2_ws"] == (lib.omc_k2_ws_doubles(n, m, k, L, plan["k2_cluster"])
                                    if ws2 else 0),
              rel_err=e2, rel_err_vs_f64=_errs(outs(s_k), ref64)[0],
              plain_vs_f64=_errs(ref, ref64)[0], max_abs_err=a2,
              deterministic=_same_bits(outs(s_k), outs(s_2)),
              ms=cuda_time_ms(k2fn["kernel"]), plain_ms=cuda_time_ms(lambda: zstep_plain(c, st)))
    p = 1 + L + L * k
    # per slot: the residual blocks K2 reads (Y, X, Theta of w1/u1; Y, U of
    # w2/u2; w3/u3; the SOC, box and cut slots), the cuts, G1 (its
    # triangle: the Cholesky factor or the symmetric inverse is enough); out
    # X, Y, Theta, U; mask and mask*A once (the shor variant: no X or Theta
    # blocks in or out, no masks)
    xt = 0 if shor else 1
    rd = (2 * (n * n + xt * (n * m + m * m)) + 2 * (n * n + n * k) + 2 * n * n + 2 + 4 * k * n
          + 4 * L * k + 2 * L + L * n + 2 * L * k + L + 3 + p * (p + 1) // 2)
    wr = n * n + n * k + xt * (n * m + m * m)
    with_bound(r2, 4 * (B * (rd + wr) + xt * 2 * n * m),
               B * (8 * L * n * n + 4 * L * n * k + 2 * p * p + 10 * (n * m * xt + n * n)))
    if band is not None:
        return r2, None

    # K3 at the z-step's outputs
    s3, s3b = s_k.clone(), s_k.clone()
    acc_k, acc_b = [a.clone() for a in acc], [a.clone() for a in acc]
    ts_k, ts_b = tuple(torch.empty_like(t) for t in ts), tuple(torch.empty_like(t) for t in ts)
    cone_step(c, s3, ts_k, acc_k)
    cone_step(c, s3b, ts_b, acc_b)
    torch.cuda.synchronize()
    t1, t2, t3, rest, acc_p = cone_step_plain(c, s_k, acc)
    T1, T2, T3, rest64, acc64 = cone_step_plain(_to64(c), _to64(s_k), _to64(acc))
    k3out = lambda x, t, a: list(t) + [getattr(x, nm) for nm in _REST] + list(a)  # noqa: E731
    got = k3out(s3, ts_k, acc_k)
    ref = [t1, t2, t3, *rest, *acc_p]
    ref64 = [T1, T2, T3, *rest64, *acc64]
    e3, a3 = _errs(got, ref)
    s4 = s_k.clone()
    acc4 = [a.clone() for a in acc]
    k3fn = {"kernel": lambda: cone_step(c, s4, ts_k, acc4)}
    r3 = dict(**shape, plan=plan,
              plan_matches_kernel=plan["k3_smem"] == lib.omc_k3_smem_bytes(
                  n, m, k, L, plan["k3_cluster"], int(plan["k3_xs"] == "smem"),
                  int(plan["k3_slots"] == "smem"), int(ws3))
              and plan["k3_ws"] == (lib.omc_k3_ws_doubles(n, m, k, L, plan["k3_cluster"])
                                    if ws3 else 0),
              rel_err=e3, rel_err_vs_f64=_errs(got, ref64)[0],
              plain_vs_f64=_errs(ref, ref64)[0], max_abs_err=a3,
              deterministic=_same_bits(got, k3out(s3b, ts_b, acc_b)),
              ms=cuda_time_ms(k3fn["kernel"]),
              plain_ms=cuda_time_ms(lambda: cone_step_plain(c, s_k, acc)))
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

    # the parent's kernels on the same inputs (up to 512 cuts), and every
    # cluster size
    if PARENT and L <= 512:
        sp, accp = s_k.clone(), [a.clone() for a in acc]
        k2fn["parent"] = _parent_k2(c, st.clone(), shor)
        k3fn["parent"] = _parent_k3(c, sp, tuple(torch.empty_like(t) for t in ts), accp)
        r2["parent_ms"] = cuda_time_ms(k2fn["parent"])
        r3["parent_ms"] = cuda_time_ms(k3fn["parent"])
    if sweep:
        for C in K2K3_CLUSTERS:
            if C <= min(n, m):
                k2fn[C] = (lambda C=C: zstep(c, s_t, shor, cluster=C))
                k3fn[C] = (lambda C=C: cone_step(c, s4, ts_k, acc4, cluster=C))
    # device times: the kernel, the parent's, and (sweep) every cluster size
    for r, fns in ((r2, k2fn), (r3, k3fn)):
        dms = _k2k3_device_ms(fns)
        r["device_ms"] = dms.pop("kernel")
        if "parent" in dms:
            r["parent_device_ms"] = dms.pop("parent")
        if dms:
            r["device_ms_by_cluster"] = dms
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


# (B, n = m, k) of the McCormick kernels' rows: the McCormick cell's batch
# at the headline's shape and at config 3's, the root visit, a mid-tree
# frontier
MC_SHAPES = ((64, 50, 1), (64, 75, 2), (1, 50, 1), (16, 50, 1))
# K9s alone at rank 3: the structured Gram's largest saving over a dense one
K9S_EXTRA_SHAPES = ((64, 50, 3),)


def _check_mc_kernels(B, n, m, k, gen, dev, k9s=True):
    """K9s (with ``k9s``), K9a and K9b against their plain versions on the
    same inputs (K9b at K9a's outputs), with CUDA-event and device times
    (with ``--parent``, the parent's kernels on the same inputs beside),
    bounds, a determinism check of each and, for K9s, Mc Mc' against the row
    Grams."""
    import torch

    from omc_torch.sdp import mccormick as MC

    from omc_torch import kernels

    c, st = _mc_inputs(B, n, m, k, gen, dev)
    q = k * (k + 1) // 2
    kq = k + q
    d1, d2 = n + m, n + k
    plan = MC.k9_plan(B, n, m, k)
    lib = kernels.library()

    out = {}
    if k9s:
        out["K9s"] = _check_k9s(c, B, n, k, dev)
    # ---- K9a ----
    zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
    sk = st.clone()
    MC.mc_zstep(c, sk)
    s2 = st.clone()
    MC.mc_zstep(c, s2)
    torch.cuda.synchronize()
    rel, ab = _errs(zs(sk), MC.mc_zstep_plain(c, st))
    s3 = st.clone()
    fns = {"kernel": lambda: MC.mc_zstep(c, s3)}
    out["K9a"] = row = dict(B=B, n=n, m=m, k=k, plan=plan,
                            plan_matches_kernel=plan["k9a_grid"] == lib.omc_k9a_grid_x(B, n, m),
                            rel_err=rel, max_abs_err=ab,
                            deterministic=_same_bits(zs(sk), zs(s2)),
                            ms=cuda_time_ms(fns["kernel"]),
                            plain_ms=cuda_time_ms(lambda: MC.mc_zstep_plain(c, st)),
                            library_ms=None)
    if PARENT:
        fns["parent"] = _parent_k9a(c, st.clone())
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # per slot: the X, Theta, Y blocks of w1/u1, the Y and U blocks of
    # w2/u2, w3/u3, the trace, SOC, box, envelope and orthogonality slots,
    # the boxes, Mc, Si, Gc; out X, Y, Theta, U, t; mask and mask*A once
    rd = (2 * (n * m + m * m + n * n) + 2 * (n * n + n * k) + 2 * n * n + 2 + 2 * k * n
          + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + n * (kq * kq + kq * q) + q * q + 3)
    wr = n * m + n * n + m * m + n * k + n * q
    with_bound(row, 4 * (B * (rd + wr) + 2 * n * m),
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
    fns = {"kernel": lambda: MC.mc_cone_step(c, s4, ts4, a4, beta)}
    out["K9b"] = row = dict(B=B, n=n, m=m, k=k, plan=plan,
                            plan_matches_kernel=plan["k9b_grid"] == lib.omc_k9b_grid_x(
                                B, n, m, k, plan["qpc"]),
                            rel_err=rel, max_abs_err=ab,
                            deterministic=_same_bits(got, got2),
                            ms=cuda_time_ms(fns["kernel"]),
                            plain_ms=cuda_time_ms(
                                lambda: MC.mc_cone_step_plain(c, sk, acc, beta)),
                            library_ms=None)
    if PARENT:
        fns["parent"] = _parent_k9b(c, sk.clone(), tuple(torch.empty_like(x) for x in ts4),
                                    [a.clone() for a in acc], beta)
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # per slot: X, Y, Theta, U, t and the w/u of every slot in, the boxes and
    # both running means (read and written); t1-t3 and the non-PSD slots out
    rd = (n * m + n * n + m * m + n * k + n * q + 2 * (d1 * d1 + d2 * d2 + n * n) + 2
          + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + 4 * n * q + q + 3)
    wr = (d1 * d1 + d2 * d2 + n * n + 2 + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q
          + 4 * n * q + q)
    with_bound(row, 4 * B * (rd + wr),
               B * (5 * (d1 * d1 + d2 * d2 + n * n) + 20 * n * q + 10 * n * k))
    return out


def _check_k9s(c, B, n, k, dev):
    """K9s against its plain version, with CUDA-event and device times (with
    ``--parent``, the parent's kernel on the same inputs beside), its bound,
    a determinism check and Mc Mc' against the row Grams."""
    import torch

    from omc_torch.sdp import mccormick as MC

    from omc_torch import kernels

    q = k * (k + 1) // 2
    kq = k + q
    got = MC.mc_setup(c.batch, k)
    got2 = MC.mc_setup(c.batch, k)
    torch.cuda.synchronize()
    ref = MC.mc_setup_plain(c.batch, k)
    gram = MC.mc_gram_plain(c.batch, k)
    rel, ab = _errs(got, ref)
    Et = torch.zeros((kq, q), dtype=torch.float32, device=dev)
    Et[k:] = torch.eye(q, dtype=torch.float32, device=dev)
    Etb = Et.expand(B, n, kq, q).contiguous()
    plan = MC.k9s_plan(B, n, k)
    lib = kernels.library()
    # ms: the wrapper as the solver calls it (a new buffer, the block packed
    # and every operand checked); launch_ms: the launch alone, of a block
    # packed beforehand into one buffer, as parent_ms launches the parent's
    buf = MC.mc_setup_buffer(B, n, k, dev)
    prm = MC._k9s_params(c.batch, k, MC._k9s_views(buf, B, n, k), dev)
    fns = {"kernel": lambda: MC.mc_setup(c.batch, k)}
    row = dict(B=B, n=n, k=k, plan=plan,
               plan_matches_kernel=(plan["threads"] == lib.omc_k9s_threads(n, k)
                                    and plan["smem_bytes"] == lib.omc_k9s_smem_bytes(n, k)),
               rel_err=rel, max_abs_err=ab,
               gram_rel_err=rel_fro(got[0] @ got[0].transpose(-1, -2), gram),
               deterministic=_same_bits(got, got2),
               ms=cuda_time_ms(fns["kernel"]),
               launch_ms=cuda_time_ms(lambda: kernels.launch("K9s", "omc_k9s_setup", prm, dev)),
               plain_ms=cuda_time_ms(lambda: MC.mc_setup_plain(c.batch, k)),
               # the library chain on the same Grams: cuSOLVER's batched
               # Cholesky, then the triangular solves for S_i
               library_ms=cuda_time_ms(
                   lambda: torch.cholesky_solve(Etb, torch.linalg.cholesky(gram))))
    if PARENT:
        fns["parent"] = _parent_k9s(c.batch, k)
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    # boxes in; Mc, Si, Gc out.  Per row: the Gram from its structure (each
    # envelope row's at most 3 x 3 block: 4 q rows of at most 12 operations),
    # its Cholesky, q solves; per slot G's sum and Cholesky
    return with_bound(row, 4 * (B * n * (2 * k + kq * kq + kq * q) + B * q * q),
                      B * n * (48 * q + kq ** 3 // 3 + 2 * q * kq * kq)
                      + B * (n * q * q + q ** 3))


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


# K5's rows (B, n, k): the headline's base path (64, 50, 1; the row of the
# record), config 3's (64, 75, 2), the headline's root visit (1, 50, 1),
# the multinode and shor cells' (4, 50, 1), shork's (32, 75, 2), config 2's
# (32, 100, 1) and config 4's (128, 250, 5); K4s's (N, D): config 2's 5x5
# minors (32 x 4096), the shor cell's (4 x 4096), shork's per-term minors
# (32 x 1024 x 2) and XWH slots (32 x 4096, k + 1 = 3)
K5_SHAPES = ((64, 50, 1), (64, 75, 2), (1, 50, 1), (4, 50, 1), (32, 75, 2), (32, 100, 1),
             (128, 250, 5))
K4S_SHAPES = ((32 * 4096, 5), (4 * 4096, 5), (32 * 1024 * 2, 5), (32 * 4096, 3))


def _check_k5_special(rows, path, d, case, gen, dev, launch, plan, max_iters):
    """One K5 row on ``path`` at order ``d`` (B = 4) on an input that takes
    a special branch of the kernel (``case``), held as the mirror's tests
    hold it: the residual ||A v - lambda v|| and the eigenvalues within
    1e-5 max(||A||_F, 1) of a float64 eigh of the same float32 input, V'V
    within 1e-5 of I, all finite, no inverse iteration past its cap."""
    import torch

    B = 4
    U = torch.zeros(B, d, 1, dtype=torch.float64)
    if case.startswith("gap"):
        gap = float(case.split()[1])
        U = torch.randn(B, d, 1, generator=gen, dtype=torch.float64)
        Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=torch.float64))
        lam = torch.empty(B, d, dtype=torch.float64).uniform_(-0.3, 1.0, generator=gen)
        lam[:, 0], lam[:, 1] = -1.0, -1.0 + gap
        Y = U @ U.transpose(-1, -2) - (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    elif case == "zero":
        Y = torch.zeros(B, d, d, dtype=torch.float64)
    elif case == "Y=UU'":
        U = torch.randn(B, d, 1, generator=gen, dtype=torch.float64)
        Y = U @ U.transpose(-1, -2)
    else:
        diag = torch.empty(B, d, dtype=torch.float64).uniform_(-1.0, 1.0, generator=gen)
        if case == "diagonal repeated":
            diag[:, 0] = diag[:, d - 1] = diag.amin(-1) - 0.1
        Y = -torch.diag_embed(diag)
    U32 = U.float().to(dev).contiguous()
    Y32 = (0.5 * (Y + Y.transpose(-1, -2))).float().to(dev).contiguous()
    it = torch.empty(B, dtype=torch.int32, device=dev)
    w, V = launch(U32, Y32, plan(B, d, path), it)
    torch.cuda.synchronize()
    M = U32.double() @ U32.double().transpose(-1, -2) - Y32.double()
    A = 0.5 * (M + M.transpose(-1, -2))
    w64 = torch.linalg.eigvalsh(A)[:, :2]
    scale = torch.linalg.norm(A, dim=(-2, -1)).clamp(min=1.0)
    w, V = w.double(), V.double()
    row = dict(path=path, d=d, case=case, max_iters=int(it.max()),
               finite=bool(torch.isfinite(w).all() and torch.isfinite(V).all()),
               resid=float((torch.linalg.norm(A @ V - V * w[:, None, :], dim=-2).amax(-1)
                            / scale).max()),
               orth_err=float((V.transpose(-1, -2) @ V - torch.eye(2, dtype=V.dtype,
                                                                 device=dev)).abs().max()),
               eig_err=float(((w - w64).abs().amax(-1) / scale).max()))
    row["ok"] = (row["finite"] and row["resid"] <= 1e-5 and row["orth_err"] <= 1e-5
                 and row["eig_err"] <= 1e-5 and row["max_iters"] <= max_iters)
    rows.append(row)


def _check_eig_kernels(gen, dev):
    """K4 (three epilogues), K4s, K5 and K6 against float64 references and
    their plain versions on the card, with times, bounds and sweep counts.
    Bars: eigenvalues within 1e-5 max|lambda| and projections within 1e-5
    relative Frobenius of a float64 eigh of the same float32 input, K5's
    vectors within 1e-5 up to sign, K6 within 1e-5 relative of its plain
    version; no Jacobi hits its sweep cap.  Times: ``tm`` below."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.ops.jacobi import MAX_SWEEPS
    from omc_torch.ops.tridiag import MAX_ITERS as K5_MAX_ITERS
    from omc_torch.ops.linalg import (
        K6_PATHS,
        k6_plan,
        u_step_unconstrained,
        u_step_unconstrained_plain,
        v_step,
        v_step_plain,
    )
    from omc_torch.ops.cones import K4_PATHS
    from omc_torch.sdp.relax import (
        K5_PATHS,
        K5_TRIDIAG,
        _k5_launch,
        k5_plan,
        separation_eigpairs,
        separation_eigpairs_plain,
    )

    out = {"K4": [], "K4s": [], "K5": [], "K6": [], "K4_nonfinite": [], "K5_nonfinite": [],
           "K5_special": []}
    i32 = dict(dtype=torch.int32, device=dev)

    def tm(fn, warm=False):
        """Median of 20 timed calls; of 3 for a call over 20 ms (cuSOLVER
        at B=64), one call for a call over 200 ms (cuSOLVER at B=128).
        ``warm``: the call has just run, so the first timed call counts."""
        probe = cuda_time_ms(fn, reps=1, warmup=0 if warm else 1)
        if probe > 200.0:
            return probe
        return cuda_time_ms(fn) if probe <= 20.0 else cuda_time_ms(fn, reps=3, warmup=0)

    # a NaN or an Inf runs to the sweep cap and gives NaN out (K4 on each
    # of its paths, K4s)
    for D, path in [(50, path) for path in cones.K4_PATHS] + [(5, None)]:
        T, _ = _eig_batch(2, D, gen, dev)
        T[0, 1, 2], T[1, 0, 0] = float("nan"), float("inf")
        sw = torch.empty(2, **i32)
        got = (cones.k4_jacobi(T, 1, sweeps=sw, path=path) if D > 8
               else cones.k4s_project_psd(T, sw))
        torch.cuda.synchronize()
        row = dict(D=D, path=path, sweeps=sw.tolist(), all_nan=bool(got.isnan().all()))
        row["ok"] = row["all_nan"] and row["sweeps"] == [MAX_SWEEPS + 1] * 2
        out["K4_nonfinite"].append(row)
    # and on K5's tridiag paths: NaN out, the inverse iteration at its cap
    for path in K5_TRIDIAG:
        T, _ = _eig_batch(2, 50, gen, dev)
        T[0, 1, 2], T[1, 0, 0] = float("nan"), float("inf")
        it = torch.empty(2, **i32)
        w, V = _k5_launch(torch.zeros(2, 50, 1, device=dev), T, k5_plan(2, 50, path), it)
        torch.cuda.synchronize()
        row = dict(D=50, path=path, iters=it.tolist(),
                   all_nan=bool(w.isnan().all() and V.isnan().all()))
        row["ok"] = row["all_nan"] and row["iters"] == [K5_MAX_ITERS + 1] * 2
        out["K5_nonfinite"].append(row)
    # and on the inputs that take K5's special branches, on each tridiag
    # path: a repeated and a near-repeated smallest pair (warp 1's inverse
    # iteration orthogonalised against the first vector after every
    # solve), and tridiagonals that split (the zero matrix, whose
    # orthogonalisation leaves nothing and reseeds; a diagonal matrix, its
    # smallest entry once or twice; Y = U U'), at d = 50 and at config 4's
    # 250 on the float32 triangle
    for path, d in [(p, 50) for p in K5_TRIDIAG] + [("tridiag32", 250)]:
        for case in ("gap 0", "gap 1e-9", "zero", "diagonal", "diagonal repeated", "Y=UU'"):
            _check_k5_special(out["K5_special"], path, d, case, gen, dev, _k5_launch, k5_plan,
                              K5_MAX_ITERS)

    # ---- K4: the headline's S1 first (the row the record times), the
    # headline's B=1 and multinode's B=4 visits (S1 at d = 100, S2 at d =
    # 51), then BASELINE config 4's bound (B = 128: S1 at d = 500, S2 at
    # d = 255, the spectra at d = 250) and config 5's sizing (B = 1,
    # d = 1000) ----
    lib = kernels.library()
    m3, m10 = (1, 0, 2), (1, 0)
    for B, d, modes in ((64, 100, m3), (64, 50, m3), (64, 51, m3), (64, 150, m3),
                        (1, 100, m10), (4, 100, m10), (1, 51, m10), (4, 51, m10),
                        (32, 200, m3), (2, 500, m3), (128, 500, (1,)), (128, 255, (1,)),
                        (128, 250, (0,)), (1, 1000, m10)):
        T, T64 = _eig_batch(B, d, gen, dev)
        w64, V64 = torch.linalg.eigh(T64)
        P64 = (V64 * w64.clamp(min=0.0)[..., None, :]) @ V64.transpose(-1, -2)
        lam = w64.abs().amax(-1)
        # the plain eigenvalue and eigenpair versions are the library calls
        # themselves: each is timed once
        lib_ms = {}

        def library_ms(name):
            if name not in lib_ms:
                fn = torch.linalg.eigvalsh if name == "eigvalsh" else torch.linalg.eigh
                lib_ms[name] = tm(lambda: fn(T))
            return lib_ms[name]

        for mode in modes:
            plan = cones.k4_plan(B, d, mode)

            def judge(got, sw):
                """The row's errors and its bars for one output."""
                r = dict(max_sweeps=int(sw.max()), min_sweeps=int(sw.min()))
                if mode == 1:
                    r["rel_err_vs_f64"] = float(((got.double() - P64).norm(dim=(-2, -1))
                                                 / P64.norm(dim=(-2, -1))).max())
                    ok = r["rel_err_vs_f64"] <= 1e-5
                else:
                    w = got if mode == 0 else got[0]
                    r["eig_err_vs_f64"] = float(((w.double() - w64).abs().amax(-1) / lam).max())
                    ok = r["eig_err_vs_f64"] <= 1e-5
                    if mode == 2:
                        V = got[1].double()
                        resid = (T64 @ V - V * w.double()[..., None, :]).norm(dim=(-2, -1))
                        eye = torch.eye(d, dtype=torch.float64, device=dev)
                        r["residual"] = float((resid / T64.norm(dim=(-2, -1))).max())
                        r["orthogonality"] = float((V.transpose(-1, -2) @ V - eye)
                                                   .norm(dim=(-2, -1)).max())
                        ok = (ok and r["residual"] <= 1e-5 * d ** 0.5
                              and r["orthogonality"] <= 1e-5 * d ** 0.5)
                r["ok"] = ok and r["max_sweeps"] <= MAX_SWEEPS
                return r

            sw = torch.empty(B, **i32)
            got = cones.k4_jacobi(T, mode, sweeps=sw)
            torch.cuda.synchronize()
            row = dict(B=B, d=d, mode=("eigvalsh", "projection", "eigh")[mode], plan=plan,
                       **judge(got, sw))
            if mode == 1:
                plain = cones.project_psd_plain(T)
                row["max_abs_err"] = float((got - plain).abs().max())
                plain_ms, library = tm(lambda: cones.project_psd_plain(T)), library_ms("eigh")
            elif mode == 0:
                row["max_abs_err"] = float((got - torch.linalg.eigvalsh(T)).abs().max())
                plain_ms = library = library_ms("eigvalsh")
            else:
                # eigenvalues only: the vectors of a cluster are a basis of
                # its subspace, not unique, and signs are free
                row["max_abs_err"] = float((got[0] - cones.eigh_plain(T)[0]).abs().max())
                plain_ms = library = library_ms("eigh")
            # every path k4_plan could take: its time, its bars, and its
            # workspace held against the kernel's export
            by_path, err_by_path = {}, {}
            for path in cones.K4_PATHS:
                try:
                    pp = cones.k4_plan(B, d, mode, path)
                except ValueError:
                    continue  # A (and V) do not fit the CTA path's shared memory
                ws = lib.omc_k4_workspace_floats(B, d, mode, int(path != "cta"))
                sw2 = torch.empty(B, **i32)
                out2 = cones.k4_jacobi(T, mode, sweeps=sw2, path=path)
                torch.cuda.synchronize()
                err_by_path[path] = judge(out2, sw2)
                err_by_path[path]["workspace_matches_kernel"] = ws == pp["workspace_floats"]
                by_path[path] = tm(lambda: cones.k4_jacobi(T, mode, path=path), warm=True)
                if path != "cta":
                    # the grid barriers the call passed, the time its first
                    # CTA spent in each phase, and its launch shape
                    st = {}
                    cones.k4_jacobi(T, mode, path=path, stats=st)
                    err_by_path[path].update(st)
            row.update(ms=by_path[plan["path"]], plain_ms=plain_ms, library_ms=library,
                       ms_by_path=by_path, err_by_path=err_by_path)
            row["ok"] = row["ok"] and all(
                e["ok"] and e["workspace_matches_kernel"] for e in err_by_path.values())
            # an eigendecomposition counts 9 d^3 flops with vectors and
            # 4 d^3 / 3 without, whatever the method; the projection adds
            # the symmetric half of V max(w, 0) V' (d^3)
            outf = (d, d * d, d * d + d)[mode]
            with_path_bound(row, plan["path"], 4 * B * (d * d + outf),
                            B * (4 * d ** 3 / 3, 10 * d ** 3, 9 * d ** 3)[mode])
            out["K4"].append(row)

    # the grid barrier's cost: the block path on diagonal matrices (one
    # outer sweep that rotates nothing: 1 + 2 x 31 barriers at d = 500 and
    # no products)
    T = torch.diag_embed(torch.linspace(-1.0, 1.0, 500, device=dev)).expand(1, 500, 500)
    T = T.contiguous()
    sw = torch.empty(1, **i32)
    cones.k4_jacobi(T, 0, sweeps=sw, path="block16")
    rounds = cones.k4_plan(1, 500, 0, "block16")["rounds"]
    st = {}
    cones.k4_jacobi(T, 0, path="block16", stats=st)
    probe = dict(B=1, d=500, sweeps=int(sw.max()), **st,
                 ms=tm(lambda: cones.k4_jacobi(T, 0, path="block16")))
    probe["us_per_barrier_at_most"] = 1e3 * probe["ms"] / probe["grid_barriers"]
    probe["ok"] = probe["sweeps"] == 1 and probe["grid_barriers"] == 1 + 2 * rounds
    log("K4 barrier", json.dumps(probe))
    out["K4_barrier"] = [probe]

    # ---- K4s: the Shor bounds' 5x5 minors at config 2's (32 x 4096; the
    # row of the record), the shor cell's (4 x 4096) and the rank-k
    # per-term minors (32 x 1024 x 2), then the 3x3 XWH slots (32 x 4096) ----
    for N, D in K4S_SHAPES:
        T, T64 = _eig_batch(N, D, gen, dev)
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
        plan = cones.k4s_plan(N, D)
        row.update(plan=plan, plan_matches_kernel=plan["ctas"] == lib.omc_k4s_grid_x(N),
                   smem_matches_kernel=plan["smem_bytes"] == lib.omc_k4s_smem_bytes(D))
        row["ok"] = (row["rel_err_vs_f64"] <= 1e-5 and row["per_matrix_err_vs_f64"] <= 1e-5
                     and row["max_sweeps"] <= MAX_SWEEPS and row["plan_matches_kernel"]
                     and row["smem_matches_kernel"])
        with_bound(row, 4 * 2 * T.numel(), T.shape[0] * 10 * D ** 3)
        fns = {"kernel": lambda: cones.k4s_project_psd(T)}
        if PARENT:
            fns["parent"] = _parent_k4s(T)
        _device_rows(row, fns)
        out["K4s"].append(row)

    # ---- K5: U U' - Y with its two smallest eigenvalues -1 and -0.6, at
    # every driving phase's shape (K5_SHAPES) ----
    for B, n, k in K5_SHAPES:
        U = torch.randn(B, n, k, generator=gen, dtype=torch.float64)
        Q, _ = torch.linalg.qr(torch.randn(B, n, n, generator=gen, dtype=torch.float64))
        lam = torch.empty(B, n, dtype=torch.float64).uniform_(-0.3, 1.0, generator=gen)
        lam[:, 0], lam[:, 1] = -1.0, -0.6
        Y = U @ U.transpose(-1, -2) - (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
        U32 = U.float().to(dev).contiguous()
        Y32 = (0.5 * (Y + Y.transpose(-1, -2))).float().to(dev).contiguous()
        M64 = U32.double() @ U32.double().transpose(-1, -2) - Y32.double()
        w64, V64 = torch.linalg.eigh(0.5 * (M64 + M64.transpose(-1, -2)))
        plan = k5_plan(B, n)
        it = torch.empty(B, **i32)
        w, V = _k5_launch(U32, Y32, plan, it)
        torch.cuda.synchronize()
        wp, Vp = separation_eigpairs_plain(U32, Y32)

        def aligned(X, R):  # X's columns with R's signs
            return X * torch.sign(torch.sum(X * R, dim=-2, keepdim=True))

        M32 = 0.5 * (M64 + M64.transpose(-1, -2)).float()

        def judge(w, V, it, path):
            """The bars of one path: eigenvalues and sign-aligned vectors
            within 1e-5 of a float64 eigh; the sweep cap on K4's paths (the
            tridiag paths report inverse iterations, no bar)."""
            Va = aligned(V.double(), V64[..., :2])
            count = "sweeps" if path in K4_PATHS else "iters"
            r = {f"max_{count}": int(it.max()), f"min_{count}": int(it.min()),
                 "eig_err_vs_f64": float(((w.double() - w64[:, :2]).abs().amax(-1)
                                          / w64.abs().amax(-1)).max()),
                 "vec_err_vs_f64": float((Va - V64[..., :2]).norm(dim=-2).max())}
            r["ok"] = (r["eig_err_vs_f64"] <= 1e-5 and r["vec_err_vs_f64"] <= 1e-5
                       and (path not in K4_PATHS or r["max_sweeps"] <= MAX_SWEEPS))
            return r

        # every path k5_plan could take, each timed once (the planned
        # path's time is the row's), its bars, and a tridiag path's shared
        # memory and threads held against the kernel's exports
        by_path, err_by_path = {}, {}
        for path in K5_PATHS:
            try:
                pp = k5_plan(B, n, path)
            except ValueError:
                continue  # the triangle (or K4's A and V) does not fit
            it2 = torch.empty(B, **i32)
            w2, V2 = _k5_launch(U32, Y32, pp, it2)
            torch.cuda.synchronize()
            err_by_path[path] = judge(w2, V2, it2, path)
            if path in K5_TRIDIAG:
                err_by_path[path]["smem_matches_kernel"] = (
                    pp["smem_bytes"] == lib.omc_k5_smem_bytes(n, K5_TRIDIAG.index(path))
                    and pp["threads"] == lib.omc_k5_threads())
            by_path[path] = tm(lambda: _k5_launch(U32, Y32, pp), warm=True)
        row = dict(B=B, n=n, k=k, plan=plan, **judge(w, V, it, plan["path"]),
                   max_abs_err=max(float((w - wp).abs().max()),
                                   float((aligned(V, Vp) - Vp).abs().max())),
                   ms=by_path[plan["path"]],
                   plain_ms=tm(lambda: separation_eigpairs_plain(U32, Y32)),
                   library_ms=tm(lambda: torch.linalg.eigh(M32)),
                   ms_by_path=by_path, err_by_path=err_by_path)
        row["smem_matches_kernel"] = all(e.get("smem_matches_kernel", True)
                                         for e in err_by_path.values())
        row["ok"] = row["ok"] and all(e["ok"] for e in err_by_path.values()) and \
            row["smem_matches_kernel"]
        # U and Y read, w and V written; the two smallest eigenpairs need
        # the reduction to tridiagonal form, (4/3) n^3, after U U', 2 n^2 k
        # (bound_all_ms: the 9 n^3 of a full Jacobi eigendecomposition,
        # the figure K5's rows had before its own kernel)
        nbytes = 4 * B * (n * k + n * n + 2 + 2 * n)
        with_path_bound(row, plan["path"], nbytes, B * (4 * n ** 3 / 3 + 2 * n * n * k))
        row["bound_all_ms"] = with_path_bound({}, plan["path"], nbytes, B * 9 * n ** 3)["bound_ms"]
        fns = {"kernel": lambda: separation_eigpairs(U32, Y32)}
        if PARENT:
            fns["parent"] = _parent_k5(U32, Y32, 2)
        _device_rows(row, fns)
        out["K5"].append(row)

    # ---- K6: one V-step + U-step at the headline's n = m = 50, config 4's
    # 250 (k = 5) and config 5's 1000 (k = 10) ----
    lib = kernels.library()
    for n, B, k in ((50, 4, 1), (50, 64, 1), (50, 4, 2), (50, 64, 2), (50, 4, 10),
                    (50, 64, 10), (250, 4, 5), (250, 64, 5), (1000, 4, 10), (1000, 64, 10)):
        m = n
        A = torch.randn(n, m, generator=gen).to(dev)
        mask = (torch.rand(n, m, generator=gen) < 0.5).float().to(dev)
        # well-conditioned factors, as altmin's SVD warm start gives
        Q, _ = torch.linalg.qr(torch.randn(B, n, k, generator=gen, dtype=torch.float64))
        U = (Q * torch.empty(B, 1, k, dtype=torch.float64).uniform_(0.5, 2.0, generator=gen))
        U = U.float().to(dev).contiguous()
        # every path k6_plan could take, each held to the plain version (the
        # U-step on that path's V) and to its own second launch
        by_path, err_by_path = {}, {}
        for path in K6_PATHS:
            try:
                pl = {"v": k6_plan(B, n, m, k, path), "u": k6_plan(B, m, n, k, path)}
            except ValueError:  # the slots path needs n k and m k multiples of 4
                continue
            V = v_step(U, A, mask, 80.0, path=path)
            U2 = u_step_unconstrained(V, A, mask, 80.0, path=path)
            V_b = v_step(U, A, mask, 80.0, path=path)
            U2_b = u_step_unconstrained(V, A, mask, 80.0, path=path)
            torch.cuda.synchronize()
            Vp = v_step_plain(U, A, mask, 80.0)
            U2p = u_step_unconstrained_plain(V, A, mask, 80.0)
            err_by_path[path] = dict(
                rel_err=max(rel_fro(V, Vp), rel_fro(U2, U2p)),
                max_abs_err=max(float((V - Vp).abs().max()), float((U2 - U2p).abs().max())),
                deterministic=_same_bits((V, U2), (V_b, U2_b)),
                smem_matches_kernel=all(
                    x["smem_bytes"] == lib.omc_k6_smem_bytes(
                        K6_PATHS.index(path), k, x["S"], x["W"], x["rpw"]) for x in pl.values()))
            by_path[path] = cuda_time_ms(lambda: u_step_unconstrained(
                v_step(U, A, mask, 80.0, path=path), A, mask, 80.0, path=path))
        plans = {"v": k6_plan(B, n, m, k), "u": k6_plan(B, m, n, k)}
        path = plans["v"]["path"]
        V = v_step(U, A, mask, 80.0)
        G = torch.einsum("bnk,nm,bnl->bmkl", U, mask, U) + (1 / 80.0) * (
            U.transpose(-1, -2) @ U)[:, None] + 1e-10 * torch.eye(k, device=dev)
        r = (U.transpose(-1, -2) @ (mask * A)).transpose(-1, -2)[..., None]
        H = torch.einsum("bkm,nm,blm->bnkl", V, mask, V) + (1 / 80.0) * (
            V @ V.transpose(-1, -2))[:, None] + 1e-10 * torch.eye(k, device=dev)
        r2 = ((mask * A) @ V.transpose(-1, -2))[..., None]
        row = dict(B=B, n=n, m=m, k=k, plan=plans, **err_by_path[path],
                   ms=by_path[path], ms_by_path=by_path, err_by_path=err_by_path,
                   plain_ms=cuda_time_ms(lambda: u_step_unconstrained_plain(
                       v_step_plain(U, A, mask, 80.0), A, mask, 80.0)),
                   # the library's batched solves on the same Grams
                   library_ms=cuda_time_ms(lambda: (torch.linalg.solve(G, r),
                                                    torch.linalg.solve(H, r2))))
        row["max_abs_err"] = max(e["max_abs_err"] for e in err_by_path.values())
        row["beats_library"] = row["ms"] <= row["library_ms"]
        row["ok"] = all(e["rel_err"] <= 1e-5 and e["deterministic"] and e["smem_matches_kernel"]
                        for e in err_by_path.values())
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


# the phases that drive the port's paths through its entry points: every
# launch they make counts in the record (the kernels phase's launches, made
# to compare each kernel with its plain version, do not)
COUNTED = ("admm", "fixtures", "headline", "multinode", "dist", "branch", "shor", "config2",
           "config3", "shork", "mccormick", "config4")
_PHASE = {"name": None}


def _bank(res):
    """Add the launch counts so far to the running phase's totals in
    ``res["launches_by_phase"]``, then set every count to 0."""
    from omc_torch import kernels

    tot = res.setdefault("launches_by_phase", {}).setdefault(
        _PHASE["name"], dict.fromkeys(kernels.LAUNCHES, 0))
    for key, v in kernels.LAUNCHES.items():
        tot[key] += v
    kernels.reset_launches()


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
        _bank(res)  # the launches so far count, then 0
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
    sol, inst, secs = _solve(A, idx, 80.0, **{**BENCH_KW, "time_limit": 30})
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


# the multi-process frontier: two ranks of omc_torch.parallel.worker on the
# card, over gloo, on the multinode instance (BENCH_KW with batch 8, so that
# the frontier outgrows a batch, 60 s, rebalancing every round; the root's
# budget not boosted and at most two refinement visits a node, since with
# either this root certifies alone and rank 1 would get no node)
DIST_RANKS = 2
DIST_TIME_LIMIT = 60
# seconds a rank may take, start-up and the final gather included
DIST_TIMEOUT = 240


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dist(res):
    """Two ranks of ``python -m omc_torch.parallel.worker --instance
    multinode`` share the card: the root starts on
    rank 0, rank 1 starts empty and gets nodes only by migration.  Both exit
    0, agree on the objective (the instance's optimum within the combined
    gaps), certify the gap or keep every lower bound at or below the
    optimum, rank 1 explores nodes, the global census is the sum of the
    ranks', each rank's K1-K6 launch counts grew, and the migration was
    warm: migrated states were installed, and none had a leaf that did not
    fit the wire: rank 1 installed states that came with its nodes."""
    from omc_torch import kernels

    kernels.library()  # the build phase's library: the ranks load it, never build
    out_dir = os.path.join(HERE, "build", "dist_phase")
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "omc_torch.parallel.worker", "--coordinator",
           f"localhost:{_free_port()}", "--world", str(DIST_RANKS), "--instance", "multinode",
           "--device", "cuda", "--set", f"time_limit={DIST_TIME_LIMIT}",
           "--timeout", "120"]
    procs, files = [], []
    for r in range(DIST_RANKS):
        fo = open(os.path.join(out_dir, f"rank{r}.out"), "w+")
        fe = open(os.path.join(out_dir, f"rank{r}.err"), "w+")
        files.append((fo, fe))
        procs.append(subprocess.Popen(cmd + ["--rank", str(r)], cwd=HERE, stdout=fo, stderr=fe,
                                      text=True))
    deadline = time.time() + DIST_TIMEOUT
    ranks = []
    try:
        for r, (p, (fo, fe)) in enumerate(zip(procs, files)):
            rc = p.wait(timeout=max(1.0, deadline - time.time()))
            fo.seek(0)
            fe.seek(0)
            out, err = fo.read(), fe.read()
            assert rc == 0, f"rank {r} exited {rc}:\n{err[-3000:]}"
            line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
            ranks.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()
    for r in ranks:
        log(f"dist rank {r['pid']} wall_s {r['wall_seconds']:.3f} solve_s "
            f"{r['solve_seconds']:.3f}")
        log(f"dist rank {r['pid']} dist_sync_seconds {r['dist_sync_seconds']:.3f}")
        log(f"dist rank {r['pid']} states_installed {r['states_installed']} "
            f"state_refit_leaves {r['state_refit_leaves']}")
        log("dist rank", r["pid"], json.dumps(r))
    tot = res.setdefault("launches_by_phase", {}).setdefault(
        "dist", dict.fromkeys(kernels.LAUNCHES, 0))
    for r in ranks:
        for key, v in r["launches"].items():
            tot[key] += v
    r0, r1 = ranks
    assert r0["pid"] == 0 and r1["pid"] == 1, ranks
    assert r0["process_count"] == r1["process_count"] == DIST_RANKS, ranks
    gap = max(r0["gap"], r1["gap"])
    assert r0["objective"] == r1["objective"], ranks
    assert abs(r0["objective"] - MULTI_OBJ) <= (gap + MULTI_GAP) * MULTI_OBJ, ranks
    certified = gap <= 1e-4
    for r in ranks:
        # no certified lower bound above the instance's optimum
        assert r["lower_max"] is None or r["lower_max"] <= MULTI_OBJ * (1 + 1e-9), r
        assert certified or r["solve_seconds"] >= DIST_TIME_LIMIT, r
        _assert_launched(r["launches"], ("K1", "K2", "K3", "K4", "K5", "K6"))
    # rank 1 starts empty: its nodes came by migration
    assert r1["nodes_explored_local"] > 0, ranks
    # warm migration: every migrated state fitted the wire spec, and rank 1
    # installed states that came with its nodes
    assert r0["state_refit_leaves"] == r1["state_refit_leaves"] == 0, ranks
    assert r1["states_installed"] > 0, ranks
    assert r0["census_global"] == r1["census_global"], ranks
    for key in ("nodes_explored", "refinement_visits"):
        assert r0["census_global"][key] == r0[f"{key}_local"] + r1[f"{key}_local"], (key, ranks)
    res["dist"] = dict(ranks=ranks, certified=certified, gap=gap)


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
    update_Shor_indices_n_minors=100, gap=1e-2, time_limit=45, batch_size=32,
    sdp_iters=2000, dtype="float32", altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: one visit's budget is not boosted 8x
    sdp_iter_boost_max=1,
)


def phase_config2(res):
    """BASELINE config 2 at full width (rank-1 100x100, 30% observed, seed 1,
    iterative [4]-minor Shor, breadth-first, batch 32), 45 s."""
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
    gap=1e-2, time_limit=60, batch_size=64, sdp_iters=2000, dtype="float32",
    altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: the 8x boosted root visit (16,000 iterations
    # of K1's d=150 chain) does not fit the budget, and the budget is 60 s
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
    smallest_2_eigvec, best-first/depth-first, batch 64), 60 s: the base
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
    call (iterative Shor, batch 32), 60 s, through K1, K2, K3, K7t, K7x,
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
    _bank(res)  # the launches so far count, then 0
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
             disjunctive_cuts_breakpoints=None, time_limit=30, sdp_iter_boost_max=1)
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
    30 s."""
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

    _bank(res)  # the launches so far count, then 0
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


# BASELINE config 4 (benchmarks/bench_configs.py config4): rank-5 250x250,
# 30% observed, seed 1, gamma 80, L = 8, a device batch of 128 nodes, 400
# ADMM iterations per step with one safe-bound call and one separation.
# The one cut: the timed frontier is 2 sub-steps (256 node relaxations)
# after one warm-up step, where bench_configs.py defaults to 1,024 and
# BASELINE asks for 4,096; n, m, k, L and the device batch are as published.
C4 = dict(n=250, m=250, k=5, L=8, B=128, iters=400, substeps=2, gamma=80.0)
# kernel names in a profile: K4 and K5 share one template per path
K4_NAMES = {"k4_kernel<false>": "K4", "k4_kernel<true>": "K5",
            "k4_block_kernel<16, false>": "K4", "k4_block_kernel<16, true>": "K5",
            "k5_kernel": "K5"}


def _config4_frontier(dev, B=None, iters=None):
    """BASELINE config 4's instance and synthetic depth-1 frontier (each
    node one random unit-vector cut, cut_lo = -1, cut_hi = 0.1) on the
    port's API; returns the solver, its arguments and the constants."""
    import numpy as np
    import torch

    from omc_torch.data import generate_matrix_completion_data
    from omc_torch.sdp.admm import init_admm_state, make_admm_solver
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.tree import root_box

    n, m, k, L, gamma = C4["n"], C4["m"], C4["k"], C4["L"], C4["gamma"]
    B = C4["B"] if B is None else B
    iters = C4["iters"] if iters is None else iters
    A, idx = generate_matrix_completion_data(k, n, m, int(0.3 * n * m), seed=1)
    mask = idx.astype(np.float64)
    lo, hi = root_box(n, k)
    rng = np.random.default_rng(0)
    cut_x = rng.standard_normal((B, L, n))
    cut_x /= np.linalg.norm(cut_x, axis=-1, keepdims=True)
    cut_lo = np.tile(np.array([-1.0] * k), (B, L, 1))
    cut_hi = np.tile(np.array([0.1] * k), (B, L, 1))
    cut_mask = np.zeros((B, L))
    cut_mask[:, 0] = 1.0
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,  # noqa: E731
                                  device=dev)
    batch = NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask),
                      f(np.broadcast_to(lo, (B, n, k))), f(np.broadcast_to(hi, (B, n, k))))
    ub_bar = 0.5 * float(np.sum(mask * A * A))
    solve = make_admm_solver(n, m, k, L, gamma, iters=iters, check_every=iters)
    st = init_admm_state(B, n, m, k, L, torch.float32, device=dev,
                         sX=max(1.0, float(np.abs(A).max())), sT=1.0, rho=0.03)
    return solve, (f(A), f(mask), batch, ub_bar, st), dict(A=A, mask=mask, k=k, gamma=gamma,
                                                           ub_bar=ub_bar)


def _bound_split(args, c, ys, reps=1):
    """Safe-bound calls on the duals ``ys`` (warm: the solver has run
    them) under the profiler: CUDA-event ms per call, and its device time
    split into the eigensolver (K4) and the torch terms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from omc_torch.sdp.relax import safe_dual_bound2

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(reps):
            safe_dual_bound2(args[0], args[1], args[2], *ys, c["gamma"], c["k"], c["ub_bar"])
        b.record()
        torch.cuda.synchronize()
    ev_ms = a.elapsed_time(b) / reps
    bb = _device_ms_by_kernel(prof, K4_NAMES, per=reps)
    k4 = bb.get("K4", 0.0)
    return dict(event_ms=ev_ms, k4_device_ms=k4, torch_terms_device_ms=sum(bb.values()) - k4,
                host_and_gaps_ms=max(0.0, ev_ms - sum(bb.values())), kernel_ms=bb)


def phase_config4(res):
    """BASELINE config 4's frontier step on the port (``config4()`` of
    benchmarks/bench_configs.py): rank-5 250x250, a device batch of 128
    nodes, 400 iterations a step with one safe-bound call (K4 at d = 500,
    255 and 250) and one separation (K5 at d = 250, k = 5); one warm-up
    step, then two timed sub-steps.  The 8 slots with the lowest lb_est are
    certified in float64 on the host; the same bound through torch's
    float32 eigh is logged as a reading."""
    import numpy as np
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.sdp import relax
    from omc_torch.sdp.relax import NodeBatch

    dev = torch.device("cuda", 0)
    solve, args, c = _config4_frontier(dev)
    A_d, m_d, batch, ub_bar, st = args
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    st, out = solve(A_d, m_d, batch, ub_bar, st)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    _bank(res)  # the launches so far count, then 0
    t0 = time.time()
    for _ in range(C4["substeps"]):
        st, out = solve(A_d, m_d, batch, ub_bar, st)
        torch.cuda.synchronize()
    frontier_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ys = [out[key] for key in ("y1", "y2", "ya", "yb", "yc")]
    call = _bound_split(args, c, ys)
    k5_ms = cuda_time_ms(lambda: relax.separation_eigpairs(st.U, st.Y), reps=3, warmup=1)

    # the 8 slots with the lowest lb_est, certified in float64 on the host
    lb_dev = out["lb_dev"].double().cpu().numpy()
    lb_est = out["lb_est"].double().cpu().numpy()
    sel = np.argsort(lb_est)[:8]
    sel_t = torch.as_tensor(sel, device=dev)
    sub = NodeBatch(*[x[sel_t] for x in batch.fields()])
    sub_out = {key: out[key][sel_t] for key in ("y1", "y2", "ya", "yb", "yc")}
    t0 = time.time()
    lb_host = relax.host_certified_bound(c["A"], c["mask"], sub, sub_out, c["gamma"], c["k"],
                                         ub_bar)
    certify_s = time.time() - t0
    scale = (lb_est[sel] - lb_dev[sel]) / relax.margin_rel_default(torch.float32)
    # a reading: the same bound of the same slots through torch's float32
    # eigh (cuSOLVER), as the admm phase takes it
    saved = relax.project_psd, relax.eigvalsh
    relax.project_psd, relax.eigvalsh = cones.project_psd_plain, torch.linalg.eigvalsh
    try:
        _, est_t = relax.safe_dual_bound2(A_d, m_d, sub, *sub_out.values(), c["gamma"],
                                          c["k"], ub_bar)
    finally:
        relax.project_psd, relax.eigvalsh = saved
    est_t = est_t.double().cpu().numpy()
    k4_over = np.abs(lb_est[sel] - lb_host) / scale
    torch_over = np.abs(est_t - lb_host) / scale
    iters, nsub = C4["iters"], C4["substeps"]
    row = dict(n=C4["n"], m=C4["m"], k=C4["k"], L=C4["L"], device_batch=C4["B"],
               iters_per_step=iters, frontier=nsub * C4["B"], first_step_s=first_s,
               frontier_s=frontier_s, step_s=frontier_s / nsub,
               node_relaxations_per_s=nsub * C4["B"] / frontier_s,
               ms_per_iter=1e3 * frontier_s / (nsub * iters), bound_call=call,
               k5_ms=k5_ms, certify_s=certify_s, max_memory_allocated=peak,
               lb_est_min=float(lb_est.min()), lb_dev_min=float(lb_dev.min()),
               lb_host_min=float(lb_host.min()), scale_min=float(scale.min()),
               worst_k4_est_vs_host_over_scale=float(k4_over.max()),
               worst_torch_est_vs_host_over_scale=float(torch_over.max()),
               launches=launches)
    log("config4", json.dumps(row))
    assert np.all(np.isfinite(lb_dev)) and np.all(np.isfinite(lb_est)), row
    assert np.all(np.isfinite(lb_host)), row
    # the margin-guarded device bound is sound against the float64
    # certificate, and K4's margin-free estimate sits within 1e-5 scale of
    # it (the admm phase's bar, well inside the 3e-5 margin)
    assert np.all(lb_dev[sel] <= lb_host), row
    assert np.all(k4_over <= 1e-5), row
    _assert_launched(launches, ("K1", "K2", "K3", "K4", "K5"))
    res["config4"] = row


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
    config 2's shape (B=32, n=m=100, M5=1024, L=8) and at the shor cell's
    (B=4, n=m=50, M5=4096), with K7 + K8a's and K8b's device ms per
    iteration, of the rank-k Shor loop at config 3's (B=32, n=m=75, k=2,
    M5=1024, L=8), with K7t's, K7x's and K8d's, 20 iterations each, of the
    McCormick loop at the headline's shape (n=m=50, k=1; B=1 and B=64), 50
    iterations each, with K9a's and K9b's device ms per iteration, and of
    one base-path root visit at B=64 with its two safe-bound calls (K4) and
    its separation (K5)."""
    import torch

    from omc_torch.sdp import admm_shor as S
    from omc_torch.sdp import shor_k as SK

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    names = {"k1_": "K1", "k2_kernel": "K2", "k3_kernel": "K3", "k7_kernel": "K7",
             "k8a_kernel": "K8a", "k8b_kernel": "K8b", "k7t_kernel": "K7t",
             "k7x_kernel": "K7x", "k8c_kernel": "K8c", "k8d_kernel": "K8d"}
    # the Shor loop at config 2's shape, then at the shor cell's frontier
    for key, (B, n, M5) in (("trace", (32, 100, 1024)), ("trace_shor", (4, 50, 4096))):
        c, sc, st = _shor_inputs(B, n, n, 8, M5, gen, dev)
        acc = [torch.zeros_like(x) for x in (st.core.u1, st.core.u2, st.core.ua, st.core.ub,
                                             st.core.uc, st.u5, st.ur, st.ul)]
        ts = (torch.empty_like(st.core.w1), torch.empty_like(st.core.w2),
              torch.empty_like(st.core.w3))
        row = _k2k3_traced(lambda: _trace_loop(
            lambda: S.shor_iteration(c, sc, st, ts, acc, "ns"), names, 20, B=B, n=n, m=n,
            M5=M5, L=8))
        by = row["kernel_ms_per_iter"]
        row["k7_k8a_ms_per_iter"] = by.get("K7", 0.0) + by.get("K8a", 0.0)
        row["k8b_ms_per_iter"] = by.get("K8b", 0.0)
        log(key.replace("_", " "), json.dumps(row))
        res[key] = row
    c, sc, st = _shor_k_inputs(32, 75, 75, 8, 1024, gen, dev)
    acc = [torch.zeros_like(x) for x in (st.core.u1, st.core.u2, st.core.ua, st.core.ub,
                                         st.core.uc, st.u5, st.ux, st.ur, st.ul, st.uwl)]
    ts = (torch.empty_like(st.core.w1), torch.empty_like(st.core.w2),
          torch.empty_like(st.core.w3))
    row = _k2k3_traced(lambda: _trace_loop(
        lambda: SK.shor_k_iteration(c, sc, st, ts, acc, "ns"), names, 20, B=32, n=75, m=75, k=2,
        M5=1024, L=8))
    for name in ("K7t", "K7x", "K8d"):
        row[f"{name.lower()}_ms_per_iter"] = row["kernel_ms_per_iter"].get(name, 0.0)
    log("trace shork", json.dumps(row))
    res["trace_shork"] = row
    # the McCormick loop (K9a -> K9b -> K1) at the headline's shape, with
    # the running means on, at B=1 (the root visit) and B=64
    from omc_torch.sdp import mccormick as MC

    names.update({"k9a_kernel": "K9a", "k9b_kernel": "K9b", **K4_NAMES,
                  "k4s_kernel": "K4s", "k6_kernel": "K6"})
    for B in (1, 64):
        c, st = _mc_inputs(B, 50, 50, 1, gen, dev)
        acc = [torch.zeros_like(x) for x in (st.u1, st.u2, st.umc, st.uorth)]
        ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
        row = _trace_loop(lambda: MC.mc_iteration(c, st, ts, acc, 0.25, "ns"), names, 50,
                          B=B, n=50, m=50, k=1)
        for name in ("K9a", "K9b"):
            row[f"{name.lower()}_ms_per_iter"] = row["kernel_ms_per_iter"].get(name, 0.0)
        log("trace mccormick", json.dumps(row))
        res[f"trace_mccormick_B{B}"] = row
    # the headline's root visit runs at B=1: the K1 chain's latency and the
    # host's launches set its iteration
    head = _k2k3_traced(lambda: _trace_root_visit(names, 1)[0])
    log("trace headline visit", json.dumps(head))
    res["trace_headline_visit"] = head
    visit, call = _trace_visit(names)
    log("trace visit", json.dumps(visit))
    log("trace bound call", json.dumps(call))
    res["trace_visit"], res["trace_bound_call"] = visit, call
    # the same split at BASELINE config 4's shape (B = 128, n = m = 250,
    # k = 5), on the duals of 40 iterations from the config4 phase's start
    solve, args, c = _config4_frontier(dev, iters=40)
    _, out = solve(*args)
    call = _bound_split(args, c, [out[key] for key in ("y1", "y2", "ya", "yb", "yc")], reps=3)
    call.update(B=C4["B"], n=C4["n"], m=C4["m"], k=C4["k"], L=C4["L"])
    log("trace bound call config4", json.dumps(call))
    res["trace_bound_call_config4"] = call


def _k2k3_traced(run, row=None):
    """``row`` (else ``run()``'s) with K2's and K3's device ms per iteration
    and the iteration's ms."""
    def split(r):
        by = r.get("kernel_ms_per_iter") or {
            key: v / r["iters"] for key, v in r["kernel_ms"].items()}
        return dict(K2=by.get("K2", 0.0), K3=by.get("K3", 0.0),
                    iter_ms=r.get("event_ms_per_iter", r.get("ms_per_iter")))

    row = run() if row is None else row
    row["k2k3_ms_per_iter"] = split(row)
    return row


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
    and five safe-bound calls alone, split into the eigensolver (K4) and the
    torch terms."""
    visit, (solve, args, c, out) = _trace_root_visit(names, 64)
    _k2k3_traced(lambda: _trace_root_visit(names, 64)[0], visit)
    call = _bound_split(args, c, [out[key] for key in ("y1", "y2", "ya", "yb", "yc")], reps=5)
    call.update(B=64, n=50, m=50, k=1, L=8)
    return visit, call


KERNELS = (
    # key, rows of the kernels phase (the first is the one timed in the
    # record), name, source, replaces
    ("K1", ("K1",), "K1 sign-schedule PSD projection (B=64, d=100/51/50)",
     "omc_torch/csrc/k1_psd_sign.cu", "omc/ops/polar.py:102"),
    ("K2", ("K2",), "K2 adjoint + Woodbury z-step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k2_zstep.cu", "omc/sdp/admm.py:324"),
    ("K3", ("K3",), "K3 forward map + cone step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k3_cone.cu", "omc/sdp/admm.py:133"),
    ("K7", ("K7fused", "K7"),
     "K7 5x5 minor-slot PSD projection, fused (B=32, M5=1024)",
     "omc_torch/csrc/k7_minor_psd.cu", "omc/ops/polar.py:127"),
    ("K8a", ("K8a",), "K8a Shor adjoint + z-step (B=32, n=m=100, M5=1024)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:178"),
    ("K8b", ("K8b",), "K8b Shor RSOC/link/W>=0 cone step (B=32, n=m=100)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:423"),
    ("K7t", ("K7t",),
     "K7t per-term 5x5 minor slots, rank-k Shor (B=32, M5=1024, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:349"),
    ("K7x", ("K7xfused", "K7x"),
     "K7x (k+1)x(k+1) XWH slots, rank-k Shor (B=32, C=4096, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:373"),
    ("K8c", ("K8c",),
     "K8c rank-k Shor adjoint + z-step (B=32, n=m=75, k=2, M5=1024)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:618"),
    ("K8d", ("K8d",),
     "K8d rank-k Shor RSOC/link/W>=0/Wt>=0 cone step (B=32, n=m=75, k=2)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:754"),
    ("K9s", ("K9s",),
     "K9s McCormick row Grams, Cholesky factors, orthogonality Woodbury (B=64, n=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:385"),
    ("K9a", ("K9a",),
     "K9a McCormick adjoint + z-step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:446"),
    ("K9b", ("K9b",),
     "K9b McCormick forward map + cone step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:477"),
    ("K4", ("K4",),
     "K4 Jacobi eigensolver of the safe bounds, PSD projection (B=64, d=100)",
     "omc_torch/csrc/k4_jacobi.cu", "omc/sdp/relax.py:356"),
    ("K4s", ("K4s",),
     "K4s Jacobi PSD projection of 5x5 minor duals, one thread each (32x4096)",
     "omc_torch/csrc/k4s_jacobi_small.cu", "omc/sdp/admm_shor.py:786"),
    ("K5", ("K5",),
     "K5 separation eigenpairs of UU'-Y, two smallest (B=64, n=50)",
     "omc_torch/csrc/k5_separation.cu", "omc/sdp/admm.py:576"),
    ("K6", ("K6",),
     "K6 altmin masked ridge V-step + U-step (B=4, n=m=50, k=1)",
     "omc_torch/csrc/k6_altmin.cu", "omc/ops/linalg.py:15"),
)


def kernel_record(res):
    """The per-kernel JSON record: launches over every phase that drives the
    port's paths, the largest absolute error against its plain version, the
    kernel, plain and library times and the bound of the row it was timed
    on."""
    rec = []
    for key, rows, name, source, replaces in KERNELS:
        all_rows = [r for rk in rows for r in res["kernels"][rk]]
        r = res["kernels"][rows[0]][0]
        rec.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[key] for c in res["launches_by_phase"].values()),
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
    ap.add_argument("--parent", help="a checkout of an older tree: its K2, K3, K7, K8a, K8b, "
                    "K7t, K7x, K8d, K9s, K9a, K9b, K4s and K5 are timed beside the kernels "
                    "phase's rows")
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
    try:
        import omc_torch  # noqa: F401
    except ImportError as err:
        # the script alone, outside a checkout of the repository
        print(f"chip_smoke: the omc_torch package is not beside this script ({err})",
              file=sys.stderr)
        return 4

    if args.parent:
        _load_parent(args.parent)
    from omc_torch import kernels

    res = {}
    t_all = time.time()
    for p in phases:
        t0 = time.time()
        log(f"== {p}")
        _PHASE["name"] = p
        if p in COUNTED:
            kernels.reset_launches()
        globals()[f"phase_{p}"](res)
        if p in COUNTED:
            _bank(res)
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
