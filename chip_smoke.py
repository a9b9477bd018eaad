#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``omc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, about 9 minutes on an H100

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
               variant; one node of n=m=6000 at rank 10, whose U K3 reads
               from the input) with their device times on every cluster size
               k2k3_plan could take, and K3 in its Halpern mode up to 512
               cuts, with its device time; K8a, K7 (fused and projection mode)
               and K8b at every shape of the Shor k=1 loop (SHOR_SHAPES),
               K7t, K7x (fused) and K8d at k = 2, 3 and 4 and K7x's
               projection mode, K9a and K9b at (B, n=m, k) = (64, 50, 1),
               (64, 75, 2), (1, 50, 1), (16, 50, 1) (MC_SHAPES), with their
               device times, and K9s also at (64, 50, 3); then the float64
               builds of K8a, K7 (fused: its exact Jacobi projection) and
               K8b at every shape of SHOR_SHAPES, K8c, K7t, K7x (slots: their
               exact Jacobi projections) and K8d at config 3's frontier
               (B=32, n=m=75, M5=1024) at k = 2, 3, 4 and K8c, K7x, K8d at
               a root visit (B=1, M5=64), K9s, K9a and K9b at MC_SHAPES and
               (64, 50, 3), each beside the float32 build's
               device ms on the same values, K2's Shor mode at (32,
               100) and (4, 50), K2 and K3 (both modes; the headline's and
               the fixtures' shapes, and one node of n=m=2600 at rank 10,
               U read from the input), K4 (modes 0-2 at B=1 and 64,
               d=100/51/50, B=4 at d=150 and B=32 at d=200 on the planned
               path, the tridiagonal one, the block path at d=150, and two
               clustered batches, each beside every other path that takes
               the shape, that path's time and bars), K4s (5x5), K5
               ((64, 50, 1), (1, 50, 1)) and K6 (n=m=50; B=4, 64; k=1, 2,
               10) against their plain versions in float64 and K7, K7t,
               K7x, K4, K4s and K5 against a float64 LAPACK eigh; the build
               fails if
               ptxas reports a spill in any kernel of either type
4. admm      — one root ADMM solve (B=64, L=8, 2000 iterations) on the
               headline instance; device bound vs float64 host bound (the
               same bound through torch's eigh is logged as a reading)
5. fixtures  — the four certified instances of tests/fixtures/instances.json
6. headline  — rank-1 50x50, 50% observed, gamma 80, gap 1e-4 (cold, warm)
7. multinode — the 30%-observed instance, gap 1e-4
8. dist      — the multi-process frontier: two ranks of
               omc_torch.parallel.worker on the card over gloo, the
               multinode instance at batch 8, 16 s
9. branch    — the 20%-observed instance, 30 s budget
10. shor     — the 30%-observed instance with static Shor minors
               (breadth-first, 15 s): the K7/K8a/K8b path
11. config2  — BASELINE config 2 (rank-1 100x100, iterative Shor, batch 32),
               8 s, with soundness checks
12. config3  — BASELINE config 3 (rank-2 75x75, linear3 cuts,
               smallest_2_eigvec, best-first/depth-first, batch 64), 8 s
13. shork    — the rank-k Shor path (K7t/K7x/K8c/K8d) on config 3's
               instance: a root visit held to omc's bound, then the full
               call (iterative Shor, batch 32), 10 s
14. mccormick — the McCormick path (K9s/K9a/K9b): the standalone relaxation
               entry point on the headline's root and a rank-2 root visit on
               config 3's instance, each held to omc's bound, then the full
               McCormick B&B on the headline instance, 6 s
15. config4  — BASELINE config 4's frontier step (rank-5 250x250, a device
               batch of 128 nodes, 400 iterations, one safe-bound call: K4 at
               d=500, 255 and 250, K5 at d=250): a warm-up step, then one
               timed sub-step, the 8 lowest bounds certified in float64
16. mesh     — the node-batch split (mesh_shape): the multinode instance at
               batch 8 as two shards on streams of the one card, certified;
               then the Shor k=1 solver at config 2's shape (B=32 as two
               shards of 16, K4's block path at d=200 on both streams)
               against the same call on one device
17. pdhg     — omc's PDHG relaxation (sdp_method="pdhg"): a root-only
               visit of 1,000 iterations on the headline instance (K4, K5)
18. halpern  — Halpern-anchored ADMM (sdp_halpern=True, K3's Halpern
               mode): a root-only visit of 4,000 iterations on the headline
19. profile  — the headline with profile_dir: a torch.profiler Chrome trace
               of its first super-steps holding K1's, K2's and K3's kernels
20. float64  — omc's dtype="float64" on the card (the float64 builds of K2,
               K3, K4, K5, K6): api.alternating_minimization and
               api.matrix_completion_SDP_relaxation (250 iterations) at
               their defaults on the headline's root, each against the same
               call on the CPU, and a 4x4 root (K4s); the four fixtures at
               their own gap_target;
               the headline branch-and-bound for 3 s (sound bounds); one
               traced iteration at B=1 in float64 beside float32
21. shor64   — omc's float64 on the Shor k = 1 family (the float64 builds of
               K2's Shor mode, K8a, K3, K4, K7, K8b, K4s, K5): the api's Shor
               relaxation at its defaults on the headline's root (1,024
               minors, 250 iterations) against the same call on the CPU;
               BASELINE config 2 in float64 (visits of 250 iterations, one
               refinement before a growth, 10 s) with sound bounds and a
               Shor growth; the Shor solver at its shape as two shards
               (mesh) against one device; one traced iteration there
22. shork64  — omc's float64 on the rank-k Shor family (the float64 builds
               of K2's Shor mode, K8c, K3, K4, K7t, K7x, K8d, K4s, K5, K6):
               the api's rank-k Shor relaxation at its defaults on config
               3's root (256 minors, 150 iterations) against the same call
               on the CPU; config 3's instance on the shork cell's settings
               in float64 (visits of 250 iterations, one refinement before
               a growth, 10 s) with sound bounds, a Shor growth and no
               float32 build launched; one traced iteration at config 3's
               frontier shape
23. mccormick64 — omc's float64 on the McCormick family (the float64
               builds of K9s, K9a, K9b, K4, K5, K6): the api's McCormick
               relaxation at its defaults on the headline's root (250
               iterations) and at k = 2 on config 3's root (150), each
               against the same call on the CPU; the headline's McCormick
               B&B in float64 (visits of 250 iterations, one refinement
               before a split, 8 s) with sound bounds, omc's objective, more
               than one node and no float32 build launched; one traced
               iteration at B=64 and at B=1
24. widerank — every rank omc runs through altmin and McCormick: K6's wide
               path (k > 10) at (B, n = m, k) = (4, 250, 16), (64, 250, 16),
               (64, 1000, 20), (4, 1000, 32), and in float64 (4, 250, 16),
               (64, 1000, 20) and (4, 1000, 80) in its global workspace; the
               wide K9s, K9a, K9b at (16, 50, 4), (4, 50, 6), (1, 75, 10)
               and K9a, K9b at (1, 2100, 1) (n + m = 4,200) in both dtypes;
               each against its plain version, twice for its bits, with
               CUDA-event and device ms (events around launches queued
               behind a held stream), its bound, the plain version's and
               the library's ms; the wide kernels forced at K6's k = 10 and
               K9's k <= 3, held to their plain versions (timed beside the
               register and unrolled ones on request: widevsunrolled);
               then api.alternating_minimization at rank 20 on a 1000x1000
               instance in both dtypes against the CPU, a rank-12 root
               visit (the device bound no higher than the host
               certificate), the api's McCormick relaxation at k = 4 on
               config 3's instance in both dtypes against the CPU and its
               4 s McCormick B&B (McCormick past n + m = 4096 through an
               entry point: mcflat's driver)
25. shorkwide — rank-k Shor past k = 4 (K7t at any k; the wide K7x, K8c
               and K8d): K8c, K7t, K7x and K8d at config 3's frontier
               (B=32, n=m=75, M5=1024) at k = 5, 8, 12 and config 4's
               root (B=1, n=m=250, M5=1024) at k = 5, in both dtypes,
               each against its plain version, twice for its bits, with
               CUDA-event and device ms (events behind a held stream), its
               bound and the plain version's and the library's ms; the
               wide K7x, K8c and K8d forced at k = 4 beside the register
               kernels; then the api's rank-k Shor relaxation at k = 5 on
               config 3's instance in float64 against the CPU, config 4's
               root at k = 5 in float32 (device bound at most the host
               certificate, at most altmin's objective) and a 4 s B&B at
               k = 5 with iterative Shor (every lower bound at most config
               3's rank-2 incumbent)
26. mcflat   — McCormick past batch x (n + m)^2 >= 2^31: K9a and K9b at
               128 slots of n + m = 4,096 (the unrolled kernels, exactly
               2^31) and 64 of n + m = 5,796 (the wide ones) in both dtypes,
               each against the same kernel on the batch's two halves, bit
               for bit, and on the slot past entry 2^31 - 1 against its
               plain version; K9a and K9b (both dtypes) and K2 and K3
               (float32) at one node of n + m = 46,342 against their plain
               versions on a gathered sub-problem; K1 at 1,024 slots of
               1,449^2 against its halves; the bytes a McCormick solver
               call takes a flat entry in each dtype; then the driver at
               batch_size 1,024 on a 100 x 1,350 instance (n + m = 1,450),
               one root visit on the card (lower bounds at most the
               incumbent)

Every phase that drives the solver asserts that the launch counts of the
kernels its path runs grew (K4 the on-device safe bound, K4s the Shor
bounds' small slots, K5 the separation, K6 altmin).  The record's launches
of a kernel are its launches over all those phases (``COUNTED``).

``--phases device,build,kernels64`` runs the kernels phase's float64 rows
alone; ``--phases device,build,widevsunrolled`` times the wide K6 and K9
kernels beside the register and unrolled ones at the ranks both take.
``--phases device,build,mcwide64`` runs McCormick in float64 past
n + m = 4096: K4's float64 build at d = 4,200 against cuSOLVER's eigh, and
the api's float64 relaxation at n = m = 2100 (K4 on its three PSD blocks).  ``--phases device,build,trace`` runs the optional ``trace`` phase: a
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
builds that tree's K2, K3, K7, K8a, K8b, K7t, K7x, K8d, K9s, K9a, K9b, K4,
K4s, K5 and K6 and times them, with that tree's parameter blocks, beside
every K2/K3 row of the kernels phase up to 512 cuts, every K7/K8a/K8b/K7t/
K7x/K8d/K9s/K9a/K9b/K4s/K5/K6 row and every K4 row of at most 20 ms (the
float32 rows; each on this tree's float32 plan, which is the parent's),
and reports ptxas's registers of its K7, K7t, K7x, K8a, K8b, K8d, K9a and
K9b.

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
import concurrent.futures
import functools
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "admm", "fixtures", "headline",
          "multinode", "dist", "branch", "shor", "config2", "config3", "shork",
          "mccormick", "config4", "mesh", "pdhg", "halpern", "profile", "float64", "shor64",
          "shork64", "mccormick64", "widerank", "shorkwide", "mcflat")
# run only when named in --phases
EXTRA_PHASES = ("trace", "kernels64", "mcwide64", "widevsunrolled")

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
# fp64 outside the tensor cores (the float64 builds' FMAs) and on them (the
# figure given beside the float64 block path's bound, whose tile products
# could go there)
PEAK_FP64_FLOPS = 34e12
PEAK_FP64_TC_FLOPS = 67e12
# products in one sign-schedule projection: 3 per quintic step, 2 per cubic
# step, 1 for (T + sign(T) T) / 2
SIGN_PRODUCTS = 3 * 12 + 2 * 2 + 1


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=10, warmup=2):
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


def _slot_errs(got, ref, groups):
    """The largest relative Frobenius error over the slots ``groups`` (tuples
    of output indices taken together: a slot's projection w and its dual u
    = t - w, whose own norm may be rounding noise where t lies in the cone,
    are held at the scale of the slot), and the largest absolute error."""
    import torch

    cat = lambda xs, g: torch.cat([xs[i].reshape(-1) for i in g])  # noqa: E731
    rel = max(rel_fro(cat(got, g), cat(ref, g)) for g in groups)
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
NO_FRAME = ("k7_kernel", "k7t_kernel", "k7x_kernel", "k8a_kernel", "k8b_kernel", "k8c_kernel",
            "k8d_kernel", "k9s_kernel", "k9a_kernel", "k9b_kernel")


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
    # each source's own nvcc (all run at once: the build takes the longest)
    res["source_seconds"] = info.get("source_seconds", {})
    log("build: seconds by source", json.dumps(res["source_seconds"]))
    report = _ptxas_report(info.get("ptxas", ""))
    res["spills"] = spills = {f: r["spill"] for f, r in report.items() if any(r["spill"])}
    log("build: kernels that spill", json.dumps(spills))
    keep = ("k6_", "k8c_kernel", "k2_kernel", "k3_kernel", "k4", "k5_kernel", "_wide") + NO_FRAME
    res["registers"] = regs = {f: r["registers"] for f, r in report.items()
                               if any(x in f for x in keep)}
    log("build: K2, K3, K4, K4s, K5, K6, K7, K7t, K7x, K8a, K8b, K8c, K8d, K9s, K9a and K9b "
        "registers",
        json.dumps(regs))
    if PARENT:
        res["parent_ptxas"] = {f: r for f, r in PARENT["ptxas"].items()
                               if any(x in f for x in NO_FRAME + ("k4s_kernel",))}
        log("build: the parent's K7, K7t, K7x, K8a, K8b, K8d, K9s, K9a, K9b and K4s",
            json.dumps(res["parent_ptxas"]))
        # every kernel both trees build (its name from the kernel's
        # identifier on, without the file's internal namespace) against the
        # parent's registers
        now, was = _by_kernel(report), _by_kernel(PARENT["ptxas"])
        res["registers_changed"] = changed = {f: [was[f], now[f]] for f in sorted(was)
                                              if f in now and was[f] != now[f]}
        log(f"build: {sum(f in now for f in was)} kernels of both trees, registers changed",
            json.dumps(changed))
    # every instantiation of every kernel, the float64 builds included,
    # keeps its values in registers (no spill); K7's, K7t's, K7x's, K8a's,
    # K8b's, K8c's, K8d's, K9s's, K9a's and K9b's index their small arrays
    # only with constants (no stack frame: a 5x5 triangle in local memory
    # costs K7 ten times its time)
    assert not spills, spills
    frames = {f: r["stack"] for f, r in report.items()
              if any(x in f for x in NO_FRAME) and r["stack"]}
    assert not frames, frames



def _by_kernel(report):
    """{kernel: registers} of a ptxas report, each mangled name cut to
    start at the kernel's identifier (k1... to k9..., a float64 build's
    ``_f64`` kept, whose tail holds the template arguments and the parameter
    types): the same key in two trees built from other paths."""
    import re

    out = {}
    for f, r in report.items():
        m = re.search(r"\d(k\d[0-9a-z_]*?(?:kernel|wide)(?:_f64)?)(?=I|\d|E)", f)
        if m:
            out[f[m.start(1):]] = r["registers"]
    return out


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


def _qr_device(d, dev):
    """Where a spectral batch's random orthogonal factors are formed (drawn
    on the host from the seeded generator either way): on the card from d =
    64 (the host's LAPACK took seconds at config 4's B = 128, d = 500), on
    the host for the small matrices of the minor batches."""
    return dev if d >= 64 else "cpu"


def _spectral_batch(B, d, gen, dev):
    """Symmetric (B, d, d) matrices with eigenvalues +-[0.1, 1] (so every
    |lambda| / ||T||_F >= 1e-4, inside the sign schedule's resolution)."""
    import torch

    Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=torch.float64).to(
        _qr_device(d, dev)))
    lam = torch.empty(B, d, dtype=torch.float64).uniform_(0.1, 1.0, generator=gen)
    sign = torch.where(torch.rand(B, d, generator=gen) < 0.5, -1.0, 1.0).double()
    T = (Q * (lam * sign).to(Q.device)[:, None, :]) @ Q.transpose(-1, -2)
    T = (0.5 * (T + T.transpose(-1, -2))).to(dev)
    return T.float().contiguous(), T


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
        ms_plain = _tm(lambda: psd_epilogue(
            ts, project_psd_ns_merged(ts), w2, u2, a2, rho, beta))
        # the library yardstick: the same chain of products through
        # torch.bmm (cuBLAS), without the epilogue
        ms_lib = _tm(lambda: project_psd_ns_merged(ts))
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
    # 12,289 and B=2); one node of n=m=6000 at rank 10, whose U (240 KB)
    # K3 reads from the input (the plan's k3_u "global")
    k2, k3 = [], []
    for B, n, k, L, shor in ((64, 50, 1, 8, False), (64, 50, 1, 32, False), (1, 50, 1, 8, False),
                             (4, 50, 1, 8, False), (64, 75, 2, 8, False), (64, 75, 2, 32, False),
                             (32, 75, 2, 8, False), (32, 100, 1, 8, True),
                             (C4["B"], C4["n"], C4["k"], C4["L"], False), (2, 1000, 10, 8, False),
                             (4, 50, 1, 512, False), (2, 250, 10, 512, False),
                             (1, 250, 10, 2048, False), (1, 6000, 10, 8, False)):
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
            if "halpern" in r:
                # K3's Halpern mode: the same bars as its normal mode.  At
                # the one node of n = 6000 (K3's U read from the input) the
                # blended trace slot's u4 lies near 0 and float32 cancels:
                # the float32 plain version is itself 1.6e-5 from float64
                # (abs 1.4e-6, on an H100), so there the kernel is held to
                # within 1e-6, or four times the plain version's own
                # distance, of float64 (a wrong read of U is O(1) off)
                h = r["halpern"]
                err = h["rel_err_vs_f64"] if n >= 250 or L > 32 else h["rel_err"]
                bar = 1e-6 if n < 6000 else max(1e-6, 4 * h["plain_vs_f64"])
                checks.append(("K3halpern", h, err <= bar and h["deterministic"]))
                log("K3 halpern", json.dumps(dict(B=B, n=n, k=k, L=L, bar=bar, **h)))
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
    shor_inputs = {}  # the float64 rows below take these inputs in float64
    for B, n, M5 in SHOR_SHAPES:
        shor_inputs[B, n, M5] = _shor_inputs(B, n, n, 8, M5, gen, dev)
        rows = _check_shor_kernels(*shor_inputs[B, n, M5], gen, dev)
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
    # (the float64 rows below take these inputs in float64)
    shork_inputs = {(B, M5, k): _shor_k_inputs(B, 75, 75, 8, M5, gen, dev, k=k)
                    for B, _, M5, k in F64_SHORK_SHAPES}
    rows = _check_shor_k_kernels(*shork_inputs[32, 1024, 2], gen, dev)
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
        r, stepped = _check_k8c(*shork_inputs[32, 1024, k])
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
    for name, fn in (("K7xfused", _check_k7x), ("K8d", _check_k8d)):
        r = fn(*shork_inputs[1, 64, 2], gen, dev)
        log(name, json.dumps(r))
        out[name].append(r)
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
    mc_inputs = {}  # by (B, n, k): the float64 rows take float64 copies
    for B, n, k in MC_SHAPES + K9S_EXTRA_SHAPES:
        mc_inputs[B, n, k] = inputs = _mc_inputs(B, n, n, k, gen, dev)
        if (B, n, k) in K9S_EXTRA_SHAPES:
            rows = {"K9s": _check_k9s(inputs[0], B, n, k, dev)}
        else:
            rows = _check_mc_kernels(*inputs, gen, dev, k9s=B == 64)
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

    # ---- K4, K4s, K5, K6: the eigensolvers and altmin's ridge steps; then
    # the float64 builds ----
    for check in (_check_eig_kernels,
                  lambda g, d: _check_float64_kernels(g, d, shor_inputs, shork_inputs,
                                                      mc_inputs)):
        rows = check(gen, dev)
        for name, rs in rows.items():
            for row in rs:
                log(name, json.dumps(row))
                checks.append((name, row, row["ok"]))
        out.update(rows)
    res["kernels"] = out
    failed = [(name, row) for name, row, ok in checks if not ok]
    assert not failed, failed


def _random_minors(rng, B, n, m, M5):
    """B slots' lists of M5 - 24 distinct random 2x2 minors (i1, i2, j1,
    j2), i1 < i2, j1 < j2: of 4 M5 draws of two rows and two columns a slot,
    the valid ones in the order of their first draw."""
    import numpy as np

    minors = []
    for _ in range(B):
        i = np.sort(rng.choice(n, (4 * M5, 2)), axis=1)
        j = np.sort(rng.choice(m, (4 * M5, 2)), axis=1)
        ok = (i[:, 0] < i[:, 1]) & (j[:, 0] < j[:, 1])
        cand = np.stack([i[:, 0], i[:, 1], j[:, 0], j[:, 1]], 1)[ok]
        key = ((cand[:, 0] * n + cand[:, 1]) * m + cand[:, 2]) * m + cand[:, 3]
        first = np.sort(np.unique(key, return_index=True)[1])[: M5 - 24]
        minors.append(list(map(tuple, cand[first].tolist())))
    return minors


def _shor_inputs(B, n, m, L, M5, gen, dev, dtype=None):
    """Random Shor ADMM state and node batch at a config-2 shape (float32
    on the card, or ``dtype``): ~M5 - 24 random distinct 2x2 minors per
    slot, the RSOC rows on the rest, slot values and duals of unit scale."""
    import numpy as np
    import torch

    from omc_torch.sdp import admm_shor
    from omc_torch.sdp.shor import shor_soc_complement
    from omc_torch.sdp.shor_encode import pack_shor_batch

    dt = dtype or torch.float32
    c, core, acc, ts = _admm_inputs(B, n, m, 1, L, gen, dev, dt)
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    minors = _random_minors(rng, B, n, m, M5)
    socs = [shor_soc_complement(n, m, mm) for mm in minors]
    sbh = pack_shor_batch(n, m, minors, socs, M5, n * m)
    sb = admm_shor.shor_batch_to_device(sbh, dt, device=dev)
    st = admm_shor.init_shor_state(B, n, m, 1, L, M5, n * m, dt, device=dev)
    st = st.replace(core=core)
    core.sS.copy_(core.sX)
    for name in ("W", "v1", "v2", "v3", "w5", "u5", "wr", "ur", "wl", "ul", "wp", "up"):
        t = getattr(st, name)
        v = torch.tensor(rng.standard_normal(tuple(t.shape)) * 0.3, dtype=dt, device=dev)
        if name in ("w5", "u5"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.minor_mask[..., None, None]
        t.copy_(v)
    sc = admm_shor.make_shor_consts(c, sb, core, SHOR_UB)
    return c, sc, st


# the upper bound the Shor kernels' inputs are made for (its clip of X)
SHOR_UB = 40.0
# (B, n = m, M5) of the Shor k=1 loop's K7 and K8a launches: config 2's
# frontier (the record's row), its root visit's first minor bucket, its
# largest bucket after the growths, and the shor cell's root and frontier
SHOR_SHAPES = ((32, 100, 1024), (1, 100, 64), (32, 100, 4096), (1, 50, 4096), (4, 50, 4096))


def _check_shor_kernels(c, sc, st, gen, dev):
    """K8a, K7 (fused) and K8b against their plain versions on the inputs
    (c, sc, st) of ``_shor_inputs`` (float32), or float64 copies of them
    (``_shor64_of``: the float64 builds, rows ``K8a_f64``, ``K7_f64`` and
    ``K8b_f64``), each at the outputs of the step before it: errors, the
    same bits from two launches, CUDA-event and device times (float64: the
    device ms is the row's ``ms``; float32 with ``--parent``, the parent
    tree's kernels on the same inputs), the plans against the kernels'
    exports and the bound (values at the dtype's size, int32 tables at 4
    bytes, the dtype's FMA rate).  K7 projects as the dtype's route does:
    float32 by the sign schedule, its plain version's and its own distance
    to a float64 eigh beside; float64 by K4s's Jacobi, its plain version
    the fused step with K4s's Jacobi mirror (``ops.jacobi.k4s_project_psd``),
    with its distance to a float64 LAPACK projection of the same t5 on the
    host (``err_vs_lapack``, over max|lambda|), the mirror's and K4s's
    float64 build's sweeps on that t5, and the float64 eigh of the batch as
    the library call.  The callers hold the rows to their bars."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.ops.jacobi import k4s_project_psd
    from omc_torch.ops.polar import project_psd_ns_small
    from omc_torch.sdp import admm_shor as S

    lib = kernels.library()
    dt = st.core.X.dtype
    f64 = dt == torch.float64
    sfx, esz, peak = ("_f64", 8, PEAK_FP64_FLOPS) if f64 else ("", 4, PEAK_FP32_FLOPS)
    psd = "eigh" if f64 else "ns"
    tm = _tm
    parent = PARENT and not f64  # the parent tree has float32 builds only
    (B, n, m), M5 = st.core.X.shape, sc.M5
    shape = dict(B=B, n=n, m=m, M5=M5)
    nm, N = n * m, B * M5
    P = sum(t.shape[1] for t in (st.v1, st.v2, st.v3))
    A_ = float(sc.sb.minor_mask.sum())  # active minors over the batch
    out = {}

    def timed(row, fns, plain):
        row["ms"] = cuda_time_ms(fns["kernel"])
        row["plain_ms"] = tm(plain)
        if parent:
            row["parent_ms"] = cuda_time_ms(fns["parent"])
        _device_rows(row, fns)
        if f64:
            row["event_ms"], row["ms"] = row["ms"], row["device_ms"]

    # K8a
    k8a_out = lambda x: (x.core.X, x.core.Th, x.W, x.v1, x.v2, x.v3)  # noqa: E731
    plan8 = S.k8a_plan(B, n, m, M5, dtype=dt)
    sk, s2 = st.clone(), st.clone()
    S.shor_zstep(c, sc, sk)
    S.shor_zstep(c, sc, s2)
    torch.cuda.synchronize()
    rel, ab = _errs(k8a_out(sk), S.shor_zstep_plain(c, sc, st))
    s3 = st.clone()
    fns = {"kernel": lambda: S.shor_zstep(c, sc, s3)}
    if parent:
        fns["parent"] = _parent_k8a(c, sc, st.clone())
    r8 = out["K8a" + sfx] = dict(
        **shape, plan=plan8, plan_matches_kernel=plan8["smem"] == lib.omc_k8a_smem_bytes(
            n, m, plan8["cluster"], plan8["groups"], esz)
        and plan8["grid"][0] == lib.omc_k8a_grid_x(m, P, plan8["cluster"], plan8["groups"]),
        rel_err=rel, max_abs_err=ab, deterministic=_same_bits(k8a_out(sk), k8a_out(s2)),
        library_ms=None)
    timed(r8, fns, lambda: S.shor_zstep_plain(c, sc, st))
    # values per slot: the X and Theta blocks of w1/u1, the RSOC X/W parts,
    # the SOC mask, the link and W >= 0 slots, the counts of X, W and v,
    # the link's g and the four scalars; out X, Theta, W and v; per active
    # minor the 14 entries of w5/u5 the adjoint reads; maskA and mask once.
    # int32: the CSR pointers of X/W (nm + 1) and of v (P + 3) per slot, the
    # 9 entries of each active minor
    vals = (2 * (nm + m * m) + 4 * nm + nm + 2 * m + 2 * nm + 2 * nm + P + m + 4
            + 2 * nm + m * m + P)
    with_bound(r8, esz * (B * vals + A_ * 2 * 14 + 2 * nm) + 4 * (B * (nm + 1 + P + 3) + A_ * 9),
               B * 25 * nm + A_ * 40, peak)

    # K7 fused at K8a's primal
    acc5 = torch.randn(st.u5.shape, generator=gen, dtype=dt).to(dev) * 0.1
    s7, s7b = sk.clone(), sk.clone()
    a7, a7b = acc5.clone(), acc5.clone()
    S.minor_step(c, sc, s7, a7, psd)
    S.minor_step(c, sc, s7b, a7b, psd)
    torch.cuda.synchronize()
    s8, a8 = sk.clone(), acc5.clone()
    fns = {"kernel": lambda: S.minor_step(c, sc, s8, a8, psd)}
    got7 = (s7.w5, s7.u5, a7)
    r7 = out["K7" + ("_f64" if f64 else "fused")] = dict(
        **shape, deterministic=_same_bits(got7, (s7b.w5, s7b.u5, a7b)))
    if f64:
        seen = {}

        def mirror(t):
            seen["t5"] = t
            P_, seen["sweeps"] = k4s_project_psd(t)
            return P_

        r7["rel_err"], r7["max_abs_err"] = _slot_errs(
            got7, S.minor_step_plain(c, sc, sk, acc5, mirror), ((0, 1), (2,)))
        t5 = seen["t5"]
        w64, V64 = torch.linalg.eigh(t5.cpu())
        exact = ((V64 * w64.clamp(min=0.0)[..., None, :]) @ V64.transpose(-1, -2)).to(dev)
        lam = w64.abs().amax(-1).to(dev)
        sw4s = torch.empty(t5.shape[:-2], dtype=torch.int32, device=dev)
        cones.k4s_project_psd(t5, sw4s)
        plan7 = S.k7_plan(N, dt)
        r7.update(
            plan=plan7, plan_matches_kernel=(plan7["threads"] == lib.omc_k7_threads(8)
                                             and plan7["smem"] == lib.omc_k7_smem_bytes(8)),
            err_vs_lapack=float(((s7.w5 - exact).abs().amax((-2, -1))
                                 / lam.clamp(min=1e-300)).max()),
            mirror_sweeps_max=int(seen["sweeps"].max()),
            mirror_sweeps_min=int(seen["sweeps"].min()),
            k4s_sweeps_max=int(sw4s.max()), k4s_sweeps_min=int(sw4s.min()),
            # the library call: the float64 eigh of the B M5 batch (cuSOLVER,
            # chunked below its batch limit)
            library_ms=_tm(lambda: cones.eigh_plain(t5)))
        timed(r7, fns, lambda: S.minor_step_plain(c, sc, sk, acc5,
                                                  lambda t: k4s_project_psd(t)[0]))
        # the FP64 operations of the sweeps the mirror ran on these t5 (10
        # pairs a sweep, ~90 flops a pair's test and rotation of A's rows
        # and V), the rebuild (15 entries of 5 FMAs) and the mixing, u-step
        # and EMA
        flops = float(seen["sweeps"].double().sum()) * 10 * 90 + N * (150 + 100)
    else:
        ref = S.minor_step_plain(c, sc, sk, acc5, project_psd_ns_small)
        w5e, _, _ = S.minor_step_plain(c, sc, sk, acc5,
                                       lambda t: cones.project_psd_plain(t.double()).float())
        r7["rel_err"], r7["max_abs_err"] = _errs(got7, ref)
        r7.update(plain_vs_eigh=rel_fro(ref[0], w5e), kernel_vs_eigh=rel_fro(s7.w5, w5e))
        if parent:
            fns["parent"] = _parent_k7(c, sc, sk.clone(), acc5.clone())
        timed(r7, fns, lambda: S.minor_step_plain(c, sc, sk, acc5, project_psd_ns_small))
        # the symmetric schedule's products (the upper triangle, 15 entries
        # of 5 FMAs) and the mixing, epilogue and EMA
        flops = N * (SIGN_PRODUCTS * 150 + 75)
    xw, nv = _k7_gathered(sc.sb, st, n, m)
    # values: w5/u5/acc read and written and the minor mask, once each the
    # entries of X, W and v that this batch's minors gather, sS and rho;
    # int32: each minor's 4 indices and 5 v entries
    with_bound(r7, esz * (N * (6 * 25 + 1) + 2 * xw + nv + 2 * B) + 4 * 9 * N, flops, peak)

    # K8b at K8a's primal
    acc_r = torch.randn(st.ur.shape, generator=gen, dtype=dt).to(dev) * 0.1
    acc_l = torch.randn(st.ul.shape, generator=gen, dtype=dt).to(dev) * 0.1
    k8b_out = lambda x, ar, al: (x.wr, x.ur, x.wl, x.ul, x.wp, x.up, ar, al)  # noqa: E731
    runs = [(sk.clone(), acc_r.clone(), acc_l.clone()) for _ in range(2)]
    for x, ar, al in runs:
        S.shor_cone_step(c, sc, x, ar, al)
    torch.cuda.synchronize()
    ref = S.shor_cone_step_plain(c, sc, sk, acc_r, acc_l)
    # float64: each slot's (w, u) held together (u = t - w may be all
    # rounding noise where t lies in the cone)
    rel, ab = (_slot_errs(k8b_out(*runs[0]), ref, ((0, 1), (2, 3), (4, 5), (6,), (7,))) if f64
               else _errs(k8b_out(*runs[0]), ref))
    s9, ar9, al9 = sk.clone(), acc_r.clone(), acc_l.clone()
    plan8b = S.k8b_plan(B, n, m, dt)
    fns = {"kernel": lambda: S.shor_cone_step(c, sc, s9, ar9, al9)}
    if parent:
        fns["parent"] = _parent_k8b(c, sc, sk.clone(), acc_r.clone(), acc_l.clone())
    r8b = out["K8b" + sfx] = dict(
        **shape, plan=plan8b,
        plan_matches_kernel=plan8b["grid"] == lib.omc_k8b_grid_x(B, n, m, plan8b["qpc"], esz),
        rel_err=rel, max_abs_err=ab,
        deterministic=_same_bits(k8b_out(*runs[0]), k8b_out(*runs[1])), library_ms=None)
    timed(r8b, fns, lambda: S.shor_cone_step_plain(c, sc, sk, acc_r, acc_l))
    # per slot: X, W, the RSOC slots and their EMA (read and written), the
    # mask, W >= 0, Theta's diagonal and the link rows
    with_bound(r8b, esz * B * (2 * nm + 9 * nm + nm + 2 * nm + m + 3 * m + 9 * nm
                               + 2 * nm + 3 * m + 4),
               B * 40 * nm, peak)
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

    from omc_torch.ops.cones import eigh_plain, project_psd_plain
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
               plain_ms=_tm(lambda: project_psd_ns_small(T)),
               # the library: cuSOLVER's eigh of the batch (chunked, as K4s's)
               library_ms=_tm(lambda: eigh_plain(T)))
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


def _shor_k_inputs(B, n, m, L, M5, gen, dev, k=2, dtype=None, on_device=False):
    """Random rank-k Shor ADMM state and node batch at a config-3 shape
    (float32 on the card, or ``dtype``): ~M5 - 24 random distinct 2x2 minors
    per slot, the RSOC rows on the rest, slot values and duals of unit
    scale (drawn on the card with ``on_device``: the wide rows' states run
    to tens of millions of values)."""
    import numpy as np
    import torch

    from omc_torch.sdp import shor_k as SK
    from omc_torch.sdp.shor import shor_soc_complement

    dt = dtype or torch.float32
    c, core, acc, ts = _admm_inputs(B, n, m, k, L, gen, dev, dt)
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    minors = _random_minors(rng, B, n, m, M5)
    socs = [shor_soc_complement(n, m, mm) for mm in minors]
    sbh = SK.pack_shor_k_batch(n, m, minors, socs, M5, n * m)
    sb = SK.shor_k_batch_to_device(sbh, dt, device=dev)
    st = SK.init_shor_k_state(B, n, m, k, L, M5, n * m, dt, device=dev)
    st = st.replace(core=core)
    core.sS.copy_(core.sX)
    dgen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31))) if on_device else None
    for name in ("Xt", "W", "Wt", "Hh", "v1", "v2", "v3", "w5", "u5", "wx", "ux", "wr", "ur",
                 "wl", "ul", "wwl", "uwl", "wp", "up", "wq", "uq"):
        t = getattr(st, name)
        if on_device:
            v = torch.randn(tuple(t.shape), generator=dgen, dtype=dt, device=dev) * 0.3
        else:
            v = torch.tensor(rng.standard_normal(tuple(t.shape)) * 0.3, dtype=dt, device=dev)
        if name in ("w5", "u5"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.minor_mask[..., None, None, None]
        if name in ("wx", "ux"):
            v = 0.5 * (v + v.transpose(-1, -2)) * sb.coord_mask[..., None, None]
        t.copy_(v)
    sc = SK.make_shor_k_consts(c, sb, core, 40.0, k)
    return c, sc, st


def _k8c_plan_row(B, n, m, k, dtype=None):
    """K8c's tile at this shape (float32, or ``dtype``), its shared memory
    held against the kernel's own count (``omc_k8c_smem_bytes``)."""
    import torch

    from omc_torch import kernels
    from omc_torch.sdp.shor_k import k8c_plan

    dt = dtype or torch.float32
    plan = k8c_plan(B, n, m, k, dt)
    smem = kernels.library().omc_k8c_smem_bytes(n, m, k, plan["cols"], dt.itemsize)
    return dict(plan=plan, smem_matches_kernel=smem == plan["smem_bytes"])


def _check_k8c(c, sc, st):
    """K8c alone at rank k on the inputs (c, sc, st) of ``_shor_k_inputs``:
    within 1e-5 relative of its plain version, the same bits from two
    launches, CUDA-event ms, the plain version's (one warm call) and the
    bound (``_k8c_work``).  Returns the row and (c, sc, the stepped
    state)."""
    import torch

    from omc_torch.sdp import shor_k as SK

    (B, n, m), k, M5 = st.core.X.shape, st.Xt.shape[1], sc.M5
    zs = lambda x: (x.Xt, x.core.X, x.core.Th, x.W, x.Wt, x.Hh, x.v1, x.v2, x.v3)  # noqa: E731
    sk, s2 = st.clone(), st.clone()
    SK.shor_k_zstep(c, sc, sk)
    SK.shor_k_zstep(c, sc, s2)
    torch.cuda.synchronize()
    rel, ab = _errs(zs(sk), SK.shor_k_zstep_plain(c, sc, st))
    s3 = st.clone()
    row = dict(B=B, n=n, m=m, k=k, M5=M5, rel_err=rel, max_abs_err=ab,
               deterministic=_same_bits(zs(sk), zs(s2)), **_k8c_plan_row(B, n, m, k),
               ms=cuda_time_ms(lambda: SK.shor_k_zstep(c, sc, s3)),
               plain_ms=_tm(lambda: SK.shor_k_zstep_plain(c, sc, st)))
    return with_bound(row, *_k8c_work(sc, st)), (c, sc, sk)


def _k8c_work(sc, st):
    """The bytes K8c moves (float32) and the operations it does on the
    inputs (sc, st).  Per slot: X and Theta blocks of w1/u1, Xt_prev, W >=
    0, Wt >= 0, the link rows, the entry/coordinate constants and tables;
    per active minor and term the 14 entries of w5/u5 the adjoint reads, per
    active coordinate k^2 + k entries of wx/ux, per active RSOC row 2 of
    wr/ur; out Xt, X, Theta, W, Wt, H, v."""
    B, n, m = st.core.X.shape
    k, kp, C = st.Xt.shape[1], st.Hh.shape[1], st.Wt.shape[2]
    nm = n * m
    P = sum(t.shape[2] for t in (st.v1, st.v2, st.v3))
    sb = sc.sb
    A_ = float(sb.minor_mask.sum())   # active minors over the batch
    Ca = float(sb.coord_mask.sum())   # active coordinates
    Sa = float(sb.soc_mask.sum())     # active RSOC rows
    rd = (2 * (nm + m * m) + k * nm + 2 * nm + 2 * k * C + 2 * m + 7 * nm + 5 * C + m + P
          + 2 * m + (C + 1) + (P + 3) + 4)
    wr = k * nm + nm + m * m + nm + (k + kp) * C + k * P
    per_act = A_ * k * 2 * 14 + A_ * 9 + Ca * (2 * (k * k + k) + 3) + Sa * 5
    return (4 * (B * (rd + wr) + per_act + 2 * nm),
            B * nm * (12 * k + 25) + 30 * k * A_ + 20 * Ca)


def _check_shor_k_kernels(c, sc, st, gen, dev):
    """K8c, K7t, K7x (slots) and K8d against their plain versions on the
    inputs (c, sc, st) of ``_shor_k_inputs``, each at the outputs of the
    step before it, with times, bounds and a determinism check of each."""
    import torch

    from omc_torch.sdp import shor_k as SK

    (B, n, m), M5 = st.core.X.shape, sc.M5
    k = st.Xt.shape[1]

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
                      plain_ms=_tm(lambda: SK.shor_k_zstep_plain(c, sc, st)))
    with_bound(out["K8c"], *_k8c_work(sc, st))

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

    from omc_torch.ops.cones import eigh_plain, project_psd_plain
    from omc_torch.ops.polar import project_psd_ns, project_psd_ns_small, truncated_matmul
    from omc_torch.sdp import shor_k as SK

    B, n, m, k, kp, C, Ms = SK._shapes(sk)
    accx = torch.randn(sk.ux.shape, generator=gen).to(dev) * 0.1
    runs = [(sk.clone(), accx.clone()) for _ in range(2)]
    for x, a in runs:
        SK.xwh_step(c, sc, x, a, "ns")
    torch.cuda.synchronize()
    plain = lambda proj: SK.xwh_step_plain(c, sc, sk, accx, proj)  # noqa: E731
    seen = {}

    def keep(t):  # the slot batch, for the library call
        seen["t"] = t
        return project_psd_ns_small(t)

    wxp, uxp, axp = plain(keep)
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
               plain_ms=_tm(lambda: plain(project_psd_ns_small)),
               # cuSOLVER's eigh of the same slot batch, chunked
               library_ms=_tm(lambda: eigh_plain(seen["t"])))
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

    from omc_torch.ops.cones import eigh_plain, project_psd_plain
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
               plain_ms=_tm(lambda: project_psd_ns_small(T)),
               # the library: cuSOLVER's eigh of the batch (chunked, as K4s's)
               library_ms=_tm(lambda: eigh_plain(T)))
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
                   B, n, m, C, Ms, plan["ipc"], 4),
               rel_err=rel, max_abs_err=ab,
               deterministic=_same_bits(kd(sd) + tuple(ad), kd(sd2) + tuple(ad2)),
               ms=cuda_time_ms(fns["kernel"]),
               plain_ms=_tm(lambda: SK.shor_k_cone_step_plain(c, sc, sk, *accs)))
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

    from omc_torch.ops.cones import eigh_plain, project_psd_plain
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
    seen = {}

    def keep(t):  # the slot batch, for the library call
        seen["t"] = t
        return project_psd_ns_small(t)

    w5p, u5p, a5p = plain(keep)
    w5e = plain(lambda t: project_psd_plain(t.double()).float())[0]
    w5c = plain(lambda t: project_psd_ns(t, matmul=truncated_matmul(16)))[0]
    (s7, a7), (s7b, a7b) = runs
    rel, ab = _errs((s7.w5, s7.u5, a7), (w5p, u5p, a5p))
    s8, a8 = sk.clone(), acc5.clone()
    fns = {"kernel": lambda: SK.minor_k_step(c, sc, s8, a8, "ns")}
    row = dict(B=B, M5=M5, k=k, rel_err=rel, max_abs_err=ab, plain_vs_eigh=rel_fro(w5p, w5e),
               kernel_vs_eigh=rel_fro(s7.w5, w5e), control_16bit_vs_eigh=rel_fro(w5c, w5e),
               deterministic=_same_bits((s7.w5, s7.u5, a7), (s7b.w5, s7b.u5, a7b)),
               ms=cuda_time_ms(fns["kernel"]), plain_ms=_tm(lambda: plain(
                   project_psd_ns_small)),
               # cuSOLVER's eigh of the same slot batch, chunked
               library_ms=_tm(lambda: eigh_plain(seen["t"])))
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


def _admm_inputs(B, n, m, k, L, gen, dev, dtype=None):
    """Random ADMM state and node batch at a main-path shape (float32 on
    the card, or ``dtype``): slot values and duals of unit scale, ~L/2 real
    cuts.  Past a million entries of X the state's values come from a
    generator on the card (seeded from ``gen``), not from numpy."""
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
    dt = dtype or torch.float32
    f = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    batch = NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask),
                      f(np.broadcast_to(lo, (B, n, k))), f(np.broadcast_to(hi, (B, n, k))))
    st = init_admm_state(B, n, m, k, L, dt, device=dev, sX=2.5, sT=1.7, rho=0.02)
    big = n * m > 10 ** 6
    gdev = torch.Generator(device=dev).manual_seed(int(rng.integers(0, 2**62))) if big else None
    for name in ("w1", "w2", "w3", "w4", "wsoc", "wbox", "wa", "wb", "wc",
                 "u1", "u2", "u3", "u4", "usoc", "ubox", "ua", "ub", "uc",
                 "X", "Y", "Th", "U"):
        t = getattr(st, name)
        if big:
            v = torch.randn(tuple(t.shape), generator=gdev, dtype=dt, device=dev) * 0.3
        else:
            v = f(rng.standard_normal(tuple(t.shape)) * 0.3)
        if v.ndim == 3 and v.shape[-1] == v.shape[-2]:
            v = 0.5 * (v + v.transpose(-1, -2))
        if name in ("wa", "wb", "ua", "ub"):
            v = v * batch.cut_mask[..., None]
        if name in ("wc", "uc"):
            v = v * batch.cut_mask
        t.copy_(v)
        del v
    st.rho.copy_(f(rng.uniform(0.01, 0.1, B)))
    c = make_consts(f(A), f(mask), batch, st, n, m, k, 80.0, 1.9, 1e-3, dt)
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
                  "k9_mccormick", "k4_jacobi", "k4s_jacobi_small", "k5_separation", "k6_altmin")


def _load_parent(src):
    """Build DIR's K2, K3, K7, K8, K7t/K7x, K8c/K8d, K9, K4, K4s, K5 and K6 sources into
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
    def compile_one(name):  # one nvcc, timed
        obj = os.path.join(out, f"{name}.o")
        t = time.time()
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-I", csrc, "-c",
                            os.path.join(csrc, f"{name}.cu"), "-o", obj],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        return obj, r.stderr, time.time() - t

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(PARENT_SOURCES)) as ex:
        jobs = list(ex.map(compile_one, PARENT_SOURCES))
    logs = [err for _, err, _ in jobs]
    seconds = {f"{name}.cu": sec for name, (_, _, sec) in zip(PARENT_SOURCES, jobs)}
    log("parent build: seconds by source", json.dumps(seconds))
    so = os.path.join(out, "libparent_kernels.so")
    subprocess.run([nvcc, "-shared", "-o", so, *[o for o, _, _ in jobs]], check=True)
    lib = ctypes.CDLL(so)
    for fn, st in ((lib.omc_k2_zstep, mod.K2Params), (lib.omc_k3_cone, mod.K3Params),
                   (lib.omc_k7_minor_psd, mod.K7Params),
                   (lib.omc_k8a_shor_zstep, mod.K8aParams),
                   (lib.omc_k8b_shor_cone, mod.K8bParams),
                   (lib.omc_k7t_minor_k, mod.K7tParams), (lib.omc_k7x_xwh, mod.K7xParams),
                   (lib.omc_k8d_shor_k_cone, mod.K8dParams),
                   (lib.omc_k9s_setup, mod.K9sParams), (lib.omc_k9a_zstep, mod.K9aParams),
                   (lib.omc_k9b_cone, mod.K9bParams), (lib.omc_k4_jacobi, mod.K4Params),
                   (lib.omc_k4s_jacobi_small, mod.K4sParams),
                   (lib.omc_k5_separation, mod.K5Params), (lib.omc_k6_vstep, mod.K6Params),
                   (lib.omc_k6_ustep, mod.K6Params)):
        fn.argtypes = [ctypes.POINTER(st), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.omc_k4_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.omc_k4_workspace_floats.restype = ctypes.c_longlong
    # K4's float64 build (the float64 iteration's eigh route)
    lib.omc_k4_jacobi_f64.argtypes = [ctypes.POINTER(mod.K4Params64), ctypes.c_void_p]
    lib.omc_k4_jacobi_f64.restype = ctypes.c_int
    PARENT.update(lib=lib, P2=mod.K2Params, P3=mod.K3Params, P7=mod.K7Params, P4_64=mod.K4Params64,
                  P8a=mod.K8aParams, P8b=mod.K8bParams, P7t=mod.K7tParams, P7x=mod.K7xParams,
                  P8d=mod.K8dParams, P9s=mod.K9sParams, P9a=mod.K9aParams, P9b=mod.K9bParams,
                  P4=mod.K4Params, P4s=mod.K4sParams, P5=mod.K5Params, P6=mod.K6Params,
                  k2k3_plan=plan,
                  src=src, source_seconds=seconds,
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


def _parent_admits(B, n, m, k, L):
    """Whether the parent's ``k2k3_plan`` takes the shape (before K3 read
    U from global memory it refused n k past its shared memory)."""
    try:
        PARENT["k2k3_plan"](B, n, m, k, L)
    except ValueError:
        return False
    return True


def _parent_k2(c, st, shor=False):
    """The parent's K2 on (c, st), writing into st: a launcher with its
    parameter block packed once (``shor``: Xs and Ths null)."""
    v = _parent_values(c, st)
    v.update(_parent_plan_values(c, st, "k2"), G1i=c.G1i)
    if shor:
        v.update(Xs=None, Ths=None)
    return _parent_launch(PARENT["lib"].omc_k2_zstep, _parent_block(PARENT["P2"], v), v["ws"])


def _parent_k3(c, st, ts, acc):
    """The parent's K3 on (c, st), writing into st, ts and acc (its normal
    mode: a parent with K3's Halpern mode gets null anchors)."""
    from omc_torch.kernels import K3_ANCHORS

    v = _parent_values(c, st)
    v.update(_parent_plan_values(c, st, "k3"), t1=ts[0], t2=ts[1], t3=ts[2], acc_a=acc[0],
             acc_b=acc[1], acc_c=acc[2], hal_it=0, **dict.fromkeys(K3_ANCHORS))
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


def _parent_k4(M, mode, path):
    """The parent's K4 on the float32 batch M in ``mode`` on ``path`` (one
    of this tree's K4_PATHS, whose float32 plans are the parent's): a
    launcher with its block, outputs and workspace allocated once."""
    import torch

    lib = PARENT["lib"]
    B, d = M.shape[0], M.shape[-1]
    p = int(path != "cta")
    nwork = lib.omc_k4_workspace_floats(B, d, mode, p)
    f32 = dict(dtype=torch.float32, device=M.device)
    v = dict(M=M, U=None, Y=None, w=torch.empty(B, d, **f32) if mode != 1 else None,
             V=torch.empty(B, d, d, **f32) if mode == 2 else None,
             P=torch.empty(B, d, d, **f32) if mode == 1 else None,
             sweeps=torch.empty(B, dtype=torch.int32, device=M.device),
             work=torch.empty(nwork, **f32) if nwork else None, B=B, d=d, k=0, nout=d,
             mode=mode, path=p)
    return _parent_launch(lib.omc_k4_jacobi, _parent_block(PARENT["P4"], v),
                          *[x for x in v.values() if isinstance(x, torch.Tensor)])


def _parent_k4_f64(M=None, mode=0, nout=None, **kw):
    """The parent's float64 K4 on the float64 batch M in ``mode`` on the
    parent's float64 plan (the CTA path wherever A, and V, fit its shared
    memory, else the block path), launched at once; for K5's form (M None)
    this tree's wrapper (the float64 iteration traced with the parent's
    K4)."""
    import ctypes

    import torch

    from omc_torch.ops import cones

    if M is None or M.dtype != torch.float64 or kw.get("path") is not None:
        return _PARENT_K4_F64_SELF(M, mode, nout, **kw)
    lib = PARENT["lib"]
    M = M.contiguous()
    lead, d = M.shape[:-2], M.shape[-1]
    B = M.numel() // (d * d)
    nout = d if nout is None else nout
    p = int(not cones.k4_cta_fits(d, mode, torch.float64))
    nwork = lib.omc_k4_workspace_floats(B, d, mode, p)
    o = dict(dtype=torch.float64, device=M.device)
    v = dict(M=M, U=None, Y=None, w=torch.empty(*lead, nout, **o) if mode != 1 else None,
             V=torch.empty(*lead, d, nout, **o) if mode == 2 else None,
             P=torch.empty(*lead, d, d, **o) if mode == 1 else None,
             sweeps=torch.empty(lead, dtype=torch.int32, device=M.device),
             work=torch.empty(nwork, **o) if nwork else None, B=B, d=d, k=0, nout=nout,
             mode=mode, path=p)
    prm = _parent_block(PARENT["P4_64"], v)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    assert lib.omc_k4_jacobi_f64(ctypes.byref(prm), stream) == 0, "parent K4 launch failed"
    return v["P"] if mode == 1 else (v["w"] if mode == 0 else (v["w"], v["V"]))


_PARENT_K4_F64_SELF = None


def _parent_k5(U, Y, nout):
    """The parent's K5 on the path this tree's float32 ``k5_plan`` gives (the
    parent's own: its tridiag kernel, or K4's Jacobi template beyond): a
    launcher with its block and outputs (and K4's workspace) allocated
    once."""
    import torch

    from omc_torch.sdp.relax import K5_TRIDIAG, k5_plan

    B, d, k = U.shape
    plan = k5_plan(B, d)
    lib = PARENT["lib"]
    f32 = dict(dtype=torch.float32, device=U.device)
    out = dict(w=torch.empty(B, nout, **f32), V=torch.empty(B, d, nout, **f32))
    if plan["path"] in K5_TRIDIAG:
        v = dict(U=U, Y=Y, **out, iters=torch.empty(B, dtype=torch.int32, device=U.device),
                 B=B, d=d, k=k, nout=nout, path=K5_TRIDIAG.index(plan["path"]))
        return _parent_launch(lib.omc_k5_separation, _parent_block(PARENT["P5"], v),
                              *[x for x in v.values() if isinstance(x, torch.Tensor)])
    path = int(plan["path"] != "cta")
    nwork = lib.omc_k4_workspace_floats(B, d, 2, path)
    v = dict(M=None, U=U, Y=Y, **out, P=None,
             sweeps=torch.empty(B, dtype=torch.int32, device=U.device),
             work=torch.empty(nwork, **f32) if nwork else None, B=B, d=d, k=k, nout=nout, mode=2,
             path=path)
    return _parent_launch(lib.omc_k4_jacobi, _parent_block(PARENT["P4"], v),
                          *[x for x in v.values() if isinstance(x, torch.Tensor)])


def _parent_k6(U, A, mask, gamma, path):
    """The parent's K6 V-step and then its U-step (on its own V) on this
    tree's float32 ``k6_plan`` path (the parent's plans): one launcher of
    both, its blocks, outputs and scratch allocated once."""
    import torch

    from omc_torch.ops.linalg import K6_PATHS, k6_plan

    B, n, k = U.shape
    m = A.shape[1]
    f32 = dict(dtype=torch.float32, device=U.device)
    V = torch.empty(B, k, m, **f32)
    U2 = torch.empty(B, n, k, **f32)
    slots = path == "slots"
    # the slots path reads the U-step's factor as (B, m, k) rows: V's copy
    Vt = torch.empty(B, m, k, **f32) if slots else V
    gram = torch.empty(B, k * (k + 1) // 2, **f32) if slots else None
    runs = []
    for F, out, R, O, fn in ((U, V, n, m, "omc_k6_vstep"), (Vt, U2, m, n, "omc_k6_ustep")):
        pl = k6_plan(B, R, O, k, path)
        v = dict(F=F, A=A, mask=mask, out=out, gram=gram, B=B, n=n, m=m, k=k,
                 path=K6_PATHS.index(path), S=pl["S"], W=pl["W"], rpw=pl["rpw"],
                 inv_gamma=1.0 / gamma, ridge_eps=1e-10)
        runs.append(_parent_launch(getattr(PARENT["lib"], fn), _parent_block(PARENT["P6"], v),
                                   F, out, A, mask, *([gram] if slots else [])))

    def run():
        runs[0]()
        if slots:
            Vt.copy_(V.transpose(-1, -2))
        runs[1]()
    run.keep = (V, U2, Vt)
    return run


def _parent_k4s(T):
    """The parent's K4s on the (N, D, D) batch T into an output of its own."""
    import torch

    out = torch.empty_like(T)
    v = dict(t=T, w=out, sweeps=None, N=T.shape[0], D=T.shape[-1])
    return _parent_launch(PARENT["lib"].omc_k4s_jacobi_small, _parent_block(PARENT["P4s"], v), T,
                          out)


def _k2k3_device_ms(fns, reps=10, medians=("kernel", "parent")):
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
        # the median of ``want`` traces that saw the kernel (at most 5 want
        # tries; the misses come in runs, so a miss waits 0.1 s)
        got = []
        for _ in range(5 * want):
            t = traced(fn)
            if t > 0:
                got.append(t)
            else:
                time.sleep(0.1)
            if len(got) == want:
                break
        assert got, f"no trace of {5 * want} saw a device kernel"
        return statistics.median(got)

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    return {name: timed(fn, 3 if name in medians else 1) for name, fn in fns.items()}


def _k2_work(B, n, m, k, L, shor=False):
    """The values K2 moves and the operations it does.  Per slot: the
    residual blocks it reads (Y, X, Theta of w1/u1; Y, U of w2/u2; w3/u3;
    the SOC, box and cut slots), the cuts, G1 (its triangle: the Cholesky
    factor or the symmetric inverse is enough); out X, Y, Theta, U; mask
    and mask*A once (the shor variant: no X or Theta blocks in or out, no
    masks)."""
    p = 1 + L + L * k
    xt = 0 if shor else 1
    rd = (2 * (n * n + xt * (n * m + m * m)) + 2 * (n * n + n * k) + 2 * n * n + 2 + 4 * k * n
          + 4 * L * k + 2 * L + L * n + 2 * L * k + L + 3 + p * (p + 1) // 2)
    wr = n * n + n * k + xt * (n * m + m * m)
    return (B * (rd + wr) + xt * 2 * n * m,
            B * (8 * L * n * n + 4 * L * n * k + 2 * p * p + 10 * (n * m * xt + n * n)))


def _k3_values(n, m, k, L):
    """The values K3 reads and writes a slot: X, Y, Theta, U and the w/u of
    every slot in; t1-t3 and the non-PSD slots and the three EMAs out (the
    EMAs are read too)."""
    d1, d2 = n + m, n + k
    rd = (n * m + n * n + m * m + n * k + 2 * (d1 * d1 + d2 * d2 + n * n) + 2
          + 2 * k * (1 + n) + 2 * n * k + 4 * L * k + 2 * L + 2 * L * k + L + L * n
          + 3 * L * k + L + 2 * n * k + 3)
    wr = d1 * d1 + d2 * d2 + n * n + 2 + 2 * k * (1 + n) + 2 * n * k + 4 * L * k + 2 * L \
        + 2 * L * k + L
    return rd, wr


def _k3_work(B, n, m, k, L):
    """The values K3 moves and the operations it does (``_k3_values``)."""
    d1, d2 = n + m, n + k
    rd, wr = _k3_values(n, m, k, L)
    return B * (rd + wr), B * (2 * L * n * n + 2 * L * n * k + 5 * (d1 * d1 + d2 * d2 + n * n))


def _check_k2_k3(c, st, acc, ts, shor=False, band=None, sweep=True):
    """K2 and K3 against their plain versions on the same inputs, in float32
    (``rel_err``) and in float64 (``rel_err_vs_f64``, with the float32 plain
    version's own distance ``plain_vs_f64``); the same bits from two
    launches; ``k2k3_plan`` and its shared memory against the kernels'
    exports; CUDA-event times and device times (``device_ms``; on every
    cluster size with ``sweep``, ``device_ms_by_cluster``) and, with
    ``--parent``, the parent tree's kernels' beside them.  ``shor``: K2's variant that writes Y and U
    only; ``band`` forces K2's band (K3 then runs unchecked).  A float64
    state runs the float64 builds (its plain version is then the float64
    one; its bounds at 8 bytes a value and the FP64 rate; no parent)."""
    import dataclasses

    import torch

    from omc_torch import kernels
    from omc_torch.sdp.admm import (
        _REST,
        K2K3_CLUSTERS,
        cone_step,
        cone_step_plain,
        halpern_anchors,
        k2k3_plan,
        zstep,
        zstep_plain,
    )

    lib = kernels.library()
    B, n, m, k, L = c.batch.cut_mask.shape[0], c.n, c.m, c.k, c.L
    dt = st.w1.dtype
    f64 = dt == torch.float64
    e, peak = (8, PEAK_FP64_FLOPS) if f64 else (4, PEAK_FP32_FLOPS)
    plan = k2k3_plan(B, n, m, k, L, band=band, dtype=dt)
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
                  int(plan["k2_xs"] == "smem"), int(ws2), e, int(plan["k2_u"] == "smem"))
              and plan["k2_ws"] == (lib.omc_k2_ws_doubles(n, m, k, L, plan["k2_cluster"], e)
                                    if ws2 else 0),
              rel_err=e2, rel_err_vs_f64=_errs(outs(s_k), ref64)[0],
              plain_vs_f64=_errs(ref, ref64)[0], max_abs_err=a2,
              deterministic=_same_bits(outs(s_k), outs(s_2)),
              ms=cuda_time_ms(k2fn["kernel"]), plain_ms=_tm(lambda: zstep_plain(c, st)))
    vals, ops = _k2_work(B, n, m, k, L, shor)
    with_bound(r2, e * vals, ops, peak)
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
                  int(plan["k3_slots"] == "smem"), int(ws3), e, int(plan["k3_u"] == "smem"))
              and plan["k3_ws"] == (lib.omc_k3_ws_doubles(n, m, k, L, plan["k3_cluster"])
                                    if ws3 else 0),
              rel_err=e3, rel_err_vs_f64=_errs(got, ref64)[0],
              plain_vs_f64=_errs(ref, ref64)[0], max_abs_err=a3,
              deterministic=_same_bits(got, k3out(s3b, ts_b, acc_b)),
              ms=cuda_time_ms(k3fn["kernel"]),
              plain_ms=_tm(lambda: cone_step_plain(c, s_k, acc)))
    d1, d2 = n + m, n + k
    rd, wr = _k3_values(n, m, k, L)
    vals, ops = _k3_work(B, n, m, k, L)
    with_bound(r3, e * vals, ops, peak)

    # K3's Halpern mode (up to 512 cuts): the same step at iteration 3 of a
    # call, every pre-projection slot blended with the anchors w + u of the
    # input state, against its plain version in float32 and float64
    if L <= 512:
        ch = dataclasses.replace(c, anchors=halpern_anchors(st))
        hit = 3
        s5, s5b = s_k.clone(), s_k.clone()
        acc5, acc5b = [a.clone() for a in acc], [a.clone() for a in acc]
        ts5, ts5b = tuple(torch.empty_like(t) for t in ts), tuple(torch.empty_like(t) for t in ts)
        cone_step(ch, s5, ts5, acc5, it=hit)
        cone_step(ch, s5b, ts5b, acc5b, it=hit)
        torch.cuda.synchronize()
        h1, h2, h3, hrest, hacc = cone_step_plain(ch, s_k, acc, hit)
        H1, H2, H3, hrest64, hacc64 = cone_step_plain(_to64(ch), _to64(s_k), _to64(acc), hit)
        goth = k3out(s5, ts5, acc5)
        refh, refh64 = [h1, h2, h3, *hrest, *hacc], [H1, H2, H3, *hrest64, *hacc64]
        eh, ah = _errs(goth, refh)
        s6, acc6 = s_k.clone(), [a.clone() for a in acc]
        k3fn["halpern"] = lambda: cone_step(ch, s6, ts5, acc6, it=hit)
        rh = dict(it=hit, rel_err=eh, rel_err_vs_f64=_errs(goth, refh64)[0],
                  plain_vs_f64=_errs(refh, refh64)[0], max_abs_err=ah,
                  deterministic=_same_bits(goth, k3out(s5b, ts5b, acc5b)),
                  ms=cuda_time_ms(k3fn["halpern"]),
                  plain_ms=_tm(lambda: cone_step_plain(ch, s_k, acc, hit)))
        # the nine anchors read, and three flops an entry of every slot
        anc = d1 * d1 + d2 * d2 + n * n + 1 + k * (1 + n) + n * k + 2 * L * k + L
        with_bound(rh, e * B * (rd + wr + anc),
                   B * (2 * L * n * n + 2 * L * n * k + 5 * (d1 * d1 + d2 * d2 + n * n)
                        + 3 * anc), peak)
        r3["halpern"] = rh

    # the parent's kernels on the same inputs (up to 512 cuts, where the
    # parent's plan takes the shape), and every cluster size
    if PARENT and L <= 512 and not f64 and _parent_admits(B, n, m, k, L):
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
    # device times: the kernel, the parent's, K3's Halpern mode and (sweep)
    # every cluster size
    for r, fns in ((r2, k2fn), (r3, k3fn)):
        dms = _k2k3_device_ms(fns, medians=("kernel", "parent", "halpern"))
        r["device_ms"] = dms.pop("kernel")
        if "parent" in dms:
            r["parent_device_ms"] = dms.pop("parent")
        if "halpern" in dms:
            r["halpern"]["device_ms"] = dms.pop("halpern")
        if dms:
            r["device_ms_by_cluster"] = dms
    return r2, r3


def _mc_inputs(B, n, m, k, gen, dev, on_device=False):
    """Random McCormick ADMM state and node boxes at a main-path shape
    (float32 on the card): boxes inside [-1, 1] of widths 0.05 to 1, slot
    values and duals of unit scale, penalties around omc's 10.
    ``on_device``: the state's values drawn on the card (a seeded CUDA
    generator), for widths where numpy's draw takes seconds."""
    import numpy as np
    import torch

    from omc_torch.sdp.mccormick import MCBatch, init_mc_state, make_mc_consts

    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    rng = np.random.default_rng(seed)
    dgen = torch.Generator(device=dev).manual_seed(seed) if on_device else None
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
        v = (torch.randn(tuple(t.shape), generator=dgen, device=dev) * 0.3 if on_device
             else f(rng.standard_normal(tuple(t.shape)) * 0.3))
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


def _k9s_work(B, n, k):
    """The values K9s moves and the operations it does: boxes in; Mc, Si, Gc
    out.  Per row: the Gram from its structure (each envelope row's at most
    3 x 3 block: 4 q rows of at most 12 operations), its Cholesky, q solves;
    per slot G's sum and Cholesky."""
    q = k * (k + 1) // 2
    kq = k + q
    return (B * n * (2 * k + kq * kq + kq * q) + B * q * q,
            B * n * (48 * q + kq ** 3 // 3 + 2 * q * kq * kq) + B * (n * q * q + q ** 3))


def _k9a_work(B, n, m, k):
    """The values K9a moves and the operations it does: per slot the X,
    Theta, Y blocks of w1/u1, the Y and U blocks of w2/u2, w3/u3, the trace,
    SOC, box, envelope and orthogonality slots, the boxes, Mc, Si, Gc in; X,
    Y, Theta, U, t out; mask and mask*A once."""
    q = k * (k + 1) // 2
    kq = k + q
    rd = (2 * (n * m + m * m + n * n) + 2 * (n * n + n * k) + 2 * n * n + 2 + 2 * k * n
          + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + n * (kq * kq + kq * q) + q * q + 3)
    wr = n * m + n * n + m * m + n * k + n * q
    return (B * (rd + wr) + 2 * n * m,
            B * (10 * (n * m + m * m + n * n) + n * (40 * q + 4 * kq * kq + 2 * kq * q)))


def _k9b_work(B, n, m, k):
    """The values K9b moves and the operations it does: per slot X, Y,
    Theta, U, t and the w/u of every slot in, the boxes and both running
    means (read and written); t1-t3 and the non-PSD slots out."""
    q = k * (k + 1) // 2
    d1, d2 = n + m, n + k
    rd = (n * m + n * n + m * m + n * k + n * q + 2 * (d1 * d1 + d2 * d2 + n * n) + 2
          + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q + 2 * n * k + 4 * n * q + q + 3)
    wr = (d1 * d1 + d2 * d2 + n * n + 2 + 2 * k * (1 + n) + 2 * n * k + 8 * n * q + 2 * q
          + 4 * n * q + q)
    return B * (rd + wr), B * (5 * (d1 * d1 + d2 * d2 + n * n) + 20 * n * q + 10 * n * k)


def _check_mc_kernels(c, st, gen, dev, k9s=True):
    """K9s (with ``k9s``), K9a and K9b against their plain versions on the
    inputs (c, st) of ``_mc_inputs`` (K9b at K9a's outputs), with CUDA-event
    and device times (with ``--parent``, the parent's kernels on the same
    inputs beside), bounds, a determinism check of each and, for K9s, Mc Mc'
    against the row Grams."""
    import torch

    from omc_torch.sdp import mccormick as MC

    from omc_torch import kernels

    B, n, m, k = st.rho.shape[0], c.n, c.m, c.k
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
                            plain_ms=_tm(lambda: MC.mc_zstep_plain(c, st)),
                            library_ms=None)
    if PARENT:
        fns["parent"] = _parent_k9a(c, st.clone())
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    vals, ops = _k9a_work(B, n, m, k)
    with_bound(row, 4 * vals, ops)

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
                                B, n, m, k, plan["qpc"], 4),
                            rel_err=rel, max_abs_err=ab,
                            deterministic=_same_bits(got, got2),
                            ms=cuda_time_ms(fns["kernel"]),
                            plain_ms=_tm(
                                lambda: MC.mc_cone_step_plain(c, sk, acc, beta)),
                            library_ms=None)
    if PARENT:
        fns["parent"] = _parent_k9b(c, sk.clone(), tuple(torch.empty_like(x) for x in ts4),
                                    [a.clone() for a in acc], beta)
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    vals, ops = _k9b_work(B, n, m, k)
    with_bound(row, 4 * vals, ops)
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
               plan_matches_kernel=(plan["threads"] == lib.omc_k9s_threads(n, k, 4)
                                    and plan["smem_bytes"] == lib.omc_k9s_smem_bytes(n, k, 4)),
               rel_err=rel, max_abs_err=ab,
               gram_rel_err=rel_fro(got[0] @ got[0].transpose(-1, -2), gram),
               deterministic=_same_bits(got, got2),
               ms=cuda_time_ms(fns["kernel"]),
               launch_ms=cuda_time_ms(lambda: kernels.launch("K9s", "omc_k9s_setup", prm, dev)),
               plain_ms=_tm(lambda: MC.mc_setup_plain(c.batch, k)),
               # the library chain on the same Grams: cuSOLVER's batched
               # Cholesky, then the triangular solves for S_i
               library_ms=_tm(
                   lambda: torch.cholesky_solve(Etb, torch.linalg.cholesky(gram))))
    if PARENT:
        fns["parent"] = _parent_k9s(c.batch, k)
        row["parent_ms"] = cuda_time_ms(fns["parent"])
    _device_rows(row, fns)
    vals, ops = _k9s_work(B, n, k)
    return with_bound(row, 4 * vals, ops)


def _eig_batch_clustered(B, d, gen, dev):
    """Symmetric (B, d, d) float64 matrices Q diag(lam) Q' on the card whose
    spectra are what ADMM's PSD iterates and rank-k slots give: max|lambda|
    = 1, half the eigenvalues within 1e-13 of 0, an eighth repeated at 0.7
    and an eighth at -0.4, the rest uniform in [-1, 1]."""
    import torch

    f64 = torch.float64
    Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=f64).to(_qr_device(d, dev)))
    lam = torch.empty(B, d, dtype=f64).uniform_(-1.0, 1.0, generator=gen)
    h, e = d // 2, d // 8
    lam[:, :h] = 1e-13 * torch.empty(B, h, dtype=f64).uniform_(-1.0, 1.0, generator=gen)
    lam[:, h:h + e] = 0.7
    lam[:, h + e:h + 2 * e] = -0.4
    lam[:, -1] = 1.0
    T = (Q * lam.to(Q.device)[:, None, :]) @ Q.transpose(-1, -2)
    return (0.5 * (T + T.transpose(-1, -2))).to(dev).contiguous()


def _eig_batch(B, d, gen, dev, dtype=None):
    """Symmetric (B, d, d) float32 matrices Q diag(lam) Q' on the card, lam
    uniform in [-1, 1] with degenerate and negative clusters: for d >= 20
    five eigenvalues equal to 0.5, five within 1e-7 of -0.3 and five zeros;
    for small d a double eigenvalue in every second matrix and zeros in
    every fourth.  Returns the float32 batch and its float64 copy (the
    reference's input is the float32 matrix itself); with ``dtype``
    float64 the batch is formed and kept in float64 (both returns)."""
    import torch

    Q, _ = torch.linalg.qr(torch.randn(B, d, d, generator=gen, dtype=torch.float64).to(
        _qr_device(d, dev)))
    lam = torch.empty(B, d, dtype=torch.float64).uniform_(-1.0, 1.0, generator=gen)
    if d >= 20:
        lam[:, :5] = 0.5
        lam[:, 5:10] = -0.3 + 1e-7 * torch.arange(5)
        lam[:, 10:15] = 0.0
    else:
        lam[1::2, :2] = 0.5
        lam[::4, 2:] = 0.0
    T = (Q * lam.to(Q.device)[:, None, :]) @ Q.transpose(-1, -2)
    T = (0.5 * (T + T.transpose(-1, -2))).to(dtype or torch.float32).to(dev).contiguous()
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

    def tm(fn, warm=False, reps=10):
        """Median of ``reps`` timed calls; of 3 for a call over 20 ms, one
        call for a call over 50 ms (cuSOLVER at B=64 and B=128, whose times
        spread little).  ``warm``: the call has just run, so the first timed
        call counts."""
        probe = cuda_time_ms(fn, reps=1, warmup=0 if warm else 1)
        if probe > 50.0:
            return probe
        return cuda_time_ms(fn, reps=reps) if probe <= 20.0 else cuda_time_ms(fn, reps=3, warmup=0)

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
        # themselves: each is timed once, one call right after the row's
        # reference has run the same routine on T (no warm-up call)
        lib_ms = {}

        def library_ms(name):
            if name not in lib_ms:
                fn = torch.linalg.eigvalsh if name == "eigvalsh" else torch.linalg.eigh
                lib_ms[name] = _tm(lambda: fn(T), warm=True)
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
                # the plain version's call that gives the reference is timed
                # too: past 200 ms (config 4's B = 128) it is the time
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ev0.record()
                plain = cones.project_psd_plain(T)
                ev1.record()
                torch.cuda.synchronize()
                row["max_abs_err"] = float((got - plain).abs().max())
                plain_ms = ev0.elapsed_time(ev1)
                if plain_ms <= 200.0:
                    plain_ms = _tm(lambda: cones.project_psd_plain(T), warm=True)
                library = library_ms("eigh")
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
            if PARENT and row["ms"] <= 20.0:
                # device ms beside the parent's K4 on the same path
                _device_rows(row, {"kernel": lambda: cones.k4_jacobi(T, mode),
                                   "parent": _parent_k4(T, mode, plan["path"])})
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
                   plain_ms=_tm(lambda: cones.project_psd_plain(T), warm=True),
                   # cuSOLVER's batched eigh, chunked below its limit
                   library_ms=_tm(lambda: cones.eigh_plain(T), warm=True))
        plan = cones.k4s_plan(N, D)
        row.update(plan=plan, plan_matches_kernel=plan["ctas"] == lib.omc_k4s_grid_x(N),
                   smem_matches_kernel=plan["smem_bytes"] == lib.omc_k4s_smem_bytes(D, 4))
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
                   plain_ms=_tm(lambda: separation_eigpairs_plain(U32, Y32), warm=True),
                   library_ms=_tm(lambda: torch.linalg.eigh(M32), warm=True),
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
                        K6_PATHS.index(path), k, x["S"], x["W"], x["rpw"], 4)
                    for x in pl.values()))
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
                   plain_ms=_tm(lambda: u_step_unconstrained_plain(
                       v_step_plain(U, A, mask, 80.0), A, mask, 80.0)),
                   # the library's batched solves on the same Grams
                   library_ms=_tm(lambda: (torch.linalg.solve(G, r),
                                                    torch.linalg.solve(H, r2))))
        row["max_abs_err"] = max(e["max_abs_err"] for e in err_by_path.values())
        row["beats_library"] = row["ms"] <= row["library_ms"]
        if PARENT:  # device ms beside the parent's K6 on the same path
            _device_rows(row, {"kernel": lambda: u_step_unconstrained(
                v_step(U, A, mask, 80.0), A, mask, 80.0),
                "parent": _parent_k6(U, A, mask, 80.0, path)})
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


# The float64 builds' rows (B, n, k, L) of K2 and K3: the base path at B=64
# (the row of the record), the headline's root visit (B=1; the api phase's
# call) and the four fixtures' shapes at their batch of 8
def _tm(fn, warm=False):
    """One warm call of a plain version or a library routine (CUDA-event
    ms; the rows' ``plain_ms`` and ``library_ms``, the kernels' own ``ms``
    a median of many).  ``warm``: the same call (or the library routine it
    runs, on the same shapes) has just run, so it takes no warm-up call."""
    return cuda_time_ms(fn, reps=1, warmup=0 if warm else 1)


def _shor64_of(c, sc, st):
    """Float64 copies of ``_shor_inputs``' state and tables, with the
    constants computed from them in float64, as the solver computes them."""
    import torch

    from omc_torch.sdp.admm import make_consts
    from omc_torch.sdp.admm_shor import make_shor_consts

    c, sb, st = _to64(c), _to64(sc.sb), _to64(st)
    c = make_consts(c.maskA, c.mask, c.batch, st.core, c.n, c.m, c.k, c.gamma, c.alpha, c.beta,
                    torch.float64)
    return c, make_shor_consts(c, sb, st.core, SHOR_UB), st


def _mc64_of(c, st):
    """Float64 copies of ``_mc_inputs``' state and boxes, with the constants
    computed from them in float64, as the solver computes them (K9s's
    float64 build factoring the boxes)."""
    import torch

    from omc_torch.sdp.mccormick import make_mc_consts

    st = _to64(st)
    return make_mc_consts(c.maskA.double(), c.mask.double(), _to64(c.batch), st, c.n, c.m, c.k,
                          c.gamma, c.alpha, torch.float64), st


def _f64_device(row, f64_fn, f32_fn):
    """A float64 row's device ms (``ms``, ``device_ms``) beside the float32
    build's on the float32 inputs (``f32_device_ms``), in the same profiler
    call, their ratio, and the CUDA-event ms (``event_ms``)."""
    dms = _k2k3_device_ms({"kernel": f64_fn, "float32": f32_fn}, medians=("kernel", "float32"))
    row["event_ms"] = cuda_time_ms(f64_fn)
    row["ms"] = row["device_ms"] = dms["kernel"]
    row["f32_device_ms"] = dms["float32"]
    row["f64_over_f32"] = dms["kernel"] / dms["float32"]


def _shork64_of(c, sc, st):
    """Float64 copies of ``_shor_k_inputs``' state and tables, with the
    constants computed from them in float64, as the solver computes them."""
    import torch

    from omc_torch.sdp.admm import make_consts
    from omc_torch.sdp.shor_k import make_shor_k_consts

    c, sb, st = _to64(c), _to64(sc.sb), _to64(st)
    c = make_consts(c.maskA, c.mask, c.batch, st.core, c.n, c.m, c.k, c.gamma, c.alpha, c.beta,
                    torch.float64)
    return c, make_shor_k_consts(c, sb, st.core, SHORK_UB, sc.k), st


# the upper bound the rank-k Shor kernels' inputs are made for (its clip of Xt)
SHORK_UB = 40.0
# (B, n = m, M5, k) of the float64 rank-k rows: config 3's frontier at each
# rank (k = 2 is the record's row), and a root visit's B=1 (K7x's and K8d's
# ragged ends; K8c and K7t beside them)
F64_SHORK_SHAPES = ((32, 75, 1024, 2), (32, 75, 1024, 3), (32, 75, 1024, 4), (1, 75, 64, 2))


def _jacobi_pair_flops(D):
    """FP64 operations of one Jacobi rotation of a D x D matrix held in
    registers: its test and angle, A's two rows and columns, V's two
    columns (90 at D = 5, the count of K7's float64 row)."""
    return 26 + 16 * (D - 1)


def _check_shor_k64_kernels(gen, dev, shork_inputs=None):
    """The float64 builds of K8c, K7t, K7x (slot mode) and K8d against their
    plain versions in float64 on float64 copies of ``_shor_k_inputs``'
    float32 inputs (``_shork64_of``; the float32 rows' own, by (B, M5, k),
    where given), each at the outputs of the step before
    it (K8c's), at every shape of ``F64_SHORK_SHAPES``: errors (the slots'
    (w, u) held together), the same bits from two launches, device ms (the
    row's ``ms``; the float32 build's on the float32 inputs beside it,
    ``f32_device_ms``, in the same profiler call), CUDA-event ms, the plain
    version's and the library's ms, the plans against the kernels' exports
    and the bound (values at 8 bytes, int32 tables at 4, FP64 operations at
    34 TFLOP/s, the larger).  K7t and K7x project as omc's float64 route
    does, exactly: their plain versions are the steps with K4s's Jacobi
    mirror (``ops.jacobi.k4s_project_psd``), and each row holds the kernel's
    projection to a float64 LAPACK projection of the same slot values on the
    host (``err_vs_lapack``, over each matrix's max|lambda|), with the
    mirror's and K4s's float64 build's sweeps on them and the float64 eigh
    of the batch (cuSOLVER, chunked) as the library call."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.ops.jacobi import MAX_SWEEPS, k4s_project_psd
    from omc_torch.sdp import shor_k as SK

    f64, i32 = torch.float64, torch.int32
    lib = kernels.library()
    out = {key: [] for key in ("K8c_f64", "K7t_f64", "K7x_f64", "K8d_f64")}
    tm, device = _tm, _f64_device

    def exact_err(w, t):
        """max over the matrices of |w - proj_LAPACK(t)| / max|lambda(t)|"""
        wl, Vl = torch.linalg.eigh(t.cpu())
        ex = ((Vl * wl.clamp(min=0.0)[..., None, :]) @ Vl.transpose(-1, -2)).to(dev)
        lam = wl.abs().amax(-1).to(dev)
        return float(((w.reshape(t.shape) - ex).abs().amax((-2, -1))
                      / lam.clamp(min=1e-300)).max())

    def jacobi_row(row, got, got_b, ref, seen, D, N):
        t = seen["t"]
        sw = torch.empty(t.shape[:-2], dtype=i32, device=dev)
        cones.k4s_project_psd(t, sw)
        row["rel_err"], row["max_abs_err"] = _slot_errs(got, ref, ((0, 1), (2,)))
        row.update(deterministic=_same_bits(got, got_b), err_vs_lapack=exact_err(got[0], t),
                   mirror_sweeps_max=int(seen["sweeps"].max()),
                   mirror_sweeps_min=int(seen["sweeps"].min()),
                   k4s_sweeps_max=int(sw.max()), k4s_sweeps_min=int(sw.min()),
                   library_ms=tm(lambda: cones.eigh_plain(t)))
        row["ok"] = (row["rel_err"] <= 1e-10 and row["err_vs_lapack"] <= 1e-11
                     and row["deterministic"] and row["plan_matches_kernel"]
                     and row["mirror_sweeps_max"] <= MAX_SWEEPS
                     and row["k4s_sweeps_max"] <= MAX_SWEEPS)
        # the FP64 operations of the sweeps the mirror ran on these values,
        # the rebuild V max(w, 0) V' (D (D + 1) / 2 entries of D FMAs) and
        # the mixing, u-step and EMA
        return (float(seen["sweeps"].double().sum()) * D * (D - 1) / 2 * _jacobi_pair_flops(D)
                + N * (D * D * (D + 1) + 10 * D * D))

    def mirror(seen):
        def proj(t):
            seen["t"] = t
            P, seen["sweeps"] = k4s_project_psd(t)
            return P
        return proj

    for B, n, M5, k in F64_SHORK_SHAPES:
        c32, sc32, st32 = ((shork_inputs or {}).get((B, M5, k))
                           or _shor_k_inputs(B, n, n, 8, M5, gen, dev, k=k))
        c, sc, st = _shork64_of(c32, sc32, st32)
        m, nm = n, n * n
        _, _, _, _, kp, C, Ms = SK._shapes(st)
        P = sum(t.shape[2] for t in (st.v1, st.v2, st.v3))
        sb = sc.sb
        A_ = float(sb.minor_mask.sum())   # active minors over the batch
        Ca = float(sb.coord_mask.sum())   # active coordinates
        Sa = float(sb.soc_mask.sum())     # active RSOC rows
        shape = dict(B=B, n=n, m=m, k=k, M5=M5, C=C, Ms=Ms)

        # K8c
        zs = lambda x: (x.Xt, x.core.X, x.core.Th, x.W, x.Wt, x.Hh, x.v1, x.v2, x.v3)  # noqa: E731
        sk, s2 = st.clone(), st.clone()
        SK.shor_k_zstep(c, sc, sk)
        SK.shor_k_zstep(c, sc, s2)
        torch.cuda.synchronize()
        rel, ab = _errs(zs(sk), SK.shor_k_zstep_plain(c, sc, st))
        r8c = dict(**shape, rel_err=rel, max_abs_err=ab, deterministic=_same_bits(zs(sk), zs(s2)),
                   **_k8c_plan_row(B, n, m, k, f64), library_ms=None)
        r8c["plan_matches_kernel"] = r8c.pop("smem_matches_kernel")
        s3, s3f = st.clone(), st32.clone()
        device(r8c, lambda: SK.shor_k_zstep(c, sc, s3), lambda: SK.shor_k_zstep(c32, sc32, s3f))
        r8c["plain_ms"] = tm(lambda: SK.shor_k_zstep_plain(c, sc, st))
        r8c["ok"] = r8c["rel_err"] <= 1e-10 and r8c["deterministic"] and r8c["plan_matches_kernel"]
        # values per slot: the X and Theta blocks of w1/u1, Xt_prev, W >= 0,
        # Wt >= 0, the link and W-link rows, the entry and coordinate
        # constants, Theta's Schur complement, v's diagonal, the coordinate
        # mask, the four scalars; out Xt, X, Theta, W, Wt, H, v; per active
        # minor and term the 14 entries of w5/u5 the adjoint reads, per
        # active coordinate the k^2 + k entries of wx/ux, per active RSOC row
        # two of wr/ur and its mask; maskA and mask once.  int32: the entry
        # tables (fm_ptr, flat_coord, flat_soc) and v's pointers per slot,
        # the 9 list entries of each active minor
        rd = (2 * (nm + m * m) + k * nm + 2 * nm + 2 * k * C + 2 * m + 2 * C + 3 * nm + 4 * C
              + m + P + C + 4)
        wr = k * nm + nm + m * m + nm + (k + kp) * C + k * P
        with_bound(r8c, 8 * (B * (rd + wr) + A_ * k * 28 + Ca * 2 * (k * k + k) + Sa * 5 + 2 * nm)
                   + 4 * (B * (3 * nm + 1 + P + 3) + 9 * A_),
                   B * nm * (12 * k + 25) + 30 * k * A_ + 20 * Ca, PEAK_FP64_FLOPS)
        out["K8c_f64"].append(r8c)
        # the float32 build's stepped state, for its timings beside
        sk32 = st32.clone()
        SK.shor_k_zstep(c32, sc32, sk32)

        # K7t at K8c's primal
        if M5 >= 1024:
            N = B * M5 * k
            acc5 = torch.randn(sk.u5.shape, generator=gen, dtype=f64).to(dev) * 0.1
            runs = [(sk.clone(), acc5.clone()) for _ in range(2)]
            for x, a in runs:
                SK.minor_k_step(c, sc, x, a, "eigh")
            torch.cuda.synchronize()
            seen = {}
            ref = SK.minor_k_step_plain(c, sc, sk, acc5, mirror(seen))
            plan = SK.k7t_plan(N, f64)
            r7 = dict(**shape, plan=plan,
                      plan_matches_kernel=(plan["threads"] == lib.omc_k7t_threads(8)
                                           and plan["smem"] == lib.omc_k7t_smem_bytes(8)))
            flops = jacobi_row(r7, (runs[0][0].w5, runs[0][0].u5, runs[0][1]),
                               (runs[1][0].w5, runs[1][0].u5, runs[1][1]), ref, seen, 5, N)
            s8, a8 = sk.clone(), acc5.clone()
            s8f, a8f = sk32.clone(), acc5.float()
            device(r7, lambda: SK.minor_k_step(c, sc, s8, a8, "eigh"),
                   lambda: SK.minor_k_step(c32, sc32, s8f, a8f, "ns"))
            r7["plain_ms"] = tm(lambda: SK.minor_k_step_plain(
                c, sc, sk, acc5, lambda t: k4s_project_psd(t)[0]))
            # values: w5/u5/acc read and written, the minor mask, the gathered
            # entries of Xt, Wt and v, sS and rho; int32: the 16-int records
            with_bound(r7, 8 * (N * 6 * 25 + B * M5 + _k7t_gathered(sc, nm) + 2 * B)
                       + 4 * 16 * B * M5, flops, PEAK_FP64_FLOPS)
            out["K7t_f64"].append(r7)

        # K7x (slot mode) at K8c's primal
        D, N = k + 1, B * C
        accx = torch.randn(sk.ux.shape, generator=gen, dtype=f64).to(dev) * 0.1
        runs = [(sk.clone(), accx.clone()) for _ in range(2)]
        for x, a in runs:
            SK.xwh_step(c, sc, x, a, "eigh")
        torch.cuda.synchronize()
        seen = {}
        ref = SK.xwh_step_plain(c, sc, sk, accx, mirror(seen))
        plan = SK.k7x_plan(N, D, f64)
        rx = dict(**shape, D=D, plan=plan,
                  plan_matches_kernel=(plan["threads"] == lib.omc_k7x_threads(8, D)
                                       and plan["smem"] == lib.omc_k7x_smem_bytes(8, D)))
        flops = jacobi_row(rx, (runs[0][0].wx, runs[0][0].ux, runs[0][1]),
                           (runs[1][0].wx, runs[1][0].ux, runs[1][1]), ref, seen, D, N)
        s9, a9 = sk.clone(), accx.clone()
        s9f, a9f = sk32.clone(), accx.float()
        device(rx, lambda: SK.xwh_step(c, sc, s9, a9, "eigh"),
               lambda: SK.xwh_step(c32, sc32, s9f, a9f, "ns"))
        rx["plain_ms"] = tm(lambda: SK.xwh_step_plain(c, sc, sk, accx,
                                                      lambda t: k4s_project_psd(t)[0]))
        # values: wx/ux/acc read and written, the coordinate mask, the
        # gathered entries of Xt, Wt and H, sS and rho; int32: coord_flat
        fl = sb.coord_flat.long()
        gathered = k * torch.unique(torch.arange(B, device=fl.device)[:, None] * nm + fl).numel()
        with_bound(rx, 8 * (N * (6 * D * D + 1) + gathered + B * (k + kp) * C + 2 * B) + 4 * N,
                   flops, PEAK_FP64_FLOPS)
        out["K7x_f64"].append(rx)

        # K8d at K8c's primal
        accs = [torch.randn(x.shape, generator=gen, dtype=f64).to(dev) * 0.1
                for x in (sk.ur, sk.ul, sk.uwl)]
        kd = lambda x: (x.wr, x.ur, x.wl, x.ul, x.wwl, x.uwl, x.wp, x.up, x.wq, x.uq)  # noqa: E731
        runs = [(sk.clone(), [a.clone() for a in accs]) for _ in range(2)]
        for x, a in runs:
            SK.shor_k_cone_step(c, sc, x, *a)
        torch.cuda.synchronize()
        ref = SK.shor_k_cone_step_plain(c, sc, sk, *accs)
        (sd, ad), (sd2, ad2) = runs
        # each slot's (w, u) held together (u = t - w may be all rounding
        # noise where t lies in the cone), the EMAs on their own
        rel, ab = _slot_errs(kd(sd) + tuple(ad), ref,
                             ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10,), (11,), (12,)))
        plan = SK.k8d_plan(B, n, m, k, C, Ms, f64)
        rd8 = dict(**shape, plan=plan,
                   plan_matches_kernel=plan["grid"] == lib.omc_k8d_grid_x(
                       B, n, m, C, Ms, plan["ipc"], 8),
                   rel_err=rel, max_abs_err=ab,
                   deterministic=_same_bits(kd(sd) + tuple(ad), kd(sd2) + tuple(ad2)),
                   library_ms=None)
        s10, a10 = sk.clone(), [a.clone() for a in accs]
        s10f, a10f = sk32.clone(), [a.float() for a in accs]
        device(rd8, lambda: SK.shor_k_cone_step(c, sc, s10, *a10),
               lambda: SK.shor_k_cone_step(c32, sc32, s10f, *a10f))
        rd8["plain_ms"] = tm(lambda: SK.shor_k_cone_step_plain(c, sc, sk, *accs))
        rd8["ok"] = rd8["rel_err"] <= 1e-10 and rd8["deterministic"] and rd8["plan_matches_kernel"]
        # values per slot: X, W, Theta's diagonal, Wt, H, the RSOC rows with
        # their EMA and mask, the link rows with their EMAs, W >= 0, Wt >= 0,
        # the coordinate mask, the four scalars; out the same slots and
        # EMAs; int32: soc_flat and coord_flat
        rdv = (2 * nm + m + (k + kp) * C + 9 * Ms + Ms + 2 * m + 2 * C + 2 * nm + 2 * k * C
               + 2 * C + C + 4)
        wrv = 9 * Ms + 3 * m + 3 * C + 2 * nm + 2 * k * C
        with_bound(rd8, 8 * B * (rdv + wrv) + 4 * B * (Ms + C),
                   B * (40 * Ms + 6 * nm + (k + kp + 6) * C + 5 * k * C), PEAK_FP64_FLOPS)
        out["K8d_f64"].append(rd8)
        del c32, sc32, st32, c, sc, st, sk, s2, sk32
    return out


# (B, n = m, k) of the float64 McCormick rows: MC_SHAPES and (64, 50, 3),
# where a slot thread holds the most values (k + q = 9)
F64_MC_SHAPES = MC_SHAPES + K9S_EXTRA_SHAPES


def _check_mc64_kernels(gen, dev, mc_inputs=None):
    """The float64 builds of K9s, K9a and K9b against their plain versions
    in float64 on float64 copies of ``_mc_inputs``' float32 inputs
    (``_mc64_of``; the float32 rows' own, by (B, n, k), where given), K9b at
    K9a's outputs, at every shape of ``F64_MC_SHAPES``: errors (K9s's
    factors also against the row Grams, Mc Mc'), the same bits from two
    launches, device ms (the row's ``ms``) beside the float32 build's on
    the float32 inputs in the same profiler call (``f32_device_ms``),
    CUDA-event ms, the plain version's and (K9s) the library chain's ms, the
    plans against the kernels' exports and the bound (values at 8 bytes,
    FP64 operations at 34 TFLOP/s, the larger).  Bars: 1e-10 relative of
    the plain version, Mc Mc' within 1e-12 of the Grams."""
    import torch

    from omc_torch import kernels
    from omc_torch.sdp import mccormick as MC

    f64 = torch.float64
    lib = kernels.library()
    out = {key: [] for key in ("K9s_f64", "K9a_f64", "K9b_f64")}
    for B, n, k in F64_MC_SHAPES:
        c32, st32 = (mc_inputs or {}).get((B, n, k)) or _mc_inputs(B, n, n, k, gen, dev)
        c, st = _mc64_of(c32, st32)
        m, q = n, k * (k + 1) // 2
        shape = dict(B=B, n=n, m=m, k=k)

        # K9s, and the library chain on the same Grams: cuSOLVER's batched
        # Cholesky, then the triangular solves for S_i
        got, got2 = MC.mc_setup(c.batch, k), MC.mc_setup(c.batch, k)
        torch.cuda.synchronize()
        gram = MC.mc_gram_plain(c.batch, k)
        rel, ab = _errs(got, MC.mc_setup_plain(c.batch, k))
        Et = torch.zeros((k + q, q), dtype=f64, device=dev)
        Et[k:] = torch.eye(q, dtype=f64, device=dev)
        Etb = Et.expand(B, n, k + q, q).contiguous()
        plan = MC.k9s_plan(B, n, k, f64)
        rs = dict(**shape, plan=plan,
                  plan_matches_kernel=(plan["threads"] == lib.omc_k9s_threads(n, k, 8)
                                       and plan["smem_bytes"] == lib.omc_k9s_smem_bytes(n, k, 8)),
                  rel_err=rel, max_abs_err=ab,
                  gram_rel_err=rel_fro(got[0] @ got[0].transpose(-1, -2), gram),
                  deterministic=_same_bits(got, got2),
                  plain_ms=_tm(lambda: MC.mc_setup_plain(c.batch, k)),
                  library_ms=_tm(lambda: torch.cholesky_solve(Etb, torch.linalg.cholesky(gram))))
        _f64_device(rs, lambda: MC.mc_setup(c.batch, k), lambda: MC.mc_setup(c32.batch, k))
        rs["ok"] = (rs["rel_err"] <= 1e-10 and rs["gram_rel_err"] <= 1e-12
                    and rs["deterministic"] and rs["plan_matches_kernel"])
        vals, ops = _k9s_work(B, n, k)
        with_bound(rs, 8 * vals, ops, PEAK_FP64_FLOPS)
        out["K9s_f64"].append(rs)

        # K9a
        zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
        sk, s2 = st.clone(), st.clone()
        MC.mc_zstep(c, sk)
        MC.mc_zstep(c, s2)
        torch.cuda.synchronize()
        rel, ab = _errs(zs(sk), MC.mc_zstep_plain(c, st))
        plan = MC.k9_plan(B, n, m, k, f64)
        ra = dict(**shape, plan=plan,
                  plan_matches_kernel=plan["k9a_grid"] == lib.omc_k9a_grid_x(B, n, m),
                  rel_err=rel, max_abs_err=ab, deterministic=_same_bits(zs(sk), zs(s2)),
                  plain_ms=_tm(lambda: MC.mc_zstep_plain(c, st)), library_ms=None)
        s3, s3f = st.clone(), st32.clone()
        _f64_device(ra, lambda: MC.mc_zstep(c, s3), lambda: MC.mc_zstep(c32, s3f))
        ra["ok"] = ra["rel_err"] <= 1e-10 and ra["deterministic"] and ra["plan_matches_kernel"]
        vals, ops = _k9a_work(B, n, m, k)
        with_bound(ra, 8 * vals, ops, PEAK_FP64_FLOPS)
        out["K9a_f64"].append(ra)

        # K9b at K9a's outputs, with the running means (the float32 build at
        # its own K9a's outputs beside)
        sk32 = st32.clone()
        MC.mc_zstep(c32, sk32)
        acc = [torch.randn(x.shape, generator=gen, dtype=f64).to(dev) * 0.1
               for x in (st.umc, st.uorth)]

        def k9b(c_, s_, acc_):
            """A launcher of K9b on copies of s_ and acc_, and its outputs."""
            sb, a = s_.clone(), [x.clone() for x in acc_]
            ts = tuple(torch.empty_like(x) for x in (sb.w1, sb.w2, sb.w3))
            return (lambda: MC.mc_cone_step(c_, sb, ts, a, 0.25),
                    lambda: ts + tuple(getattr(sb, name) for name in MC._REST) + tuple(a))

        (run1, out1), (run2, out2) = k9b(c, sk, acc), k9b(c, sk, acc)
        run1()
        run2()
        torch.cuda.synchronize()
        t1, t2, t3, rest, acc_p = MC.mc_cone_step_plain(c, sk, acc, 0.25)
        rel, ab = _errs(out1(), (t1, t2, t3) + tuple(rest) + tuple(acc_p))
        rb = dict(**shape, plan=plan,
                  plan_matches_kernel=plan["k9b_grid"] == lib.omc_k9b_grid_x(
                      B, n, m, k, plan["qpc"], 8),
                  rel_err=rel, max_abs_err=ab, deterministic=_same_bits(out1(), out2()),
                  plain_ms=_tm(lambda: MC.mc_cone_step_plain(c, sk, acc, 0.25)),
                  library_ms=None)
        _f64_device(rb, k9b(c, sk, acc)[0], k9b(c32, sk32, [a.float() for a in acc])[0])
        rb["ok"] = rb["rel_err"] <= 1e-10 and rb["deterministic"] and rb["plan_matches_kernel"]
        vals, ops = _k9b_work(B, n, m, k)
        with_bound(rb, 8 * vals, ops, PEAK_FP64_FLOPS)
        out["K9b_f64"].append(rb)
        del c32, st32, c, st, sk, s2, s3, s3f, sk32
    return out


# (the last: one node of n=m=2600 at rank 10, whose U K3 reads from the
# input in float64, k2k3_plan's k3_u "global")
F64_ADMM_SHAPES = ((64, 50, 1, 8), (1, 50, 1, 8), (8, 12, 1, 8), (8, 16, 1, 8), (8, 20, 1, 8),
                   (8, 10, 2, 8), (1, 2600, 10, 8))
# K4's float64 rows (B, d, modes, path, spectrum): the three blocks of the
# headline's eigh route at the root visit (B=1) and at B=64 on the planned
# path (the tridiagonal one), config 3's d = 150 on the block path (above
# the CTA path's float64 limits with vectors) and on the planned path,
# config 2's d = 200 at its float64 batch (B=32), and two batches of
# clustered spectra (_eig_batch_clustered) at B=1, d=100 and B=4, d=150,
# and below the tridiagonal path's lower edge (K4_TRI_MIN_D): the Shor
# bounds' XWH slots (k + 1 = 9 and 17, B x C = 32 x 4096 matrices, the
# projection), d = 17 at batches between, and d = 9, 17, 24 at B = 1 and
# 64; each beside every other path that takes the shape (past B = 4096 the
# CTA and tridiagonal paths: the block path's time is not taken there)
F64_K4_SHAPES = ((64, 100, (1, 0, 2), None, "mixed"), (1, 100, (1, 0, 2), None, "mixed"),
                 (64, 51, (1, 0, 2), None, "mixed"), (1, 51, (1, 0, 2), None, "mixed"),
                 (64, 50, (1, 0, 2), None, "mixed"), (1, 50, (1, 0, 2), None, "mixed"),
                 (4, 150, (1, 0, 2), "block16", "mixed"), (64, 150, (1,), "block16", "mixed"),
                 (4, 150, (1, 0, 2), None, "mixed"), (32, 200, (1, 0, 2), None, "mixed"),
                 (1, 100, (1, 0, 2), None, "clustered"), (4, 150, (1, 0, 2), None, "clustered"),
                 (131072, 9, (1,), None, "mixed"), (131072, 17, (1,), None, "mixed"),
                 (8192, 17, (1,), None, "mixed"), (1024, 17, (1,), None, "mixed"),
                 (1, 9, (1, 0, 2), None, "mixed"), (64, 9, (1, 0, 2), None, "mixed"),
                 (1, 17, (1, 0, 2), None, "mixed"), (64, 17, (1, 0, 2), None, "mixed"),
                 (64, 24, (1, 0, 2), None, "mixed"))
F64_K6_SHAPES = ((50, 4, 1), (50, 64, 1), (50, 4, 2), (50, 64, 2), (50, 4, 10))


def _check_float64_kernels(gen, dev, shor_inputs=None, shork_inputs=None, mc_inputs=None):
    """The float64 builds of K8a, K7 and K8b (``_check_shor_kernels``, on
    float64 copies of ``shor_inputs``, the float32 rows' inputs by shape,
    where given: ``_shor64_of``), K8c, K7t, K7x and K8d
    (``_check_shor_k64_kernels``), K9s, K9a and K9b
    (``_check_mc64_kernels``), K2 (also its Shor mode), K3 (both modes),
    K4 (modes 0, 1, 2 on both paths), K4s, K5 and K6 against their plain
    versions in float64 on the same inputs, with times, bounds (8 bytes a
    value, the FP64 rate) and the library call.  Bars: K2, K3, K6, K8a, K7
    and K8b within 1e-10 relative Frobenius of the plain version (float64
    sums in another order, K8b's cone projections through rsqrt; K7's and
    K8b's slots (w, u) taken together; the same bits from two launches; the
    plans the kernels' own); K7 also within 1e-11 max|lambda| of a float64
    LAPACK projection of the same t5, its mirror's and K4s's sweeps within
    the cap; K4, K4s and K5 within 1e-11 max|lambda| of a float64
    LAPACK eigh of the same input on the host (eigenvalues; K4's
    projection within 1e-11 relative Frobenius, its and K5's vectors with
    a residual and orthogonality within 1e-11 sqrt(d) and, K5's, within
    1e-10 of LAPACK's up to sign: a vector's error grows with ||A|| over
    its gap), no sweep or iteration cap, their plans the kernels' own."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.ops.jacobi import MAX_SWEEPS
    from omc_torch.ops.linalg import (
        K6_PATHS,
        k6_plan,
        u_step_unconstrained,
        u_step_unconstrained_plain,
        v_step,
        v_step_plain,
    )
    from omc_torch.ops.tridiag import MAX_ITERS as K5_MAX_ITERS
    from omc_torch.sdp.relax import _k5_launch, k5_plan, separation_eigpairs_plain

    f64 = torch.float64
    lib = kernels.library()
    out = {key: [] for key in ("K2_f64", "K3_f64", "K7_f64", "K8a_f64", "K8b_f64", "K4_f64",
                               "K4s_f64", "K5_f64", "K6_f64")}
    i32 = dict(dtype=torch.int32, device=dev)
    tm = _tm

    # ---- K8a, K7 (fused) and K8b: every shape of the Shor k=1 loop; K2's
    # Shor mode at config 2's and the shor cell's ----
    for B, n, M5 in SHOR_SHAPES:
        inputs = (shor_inputs or {}).get((B, n, M5))
        inputs = (_shor64_of(*inputs) if inputs else
                  _shor_inputs(B, n, n, 8, M5, gen, dev, f64))
        for name, row in _check_shor_kernels(*inputs, gen, dev).items():
            row["ok"] = (row["rel_err"] <= 1e-10 and row["deterministic"]
                         and row["plan_matches_kernel"])
            if name == "K7_f64":
                row["ok"] = (row["ok"] and row["err_vs_lapack"] <= 1e-11
                             and row["mirror_sweeps_max"] <= MAX_SWEEPS
                             and row["k4s_sweeps_max"] <= MAX_SWEEPS)
            out[name].append(row)
    # ---- K8c, K7t, K7x (slots) and K8d: config 3's frontier at k = 2, 3, 4
    # and a root visit ----
    out.update(_check_shor_k64_kernels(gen, dev, shork_inputs))
    # ---- K9s, K9a and K9b: the McCormick rows' shapes and (64, 50, 3) ----
    out.update(_check_mc64_kernels(gen, dev, mc_inputs))
    for B, n in ((32, 100), (4, 50)):
        c, st, acc, ts = _admm_inputs(B, n, n, 1, 8, gen, dev, f64)
        r2, _ = _check_k2_k3(c, st, acc, ts, shor=True, sweep=False)
        r2["ok"] = r2["rel_err"] <= 1e-10 and r2["deterministic"] and r2["plan_matches_kernel"]
        out["K2_f64"].append(dict(r2, shor=True))
        del c, st, acc, ts

    # ---- K2 and K3 (and K3's Halpern mode) ----
    for B, n, k, L in F64_ADMM_SHAPES:
        c, st, acc, ts = _admm_inputs(B, n, n, k, L, gen, dev, f64)
        r2, r3 = _check_k2_k3(c, st, acc, ts, sweep=False)
        r2["ok"] = r2["rel_err"] <= 1e-10 and r2["deterministic"] and r2["plan_matches_kernel"]
        h = r3["halpern"]
        r3["ok"] = (r3["rel_err"] <= 1e-10 and r3["deterministic"] and r3["plan_matches_kernel"]
                    and h["rel_err"] <= 1e-10 and h["deterministic"])
        out["K2_f64"].append(r2)
        out["K3_f64"].append(r3)
        del c, st, acc, ts

    def lapack(T):  # float64 LAPACK on the host, the independent reference
        w, V = torch.linalg.eigh(T.cpu())
        return w.to(dev), V.to(dev)

    # ---- K4: modes 0, 1 and 2, on the planned or forced path and, beside
    # it, every other path that takes the shape ----
    def k4_metrics(T, mode, got, w64, P64, lam, d):
        """The row's bars of one K4 output: the projection within 1e-11
        relative Frobenius of LAPACK's (relative to A's norm below d = 20,
        where _eig_batch makes matrices whose projection is 0, as K4s's
        rows); eigenvalues within 1e-11 max|lambda|; eigenpairs' residual
        and orthogonality within 1e-11 sqrt(d)."""
        if mode == 1:
            scale = (P64 if d >= 20 else T).norm(dim=(-2, -1))
            r = dict(rel_err_vs_f64=float(((got - P64).norm(dim=(-2, -1)) / scale).max()))
            return r, r["rel_err_vs_f64"] <= 1e-11
        w = got if mode == 0 else got[0]
        r = dict(eig_err_vs_f64=float(((w - w64).abs().amax(-1) / lam).max()))
        ok = r["eig_err_vs_f64"] <= 1e-11
        if mode == 2:
            V = got[1]
            resid = (T @ V - V * w[..., None, :]).norm(dim=(-2, -1))
            eye = torch.eye(d, dtype=f64, device=dev)
            r["residual"] = float((resid / T.norm(dim=(-2, -1))).max())
            r["orthogonality"] = float((V.transpose(-1, -2) @ V - eye).norm(dim=(-2, -1)).max())
            ok = (ok and r["residual"] <= 1e-11 * d ** 0.5
                  and r["orthogonality"] <= 1e-11 * d ** 0.5)
        return r, ok

    for B, d, modes, force, spectrum in F64_K4_SHAPES:
        T = (_eig_batch(B, d, gen, dev, f64)[0] if spectrum == "mixed"
             else _eig_batch_clustered(B, d, gen, dev))
        w64, V64 = lapack(T)
        P64 = (V64 * w64.clamp(min=0.0)[..., None, :]) @ V64.transpose(-1, -2)
        lam = w64.abs().amax(-1)
        lib_ms = {}
        for mode in modes:
            plan = cones.k4_plan(B, d, mode, force, f64)
            sw = torch.empty(B, **i32)
            got = cones.k4_jacobi(T, mode, sweeps=sw, path=force)
            got_b = cones.k4_jacobi(T, mode, path=force)
            torch.cuda.synchronize()
            code = cones.K4_PATH_CODES[plan["path"]]
            row = dict(B=B, d=d, mode=("eigvalsh", "projection", "eigh")[mode], plan=plan,
                       spectrum=spectrum, max_sweeps=int(sw.max()), min_sweeps=int(sw.min()),
                       deterministic=_same_bits(got if mode == 2 else (got,),
                                                got_b if mode == 2 else (got_b,)),
                       workspace_matches_kernel=plan["workspace_floats"] ==
                       lib.omc_k4_workspace_floats(B, d, mode, code),
                       smem_matches_kernel=plan["smem_bytes"] == (
                           lib.omc_k4_cta_smem_bytes(d, mode, 8) if code == 0 else
                           lib.omc_k4_tri_smem_bytes(d) if code == 2 else 0))
            m, ok = k4_metrics(T, mode, got, w64, P64, lam, d)
            row.update(m)
            if mode == 1:
                plain = cones.project_psd_plain(T)
                row["max_abs_err"] = float((got - plain).abs().max())
                row["plain_ms"] = tm(lambda: cones.project_psd_plain(T), warm=True)
                name = "eigh"
            else:
                w = got if mode == 0 else got[0]
                # the plain versions are the library calls (cuSOLVER in float64)
                name = "eigvalsh" if mode == 0 else "eigh"
                ref = torch.linalg.eigvalsh(T) if mode == 0 else torch.linalg.eigh(T)[0]
                row["max_abs_err"] = float((w - ref).abs().max())
            if name not in lib_ms:
                # eigh in chunks of 16,384 (cuSOLVER's batched call refuses
                # the Shor bounds' 131,072 slots), one call below that
                fn = torch.linalg.eigvalsh if name == "eigvalsh" else cones.eigh_plain
                lib_ms[name] = tm(lambda: fn(T), warm=True)
            row["library_ms"] = lib_ms[name]
            row.setdefault("plain_ms", lib_ms[name])
            row["ms"] = tm(lambda: cones.k4_jacobi(T, mode, path=force))
            # every other path that takes the shape, with its time and its
            # bars: the measurement behind the float64 plan
            row["ms_by_path"] = {plan["path"]: row["ms"]}
            row["err_by_path"], row["ok_by_path"] = {}, {}
            for path in cones.K4_F64_PATHS:
                takes = (cones.k4_cta_fits(d, mode, f64) if path == "cta" else
                         bool(cones.k4_tri_smem_bytes(d)) if path == cones.K4_TRI else True)
                if path == plan["path"] or not takes or (path == "block16" and B > 4096):
                    continue
                sw2 = torch.empty(B, **i32)
                out2 = cones.k4_jacobi(T, mode, sweeps=sw2, path=path)
                m2, ok2 = k4_metrics(T, mode, out2, w64, P64, lam, d)
                row["err_by_path"][path] = m2
                row["ok_by_path"][path] = ok2 and int(sw2.max()) <= MAX_SWEEPS
                row["ms_by_path"][path] = tm(lambda: cones.k4_jacobi(T, mode, path=path))
                del out2
            st = {}
            if plan["path"] != "cta":
                cones.k4_jacobi(T, mode, path=force, stats=st)
            if plan["path"] == cones.K4_TRI:
                row["vectors"] = sum(st.pop("vectors"))
            row.update(st)
            row["ok"] = (ok and row["max_sweeps"] <= MAX_SWEEPS and row["deterministic"]
                         and row["workspace_matches_kernel"] and row["smem_matches_kernel"]
                         and all(row["ok_by_path"].values()))
            outf = (d, d * d, d * d + d)[mode]
            if plan["path"] == cones.K4_TRI:
                # the tridiagonal path's own work: the reduction (4 d^3 / 3 a
                # matrix), y = Q z (2 d^2 a vector) and in a projection
                # V diag(c) V' over the triangle r <= c (d^2 a vector), for
                # the vectors this run's matrices needed, all at the FP64
                # tensor cores' rate (the least time; the eigenvalues'
                # Sturm counts are left out)
                flops = B * 4 * d ** 3 / 3 + (3 if mode == 1 else 2) * d * d * row["vectors"]
                with_bound(row, 8 * B * (d * d + outf), flops, PEAK_FP64_TC_FLOPS)
            else:
                # an eigendecomposition counts 9 d^3 flops with vectors and
                # 4 d^3 / 3 without; the projection adds V max(w, 0) V' (d^3)
                flops = B * (4 * d ** 3 / 3, 10 * d ** 3, 9 * d ** 3)[mode]
                with_bound(row, 8 * B * (d * d + outf), flops, PEAK_FP64_FLOPS)
                if plan["path"] == "block16":  # its products could run on the FP64 tensor cores
                    row["bound_fp64_tc_ms"] = bound(row["bound_bytes"], flops,
                                                    PEAK_FP64_TC_FLOPS)[0]
            out["K4_f64"].append(row)

    # ---- K4s: the shor cell's 5x5 minors (4 x 4096) ----
    for N, D in ((4 * 4096, 5),):
        T, _ = _eig_batch(N, D, gen, dev, f64)
        sw = torch.empty(N, **i32)
        got = cones.k4s_project_psd(T, sw)
        got_b = cones.k4s_project_psd(T)
        torch.cuda.synchronize()
        w64, V64 = lapack(T)
        P64 = (V64 * w64.clamp(min=0.0)[..., None, :]) @ V64.transpose(-1, -2)
        plain = cones.project_psd_plain(T)
        plan = cones.k4s_plan(N, D, f64)
        row = dict(N=N, D=D, plan=plan,
                   rel_err_vs_f64=float(((got - P64).norm(dim=(-2, -1))
                                         / T.norm(dim=(-2, -1)).clamp(min=1e-300)).max()),
                   max_abs_err=float((got - plain).abs().max()),
                   max_sweeps=int(sw.max()), min_sweeps=int(sw.min()),
                   deterministic=_same_bits((got,), (got_b,)),
                   smem_matches_kernel=plan["smem_bytes"] == lib.omc_k4s_smem_bytes(D, 8),
                   ms=cuda_time_ms(lambda: cones.k4s_project_psd(T)),
                   plain_ms=tm(lambda: cones.project_psd_plain(T), warm=True),
                   library_ms=tm(lambda: cones.eigh_plain(T), warm=True))
        row["ok"] = (row["rel_err_vs_f64"] <= 1e-11 and row["max_sweeps"] <= MAX_SWEEPS
                     and row["deterministic"] and row["smem_matches_kernel"])
        with_bound(row, 8 * 2 * T.numel(), N * 10 * D ** 3, PEAK_FP64_FLOPS)
        out["K4s_f64"].append(row)

    # ---- K5: U U' - Y with its two smallest eigenvalues -1 and -0.6 ----
    for B, n, k in ((64, 50, 1), (1, 50, 1)):
        U = torch.randn(B, n, k, generator=gen, dtype=f64)
        Q, _ = torch.linalg.qr(torch.randn(B, n, n, generator=gen, dtype=f64))
        lam = torch.empty(B, n, dtype=f64).uniform_(-0.3, 1.0, generator=gen)
        lam[:, 0], lam[:, 1] = -1.0, -0.6
        Y = U @ U.transpose(-1, -2) - (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
        U, Y = U.to(dev).contiguous(), (0.5 * (Y + Y.transpose(-1, -2))).to(dev).contiguous()
        M = U @ U.transpose(-1, -2) - Y
        w64, V64 = lapack(0.5 * (M + M.transpose(-1, -2)))
        plan = k5_plan(B, n, dtype=f64)
        it = torch.empty(B, **i32)
        w, V = _k5_launch(U, Y, plan, it)
        w_b, V_b = _k5_launch(U, Y, plan)
        torch.cuda.synchronize()
        wp, Vp = separation_eigpairs_plain(U, Y)

        def aligned(X, R):  # X's columns with R's signs
            return X * torch.sign(torch.sum(X * R, dim=-2, keepdim=True))

        row = dict(B=B, n=n, k=k, plan=plan, max_iters=int(it.max()), min_iters=int(it.min()),
                   eig_err_vs_f64=float(((w - w64[:, :2]).abs().amax(-1)
                                         / w64.abs().amax(-1)).max()),
                   vec_err_vs_f64=float((aligned(V, V64[..., :2]) - V64[..., :2])
                                        .norm(dim=-2).max()),
                   max_abs_err=max(float((w - wp).abs().max()),
                                   float((aligned(V, Vp) - Vp).abs().max())),
                   deterministic=_same_bits((w, V), (w_b, V_b)),
                   smem_matches_kernel=plan["smem_bytes"] == lib.omc_k5_smem_bytes(n, 0),
                   ms=cuda_time_ms(lambda: _k5_launch(U, Y, plan)),
                   plain_ms=tm(lambda: separation_eigpairs_plain(U, Y), warm=True),
                   library_ms=tm(lambda: torch.linalg.eigh(M), warm=True))
        row["ok"] = (row["eig_err_vs_f64"] <= 1e-11 and row["vec_err_vs_f64"] <= 1e-10
                     and row["max_iters"] <= K5_MAX_ITERS and row["deterministic"]
                     and row["smem_matches_kernel"] and plan["path"] == "tridiag64")
        with_bound(row, 8 * B * (n * k + n * n + 2 + 2 * n),
                   B * (4 * n ** 3 / 3 + 2 * n * n * k), PEAK_FP64_FLOPS)
        out["K5_f64"].append(row)

    # ---- K6: a V-step + U-step at the headline's n = m = 50 on every path
    # k6_plan could take ----
    for n, B, k in F64_K6_SHAPES:
        m = n
        A = torch.randn(n, m, generator=gen, dtype=f64).to(dev)
        mask = (torch.rand(n, m, generator=gen) < 0.5).to(f64).to(dev)
        Q, _ = torch.linalg.qr(torch.randn(B, n, k, generator=gen, dtype=f64))
        U = (Q * torch.empty(B, 1, k, dtype=f64).uniform_(0.5, 2.0, generator=gen))
        U = U.to(dev).contiguous()
        by_path, err_by_path = {}, {}
        for path in K6_PATHS:
            try:
                pl = {"v": k6_plan(B, n, m, k, path, f64), "u": k6_plan(B, m, n, k, path, f64)}
            except ValueError:
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
                        K6_PATHS.index(path), k, x["S"], x["W"], x["rpw"], 8)
                    for x in pl.values()))
            by_path[path] = cuda_time_ms(lambda: u_step_unconstrained(
                v_step(U, A, mask, 80.0, path=path), A, mask, 80.0, path=path))
        plans = {"v": k6_plan(B, n, m, k, dtype=f64), "u": k6_plan(B, m, n, k, dtype=f64)}
        path = plans["v"]["path"]
        V = v_step(U, A, mask, 80.0)
        eye = torch.eye(k, dtype=f64, device=dev)
        G = torch.einsum("bnk,nm,bnl->bmkl", U, mask, U) + (1 / 80.0) * (
            U.transpose(-1, -2) @ U)[:, None] + 1e-10 * eye
        r = (U.transpose(-1, -2) @ (mask * A)).transpose(-1, -2)[..., None]
        H = torch.einsum("bkm,nm,blm->bnkl", V, mask, V) + (1 / 80.0) * (
            V @ V.transpose(-1, -2))[:, None] + 1e-10 * eye
        r2 = ((mask * A) @ V.transpose(-1, -2))[..., None]
        row = dict(B=B, n=n, m=m, k=k, plan=plans, **err_by_path[path],
                   ms=by_path[path], ms_by_path=by_path, err_by_path=err_by_path,
                   plain_ms=_tm(lambda: u_step_unconstrained_plain(
                       v_step_plain(U, A, mask, 80.0), A, mask, 80.0)),
                   library_ms=_tm(lambda: (torch.linalg.solve(G, r),
                                                    torch.linalg.solve(H, r2))))
        row["max_abs_err"] = max(e["max_abs_err"] for e in err_by_path.values())
        row["ok"] = all(e["rel_err"] <= 1e-10 and e["deterministic"] and e["smem_matches_kernel"]
                        for e in err_by_path.values())
        nnz = float(mask.sum())
        with_bound(row, 8 * (2 * n * m + B * (2 * n * k + k * m)),
                   2 * B * nnz * (k * k + 3 * k), PEAK_FP64_FLOPS)
        out["K6_f64"].append(row)
    return out


def phase_kernels64(res):
    """(Run on request only.)  The kernels phase's float64 rows alone."""
    import torch

    rows = _check_float64_kernels(torch.Generator().manual_seed(0), torch.device("cuda", 0))
    for name, rs in rows.items():
        for row in rs:
            log(name, json.dumps(row))
    res["kernels64"] = rows
    failed = [(name, row) for name, rs in rows.items() for row in rs if not row["ok"]]
    assert not failed, failed


def _bench_instance(frac, seed=0, n=50):
    """A rank-1 n x n instance with a fraction ``frac`` observed (a copy of
    the one made at the first call with these arguments)."""
    A, idx = _instance(1, n, n, int(round(frac * n * n)), seed)
    return A.copy(), idx.copy()


@functools.lru_cache(maxsize=None)
def _instance(k, n, m, n_indices, seed):
    """``generate_matrix_completion_data`` once per arguments: its
    rejection sampling takes seconds at n = 50 and 75 (2-3 s for each of
    the fixtures), and the phases ask for the same few instances."""
    from omc_torch.data import generate_matrix_completion_data

    return generate_matrix_completion_data(k, n, m, n_indices, seed)


def _fixtures():
    """The four instances of tests/fixtures/instances.json: (fixture,
    A, indices), each generated once for the fixtures and float64 phases."""
    with open(os.path.join(HERE, "tests", "fixtures", "instances.json")) as fh:
        fixtures = json.load(fh)
    for fx in fixtures:
        A, idx = _instance(fx["k"], fx["n"], fx["m"], fx["n_indices"], fx["seed"])
        yield fx, A.copy(), idx.copy()


BENCH_KW = dict(
    node_selection="bestfirst", disjunctive_cuts_type="linear",
    disjunctive_cuts_breakpoints="smallest_1_eigvec", gap=1e-4,
    time_limit=600, batch_size=64, sdp_iters=2000, dtype="float32",
    altmin_root_n_iters=3, verbosity=0,
)


def _admm_root(B=64, L=8, iters=2000, dtype=None, inst=None, k=1):
    """One root ADMM visit of the headline instance (or of ``inst``, an (A,
    indices) pair at rank ``k``) at a batch of B copies (float32, or
    ``dtype``: float64 projects with the exact Jacobi route): the solver,
    its arguments and the problem's constants."""
    import numpy as np
    import torch

    from omc_torch.sdp.admm import init_admm_state, make_admm_solver
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.solve import _polish_incumbent
    from omc_torch.tree import root_box

    dev = torch.device("cuda", 0)
    A, idx = inst or _bench_instance(0.5)
    mask = idx.astype(np.float64)
    (n, m), gamma = A.shape, 80.0
    U0 = np.linalg.svd(A * mask, full_matrices=False)[0][:, :k]
    obj0, X0, U0 = _polish_incumbent(U0 @ (U0.T @ (A * mask)), A, mask, gamma, k)
    V0 = U0.T @ X0
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = max(1.0, 2.0 * gamma * obj0 / (4.0 * m))
    rho = min(0.05, (62.5 / (n * m)) * min(2.0, 0.5 / max(mask.mean(), 1e-6)))
    lo, hi = root_box(n, k)
    dt = dtype or torch.float32
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    batch = NodeBatch(f(np.zeros((B, L, n))), f(np.zeros((B, L, k))), f(np.zeros((B, L, k))),
                      f(np.zeros((B, L))), f(np.broadcast_to(lo, (B, n, k))),
                      f(np.broadcast_to(hi, (B, n, k))))
    st = init_admm_state(B, n, m, k, L, dt, device=dev, sX=sX, sT=sT,
                         X0=X0[None], Y0=(U0 @ U0.T)[None], Th0=(V0.T @ V0)[None],
                         U0=U0[None], rho=rho)
    solve = make_admm_solver(n, m, k, L, gamma, iters=iters, dtype=dt,
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
           "config3", "shork", "mccormick", "config4", "mesh", "pdhg", "halpern", "profile",
           "float64", "shor64", "shork64", "mccormick64", "widerank", "shorkwide", "mcflat")
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

    rows = []
    for fx, A, idx in _fixtures():
        _bank(res)  # the launches so far count, then 0
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
# the frontier outgrows a batch, 16 s, rebalancing every round; the root's
# budget not boosted and at most two refinement visits a node, since with
# either this root certifies alone and rank 1 would get no node)
DIST_RANKS = 2
DIST_TIME_LIMIT = 16
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
    add_Shor_valid_inequalities_fraction=0.25, time_limit=15,
)
# the certified gap the shor phase must reach in its 15 s: 1e-4 is out of
# reach for this relaxation there (the card reaches ~3e-3 in 180 s and
# ~5e-3 by its second visit, some 10 s in; PERF.md, "shor phase"), so the
# bar is 1e-2
SHOR_GAP = 1e-2


def phase_shor(res):
    """Static Shor ([4]-minors, a quarter of them) on the 30%-observed
    50x50 instance, breadth-first, 15 s: the K7/K8a/K8b path through the
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
    update_Shor_indices_n_minors=100, gap=1e-2, time_limit=8, batch_size=32,
    sdp_iters=2000, dtype="float32", altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: one visit's budget is not boosted 8x
    sdp_iter_boost_max=1,
)


def phase_config2(res):
    """BASELINE config 2 at full width (rank-1 100x100, 30% observed, seed 1,
    iterative [4]-minor Shor, breadth-first, batch 32), 8 s."""
    import numpy as np

    from omc_torch import kernels

    n = 100
    A, idx = _bench_instance(0.3, seed=1, n=n)
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
    gap=1e-2, time_limit=8, batch_size=64, sdp_iters=2000, dtype="float32",
    altmin_root_n_iters=3, verbosity=0,
    # cut of depth, not width: the 8x boosted root visit (16,000 iterations
    # of K1's d=150 chain) does not fit the budget, and the budget is 8 s
    sdp_iter_boost_max=1,
)
# the rank-k Shor path on config 3's instance: config 2's Shor settings and
# batch (iterative [4]-minors, 100 per growth, batch 32)
SHORK_KW = dict(
    CONFIG3_KW, batch_size=32, add_Shor_valid_inequalities=True,
    add_Shor_valid_inequalities_iterative=True,
    Shor_valid_inequalities_noisy_rank1_num_entries_present=[4],
    update_Shor_indices_n_minors=100, time_limit=10,
)


def _config3_instance():
    n = 75
    A, idx = _instance(2, n, n, int(0.5 * n * n), 1)
    return A.copy(), idx.copy()


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
    smallest_2_eigvec, best-first/depth-first, batch 64), 12 s: the base
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
    call (iterative Shor, batch 32), 10 s, through K1, K2, K3, K7t, K7x,
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
             disjunctive_cuts_breakpoints=None, time_limit=6, sdp_iter_boost_max=1)
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


def _mc_root(n, k):
    """The root node of an n x n rank-k instance on the McCormick path (no
    cuts)."""
    import numpy as np

    from omc_torch.tree import BBNode, root_box

    lo, hi = root_box(n, k)
    return BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0,
                  cuts=None)


def phase_mccormick(res):
    """The McCormick path (K9s/K9a/K9b with K1): (i) the standalone
    relaxation entry point on the headline's root node, held to omc's bound;
    (ii) a rank-2 root visit of the driver on config 3's instance, held to
    omc's bound; (iii) the full McCormick B&B on the headline instance,
    6 s."""
    from omc_torch import kernels
    from omc_torch.api import matrix_completion_SDP_relaxation

    A, idx = _bench_instance(0.5)
    node = _mc_root(50, 1)
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
# The one cut: the timed frontier is 1 sub-step (128 node relaxations)
# after one warm-up step, where bench_configs.py defaults to 1,024 and
# BASELINE asks for 4,096; n, m, k, L and the device batch are as published.
C4 = dict(n=250, m=250, k=5, L=8, B=128, iters=400, substeps=1, gamma=80.0)
# kernel names in a profile: K4 and K5 share one template per path
# (prefixes: the kernels are templates on the element type too, as
# "k4_kernel<false, float>"; an older tree's have no such argument)
K4_NAMES = {"k4_kernel<false": "K4", "k4_kernel<true": "K5", "k4t_": "K4",
            "k4_block_kernel<16, false": "K4", "k4_block_kernel<16, true": "K5",
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
    step, then one timed sub-step.  The 8 slots with the lowest lb_est are
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


# ---- the node-batch split, PDHG, Halpern-anchored ADMM and the profiler

# the multinode instance at batch 8 split over two shards (streams) of the
# one card
MESH_KW = dict(BENCH_KW, batch_size=8, mesh_shape=(2,))
# the shard solver's check: config 2's shape (rank-1 100x100, 30%, Shor
# k=1, M5 bucket 1,024), B = 32 as two shards of 16, 500 iterations with a
# safe-bound call every 250 at +inf targets
MESH_SHOR = dict(n=100, B=32, L=8, M5=1024, iters=500, check_every=250, gamma=80.0)


def _mesh_shard_check(dtype=None):
    """The Shor k=1 solver at config 2's shape, split over two shards on
    streams of the one card, against the same call on one device: the
    host-certified bounds within 1e-3 (1 + |b|) and Y within 1e-3 relative
    Frobenius (float32 on the card, other kernel plans at B = 16 than at
    32; in float64, ``dtype``, 50 iterations with a bound call every 25,
    within 1e-8: float64's rounding).  The on-device bound (K4's block path
    at d = 200) runs on both streams: no slot exits early."""
    import numpy as np
    import torch

    from omc_torch import kernels
    from omc_torch.ops.cones import k4_plan
    from omc_torch.parallel.mesh import make_mesh, shard_solver_shor
    from omc_torch.sdp import admm_shor
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.sdp.shor import shor_soc_complement
    from omc_torch.sdp.shor_encode import pack_shor_batch
    from omc_torch.solve import _polish_incumbent
    from omc_torch.tree import root_box

    dt = dtype or torch.float32
    f64 = dt == torch.float64
    c = dict(MESH_SHOR, iters=50, check_every=25) if f64 else MESH_SHOR
    tol, sfx = (1e-8, "_f64") if f64 else (1e-3, "")
    n, B, L, M5, gamma, k = c["n"], c["B"], c["L"], c["M5"], c["gamma"], 1
    dev = torch.device("cuda", 0)
    A, idx = _bench_instance(0.3, seed=1, n=n)
    mask = idx.astype(np.float64)
    U0 = np.linalg.svd(A * mask, full_matrices=False)[0][:, :k]
    obj0, X0, U0 = _polish_incumbent(U0 @ (U0.T @ (A * mask)), A, mask, gamma, k)
    V0 = U0.T @ X0
    sX = max(1.0, float(np.max(np.abs(A))))
    sT = max(1.0, 2.0 * gamma * obj0 / (4.0 * n))
    rho = min(0.05, (62.5 / (n * n)) * min(2.0, 0.5 / max(mask.mean(), 1e-6)))
    rng = np.random.default_rng(7)
    minors = _random_minors(rng, B, n, n, M5)  # distinct random 2x2 minors, M5 - 24 a slot
    sbh = pack_shor_batch(n, n, minors, [shor_soc_complement(n, n, mm) for mm in minors], M5,
                          n * n)
    lo, hi = root_box(n, k)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)  # noqa: E731
    hb = NodeBatch(np.zeros((B, L, n)), np.zeros((B, L, k)), np.zeros((B, L, k)),
                   np.zeros((B, L)), np.broadcast_to(lo, (B, n, k)).copy(),
                   np.broadcast_to(hi, (B, n, k)).copy())
    batch = hb.map(f)
    st = admm_shor.init_shor_state(B, n, n, k, L, M5, n * n, dt, device=dev, sX=sX,
                                   sT=sT, sS=sX, rho=rho, X0=X0[None], Y0=(U0 @ U0.T)[None],
                                   Th0=(V0.T @ V0)[None], U0=U0[None])
    solve = admm_shor.make_shor_solver(n, n, L, M5, n * n, gamma, iters=c["iters"],
                                       dtype=dt, check_every=c["check_every"],
                                       ema_iters=1000)
    ub_bar = obj0 * (1 + 1e-9) + 1e-9
    target = torch.full((B,), float("inf"), dtype=dt, device=dev)
    group = torch.arange(B, device=dev)
    args = (f(A), f(mask), batch, sbh, ub_bar, st, c["iters"], target, group)
    mesh = make_mesh(2)
    step = shard_solver_shor(mesh, solve)
    runs = {}
    for name, fn in (("one_device", solve), ("mesh", step)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        _, out = fn(*args)
        torch.cuda.synchronize()
        runs[name] = dict(seconds=time.time() - t0, out={kk: v.cpu().numpy() for kk, v in
                                                          out.items()},
                          launches=dict(kernels.LAUNCHES))
    lbs = {name: admm_shor.host_certified_bound_shor(A, mask, hb, sbh, r["out"], gamma, ub_bar)
           for name, r in runs.items()}
    one, msh = runs["one_device"]["out"], runs["mesh"]["out"]
    d_lb = np.abs(lbs["mesh"] - lbs["one_device"]) / (1.0 + np.abs(lbs["one_device"]))
    y_rel = float(np.linalg.norm(msh["Y"] - one["Y"]) / np.linalg.norm(one["Y"]))
    row = dict(c, dtype=str(dt), mesh=[str(d) for d in mesh],
               k4_path_d200=k4_plan(B // 2, 2 * n, 1, dtype=dt)["path"],
               seconds={name: r["seconds"] for name, r in runs.items()},
               launches_mesh=runs["mesh"]["launches"],
               launches_one_device=runs["one_device"]["launches"],
               iters_run_mesh=sorted(set(int(x) for x in msh["iters_run"])),
               lb_one_device_min=float(lbs["one_device"].min()),
               lb_mesh_min=float(lbs["mesh"].min()),
               worst_rel_lb=float(d_lb.max()), y_rel_fro=y_rel)
    log("mesh shard_solver", json.dumps(row))
    assert all(np.isfinite(v).all() for v in lbs.values()), row
    assert row["worst_rel_lb"] <= tol, row
    assert y_rel <= tol, row
    assert row["iters_run_mesh"] == [c["iters"]], row  # no slot exited early
    # each shard ran its own bound calls and separation: K4 and K5 twice
    # as often as on one device
    lm, l1 = row["launches_mesh"], row["launches_one_device"]
    k4, k5 = "K4" + sfx, "K5" + sfx
    assert lm[k5] == 2 * l1[k5] == 2 and lm[k4] == 2 * l1[k4] > 0, row
    _assert_launched(lm, tuple(key + sfx for key in ("K2", "K3", "K7", "K8a", "K8b", "K4s", "K4",
                                                       "K5")) + (() if f64 else ("K1",)))
    return row


def phase_mesh(res):
    """The node-batch split (omc_torch.parallel.mesh): (i) the multinode
    instance at mesh_shape=(2,) and batch 8, two shards of 4 slots on
    streams of cuda:0, certified as the multinode phase is, with both
    shards in run_details; (ii) the shard solver at config 2's shape
    against one-device solves (``_mesh_shard_check``)."""
    from omc_torch import kernels

    A, idx = _bench_instance(0.3)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **MESH_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    row = _summary(sol, inst, secs)
    row.update(mesh_devices=rd["mesh_devices"], launches=launches)
    log("mesh multinode", json.dumps(row))
    assert rd["mesh_devices"] == ["cuda:0", "cuda:0"], rd["mesh_devices"]
    assert row["gap"] <= 1e-4, row
    assert abs(row["objective"] - MULTI_OBJ) <= (1e-4 + MULTI_GAP) * abs(MULTI_OBJ), row
    lowers = [r["lower"] for r in inst["run_log"] if r["lower"] > -1e300]
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:]))
    _assert_launched(launches, ("K1", "K2", "K3") + BOUND_KEYS)
    _bank(res)  # the launches so far count, then 0
    res["mesh"] = dict(multinode=row, shard_solver=_mesh_shard_check())


# the PDHG relaxation (sdp_method="pdhg"): a root-only visit of 1,000
# iterations on the headline instance
PDHG_KW = dict(BENCH_KW, sdp_method="pdhg", root_only=True, sdp_iters=1000,
               sdp_iter_boost_max=1)


def phase_pdhg(res):
    """omc's reference solver through the entry point: its host-certified
    root bound is finite and, by weak duality, at most the instance's
    optimum; its exact projections run through K4 and its separation
    through K5."""
    import numpy as np

    from omc_torch import kernels

    A, idx = _bench_instance(0.5)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **PDHG_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    row = _summary(sol, inst, secs)
    row.update(lower_root=float(inst["run_log"][-1]["lower"]), launches=launches,
               ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1))
    log("pdhg", json.dumps(row))
    log(f"pdhg ms_per_iter {row['ms_per_iter']:.4f}")
    assert np.isfinite(row["lower_root"]), row
    assert row["lower_root"] <= HEADLINE_OBJ * (1 + 1e-9), row
    assert row["sdp_iters_total"] == PDHG_KW["sdp_iters"], row
    _assert_launched(launches, ("K4", "K5", "K6"))
    res["pdhg"] = row


# Halpern-anchored ADMM (sdp_halpern=True): a root-only visit of 4,000
# iterations on the headline instance
HALPERN_KW = dict(BENCH_KW, sdp_halpern=True, root_only=True, sdp_iters=4000,
                  sdp_iter_boost_max=1)


def phase_halpern(res):
    """The base solver with K3 in its Halpern mode through the entry point:
    a finite certified root bound at most the instance's optimum."""
    import numpy as np

    from omc_torch import kernels

    A, idx = _bench_instance(0.5)
    kernels.reset_launches()
    sol, inst, secs = _solve(A, idx, 80.0, **HALPERN_KW)
    launches = dict(kernels.LAUNCHES)
    rd = inst["run_details"]
    row = _summary(sol, inst, secs)
    row.update(lower_root=float(inst["run_log"][-1]["lower"]), launches=launches,
               ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1))
    log("halpern", json.dumps(row))
    assert np.isfinite(row["lower_root"]), row
    assert row["lower_root"] <= HEADLINE_OBJ * (1 + 1e-9), row
    assert 0 < row["sdp_iters_total"] <= HALPERN_KW["sdp_iters"], row
    _assert_launched(launches, ("K1", "K2", "K3") + BOUND_KEYS)
    res["halpern"] = row


# the float64 phase: omc's own configuration (dtype="float64") on the card.
# The api calls at their defaults (500 ADMM iterations for the
# relaxation) on the headline's root, each against the same call on the
# CPU; the four fixtures at their own gap_target with make_fixtures.py's
# batch and iterations (tests/fixtures/instances.json records their
# certificates); the headline branch-and-bound for 3 s as a reading, its
# visits cut to 500 iterations unboosted (a float64 iteration at the root
# costs ~40x a float32 one: a boosted root alone would take minutes).
F64_API_ITERS = 250
F64_FIXTURE_KW = {  # (k, n, seed) -> benchmarks/make_fixtures.py's settings
    (1, 12, 3): dict(batch_size=4, sdp_iters=1500), (1, 16, 1): dict(batch_size=8, sdp_iters=1500),
    (1, 20, 2): dict(batch_size=8, sdp_iters=2000), (2, 10, 6): dict(batch_size=8, sdp_iters=1500)}
F64_BRANCH_KW = dict(BENCH_KW, dtype="float64", time_limit=3, sdp_iters=500,
                     sdp_iter_boost_max=1)
F64_KEYS = ("K2_f64", "K3_f64", "K4_f64", "K5_f64", "K6_f64")


def _launched_since(before):
    from omc_torch import kernels

    return {key: kernels.LAUNCHES[key] - before[key] for key in before}


def _f64_iteration_trace(dtype, psd_method, B=1, iters=20, parent=False):
    """One ADMM iteration of the headline's root at a batch of B, in
    ``dtype`` on its route, traced: CUDA-event ms an iteration, device ms by
    kernel (the rest under "other: ...": the eigh route's torch epilogue,
    psd_epilogue), K4's share, the idle share.  ``parent``: the parent's
    float64 K4 on its own plan takes this tree's K4 calls (``--parent``)."""
    global _PARENT_K4_F64_SELF
    import torch

    from omc_torch.ops import cones
    from omc_torch.sdp.admm import iteration, make_consts

    if parent:
        _PARENT_K4_F64_SELF = cones.k4_jacobi
        cones.k4_jacobi = _parent_k4_f64
        try:
            return _f64_iteration_trace(dtype, psd_method, B, iters)
        finally:
            cones.k4_jacobi = _PARENT_K4_F64_SELF

    solve, (A, mask, batch, ub_bar, st), c = _admm_root(B, dtype=dtype)
    st = st.clone()
    cs = make_consts(A, mask, batch, st, 50, 50, 1, c["gamma"], 1.9, 1e-3, dtype)
    ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
    ema = [torch.zeros_like(x) for x in (st.u1, st.u2, st.ua, st.ub, st.uc)]
    names = {"k1_": "K1", "k2_kernel": "K2", "k3_kernel": "K3", "k4_kernel": "K4",
             "k4t_": "K4", "k4s_kernel": "K4s"}
    row = _trace_loop(lambda: iteration(cs, st, ts, ema, psd_method), names, iters,
                      B=B, dtype=str(dtype), psd_method=psd_method)
    other = sum(v for key, v in row["kernel_ms_per_iter"].items() if key.startswith("other"))
    row["torch_ops_ms_per_iter"] = other
    row["torch_ops_share_of_event"] = other / row["event_ms_per_iter"]
    row["k4_share_of_event"] = row["kernel_ms_per_iter"].get("K4", 0.0) / row["event_ms_per_iter"]
    return row


def phase_float64(res):
    """The port in float64 on the card, through the float64 builds of K2,
    K3, K4, K5 and K6: the api's two entry points at their defaults against
    the same calls on the CPU, the four fixtures at their own gap, a 3 s
    headline branch-and-bound whose bounds must be sound, and one traced
    iteration at B=1 in float64 (eigh route) beside float32 (sign
    schedule)."""
    import numpy as np
    import torch

    from omc_torch import api, kernels
    from omc_torch.data import generate_matrix_completion_data
    from omc_torch.tree import BBNode, root_box

    row = {}
    A, idx = _bench_instance(0.5)
    n, k, gamma = 50, 1, 80.0
    mask = idx.astype(np.float64)
    U0 = np.linalg.svd(A * mask, full_matrices=False)[0][:, :k]
    # altmin at its defaults (float64, cuda), then on the CPU: the two runs
    # take the same steps (1e-14-level rounding apart), so their objectives
    # agree within 1e-8 relative and their iteration counts exactly
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    am = api.alternating_minimization(A, n, k, idx, gamma, U_initial=U0)
    am_s = time.time() - t0
    am_launches = _launched_since(before)
    t0 = time.time()
    am_cpu = api.alternating_minimization(A, n, k, idx, gamma, U_initial=U0, device="cpu")
    am_cpu_s = time.time() - t0
    obj, obj_cpu = float(am["objectives"][-1]), float(am_cpu["objectives"][-1])
    row["altmin"] = dict(seconds=am_s, seconds_cpu=am_cpu_s, n_iters=int(am["n_iters"]),
                         n_iters_cpu=int(am_cpu["n_iters"]), objective=obj,
                         objective_cpu=obj_cpu, rel_dist=abs(obj - obj_cpu) / abs(obj_cpu),
                         X_rel_dist=float(np.linalg.norm(am["U"] @ am["V"] - am_cpu["U"] @
                                                         am_cpu["V"])
                                          / np.linalg.norm(am_cpu["U"] @ am_cpu["V"])),
                         tol=1e-8, launches=am_launches)
    log("float64 altmin", json.dumps(row["altmin"]))
    assert am_launches["K6_f64"] > 0 and am_launches["K6"] == 0, am_launches
    assert row["altmin"]["n_iters"] == row["altmin"]["n_iters_cpu"], row["altmin"]
    assert row["altmin"]["rel_dist"] <= 1e-8, row["altmin"]
    # the root's relaxation at its defaults but 250 iterations, then on
    # the CPU: ADMM's step is nonexpansive, so the rounding of the two
    # devices stays at its own level; bound and objective within 1e-8
    # relative.  The CPU's call runs in a thread beside the card's work of
    # this phase and is read before the traced iterations.
    lo, hi = root_box(n, k)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[])

    def on_cpu():
        t0 = time.time()
        out = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma,
                                                   iters=F64_API_ITERS, device="cpu")
        return out, time.time() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu_future = pool.submit(on_cpu)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    sdp = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma, iters=F64_API_ITERS)
    sdp_s = time.time() - t0
    sdp_launches = _launched_since(before)
    _assert_launched(sdp_launches, ("K2_f64", "K3_f64", "K4_f64", "K5_f64"))
    assert not any(sdp_launches[key] for key in ("K1", "K2", "K3", "K4", "K5")), sdp_launches

    # a 4 x 4 root (blocks of order 8, 5 and 4: K4s's float64 build takes
    # every projection) against the same call on the CPU, 1e-8 relative
    A4, idx4 = generate_matrix_completion_data(1, 4, 4, 10, 0)
    lo4, hi4 = root_box(4, 1)
    node4 = BBNode(node_id=1, parent_id=0, U_lower=lo4, U_upper=hi4, LB=-np.inf, depth=0, cuts=[])
    before = dict(kernels.LAUNCHES)
    small = api.matrix_completion_SDP_relaxation(node4, 4, 1, A4, idx4, gamma, iters=F64_API_ITERS)
    small_launches = _launched_since(before)
    small_cpu = api.matrix_completion_SDP_relaxation(node4, 4, 1, A4, idx4, gamma,
                                                     iters=F64_API_ITERS, device="cpu")
    r4 = dict(lower_bound=float(small["lower_bound"]), launches=small_launches,
              lower_bound_cpu=float(small_cpu["lower_bound"]), tol=1e-8)
    r4["lower_bound_rel_dist"] = abs(r4["lower_bound"] - r4["lower_bound_cpu"]) / max(
        1.0, abs(r4["lower_bound_cpu"]))
    row["relaxation_4x4"] = r4
    log("float64 relaxation 4x4", json.dumps(r4))
    _assert_launched(small_launches, ("K2_f64", "K3_f64", "K4s_f64", "K5_f64"))
    assert r4["lower_bound_rel_dist"] <= 1e-8, r4

    # the four fixtures in float64 at their own gap_target
    rows = []
    for fx, A_, idx_ in _fixtures():
        before = dict(kernels.LAUNCHES)
        sol, inst, secs = _solve(
            A_, idx_, fx["gamma"], k=fx["k"], node_selection="bestfirst",
            disjunctive_cuts_type="linear", disjunctive_cuts_breakpoints="smallest_1_eigvec",
            gap=fx["gap_target"], dtype="float64", time_limit=60, verbosity=0,
            **F64_FIXTURE_KW[(fx["k"], fx["n"], fx["seed"])])
        fr = dict(k=fx["k"], n=fx["n"], seed=fx["seed"], gap_target=fx["gap_target"],
                  **_summary(sol, inst, secs))
        ref = fx["certified_objective"]
        fr.update(reference=ref, tol=(fx["certified_gap"] + fx["gap_target"]) * max(1.0, abs(ref)),
                  launches=_launched_since(before))
        log("float64 fixture", json.dumps(fr))
        _assert_launched(fr["launches"], F64_KEYS)
        assert fr["gap"] <= fx["gap_target"], fr
        assert abs(fr["objective"] - ref) <= fr["tol"], fr
        assert fr["lower"] <= ref * (1.0 + fx["certified_gap"]) + 1e-9, fr
        rows.append(fr)
    row["fixtures"] = rows

    # the headline branch-and-bound, 3 s, as a reading: sound bounds
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A, idx, gamma, **F64_BRANCH_KW)
    br = _summary(sol, inst, secs)
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    br.update(launches=_launched_since(before), lowers=len(lowers))
    log("float64 branch", json.dumps(br))
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert br["lower"] <= HEADLINE_OBJ * (1 + 1e-9), br
    row["branch"] = br

    # the relaxation against its CPU call (the thread's result)
    sdp_cpu, cpu_s = cpu_future.result()
    pool.shutdown()
    r = dict(seconds=sdp_s, seconds_cpu=cpu_s, ms_per_iter=1e3 * sdp_s / F64_API_ITERS,
             tol=1e-8, launches=sdp_launches)
    for key in ("lower_bound", "objective"):
        a_, b_ = float(sdp[key]), float(sdp_cpu[key])
        r[key], r[key + "_cpu"] = a_, b_
        r[key + "_rel_dist"] = abs(a_ - b_) / max(1.0, abs(b_))
    r["Y_rel_dist"] = float(np.linalg.norm(sdp["Y"] - sdp_cpu["Y"]) / np.linalg.norm(sdp_cpu["Y"]))
    row["relaxation"] = r
    log("float64 relaxation", json.dumps(r))
    assert r["lower_bound_rel_dist"] <= 1e-8 and r["objective_rel_dist"] <= 1e-8, r
    assert r["lower_bound"] <= HEADLINE_OBJ * (1 + 1e-9), r

    # ms an iteration at the root visit's B=1: float64 on the eigh route
    # (K2, K3, three K4 launches, the torch epilogue) beside float32 on the
    # sign schedule (K2, K3, K1)
    t0 = time.time()
    row["iteration"] = {dt: _f64_iteration_trace(getattr(torch, dt), pm)
                        for dt, pm in (("float64", "eigh"), ("float32", "ns"))}
    if PARENT:  # the parent's float64 K4 (its plan: the CTA path at B=1)
        row["iteration"]["float64_parent"] = _f64_iteration_trace(torch.float64, "eigh",
                                                                  parent=True)
    row["iteration_seconds"] = time.time() - t0
    for dt, tr in row["iteration"].items():
        log(f"float64 iteration ({dt})", json.dumps(tr))
    res["float64"] = row


# the shor64 phase: omc's float64 Shor k = 1 relaxation on the card.  (a)
# The api's Shor relaxation at its defaults (float64, cuda) on the
# headline's root, 250 iterations, with the root's first 1,024 fully
# observed 2x2 minors (config 2's frontier bucket; all ~94,000 would take
# the CPU's reference call minutes), against the same call on the CPU, run
# in a thread beside this phase's card work.  (b) BASELINE config 2 at full
# width in float64 (bench_configs.py's off-TPU dtype), cut in depth only:
# visits of 250 iterations, one refinement visit before a node grows or
# splits, 10 s.  (c) The Shor solver at config 2's shape split over two
# shards (mesh_shape's path) against one device, 50 iterations.  (d) One
# traced float64 iteration at config 2's shape.
SHOR64_API_ITERS = 250
SHOR64_API_MINORS = 1024
CONFIG2_F64_KW = dict(CONFIG2_KW, dtype="float64", sdp_iters=250, max_refines=1, time_limit=10)
SHOR64_KEYS = ("K2_f64", "K3_f64", "K4_f64", "K7_f64", "K8a_f64", "K8b_f64", "K4s_f64", "K5_f64")


def _shor_iteration_trace(B=32, n=100, M5=1024, iters=10):
    """One Shor k = 1 iteration at config 2's shape in float64 (the eigh
    route: K2, K8a, K3, three K4 launches and the torch epilogue, K7, K8b),
    traced: CUDA-event ms an iteration, device ms by kernel (the rest under
    "other: ..."), K4's share, the idle share."""
    import torch

    from omc_torch.sdp import admm_shor as S

    dev = torch.device("cuda", 0)
    c, sc, st = _shor_inputs(B, n, n, 8, M5, torch.Generator().manual_seed(3), dev,
                             torch.float64)
    core = st.core
    acc = [torch.zeros_like(x) for x in (core.u1, core.u2, core.ua, core.ub, core.uc, st.u5,
                                         st.ur, st.ul)]
    ts = (torch.empty_like(core.w1), torch.empty_like(core.w2), torch.empty_like(core.w3))
    names = {"k2_kernel": "K2", "k3_kernel": "K3", "k7_kernel": "K7", "k8a_kernel": "K8a",
             "k8b_kernel": "K8b", "k4s_kernel": "K4s", "k4_": "K4", "k4t_": "K4"}
    row = _trace_loop(lambda: S.shor_iteration(c, sc, st, ts, acc, "eigh"), names, iters,
                      B=B, n=n, m=n, M5=M5, L=8, dtype="float64")
    row["k4_share_of_event"] = row["kernel_ms_per_iter"].get("K4", 0.0) / row["event_ms_per_iter"]
    return row


def phase_shor64(res):
    """The Shor k = 1 family in float64 on the card, through the float64
    builds of K2 (its Shor mode), K8a, K3, K4, K7, K8b, K4s and K5: the api's
    Shor relaxation at its defaults against the same call on the CPU (bound
    and objective within 1e-8 relative), BASELINE config 2 in float64 with
    sound bounds and a Shor growth, the Shor solver at its shape split over
    two shards against one device (``_mesh_shard_check``), one traced
    iteration at its shape."""
    import numpy as np
    import torch

    from omc_torch import api, kernels
    from omc_torch.sdp.shor import (
        generate_rank1_matrix_completion_Shor_constraints_indexes,
        shor_soc_complement,
    )
    from omc_torch.tree import BBNode, ShorInfo, root_box

    row = {}
    A, idx = _bench_instance(0.5)
    n, k, gamma = 50, 1, 80.0
    minors = generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    minors = minors[:SHOR64_API_MINORS]
    lo, hi = root_box(n, k)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[],
                  Shor_info=ShorInfo(constraints_indexes=minors,
                                     SOC_constraints_indexes=shor_soc_complement(n, n, minors)))
    kw = dict(add_Shor_valid_inequalities=True, iters=SHOR64_API_ITERS)

    def on_cpu():
        t0 = time.time()
        out = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma, device="cpu", **kw)
        return out, time.time() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu_future = pool.submit(on_cpu)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    sdp = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma, **kw)
    sdp_s = time.time() - t0
    sdp_launches = _launched_since(before)
    log("shor64 relaxation launches", json.dumps(sdp_launches))
    _assert_launched(sdp_launches, SHOR64_KEYS)
    assert not any(sdp_launches[key] for key in ("K1", "K7", "K8a", "K8b")), sdp_launches

    # BASELINE config 2 in float64 (benchmarks/bench_configs.py:63 off a TPU)
    n2 = 100
    A2, idx2 = _bench_instance(0.3, seed=1, n=n2)
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A2, idx2, 80.0, **CONFIG2_F64_KW)
    launches = _launched_since(before)
    rd = inst["run_details"]
    log_ = inst["run_log"]
    lowers = [r["lower"] for r in log_ if r["lower"] > -1e300]
    c2 = _summary(sol, inst, secs)
    mask = idx2.astype(np.float64)
    X = np.asarray(sol["X"], np.float64)
    obj64 = 0.5 * float(np.sum(mask * (X - A2) ** 2)) + (0.5 / 80.0) * float(np.sum(X * X))
    c2.update(launches=launches, growths=int(rd["shor_growths"]),
              minors_max=int(rd["shor_minors_max"]),
              ms_per_iter=1e3 * rd["solve_time_device"] / max(rd["sdp_iters_total"], 1),
              gap_first=float(log_[0]["gap"]), gap_final=float(log_[-1]["gap"]),
              lowers=lowers, objective_f64=obj64)
    log("shor64 config2", json.dumps(c2))
    log(f"shor64 config2 ms_per_iter {c2['ms_per_iter']:.4f} growths {c2['growths']} "
        f"minors_max {c2['minors_max']} gap {c2['gap']:.6g}")
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert lowers and lowers[-1] <= c2["objective"] * (1 + 1e-12), c2
    assert abs(obj64 - c2["objective"]) <= 1e-9 * abs(obj64), c2
    assert c2["growths"] >= 1, c2
    _assert_launched(launches, SHOR64_KEYS)
    assert not any(launches[key] for key in ("K1", "K7", "K8a", "K8b")), launches
    row["config2"] = c2

    # the Shor solver at config 2's shape split over two shards (the
    # driver's mesh path), against one device (it resets the counts: the
    # launches so far count first)
    _bank(res)
    row["mesh"] = _mesh_shard_check(torch.float64)

    # one float64 iteration at config 2's shape, split by kernel
    row["iteration"] = _shor_iteration_trace()
    log("shor64 iteration", json.dumps(row["iteration"]))

    # the relaxation against its CPU call (the thread's result)
    sdp_cpu, cpu_s = cpu_future.result()
    pool.shutdown()
    r = dict(minors=len(minors), iters=SHOR64_API_ITERS, seconds=sdp_s, seconds_cpu=cpu_s,
             ms_per_iter=1e3 * sdp_s / SHOR64_API_ITERS, tol=1e-8, launches=sdp_launches)
    for key in ("lower_bound", "objective"):
        a_, b_ = float(sdp[key]), float(sdp_cpu[key])
        r[key], r[key + "_cpu"] = a_, b_
        r[key + "_rel_dist"] = abs(a_ - b_) / max(1.0, abs(b_))
    r["Y_rel_dist"] = float(np.linalg.norm(sdp["Y"] - sdp_cpu["Y"]) / np.linalg.norm(sdp_cpu["Y"]))
    r["W_rel_dist"] = float(np.linalg.norm(sdp["W"] - sdp_cpu["W"]) / np.linalg.norm(sdp_cpu["W"]))
    row["relaxation"] = r
    log("shor64 relaxation", json.dumps(r))
    assert r["lower_bound_rel_dist"] <= 1e-8 and r["objective_rel_dist"] <= 1e-8, r
    assert r["lower_bound"] <= HEADLINE_OBJ * (1 + 1e-9), r
    res["shor64"] = row


# the shork64 phase: omc's float64 rank-k Shor relaxation on the card.  (a)
# The api's rank-k Shor relaxation at its defaults (float64, cuda) on config
# 3's root (k = 2), cut to its first 256 fully observed 2x2 minors and 150
# iterations (a CPU call of all of them, or of 2,000 iterations, would take
# the CPU's reference call minutes), against the same call on the CPU, run
# in a thread beside this phase's card work.  (b) Config 3's instance on
# the shork cell's settings (SHORK_KW) in float64, cut in depth only: visits
# of 250 iterations, one refinement visit before a node grows or splits,
# 10 s.  (c) One traced float64 iteration at config 3's frontier shape.
SHORK64_API_ITERS = 150
SHORK64_API_MINORS = 256
SHORK64_KW = dict(SHORK_KW, dtype="float64", sdp_iters=250, max_refines=1, time_limit=10)
SHORK64_KEYS = ("K2_f64", "K3_f64", "K4_f64", "K7t_f64", "K7x_f64", "K8c_f64", "K8d_f64",
                "K4s_f64", "K5_f64")
# the float32 builds a float64 rank-k run must not launch
SHORK64_NO_F32 = ("K1", "K7t", "K7x", "K8c", "K8d")


def _shork_iteration_trace(B=32, n=75, M5=1024, k=2, iters=5):
    """One rank-k Shor iteration at config 3's frontier shape in float64
    (the eigh route: K2, K8c, K3, three K4 launches and the torch epilogue,
    K7t, K7x, K8d), traced: CUDA-event ms an iteration, device ms by kernel
    (the rest under "other: ..."), K4's share, the idle share."""
    import torch

    from omc_torch.sdp import shor_k as SK

    dev = torch.device("cuda", 0)
    c, sc, st = _shor_k_inputs(B, n, n, 8, M5, torch.Generator().manual_seed(3), dev, k=k,
                               dtype=torch.float64)
    core = st.core
    acc = [torch.zeros_like(x) for x in (core.u1, core.u2, core.ua, core.ub, core.uc, st.u5,
                                         st.ux, st.ur, st.ul, st.uwl)]
    ts = (torch.empty_like(core.w1), torch.empty_like(core.w2), torch.empty_like(core.w3))
    names = {"k2_kernel": "K2", "k3_kernel": "K3", "k8c_kernel": "K8c", "k7t_kernel": "K7t",
             "k7x_kernel": "K7x", "k8d_kernel": "K8d", "k4s_kernel": "K4s", "k4_": "K4", "k4t_": "K4"}
    row = _trace_loop(lambda: SK.shor_k_iteration(c, sc, st, ts, acc, "eigh"), names, iters,
                      B=B, n=n, m=n, k=k, M5=M5, L=8, dtype="float64")
    row["k4_share_of_event"] = row["kernel_ms_per_iter"].get("K4", 0.0) / row["event_ms_per_iter"]
    return row


def phase_shork64(res):
    """The rank-k Shor family in float64 on the card, through the float64
    builds of K2 (its Shor mode), K8c, K3, K4, K7t, K7x, K8d, K4s and K5:
    the api's rank-k Shor relaxation at its defaults against the same call
    on the CPU (bound and objective within 1e-8 relative), config 3's
    instance on the shork cell's settings in float64 with sound bounds and a
    Shor growth, and no float32 build launched; one traced iteration at its
    frontier shape."""
    import numpy as np

    from omc_torch import api, kernels
    from omc_torch.sdp.shor import (
        generate_rank1_matrix_completion_Shor_constraints_indexes,
        shor_soc_complement,
    )
    from omc_torch.tree import BBNode, ShorInfo, root_box

    row = {}
    A, idx = _config3_instance()
    n, k, gamma = 75, 2, 80.0
    minors = generate_rank1_matrix_completion_Shor_constraints_indexes(idx, [4])
    n_all = len(minors)
    minors = minors[:SHORK64_API_MINORS]
    lo, hi = root_box(n, k)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[],
                  Shor_info=ShorInfo(constraints_indexes=minors,
                                     SOC_constraints_indexes=shor_soc_complement(n, n, minors)))
    kw = dict(add_Shor_valid_inequalities=True, iters=SHORK64_API_ITERS)

    def on_cpu():
        t0 = time.time()
        out = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma, device="cpu", **kw)
        return out, time.time() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu_future = pool.submit(on_cpu)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    sdp = api.matrix_completion_SDP_relaxation(node, n, k, A, idx, gamma, **kw)
    sdp_s = time.time() - t0
    sdp_launches = _launched_since(before)
    log("shork64 relaxation launches", json.dumps(sdp_launches))
    _assert_launched(sdp_launches, SHORK64_KEYS)
    assert not any(sdp_launches[key] for key in SHORK64_NO_F32), sdp_launches

    # config 3's instance on the shork cell's settings in float64
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A, idx, gamma, k=k, **SHORK64_KW)
    launches = _launched_since(before)
    c3 = _rank2_checks("shork64 config3", sol, inst, secs, A, idx, launches,
                       SHORK64_KEYS + ("K6_f64",))
    log(f"shork64 config3 ms_per_iter {c3['ms_per_iter']:.4f} growths {c3['growths']} "
        f"minors_max {c3['minors_max']} gap {c3['gap']:.6g}")
    assert c3["growths"] >= 1 and c3["minors_max"] > 0, c3
    assert not any(launches[key] for key in SHORK64_NO_F32), launches
    row["config3"] = c3

    # one float64 iteration at config 3's frontier shape, split by kernel
    row["iteration"] = _shork_iteration_trace()
    log("shork64 iteration", json.dumps(row["iteration"]))

    # the relaxation against its CPU call (the thread's result)
    sdp_cpu, cpu_s = cpu_future.result()
    pool.shutdown()
    r = dict(minors=len(minors), minors_all=n_all, iters=SHORK64_API_ITERS, seconds=sdp_s,
             seconds_cpu=cpu_s, ms_per_iter=1e3 * sdp_s / SHORK64_API_ITERS, tol=1e-8,
             launches=sdp_launches)
    for key in ("lower_bound", "objective"):
        a_, b_ = float(sdp[key]), float(sdp_cpu[key])
        r[key], r[key + "_cpu"] = a_, b_
        r[key + "_rel_dist"] = abs(a_ - b_) / max(1.0, abs(b_))
    for key in ("Y", "W"):
        r[key + "_rel_dist"] = float(np.linalg.norm(sdp[key] - sdp_cpu[key])
                                     / np.linalg.norm(sdp_cpu[key]))
    row["relaxation"] = r
    log("shork64 relaxation", json.dumps(r))
    assert r["lower_bound_rel_dist"] <= 1e-8 and r["objective_rel_dist"] <= 1e-8, r
    assert r["lower_bound"] <= CONFIG3_OBJ * (1 + 1e-9), r
    res["shork64"] = row


# the mccormick64 phase: omc's float64 McCormick relaxation on the card
# (the float64 builds of K9s, K9a, K9b, K4, K5 and K6).  (a) The api's
# McCormick relaxation at its defaults (float64, cuda) on the headline's root
# (the mccormick phase's node), cut to 250 iterations, and (b) at k = 2 on
# config 3's root, cut to 150 iterations as shork64 cut its call, each
# against the same call on the CPU, run in a thread beside this phase's card
# work.  (c) The headline instance's McCormick B&B in float64 (MC_KW), cut in
# depth only: visits of 250 iterations, one refinement visit before a node
# splits, 8 s.  (d) One traced float64 iteration at the headline's shape,
# B=64 and the root's B=1.
MC64_API_ITERS = 250
MC64_K2_ITERS = 150
MC64_KW = dict(MC_KW, dtype="float64", sdp_iters=250, max_refines=1, time_limit=8)
MC64_KEYS = ("K9s_f64", "K9a_f64", "K9b_f64", "K4_f64", "K5_f64", "K6_f64")
# the float32 builds a float64 McCormick run must not launch
MC64_NO_F32 = ("K1", "K9s", "K9a", "K9b")


def _mc_iteration_trace(B, iters=10):
    """One McCormick iteration at the headline's shape (n = m = 50, k = 1)
    in float64 (the eigh route: K9a, K9b, three K4 launches and the torch
    epilogue, the running means on), traced: CUDA-event ms an iteration,
    device ms by kernel (the rest under "other: ..."), K4's share, the idle
    share."""
    import torch

    from omc_torch.sdp import mccormick as MC

    dev = torch.device("cuda", 0)
    c, st = _mc64_of(*_mc_inputs(B, 50, 50, 1, torch.Generator().manual_seed(4), dev))
    acc = [torch.zeros_like(x) for x in (st.u1, st.u2, st.umc, st.uorth)]
    ts = (torch.empty_like(st.w1), torch.empty_like(st.w2), torch.empty_like(st.w3))
    names = {"k9a_kernel": "K9a", "k9b_kernel": "K9b", "k4_": "K4", "k4t_": "K4"}
    row = _trace_loop(lambda: MC.mc_iteration(c, st, ts, acc, 0.25, "eigh"), names, iters,
                      B=B, n=50, m=50, k=1, dtype="float64")
    row["k4_share_of_event"] = row["kernel_ms_per_iter"].get("K4", 0.0) / row["event_ms_per_iter"]
    return row


def phase_mccormick64(res):
    """The McCormick family in float64 on the card, through the float64
    builds of K9s, K9a, K9b, K4, K5 and K6: the api's McCormick relaxation
    at its defaults on the headline's root and at k = 2 on config 3's root,
    each against the same call on the CPU (bound and objective within 1e-8
    relative); the headline's McCormick B&B in float64 with sound bounds,
    omc's objective and more than one node; no float32 build launched; one
    traced iteration at B=64 and at B=1."""
    import numpy as np

    from omc_torch import api, kernels

    row = {}
    A, idx = _bench_instance(0.5)
    A3, idx3 = _config3_instance()
    calls = {"k1": (_mc_root(50, 1), 50, 1, A, idx, MC64_API_ITERS, HEADLINE_OBJ),
             "k2": (_mc_root(75, 2), 75, 2, A3, idx3, MC64_K2_ITERS, CONFIG3_OBJ)}

    def relax(key, **kw):
        node, n, k, A_, idx_, iters, _ = calls[key]
        t0 = time.time()
        out = api.matrix_completion_SDP_relaxation(node, n, k, A_, idx_, 80.0,
                                                   use_disjunctive_cuts=False, iters=iters, **kw)
        return out, time.time() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu_futures = {key: pool.submit(relax, key, device="cpu") for key in calls}
    card = {}
    for key in calls:
        before = dict(kernels.LAUNCHES)
        card[key] = relax(key) + (_launched_since(before),)
        log(f"mccormick64 relaxation {key} launches", json.dumps(card[key][2]))
        _assert_launched(card[key][2], MC64_KEYS[:5])
        assert not any(card[key][2][x] for x in MC64_NO_F32), card[key][2]

    # the headline's McCormick B&B in float64
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A, idx, 80.0, **MC64_KW)
    launches = _launched_since(before)
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    br = _summary(sol, inst, secs)
    br.update(launches=launches, lowers=lowers,
              ms_per_iter=1e3 * br["device_s"] / max(br["sdp_iters_total"], 1))
    log("mccormick64 branch", json.dumps(br))
    assert abs(br["objective"] - HEADLINE_OBJ) <= 1e-6 * HEADLINE_OBJ, br
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert all(x <= HEADLINE_OBJ * (1 + 1e-4) for x in lowers), lowers
    assert br["nodes_explored"] > 1, br
    _assert_launched(launches, MC64_KEYS)
    assert not any(launches[x] for x in MC64_NO_F32), launches
    # one K9a, one K9b and three K4 projections an iteration, K9s and the
    # separation once a visit
    iters, visits = br["sdp_iters_total"], br["device_steps"]
    assert launches["K9a_f64"] == launches["K9b_f64"] == iters, (launches, br)
    assert launches["K4_f64"] == 3 * iters, (launches, br)
    assert launches["K9s_f64"] == launches["K5_f64"] == visits, (launches, br)
    row["branch"] = br

    # one float64 iteration at B=64 and at the root's B=1, split by kernel
    row["iteration"] = {f"B{B}": _mc_iteration_trace(B) for B in (64, 1)}
    for key, tr in row["iteration"].items():
        log(f"mccormick64 iteration {key}", json.dumps(tr))

    # the relaxations against their CPU calls (the thread's results)
    for key, (_, _, k, _, _, iters, obj) in calls.items():
        (sdp, secs_), sdp_launches = card[key][:2], card[key][2]
        sdp_cpu, cpu_s = cpu_futures[key].result()
        r = dict(k=k, iters=iters, seconds=secs_, seconds_cpu=cpu_s,
                 ms_per_iter=1e3 * secs_ / iters, tol=1e-8, launches=sdp_launches)
        for name in ("lower_bound", "objective"):
            a_, b_ = float(sdp[name]), float(sdp_cpu[name])
            r[name], r[name + "_cpu"] = a_, b_
            r[name + "_rel_dist"] = abs(a_ - b_) / max(1.0, abs(b_))
        r["Y_rel_dist"] = float(np.linalg.norm(sdp["Y"] - sdp_cpu["Y"])
                                / np.linalg.norm(sdp_cpu["Y"]))
        row[f"relaxation_{key}"] = r
        log(f"mccormick64 relaxation {key}", json.dumps(r))
        assert r["lower_bound_rel_dist"] <= 1e-8 and r["objective_rel_dist"] <= 1e-8, r
        assert r["lower_bound"] <= obj, r
    pool.shutdown()
    res["mccormick64"] = row


# ---------------------------------------------------------------------------
# widerank: every rank omc runs through altmin and McCormick (K6's wide
# path past k = 10; K9s, K9a and K9b's wide kernels at k >= 4 and n + m >
# 4096), and the shape gate's refusal of rank-k Shor at k >= 5
# ---------------------------------------------------------------------------

# K6's wide rows (B, n = m, k, dtype): config 5's scale (n = m = 1000) and
# a mid-size width, batches of a root visit and of a frontier; at k = 80 in
# float64 the 8 warps' entries pass a CTA's shared memory and go to the
# global workspace
K6W_SHAPES = ((4, 250, 16, "float32"), (64, 250, 16, "float32"), (64, 1000, 20, "float32"),
              (4, 1000, 32, "float32"), (4, 250, 16, "float64"), (64, 1000, 20, "float64"),
              (4, 1000, 80, "float64"))
# the wide McCormick rows (B, n = m, k): rank 4 at a mid-tree batch, 6 and
# 10 at small batches; K9a and K9b also at n + m = 4,200 (k = 1)
MCW_SHAPES = ((16, 50, 4), (4, 50, 6), (1, 75, 10))
MCW_WIDE_NM = ((1, 2100, 1),)
# the paths: altmin at rank 20 on a 1000 x 1000 instance (config 5's
# scale, 30% observed), a rank-12 root visit at 100 x 100, the McCormick
# relaxation and B&B at k = 4 on config 3's instance; on request
# (mcwide64), the float64 McCormick relaxation at n = m = 2100, k = 1
WR_ALT = dict(k=20, n=1000, frac=0.3, seed=0, iters=1)
WR_ROOT = dict(k=12, n=100, frac=0.3, seed=1, B=4, visit=500, iters=1000)
WR_MC_ITERS, WR_MC_BB_S = 100, 4
WR_MC_BIG = dict(n=2100, frac=0.3, seed=2)
WR_MC_KW = dict(MC_KW, time_limit=WR_MC_BB_S)
# the wide kernels against the register and unrolled ones at the ranks
# both take: K6 at k = 10 (B, n = m), K9s, K9a and K9b at k <= 3 (B, n = m, k)
WR_K6_BOTH = ((64, 250), (4, 1000))
WR_K9_BOTH = ((64, 50, 1), (16, 50, 3))
# the float64 McCormick relaxation at n = m = 2100 (run on request: K4's
# float64 build on the three PSD blocks at d = 4,200)
WR_MC_BIG64_ITERS = 4


def _held_device_ms(fn, reps=10):
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls queued behind a spin kernel that holds the stream until the host
    has queued them all, so that they run back to back and the events span
    the device's time alone (its gaps between launches included).  It reads
    no profiler trace: late in a long process the profiler misses these
    rows' kernels (PERF.md §7).  Raises where the hold ended before the last
    call was queued at every hold tried (the span would hold the host's
    time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 10 ** 7  # ~6 ms at the H100's clocks
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError(f"the stream's hold ended before {reps} calls were queued")


def _wr_instance(k, n, frac, seed):
    """A rank-k n x n instance from omc_torch.data with a fraction ``frac``
    observed (its noise drawn at the instance's own size)."""
    from omc_torch.data import generate_matrix_completion_data

    return generate_matrix_completion_data(k, n, n, int(frac * n * n), seed, n_max=n, m_max=n)


def _check_k6_wide(gen, dev):
    """K6's wide path (V-step, then U-step on its V) against the plain
    version in the row's dtype (and, in float32, in float64), two launches'
    bits, its plan against the kernel's shared-memory export, CUDA-event and
    device ms (``_held_device_ms``), the plain version's and the library's (torch.linalg.solve on
    the prebuilt Grams) ms, and the bound (the register paths' count of
    bytes and of the observed entries' operations; FP64 at 34 TFLOP/s).
    Bars: float64 1e-12 relative; float32 1e-5 of the float32 plain
    version, or, where the float32 plain version is itself more than 5e-6
    from the float64 one (the Grams' conditioning), within twice that
    distance of the float64 plain version."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops.linalg import (K6_WIDE, k6_plan, u_step_unconstrained,
                                      u_step_unconstrained_plain, v_step, v_step_plain)

    lib = kernels.library()
    out = {"K6w": [], "K6w_f64": []}
    for B, n, k, dts in K6W_SHAPES:
        m, dt = n, getattr(torch, dts)
        e = dt.itemsize
        A = torch.randn(n, m, generator=gen, dtype=torch.float64).to(dev)
        mask = (torch.rand(n, m, generator=gen) < 0.3).double().to(dev)
        Q, _ = torch.linalg.qr(torch.randn(B, n, k, generator=gen, dtype=torch.float64))
        U64 = (Q * torch.empty(B, 1, k, dtype=torch.float64).uniform_(0.5, 2.0, generator=gen))
        U64 = U64.to(dev).contiguous()
        U, A_, mask_ = U64.to(dt), A.to(dt), mask.to(dt)
        pl = {"v": k6_plan(B, n, m, k, None, dt), "u": k6_plan(B, m, n, k, None, dt)}

        def step():
            V = v_step(U, A_, mask_, 80.0)
            return V, u_step_unconstrained(V, A_, mask_, 80.0)

        (V, U2), (V_b, U2_b) = step(), step()
        torch.cuda.synchronize()
        Vp, U2p = v_step_plain(U, A_, mask_, 80.0), u_step_unconstrained_plain(V, A_, mask_, 80.0)
        row = dict(B=B, n=n, m=m, k=k, dtype=dts, plan=pl,
                   rel_err=max(rel_fro(V, Vp), rel_fro(U2, U2p)),
                   max_abs_err=max(float((V - Vp).abs().max()), float((U2 - U2p).abs().max())),
                   deterministic=_same_bits((V, U2), (V_b, U2_b)),
                   smem_matches_kernel=all(
                       x["path"] == K6_WIDE and x["smem_bytes"] == lib.omc_k6_smem_bytes(
                           2, k, x["S"], x["W"], x["rpw"], e) for x in pl.values()))
        if dt == torch.float32:
            # the float64 plain version on the same values, and the float32
            # plain version's own distance from it
            V64 = v_step_plain(U.double(), A, mask, 80.0)
            U264 = u_step_unconstrained_plain(V.double(), A, mask, 80.0)
            row["rel_err_vs_f64"] = max(rel_fro(V, V64), rel_fro(U2, U264))
            row["plain_rel_err_vs_f64"] = max(rel_fro(Vp, V64), rel_fro(U2p, U264))
            ok = row["rel_err"] <= 1e-5 or (
                row["plain_rel_err_vs_f64"] > 5e-6
                and row["rel_err_vs_f64"] <= 2 * row["plain_rel_err_vs_f64"])
        else:
            ok = row["rel_err"] <= 1e-12
        fns = {"kernel": lambda: u_step_unconstrained(v_step(U, A_, mask_, 80.0), A_, mask_,
                                                      80.0)}
        G = torch.einsum("bnk,nm,bnl->bmkl", U, mask_, U) + (1 / 80.0) * (
            U.transpose(-1, -2) @ U)[:, None] + 1e-10 * torch.eye(k, dtype=dt, device=dev)
        r = (U.transpose(-1, -2) @ (mask_ * A_)).transpose(-1, -2)[..., None]
        H = torch.einsum("bkm,nm,blm->bnkl", V, mask_, V) + (1 / 80.0) * (
            V @ V.transpose(-1, -2))[:, None] + 1e-10 * torch.eye(k, dtype=dt, device=dev)
        r2 = ((mask_ * A_) @ V.transpose(-1, -2))[..., None]
        row.update(ms=cuda_time_ms(fns["kernel"], reps=10),
                   plain_ms=_tm(lambda: u_step_unconstrained_plain(
                       v_step_plain(U, A_, mask_, 80.0), A_, mask_, 80.0)),
                   library_ms=_tm(lambda: (torch.linalg.solve(G, r), torch.linalg.solve(H, r2))))
        row["device_ms"] = _held_device_ms(fns["kernel"])
        row["ok"] = ok and row["deterministic"] and row["smem_matches_kernel"]
        nnz = float(mask.sum())
        with_bound(row, e * (2 * n * m + B * (2 * n * k + k * m)),
                   2 * B * nnz * (k * k + 3 * k), PEAK_FP64_FLOPS if e == 8 else PEAK_FP32_FLOPS)
        out["K6w" if e == 4 else "K6w_f64"].append(row)
        del A, mask, U64, U, A_, mask_, G, H
    return out


def _check_mc_wide(gen, dev):
    """K9s's, K9a's and K9b's wide kernels against their plain versions at
    ``MCW_SHAPES`` (K9a and K9b also at ``MCW_WIDE_NM``), float32 on
    ``_mc_inputs``' inputs and float64 on their float64 copies (K9b at
    K9a's outputs, with the running means): errors (K9s's factors also
    against the row Grams), two launches' bits, the plans against the
    kernels' exports, CUDA-event and device ms (``_held_device_ms``), the
    plain version's and
    (K9s) the library chain's ms (cuSOLVER's Cholesky and the solves for
    S_i on the same Grams), the bound (values at 4 or 8 bytes; FP64 at 34
    TFLOP/s).  Bars: 1e-5 relative in float32 (sums in another order than
    the plain version's), 1e-12 in float64; Mc Mc' within 1e-5 / 1e-12 of
    the Grams."""
    import torch

    from omc_torch import kernels
    from omc_torch.sdp import mccormick as MC

    lib = kernels.library()
    out = {key: [] for key in ("K9sw", "K9aw", "K9bw", "K9sw_f64", "K9aw_f64", "K9bw_f64")}
    zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
    for B, n, k in MCW_SHAPES + MCW_WIDE_NM:
        c32, st32 = _mc_inputs(B, n, n, k, gen, dev, on_device=(B, n, k) in MCW_WIDE_NM)
        for c, st in ((c32, st32), _mc64_of(c32, st32)):
            dt = st.rho.dtype
            e, suf = dt.itemsize, "" if dt == torch.float32 else "_f64"
            bar = 1e-5 if e == 4 else 1e-12
            peak = PEAK_FP32_FLOPS if e == 4 else PEAK_FP64_FLOPS
            m, q = n, k * (k + 1) // 2
            shape = dict(B=B, n=n, m=m, k=k, dtype=str(dt).split(".")[1])
            if k > 3:  # K9s's wide kernels (k <= 3 takes the unrolled one at any n)
                got, got2 = MC.mc_setup(c.batch, k), MC.mc_setup(c.batch, k)
                torch.cuda.synchronize()
                gram = MC.mc_gram_plain(c.batch, k)
                rel, ab = _errs(got, MC.mc_setup_plain(c.batch, k))
                Et = torch.zeros((k + q, q), dtype=dt, device=dev)
                Et[k:] = torch.eye(q, dtype=dt, device=dev)
                Etb = Et.expand(B, n, k + q, q).contiguous()
                plan = MC.k9s_plan(B, n, k, dt)
                fns = {"kernel": lambda: MC.mc_setup(c.batch, k)}
                rs = dict(**shape, plan=plan, plan_matches_kernel=plan.get("path") == "wide",
                          rel_err=rel, max_abs_err=ab,
                          gram_rel_err=rel_fro(got[0] @ got[0].transpose(-1, -2), gram),
                          deterministic=_same_bits(got, got2),
                          ms=cuda_time_ms(fns["kernel"], reps=10),
                          plain_ms=_tm(lambda: MC.mc_setup_plain(c.batch, k)),
                          library_ms=_tm(
                              lambda: torch.cholesky_solve(Etb, torch.linalg.cholesky(gram))))
                rs["device_ms"] = _held_device_ms(fns["kernel"])
                rs["ok"] = (rs["rel_err"] <= bar and rs["gram_rel_err"] <= bar
                            and rs["deterministic"] and rs["plan_matches_kernel"])
                vals, ops = _k9s_work(B, n, k)
                with_bound(rs, e * vals, ops, peak)
                out["K9sw" + suf].append(rs)

            # K9a
            sk, s2 = st.clone(), st.clone()
            MC.mc_zstep(c, sk)
            MC.mc_zstep(c, s2)
            torch.cuda.synchronize()
            rel, ab = _errs(zs(sk), MC.mc_zstep_plain(c, st))
            plan = MC.k9_plan(B, n, m, k, dt)
            s3 = st.clone()
            fns = {"kernel": lambda: MC.mc_zstep(c, s3)}
            ra = dict(**shape, plan=plan,
                      plan_matches_kernel=(plan.get("path") == "wide" and plan["k9a_grid"]
                                           == lib.omc_k9a_wide_grid_x(B, n, m)
                                           and plan["k9a_fix_smem"]
                                           == lib.omc_k9a_fix_smem_bytes(k, e)),
                      rel_err=rel, max_abs_err=ab, deterministic=_same_bits(zs(sk), zs(s2)),
                      ms=cuda_time_ms(fns["kernel"], reps=10),
                      plain_ms=_tm(lambda: MC.mc_zstep_plain(c, st)), library_ms=None)
            ra["device_ms"] = _held_device_ms(fns["kernel"])
            ra["ok"] = ra["rel_err"] <= bar and ra["deterministic"] and ra["plan_matches_kernel"]
            vals, ops = _k9a_work(B, n, m, k)
            with_bound(ra, e * vals, ops, peak)
            out["K9aw" + suf].append(ra)

            # K9b at K9a's outputs, with the running means
            acc = [torch.randn(x.shape, generator=gen, dtype=torch.float64).to(dev, dt) * 0.1
                   for x in (st.umc, st.uorth)]

            def k9b(s_):
                sb, a = s_.clone(), [x.clone() for x in acc]
                ts = tuple(torch.empty_like(x) for x in (sb.w1, sb.w2, sb.w3))
                return (lambda: MC.mc_cone_step(c, sb, ts, a, 0.25),
                        lambda: ts + tuple(getattr(sb, name) for name in MC._REST) + tuple(a))

            (run1, out1), (run2, out2) = k9b(sk), k9b(sk)
            run1()
            run2()
            torch.cuda.synchronize()
            t1, t2, t3, rest, acc_p = MC.mc_cone_step_plain(c, sk, acc, 0.25)
            ref = (t1, t2, t3) + tuple(rest) + tuple(acc_p)
            rel, ab, by_out = _k9b_errs(c, sk, out1(), ref, 0.25)
            fns = {"kernel": k9b(sk)[0]}
            rb = dict(**shape, plan=plan,
                      plan_matches_kernel=(plan["k9b_grid"] == lib.omc_k9b_grid_x(
                          B, n, m, k, plan["qpc"], e) and plan["k9b_smem"]
                          == lib.omc_k9b_wide_smem_bytes(k, e)),
                      rel_err=rel, max_abs_err=ab, err_by_output=by_out,
                      deterministic=_same_bits(out1(), out2()),
                      ms=cuda_time_ms(fns["kernel"], reps=10),
                      plain_ms=_tm(lambda: MC.mc_cone_step_plain(c, sk, acc, 0.25)),
                      library_ms=None)
            rb["device_ms"] = _held_device_ms(fns["kernel"])
            rb["ok"] = rb["rel_err"] <= bar and rb["deterministic"] and rb["plan_matches_kernel"]
            vals, ops = _k9b_work(B, n, m, k)
            with_bound(rb, e * vals, ops, peak)
            out["K9bw" + suf].append(rb)
            del sk, s2, s3, acc
        del c32, st32
    return out


def _check_wide_vs_unrolled(gen, dev, timed=True):
    """The wide kernels forced at ranks the register and unrolled kernels
    take, in float32: K6 (V-step, then U-step) at k = 10 (``WR_K6_BOTH``),
    K9s, K9a and K9b at k <= 3 (``WR_K9_BOTH``).  The wide side's error
    against the plain version (bar 1e-5 relative, as its rows at k > 10 and
    k >= 4); with ``timed``, each side's CUDA-event and held-stream device
    ms on the same inputs (whether the register and unrolled paths earn
    their place beside the wide ones)."""
    import torch

    from omc_torch.ops.linalg import (u_step_unconstrained, u_step_unconstrained_plain, v_step,
                                      v_step_plain)
    from omc_torch.sdp import mccormick as MC

    def both(row, default, wide, err):
        row["wide_rel_err"] = err
        if timed:
            row.update(ms=cuda_time_ms(default, reps=10), wide_ms=cuda_time_ms(wide, reps=10),
                       device_ms=_held_device_ms(default), wide_device_ms=_held_device_ms(wide))
            row["wide_over_default"] = row["wide_device_ms"] / row["device_ms"]
        row["ok"] = err <= 1e-5
        log("wide vs unrolled", json.dumps(row))
        return row

    rows = []
    for B, n in WR_K6_BOTH:
        k = 10
        A = torch.randn(n, n, generator=gen).to(dev)
        mask = (torch.rand(n, n, generator=gen) < 0.3).float().to(dev)
        Q, _ = torch.linalg.qr(torch.randn(B, n, k, generator=gen, dtype=torch.float64))
        U = (Q * torch.empty(B, 1, k, dtype=torch.float64).uniform_(0.5, 2.0, generator=gen))
        U = U.float().to(dev).contiguous()

        def step(path):
            V = v_step(U, A, mask, 80.0, path=path)
            return V, u_step_unconstrained(V, A, mask, 80.0, path=path)

        V, U2 = step("wide")
        err = max(rel_fro(V, v_step_plain(U, A, mask, 80.0)),
                  rel_fro(U2, u_step_unconstrained_plain(V, A, mask, 80.0)))
        rows.append(both(dict(kernel="K6", B=B, n=n, k=k), lambda: step(None),
                         lambda: step("wide"), err))
    for B, n, k in WR_K9_BOTH:
        c, st = _mc_inputs(B, n, n, k, gen, dev)
        err = _errs(MC.mc_setup(c.batch, k, path="wide"), MC.mc_setup_plain(c.batch, k))[0]
        rows.append(both(dict(kernel="K9s", B=B, n=n, k=k), lambda: MC.mc_setup(c.batch, k),
                         lambda: MC.mc_setup(c.batch, k, path="wide"), err))
        sa, sw = st.clone(), st.clone()
        MC.mc_zstep(c, sw, path="wide")
        err = _errs((sw.X, sw.Y, sw.Th, sw.U, sw.t), MC.mc_zstep_plain(c, st))[0]
        rows.append(both(dict(kernel="K9a", B=B, n=n, k=k), lambda: MC.mc_zstep(c, sa),
                         lambda: MC.mc_zstep(c, sw, path="wide"), err))
        ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
        tw = tuple(torch.empty_like(x) for x in ts)
        sb, sw = st.clone(), st.clone()
        MC.mc_cone_step(c, sw, tw, None, 0.0, path="wide")
        t1, t2, t3, rest, _ = MC.mc_cone_step_plain(c, st)
        err = _k9b_errs(c, st, tw + tuple(getattr(sw, x) for x in MC._REST),
                        (t1, t2, t3) + tuple(rest), 0.0)[0]
        rows.append(both(dict(kernel="K9b", B=B, n=n, k=k),
                         lambda: MC.mc_cone_step(c, sb, ts, None, 0.0),
                         lambda: MC.mc_cone_step(c, sb, tw, None, 0.0, path="wide"), err))
        del c, st, sa, sb, sw
    return rows


def _k9b_errs(c, st, got, ref, beta):
    """K9b's outputs (t1, t2, t3, the non-PSD slots, the running means)
    against the plain version's: the largest error relative to each
    output's scale, the largest absolute error, and both by output.  The
    trace slot (w4, u4) sums n diagonal entries of Y and the orthogonality
    rows (uorth, and acc_orth through beta rho uorth) n entries of t each:
    their scale is the sum of the terms' magnitudes (alpha sum_i |Y_ii|,
    alpha sum_i |t_ip|), not the sum's own, which cancels to a small value
    at a (near-)feasible point; the sums run in another order than the
    plain version's.  Every other output's scale is its own norm."""
    import torch

    from omc_torch.sdp import mccormick as MC

    names = ("t1", "t2", "t3") + MC._REST + ("acc_mc", "acc_orth")
    a = c.alpha
    tr = a * torch.diagonal(st.Y, dim1=-2, dim2=-1).abs().sum(-1)  # (B,)
    tt = a * st.t.abs().sum(-2)  # (B, q)
    scale = {"w4": tr, "u4": tr, "uorth": tt, "acc_orth": beta * st.rho[:, None] * tt}
    by_out, rel, ab = {}, 0.0, 0.0
    for nm, x, y in zip(names, got, ref):
        d = float(torch.linalg.norm((x - y).double()))
        nrm = float(torch.linalg.norm(y.double()))
        if nm in scale:
            nrm = max(nrm, float(torch.linalg.norm(scale[nm].double())))
        r = d / nrm if nrm > 0 else (0.0 if d == 0 else float("inf"))
        by_out[nm] = (r, float((x - y).abs().max()))
        rel, ab = max(rel, r), max(ab, by_out[nm][1])
    return rel, ab, by_out


def _wr_against_cpu(name, fn, tol, keys, cpu):
    """``fn("cuda")`` on the card against ``cpu``, the future of the same
    call on the CPU: the card's result, its seconds and launches, and the
    relative distances of ``keys`` (numbers or arrays) from the CPU's."""
    import numpy as np

    from omc_torch import kernels

    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    got = fn("cuda")
    secs = time.time() - t0
    launches = _launched_since(before)
    ref = cpu.result()
    row = dict(seconds=secs, tol=tol, launches={x: v for x, v in launches.items() if v})
    for key in keys:
        a, b = np.asarray(got[key], np.float64), np.asarray(ref[key], np.float64)
        row[key + "_rel_dist"] = float(np.linalg.norm(a - b) / max(1.0, np.linalg.norm(b)))
        assert row[key + "_rel_dist"] <= tol, (name, key, row)
    log(f"widerank {name}", json.dumps(row))
    return got, row


def _wr_mc_big(dts, iters):
    """The api's McCormick relaxation at n = m = 2100, k = 1 (n + m =
    4,200: the wide K9a and K9b, and the PSD blocks at d = 4,200), in
    ``dts`` for ``iters`` iterations, from altmin's incumbent: its bound
    finite and no higher than altmin's objective, and its kernels launched
    (float32: K1; float64: K4's float64 build)."""
    import numpy as np

    from omc_torch import api, kernels

    nb = WR_MC_BIG["n"]
    Ab, idxb = _wr_instance(1, nb, WR_MC_BIG["frac"], WR_MC_BIG["seed"])
    # the top left singular vector of the observed entries, by power steps
    Mb = Ab * idxb
    Ub = np.random.default_rng(4).standard_normal((nb, 1))
    for _ in range(8):
        Ub = Mb @ (Mb.T @ Ub)
        Ub /= np.linalg.norm(Ub)
    alt = api.alternating_minimization(Ab, nb, 1, idxb, 80.0, U_initial=Ub, max_iters=20,
                                       dtype=dts)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    big = api.matrix_completion_SDP_relaxation(_mc_root(nb, 1), nb, 1, Ab, idxb, 80.0,
                                               use_disjunctive_cuts=False, iters=iters,
                                               dtype=dts)
    r = dict(dtype=dts, iters=iters, seconds=time.time() - t0, lower_bound=big["lower_bound"],
             objective=big["objective"], altmin_objective=alt["objectives"][-1],
             launches={x: v for x, v in _launched_since(before).items() if v})
    log(f"widerank mccormick n=2100 {dts}", json.dumps(r))
    assert np.isfinite(r["lower_bound"]) and r["lower_bound"] <= r["altmin_objective"], r
    suf = "" if dts == "float32" else "_f64"
    _assert_launched(r["launches"], tuple(x + suf for x in ("K9aw", "K9bw", "K9s"))
                     + (("K1",) if dts == "float32" else ("K4_f64",)))
    return r


def phase_widevsunrolled(res):
    """(Run on request only.)  The wide kernels forced at the ranks the
    register and unrolled kernels take, timed beside them
    (``_check_wide_vs_unrolled``; the widerank phase holds them to their
    plain versions untimed)."""
    import torch

    rows = _check_wide_vs_unrolled(torch.Generator().manual_seed(21), torch.device("cuda", 0))
    res["widevsunrolled"] = rows
    assert all(r["ok"] for r in rows), rows


def phase_mcwide64(res):
    """(Run on request only.)  McCormick in float64 past n + m = 4096: K4's
    float64 build on one PSD block at d = 4,200 against its plain version
    (cuSOLVER's eigh), 1e-10 relative, timed once each; then the api's
    float64 relaxation at n = m = 2100, k = 1 for ``WR_MC_BIG64_ITERS``
    iterations (``_wr_mc_big``)."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops.cones import k4_plan, project_psd, project_psd_plain

    d = 2 * WR_MC_BIG["n"]
    gen = torch.Generator().manual_seed(64)
    dev = torch.device("cuda", 0)
    T = torch.randn(1, d, d, generator=gen, dtype=torch.float64).to(dev)
    T = (T + T.transpose(-1, -2)) / 2
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    got = project_psd(T)
    torch.cuda.synchronize()
    k4_s = time.time() - t0
    launched = _launched_since(before)
    t0 = time.time()
    ref = project_psd_plain(T)
    torch.cuda.synchronize()
    r = dict(d=d, plan=k4_plan(1, d, "project", dtype=torch.float64), seconds=k4_s,
             plain_seconds=time.time() - t0, rel_err=rel_fro(got, ref),
             max_abs_err=float((got - ref).abs().max()),
             launches={x: v for x, v in launched.items() if v})
    log("mcwide64 K4_f64", json.dumps(r))
    assert r["rel_err"] <= 1e-10 and r["launches"].get("K4_f64"), r
    res["mcwide64"] = dict(k4=r, relaxation=_wr_mc_big("float64", WR_MC_BIG64_ITERS))


def phase_widerank(res):
    """Every rank omc runs through altmin and McCormick, on the card: the
    wide kernels' rows (K6's wide path; K9s's, K9a's and K9b's wide
    kernels) and the wide kernels beside the register and unrolled ones at
    the ranks both take, then the paths through the entry points, each
    launch of which counts: api.alternating_minimization at rank 20 on a
    1000 x 1000 instance in float32 and float64 against the CPU; a rank-12
    root visit (matrix_completion_branchandbound, root_only, then the
    solver's device bound against the host float64 certificate); the api's
    McCormick relaxation at k = 4 on config 3's instance in both dtypes
    against the CPU; and its McCormick B&B at k = 4 for ``WR_MC_BB_S`` s with
    sound bounds.  (Rank-k Shor past k = 4: the shorkwide phase; McCormick
    past n + m = 4096 through the driver: the mcflat phase.)"""
    import numpy as np
    import torch

    from omc_torch import api, kernels
    from omc_torch.sdp import relax

    gen = torch.Generator().manual_seed(21)
    dev = torch.device("cuda", 0)
    rows = {**_check_k6_wide(gen, dev), **_check_mc_wide(gen, dev)}
    for name, rs in rows.items():
        for row in rs:
            log(name, json.dumps(row))
    res.setdefault("kernels", {}).update(rows)
    failed = [(name, row) for name, rs in rows.items() for row in rs if not row["ok"]]
    # the wide kernels forced at the ranks the register and unrolled ones
    # take, held to their plain versions (their timings beside the others':
    # the widevsunrolled phase, on request)
    both = _check_wide_vs_unrolled(gen, dev, timed=False)
    failed += [("wide vs unrolled", r) for r in both if not r["ok"]]
    kernels.reset_launches()  # the paths' launches count from here
    row = {"wide_vs_unrolled": both}

    # the paths' CPU calls, one after another in a thread beside the card's
    A, idx = _wr_instance(WR_ALT["k"], WR_ALT["n"], WR_ALT["frac"], WR_ALT["seed"])
    n, k = WR_ALT["n"], WR_ALT["k"]
    U0 = np.linalg.qr(np.random.default_rng(3).standard_normal((n, k)))[0]
    A3, idx3 = _config3_instance()
    node4 = _mc_root(75, 4)

    def altmin(dts, d):
        out = api.alternating_minimization(A, n, k, idx, 80.0, U_initial=U0,
                                           max_iters=WR_ALT["iters"], eps=0.0, dtype=dts,
                                           device=d)
        return dict(out, objective=out["objectives"][-1])

    def mc4(dts, d):
        return api.matrix_completion_SDP_relaxation(node4, 75, 4, A3, idx3, 80.0,
                                                    use_disjunctive_cuts=False,
                                                    iters=WR_MC_ITERS, dtype=dts, device=d)

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu = {(fn.__name__, dts): pool.submit(fn, dts, "cpu")
           for fn in (altmin, mc4) for dts in ("float32", "float64")}

    # altmin at rank 20, 1000 x 1000 (K6's wide path)
    for dts, tol in (("float32", 1e-3), ("float64", 1e-9)):
        got, r = _wr_against_cpu(f"altmin {dts}", functools.partial(altmin, dts), tol,
                                 ("U", "V", "objective"), cpu["altmin", dts])
        r.update(objective=got["objective"], n_iters=got["n_iters"])
        _assert_launched(r["launches"], ("K6w" if dts == "float32" else "K6w_f64",))
        assert not r["launches"].get("K6") and not r["launches"].get("K6_f64"), r
        row[f"altmin_{dts}"] = r

    # a rank-12 root visit: matrix_completion_branchandbound (altmin at the
    # root on K6's wide path), then the solver's device bound against the
    # float64 certificate
    A12, idx12 = _wr_instance(WR_ROOT["k"], WR_ROOT["n"], WR_ROOT["frac"], WR_ROOT["seed"])
    sol, inst, secs = _solve(A12, idx12, 80.0, k=WR_ROOT["k"],
                             **dict(BENCH_KW, root_only=True, sdp_iters=WR_ROOT["visit"],
                                    sdp_iter_boost_max=1, batch_size=WR_ROOT["B"]))
    lower = float(inst["run_log"][-1]["lower"])
    r = dict(seconds=secs, lower=lower, objective=float(sol["objective"]),
             iters=int(inst["run_details"]["sdp_iters_total"]))
    assert np.isfinite(lower) and lower <= r["objective"] * (1 + 1e-9) + 1e-9, r
    solve, args, c = _admm_root(WR_ROOT["B"], iters=WR_ROOT["iters"], inst=(A12, idx12),
                                k=WR_ROOT["k"])
    _, o = solve(*args)
    o = {x: v.cpu().numpy() for x, v in o.items()}
    lb_host = relax.host_certified_bound(c["A"], c["mask"], args[2], o, c["gamma"], c["k"],
                                         c["ub_bar"])
    lb_dev = o["lb_dev"].astype(np.float64)
    r.update(lb_dev=lb_dev.tolist(), lb_host=lb_host.tolist())
    log("widerank root k=12", json.dumps(r))
    assert np.all(np.isfinite(lb_host)) and np.all(lb_dev <= lb_host), r
    row["root_k12"] = r

    # the McCormick relaxation at k = 4 on config 3's instance, both dtypes
    for dts, tol in (("float32", 1e-3), ("float64", 1e-8)):
        got, r = _wr_against_cpu(f"mccormick k=4 {dts}", functools.partial(mc4, dts), tol,
                                 ("lower_bound", "objective"), cpu["mc4", dts])
        r["lower_bound"] = got["lower_bound"]
        suf = "" if dts == "float32" else "_f64"
        _assert_launched(r["launches"], tuple(x + suf for x in ("K9sw", "K9aw", "K9bw")))
        assert not any(r["launches"].get(x + suf) for x in ("K9s", "K9a", "K9b")), r
        # a sound bound is at most the rank-4 optimum, itself at most the
        # rank-2 one
        assert np.isfinite(r["lower_bound"]) and r["lower_bound"] <= CONFIG3_OBJ, r
        row[f"mccormick_k4_{dts}"] = r

    # the McCormick B&B at k = 4
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A3, idx3, 80.0, k=4, **WR_MC_KW)
    launches = _launched_since(before)
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    br = _summary(sol, inst, secs)
    br.update(lowers=lowers)
    log("widerank mccormick k=4 branch", json.dumps(br))
    assert all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert lowers and all(x <= br["objective"] * (1 + 1e-9) + 1e-9 for x in lowers), br
    assert br["objective"] <= br["objective_initial"] + 1e-12, br
    _assert_launched(launches, ("K9sw", "K9aw", "K9bw", "K6"))
    row["mccormick_k4_branch"] = br

    pool.shutdown()
    res["widerank"] = row
    assert not failed, failed  # the kernel rows, after the paths have run


# ---- shorkwide: rank-k Shor past k = 4 ----

# (B, n = m, M5, k) of the wide rows: config 3's frontier at k = 5, 8 and 12
# (K7x at D = 6, 9, 13), config 4's root (n = m = 250) at its rank, k = 5,
# with the api call's M5; and config 3's frontier at k = 4, where the wide
# K7x, K8c and K8d run forced beside the register kernels
SKW_SHAPES = ((32, 75, 1024, 5), (32, 75, 1024, 8), (32, 75, 1024, 12), (1, 250, 1024, 5))
SKW_FORCED = (32, 75, 1024, 4)
# the paths: the api's rank-k Shor relaxation at k = 5 on config 3's
# instance in float64 (the first 256 [4]-minors, 100 iterations) against
# the CPU; the same at k = 5 on config 4's instance in float32 (the first
# 1,024 [4]-minors, 300 iterations; altmin's 20 iterations for the upper
# bound); the B&B at k = 5 with iterative Shor on config 3's instance on
# the shork phase's settings, 4 s
SKW_API = dict(k=5, minors=256, iters=100)
SKW_C4 = dict(k=5, n=250, frac=0.3, seed=1, minors=1024, iters=300, altmin_iters=20)
# config 4's root: the device bound within this of the host certificate of
# the same duals, relative to the certificate
SKW_C4_DEV_VS_HOST = 1e-3
SKW_BB_KW = dict(SHORK_KW, time_limit=4)
SKW_KEYS = ("K7t", "K7xw", "K8cw", "K8dw")
# the bars: float32 as the register kernels' rows (K8c and K8d 1e-5 of their
# plain versions, sums in another order; K7t and K7x the sign schedule's
# 1e-4 against a float64 eigh projection and 2e-4 of their plain
# versions); float64 1e-13 relative (the wide kernels' exact Jacobi
# against cuSOLVER's eigh, K8c's and K8d's sums in another order)
SKW_F64_BAR = 1e-13
# matrices whose Jacobi sweeps the float64 bound counts (the mirror's, on
# the first this many of the batch; their mean stands for the rest)
SKW_SWEEP_SAMPLE = 2048


def _first_minors(idx, count, present=4):
    """The first ``count`` 2x2 minors with ``present`` observed entries,
    in the enumeration order of
    ``generate_rank1_matrix_completion_Shor_constraints_indexes`` (rows
    pairs in order, then column pairs), without listing the rest."""
    import itertools

    import numpy as np

    obs = np.asarray(idx, dtype=bool)
    out = []
    for i1, i2 in itertools.combinations(range(obs.shape[0]), 2):
        both = np.flatnonzero(obs[i1] & obs[i2]).tolist()
        assert present == 4
        for j1, j2 in itertools.combinations(both, 2):
            out.append((i1, i2, j1, j2))
            if len(out) == count:
                return out
    return out


def _skw_jacobi_flops(t, D, N):
    """FP64 operations of K4s's Jacobi on the batch ``t`` (N D x D slots):
    the mirror's sweeps on its first ``SKW_SWEEP_SAMPLE`` matrices, their
    mean over all N, each sweep D (D - 1) / 2 rotations; then V max(w, 0) V'
    and the mixing, u-step and EMA.  Returns (flops, mean sweeps)."""
    from omc_torch.ops.jacobi import k4s_eigh

    sw = k4s_eigh(t.reshape(-1, D, D)[:SKW_SWEEP_SAMPLE])[2].double().mean().item()
    return (N * sw * D * (D - 1) / 2 * _jacobi_pair_flops(D)
            + N * (D * D * (D + 1) + 10 * D * D)), sw


def _skw_rows(c, sc, st, gen, dev, path=None):
    """K8c, K7t, K7x (slot mode) and K8d at one shape and dtype, each at
    the outputs of the step before it (K8c's), through the wrappers (the
    wide kernels past k = 4), or with ``path="wide"`` the wide kernels of
    K8c, K7x and K8d forced through their plans (each block built once per
    state, launched on its entry): errors against the plain versions, two
    launches' bits, the plans against the kernels' exports, CUDA-event ms
    and device ms (``_held_device_ms``), the plain version's and (K7t, K7x)
    the library's (cuSOLVER's eigh of the slot batch, chunked) ms over one
    warm call, and the bound; forced, also the register kernels' device ms
    on the same timed states."""
    import torch

    from omc_torch import kernels
    from omc_torch.ops import cones
    from omc_torch.ops.cones import project_psd_plain
    from omc_torch.ops.polar import project_psd_ns, project_psd_ns_small, truncated_matmul
    from omc_torch.sdp import shor_k as SK

    lib = kernels.library()
    dt = st.core.X.dtype
    f64 = dt == torch.float64
    e = dt.itemsize
    bar = SKW_F64_BAR if f64 else 1e-5
    peak = PEAK_FP64_FLOPS if f64 else PEAK_FP32_FLOPS
    meth = "eigh" if f64 else "ns"
    B, n, m, k, kp, C, Ms = SK._shapes(st)
    nm, M5 = n * m, sc.M5
    P = sum(t.shape[2] for t in (st.v1, st.v2, st.v3))
    sb = sc.sb
    A_ = float(sb.minor_mask.sum())   # active minors over the batch
    Ca = float(sb.coord_mask.sum())   # active coordinates
    Sa = float(sb.soc_mask.sum())     # active RSOC rows
    shape = dict(B=B, n=n, m=m, k=k, M5=M5, dtype=str(dt).split(".")[1], path=path)
    out = {}

    def k8c(x):  # launchers on the state x (and the EMAs a)
        if not path:
            return lambda: SK.shor_k_zstep(c, sc, x)
        p = SK._k8c_block(c, sc, x, dev, SK.k8c_plan(B, n, m, k, dt, path))
        return lambda: kernels.launch("K8cw", kernels.entry("omc_k8c_shor_k_zstep_wide", dt), p,
                                      dev)

    def k7x(x, a):
        if not path:
            return lambda: SK.xwh_step(c, sc, x, a, meth)
        p = SK._k7x_block(c, sc, x, a, dev, SK.k7x_plan(B * C, k + 1, dt, path))
        return lambda: kernels.launch("K7xw", kernels.entry("omc_k7x_xwh_wide", dt), p, dev)

    def k8d(x, a):
        if not path:
            return lambda: SK.shor_k_cone_step(c, sc, x, *a)
        p = SK._k8d_block(c, sc, x, *a, dev, SK.k8d_plan(B, n, m, k, C, Ms, dt, path))
        return lambda: kernels.launch("K8dw", kernels.entry("omc_k8d_shor_k_cone_wide", dt), p,
                                      dev)

    def timed(row, fn, plain):
        row.update(ms=cuda_time_ms(fn, reps=5), device_ms=_held_device_ms(fn, reps=5),
                   plain_ms=_tm(plain))

    def slot_errs(got, ref):
        # float64: each slot's (w, u) held together (u = t - w may be all
        # rounding noise where t lies in the cone), the EMA on its own
        return _slot_errs(got, ref, ((0, 1), (2,))) if f64 else _errs(got, ref)

    # K8c
    zs = lambda x: (x.Xt, x.core.X, x.core.Th, x.W, x.Wt, x.Hh, x.v1, x.v2, x.v3)  # noqa: E731
    sk, s2 = st.clone(), st.clone()
    k8c(sk)()
    k8c(s2)()
    torch.cuda.synchronize()
    rel, ab = _errs(zs(sk), SK.shor_k_zstep_plain(c, sc, st))
    plan = SK.k8c_plan(B, n, m, k, dt, path)
    glob = plan.get("kept") == "global"
    r = dict(**shape, plan=plan, rel_err=rel, max_abs_err=ab,
             deterministic=_same_bits(zs(sk), zs(s2)), library_ms=None,
             plan_matches_kernel=plan["smem_bytes"] == lib.omc_k8c_wide_smem_bytes(
                 n, k, plan["cols"], int(glob), e))
    s3 = st.clone()
    timed(r, k8c(s3), lambda: SK.shor_k_zstep_plain(c, sc, st))
    r["ok"] = r["rel_err"] <= bar and r["deterministic"] and r["plan_matches_kernel"]
    # values per slot: the X and Theta blocks of w1/u1, Xt_prev, W >= 0,
    # Wt >= 0, the link rows, the entry and coordinate constants, Theta's
    # Schur complement, v's diagonal, the masks, the scalars; out Xt, X,
    # Theta, W, Wt, H, v; per active minor and term the 14 entries of w5/u5
    # the adjoint reads, per active coordinate k^2 + k entries of wx/ux, per
    # active RSOC row 2 of wr/ur and its mask; int32 the entry tables, v's
    # pointers and the 9 list entries of each active minor.  The kept values
    # in the workspace are written and read once where the plan puts them
    # there (they are part of this kernel's traffic, not of the function's:
    # the bound leaves them out)
    rd = (2 * (nm + m * m) + k * nm + 2 * nm + 2 * k * C + 2 * m + 2 * C + 3 * nm + 4 * C
          + m + P + C + 4)
    wr = k * nm + nm + m * m + nm + (k + kp) * C + k * P
    with_bound(r, e * (B * (rd + wr) + A_ * k * 28 + Ca * 2 * (k * k + k) + Sa * 5 + 2 * nm)
               + 4 * (B * (3 * nm + 1 + P + 3) + 9 * A_),
               B * nm * (12 * k + 25) + 30 * k * A_ + 20 * Ca, peak)
    out["K8cw"] = r

    # K7t at K8c's primal (its one kernel at every k), and K7x
    for name, w_, u_, acc_shape, step, plain_step, D, N in (
            ("K7t", "w5", "u5", sk.u5.shape,
             lambda x, a: lambda: SK.minor_k_step(c, sc, x, a, meth), SK.minor_k_step_plain, 5,
             B * M5 * k),
            ("K7xw", "wx", "ux", sk.ux.shape, k7x, SK.xwh_step_plain, k + 1, B * C)):
        if name == "K7t" and path:
            continue
        acc = torch.randn(acc_shape, generator=gen, dtype=torch.float64).to(dev, dt) * 0.1
        runs = [(sk.clone(), acc.clone()) for _ in range(2)]
        for x, a in runs:
            step(x, a)()
        torch.cuda.synchronize()
        seen = {}

        def keep(proj):
            def f(t):
                seen["t"] = t
                return proj(t)
            return f

        got = (getattr(runs[0][0], w_), getattr(runs[0][0], u_), runs[0][1])
        got_b = (getattr(runs[1][0], w_), getattr(runs[1][0], u_), runs[1][1])
        if f64:
            ref = plain_step(c, sc, sk, acc, keep(project_psd_plain))
            plain = lambda: plain_step(c, sc, sk, acc, project_psd_plain)  # noqa: E731
        else:
            ref = plain_step(c, sc, sk, acc, keep(project_psd_ns_small))
            plain = lambda: plain_step(c, sc, sk, acc, project_psd_ns_small)  # noqa: E731
        t = seen["t"]
        rel, ab = slot_errs(got, ref)
        r = dict(**shape, D=D, N=N, rel_err=rel, max_abs_err=ab,
                 deterministic=_same_bits(got, got_b))
        if name == "K7t":
            pl = SK.k7t_plan(N, dt)
            r["plan_matches_kernel"] = (pl["threads"] == lib.omc_k7t_threads(e)
                                        and pl["smem"] == lib.omc_k7t_smem_bytes(e))
        else:
            pl = SK.k7x_plan(N, D, dt, path)
            r["plan_matches_kernel"] = (pl["path"] == SK.WIDE and pl["work_bytes"] == 0 and pl[
                "smem"] == lib.omc_k7x_wide_smem_bytes(e, D, pl["warps"]))
        r["plan"] = pl
        if not f64:
            # the sign schedule's bars against a float64 eigh projection of
            # the same slot values, the 16-bit truncated-product control
            # failing them
            exact = plain_step(c, sc, sk, acc, lambda x: project_psd_plain(x.double()).float())[0]
            ctl = plain_step(c, sc, sk, acc,
                             lambda x: project_psd_ns(x, matmul=truncated_matmul(16)))[0]
            r.update(plain_vs_eigh=rel_fro(ref[0], exact), kernel_vs_eigh=rel_fro(got[0], exact),
                     control_16bit_vs_eigh=rel_fro(ctl, exact))
            r["ok"] = (r["plain_vs_eigh"] <= 1e-4 and r["kernel_vs_eigh"] <= 1e-4
                       and r["rel_err"] <= 2e-4 and not r["control_16bit_vs_eigh"] <= 1e-4)
        else:
            r["ok"] = r["rel_err"] <= bar
        r["ok"] = r["ok"] and r["deterministic"] and r["plan_matches_kernel"]
        s8, a8 = sk.clone(), acc.clone()
        timed(r, step(s8, a8), plain)
        r["library_ms"] = _tm(lambda: cones.eigh_plain(t))
        # values: w/u/acc read and written, the masks, the gathered entries
        # of Xt, Wt and v (K7t) or H (K7x), sS and rho; int32 K7t's records,
        # K7x's coord_flat.  FP32: the sign schedule's symmetric products
        # (D (D + 1) / 2 entries of D FMAs) and the mixing, epilogue and EMA;
        # FP64: the Jacobi sweeps this batch needs
        if name == "K7t":
            vals = N * 6 * 25 + B * M5 + _k7t_gathered(sc, nm) + 2 * B
            ints = 16 * B * M5
        else:
            fl = sb.coord_flat.long()
            gathered = k * torch.unique(torch.arange(B, device=fl.device)[:, None] * nm
                                        + fl).numel()
            vals = N * (6 * D * D + 1) + gathered + B * (k + kp) * C + 2 * B
            ints = N
        if f64:
            flops, r["sweeps_mean"] = _skw_jacobi_flops(t, D, N)
        else:
            flops = N * (SIGN_PRODUCTS * D * D * (D + 1) + 3 * D * D)
        with_bound(r, e * vals + 4 * ints, flops, peak)
        out[name] = r

    # K8d at K8c's primal
    accs = [torch.randn(x.shape, generator=gen, dtype=torch.float64).to(dev, dt) * 0.1
            for x in (sk.ur, sk.ul, sk.uwl)]
    kd = lambda x: (x.wr, x.ur, x.wl, x.ul, x.wwl, x.uwl, x.wp, x.up, x.wq, x.uq)  # noqa: E731
    runs = [(sk.clone(), [a.clone() for a in accs]) for _ in range(2)]
    for x, a in runs:
        k8d(x, a)()
    torch.cuda.synchronize()
    ref = SK.shor_k_cone_step_plain(c, sc, sk, *accs)
    (sd, ad), (sd2, ad2) = runs
    got = kd(sd) + tuple(ad)
    if f64:
        rel, ab = _slot_errs(got, ref, ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10,), (11,),
                                        (12,)))
    else:
        rel, ab = _errs(got, ref)
    plan = SK.k8d_plan(B, n, m, k, C, Ms, dt, path)
    r = dict(**shape, C=C, Ms=Ms, plan=plan, rel_err=rel, max_abs_err=ab,
             deterministic=_same_bits(got, kd(sd2) + tuple(ad2)), library_ms=None,
             plan_matches_kernel=plan.get("path") == SK.WIDE and plan["grid"] == lib.omc_k8d_grid_x(
                 B, n, m, C, Ms, plan["ipc"], e))
    s10, a10 = sk.clone(), [a.clone() for a in accs]
    timed(r, k8d(s10, a10), lambda: SK.shor_k_cone_step_plain(c, sc, sk, *accs))
    r["ok"] = r["rel_err"] <= bar and r["deterministic"] and r["plan_matches_kernel"]
    # values per slot: X, W, Theta's diagonal, Wt, H, the RSOC rows with
    # their EMA and mask, the link rows with their EMAs, W >= 0, Wt >= 0,
    # the coordinate mask, the scalars; out the same slots and EMAs; int32
    # soc_flat and coord_flat
    rdv = (2 * nm + m + (k + kp) * C + 9 * Ms + Ms + 2 * m + 2 * C + 2 * nm + 2 * k * C
           + 2 * C + C + 4)
    wrv = 9 * Ms + 3 * m + 3 * C + 2 * nm + 2 * k * C
    with_bound(r, e * B * (rdv + wrv) + 4 * B * (Ms + C),
               B * (40 * Ms + 6 * nm + (k + kp + 6) * C + 5 * k * C), peak)
    out["K8dw"] = r
    if path:  # the register kernels on the wide rows' timed states, timed beside
        for key, fn in (("K8cw", lambda: SK.shor_k_zstep(c, sc, s3)),
                        ("K7xw", lambda: SK.xwh_step(c, sc, s8, a8, meth)),
                        ("K8dw", lambda: SK.shor_k_cone_step(c, sc, s10, *a10))):
            out[key]["register_device_ms"] = _held_device_ms(fn, reps=5)
            out[key]["wide_over_register"] = out[key]["device_ms"] / out[key]["register_device_ms"]
    return out


def _check_shork_wide(gen, dev):
    """The wide rows at ``SKW_SHAPES`` in float32 and float64 (the float64
    rows on float64 copies of the float32 inputs, ``_shork64_of``), and the
    wide kernels forced at ``SKW_FORCED`` in float32 beside the register
    kernels.  Returns {row key: [rows]}."""
    out = {}
    for B, n, M5, k in SKW_SHAPES + (SKW_FORCED,):
        c32, sc32, st32 = _shor_k_inputs(B, n, n, 8, M5, gen, dev, k=k, on_device=True)
        forced = (B, n, M5, k) == SKW_FORCED
        for c, sc, st in ((c32, sc32, st32),) if forced else (
                (c32, sc32, st32), _shork64_of(c32, sc32, st32)):
            f64 = st.core.X.dtype != st32.core.X.dtype
            rows = _skw_rows(c, sc, st, gen, dev, path="wide" if forced else None)
            for name, r in rows.items():
                key = ("K7t_wide" if name == "K7t" else name) + ("_f64" if f64 else "")
                if forced:
                    key = name + "_forced_k4"
                log(key, json.dumps(r))
                out.setdefault(key, []).append(r)
        del c32, sc32, st32
    return out


def _skw_api_k5(A, idx, dts, device="cuda"):
    """The api's rank-k Shor relaxation at k = 5 on config 3's instance,
    root box, the first ``SKW_API["minors"]`` [4]-minors."""
    import numpy as np

    from omc_torch import api
    from omc_torch.sdp.shor import shor_soc_complement
    from omc_torch.tree import BBNode, ShorInfo, root_box

    n, k = A.shape[0], SKW_API["k"]
    minors = _first_minors(idx, SKW_API["minors"])
    lo, hi = root_box(n, k)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[],
                  Shor_info=ShorInfo(constraints_indexes=minors,
                                     SOC_constraints_indexes=shor_soc_complement(n, n, minors)))
    return api.matrix_completion_SDP_relaxation(node, n, k, A, idx, 80.0,
                                                add_Shor_valid_inequalities=True,
                                                iters=SKW_API["iters"], dtype=dts, device=device)


def _skw_config4_root():
    """Config 4's instance (rank 5, 250 x 250, 30% observed) at its root,
    rank k = 5 with the first ``SKW_C4["minors"]`` [4]-minors, in float32
    for ``SKW_C4["iters"]`` iterations through the rank-k Shor solver as
    the api calls it; its device bound, the host float64 certificate of
    its duals and altmin's objective (``SKW_C4["altmin_iters"]``
    iterations from the top singular vectors of the observed entries)."""
    import numpy as np
    import torch

    from omc_torch import api
    from omc_torch.data import generate_matrix_completion_data
    from omc_torch.sdp.shor import shor_soc_complement
    from omc_torch.sdp.shor_k import (host_certified_bound_shor_k, init_shor_k_state,
                                      make_shor_k_solver, pack_shor_k_batch)
    from omc_torch.solve import _pack_batch
    from omc_torch.tree import BBNode, root_box

    n, k, gamma = SKW_C4["n"], SKW_C4["k"], 80.0
    A, idx = generate_matrix_completion_data(k, n, n, int(SKW_C4["frac"] * n * n),
                                             seed=SKW_C4["seed"])
    mask = idx.astype(np.float64)
    U0 = np.linalg.svd(A * mask)[0][:, :k]
    t0 = time.time()
    alt = api.alternating_minimization(A, n, k, idx, gamma, U_initial=U0,
                                       max_iters=SKW_C4["altmin_iters"], dtype="float32")
    alt_s = time.time() - t0
    minors = _first_minors(idx, SKW_C4["minors"])
    socs = shor_soc_complement(n, n, minors)
    lo, hi = root_box(n, k)
    node = BBNode(node_id=1, parent_id=0, U_lower=lo, U_upper=hi, LB=-np.inf, depth=0, cuts=[])
    dev = torch.device("cuda", 0)
    ub_bar = 0.5 * float(np.sum(mask * A * A))
    M5 = len(minors)
    batch = _pack_batch([node], 1, 1, n, k, None, np.float32)
    sbh = pack_shor_k_batch(n, n, [minors], [socs], M5, n * n)
    solve = make_shor_k_solver(n, n, k, 1, M5, n * n, gamma, iters=SKW_C4["iters"],
                               dtype=torch.float32)
    st0 = init_shor_k_state(1, n, n, k, 1, M5, n * n, torch.float32, device=dev,
                            sX=max(1.0, float(np.max(np.abs(A)))),
                            sT=max(1.0, 2.0 * gamma * ub_bar / (4.0 * n)))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    t0 = time.time()
    _, out = solve(f(A), f(mask), batch, sbh, ub_bar, st0)
    torch.cuda.synchronize()
    secs = time.time() - t0
    out = {x: v.cpu().numpy() for x, v in out.items()}
    lb_host = host_certified_bound_shor_k(A, mask, batch, sbh, out, gamma, k, ub_bar)
    return dict(n=n, k=k, M5=M5, iters=int(out["iters_run"][0]), seconds=secs,
                lb_dev=float(out["lb_dev"][0]), lb_host=float(lb_host[0]),
                altmin_objective=float(alt["objectives"][-1]), altmin_seconds=alt_s)


def phase_shorkwide(res):
    """Rank-k Shor past k = 4 on the card: the wide rows (K8c, K7t, K7x and
    K8d at ``SKW_SHAPES`` in both dtypes, held to their plain versions,
    twice for their bits, with CUDA-event and device ms, the bound, the
    plain version's and the library's ms; the wide K7x, K8c and K8d forced
    at k = 4 beside the register kernels), then the paths, whose launches
    count: the api's rank-k Shor relaxation at k = 5 on config 3's instance
    in float64 against the same call on the CPU (1e-8 relative); config 4's
    root at k = 5 in float32 (its device bound no higher than the host
    float64 certificate and within ``SKW_C4_DEV_VS_HOST`` of it, the
    certificate no higher than altmin's objective); the
    B&B at k = 5 with iterative Shor on config 3's instance for 4 s (every
    lower bound at most ``CONFIG3_OBJ``, a rank-5 optimum being at most the
    rank-2 incumbent), through K7t, K7x, K8c and K8d's wide kernels."""
    import numpy as np
    import torch

    from omc_torch import kernels

    gen = torch.Generator().manual_seed(22)
    dev = torch.device("cuda", 0)
    rows = _check_shork_wide(gen, dev)
    res.setdefault("kernels", {}).update(rows)
    failed = [(name, r) for name, rs in rows.items() for r in rs if not r["ok"]]
    kernels.reset_launches()  # the paths' launches count from here
    row = {}

    # the api at k = 5 on config 3's instance, float64, against the CPU
    A3, idx3 = _config3_instance()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    cpu = pool.submit(_skw_api_k5, A3, idx3, "float64", "cpu")
    got, r = _wr_against_cpu("shorkwide api k=5 float64",
                             functools.partial(_skw_api_k5, A3, idx3, "float64"), 1e-8,
                             ("lower_bound", "objective"), cpu)
    pool.shutdown()
    r.update(lower_bound=got["lower_bound"], objective=got["objective"])
    _assert_launched(r["launches"], tuple(x + "_f64" for x in SKW_KEYS + ("K2", "K3", "K4")))
    assert not any(r["launches"].get(x) for x in SKW_KEYS + ("K1",)), r
    assert np.isfinite(r["lower_bound"]) and r["lower_bound"] <= CONFIG3_OBJ, r
    row["api_k5_float64"] = r

    # config 4's root at k = 5, float32
    before = dict(kernels.LAUNCHES)
    r = _skw_config4_root()
    r["launches"] = {x: v for x, v in _launched_since(before).items() if v}
    r["rel_dev_vs_host"] = (r["lb_host"] - r["lb_dev"]) / abs(r["lb_host"])
    log("shorkwide config4 root k=5", json.dumps(r))
    assert np.isfinite(r["lb_host"]) and r["lb_dev"] <= r["lb_host"], r
    assert r["lb_host"] <= r["altmin_objective"], r
    # the device's dual and bound formula against the host's: after 300
    # float32 iterations the bound is far below the objective, so the
    # ordering above holds for nearly any dual; the two bounds of one dual
    # must agree
    assert r["rel_dev_vs_host"] <= SKW_C4_DEV_VS_HOST, r
    _assert_launched(r["launches"], SKW_KEYS + ("K1", "K2", "K3", "K6"))
    row["config4_root_k5"] = r

    # the B&B at k = 5 with iterative Shor on config 3's instance
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A3, idx3, 80.0, k=5, **SKW_BB_KW)
    launches = _launched_since(before)
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    br = _summary(sol, inst, secs)
    br.update(lowers=lowers, launches={x: v for x, v in launches.items() if v},
              growths=int(inst["run_details"]["shor_growths"]))
    log("shorkwide branch k=5", json.dumps(br))
    assert lowers and all(b >= a - 1e-9 for a, b in zip(lowers, lowers[1:])), lowers
    assert all(x <= CONFIG3_OBJ * (1 + 1e-9) for x in lowers), br
    assert all(x <= br["objective"] * (1 + 1e-9) + 1e-9 for x in lowers), br
    _assert_launched(launches, SKW_KEYS + ("K1", "K2", "K3", "K4s") + BOUND_KEYS)
    row["branch_k5"] = br
    res["shorkwide"] = row
    assert not failed, failed  # the kernel rows, after the paths have run


# ---- mcflat: McCormick past batch x (n + m)^2 >= 2^31 ----

# (B, n, m, k) of the K9a/K9b rows held against the same kernel on the
# batch's two halves (each below 2^31 flat entries): the unrolled kernels at
# 128 slots of n + m = 4,096 (exactly 2^31) and the wide ones at the
# driver's default batch of 64 at n + m = 5,796 (2,149,991,424)
MCF_HALVES = ((128, 64, 4032, 1), (64, 64, 5732, 1))
# one node past n + m = 46,340 (its own (n + m)^2 = 2,147,580,964 > 2^31,
# n small): K9a and K9b (their wide kernels) in both dtypes, K2 and K3 in
# float32, against their plain versions on a gathered sub-problem
MCF_ONE = dict(n=8, m=46334, k=1, L=8)
# the columns of the gathered sub-problem: MCF_SPREAD spread over Theta's
# block and its last MCF_TAIL (which hold every entry past 2^31)
MCF_SPREAD, MCF_TAIL = 240, 16
# K1 alone at a McCormick batch past 2^31 (1,024 slots at n + m = 1,449:
# 2,149,991,424 entries), against its two halves
MCF_K1 = dict(B=1024, d=1449)
# the bytes a McCormick solver call takes a flat entry: (B, n, m, iters)
# at n + m = 1,449 where it fits, float32 and float64
MCF_ITER = {"float32": (128, 64, 1385, 2), "float64": (8, 64, 1385, 2)}
# the driver at a batch_size past 2^31 (1,024 x 1,450^2): a rank-1 100 x
# 1,350 instance from omc_torch.data, 30% observed, one root visit of 20
# iterations (at 64 x 5,800^2, a 300 x 5,500 instance, the visit took
# 38-44 s, its float64 host certificate of the 5,800^2 block 26-30 s of
# them; the visit runs one slot, so the batch only passes the gate)
MCF_DRIVER = dict(n=100, m=1350, frac=0.3, seed=5)
MCF_DRIVER_KW = dict(MC_KW, sdp_iters=20, root_only=True, max_refines=0, time_limit=60,
                     batch_size=1024)


def _mcf_mc(B, n, m, k, dt, dev, seed, share):
    """A random McCormick state, node boxes, data and the constants K9a and
    K9b read at (B, n, m, k) in ``dt``, drawn on the card (a seeded CUDA
    generator) field by field; with ``share`` w1 and u1 are the last and the
    first B slots of one buffer of B + 1 (u1's slot b is w1's slot b - 1:
    K9a and K9b only read them), so the batch's (n + m)^2 blocks take one
    copy, not two.  The constants are make_mc_consts' at one column, with
    the full mask and mask A: they hold no (B, m, m) or (B, n + m, n + m)
    tensor (only the plain version reads those).  Theta is left unset (K9a
    writes it).  Returns (c, st, A, mask, generator)."""
    import dataclasses

    import torch

    from omc_torch.sdp.mccormick import MCBatch, MCState, init_mc_state, make_mc_consts

    g = torch.Generator(device=dev).manual_seed(seed)
    q, D = k * (k + 1) // 2, n + m

    def r(*s):
        return torch.empty(s, dtype=dt, device=dev).normal_(0.0, 0.3, generator=g)

    def uni(lo_, hi_, *s):
        return torch.empty(s, dtype=dt, device=dev).uniform_(lo_, hi_, generator=g)

    if share:
        buf = r(B + 1, D, D)
        w1, u1 = buf[1:], buf[:-1]
    else:
        w1, u1 = r(B, D, D), r(B, D, D)
    st = MCState(w1=w1, w2=r(B, n + k, n + k), w3=r(B, n, n), w4=r(B), wsoc=r(B, k, 1 + n),
                 wbox=r(B, n, k), wmc=r(B, 4, n, q), worth=r(B, q), u1=u1,
                 u2=r(B, n + k, n + k), u3=r(B, n, n), u4=r(B), usoc=r(B, k, 1 + n),
                 ubox=r(B, n, k), umc=r(B, 4, n, q), uorth=r(B, q), X=r(B, n, m),
                 Y=r(B, n, n), Th=torch.empty((B, m, m), dtype=dt, device=dev), U=r(B, n, k),
                 t=r(B, n, q), rho=uni(5.0, 15.0, B),
                 sX=torch.full((B,), 2.5, dtype=dt, device=dev),
                 sT=torch.full((B,), 1.7, dtype=dt, device=dev))
    lo = uni(-1.0, 0.5, B, n, k)
    hi = torch.minimum(lo + uni(0.05, 1.0, B, n, k), torch.ones_like(lo))
    A = r(n, m) / 0.3
    mask = (uni(0.0, 1.0, n, m) < 0.5).to(dt)
    batch = MCBatch(lo, hi)
    c1 = make_mc_consts(A[:, :1].contiguous(), mask[:, :1].contiguous(), batch,
                        init_mc_state(B, n, 1, k, dt, device=dev), n, 1, k, 80.0, 1.6, dt)
    c = dataclasses.replace(c1, mask=mask, maskA=(mask * A).contiguous(), m=m, cX=None,
                            cTh=None, offs=None)
    return c, st, A, mask, g


def _mcf_slots(c, st, sl):
    """The constants K9a and K9b read and the state of the batch's slots
    ``sl``: views, no copy."""
    import dataclasses

    from omc_torch.sdp.mccormick import MCState

    return (dataclasses.replace(c, batch=c.batch.map(lambda x: x[sl]), Mc=c.Mc[sl],
                                Si=c.Si[sl], Gc=c.Gc[sl]),
            MCState(*[x[sl] for x in st.leaves()]))


def _mcf_k9_plan_ok(plan, B, n, m, k, e):
    """K9a's and K9b's grids of ``plan`` against the kernels' exports."""
    from omc_torch import kernels

    lib = kernels.library()
    k9a = lib.omc_k9a_wide_grid_x if plan.get("path") == "wide" else lib.omc_k9a_grid_x
    return (plan["k9a_grid"] == k9a(B, n, m)
            and plan["k9b_grid"] == lib.omc_k9b_grid_x(B, n, m, k, plan["qpc"], e))


def _mcf_k9_halves(B, n, m, k, dt, dev, seed):
    """K9a, then K9b at its outputs (with the running means), on a batch at
    or past 2^31 flat entries: the whole batch's outputs against the same
    kernel's on its two halves, bit for bit; the slots from the one holding
    entry 2^31 - 1 on against their plain version on those slots alone
    (constants of their own, at 1e-5 relative in float32 and the rows'
    float64 bars: 1e-10 unrolled, 1e-12 wide); the grids against the
    kernels' exports; CUDA-event and held-stream device ms and the bytes
    bound of the whole batch, the plain version's ms on the tail slots."""
    import dataclasses

    import torch

    from omc_torch.sdp import mccormick as MC
    from omc_torch.sdp.mccormick import MCState, make_mc_consts

    f64 = dt == torch.float64
    e, D, h = dt.itemsize, n + m, B // 2
    c, st, A, mask, g = _mcf_mc(B, n, m, k, dt, dev, seed, share=True)
    plan = MC.k9_plan(B, n, m, k, dt)
    wide = plan.get("path") == "wide"
    bar = (1e-12 if wide else 1e-10) if f64 else 1e-5
    peak = PEAK_FP64_FLOPS if f64 else PEAK_FP32_FLOPS
    halves = (slice(0, h), slice(h, B))
    tail = slice(min(B - 1, (2 ** 31 - 1) // (D * D)), B)
    shape = dict(B=B, n=n, m=m, k=k, dtype=str(dt).split(".")[1], flat=B * D * D, wide=wide,
                 tail_slots=[tail.start, B])
    c_t, st_t = _mcf_slots(c, st, tail)
    c_t = make_mc_consts(A, mask, c_t.batch, st_t, n, m, k, 80.0, 1.6, dt)

    # K9a: the halves, then the whole batch
    zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
    for sl in halves:
        MC.mc_zstep(*_mcf_slots(c, st, sl))
    torch.cuda.synchronize()
    keep = [x.clone() for x in zs(st)]
    MC.mc_zstep(c, st)
    torch.cuda.synchronize()
    ra = dict(**shape, same_bits_as_halves=_same_bits(zs(st), keep))
    del keep
    ref = MC.mc_zstep_plain(c_t, st_t)
    ra["tail_rel_err"], ra["tail_max_abs_err"] = _errs(zs(st_t), ref)
    del ref
    ra["tail_plain_ms"] = _tm(lambda: MC.mc_zstep_plain(c_t, st_t), warm=True)
    run = lambda: MC.mc_zstep(c, st)  # noqa: E731
    ra["ms"] = cuda_time_ms(run, reps=3, warmup=1)
    ra["device_ms"] = _held_device_ms(run, reps=3)
    vals, ops = _k9a_work(B, n, m, k)
    with_bound(ra, e * vals, ops, peak)
    ra["plan_matches_kernel"] = _mcf_k9_plan_ok(plan, B, n, m, k, e)
    ra["ok"] = (ra["same_bits_as_halves"] and ra["tail_rel_err"] <= bar
                and ra["plan_matches_kernel"])
    log("mcflat K9a", json.dumps(ra))

    # K9b at K9a's outputs: the halves, then (its in-place slots and running
    # means restored) the whole batch
    acc = [torch.empty_like(x).normal_(0.0, 0.1, generator=g) for x in (st.umc, st.uorth)]
    beta = 0.25
    small = lambda: [getattr(st, f) for f in MC._REST] + acc  # noqa: E731
    pre = [x.clone() for x in small()]
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    for sl in halves:
        c_, s_ = _mcf_slots(c, st, sl)
        MC.mc_cone_step(c_, s_, tuple(t[sl] for t in ts), [a[sl] for a in acc], beta)
    torch.cuda.synchronize()
    keep = [x.clone() for x in small()]
    for x, v in zip(small(), pre):
        x.copy_(v)
    ts2 = tuple(torch.empty_like(x) for x in ts)
    MC.mc_cone_step(c, st, ts2, acc, beta)
    torch.cuda.synchronize()
    rb = dict(**shape, same_bits_as_halves=_same_bits(ts2, ts) and _same_bits(small(), keep))
    got = [t[tail] for t in ts2] + [x[tail] for x in small()]
    del ts, keep
    nr = len(MC._REST)
    st_pre = MCState(*[pre[MC._REST.index(f.name)][tail] if f.name in MC._REST
                       else getattr(st_t, f.name) for f in dataclasses.fields(MCState)])
    acc_pre = [x[tail] for x in pre[nr:]]
    t1, t2, t3, rest, acc_p = MC.mc_cone_step_plain(c_t, st_pre, acc_pre, beta)
    rb["tail_rel_err"], rb["tail_max_abs_err"], _ = _k9b_errs(
        c_t, st_pre, got, (t1, t2, t3) + tuple(rest) + tuple(acc_p), beta)
    del t1, t2, t3, rest, acc_p, got
    rb["tail_plain_ms"] = _tm(lambda: MC.mc_cone_step_plain(c_t, st_pre, acc_pre, beta),
                              warm=True)
    run = lambda: MC.mc_cone_step(c, st, ts2, acc, beta)  # noqa: E731
    rb["ms"] = cuda_time_ms(run, reps=3, warmup=1)
    rb["device_ms"] = _held_device_ms(run, reps=3)
    vals, ops = _k9b_work(B, n, m, k)
    with_bound(rb, e * vals, ops, peak)
    rb["plan_matches_kernel"] = ra["plan_matches_kernel"]
    rb["ok"] = (rb["same_bits_as_halves"] and rb["tail_rel_err"] <= bar
                and rb["plan_matches_kernel"])
    log("mcflat K9b", json.dumps(rb))
    return ra, rb


def _mcf_once(fn):
    """One call of ``fn`` (a check's own launch, at one node past n + m =
    46,340, where a launch takes 15 ms to 3 s) timed by CUDA events around
    it: the row's ``ms`` and, a lone launch on an idle stream, its
    ``device_ms``."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _mcf_cols(n, m, dev):
    """The gathered sub-problem's columns of the m block (``MCF_SPREAD``
    spread over it and its last ``MCF_TAIL``) and their rows and columns of
    the (n + m)^2 blocks."""
    import torch

    S = torch.cat([torch.linspace(0, m - MCF_TAIL - 1, MCF_SPREAD).round().long(),
                   torch.arange(m - MCF_TAIL, m)]).unique().to(dev)
    return S, torch.cat([torch.arange(n, device=dev), n + S])


def _mcf_gather(x, n, m, S, idx):
    """x's entries at the gathered sub-problem: an (n + m)^2 block at rows
    and columns ``idx``, an m^2 block at S, an (n, m) block at columns S;
    any other tensor as a copy."""
    D = n + m
    if x.ndim >= 2 and tuple(x.shape[-2:]) == (D, D):
        return x.index_select(-2, idx).index_select(-1, idx)
    if x.ndim >= 2 and tuple(x.shape[-2:]) == (m, m):
        return x.index_select(-2, S).index_select(-1, S)
    if x.ndim >= 2 and tuple(x.shape[-2:]) == (n, m):
        return x.index_select(-1, S)
    return x.clone()


def _mcf_gathered(obj, n, m, S, idx):
    """A state (dataclass of tensors) or a tuple of tensors at the gathered
    sub-problem."""
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return type(obj)(*[_mcf_gather(getattr(obj, f.name), n, m, S, idx)
                           for f in dataclasses.fields(obj)])
    return [_mcf_gather(x, n, m, S, idx) for x in obj]


def _mcf_fits(nbytes):
    """Whether ``nbytes`` more (and 2 GiB of slack) fit in the card's free
    memory; the free bytes."""
    import torch

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    return nbytes + 2 ** 31 <= free, free


def _mcf_one_k9(dt, dev):
    """K9a and K9b (their wide kernels) at one node past n + m = 46,340
    (MCF_ONE) in ``dt`` against their plain versions on the gathered
    sub-problem of the same node (``_mcf_cols``: every entry of its rows and
    columns is the same function of the same inputs as in the whole node;
    the sums over rows run over the node's n rows either way), K9b with the
    running means; bars 1e-5 relative in float32, 1e-12 in float64 (the
    wide rows').  Where the node's blocks do not fit on the card, says so
    with the bytes instead."""
    import torch

    from omc_torch.sdp import mccormick as MC
    from omc_torch.sdp.mccormick import MCState, make_mc_consts

    n, m, k = MCF_ONE["n"], MCF_ONE["m"], MCF_ONE["k"]
    D, e = n + m, dt.itemsize
    f64 = dt == torch.float64
    need = e * (3 * D * D + m * m)  # w1, u1, t1 and Theta
    fits, free = _mcf_fits(need)
    shape = dict(B=1, n=n, m=m, k=k, dtype=str(dt).split(".")[1], flat=D * D)
    if not fits:
        r = dict(**shape, skipped=f"needs {need} bytes of w1, u1, t1 and Theta, {free} free")
        log("mcflat K9 one node", json.dumps(r))
        return r, r
    bar, peak = (1e-12, PEAK_FP64_FLOPS) if f64 else (1e-5, PEAK_FP32_FLOPS)
    c, st, A, mask, g = _mcf_mc(1, n, m, k, dt, dev, 46342 + e, share=False)
    S, idx = _mcf_cols(n, m, dev)
    st_s = _mcf_gathered(st, n, m, S, idx)
    c_s = make_mc_consts(A[:, S].contiguous(), mask[:, S].contiguous(), c.batch, st_s, n,
                         len(S), k, 80.0, 1.6, dt)
    zs = lambda x: (x.X, x.Y, x.Th, x.U, x.t)  # noqa: E731
    ra = dict(**shape, sub_columns=len(S))
    ra["ms"] = ra["device_ms"] = _mcf_once(lambda: MC.mc_zstep(c, st))
    ra["rel_err"], ra["max_abs_err"] = _errs(_mcf_gathered(zs(st), n, m, S, idx),
                                             MC.mc_zstep_plain(c_s, st_s))
    ra["sub_plain_ms"] = _tm(lambda: MC.mc_zstep_plain(c_s, st_s))
    vals, ops = _k9a_work(1, n, m, k)
    with_bound(ra, e * vals, ops, peak)
    ra["plan_matches_kernel"] = _mcf_k9_plan_ok(MC.k9_plan(1, n, m, k, dt), 1, n, m, k, e)
    ra["ok"] = ra["rel_err"] <= bar and ra["plan_matches_kernel"]
    log("mcflat K9a one node", json.dumps(ra))

    acc = [torch.empty_like(x).normal_(0.0, 0.1, generator=g) for x in (st.umc, st.uorth)]
    beta = 0.25
    st_s = _mcf_gathered(st, n, m, S, idx)  # K9a's outputs, K9b's slots before it
    acc_s = [a.clone() for a in acc]
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    rb = dict(**shape, sub_columns=len(S))
    rb["ms"] = rb["device_ms"] = _mcf_once(lambda: MC.mc_cone_step(c, st, ts, acc, beta))
    got = _mcf_gathered(list(ts) + [getattr(st, f) for f in MC._REST] + acc, n, m, S, idx)
    t1, t2, t3, rest, acc_p = MC.mc_cone_step_plain(c_s, st_s, acc_s, beta)
    rb["rel_err"], rb["max_abs_err"], _ = _k9b_errs(c_s, st_s, got, (t1, t2, t3) + tuple(rest)
                                                    + tuple(acc_p), beta)
    rb["sub_plain_ms"] = _tm(lambda: MC.mc_cone_step_plain(c_s, st_s, acc_s, beta))
    vals, ops = _k9b_work(1, n, m, k)
    with_bound(rb, e * vals, ops, peak)
    rb["plan_matches_kernel"] = ra["plan_matches_kernel"]
    rb["ok"] = rb["rel_err"] <= bar and rb["plan_matches_kernel"]
    log("mcflat K9b one node", json.dumps(rb))
    return ra, rb


def _mcf_one_k2k3(dev):
    """K2, then K3 at its outputs, float32, at one node past n + m = 46,340
    (MCF_ONE, L cuts of which half are real) against their plain versions
    on the gathered sub-problem (``_mcf_one_k9``'s), the float32 plain
    version's and the float64 one's: 1e-6 relative to the float64 one (the
    kernels' bar at the large shapes); k2k3_plan's shared memory against the
    kernels' exports."""
    import dataclasses

    import numpy as np
    import torch

    from omc_torch import kernels
    from omc_torch.sdp.admm import (_REST, cone_step, cone_step_plain, init_admm_state,
                                    k2k3_plan, make_consts, zstep, zstep_plain)
    from omc_torch.sdp.cuts import region_bounds
    from omc_torch.sdp.relax import NodeBatch
    from omc_torch.tree import root_box

    n, m, k, L = MCF_ONE["n"], MCF_ONE["m"], MCF_ONE["k"], MCF_ONE["L"]
    D, dt, e = n + m, torch.float32, 4
    shape = dict(B=1, n=n, m=m, k=k, L=L, flat=D * D)
    need = e * (3 * D * D + m * m)  # w1, u1, t1 and Theta
    fits, free = _mcf_fits(need)
    assert fits, ("K2/K3 at one node past n + m = 46,340", need, free)
    g = torch.Generator(device=dev).manual_seed(46342)
    rng = np.random.default_rng(46342)
    cut_x, cut_lo = np.zeros((1, L, n)), np.zeros((1, L, k))
    cut_hi, cut_mask = np.zeros((1, L, k)), np.zeros((1, L))
    for l in range(L // 2):
        x = rng.standard_normal(n)
        cut_x[0, l] = x / np.linalg.norm(x)
        cut_lo[0, l], cut_hi[0, l] = region_bounds("linear", rng.integers(0, 2, k),
                                                   rng.uniform(-0.5, 0.5, k))
        cut_mask[0, l] = 1.0
    lo, hi = root_box(n, k)
    f = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    batch = NodeBatch(f(cut_x), f(cut_lo), f(cut_hi), f(cut_mask), f(lo[None]), f(hi[None]))
    st = init_admm_state(1, n, m, k, L, dt, device=dev, sX=2.5, sT=1.7, rho=0.02)
    for name in ("w1", "w2", "w3", "w4", "wsoc", "wbox", "wa", "wb", "wc", "u1", "u2", "u3",
                 "u4", "usoc", "ubox", "ua", "ub", "uc", "X", "Y", "Th", "U"):
        t = getattr(st, name)
        t.normal_(0.0, 0.3, generator=g)
        if name in ("wa", "wb", "ua", "ub"):
            t.mul_(batch.cut_mask[..., None])
        if name in ("wc", "uc"):
            t.mul_(batch.cut_mask)
    A = torch.empty((n, m), dtype=dt, device=dev).normal_(generator=g)
    mask = (torch.empty((n, m), dtype=dt, device=dev).uniform_(generator=g) < 0.5).to(dt)
    # the constants K2 and K3 read: make_consts' at one column, with the full
    # mask and mask A (no (1, m, m) or (1, n + m, n + m) tensor)
    c1 = make_consts(A[:, :1].contiguous(), mask[:, :1].contiguous(), batch,
                     init_admm_state(1, n, 1, k, L, dt, device=dev), n, 1, k, 80.0, 1.9, 1e-3, dt)
    c = dataclasses.replace(c1, mask=mask, maskA=(mask * A).contiguous(), m=m, cX=None,
                            cTh=None, offs=None)
    S, idx = _mcf_cols(n, m, dev)
    st_s = _mcf_gathered(st, n, m, S, idx)
    c_s = make_consts(A[:, S].contiguous(), mask[:, S].contiguous(), batch, st_s, n, len(S), k,
                      80.0, 1.9, 1e-3, dt)
    lib = kernels.library()
    plan = k2k3_plan(1, n, m, k, L, dtype=dt)
    outs = lambda x: (x.X, x.Y, x.Th, x.U)  # noqa: E731
    ms = _mcf_once(lambda: zstep(c, st))
    got = _mcf_gathered(outs(st), n, m, S, idx)
    r2 = dict(**shape, plan=plan, sub_columns=len(S),
              plan_matches_kernel=plan["k2_smem"] == lib.omc_k2_smem_bytes(
                  n, m, k, L, plan["k2_cluster"], int(plan["band"] == "smem"),
                  int(plan["k2_xs"] == "smem"), int(plan["k2_sums"] == "global"), e,
                  int(plan["k2_u"] == "smem")))
    r2["rel_err"], r2["max_abs_err"] = _errs(got, zstep_plain(c_s, st_s))
    r2["rel_err_vs_f64"] = _errs(got, zstep_plain(_to64(c_s), _to64(st_s)))[0]
    r2["ms"] = r2["device_ms"] = ms
    r2["sub_plain_ms"] = _tm(lambda: zstep_plain(c_s, st_s))
    vals, ops = _k2_work(1, n, m, k, L)
    with_bound(r2, e * vals, ops)
    r2["ok"] = r2["rel_err_vs_f64"] <= 1e-6 and r2["plan_matches_kernel"]
    log("mcflat K2 one node", json.dumps(r2))

    acc = [torch.empty_like(x).normal_(0.0, 0.1, generator=g) for x in (st.ua, st.ub, st.uc)]
    st_s = _mcf_gathered(st, n, m, S, idx)  # K2's outputs, K3's slots before it
    acc_s = [a.clone() for a in acc]
    ts = tuple(torch.empty_like(x) for x in (st.w1, st.w2, st.w3))
    ms = _mcf_once(lambda: cone_step(c, st, ts, acc))
    got = _mcf_gathered(list(ts) + [getattr(st, nm) for nm in _REST] + acc, n, m, S, idx)
    t1, t2, t3, rest, acc_p = cone_step_plain(c_s, st_s, acc_s)
    T1, T2, T3, rest64, acc64 = cone_step_plain(_to64(c_s), _to64(st_s), _to64(acc_s))
    r3 = dict(**shape, plan=plan, sub_columns=len(S),
              plan_matches_kernel=plan["k3_smem"] == lib.omc_k3_smem_bytes(
                  n, m, k, L, plan["k3_cluster"], int(plan["k3_xs"] == "smem"),
                  int(plan["k3_slots"] == "smem"), int(plan["k3_sums"] == "global"), e,
                  int(plan["k3_u"] == "smem")))
    r3["rel_err"], r3["max_abs_err"] = _errs(got, [t1, t2, t3, *rest, *acc_p])
    r3["rel_err_vs_f64"] = _errs(got, [T1, T2, T3, *rest64, *acc64])[0]
    r3["ms"] = r3["device_ms"] = ms
    r3["sub_plain_ms"] = _tm(lambda: cone_step_plain(c_s, st_s, acc_s))
    vals, ops = _k3_work(1, n, m, k, L)
    with_bound(r3, e * vals, ops)
    r3["ok"] = r3["rel_err_vs_f64"] <= 1e-6 and r3["plan_matches_kernel"]
    log("mcflat K3 one node", json.dumps(r3))
    return r2, r3


def _mcf_k1(dev):
    """K1 alone (one block, with McCormick's epilogue: u and the running
    mean of rho u) at a McCormick batch past 2^31 (MCF_K1) against the same
    call on the batch's two halves: the same bits where both take the same
    k1_plan path (else 1e-5 relative); its time and the bytes it held."""
    import torch

    from omc_torch.ops.polar import k1_plan, project_psd_ns_multi

    B, d = MCF_K1["B"], MCF_K1["d"]
    h = B // 2
    g = torch.Generator(device=dev).manual_seed(1449)
    T = torch.empty((B, d, d), device=dev).normal_(generator=g)
    rho = torch.empty(B, device=dev).uniform_(5.0, 15.0, generator=g)
    W, U, ACC = (torch.empty_like(T) for _ in range(3))
    ACC.copy_(T).mul_(0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    project_psd_ns_multi([T], w_out=[W], u_out=[U], acc=[ACC], rho=rho, beta=0.5)
    b.record()
    torch.cuda.synchronize()
    plans = [k1_plan([d], B)["path"], k1_plan([d], h)["path"]]
    r = dict(B=B, d=d, flat=B * d * d, plans=plans, ms=a.elapsed_time(b),
             workspace_bytes=torch.cuda.max_memory_allocated() - base,
             held_bytes=torch.cuda.max_memory_allocated())
    same, err = True, 0.0
    for sl in (slice(0, h), slice(h, B)):
        outs = [torch.empty((h, d, d), device=dev) for _ in range(3)]
        outs[2].copy_(T[sl]).mul_(0.1)
        project_psd_ns_multi([T[sl]], w_out=[outs[0]], u_out=[outs[1]], acc=[outs[2]],
                             rho=rho[sl], beta=0.5)
        torch.cuda.synchronize()
        whole = (W[sl], U[sl], ACC[sl])
        same = same and _same_bits(whole, outs)
        err = max(err, _errs(whole, outs)[0])
        del outs
    r.update(same_bits_as_halves=same, rel_err_vs_halves=err)
    r["ok"] = same if plans[0] == plans[1] else err <= 1e-5
    log("mcflat K1", json.dumps(r))
    return r


def _mcf_iteration_bytes(dev):
    """The bytes a McCormick solver call takes a flat entry of its batch's
    (n + m)^2 blocks, at MCF_ITER's (B, n, m, iters) in each dtype: the
    peak allocated during the call, its state included (the caller's copy),
    over B (n + m)^2; and the largest batch (n + m)^2 that the card's
    memory would then hold."""
    import numpy as np
    import torch

    from omc_torch.sdp.mccormick import MCBatch, init_mc_state, make_mccormick_solver

    out = {}
    for dts, (B, n, m, iters) in MCF_ITER.items():
        dt = getattr(torch, dts)
        rng = np.random.default_rng(B)
        A = rng.standard_normal((n, m))
        mask = (rng.random((n, m)) < 0.3).astype(np.float64)
        lo = rng.uniform(-1.0, 0.5, (B, n, 1))
        hi = np.minimum(lo + rng.uniform(0.05, 1.0, (B, n, 1)), 1.0)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        batch = MCBatch(*(torch.tensor(x, dtype=dt, device=dev) for x in (lo, hi)))
        st = init_mc_state(B, n, m, 1, dt, device=dev, sX=2.5, sT=1.7, rho=10.0)
        solve = make_mccormick_solver(n, m, 1, 80.0, iters=iters, dtype=dt)
        t0 = time.time()
        _, o = solve(A, mask, batch, 0.0, st)
        torch.cuda.synchronize()
        flat = B * (n + m) ** 2
        used = torch.cuda.max_memory_allocated() - base
        total = torch.cuda.get_device_properties(0).total_memory
        out[dts] = r = dict(B=B, n=n, m=m, iters=iters, flat=flat, seconds=time.time() - t0,
                            peak_bytes=used, bytes_per_flat_entry=used / flat,
                            card_bytes=total, largest_flat=int(total / (used / flat)))
        assert bool(torch.isfinite(o["Y"]).all()), r
        del batch, st, o
        log(f"mcflat McCormick call bytes {dts}", json.dumps(r))
    return out


def _mcf_driver():
    """matrix_completion_branchandbound on the McCormick path at a
    batch_size past 2^31 (1,024 x 1,450^2; MCF_DRIVER): the gate passes,
    the root visit runs on the card (K9s, K9a, K9b, K1 and altmin's K6
    launched), its lower bounds finite and no higher than the incumbent."""
    import numpy as np

    from omc_torch import kernels
    from omc_torch.data import generate_matrix_completion_data

    n, m = MCF_DRIVER["n"], MCF_DRIVER["m"]
    A, idx = generate_matrix_completion_data(1, n, m, int(MCF_DRIVER["frac"] * n * m),
                                             MCF_DRIVER["seed"], n_max=n, m_max=m)
    assert MCF_DRIVER_KW["batch_size"] * (n + m) ** 2 >= 2 ** 31
    before = dict(kernels.LAUNCHES)
    sol, inst, secs = _solve(A, idx, 80.0, k=1, **MCF_DRIVER_KW)
    launches = _launched_since(before)
    lowers = [x["lower"] for x in inst["run_log"] if x["lower"] > -1e300]
    r = _summary(sol, inst, secs)
    r.update(lowers=lowers, launches={x: v for x, v in launches.items() if v},
             batch_size=MCF_DRIVER_KW["batch_size"], flat=MCF_DRIVER_KW["batch_size"] * (n + m) ** 2)
    log("mcflat driver", json.dumps(r))
    assert lowers and all(np.isfinite(lowers)), r
    assert all(x <= r["objective"] * (1 + 1e-9) + 1e-9 for x in lowers), r
    _assert_launched(launches, ("K9s", "K9a", "K9b", "K1", "K6"))
    return r


def phase_mcflat(res):
    """McCormick past batch x (n + m)^2 >= 2^31: K9a and K9b on both paths
    and in both dtypes at MCF_HALVES against their halves and their plain
    version on the tail slots (``_mcf_k9_halves``); K9a and K9b in both
    dtypes and K2 and K3 in float32 at one node past n + m = 46,340
    (``_mcf_one_k9``, ``_mcf_one_k2k3``); K1 at a McCormick batch past 2^31
    against its halves (no float32 McCormick solver call past 2^31 fits on
    80 GB: ``_mcf_iteration_bytes`` measures the bytes a call takes a flat
    entry); then the driver at batch_size 1,024 past 2^31, whose launches
    count (``_mcf_driver``)."""
    import torch

    from omc_torch import kernels

    dev = torch.device("cuda", 0)
    row, rows = {}, []
    for i, (B, n, m, k) in enumerate(MCF_HALVES):
        for dt in (torch.float32, torch.float64):
            rows += _mcf_k9_halves(B, n, m, k, dt, dev, 31 + 2 * i + (dt == torch.float64))
            torch.cuda.empty_cache()
    for dt in (torch.float32, torch.float64):
        for r in _mcf_one_k9(dt, dev):
            if "skipped" in r:
                row.setdefault("skipped", []).append(r)
            else:
                rows.append(r)
        torch.cuda.empty_cache()
    rows += _mcf_one_k2k3(dev)
    torch.cuda.empty_cache()
    rows.append(_mcf_k1(dev))
    torch.cuda.empty_cache()
    row["rows"] = rows
    row["iteration_bytes"] = _mcf_iteration_bytes(dev)
    torch.cuda.empty_cache()
    kernels.reset_launches()  # the driver's launches count from here
    row["driver"] = _mcf_driver()
    res["mcflat"] = row
    failed = [r for r in rows if not r["ok"]]
    assert not failed, failed


def phase_profile(res):
    """The headline with profile_dir (a directory under build/, removed
    after) and profile_steps=3: the Chrome trace holds CUDA kernel events
    of the base loop's K1, K2 and K3 by their symbol names, and the
    certified objective is the unprofiled headline's within the gap.  The
    wall time is logged beside the cold headline's."""
    import tempfile

    from omc_torch import kernels

    A, idx = _bench_instance(0.5)
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        sol, inst, secs = _solve(A, idx, 80.0, **BENCH_KW, profile_dir=tmp, profile_steps=3)
        rd = inst["run_details"]
        path = rd["profile_trace"]
        size = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    launches = dict(kernels.LAUNCHES)
    kern = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    seen = {key: sum(pat in nm for nm in kern) for key, pat in
            (("K1", "k1_"), ("K2", "k2_kernel"), ("K3", "k3_kernel"))}
    row = _summary(sol, inst, secs)
    cold = res.get("headline", {}).get("cold")
    row.update(trace_bytes=size, trace_events=len(events), kernel_events=len(kern),
               kernel_events_by_key=seen, profile_super_steps=rd["profile_super_steps"],
               launches=launches, headline_cold_seconds=cold["seconds"] if cold else None)
    log("profile", json.dumps(row))
    log(f"profile wall_s {secs:.3f} headline_cold_wall_s "
        f"{cold['seconds'] if cold else float('nan'):.3f}")
    assert all(v > 0 for v in seen.values()), row
    assert row["gap"] <= 1e-4, row
    assert abs(row["objective"] - HEADLINE_OBJ) <= (1e-4 + HEADLINE_GAP) * HEADLINE_OBJ, row
    if cold:
        tol = (row["gap"] + cold["gap"]) * abs(cold["objective"])
        assert abs(row["objective"] - cold["objective"]) <= tol, (row, cold)
    _assert_launched(launches, ("K1", "K2", "K3") + BOUND_KEYS)
    res["profile"] = row


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
    # the float64 builds (the float64, shor64, shork64 and mccormick64
    # phases' launches)
    ("K2_f64", ("K2_f64",), "K2 float64 build: adjoint + Woodbury z-step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k2_zstep.cu", "omc/sdp/admm.py:324"),
    ("K3_f64", ("K3_f64",), "K3 float64 build: forward map + cone step (B=64, n=m=50, L=8)",
     "omc_torch/csrc/k3_cone.cu", "omc/sdp/admm.py:133"),
    ("K7_f64", ("K7_f64",),
     "K7 float64 build: 5x5 minor slots, fused, exact Jacobi projection (B=32, M5=1024)",
     "omc_torch/csrc/k7_minor_psd.cu", "omc/ops/polar.py:127"),
    ("K8a_f64", ("K8a_f64",), "K8a float64 build: Shor adjoint + z-step (B=32, n=m=100, M5=1024)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:178"),
    ("K8b_f64", ("K8b_f64",), "K8b float64 build: Shor RSOC/link/W>=0 cone step (B=32, n=m=100)",
     "omc_torch/csrc/k8_shor.cu", "omc/sdp/admm_shor.py:423"),
    ("K7t_f64", ("K7t_f64",),
     "K7t float64 build: per-term 5x5 minor slots, exact Jacobi projection (B=32, M5=1024, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:349"),
    ("K7x_f64", ("K7x_f64",),
     "K7x float64 build: (k+1)x(k+1) XWH slots, exact Jacobi projection (B=32, C=4096, k=2)",
     "omc_torch/csrc/k7k_minor_xwh.cu", "omc/sdp/shor_k.py:373"),
    ("K8c_f64", ("K8c_f64",),
     "K8c float64 build: rank-k Shor adjoint + z-step (B=32, n=m=75, k=2, M5=1024)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:618"),
    ("K8d_f64", ("K8d_f64",),
     "K8d float64 build: rank-k Shor RSOC/link/W>=0/Wt>=0 cone step (B=32, n=m=75, k=2)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:754"),
    ("K9s_f64", ("K9s_f64",),
     "K9s float64 build: McCormick row Grams, Cholesky factors, orthogonality Woodbury "
     "(B=64, n=50, k=1)", "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:385"),
    ("K9a_f64", ("K9a_f64",), "K9a float64 build: McCormick adjoint + z-step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:446"),
    ("K9b_f64", ("K9b_f64",),
     "K9b float64 build: McCormick forward map + cone step (B=64, n=m=50, k=1)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:477"),
    ("K4_f64", ("K4_f64",),
     "K4 float64 build: PSD projection, tridiagonal path (B=64, d=100)",
     "omc_torch/csrc/k4_tridiag.cu", "omc/sdp/relax.py:356"),
    ("K4s_f64", ("K4s_f64",),
     "K4s float64 build: Jacobi PSD projection of 5x5 matrices (4x4096)",
     "omc_torch/csrc/k4s_jacobi_small.cu", "omc/sdp/admm_shor.py:786"),
    ("K5_f64", ("K5_f64",), "K5 float64 build: separation eigenpairs (B=64, n=50)",
     "omc_torch/csrc/k5_separation.cu", "omc/sdp/admm.py:576"),
    ("K6_f64", ("K6_f64",), "K6 float64 build: masked ridge V-step + U-step (B=4, n=m=50, k=1)",
     "omc_torch/csrc/k6_altmin.cu", "omc/ops/linalg.py:15"),
    # the wide kernels (the widerank phase's launches): K6 past k = 10, the
    # McCormick kernels at k >= 4 and n + m > 4096
    ("K6w", ("K6w",),
     "K6 wide path: masked ridge V-step + U-step, a warp an output (B=4, n=m=250, k=16)",
     "omc_torch/csrc/k6_altmin.cu", "omc/ops/linalg.py:15"),
    ("K6w_f64", ("K6w_f64",),
     "K6 wide path, float64 build: masked ridge V-step + U-step (B=4, n=m=250, k=16)",
     "omc_torch/csrc/k6_altmin.cu", "omc/ops/linalg.py:15"),
    ("K9sw", ("K9sw",),
     "K9s wide: McCormick row Grams and factors in memory, a warp a row (B=16, n=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:385"),
    ("K9aw", ("K9aw",),
     "K9a wide: McCormick adjoint + z-step, a warp a row's solve (B=16, n=m=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:446"),
    ("K9bw", ("K9bw",),
     "K9b wide: McCormick forward map + cone step, a runtime rank (B=16, n=m=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:477"),
    ("K9sw_f64", ("K9sw_f64",),
     "K9s wide, float64 build: McCormick row Grams and factors (B=16, n=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:385"),
    ("K9aw_f64", ("K9aw_f64",),
     "K9a wide, float64 build: McCormick adjoint + z-step (B=16, n=m=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:446"),
    ("K9bw_f64", ("K9bw_f64",),
     "K9b wide, float64 build: McCormick forward map + cone step (B=16, n=m=50, k=4)",
     "omc_torch/csrc/k9_mccormick.cu", "omc/sdp/mccormick.py:477"),
    # the rank-k Shor wide kernels (the shorkwide phase's launches): K7x,
    # K8c and K8d past k = 4
    ("K7xw", ("K7xw",),
     "K7x wide: (k+1)x(k+1) XWH slots, a warp a slot, sign schedule (B=32, C=4096, k=5)",
     "omc_torch/csrc/k7x_wide.cu", "omc/sdp/shor_k.py:373"),
    ("K7xw_f64", ("K7xw_f64",),
     "K7x wide, float64 build: XWH slots, a warp's Jacobi (B=32, C=4096, k=5)",
     "omc_torch/csrc/k7x_wide.cu", "omc/sdp/shor_k.py:373"),
    ("K8cw", ("K8cw",),
     "K8c wide: rank-k Shor adjoint + z-step, a runtime rank (B=32, n=m=75, k=5, M5=1024)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:618"),
    ("K8cw_f64", ("K8cw_f64",),
     "K8c wide, float64 build: rank-k Shor adjoint + z-step (B=32, n=m=75, k=5, M5=1024)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:618"),
    ("K8dw", ("K8dw",),
     "K8d wide: rank-k Shor RSOC/link/W>=0/Wt>=0 cone step, a runtime rank (B=32, n=m=75, k=5)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:754"),
    ("K8dw_f64", ("K8dw_f64",),
     "K8d wide, float64 build: rank-k Shor cone step (B=32, n=m=75, k=5)",
     "omc_torch/csrc/k8k_shor_k.cu", "omc/sdp/shor_k.py:754"),
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
