"""Build, load and launch the hand-written CUDA kernels of the port.

The kernels live in ``omc_torch/csrc/*.cu`` (CUDA C++ for ``sm_90a``).  At
first use each source is compiled by its own ``nvcc``, all at once, and the
objects are linked into one shared library with a plain C interface under
``build/omc_torch/<hash>/`` beside the package (the hash covers the sources
and the flags, so an edited source rebuilds), loaded with ``ctypes``.
Nothing is compiled or loaded at import time: a CPU-only installation
imports this module and never calls ``library()``.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; ``launch``
raises on a non-zero code and counts the launch in ``LAUNCHES``.

The wrappers that call these entry points sit beside each kernel's plain
PyTorch version:

- K1 ``omc_torch.ops.polar.project_psd_ns_multi``  (``csrc/k1_psd_sign.cu``)
- K2 ``omc_torch.sdp.admm.zstep``                  (``csrc/k2_zstep.cu``)
- K3 ``omc_torch.sdp.admm.cone_step``              (``csrc/k3_cone.cu``)
- K7 ``omc_torch.ops.polar.project_psd_small`` and
  ``omc_torch.sdp.admm_shor.minor_step``           (``csrc/k7_minor_psd.cu``)
- K8a ``omc_torch.sdp.admm_shor.shor_zstep``       (``csrc/k8_shor.cu``)
- K8b ``omc_torch.sdp.admm_shor.shor_cone_step``   (``csrc/k8_shor.cu``)
- K7t ``omc_torch.sdp.shor_k.minor_k_step``        (``csrc/k7k_minor_xwh.cu``)
- K7x ``omc_torch.sdp.shor_k.xwh_step`` and
  ``omc_torch.ops.polar.project_psd_xwh``          (``csrc/k7k_minor_xwh.cu``)
- K8c ``omc_torch.sdp.shor_k.shor_k_zstep``        (``csrc/k8k_shor_k.cu``)
- K8d ``omc_torch.sdp.shor_k.shor_k_cone_step``    (``csrc/k8k_shor_k.cu``)
- K9s ``omc_torch.sdp.mccormick.mc_setup``         (``csrc/k9_mccormick.cu``)
- K9a ``omc_torch.sdp.mccormick.mc_zstep``         (``csrc/k9_mccormick.cu``)
- K9b ``omc_torch.sdp.mccormick.mc_cone_step``     (``csrc/k9_mccormick.cu``)
- K4 ``omc_torch.ops.cones.eigvalsh`` and
  ``project_psd`` (d > 8)                          (``csrc/k4_jacobi.cu``)
- K4s ``omc_torch.ops.cones.project_psd`` (d <= 8) (``csrc/k4s_jacobi_small.cu``)
- K5 ``omc_torch.sdp.relax.separation_eigpairs``   (``csrc/k5_separation.cu``;
  ``k5_plan`` gives K4's paths the matrices whose triangle does not fit)
- K6 ``omc_torch.ops.linalg.v_step`` and
  ``u_step_unconstrained``                         (``csrc/k6_altmin.cu``)

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

# launches of each kernel in this process (the wrappers add one per launch)
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K7": 0, "K8a": 0, "K8b": 0,
            "K7t": 0, "K7x": 0, "K8c": 0, "K8d": 0, "K9s": 0, "K9a": 0, "K9b": 0,
            "K4": 0, "K4s": 0, "K5": 0, "K6": 0}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "omc_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO = {"seconds": None, "cached": None, "path": None, "ptxas": ""}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library(build: bool = True):
    """The loaded kernel library, built on first call.  With ``build=False``
    a library of these sources must exist already (a process that shares
    the build of another, as the ranks of a multi-process run do)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load(_build(build))
    return _lib


def _build(build: bool = True) -> Path:
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libomc_torch_kernels.so"
    BUILD_INFO["path"] = str(so)
    if so.exists():
        BUILD_INFO.update(seconds=0.0, cached=True)
        return so
    if not build:
        raise RuntimeError(f"the kernel library {so} is not built; build it first "
                           "(omc_torch.kernels.library())")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.time()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libomc_torch_kernels.{tag}.so"
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    for _, obj, _ in jobs:
        obj.unlink()
    BUILD_INFO.update(seconds=time.time() - t0, cached=False, ptxas="".join(logs))
    return so


class K1Params(ctypes.Structure):
    _fields_ = [
        ("t", ctypes.c_void_p * 3), ("w", ctypes.c_void_p * 3),
        ("u", ctypes.c_void_p * 3), ("acc", ctypes.c_void_p * 3),
        ("scratch", ctypes.c_void_p * 3), ("scratch_floats", ctypes.c_longlong * 3),
        ("D", ctypes.c_int * 3),
        ("G", ctypes.c_int), ("B", ctypes.c_int), ("C", ctypes.c_int),
        ("rho", ctypes.c_void_p), ("beta", ctypes.c_float),
    ]


_K2_PTRS = (
    "w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc", "wbox",
    "ubox", "wa", "ua", "wb", "ub", "wc", "uc", "cut_x", "cut_lo", "cut_hi",
    "cut_mask", "maskA", "mask", "sX", "sT", "rho", "G1i", "Xs", "Y", "Ths",
    "U",
)


class K2Params(ctypes.Structure):
    # ws: the block's own workspace where the plan puts the partials of s in
    # global memory (held by the block), else null
    _fields_ = [(name, ctypes.c_void_p) for name in _K2_PTRS + ("ws",)] + [
        ("B", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("k", ctypes.c_int), ("L", ctypes.c_int), ("C", ctypes.c_int),
        ("band", ctypes.c_int), ("xsmem", ctypes.c_int), ("gamma", ctypes.c_float),
    ]


_K3_PTRS = (
    "Xs", "Y", "Ths", "U", "w1", "u1", "w2", "u2", "w3", "u3", "t1", "t2",
    "t3", "w4", "u4", "wsoc", "usoc", "wbox", "ubox", "wa", "ua", "wb", "ub",
    "wc", "uc", "acc_a", "acc_b", "acc_c", "cut_x", "cut_lo", "cut_hi",
    "cut_mask", "U_lo", "U_hi", "sX", "sT", "rho",
)


class K3Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _K3_PTRS + ("ws",)] + [
        ("B", ctypes.c_int), ("n", ctypes.c_int), ("m", ctypes.c_int),
        ("k", ctypes.c_int), ("L", ctypes.c_int), ("C", ctypes.c_int),
        ("xsmem", ctypes.c_int), ("slsmem", ctypes.c_int), ("alpha", ctypes.c_float),
        ("beta", ctypes.c_float),
    ]


def _struct(ptrs, ints, floats):
    return ([(name, ctypes.c_void_p) for name in ptrs]
            + [(name, ctypes.c_int) for name in ints]
            + [(name, ctypes.c_float) for name in floats])


class K7Params(ctypes.Structure):
    _fields_ = _struct(
        ("t", "w", "u", "acc", "Xs", "Ws", "v1", "v2", "v3", "minor_idx",
         "iv1a", "iv1b", "iv2a", "iv2b", "iv3", "minor_mask", "sS", "rho"),
        ("N", "M5", "nm", "P1", "P2", "P3", "m"), ("alpha", "beta"))


class K8aParams(ctypes.Structure):
    _fields_ = _struct(
        ("w1", "u1", "w5", "u5", "wr", "ur", "soc_mask", "wl", "ul", "wp",
         "up", "xw_ptr", "xw_ent", "v1_ptr", "v1_ent", "v2_ptr", "v2_ent",
         "v3_ptr", "v3_ent", "cnt_X", "cnt_W", "cnt_v1", "cnt_v2", "cnt_v3",
         "g_link", "maskA", "mask", "sX", "sT", "sS", "rho", "Xs", "Ths",
         "Ws", "v1", "v2", "v3"),
        ("B", "n", "m", "M5", "P1", "P2", "P3", "C", "Q"), ("gamma", "R_X"))


class K8bParams(ctypes.Structure):
    _fields_ = _struct(
        ("Xs", "Ws", "Ths", "wr", "ur", "acc_r", "soc_mask", "wl", "ul",
         "acc_l", "wp", "up", "sX", "sT", "sS", "rho"),
        ("B", "n", "m", "qpc"), ("alpha", "beta"))


class K7tParams(ctypes.Structure):
    _fields_ = _struct(
        ("w", "u", "acc", "Xt", "Wt", "v1", "v2", "v3", "rec", "minor_mask", "sS", "rho"),
        ("B", "M5", "k", "nm", "C", "P1", "P2", "P3"), ("alpha", "beta"))


class K7xParams(ctypes.Structure):
    _fields_ = _struct(
        ("t", "w", "u", "acc", "Xt", "Wt", "Hh", "coord_flat", "coord_mask",
         "sS", "rho"),
        ("N", "C", "k", "nm"), ("alpha", "beta"))


class K8cParams(ctypes.Structure):
    _fields_ = _struct(
        ("w1", "u1", "w5", "u5", "wx", "ux", "wr", "ur", "wl", "ul", "wwl",
         "uwl", "wp", "up", "wq", "uq", "soc_mask", "coord_mask", "fm_ptr", "fm_ent",
         "flat_coord", "flat_soc", "v1_ptr", "v1_ent", "v2_ptr", "v2_ent", "v3_ptr",
         "v3_ent", "D1x", "c1x", "D1w", "D1wt", "D1h", "D_c", "B_jc", "S_th", "D1v1",
         "D1v2", "D1v3", "maskA", "mask", "sX", "sT", "sS", "rho", "Xt", "Xs", "Ths",
         "Ws", "Wt", "Hh", "v1", "v2", "v3"),
        ("B", "n", "m", "k", "M5", "C", "Ms", "P1", "P2", "P3", "cols"), ("gamma", "R_X"))


class K8dParams(ctypes.Structure):
    _fields_ = _struct(
        ("Xs", "Ws", "Ths", "Wt", "Hh", "wr", "ur", "acc_r", "wl", "ul", "acc_l",
         "wwl", "uwl", "acc_wl", "wp", "up", "wq", "uq", "soc_flat", "soc_mask",
         "coord_flat", "coord_mask", "sX", "sT", "sS", "rho"),
        ("B", "n", "m", "k", "C", "Ms", "ipc"), ("alpha", "beta"))


class K9sParams(ctypes.Structure):
    _fields_ = _struct(("U_lo", "U_hi", "Mc", "Si", "Gc"), ("B", "n", "k"), ())


class K9aParams(ctypes.Structure):
    _fields_ = _struct(
        ("w1", "u1", "w2", "u2", "w3", "u3", "w4", "u4", "wsoc", "usoc", "wbox",
         "ubox", "wmc", "umc", "worth", "uorth", "U_lo", "U_hi", "maskA", "mask",
         "sX", "sT", "rho", "Mc", "Si", "Gc", "Xs", "Y", "Ths", "U", "t"),
        ("B", "n", "m", "k"), ("gamma",))


class K9bParams(ctypes.Structure):
    _fields_ = _struct(
        ("Xs", "Y", "Ths", "U", "t", "w1", "u1", "w2", "u2", "w3", "u3", "t1",
         "t2", "t3", "w4", "u4", "wsoc", "usoc", "wbox", "ubox", "wmc", "umc",
         "worth", "uorth", "acc_mc", "acc_orth", "U_lo", "U_hi", "sX", "sT", "rho"),
        ("B", "n", "m", "k", "qpc"), ("alpha", "beta"))


class K4Params(ctypes.Structure):
    _fields_ = _struct(("M", "U", "Y", "w", "V", "P", "sweeps", "work"),
                       ("B", "d", "k", "nout", "mode", "path"), ())


class K5Params(ctypes.Structure):
    _fields_ = _struct(("U", "Y", "w", "V", "iters"), ("B", "d", "k", "nout", "path"), ())


class K4sParams(ctypes.Structure):
    _fields_ = _struct(("t", "w", "sweeps"), ("N", "D"), ())


class K6Params(ctypes.Structure):
    _fields_ = _struct(("F", "A", "mask", "out", "gram"),
                       ("B", "n", "m", "k", "path", "S", "W", "rpw"), ("inv_gamma", "ridge_eps"))


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, params in (
        ("omc_k1_psd_sign", K1Params),
        ("omc_k2_zstep", K2Params),
        ("omc_k3_cone", K3Params),
        ("omc_k7_minor_psd", K7Params),
        ("omc_k8a_shor_zstep", K8aParams),
        ("omc_k8b_shor_cone", K8bParams),
        ("omc_k7t_minor_k", K7tParams),
        ("omc_k7x_xwh", K7xParams),
        ("omc_k8c_shor_k_zstep", K8cParams),
        ("omc_k8d_shor_k_cone", K8dParams),
        ("omc_k9s_setup", K9sParams),
        ("omc_k9a_zstep", K9aParams),
        ("omc_k9b_cone", K9bParams),
        ("omc_k4_jacobi", K4Params),
        ("omc_k5_separation", K5Params),
        ("omc_k4s_jacobi_small", K4sParams),
        ("omc_k6_vstep", K6Params),
        ("omc_k6_ustep", K6Params),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.omc_error_string.argtypes = [ctypes.c_int]
    lib.omc_error_string.restype = ctypes.c_char_p
    lib.omc_k4_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.omc_k4_workspace_floats.restype = ctypes.c_longlong
    lib.omc_k5_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.omc_k5_smem_bytes.restype = ctypes.c_longlong
    lib.omc_k5_threads.argtypes = []
    lib.omc_k5_threads.restype = ctypes.c_int
    lib.omc_k4s_smem_bytes.argtypes = [ctypes.c_int]
    lib.omc_k4s_smem_bytes.restype = ctypes.c_longlong
    lib.omc_k4s_grid_x.argtypes = [ctypes.c_int]
    lib.omc_k4s_grid_x.restype = ctypes.c_int
    lib.omc_k1_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.omc_k1_scratch_floats.restype = ctypes.c_longlong
    lib.omc_k1_cluster_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.omc_k1_cluster_smem.restype = ctypes.c_longlong
    lib.omc_k6_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.omc_k6_smem_bytes.restype = ctypes.c_longlong
    lib.omc_k8c_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.omc_k8c_smem_bytes.restype = ctypes.c_longlong
    lib.omc_k8a_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.omc_k8a_smem_bytes.restype = ctypes.c_longlong
    lib.omc_k8a_grid_x.argtypes = [ctypes.c_int] * 4
    lib.omc_k8a_grid_x.restype = ctypes.c_int
    lib.omc_k8b_grid_x.argtypes = [ctypes.c_int] * 4
    lib.omc_k8b_grid_x.restype = ctypes.c_int
    lib.omc_k8d_grid_x.argtypes = [ctypes.c_int] * 6
    lib.omc_k8d_grid_x.restype = ctypes.c_int
    lib.omc_k9s_threads.argtypes = [ctypes.c_int] * 2
    lib.omc_k9s_threads.restype = ctypes.c_int
    lib.omc_k9s_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.omc_k9s_smem_bytes.restype = ctypes.c_int
    lib.omc_k9a_grid_x.argtypes = [ctypes.c_int] * 3
    lib.omc_k9a_grid_x.restype = ctypes.c_int
    lib.omc_k9b_grid_x.argtypes = [ctypes.c_int] * 5
    lib.omc_k9b_grid_x.restype = ctypes.c_int
    for name, nargs in (("omc_k2_smem_bytes", 8), ("omc_k3_smem_bytes", 8),
                        ("omc_k2_ws_doubles", 5), ("omc_k3_ws_doubles", 5)):
        getattr(lib, name).argtypes = [ctypes.c_int] * nargs
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


def launch(key: str, fn_name: str, params: ctypes.Structure, device):
    """Launch one kernel on the current stream of ``device``; raise on a
    launch error, count the launch."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.omc_error_string(err).decode()
        raise RuntimeError(f"{key} ({fn_name}) launch failed: {msg} ({err})")
    LAUNCHES[key] += 1


def check(name, t, shape, device, dtype=torch.float32):
    """Validate one kernel operand: ``dtype`` (float32 values, int32
    index tables), contiguous, on ``device``, of exactly ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the CUDA kernels take {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def require_full_fp32():
    """The sign schedule and the on-device bound need full-fp32 matmuls
    (TF32 keeps about three digits and floors ADMM accuracy)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "omc_torch needs torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.backends.cudnn.allow_tf32 = False on the GPU"
        )


def set_full_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
