"""Build and bind the port's hand-written CUDA kernels.

The sources are ``rayaccel_tpu_torch/csrc/*.cu``. At the first launch on a
CUDA tensor they are compiled by nvcc, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``), one nvcc process per source
started together, and linked into one shared library with a plain C
interface under the package's git-ignored ``_build/`` directory, named by
a hash of the sources and flags, and loaded with ctypes. Nothing
is compiled or loaded when the module is imported. If nvcc is missing or
the build fails, the launch raises: there is no fallback.

Each C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code. Kernels launch on ``torch.cuda.current_stream()`` and
allocate nothing: the wrappers in ``ops/`` allocate every output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output of the build this process ran (ptxas -v)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    "racc_dense_hit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P],
    "racc_dense_occluded": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _P],
    "racc_select_nearest": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _P],
    "racc_select_split": [_I],
    "racc_select_max_boxes": [],
    "racc_select_chunks": [_I],
    "racc_pair_hit": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                      _P],
    "racc_probe_static": [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    "racc_probe_dynamic": [_P, _I, _I, _P, _I, _P, _P, _I, _P],
    "racc_probe_worklist": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _P],
    "racc_pair_units": [_P, _I, _I, _I, _P, _P],
    "racc_pair_hit_mb_resident": [_I, _I],
    "racc_pair_hit_mb": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    "racc_cull_queue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _P],
    "racc_threefry": [_I, _P, _P, _I, _U, _U, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _build(so: str) -> None:
    """Compile every ``.cu`` to an object in parallel, then link ``so``."""
    global build_log
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cu, obj in zip(cus, objs)]
    logs, failed = [], []
    try:
        for cu, proc in zip(cus, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(os.path.basename(cu))
        if not failed:
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                                   *objs], capture_output=True, text=True,
                                  timeout=300)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed to build the port's kernels "
                           f"({', '.join(failed)}):\n{build_log[-6000:]}")
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises RuntimeError if nvcc
    is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for path in _sources():
            with open(path, "rb") as f:
                digest.update(f.read())
        so = os.path.join(BUILD_DIR, f"kernels-{digest.hexdigest()[:12]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _build(so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


# The error words of the kernels that wait on an mbarrier
# (``csrc/tma.cuh``): err[0] a code, err[1] the step it failed at.
_DEVICE_ERRORS = {1: "was given less dynamic shared memory than it needs",
                  2: "timed out waiting on an mbarrier",
                  3: "read a row block index out of range"}


def check_device(err: torch.Tensor, name: str) -> None:
    """Raise if a kernel reported a failure in its error word ``err`` (a
    (2,) int32 CUDA tensor of zeros before the launch). Reads it on the
    host, so it waits for the kernels before it on the stream."""
    code, step = err.tolist()
    if code != 0:
        what = _DEVICE_ERRORS.get(code, f"reported error {code}")
        raise RuntimeError(f"{name}: the kernel {what} (step {step})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Validate a kernel argument: device, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
