"""Compile-on-demand + ctypes bindings for the native scene compiler.

Counterpart of ``rayaccel_tpu/scene/native/build.py``: the BVH build, the
whole-scene and one-leaf pairing, and ``native_available``.
The repository keeps ONE copy of the host builder: this module compiles the
existing ``rayaccel_tpu/scene/native/scene_compiler.cpp`` (reading a source
file imports nothing) with the same g++ flags, into the port's git-ignored
build directory. There is no NumPy fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(_PKG), "rayaccel_tpu", "scene",
                      "native", "scene_compiler.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread"]

_lock = threading.Lock()
_lib = None


def _library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"scene_compiler-{digest.hexdigest()[:12]}.so")


def get_library() -> ctypes.CDLL:
    """Load the native builder, compiling it first if this source has not
    been built yet. Raises RuntimeError if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        i64 = ctypes.c_int64
        lib.racc_build_bvh.restype = i64
        lib.racc_build_bvh.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, i64, ctypes.c_int]
        lib.racc_fetch_bvh.restype = None
        lib.racc_fetch_bvh.argtypes = [ctypes.c_void_p] * 7
        lib.racc_release.restype = None
        lib.racc_release.argtypes = []
        lib.racc_pair_leaf.restype = i64
        lib.racc_pair_leaf.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, i64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.racc_pair_all.restype = i64
        lib.racc_pair_all.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native BVH library compiles and loads here. The port
    has no NumPy fallback: a call that needs the library still raises the
    build's error."""
    try:
        get_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_bvh_native(vertices: np.ndarray, indices: np.ndarray,
                     max_leaf: int):
    """Native full-sweep SAH build. Returns (kind, first, last, parent,
    bbmin, bbmax, prim_order), the arrays of ``scene/bvh.py:Bvh2``."""
    lib = get_library()
    verts = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.uint32)
    T = idx.shape[0]
    n = lib.racc_build_bvh(_ptr(verts), verts.shape[0], _ptr(idx), T,
                           int(max_leaf))
    if n < 0:
        raise RuntimeError(f"native BVH build failed (code {n})")
    kind = np.empty(n, np.uint8)
    first = np.empty(n, np.int64)
    last = np.empty(n, np.int64)
    parent = np.empty(n, np.int64)
    bbmin = np.empty((n, 3), np.float32)
    bbmax = np.empty((n, 3), np.float32)
    prim_order = np.empty(T, np.int64)
    lib.racc_fetch_bvh(_ptr(kind), _ptr(first), _ptr(last), _ptr(parent),
                       _ptr(bbmin), _ptr(bbmax), _ptr(prim_order))
    lib.racc_release()
    return kind, first, last, parent, bbmin, bbmax, prim_order


def pair_all_native(vertices: np.ndarray, indices: np.ndarray, bvh):
    """Pair every leaf's triangles in one native call. Returns (pair_rows,
    remap, leaf_first, leaf_last), the arrays of
    ``scene/pairs.py:PairedScene``."""
    lib = get_library()
    verts = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.uint32)
    kind = np.ascontiguousarray(bvh.kind, np.uint8)
    first = np.ascontiguousarray(bvh.first, np.int64)
    last = np.ascontiguousarray(bvh.last, np.int64)
    prim = np.ascontiguousarray(bvh.prim_order, np.int64)
    T = idx.shape[0]
    n_nodes = len(kind)
    rows = np.empty((T, 12), np.float32)
    remap = np.empty(2 * T, np.uint32)
    leaf_first = np.empty(n_nodes, np.int64)
    leaf_last = np.empty(n_nodes, np.int64)
    n = lib.racc_pair_all(_ptr(verts), _ptr(idx), _ptr(kind), _ptr(first),
                          _ptr(last), n_nodes, _ptr(prim), _ptr(rows),
                          _ptr(remap), _ptr(leaf_first), _ptr(leaf_last))
    return rows[:n].copy(), remap[:2 * n].copy(), leaf_first, leaf_last


def pair_leaves_native(vertices: np.ndarray, indices: np.ndarray,
                       tri_ids: np.ndarray):
    """Pair one leaf's triangles natively. Returns (pair_rows, remap)."""
    lib = get_library()
    verts = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.uint32)
    ids = np.ascontiguousarray(tri_ids, np.int64)
    count = len(ids)
    rows = np.empty((count, 12), np.float32)
    remap = np.empty(2 * count, np.uint32)
    n = lib.racc_pair_leaf(_ptr(verts), _ptr(idx), _ptr(ids), count,
                           _ptr(rows), _ptr(remap))
    return rows[:n], remap[:2 * n]
