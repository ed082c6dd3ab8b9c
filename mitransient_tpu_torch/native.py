"""ctypes bindings for the native (C++) host components: the OBJ parser and
the BVH builders of ``native/mitr_native.cpp``.

Counterpart of ``mitransient_tpu/native.py``, with the same entry points and
contracts.  The library is compiled with ``g++ -O3 -shared -fPIC`` at first
use into ``build/`` at the root of the checkout, under a file name that
hashes the source and the flags, so an edited source is rebuilt and the
tracked ``native/libmitr_native.so`` is never written.  Every entry point
falls back to pure Python when the library cannot be built or loaded, as in
the JAX package; :func:`available` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SRC = _ROOT / "native" / "mitr_native.cpp"
BUILD_DIR = _ROOT / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmitr_native_{h.hexdigest()[:16]}.so"


def _compile() -> Path:
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_compile()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.mitr_obj_count.restype = ctypes.c_int32
            lib.mitr_obj_count.argtypes = [ctypes.c_char_p, i64p, i64p]
            lib.mitr_obj_load.restype = ctypes.c_int32
            lib.mitr_obj_load.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64,
                                          i32p, ctypes.c_int64]
            bvh_sig = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
                       f32p, f32p, i32p, i32p, i32p, i32p]
            for fn in (lib.mitr_build_bvh, lib.mitr_build_bvh_sah):
                fn.restype = ctypes.c_int64
                fn.argtypes = bvh_sig
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            _lib = None
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str):
    """Fast OBJ parse -> (verts (V,3) f32, faces (F,3) i32): positions and
    topology only.  None if the native library is unavailable or parsing
    fails."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    if lib.mitr_obj_count(path.encode(), ctypes.byref(nv),
                          ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nt.value, 3), np.int32)
    if lib.mitr_obj_load(path.encode(), _fptr(verts), nv.value,
                         _iptr(faces), nt.value) != 0:
        return None
    return verts, faces


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = 4, method: str = "sah"):
    """BVH over a triangle soup -> dict of flat arrays (bbox_min/bbox_max
    (N,3), left/right/count (N,), prim_order (M,)).

    ``method``: "sah" (binned surface-area heuristic) or "median" (centroid
    median split).  Without the native library: the Python median-split
    builder."""
    m = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    lib = _load()
    if lib is not None:
        cap = 2 * m
        bmin = np.empty((cap, 3), np.float32)
        bmax = np.empty((cap, 3), np.float32)
        left = np.empty((cap,), np.int32)
        right = np.empty((cap,), np.int32)
        count = np.empty((cap,), np.int32)
        order = np.empty((m,), np.int32)
        fn = lib.mitr_build_bvh_sah if method == "sah" else lib.mitr_build_bvh
        n_nodes = fn(_fptr(v0), _fptr(e1), _fptr(e2), m, leaf_size,
                     _fptr(bmin), _fptr(bmax), _iptr(left), _iptr(right),
                     _iptr(count), _iptr(order))
        if n_nodes > 0:
            n = int(n_nodes)
            return {"bbox_min": bmin[:n], "bbox_max": bmax[:n],
                    "left": left[:n], "right": right[:n], "count": count[:n],
                    "prim_order": order}
    return _build_bvh_py(v0, e1, e2, leaf_size)


def _build_bvh_py(v0, e1, e2, leaf_size=4):
    """Python median-split BVH builder (same output contract)."""
    m = v0.shape[0]
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (M, 3, 3)
    tmin = pts.min(axis=1)
    tmax = pts.max(axis=1)
    cent = 0.5 * (tmin + tmax)
    order = np.arange(m, dtype=np.int32)
    bmin, bmax, left, right, count = [], [], [], [], []

    def rec(lo, hi):
        node = len(bmin)
        sel = order[lo:hi]
        bmin.append(tmin[sel].min(axis=0))
        bmax.append(tmax[sel].max(axis=0))
        left.append(0)
        right.append(0)
        count.append(0)
        n = hi - lo
        if n <= leaf_size:
            left[node] = -1
            right[node] = lo
            count[node] = n
            return node
        c = cent[sel]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = n // 2
        part = np.argpartition(c[:, axis], mid)
        order[lo:hi] = sel[part]
        left[node] = rec(lo, lo + mid)
        right[node] = rec(lo + mid, hi)
        return node

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, m)
    finally:
        sys.setrecursionlimit(old)
    return {
        "bbox_min": np.asarray(bmin, np.float32),
        "bbox_max": np.asarray(bmax, np.float32),
        "left": np.asarray(left, np.int32),
        "right": np.asarray(right, np.int32),
        "count": np.asarray(count, np.int32),
        "prim_order": order,
    }
