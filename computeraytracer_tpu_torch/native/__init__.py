"""Native (C++) components, loaded with ctypes (port of
computeraytracer_tpu/native/__init__.py). Currently the BVH builder
(bvh_builder.cpp, a copy of the JAX package's source).

The library is compiled on first use with g++ into ``native/build/``
(listed in .gitignore): each process compiles to a temporary file with
its pid in the name and moves it into place with ``os.replace``, so
concurrent processes (test workers) never load a half-written library.
Nothing is written outside this package.

``build_bvh_native`` builds the same ``BVHArrays`` as
``bvh.builder.build_bvh``; without a toolchain it raises, and
``bvh.builder.scene_bvh(backend="auto")`` falls back to NumPy.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "bvh_builder.cpp"
BUILD_DIR = HERE / "build"
LIB = BUILD_DIR / "libcrtbvh.so"

_lock = threading.Lock()
_lib = None


def _compile() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libcrtbvh.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o",
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
            _compile()
        lib = ctypes.CDLL(str(LIB))
        lib.crt_build_bvh.restype = ctypes.c_int32
        lib.crt_build_bvh.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def build_bvh_native(category, data1, data2, data3, max_leaf: int = 4):
    """C++ twin of bvh.builder.build_bvh; returns BVHArrays of NumPy
    arrays."""
    from computeraytracer_tpu_torch.bvh import builder

    lib = _load()
    lo, hi = builder.primitive_bounds(category, data1, data2, data3)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    cap = 2 * n + 2
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    leaf = np.empty((cap, max_leaf), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.crt_build_bvh(
        n, lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), max_leaf,
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        miss.ctypes.data_as(ip), leaf.ctypes.data_as(ip))
    if n_nodes <= 0:
        raise RuntimeError(f"crt_build_bvh failed ({n_nodes})")
    return builder.BVHArrays(
        bbox_min=bmin[:n_nodes].copy(),
        bbox_max=bmax[:n_nodes].copy(),
        miss=miss[:n_nodes].copy(),
        leaf_prims=leaf[:n_nodes].copy(),
    )
