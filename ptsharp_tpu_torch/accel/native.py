"""ctypes bindings for the shared native binned-SAH BVH builder.

Compiles `native/bvh_builder.cpp` (shared with the JAX package, read and
never written) with g++ into the port's build directory,
`build/ptsharp_tpu_torch/`, with the flags of `native/Makefile`, so both
packages run the same builder. Returns None when no toolchain is
available; accel/bvh.py then takes the Morton builder, as the JAX package
does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "ptsharp_tpu_torch")
_SO_PATH = os.path.join(BUILD_DIR, "libptbvh.so")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        stale = (not os.path.exists(_SO_PATH)
                 or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC))
        if stale:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *_CXXFLAGS, "-shared", "-o", tmp, _SRC],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
            os.replace(tmp, _SO_PATH)
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.ptbvh_build.restype = ctypes.c_int
        lib.ptbvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # tri_bmin
            ctypes.POINTER(ctypes.c_float),  # tri_bmax
            ctypes.c_int,  # num_tris
            ctypes.c_int,  # leaf_size
            ctypes.POINTER(ctypes.c_float),  # node_bmin
            ctypes.POINTER(ctypes.c_float),  # node_bmax
            ctypes.POINTER(ctypes.c_int),  # node_first
            ctypes.POINTER(ctypes.c_int),  # node_count
            ctypes.POINTER(ctypes.c_int),  # node_skip
            ctypes.POINTER(ctypes.c_int),  # tri_order
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """The native builder compiled and loaded."""
    return _load() is not None


def build_bvh_sah(tri_bmin: np.ndarray, tri_bmax: np.ndarray,
                  leaf_size: int = 8):
    """Binned-SAH build. Returns (bmin, bmax, first, count, skip, order)
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = tri_bmin.shape[0]
    cap = 2 * t
    bmin = np.ascontiguousarray(tri_bmin, np.float32)
    bmax = np.ascontiguousarray(tri_bmax, np.float32)
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_skip = np.empty(cap, np.int32)
    tri_order = np.empty(t, np.int32)

    def f32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def i32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n = lib.ptbvh_build(
        f32p(bmin), f32p(bmax), t, leaf_size,
        f32p(node_bmin), f32p(node_bmax),
        i32p(node_first), i32p(node_count), i32p(node_skip), i32p(tri_order),
    )
    if n <= 0:
        return None
    return (
        node_bmin[:n].copy(),
        node_bmax[:n].copy(),
        node_first[:n].copy(),
        node_count[:n].copy(),
        node_skip[:n].copy(),
        tri_order,
    )
