"""ctypes bridge to the C++ kernel-map code (csrc/kernel_maps.cpp).

Counterpart of ``pq3d_tpu/ops/_native.py``: compiled lazily with g++ into
the port's ``build/native/`` directory (plain C ABI + ctypes).  ``lib()``
returns None when no compiler is available; callers keep the numpy
fallback, which builds the same maps.
"""
from __future__ import annotations

import ctypes
import os
import threading

from pq3d_tpu_torch._build import CSRC_DIR, build_shared

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(CSRC_DIR, "kernel_maps.cpp")


def lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = build_shared(_SRC, "native", ["g++"],
                              ["-O3", "-march=native", "-shared", "-fPIC",
                               "-std=c++17"])
            L = ctypes.CDLL(so)
            L.pq3d_neighbor_map.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            L.pq3d_neighbor_map.restype = None
            L.pq3d_downsample.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            L.pq3d_downsample.restype = ctypes.c_int64
            L.pq3d_fps.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            L.pq3d_fps.restype = None
            _LIB = L
        except Exception:
            _LIB = None
    return _LIB
