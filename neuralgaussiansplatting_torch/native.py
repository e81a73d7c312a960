"""ctypes loader for the repository's native host library
(``native/libngs_native.so``, built from ``native/ngs_native.cpp``).

The port's own loader for the committed library: it loads the file as it
is and never builds it. Two host functions come from it, both run once at
scene load: the bulk parse of COLMAP's ``points3D.bin`` and the 3-nearest-
neighbour mean distance that seeds Gaussian scales (exact, Morton-boxed,
multithreaded). Each returns None where the library cannot be loaded, and
callers fall back to Python (COLMAP) or scipy (kNN).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

LIBRARY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libngs_native.so")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError:
            return None
        lib.colmap_points3d_count.restype = ctypes.c_longlong
        lib.colmap_points3d_count.argtypes = [ctypes.c_char_p]
        lib.colmap_points3d_read.restype = ctypes.c_longlong
        lib.colmap_points3d_read.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.knn_mean_dist3.restype = ctypes.c_int
        lib.knn_mean_dist3.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def read_points3d_binary(path: str):
    """(xyz (N, 3) f64, rgb (N, 3) u8, error (N,) f64) of a COLMAP
    points3D.bin, or None when the library is unavailable or the parse
    fails."""
    lib = _load()
    if lib is None:
        return None
    n = lib.colmap_points3d_count(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    if lib.colmap_points3d_read(path.encode(), xyz, rgb, err) != n:
        return None
    return xyz, rgb, err


def knn_mean_dist3(points: np.ndarray, num_threads: int = 0):
    """(N,) float32 mean squared distance of each point to its 3 nearest
    neighbours, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), not {pts.shape}")
    out = np.empty(len(pts), np.float32)
    if lib.knn_mean_dist3(pts, len(pts), out, num_threads) != 0:
        return None
    return out
