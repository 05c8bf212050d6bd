"""ctypes bindings for the native host-runtime kernels (native/rodc_native.cc
at the repository root), the port's copy of the JAX package's ``native.py``.

The shared library is built on first use with the repo Makefile (g++ only,
a plain C ABI bound with ctypes). All entry points return None when the
toolchain or library is unavailable, and callers then use the numpy
implementations, so the port never hard-depends on the native build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .utils import log

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librodc_native.so")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except Exception as exc:
        log.log("native build unavailable: {}".format(exc))
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_SO_PATH) and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.rodc_group_rectangles.restype = ctypes.c_int32
            lib.rodc_group_rectangles.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.rodc_enumerate_pyramid.restype = ctypes.c_int32
            lib.rodc_enumerate_pyramid.argtypes = [
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32,
            ]
            _lib = lib
        except OSError as exc:
            log.log("native library load failed: {}".format(exc))
            _load_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def group_rectangles(
    rects_xywh: np.ndarray, min_neighbors: int, eps: float = 0.2
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native groupRectangles; returns None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rects = np.ascontiguousarray(rects_xywh, dtype=np.float64)
    n = len(rects)
    if n == 0:
        return np.zeros((0, 4), np.int64), np.zeros((0,), np.int64)
    out_xywh = np.empty((n, 4), dtype=np.int64)
    out_w = np.empty((n,), dtype=np.int64)
    kept = lib.rodc_group_rectangles(
        rects.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        int(min_neighbors),
        float(eps),
        out_xywh.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_xywh[:kept].copy(), out_w[:kept].copy()


def enumerate_pyramid(
    img_h: int,
    img_w: int,
    window_h: int,
    window_w: int,
    min_window_length: float,
    factor: float,
    max_scales: int = 4096,
) -> Optional[np.ndarray]:
    """Native pyramid schedule: (n_scales, 6) rows of
    (scale, scaled_h, scaled_w, step_x, step_y, n_windows), or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max_scales, 6), dtype=np.float64)
    k = lib.rodc_enumerate_pyramid(
        int(img_h),
        int(img_w),
        int(window_h),
        int(window_w),
        float(min_window_length),
        float(factor),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(max_scales),
    )
    if k < 0:
        return None
    return out[:k].copy()
