"""ctypes bindings for the native host-runtime kernels (native/rodc_native.cc
at the repository root), the port's copy of the JAX package's ``native.py``.

The shared library is built on first use by ``native/Makefile`` (g++, a
plain C ABI bound with ctypes) into the port's own build directory,
``_build/`` inside the package, named by a hash of the source, the Makefile
and the host CPU: ``make`` is given the target's path, so it never writes the JAX package's ``native/librodc_native.so``. A build runs
under a cross-process file lock into a temporary name that ``os.replace``
moves into place, so no process sees a half-written library. Without a compiler
every entry point returns None and callers use the numpy implementations
(logged once); a library that was built and then fails to load raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .utils import log

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCE = os.path.join(NATIVE_DIR, "rodc_native.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code is built for it."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library built from the current source, Makefile and host
    CPU lives."""
    digest = hashlib.sha256(_cpu_model().encode())
    for path in (SOURCE, os.path.join(NATIVE_DIR, "Makefile")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir, "librodc_native_{}.so".format(digest.hexdigest()[:16]))


def build(build_dir: str = BUILD_DIR) -> Optional[str]:
    """Build the library into ``build_dir`` unless it is there already;
    returns its path, or None when the compiler is missing or fails."""
    target = library_path(build_dir)
    if os.path.exists(target):
        return target
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(target):  # another process built it meanwhile
                return target
            tmp = "{}.tmp{}".format(target, os.getpid())
            try:
                subprocess.run(
                    ["make", "-s", "-C", NATIVE_DIR, "TARGET=" + os.path.abspath(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError) as exc:
                log.log("native build unavailable ({}); host NMS runs its numpy "
                        "version".format(exc))
                return None
            os.replace(tmp, target)
            return target
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None without a
    compiler."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build()
        if path is None:
            _load_failed = True
            return None
        lib = ctypes.CDLL(path)
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
        log.log("native host library loaded from {}".format(path))
        _lib = lib
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
