"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``_build/`` inside the
package, named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header is rebuilt; a file lock keeps
concurrent processes from building the same library twice. Nothing is
built at import time. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# C signatures of the kernels' entry points: pointers and the stream as
# c_void_p (a plain int would be cut to 32 bits), ints as c_int, floats as
# c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "resample": ("rodc_resample", [_P, _P, _P, _P] + [_I] * 10 + [_P]),
    "sched": ("rodc_sched", [_P] * 5 + [_I] * 10 + [_P]),
    "sched_precomp": ("rodc_sched_precomp", [_P] * 5 + [_I] * 12 + [_P]),
    "rowbound": ("rodc_rowbound", [_P] * 5 + [_I] * 12 + [_P]),
    "cluster": ("rodc_cluster", [_P] * 7 + [_I] * 3 + [_F, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(SRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    return os.path.join(BUILD_DIR, "lib{}_{}.so".format(name, digest[:16]))


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, with one
    ``nvcc`` per source, all started together. Returns seconds per source
    built (0.0 when it was up to date); compiler output lands in
    ``build_logs``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            t0 = time.perf_counter()
            for name in names:
                target = _lib_path(name)
                if os.path.exists(target):
                    continue
                tmp = target + ".tmp{}".format(os.getpid())
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, name + ".cu")]
                procs[name] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                    ),
                    tmp,
                    target,
                )
            failed = []
            for name, (proc, tmp, target) in procs.items():
                out, _ = proc.communicate()
                build_logs[name] = out
                seconds[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append("{} (exit {}):\n{}".format(name, proc.returncode, out))
                    continue
                os.replace(tmp, target)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.exists(path):
        build([name])
    lib = ctypes.CDLL(path)
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib
