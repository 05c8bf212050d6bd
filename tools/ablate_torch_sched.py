#!/usr/bin/env python3
"""Where kernel K2 (``csrc/sched.cu``) spends its time on a CUDA card: the
kernel as built beside copies with one phase taken out or another launch
shape, timed in turns at the FDDB-density inputs of ``chip_smoke.py``
phase 7 (4 frames of 450x450 at scale factor 1.005, 132,480 slots).

    python3 tools/ablate_torch_sched.py

Each variant is the source with a text edit, built with ``nvcc`` into
``chiprun_out/ablate_sched/`` and called through the same C entry point:

  * ``as built``;
  * ``no staging loads``: the support is not copied into shared memory
    (sampling reads whatever is there);
  * ``no sampling``: the output tile is stored unwritten;
  * ``taps, compaction and stores``: both taken out;
  * ``1 block of 1024 threads an SM`` and ``2 blocks of 256 threads an
    SM``: the launch shape.

The ablated variants compute wrong values by design; the others are held
against the plain version. Prints the median time of each (20 samples of
10 calls between CUDA events) in two rounds, with the card's name and power
limit. An edit that no longer matches the source raises.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "rapidobjectdetectionusingcascadedcnns_torch", "csrc")
OUT = os.path.join(ROOT, "chiprun_out", "ablate_sched")
STAGING = ("    if (staged) {\n      int e = threadIdx.x;",
           "    if (false) {\n      int e = threadIdx.x;")
SAMPLING = ("""    if (staged) {
      sample_tile<kC, true>(rtab, ctab, stage, plane, w, n_cols, out_h, out_w, otile);
    } else {
      sample_tile<kC, false>(rtab, ctab, frame, plane, w, n_cols, out_h, out_w, otile);
    }""", "")
VARIANTS = {
    "as built": [],
    "no staging loads": [STAGING],
    "no sampling": [SAMPLING],
    "taps, compaction and stores": [STAGING, SAMPLING],
    "1 block of 1024 threads an SM": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "2 blocks of 256 threads an SM": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
}
EXACT = ("as built", "1 block of 1024 threads an SM", "2 blocks of 256 threads an SM")


def build() -> dict:
    from rapidobjectdetectionusingcascadedcnns_torch.ops import _build

    with open(os.path.join(CSRC, "sched.cu")) as f:
        source = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant {!r}: its edit no longer matches sched.cu".format(name))
            text = text.replace(old, new)
        path = os.path.join(OUT, "v{}.cu".format(k))
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", path[:-3] + ".so", path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), path[:-3] + ".so")
    fns = {}
    symbol, argtypes = _build.SIGNATURES["sched"]
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for {!r}:\n{}".format(name, log))
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        pyramid,
        windows,
        windows_sched,
        windows_sched_cuda,
    )

    if not torch.cuda.is_available():
        print("ablate_torch_sched: needs a CUDA card", file=sys.stderr)
        return 2
    fns = build()
    dev = torch.device("cuda")
    plan = pyramid.build_plan(*chip_smoke.DENSE_HW, 12, 12, 0.075, chip_smoke.DENSE_WSF)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=dev)
    frames = chip_smoke.dense_frames(chip_smoke.DENSE_FRAMES)
    planes = windows.to_planes_bf16(torch.as_tensor(np.stack(frames), device=dev).float())
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, dev)
    b, c, h, w = planes.shape
    smem, budget = windows_sched_cuda.launch_geometry(sched.tile, 12, 12, c)
    ref = windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        err = fn(planes.data_ptr(), sy.data_ptr(), sx.data_ptr(), tiles.data_ptr(),
                 out.data_ptr(), b, sched.n_slots, c, h, w, 12, 12, sched.tile, budget, smem,
                 stream)
        if err != 0:
            raise RuntimeError("launch failed: cudaError {}".format(err))

    card = chip_smoke._nvidia_smi()
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(chip_smoke._median_ms(lambda: call(fn), torch))
            if name in EXACT:
                out.zero_()
                call(fn)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise RuntimeError("variant {!r} differs from the plain version".format(name))
    for name, ms in times.items():
        print("K2 {}: {} ms (median {:.4f}) [{}]".format(
            name, [round(x, 4) for x in ms], statistics.median(ms), card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
