#!/usr/bin/env python3
"""Where kernel K2 (``csrc/sched.cu``) or K2p (``csrc/sched_precomp.cu``)
spends its time on a CUDA card: the kernel as built beside copies with one
phase taken out or another launch shape, timed in turns at the
FDDB-density inputs of ``chip_smoke.py`` phases 7 and 14 (4 frames of
450x450 at scale factor 1.005, 132,480 slots; K2p with its 1,617.8 MB of
tap matrices).

    python3 tools/ablate_torch_sched.py [k2|k2p]

Each variant is the kernel's source and the shared ``csrc/sched_tile.cuh``
with text edits, built with ``nvcc`` into ``chiprun_out/ablate_sched/``
and called through the same C entry point. K2's variants:

  * ``as built``;
  * ``no staging loads``: the support is not copied into shared memory
    (sampling reads whatever is there);
  * ``no sampling``: the output tile is stored unwritten;
  * ``taps, compaction and stores``: both taken out;
  * ``1 block of 1024 threads an SM`` and ``2 blocks of 256 threads an
    SM``: the launch shape.

K2p's: ``as built``; ``stream only`` (phases 2-5 taken out, nothing
stored); ``bytes only`` (the stages' reduction taken out too: the bulk
copies and barriers alone); ``no staging loads``, ``no sampling`` and
``stream, compaction and stores`` as for K2; ``ring of 2 (4, 6)
stages``: the ring's depth over the same bytes; ``L2 evict_normal``: the
tap stream without its evict-first policy.

The ablated variants compute wrong values by design; the others are held
against the plain version. Prints the median time of each (20 samples of
10 calls between CUDA events) in two rounds, with the card's name and power
limit. An edit that no longer matches the sources raises.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "rapidobjectdetectionusingcascadedcnns_torch", "csrc")
OUT = os.path.join(ROOT, "chiprun_out", "ablate_sched")
HEADER = "sched_tile.cuh"
STAGING = ("    if (staged) {\n      int e = threadIdx.x;",
           "    if (false) {\n      int e = threadIdx.x;")
SAMPLING = ("""    if (staged) {
      sample_tile<kC, true>(s.rtab, s.ctab, stage, plane, w, n_cols, out_h, out_w, s.otile);
    } else {
      sample_tile<kC, false>(s.rtab, s.ctab, frame, plane, w, n_cols, out_h, out_w, s.otile);
    }""", "")
FINISH = ("""  finish_tile<kC>(s, planes, out, frames, n_slots, h, w, out_h, out_w, tile, budget,
                  (long long)t * tile, row0, col0, is_mapped);""", "")
REDUCE = [("reduce_ry(src, r0, min(ry_rows, n_rows - r0), cell_r, lim_r, is_mapped, s, bad);", ""),
          ("reduce_rx(src, c0, min(rx_rows, cell_c - c0), n_cols, s);", "")]
L2_HINT = ("createpolicy.fractional.L2::evict_first.b64", "createpolicy.fractional.L2::evict_normal.b64")


def _stages(n):
    return ("constexpr int kStages = 3;", "constexpr int kStages = {};".format(n))


# kernel: (source, C entry point's build name, {variant: (edits, ring stages)}, exact variants)
KERNELS = {
    "k2": ("sched.cu", "sched", {
        "as built": ([], None),
        "no staging loads": ([STAGING], None),
        "no sampling": ([SAMPLING], None),
        "taps, compaction and stores": ([STAGING, SAMPLING], None),
        "1 block of 1024 threads an SM": ([
            ("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
            ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")], None),
        "2 blocks of 256 threads an SM": ([
            ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")], None),
    }, ("as built", "1 block of 1024 threads an SM", "2 blocks of 256 threads an SM")),
    "k2p": ("sched_precomp.cu", "sched_precomp", {
        "as built": ([], 3),
        "stream only": ([FINISH], 3),
        "bytes only": ([FINISH] + REDUCE, 3),
        "no staging loads": ([STAGING], 3),
        "no sampling": ([SAMPLING], 3),
        "stream, compaction and stores": ([STAGING, SAMPLING], 3),
        "ring of 2 stages": ([_stages(2)], 2),
        "ring of 4 stages": ([_stages(4)], 4),
        "ring of 6 stages": ([_stages(6)], 6),
        "L2 evict_normal": ([L2_HINT], 3),
    }, ("as built", "ring of 2 stages", "ring of 4 stages", "ring of 6 stages", "L2 evict_normal")),
}


def build(kernel: str) -> dict:
    """Build every variant of ``kernel``; returns {variant: C entry point}."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import _build

    source, name, variants, _ = KERNELS[kernel]
    texts = {}
    for fname in (source, HEADER):
        with open(os.path.join(CSRC, fname)) as f:
            texts[fname] = f.read()
    procs = {}
    for k, (variant, (edits, _)) in enumerate(variants.items()):
        edited = dict(texts)
        for old, new in edits:
            hits = [f for f, text in edited.items() if old in text]
            if len(hits) != 1:
                raise RuntimeError("variant {!r}: its edit matches {} of {}".format(
                    variant, len(hits), sorted(edited)))
            edited[hits[0]] = edited[hits[0]].replace(old, new)
        # the edited header sits beside the edited source, which includes it
        # before the -I directory's
        folder = os.path.join(OUT, "{}_v{}".format(kernel, k))
        os.makedirs(folder, exist_ok=True)
        for fname, text in edited.items():
            with open(os.path.join(folder, fname), "w") as f:
                f.write(text)
        lib = os.path.join(folder, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", lib,
               os.path.join(folder, source)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), lib)
    fns = {}
    symbol, argtypes = _build.SIGNATURES[name]
    for variant, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for {!r}:\n{}".format(variant, log))
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[variant] = fn
    return fns


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        pyramid,
        windows,
        windows_sched,
        windows_sched_cuda,
        windows_sched_precomp_cuda,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kernel", nargs="?", default="k2", choices=sorted(KERNELS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_torch_sched: needs a CUDA card", file=sys.stderr)
        return 2
    fns = build(args.kernel)
    _, _, variants, exact = KERNELS[args.kernel]
    dev = torch.device("cuda")
    plan = pyramid.build_plan(*chip_smoke.DENSE_HW, 12, 12, 0.075, chip_smoke.DENSE_WSF)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=dev)
    frames = chip_smoke.dense_frames(chip_smoke.DENSE_FRAMES)
    planes = windows.to_planes_bf16(torch.as_tensor(np.stack(frames), device=dev).float())
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, dev)
    b, c, h, w = planes.shape
    stream = torch.cuda.current_stream().cuda_stream
    if args.kernel == "k2":
        smem, budget = windows_sched_cuda.launch_geometry(sched.tile, 12, 12, c)
        ref = windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)

        def launch(fn, stages):
            return fn(planes.data_ptr(), sy.data_ptr(), sx.data_ptr(), tiles.data_ptr(),
                      out.data_ptr(), b, sched.n_slots, c, h, w, 12, 12, sched.tile, budget,
                      smem, stream)
    else:
        taps = windows_sched.precompute_tap_matrices(sched, boxes)
        table = torch.as_tensor(windows_sched_precomp_cuda.class_table(sched, taps), device=dev)
        violations = torch.zeros(1, dtype=torch.int32, device=dev)
        ref = windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)

        def launch(fn, stages):
            smem, budget, stage = windows_sched_precomp_cuda.launch_geometry(
                sched.tile, 12, 12, c, stages)
            return fn(planes.data_ptr(), table.data_ptr(), tiles.data_ptr(), out.data_ptr(),
                      violations.data_ptr(), b, sched.n_slots,
                      table.shape[0], c, h, w, 12, 12, sched.tile, budget, stage, smem, stream)
    out = torch.empty_like(ref)

    def call(variant):
        err = launch(fns[variant], variants[variant][1])
        if err != 0:
            raise RuntimeError("launch failed: cudaError {}".format(err))

    card = chip_smoke._nvidia_smi()
    times = {variant: [] for variant in fns}
    for _ in range(2):
        for variant in fns:
            times[variant].append(chip_smoke._median_ms(lambda: call(variant), torch))
            if variant in exact:
                out.zero_()
                call(variant)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise RuntimeError("variant {!r} differs from the plain version".format(
                        variant))
    for variant, ms in times.items():
        print("{} {}: {} ms (median {:.4f}) [{}]".format(
            args.kernel.upper(), variant, [round(x, 4) for x in ms], statistics.median(ms), card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
