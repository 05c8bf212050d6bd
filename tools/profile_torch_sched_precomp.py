#!/usr/bin/env python3
"""Experiment: precomputed tap matrices (kernel K2p) against taps built in
the kernel (kernel K2), in the PyTorch port on a CUDA card.

The port's counterpart of ``tools/profile_sched_precomp.py``. The scheduled
stage-0 extraction resamples every window of a static pyramid plan inside
its tile's image cell. K2 (``csrc/sched.cu``) computes each output's two
taps from its sampling position; K2p (``csrc/sched_precomp.cu``) reads
them from the two-tap triangle weight matrices RY and RX of every tile,
built once per plan by ``windows_sched.precompute_tap_matrices`` and kept
in device memory. Both give the same u8-lattice windows.

For the chosen geometry it prints the windows, tiles and cell classes, the
tap matrices' size and build time, the mismatches of K2p against K2 on the
same frames and K2p's two-tap violations (nonzero taps besides a row's or
column's two), K2's and K2p's milliseconds per frame from CUDA events, the
rate at which K2p reads the taps, and the card's name and power limit from
nvidia-smi.

Run from the repository root on a machine with a card:

    python3 tools/profile_torch_sched_precomp.py [fddb|vga] [--frames N]

``fddb``: 450x450 at window scale factor 1.005 (131,903 windows); ``vga``:
480x640 at 1.1.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GEOMETRIES = {"fddb": (450, 450, 1.005), "vga": (480, 640, 1.1)}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, torch, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def setup(which: str, device, n_frames: int, seed: int = 0) -> dict:
    """The geometry's plan, schedule, window boxes and ``n_frames`` random
    u8 frames (as f32) on ``device``, and the tap matrices with their build
    time."""
    import numpy as np
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows_sched

    img_h, img_w, wsf = GEOMETRIES[which]
    plan = pyramid.build_plan(img_h, img_w, 12, 12, 0.075, wsf)
    boxes_np = pyramid.window_table(plan)["boxes_float"].astype(np.float32)
    sched = windows_sched.build_schedule(boxes_np, img_h, img_w, 12, 12)
    if sched is None:
        raise ValueError("no schedule for the {} geometry".format(which))
    rng = np.random.default_rng(seed)
    frames = torch.as_tensor(
        rng.integers(0, 256, (n_frames, img_h, img_w, 3)).astype(np.float32), device=device
    )
    boxes = torch.as_tensor(boxes_np, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    taps = windows_sched.precompute_tap_matrices(sched, boxes)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {
        "which": which, "plan": plan, "sched": sched, "boxes": boxes, "frames": frames,
        "taps": taps, "build_s": time.perf_counter() - t0,
        "tap_bytes": windows_sched.tap_bytes(taps),
    }


def profile(which: str = "fddb", n_frames: int = 4, device=None, iters: int = 10) -> dict:
    """Build the taps, hold K2p against K2 on the same frames and time both
    with CUDA events; prints a report and returns its numbers, with the
    number of K2p calls made (``calls``)."""
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_precomp_cuda as k2p_mod
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the profile times kernels on a CUDA card; got {}".format(device))
    ctx = setup(which, device, n_frames)
    sched, frames, boxes, taps = ctx["sched"], ctx["frames"], ctx["boxes"], ctx["taps"]
    classes = [(c.cell_r, c.cell_c, c.n_tiles) for c in sched.classes]
    print("{}: {} windows, {} tiles of {}, {} classes {} (cell rows, cols, tiles)".format(
        which, ctx["plan"].n_windows, sched.n_tiles, sched.tile, len(classes), classes))
    print("tap matrices: {:.1f} MB in {} classes, built in {:.3f} s".format(
        ctx["tap_bytes"] / 1e6, len(classes), ctx["build_s"]))

    def k2p():
        return windows_sched.extract_scheduled_precomp(frames, taps, sched)

    def k2():
        return windows_sched.extract_scheduled(frames, boxes, sched)

    k2p_mod.VIOLATIONS.clear()
    got, ref = k2p(), k2()
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    violations = k2p_mod.violation_count()
    print("K2p vs K2 on {} frames: {} of {} values differ; {} two-tap violations".format(
        n_frames, mismatches, ref.numel(), violations))
    del got, ref
    warmup = 2
    k2_ms = event_ms(k2, torch, warmup=warmup, iters=iters)
    k2p_ms = event_ms(k2p, torch, warmup=warmup, iters=iters)
    card = nvidia_smi()
    print("K2 (taps built in the kernel): {:.4f} ms/frame ({:.4f} ms for {} frames)".format(
        k2_ms / n_frames, k2_ms, n_frames))
    print("K2p (precomputed taps)       : {:.4f} ms/frame ({:.4f} ms for {} frames); taps "
          "read at {:.1f} GB/s".format(k2p_ms / n_frames, k2p_ms, n_frames,
                                       ctx["tap_bytes"] / k2p_ms / 1e6))
    print("card: {}".format(card))
    return {
        "ctx": ctx, "mismatches": mismatches, "violations": violations, "k2_ms": k2_ms,
        "k2p_ms": k2p_ms, "card": card, "calls": 1 + warmup + iters,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="fddb", choices=sorted(GEOMETRIES))
    parser.add_argument("--frames", type=int, default=4)
    args = parser.parse_args()
    result = profile(args.which, args.frames)
    return 0 if result["mismatches"] == 0 and result["violations"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
