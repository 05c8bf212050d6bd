#!/usr/bin/env python3
"""Where the PyTorch port's detection paths spend their time on a CUDA card.

Default: drives ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic VGA
YUV420 frames with the reference default architecture (random weights,
seed 0, bf16 compute), as chip_smoke.py does, in two settings:

  * default capacities [640, 256]: what a user gets; frames that saturate
    are re-dispatched one by one with doubled capacities;
  * open capacities [5061, 4096]: the same survivors in ONE batched pass,
    i.e. the cost of the batched program itself.

``--dense``: the dense path instead, ``CascadeDetector.detect_batch`` on 4
synthetic 450x450 RGB frames at window scale factor 1.005 (131,903
windows, crop mode, kernel K2 for stage 0), in three settings: default
capacities [16512, 4224]; open capacities [131903, 131903] (the last
rung of escalation), as one batched pass; and default capacities with
``dyn_reextract="on"`` (kernel K4 for re-extraction).

For each setting it prints the median wall time of a batch, the kernel
launches per batch, the host time spent in NMS (``serve.postprocess_raw``,
which decodes every packed row, re-dispatched ones included), the device's
busy share (sum of kernel time over wall time, from torch.profiler) and
the kernels that take the most device time;
the full tables go to ``chiprun_out/profile_main_path.txt`` (or
``profile_dense_path.txt``). Run from the repository root on a machine with
a card: ``python3 tools/profile_torch_main_path.py [--dense]``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = "chiprun_out"


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if value is None else value


def _vga_case(cf, synthetic, cascade):
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

    frames = [
        rgb_to_yuv420(
            synthetic.make_scene(480, 640, n_faces=3, seed=s, min_face=48, max_face=120).image
        )
        for s in range(16)
    ]
    settings = [
        ("default caps", {"cascade_capacity_schedule": None}),
        ("open caps", {"cascade_capacity_schedule": [5061, 4096]}),
    ]
    return frames, settings, "detect_batch_yuv420", 5, "profile_main_path.txt"


def _dense_case(cf, synthetic, cascade):
    cf.set("window_scale_factor", 1.005)
    frames = [
        synthetic.make_scene(450, 450, n_faces=3, seed=100 + s, min_face=40, max_face=160).image
        for s in range(4)
    ]
    n_windows = 131903
    caps = cascade.default_capacity_schedule(n_windows, 3)
    while True:
        wider = cascade.escalate_capacities(caps, n_windows)
        if wider is None:
            break
        caps = wider
    settings = [
        ("default caps", {"cascade_capacity_schedule": None, "dyn_reextract": "auto"}),
        ("open caps {}".format(caps),
         {"cascade_capacity_schedule": caps, "dyn_reextract": "auto"}),
        ("default caps, dyn_reextract on",
         {"cascade_capacity_schedule": None, "dyn_reextract": "on"}),
    ]
    return frames, settings, "detect_batch", 2, "profile_dense_path.txt"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dense", action="store_true",
                        help="profile the 450x450 scale-factor-1.005 crop-mode path")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        windows_cuda,
        windows_dyn_cuda,
        windows_sched_cuda,
    )

    from rapidobjectdetectionusingcascadedcnns_torch import serve

    kernels = (("K1", windows_cuda), ("K2", windows_sched_cuda), ("K4", windows_dyn_cuda))
    # host NMS time: every decoded packed row goes through postprocess_raw
    nms = {"s": 0.0, "calls": 0}
    postprocess = serve.postprocess_raw

    def timed_postprocess(*a, **k):
        t0 = time.perf_counter()
        try:
            return postprocess(*a, **k)
        finally:
            nms["s"] += time.perf_counter() - t0
            nms["calls"] += 1

    serve.postprocess_raw = timed_postprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    case = _dense_case if args.dense else _vga_case
    frames, settings, method, reps, out_name = case(cf, synthetic, cascade)
    model = cascade.build_cascade_model(seed=0, device="cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    print("card:", card)
    tables = []
    for label, keys in settings:
        for key, value in keys.items():
            cf.set(key, value)
        det = cascade.CascadeDetector(model)
        detect = getattr(det, method)
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):  # saturation warnings
            detect(frames)
            det.redispatches = 0
            for _, module in kernels:
                module.LAUNCHES = 0
            nms.update(s=0.0, calls=0)
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = detect(frames)
                walls.append(time.perf_counter() - t0)
            redispatches = det.redispatches // reps
            launches = ", ".join(
                "{} {}".format(name, module.LAUNCHES // reps) for name, module in kernels
            )
            nms_s, nms_calls = nms["s"] / reps, nms["calls"] // reps
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                detect(frames)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = sum(_self_device_us(e) for e in events)
        med = statistics.median(walls)
        print("{}: batch wall median {:.4f} s of {} -> {:.2f} frames/s; re-dispatches "
              "{}, launches per batch {}; host NMS {:.4f} s per batch over {} decoded "
              "rows; survivors frame 0 {}".format(
                  label, med, [round(w, 4) for w in walls], len(frames) / med,
                  redispatches, launches, nms_s, nms_calls, res[0].n_survivors_per_stage))
        print("{}: profiled batch wall {:.4f} s, device kernel time {:.4f} s, busy "
              "share {:.3f}".format(label, prof_wall, device_us / 1e6,
                                   device_us / 1e6 / prof_wall))
        top = sorted(events, key=lambda e: -_self_device_us(e))[:12]
        for e in top:
            print("  {:>9.3f} ms {:>6.1%} x{:<5d} {}".format(
                _self_device_us(e) / 1e3, _self_device_us(e) / max(device_us, 1),
                e.count, e.key[:90]))
        sort_key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                    else "self_cuda_time_total")
        tables.append("== {} ==\n{}\n".format(
            label, prof.key_averages().table(sort_by=sort_key, row_limit=60)))
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write("card: {}\n".format(card) + "".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
