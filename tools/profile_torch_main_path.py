#!/usr/bin/env python3
"""Where the PyTorch port's detection paths spend their time on a CUDA card.

Default: drives ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic VGA
YUV420 frames with the reference default architecture (random weights,
seed 0, bf16 compute), as chip_smoke.py does, in two settings:

  * default capacities [640, 256]: what a user gets; frames that saturate
    are re-dispatched one by one with doubled capacities;
  * open capacities [5061, 4096]: the same survivors in ONE batched pass,
    i.e. the cost of the batched program itself;
  * with ``--nms-on-device`` also default capacities with the device NMS
    tail (groupRectangles as kernel K3 at the end of every program, no
    host NMS).

``--dense``: the dense path instead, ``CascadeDetector.detect_batch`` on 4
synthetic 450x450 RGB frames at window scale factor 1.005 (131,903
windows, crop mode, kernel K2 for stage 0), in three settings: default
capacities [16512, 4224]; open capacities [131903, 131903] (the last
rung of escalation), as one batched pass; and default capacities with
``dyn_reextract="on"`` (kernel K4 for re-extraction).

``--flagship``: the port-trained flagship (``artifacts/model_torch_flagship_*``
from tools/train_torch_flagship.py) at its recorded operating point
(threshold and min_neighbors of ``artifacts/torch_flagship_eval.json``)
instead of random weights; the VGA path then also runs at the capacities
``capacity_schedule_from_quality`` gives from its measured survivor maxima,
first.

For each setting it prints the median wall time of a batch, the kernel
launches per batch, and, from one batch under torch.profiler: the
detector's ``counters`` over that batch (frames, upload bytes, rows each
stage launched, skipped and needed, re-dispatches), the card's idle time split by
the host span open at each idle instant (``utils/profiling.span_report``:
between calls, upload and dispatch, read-back and decode, other), each
``rodc.*`` span's count and host, device and idle time (host NMS is
``rodc.host_nms``), and the kernels that take the most device time;
the full tables go to ``chiprun_out/profile_main_path.txt`` (or
``profile_dense_path.txt``, with ``_flagship`` before the suffix for
``--flagship``). Run from the repository root on a machine with a card:
``python3 tools/profile_torch_main_path.py [--dense] [--nms-on-device]
[--flagship]``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT_DIR = "chiprun_out"


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if value is None else value


def _chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _delta(after, before):
    if isinstance(after, list):
        return [a - b for a, b in zip(after, before)]
    return after - before


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
    parser.add_argument("--nms-on-device", action="store_true",
                        help="VGA path: add default capacities with the device NMS tail (K3)")
    parser.add_argument("--flagship", action="store_true",
                        help="the port-trained flagship at its operating point, not random "
                        "weights")
    args = parser.parse_args(argv)
    if args.dense and args.nms_on_device:
        parser.error("--nms-on-device profiles the VGA path only")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        nms_cuda,
        windows_cuda,
        windows_dyn_cuda,
        windows_sched_cuda,
    )

    from rapidobjectdetectionusingcascadedcnns_torch import native
    from rapidobjectdetectionusingcascadedcnns_torch.utils import profiling

    kernels = (("K1", windows_cuda), ("K2", windows_sched_cuda), ("K4", windows_dyn_cuda),
               ("K3", nms_cuda))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    case = _dense_case if args.dense else _vga_case
    frames, settings, method, reps, out_name = case(cf, synthetic, cascade)
    if args.nms_on_device:  # last, so the settings before it keep host NMS
        settings.append(("default caps, nms_on_device",
                         {"cascade_capacity_schedule": None, "nms_on_device": True}))
    if args.flagship:
        import train_torch_flagship as flagship

        model, quality = flagship.load_flagship(), flagship.load_flagship_quality()
        if model is None or quality is None:
            print("no port flagship: run tools/train_torch_flagship.py", file=sys.stderr)
            return 2
        cf.set("foreground_confidence_threshold", quality["threshold"])
        cf.set("nms_opencv_min_neighbors", quality["min_neighbors"])
        if not args.dense:
            caps = flagship.capacity_schedule_from_quality(quality)
            settings.insert(0, ("flagship caps {}".format(caps),
                                {"cascade_capacity_schedule": caps}))
        out_name = out_name.replace(".txt", "_flagship.txt")
        print("flagship: threshold {}, min_neighbors {}, survivors max {}".format(
            quality["threshold"], quality["min_neighbors"], quality["survivors_max"]))
    else:
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
            before = copy.deepcopy(det.counters)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                detect(frames)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        counters = {k: _delta(v, before[k]) for k, v in det.counters.items()}
        report = profiling.span_report(_chrome_events(prof))
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("rodc.")]  # kernels, not the spans over them
        device_us = sum(_self_device_us(e) for e in events)
        med = statistics.median(walls)
        print("{}: batch wall median {:.4f} s of {} -> {:.2f} frames/s; re-dispatches "
              "{}, launches per batch {} (native.available() {}); survivors frame 0 "
              "{}".format(label, med, [round(w, 4) for w in walls], len(frames) / med,
                          redispatches, launches, native.available(),
                          res[0].n_survivors_per_stage))
        print("{}: profiled batch wall {:.4f} s; counters {}".format(
            label, prof_wall, json.dumps(counters)))
        print("{}: card idle {:.5f} of the profiler's {:.5f} s: {}; host-to-device copies "
              "under rodc.upload {:.5f} s".format(
                  label, report["idle_s"], report["window_s"],
                  ", ".join("{} {:.5f}".format(k, v) for k, v in report["idle"].items()),
                  report["h2d_s"]))
        for name, row in sorted(report["spans"].items()):
            print("  {:<22} x{:<4d} host {:>9.3f} ms, device {:>9.3f} ms, card idle {:>8.3f} "
                  "ms".format(name, row["count"], row["host_s"] * 1e3, row["device_s"] * 1e3,
                              row["idle_s"] * 1e3))
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
