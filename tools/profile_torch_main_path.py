#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on a CUDA card.

Drives ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic VGA YUV420
frames with the reference default architecture (random weights, seed 0,
bf16 compute), as chip_smoke.py does, in two settings:

  * default capacities [640, 256]: what a user gets; frames that saturate
    are re-dispatched one by one with doubled capacities;
  * open capacities [5061, 4096]: the same survivors in ONE batched pass,
    i.e. the cost of the batched program itself.

For each it prints the median wall time of a 16-frame batch, the device's
busy share (sum of kernel time over wall time, from torch.profiler) and
the kernels that take the most device time; the full tables go to
``chiprun_out/profile_main_path.txt``. Run from the repository root on a
machine with a card: ``python3 tools/profile_torch_main_path.py``.
"""

from __future__ import annotations

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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    frames = [
        rgb_to_yuv420(
            synthetic.make_scene(480, 640, n_faces=3, seed=s, min_face=48, max_face=120).image
        )
        for s in range(16)
    ]
    model = cascade.build_cascade_model(seed=0, device="cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    print("card:", card)
    tables = []
    for label, caps in (("default caps", None), ("open caps", [5061, 4096])):
        cf.set("cascade_capacity_schedule", caps)
        det = cascade.CascadeDetector(model)
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):  # saturation warnings
            det.detect_batch_yuv420(frames)
            det.redispatches = 0
            windows_cuda.LAUNCHES = 0
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = det.detect_batch_yuv420(frames)
                walls.append(time.perf_counter() - t0)
            redispatches = det.redispatches // 5
            launches = windows_cuda.LAUNCHES // 5
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                det.detect_batch_yuv420(frames)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        device_us = sum(_self_device_us(e) for e in events)
        med = statistics.median(walls)
        print("{}: batch wall median {:.4f} s of {} -> {:.2f} frames/s; re-dispatches "
              "{}, K1 launches {} per batch; survivors frame 0 {}".format(
                  label, med, [round(w, 4) for w in walls], 16 / med, redispatches,
                  launches, res[0].n_survivors_per_stage))
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
    with open(os.path.join(OUT_DIR, "profile_main_path.txt"), "w") as f:
        f.write("card: {}\n".format(card) + "".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
