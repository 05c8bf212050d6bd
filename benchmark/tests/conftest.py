"""A checkout-shaped directory with the benchmark's files and tiny traffic
(96 x 128 frames two to a request; 64 x 64 frames at scale 1.02, whose 84
levels take the crop-mode path; two traced requests a session), for runs
of whole cells on the CPU.

The manifest there also holds ``HELD_OUT``: cells whose files stay in
``benchmark/`` while ``BENCHMARK.json`` leaves them out (the port fails
them; PERF.md, Open questions), so that those files stay tested."""

from __future__ import annotations

import json
import os
import shutil

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

HELD_OUT = [
    {"name": "dense-fddb-450", "config": "cascade-12-24-48", "traffic": "fddb-450-single",
     "chips": 1, "why": "one 450x450 RGB image a call at scale 1.005 (131,903 windows), "
     "closed loop: FDDB evaluation; K2, stage-0 CNN and host NMS of ~3,000 survivors"},
]

TINY = {
    "vga-yuv420-batch16": {"frame": {"height": 96, "width": 128, "min_face": 24, "max_face": 40},
                           "frames_per_request": 2, "pool_frames": 4,
                           "survivors_per_frame": [40, 10, 8]},
    "fddb-450-single": {"frame": {"height": 64, "width": 64, "min_face": 20, "max_face": 40},
                        "frames_per_request": 1, "pool_frames": 2,
                        "detector": {"window_scale_factor": 1.02},
                        "survivors_per_frame": [200, 40, 30]},
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"] += HELD_OUT
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        path = os.path.join(root, "benchmark", "traffic", name + ".json")
        with open(path) as f:
            traffic = json.load(f)
        traffic["frame"].update(cut["frame"])
        traffic["frames_per_request"] = cut["frames_per_request"]
        traffic["pool_frames"] = cut["pool_frames"]
        traffic["detector"] = cut.get("detector", traffic["detector"])
        traffic["calibration"]["survivors_per_frame"] = cut["survivors_per_frame"]
        with open(path, "w") as f:
            json.dump(traffic, f)
    for name in os.listdir(os.path.join(root, "benchmark", "workloads")):
        path = os.path.join(root, "benchmark", "workloads", name)
        with open(path) as f:
            workload = json.load(f)
        workload["trace_requests"] = 2
        with open(path, "w") as f:
            json.dump(workload, f)
    return root
