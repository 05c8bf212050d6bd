#!/usr/bin/env python3
"""Time kernels K1, K2, K3, K4 and K2p of two checkouts of the PyTorch port
on one CUDA card, in turns, at the shapes ``chip_smoke.py`` uses.

    python3 tools/compare_torch_kernels.py OTHER_DIR

``OTHER_DIR`` is another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. The two packages share a name, so each checkout runs
in a process of its own, in the order other, this tree, this tree, other.
Each process builds its checkout's kernels, makes the same inputs from the
same seeds with the package's own functions, and times (median of 20
samples, each 10 calls back to back between two CUDA events):

  * K1 (``windows_cuda.crop_and_resize_cuda``): 16 VGA frames with 640
    boxes at 24 px and 256 at 48 px, and 4 frames of 450x450 with 16,512
    boxes at 24 px and 4,224 at 48 px (window boxes of each pyramid);
  * K2 (``windows_sched_cuda.resample_sched_cuda``): every slot of the
    FDDB-density schedule (4 frames of 450x450 at scale factor 1.005,
    132,480 slots at 12 px), as phase 7 of ``chip_smoke.py``;
  * K3 (``nms_cuda.group_rectangles_cuda``, min_neighbors 1, eps 0.2): the
    VGA batch's last-stage survivors at capacities [5061, 4096] (N = 4096)
    and [640, 256] (N = 256), and the dense batch's at [16512, 4224]
    (N = 4,224), with random weights from seed 0;
  * K4 (``windows_dyn_cuda.resample_rowbound_cuda``): the same 4 frames
    with 16,512 plan boxes at 24 px and 4,224 at 48 px drawn as phase 8 of
    ``chip_smoke.py`` draws them, laid out by ``windows_dyn.small_class``;
  * K2p (``windows_sched_precomp_cuda.resample_sched_precomp_cuda``): K2's
    frames and schedule with the 1,617.8 MB of tap matrices of
    ``windows_sched.precompute_tap_matrices``, as phase 14 of
    ``chip_smoke.py``.

Prints one line per process and a summary with the card's name and power
limit; the numbers also go to ``chiprun_out/compare_kernels.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WORKER = r'''
import json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import (
    _build, nms_cuda, pyramid, windows, windows_cuda, windows_dyn, windows_dyn_cuda, windows_sched,
    windows_sched_cuda, windows_sched_precomp_cuda)
from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420, yuv420_to_rgb

_build.build(["resample", "sched", "cluster", "rowbound", "sched_precomp"])
dev = torch.device("cuda")
out = {}

def median_ms(fn, reps=10, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)

def k1(label, planes, coords, shapes):
    gen = torch.Generator(device=dev).manual_seed(0)
    for size, n in shapes:
        ids = torch.randint(0, coords.shape[0], (planes.shape[0], n), generator=gen, device=dev)
        sy, sx = windows.sample_positions(coords[ids], planes.shape[2], planes.shape[3], size, size)
        sy, sx = sy.contiguous(), sx.contiguous()
        out["K1 {} {} frames x {} boxes at {} px".format(label, planes.shape[0], n, size)] = median_ms(
            lambda: windows_cuda.crop_and_resize_cuda(planes, sy, sx))

def k3(label, det, frames, caps, yuv, hw):
    entry = det._plan_and_table(*hw)
    packed = det._run_chunk(frames, yuv, caps, entry, None)
    c = caps[-1]
    xyxy = entry[2][packed[:, :c].long()].float()
    rects = torch.cat([xyxy[..., :2], xyxy[..., 2:] - xyxy[..., :2]], dim=-1).contiguous()
    alive = (packed[:, 2 * c : 3 * c] > 0.5).contiguous()
    out["K3 {} {} frames x N = {}".format(label, alive.shape[0], c)] = median_ms(
        lambda: nms_cuda.group_rectangles_cuda(rects, alive, 1, 0.2))

def k2(images, plan):
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=dev)
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, dev)
    planes = windows.to_planes_bf16(images)
    out["K2 dense {} frames x {} slots at 12 px".format(planes.shape[0], sched.n_slots)] = median_ms(
        lambda: windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile))

def k2p(images, plan):
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=dev)
    taps = windows_sched.precompute_tap_matrices(sched, boxes)
    tiles = sched.device_tables(dev)[1]
    planes = windows.to_planes_bf16(images)
    out["K2p dense {} frames x {} slots, {:.1f} MB of taps".format(
        planes.shape[0], sched.n_slots, windows_sched.tap_bytes(taps) / 1e6)] = median_ms(
        lambda: windows_sched_precomp_cuda.resample_sched_precomp_cuda(planes, taps, tiles, sched))

def k4(images, plan):
    coords = torch.as_tensor(pyramid.window_table(plan)["coords_norm"]).float()
    gen = torch.Generator().manual_seed(7)
    for size, n in ((24, 16512), (48, 4224)):
        boxes = coords[torch.randint(0, plan.n_windows, (images.shape[0], n), generator=gen)]
        lay = windows_dyn.small_class(images, boxes.to(dev), size, size)
        args = (lay["planes"], lay["sy_local"], lay["sx"], lay["cell_start"], lay["tile"],
                windows_dyn.ROW_RUNG, lay["w_pad"])
        out["K4 dense {} frames x {} boxes at {} px".format(images.shape[0], n, size)] = median_ms(
            lambda: windows_dyn_cuda.resample_rowbound_cuda(*args))

dense = [synthetic.make_scene(450, 450, n_faces=3, seed=100 + s, min_face=40, max_face=160).image
         for s in range(4)]
plan = pyramid.build_plan(450, 450, 12, 12, 0.075, 1.005)
dense_images = torch.as_tensor(np.stack(dense), device=dev).float()
model = cascade.build_cascade_model(seed=0, device=dev)
det = cascade.CascadeDetector(model)
vga = [rgb_to_yuv420(synthetic.make_scene(480, 640, n_faces=3, seed=s, min_face=48,
                                          max_face=120).image) for s in range(16)]
y = torch.as_tensor(np.stack([f[0] for f in vga]), device=dev)
uv = torch.as_tensor(np.stack([f[1] for f in vga]), device=dev)
k1("VGA", windows.to_planes_bf16(yuv420_to_rgb(y, uv)), det._plan_and_table(480, 640)[2].float(),
   [(24, 640), (48, 256)])
k1("dense", windows.to_planes_bf16(dense_images),
   torch.as_tensor(pyramid.window_table(plan)["coords_norm"], device=dev).float(),
   [(24, 16512), (48, 4224)])
k2(dense_images, plan)
k3("VGA", det, vga, [5061, 4096], True, (480, 640))
k3("VGA", det, vga, [640, 256], True, (480, 640))
cf.set("window_scale_factor", 1.005)
k3("dense", cascade.CascadeDetector(model), dense, [16512, 4224], False, (450, 450))
k4(dense_images, plan)
k2p(dense_images, plan)
print("RESULT " + json.dumps(out))
'''


def _run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError("worker in {} failed:\n{}".format(tree, proc.stderr[-3000:]))
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="another checkout of the repository")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    runs = []
    for label, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        result = _run(tree)
        runs.append((label, result))
        print("{} ({}): {}".format(label, tree, json.dumps({k: round(v, 4) for k, v in result.items()})))
    summary = {}
    for key in runs[0][1]:
        mine = [r[key] for label, r in runs if label == "this"]
        theirs = [r[key] for label, r in runs if label == "other"]
        summary[key] = {"this_ms": mine, "other_ms": theirs}
        print("{}: this tree {} ms, other {} ms [{}]".format(
            key, [round(x, 4) for x in mine], [round(x, 4) for x in theirs], card))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "compare_kernels.json"), "w") as f:
        json.dump({"card": card, "other": other, "kernels": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
