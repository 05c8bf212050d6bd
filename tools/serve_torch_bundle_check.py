#!/usr/bin/env python3
"""Check the port's serving bundles on the card with the port-trained
flagship (the port's counterpart of tools/serve_bundle_check.py).

Exports the flagship's VGA YUV420 cascade program (batch 16, 3 capacity
rungs, the device NMS tail), saves and reloads it, and on 32 synthetic
scenes checks that its detections are identical to the live
``CascadeDetector``'s; times the served rate against the live rate
(median of 3 passes over the 32 frames, each between two CUDA events);
then does the same for a ``batch="dynamic"`` bundle. Writes
``artifacts/torch_serving_check.json`` with the card's ``nvidia-smi`` name
and power limit beside every number.

The flagship is the gitignored checkpoint tools/train_torch_flagship.py
writes, at the threshold, min_neighbors and capacities of
``artifacts/torch_flagship_eval.json``; without it the tool runs random
weights (seed 0) of the flagship architecture and says so in ``weights``.

Usage, from the repository root on a machine with a card:

    python3 tools/serve_torch_bundle_check.py [--checkpoint artifacts/model_torch_flagship]
        [--device cpu]
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line, split_checkpoint  # noqa: E402

OUT_FILE = "torch_serving_check.json"
N_SCENES = 32
IMG_H, IMG_W = 480, 640


def load_operating_model(checkpoint, device):
    """The flagship checkpoint on ``device`` at its recorded operating
    point, with the device NMS tail on: (model, weights record, capacities
    or None). Random weights of the flagship architecture (seed 0, the
    default operating point) when there is no checkpoint."""
    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
    from rapidobjectdetectionusingcascadedcnns_torch.models.cascade import build_cascade_model

    model_dir, session_key = split_checkpoint(checkpoint)
    flagship.flagship_config(cf)
    cf.set("nms_on_device", True)
    try:
        model = bridge.load_cascade(model_dir, session_key, device)
    except FileNotFoundError:
        return build_cascade_model(seed=0, device=device), {"kind": "random", "seed": 0}, None
    weights = {"kind": "trained", "session_key": session_key}
    quality = flagship.load_flagship_quality()
    caps = None
    if quality is not None:
        cf.set("foreground_confidence_threshold", float(quality["threshold"]))
        if quality.get("min_neighbors") is not None:
            cf.set("nms_opencv_min_neighbors", int(quality["min_neighbors"]))
        caps = flagship.capacity_schedule_from_quality(quality)
        weights.update(threshold=quality["threshold"], min_neighbors=quality.get("min_neighbors"))
    return model, weights, caps


def vga_yuv_scenes(n, seed0=0):
    """``n`` synthetic 480x640 scenes (3 faces of 48-120 px) as YUV420."""
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

    return [
        rgb_to_yuv420(synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=seed0 + s, min_face=48,
                                           max_face=120).image)
        for s in range(n)
    ]


def timed_s(fn, device):
    """Seconds of ``fn()``: between two CUDA events on the card (``fn``
    reads its results back, so the end event follows them), by the host
    clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def same_detections(a, b) -> bool:
    """Identical raw survivors, boxes, confidences and survivor counts."""
    import numpy as np

    return (np.array_equal(a.raw_window_ids, b.raw_window_ids)
            and np.array_equal(a.raw_confidences, b.raw_confidences)
            and np.array_equal(a.boxes, b.boxes)
            and np.array_equal(a.confidences, b.confidences)
            and a.n_survivors_per_stage == b.n_survivors_per_stage)


def check_bundle(model, frames, caps, device, batch, n_rungs=3):
    """Export (batch, n_rungs), save, load and serve ``frames``; returns
    (record, served results)."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    t0 = time.perf_counter()
    bundle = serve.export_detector(model, IMG_H, IMG_W, batch=batch, yuv=True, capacities=caps,
                                   n_rungs=n_rungs)
    export_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        serve.save_bundle(bundle, d)
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        served_det = serve.load_bundle(d, device=device)
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = served_det.detect_batch(frames)
    first_s = time.perf_counter() - t0
    rates = [len(frames) / timed_s(lambda: served_det.detect_batch(frames), device)
             for _ in range(3)]
    record = {
        "batch": bundle.meta["batch"], "chunk_hint": bundle.meta["chunk_hint"],
        "capacity_rungs": bundle.meta["capacity_rungs"], "bundle_bytes": size,
        "export_s": export_s, "load_s": load_s, "first_detect_s": first_s,
        "served_fps": statistics.median(rates), "served_fps_runs": rates,
    }
    return record, served


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_line(device)
    model, weights, caps = load_operating_model(args.checkpoint, device)
    frames = vga_yuv_scenes(N_SCENES)
    det = casc.CascadeDetector(model, capacity_schedule=caps)
    live = det.detect_batch_yuv420(frames)
    det.redispatches = 0
    live_rates = [N_SCENES / timed_s(lambda: det.detect_batch_yuv420(frames), device)
                  for _ in range(3)]
    out = {"card": card, "device": str(device), "weights": weights, "n_scenes": N_SCENES,
           "capacities": caps, "live_fps": statistics.median(live_rates),
           "live_fps_runs": live_rates, "live_redispatches_per_pass": det.redispatches / 3}
    for name, batch in (("static", 16), ("dynamic", "dynamic")):
        record, served = check_bundle(model, frames, caps, device, batch)
        record["detection_mismatches"] = sum(
            not same_detections(a, b) for a, b in zip(live, served))
        out[name] = record
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    assert out["static"]["detection_mismatches"] == 0, "the bundle diverged from the live detector"
    assert out["dynamic"]["detection_mismatches"] == 0, (
        "the dynamic bundle diverged from the live detector")


if __name__ == "__main__":
    main()
