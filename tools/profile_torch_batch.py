#!/usr/bin/env python3
"""A VGA frame's device cost against a call's fixed cost, from the slope of
the batch wall over the frame count (the port's counterpart of
tools/profile_batch.py).

Times the flagship's VGA YUV420 program (``CascadeDetector._run_chunk``:
the YUV decode, the pyramid, the three stage CNNs with re-extraction by
kernel K1, compaction and the packed rows; no read-back, no host NMS) at 1,
2, 4, 8 and 16 frames, the frames staged on the card, each call between two
CUDA events (the median of ``--iters`` calls after a warm-up). The
least-squares line through (frames, ms) gives the slope, the device ms a
frame, and the intercept, the fixed cost of a call (its launches and host
orchestration where the card waits for them). The cascade is the
port-trained flagship (``--checkpoint``) at its operating threshold and the
capacities ``capacity_schedule_from_quality`` gives from
``artifacts/torch_flagship_eval.json``; where there is no checkpoint,
random weights from seed 0 at threshold 0.5 and the default capacities,
as the JAX tool runs them (the output says which). Frames are
``make_scene(480, 640, 3 faces, 48-120 px)``, seeds 0-15.

Prints the table and writes it to ``chiprun_out/profile_batch.json`` with
the card's ``nvidia-smi`` name and power limit. Run from the repository
root on a machine with a card:

    python3 tools/profile_torch_batch.py [--checkpoint artifacts/model_torch_flagship]
        [--iters 20] [--device cpu]

With ``--device cpu`` the calls are timed on the host clock.
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import DEFAULT_CHECKPOINT, card_line, load_checkpoint  # noqa: E402

OUT_DIR = "chiprun_out"
OUT_FILE = "profile_batch.json"
FRAME_COUNTS = (1, 2, 4, 8, 16)
IMG_H, IMG_W = 480, 640


def call_ms(fn, device, iters):
    """Median ms of ``iters`` calls of ``fn`` after one warm-up: between two
    CUDA events on a card, on the host clock around a call on the CPU."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def batch_slope(model, caps, frame_counts=FRAME_COUNTS, iters=20):
    """{"points": [{"frames", "ms", "ms_per_frame"}], "slope_ms_per_frame",
    "intercept_ms"} of ``model``'s VGA YUV program (scale factor 1.1,
    minimum window 0.075) at capacities ``caps`` on the model's device (the
    threshold as the port's config holds it)."""
    import numpy as np
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

    device = model.device
    cf.set("window_scale_factor", 1.1)
    cf.set("min_window_length", 0.075)
    detector = cascade.CascadeDetector(model)
    entry = detector._plan_and_table(IMG_H, IMG_W)
    staged = []
    for s in range(max(frame_counts)):
        y, uv = rgb_to_yuv420(synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=s, min_face=48,
                                                   max_face=120).image)
        staged.append((torch.as_tensor(y, device=device), torch.as_tensor(uv, device=device)))
    points = []
    for b in frame_counts:
        ms = call_ms(lambda: detector._run_chunk(staged[:b], True, caps, entry, None), device,
                     iters)
        points.append({"frames": b, "ms": ms, "ms_per_frame": ms / b})
        print("{:3d} frames: {:9.4f} ms a call, {:8.4f} ms a frame".format(b, ms, ms / b),
              flush=True)
    slope, intercept = np.polyfit([p["frames"] for p in points], [p["ms"] for p in points], 1)
    print("slope {:.4f} ms a frame, intercept {:.4f} ms a call".format(slope, intercept))
    return {"points": points, "slope_ms_per_frame": float(slope),
            "intercept_ms": float(intercept), "capacities": list(caps),
            "n_windows": entry[0].n_windows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    flagship.flagship_config(cf)
    model, weights = load_checkpoint(args.checkpoint, device, random_seed=0)
    quality = flagship.load_flagship_quality() if weights["kind"] == "trained" else None
    cf.set("foreground_confidence_threshold", quality["threshold"] if quality else 0.5)
    caps = (flagship.capacity_schedule_from_quality(quality) if quality
            else cascade.default_capacity_schedule(5061, model.n_nets))
    out = batch_slope(model, caps, iters=args.iters)
    out.update(weights=weights, threshold=cf.get("foreground_confidence_threshold"),
               device=str(device), card=card_line(device))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print("card:", out["card"])


if __name__ == "__main__":
    main()
