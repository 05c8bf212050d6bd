#!/usr/bin/env python3
"""Serving soak of the port on the card (the port's counterpart of
tools/soak.py): sustained streaming detection, with the health checks a
long-running service is watched by.

Pushes N YUV420 VGA frames through ``CascadeDetector.detect_batch_yuv420``
in batches of ``inference_batch_frames``, or with ``--bundle`` through a
serving bundle (``serve.export_detector`` -> save -> load ->
``ServingDetector``), and reports:

  * per-batch latency drift: the median batch time of the last quarter of
    the batches against that of the first quarter (each batch timed
    between two CUDA events);
  * card memory growth: ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` after the warm-up and at the end;
  * detection stability: the 32 scenes repeat, and every repeat of one of
    the first batch's frames must give exactly its first detections.

The weights are the port-trained flagship at its operating point, or
random weights without its checkpoint (see tools/serve_torch_bundle_check.py).
Writes ``artifacts/torch_soak_live.json`` or ``torch_soak_bundle.json``
with the card's ``nvidia-smi`` name and power limit.

Usage, from the repository root on a machine with a card:

    python3 tools/soak_torch_serving.py [n_frames] [--bundle] [--device cpu]
"""

import argparse
import json
import os
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line  # noqa: E402
from serve_torch_bundle_check import (  # noqa: E402
    load_operating_model,
    same_detections,
    timed_s,
    vga_yuv_scenes,
)

N_SCENES = 32


def _memory(device):
    import torch

    if device.type != "cuda":
        return None
    return {"allocated": torch.cuda.memory_allocated(device),
            "max_allocated": torch.cuda.max_memory_allocated(device)}


def soak(detect, scenes, n_frames, batch, device):
    """Run ``detect`` (a list of frames -> a list of results) over
    ``n_frames`` frames of the repeating ``scenes`` in batches of
    ``batch``, after one warm-up batch whose results are the reference of
    the stability check. Returns the report."""
    reference = detect(scenes[:batch])
    memory_warm = _memory(device)
    batch_s, drift, done = [], 0, 0
    while done < n_frames:
        frames = [scenes[(done + i) % len(scenes)] for i in range(batch)]
        results = []
        batch_s.append(timed_s(lambda: results.extend(detect(frames)), device))
        for i, res in enumerate(results):
            k = (done + i) % len(scenes)
            if k < batch and not same_detections(res, reference[k]):
                drift += 1
        done += batch
    quarter = max(1, len(batch_s) // 4)
    first, last = statistics.median(batch_s[:quarter]), statistics.median(batch_s[-quarter:])
    ms = sorted(s * 1e3 for s in batch_s)
    return {
        "n_frames": done, "batch": batch, "n_batches": len(batch_s),
        "fps": done / sum(batch_s),
        "batch_ms_median": statistics.median(ms),
        "batch_ms_p95": ms[min(len(ms) - 1, int(0.95 * len(ms)))],
        "batch_ms_first_quarter_median": first * 1e3,
        "batch_ms_last_quarter_median": last * 1e3,
        "latency_drift_pct": 100.0 * (last - first) / first,
        "memory_after_warmup": memory_warm, "memory_at_end": _memory(device),
        "detection_drift_count": drift,
    }


def bundle_detector(model, caps, device, n_rungs=3):
    """The live program as a saved and reloaded static VGA YUV bundle:
    a ``ServingDetector``."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    bundle = serve.export_detector(model, 480, 640, yuv=True, capacities=caps, n_rungs=n_rungs)
    with tempfile.TemporaryDirectory() as d:
        serve.save_bundle(bundle, d)
        return serve.load_bundle(d, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=512)
    ap.add_argument("--bundle", action="store_true", help="soak a serving bundle")
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model, weights, caps = load_operating_model(args.checkpoint, device)
    if args.bundle:
        detect = bundle_detector(model, caps, device).detect_batch
    else:
        detect = casc.CascadeDetector(model, capacity_schedule=caps).detect_batch_yuv420
    report = soak(detect, vga_yuv_scenes(N_SCENES), args.n_frames,
                  int(cf.get("inference_batch_frames")), device)
    report.update(path="bundle" if args.bundle else "live_detector", weights=weights,
                  capacities=caps, card=card_line(device), device=str(device))
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    name = "torch_soak_{}.json".format("bundle" if args.bundle else "live")
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    assert report["detection_drift_count"] == 0, "detections drifted across repeats"
    assert abs(report["latency_drift_pct"]) < 25, "latency drifted by more than 25%"


if __name__ == "__main__":
    main()
