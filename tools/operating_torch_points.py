#!/usr/bin/env python3
"""Operating-point grid of the port-trained flagship cascade (the port's
counterpart of tools/operating_points.py).

The reference's inference knobs are the per-stage foreground confidence
threshold and the groupRectangles min_neighbors count. This tool sweeps
``THRESHOLDS`` x ``MIN_NEIGHBORS`` on the flagship checkpoint that
tools/train_torch_flagship.py writes (no retraining; ``--checkpoint`` names
its path stem, ``<dir>/model_<session key>``) over the 100 benchmark scenes
through ``train_torch_flagship.evaluate_on_scenes``, after
``flagship_config`` and ``apply_recorded_overrides``, and records every
point, so that the shipped quality is a chosen point on a measured curve.
The headline is the JAX tool's: the most recall among the points with at
most ``FP_LIMIT`` false positives a scene, ties to fewer false positives.

Writes ``artifacts/torch_flagship_operating_points.json`` with the card's
``nvidia-smi`` name and power limit (``artifacts/flagship_operating_points.json``
is the JAX package's grid, with its own weights).

Usage, from the repository root on a machine with a card:

    python3 tools/operating_torch_points.py [--checkpoint artifacts/model_torch_flagship]
        [--device cpu]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line, load_checkpoint  # noqa: E402

OUT_FILE = "torch_flagship_operating_points.json"
THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
# min_neighbors 0 keeps singleton clusters, where the JAX package found the
# recall that the >= 2-member bar had cost
MIN_NEIGHBORS = (0, 1, 2)
FP_LIMIT = 0.5  # false positives a scene a headline point may have


def headline(points):
    """The JAX rule (tools/operating_points.py:57-62): best recall among
    the points with ``false_pos_per_scene`` <= ``FP_LIMIT``, ties to fewer
    false positives; None when no point is that low."""
    feasible = [p for p in points if p["false_pos_per_scene"] <= FP_LIMIT]
    if not feasible:
        return None
    return max(feasible, key=lambda p: (p["recall"], -p["false_pos_per_scene"]))


def operating_points(model, thresholds=THRESHOLDS, min_neighbors=MIN_NEIGHBORS, n_scenes=100):
    """{"points": the stats of every (min_neighbors, threshold), in the JAX
    tool's order, "headline": :func:`headline` of them} of ``model`` on the
    benchmark scenes (``evaluate_on_scenes`` without miss analysis; it sets
    the port's config as the JAX tool does)."""
    import train_torch_flagship as flagship

    points = []
    for mn in min_neighbors:
        for thr in thresholds:
            stats = flagship.evaluate_on_scenes(model, n_scenes=n_scenes, threshold=thr,
                                                miss_analysis=False, min_neighbors=mn)
            points.append(stats)
            print(json.dumps(stats), flush=True)
    return {"points": points, "headline": headline(points)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import torch

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model, weights = load_checkpoint(args.checkpoint, device)
    flagship.flagship_config(cf)
    flagship.apply_recorded_overrides(cf)

    t0 = time.perf_counter()
    out = operating_points(model)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["wall_secs"] = time.perf_counter() - t0
    out["fp_limit"] = FP_LIMIT
    out["device"] = str(device)
    out["card"] = card_line(device)
    out["weights"] = weights
    path = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    print("headline:", json.dumps(out["headline"]))


if __name__ == "__main__":
    main()
