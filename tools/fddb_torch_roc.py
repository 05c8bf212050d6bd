#!/usr/bin/env python3
"""Produce artifacts/torch_fddb_roc.json: the port's FDDB detection-rate
curve on the synthetic 10-fold corpus, end to end through the port's
``EvaluateFDDBApp`` and in-repo scorer (the port's counterpart of
tools/fddb_roc.py).

The corpus (``data/fddb.make_synthetic_corpus``, seed 7) has the official
layout: images, fold lists and ellipse ground truth. So the whole harness
runs: fold parsing, dense-pyramid (scale factor 1.005) cascade detection one
image a call (crop mode: kernel K2 for stage 0, K1 for re-extraction), the
official detection format, ellipse-IoU scoring and the score-swept ROC.

The cascade is the port-trained flagship, the gitignored checkpoint that
tools/train_torch_flagship.py writes (``--checkpoint`` names its path stem,
``<dir>/model_<session key>``), at the operating threshold and
min_neighbors of ``artifacts/torch_flagship_eval.json`` (0.5 and 1 without
it), at the default dense capacities. The JSON records the weights, the
settings, the wall, the re-dispatches, the kernel launches and the card's
``nvidia-smi`` name and power limit. ``artifacts/fddb_roc.json`` is the
JAX package's curve, with its own weights.

Usage, from the repository root on a machine with a card:

    python3 tools/fddb_torch_roc.py [--checkpoint artifacts/model_torch_flagship]
        [--imgs-per-fold 3] [--wsf 1.005] [--device cpu]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

ARTIFACT_DIR = os.path.join(REPO, "artifacts")
DEFAULT_CHECKPOINT = os.path.join(ARTIFACT_DIR, "model_torch_flagship")
OUT_FILE = "torch_fddb_roc.json"


def split_checkpoint(stem: str):
    """``<dir>/model_<session key>`` -> (dir, session key)."""
    base = os.path.basename(stem)
    if not base.startswith("model_"):
        raise ValueError("--checkpoint must name <dir>/model_<session key>, got " + stem)
    return os.path.dirname(os.path.abspath(stem)), base[len("model_"):]


def card_line(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--imgs-per-fold", type=int, default=3)
    ap.add_argument("--wsf", type=float, default=1.005,
                    help="pyramid scale factor (the FDDB evaluation density)")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import torch

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_fddb import EvaluateFDDBApp
    from rapidobjectdetectionusingcascadedcnns_torch.data import fddb
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda, windows_sched_cuda
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model_dir, session_key = split_checkpoint(args.checkpoint)
    try:
        model = bridge.load_cascade(model_dir, session_key, device)
    except FileNotFoundError as exc:
        raise SystemExit("{}; run tools/train_torch_flagship.py first".format(exc))
    flagship.flagship_config(cf)

    work = tempfile.mkdtemp(prefix="fddb_torch_roc_")
    try:
        img_base, folds_dir, _ = fddb.make_synthetic_corpus(
            work, n_folds=10, imgs_per_fold=args.imgs_per_fold, seed=7
        )
        out_dir = os.path.join(work, "out")
        cf.set("fddb_folds_dir", folds_dir)
        cf.set("fddb_img_base_dir", img_base)
        cf.set("fddb_detection_output_dir", out_dir)
        cf.set("fddb_latest_detection_output_dir", os.path.join(out_dir, "latest"))
        cf.set("fddb_per_evaluation_script_path", os.path.join(work, "missing.pl"))
        cf.set("log_dir", os.path.join(work, "logs"))
        cf.set("nms", cf.NMS_OPENCV)
        # every detection the cascade emits at the flagship's operating
        # point, with its confidence: the scorer sweeps the recorded scores
        quality = flagship.load_flagship_quality() or {}
        cf.set("foreground_confidence_threshold", float(quality.get("threshold", 0.5)))
        cf.set("nms_opencv_min_neighbors", int(quality.get("min_neighbors", 1)))

        windows_cuda.LAUNCHES = windows_sched_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        app = EvaluateFDDBApp(model=model, n_folds=10, run_now=False, device=device)
        cf.set("window_scale_factor", args.wsf)
        app.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(app.export_dir, "fddb_roc.json")) as f:
            roc = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    n_images = 10 * args.imgs_per_fold
    roc["config"] = {
        "window_scale_factor": args.wsf,
        "imgs_per_fold": args.imgs_per_fold,
        "n_images": n_images,
        "thresholds": cf.get("foreground_confidence_threshold"),
        "min_neighbors": cf.get("nms_opencv_min_neighbors"),
        "resize_buckets": cf.get("inference_resize_buckets"),
        "wall_secs": wall,
        "secs_per_image": wall / n_images,
        "redispatches": app.inference_app.detector.redispatches,
        "kernel_launches": {"K1": windows_cuda.LAUNCHES, "K2": windows_sched_cuda.LAUNCHES},
        "device": str(device),
        "card": card_line(device),
        "weights": {"kind": "trained", "session_key": session_key,
                    "checkpoint": os.path.relpath(args.checkpoint, REPO)},
        "corpus": "synthetic (data/fddb.make_synthetic_corpus, seed 7); the wall includes "
                  "the first use of each image size (plan, K2 schedule, kernel build)",
    }
    dst = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(dst, "w") as f:
        json.dump(roc, f, indent=1)
    print("wrote", dst)
    if roc["roc"]:
        end = roc["roc"][-1]
        print("{} faces, {} detections: detection rate {:.4f} discrete / {:.4f} continuous at "
              "{} false positives; {:.4f} s an image, {} re-dispatches, launches {}; {}".format(
                  roc["n_faces"], roc["n_detections"], end["detection_rate"],
                  end["detection_rate_continuous"], end["false_positives"],
                  wall / n_images, roc["config"]["redispatches"],
                  roc["config"]["kernel_launches"], roc["config"]["card"]))


if __name__ == "__main__":
    main()
