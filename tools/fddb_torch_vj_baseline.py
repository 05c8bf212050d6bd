#!/usr/bin/env python3
"""Produce artifacts/torch_fddb_vj_baseline.json: the Viola-Jones baseline
scored on the synthetic FDDB corpus through the port, with the port's
cascade numbers beside it (the port's counterpart of
tools/fddb_vj_baseline.py; the reference's headline comparison, cascaded
CNNs against OpenCV's detector).

The port's in-repo evaluator (``ops/viola_jones.py``, the committed
``opencv_data/haarcascade_frontalface_default.xml``) runs over the 10-fold
synthetic corpus of tools/fddb_torch_roc.py (``data/fddb.make_synthetic_corpus``,
seed 7, the same images at the same ``--imgs-per-fold``), writes the
official detection format with each box's neighbour count as its score,
and scores the folds with the in-repo ellipse scorer. The detector runs on
the host by design (no kernel); the JSON records the host seconds and, where
the machine has a card, its ``nvidia-smi`` line, with the cascade's curve
from ``artifacts/torch_fddb_roc.json``.

Usage, from the repository root:

    python3 tools/fddb_torch_vj_baseline.py [--imgs-per-fold 3]
        [--scale-factor 1.1] [--min-neighbors 1]
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

ARTIFACT_DIR = os.path.join(REPO, "artifacts")
OUT_FILE = "torch_fddb_vj_baseline.json"
CASCADE_FILE = "torch_fddb_roc.json"


def machine_line() -> str:
    """The card's ``nvidia-smi`` name and power limit where there is one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return out.stdout.strip().splitlines()[0]


def xywh_to_xyxy(rects):
    import numpy as np

    if not len(rects):
        return np.zeros((0, 4), np.float64)
    r = np.asarray(rects, np.float64)
    return np.stack([r[:, 0], r[:, 1], r[:, 0] + r[:, 2], r[:, 1] + r[:, 3]], axis=1)


def run_baseline(imgs_per_fold: int, scale_factor: float, min_neighbors: int) -> dict:
    """Detect, export and score the corpus; returns the scorer's result with
    the settings and the host seconds."""
    import numpy as np

    from rapidobjectdetectionusingcascadedcnns_torch.data import fddb, fddb_eval
    from rapidobjectdetectionusingcascadedcnns_torch.data.image_io import load_rgb
    from rapidobjectdetectionusingcascadedcnns_torch.ops import viola_jones as vj

    xml = vj.default_cascade_path()
    if xml is None:
        raise SystemExit("no pretrained HAAR XML found (opencv_data/)")
    cascade = vj.parse_cascade_xml(xml)
    work = tempfile.mkdtemp(prefix="fddb_torch_vj_")
    try:
        img_base, folds_dir, _ = fddb.make_synthetic_corpus(
            work, n_folds=10, imgs_per_fold=imgs_per_fold, seed=7)
        export_dir = os.path.join(work, "out")
        n_images, t0 = 0, time.perf_counter()
        for fold_nr in range(1, 11):
            keys = fddb.read_fold_keys_from(folds_dir, fold_nr)
            boxes, confs = [], []
            for key in keys:
                gray = vj.rgb_to_gray_u8(load_rgb(os.path.join(img_base, key + ".jpg")))
                rects, weights = vj.detect_multi_scale(
                    cascade, gray, scale_factor=scale_factor, min_neighbors=min_neighbors,
                    return_weights=True)
                boxes.append(xywh_to_xyxy(rects))
                confs.append(np.asarray(weights, np.float64))
                n_images += 1
            fddb.write_fold_results(export_dir, fold_nr, keys, boxes, confs)
        wall = time.perf_counter() - t0
        result = fddb_eval.evaluate_folds(export_dir, folds_dir, 10)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "detector": "viola_jones_in_repo (the port's ops/viola_jones.py)",
        "model_xml": os.path.relpath(xml, REPO) if os.path.isabs(xml) else xml,
        "scale_factor": scale_factor,
        "min_neighbors": min_neighbors,
        "imgs_per_fold": imgs_per_fold,
        "n_images": n_images,
        "host_secs": wall,
        "host_secs_per_image": wall / max(n_images, 1),
        "n_faces": result["n_faces"],
        "n_detections": result["n_detections"],
        "roc": result["roc"],
        "corpus": "synthetic (data/fddb.make_synthetic_corpus, seed 7; the corpus of "
                  "tools/fddb_torch_roc.py at the same imgs_per_fold)",
    }


def cascade_comparison(imgs_per_fold: int):
    """The port's cascade curve from ``artifacts/torch_fddb_roc.json``: its
    last point, its corpus size and card, or None without the file."""
    path = os.path.join(ARTIFACT_DIR, CASCADE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        roc = json.load(f)
    if not roc.get("roc"):
        return None
    config = roc.get("config", {})
    return {
        "source_artifact": CASCADE_FILE,
        "n_faces": roc["n_faces"],
        "n_detections": roc["n_detections"],
        "tail": roc["roc"][-1],
        "imgs_per_fold": config.get("imgs_per_fold"),
        "same_corpus": config.get("imgs_per_fold") == imgs_per_fold,
        "secs_per_image": config.get("secs_per_image"),
        "card": config.get("card"),
        "weights": config.get("weights"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--imgs-per-fold", type=int, default=3)
    ap.add_argument("--scale-factor", type=float, default=1.1)
    ap.add_argument("--min-neighbors", type=int, default=1)
    args = ap.parse_args(argv)

    out = run_baseline(args.imgs_per_fold, args.scale_factor, args.min_neighbors)
    out["machine"] = machine_line()
    comparison = cascade_comparison(args.imgs_per_fold)
    if comparison is not None:
        out["cascade_comparison"] = comparison
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    dst = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(dst, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", dst)
    print(json.dumps({
        "n_faces": out["n_faces"], "n_detections": out["n_detections"],
        "vj_tail": out["roc"][-1] if out["roc"] else None,
        "host_secs_per_image": out["host_secs_per_image"],
        "cascade_tail": comparison["tail"] if comparison else None,
        "machine": out["machine"],
    }))


if __name__ == "__main__":
    main()
