#!/usr/bin/env python3
"""What the FDDB app's resize buckets cost in detection rate, on the card
(the port's counterpart of tools/fddb_bucketing_delta.py).

The FDDB app resizes each image to its nearest bucket
(``fddb_resize_buckets="auto"``: the corpus's most common sizes,
``data/fddb.derive_resize_buckets``), which bounds the pyramid plans and
stage-0 schedules built, at the price of exact per-size geometry. This tool
runs the full-density (scale factor 1.005) detection of the port-trained
flagship (``--checkpoint``, the gitignored checkpoint of
tools/train_torch_flagship.py) over the synthetic FDDB corpus (seed 7, 2
images a fold) twice, with ``inference_resize_buckets=None`` (exact) and
with the derived buckets (``models/cascade.CascadeDetector.detect_batch``
maps the detections back), at threshold 0.5 and min_neighbors 1 with plain
boxes, and scores both against the ground truth (:func:`score`: a face is
found by a box of IoU over 0.3). The JAX tool passes the config's "auto"
to ``detect_batch`` as it stands; here it is resolved as the FDDB app
resolves it.

Each mode runs once to warm (plans, K2 schedules, cuDNN plans) and once
timed; the kernel launches K1 and K2 are counted in the timed run (a
bucket size gets its own K2 schedule). Writes
``artifacts/torch_bucketing_delta.json``: each mode's recall, false
positives an image, seconds and launches, the buckets, ``recall_delta``
and the card's ``nvidia-smi`` name and power limit.

Usage, from the repository root on a machine with a card:

    python3 tools/fddb_torch_bucketing_delta.py [--checkpoint artifacts/model_torch_flagship]
        [--scale 1.005] [--folds 4] [--device cpu]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line, load_checkpoint  # noqa: E402

OUT_FILE = "torch_bucketing_delta.json"


def score(results_by_key, truth, iou_thr=0.3):
    """Recall and false positives an image of ``results_by_key`` ({key:
    (M, 4) boxes}) against ``truth`` ({key: ground-truth boxes}), as the JAX
    tool scores them: a face is found when some box has IoU over
    ``iou_thr`` with it; a box that finds no face is a false positive."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import rectangles as R

    tp = fn = fp = 0
    for key, gt_boxes in truth.items():
        boxes = results_by_key.get(key)
        matched = set()
        for gt in gt_boxes:
            hit = False
            for k, box in enumerate(boxes):
                if R.iou_single(gt, box) > iou_thr:
                    hit = True
                    matched.add(k)
            tp += int(hit)
            fn += int(not hit)
        fp += len(boxes) - len(matched)
    n_img = len(truth)
    return {
        "recall": round(tp / max(tp + fn, 1), 4),
        "false_pos_per_img": round(fp / max(n_img, 1), 2),
        "n_faces": tp + fn,
        "n_images": n_img,
    }


def bucketing_delta(model, folds=4, scale=1.005):
    """The two modes' scores, seconds and launches on the synthetic corpus
    of ``folds`` folds, and ``recall_delta`` (bucketed minus exact), for
    ``model`` on its device. Sets the port's config as the JAX tool does."""
    import numpy as np
    import torch
    from PIL import Image

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import fddb
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda, windows_sched_cuda

    flagship.flagship_config(cf)
    work = tempfile.mkdtemp(prefix="fddb_torch_bucketing_")
    try:
        img_base, folds_dir, truth = fddb.make_synthetic_corpus(
            work, n_folds=folds, imgs_per_fold=2, seed=7
        )
        cf.set("fddb_folds_dir", folds_dir)
        cf.set("fddb_img_base_dir", img_base)
        images = {}
        for fold_nr in range(1, folds + 1):
            for key in fddb.read_fold(fold_nr):
                with Image.open(os.path.join(img_base, key + ".jpg")) as im:
                    images[key] = np.asarray(im.convert("RGB"))
        buckets = fddb.derive_resize_buckets(folds)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    cf.set("window_scale_factor", scale)
    cf.set("vertically_enlarge_bboxes", False)  # plain boxes against the ground truth
    cf.set("foreground_confidence_threshold", 0.5)
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_opencv_min_neighbors", 1)
    detector = cascade.CascadeDetector(model)
    keys = list(images)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)

    out = {"scale": scale, "n_images": len(images), "buckets": [list(b) for b in buckets]}
    for mode, mode_buckets in (("exact", None), ("bucketed", buckets)):
        cf.set("inference_resize_buckets", mode_buckets)
        detector.detect_batch([images[k] for k in keys])  # warm-up
        sync()
        redispatches = detector.redispatches
        k1, k2 = windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES
        t0 = time.perf_counter()
        results = detector.detect_batch([images[k] for k in keys])
        sync()
        secs = time.perf_counter() - t0
        out[mode] = score({k: r.boxes for k, r in zip(keys, results)}, truth)
        out[mode].update(
            seconds=secs,
            redispatches=detector.redispatches - redispatches,
            kernel_launches={"K1": windows_cuda.LAUNCHES - k1,
                             "K2": windows_sched_cuda.LAUNCHES - k2},
            sizes=sorted({tuple(int(v) for v in images[k].shape[:2]) for k in keys}),
        )
        print(mode, out[mode], flush=True)
    out["recall_delta"] = round(out["bucketed"]["recall"] - out["exact"]["recall"], 4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--scale", type=float, default=1.005)
    ap.add_argument("--folds", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch.utils import log
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    log.set_echo(True)
    device = resolve_device(args.device)
    model, weights = load_checkpoint(args.checkpoint, device)
    out = bucketing_delta(model, args.folds, args.scale)
    out["device"] = str(device)
    out["card"] = card_line(device)
    out["weights"] = weights
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
