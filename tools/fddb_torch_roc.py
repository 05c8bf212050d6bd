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
``<dir>/model_<session key>``), at the default dense capacities. The
options map to the configuration as in the JAX tool (:func:`roc_settings`):

  * by default, the operating threshold and min_neighbors of
    ``artifacts/torch_flagship_eval.json`` (0.5 and 1 without it), the
    FDDB app's corpus-derived resize buckets; ``--thr`` overrides the
    threshold;
  * ``--reference-default``: the reference's own defaults, threshold 0.5
    on every stage, min_neighbors 1 and no resize buckets (exact per-size
    pyramid geometry), written to ``torch_fddb_roc_default.json``;
    ``--thr`` is ignored there;
  * ``--mn`` overrides min_neighbors in either mode;
  * ``--out`` names the file under ``artifacts/`` (an absolute path is
    taken as it is);
  * ``--corpus-dir`` keeps the corpus in that directory and reuses it when
    its last fold list (``folds/FDDB-fold-10.txt``) exists: an interrupted
    synthesis leaves the first folds alone (:func:`corpus_ready`).

The JSON records the weights, the settings, the wall, the re-dispatches,
the kernel launches and the card's ``nvidia-smi`` name and power limit.
``artifacts/fddb_roc.json`` is the JAX package's curve, with its own
weights.

Usage, from the repository root on a machine with a card:

    python3 tools/fddb_torch_roc.py [--checkpoint artifacts/model_torch_flagship]
        [--imgs-per-fold 3] [--wsf 1.005] [--reference-default] [--thr T]
        [--mn N] [--out NAME] [--corpus-dir DIR] [--device cpu]
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
DEFAULT_OUT_FILE = "torch_fddb_roc_default.json"
LAST_FOLD = os.path.join("folds", "FDDB-fold-10.txt")


def split_checkpoint(stem: str):
    """``<dir>/model_<session key>`` -> (dir, session key)."""
    base = os.path.basename(stem)
    if not base.startswith("model_"):
        raise ValueError("--checkpoint must name <dir>/model_<session key>, got " + stem)
    return os.path.dirname(os.path.abspath(stem)), base[len("model_"):]


def load_checkpoint(stem: str, device, random_seed=None):
    """(cascade, weights record) of the checkpoint at path stem ``stem``
    on ``device``. Where there is none: random weights from
    ``random_seed`` in the configured architecture, or, with no seed, exit
    naming tools/train_torch_flagship.py."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge, cascade

    model_dir, session_key = split_checkpoint(stem)
    try:
        model = bridge.load_cascade(model_dir, session_key, device)
    except FileNotFoundError as exc:
        if random_seed is None:
            raise SystemExit("{}; run tools/train_torch_flagship.py first".format(exc))
        return (cascade.build_cascade_model(seed=random_seed, device=device),
                {"kind": "random", "seed": random_seed})
    return model, {"kind": "trained", "session_key": session_key,
                   "checkpoint": os.path.relpath(stem, REPO)}


def roc_settings(reference_default=False, thr=None, mn=None, out=None, quality=None):
    """(config settings, artifact name) of the options, as the JAX tool maps
    them (tools/fddb_roc.py:105-131): the operating point of ``quality``
    (the flagship's eval, or None) with ``thr`` over its threshold, or with
    ``reference_default`` threshold 0.5, min_neighbors 1 and no resize
    buckets; ``mn`` over min_neighbors in either mode; ``out`` over the
    mode's file name. The settings name the port's config keys."""
    if reference_default:
        settings = {"foreground_confidence_threshold": 0.5, "nms_opencv_min_neighbors": 1,
                    "fddb_resize_buckets": None}
    else:
        quality = quality or {}
        settings = {
            "foreground_confidence_threshold":
                float(quality.get("threshold", 0.5)) if thr is None else thr,
            "nms_opencv_min_neighbors": int(quality.get("min_neighbors", 1)),
        }
    if mn is not None:
        settings["nms_opencv_min_neighbors"] = mn
    return settings, out or (DEFAULT_OUT_FILE if reference_default else OUT_FILE)


def corpus_ready(corpus_dir) -> bool:
    """Whether ``corpus_dir`` holds a whole corpus to reuse: its last fold
    list exists."""
    return bool(corpus_dir) and os.path.exists(os.path.join(corpus_dir, LAST_FOLD))


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
    ap.add_argument("--reference-default", action="store_true",
                    help="threshold 0.5 on every stage, min_neighbors 1, no resize buckets; "
                         "writes " + DEFAULT_OUT_FILE)
    ap.add_argument("--thr", type=float, default=None,
                    help="threshold over the flagship's operating threshold")
    ap.add_argument("--mn", type=int, default=None, help="groupRectangles min_neighbors")
    ap.add_argument("--out", default=None, help="artifact file name under artifacts/")
    ap.add_argument("--corpus-dir", default=None,
                    help="keep the corpus there; reuse it when its last fold list exists")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import torch

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_fddb import EvaluateFDDBApp
    from rapidobjectdetectionusingcascadedcnns_torch.data import fddb
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda, windows_sched_cuda
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model, weights = load_checkpoint(args.checkpoint, device)
    flagship.flagship_config(cf)

    settings, out_name = roc_settings(args.reference_default, args.thr, args.mn, args.out,
                                      flagship.load_flagship_quality())
    work = tempfile.mkdtemp(prefix="fddb_torch_roc_")
    try:
        if corpus_ready(args.corpus_dir):
            img_base = os.path.join(args.corpus_dir, "images")
            folds_dir = os.path.join(args.corpus_dir, "folds")
            print("reusing the corpus at", args.corpus_dir)
        else:
            img_base, folds_dir, _ = fddb.make_synthetic_corpus(
                args.corpus_dir or work, n_folds=10, imgs_per_fold=args.imgs_per_fold, seed=7
            )
        out_dir = os.path.join(work, "out")
        cf.set("fddb_folds_dir", folds_dir)
        cf.set("fddb_img_base_dir", img_base)
        cf.set("fddb_detection_output_dir", out_dir)
        cf.set("fddb_latest_detection_output_dir", os.path.join(out_dir, "latest"))
        cf.set("fddb_per_evaluation_script_path", os.path.join(work, "missing.pl"))
        cf.set("log_dir", os.path.join(work, "logs"))
        cf.set("nms", cf.NMS_OPENCV)
        # every detection the cascade emits at the chosen operating point,
        # with its confidence: the scorer sweeps the recorded scores
        for key, value in settings.items():
            cf.set(key, value)
        n_images = sum(len(fddb.read_fold(k)) for k in range(1, 11))

        k1, k2 = windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES
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

    roc["config"] = {
        "window_scale_factor": args.wsf,
        "imgs_per_fold": n_images // 10,
        "n_images": n_images,
        "thresholds": cf.get("foreground_confidence_threshold"),
        "min_neighbors": cf.get("nms_opencv_min_neighbors"),
        "resize_buckets": cf.get("inference_resize_buckets"),
        "reference_default": args.reference_default,
        "wall_secs": wall,
        "secs_per_image": wall / n_images,
        "redispatches": app.inference_app.detector.redispatches,
        "kernel_launches": {"K1": windows_cuda.LAUNCHES - k1,
                            "K2": windows_sched_cuda.LAUNCHES - k2},
        "device": str(device),
        "card": card_line(device),
        "weights": weights,
        "corpus": "synthetic (data/fddb.make_synthetic_corpus, seed 7 where this run made "
                  "it); the wall includes the first use of each image size (plan, K2 "
                  "schedule, kernel build)",
        "corpus_dir": args.corpus_dir,
    }
    dst = os.path.join(ARTIFACT_DIR, out_name)
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
