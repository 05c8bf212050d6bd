#!/usr/bin/env python3
"""Produce artifacts/torch_runtime_eval.json: the reference's core
experiment table, {cascade, single net} x {card, host CPU} runtime, through
the port's ``EvaluateRuntimeApp`` (the port's counterpart of
tools/runtime_eval.py).

The cascade is the port-trained flagship, the gitignored checkpoint that
tools/train_torch_flagship.py writes (``--checkpoint`` names its path stem,
``<dir>/model_<session key>``), or random weights from seed 0 where there
is none; the JSON says which. The single net is the final-resolution
architecture (48 px, conv [32], fc1 512) with fresh weights from seed 0:
its runtime does not depend on its weights, since it classifies every
pyramid window. Both run the reference's inference geometry (scale factor
1.1, minimum window 0.075, threshold 0.5, min_neighbors 1) over 16 positive
and 4 negative synthetic VGA scenes, each family warmed once and then timed
once per device. At VGA 1.1 the pyramid has at most 48 levels, so both
stage 0s run in gather mode: the single net launches no hand-written
kernel, the cascade K1 for its re-extractions.

Usage, from the repository root on a machine with a card:

    python3 tools/runtime_torch_eval.py [--checkpoint artifacts/model_torch_flagship]
        [--n-pos 16] [--n-neg 4]
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

OUT_FILE = "torch_runtime_eval.json"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--n-pos", type=int, default=16)
    ap.add_argument("--n-neg", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_runtime import (
        EvaluateRuntimeApp,
    )
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.models.single import SingleNetDetector
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda, windows_sched_cuda
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    log.set_echo(True)
    device = resolve_device("cuda")
    flagship.flagship_config(cf)
    model, weights = load_checkpoint(args.checkpoint, device, random_seed=0)

    # the reference's inference geometry
    cf.set("window_scale_factor", 1.1)
    cf.set("min_window_length", 0.075)
    cf.set("foreground_confidence_threshold", 0.5)
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_opencv_min_neighbors", 1)
    cf.set("dataset_keys", ["synthetic"])
    cf.set("inference_merge", True)
    cf.set("log_auto_save", False)

    scfg = cnn.StageConfig.from_config(48, bottleneck_in_size=None)
    single = SingleNetDetector(
        cnn.init_stage(scfg, torch.Generator().manual_seed(0)),
        scfg,
        np.full((48, 48, 3), 127.5, np.float32),
        np.full((48, 48, 3), 64.0, np.float32),
        device,
    )

    windows_cuda.LAUNCHES = windows_sched_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    app = EvaluateRuntimeApp(
        n_positive=args.n_pos,
        n_negative=args.n_neg,
        cascade_model=model,
        single_detector=single,
        compare_platforms=["cuda", "cpu"],
    )
    wall = time.perf_counter() - t0

    payload = {
        "experiment": "runtime cascade-vs-single x device "
                      "(reference app/evaluate_runtime_app.py:50-97)",
        "n_images": args.n_pos + args.n_neg,
        "image_size": [480, 640],
        "window_scale_factor": 1.1,
        "threshold": 0.5,
        "min_neighbors": 1,
        "compute_dtype": str(model.stage_configs[0].compute_dtype).replace("torch.", ""),
        "cascade_weights": weights,
        "single_weights": {"kind": "random", "seed": 0, "input_size": 48,
                           "conv_filter_sizes": list(scfg.conv_filter_sizes),
                           "fc1_size": scfg.fc1_size},
        "devices": ["cuda", "cpu"],
        "card": card_line(device),
        "torch": torch.__version__,
        "cpu_threads": torch.get_num_threads(),
        "results": app.results,
        "kernel_launches_cuda": {"K1": windows_cuda.LAUNCHES, "K2": windows_sched_cuda.LAUNCHES},
        "wall_secs": wall,
        "note": "each family runs the images once to warm and once timed, per device; "
                "kernel_launches_cuda counts both cascade runs on the card. At VGA 1.1 both "
                "stage 0s run in gather mode, so the single net launches no hand-written "
                "kernel and the cascade launches K1 for its re-extractions.",
    }
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", path)
    print(json.dumps(payload["results"], indent=1))


if __name__ == "__main__":
    main()
