#!/usr/bin/env python3
"""Frames/s of the runtime app's two detector families for two checkouts
of the PyTorch port on one CUDA card, in turns.

    python3 tools/compare_torch_pipeline.py OTHER_DIR [--repeats 5]
        [--checkpoint artifacts/model_torch_flagship]

``OTHER_DIR`` is another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. The two packages share a name, so each checkout runs
in a process of its own, in the order other, this tree, this tree, other.
Each process builds its checkout's kernels and runs its own
``EvaluateRuntimeApp`` on the card ``--repeats`` times, as
tools/runtime_torch_eval.py runs it (16 positive and 4 negative VGA
scenes, scale factor 1.1, threshold 0.5, min_neighbors 1, each family
warmed and then timed once an app; ``inference_batch_frames`` 16 and
``inference_pipeline_depth`` 2, their defaults, so each family's 20 frames
are 2 chunks): the cascade is the checkpoint that
tools/train_torch_flagship.py writes (both trees read the same file); the
single net is the 48 px net (conv [32], fc1 512) of fresh weights from
seed 0.

Prints one line per process and a summary with the card's name and power
limit; the numbers also go to ``chiprun_out/compare_pipeline.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WORKER = r'''
import json, sys
import numpy as np
import torch
sys.path[:0] = [".", "tools"]
import train_torch_flagship
from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_runtime import EvaluateRuntimeApp
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge, cnn
from rapidobjectdetectionusingcascadedcnns_torch.models.single import SingleNetDetector
from rapidobjectdetectionusingcascadedcnns_torch.ops import _build

model_dir, session_key, repeats = sys.argv[1], sys.argv[2], int(sys.argv[3])
_build.build()
dev = torch.device("cuda")
train_torch_flagship.flagship_config(cf)
model = bridge.load_cascade(model_dir, session_key, dev)
for key, value in (("window_scale_factor", 1.1), ("min_window_length", 0.075),
                   ("foreground_confidence_threshold", 0.5), ("nms", cf.NMS_OPENCV),
                   ("nms_opencv_min_neighbors", 1), ("dataset_keys", ["synthetic"]),
                   ("inference_merge", True), ("log_auto_save", False),
                   ("conv_filter_sizes", [32]), ("fc1_size", 512)):
    cf.set(key, value)
scfg = cnn.StageConfig.from_config(48, bottleneck_in_size=None)
single = SingleNetDetector(cnn.init_stage(scfg, torch.Generator().manual_seed(0)), scfg,
                           np.full((48, 48, 3), 127.5, np.float32),
                           np.full((48, 48, 3), 64.0, np.float32), dev)
out = {"cascade_fps": [], "single_fps": []}
for _ in range(repeats):
    app = EvaluateRuntimeApp(n_positive=16, n_negative=4, cascade_model=model,
                             single_detector=single, device="cuda")
    out["cascade_fps"].append(app.results["cascade"]["fps"])
    out["single_fps"].append(app.results["single"]["fps"])
print("RESULT " + json.dumps(out))
'''


def _run(tree: str, model_dir: str, session_key: str, repeats: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER, model_dir, session_key, str(repeats)],
                          cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError("worker in {} failed:\n{}".format(tree, proc.stderr[-3000:]))
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="another checkout of the repository")
    parser.add_argument("--repeats", type=int, default=5, help="runtime apps a process")
    parser.add_argument("--checkpoint",
                        default=os.path.join(here, "artifacts", "model_torch_flagship"),
                        help="path stem <dir>/model_<session key> of the cascade")
    args = parser.parse_args(argv)
    other = os.path.abspath(args.other)
    stem = os.path.abspath(args.checkpoint)
    model_dir, session_key = os.path.dirname(stem), os.path.basename(stem)[len("model_"):]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    runs = []
    for label, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        result = _run(tree, model_dir, session_key, args.repeats)
        runs.append((label, result))
        print("{} ({}): {}".format(label, tree, json.dumps(result)))
    summary = {}
    for family in ("cascade_fps", "single_fps"):
        summary[family] = {side: [x for label, r in runs if label == side for x in r[family]]
                           for side in ("this", "other")}
        print("{}: this tree median {:.2f} {}, other median {:.2f} {} [{}]".format(
            family, statistics.median(summary[family]["this"]),
            [round(x, 2) for x in summary[family]["this"]],
            statistics.median(summary[family]["other"]),
            [round(x, 2) for x in summary[family]["other"]], card))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "compare_pipeline.json"), "w") as f:
        json.dump({"card": card, "other": other, "checkpoint": stem, "fps": summary}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
