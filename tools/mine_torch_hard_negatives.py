#!/usr/bin/env python3
"""Mine hard-negative windows from the port-trained flagship's false
positives (the port's counterpart of tools/mine_hard_negatives.py).

The reference bootstraps its negative corpus by sampling patches where a
face detector fires on non-face content (app/sampling_app.py). The
synthetic-corpus analog: run the CURRENT flagship cascade over freshly
generated scenes (seeds disjoint from both the training corpus and the
100-scene benchmark eval, which uses seeds 100..199) at a permissive
threshold, and keep every pre-NMS final-stage survivor whose IoU with all
ground-truth faces is < 0.2: the windows the cascade wrongly believes are
faces. Those crops, re-rendered at the cascade's aligned stage resolutions,
become additional negatives for the next training round
(``SyntheticProvider(hard_negatives=...)``).

Writes ``artifacts/torch_hard_negatives.npz`` {"images": (N, 48, 48, 3) u8,
meta}; the committed ``artifacts/hard_negatives.npz`` of the JAX package is
left alone (``tools/train_torch_flagship.py --mined port`` trains on this
file).

Usage, from the repository root on a machine with a card:

    python3 tools/mine_torch_hard_negatives.py [n_scenes] [threshold]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MINE_SEED0 = 5000  # eval scenes are 100..199; training scenes use small seeds
MINE_THRESHOLD = 0.3  # permissive: catch near-threshold false positives too
MAX_PER_SCENE = 120
IOU_NEG_MAX = 0.2
OUT_FILE = "torch_hard_negatives.npz"


def mine(model, n_scenes=300, seed0=MINE_SEED0, threshold=MINE_THRESHOLD):
    """(N, top, top, 3) uint8 crops of the false-positive pre-NMS survivors
    of ``model`` (a port ``CascadeModel``) on ``n_scenes`` VGA scenes from
    ``seed0``, at most ``MAX_PER_SCENE`` a scene, strongest first."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.data.image_io import resize_rgb
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.ops import rectangles as rect_ops

    cf.set("window_scale_factor", 1.1)
    cf.set("min_window_length", 0.075)
    cf.set("foreground_confidence_threshold", threshold)

    top = max(model.input_sizes)
    detector = casc.CascadeDetector(model)
    patches = []
    batch = 25  # keeps host memory flat
    for start in range(0, n_scenes, batch):
        scenes = [
            synthetic.make_scene(480, 640, n_faces=3, seed=seed0 + s, min_face=48, max_face=120)
            for s in range(start, min(start + batch, n_scenes))
        ]
        results = detector.detect_batch([s.image for s in scenes])
        for scene, res in zip(scenes, results):
            if not len(res.raw_boxes):
                continue
            gt = scene.boxes.astype(np.float64)
            ious = rect_ops.iou_matrix(res.raw_boxes.astype(np.float64), gt)
            fp_mask = ious.max(axis=1) < IOU_NEG_MAX
            order = np.argsort(-res.raw_confidences[fp_mask])[:MAX_PER_SCENE]
            h, w = scene.image.shape[:2]
            for box in res.raw_boxes[fp_mask][order]:
                x0, y0, x1, y1 = [int(round(v)) for v in box]
                x0, y0 = max(x0, 0), max(y0, 0)
                x1, y1 = min(x1, w), min(y1, h)
                if x1 - x0 < 8 or y1 - y0 < 8:
                    continue
                patches.append(resize_rgb(scene.image[y0:y1, x0:x1], top, top))
        print(f"scenes {start}..{start + len(scenes)}: {len(patches)} mined", flush=True)
    return np.stack(patches) if patches else np.zeros((0, top, top, 3), np.uint8)


def main():
    import train_torch_flagship as tf_mod

    n_scenes = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    threshold = float(sys.argv[2]) if len(sys.argv) > 2 else MINE_THRESHOLD
    model = tf_mod.load_flagship()
    if model is None:
        raise SystemExit("no port flagship checkpoint - run tools/train_torch_flagship.py")
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    tf_mod.flagship_config(cf)
    images = mine(model, n_scenes=n_scenes, threshold=threshold)
    path = os.path.join(tf_mod.ARTIFACT_DIR, OUT_FILE)
    np.savez_compressed(
        path,
        images=images,
        meta=json.dumps({
            "n_scenes": n_scenes,
            "seed0": MINE_SEED0,
            "threshold": threshold,
            "iou_neg_max": IOU_NEG_MAX,
            "n_mined": int(len(images)),
        }),
    )
    print(f"saved {len(images)} hard negatives to {path}")


if __name__ == "__main__":
    main()
