#!/usr/bin/env python3
"""Mine hard-POSITIVE samples from the port-trained flagship's missed faces
(the port's counterpart of tools/mine_hard_positives.py).

Run the CURRENT flagship over freshly generated scenes (seeds disjoint from
the training corpus, the benchmark eval 100..199 and the hard-negative
mining pool 5000+), find every ground-truth face with no detection at
IoU >= 0.5, and keep for each miss:

  * the ground-truth face box itself (what the model should score high);
  * its best-IoU pyramid window box when one reaches IoU 0.5 (the geometry
    the sliding-window grid presents at inference);
  * four scale/shift jitters of the face box (0.85x, 1.15x, +12% in x,
    +12% in y), the off-centre and off-scale views the grid shows.

Re-rendered at the cascade's aligned stage resolutions, these become extra
foreground samples for the next training round
(``SyntheticProvider(hard_positives=...)``).

Writes ``artifacts/torch_hard_positives.npz`` {"images": (N, 48, 48, 3) u8,
meta}; the committed ``artifacts/hard_positives.npz`` of the JAX package is
left alone (``tools/train_torch_flagship.py --mined port`` trains on this
file).

Usage, from the repository root on a machine with a card:

    python3 tools/mine_torch_hard_positives.py [n_scenes]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MINE_SEED0 = 20000  # disjoint: train <5000, eval 100..199, hard-neg 5000+
IOU_DETECTED = 0.5  # a GT face with no detection above this is a miss
OUT_FILE = "torch_hard_positives.npz"
# (scale, dx, dy) jitters of a missed face box, dx/dy in face widths/heights
JITTERS = ((0.85, 0.0, 0.0), (1.15, 0.0, 0.0), (1.0, 0.12, 0.0), (1.0, 0.0, 0.12))


def mine(model, n_scenes=400, seed0=MINE_SEED0, threshold=0.5):
    """((N, top, top, 3) uint8 crops, number of missed faces) of ``model``
    (a port ``CascadeModel``) on ``n_scenes`` VGA scenes from ``seed0``."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.data.image_io import resize_rgb
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.ops import rectangles as rect_ops
    from rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid import build_plan, window_table

    cf.set("window_scale_factor", 1.1)
    cf.set("min_window_length", 0.075)
    cf.set("foreground_confidence_threshold", threshold)
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_opencv_min_neighbors", 1)

    top = max(model.input_sizes)
    detector = casc.CascadeDetector(model)
    plan = build_plan(480, 640, model.input_sizes[0], model.input_sizes[0], 0.075, 1.1)
    grid = window_table(plan)["coords_norm"].astype(np.float64)  # every pyramid window
    patches = []
    n_missed = 0
    batch = 25
    for start in range(0, n_scenes, batch):
        scenes = [
            synthetic.make_scene(480, 640, n_faces=3, seed=seed0 + s, min_face=48, max_face=120)
            for s in range(start, min(start + batch, n_scenes))
        ]
        results = detector.detect_batch([s.image for s in scenes])
        for scene, res in zip(scenes, results):
            gt = scene.boxes.astype(np.float64)
            if not len(gt):
                continue
            det = res.boxes.astype(np.float64)
            det_iou = (
                rect_ops.iou_matrix(det, gt).max(axis=0) if len(det) else np.zeros(len(gt))
            )
            h, w = scene.image.shape[:2]
            for gi in np.nonzero(det_iou < IOU_DETECTED)[0]:
                n_missed += 1
                crops = [gt[gi]]
                win_iou = rect_ops.iou_matrix(grid, gt[gi : gi + 1])[:, 0]
                best = int(np.argmax(win_iou))
                if win_iou[best] >= 0.5:
                    crops.append(grid[best])
                x0g, y0g, x1g, y1g = gt[gi]
                cw, ch = x1g - x0g, y1g - y0g
                cx, cy = (x0g + x1g) / 2.0, (y0g + y1g) / 2.0
                for scale, dx, dy in JITTERS:
                    half_w, half_h = cw * scale / 2.0, ch * scale / 2.0
                    jx, jy = cx + dx * cw, cy + dy * ch
                    crops.append(np.array([jx - half_w, jy - half_h, jx + half_w, jy + half_h]))
                for box in crops:
                    x0, y0, x1, y1 = [int(round(v)) for v in box]
                    x0, y0 = max(x0, 0), max(y0, 0)
                    x1, y1 = min(x1, w), min(y1, h)
                    if x1 - x0 < 8 or y1 - y0 < 8:
                        continue
                    patches.append(resize_rgb(scene.image[y0:y1, x0:x1], top, top))
        print(f"scenes {start}..{start + len(scenes)}: {n_missed} missed faces, "
              f"{len(patches)} crops mined", flush=True)
    images = np.stack(patches) if patches else np.zeros((0, top, top, 3), np.uint8)
    return images, n_missed


def main():
    import train_torch_flagship as tf_mod

    n_scenes = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    model = tf_mod.load_flagship()
    if model is None:
        raise SystemExit("no port flagship checkpoint - run tools/train_torch_flagship.py")
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    tf_mod.flagship_config(cf)
    tf_mod.apply_recorded_overrides(cf)
    quality = tf_mod.load_flagship_quality()
    threshold = float(quality["threshold"]) if quality else 0.5
    images, n_missed = mine(model, n_scenes=n_scenes, threshold=threshold)
    path = os.path.join(tf_mod.ARTIFACT_DIR, OUT_FILE)
    np.savez_compressed(
        path,
        images=images,
        meta=json.dumps({
            "n_scenes": n_scenes,
            "seed0": MINE_SEED0,
            "threshold": threshold,
            "iou_detected": IOU_DETECTED,
            "n_missed_faces": int(n_missed),
            "n_mined": int(len(images)),
        }),
    )
    print(f"saved {len(images)} hard positives ({n_missed} missed faces) to {path}")


if __name__ == "__main__":
    main()
