"""FDDB benchmark IO: fold parsing and the official detection format (the
port's copy of the JAX package's ``data/fddb.py``).

Mirrors the reference FDDB harness IO (app/evaluate_fddb_app.py:71-137):
fold files list relative image paths; detections are exported as

    <image key>
    <n faces>
    <left_x top_y width height detection_score>*

one file per fold, ready for the official Perl evaluator.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from .. import config as cf
from ..labels import get_by_key, KEY_FOREGROUND
from .image_io import ImageInfo


def fold_file_path(fold_nr: int) -> str:
    return os.path.join(cf.get("fddb_folds_dir"), "FDDB-fold-{:02d}.txt".format(fold_nr))


def read_fold_keys_from(folds_dir: str, fold_nr: int) -> List[str]:
    """Relative image keys of one fold file under an explicit directory."""
    path = os.path.join(folds_dir, "FDDB-fold-{:02d}.txt".format(fold_nr))
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def read_fold(fold_nr: int) -> List[str]:
    """Relative image keys of one fold (order preserved)."""
    return read_fold_keys_from(cf.get("fddb_folds_dir"), fold_nr)


def image_infos_for_fold(fold_nr: int) -> List[ImageInfo]:
    """ImageInfo objects for a fold (app/evaluate_fddb_app.py:71-93)."""
    infos = []
    for rel in read_fold(fold_nr):
        path = os.path.join(cf.get("fddb_img_base_dir"), rel + ".jpg")
        infos.append(ImageInfo(path, get_by_key(KEY_FOREGROUND), "fddb"))
    return infos


def derive_resize_buckets(n_folds: int, k: int = 6) -> List[tuple]:
    """Derive resize buckets from the corpus itself: the ``k`` most common
    image sizes across the folds (PIL header reads — no pixel decode).

    A static bucket list that the corpus' sizes do not land on costs
    detection rate (the JAX package measured it with its own flagship):
    resizing to an off-size bucket perturbs pyramid geometry for every face
    in the image. Corpus-derived buckets make the dominant sizes EXACT
    while still bounding the number of pyramid plans and stage-0 schedules
    built; only tail sizes get resized to their log-nearest bucket
    (models/cascade.CascadeDetector.detect_batch maps detections back)."""
    from collections import Counter

    from PIL import Image

    counts: Counter = Counter()
    for fold_nr in range(1, n_folds + 1):
        for rel in read_fold(fold_nr):
            path = os.path.join(cf.get("fddb_img_base_dir"), rel + ".jpg")
            try:
                with Image.open(path) as im:
                    w, h = im.size
            except OSError:
                continue
            counts[(h, w)] += 1
    return [size for size, _n in counts.most_common(k)]


def image_key(image_path: str) -> str:
    key = image_path.replace(cf.get("fddb_img_base_dir"), "").replace(".jpg", "")
    return key[1:] if key.startswith("/") else key


def format_fold_results(
    img_keys: Sequence[str],
    boxes_per_img: Sequence[np.ndarray],
    confidences_per_img: Sequence[np.ndarray],
) -> str:
    """Detection-format text for one fold (app/evaluate_fddb_app.py:106-134)."""
    lines: List[str] = []
    for key, boxes, confs in zip(img_keys, boxes_per_img, confidences_per_img):
        lines.append(key)
        lines.append(str(len(boxes)))
        for box, conf in zip(boxes, confs):
            xmin, ymin, xmax, ymax = box
            lines.append(
                "{} {} {} {} {}".format(xmin, ymin, xmax - xmin, ymax - ymin, conf)
            )
    return "\n".join(lines) + "\n"


def write_fold_results(
    export_dir: str,
    fold_nr: int,
    img_keys: Sequence[str],
    boxes_per_img: Sequence[np.ndarray],
    confidences_per_img: Sequence[np.ndarray],
) -> str:
    cf.ensure_dir(export_dir)
    path = os.path.join(export_dir, "fold-{:02d}-out.txt".format(fold_nr))
    with open(path, "w") as f:
        f.write(format_fold_results(img_keys, boxes_per_img, confidences_per_img))
    return path


def write_ellipse_ground_truth(
    folds_dir: str,
    fold_nr: int,
    img_keys: Sequence[str],
    ellipses_per_img: Sequence[np.ndarray],
) -> str:
    """Official FDDB ellipse ground-truth file for one fold:

        <image key>
        <n faces>
        <major_axis_radius minor_axis_radius angle center_x center_y 1>*

    (the format the official Perl evaluator consumes next to the fold's
    detection output)."""
    os.makedirs(folds_dir, exist_ok=True)
    path = os.path.join(
        folds_dir, "FDDB-fold-{:02d}-ellipseList.txt".format(fold_nr)
    )
    lines: List[str] = []
    for key, ellipses in zip(img_keys, ellipses_per_img):
        lines.append(key)
        lines.append(str(len(ellipses)))
        for e in ellipses:
            lines.append("{} {} {} {} {} 1".format(*[float(v) for v in e[:5]]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def boxes_to_ellipses(boxes: np.ndarray) -> np.ndarray:
    """Face boxes (xyxy) -> FDDB-style ellipses
    (major_r, minor_r, angle, cx, cy); the EXACT inverse of the detector's
    vertical-enlargement convention (reference rectangles.py:186-220: face
    boxes sit below the chin, annotation ellipses extend ABOVE into the
    forehead — which is why the reference enlarges detection boxes by 0.2h
    at the TOP only). The ellipse is therefore centered 0.1h above the box
    center with vertical major radius 0.6h: a perfectly-aligned enlarged
    detection box is the ellipse's exact bounding box, the same best-case
    rasterized IoU (pi/4) a perfect detector achieves on real FDDB."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2 - 0.1 * h
    # angle pi/2: the major axis points UP (the official annotations measure
    # the major-axis direction from the x-axis; upright faces are ~pi/2)
    angle = np.full_like(w, np.pi / 2)
    return np.stack([h / 2 * 1.2, w / 2, angle, cx, cy], axis=1)


def make_synthetic_corpus(
    base_dir: str,
    n_folds: int = 10,
    imgs_per_fold: int = 2,
    seed: int = 0,
    sizes: Sequence = ((240, 320), (200, 280), (320, 240)),
):
    """Build a complete FDDB-format synthetic corpus: <base>/images/... JPEGs
    with faces, <base>/folds/FDDB-fold-XX.txt + ellipse ground truth.

    Stands in for the real FDDB data (not shipped with the repository) so
    the full 10-fold harness — fold parsing, dense-pyramid detection,
    official detection-format export, evaluator hand-off — runs end-to-end
    (apps/evaluate_fddb.py, tools/fddb_torch_roc.py). Byte-equal to the
    JAX package's corpus for the same arguments.
    Returns (img_base_dir, folds_dir, ground_truth dict key -> boxes).
    """
    from PIL import Image

    from .synthetic import make_scene

    img_base = os.path.join(base_dir, "images")
    folds_dir = os.path.join(base_dir, "folds")
    os.makedirs(folds_dir, exist_ok=True)
    rng_seed = seed
    truth = {}
    for fold_nr in range(1, n_folds + 1):
        keys, ellipses = [], []
        for i in range(imgs_per_fold):
            h, w = sizes[(fold_nr + i) % len(sizes)]
            scene = make_scene(
                h, w, n_faces=1 + (i % 2), seed=rng_seed, min_face=48, max_face=100
            )
            rng_seed += 1
            key = "2002/{:02d}/img_{}".format(fold_nr, i)
            path = os.path.join(img_base, key + ".jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(scene.image).save(path, quality=95)
            keys.append(key)
            ellipses.append(boxes_to_ellipses(scene.boxes))
            truth[key] = scene.boxes
        with open(os.path.join(folds_dir, "FDDB-fold-{:02d}.txt".format(fold_nr)), "w") as f:
            f.write("\n".join(keys) + "\n")
        write_ellipse_ground_truth(folds_dir, fold_nr, keys, ellipses)
    return img_base, folds_dir, truth


def parse_fold_results(path: str):
    """Parse an exported fold detection file back into
    [(key, boxes (N, 4) xywh, scores (N,))]. Round-trips
    :func:`format_fold_results`; used to validate the export is byte-level
    parseable per the official spec."""
    out = []
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        key = lines[i]
        n = int(lines[i + 1])
        boxes, scores = [], []
        for j in range(n):
            parts = lines[i + 2 + j].split()
            if len(parts) != 5:
                raise ValueError("{}: malformed detection line {!r}".format(path, lines[i + 2 + j]))
            x, y, w, h, s = [float(p) for p in parts]
            boxes.append((x, y, w, h))
            scores.append(s)
        out.append((key, np.asarray(boxes).reshape(-1, 4), np.asarray(scores)))
        i += 2 + n
    return out
