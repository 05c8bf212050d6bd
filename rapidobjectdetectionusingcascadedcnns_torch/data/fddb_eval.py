"""In-repo FDDB scorer: ellipse ground truth vs rectangular detections
(the port's copy of the JAX package's ``data/fddb_eval.py``).

The reference delegates scoring to the official Perl/C++ evaluator
(app/evaluate_fddb_app.py:171-179), which is not installed in every
environment. This module reimplements its scoring contract so the harness
can always produce the benchmark's actual output — a detection-rate *curve*,
not a single operating point:

  * overlap between an annotation ellipse and a detection rectangle is the
    pixel IoU of the two regions (the official evaluator rasterizes region
    masks; RegionsSingleImage::computeOverlap semantics);
  * per image, detections are matched to annotations by maximum-weight
    bipartite matching on the IoU matrix (the official matchPairs uses the
    Hungarian algorithm; scipy's linear_sum_assignment here, greedy
    fallback);
  * DISCRETE score: a matched pair counts as one true positive iff
    IoU > 0.5; CONTINUOUS score: the matched IoU itself;
  * the ROC sweeps the detection-score threshold over every unique score:
    x = total false positives over the corpus, y = detection rate
    (discrete: TP / n_faces; continuous: sum(IoU) / n_faces).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def ellipse_mask(
    ellipse: Sequence[float], x0: int, y0: int, w: int, h: int
) -> np.ndarray:
    """Boolean mask of the ellipse over the pixel grid [x0, x0+w) x [y0, y0+h).

    ``ellipse``: (major_radius, minor_radius, angle_rad, cx, cy) — the FDDB
    annotation format; the major axis points along ``angle`` from the x-axis
    the way the official annotations define it (vertical faces have angles
    near pi/2). Pixel centers (x + 0.5, y + 0.5) inside the ellipse are True.
    """
    major, minor, angle, cx, cy = [float(v) for v in ellipse[:5]]
    ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
    px = xs + 0.5 - cx
    py = ys + 0.5 - cy
    c, s = np.cos(angle), np.sin(angle)
    u = px * c + py * s  # along the major axis
    v = -px * s + py * c
    return (u / max(major, 1e-9)) ** 2 + (v / max(minor, 1e-9)) ** 2 <= 1.0


def rect_mask(rect_xywh: Sequence[float], x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Boolean mask of an axis-aligned rectangle over the same pixel grid."""
    rx, ry, rw, rh = [float(v) for v in rect_xywh[:4]]
    ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
    pcx = xs + 0.5
    pcy = ys + 0.5
    return (pcx >= rx) & (pcx < rx + rw) & (pcy >= ry) & (pcy < ry + rh)


def ellipse_rect_iou(ellipse: Sequence[float], rect_xywh: Sequence[float]) -> float:
    """Pixel IoU of an FDDB ellipse and a detection rectangle (rasterized
    over the union bounding box, like the official mask-based overlap)."""
    major, minor, angle, cx, cy = [float(v) for v in ellipse[:5]]
    r = max(major, minor)
    ex0, ey0 = cx - r, cy - r
    ex1, ey1 = cx + r, cy + r
    rx, ry, rw, rh = [float(v) for v in rect_xywh[:4]]
    x0 = int(np.floor(min(ex0, rx)))
    y0 = int(np.floor(min(ey0, ry)))
    x1 = int(np.ceil(max(ex1, rx + rw)))
    y1 = int(np.ceil(max(ey1, ry + rh)))
    w, h = max(x1 - x0, 1), max(y1 - y0, 1)
    em = ellipse_mask((major, minor, angle, cx, cy), x0, y0, w, h)
    rm = rect_mask((rx, ry, rw, rh), x0, y0, w, h)
    inter = np.count_nonzero(em & rm)
    union = np.count_nonzero(em | rm)
    return inter / union if union else 0.0


# ---------------------------------------------------------------------------
# matching + ROC
# ---------------------------------------------------------------------------


def _match_pairs(iou: np.ndarray) -> List[Tuple[int, int]]:
    """Maximum-weight bipartite matching (detections x annotations) on the
    IoU matrix; pairs with IoU == 0 are dropped. Hungarian via scipy when
    available (the official evaluator's matchPairs), greedy otherwise."""
    if iou.size == 0:
        return []
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-iou)
        return [(int(r), int(c)) for r, c in zip(rows, cols) if iou[r, c] > 0]
    except ImportError:  # pragma: no cover - scipy is installed here
        pairs = []
        used_r, used_c = set(), set()
        order = np.argsort(-iou, axis=None)
        for flat in order:
            r, c = np.unravel_index(flat, iou.shape)
            if iou[r, c] <= 0:
                break
            if r in used_r or c in used_c:
                continue
            pairs.append((int(r), int(c)))
            used_r.add(r)
            used_c.add(c)
        return pairs


def score_image(
    ellipses: np.ndarray,  # (G, 5) ground-truth ellipses
    boxes_xywh: np.ndarray,  # (D, 4) detections
    scores: np.ndarray,  # (D,)
    iou_threshold: float = 0.5,
):
    """Per-detection outcome for one image, in DESCENDING score order.

    Returns (scores_sorted, disc, cont): for the k-th strongest detection,
    ``disc[k]`` is 1.0 for a true positive (matched annotation with
    IoU > threshold) else 0.0, and ``cont[k]`` is the matched IoU (0 for
    unmatched). Matching follows the official cumulative protocol: as the
    threshold sweeps down, each annotation can be claimed by at most one
    detection — resolved by maximum-weight matching on the full matrix.
    """
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    boxes = np.asarray(boxes_xywh, np.float64).reshape(-1, 4)[order]
    ss = np.asarray(scores, np.float64)[order]
    G = len(ellipses)
    D = len(boxes)
    disc = np.zeros(D)
    cont = np.zeros(D)
    if G and D:
        iou = np.zeros((D, G))
        for d in range(D):
            for g in range(G):
                iou[d, g] = ellipse_rect_iou(ellipses[g], boxes[d])
        for d, g in _match_pairs(iou):
            cont[d] = iou[d, g]
            if iou[d, g] > iou_threshold:
                disc[d] = 1.0
    return ss, disc, cont


def roc_curve(
    per_image: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_faces_total: int,
):
    """Corpus ROC from per-image (scores, disc, cont) triples.

    Returns a list of points swept over every unique detection score s
    (threshold = keep detections with score >= s), each point a dict with
    ``threshold``, ``false_positives`` (corpus total), ``true_positives``,
    ``detection_rate`` (discrete) and ``detection_rate_continuous``.
    """
    scores = np.concatenate([s for s, _, _ in per_image]) if per_image else np.zeros(0)
    disc = np.concatenate([d for _, d, _ in per_image]) if per_image else np.zeros(0)
    cont = np.concatenate([c for _, _, c in per_image]) if per_image else np.zeros(0)
    order = np.argsort(-scores, kind="stable")
    scores, disc, cont = scores[order], disc[order], cont[order]

    points = []
    tp = fp = 0.0
    cont_sum = 0.0
    n = len(scores)
    denom = max(n_faces_total, 1)
    for i in range(n):
        tp += disc[i]
        cont_sum += cont[i]
        fp += 1.0 - disc[i]
        last_of_score = i == n - 1 or scores[i + 1] < scores[i]
        if last_of_score:
            points.append(
                {
                    "threshold": float(scores[i]),
                    "false_positives": int(fp),
                    "true_positives": int(tp),
                    "detection_rate": tp / denom,
                    "detection_rate_continuous": cont_sum / denom,
                }
            )
    return points


# ---------------------------------------------------------------------------
# corpus-level scoring
# ---------------------------------------------------------------------------


def read_ellipse_ground_truth(folds_dir: str, fold_nr: int) -> Dict[str, np.ndarray]:
    """Parse FDDB-fold-XX-ellipseList.txt -> {image key: (G, 5) ellipses}."""
    path = os.path.join(
        folds_dir, "FDDB-fold-{:02d}-ellipseList.txt".format(fold_nr)
    )
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        key = lines[i]
        n = int(lines[i + 1])
        ells = []
        for j in range(n):
            parts = lines[i + 2 + j].split()
            ells.append([float(p) for p in parts[:5]])
        out[key] = np.asarray(ells, np.float64).reshape(-1, 5)
        i += 2 + n
    return out


def evaluate_folds(
    detection_dir: str,
    folds_dir: str,
    n_folds: int = 10,
    iou_threshold: float = 0.5,
) -> Dict:
    """Score exported fold-XX-out.txt detections against the fold ellipse
    ground truth; returns {"roc": [...], "n_faces": N, "n_detections": D,
    "per_fold": {...}} — the in-repo equivalent of the official evaluator's
    discrete/continuous ROC output."""
    from .fddb import parse_fold_results

    per_image = []
    n_faces = 0
    n_dets = 0
    per_fold = {}
    for fold_nr in range(1, n_folds + 1):
        det_path = os.path.join(detection_dir, "fold-{:02d}-out.txt".format(fold_nr))
        gt = read_ellipse_ground_truth(folds_dir, fold_nr)
        fold_faces = fold_tp = 0
        for key, boxes, scores in parse_fold_results(det_path):
            ells = gt.get(key, np.zeros((0, 5)))
            triple = score_image(ells, boxes, scores, iou_threshold)
            per_image.append(triple)
            n_faces += len(ells)
            fold_faces += len(ells)
            fold_tp += int(triple[1].sum())
            n_dets += len(scores)
        per_fold["fold_{:02d}".format(fold_nr)] = {
            "faces": fold_faces,
            "true_positives_at_threshold_0": fold_tp,
        }
    return {
        "roc": roc_curve(per_image, n_faces),
        "n_faces": n_faces,
        "n_detections": n_dets,
        "iou_threshold": iou_threshold,
        "per_fold": per_fold,
    }


def write_roc_artifact(result: Dict, path: str, extra: Optional[Dict] = None) -> str:
    payload = dict(result)
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path
