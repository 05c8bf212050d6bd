"""Decoding of the cascade's packed result rows (counterpart of the decoder
half of serve.py, lines 59-148). Bundle export and loading are not ported
yet (ROADMAP Queue A item 9)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from . import config as cf
from .ops import nms as nms_ops
from .ops import rectangles as rect_ops


def postprocess_raw(
    boxes: np.ndarray,
    conf: np.ndarray,
    *,
    nms_mode: str,
    nms_min_neighbors: int,
    vertically_enlarge: bool,
    nms_eps: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host NMS (groupRectangles, numpy or native code) plus optional
    vertical enlargement (app/inference_app.py:219-231)."""
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float64), np.zeros((0,), np.float64)
    if nms_mode == cf.NMS_OPENCV:
        out_boxes, weights = nms_ops.nms_boxes(boxes, nms_min_neighbors, nms_eps)
        out_boxes = out_boxes.astype(np.float64)
        out_conf = weights.astype(np.float64)
    else:
        out_boxes = boxes.astype(np.float64)
        out_conf = conf.astype(np.float64)
    if vertically_enlarge and len(out_boxes):
        out_boxes = rect_ops.vertically_enlarge(out_boxes, enlarge_top=0.2)
    return out_boxes, out_conf


def unpack_packed_row(
    row: np.ndarray,
    capacities: Sequence[int],
    n_stages: int,
    plan,
    table,
    *,
    nms_mode: str,
    nms_min_neighbors: int,
    vertically_enlarge: bool,
    nms_eps: float = 0.2,
):
    """Decode one frame's packed vector (models/cascade.pack_result layout:
    ids, confidences, alive, then per-stage survivor counts and per-stage
    re-extract overflow counts) into a ``DetectionResult``."""
    from .models.cascade import DetectionResult

    cap_last = capacities[-1] if capacities else plan.n_windows
    window_ids = row[:cap_last].astype(np.int64)
    conf = row[cap_last : 2 * cap_last]
    alive = row[2 * cap_last : 3 * cap_last] > 0.5
    base = 3 * cap_last
    survivors = [int(s) for s in row[base : base + n_stages]]
    overflows = [int(s) for s in row[base + n_stages : base + 2 * n_stages - 1]]
    keep_ids = window_ids[alive]
    raw_boxes = table["coords_norm"][keep_ids]
    raw_conf = conf[alive]
    boxes, confidences = postprocess_raw(
        raw_boxes,
        raw_conf,
        nms_mode=nms_mode,
        nms_min_neighbors=nms_min_neighbors,
        vertically_enlarge=vertically_enlarge,
        nms_eps=nms_eps,
    )
    return DetectionResult(
        boxes=boxes,
        confidences=confidences,
        raw_boxes=raw_boxes,
        raw_confidences=raw_conf,
        n_windows=plan.n_windows,
        n_survivors_per_stage=survivors,
        raw_window_ids=keep_ids,
        reextract_overflows=overflows,
    )
