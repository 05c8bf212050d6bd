"""Non-maximum suppression: OpenCV ``groupRectangles``-compatible clustering.

The reference delegates NMS to ``cv2.groupRectangles(min_neighbors)``
(app/inference_app.py:168-217): that algorithm is *equivalence-class
clustering*, not score-sorted greedy NMS. Semantics reproduced here:

  1. Two rectangles are "similar" iff all four coordinate deltas are within
     ``eps * 0.5 * (min(w1, w2) + min(h1, h2))`` (OpenCV ``SimilarRects`` with
     default ``eps = 0.2``).
  2. Rectangles are partitioned into connected components of the similarity
     relation (OpenCV ``partition``).
  3. Each class is averaged (``x * 1/n`` with round-half-to-even int cast)
     and rejected if its member count ``n <= min_neighbors``.
  4. A surviving class is also rejected if it lies inside another surviving
     class and either the container has a sufficiently larger count
     (``n2 > max(3, n1)``) or the contained class itself is weak
     (``n1 < 3``), under a small tolerance of 0.2 of the container's size.
  5. Returned weight per kept class = member count (the reference uses this
     as the output confidence, app/inference_app.py:206-212).

The port's copy of the host half of the JAX package's ``ops/nms.py``:
:func:`group_rectangles` (vectorized numpy), :func:`group_rectangles_fast`
(the native C++ kernel when it builds) and :func:`nms_boxes`. The
on-device variant is not ported yet (ROADMAP Queue A item 6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _similarity_matrix(xywh: np.ndarray, eps: float) -> np.ndarray:
    """(N, N) bool similarity per OpenCV SimilarRects."""
    x, y, w, h = xywh[:, 0], xywh[:, 1], xywh[:, 2], xywh[:, 3]
    delta = eps * 0.5 * (np.minimum(w[:, None], w[None, :]) + np.minimum(h[:, None], h[None, :]))
    ok = (
        (np.abs(x[:, None] - x[None, :]) <= delta)
        & (np.abs(y[:, None] - y[None, :]) <= delta)
        & (np.abs((x + w)[:, None] - (x + w)[None, :]) <= delta)
        & (np.abs((y + h)[:, None] - (y + h)[None, :]) <= delta)
    )
    return ok


def _connected_components(adj: np.ndarray) -> np.ndarray:
    """Component labels via iterated min-label propagation (host numpy)."""
    n = adj.shape[0]
    labels = np.arange(n)
    while True:
        # each node takes the minimum label among its neighbors (incl. itself)
        prop = np.where(adj, labels[None, :], n)
        new_labels = np.minimum(labels, prop.min(axis=1))
        if np.array_equal(new_labels, labels):
            return labels
        labels = new_labels


def _round_half_even(x: np.ndarray) -> np.ndarray:
    """cv2 saturate_cast<int> rounding (round half to even, like np.rint)."""
    return np.rint(x).astype(np.int64)


def group_rectangles(
    rects_xywh: np.ndarray,
    min_neighbors: int,
    eps: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """groupRectangles-compatible clustering.

    ``rects_xywh``: (N, 4) int/float array of (x, y, w, h).
    Returns ``(kept_xywh (M, 4) int64, weights (M,) int64)``.
    """
    rects_xywh = np.asarray(rects_xywh, dtype=np.float64)
    n = len(rects_xywh)
    if n == 0:
        return np.zeros((0, 4), np.int64), np.zeros((0,), np.int64)

    labels = _connected_components(_similarity_matrix(rects_xywh, eps))
    uniq, inverse, counts = np.unique(labels, return_inverse=True, return_counts=True)
    n_classes = len(uniq)

    # class average with OpenCV's scale-then-round arithmetic
    sums = np.zeros((n_classes, 4), dtype=np.float64)
    np.add.at(sums, inverse, rects_xywh)
    avg = _round_half_even(sums / counts[:, None])

    keep_counts = counts > min_neighbors
    cls_rects = avg[keep_counts]
    cls_weights = counts[keep_counts]

    m = len(cls_rects)
    if m <= 1:
        return cls_rects, cls_weights

    # phase 2: drop a class if it sits inside a (sufficiently more supported)
    # other class, with tolerance 0.2 of its own dims (OpenCV groupRectangles)
    x1, y1, w1, h1 = cls_rects[:, 0], cls_rects[:, 1], cls_rects[:, 2], cls_rects[:, 3]
    # tolerance uses the CONTAINER's dims with cvRound (OpenCV phase 2)
    dx = _round_half_even(w1 * 0.2)
    dy = _round_half_even(h1 * 0.2)
    # i inside j?
    inside = (
        (x1[:, None] >= x1[None, :] - dx[None, :])
        & (y1[:, None] >= y1[None, :] - dy[None, :])
        & ((x1 + w1)[:, None] <= (x1 + w1)[None, :] + dx[None, :])
        & ((y1 + h1)[:, None] <= (y1 + h1)[None, :] + dy[None, :])
    )
    np.fill_diagonal(inside, False)
    # OpenCV phase 2: reject i inside j when (n2 > max(3, n1) || n1 < 3)
    stronger = (cls_weights[None, :] > np.maximum(3, cls_weights[:, None])) | (
        cls_weights[:, None] < 3
    )
    rejected = (inside & stronger).any(axis=1)

    return cls_rects[~rejected], cls_weights[~rejected]


def group_rectangles_fast(
    rects_xywh: np.ndarray, min_neighbors: int, eps: float = 0.2
) -> Tuple[np.ndarray, np.ndarray]:
    """groupRectangles via the native C++ kernel when available (the union-
    find clustering is O(N^2) host work on the frame-latency path), falling
    back to the vectorized numpy implementation."""
    from .. import native

    result = native.group_rectangles(rects_xywh, min_neighbors, eps)
    if result is not None:
        return result
    return group_rectangles(rects_xywh, min_neighbors, eps)


def nms_boxes(
    boxes_xyxy: np.ndarray,
    min_neighbors: int,
    eps: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience wrapper in (xmin, ymin, xmax, ymax) convention.

    Returns kept boxes in xyxy plus weights (= neighbor counts, used as the
    output confidence like app/inference_app.py:206-212).
    """
    boxes_xyxy = np.asarray(boxes_xyxy)
    if len(boxes_xyxy) == 0:
        return np.zeros((0, 4), np.int64), np.zeros((0,), np.int64)
    xywh = np.stack(
        [
            boxes_xyxy[:, 0],
            boxes_xyxy[:, 1],
            boxes_xyxy[:, 2] - boxes_xyxy[:, 0],
            boxes_xyxy[:, 3] - boxes_xyxy[:, 1],
        ],
        axis=1,
    )
    kept, weights = group_rectangles_fast(xywh, min_neighbors, eps)
    if len(kept) == 0:
        return np.zeros((0, 4), np.int64), weights
    out = np.stack(
        [kept[:, 0], kept[:, 1], kept[:, 0] + kept[:, 2], kept[:, 1] + kept[:, 3]],
        axis=1,
    )
    return out, weights
