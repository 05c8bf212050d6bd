"""Rectangle geometry as vectorized array ops.

The reference models rectangles as Python objects with scalar methods
(data/rectangles.py:12-220). Here rectangles are ``(..., 4)`` arrays in
``(xmin, ymin, xmax, ymax)`` order with the origin in the top-left corner,
and every operation is batched (the port's copy of the JAX package's
``ops/rectangles.py``).

Semantics parity:
  * ``intersects``   — closed-interval test (reference data/rectangles.py:63-80).
  * ``iou``          — +1 pixel-area convention (reference data/rectangles.py:82-111).
  * ``vertically_enlarge`` — Li-et-al.-style top extension for FDDB's
    elliptical ground truth (reference data/rectangles.py:186-220).
  * ``restricted_area``    — padding enlarge with the reference's exact (and
    idiosyncratic) width/height mix (reference data/rectangles.py:126-158).
"""

from __future__ import annotations

import numpy as np

XMIN, YMIN, XMAX, YMAX = 0, 1, 2, 3


def make(xmin, ymin, xmax, ymax, dtype=np.float32) -> np.ndarray:
    return np.stack(
        [np.asarray(xmin), np.asarray(ymin), np.asarray(xmax), np.asarray(ymax)],
        axis=-1,
    ).astype(dtype)


def width(rects):
    return rects[..., XMAX] - rects[..., XMIN]


def height(rects):
    return rects[..., YMAX] - rects[..., YMIN]


def intersects(a, b):
    """Pairwise closed-interval intersection test.

    ``a``: (..., 4), ``b``: (..., 4) broadcastable. Touching borders count as
    intersecting, matching the reference truth table
    (test/test_rectangles.py:9-39).
    """
    import numpy as xp

    a = xp.asarray(a)
    b = xp.asarray(b)
    disjoint = (
        (b[..., XMIN] > a[..., XMAX])
        | (b[..., YMIN] > a[..., YMAX])
        | (a[..., XMIN] > b[..., XMAX])
        | (a[..., YMIN] > b[..., YMAX])
    )
    return ~disjoint


def iou(a, b):
    """Pairwise IoU with the reference's +1 inclusive-pixel-area convention.

    The per-axis extents clamp at zero: without the clamp, boxes disjoint
    in BOTH axes multiply two negative extents into a large bogus positive
    intersection (e.g. IoU([0,0,10,10],[130,130,250,250]) came out 23.6)."""
    import numpy as xp

    a = xp.asarray(a, dtype=xp.float64)
    b = xp.asarray(b, dtype=xp.float64)
    x_a = xp.maximum(a[..., XMIN], b[..., XMIN])
    y_a = xp.maximum(a[..., YMIN], b[..., YMIN])
    x_b = xp.minimum(a[..., XMAX], b[..., XMAX])
    y_b = xp.minimum(a[..., YMAX], b[..., YMAX])
    inter = xp.maximum(x_b - x_a + 1, 0.0) * xp.maximum(y_b - y_a + 1, 0.0)
    area_a = (a[..., XMAX] - a[..., XMIN] + 1) * (a[..., YMAX] - a[..., YMIN] + 1)
    area_b = (b[..., XMAX] - b[..., XMIN] + 1) * (b[..., YMAX] - b[..., YMIN] + 1)
    return inter / (area_a + area_b - inter)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU matrix."""
    return iou(a[:, None, :], b[None, :, :])


def iou_single(a, b) -> float:
    """Scalar IoU of two xyxy boxes (0 for disjoint boxes)."""
    return max(float(iou(np.asarray(a), np.asarray(b))), 0.0)


def vertically_enlarge(
    rects: np.ndarray,
    enlarge_top: float | None = 0.2,
    enlarge_bottom: float | None = None,
    img_heights: np.ndarray | None = None,
) -> np.ndarray:
    """Vertically extend boxes (top by default), clamped to the image.

    Matches reference data/rectangles.py:186-220: top extension clamps at 0,
    bottom extension clamps at ``img_height - 1``.
    """
    rects = np.asarray(rects, dtype=np.float64).copy()
    h = rects[..., YMAX] - rects[..., YMIN]
    if enlarge_top is not None:
        rects[..., YMIN] = np.maximum(rects[..., YMIN] - enlarge_top * h, 0)
    if enlarge_bottom is not None:
        ymax = rects[..., YMAX] + enlarge_bottom * h
        if img_heights is not None:
            ymax = np.minimum(ymax, np.asarray(img_heights) - 1)
        rects[..., YMAX] = ymax
    return rects


def restricted_area(
    bbox: np.ndarray,
    enlarge_by: float = 0.05,
    img_width: int | None = None,
    img_height: int | None = None,
) -> np.ndarray:
    """Enlarge a bbox by padding, reproducing the reference's exact arithmetic
    (data/rectangles.py:136-158, including its width/height extension mix)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    old_w = bbox[..., XMAX] - bbox[..., XMIN]
    old_h = bbox[..., YMAX] - bbox[..., YMIN]
    w_ext = (enlarge_by * old_w).astype(np.int64)
    h_ext = (enlarge_by * old_h).astype(np.int64)
    xmin = np.maximum(bbox[..., XMIN] - w_ext, 0)
    ymin = np.maximum(bbox[..., YMIN] - w_ext, 0)
    xmax = bbox[..., XMAX] + h_ext
    ymax = bbox[..., YMAX] + h_ext
    if img_width is not None:
        xmax = np.minimum(xmax, img_width)
    if img_height is not None:
        ymax = np.minimum(ymax, img_height)
    return np.stack([xmin, ymin, xmax, ymax], axis=-1)
