"""Plain reference: OpenCV ``groupRectangles`` (the reference detector's NMS,
``app/inference_app.py``), in numpy.

Two rectangles are similar when each of their four edges differs by at
most ``eps * 0.5 * (min(w1, w2) + min(h1, h2))``; classes are the connected
components of that relation (a union-find); a class's rectangle is the
rounded mean (half to even) of its members, kept when it has more than
``min_neighbors`` members. A kept class is dropped when it lies inside
another kept class, within 0.2 of the container's size rounded, and the
container has more than ``max(3, n)`` members or the class fewer than 3.
Returns xyxy boxes and member counts.
"""

from __future__ import annotations

import numpy as np


def _find(parent, i):
    while parent[i] != i:
        parent[i] = parent[parent[i]]
        i = parent[i]
    return i


def group_rectangles(boxes_xyxy: np.ndarray, min_neighbors: int, eps: float = 0.2):
    boxes = np.asarray(boxes_xyxy, dtype=np.float64).reshape(-1, 4)
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4), np.int64), np.zeros((0,), np.int64)
    x, y = boxes[:, 0], boxes[:, 1]
    w, h = boxes[:, 2] - x, boxes[:, 3] - y
    parent = list(range(n))
    for i in range(n):
        delta = eps * 0.5 * (np.minimum(w[i], w[i + 1:]) + np.minimum(h[i], h[i + 1:]))
        close = ((np.abs(x[i] - x[i + 1:]) <= delta) & (np.abs(y[i] - y[i + 1:]) <= delta)
                 & (np.abs(x[i] + w[i] - x[i + 1:] - w[i + 1:]) <= delta)
                 & (np.abs(y[i] + h[i] - y[i + 1:] - h[i + 1:]) <= delta))
        for j in np.nonzero(close)[0] + i + 1:
            a, b = _find(parent, i), _find(parent, int(j))
            if a != b:
                parent[max(a, b)] = min(a, b)
    roots = np.array([_find(parent, i) for i in range(n)])
    labels, inverse, counts = np.unique(roots, return_inverse=True, return_counts=True)
    xywh = np.stack([x, y, w, h], 1)
    sums = np.zeros((len(labels), 4))
    np.add.at(sums, inverse, xywh)
    mean = np.rint(sums / counts[:, None]).astype(np.int64)
    keep = counts > min_neighbors
    rects, weights = mean[keep], counts[keep]
    if len(rects) > 1:
        rx, ry, rw, rh = rects.T
        dx, dy = np.rint(rw * 0.2).astype(np.int64), np.rint(rh * 0.2).astype(np.int64)
        inside = ((rx[:, None] >= rx[None] - dx[None]) & (ry[:, None] >= ry[None] - dy[None])
                  & (rx[:, None] + rw[:, None] <= rx[None] + rw[None] + dx[None])
                  & (ry[:, None] + rh[:, None] <= ry[None] + rh[None] + dy[None]))
        np.fill_diagonal(inside, False)
        stronger = (weights[None, :] > np.maximum(3, weights[:, None])) | (weights[:, None] < 3)
        drop = (inside & stronger).any(axis=1)
        rects, weights = rects[~drop], weights[~drop]
    xyxy = np.concatenate([rects[:, :2], rects[:, :2] + rects[:, 2:]], 1) if len(rects) else \
        np.zeros((0, 4), np.int64)
    return xyxy, weights
