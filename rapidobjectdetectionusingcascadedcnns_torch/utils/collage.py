"""Collage visualizations: sample grids rendered to image files.

The port's copy of the JAX package's ``utils/collage.py`` (numpy and PIL
only: the same arrays give the same PNG bytes). Re-design of the reference
collage module (utils/collage.py): a generic grid renderer plus the
concrete collages used across the pipeline — evaluation TP/FP/FN/TN grids
(utils/collage.py:349-437), resampled-split previews (:155),
class-distribution grids (:440-502) and removed-sample sheets (:130).
Pure numpy compositing; PIL only for file encoding.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .. import config as cf
from ..labels import IID_BACKGROUND, IID_FOREGROUND
from . import log


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def render_grid(
    images: Sequence[np.ndarray],
    max_images: int = 100,
    pad: int = 2,
    pad_value: int = 255,
) -> np.ndarray:
    """Compose up to ``max_images`` equally-sized images into a square-ish
    grid (utils/collage.py:15-127)."""
    images = list(images)[:max_images]
    if not images:
        return np.full((8, 8, 3), pad_value, np.uint8)
    h, w = images[0].shape[0], images[0].shape[1]
    cols = max(1, math.ceil(math.sqrt(len(images))))
    rows = math.ceil(len(images) / cols)
    canvas = np.full(
        (rows * (h + pad) + pad, cols * (w + pad) + pad, 3), pad_value, np.uint8
    )
    for idx, img in enumerate(images):
        r, c = divmod(idx, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        canvas[y : y + h, x : x + w] = _to_u8(np.asarray(img))
    return canvas


def save_collage(canvas: np.ndarray, name: str) -> str:
    from PIL import Image

    out_dir = cf.ensure_dir(cf.get("collages_dir"))
    path = os.path.join(out_dir, "{}_{}.png".format(cf.get("session_key"), name))
    Image.fromarray(canvas).save(path)
    log.log("saved collage: {}".format(path))
    return path


def evaluation_collage(
    images: np.ndarray,
    labels: np.ndarray,
    predictions: np.ndarray,
    name: str,
    max_per_cell: int = 64,
) -> str:
    """TP/FP/FN/TN quadrant collage (utils/collage.py:349-437): four grids
    stacked vertically with one row group per confusion cell."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    groups = {
        "true_positives": (labels == IID_FOREGROUND) & (predictions == IID_FOREGROUND),
        "false_positives": (labels == IID_BACKGROUND) & (predictions == IID_FOREGROUND),
        "false_negatives": (labels == IID_FOREGROUND) & (predictions == IID_BACKGROUND),
        "true_negatives": (labels == IID_BACKGROUND) & (predictions == IID_BACKGROUND),
    }
    panels = []
    for key, mask in groups.items():
        grid = render_grid([images[i] for i in np.where(mask)[0]], max_per_cell)
        panels.append((key, grid))
    width = max(g.shape[1] for _, g in panels)
    rows = []
    for key, grid in panels:
        padded = np.full((grid.shape[0] + 12, width, 3), 255, np.uint8)
        padded[6 : 6 + grid.shape[0], : grid.shape[1]] = grid
        rows.append(padded)
    return save_collage(np.concatenate(rows, axis=0), name)


def resampled_splits_collage(
    train_split, valid_split, name: str = "resampled_splits", n_preview: int = 100
) -> Optional[str]:
    """Preview of the samples a (re-weighted) split will actually feed to the
    net (utils/collage.py:155)."""
    try:
        panels = []
        for split in (train_split, valid_split):
            it = split.new_default_iterator(n_preview)
            batch = it.next_batch
            panels.append(render_grid(list(batch.images), n_preview))
        width = max(p.shape[1] for p in panels)
        rows = []
        for p in panels:
            padded = np.full((p.shape[0] + 8, width, 3), 255, np.uint8)
            padded[4 : 4 + p.shape[0], : p.shape[1]] = p
            rows.append(padded)
        return save_collage(np.concatenate(rows, axis=0), name)
    except Exception as exc:  # visualization must never break training
        log.log("collage skipped: {}".format(exc))
        return None


def class_distribution_collage(
    images: np.ndarray, labels: np.ndarray, name: str = "class_distribution"
) -> str:
    """Per-class sample grids (utils/collage.py:440-502)."""
    labels = np.asarray(labels)
    panels = []
    for iid in (IID_BACKGROUND, IID_FOREGROUND):
        idx = np.where(labels == iid)[0]
        panels.append(render_grid([images[i] for i in idx], 64))
    width = max(p.shape[1] for p in panels)
    rows = []
    for p in panels:
        padded = np.full((p.shape[0] + 8, width, 3), 255, np.uint8)
        padded[4 : 4 + p.shape[0], : p.shape[1]] = p
        rows.append(padded)
    return save_collage(np.concatenate(rows, axis=0), name)


def removed_samples_collage(images: Sequence[np.ndarray], name: str = "removed") -> str:
    """Sheet of samples removed by filtering (utils/collage.py:130)."""
    return save_collage(render_grid(images, 100), name)


def partitioned_bundles_collage(
    bundles: Dict[str, np.ndarray], name: str = "partitioned_bundles",
    max_per_bundle: int = 49,
) -> str:
    """One grid per named data bundle, stacked (utils/collage.py:235)."""
    panels = [render_grid(list(images), max_per_bundle) for images in bundles.values()]
    width = max(p.shape[1] for p in panels)
    rows = []
    for p in panels:
        padded = np.full((p.shape[0] + 8, width, 3), 255, np.uint8)
        padded[4 : 4 + p.shape[0], : p.shape[1]] = p
        rows.append(padded)
    return save_collage(np.concatenate(rows, axis=0), name)
