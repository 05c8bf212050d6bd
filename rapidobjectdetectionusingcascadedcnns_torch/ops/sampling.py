"""Offline dataset sampling: foreground crops and rejection-sampled
backgrounds (the port's copy of the JAX package's ``ops/sampling.py``).

Re-design of the reference offline augmentation (run_sampling.py:81-186 and
utils/img_manipulation.py:11-72): each annotated native image contributes its
annotation crops as foreground samples plus up to ``sampling_multiplier``
random square background patches whose IoU with any restricted (foreground)
area stays below ``sampling_background_max_iou_with_foreground``. The draws
follow the JAX package's order (size, then x0, then y0, per try), so the same
``RandomState`` gives the same patches.

The Viola-Jones face detector that keeps unannotated faces out of the
background pool (``make_haar_face_detector``) and the reference's exact
per-image flow (``sample_image_reference``) need ``ops/viola_jones.py`` and
OpenCV, and wait for ROADMAP Queue A item 5.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import config as cf
from . import rectangles as rect_ops


class PotentialDeadlockError(RuntimeError):
    """Raised when rejection sampling keeps colliding with restricted areas
    (utils/img_manipulation.py:64-71)."""


def random_img_patch(
    img: np.ndarray,
    restricted_areas: np.ndarray,
    max_iou: float,
    min_size: int,
    rng: np.random.RandomState,
    max_tries: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random square crop avoiding restricted areas.

    Returns (patch, box). Raises :class:`PotentialDeadlockError` after
    ``max_tries`` rejected proposals, ``ValueError`` when the image is
    smaller than ``min_size``.
    """
    h, w = img.shape[0], img.shape[1]
    max_len = min(h, w)
    if max_len < min_size:
        raise ValueError("image is smaller than the minimum patch size")
    for _ in range(max_tries):
        size = rng.randint(min_size, max_len + 1)
        x0 = rng.randint(0, w - size + 1)
        y0 = rng.randint(0, h - size + 1)
        box = np.array([x0, y0, x0 + size, y0 + size], dtype=np.float64)
        if len(restricted_areas):
            ious = rect_ops.iou(box[None, :], restricted_areas)
            # IoU of disjoint boxes can go negative under the +1 convention
            if np.any(np.maximum(ious, 0.0) > max_iou):
                continue
        return img[y0 : y0 + size, x0 : x0 + size], box
    raise PotentialDeadlockError(
        "could not sample a background patch clear of restricted areas"
    )


def sample_image(
    img: np.ndarray,
    annotation_boxes: np.ndarray,
    min_patch_size: int,
    rng: np.random.RandomState,
    extra_restricted: Optional[np.ndarray] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Offline sampling of one native image (run_sampling.py:96-137).

    Returns (foreground_crops, background_patches). Restricted areas are the
    padded annotation boxes plus any externally detected regions (the
    reference adds Viola-Jones detections, run_sampling.py:114-122).
    Background sampling stops at the first deadlock or undersized image.
    """
    foreground = []
    h, w = img.shape[0], img.shape[1]
    restricted = []
    for box in annotation_boxes:
        x0, y0, x1, y1 = [int(v) for v in box]
        x0c, y0c = max(0, x0), max(0, y0)
        x1c, y1c = min(w, x1), min(h, y1)
        if x1c > x0c and y1c > y0c:
            foreground.append(img[y0c:y1c, x0c:x1c])
        restricted.append(rect_ops.restricted_area(box, img_width=w, img_height=h))
    if extra_restricted is not None and len(extra_restricted):
        restricted.extend(np.asarray(extra_restricted, dtype=np.float64))
    restricted_arr = np.stack(restricted) if restricted else np.zeros((0, 4), np.float64)

    background = []
    max_iou = cf.get("sampling_background_max_iou_with_foreground")
    for _ in range(cf.get("sampling_multiplier")):
        try:
            patch, _box = random_img_patch(img, restricted_arr, max_iou, min_patch_size, rng)
            background.append(patch)
        except (PotentialDeadlockError, ValueError):
            break
    return foreground, background
