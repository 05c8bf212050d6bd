"""Offline dataset sampling: foreground crops and rejection-sampled
backgrounds (the port's copy of the JAX package's ``ops/sampling.py``).

Re-design of the reference offline augmentation (run_sampling.py:81-186 and
utils/img_manipulation.py:11-72): each annotated native image contributes its
annotation crops as foreground samples plus up to ``sampling_multiplier``
random square background patches whose IoU with any restricted (foreground)
area stays below ``sampling_background_max_iou_with_foreground``. The draws
follow the JAX package's order (size, then x0, then y0, per try), so the same
``RandomState`` gives the same patches.

``make_haar_face_detector`` gives the Viola-Jones face detector that keeps
unannotated faces out of the background pool (cv2's, else the port's
``ops/viola_jones.py``), and ``sample_image_reference`` the reference's
exact per-image flow. All of it is host work: no kernel is involved.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import config as cf
from ..utils import log
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


def make_haar_face_detector(cascade_xml_path: Optional[str] = None):
    """Viola-Jones face detector used to keep unannotated faces out of the
    background pool (reference run_sampling.py:60-67,114-122). Returns a
    ``image -> (K, 4) xyxy boxes`` callable — cv2's CascadeClassifier when
    this build has objdetect, else the in-repo evaluator
    (ops/viola_jones.py) — or None when no cascade XML can be found
    (annotations-only fallback)."""
    from . import viola_jones as vj

    classifier = None
    try:
        import cv2

        if hasattr(cv2, "CascadeClassifier"):
            path = vj.default_cascade_path(cascade_xml_path)
            if path:
                classifier = cv2.CascadeClassifier(path)
    except ImportError:  # cv2 is optional
        pass
    if classifier is not None:
        log.log("background sampling: cv2.CascadeClassifier detects faces")
    else:
        try:
            classifier = vj.VJDetector(cascade_xml_path)
        except FileNotFoundError:
            log.log("background sampling: no HAAR cascade XML, annotations only")
            return None
        log.log("background sampling: the in-repo Viola-Jones evaluator detects faces "
                "({})".format(classifier.path))

    def detect(img: np.ndarray) -> np.ndarray:
        gray = vj.rgb_to_gray_u8(img)
        # deliberately recall-heavy settings: false positives only shrink the
        # background pool, false negatives poison it (run_sampling.py:60-63)
        faces = classifier.detectMultiScale(
            gray, 1.1, cf.get("nms_opencv_min_neighbors")
        )
        if len(faces) == 0:
            return np.zeros((0, 4), np.float64)
        faces = np.asarray(faces, np.float64)
        return np.stack(
            [faces[:, 0], faces[:, 1], faces[:, 0] + faces[:, 2], faces[:, 1] + faces[:, 3]],
            axis=1,
        )

    return detect


def sample_image_reference(
    img: np.ndarray,
    annotation_boxes: np.ndarray,
    is_foreground: bool,
    min_patch_size: int,
    rng: np.random.RandomState,
    detected_boxes: Optional[np.ndarray] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One native image's offline samples with the reference's exact flow
    (run_sampling.py:81-137):

      * every valid annotation box is cropped as a sample carrying the
        image's label (foreground crops for foreground images);
      * annotation boxes restrict background sampling only on FOREGROUND
        images; externally detected faces (``detected_boxes``, the Haar
        detector) always restrict but are never emitted as samples;
      * background patches are sampled from background images
        unconditionally and from foreground images only when restrictions
        exist, topping the image's sample count up to ``sampling_multiplier``
        (annotation crops count toward the quota), stopping at the first
        rejection-sampling deadlock.

    Returns (annotation_crops, background_patches).
    """
    h, w = img.shape[0], img.shape[1]
    crops: List[np.ndarray] = []
    restricted: List[np.ndarray] = []
    for box in np.asarray(annotation_boxes).reshape(-1, 4):
        x0, y0, x1, y1 = [int(v) for v in box]
        x0c, y0c = max(0, x0), max(0, y0)
        x1c, y1c = min(w, x1), min(h, y1)
        if x1c > x0c and y1c > y0c:
            crops.append(img[y0c:y1c, x0c:x1c])
        if is_foreground:
            restricted.append(
                rect_ops.restricted_area(box, img_width=w, img_height=h)
            )
    if detected_boxes is not None:
        for box in np.asarray(detected_boxes, np.float64).reshape(-1, 4):
            restricted.append(
                rect_ops.restricted_area(box, img_width=w, img_height=h)
            )
    restricted_arr = (
        np.stack(restricted) if restricted else np.zeros((0, 4), np.float64)
    )

    background: List[np.ndarray] = []
    if not is_foreground or len(restricted):
        max_iou = cf.get("sampling_background_max_iou_with_foreground")
        while len(crops) + len(background) < cf.get("sampling_multiplier"):
            try:
                patch, _box = random_img_patch(
                    img, restricted_arr, max_iou, min_patch_size, rng
                )
                background.append(patch)
            except (PotentialDeadlockError, ValueError):
                break
    return crops, background
