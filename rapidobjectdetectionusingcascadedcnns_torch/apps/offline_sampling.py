"""Offline dataset sampling over the native corpus (the port's home of the
JAX package's root script ``run_sampling.py``; reference run_sampling.py).

Crops the annotated foreground boxes, rejection-samples background patches
clear of restricted areas, writes the presampled label-folder tree under
``dataset_presampled_path_root`` and clears the dataset cache so the next
load rebuilds it. Host work only (PIL, numpy, the Viola-Jones evaluator):
no kernel is involved.
"""

from __future__ import annotations

import os

import numpy as np

from .. import config as cf
from ..data import annotations as ann_mod
from ..data import cache
from ..data.file_list import FileListLoader
from ..data.image_io import DECODE_ERRORS
from ..labels import IID_FOREGROUND
from ..ops import sampling
from ..utils import log


def run_sampling(face_detector=None):
    """Offline sampling over the native corpus (reference run_sampling.py).

    ``face_detector``: optional ``image -> (K, 4) xyxy`` callable restricting
    background sampling around unannotated faces. Defaults to
    ``sampling.make_haar_face_detector()`` (cv2's detector where the build
    has objdetect, else the in-repo evaluator; reference
    run_sampling.py:60-67,114-122); annotations-only restrictions when no
    cascade XML is found. Returns (annotation crops, background patches)
    written.
    """
    from PIL import Image

    cf.set("dataset_path_root", cf.get("dataset_native_path_root"))
    cf.set("cache_dataset", False)
    loader = FileListLoader()
    rng = np.random.RandomState(cf.get("seed"))
    out_root = cf.ensure_dir("dataset_presampled_path_root")
    min_patch = cf.get("img_width")
    n_crops = n_bg = 0

    if face_detector is None and cf.get("foreground_equals_face"):
        face_detector = sampling.make_haar_face_detector()
        if face_detector is not None:
            log.log("background patches overlapping detected faces are rejected")

    for info in loader.image_infos:
        anns = ann_mod.get_annotations(info.path_original, info.dataset_key)
        boxes = np.stack([a.bbox for a in anns]) if anns else np.zeros((0, 4))
        try:
            img = info.raw_original()
        except DECODE_ERRORS as exc:
            log.log(" .. Skipped {}: {}".format(info.path_original, exc))
            continue
        detected = face_detector(img) if face_detector is not None else None
        is_foreground = info.label.iid == IID_FOREGROUND
        crops, bg = sampling.sample_image_reference(
            img, boxes, is_foreground, min_patch, rng, detected_boxes=detected
        )
        base = os.path.splitext(info.basename)[0]
        # annotation crops carry the IMAGE's label; sampled patches are
        # always background (reference run_sampling.py:96-108,127-137)
        crop_label = "foreground" if is_foreground else "background"
        crop_dir = cf.ensure_dir(os.path.join(out_root, info.dataset_key, crop_label))
        bg_dir = cf.ensure_dir(os.path.join(out_root, info.dataset_key, "background"))
        for k, patch in enumerate(crops):
            Image.fromarray(patch).save(os.path.join(crop_dir, "aug_{}_{}.png".format(base, k)))
            n_crops += 1
        for k, patch in enumerate(bg):
            Image.fromarray(patch).save(os.path.join(bg_dir, "aug_{}_bg{}.png".format(base, k)))
            n_bg += 1

    log.log("sampled {} annotation crops and {} background patches".format(n_crops, n_bg))
    cache.clear()  # rebuild caches on next dataset load (run_sampling.py:190-215)
    return n_crops, n_bg
