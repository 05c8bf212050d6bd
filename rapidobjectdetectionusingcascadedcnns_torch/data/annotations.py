"""Ground-truth annotations (bounding boxes per image file); the port's
copy of the JAX package's ``data/annotations.py`` (sqlite and numpy only).

Mirrors the reference annotation layer (data/annotation.py): an Annotation
wraps a bounding box; AFLW face rectangles are loaded from the ``aflw.sqlite``
database (data/annotation.py:67-122); datasets listed in
``dataset_keys_annotated`` are the ones with ground truth.
"""

from __future__ import annotations

import os
import sqlite3
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import config as cf


@dataclass
class Annotation:
    """One annotated object: bbox in (xmin, ymin, xmax, ymax)."""

    bbox: np.ndarray

    @property
    def xmin(self):
        return self.bbox[0]

    @property
    def ymin(self):
        return self.bbox[1]

    @property
    def xmax(self):
        return self.bbox[2]

    @property
    def ymax(self):
        return self.bbox[3]


def has_annotations(dataset_key: str) -> bool:
    return dataset_key in cf.get("dataset_keys_annotated")


_aflw_cache: Optional[Dict[str, List[Annotation]]] = None


def _aflw_db_path() -> str:
    return os.path.join(cf.get("dataset_path_root"), "aflw", "aflw.sqlite")


def load_aflw_annotations(db_path: Optional[str] = None) -> Dict[str, List[Annotation]]:
    """All AFLW face rectangles keyed by image file name.

    Single bulk query instead of the reference's per-image queries
    (data/annotation.py:84-98) — same join across FaceImages/Faces/FaceRect.
    """
    db_path = db_path or _aflw_db_path()
    out: Dict[str, List[Annotation]] = {}
    if not os.path.exists(db_path):
        return out
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT FaceImages.filepath, FaceRect.x, FaceRect.y, FaceRect.w, "
            "FaceRect.h FROM FaceImages JOIN Faces ON "
            "FaceImages.file_id = Faces.file_id JOIN FaceRect ON "
            "Faces.face_id = FaceRect.face_id"
        ).fetchall()
    finally:
        conn.close()
    for filepath, x, y, w, h in rows:
        name = os.path.basename(filepath)
        out.setdefault(name, []).append(
            Annotation(np.array([x, y, x + w, y + h], dtype=np.float64))
        )
    return out


def get_annotations(image_path: str, dataset_key: str) -> List[Annotation]:
    """Annotations for one image file (data/annotation.py:52-64)."""
    global _aflw_cache
    if not has_annotations(dataset_key):
        return []
    if dataset_key == "aflw":
        if _aflw_cache is None:
            _aflw_cache = load_aflw_annotations()
        return _aflw_cache.get(os.path.basename(image_path), [])
    return []


def reset_cache() -> None:
    global _aflw_cache
    _aflw_cache = None
