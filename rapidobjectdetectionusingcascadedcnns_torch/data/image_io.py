"""Host-side image IO and per-file metadata (the port's copy of the JAX
package's ``data/image_io.py``).

Re-design of the reference's ``ImageInfo`` (data/image_info.py): lazy pixel
access with per-scale caching, always-RGB decoding, resized-patch extraction.
PIL replaces the removed ``scipy.misc`` imread/imresize; scaled dims use the
same ``int(dim * ratio)`` truncation as scipy's imresize did.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..labels import Label


# what PIL raises on a missing, unreadable or corrupt image file
DECODE_ERRORS = (OSError, ValueError, SyntaxError)


def load_rgb(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB (data/image_info.py:229-236)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def resize_rgb(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear host resize to (height, width)."""
    from PIL import Image

    pil = Image.fromarray(img)
    return np.asarray(
        pil.resize((width, height), resample=Image.BILINEAR), dtype=np.uint8
    )


class ImageInfo:
    """Per-file metadata with lazy, cacheable pixel access."""

    def __init__(self, path: str, label: Label, dataset_key: str):
        self.path_original = path
        self.label = label
        self.dataset_key = dataset_key
        self._cache: Dict[str, np.ndarray] = {}
        self._dims: Optional[Tuple[int, int]] = None  # (width, height)

    @property
    def basename(self) -> str:
        return os.path.basename(self.path_original)

    @property
    def full_key(self) -> str:
        return "{}/{}".format(self.dataset_key, self.path_original)

    def _load_dims(self) -> None:
        if "original" in self._cache:
            arr = self._cache["original"]
            self._dims = (arr.shape[1], arr.shape[0])
        else:
            from PIL import Image

            with Image.open(self.path_original) as im:
                self._dims = im.size

    @property
    def img_width_original(self) -> int:
        if self._dims is None:
            self._load_dims()
        return self._dims[0]

    @property
    def img_height_original(self) -> int:
        if self._dims is None:
            self._load_dims()
        return self._dims[1]

    def raw_original(self, cache: bool = False) -> np.ndarray:
        if "original" in self._cache:
            return self._cache["original"]
        data = load_rgb(self.path_original)
        if cache:
            self._cache["original"] = data
        return data

    def raw_scaled(self, cache: bool = False, ratio: float = 1.0) -> np.ndarray:
        """Original image rescaled by ``ratio`` with int-truncated dims."""
        if ratio == 1.0:
            return self.raw_original(cache)
        key = "scaled_{}".format(ratio)
        if key in self._cache:
            return self._cache[key]
        orig = self.raw_original(cache)
        h = int(orig.shape[0] * ratio)
        w = int(orig.shape[1] * ratio)
        data = resize_rgb(orig, h, w)
        if cache:
            self._cache[key] = data
        return data

    def is_raw_scaled_cached(self, ratio: float) -> bool:
        return "scaled_{}".format(ratio) in self._cache

    def raw_resized(
        self,
        height: int,
        width: int,
        annotation_box: Optional[np.ndarray] = None,
        rng: Optional[np.random.RandomState] = None,
    ) -> np.ndarray:
        """Fixed-size training patch (data/image_info.py:140-195):
        annotation crop when a bbox is given, otherwise a random square patch
        for annotated-background datasets, otherwise the full image."""
        img = self.raw_original()
        if annotation_box is not None:
            x0, y0, x1, y1 = [int(v) for v in annotation_box]
            x0 = max(0, x0)
            y0 = max(0, y0)
            x1 = min(img.shape[1], max(x1, x0 + 1))
            y1 = min(img.shape[0], max(y1, y0 + 1))
            img = img[y0:y1, x0:x1]
        return resize_rgb(img, height, width)

    def clear_raw_img_cache(self) -> None:
        self._cache.clear()

    def is_loadable(self) -> bool:
        """Broken-image check (reference uses a TF decode probe,
        data/db/file_list_loader.py:275-333)."""
        try:
            self.raw_original()
            return True
        except DECODE_ERRORS:
            return False
