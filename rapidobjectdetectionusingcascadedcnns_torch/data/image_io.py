"""Host-side image resizing (the port's copy of ``resize_rgb`` from the JAX
package's ``data/image_io.py``)."""

from __future__ import annotations

import numpy as np


def resize_rgb(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear host resize to (height, width)."""
    from PIL import Image

    pil = Image.fromarray(img)
    return np.asarray(
        pil.resize((width, height), resample=Image.BILINEAR), dtype=np.uint8
    )
