"""Dataset standardization: mean image + per-pixel std.

Same statistics as the reference preprocessor (data/preprocessor.py:26-100):
mean image over the training split, per-pixel standard deviation via a
memory-bounded Welford pass, zeros in the std replaced by 0.001, and
``(x - mean) / std`` applied to every batch before it reaches the network.

The port's copy of the JAX package's ``data/preprocessor.py`` (numpy
only, the same statistics bit for bit): ``preprocess_data`` is a pure
function, and the Welford pass is vectorized over the pixel grid
(streaming over samples), so statistics need only one image of state.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def welford_stats(samples: Iterable[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Streaming per-pixel mean/variance over an iterable of (H, W, C) images.

    Returns (mean float32, sample variance float64 with n-1 denominator, n).
    Matches the reference's online variance (data/preprocessor.py:52-72).
    """
    n = 0
    mean = None
    m2 = None
    for x in samples:
        x = np.asarray(x, dtype=np.float64)
        n += 1
        if mean is None:
            mean = np.zeros_like(x)
            m2 = np.zeros_like(x)
        delta = x - mean
        mean += delta / n
        delta2 = x - mean
        m2 += delta * delta2
    if n < 2:
        raise ValueError("Need at least 2 samples for a variance estimate.")
    return mean.astype(np.float32), m2 / (n - 1), n


class Preprocessor:
    """Standardization statistics + application.

    ``data``: (N, H, W, C) training images (any numeric dtype).
    """

    def __init__(self, data: np.ndarray | None, standardization: bool = True):
        self.active = standardization and data is not None
        if self.active:
            self._mean_image = np.mean(data, axis=0, dtype=np.float32)
            _, var, _ = welford_stats(iter(data))
            std = np.sqrt(var).astype(np.float32)
            std[std == 0] = 0.001  # prevent division by zero
            self._std = std
        else:
            self._mean_image = np.float32(0.0)
            self._std = np.float32(1.0)

    @property
    def mean_image(self) -> np.ndarray:
        return self._mean_image

    @property
    def std(self) -> np.ndarray:
        return self._std

    def preprocess_data(self, x):
        """Return standardized copy of ``x`` (a numpy array).

        Output is approximately in [-1, 1] (data/preprocessor.py:79-100).
        """
        if not self.active:
            return x.astype("float32") if hasattr(x, "astype") else x
        return (x.astype("float32") - self._mean_image) / self._std

    def state_dict(self) -> dict:
        return {
            "active": np.asarray(self.active),
            "mean_image": np.asarray(self._mean_image),
            "std": np.asarray(self._std),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "Preprocessor":
        obj = cls(None, standardization=False)
        obj.active = bool(state["active"])
        obj._mean_image = np.asarray(state["mean_image"], dtype=np.float32)
        obj._std = np.asarray(state["std"], dtype=np.float32)
        return obj
