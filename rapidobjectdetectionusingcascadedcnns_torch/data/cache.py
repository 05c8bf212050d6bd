"""Versioned on-disk cache (the port's copy of the JAX package's
``data/cache.py``).

Npz re-design of the reference cache (data/cache.py): datasets keyed by
``<W>x<H>/<dataset_key>`` under a versioned root, storing images, labels, the
full config snapshot and the preprocessor state (data/cache.py:54-77,248-298),
plus a generic category store (data/cache.py:140-246), which
``data/imagenet_info.py`` reads and writes. The layout, the npz keys and the
config snapshot are the JAX package's, so a dataset either package caches is
one the other reads.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Optional, Tuple

import numpy as np

from .. import config as cf
from ..utils import log
from .preprocessor import Preprocessor

CACHE_VERSION = 1


def _root() -> str:
    return os.path.join(cf.get("cache_path_root"), "v{}".format(CACHE_VERSION))


def _dataset_dir(dataset_key: str, width: int, height: int) -> str:
    return os.path.join(_root(), "{}x{}".format(width, height), dataset_key)


def dataset_cached(dataset_key: str, width: int, height: int) -> bool:
    return os.path.exists(os.path.join(_dataset_dir(dataset_key, width, height), "data.npz"))


def save_dataset(
    dataset_key: str,
    width: int,
    height: int,
    images: np.ndarray,
    labels: np.ndarray,
    preprocessor: Preprocessor,
) -> str:
    d = cf.ensure_dir(_dataset_dir(dataset_key, width, height))
    path = os.path.join(d, "data.npz")
    state = preprocessor.state_dict()
    np.savez_compressed(
        path,
        images=images,
        labels=labels,
        pp_active=state["active"],
        pp_mean=state["mean_image"],
        pp_std=state["std"],
    )
    # the full config snapshot rides along for debuggability
    # (data/cache.py:273-274)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(
            {k: repr(v) for k, v in cf.snapshot().items()}, f, indent=2, sort_keys=True
        )
    log.log("cached dataset {} at {}x{} -> {}".format(dataset_key, width, height, path))
    return path


def load_dataset(
    dataset_key: str, width: int, height: int
) -> Optional[Tuple[np.ndarray, np.ndarray, Preprocessor]]:
    path = os.path.join(_dataset_dir(dataset_key, width, height), "data.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        images = data["images"]
        labels = data["labels"]
        pp = Preprocessor.from_state_dict(
            {"active": data["pp_active"], "mean_image": data["pp_mean"], "std": data["pp_std"]}
        )
    log.log("loaded dataset cache {} ({} samples)".format(path, len(images)))
    return images, labels, pp


# ---------------------------------------------------------------------------
# generic category store (data/cache.py:140-246)
# ---------------------------------------------------------------------------


def _category_path(category: str, key: str) -> str:
    return os.path.join(_root(), "generic", category, key + ".pkl")


def save(category: str, key: str, value: Any) -> str:
    path = _category_path(category, key)
    cf.ensure_dir(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(value, f)
    return path


def load(category: str, key: str, default: Any = None) -> Any:
    path = _category_path(category, key)
    if not os.path.exists(path):
        return default
    with open(path, "rb") as f:
        return pickle.load(f)


def clear() -> None:
    if os.path.exists(_root()):
        shutil.rmtree(_root())
