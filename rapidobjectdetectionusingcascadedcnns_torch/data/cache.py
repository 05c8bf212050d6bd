"""Versioned on-disk cache (the port's copy of the JAX package's
``data/cache.py``): the generic category store (data/cache.py:140-246),
which ``data/imagenet_info.py`` reads and writes. The dataset store
(data/cache.py:54-77,248-298) comes with its first caller, the train apps
(ROADMAP Queue A item 5b).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from .. import config as cf

CACHE_VERSION = 1


def _category_path(category: str, key: str) -> str:
    root = os.path.join(cf.get("cache_path_root"), "v{}".format(CACHE_VERSION))
    return os.path.join(root, "generic", category, key + ".pkl")


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
