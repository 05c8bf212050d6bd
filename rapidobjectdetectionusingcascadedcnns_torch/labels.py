"""Binary label registry (the port's copy of the JAX package's
``labels.py``).

Mirrors the reference label module (data/db/label.py:12-97): fixed internal
ids ``IID_BACKGROUND=0`` / ``IID_FOREGROUND=1`` plus a small dynamic registry
keyed by folder-name label keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

IID_BACKGROUND = 0
IID_FOREGROUND = 1

KEY_BACKGROUND = "background"
KEY_FOREGROUND = "foreground"


@dataclass(frozen=True)
class Label:
    iid: int
    key: str

    @property
    def name(self) -> str:
        return self.key


_by_key: Dict[str, Label] = {}
_by_iid: Dict[int, Label] = {}


def _register(label: Label) -> Label:
    _by_key[label.key] = label
    _by_iid[label.iid] = label
    return label


def reset() -> None:
    """Restore the default binary registry."""
    _by_key.clear()
    _by_iid.clear()
    _register(Label(IID_BACKGROUND, KEY_BACKGROUND))
    _register(Label(IID_FOREGROUND, KEY_FOREGROUND))


def get_by_key(key: str) -> Label:
    if key not in _by_key:
        # unknown folder keys map onto the binary scheme: anything that is not
        # literally "foreground" is background (reference
        # data/db/dataset_config.py:55-91 maps ImageNet wordnet folders this way)
        iid = IID_FOREGROUND if key == KEY_FOREGROUND else IID_BACKGROUND
        return _by_iid[iid]
    return _by_key[key]


def get_by_iid(iid: int) -> Label:
    return _by_iid[int(iid)]


def n_labels() -> int:
    return 2


def all_labels() -> List[Label]:
    return [_by_iid[i] for i in sorted(_by_iid)]


reset()
