"""Scalar-vs-list helper (the port's copy of the JAX package's
``utils/numbers.py``; reference utils/numbers.py:1-13)."""

from __future__ import annotations

from typing import Any


def is_number(value: Any) -> bool:
    """True iff ``value`` can be interpreted as a single float."""
    try:
        float(value)
        return True
    except (TypeError, ValueError):
        return False
