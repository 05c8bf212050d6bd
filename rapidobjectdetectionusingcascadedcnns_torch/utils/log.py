"""Session logger.

Same surface as the reference logger (utils/log.py:22-62): timestamped lines,
an in-memory cache, and ``log_save`` persisting ``<session_key>-<name>.txt``.
The port's copy of the JAX package's ``utils/log.py``, on the stdlib.
"""

from __future__ import annotations

import os
import time
from typing import List

_log_cache: List[str] = []
_name = "log"
_echo = True


def log(message: str = "") -> None:
    line = "{} {}".format(time.strftime("%H:%M:%S"), message)
    _log_cache.append(line)
    if _echo:
        print(line, flush=True)


def log_set_name(name: str) -> None:
    global _name
    _name = name


def set_echo(echo: bool) -> None:
    global _echo
    _echo = echo


def log_clear() -> None:
    _log_cache.clear()


def log_lines() -> List[str]:
    return list(_log_cache)


def log_save(directory: str, session_key: str, name: str | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "{}-{}.txt".format(session_key, name or _name))
    with open(path, "w") as f:
        f.write("\n".join(_log_cache) + "\n")
    return path
