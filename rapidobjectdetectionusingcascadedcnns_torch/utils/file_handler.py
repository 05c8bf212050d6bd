"""File/URL helpers (the port's copy of the JAX package's
``utils/file_handler.py``; reference utils/file_handler.py).

``fetch_url`` with rotating user agents (:40-64; returns None where there
is no network), which ``data/imagenet_info.py`` calls. ``read_txt_lines``
and ``open_file`` come with their first callers (ROADMAP Queue A item 5b).
"""

from __future__ import annotations

import http.client
import random
from typing import Optional

from . import log

_USER_AGENTS = [
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko)",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) Gecko/20100101 Firefox/115.0",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15) Safari/605.1.15",
]


def fetch_url(url: str, timeout: float = 10.0) -> Optional[bytes]:
    """Fetch a URL with a rotated user agent; None on any network failure
    (offline environments must degrade gracefully)."""
    import urllib.request

    try:
        req = urllib.request.Request(
            url, headers={"User-Agent": random.choice(_USER_AGENTS)}
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    # URLError and timeouts are OSErrors; a truncated or garbled reply
    # (IncompleteRead, BadStatusLine) is an HTTPException
    except (OSError, ValueError, http.client.HTTPException) as exc:
        log.log("fetch_url failed for {}: {}".format(url, exc))
        return None

