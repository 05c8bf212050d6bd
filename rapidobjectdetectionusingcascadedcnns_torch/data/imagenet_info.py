"""ImageNet wordnet-id metadata for background-corpus construction (the
port's copy of the JAX package's ``data/imagenet_info.py``).

The reference fetches wordnet subtree listings over HTTP with a disk cache
(data/imagenet_info.py:12-39): the human subtree (``n00007846``) must not be
used as background for a face detector, and a clothing/apparel subtree is
ignored because garments co-occur with faces. The API endpoints have been
retired upstream, so the ids here are the cached roots plus the documented
direct hyponyms; :func:`refresh_from_api` keeps the online path for
environments where the endpoint (or a mirror) exists.
"""

from __future__ import annotations

from typing import Set

from ..utils import log
from ..utils.file_handler import fetch_url
from . import cache as cache_mod

HUMAN_ROOT = "n00007846"  # person, individual, someone
CLOTHING_ROOT = "n03051540"  # clothing, article of clothing, vesture

# cached root + first-level subtree ids (offline default)
_HUMAN_IDS = {
    HUMAN_ROOT,
    "n09613191",  # capitalist
    "n09618957",  # female person
    "n09624168",  # male person
    "n10287213",  # man
    "n10787470",  # woman
    "n09917593",  # child
    "n09605289",  # adult
}
_IGNORED_IDS = {
    CLOTHING_ROOT,
    "n02728440",  # apparel
    "n03419014",  # garment
    "n03476083",  # hairpiece
    "n03502509",  # headdress, headgear
    "n04197391",  # shirt
    "n04371563",  # swimsuit
}

_API_URL = "http://www.image-net.org/api/text/wordnet.structure.hyponym?wnid={}&full=1"


def human_wordnet_ids() -> Set[str]:
    cached = cache_mod.load("imagenet", "human_ids")
    return set(cached) if cached else set(_HUMAN_IDS)


def ignored_wordnet_ids() -> Set[str]:
    cached = cache_mod.load("imagenet", "ignored_ids")
    return set(cached) if cached else set(_IGNORED_IDS)


def is_usable_background(wordnet_id: str) -> bool:
    """Whether an ImageNet synset folder may contribute background samples
    (data/db/dataset_config.py:55-91 maps every non-human, non-ignored folder
    to the background class)."""
    return wordnet_id not in human_wordnet_ids() and wordnet_id not in ignored_wordnet_ids()


def refresh_from_api() -> bool:
    """Try to refresh the id sets from the (historical) ImageNet API; caches
    results when reachable. Returns success."""
    ok = True
    for key, root in (("human_ids", HUMAN_ROOT), ("ignored_ids", CLOTHING_ROOT)):
        data = fetch_url(_API_URL.format(root))
        if data is None:
            ok = False
            continue
        ids = {line.strip().lstrip("-") for line in data.decode().splitlines() if line.strip()}
        ids.add(root)
        cache_mod.save("imagenet", key, sorted(ids))
        log.log("refreshed {} ({} ids)".format(key, len(ids)))
    return ok
