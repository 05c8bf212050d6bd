"""What decides ``correct``: every answer the window produced, held against
the plain reference's answer for the same frame.

Numbers, each the worst over the requests answered (a request is one
call: a batch of frames or one image). A window flips where one side
keeps it to the end and the other does not; rounding flips only windows
whose probability lies close to the threshold of the gate that decided
them, while a window lost or added by a fault lies anywhere.

  * ``flip_margin``: of the flipped windows, the farthest that the
    reference's probability lay from the threshold of the gate that
    decided it;
  * ``flip_mass``: of a frame, the sum of those distances over its flipped
    windows, over the number of windows the reference kept to the end
    (a few flips at their thresholds weigh little; lost or added windows,
    or an answer with none, weigh about their mean distance each);
  * ``conf_gap``: the largest gap between the two sides' confidence of a
    final window both have;
  * ``nms_mismatch``: frames whose boxes are not exactly the reference's
    groupRectangles of the program's own final windows (the NMS judged on
    its own input, so a window flipped at a gate does not count here).

A frame the program returns no answer for counts as having kept no window
and as an NMS mismatch. The cell's workload file names the numbers that
are compared and their limits; a run reports the others beside no limit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..reference import nms as ref_nms


def request_numbers(prog: List[dict], ref: List[dict], boxes_int: np.ndarray,
                    min_neighbors: int, eps: float) -> Dict[str, float]:
    """The numbers of one request: ``prog`` and ``ref`` hold one answer per
    frame (``ids``, ``conf``; the program's also ``boxes``)."""
    conf_gap = margin = mass = 0.0
    mismatch = 0
    for i, b in enumerate(ref):
        ids_r = np.asarray(b["ids"])
        a = prog[i] if i < len(prog) else None  # no answer: no window kept
        ids_p = np.asarray(a["ids"] if a is not None else [], np.int64)
        flipped = b["margin"][np.setxor1d(ids_p, ids_r)]
        margin = max(margin, float(flipped.max(initial=0.0)))
        mass = max(mass, float(flipped.sum()) / max(len(ids_r), 1))
        if a is None:
            mismatch += 1
            continue
        common, ip, ir = np.intersect1d(ids_p, ids_r, return_indices=True)
        if len(common):
            gap = np.abs(np.asarray(a["conf"], np.float64)[ip] - np.asarray(b["conf"])[ir])
            conf_gap = max(conf_gap, float(gap.max()))
        expect, _ = ref_nms.group_rectangles(boxes_int[ids_p], min_neighbors, eps)
        if not _same_boxes(np.asarray(a["boxes"], np.float64).reshape(-1, 4), expect):
            mismatch += 1
    return {"flip_margin": margin, "flip_mass": mass, "conf_gap": conf_gap,
            "nms_mismatch": float(mismatch + max(0, len(prog) - len(ref)))}


def _same_boxes(got: np.ndarray, expect: np.ndarray) -> bool:
    if got.shape != expect.shape:
        return False
    key = lambda b: b[np.lexsort(b.T[::-1])] if len(b) else b  # noqa: E731
    return bool(np.array_equal(key(got), key(expect.astype(np.float64))))


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(worst_numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is at or under its limit (a limit
    with no number fails; a number with no limit is not compared)."""
    return all(k in worst_numbers and worst_numbers[k] <= v for k, v in limits.items())
