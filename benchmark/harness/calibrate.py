"""Each stage's threshold, set with the plain reference on a run's frame
pool so that no frame keeps more windows after a stage than the traffic
file names: the most a frame of the trained flagship kept there, at that
frame size and scale (random weights at the published 0.5 would keep two
thirds of the windows and send every frame up the re-dispatch ladder,
which a trained cascade does not do).

``survivors_per_frame`` lists the custom stages' maxima; an appended stage
(the Inception stage) keeps the share of the windows that reach it that
the last custom stage's maximum is of the one before. A share of 1 keeps
every window (threshold 0, below any softmax probability), and the stage
is then not run here.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..reference import cascade as ref_cascade


def _at_most(probs: List[np.ndarray], n_keep: int) -> float:
    """A threshold at which no frame has more than ``n_keep`` probabilities
    above it and the frame that keeps the most keeps ``n_keep``: midway
    between the n_keep-th and the next largest probability of the frame
    whose next one is largest."""
    best = None
    for p in probs:
        if len(p) > n_keep:
            top = np.sort(p.astype(np.float64))[::-1]
            if best is None or top[n_keep] > best[1]:
                best = (top[n_keep - 1] if n_keep else top[0] + 1.0, top[n_keep])
    return 0.0 if best is None else float((best[0] + best[1]) / 2.0)


def _keep_share(probs: List[np.ndarray], share: float) -> float:
    """The threshold midway between the k-th and the next largest of all
    probabilities, k the ``share`` of them."""
    allp = np.sort(np.concatenate(probs))[::-1]
    n_keep = int(round(share * len(allp)))
    if n_keep >= len(allp):
        return 0.0
    if n_keep <= 0:
        return float(allp[0])
    return float((np.float64(allp[n_keep - 1]) + np.float64(allp[n_keep])) / 2.0)


def thresholds(stages, frames, geom, calibration: dict) -> List[float]:
    """Thresholds of every stage for the (B, H, W, 3) float32 ``frames``."""
    targets = [float(t) for t in calibration["survivors_per_frame"]]
    n_custom = sum(1 for s in stages if s["kind"] == "custom")
    if len(targets) != n_custom:
        raise ValueError("calibration names {} stages, the configuration has {}".format(
            len(targets), n_custom))
    shares = [targets[-1] / targets[-2]] * (len(stages) - n_custom)

    def choose(i, probs):
        if i < n_custom:
            return _at_most(probs, int(targets[i]))
        return _keep_share(probs, shares[i - n_custom])

    custom_like = n_custom + sum(1 for s in shares if s < 1.0)
    res = ref_cascade.detect(stages[:custom_like], frames, geom, [None] * custom_like,
                             choose=choose, with_nms=False)
    return list(res[0]["thresholds"]) + [0.0] * (len(stages) - custom_like)
