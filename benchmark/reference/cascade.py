"""Plain reference of the whole detector: frames -> per-stage survivors,
final windows with their confidences, groupRectangles boxes.

Every stage runs on exactly the windows that the stages before it kept
(no buffers, no capacities): stage 0 on every pyramid window, stage i on
the survivors of stage i - 1, re-extracted from the frame at their
integer boxes, reading the previous stage's bottleneck rows of those
windows. A window survives stage i when its foreground probability is
above the stage's threshold. The final confidence is the last stage's
probability. The appended Inception stage, where the configuration has
one, runs the trunk on its windows in place of the conv stack and fc1.

Imports nothing of the detector under test.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import cnn, inception_v3, nms, pyramid

ROWS = 16384          # windows a stage CNN takes at once
TRUNK_ROWS = 32       # windows the 299 px trunk takes at once


class Geometry:
    """The pyramid of one frame size: levels, boxes, extraction mode."""

    def __init__(self, img_h: int, img_w: int, window: int, min_window_length: float,
                 scale_factor: float, device):
        self.levels = pyramid.levels(img_h, img_w, window, min_window_length, scale_factor)
        ints, floats = pyramid.window_boxes(self.levels, img_h, img_w, window)
        self.boxes_int = ints
        self.n_windows = len(ints)
        self.window = window
        self.crop = len(self.levels) > 48
        self.boxes_int_dev = torch.as_tensor(ints, device=device)
        self.boxes_float_dev = torch.as_tensor(floats, device=device)


def _stage_probs(stage, windows: torch.Tensor, bneck_in, precision: str):
    if stage["kind"] == "inception":
        feats = []
        for s in range(0, windows.shape[0], TRUNK_ROWS):
            x = (windows[s:s + TRUNK_ROWS] - stage["mean"]) / stage["std"]
            feats.append(inception_v3.trunk(stage["params"]["trunk"], x, precision))
        hidden = torch.cat(feats) if feats else windows.new_zeros((0, inception_v3.WIDTH))
        return cnn.head(hidden, bneck_in, stage["params"]["fc2"], precision)
    return cnn.custom_stage(stage["params"], stage["arch"], windows, stage["mean"],
                            stage["std"], bneck_in, precision)


def _rows(stage, windows_iter, bneck_in, precision):
    probs, bnecks, start = [], [], 0
    for wins in windows_iter:
        n = wins.shape[0]
        b = None if bneck_in is None else bneck_in[start:start + n]
        p, bn = _stage_probs(stage, wins, b, precision)
        probs.append(p)
        bnecks.append(bn)
        start += n
    return torch.cat(probs), torch.cat(bnecks)


def _stage0(stage, frame: torch.Tensor, geom: Geometry, precision: str):
    if geom.crop:
        wins = pyramid.crop_resize_chunked(frame, geom.boxes_float_dev, geom.window, ROWS)
    else:
        all_wins = pyramid.gather_windows(frame[None], geom.levels, geom.window)[0]
        wins = (all_wins[s:s + ROWS] for s in range(0, all_wins.shape[0], ROWS))
    return _rows(stage, wins, None, precision)


def detect(stages: Sequence[dict], frames: torch.Tensor, geom: Geometry,
           thresholds: Sequence[Optional[float]], precision: str = "f32",
           choose: Optional[Callable[[int, List[np.ndarray]], float]] = None,
           min_neighbors: int = 1, eps: float = 0.2, with_nms: bool = True) -> List[dict]:
    """Run the cascade on (B, H, W, 3) float32 frames. A threshold that is
    None is set by ``choose(stage, [probabilities of each frame's windows
    at that stage])`` once every frame has reached the stage; the
    thresholds used are returned in each result under ``thresholds``.
    ``with_nms=False`` leaves the boxes out (empty).

    Each result: ``counts`` (survivors after each stage), ``ids`` (final
    window ids, ascending), ``conf`` (their confidences), ``boxes`` (the
    groupRectangles boxes, xyxy), ``weights`` (their member counts) and
    ``margin`` (per window of the pyramid, how far its probability lay
    from the threshold of the gate that decided it: the stage that dropped
    it, or for a survivor the closest of its stages)."""
    thresholds = list(thresholds)
    state = []
    for f in range(frames.shape[0]):
        probs, bneck = _stage0(stages[0], frames[f], geom, precision)
        state.append({"ids": torch.arange(geom.n_windows, device=frames.device),
                      "probs": probs, "bneck": bneck, "counts": [],
                      "margin": torch.full((geom.n_windows,), float("inf"),
                                           device=frames.device)})
    for i, stage in enumerate(stages):
        if i > 0:
            for f, st in enumerate(state):
                boxes = geom.boxes_int_dev[st["ids"]]
                wins = pyramid.crop_resize_chunked(frames[f], boxes, stage["size"], ROWS)
                st["probs"], st["bneck"] = _rows(stage, wins, st["bneck"], precision)
        if thresholds[i] is None:
            thresholds[i] = choose(i, [st["probs"].cpu().numpy() for st in state])
        for st in state:
            st["margin"][st["ids"]] = torch.minimum(st["margin"][st["ids"]],
                                                    st["probs"] - thresholds[i])
            keep = st["probs"] > thresholds[i]
            st["ids"], st["probs"], st["bneck"] = st["ids"][keep], st["probs"][keep], st["bneck"][keep]
            st["counts"].append(int(keep.sum()))
    results = []
    for st in state:
        ids = st["ids"].cpu().numpy()
        boxes, weights = (nms.group_rectangles(geom.boxes_int[ids], min_neighbors, eps)
                          if with_nms else (np.zeros((0, 4), np.int64), np.zeros(0, np.int64)))
        results.append({"counts": st["counts"], "ids": ids, "conf": st["probs"].cpu().numpy(),
                        "boxes": boxes, "weights": weights, "thresholds": thresholds,
                        "margin": st["margin"].abs().cpu().numpy()})
    return results
