"""In-repo Viola-Jones Haar-cascade evaluator (OpenCV XML compatible); the
port's copy of the JAX package's ``ops/viola_jones.py`` (numpy only).

The reference's OpenCV baseline (app/inference_ocv_app.py:35-61) and its
face-free background sampling (run_sampling.py:63-67) call
``cv2.CascadeClassifier.detectMultiScale`` with the pretrained
``haarcascade_frontalface_default.xml``. This environment's cv2 build ships
WITHOUT the objdetect module, so this module reimplements the evaluator —
parsing the standard ``opencv-cascade-classifier`` XML (stage-boosted stump
classifiers over 2-3-rect HAAR features) and running the documented
``detectMultiScale`` algorithm:

  * image pyramid: the GRAYSCALE image is bilinearly rescaled by
    ``1/scale_factor**k``; the fixed model window (24x24) slides over each
    level with OpenCV's step rule (``yStep = factor > 2 ? 1 : 2``);
  * per window, features are raw weighted rect-sums from the integral image,
    normalized by the window's intensity std over the inner (1,1,w-2,h-2)
    rect (``varianceNormFactor = 1/sqrt(area*sqsum - sum^2)``);
  * stump: ``leaf[value < threshold ? 0 : 1]`` summed per stage, windows
    failing a ``stageThreshold`` are rejected early;
  * surviving windows map back to original coordinates and group through
    the same ``groupRectangles`` semantics as the cascade's NMS
    (ops/nms.group_rectangles, eps=0.2).

Host-side by design: the Viola-Jones app is the reference's CPU baseline
comparator (SURVEY.md §2.7), not a device path, so it has no kernel.
Evaluation is numpy-vectorized over all windows of a pyramid level (flat
integral-image gathers), with per-stage early-reject compaction.

The pretrained XML itself is OpenCV's BSD-licensed asset (Intel/Lienhart,
shipped verbatim with every OpenCV distribution); this module only READS a
user-supplied path and additionally looks in the conventional
``opencv_data/`` location the reference uses.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .nms import group_rectangles


@dataclass
class HaarCascade:
    """Parsed stump-boosted HAAR cascade (the opencv-cascade-classifier
    format; tree classifiers beyond stumps are not supported)."""

    window_h: int
    window_w: int
    # per stage: (threshold, first_stump, n_stumps) into the stump arrays
    stage_thresholds: np.ndarray  # (n_stages,) float64
    stage_bounds: np.ndarray  # (n_stages, 2) int — [first, count]
    stump_feature: np.ndarray  # (n_stumps,) int
    stump_threshold: np.ndarray  # (n_stumps,) float64
    stump_leaves: np.ndarray  # (n_stumps, 2) float64 — [left, right]
    # per feature: up to 3 rects of (x, y, w, h) + weight (weight 0 = unused)
    feat_rects: np.ndarray  # (n_features, 3, 4) int
    feat_weights: np.ndarray  # (n_features, 3) float64

    @property
    def n_stages(self) -> int:
        return len(self.stage_thresholds)


def parse_cascade_xml(path: str) -> HaarCascade:
    """Parse an OpenCV ``opencv-cascade-classifier`` HAAR XML."""
    root = ET.parse(path).getroot()
    cascade = root.find("cascade")
    if cascade is None:
        raise ValueError(
            "not an opencv-cascade-classifier XML (old-format cascades are "
            "not supported): {}".format(path)
        )
    if (cascade.findtext("featureType") or "").strip() != "HAAR":
        raise ValueError("only HAAR feature cascades are supported")
    window_h = int(cascade.findtext("height"))
    window_w = int(cascade.findtext("width"))

    stage_thresholds: List[float] = []
    stage_bounds: List[Tuple[int, int]] = []
    stump_feature: List[int] = []
    stump_threshold: List[float] = []
    stump_leaves: List[Tuple[float, float]] = []
    for stage in cascade.find("stages"):
        thr = float(stage.findtext("stageThreshold"))
        first = len(stump_feature)
        for weak in stage.find("weakClassifiers"):
            nodes = [float(v) for v in weak.findtext("internalNodes").split()]
            leaves = [float(v) for v in weak.findtext("leafValues").split()]
            if len(nodes) != 4 or len(leaves) != 2:
                raise ValueError(
                    "only stump weak classifiers are supported "
                    "(got {} internal nodes)".format(len(nodes) // 4)
                )
            stump_feature.append(int(nodes[2]))
            stump_threshold.append(nodes[3])
            stump_leaves.append((leaves[0], leaves[1]))
        stage_thresholds.append(thr)
        stage_bounds.append((first, len(stump_feature) - first))

    rects_out: List[np.ndarray] = []
    weights_out: List[np.ndarray] = []
    for feat in cascade.find("features"):
        if feat.find("tilted") is not None and (
            feat.findtext("tilted") or "0"
        ).strip() not in ("0", ""):
            raise ValueError("tilted HAAR features are not supported")
        rects = np.zeros((3, 4), np.int64)
        weights = np.zeros((3,), np.float64)
        for i, r in enumerate(feat.find("rects")):
            vals = r.text.split()
            if i >= 3:
                raise ValueError("HAAR features have at most 3 rects")
            rects[i] = [int(float(v)) for v in vals[:4]]
            weights[i] = float(vals[4])
        rects_out.append(rects)
        weights_out.append(weights)

    return HaarCascade(
        window_h=window_h,
        window_w=window_w,
        stage_thresholds=np.asarray(stage_thresholds),
        stage_bounds=np.asarray(stage_bounds, np.int64),
        stump_feature=np.asarray(stump_feature, np.int64),
        stump_threshold=np.asarray(stump_threshold),
        stump_leaves=np.asarray(stump_leaves),
        feat_rects=np.stack(rects_out),
        feat_weights=np.stack(weights_out),
    )


def default_cascade_path(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the pretrained frontal-face XML: an explicit path, the
    reference-layout ``opencv_data/`` in the working directory, or the
    copy vendored at the repo root (self-contained — no dependency on
    the reference checkout, which ships the same OpenCV asset)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        explicit,
        os.path.join("opencv_data", "haarcascade_frontalface_default.xml"),
        os.path.join(repo_root, "opencv_data", "haarcascade_frontalface_default.xml"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def rgb_to_gray_u8(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(RGB2GRAY) semantics: 0.299 R + 0.587 G + 0.114 B,
    rounded to uint8."""
    if image.ndim == 2:
        return image.astype(np.uint8)
    g = (
        0.299 * image[..., 0].astype(np.float64)
        + 0.587 * image[..., 1].astype(np.float64)
        + 0.114 * image[..., 2].astype(np.float64)
    )
    return np.clip(np.round(g), 0, 255).astype(np.uint8)


def _resize_bilinear_u8(gray: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel two-tap bilinear resize of a u8 grayscale image
    (cv2.resize INTER_LINEAR sampling positions), returned as float64."""
    h, w = gray.shape
    src = gray.astype(np.float64)
    sy = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
    sx = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (sy - y0)[:, None]
    wx = (sx - x0)[None, :]
    top = src[y0][:, x0] * (1 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1 - wx) + src[y1][:, x1] * wx
    return np.round(top * (1 - wy) + bot * wy)


def _eval_windows(
    cascade: HaarCascade, level: np.ndarray, origins_y: np.ndarray, origins_x: np.ndarray
) -> np.ndarray:
    """Evaluate every cascade stage for windows at (origins_y, origins_x) on
    one pyramid level; returns a keep mask. Vectorized: flat integral-image
    gathers per stage over the still-alive windows."""
    h, w = level.shape
    ii = np.zeros((h + 1, w + 1), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(level, axis=0), axis=1)
    ii2 = np.zeros((h + 1, w + 1), np.float64)
    ii2[1:, 1:] = np.cumsum(np.cumsum(level * level, axis=0), axis=1)
    w1 = w + 1
    ii_flat = ii.ravel()
    ii2_flat = ii2.ravel()

    # variance normalization over the inner rect (1, 1, w-2, h-2):
    # nf = sqrt(area * sqsum - sum^2); degenerate windows use 1
    nh, nw = cascade.window_h - 2, cascade.window_w - 2
    area = float(nh * nw)
    base = (origins_y * w1 + origins_x).astype(np.int64)

    def rect_sum(flat, base_idx, ry, rx, rh, rw):
        tl = base_idx + ry * w1 + rx
        return (
            flat[tl]
            - flat[tl + rw]
            - flat[tl + rh * w1]
            + flat[tl + rh * w1 + rw]
        )

    s = rect_sum(ii_flat, base, 1, 1, nh, nw)
    s2 = rect_sum(ii2_flat, base, 1, 1, nh, nw)
    nf = area * s2 - s * s
    nf = np.where(nf > 0, np.sqrt(np.maximum(nf, 0)), 1.0)
    inv_nf = 1.0 / nf

    # per-feature corner offsets into the flat integral (+ - - + signs)
    rects = cascade.feat_rects  # (F, 3, 4)
    rx, ry, rw, rh = rects[..., 0], rects[..., 1], rects[..., 2], rects[..., 3]
    tl = ry * w1 + rx  # (F, 3)
    offsets = np.stack(
        [tl, tl + rw, tl + rh * w1, tl + rh * w1 + rw], axis=-1
    )  # (F, 3, 4)
    signs = np.array([1.0, -1.0, -1.0, 1.0])

    alive = np.arange(len(base))
    keep = np.zeros(len(base), bool)
    for si in range(cascade.n_stages):
        first, count = cascade.stage_bounds[si]
        fi = cascade.stump_feature[first : first + count]  # (S,)
        thr = cascade.stump_threshold[first : first + count]
        leaves = cascade.stump_leaves[first : first + count]  # (S, 2)
        # (Na, S, 3, 4) flat gathers -> weighted rect sums -> (Na, S)
        idx = base[alive][:, None, None, None] + offsets[fi][None]
        sums = (ii_flat[idx] * signs).sum(axis=-1)  # (Na, S, 3)
        vals = (sums * cascade.feat_weights[fi][None]).sum(axis=-1)
        vals = vals * inv_nf[alive][:, None]
        stage_sum = np.where(vals < thr[None], leaves[None, :, 0], leaves[None, :, 1]).sum(
            axis=1
        )
        alive = alive[stage_sum >= cascade.stage_thresholds[si]]
        if len(alive) == 0:
            break
    keep[alive] = True
    return keep


def detect_multi_scale(
    cascade: HaarCascade,
    gray: np.ndarray,
    scale_factor: float = 1.1,
    min_neighbors: int = 3,
    return_weights: bool = False,
) -> np.ndarray:
    """``cv2.CascadeClassifier.detectMultiScale`` semantics: returns (N, 4)
    int32 rects (x, y, w, h) in original image coordinates after
    groupRectangles(min_neighbors, eps=0.2). With ``return_weights`` also
    returns the per-cluster neighbor counts (detectMultiScale's
    ``levelWeights``-style confidence surrogate, used for ROC sweeps)."""
    if scale_factor <= 1.0:
        raise ValueError("scale_factor must be > 1")
    gray = np.asarray(gray)
    if gray.ndim != 2:
        gray = rgb_to_gray_u8(gray)
    h, w = gray.shape
    wh, ww = cascade.window_h, cascade.window_w

    candidates: List[Tuple[int, int, int, int]] = []
    factor = 1.0
    while True:
        sh = int(round(h / factor))
        sw = int(round(w / factor))
        if sh < wh or sw < ww:
            break
        level = (
            gray.astype(np.float64)
            if factor == 1.0
            else _resize_bilinear_u8(gray, sh, sw)
        )
        step = 1 if factor > 2.0 else 2  # OpenCV's yStep rule
        ys = np.arange(0, sh - wh + 1, step)
        xs = np.arange(0, sw - ww + 1, step)
        if len(ys) and len(xs):
            oy, ox = np.meshgrid(ys, xs, indexing="ij")
            oy = oy.ravel()
            ox = ox.ravel()
            keep = _eval_windows(cascade, level, oy, ox)
            for y, x in zip(oy[keep], ox[keep]):
                candidates.append(
                    (
                        int(round(x * factor)),
                        int(round(y * factor)),
                        int(round(ww * factor)),
                        int(round(wh * factor)),
                    )
                )
        factor *= scale_factor

    if not candidates:
        empty = np.zeros((0, 4), np.int32)
        return (empty, np.zeros((0,), np.int64)) if return_weights else empty
    rects = np.asarray(candidates, np.float64)
    grouped, weights = group_rectangles(rects, int(min_neighbors), eps=0.2)
    out = np.asarray(np.round(grouped), np.int32)
    return (out, weights) if return_weights else out


class VJDetector:
    """Convenience wrapper matching the shape of cv2.CascadeClassifier for
    the app/sampling fallbacks."""

    def __init__(self, xml_path: Optional[str] = None):
        path = default_cascade_path(xml_path)
        if path is None:
            raise FileNotFoundError(
                "no HAAR cascade XML found (looked for opencv_data/"
                "haarcascade_frontalface_default.xml); pass an explicit path"
            )
        self.cascade = parse_cascade_xml(path)
        self.path = path

    def detectMultiScale(self, gray, scaleFactor=1.1, minNeighbors=3):
        return detect_multi_scale(
            self.cascade, gray, scale_factor=scaleFactor, min_neighbors=minNeighbors
        )
