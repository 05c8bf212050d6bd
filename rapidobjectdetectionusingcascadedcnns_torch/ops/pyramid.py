"""Image-pyramid / sliding-window schedule (the port's copy of the JAX
package's ``ops/pyramid.py``).

The reference enumerates sliding windows with nested Python ``while`` loops
over scales and grid positions and extracts pixels one window at a time
(data/rectangles.py:309-435). Here the *schedule* is computed once on the
host as a static ``PyramidPlan`` (pure function of the image size and
config) and the *pixels* are produced on the device (:mod:`.windows`,
:mod:`.windows_sched`).

Math parity with the reference (oracle-tested in tests/test_pyramid.py):
  * scale loop: ``scale /= f``, float ``w/h`` divided alongside, stop when a
    dimension drops below the window size (data/rectangles.py:418-425);
  * a scale is *skipped* (not stopped) while the image is still larger than
    ``(1/min_window_length) * window_width`` (data/rectangles.py:359-366);
  * step rule ``max(min(int(0.4*win), int(0.1*img)), 1)``
    (data/rectangles.py:386-387);
  * strict ``xmax < img_width`` / ``ymax < img_height`` bounds against the
    *float* tracked dims (data/rectangles.py:391-404);
  * window ordering: scale-major, then x, then y (x is the outer grid loop);
  * normalized coords truncate: ``int(x / scale)`` (data/rectangles.py:249-262).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ScaleSpec:
    """One pyramid level: resized image dims plus the window grid on it."""

    scale: float  # multiplier vs the original image (<= 1.0)
    scaled_h: int  # = int(img_h * scale): truncation like scipy imresize
    scaled_w: int
    step_x: int
    step_y: int
    xs: Tuple[int, ...]  # window xmin values on the scaled image
    ys: Tuple[int, ...]

    @property
    def n_windows(self) -> int:
        return len(self.xs) * len(self.ys)


@dataclass(frozen=True)
class PyramidPlan:
    """Static sliding-window schedule for one image size. Hashable, so it
    can key the caches of per-plan tables (index tables, schedules)."""

    img_h: int
    img_w: int
    window_h: int
    window_w: int
    scales: Tuple[ScaleSpec, ...]

    @property
    def n_windows(self) -> int:
        return sum(s.n_windows for s in self.scales)

    @property
    def n_scales(self) -> int:
        return len(self.scales)


def _grid_positions(img_len: float, window_len: int, step: int) -> Tuple[int, ...]:
    """All start positions ``p in {0, step, 2*step, ...}`` with
    ``p + window_len < img_len`` (strict, float bound) — reference
    data/rectangles.py:391-404."""
    out = []
    p = 0
    while p + window_len < img_len:
        out.append(p)
        p += step
    return tuple(out)


@functools.lru_cache(maxsize=512)
def build_plan(
    img_h: int,
    img_w: int,
    window_h: int,
    window_w: int,
    min_window_length: float,
    window_scale_factor: float,
) -> PyramidPlan:
    """Compute the full pyramid schedule (host-side, cached per image size)."""
    if window_scale_factor <= 1.0:
        raise ValueError("window_scale_factor must be > 1.0")

    scales = []
    scale = 1.0
    h = float(img_h)
    w = float(img_w)
    # maximum number of non-overlapping windows per row caps how large the
    # (virtual) image may be at an extracted scale (data/rectangles.py:359-361)
    max_img_length = (1.0 / min_window_length) * window_w

    while True:
        if w < max_img_length and h < max_img_length:
            step_x = max(min(int(0.4 * window_w), int(0.1 * w)), 1)
            step_y = max(min(int(0.4 * window_h), int(0.1 * h)), 1)
            xs = _grid_positions(w, window_w, step_x)
            ys = _grid_positions(h, window_h, step_y)
            if xs and ys:
                scales.append(
                    ScaleSpec(
                        scale=scale,
                        scaled_h=int(img_h * scale),
                        scaled_w=int(img_w * scale),
                        step_x=step_x,
                        step_y=step_y,
                        xs=xs,
                        ys=ys,
                    )
                )
        # next scale (data/rectangles.py:418-425)
        scale /= window_scale_factor
        h /= window_scale_factor
        w /= window_scale_factor
        if h < window_h or w < window_w:
            break

    return PyramidPlan(
        img_h=img_h,
        img_w=img_w,
        window_h=window_h,
        window_w=window_w,
        scales=tuple(scales),
    )


def plan_from_config(img_h: int, img_w: int, cf_module=None) -> PyramidPlan:
    """Build a plan using the live config (img_width/height = window dims)."""
    if cf_module is None:
        from .. import config as cf_module
    return build_plan(
        img_h,
        img_w,
        cf_module.get("img_height"),
        cf_module.get("img_width"),
        cf_module.get("min_window_length"),
        cf_module.get("window_scale_factor"),
    )


def window_table(plan: PyramidPlan):
    """Flattened per-window metadata arrays, in plan ordering.

    Returns dict of numpy arrays:
      ``coords``      (N, 4) int32 — (xmin, ymin, xmax, ymax) on the scaled image
      ``scales``      (N,)  float64 — scale of each window
      ``scale_idx``   (N,)  int32  — index into ``plan.scales``
      ``coords_norm`` (N, 4) int32 — coords on the original image,
                                      ``int(v / scale)`` truncation
                                      (data/rectangles.py:249-262)
    """
    coords = np.empty((plan.n_windows, 4), dtype=np.int32)
    scales = np.empty((plan.n_windows,), dtype=np.float64)
    scale_idx = np.empty((plan.n_windows,), dtype=np.int32)
    boxes_float = np.empty((plan.n_windows, 4), dtype=np.float64)
    offset = 0
    for si, s in enumerate(plan.scales):
        nx, ny = len(s.xs), len(s.ys)
        n = nx * ny
        xs = np.asarray(s.xs, dtype=np.int64)
        ys = np.asarray(s.ys, dtype=np.int64)
        # ordering: x-major (outer), y inner — reference rectangles.py:391-408
        xmin = np.repeat(xs, ny)
        ymin = np.tile(ys, nx)
        coords[offset : offset + n, 0] = xmin
        coords[offset : offset + n, 1] = ymin
        coords[offset : offset + n, 2] = xmin + plan.window_w
        coords[offset : offset + n, 3] = ymin + plan.window_h
        scales[offset : offset + n] = s.scale
        scale_idx[offset : offset + n] = si
        # exact resize ratios of the int-truncated level dims: crop-mode
        # sampling of these float boxes coincides with resize-then-slice
        rw = plan.img_w / s.scaled_w
        rh = plan.img_h / s.scaled_h
        boxes_float[offset : offset + n, 0] = xmin * rw
        boxes_float[offset : offset + n, 1] = ymin * rh
        boxes_float[offset : offset + n, 2] = (xmin + plan.window_w) * rw
        boxes_float[offset : offset + n, 3] = (ymin + plan.window_h) * rh
        offset += n

    # int() truncation toward zero (coords are non-negative => floor)
    coords_norm = (coords.astype(np.float64) / scales[:, None]).astype(np.int32)
    return {
        "coords": coords,
        "scales": scales,
        "scale_idx": scale_idx,
        "coords_norm": coords_norm,
        # exact float window geometry on the original image: crop_and_resize
        # of these boxes samples the same positions as resize-then-slice
        "boxes_float": boxes_float.astype(np.float32),
    }
