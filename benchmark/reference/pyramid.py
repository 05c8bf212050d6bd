"""Plain reference: the sliding-window pyramid, stage-0 windows and the
re-extraction of survivor boxes, in float32.

Written from the reference detector's window rules
(Johnson145/RapidObjectDetectionUsingCascadedCNNs ``data/rectangles.py``):

  * scales: ``scale /= f`` with the float image dims divided alongside,
    stop when a dim drops below the window; a scale is skipped while the
    image is longer than ``window / min_window_length``;
  * step ``max(min(int(0.4 * window), int(0.1 * dim)), 1)``; positions ``p``
    with ``p + window < dim`` (the float dim);
  * order: scale-major, then x, then y; original-image coordinates
    truncate, ``int(v / scale)``.

Gather mode (coarse pyramids) resizes every level with an antialiased
bilinear filter as ``jax.image.resize`` defines it (triangle kernel
stretched by the downscale, weights normalised), quantises to u8 below
scale 1 and slices the windows. Crop mode (more than 48 levels) samples
every window straight from the frame at its exact float box. A later
stage re-extracts its windows from the frame at their truncated integer
boxes. Both samplings are cv2-style half-pixel bilinear on the crop,
clamped inside it, then quantised to u8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Level:
    scale: float
    scaled_h: int
    scaled_w: int
    xs: Tuple[int, ...]
    ys: Tuple[int, ...]


def _positions(dim: float, window: int, step: int) -> Tuple[int, ...]:
    out, p = [], 0
    while p + window < dim:
        out.append(p)
        p += step
    return tuple(out)


def levels(img_h: int, img_w: int, window: int, min_window_length: float,
           scale_factor: float) -> List[Level]:
    """Every pyramid level that holds at least one window."""
    out, scale, h, w = [], 1.0, float(img_h), float(img_w)
    longest = (1.0 / min_window_length) * window
    while True:
        if w < longest and h < longest:
            xs = _positions(w, window, max(min(int(0.4 * window), int(0.1 * w)), 1))
            ys = _positions(h, window, max(min(int(0.4 * window), int(0.1 * h)), 1))
            if xs and ys:
                out.append(Level(scale, int(img_h * scale), int(img_w * scale), xs, ys))
        scale /= scale_factor
        h /= scale_factor
        w /= scale_factor
        if h < window or w < window:
            return out


def window_boxes(lvls: List[Level], img_h: int, img_w: int, window: int):
    """(integer boxes on the original image (N, 4) int64, exact float boxes
    (N, 4) float32), xyxy with exclusive max, in window order."""
    ints, floats = [], []
    for lv in lvls:
        xs = np.repeat(np.asarray(lv.xs, np.float64), len(lv.ys))
        ys = np.tile(np.asarray(lv.ys, np.float64), len(lv.xs))
        scaled = np.stack([xs, ys, xs + window, ys + window], axis=1)
        ints.append((scaled / lv.scale).astype(np.int64))
        ratio = np.array([img_w / lv.scaled_w, img_h / lv.scaled_h] * 2)
        floats.append(scaled * ratio)
    return np.concatenate(ints), np.concatenate(floats).astype(np.float32)


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 weights of an antialiased bilinear resize
    along one axis (``jax.image.resize(..., "bilinear", antialias=True)``,
    computed in float64)."""
    inv = n_in / n_out
    stretch = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    dist = np.abs(centre[:, None] - np.arange(n_in)[None, :]) / stretch
    w = np.maximum(0.0, 1.0 - dist)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.as_tensor(w * inside[:, None], dtype=torch.float32, device=device)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0)


def gather_windows(images: torch.Tensor, lvls: List[Level], window: int) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, N, window, window, C) float32, every
    window of every level in window order."""
    b, h, w, c = images.shape
    parts = []
    for lv in lvls:
        if (lv.scaled_h, lv.scaled_w) == (h, w):
            scaled = images
        else:
            my = resize_matrix(h, lv.scaled_h, images.device)
            mx = resize_matrix(w, lv.scaled_w, images.device)
            scaled = quantize_u8(torch.einsum("yh,bhwc,xw->byxc", my, images, mx))
        ys = torch.as_tensor(lv.ys, device=images.device)[:, None] + torch.arange(
            window, device=images.device)
        xs = torch.as_tensor(lv.xs, device=images.device)[:, None] + torch.arange(
            window, device=images.device)
        rows = scaled[:, ys]                    # (B, ny, wy, W, C)
        wins = rows[:, :, :, xs]                # (B, ny, wy, nx, wx, C)
        wins = wins.permute(0, 3, 1, 2, 4, 5)   # (B, nx, ny, wy, wx, C)
        parts.append(wins.reshape(b, -1, window, window, c))
    return torch.cat(parts, dim=1)


def _sample_axis(lo: torch.Tensor, hi: torch.Tensor, out: int, limit: int) -> torch.Tensor:
    """Half-pixel sampling positions of (n,) spans [lo, hi) at ``out``
    samples, clamped inside the span and the image: (n, out). The step is
    ``span * f32(1 / out)`` and ``(o + 0.5) * step - 0.5`` is rounded once
    to float32, as the detector's compiled program evaluates it."""
    span = (hi - lo).float()
    step = span * torch.tensor(1.0 / out, dtype=torch.float32)
    o = torch.arange(out, dtype=torch.float64, device=lo.device) + 0.5
    local = (o[None, :] * step.double()[:, None] - 0.5).float()
    local = torch.minimum(torch.clamp(local, min=0.0), torch.clamp(span - 1.0, min=0.0)[:, None])
    return torch.clamp(local + lo.float()[:, None], 0.0, limit - 1.0)


def crop_resize(image: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """One (H, W, C) float32 frame, (n, 4) xyxy float boxes -> (n, size,
    size, C) float32 u8-quantised windows, bilinear in float32."""
    h, w, c = image.shape
    boxes = boxes.float()
    sy = _sample_axis(boxes[:, 1], boxes[:, 3], size, h)
    sx = _sample_axis(boxes[:, 0], boxes[:, 2], size, w)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy, fx = (sy - y0)[:, :, None, None], (sx - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)

    def px(yi, xi):
        return image[yi[:, :, None], xi[:, None, :]]  # (n, size, size, C)

    top = (1 - fx) * px(y0, x0) + fx * px(y0, x1)
    bottom = (1 - fx) * px(y1, x0) + fx * px(y1, x1)
    return quantize_u8((1 - fy) * top + fy * bottom)


def crop_resize_chunked(image: torch.Tensor, boxes: torch.Tensor, size: int,
                        chunk: int = 16384):
    """:func:`crop_resize` in chunks of ``chunk`` boxes (a generator; one
    empty chunk for no boxes)."""
    for s in range(0, max(boxes.shape[0], 1), chunk):
        yield crop_resize(image, boxes[s:s + chunk], size)
