"""The traffic's frames: synthetic scenes drawn from a seed (a frozen copy
of the detector's synthetic scene generator, so that a change to the
program cannot move the yardstick), and the BT.601 YUV420 encoder.

A scene is a low-frequency textured canvas with skin-toned elliptical
faces (dark eyes and mouth) pasted where they do not overlap.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth_noise(rng: np.random.RandomState, h: int, w: int, cells: int = 4) -> np.ndarray:
    grid = rng.uniform(40, 215, size=(cells + 1, cells + 1, 3))
    ys = np.linspace(0, cells, h)
    xs = np.linspace(0, cells, w)
    y0 = np.clip(ys.astype(int), 0, cells - 1)
    x0 = np.clip(xs.astype(int), 0, cells - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    return (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fy * fx)


def _face(rng: np.random.RandomState, size: int) -> np.ndarray:
    img = _smooth_noise(rng, size, size)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy = size / 2 + rng.uniform(-0.05, 0.05) * size
    cx = size / 2 + rng.uniform(-0.05, 0.05) * size
    ry, rx = size * rng.uniform(0.38, 0.46), size * rng.uniform(0.30, 0.38)
    face = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    skin = np.array([rng.uniform(180, 235), rng.uniform(130, 185), rng.uniform(100, 155)])
    img[face] = skin + rng.uniform(-12, 12, size=3)
    eye_r = size * rng.uniform(0.05, 0.08)
    for side in (-1, 1):
        ey = cy - 0.18 * size + rng.uniform(-0.02, 0.02) * size
        ex = cx + side * (0.16 * size) + rng.uniform(-0.02, 0.02) * size
        img[(yy - ey) ** 2 + (xx - ex) ** 2 <= eye_r ** 2] = rng.uniform(10, 60)
    my = cy + 0.22 * size
    mw = size * rng.uniform(0.14, 0.20)
    mh = size * rng.uniform(0.03, 0.05)
    mouth = (np.abs(yy - my) <= mh) & (np.abs(xx - cx) <= mw)
    img[mouth] = np.array([rng.uniform(90, 140), rng.uniform(30, 60), rng.uniform(30, 60)])
    return np.clip(img, 0, 255).astype(np.uint8)


def make_scene(height: int, width: int, n_faces: int, seed: int, min_face: int,
               max_face: int) -> np.ndarray:
    """(height, width, 3) uint8 scene of ``seed`` (below 2**32)."""
    rng = np.random.RandomState(seed)
    canvas = np.clip(_smooth_noise(rng, height, width, cells=8), 0, 255).astype(np.uint8)
    boxes = []
    max_face = min(max_face, height - 2, width - 2)
    for _ in range(n_faces):
        for _attempt in range(50):
            size = rng.randint(min_face, max_face + 1)
            y0 = rng.randint(0, height - size)
            x0 = rng.randint(0, width - size)
            new = (x0, y0, x0 + size, y0 + size)
            if all(new[2] <= b[0] or b[2] <= new[0] or new[3] <= b[1] or b[3] <= new[1]
                   for b in boxes):
                canvas[y0:y0 + size, x0:x0 + size] = _face(rng, size)
                boxes.append(new)
                break
    return canvas


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (Y (H, W), UV (H/2, W/2, 2)) uint8, BT.601 full
    range, chroma as 2 x 2 means."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h, w = y.shape
    uv = np.stack([u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)),
                   v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))], axis=-1)
    return (np.clip(np.round(y), 0, 255).astype(np.uint8),
            np.clip(np.round(uv), 0, 255).astype(np.uint8))
