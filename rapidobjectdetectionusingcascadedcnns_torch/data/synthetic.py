"""Deterministic synthetic face-detection data.

The port's copy of the scene generator of the JAX package's
``data/synthetic.py`` (``make_scene`` and what it draws with; the training
corpora are not ported yet). Same seeds, same pixels: skin-toned ellipses
with darker eye/mouth blobs pasted on a low-frequency textured canvas, with
ground-truth boxes, so detection runs hermetically and reproducibly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _smooth_noise(rng: np.random.RandomState, h: int, w: int, cells: int = 4) -> np.ndarray:
    """Low-frequency RGB texture in [0, 255] via bilinear-upsampled noise."""
    grid = rng.uniform(40, 215, size=(cells + 1, cells + 1, 3))
    ys = np.linspace(0, cells, h)
    xs = np.linspace(0, cells, w)
    y0 = np.clip(ys.astype(int), 0, cells - 1)
    x0 = np.clip(xs.astype(int), 0, cells - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    g00 = grid[y0][:, x0]
    g01 = grid[y0][:, x0 + 1]
    g10 = grid[y0 + 1][:, x0]
    g11 = grid[y0 + 1][:, x0 + 1]
    return (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
            + g10 * fy * (1 - fx) + g11 * fy * fx)


def draw_face(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One synthetic face patch (size, size, 3) uint8."""
    img = _smooth_noise(rng, size, size)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy, cx = size / 2 + rng.uniform(-0.05, 0.05) * size, size / 2 + rng.uniform(
        -0.05, 0.05
    ) * size
    ry, rx = size * rng.uniform(0.38, 0.46), size * rng.uniform(0.30, 0.38)
    face = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0

    skin = np.array(
        [
            rng.uniform(180, 235),
            rng.uniform(130, 185),
            rng.uniform(100, 155),
        ]
    )
    img[face] = skin + rng.uniform(-12, 12, size=3)

    # eyes: two dark blobs in the upper half
    eye_r = size * rng.uniform(0.05, 0.08)
    for side in (-1, 1):
        ey = cy - 0.18 * size + rng.uniform(-0.02, 0.02) * size
        ex = cx + side * (0.16 * size) + rng.uniform(-0.02, 0.02) * size
        eye = (yy - ey) ** 2 + (xx - ex) ** 2 <= eye_r**2
        img[eye] = rng.uniform(10, 60)

    # mouth: dark horizontal bar in the lower half
    my = cy + 0.22 * size
    mw = size * rng.uniform(0.14, 0.20)
    mh = size * rng.uniform(0.03, 0.05)
    mouth = (np.abs(yy - my) <= mh) & (np.abs(xx - cx) <= mw)
    img[mouth] = np.array([rng.uniform(90, 140), rng.uniform(30, 60), rng.uniform(30, 60)])

    return np.clip(img, 0, 255).astype(np.uint8)


@dataclass
class Scene:
    image: np.ndarray  # (H, W, 3) uint8
    boxes: np.ndarray  # (n_faces, 4) int32 xyxy ground truth


def make_scene(
    height: int,
    width: int,
    n_faces: int,
    seed: int = 0,
    min_face: int = 40,
    max_face: int = 120,
) -> Scene:
    """A full detection scene with ``n_faces`` synthetic faces pasted on a
    textured canvas; ground-truth boxes returned in xyxy."""
    rng = np.random.RandomState(seed)
    canvas = np.clip(_smooth_noise(rng, height, width, cells=8), 0, 255).astype(
        np.uint8
    )
    boxes = []
    max_face = min(max_face, height - 2, width - 2)
    for _ in range(n_faces):
        for _attempt in range(50):
            fsize = rng.randint(min_face, max_face + 1)
            y0 = rng.randint(0, height - fsize)
            x0 = rng.randint(0, width - fsize)
            new_box = np.array([x0, y0, x0 + fsize, y0 + fsize])
            overlap = any(
                not (
                    new_box[2] <= b[0]
                    or b[2] <= new_box[0]
                    or new_box[3] <= b[1]
                    or b[3] <= new_box[1]
                )
                for b in boxes
            )
            if not overlap:
                canvas[y0 : y0 + fsize, x0 : x0 + fsize] = draw_face(rng, fsize)
                boxes.append(new_box)
                break
    return Scene(
        image=canvas,
        boxes=np.asarray(boxes, dtype=np.int32).reshape(-1, 4),
    )
