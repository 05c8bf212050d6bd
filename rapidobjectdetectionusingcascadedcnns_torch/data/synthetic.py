"""Deterministic synthetic face-detection data.

The port's copy of the JAX package's ``data/synthetic.py``: the scene
generator (``make_scene``) and the patch corpora the trainers learn from
(``make_patch_dataset``, ``make_multiresolution_patch_dataset``, and the
scene-sampled ``make_scene_patch_dataset``,
``make_multiresolution_scene_patch_dataset``). Same seeds, same pixels:
skin-toned ellipses with darker eye/mouth blobs pasted on a low-frequency
textured canvas, with ground-truth boxes, so training and detection run
hermetically and reproducibly. ``write_label_folder_corpus`` (the port's
own) writes such faces and backgrounds as an image corpus on disk, for the
disk dataset provider and the train apps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

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


def draw_background(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One synthetic non-face patch (size, size, 3) uint8."""
    kind = rng.randint(0, 3)
    img = _smooth_noise(rng, size, size, cells=rng.randint(2, 7))
    if kind == 1:  # add a rectangle (non-face structure)
        y0, x0 = rng.randint(0, size // 2, size=2)
        y1 = y0 + rng.randint(size // 4, size // 2)
        x1 = x0 + rng.randint(size // 4, size // 2)
        img[y0:y1, x0:x1] = rng.uniform(0, 255, size=3)
    elif kind == 2:  # add diagonal stripes
        yy, xx = np.mgrid[0:size, 0:size]
        stripes = ((yy + xx) // max(2, size // 6)) % 2 == 0
        img[stripes] = img[stripes] * 0.5
    return np.clip(img, 0, 255).astype(np.uint8)


def make_patch_dataset(
    n_pos: int, n_neg: int, size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary patch corpus: returns (images uint8 (N, size, size, 3), labels
    int32 (N,)). Ordering is positives-then-negatives; callers shuffle with
    :func:`.dataset.deterministic_shuffle`."""
    rng = np.random.RandomState(seed)
    images = np.empty((n_pos + n_neg, size, size, 3), dtype=np.uint8)
    for i in range(n_pos):
        images[i] = draw_face(rng, size)
    for i in range(n_neg):
        images[n_pos + i] = draw_background(rng, size)
    labels = np.concatenate(
        [np.ones(n_pos, np.int32), np.zeros(n_neg, np.int32)]
    )
    return images, labels


def aligned_views(images_top: np.ndarray, sizes: List[int]) -> dict:
    """``{size: images}`` for every size in ``sizes``: ``images_top`` (N, top,
    top, 3) uint8 at the largest size, the others by an aligned block mean,
    so sample i shows the same pixels at every resolution."""
    top = max(sizes)
    out = {top: images_top}
    for size in sizes:
        if size == top:
            continue
        factor = top // size
        if top % size != 0:
            raise ValueError("sizes must divide the maximum size")
        ds = images_top.reshape(
            len(images_top), size, factor, size, factor, 3
        ).mean(axis=(2, 4))
        out[size] = np.clip(np.round(ds), 0, 255).astype(np.uint8)
    return out


def make_multiresolution_patch_dataset(
    n_pos: int, n_neg: int, sizes: List[int], seed: int = 0
) -> dict:
    """The same samples rendered at several resolutions (cascade stages need
    pixel-aligned datasets across resolutions, app/train_cascade_app.py:244-263).

    Renders at max(sizes) once and area-downsamples, so sample i is the same
    underlying scene at every resolution.
    """
    images_top, labels = make_patch_dataset(n_pos, n_neg, max(sizes), seed)
    return {"images": aligned_views(images_top, sizes), "labels": labels}


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


def make_scene_patch_dataset(
    n_pos: int, n_neg: int, size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Patch corpus sampled from full SCENES via the offline-sampling flow
    (the synthetic analog of the reference's run_sampling.py over
    AFLW/ImageNet): positives are ground-truth face crops, negatives are
    rejection-sampled background patches clear of any face (IoU <= 0.05,
    at least 24 px, eight a scene, stopping at a scene's first deadlock).

    Scene-sampled patches match the distribution pyramid windows see at
    inference (canvas textures, varied crop scales), which is what makes a
    stage-0 net reject background windows: plain :func:`make_patch_dataset`
    textures are too unlike scene windows.
    """
    from ..ops import sampling as sampling_ops
    from .image_io import resize_rgb

    rng = np.random.RandomState(seed)
    pos: List[np.ndarray] = []
    neg: List[np.ndarray] = []
    scene_seed = seed * 100003 + 17
    while len(pos) < n_pos or len(neg) < n_neg:
        scene = make_scene(240, 320, n_faces=3, seed=scene_seed, min_face=40, max_face=140)
        scene_seed += 1
        if len(pos) < n_pos:
            for box in scene.boxes:
                x0, y0, x1, y1 = [int(v) for v in box]
                pos.append(resize_rgb(scene.image[y0:y1, x0:x1], size, size))
        if len(neg) < n_neg:
            restricted = scene.boxes.astype(np.float64)
            for _ in range(8):
                try:
                    patch, _ = sampling_ops.random_img_patch(
                        scene.image, restricted, 0.05, 24, rng
                    )
                except (sampling_ops.PotentialDeadlockError, ValueError):
                    break
                neg.append(resize_rgb(patch, size, size))
    images = np.stack(pos[:n_pos] + neg[:n_neg])
    labels = np.concatenate([np.ones(n_pos, np.int32), np.zeros(n_neg, np.int32)])
    return images, labels


def make_multiresolution_scene_patch_dataset(
    n_pos: int, n_neg: int, sizes: List[int], seed: int = 0
) -> dict:
    """Scene-sampled patches rendered at aligned cascade resolutions
    (pixel-aligned across sizes like
    :func:`make_multiresolution_patch_dataset`)."""
    images_top, labels = make_scene_patch_dataset(n_pos, n_neg, max(sizes), seed)
    return {"images": aligned_views(images_top, sizes), "labels": labels}


def write_label_folder_corpus(
    root: str,
    dataset_key: str,
    n_pos: int,
    n_neg: int,
    seed: int = 0,
    face_size: Tuple[int, int] = (40, 80),
    background_size: int = 64,
) -> Tuple[List[str], List[str]]:
    """A label-folder image corpus on disk, as ``data/file_list.py`` walks
    it: ``<root>/<dataset_key>/foreground/*.png`` holds the face crops of
    ``n_pos`` one-face scenes (``make_scene`` at seeds ``seed + i``, cut at
    their ground-truth boxes), ``<root>/<dataset_key>/background/*.png``
    ``n_neg`` ``draw_background`` patches of ``background_size`` pixels from
    one ``RandomState(seed)``. Returns the two lists of paths."""
    import os

    from PIL import Image

    fg_dir = os.path.join(root, dataset_key, "foreground")
    bg_dir = os.path.join(root, dataset_key, "background")
    os.makedirs(fg_dir, exist_ok=True)
    os.makedirs(bg_dir, exist_ok=True)
    lo, hi = face_size
    side = hi + 16
    fg, bg = [], []
    for i in range(n_pos):
        scene = make_scene(side, side, 1, seed=seed + i, min_face=lo, max_face=hi)
        x0, y0, x1, y1 = scene.boxes[0]
        path = os.path.join(fg_dir, "face_{:05d}.png".format(i))
        Image.fromarray(scene.image[y0:y1, x0:x1]).save(path)
        fg.append(path)
    rng = np.random.RandomState(seed)
    for i in range(n_neg):
        path = os.path.join(bg_dir, "bg_{:05d}.png".format(i))
        Image.fromarray(draw_background(rng, background_size)).save(path)
        bg.append(path)
    return fg, bg
