"""Online data augmentation as batched tensor ops on the training device
(counterpart of ops/augment.py of the JAX package).

The reference appends TF graph ops to the training input
(data/data_augmentation_online.py): color distortion chains in one of four
orderings with a [-1, 1] <-> [0, 1] range shimmy, then per-sample affine
transforms (horizontal/vertical flip with a foreground exemption,
continuous or 90-degree rotation with per-class angles, random crop)
composed into one transform.

Randomness is split from application. :func:`draw_color` and
:func:`draw_affine` draw every random value from an explicit
``torch.Generator`` (the trainer's host generator: the draws are a few
scalars and a few values per sample, moved to the batch's device);
:func:`color_distort_planar`, :func:`affine_transforms` and
:func:`augment_batch` apply given draws and are deterministic. So a test
can hand both packages the same drawn values. The two packages' generators
differ, so the same seed does not give the same draws.

The arithmetic follows the JAX functions: the planar (3, ..., P) color
math, and the affine warp as two-tap triangle weights contracted with a
batched matrix product in float32 (``_affine_warp_batch``), which fills
samples outside the image with zeros and is a bit-exact no-op for identity
transforms. The reference's crop transform swaps its left/top offsets; like
the JAX package, left goes to x and top to y (the same distribution).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation settings (mirrors the dao_* config keys)."""

    horizontal_flip: bool = True
    vertical_flip: bool = False
    allow_vertical_flip_foreground: bool = False
    rotation_mode: str = "DAO_ROTATION_MODE_CONTINUOUS"
    max_rotation_angle: float = 0.0  # degrees
    max_foreground_rotation_angle: Optional[float] = 0.0
    crop_probability: float = 0.5
    crop_min_percent: float = 0.9
    crop_max_percent: float = 1.0
    color_distortion: bool = True
    color_fast_mode: bool = False

    @classmethod
    def from_config(cls) -> "AugmentConfig":
        from .. import config as cf

        return cls(
            horizontal_flip=cf.get("dao_horizontal_flip"),
            vertical_flip=cf.get("dao_vertical_flip"),
            allow_vertical_flip_foreground=cf.get(
                "dao_allow_vertical_flipping_of_foreground"
            ),
            rotation_mode=cf.get("dao_rotation_mode"),
            max_rotation_angle=cf.get("dao_max_rotation_angle"),
            max_foreground_rotation_angle=cf.get("dao_max_foreground_rotation_angle"),
            crop_probability=cf.get("dao_crop_probability"),
            crop_min_percent=cf.get("dao_crop_min_percent"),
            color_distortion=cf.get("dao_color_distortion"),
            color_fast_mode=cf.get("dao_color_distortion_fast_mode"),
        )


# ---------------------------------------------------------------------------
# random draws


def _uniform(generator: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return lo + u * (hi - lo)


@dataclass
class ColorDraws:
    """One batch's color distortion: the ordering and the four factors."""

    branch: int  # index into the orderings (2 in fast mode, else 4)
    brightness_delta: float  # in [-32/255, 32/255)
    saturation_factor: float  # in [0.5, 1.5)
    hue_delta: float  # in [-0.2, 0.2)
    contrast_factor: float  # in [0.5, 1.5)


def draw_color(generator: torch.Generator, fast_mode: bool) -> ColorDraws:
    """Draw one batch's color distortion (data_augmentation_online.py:230-284)."""
    n_branches = 2 if fast_mode else 4
    branch = int(torch.randint(0, n_branches, (), generator=generator))
    v = _uniform(generator, (4,))
    max_b = 32.0 / 255.0
    return ColorDraws(
        branch=branch,
        brightness_delta=float(-max_b + v[0] * (2 * max_b)),
        saturation_factor=float(0.5 + v[1]),
        hue_delta=float(-0.2 + v[2] * 0.4),
        contrast_factor=float(0.5 + v[3]),
    )


@dataclass
class AffineDraws:
    """Per-sample random values of the affine pipeline, each (N,)."""

    hflip: Tensor  # bool: flip horizontally
    vflip: Tensor  # bool: flip vertically (foreground exempt unless allowed)
    quarter_turns: Tensor  # int64 in [0, 4): 90-degree rotation mode
    angles: Tensor  # f32 radians: continuous rotation, background
    fg_angles: Tensor  # f32 radians: continuous rotation, foreground
    crop_pct: Tensor  # f32 in [crop_min_percent, crop_max_percent)
    crop_left: Tensor  # f32 uniform [0, 1): left offset as a share of the slack
    crop_top: Tensor  # f32 uniform [0, 1)
    crop: Tensor  # bool: apply the crop

    def to(self, device) -> "AffineDraws":
        return AffineDraws(**{k: v.to(device) for k, v in vars(self).items()})


def draw_affine(generator: torch.Generator, n: int, acfg: AugmentConfig) -> AffineDraws:
    """Draw the per-sample values of :func:`affine_transforms` for a batch
    of ``n`` (data_augmentation_online.py:100-197)."""
    base = acfg.max_rotation_angle / 180.0 * math.pi
    fg_max = (acfg.max_foreground_rotation_angle or 0.0) / 180.0 * math.pi
    return AffineDraws(
        hflip=_uniform(generator, (n,)) < 0.5,
        vflip=_uniform(generator, (n,)) < 0.5,
        quarter_turns=torch.randint(0, 4, (n,), generator=generator),
        angles=_uniform(generator, (n,), -base, base),
        fg_angles=_uniform(generator, (n,), -fg_max, fg_max),
        crop_pct=_uniform(generator, (n,), acfg.crop_min_percent, acfg.crop_max_percent),
        crop_left=_uniform(generator, (n,)),
        crop_top=_uniform(generator, (n,)),
        crop=_uniform(generator, (n,)) < acfg.crop_probability,
    )


# ---------------------------------------------------------------------------
# color ops on a channel-planar (3, ..., P) stack in [0, 1]


def _brightness(S: Tensor, delta: float) -> Tensor:
    return S + delta


def _saturation(S: Tensor, factor: float) -> Tensor:
    gray = 0.299 * S[0] + 0.587 * S[1] + 0.114 * S[2]
    return gray[None] + factor * (S - gray[None])


def _contrast(S: Tensor, factor: float) -> Tensor:
    mean = S.mean(dim=-1, keepdim=True)  # per-channel spatial mean
    return (S - mean) * factor + mean


def _rgb_to_hsv(r: Tensor, g: Tensor, b: Tensor):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return h, s, v


def _select(i: Tensor, choices):
    out = choices[5]
    for k in (4, 3, 2, 1, 0):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return r, g, b


def _hue(S: Tensor, delta: float) -> Tensor:
    Sc = torch.clamp(S, 0.0, 1.0)
    h, s, v = _rgb_to_hsv(Sc[0], Sc[1], Sc[2])
    h = torch.remainder(h + delta, 1.0)
    return torch.stack(_hsv_to_rgb(h, s, v))


def color_distort_planar(S: Tensor, draws: ColorDraws, fast_mode: bool) -> Tensor:
    """Apply one of the reference's distortion orderings
    (data_augmentation_online.py:230-284) to ``S``, a (3, ..., P) planar
    stack in [0, 1]; clipped to [0, 1]."""
    b = lambda x: _brightness(x, draws.brightness_delta)  # noqa: E731
    s = lambda x: _saturation(x, draws.saturation_factor)  # noqa: E731
    h = lambda x: _hue(x, draws.hue_delta)  # noqa: E731
    c = lambda x: _contrast(x, draws.contrast_factor)  # noqa: E731
    if fast_mode:
        orders = [(b, s), (s, b)]
    else:
        orders = [(b, s, h, c), (s, b, c, h), (c, h, b, s), (h, s, c, b)]
    for op in orders[draws.branch]:
        S = op(S)
    return torch.clamp(S, 0.0, 1.0)


# ---------------------------------------------------------------------------
# affine warp


# Bytes of images a dense warp takes at once: an image's tap matrices and
# products are 4 * H * W * (H + W + 2 * W * C) bytes, 3.5 MB at 48 px (a
# batch of 1,200 in one call) but 855 MB at the Inception stage's 299 px,
# where a batch is cut into chunks of 10 images.
WARP_CHUNK_BYTES = 8 << 30


def _affine_warp_batch(images: Tensor, mats: Tensor) -> Tensor:
    """Batched inverse-warp bilinear sampling in float32.

    ``images`` (N, H, W, C) f32; ``mats`` (N, 3, 3) map OUTPUT pixel
    coordinates (x, y, 1) to INPUT coordinates. Samples outside the input
    are 0. Two-tap triangle weights: the vertical pass is one batched
    matrix product over all channels, the horizontal pass a multiply-reduce.
    Images are independent, so a batch over ``WARP_CHUNK_BYTES`` is warped
    in chunks.
    """
    n, h, w, c = images.shape
    step = max(1, WARP_CHUNK_BYTES // (4 * h * w * (h + w + 2 * w * c)))
    if n > step:
        return torch.cat([_affine_warp_batch(images[s : s + step], mats[s : s + step])
                          for s in range(0, n, step)])
    dev = images.device
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    out_coords = torch.stack([xs, ys, torch.ones_like(xs)]).float().reshape(3, -1)
    in_coords = torch.matmul(mats, out_coords)  # (N, 3, H*W)
    denom = torch.clamp(in_coords[:, 2], min=1e-12)
    sx = in_coords[:, 0] / denom  # (N, H*W)
    sy = in_coords[:, 1] / denom
    hi = torch.arange(h, dtype=torch.float32, device=dev)
    wi = torch.arange(w, dtype=torch.float32, device=dev)
    ry = torch.clamp(1.0 - torch.abs(sy[:, :, None] - hi), min=0.0)  # (N, H*W, H)
    rx = torch.clamp(1.0 - torch.abs(sx[:, :, None] - wi), min=0.0)  # (N, H*W, W)
    g = torch.bmm(ry, images.reshape(n, h, w * c)).reshape(n, h * w, w, c)
    out = (g * rx[..., None]).sum(dim=2)  # (N, H*W, C)
    return out.reshape(n, h, w, c)


def affine_transforms(
    draws: AffineDraws, labels: Tensor, height: int, width: int, acfg: AugmentConfig
) -> Tensor:
    """Compose per-sample flip/rotate/crop matrices (output -> input
    coordinates) from ``draws``, with the reference's foreground
    exemptions: no vertical flip for foreground unless allowed, a separate
    foreground rotation angle, no 90-degree rotation of foreground.
    Returns (N, 3, 3) f32 on ``labels``' device."""
    dev = labels.device
    n = labels.shape[0]
    is_fg = labels.to(torch.bool)
    mats = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)

    def where(coin, a, b):
        return torch.where(coin[:, None, None], a, b)

    def mat(rows):
        return torch.tensor(rows, dtype=torch.float32, device=dev)

    if acfg.horizontal_flip:
        flip = mat([[-1.0, 0.0, width], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        mats = where(draws.hflip, torch.matmul(mats, flip), mats)

    if acfg.vertical_flip:
        coin = draws.vflip
        if not acfg.allow_vertical_flip_foreground:
            coin = coin & ~is_fg
        flip = mat([[1.0, 0.0, 0.0], [0.0, -1.0, height], [0.0, 0.0, 1.0]])
        mats = where(coin, torch.matmul(mats, flip), mats)

    rotation_90 = acfg.rotation_mode == "DAO_ROTATION_MODE_90"
    rotation_cont = (
        acfg.rotation_mode == "DAO_ROTATION_MODE_CONTINUOUS" and acfg.max_rotation_angle > 0
    )
    if rotation_90 or rotation_cont:
        if rotation_90:
            k = torch.where(is_fg, torch.zeros_like(draws.quarter_turns), draws.quarter_turns)
            angles = k.to(torch.float32) * (math.pi / 2.0)
        else:
            angles = draws.angles
            if acfg.max_foreground_rotation_angle is not None:
                angles = torch.where(is_fg, draws.fg_angles, angles)
        cos, sin = torch.cos(angles), torch.sin(angles)
        cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
        zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
        rot = torch.stack(
            [
                torch.stack([cos, -sin, cx - cx * cos + cy * sin], dim=-1),
                torch.stack([sin, cos, cy - cx * sin - cy * cos], dim=-1),
                torch.stack([zeros, zeros, ones], dim=-1),
            ],
            dim=1,
        )
        mats = torch.matmul(mats, rot)

    if acfg.crop_probability > 0:
        pct = draws.crop_pct
        left = draws.crop_left * width * (1.0 - pct)
        top = draws.crop_top * height * (1.0 - pct)
        zeros, ones = torch.zeros_like(pct), torch.ones_like(pct)
        crop = torch.stack(
            [
                torch.stack([pct, zeros, left], dim=-1),
                torch.stack([zeros, pct, top], dim=-1),
                torch.stack([zeros, zeros, ones], dim=-1),
            ],
            dim=1,
        )
        mats = where(draws.crop, torch.matmul(mats, crop), mats)

    return mats.contiguous()


def augment_batch(
    images: Tensor,
    labels: Tensor,
    acfg: AugmentConfig,
    color: ColorDraws,
    affine: AffineDraws,
) -> Tensor:
    """Full online augmentation of one standardized (N, H, W, C) f32 batch
    (values about [-1, 1]) with given draws: color first, with the
    reference's range shimmy (data_augmentation_online.py:26-43), then the
    composed affine warp."""
    n, h, w, c = images.shape
    out = images
    if acfg.color_distortion:
        S = out.reshape(n, h * w, c).permute(2, 0, 1)  # (C, N, H*W)
        S = (S + 1.0) / 2.0
        S = color_distort_planar(S, color, acfg.color_fast_mode)
        S = (S - 0.5) * 2.0
        out = S.permute(1, 2, 0).reshape(n, h, w, c)
    mats = affine_transforms(affine.to(images.device), labels, h, w, acfg)
    return _affine_warp_batch(out, mats)


def draw_and_augment(
    generator: torch.Generator, images: Tensor, labels: Tensor, acfg: AugmentConfig
) -> Tensor:
    """Draw one batch's augmentation from ``generator`` and apply it."""
    color = draw_color(generator, acfg.color_fast_mode)
    affine = draw_affine(generator, images.shape[0], acfg)
    return augment_batch(images, labels, acfg, color, affine)
