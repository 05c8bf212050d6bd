"""Pyramid resize, dense window extraction and window re-extraction
(counterpart of ops/windows.py), batched over frames.

  * :func:`extract_windows` -- stage 0 in gather mode: per pyramid level an
    antialiased bilinear resize, u8 quantization, and a double index gather
    of the window grid, in plan order (scale-major, then x, then y).
  * :func:`crop_and_resize_impl` -- stage 1/2 re-extraction of survivor
    boxes straight from the full-resolution frame. The default path is
    kernel K1 (ops/windows_cuda.py) on a CUDA tensor and its plain version
    :func:`crop_and_resize_plain` on a CPU tensor; ``high_precision`` is an
    f32 gather without the bf16 rounding points (the JAX XLA path, which
    never reaches Pallas).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .pyramid import PyramidPlan

LevelIndex = Tuple[int, int, torch.Tensor, torch.Tensor]


def resize_image(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of (B, C, H, W) float32 planes.

    Stands in for ``jax.image.resize(method="bilinear", antialias=True)``:
    the two differ by at most a few 1e-4 before u8 quantization, so a rare
    pixel lands on the other side of a rounding tie.
    """
    if images.shape[2] == out_h and images.shape[3] == out_w:
        return images
    return F.interpolate(
        images, size=(out_h, out_w), mode="bilinear", align_corners=False,
        antialias=True,
    )


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even onto the uint8 lattice, staying float32."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def level_indices(plan: PyramidPlan, device) -> List[LevelIndex]:
    """Per level: (scaled_h, scaled_w, row index (ny, wh), column index
    (nx, ww)) on ``device``. Built once per plan and reused, so detecting
    copies no index table to the card. Indices clamp at the level's edge,
    as an XLA gather clamps out-of-range reads."""
    out = []
    for s in plan.scales:
        ys = np.asarray(s.ys, np.int64)[:, None] + np.arange(plan.window_h)
        xs = np.asarray(s.xs, np.int64)[:, None] + np.arange(plan.window_w)
        out.append(
            (
                s.scaled_h,
                s.scaled_w,
                torch.as_tensor(np.minimum(ys, s.scaled_h - 1), device=device),
                torch.as_tensor(np.minimum(xs, s.scaled_w - 1), device=device),
            )
        )
    return out


def extract_windows(
    images: torch.Tensor,
    plan: PyramidPlan,
    indices: Optional[List[LevelIndex]] = None,
) -> torch.Tensor:
    """Every sliding window of the plan from (B, H, W, C) frames.

    Returns (B, plan.n_windows, window_h, window_w, C) float32 in plan
    order. Levels below scale 1 are quantized to u8 after the resize; the
    scale-1 level keeps the frame's own (possibly fractional) values.
    """
    if images.shape[1] != plan.img_h or images.shape[2] != plan.img_w:
        raise ValueError(
            "image shape {} does not match plan ({}, {})".format(
                tuple(images.shape), plan.img_h, plan.img_w
            )
        )
    if indices is None:
        indices = level_indices(plan, images.device)
    b, c = images.shape[0], images.shape[3]
    planes = images.float().permute(0, 3, 1, 2)  # (B, C, H, W)
    parts = []
    for s, (sh, sw, ys_idx, xs_idx) in zip(plan.scales, indices):
        scaled = resize_image(planes, sh, sw)
        if s.scale != 1.0:
            scaled = _quantize_u8(scaled)
        rows = scaled[:, :, ys_idx]  # (B, C, ny, wh, sw)
        wins = rows[..., xs_idx]  # (B, C, ny, wh, nx, ww)
        wins = wins.permute(0, 4, 2, 3, 5, 1)  # (B, nx, ny, wh, ww, C)
        parts.append(wins.reshape(b, -1, plan.window_h, plan.window_w, c))
    return torch.cat(parts, dim=1)


def sample_positions(
    boxes: torch.Tensor, h: int, w: int, out_h: int, out_w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling rows/columns of each box: ``boxes`` (..., 4) float32 xyxy
    with exclusive max -> sy (..., out_h), sx (..., out_w).

    cv2.resize half-pixel sampling on the crop, clamped inside the crop
    (replicate border), then shifted to image coordinates: the expressions
    of ``_crop_and_resize_core``/``crop_and_resize_pallas``, rounded as the
    jitted JAX program rounds them. XLA rewrites ``box / out`` into
    ``box * f32(1 / out)`` and contracts ``o * step - 0.5`` into one fused
    multiply-add; the multiply-add is evaluated here in float64, where the
    product of two f32 values is exact, so the one rounding to f32 equals
    the FMA's (negative results, the only inexact case, are clamped to 0).
    """
    boxes = boxes.float()
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    box_w = (xmax - xmin)[..., None]
    box_h = (ymax - ymin)[..., None]

    def local(box_len: torch.Tensor, out_len: int) -> torch.Tensor:
        step = box_len * torch.tensor(1.0 / out_len, dtype=torch.float32)
        o = torch.arange(out_len, dtype=torch.float64, device=boxes.device) + 0.5
        return (o * step.double() - 0.5).float()

    local_y = local(box_h, out_h)
    local_x = local(box_w, out_w)
    local_y = torch.minimum(
        torch.clamp(local_y, min=0.0), torch.clamp(box_h - 1.0, min=0.0)
    )
    local_x = torch.minimum(
        torch.clamp(local_x, min=0.0), torch.clamp(box_w - 1.0, min=0.0)
    )
    sy = torch.clamp(local_y + ymin[..., None], 0.0, h - 1.0)
    sx = torch.clamp(local_x + xmin[..., None], 0.0, w - 1.0)
    return sy, sx


def _two_tap(s: torch.Tensor, size: int):
    """Two-tap bilinear support: (i0, i1, w0, w1), i1 = min(i0 + 1, size - 1)."""
    s0 = torch.floor(s)
    frac = s - s0
    i0 = s0.long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    return i0, i1, 1.0 - frac, frac


def resample_plain(
    planes: torch.Tensor,
    sy: torch.Tensor,
    sx: torch.Tensor,
    quantize: bool = True,
    bf16_rounding: bool = True,
) -> torch.Tensor:
    """Plain version of kernel K1 at its interface.

    ``planes`` (B, C, H, W), ``sy`` (B, N, out_h), ``sx`` (B, N, out_w) ->
    (B, N, out_h, out_w, C) float32.

    With ``bf16_rounding`` (the default path, ``planes`` in bf16) this is
    ``_crop_and_resize_core`` with high precision off, as a two-tap gather
    with the same rounding points: taps rounded to bf16; vertical pass
    bf16 x bf16 products (exact in f32) summed in f32, then rounded to
    bf16; horizontal pass the same in f32; round half to even and clip.
    Without it, everything stays float32 (the high-precision path).
    """
    b, c, h, w = planes.shape
    n, out_h, out_w = sy.shape[1], sy.shape[2], sx.shape[2]
    y0, y1, wy0, wy1 = _two_tap(sy, h)
    x0, x1, wx0, wx1 = _two_tap(sx, w)
    if bf16_rounding:
        wy0, wy1, wx0, wx1 = (t.to(torch.bfloat16).float() for t in (wy0, wy1, wx0, wx1))
    flat = planes.float().permute(0, 2, 3, 1).reshape(b, h * w, c)
    bidx = torch.arange(b, device=planes.device)[:, None, None, None]

    def pixels(yi, xi):  # (B, N, out_h, out_w, C)
        idx = yi[:, :, :, None] * w + xi[:, :, None, :]
        return flat[bidx, idx]

    def vertical(xi):
        v = wy0[..., None, None] * pixels(y0, xi) + wy1[..., None, None] * pixels(y1, xi)
        return v.to(torch.bfloat16).float() if bf16_rounding else v

    out = wx0[:, :, None, :, None] * vertical(x0) + wx1[:, :, None, :, None] * vertical(x1)
    if quantize:
        out = _quantize_u8(out)
    return out.reshape(b, n, out_h, out_w, c)


def to_planes_bf16(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float32 frames -> contiguous (B, C, H, W) bf16 planes,
    rounded to nearest even: the image K1 samples (windows_pallas.py:175-177)."""
    return images.float().permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()


def crop_and_resize_plain(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_h: int,
    out_w: int,
    quantize: bool = True,
    high_precision: bool = False,
) -> torch.Tensor:
    """Batched crop + bilinear resize: ``images`` (B, H, W, C), ``boxes``
    (B, N, 4) xyxy (exclusive max) -> (B, N, out_h, out_w, C) float32."""
    h, w = images.shape[1], images.shape[2]
    sy, sx = sample_positions(boxes, h, w, out_h, out_w)
    if high_precision:
        planes = images.float().permute(0, 3, 1, 2)
        return resample_plain(planes, sy, sx, quantize, bf16_rounding=False)
    return resample_plain(to_planes_bf16(images), sy, sx, quantize)


def crop_and_resize_impl(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_h: int,
    out_w: int,
    high_precision: bool,
) -> torch.Tensor:
    """Re-extraction of u8-quantized windows: high precision -> the f32
    gather (any device); otherwise K1's wrapper, which launches the kernel
    for a CUDA tensor and runs the plain version for a CPU tensor."""
    if high_precision:
        return crop_and_resize_plain(images, boxes, out_h, out_w, high_precision=True)
    from . import windows_cuda

    return windows_cuda.crop_and_resize(images, boxes, out_h, out_w)
