"""YUV420 <-> RGB conversion (counterpart of ops/color.py).

BT.601 full range, chroma upsampled bilinearly. ``yuv420_to_rgb`` is the
device decoder, batched over frames; it returns clipped float32, not u8:
the unrounded values feed the pyramid and K1's bf16 cast, as in the JAX
program. ``rgb_to_yuv420`` is the numpy host encoder used by tests and
benchmarks (copied here because the JAX module imports jax).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host encoder: (H, W, 3) uint8 -> (Y (H, W), UV (H/2, W/2, 2)) uint8.

    H and W must be even. BT.601 full range; chroma planes are 2x2 box means.
    """
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h, w = y.shape
    u_sub = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v_sub = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    return (
        np.clip(np.round(y), 0, 255).astype(np.uint8),
        np.clip(np.round(np.stack([u_sub, v_sub], axis=-1)), 0, 255).astype(np.uint8),
    )


def _up2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 2x bilinear upsample along ``dim`` (half-pixel convention,
    replicate edges): output 2k takes 0.25*x[k-1] + 0.75*x[k], output 2k+1
    takes 0.75*x[k] + 0.25*x[k+1] -- the same lerps as the JAX ``_up2``.
    Every intermediate keeps the frames outermost and contiguous, so a
    symbolic frame count enters no stride (``torch.export``)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    xm = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)  # x[max(k-1, 0)]
    xp = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)  # x[min(k+1, n-1)]
    even = 0.25 * xm + 0.75 * x
    odd = 0.75 * x + 0.25 * xp
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def yuv420_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Y (..., H, W) + UV (..., H/2, W/2, 2) uint8 -> (..., H, W, 3) float32
    RGB in [0, 255]; any leading (frame) dimensions are batched."""
    h, w = y.shape[-2], y.shape[-1]
    if (h, w) != (2 * uv.shape[-3], 2 * uv.shape[-2]) or uv.shape[-1] != 2:
        raise ValueError(
            "YUV420 frames need even dimensions with UV at exactly half the "
            "Y plane; got Y {} / UV {}".format(tuple(y.shape), tuple(uv.shape))
        )
    yf = y.float()
    uvf = _up2(_up2(uv.float(), -3), -2)
    u = uvf[..., 0] - 128.0
    v = uvf[..., 1] - 128.0
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
