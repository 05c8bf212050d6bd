"""Plain reference: the colour decode and one cascade stage's CNN.

YUV420 -> RGB: BT.601 full range, the chroma planes upsampled 2x
bilinearly (half-pixel centres, edges replicated), clipped to [0, 255] and
left unrounded.

A stage (the reference net, ``network/net.py``): the window standardised
with the stage's mean and deviation, then per conv layer a k x k SAME
convolution, bias, relu and a SAME max-pool (padding with -inf); the
activations flattened in (y, x, channel) order; fc1 with relu, the
"bottleneck"; the previous stage's bottleneck appended after it; fc2 and a
softmax over the two classes. Weights: conv ``W`` in HWIO, fc ``W`` as
(in, out).

``precision`` is "f32" (float32, TF32 off: the reference) or "fp8": every
convolution and product takes operands rounded to float8 e4m3 with one
scale per tensor (its largest magnitude onto 448) and accumulates in
float32, the control that a precision below the configuration's bf16
must fail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products and convolutions in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError("precision is 'f32' or 'fp8', not {!r}".format(precision))
    if x.numel() == 0:
        return x
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def yuv420_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Y (B, H, W), UV (B, H/2, W/2, 2) uint8 -> (B, H, W, 3) float32."""

    def up2(x, dim):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        even, odd = 0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt
        return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)

    c = up2(up2(uv.float(), 1), 2)
    u, v = c[..., 0] - 128.0, c[..., 1] - 128.0
    yf = y.float()
    rgb = torch.stack([yf + 1.402 * v, yf - 0.344136 * u - 0.714136 * v, yf + 1.772 * u], -1)
    return torch.clamp(rgb, 0.0, 255.0)


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_stack(x: torch.Tensor, layers, pool: int, pool_stride: int, stride: int,
               precision: str) -> torch.Tensor:
    """(N, s, s, C) standardised windows -> (N, features) flattened in
    (y, x, channel) order."""
    h = x.permute(0, 3, 1, 2)
    for layer in layers:
        w = layer["W"].permute(3, 2, 0, 1)
        k = w.shape[2]
        t, b = _same(h.shape[2], k, stride)
        lft, r = _same(h.shape[3], k, stride)
        h = F.conv2d(round_operand(F.pad(h, (lft, r, t, b)), precision),
                     round_operand(w, precision), stride=stride)
        h = torch.relu(h + layer["b"][:, None, None])
        t, b = _same(h.shape[2], pool, pool_stride)
        lft, r = _same(h.shape[3], pool, pool_stride)
        h = F.max_pool2d(F.pad(h, (lft, r, t, b), value=float("-inf")), pool, pool_stride)
    return h.permute(0, 2, 3, 1).flatten(1)


def dense(x: torch.Tensor, layer, precision: str) -> torch.Tensor:
    return round_operand(x, precision) @ round_operand(layer["W"], precision) + layer["b"]


def head(hidden: torch.Tensor, bottleneck_in, fc2, precision: str):
    """(foreground probability (N,), bottleneck (N, F)) from the hidden
    representation and the previous stage's bottleneck (or None)."""
    bottleneck = hidden if bottleneck_in is None else torch.cat([hidden, bottleneck_in], 1)
    probs = torch.softmax(dense(bottleneck, fc2, precision), dim=-1)
    return probs[:, 1], bottleneck


def custom_stage(params, arch, windows: torch.Tensor, mean, std, bottleneck_in,
                 precision: str):
    """A conv stage over (N, s, s, 3) windows of pixel values."""
    x = (windows - mean) / std
    flat = conv_stack(x, params["conv"], arch["pooling_size"], arch["pooling_stride"],
                      arch["conv_stride"], precision)
    hidden = torch.relu(dense(flat, params["fc1"], precision))
    return head(hidden, bottleneck_in, params["fc2"], precision)
