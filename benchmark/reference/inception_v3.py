"""Plain reference: the InceptionV3 trunk (Szegedy et al., arXiv:1512.00567,
in torchvision's ``inception_v3`` layout), 299 x 299 x 3 -> the 2048-wide
mean of the last block.

Each BasicConv2d is a convolution whose batch norm is folded into its
weights and bias, then relu. Max pools are 3 x 3 stride 2 without padding;
a block's pool branch is a 3 x 3 stride-1 average over zero padding
(padding counted). Weights: ``{path: {"W" (out, in, kh, kw), "b" (out,)}}``
keyed by torchvision's module paths.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .cnn import round_operand

WIDTH = 2048  # the trunk's output features

# torchvision's trunk: path -> (in, out, kh, kw, stride, pad_h, pad_w)
STEM = [
    ("Conv2d_1a_3x3", 3, 32, 3, 3, 2, 0, 0),
    ("Conv2d_2a_3x3", 32, 32, 3, 3, 1, 0, 0),
    ("Conv2d_2b_3x3", 32, 64, 3, 3, 1, 1, 1),
    ("pool",),
    ("Conv2d_3b_1x1", 64, 80, 1, 1, 1, 0, 0),
    ("Conv2d_4a_3x3", 80, 192, 3, 3, 1, 0, 0),
    ("pool",),
]


def _a(p, cin, pool):
    return {"kind": "a", "convs": [
        (p + ".branch1x1", cin, 64, 1, 1, 1, 0, 0),
        (p + ".branch5x5_1", cin, 48, 1, 1, 1, 0, 0),
        (p + ".branch5x5_2", 48, 64, 5, 5, 1, 2, 2),
        (p + ".branch3x3dbl_1", cin, 64, 1, 1, 1, 0, 0),
        (p + ".branch3x3dbl_2", 64, 96, 3, 3, 1, 1, 1),
        (p + ".branch3x3dbl_3", 96, 96, 3, 3, 1, 1, 1),
        (p + ".branch_pool", cin, pool, 1, 1, 1, 0, 0)]}


def _b(p, cin):
    return {"kind": "b", "convs": [
        (p + ".branch3x3", cin, 384, 3, 3, 2, 0, 0),
        (p + ".branch3x3dbl_1", cin, 64, 1, 1, 1, 0, 0),
        (p + ".branch3x3dbl_2", 64, 96, 3, 3, 1, 1, 1),
        (p + ".branch3x3dbl_3", 96, 96, 3, 3, 2, 0, 0)]}


def _c(p, cin, c7):
    return {"kind": "c", "convs": [
        (p + ".branch1x1", cin, 192, 1, 1, 1, 0, 0),
        (p + ".branch7x7_1", cin, c7, 1, 1, 1, 0, 0),
        (p + ".branch7x7_2", c7, c7, 1, 7, 1, 0, 3),
        (p + ".branch7x7_3", c7, 192, 7, 1, 1, 3, 0),
        (p + ".branch7x7dbl_1", cin, c7, 1, 1, 1, 0, 0),
        (p + ".branch7x7dbl_2", c7, c7, 7, 1, 1, 3, 0),
        (p + ".branch7x7dbl_3", c7, c7, 1, 7, 1, 0, 3),
        (p + ".branch7x7dbl_4", c7, c7, 7, 1, 1, 3, 0),
        (p + ".branch7x7dbl_5", c7, 192, 1, 7, 1, 0, 3),
        (p + ".branch_pool", cin, 192, 1, 1, 1, 0, 0)]}


def _d(p, cin):
    return {"kind": "d", "convs": [
        (p + ".branch3x3_1", cin, 192, 1, 1, 1, 0, 0),
        (p + ".branch3x3_2", 192, 320, 3, 3, 2, 0, 0),
        (p + ".branch7x7x3_1", cin, 192, 1, 1, 1, 0, 0),
        (p + ".branch7x7x3_2", 192, 192, 1, 7, 1, 0, 3),
        (p + ".branch7x7x3_3", 192, 192, 7, 1, 1, 3, 0),
        (p + ".branch7x7x3_4", 192, 192, 3, 3, 2, 0, 0)]}


def _e(p, cin):
    return {"kind": "e", "convs": [
        (p + ".branch1x1", cin, 320, 1, 1, 1, 0, 0),
        (p + ".branch3x3_1", cin, 384, 1, 1, 1, 0, 0),
        (p + ".branch3x3_2a", 384, 384, 1, 3, 1, 0, 1),
        (p + ".branch3x3_2b", 384, 384, 3, 1, 1, 1, 0),
        (p + ".branch3x3dbl_1", cin, 448, 1, 1, 1, 0, 0),
        (p + ".branch3x3dbl_2", 448, 384, 3, 3, 1, 1, 1),
        (p + ".branch3x3dbl_3a", 384, 384, 1, 3, 1, 0, 1),
        (p + ".branch3x3dbl_3b", 384, 384, 3, 1, 1, 1, 0),
        (p + ".branch_pool", cin, 192, 1, 1, 1, 0, 0)]}


BLOCKS = [
    _a("Mixed_5b", 192, 32), _a("Mixed_5c", 256, 64), _a("Mixed_5d", 288, 64),
    _b("Mixed_6a", 288),
    _c("Mixed_6b", 768, 128), _c("Mixed_6c", 768, 160), _c("Mixed_6d", 768, 160),
    _c("Mixed_6e", 768, 192),
    _d("Mixed_7a", 768), _e("Mixed_7b", 1280), _e("Mixed_7c", 2048),
]


def conv_specs() -> Dict[str, Tuple[int, ...]]:
    """path -> (in, out, kh, kw, stride, pad_h, pad_w) of every trunk conv."""
    specs = {s[0]: s[1:] for s in STEM if len(s) > 1}
    for block in BLOCKS:
        specs.update({s[0]: s[1:] for s in block["convs"]})
    return specs


def _conv(params, spec, x, precision):
    path, _cin, _cout, _kh, _kw, stride, ph, pw = spec
    p = params[path]
    out = F.conv2d(round_operand(x, precision), round_operand(p["W"], precision),
                   stride=stride, padding=(ph, pw))
    return torch.relu(out + p["b"][:, None, None])


def _pool_avg(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _block(params, block, x, precision):
    c = {s[0].split(".")[1]: s for s in block["convs"]}

    def run(*names, inp=x):
        h = inp
        for n in names:
            h = _conv(params, c[n], h, precision)
        return h

    kind = block["kind"]
    if kind == "a":
        return torch.cat([run("branch1x1"), run("branch5x5_1", "branch5x5_2"),
                          run("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                          run("branch_pool", inp=_pool_avg(x))], 1)
    if kind == "b":
        return torch.cat([run("branch3x3"),
                          run("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                          F.max_pool2d(x, 3, 2)], 1)
    if kind == "c":
        return torch.cat([run("branch1x1"),
                          run("branch7x7_1", "branch7x7_2", "branch7x7_3"),
                          run("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                              "branch7x7dbl_4", "branch7x7dbl_5"),
                          run("branch_pool", inp=_pool_avg(x))], 1)
    if kind == "d":
        return torch.cat([run("branch3x3_1", "branch3x3_2"),
                          run("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                              "branch7x7x3_4"),
                          F.max_pool2d(x, 3, 2)], 1)
    b3 = run("branch3x3_1")
    bd = run("branch3x3dbl_1", "branch3x3dbl_2")
    return torch.cat([run("branch1x1"),
                      run("branch3x3_2a", inp=b3), run("branch3x3_2b", inp=b3),
                      run("branch3x3dbl_3a", inp=bd), run("branch3x3dbl_3b", inp=bd),
                      run("branch_pool", inp=_pool_avg(x))], 1)


def trunk(params, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(N, 299, 299, 3) standardised windows -> (N, 2048) float32."""
    h = x.permute(0, 3, 1, 2)
    for spec in STEM:
        h = F.max_pool2d(h, 3, 2) if spec[0] == "pool" else _conv(params, spec, h, precision)
    for block in BLOCKS:
        h = _block(params, block, h, precision)
    return h.mean(dim=(2, 3))
