"""The yardstick's arithmetic: the card's peaks, the operations a stage
needs per window, and the least time a resampling kernel could take.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM.

Operations: two per multiply-add of every convolution and fully
connected layer (bias adds, activations and pools are not counted).

A resampling kernel's bound (K1, K2) is the larger of its bytes over the
HBM bandwidth (the frame's bf16 planes read once, each window's sampling
positions read once, each output value written once) and its float32
operations over the float32 peak (24 a value: four tap weights, two
vertical and one horizontal sum, rounding and clipping).
"""

from __future__ import annotations

from typing import List

from ..reference import inception_v3 as ref_v3

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_VALUE = 24


def conv_flops(cin: int, cout: int, kh: int, kw: int, out_h: int, out_w: int) -> int:
    return 2 * cin * cout * kh * kw * out_h * out_w


def custom_stage_flops(size: int, config: dict, bneck_in: int) -> int:
    """Operations of one window through a conv stage (SAME padding)."""
    k, cin, hw, total = config["conv_filter_size"], 3, size, 0
    for cout in config["conv_filter_sizes"]:
        hw = -(-hw // config["conv_stride"])
        total += conv_flops(cin, cout, k, k, hw, hw)
        hw = -(-hw // config["pooling_stride"])
        cin = cout
    flat, fc1 = hw * hw * cin, config["fc1_size"]
    return total + 2 * flat * fc1 + 2 * (fc1 + (bneck_in or 0)) * 2


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def trunk_flops(size: int = 299) -> int:
    """Operations of one window through the InceptionV3 trunk."""
    total, hw = 0, size
    for spec in ref_v3.STEM:
        if spec[0] == "pool":
            hw = _out(hw, 3, 2, 0)
            continue
        _p, cin, cout, kh, kw, s, ph, pw = spec
        oh = _out(hw, kh, s, ph)
        total += conv_flops(cin, cout, kh, kw, oh, _out(hw, kw, s, pw))
        hw = oh
    for block in ref_v3.BLOCKS:
        for _p, cin, cout, kh, kw, s, ph, pw in block["convs"]:
            # a branch's convolutions before its stride-2 one run at the
            # block's input size
            total += conv_flops(cin, cout, kh, kw, _out(hw, kh, s, ph), _out(hw, kw, s, pw))
        if block["kind"] in ("b", "d"):
            hw = _out(hw, 3, 2, 0)
    return total


def stage_flops(stages: List[dict], config: dict) -> List[int]:
    """Operations of one window through each stage of a configuration."""
    out = []
    for st in stages:
        if st["kind"] == "inception":
            out.append(trunk_flops(st["size"]) + 2 * (ref_v3.WIDTH + (st["bneck_in"] or 0)) * 2)
        else:
            out.append(custom_stage_flops(st["size"], config, st["bneck_in"]))
    return out


def resample_bound_s(frames: int, img_h: int, img_w: int, windows: int, size: int,
                     out_bytes: int, channels: int = 3) -> float:
    """Least seconds a kernel could take to resample ``windows`` windows of
    ``size`` px from ``frames`` frames, writing ``out_bytes`` a value."""
    values = windows * size * size * channels
    n_bytes = (frames * channels * img_h * img_w * 2 + windows * 2 * size * 4
               + values * out_bytes)
    return max(n_bytes / HBM_BYTES_PER_S, values * OPS_PER_VALUE / F32_FLOPS)
