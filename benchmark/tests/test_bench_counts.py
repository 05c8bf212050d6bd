"""The benchmark's operation and byte counts against counts worked out by
hand for small shapes, and the trunk's against PyTorch's own counter."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import counts, weights
from benchmark.reference import inception_v3 as ref_v3

SMALL = {"conv_filter_sizes": [8], "conv_filter_size": 3, "conv_stride": 1,
         "pooling_stride": 1, "fc1_size": 32}


def test_custom_stage_by_hand():
    # 12 x 12 x 3 -> conv 3x3 to 8 channels (SAME): 2 * 27 * 8 * 144 = 62,208;
    # fc1 from 12 * 12 * 8 = 1,152 to 32: 2 * 1,152 * 32 = 73,728; fc2 from
    # 32 + 16 to 2: 2 * 48 * 2 = 192
    assert counts.custom_stage_flops(12, SMALL, 16) == 62_208 + 73_728 + 192
    # the published stage 0 (conv [32], fc1 512, no bottleneck in):
    # 2 * 27 * 32 * 144 + 2 * 4,608 * 512 + 2 * 512 * 2
    published = dict(SMALL, conv_filter_sizes=[32], fc1_size=512)
    assert counts.custom_stage_flops(12, published, None) == 248_832 + 4_718_592 + 2_048


def test_trunk_against_torch_counter():
    from torch.utils.flop_counter import FlopCounterMode

    params = {path: {"W": torch.zeros(cout, cin, kh, kw), "b": torch.zeros(cout)}
              for path, (cin, cout, kh, kw, *_r) in ref_v3.conv_specs().items()}
    with FlopCounterMode(display=False) as fc:
        ref_v3.trunk(params, torch.zeros(1, 299, 299, 3))
    assert counts.trunk_flops(299) == fc.get_total_flops()
    assert 11.0e9 < counts.trunk_flops(299) < 11.6e9  # 5.7 G multiply-adds


def test_stage_flops_follow_the_stages():
    config = dict(SMALL, cascade_n_nets=3, img_width=48, pooling_size=3,
                  reuse_bottlenecks=True, append_inception=True,
                  standardization={"mean": 127.5, "std": 64.0})
    stages = weights.stages(config, 0, "cpu")
    assert [st["size"] for st in stages] == [12, 24, 48, 299]
    assert [st["bneck_in"] for st in stages] == [None, 32, 64, 96]
    assert counts.stage_flops(stages, config) == [
        counts.custom_stage_flops(12, config, None), counts.custom_stage_flops(24, config, 32),
        counts.custom_stage_flops(48, config, 64),
        counts.trunk_flops(299) + 2 * (2048 + 96) * 2]


def test_resample_bound_by_hand():
    # 2 frames of 10 x 20 x 3 bf16 (2,400 B), 5 windows of 4 px: positions
    # 5 * 8 floats (160 B), 240 f32 values out (960 B): 3,520 B over 3.35
    # TB/s; 240 values * 24 f32 operations over 67 TFLOP/s
    got = counts.resample_bound_s(2, 10, 20, 5, 4, 4)
    assert got == pytest.approx(max(3520 / 3.35e12, 240 * 24 / 67e12))
    assert got == pytest.approx(3520 / 3.35e12)
