"""The benchmark's plain reference held against the port, piece by piece and
whole, at tiny sizes on the CPU (float32 on both sides)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import scenes, weights
from benchmark.reference import cascade as ref_cascade
from benchmark.reference import cnn as ref_cnn
from benchmark.reference import inception_v3 as ref_v3
from benchmark.reference import nms as ref_nms
from benchmark.reference import pyramid as ref_pyramid
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn, inception_v3
from rapidobjectdetectionusingcascadedcnns_torch.ops import color, nms, pyramid, windows

CONFIG = {"cascade_n_nets": 3, "img_width": 48, "conv_filter_sizes": [8], "conv_filter_size": 3,
          "conv_stride": 1, "pooling_size": 3, "pooling_stride": 1, "fc1_size": 32,
          "reuse_bottlenecks": True, "standardization": {"mean": 127.5, "std": 64.0}}


def test_scenes_are_the_detectors_scenes():
    for seed in (0, 7, 2**32 - 1):
        ours = scenes.make_scene(96, 128, 3, seed, 24, 40)
        theirs = synthetic.make_scene(96, 128, 3, seed=seed, min_face=24, max_face=40).image
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(scenes.rgb_to_yuv420(ours)[1],
                                      color.rgb_to_yuv420(ours)[1])


def test_yuv_decode_matches():
    y, uv = scenes.rgb_to_yuv420(scenes.make_scene(32, 48, 1, 3, 10, 20))
    ours = ref_cnn.yuv420_to_rgb(torch.as_tensor(y)[None], torch.as_tensor(uv)[None])
    theirs = color.yuv420_to_rgb(torch.as_tensor(y)[None], torch.as_tensor(uv)[None])
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw,wsf", [((480, 640), 1.1), ((96, 128), 1.1), ((64, 64), 1.02)])
def test_pyramid_matches(hw, wsf):
    lv = ref_pyramid.levels(hw[0], hw[1], 12, 0.075, wsf)
    ints, floats = ref_pyramid.window_boxes(lv, hw[0], hw[1], 12)
    table = pyramid.window_table(pyramid.build_plan(hw[0], hw[1], 12, 12, 0.075, wsf))
    np.testing.assert_array_equal(ints, table["coords_norm"])
    np.testing.assert_array_equal(floats, table["boxes_float"])


def test_gather_windows_match():
    img = torch.as_tensor(scenes.make_scene(96, 128, 2, 5, 24, 40)).float()[None]
    lv = ref_pyramid.levels(96, 128, 12, 0.075, 1.1)
    ours = ref_pyramid.gather_windows(img, lv, 12)
    theirs = windows.extract_windows(img, pyramid.build_plan(96, 128, 12, 12, 0.075, 1.1))
    diff = (ours - theirs).abs()
    assert diff.max() <= 1.0  # antialiased resize vs. its weight matrix: ties at .5
    assert (diff > 0).float().mean() < 0.01


def test_crop_resize_matches():
    img = torch.as_tensor(scenes.make_scene(64, 80, 2, 9, 20, 30)).float()
    boxes = torch.tensor([[3.0, 4.0, 40.0, 41.0], [10.5, 0.0, 22.25, 11.75], [0, 0, 79, 63]])
    ours = ref_pyramid.crop_resize(img, boxes, 24)
    theirs = windows.crop_and_resize_plain(img[None], boxes[None], 24, 24, high_precision=True)[0]
    diff = (ours - theirs).abs()
    assert diff.max() <= 1.0
    assert (diff > 0).float().mean() < 0.001


def test_stage_cnn_matches():
    stages = weights.stages(CONFIG, 3, "cpu")
    x = torch.rand(5, 24, 24, 3) * 255
    bneck = torch.rand(5, 32)
    st = stages[1]
    p, bn = ref_cnn.custom_stage(st["params"], st["arch"], x, st["mean"], st["std"], bneck,
                                 "f32")
    sc = cnn.StageConfig(input_size=24, conv_filter_sizes=(8,), fc1_size=32,
                         bottleneck_in_size=32, compute_dtype=torch.float32)
    out = cnn.apply_stage(st["params"], sc, (x - 127.5) / 64.0, bneck)
    torch.testing.assert_close(p, out["probs"][:, 1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn, out["bottleneck"], rtol=1e-5, atol=1e-6)


def test_inception_trunk_matches():
    gen = torch.Generator().manual_seed(1)
    params = {path: {"W": torch.randn(cout, cin, kh, kw, generator=gen) * (2.0 / (cin * kh * kw)) ** 0.5,
                     "b": torch.randn(cout, generator=gen) * 0.1}
              for path, (cin, cout, kh, kw, *_r) in ref_v3.conv_specs().items()}
    x = torch.randn(2, 75, 75, 3, generator=gen)
    ours = ref_v3.trunk(params, x)
    theirs = inception_v3.apply_v3(params, x, dtype=torch.float32)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


def test_group_rectangles_matches():
    rs = np.random.RandomState(4)
    for n in (0, 1, 5, 60, 300):
        xy = rs.randint(0, 200, size=(n, 2))
        wh = rs.randint(12, 60, size=(n, 1)).repeat(2, 1)
        boxes = np.concatenate([xy, xy + wh], 1)
        for mn in (0, 1, 3):
            ours, ow = ref_nms.group_rectangles(boxes, mn)
            theirs, tw = nms.nms_boxes(boxes, mn)
            key = lambda b: b[np.lexsort(b.T[::-1])]  # noqa: E731
            np.testing.assert_array_equal(key(ours.reshape(-1, 4)), key(theirs.reshape(-1, 4)))
            np.testing.assert_array_equal(np.sort(ow), np.sort(tw))


def test_cascade_matches_the_detector_in_f32():
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    stages = weights.stages(CONFIG, 11, "cpu")
    frames = [scenes.make_scene(96, 128, 2, s, 24, 40) for s in (1, 2)]
    geom = ref_cascade.Geometry(96, 128, 12, 0.075, 1.1, "cpu")
    thresholds = [0.5, 0.5, 0.45]
    ref = ref_cascade.detect(stages, torch.as_tensor(np.stack(frames)).float(), geom,
                             thresholds)
    cf.reset()
    cf.set("foreground_confidence_threshold", thresholds)
    configs = [cnn.StageConfig(input_size=st["size"], conv_filter_sizes=(8,), fc1_size=32,
                               bottleneck_in_size=st["bneck_in"], compute_dtype=torch.float32)
               for st in stages]
    model = cascade.CascadeModel([st["params"] for st in stages], configs,
                                 [np.full((s.input_size,) * 2 + (3,), 127.5, np.float32)
                                  for s in configs],
                                 [np.full((s.input_size,) * 2 + (3,), 64.0, np.float32)
                                  for s in configs])
    try:
        got = cascade.CascadeDetector(model).detect_batch(frames)
    finally:
        cf.reset()
    for g, r in zip(got, ref):
        assert g.n_survivors_per_stage[0] == r["counts"][0]
        flips = len(np.setxor1d(g.raw_window_ids, r["ids"]))
        assert flips <= max(1, 0.02 * len(r["ids"]))
