"""Tests of the port that need a CUDA card (marked ``cuda``; each skips on a
host without one). They import no jax, so they run where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows, windows_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU build")
    return torch.device("cuda")


def _boxes(rng, b, n, h, w):
    x0 = rng.uniform(0, w - 4, (b, n))
    y0 = rng.uniform(0, h - 4, (b, n))
    bw = rng.uniform(4, w, (b, n))
    bh = rng.uniform(4, h, (b, n))
    boxes = np.stack([x0, y0, np.minimum(x0 + bw, w), np.minimum(y0 + bh, h)], -1)
    boxes[:, : n // 4] = np.floor(boxes[:, : n // 4])
    boxes[:, 0] = [0, 0, w, h]  # the full frame
    boxes[:, 1] = [w - 1, h - 1, w, h]  # a 1x1 corner (replicate border)
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.parametrize("out", [12, 24, 48])
def test_kernel_matches_plain(card, out):
    """K1 against its plain version on the card: |diff| <= 1 on at most
    1e-4 of the values (bit-exact is expected)."""
    rng = np.random.RandomState(out)
    images = torch.from_numpy((rng.rand(3, 120, 160, 3) * 255).astype(np.float32)).to(card)
    boxes = _boxes(rng, 3, 50, 120, 160).to(card)
    sy, sx = windows.sample_positions(boxes, 120, 160, out, out)
    planes = windows.to_planes_bf16(images)
    before = windows_cuda.LAUNCHES
    got = windows_cuda.crop_and_resize_cuda(planes, sy.contiguous(), sx.contiguous())
    assert windows_cuda.LAUNCHES == before + 1
    ref = windows.resample_plain(planes, sy, sx)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) <= 1e-4


def test_wrapper_on_card_equals_plain_on_cpu(card):
    """The box-level wrapper: kernel on the card == plain version on the
    CPU for the same inputs (positions computed by the same expressions)."""
    rng = np.random.RandomState(5)
    images = torch.from_numpy((rng.rand(2, 60, 80, 3) * 255).astype(np.float32))
    boxes = _boxes(rng, 2, 30, 60, 80)
    got = windows_cuda.crop_and_resize(images.to(card), boxes.to(card), 24, 24)
    ref = windows.crop_and_resize_plain(images, boxes, 24, 24)
    diff = (got.cpu() - ref).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) <= 1e-4


def test_detector_on_card_matches_cpu(card):
    """A small f32 cascade (TF32 off) on the card and on the CPU, same
    weights: same survivor windows up to borderline flips."""
    cf.set("conv_filter_sizes", [8])
    cf.set("fc1_size", 32)
    cf.set("compute_dtype", "float32")
    model = cascade.build_cascade_model(seed=0)
    img = synthetic.make_scene(100, 120, 1, seed=3, min_face=40, max_face=60).image
    before = windows_cuda.LAUNCHES
    res_gpu = cascade.CascadeDetector(model.to(card)).detect(img)
    assert windows_cuda.LAUNCHES >= before + 2
    res_cpu = cascade.CascadeDetector(model).detect(img)
    assert res_gpu.n_windows == res_cpu.n_windows
    ids_g, ids_c = set(res_gpu.raw_window_ids.tolist()), set(res_cpu.raw_window_ids.tolist())
    assert len(ids_g ^ ids_c) <= 0.02 * max(len(ids_c), 1)
