"""Tests of the port that need a CUDA card (marked ``cuda``; each skips on a
host without one). They import no jax, so they run where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

Kernels against their plain versions on the card: |diff| <= 1 on at most
1e-4 of the values (bit-exact is expected).
"""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import (
    pyramid,
    windows,
    windows_cuda,
    windows_dyn,
    windows_dyn_cuda,
    windows_sched,
    windows_sched_cuda,
)

pytestmark = pytest.mark.cuda

MAX_BAD_FRACTION = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_config():
    yield
    cf.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU build")
    return torch.device("cuda")


def _assert_equalish(got, ref):
    diff = (got.float() - ref.float()).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) <= MAX_BAD_FRACTION


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
    """K1 against its plain version on the card."""
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
    _assert_equalish(got, ref)


def test_wrapper_on_card_equals_plain_on_cpu(card):
    """The box-level wrapper: kernel on the card == plain version on the
    CPU for the same inputs (positions computed by the same expressions)."""
    rng = np.random.RandomState(5)
    images = torch.from_numpy((rng.rand(2, 60, 80, 3) * 255).astype(np.float32))
    boxes = _boxes(rng, 2, 30, 60, 80)
    got = windows_cuda.crop_and_resize(images.to(card), boxes.to(card), 24, 24)
    ref = windows.crop_and_resize_plain(images, boxes, 24, 24)
    _assert_equalish(got.cpu(), ref)


def test_k2_matches_plain(card):
    """K2 on every slot of a 192x256 plan's schedule, two frames, against
    its plain version on the card; real slots also equal K1 reordered."""
    plan = pyramid.build_plan(192, 256, 12, 12, 0.075, 1.05)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=card)
    rng = np.random.RandomState(2)
    images = torch.from_numpy((rng.rand(2, 192, 256, 3) * 255).astype(np.float32)).to(card)
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, card)
    planes = windows.to_planes_bf16(images)
    before = windows_sched_cuda.LAUNCHES
    got = windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile)
    assert windows_sched_cuda.LAUNCHES == before + 1
    ref = windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _assert_equalish(got, ref)
    ordered = windows_sched.extract_scheduled(images, boxes, sched, reorder=True)
    k1 = windows_cuda.crop_and_resize(images, boxes.expand(2, -1, 4), 12, 12)
    _assert_equalish(ordered, k1)


@pytest.mark.parametrize("size", [24, 48])
def test_k4_matches_plain(card, size):
    """K4's raw output on every sorted slot and the merged windows against
    the plain version on the card; n_big and overflow equal."""
    plan = pyramid.build_plan(480, 640, 12, 12, 0.075, 1.1)
    coords = pyramid.window_table(plan)["coords_norm"]
    rng = np.random.RandomState(size)
    boxes = torch.from_numpy(
        np.stack([coords[rng.choice(plan.n_windows, 300, replace=False)] for _ in range(2)])
    ).float()
    images = torch.from_numpy((rng.rand(2, 480, 640, 3) * 255).astype(np.float32))
    cap = windows_dyn.default_big_cap(300, size, size, 480)
    before = windows_dyn_cuda.LAUNCHES
    got = windows_dyn.small_class(images.to(card), boxes.to(card), size, size)
    assert windows_dyn_cuda.LAUNCHES == before + 1
    ref = windows_dyn.small_class(images, boxes, size, size)
    for key in ("perm", "small_ok", "n_big"):
        torch.testing.assert_close(got[key].cpu(), ref[key], rtol=0, atol=0)
    _assert_equalish(got["raw"].cpu(), ref["raw"])
    wins, n_big, ovf = windows_dyn.extract_rowbound(
        images.to(card), boxes.to(card), size, size, big_cap=cap
    )
    wins_ref, n_big_ref, ovf_ref = windows_dyn.extract_rowbound(
        images, boxes, size, size, big_cap=cap
    )
    _assert_equalish(wins.cpu(), wins_ref)
    assert n_big.tolist() == n_big_ref.tolist() and ovf.tolist() == ovf_ref.tolist()


@pytest.mark.parametrize(
    "mode, dyn", [("gather", "off"), ("crop", "off"), ("crop", "on")]
)
def test_detector_on_card_matches_cpu(card, mode, dyn):
    """A small f32 cascade (TF32 off) on the card and on the CPU, same
    weights: same survivor windows up to borderline flips. In crop mode
    the card runs K2 (and K4 with dyn_reextract on)."""
    cf.set("conv_filter_sizes", [8])
    cf.set("fc1_size", 32)
    cf.set("compute_dtype", "float32")
    model = cascade.build_cascade_model(seed=0, device="cpu")
    if mode == "gather":
        img = synthetic.make_scene(100, 120, 1, seed=3, min_face=40, max_face=60).image
    else:
        cf.set("window_extraction_mode", "crop")
        cf.set("window_scale_factor", 1.25)
        cf.set("dyn_reextract", dyn)
        img = synthetic.make_scene(256, 320, 2, seed=3, min_face=40, max_face=90).image
    before = (windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES, windows_dyn_cuda.LAUNCHES)
    res_gpu = cascade.CascadeDetector(model.to(card)).detect(img)
    k1, k2, k4 = (
        windows_cuda.LAUNCHES - before[0],
        windows_sched_cuda.LAUNCHES - before[1],
        windows_dyn_cuda.LAUNCHES - before[2],
    )
    if mode == "gather":
        assert k1 >= 2 and k2 == 0
    else:
        assert k2 >= 1
        assert k4 >= 1 if dyn == "on" else k4 == 0
    res_cpu = cascade.CascadeDetector(model).detect(img)
    assert res_gpu.n_windows == res_cpu.n_windows
    ids_g, ids_c = set(res_gpu.raw_window_ids.tolist()), set(res_cpu.raw_window_ids.tolist())
    assert len(ids_g ^ ids_c) <= 0.02 * max(len(ids_c), 1)
