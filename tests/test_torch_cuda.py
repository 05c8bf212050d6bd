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
    nms,
    nms_cuda,
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


@pytest.mark.parametrize("out", [12, 24, 48, 97, 98, 299])
def test_kernel_matches_plain(card, out):
    """K1 against its plain version on the card: whole boxes up to 97 px,
    the banded launch above (98 px: one band of 31 rows short; 299 px:
    the Inception stage, 10 rows a block)."""
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


def _k2_case(case, c):
    """(planes (B, C, H, W) bf16, sy_local, sx_local, tiles, tile) of one K2
    edge case, on the CPU."""
    rng = np.random.RandomState(9)
    tile = windows_sched._tile_windows(12, 12)
    if case in ("over budget", "wide"):
        # synthetic tiles: 32 windows spread over a 256x256 cell (support
        # up to 256 x 256 pixels, past the staging budget), or one cell
        # 4,352 columns wide (more than the kernel's bitmap covers)
        h, w = (256, 300) if case == "over budget" else (64, 4300)
        cells = [[0, 0, 256, 256], [0, 0, 256, 512]] if case == "over budget" else [[0, 0, 64, 4352]]
        tiles = torch.tensor(cells, dtype=torch.int32)
        n = tile * len(cells)
        sy = torch.from_numpy(np.sort(rng.uniform(0, h - 1, (n, 12)), 1).astype(np.float32))
        sx = torch.from_numpy(np.sort(rng.uniform(0, w - 1, (n, 12)), 1).astype(np.float32))
    else:
        # a real schedule of a frame whose cells reach past its bottom and
        # right edges; "leaves cell" moves one tile's rows 3.3 above its
        # cell and another tile's columns past its cell's right end
        h, w = 200, 300
        plan = pyramid.build_plan(h, w, 12, 12, 0.075, 1.25)
        boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"]).float()
        sched = windows_sched.build_schedule(boxes.numpy(), h, w, 12, 12)
        sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, torch.device("cpu"))
        if case == "leaves cell":
            sy[:tile] -= 3.3
            sx[tile : 2 * tile] += float(tiles[1, 3]) - 5.0
    images = torch.from_numpy(rng.randint(0, 256, (2, h, w, c)).astype(np.float32))
    return windows.to_planes_bf16(images), sy.contiguous(), sx.contiguous(), tiles, tile


@pytest.mark.parametrize(
    "case, c",
    [("edges", 3), ("edges", 1), ("leaves cell", 3), ("over budget", 3), ("over budget", 1),
     ("wide", 1)],
)
def test_k2_edge_cases(card, case, c):
    """K2 against its plain version, bit for bit: tiles on the frame's
    bottom and right edges (rows and columns past the image), taps that
    leave their tile's cell, 1 and 3 channels, and tiles that the kernel
    samples from the planes instead of staging (a support over the budget;
    a cell wider than the bitmap)."""
    planes, sy, sx, tiles, tile = _k2_case(case, c)
    _, budget = windows_sched_cuda.launch_geometry(tile, 12, 12, c)
    sizes = windows_sched_cuda.staging_bytes(sy, sx, tiles, tile, c, *planes.shape[2:])
    direct = (sizes < 0) | (sizes > budget)
    assert bool(direct.all()) if case in ("over budget", "wide") else not direct.any()
    args = [t.to(card) for t in (planes, sy, sx, tiles)]
    before = windows_sched_cuda.LAUNCHES
    got = windows_sched_cuda.resample_sched_cuda(*args, tile)
    assert windows_sched_cuda.LAUNCHES == before + 1
    ref = windows_sched.resample_sched_plain(*args, tile)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got.cpu(), windows_sched.resample_sched_plain(planes, sy, sx, tiles, tile))


@pytest.mark.parametrize("size, c", [(12, 3), (12, 1), (24, 3), (24, 1), (48, 3), (48, 1)])
def test_k4_edge_cases(card, size, c):
    """K4 against its plain version, bit for bit, on three frames of
    150x200 (w_pad 256): cells that start near the bottom edge (rows past
    the image), columns past the right edge, rows above and below the
    cell, 1 and 3 channels; at 12 px the 288 slots end on a partial block
    (5 or 15 slots a block) and blocks span tiles and frames."""
    rng = np.random.RandomState(size + c)
    b, h, w, w_pad = 3, 150, 200, 256
    tile = windows_sched._tile_windows(size, size)
    n_tiles = 3
    n_pad = tile * n_tiles
    images = torch.from_numpy((rng.rand(b, h, w, c) * 255).astype(np.float32))
    planes = windows.to_planes_bf16(images)
    sy = torch.from_numpy(np.sort(rng.uniform(-3, 131, (b, n_pad, size)), -1).astype(np.float32))
    sx = torch.from_numpy(np.sort(rng.uniform(-1, w_pad + 1, (b, n_pad, size)), -1).astype(np.float32))
    cell_start = torch.from_numpy((rng.randint(0, 5, (b, n_tiles)) * 32).astype(np.int32))
    args = (planes, sy, sx, cell_start, tile, windows_dyn.ROW_RUNG, w_pad)
    on_card = [t.to(card) if isinstance(t, torch.Tensor) else t for t in args]
    before = windows_dyn_cuda.LAUNCHES
    got = windows_dyn_cuda.resample_rowbound_cuda(*on_card)
    assert windows_dyn_cuda.LAUNCHES == before + 1
    ref = windows_dyn.resample_rowbound_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    if size == 12:
        per_block, _ = windows_dyn_cuda.launch_geometry(size, size, c)
        assert (b * n_pad) % per_block


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


@pytest.mark.parametrize("eps", [0.2, 0.3])
def test_k3_matches_plain(card, eps):
    """K3 against its plain version on the card: three frames of clustered
    integer boxes with different valid counts and an all-invalid frame;
    avg, counts, keep and labels all equal."""
    rng = np.random.RandomState(int(eps * 10))
    b, n = 4, 300
    centers = rng.randint(0, 400, (b, 12, 2))
    pick = rng.randint(0, 12, (b, n))
    xy = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1) + rng.randint(-4, 5, (b, n, 2))
    wh = 40 + pick[..., None] * 6 + rng.randint(-3, 4, (b, n, 2))
    rects = torch.from_numpy(np.concatenate([xy, wh], -1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(b, n) < np.array([0.9, 0.5, 0.05, 0.0])[:, None])
    before = nms_cuda.LAUNCHES
    got = nms_cuda.group_rectangles_cuda(rects.to(card), valid.to(card), 1, eps)
    assert nms_cuda.LAUNCHES == before + 1
    ref = nms.group_rectangles_device_plain(rects, valid, 1, eps)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=0)
    assert bool(ref[2].any()) and bool((ref[1] > 1).any())


def test_k3_long_chain_converges(card):
    """A chain of 600 boxes in shuffled row order, which min-label
    propagation would need far more than the JAX tail's 11 steps to
    label: K3's union-find joins it into one component in its fixed four
    launches, as its plain version and the host union-find do."""
    order = np.random.RandomState(3).permutation(600)
    rects = np.zeros((1, 600, 4), np.float32)
    rects[0, order] = [(10 + 5 * k, 50, 40, 40) for k in range(600)]
    valid = torch.ones(1, 600, dtype=torch.bool)
    got = nms_cuda.group_rectangles_cuda(torch.from_numpy(rects).to(card), valid.to(card), 1, 0.2)
    ref = nms.group_rectangles_device_plain(torch.from_numpy(rects), valid, 1, 0.2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=0)
    assert (ref[3] == 0).all() and int(ref[2].sum()) == 1


def _k3_case(case):
    """(rects (B, N, 4), valid (B, N)) of one K3 edge case."""
    rng = np.random.RandomState(11)
    if case == "one row":
        return torch.tensor([[[10.0, 20.0, 30.0, 30.0]]]), torch.ones(1, 1, dtype=torch.bool)
    if case == "all similar":  # every pair similar: every join contends for one root
        n = 2000
        xy = 100 + rng.randint(-2, 3, (1, n, 2))
        wh = 60 + rng.randint(-2, 3, (1, n, 2))
        rects = np.concatenate([xy, wh], -1).astype(np.float32)
        return torch.from_numpy(rects), torch.ones(1, n, dtype=torch.bool)
    # ragged: N not a multiple of the 128-row tile; invalid rows interleaved
    b, n = 3, 1000 if case == "ragged" else 517
    centers = rng.randint(0, 500, (b, 40, 2))
    pick = rng.randint(0, 40, (b, n))
    xy = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1) + rng.randint(-3, 4, (b, n, 2))
    wh = 30 + pick[..., None] * 3 + rng.randint(-2, 3, (b, n, 2))
    rects = np.concatenate([xy, wh], -1).astype(np.float32)
    if case == "ragged":
        valid = np.ones((b, n), bool)
    else:
        valid = np.zeros((b, n), bool)
        valid[:, ::2] = True
        valid[1, 1::7] = True
    return torch.from_numpy(rects), torch.from_numpy(valid)


@pytest.mark.parametrize("case", ["one row", "ragged", "interleaved invalid", "all similar"])
def test_k3_edge_cases(card, case):
    """K3 against its plain version: N = 1; N not a multiple of the tile;
    invalid rows interleaved with valid ones; one frame in which every box
    is similar to every other (heavy contention on one root)."""
    rects, valid = _k3_case(case)
    got = nms_cuda.group_rectangles_cuda(rects.to(card), valid.to(card), 1, 0.2)
    ref = nms.group_rectangles_device_plain(rects, valid, 1, 0.2)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.cpu(), r, rtol=0, atol=0)
    if case == "all similar":
        assert (ref[3] == 0).all() and int(ref[1][0, 0]) == valid.shape[1]


def test_k3_repeatable(card):
    """Two calls on the same input give bit-identical outputs, though the
    atomics run in another order each time."""
    rects, valid = _k3_case("interleaved invalid")
    rects, valid = rects.to(card), valid.to(card)
    first = nms_cuda.group_rectangles_cuda(rects, valid, 1, 0.3)
    second = nms_cuda.group_rectangles_cuda(rects, valid, 1, 0.3)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _k1_case(case):
    """(images (B, H, W, 3), boxes (B, N, 4), out) of one K1 edge case."""
    rng = np.random.RandomState(21)
    h, w = 90, 130
    b = 1 if case == "one frame" else 2
    images = torch.from_numpy((rng.rand(b, h, w, 3) * 255).astype(np.float32))
    if case == "edges":  # boxes ending at the right and bottom edges
        x0 = rng.randint(0, w - 8, (b, 40))
        y0 = rng.randint(0, h - 8, (b, 40))
        boxes = np.stack([x0, y0, np.full_like(x0, w), np.full_like(y0, h)], -1)
        boxes[:, 20:, 1] = 0
        boxes[:, 30:, 2] = x0[:, 30:] + 8
        return images, torch.from_numpy(boxes.astype(np.float32)), 24
    if case == "upsampling":  # boxes smaller than the output: several ox per column
        x0 = rng.uniform(0, w - 12, (b, 30))
        y0 = rng.uniform(0, h - 12, (b, 30))
        side = rng.uniform(2, 20, (b, 30))
        boxes = np.stack([x0, y0, x0 + side, y0 + side], -1)
        return images, torch.from_numpy(boxes.astype(np.float32)), 48
    n = 0 if case == "no boxes" else 37
    boxes = _boxes(rng, b, n, h, w) if n else torch.zeros(b, 0, 4)
    return images, boxes, 12 if case == "12 px" else 24


@pytest.mark.parametrize("case", ["edges", "upsampling", "12 px", "one frame", "no boxes"])
def test_k1_edge_cases(card, case):
    """K1 against its plain version: boxes at the frame's right and bottom
    edges (the zero tap on row H / column W), boxes smaller than the
    output, 12 px (five boxes per block, a ragged last block), one frame
    (a single-frame re-dispatch) and no boxes at all."""
    images, boxes, out = _k1_case(case)
    h, w = images.shape[1:3]
    sy, sx = windows.sample_positions(boxes, h, w, out, out)
    planes = windows.to_planes_bf16(images)
    before = windows_cuda.LAUNCHES
    got = windows_cuda.crop_and_resize_cuda(
        planes.to(card), sy.contiguous().to(card), sx.contiguous().to(card)
    )
    assert windows_cuda.LAUNCHES == before + (1 if boxes.shape[1] else 0)
    ref = windows.resample_plain(planes, sy, sx)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (images.shape[0], boxes.shape[1], out, out, 3)
    assert torch.equal(got.cpu(), ref)


def _k2p_case(card, img_h, img_w, wsf, n_frames):
    """(images, boxes, sched, taps, tiles, planes) of a K2p geometry on the
    card, frames from seed 4."""
    plan = pyramid.build_plan(img_h, img_w, 12, 12, 0.075, wsf)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=card).float()
    sched = windows_sched.build_schedule(boxes.cpu().numpy(), img_h, img_w, 12, 12)
    rng = np.random.RandomState(4)
    images = torch.as_tensor(rng.randint(0, 256, (n_frames, img_h, img_w, 3)).astype(np.float32),
                             device=card)
    taps = windows_sched.precompute_tap_matrices(sched, boxes)
    _, tiles, _ = sched.device_tables(card)
    return images, boxes, sched, taps, tiles, windows.to_planes_bf16(images)


@pytest.mark.parametrize("geometry", [(200, 300, 1.25, 3), (480, 640, 1.1, 2)])
def test_k2p_matches_plain_and_k2(card, geometry):
    """K2p in one launch over a 6-class schedule with 512-wide cells and a
    ragged edge, and over the VGA schedule's 8 classes with 768-wide cells:
    equal to its plain version and to K2, bit for bit, with no nonzero tap
    besides a row's or column's two."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_precomp_cuda as k2p

    images, boxes, sched, taps, tiles, planes = _k2p_case(card, *geometry)
    k2p.VIOLATIONS.clear()
    before = k2p.LAUNCHES
    got = k2p.resample_sched_precomp_cuda(planes, taps, tiles, sched)
    assert k2p.LAUNCHES == before + 1
    ref = windows_sched.resample_sched_precomp_plain(planes, taps, tiles, sched)
    k2 = windows_sched.extract_scheduled(images, boxes, sched)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, k2)
    assert k2p.violation_count() == 0


def test_k2p_counts_a_third_nonzero_tap(card):
    """A third nonzero planted in one RY row, two past the row's second
    tap: the kernel keeps the row's first two taps and counts the third
    as one violation."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_precomp_cuda as k2p

    _, _, sched, taps, tiles, planes = _k2p_case(card, 200, 300, 1.25, 1)
    ry, rx = taps[0]
    nz = (ry != 0).int()
    inside = nz[:, : ry.shape[1] - 3].sum(dim=1)
    row = int(torch.nonzero((inside == nz.sum(dim=1)) & (inside > 0))[0])
    lo = int(nz[row].argmax())
    planted = ry.clone()
    planted[row, lo + 3] = 0.5
    k2p.VIOLATIONS.clear()
    k2p.resample_sched_precomp_cuda(planes, [(planted, rx)] + taps[1:], tiles, sched)
    assert k2p.violation_count() == 1
    k2p.VIOLATIONS.clear()
    k2p.resample_sched_precomp_cuda(planes, taps, tiles, sched)
    assert k2p.violation_count() == 0


def test_train_step_on_card_matches_cpu(card):
    """A few f32 updates (TF32 off, dropout 1, no augmentation) of a small
    stage with a bottleneck input, on the card and on the CPU from the same
    parameters: losses within 1e-5 relative, parameters within 1e-5 + 1e-4
    relative (cuDNN and cuBLAS sum in other orders)."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.train import optimizer, train_step
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import set_numerics

    set_numerics(torch.float32)
    cfg = cnn.StageConfig(input_size=24, conv_filter_sizes=(8,), fc1_size=32,
                          bottleneck_in_size=16, compute_dtype=torch.float32)
    rng = np.random.RandomState(1)
    images = torch.as_tensor(rng.randint(0, 256, (64, 24, 24, 3)).astype(np.uint8))
    labels = torch.as_tensor((rng.rand(64) < 0.4).astype(np.int64))
    bneck = torch.as_tensor(rng.normal(0, 1, (64, 16)).astype(np.float32))
    mean, std = images.float().mean(0), images.float().std(0) + 1.0
    settings = train_step.LossSettings(f_beta=4.0, positive_proportion=0.4, weighted=True,
                                       normalize=False, l2_strength=0.0, l1_strength=0.0,
                                       dropout_keep=1.0)
    sched = optimizer.exponential_decay_staircase(0.01, 0.5, 2.0, 0.001)
    runs = {}
    for dev in (torch.device("cpu"), card):
        state = train_step.init_train_state(
            cfg, 3, lambda leaves: optimizer.make_optimizer(leaves, sched, cf.OPTIMIZER_MOMENTUM,
                                                            0.9), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        args = [t.to(dev) for t in (images, labels, bneck, mean, std)]
        losses = [float(train_step.train_step(state, cfg, settings, None, *args,
                                              torch.Generator().manual_seed(0), gen))
                  for _ in range(4)]
        runs[dev.type] = (losses, [t.detach().cpu().numpy()
                                   for t in train_step.param_leaves(state.params)])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
    for g, r in zip(runs["cuda"][1], runs["cpu"][1]):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
