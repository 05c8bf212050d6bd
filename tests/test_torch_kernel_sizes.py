"""Sizes the port's kernels ask of the card, computed on the host: K3's
workspace grows with B * N (no adjacency is stored), the launch geometries
of K1, K2, K2p and K4 fit a Hopper block's shared memory at the cascade's
window sizes, and K2's staged support covers all but a few tiles of an
FDDB-density schedule."""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch.ops import (
    nms_cuda,
    pyramid,
    windows_cuda,
    windows_dyn_cuda,
    windows_sched,
    windows_sched_cuda,
    windows_sched_precomp_cuda,
)

BLOCK_LIMIT = 227 * 1024  # dynamic shared memory one block may have on Hopper
SM_LIMIT = 228 * 1024  # shared memory of one SM; each block also reserves 1 KB


def test_k3_workspace_is_linear_in_rows():
    """At the dense path's open rung (4 frames x 131,903 rows) the
    workspace stays under 64 MB, and doubling N doubles it."""
    at_open_rung = nms_cuda.workspace_bytes(4, 131903)
    assert at_open_rung < 64 * 2**20
    assert nms_cuda.workspace_bytes(4, 2 * 131903) - 4 == 2 * (at_open_rung - 4)
    assert nms_cuda.workspace_bytes(8, 131903) - 4 == 2 * (at_open_rung - 4)


def test_k1_launch_geometry_fits_shared_memory():
    """Boxes per block and the shared memory they take (output tile,
    bf16 intermediate, taps) at 12, 24 and 48 px with 3 channels: whole
    boxes, within the 227 KB a block may have, and each box's output a
    multiple of 16 bytes (the bulk store's unit). Above 97 px a box is
    banded: one box a block, a band of rows sized for 3 blocks an SM (299
    px: 10 rows, 76,784 B). A window whose single row does not fit
    raises."""
    for size, per_block in ((12, 5), (24, 2), (48, 1)):
        got_per_block, band, smem = windows_cuda.launch_geometry(size, size, 3)
        assert (got_per_block, band) == (per_block, size)
        assert smem == per_block * (8 * size * size * 3 + 40 * size)
        assert smem <= 227 * 1024
        assert (size * size * 3 * 4) % 16 == 0
    assert windows_cuda.launch_geometry(97, 97, 3)[:2] == (1, 97)
    for size in range(98, 300):
        per_block, band, smem = windows_cuda.launch_geometry(size, size, 3)
        assert per_block == 1 and 1 <= band < size
        assert smem == band * (8 * size * 3 + 24) + 16 * size
        assert 3 * (smem + 1024) <= SM_LIMIT
    assert windows_cuda.launch_geometry(299, 299, 3) == (1, 10, 76784)
    with pytest.raises(ValueError, match="shared-memory limit"):
        windows_cuda.launch_geometry(8, 8000, 4)


@pytest.mark.parametrize("c", [1, 3])
def test_k4_launch_geometry_fits_shared_memory(c):
    """Slots per block (5, 2, 1 at 12, 24, 48 px with 3 channels, at least
    2,048 output values a block) and the shared memory they take (bf16
    output tile, bf16 intermediate, tables): within 227 KB, and each slot's
    bf16 output a multiple of 16 bytes, so the block's tile leaves with one
    bulk store. A window too large to stage raises."""
    for size, per_block_rgb in ((12, 5), (24, 2), (48, 1)):
        per_slot = size * size * c
        per_block, smem = windows_dyn_cuda.launch_geometry(size, size, c)
        if c == 3:
            assert per_block == per_block_rgb
        assert per_block * per_slot >= min(2048, per_slot)
        assert (per_block - 1) * per_slot < 2048
        assert smem == per_block * (6 * per_slot + 24 * size + 16 * size + 4)
        assert smem <= BLOCK_LIMIT
        assert (2 * per_slot) % 16 == 0
    with pytest.raises(ValueError):
        windows_dyn_cuda.launch_geometry(128, 128, 3)


def test_k2_launch_geometry_fits_shared_memory():
    """K2's shared memory at the schedule's tile for 12, 24 and 48 px
    windows with 1 and 3 channels fits 227 KB with a budget that is a
    multiple of 16 bytes; at stage 0's 12 px RGB (tile 32) the budget is
    the full 64 KB and two blocks share an SM. A tile too large raises."""
    for size in (12, 24, 48):
        tile = windows_sched._tile_windows(size, size)
        for c in (1, 3):
            smem, budget = windows_sched_cuda.launch_geometry(tile, size, size, c)
            assert smem <= BLOCK_LIMIT
            assert 0 <= budget <= windows_sched_cuda.STAGING_BUDGET and budget % 16 == 0
            assert (2 * tile * size * size * c) % 16 == 0  # the bulk store's unit
    smem, budget = windows_sched_cuda.launch_geometry(32, 12, 12, 3)
    assert budget == 65536
    assert 2 * (smem + 1024) <= SM_LIMIT
    with pytest.raises(ValueError):
        windows_sched_cuda.launch_geometry(4, 96, 96, 4)


def test_k2_staging_fits_fddb_density():
    """Over the FDDB-density schedule (450x450, scale factor 1.005, 4,140
    tiles of 32 windows) the compacted support of a tile is at most 79,350
    bytes and at most 0.1% of the tiles exceed the 64 KB budget (they are
    sampled from the planes). On a sample of tiles the count equals the
    distinct rows and columns that the plain version's non-zero taps
    read."""
    plan = pyramid.build_plan(450, 450, 12, 12, 0.075, 1.005)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"])
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, torch.device("cpu"))
    sizes = windows_sched_cuda.staging_bytes(sy, sx, tiles, sched.tile, 3, 450, 450)
    _, budget = windows_sched_cuda.launch_geometry(sched.tile, 12, 12, 3)
    assert sizes.shape == (sched.n_tiles,) == (4140,)
    assert sizes.min() > 0 and sizes.max() <= 79350
    assert np.mean(sizes > budget) <= 0.001

    per_slot = torch.repeat_interleave(tiles.long(), sched.tile, dim=0)
    for t in np.random.RandomState(0).choice(sched.n_tiles, 40, replace=False):
        sl = slice(t * sched.tile, (t + 1) * sched.tile)
        used = []
        for s, lo, size, bound in ((sy[sl], per_slot[sl, 0:1], 450, per_slot[sl, 2:3]),
                                   (sx[sl], per_slot[sl, 1:2], 450, per_slot[sl, 3:4])):
            taps = windows_sched._bounded_taps(s, lo, size, bound)
            used.append(len(set(torch.cat([g[w > 0] for g, w in taps]).tolist())))
        assert sizes[t] == used[0] * used[1] * 3 * 2, t


def test_k2p_launch_geometry_fits_shared_memory():
    """K2p's block is K2's with the ring's barriers and its violation
    count (56 bytes more at 3 ring stages): within 227 KB at FDDB density
    (450x450, scale factor 1.005) and at VGA (480x640, 1.1), with two
    blocks an SM at FDDB density. Its ring of 3 stages of 31,056 bytes
    fills the output tile and the 64 KB staging budget, and a stage holds
    whole RY rows and RX rows of every cell class."""
    for h, w, wsf in ((450, 450, 1.005), (480, 640, 1.1)):
        sched = windows_sched.schedule_for_plan(pyramid.build_plan(h, w, 12, 12, 0.075, wsf), 12, 12)
        smem, budget, stage = windows_sched_precomp_cuda.launch_geometry(sched.tile, 12, 12, 3)
        k2_smem, k2_budget = windows_sched_cuda.launch_geometry(sched.tile, 12, 12, 3)
        assert (smem, budget) == (k2_smem + 56, k2_budget) and smem <= BLOCK_LIMIT
        ring = 2 * sched.tile * 12 * 12 * 3 + budget
        assert stage == 31056 and stage % 16 == 0 and budget == 65536
        assert ring - 16 * 3 < windows_sched_precomp_cuda.STAGES * stage <= ring
        for cls in sched.classes:
            assert 2 * max(cls.cell_r, sched.tile * 12) <= stage and cls.cell_r % 8 == 0
            assert (2 * sched.tile * 12) % 16 == 0  # an RX row is a bulk copy
        if h == 450:
            assert 2 * (smem + 1024) <= SM_LIMIT
