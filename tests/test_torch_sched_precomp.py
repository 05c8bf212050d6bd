"""Port vs JAX: kernel K2p's tap matrices and its plain version.

K2p itself (csrc/sched_precomp.cu) runs only on a CUDA card
(tests/test_torch_cuda.py). Its TPU counterpart, the Pallas kernel of
``tools/profile_sched_precomp.py``, has no interpret mode, so the plain
version is held against what that kernel reproduces: the jitted JAX
``extract_scheduled`` (kernel K2, interpret mode). The tap matrices are
held against the tool's own ``precompute_weights``, plain jnp, jitted.
All comparisons are exact.
"""

import ctypes
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import pyramid as jpyramid
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows_sched as jsched
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched as tsched
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_precomp_cuda

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2,464 slots in 6 cell classes up to 256 x 512, a frame whose width is
# no multiple of the cells (taps past the image read zeros)
PLAN = (200, 300, 1.25)
# 2,084 windows in 2 classes: the JAX kernel in interpret mode takes about
# 2 s per class
PLAN_JAX = (128, 256, 1.15)
# 189 tiles in 8 classes with 768-wide cells; 93.1 MB of taps (the FDDB
# density's 1.6 GB stay off the CPU)
PLAN_VGA = (480, 640, 1.1)


def _load_jax_tool():
    """``tools/profile_sched_precomp.py`` as a module. Importing it points
    JAX's persistent compilation cache at ``RODC_JIT_CACHE`` (the test
    run's temporary directory, tests/conftest.py); the two settings are
    put back as they were."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        spec = importlib.util.spec_from_file_location(
            "profile_sched_precomp", os.path.join(REPO, "tools", "profile_sched_precomp.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@functools.lru_cache(maxsize=None)
def _geometry(plan_args):
    img_h, img_w, wsf = plan_args
    plan = jpyramid.build_plan(img_h, img_w, 12, 12, 0.075, wsf)
    boxes = jpyramid.window_table(plan)["boxes_float"].astype(np.float32)
    sched = tsched.build_schedule(boxes, img_h, img_w, 12, 12)
    frames = np.random.RandomState(11).randint(0, 256, (2, img_h, img_w, 3)).astype(np.float32)
    taps = tsched.precompute_tap_matrices(sched, torch.tensor(boxes))
    return boxes, sched, frames, taps


@pytest.fixture(scope="module")
def geometry():
    return _geometry(PLAN)


def test_tap_matrices_equal_the_jax_tools(geometry):
    boxes, sched, _, taps = geometry
    tool = _load_jax_tool()
    jsch = jsched.build_schedule(boxes, *PLAN[:2], 12, 12)
    # jitted, as the tool's extraction consumes them: the port's positions
    # follow the jitted rounding, and eager evaluation may round an ulp
    # differently (the tool: "bit-identical up to XLA fusion")
    ref = jax.jit(lambda b: tool.precompute_weights(b, jsch)[0])(jnp.asarray(boxes))
    assert tsched.tap_bytes(taps) == sum(m.size * 2 for pair in ref for m in pair)
    assert len(taps) == len(ref) == len(sched.classes) == 6
    for (ry, rx), (jry, jrx), cls in zip(taps, ref, sched.classes):
        assert ry.dtype == rx.dtype == torch.bfloat16
        assert ry.shape == (cls.n_tiles * sched.tile * 12, cls.cell_r)
        assert rx.shape == (cls.cell_c, cls.n_tiles * sched.tile * 12)
        np.testing.assert_array_equal(ry.float().numpy(), np.asarray(jry, np.float32))
        np.testing.assert_array_equal(rx.float().numpy(), np.asarray(jrx, np.float32))
        # a triangle row has at most two nonzero taps, adjacent
        nz = (ry != 0).sum(dim=1)
        assert int(nz.max()) <= 2 and int(nz.min()) >= 1


def test_plain_version_equals_the_jax_kernel():
    """Frame 0 through the port's plain K2p against the jitted JAX K2 in
    interpret mode (scheduled order, bf16), every slot equal."""
    boxes, sched, frames, taps = _geometry(PLAN_JAX)
    jsch = jsched.build_schedule(boxes, *PLAN_JAX[:2], 12, 12)
    ref = jax.jit(lambda img, bx: jsched.extract_scheduled(
        img, bx, jsch, interpret=True, reorder=False, blockdiag=True,
        out_dtype=jnp.bfloat16))(jnp.asarray(frames[0]), jnp.asarray(boxes))
    got = tsched.extract_scheduled_precomp(torch.tensor(frames[:1]), taps, sched)
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_plain_version_equals_k2s(geometry):
    """Both frames, K2p's plain version against K2's: equal bit for bit."""
    boxes, sched, frames, taps = geometry
    images = torch.tensor(frames)
    got = tsched.extract_scheduled_precomp(images, taps, sched)
    ref = tsched.extract_scheduled(images, torch.tensor(boxes), sched)
    assert got.shape == ref.shape == (2, sched.n_slots, 12, 12, 3)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


def test_wrapper_refuses_cpu_tensors(geometry):
    """The kernel wrapper launches on CUDA tensors only: a CPU tensor is
    refused, never run by the plain version behind the caller's back."""
    _, sched, frames, taps = geometry
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows

    planes = windows.to_planes_bf16(torch.tensor(frames))
    _, tiles, _ = sched.device_tables(torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        windows_sched_precomp_cuda.resample_sched_precomp_cuda(planes, taps, tiles, sched)
    assert windows_sched_precomp_cuda.LAUNCHES == 0
    with pytest.raises(ValueError, match="schedule built for"):
        tsched.extract_scheduled_precomp(torch.zeros((1, 64, 64, 3)), taps, sched)


def _bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _read(address, shape, strides):
    """uint16 values of host memory at ``address``, as the kernel's
    addresses reach them (strides in bytes)."""
    extent = sum((n - 1) * st for n, st in zip(shape, strides)) // 2 + 1
    flat = np.frombuffer((ctypes.c_uint16 * extent).from_address(address), np.uint16)
    return np.lib.stride_tricks.as_strided(flat, shape, strides)


def _block_operands(table, block, n_rows, n_cols):
    """What block ``block`` of K2p's launch reads, by the kernel's rule
    (csrc/sched_precomp.cu): its class is the last row whose first block
    is at most ``block``; it takes the tile ``tile0 + local``, the RY block
    ``n_rows`` rows of cell_r bf16 values on from ``ry + local * n_rows *
    cell_r`` values, and the RX rows of ``n_cols`` values from ``rx +
    local * n_cols`` values at RX's row stride."""
    k = int(np.searchsorted(table[:, 5], block, side="right")) - 1
    ry, rx, rx_stride, tile0, _, block0, cell_r, cell_c = (int(v) for v in table[k])
    local = block - block0
    return {"tile": tile0 + local, "ry": ry + 2 * local * n_rows * cell_r,
            "rx": rx + 2 * local * n_cols, "rx_stride_bytes": 2 * rx_stride,
            "cell_r": cell_r, "cell_c": cell_c}


def test_class_table_covers_every_tile_largest_first():
    """At the VGA geometry K2p's one launch numbers its blocks through the
    classes by tap bytes a tile, largest first: every tile exactly once,
    and each block's RY and RX addresses reach the values of slicing its
    class's matrices at the tile, with the tile table's cell."""
    _, sched, _, taps = _geometry(PLAN_VGA)
    n_rows, n_cols = sched.tile * 12, sched.tile * 12
    table = windows_sched_precomp_cuda.class_table(sched, taps)
    per_tile = n_rows * table[:, 6] + table[:, 7] * n_cols
    assert len(table) == len(sched.classes) == 8 and (np.diff(per_tile) <= 0).all()
    assert table[0, 7] == 768 and (table[:, 5] == np.cumsum(table[:, 4]) - table[:, 4]).all()
    cell_of = sched.tile_table()
    seen = []
    for block in range(sched.n_tiles):
        op = _block_operands(table, block, n_rows, n_cols)
        t = op["tile"]
        seen.append(t)
        k = next(i for i, c in enumerate(sched.classes) if c.sel[0] <= t <= c.sel[-1])
        cls, (ry, rx) = sched.classes[k], taps[k]
        assert (op["cell_r"], op["cell_c"]) == (cls.cell_r, cls.cell_c) == tuple(cell_of[t, 2:])
        i = t - int(cls.sel[0])
        np.testing.assert_array_equal(
            _read(op["ry"], (n_rows, cls.cell_r), (2 * cls.cell_r, 2)),
            _bf16_bits(ry[i * n_rows : (i + 1) * n_rows]))
        np.testing.assert_array_equal(
            _read(op["rx"], (cls.cell_c, n_cols), (op["rx_stride_bytes"], 2)),
            _bf16_bits(rx[:, i * n_cols : (i + 1) * n_cols]))
    assert sorted(seen) == list(range(sched.n_tiles))


def test_tap_matrices_have_two_adjacent_nonzeros():
    """K2p keeps a row's (column's) first nonzero tap and the one after it
    and counts any other: the matrices of ``precompute_tap_matrices`` never
    have another. At the 200x300 geometry and at VGA every RY row and RX
    column has one or two nonzeros, and two are adjacent."""
    for plan_args in (PLAN, PLAN_VGA):
        _, _, _, taps = _geometry(plan_args)
        for nz in [m for ry, rx in taps for m in (ry != 0, (rx != 0).t())]:
            count = nz.sum(dim=1)
            first = nz.int().argmax(dim=1)
            assert int(count.min()) >= 1 and int(count.max()) <= 2
            two = count == 2
            after = nz[two].gather(1, (first[two] + 1).clamp(max=nz.shape[1] - 1)[:, None])
            assert bool(after.all())
