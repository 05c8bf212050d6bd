"""Port vs JAX: the stage-0 extraction schedule and kernel K2's plain version.

K2 itself (csrc/sched.cu) runs only on a CUDA card (tests/test_torch_cuda.py).
On the CPU ``extract_scheduled`` runs the plain version, held here against
the jitted JAX ``extract_scheduled`` in interpret mode with the cascade's
arguments (``reorder=False, blockdiag=True``, bf16 out). Tolerance across
separately compiled programs, as tests/test_windows_sched.py states it:
|diff| <= 1 on at most 1e-3 of the values. Against the port's own K1 plain
version the real slots are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import pyramid as jpyramid
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows as jwin
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows_sched as jsched
from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid as tpyramid
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows as twin
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched as tsched
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_cuda

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

PLAN_192 = (192, 256, 1.05)


def _boxes(img_h, img_w, wsf):
    plan = jpyramid.build_plan(img_h, img_w, 12, 12, 0.075, wsf)
    return jpyramid.window_table(plan)["boxes_float"].astype(np.float32)


def _parity(got, ref, max_frac=1e-3):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    assert diff.max(initial=0.0) <= 1.0
    assert (diff > 0).mean() <= max_frac, (diff > 0).sum()


@pytest.fixture(scope="module")
def scene192():
    rng = np.random.RandomState(11)
    return rng.randint(0, 256, (2, 192, 256, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_scheduled(scene192):
    """The jitted JAX kernel (interpret mode) on frame 0 of the 192x256 plan,
    as the cascade calls it: scheduled order, bf16."""
    boxes = _boxes(*PLAN_192)
    sched = jsched.build_schedule(boxes, 192, 256, 12, 12)
    fn = jax.jit(
        lambda img, bx: jsched.extract_scheduled(
            img, bx, sched, interpret=True, reorder=False, blockdiag=True,
            out_dtype=jnp.bfloat16,
        )
    )
    return np.asarray(fn(jnp.asarray(scene192[0]), jnp.asarray(boxes)).astype(jnp.float32))


@pytest.mark.parametrize("geometry", [PLAN_192, (450, 450, 1.005)])
def test_schedule_arrays_equal_jax(geometry):
    img_h, img_w, wsf = geometry
    boxes = _boxes(img_h, img_w, wsf)
    ref = jsched.build_schedule(boxes, img_h, img_w, 12, 12)
    got = tsched.build_schedule(boxes, img_h, img_w, 12, 12)
    for key in ("img_h", "img_w", "h_pad", "w_pad", "out_h", "out_w", "tile", "n_windows"):
        assert getattr(got, key) == getattr(ref, key), key
    for key in ("order", "ids", "valid", "positions"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert len(got.classes) == len(ref.classes)
    for g, r in zip(got.classes, ref.classes):
        assert (g.cell_r, g.cell_c) == (r.cell_r, r.cell_c)
        np.testing.assert_array_equal(g.sel, r.sel)
        np.testing.assert_array_equal(g.offs, r.offs)
    table = got.tile_table()
    assert table.shape == (got.n_slots // got.tile, 4)
    assert ((table[:, 0] + table[:, 2]) <= got.h_pad).all()
    assert ((table[:, 1] + table[:, 3]) <= got.w_pad).all()


def test_schedule_for_plan_matches_jax_at_fddb_density():
    """The plan-keyed schedule of a 450x450 frame at scale factor 1.005:
    the slot count and classes the cascade consumes, cached per plan."""
    plan_j = jpyramid.build_plan(450, 450, 12, 12, 0.075, 1.005)
    plan_t = tpyramid.build_plan(450, 450, 12, 12, 0.075, 1.005)
    assert plan_t.n_windows == plan_j.n_windows == 131903
    assert plan_t.n_scales > 48
    got = tsched.schedule_for_plan(plan_t, 12, 12)
    assert got is tsched.schedule_for_plan(plan_t, 12, 12)
    ref = jsched.schedule_for_plan(plan_j, 12, 12)
    assert got.n_slots == ref.order.size == 132480
    assert [(c.cell_r, c.cell_c) for c in got.classes] == [
        (c.cell_r, c.cell_c) for c in ref.classes
    ]


def test_small_image_has_no_schedule():
    boxes = np.array([[0, 0, 20, 20]], np.float32)
    assert tsched.build_schedule(boxes, 100, 120, 12, 12) is None


def test_extract_scheduled_matches_jitted_jax(scene192, jax_scheduled):
    boxes = _boxes(*PLAN_192)
    sched = tsched.build_schedule(boxes, 192, 256, 12, 12)
    before = windows_sched_cuda.LAUNCHES
    got = tsched.extract_scheduled(torch.from_numpy(scene192), torch.from_numpy(boxes), sched)
    assert windows_sched_cuda.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (2, sched.n_slots, 12, 12, 3)
    _parity(got[0].float().numpy(), jax_scheduled)
    # frame 1 went through the same launch: equal to a one-frame call
    one = tsched.extract_scheduled(
        torch.from_numpy(scene192[1:]), torch.from_numpy(boxes), sched
    )
    torch.testing.assert_close(got[1], one[0], rtol=0, atol=0)


def test_reorder_round_trip_equals_k1_plain(scene192):
    """``reorder=True`` puts every window back in plan order, and there each
    window equals K1's plain version bit for bit (cell-local taps equal the
    global ones)."""
    boxes = _boxes(*PLAN_192)
    sched = tsched.build_schedule(boxes, 192, 256, 12, 12)
    frames = torch.from_numpy(scene192)
    scheduled = tsched.extract_scheduled(frames, torch.from_numpy(boxes), sched)
    ordered = tsched.extract_scheduled(frames, torch.from_numpy(boxes), sched, reorder=True)
    assert tuple(ordered.shape) == (2, len(boxes), 12, 12, 3)
    torch.testing.assert_close(
        ordered, scheduled[:, torch.as_tensor(sched.positions)], rtol=0, atol=0
    )
    k1 = twin.crop_and_resize_plain(frames, torch.from_numpy(boxes).expand(2, -1, 4), 12, 12)
    torch.testing.assert_close(ordered.float(), k1, rtol=0, atol=0)
    # pad slots replicate their group's last window
    pads = ~sched.valid
    torch.testing.assert_close(
        scheduled[:, torch.as_tensor(pads)],
        ordered[:, torch.as_tensor(sched.ids[pads])],
        rtol=0, atol=0,
    )


def test_power_of_two_boxes_bit_exact():
    """Boxes whose resize ratio is a power of two have exactly
    representable taps: equal to the jitted JAX ``crop_and_resize``."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(160, 256, 3)).astype(np.float32)
    n = 70
    sides = rng.choice([12, 24, 48], size=n)
    x0 = rng.randint(0, 200, n).astype(np.float32)
    y0 = rng.randint(0, 100, n).astype(np.float32)
    boxes = np.stack([x0, y0, x0 + sides, y0 + sides], 1).astype(np.float32)
    boxes[:, 2] = np.minimum(boxes[:, 2], 256)
    boxes[:, 3] = np.minimum(boxes[:, 3], 160)
    sched = tsched.build_schedule(boxes, 160, 256, 12, 12)
    got = tsched.extract_scheduled(
        torch.from_numpy(img)[None], torch.from_numpy(boxes), sched, reorder=True
    )[0].float().numpy()
    ref = np.asarray(jwin.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), out_h=12, out_w=12))
    np.testing.assert_array_equal(got, ref)


def test_kernel_entry_refuses_cpu_tensors():
    planes = torch.zeros((1, 3, 8, 8), dtype=torch.bfloat16)
    pos = torch.zeros((32, 12))
    tiles = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        windows_sched_cuda.resample_sched_cuda(planes, pos, pos, tiles, 32)
