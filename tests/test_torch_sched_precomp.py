"""Port vs JAX: kernel K2p's tap matrices and its plain version.

K2p itself (csrc/sched_precomp.cu) runs only on a CUDA card
(tests/test_torch_cuda.py). Its TPU counterpart, the Pallas kernel of
``tools/profile_sched_precomp.py``, has no interpret mode, so the plain
version is held against what that kernel reproduces: the jitted JAX
``extract_scheduled`` (kernel K2, interpret mode). The tap matrices are
held against the tool's own ``precompute_weights``, plain jnp, jitted.
All comparisons are exact.
"""

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
