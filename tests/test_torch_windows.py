"""Port vs JAX: stage-0 window extraction and kernel K1's plain version.

K1 itself (csrc/resample.cu) runs only on a CUDA card: its tests are in
tests/test_torch_cuda.py. On the CPU the wrapper runs the plain version,
which these tests hold bit-equal to the JAX XLA formulation
``_crop_and_resize_core`` as the jitted cascade runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import pyramid
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows as jwin
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows_pallas
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows as twin
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda

torch.set_num_threads(2)


def _boxes(rng, n, img_h, img_w, min_side=4, max_side=None):
    max_side = max_side or min(img_h, img_w)
    x0 = rng.uniform(0, img_w - min_side, n)
    y0 = rng.uniform(0, img_h - min_side, n)
    w = rng.uniform(min_side, max_side, n)
    h = rng.uniform(min_side, max_side, n)
    boxes = np.stack(
        [x0, y0, np.minimum(x0 + w, img_w), np.minimum(y0 + h, img_h)], axis=1
    ).astype(np.float32)
    boxes[: n // 4] = np.floor(boxes[: n // 4])  # integer boxes, like coords_norm
    return boxes


def _fractional_image(rng, h, w):
    """A float image with fractional values (like a decoded YUV420 frame)."""
    return (rng.rand(h, w, 3) * 255.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["u8", "fractional"])
def test_extract_windows_matches_jax(kind):
    """Gather-mode stage 0 in plan order. torch's antialiased bilinear and
    jax.image.resize differ by ~1e-4 before quantization, so a pixel on a
    u8 rounding tie may land one level away: <= 0.1% of values, by <= 1."""
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (64, 80, 3)).astype(np.float32)
    if kind == "fractional":
        img = _fractional_image(rng, 64, 80)
    plan = pyramid.build_plan(64, 80, 12, 12, 0.075, 1.1)
    ref = np.asarray(jwin.extract_windows(jnp.asarray(img), plan))
    batch = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    got = twin.extract_windows(batch, plan)
    assert tuple(got.shape) == (2, plan.n_windows, 12, 12, 3)
    diff = np.abs(got[0].numpy() - ref)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-3, (diff > 0).sum()
    ref1 = np.asarray(jwin.extract_windows(jnp.asarray(img[::-1].copy()), plan))
    assert (np.abs(got[1].numpy() - ref1) > 0).mean() <= 1e-3


@pytest.mark.parametrize("out", [24, 48])
def test_plain_bit_equal_to_xla_core(out):
    """K1's plain version == ``_crop_and_resize_core`` (high precision off)
    as the cascade program runs it, under jit, bit for bit, on a
    non-integer image."""
    rng = np.random.RandomState(out)
    img = _fractional_image(rng, 60, 80)
    boxes = _boxes(rng, 60, 60, 80)
    ref = np.asarray(
        jwin.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), out_h=out, out_w=out)
    )
    got = twin.crop_and_resize_plain(
        torch.from_numpy(img)[None], torch.from_numpy(boxes)[None], out, out
    )
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_plain_close_to_pallas_interpret():
    """Against the Pallas kernel run in interpret mode: within 1 on at most
    1e-4 of the values (the kernel's matmuls may sum in another order)."""
    rng = np.random.RandomState(1234)
    img = rng.randint(0, 256, size=(100, 120, 3)).astype(np.float32)
    boxes = _boxes(rng, 37, 100, 120)
    ref = np.asarray(
        windows_pallas.crop_and_resize_pallas(
            jnp.asarray(img), jnp.asarray(boxes), out_h=24, out_w=24, interpret=True
        )
    )
    got = twin.crop_and_resize_plain(
        torch.from_numpy(img)[None], torch.from_numpy(boxes)[None], 24, 24
    )[0].numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-4, (diff > 0).sum()


def test_high_precision_matches_xla_core():
    """The f32 path (no bf16 rounding) vs the HIGHEST-precision einsums:
    the same two products and one sum per pass, so float32 rounding only."""
    rng = np.random.RandomState(3)
    img = _fractional_image(rng, 50, 70)
    boxes = _boxes(rng, 40, 50, 70)
    ref = np.asarray(
        jwin.crop_and_resize(
            jnp.asarray(img), jnp.asarray(boxes), out_h=24, out_w=24,
            quantize=False, high_precision=True,
        )
    )
    got = twin.crop_and_resize_plain(
        torch.from_numpy(img)[None], torch.from_numpy(boxes)[None], 24, 24,
        quantize=False, high_precision=True,
    )
    np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-3)


def test_cpu_tensor_runs_plain_and_counts_no_launch():
    rng = np.random.RandomState(6)
    images = torch.from_numpy(np.stack([_fractional_image(rng, 40, 50) for _ in range(2)]))
    boxes = torch.from_numpy(np.stack([_boxes(rng, 9, 40, 50) for _ in range(2)]))
    before = windows_cuda.LAUNCHES
    got = twin.crop_and_resize_impl(images, boxes, 12, 12, False)
    assert windows_cuda.LAUNCHES == before
    ref = twin.crop_and_resize_plain(images, boxes, 12, 12)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for b in range(2):  # batching over frames == one frame at a time
        one = twin.crop_and_resize_plain(images[b : b + 1], boxes[b : b + 1], 12, 12)
        torch.testing.assert_close(got[b], one[0], rtol=0, atol=0)


def test_kernel_entry_refuses_cpu_tensors():
    planes = torch.zeros((1, 3, 8, 8), dtype=torch.bfloat16)
    pos = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError):
        windows_cuda.crop_and_resize_cuda(planes, pos, pos)
