"""Port vs JAX: YUV420 decode (device) and encode (host)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic
from rapidobjectdetectionusingcascadedcnns_tpu.ops import color as jcolor
from rapidobjectdetectionusingcascadedcnns_torch.ops import color as tcolor

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(8, 10), (64, 80)])
def test_yuv420_to_rgb_matches_jax(shape):
    """Batched decode vs the per-frame JAX decoder: f32 values (not u8)
    within 1e-4 -- the same lerps and coefficients, rounded per op."""
    rng = np.random.RandomState(2)
    h, w = shape
    ys = rng.randint(0, 256, (3, h, w)).astype(np.uint8)
    uvs = rng.randint(0, 256, (3, h // 2, w // 2, 2)).astype(np.uint8)
    got = tcolor.yuv420_to_rgb(torch.from_numpy(ys), torch.from_numpy(uvs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, h, w, 3)
    for i in range(3):
        ref = np.asarray(jax.jit(jcolor.yuv420_to_rgb)(jnp.asarray(ys[i]), jnp.asarray(uvs[i])))
        np.testing.assert_allclose(got[i].numpy(), ref, atol=1e-4)
    single = tcolor.yuv420_to_rgb(torch.from_numpy(ys[0]), torch.from_numpy(uvs[0]))
    torch.testing.assert_close(single, got[0], rtol=0, atol=0)


def test_rgb_to_yuv420_equals_jax_encoder():
    rgb = synthetic.make_scene(48, 64, 1, seed=4, min_face=20, max_face=30).image
    y_t, uv_t = tcolor.rgb_to_yuv420(rgb)
    y_j, uv_j = jcolor.rgb_to_yuv420(rgb)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(uv_t, uv_j)
    assert y_t.dtype == np.uint8 and uv_t.shape == (24, 32, 2)


def test_yuv420_rejects_odd_planes():
    with pytest.raises(ValueError):
        tcolor.yuv420_to_rgb(
            torch.zeros((1, 8, 10), dtype=torch.uint8),
            torch.zeros((1, 3, 5, 2), dtype=torch.uint8),
        )
