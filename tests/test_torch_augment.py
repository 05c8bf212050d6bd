"""Port vs JAX: online augmentation with the same drawn values.

The two packages draw from different generators, so the port's functions
take their random values as arguments: here they are the values the JAX
functions draw from their keys (the same ``jax.random`` calls on the same
split keys), and the outputs are compared. Tolerance: atol 1e-5 in f32 on
[-1, 1] / [0, 1] images (other summation orders and transcendental
implementations).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import augment as jaug
from rapidobjectdetectionusingcascadedcnns_torch.ops import augment as taug

from torch_parity import jax_affine_draws as _jax_affine_draws
from torch_parity import jax_color_draws as _jax_color_draws
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)
ATOL = 1e-5
N, H, W = 6, 16, 16
KEYS = [jax.random.PRNGKey(s) for s in range(12)]
# the JAX functions jitted once each (eager lax.switch retraces per call)
_color = jax.jit(jaug.color_distort_planar, static_argnums=2)
_affine = jax.jit(jaug.affine_transforms, static_argnums=(2, 3, 4))
_augment = jax.jit(jaug.augment_batch, static_argnums=3)


def _configs():
    cont = dict(rotation_mode="DAO_ROTATION_MODE_CONTINUOUS", max_rotation_angle=20.0,
                max_foreground_rotation_angle=5.0)
    return [
        {},  # the defaults: horizontal flip and crop
        dict(vertical_flip=True, rotation_mode="DAO_ROTATION_MODE_90", crop_probability=0.0),
        dict(vertical_flip=True, allow_vertical_flip_foreground=True, **cont),
        dict(horizontal_flip=False, crop_probability=1.0, crop_min_percent=0.6, **cont),
    ]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (N, H, W, 3)).astype(np.float32)
    labels = np.array([1, 0, 1, 0, 0, 1], np.int32)
    return images, labels


@pytest.mark.parametrize("fast_mode", [False, True], ids=["four-orderings", "fast"])
def test_color_distortion_matches_jax(data, fast_mode):
    """Every ordering (the keys cover all branches) on a planar stack in
    [0, 1], and the hue round trip."""
    images, _ = data
    S = np.transpose(((images + 1.0) / 2.0).reshape(N, H * W, 3), (2, 0, 1))
    branches = set()
    for key in KEYS:
        draws = _jax_color_draws(key, fast_mode)
        branches.add(draws.branch)
        ref = _color(key, jnp.asarray(S), fast_mode)
        got = taug.color_distort_planar(torch.tensor(S), draws, fast_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert branches == set(range(2 if fast_mode else 4)), branches
    hsv = taug._rgb_to_hsv(*torch.tensor(S))
    ref_hsv = jaug._rgb_to_hsv_p(*jnp.asarray(S))
    for g, r in zip(hsv, ref_hsv):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    for g, r in zip(taug._hsv_to_rgb(*hsv), S):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)


def test_affine_transforms_match_jax(data):
    """The composed matrices of every flip/rotation/crop setting, with the
    foreground exemptions."""
    _, labels = data
    for kw in _configs():
        acfg = jaug.AugmentConfig(**kw)
        tcfg = taug.AugmentConfig(**kw)
        for key in KEYS[:2]:
            ref = _affine(key, jnp.asarray(labels), H, W, acfg)
            got = taug.affine_transforms(
                _jax_affine_draws(key, N, acfg), torch.tensor(labels), H, W, tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_affine_warp_matches_jax(data):
    """The two-tap warp with fixed matrices: identity (a bit-exact no-op),
    flips, a rotation, a zoom and a shift that leaves the image."""
    images, _ = data
    c, s = math.cos(0.3), math.sin(0.3)
    mats = np.stack([
        np.eye(3),
        [[-1, 0, W], [0, 1, 0], [0, 0, 1]],
        [[1, 0, 0], [0, -1, H], [0, 0, 1]],
        [[c, -s, 7.5 - 7.5 * c + 7.5 * s], [s, c, 7.5 - 7.5 * s - 7.5 * c], [0, 0, 1]],
        [[0.8, 0, 1.3], [0, 0.8, 2.1], [0, 0, 1]],
        [[1, 0, 5.5], [0, 1, -3.25], [0, 0, 1]],
    ]).astype(np.float32)
    ref = jaug._affine_warp_batch(jnp.asarray(images), jnp.asarray(mats))
    got = taug._affine_warp_batch(torch.tensor(images), torch.tensor(mats))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[0].numpy(), images[0])


@pytest.mark.parametrize("kw", _configs()[::3], ids=["defaults", "rotate-and-crop"])
def test_augment_batch_matches_jax(data, kw):
    """The whole chain with JAX's draws: color with the range shimmy, then
    the warp; with the color distortion off, the warp alone."""
    images, labels = data
    for color in (True, False):
        acfg = jaug.AugmentConfig(color_distortion=color, **kw)
        tcfg = taug.AugmentConfig(color_distortion=color, **kw)
        for key in KEYS[:2]:
            k_color, k_affine = jax.random.split(key)
            ref = _augment(key, jnp.asarray(images), jnp.asarray(labels), acfg)
            got = taug.augment_batch(
                torch.tensor(images), torch.tensor(labels), tcfg,
                _jax_color_draws(k_color, tcfg.color_fast_mode),
                _jax_affine_draws(k_affine, N, acfg))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the port's own draws: in range, reproducible from the generator's seed
    tcfg = taug.AugmentConfig(**kw)
    out = [taug.draw_and_augment(torch.Generator().manual_seed(9), torch.tensor(images),
                                 torch.tensor(labels), tcfg) for _ in range(2)]
    assert torch.equal(out[0], out[1]) and bool(torch.isfinite(out[0]).all())
    draws = taug.draw_affine(torch.Generator().manual_seed(1), 1000, tcfg)
    assert float(draws.crop_pct.min()) >= tcfg.crop_min_percent
    assert float(draws.crop_pct.max()) < tcfg.crop_max_percent
    assert abs(float(draws.crop.float().mean()) - tcfg.crop_probability) < 0.06
