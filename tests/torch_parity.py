"""Shared helpers of the port-vs-JAX tests (tests/test_torch_*.py).

The two packages keep separate configurations: ``configure`` sets each key
on both, and the autouse fixture ``reset_port_config`` (imported by every
port test module) restores the port's configuration after each test, as
tests/conftest.py does for the JAX package's. ``jax_color_draws`` and
``jax_affine_draws`` give the random values a JAX augmentation key draws,
in the port's draw types, so both packages can augment alike.
"""

import math

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.ops import augment as taug

# tests/test_golden.py's configuration: small nets, f32, NMS keeping singletons
GOLDEN_CFG = {
    "conv_filter_sizes": [8],
    "fc1_size": 32,
    "compute_dtype": "float32",
    "nms": jcf.NMS_OPENCV,
    "nms_opencv_min_neighbors": 0,
    "foreground_confidence_threshold": 0.5,
}
# the JAX package's CPU default resampler, named so a TPU run compares like
# with like; the port has no counterpart of it (its kernels are K1/K2/K4)
JAX_ONLY_CFG = {"use_pallas_resample": "xla"}
PROB_TOL = 2e-3  # the e2e oracle's borderline band |p - threshold| (NOTES.md)
MAX_FLIP_FRACTION = 0.02  # borderline flips allowed, as a share of survivors


@pytest.fixture(autouse=True)
def reset_port_config():
    yield
    tcf.reset()


def configure(**extra):
    """Set GOLDEN_CFG plus ``extra`` on both configurations (and the JAX
    package's resampler on its own)."""
    for key, value in {**GOLDEN_CFG, **extra}.items():
        jcf.set(key, value)
        tcf.set(key, value)
    for key, value in JAX_ONLY_CFG.items():
        jcf.set(key, value)


def jax_and_port_models(seed=0):
    """The JAX ``build_cascade_model(seed)`` and its converted port copy on
    the CPU."""
    jmodel = jcascade.build_cascade_model(seed=seed)
    tmodel = bridge.cascade_model_from_jax_arrays(
        jmodel.stage_params, jmodel.stage_configs, jmodel.stage_means, jmodel.stage_stds,
        device="cpu",
    )
    return jmodel, tmodel


def assert_results_close(got, ref):
    """Same window count; survivor ids equal up to borderline flips (at most
    2% of survivors); confidences of common survivors within the borderline
    band; NMS boxes within 2 px."""
    assert got.n_windows == ref.n_windows
    ids_g = dict(zip(got.raw_window_ids.tolist(), got.raw_confidences.tolist()))
    ids_r = dict(zip(ref.raw_window_ids.tolist(), ref.raw_confidences.tolist()))
    flips = set(ids_g) ^ set(ids_r)
    assert len(flips) <= MAX_FLIP_FRACTION * max(len(ids_r), 1), sorted(flips)
    common = sorted(set(ids_g) & set(ids_r))
    if common:
        err = max(abs(ids_g[i] - ids_r[i]) for i in common)
        assert err < PROB_TOL, err
    assert len(got.boxes) == len(ref.boxes)
    if len(ref.boxes):
        np.testing.assert_allclose(
            np.asarray(sorted(map(tuple, got.boxes.tolist()))),
            np.asarray(sorted(map(tuple, ref.boxes.tolist()))),
            atol=2.0,
        )


def jax_color_draws(key, fast_mode):
    """The values ``jaug.color_distort_planar(key, ...)`` draws."""
    keys = jax.random.split(key, 5)
    sel = int(jax.random.randint(keys[0], (), 0, 2 if fast_mode else 4))
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo, maxval=hi))  # noqa: E731
    return taug.ColorDraws(
        branch=sel,
        brightness_delta=u(keys[1], -32.0 / 255.0, 32.0 / 255.0),
        saturation_factor=u(keys[2], 0.5, 1.5),
        hue_delta=u(keys[3], -0.2, 0.2),
        contrast_factor=u(keys[4], 0.5, 1.5),
    )


def jax_affine_draws(key, n, acfg):
    """The values ``jaug.affine_transforms(key, ...)`` draws."""
    k_h, k_v, k_rot, k_rot_fg, k_pct, k_l, k_t, k_coin = jax.random.split(key, 8)
    u = lambda k, lo=0.0, hi=1.0: torch.tensor(np.asarray(  # noqa: E731
        jax.random.uniform(k, (n,), minval=lo, maxval=hi)))
    base = acfg.max_rotation_angle / 180.0 * math.pi
    fg_max = (acfg.max_foreground_rotation_angle or 0.0) / 180.0 * math.pi
    return taug.AffineDraws(
        hflip=u(k_h) < 0.5,
        vflip=u(k_v) < 0.5,
        quarter_turns=torch.tensor(np.asarray(jax.random.randint(k_rot, (n,), 0, 4))).long(),
        angles=u(k_rot, -base, base),
        fg_angles=u(k_rot_fg, -fg_max, fg_max),
        crop_pct=u(k_pct, acfg.crop_min_percent, acfg.crop_max_percent),
        crop_left=u(k_l),
        crop_top=u(k_t),
        crop=u(k_coin) < acfg.crop_probability,
    )
