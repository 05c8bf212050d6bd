"""Port vs JAX: the cascade's ingress format, saturation re-dispatch and
confidence modes, on small frames with a coarse pyramid (scale factor 1.3)
so the JAX reference compiles quickly. Parameters come from the JAX
``build_cascade_model(seed=0)`` through the bridge."""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as cf
from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.ops.color import rgb_to_yuv420
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade

import torch_parity as tp

torch.set_num_threads(2)

COARSE = {"window_scale_factor": 1.3}


def _scene(seed, h=64, w=80):
    return synthetic.make_scene(h, w, 1, seed=seed, min_face=24, max_face=40).image


@pytest.fixture(scope="module")
def models():
    tp.configure()
    return tp.jax_and_port_models(seed=0)


def test_detect_batch_yuv420_matches_jax(models):
    """Two YUV420 frames through one batched cascade (decode on the device)
    against the JAX YUV program."""
    tp.configure(**COARSE)
    frames = [rgb_to_yuv420(_scene(s)) for s in (4, 5)]
    ref = jcascade.CascadeDetector(models[0]).detect_batch_yuv420(frames)
    got = tcascade.CascadeDetector(models[1]).detect_batch_yuv420(frames)
    assert len(got) == 2
    for g, r in zip(got, ref):
        tp.assert_results_close(g, r)


def test_forced_saturation_matches_jax(models):
    """Threshold 0 keeps every window, so capacities [128, 128] overflow:
    the frame is re-dispatched with escalated capacities and the result
    equals the JAX detector's (which escalates the same way)."""
    tp.configure(
        foreground_confidence_threshold=0.0,
        cascade_capacity_schedule=[128, 128],
        **COARSE,
    )
    img = _scene(6, 40, 48)
    ref = jcascade.CascadeDetector(models[0]).detect(img)
    det = tcascade.CascadeDetector(models[1])
    got = det.detect(img)
    assert det.redispatches >= 1
    assert got.n_survivors_per_stage == [got.n_windows] * 3
    assert got.n_survivors_per_stage == ref.n_survivors_per_stage
    tp.assert_results_close(got, ref)


@pytest.mark.parametrize(
    "mode",
    [cf.FINAL_CONFIDENCE_CALCULATION_AVG, cf.FINAL_CONFIDENCE_CALCULATION_MULT],
)
def test_confidence_modes_match_jax(models, mode):
    tp.configure(final_confidence_calculation=mode, nms=cf.NMS_DISABLED, **COARSE)
    img = _scene(8)
    ref = jcascade.CascadeDetector(models[0]).detect(img)
    got = tcascade.CascadeDetector(models[1]).detect(img)
    assert len(got.raw_window_ids) > 0
    tp.assert_results_close(got, ref)
    if mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
        assert got.raw_confidences.min() >= cf.MIN_SCORE_FOR_FINAL_CONFIDENCE_CALCULATION_MULT - 1e-7
