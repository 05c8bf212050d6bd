"""One image's windows sharded over a 4-shard CPU mesh
(``parallel/window_shard.detect_window_sharded``) against the port's
single-device ``detect`` and the JAX package's ``detect_window_sharded``
on a JAX ``get_mesh(4)``, in both stage-0 extraction modes, with
saturation re-dispatch on and off, and in every confidence mode. Weights
come from the JAX tree through the bridge."""

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.parallel import mesh as jmesh
from rapidobjectdetectionusingcascadedcnns_tpu.parallel import window_shard as jws
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.parallel import mesh as tmesh
from rapidobjectdetectionusingcascadedcnns_torch.parallel import window_shard as tws
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

MESH = ("cpu",) * 4
# the 2,838 windows of a 64x96 frame at scale factor 1.05; with re-dispatch
# off the survivors overflow the [256, 128] buffers and are truncated
BASE_CFG = dict(window_scale_factor=1.05, nms_opencv_min_neighbors=1)
CASES = {
    "crop, re-dispatch": dict(window_extraction_mode="crop", cascade_saturation_redispatch=True),
    "crop, truncated": dict(window_extraction_mode="crop", cascade_saturation_redispatch=False,
                            cascade_capacity_schedule=[256, 128]),
    "gather, re-dispatch": dict(window_extraction_mode="gather",
                                cascade_saturation_redispatch=True),
    "gather, truncated": dict(window_extraction_mode="gather", cascade_saturation_redispatch=False,
                              cascade_capacity_schedule=[256, 128]),
}
# the port and the JAX package run other convolution and matrix-product
# code, so their confidences agree within the parity band of the other
# port-vs-JAX tests (torch_parity.PROB_TOL); the port's window-sharded run
# and its single-device run share the code, and agree within the 2 float32
# ulps that the JAX module allows for gather mode (window_shard.py:29-33)
PORT_ULPS = 2


def _frame():
    return synthetic.make_scene(64, 96, 1, seed=5, min_face=24, max_face=40).image


@pytest.fixture(scope="module")
def models():
    """The JAX cascade and its port copy, and each case's JAX
    window-sharded detection on a 4-device JAX mesh."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual JAX devices")
    # from the defaults: a module fixture runs before conftest's per-test
    # restore, which brings back whatever the process's first test module
    # had set when it took its snapshot
    jcf.reset()
    tcf.reset()
    tp.configure(**BASE_CFG)
    jmodel, tmodel = tp.jax_and_port_models(seed=0)
    refs = {}
    for name, case in CASES.items():
        tp.configure(**BASE_CFG, **case)
        refs[name] = jws.detect_window_sharded(
            jcascade.CascadeDetector(jmodel), _frame(), jmesh.get_mesh(4))
    jcf.reset()
    tcf.reset()
    return tmodel, refs


def _assert_same_windows(got, ref, conf_tol):
    assert got.n_windows == ref.n_windows
    assert got.n_survivors_per_stage == ref.n_survivors_per_stage
    order_g, order_r = np.argsort(got.raw_window_ids), np.argsort(ref.raw_window_ids)
    np.testing.assert_array_equal(got.raw_window_ids[order_g], ref.raw_window_ids[order_r])
    np.testing.assert_array_equal(got.raw_boxes[order_g], ref.raw_boxes[order_r])
    np.testing.assert_allclose(got.raw_confidences[order_g], ref.raw_confidences[order_r],
                               rtol=0, atol=conf_tol)
    assert sorted(map(tuple, got.boxes.tolist())) == sorted(map(tuple, ref.boxes.tolist()))


def _ulps(values):
    return PORT_ULPS * np.spacing(np.float32(max(1.0, float(np.max(values, initial=0.0)))))


@pytest.mark.parametrize("name", list(CASES))
def test_window_sharded_matches_one_device_and_jax(models, name):
    """Survivors, window ids, integer boxes and NMS boxes equal the port's
    single-device ``detect`` and the JAX window-sharded detection; with
    re-dispatch off the truncation warns, as in the JAX package."""
    tmodel, refs = models
    tp.configure(**BASE_CFG, **CASES[name])
    det = tcascade.CascadeDetector(tmodel)
    single = det.detect(_frame())
    before = len(tlog.log_lines())
    got = tws.detect_window_sharded(det, _frame(), MESH)
    warned = "saturated" in "\n".join(tlog.log_lines()[before:])
    assert warned == (not CASES[name]["cascade_saturation_redispatch"])
    if warned:
        assert det._is_saturated(got.n_survivors_per_stage, [256, 128])
        assert len(got.raw_window_ids) <= 128
    _assert_same_windows(got, single, _ulps(single.raw_confidences))
    _assert_same_windows(got, refs[name], tp.PROB_TOL)


def test_confidence_modes_and_k4_setting(models):
    """The AVG and MULT confidence modes equal the single-device detector,
    and ``dyn_reextract="on"`` changes nothing on this path: the
    window-sharded cascade re-extracts with K1, as the JAX package routes
    its K4 setting to the v1 kernel here."""
    tmodel, _ = models
    mesh = tmesh.get_mesh(devices=MESH)
    for mode in (tcf.FINAL_CONFIDENCE_CALCULATION_AVG, tcf.FINAL_CONFIDENCE_CALCULATION_MULT):
        tp.configure(**BASE_CFG, **CASES["crop, re-dispatch"], final_confidence_calculation=mode)
        det = tcascade.CascadeDetector(tmodel)
        single = det.detect(_frame())
        got = tws.detect_window_sharded(det, _frame(), mesh)
        _assert_same_windows(got, single, _ulps(single.raw_confidences))
        tcf.set("dyn_reextract", "on")
        dyn = tws.detect_window_sharded(det, _frame(), mesh)
        np.testing.assert_array_equal(dyn.raw_window_ids, got.raw_window_ids)
        np.testing.assert_array_equal(dyn.raw_confidences, got.raw_confidences)
        assert dyn.reextract_overflows == [0, 0]
