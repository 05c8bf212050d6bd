"""Dynamic-batch serving bundles of the port: one ``torch.export`` program
per rung with a symbolic frame count, against the port's live detector
(frame for frame, bit for bit) and against the JAX package's dynamic
bundle. Weights come from the JAX ``build_cascade_model`` through the
bridge, never re-drawn.

The stage CNNs run in chunks of ``inference_chunk_size`` rows; it is cut
to 4,000 here so that chunks straddle frames (3,344 windows a frame), as
the VGA path's 16,384-row chunks straddle its 5,061-window frames."""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu import serve as jserve
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CAPS = [8, 8]  # tests/test_serve.py::test_bundle_dynamic_batch's ladder
N_RUNGS = 4  # enough for these frames: at most 499 and 330 survivors


def _cfg():
    tp.configure(nms_opencv_min_neighbors=1, nms_on_device=True, inference_batch_frames=2,
                 inference_chunk_size=4000)


def _frames(n=5):
    return [
        synthetic.make_scene(100, 120, n_faces=1, seed=s, min_face=40, max_face=60).image
        for s in range(n)
    ]


def _assert_same(a, b):
    np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
    np.testing.assert_array_equal(a.raw_boxes, b.raw_boxes)
    np.testing.assert_array_equal(a.raw_confidences, b.raw_confidences)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.confidences, b.confidences)
    assert a.n_survivors_per_stage == b.n_survivors_per_stage


@pytest.fixture(scope="module")
def models():
    _cfg()
    return tp.jax_and_port_models(seed=0)


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    """The live detector's results on 5 frames (with its re-dispatches),
    the dynamic bundle exported, saved and loaded, and its results on the
    same frames with every program call recorded."""
    _cfg()
    model = models[1]
    det = tcascade.CascadeDetector(model, capacity_schedule=CAPS)
    live = det.detect_batch(_frames())
    bundle = tserve.export_detector(model, 100, 120, batch="dynamic", capacities=CAPS,
                                    n_rungs=N_RUNGS)
    path = str(tmp_path_factory.mktemp("dynamic_bundle"))
    tserve.save_bundle(bundle, path)
    tcf.reset()
    loaded = tserve.load_bundle(path, device="cpu")
    calls = []
    dispatch = loaded._dispatch_rung

    def spy(rung, frames):
        calls.append((rung, len(frames)))
        return dispatch(rung, frames)

    loaded._dispatch_rung = spy
    results = loaded.detect_batch(_frames())
    loaded._dispatch_rung = dispatch
    return {"bundle": bundle, "loaded": loaded, "live": live, "served": results,
            "calls": calls, "redispatches": det.redispatches}


def test_dynamic_bundle_equals_live_detector(served):
    """Frame for frame, bit for bit, with chunks of rows that straddle
    frames; every frame saturates rung 0 and walks the ladder."""
    assert served["redispatches"] == 15  # 3 escalations for each of the 5 frames
    for a, b in zip(served["live"], served["served"]):
        _assert_same(a, b)
        assert not any(s > c for s, c in zip(b.n_survivors_per_stage, [512, 512]))
    assert all(len(r.boxes) for r in served["served"])


def test_dynamic_bundle_matches_jax_dynamic_bundle(models, served, tmp_path):
    """The JAX package's dynamic bundle of the same weights, at capacities
    no frame saturates (its ladder would compile a program per rung and
    frame count), against the port's ladder walk: both are the unbounded
    survivor sets, within the port-vs-JAX tolerances."""
    _cfg()
    bundle = jserve.export_detector(models[0], 100, 120, batch="dynamic",
                                    capacities=[1024, 512], n_rungs=1)
    assert bundle.meta["batch"] == "dynamic"
    jserve.save_bundle(bundle, str(tmp_path))
    jax_served = jserve.load_bundle(str(tmp_path)).detect_batch(_frames(4))
    jcf.reset()
    for a, b in zip(served["served"], jax_served):
        tp.assert_results_close(a, b)


def test_one_program_serves_1_2_and_5_frames(served):
    """The loaded rung-0 program takes 1 and 2 frames in one call (no
    padding) and refuses 3 (its bound), and ``detect_batch`` serves 1, 2
    and (in the fixture) 5 frames through it, each equal to the live
    detector."""
    loaded, live = served["loaded"], served["live"]
    frames = _frames()
    weights = loaded._weights
    for n in (1, 2):
        rows = loaded._modules[0](torch.as_tensor(np.stack(frames[:n])), weights)
        assert rows.shape[0] == n
    with pytest.raises(Exception):  # the bound of the symbolic frame count
        loaded._modules[0](torch.as_tensor(np.stack(frames[:3])), weights)
    for n in (1, 2):
        for a, b in zip(live[:n], loaded.detect_batch(frames[:n])):
            _assert_same(a, b)
    assert len(served["served"]) == 5  # the fixture's 5 frames, through the same program


def test_saturated_frame_is_rerun_alone(served):
    """Chunks of ``chunk_hint`` frames with no padding (2, 2, 1), and each
    saturated frame re-run as a batch of one at every rung it climbs."""
    calls = served["calls"]
    assert [n for rung, n in calls if rung == 0] == [2, 2, 1]
    reruns = [(rung, n) for rung, n in calls if rung > 0]
    assert reruns == [(1, 1), (2, 1), (3, 1)] * 5


def test_dynamic_meta(served):
    meta = served["bundle"].meta
    assert meta["batch"] == "dynamic"
    assert meta["chunk_hint"] == 2 and meta["max_batch"] == 2  # inference_batch_frames
    assert meta["capacity_rungs"] == [CAPS, [128, 128], [256, 256], [512, 512]]
    assert meta["platforms"] == ["cpu"] and meta["export_device"] == "cpu"
    targets = [str(n.target) for n in served["loaded"].programs[0].graph.nodes
               if n.op == "call_function"]
    assert targets.count("rodc.resample.default") == 2 and targets.count(
        "rodc.cluster.default") == 1
