"""The port's serving path: the on-device NMS tail of ``CascadeDetector``
(``nms_on_device``, kernel K3's plain version here) and serving bundles
through ``torch.export``, against the JAX package and against the port's
own live detector. Weights come from the JAX ``build_cascade_model``
through the bridge, never re-drawn.

Exports in this file: a port RGB bundle, a port YUV ladder bundle and a
JAX bundle (one each, module-scoped)."""

import os

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu import serve as jserve
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda, windows_cuda
from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CAPS = [1024, 512]  # the JAX bundle test's capacities: no frame saturates them
LADDER_CAPS = [128, 64]  # the 64x80 ladder frame saturates rungs 0 and 1


def _serve_cfg(**extra):
    settings = {"nms_opencv_min_neighbors": 1, "nms_on_device": True, "inference_batch_frames": 2}
    tp.configure(**{**settings, **extra})


def _frames():
    return [
        synthetic.make_scene(100, 120, n_faces=1, seed=s, min_face=40, max_face=60).image
        for s in range(3)
    ]


def _box_set(boxes):
    return sorted(map(tuple, np.asarray(boxes).tolist()))


def _assert_same(a, b):
    np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
    np.testing.assert_array_equal(a.raw_boxes, b.raw_boxes)
    np.testing.assert_array_equal(a.raw_confidences, b.raw_confidences)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.confidences, b.confidences)
    assert a.n_survivors_per_stage == b.n_survivors_per_stage


@pytest.fixture(scope="module")
def models():
    _serve_cfg()
    return tp.jax_and_port_models(seed=0)


@pytest.fixture(scope="module")
def rgb_bundle(models, tmp_path_factory):
    """A port bundle (RGB, batch 2, CAPS, one rung), saved and loaded, and
    the live port detector's results on the same frames."""
    _serve_cfg()
    model = models[1]
    live = tcascade.CascadeDetector(model, capacity_schedule=CAPS).detect_batch(_frames())
    bundle = tserve.export_detector(model, 100, 120, batch=2, capacities=CAPS, n_rungs=1)
    path = str(tmp_path_factory.mktemp("port_bundle"))
    tserve.save_bundle(bundle, path)
    tcf.reset()
    return bundle, path, live


@pytest.fixture(scope="module")
def jax_bundle(models, tmp_path_factory):
    """The JAX package's bundle of the same weights and knobs, and its
    served results."""
    _serve_cfg()
    bundle = jserve.export_detector(models[0], 100, 120, batch=2, capacities=CAPS, n_rungs=1)
    path = str(tmp_path_factory.mktemp("jax_bundle"))
    jserve.save_bundle(bundle, path)
    served = jserve.load_bundle(path).detect_batch(_frames())
    jcf.reset()
    return path, served


SCENES = [  # tests/test_device_nms.py's scenes, and one YUV frame
    ("rgb", dict(seed=3, min_face=40, max_face=60), {"nms_opencv_min_neighbors": 1}),
    ("rgb", dict(seed=5, min_face=40, max_face=50),
     {"nms_opencv_min_neighbors": 0, "vertically_enlarge_bboxes": True}),
    ("yuv", dict(seed=7, min_face=40, max_face=50), {"nms_opencv_min_neighbors": 1}),
]


@pytest.mark.parametrize("kind, scene, settings", SCENES)
def test_cascade_tail_matches_jax_and_host_nms(models, kind, scene, settings):
    """The port's detector with the device tail against the JAX detector
    with its tail, and against the port's own host NMS on the same raw
    survivors (exactly)."""
    jmodel, tmodel = models
    tp.configure(nms_on_device=True, **settings)
    image = synthetic.make_scene(100, 100, n_faces=1, **scene).image
    tdet, jdet = tcascade.CascadeDetector(tmodel), jcascade.CascadeDetector(jmodel)
    before = nms_cuda.LAUNCHES
    if kind == "yuv":
        frame = rgb_to_yuv420(image)
        got, ref = tdet.detect_batch_yuv420([frame])[0], jdet.detect_batch_yuv420([frame])[0]
    else:
        got, ref = tdet.detect(image), jdet.detect(image)
    assert nms_cuda.LAUNCHES == before  # CPU tensors: the plain version
    assert len(got.boxes) > 0
    tp.assert_results_close(got, ref)
    np.testing.assert_allclose(np.sort(got.confidences), np.sort(ref.confidences))

    tcf.set("nms_on_device", False)
    host = tdet.detect_batch_yuv420([frame])[0] if kind == "yuv" else tdet.detect(image)
    np.testing.assert_array_equal(host.raw_window_ids, got.raw_window_ids)
    assert _box_set(host.boxes) == _box_set(got.boxes)
    np.testing.assert_array_equal(np.sort(host.confidences), np.sort(got.confidences))


def test_bundle_matches_live_detector_config_free(rgb_bundle):
    """A loaded bundle equals the live detector with every config knob the
    program or the decoder could read set to a wrong value first."""
    bundle, path, live = rgb_bundle
    served_det = tserve.load_bundle(path, device="cpu")
    tcf.set("foreground_confidence_threshold", 0.99)
    tcf.set("nms_opencv_min_neighbors", 5)
    tcf.set("nms_opencv_eps", 0.5)
    tcf.set("vertically_enlarge_bboxes", True)
    tcf.set("nms_on_device", False)
    tcf.set("cascade_capacity_schedule", [8, 8])
    tcf.set("inference_batch_frames", 1)
    before = windows_cuda.LAUNCHES
    served = served_det.detect_batch(_frames())  # 3 frames: one padded chunk
    assert windows_cuda.LAUNCHES == before
    assert len(served) == 3
    for a, b in zip(live, served):
        _assert_same(a, b)
    assert any(len(r.boxes) for r in served)


def test_bundle_meta_and_graph(rgb_bundle):
    bundle, path, _ = rgb_bundle
    meta = bundle.meta
    assert meta["program_format"] == "torch.export" and meta["device"] == "cpu"
    assert meta["nms_on_device"] and meta["nms_min_neighbors"] == 1 and meta["nms_eps"] == 0.2
    assert meta["capacity_rungs"] == [CAPS] and meta["batch"] == 2 and not meta["yuv"]
    assert meta["resample_impl"] == "pallas2" and meta["extraction_mode"] == "gather"
    loaded = tserve.load_bundle(path, device="cpu")
    targets = [str(n.target) for n in loaded.programs[0].graph.nodes if n.op == "call_function"]
    assert targets.count("rodc.resample.default") == 2  # stages 1 and 2
    assert targets.count("rodc.cluster.default") == 1
    assert len(loaded._weights) == len(meta["weight_dtypes"])
    # the weights are stored once, not again inside each program
    weights_bytes = os.path.getsize(os.path.join(path, "weights.npz"))
    assert os.path.getsize(os.path.join(path, "program_0.pt2")) < weights_bytes / 2


def test_bundle_ladder_matches_redispatch(models, tmp_path):
    """A YUV bundle with a 3-rung ladder from small capacities: a frame
    that saturates walks the rungs as the live detector re-dispatches it
    (1,420 windows, 179 and 135 survivors after stages 0 and 1)."""
    _serve_cfg(inference_batch_frames=1)
    model = models[1]
    image = synthetic.make_scene(64, 80, n_faces=1, seed=7, min_face=40, max_face=50).image
    frames = [rgb_to_yuv420(image)]
    det = tcascade.CascadeDetector(model, capacity_schedule=LADDER_CAPS)
    live = det.detect_batch_yuv420(frames)
    assert det.redispatches == 2
    bundle = tserve.export_detector(model, 64, 80, batch=1, yuv=True,
                                    capacities=LADDER_CAPS, n_rungs=3)
    assert bundle.meta["capacity_rungs"] == [LADDER_CAPS, [256, 128], [512, 256]]
    tserve.save_bundle(bundle, str(tmp_path))
    tcf.set("nms_opencv_min_neighbors", 3)
    served_det = tserve.load_bundle(str(tmp_path), device="cpu")
    served = served_det.detect_batch(frames)
    for a, b in zip(live, served):
        _assert_same(a, b)
        assert not any(s > c for s, c in zip(b.n_survivors_per_stage, [512, 256]))
    assert len(served[0].boxes) > 0
    with pytest.raises(ValueError, match="frame shape"):
        served_det.detect(image)  # an RGB frame for a YUV bundle


def test_port_bundle_matches_jax_bundle(rgb_bundle, jax_bundle):
    """The port's bundle against the JAX package's on the same frames and
    weights, within the port-vs-JAX tolerances."""
    _, path, _ = rgb_bundle
    _, jax_served = jax_bundle
    served = tserve.load_bundle(path, device="cpu").detect_batch(_frames())
    for a, b in zip(served, jax_served):
        tp.assert_results_close(a, b)


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        ({"resample_impl": "pallas2dyn"}, ValueError, "overflow"),
        ({"resample_impl": "xla"}, ValueError, "pallas"),
        ({"batch": "dynamic", "mesh": object()}, NotImplementedError, "item 6"),
        ({"platforms": ("cpu", "tpu")}, ValueError, "tpu"),
        ({"platforms": ("cuda",)}, ValueError, "export device"),
        ({"mesh": object()}, NotImplementedError, "item 6"),
    ],
)
def test_export_refusals(models, kwargs, error, match):
    with pytest.raises(error, match=match):
        tserve.export_detector(models[1], 100, 120, capacities=CAPS, **kwargs)


def test_window_sharded_export_raises(models):
    with pytest.raises(NotImplementedError, match="item 6"):
        tserve.export_window_sharded(models[1], 100, 120, mesh=object())


def test_load_refuses_a_jax_bundle_and_another_device(jax_bundle, rgb_bundle):
    path, _ = jax_bundle
    with pytest.raises(ValueError, match="torch.export"):
        tserve.load_bundle(path, device="cpu")
    _, port_path, _ = rgb_bundle
    with pytest.raises((NotImplementedError, RuntimeError)):
        tserve.load_bundle(port_path)  # the default device is the card
