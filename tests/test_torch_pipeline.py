"""The detectors' bounded pipeline and the frame upload.

Both detectors run ``models/cascade.read_back_pipelined``, the loop of the
JAX ``detect_batch``: frames in chunks of ``inference_batch_frames``
(here 2), each uploaded (``utils/device.upload``) and enqueued; once more
than ``inference_pipeline_depth`` chunks are pending the oldest is read
back, and host NMS runs only after the last read-back. Spies on the
dispatch (``_infer``, ``_run_chunk``), on the read-back (``.numpy()`` of
what the dispatch returned) and on the decode (``_unpack_row``) record the
order over 5 frames (3 chunks) at depth 1 and 2.

The single net's results at both depths over 6 frames (3 full chunks, so
the JAX side compiles one program) are held against the JAX
``SingleNetDetector.detect_batch`` on the same frames and converted
weights (12 px, conv [8], fc1 32, f32, weights drawn with numpy; gather
mode at 64x96 and scale factor 1.1): NMS boxes and raw boxes equal, confidences within
``torch_parity.PROB_TOL`` (2e-3, the tolerance of
tests/test_torch_cascade_dense.py's single-net test). The JAX result is
computed once for the module.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import single as jsingle
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420
from rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid import build_plan
from rapidobjectdetectionusingcascadedcnns_torch.utils import device as tdevice

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

FRAME = (64, 96)
PIPELINE_CFG = {"inference_batch_frames": 2, "window_scale_factor": 1.1}


def _frames(n=5):
    return [synthetic.make_scene(*FRAME, 1, seed=40 + k, min_face=24, max_face=40).image
            for k in range(n)]


@contextlib.contextmanager
def _configured():
    """Both configurations from their defaults plus ``tp.configure()``
    while a module fixture builds, then back as they were
    (tests/test_torch_analysis_tools.py::_configured)."""
    saved = jcf.snapshot()
    jcf.reset()
    tcf.reset()
    tp.configure(**PIPELINE_CFG)
    try:
        yield
    finally:
        jcf.restore(saved)
        tcf.reset()


@pytest.fixture(scope="module")
def single():
    """A 12 px net drawn with numpy in the JAX tree's shapes, its port
    detector on the CPU, and the JAX ``detect_batch`` of 6 frames."""
    with _configured():
        scfg = jcnn.StageConfig.from_config(12, bottleneck_in_size=None)
        shapes = jax.eval_shape(lambda: jcnn.init_stage(jax.random.PRNGKey(1), scfg))
        rng = np.random.RandomState(1)
        params = jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype), shapes)
        mean = np.full((12, 12, 3), 127.5, np.float32)
        std = np.full((12, 12, 3), 64.0, np.float32)
        ref = jsingle.SingleNetDetector(params, scfg, mean, std).detect_batch(_frames(6))
        port = tsingle.SingleNetDetector(
            bridge.params_from_numpy(params, device="cpu"), bridge.stage_config_from_jax(scfg),
            mean, std, device="cpu",
        )
    return port, ref


class _ReadBack:
    """What a spied dispatch returns: its rows (on the CPU), logging
    ``("read", k)`` when the pipeline reads them back."""

    def __init__(self, rows, k, events):
        self.rows, self.k, self.events = rows, k, events
        self.device = rows.device

    def numpy(self):
        self.events.append(("read", self.k))
        return self.rows.numpy()


def _spy(monkeypatch, cls, dispatch_name, events):
    """Log ``("dispatch", k)`` for the k-th call of ``cls.dispatch_name``
    and ``("decode",)`` for each ``cls._unpack_row``."""
    dispatch = getattr(cls, dispatch_name)
    unpack = cls.__dict__["_unpack_row"]
    static = isinstance(unpack, staticmethod)
    decode = unpack.__func__ if static else unpack

    def spied_dispatch(*args, **kwargs):
        k = sum(e[0] == "dispatch" for e in events)
        events.append(("dispatch", k))
        return _ReadBack(dispatch(*args, **kwargs), k, events)

    def spied_unpack(*args, **kwargs):
        events.append(("decode",))
        return decode(*args, **kwargs)

    monkeypatch.setattr(cls, dispatch_name, spied_dispatch)
    monkeypatch.setattr(cls, "_unpack_row", staticmethod(spied_unpack) if static else spied_unpack)


# the JAX loop's order over 3 chunks: every chunk enqueued and read back
# before the first decode; at most `depth` chunks pending when one more is
# enqueued
EXPECTED = {
    1: [("dispatch", 0), ("dispatch", 1), ("read", 0), ("dispatch", 2), ("read", 1),
        ("read", 2)],
    2: [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("read", 0), ("read", 1),
        ("read", 2)],
}


def test_single_net_enqueues_every_chunk_before_host_nms(single, monkeypatch):
    port, _ = single
    tp.configure(**PIPELINE_CFG)
    events = []
    _spy(monkeypatch, tsingle.SingleNetDetector, "_infer", events)
    for depth in (1, 2):
        tcf.set("inference_pipeline_depth", depth)
        events.clear()
        assert len(port.detect_batch(_frames())) == 5
        assert events == EXPECTED[depth] + [("decode",)] * 5


def test_cascade_enqueues_every_chunk_before_host_nms(monkeypatch):
    """The YUV420 path (two uploads a chunk) at scale factor 1.5 (519
    windows), with capacities above every survivor count, so no frame is
    re-dispatched."""
    tp.configure(**{**PIPELINE_CFG, "window_scale_factor": 1.5})
    model = tcascade.build_cascade_model(seed=0, device="cpu")
    plan = build_plan(*FRAME, 12, 12, float(tcf.get("min_window_length")), 1.5)
    detector = tcascade.CascadeDetector(model, capacity_schedule=[256, 256])
    frames = [rgb_to_yuv420(f) for f in _frames()]
    events = []
    _spy(monkeypatch, tcascade.CascadeDetector, "_run_chunk", events)
    for depth in (1, 2):
        tcf.set("inference_pipeline_depth", depth)
        events.clear()
        results = detector.detect_batch_yuv420(frames)
        assert [r.n_windows for r in results] == [plan.n_windows] * 5
        assert events == EXPECTED[depth] + [("decode",)] * 5
    assert detector.redispatches == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_single_net_detect_batch_matches_jax(single, depth):
    port, ref = single
    tp.configure(inference_pipeline_depth=depth, **PIPELINE_CFG)
    got = port.detect_batch(_frames(6))
    assert sum(len(r.raw_boxes) for r in ref) > 0
    for g, r in zip(got, ref, strict=True):
        assert g.n_windows == r.n_windows
        np.testing.assert_array_equal(g.raw_boxes, r.raw_boxes)
        np.testing.assert_allclose(g.raw_confidences, r.raw_confidences, rtol=0,
                                   atol=tp.PROB_TOL)
        np.testing.assert_array_equal(g.boxes, r.boxes)
        np.testing.assert_array_equal(g.confidences, r.confidences)


def test_upload_on_the_cpu_is_the_stack():
    frames = _frames(3)
    got = tdevice.upload(frames, torch.device("cpu"))
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.stack(frames))
    yuv = [rgb_to_yuv420(f) for f in frames]
    uv = tdevice.upload([f[1] for f in yuv], torch.device("cpu"))
    np.testing.assert_array_equal(uv.numpy(), np.stack([f[1] for f in yuv]))
    staged = tdevice.upload([torch.from_numpy(f) for f in frames], torch.device("cpu"))
    torch.testing.assert_close(staged, got, rtol=0, atol=0)
