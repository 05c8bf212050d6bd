"""Dynamic-batch serving bundles of the port: one ``torch.export`` program
per rung with a symbolic frame count, against the port's live detector
(frame for frame, bit for bit) and against the JAX package's dynamic
bundle. Weights come from the JAX ``build_cascade_model`` through the
bridge, never re-drawn.

The stage CNNs run in chunks of ``inference_chunk_size`` rows; it is cut
to 4,000 here so that chunks straddle frames (3,344 windows a frame), as
the VGA path's 16,384-row chunks straddle its 5,061-window frames."""

import json
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CAPS = [8, 8]  # tests/test_serve.py::test_bundle_dynamic_batch's ladder
N_RUNGS = 4  # enough for these frames: at most 499 and 330 survivors
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_CFG = dict(nms_opencv_min_neighbors=1, nms_on_device=True, inference_batch_frames=2,
                 inference_chunk_size=4000)

# A fresh process computes the references while this file's port export
# runs: the port's live detector on the 5 frames (its re-dispatches
# counted), then the JAX package's dynamic bundle of the same weights and
# knobs, exported, saved, loaded and served on the first 4 frames. Each
# result is pickled as soon as it is ready.
CHILD = r"""
import json, os, pickle, sys
import numpy as np
import torch
settings, frames_path, work, tests_dir, caps = sys.argv[1:6]
sys.path.insert(0, tests_dir)
import torch_parity as tp
from rapidobjectdetectionusingcascadedcnns_tpu import serve as jserve
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
torch.set_num_threads(2)
tp.configure(**json.loads(settings))
with np.load(frames_path) as z:
    frames = list(z["frames"])
jmodel, tmodel = tp.jax_and_port_models(seed=0)
det = tcascade.CascadeDetector(tmodel, capacity_schedule=json.loads(caps))
live = det.detect_batch(frames)
with open(work + "/live.part", "wb") as f:
    pickle.dump({"redispatches": det.redispatches, "results": live}, f)
os.replace(work + "/live.part", work + "/live.pkl")
bundle = jserve.export_detector(jmodel, 100, 120, batch="dynamic", capacities=[1024, 512],
                                n_rungs=1)
jserve.save_bundle(bundle, work)
served = jserve.load_bundle(work).detect_batch(frames[:4])
with open(work + "/served.pkl", "wb") as f:
    pickle.dump({"batch": bundle.meta["batch"], "results": [
        {k: getattr(r, k) for k in ("n_windows", "raw_window_ids", "raw_confidences", "boxes")}
        for r in served]}, f)
"""


def _cfg():
    tp.configure(**SERVE_CFG)


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


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """The reference process, started with the module's first test.
    Yields functions that wait for its results: ``live()`` (the live
    detector's results on the 5 frames and its re-dispatches) and ``jax()``
    (the JAX bundle's batch mode and its results on the first 4 frames)."""
    work = tmp_path_factory.mktemp("references")
    np.savez(str(work / "frames.npz"), frames=np.stack(_frames()))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(SERVE_CFG), str(work / "frames.npz"),
         str(work), os.path.join(REPO, "tests"), json.dumps(CAPS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read(name):
        deadline = time.time() + 600
        while not (work / name).exists():
            if proc.poll() is not None and not (work / name).exists():
                raise AssertionError(proc.communicate()[1][-3000:])
            assert time.time() < deadline, "the reference process took over 600 s"
            time.sleep(0.2)
        with open(str(work / name), "rb") as f:
            return pickle.load(f)

    def live():
        out = read("live.pkl")
        return out["results"], out["redispatches"]

    def jax():
        _, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        out = read("served.pkl")
        return out["batch"], [types.SimpleNamespace(**r) for r in out["results"]]

    yield types.SimpleNamespace(live=live, jax=jax)
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def served(models, references, tmp_path_factory):
    """The live detector's results on 5 frames and its re-dispatches (from
    the reference process), the dynamic bundle exported, saved and loaded,
    and its results on the same frames with every program call recorded."""
    _cfg()
    bundle = tserve.export_detector(models[1], 100, 120, batch="dynamic", capacities=CAPS,
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
    live, redispatches = references.live()
    return {"bundle": bundle, "loaded": loaded, "live": live, "served": results,
            "calls": calls, "redispatches": redispatches}


def test_dynamic_bundle_equals_live_detector(served):
    """Frame for frame, bit for bit, with chunks of rows that straddle
    frames; every frame saturates rung 0 and walks the ladder."""
    assert served["redispatches"] == 15  # 3 escalations for each of the 5 frames
    for a, b in zip(served["live"], served["served"]):
        _assert_same(a, b)
        assert not any(s > c for s, c in zip(b.n_survivors_per_stage, [512, 512]))
    assert all(len(r.boxes) for r in served["served"])


def test_dynamic_bundle_matches_jax_dynamic_bundle(served, references):
    """The JAX package's dynamic bundle of the same weights (its
    ``build_cascade_model(seed=0)``), at capacities no frame saturates (its
    ladder would compile a program per rung and frame count), against the
    port's ladder walk: both are the unbounded survivor sets, within the
    port-vs-JAX tolerances."""
    batch, jax_results = references.jax()
    assert batch == "dynamic" and len(jax_results) == 4
    for a, b in zip(served["served"], jax_results):
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
