"""The cascade detector's spans and counters on the CPU.

``utils/profiling.annotate`` opens a ``record_function`` only while a
profiler records, and never while ``torch.export`` traces; under a CPU
``torch.profiler`` one ``detect_batch_yuv420`` call opens one
``rodc.request`` with every other span inside it.
``CascadeDetector.counters`` counts frames, upload bytes, rows launched,
skipped and needed per stage, and re-dispatches at their rung; a stage
run in one chunk reads no live count.
``profiling.span_report`` splits a hand-made Chrome trace's idle time by
the innermost span, the classes adding up to the idle time of the union
of device intervals.

The model: the port's ``build_cascade_model(seed=0)`` on the CPU with
tests/test_golden.py's small nets (conv [8], fc1 32, f32), on 48x64
synthetic frames at window scale factor 1.3.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420
from rapidobjectdetectionusingcascadedcnns_torch.utils import profiling

torch.set_num_threads(2)

SMALL = {"conv_filter_sizes": [8], "fc1_size": 32, "compute_dtype": "float32",
         "nms": tcf.NMS_OPENCV, "nms_opencv_min_neighbors": 0,
         "foreground_confidence_threshold": 0.5, "window_scale_factor": 1.3}
SPANS = ("rodc.upload", "rodc.dispatch", "rodc.stage0.windows", "rodc.cnn.0", "rodc.cnn.1",
         "rodc.cnn.2", "rodc.reextract.1", "rodc.reextract.2", "rodc.read_back",
         "rodc.decode", "rodc.host_nms")


@pytest.fixture(autouse=True)
def small_config():
    tcf.reset()
    for key, value in SMALL.items():
        tcf.set(key, value)
    yield
    tcf.reset()


@pytest.fixture(scope="module")
def model():
    tcf.reset()
    for key, value in SMALL.items():
        tcf.set(key, value)
    built = cascade.build_cascade_model(seed=0, device="cpu")
    tcf.reset()
    return built


def _frames(n):
    return [rgb_to_yuv420(synthetic.make_scene(48, 64, 1, seed=60 + k, min_face=20,
                                               max_face=30).image) for k in range(n)]


def _spans(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, [e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("rodc.")]


def test_one_request_span_holds_the_others(model, tmp_path):
    det = cascade.CascadeDetector(model)
    frames = _frames(2)
    det.detect_batch_yuv420(frames)  # plans and tables built outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.detect_batch_yuv420(frames)
    events, spans = _spans(prof, tmp_path)
    requests = [e for e in spans if e["name"] == "rodc.request"]
    assert len(requests) == 1
    lo, hi = requests[0]["ts"], requests[0]["ts"] + requests[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3 for e in spans)
    names = [e["name"] for e in spans]
    assert set(SPANS) <= set(names)
    # request, upload, dispatch, read-back, decode; decode, planes and
    # extraction of stage 0; 3 nets, 2 re-extractions; host NMS a frame
    assert len(names) == 13 + len(frames)
    report = profiling.span_report(events)
    assert report["spans"]["rodc.host_nms"]["count"] == len(frames)
    assert report["idle_s"] == pytest.approx(sum(report["idle"].values()))


def test_no_record_function_without_a_profiler(model, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError("record_function {} entered with no profiler".format(name))

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert isinstance(profiling.annotate("rodc.request"), type(profiling._OFF))
    results = cascade.CascadeDetector(model).detect_batch_yuv420(_frames(1))
    assert results[0].n_windows > 0


def test_counters_count_launched_and_needed_rows(model):
    det = cascade.CascadeDetector(model)
    frames = _frames(2)
    results = det.detect_batch_yuv420(frames)
    n0 = results[0].n_windows
    caps = cascade.default_capacity_schedule(n0, 3)
    assert det.counters == {
        "frames": 2,
        "upload_bytes": sum(y.nbytes + uv.nbytes for y, uv in frames),
        "rows_launched": [2 * n0] + [2 * c for c in caps],
        "rows_skipped": [0, 0, 0],
        "rows_needed": [2 * n0] + [sum(r.n_survivors_per_stage[k] for r in results)
                                   for k in (0, 1)],
        "redispatches": 0,
    }
    det.redispatches = 5  # the attribute is the counter
    assert det.counters["redispatches"] == 5


def test_one_chunk_stages_read_no_live_count(model, monkeypatch):
    """A cascade without an Inception stage runs each stage's capacity in
    one chunk: it reads no live count, launches every slot and skips
    none."""
    def refuse(alive):
        raise AssertionError("a live count read for a stage run in one chunk")

    monkeypatch.setattr(cascade, "_live_slots", refuse)
    det = cascade.CascadeDetector(model)
    n0 = det.detect_batch_yuv420(_frames(2))[0].n_windows
    caps = cascade.default_capacity_schedule(n0, 3)
    assert det.counters["rows_launched"] == [2 * n0] + [2 * c for c in caps]
    assert det.counters["rows_skipped"] == [0, 0, 0]


def test_counters_count_a_redispatch_at_its_rung(model):
    tcf.set("foreground_confidence_threshold", 0.0)  # every window survives
    det = cascade.CascadeDetector(model, capacity_schedule=[16, 16])
    result = det.detect_batch_yuv420(_frames(1))[0]
    n0 = result.n_windows
    assert result.n_survivors_per_stage == [n0, n0, n0]
    rungs = list(cascade.capacity_ladder([16, 16], n0, 8))
    assert rungs[-1] == [n0, n0] and det.redispatches == len(rungs)  # to the open rung
    assert det.counters["rows_launched"] == [n0 * (1 + len(rungs))] + [
        16 + sum(r[k] for r in rungs) for k in (0, 1)]
    assert det.counters["rows_needed"] == [n0, n0, n0]


def test_export_under_a_profiler_holds_no_profiler_op(model):
    with profile(activities=[ProfilerActivity.CPU]):
        bundle = serve.export_detector(model, 48, 64, batch=1, capacities=[128, 128],
                                       n_rungs=1)
    targets = [str(n.target) for p in bundle.programs for n in p.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_span_report_splits_idle_time_by_innermost_span():
    """A 100 us window: spans of one request, an upload's copy, two kernels
    launched under the dispatch, and a copy launched between calls."""
    events = [_x("PyTorch Profiler (0)", "Trace", 0.0, 100.0)]
    events += [_x(n, "user_annotation", ts, dur) for n, ts, dur in (
        ("rodc.request", 10, 80), ("rodc.upload", 12, 8), ("rodc.dispatch", 20, 20),
        ("rodc.stage0.windows", 22, 8), ("rodc.read_back", 40, 20), ("rodc.decode", 60, 25),
        ("rodc.host_nms", 62, 8))]
    events += [_x("cudaLaunch", "cuda_runtime", ts, 0.5, correlation=c)
               for c, ts in ((1, 13), (2, 23), (3, 35), (4, 5))]
    events += [_x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 14, 4, correlation=1),
               _x("conv_kernel", "kernel", 24, 21, correlation=2),
               _x("pool_kernel", "kernel", 44, 6, correlation=3),
               _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 6, 2, correlation=4)]
    report = profiling.span_report(events)
    us = {k: round(v * 1e6, 6) for k, v in report["idle"].items()}
    assert us == {"client": 18.0, "other": 7.0, "dispatch": 8.0, "decode": 35.0}
    # the union of device intervals: [6, 8], [14, 18], [24, 50]
    assert round(report["idle_s"] * 1e6, 6) == 100.0 - 32.0
    assert round(report["h2d_s"] * 1e6, 6) == 4.0
    spans = report["spans"]
    assert {n: round(spans[n]["device_s"] * 1e6, 6) for n in spans} == {
        "rodc.request": 0.0, "rodc.upload": 4.0, "rodc.dispatch": 6.0,
        "rodc.stage0.windows": 21.0, "rodc.read_back": 0.0, "rodc.decode": 0.0,
        "rodc.host_nms": 0.0}
    assert round(spans["rodc.host_nms"]["idle_s"] * 1e6, 6) == 8.0
    assert spans["rodc.request"]["count"] == 1 and spans["rodc.decode"]["host_s"] == 25e-6
