"""The trace reader on a hand-made Chrome trace: busy time is the union of
the device intervals, and a kernel's modules are those of the Python
spans open at its launch, spans that did not nest included."""

from __future__ import annotations

import pytest

from benchmark.harness.trace import Trace

PKG = "rapidobjectdetectionusingcascadedcnns_torch/"


def _py(name, ts, dur):
    return {"ph": "X", "cat": "python_function", "name": name, "ts": ts, "dur": dur}


def _launch(corr, launch_ts, kernel_ts, dur, name):
    return [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts,
         "dur": 1.0, "args": {"correlation": corr}},
        {"ph": "X", "cat": "kernel", "name": name, "ts": kernel_ts, "dur": dur,
         "args": {"correlation": corr}},
    ]


@pytest.fixture()
def trace():
    events = [
        _py(PKG + "models/cascade.py(10): detect", 0.0, 100.0),
        # spans that do not nest (a generator's): the first has ended by
        # the launch, under a span that started inside it and goes on
        _py(PKG + "ops/windows_cuda.py(5): gen", 5.0, 10.0),
        _py(PKG + "ops/windows.py(7): stage0", 10.0, 20.0),
        _py(PKG + "models/cnn.py(3): apply_stage", 40.0, 30.0),
        _py("torch/nn/functional.py(9): conv2d", 41.0, 5.0),
    ]
    events += _launch(11, 21.0, 30.0, 10.0, "resize")
    events += _launch(12, 42.0, 45.0, 20.0, "conv")
    events += _launch(13, 43.0, 50.0, 10.0, "pool")  # overlaps the conv
    events.append({"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 0.0,
                   "dur": 100.0})
    return Trace(events, (0.0, 100.0))


def test_busy_is_the_union(trace):
    assert trace.busy_s() == pytest.approx(30e-6)  # [30, 40] + [45, 65]; [50, 60] inside
    assert trace.window_s == pytest.approx(100e-6)


def test_modules_at_the_launch(trace):
    by_name = {e["name"]: trace.chain[id(e)] for e in trace.device}
    assert by_name["resize"] == ("models/cascade.py", "ops/windows.py")
    assert by_name["conv"] == ("models/cascade.py", "models/cnn.py")
    assert trace.seconds(lambda chain, name: chain[-1] == "models/cnn.py") == \
        pytest.approx(30e-6)


def test_idle_gaps_named_by_the_host(trace):
    gaps = trace.idle_gaps(2)
    assert gaps[0] == ["models/cnn.py:apply_stage", pytest.approx(35e-6)]  # [65, 100]
    assert gaps[1] == ["models/cascade.py:detect", pytest.approx(30e-6)]  # [0, 30]


@pytest.mark.parametrize("name", ["vga-batch16", "dense-fddb-450"])
def test_traced_run_on_cpu(tiny_root, name):
    """Both trace sessions run the same requests; every one is judged."""
    from benchmark.harness import cell

    out = cell.run(name, 2**36 + 1, 0.5, True, "cpu", root=tiny_root)
    out.pop("_lines")
    assert out["correct"], out["checks"]
    assert out["attempted"] == 4
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    if name == "vga-batch16":
        assert {"redispatches_per_req", "host_nms_ms_per_frame"} <= set(out["metrics"])
