"""Profiling hooks: per-phase timers, ``torch.profiler`` traces and the
cascade detector's spans (the port's counterpart of the JAX package's
``utils/profiling.py``).

The reference's only tracing is wall-clock TimeWatchers around phases
(SURVEY.md §5). This module keeps that surface (phase timers with the same
log format) and, where the JAX package captures a ``jax.profiler`` trace,
captures a ``torch.profiler`` trace of the host and the CUDA card, written
as a Chrome trace: :func:`device_trace` is the exporter an operator opens
in Perfetto (or chrome://tracing) to see the spans below beside the card's
kernels and copies, on the profiler's one clock.

Spans (:func:`annotate`, fixed names) of ``models/cascade.CascadeDetector``
on its host thread, every one of a call inside that call's
``rodc.request``:

  rodc.request          one public detect call
  rodc.upload           a chunk's frames to the card (``utils/device.upload``)
  rodc.dispatch         enqueueing a chunk's cascade and its packed rows
  rodc.stage0.windows   colour decode, pyramid, stage-0 extraction, K1's planes
  rodc.cnn.<i>          stage i's CNN (a chunk of rows at a time)
  rodc.trunk            the Inception trunk, inside its rodc.cnn.<i>
  rodc.reextract.<i>    stage i's re-extraction (K1 or K4), i >= 1
  rodc.nms_device       the groupRectangles tail (K3), with ``nms_on_device``
  rodc.read_back        the host blocked on a chunk's copy to the host
  rodc.decode           saturation checks and unpacking of the rows
  rodc.host_nms         host groupRectangles of one frame
  rodc.redispatch       a saturated frame run again

:func:`span_report` reads them back from a Chrome trace's events.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from . import log
from .time_watcher import TimeWatcher

_phase_totals: Dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str, quiet: bool = True) -> Iterator[None]:
    """Accumulating phase timer; totals retrievable via :func:`summary`."""
    tw = TimeWatcher(name, quiet=quiet)
    try:
        yield
    finally:
        elapsed = tw.stop()
        _phase_totals[name] = _phase_totals.get(name, 0.0) + elapsed


def summary() -> Dict[str, float]:
    return dict(_phase_totals)


def reset() -> None:
    _phase_totals.clear()


def log_summary() -> None:
    log.log("phase timing summary:")
    for name, total in sorted(_phase_totals.items(), key=lambda kv: -kv[1]):
        log.log("  - {}: {}".format(name, TimeWatcher.seconds_to_str(total)))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, of CUDA; written to ``<log_dir>/trace.json`` (default
    ``<summary_dir>/torch_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    from .. import config as cf

    target = log_dir or os.path.join(cf.get("summary_dir"), "torch_trace")
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(target, "trace.json")
    prof.export_chrome_trace(path)
    log.log("torch profiler trace written to {}".format(path))


_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """Named region visible in profiler traces (``record_function``) while
    a profiler records; otherwise, and while ``torch.export`` or
    ``torch.compile`` traces (a program must hold no profiler op), a null
    context that costs one flag check."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


# the span that decides where card-idle time goes: the innermost of these
# open on the host, else "other" inside a request, else "client"
IDLE_CLASSES = {"rodc.upload": "dispatch", "rodc.dispatch": "dispatch",
                "rodc.read_back": "decode", "rodc.decode": "decode"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span_report(events: List[dict]) -> dict:
    """The ``rodc.*`` spans of a Chrome trace's ``events`` (``traceEvents``
    of ``export_chrome_trace``) against its device activities, in seconds.

    The window is the profiler session's; idle time is the window less the
    union of kernel, copy and set intervals. Each idle instant goes to the
    innermost span open on the host then, and to its class
    (:data:`IDLE_CLASSES`): ``client`` outside every ``rodc.request``,
    ``other`` inside one but under none of the classes' spans; the four
    classes add up to the idle time. Each device activity goes to the
    innermost span open when its launch was called (matched by correlation
    id). Returns ``{"window_s", "idle_s", "idle": {class: s}, "h2d_s"
    (host-to-device copies launched under rodc.upload), "spans": {name:
    {"count", "host_s", "device_s", "idle_s"}}}``."""
    session = next(e for e in events if e.get("cat") == "Trace" and e.get("ph") == "X")
    lo, hi = session["ts"], session["ts"] + session["dur"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("ph") == "X" and e.get("name", "").startswith("rodc.")),
                   key=lambda e: (e["ts"], -e["dur"]))
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    table = {}
    for e in spans:
        row = table.setdefault(e["name"], {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                           "idle_s": 0.0})
        row["count"] += 1
        row["host_s"] += e["dur"] / 1e6
    idle = {"client": 0.0, "dispatch": 0.0, "decode": 0.0, "other": 0.0}
    for (s, t), stack in _overlay(_idle_intervals(device, lo, hi), _segments(spans, lo, hi)):
        idle[_idle_class(stack)] += (t - s) / 1e6
        if stack:
            table[stack[-1]]["idle_s"] += (t - s) / 1e6
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    at = sorted((launched[e["args"]["correlation"]], i) for i, e in enumerate(device)
                if e.get("args", {}).get("correlation") in launched)
    h2d = 0.0
    for (ts, i), stack in zip(at, _stacks_at(spans, [ts for ts, _ in at])):
        if stack:
            table[stack[-1]]["device_s"] += device[i]["dur"] / 1e6
            if stack[-1] == "rodc.upload" and "HtoD" in device[i]["name"]:
                h2d += device[i]["dur"] / 1e6
    return {"window_s": (hi - lo) / 1e6, "idle_s": sum(idle.values()), "idle": idle,
            "h2d_s": h2d, "spans": table}


def _idle_class(stack: Tuple[str, ...]) -> str:
    for name in reversed(stack):
        if name in IDLE_CLASSES:
            return IDLE_CLASSES[name]
    return "other" if "rodc.request" in stack else "client"


def _idle_intervals(device: List[dict], lo: float, hi: float) -> List[Tuple[float, float]]:
    """[lo, hi] less the union of the device intervals, in time order."""
    out, end = [], lo
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, t)
        if end >= hi:
            break
    if hi > end:
        out.append((end, hi))
    return [(s, t) for s, t in out if t > s]


def _segments(spans: List[dict], lo: float, hi: float):
    """[lo, hi] cut where a span starts or ends: ((start, end), the names
    of the spans open there, outermost first), in time order."""
    cuts = sorted({lo, hi} | {min(max(x, lo), hi) for e in spans
                              for x in (e["ts"], e["ts"] + e["dur"])})
    stacks = _stacks_at(spans, cuts[:-1], half_open=True)
    return [((s, t), stack) for s, t, stack in zip(cuts, cuts[1:], stacks)]


def _stacks_at(spans: List[dict], points: List[float], half_open: bool = False):
    """The names of the spans open at each of ``points`` (ascending),
    outermost first; with ``half_open`` a span ending at a point is
    closed there, so the stack holds for the stretch after it."""
    out, stack, i = [], [], 0
    for ts in points:
        while i < len(spans) and spans[i]["ts"] <= ts:
            stack.append(spans[i])
            i += 1
        stack = [e for e in stack if e["ts"] + e["dur"] > ts
                 or (not half_open and e["ts"] + e["dur"] == ts)]
        out.append(tuple(e["name"] for e in stack))
    return out


def _overlay(intervals, segments):
    """The pieces of ``intervals`` (sorted, disjoint) cut by ``segments``
    (sorted, covering them), each with its segment's span names."""
    j = 0
    for s, t in intervals:
        while j < len(segments) and segments[j][0][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0][0] < t:
            (a, b), stack = segments[k]
            yield (max(a, s), min(b, t)), stack
            k += 1
