"""The device trace of a run's traced requests, read into what the
per-layer metrics need.

``torch.profiler`` with CPU and CUDA activities records the requests; its
Chrome trace (written under ``TMPDIR`` and deleted once read) holds the
kernels and copies on the card and the CUDA runtime and driver calls that
launched them (matched by correlation id); with Python stacks, also a
span for every Python function call. Recording those spans slows the
host, so the card's busy time and the window are read from a session
without them, and the modules from one with them. A kernel belongs to the detector module
that is the innermost of the detector's own frames on the Python stack of
its launch. ``Trace.chain`` gives, for each device activity, the
detector's modules on that stack from the outermost to the innermost, as
paths inside the package (``("models/cascade.py", "models/cnn.py")``);
empty for work launched from outside the package.

A process's first profiler session can return its device activities with
no timestamps, so ``Recorder`` opens and closes a short session on a
trivial operation before the traced one.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Tuple

PACKAGE = "rapidobjectdetectionusingcascadedcnns_torch"
_FRAME = re.compile(re.escape(PACKAGE) + r"/([\w/]+\.py)\(")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Recorder:
    """A context manager that traces what runs inside it."""

    def __init__(self, device, stacks: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device=device).sum().item()
        self.prof = profile(activities=acts, with_stack=stacks)
        self.events: List[dict] = []
        self.window_us: Tuple[float, float] = (0.0, 0.0)

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        spans = [e for e in self.events if e.get("cat") == "Trace"]
        if spans:
            self.window_us = (spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"])
        return False


class Trace:
    """The device intervals of a trace and the module that launched each."""

    def __init__(self, events: List[dict], window_us: Tuple[float, float]):
        self.window_us = window_us
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        if self.device and all(e["ts"] == 0 for e in self.device):
            raise RuntimeError("the trace's device activities carry no timestamps")
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.python = sorted((e for e in events if e.get("cat") == "python_function"),
                             key=lambda e: (e["ts"], -e["dur"]))
        points = sorted((ev["ts"], cid) for cid, ev in launches.items())
        where = _package_chains(self.python, points)
        self.chain: Dict[int, Tuple[str, ...]] = {
            id(e): where.get(e.get("args", {}).get("correlation"), ()) for e in self.device}

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which at least one kernel, copy or set ran on the card
        (the union of their intervals, so overlaps count once)."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        total, end = 0.0, float("-inf")
        for s, t in spans:
            if t <= end:
                continue
            total += t - max(s, end)
            end = t
        return total / 1e6

    def seconds(self, select: Callable[[Tuple[str, ...], str], bool]) -> float:
        """Device seconds of the activities for which ``select(chain,
        name)`` holds."""
        return sum(e["dur"] for e in self.device if select(self.chain[id(e)], e["name"])) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            key = _short(e["name"])
            by[key] = by.get(key, 0.0) + e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with nothing on the card, each named by the
        innermost Python function running on the host when it began (a
        trace with Python stacks, whose host runs slower than untraced)."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        gaps, end = [], self.window_us[0]
        for s, t in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if self.window_us[1] > end:
            gaps.append((end, self.window_us[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        names = _innermost_frames(self.python, [(g[0], i) for i, g in enumerate(gaps)])
        return [[names.get(i, "host"), (g[1] - g[0]) / 1e6] for i, g in enumerate(gaps)]


_NOISE = re.compile(r"^void |\(anonymous namespace\)::|at::native::|at_cuda_detail::")
_FUNCTOR = re.compile(r"(\w+_kernel_cuda|\w*Functor\w*)")


def _short(name: str) -> str:
    """A kernel's name without its namespaces and template arguments; a
    generic elementwise kernel keeps the functor it applies."""
    name = _NOISE.sub("", name)
    base = re.split(r"[<(]", name, maxsplit=1)[0] or name
    if base.endswith("elementwise_kernel"):
        m = _FUNCTOR.search(name[len(base):])
        if m:
            base += "[" + m.group(1) + "]"
    return base.strip()[:80]


def _sweep(python: List[dict], points):
    """For each (ts, key) point in time order, the Python spans open at ts,
    outermost first (a sweep over the spans sorted by start; a span is
    dropped once it has ended, wherever it sits, since a generator's spans
    need not nest)."""
    stack: List[dict] = []
    i = 0
    for ts, key in points:
        while i < len(python) and python[i]["ts"] <= ts:
            stack.append(python[i])
            i += 1
        stack = [ev for ev in stack if ev["ts"] + ev["dur"] >= ts]
        yield key, stack


def _package_chains(python, points) -> Dict[int, Tuple[str, ...]]:
    out = {}
    for key, stack in _sweep(python, sorted(points)):
        chain: List[str] = []
        for ev in stack:
            m = _FRAME.search(ev["name"])
            if m and (not chain or chain[-1] != m.group(1)):
                chain.append(m.group(1))
        out[key] = tuple(chain)
    return out


def _innermost_frames(python, points) -> Dict[int, str]:
    """The innermost of the detector's frames open at each point (module
    and function), else the innermost frame of any code."""
    out = {}
    for key, stack in _sweep(python, sorted(points)):
        for ev in reversed(stack):
            m = _FRAME.search(ev["name"])
            if m:
                out[key] = m.group(1) + ":" + ev["name"].rsplit(": ", 1)[-1]
                break
        else:
            if stack:
                out[key] = stack[-1]["name"][-80:]
    return out
