"""Profiling hooks: per-phase timers and ``torch.profiler`` traces (the
port's counterpart of the JAX package's ``utils/profiling.py``).

The reference's only tracing is wall-clock TimeWatchers around phases
(SURVEY.md §5). This module keeps that surface (phase timers with the same
log format) and, where the JAX package captures a ``jax.profiler`` trace,
captures a ``torch.profiler`` trace of the host and the CUDA card, written
as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

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
    import torch
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


def annotate(name: str):
    """Named region visible in profiler traces (``record_function``)."""
    import torch

    return torch.profiler.record_function(name)
