"""One run of one cell: set-up, the measured window (or the traced
requests), the comparison with the plain reference, the metrics.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
entry in ``workloads`` names a configuration (``benchmark/configs/<name>.json``,
whose ``system`` names ``benchmark/systems/<system>.py``) and a traffic
mix (``benchmark/traffic/<name>.json``); ``benchmark/workloads/<cell>.json``
holds the cell's limits; each metric is ``benchmark/e2e/<name>.py`` or
``benchmark/metrics/<name>.py`` with a ``read(run)`` function. A metric
split by cells, ``<name>.<part>`` (``frames_per_s.dense``), is read by
``<name>.py`` where it has no file of its own.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import calibrate, compare, traffic as traffic_mod, weights
from ..reference import cascade as ref_cascade
from ..reference import cnn as ref_cnn

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "rapidobjectdetectionusingcascadedcnns_tpu")
REF_FRAMES = 8  # frames the reference takes at once


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str):
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """A cell and everything it names, read from ``BENCHMARK.json``."""

    def __init__(self, name: str, root: str = ROOT):
        manifest = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError("no workload {!r} in BENCHMARK.json".format(name))
        bench = os.path.join(root, "benchmark")
        self.name, self.cell = name, cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _json(os.path.join(root, configs[self.cell["config"]]["file"]))
        self.traffic = _json(os.path.join(bench, "traffic", self.cell["traffic"] + ".json"))
        self.workload = _json(os.path.join(bench, "workloads", name + ".json"))
        self.system = _module(os.path.join(bench, "systems", self.config["system"] + ".py"))

        def applies(metric, moved):
            listed = metric.get("workloads")
            return name in listed if listed is not None else moved(metric)

        self.end_to_end = [m for m in manifest["end_to_end"] if applies(m, lambda m: True)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if applies(m, lambda m: m["moves"] in e2e_names)]
        self.readers = {m["name"]: reader(os.path.join(bench, "e2e"), m["name"])
                        for m in self.end_to_end}
        self.readers.update({m["name"]: reader(os.path.join(bench, "metrics"), m["name"])
                             for m in self.per_layer})


def reader(folder: str, name: str) -> str:
    """The file that reads metric ``name``: ``<name>.py``, else that of the
    name before its first dot."""
    path = os.path.join(folder, name + ".py")
    if os.path.isfile(path):
        return path
    return os.path.join(folder, name.split(".", 1)[0] + ".py")


class Session:
    """Requests sent back to back, with what was recorded over them: the
    host-clock window, the program's counters and, traced, the trace."""

    def __init__(self):
        self.requests: List[dict] = []
        self.window_s = 0.0
        self.trace = None
        self.redispatches = 0
        self.nms_s = 0.0

    @property
    def frames(self) -> int:
        return sum(len(r["idx"]) for r in self.requests)


class Run(Session):
    """What a metric reader reads: the cell, the requests and their
    answers, the reference's answers, and the program's counts.

    Untraced, the run is the measured window's session. Traced, the same
    requests go through two sessions of ``torch.profiler``: ``stacked``,
    with Python stacks, by which each kernel is put to the module that
    launched it, and ``plain``, without them, so that the host runs at its
    own pace: the busy time, the window, the counters and the host NMS
    time come from it. ``requests`` then holds both sessions' requests,
    every one judged."""

    def __init__(self, spec: Spec, seed: int, device):
        super().__init__()
        self.spec, self.seed, self.device = spec, seed, device
        self.config, self.traffic = spec.config, spec.traffic
        self.setup_s = 0.0
        self.calibration_s = 0.0
        self.stacked: Optional[Session] = None
        self.plain: Optional[Session] = None
        self.reference: Dict[int, dict] = {}

    def stage_windows(self, request: dict) -> List[int]:
        """Windows each stage runs on for a request's frames, by the
        reference: every pyramid window at stage 0, then the survivors of
        the stage before."""
        out = [self.geometry.n_windows * len(request["idx"])]
        for i in range(1, len(self.stages)):
            out.append(sum(self.reference[f]["counts"][i - 1] for f in request["idx"]))
        return out


def process_start() -> float:
    """Wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    import sys

    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def prepare(spec: Spec, seed: int, device):
    """Set-up before the program is built: kernels, the frame pool, the
    weights, the pyramid and the calibrated thresholds. Returns (run,
    pool, the detector settings)."""
    import torch

    rn = Run(spec, seed, device)
    cfg, tr = spec.config, spec.traffic
    ref_cnn.strict_f32()
    spec.system.build_kernels(device)
    pool = traffic_mod.Pool(tr, seed)
    fr = tr["frame"]
    det = dict(cfg, **tr.get("detector", {}))
    rn.stages = weights.stages(cfg, seed, device)
    rn.geometry = ref_cascade.Geometry(fr["height"], fr["width"], rn.stages[0]["size"],
                                       det["min_window_length"], det["window_scale_factor"],
                                       device)
    t0 = time.time()
    rn.thresholds = calibrate.thresholds(
        rn.stages, pool.frames_tensor(list(range(pool.n_frames)), device), rn.geometry,
        tr["calibration"])
    _sync(torch, device)
    rn.calibration_s = time.time() - t0
    _free(torch, device)
    return rn, pool, det


def run(name: str, seed: int, seconds: float, trace: bool, device=None,
        root: str = ROOT, started: Optional[float] = None,
        wrap: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object (``checks`` last) and the
    lines for standard error under ``_lines``. ``wrap(program)`` returns
    the callable the window drives (the tests plant faults through it)."""
    import torch

    started = process_start() if started is None else started
    device = torch.device("cuda" if device is None else device)
    spec = Spec(name, root)
    rn, pool, det = prepare(spec, seed, device)
    program = spec.system.Program(spec.config, spec.traffic, rn.stages, rn.thresholds, device)
    call = wrap(program) if wrap else program
    for k in range(pool.n_requests):  # warm-up: every shape the traffic sends
        call(pool.request(k)[1])
    _sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    failed = 0
    if trace:
        from . import trace as trace_mod

        rn.setup_s = time.time() - started - rn.calibration_s
        n = int(spec.workload["trace_requests"])
        rn.stacked = _traced(rn, pool, call, program, trace_mod.Recorder(device, stacks=True), n)
        rn.plain = _traced(rn, pool, call, program, trace_mod.Recorder(device, stacks=False), n)
        failed = rn.stacked.failed + rn.plain.failed
        rn.requests = rn.stacked.requests + rn.plain.requests
    else:
        rn.setup_s = time.time() - started - rn.calibration_s
        t0 = time.perf_counter()
        failed = _drive(rn, pool, call, None, t0 + seconds)
        rn.window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    program.close()
    del program, call
    _free(torch, device)

    numbers = judge(rn, pool, det)
    limits = {k: float(v) for k, v in spec.workload["limits"].items()}
    correct = failed == 0 and compare.verdict(numbers, limits)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = _module(spec.readers[m["name"]]).read(rn)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(rn.requests), "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = rn.plain.trace.busy_s()
        device_info["window_s"] = rn.plain.trace.window_s
        out["breakdown"] = {"device_ops": rn.plain.trace.top_ops(10),
                            "idle_gaps": rn.stacked.trace.idle_gaps(10)}
    # every number computed, each beside its limit (None: not compared)
    out["checks"] = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                     for k in sorted(set(numbers) | set(limits))}
    out["_lines"] = ["calibration_s {} (the reference's, not in setup_s)".format(
        rn.calibration_s)]
    out["_lines"] += ["{} {} {}".format(k, v["value"], "not compared" if v["limit"] is None
                                        else "limit {}".format(v["limit"]))
                      for k, v in out["checks"].items()]
    return out


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _traced(rn: Run, pool, call, program, recorder, n_requests: int) -> Session:
    """``n_requests`` requests, from the pool's first, under ``recorder``."""
    from . import trace as trace_mod

    sess = Session()
    before = (program.redispatches, program.nms_s)
    with recorder:
        sess.failed = _drive(sess, pool, call, n_requests, None)
    sess.trace = trace_mod.Trace(recorder.events, recorder.window_us)
    sess.window_s = sess.trace.window_s
    sess.redispatches = program.redispatches - before[0]
    sess.nms_s = program.nms_s - before[1]
    return sess


def _drive(rn: Session, pool, call, n_requests: Optional[int],
           deadline: Optional[float]) -> int:
    """Send requests back to back (one client) until ``n_requests`` were
    sent or the clock passed ``deadline``; returns how many failed."""
    failed, k = 0, 0
    while (n_requests is None or k < n_requests) and \
            (deadline is None or time.perf_counter() < deadline):
        idx, payload = pool.request(k)
        t0 = time.perf_counter()
        try:
            answers = call(payload)
        except (RuntimeError, ValueError) as exc:  # counted; the run goes on
            if "CUDA" in str(exc):  # the card's context may be lost
                raise
            answers, failed = None, failed + 1
        rn.requests.append({"k": k, "idx": idx, "t0": t0, "t1": time.perf_counter(),
                            "answers": answers})
        k += 1
    return failed


def judge(rn: Run, pool, det: dict) -> Dict[str, float]:
    """The reference's answer for every frame the requests carried, and the
    worst of each number over the requests."""
    import torch

    needed = sorted({f for r in rn.requests for f in r["idx"]} - set(rn.reference))
    for s in range(0, len(needed), REF_FRAMES):
        idx = needed[s:s + REF_FRAMES]
        answers = ref_cascade.detect(rn.stages, pool.frames_tensor(idx, rn.device),
                                     rn.geometry, rn.thresholds,
                                     min_neighbors=int(det["nms_opencv_min_neighbors"]),
                                     eps=float(det["nms_opencv_eps"]))
        rn.reference.update(zip(idx, answers))
        del answers
        _free(torch, rn.device)
    memo: Dict[tuple, Dict[str, float]] = {}
    per_request = []
    for r in rn.requests:
        if r["answers"] is None:
            continue
        key = (tuple(r["idx"]),) + tuple(a["ids"].tobytes() + a["boxes"].tobytes()
                                        + np.asarray(a["conf"]).tobytes()
                                        for a in r["answers"])
        if key not in memo:
            memo[key] = compare.request_numbers(
                r["answers"], [rn.reference[f] for f in r["idx"]], rn.geometry.boxes_int,
                int(det["nms_opencv_min_neighbors"]), float(det["nms_opencv_eps"]))
        per_request.append(memo[key])
    return compare.worst(per_request)
