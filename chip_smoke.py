#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 (or another
sm_90a card):

    python3 chip_smoke.py

Phases (each checked; any failure exits non-zero):

  1. environment: CUDA must be available; prints torch/CUDA versions and the
     card's name and power limit;
  2. build: compiles every kernel source under
     rapidobjectdetectionusingcascadedcnns_torch/csrc with nvcc (sm_90a);
  3. kernel vs plain: K1 (csrc/resample.cu) against its plain PyTorch
     version on the card, at the main path's shapes (16 VGA frames, 640
     boxes at 24 px and 256 boxes at 48 px, real window boxes of the VGA
     pyramid), with median times of both;
  4. main path: ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic VGA
     YUV420 frames with the reference default architecture at full width
     (random weights from seed 0, bf16 compute); the kernel launch counts are
     reset just before and read just after one detect call;
  5. card vs CPU: one frame, f32 compute with TF32 off, same weights; the
     stage-0 survivor window ids must agree up to borderline flips.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel with its launches, error and times. Without
CUDA the script prints a message to stderr and exits 2.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

N_FRAMES = 16
IMG_H, IMG_W = 480, 640
CAPS_BY_SIZE = {24: 640, 48: 256}  # the main path's default capacities
K1_MAX_BAD_FRACTION = 1e-4  # values allowed to differ, each by at most 1
BORDERLINE_FRACTION = 0.02  # survivor flips allowed between card and CPU


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, torch, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _frames(synthetic, rgb_to_yuv420, n: int):
    return [
        rgb_to_yuv420(
            synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=s, min_face=48, max_face=120).image
        )
        for s in range(n)
    ]


def _quietly(fn, *args):
    """Call ``fn`` with its stdout (the detector's per-re-dispatch
    saturation warnings) captured; returns its result."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def main() -> int:
    import torch

    # ---- 1. environment ------------------------------------------------
    if not torch.cuda.is_available():
        print(
            "chip_smoke: torch.cuda.is_available() is False -- this script "
            "needs an NVIDIA GPU; nothing was run",
            file=sys.stderr,
        )
        return 2
    try:
        from rapidobjectdetectionusingcascadedcnns_torch import config as cf
        from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
        from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
        from rapidobjectdetectionusingcascadedcnns_torch.ops import _build, windows, windows_cuda
        from rapidobjectdetectionusingcascadedcnns_torch.ops.color import (
            rgb_to_yuv420,
            yuv420_to_rgb,
        )
    except ImportError as exc:
        print(
            "chip_smoke: cannot import the port ({}); run it from the "
            "repository root".format(exc),
            file=sys.stderr,
        )
        return 2
    import numpy as np

    device = torch.device("cuda")
    card = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    print("device:", kind, "| nvidia-smi:", card)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print("build: {:.2f} s wall ({})".format(
        time.perf_counter() - t0,
        ", ".join("{} {:.2f} s".format(k, v) for k, v in built.items()),
    ))
    for name, log in _build.build_logs.items():
        print("nvcc[{}]: {}".format(name, log.strip().replace("\n", " | ")))

    # ---- 3. K1 vs its plain version, main-path shapes -----------------------
    # reference default architecture and pyramid (bench.py's workload)
    model = cascade.build_cascade_model(seed=0, device=device)
    detector = cascade.CascadeDetector(model)
    plan, _, coords_norm, _ = detector._plan_and_table(IMG_H, IMG_W)
    coords = coords_norm.float()
    frames = _frames(synthetic, rgb_to_yuv420, N_FRAMES)
    y = torch.as_tensor(np.stack([f[0] for f in frames]), device=device)
    uv = torch.as_tensor(np.stack([f[1] for f in frames]), device=device)
    images = yuv420_to_rgb(y, uv)
    gen = torch.Generator(device=device).manual_seed(0)
    planes = windows.to_planes_bf16(images)
    k1_err, k1_ms, plain_ms = 0.0, 0.0, 0.0
    for size, n in CAPS_BY_SIZE.items():
        ids = torch.randint(0, plan.n_windows, (N_FRAMES, n), generator=gen, device=device)
        sy, sx = windows.sample_positions(coords[ids], IMG_H, IMG_W, size, size)
        sy, sx = sy.contiguous(), sx.contiguous()
        got = windows_cuda.crop_and_resize_cuda(planes, sy, sx)
        ref = windows.resample_plain(planes, sy, sx)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (N_FRAMES, n, size, size, 3), got.shape
        diff = (got - ref).abs()
        n_bad = int((diff > 0).sum())
        err = float(diff.max())
        assert err <= 1.0 and n_bad <= K1_MAX_BAD_FRACTION * diff.numel(), (size, n_bad, err)
        ms = _median_ms(lambda: windows_cuda.crop_and_resize_cuda(planes, sy, sx), torch)
        pms = _median_ms(lambda: windows.resample_plain(planes, sy, sx), torch)
        print("K1 {}px x {} boxes x {} frames: {} of {} values differ (max {}), "
              "kernel {:.4f} ms, plain {:.4f} ms".format(
                  size, n, N_FRAMES, n_bad, diff.numel(), err, ms, pms))
        k1_err = max(k1_err, err)
        k1_ms += ms
        plain_ms += pms

    # ---- 4. the main path at full width ------------------------------------
    _quietly(detector.detect_batch_yuv420, frames)  # warm-up (cuDNN/cuBLAS plans)
    detector.redispatches = 0
    windows_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = _quietly(detector.detect_batch_yuv420, frames)
    first_s = time.perf_counter() - t0
    launches = windows_cuda.LAUNCHES
    assert len(results) == N_FRAMES
    assert launches >= 2, "K1 was launched {} times on the main path".format(launches)
    for r in results:
        assert r.n_windows == 5061, r.n_windows
        assert r.boxes.ndim == 2 and r.boxes.shape[1] == 4 and bool((r.boxes == r.boxes).all())
        s = r.n_survivors_per_stage
        assert len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
        assert 0 <= s[0] <= r.n_windows
        assert len(r.raw_window_ids) == s[2]
    print("main path: n_windows 5061, survivors per stage per frame:",
          [r.n_survivors_per_stage for r in results])
    print("main path: saturation re-dispatches {}, K1 launches {}, detections per "
          "frame {}".format(detector.redispatches, launches, [len(r.boxes) for r in results]))
    batch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(detector.detect_batch_yuv420, frames)
        batch_s.append(time.perf_counter() - t0)
    med = statistics.median(batch_s)
    print("main path: 16-frame batch {:.4f} s median of {} (first timed {:.4f} s) = "
          "{:.2f} frames/s on {} [{}]".format(
              med, [round(x, 4) for x in batch_s], first_s, N_FRAMES / med, kind, card))

    # ---- 5. card vs CPU, one frame, f32 ------------------------------------
    cf.set("compute_dtype", "float32")
    model_cpu = cascade.build_cascade_model(seed=0)
    res_cpu = _quietly(cascade.CascadeDetector(model_cpu).detect_batch_yuv420, frames[:1])[0]
    res_gpu = _quietly(
        cascade.CascadeDetector(model_cpu.to(device)).detect_batch_yuv420, frames[:1]
    )[0]
    ids_cpu = set(res_cpu.raw_window_ids.tolist())
    ids_gpu = set(res_gpu.raw_window_ids.tolist())
    flips = ids_cpu ^ ids_gpu
    allowed = BORDERLINE_FRACTION * max(len(ids_cpu | ids_gpu), 1)
    common = sorted(ids_cpu & ids_gpu)
    conf_cpu = dict(zip(res_cpu.raw_window_ids.tolist(), res_cpu.raw_confidences.tolist()))
    conf_gpu = dict(zip(res_gpu.raw_window_ids.tolist(), res_gpu.raw_confidences.tolist()))
    conf_err = max((abs(conf_cpu[i] - conf_gpu[i]) for i in common), default=0.0)
    print("card vs cpu (f32): survivors cpu {} gpu {}, flips {} (allowed {:.1f}), "
          "max |conf diff| on common {:.3g}, survivors per stage cpu {} gpu {}".format(
              len(ids_cpu), len(ids_gpu), sorted(flips), allowed, conf_err,
              res_cpu.n_survivors_per_stage, res_gpu.n_survivors_per_stage))
    assert len(flips) <= allowed, flips
    assert res_cpu.n_windows == res_gpu.n_windows == 5061
    cf.set("compute_dtype", "bfloat16")

    assert "jax" not in sys.modules, "the port imported jax"
    print(card)
    print(json.dumps({"kernels": [{
        "name": "K1 crop_and_resize (window re-extraction)",
        "route": "cuda",
        "source": "rapidobjectdetectionusingcascadedcnns_torch/csrc/resample.cu",
        "replaces": "rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_pallas.py:63",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
