#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA H100 (or another
sm_90a card):

    python3 chip_smoke.py

Phases (each checked; any failure exits non-zero):

  1. environment: CUDA must be available; prints torch/CUDA versions and the
     card's name and power limit;
  2. build: compiles every kernel source under
     rapidobjectdetectionusingcascadedcnns_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together;
  3. K1 (csrc/resample.cu) against its plain PyTorch version at the VGA
     path's shapes (16 VGA frames, 640 boxes at 24 px and 256 boxes at
     48 px, real window boxes of the VGA pyramid), with median times;
  4. the VGA path: ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic
     VGA YUV420 frames with the reference default architecture at full
     width (random weights from seed 0, bf16 compute); the launch counts
     are reset just before and read just after one detect call;
  5. card vs CPU on the VGA path: one frame, f32 compute with TF32 off,
     same weights; survivor window ids agree up to borderline flips;
  6. K1 against its plain version at the dense path's re-extraction
     shapes: 4 frames of 450x450, as many boxes of the scale-factor-1.005
     pyramid as the default capacities (16,512 at 24 px, 4,224 at 48 px);
  7. K2 (csrc/sched.cu) against its plain version on every slot of the
     FDDB-density schedule: 4 frames of 450x450 at scale factor 1.005;
  8. K4 (csrc/rowbound.cu) against its plain version on 450x450 frames with
     the dense path's default capacities of plan boxes (16,512 at 24 px,
     4,224 at 48 px): raw and merged windows, n_big and overflow;
  9. the dense path: ``CascadeDetector.detect_batch`` on 4 synthetic
     450x450 frames at scale factor 1.005 (crop mode, K2 stage 0), with
     enough re-dispatch retries to reach the open capacities, then
     again with ``dyn_reextract="on"`` (K4), then ``SingleNetDetector``
     (the 12 px stage) on one frame; the launch counts are reset just
     before and read just after each detect call;
  10. card vs CPU in crop mode: one 256x320 frame at scale factor 1.02
     (25,534 windows, 119 levels), f32 with TF32 off, with the default
     kernels and again with ``dyn_reextract="on"``.

Kernels against plain versions: at most 1e-4 of the values may differ, each
by at most 1 (bit-exact is expected). The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on its path, error, times and bound (K1 once for each path,
at that path's shapes); the line before that is
the card's name and power limit. Without CUDA the script prints a message
to stderr and exits 2.
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
CAPS_BY_SIZE = {24: 640, 48: 256}  # the VGA path's default capacities
DENSE_FRAMES = 4
DENSE_HW = (450, 450)
DENSE_WSF = 1.005
DENSE_WINDOWS = 131903
DENSE_CAPS_BY_SIZE = {24: 16512, 48: 4224}  # the dense path's default capacities
CROP_CHECK = (256, 320, 1.02)  # card-vs-CPU crop-mode frame: 25,534 windows
MAX_BAD_FRACTION = 1e-4  # kernel vs plain: values allowed to differ, each by at most 1
BORDERLINE_FRACTION = 0.02  # survivor flips allowed between two runs

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# f32 operations per output value of K1, K2 and K4: 4 tap weights x 3
# (subtract, abs, 1 - x), 2 vertical sums x 3, 1 horizontal sum x 3,
# round and two clips 3
OPS_PER_VALUE = 24


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


def _bound(tensors_in, tensors_out, n_values):
    """(bound ms, "bytes" or "operations"): the larger of the bytes moved
    (inputs read once, outputs written once) over HBM bandwidth and the
    f32 operations over the f32 peak."""
    n_bytes = sum(t.numel() * t.element_size() for t in list(tensors_in) + list(tensors_out))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_values * OPS_PER_VALUE / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _compare(got, ref, what):
    """Values differing between a kernel and its plain version; asserts the
    tolerance. Returns (n_differing, n_total, max_abs_err)."""
    assert got.shape == ref.shape, (what, tuple(got.shape), tuple(ref.shape))
    diff = (got.float() - ref.float()).abs()
    n_bad = int((diff > 0).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    assert err <= 1.0 and n_bad <= MAX_BAD_FRACTION * diff.numel(), (what, n_bad, err)
    return n_bad, diff.numel(), err


def _quietly(fn, *args):
    """Call ``fn`` with its stdout (the detector's per-re-dispatch
    saturation warnings) captured; returns its result."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _flips(res_a, res_b):
    ids_a, ids_b = set(res_a.raw_window_ids.tolist()), set(res_b.raw_window_ids.tolist())
    flips = ids_a ^ ids_b
    allowed = BORDERLINE_FRACTION * max(len(ids_a | ids_b), 1)
    return flips, allowed, ids_a, ids_b


def _reset_launches():
    for m in _kernel_modules():
        m.LAUNCHES = 0


def _kernel_modules():
    """The kernel wrappers, whose ``LAUNCHES`` counts the path's launches."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        windows_cuda,
        windows_dyn_cuda,
        windows_sched_cuda,
    )

    return windows_cuda, windows_sched_cuda, windows_dyn_cuda


def vga_frames(n: int):
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

    return [
        rgb_to_yuv420(
            synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=s, min_face=48, max_face=120).image
        )
        for s in range(n)
    ]


def dense_frames(n: int):
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic

    h, w = DENSE_HW
    return [
        synthetic.make_scene(h, w, n_faces=3, seed=100 + s, min_face=40, max_face=160).image
        for s in range(n)
    ]


def vga_k1_inputs(torch, device, detector, frames):
    """K1's inputs on the VGA path: the decoded frames' bf16 planes and the
    VGA pyramid's window boxes."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import yuv420_to_rgb

    coords = detector._plan_and_table(IMG_H, IMG_W)[2].float()
    y = torch.as_tensor(np.stack([f[0] for f in frames]), device=device)
    uv = torch.as_tensor(np.stack([f[1] for f in frames]), device=device)
    return windows.to_planes_bf16(yuv420_to_rgb(y, uv)), coords


def dense_k1_inputs(torch, device, frames):
    """K1's inputs on the dense path: the frames' bf16 planes and the
    window boxes of the 450x450 pyramid at scale factor 1.005."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows

    plan = pyramid.build_plan(*DENSE_HW, 12, 12, 0.075, DENSE_WSF)
    assert plan.n_windows == DENSE_WINDOWS
    coords = torch.as_tensor(pyramid.window_table(plan)["coords_norm"], device=device).float()
    return windows.to_planes_bf16(_dense_images(torch, device, frames)), coords


def phase_k1(torch, label, planes, coords, caps_by_size):
    """K1 against its plain version at one path's re-extraction shapes:
    per frame and window size, as many of the path's window boxes as its
    default capacity."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows, windows_cuda

    n_frames, _, img_h, img_w = planes.shape
    gen = torch.Generator(device=planes.device).manual_seed(0)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for size, n in caps_by_size.items():
        ids = torch.randint(0, coords.shape[0], (n_frames, n), generator=gen,
                            device=planes.device)
        sy, sx = windows.sample_positions(coords[ids], img_h, img_w, size, size)
        sy, sx = sy.contiguous(), sx.contiguous()
        got = windows_cuda.crop_and_resize_cuda(planes, sy, sx)
        ref = windows.resample_plain(planes, sy, sx)
        torch.cuda.synchronize()
        assert got.shape == (n_frames, n, size, size, 3), got.shape
        n_bad, total, err = _compare(got, ref, "K1 {} {}px".format(label, size))
        del ref
        ms = _median_ms(lambda: windows_cuda.crop_and_resize_cuda(planes, sy, sx), torch)
        pms = _median_ms(lambda: windows.resample_plain(planes, sy, sx), torch,
                         warmup=1, iters=5)
        bound_ms, bound_by = _bound((planes, sy, sx), (got,), got.numel())
        print("K1 ({}) {}px x {} boxes x {} frames {}x{}: {} of {} values differ (max {}), "
              "kernel {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms ({})".format(
                  label, size, n, n_frames, img_h, img_w, n_bad, total, err, ms, pms,
                  bound_ms, bound_by))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms"] += ms
        out["plain_ms"] += pms
        out["bound_ms"] += bound_ms
        out["bound_by"] = bound_by
    return out


def phase_vga_path(torch, detector, frames, kind, card):
    """4. The VGA path at full width; returns K1's launches in one batch."""
    windows_cuda, windows_sched_cuda, windows_dyn_cuda = _kernel_modules()
    _quietly(detector.detect_batch_yuv420, frames)  # warm-up (cuDNN/cuBLAS plans)
    detector.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    results = _quietly(detector.detect_batch_yuv420, frames)
    first_s = time.perf_counter() - t0
    launches = windows_cuda.LAUNCHES
    assert len(results) == N_FRAMES
    assert launches >= 2, "K1 was launched {} times on the VGA path".format(launches)
    assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == 0
    for r in results:
        assert r.n_windows == 5061, r.n_windows
        assert r.boxes.ndim == 2 and r.boxes.shape[1] == 4 and bool((r.boxes == r.boxes).all())
        s = r.n_survivors_per_stage
        assert len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
        assert 0 <= s[0] <= r.n_windows
        assert len(r.raw_window_ids) == s[2]
    print("VGA path: n_windows 5061, survivors per stage per frame:",
          [r.n_survivors_per_stage for r in results])
    print("VGA path: saturation re-dispatches {}, K1 launches {}, detections per "
          "frame {}".format(detector.redispatches, launches, [len(r.boxes) for r in results]))
    batch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(detector.detect_batch_yuv420, frames)
        batch_s.append(time.perf_counter() - t0)
    med = statistics.median(batch_s)
    print("VGA path: 16-frame batch {:.4f} s median of {} (first timed {:.4f} s) = "
          "{:.2f} frames/s on {} [{}]".format(
              med, [round(x, 4) for x in batch_s], first_s, N_FRAMES / med, kind, card))
    return launches


def phase_card_vs_cpu_vga(device, frames):
    """5. Card vs CPU on the VGA path, one frame, f32."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    cf.set("compute_dtype", "float32")
    model_cpu = cascade.build_cascade_model(seed=0, device="cpu")
    res_cpu = _quietly(cascade.CascadeDetector(model_cpu).detect_batch_yuv420, frames[:1])[0]
    res_gpu = _quietly(
        cascade.CascadeDetector(model_cpu.to(device)).detect_batch_yuv420, frames[:1]
    )[0]
    flips, allowed, ids_cpu, ids_gpu = _flips(res_cpu, res_gpu)
    common = sorted(ids_cpu & ids_gpu)
    conf_cpu = dict(zip(res_cpu.raw_window_ids.tolist(), res_cpu.raw_confidences.tolist()))
    conf_gpu = dict(zip(res_gpu.raw_window_ids.tolist(), res_gpu.raw_confidences.tolist()))
    conf_err = max((abs(conf_cpu[i] - conf_gpu[i]) for i in common), default=0.0)
    print("VGA card vs cpu (f32): survivors cpu {} gpu {}, flips {} (allowed {:.1f}), "
          "max |conf diff| on common {:.3g}, survivors per stage cpu {} gpu {}".format(
              len(ids_cpu), len(ids_gpu), sorted(flips), allowed, conf_err,
              res_cpu.n_survivors_per_stage, res_gpu.n_survivors_per_stage))
    assert len(flips) <= allowed, flips
    assert res_cpu.n_windows == res_gpu.n_windows == 5061
    cf.set("compute_dtype", "bfloat16")


def _dense_images(torch, device, frames):
    import numpy as np

    return torch.as_tensor(np.stack(frames), device=device).float()


def phase_k2(torch, device, frames):
    """7. K2 against its plain version on every slot of the FDDB-density
    schedule."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        pyramid,
        windows,
        windows_sched,
        windows_sched_cuda,
    )

    plan = pyramid.build_plan(*DENSE_HW, 12, 12, 0.075, DENSE_WSF)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    assert sched is not None and plan.n_windows == DENSE_WINDOWS
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=device)
    images = _dense_images(torch, device, frames)
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, device)
    planes = windows.to_planes_bf16(images)

    def kernel():
        return windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile)

    def plain():
        return windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    n_bad, total, err = _compare(got, ref, "K2")
    del ref
    ms = _median_ms(kernel, torch)
    pms = _median_ms(plain, torch, warmup=1, iters=5)
    bound_ms, bound_by = _bound((planes, sy, sx, tiles), (got,), got.numel())
    print("K2 {} frames {}x{} wsf {}: n_slots {} for {} windows in {} classes {}; "
          "{} of {} values differ (max {}), kernel {:.4f} ms, plain {:.4f} ms, bound "
          "{:.4f} ms ({})".format(
              DENSE_FRAMES, DENSE_HW[0], DENSE_HW[1], DENSE_WSF, sched.n_slots,
              plan.n_windows, len(sched.classes),
              [(c.cell_r, c.cell_c, c.n_tiles) for c in sched.classes],
              n_bad, total, err, ms, pms, bound_ms, bound_by))
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_k4(torch, device, frames):
    """8. K4 against its plain version at the dense path's capacities."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows_dyn, windows_dyn_cuda

    plan = pyramid.build_plan(*DENSE_HW, 12, 12, 0.075, DENSE_WSF)
    coords = torch.as_tensor(pyramid.window_table(plan)["coords_norm"]).float()
    images_cpu = _dense_images(torch, "cpu", frames)
    images = images_cpu.to(device)
    gen = torch.Generator().manual_seed(7)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for size, n in DENSE_CAPS_BY_SIZE.items():
        boxes_cpu = coords[torch.randint(0, plan.n_windows, (DENSE_FRAMES, n), generator=gen)]
        boxes = boxes_cpu.to(device)
        lay = windows_dyn.small_class(images, boxes, size, size)
        ref_raw = windows_dyn.resample_rowbound_plain(
            lay["planes"], lay["sy_local"], lay["sx"], lay["cell_start"], lay["tile"],
            windows_dyn.ROW_RUNG, lay["w_pad"],
        )
        torch.cuda.synchronize()
        n_bad, total, err = _compare(lay["raw"], ref_raw, "K4 raw {}px".format(size))
        del ref_raw
        big_cap = windows_dyn.default_big_cap(n, size, size, DENSE_HW[0])
        wins, n_big, ovf = windows_dyn.extract_rowbound(images, boxes, size, size, big_cap=big_cap)
        wins_ref, n_big_ref, ovf_ref = windows_dyn.extract_rowbound(
            images_cpu, boxes_cpu, size, size, big_cap=big_cap
        )
        m_bad, m_total, m_err = _compare(wins.cpu(), wins_ref, "K4 merged {}px".format(size))
        assert n_big.tolist() == n_big_ref.tolist(), (n_big, n_big_ref)
        assert ovf.tolist() == ovf_ref.tolist(), (ovf, ovf_ref)
        args = (lay["planes"], lay["sy_local"], lay["sx"], lay["cell_start"], lay["tile"],
                windows_dyn.ROW_RUNG, lay["w_pad"])
        ms = _median_ms(lambda: windows_dyn_cuda.resample_rowbound_cuda(*args), torch)
        pms = _median_ms(lambda: windows_dyn.resample_rowbound_plain(*args), torch,
                         warmup=1, iters=5)
        bound_ms, bound_by = _bound(args[:4], (lay["raw"],), lay["raw"].numel())
        print("K4 {}px x {} boxes x {} frames {}x{}: raw {} of {} values differ (max {}), "
              "merged {} of {} differ (max {}), n_big {} overflow {} (big_cap {}); kernel "
              "{:.4f} ms, plain {:.4f} ms, bound {:.4f} ms ({})".format(
                  size, n, DENSE_FRAMES, DENSE_HW[0], DENSE_HW[1], n_bad, total, err,
                  m_bad, m_total, m_err, n_big.tolist(), ovf.tolist(), big_cap, ms, pms,
                  bound_ms, bound_by))
        out["max_abs_err"] = max(out["max_abs_err"], err, m_err)
        out["ms"] += ms
        out["plain_ms"] += pms
        out["bound_ms"] += bound_ms
        out["bound_by"] = bound_by
    return out


def _dense_detect(torch, detector, frames, label, kind, card, repeats=3):
    """One counted dense detect (launch counts reset just before and read
    just after), then ``repeats - 1`` more for the median wall."""
    _reset_launches()
    detector.redispatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = _quietly(detector.detect_batch, frames)
    walls = [time.perf_counter() - t0]
    launches = tuple(m.LAUNCHES for m in _kernel_modules())
    redispatches = detector.redispatches
    for _ in range(repeats - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(detector.detect_batch, frames)
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    for r in results:
        assert r.n_windows == DENSE_WINDOWS, r.n_windows
        s = r.n_survivors_per_stage
        assert len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
        assert len(r.raw_window_ids) == s[2]
        assert r.boxes.ndim == 2 and r.boxes.shape[1] == 4 and bool((r.boxes == r.boxes).all())
    print("dense path ({}): survivors per stage per frame {}, re-extract overflows {}".format(
        label, [r.n_survivors_per_stage for r in results],
        [r.reextract_overflows for r in results]))
    print("dense path ({}): launches K1 {} K2 {} K4 {}, saturation re-runs {} in the "
          "counted batch; {}-frame batch {:.4f} s median of {} = {:.2f} frames/s on {} "
          "[{}]".format(label, *launches, redispatches, DENSE_FRAMES, med,
                        [round(x, 4) for x in walls], DENSE_FRAMES / med, kind, card))
    return results, launches


def phase_dense_path(torch, device, model, frames, kind, card):
    """9. The dense path at full width, default kernels then K4, then the
    single-net detector. Returns K1's and K2's launches on the default run
    and K4's on the dyn_reextract run."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade, single

    cf.set("window_scale_factor", DENSE_WSF)
    detector = cascade.CascadeDetector(model)
    plan = detector._plan_and_table(*DENSE_HW)[0]
    assert plan.n_windows == DENSE_WINDOWS and plan.n_scales > 48
    assert cascade.resolve_extraction_mode(plan) == "crop"
    assert cascade.resolve_resample_impl() == "pallas2"
    # Random weights keep ~89k windows after stage 1, more than the 4th
    # rung's stage-2 capacity, so the default retry budget would end in a
    # truncated result; truncation depends on the stage-0 order, which a
    # K4 overflow's corrective K1 re-run changes (plan instead of scheduled
    # order). With enough retries to reach the open rung both runs are
    # exact and comparable.
    caps, rungs = cascade.default_capacity_schedule(DENSE_WINDOWS, model.n_nets), 0
    while True:
        caps = cascade.escalate_capacities(caps, DENSE_WINDOWS)
        if caps is None:
            break
        rungs += 1
    retries = cf.get("cascade_saturation_max_retries")
    cf.set("cascade_saturation_max_retries", rungs)
    print("dense path: cascade_saturation_max_retries {} (default {}) reaches the open "
          "rung".format(rungs, retries))
    base, (k1, k2, k4) = _dense_detect(torch, detector, frames, "default", kind, card)
    assert k2 >= 1 and k1 >= 2 and k4 == 0, (k1, k2, k4)

    cf.set("dyn_reextract", "on")
    assert cascade.resolve_resample_impl() == "pallas2dyn"
    # one run: host NMS makes a dense batch take tens of seconds
    dyn, (dk1, dk2, dk4) = _dense_detect(torch, detector, frames, "dyn_reextract on",
                                         kind, card, repeats=1)
    assert dk4 >= 1 and dk2 >= 1, (dk1, dk2, dk4)
    for a, b in zip(base, dyn):
        flips, allowed, _, _ = _flips(a, b)
        assert len(flips) <= allowed, (len(flips), allowed)
    print("dense path: K4 vs K1 re-extraction survivor flips per frame {}".format(
        [len(_flips(a, b)[0]) for a, b in zip(base, dyn)]))
    cf.set("dyn_reextract", "auto")
    cf.set("cascade_saturation_max_retries", retries)

    single_det = single.SingleNetDetector(
        model.stage_params[0], model.stage_configs[0], model.stage_means[0],
        model.stage_stds[0], device=device,
    )
    _quietly(single_det.detect, frames[0])  # warm-up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = single_det.detect(frames[0])
    wall = time.perf_counter() - t0
    windows_sched_cuda = _kernel_modules()[1]
    assert windows_sched_cuda.LAUNCHES >= 1
    assert res.n_windows == DENSE_WINDOWS
    print("dense path (SingleNetDetector, 12 px): K2 launches {}, foreground windows {}, "
          "detections {}, {:.4f} s".format(
              windows_sched_cuda.LAUNCHES, res.n_survivors_per_stage[0],
              len(res.boxes), wall))
    cf.set("window_scale_factor", 1.1)
    return k1, k2, dk4


def phase_card_vs_cpu_crop(device):
    """10. Card vs CPU in crop mode, f32, default kernels and K4."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    h, w, wsf = CROP_CHECK
    keys = ("compute_dtype", "window_scale_factor", "dyn_reextract", "cascade_capacity_schedule")
    saved = {key: cf.get(key) for key in keys}
    cf.set("compute_dtype", "float32")
    cf.set("window_scale_factor", wsf)
    model_cpu = cascade.build_cascade_model(seed=0, device="cpu")
    model_gpu = model_cpu.to(device)
    img = synthetic.make_scene(h, w, n_faces=2, seed=31, min_face=40, max_face=120).image
    for dyn in ("auto", "on"):
        cf.set("dyn_reextract", dyn)
        det_cpu = cascade.CascadeDetector(model_cpu)
        plan = det_cpu._plan_and_table(h, w)[0]
        assert cascade.resolve_extraction_mode(plan) == "crop" and plan.n_scales > 48
        # open capacities: one pass each, no saturation re-runs on the CPU
        cf.set("cascade_capacity_schedule", [plan.n_windows, plan.n_windows])
        t0 = time.perf_counter()
        res_cpu = _quietly(det_cpu.detect, img)
        cpu_s = time.perf_counter() - t0
        _reset_launches()
        res_gpu = _quietly(cascade.CascadeDetector(model_gpu).detect, img)
        launches = tuple(m.LAUNCHES for m in _kernel_modules())
        assert launches[1] >= 1 and (launches[2] >= 1) == (dyn == "on"), launches
        flips, allowed, ids_cpu, ids_gpu = _flips(res_cpu, res_gpu)
        print("crop card vs cpu (f32, dyn_reextract {}): {} windows over {} levels, "
              "survivors cpu {} gpu {}, flips {} (allowed {:.1f}), survivors per stage "
              "cpu {} gpu {}, launches K1 {} K2 {} K4 {}, cpu {:.2f} s".format(
                  dyn, plan.n_windows, plan.n_scales, len(ids_cpu), len(ids_gpu),
                  len(flips), allowed, res_cpu.n_survivors_per_stage,
                  res_gpu.n_survivors_per_stage, *launches, cpu_s))
        assert len(flips) <= allowed, flips
        assert res_cpu.n_windows == res_gpu.n_windows == plan.n_windows
    for key, value in saved.items():
        cf.set(key, value)


def _kernel_line(name, source, replaces, launches, m):
    return {
        "name": name,
        "route": "cuda",
        "source": "rapidobjectdetectionusingcascadedcnns_torch/csrc/" + source,
        "replaces": "rapidobjectdetectionusingcascadedcnns_tpu/" + replaces,
        "launches": launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        # no single PyTorch call keeps the kernels' two bf16 rounding points
        "library_ms": None,
    }


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
        from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
        from rapidobjectdetectionusingcascadedcnns_torch.ops import _build
    except ImportError as exc:
        print(
            "chip_smoke: cannot import the port ({}); run it from the "
            "repository root".format(exc),
            file=sys.stderr,
        )
        return 2

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

    # ---- 3-5. the VGA path -------------------------------------------------
    model = cascade.build_cascade_model(seed=0, device=device)
    detector = cascade.CascadeDetector(model)
    frames = vga_frames(N_FRAMES)
    k1_vga = phase_k1(torch, "VGA", *vga_k1_inputs(torch, device, detector, frames),
                      CAPS_BY_SIZE)
    k1_vga_launches = phase_vga_path(torch, detector, frames, kind, card)
    phase_card_vs_cpu_vga(device, frames)

    # ---- 6-10. the dense path ----------------------------------------------
    dense = dense_frames(DENSE_FRAMES)
    k1_dense = phase_k1(torch, "dense", *dense_k1_inputs(torch, device, dense),
                        DENSE_CAPS_BY_SIZE)
    torch.cuda.empty_cache()
    k2 = phase_k2(torch, device, dense)
    torch.cuda.empty_cache()
    k4 = phase_k4(torch, device, dense)
    torch.cuda.empty_cache()
    k1_dense_launches, k2_launches, k4_launches = phase_dense_path(
        torch, device, model, dense, kind, card
    )
    phase_card_vs_cpu_crop(device)

    loaded = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "rapidobjectdetectionusingcascadedcnns_tpu")
    )
    assert not loaded, "the port imported {}".format(loaded)
    print(card)
    print(json.dumps({"kernels": [
        _kernel_line("K1 crop_and_resize (VGA path re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", k1_vga_launches, k1_vga),
        _kernel_line("K1 crop_and_resize (dense path re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", k1_dense_launches, k1_dense),
        _kernel_line("K2 scheduled stage-0 extraction (crop mode)", "sched.cu",
                     "ops/windows_sched.py:259", k2_launches, k2),
        _kernel_line("K4 row-bounded re-extraction (dyn_reextract)", "rowbound.cu",
                     "ops/windows_dyn.py:83", k4_launches, k4),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
