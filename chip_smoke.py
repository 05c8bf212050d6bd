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
     48 px, real window boxes of the VGA pyramid), with median times and,
     as a yardstick, one ``grid_sample`` call on the same positions;
  4. the VGA path: ``CascadeDetector.detect_batch_yuv420`` on 16 synthetic
     VGA YUV420 frames with the reference default architecture at full
     width (random weights from seed 0, bf16 compute); the launch counts
     are reset just before and read just after one detect call; the batch
     walls (host NMS included) with ``native.available()``;
  5. card vs CPU on the VGA path: one frame, f32 compute with TF32 off,
     same weights; survivor window ids agree up to borderline flips;
  6. K1 against its plain version at the dense path's re-extraction
     shapes: 4 frames of 450x450, as many boxes of the scale-factor-1.005
     pyramid as the default capacities (16,512 at 24 px, 4,224 at 48 px);
  7. K2 (csrc/sched.cu) against its plain version on every slot of the
     FDDB-density schedule: 4 frames of 450x450 at scale factor 1.005;
     its shared memory a block, the share of its byte bound reached, and
     the tiles whose support exceeds its staging budget
     (``windows_sched_cuda.staging_bytes``);
  8. K4 (csrc/rowbound.cu) against its plain version on 450x450 frames with
     the dense path's default capacities of plan boxes (16,512 at 24 px,
     4,224 at 48 px): raw and merged windows, n_big and overflow; its slots
     and shared memory a block and the share of its byte bound reached;
  9. the dense path: ``CascadeDetector.detect_batch`` on 4 synthetic
     450x450 frames at scale factor 1.005 (crop mode, K2 stage 0), with
     enough re-dispatch retries to reach the open capacities, then
     again with ``dyn_reextract="on"`` (K4), then ``SingleNetDetector``
     (the 12 px stage) on one frame; the launch counts are reset just
     before and read just after each detect call; the batch walls (host
     NMS included) with ``native.available()``;
  10. card vs CPU in crop mode: one 256x512 frame at scale factor 1.04
     (7,936 windows, 49 levels), f32 with TF32 off, with the default
     kernels and again with ``dyn_reextract="on"``;
  11. K3 (csrc/cluster.cu) against its plain version on the 16 VGA frames'
     last-stage survivor boxes and alive masks: from an open-capacity
     [5061, 4096] run (N = 4096) and from a default-capacity run (N = 256),
     at eps 0.2 and 0.3 with min_neighbors 1, and on the dense path's
     last stage (4 frames of 450x450 at the default capacities, N = 4,224);
     every output equal; kernel launches (profiler) and host
     synchronisations (sync debug mode) in one call; the workspace at the
     dense open rung (N = 131,903) against the adjacency bitmask K3 kept
     before;
  12. the VGA path with the device NMS tail (``nms_on_device``): the 16
     frames at the default capacities with re-dispatch; raw survivors,
     final boxes and confidences equal to the host-NMS run of phase 4;
     K3 launches, and the batch wall with the tail against host NMS (with
     ``native.available()``);
  13. the serving bundle: a VGA YUV bundle (batch 16, capacities [5061,
     4096], one rung, device tail) exported, saved, loaded; its graph holds
     the ``rodc`` kernel operators; served results equal the live
     detector's at the same capacities, with K1 and K3 counted. Random
     weights leave more than 4096 stage-1 survivors in two frames, which
     the one-rung bundle truncates, so the live detector runs with
     re-dispatch off and truncates them the same way.
  14. K2p (csrc/sched_precomp.cu), the path of
     tools/profile_torch_sched_precomp.py: its ``profile`` at FDDB density
     (4 frames of 450x450 at scale factor 1.005; builds the tap matrices,
     K2p against K2 on the same frames, times both) with the launch counts
     reset just before and read just after (one launch a call); then K2p
     against its plain version and against K2, bit-equal, at FDDB density
     and at the VGA geometry (480x640 at 1.1, 768-wide cells), its two-tap
     violation count (0), its time beside its bound, ``grid_sample`` and
     K2, and the rate at which it reads the taps;
  15. full-width training: ``CascadeTrainer`` on the card with the
     reference default architecture (3 nets of 12/24/48 px, conv [32], fc1
     512, bf16, batch 1200, momentum SGD, dropout 0.5, online augmentation,
     AdaBoost-like re-weighting, bottleneck reuse) on a synthetic patch
     corpus of 12,000 samples (4,000 faces), so every stage takes 56 steps; only
     ``epochs_total`` is cut (50 -> 7). Per stage: steps, first and last
     loss, s/step, validation metrics, re-weighting error;
  16. the trained cascade detecting: saved with the port's checkpoint,
     reloaded through ``bridge.load_cascade`` on the card, the 16 VGA
     YUV420 frames through ``detect_batch_yuv420`` with the in-memory and
     the reloaded model, results equal; survivors per stage, re-dispatches,
     K1 launches (counted around the in-memory run) and the batch wall;
  17. card vs CPU for training: a tiny f32 cascade (conv [8], fc1 32, TF32
     off, dropout 1, augmentation off) trained 2 epochs on both; losses
     within 1e-4 relative, parameters within 1e-4 + 1e-3 relative;
  18. the flagship recipe (tools/train_torch_flagship.py: conv [32, 32],
     fc1 512, max_beta 2, min_beta 1, batch 512, positional augmentation,
     the mixed corpus with the committed hard examples x4), only its corpus
     (5,000/40,000 -> 2,000/6,000) and epochs (20 -> 12) cut: trained on
     the card (corpus seconds, s/step, loss first -> last falling on every
     stage, validation); its recall, false positives and survivor maxima on
     the 100 benchmark scenes at threshold 0.3 and min_neighbors 0, stage 0
     keeping under half of the 5,061 windows, and the capacities
     ``capacity_schedule_from_quality`` gives; the 16 VGA frames at those
     capacities in bf16 (wall, frames/s, re-dispatches, K1 launches, host
     NMS, ``native.available()``), K1 at those shapes against its plain
     version; bf16 card vs CPU on 4 frames, with cuBLAS's reduced-precision
     bf16 reduction on and off (flips at most 2% of the survivors as
     ``set_numerics`` leaves it); the device NMS tail equal to host NMS, K3
     at the flagship's last capacity; the dense 4-frame batch at the
     default capacities and with ``dyn_reextract="on"`` (walls,
     re-dispatches, K1/K2/K4 launches, host NMS and decoded rows);
  19. the FDDB app with phase 18's flagship at its threshold and
     min_neighbors: ``EvaluateFDDBApp`` on the card over the synthetic
     10-fold corpus (2 images a fold at its default sizes 240x320, 200x280,
     320x240) with its forced settings (scale factor 1.005, one image a
     call, corpus-derived resize buckets; crop mode, K2 then K1), the launch
     counts reset just before and read just after, and held to the
     dispatches: K2 once for each dispatch at a size with a K2 schedule,
     K1 over 16,384-box chunks for stage 0 at the size without one
     (320x240, narrower than 256 columns) and once for each re-extraction;
     images, s/image, re-dispatches, host plan and K2 schedule seconds per
     new size, host NMS, the ROC's last point (``fddb_roc.json`` written
     and not empty); K2 and K1 against their plain versions at this path's
     shapes (a scheduled-size corpus image at its default capacities, and
     K1's 12 px stage-0 chunk on a 320x240 one); then the same app on the CPU
     over the first 2 folds, at capacities from the card's survivor maxima,
     fold files compared: the same keys, survivor flips at most 2% and box
     counts apart by at most the flips;
  20. the runtime app: the flagship cascade against a 48 px single net
     (conv [32], fc1 512, fresh weights from seed 0) at VGA, scale factor
     1.1, threshold 0.5, min_neighbors 1, each family warmed then timed: on
     the card over 16 positive and 4 negative scenes, on the CPU over 4;
     fps and the cascade's speedup (the single net runs gather mode: no
     hand-written kernel);
  21. the CLI: ``python -m rapidobjectdetectionusingcascadedcnns_torch.run
     inference-cascade`` in a subprocess, on the flagship saved as a
     checkpoint and 3 VGA images set by a ``rodc_local.py`` overlay: exit 0
     and a detection count reported;
  22. dynamic-batch bundles: phase 18's flagship VGA YUV program exported
     with ``batch="dynamic"`` and ``platforms=("cuda", "cpu")`` (1 rung:
     no frame saturates the flagship's capacities, and a saturated frame
     would be truncated there and differ from the live re-dispatch),
     saved, loaded on the card and serving 1, 7, 16 and 23 frames, each
     equal to the live detector (K1 and K3 counted around each call; the
     stage CNNs' 16,384-row chunks straddle frames); then random weights at
     the default capacities [640, 256] through a 5-rung dynamic bundle
     that reaches [5061, 4096] over the 16 VGA frames: every
     saturated frame re-run alone, as many re-runs as the live detector's
     re-dispatches, results equal; the batch wall against the same programs
     re-running each frame padded to 16 copies (a static bundle's re-runs);
     then the flagship's program in crop mode (stage 0 through K2 over the
     VGA plan's 6,048-slot schedule, whose tables are constants of the
     program), dynamic and for ("cuda", "cpu"), saved, loaded on the card
     and serving the 16 frames equal to the live crop-mode detector, with
     exactly one K2, two K1 and one K3 launch a program call; K1 and K3
     held against their plain versions on the 23-frame call's 7-frame
     chunk and K2 on the crop-mode call's 16 frames;
  23. the cross-device bundles: phase 22's gather-mode and crop-mode
     bundles loaded on the CPU (programs moved there, no kernel launched)
     over 2 frames each against the card's results, compared as
     tools/cross_platform_torch_bundle.py compares them (matched detections
     within 1 px and 0.05 confidence, each unmatched detection and each
     scene out of tolerance with its survivor flips' stage probabilities
     on both devices);
  24. a short soak (tools/soak_torch_serving.py) of the live flagship
     detector and of phase 22's bundle: 8 batches of the 16 VGA frames
     each, latency drift, card memory after the warm-up and at the end,
     detections identical across repeats;
  25. tools/profile_torch_train.py's step times for the 12 / 24 / 48 px
     stages and 48 px with augmentation (conv [32], fc1 512, batch 1200, 4
     chained updates each) and its split of one update (augmentation,
     forward with the loss, backward, optimizer), which must give
     ``train_step``'s loss.
  26. the train apps through the CLI, each in a fresh process on the card
     set up by a ``rodc_local.py`` overlay: a label-folder corpus of 1,000
     face crops (``make_scene`` faces) and 2,000 ``draw_background``
     patches written as PNGs, then ``python -m ...run train-cascade``
     (the dataset built from the files at 12/24/48 px and cached as npz,
     3 nets trained at the default widths, exported) and ``train-single``
     (its 48 px dataset read from the cache); only ``epochs_total`` (50 ->
     3) and the constant-prediction guard (off) are cut; exit 0, the cache
     files, the checkpoints and ``final_results`` with the JAX package's
     keys; host seconds of the dataset build per size and of each stage;
  27. the visualizers in process: phase 26's checkpoint loaded on the card
     by ``InferenceCascadeApp`` through ``InferenceVisualizerApp`` on 4 VGA
     scenes (gather mode at 1.1, K1 re-extracts), K1 counted around the
     visualizer's run per dispatch shape (the first dispatch and each
     saturation re-dispatch rung) and held against its plain version at
     every one of those shapes; each overlay equal to ``draw_detections`` of its boxes;
     one scene again on the CPU (flips at most 2%, overlays equal where the
     boxes are); then ``InferenceOCVApp`` (Viola-Jones, on the host)
     through the same visualizer, s/image beside the cascade's;
  28. the tune app in process: ``TuneCascadeApp`` with random draws over
     the tune-cascade keys without ``cascade_n_nets`` on phase 26's corpus
     and cache, 2 sessions at a fixed seed, none failed, a global best,
     the configuration restored; a second app resumes from the state file;
  29. the appended Inception stage: phase 18's cut recipe with
     ``append_inception`` and the InceptionV3 fixture archive
     (``random_state_dict(3)`` converted; frozen trunk, embed-once), its
     corpus cut to 1,000/3,000 and the mined windows once so that the
     299 px rendering stays under about 2 GB (bytes, embed rate and the
     head's s/step printed), with the embedded rows' scale and a plain
     logistic head on raw and on per-feature standardized rows (why the
     recipe's head diverges on this trunk); the 4-stage cascade on the 16
     VGA YUV frames (batch wall, survivors per stage, K1 launches per
     launch shape, trunk device ms), counted as the other paths; card
     against CPU on 1 frame, and the Inception stage's first rows of that
     card run again on the CPU: the trunk's 2048-wide embeddings in bf16
     and in f32 (TF32 off; their row-to-row part too), and the stage's
     logits and probabilities before the threshold; the compact trunk
     trained end to end with augmentation (s/step over 10 synchronised
     updates); a static bundle (1 frame a call, 1 rung) equal to the live
     detector; K1 at 299 px (banded) held against its plain version at
     every shape those runs launched it at (one ``kernels`` entry per
     shape, with its launches), at 16 frames x 64 boxes and 1 frame x 256
     boxes (listed with 0 launches), and one launch of 8,192 boxes (over
     2^31 values) at its last boxes.
  30. meshes on the card: a 2-shard mesh (cuda:0, cuda:0) with phase 18's
     flagship at its capacities and operating point (host NMS): the 16 VGA
     YUV frames frame-sharded (8 a shard) against the single-device
     detector, in gather mode and in crop mode (K2 once a shard a dispatch,
     over the full plan's schedule), flips counted as phase 18 counts them,
     the walls, and one chunk's shards against its gather; one dense
     450x450 frame at scale factor 1.005 window-sharded in crop mode (K1 on
     each shard's boxes) and in gather mode against ``detect``; a few
     data-parallel steps of the 24 px stage (f32, TF32 off, augmentation,
     dropout 0.5) against one device from the same seed; NCCL at world size
     1 through ``multihost.initialize`` and the rehearsal in the group
     against the rehearsal alone; a frame-sharded static bundle (16 frames
     a call, programs of 8) against the live frame-sharded detector; a
     window-sharded bundle of the dense frame (crop mode, 1 rung) against
     the live window-sharded detection; K1 and K2 counted by launch shape
     (spies on their wrappers) in every counted run of the phase, and held
     against their plain versions at every shape launched: one ``kernels``
     entry per shape, with its launches summed over the runs that launched
     it (K1 at the frame-sharded shards' 24 and 48 px, at the
     window-sharded stage 0's 16,384-box chunks and their remainder, and at
     each shard's share of every capacity rung the re-dispatches reached).
     What one card cannot show (NCCL across two cards, two cards' shards
     overlapping) is printed as unverified.
  31. the analysis tools in process on phase 18's cut flagship at its
     operating point, host NMS, each run with K1 and K2 counted by launch
     shape (spies on their wrappers, reset just before and read just
     after): tools/operating_torch_points.py's grid at 3 thresholds x 2
     min_neighbors over 20 benchmark scenes (its headline by the JAX rule);
     tools/runtime_torch_density_sweep.py's ``--quick`` (VGA at 1.1 and
     1.02, 1 pass) against a 48 px single net of fresh weights from seed
     0, as phase 20 builds it: at 1.02 both stage 0s run in crop mode, K2
     at 12 px for the cascade and at 48 px for the single net (at least one
     48 px launch); K2 held against its plain version at every shape the
     sweep launched it at (one ``kernels`` entry a shape); the bucketing
     delta (tools/fddb_torch_bucketing_delta.py) on 1 fold; the ROC tool
     with ``--reference-default --corpus-dir`` on phase 19's corpus
     (threshold 0.5, min_neighbors 1, no resize buckets, the corpus
     reused); tools/profile_torch_batch.py at VGA (1-16 frames) and
     tools/profile_torch_cnn.py at 131,903 windows. K1 held against its
     plain version at every (frames, boxes, window size, frame size) the
     tools launched it at, on the inputs of its first launch there (one
     ``kernels`` entry each, its launches summed over the tools).

Phases 19 and 20 run their CPU legs on 1 fold and 2 scenes (2 and 4 until
phases 26-28 came) and phase 10 on a 256x512 frame at 1.04 (7,936
windows; 256x320, 13,367, until phase 31 came), to keep the script's time.

Kernels against plain versions: at most 1e-4 of the values may differ, each
by at most 1 (bit-exact is expected); K3's and K2p's outputs must be equal.
``library_ms`` of K1, K2, K2p and K4 is one ``torch.nn.functional.grid_sample``
call (f32 bilinear, border padding) at the same sampling positions: a time
yardstick without the two bf16 rounding points and the u8 quantisation,
never called by the port; K3 has none. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on its path, error, times and bound (K1 once for each path,
at that path's shapes; K2, K1's re-extraction and K1's stage 0 also for the
FDDB app; K1 and K3 also for phase 22's dynamic bundle, K2 for its
crop-mode bundle; K1 for phase 27's visualizer, once for each dispatch
shape; K1 at 299 px for phase 29, once for each held shape; K1 and K2 at
each of phase 30's shard-local launch shapes; K2 at each shape phase 31's
density sweep launched it at, 12 and 48 px, and K1 at each shape phase
31's tools launched it at); the line before that is the
card's name and power limit. Without
CUDA the script prints a message to stderr and exits 2.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_FRAMES = 16
IMG_H, IMG_W = 480, 640
VGA_WINDOWS = 5061
CAPS_BY_SIZE = {24: 640, 48: 256}  # the VGA path's default capacities
OPEN_CAPS = [VGA_WINDOWS, 4096]  # the VGA path's open rung
DENSE_FRAMES = 4
DENSE_HW = (450, 450)
DENSE_WSF = 1.005
DENSE_WINDOWS = 131903
DENSE_CAPS_BY_SIZE = {24: 16512, 48: 4224}  # the dense path's default capacities
# card-vs-CPU crop-mode frame: 7,936 windows over 49 levels, K4's gate open
# (256x320 until phase 31 came, 13,367 over 61; at 1.02 until phase 29
# came, 25,534 over 119: the CPU legs cut to keep the script's time)
CROP_CHECK = (256, 512, 1.04)
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


def _median_ms(fn, torch, warmup: int = 3, iters: int = 20, reps: int = 10) -> float:
    """Median over ``iters`` samples of the time per call, each sample
    ``reps`` calls back to back between two CUDA events (so that the
    host's launch overhead overlaps the card's work where the call does
    not synchronise)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _bound(tensors_in, tensors_out, n_values):
    """(bound ms, "bytes" or "operations"): the larger of the bytes moved
    (inputs read once, outputs written once) over HBM bandwidth and the
    f32 operations over the f32 peak."""
    n_bytes = sum(t.numel() * t.element_size() for t in list(tensors_in) + list(tensors_out))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_values * OPS_PER_VALUE / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _grid_sample_ms(torch, planes, sy, sx):
    """``library_ms``: the median time of one ``grid_sample`` call (f32
    bilinear, border padding, half-pixel centres) of ``planes`` (B, C, H,
    W) at the sampling positions ``sy`` (B, N, oh) and ``sx`` (B, N, ow),
    in global pixel coordinates. The f32 planes and the grid are built
    before the timed call. A yardstick only: no bf16 rounding points and
    no u8 quantisation, and the port never calls it."""
    import torch.nn.functional as F

    b, _, h, w = planes.shape
    n, oh, ow = sy.shape[1], sy.shape[2], sx.shape[2]
    gy = ((2.0 * sy + 1.0) / h - 1.0)[..., :, None].expand(b, n, oh, ow)
    gx = ((2.0 * sx + 1.0) / w - 1.0)[..., None, :].expand(b, n, oh, ow)
    grid = torch.stack([gx, gy], dim=-1).reshape(b, n * oh, ow, 2)
    pf = planes.float()
    ms = _median_ms(lambda: F.grid_sample(pf, grid, mode="bilinear", padding_mode="border",
                                          align_corners=False), torch)
    del grid, pf
    return ms


def _native():
    """Whether host NMS ran the native groupRectangles library (else its
    numpy fallback), for the host-NMS walls."""
    from rapidobjectdetectionusingcascadedcnns_torch import native

    return native.available()


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


# K3's bound: about 16 f32 operations per pair (i < j) of rows of a frame
# (the SimilarRects test is symmetric, so each pair is tested once); bytes
# per row in and out: rects 16, valid 1, avg 16, counts 4, keep 1, labels 8
K3_OPS_PER_PAIR = 16
K3_BYTES_PER_ROW = 46


def _reset_launches():
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched_precomp_cuda

    for m in _kernel_modules() + (windows_sched_precomp_cuda,):
        m.LAUNCHES = 0


def _kernel_modules():
    """The kernel wrappers, whose ``LAUNCHES`` counts the path's launches."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        nms_cuda,
        windows_cuda,
        windows_dyn_cuda,
        windows_sched_cuda,
    )

    return windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda


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
    """K1's inputs on a dense path: the frames' bf16 planes and the window
    boxes of their pyramid at scale factor 1.005 (450x450 on the dense
    path)."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows

    hw = frames[0].shape[:2]
    plan = pyramid.build_plan(*hw, 12, 12, 0.075, DENSE_WSF)
    assert hw != DENSE_HW or plan.n_windows == DENSE_WINDOWS
    coords = torch.as_tensor(pyramid.window_table(plan)["coords_norm"], device=device).float()
    return windows.to_planes_bf16(_dense_images(torch, device, frames)), coords


def phase_k1(torch, label, planes, coords, caps_by_size):
    """K1 against its plain version at one path's re-extraction shapes:
    per frame and window size, as many of the path's window boxes as its
    default capacity."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows

    n_frames, _, img_h, img_w = planes.shape
    gen = torch.Generator(device=planes.device).manual_seed(0)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for size, n in caps_by_size.items():
        ids = torch.randint(0, coords.shape[0], (n_frames, n), generator=gen,
                            device=planes.device)
        sy, sx = windows.sample_positions(coords[ids], img_h, img_w, size, size)
        m = _k1_hold(torch, label, planes, sy.contiguous(), sx.contiguous())
        out["max_abs_err"] = max(out["max_abs_err"], m["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            out[key] += m[key]
        out["bound_by"] = m["bound_by"]
    return out


def _k1_hold(torch, label, planes, sy, sx):
    """K1 against its plain version at one launch shape: ``planes`` (B, C,
    H, W) bf16 sampled at ``sy`` (B, N, s) and ``sx`` (B, N, s). Returns
    the metrics of one ``kernels`` entry."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows, windows_cuda

    n_frames, _, img_h, img_w = planes.shape
    n, size = sy.shape[1], sy.shape[2]
    per_block, band, smem = windows_cuda.launch_geometry(size, size, 3)
    got = windows_cuda.crop_and_resize_cuda(planes, sy, sx)
    ref = windows.resample_plain(planes, sy, sx)
    torch.cuda.synchronize()
    assert got.shape == (n_frames, n, size, size, 3), got.shape
    n_bad, total, err = _compare(got, ref, "K1 {} {}px".format(label, size))
    del ref
    ms = _median_ms(lambda: windows_cuda.crop_and_resize_cuda(planes, sy, sx), torch)
    pms = _median_ms(lambda: windows.resample_plain(planes, sy, sx), torch,
                     warmup=1, iters=5, reps=1)
    lib_ms = _grid_sample_ms(torch, planes, sy, sx)
    bound_ms, bound_by = _bound((planes, sy, sx), (got,), got.numel())
    print("K1 ({}) {}px x {} boxes x {} frames {}x{}: {} of {} values differ (max {}), "
          "kernel {:.4f} ms, plain {:.4f} ms, grid_sample {:.4f} ms, bound {:.4f} ms ({}; "
          "{:.1%} of it); {} boxes per block, {} rows a block, {} B of shared "
          "memory".format(
              label, size, n, n_frames, img_h, img_w, n_bad, total, err, ms, pms, lib_ms,
              bound_ms, bound_by, bound_ms / ms, per_block, band, smem))
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_vga_path(torch, detector, frames, kind, card):
    """4. The VGA path at full width; returns K1's launches in one batch
    and the counted batch's results."""
    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
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
    assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
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
          "{:.2f} frames/s, host NMS with native.available() {}, on {} [{}]".format(
              med, [round(x, 4) for x in batch_s], first_s, N_FRAMES / med, _native(), kind,
              card))
    return launches, results


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


def _k2_hold(torch, planes, plan, sched, label):
    """K2 against its plain version on every slot of ``sched`` (the
    schedule of ``plan``'s windows, 12 px for the cascade's stage 0, 48 px
    for the single net's) over the frames' bf16 ``planes``: error, times,
    grid_sample's time and the bound."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        pyramid,
        windows,
        windows_sched,
        windows_sched_cuda,
    )

    device, hw = planes.device, tuple(planes.shape[2:])
    boxes = torch.as_tensor(pyramid.window_table(plan)["boxes_float"], device=device)
    sy, sx, tiles = windows_sched.scheduled_positions(boxes, sched, device)

    def kernel():
        return windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile)

    def plain():
        return windows_sched.resample_sched_plain(planes, sy, sx, tiles, sched.tile)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    n_bad, total, err = _compare(got, ref, "K2 " + label)
    del ref
    ms = _median_ms(kernel, torch)
    pms = _median_ms(plain, torch, warmup=1, iters=5, reps=1)
    # the yardstick samples every slot at its global positions
    order = sched.device_tables(device)[0]
    gsy, gsx = windows.sample_positions(boxes, *hw, sched.out_h, sched.out_w)
    n_frames = planes.shape[0]
    lib_ms = _grid_sample_ms(torch, planes, gsy[order].expand(n_frames, -1, -1),
                             gsx[order].expand(n_frames, -1, -1))
    bound_ms, bound_by = _bound((planes, sy, sx, tiles), (got,), got.numel())
    smem, budget = windows_sched_cuda.launch_geometry(sched.tile, sched.out_h, sched.out_w,
                                                      planes.shape[1])
    staged = windows_sched_cuda.staging_bytes(sy, sx, tiles, sched.tile, planes.shape[1], *hw)
    n_direct = int(((staged < 0) | (staged > budget)).sum())
    print("K2 ({}) {} frames {}x{} at {} px: n_slots {} (tiles of {}) for {} windows in {} "
          "classes {}; "
          "{} of {} values differ (max {}), kernel {:.4f} ms, plain {:.4f} ms, grid_sample "
          "{:.4f} ms, bound {:.4f} ms ({}), {:.1%} of the bound reached; {} B shared a "
          "block, staging budget {} B, staged support per tile median {:.0f} B max {} B, "
          "{} of {} tiles over the budget (sampled from the planes)".format(
              label, n_frames, hw[0], hw[1], sched.out_h, sched.n_slots, sched.tile,
              plan.n_windows, len(sched.classes),
              [(c.cell_r, c.cell_c, c.n_tiles) for c in sched.classes],
              n_bad, total, err, ms, pms, lib_ms, bound_ms, bound_by, bound_ms / ms, smem,
              budget, float(np.median(staged)), int(staged.max()), n_direct, sched.n_tiles))
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_k2(torch, device, frames):
    """7. K2 against its plain version on every slot of the FDDB-density
    schedule of the frames (4 of 450x450 on the dense path; one corpus
    image in phase 19)."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows, windows_sched

    hw = frames[0].shape[:2]
    plan = pyramid.build_plan(*hw, 12, 12, 0.075, DENSE_WSF)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    assert sched is not None and (hw != DENSE_HW or plan.n_windows == DENSE_WINDOWS)
    planes = windows.to_planes_bf16(_dense_images(torch, device, frames))
    return _k2_hold(torch, planes, plan, sched, "wsf {}".format(DENSE_WSF))


def phase_k4(torch, device, frames):
    """8. K4 against its plain version at the dense path's capacities."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        pyramid,
        windows,
        windows_dyn,
        windows_dyn_cuda,
    )

    plan = pyramid.build_plan(*DENSE_HW, 12, 12, 0.075, DENSE_WSF)
    coords = torch.as_tensor(pyramid.window_table(plan)["coords_norm"]).float()
    images_cpu = _dense_images(torch, "cpu", frames)
    images = images_cpu.to(device)
    gen = torch.Generator().manual_seed(7)
    frame_planes = windows.to_planes_bf16(images)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
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
                         warmup=1, iters=5, reps=1)
        lib_ms = _grid_sample_ms(
            torch, frame_planes, *windows.sample_positions(boxes, *DENSE_HW, size, size))
        bound_ms, bound_by = _bound(args[:4], (lay["raw"],), lay["raw"].numel())
        per_block, smem = windows_dyn_cuda.launch_geometry(size, size, frame_planes.shape[1])
        print("K4 {}px x {} boxes x {} frames {}x{}: raw {} of {} values differ (max {}), "
              "merged {} of {} differ (max {}), n_big {} overflow {} (big_cap {}); kernel "
              "{:.4f} ms, plain {:.4f} ms, grid_sample {:.4f} ms, bound {:.4f} ms ({}), "
              "{:.1%} of the bound reached; {} slots and {} B shared a block".format(
                  size, n, DENSE_FRAMES, DENSE_HW[0], DENSE_HW[1], n_bad, total, err,
                  m_bad, m_total, m_err, n_big.tolist(), ovf.tolist(), big_cap, ms, pms,
                  lib_ms, bound_ms, bound_by, bound_ms / ms, per_block, smem))
        out["max_abs_err"] = max(out["max_abs_err"], err, m_err)
        out["ms"] += ms
        out["plain_ms"] += pms
        out["library_ms"] += lib_ms
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
    launches = tuple(m.LAUNCHES for m in _kernel_modules()[:3])
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
          "counted batch; {}-frame batch {:.4f} s median of {} = {:.2f} frames/s, host NMS "
          "with native.available() {}, on {} [{}]".format(
              label, *launches, redispatches, DENSE_FRAMES, med, [round(x, 4) for x in walls],
              DENSE_FRAMES / med, _native(), kind, card))
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
        plan = cascade.CascadeDetector(model_cpu)._plan_and_table(h, w)[0]
        assert cascade.resolve_extraction_mode(plan) == "crop" and plan.n_scales > 48
        # open capacities: one pass each, no saturation re-runs on the CPU
        # (a detector reads them when it is made)
        cf.set("cascade_capacity_schedule", [plan.n_windows, plan.n_windows])
        det_cpu = cascade.CascadeDetector(model_cpu)
        t0 = time.perf_counter()
        res_cpu = _quietly(det_cpu.detect, img)
        cpu_s = time.perf_counter() - t0
        _reset_launches()
        res_gpu = _quietly(cascade.CascadeDetector(model_gpu).detect, img)
        launches = tuple(m.LAUNCHES for m in _kernel_modules()[:3])
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


def _k3_inputs(torch, detector, frames, caps, yuv=True):
    """K3's inputs on a path's tail: the last-stage survivor boxes (xywh of
    ``coords_norm[window_ids]``) and alive masks of one run of ``frames``
    at ``caps``, as (B, caps[-1], 4) f32 and (B, caps[-1]) bool."""
    img_h, img_w = (IMG_H, IMG_W) if yuv else DENSE_HW
    entry = detector._plan_and_table(img_h, img_w)
    packed = _quietly(detector._run_chunk, frames, yuv, caps, entry, None)
    c = caps[-1]
    xyxy = entry[2][packed[:, :c].long()].float()
    rects = torch.cat([xyxy[..., :2], xyxy[..., 2:] - xyxy[..., :2]], dim=-1)
    return rects.contiguous(), (packed[:, 2 * c : 3 * c] > 0.5).contiguous()


def _k3_call_counts(torch, rects, alive):
    """Kernel launches (profiler) and host synchronisations (sync debug
    mode) in one K3 call."""
    import warnings

    from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        nms_cuda.group_rectangles_cuda(rects, alive, 1, 0.2)
        torch.cuda.synchronize()
    kernels = [(e.name.replace("(anonymous namespace)::", "").split("(")[0], e.device_time_total)
               for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            nms_cuda.group_rectangles_cuda(rects, alive, 1, 0.2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return kernels, syncs


def _k3_case(torch, rects, alive, label, call_counts=True):
    """K3 against its plain version at eps 0.2 and 0.3 (every output
    equal), then its times, bound and, with ``call_counts``, its launches
    and synchronisations in one call (phase 11 holds those; a profiler
    session late in the process has been seen to record no kernel)."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import nms, nms_cuda

    b, n = alive.shape
    err = 0.0
    for eps in (0.2, 0.3):
        got = nms_cuda.group_rectangles_cuda(rects, alive, 1, eps)
        ref = nms.group_rectangles_device_plain(rects, alive, 1, eps)
        torch.cuda.synchronize()
        for name, g, r in zip(("avg", "counts", "keep", "labels"), got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype, (name, g.shape, r.shape)
            n_bad = int((g != r).sum())
            assert n_bad == 0, ("K3", label, n, eps, name, n_bad)
            err = max(err, float((g.double() - r.double()).abs().max()))
        print("K3 {} N={} eps {}: {} survivors, {} clusters kept of {} with count > 1 "
              "(frames {}); avg, counts, keep, labels equal".format(
                  label, n, eps, int(alive.sum()), int(got[2].sum()),
                  int(((got[3] == torch.arange(n, device=rects.device)) & alive
                       & (got[1] > 1)).sum()), b))
        del got, ref
    counts = "launches and synchronisations per call not counted here (phase 11)"
    if call_counts:
        kernels, syncs = _k3_call_counts(torch, rects, alive)
        assert len(kernels) <= 4 and syncs <= 1, (kernels, syncs)
        counts = ("{} kernel launches per call, device us {} (sum {:.1f}), and {} host "
                  "synchronisation(s) per call".format(
                      len(kernels), [(name, round(us, 1)) for name, us in kernels],
                      sum(us for _, us in kernels), syncs))
    ms = _median_ms(lambda: nms_cuda.group_rectangles_cuda(rects, alive, 1, 0.2), torch)
    pms = _median_ms(lambda: nms.group_rectangles_device_plain(rects, alive, 1, 0.2), torch,
                     warmup=1, iters=3, reps=1)
    ops_ms = b * n * (n - 1) / 2 * K3_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    bytes_ms = b * n * K3_BYTES_PER_ROW / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    print("K3 {} {} frames x N={}: kernel {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms ({}; "
          "bytes {:.6f} ms; {:.1%} of it); {}; workspace {} B".format(
              label, b, n, ms, pms, bound_ms, bound_by, bytes_ms, bound_ms / ms, counts,
              nms_cuda.workspace_bytes(b, n)))
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_k3(torch, detector, model, frames, dense):
    """11. K3 against its plain version at the VGA tail's shapes, N = 4096
    (open capacities) and N = 256 (default capacities), and at the dense
    path's last stage (4 frames of 450x450 at the default capacities, N =
    4,224); then the workspace at the dense open rung."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda

    out = {}
    for caps in (OPEN_CAPS, [CAPS_BY_SIZE[24], CAPS_BY_SIZE[48]]):
        out[caps[-1]] = _k3_case(torch, *_k3_inputs(torch, detector, frames, caps), "VGA")
    cf.set("window_scale_factor", DENSE_WSF)
    dense_caps = cascade.default_capacity_schedule(DENSE_WINDOWS, model.n_nets)
    assert list(dense_caps) == list(DENSE_CAPS_BY_SIZE.values()), dense_caps
    rects, alive = _k3_inputs(torch, cascade.CascadeDetector(model), dense, dense_caps,
                              yuv=False)
    cf.set("window_scale_factor", 1.1)
    out[dense_caps[-1]] = _k3_case(torch, rects, alive, "dense")
    del rects, alive
    # the adjacency bitmask K3 kept before (one uint32 word per 32 columns)
    # beside the two label buffers, counts, sums and status
    n = DENSE_WINDOWS
    old_bytes = DENSE_FRAMES * n * ((n + 31) // 32) * 4 + DENSE_FRAMES * n * 44 + 4
    print("K3 workspace at the dense open rung ({} frames x N={}): {} B (before: {} B with the "
          "adjacency bitmask)".format(DENSE_FRAMES, n, nms_cuda.workspace_bytes(DENSE_FRAMES, n),
                                      old_bytes))
    return out


def _sorted_rows(a):
    return sorted(map(tuple, a.tolist()))


def phase_vga_tail(torch, detector, frames, host_results, kind, card):
    """12. The VGA path with the device NMS tail at the default capacities,
    against the host-NMS run of phase 4. Returns K3's launches."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    windows_cuda, _, _, nms_cuda = _kernel_modules()
    cf.set("nms_on_device", True)
    _quietly(detector.detect_batch_yuv420, frames)  # warm-up
    detector.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    results = _quietly(detector.detect_batch_yuv420, frames)
    first_s = time.perf_counter() - t0
    k3, k1, reruns = nms_cuda.LAUNCHES, windows_cuda.LAUNCHES, detector.redispatches
    assert k3 == 1 + reruns, (k3, reruns)
    for r, h in zip(results, host_results):
        assert r.raw_window_ids.tolist() == h.raw_window_ids.tolist()
        assert _sorted_rows(r.boxes) == _sorted_rows(h.boxes), (len(r.boxes), len(h.boxes))
        assert sorted(r.confidences.tolist()) == sorted(h.confidences.tolist())
    walls = {True: [], False: []}
    for on in (False, True, True, False):  # in turns: host, tail, tail, host
        cf.set("nms_on_device", on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(detector.detect_batch_yuv420, frames)
        walls[on].append(time.perf_counter() - t0)
    cf.set("nms_on_device", False)
    print("VGA tail: K3 launches {} (1 batch + {} re-runs), K1 launches {}; raw survivors, "
          "boxes and confidences equal to host NMS on all {} frames; detections per frame {}".format(
              k3, reruns, k1, len(results), [len(r.boxes) for r in results]))
    print("VGA tail: 16-frame batch with the device tail {} s (first timed {:.4f} s), with host "
          "NMS {} s (native.available() {}), on {} [{}]".format(
              [round(x, 4) for x in walls[True]], first_s, [round(x, 4) for x in walls[False]],
              _native(), kind, card))
    return k3


def phase_bundle(torch, model, frames, kind, card):
    """13. A VGA YUV serving bundle with the device tail: export, save,
    load, serve; equal to the live detector at the same capacities, both
    truncating a saturated frame (the live detector with re-dispatch off,
    the bundle at its top rung). Then, for information, one saturated
    frame's re-run alone (as the live detector re-dispatches it) against
    the same frame in a padded 16-frame batch (as a bundle's rung ladder
    re-runs it)."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, _, _, nms_cuda = _kernel_modules()
    caps = OPEN_CAPS
    cf.set("nms_on_device", True)
    # re-dispatch off for both: the live detector keeps truncated results,
    # and both resolve the compaction it implies ("rank")
    cf.set("cascade_saturation_redispatch", False)
    live_det = cascade.CascadeDetector(model, capacity_schedule=caps)
    live = _quietly(live_det.detect_batch_yuv420, frames)
    t0 = time.perf_counter()
    bundle = serve.export_detector(model, IMG_H, IMG_W, batch=N_FRAMES, yuv=True,
                                   capacities=caps, n_rungs=1)
    export_s = time.perf_counter() - t0
    cf.set("cascade_saturation_redispatch", True)
    cf.set("nms_on_device", False)  # the served program must not read it
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        serve.save_bundle(bundle, d)
        save_s = time.perf_counter() - t0
        size_mb = sum(f.stat().st_size for f in __import__("pathlib").Path(d).iterdir()) / 1e6
        t0 = time.perf_counter()
        served_det = serve.load_bundle(d)
        load_s = time.perf_counter() - t0
    targets = [str(n.target) for n in served_det.programs[0].graph.nodes if n.op == "call_function"]
    n_resample, n_cluster = targets.count("rodc.resample.default"), targets.count(
        "rodc.cluster.default")
    assert n_resample == 2 and n_cluster == 1, (n_resample, n_cluster)
    _quietly(served_det.detect_batch, frames)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    served = _quietly(served_det.detect_batch, frames)
    served_s = time.perf_counter() - t0
    k1, k3 = windows_cuda.LAUNCHES, nms_cuda.LAUNCHES
    assert k1 == 2 and k3 == 1, (k1, k3)
    saturated = [i for i, r in enumerate(live)
                 if cascade.CascadeDetector._is_saturated(r.n_survivors_per_stage, caps)]
    bad = [
        (i, len(set(a.raw_window_ids.tolist()) ^ set(b.raw_window_ids.tolist())),
         len(a.boxes), len(b.boxes))
        for i, (a, b) in enumerate(zip(live, served))
        if not (a.raw_window_ids.tolist() == b.raw_window_ids.tolist()
                and a.raw_confidences.tolist() == b.raw_confidences.tolist()
                and a.boxes.tolist() == b.boxes.tolist()
                and a.confidences.tolist() == b.confidences.tolist()
                and a.n_survivors_per_stage == b.n_survivors_per_stage)
    ]
    assert not bad, ("bundle vs live: (frame, raw id flips, boxes live, boxes served)", bad)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(served_det.detect_batch, frames)
        walls.append(time.perf_counter() - t0)
    print("bundle: graph holds {} rodc.resample and {} rodc.cluster nodes; {:.1f} MB on disk; "
          "served results equal to the live detector on all {} frames (frames {} truncated "
          "at the top rung by both); K1 {} K3 {} launches".format(
              n_resample, n_cluster, size_mb, len(served), saturated, k1, k3))
    if saturated:
        # the live detector re-runs a saturated frame alone, a bundle's
        # ladder in a padded batch: other GEMM shapes, other bf16 roundings
        i = saturated[0]
        wider = cascade.escalate_capacities(caps, VGA_WINDOWS)
        entry = live_det._plan_and_table(IMG_H, IMG_W)
        alone = live_det._run_chunk([frames[i]], True, wider, entry, None)[0]
        padded = live_det._run_chunk([frames[i]] * N_FRAMES, True, wider, entry, None)[0]
        c = wider[-1]
        ids_a = set(alone[:c][alone[2 * c : 3 * c] > 0.5].long().tolist())
        ids_p = set(padded[:c][padded[2 * c : 3 * c] > 0.5].long().tolist())
        print("bundle: frame {} at {} alone vs in a padded batch of {}: {} survivor flips of {}, "
              "max |conf diff| {:.3g}".format(
                  i, wider, N_FRAMES, len(ids_a ^ ids_p), len(ids_a),
                  float((alone[c : 2 * c] - padded[c : 2 * c]).abs().max())))
    print("bundle: export {:.4f} s, save {:.4f} s, load {:.4f} s, served 16-frame batch {:.4f} s "
          "(counted) then {} s, on {} [{}]".format(export_s, save_s, load_s, served_s,
                                                   [round(x, 4) for x in walls], kind, card))


def _load_tool(name):
    """A script of ``tools/`` as a module (the directory is no package)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _k2p_hold(torch, k2p_mod, ctx):
    """K2p on one geometry of the profiling tool (``ctx`` of its
    ``setup``) against its plain version and against K2, bit for bit.
    Returns (planes, tiles, sy, sx, n_values, max |diff|)."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        windows,
        windows_sched,
        windows_sched_cuda,
    )

    sched, taps, device = ctx["sched"], ctx["taps"], ctx["frames"].device
    _, tiles, _ = sched.device_tables(device)
    planes = windows.to_planes_bf16(ctx["frames"])
    sy, sx, _ = windows_sched.scheduled_positions(ctx["boxes"], sched, device)
    got = k2p_mod.resample_sched_precomp_cuda(planes, taps, tiles, sched)
    ref = windows_sched.resample_sched_precomp_plain(planes, taps, tiles, sched)
    k2 = windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == k2.shape, (got.shape, ref.shape, k2.shape)
    n_bad = int((got != ref).sum())
    n_bad_k2 = int((got != k2).sum())
    assert n_bad == 0 and n_bad_k2 == 0, ("K2p", ctx["which"], n_bad, n_bad_k2)
    err = float((got.float() - ref.float()).abs().max())
    print("K2p {}: {} frames, {} tiles in {} classes, {:.1f} MB of taps; vs plain {} and vs K2 "
          "{} of {} values differ".format(ctx["which"], planes.shape[0], sched.n_tiles,
                                          len(sched.classes), ctx["tap_bytes"] / 1e6, n_bad,
                                          n_bad_k2, got.numel()))
    return planes, tiles, sy, sx, got.numel(), err


def phase_k2p(torch, device, grid_sample_ms):
    """14. K2p on its path (the profiling tool at FDDB density), then
    against its plain version and against K2 at FDDB density and at the
    VGA geometry, with its two-tap violation count. ``grid_sample_ms`` is
    phase 7's yardstick on the same windows of the same frames. Returns
    K2p's launches on the path and its kernel-line numbers."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import (
        windows_sched,
        windows_sched_cuda,
        windows_sched_precomp_cuda as k2p_mod,
    )

    tool = _load_tool("profile_torch_sched_precomp")
    _reset_launches()
    k2p_mod.VIOLATIONS.clear()
    result = tool.profile("fddb", DENSE_FRAMES, device)
    launches = k2p_mod.LAUNCHES
    assert launches == result["calls"], (
        "K2p was launched {} times in {} calls on its path".format(launches, result["calls"]))
    assert result["mismatches"] == 0 and result["violations"] == 0, result
    ctx = result["ctx"]
    sched, taps = ctx["sched"], ctx["taps"]
    assert ctx["plan"].n_windows == DENSE_WINDOWS
    planes, tiles, sy, sx, n_values, err = _k2p_hold(torch, k2p_mod, ctx)
    vga = tool.setup("vga", device, DENSE_FRAMES)
    vga_planes, vga_tiles = _k2p_hold(torch, k2p_mod, vga)[:2]

    def kernel():
        return k2p_mod.resample_sched_precomp_cuda(planes, taps, tiles, sched)

    def plain():
        return windows_sched.resample_sched_precomp_plain(planes, taps, tiles, sched)

    ms = _median_ms(kernel, torch)
    k2_ms = _median_ms(
        lambda: windows_sched_cuda.resample_sched_cuda(planes, sy, sx, tiles, sched.tile), torch
    )
    vga_ms = _median_ms(lambda: k2p_mod.resample_sched_precomp_cuda(
        vga_planes, vga["taps"], vga_tiles, vga["sched"]), torch)
    pms = _median_ms(plain, torch, warmup=1, iters=3, reps=1)
    violations = k2p_mod.violation_count()
    assert violations == 0, ("K2p two-tap violations", violations)
    tap_values = sum(m.numel() for pair in taps for m in pair)
    n_bytes = (ctx["tap_bytes"] + planes.numel() * planes.element_size()
               + tiles.numel() * tiles.element_size() + n_values * 2)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    # per output value K1's arithmetic; per tap value one comparison
    ops_ms = (n_values * OPS_PER_VALUE + tap_values) / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    smem, _, stage = k2p_mod.launch_geometry(sched.tile, 12, 12, planes.shape[1])
    print("K2p {} frames {}x{} wsf {}: tap matrices {:.1f} MB built in {:.3f} s; {} launches "
          "in {} calls on the tool's path; kernel {:.4f} ms ({:.1f} MB/s of taps), bound "
          "{:.4f} ms ({}; bytes {:.1f} MB; {:.1%} reached), grid_sample {:.4f} ms, K2 {:.4f} "
          "ms, plain {:.4f} ms; VGA ({:.1f} MB of taps) {:.4f} ms; {} B shared a block, ring "
          "{} x {} B; {} two-tap violations".format(
              DENSE_FRAMES, DENSE_HW[0], DENSE_HW[1], DENSE_WSF, ctx["tap_bytes"] / 1e6,
              ctx["build_s"], launches, result["calls"], ms, ctx["tap_bytes"] / ms / 1e3,
              bound_ms, bound_by, n_bytes / 1e6, bound_ms / ms, grid_sample_ms, k2_ms, pms,
              vga["tap_bytes"] / 1e6, vga_ms, smem, k2p_mod.STAGES, stage, violations))
    return launches, {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": grid_sample_ms}


def _report_stages(torch, device, trainer, min_steps, must_fall=None):
    """Per stage of a trained ``CascadeTrainer``: steps, loss first and
    last (which must stay finite, and fall for the stages in
    ``must_fall``, default all), s/step over 10 synchronised updates,
    validation results and re-weighting error."""
    import math

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step

    for i, st in enumerate(trainer.stage_trainers):
        losses = st.losses()
        assert len(losses) >= min_steps, (i, len(losses))
        assert all(math.isfinite(x) for x in losses), ("NaN loss", i)
        # s/step: ten more updates of this stage's trainer on one batch,
        # synchronized (the cascade already holds copies of the weights).
        # The split's bottlenecks now hold the next stage's input, so the
        # timed batch gets zeros of this stage's bottleneck width.
        batch = st.ds.train.new_default_iterator(cf.get("batch_size"), seed=0).next_batch
        images = torch.as_tensor(batch.images, device=device)
        labels = torch.as_tensor(batch.labels, device=device).long()
        width = st.stage_config.bottleneck_in_size
        bneck = None if width is None else torch.zeros((len(labels), width), device=device)

        def step():
            return train_step.train_step(
                st.state, st.stage_config, st._loss_settings, st._augment, images, labels,
                bneck, st._mean, st._std, st._host_gen, st._device_gen)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / 10
        val = st.best_val_results or {}
        err = trainer.reweight_errors[i] if i < len(trainer.reweight_errors) else None
        print("training stage {} ({} px, f_beta {}): {} steps, loss first {:.6f} last {:.6f} "
              "(min {:.6f}), {:.6f} s/step, validation accuracy {:.4f} recall {:.4f} precision "
              "{:.4f} {} {:.4f}, re-weighting error {}".format(
                  i, st.stage_config.input_size, st.f_beta, len(losses), losses[0], losses[-1],
                  float(losses.min()), s_step, val.get("accuracy", float("nan")),
                  val.get("recall", float("nan")), val.get("precision", float("nan")),
                  st.main_criteria, val.get(st.main_criteria, float("nan")), err))
        if must_fall is None or i in must_fall:
            assert losses[-1] < losses[0], ("loss did not fall", i, losses[0], losses[-1])


# a third positives, as in a face corpus with more backgrounds than faces
# (with more positives than negatives the trainer drops the F-beta loss);
# 9,600 training samples are 8 steps of 1200 per epoch
TRAIN_POS, TRAIN_NEG = 4000, 8000
TRAIN_EPOCHS = 7  # cut from the default 50: 56 steps per stage


def phase_training(torch, device, kind, card):
    """15. The boosted cascade trained on the card at full width. Returns
    the trained model."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import (
        ConstantPredictionException,
    )
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    for key, want in (("cascade_n_nets", 3), ("img_width", 48), ("conv_filter_sizes", [32]),
                      ("fc1_size", 512), ("compute_dtype", "bfloat16"), ("batch_size", 1200),
                      ("optimizer", cf.OPTIMIZER_MOMENTUM), ("dropout_rate", 0.5),
                      ("data_augmentation_online", True),
                      ("cascade_resampling_method", cf.RESAMPLING_ADABOOST_LIKE),
                      ("reuse_bottlenecks", True)):
        assert cf.get(key) == want, (key, cf.get(key), want)
    default_epochs = cf.get("epochs_total")
    cf.set("epochs_total", TRAIN_EPOCHS)
    print("training: epochs_total cut from {} to {}; everything else at its default".format(
        default_epochs, TRAIN_EPOCHS))
    t0 = time.perf_counter()
    provider = ct.SyntheticProvider(TRAIN_POS, TRAIN_NEG, [12, 24, 48], seed=0)
    data_s = time.perf_counter() - t0
    trainer = ct.CascadeTrainer(provider, seed=0, device=device)
    log.set_echo(False)
    try:
        t0 = time.perf_counter()
        model = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    except ConstantPredictionException as exc:
        raise AssertionError("training raised ConstantPredictionException: {}".format(exc))
    finally:
        log.set_echo(True)
    print("training: corpus of {} samples made in {:.2f} s; 3 stages trained in {:.2f} s "
          "(evaluations and snapshots included) on {} [{}]".format(
              TRAIN_POS + TRAIN_NEG, data_s, train_s, kind, card))
    _report_stages(torch, device, trainer, min_steps=50)
    print("training: combined cascade on the test split {}".format(
        {k: round(v, 4) for k, v in trainer.combined_results["test"].items()}))
    cf.set("epochs_total", default_epochs)
    return model


def phase_trained_detection(torch, device, model, frames, kind, card):
    """16. The trained cascade detecting the VGA batch, in memory and
    reloaded from its checkpoint. Returns K1's launches."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge, cascade
    from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint

    windows_cuda = _kernel_modules()[0]
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_cascade(d, "smoke", model)
        reloaded = bridge.load_cascade(d, "smoke", device=device)
    live = cascade.CascadeDetector(model)
    _quietly(live.detect_batch_yuv420, frames)  # warm-up
    live.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    results = _quietly(live.detect_batch_yuv420, frames)
    wall = time.perf_counter() - t0
    k1, redispatches = windows_cuda.LAUNCHES, live.redispatches
    assert k1 >= 2, k1
    again = _quietly(cascade.CascadeDetector(reloaded).detect_batch_yuv420, frames)
    for a, b in zip(results, again):
        assert a.raw_window_ids.tolist() == b.raw_window_ids.tolist()
        assert a.raw_confidences.tolist() == b.raw_confidences.tolist()
        assert _sorted_rows(a.boxes) == _sorted_rows(b.boxes)
        assert a.n_survivors_per_stage == b.n_survivors_per_stage
    for r in results:
        s = r.n_survivors_per_stage
        assert r.n_windows == VGA_WINDOWS and len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(live.detect_batch_yuv420, frames)
        walls.append(time.perf_counter() - t0)
    print("trained cascade: survivors per stage per frame {}".format(
        [r.n_survivors_per_stage for r in results]))
    print("trained cascade: detections per frame {}; re-dispatches {}, K1 launches {}; in-memory "
          "and reloaded results equal on all {} frames; 16-frame batch {:.4f} s (counted) then "
          "{} s on {} [{}]".format([len(r.boxes) for r in results], redispatches, k1,
                                   len(results), wall, [round(x, 4) for x in walls], kind, card))
    return k1


def phase_train_card_vs_cpu(torch, device):
    """17. A tiny f32 cascade trained on the card and on the CPU."""
    import numpy as np

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    saved = cf.snapshot()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for key, value in (("conv_filter_sizes", [8]), ("fc1_size", 32), ("batch_size", 64),
                       ("max_batch_size", 256), ("epochs_total", 2),
                       ("compute_dtype", "float32"), ("data_augmentation_online", False),
                       ("dropout_rate", 1.0)):
        cf.set(key, value)
    provider = ct.SyntheticProvider(150, 150, [12, 24, 48], seed=1)
    log.set_echo(False)
    try:
        runs = {}
        for dev in ("cpu", device):
            trainer = ct.CascadeTrainer(provider, seed=0, device=dev)
            model = trainer.train()
            runs[str(dev)] = (trainer, model)
    finally:
        log.set_echo(True)
        cf.restore(saved)
    (t_cpu, m_cpu), (t_gpu, m_gpu) = runs["cpu"], runs[str(device)]
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    loss_err, param_err = 0.0, 0.0
    for a, b in zip(t_cpu.stage_trainers, t_gpu.stage_trainers):
        la, lb = a.losses(), b.losses()
        assert la.shape == lb.shape, (la.shape, lb.shape)
        np.testing.assert_allclose(lb, la, rtol=1e-4)
        loss_err = max(loss_err, float(np.max(np.abs(lb - la) / np.abs(la))))
    for pa, pb in zip(m_cpu.stage_params, m_gpu.stage_params):
        for name in ("fc1", "fc2"):
            for k in ("W", "b"):
                x, y = pa[name][k].numpy(), pb[name][k].cpu().numpy()
                np.testing.assert_allclose(y, x, rtol=1e-3, atol=1e-4)
                param_err = max(param_err, float(np.max(np.abs(y - x))))
        for la, lb in zip(pa["conv"], pb["conv"]):
            for k in ("W", "b"):
                x, y = la[k].numpy(), lb[k].cpu().numpy()
                np.testing.assert_allclose(y, x, rtol=1e-3, atol=1e-4)
                param_err = max(param_err, float(np.max(np.abs(y - x))))
    print("training card vs cpu (f32, TF32 off, 3 stages x {} steps): max relative loss diff "
          "{:.3g}, max |param diff| {:.3g}".format(
              [len(t.losses()) for t in t_gpu.stage_trainers], loss_err, param_err))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# the recipe of tools/train_torch_flagship.py, cut in corpus size and epochs
# only (the JAX sweep's 2,000/6,000 at 12 epochs kept 30% of the VGA
# windows after stage 0)
FLAG_POS, FLAG_NEG = 2000, 6000
FLAG_EPOCHS = 12
FLAG_SCENES = 100  # benchmark scenes for the survivor maxima, as the tool
FLAG_THRESHOLD, FLAG_MIN_NEIGHBORS = 0.3, 0  # the JAX flagship's operating point
FLAG_CPU_FRAMES = 4  # bf16 card vs CPU: the frames the CPU detects


@contextlib.contextmanager
def _host_nms_timer():
    """Host NMS seconds and decoded rows: every packed row goes through
    ``serve.postprocess_raw``. Yields {"s": seconds, "rows": calls}."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    real = serve.postprocess_raw
    acc = {"s": 0.0, "rows": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["rows"] += 1

    serve.postprocess_raw = timed
    try:
        yield acc
    finally:
        serve.postprocess_raw = real


def _flagship_train(torch, device, tool, kind, card):
    """18a. The flagship recipe trained on the card; returns the model."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import (
        ConstantPredictionException,
    )
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    tool.flagship_config(cf)
    recipe = _quietly(tool.apply_recorded_overrides, cf)
    for key, want in (("cascade_n_nets", 3), ("img_width", 48), ("conv_filter_sizes", [32, 32]),
                      ("fc1_size", 512), ("compute_dtype", "bfloat16"), ("max_beta", 2),
                      ("min_beta", 1), ("batch_size", 512), ("data_augmentation_online", True),
                      ("dao_crop_probability", 1.0), ("reuse_bottlenecks", True)):
        assert cf.get(key) == want, (key, cf.get(key), want)
    assert recipe["hard_negatives"] == recipe["hard_positives"] == 4, recipe
    print("flagship: corpus cut from {}/{} to {}/{} faces/backgrounds; epochs_total cut from "
          "{} to {}; architecture and recipe as recorded (conv {}, fc1 {}, max_beta {}, "
          "min_beta {}, batch {}, positional augmentation, mixed corpus, hard examples "
          "x{})".format(recipe["n_pos"], recipe["n_neg"], FLAG_POS, FLAG_NEG,
                        cf.get("epochs_total"), FLAG_EPOCHS, cf.get("conv_filter_sizes"),
                        cf.get("fc1_size"), cf.get("max_beta"), cf.get("min_beta"),
                        cf.get("batch_size"), recipe["hard_negatives"]))
    cf.set("epochs_total", FLAG_EPOCHS)
    t0 = time.perf_counter()
    provider = _quietly(tool.flagship_provider, FLAG_POS, FLAG_NEG, recipe["seed"], recipe)
    corpus_s = time.perf_counter() - t0
    labels = provider._labels
    trainer = ct.CascadeTrainer(provider, seed=recipe["seed"], device=device)
    log.set_echo(False)
    try:
        t0 = time.perf_counter()
        model = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    except ConstantPredictionException as exc:
        raise AssertionError("training raised ConstantPredictionException: {}".format(exc))
    finally:
        log.set_echo(True)
    print("flagship: corpus of {} samples ({} faces; {} mined windows appended) built in "
          "{:.2f} s on the host; 3 stages trained in {:.2f} s (evaluations and snapshots "
          "included) on {} [{}]".format(len(labels), int(labels.sum()),
                                       len(labels) - FLAG_POS - FLAG_NEG, corpus_s, train_s,
                                       kind, card))
    _report_stages(torch, device, trainer, min_steps=100)
    print("flagship: combined cascade on the test split {}".format(
        {k: round(v, 4) for k, v in trainer.combined_results["test"].items()}))
    return model


def _flagship_vga(torch, model, caps, frames, kind, card):
    """18c. The 16-frame VGA YUV420 batch at the flagship's capacities:
    returns (detector, results, K1 launches)."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    det = cascade.CascadeDetector(model, capacity_schedule=caps)
    _quietly(det.detect_batch_yuv420, frames)  # warm-up
    det.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    with _host_nms_timer() as nms:
        t0 = time.perf_counter()
        results = _quietly(det.detect_batch_yuv420, frames)
        counted_s = time.perf_counter() - t0
    k1, redispatches = windows_cuda.LAUNCHES, det.redispatches
    assert k1 >= 2, k1
    assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
    for r in results:
        s = r.n_survivors_per_stage
        assert r.n_windows == VGA_WINDOWS and len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
        assert r.boxes.ndim == 2 and r.boxes.shape[1] == 4 and bool((r.boxes == r.boxes).all())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(det.detect_batch_yuv420, frames)
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    print("flagship VGA: survivors per stage per frame {}".format(
        [r.n_survivors_per_stage for r in results]))
    print("flagship VGA at capacities {} (bf16, threshold {}, min_neighbors {}): 16-frame batch "
          "{:.4f} s median of {} (counted {:.4f} s) = {:.2f} frames/s; re-dispatches {}, K1 "
          "launches {}; host NMS {:.4f} s over {} decoded rows in the counted batch, "
          "native.available() {}; detections per frame {}; on {} [{}]".format(
              caps, FLAG_THRESHOLD, FLAG_MIN_NEIGHBORS, med, [round(x, 4) for x in walls],
              counted_s, N_FRAMES / med, redispatches, k1, nms["s"], nms["rows"], _native(),
              [len(r.boxes) for r in results], kind, card))
    return det, results, k1


def _flagship_bf16_parity(torch, model, caps, frames):
    """18d. bf16 card against CPU: the same model, capacities and settings;
    flips at most 2% of the survivors, with cuBLAS's reduced-precision bf16
    reduction as ``set_numerics`` leaves it (both settings printed)."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    t0 = time.perf_counter()
    cpu_det = cascade.CascadeDetector(model.to("cpu"), capacity_schedule=caps)
    res_cpu = _quietly(cpu_det.detect_batch_yuv420, frames[:FLAG_CPU_FRAMES])
    cpu_s = time.perf_counter() - t0
    det = cascade.CascadeDetector(model, capacity_schedule=caps)
    as_set = matmul.allow_bf16_reduced_precision_reduction  # what set_numerics leaves
    counts = {}
    for value in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = value
        res = _quietly(det.detect_batch_yuv420, frames)
        pairs = [_flips(a, b) for a, b in zip(res_cpu, res)]
        per_frame = [len(f[0]) for f in pairs]
        survivors = sum(len(f[2] | f[3]) for f in pairs)
        conf_err = 0.0
        for a, b in zip(res_cpu, res):
            ca = dict(zip(a.raw_window_ids.tolist(), a.raw_confidences.tolist()))
            cb = dict(zip(b.raw_window_ids.tolist(), b.raw_confidences.tolist()))
            conf_err = max([conf_err] + [abs(ca[i] - cb[i]) for i in set(ca) & set(cb)])
        counts[value] = (sum(per_frame), survivors)
        print("flagship bf16 card vs cpu (allow_bf16_reduced_precision_reduction {}{}): flips "
              "per frame {} = {} of {} survivors (allowed {:.1f}), max |conf diff| on common "
              "{:.3g}; survivors per stage cpu {} gpu {}".format(
                  value, ", as set_numerics leaves it" if value == as_set else "", per_frame,
                  sum(per_frame), survivors, BORDERLINE_FRACTION * survivors, conf_err,
                  [r.n_survivors_per_stage for r in res_cpu],
                  [r.n_survivors_per_stage for r in res[:FLAG_CPU_FRAMES]]))
    matmul.allow_bf16_reduced_precision_reduction = saved
    print("flagship bf16 card vs cpu: the cpu detected {} of the {} frames (bf16 on the host is "
          "slow) in {:.2f} s".format(FLAG_CPU_FRAMES, N_FRAMES, cpu_s))
    flips, survivors = counts[as_set]
    assert flips <= BORDERLINE_FRACTION * max(survivors, 1), counts


def _flagship_tail(torch, model, caps, frames, host_results):
    """18e. The VGA batch with the device NMS tail (K3 at the flagship's
    last capacity): boxes equal to host NMS on every frame. Returns K3's
    launches."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    nms_cuda = _kernel_modules()[3]
    cf.set("nms_on_device", True)
    det = cascade.CascadeDetector(model, capacity_schedule=caps)
    _quietly(det.detect_batch_yuv420, frames)  # warm-up
    det.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    results = _quietly(det.detect_batch_yuv420, frames)
    k3, reruns = nms_cuda.LAUNCHES, det.redispatches
    cf.set("nms_on_device", False)
    assert k3 == 1 + reruns, (k3, reruns)
    for r, h in zip(results, host_results):
        assert r.raw_window_ids.tolist() == h.raw_window_ids.tolist()
        assert _sorted_rows(r.boxes) == _sorted_rows(h.boxes), (len(r.boxes), len(h.boxes))
        assert sorted(r.confidences.tolist()) == sorted(h.confidences.tolist())
    print("flagship VGA tail: K3 launches {} (1 batch + {} re-runs) at N = {}; raw survivors, "
          "boxes and confidences equal to host NMS on all {} frames".format(
              k3, reruns, caps[-1], len(results)))
    return k3


def _flagship_dense(torch, model, dense, kind, card):
    """18f. The dense 4-frame 450x450 batch at scale factor 1.005 with the
    flagship, at the default capacities, then with ``dyn_reextract="on"``.
    Returns the launches (K1, K2) of the first and K4's of the second."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    cf.set("window_scale_factor", DENSE_WSF)
    det = cascade.CascadeDetector(model)
    runs = {}
    for dyn, label in (("auto", "flagship, default caps"),
                       ("on", "flagship, default caps, dyn_reextract on")):
        cf.set("dyn_reextract", dyn)
        with _host_nms_timer() as nms:
            runs[dyn] = _dense_detect(torch, det, dense, label, kind, card)
        print("dense path ({}): host NMS {:.4f} s per batch over {:.1f} decoded rows per "
              "batch".format(label, nms["s"] / 3, nms["rows"] / 3))
    cf.set("dyn_reextract", "auto")
    cf.set("window_scale_factor", 1.1)
    (base, (k1, k2, k4)), (dyn, (dk1, dk2, dk4)) = runs["auto"], runs["on"]
    assert k2 >= 1 and k1 >= 2 and k4 == 0, (k1, k2, k4)
    assert dk2 >= 1 and dk4 >= 1, (dk1, dk2, dk4)
    flips = [_flips(a, b) for a, b in zip(base, dyn)]
    print("flagship dense: K4 vs K1 re-extraction survivor flips per frame {}".format(
        [len(f[0]) for f in flips]))
    assert all(len(f[0]) <= f[1] for f in flips), [(len(f[0]), f[1]) for f in flips]
    return k1, k2, dk4


def phase_flagship(torch, device, frames, dense, kind, card):
    """18. The flagship recipe trained on the card and driven through the
    detection paths of K1-K4. Returns the launch counts and the kernel
    measurements at the flagship's shapes."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    tool = _load_tool("train_torch_flagship")
    saved = cf.snapshot()
    try:
        model = _flagship_train(torch, device, tool, kind, card)
        # 18b. survivor maxima and quality on the benchmark scenes
        t0 = time.perf_counter()
        quality = _quietly(tool.evaluate_on_scenes, model, FLAG_SCENES, 100, FLAG_THRESHOLD,
                           True, FLAG_MIN_NEIGHBORS)
        caps = tool.capacity_schedule_from_quality(quality)
        print("flagship quality on {} benchmark scenes at threshold {} min_neighbors {}: recall "
              "{}, {} false positives a scene, survivors mean {} max {} of {} windows -> "
              "capacities {}; misses {} (grid-limited {}, stage-0-blind {}); {:.2f} s".format(
                  FLAG_SCENES, FLAG_THRESHOLD, FLAG_MIN_NEIGHBORS, quality["recall"],
                  quality["false_pos_per_scene"], quality["survivors_mean"],
                  quality["survivors_max"], quality["n_windows"], caps, len(quality["misses"]),
                  quality["misses_grid_limited"], quality["misses_stage0_blind"],
                  time.perf_counter() - t0))
        assert quality["n_windows"] == VGA_WINDOWS
        assert quality["survivors_mean"][0] < VGA_WINDOWS / 2, (
            "stage 0 does not discriminate", quality["survivors_mean"])
        det, host_results, k1_launches = _flagship_vga(torch, model, caps, frames, kind, card)
        k1 = phase_k1(torch, "flagship VGA", *vga_k1_inputs(torch, device, det, frames),
                      {24: caps[0], 48: caps[1]})
        _flagship_bf16_parity(torch, model, caps, frames)
        k3_launches = _flagship_tail(torch, model, caps, frames, host_results)
        k3 = _k3_case(torch, *_k3_inputs(torch, det, frames, caps), "flagship VGA",
                      call_counts=False)
        del det
        torch.cuda.empty_cache()
        k1_dense, k2_dense, k4_dense = _flagship_dense(torch, model, dense, kind, card)
    finally:
        cf.restore(saved)
    return {"k1": (k1_launches, k1), "k3": (k3_launches, k3), "caps": caps,
            "k1_dense": k1_dense, "k2_dense": k2_dense, "k4_dense": k4_dense, "model": model}

FDDB_IMGS_PER_FOLD = 2  # the synthetic 10-fold corpus at its default sizes
FDDB_CPU_FOLDS = 1  # the folds the CPU runs again (2 until phases 26-28 came)
# the CPU's scenes were 4 until phases 26-28 came
RUNTIME_POS, RUNTIME_NEG, RUNTIME_CPU_SCENES = 16, 4, 2


@contextlib.contextmanager
def _host_plan_timer():
    """Host seconds of the pyramid plans (``build_plan`` + ``window_table``,
    on a detector's plan-cache misses) and of the stage-0 schedules
    (``windows_sched.schedule_for_plan``, cached per plan), per image size.
    Yields {"plan": {(h, w): s}, "sched": {(h, w): s}}."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched

    acc = {"plan": {}, "sched": {}}
    real = {"build_plan": cascade.build_plan, "window_table": cascade.window_table,
            "schedule_for_plan": windows_sched.schedule_for_plan}

    def timed(fn, kind, size_of):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                size = size_of(args)
                acc[kind][size] = acc[kind].get(size, 0.0) + time.perf_counter() - t0
        return wrapper

    cascade.build_plan = timed(real["build_plan"], "plan", lambda a: (a[0], a[1]))
    cascade.window_table = timed(real["window_table"], "plan", lambda a: (a[0].img_h, a[0].img_w))
    windows_sched.schedule_for_plan = timed(real["schedule_for_plan"], "sched",
                                            lambda a: (a[0].img_h, a[0].img_w))
    try:
        yield acc
    finally:
        cascade.build_plan = real["build_plan"]
        cascade.window_table = real["window_table"]
        windows_sched.schedule_for_plan = real["schedule_for_plan"]


@contextlib.contextmanager
def _captured_results():
    """Every list of results the inference apps return, in call order."""
    from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps

    real = inference_apps.AbstractInferenceApp.run_inference_on_images
    captured = []

    def capture(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        captured.append(out)
        return out

    inference_apps.AbstractInferenceApp.run_inference_on_images = capture
    try:
        yield captured
    finally:
        inference_apps.AbstractInferenceApp.run_inference_on_images = real


def _fddb_settings(cf, work, img_base, folds_dir, name):
    """The FDDB app's paths under ``work`` and the flagship's operating
    point, host NMS."""
    import os

    out = os.path.join(work, name)
    cf.set("fddb_folds_dir", folds_dir)
    cf.set("fddb_img_base_dir", img_base)
    cf.set("fddb_detection_output_dir", out)
    cf.set("fddb_latest_detection_output_dir", os.path.join(out, "latest"))
    cf.set("fddb_per_evaluation_script_path", os.path.join(work, "missing.pl"))
    cf.set("log_dir", os.path.join(work, "logs"))
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_on_device", False)
    cf.set("foreground_confidence_threshold", FLAG_THRESHOLD)
    cf.set("nms_opencv_min_neighbors", FLAG_MIN_NEIGHBORS)


def _box_set(boxes):
    return {tuple(round(float(v), 3) for v in row) for row in boxes}


def phase_fddb(torch, model, corpus_dir, kind, card):
    """19. The FDDB app on the card with the flagship: the synthetic 10-fold
    corpus (2 images a fold at its default sizes, written to
    ``corpus_dir``, which phase 31 reads again) through
    ``EvaluateFDDBApp`` and its forced settings (scale factor 1.005, one
    image a call, corpus-derived resize buckets); then the app again on the
    CPU over the first 2 folds, fold files compared. Returns the card
    run's launches of K2, of K1's re-extraction and of K1's stage 0 at the
    unscheduled size, each with its measurement at that shape."""
    import numpy as np
    import os
    import shutil

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_fddb import EvaluateFDDBApp
    from rapidobjectdetectionusingcascadedcnns_torch.data import fddb
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    saved = cf.snapshot()
    work = tempfile.mkdtemp(prefix="chip_smoke_fddb_")
    try:
        img_base, folds_dir, _ = fddb.make_synthetic_corpus(
            corpus_dir, n_folds=10, imgs_per_fold=FDDB_IMGS_PER_FOLD, seed=0)
        n_images = 10 * FDDB_IMGS_PER_FOLD
        _fddb_settings(cf, work, img_base, folds_dir, "card")
        torch.cuda.synchronize()
        _reset_launches()
        with _host_nms_timer() as nms, _host_plan_timer() as plans, _captured_results() as got:
            t0 = time.perf_counter()
            app = _quietly(lambda: EvaluateFDDBApp(model=model, n_folds=10, device="cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1, k2 = windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES
        assert windows_dyn_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
        detector = app.inference_app.detector

        # Each dispatch of an image (its first run and each re-dispatch)
        # runs stage 0 through K2 where its size has a schedule, else
        # through K1 over chunks of inference_chunk_size boxes; and K1 once
        # for each later stage's re-extraction.
        infos = [i for fold_nr in range(1, 11) for i in fddb.image_infos_for_fold(fold_nr)]
        sizes = [info.raw_original().shape[:2] for info in infos]
        chunk = int(cf.get("inference_chunk_size"))
        stage0 = model.stage_configs[0].input_size
        unscheduled = {}  # size -> K1's stage-0 launches a dispatch
        for size in set(sizes):
            plan = detector._plan_and_table(*size)[0]
            if cascade._stage0_schedule(plan, stage0, cascade.resolve_resample_impl(),
                                        bool(cf.get("inference_high_precision"))) is None:
                unscheduled[size] = -(-plan.n_windows // chunk)
        n_sched = sum(size not in unscheduled for size in sizes)
        dispatches = n_images + detector.redispatches
        assert n_sched <= k2 <= n_sched + detector.redispatches, (k2, n_sched, dispatches)
        assert len(set(unscheduled.values())) <= 1, unscheduled
        k1_stage0 = (dispatches - k2) * max(unscheduled.values(), default=0)
        assert unscheduled or k2 == dispatches, (k2, dispatches)
        k1_reextract = (len(model.stage_configs) - 1) * dispatches
        assert k1 == k1_stage0 + k1_reextract, (k1, k1_stage0, k1_reextract)
        card_results = [r for batch in got for r in batch]
        assert len(card_results) == n_images and len(app.fold_paths) == 10
        assert cf.get("window_scale_factor") == DENSE_WSF and not cf.get("inference_merge")
        buckets = cf.get("inference_resize_buckets")
        assert sorted(map(tuple, buckets)) == sorted([(240, 320), (200, 280), (320, 240)]), buckets
        assert set(sizes) == set(map(tuple, buckets)), (sorted(set(sizes)), buckets)
        for fold_nr, path in enumerate(app.fold_paths, start=1):
            parsed = fddb.parse_fold_results(path)
            assert [p[0] for p in parsed] == fddb.read_fold(fold_nr)
        for r in card_results:
            s = r.n_survivors_per_stage
            assert r.n_windows > 0 and len(s) == 3 and s[0] >= s[1] >= s[2] >= 0, s
            assert r.boxes.ndim == 2 and bool(np.isfinite(r.boxes).all())
        roc_path = os.path.join(app.export_dir, "fddb_roc.json")
        assert os.path.exists(roc_path), roc_path
        with open(roc_path) as f:
            roc = json.load(f)
        assert roc["roc"] and app.roc is not None, "the FDDB ROC is empty"
        end = roc["roc"][-1]
        print("FDDB app on {} [{}]: {} images of sizes {} in {:.2f} s = {:.4f} s/image "
              "(first use of each size included); re-dispatches {} ({:.2f} an image) at the "
              "default capacities {}; survivors per stage per image {}".format(
                  kind, card, n_images, buckets, wall, wall / n_images, detector.redispatches,
                  detector.redispatches / n_images,
                  {size: cascade.default_capacity_schedule(
                      detector._plan_and_table(*size)[0].n_windows, 3) for size in
                   map(tuple, buckets)},
                  [r.n_survivors_per_stage for r in card_results]))
        print("FDDB app: host plan s per new size {}, K2 schedule s per size {}, host NMS "
              "{:.4f} s over {} decoded rows, native.available() {}; launches K1 {} K2 {} "
              "(one image a call)".format(
                  {k: round(v, 4) for k, v in plans["plan"].items()},
                  {k: round(v, 4) for k, v in plans["sched"].items()}, nms["s"], nms["rows"],
                  _native(), k1, k2))
        print("FDDB app: {} of {} images at a size with a K2 schedule; {} dispatches; K1 "
              "launches {} for stage 0 at the unscheduled sizes {} ({}-box chunks) and {} for "
              "re-extraction".format(n_sched, n_images, dispatches, k1_stage0,
                                     sorted(unscheduled), chunk, k1_reextract))
        print("FDDB app ROC: {} faces, {} detections, {} points; last point: detection rate "
              "{:.4f} discrete / {:.4f} continuous at {} false positives (threshold {}, "
              "min_neighbors {})".format(
                  roc["n_faces"], roc["n_detections"], len(roc["roc"]), end["detection_rate"],
                  end["detection_rate_continuous"], end["false_positives"], FLAG_THRESHOLD,
                  FLAG_MIN_NEIGHBORS))
        print("FDDB app: nvidia-smi {}".format(card))

        # K1 and K2 at this path's shapes: a corpus image of a scheduled
        # size at the default capacities of its pyramid, and K1's stage-0
        # chunk on one of an unscheduled size
        first = next(infos[i] for i, s in enumerate(sizes) if s not in unscheduled)
        first = first.raw_original()
        n_windows = detector._plan_and_table(*first.shape[:2])[0].n_windows
        caps = cascade.default_capacity_schedule(n_windows, 3)
        k2m = phase_k2(torch, torch.device("cuda"), [first])
        k1m = phase_k1(torch, "FDDB app", *dense_k1_inputs(torch, torch.device("cuda"), [first]),
                       {24: caps[0], 48: caps[1]})
        k1s = None
        if unscheduled:
            other = next(infos[i] for i, s in enumerate(sizes) if s in unscheduled)
            other = other.raw_original()
            planes, coords = dense_k1_inputs(torch, torch.device("cuda"), [other])
            k1s = phase_k1(torch, "FDDB app stage 0", planes, coords,
                           {stage0: min(chunk, coords.shape[0])})
            del planes, coords

        # the CPU over the first folds, at capacities from the card's
        # survivor maxima on those images (x1.1): re-dispatch makes the
        # result independent of the capacities, the CPU need not repeat the
        # card's re-runs, and its stage CNNs run on no more rows than needed
        n_cpu = FDDB_CPU_FOLDS * FDDB_IMGS_PER_FOLD
        top = np.max([r.n_survivors_per_stage[:-1] for r in card_results[:n_cpu]], axis=0)
        cpu_caps = [int(-(-int(m * 1.1) // 128) * 128) for m in top]
        cf.set("cascade_capacity_schedule", cpu_caps)
        _fddb_settings(cf, work, img_base, folds_dir, "cpu")
        with _captured_results() as got_cpu:
            t0 = time.perf_counter()
            cpu_app = _quietly(lambda: EvaluateFDDBApp(
                model=model.to("cpu"), n_folds=FDDB_CPU_FOLDS, device="cpu"))
            cpu_s = time.perf_counter() - t0
        cpu_results = [r for batch in got_cpu for r in batch]
        assert len(cpu_results) == n_cpu
        flips, box_diffs, counts = [], [], []
        for fold_nr in range(1, FDDB_CPU_FOLDS + 1):
            card_fold = fddb.parse_fold_results(app.fold_paths[fold_nr - 1])
            cpu_fold = fddb.parse_fold_results(cpu_app.fold_paths[fold_nr - 1])
            assert [p[0] for p in cpu_fold] == [p[0] for p in card_fold]
            for (_, cb, _), (_, gb, _) in zip(cpu_fold, card_fold):
                box_diffs.append(len(_box_set(cb) ^ _box_set(gb)))
                counts.append((len(gb), len(cb)))
        for i, (g, c) in enumerate(zip(card_results[:n_cpu], cpu_results)):
            f, allowed, ids_g, ids_c = _flips(g, c)
            flips.append(len(f))
            assert len(f) <= allowed, (i, len(f), allowed)
            assert abs(counts[i][0] - counts[i][1]) <= len(f), (i, counts[i], len(f))
        print("FDDB app card vs cpu ({} folds, {} images, bf16, cpu capacities {}): last-stage "
              "survivor flips per image {} (allowed {:.0%} of the survivors), fold-file boxes "
              "(card, cpu) {}, fold-file boxes that differ {}; the cpu took {:.2f} s with {} "
              "re-dispatches".format(
                  FDDB_CPU_FOLDS, n_cpu, cpu_caps, flips, BORDERLINE_FRACTION, counts,
                  box_diffs, cpu_s, cpu_app.inference_app.detector.redispatches))
    finally:
        cf.restore(saved)
        shutil.rmtree(work, ignore_errors=True)
    return {"k1": (k1_reextract, k1m), "k1_stage0": (k1_stage0, k1s), "k2": (k2, k2m),
            "unscheduled": sorted(unscheduled), "chunk": chunk}


def phase_runtime(torch, model, kind, card):
    """20. The runtime app: the flagship cascade against a 48 px single net
    (conv [32], fc1 512, fresh weights from seed 0) at the reference's
    inference geometry (VGA, scale factor 1.1, threshold 0.5,
    min_neighbors 1), on the card over 16 positive and 4 negative scenes,
    then on the CPU over 4 of them."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_runtime import (
        EvaluateRuntimeApp,
    )
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.models.single import SingleNetDetector

    windows_cuda, windows_sched_cuda, _, _ = _kernel_modules()
    saved = cf.snapshot()
    try:
        for key, value in (("window_scale_factor", 1.1), ("min_window_length", 0.075),
                           ("foreground_confidence_threshold", 0.5), ("nms", cf.NMS_OPENCV),
                           ("nms_opencv_min_neighbors", 1), ("dataset_keys", ["synthetic"]),
                           ("inference_merge", True), ("log_auto_save", False),
                           ("conv_filter_sizes", [32]), ("fc1_size", 512)):
            cf.set(key, value)
        scfg = cnn.StageConfig.from_config(48, bottleneck_in_size=None)
        single = SingleNetDetector(
            cnn.init_stage(scfg, torch.Generator().manual_seed(0)), scfg,
            np.full((48, 48, 3), 127.5, np.float32), np.full((48, 48, 3), 64.0, np.float32),
            "cuda")
        _reset_launches()
        t0 = time.perf_counter()
        app = _quietly(lambda: EvaluateRuntimeApp(
            n_positive=RUNTIME_POS, n_negative=RUNTIME_NEG, cascade_model=model,
            single_detector=single, device="cuda"))
        card_s = time.perf_counter() - t0
        k1, k2 = windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES
        assert k1 >= 2 and k2 == 0, (k1, k2)
        images = app._images_cache
        assert len(images) == RUNTIME_POS + RUNTIME_NEG
        t0 = time.perf_counter()
        cpu_app = _quietly(lambda: EvaluateRuntimeApp(
            images=images[:RUNTIME_CPU_SCENES], cascade_model=model, single_detector=single,
            device="cpu"))
        cpu_s = time.perf_counter() - t0
    finally:
        cf.restore(saved)
    for label, a, n in (("card", app, len(images)), ("cpu", cpu_app, RUNTIME_CPU_SCENES)):
        r = a.results
        assert r["cascade"]["fps"] > 0 and r["single"]["fps"] > 0
        print("runtime app ({}, {} VGA scenes): cascade {:.2f} fps ({:.4f} s/image), single "
              "48 px net {:.2f} fps ({:.4f} s/image), cascade speedup {:.2f}x".format(
                  label, n, r["cascade"]["fps"], r["cascade"]["avg_seconds_per_image"],
                  r["single"]["fps"], r["single"]["avg_seconds_per_image"],
                  r["speedup_cascade_vs_single"]["value"]))
    print("runtime app: K1 launches {} over the cascade's warm and timed card runs; K2 {} (both "
          "stage 0s run in gather mode at VGA 1.1: the single net launches no hand-written "
          "kernel); card app {:.2f} s, cpu app {:.2f} s in all; on {} [{}]".format(
              k1, k2, card_s, cpu_s, kind, card))


def phase_cli(torch, model):
    """21. The CLI: ``python -m rapidobjectdetectionusingcascadedcnns_torch.run
    inference-cascade`` in a subprocess, on the flagship saved as a
    checkpoint and a small file tree set by a ``rodc_local.py`` overlay."""
    import os
    import shutil

    from PIL import Image
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        checkpoint.save_cascade(os.path.join(work, "models"), "flagship", model)
        native = os.path.join(work, "native")
        for label, seeds in (("foreground", (40, 41)), ("background", (42,))):
            os.makedirs(os.path.join(native, "testset", label))
            for s in seeds:
                scene = synthetic.make_scene(IMG_H, IMG_W, 3 if label == "foreground" else 0,
                                             seed=s, min_face=48, max_face=120)
                Image.fromarray(scene.image).save(
                    os.path.join(native, "testset", label, "{}.png".format(s)))
        with open(os.path.join(work, "rodc_local.py"), "w") as f:
            f.write("cf = {!r}\n".format({
                "output_graph_dir": os.path.join(work, "models"),
                "default_evaluation_model_cascade": "flagship",
                "dataset_native_path_root": native, "dataset_keys": ["testset"],
                "class_min_images": None, "foreground_confidence_threshold": FLAG_THRESHOLD,
                "nms_opencv_min_neighbors": FLAG_MIN_NEIGHBORS, "log_auto_save": False,
            }))
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, RODC_HOME=work)
        env["PYTHONPATH"] = os.pathsep.join([work, repo, env.get("PYTHONPATH", "")])
        command = [sys.executable, "-m", "rapidobjectdetectionusingcascadedcnns_torch.run",
                   "inference-cascade"]
        t0 = time.perf_counter()
        out = subprocess.run(command, cwd=work, env=env, capture_output=True, text=True,
                             timeout=300)
        wall = time.perf_counter() - t0
        assert out.returncode == 0, (out.returncode, out.stdout[-2000:], out.stderr[-2000:])
        lines = [line for line in out.stdout.splitlines() if "detections: " in line]
        assert lines and "over 3 images" in lines[-1], out.stdout[-2000:]
        n_det = int(lines[-1].split("detections: ")[1].split()[0])
        assert n_det > 0, lines[-1]
        print("CLI: {} -> exit 0 in {:.2f} s (a new process: imports, checkpoint load on the "
              "card, 3 VGA images); {}".format(" ".join(command[1:]), wall,
                                               lines[-1].split(" ", 1)[1]))
    finally:
        shutil.rmtree(work, ignore_errors=True)



DYN_FRAME_COUNTS = (1, 7, 16, 23)  # frames served by one loaded dynamic program
LADDER_RUNGS = 5  # [640, 256] .. [5061, 4096]: the rungs phase 4's frames climb
CROSS_FRAMES = 2  # the cross-device bundle's CPU leg
SOAK_FRAMES = 128  # a short soak: 8 batches of the 16 VGA frames, each path
TRAIN_STEPS = 4  # chained updates a stage in phase 25


def _flagship_settings(cf):
    """Phase 18's recipe and operating point on ``cf``, with the device NMS
    tail on (the bundles' tail)."""
    tool = _load_tool("train_torch_flagship")
    tool.flagship_config(cf)
    _quietly(tool.apply_recorded_overrides, cf)
    cf.set("foreground_confidence_threshold", FLAG_THRESHOLD)
    cf.set("nms_opencv_min_neighbors", FLAG_MIN_NEIGHBORS)
    cf.set("nms_on_device", True)


def _spy_dispatches(served_det):
    """Record ``(rung, frames)`` of every program call of ``served_det``."""
    calls = []
    dispatch = served_det._dispatch_rung

    def spy(rung, frames):
        calls.append((rung, len(frames)))
        return dispatch(rung, frames)

    served_det._dispatch_rung = spy
    return calls


def _dynamic_flagship(torch, model, caps, work, kind, card):
    """22a. The flagship's VGA YUV program with a dynamic frame count,
    exported for ("cuda", "cpu") into ``work``, loaded on the card and
    serving 1, 7, 16 and 23 frames, each equal to the live detector."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    same = _load_tool("serve_torch_bundle_check").same_detections
    frames = vga_frames(max(DYN_FRAME_COUNTS))
    live_det = cascade.CascadeDetector(model, capacity_schedule=caps)
    t0 = time.perf_counter()
    bundle = serve.export_detector(model, IMG_H, IMG_W, batch="dynamic", yuv=True,
                                   capacities=caps, n_rungs=1, platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    assert bundle.meta["batch"] == "dynamic" and bundle.meta["chunk_hint"] == N_FRAMES
    t0 = time.perf_counter()
    serve.save_bundle(bundle, work)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served_det = serve.load_bundle(work)
    load_s = time.perf_counter() - t0
    _quietly(served_det.detect_batch, frames[:N_FRAMES])  # warm-up
    served = {}
    for n in DYN_FRAME_COUNTS:
        live = _quietly(live_det.detect_batch_yuv420, frames[:n])
        torch.cuda.synchronize()
        _reset_launches()
        calls = _spy_dispatches(served_det)
        t0 = time.perf_counter()
        served[n] = _quietly(served_det.detect_batch, frames[:n])
        wall = time.perf_counter() - t0
        del served_det._dispatch_rung
        bad = [i for i, (a, b) in enumerate(zip(live, served[n])) if not same(a, b)]
        assert len(served[n]) == n and not bad, ("dynamic bundle vs live", n, bad)
        k1, k3 = windows_cuda.LAUNCHES, nms_cuda.LAUNCHES
        # each program call: K1 for the two re-extractions, K3 for the tail
        assert k1 == 2 * len(calls) and k3 == len(calls), (n, calls, k1, k3)
        assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == 0
        print("dynamic bundle (flagship, capacities {}): {} frames served in {:.4f} s by program "
              "calls {} (rung, frames); equal to the live detector on every frame; K1 {} K3 {} "
              "launches".format(caps, n, wall, calls, k1, k3))
        if n == max(DYN_FRAME_COUNTS):
            launches = (k1, k3)
    print("dynamic bundle: export {:.2f} s ({} rungs, up to {} frames a call), save {:.2f} s, "
          "load {:.2f} s, on {} [{}]".format(export_s, len(bundle.meta["capacity_rungs"]),
                                            bundle.meta["max_batch"], save_s, load_s, kind, card))
    # K1 and K3 against their plain versions on the last program call's
    # inputs (the 7 frames after the first 16-frame chunk)
    tail = frames[N_FRAMES:max(DYN_FRAME_COUNTS)]
    label = "flagship dynamic bundle, {}-frame chunk".format(len(tail))
    k1 = phase_k1(torch, label, *vga_k1_inputs(torch, torch.device("cuda"), live_det, tail),
                  {24: caps[0], 48: caps[1]})
    k3 = _k3_case(torch, *_k3_inputs(torch, live_det, tail, caps), label, call_counts=False)
    return {"detector": served_det, "served": served, "frames": frames,
            "k1": (launches[0], k1), "k3": (launches[1], k3)}


def _crop_flagship(torch, model, caps, frames, work, kind, card):
    """22c. The flagship's VGA YUV program in crop mode (stage 0 through
    K2 over the plan's schedule, the schedule's tables constants of the
    program) with a dynamic frame count, exported for ("cuda", "cpu") into
    ``work``, loaded on the card and serving ``frames`` (the 16 VGA
    frames), equal to the live crop-mode detector. Returns the loaded detector's results,
    K2's launches in that call and K2 held against its plain version on
    the call's inputs."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    same = _load_tool("serve_torch_bundle_check").same_detections
    live_det = cascade.CascadeDetector(model, capacity_schedule=caps)
    plan = live_det._plan_and_table(IMG_H, IMG_W)[0]
    sched = cascade._stage0_schedule(plan, model.input_sizes[0], "pallas2", False)
    assert sched is not None
    t0 = time.perf_counter()
    bundle = serve.export_detector(model, IMG_H, IMG_W, batch="dynamic", yuv=True,
                                   capacities=caps, n_rungs=1, platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    assert bundle.meta["extraction_mode"] == "crop", bundle.meta["extraction_mode"]
    targets = [str(n.target) for n in bundle.programs[0].graph.nodes if n.op == "call_function"]
    assert targets.count("rodc.sched.default") == 1, targets.count("rodc.sched.default")
    serve.save_bundle(bundle, work)
    del bundle
    served_det = serve.load_bundle(work)
    live = _quietly(live_det.detect_batch_yuv420, frames)
    _quietly(served_det.detect_batch, frames)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    calls = _spy_dispatches(served_det)
    t0 = time.perf_counter()
    served = _quietly(served_det.detect_batch, frames)
    wall = time.perf_counter() - t0
    del served_det._dispatch_rung
    k1, k2, k3 = windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES, nms_cuda.LAUNCHES
    # each program call: K2 for stage 0, K1 for the two re-extractions, K3
    # for the tail
    assert k2 == len(calls) and k1 == 2 * len(calls) and k3 == len(calls), (calls, k1, k2, k3)
    assert windows_dyn_cuda.LAUNCHES == 0
    bad = [i for i, (a, b) in enumerate(zip(live, served)) if not same(a, b)]
    assert not bad, ("crop-mode bundle vs live", bad)
    print("crop-mode dynamic bundle (flagship, capacities {}, {} scheduled slots for {} "
          "windows): {} frames served in {:.4f} s by program calls {} (rung, frames); equal "
          "to the live crop-mode detector on every frame; K2 {} K1 {} K3 {} launches; export "
          "{:.2f} s; on {} [{}]".format(caps, sched.n_slots, plan.n_windows, len(frames), wall,
                                        calls, k2, k1, k3, export_s, kind, card))
    planes, _ = vga_k1_inputs(torch, torch.device("cuda"), live_det, frames)
    k2m = _k2_hold(torch, planes, plan, sched, "flagship crop-mode dynamic bundle, VGA")
    return {"served": served, "frames": frames, "k2": (k2, k2m)}


def _ladder_walk(torch, device, frames, kind, card):
    """22b. Random weights at the default capacities through a dynamic
    bundle whose ladder reaches the rung phase 4's frames end on: the
    served batch re-runs each saturated frame alone at each rung, as the
    live detector re-dispatches it, with equal results. Then the same
    programs re-run each frame padded to 16 copies, as a static bundle
    does."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    same = _load_tool("serve_torch_bundle_check").same_detections
    model = cascade.build_cascade_model(seed=0, device=device)
    live_det = cascade.CascadeDetector(model)
    live = _quietly(live_det.detect_batch_yuv420, frames)
    t0 = time.perf_counter()
    bundle = serve.export_detector(model, IMG_H, IMG_W, batch="dynamic", yuv=True,
                                   n_rungs=LADDER_RUNGS)
    export_s = time.perf_counter() - t0
    rungs = bundle.meta["capacity_rungs"]
    assert rungs[-1] == OPEN_CAPS, rungs
    served_det = serve.ServingDetector(bundle, device)
    _quietly(served_det.detect_batch, frames)  # warm-up
    live_det.redispatches = 0
    live = _quietly(live_det.detect_batch_yuv420, frames)
    calls = _spy_dispatches(served_det)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = _quietly(served_det.detect_batch, frames)
    dynamic_s = time.perf_counter() - t0
    del served_det._dispatch_rung
    reruns = [c for c in calls if c[0] > 0]
    assert reruns and all(n == 1 for _, n in reruns), calls
    assert len(reruns) == live_det.redispatches, (len(reruns), live_det.redispatches)
    bad = [i for i, (a, b) in enumerate(zip(live, served)) if not same(a, b)]
    assert not bad, ("ladder walk vs the live re-dispatch", bad)
    # the static bundle's re-runs: the same programs, each frame padded to 16
    served_det.meta = dict(served_det.meta, batch=N_FRAMES)
    calls = _spy_dispatches(served_det)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    padded = _quietly(served_det.detect_batch, frames)
    padded_s = time.perf_counter() - t0
    del served_det._dispatch_rung
    assert all(n == N_FRAMES for _, n in calls), calls
    flips = [len(set(a.raw_window_ids.tolist()) ^ set(b.raw_window_ids.tolist()))
             for a, b in zip(live, padded)]
    print("ladder walk (random weights, rungs {}): {} re-runs, each of 1 frame, as the live "
          "detector's {} re-dispatches; served equal to the live detector on all {} frames; "
          "batch {:.4f} s with single-frame re-runs against {:.4f} s with the re-runs padded to "
          "{} frames (a static bundle's), whose survivors differ from the live ones by {} "
          "windows a frame; export {:.2f} s; on {} [{}]".format(
              rungs, len(reruns), live_det.redispatches, len(frames), dynamic_s, padded_s,
              N_FRAMES, flips, export_s, kind, card))


def phase_dynamic_bundle(torch, device, flagship, frames, work, kind, card):
    """22. Dynamic-batch bundles: the flagship's (22a, saved in
    ``work["gather"]``), a ladder walk with random weights (22b), and the
    flagship's in crop mode (22c, saved in ``work["crop"]``). Returns 22a's
    loaded detector, served results, frames and K1/K3 launches and
    measurements, and 22c's under ``"crop"``."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    saved = cf.snapshot()
    try:
        t0 = time.perf_counter()
        _flagship_settings(cf)
        out = _dynamic_flagship(torch, flagship["model"], flagship["caps"], work["gather"],
                                kind, card)
        cf.restore(saved)
        cf.set("nms_on_device", True)
        torch.cuda.empty_cache()
        _ladder_walk(torch, device, frames, kind, card)
        cf.restore(saved)
        torch.cuda.empty_cache()
        _flagship_settings(cf)
        cf.set("window_extraction_mode", "crop")
        out["crop"] = _crop_flagship(torch, flagship["model"], flagship["caps"], frames,
                                     work["crop"], kind, card)
        print("phase 22: {:.1f} s".format(time.perf_counter() - t0))
    finally:
        cf.restore(saved)
    return out


def phase_cross_device(torch, flagship, dynamic, work, kind, card):
    """23. Phase 22's ("cuda", "cpu") bundles, gather mode (22a) and crop
    mode (22c), loaded on the CPU (their programs moved there, the
    operators' plain versions running) over 2 frames each, against the
    card's results for them: matched detections within 1 px and 0.05
    confidence, every unmatched detection with its survivor flips' stage
    probabilities on both devices."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    tool = _load_tool("cross_platform_torch_bundle")
    windows_cuda, windows_sched_cuda, _, nms_cuda = _kernel_modules()
    model = flagship["model"]
    cpu_model = model.to("cpu")
    t_phase = time.perf_counter()
    for mode, card_results, frames in (
            ("gather", dynamic["served"][N_FRAMES], dynamic["frames"]),
            ("crop", dynamic["crop"]["served"], dynamic["crop"]["frames"])):
        card_results = card_results[:CROSS_FRAMES]
        cpu_det = serve.load_bundle(work[mode], device="cpu")
        assert cpu_det.meta["extraction_mode"] == mode, cpu_det.meta["extraction_mode"]
        _reset_launches()
        t0 = time.perf_counter()
        cpu_results = _quietly(cpu_det.detect_batch, frames[:CROSS_FRAMES])
        cpu_s = time.perf_counter() - t0
        # the plain versions
        assert windows_cuda.LAUNCHES == windows_sched_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
        meta = cpu_det.meta
        probes = {"card": {}, "cpu": {}}
        for i, (a, b) in enumerate(zip(card_results, cpu_results)):
            ids = set(a.raw_window_ids.tolist()) ^ set(b.raw_window_ids.tolist())
            probes["card"][i] = tool.stage_probabilities(model, frames[i], ids, meta,
                                                         model.device)
            probes["cpu"][i] = tool.stage_probabilities(cpu_model, frames[i], ids, meta,
                                                        cpu_model.device)
        cmp = tool.compare_detections(tool.jsonable(card_results), tool.jsonable(cpu_results),
                                      meta["thresholds"], probes)
        print("cross-device bundle ({} mode): {} frames on the CPU in {:.2f} s (no kernel "
              "launched); card {} and CPU {} detections; max matched box delta {} px, "
              "confidence delta {:.3g}; survivor flips per frame {}; on {} [{}]".format(
                  mode, CROSS_FRAMES, cpu_s, [len(r.boxes) for r in card_results],
                  [len(r.boxes) for r in cpu_results], cmp["max_box_delta"],
                  cmp["max_conf_delta"], [sc["survivor_flips"] for sc in cmp["scenes"]], kind,
                  card))
        for u in cmp["unmatched"]:
            print("cross-device bundle ({} mode): unmatched".format(mode), json.dumps(u))
        for sc in cmp["scenes"]:
            if not sc["ok"]:
                print("cross-device bundle ({} mode): scene out of tolerance".format(mode),
                      json.dumps(sc))
        assert cmp["ok"], (mode, cmp)
    print("phase 23: {:.1f} s".format(time.perf_counter() - t_phase))


def phase_soak(torch, flagship, dynamic, frames, kind, card):
    """24. A short soak of the live detector and of phase 22's bundle:
    latency drift, card memory after the warm-up and at the end, and
    detections identical across repeats of the same frames."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    tool = _load_tool("soak_torch_serving")
    saved = cf.snapshot()
    try:
        _flagship_settings(cf)
        live = cascade.CascadeDetector(flagship["model"], capacity_schedule=flagship["caps"])
        for name, detect in (("live detector", live.detect_batch_yuv420),
                             ("dynamic bundle", dynamic["detector"].detect_batch)):
            r = _quietly(tool.soak, detect, frames, SOAK_FRAMES, N_FRAMES,
                         torch.device("cuda"))
            warm, end = r["memory_after_warmup"], r["memory_at_end"]
            print("soak, {}: {} frames in {} batches, {:.2f} frames/s, batch median {:.3f} ms "
                  "(p95 {:.3f}), latency drift {:+.2f}% (last quarter {:.3f} ms against first "
                  "{:.3f} ms); card memory allocated {} -> {} B, peak {} -> {} B; detection "
                  "drift {}; on {} [{}]".format(
                      name, r["n_frames"], r["n_batches"], r["fps"], r["batch_ms_median"],
                      r["batch_ms_p95"], r["latency_drift_pct"],
                      r["batch_ms_last_quarter_median"], r["batch_ms_first_quarter_median"],
                      warm["allocated"], end["allocated"], warm["max_allocated"],
                      end["max_allocated"], r["detection_drift_count"], kind, card))
            assert r["detection_drift_count"] == 0, (name, r)
            assert end["allocated"] <= warm["allocated"] + (64 << 20), (name, warm, end)
    finally:
        cf.restore(saved)


def phase_train_profile(torch, device, kind, card):
    """25. tools/profile_torch_train.py's step times per stage, cut to a
    few chained updates, and its split of one update."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    tool = _load_tool("profile_torch_train")
    saved = cf.snapshot()
    try:
        cf.reset()
        tool.profile_config(cf)
        batch = int(cf.get("batch_size"))
        for r in tool.step_times(device, batch, steps=TRAIN_STEPS):
            assert r["ms_per_step"] > 0, r
            print("train step, {} px{}: {:.4f} ms a step, {:.0f} samples/s over {} chained "
                  "updates of batch {}, on {} [{}]".format(
                      r["size"], " with augmentation" if r["augment"] else "",
                      r["ms_per_step"], r["samples_per_s"], r["steps"], batch, kind, card))
        split = tool.update_split(device, batch)
        assert split["same_loss"], split
        print("train update split (48 px with augmentation, batch {}): {}; total {:.4f} ms, {} "
              "launches in all; on {} [{}]".format(batch, json.dumps(split["parts"]),
                                                  split["total_ms"], split["launches"], kind,
                                                  card))
    finally:
        cf.restore(saved)


TRAIN_APP_POS, TRAIN_APP_NEG = 1000, 2000  # the 80% train split: 2,400 samples, 2 batches
TRAIN_APP_EPOCHS = 3  # epochs_total cut from 50 (the debug preset's count)
TRAIN_APP_KEY = "chip_smoke_apps"
TRAIN_APP_DATASET = "faces"
# the metric keys of the JAX package's train/metrics.process_results
METRIC_KEYS = {"accuracy", "f1_score", "false_negatives", "false_positives", "precision",
               "recall", "samples_negative", "samples_positive", "true_negative_rate",
               "true_negatives", "true_positives"}
VIS_SCENES = 4  # VGA scenes through the visualizers
VIS_CPU_SCENES = 1  # of them again on the CPU
TUNE_SESSIONS = 2


def _train_app_settings(work):
    """The ``rodc_local.py`` settings of phase 26's runs and the config
    phases 27-28 use: the corpus, its dataset cache, the checkpoints; the
    default widths with ``epochs_total`` cut and the constant-prediction
    guard off (tools/tune_session.py's choice: the F-beta stages of a
    3-epoch run may predict one class at every evaluation)."""
    import os

    return {
        "dataset_path_root": os.path.join(work, "data"),
        "dataset_keys": [TRAIN_APP_DATASET], "class_min_images": None,
        "cache_path_root": os.path.join(work, "cache"),
        "output_graph_dir": os.path.join(work, "models"),
        "collages_dir": os.path.join(work, "collages"),
        "log_dir": os.path.join(work, "logs"),
        "snapshot_dir": os.path.join(work, "snapshots"),
        "summary_dir": os.path.join(work, "summaries"),
        "epochs_total": TRAIN_APP_EPOCHS, "n_max_constant_evals": None,
        "log_auto_save": False,
    }


def _json_line(stdout, prefix):
    lines = [line for line in stdout.splitlines() if prefix in line]
    assert lines, "no {!r} line in\n{}".format(prefix, stdout[-3000:])
    return json.loads(lines[-1].split(prefix, 1)[1])


def phase_train_apps(torch, kind, card, work):
    """26. The train apps through the CLI, each in a fresh process on the
    card set up by a ``rodc_local.py`` overlay: a label-folder corpus of
    ``TRAIN_APP_POS`` face crops and ``TRAIN_APP_NEG`` background patches
    written as PNGs, then ``train-cascade`` (builds and caches the dataset at
    12/24/48 px, trains, exports) and ``train-single`` (its 48 px dataset
    read from the cache). Returns the checkpoint's directory and session key."""
    import os

    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic

    t0 = time.perf_counter()
    fg, bg = synthetic.write_label_folder_corpus(os.path.join(work, "data"), TRAIN_APP_DATASET,
                                                 TRAIN_APP_POS, TRAIN_APP_NEG, seed=0)
    corpus_s = time.perf_counter() - t0
    settings = _train_app_settings(work)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RODC_HOME=work)
    env["PYTHONPATH"] = os.pathsep.join([work, repo, env.get("PYTHONPATH", "")])
    print("train apps: corpus of {} face crops and {} backgrounds written as PNGs in {:.2f} s; "
          "default widths, epochs_total {} (cut from 50), n_max_constant_evals None".format(
              len(fg), len(bg), corpus_s, TRAIN_APP_EPOCHS))
    for command, key in (("train-cascade", TRAIN_APP_KEY), ("train-single",
                                                             TRAIN_APP_KEY + "_single")):
        with open(os.path.join(work, "rodc_local.py"), "w") as f:
            f.write("cf = {!r}\n".format(dict(settings, session_key=key)))
        argv = [sys.executable, "-m", "rapidobjectdetectionusingcascadedcnns_torch.run",
                command]
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=work, env=env, capture_output=True, text=True,
                             timeout=900)
        wall = time.perf_counter() - t0
        assert out.returncode == 0, (command, out.returncode, out.stdout[-3000:],
                                     out.stderr[-3000:])
        results = _json_line(out.stdout, "final_results: ")
        phases = _json_line(out.stdout, "phase seconds: ")
        assert sorted(results) == ["test", "train", "valid"], sorted(results)
        for split, metrics in results.items():
            assert METRIC_KEYS <= set(metrics), (split, sorted(metrics))
        print("train apps: {} -> exit 0 in {:.2f} s (a new process); final_results: {}".format(
            " ".join(argv[2:]), wall, json.dumps(
                {k: {m: round(v, 4) for m, v in r.items() if m in ("accuracy", "recall",
                                                                   "precision")}
                 for k, r in results.items()})))
        print("train apps: {} host seconds: {} on {} [{}]".format(
            command, json.dumps({k: round(v, 3) for k, v in phases.items()}), kind, card))
    for size in (12, 24, 48):
        npz = os.path.join(work, "cache", "v1", "{0}x{0}".format(size), TRAIN_APP_DATASET,
                           "data.npz")
        assert os.path.exists(npz), npz
    models = os.path.join(work, "models")
    names = ["model_{}_{}.{}".format(TRAIN_APP_KEY, i, ext) for i in range(3)
             for ext in ("npz", "json")]
    names += ["model_{}_single.{}".format(TRAIN_APP_KEY, ext) for ext in ("npz", "json")]
    missing = [n for n in names if not os.path.exists(os.path.join(models, n))]
    assert not missing, missing
    return {"model_dir": models, "session_key": TRAIN_APP_KEY}


def phase_visualizers(torch, kind, card, work, trained):
    """27. The visualizers in process: phase 26's cascade loaded on the card
    by ``InferenceCascadeApp`` and run through ``InferenceVisualizerApp`` on
    VGA scenes (stage 0 in gather mode at 1.1: K1 re-extracts), K1 counted
    per dispatch shape (the first dispatch and each saturation re-dispatch
    rung) and held against its plain version at every shape the run
    launched it at, the overlays and boxes against the same app on the CPU;
    then the Viola-Jones baseline (``InferenceOCVApp``, on the host) through
    the same visualizer. Returns one ``(label, launches, measurement)`` for
    K1 per dispatch shape."""
    import os

    import numpy as np
    from PIL import Image

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps, visualizer
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge, cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    saved = cf.snapshot()
    try:
        cf.set("output_graph_dir", trained["model_dir"])
        cf.set("session_key", "chip_smoke_vis")
        cf.set("log_auto_save", False)
        frames = [synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=60 + i, min_face=48,
                                       max_face=120).image for i in range(VIS_SCENES)]
        app = inference_apps.InferenceCascadeApp(trained["session_key"])
        det = app.detector
        _quietly(app.run_inference_on_images, frames)  # warm-up (cuDNN/cuBLAS plans)
        cf.set("bbox_visualization_dir", os.path.join(work, "vis_card"))
        det.redispatches = 0
        # K1's launches per dispatch shape (frames, capacities), with the
        # frames each shape first saw
        shapes = {}
        run_chunk = det._run_chunk

        def counted_chunk(chunk, yuv, caps, entry, resample):
            before = windows_cuda.LAUNCHES
            out = run_chunk(chunk, yuv, caps, entry, resample)
            shape = shapes.setdefault((len(chunk), tuple(caps)), {"frames": chunk, "k1": 0})
            shape["k1"] += windows_cuda.LAUNCHES - before
            return out

        det._run_chunk = counted_chunk
        torch.cuda.synchronize()
        _reset_launches()
        with _captured_results() as got:
            t0 = time.perf_counter()
            vis = _quietly(visualizer.InferenceVisualizerApp, app, frames)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        del det._run_chunk
        k1 = windows_cuda.LAUNCHES
        assert k1 >= 2, k1
        assert k1 == sum(v["k1"] for v in shapes.values()), (k1, shapes)
        assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
        entry = det._plan_and_table(IMG_H, IMG_W)
        plan, coords = entry[0], entry[2]
        assert cascade.resolve_extraction_mode(plan) == "gather", plan.n_scales  # cascade.py:154
        (results,) = got
        assert len(results) == len(vis.saved_paths) == VIS_SCENES
        for frame, res, path in zip(frames, results, vis.saved_paths):
            assert bool(np.isfinite(res.boxes).all()) and res.n_windows == plan.n_windows
            overlay = np.asarray(Image.open(path))
            assert np.array_equal(overlay, visualizer.draw_detections(frame, res.boxes,
                                                                      res.confidences)), path
        print("visualizer, train-app cascade on {} [{}]: {} VGA scenes in {:.4f} s = {:.4f} "
              "s/image (overlays drawn and written included); survivors per stage {}, "
              "detections {}, re-dispatches {}; K1 launches {} by (frames, capacities) {}, "
              "K2 {} (gather mode: {} levels)".format(
                  kind, card, VIS_SCENES, card_s, card_s / VIS_SCENES,
                  [r.n_survivors_per_stage for r in results], [len(r.boxes) for r in results],
                  det.redispatches, k1, {"{} x {}".format(*k): v["k1"]
                                         for k, v in shapes.items()},
                  windows_sched_cuda.LAUNCHES, plan.n_scales))

        # K1 against its plain version at every shape the run launched it at
        default_caps = tuple(det._capacity_override or cascade.default_capacity_schedule(
            plan.n_windows, det.model.n_nets))
        k1_lines = []
        for (n_frames, caps), shape in sorted(shapes.items(), key=lambda kv: kv[0][1]):
            what = "{}, {} frame{} at capacities {}".format(
                "first dispatch" if caps == default_caps else "saturation re-dispatch",
                n_frames, "" if n_frames == 1 else "s", "/".join(map(str, caps)))
            planes = windows.to_planes_bf16(_dense_images(torch, torch.device("cuda"),
                                                          shape["frames"]))
            m = phase_k1(torch, "train-app visualizer, " + what, planes, coords.float(),
                         {24: caps[0], 48: caps[1]})
            del planes
            k1_lines.append((what, shape["k1"], m))

        # the same app and visualizer on the CPU
        cf.set("bbox_visualization_dir", os.path.join(work, "vis_cpu"))
        cpu_model = bridge.load_cascade(trained["model_dir"], trained["session_key"], "cpu")
        cpu_app = inference_apps.InferenceCascadeApp(model=cpu_model, device="cpu")
        with _captured_results() as got_cpu:
            t0 = time.perf_counter()
            cpu_vis = _quietly(visualizer.InferenceVisualizerApp, cpu_app,
                               frames[:VIS_CPU_SCENES])
            cpu_s = time.perf_counter() - t0
        (cpu_results,) = got_cpu
        flips, same_overlays = [], 0
        for i, (g, c) in enumerate(zip(results, cpu_results)):
            f, allowed, _, _ = _flips(g, c)
            flips.append(len(f))
            assert len(f) <= allowed, (i, len(f), allowed)
            assert abs(len(g.boxes) - len(c.boxes)) <= len(f), (i, len(g.boxes), len(c.boxes))
            if _box_set(g.boxes) == _box_set(c.boxes):
                a = np.asarray(Image.open(vis.saved_paths[i]))
                b = np.asarray(Image.open(cpu_vis.saved_paths[i]))
                assert np.array_equal(a, b), i
                same_overlays += 1
        print("visualizer card vs cpu ({} scenes, bf16): last-stage survivor flips per scene {} "
              "(allowed {:.0%} of the survivors), boxes (card, cpu) {}, overlays pixel-equal "
              "in {} of {} (every scene with equal boxes); the cpu took {:.2f} s".format(
                  VIS_CPU_SCENES, flips, BORDERLINE_FRACTION,
                  [(len(g.boxes), len(c.boxes)) for g, c in zip(results, cpu_results)],
                  same_overlays, VIS_CPU_SCENES, cpu_s))

        # the Viola-Jones baseline through the same visualizer, on the host
        cf.set("bbox_visualization_dir", os.path.join(work, "vis_vj"))
        cf.set("window_scale_factor", 1.1)
        with _captured_results() as got_vj:
            t0 = time.perf_counter()
            vj_vis = _quietly(visualizer.InferenceVisualizerApp,
                              inference_apps.InferenceOCVApp(), frames)
            vj_s = time.perf_counter() - t0
        (vj_results,) = got_vj
        assert len(vj_vis.saved_paths) == VIS_SCENES
        print("visualizer: cascade {:.4f} s/image on {} against the Viola-Jones baseline {:.4f} "
              "s/image on the host (in-repo evaluator, scale factor 1.1, min_neighbors {}); "
              "detections per scene cascade {} VJ {}; [{}]".format(
                  card_s / VIS_SCENES, kind, vj_s / VIS_SCENES, cf.get("nms_opencv_min_neighbors"),
                  [len(r.boxes) for r in results], [len(r.boxes) for r in vj_results], card))
    finally:
        cf.restore(saved)
    return k1_lines


def phase_tune_app(torch, kind, card, work, trained):
    """28. The tune app in process: ``TuneCascadeApp`` with random draws over
    the tune-cascade keys without ``cascade_n_nets`` (as
    tools/tune_session.py: that grid reaches 15 nets) on phase 26's corpus
    and dataset cache, at its cut epochs and a fixed seed; two sessions, then
    a second app resuming from the state file for one more."""
    import os

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps.tune_apps import TuneCascadeApp
    from rapidobjectdetectionusingcascadedcnns_torch.run import TUNE_CASCADE_PARAM_KEYS
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    keys = [k for k in TUNE_CASCADE_PARAM_KEYS if k != "cascade_n_nets"]
    saved = cf.snapshot()
    state = os.path.join(work, "tune_state.json")
    try:
        for key, value in dict(_train_app_settings(work), seed=11, session_key="chip_smoke_tune",
                               output_graph_dir=os.path.join(work, "tune_models")).items():
            cf.set(key, value)
        before = cf.snapshot()
        log.set_echo(False)
        try:
            t0 = time.perf_counter()
            app = TuneCascadeApp(keys, random=True, max_sessions=TUNE_SESSIONS, state_path=state)
            first_s = time.perf_counter() - t0
            assert cf.snapshot() == before, "the tune app left the configuration changed"
            t0 = time.perf_counter()
            resumed = TuneCascadeApp(keys, random=True, max_sessions=1, state_path=state)
            resumed_s = time.perf_counter() - t0
        finally:
            log.set_echo(True)
        assert app.n_sessions == TUNE_SESSIONS and app.n_failed == 0, app.failures
        assert app.best_score > float("-inf") and app.best_config_snapshot is not None
        assert resumed.n_failed == 0, resumed.failures
        assert len(resumed.tuner.results) == TUNE_SESSIONS + 1, len(resumed.tuner.results)
        assert cf.snapshot() == before
        print("tune app on {} [{}]: {} sessions in {:.2f} s ({:.2f} s a session; dataset read "
              "from phase 26's cache), 0 failed, global best {} = {:.4f}; configurations {}; "
              "a second app resumed from the state file: 1 more session in {:.2f} s, {} "
              "results in all".format(
                  kind, card, app.n_sessions, first_s, first_s / app.n_sessions,
                  cf.get("tuning_main_criteria"), app.best_score,
                  [r["config"] for r in resumed.tuner.results], resumed_s,
                  len(resumed.tuner.results)))
    finally:
        cf.restore(saved)


# phase 29: phase 18's cut recipe with the appended Inception stage, its
# corpus cut again so that the 299 px rendering stays under about 2 GB of
# host memory (4,000 samples and the mined windows once, not 4 times:
# 5,524 samples, 1.48 GB at 299 px)
INC_POS, INC_NEG, INC_MINED = 1000, 3000, 1
# (frames, boxes) at which K1 is held at 299 px beside the shapes the path
# launched it at (the detector cuts the stage into chunks of
# inception.rows_per_chunk() // frames boxes a frame, so it launches
# neither of these)
INC_K1_EXTRA_SHAPES = ((N_FRAMES, 64), (1, 256))
INC_BIG_BOXES = 8192  # one K1 launch of more than 2^31 output values
INC_TRAIN_STEPS = 10  # synchronised updates of the compact trunk trained end to end
INC_COMPACT_SAMPLES = 1024  # its corpus: 819 training samples, one batch of 512
INC_CMP_ROWS = 32  # the Inception stage's rows of the card run held against the CPU
# card against CPU: bf16 embeddings and logits within 2% of each value plus
# 1% of the largest magnitude (tests/test_torch_inception_training.py's
# bound for the port's bf16 embeddings against JAX's); f32 embeddings (TF32
# off) within the JAX package's bound against torch (rtol 1e-3, atol 5e-4,
# tests/test_inception_v3.py), and their row-to-row part (each row less the
# rows' mean: what depends on the window) within 5% of its largest value
INC_BF16_RTOL, INC_BF16_ATOL_SHARE = 0.02, 0.01
INC_F32_RTOL, INC_F32_ATOL = 1e-3, 5e-4
INC_CENTRED_SHARE = 0.05


@contextlib.contextmanager
def _k1_launches_by_shape(inputs=None):
    """K1's launches by launch shape while the block runs: the wrapper
    counts each launch (``LAUNCHES``); this splits the count by the
    launch's (frames, boxes, window size). Yields {(frames, boxes, size):
    launches}. With ``inputs`` (a dict), also keeps the first launch's
    inputs at each (frames, boxes, size, height, width): ``inputs[key] =
    [launches, planes, sy, sx]`` (the planes by reference: the detectors
    make them anew for every chunk and write them once)."""
    windows_cuda = _kernel_modules()[0]
    real = windows_cuda.crop_and_resize_cuda
    counts = {}

    def counted(planes, sy, sx):
        before = windows_cuda.LAUNCHES
        out = real(planes, sy, sx)
        key = tuple(int(n) for n in sy.shape)
        launched = windows_cuda.LAUNCHES - before
        counts[key] = counts.get(key, 0) + launched
        if inputs is not None:
            seen = inputs.setdefault(key + tuple(int(n) for n in planes.shape[2:]),
                                     [0, planes, sy.clone(), sx.clone()])
            seen[0] += launched
        return out

    windows_cuda.crop_and_resize_cuda = counted
    try:
        yield counts
    finally:
        windows_cuda.crop_and_resize_cuda = real


@contextlib.contextmanager
def _k2_launches_by_shape():
    """K2's launches by launch shape while the block runs, as
    :func:`_k1_launches_by_shape` counts K1's. Yields {(frames, slots,
    window size): launches}."""
    windows_sched_cuda = _kernel_modules()[1]
    real = windows_sched_cuda.resample_sched_cuda
    counts = {}

    def counted(planes, sy, *args):
        before = windows_sched_cuda.LAUNCHES
        out = real(planes, sy, *args)
        key = (int(planes.shape[0]), int(sy.shape[0]), int(sy.shape[1]))
        counts[key] = counts.get(key, 0) + windows_sched_cuda.LAUNCHES - before
        return out

    windows_sched_cuda.resample_sched_cuda = counted
    try:
        yield counts
    finally:
        windows_sched_cuda.resample_sched_cuda = real


def _at_299(by_shape):
    """{(frames, boxes): launches} of the 299 px launches."""
    return {(f, n): k for (f, n, size), k in by_shape.items() if size == 299}


@contextlib.contextmanager
def _trunk_timer(torch):
    """Device milliseconds of every Inception trunk call while the block
    runs (CUDA events around each call, read once at the end). Yields
    {"ms": ..., "calls": ..., "rows": ...}."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import inception

    real = inception.apply_backbone
    events, acc = [], {"ms": 0.0, "calls": 0, "rows": 0}

    def timed(params, x, dtype=torch.bfloat16):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(params, x, dtype=dtype)
        end.record()
        events.append((start, end))
        acc["calls"] += 1
        acc["rows"] += int(x.shape[0])
        return out

    inception.apply_backbone = timed
    try:
        yield acc
    finally:
        inception.apply_backbone = real
        torch.cuda.synchronize()
        acc["ms"] = sum(a.elapsed_time(b) for a, b in events)


def _inception_k1_big(torch, planes, coords):
    """K1 at 299 px on INC_BIG_BOXES boxes of one frame, more than 2^31
    output values: the last boxes, past that offset, equal the plain
    version on the same boxes (64-bit box offsets)."""
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows, windows_cuda

    gen = torch.Generator(device=planes.device).manual_seed(1)
    ids = torch.randint(0, coords.shape[0], (1, INC_BIG_BOXES), generator=gen,
                        device=planes.device)
    sy, sx = windows.sample_positions(coords[ids], IMG_H, IMG_W, 299, 299)
    sy, sx = sy.contiguous(), sx.contiguous()
    got = windows_cuda.crop_and_resize_cuda(planes[:1].contiguous(), sy, sx)
    tail = slice(INC_BIG_BOXES - 16, INC_BIG_BOXES)
    ref = windows.resample_plain(planes[:1], sy[:, tail], sx[:, tail])
    n_values = got.numel()
    assert n_values > 2 ** 31, n_values
    n_bad, total, err = _compare(got[:, tail], ref, "K1 299 px past 2^31 values")
    print("K1 299 px, one launch of {} boxes ({} values, over 2^31): its last 16 boxes "
          "against the plain version, {} of {} values differ (max {})".format(
              INC_BIG_BOXES, n_values, n_bad, total, err))
    del got, ref


def _inception_head_scale(torch, device, inc):
    """Why the recipe's head diverges on the fixture trunk: the embedded
    training rows' scale (mean |f|, the largest eigenvalue of their second
    moment, which sets the step a gradient method can take, and their
    spread from row to row), then a plain logistic head (2048 -> 2, zero
    weights, the recipe's momentum SGD, learning rate and batch, as many
    steps as the stage took) on the raw rows and on the rows standardized
    per feature. The standardized head's loss must fall."""
    import math

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    x = torch.as_tensor(inc.ds.train.images, device=device)
    y = torch.as_tensor(inc.ds.train.labels, device=device).long()
    lam = float(torch.linalg.eigvalsh(x.T @ x / len(x))[-1])
    lr, momentum, batch = cf.get("learning_rate_init"), cf.get("momentum"), cf.get("batch_size")
    steps = len(inc.losses())

    def fit(rows):
        gen = torch.Generator(device=device).manual_seed(0)
        w = torch.zeros(rows.shape[1], 2, device=device, requires_grad=True)
        b = torch.zeros(2, device=device, requires_grad=True)
        opt = torch.optim.SGD([w, b], lr=lr, momentum=momentum)
        losses = []
        for _ in range(steps):
            idx = torch.randint(0, len(rows), (batch,), generator=gen, device=device)
            loss = torch.nn.functional.cross_entropy(rows[idx] @ w + b, y[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses

    raw = fit(x)
    std = fit((x - x.mean(0)) / (x.std(0) + 1e-6))
    print("inception head: the embedded training rows ({} x {}) have mean |f| {:.4f}, the "
          "second moment's largest eigenvalue {:.6g} (learning rate x eigenvalue / 4 = {:.6g} "
          "against momentum SGD's stability limit 2 (1 + {}) = {:.2f}) and a row-to-row spread "
          "of {:.4f} a feature (mean std over the rows); a logistic head at the recipe's "
          "momentum SGD (lr {}, batch {}, {} steps): raw rows loss first {:.6f} last {:.6g} "
          "(max {:.6g}), rows standardized per feature first {:.6f} last {:.6f} (min "
          "{:.6f})".format(tuple(x.shape)[0], tuple(x.shape)[1], float(x.abs().mean()), lam,
                           lr * lam / 4, momentum, 2 * (1 + momentum), float(x.std(0).mean()),
                           lr, batch, steps, raw[0], raw[-1], max(raw), std[0], std[-1],
                           min(std)))
    assert all(math.isfinite(v) for v in std) and statistics.mean(std[-10:]) < std[0], std


def _inception_train(torch, device, tool, archive, kind, card):
    """29b. Phase 18's cut recipe with ``append_inception`` and the v3
    fixture archive: three custom stages, then the frozen trunk's
    embed-once head training. Returns (model, trainer, provider)."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as tr
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    tool.flagship_config(cf)
    recipe = _quietly(tool.apply_recorded_overrides, cf)
    cf.set("epochs_total", FLAG_EPOCHS)
    cf.set("append_inception", True)
    cf.set("inception_weights_path", archive)
    cut = dict(recipe, hard_negatives=INC_MINED, hard_positives=INC_MINED)
    t0 = time.perf_counter()
    provider = _quietly(tool.flagship_provider, INC_POS, INC_NEG, recipe["seed"], cut)
    corpus_s = time.perf_counter() - t0
    timing = {}
    real_dataset, real_embed = provider.dataset, tr.SingleNetTrainer._embed_splits_through_trunk

    def dataset(size):
        t = time.perf_counter()
        out = real_dataset(size)
        timing.setdefault("dataset", {})[size] = time.perf_counter() - t
        return out

    def embed(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_embed(self)
        timing["embed"] = (time.perf_counter() - t, self.ds.n_samples)

    provider.dataset = dataset
    tr.SingleNetTrainer._embed_splits_through_trunk = embed
    trainer = ct.CascadeTrainer(provider, seed=recipe["seed"], device=device)
    log.set_echo(False)
    try:
        t0 = time.perf_counter()
        model = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        log.set_echo(True)
        tr.SingleNetTrainer._embed_splits_through_trunk = real_embed
        provider.dataset = real_dataset
    assert model.n_nets == 4 and trainer.sizes == [12, 24, 48, 299], trainer.sizes
    inc = trainer.stage_trainers[-1]
    assert inc._frozen_trunk and inc._augment is None and inc.ds.train.images.shape[1] == 2048
    rendered = provider._images[299]
    embed_s, n_embedded = timing["embed"]
    print("inception: corpus of {} samples ({}/{} and the mined windows x{}) in {:.2f} s; "
          "its 299 px rendering {} bytes, dataset {:.2f} s (render and standardization "
          "statistics); 4 stages trained in {:.2f} s on {} [{}]".format(
              len(provider._labels), INC_POS, INC_NEG, INC_MINED, corpus_s, rendered.nbytes,
              timing["dataset"][299], train_s, kind, card))
    assert rendered.nbytes < 2.2e9, rendered.nbytes
    # the warm trunk: one chunk of the embed pass's rows, median of 5 calls
    from rapidobjectdetectionusingcascadedcnns_torch.models import inception

    rows = inception.rows_per_chunk()
    trunk = inception.cast_backbone(inc.state.params["backbone"], torch.bfloat16)
    x = torch.as_tensor(rendered[:rows], device=device).float()
    x = (x - inc._window_mean) / inc._window_std
    with torch.no_grad():
        warm_ms = _median_ms(lambda: inception.apply_backbone(trunk, x), torch, warmup=2,
                             iters=5, reps=1)
    print("inception: embed-once through the frozen InceptionV3 trunk (bf16): {} windows in "
          "{:.3f} s = {:.1f} windows/s (the pass, its chunks' first cuDNN plans included); "
          "warm, {} rows a call: {:.3f} ms = {:.1f} windows/s".format(
              n_embedded, embed_s, n_embedded / embed_s, rows, warm_ms, rows / warm_ms * 1e3))
    del x
    # the head's loss on the fixture trunk rises: _inception_head_scale
    # shows why, and holds a head on the same rows standardized to falling
    _report_stages(torch, device, trainer, min_steps=50, must_fall={0, 1, 2})
    _inception_head_scale(torch, device, inc)
    print("inception: combined cascade on the test split {}".format(
        {k: round(v, 4) for k, v in trainer.combined_results["test"].items()}))
    return model, trainer, provider


# The cut recipe's cascade keeps about 90% of the VGA windows at stage 0
# and its last two stages pass what reaches them, so every frame saturates
# the default capacities, and exact survivor sets would climb the ladder
# to 5,061 rows a frame through the trunk. Phase 29 keeps the default
# capacities without re-dispatch: truncated results (the rank compaction
# keeps each stage's strongest windows), the trunk bounded at 16 x 256
# rows a batch.
INC_SETTINGS = {"cascade_saturation_redispatch": False}


def _inception_detect(torch, model, frames, kind, card):
    """29c. The 4-stage cascade on the 16 VGA YUV frames at the default
    capacities, without re-dispatch: the launch counts are reset just
    before and read just after the counted batch. Returns K1's 299 px
    launches by (frames, boxes)."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    windows_cuda, windows_sched_cuda, windows_dyn_cuda, nms_cuda = _kernel_modules()
    det = cascade.CascadeDetector(model)
    _quietly(det.detect_batch_yuv420, frames)  # warm-up (cuDNN/cuBLAS plans)
    det.redispatches = 0
    torch.cuda.synchronize()
    _reset_launches()
    with _k1_launches_by_shape() as by_shape, _trunk_timer(torch) as trunk:
        t0 = time.perf_counter()
        results = _quietly(det.detect_batch_yuv420, frames)
        counted_s = time.perf_counter() - t0
    k1 = windows_cuda.LAUNCHES
    assert _at_299(by_shape) and sum(by_shape.values()) == k1, (by_shape, k1)
    assert windows_sched_cuda.LAUNCHES == windows_dyn_cuda.LAUNCHES == nms_cuda.LAUNCHES == 0
    for r in results:
        s = r.n_survivors_per_stage
        assert r.n_windows == VGA_WINDOWS and len(s) == 4 and s[0] >= s[1] >= s[2] >= s[3], s
        assert r.boxes.ndim == 2 and r.boxes.shape[1] == 4 and bool((r.boxes == r.boxes).all())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(det.detect_batch_yuv420, frames)
        walls.append(time.perf_counter() - t0)
    print("inception VGA: survivors per stage per frame {}".format(
        [r.n_survivors_per_stage for r in results]))
    print("inception VGA (4 stages, bf16, capacities {}, no re-dispatch): 16-frame batch "
          "{:.4f} s median of {} "
          "(counted {:.4f} s); re-dispatches {}; K1 launches by (frames, boxes, window size) "
          "{}; the trunk {} calls over {} rows, {:.3f} device ms; detections per frame {}; on "
          "{} [{}]".format(
              cascade.default_capacity_schedule(VGA_WINDOWS, 4),
              statistics.median(walls), [round(x, 4) for x in walls], counted_s,
              det.redispatches, dict(sorted(by_shape.items())), trunk["calls"], trunk["rows"],
              trunk["ms"], [len(r.boxes) for r in results], kind, card))
    return _at_299(by_shape)


@contextlib.contextmanager
def _first_inception_rows(rows):
    """The first call of an Inception stage on windows while the block
    runs: its parameters and configuration, and its first ``rows`` inputs
    (standardized windows and incoming bottlenecks) and outputs, copied.
    Yields that dict, filled when the block ends."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn

    real, seen = cnn.apply_stage, {}

    def spy(params, cfg, x, bottleneck_in=None, **kw):
        out = real(params, cfg, x, bottleneck_in, **kw)
        if cfg.backbone == "inception" and x.dim() == 4 and not seen:
            seen.update(params=params, cfg=cfg, x=x[:rows].clone(),
                        bneck=None if bottleneck_in is None else bottleneck_in[:rows].clone(),
                        **{k: out[k][:rows].clone() for k in ("logits", "probs")})
        return out

    cnn.apply_stage = spy
    try:
        yield seen
    finally:
        cnn.apply_stage = real


def _close(got, ref, rtol, atol):
    """(max |got - ref|, whether every value is within atol + rtol |ref|)."""
    diff = (got - ref).abs()
    return float(diff.max()), bool((diff <= atol + rtol * ref.abs()).all())


def _inception_card_vs_cpu(torch, model, frames):
    """29d. One frame on the card and on the CPU, the same model (bf16):
    survivor flips within the borderline share, the final boxes' deltas.
    Then the Inception stage's first INC_CMP_ROWS rows of the card run
    (real 299 px windows) again on the CPU: the trunk's embeddings in bf16
    (the detector's pre-cast weights) and in f32 with TF32 off (the
    masters), whose row-to-row part would show a trunk that ignored its
    input, and the stage's logits and probabilities before the threshold.
    Returns K1's 299 px launches by (frames, boxes) in the card run."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade, cnn, inception

    det = cascade.CascadeDetector(model)
    _reset_launches()
    with _k1_launches_by_shape() as by_shape, _first_inception_rows(INC_CMP_ROWS) as first:
        gpu = _quietly(det.detect_batch_yuv420, frames[:1])[0]
    assert sum(by_shape.values()) == _kernel_modules()[0].LAUNCHES, by_shape
    t0 = time.perf_counter()
    cpu = _quietly(cascade.CascadeDetector(model.to("cpu")).detect_batch_yuv420, frames[:1])[0]
    cpu_s = time.perf_counter() - t0
    flips, allowed, ids_cpu, ids_gpu = _flips(cpu, gpu)
    delta = None
    if len(cpu.boxes) == len(gpu.boxes) and len(cpu.boxes):
        delta = float(np.abs(np.asarray(_sorted_rows(cpu.boxes))
                             - np.asarray(_sorted_rows(gpu.boxes))).max())
    print("inception card vs cpu (bf16, 1 frame, cpu {:.2f} s): survivors cpu {} gpu {}, flips "
          "{} (allowed {:.1f}); final boxes cpu {} gpu {}, max |box delta| {}; survivors per "
          "stage cpu {} gpu {}".format(cpu_s, len(ids_cpu), len(ids_gpu), sorted(flips),
                                       allowed, len(cpu.boxes), len(gpu.boxes), delta,
                                       cpu.n_survivors_per_stage, gpu.n_survivors_per_stage))
    assert len(flips) <= allowed, flips

    cfg, x = first["cfg"], first["x"]
    on_cpu = cnn.tree_map(lambda t: t.cpu(), first["params"])
    masters = model.stage_params[-1]["backbone"]
    with torch.no_grad():
        bf_gpu = inception.apply_backbone(first["params"]["backbone"], x, dtype=cfg.compute_dtype)
        bf_cpu = inception.apply_backbone(on_cpu["backbone"], x.cpu(), dtype=cfg.compute_dtype)
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            f32_gpu = inception.apply_backbone(masters, x, dtype=torch.float32).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        f32_cpu = inception.apply_backbone(cnn.tree_map(lambda t: t.cpu(), masters), x.cpu(),
                                           dtype=torch.float32)
        # the stage on the CPU's embeddings: its head alone (2-D rows)
        out_cpu = cnn.apply_stage(on_cpu, cfg, bf_cpu,
                                  None if first["bneck"] is None else first["bneck"].cpu())
    bf_gpu = bf_gpu.cpu()
    bf_err, bf_ok = _close(bf_gpu, bf_cpu, INC_BF16_RTOL,
                           INC_BF16_ATOL_SHARE * float(bf_cpu.abs().max()))
    f32_err, f32_ok = _close(f32_gpu, f32_cpu, INC_F32_RTOL, INC_F32_ATOL)
    centred_gpu, centred_cpu = f32_gpu - f32_gpu.mean(0), f32_cpu - f32_cpu.mean(0)
    spread = float(centred_cpu.abs().max())
    centred_err = float((centred_gpu - centred_cpu).abs().max())
    logits_gpu, logits_cpu = first["logits"].cpu(), out_cpu["logits"]
    logit_err, logit_ok = _close(logits_gpu, logits_cpu, INC_BF16_RTOL,
                                 INC_BF16_ATOL_SHARE * float(logits_cpu.abs().max()))
    threshold = cascade.resolve_thresholds(model.n_nets)[-1]
    p_gpu, p_cpu = first["probs"].cpu()[:, 1], out_cpu["probs"][:, 1]
    decisions = int(((p_gpu > threshold) != (p_cpu > threshold)).sum())
    print("inception card vs cpu, the Inception stage's first {} rows of the card run: trunk "
          "bf16 max |diff| {:.6g} of max |f| {:.6g} (within 2% + 1% of max: {}); trunk f32 "
          "(TF32 off) max |diff| {:.6g} (within rtol {} atol {}: {}), its row-to-row part max "
          "|diff| {:.6g} of max {:.6g}; logits in [{:.6g}, {:.6g}], max |diff| {:.6g} (within "
          "2% + 1% of max: {}); face probabilities in [{:.6g}, {:.6g}], max |diff| {:.6g}, "
          "decisions at the stage's threshold {} that differ {}".format(
              len(x), bf_err, float(bf_cpu.abs().max()), bf_ok, f32_err, INC_F32_RTOL,
              INC_F32_ATOL, f32_ok, centred_err, spread, float(logits_cpu.min()),
              float(logits_cpu.max()), logit_err, logit_ok, float(p_cpu.min()),
              float(p_cpu.max()), float((p_gpu - p_cpu).abs().max()), threshold, decisions))
    assert bf_ok and f32_ok and logit_ok, (bf_err, f32_err, logit_err)
    assert centred_err <= INC_CENTRED_SHARE * spread, (centred_err, spread)
    assert decisions <= BORDERLINE_FRACTION * len(x), decisions
    return _at_299(by_shape)


def _inception_compact_steps(torch, device, provider, kind, card):
    """29e. The compact trunk trained end to end (no weights path),
    augmentation on at 299 px: s/step over INC_TRAIN_STEPS synchronised
    updates of the recipe's batch, on the first INC_COMPACT_SAMPLES of the
    299 px corpus (their standardization statistics alone)."""
    import math

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data.dataset import Dataset
    from rapidobjectdetectionusingcascadedcnns_torch.data.preprocessor import Preprocessor
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step
    from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import SingleNetTrainer

    cf.set("inception_weights_path", None)
    images = provider._images[299][:INC_COMPACT_SAMPLES]
    ds = Dataset(images, provider._labels[:INC_COMPACT_SAMPLES], cf.get("dataset_split"),
                 Preprocessor(images, standardization=cf.get("standardization")),
                 name="compact_299px")
    st = SingleNetTrainer(ds, use_inception=True, seed=0, device=device)
    assert not st._frozen_trunk and st._augment is not None
    batch = st.ds.train.new_default_iterator(cf.get("batch_size"), seed=0).next_batch
    images = torch.as_tensor(batch.images, device=device)
    labels = torch.as_tensor(batch.labels, device=device).long()

    def step():
        return train_step.train_step(st.state, st.stage_config, st._loss_settings, st._augment,
                                     images, labels, None, st._mean, st._std, st._host_gen,
                                     st._device_gen)

    first = float(step())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(INC_TRAIN_STEPS):
        loss = step()
        torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / INC_TRAIN_STEPS
    assert math.isfinite(first) and math.isfinite(float(loss))
    print("inception compact trunk trained end to end with augmentation: batch {} at 299 px, "
          "{:.6f} s/step over {} synchronised updates, loss {:.6f} -> {:.6f}; on {} [{}]".format(
              len(labels), s_step, INC_TRAIN_STEPS, first, float(loss), kind, card))


def _inception_bundle(torch, model, frames, kind, card):
    """29f. A static bundle of the Inception cascade (YUV, one frame a
    call, one rung at the default capacities, which truncate as the live
    detector does without re-dispatch), saved, loaded and served: equal
    to the live detector at one frame a call. The launch counts are reset
    just before and read just after the served frames. Returns K1's 299 px
    launches by (frames, boxes) in them."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    caps = cascade.default_capacity_schedule(VGA_WINDOWS, 4)
    cf.set("inference_batch_frames", 1)
    work = tempfile.mkdtemp(prefix="chip_smoke_inception_")
    try:
        live = _quietly(cascade.CascadeDetector(model, capacity_schedule=caps)
                        .detect_batch_yuv420, frames[:2])
        t0 = time.perf_counter()
        bundle = serve.export_detector(model, IMG_H, IMG_W, batch=1, yuv=True, capacities=caps,
                                       n_rungs=1)
        export_s = time.perf_counter() - t0
        serve.save_bundle(bundle, work)
        t0 = time.perf_counter()
        served_det = serve.load_bundle(work)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _reset_launches()
        with _k1_launches_by_shape() as by_shape:
            served = _quietly(served_det.detect_batch, frames[:2])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert sum(by_shape.values()) == _kernel_modules()[0].LAUNCHES and _at_299(by_shape), by_shape
    for a, b in zip(live, served):
        np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
        np.testing.assert_array_equal(a.raw_confidences, b.raw_confidences)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        assert a.n_survivors_per_stage == b.n_survivors_per_stage
    assert bundle.meta["trunks"] == [None, None, None, "v3"], bundle.meta["trunks"]
    print("inception bundle (static, YUV, 1 frame a call, capacities {}, 1 rung): export {:.2f} "
          "s, load {:.2f} s; 2 frames served equal to the live detector (survivors {}), K1 "
          "launches by (frames, boxes, window size) {}; on {} [{}]".format(
              caps, export_s, load_s, [r.n_survivors_per_stage for r in served],
              dict(sorted(by_shape.items())), kind, card))
    return _at_299(by_shape)


def phase_inception(torch, device, frames, kind, card):
    """29. The appended Inception stage (ROADMAP Queue A item 7) on the
    card: phase 18's cut recipe trained with ``append_inception`` on the
    v3 fixture archive (frozen trunk, embed-once), the 4-stage cascade
    detecting the 16 VGA frames, card against CPU, the compact trunk
    trained end to end, a static bundle against the live detector, and K1
    at 299 px (banded) against its plain version at every shape those runs
    launched it at. Returns one ``(label, launches, measurement)`` for K1
    per 299 px shape."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade, inception_v3
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda

    t_phase = time.perf_counter()
    tool = _load_tool("train_torch_flagship")
    saved = cf.snapshot()
    work = tempfile.mkdtemp(prefix="chip_smoke_v3_")
    try:
        archive = work + "/inception_v3_fixture.npz"
        t0 = time.perf_counter()
        params = inception_v3.convert_torchvision_state_dict(inception_v3.random_state_dict(3))
        inception_v3.save_npz(archive, params)
        print("inception: the v3 fixture archive ({} convs, {} parameters, random_state_dict(3) "
              "converted) in {:.2f} s".format(len(params), inception_v3.n_params(params),
                                              time.perf_counter() - t0))
        model, trainer, provider = _inception_train(torch, device, tool, archive, kind, card)
        for key, value in INC_SETTINGS.items():
            cf.set(key, value)
        batch_shapes = _inception_detect(torch, model, frames, kind, card)
        one_frame = _inception_card_vs_cpu(torch, model, frames)
        _inception_compact_steps(torch, device, provider, kind, card)
        del trainer, provider
        torch.cuda.empty_cache()
        for shape, n in _inception_bundle(torch, model, frames, kind, card).items():
            one_frame[shape] = one_frame.get(shape, 0) + n
        # K1 against its plain version at every 299 px shape launched above
        # (each entry with its own launches), then at the extra shapes
        planes, coords = vga_k1_inputs(torch, device, cascade.CascadeDetector(model), frames)
        per_block, band, smem = windows_cuda.launch_geometry(299, 299, 3)
        shapes = [(s, n, "16-frame detection batch") for s, n in sorted(batch_shapes.items())]
        shapes += [(s, n, "one-frame calls: the card-vs-CPU run and 2 bundle frames")
                   for s, n in sorted(one_frame.items())]
        shapes += [(s, 0, "an extra shape, not launched on the path")
                   for s in INC_K1_EXTRA_SHAPES if s not in batch_shapes and s not in one_frame]
        holds = []
        for (n_frames, n_boxes), launches, what in shapes:
            m = phase_k1(torch, "Inception, {}".format(what), planes[:n_frames].contiguous(),
                         coords, {299: n_boxes})
            holds.append(("{} frame(s) x {} boxes at 299 px, {}; banded: {} rows a block, {} "
                          "B shared".format(n_frames, n_boxes, what, band, smem), launches, m))
        _inception_k1_big(torch, planes, coords)
        del planes
    finally:
        cf.restore(saved)
        shutil.rmtree(work, ignore_errors=True)
    print("phase 29: {:.1f} s".format(time.perf_counter() - t_phase))
    return holds


MESH_TRAIN = dict(n_pos=1600, n_neg=3200, size=24, batch=1200)  # 4 ragged steps an epoch


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spied_launches(run, k1_inputs=None):
    """``run()`` with K1 and K2 counted by launch shape; returns (its
    result, (launches of K1, K2, K4, K3), K1 by shape, K2 by shape). Fails
    if a launch escaped the spies. ``k1_inputs``: as
    :func:`_k1_launches_by_shape`'s ``inputs``."""
    _reset_launches()
    with _k1_launches_by_shape(k1_inputs) as k1_shapes, _k2_launches_by_shape() as k2_shapes:
        out = run()
    launches = tuple(m.LAUNCHES for m in _kernel_modules())
    assert sum(k1_shapes.values()) == launches[0], (k1_shapes, launches)
    assert sum(k2_shapes.values()) == launches[1], (k2_shapes, launches)
    return out, launches, dict(k1_shapes), dict(k2_shapes)


def _mesh_frames(torch, model, mesh, caps, frames, kind, card, label):
    """30a/30c. The 16 VGA YUV frames through a frame-sharded detector
    against the single-device one at ``caps``: flips as phase 18 counts
    them, the launches of the counted sharded batch, the walls, and the
    shards' and the gather's part of one chunk. Returns (K1's launches by
    shape, K2's by frames) of the counted batch."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.parallel import mesh as mesh_mod

    single = cascade.CascadeDetector(model, capacity_schedule=caps)
    sharded = cascade.CascadeDetector(model, capacity_schedule=caps, mesh=mesh)
    ref = _quietly(single.detect_batch_yuv420, frames)
    _quietly(sharded.detect_batch_yuv420, frames)  # warm-up
    sharded.redispatches = 0
    torch.cuda.synchronize()
    got, launches, k1_shapes, k2_shapes = _spied_launches(
        lambda: _quietly(sharded.detect_batch_yuv420, frames))
    k2_frames = {}
    for (n_frames, _, _), n in k2_shapes.items():
        k2_frames[n_frames] = k2_frames.get(n_frames, 0) + n
    pairs = [_flips(a, b) for a, b in zip(got, ref)]
    n_flips = sum(len(p[0]) for p in pairs)
    survivors = sum(len(p[2] | p[3]) for p in pairs)
    assert n_flips <= BORDERLINE_FRACTION * max(survivors, 1), [len(p[0]) for p in pairs]
    same_boxes = sum(
        sorted(map(tuple, a.boxes.tolist())) == sorted(map(tuple, b.boxes.tolist()))
        for a, b in zip(got, ref))
    walls = {}
    for name, det in (("single", single), ("sharded", sharded)):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _quietly(det.detect_batch_yuv420, frames)
            runs.append(time.perf_counter() - t0)
        walls[name] = statistics.median(runs)
    # one chunk's parts: both shards enqueued and finished, then the gather
    entry = sharded._plan_and_table(IMG_H, IMG_W)
    rows = mesh_mod.split_rows(len(frames), mesh)
    shard_ms, gather_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [sharded._run_shard(frames[r], True, caps, entry, None, k)
                 for k, r in enumerate(rows)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mesh_mod.gather(mesh, parts)
        torch.cuda.synchronize()
        shard_ms.append((t1 - t0) * 1e3)
        gather_ms.append((time.perf_counter() - t1) * 1e3)
    s_ms, g_ms = statistics.median(shard_ms), statistics.median(gather_ms)
    print("mesh ({}): frame-sharded over {} vs one device at capacities {}: flips {} of {} "
          "survivors (allowed {:.1f}), NMS boxes equal in {} of {} frames; survivors per stage "
          "sharded {} single {}; launches K1 {} K2 {} K4 {} K3 {}, re-dispatches {} in the "
          "counted batch; K1 launches by (frames, boxes, px) {}, K2 by frames {}; 16-frame "
          "batch {:.4f} s sharded vs {:.4f} s single (median of 3); one chunk: shards {:.3f} "
          "ms, gather {:.3f} ms ({:.2%} of the chunk); on {} [{}]".format(
              label, mesh, caps, n_flips, survivors, BORDERLINE_FRACTION * survivors,
              same_boxes, len(got), [r.n_survivors_per_stage for r in got[:4]],
              [r.n_survivors_per_stage for r in ref[:4]], *launches, sharded.redispatches,
              k1_shapes, k2_frames, walls["sharded"], walls["single"], s_ms, g_ms,
              g_ms / (s_ms + g_ms), kind, card))
    return k1_shapes, k2_frames


def _mesh_window_sharded(torch, model, mesh, frame, kind, card):
    """30b. One dense 450x450 frame at scale factor 1.005 with its windows
    split over the mesh, in crop and in gather mode, against ``detect``:
    survivor sets and NMS boxes, the launches of the counted runs and the
    walls. Returns {mode: K1's launches by shape in its counted run}."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.parallel import window_shard

    # enough retries to reach the open rung: a truncated result depends on
    # the stage-0 order, which is K2's scheduled order on one device and the
    # plan's order on the window-sharded path (as in phase 9)
    caps, rungs = cascade.default_capacity_schedule(DENSE_WINDOWS, model.n_nets), 0
    while caps is not None:
        caps = cascade.escalate_capacities(caps, DENSE_WINDOWS)
        rungs += caps is not None
    cf.set("cascade_saturation_max_retries", rungs)
    det = cascade.CascadeDetector(model)
    k1 = {}
    for mode in ("crop", "gather"):
        cf.set("window_extraction_mode", mode)
        ref = _quietly(det.detect, frame)
        _quietly(window_shard.detect_window_sharded, det, frame, mesh)  # warm-up
        torch.cuda.synchronize()
        det.redispatches = 0
        t0 = time.perf_counter()
        got, launches, k1[mode], _ = _spied_launches(
            lambda: _quietly(window_shard.detect_window_sharded, det, frame, mesh))
        sharded_s = time.perf_counter() - t0
        assert launches[1:] == (0, 0, 0), launches  # K1 only on shard-local boxes
        flips, allowed, _, _ = _flips(got, ref)
        assert len(flips) <= allowed, (mode, len(flips), sorted(flips)[:20])
        same = sorted(map(tuple, got.boxes.tolist())) == sorted(map(tuple, ref.boxes.tolist()))
        assert same or flips, mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _quietly(det.detect, frame)
        single_s = time.perf_counter() - t0
        print("mesh: window-sharded dense frame ({} mode, {} windows) over {}: survivors per "
              "stage {} vs detect {}, flips {} (allowed {:.1f}), NMS boxes equal {}; launches "
              "K1 {} K2 {} K4 {} K3 {}, re-dispatches {}; K1 launches by (frames, boxes, px) "
              "{}; {:.4f} s (spied) vs detect {:.4f} s; on {} [{}]".format(
                  mode, got.n_windows, mesh, got.n_survivors_per_stage,
                  ref.n_survivors_per_stage, len(flips), allowed, same, *launches,
                  det.redispatches, k1[mode], sharded_s, single_s, kind, card))
    cf.set("window_extraction_mode", "auto")
    return k1


def _mesh_training(torch, mesh, kind, card):
    """30d. A few data-parallel steps of the 24 px stage at the reference
    default width (conv [32], fc1 512) in f32 with TF32 off, online
    augmentation and dropout 0.5, over the mesh against one device from
    the same seed: losses and parameters."""
    import numpy as np

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step
    from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import SingleNetTrainer
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for key, value in (("batch_size", MESH_TRAIN["batch"]), ("epochs_total", 1),
                       ("compute_dtype", "float32"), ("data_augmentation_online", True),
                       ("dropout_rate", 0.5), ("n_max_constant_evals", None)):
        cf.set(key, value)
    size = MESH_TRAIN["size"]
    t0 = time.perf_counter()
    ds = ct.SyntheticProvider(MESH_TRAIN["n_pos"], MESH_TRAIN["n_neg"], [size], seed=0).dataset(size)
    corpus_s = time.perf_counter() - t0
    log.set_echo(False)
    try:
        runs = {}
        for name, kwargs in (("mesh", {"mesh": mesh}), ("single", {"device": mesh[0]})):
            trainer = SingleNetTrainer(ds, f_beta=None, seed=0, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            runs[name] = (trainer, time.perf_counter() - t0)
    finally:
        log.set_echo(True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (tm, mesh_s), (ts, single_s) = runs["mesh"], runs["single"]
    lm, ls = tm.losses(), ts.losses()
    assert lm.shape == ls.shape and len(lm) >= 2, (lm.shape, ls.shape)
    np.testing.assert_allclose(lm, ls, rtol=1e-4)
    param_err = 0.0
    for a, b in zip(train_step.param_leaves(tm.state.params),
                    train_step.param_leaves(ts.state.params)):
        x, y = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-2, atol=1e-4)
        param_err = max(param_err, float(np.max(np.abs(x - y))))
    print("mesh training ({} px, conv {}, fc1 {}, f32 TF32 off, augmentation, dropout 0.5, "
          "batch {} over {}): {} steps, losses mesh {} single {}, max |loss diff| {:.3g}, max "
          "|param diff| {:.3g}; {:.2f} s vs {:.2f} s (corpus {:.2f} s on the host); on {} "
          "[{}]".format(size, cf.get("conv_filter_sizes"), cf.get("fc1_size"),
                        MESH_TRAIN["batch"], mesh, len(lm), np.round(lm, 5).tolist(),
                        np.round(ls, 5).tolist(), float(np.max(np.abs(lm - ls))), param_err,
                        mesh_s, single_s, corpus_s, kind, card))


def _mesh_multihost(torch, device, kind, card):
    """30e. ``multihost.initialize`` from the standard environment with NCCL
    at world size 1, and the rehearsal in the group against the rehearsal
    without one."""
    import os

    import torch.distributed as dist

    from rapidobjectdetectionusingcascadedcnns_torch.parallel import multihost

    alone = multihost.rehearsal(device=device)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "RANK": "0",
           "WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        assert multihost.initialize(device=device)
        init_s = time.perf_counter() - t0
        backend = dist.get_backend()
        grouped = multihost.rehearsal()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert backend == "nccl", backend
    assert grouped["eval_total"] == alone["eval_total"] == 32
    assert abs(grouped["loss"] - alone["loss"]) <= 2e-6 * abs(alone["loss"]), (grouped, alone)
    print("mesh multihost: initialize ({}, world size 1) {:.2f} s; rehearsal loss {} in the "
          "group, {} alone, eval total {}; on {} [{}]".format(
              backend, init_s, grouped["loss"], alone["loss"], grouped["eval_total"], kind, card))


def _mesh_bundle(torch, model, mesh, caps, frames, kind, card):
    """30f. A frame-sharded static bundle of the flagship's VGA YUV program
    (16 frames a call, 8 a shard, 1 rung), saved, loaded with the mesh and
    serving the 16 frames equal to the live frame-sharded detector; both
    with re-dispatch off, so a frame that saturates the one rung is
    truncated alike (rank compaction). Returns K1's launches by shape in
    the served call."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

    cf.set("cascade_saturation_redispatch", False)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        bundle = serve.export_detector(model, IMG_H, IMG_W, batch=N_FRAMES, yuv=True,
                                       capacities=caps, n_rungs=1, mesh=mesh)
        export_s = time.perf_counter() - t0
        serve.save_bundle(bundle, work)
        t0 = time.perf_counter()
        served_det = serve.load_bundle(work, mesh=mesh)
        load_s = time.perf_counter() - t0
        served, launches, k1_shapes, _ = _spied_launches(
            lambda: _quietly(served_det.detect_batch, frames))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    live = _quietly(cascade.CascadeDetector(model, capacity_schedule=caps,
                                            mesh=mesh).detect_batch_yuv420, frames)
    for a, b in zip(served, live):
        flips, allowed, _, _ = _flips(a, b)
        assert not flips and a.n_survivors_per_stage == b.n_survivors_per_stage, (
            sorted(flips)[:20], a.n_survivors_per_stage, b.n_survivors_per_stage)
        assert sorted(map(tuple, a.boxes.tolist())) == sorted(map(tuple, b.boxes.tolist()))
    print("mesh bundle (static, YUV, {} frames a call over {}: programs of {}, capacities {}, 1 "
          "rung): export {:.2f} s, load {:.2f} s; 16 frames served equal to the live "
          "frame-sharded detector; launches K1 {} K2 {} K4 {} K3 {}; on {} [{}]".format(
              len(frames), mesh, bundle.meta["max_batch"], caps, export_s, load_s, *launches,
              kind, card))
    return k1_shapes


def _mesh_window_bundle(torch, model, mesh, frame, kind, card):
    """30g. A window-sharded bundle of the dense frame's cascade (crop mode,
    the default capacities, 1 rung), saved, loaded with the mesh and
    serving the frame equal to the live window-sharded detection, both
    with re-dispatch off (rank compaction alike). Returns K1's launches by
    shape in the counted served call."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.parallel import window_shard

    cf.set("window_extraction_mode", "crop")
    cf.set("cascade_saturation_redispatch", False)
    work = tempfile.mkdtemp(prefix="chip_smoke_window_bundle_")
    try:
        t0 = time.perf_counter()
        bundle = serve.export_window_sharded(model, *DENSE_HW, mesh, n_rungs=1)
        export_s = time.perf_counter() - t0
        serve.save_bundle(bundle, work)
        t0 = time.perf_counter()
        served_det = serve.load_bundle(work, mesh=mesh)
        load_s = time.perf_counter() - t0
        _quietly(served_det.detect, frame)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served, launches, k1_shapes, _ = _spied_launches(
            lambda: _quietly(served_det.detect, frame))
        served_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    live = _quietly(window_shard.detect_window_sharded, cascade.CascadeDetector(model), frame,
                    mesh)
    flips, _, _, _ = _flips(served, live)
    assert not flips and served.n_survivors_per_stage == live.n_survivors_per_stage, (
        sorted(flips)[:20], served.n_survivors_per_stage, live.n_survivors_per_stage)
    assert sorted(map(tuple, served.boxes.tolist())) == sorted(map(tuple, live.boxes.tolist()))
    assert launches[0] >= 2 * mesh.size and launches[1:] == (0, 0, 0), launches
    print("mesh window-sharded bundle ({}x{} at {}, crop mode, capacities {}, 1 rung, {} "
          "programs over {}): export {:.2f} s, load {:.2f} s; served equal to the live "
          "window-sharded detection (survivors {}) in {:.4f} s (spied); launches K1 {} K2 {} K4 {} K3 "
          "{}; on {} [{}]".format(DENSE_HW[0], DENSE_HW[1], DENSE_WSF,
                                  bundle.meta["capacity_rungs"][0], len(bundle.programs), mesh,
                                  export_s, load_s, served.n_survivors_per_stage, served_s,
                                  *launches, kind, card))
    return k1_shapes


def _mesh_holds(torch, device, mesh, model, frames, dense, k1_runs, k2_runs):
    """K1 and K2 against their plain versions at every shape phase 30's
    counted runs launched them at, on the frames those runs read: one
    ``kernels`` entry per shape, with its launches summed over the runs
    that launched it. ``k1_runs``: {(image, frames, boxes, px): [launches,
    runs]}; ``k2_runs``: {frames: [launches, runs]}."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows_sched

    inputs = {"VGA": vga_k1_inputs(torch, device, cascade.CascadeDetector(model), frames),
              "dense": dense_k1_inputs(torch, device, dense[:1])}
    holds = []
    for (image, n_frames, n_boxes, size), (launches, runs) in sorted(k1_runs.items()):
        planes, coords = inputs[image]
        what = "{} {} frame(s) x {} boxes at {} px".format(image, n_frames, n_boxes, size)
        m = phase_k1(torch, "mesh shard, " + what, planes[:n_frames].contiguous(), coords,
                     {size: n_boxes})
        holds.append(("K1 crop_and_resize (flagship over {}: {}; launched by {})".format(
            mesh, what, ", ".join(runs)), "resample.cu", "ops/windows_pallas.py:63",
            launches, m))
    plan = pyramid.build_plan(IMG_H, IMG_W, 12, 12, 0.075, 1.1)
    sched = windows_sched.schedule_for_plan(plan, 12, 12)
    for n_frames, (launches, runs) in sorted(k2_runs.items()):
        m = _k2_hold(torch, inputs["VGA"][0][:n_frames].contiguous(), plan, sched,
                     "mesh shard, VGA {} frame(s)".format(n_frames))
        holds.append(("K2 scheduled stage-0 extraction (flagship over {}: VGA {} frame(s) a "
                      "shard; launched by {})".format(mesh, n_frames, ", ".join(runs)),
                      "sched.cu", "ops/windows_sched.py:259", launches, m))
    return holds


def phase_meshes(torch, device, flagship, frames, dense, kind, card):
    """30. Meshes on the card: a 2-shard mesh (cuda:0, cuda:0) with phase
    18's flagship at its operating point. Returns the ``kernels`` entries
    of K1 and K2, one per shard-local shape its runs launched."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    saved = cf.snapshot()
    mesh = mesh_mod.get_mesh(devices=(device, device))
    model, caps = flagship["model"], flagship["caps"]
    k1_runs, k2_runs = {}, {}

    def add(runs, by_key, run):
        for key, n in by_key.items():
            if n:
                entry = runs.setdefault(key, [0, []])
                entry[0] += n
                entry[1].append(run)

    def on(image, by_shape):
        return {(image,) + shape: n for shape, n in by_shape.items()}

    try:
        _flagship_settings(cf)
        cf.set("nms_on_device", False)  # host NMS, as phase 18c
        # 30a. frame-sharded gather mode (K1 re-extracts on each shard)
        k1, _ = _mesh_frames(torch, model, mesh, caps, frames, kind, card, "gather mode")
        add(k1_runs, on("VGA", k1), "the frame-sharded gather-mode batch")
        # 30c. frame-sharded crop mode: K2 per shard over the full plan's schedule
        cf.set("window_extraction_mode", "crop")
        k1, k2 = _mesh_frames(torch, model, mesh, caps, frames, kind, card, "crop mode")
        cf.set("window_extraction_mode", "auto")
        n_k2 = sum(k2.values())
        assert n_k2 >= mesh.size and n_k2 % mesh.size == 0, k2  # one a shard a dispatch
        add(k1_runs, on("VGA", k1), "the frame-sharded crop-mode batch")
        add(k2_runs, k2, "the frame-sharded crop-mode batch")
        # 30b. one dense frame's windows over the mesh, and its bundle
        cf.set("window_scale_factor", DENSE_WSF)
        for mode, k1 in _mesh_window_sharded(torch, model, mesh, dense[0], kind, card).items():
            add(k1_runs, on("dense", k1), "the window-sharded {}-mode run".format(mode))
        add(k1_runs, on("dense", _mesh_window_bundle(torch, model, mesh, dense[0], kind, card)),
            "the window-sharded bundle")
        cf.set("window_scale_factor", 1.1)
        cf.set("window_extraction_mode", "auto")
        cf.set("cascade_saturation_redispatch", True)
        torch.cuda.empty_cache()
        # 30d-f. training, the process group, a frame-sharded bundle
        _mesh_training(torch, mesh, kind, card)
    finally:
        cf.restore(saved)
    saved = cf.snapshot()
    try:
        _flagship_settings(cf)
        cf.set("nms_on_device", False)
        _mesh_multihost(torch, device, kind, card)
        add(k1_runs, on("VGA", _mesh_bundle(torch, model, mesh, caps, frames, kind, card)),
            "the frame-sharded bundle")
        torch.cuda.empty_cache()
        holds = _mesh_holds(torch, device, mesh, model, frames, dense, k1_runs, k2_runs)
    finally:
        cf.restore(saved)
    print("mesh: unverified on this one-card host: NCCL collectives across two cards, and two "
          "cards' shards overlapping")
    print("phase 30: {:.1f} s".format(time.perf_counter() - t_phase))
    return holds

GRID = ((0.3, 0.5, 0.7), (0, 1), 20)  # thresholds, min_neighbors, scenes of phase 31's grid
SWEEP_REPS = 1  # passes of phase 31's density sweep (the tool's default 3)
BUCKET_FOLDS = 1  # folds of phase 31's bucketing delta (the tool's default 4)
PROFILE_ITERS = 5  # calls a point of phase 31's profiles


def _tool_run(label, run, k1_runs):
    """``run()`` with its stdout captured and its launches counted (K1 and
    K2 by launch shape); prints the wall and the launches. Adds K1's
    launches and the first inputs at each (frames, boxes, px, height,
    width) to ``k1_runs`` ({key: [launches, planes, sy, sx, [labels]]}).
    Returns (its result, K2's launches by (frames, slots, px))."""
    import torch

    t0 = time.perf_counter()
    seen = {}
    out, launches, k1_shapes, k2_shapes = _spied_launches(lambda: _quietly(run), seen)
    torch.cuda.synchronize()
    for key, (n, planes, sy, sx) in seen.items():
        entry = k1_runs.setdefault(key, [0, planes, sy, sx, []])
        entry[0] += n
        entry[4].append(label)
    print("phase 31 {}: {:.2f} s; launches K1 {} K2 {} K4 {} K3 {}; K1 by (frames, boxes, "
          "px) {}; K2 by (frames, slots, px) {}".format(
              label, time.perf_counter() - t0, *launches, k1_shapes, k2_shapes))
    return out, k2_shapes


def _tool_k1_holds(torch, k1_runs):
    """K1 against its plain version at every shape phase 31's tools
    launched it at, on the inputs of the first launch at that shape: the
    kwargs of one ``kernels`` entry each, with its launches summed over the
    tools that launched it."""
    holds = []
    for key in sorted(k1_runs):
        n_frames, n_boxes, px, img_h, img_w = key
        launches, planes, sy, sx, labels = k1_runs.pop(key)
        what = "{} frame(s) of {}x{} x {} boxes at {} px".format(
            n_frames, img_h, img_w, n_boxes, px)
        m = _k1_hold(torch, "analysis tools, " + what, planes, sy, sx)
        holds.append(("K1 crop_and_resize (analysis tools: {}; launched by {})".format(
            what, ", ".join(labels)), "resample.cu", "ops/windows_pallas.py:63", launches, m))
        del planes, sy, sx
    torch.cuda.empty_cache()
    return holds


def _sweep_k2_holds(torch, sweep_tool, k2_shapes):
    """K2 against its plain version at every shape the density sweep
    launched it at, on the frames of the sweep's first batch of that
    shape: the kwargs of one ``kernels`` entry each."""
    import numpy as np
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows, windows_sched

    holds = []
    for (n_frames, n_slots, px), launches in sorted(k2_shapes.items()):
        for wsf in sweep_tool.DENSITIES:
            plan = pyramid.build_plan(IMG_H, IMG_W, px, px, 0.075, wsf)
            sched = windows_sched.schedule_for_plan(plan, px, px)
            if sched is not None and sched.n_slots == n_slots:
                break
        else:
            raise AssertionError("no sweep plan has {} slots at {} px".format(n_slots, px))
        images = np.stack([synthetic.make_scene(IMG_H, IMG_W, n_faces=3, seed=100 + s,
                                                min_face=48, max_face=120).image
                           for s in range(n_frames)])
        planes = windows.to_planes_bf16(torch.as_tensor(images, device="cuda").float())
        family = "single 48 px net" if px == 48 else "flagship cascade"
        m = _k2_hold(torch, planes, plan, sched, "density sweep, {}, VGA at {}".format(
            family, wsf))
        holds.append(("K2 scheduled stage-0 extraction ({}, density sweep: VGA at {}, {} frames "
                      "x {} slots at {} px)".format(family, wsf, n_frames, n_slots, px),
                      "sched.cu", "ops/windows_sched.py:259", launches, m))
        del planes
        torch.cuda.empty_cache()
    return holds


def phase_analysis_tools(torch, flagship, corpus_dir, kind, card):
    """31. The analysis tools in process on phase 18's cut flagship. Returns
    the ``kernels`` entries of K2 at every shape the density sweep launched
    it at and of K1 at every shape the tools launched it at."""
    import numpy as np
    import os

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.models.single import SingleNetDetector
    from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint

    t_phase = time.perf_counter()
    model, caps = flagship["model"], flagship["caps"]
    points_tool = _load_tool("operating_torch_points")
    sweep_tool = _load_tool("runtime_torch_density_sweep")
    delta_tool = _load_tool("fddb_torch_bucketing_delta")
    roc_tool = _load_tool("fddb_torch_roc")
    batch_tool = _load_tool("profile_torch_batch")
    cnn_tool = _load_tool("profile_torch_cnn")
    saved = cf.snapshot()
    k1_runs = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        _flagship_settings(cf)
        cf.set("nms_on_device", False)  # host NMS, as the tools run

        # 31a. the operating-point grid
        thresholds, min_neighbors, n_scenes = GRID
        grid, _ = _tool_run("operating-point grid", lambda: points_tool.operating_points(
            model, thresholds, min_neighbors, n_scenes), k1_runs)
        points = grid["points"]
        assert [(p["min_neighbors"], p["threshold"]) for p in points] == [
            (mn, thr) for mn in min_neighbors for thr in thresholds]
        assert grid["headline"] == points_tool.headline(points)
        print("grid ({} scenes): {}; headline {}".format(n_scenes, [
            (p["threshold"], p["min_neighbors"], p["recall"], p["false_pos_per_scene"])
            for p in points], grid["headline"] and (
            grid["headline"]["threshold"], grid["headline"]["min_neighbors"],
            grid["headline"]["recall"], grid["headline"]["false_pos_per_scene"])))

        # 31b. the density sweep's --quick, a 48 px single net of fresh weights
        recipe_convs = cf.get("conv_filter_sizes")
        cf.set("conv_filter_sizes", [32])  # the flagship's 48 px architecture, as phase 20
        scfg = cnn.StageConfig.from_config(48, bottleneck_in_size=None)
        cf.set("conv_filter_sizes", recipe_convs)
        single = SingleNetDetector(
            cnn.init_stage(scfg, torch.Generator().manual_seed(0)), scfg,
            np.full((48, 48, 3), 127.5, np.float32), np.full((48, 48, 3), 64.0, np.float32),
            "cuda")
        sweep, k2_sweep = _tool_run("density sweep --quick", lambda: sweep_tool.density_sweep(
            model, single, FLAG_THRESHOLD, sizes=sweep_tool.SIZES[:1],
            densities=sweep_tool.DENSITIES[:2], reps=SWEEP_REPS), k1_runs)
        at_48 = {shape: n for shape, n in k2_sweep.items() if shape[2] == 48}
        assert sum(at_48.values()) >= 1, k2_sweep
        for key, entry in sweep.items():
            for family in ("cascade", "single"):
                e = entry[family]
                assert e["fps"] > 0 and len(e["rates"]) == SWEEP_REPS, (key, family, e)
            print("sweep {}: cascade {:.2f} fps (rates {}, windows {}, {}, capacities {}, "
                  "survivors max {}, saturated {}), single {:.2f} fps (rates {}, windows {}, "
                  "slots {}, {}, chunk {}, survivors max {}), speedup {:.3f}; launches "
                  "(calls) cascade {} ({}), single {} ({})".format(
                      key, entry["cascade"]["fps"], entry["cascade"]["rates"],
                      entry["cascade"]["n_windows"], entry["cascade"]["extraction_mode"],
                      entry["cascade"]["capacities"], entry["cascade"]["survivors_max"],
                      entry["cascade"]["saturated"], entry["single"]["fps"],
                      entry["single"]["rates"], entry["single"]["n_windows"],
                      entry["single"]["n_slots"], entry["single"]["extraction_mode"],
                      entry["single"]["window_chunk"], entry["single"]["survivors_max"],
                      entry["speedup_cascade_vs_single"], entry["cascade"]["launches"],
                      entry["cascade"]["calls"], entry["single"]["launches"],
                      entry["single"]["calls"]))
        dense_single = sweep["480x640@wsf1.02"]["single"]
        assert dense_single["extraction_mode"] == "crop" and dense_single["window_chunk"] == 1024
        print("sweep: host NMS with native.available() {}; on {} [{}]".format(
            _native(), kind, card))
        del single
        torch.cuda.empty_cache()
        holds = _sweep_k2_holds(torch, sweep_tool, k2_sweep)

        # 31c. the bucketing delta
        delta, _ = _tool_run("bucketing delta", lambda: delta_tool.bucketing_delta(
            model, folds=BUCKET_FOLDS), k1_runs)
        for mode in ("exact", "bucketed"):
            assert delta[mode]["n_images"] == 2 * BUCKET_FOLDS, delta
        print("bucketing delta ({} fold(s), buckets {}): {}".format(
            BUCKET_FOLDS, delta["buckets"], json.dumps(
                {k: delta[k] for k in ("exact", "bucketed", "recall_delta")})))

        # 31d. the ROC tool's --reference-default on phase 19's corpus
        cf.restore(saved)
        assert roc_tool.corpus_ready(corpus_dir), corpus_dir  # reused, not synthesized
        checkpoint.save_cascade(os.path.join(work, "models"), "flagship", model)
        out = os.path.join(work, "roc_default.json")
        _tool_run("ROC --reference-default", lambda: roc_tool.main([
            "--checkpoint", os.path.join(work, "models", "model_flagship"),
            "--reference-default", "--corpus-dir", corpus_dir, "--out", out]), k1_runs)
        with open(out) as f:
            roc = json.load(f)
        config = roc["config"]
        assert roc["roc"] and config["reference_default"] and config["resize_buckets"] is None
        assert (config["thresholds"], config["min_neighbors"]) == (0.5, 1), config
        assert config["n_images"] == 10 * FDDB_IMGS_PER_FOLD, config
        end = roc["roc"][-1]
        print("ROC --reference-default on phase 19's corpus: {} images, {:.4f} s an image, "
              "{} faces, detection rate {:.4f} discrete / {:.4f} continuous at {} false "
              "positives; re-dispatches {}, launches {}".format(
                  config["n_images"], config["secs_per_image"], roc["n_faces"],
                  end["detection_rate"], end["detection_rate_continuous"],
                  end["false_positives"], config["redispatches"], config["kernel_launches"]))

        # 31e. the profiles, at one size each
        cf.restore(saved)
        _flagship_settings(cf)
        cf.set("nms_on_device", False)
        slope, _ = _tool_run("batch profile", lambda: batch_tool.batch_slope(
            model, caps, iters=PROFILE_ITERS), k1_runs)
        assert slope["slope_ms_per_frame"] > 0, slope
        print("batch profile (VGA YUV, capacities {}): {}; slope {:.4f} ms a frame, "
              "intercept {:.4f} ms a call".format(
                  caps, [(p["frames"], round(p["ms"], 4)) for p in slope["points"]],
                  slope["slope_ms_per_frame"], slope["intercept_ms"]))
        parts, _ = _tool_run("stage-0 CNN profile", lambda: cnn_tool.stage_parts(
            model, DENSE_WINDOWS, 16384, iters=PROFILE_ITERS), k1_runs)
        assert all(v > 0 for v in parts.values()), parts
        print("stage-0 CNN profile ({} windows, chunks of 16,384, bf16, conv {}): {}; on {} "
              "[{}]".format(DENSE_WINDOWS, list(model.stage_configs[0].conv_filter_sizes),
                           {k: round(v, 4) for k, v in parts.items()}, kind, card))
        holds += _tool_k1_holds(torch, k1_runs)
    finally:
        cf.restore(saved)
        shutil.rmtree(work, ignore_errors=True)
    print("phase 31: {:.1f} s".format(time.perf_counter() - t_phase))
    return holds



def _kernel_line(name, source, replaces, launches, m):
    return {
        "name": name,
        "route": "cuda",
        "source": "rapidobjectdetectionusingcascadedcnns_torch/csrc/" + source,
        "replaces": replaces if replaces.startswith("tools/") else (
            "rapidobjectdetectionusingcascadedcnns_tpu/" + replaces),
        "launches": launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        # grid_sample for the bilinear samplers (a yardstick without their
        # bf16 rounding points); no single PyTorch call computes K3's
        # groupRectangles
        "library_ms": m.get("library_ms"),
    }


def main() -> int:
    started = time.perf_counter()
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
    k1_vga_launches, host_results = phase_vga_path(torch, detector, frames, kind, card)
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
    torch.cuda.empty_cache()

    # ---- 11-13. the serving path ---------------------------------------------
    k3 = phase_k3(torch, detector, model, frames, dense)
    k3_launches = phase_vga_tail(torch, detector, frames, host_results, kind, card)
    torch.cuda.empty_cache()
    phase_bundle(torch, model, frames, kind, card)
    torch.cuda.empty_cache()

    # ---- 14. K2p, the profiling tool's path ----------------------------------
    # K2p's yardstick: phase 7's, on the same windows of the same frames
    k2p_launches, k2p = phase_k2p(torch, device, k2["library_ms"])
    torch.cuda.empty_cache()

    # ---- 15-17. training -----------------------------------------------------
    del model, detector
    torch.cuda.empty_cache()
    trained = phase_training(torch, device, kind, card)
    k1_trained_launches = phase_trained_detection(torch, device, trained, frames, kind, card)
    del trained
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu(torch, device)

    # ---- 18. the flagship recipe ---------------------------------------------
    torch.cuda.empty_cache()
    flagship = phase_flagship(torch, device, frames, dense, kind, card)
    torch.cuda.empty_cache()

    # ---- 19-21. the evaluation entry points, with the flagship ---------------
    _build.build()  # every library up to date, so the CLI's process builds nothing
    fddb_corpus = tempfile.mkdtemp(prefix="chip_smoke_fddb_corpus_")
    fddb_app = phase_fddb(torch, flagship["model"], fddb_corpus, kind, card)
    torch.cuda.empty_cache()
    phase_runtime(torch, flagship["model"], kind, card)
    phase_cli(torch, flagship["model"])

    # ---- 22-25. the rest of serving, and a training-step profile ------------
    root = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    work = {mode: "{}/{}".format(root, mode) for mode in ("gather", "crop")}
    try:
        torch.cuda.empty_cache()
        dynamic = phase_dynamic_bundle(torch, device, flagship, frames, work, kind, card)
        phase_cross_device(torch, flagship, dynamic, work, kind, card)
        t0 = time.perf_counter()
        phase_soak(torch, flagship, dynamic, frames, kind, card)
        print("phase 24: {:.1f} s".format(time.perf_counter() - t0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train_profile(torch, device, kind, card)
    print("phase 25: {:.1f} s".format(time.perf_counter() - t0))

    # ---- 26-28. the train, visualizer and tune apps ----------------------------
    apps_work = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trained_app = phase_train_apps(torch, kind, card, apps_work)
        print("phase 26: {:.1f} s".format(time.perf_counter() - t0))
        t0 = time.perf_counter()
        k1_vis = phase_visualizers(torch, kind, card, apps_work, trained_app)
        print("phase 27: {:.1f} s".format(time.perf_counter() - t0))
        t0 = time.perf_counter()
        phase_tune_app(torch, kind, card, apps_work, trained_app)
        print("phase 28: {:.1f} s".format(time.perf_counter() - t0))
    finally:
        shutil.rmtree(apps_work, ignore_errors=True)

    # ---- 29. the appended Inception stage ---------------------------------------
    torch.cuda.empty_cache()
    k1_inception = phase_inception(torch, device, frames, kind, card)

    # ---- 30. meshes ---------------------------------------------------------------
    torch.cuda.empty_cache()
    mesh_holds = phase_meshes(torch, device, flagship, frames, dense, kind, card)

    # ---- 31. the analysis tools ------------------------------------------------------
    torch.cuda.empty_cache()
    try:
        tool_holds = phase_analysis_tools(torch, flagship, fddb_corpus, kind, card)
    finally:
        shutil.rmtree(fddb_corpus, ignore_errors=True)

    loaded = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "rapidobjectdetectionusingcascadedcnns_tpu")
    )
    assert not loaded, "the port imported {}".format(loaded)
    print("chip_smoke: every phase passed in {:.1f} s".format(time.perf_counter() - started))
    print(card)
    kernels = [
        _kernel_line("K1 crop_and_resize (VGA path re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", k1_vga_launches, k1_vga),
        _kernel_line("K1 crop_and_resize (dense path re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", k1_dense_launches, k1_dense),
        _kernel_line("K2 scheduled stage-0 extraction (crop mode)", "sched.cu",
                     "ops/windows_sched.py:259", k2_launches, k2),
        _kernel_line("K4 row-bounded re-extraction (dyn_reextract)", "rowbound.cu",
                     "ops/windows_dyn.py:83", k4_launches, k4),
        _kernel_line("K3 groupRectangles clustering (VGA device NMS tail, N=4096)",
                     "cluster.cu", "ops/nms_pallas.py:33", k3_launches, k3[OPEN_CAPS[-1]]),
        _kernel_line("K2p scheduled extraction with precomputed taps (profiling tool)",
                     "sched_precomp.cu", "tools/profile_sched_precomp.py:62", k2p_launches, k2p),
        _kernel_line("K1 crop_and_resize (trained cascade, VGA path re-extraction)",
                     "resample.cu", "ops/windows_pallas.py:63", k1_trained_launches, k1_vga),
        _kernel_line("K1 crop_and_resize (flagship, VGA path re-extraction at {})".format(
            flagship["caps"]), "resample.cu", "ops/windows_pallas.py:63", *flagship["k1"]),
        _kernel_line("K3 groupRectangles clustering (flagship, VGA device NMS tail, N={})".format(
            flagship["caps"][-1]), "cluster.cu", "ops/nms_pallas.py:33", *flagship["k3"]),
        _kernel_line("K1 crop_and_resize (flagship, dense path re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", flagship["k1_dense"], k1_dense),
        _kernel_line("K2 scheduled stage-0 extraction (flagship, dense path)", "sched.cu",
                     "ops/windows_sched.py:259", flagship["k2_dense"], k2),
        _kernel_line("K4 row-bounded re-extraction (flagship, dense path, dyn_reextract)",
                     "rowbound.cu", "ops/windows_dyn.py:83", flagship["k4_dense"], k4),
        _kernel_line("K2 scheduled stage-0 extraction (flagship, FDDB app, one image a call)",
                     "sched.cu", "ops/windows_sched.py:259", *fddb_app["k2"]),
        _kernel_line("K1 crop_and_resize (flagship, FDDB app re-extraction)", "resample.cu",
                     "ops/windows_pallas.py:63", *fddb_app["k1"]),
    ]
    kernels += [
        _kernel_line("K1 crop_and_resize (flagship, dynamic bundle, {} frames; measured on "
                     "its {}-frame chunk)".format(max(DYN_FRAME_COUNTS),
                                                  max(DYN_FRAME_COUNTS) - N_FRAMES),
                     "resample.cu", "ops/windows_pallas.py:63", *dynamic["k1"]),
        _kernel_line("K3 groupRectangles clustering (flagship, dynamic bundle, {} frames; "
                     "measured on its {}-frame chunk)".format(max(DYN_FRAME_COUNTS),
                                                             max(DYN_FRAME_COUNTS) - N_FRAMES),
                     "cluster.cu", "ops/nms_pallas.py:33", *dynamic["k3"]),
        _kernel_line("K2 scheduled stage-0 extraction (flagship, crop-mode dynamic bundle, {} "
                     "VGA frames)".format(N_FRAMES), "sched.cu", "ops/windows_sched.py:259",
                     *dynamic["crop"]["k2"]),
    ]
    kernels += [_kernel_line("K1 crop_and_resize (train-app cascade, visualizer re-extraction, "
                             "{})".format(what), "resample.cu", "ops/windows_pallas.py:63",
                             launches, m) for what, launches, m in k1_vis]
    kernels += [_kernel_line("K1 crop_and_resize (Inception cascade, {})".format(what),
                             "resample.cu", "ops/windows_pallas.py:63", launches, m)
                for what, launches, m in k1_inception]
    kernels += [_kernel_line(*hold) for hold in mesh_holds]
    kernels += [_kernel_line(*hold) for hold in tool_holds]
    if fddb_app["unscheduled"]:
        kernels.append(_kernel_line(
            "K1 crop_and_resize (flagship, FDDB app stage 0 at the unscheduled sizes {}, "
            "{}-box chunks)".format(fddb_app["unscheduled"], fddb_app["chunk"]),
            "resample.cu", "ops/windows_pallas.py:63", *fddb_app["k1_stage0"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
