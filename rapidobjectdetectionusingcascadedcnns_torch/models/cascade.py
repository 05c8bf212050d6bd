"""Cascade inference: multi-stage early reject over window batches
(counterpart of models/cascade.py).

Per chunk of same-size frames, every stage runs once for all frames:

  stage 0:  gather mode (coarse pyramids, <= 48 levels): pyramid resize +
            dense window gather (ops/windows.py); crop mode (dense
            pyramids): every plan window resampled from the full frame,
            by kernel K2 over the plan's static schedule
            (ops/windows_sched.py) or by K1 over box chunks where there is
            no schedule -> stage CNN over all windows -> foreground probs
  between:  compaction -- survivors move to the front of a fixed-capacity
            buffer ("scan": cumsum + searchsorted, window order; "rank":
            stable argsort on (alive, strength)); the next stage's windows
            are re-extracted from the full frame by kernel K1
            (ops/windows_cuda.py), or with ``dyn_reextract="on"`` by the
            row-bounded kernel K4 (ops/windows_dyn.py), one launch per
            stage for the whole chunk
  stage i:  CNN with the previous stage's bottleneck concat -> probs ->
            alive mask and LAST/AVG/MULT confidence accumulation; an
            Inception stage (299 px, ``append_inception``) re-extracts and
            classifies its boxes in chunks whose windows and trunk
            activations fit ``models/inception.CHUNK_BYTES`` (4 GiB), so
            each of its K1 launches stays far below 2^31 values; the live
            detector runs only the chunks up to the last slot alive in any
            frame of the dispatch (one host read of that count), a traced
            bundle and the window-sharded path every chunk
  last:     one packed float32 row per frame leaves the device; NMS runs on
            the host (numpy/native groupRectangles), or with
            ``nms_on_device`` on the device as a tail of the same program:
            groupRectangles over every frame's last-stage survivors, kernel
            K3 (ops/nms_cuda.py), one launch for the chunk.

Capacities are fixed per dispatch; a frame whose survivors overflow a buffer
is re-run alone with doubled capacities (saturation re-dispatch), so the
result equals the reference's unbounded survivor sets. A K4 big-class
overflow is saturation too, and ends in a re-run with K1 if escalation
cannot cure it.

With a mesh (``parallel/mesh.py``) a chunk of frames is padded to a
multiple of the mesh size with copies of its last frame and split: each
shard runs :func:`cascade_core` on its device with its own copy of the
weights and tables (every frame keeps its full plan, so a crop-mode stage
0 still runs K2 per shard), and the packed rows come back to mesh device 0.
One huge image's windows are sharded by ``parallel/window_shard.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cf
from ..ops import windows_dyn, windows_sched
from ..ops.color import yuv420_to_rgb
from ..ops.pyramid import PyramidPlan, build_plan, window_table
from ..ops.windows import crop_and_resize_impl, extract_windows, level_indices, to_planes_bf16
from ..parallel import mesh as mesh_mod
from ..utils import log
from ..utils.device import resolve_device, set_numerics, upload
from ..utils.profiling import annotate
from . import cnn


@dataclass
class CascadeModel:
    """Trained cascade: per-stage params/configs/standardization stats."""

    stage_params: List[cnn.Params]
    stage_configs: List[cnn.StageConfig]
    stage_means: List[np.ndarray]  # (H, W, C) float32 per stage
    stage_stds: List[np.ndarray]

    @property
    def n_nets(self) -> int:
        return len(self.stage_params)

    @property
    def input_sizes(self) -> List[int]:
        return [c.input_size for c in self.stage_configs]

    @property
    def device(self) -> torch.device:
        return self.stage_params[0]["fc2"]["W"].device

    def to(self, device) -> "CascadeModel":
        """A copy with every parameter on ``device`` (None: the CUDA card)."""
        device = resolve_device(device)
        return CascadeModel(
            [cnn.tree_map(lambda t: t.to(device), p) for p in self.stage_params],
            list(self.stage_configs),
            list(self.stage_means),
            list(self.stage_stds),
        )


@dataclass
class DetectionResult:
    """Detections for one image, boxes in original pixel coords (xyxy)."""

    boxes: np.ndarray  # (M, 4) after NMS
    confidences: np.ndarray  # (M,)
    raw_boxes: np.ndarray  # pre-NMS surviving windows (K, 4)
    raw_confidences: np.ndarray  # (K,)
    n_windows: int  # total windows evaluated at stage 0
    n_survivors_per_stage: List[int]
    # stage-0 window ids (plan order) of the pre-NMS survivors
    raw_window_ids: Optional[np.ndarray] = None
    # per-re-extract big-class overflow counts of the row-bounded kernel K4
    # (ops/windows_dyn.py); nonzero means the frame was re-dispatched
    reextract_overflows: Optional[List[int]] = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_capacity_schedule(n_windows: int, n_stages: int) -> List[int]:
    """Fixed survivor capacities after each non-final stage: 1/8 of the
    windows, then /4 per stage, at least 256, multiples of 128, at most
    ``n_windows``. Safe to undershoot: saturation re-dispatch re-runs a
    frame with doubled capacities."""
    caps = []
    for i in range(1, n_stages):
        frac = n_windows // (8 * 4 ** (i - 1))
        caps.append(min(n_windows, _round_up(max(256, frac), 128)))
    return caps


def escalate_capacities(
    capacities: Sequence[int], n_windows: int
) -> Optional[List[int]]:
    """Double every capacity, clamped by the window count that can reach
    each stage; None when the buffers are already fully open."""
    new_caps, bound = [], n_windows
    for c in capacities:
        nc = min(bound, _round_up(c * 2, 128))
        new_caps.append(nc)
        bound = nc
    if tuple(new_caps) == tuple(capacities):
        return None
    return new_caps


def capacity_ladder(capacities: Sequence[int], n_windows: int, steps: int):
    """The rungs above ``capacities``: up to ``steps``
    :func:`escalate_capacities` doublings, ending where the buffers are
    fully open."""
    caps = list(capacities)
    for _ in range(steps):
        caps = escalate_capacities(caps, n_windows)
        if caps is None:
            return
        yield caps


def climb_ladder(result, rung, ladder, rerun, saturated):
    """The saturation re-dispatch of the live detectors and the serving
    bundles: while ``saturated(result, rung)``, re-run at the next rung of
    ``ladder`` (``rerun(rung)``). Returns (result, rung): the first result
    that is not saturated, else the last rung's."""
    for nxt in ladder:
        if not saturated(result, rung):
            break
        rung, result = nxt, rerun(nxt)
    return result, rung


def read_back_pipelined(idxs: Sequence[int], dispatch) -> List[Tuple[List[int], np.ndarray]]:
    """The bounded software pipeline of both detectors (JAX
    ``CascadeDetector.detect_batch`` and ``SingleNetDetector.detect_batch``):
    ``idxs`` in chunks of ``inference_batch_frames``, each given to
    ``dispatch``, which uploads and enqueues it and returns its packed rows
    on the device; once more than ``inference_pipeline_depth`` chunks are
    pending, the oldest is read back. Returns every chunk with its rows on
    the host, in order, so the caller decodes only after the last
    dispatch."""
    step = int(cf.get("inference_batch_frames"))
    depth = max(1, int(cf.get("inference_pipeline_depth")))
    pending, done = [], []
    for s in range(0, len(idxs), step):
        chunk = idxs[s : s + step]
        pending.append((chunk, *_copy_to_host(dispatch(chunk))))
        if len(pending) > depth:
            done.append(_read_back(*pending.pop(0)))
    done.extend(_read_back(*p) for p in pending)
    return done


def _copy_to_host(rows: torch.Tensor):
    """Enqueue the copy of a chunk's rows to (pinned) host memory right
    behind the work that made them: (host tensor, the CUDA event that marks
    the copy done, or None for rows on the CPU). Reading the chunk back
    then waits for it alone, as ``np.asarray`` of one array does in the JAX
    package; a ``.cpu()`` at read time would queue behind every chunk
    enqueued since."""
    if rows.device.type != "cuda":
        return rows, None
    host = rows.to("cpu", non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(rows.device))
    return host, copied


def _read_back(chunk, host, copied):
    with annotate("rodc.read_back"):
        if copied is not None:
            copied.synchronize()
        return chunk, host.numpy()


def resolve_extraction_mode(plan: PyramidPlan) -> str:
    """'gather' for coarse pyramids (<= 48 levels), 'crop' for dense ones,
    unless ``window_extraction_mode`` forces one."""
    configured = cf.get("window_extraction_mode")
    if configured in ("gather", "crop"):
        return configured
    return "crop" if plan.n_scales > 48 else "gather"


def resolve_compaction() -> str:
    """``cascade_compaction``: "scan" whenever saturation re-dispatch
    guarantees untruncated survivor sets, "rank" otherwise."""
    configured = cf.get("cascade_compaction")
    if configured in ("rank", "scan"):
        return configured
    return "scan" if cf.get("cascade_saturation_redispatch") else "rank"


def resolve_thresholds(n_stages: int) -> List[float]:
    """Scalar-or-list ``foreground_confidence_threshold``."""
    thr = cf.get("foreground_confidence_threshold")
    if isinstance(thr, (int, float)):
        return [float(thr)] * n_stages
    if len(thr) != n_stages:
        raise ValueError("Invalid foreground_confidence_threshold.")
    return [float(t) for t in thr]


RESAMPLE_CHOICES = ("auto", True, "pallas", "pallas2", "pallas2dyn")


def resolve_resample_impl() -> str:
    """The resampling kernels of a dispatch, from ``use_pallas_resample``,
    ``stage0_scheduled_extraction`` and ``dyn_reextract`` (the JAX
    package's resolution, with the TPU's kernels mapped to the port's):

      * "pallas2": K2 for the crop-mode stage 0, K1 for re-extraction;
      * "pallas": K1 for both;
      * "pallas2dyn": "pallas2" with K4 for re-extraction.

    "auto" is "pallas2" ("pallas" with ``stage0_scheduled_extraction``
    "off"); "pallas" and ``True`` become "pallas2" with it "on"; "pallas2"
    becomes "pallas2dyn" with ``dyn_reextract`` "on". The JAX package's
    "xla" (and ``False``) names its einsum formulation, which the port does
    not have: it raises ``ValueError`` rather than being rerouted.
    """
    configured = cf.get("use_pallas_resample")
    sched_flag = cf.get("stage0_scheduled_extraction")
    if configured not in RESAMPLE_CHOICES:
        raise ValueError(
            "use_pallas_resample={!r} has no counterpart in the port; use one of "
            "{}".format(configured, ", ".join(repr(c) for c in RESAMPLE_CHOICES))
        )
    if configured == "pallas2dyn":
        return configured
    if configured == "pallas2":
        impl = "pallas2"
    elif configured == "auto":
        impl = "pallas" if sched_flag == "off" else "pallas2"
    else:  # "pallas" or True
        impl = "pallas2" if sched_flag == "on" else "pallas"
    if impl == "pallas2" and cf.get("dyn_reextract") == "on":
        return "pallas2dyn"
    return impl


def resolve_nms_on_device() -> bool:
    """``nms_on_device`` takes effect with OpenCV-style NMS only."""
    return bool(cf.get("nms_on_device")) and cf.get("nms") == cf.NMS_OPENCV


def _compact_indices(alive: torch.Tensor, p_fg: torch.Tensor, cap: int, compaction: str):
    """Select up to ``cap`` surviving rows per frame from (B, n) masks.

    Returns ``(keep, alive_out)``, both (B, cap): row indices to gather and
    their alive mask. "scan": the j-th kept row is the j-th alive row in
    window order (cumsum + searchsorted, clamped to n - 1). "rank": a
    stable argsort on (alive, strength), strongest first.
    """
    n = alive.shape[1]
    if compaction == "scan":
        c = torch.cumsum(alive.long(), dim=1)
        n_alive = c[:, -1:]
        targets = torch.arange(1, cap + 1, device=alive.device).expand(alive.shape[0], cap)
        keep = torch.searchsorted(c, targets.contiguous(), side="left")
        keep = torch.clamp(keep, max=n - 1)
        slots = torch.arange(cap, device=alive.device)[None, :]
        return keep, slots < torch.clamp(n_alive, max=cap)
    order = torch.argsort(-(alive.float() * (1.0 + p_fg)), dim=1, stable=True)
    keep = order[:, :cap]
    return keep, torch.gather(alive, 1, keep)


def _apply_stage_rows(params, cfg, x, bneck_in, mean, std, chunk: int):
    """Standardize (R, s, s, C) windows (any float dtype) and run the stage
    CNN over row chunks of at most ``chunk`` (bounds the conv
    intermediates). A symbolic R (a frame count traced by ``torch.export``)
    takes :func:`_apply_stage_rows_traced`, which cuts the same chunks."""
    if isinstance(x.shape[0], torch.SymInt):
        return _apply_stage_rows_traced(params, cfg, x, bneck_in, mean, std, chunk)
    probs, bnecks = [], []
    for s in range(0, x.shape[0], chunk):
        xc = (x[s : s + chunk].float() - mean) / std
        bc = None if bneck_in is None else bneck_in[s : s + chunk]
        out = cnn.apply_stage(params, cfg, xc, bc)
        probs.append(out["probs"])
        bnecks.append(out["bottleneck"])
    return torch.cat(probs), torch.cat(bnecks)


def _apply_stage_rows_traced(params, cfg, x, bneck_in, mean, std, chunk: int):
    """:func:`_apply_stage_rows` for a row count R that ``torch.export``
    holds symbolic (frames x windows under a dynamic frame count).

    The chunks are the eager loop's, rows [k * chunk, min((k + 1) * chunk,
    R)), so each GEMM and convolution sees the row count the live detector
    gives it (another row count can pick another cuBLAS kernel, and flip a
    window at a gate). The graph holds one chunk for each ``chunk`` rows of
    R's upper bound (the bounded ``torch.export.Dim`` of the frames); a
    chunk's length is read on the host at run time (``item`` of a CPU
    scalar: no device synchronisation; :func:`pin_host_scalars` keeps it on
    the CPU when the program moves) and is 0 past R, where the CNN runs on
    no rows. The rows are gathered and their outputs scattered back by
    index, so no size depends on a sum of chunk lengths. (Lengths held as
    symbolic expressions of R, with no tensor, trace under torch 2.13 but
    not under 2.11, whose shape checks in the CNN guard on them.)"""
    n_rows = x.shape[0]
    upper = n_rows.node.shape_env.bound_sympy(n_rows.node.expr).upper
    if not upper.is_finite:
        raise ValueError(
            "a symbolic frame count needs an upper bound: export it with "
            "torch.export.Dim(..., max=...)"
        )
    n_left = torch.full((), n_rows, dtype=torch.int64, device="cpu")
    probs = bnecks = None
    for k in range(-(-int(upper) // chunk)):
        length = torch.clamp(n_left - k * chunk, 0, chunk).item()
        torch._check(length >= 0)
        torch._check(length <= chunk)
        idx = torch.arange(length, device=x.device) + k * chunk
        xc = (x.index_select(0, idx).float() - mean) / std
        bc = None if bneck_in is None else bneck_in.index_select(0, idx)
        out = cnn.apply_stage(params, cfg, xc, bc)
        if probs is None:
            probs = out["probs"].new_empty((n_rows,) + tuple(out["probs"].shape[1:]))
            bnecks = out["bottleneck"].new_empty((n_rows,) + tuple(out["bottleneck"].shape[1:]))
        probs = probs.index_copy(0, idx, out["probs"])
        bnecks = bnecks.index_copy(0, idx, out["bottleneck"])
    return probs, bnecks


def pin_host_scalars(graph) -> None:
    """Put back on the CPU every tensor that an ``item`` call of an exported
    program's ``graph`` reads (the chunk lengths of
    :func:`_apply_stage_rows_traced`), after ``move_to_device_pass`` moved
    the program's tensors to another device, so that reading them needs no
    device synchronisation. Raises ``ValueError`` when such a tensor comes
    from a program input or from an op that does not name its device."""
    cpu = torch.device("cpu")
    for node in graph.nodes:
        if node.target is not torch.ops.aten.item.default:
            continue
        stack = [node.args[0]]
        while stack:
            arg = stack.pop()
            val = arg.meta.get("val")
            if not isinstance(val, torch.Tensor):
                continue  # a symbolic size, such as the frame count
            inputs = [a for a in arg.all_input_nodes
                      if isinstance(a.meta.get("val"), torch.Tensor)]
            if arg.op != "call_function" or (not inputs and "device" not in arg.kwargs):
                raise ValueError(
                    "{} reads {} ({}), which cannot be kept on the CPU".format(
                        node.name, arg.name, arg.target))
            if "device" in arg.kwargs:
                arg.kwargs = {**arg.kwargs, "device": cpu}
            arg.meta["val"] = val.to(cpu)
            stack.extend(inputs)


def _upper_bound(n) -> int:
    """``n``, or for a size ``torch.export`` holds symbolic (the frame count
    of a dynamic bundle) its upper bound."""
    if isinstance(n, torch.SymInt):
        return int(n.node.shape_env.bound_sympy(n.node.expr).upper)
    return int(n)


def _reextract(images, boxes, size: int, cap: int, resample_impl: str,
               high_precision: bool, planes):
    """(B, cap, size, size, C) windows of (B, cap, 4) boxes and the per-frame
    K4 big-class overflow: K4 (``dyn_reextract="on"``) where its gate
    (``windows_dyn.dyn_supported``, the JAX package's, from shapes alone)
    admits the geometry, else K1 (0 overflow). The gate sends the
    Inception stage's 299 px windows to K1, as in the JAX package; a
    geometry it admits but K4 cannot stage raises K4's ``ValueError``."""
    b, img_h, img_w = images.shape[0], images.shape[1], images.shape[2]
    use_dyn = (resample_impl == "pallas2dyn" and not high_precision
               and windows_dyn.dyn_supported(img_h, img_w, size, size, cap))
    if use_dyn:
        from ..ops import windows_dyn_cuda

        windows_dyn_cuda.launch_geometry(size, size, images.shape[3])
        wins, _n_big, overflow = windows_dyn.extract_rowbound(
            images, boxes, size, size,
            big_cap=windows_dyn.default_big_cap(cap, size, size, img_h),
        )
        return wins, overflow
    wins = crop_and_resize_impl(images, boxes, size, size, high_precision, planes)
    return wins, torch.zeros(b, dtype=torch.long, device=images.device)


def _stage0_schedule(plan: PyramidPlan, size: int, resample_impl: str,
                     high_precision: bool):
    """The scheduled extraction plan of stage 0 (kernel K2), or None when
    the impl or the precision rules it out or the plan admits no schedule.
    One definition for the device path (which consumes it) and the host
    unpacking (which maps scheduled rows back to plan order)."""
    if resample_impl not in ("pallas2", "pallas2dyn") or high_precision:
        return None
    return windows_sched.schedule_for_plan(plan, size, size)


def _stage0_apply(
    images: torch.Tensor,
    boxes_float: torch.Tensor,
    plan: PyramidPlan,
    params,
    stage_cfg: cnn.StageConfig,
    mean0: torch.Tensor,
    std0: torch.Tensor,
    chunk: int,
    extraction_mode: str,
    resample_impl: str,
    high_precision: bool,
    indices=None,
    planes=None,
):
    """Dense-pyramid stage-0 classification of (B, H, W, C) float32 frames,
    shared by the cascade and the single-net detector.

    gather mode: per-level resize + gather (``indices`` are the plan's
    level index tables, built when None). crop mode: every window of
    ``boxes_float`` (N, 4) resampled from the full frame -- by K2 over the
    plan's schedule when there is one, else by K1 (or, with
    ``high_precision``, the f32 gather) over chunks of ``chunk`` boxes.
    ``planes``: the frames' bf16 planes for K1, when the caller has them
    (else converted once here, for all chunks).

    Returns (probs (B, M, 2), bottleneck (B, M, F), window_ids0 (M,) int64
    or None, valid0 (M,) bool or None): ids/valid are set exactly when K2
    ran -- its rows are in scheduled order with replicated pad rows; ids
    map rows back to plan order and valid masks the pads.
    """
    b, c = images.shape[0], images.shape[3]
    size = stage_cfg.input_size

    def classify(wins):
        rows = wins.shape[0] * wins.shape[1]
        with annotate("rodc.cnn.0"):
            probs, bneck = _apply_stage_rows(
                params, stage_cfg, wins.reshape(rows, size, size, c), None, mean0, std0, chunk
            )
        return probs.reshape(b, -1, probs.shape[1]), bneck.reshape(b, -1, bneck.shape[1])

    if extraction_mode == "crop":
        sched = _stage0_schedule(plan, size, resample_impl, high_precision)
        if sched is not None:
            # scheduled order is consumed as it is: the window-id channel
            # carries identity, so un-permuting the windows would be waste
            with annotate("rodc.stage0.windows"):
                wins = windows_sched.extract_scheduled(images, boxes_float, sched)
            probs, bneck = classify(wins)
            ids, _, valid = sched.device_tables(images.device)
            return probs, bneck, ids, valid
        if planes is None and not high_precision:
            with annotate("rodc.stage0.windows"):
                planes = to_planes_bf16(images)

        def crops(s):
            with annotate("rodc.stage0.windows"):
                return crop_and_resize_impl(
                    images, boxes_float[s : s + chunk].expand(b, -1, 4), size, size,
                    high_precision, planes,
                )

        parts = [classify(crops(s)) for s in range(0, boxes_float.shape[0], chunk)]
        return (
            torch.cat([p for p, _ in parts], dim=1),
            torch.cat([bn for _, bn in parts], dim=1),
            None,
            None,
        )
    with annotate("rodc.stage0.windows"):
        wins = extract_windows(images, plan, indices)
    probs, bneck = classify(wins)
    return probs, bneck, None, None


def _live_slots(alive: torch.Tensor) -> int:
    """One past the last slot of (B, n) ``alive`` that is live in any frame
    (0 when none is): the slots a stage must run. A host read, so one
    device synchronisation."""
    slots = torch.arange(1, alive.shape[1] + 1, device=alive.device)
    return int((alive * slots).max())


def stage_on_boxes(images, planes, boxes, bottleneck, params, cfg: cnn.StageConfig,
                   stats, resample_impl: str, high_precision: bool, chunk: int, stage: int,
                   alive: Optional[torch.Tensor] = None):
    """Stage ``stage`` over (B, n, 4) boxes of (B, H, W, C) float32 frames:
    re-extraction (:func:`_reextract`) and the stage CNN, reading the
    previous stage's (B, n, F) ``bottleneck`` where the stage takes one.
    Returns (foreground probs (B, n), bottleneck (B, n, F'), K4 overflow
    (B,), the slots of a frame it ran). An Inception stage handles its
    boxes in chunks whose 299 px windows and trunk activations fit
    ``inception.rows_per_chunk`` (rows are independent: the same result).
    Given the boxes' (B, n) ``alive`` mask, a stage cut into more than one
    chunk runs only the chunks before :func:`_live_slots`; the slots past
    them, dead in every frame, get foreground probability 0 and a zero
    bottleneck. Each chunk run has the shape it has in the full walk, so
    every live slot's result is the full walk's bit for bit."""
    b, cap = images.shape[0], boxes.shape[1]
    size = cfg.input_size
    mean, std = stats
    step = cap
    if cfg.backbone == "inception":
        from . import inception

        step = max(1, inception.rows_per_chunk(size) // _upper_bound(b))
    end = _live_slots(alive) if alive is not None and step < cap else cap
    reextract_span, cnn_span = "rodc.reextract.{}".format(stage), "rodc.cnn.{}".format(stage)
    probs_parts, bneck_parts, overflow, done = [], [], None, 0
    for s in range(0, end, step):
        n = min(step, cap - s)
        with annotate(reextract_span):
            wins, over = _reextract(
                images, boxes[:, s : s + n], size, n, resample_impl, high_precision, planes
            )
        overflow = over if overflow is None else overflow + over
        bneck_in = (
            bottleneck[:, s : s + n].reshape(b * n, -1)
            if cfg.bottleneck_in_size is not None else None
        )
        with annotate(cnn_span):
            probs_c, bneck_c = _apply_stage_rows(
                params, cfg, wins.reshape(b * n, size, size, -1), bneck_in, mean, std, chunk,
            )
        probs_parts.append(probs_c[:, 1].reshape(b, n))
        bneck_parts.append(bneck_c.reshape(b, n, -1))
        done += n
    if done < cap:
        probs_parts.append(images.new_zeros(b, cap - done))
        bneck_parts.append(images.new_zeros(b, cap - done, cfg.bottleneck_out_size))
        if overflow is None:
            overflow = torch.zeros(b, dtype=torch.long, device=images.device)
    p = probs_parts[0] if len(probs_parts) == 1 else torch.cat(probs_parts, 1)
    bneck = bneck_parts[0] if len(bneck_parts) == 1 else torch.cat(bneck_parts, 1)
    return p, bneck, overflow, done


def cascade_core(
    images: torch.Tensor,
    coords_norm: torch.Tensor,
    boxes_float: torch.Tensor,
    stage_params: Sequence[cnn.Params],
    stage_stats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    plan: PyramidPlan,
    stage_configs: Sequence[cnn.StageConfig],
    capacities: Sequence[int],
    confidence_mode: str,
    thresholds: Sequence[float],
    high_precision: bool = False,
    chunk: int = 16384,
    compaction: str = "rank",
    indices=None,
    extraction_mode: str = "gather",
    resample_impl: str = "pallas2",
    nms_min_neighbors: int = -1,
    nms_eps: float = 0.2,
    live_prefix: bool = False,
):
    """Full cascade over a chunk of frames.

    ``images`` (B, H, W, C) float32; ``coords_norm`` (N0, 4) int64 window
    boxes on the original image (re-extraction); ``boxes_float`` (N0, 4)
    float32 exact window geometry (crop-mode stage 0). Returns (outputs,
    slots): ``slots`` lists the slots of a frame each stage ran, stage 0
    first; ``outputs`` is ``window_ids`` (B, C_last) int64, ``conf`` (B,
    C_last) f32, ``alive`` (B, C_last) bool and ``diagnostics`` (B, 2 *
    n_stages - 1): per-stage pre-compaction survivor counts, then
    per-re-extract K4 big-class overflow counts (0 where K4 did not run).
    With ``nms_min_neighbors >= 0`` the groupRectangles tail runs too
    (``rodc::cluster``, kernel K3, once for the chunk) and ``outputs``
    gains ``cluster_xywh`` (B, C_last, 4) int32, ``cluster_weights`` (B,
    C_last) int32 and ``cluster_keep`` (B, C_last) bool.

    ``live_prefix`` (the live detector): a stage cut into more than one
    slot chunk runs only the chunks up to the last slot alive after its
    compaction (:func:`stage_on_boxes`; one host read a stage). Without it
    every chunk runs, as a traced program (which must not read the device)
    needs.
    """
    n_stages = len(stage_configs)
    b = images.shape[0]
    images = images.float()

    # K1's bf16 planes, converted once for every re-extraction of the chunk
    with annotate("rodc.stage0.windows"):
        planes = None if high_precision else to_planes_bf16(images)

    mean0, std0 = stage_stats[0]
    probs0, bottleneck, ids0, valid0 = _stage0_apply(
        images, boxes_float, plan, stage_params[0], stage_configs[0], mean0, std0,
        chunk, extraction_mode, resample_impl, high_precision, indices, planes,
    )
    n0 = probs0.shape[1]
    p_fg = probs0[..., 1]
    alive = p_fg > thresholds[0]
    if valid0 is not None:
        alive = alive & valid0
    conf = p_fg
    if ids0 is None:
        ids0 = torch.arange(n0, device=images.device)
    window_ids = ids0.expand(b, n0)
    survivors = [alive.sum(dim=1)]
    overflows = []
    slots = [n0]

    for i in range(1, n_stages):
        cap = capacities[i - 1]
        keep, alive = _compact_indices(alive, p_fg, cap, compaction)
        conf = torch.gather(conf, 1, keep)
        window_ids = torch.gather(window_ids, 1, keep)
        bottleneck = torch.gather(
            bottleneck, 1, keep[:, :, None].expand(b, cap, bottleneck.shape[2])
        )
        boxes = coords_norm[window_ids].float()  # (B, cap, 4)
        p_i, bottleneck, overflow, done = stage_on_boxes(
            images, planes, boxes, bottleneck, stage_params[i], stage_configs[i],
            stage_stats[i], resample_impl, high_precision, chunk, i,
            alive if live_prefix else None,
        )
        overflows.append(overflow)
        slots.append(done)
        alive = alive & (p_i > thresholds[i])
        if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
            conf = conf + p_i
        elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
            conf = conf * p_i
        else:  # LAST: only the final net's score matters
            conf = p_i
        p_fg = p_i
        survivors.append(alive.sum(dim=1))

    if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
        conf = conf / n_stages
    elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
        conf = torch.clamp(conf, min=cf.MIN_SCORE_FOR_FINAL_CONFIDENCE_CALCULATION_MULT)

    diagnostics = torch.stack(survivors + overflows, dim=1)
    if nms_min_neighbors < 0:
        return (window_ids, conf, alive, diagnostics), slots

    from ..ops import nms_cuda

    with annotate("rodc.nms_device"):
        final = coords_norm[window_ids].float()  # (B, C_last, 4) xyxy
        xywh = torch.stack(
            [final[..., 0], final[..., 1], final[..., 2] - final[..., 0],
             final[..., 3] - final[..., 1]],
            dim=-1,
        )
        avg, weights, keep, _ = nms_cuda.group_rectangles(xywh, alive, nms_min_neighbors, nms_eps)
    return (window_ids, conf, alive, diagnostics, avg, weights, keep), slots


def pack_result(window_ids, conf, alive, diagnostics, *nms_tail) -> torch.Tensor:
    """One float32 row per frame, so the host reads back one buffer:
    [ids (C), conf (C), alive (C), diagnostics (2 * n_stages - 1)], plus
    with the device NMS tail [xywh (C, 4) row-major, weights (C), keep
    (C)]."""
    parts = [window_ids.float(), conf.float(), alive.float(), diagnostics.float()]
    if nms_tail:
        avg, weights, keep = nms_tail
        parts += [avg.float().reshape(avg.shape[0], -1), weights.float(), keep.float()]
    return torch.cat(parts, dim=1)


class CascadeDetector:
    """Host orchestration around :func:`cascade_core`.

    One instance per :class:`CascadeModel`; it runs over a mesh
    (``parallel.mesh.Mesh``, or a tuple of devices; by default the model's
    device alone): frame chunks are sharded over the mesh, the weights
    replicated once per distinct device, and the results gathered on mesh
    device 0 (JAX ``CascadeDetector(mesh=)``). Pyramid plans and their
    device tables are cached per image size.

    A stage cut into more than one slot chunk (the 299 px Inception stage)
    runs only the chunks up to the last slot alive in any frame of the
    dispatch (``cascade_core``'s ``live_prefix``): one host read before
    that stage.

    ``counters`` adds up, over the detect calls (host integers): ``frames``
    requested; ``upload_bytes`` handed to ``utils/device.upload``;
    ``rows_launched[i]``, the rows stage i ran (stage 0 every window, with
    K2's pad rows, of every frame a dispatch carries, mesh padding
    included; stage i >= 1 the slots it ran of the dispatch's capacity
    i - 1), re-dispatched re-runs at their rung; ``rows_skipped[i]``, the
    rows of capacity i - 1 that stage i left out as dead in every frame (0
    for stage 0 and every stage run in one chunk); ``rows_needed[i]``, the
    rows stage i needed (every window of each frame; stage i >= 1 the
    pre-compaction survivors of stage i - 1 in the frame's kept row); and
    ``redispatches``, the saturation re-runs (also the attribute
    ``redispatches``). The window-sharded path
    (``parallel/window_shard.py``) counts only ``redispatches``.
    """

    def __init__(self, model: CascadeModel, capacity_schedule=None, mesh=None):
        if model.n_nets < 2:
            raise ValueError("a cascade must consist of at least two nets")
        self.model = model
        self.mesh = mesh_mod.Mesh([model.device]) if mesh is None else mesh_mod.as_mesh(mesh)
        self.device = self.mesh[0]
        self.counters = {"frames": 0, "upload_bytes": 0, "rows_launched": [0] * model.n_nets,
                         "rows_skipped": [0] * model.n_nets, "rows_needed": [0] * model.n_nets,
                         "redispatches": 0}
        self._saturation_warned = False
        self._plan_cache: Dict[tuple, list] = {}
        self._capacity_override = capacity_schedule or cf.get("cascade_capacity_schedule")
        for c in model.stage_configs:
            set_numerics(c.compute_dtype)
        self._stats_device = tuple(
            (
                torch.as_tensor(m, dtype=torch.float32, device=self.device),
                torch.as_tensor(s, dtype=torch.float32, device=self.device),
            )
            for m, s in zip(model.stage_means, model.stage_stds)
        )
        self._params_device = tuple(
            cnn.cast_params(p, c) for p, c in zip(model.stage_params, model.stage_configs)
        )
        # per shard: (params, stats) on its device (one copy per device)
        self._shards = list(zip(
            mesh_mod.replicate(self.mesh, self._params_device),
            mesh_mod.replicate(self.mesh, self._stats_device),
        ))
        self._params_device = self._shards[0][0]

    @property
    def redispatches(self) -> int:
        """Saturation re-runs, for diagnostics (``counters``)."""
        return self.counters["redispatches"]

    @redispatches.setter
    def redispatches(self, value: int) -> None:
        self.counters["redispatches"] = value

    def _plan_and_table(self, img_h: int, img_w: int) -> list:
        """[plan, window table, coords_norm (N, 4) int64 and boxes_float
        (N, 4) float32 on the device, level indices, the other mesh
        devices' copies], cached per size and pyramid config. The level
        indices stay None until gather mode asks for them
        (:meth:`_level_indices`); crop mode never does."""
        size0 = self.model.input_sizes[0]
        mwl = float(cf.get("min_window_length"))
        wsf = float(cf.get("window_scale_factor"))
        key = (img_h, img_w, size0, mwl, wsf)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        plan = build_plan(img_h, img_w, size0, size0, mwl, wsf)
        table = window_table(plan)
        coords_norm = torch.as_tensor(
            table["coords_norm"].astype(np.int64), device=self.device
        )
        boxes_float = torch.as_tensor(table["boxes_float"], device=self.device)
        entry = [plan, table, coords_norm, boxes_float, None, {}]
        if len(self._plan_cache) >= 128:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = entry
        return entry

    def _level_indices(self, entry: list):
        """Gather mode's per-level index tables on the device, built into
        the plan's cache entry on first use."""
        if entry[4] is None:
            entry[4] = level_indices(entry[0], self.device)
        return entry[4]

    def _tables_on(self, entry: list, device: torch.device, mode: str):
        """(coords_norm, boxes_float, level indices or None) of a plan's
        cache entry on ``device``: the entry's own on the detector's
        device, else a copy made on first use."""
        indices = None
        if device == self.device:
            if mode == "gather":
                indices = self._level_indices(entry)
            return entry[2], entry[3], indices
        copy = entry[5].get(device)
        if copy is None:
            copy = entry[5][device] = [entry[2].to(device), entry[3].to(device), None]
        if mode == "gather" and copy[2] is None:
            copy[2] = level_indices(entry[0], device)
        return copy[0], copy[1], copy[2]

    def detect(self, image: np.ndarray) -> DetectionResult:
        """Run the full pyramid cascade on one (H, W, 3) uint8 image."""
        return self.detect_batch([image])[0]

    def detect_batch(self, images: Sequence[np.ndarray]) -> List[DetectionResult]:
        """Detect over a list of images; with ``inference_resize_buckets``
        each image is first resized to its nearest bucket and detections
        are mapped back."""
        buckets = cf.get("inference_resize_buckets")
        if not buckets:
            return self._detect_batch_exact(images)

        from ..data.image_io import resize_rgb

        resized: List[np.ndarray] = []
        inverse_scales: List[Tuple[float, float]] = []
        for img in images:
            h, w = img.shape[0], img.shape[1]
            bh, bw = min(
                buckets,
                key=lambda bk: abs(np.log(h / bk[0])) + abs(np.log(w / bk[1])),
            )
            if (bh, bw) == (h, w):
                resized.append(img)
                inverse_scales.append((1.0, 1.0))
            else:
                resized.append(resize_rgb(img, bh, bw))
                inverse_scales.append((w / bw, h / bh))

        results = self._detect_batch_exact(resized)
        for res, (sx, sy) in zip(results, inverse_scales):
            if sx != 1.0 or sy != 1.0:
                factors = np.array([sx, sy, sx, sy])
                res.boxes = res.boxes * factors
                res.raw_boxes = (res.raw_boxes * factors).astype(res.raw_boxes.dtype)
        return results

    def detect_batch_yuv420(self, frames: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Detect over YUV420 frames: each is (Y (H, W) uint8, UV (H/2, W/2,
        2) uint8). The chroma -> RGB decode runs on the device."""
        return self._detect_batch_exact(frames, yuv=True)

    def _run_chunk(self, frames: Sequence, yuv: bool, caps, entry, resample: Optional[str]):
        """Upload one chunk of frames (host arrays; or tensors already on
        the card, which :func:`upload` stacks there) and enqueue its
        cascade; returns the packed (B, row) tensor on the device (not yet
        synchronised).
        ``resample`` overrides the configured kernels (the K1 re-run after
        a K4 overflow). With ``nms_on_device`` the program ends in the
        groupRectangles tail. The chunk is padded to a multiple of the mesh
        size with its last frame and split; every shard is enqueued before
        the rows are gathered on mesh device 0, and the padding rows are
        dropped."""
        n = len(frames)
        padded = list(frames) + [frames[-1]] * (-n % self.mesh.size)
        parts = [
            self._run_shard(padded[rows], yuv, caps, entry, resample, k)
            for k, rows in enumerate(mesh_mod.split_rows(len(padded), self.mesh))
        ]
        return mesh_mod.gather(self.mesh, parts)[:n]

    def _run_shard(self, frames: Sequence, yuv: bool, caps, entry, resample: Optional[str],
                   shard: int):
        """:meth:`_run_chunk` of one shard's frames on its device."""
        device = self.mesh[shard]
        params, stats = self._shards[shard]
        plan = entry[0]
        mode = resolve_extraction_mode(plan)
        coords_norm, boxes_float, indices = self._tables_on(entry, device, mode)
        n_stages = self.model.n_nets
        impl = resample or resolve_resample_impl()
        high_precision = bool(cf.get("inference_high_precision"))
        self.counters["upload_bytes"] += sum(
            a.nbytes for f in frames for a in (f if yuv else (f,)))
        with mesh_mod.on_device(device):
            with annotate("rodc.upload"):
                if yuv:
                    y = upload([f[0] for f in frames], device)
                    uv = upload([f[1] for f in frames], device)
                else:
                    images = upload(frames, device)
            with annotate("rodc.dispatch"):
                if yuv:
                    with annotate("rodc.stage0.windows"):
                        images = yuv420_to_rgb(y, uv)
                else:
                    images = images.float()
                out, slots = cascade_core(
                    images,
                    coords_norm,
                    boxes_float,
                    params,
                    stats,
                    plan,
                    self.model.stage_configs,
                    tuple(caps),
                    cf.get("final_confidence_calculation"),
                    tuple(resolve_thresholds(n_stages)),
                    high_precision,
                    int(cf.get("inference_chunk_size")),
                    resolve_compaction(),
                    indices,
                    mode,
                    impl,
                    int(cf.get("nms_opencv_min_neighbors")) if resolve_nms_on_device() else -1,
                    float(cf.get("nms_opencv_eps")),
                    live_prefix=True,
                )
                packed = pack_result(*out)
        launched, skipped = self.counters["rows_launched"], self.counters["rows_skipped"]
        for i, done in enumerate(slots):
            launched[i] += len(frames) * done
            if i:
                skipped[i] += len(frames) * (int(caps[i - 1]) - done)
        return packed

    def _detect_batch_exact(self, images: Sequence, yuv: bool = False) -> List[DetectionResult]:
        """Same-size frames go through one batched cascade per chunk of
        ``inference_batch_frames``, pipelined by :func:`read_back_pipelined`;
        rows are decoded (saturation re-dispatch, host NMS) once every chunk
        of a size is read back."""
        resolve_resample_impl()  # refuse an unported choice before any upload
        results: List[Optional[DetectionResult]] = [None] * len(images)
        needed = self.counters["rows_needed"]

        by_size: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            shape = img[0].shape if yuv else img.shape
            by_size.setdefault((shape[0], shape[1]), []).append(i)

        with annotate("rodc.request"):
            self.counters["frames"] += len(images)
            for (img_h, img_w), idxs in by_size.items():
                entry = self._plan_and_table(img_h, img_w)
                plan, table = entry[0], entry[1]
                if plan.n_windows < 1:
                    raise ValueError("Could not extract any windows from the given image")
                capacities = tuple(
                    self._capacity_override
                    or default_capacity_schedule(plan.n_windows, self.model.n_nets)
                )

                def run(frames, caps, resample=None):
                    return self._run_chunk(frames, yuv, caps, entry, resample)

                chunks = read_back_pipelined(
                    idxs, lambda chunk: run([images[i] for i in chunk], capacities))
                with annotate("rodc.decode"):
                    for chunk, packed in chunks:
                        for j, i in enumerate(chunk):
                            row, caps = packed[j], capacities
                            if self._row_saturated(row, caps, plan):
                                row, caps = self._handle_saturation(images[i], row, caps, plan,
                                                                    run)
                            results[i] = res = self._unpack_row(row, caps, plan, table)
                            needed[0] += plan.n_windows
                            for k, n in enumerate(res.n_survivors_per_stage[:-1], start=1):
                                needed[k] += n
        return results  # type: ignore[return-value]

    def _row_saturated(self, row, capacities, plan) -> bool:
        """:meth:`_is_saturated` of a packed row, read from its counts (no
        host NMS for a row that is re-dispatched)."""
        from ..serve import packed_row_counts

        survivors, overflows = packed_row_counts(
            row, capacities, self.model.n_nets, plan.n_windows)
        return self._is_saturated(survivors, capacities, overflows)

    def _unpack_row(self, row, capacities, plan, table) -> DetectionResult:
        from ..serve import unpack_packed_row

        return unpack_packed_row(
            row,
            capacities,
            self.model.n_nets,
            plan,
            table,
            resolve_nms_on_device(),
            nms_mode=str(cf.get("nms")),
            nms_min_neighbors=int(cf.get("nms_opencv_min_neighbors")),
            nms_eps=float(cf.get("nms_opencv_eps")),
            vertically_enlarge=bool(cf.get("vertically_enlarge_bboxes")),
        )

    @staticmethod
    def _is_saturated(survivors, capacities, overflows=None) -> bool:
        """Truncation at compaction i happens exactly when the
        pre-compaction alive count exceeds the capacity."""
        if overflows and any(o > 0 for o in overflows):
            return True
        return any(s > c for s, c in zip(survivors, capacities))

    def _handle_saturation(self, frame, row, capacities, plan, run):
        """Re-run the frame alone with doubled capacities (bounded retries)
        so no detection is lost to truncation; with
        ``cascade_saturation_redispatch`` off, warn once and keep the
        truncated result. A K4 big-class overflow is never kept: its
        windows carry other windows' pixels, so the frame gets one
        corrective re-run with K1 ("pallas"), at unchanged capacities when
        re-dispatch is off, after the escalation budget otherwise. Takes
        and returns a packed row and its capacities: only the row that is
        kept is decoded (host NMS included)."""
        from ..serve import packed_row_counts

        def rerun(caps, resample=None):
            self.redispatches += 1
            with annotate("rodc.redispatch"):
                return run([frame], caps, resample).cpu().numpy()[0]

        def overflowed(r, caps) -> bool:
            overflows = packed_row_counts(r, caps, self.model.n_nets, plan.n_windows)[1]
            return any(o > 0 for o in overflows)

        if not cf.get("cascade_saturation_redispatch"):
            if overflowed(row, capacities):
                log.log(
                    "WARNING: dynamic re-extraction big class overflowed "
                    "(cascade_saturation_redispatch is off); re-running with "
                    "the full-image resampler at unchanged capacities."
                )
                return rerun(list(capacities), resample="pallas"), list(capacities)
            if not self._saturation_warned:
                log.log(
                    "WARNING: a cascade stage saturated its survivor capacity; "
                    "excess windows were dropped by confidence ranking "
                    "(cascade_saturation_redispatch is off). Consider "
                    "retraining the stage or raising cascade_capacity_schedule."
                )
                self._saturation_warned = True
            return row, capacities

        def escalate(caps):
            log.log(
                "WARNING: cascade stage saturated its survivor capacity; "
                "re-dispatching with capacities {}".format(caps)
            )
            return rerun(caps)

        ladder = capacity_ladder(capacities, plan.n_windows,
                                 int(cf.get("cascade_saturation_max_retries")))
        row, caps = climb_ladder(
            row, list(capacities), ladder, escalate,
            lambda r, c: self._row_saturated(r, c, plan),
        )
        if overflowed(row, caps):
            log.log(
                "WARNING: dynamic re-extraction big class overflowed; "
                "re-dispatching with the full-image resampler."
            )
            row = rerun(caps, resample="pallas")
        return row, caps


def build_cascade_model(
    seed: int = 0,
    n_nets: Optional[int] = None,
    img_size_max: Optional[int] = None,
    device=None,
) -> CascadeModel:
    """Randomly initialized cascade with the configured architecture, on
    ``device`` (default: the CUDA card; ``"cpu"`` for the CPU). The weights
    are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and
    then moved, so a seed gives the same weights on every device."""
    n_nets = n_nets or cf.get("cascade_n_nets")
    img_size_max = img_size_max or cf.get("img_width")
    sizes = cnn.stage_input_sizes(
        n_nets, img_size_max, cf.get("cascade_increasing_input_dimensions")
    )
    generator = torch.Generator().manual_seed(seed)
    params_list, config_list, means, stds = [], [], [], []
    bneck = None
    for size in sizes:
        sc = cnn.StageConfig.from_config(size, bottleneck_in_size=bneck)
        params_list.append(cnn.init_stage(sc, generator))
        config_list.append(sc)
        means.append(np.full((size, size, 3), 127.5, np.float32))
        stds.append(np.full((size, size, 3), 64.0, np.float32))
        bneck = sc.bottleneck_out_size if cf.get("reuse_bottlenecks") else None
    return CascadeModel(params_list, config_list, means, stds).to(device)
