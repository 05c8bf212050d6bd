"""Serving bundles: the cascade program as a deployable artifact, and the
decoder of its packed result rows (counterpart of serve.py).

A bundle holds the batched cascade program exported with ``torch.export``
once per rung of a *capacity ladder*: the base survivor capacities and
each escalation the live detector would re-dispatch to on saturation
(``models/cascade.escalate_capacities``). The serving loop walks the
ladder as ``CascadeDetector`` walks its doubling loop; a top-rung
saturation warns and keeps the truncated result. The kernels enter each
program as single graph nodes, the custom operators of ``ops/library.py``
(K1 ``rodc::resample``, K2 ``rodc::sched``, K3 ``rodc::cluster`` for the
on-device NMS tail), so a loaded program runs the same kernels as the live
detector.

Every config knob is resolved at export time and written to ``meta.json``:
the serving side reads no config. The weights, pre-cast to the compute
dtype as the live detector casts them, ride in the bundle once
(``weights.npz``) and enter every rung's program as one list input.

Layout on disk (``save_bundle``)::

    <dir>/meta.json        everything serving needs, config-free
    <dir>/weights.npz      flat weight arrays, shared by all rungs
    <dir>/program_0.pt2    torch.export program at base capacities
    <dir>/program_1.pt2    ... first escalation rung, etc.

A bundle is exported once, on the model's device, with a static frame
count or (``batch="dynamic"``) a bounded symbolic one: one program per rung
then serves any number of frames up to the bound with no padding, and a
saturated frame is re-run alone. ``platforms`` lists the device types the
bundle may run on; a saved bundle holds its tensors on the CPU, and
``load_bundle`` moves the programs to the device it is given
(``torch.export.passes.move_to_device_pass``), where the custom
operators dispatch by device: the CUDA kernels on the card, their plain
versions on the CPU.

A frame-sharded bundle (``export_detector(mesh=)``, the serving layout of
``CascadeDetector(mesh=)``) holds the same single-device program at the
static batch divided by the mesh size, and records the device count;
``load_bundle(dir, mesh=)`` loads one copy of it per distinct mesh device
and splits each call's frames over the mesh.

A window-sharded bundle (``export_window_sharded``, the serving layout of
``parallel/window_shard.detect_window_sharded``) holds the shard-local parts
of one image's cascade at fixed shapes, and serves through
:class:`WindowShardedServingDetector`, which runs the compaction between
them on mesh device 0.
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from . import config as cf
from .models import cascade as casc
from .models import cnn, inception
from .models.cascade import CascadeModel, DetectionResult
from .ops import library  # noqa: F401 (registers the kernels' operators before loading)
from .ops import nms as nms_ops
from .ops import rectangles as rect_ops
from .ops.color import yuv420_to_rgb
from .ops.pyramid import build_plan, window_table
from .ops.windows import extract_windows, level_indices, to_planes_bf16
from .parallel import mesh as mesh_mod
from .parallel import window_shard
from .utils import log
from .utils.device import resolve_device, set_numerics, upload
from .utils.profiling import annotate

FORMAT_VERSION = 2  # 2: dynamic batches, platforms and the export device
PROGRAM_FORMAT = "torch.export"


def postprocess_raw(
    boxes: np.ndarray,
    conf: np.ndarray,
    *,
    nms_mode: str,
    nms_min_neighbors: int,
    vertically_enlarge: bool,
    nms_eps: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host NMS (groupRectangles, numpy or native code) plus optional
    vertical enlargement (app/inference_app.py:219-231)."""
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float64), np.zeros((0,), np.float64)
    if nms_mode == cf.NMS_OPENCV:
        out_boxes, weights = nms_ops.nms_boxes(boxes, nms_min_neighbors, nms_eps)
        out_boxes = out_boxes.astype(np.float64)
        out_conf = weights.astype(np.float64)
    else:
        out_boxes = boxes.astype(np.float64)
        out_conf = conf.astype(np.float64)
    if vertically_enlarge and len(out_boxes):
        out_boxes = rect_ops.vertically_enlarge(out_boxes, enlarge_top=0.2)
    return out_boxes, out_conf


def packed_row_counts(
    row: np.ndarray, capacities: Sequence[int], n_stages: int, n_windows: int
) -> Tuple[List[int], List[int]]:
    """(survivors per stage, re-extract overflow counts) of one frame's
    packed vector, read without decoding the rest of it."""
    base = 3 * (capacities[-1] if capacities else n_windows)
    survivors = [int(s) for s in row[base : base + n_stages]]
    overflows = [int(s) for s in row[base + n_stages : base + 2 * n_stages - 1]]
    return survivors, overflows


def unpack_packed_row(
    row: np.ndarray,
    capacities: Sequence[int],
    n_stages: int,
    plan,
    table,
    nms_on_device: bool,
    *,
    nms_mode: str,
    nms_min_neighbors: int,
    vertically_enlarge: bool,
    nms_eps: float = 0.2,
) -> DetectionResult:
    """Decode one frame's packed vector (models/cascade.pack_result layout:
    ids, confidences, alive, per-stage survivor counts, per-stage
    re-extract overflow counts, and with the device NMS tail the clusters'
    xywh, weights and keep flags) into a ``DetectionResult``. Config-free,
    so the live detector and a bundle share one decoder."""
    cap_last = capacities[-1] if capacities else plan.n_windows
    window_ids = row[:cap_last].astype(np.int64)
    conf = row[cap_last : 2 * cap_last]
    alive = row[2 * cap_last : 3 * cap_last] > 0.5
    base = 3 * cap_last
    survivors, overflows = packed_row_counts(row, capacities, n_stages, plan.n_windows)
    keep_ids = window_ids[alive]
    raw_boxes = table["coords_norm"][keep_ids]
    raw_conf = conf[alive]
    if nms_on_device:
        tail = row[base + 2 * n_stages - 1 :]
        cl_keep = tail[5 * cap_last : 6 * cap_last] > 0.5
        cl_xywh = tail[: 4 * cap_last].reshape(cap_last, 4)[cl_keep]
        cl_w = tail[4 * cap_last : 5 * cap_last][cl_keep]
        boxes = np.stack(
            [cl_xywh[:, 0], cl_xywh[:, 1], cl_xywh[:, 0] + cl_xywh[:, 2], cl_xywh[:, 1] + cl_xywh[:, 3]],
            axis=1,
        ).astype(np.float64)
        confidences = cl_w.astype(np.float64)
        if vertically_enlarge and len(boxes):
            boxes = rect_ops.vertically_enlarge(boxes, enlarge_top=0.2)
    else:
        with annotate("rodc.host_nms"):
            boxes, confidences = postprocess_raw(
                raw_boxes,
                raw_conf,
                nms_mode=nms_mode,
                nms_min_neighbors=nms_min_neighbors,
                vertically_enlarge=vertically_enlarge,
                nms_eps=nms_eps,
            )
    return DetectionResult(
        boxes=boxes,
        confidences=confidences,
        raw_boxes=raw_boxes,
        raw_confidences=raw_conf,
        n_windows=plan.n_windows,
        n_survivors_per_stage=survivors,
        raw_window_ids=keep_ids,
        reextract_overflows=overflows,
    )


@dataclass
class ServingBundle:
    """An exported cascade: config-free metadata, the flat weights (shared
    by all rungs) and one ``torch.export`` program per capacity rung."""

    meta: dict
    weights: List[torch.Tensor]
    programs: List[torch.export.ExportedProgram]


def trunk_kinds(stage_params: Sequence[cnn.Params]) -> List[Optional[str]]:
    """Per stage: None for a custom stage, else its trunk's kind
    (``"compact"`` or ``"v3"``, ``inception.trunk_kind``)."""
    return [inception.trunk_kind(p["backbone"]) if "backbone" in p else None
            for p in stage_params]


def flatten_params(stage_params: Sequence[cnn.Params]) -> List[torch.Tensor]:
    """Stage parameter dictionaries -> one flat list (per stage: each conv
    layer's W and b, then fc1's, then fc2's; for an Inception stage the
    trunk's leaves in ``inception.flat_keys`` order, then fc2's)."""
    return [t for p in stage_params for t in cnn.param_leaves(p)]


def unflatten_params(
    flat: Sequence[torch.Tensor], stage_configs, trunks: Optional[Sequence] = None
) -> Tuple[cnn.Params, ...]:
    """The inverse of :func:`flatten_params`; ``trunks``: the stages'
    :func:`trunk_kinds` (needed where a stage is an Inception one)."""
    out, k = [], 0
    for i, c in enumerate(stage_configs):
        if c.backbone == "inception":
            n = len(inception.flat_keys(trunks[i]))
            out.append({
                "backbone": inception.backbone_from_leaves(list(flat[k : k + n]), trunks[i]),
                "fc2": {"W": flat[k + n], "b": flat[k + n + 1]},
            })
            k += n + 2
            continue
        n_conv = len(c.conv_filter_sizes)
        conv = [{"W": flat[k + 2 * i], "b": flat[k + 2 * i + 1]} for i in range(n_conv)]
        k += 2 * n_conv
        out.append({
            "conv": conv,
            "fc1": {"W": flat[k], "b": flat[k + 1]},
            "fc2": {"W": flat[k + 2], "b": flat[k + 3]},
        })
        k += 4
    return tuple(out)


def _register_level_indices(module: torch.nn.Module, indices):
    """Gather mode's level index tables as buffers of ``module``; returns
    the levels' sizes (None without tables)."""
    if indices is None:
        return None
    for k, (_, _, ys, xs) in enumerate(indices):
        module.register_buffer("ys{}".format(k), ys)
        module.register_buffer("xs{}".format(k), xs)
    return [(sh, sw) for sh, sw, _, _ in indices]


def _level_indices_of(module: torch.nn.Module, level_sizes):
    if level_sizes is None:
        return None
    return [(sh, sw, getattr(module, "ys{}".format(k)), getattr(module, "xs{}".format(k)))
            for k, (sh, sw) in enumerate(level_sizes)]


class _CascadeProgram(torch.nn.Module):
    """The batched cascade at one rung's capacities, every knob fixed; the
    pyramid tables and standardisation stats are buffers, the weights an
    input. ``forward`` takes uint8 frames and returns the packed rows."""

    def __init__(self, tables: dict, knobs: dict, capacities: Sequence[int]):
        super().__init__()
        self.knobs = knobs
        self.capacities = tuple(int(c) for c in capacities)
        self.register_buffer("coords_norm", tables["coords_norm"])
        self.register_buffer("boxes_float", tables["boxes_float"])
        for k, (mean, std) in enumerate(tables["stats"]):
            self.register_buffer("mean{}".format(k), mean)
            self.register_buffer("std{}".format(k), std)
        self.level_sizes = _register_level_indices(self, tables["indices"])

    def run(self, images: torch.Tensor, flat: List[torch.Tensor]) -> torch.Tensor:
        kn = self.knobs
        configs = kn["stage_configs"]
        stats = tuple(
            (getattr(self, "mean{}".format(k)), getattr(self, "std{}".format(k)))
            for k in range(len(configs))
        )
        out, _ = casc.cascade_core(
            images, self.coords_norm, self.boxes_float,
            unflatten_params(flat, configs, kn["trunks"]), stats,
            kn["plan"], configs, self.capacities, kn["confidence_mode"], kn["thresholds"],
            kn["high_precision"], kn["chunk"], kn["compaction"],
            _level_indices_of(self, self.level_sizes), kn["extraction_mode"],
            kn["resample_impl"], kn["nms_mn"], kn["nms_eps"],
        )
        return casc.pack_result(*out)


class _RgbProgram(_CascadeProgram):
    def forward(self, images: torch.Tensor, flat: List[torch.Tensor]) -> torch.Tensor:
        return self.run(images.float(), flat)


class _YuvProgram(_CascadeProgram):
    def forward(self, y: torch.Tensor, uv: torch.Tensor, flat: List[torch.Tensor]) -> torch.Tensor:
        return self.run(yuv420_to_rgb(y, uv), flat)


PLATFORMS = ("cuda", "cpu")


def _device_key(device: torch.device) -> str:
    """The device as tensors on it print it ("cuda:0", "cpu"): the key
    ``move_to_device_pass`` matches a program's devices by."""
    if device.type == "cuda" and device.index is None:
        return "cuda:{}".format(torch.cuda.current_device())
    return str(device)


def _check_platforms(device: torch.device, platforms: Optional[Sequence[str]]) -> List[str]:
    """The device types a bundle exported on ``device`` may load on
    (default: its own); raises unless they are known and include it."""
    platforms = list(platforms) if platforms is not None else [device.type]
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or device.type not in platforms:
        raise ValueError(
            "platforms={}: list device types of {} that include the export "
            "device's ({})".format(platforms, PLATFORMS, device.type)
        )
    return platforms


def _plan_and_rungs(model: CascadeModel, img_h: int, img_w: int,
                    capacities: Optional[Sequence[int]], n_rungs: int):
    """(plan, capacity rungs) of an export: rung 0 the base capacities,
    each next one an ``escalate_capacities`` doubling, at most
    ``n_rungs``."""
    if model.n_nets < 2:
        raise ValueError("a cascade must consist of at least two nets")
    size0 = model.input_sizes[0]
    plan = build_plan(img_h, img_w, size0, size0, float(cf.get("min_window_length")),
                      float(cf.get("window_scale_factor")))
    if plan.n_windows < 1:
        raise ValueError("Could not extract any windows at this image size")
    base = list(
        capacities
        or cf.get("cascade_capacity_schedule")
        or casc.default_capacity_schedule(plan.n_windows, model.n_nets)
    )
    return plan, [base] + list(casc.capacity_ladder(base, plan.n_windows, n_rungs - 1))


def export_detector(
    model: CascadeModel,
    img_h: int,
    img_w: int,
    *,
    batch=None,
    yuv: bool = False,
    capacities: Optional[Sequence[int]] = None,
    n_rungs: int = 3,
    resample_impl: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh=None,
) -> ServingBundle:
    """Export the batched cascade program for (img_h, img_w) frames on the
    model's device.

    Every config knob the program depends on is resolved here and recorded
    in the bundle's metadata. ``n_rungs``: how many capacity rungs to ship
    (rung 0 = base capacities; each next rung is one
    ``escalate_capacities`` doubling). ``resample_impl``: "pallas2" (K2
    for a crop-mode stage 0, K1 for re-extraction) or "pallas" (K1 for
    both); default the configured choice. The row-bounded kernel K4
    ("pallas2dyn") needs the host's overflow re-dispatch and is refused.

    ``batch``: frames per program call (default
    ``inference_batch_frames``), or ``"dynamic"``: a symbolic frame count
    from 1 to ``max(2, inference_batch_frames)`` (the serving loop's chunk,
    recorded as ``chunk_hint``), traced from an example of 2 frames so that
    one frame is not special-cased. ``platforms``: the device types the
    bundle may be loaded on, from ``PLATFORMS`` and including the model's
    (default: the model's alone). ``mesh``: a ``parallel.mesh.Mesh`` (or a
    tuple of devices) to serve frame-sharded over; it needs a static batch
    divisible by the mesh size, and the program is exported at the batch
    divided by it (``max_batch``), to be loaded with a mesh of that size."""
    n_devices = 1
    if mesh is not None:
        n_devices = mesh_mod.as_mesh(mesh).size
        full = int(cf.get("inference_batch_frames")) if batch is None else batch
        if full == "dynamic":
            raise ValueError("a frame-sharded export needs a static batch")
        if full % n_devices:
            raise ValueError(
                "batch {} is not divisible by the {}-device mesh".format(full, n_devices))
        batch = full // n_devices
    device = model.device
    platforms = _check_platforms(device, platforms)
    impl = resample_impl or casc.resolve_resample_impl()
    if impl == "pallas2dyn":
        raise ValueError(
            "the dynamic row-bounded kernel needs host-side overflow re-dispatch "
            "policy; export with 'pallas' or 'pallas2'"
        )
    if impl not in ("pallas", "pallas2"):
        raise ValueError("resample_impl={!r}: export with 'pallas' or 'pallas2'".format(impl))
    plan, rungs = _plan_and_rungs(model, img_h, img_w, capacities, n_rungs)
    table = window_table(plan)
    n_stages = model.n_nets
    size0 = model.input_sizes[0]
    extraction_mode = casc.resolve_extraction_mode(plan)
    high_precision = bool(cf.get("inference_high_precision"))
    nms_mode = str(cf.get("nms"))
    nms_on_device = casc.resolve_nms_on_device()
    nms_min_neighbors = int(cf.get("nms_opencv_min_neighbors"))
    knobs = {
        "plan": plan,
        "stage_configs": tuple(model.stage_configs),
        "trunks": tuple(trunk_kinds(model.stage_params)),
        "confidence_mode": str(cf.get("final_confidence_calculation")),
        "thresholds": tuple(casc.resolve_thresholds(n_stages)),
        "high_precision": high_precision,
        "chunk": int(cf.get("inference_chunk_size")),
        "compaction": casc.resolve_compaction(),
        "extraction_mode": extraction_mode,
        "resample_impl": impl,
        "nms_mn": nms_min_neighbors if nms_on_device else -1,
        "nms_eps": float(cf.get("nms_opencv_eps")),
    }
    dynamic = batch == "dynamic"
    chunk_hint = int(cf.get("inference_batch_frames"))
    if dynamic:
        max_batch = max(2, chunk_hint)
        example_batch = 2
    else:
        max_batch = example_batch = chunk_hint = int(batch or chunk_hint)

    coords_norm = torch.as_tensor(table["coords_norm"].astype(np.int64), device=device)
    tables = {
        "coords_norm": coords_norm,
        "boxes_float": torch.as_tensor(table["boxes_float"], device=device),
        "stats": [
            (torch.as_tensor(m, device=device), torch.as_tensor(s, device=device))
            for m, s in zip(model.stage_means, model.stage_stds)
        ],
        "indices": level_indices(plan, device) if extraction_mode == "gather" else None,
    }
    sched = casc._stage0_schedule(plan, size0, impl, high_precision)
    if extraction_mode == "crop" and sched is not None:
        # build the schedule's device tables outside the trace, on the very
        # device key the trace looks them up with, so they enter as constants
        sched.device_tables(coords_norm.device)
    flat = flatten_params(
        [cnn.cast_params(p, c) for p, c in zip(model.stage_params, model.stage_configs)]
    )
    if yuv:
        frames = (
            torch.zeros(example_batch, img_h, img_w, dtype=torch.uint8, device=device),
            torch.zeros(example_batch, img_h // 2, img_w // 2, 2, dtype=torch.uint8,
                        device=device),
        )
    else:
        frames = (torch.zeros(example_batch, img_h, img_w, 3, dtype=torch.uint8, device=device),)
    dynamic_shapes = None
    if dynamic:
        frames_dim = torch.export.Dim("frames", min=1, max=max_batch)
        dynamic_shapes = tuple({0: frames_dim} for _ in frames) + ([None] * len(flat),)
    program_cls = _YuvProgram if yuv else _RgbProgram
    programs = []
    for caps in rungs:
        program = torch.export.export(
            program_cls(tables, knobs, caps), (*frames, flat), dynamic_shapes=dynamic_shapes
        )
        # a saved program keeps its example inputs, the weights among them:
        # drop them, so the weights are stored once, in weights.npz
        program.example_inputs = None
        programs.append(program)
    meta = {
        "format_version": FORMAT_VERSION,
        "program_format": PROGRAM_FORMAT,
        "device": device.type,
        "export_device": _device_key(device),
        "img_h": img_h,
        "img_w": img_w,
        "batch": "dynamic" if dynamic else max_batch * n_devices,
        "chunk_hint": chunk_hint * n_devices,
        "max_batch": max_batch,  # frames a program call takes
        "yuv": yuv,
        "n_stages": n_stages,
        "trunks": list(knobs["trunks"]),  # per stage: None (custom) or the Inception trunk
        "size0": size0,
        "min_window_length": float(cf.get("min_window_length")),
        "window_scale_factor": float(cf.get("window_scale_factor")),
        "capacity_rungs": [list(map(int, caps)) for caps in rungs],
        "thresholds": list(knobs["thresholds"]),
        "confidence_mode": knobs["confidence_mode"],
        "extraction_mode": extraction_mode,
        "resample_impl": impl,
        "chunk": knobs["chunk"],
        "high_precision": high_precision,
        "compaction": knobs["compaction"],
        "nms_mode": nms_mode,
        "nms_on_device": nms_on_device,
        "nms_min_neighbors": nms_min_neighbors,
        "nms_eps": knobs["nms_eps"],
        "vertically_enlarge": bool(cf.get("vertically_enlarge_bboxes")),
        "compute_dtype": str(model.stage_configs[0].compute_dtype).replace("torch.", ""),
        "platforms": platforms,
        "weight_dtypes": [str(w.dtype).replace("torch.", "") for w in flat],
        "nr_devices": n_devices,
        "mesh_axis": None if mesh is None else mesh_mod.DATA_AXIS,
    }
    return ServingBundle(meta=meta, weights=[w.detach() for w in flat], programs=programs)


def _to_device(program: torch.export.ExportedProgram, src: str, dst: str):
    """``move_to_device_pass`` of ``program`` from device ``src`` to
    ``dst``, with the host scalars of a traced chunk loop kept on the CPU
    (``models/cascade.pin_host_scalars``)."""
    program = move_to_device_pass(program, {src: dst})
    casc.pin_host_scalars(program.graph)
    program.graph_module.recompile()
    return program


class _WindowProgram(torch.nn.Module):
    """One part of the window-sharded cascade (``parallel/window_shard.py``)
    at fixed shapes, every knob fixed; the standardisation stats of its
    stage (and gather mode's level index tables) are buffers, the weights
    an input. ``role``: ``"extract"`` (gather mode: the whole window tensor
    of a (1, H, W, 3) uint8 frame, padded to a mesh multiple), ``"stage0"``
    (a shard's rows: its boxes in crop mode, its windows in gather mode)
    or a later stage's index (a shard's boxes and incoming bottleneck)."""

    def __init__(self, knobs: dict, tables: dict, role):
        super().__init__()
        self.knobs, self.role = knobs, role
        self.level_sizes = None
        if role == "extract":
            self.level_sizes = _register_level_indices(self, tables["indices"])
        else:
            mean, std = tables["stats"][0 if role == "stage0" else role]
            self.register_buffer("mean", mean)
            self.register_buffer("std", std)

    def forward(self, image: torch.Tensor, *args):
        kn = self.knobs
        frame = image.float()
        if self.role == "extract":
            wins = extract_windows(frame, kn["plan"], _level_indices_of(self, self.level_sizes))
            return mesh_mod.pad_to_multiple(wins[0], kn["n_devices"])[0]
        *rows, flat = args
        i = 0 if self.role == "stage0" else self.role
        params = unflatten_params(flat, kn["stage_configs"], kn["trunks"])[i]
        cfg, stats = kn["stage_configs"][i], (self.mean, self.std)
        planes = None
        if not kn["high_precision"] and not (i == 0 and kn["extraction_mode"] == "gather"):
            planes = to_planes_bf16(frame)
        if i == 0:
            return window_shard.shard_stage0(frame, rows[0], kn["plan"], params, cfg, stats,
                                             kn["chunk"], kn["extraction_mode"],
                                             kn["high_precision"], planes)
        return window_shard.shard_stage(frame, rows[0], rows[1], params, cfg, stats, kn["chunk"],
                                        kn["high_precision"], planes, stage=i)


def export_window_sharded(
    model: CascadeModel,
    img_h: int,
    img_w: int,
    mesh,
    *,
    capacities: Optional[Sequence[int]] = None,
    n_rungs: int = 3,
    resample_impl: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
) -> ServingBundle:
    """Export one image's cascade with its window axis split over ``mesh``
    (a ``parallel.mesh.Mesh`` or a tuple of devices; the layout of
    ``parallel/window_shard.detect_window_sharded``) as a bundle, on the
    model's device. Its programs are the shard-local parts at fixed shapes:
    gather mode's window extraction, stage 0 over one shard's rows, and for
    each rung of the capacity ladder each later stage over one shard's
    survivors; the compaction between them runs on mesh device 0 when the
    bundle serves (:class:`WindowShardedServingDetector`), which walks the
    ladder as the live path re-dispatches. Re-extraction is K1's:
    ``resample_impl`` "pallas2" or "pallas2dyn" (the JAX signature's) is
    sent to K1 on this path, as in the JAX package. Loads with a mesh of
    the same size."""
    mesh = mesh_mod.as_mesh(mesh)
    n_dev = mesh.size
    if resample_impl not in (None, "pallas", "pallas2", "pallas2dyn"):
        raise ValueError("resample_impl={!r}: a window-sharded bundle re-extracts with K1 "
                         "('pallas')".format(resample_impl))
    device = model.device
    platforms = _check_platforms(device, platforms)
    plan, rungs = _plan_and_rungs(model, img_h, img_w, capacities, n_rungs)
    n_stages = model.n_nets
    size0 = model.input_sizes[0]
    extraction_mode = casc.resolve_extraction_mode(plan)
    configs = tuple(model.stage_configs)
    knobs = {
        "plan": plan,
        "stage_configs": configs,
        "trunks": tuple(trunk_kinds(model.stage_params)),
        "high_precision": bool(cf.get("inference_high_precision")),
        "chunk": int(cf.get("inference_chunk_size")),
        "extraction_mode": extraction_mode,
        "n_devices": n_dev,
    }
    tables = {
        "stats": [(torch.as_tensor(m, device=device), torch.as_tensor(s, device=device))
                  for m, s in zip(model.stage_means, model.stage_stds)],
        "indices": level_indices(plan, device) if extraction_mode == "gather" else None,
    }
    flat = flatten_params([cnn.cast_params(p, c) for p, c in zip(model.stage_params, configs)])
    image = torch.zeros(1, img_h, img_w, 3, dtype=torch.uint8, device=device)
    n0_pad = window_shard.pad_len(plan.n_windows, n_dev)
    if extraction_mode == "gather":
        rows0 = torch.zeros(n0_pad // n_dev, size0, size0, 3, device=device)
    else:
        rows0 = torch.zeros(n0_pad // n_dev, 4, device=device)
    parts = ([("extract", (image,))] if extraction_mode == "gather" else [])
    parts.append(("stage0", (image, rows0, flat)))
    for r, caps in enumerate(rungs):
        for i, cap in enumerate(window_shard.padded_capacities(caps, n_dev), start=1):
            width = configs[i - 1].bottleneck_out_size
            parts.append(((i, r), (image, torch.zeros(cap // n_dev, 4, device=device),
                                   torch.zeros(cap // n_dev, width, device=device), flat)))
    programs, roles = [], []
    for role, example in parts:
        program = torch.export.export(
            _WindowProgram(knobs, tables, role if role in ("extract", "stage0") else role[0]),
            example,
        )
        program.example_inputs = None  # the weights are stored once, in weights.npz
        programs.append(program)
        roles.append(role if isinstance(role, str) else "stage{}@{}".format(*role))
    meta = {
        "format_version": FORMAT_VERSION,
        "program_format": PROGRAM_FORMAT,
        "kind": "window_sharded",
        "program_roles": roles,
        "device": device.type,
        "export_device": _device_key(device),
        "img_h": img_h,
        "img_w": img_w,
        "n_stages": n_stages,
        "trunks": list(knobs["trunks"]),
        "size0": size0,
        "min_window_length": float(cf.get("min_window_length")),
        "window_scale_factor": float(cf.get("window_scale_factor")),
        "capacity_rungs": [list(map(int, caps)) for caps in rungs],
        "thresholds": list(casc.resolve_thresholds(n_stages)),
        "confidence_mode": str(cf.get("final_confidence_calculation")),
        "extraction_mode": extraction_mode,
        "resample_impl": "pallas",
        "chunk": knobs["chunk"],
        "high_precision": knobs["high_precision"],
        "compaction": casc.resolve_compaction(),
        "nms_mode": str(cf.get("nms")),
        "nms_min_neighbors": int(cf.get("nms_opencv_min_neighbors")),
        "nms_eps": float(cf.get("nms_opencv_eps")),
        "vertically_enlarge": bool(cf.get("vertically_enlarge_bboxes")),
        "compute_dtype": str(configs[0].compute_dtype).replace("torch.", ""),
        "platforms": platforms,
        "weight_dtypes": [str(w.dtype).replace("torch.", "") for w in flat],
        "nr_devices": n_dev,
        "mesh_axis": mesh_mod.DATA_AXIS,
        "n0_pad": n0_pad,
    }
    return ServingBundle(meta=meta, weights=[w.detach() for w in flat], programs=programs)


def save_bundle(bundle: ServingBundle, dir_path: str) -> None:
    """Write ``meta.json``, ``weights.npz`` and one ``program_<rung>.pt2``
    per capacity rung (``torch.export.save``), every tensor on the CPU (a
    host without a card can read it; ``load_bundle`` moves it to its
    device). bfloat16 weights are stored as uint16 views (npz has no
    bfloat16) and re-viewed on load per the meta's ``weight_dtypes``."""
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "meta.json"), "w") as f:
        json.dump(bundle.meta, f, indent=1)
    arrays = {}
    for i, w in enumerate(bundle.weights):
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            arrays["w{}".format(i)] = w.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays["w{}".format(i)] = w.numpy()
    np.savez(os.path.join(dir_path, "weights.npz"), **arrays)
    for i, program in enumerate(bundle.programs):
        if bundle.meta["export_device"] != "cpu":
            with warnings.catch_warnings():  # pytree's deprecation notes on deepcopy
                warnings.simplefilter("ignore", FutureWarning)
                program = copy.deepcopy(program)
            program = _to_device(program, bundle.meta["export_device"], "cpu")
        torch.export.save(program, os.path.join(dir_path, "program_{}.pt2".format(i)))


def _load_programs(dir_path: str, n_rungs: int, device: torch.device):
    """The saved programs (their tensors on the CPU), moved to ``device``."""
    programs = [
        torch.export.load(os.path.join(dir_path, "program_{}.pt2".format(i)))
        for i in range(n_rungs)
    ]
    target = _device_key(device)
    if target != "cpu":
        programs = [_to_device(p, "cpu", target) for p in programs]
    return programs


def load_bundle(dir_path: str, device=None, mesh=None) -> "ServingDetector":
    """Load a saved bundle into a ready :class:`ServingDetector` on
    ``device`` (default: the CUDA card), which must be of a type the
    bundle's ``platforms`` list; the saved programs (their tensors on the
    CPU) are moved to it. A frame-sharded bundle needs ``mesh`` (a
    ``parallel.mesh.Mesh`` or a tuple of devices) of its recorded device
    count, and loads one copy per distinct mesh device; a mesh of another
    size, or a ``device`` that is not mesh device 0, raises ``ValueError``.
    No model and no config: the artifact is self-contained. A bundle that
    is not a ``torch.export`` bundle (e.g. one of the JAX package) or a
    device it does not list raises ``ValueError``."""
    with open(os.path.join(dir_path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("program_format") != PROGRAM_FORMAT:
        raise ValueError(
            "{} is not a {} bundle (program_format {!r}); the JAX package's "
            "bundles load with its own serve.load_bundle".format(
                dir_path, PROGRAM_FORMAT, meta.get("program_format")
            )
        )
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            "unsupported bundle format {} (this build reads {})".format(
                meta.get("format_version"), FORMAT_VERSION
            )
        )
    n_devices = int(meta.get("nr_devices", 1))
    if mesh is None:
        if n_devices > 1 or meta.get("kind") == "window_sharded":
            raise ValueError(
                "this bundle was exported frame-sharded over {0} devices; pass "
                "load_bundle(..., mesh=) with a {0}-device mesh".format(n_devices))
        devices = [resolve_device(device)]
    else:
        mesh = mesh_mod.as_mesh(mesh)
        if mesh.size != n_devices:
            raise ValueError(
                "this bundle was exported for {} device(s); the mesh has {}".format(
                    n_devices, mesh.size))
        if device is not None and mesh_mod.as_mesh([device])[0] != mesh[0]:
            raise ValueError("device {} is not mesh device 0 ({})".format(device, mesh[0]))
        devices = list(mesh.distinct)
    for d in devices:
        if d.type not in meta["platforms"]:
            raise ValueError(
                "this bundle lists platforms {}; it does not run on {}".format(
                    meta["platforms"], d.type
                )
            )
    devices = list(mesh_mod.Mesh(devices).distinct)  # a bare "cuda" names its index
    weights = []
    with np.load(os.path.join(dir_path, "weights.npz")) as z:
        for i, dt in enumerate(meta["weight_dtypes"]):
            w = z["w{}".format(i)]
            if dt == "bfloat16":
                weights.append(torch.from_numpy(w.view(np.int16)).view(torch.bfloat16))
            else:
                weights.append(torch.from_numpy(w))
    n_programs = len(meta.get("program_roles", meta["capacity_rungs"]))
    by_device = {d: _load_programs(dir_path, n_programs, d) for d in devices}
    bundle = ServingBundle(meta=meta, weights=weights, programs=by_device[devices[0]])
    if meta.get("kind") == "window_sharded":
        return WindowShardedServingDetector(bundle, mesh, by_device)
    return ServingDetector(bundle, devices[0], mesh=mesh, programs_by_device=by_device)


class ServingDetector:
    """Serve detections from a bundle, with ``CascadeDetector.detect_batch``
    semantics for fixed-size frames: frames are chunked to the exported
    batch (``chunk_hint`` frames under a dynamic batch, unpadded; a static
    batch pads a short chunk with its last frame), a saturated frame walks
    the capacity ladder (re-run alone under a dynamic batch, as the live
    detector re-dispatches it; as a padded batch under a static one), and
    a top-rung saturation warns once and keeps the truncated result. With
    a mesh each call's frames are split over it, every shard's program
    enqueued on its device before the rows are gathered on mesh device 0.
    """

    def __init__(self, bundle: ServingBundle, device=None, mesh=None, programs_by_device=None):
        self.meta = m = bundle.meta
        self.mesh = mesh if mesh is not None else mesh_mod.Mesh([resolve_device(device)])
        self.device = self.mesh[0]
        self.programs = bundle.programs
        by_device = programs_by_device or {self.device: bundle.programs}
        # per mesh position: (modules, weights) of its device, on the device
        # once; every rung's call reuses the same tensors
        shards = {
            d: ([p.module() for p in by_device[d]], [w.to(d) for w in bundle.weights])
            for d in self.mesh.distinct
        }
        self._shards = [shards[d] for d in self.mesh]
        self._modules, self._weights = self._shards[0]
        set_numerics(getattr(torch, m["compute_dtype"]))
        self._plan = build_plan(
            m["img_h"], m["img_w"], m["size0"], m["size0"],
            m["min_window_length"], m["window_scale_factor"],
        )
        self._table = window_table(self._plan)
        self._warned = False

    def _frame_shape_ok(self, frame) -> bool:
        m = self.meta
        if m["yuv"]:
            if not isinstance(frame, (tuple, list)) or len(frame) != 2:
                return False
            y, uv = frame
            return y.shape == (m["img_h"], m["img_w"]) and uv.shape == (
                m["img_h"] // 2, m["img_w"] // 2, 2,
            )
        return frame.shape == (m["img_h"], m["img_w"], 3)

    def _dispatch_rung(self, rung: int, frames: List) -> torch.Tensor:
        """One exported program over ``frames`` (exactly ``batch`` of them
        under a static batch), split over the mesh; returns the packed rows
        on (mesh) device 0, not yet synchronised."""
        parts = []
        for (modules, weights), device, rows in zip(
            self._shards, self.mesh, mesh_mod.split_rows(len(frames), self.mesh)
        ):
            with mesh_mod.on_device(device):
                if self.meta["yuv"]:
                    y = upload([f[0] for f in frames[rows]], device)
                    uv = upload([f[1] for f in frames[rows]], device)
                    parts.append(modules[rung](y, uv, weights))
                else:
                    parts.append(modules[rung](upload(frames[rows], device), weights))
        return mesh_mod.gather(self.mesh, parts)

    def _unpack(self, row: np.ndarray, rung: int) -> DetectionResult:
        m = self.meta
        return unpack_packed_row(
            row,
            m["capacity_rungs"][rung],
            m["n_stages"],
            self._plan,
            self._table,
            m["nms_on_device"],
            nms_mode=m["nms_mode"],
            nms_min_neighbors=m["nms_min_neighbors"],
            vertically_enlarge=m["vertically_enlarge"],
            nms_eps=m["nms_eps"],
        )

    def _saturated(self, result: DetectionResult, rung: int) -> bool:
        return casc.CascadeDetector._is_saturated(
            result.n_survivors_per_stage,
            self.meta["capacity_rungs"][rung],
            result.reextract_overflows,
        )

    def detect(self, frame) -> DetectionResult:
        return self.detect_batch([frame])[0]

    def detect_batch(self, frames: Sequence, pipeline_depth: int = 2) -> List[DetectionResult]:
        """``pipeline_depth``: chunks kept in flight, so the next chunk's
        upload and compute overlap the current read-back."""
        m = self.meta
        for f in frames:
            if not self._frame_shape_ok(f):
                raise ValueError(
                    "frame shape does not match the exported program "
                    "({}x{}, yuv={})".format(m["img_h"], m["img_w"], m["yuv"])
                )
        dynamic = m["batch"] == "dynamic"
        step = m["chunk_hint"]
        # a saturated frame is re-run alone under a dynamic batch; a static
        # program admits exactly one frame count
        rerun_n = 1 if dynamic else step
        results: List[Optional[DetectionResult]] = [None] * len(frames)
        pending: List[Tuple[List[int], torch.Tensor]] = []

        def finish(chunk_idx, packed_dev):
            packed = packed_dev.cpu().numpy()
            for j, i in enumerate(chunk_idx):
                def rerun(rung, frame=frames[i]):
                    re_packed = self._dispatch_rung(rung, [frame] * rerun_n).cpu().numpy()
                    return self._unpack(re_packed[0], rung)

                result, rung = casc.climb_ladder(self._unpack(packed[j], 0), 0,
                                                 range(1, len(self._modules)), rerun,
                                                 self._saturated)
                if self._saturated(result, rung) and not self._warned:
                    log.log(
                        "WARNING: cascade stage saturated the bundle's top "
                        "capacity rung; excess windows were dropped. Export "
                        "with more rungs (n_rungs) or larger capacities."
                    )
                    self._warned = True
                results[i] = result

        for s in range(0, len(frames), step):
            chunk_idx = list(range(s, min(s + step, len(frames))))
            chunk = [frames[i] for i in chunk_idx]
            if not dynamic:
                chunk += [chunk[-1]] * (step - len(chunk))
            pending.append((chunk_idx, self._dispatch_rung(0, chunk)))
            if len(pending) > max(1, pipeline_depth):
                finish(*pending.pop(0))
        while pending:
            finish(*pending.pop(0))
        return results  # type: ignore[return-value]


class WindowShardedServingDetector:
    """Serve single images from a window-sharded bundle over a mesh of its
    device count, as ``parallel/window_shard.detect_window_sharded`` detects:
    each part runs on every shard's device (one copy of the programs and
    weights per distinct device), the compaction between the stages on mesh
    device 0, and a saturated result walks the bundle's capacity ladder; a
    top-rung saturation warns once and keeps the truncated result."""

    def __init__(self, bundle: ServingBundle, mesh, programs_by_device):
        self.meta = m = bundle.meta
        self.mesh = mesh
        self.device = mesh[0]
        shards = {
            d: (dict(zip(m["program_roles"], (p.module() for p in programs_by_device[d]))),
                [w.to(d) for w in bundle.weights])
            for d in mesh.distinct
        }
        self._shards = [shards[d] for d in mesh]
        set_numerics(getattr(torch, m["compute_dtype"]))
        self._plan = build_plan(
            m["img_h"], m["img_w"], m["size0"], m["size0"],
            m["min_window_length"], m["window_scale_factor"],
        )
        self._table = window_table(self._plan)
        self._coords_norm = torch.as_tensor(self._table["coords_norm"].astype(np.int64),
                                            device=self.device)
        self._boxes0 = mesh_mod.pad_to_multiple(
            torch.as_tensor(self._table["boxes_float"], device=self.device), mesh.size)[0]
        self._warned = False

    def detect(self, image: np.ndarray) -> DetectionResult:
        m, mesh = self.meta, self.mesh
        if image.shape != (m["img_h"], m["img_w"], 3):
            raise ValueError(
                "image shape {} does not match the exported program ({}x{})".format(
                    image.shape, m["img_h"], m["img_w"]))
        copies = {d: torch.as_tensor(image, device=d)[None] for d in mesh.distinct}
        frames = [copies[d] for d in mesh]
        rows0 = self._boxes0
        if m["extraction_mode"] == "gather":
            modules, weights = self._shards[0]
            rows0 = modules["extract"](frames[0])
        split0 = mesh_mod.split_rows(m["n0_pad"], mesh)

        def stage0(k):
            modules, weights = self._shards[k]
            return modules["stage0"](frames[k], rows0[split0[k]].to(mesh[k]), weights)

        rungs = m["capacity_rungs"]

        def run(rung):
            def stage(i, k, boxes, bottleneck):
                modules, weights = self._shards[k]
                return modules["stage{}@{}".format(i, rung)](frames[k], boxes, bottleneck, weights)

            padded = window_shard.padded_capacities(rungs[rung], mesh.size)
            packed = window_shard.cascade_infer_window_sharded(
                stage0, stage, self._coords_norm, self._plan.n_windows, m["n_stages"], padded,
                m["confidence_mode"], m["thresholds"], mesh, m["compaction"],
            )
            return unpack_packed_row(
                packed.cpu().numpy()[0], padded, m["n_stages"], self._plan, self._table, False,
                nms_mode=m["nms_mode"], nms_min_neighbors=m["nms_min_neighbors"],
                vertically_enlarge=m["vertically_enlarge"], nms_eps=m["nms_eps"],
            )

        def saturated(result, rung):
            return casc.CascadeDetector._is_saturated(result.n_survivors_per_stage, rungs[rung])

        result, rung = casc.climb_ladder(run(0), 0, range(1, len(rungs)), run, saturated)
        if not saturated(result, rung):
            return result
        if not self._warned:
            log.log(
                "WARNING: cascade stage saturated the bundle's top capacity rung; "
                "excess windows were dropped. Export with more rungs (n_rungs) or "
                "larger capacities."
            )
            self._warned = True
        return result

    def detect_batch(self, images: Sequence[np.ndarray]) -> List[DetectionResult]:
        return [self.detect(image) for image in images]
