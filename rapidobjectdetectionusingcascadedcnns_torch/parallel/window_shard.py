"""One image's windows sharded over a mesh (counterpart of
parallel/window_shard.py of the JAX package).

Frame sharding (``CascadeDetector(mesh=)``) scales many streams; this
module scales one image's latency: the dense pyramid's window batch is split
over the mesh, which pays at FDDB density (scale factor 1.005: about 130k
windows in a 450x450 image).

  * stage 0 scores each shard's windows on its device, against the frame
    and weights copied there. Crop mode resamples the shard's boxes with K1
    (the JAX package routes its scheduled kernels to the v1 kernel here:
    K2's schedule covers the whole plan, not a shard of it). Gather mode
    extracts the whole window tensor on mesh device 0, as the single-device
    path does, pads it to a mesh multiple and splits it;
  * compaction is global: each stage's per-window (probability,
    bottleneck) come back to mesh device 0 (the explicit all-gather of the
    JAX module), ``models/cascade._compact_indices`` selects the survivors
    there into capacities padded to a mesh multiple, and the survivors are
    split again for the next stage, whose re-extraction is K1's (never K4:
    the JAX package sends ``pallas2dyn`` to its v1 kernel on this path).

Every window's arithmetic is the single-device path's, so survivors, window
ids and boxes equal ``detector.detect``'s; a stage CNN's matrix products
see other row counts than there, which can move a confidence by an ulp.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import config as cf
from ..models import cascade as casc
from ..ops.windows import extract_windows, to_planes_bf16
from ..utils.device import upload
from . import mesh as mesh_mod


def pad_len(n: int, d: int) -> int:
    return ((n + d - 1) // d) * d


def cascade_infer_window_sharded(
    stage0,
    stage,
    coords_norm: torch.Tensor,
    n0: int,
    n_stages: int,
    capacities: Sequence[int],
    confidence_mode: str,
    thresholds: Sequence[float],
    mesh: mesh_mod.Mesh,
    compaction: str = "rank",
) -> torch.Tensor:
    """One image's cascade with its window axis split over ``mesh``.

    ``stage0(k)``: shard k's stage-0 (probs (m, 2), bottleneck (m, F)) of
    its rows of the ``n0`` windows padded to a mesh multiple;
    ``stage(i, k, boxes, bottleneck)``: stage i's (foreground probs (m,),
    bottleneck (m, F')) of shard k's (m, 4) boxes and (m, F) incoming
    bottleneck, both on its device. The live path and a window-sharded
    bundle give their own. ``coords_norm`` (N0, 4) int64 on mesh device 0;
    ``capacities`` already mesh multiples. Every shard of a stage is
    enqueued before any result is gathered on mesh device 0, where the
    compaction runs. Returns the packed row of
    ``models/cascade.pack_result`` (1, row) on mesh device 0, with zero K4
    overflows."""
    dev0 = mesh[0]
    n0_pad = pad_len(n0, mesh.size)

    def each_shard(fn):
        out = []
        for k, device in enumerate(mesh):
            with mesh_mod.on_device(device):
                out.append(fn(k))
        return out

    parts = each_shard(stage0)
    probs0 = mesh_mod.gather(mesh, [p for p, _ in parts])
    bottleneck = mesh_mod.gather(mesh, [b for _, b in parts])
    p_fg = probs0[:, 1]
    alive = (p_fg > thresholds[0]) & (torch.arange(n0_pad, device=dev0) < n0)
    conf = p_fg
    window_ids = torch.arange(n0_pad, device=dev0)
    survivors = [alive.sum()]

    for i in range(1, n_stages):
        keep, alive = casc._compact_indices(alive[None], p_fg[None], capacities[i - 1],
                                            compaction)
        keep, alive = keep[0], alive[0]
        conf, window_ids, bottleneck = conf[keep], window_ids[keep], bottleneck[keep]
        boxes = coords_norm[torch.clamp(window_ids, max=n0 - 1)].float()
        rows = mesh_mod.split_rows(capacities[i - 1], mesh)
        parts = each_shard(lambda k: stage(i, k, boxes[rows[k]].to(mesh[k]),
                                           bottleneck[rows[k]].to(mesh[k])))
        p_i = mesh_mod.gather(mesh, [p for p, _ in parts])
        bottleneck = mesh_mod.gather(mesh, [b for _, b in parts])
        alive = alive & (p_i > thresholds[i])
        if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
            conf = conf + p_i
        elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
            conf = conf * p_i
        else:
            conf = p_i
        p_fg = p_i
        survivors.append(alive.sum())

    if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
        conf = conf / n_stages
    elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
        conf = torch.clamp(conf, min=cf.MIN_SCORE_FOR_FINAL_CONFIDENCE_CALCULATION_MULT)
    diagnostics = torch.stack(survivors + [torch.zeros_like(survivors[0])] * (n_stages - 1))
    return casc.pack_result(window_ids[None], conf[None], alive[None], diagnostics[None])


def shard_stage0(frame: torch.Tensor, boxes0_or_wins0: torch.Tensor, plan, params, cfg, stats,
                 chunk: int, extraction_mode: str, high_precision: bool, planes=None):
    """Stage 0 of one shard's rows on their device: in crop mode its (m, 4)
    window boxes resampled from the (1, H, W, C) float32 frame by K1; in
    gather mode its (m, s, s, C) rows of the window tensor. Returns (probs
    (m, 2), bottleneck (m, F))."""
    if extraction_mode == "gather":
        return casc._apply_stage_rows(params, cfg, boxes0_or_wins0, None, *stats, chunk)
    probs, bneck, _, _ = casc._stage0_apply(
        frame, boxes0_or_wins0, plan, params, cfg, *stats, chunk, "crop", "pallas",
        high_precision, None, planes,
    )
    return probs[0], bneck[0]


def shard_stage(frame: torch.Tensor, boxes: torch.Tensor, bottleneck: torch.Tensor, params, cfg,
                stats, chunk: int, high_precision: bool, planes=None, *, stage: int):
    """Stage ``stage`` over one shard's (m, 4) boxes, re-extracted by K1
    from the (1, H, W, C) float32 frame. Returns (foreground probs (m,),
    bottleneck (m, F'))."""
    p, bneck, _, _ = casc.stage_on_boxes(frame, planes, boxes[None], bottleneck[None], params, cfg,
                                         stats, "pallas", high_precision, chunk, stage)
    return p[0], bneck[0]


def padded_capacities(capacities: Sequence[int], n_dev: int) -> List[int]:
    return [pad_len(int(c), n_dev) for c in capacities]


def detect_window_sharded(detector: "casc.CascadeDetector", image: np.ndarray,
                          mesh) -> "casc.DetectionResult":
    """Run ``detector``'s model on one (H, W, 3) uint8 image with its window
    axis split over ``mesh`` (a ``parallel.mesh.Mesh`` or a tuple of
    devices); returns the ``DetectionResult`` of ``detector.detect(image)``,
    saturation re-dispatch included: a saturated stage re-runs the image
    with doubled capacities (bounded retries); with
    ``cascade_saturation_redispatch`` off it warns and keeps the truncated
    result. NMS runs on the host."""
    from ..serve import unpack_packed_row
    from ..utils import log

    mesh = mesh_mod.as_mesh(mesh)
    img_h, img_w = image.shape[0], image.shape[1]
    entry = detector._plan_and_table(img_h, img_w)
    plan, table = entry[0], entry[1]
    if plan.n_windows < 1:
        raise ValueError("Could not extract any windows from the given image")
    n_stages = detector.model.n_nets
    configs = detector.model.stage_configs
    capacities = list(
        detector._capacity_override
        or casc.default_capacity_schedule(plan.n_windows, n_stages)
    )
    mode = casc.resolve_extraction_mode(plan)
    casc.resolve_resample_impl()  # refuse an unported choice before any upload
    high_precision = bool(cf.get("inference_high_precision"))
    chunk = int(cf.get("inference_chunk_size"))
    coords_norm, boxes_float, indices = detector._tables_on(entry, mesh[0], mode)
    copies = {d: upload([image], d).float() for d in mesh.distinct}
    frames = [copies[d] for d in mesh]
    planes = {d: None if high_precision else to_planes_bf16(copies[d]) for d in mesh.distinct}
    shards = list(zip(
        mesh_mod.replicate(mesh, detector._params_device),
        mesh_mod.replicate(mesh, detector._stats_device),
    ))
    if mode == "gather":
        # the whole window tensor on mesh device 0, in the single-device order
        rows0 = extract_windows(frames[0], plan, indices)[0]
    else:
        rows0 = boxes_float
    rows0, _ = mesh_mod.pad_to_multiple(rows0, mesh.size)
    split0 = mesh_mod.split_rows(rows0.shape[0], mesh)

    def stage0(k):
        params, stats = shards[k]
        return shard_stage0(frames[k], rows0[split0[k]].to(mesh[k]), plan, params[0], configs[0],
                            stats[0], chunk, mode, high_precision, planes[mesh[k]])

    def stage(i, k, boxes, bottleneck):
        params, stats = shards[k]
        return shard_stage(frames[k], boxes, bottleneck, params[i], configs[i], stats[i], chunk,
                           high_precision, planes[mesh[k]], stage=i)

    def run(caps):
        caps = padded_capacities(caps, mesh.size)
        packed = cascade_infer_window_sharded(
            stage0, stage, coords_norm, plan.n_windows, n_stages, caps,
            cf.get("final_confidence_calculation"), tuple(casc.resolve_thresholds(n_stages)),
            mesh, casc.resolve_compaction(),
        )
        return unpack_packed_row(
            packed.cpu().numpy()[0], caps, n_stages, plan, table, False,
            nms_mode=str(cf.get("nms")),
            nms_min_neighbors=int(cf.get("nms_opencv_min_neighbors")),
            nms_eps=float(cf.get("nms_opencv_eps")),
            vertically_enlarge=bool(cf.get("vertically_enlarge_bboxes")),
        )

    result = run(capacities)
    if not detector._is_saturated(result.n_survivors_per_stage, capacities):
        return result
    if not cf.get("cascade_saturation_redispatch"):
        log.log(
            "WARNING: a cascade stage saturated its survivor capacity on the "
            "window-sharded path; excess windows were dropped by confidence "
            "ranking (cascade_saturation_redispatch is off)."
        )
        return result

    def escalate(caps):
        log.log(
            "WARNING: window-sharded cascade saturated; re-dispatching with "
            "capacities {}".format(caps)
        )
        detector.redispatches += 1
        return run(caps)

    ladder = casc.capacity_ladder(capacities, plan.n_windows,
                                  int(cf.get("cascade_saturation_max_retries")))
    return casc.climb_ladder(
        result, capacities, ladder, escalate,
        lambda res, caps: detector._is_saturated(res.n_survivors_per_stage, caps),
    )[0]
