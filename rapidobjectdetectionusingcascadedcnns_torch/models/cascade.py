"""Cascade inference: multi-stage early reject over window batches
(counterpart of models/cascade.py, restricted to the ported path).

Per chunk of same-size frames, every stage runs once for all frames:

  stage 0:  pyramid resize + dense window gather (ops/windows.py, gather
            mode) -> stage CNN over all windows -> foreground probs
  between:  compaction -- survivors move to the front of a fixed-capacity
            buffer ("scan": cumsum + searchsorted, window order; "rank":
            stable argsort on (alive, strength)); the next stage's windows
            are re-extracted from the full frame by kernel K1
            (ops/windows_cuda.py), one launch per stage for the whole chunk
  stage i:  CNN with the previous stage's bottleneck concat -> probs ->
            alive mask and LAST/AVG/MULT confidence accumulation
  last:     one packed float32 row per frame leaves the device; NMS runs on
            the host (shared numpy/native groupRectangles).

Capacities are fixed per dispatch; a frame whose survivors overflow a buffer
is re-run alone with doubled capacities (saturation re-dispatch), so the
result equals the reference's unbounded survivor sets.

Not ported yet, and raising ``NotImplementedError`` rather than being
rerouted: crop-mode extraction (dense pyramids, ROADMAP Queue A item 7,
kernel K2), the on-device NMS tail (item 6, kernel K3), meshes (item 11)
and the dynamic row-bounded re-extraction (kernel K4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops.pyramid import (
    PyramidPlan,
    build_plan,
    window_table,
)

from .. import config as cf
from ..ops.color import yuv420_to_rgb
from ..ops.windows import crop_and_resize_impl, extract_windows, level_indices
from ..utils.device import resolve_device, set_numerics
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
        return self.stage_params[0]["fc1"]["W"].device

    def to(self, device) -> "CascadeModel":
        """A copy with every parameter on ``device``."""
        device = resolve_device(device)

        def move(p):
            return {
                "conv": [{k: v.to(device) for k, v in layer.items()} for layer in p["conv"]],
                "fc1": {k: v.to(device) for k, v in p["fc1"].items()},
                "fc2": {k: v.to(device) for k, v in p["fc2"].items()},
            }

        return CascadeModel(
            [move(p) for p in self.stage_params],
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
    # per-re-extract overflow counts; always 0 here (only the dynamic
    # row-bounded kernel K4, not ported yet, can overflow)
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


def _check_ported_path() -> None:
    """Refuse configurations whose path is not ported yet."""
    if cf.get("nms_on_device") and cf.get("nms") == cf.NMS_OPENCV:
        raise NotImplementedError(
            "nms_on_device: the on-device NMS tail is not ported yet "
            "(ROADMAP Queue A item 6, kernel K3)"
        )
    if cf.get("use_pallas_resample") == "pallas2dyn" or cf.get("dyn_reextract") == "on":
        raise NotImplementedError(
            "dynamic row-bounded re-extraction is not ported yet (ROADMAP "
            "Queue B, kernel K4)"
        )


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
    """Standardize (R, s, s, C) windows and run the stage CNN over row
    chunks of at most ``chunk`` (bounds the conv intermediates)."""
    probs, bnecks = [], []
    for s in range(0, x.shape[0], chunk):
        xc = (x[s : s + chunk] - mean) / std
        bc = None if bneck_in is None else bneck_in[s : s + chunk]
        out = cnn.apply_stage(params, cfg, xc, bc)
        probs.append(out["probs"])
        bnecks.append(out["bottleneck"])
    return torch.cat(probs), torch.cat(bnecks)


def cascade_core(
    images: torch.Tensor,
    coords_norm: torch.Tensor,
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
):
    """Full cascade over a chunk of frames (gather-mode stage 0).

    ``images`` (B, H, W, C) float32; ``coords_norm`` (N0, 4) int64 window
    boxes on the original image. Returns ``window_ids`` (B, C_last) int64,
    ``conf`` (B, C_last) f32, ``alive`` (B, C_last) bool and
    ``diagnostics`` (B, 2 * n_stages - 1): per-stage pre-compaction
    survivor counts, then per-re-extract overflow counts (always 0).
    """
    n_stages = len(stage_configs)
    b = images.shape[0]
    images = images.float()

    size0 = stage_configs[0].input_size
    windows = extract_windows(images, plan, indices)  # (B, N0, s0, s0, C)
    n0 = windows.shape[1]
    mean0, std0 = stage_stats[0]
    probs0, bneck0 = _apply_stage_rows(
        stage_params[0], stage_configs[0],
        windows.reshape(b * n0, size0, size0, -1), None, mean0, std0, chunk,
    )
    p_fg = probs0[:, 1].reshape(b, n0)
    bottleneck = bneck0.reshape(b, n0, -1)
    alive = p_fg > thresholds[0]
    conf = p_fg
    window_ids = torch.arange(n0, device=images.device).expand(b, n0)
    survivors = [alive.sum(dim=1)]
    overflows = []

    for i in range(1, n_stages):
        cap = capacities[i - 1]
        keep, alive = _compact_indices(alive, p_fg, cap, compaction)
        conf = torch.gather(conf, 1, keep)
        window_ids = torch.gather(window_ids, 1, keep)
        bottleneck = torch.gather(
            bottleneck, 1, keep[:, :, None].expand(b, cap, bottleneck.shape[2])
        )
        cfg_i = stage_configs[i]
        size_i = cfg_i.input_size
        boxes = coords_norm[window_ids].float()  # (B, cap, 4)
        wins = crop_and_resize_impl(images, boxes, size_i, size_i, high_precision)
        mean_i, std_i = stage_stats[i]
        bneck_in = (
            bottleneck.reshape(b * cap, -1) if cfg_i.bottleneck_in_size is not None else None
        )
        probs_i, bneck_i = _apply_stage_rows(
            stage_params[i], cfg_i, wins.reshape(b * cap, size_i, size_i, -1),
            bneck_in, mean_i, std_i, chunk,
        )
        bottleneck = bneck_i.reshape(b, cap, -1)
        p_i = probs_i[:, 1].reshape(b, cap)
        alive = alive & (p_i > thresholds[i])
        if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
            conf = conf + p_i
        elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
            conf = conf * p_i
        else:  # LAST: only the final net's score matters
            conf = p_i
        p_fg = p_i
        survivors.append(alive.sum(dim=1))
        overflows.append(torch.zeros(b, dtype=torch.long, device=images.device))

    if confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_AVG:
        conf = conf / n_stages
    elif confidence_mode == cf.FINAL_CONFIDENCE_CALCULATION_MULT:
        conf = torch.clamp(conf, min=cf.MIN_SCORE_FOR_FINAL_CONFIDENCE_CALCULATION_MULT)

    diagnostics = torch.stack(survivors + overflows, dim=1)
    return window_ids, conf, alive, diagnostics


def pack_result(window_ids, conf, alive, diagnostics) -> torch.Tensor:
    """One float32 row per frame, so the host reads back one buffer:
    [ids (C), conf (C), alive (C), diagnostics (2 * n_stages - 1)]."""
    return torch.cat(
        [window_ids.float(), conf.float(), alive.float(), diagnostics.float()], dim=1
    )


class CascadeDetector:
    """Host orchestration around :func:`cascade_core`.

    One instance per :class:`CascadeModel`; it runs on the model's device.
    Pyramid plans and their device index tables are cached per image size.
    """

    def __init__(self, model: CascadeModel, capacity_schedule=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device serving is not ported yet (ROADMAP Queue A item 11)"
            )
        if model.n_nets < 2:
            raise ValueError("a cascade must consist of at least two nets")
        self.model = model
        self.device = model.device
        self.redispatches = 0  # saturation re-runs, for diagnostics
        self._saturation_warned = False
        self._plan_cache: Dict[tuple, tuple] = {}
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

    def _plan_and_table(self, img_h: int, img_w: int):
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
        entry = (plan, table, coords_norm, level_indices(plan, self.device))
        if len(self._plan_cache) >= 128:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = entry
        return entry

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

        from rapidobjectdetectionusingcascadedcnns_tpu.data.image_io import resize_rgb

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

    def _run_chunk(self, frames: Sequence, yuv: bool, caps, plan, coords_norm, indices):
        """Upload one chunk of frames and enqueue its cascade; returns the
        packed (B, row) tensor on the device (not yet synchronised)."""
        if yuv:
            y = torch.as_tensor(np.stack([f[0] for f in frames]), device=self.device)
            uv = torch.as_tensor(np.stack([f[1] for f in frames]), device=self.device)
            images = yuv420_to_rgb(y, uv)
        else:
            images = torch.as_tensor(np.stack(frames), device=self.device).float()
        n_stages = self.model.n_nets
        out = cascade_core(
            images,
            coords_norm,
            self._params_device,
            self._stats_device,
            plan,
            self.model.stage_configs,
            tuple(caps),
            cf.get("final_confidence_calculation"),
            tuple(resolve_thresholds(n_stages)),
            bool(cf.get("inference_high_precision")),
            int(cf.get("inference_chunk_size")),
            resolve_compaction(),
            indices,
        )
        return pack_result(*out)

    def _detect_batch_exact(self, images: Sequence, yuv: bool = False) -> List[DetectionResult]:
        """Same-size frames go through one batched cascade per chunk of
        ``inference_batch_frames``; up to ``inference_pipeline_depth`` chunks
        are enqueued before the oldest is read back."""
        _check_ported_path()
        max_frames = int(cf.get("inference_batch_frames"))
        depth = max(1, int(cf.get("inference_pipeline_depth")))
        results: List[Optional[DetectionResult]] = [None] * len(images)

        by_size: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            shape = img[0].shape if yuv else img.shape
            by_size.setdefault((shape[0], shape[1]), []).append(i)

        for (img_h, img_w), idxs in by_size.items():
            plan, table, coords_norm, indices = self._plan_and_table(img_h, img_w)
            if plan.n_windows < 1:
                raise ValueError("Could not extract any windows from the given image")
            if resolve_extraction_mode(plan) == "crop":
                raise NotImplementedError(
                    "crop-mode window extraction (dense pyramids, > 48 levels) is "
                    "not ported yet (ROADMAP Queue A item 7, kernel K2)"
                )
            capacities = tuple(
                self._capacity_override
                or default_capacity_schedule(plan.n_windows, self.model.n_nets)
            )

            def run(frames, caps):
                return self._run_chunk(frames, yuv, caps, plan, coords_norm, indices)

            pending, done = [], []
            for s in range(0, len(idxs), max_frames):
                chunk = idxs[s : s + max_frames]
                pending.append((chunk, run([images[i] for i in chunk], capacities)))
                if len(pending) > depth:
                    c, r = pending.pop(0)
                    done.append((c, r.cpu().numpy()))
            while pending:
                c, r = pending.pop(0)
                done.append((c, r.cpu().numpy()))

            for chunk, packed in done:
                for j, i in enumerate(chunk):
                    result = self._unpack_row(packed[j], capacities, plan, table)
                    if self._is_saturated(
                        result.n_survivors_per_stage, capacities,
                        result.reextract_overflows,
                    ):
                        result = self._handle_saturation(
                            images[i], result, capacities, plan, table, run
                        )
                    results[i] = result
        return results  # type: ignore[return-value]

    def _unpack_row(self, row, capacities, plan, table) -> DetectionResult:
        from ..serve import unpack_packed_row

        return unpack_packed_row(
            row,
            capacities,
            self.model.n_nets,
            plan,
            table,
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

    def _handle_saturation(self, frame, result, capacities, plan, table, run) -> DetectionResult:
        """Re-run the frame alone with doubled capacities (bounded retries)
        so no detection is lost to truncation; with
        ``cascade_saturation_redispatch`` off, warn once and keep the
        truncated result."""
        from rapidobjectdetectionusingcascadedcnns_tpu.utils import log

        if not cf.get("cascade_saturation_redispatch"):
            if not self._saturation_warned:
                log.log(
                    "WARNING: a cascade stage saturated its survivor capacity; "
                    "excess windows were dropped by confidence ranking "
                    "(cascade_saturation_redispatch is off). Consider "
                    "retraining the stage or raising cascade_capacity_schedule."
                )
                self._saturation_warned = True
            return result

        caps = list(capacities)
        for _ in range(int(cf.get("cascade_saturation_max_retries"))):
            new_caps = escalate_capacities(caps, plan.n_windows)
            if new_caps is None:
                break
            caps = new_caps
            log.log(
                "WARNING: cascade stage saturated its survivor capacity; "
                "re-dispatching with capacities {}".format(caps)
            )
            self.redispatches += 1
            packed = run([frame], caps).cpu().numpy()
            result = self._unpack_row(packed[0], caps, plan, table)
            if not self._is_saturated(
                result.n_survivors_per_stage, caps, result.reextract_overflows
            ):
                return result
        return result


def build_cascade_model(
    seed: int = 0,
    n_nets: Optional[int] = None,
    img_size_max: Optional[int] = None,
    device=None,
) -> CascadeModel:
    """Randomly initialized cascade with the configured architecture. The
    weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved, so a seed gives the same weights on every device."""
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
