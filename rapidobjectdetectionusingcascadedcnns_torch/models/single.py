"""Single-net sliding-window detector, no cascade (counterpart of
models/single.py).

The reference's ``InferenceApp`` path (app/inference_app.py:117-154):
classify every pyramid window with one CNN, keep windows whose argmax is
foreground (confidence = max softmax), then NMS on the host. Stage 0 is the
cascade's (``cascade._stage0_apply``): gather mode for coarse pyramids,
crop mode for dense ones, with kernel K2 over the plan's schedule. K2's rows
come back in scheduled order with replicated pads; the host maps them to
plan order through the schedule's ``ids`` and ``valid``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cf
from ..ops.pyramid import build_plan, window_table
from ..serve import postprocess_raw
from ..utils.device import resolve_device, set_numerics, upload
from . import cnn
from .cascade import (
    DetectionResult,
    _apply_stage_rows,
    _stage0_apply,
    _stage0_schedule,
    read_back_pipelined,
    resolve_extraction_mode,
    resolve_resample_impl,
)


class SingleNetDetector:
    """Full-image detection with one stage CNN, on ``device`` (default: the
    CUDA card; ``"cpu"`` for the CPU)."""

    def __init__(
        self,
        params: cnn.Params,
        stage_config: cnn.StageConfig,
        mean: np.ndarray,
        std: np.ndarray,
        device=None,
    ):
        self.device = resolve_device(device)
        self.stage_config = stage_config
        set_numerics(stage_config.compute_dtype)
        moved = cnn.tree_map(lambda t: t.to(self.device), params)
        self.params = cnn.cast_params(moved, stage_config)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=self.device)
        self._plan_cache: Dict[tuple, tuple] = {}

    # keyed by the pyramid config too, so a change of min_window_length or
    # window_scale_factor between detects never serves a stale plan
    def _plan_and_table(self, img_h: int, img_w: int):
        size = self.stage_config.input_size
        mwl = float(cf.get("min_window_length"))
        wsf = float(cf.get("window_scale_factor"))
        key = (img_h, img_w, size, mwl, wsf)
        cached = self._plan_cache.get(key)
        if cached is None:
            plan = build_plan(img_h, img_w, size, size, mwl, wsf)
            table = window_table(plan)
            cached = (plan, table, torch.as_tensor(table["boxes_float"], device=self.device))
            if len(self._plan_cache) >= 128:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[key] = cached
        return cached

    def detect(self, image: np.ndarray) -> DetectionResult:
        return self.detect_batch([image])[0]

    def detect_batch(self, images: Sequence[np.ndarray]) -> List[DetectionResult]:
        """Same-size frames go through stage 0 together, in chunks of
        ``inference_batch_frames`` pipelined as the cascade's
        (:func:`~.cascade.read_back_pipelined`): every chunk of a size is
        enqueued and read back before the first host NMS."""
        results: List[Optional[DetectionResult]] = [None] * len(images)
        by_size: Dict[Tuple[int, int], List[int]] = {}
        for i, img in enumerate(images):
            by_size.setdefault((img.shape[0], img.shape[1]), []).append(i)

        for (img_h, img_w), idxs in by_size.items():
            plan, table, boxes_float = self._plan_and_table(img_h, img_w)
            if plan.n_windows < 1:
                raise ValueError("Could not extract any windows from the given image")
            sched = self._schedule(plan)

            def dispatch(chunk):
                frames = upload([images[i] for i in chunk], self.device)
                return self._infer(frames, plan, boxes_float)

            for chunk, packed in read_back_pipelined(idxs, dispatch):
                for j, i in enumerate(chunk):
                    results[i] = self._unpack_row(packed[j], plan, table, sched)
        return results  # type: ignore[return-value]

    def _schedule(self, plan):
        """The K2 schedule that stage 0 of ``plan`` runs over (crop mode),
        by which :meth:`_unpack_row` maps rows back to plan order; else
        None."""
        if resolve_extraction_mode(plan) != "crop":
            return None
        return _stage0_schedule(plan, self.stage_config.input_size, resolve_resample_impl(), False)

    def _infer(self, frames: torch.Tensor, plan, boxes_float: torch.Tensor,
               chunk: Optional[int] = None) -> torch.Tensor:
        """(B, H, W, C) frames on the device -> packed (B, 2 M) float32
        rows [fg_mask (M), confidence (M)], enqueued and not synchronised
        (the JAX ``_single_infer_batch``); ``chunk`` is the windows a CNN
        call takes (default ``inference_chunk_size``)."""
        chunk = int(cf.get("inference_chunk_size")) if chunk is None else int(chunk)
        probs, _, _, valid = _stage0_apply(
            frames.float(), boxes_float, plan, self.params, self.stage_config,
            self.mean, self.std, chunk, resolve_extraction_mode(plan),
            resolve_resample_impl(), False,
        )
        fg = torch.argmax(probs, dim=2) == 1
        if valid is not None:
            fg = fg & valid
        conf = probs.max(dim=2).values
        return torch.cat([fg.float(), conf], dim=1)

    @staticmethod
    def _unpack_row(row: np.ndarray, plan, table, sched) -> DetectionResult:
        """One frame's [fg_mask (M), confidence (M)] row: scheduled rows
        mapped back to plan window order, then NMS on the host."""
        n = plan.n_windows
        m = row.shape[0] // 2
        fg_rows = row[:m] > 0.5
        conf_rows = row[m:]
        if sched is not None:
            fg = np.zeros(n, bool)
            conf = np.zeros(n, np.float32)
            fg[sched.ids[sched.valid]] = fg_rows[sched.valid]
            conf[sched.ids[sched.valid]] = conf_rows[sched.valid]
        else:
            fg, conf = fg_rows, conf_rows
        raw_boxes = table["coords_norm"][fg]
        raw_conf = conf[fg]
        boxes, confs = postprocess_raw(
            raw_boxes,
            raw_conf,
            nms_mode=str(cf.get("nms")),
            nms_min_neighbors=int(cf.get("nms_opencv_min_neighbors")),
            nms_eps=float(cf.get("nms_opencv_eps")),
            vertically_enlarge=bool(cf.get("vertically_enlarge_bboxes")),
        )
        return DetectionResult(
            boxes=boxes,
            confidences=confs,
            raw_boxes=raw_boxes,
            raw_confidences=raw_conf,
            n_windows=n,
            n_survivors_per_stage=[int(fg.sum())],
            raw_window_ids=np.nonzero(fg)[0],
        )

    def classify_patches(self, patches: np.ndarray) -> np.ndarray:
        """Foreground probabilities of pre-extracted (N, s, s, 3) patches
        (the reference's ``run_inference_on_raw_data``,
        app/inference_app.py:156-166)."""
        x = torch.as_tensor(np.asarray(patches), device=self.device)
        probs, _ = _apply_stage_rows(
            self.params, self.stage_config, x, None, self.mean, self.std,
            int(cf.get("inference_chunk_size")),
        )
        return probs[:, 1].cpu().numpy()
