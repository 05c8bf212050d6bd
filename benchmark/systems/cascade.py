"""The system under test for configurations of ``"system": "cascade"``: the
port's ``CascadeDetector``, given the benchmark's weights and the
calibrated thresholds, called through the entry a traffic file names.

What the benchmark reads from the program: each frame's detections
(``DetectionResult``: final windows, confidences, boxes, survivors per
stage), the detector's re-dispatch count, and the host time of
``serve.postprocess_raw`` (host NMS), timed by a spy on it.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

# the configuration's keys that the detector reads from its configuration
DETECTOR_KEYS = ("window_scale_factor", "min_window_length", "nms", "nms_opencv_min_neighbors",
                 "nms_opencv_eps", "final_confidence_calculation", "compute_dtype")
ENTRIES = ("detect_batch_yuv420", "detect")


def build_kernels(device) -> None:
    """Build the port's CUDA kernels and its host NMS library (set-up; a
    checkout's first run compiles, later runs find them built)."""
    from rapidobjectdetectionusingcascadedcnns_torch import native
    from rapidobjectdetectionusingcascadedcnns_torch.ops import _build

    native.available()
    if device.type == "cuda":
        _build.build()


class Program:
    """The detector, set up for one cell."""

    def __init__(self, config: dict, traffic: dict, stages: List[dict],
                 thresholds: List[float], device):
        import torch

        from rapidobjectdetectionusingcascadedcnns_torch import config as cf, serve
        from rapidobjectdetectionusingcascadedcnns_torch.models import cascade, cnn

        self.serve = serve
        cf.reset()
        for key in DETECTOR_KEYS:
            cf.set(key, config[key])
        for key, value in traffic.get("detector", {}).items():
            cf.set(key, value)
        cf.set("foreground_confidence_threshold", [float(t) for t in thresholds])
        dtype = torch.bfloat16 if config["compute_dtype"] == "bfloat16" else torch.float32
        params, configs, means, stds = [], [], [], []
        for st in stages:
            s = st["size"]
            if st["kind"] == "inception":
                params.append({"backbone": {"v3": st["params"]["trunk"]},
                               "fc2": st["params"]["fc2"]})
                configs.append(cnn.StageConfig(input_size=s, bottleneck_in_size=st["bneck_in"],
                                               compute_dtype=dtype, backbone="inception"))
            else:
                params.append(st["params"])
                configs.append(cnn.StageConfig(
                    input_size=s, conv_filter_sizes=tuple(config["conv_filter_sizes"]),
                    conv_kernel=config["conv_filter_size"], conv_stride=config["conv_stride"],
                    pooling_size=config["pooling_size"],
                    pooling_stride=config["pooling_stride"], fc1_size=config["fc1_size"],
                    bottleneck_in_size=st["bneck_in"], compute_dtype=dtype))
            means.append(np.full((s, s, 3), st["mean"], np.float32))
            stds.append(np.full((s, s, 3), st["std"], np.float32))
        self.detector = cascade.CascadeDetector(
            cascade.CascadeModel(params, configs, means, stds))
        entry = traffic["entry"]
        if entry not in ENTRIES:
            raise ValueError("unknown entry {!r}".format(entry))
        self.entry = entry
        self.nms_s = 0.0
        real = self.serve.postprocess_raw

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.nms_s += time.perf_counter() - t0

        self._real_postprocess = real
        self.serve.postprocess_raw = timed

    @property
    def redispatches(self) -> int:
        return self.detector.redispatches

    def __call__(self, payload) -> List[dict]:
        """One request: the detector's answer for each frame, on the host."""
        if self.entry == "detect":
            results = [self.detector.detect(f) for f in payload]
        else:
            results = self.detector.detect_batch_yuv420(payload)
        return [{"ids": np.asarray(r.raw_window_ids, np.int64),
                 "conf": np.asarray(r.raw_confidences, np.float64),
                 "boxes": np.asarray(r.boxes, np.float64).reshape(-1, 4),
                 "counts": [int(c) for c in r.n_survivors_per_stage]} for r in results]

    def close(self) -> None:
        """Undo the spy and drop the detector (its weights and tables)."""
        self.serve.postprocess_raw = self._real_postprocess
        self.detector = None
