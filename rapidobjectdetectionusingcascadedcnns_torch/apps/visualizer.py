"""Detection visualization: bbox overlays saved to disk (counterpart of the
JAX package's ``apps/visualizer.py``; the same boxes give the same pixels).

Re-design of ``InferenceVisualizerApp`` (app/inference_visualizer_app.py:37-102):
runs any inference app over images, draws confidence-colored boxes onto
copies and saves them under ``bbox_visualization_dir``. The detection runs
on the inference app's device; drawing and encoding are host numpy and PIL.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from .. import config as cf
from ..utils import log
from .base import BaseApp
from .inference_apps import AbstractInferenceApp


def _confidence_color(conf: float, conf_max: float):
    """Hot-colormap-ish color by relative confidence
    (inference_visualizer_app.py:70-80)."""
    t = min(max(conf / conf_max if conf_max > 0 else 0.0, 0.0), 1.0)
    return (int(255 * min(1.0, 0.3 + t)), int(255 * max(0.0, t - 0.3)), 0)


def draw_detections(image: np.ndarray, boxes, confidences) -> np.ndarray:
    """Return a copy of image with boxes burned in (numpy, 2px borders)."""
    out = image.copy()
    h, w = out.shape[0], out.shape[1]
    conf_max = float(np.max(confidences)) if len(confidences) else 1.0
    for box, conf in zip(boxes, confidences):
        x0, y0, x1, y1 = [int(v) for v in box]
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w - 1, x1), min(h - 1, y1)
        color = _confidence_color(float(conf), conf_max)
        for t in range(2):
            out[y0 + t, x0 : x1 + 1] = color
            out[max(y1 - t, 0), x0 : x1 + 1] = color
            out[y0 : y1 + 1, x0 + t] = color
            out[y0 : y1 + 1, max(x1 - t, 0)] = color
    return out


class InferenceVisualizerApp(BaseApp):
    """Run an inference app and save bbox overlay images."""

    def __init__(
        self,
        inference_app: AbstractInferenceApp,
        images: Sequence,
        run_now: bool = True,
    ):
        self.inference_app = inference_app
        self.images = images
        self.saved_paths: List[str] = []
        BaseApp.__init__(self, run_now)

    def _main(self):
        from PIL import Image

        results = self.inference_app.run_inference_on_images(
            self.images, merge=cf.get("inference_merge")
        )
        out_dir = cf.ensure_dir("bbox_visualization_dir")
        for i, (img, res) in enumerate(zip(self.images, results)):
            array = img.raw_original() if hasattr(img, "raw_original") else np.asarray(img)
            overlay = draw_detections(array, res.boxes, res.confidences)
            name = "{}_{:04d}.png".format(cf.get("session_key"), i)
            path = os.path.join(out_dir, name)
            Image.fromarray(overlay).save(path)
            self.saved_paths.append(path)
        log.log("saved {} bbox visualizations to {}".format(len(self.saved_paths), out_dir))
