"""Inference applications (counterpart of the JAX package's
``apps/inference_apps.py``).

Re-design of the reference inference app family:
  * :class:`AbstractInferenceApp` — the batch-of-images runner with runtime
    stat logging (app/abstract_inference_app.py:38-154). "merge" maps to
    batched frames per detector call.
  * :class:`InferenceApp` — single pretrained net
    (app/inference_app.py:24-300).
  * :class:`InferenceCascadeApp` — pretrained cascade discovered by probing
    per-stage artifacts (app/inference_cascade_app.py:36-60).
  * :class:`InferenceOCVApp` — the OpenCV Viola-Jones baseline
    (app/inference_ocv_app.py:35-61), on the host.

Every CNN app runs on ``device`` (default: the CUDA card; ``"cpu"`` for the
CPU), resolved when the app is made, so an app asked for the card on a host
without one raises at once. The Viola-Jones baseline runs on the host by
design (SURVEY.md §2.7) and takes no device.

Deliberate difference from the JAX package: in non-merge mode the JAX app
catches every exception of an image's detection and returns an empty result
for it (its inference_apps.py:91-95). Here only the image read is isolated
per image (an unreadable file gives an empty result); an error in detection
propagates, so a kernel that fails to build or launch is never reported as
"no faces".
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence

import numpy as np

from .. import config as cf
from ..data.image_io import DECODE_ERRORS
from ..models import bridge
from ..models.cascade import CascadeDetector, DetectionResult
from ..models.single import SingleNetDetector
from ..utils import log
from ..utils.device import resolve_device
from ..utils.time_watcher import TimeWatcher
from .base import BaseApp


def empty_result() -> DetectionResult:
    """The result of an image that could not be read."""
    return DetectionResult(
        boxes=np.zeros((0, 4)),
        confidences=np.zeros((0,)),
        raw_boxes=np.zeros((0, 4)),
        raw_confidences=np.zeros((0,)),
        n_windows=0,
        n_survivors_per_stage=[],
    )


class AbstractInferenceApp(BaseApp):
    """Common runner: images -> per-image detections, with runtime stats."""

    def __init__(self, device=None):
        BaseApp.__init__(self, run_now=False)
        self.device = resolve_device(device)

    def _main(self):
        pass

    @abc.abstractmethod
    def run_inference_on_image(self, image: np.ndarray) -> DetectionResult:
        ...

    @abc.abstractmethod
    def run_inference_on_images_impl(
        self, images: Sequence[np.ndarray]
    ) -> List[DetectionResult]:
        ...

    def run_inference_on_images(
        self, images: Sequence, merge: bool = True
    ) -> List[DetectionResult]:
        """images: arrays or ImageInfo objects. ``merge`` batches frames into
        fused detector calls; non-merge processes strictly per image
        (abstract_inference_app.py:107-126). An image that cannot be read
        gives an empty result; a detection error raises."""
        arrays: List[Optional[np.ndarray]] = []
        for img in images:
            if hasattr(img, "raw_original"):
                try:
                    arrays.append(img.raw_original())
                except DECODE_ERRORS as exc:
                    log.log(" .. Skipped {}: {}".format(getattr(img, "path_original", "?"), exc))
                    arrays.append(None)
            else:
                arrays.append(np.asarray(img))

        timer = TimeWatcher("inference_img_multiple: {} imgs".format(len(arrays)), quiet=True)
        if merge:
            valid = [(i, a) for i, a in enumerate(arrays) if a is not None]
            results: List[DetectionResult] = [empty_result() for _ in arrays]
            if valid:
                out = self.run_inference_on_images_impl([a for _, a in valid])
                for (i, _), res in zip(valid, out):
                    results[i] = res
        else:
            results = [
                empty_result() if a is None else self.run_inference_on_image(a)
                for a in arrays
            ]

        total = timer.stop()
        log.log(
            "Runtime inference including window extraction: {} images in {} "
            "(avg: {}).".format(
                len(arrays),
                TimeWatcher.seconds_to_str(total),
                TimeWatcher.seconds_to_str(total / max(len(arrays), 1)),
            )
        )
        return results


class InferenceApp(AbstractInferenceApp):
    """Single-net inference from an exported model artifact."""

    def __init__(self, model_session_key: Optional[str] = None, device=None):
        super().__init__(device)
        self.model_session_key = model_session_key or cf.get(
            "default_evaluation_model_single"
        )
        log.log("Initializing inference app with the following settings:")
        log.log(" - pre-trained model: {}".format(self.model_session_key))
        log.log(" - min_window_length: {}".format(cf.get("min_window_length")))
        log.log(" - window_scale_factor: {}".format(cf.get("window_scale_factor")))
        log.log(" - nms: {}".format(cf.get("nms")))
        log.log(" - device: {}".format(self.device))
        self._detector: Optional[SingleNetDetector] = None

    @property
    def detector(self) -> SingleNetDetector:
        if self._detector is None:
            params, cfg, mean, std, _ = bridge.load_single(
                cf.get("output_graph_dir"), self.model_session_key, self.device
            )
            self._detector = SingleNetDetector(params, cfg, mean, std, self.device)
            # input dims come from the artifact, like the reference derives
            # them from graph tensor shapes (inference_app.py:276-295)
            cf.set("img_width", cfg.input_size)
            cf.set("img_height", cfg.input_size)
        return self._detector

    def run_inference_on_image(self, image):
        return self.detector.detect(image)

    def run_inference_on_images_impl(self, images):
        return self.detector.detect_batch(list(images))

    def run_inference_on_raw_data(self, raw_data: np.ndarray) -> np.ndarray:
        """Classify pre-extracted patches (inference_app.py:156-166)."""
        return self.detector.classify_patches(raw_data)


class InferenceCascadeApp(AbstractInferenceApp):
    """Cascade inference from exported per-stage artifacts, or from a
    ``CascadeModel`` in memory (moved to the app's device)."""

    def __init__(self, model_session_key: Optional[str] = None, model=None, device=None):
        super().__init__(device)
        self.model_session_key = model_session_key or cf.get(
            "default_evaluation_model_cascade"
        )
        self._model = model
        self._detector: Optional[CascadeDetector] = None

    @property
    def detector(self) -> CascadeDetector:
        if self._detector is None:
            if self._model is None:
                model = bridge.load_cascade(
                    cf.get("output_graph_dir"), self.model_session_key, self.device
                )
            else:
                model = self._model.to(self.device)
            log.log("the loaded cascade contains {} nets".format(model.n_nets))
            self._detector = CascadeDetector(model)
            cf.set("img_width", model.input_sizes[-1])
            cf.set("img_height", model.input_sizes[-1])
        return self._detector

    def run_inference_on_image(self, image):
        return self.detector.detect(image)

    def run_inference_on_images_impl(self, images):
        return self.detector.detect_batch(list(images))


class InferenceOCVApp(AbstractInferenceApp):
    """OpenCV Viola-Jones baseline (app/inference_ocv_app.py:35-61).

    Baseline-only and host-only, like the JAX package's (SURVEY.md §2.7):
    cv2's CascadeClassifier when this build has objdetect, otherwise the
    port's in-repo evaluator (ops/viola_jones.py) runs the same pretrained
    XML.
    """

    def __init__(self, cascade_xml_path: Optional[str] = None):
        super().__init__("cpu")
        from ..ops import viola_jones as vj

        self._classifier = None
        try:
            import cv2

            if hasattr(cv2, "CascadeClassifier"):
                path = vj.default_cascade_path(cascade_xml_path)
                if path:
                    self._classifier = cv2.CascadeClassifier(path)
        except ImportError:  # cv2 is optional
            pass
        if self._classifier is None:
            self._classifier = vj.VJDetector(cascade_xml_path)

    def run_inference_on_image(self, image):
        from ..ops import viola_jones as vj

        gray = vj.rgb_to_gray_u8(image)
        rects = self._classifier.detectMultiScale(
            gray,
            scaleFactor=cf.get("window_scale_factor"),
            minNeighbors=cf.get("nms_opencv_min_neighbors"),
        )
        if len(rects) == 0:
            boxes = np.zeros((0, 4))
        else:
            rects = np.asarray(rects, np.float64)
            boxes = np.stack(
                [rects[:, 0], rects[:, 1], rects[:, 0] + rects[:, 2], rects[:, 1] + rects[:, 3]],
                axis=1,
            )
        conf = np.ones((len(boxes),))
        return DetectionResult(boxes, conf, boxes, conf, 0, [])

    def run_inference_on_images_impl(self, images):
        # non-merge only, like the reference forces (inference_ocv_app.py:26)
        return [self.run_inference_on_image(img) for img in images]
