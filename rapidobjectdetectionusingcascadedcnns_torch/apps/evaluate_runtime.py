"""Runtime benchmark: cascade vs single net, per device (counterpart of the
JAX package's ``apps/evaluate_runtime.py``).

Re-design of ``EvaluateRuntimeApp`` (app/evaluate_runtime_app.py:50-97). The
reference compared {cascade, single} x {GPU, CPU}; pass
``compare_platforms=["cuda", "cpu"]`` and the app benchmarks both families
on each device in turn, results keyed ``cascade@cuda``, ``single@cpu`` and so
on. Where the JAX app re-initialises its backend per platform, the port
moves the model (``CascadeModel.to``) and rebuilds the single-net detector
on each device. Without ``compare_platforms`` both families run on
``device`` (default: the CUDA card; ``"cpu"`` for the CPU), keyed
``cascade`` and ``single``. Images default to a synthetic sampled set (80
positive scenes / 20 background scenes), or a pos/neg sample of the
configured disk corpus.

Each family runs the image set once to warm (kernel builds, plan and
schedule caches, cuDNN's algorithm choice), then once timed, with the card
synchronised before each clock read.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import config as cf
from ..utils import log
from ..utils.device import resolve_device
from .base import BaseApp
from .inference_apps import InferenceApp, InferenceCascadeApp


class EvaluateRuntimeApp(BaseApp):
    def __init__(
        self,
        cascade_session_key: Optional[str] = None,
        single_session_key: Optional[str] = None,
        n_positive: int = 80,
        n_negative: int = 20,
        images: Optional[Sequence[np.ndarray]] = None,
        cascade_model=None,
        single_detector=None,
        compare_platforms: Optional[Sequence[str]] = None,
        run_now: bool = True,
        device=None,
    ):
        self.cascade_session_key = cascade_session_key
        self.single_session_key = single_session_key
        self.n_positive = n_positive
        self.n_negative = n_negative
        self._images = images
        self._cascade_model = cascade_model
        self._single_detector = single_detector
        self.compare_platforms = list(compare_platforms or [])
        # resolved now, so a device that is not there raises before any work
        self.devices = [resolve_device(p) for p in self.compare_platforms] or [
            resolve_device(device)
        ]
        self.results: Dict[str, Dict[str, float]] = {}
        BaseApp.__init__(self, run_now)

    def _collect_images(self) -> List[np.ndarray]:
        if self._images is not None:
            return list(self._images)
        if cf.get("dataset_keys") == ["synthetic"]:
            from ..data.synthetic import make_scene

            scenes = []
            for s in range(self.n_positive):
                scenes.append(make_scene(480, 640, 2, seed=s).image)
            for s in range(self.n_negative):
                scenes.append(make_scene(480, 640, 0, seed=1000 + s).image)
            return scenes
        from ..data.file_list import FileListLoader

        infos = FileListLoader().sample_image_infos(self.n_positive, self.n_negative)
        return [i.raw_original() for i in infos]

    def _bench(self, name: str, app, device: torch.device) -> None:
        images = self._images_cache

        def synchronize():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        # warm with the full set once: kernel builds, plan and schedule
        # caches and the batched-frames path at its real batch size, so the
        # measurement is steady-state throughput
        app.run_inference_on_images(images, merge=cf.get("inference_merge"))
        synchronize()
        start = time.perf_counter()
        app.run_inference_on_images(images, merge=cf.get("inference_merge"))
        synchronize()
        elapsed = time.perf_counter() - start
        self.results[name] = {
            "total_seconds": elapsed,
            "avg_seconds_per_image": elapsed / len(images),
            "fps": len(images) / elapsed,
        }
        log.log(
            "{}: {} images in {:.2f}s (avg {:.3f}s, {:.1f} fps)".format(
                name,
                len(images),
                elapsed,
                elapsed / len(images),
                len(images) / elapsed,
            )
        )

    def _bench_families(self, device: torch.device, suffix: str = "") -> None:
        """Benchmark both detector families on ``device``."""
        cascade_app = InferenceCascadeApp(
            self.cascade_session_key, model=self._cascade_model, device=device
        )
        self._bench("cascade" + suffix, cascade_app, device)

        single_app = InferenceApp(self.single_session_key, device=device)
        if self._single_detector is not None:
            from ..models.single import SingleNetDetector

            sd = self._single_detector
            single_app._detector = SingleNetDetector(
                sd.params, sd.stage_config, sd.mean.cpu().numpy(), sd.std.cpu().numpy(),
                device,
            )
        self._bench("single" + suffix, single_app, device)

        speedup = (
            self.results["single" + suffix]["avg_seconds_per_image"]
            / self.results["cascade" + suffix]["avg_seconds_per_image"]
        )
        log.log("cascade speedup over single net{}: {:.2f}x".format(suffix, speedup))
        self.results["speedup_cascade_vs_single" + suffix] = {"value": speedup}

    def _main(self):
        self._images_cache = self._collect_images()
        if not self.compare_platforms:
            self._bench_families(self.devices[0])
            return
        for platform, device in zip(self.compare_platforms, self.devices):
            self._bench_families(device, "@" + platform)
