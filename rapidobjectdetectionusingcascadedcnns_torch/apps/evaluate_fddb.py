"""FDDB 10-fold benchmark harness (counterpart of the JAX package's
``apps/evaluate_fddb.py``).

Re-design of ``EvaluateFDDBApp`` (app/evaluate_fddb_app.py): forces the dense
FDDB pyramid (scale factor 1.005) and vertical bbox enlargement, runs the
cascade over every fold one image per detector call (crop mode: kernel K2
for stage 0, K1 for re-extraction), exports detections in the official
format, symlinks ``latest``, scores them with the in-repo scorer
(``data/fddb_eval.py``) and shells out to the official Perl evaluator +
gnuplot when they are installed. Runs on ``device`` (default: the CUDA
card; ``"cpu"`` for the CPU).
"""

from __future__ import annotations

import os
import shutil
from typing import List

from .. import config as cf
from ..data import fddb
from ..utils import console, log
from ..utils.device import resolve_device
from .base import BaseApp
from .inference_apps import InferenceCascadeApp


class EvaluateFDDBApp(BaseApp):
    def __init__(
        self,
        session_suffix: str = "",
        model=None,
        n_folds: int = 10,
        run_now: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if not cf.get("foreground_equals_face"):
            raise AttributeError(
                "This app does not make sense, if you're not looking for a "
                "face detector"
            )
        # evaluation density/format settings (evaluate_fddb_app.py:32-41)
        cf.set("window_scale_factor", 1.005)
        cf.set("inference_merge", False)
        cf.set("vertically_enlarge_bboxes", True)
        # bound the pyramid plans and stage-0 schedules built across FDDB's
        # many image sizes
        if cf.get("inference_resize_buckets") is None:
            cf.set("inference_resize_buckets", cf.get("fddb_resize_buckets"))

        suffix = session_suffix
        if suffix and not suffix.startswith("_"):
            suffix = "_" + suffix
        self.export_dir = os.path.join(
            cf.get("fddb_detection_output_dir"), cf.get("session_key") + suffix
        )
        self.n_folds = n_folds
        self._model = model
        self.fold_paths: List[str] = []
        self.roc = None
        self.inference_app = None
        BaseApp.__init__(self, run_now)

    def _main(self):
        log.log("Running inference on the FDDB dataset")
        if cf.get("inference_resize_buckets") == "auto":
            buckets = fddb.derive_resize_buckets(self.n_folds)
            cf.set("inference_resize_buckets", buckets)
            log.log(
                "derived {} resize buckets from the corpus: {}".format(
                    len(buckets), buckets
                )
            )
        app = self.inference_app = InferenceCascadeApp(model=self._model, device=self.device)

        for fold_nr in range(1, self.n_folds + 1):
            log.log("*************  Fold {}/{}  *************".format(fold_nr, self.n_folds))
            infos = fddb.image_infos_for_fold(fold_nr)
            results = app.run_inference_on_images(infos, merge=cf.get("inference_merge"))
            keys = [fddb.image_key(i.path_original) for i in infos]
            path = fddb.write_fold_results(
                self.export_dir,
                fold_nr,
                keys,
                [r.boxes for r in results],
                [r.confidences for r in results],
            )
            self.fold_paths.append(path)

        self._symlink_latest()
        self.roc = self._run_in_repo_scorer()
        self._run_official_evaluator()

    def _run_in_repo_scorer(self):
        """Score the exported detections against the fold ellipse ground
        truth with the in-repo evaluator (data/fddb_eval.py) and write
        <export_dir>/fddb_roc.json — the detection-rate curve the official
        evaluator would produce (app/evaluate_fddb_app.py:171-179 contract),
        available even where Perl/gnuplot are not."""
        from ..data import fddb_eval

        try:
            result = fddb_eval.evaluate_folds(
                self.export_dir, cf.get("fddb_folds_dir"), self.n_folds
            )
        except FileNotFoundError as exc:
            log.log("in-repo FDDB scoring skipped (missing ground truth): {}".format(exc))
            return None
        except Exception as exc:  # noqa: BLE001 — the in-repo scorer is
            # additive: a malformed fold file must not abort the app before
            # the official evaluator step (which predates this scorer) runs
            log.log(
                "WARNING: in-repo FDDB scoring failed ({}: {}); continuing "
                "to the official evaluator".format(type(exc).__name__, exc)
            )
            return None
        path = fddb_eval.write_roc_artifact(
            result,
            os.path.join(self.export_dir, "fddb_roc.json"),
            extra={"session_key": cf.get("session_key")},
        )
        if result["roc"]:
            best = result["roc"][-1]
            log.log(
                "FDDB ROC ({} faces, {} detections): detection rate {:.3f} "
                "discrete / {:.3f} continuous at {} total false positives "
                "(full curve: {})".format(
                    result["n_faces"], result["n_detections"],
                    best["detection_rate"], best["detection_rate_continuous"],
                    best["false_positives"], path,
                )
            )
        return result

    def _symlink_latest(self):
        latest = cf.get("fddb_latest_detection_output_dir")
        if os.path.islink(latest):
            os.remove(latest)
        if not os.path.exists(latest):
            os.symlink(self.export_dir, latest)
            log.log("Creating symlink {}".format(latest))

    def _run_official_evaluator(self):
        """Official Perl evaluator + gnuplot ROC compare plots, when present
        (evaluate_fddb_app.py:171-179)."""
        script = cf.get("fddb_per_evaluation_script_path")
        if not os.path.exists(script):
            log.log(
                "FDDB evaluation script not found ({}); skipping the official "
                "ROC computation.".format(script)
            )
            return
        log.log("Running the FDDB evaluation script (in Perl)")
        console.run(script)
        for name in ("contROC.p", "discROC.p"):
            plot = os.path.join(cf.get("fddb_gnuplot_compare_dir"), name)
            if os.path.exists(plot):
                if shutil.which("gnuplot") is None:
                    log.log(
                        "gnuplot not installed; skipping ROC compare plot "
                        "{}".format(plot)
                    )
                    continue
                console.run(["gnuplot", plot])
        for name in ("contROC-compare.png", "discROC-compare.png"):
            src = os.path.join(cf.get("fddb_gnuplot_compare_dir"), name)
            if os.path.exists(src):
                shutil.copy2(src, self.export_dir)
