"""Training applications (counterpart of the JAX package's
``apps/train_apps.py``).

``TrainApp`` / ``TrainCascadeApp`` re-design (app/train_app.py,
app/train_cascade_app.py at the orchestration level — the actual training
logic lives in train/trainer.py and train/cascade_trainer.py):
  * config echo before training (train_app.py:88-137);
  * finalize = final evaluation + deployment export (train_app.py:139-155);
  * the export step replaces the reference's freeze/optimize/re-import
    pipeline (train_app.py:177-227) with the JAX package's npz+json
    checkpoints (train/checkpoint.py), which either package reads.

Both apps train on ``device`` (default: the CUDA card; ``"cpu"`` for the
CPU), resolved when the app is made. Deliberate difference from the JAX
package: its ``TrainApp._finalize`` wraps the validation predictions and the
collage in one ``except Exception``; here only the collage rendering (host
numpy and PIL) is isolated, so an error of ``trainer.predict`` on the card
propagates. The abort save re-raises a CUDA error likewise.
"""

from __future__ import annotations

from typing import Optional

from .. import config as cf
from ..data.loader import DiskDatasetProvider
from ..train import checkpoint
from ..train.cascade_trainer import CascadeTrainer, DatasetProvider, SyntheticProvider
from ..train.trainer import SingleNetTrainer
from ..utils import log, profiling
from ..utils.collage import evaluation_collage
from ..utils.device import is_cuda_error, resolve_device
from .base import BaseApp


def _default_provider() -> DatasetProvider:
    """Synthetic data when configured (hermetic runs), disk data otherwise."""
    keys = cf.get("dataset_keys")
    if keys == ["synthetic"]:
        sizes = sorted(set(_stage_sizes()))
        return SyntheticProvider(
            n_pos=cf.get("class_min_images") or 200,
            n_neg=cf.get("class_min_images") or 200,
            sizes=sizes,
            seed=cf.get("seed"),
        )
    return DiskDatasetProvider()


def _stage_sizes():
    from ..models.cnn import stage_input_sizes

    return stage_input_sizes(
        cf.get("cascade_n_nets"),
        cf.get("img_width"),
        cf.get("cascade_increasing_input_dimensions"),
    )


def _log_current_config(extra_cascade: bool = False) -> None:
    """Echo the settings that shape this run (train_app.py:88-137)."""
    for key in (
        "session_key",
        "batch_size",
        "epochs_total",
        "learning_rate_init",
        "learning_rate_decay",
        "optimizer",
        "momentum",
        "dropout_rate",
        "fc1_size",
        "conv_filter_sizes",
        "img_width",
        "data_augmentation_online",
        "standardization",
        "train_mesh_devices",
    ):
        log.log(".. {}: {}".format(key, cf.get(key)))
    if extra_cascade:
        for key in ("cascade_resampling_method", "reuse_bottlenecks", "max_beta", "min_beta"):
            log.log(".. {}: {}".format(key, cf.get(key)))


class TrainApp(BaseApp):
    """Train a single net and export it."""

    def __init__(self, provider: Optional[DatasetProvider] = None, run_now: bool = True,
                 device=None):
        self.provider = provider
        self.device = resolve_device(device)
        self.trainer: Optional[SingleNetTrainer] = None
        self.final_results = None
        BaseApp.__init__(self, run_now)

    def _main(self):
        _log_current_config()
        log.log(".. device: {}".format(self.device))
        provider = self.provider or _default_provider()
        ds = provider.dataset(cf.get("img_width"))
        self.trainer = SingleNetTrainer(ds, f_beta=cf.get("f_beta_default"), device=self.device)
        with profiling.phase("train single ({} px)".format(cf.get("img_width"))):
            self.trainer.train()
        self._finalize()

    def _on_cancel(self):
        """Save the latest state on user abort when configured
        (app/train_app.py:157-175, config auto_save_on_abort)."""
        super()._on_cancel()
        if cf.get("auto_save_on_abort") and self.trainer is not None:
            try:
                self._finalize()
                log.log("saved current work after abort")
            except Exception as exc:
                if is_cuda_error(exc):
                    raise
                log.log("abort-save failed: {}".format(exc))

    def _finalize(self):
        val_eval, test_eval, train_eval = self.trainer.final_evaluation()
        self.final_results = {"valid": val_eval, "test": test_eval, "train": train_eval}
        predictions, _ = self.trainer.predict(self.trainer.ds.valid)
        try:
            evaluation_collage(
                self.trainer.ds.valid.images,
                self.trainer.ds.valid.labels,
                predictions,
                "single_eval",
            )
        except Exception as exc:  # host rendering only: it must never break training
            log.log("collage skipped: {}".format(exc))
        self.exported_path = self.trainer.export(
            cf.ensure_dir("output_graph_dir"), cf.get("session_key")
        )
        log.log("exported model: {}".format(self.exported_path))


class TrainCascadeApp(BaseApp):
    """Train the boosted cascade and export all stages."""

    def __init__(self, provider: Optional[DatasetProvider] = None, run_now: bool = True,
                 device=None):
        self.provider = provider
        self.device = resolve_device(device)
        self.model = None
        self.cascade_trainer: Optional[CascadeTrainer] = None
        self.final_results = None
        BaseApp.__init__(self, run_now)

    def _main(self):
        _log_current_config(extra_cascade=True)
        log.log(".. device: {}".format(self.device))
        provider = self.provider or _default_provider()
        self.cascade_trainer = CascadeTrainer(provider, device=self.device)
        self.model = self.cascade_trainer.train()
        self.final_results = self.cascade_trainer.combined_results
        self.exported_paths = checkpoint.save_cascade(
            cf.ensure_dir("output_graph_dir"), cf.get("session_key"), self.model
        )
        log.log("exported cascade stages: {}".format(self.exported_paths))
