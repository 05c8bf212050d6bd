"""Boosted cascade training: sequential stage driver and sample
re-weighting (counterpart of train/cascade_trainer.py of the JAX package).

Re-design of ``TrainCascadeApp`` (app/train_cascade_app.py:41-440):

  * per-stage beta interpolation from ``max_beta`` down to ``min_beta``
    (train_cascade_app.py:56-62), with the optional cross-entropy very-last
    stage (config.py:194-199);
  * bottleneck handoff: each stage's post-concat fc1 activations are
    recorded per sample and copied into the next stage's dataset splits
    (train_cascade_app.py:64-69, 95-113, 264-269);
  * retry with the same beta on :class:`ConstantPredictionException`, up to
    ``cascade_max_same_beta`` times (train_cascade_app.py:71-86);
  * AdaBoost.M1-like and confidence-based re-weighting of the training
    distribution (train_cascade_app.py:115-173), vectorized over a split;
  * combined cascade evaluation as the elementwise product of per-stage
    predictions (train_cascade_app.py:320-402).

Every stage trains on the CUDA card unless given ``device="cpu"``; the
result is the port's ``CascadeModel``, which detects through
``CascadeDetector``. With ``append_inception`` a 299 px Inception stage
follows the custom ones (config.py:279-287, train_cascade_app.py:203-228).
With a mesh (``mesh=``, else ``train_mesh_devices``) every stage trains
data parallel over it (``train/trainer.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol

import numpy as np

from .. import config as cf
from ..data.dataset import SPLIT_KEYS, Dataset, deterministic_shuffle
from ..data.preprocessor import Preprocessor
from ..labels import IID_BACKGROUND, IID_FOREGROUND
from ..models import cnn
from ..models.cascade import CascadeModel
from ..utils import log, profiling
from . import metrics
from .trainer import ConstantPredictionException, SingleNetTrainer, resolve_training_mesh


class DatasetProvider(Protocol):
    def dataset(self, img_size: int) -> Dataset:  # pragma: no cover - protocol
        ...


class SyntheticProvider:
    """Multi-resolution synthetic patch datasets with aligned sample order.

    ``source``: "patches" (procedural face/texture patches), "scenes"
    (patches sampled from full scenes via the offline-sampling flow, the
    distribution pyramid windows actually see), or "mixed" (``n - n // 2``
    patches and ``n // 2`` scene samples of each label, the scenes drawn
    from ``seed + 1``).

    ``hard_negatives`` / ``hard_positives``: optional (N, top, top, 3)
    uint8 arrays of mined windows (tools/mine_torch_hard_negatives.py,
    tools/mine_torch_hard_positives.py) at the top stage resolution,
    appended as background / foreground samples (negatives first) before
    the shuffle, their lower resolutions by the corpora's aligned block
    mean: the bootstrap step of the reference's sampling design.
    """

    def __init__(
        self, n_pos: int, n_neg: int, sizes: List[int], seed: int = 0,
        source: str = "patches", hard_negatives=None, hard_positives=None,
    ):
        from ..data.synthetic import (
            aligned_views,
            make_multiresolution_patch_dataset,
            make_multiresolution_scene_patch_dataset,
        )

        if source == "patches":
            bundle = make_multiresolution_patch_dataset(n_pos, n_neg, sizes, seed)
        elif source == "scenes":
            bundle = make_multiresolution_scene_patch_dataset(n_pos, n_neg, sizes, seed)
        elif source == "mixed":
            a = make_multiresolution_patch_dataset(
                n_pos - n_pos // 2, n_neg - n_neg // 2, sizes, seed
            )
            b = make_multiresolution_scene_patch_dataset(n_pos // 2, n_neg // 2, sizes, seed + 1)
            bundle = {
                "labels": np.concatenate([a["labels"], b["labels"]]),
                "images": {s: np.concatenate([a["images"][s], b["images"][s]])
                           for s in a["images"]},
            }
        else:
            raise ValueError("unknown corpus source {!r}".format(source))

        top = max(sizes)
        for patches, label in ((hard_negatives, IID_BACKGROUND), (hard_positives, IID_FOREGROUND)):
            if patches is None or not len(patches):
                continue
            mined = np.asarray(patches, np.uint8)
            if mined.shape[1] != top:
                raise ValueError(
                    "mined patches must be at the top stage resolution "
                    "({}), got {}".format(top, mined.shape[1])
                )
            views = aligned_views(mined, sizes)
            bundle = {
                "labels": np.concatenate(
                    [bundle["labels"], np.full(len(mined), label, np.int32)]
                ),
                "images": {s: np.concatenate([imgs, views[s]])
                           for s, imgs in bundle["images"].items()},
            }
        perm = deterministic_shuffle(len(bundle["labels"]), cf.get("shuffle_seed"))
        self._labels = bundle["labels"][perm]
        self._images = {s: imgs[perm] for s, imgs in bundle["images"].items()}

    def dataset(self, img_size: int) -> Dataset:
        if img_size not in self._images:
            # render on demand (the 299 px Inception stage) from the highest
            # resolution there is, the sample order kept
            from ..data.image_io import resize_rgb

            base = self._images[max(self._images)]
            self._images[img_size] = np.stack(
                [resize_rgb(img, img_size, img_size) for img in base]
            )
        images = self._images[img_size]
        pp = Preprocessor(images, standardization=cf.get("standardization"))
        return Dataset(
            images, self._labels, cf.get("dataset_split"), pp,
            name="synthetic_{}px".format(img_size),
        )


def stage_beta(stage_index: int, n_nets: int) -> Optional[float]:
    """Beta schedule (train_cascade_app.py:56-62)."""
    if not cf.get("f_beta_cascade_loss"):
        return None
    if n_nets == 1:
        beta = float(cf.get("min_beta"))
    else:
        beta = cf.get("max_beta") - (
            (stage_index / (n_nets - 1)) * (cf.get("max_beta") - cf.get("min_beta"))
        )
    if stage_index == n_nets - 1 and not cf.get("f_beta_cascade_loss_very_last"):
        return None
    return beta


def reweight_adaboost_like(
    weights: np.ndarray, predicted: np.ndarray, actual: np.ndarray
) -> np.ndarray:
    """AdaBoost.M1-like update: downweight background-predicted samples by
    error/(1-error); reset to uniform when the error is degenerate
    (train_cascade_app.py:137-173)."""
    error = float(weights[predicted != actual].sum())
    n = len(weights)
    if error == 0 or error >= 0.5:
        log.log("resetting weight distribution, because of an unsupported error rate.")
        return np.full((n,), 1.0 / n)
    update_factor = error / (1.0 - error)
    new = np.where(predicted == IID_BACKGROUND, weights * update_factor, weights)
    return new / new.sum()


def reweight_confidence(
    weights_acc: np.ndarray, fg_probabilities: np.ndarray, actual: np.ndarray
) -> np.ndarray:
    """Confidence-based update: a background sample's weight is the product
    of the keep-probabilities all previous nets assigned to it; foreground
    stays at weight 1 (train_cascade_app.py:115-135). Returns the updated
    (unnormalized) accumulator."""
    change = np.where(actual == IID_FOREGROUND, 1.0, fg_probabilities)
    return weights_acc * change


class CascadeTrainer:
    """Sequentially trains the boosted cascade and assembles a CascadeModel."""

    def __init__(self, provider: DatasetProvider, seed: Optional[int] = None, mesh=None,
                 device=None):
        self.mesh, self.device = resolve_training_mesh(mesh, device)
        self.provider = provider
        self.seed = cf.get("seed") if seed is None else seed
        self.n_nets = cf.get("cascade_n_nets")
        self.sizes = cnn.stage_input_sizes(
            self.n_nets, cf.get("img_width"), cf.get("cascade_increasing_input_dimensions")
        )
        # the optional Inception stage at 299 px after the custom nets
        self.append_inception = bool(cf.get("append_inception"))
        if self.append_inception:
            from ..models import inception

            self.n_nets += 1
            self.sizes.append(inception.MODEL_INPUT_WIDTH)
        self.stage_trainers: List[SingleNetTrainer] = []
        self.combined_results: Dict[str, Dict[str, float]] = {}
        # per stage but the last: the sample weights after its re-weighting
        # and the weighted error it was re-weighted with, per split
        self.weight_history: List[Dict[str, np.ndarray]] = []
        self.reweight_errors: List[Dict[str, float]] = []
        self._weights: Optional[Dict[str, np.ndarray]] = None
        self._weights_acc: Optional[Dict[str, np.ndarray]] = None
        self._predictions: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------

    def _load_stage_dataset(self, stage: int, prev_ds: Optional[Dataset]) -> Dataset:
        ds = self.provider.dataset(self.sizes[stage])
        if prev_ds is not None:
            if ds.n_samples != prev_ds.n_samples or not np.array_equal(
                ds.labels, prev_ds.labels
            ):
                raise ValueError(
                    "The previous net's dataset is incompatible with the current one."
                )
            if cf.get("reuse_bottlenecks"):
                for key in SPLIT_KEYS:
                    ds.split(key).set_bottlenecks(prev_ds.split(key).bottlenecks)

        resampling = cf.get("cascade_resampling_method")
        if resampling != cf.RESAMPLING_DEACTIVATED:
            if stage == 0:
                log.log("initializing sample probability distribution")
                self._weights = {
                    key: np.full(
                        (ds.split(key).n_samples,), 1.0 / max(ds.split(key).n_samples, 1)
                    )
                    for key in SPLIT_KEYS
                }
                if resampling == cf.RESAMPLING_CONFIDENCE:
                    self._weights_acc = {
                        key: np.ones((ds.split(key).n_samples,)) for key in SPLIT_KEYS
                    }
                # stage 0 sees everything, like production will
                for key in SPLIT_KEYS:
                    ds.split(key).set_probability_distribution(None)
            else:
                log.log("using a new sample probability distribution")
                for key in SPLIT_KEYS:
                    ds.split(key).set_probability_distribution(self._weights[key])
        return ds

    def _reweight(self, trainer: SingleNetTrainer, ds: Dataset) -> None:
        """Post-stage bottleneck refresh and weight update for every split
        (train_cascade_app.py:89-176)."""
        resampling = cf.get("cascade_resampling_method")
        errors = {}
        for key in SPLIT_KEYS:
            split = ds.split(key)
            log.log(
                "Updating {} sample weights{}".format(
                    key, " and bottlenecks" if cf.get("reuse_bottlenecks") else ""
                )
            )
            predicted, probabilities = trainer.predict(
                split,
                update_bottlenecks=cf.get("reuse_bottlenecks"),
                return_probabilities=True,
            )
            if self._weights is not None:
                errors[key] = float(self._weights[key][predicted != split.labels].sum())
            if resampling == cf.RESAMPLING_CONFIDENCE:
                self._weights_acc[key] = reweight_confidence(
                    self._weights_acc[key], probabilities[:, IID_FOREGROUND], split.labels
                )
                self._weights[key] = self._weights_acc[key] / self._weights_acc[key].sum()
            elif resampling == cf.RESAMPLING_ADABOOST_LIKE:
                self._weights[key] = reweight_adaboost_like(
                    self._weights[key], predicted, split.labels
                )
        if self._weights is not None:
            self.weight_history.append({k: v.copy() for k, v in self._weights.items()})
            self.reweight_errors.append(errors)

    def _accumulate_combined(self, trainer: SingleNetTrainer, ds: Dataset, stage: int):
        """Π-prediction combined evaluation (train_cascade_app.py:320-402)."""
        if stage == 0:
            self._predictions = {
                key: np.full((ds.split(key).n_samples,), IID_FOREGROUND, np.int8)
                for key in SPLIT_KEYS
            }
        for key in SPLIT_KEYS:
            predicted, _ = trainer.predict(ds.split(key))
            self._predictions[key] = self._predictions[key] * predicted.astype(np.int8)

        if stage == self.n_nets - 1:
            for key in SPLIT_KEYS:
                labels = ds.split(key).labels
                pred = self._predictions[key]
                results = {
                    "true_positives": int((pred * labels).sum()),
                    "true_negatives": int(((pred - 1) * (labels - 1)).sum()),
                    "false_negatives": int(-((pred - 1) * labels).sum()),
                    "false_positives": int(-(pred * (labels - 1)).sum()),
                }
                self.combined_results[key] = metrics.process_results(results)
                metrics.log_results(
                    self.combined_results[key],
                    "Combined cascade evaluation for the {} split".format(key),
                )

    # ------------------------------------------------------------------

    def train(self) -> CascadeModel:
        prev_ds: Optional[Dataset] = None
        bottleneck_in_size: Optional[int] = None
        params_list, cfg_list, means, stds = [], [], [], []

        for stage in range(self.n_nets):
            log.log("*" * 60)
            log.log(
                "Training net {}/{} to create a cascade (input {}px)".format(
                    stage + 1, self.n_nets, self.sizes[stage]
                )
            )
            beta = stage_beta(stage, self.n_nets)
            ds = self._load_stage_dataset(stage, prev_ds)
            bneck_in = None if stage == 0 or not cf.get("reuse_bottlenecks") else bottleneck_in_size

            use_inception = self.append_inception and stage == self.n_nets - 1
            n_custom = self.n_nets - int(self.append_inception)
            per_stage = cf.get("conv_filter_sizes_per_stage")
            if per_stage is not None and not use_inception:
                if len(per_stage) < n_custom:
                    raise ValueError(
                        "conv_filter_sizes_per_stage needs one entry per custom cascade "
                        "stage ({} given, {} needed)".format(len(per_stage), n_custom)
                    )
                stage_overlay = {"conv_filter_sizes": list(per_stage[stage])}
            else:
                stage_overlay = {}
            trial = 1
            stage_timer = profiling.phase("train stage {} ({} px)".format(stage, self.sizes[stage]))
            with stage_timer, cf.overrides(**stage_overlay):
                while True:
                    trainer = SingleNetTrainer(
                        ds,
                        f_beta=beta,
                        bottleneck_in_size=bneck_in,
                        nr=stage + 1,
                        nr_max=self.n_nets,
                        seed=self.seed + stage + 1000 * trial,
                        use_inception=use_inception,
                        mesh=self.mesh,
                        device=self.device,
                    )
                    try:
                        trainer.train()
                        break
                    except ConstantPredictionException:
                        if trial >= cf.get("cascade_max_same_beta"):
                            raise
                        log.log(
                            "WARNING: Retrying with same beta value: {}/{}".format(
                                trial, cf.get("cascade_max_same_beta")
                            )
                        )
                        trial += 1

            trainer.restore_best()
            trainer.final_evaluation()
            self.stage_trainers.append(trainer)
            self._accumulate_combined(trainer, ds, stage)

            if stage != self.n_nets - 1:
                self._reweight(trainer, ds)
                bottleneck_in_size = trainer.bottleneck_out_size

            mean, std = trainer.mean_std()
            params_list.append(trainer.inference_params())
            cfg_list.append(trainer.stage_config)
            means.append(mean)
            stds.append(std)
            prev_ds = ds

        return CascadeModel(params_list, cfg_list, means, stds)
