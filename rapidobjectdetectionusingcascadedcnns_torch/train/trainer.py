"""Single-net training loop (counterpart of train/trainer.py of the JAX
package).

Re-design of ``NetTrainable.train`` (network/net_trainable.py:159-309) with
all its guards:

  * NaN-loss abort (net_trainable.py:223-226);
  * constant-prediction detection on validation evals, raising
    :class:`ConstantPredictionException` after ``n_max_constant_evals``
    repeats (net_trainable.py:256-276);
  * best-snapshot tracking on the main validation criteria with rollback
    after ``restore_after`` stagnant iterations (net_trainable.py:287-295,
    311-336);
  * training timeout (net_trainable.py:300-306);
  * periodic validation/training evaluation at the reference's interrupt
    cadence (net_trainable.py:168-177, 247-282);
  * final evaluation restores the best snapshot and scores all splits
    (net_trainable.py:360-401).

The device work goes through :mod:`.train_step`; the loop is host
orchestration, with the batch stream of the JAX package's seeded iterators
(the same seeds give the same batches in both packages), assembled ahead of
the card by a prefetch thread (``data/prefetch.PrefetchIterator``, depth 2). It runs on the
CUDA card unless given ``device="cpu"``.

The steps run over a mesh (``mesh=``, else ``train_mesh_devices`` through
``parallel/mesh.mesh_from_config``, else the one device): every batch is
padded to a multiple of the mesh size with a valid mask and split over the
mesh, the master weights stay on mesh device 0, and the loss is formed
over the whole batch; inside a ``torch.distributed`` group the batch is
split over the processes too (``parallel/multihost.py``). The same seed
gives the single-device run's draws, so a mesh run tracks it within float
rounding.

An Inception stage (``use_inception``) trains its compact trunk end to end,
or, with ``inception_weights_path`` set, keeps the loaded trunk frozen:
every split is embedded through it once, the head trains on the 2048-wide
rows, and online augmentation is off for the stage (JAX
``trainer.py:189-256``).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config as cf
from ..data.dataset import Dataset, DatasetSplit, DeterministicIterator
from ..data.prefetch import PrefetchIterator
from ..labels import IID_BACKGROUND, IID_FOREGROUND, n_labels
from ..models import bridge, cnn
from ..ops import augment as augment_ops
from ..utils import log
from ..utils.device import resolve_device, set_numerics
from . import checkpoint, metrics, optimizer as opt_mod, train_step


class ConstantPredictionException(Exception):
    """Raised when the net keeps predicting a single class
    (net_trainable.py:438-441)."""


def resolve_training_mesh(mesh, device):
    """(mesh, device) of a trainer: ``mesh`` (a ``Mesh`` or a tuple of
    devices), else the ``train_mesh_devices`` mesh on ``device``'s type,
    else the mesh of ``device`` alone; the device is mesh device 0, and a
    ``device`` naming another raises."""
    from ..parallel import mesh as mesh_mod

    if mesh is None:
        mesh = mesh_mod.mesh_from_config(device)
    else:
        mesh = mesh_mod.as_mesh(mesh)
    if mesh is None:
        device = resolve_device(device)
        return mesh_mod.Mesh([device]), device
    if device is not None and mesh_mod.as_mesh([device])[0] != mesh[0]:
        raise ValueError("device {} is not mesh device 0 ({})".format(device, mesh[0]))
    return mesh, mesh[0]


class SingleNetTrainer:
    """Trains one cascade-stage CNN on a Dataset."""

    def __init__(
        self,
        dataset: Dataset,
        f_beta: Optional[float] = None,
        bottleneck_in_size: Optional[int] = None,
        nr: int = 1,
        nr_max: int = 1,
        seed: Optional[int] = None,
        snapshot_full_path: str = "",
        use_inception: bool = False,
        mesh=None,
        device=None,
    ):
        self.mesh, self.device = resolve_training_mesh(mesh, device)
        if self.mesh.size > 1:
            log.log("data-parallel training over {} (batch axis sharded, weights on {})".format(
                self.mesh, self.device))
        self.ds = dataset
        self.nr = nr
        self.nr_max = nr_max
        self.f_beta = f_beta

        # the reference disables F-beta when positives dominate
        # (net_trainable.py:66-69)
        if self.f_beta is not None and dataset.train.positive_proportion > 0.5:
            log.log(
                "Warning: Disabling the usage of F-Beta, because there are more "
                "positive samples than negative ones. Weighted cross entropy "
                "will be used instead."
            )
            self.f_beta = None

        self._f_beta_key = (
            metrics.f_beta_key(self.f_beta) if self.f_beta is not None else None
        )
        self.main_criteria = (
            self._f_beta_key if self.f_beta is not None else cf.get("tuning_main_criteria")
        )

        self.stage_config = cnn.StageConfig.from_config(
            dataset.image_shape[0],
            bottleneck_in_size=bottleneck_in_size,
            backbone="inception" if use_inception else "custom",
        )
        # the pretrained-trunk workflow: a loaded trunk stays frozen and only
        # the head trains, as the reference trains the layers on top of the
        # imported Inception graph (network/inception_builder.py:68-96)
        self._frozen_trunk = bool(use_inception and cf.get("inception_weights_path"))
        set_numerics(self.stage_config.compute_dtype)
        self.iterations_per_epoch = math.ceil(dataset.train.n_samples / cf.get("batch_size"))
        self.iterations_total = int(cf.get("epochs_total") * self.iterations_per_epoch)

        seed = cf.get("seed") if seed is None else seed
        # one seed for everything this trainer draws: the initial weights,
        # the augmentation draws (host generator), the dropout masks (device
        # generator) and the batch order (seeded iterators)
        self._seed = seed + nr
        self._host_gen = torch.Generator().manual_seed(self._seed)
        self._device_gen = torch.Generator(device=self.device).manual_seed(self._seed)

        def make_optimizer(leaves):
            return opt_mod.optimizer_from_config(leaves, self.iterations_total)

        if snapshot_full_path:
            params, _, _, _, _ = bridge.load_stage(snapshot_full_path, self.device)
            params = train_step.trainable(params, self.device, self._frozen_trunk)
            self.state = train_step.TrainState(
                params, make_optimizer(train_step.optimized_leaves(params))
            )
        else:
            self.state = train_step.init_train_state(
                self.stage_config, self._seed, make_optimizer, self.device, self._frozen_trunk
            )

        self._loss_settings = train_step.LossSettings(
            f_beta=self.f_beta,
            positive_proportion=float(dataset.train.positive_proportion),
            weighted=cf.get("weighted_cross_entropy"),
            normalize=cf.get("weighted_cross_entropy_normalize"),
            l2_strength=float(cf.get("L2_regularization_strength")),
            l1_strength=float(cf.get("L1_regularization_strength")),
            dropout_keep=float(cf.get("dropout_rate")),
        )
        self._augment = (
            augment_ops.AugmentConfig.from_config()
            if cf.get("data_augmentation_online") and not self._frozen_trunk
            else None
        )
        if self._frozen_trunk and cf.get("data_augmentation_online"):
            log.log(
                "frozen pretrained trunk: disabling online augmentation for "
                "this stage (images are embedded once through the trunk; the "
                "head trains on cached 2048-d bottlenecks)"
            )

        pp = dataset.preprocessor
        size = self.stage_config.input_size
        mean = np.broadcast_to(np.asarray(pp.mean_image, np.float32), (size, size, 3)).copy()
        std = np.broadcast_to(np.asarray(pp.std, np.float32), (size, size, 3)).copy()
        self._mean = torch.as_tensor(mean, device=self.device)
        self._std = torch.as_tensor(std, device=self.device)
        # what the stage standardizes its windows with in a detector
        self._window_mean, self._window_std = self._mean, self._std
        if self._frozen_trunk:
            # embed-once: the splits go through the frozen trunk once, and the
            # steps standardize the embedded rows with the identity
            self._embed_splits_through_trunk()
            self._mean = torch.zeros((), device=self.device)
            self._std = torch.ones((), device=self.device)

        # best-snapshot tracking
        self.best_val_results: Optional[Dict[str, float]] = None
        self.best_params = None
        self.iterations_since_best_found = 0
        self._last_loss = None
        # every update's loss as a 0-d device tensor (read with losses())
        self.loss_history: List[torch.Tensor] = []

    # ---------------- helpers ----------------

    def losses(self) -> np.ndarray:
        """The loss of every update so far, as float32 on the host."""
        if not self.loss_history:
            return np.zeros((0,), np.float32)
        return torch.stack(self.loss_history).float().cpu().numpy()

    @torch.no_grad()
    def _embed_splits_through_trunk(self) -> None:
        """Replace every split's images with their frozen-trunk embeddings,
        (N, 2048) float32, in place, so predict, evaluation and the
        cascade's combined evaluation read the same rows through
        ``apply_stage``'s 2-D path. The trunk runs in bf16, as the JAX
        package's embed program (JAX ``trainer.py:218-256``) does whatever
        the compute dtype, over chunks of ``inception.rows_per_chunk`` rows
        (rows are independent)."""
        from ..models import inception

        backbone = inception.cast_backbone(self.state.params["backbone"], torch.bfloat16)
        chunk = inception.rows_per_chunk(self.stage_config.input_size)
        for split in (self.ds.train, self.ds.valid, self.ds.test):
            imgs = split.images
            if imgs.ndim != 4 or len(imgs) == 0:
                continue  # already embedded (a shared split) or empty
            out = np.empty((len(imgs), inception.BOTTLENECK_TENSOR_SIZE), np.float32)
            for s in range(0, len(imgs), chunk):
                block = torch.as_tensor(imgs[s : s + chunk], device=self.device)
                x = train_step.standardize(block, self._mean, self._std)
                out[s : s + chunk] = inception.apply_backbone(
                    backbone, x, dtype=torch.bfloat16
                ).cpu().numpy()
            split.images = out
        log.log(
            "embedded {} train / {} valid / {} test samples through the "
            "frozen trunk".format(
                self.ds.train.n_samples, self.ds.valid.n_samples, self.ds.test.n_samples
            )
        )

    def _batch_bottlenecks(self, batch) -> Optional[np.ndarray]:
        if self.stage_config.bottleneck_in_size is None:
            return None
        if batch.bottlenecks is None:
            raise ValueError(
                "stage {} requires bottlenecks from the previous net".format(self.nr)
            )
        return np.asarray(batch.bottlenecks, np.float32)

    def _place_batch(self, batch):
        """(images u8, labels int64, bottlenecks or None) on the device."""
        dev = self.device
        images = torch.as_tensor(np.asarray(batch.images), device=dev)
        labels = torch.as_tensor(np.asarray(batch.labels), device=dev).long()
        bneck = self._batch_bottlenecks(batch)
        if bneck is not None:
            bneck = torch.as_tensor(bneck, device=dev)
        return images, labels, bneck

    def evaluate_split(
        self, split: DatasetSplit, log_line: Optional[str] = None
    ) -> Dict[str, float]:
        """Full-split metric evaluation in batches (net.py:282-332,445-483)."""
        it = split.new_default_iterator(cf.get("max_batch_size"), seed=self._seed)
        totals: Dict[str, float] = {}
        while it.in_first_epoch:
            images, labels, bneck = self._place_batch(it.next_batch)
            counts = train_step.eval_step(
                self.state.params, self.stage_config, images, labels, bneck,
                self._mean, self._std, None, self.f_beta, mesh=self.mesh,
            )
            for k, v in counts.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        results = metrics.process_results(totals, self.f_beta)
        if log_line is not None:
            metrics.log_results(results, log_line)
        return results

    def predict(
        self,
        split: DatasetSplit,
        update_bottlenecks: bool = False,
        return_probabilities: bool = False,
    ):
        """Deterministic-order prediction over a split (net.py:572-652)."""
        if update_bottlenecks and self.nr == self.nr_max:
            log.log(
                "Not caching the new bottlenecks, because the last net of a "
                "cascade has been reached."
            )
            update_bottlenecks = False
        preds, probs, bnecks = [], [], []
        it = DeterministicIterator(split, cf.get("max_batch_size"), shuffle_every_epoch=False)
        while it.in_first_epoch:
            images, _, bneck_in = self._place_batch(it.next_batch)
            best, p, bneck = train_step.predict_step(
                self.state.params, self.stage_config, images, bneck_in, self._mean, self._std,
                mesh=self.mesh,
            )
            preds.append(best)
            if return_probabilities:
                probs.append(p)
            if update_bottlenecks:
                bnecks.append(bneck)
        label_predictions = torch.cat(preds).cpu().numpy().astype(np.int64)
        probabilities = torch.cat(probs).cpu().numpy() if return_probabilities else None
        if update_bottlenecks:
            split.set_bottlenecks(torch.cat(bnecks).cpu().numpy())
        return label_predictions, probabilities

    @property
    def bottleneck_out_size(self) -> int:
        return self.stage_config.bottleneck_out_size

    # ---------------- training loop ----------------

    def train(self) -> None:
        start_time = time.time()
        summary_path = self._open_summary()

        interrupt_often = 100
        interrupt_sometimes = max(
            1,
            min(10000, math.floor(cf.get("epochs_total") * self.iterations_per_epoch / 4)),
        )
        interrupt_seldom = interrupt_sometimes * 3
        max_eval_step = self.iterations_total * 0.85  # skip evals in the last 15%

        n_const_predict = np.zeros((n_labels(),), np.uint8)
        cancel = False

        it = self.ds.train.new_default_iterator(cf.get("batch_size"), seed=self._seed)
        step = 0
        while it.epoch < cf.get("epochs_total"):
            if cancel:
                break
            log.log("Epoch {}/{}".format(it.epoch + 1, cf.get("epochs_total")))
            # host-side batch assembly runs ahead of the card in a
            # background thread, as in the JAX package's loop; leaving the
            # epoch early (cancel, timeout, an exception) stops the thread
            with PrefetchIterator(iter(it), depth=2) as batches:
                for batch in batches:
                    step += 1
                    images, labels, bneck = self._place_batch(batch)
                    loss = train_step.train_step(
                        self.state, self.stage_config, self._loss_settings, self._augment,
                        images, labels, bneck, self._mean, self._std,
                        self._host_gen, self._device_gen, mesh=self.mesh,
                    )
                    self.loss_history.append(loss)

                    if step % interrupt_often == 1 or step == self.iterations_total:
                        loss_value = float(loss)
                        self._last_loss = loss_value
                        if math.isnan(loss_value):
                            log.log("ERROR: loss value is nan. Cancelling training.")
                            cancel = True
                            break
                        log.log(
                            "Iteration {}/{}: loss = {:.4f}".format(
                                step, self.iterations_total, loss_value
                            )
                        )
                        self._write_summary(summary_path, step, loss_value)

                    if (
                        step % interrupt_sometimes == 0
                        and step < max_eval_step
                        and step != self.iterations_total
                    ):
                        res_val = self.evaluate_split(self.ds.valid, " -> validation:")
                        self._check_constant_prediction(res_val, n_const_predict)
                        if step % interrupt_seldom == 0:
                            self.evaluate_split(self.ds.train, " -> training:")
                        self._update_best_val_results(res_val)

                    if (
                        cf.get("restore_after") is not None
                        and self.iterations_since_best_found > cf.get("restore_after")
                        and step != self.iterations_total
                        and self.best_params is not None
                    ):
                        self.iterations_since_best_found = 0
                        log.log(
                            "Step back: restoring best parameters (no progress for "
                            "more than {} iterations).".format(cf.get("restore_after"))
                        )
                        self._load_params(self.best_params)

                    self.iterations_since_best_found += 1

                    if cf.get("timeout_minutes") > 0 and (
                        time.time() - start_time > cf.get("timeout_seconds")
                    ):
                        log.log("TIMEOUT: stopping earlier. saving current work.")
                        cancel = True
                        break

        self.stop_training()

    def _load_params(self, params: cnn.Params) -> None:
        """Copy ``params`` into the trained tensors in place: the optimizer
        keeps its state, as the JAX trainer keeps its opt_state."""
        with torch.no_grad():
            for dst, src in zip(
                train_step.param_leaves(self.state.params), train_step.param_leaves(params)
            ):
                dst.copy_(src)

    def _open_summary(self) -> str:
        """Per-session training-scalars log: a JSONL stream under the
        summary_dir (the reference records loss and learning rate as TF
        summaries, net_trainable.py:146-151)."""
        directory = cf.ensure_dir(os.path.join(cf.get("summary_dir"), cf.get("session_key")))
        path = os.path.join(directory, "scalars_net{}.jsonl".format(self.nr))
        with open(path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "event": "start",
                        "iterations_total": self.iterations_total,
                        "main_criteria": self.main_criteria,
                    }
                )
                + "\n"
            )
        return path

    def _write_summary(self, path: str, step: int, loss_value: float) -> None:
        lr = opt_mod.lr_schedule_from_config(self.iterations_total)(step)
        with open(path, "a") as f:
            f.write(json.dumps({"step": step, "loss": loss_value, "learning_rate": lr}) + "\n")

    def _check_constant_prediction(self, res_val, n_const_predict) -> None:
        limit = cf.get("n_max_constant_evals")
        for iid, positives, name in (
            (IID_BACKGROUND, ("true_positives", "false_positives"), "background"),
            (IID_FOREGROUND, ("true_negatives", "false_negatives"), "foreground"),
        ):
            if res_val[positives[0]] + res_val[positives[1]] != 0:
                continue
            n_const_predict[iid] += 1
            log.log(
                "WARNING: validation evaluation suggests constant {} prediction "
                "({} times)".format(name, n_const_predict[iid])
            )
            if limit is not None and n_const_predict[iid] > limit:
                raise ConstantPredictionException(
                    "validation evaluation suggests constant {} prediction too "
                    "often. Cancelling training.".format(name)
                )
            return

    def _update_best_val_results(self, res_val) -> None:
        if (
            self.best_val_results is None
            or res_val[self.main_criteria] > self.best_val_results[self.main_criteria]
        ):
            self.best_params = self.inference_params()
            self.best_val_results = res_val
            self.iterations_since_best_found = 0
            log.log(
                "Updated best model with validation {} of {}".format(
                    self.main_criteria,
                    metrics.get(self.main_criteria).format(res_val[self.main_criteria]),
                )
            )
            self._save_snapshot(res_val)

    def _save_snapshot(self, res_val) -> None:
        snap_dir = cf.ensure_dir(os.path.join(cf.get("snapshot_dir"), cf.get("session_key")))
        path = os.path.join(
            snap_dir,
            "val_{}_{:.3f}_net{}".format(self.main_criteria, res_val[self.main_criteria], self.nr),
        )
        mean, std = self.mean_std()
        checkpoint.save_stage(
            path, self.state.params, self.stage_config, mean, std,
            extra_meta={"val_results": {k: float(v) for k, v in res_val.items()}},
        )

    def stop_training(self) -> None:
        """Final best-vs-current check (net_trainable.py:338-357)."""
        if self.iterations_since_best_found > 1:
            log.log("Ensure that the last known best snapshot is still better.")
            res_val = self.evaluate_split(self.ds.valid)
            self._update_best_val_results(res_val)
        log.log(".. training finished.")

    def restore_best(self) -> None:
        if self.best_params is not None and self.iterations_since_best_found > 1:
            self._load_params(self.best_params)
            log.log("Restored best parameters of this run.")

    def final_evaluation(self):
        """Restore the best model and evaluate all splits
        (net_trainable.py:360-401)."""
        log.log("starting final evaluation")
        self.restore_best()
        if self.best_val_results is not None:
            val_eval = self.best_val_results
            metrics.log_results(val_eval, "FINAL validation set evaluation:")
        else:
            val_eval = self.evaluate_split(self.ds.valid, "FINAL validation set evaluation:")
        train_eval = self.evaluate_split(self.ds.train, "FINAL training set evaluation:")
        test_eval = self.evaluate_split(self.ds.test, "FINAL test set evaluation:")
        log.log("final evaluation is done.")
        return val_eval, test_eval, train_eval

    # -------- deployment artifacts --------

    def mean_std(self):
        """The stage's standardization of its input windows. For a frozen
        trunk these are the statistics the embed pass used, not the
        identity the steps use afterwards: the JAX trainer exports the
        identity there, so its detector feeds that trunk unstandardized
        windows (ROADMAP Queue C)."""
        return self._window_mean.cpu().numpy(), self._window_std.cpu().numpy()

    def inference_params(self) -> cnn.Params:
        """A detached copy of the current weights (what a ``CascadeModel``
        holds, and the best snapshot); a frozen trunk, which never changes,
        is shared rather than copied."""
        return cnn.tree_map(
            lambda t: t.detach().clone() if t.requires_grad else t, self.state.params
        )

    def export(self, model_dir: str, session_key: str, stage: Optional[int] = None):
        """Persist the trained stage as a deployment artifact (the analog of
        the reference's freeze+optimize+export, app/train_app.py:177-227)."""
        cf.ensure_dir(model_dir)
        if stage is None:
            path = checkpoint.single_model_path(model_dir, session_key)
        else:
            path = checkpoint.cascade_stage_path(model_dir, session_key, stage)
        mean, std = self.mean_std()
        return checkpoint.save_stage(path, self.state.params, self.stage_config, mean, std)
