"""Train, eval and predict steps (counterpart of train/train_step.py of the
JAX package, whose steps are jitted XLA programs).

Plain eager functions: a batch crosses to the device as uint8 and is
standardized there (``(images_u8 - mean) / std``); augmentation, forward,
loss, backward and the optimizer update follow on the device. The forward
runs on the f32 master weights, so the casts to the compute dtype inside
``cnn.apply_stage`` carry the gradients back to the masters. The backward
passes of the convolutions, max-pools and matrix products are autograd's
(cuDNN and cuBLAS on the card): the JAX package has no backward kernel of
its own. ``valid_mask`` excludes padding rows from the loss and the
metrics, as in the JAX package.

Unlike the JAX steps, :func:`train_step` updates its state in place: the
optimizer steps the parameter tensors, and ``state.step`` counts updates.
A frozen Inception trunk (``trainable(..., frozen_trunk=True)``) takes no
gradient and is not given to the optimizer, the counterpart of the JAX
trainer's ``optax.masked`` head-only update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models import cnn
from ..ops import augment as augment_ops
from . import losses, metrics
from .optimizer import ScheduledOptimizer

Tensor = torch.Tensor


@dataclass
class TrainState:
    params: cnn.Params  # f32 master weights, requires_grad
    optimizer: ScheduledOptimizer
    step: int = 0  # updates done; the next one runs at schedule(step)


@dataclass(frozen=True)
class LossSettings:
    """Static loss configuration."""

    f_beta: Optional[float]
    positive_proportion: float
    weighted: bool
    normalize: bool
    l2_strength: float
    l1_strength: float
    dropout_keep: float


param_leaves = cnn.param_leaves


def optimized_leaves(params: cnn.Params) -> List[Tensor]:
    """The leaves the optimizer steps: those that take a gradient."""
    return [t for t in param_leaves(params) if t.requires_grad]


def trainable(params: cnn.Params, device: torch.device, frozen_trunk: bool = False) -> cnn.Params:
    """A copy of ``params`` on ``device`` as f32 leaves that require grad;
    with ``frozen_trunk`` an Inception stage's trunk is copied without."""

    def leaf(t, grad=True):
        return t.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(grad)

    if "backbone" in params:
        return {
            "backbone": cnn.tree_map(lambda t: leaf(t, not frozen_trunk), params["backbone"]),
            "fc2": {k: leaf(v) for k, v in params["fc2"].items()},
        }
    return cnn.tree_map(leaf, params)


def init_train_state(
    cfg: cnn.StageConfig,
    seed: int,
    make_optimizer: Callable[[List[Tensor]], ScheduledOptimizer],
    device: torch.device,
    frozen_trunk: bool = False,
) -> TrainState:
    """Glorot-initialized master weights drawn on the host from ``seed``
    (the same values on every device), moved to ``device``."""
    generator = torch.Generator().manual_seed(seed)
    params = trainable(cnn.init_stage(cfg, generator), device, frozen_trunk)
    return TrainState(params, make_optimizer(optimized_leaves(params)))


def standardize(images_u8: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return (images_u8.float() - mean) / std


def train_step(
    state: TrainState,
    cfg: cnn.StageConfig,
    loss_settings: LossSettings,
    augment_config: Optional[augment_ops.AugmentConfig],
    images_u8: Tensor,
    labels: Tensor,
    bottlenecks: Optional[Tensor],
    mean: Tensor,
    std: Tensor,
    host_generator: torch.Generator,
    device_generator: torch.Generator,
    valid_mask: Optional[Tensor] = None,
) -> Tensor:
    """One update. Augmentation draws come from ``host_generator`` (a CPU
    generator), the dropout mask from ``device_generator`` (on the batch's
    device). Returns the loss, a 0-d tensor (no host sync)."""
    x = standardize(images_u8, mean, std)
    if augment_config is not None:
        x = augment_ops.draw_and_augment(host_generator, x, labels, augment_config)
    out = cnn.apply_stage(
        state.params,
        cfg,
        x,
        bottlenecks if cfg.bottleneck_in_size is not None else None,
        dropout_keep=loss_settings.dropout_keep,
        generator=device_generator,
    )
    loss = losses.total_loss(
        out,
        labels,
        state.params,
        f_beta=loss_settings.f_beta,
        positive_proportion=loss_settings.positive_proportion,
        weighted=loss_settings.weighted,
        normalize=loss_settings.normalize,
        l2_strength=loss_settings.l2_strength,
        l1_strength=loss_settings.l1_strength,
        valid_mask=valid_mask,
    )
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step(state.step)
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_step(
    params: cnn.Params,
    cfg: cnn.StageConfig,
    images_u8: Tensor,
    labels: Tensor,
    bottlenecks: Optional[Tensor],
    mean: Tensor,
    std: Tensor,
    valid_mask: Optional[Tensor] = None,
    f_beta: Optional[float] = None,
) -> Dict[str, Tensor]:
    """Confusion-count sums of one batch (soft counts too with ``f_beta``)."""
    x = standardize(images_u8, mean, std)
    bneck = bottlenecks if cfg.bottleneck_in_size is not None else None
    out = cnn.apply_stage(params, cfg, x, bneck)
    counts = metrics.confusion_counts(out["logits"], labels, valid_mask)
    if f_beta is not None:
        counts.update(metrics.soft_confusion_counts(out["probs"], labels, valid_mask))
    return counts


@torch.no_grad()
def predict_step(
    params: cnn.Params,
    cfg: cnn.StageConfig,
    images_u8: Tensor,
    bottlenecks: Optional[Tensor],
    mean: Tensor,
    std: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(argmax labels, softmax probs, bottleneck) of one batch; the
    bottleneck is the post-concat fc1 tensor the next stage reads
    (net.py:572-652)."""
    x = standardize(images_u8, mean, std)
    bneck = bottlenecks if cfg.bottleneck_in_size is not None else None
    out = cnn.apply_stage(params, cfg, x, bneck)
    return torch.argmax(out["logits"], dim=1), out["probs"], out["bottleneck"]
