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

Every step is data parallel over a mesh (``parallel/mesh.py``; by default
the one device the batch lies on) and, inside a ``torch.distributed``
group, over its processes (``parallel/multihost.py``): the batch is padded
to a multiple of the shards with copies of its last row and a valid mask,
each shard runs the forward on its device with the master weights of mesh
device 0 moved there by a differentiable ``.to()``, and the per-row outputs
are gathered before the loss, which is formed over the whole batch (the
soft-count F-beta sums over the batch, and the weighted cross entropy
divides by its count of nonzero weights: an average of per-shard losses
would be another loss). The augmentation and the dropout mask are drawn
for the batch's real rows before the split, so a mesh run follows the
single-device run of the same seed; on one device with no padding the
step is the plain forward, loss and update.
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
from ..parallel import mesh as mesh_mod
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


def _mesh_of(mesh, batch: Tensor) -> "mesh_mod.Mesh":
    """``mesh``, or the one device ``batch`` lies on."""
    return mesh_mod.Mesh([batch.device]) if mesh is None else mesh


def _shard_multiple(mesh) -> int:
    from ..parallel import multihost

    return mesh.size * multihost.process_count()


def _pad_rows(multiple: int, n: int, valid_mask: Optional[Tensor], *tensors):
    """Each tensor (or None) padded to a multiple of ``multiple`` rows with
    copies of its last row, and the valid mask of the padded batch: the
    ``n`` real rows (those of ``valid_mask`` among them); None where every
    row is real and valid."""
    padded = [None if t is None else mesh_mod.pad_to_multiple(t, multiple)[0] for t in tensors]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return padded, valid_mask
    device = next(t.device for t in tensors if t is not None)
    valid = torch.arange(n_pad, device=device) < n
    if valid_mask is not None:
        valid = valid & mesh_mod.pad_to_multiple(valid_mask, multiple)[0]
    return padded, valid


def sharded_apply(
    params: cnn.Params,
    cfg: cnn.StageConfig,
    mesh,
    images_u8: Tensor,
    bottlenecks: Optional[Tensor],
    mean: Tensor,
    std: Tensor,
    *,
    labels: Optional[Tensor] = None,
    augment: Optional[tuple] = None,
    dropout_keep: float = 1.0,
    keep_mask: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """``cnn.apply_stage`` over a batch on mesh device 0 whose rows are a
    multiple of the mesh size times the process count: this process takes
    its contiguous rows (all of them outside a process group), each mesh
    shard standardizes its rows (and with ``augment`` = (config, color
    draws, affine draws of every row) augments them) and runs the forward
    on its device, and the outputs come back to mesh device 0 and then from
    every process (a differentiable all-gather). Every shard is enqueued
    before any output is gathered. Returns the forward's dict over the
    whole batch."""
    from ..parallel import multihost

    world = multihost.process_count()
    per_process = images_u8.shape[0] // world
    lo = multihost.process_index() * per_process
    replicas = mesh_mod.replicate(mesh, params)
    outs = []
    for k, rows in enumerate(mesh_mod.split_rows(per_process, mesh)):
        rows = slice(lo + rows.start, lo + rows.stop)
        device = mesh[k]
        with mesh_mod.on_device(device):
            x = standardize(images_u8[rows].to(device), mean.to(device), std.to(device))
            if augment is not None:
                acfg, color, affine = augment
                shard_draws = augment_ops.AffineDraws(
                    **{key: v[rows] for key, v in vars(affine).items()})
                x = augment_ops.augment_batch(x, labels[rows].to(device), acfg, color,
                                              shard_draws)
            bneck = None
            if cfg.bottleneck_in_size is not None:
                bneck = bottlenecks[rows].to(device)
            outs.append(cnn.apply_stage(
                replicas[k], cfg, x, bneck, dropout_keep=dropout_keep,
                dropout_mask=None if keep_mask is None else keep_mask[rows].to(device),
            ))
    out = {key: mesh_mod.gather(mesh, [o[key] for o in outs])
           for key in ("logits", "probs", "bottleneck")}
    if world > 1:
        out = {key: multihost.all_gather_rows(v) for key, v in out.items()}
    return out


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
    mesh=None,
    augment_draws: Optional[tuple] = None,
) -> Tensor:
    """One update of one batch (its n rows on mesh device 0, the same batch
    in every process), data parallel over ``mesh`` (default: the batch's
    device) and the process group. Augmentation draws come from
    ``host_generator`` (a CPU generator), or are given as ``augment_draws``
    ((color, affine); a test hands both packages the same values); the
    dropout mask comes from ``device_generator`` (on mesh device 0).
    Inside a group the gradients are summed over the processes and divided
    by their count: each process computes the same global loss, and the
    all-gather's backward sums every process's gradient of it. Returns the
    loss, a 0-d tensor (no host sync)."""
    from ..parallel import multihost

    mesh = _mesh_of(mesh, images_u8)
    n = images_u8.shape[0]
    multiple = _shard_multiple(mesh)
    augment = None
    if augment_config is not None:
        if augment_draws is None:
            color = augment_ops.draw_color(host_generator, augment_config.color_fast_mode)
            affine = augment_ops.draw_affine(host_generator, n, augment_config)
        else:
            color, affine = augment_draws
        affine = affine.to(mesh[0])
        fields, _ = _pad_rows(multiple, n, None, *vars(affine).values())
        augment = (augment_config, color,
                   augment_ops.AffineDraws(**dict(zip(vars(affine), fields))))
    keep = None
    if loss_settings.dropout_keep < 1.0:
        keep = cnn.dropout_keep_mask((n, cfg.bottleneck_out_size), loss_settings.dropout_keep,
                                     device_generator, mesh[0])
    (images_p, labels_p, bneck_p, keep_p), valid = _pad_rows(
        multiple, n, valid_mask, images_u8, labels, bottlenecks, keep)
    out = sharded_apply(
        state.params, cfg, mesh, images_p, bneck_p, mean, std, labels=labels_p,
        augment=augment, dropout_keep=loss_settings.dropout_keep, keep_mask=keep_p,
    )
    loss = losses.total_loss(
        out,
        labels_p,
        state.params,
        f_beta=loss_settings.f_beta,
        positive_proportion=loss_settings.positive_proportion,
        weighted=loss_settings.weighted,
        normalize=loss_settings.normalize,
        l2_strength=loss_settings.l2_strength,
        l1_strength=loss_settings.l1_strength,
        valid_mask=valid,
    )
    state.optimizer.zero_grad()
    loss.backward()
    if multihost.process_count() > 1:
        multihost.average_gradients(optimized_leaves(state.params))
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
    mesh=None,
) -> Dict[str, Tensor]:
    """Confusion-count sums of one batch (soft counts too with ``f_beta``),
    sharded as :func:`train_step`; the padding rows count nowhere."""
    mesh = _mesh_of(mesh, images_u8)
    (images_p, labels_p, bneck_p), valid = _pad_rows(
        _shard_multiple(mesh), images_u8.shape[0], valid_mask, images_u8, labels, bottlenecks)
    out = sharded_apply(params, cfg, mesh, images_p, bneck_p, mean, std)
    counts = metrics.confusion_counts(out["logits"], labels_p, valid)
    if f_beta is not None:
        counts.update(metrics.soft_confusion_counts(out["probs"], labels_p, valid))
    return counts


@torch.no_grad()
def predict_step(
    params: cnn.Params,
    cfg: cnn.StageConfig,
    images_u8: Tensor,
    bottlenecks: Optional[Tensor],
    mean: Tensor,
    std: Tensor,
    mesh=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(argmax labels, softmax probs, bottleneck) of one batch, sharded as
    :func:`train_step`, the padding rows dropped; the bottleneck is the
    post-concat fc1 tensor the next stage reads (net.py:572-652)."""
    mesh = _mesh_of(mesh, images_u8)
    n = images_u8.shape[0]
    (images_p, bneck_p), _ = _pad_rows(_shard_multiple(mesh), n, None, images_u8, bottlenecks)
    out = sharded_apply(params, cfg, mesh, images_p, bneck_p, mean, std)
    return torch.argmax(out["logits"][:n], dim=1), out["probs"][:n], out["bottleneck"][:n]
