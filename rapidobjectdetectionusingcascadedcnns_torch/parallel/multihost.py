"""Multi-process runs over ``torch.distributed`` (counterpart of
parallel/multihost.py of the JAX package).

Every process runs the same program; the process group joins them (NCCL
when the process's device is a CUDA card, gloo on the CPU). A process holds
its part of the global mesh, its local devices (:func:`global_mesh`); the
global batch is split over the processes in contiguous rows, and over each
process's mesh within them (``train/train_step.sharded_apply``).

  * :func:`initialize`: joins the group from torch's standard environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) or from
    arguments; idempotent, and single-process without either;
  * :func:`host_local_batch_to_global`: an all-gather of each process's
    contiguous rows (pairs with ``data.prefetch.shard_for_host``, which
    splits the corpus per process);
  * :func:`rehearsal`: one data-parallel training and evaluation step;
    :func:`workflow_rehearsal`: a multi-epoch ``SingleNetTrainer`` run, its
    export on process 0, a barrier, and every process restoring and
    evaluating it. ``tools/multihost_torch_worker.py`` runs either in one
    process of a group.

Every process computes the same global loss from a differentiable
all-gather of the per-row outputs; the all-gather's backward sums the
processes' gradients of it, so :func:`average_gradients` all-reduces the
parameter gradients and divides them by the process count.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist else 1


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> bool:
    """Join the process group (idempotent). With no ``init_method`` the
    standard environment is read; without ``MASTER_ADDR`` and
    ``WORLD_SIZE`` the run stays single-process. ``device``: this
    process's device (default the CUDA card; a bare ``"cuda"`` is card
    ``LOCAL_RANK``, else the rank modulo the card count): NCCL for a card,
    gloo for the CPU. Returns whether the process is in a group."""
    import torch.distributed as dist

    from ..utils.device import resolve_device

    if _group() is not None:
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def process_device(device=None) -> torch.device:
    """This process's device: in a group, the group's (the current card
    under NCCL, the CPU under gloo); else ``device`` (default the card)."""
    from ..utils.device import resolve_device

    dist = _group()
    if dist is None:
        return resolve_device(device)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(device=None):
    """This process's part of the global mesh: its device. The global mesh
    is every process's part, in rank order."""
    from .mesh import Mesh

    return Mesh([process_device(device)])


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``t`` concatenated in rank order, through a
    differentiable all-gather (each process holds rows of one shape)."""
    import torch.distributed.nn.functional as dist_fn

    return torch.cat(dist_fn.all_gather(t))


def average_gradients(leaves: Sequence[torch.Tensor]) -> None:
    """Sum each leaf's gradient over the processes and divide it by their
    count."""
    dist = _group()
    world = dist.get_world_size()
    for t in leaves:
        if t.grad is not None:
            dist.all_reduce(t.grad)
            t.grad /= world


def host_local_batch_to_global(*host_arrays, device=None):
    """Global arrays from each process's contiguous local rows: an
    all-gather, on this process's device. Single-process: the arrays
    themselves, on ``device``."""
    device = process_device(device)
    out = []
    for a in host_arrays:
        t = torch.as_tensor(np.asarray(a), device=device)
        out.append(all_gather_rows(t) if process_count() > 1 else t)
    return tuple(out) if len(out) > 1 else out[0]


def barrier() -> None:
    dist = _group()
    if dist is not None:
        dist.barrier()


def rehearsal(global_batch: int = 32, seed: int = 0, initial_params=None,
              augment_draws=None, device=None) -> Dict[str, Any]:
    """One deterministic data-parallel training and evaluation step (JAX
    ``multihost.rehearsal``): the global batch is drawn from ``seed`` (so the
    run does not depend on the process count), each process takes its
    contiguous rows through :func:`host_local_batch_to_global`, and the
    sharded training step runs over the global mesh, with the online
    augmentation of the configured settings as the JAX step applies it.
    ``initial_params``: the stage's starting weights (a port parameter
    tree), e.g. the JAX rehearsal's initial state through ``models/bridge``;
    default the port's init from ``seed``. ``augment_draws``: (color,
    affine) draws in place of the ones from ``seed`` (the JAX rehearsal's,
    for a comparison with it). Returns the loss, the squared size of the
    update (``update_sq``: the gradients' scale), the evaluation count and
    the process layout: the same in every process, and equal to a
    single-process run of the same batch."""
    from .. import config as cf
    from ..data.prefetch import shard_for_host
    from ..models import cnn
    from ..ops import augment as augment_ops
    from ..train import optimizer as opt_mod
    from ..train import train_step

    cf.set("conv_filter_sizes", [8])
    cf.set("fc1_size", 32)
    cf.set("compute_dtype", "float32")
    cf.set("optimizer", cf.OPTIMIZER_SGD)
    cf.set("data_augmentation_online", False)

    mesh = global_mesh(device)
    device = mesh[0]
    size = 12
    stage_cfg = cnn.StageConfig.from_config(size, bottleneck_in_size=16)

    def make_optimizer(leaves):
        return opt_mod.optimizer_from_config(leaves, iterations_total=100)

    if initial_params is None:
        state = train_step.init_train_state(stage_cfg, seed, make_optimizer, device)
    else:
        params = train_step.trainable(initial_params, device)
        state = train_step.TrainState(params, make_optimizer(train_step.optimized_leaves(params)))
    loss_settings = train_step.LossSettings(
        f_beta=8.0,
        positive_proportion=0.25,
        weighted=True,
        normalize=False,
        l2_strength=1e-4,
        l1_strength=0.0,
        dropout_keep=1.0,  # deterministic across processes
    )

    # the GLOBAL batch, drawn deterministically; each process takes its rows
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(global_batch, size, size, 3), dtype=np.uint8)
    labels = (np.arange(global_batch) % 2).astype(np.int64)
    bottlenecks = rng.rand(global_batch, 16).astype(np.float32)
    per_process = global_batch // process_count()
    lo = process_index() * per_process
    hi = lo + per_process
    images_g, labels_g, bneck_g = host_local_batch_to_global(
        images[lo:hi], labels[lo:hi], bottlenecks[lo:hi], device=device
    )
    initial = [t.detach().clone() for t in train_step.param_leaves(state.params)]
    mean = torch.full((size, size, 3), 127.5, device=device)
    std = torch.full((size, size, 3), 64.0, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss = train_step.train_step(
        state, stage_cfg, loss_settings, augment_ops.AugmentConfig.from_config(),
        images_g, labels_g, bneck_g, mean, std, torch.Generator().manual_seed(seed), generator,
        mesh=mesh, augment_draws=augment_draws,
    )
    counts = train_step.eval_step(
        state.params, stage_cfg, images_g, labels_g, bneck_g, mean, std, f_beta=8.0, mesh=mesh
    )
    # the updated weights, which show the gradients' scale over processes
    update_sq = sum(float(((t.detach() - t0) ** 2).double().sum()) for t, t0 in zip(
        train_step.param_leaves(state.params), initial))
    # the strided corpus split covers every sample once across processes
    local = shard_for_host(list(range(100)))
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "global_devices": process_count() * mesh.size,
        "local_devices": mesh.size,
        "loss": float(loss),
        "update_sq": update_sq,
        "eval_total": int(
            counts["true_positives"] + counts["false_positives"]
            + counts["true_negatives"] + counts["false_negatives"]
        ),
        "host_corpus_len": len(local),
    }


def workflow_rehearsal(work_dir: str, epochs: int = 2, seed: int = 0,
                       device=None) -> Dict[str, Any]:
    """The multi-process training workflow (JAX
    ``multihost.workflow_rehearsal``): a multi-epoch ``SingleNetTrainer``
    run over the global mesh, its export on process 0, a barrier, then every
    process restores the same checkpoint and evaluates it; the evaluation
    must be the same in every process and equal the exporting trainer's.
    The processes share one file system."""
    from .. import config as cf
    from ..train import checkpoint
    from ..train.cascade_trainer import SyntheticProvider
    from ..train.trainer import SingleNetTrainer

    proc = process_index()
    cf.set("conv_filter_sizes", [8])
    cf.set("fc1_size", 32)
    cf.set("compute_dtype", "float32")
    cf.set("optimizer", cf.OPTIMIZER_ADAM)
    cf.set("learning_rate_init", 0.003)
    cf.set("data_augmentation_online", False)
    cf.set("dropout_rate", 1.0)
    cf.set("batch_size", 32)
    cf.set("max_batch_size", 64)
    cf.set("epochs_total", epochs)
    cf.set("n_max_constant_evals", None)
    # per-process snapshots and summaries (one shared session key would
    # race on one file)
    cf.set("snapshot_dir", os.path.join(work_dir, "snap_p{}".format(proc)))
    cf.set("summary_dir", os.path.join(work_dir, "summary_p{}".format(proc)))

    mesh = global_mesh(device)
    # the same corpus in every process, so every process assembles the same
    # batches
    ds = SyntheticProvider(32, 32, [12], seed=seed).dataset(12)
    trainer = SingleNetTrainer(ds, f_beta=None, seed=seed, mesh=mesh)
    trainer.train()
    pre_eval = trainer.evaluate_split(ds.valid)

    export_dir = os.path.join(work_dir, "export")
    if proc == 0:
        os.makedirs(export_dir, exist_ok=True)
        trainer.export(export_dir, "mh_workflow")
    barrier()
    ckpt_path = checkpoint.single_model_path(export_dir, "mh_workflow")
    restored = SingleNetTrainer(ds, f_beta=None, seed=seed + 99,
                                snapshot_full_path=str(ckpt_path), mesh=mesh)
    post_eval = restored.evaluate_split(ds.valid)

    keys = ("true_positives", "false_positives", "true_negatives", "false_negatives")
    return {
        "process_index": proc,
        "process_count": process_count(),
        "epochs": epochs,
        "iterations_total": trainer.iterations_total,
        "final_loss": trainer._last_loss,
        "pre_eval_counts": {k: pre_eval[k] for k in keys},
        "post_restore_counts": {k: post_eval[k] for k in keys},
        "checkpoint": str(ckpt_path),
    }
