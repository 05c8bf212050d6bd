"""Learning-rate schedule and optimizers (counterpart of train/optimizer.py
of the JAX package, which builds them with optax).

Parity with the reference (network/net_trainable.py:127-143):
  * exponential decay, staircase, ``decay_steps = iterations_total / 20``,
    floored at ``learning_rate_min`` (= 0.1 * init, config.py:567-571);
  * SGD / Adam / Momentum selected by the ``optimizer`` config int
    (config.py:169-176), momentum falling back to plain SGD when the
    momentum coefficient is 0.

``torch.optim.SGD`` (momentum without dampening or Nesterov) and
``torch.optim.Adam`` (``eps`` outside the square root) compute the updates
of ``optax.sgd`` and ``optax.adam``. optax evaluates the schedule at the
update count BEFORE it is incremented, so update k (0-based) uses
``schedule(k)``: :class:`ScheduledOptimizer` sets that rate by hand before
each step instead of trusting an ``LRScheduler``'s own counter.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import config as cf


def exponential_decay_staircase(
    init: float, decay_rate: float, decay_steps: float, floor: float
) -> Callable[[int], float]:
    """lr(step) = max(init * decay_rate^floor(step / decay_steps), floor), in
    float32 like the JAX schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        exponent = np.floor(f32(step) / f32(max(decay_steps, 1e-9)))
        return float(np.maximum(f32(init) * f32(decay_rate) ** exponent, f32(floor)))

    return schedule


def lr_schedule_from_config(iterations_total: int) -> Callable[[int], float]:
    return exponential_decay_staircase(
        init=cf.get("learning_rate_init"),
        decay_rate=cf.get("learning_rate_decay"),
        decay_steps=iterations_total / 20.0,
        floor=cf.get("learning_rate_min"),
    )


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose update k (0-based) runs at learning
    rate ``schedule(k)``."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule

    def step(self, count: int) -> None:
        lr = self.schedule(count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(
    params: Sequence[torch.Tensor],
    schedule: Callable[[int], float],
    optimizer_id: int,
    momentum: float = 0.0,
) -> ScheduledOptimizer:
    """``optimizer_id`` one of ``cf.OPTIMIZER_SGD``/``_ADAM``/``_MOMENTUM``
    (momentum 0 means plain SGD), as ``optax.sgd``/``optax.adam``."""
    params = list(params)
    lr = schedule(0)
    if optimizer_id == cf.OPTIMIZER_MOMENTUM and momentum != 0:
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    elif optimizer_id == cf.OPTIMIZER_ADAM:
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        opt = torch.optim.SGD(params, lr=lr)
    return ScheduledOptimizer(opt, schedule)


def optimizer_from_config(
    params: Sequence[torch.Tensor], iterations_total: int
) -> ScheduledOptimizer:
    return make_optimizer(
        params,
        lr_schedule_from_config(iterations_total),
        cf.get("optimizer"),
        cf.get("momentum"),
    )
