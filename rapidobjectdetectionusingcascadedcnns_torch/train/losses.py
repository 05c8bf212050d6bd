"""Training losses (counterpart of train/losses.py of the JAX package).

  * weighted / unweighted cross entropy with the unbalanced-data ratio
    weighting (network/net_trainable.py:66-100);
  * the differentiable soft-count F-beta loss: probabilistic TP/FP/FN from
    softmax foreground probabilities, guarded divisions, loss = 1 - F_beta
    (network/net.py:418-442, net_trainable.py:102-107);
  * optional L2/L1 regularization on the fully-connected weights only
    (net_trainable.py:109-124).

Every function takes and returns float32 tensors and is differentiable
through autograd; ``valid_mask`` excludes padding rows as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def weighted_cross_entropy(
    logits: Tensor,
    labels: Tensor,
    positive_proportion: float,
    *,
    weighted: bool = True,
    normalize: bool = False,
    valid_mask: Optional[Tensor] = None,
) -> Tensor:
    """Sparse softmax cross entropy, optionally class-weighted.

    ``positive_proportion``: fraction of foreground samples in the training
    distribution. With ``weighted`` the foreground loss is scaled to the
    level of the imbalance (net_trainable.py:73-94); ``normalize`` makes the
    two weights sum to 1. Reduced like tf.losses' SUM_BY_NONZERO_WEIGHTS:
    ``sum(w * nll) / count(w != 0)``.
    """
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    if not weighted:
        if valid_mask is None:
            return nll.mean()
        m = valid_mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)

    p = positive_proportion
    if normalize:
        fg_w, bg_w = 1.0 - p, p
    else:
        bg_w, fg_w = 1.0, (1.0 - p) / p
    y = labels.float()
    weights = y * (fg_w - bg_w) + bg_w
    if valid_mask is not None:
        weights = weights * valid_mask.float()
    nonzero = (weights != 0).float().sum()
    return (weights * nll).sum() / torch.clamp(nonzero, min=1.0)


def soft_fbeta_score(
    probs: Tensor, labels: Tensor, beta: float, valid_mask: Optional[Tensor] = None
) -> Tensor:
    """Differentiable F-beta from soft counts (network/net.py:418-442).

    ``probs``: (N, 2) softmax outputs; ``labels``: (N,) int {0, 1}. Every
    division is guarded to 0 like the reference's tf.cond guards.
    """
    y = labels.float()
    p_fg, p_bg = probs[:, 1], probs[:, 0]
    if valid_mask is not None:
        m = valid_mask.float()
        p_fg, p_bg = p_fg * m, p_bg * m
    tp = (p_fg * y).sum()
    fp = (p_fg * (1.0 - y)).sum()
    fn = (p_bg * y).sum()
    zero = torch.zeros_like(tp)
    beta_sq = beta * beta
    precision = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-30), zero)
    recall = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1e-30), zero)
    denom = beta_sq * precision + recall
    return torch.where(
        denom > 0,
        (1.0 + beta_sq) * precision * recall / torch.clamp(denom, min=1e-30),
        zero,
    )


def soft_fbeta_loss(
    probs: Tensor, labels: Tensor, beta: float, valid_mask: Optional[Tensor] = None
) -> Tensor:
    """Loss = 1 - soft F-beta (net_trainable.py:102-107)."""
    return 1.0 - soft_fbeta_score(probs, labels, beta, valid_mask)


def fc_regularization(
    params: Dict[str, object], l2_strength: float = 0.0, l1_strength: float = 0.0
) -> Tensor:
    """L2/L1 penalties on fc1/fc2 weights and biases (net_trainable.py:109-124);
    an Inception stage has no fc1, so fc2 alone."""
    leaves = [params["fc2"]["W"], params["fc2"]["b"]]
    if "fc1" in params:
        leaves += [params["fc1"]["W"], params["fc1"]["b"]]
    reg = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if l2_strength > 0:
        reg = reg + l2_strength * sum(0.5 * (w * w).sum() for w in leaves)
    if l1_strength > 0:
        reg = reg + l1_strength * sum(w.abs().sum() for w in leaves)
    return reg


def total_loss(
    outputs: Dict[str, Tensor],
    labels: Tensor,
    params: Dict[str, object],
    *,
    f_beta: Optional[float],
    positive_proportion: float,
    weighted: bool = True,
    normalize: bool = False,
    l2_strength: float = 0.0,
    l1_strength: float = 0.0,
    valid_mask: Optional[Tensor] = None,
) -> Tensor:
    """The training loss of NetTrainable._set_up_architecture_training
    (net_trainable.py:57-124): soft F-beta when ``f_beta`` is set, else
    (weighted) cross entropy; plus the FC regularizers."""
    if f_beta is not None:
        loss = soft_fbeta_loss(outputs["probs"], labels, f_beta, valid_mask)
    else:
        loss = weighted_cross_entropy(
            outputs["logits"],
            labels,
            positive_proportion,
            weighted=weighted,
            normalize=normalize,
            valid_mask=valid_mask,
        )
    if l2_strength > 0 or l1_strength > 0:
        loss = loss + fc_regularization(params, l2_strength, l1_strength)
    return loss
