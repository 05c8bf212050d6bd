"""Evaluation metrics: confusion sums on the device, stable derivation on
the host (counterpart of train/metrics.py of the JAX package).

Mirrors the reference split:
  * integer confusion counts with the "different probs" guard
    (network/net.py:351-401), returned as sums that are added across
    batches;
  * numerically-stable recomputation of accuracy / precision / recall /
    F-scores / TNR from the summed counts on the host
    (network/net.py:485-549);
  * criteria registry with per-metric formatting and accumulation policy
    (network/criteria.py).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

# ---------------------------------------------------------------------------
# criteria registry (network/criteria.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Criteria:
    key: str
    format_func: Callable[[float], str]
    acc_mean: bool  # mean-accumulated across batches, else summed

    def format(self, value) -> str:
        return self.format_func(value)


def format_perc_3(value) -> str:
    return "{:.3f}%".format(value * 100)


def format_3(value) -> str:
    return "{:.3f}".format(value)


def format_int(value) -> str:
    return "{}".format(int(value))


_all_criterias: Dict[str, Criteria] = {}


def _register(key, fmt, acc_mean):
    _all_criterias[key] = Criteria(key, fmt, acc_mean)


for _k in ("accuracy", "precision", "recall", "true_negative_rate",
           "precision_diffable", "recall_diffable"):
    _register(_k, format_perc_3, True)
_register("f1_score", format_3, True)
for _k in (
    "true_positives",
    "false_positives",
    "true_negatives",
    "false_negatives",
    "true_positives_diffable",
    "false_positives_diffable",
    "false_negatives_diffable",
    "samples_positive",
    "samples_negative",
):
    _register(_k, format_int, False)


def get(key: str) -> Criteria:
    if key not in _all_criterias:
        # f_<beta>_score criteria are created dynamically like f1_score
        # (network/criteria.py:57-62)
        if key.startswith("f_") and (
            key.endswith("_score") or key.endswith("_score_diffable")
        ):
            _register(key, format_3, True)
        else:
            raise ValueError("The criteria {} has not been configured yet.".format(key))
    return _all_criterias[key]


def f_beta_key(beta: float) -> str:
    return "f_{:.2f}_score".format(beta)


# ---------------------------------------------------------------------------
# confusion sums on the device
# ---------------------------------------------------------------------------


def confusion_counts(
    logits: torch.Tensor, labels: torch.Tensor, valid_mask: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Integer TP/FP/TN/FN sums for one batch (0-d int64 tensors).

    Correctness uses argmax plus the reference's anti-constant-function
    guard: a prediction only counts as correct if the two class scores
    differ (network/net.py:355-364). ``valid_mask`` excludes padding rows.
    """
    best = torch.argmax(logits, dim=1)
    different = logits[:, 0] != logits[:, 1]
    correct = (best == labels.long()) & different
    is_pos = labels.to(torch.bool)
    is_neg = ~is_pos
    wrong = ~correct
    valid = torch.ones_like(is_pos) if valid_mask is None else valid_mask.to(torch.bool)
    return {
        "true_positives": (correct & is_pos & valid).sum(),
        "false_positives": (wrong & is_neg & valid).sum(),
        "true_negatives": (correct & is_neg & valid).sum(),
        "false_negatives": (wrong & is_pos & valid).sum(),
    }


def soft_confusion_counts(
    probs: torch.Tensor, labels: torch.Tensor, valid_mask: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Probabilistic ("diffable") confusion sums (network/net.py:425-427)."""
    y = labels.float()
    v = torch.ones_like(y) if valid_mask is None else valid_mask.float()
    return {
        "true_positives_diffable": (probs[:, 1] * y * v).sum(),
        "false_positives_diffable": (probs[:, 1] * (1.0 - y) * v).sum(),
        "false_negatives_diffable": (probs[:, 0] * y * v).sum(),
    }


# ---------------------------------------------------------------------------
# host-side stable post-processing (network/net.py:485-549)
# ---------------------------------------------------------------------------


def process_results(
    results: Dict[str, float], f_beta: Optional[float] = None
) -> "collections.OrderedDict[str, float]":
    """Derive accuracy/precision/recall/F-scores from summed confusion counts.

    Divisions guard against zero denominators by leaving the numerator value
    (reference semantics, net.py:506-534).
    """
    required = ("true_positives", "true_negatives", "false_negatives", "false_positives")
    if not all(k in results for k in required):
        raise ValueError("Missing result values.")
    results = dict(results)
    tp = float(results["true_positives"])
    tn = float(results["true_negatives"])
    fn = float(results["false_negatives"])
    fp = float(results["false_positives"])

    n_total = tp + tn + fn + fp
    results["accuracy"] = (tp + tn) / n_total if n_total > 0 else 0.0

    precision = tp
    if tp + fp > 0:
        precision /= tp + fp
    results["precision"] = precision

    recall = tp
    if tp + fn > 0:
        recall /= tp + fn
    results["recall"] = recall

    tnr = tn
    if tn + fp > 0:
        tnr /= tn + fp
    results["true_negative_rate"] = tnr

    f1 = 2.0 * precision * recall
    if precision + recall > 0:
        f1 /= precision + recall
    results["f1_score"] = f1

    if f_beta is not None:
        beta_sq = f_beta * f_beta
        fb = (1.0 + beta_sq) * precision * recall
        if beta_sq * precision + recall > 0:
            fb /= beta_sq * precision + recall
        results[f_beta_key(f_beta)] = fb

    results["samples_positive"] = tp + fn
    results["samples_negative"] = tn + fp
    return collections.OrderedDict(sorted(results.items()))


def log_results(results: Dict[str, float], first_line: str = "results:") -> None:
    from ..utils import log

    log.log(first_line)
    for key, value in results.items():
        log.log("    - {}: {}".format(key, get(key).format(value)))


def accumulate_batch_results(
    batch_results: list,
) -> Dict[str, float]:
    """Merge per-batch metric dicts: counts are summed, mean-criteria averaged
    (network/net.py:296-332)."""
    if not batch_results:
        return {}
    acc: Dict[str, float] = {}
    for res in batch_results:
        for key, value in res.items():
            acc[key] = acc.get(key, 0.0) + float(value)
    n = float(len(batch_results))
    for key in acc:
        if get(key).acc_mean:
            acc[key] /= n
    return acc
