"""Port vs JAX: the training losses, their gradients and the evaluation
metrics, on the same numpy inputs from a seed.

Tolerance: rtol 1e-6 on float32 values (the two packages sum in other
orders); integer confusion counts and host-side derived metrics equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.train import losses as jlosses
from rapidobjectdetectionusingcascadedcnns_tpu.train import metrics as jmetrics
from rapidobjectdetectionusingcascadedcnns_torch.train import losses as tlosses
from rapidobjectdetectionusingcascadedcnns_torch.train import metrics as tmetrics

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)
RTOL = 1e-6
N = 97


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 2, (N, 2)).astype(np.float32)
    logits[:7, 1] = logits[:7, 0]  # equal scores: the constant-function guard
    labels = (rng.rand(N) < 0.3).astype(np.int32)
    mask = rng.rand(N) < 0.8
    params = {
        "conv": [{"W": rng.normal(0, 0.1, (3, 3, 3, 4)).astype(np.float32),
                  "b": rng.normal(0, 0.1, (4,)).astype(np.float32)}],
        "fc1": {"W": rng.normal(0, 0.1, (36, 8)).astype(np.float32),
                "b": rng.normal(0, 0.1, (8,)).astype(np.float32)},
        "fc2": {"W": rng.normal(0, 0.1, (8, 2)).astype(np.float32),
                "b": rng.normal(0, 0.1, (2,)).astype(np.float32)},
    }
    return logits, labels, mask, params


def _t(x):
    return torch.tensor(np.asarray(x))


def _tparams(params):
    return {
        "conv": [{k: _t(v) for k, v in layer.items()} for layer in params["conv"]],
        "fc1": {k: _t(v) for k, v in params["fc1"].items()},
        "fc2": {k: _t(v) for k, v in params["fc2"].items()},
    }


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=RTOL, atol=1e-7)


def test_cross_entropy_matches_jax(batch):
    logits, labels, mask, _ = batch
    for weighted in (False, True):
        for normalize in (False, True):
            for m in (None, mask):
                ref = jlosses.weighted_cross_entropy(
                    jnp.asarray(logits), jnp.asarray(labels), 0.3, weighted=weighted,
                    normalize=normalize, valid_mask=None if m is None else jnp.asarray(m))
                got = tlosses.weighted_cross_entropy(
                    _t(logits), _t(labels), 0.3, weighted=weighted, normalize=normalize,
                    valid_mask=None if m is None else _t(m))
                _close(got, ref)


def test_fbeta_regularization_and_total_loss_match_jax(batch):
    logits, labels, mask, params = batch
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for beta in (1.0, 4.0, 24.0):
        for m in (None, mask):
            jm, tm = (None, None) if m is None else (jnp.asarray(m), _t(m))
            _close(tlosses.soft_fbeta_score(_t(probs), _t(labels), beta, tm),
                   jlosses.soft_fbeta_score(jnp.asarray(probs), jnp.asarray(labels), beta, jm))
            _close(tlosses.soft_fbeta_loss(_t(probs), _t(labels), beta, tm),
                   jlosses.soft_fbeta_loss(jnp.asarray(probs), jnp.asarray(labels), beta, jm))
    # all-background predictions: every guarded division yields 0
    zeros = np.zeros((N, 2), np.float32)
    zeros[:, 0] = 1.0
    assert float(tlosses.soft_fbeta_score(_t(zeros), _t(labels), 2.0)) == float(
        jlosses.soft_fbeta_score(jnp.asarray(zeros), jnp.asarray(labels), 2.0)) == 0.0
    for l2, l1 in ((0.0, 0.0), (0.01, 0.0), (0.0, 0.002), (0.01, 0.002)):
        _close(tlosses.fc_regularization(_tparams(params), l2, l1),
               jlosses.fc_regularization(jax.tree_util.tree_map(jnp.asarray, params), l2, l1))
    outputs = {"logits": logits, "probs": probs}
    for f_beta in (None, 4.0):
        ref = jlosses.total_loss(
            {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(labels),
            jax.tree_util.tree_map(jnp.asarray, params), f_beta=f_beta,
            positive_proportion=0.3, l2_strength=0.01, l1_strength=0.002,
            valid_mask=jnp.asarray(mask))
        got = tlosses.total_loss(
            {k: _t(v) for k, v in outputs.items()}, _t(labels), _tparams(params),
            f_beta=f_beta, positive_proportion=0.3, l2_strength=0.01, l1_strength=0.002,
            valid_mask=_t(mask))
        _close(got, ref)


def test_loss_gradients_match_jax(batch):
    """d(loss)/d(logits) through autograd equals jax.grad, for the cross
    entropy and the soft F-beta loss (through the softmax)."""
    logits, labels, mask, _ = batch

    def jloss(lg, f_beta):
        out = {"logits": lg, "probs": jax.nn.softmax(lg, axis=-1)}
        return jlosses.total_loss(out, jnp.asarray(labels), {}, f_beta=f_beta,
                                  positive_proportion=0.3, valid_mask=jnp.asarray(mask))

    for f_beta in (None, 4.0):
        ref = jax.grad(jloss)(jnp.asarray(logits), f_beta)
        lg = _t(logits).clone().requires_grad_(True)
        out = {"logits": lg, "probs": torch.softmax(lg, dim=-1)}
        tlosses.total_loss(out, _t(labels), {}, f_beta=f_beta, positive_proportion=0.3,
                           valid_mask=_t(mask)).backward()
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_confusion_counts_match_jax(batch):
    logits, labels, mask, _ = batch
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for m in (None, mask):
        jm, tm = (None, None) if m is None else (jnp.asarray(m), _t(m))
        ref = jmetrics.confusion_counts(jnp.asarray(logits), jnp.asarray(labels), jm)
        got = tmetrics.confusion_counts(_t(logits), _t(labels), tm)
        assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in ref.items()}
        ref = jmetrics.soft_confusion_counts(jnp.asarray(probs), jnp.asarray(labels), jm)
        got = tmetrics.soft_confusion_counts(_t(probs), _t(labels), tm)
        assert got.keys() == ref.keys()
        for k in ref:
            _close(got[k], ref[k])


def test_process_and_accumulate_results_match_jax(batch):
    logits, labels, mask, _ = batch
    counts = {k: int(v) for k, v in tmetrics.confusion_counts(
        _t(logits), _t(labels), _t(mask)).items()}
    for f_beta in (None, 2.0):
        assert tmetrics.process_results(counts, f_beta) == jmetrics.process_results(
            counts, f_beta)
    degenerate = {"true_positives": 0, "true_negatives": 0, "false_negatives": 0,
                  "false_positives": 0}
    assert tmetrics.process_results(degenerate, 1.0) == jmetrics.process_results(
        degenerate, 1.0)
    with pytest.raises(ValueError):
        tmetrics.process_results({"true_positives": 1})
    per_batch = [tmetrics.process_results(counts, 2.0), tmetrics.process_results(degenerate)]
    assert tmetrics.accumulate_batch_results(per_batch) == jmetrics.accumulate_batch_results(
        per_batch)
    assert tmetrics.accumulate_batch_results([]) == {}
    for key in ("accuracy", "f1_score", "true_positives", tmetrics.f_beta_key(2.0),
                "f_3.00_score_diffable"):
        t, j = tmetrics.get(key), jmetrics.get(key)
        assert (t.key, t.acc_mean, t.format(0.25)) == (j.key, j.acc_mean, j.format(0.25))
    with pytest.raises(ValueError):
        tmetrics.get("no_such_metric")
