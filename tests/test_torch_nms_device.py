"""The port's device NMS tail (``ops/nms.py::group_rectangles_device_plain``,
the plain version of kernel K3) against three references, on a batch of
frames with different valid counts and an all-invalid frame:

  (a) K3 itself, ``group_rectangles_pallas(..., interpret=True)`` at eps
      0.2 (no containment): counts, averages and the pre-containment keep,
      and the labels of ``_cluster_call`` on valid rows (K3 pads N to a
      multiple of 128 and labels invalid rows with the padded N);
  (b) ``group_rectangles_jax`` at eps 0.2 and 0.35, min_neighbors 0-2,
      with nested clusters for both branches of the containment rule:
      every output equal;
  (c) the port's numpy ``group_rectangles``, as sorted kept sets.

On these inputs the JAX tail's ceil(log2 N) + 1 propagation steps reach
the connected components. Where they do not (a long chain of similar
boxes), the port runs on to them and equals the host union-find, not the
JAX tail (the last test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.ops import nms as jnms
from rapidobjectdetectionusingcascadedcnns_tpu.ops.nms_pallas import (
    _cluster_call,
    _round_up,
    group_rectangles_pallas,
)
from rapidobjectdetectionusingcascadedcnns_torch.ops import nms as tnms
from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda

from test_nms_pallas import _random_clusters
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

N = 48  # rows per frame


def _nested(count_outer, count_inner, inner):
    """A cluster of ``count_outer`` boxes around (200, 200, 120, 120) and
    one of ``count_inner`` boxes around ``inner`` (x, y, size) inside it."""
    rects = [(200 + d, 200 - d, 120 + d, 120) for d in range(count_outer)]
    x, y, s = inner
    rects += [(x + d, y, s, s + d) for d in range(count_inner)]
    return rects


def _frames():
    """Three frames with 41, 23 and 1 valid rows, plus an all-invalid one;
    invalid rows hold garbage boxes."""
    rng = np.random.RandomState(7)
    frames = [
        # an inner cluster of 2 (< 3: dropped), one of 4 under an outer
        # cluster of 5 (5 > max(3, 4): dropped), random clusters elsewhere
        np.concatenate([
            np.array(_nested(5, 2, (230, 230, 40)) + [(240, 250, 35, 35)] * 4, np.float64),
            _random_clusters(rng, 5, 6, 4),
        ]),
        # an inner cluster of 6 under an outer one of 5: kept
        np.concatenate([
            np.array(_nested(5, 6, (220, 225, 50)), np.float64),
            _random_clusters(rng, 3, 4, 3),
        ]),
        np.array([[10, 10, 50, 50]], np.float64),
        np.zeros((0, 4), np.float64),
    ]
    rects = np.zeros((len(frames), N, 4), np.float32)
    valid = np.zeros((len(frames), N), bool)
    for b, f in enumerate(frames):
        assert len(f) <= N
        order = rng.permutation(N)[: len(f)]  # valid rows scattered among pads
        rects[b] = rng.randint(0, 500, (N, 4))
        rects[b, order] = f
        valid[b, order] = True
    return rects, valid


RECTS, VALID = _frames()


def _plain(mn, eps):
    return [
        t.numpy()
        for t in tnms.group_rectangles_device_plain(
            torch.from_numpy(RECTS), torch.from_numpy(VALID), mn, eps
        )
    ]


def test_frames_cover_the_cases():
    assert VALID.sum(axis=1).tolist() == [41, 23, 1, 0]
    avg, counts, keep, labels = _plain(1, 0.2)
    assert not keep[3].any() and (labels[3] == N).all() and (counts[3] == 0).all()
    pre = (labels == np.arange(N)) & VALID & (counts > 1)
    assert (pre & ~keep).sum() >= 2  # containment dropped clusters
    assert (counts[1][keep[1]] == 6).any()  # the strong inner cluster stays


@pytest.mark.parametrize("mn", [0, 1, 2])
def test_plain_matches_k3_interpret(mn):
    """(a) K3 in interpret mode, eps 0.2, before containment."""
    avg, counts, _, labels = _plain(mn, 0.2)
    pre_keep = (labels == np.arange(N)) & VALID & (counts > mn)
    n_pad = max(_round_up(N, 128), 128)
    for b in range(len(RECTS)):
        k_avg, k_counts, k_keep = (
            np.asarray(t)
            for t in group_rectangles_pallas(RECTS[b], VALID[b], mn, interpret=True)
        )
        np.testing.assert_array_equal(avg[b], k_avg)
        np.testing.assert_array_equal(counts[b], k_counts)
        np.testing.assert_array_equal(pre_keep[b], k_keep)
        rects_p = np.zeros((n_pad, 4), np.float32)
        rects_p[:N] = RECTS[b]
        valid_p = np.zeros((n_pad, 1), np.float32)
        valid_p[:N, 0] = VALID[b]
        k_labels = np.asarray(_cluster_call(jnp.asarray(rects_p), jnp.asarray(valid_p), interpret=True)[2])
        v = VALID[b]
        np.testing.assert_array_equal(labels[b][v], k_labels[:N, 0][v].astype(np.int64))


@pytest.mark.parametrize("eps", [0.2, 0.35])
@pytest.mark.parametrize("mn", [0, 1, 2])
def test_plain_matches_group_rectangles_jax(mn, eps):
    """(b) the JAX tail, containment included: every output equal."""
    avg, counts, keep, _ = _plain(mn, eps)
    for b in range(len(RECTS)):
        j_avg, j_counts, j_keep = (
            np.asarray(t)
            for t in jnms.group_rectangles_jax(jnp.asarray(RECTS[b]), jnp.asarray(VALID[b]), mn, eps=eps)
        )
        np.testing.assert_array_equal(avg[b], j_avg)
        np.testing.assert_array_equal(counts[b], j_counts)
        np.testing.assert_array_equal(keep[b], j_keep)


@pytest.mark.parametrize("mn", [0, 1, 2])
def test_plain_matches_host_group_rectangles(mn):
    """(c) the host union-find, as sorted (x, y, w, h, count) sets."""
    avg, counts, keep, _ = _plain(mn, 0.2)
    for b in range(len(RECTS)):
        got = sorted(tuple(avg[b, i].tolist()) + (int(counts[b, i]),) for i in np.flatnonzero(keep[b]))
        kept, weights = tnms.group_rectangles(RECTS[b][VALID[b]], mn, 0.2)
        ref = sorted(tuple(r.tolist()) + (int(w),) for r, w in zip(kept, weights))
        assert got == ref


def test_cpu_wrapper_runs_the_plain_version():
    """The wrapper and its operator run the plain version on CPU tensors and
    count no kernel launch."""
    before = nms_cuda.LAUNCHES
    out = nms_cuda.group_rectangles(torch.from_numpy(RECTS), torch.from_numpy(VALID), 1, 0.2)
    assert nms_cuda.LAUNCHES == before
    for got, ref in zip(out, _plain(1, 0.2)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert [t.dtype for t in out] == [torch.int32, torch.int32, torch.bool, torch.int64]
    with pytest.raises(ValueError, match="K3 runs on CUDA"):
        nms_cuda.group_rectangles_cuda(torch.from_numpy(RECTS), torch.from_numpy(VALID), 1)


def test_plain_refuses_inexact_sums():
    """Non-integer coordinates, or a cluster sum at 2^24, would make the
    JAX tail's f32 sums inexact: refused, not approximated."""
    valid = torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="integer"):
        tnms.group_rectangles_device_plain(torch.tensor([[[1.5, 2, 3, 4], [9, 9, 9, 9]]]), valid, 0)
    big = torch.full((1, 2, 4), float(1 << 23))
    with pytest.raises(ValueError, match="2\\^24"):
        tnms.group_rectangles_device_plain(big, valid, 0)


def test_long_chain_runs_to_convergence():
    """A chain of 48 boxes, each similar only to its neighbours along the
    chain, rows in shuffled order: the JAX tail's ceil(log2 N) + 1 = 7
    steps leave its labels split, the port's propagation runs on to the
    connected components and equals the host union-find."""
    order = np.random.RandomState(3).permutation(48)
    rects = np.zeros((48, 4), np.float32)
    rects[order] = [(10 + 5 * k, 50, 40, 40) for k in range(48)]  # delta 8 > 5, < 10
    valid = np.ones(48, bool)
    avg, counts, keep, labels = tnms.group_rectangles_device_plain(
        torch.from_numpy(rects)[None], torch.from_numpy(valid)[None], 1, 0.2
    )
    assert (labels == 0).all() and (counts == 48).all() and int(keep.sum()) == 1
    kept, weights = tnms.group_rectangles(rects, 1, 0.2)
    assert weights.tolist() == [48] and avg[0, keep[0]].tolist() == kept.tolist()
    _, j_counts, j_keep = (
        np.asarray(t) for t in jnms.group_rectangles_jax(jnp.asarray(rects), jnp.asarray(valid), 1)
    )
    assert j_counts.max() < 48  # the fixed step count split the chain
