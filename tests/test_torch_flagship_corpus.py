"""Port vs JAX: the flagship recipe's corpora, bit for bit.

Both packages draw from the same numpy seeds, so every comparison is
exact (no tolerance):

  * ``ops/sampling.py``: ``random_img_patch`` (patches, boxes and the
    generator state after the draws, for several seeds; the
    ``PotentialDeadlockError`` of a fully restricted image and the
    ``ValueError`` of an undersized one) and ``sample_image`` (foreground
    crops and rejection-sampled backgrounds of scenes);
  * ``make_multiresolution_scene_patch_dataset`` at 12/40 samples and
    [12, 24, 48] px, as drawn and with every fifth background draw turned
    into a deadlock (a scene's negatives stop at its first one);
  * ``SyntheticProvider`` with ``source="scenes"`` and ``"mixed"``, the
    latter with slices of the committed mined hard negatives and positives
    appended: labels and images at every size; a mined patch at the wrong
    resolution raises ``ValueError`` in both.
"""

import os

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic as jsyn
from rapidobjectdetectionusingcascadedcnns_tpu.ops import sampling as jsampling
from rapidobjectdetectionusingcascadedcnns_tpu.train import cascade_trainer as jct
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic as tsyn
from rapidobjectdetectionusingcascadedcnns_torch.ops import sampling as tsampling
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct

from torch_parity import configure, reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "artifacts")
SIZES = [12, 24, 48]
SAMPLING_SEEDS = (0, 1, 7, 123)


def _mined():
    """Slices of the committed mined windows (48 px): 9 negatives, 5
    positives."""
    with np.load(os.path.join(ARTIFACTS, "hard_negatives.npz")) as z:
        neg = z["images"][:9]
    with np.load(os.path.join(ARTIFACTS, "hard_positives.npz")) as z:
        pos = z["images"][:5]
    return neg, pos


def _provider(ct, source):
    neg, pos = _mined()
    if source == "mixed":
        return ct.SyntheticProvider(11, 30, SIZES, seed=3, source=source,
                                    hard_negatives=neg, hard_positives=pos)
    return ct.SyntheticProvider(10, 25, SIZES, seed=2, source=source)


def _with_deadlocks(sampling):
    """``sampling.random_img_patch`` patched to raise a deadlock (after its
    draws) on every fifth call."""
    mp = pytest.MonkeyPatch()
    real, calls = sampling.random_img_patch, [0]

    def flaky(*args, **kwargs):
        calls[0] += 1
        out = real(*args, **kwargs)
        if calls[0] % 5 == 3:
            raise sampling.PotentialDeadlockError("planted")
        return out

    mp.setattr(sampling, "random_img_patch", flaky)
    return mp


def _deadlock_corpus(syn, sampling):
    mp = _with_deadlocks(sampling)
    try:
        return syn.make_multiresolution_scene_patch_dataset(12, 40, SIZES, seed=5)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's corpora, computed once for the module."""
    configure()
    return {
        "corpus": jsyn.make_multiresolution_scene_patch_dataset(12, 40, SIZES, seed=5),
        "corpus_deadlock": _deadlock_corpus(jsyn, jsampling),
        "scenes": _provider(jct, "scenes"),
        "mixed": _provider(jct, "mixed"),
    }


def _draws(sampling, seed):
    """Every outcome of ``random_img_patch`` on one scene from ``seed``:
    clear draws, a fully restricted image (deadlock) and an undersized one,
    with the generator's state after each."""
    scene = tsyn.make_scene(120, 160, n_faces=2, seed=seed, min_face=30, max_face=60)
    rng = np.random.RandomState(seed)
    out = []
    restricted = scene.boxes.astype(np.float64)
    for _ in range(6):
        patch, box = sampling.random_img_patch(scene.image, restricted, 0.05, 24, rng)
        out.append((patch.copy(), box, rng.get_state()[2]))
    full = np.array([[0.0, 0.0, 160.0, 120.0]])
    with pytest.raises(sampling.PotentialDeadlockError):
        sampling.random_img_patch(scene.image, full, 0.0, 24, rng, max_tries=7)
    out.append(("deadlock", rng.get_state()[2]))
    with pytest.raises(ValueError):
        sampling.random_img_patch(scene.image[:20], restricted, 0.05, 24, rng)
    out.append(("undersized", rng.get_state()[2]))
    return out


def _sample_images(sampling, seed):
    """``sample_image`` of three scenes (annotation crops, backgrounds)."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(3):
        scene = tsyn.make_scene(96, 128, n_faces=2, seed=seed + s, min_face=24, max_face=56)
        fg, bg = sampling.sample_image(scene.image, scene.boxes, 24, rng)
        out.append(([f.copy() for f in fg], [b.copy() for b in bg]))
    return out


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("what", ["random_img_patch", "sample_image"])
def test_sampling_matches_jax(what):
    """The port's rejection sampling draws what the JAX package draws, in
    the same order, for several seeds."""
    configure(sampling_multiplier=6)
    fn = _draws if what == "random_img_patch" else _sample_images
    for seed in SAMPLING_SEEDS:
        _assert_same(fn(tsampling, seed), fn(jsampling, seed))


def test_scene_corpus_bit_equal(jax_reference):
    configure()
    drawn = tsyn.make_multiresolution_scene_patch_dataset(12, 40, SIZES, seed=5)
    deadlocked = _deadlock_corpus(tsyn, tsampling)
    for got, ref in ((drawn, jax_reference["corpus"]),
                     (deadlocked, jax_reference["corpus_deadlock"])):
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        assert sorted(got["images"]) == sorted(ref["images"]) == SIZES
        for size in SIZES:
            assert got["images"][size].shape == (52, size, size, 3)
            np.testing.assert_array_equal(got["images"][size], ref["images"][size])
    # the deadlocks cut scenes short, so later negatives come from later scenes
    assert not np.array_equal(drawn["images"][48], deadlocked["images"][48])


@pytest.mark.parametrize("source", ["scenes", "mixed"])
def test_provider_matches_jax(jax_reference, source):
    """Labels and images at every size equal the JAX provider's (the mixed
    corpus with mined negatives and positives appended before the
    shuffle)."""
    configure()
    got, ref = _provider(tct, source), jax_reference[source]
    np.testing.assert_array_equal(got._labels, ref._labels)
    for size in SIZES:
        np.testing.assert_array_equal(got._images[size], ref._images[size])
        np.testing.assert_array_equal(got.dataset(size).images, ref.dataset(size).images)
    if source == "mixed":
        assert len(got._labels) == 11 + 30 + 9 + 5 and int(got._labels.sum()) == 11 + 5
        wrong = np.zeros((2, 24, 24, 3), np.uint8)
        for ct in (tct, jct):
            with pytest.raises(ValueError, match="top stage resolution"):
                ct.SyntheticProvider(4, 4, SIZES, source="mixed", hard_positives=wrong)
