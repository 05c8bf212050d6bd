"""Datasets, splits and batch iterators.

Functional re-design of the reference data structures
(data/datasets.py:28-671):

  * ``DataBundle``      — images/labels/bottlenecks triple.
  * ``Dataset``         — fractional train/valid/test slicing with the
    reference's rounding (``int(round(weight * n))``, datasets.py:176-180).
  * ``DatasetSplit``    — swappable bottlenecks + per-sample probability
    distribution with ``positive_proportion`` (datasets.py:594-671).
  * ``DeterministicIterator`` / ``RandomizedIterator`` — epoch-permutation
    vs weighted-choice-without-replacement batching (datasets.py:475-591).
  * :func:`deterministic_shuffle` — the seeded shuffle applied when a dataset
    is assembled; depends only on (seed, n) so datasets of different image
    resolutions stay aligned across cascade stages
    (data/db/dataset_loader.py:328-388 and test_dataset_loader.py:81-89).

The port's copy of the JAX package's ``data/dataset.py`` (numpy only): the
same seeds give the same batch stream in both packages. Iterators are
host-side index generators; the arrays they slice are moved to the device
by the train steps.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..labels import IID_FOREGROUND
from .preprocessor import Preprocessor

SPLIT_KEY_TRAIN = "train"
SPLIT_KEY_VAL = "valid"
SPLIT_KEY_TEST = "test"
SPLIT_KEYS = (SPLIT_KEY_TRAIN, SPLIT_KEY_VAL, SPLIT_KEY_TEST)


def deterministic_shuffle(n: int, seed: int = 93452) -> np.ndarray:
    """Permutation of ``range(n)`` that depends only on (seed, n).

    Cascade stages reload the dataset at a new resolution and must see the
    *same* sample order so labels/bottlenecks/weights stay aligned
    (app/train_cascade_app.py:244-269).
    """
    rng = np.random.RandomState(seed)
    return rng.permutation(n)


class Batch:
    """One batch of images/labels(/bottlenecks)."""

    __slots__ = ("images", "labels", "bottlenecks", "indices")

    def __init__(self, images, labels, bottlenecks=None, indices=None):
        self.images = images
        self.labels = labels
        self.bottlenecks = bottlenecks
        self.indices = indices

    @property
    def n_samples(self) -> int:
        return len(self.images)


class DatasetSplit:
    """A slice of a dataset with optional sampling weights."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        bottlenecks: Optional[np.ndarray] = None,
        probability_distribution: Optional[np.ndarray] = None,
    ):
        self.images = images
        self.labels = labels
        self.bottlenecks = bottlenecks
        self._probability_distribution = None
        self._positive_proportion = 0.0
        self.set_probability_distribution(probability_distribution)

    @property
    def n_samples(self) -> int:
        return len(self.images)

    @property
    def n_positive_samples(self) -> int:
        return int(self.labels.sum())

    def set_bottlenecks(self, bottlenecks: Optional[np.ndarray]) -> None:
        if bottlenecks is not None and len(bottlenecks) != self.n_samples:
            raise ValueError("bottleneck count must match sample count")
        self.bottlenecks = bottlenecks

    def set_probability_distribution(self, dist: Optional[np.ndarray]) -> None:
        """Install per-sample weights; updates ``positive_proportion``
        accordingly (datasets.py:625-642)."""
        self._probability_distribution = dist
        if dist is None:
            self._positive_proportion = (
                float(self.n_positive_samples) / float(self.n_samples)
                if self.n_samples
                else 0.0
            )
        else:
            mask = self.labels == IID_FOREGROUND
            self._positive_proportion = float(np.sum(np.asarray(dist)[mask]))

    @property
    def probability_distribution(self) -> Optional[np.ndarray]:
        return self._probability_distribution

    @property
    def positive_proportion(self) -> float:
        return self._positive_proportion

    def new_default_iterator(self, batch_size=None, seed: Optional[int] = None):
        """RandomizedIterator when a probability distribution is set, else
        DeterministicIterator (datasets.py:644-660)."""
        if self._probability_distribution is None:
            return DeterministicIterator(self, batch_size, seed=seed)
        return RandomizedIterator(
            self, self._probability_distribution, batch_size, seed=seed
        )


class Dataset:
    """Images+labels with train/valid/test views."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        split_weights: List[float],
        preprocessor: Preprocessor,
        name: Optional[str] = None,
    ):
        if abs(sum(split_weights) - 1.0) > 1e-9 or len(split_weights) != 3:
            raise ValueError("split_weights must be three values summing to 1")
        self.images = images
        self.labels = labels
        self.name = name
        self.preprocessor = preprocessor
        n = len(images)
        train_end = int(round(split_weights[0] * n))
        val_end = train_end + int(round(split_weights[1] * n))
        test_end = val_end + int(round(split_weights[2] * n))
        self.train = DatasetSplit(images[:train_end], labels[:train_end])
        self.valid = DatasetSplit(images[train_end:val_end], labels[train_end:val_end])
        self.test = DatasetSplit(images[val_end:test_end], labels[val_end:test_end])

    @property
    def n_samples(self) -> int:
        return len(self.images)

    @property
    def splits(self) -> Dict[str, DatasetSplit]:
        return {
            SPLIT_KEY_TRAIN: self.train,
            SPLIT_KEY_VAL: self.valid,
            SPLIT_KEY_TEST: self.test,
        }

    def split(self, key: str) -> DatasetSplit:
        return self.splits[key]

    @property
    def image_shape(self):
        return self.images.shape[1:]

    def log_stats(self) -> None:
        """Class-distribution stats for the dataset and every split
        (data/datasets.py:276-340)."""
        from ..labels import IID_BACKGROUND, IID_FOREGROUND
        from ..utils import log

        log.log("Dataset stats{}:".format(" ({})".format(self.name) if self.name else ""))
        groups = [
            ("complete dataset", self.labels),
            ("training split", self.train.labels),
            ("validation split", self.valid.labels),
            ("test split", self.test.labels),
        ]
        for name, labels in groups:
            n_fg = int((labels == IID_FOREGROUND).sum())
            n_bg = int((labels == IID_BACKGROUND).sum())
            log.log(
                "- {}: {} samples ({} foreground, {} background)".format(
                    name, len(labels), n_fg, n_bg
                )
            )
            if n_fg == 0 or n_bg == 0:
                log.log("  WARNING: split contains fewer than two classes")


class _BaseIterator:
    def __init__(self, split: DatasetSplit, batch_size=None):
        self._split = split
        self._batch_size_internal = batch_size
        self._n_provided_batches = 0
        self._epoch = 0

    @property
    def batch_size(self) -> int:
        if (
            self._batch_size_internal is None
            or self._batch_size_internal > self._split.n_samples
        ):
            return self._split.n_samples
        return self._batch_size_internal

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def in_first_epoch(self) -> bool:
        return self._epoch == 0

    @property
    def n_batches_per_epoch(self) -> int:
        return math.ceil(self._split.n_samples / self.batch_size)

    @property
    def n_provided_batches(self) -> int:
        return self._n_provided_batches

    @property
    def next_batch_is_last_of_epoch(self) -> bool:
        return (self._n_provided_batches + 1) % self.n_batches_per_epoch == 0

    def _gather(self, idx: np.ndarray) -> Batch:
        s = self._split
        return Batch(
            images=s.images[idx],
            labels=s.labels[idx],
            bottlenecks=s.bottlenecks[idx] if s.bottlenecks is not None else None,
            indices=idx,
        )

    @property
    def next_batch(self) -> Batch:
        result = self._calculate_next_batch()
        if self.next_batch_is_last_of_epoch:
            self._epoch += 1
        self._n_provided_batches += 1
        return result

    def __iter__(self) -> Iterator[Batch]:
        """Iterate over the current epoch only."""
        start_epoch = self._epoch
        while self._epoch == start_epoch:
            yield self.next_batch


class DeterministicIterator(_BaseIterator):
    """Every sample exactly once per epoch, optionally reshuffled per epoch
    (datasets.py:475-550)."""

    def __init__(self, split, batch_size=None, shuffle_every_epoch=True, seed=None):
        super().__init__(split, batch_size)
        self._rng = np.random.RandomState(seed)
        if shuffle_every_epoch:
            # very first pass keeps the original order, like the reference
            self._perm = np.arange(split.n_samples)
        else:
            self._perm = None
        self._next_start = 0

    @property
    def shuffle_every_epoch(self) -> bool:
        return self._perm is not None

    def _calculate_next_batch(self) -> Batch:
        end = min(self._next_start + self.batch_size, self._split.n_samples)
        if self._perm is not None:
            # copy: the end-of-epoch shuffle below mutates _perm in place and
            # a numpy slice would be a live view into it
            idx = self._perm[self._next_start : end].copy()
        else:
            idx = np.arange(self._next_start, end)
        if self.next_batch_is_last_of_epoch:
            self._next_start = 0
            if self._perm is not None:
                self._rng.shuffle(self._perm)
        else:
            self._next_start = end
        return self._gather(idx)


class RandomizedIterator(_BaseIterator):
    """Weighted sampling without replacement per batch (datasets.py:553-591)."""

    def __init__(self, split, probability_distribution, batch_size=None, seed=None):
        super().__init__(split, batch_size)
        self._p = np.asarray(probability_distribution, dtype=np.float64)
        self._p = self._p / self._p.sum()
        self._rng = np.random.RandomState(seed)
        self._indices = np.arange(split.n_samples)

    def _calculate_next_batch(self) -> Batch:
        idx = self._rng.choice(
            self._indices, self.batch_size, replace=False, p=self._p
        )
        return self._gather(idx)
