"""Dataset assembly from disk: files -> arrays -> cache -> Dataset (the
port's copy of the JAX package's ``data/loader.py``: the same files give
the same arrays, labels, order and preprocessor).

Re-design of the reference ``DatasetLoader`` (data/db/dataset_loader.py):
  * per-dataset image loading into preallocated pools — annotation crops for
    annotated datasets, plain resizes otherwise (dataset_loader.py:412-515,
    image_info.py:140-195);
  * per-dataset npz caching keyed by resolution (dataset_loader.py:162-235);
  * multi-dataset merge (dataset_loader.py:93-139);
  * the seeded deterministic shuffle that keeps sample order identical
    across cascade resolutions (dataset_loader.py:328-388);
  * optional confidence-based background filtering with a pretrained single
    net (``filter_dataset_after_caching``, dataset_loader.py:237-326) —
    instead of importing the inference app (the reference's L3->L6 dependency
    cycle, SURVEY.md §1), the filter model is injected as a callable.

Implements the :class:`..train.cascade_trainer.DatasetProvider` protocol, so
cascade training works identically over disk data and synthetic data. All of
it is host work (PIL decodes and resizes, numpy); the trainers move batches
to the card. A file that cannot be decoded is skipped, as in the JAX
package; the port catches only the decode errors (``image_io.DECODE_ERRORS``)
where the JAX package catches every exception. The decode+resize, cache
read and cache write of each size accumulate in ``utils/profiling``'s phase
timers.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import config as cf
from ..labels import IID_BACKGROUND
from ..utils import log, profiling
from . import annotations as ann_mod
from . import cache as cache_mod
from .dataset import Dataset, deterministic_shuffle
from .file_list import FileListLoader
from .image_io import DECODE_ERRORS
from .preprocessor import Preprocessor


class DiskDatasetProvider:
    """Builds :class:`Dataset` objects at arbitrary resolutions from disk."""

    def __init__(
        self,
        file_list_loader: Optional[FileListLoader] = None,
        background_filter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        """``background_filter``: optional callable mapping a (N, H, W, 3)
        uint8 array to foreground probabilities; background samples the
        filter considers foreground-like are dropped
        (dataset_loader.py:237-326)."""
        self.files = file_list_loader or FileListLoader()
        self.background_filter = background_filter

    # ------------------------------------------------------------------

    def _load_arrays_for_dataset(
        self, dataset_key: str, height: int, width: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        infos = [i for i in self.files.image_infos if i.dataset_key == dataset_key]
        n = len(infos)
        images = np.empty((n, height, width, 3), dtype=cf.get("img_dtype"))
        labels = np.empty((n,), dtype=cf.get("label_dtype"))
        kept = 0
        for info in infos:
            try:
                anns = ann_mod.get_annotations(info.path_original, dataset_key)
                box = anns[0].bbox if anns else None
                images[kept] = info.raw_resized(height, width, annotation_box=box)
                labels[kept] = info.label.iid
                kept += 1
            except DECODE_ERRORS as exc:  # per-image isolation
                log.log(
                    " .. Skipped {}, because of an error: {}".format(
                        info.path_original, exc
                    )
                )
        return images[:kept], labels[:kept]

    def _dataset_arrays(
        self, height: int, width: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        all_images: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        for key in cf.get("dataset_keys"):
            cached = None
            if cf.get("cache_dataset") and cache_mod.dataset_cached(key, width, height):
                with profiling.phase("dataset {}px cache read".format(height)):
                    cached = cache_mod.load_dataset(key, width, height)
            if cached is not None:
                images, labels, _pp = cached
            else:
                with profiling.phase("dataset {}px decode+resize".format(height)):
                    images, labels = self._load_arrays_for_dataset(key, height, width)
                if cf.get("cache_dataset") and len(images):
                    # per-dataset preprocessor state is recomputed at merge
                    # time; cache a placeholder for format completeness
                    with profiling.phase("dataset {}px cache write".format(height)):
                        cache_mod.save_dataset(
                            key, width, height, images, labels, Preprocessor(None, False)
                        )
            if len(images):
                all_images.append(images)
                all_labels.append(labels)
        if not all_images:
            raise ValueError(
                "No images found under {} for dataset keys {}".format(
                    self.files.root, cf.get("dataset_keys")
                )
            )
        return np.concatenate(all_images), np.concatenate(all_labels)

    def _filter_background(
        self, images: np.ndarray, labels: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Drop background samples the filter net predicts as foreground
        (dataset_loader.py:237-326)."""
        if self.background_filter is None or not cf.get(
            "filter_dataset_after_caching"
        ):
            return images, labels
        probs = np.asarray(self.background_filter(images))
        thr = cf.get("foreground_confidence_threshold")
        if not isinstance(thr, (int, float)):
            thr = thr[0]
        drop = (labels == IID_BACKGROUND) & (probs > thr)
        if drop.any():
            log.log(
                "filtered {} background samples that look like foreground".format(
                    int(drop.sum())
                )
            )
        return images[~drop], labels[~drop]

    def dataset(self, img_size: int) -> Dataset:
        """Assemble the merged, shuffled dataset at ``img_size`` resolution."""
        images, labels = self._dataset_arrays(img_size, img_size)
        images, labels = self._filter_background(images, labels)
        # seeded shuffle; identical order for every resolution of the same
        # corpus, which cascade training depends on
        # (app/train_cascade_app.py:244-263)
        perm = deterministic_shuffle(len(images), cf.get("shuffle_seed"))
        images = images[perm]
        labels = labels[perm]
        n_train = int(round(cf.get("dataset_split")[0] * len(images)))
        pp = Preprocessor(
            images[:n_train].astype(np.float32),
            standardization=cf.get("standardization"),
        )
        return Dataset(
            images,
            labels,
            cf.get("dataset_split"),
            pp,
            name="disk_{}px".format(img_size),
        )
