"""File discovery: label-folder walk, ignore/whitelists, class limits (the
port's copy of the JAX package's ``data/file_list.py``).

Re-design of the reference ``FileListLoader`` (data/db/file_list_loader.py):
  * recursive dataset walk mapping folder names to binary labels — a folder
    named ``foreground`` is positive, everything else is background
    (data/db/dataset_config.py:31-37,55-91);
  * persisted ignore lists (broken images) and whitelists per dataset
    (file_list_loader.py:358-503);
  * per-class min/max enforcement with seeded subsampling
    (file_list_loader.py:505-589);
  * per-entity caps for grouped background corpora such as ImageNet
    (config.py:339-347);
  * pos/neg sampling for quick inference runs (file_list_loader.py:666-710).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

from .. import config as cf
from ..labels import IID_BACKGROUND, IID_FOREGROUND, KEY_FOREGROUND, get_by_key
from ..utils import log
from .image_io import ImageInfo

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif")


def _list_path(directory: str, dataset_key: str) -> str:
    return os.path.join(directory, "{}.txt".format(dataset_key))


def load_list(directory: str, dataset_key: str) -> List[str]:
    path = _list_path(directory, dataset_key)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def save_list(directory: str, dataset_key: str, entries: List[str]) -> str:
    cf.ensure_dir(directory)
    path = _list_path(directory, dataset_key)
    with open(path, "w") as f:
        f.write("\n".join(entries) + ("\n" if entries else ""))
    return path


class FileListLoader:
    """Discovers image files of the configured datasets."""

    def __init__(self, dataset_path_root: Optional[str] = None):
        self.root = dataset_path_root or cf.get("dataset_path_root")
        self._image_infos: Optional[List[ImageInfo]] = None

    def reset(self) -> None:
        self._image_infos = None

    # ------------------------------------------------------------------

    def _label_for_folder(self, dataset_key: str, rel_dir: str):
        """Binary mapping: a path component 'foreground' => foreground,
        everything else => background."""
        parts = rel_dir.replace("\\", "/").split("/")
        if KEY_FOREGROUND in parts:
            return get_by_key(KEY_FOREGROUND)
        return get_by_key("background")

    def _walk_dataset(self, dataset_key: str) -> List[ImageInfo]:
        ds_root = os.path.join(self.root, dataset_key)
        if not os.path.isdir(ds_root):
            log.log("WARNING: dataset folder missing: {}".format(ds_root))
            return []
        ignored = set(load_list(cf.get("ignore_lists_dir"), dataset_key))
        whitelist = set(load_list(cf.get("whitelists_dir"), dataset_key))

        infos = []
        per_entity_count: Dict[str, int] = {}
        max_per_entity = cf.get("background_max_img_per_entity")
        if dataset_key == "imagenet":
            from . import imagenet_info

            human_ids = imagenet_info.human_wordnet_ids()
            ignored_ids = imagenet_info.ignored_wordnet_ids()
        for dirpath, _dirnames, filenames in sorted(os.walk(ds_root)):
            rel_dir = os.path.relpath(dirpath, ds_root)
            # ImageNet synset folders: humans must not become background for
            # a face detector, clothing co-occurs with faces — both skipped
            # (data/db/dataset_config.py:55-91)
            if dataset_key == "imagenet":
                wnid = os.path.basename(rel_dir)
                if wnid in human_ids or wnid in ignored_ids:
                    continue
            label = self._label_for_folder(dataset_key, rel_dir)
            for name in sorted(filenames):
                if not name.lower().endswith(IMG_EXTENSIONS):
                    continue
                path = os.path.join(dirpath, name)
                if path in ignored and path not in whitelist:
                    continue
                # ImageNet-style grouped backgrounds: cap imgs per entity
                # folder (dataset_config.py:48-52, config.py:339-347)
                if (
                    dataset_key == "imagenet"
                    and label.iid == IID_BACKGROUND
                    and max_per_entity is not None
                ):
                    count = per_entity_count.get(rel_dir, 0)
                    if count >= max_per_entity:
                        continue
                    per_entity_count[rel_dir] = count + 1
                infos.append(ImageInfo(path, label, dataset_key))
        return infos

    def _enforce_class_limits(self, infos: List[ImageInfo]) -> List[ImageInfo]:
        """class_min_images warning + class_max_images seeded subsample
        (file_list_loader.py:505-589)."""
        by_iid: Dict[int, List[ImageInfo]] = {}
        for info in infos:
            by_iid.setdefault(info.label.iid, []).append(info)

        min_images = cf.get("class_min_images")
        max_images = cf.get("class_max_images")
        out: List[ImageInfo] = []
        rng = random.Random(cf.get("seed"))
        for iid, members in sorted(by_iid.items()):
            if min_images is not None and len(members) < min_images:
                log.log(
                    "WARNING: class {} has only {} images (< class_min_images"
                    " = {})".format(iid, len(members), min_images)
                )
            if max_images is not None and len(members) > max_images:
                members = rng.sample(members, max_images)
            out.extend(members)

        max_samples = cf.get("max_samples")
        if max_samples is not None and len(out) > max_samples:
            out = rng.sample(out, max_samples)
        return out

    @property
    def image_infos(self) -> List[ImageInfo]:
        if self._image_infos is None:
            infos: List[ImageInfo] = []
            for key in cf.get("dataset_keys"):
                found = self._walk_dataset(key)
                log.log("dataset {}: {} files".format(key, len(found)))
                infos.extend(found)
            self._image_infos = self._enforce_class_limits(infos)
        return self._image_infos

    def sample_image_infos(
        self, max_positive: int, max_negative: int, seed: Optional[int] = None
    ) -> List[ImageInfo]:
        """Sampled pos/neg subset for quick inference runs
        (file_list_loader.py:666-710)."""
        pos = [i for i in self.image_infos if i.label.iid == IID_FOREGROUND]
        neg = [i for i in self.image_infos if i.label.iid == IID_BACKGROUND]
        rng = random.Random(cf.get("seed") if seed is None else seed)
        rng.shuffle(pos)
        rng.shuffle(neg)
        return pos[:max_positive] + neg[:max_negative]

    def remove_broken_images(self) -> List[str]:
        """Scan the corpus for undecodable files and persist them to the
        per-dataset ignore lists (file_list_loader.py:275-333)."""
        broken_by_ds: Dict[str, List[str]] = {}
        kept = []
        for info in self.image_infos:
            if info.is_loadable():
                kept.append(info)
            else:
                broken_by_ds.setdefault(info.dataset_key, []).append(
                    info.path_original
                )
        for ds_key, paths in broken_by_ds.items():
            existing = load_list(cf.get("ignore_lists_dir"), ds_key)
            save_list(cf.get("ignore_lists_dir"), ds_key, sorted(set(existing + paths)))
            log.log("ignore list for {}: +{} broken images".format(ds_key, len(paths)))
        self._image_infos = kept
        return [p for paths in broken_by_ds.values() for p in paths]
