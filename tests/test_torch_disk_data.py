"""Port vs JAX: the disk data stack — AFLW annotations, the disk dataset
provider, the npz dataset cache and the offline background sampler (host
numpy, sqlite and PIL in both packages).

A label-folder corpus of 24 PNGs (14 face crops of one-face scenes, 10
background patches; ``data/synthetic.write_label_folder_corpus``) and a
small AFLW tree with its sqlite database are read by both packages.
Tolerance: none — arrays, labels, their order, the preprocessor's
statistics, the annotations and the sampled patches are all equal, and a
dataset npz either package writes is read by the other.
"""

import os
import sqlite3

import numpy as np
import pytest
from PIL import Image

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.data import annotations as jann
from rapidobjectdetectionusingcascadedcnns_tpu.data import cache as jcache
from rapidobjectdetectionusingcascadedcnns_tpu.data import loader as jloader
from rapidobjectdetectionusingcascadedcnns_tpu.data.preprocessor import Preprocessor as JPre
from rapidobjectdetectionusingcascadedcnns_tpu.ops import sampling as jsampling
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import annotations as tann
from rapidobjectdetectionusingcascadedcnns_torch.data import cache as tcache
from rapidobjectdetectionusingcascadedcnns_torch.data import loader as tloader
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.data.preprocessor import Preprocessor as TPre
from rapidobjectdetectionusingcascadedcnns_torch.labels import IID_BACKGROUND
from rapidobjectdetectionusingcascadedcnns_torch.ops import sampling as tsampling

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

KEY = "faces"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    fg, bg = synthetic.write_label_folder_corpus(root, KEY, 14, 10, seed=3)
    assert len(fg) == 14 and len(bg) == 10
    return root


def _configure(root, cache_root, **extra):
    for c, sub in ((jcf, "jax"), (tcf, "torch")):
        for key, value in {"dataset_path_root": root, "dataset_keys": [KEY],
                           "class_min_images": None,
                           "cache_path_root": os.path.join(cache_root, sub), **extra}.items():
            c.set(key, value)


def _assert_datasets_equal(got, ref):
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.images.dtype == ref.images.dtype and got.labels.dtype == ref.labels.dtype
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(got, split).labels, getattr(ref, split).labels)
    gs, rs = got.preprocessor.state_dict(), ref.preprocessor.state_dict()
    assert sorted(gs) == sorted(rs)
    for key in rs:
        np.testing.assert_array_equal(np.asarray(gs[key]), np.asarray(rs[key]), err_msg=key)


@pytest.mark.parametrize("size", [12, 24])
def test_disk_dataset_matches_jax(corpus, tmp_path, size):
    """``DiskDatasetProvider.dataset(size)``: the same arrays, labels,
    order, splits and preprocessor as the JAX provider, built from the
    files and again from each package's own cache."""
    _configure(corpus, str(tmp_path))
    for _ in range(2):  # the first call writes the cache, the second reads it
        ref = jloader.DiskDatasetProvider().dataset(size)
        got = tloader.DiskDatasetProvider().dataset(size)
        assert got.n_samples == ref.n_samples == 24
        assert got.name == ref.name == "disk_{}px".format(size)
        _assert_datasets_equal(got, ref)
    assert tcache.dataset_cached(KEY, size, size) and jcache.dataset_cached(KEY, size, size)


def test_dataset_npz_read_across(corpus, tmp_path):
    """A dataset npz the JAX package writes is one the port reads, and the
    other way round: the same layout, keys and config snapshot."""
    _configure(corpus, str(tmp_path))
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (6, 12, 12, 3)).astype(np.uint8)
    labels = np.array([0, 1, 0, 1, 1, 0], np.int64)
    pp_data = images.astype(np.float32)
    jcache.save_dataset("a", 12, 12, images, labels, JPre(pp_data, standardization=True))
    tcache.save_dataset("b", 12, 12, images, labels, TPre(pp_data, standardization=True))
    jroot, troot = (os.path.join(str(tmp_path), s, "v1") for s in ("jax", "torch"))
    for key, src, dst in (("a", jroot, troot), ("b", troot, jroot)):
        os.makedirs(os.path.join(dst, "12x12"), exist_ok=True)
        os.replace(os.path.join(src, "12x12", key), os.path.join(dst, "12x12", key))
        with open(os.path.join(dst, "12x12", key, "config.json")) as f:
            assert "cache_path_root" in f.read()
    t_img, t_lab, t_pp = tcache.load_dataset("a", 12, 12)  # written by JAX
    j_img, j_lab, j_pp = jcache.load_dataset("b", 12, 12)  # written by the port
    for img, lab in ((t_img, t_lab), (j_img, j_lab)):
        np.testing.assert_array_equal(img, images)
        np.testing.assert_array_equal(lab, labels)
    for key, value in j_pp.state_dict().items():
        np.testing.assert_array_equal(np.asarray(t_pp.state_dict()[key]), np.asarray(value))
    assert tcache.load_dataset("b", 12, 12) is None
    tcache.clear()
    assert not tcache.dataset_cached("a", 12, 12) and not os.path.exists(troot)


def test_background_filter_matches_jax(corpus, tmp_path):
    """The injected background filter: background samples whose filter
    probability exceeds the threshold are dropped in both packages."""
    _configure(corpus, str(tmp_path), cache_dataset=False, filter_dataset_after_caching=True,
               foreground_confidence_threshold=0.5)
    seen = []

    def stub(images):
        # "foreground-like": a bright image
        seen.append(len(images))
        return (images.reshape(len(images), -1).mean(axis=1) > 110).astype(np.float64)

    ref = jloader.DiskDatasetProvider(background_filter=stub).dataset(12)
    got = tloader.DiskDatasetProvider(background_filter=stub).dataset(12)
    assert seen == [24, 24]
    _assert_datasets_equal(got, ref)
    assert 0 < int((got.labels == IID_BACKGROUND).sum()) < 10  # some, not all, dropped


@pytest.fixture
def aflw_tree(tmp_path):
    """An AFLW tree: two 80x96 scenes under ``<root>/aflw/`` and the
    FaceImages/Faces/FaceRect sqlite schema the reference queries
    (data/annotation.py:84-98), as tests/test_annotations.py builds it."""
    root = tmp_path / "root"
    img_dir = root / "aflw" / "foreground"
    os.makedirs(img_dir)
    for i in (1, 2):
        scene = synthetic.make_scene(80, 96, 1, seed=40 + i, min_face=30, max_face=40)
        Image.fromarray(scene.image).save(str(img_dir / "image00{}.png".format(i)))
    conn = sqlite3.connect(str(root / "aflw" / "aflw.sqlite"))
    conn.executescript(
        """
        CREATE TABLE FaceImages (file_id TEXT, filepath TEXT);
        CREATE TABLE Faces (face_id INTEGER, file_id TEXT);
        CREATE TABLE FaceRect (face_id INTEGER, x INTEGER, y INTEGER, w INTEGER, h INTEGER);
        INSERT INTO FaceImages VALUES ('f1', 'flickr/0/image001.png');
        INSERT INTO FaceImages VALUES ('f2', 'flickr/2/image002.png');
        INSERT INTO Faces VALUES (1, 'f1');
        INSERT INTO Faces VALUES (2, 'f1');
        INSERT INTO Faces VALUES (3, 'f2');
        INSERT INTO FaceRect VALUES (1, 10, 20, 30, 40);
        INSERT INTO FaceRect VALUES (2, 50, 12, 25, 25);
        INSERT INTO FaceRect VALUES (3, 5, 5, 25, 25);
        """
    )
    conn.commit()
    conn.close()
    jann.reset_cache()
    tann.reset_cache()
    yield str(root)
    jann.reset_cache()
    tann.reset_cache()


def test_annotations_and_annotated_dataset_match_jax(aflw_tree, tmp_path):
    """The AFLW sqlite reader (bulk join, xywh -> xyxy), ``get_annotations``
    through the configuration and ``reset_cache``, and the provider's
    annotation crops: equal to the JAX package's."""
    db = os.path.join(aflw_tree, "aflw", "aflw.sqlite")
    got, ref = tann.load_aflw_annotations(db), jann.load_aflw_annotations(db)
    assert sorted(got) == sorted(ref) == ["image001.png", "image002.png"]
    for name in ref:
        np.testing.assert_array_equal(np.stack([a.bbox for a in got[name]]),
                                      np.stack([a.bbox for a in ref[name]]))
    a = got["image002.png"][0]
    assert (a.xmin, a.ymin, a.xmax, a.ymax) == (5, 5, 30, 30)
    assert tann.load_aflw_annotations(str(tmp_path / "missing.sqlite")) == {}

    for c in (jcf, tcf):
        for key, value in {"dataset_path_root": aflw_tree, "dataset_keys": ["aflw"],
                           "dataset_keys_annotated": ["aflw"], "class_min_images": None,
                           "cache_dataset": False}.items():
            c.set(key, value)
    assert len(tann.get_annotations("/x/image001.png", "aflw")) == 2
    assert tann.get_annotations("/x/image001.png", "imagenet") == []
    tann.reset_cache()
    ref = jloader.DiskDatasetProvider().dataset(12)
    got = tloader.DiskDatasetProvider().dataset(12)
    assert got.n_samples == 2
    _assert_datasets_equal(got, ref)


def test_sample_image_reference_draws_equal():
    """``sample_image_reference`` in the JAX draw order: the same crops and
    background patches from the same ``RandomState``, for a foreground and
    a background image, with and without detected faces."""
    for c in (jcf, tcf):
        c.set("sampling_multiplier", 6)
        c.set("sampling_background_max_iou_with_foreground", 0.1)
    scene = synthetic.make_scene(120, 160, n_faces=2, seed=5, min_face=30, max_face=50)
    detected = np.array([[100, 10, 140, 50]], np.float64)
    for is_fg in (True, False):
        for det in (None, detected):
            got = tsampling.sample_image_reference(scene.image, scene.boxes, is_fg, 24,
                                                   np.random.RandomState(7), detected_boxes=det)
            ref = jsampling.sample_image_reference(scene.image, scene.boxes, is_fg, 24,
                                                   np.random.RandomState(7), detected_boxes=det)
            for g, r in zip(got, ref):
                assert len(g) == len(r)
                for a, b in zip(g, r):
                    np.testing.assert_array_equal(a, b)
            assert len(got[0]) == 2 and len(got[0]) + len(got[1]) == 6
