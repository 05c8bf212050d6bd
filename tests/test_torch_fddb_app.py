"""Port vs JAX: the FDDB data stack and the FDDB app.

The synthetic corpus writer, the in-repo scorer and ``EvaluateFDDBApp`` of
both packages run on the same inputs; the cascade's parameters come from the
JAX ``build_cascade_model`` through the bridge (never re-drawn), in f32 with
``tests/torch_parity.py``'s small nets. The JAX package runs its CPU
formulation (``use_pallas_resample="xla"``, which its own tests hold equal
to its kernels); the port runs its kernels' plain versions on the CPU.

Tolerances: corpus files byte-equal; the scorer's integers equal and its
floats within 1e-12; fold files with the same keys and boxes, scores within
1e-5 (f32); the ROC points' counts and rates equal, their thresholds within
1e-5; bucketed detections as ``torch_parity.assert_results_close``.
"""

import json
import os

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import evaluate_fddb as japp
from rapidobjectdetectionusingcascadedcnns_tpu.data import fddb as jfddb
from rapidobjectdetectionusingcascadedcnns_tpu.data import fddb_eval as jeval
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.utils import log as jlog
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.apps import evaluate_fddb as tapp
from rapidobjectdetectionusingcascadedcnns_torch.data import fddb as tfddb
from rapidobjectdetectionusingcascadedcnns_torch.data import fddb_eval as teval
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

SIZES = ((120, 160), (100, 140))  # two sizes: two resize buckets
N_FOLDS = 2
COARSE_WSF = 1.25
SCORE_TOL = 1e-5
NETS = {"cascade_n_nets": 2, "img_width": 24, "log_auto_save": False}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("fddb_corpus"))
    img_base, folds_dir, _ = tfddb.make_synthetic_corpus(
        base, n_folds=N_FOLDS, imgs_per_fold=2, seed=0, sizes=SIZES
    )
    return img_base, folds_dir


@pytest.fixture(scope="module")
def models():
    tp.configure(**NETS)
    return tp.jax_and_port_models(seed=3)


def _configure_fddb(corpus, out_dir, **extra):
    img_base, folds_dir = corpus
    tp.configure(
        fddb_folds_dir=folds_dir,
        fddb_img_base_dir=img_base,
        fddb_per_evaluation_script_path=os.path.join(out_dir, "missing.pl"),
        **NETS,
        **extra,
    )
    for cf, name in ((jcf, "jax"), (tcf, "port")):
        cf.set("fddb_detection_output_dir", os.path.join(out_dir, name))
        cf.set("fddb_latest_detection_output_dir", os.path.join(out_dir, name, "latest"))


def _run_both(models, n_folds, wsf=None):
    """Both packages' ``EvaluateFDDBApp``; ``wsf`` replaces the forced 1.005
    after construction. Returns (jax app, port app)."""
    jlog.set_echo(False)
    tlog.set_echo(False)
    try:
        apps = []
        for module, cf, model, kwargs in (
            (japp, jcf, models[0], {}),
            (tapp, tcf, models[1], {"device": "cpu"}),
        ):
            app = module.EvaluateFDDBApp(model=model, n_folds=n_folds, run_now=False, **kwargs)
            assert cf.get("window_scale_factor") == 1.005
            assert cf.get("inference_merge") is False
            assert cf.get("vertically_enlarge_bboxes") is True
            if wsf is not None:
                cf.set("window_scale_factor", wsf)
            app.run()
            apps.append(app)
    finally:
        jlog.set_echo(True)
        tlog.set_echo(True)
    return apps


def _assert_folds_equal(japp_, tapp_):
    assert len(japp_.fold_paths) == len(tapp_.fold_paths)
    n_boxes = 0
    for jpath, tpath in zip(japp_.fold_paths, tapp_.fold_paths):
        jparsed, tparsed = jfddb.parse_fold_results(jpath), tfddb.parse_fold_results(tpath)
        assert [p[0] for p in tparsed] == [p[0] for p in jparsed]
        for (_, jb, js), (_, tb, ts) in zip(jparsed, tparsed):
            order_j, order_t = np.lexsort(jb.T[::-1]), np.lexsort(tb.T[::-1])
            np.testing.assert_array_equal(tb[order_t], jb[order_j])
            np.testing.assert_allclose(ts[order_t], js[order_j], rtol=0, atol=SCORE_TOL)
            n_boxes += len(jb)
    return n_boxes


def _assert_rocs_equal(japp_, tapp_):
    rocs = []
    for app in (japp_, tapp_):
        with open(os.path.join(app.export_dir, "fddb_roc.json")) as f:
            rocs.append(json.load(f))
    jroc, troc = rocs
    for key in ("n_faces", "n_detections", "iou_threshold", "per_fold"):
        assert troc[key] == jroc[key], key
    assert len(troc["roc"]) == len(jroc["roc"]) > 0
    for jp, tpnt in zip(jroc["roc"], troc["roc"]):
        assert abs(tpnt["threshold"] - jp["threshold"]) <= SCORE_TOL
        for key in ("false_positives", "true_positives", "detection_rate",
                    "detection_rate_continuous"):
            assert tpnt[key] == jp[key], (key, tpnt, jp)


def test_synthetic_corpus_byte_equal(tmp_path):
    """Both writers give the same fold lists, ellipse lists and JPEG bytes
    at the default sizes, and the same ground truth."""
    _, _, jtruth = jfddb.make_synthetic_corpus(str(tmp_path / "jax"), n_folds=3, seed=0)
    _, _, ttruth = tfddb.make_synthetic_corpus(str(tmp_path / "port"), n_folds=3, seed=0)
    assert sorted(ttruth) == sorted(jtruth)
    for key in jtruth:
        np.testing.assert_array_equal(ttruth[key], jtruth[key])
    files = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        files[side] = sorted(
            os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
        )
    assert files["port"] == files["jax"] and len(files["jax"]) == 3 * 2 + 6
    for rel in files["jax"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_scorer_matches_jax():
    """``ellipse_rect_iou``, ``score_image`` and ``roc_curve`` on seeded
    ellipses, boxes and scores (ties included) equal the JAX package's."""
    rng = np.random.RandomState(0)
    per_image = {"jax": [], "port": []}
    n_faces = 0
    for _ in range(6):
        g, d = rng.randint(0, 4), rng.randint(0, 7)
        n_faces += g
        ells = np.stack([rng.uniform(15, 40, g), rng.uniform(10, 25, g),
                         rng.uniform(1.2, 1.9, g), rng.uniform(30, 90, g),
                         rng.uniform(30, 90, g)], axis=1)
        boxes = np.stack([rng.uniform(0, 80, d), rng.uniform(0, 80, d),
                          rng.uniform(10, 60, d), rng.uniform(10, 60, d)], axis=1)
        scores = rng.choice([0.3, 0.5, 0.75, 0.9, 1.4], d)
        for e in ells:
            for b in boxes:
                assert teval.ellipse_rect_iou(e, b) == jeval.ellipse_rect_iou(e, b)
        jt = jeval.score_image(ells, boxes, scores)
        tt = teval.score_image(ells, boxes, scores)
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        per_image["jax"].append(jt)
        per_image["port"].append(tt)
    jroc = jeval.roc_curve(per_image["jax"], n_faces)
    troc = teval.roc_curve(per_image["port"], n_faces)
    assert len(troc) == len(jroc) > 0
    for a, b in zip(troc, jroc):
        assert a["false_positives"] == b["false_positives"]
        assert a["true_positives"] == b["true_positives"]
        for key in ("threshold", "detection_rate", "detection_rate_continuous"):
            assert abs(a[key] - b[key]) <= 1e-12, key


def test_fddb_app_matches_jax(models, corpus, tmp_path):
    """The whole app over 2 folds of 2 images, corpus-derived buckets, at a
    coarse scale factor set after construction: the same fold files and the
    same ROC."""
    _configure_fddb(corpus, str(tmp_path))
    japp_, tapp_ = _run_both(models, N_FOLDS, wsf=COARSE_WSF)
    assert tcf.get("inference_resize_buckets") == jcf.get("inference_resize_buckets")
    assert sorted(map(tuple, tcf.get("inference_resize_buckets"))) == sorted(SIZES)
    assert _assert_folds_equal(japp_, tapp_) > 0
    _assert_rocs_equal(japp_, tapp_)
    assert os.path.islink(tcf.get("fddb_latest_detection_output_dir"))


def test_dense_fold_matches_jax(models, tmp_path, monkeypatch):
    """One 128x256 image at the forced scale factor 1.005 (crop mode,
    61,986 windows; the smallest frame K2 schedules): the port's stage 0 goes through K2's plain version, the JAX
    package through its CPU path; the fold files and ROC agree."""
    base = str(tmp_path / "corpus")
    img_base, folds_dir, _ = tfddb.make_synthetic_corpus(
        base, n_folds=1, imgs_per_fold=1, seed=5, sizes=((128, 256),)
    )
    _configure_fddb((img_base, folds_dir), str(tmp_path))
    calls = []
    plain = windows_sched.resample_sched_plain

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return plain(*args, **kwargs)

    monkeypatch.setattr(windows_sched, "resample_sched_plain", spy)
    japp_, tapp_ = _run_both(models, 1)
    assert tcf.get("window_scale_factor") == 1.005
    assert len(calls) >= 1, "K2's plain version did not run"
    assert _assert_folds_equal(japp_, tapp_) > 0
    _assert_rocs_equal(japp_, tapp_)


def test_resize_buckets_map_back_like_jax(models, corpus, tmp_path):
    """Both packages derive the same buckets from the corpus; with one
    bucket, the smaller images are resized to it and their detections
    mapped back to the original geometry as the JAX package maps them."""
    _configure_fddb(corpus, str(tmp_path))
    assert tfddb.derive_resize_buckets(N_FOLDS) == jfddb.derive_resize_buckets(N_FOLDS)
    tp.configure(**NETS, window_scale_factor=COARSE_WSF, inference_resize_buckets=[SIZES[0]])
    infos = [i for f in range(1, N_FOLDS + 1) for i in tfddb.image_infos_for_fold(f)]
    images = [i.raw_original() for i in infos]
    assert {im.shape[:2] for im in images} == set(SIZES)
    jres = jcascade.CascadeDetector(models[0]).detect_batch(images)
    tres = tcascade.CascadeDetector(models[1]).detect_batch(images)
    for im, t, j in zip(images, tres, jres):
        tp.assert_results_close(t, j)
        np.testing.assert_allclose(t.raw_boxes, j.raw_boxes, rtol=0, atol=1e-4)
        if im.shape[:2] != SIZES[0] and len(t.boxes):
            assert t.boxes[:, 2].max() <= im.shape[1] + 1
            assert t.boxes[:, 3].max() <= im.shape[0] + 1
