"""Port vs JAX: the analysis tools (tools/*_torch_*.py against the JAX
package's tools/*.py).

Weights come from the JAX package's initializers through the port's
bridge, never re-drawn; inputs are seeded scenes; both configurations are
set alike (``torch_parity.configure``: conv [4], fc1 8, f32):

  * the single 48 px net in crop mode on one 128x256 frame at scale factor
    1.02 (1,866 windows over 50 levels, 1,880 slots in tiles of 8): the
    port's K2 schedule equals JAX ``schedule_for_plan(..., 48, 48)``; its
    detection (K2's plain version, ``inference_chunk_size`` 1,024: the
    sweep's window chunk) equals the
    JAX detector's (its K2 interpreted), foreground windows up to 2%
    borderline flips, confidences within 1e-5;
  * ``score`` of the bucketing delta equals the JAX tool's, a pair at the
    IoU boundary included; exact and bucketed detection of a 1-fold,
    2-image corpus of one frame size (200x280) equal JAX's at scale factor
    1.3 (gather mode, which keeps the JAX side to one compile of about 5
    s);
  * the operating-point grid (2 thresholds x 2 min_neighbors over 2 scenes)
    equals the points the JAX tool writes, and its headline follows the JAX
    rule, also on crafted points (ties, nothing under the limit);
  * the ROC tool's options map to the JAX tool's configuration;
  * the density sweep at 128x256, 1.1 and 1.02 (one frame a call, one
    batch, one pass) gives the JAX plans' window counts and schedules,
    ``default_capacity_schedule`` and the window chunk; every new tool
    refuses to run without a card unless asked for the CPU.

The cascade pair and the single net are built once for the module. The
JAX references of the single net and the grid are computed once, each in
a process of its own (``torch_parity.Reference``) started with the
module's first test, and the density sweep's test (port only) comes first,
so that the port's side and the JAX bucketing overlap them.
"""

import contextlib
import functools
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import evaluate_fddb as jevaluate_fddb
from rapidobjectdetectionusingcascadedcnns_tpu.data import fddb as jfddb
from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import single as jsingle
from rapidobjectdetectionusingcascadedcnns_tpu.ops import pyramid as jpyramid
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows_sched as jwindows_sched
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import fddb as tfddb
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid as tpyramid
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_sched as twindows_sched

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import fddb_bucketing_delta as jbucketing  # noqa: E402
import fddb_roc as jroc  # noqa: E402
import fddb_torch_bucketing_delta as tbucketing  # noqa: E402
import fddb_torch_roc as troc  # noqa: E402
import operating_points as jpoints  # noqa: E402
import operating_torch_points as tpoints  # noqa: E402
import profile_torch_batch  # noqa: E402
import profile_torch_cnn  # noqa: E402
import runtime_torch_density_sweep as tsweep  # noqa: E402
import train_flagship as jflagship  # noqa: E402
import train_torch_flagship as tflagship  # noqa: E402

FRAME = (128, 256)
CONF_TOL = 1e-5
# capacities above every survivor count of the runs below, and no higher:
# the stages after the first run on the whole capacity
GRID_CFG = {"cascade_capacity_schedule": [384, 128]}
GRID_POINTS = ((0.55, 0.6), (0, 1))  # the grid's thresholds and min_neighbors
FDDB_CFG = {"cascade_capacity_schedule": [512, 256]}
FDDB_SCALE = 1.3
FDDB_SIZES = ((200, 280),)  # one frame size: the JAX side compiles one program


@contextlib.contextmanager
def _configured():
    """Both configurations from their defaults plus ``tp.configure()`` while
    a module fixture builds, then back as they were: a module fixture runs
    before conftest's per-test restore, whose snapshot would otherwise keep
    what it set."""
    saved = jcf.snapshot()
    jcf.reset()
    tcf.reset()
    tp.configure()
    try:
        yield
    finally:
        jcf.restore(saved)
        tcf.reset()


def _single48_params():
    """(JAX params, config, mean, std) of the 48 px single net, from the
    JAX initializer."""
    scfg = jcnn.StageConfig.from_config(48, bottleneck_in_size=None)
    params = jax.tree_util.tree_map(np.asarray, jcnn.init_stage(jax.random.PRNGKey(0), scfg))
    return params, scfg, np.full((48, 48, 3), 127.5, np.float32), np.full((48, 48, 3), 64.0,
                                                                           np.float32)


def _single48_scene():
    return synthetic.make_scene(*FRAME, 2, seed=5, min_face=40, max_face=100).image


def _single48_config():
    tp.configure(window_scale_factor=1.02, min_window_length=0.075,
                 inference_chunk_size=tsweep.single_window_chunk(48))


def _jax_points(model, work):
    """The JAX grid tool's points file for the test's grid (2 thresholds x
    2 min_neighbors over 2 scenes), written into ``work``."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        _no_jit_cache(monkeypatch, pathlib.Path(work))
        monkeypatch.setattr(jpoints, "THRESHOLDS", GRID_POINTS[0])
        monkeypatch.setattr(jpoints, "MIN_NEIGHBORS", GRID_POINTS[1])
        monkeypatch.setattr(jflagship, "ARTIFACT_DIR", str(work))
        monkeypatch.setattr(jflagship, "load_flagship", lambda: model)
        monkeypatch.setattr(jflagship, "evaluate_on_scenes",
                            functools.partial(jflagship.evaluate_on_scenes, n_scenes=2))
        jpoints.main()
    with open(os.path.join(str(work), "flagship_operating_points.json")) as f:
        return json.load(f)


def _jax_reference(name, work):
    """The JAX side of one test (``single48`` or ``points``) from both
    configurations' defaults, working under ``work`` (run by
    ``torch_parity.Reference``)."""
    with _configured():
        if name == "single48":
            params, scfg, mean, std = _single48_params()
            _single48_config()
            jcf.set("use_pallas_resample", "pallas2")  # the JAX K2, interpreted on the CPU
            ref = jsingle.SingleNetDetector(params, scfg, mean, std).detect(_single48_scene())
            return {k: getattr(ref, k) for k in ("n_windows", "raw_boxes", "raw_confidences")}
        model = tp.jax_and_port_models(seed=0)[0]
        tp.configure(**GRID_CFG)
        return _jax_points(model, work)


@pytest.fixture(scope="module", autouse=True)
def jax_reference(tmp_path_factory):
    """Starts the JAX references, one process each, with the module's
    first test; yields a function that waits for one by name."""
    jobs = {}
    for name in ("single48", "points"):
        work = tmp_path_factory.mktemp("jax_" + name)
        jobs[name] = tp.Reference(work, "test_torch_analysis_tools", "_jax_reference", name,
                                  str(work))
    yield lambda name: jobs[name].result()
    for job in jobs.values():
        job.close()


@pytest.fixture(scope="module")
def models():
    """The JAX cascade (conv [4], fc1 8, f32) and its converted port copy."""
    with _configured():
        return tp.jax_and_port_models(seed=0)


@pytest.fixture(scope="module")
def single48():
    """A 48 px single net from the JAX initializer: (JAX params, config,
    mean, std) and the port's detector on the CPU."""
    with _configured():
        params, scfg, mean, std = _single48_params()
        port = tsingle.SingleNetDetector(
            bridge.params_from_numpy(params, device="cpu"), bridge.stage_config_from_jax(scfg),
            mean, std, device="cpu",
        )
    return (params, scfg, mean, std), port


def _no_jit_cache(monkeypatch, tmp_path):
    """The JAX tools' persistent jit cache set-up made a no-op."""
    monkeypatch.setenv("RODC_JIT_CACHE", str(tmp_path / "jit"))
    monkeypatch.setattr(jax.config, "update", lambda *args: None)


def test_density_sweep_geometry_matches_jax(models, single48):
    tp.configure()
    jmodel, tmodel = models
    _, single = single48
    batches = {1.1: (1, 1, 1), 1.02: (1, 1, 1)}
    sweep = tsweep.density_sweep(tmodel, single, 0.5, sizes=[FRAME], densities=(1.1, 1.02),
                                 reps=1, batches=batches)
    chunk = max(512, int(jcf.get("inference_chunk_size") * (12 / 48) ** 2))
    for wsf in (1.1, 1.02):
        entry = sweep["{}x{}@wsf{}".format(*FRAME, wsf)]
        plan = jpyramid.build_plan(*FRAME, 12, 12, 0.075, wsf)
        splan = jpyramid.build_plan(*FRAME, 48, 48, 0.075, wsf)
        assert entry["cascade"]["n_windows"] == plan.n_windows
        assert entry["cascade"]["capacities"] == jcascade.default_capacity_schedule(
            plan.n_windows, jmodel.n_nets)
        assert entry["single"]["n_windows"] == splan.n_windows
        assert entry["single"]["window_chunk"] == chunk == 1024
        sched = jwindows_sched.schedule_for_plan(splan, 48, 48) if splan.n_scales > 48 else None
        assert entry["single"]["n_slots"] == (len(sched.ids) if sched else splan.n_windows)
        assert entry["single"]["extraction_mode"] == ("crop" if sched else "gather")
        for family in ("cascade", "single"):
            assert entry[family]["fps"] > 0 and len(entry[family]["rates"]) == 1
        assert len(entry["cascade"]["survivors_max"]) == 3
    assert sweep["128x256@wsf1.02"]["single"]["n_slots"] == 1880

    if not torch.cuda.is_available():  # each tool's default device is the card
        for tool in (troc, tpoints, tbucketing, tsweep, profile_torch_batch, profile_torch_cnn):
            with pytest.raises(RuntimeError, match="cuda"):
                tool.main([])


def test_single48_crop_mode_matches_jax(single48, jax_reference):
    assert tsweep.single_window_chunk(48) == 1024
    _single48_config()
    plans = [p.build_plan(*FRAME, 48, 48, 0.075, 1.02) for p in (jpyramid, tpyramid)]
    jsched = jwindows_sched.schedule_for_plan(plans[0], 48, 48)
    tsched = twindows_sched.schedule_for_plan(plans[1], 48, 48)
    assert plans[1].n_windows == plans[0].n_windows == 1866 and plans[1].n_scales > 48
    assert tsched.tile == jsched.tile == 8 and tsched.n_slots == 1880
    np.testing.assert_array_equal(tsched.ids, jsched.ids)
    np.testing.assert_array_equal(tsched.valid, jsched.valid)

    _, port = single48
    assert port._schedule(plans[1]) is not None  # crop mode through K2
    got = port.detect(_single48_scene())
    ref = jax_reference("single48")
    assert got.n_windows == ref["n_windows"] == 1866
    conf_ref = dict(zip(map(tuple, ref["raw_boxes"].tolist()), ref["raw_confidences"].tolist()))
    conf_got = dict(zip(map(tuple, got.raw_boxes.tolist()), got.raw_confidences.tolist()))
    assert len(conf_ref) > 100
    assert len(set(conf_ref) ^ set(conf_got)) <= tp.MAX_FLIP_FRACTION * len(conf_ref)
    assert max(abs(conf_ref[k] - conf_got[k]) for k in set(conf_ref) & set(conf_got)) <= CONF_TOL


def _jax_bucketing(model, work, scale):
    """The JAX tool's two modes on its corpus of 1 fold, the derived
    buckets standing in for its "auto": {mode: score}."""
    img_base, folds_dir, truth = jfddb.make_synthetic_corpus(
        work, n_folds=1, imgs_per_fold=2, seed=7, sizes=FDDB_SIZES)
    jcf.set("fddb_folds_dir", folds_dir)
    jcf.set("fddb_img_base_dir", img_base)
    from PIL import Image

    keys = jfddb.read_fold(1)
    images = [np.asarray(Image.open(os.path.join(img_base, k + ".jpg")).convert("RGB"))
              for k in keys]
    for key, value in (("window_scale_factor", scale), ("vertically_enlarge_bboxes", False),
                       ("foreground_confidence_threshold", 0.5), ("nms", jcf.NMS_OPENCV),
                       ("nms_opencv_min_neighbors", 1)):
        jcf.set(key, value)
    detector = jcascade.CascadeDetector(model)
    out = {}
    for mode, buckets in (("exact", None), ("bucketed", jfddb.derive_resize_buckets(1))):
        jcf.set("inference_resize_buckets", buckets)
        results = detector.detect_batch(images)
        out[mode] = jbucketing.score({k: r.boxes for k, r in zip(keys, results)}, truth)
    return out


def test_bucketing_delta_matches_jax(models, monkeypatch, tmp_path):
    # IoU with [0, 0, 9, 9] (inclusive pixels): 0.3 exactly in "a" (no
    # hit), 0.31 in "c" (a hit)
    truth = {"a": [[0, 0, 9, 9]], "b": [[20, 20, 40, 40], [50, 50, 60, 60]],
             "c": [[0, 0, 9, 9]], "d": []}
    results = {"a": np.array([[0, 0, 9, 2], [100, 100, 110, 110]], np.float64),
               "b": np.array([[20, 20, 40, 40], [21, 21, 41, 41]], np.float64),
               "c": np.array([[0, 0, 9, 2.1]], np.float64),
               "d": np.array([[1, 1, 5, 5]], np.float64)}
    assert tbucketing.score(results, truth) == jbucketing.score(results, truth)
    assert tbucketing.score(results, truth) == {"recall": 0.5, "false_pos_per_img": 0.75,
                                                "n_faces": 4, "n_images": 4}

    jmodel, tmodel = models
    tp.configure(**FDDB_CFG)
    ref = _jax_bucketing(jmodel, str(tmp_path), FDDB_SCALE)
    tp.configure(**FDDB_CFG)
    monkeypatch.setattr(tfddb, "make_synthetic_corpus",
                        functools.partial(tfddb.make_synthetic_corpus, sizes=FDDB_SIZES))
    got = tbucketing.bucketing_delta(tmodel, folds=1, scale=FDDB_SCALE)
    assert got["n_images"] == 2 and got["buckets"] == [list(FDDB_SIZES[0])]
    for mode in ("exact", "bucketed"):
        assert {k: got[mode][k] for k in ref[mode]} == ref[mode], mode
        assert got[mode]["kernel_launches"] == {"K1": 0, "K2": 0}  # the CPU runs plain versions
        assert got[mode]["redispatches"] == 0
    assert got["recall_delta"] == round(ref["bucketed"]["recall"] - ref["exact"]["recall"], 4)


CRAFTED_POINTS = [
    [{"recall": 0.9, "false_pos_per_scene": 0.5}, {"recall": 0.9, "false_pos_per_scene": 0.2},
     {"recall": 0.95, "false_pos_per_scene": 0.51}, {"recall": 0.1, "false_pos_per_scene": 0.0}],
    [{"recall": 1.0, "false_pos_per_scene": 3.0}],
]


def test_operating_points_match_jax(models, jax_reference, monkeypatch, tmp_path):
    tp.configure(**GRID_CFG)
    jmodel, tmodel = models
    tflagship.flagship_config(tcf)
    tflagship.apply_recorded_overrides(tcf)
    got = tpoints.operating_points(tmodel, *GRID_POINTS, n_scenes=2)
    ref = jax_reference("points")
    assert [(p["threshold"], p["min_neighbors"]) for p in got["points"]] == [
        (p["threshold"], p["min_neighbors"]) for p in ref["points"]]
    for g, r in zip(got["points"], ref["points"]):
        assert (g["recall"], g["false_pos_per_scene"], g["n_faces"]) == (
            r["recall"], r["false_pos_per_scene"], r["n_faces"])
    assert got["headline"] == ref["headline"]

    _no_jit_cache(monkeypatch, tmp_path)
    monkeypatch.setattr(jflagship, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(jflagship, "load_flagship", lambda: jmodel)
    for points in CRAFTED_POINTS:  # the JAX rule on points chosen to test it
        replay = iter(points)
        monkeypatch.setattr(jflagship, "evaluate_on_scenes",
                            lambda model, **kwargs: dict(next(replay)))
        monkeypatch.setattr(jpoints, "THRESHOLDS", (0.5,) * len(points))
        monkeypatch.setattr(jpoints, "MIN_NEIGHBORS", (0,))
        jpoints.main()
        with open(tmp_path / "flagship_operating_points.json") as f:
            assert tpoints.headline(points) == json.load(f)["headline"]


ROC_ARGS = [[], ["--thr", "0.45"], ["--mn", "2"], ["--reference-default"],
            ["--reference-default", "--thr", "0.7", "--mn", "0"], ["--out", "x.json", "--thr", "0.6"]]


def _jax_roc_config(monkeypatch, tmp_path, argv, corpus_dir):
    """What the JAX ROC tool sets and writes for ``argv``, its app and
    corpus synthesis stubbed: (threshold, min_neighbors,
    fddb_resize_buckets, artifact name, corpus reused)."""
    made = []

    def make_corpus(work, **kwargs):
        made.append(work)
        return os.path.join(work, "images"), os.path.join(work, "folds"), {}

    class App:
        def __init__(self, model, n_folds, run_now):
            self.export_dir = str(tmp_path / "export")

        def run(self):
            os.makedirs(self.export_dir, exist_ok=True)
            with open(os.path.join(self.export_dir, "fddb_roc.json"), "w") as f:
                json.dump({"roc": []}, f)

    artifacts = tmp_path / "artifacts"
    before = set(os.listdir(artifacts))
    monkeypatch.setattr(jfddb, "make_synthetic_corpus", make_corpus)
    monkeypatch.setattr(jevaluate_fddb, "EvaluateFDDBApp", App)
    argv = argv + (["--corpus-dir", corpus_dir] if corpus_dir else [])
    monkeypatch.setattr(sys, "argv", ["fddb_roc.py"] + argv)
    jroc.main()
    (written,) = set(os.listdir(artifacts)) - before
    os.remove(artifacts / written)
    return (jcf.get("foreground_confidence_threshold"), jcf.get("nms_opencv_min_neighbors"),
            jcf.get("fddb_resize_buckets"), written, not made)


def test_roc_options_map_as_in_jax(monkeypatch, tmp_path):
    _no_jit_cache(monkeypatch, tmp_path)
    monkeypatch.setattr(jflagship, "load_flagship", lambda: object())
    artifacts = tmp_path / "artifacts"
    artifacts.mkdir()
    monkeypatch.setattr(jroc, "ARTIFACT_DIR", str(artifacts))
    monkeypatch.setattr(jroc.tempfile, "mkdtemp", lambda prefix: str(tmp_path / "work"))
    corpora = {"none": None}
    for name, folds in (("partial", (1,)), ("whole", (1, 10))):
        os.makedirs(tmp_path / name / "folds")
        for k in folds:
            (tmp_path / name / "folds" / "FDDB-fold-{:02d}.txt".format(k)).write_text("")
        corpora[name] = str(tmp_path / name)
    for quality in (None, {"threshold": 0.4, "min_neighbors": 0}):
        if quality is not None:
            (artifacts / "flagship_eval.json").write_text(json.dumps(quality))
        for argv in ROC_ARGS:
            for corpus_dir in corpora.values():
                jcf.reset()
                ref = _jax_roc_config(monkeypatch, tmp_path, argv, corpus_dir)
                args = {"reference_default": "--reference-default" in argv}
                for flag, key, kind in (("--thr", "thr", float), ("--mn", "mn", int),
                                        ("--out", "out", str)):
                    if flag in argv:
                        args[key] = kind(argv[argv.index(flag) + 1])
                settings, name = troc.roc_settings(quality=quality, **args)
                got = (settings["foreground_confidence_threshold"],
                       settings["nms_opencv_min_neighbors"],
                       settings.get("fddb_resize_buckets", tcf.get("fddb_resize_buckets")),
                       name if "out" in args else name.replace("torch_", ""),
                       troc.corpus_ready(corpus_dir))
                assert got == ref, (argv, corpus_dir, quality)
