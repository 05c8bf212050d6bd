"""The port's CLI subcommands for the host scripts, its visualizer, its
utilities against the JAX package's, and a guard that the new entry
points load nothing of JAX.

``run.main([..., "--device", "cpu"])`` runs in process over small
label-folder corpora (``data/synthetic.write_label_folder_corpus``) and is
compared with what the JAX package's scripts and apps write from the same
files. Tolerance: none — the dataset arrays, the ignore lists, the sampled
PNG trees, the Viola-Jones overlays, the collages and the utilities'
outputs are equal (PNGs byte for byte); the cascade visualizer's overlays
equal the JAX ``draw_detections`` of the same boxes.
"""

import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import inference_apps as japps
from rapidobjectdetectionusingcascadedcnns_tpu.apps import visualizer as jvis
from rapidobjectdetectionusingcascadedcnns_tpu.data import loader as jloader
from rapidobjectdetectionusingcascadedcnns_tpu.data.file_list import FileListLoader as JFiles
from rapidobjectdetectionusingcascadedcnns_tpu.utils import collage as jcollage
from rapidobjectdetectionusingcascadedcnns_tpu.utils import file_handler as jfiles
from rapidobjectdetectionusingcascadedcnns_tpu.utils import numbers as jnumbers
from rapidobjectdetectionusingcascadedcnns_tpu.utils import profiling as jprofiling
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import run as trun
from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.apps import visualizer as tvis
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.data.file_list import FileListLoader as TFiles
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.utils import collage as tcollage
from rapidobjectdetectionusingcascadedcnns_torch.utils import file_handler as tfiles
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog
from rapidobjectdetectionusingcascadedcnns_torch.utils import numbers as tnumbers
from rapidobjectdetectionusingcascadedcnns_torch.utils import profiling as tprofiling

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(**settings):
    for c in (jcf, tcf):
        for key, value in settings.items():
            c.set(key, value)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """A native corpus: 6 one-face crops, 4 backgrounds and 2 files that
    are not images."""
    root = str(tmp_path_factory.mktemp("native"))
    synthetic.write_label_folder_corpus(root, "faces", 6, 4, seed=8)
    for name in ("foreground/broken.png", "background/empty.png"):
        with open(os.path.join(root, "faces", name), "wb") as f:
            f.write(b"not an image" if "broken" in name else b"")
    return root


def test_loading_dataset_and_remove_broken_images_cli(native, tmp_path):
    """``loading-dataset`` assembles and caches the dataset as the JAX
    provider does (the unreadable files skipped); ``remove-broken-images``
    writes the ignore list the JAX ``FileListLoader`` writes."""
    for c, sub in ((jcf, "jax"), (tcf, "torch")):
        for key, value in {"dataset_path_root": native, "dataset_keys": ["faces"],
                           "class_min_images": None, "img_width": 24, "log_auto_save": False,
                           "cache_path_root": str(tmp_path / sub / "cache"),
                           "ignore_lists_dir": str(tmp_path / sub / "ignore")}.items():
            c.set(key, value)
    tlog.log_clear()
    trun.main(["loading-dataset", "--device", "cpu"])
    assert any("dataset disk_24px: 10 samples" in line for line in tlog.log_lines())
    ref = jloader.DiskDatasetProvider().dataset(24)
    assert _tree(str(tmp_path / "torch" / "cache")).keys() == _tree(
        str(tmp_path / "jax" / "cache")).keys()
    from rapidobjectdetectionusingcascadedcnns_torch.data import cache as tcache

    images, labels, _ = tcache.load_dataset("faces", 24, 24)
    order = np.lexsort(images.reshape(len(images), -1).T)
    ref_order = np.lexsort(ref.images.reshape(len(ref.images), -1).T)
    np.testing.assert_array_equal(images[order], ref.images[ref_order])
    np.testing.assert_array_equal(labels[order], ref.labels[ref_order])

    trun.main(["remove-broken-images", "--device", "cpu"])
    JFiles().remove_broken_images()
    got, want = _tree(str(tmp_path / "torch" / "ignore")), _tree(str(tmp_path / "jax" / "ignore"))
    assert got == want and len(got) == 1
    assert b"broken.png" in next(iter(got.values()))


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location("jax_" + name, os.path.join(REPO, name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sampling_cli_matches_jax_script(native, tmp_path):
    """``sampling`` writes the presampled tree ``run_sampling.py`` writes
    (the Viola-Jones detector restricting the backgrounds in both), byte
    for byte, and clears the dataset cache. The corpus gains a scene in
    which the detector finds a face: only such a foreground image, or a
    background one, is sampled (the reference's flow)."""
    corpus = str(tmp_path / "native")
    shutil.copytree(native, corpus)
    scene = synthetic.make_scene(120, 160, n_faces=1, seed=3, min_face=60, max_face=80)
    Image.fromarray(scene.image).save(os.path.join(corpus, "faces", "foreground", "scene.png"))
    for c, sub in ((jcf, "jax"), (tcf, "torch")):
        for key, value in {"dataset_native_path_root": corpus, "dataset_keys": ["faces"],
                           "class_min_images": None, "img_width": 24,
                           "sampling_multiplier": 3, "nms_opencv_min_neighbors": 1,
                           "dataset_presampled_path_root": str(tmp_path / sub / "out"),
                           "cache_path_root": str(tmp_path / sub / "cache"),
                           "log_auto_save": False}.items():
            c.set(key, value)
    os.makedirs(str(tmp_path / "torch" / "cache" / "v1"))
    trun.main(["sampling", "--device", "cpu"])
    _load_jax_script("run_sampling.py").main()
    got, want = _tree(str(tmp_path / "torch" / "out")), _tree(str(tmp_path / "jax" / "out"))
    assert got == want
    assert sum(k.startswith("faces/foreground") for k in got) == 0  # no annotations
    # 4 background images and the scene, 3 patches each
    assert len(got) == 15 and sum("aug_scene_bg" in k for k in got) == 3
    assert not os.path.exists(str(tmp_path / "torch" / "cache" / "v1"))


def test_inference_visual_opencv_cli_matches_jax(native, tmp_path):
    """``inference-visual-opencv``: the Viola-Jones baseline's overlays,
    byte-equal to what the JAX visualizer writes for the same images."""
    scenes = str(tmp_path / "scenes")
    for i in range(3):
        os.makedirs(os.path.join(scenes, "pics", "foreground"), exist_ok=True)
        scene = synthetic.make_scene(120, 160, 1, seed=3 + i, min_face=60, max_face=80)
        Image.fromarray(scene.image).save(os.path.join(scenes, "pics", "foreground",
                                                       "{}.png".format(i)))
    for c, sub in ((jcf, "jax"), (tcf, "torch")):
        for key, value in {"dataset_native_path_root": scenes, "dataset_keys": ["pics"],
                           "class_min_images": None, "window_scale_factor": 1.1,
                           "nms_opencv_min_neighbors": 1, "log_auto_save": False,
                           "session_key": "vis", "bbox_visualization_dir": str(tmp_path / sub)
                           }.items():
            c.set(key, value)
    trun.main(["inference-visual-opencv", "--device", "cpu"])
    jcf.set("dataset_path_root", scenes)
    jcf.set("cache_dataset", False)
    jvis.InferenceVisualizerApp(japps.InferenceOCVApp(), JFiles().sample_image_infos(80, 20))
    got, want = _tree(str(tmp_path / "torch")), _tree(str(tmp_path / "jax"))
    assert got == want and len(got) == 3


def test_cascade_visualizer_draws_like_jax(tmp_path):
    """``InferenceVisualizerApp(InferenceCascadeApp(...))`` on the CPU: each
    overlay equals the JAX ``draw_detections`` of the app's boxes on the
    same image, pixel for pixel, and both draw equal pixels for equal
    boxes."""
    tcf.set("conv_filter_sizes", [4])
    tcf.set("fc1_size", 8)
    tcf.set("compute_dtype", "float32")
    tcf.set("nms_opencv_min_neighbors", 0)
    tcf.set("window_scale_factor", 1.25)
    tcf.set("bbox_visualization_dir", str(tmp_path))
    tcf.set("log_auto_save", False)
    model = tcascade.build_cascade_model(seed=0, device="cpu")
    images = [synthetic.make_scene(64, 80, 1, seed=21 + i, min_face=30, max_face=40).image
              for i in range(2)]
    app = tapps.InferenceCascadeApp(model=model, device="cpu")
    results = app.run_inference_on_images(images)
    vis = tvis.InferenceVisualizerApp(app, images)
    assert len(vis.saved_paths) == 2
    for image, res, path in zip(images, results, vis.saved_paths):
        assert len(res.boxes) > 0
        got = np.asarray(Image.open(path))
        np.testing.assert_array_equal(got, jvis.draw_detections(image, res.boxes,
                                                                res.confidences))
    boxes = np.array([[-3, 4, 30, 90], [10, 10, 20, 20], [70, 50, 200, 63]], np.float64)
    confs = np.array([0.2, 0.9, 0.5])
    np.testing.assert_array_equal(tvis.draw_detections(images[0], boxes, confs),
                                  jvis.draw_detections(images[0], boxes, confs))


def test_utilities_match_jax(tmp_path, monkeypatch):
    """The collages (PNG bytes), ``numbers.is_number``,
    ``file_handler.read_txt_lines`` and ``open_file``, and the profiling
    timers equal to the JAX package's; ``device_trace`` writes a Chrome
    trace and ``annotate`` names a profiler region."""
    _both(session_key="util", collages_dir=None)
    jcf.set("collages_dir", str(tmp_path / "jax"))
    tcf.set("collages_dir", str(tmp_path / "torch"))
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (20, 8, 8, 3)).astype(np.uint8)
    floats = rng.uniform(-1, 1, (5, 8, 8, 3))
    labels = (np.arange(20) % 2).astype(np.int32)
    preds = ((np.arange(20) // 3) % 2).astype(np.int32)
    for mod in (jcollage, tcollage):
        mod.evaluation_collage(images, labels, preds, "eval")
        mod.class_distribution_collage(images, labels)
        mod.partitioned_bundles_collage({"a": images[:6], "b": floats})
        mod.removed_samples_collage(list(images[:3]))
    np.testing.assert_array_equal(tcollage.render_grid([]), jcollage.render_grid([]))
    got, want = _tree(str(tmp_path / "torch")), _tree(str(tmp_path / "jax"))
    assert got == want and len(got) == 4

    for value in (1, "2.5", [0.5], "abc", None, np.float32(3)):
        assert tnumbers.is_number(value) == jnumbers.is_number(value)
    text = tmp_path / "x.txt"
    text.write_text("a\nb\n\nc")
    assert tfiles.read_txt_lines(str(text)) == jfiles.read_txt_lines(str(text)) == [
        "a", "b", "", "c"]
    opened = []
    monkeypatch.setattr(tfiles.subprocess, "Popen", lambda args, **kw: opened.append(args))
    monkeypatch.setattr(tfiles.sys, "platform", "linux")
    tfiles.open_file(str(text))
    monkeypatch.setattr(tfiles.sys, "platform", "win32")
    tlog.log_clear()
    tfiles.open_file(str(text))
    assert opened == [["xdg-open", str(text)]]
    assert "no file opener available on platform win32" in tlog.log_lines()[-1]

    for mod in (tprofiling, jprofiling):
        mod.reset()
        for _ in range(2):
            with mod.phase("unit"):
                pass
        assert list(mod.summary()) == ["unit"] and mod.summary()["unit"] >= 0
        mod.log_summary()
        mod.reset()
        assert mod.summary() == {}
    with tprofiling.device_trace(str(tmp_path / "trace")):
        with tprofiling.annotate("unit_region"):
            torch.ones(4).sum()
    with open(str(tmp_path / "trace" / "trace.json")) as f:
        assert "unit_region" in f.read()


def test_new_entry_points_never_import_jax():
    """A train app over a disk corpus, the cascade visualizer on its
    checkpoint, a tune session, ``make_haar_face_detector`` and the CLI's
    ``loading-dataset``, in a fresh interpreter on the CPU: neither jax nor
    any module of the JAX package may be loaded."""
    code = (
        "import sys, tempfile\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import config as cf, run\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps, "
        "train_apps, tune_apps, visualizer\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.ops import sampling\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.utils import log\n"
        "log.set_echo(False)\n"
        "d = tempfile.mkdtemp()\n"
        "synthetic.write_label_folder_corpus(d + '/data', 'faces', 12, 12, seed=1)\n"
        "for k, v in {'conv_filter_sizes': [4], 'fc1_size': 8, 'batch_size': 8,\n"
        "             'epochs_total': 1, 'compute_dtype': 'float32', 'cascade_n_nets': 2,\n"
        "             'img_width': 24, 'data_augmentation_online': False,\n"
        "             'n_max_constant_evals': None, 'dataset_path_root': d + '/data',\n"
        "             'dataset_keys': ['faces'], 'class_min_images': None,\n"
        "             'cache_path_root': d + '/cache', 'output_graph_dir': d + '/models',\n"
        "             'session_key': 'guard', 'log_auto_save': False,\n"
        "             'bbox_visualization_dir': d + '/vis', 'nms_opencv_min_neighbors': 0}.items():\n"
        "    cf.set(k, v)\n"
        "app = train_apps.TrainCascadeApp(device='cpu')\n"
        "assert sorted(app.final_results) == ['test', 'train', 'valid']\n"
        "image = synthetic.make_scene(64, 80, 1, seed=3, min_face=30, max_face=40).image\n"
        "cascade_app = inference_apps.InferenceCascadeApp('guard', device='cpu')\n"
        "assert len(visualizer.InferenceVisualizerApp(cascade_app, [image]).saved_paths) == 1\n"
        "tune = tune_apps.TuneCascadeApp(['learning_rate_init'], random=True, max_sessions=1,\n"
        "                                device='cpu')\n"
        "assert tune.n_sessions == 1 and tune.n_failed == 0, tune.failures\n"
        "assert sampling.make_haar_face_detector() is not None\n"
        "run.main(['loading-dataset', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
