"""Port vs JAX: the inference apps, the runtime app and the CLI.

The cascade's parameters come from the JAX ``build_cascade_model`` through
the bridge, the single net's from a checkpoint the JAX package writes (its
``init_stage``, never trained), read with ``bridge.load_single``; f32 with
``tests/torch_parity.py``'s small nets, at scale factor 1.25. Tolerance:
``torch_parity.assert_results_close`` (survivor ids up to 2% borderline
flips, confidences within 2e-3, NMS boxes within 2 px); patch
probabilities within 1e-5.

One difference is deliberate: in non-merge mode the JAX app turns a
detection error into an empty result, the port raises.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidobjectdetectionusingcascadedcnns_tpu.apps import evaluate_runtime as jruntime
from rapidobjectdetectionusingcascadedcnns_tpu.apps import inference_apps as japps
from rapidobjectdetectionusingcascadedcnns_tpu.data import image_io as jio
from rapidobjectdetectionusingcascadedcnns_tpu.data.synthetic import make_scene
from rapidobjectdetectionusingcascadedcnns_tpu.labels import KEY_FOREGROUND
from rapidobjectdetectionusingcascadedcnns_tpu.labels import get_by_key as jlabel
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import single as jsingle
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jcheckpoint
from rapidobjectdetectionusingcascadedcnns_torch.apps import evaluate_runtime as truntime
from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.data import image_io as tio
from rapidobjectdetectionusingcascadedcnns_torch.labels import get_by_key as tlabel
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint as tcheckpoint

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = {"cascade_n_nets": 2, "img_width": 24, "window_scale_factor": 1.25,
        "log_auto_save": False}
SINGLE_KEY = "single_net"


@pytest.fixture(scope="module")
def models():
    tp.configure(**NETS)
    return tp.jax_and_port_models(seed=3)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Three readable scenes and, second, a file that is not an image."""
    d = tmp_path_factory.mktemp("images")
    paths = []
    for i in range(3):
        path = str(d / "img_{}.png".format(i))
        Image.fromarray(make_scene(100, 120, 1, seed=20 + i, min_face=40, max_face=55).image).save(path)
        paths.append(path)
    broken = str(d / "broken.png")
    with open(broken, "wb") as f:
        f.write(b"this is not an image")
    return paths[:1] + [broken] + paths[1:]


def _infos(files):
    return (
        [jio.ImageInfo(p, jlabel(KEY_FOREGROUND), "test") for p in files],
        [tio.ImageInfo(p, tlabel(KEY_FOREGROUND), "test") for p in files],
    )


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "non-merge"])
def test_inference_cascade_app_matches_jax(models, image_files, merge):
    """Cascade inference on ImageInfos with one unreadable file: the same
    detections, and an empty result for that file in both packages."""
    tp.configure(**NETS)
    jinfos, tinfos = _infos(image_files)
    jres = japps.InferenceCascadeApp(model=models[0]).run_inference_on_images(jinfos, merge)
    tres = tapps.InferenceCascadeApp(model=models[1], device="cpu").run_inference_on_images(
        tinfos, merge
    )
    assert len(tres) == len(jres) == len(image_files)
    for i, (t, j) in enumerate(zip(tres, jres)):
        if i == 1:
            assert t.n_windows == j.n_windows == 0
            assert len(t.boxes) == len(j.boxes) == 0
        else:
            assert t.n_windows > 0
            tp.assert_results_close(t, j)


def test_detection_error_raises(models, image_files, monkeypatch):
    """A failed detection propagates in the port in both modes, where the
    JAX app's non-merge mode reports the image as empty."""
    tp.configure(**NETS)
    jinfos, tinfos = _infos(image_files)

    def fail(self, *args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tcascade.CascadeDetector, "detect", fail)
    monkeypatch.setattr(tcascade.CascadeDetector, "detect_batch", fail)
    app = tapps.InferenceCascadeApp(model=models[1], device="cpu")
    for merge in (False, True):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            app.run_inference_on_images(tinfos, merge=merge)
    monkeypatch.setattr(jcascade.CascadeDetector, "detect", fail)
    jres = japps.InferenceCascadeApp(model=models[0]).run_inference_on_images(jinfos, False)
    assert [len(r.boxes) for r in jres] == [0] * len(image_files)


def _single_net(seed=1):
    """An untrained 12 px JAX stage, its standardisation constants."""
    scfg = jcnn.StageConfig.from_config(12)
    params = jcnn.init_stage(jax.random.PRNGKey(seed), scfg)
    mean = np.full((12, 12, 3), 120.0, np.float32)
    std = np.full((12, 12, 3), 60.0, np.float32)
    return params, scfg, mean, std


def test_inference_app_from_jax_checkpoint(tmp_path, image_files):
    """``InferenceApp`` on a single-net checkpoint the JAX package wrote,
    read through ``bridge.load_single``: the same detections and patch
    probabilities as the JAX ``InferenceApp``."""
    tp.configure(**NETS, output_graph_dir=str(tmp_path))
    params, scfg, mean, std = _single_net()
    jcheckpoint.save_stage(
        jcheckpoint.single_model_path(str(tmp_path), SINGLE_KEY), params, scfg, mean, std
    )
    tparams, tcfg, tmean, _, _ = bridge.load_single(str(tmp_path), SINGLE_KEY, device="cpu")
    assert tparams["fc1"]["W"].device.type == "cpu" and tcfg.input_size == 12
    np.testing.assert_array_equal(tmean, mean)
    with pytest.raises(FileNotFoundError):
        bridge.load_single(str(tmp_path), "absent", device="cpu")

    images = [np.asarray(Image.open(p).convert("RGB")) for p in image_files if "img" in p]
    japp = japps.InferenceApp(SINGLE_KEY)
    tapp = tapps.InferenceApp(SINGLE_KEY, device="cpu")
    jres = japp.run_inference_on_images(images)
    tres = tapp.run_inference_on_images(images)
    for t, j in zip(tres, jres):
        assert t.n_windows == j.n_windows > 0
        got = set(map(tuple, t.raw_boxes.tolist()))
        ref = set(map(tuple, j.raw_boxes.tolist()))
        assert len(got ^ ref) <= tp.MAX_FLIP_FRACTION * max(len(ref), 1)
        assert len(t.boxes) == len(j.boxes)
    patches = np.random.RandomState(0).randint(0, 256, (6, 12, 12, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        tapp.run_inference_on_raw_data(patches),
        np.asarray(japp.run_inference_on_raw_data(patches)),
        rtol=0, atol=1e-5,
    )


def test_cli_inference_cascade_on_cpu(models, tmp_path):
    """``python -m ...run inference-cascade --device cpu`` on a saved
    cascade and a small file tree set by a ``rodc_local.py`` overlay: exit 0
    and a detection count reported."""
    native = tmp_path / "native"
    for label, seeds in (("foreground", (30, 31)), ("background", (32,))):
        os.makedirs(native / "testset" / label)
        for s in seeds:
            scene = make_scene(100, 120, 1 if label == "foreground" else 0, seed=s,
                               min_face=40, max_face=55)
            Image.fromarray(scene.image).save(native / "testset" / label / "{}.png".format(s))
    tcheckpoint.save_cascade(str(tmp_path / "models"), "cli", models[1])
    (tmp_path / "rodc_local.py").write_text(
        "cf = {{'output_graph_dir': {models!r}, 'default_evaluation_model_cascade': 'cli',\n"
        "      'dataset_native_path_root': {native!r}, 'dataset_keys': ['testset'],\n"
        "      'class_min_images': None, 'window_scale_factor': 1.25,\n"
        "      'log_auto_save': False}}\n".format(models=str(tmp_path / "models"),
                                                 native=str(native))
    )
    env = dict(os.environ, RODC_HOME=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), REPO, env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "rapidobjectdetectionusingcascadedcnns_torch.run",
         "inference-cascade", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "detections:" in out.stdout and "over 3 images" in out.stdout, out.stdout[-2000:]


def test_runtime_app_result_keys_match_jax(models, image_files):
    """``EvaluateRuntimeApp(images=..., compare_platforms=["cpu"])``: the
    same result keys as the JAX app's, every rate positive."""
    tp.configure(**NETS)
    images = [np.asarray(Image.open(p).convert("RGB")) for p in image_files if "img" in p][:2]
    params, scfg, mean, std = _single_net()
    tsd = tsingle.SingleNetDetector(
        bridge.params_from_numpy(params, "cpu"), bridge.stage_config_from_jax(scfg), mean, std,
        device="cpu",
    )
    tapp = truntime.EvaluateRuntimeApp(
        images=images, cascade_model=models[1], single_detector=tsd, compare_platforms=["cpu"]
    )
    # last: the JAX app re-initialises the JAX backend for its platform axis
    japp = jruntime.EvaluateRuntimeApp(
        images=images, cascade_model=models[0],
        single_detector=jsingle.SingleNetDetector(params, scfg, mean, std),
        compare_platforms=["cpu"],
    )
    assert sorted(tapp.results) == sorted(japp.results)
    assert "cascade@cpu" in tapp.results and "speedup_cascade_vs_single@cpu" in tapp.results
    for key, value in tapp.results.items():
        assert (value["value"] if key.startswith("speedup") else value["fps"]) > 0, key
