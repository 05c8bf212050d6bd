"""Guards of the port: no jax and nothing of the JAX package at run time,
the card as the default device with no quiet CPU fallback, and a clear
refusal of the paths and choices that the port does not have."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch import run as trun
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.apps import evaluate_fddb as tfddb_app
from rapidobjectdetectionusingcascadedcnns_torch.apps import evaluate_runtime as truntime
from rapidobjectdetectionusingcascadedcnns_torch.apps import inference_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.ops import _build
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct
from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as ttrainer
from rapidobjectdetectionusingcascadedcnns_torch.utils import device

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "rapidobjectdetectionusingcascadedcnns_torch",
    "rapidobjectdetectionusingcascadedcnns_torch.apps",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.base",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_fddb",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.evaluate_runtime",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.inference_apps",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.offline_sampling",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.train_apps",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.tune_apps",
    "rapidobjectdetectionusingcascadedcnns_torch.apps.visualizer",
    "rapidobjectdetectionusingcascadedcnns_torch.config",
    "rapidobjectdetectionusingcascadedcnns_torch.data",
    "rapidobjectdetectionusingcascadedcnns_torch.data.annotations",
    "rapidobjectdetectionusingcascadedcnns_torch.data.cache",
    "rapidobjectdetectionusingcascadedcnns_torch.data.dataset",
    "rapidobjectdetectionusingcascadedcnns_torch.data.fddb",
    "rapidobjectdetectionusingcascadedcnns_torch.data.fddb_eval",
    "rapidobjectdetectionusingcascadedcnns_torch.data.file_list",
    "rapidobjectdetectionusingcascadedcnns_torch.data.image_io",
    "rapidobjectdetectionusingcascadedcnns_torch.data.imagenet_info",
    "rapidobjectdetectionusingcascadedcnns_torch.data.loader",
    "rapidobjectdetectionusingcascadedcnns_torch.data.prefetch",
    "rapidobjectdetectionusingcascadedcnns_torch.data.preprocessor",
    "rapidobjectdetectionusingcascadedcnns_torch.data.synthetic",
    "rapidobjectdetectionusingcascadedcnns_torch.labels",
    "rapidobjectdetectionusingcascadedcnns_torch.models.bridge",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cascade",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cnn",
    "rapidobjectdetectionusingcascadedcnns_torch.models.single",
    "rapidobjectdetectionusingcascadedcnns_torch.native",
    "rapidobjectdetectionusingcascadedcnns_torch.ops._build",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.augment",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.color",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.library",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.nms",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.nms_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.rectangles",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.sampling",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.viola_jones",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched_precomp_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.parallel",
    "rapidobjectdetectionusingcascadedcnns_torch.parallel.mesh",
    "rapidobjectdetectionusingcascadedcnns_torch.parallel.multihost",
    "rapidobjectdetectionusingcascadedcnns_torch.parallel.window_shard",
    "rapidobjectdetectionusingcascadedcnns_torch.run",
    "rapidobjectdetectionusingcascadedcnns_torch.serve",
    "rapidobjectdetectionusingcascadedcnns_torch.train",
    "rapidobjectdetectionusingcascadedcnns_torch.train.cascade_trainer",
    "rapidobjectdetectionusingcascadedcnns_torch.train.checkpoint",
    "rapidobjectdetectionusingcascadedcnns_torch.train.losses",
    "rapidobjectdetectionusingcascadedcnns_torch.train.metrics",
    "rapidobjectdetectionusingcascadedcnns_torch.train.optimizer",
    "rapidobjectdetectionusingcascadedcnns_torch.train.train_step",
    "rapidobjectdetectionusingcascadedcnns_torch.train.trainer",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.collage",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.console",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.device",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.file_handler",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.log",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.numbers",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.profiling",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.time_watcher",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    """Import every module of the port and the port's profiling tool of
    K2p, and run a tiny gather-mode detect, a crop-mode detect (K2's and
    K4's plain versions), a detect with the device NMS tail (K3's plain
    version), a bundle round trip, K2p's plain version, a 3-stage
    ``CascadeTrainer`` run with online augmentation and dropout, a
    frame-sharded and a window-sharded detect, a mesh trainer from
    ``train_mesh_devices`` and the multi-process rehearsal, in a fresh
    interpreter: neither jax nor any module of the JAX package may be
    loaded."""
    code = (
        "import importlib, importlib.util, sys\n"
        "import torch\n"
        "torch.set_num_threads(2)  # as the test modules: six workers share the host\n"
        "for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('tool', {tool!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import config as cf\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.models import cascade\n"
        "cf.set('conv_filter_sizes', [4]); cf.set('fc1_size', 8)\n"
        "cf.set('window_scale_factor', 1.5)\n"
        "model = cascade.build_cascade_model(seed=0, device='cpu')\n"
        "img = synthetic.make_scene(40, 48, 1, seed=0, min_face=16, max_face=24).image\n"
        "res = cascade.CascadeDetector(model).detect(img)\n"
        "assert res.n_windows > 0\n"
        "cf.set('window_extraction_mode', 'crop'); cf.set('dyn_reextract', 'on')\n"
        "img = synthetic.make_scene(128, 256, 1, seed=0, min_face=40, max_face=80).image\n"
        "res = cascade.CascadeDetector(model).detect(img)\n"
        "assert res.n_windows > 0 and res.reextract_overflows is not None\n"
        "import tempfile\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import serve\n"
        "cf.set('window_extraction_mode', 'auto'); cf.set('dyn_reextract', 'auto')\n"
        "cf.set('nms_on_device', True)\n"
        "img = synthetic.make_scene(40, 48, 1, seed=0, min_face=16, max_face=24).image\n"
        "live = cascade.CascadeDetector(model, capacity_schedule=[512, 512]).detect(img)\n"
        "d = tempfile.mkdtemp()\n"
        "serve.save_bundle(serve.export_detector(model, 40, 48, batch=1, capacities=[512, 512],\n"
        "                                        n_rungs=1), d)\n"
        "got = serve.load_bundle(d, device='cpu').detect(img)\n"
        "assert (got.boxes == live.boxes).all() and len(got.boxes) == len(live.boxes)\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.ops import pyramid, windows_sched as ws\n"
        "plan = pyramid.build_plan(128, 256, 12, 12, 0.075, 1.5)\n"
        "sched = ws.schedule_for_plan(plan, 12, 12)\n"
        "boxes = torch.as_tensor(pyramid.window_table(plan)['boxes_float'])\n"
        "frames = torch.zeros((1, 128, 256, 3))\n"
        "out = ws.extract_scheduled_precomp(frames, ws.precompute_tap_matrices(sched, boxes), sched)\n"
        "assert torch.equal(out, ws.extract_scheduled(frames, boxes, sched))\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct\n"
        "cf.set('nms_on_device', False); cf.set('batch_size', 16); cf.set('epochs_total', 1)\n"
        "trained = ct.CascadeTrainer(ct.SyntheticProvider(12, 20, [12, 24, 48]),\n"
        "                            device='cpu').train()\n"
        "assert trained.n_nets == 3\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.parallel import multihost, window_shard\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import SingleNetTrainer\n"
        "mesh = ('cpu', 'cpu')\n"
        "img = synthetic.make_scene(40, 48, 1, seed=0, min_face=16, max_face=24).image\n"
        "assert len(cascade.CascadeDetector(model, mesh=mesh).detect_batch([img] * 3)) == 3\n"
        "res = window_shard.detect_window_sharded(cascade.CascadeDetector(model), img, mesh)\n"
        "assert res.n_windows > 0\n"
        "cf.set('train_mesh_devices', 2)\n"
        "ds = ct.SyntheticProvider(12, 20, [12]).dataset(12)\n"
        "trainer = SingleNetTrainer(ds, device='cpu')\n"
        "trainer.train()\n"
        "assert trainer.mesh.size == 2\n"
        "assert multihost.rehearsal(device='cpu')['eval_total'] == 32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    ).format(mods=PORT_MODULES, tool=os.path.join(REPO, "tools", "profile_torch_sched_precomp.py"))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_a_card_raises():
    """The card is the default device: without one, resolving the default
    raises, and so does every entry point called without a device."""
    assert device.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        device.resolve_device(None)
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tcascade.build_cascade_model(seed=0, device="cuda")
    with pytest.raises(RuntimeError):
        tcascade.build_cascade_model(seed=0)
    model = tcascade.build_cascade_model(seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        model.to(None)
    with pytest.raises(RuntimeError):
        bridge.params_from_numpy(model.stage_params[0])
    cfg0 = model.stage_configs[0]
    mean, std = model.stage_means[0], model.stage_stds[0]
    with pytest.raises(RuntimeError):
        tsingle.SingleNetDetector(model.stage_params[0], cfg0, mean, std)
    provider = tct.SyntheticProvider(6, 10, [12, 24, 48])
    with pytest.raises(RuntimeError):
        tct.CascadeTrainer(provider)
    with pytest.raises(RuntimeError):
        ttrainer.SingleNetTrainer(provider.dataset(12))


def test_chip_smoke_refuses_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert '"ok"' not in out.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def _tiny_model():
    cf.set("conv_filter_sizes", [4])
    cf.set("fc1_size", 8)
    return tcascade.build_cascade_model(seed=0, device="cpu")


def _bundle_of_two(path):
    """A bundle exported for a 2-device CPU mesh, saved to ``path``."""
    tserve.save_bundle(tserve.export_detector(_tiny_model(), 40, 48, batch=2, n_rungs=1,
                                              capacities=[256, 256], mesh=("cpu", "cpu")), path)
    return path


@pytest.mark.parametrize(
    "entry, error, what",
    [
        (lambda m, p: tcascade.CascadeDetector(m, mesh=object()), TypeError, "tuple of devices"),
        (lambda m, p: tserve.export_detector(m, 40, 48, mesh=("cpu", "cuda:7")), RuntimeError,
         "cuda"),
        (lambda m, p: tserve.export_window_sharded(m, 40, 48, object()), TypeError,
         "tuple of devices"),
        (lambda m, p: tct.CascadeTrainer(None, mesh=("cuda:7",), device="cpu"), RuntimeError,
         "cuda"),
        (lambda m, p: ttrainer.SingleNetTrainer(None, mesh=object(), device="cpu"), TypeError,
         "tuple of devices"),
        (lambda m, p: ttrainer.SingleNetTrainer(None, use_inception=True, mesh=object(),
                                                device="cpu"),
         TypeError, "tuple of devices"),
        (lambda m, p: tserve.load_bundle(_bundle_of_two(p), mesh=("cpu",) * 3), ValueError,
         "the mesh has 3"),
    ],
    ids=["detector mesh", "bundle mesh", "window-sharded bundle", "cascade trainer mesh",
         "trainer mesh", "trainer inception", "bundle mesh of another size"],
)
def test_unported_paths_raise(entry, error, what, tmp_path):
    """The mesh entry points refuse what they cannot run rather than
    running without it: an object that is not a mesh, a mesh naming a
    device this process does not have (no CUDA card here), and a
    frame-sharded bundle loaded with a mesh of another size."""
    with pytest.raises(error, match=what):
        entry(_tiny_model(), str(tmp_path / "bundle"))


def test_flagship_tools_never_import_jax():
    """Importing the port's flagship, mining and sweep tools, in a fresh
    interpreter, loads neither jax nor any module of the JAX package."""
    code = (
        "import importlib.util, os, sys\n"
        "sys.path.insert(0, os.path.join({repo!r}, 'tools'))\n"
        "for name in ('train_torch_flagship', 'mine_torch_hard_negatives',\n"
        "             'mine_torch_hard_positives', 'sweep_torch_flagship'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join({repo!r}, 'tools', name + '.py'))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    ).format(repo=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("choice", ["xla", False, "einsum"])
def test_resample_choice_without_counterpart_raises(choice):
    """The JAX package's "xla" einsum formulation (and its boolean form)
    has no counterpart in the port: a ValueError naming the accepted
    choices, not a reroute."""
    det = tcascade.CascadeDetector(_tiny_model())
    cf.set("use_pallas_resample", choice)
    with pytest.raises(ValueError, match="pallas2dyn"):
        det.detect(np.zeros((40, 48, 3), np.uint8))


@pytest.mark.parametrize(
    "settings, impl",
    [
        ({}, "pallas2"),
        ({"stage0_scheduled_extraction": "off"}, "pallas"),
        ({"use_pallas_resample": "pallas"}, "pallas"),
        ({"use_pallas_resample": "pallas", "stage0_scheduled_extraction": "on"}, "pallas2"),
        ({"use_pallas_resample": True}, "pallas"),
        ({"use_pallas_resample": "pallas2"}, "pallas2"),
        ({"dyn_reextract": "on"}, "pallas2dyn"),
        ({"use_pallas_resample": "pallas2dyn"}, "pallas2dyn"),
        ({"use_pallas_resample": "pallas", "dyn_reextract": "on"}, "pallas"),
    ],
)
def test_resolve_resample_impl(settings, impl):
    """The JAX package's resolution of the resampler toggles, mapped to the
    port's kernels (K2 = "pallas2", K1 = "pallas", K4 = "pallas2dyn")."""
    for key, value in settings.items():
        cf.set(key, value)
    assert tcascade.resolve_resample_impl() == impl


def test_mesh_raises():
    """A detector mesh that names a device this process does not have
    raises (no shard falls back to the CPU), and so does one that is not
    a tuple of devices."""
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="cuda"):
        tcascade.CascadeDetector(model, mesh=("cpu", "cuda:{}".format(torch.cuda.device_count())))
    with pytest.raises(TypeError, match="tuple of devices"):
        tcascade.CascadeDetector(model, mesh=2)


def test_apps_and_cli_never_import_jax():
    """The FDDB app (corpus, detection, scorer), the CLI's
    ``inference-cascade`` run as ``__main__`` and the port's FDDB, runtime
    and analysis tools (each analysis tool's work reached by a small call),
    in a fresh interpreter on the CPU: neither jax nor any module of the
    JAX package may be loaded."""
    code = (
        "import importlib, importlib.util, os, runpy, sys, tempfile\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "tools = {{}}\n"
        "for name in ('fddb_torch_roc', 'runtime_torch_eval', 'operating_torch_points',\n"
        "             'fddb_torch_bucketing_delta', 'runtime_torch_density_sweep',\n"
        "             'profile_torch_batch', 'profile_torch_cnn'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join({repo!r}, 'tools', name + '.py'))\n"
        "    tools[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(tools[name])\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import config as cf\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.apps import evaluate_fddb\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.data import fddb\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.models import cascade\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint\n"
        "d = tempfile.mkdtemp()\n"
        "cf.set('conv_filter_sizes', [4]); cf.set('fc1_size', 8); cf.set('log_auto_save', False)\n"
        "model = cascade.build_cascade_model(seed=0, device='cpu')\n"
        "assert tools['fddb_torch_roc'].roc_settings(reference_default=True)[1].endswith(\n"
        "    '_default.json')\n"
        "assert tools['operating_torch_points'].headline([]) is None\n"
        "assert tools['fddb_torch_bucketing_delta'].score({{}}, {{}})['n_images'] == 0\n"
        "assert tools['runtime_torch_density_sweep'].single_window_chunk(48) == 1024\n"
        "assert tools['profile_torch_cnn'].stage_parts(model, 64, 32, iters=1)['stage'] > 0\n"
        "img_base, folds, _ = fddb.make_synthetic_corpus(d, n_folds=1, imgs_per_fold=1,\n"
        "                                                sizes=((64, 80),))\n"
        "for k, v in (('fddb_folds_dir', folds), ('fddb_img_base_dir', img_base),\n"
        "             ('fddb_detection_output_dir', d + '/out'),\n"
        "             ('fddb_latest_detection_output_dir', d + '/out/latest'),\n"
        "             ('fddb_per_evaluation_script_path', d + '/missing.pl')):\n"
        "    cf.set(k, v)\n"
        "app = evaluate_fddb.EvaluateFDDBApp(model=model, n_folds=1, run_now=False, device='cpu')\n"
        "cf.set('window_scale_factor', 1.5)\n"
        "app.run()\n"
        "assert app.roc is not None and app.roc['n_faces'] > 0\n"
        "checkpoint.save_cascade(d + '/models', 'guard', model)\n"
        "cf.set('output_graph_dir', d + '/models'); cf.set('default_evaluation_model_cascade', 'guard')\n"
        "cf.set('dataset_native_path_root', d); cf.set('dataset_keys', ['images'])\n"
        "cf.set('class_min_images', None)\n"
        "sys.argv = ['run', 'inference-cascade', '--device', 'cpu']\n"
        "runpy.run_module('rapidobjectdetectionusingcascadedcnns_torch.run', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    ).format(mods=PORT_MODULES, repo=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "detections: " in out.stdout
    assert out.stdout.strip().endswith("ok")


def test_apps_without_a_card_raise():
    """Every app and every CLI command runs on the card unless given the
    CPU: without a card they raise at once, and with ``device="cpu"`` they
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    model = _tiny_model()
    image = np.zeros((40, 48, 3), np.uint8)
    app = tapps.InferenceCascadeApp(model=model, device="cpu")
    assert app.detector.device.type == "cpu"
    assert len(app.run_inference_on_images([image])) == 1
    for make in (
        lambda d: tapps.InferenceCascadeApp(model=model, device=d),
        lambda d: tapps.InferenceApp("absent", device=d),
        lambda d: tfddb_app.EvaluateFDDBApp(model=model, run_now=False, device=d),
        lambda d: truntime.EvaluateRuntimeApp(images=[image], cascade_model=model,
                                              run_now=False, device=d),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            make(None)
        assert make("cpu") is not None
    with pytest.raises(RuntimeError, match="is_available"):
        truntime.EvaluateRuntimeApp(images=[image], cascade_model=model, run_now=False,
                                    compare_platforms=["cuda", "cpu"])
    for command in trun.COMMANDS:
        with pytest.raises(RuntimeError, match="is_available"):
            trun.main([command])
