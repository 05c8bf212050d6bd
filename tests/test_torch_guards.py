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
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
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
    "rapidobjectdetectionusingcascadedcnns_torch.config",
    "rapidobjectdetectionusingcascadedcnns_torch.data",
    "rapidobjectdetectionusingcascadedcnns_torch.data.dataset",
    "rapidobjectdetectionusingcascadedcnns_torch.data.image_io",
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
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched_precomp_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.serve",
    "rapidobjectdetectionusingcascadedcnns_torch.train",
    "rapidobjectdetectionusingcascadedcnns_torch.train.cascade_trainer",
    "rapidobjectdetectionusingcascadedcnns_torch.train.checkpoint",
    "rapidobjectdetectionusingcascadedcnns_torch.train.losses",
    "rapidobjectdetectionusingcascadedcnns_torch.train.metrics",
    "rapidobjectdetectionusingcascadedcnns_torch.train.optimizer",
    "rapidobjectdetectionusingcascadedcnns_torch.train.train_step",
    "rapidobjectdetectionusingcascadedcnns_torch.train.trainer",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.device",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.log",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    """Import every module of the port and the port's profiling tool of
    K2p, and run a tiny gather-mode detect, a crop-mode detect (K2's and
    K4's plain versions), a detect with the device NMS tail (K3's plain
    version), a bundle round trip, K2p's plain version and a 3-stage
    ``CascadeTrainer`` run with online augmentation and dropout, in a fresh
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


@pytest.mark.parametrize(
    "entry, what",
    [
        (lambda m: tcascade.CascadeDetector(m, mesh=object()), "item 6"),
        (lambda m: tserve.export_detector(m, 40, 48, mesh=object()), "item 6"),
        (lambda m: tserve.export_window_sharded(m, 40, 48, object()), "item 6"),
        (lambda m: tct.CascadeTrainer(None, mesh=object(), device="cpu"), "item 6"),
        (lambda m: ttrainer.SingleNetTrainer(None, mesh=object(), device="cpu"), "item 6"),
        (lambda m: ttrainer.SingleNetTrainer(None, use_inception=True, device="cpu"),
         "item 7"),
    ],
    ids=["detector mesh", "bundle mesh", "window-sharded bundle", "cascade trainer mesh",
         "trainer mesh", "trainer inception"],
)
def test_unported_paths_raise(entry, what):
    """Meshes (ROADMAP Queue A item 6) and the Inception backbone (item 7)
    are not ported: the entry points that take one raise, naming the item,
    rather than running without it."""
    with pytest.raises(NotImplementedError, match=what):
        entry(_tiny_model())


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
    with pytest.raises(NotImplementedError, match="item 6"):
        tcascade.CascadeDetector(_tiny_model(), mesh=object())
