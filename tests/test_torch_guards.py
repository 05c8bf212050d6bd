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
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.ops import _build
from rapidobjectdetectionusingcascadedcnns_torch.utils import device

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "rapidobjectdetectionusingcascadedcnns_torch",
    "rapidobjectdetectionusingcascadedcnns_torch.config",
    "rapidobjectdetectionusingcascadedcnns_torch.data",
    "rapidobjectdetectionusingcascadedcnns_torch.data.image_io",
    "rapidobjectdetectionusingcascadedcnns_torch.data.synthetic",
    "rapidobjectdetectionusingcascadedcnns_torch.models.bridge",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cascade",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cnn",
    "rapidobjectdetectionusingcascadedcnns_torch.models.single",
    "rapidobjectdetectionusingcascadedcnns_torch.native",
    "rapidobjectdetectionusingcascadedcnns_torch.ops._build",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.color",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.nms",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.rectangles",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_dyn_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_sched_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.serve",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.device",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.log",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    """Import every module of the port and run a tiny gather-mode detect and
    a crop-mode detect (K2's and K4's plain versions), in a fresh
    interpreter: neither jax nor any module of the JAX package may be
    loaded."""
    code = (
        "import importlib, sys\n"
        "for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
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
        "img = synthetic.make_scene(256, 256, 1, seed=0, min_face=40, max_face=80).image\n"
        "res = cascade.CascadeDetector(model).detect(img)\n"
        "assert res.n_windows > 0 and res.reextract_overflows is not None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    ).format(mods=PORT_MODULES)
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
    "settings, what",
    [
        ({"nms_on_device": True, "nms": cf.NMS_OPENCV}, "nms_on_device"),
    ],
)
def test_unported_paths_raise(settings, what):
    det = tcascade.CascadeDetector(_tiny_model())
    for key, value in settings.items():
        cf.set(key, value)
    img = np.zeros((40, 48, 3), np.uint8)
    with pytest.raises(NotImplementedError, match=what):
        det.detect(img)


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
    with pytest.raises(NotImplementedError, match="item 11"):
        tcascade.CascadeDetector(_tiny_model(), mesh=object())
