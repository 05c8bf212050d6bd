"""Guards of the port: no jax at run time, no quiet CPU fallback, and a
clear refusal of the paths that are not ported yet."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import _build
from rapidobjectdetectionusingcascadedcnns_torch.utils import device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "rapidobjectdetectionusingcascadedcnns_torch",
    "rapidobjectdetectionusingcascadedcnns_torch.data",
    "rapidobjectdetectionusingcascadedcnns_torch.models.bridge",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cascade",
    "rapidobjectdetectionusingcascadedcnns_torch.models.cnn",
    "rapidobjectdetectionusingcascadedcnns_torch.ops._build",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.color",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows",
    "rapidobjectdetectionusingcascadedcnns_torch.ops.windows_cuda",
    "rapidobjectdetectionusingcascadedcnns_torch.serve",
    "rapidobjectdetectionusingcascadedcnns_torch.utils.device",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    """Import every module of the port and run a tiny detect, in a fresh
    interpreter: jax must stay out of sys.modules."""
    code = (
        "import importlib, sys\n"
        "for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import config as cf\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.models import cascade\n"
        "cf.set('conv_filter_sizes', [4]); cf.set('fc1_size', 8)\n"
        "cf.set('window_scale_factor', 1.5)\n"
        "img = synthetic.make_scene(40, 48, 1, seed=0, min_face=16, max_face=24).image\n"
        "res = cascade.CascadeDetector(cascade.build_cascade_model(seed=0)).detect(img)\n"
        "assert res.n_windows > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    ).format(mods=PORT_MODULES)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_a_card_raises():
    assert device.resolve_device(None) == torch.device("cpu")
    assert device.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tcascade.build_cascade_model(seed=0, device="cuda")


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
    return tcascade.build_cascade_model(seed=0)


@pytest.mark.parametrize(
    "settings, what",
    [
        ({"window_extraction_mode": "crop"}, "crop-mode"),
        ({"nms_on_device": True, "nms": cf.NMS_OPENCV}, "nms_on_device"),
        ({"use_pallas_resample": "pallas2dyn"}, "re-extraction"),
        ({"dyn_reextract": "on"}, "re-extraction"),
    ],
)
def test_unported_paths_raise(settings, what):
    det = tcascade.CascadeDetector(_tiny_model())
    for key, value in settings.items():
        cf.set(key, value)
    img = np.zeros((40, 48, 3), np.uint8)
    with pytest.raises(NotImplementedError, match=what):
        det.detect(img)


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 11"):
        tcascade.CascadeDetector(_tiny_model(), mesh=object())
