"""Serving bundles of the port for more than one device type
(``platforms``), the refusals that stay, and the ``export-serving`` CLI.

A bundle is exported once, on the model's device, and saved with its
tensors on the CPU; ``load_bundle`` moves its programs to the device it is
given (``move_to_device_pass``) if the bundle lists that device's type. This
host has no card, so the bundles here are exported on the CPU; that every
tensor of a program moves (K2's schedule tables among them) is held by
moving a program to the ``meta`` device, where a constant left behind
would meet tensors of another device (and a dynamic program's host
scalars, which must stay behind, would raise). Weights come from the JAX
``build_cascade_model`` through the bridge, never re-drawn. The export
refusals (an object that is not a mesh, a dynamic batch over a mesh, K4,
``platforms`` without the export device or with a type the port lacks)
are held in ``tests/test_torch_serve.py``."""

import copy
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import run as trun
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = [1024, 512]  # no frame saturates them
CROP_CAPS = [2048, 1024]


def _cfg(**extra):
    tp.configure(nms_opencv_min_neighbors=1, nms_on_device=True, inference_batch_frames=2,
                 **extra)


def _frames(h=100, w=120, n=2):
    return [
        synthetic.make_scene(h, w, n_faces=1, seed=s, min_face=40, max_face=60).image
        for s in range(n)
    ]


def _assert_same(live, served):
    for a, b in zip(live, served):
        np.testing.assert_array_equal(a.raw_window_ids, b.raw_window_ids)
        np.testing.assert_array_equal(a.raw_confidences, b.raw_confidences)
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.confidences, b.confidences)
        assert a.n_survivors_per_stage == b.n_survivors_per_stage


CLI_ARGS = ["--height", "64", "--width", "80", "--batch", "dynamic", "--rungs", "1",
            "--platform", "cpu,cuda"]


@pytest.fixture(scope="module")
def model():
    _cfg()
    return tp.jax_and_port_models(seed=0)[1]


@pytest.fixture(scope="module", autouse=True)
def cli_run(model, tmp_path_factory):
    """``python -m ...run export-serving --device cpu --batch dynamic`` on
    the model's checkpoint in a fresh process, started with the module's
    first test so that it runs while the others do: (its directory, its
    arguments, the process)."""
    _cfg()
    work = tmp_path_factory.mktemp("cli_export")
    checkpoint.save_cascade(str(work / "models"), "cli", model)
    args = ["export-serving", str(work / "models"), "cli", str(work / "bundle"), *CLI_ARGS]
    code = (
        "import sys\n"
        "from rapidobjectdetectionusingcascadedcnns_torch import config as cf, run\n"
        "for k, v in {cfg!r}.items():\n"
        "    cf.set(k, v)\n"
        "sys.argv = ['run'] + {args!r}\n"
        "run.main(sys.argv[1:] + ['--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    ).format(cfg={k: tcf.get(k) for k in [*tp.GOLDEN_CFG, "nms_on_device",
                                           "inference_batch_frames"]}, args=args)
    tcf.reset()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield work, args, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _on_meta(loaded, rung=0):
    """Program ``rung`` of a saved bundle loaded on the CPU (a copy of it,
    as ``torch.export.load`` read it) moved from the CPU to the meta device
    as ``load_bundle`` moves it to a card, and run there on meta frames:
    the packed rows' shape. A dynamic program's host scalars stay on the
    CPU (``item`` of a meta tensor would raise). Running the copy can fix
    the frame count of the loaded bundle's own modules, so a test calls
    this after it has served with ``loaded``."""
    with warnings.catch_warnings():  # pytree's deprecation notes on deepcopy
        warnings.simplefilter("ignore", FutureWarning)
        program = copy.deepcopy(loaded.programs[rung])
    program = tserve._to_device(program, "cpu", "meta")
    meta = loaded.meta
    frames = torch.zeros(meta["chunk_hint"], meta["img_h"], meta["img_w"], 3,
                         dtype=torch.uint8, device="meta")
    out = program.module()(frames, [w.to("meta") for w in loaded._weights])
    assert out.device.type == "meta"
    return tuple(out.shape)


@pytest.fixture(scope="module")
def crop_live(model):
    """The live crop-mode detector's results on the 128x256 frames, which
    both crop-mode bundles are held to."""
    _cfg(window_extraction_mode="crop")
    frames = _frames(128, 256)
    live = tcascade.CascadeDetector(model, capacity_schedule=CROP_CAPS).detect_batch(frames)
    tcf.reset()
    return frames, live


def test_cpu_cuda_bundle_lists_both_and_equals_live(model, tmp_path):
    """A ("cpu", "cuda") bundle exported on the CPU lists both device
    types, loads on the CPU (no move) and equals the live detector; its
    program moves whole to another device."""
    _cfg()
    live = tcascade.CascadeDetector(model, capacity_schedule=CAPS).detect_batch(_frames())
    bundle = tserve.export_detector(model, 100, 120, batch=2, capacities=CAPS, n_rungs=1,
                                    platforms=("cpu", "cuda"))
    assert bundle.meta["platforms"] == ["cpu", "cuda"]
    assert bundle.meta["device"] == "cpu" and bundle.meta["export_device"] == "cpu"
    tserve.save_bundle(bundle, str(tmp_path))
    tcf.reset()
    loaded = tserve.load_bundle(str(tmp_path), device="cpu")
    assert loaded.meta["platforms"] == ["cpu", "cuda"]
    _assert_same(live, loaded.detect_batch(_frames()))
    assert _on_meta(loaded) == (2, loaded.programs[0].module()(
        torch.as_tensor(np.stack(_frames())), loaded._weights).shape[1])


@pytest.mark.parametrize("batch", [2, "dynamic"])
def test_crop_mode_bundle_lists_both_and_equals_live(model, crop_live, tmp_path, batch):
    """A crop-mode ("cpu", "cuda") bundle of 128x256 frames, with a static
    and with a symbolic frame count: stage 0 runs K2 (``rodc::sched``) over
    the plan's schedule, whose tables enter the program as constants; it
    equals the live detector on the CPU, and the moved program carries the
    tables along."""
    _cfg(window_extraction_mode="crop")
    frames, live = crop_live
    bundle = tserve.export_detector(model, 128, 256, batch=batch, capacities=CROP_CAPS,
                                    n_rungs=1, platforms=("cpu", "cuda"))
    assert bundle.meta["extraction_mode"] == "crop" and bundle.meta["resample_impl"] == "pallas2"
    targets = [str(n.target) for n in bundle.programs[0].graph.nodes if n.op == "call_function"]
    assert targets.count("rodc.sched.default") == 1
    assert len(bundle.programs[0].constants) > 0  # K2's schedule tables
    tserve.save_bundle(bundle, str(tmp_path))
    tcf.reset()
    loaded = tserve.load_bundle(str(tmp_path), device="cpu")
    _assert_same(live, loaded.detect_batch(frames))
    assert _on_meta(loaded)[0] == 2


def test_a_host_scalar_that_cannot_stay_on_the_cpu_raises():
    """A program whose ``item`` reads a tensor computed from its input
    cannot keep that tensor on the CPU when it moves: the move raises
    instead of leaving a device synchronisation in every call."""

    class ReadsInput(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(x.sum().item() + 1)

    program = torch.export.export(ReadsInput(), (torch.ones(3, dtype=torch.int64),))
    with pytest.raises(ValueError, match="cannot be kept on the CPU"):
        tserve._to_device(program, "cpu", "meta")


def test_load_on_an_unlisted_device_raises(model, tmp_path):
    _cfg()
    bundle = tserve.export_detector(model, 100, 120, batch=2, capacities=CAPS, n_rungs=1)
    assert bundle.meta["platforms"] == ["cpu"]
    tserve.save_bundle(bundle, str(tmp_path))
    with pytest.raises(ValueError, match="lists platforms"):
        tserve.load_bundle(str(tmp_path), device="meta")


def test_cli_export_serving_dynamic(model, cli_run):
    """``python -m ...run export-serving --device cpu --batch dynamic``
    writes a bundle that loads and equals the live detector, in a process
    that never loads jax or the JAX package; without a card the command
    raises unless given the CPU."""
    _cfg()
    work, args, proc = cli_run
    out_dir = str(work / "bundle")
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.strip().endswith("ok") and "exported serving bundle" in stdout
    loaded = tserve.load_bundle(out_dir, device="cpu")
    assert loaded.meta["batch"] == "dynamic" and loaded.meta["platforms"] == ["cpu", "cuda"]
    frames = _frames(64, 80, 3)
    tcf.set("inference_batch_frames", loaded.meta["chunk_hint"])
    live = tcascade.CascadeDetector(model, capacity_schedule=loaded.meta["capacity_rungs"][0])
    _assert_same(live.detect_batch(frames), loaded.detect_batch(frames))
    assert _on_meta(loaded)[0] == loaded.meta["chunk_hint"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            trun.main(args)
