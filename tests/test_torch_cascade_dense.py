"""Port vs JAX: crop-mode (dense-pyramid) detection.

The JAX reference runs its einsum formulation (``use_pallas_resample="xla"``,
which its own tests hold equal to its kernels K2 and K4); the port runs its
default kernels' plain versions on the CPU: K2 for stage 0, K1 or K4 for
re-extraction. Parameters come from the JAX ``build_cascade_model`` through
the bridge. Recipe of tests/test_windows_dyn.py's cascade test: 320x384,
2 nets of 12/24 px, scale factor 1.25 (11 levels, so crop mode is forced).
Tolerance: ``torch_parity.assert_results_close`` (survivor ids up to 2%
borderline flips, confidences within 2e-3, NMS boxes within 2 px).
"""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import single as jsingle
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import single as tsingle
from rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid import build_plan
from rapidobjectdetectionusingcascadedcnns_torch.ops import (
    windows_cuda,
    windows_dyn,
    windows_dyn_cuda,
    windows_sched_cuda,
)

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

DENSE = {
    "cascade_n_nets": 2,
    "img_width": 24,
    "window_scale_factor": 1.25,
    "min_window_length": 0.075,
    "window_extraction_mode": "crop",
}


def _scene():
    return synthetic.make_scene(320, 384, 2, seed=9, min_face=60, max_face=90).image


@pytest.fixture(scope="module")
def models():
    tp.configure(**DENSE)
    return tp.jax_and_port_models(seed=3)


@pytest.fixture(scope="module")
def jax_result(models):
    tp.configure(**DENSE)
    return jcascade.CascadeDetector(models[0]).detect(_scene())


def _launches():
    return (windows_cuda.LAUNCHES, windows_sched_cuda.LAUNCHES, windows_dyn_cuda.LAUNCHES)


def _record_resample_impls(monkeypatch):
    """Spy on ``cascade_core``: the resample choice of every dispatch."""
    seen = []
    core = tcascade.cascade_core

    def spy(*args):
        seen.append(args[-1])
        return core(*args)

    monkeypatch.setattr(tcascade, "cascade_core", spy)
    return seen


@pytest.mark.parametrize("dyn", ["off", "on"])
def test_crop_mode_cascade_matches_jax(models, jax_result, dyn):
    """The default kernels (K2 stage 0, K1 re-extraction) and, with
    ``dyn_reextract="on"``, K4 re-extraction with no big-class overflow."""
    tp.configure(dyn_reextract=dyn, **DENSE)
    assert tcascade.resolve_resample_impl() == ("pallas2dyn" if dyn == "on" else "pallas2")
    plan = build_plan(320, 384, 12, 12, 0.075, 1.25)
    assert tcascade._stage0_schedule(plan, 12, "pallas2", False) is not None
    before = _launches()
    got = tcascade.CascadeDetector(models[1]).detect(_scene())
    assert _launches() == before  # CPU tensors: the plain versions ran
    assert got.n_windows == jax_result.n_windows
    assert got.n_survivors_per_stage[0] > 0
    assert got.reextract_overflows == [0]
    tp.assert_results_close(got, jax_result)


def test_forced_big_class_overflow_reruns_with_k1(models, jax_result, monkeypatch):
    """A big class pinned to one tile overflows at every capacity, so the
    frame ends in the corrective re-run with K1 and still matches JAX."""
    tp.configure(dyn_reextract="on", **DENSE)
    monkeypatch.setattr(windows_dyn, "default_big_cap", lambda cap, oh, ow, img_h: 16)
    impls = _record_resample_impls(monkeypatch)
    det = tcascade.CascadeDetector(models[1])
    got = det.detect(_scene())
    assert impls[0] == "pallas2dyn" and impls[-1] == "pallas", impls
    assert got.reextract_overflows == [0]  # the K1 re-run cannot overflow
    tp.assert_results_close(got, jax_result)


def test_forced_overflow_without_redispatch_reruns_at_same_caps(models, monkeypatch):
    """With re-dispatch off the overflowed frame is re-run once with K1 at
    unchanged capacities: the same result as K1 re-extraction outright."""
    tp.configure(cascade_saturation_redispatch=False, **DENSE)
    tcf.set("use_pallas_resample", "pallas")
    ref = tcascade.CascadeDetector(models[1]).detect(_scene())
    tcf.set("use_pallas_resample", "auto")
    tcf.set("dyn_reextract", "on")
    monkeypatch.setattr(windows_dyn, "default_big_cap", lambda cap, oh, ow, img_h: 16)
    impls = _record_resample_impls(monkeypatch)
    det = tcascade.CascadeDetector(models[1])
    got = det.detect(_scene())
    assert impls == ["pallas2dyn", "pallas"]
    assert det.redispatches == 1
    assert got.n_survivors_per_stage == ref.n_survivors_per_stage
    assert set(got.raw_window_ids.tolist()) == set(ref.raw_window_ids.tolist())


def test_single_net_detector_crop_mode_matches_jax():
    """``SingleNetDetector`` on a dense 24 px pyramid, K2 (plain) against the
    JAX detector's einsums: same windows, foreground ids up to 2% flips."""
    import jax

    tp.configure(window_scale_factor=1.1, window_extraction_mode="crop")
    scfg = jcnn.StageConfig.from_config(24, bottleneck_in_size=None)
    params = jax.tree_util.tree_map(np.asarray, jcnn.init_stage(jax.random.PRNGKey(0), scfg))
    mean = np.full((24, 24, 3), 127.5, np.float32)
    std = np.full((24, 24, 3), 64.0, np.float32)
    img = synthetic.make_scene(160, 256, 2, seed=5, min_face=40, max_face=70).image
    ref = jsingle.SingleNetDetector(params, scfg, mean, std).detect(img)
    det = tsingle.SingleNetDetector(
        bridge.params_from_numpy(params, device="cpu"),
        bridge.stage_config_from_jax(scfg), mean, std, device="cpu",
    )
    before = windows_sched_cuda.LAUNCHES
    got = det.detect(img)
    assert windows_sched_cuda.LAUNCHES == before
    assert got.n_windows == ref.n_windows
    conf_ref = dict(zip(map(tuple, ref.raw_boxes.tolist()), ref.raw_confidences.tolist()))
    conf_got = dict(zip(map(tuple, got.raw_boxes.tolist()), got.raw_confidences.tolist()))
    assert len(conf_ref) > 0
    assert len(set(conf_ref) ^ set(conf_got)) <= tp.MAX_FLIP_FRACTION * len(conf_ref)
    common = set(conf_ref) & set(conf_got)
    assert max(abs(conf_ref[k] - conf_got[k]) for k in common) < tp.PROB_TOL
