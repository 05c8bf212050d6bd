"""Window-sharded serving bundles of the port on the CPU
(``serve.export_window_sharded``, ``load_bundle(dir, mesh=)``): the
shard-local programs of one image's cascade, saved and loaded on a 2-shard
CPU mesh, against the live ``parallel/window_shard.detect_window_sharded``
in both extraction modes, walking the capacity ladder, and truncated at its
top rung; and the bundle's refusals."""

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.parallel import window_shard as tws

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

MESH = ("cpu", "cpu")
CAPS = [256, 128]
# the 892 windows of a 48x64 frame at scale factor 1.1, every one kept by
# the 0.0 threshold: the ladder [256, 128] -> [512, 256] -> [892, 512] ->
# [892, 892] is walked to its top
CFG = dict(window_scale_factor=1.1, nms_opencv_min_neighbors=1,
           foreground_confidence_threshold=0.0)


def _frame():
    return synthetic.make_scene(48, 64, 1, seed=3, min_face=16, max_face=24).image


@pytest.fixture(scope="module")
def model():
    # from the defaults: a module fixture runs before conftest's per-test
    # restore, which brings back whatever the process's first test module
    # had set when it took its snapshot
    jcf.reset()
    tcf.reset()
    tp.configure(**CFG)
    _, tmodel = tp.jax_and_port_models(seed=0)
    tcf.reset()
    return tmodel


@pytest.mark.parametrize("mode, redispatch, n_rungs", [
    ("crop", True, 4), ("gather", True, 4), ("crop", False, 1),
], ids=["crop ladder", "gather ladder", "crop truncated"])
def test_bundle_serves_the_live_window_sharded_detection(model, tmp_path, mode, redispatch,
                                                         n_rungs):
    """Survivors, window ids, confidences and boxes of the loaded bundle
    equal the live window-sharded detection: re-dispatched to the rung the
    live path reaches, or with one rung truncated as the live path
    truncates with re-dispatch off (rank compaction both)."""
    tp.configure(**CFG, window_extraction_mode=mode, cascade_saturation_redispatch=redispatch)
    bundle = tserve.export_window_sharded(model, 48, 64, MESH, capacities=CAPS, n_rungs=n_rungs)
    assert bundle.meta["kind"] == "window_sharded" and bundle.meta["nr_devices"] == 2
    assert bundle.meta["program_roles"][0] == ("extract" if mode == "gather" else "stage0")
    assert len(bundle.meta["capacity_rungs"]) == n_rungs
    tserve.save_bundle(bundle, str(tmp_path))
    live = tws.detect_window_sharded(tcascade.CascadeDetector(model, capacity_schedule=CAPS),
                                     _frame(), MESH)
    tcf.reset()
    served = tserve.load_bundle(str(tmp_path), mesh=MESH).detect(_frame())
    assert served.n_survivors_per_stage == live.n_survivors_per_stage
    assert tcascade.CascadeDetector._is_saturated(served.n_survivors_per_stage, CAPS)
    np.testing.assert_array_equal(served.raw_window_ids, live.raw_window_ids)
    np.testing.assert_array_equal(served.raw_confidences, live.raw_confidences)
    np.testing.assert_array_equal(served.boxes, live.boxes)


def test_bundle_refusals(model, tmp_path):
    """A window-sharded bundle loads only with a mesh of its size; its
    export takes a mesh and re-extracts with K1 alone."""
    tp.configure(**CFG)
    tserve.save_bundle(tserve.export_window_sharded(model, 48, 64, MESH, capacities=CAPS,
                                                    n_rungs=1), str(tmp_path))
    with pytest.raises(ValueError, match="mesh"):
        tserve.load_bundle(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="the mesh has 4"):
        tserve.load_bundle(str(tmp_path), mesh=("cpu",) * 4)
    with pytest.raises(TypeError, match="tuple of devices"):
        tserve.export_window_sharded(model, 48, 64, object())
    with pytest.raises(ValueError, match="K1"):
        tserve.export_window_sharded(model, 48, 64, MESH, resample_impl="xla")
