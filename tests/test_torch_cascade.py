"""Port vs JAX: compaction, capacities, and the slice end to end in the
golden configuration (tests/test_golden.py), against the recorded goldens
and against the live JAX ``CascadeDetector``. Parameters come from the JAX
``build_cascade_model(seed=0)`` through the bridge, never re-drawn."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as cf
from rapidobjectdetectionusingcascadedcnns_tpu.data import synthetic
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SCENES = (3, 7)


def _scene(seed):
    return synthetic.make_scene(100, 120, 1, seed=seed, min_face=40, max_face=60).image


@pytest.fixture(scope="module")
def models():
    tp.configure()
    return tp.jax_and_port_models(seed=0)


@pytest.fixture(scope="module")
def jax_results(models):
    tp.configure()
    det = jcascade.CascadeDetector(models[0])
    return {s: det.detect(_scene(s)) for s in SCENES}


@pytest.mark.parametrize("cap", [16, 50])
@pytest.mark.parametrize("compaction", ["scan", "rank"])
def test_compact_indices_matches_jax(compaction, cap):
    rng = np.random.RandomState(cap)
    alive = rng.rand(3, 50) < 0.4
    alive[2] = False  # a frame with no survivor
    p = rng.rand(3, 50).astype(np.float32)
    keep, alive_out = tcascade._compact_indices(
        torch.from_numpy(alive), torch.from_numpy(p), cap, compaction
    )
    assert tuple(keep.shape) == tuple(alive_out.shape) == (3, cap)
    for b in range(3):
        jkeep, jalive = jcascade._compact_indices(
            jnp.asarray(alive[b]), jnp.asarray(p[b]), cap, compaction
        )
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(alive_out[b].numpy(), np.asarray(jalive))


def test_capacity_schedule_and_escalation_match_jax():
    for n in (1, 200, 3344, 5061, 131903):
        for stages in (2, 3):
            caps = tcascade.default_capacity_schedule(n, stages)
            assert caps == jcascade.default_capacity_schedule(n, stages)
            while caps is not None:
                nxt = tcascade.escalate_capacities(caps, n)
                assert nxt == jcascade.escalate_capacities(caps, n)
                caps = nxt


@pytest.mark.parametrize("scene_seed", SCENES)
def test_slice_matches_golden(models, scene_seed):
    """The port's detector against tests/goldens with the golden test's own
    tolerance: raw-survivor IoU > 0.95, same NMS count, boxes within 2 px."""
    tp.configure()
    res = tcascade.CascadeDetector(models[1]).detect(_scene(scene_seed))
    with np.load(os.path.join(GOLDEN_DIR, "detect_s{}.npz".format(scene_seed))) as g:
        assert res.n_windows == int(g["n_windows"])
        golden_raw = set(map(tuple, g["raw_boxes"].tolist()))
        ours_raw = set(map(tuple, res.raw_boxes.tolist()))
        inter = len(golden_raw & ours_raw)
        union = max(len(golden_raw | ours_raw), 1)
        assert inter / union > 0.95, (len(golden_raw), len(ours_raw), inter)
        assert len(res.boxes) == len(g["boxes"])
        np.testing.assert_allclose(
            np.asarray(sorted(map(tuple, res.boxes.tolist()))),
            np.asarray(sorted(map(tuple, g["boxes"].tolist()))),
            atol=2.0,
        )


@pytest.mark.parametrize("scene_seed", SCENES)
def test_slice_matches_live_jax_detector(models, jax_results, scene_seed):
    tp.configure()
    before = windows_cuda.LAUNCHES
    res = tcascade.CascadeDetector(models[1]).detect(_scene(scene_seed))
    assert windows_cuda.LAUNCHES == before  # CPU tensors: the plain version ran
    ref = jax_results[scene_seed]
    assert res.n_survivors_per_stage[0] > 0 and len(res.boxes) > 0
    tp.assert_results_close(res, ref)
    assert res.reextract_overflows == [0, 0]


def test_detect_batch_mixed_sizes_equals_single_detects(models):
    """Frames of two sizes in one call: grouped by size, one batched cascade
    per group, each result equal to a one-frame detect."""
    tp.configure(window_scale_factor=1.3)
    det = tcascade.CascadeDetector(models[1])
    imgs = [
        synthetic.make_scene(48, 64, 1, seed=s, min_face=20, max_face=30).image
        for s in (1, 2)
    ] + [synthetic.make_scene(40, 56, 1, seed=3, min_face=20, max_face=30).image]
    batch = det.detect_batch(imgs)
    for img, res in zip(imgs, batch):
        one = det.detect(img)
        np.testing.assert_array_equal(res.raw_window_ids, one.raw_window_ids)
        np.testing.assert_allclose(res.raw_confidences, one.raw_confidences, atol=1e-5)
        assert res.n_survivors_per_stage == one.n_survivors_per_stage
