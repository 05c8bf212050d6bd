"""The port's serving and training-profile tools on the CPU, at tiny
sizes: the soak report (tools/soak_torch_serving.py), the card-vs-CPU
comparison and stage probe (tools/cross_platform_torch_bundle.py) and the
training profile (tools/profile_torch_train.py)."""

import math
import os
import sys

import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.ops.color import rgb_to_yuv420

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import cross_platform_torch_bundle as cross  # noqa: E402
import profile_torch_train as ptrain  # noqa: E402
import soak_torch_serving as soak  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
THRESHOLDS = [0.5, 0.5, 0.5]


@pytest.fixture(scope="module")
def model():
    tp.configure(nms_opencv_min_neighbors=1)
    return tp.jax_and_port_models(seed=0)[1]


def test_soak_report(model):
    """Four small YUV frames soaked in batches of 2: every repeat equals
    the warm-up's detections, the latency fields are finite, and the card
    memory fields are None on the CPU."""
    tp.configure(nms_opencv_min_neighbors=1)
    scenes = [rgb_to_yuv420(synthetic.make_scene(64, 80, n_faces=1, seed=s, min_face=30,
                                                 max_face=40).image) for s in range(4)]
    det = tcascade.CascadeDetector(model, capacity_schedule=[1024, 512])
    report = soak.soak(det.detect_batch_yuv420, scenes, 8, 2, CPU)
    assert report["n_frames"] == 8 and report["n_batches"] == 4 and report["batch"] == 2
    assert report["detection_drift_count"] == 0
    assert report["memory_after_warmup"] is None and report["memory_at_end"] is None
    for key in ("fps", "batch_ms_median", "batch_ms_p95", "latency_drift_pct"):
        assert math.isfinite(report[key]), key
    assert report["batch_ms_p95"] >= report["batch_ms_median"] > 0


def _side(boxes, confs, raw_ids):
    return {"boxes": boxes, "confidences": confs, "raw_ids": raw_ids,
            "raw_confs": [0.9] * len(raw_ids)}


def test_compare_matched_detections():
    """Detections in another order within 1 px and 0.05 confidence agree;
    a 2 px shift or a 0.1 confidence change does not."""
    card = [_side([[10, 10, 50, 50], [100, 100, 140, 140]], [3.0, 2.0], [1, 2, 3])]
    cpu = [_side([[100.5, 100, 140, 140], [10, 10, 50, 50.75]], [2.04, 3.0], [1, 2, 3])]
    out = cross.compare_detections(card, cpu, THRESHOLDS)
    assert out["ok"] and not out["unmatched"]
    assert out["max_box_delta"] == 0.75 and out["max_conf_delta"] == pytest.approx(0.04)
    shifted = [_side([[12, 10, 50, 50], [100, 100, 140, 140]], [3.0, 2.0], [1, 2, 3])]
    assert not cross.compare_detections(card, shifted, THRESHOLDS)["ok"]
    changed = [_side([[10, 10, 50, 50], [100, 100, 140, 140]], [3.1, 2.0], [1, 2, 3])]
    assert not cross.compare_detections(card, changed, THRESHOLDS)["ok"]


@pytest.mark.parametrize(
    "probe_card, probe_cpu, explained",
    [
        ([0.9, 0.501, 0.7], [0.9, 0.499, 0.7], True),  # parted at stage 1's gate
        ([0.9, 0.52, 0.7], [0.9, 0.53, 0.7], True),  # same side, within 0.05 of a gate
        ([0.9, 0.9, 0.7], [0.9, 0.1, 0.7], False),  # parted far from the gate
        (None, None, False),  # not probed
    ],
)
def test_compare_unmatched_detection(probe_card, probe_cpu, explained):
    """An extra card detection whose survivor flip (window 7) sits at a
    gate is explained and reported with its stage probabilities; a flip
    far from every gate, or one not probed, fails the comparison."""
    card = [_side([[10, 10, 50, 50], [200, 200, 240, 240]], [3.0, 1.0], [1, 2, 7])]
    cpu = [_side([[10, 10, 50, 50]], [3.0], [1, 2])]
    probes = None if probe_card is None else {"card": {0: {7: probe_card}},
                                              "cpu": {0: {7: probe_cpu}}}
    out = cross.compare_detections(card, cpu, THRESHOLDS, probes)
    assert out["ok"] is explained
    (u,) = out["unmatched"]
    assert u["side"] == "card" and u["box"] == [200, 200, 240, 240] and u["explained"] is explained
    assert out["scenes"][0]["flip_evidence"] == u["survivor_flips"]
    (flip,) = u["survivor_flips"]
    assert flip["window_id"] == 7
    if probe_card is not None:
        assert flip["stage"] == 1 and flip["threshold"] == 0.5
        assert flip["stage_probabilities"] == {"card": probe_card, "cpu": probe_cpu}


def test_stage_probe_matches_the_cascade(model):
    """The probe's per-stage probabilities of the survivors of a live
    detect: each clears every gate, and the last is the survivor's
    confidence (``final_confidence_calculation`` LAST)."""
    tp.configure(nms_opencv_min_neighbors=1)
    image = synthetic.make_scene(100, 120, n_faces=1, seed=3, min_face=40, max_face=60).image
    res = tcascade.CascadeDetector(model, capacity_schedule=[4096, 4096]).detect(image)
    meta = {"img_h": 100, "img_w": 120, "min_window_length": tcf.get("min_window_length"),
            "window_scale_factor": tcf.get("window_scale_factor"), "high_precision": False,
            "chunk": tcf.get("inference_chunk_size"), "extraction_mode": "gather",
            "resample_impl": "pallas2"}
    ids = res.raw_window_ids[:40]
    probes = cross.stage_probabilities(model, image, ids, meta, CPU)
    assert sorted(probes) == sorted(ids.tolist())
    for wid, conf in zip(ids.tolist(), res.raw_confidences[:40].tolist()):
        assert all(p > 0.5 for p in probes[wid])
        assert probes[wid][-1] == pytest.approx(conf, abs=1e-6)


def test_profile_train_on_cpu():
    """Step times at 1 step of a batch of 8 for each stage, and one update
    split at its parts with the loss of ``train_step``; the profiler sees
    no device activity on the CPU."""
    tcf.set("conv_filter_sizes", [8])
    tcf.set("fc1_size", 32)
    times = ptrain.step_times(CPU, 8, steps=1, warmup=1)
    assert [(r["size"], r["augment"]) for r in times] == list(ptrain.STAGES)
    assert all(r["ms_per_step"] > 0 and r["samples_per_s"] > 0 for r in times)
    split = ptrain.update_split(CPU, 8)
    assert split["same_loss"] and math.isfinite(split["loss_parts"])
    assert set(split["parts"]) == {"augment", "forward_and_loss", "backward", "optimizer"}
    assert all(p["launches"] == ptrain.NOT_MEASURED for p in split["parts"].values())
    assert split["launches"] == ptrain.NOT_MEASURED
    assert split["total_ms"] == pytest.approx(sum(p["ms"] for p in split["parts"].values()))


def test_corpus_split_on_cpu():
    """The host timers around a tiny flagship corpus build: every part
    runs, the mined examples are read twice (negatives and positives), and
    no part outlasts the whole build."""
    out = ptrain.corpus_split(6, 12)
    parts = out["parts"]
    assert out["samples"] >= 18
    assert parts["mined_examples_read"]["calls"] == 2
    assert parts["scene_render"]["calls"] >= 1 and parts["background_sampling"]["calls"] >= 1
    assert all(0 <= p["s"] <= out["total_s"] for p in parts.values())
