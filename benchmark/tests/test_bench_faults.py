"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` has to come out false, for each fault a
cell can have. The faults are planted in the detector, where its answers
are made."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import cell
from rapidobjectdetectionusingcascadedcnns_torch import serve
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade

SEED = 2**33 + 5


def _run(root, name, every_frame=False):
    """A run of 0.5 s; ``every_frame``: a traced run instead, whose
    sessions send a fixed number of requests (the tiny pool's every frame)
    whatever the host's speed."""
    out = cell.run(name, SEED, 0.5, every_frame, "cpu", root=root)
    out.pop("_lines")
    return out


@pytest.mark.parametrize("name", ["vga-batch16", "dense-fddb-450"])
def test_sound_run_is_correct(tiny_root, name):
    out = _run(tiny_root, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    real = cascade.CascadeDetector.detect_batch_yuv420

    def half(self, frames):
        kept = real(self, frames[: len(frames) // 2])
        return kept + kept  # the frames left out get the answers of the rest

    monkeypatch.setattr(cascade.CascadeDetector, "detect_batch_yuv420", half)
    out = _run(tiny_root, "vga-batch16")
    assert not out["correct"]
    assert out["checks"]["flip_margin"]["value"] > out["checks"]["flip_margin"]["limit"]


def test_half_the_survivors_lost(tiny_root, monkeypatch):
    """A stage gate that drops every other survivor (slots skipped): the
    program's NMS still agrees with its own final windows, and the
    windows it lost lie far from their thresholds."""
    real = cascade._compact_indices

    def lossy(alive, p_fg, cap, compaction):
        keep, alive_out = real(alive, p_fg, cap, compaction)
        alive_out = alive_out.clone()
        alive_out[:, 1::2] = False
        return keep, alive_out

    monkeypatch.setattr(cascade, "_compact_indices", lossy)
    out = _run(tiny_root, "dense-fddb-450", every_frame=True)
    assert out["attempted"] == 4
    assert not out["correct"]
    assert out["checks"]["flip_mass"]["value"] > out["checks"]["flip_mass"]["limit"]
    assert out["checks"]["nms_mismatch"]["value"] == 0


def test_no_window_kept(tiny_root, monkeypatch):
    """Every frame answered with no window and no box: only the windows
    that the reference keeps far from their thresholds can tell."""
    real = serve.unpack_packed_row

    def empty(*args, **kwargs):
        res = real(*args, **kwargs)
        for field in ("raw_window_ids", "raw_confidences", "raw_boxes", "boxes",
                      "confidences"):
            setattr(res, field, getattr(res, field)[:0])
        return res

    monkeypatch.setattr(serve, "unpack_packed_row", empty)
    out = _run(tiny_root, "dense-fddb-450", every_frame=True)
    assert out["attempted"] == 4
    assert not out["correct"]
    assert out["checks"]["nms_mismatch"]["value"] == 0
    assert out["checks"]["flip_mass"]["value"] > out["checks"]["flip_mass"]["limit"]


@pytest.mark.parametrize("name", ["vga-batch16", "dense-fddb-450"])
def test_an_answer_altered_where_it_is_made(tiny_root, monkeypatch, name):
    real = serve.postprocess_raw

    def shifted(boxes, conf, **kwargs):
        out_boxes, out_conf = real(boxes, conf, **kwargs)
        if len(out_boxes):
            out_boxes = out_boxes.copy()
            out_boxes[0] += np.array([1.0, 0.0, 1.0, 0.0])
        return out_boxes, out_conf

    monkeypatch.setattr(serve, "postprocess_raw", shifted)
    out = _run(tiny_root, name)
    assert not out["correct"]
    assert out["checks"]["nms_mismatch"]["value"] > 0
