"""A cascade with the appended Inception stage in the port against the JAX
package on the CPU: K1's plain version at 299 px, a 2-stage cascade (a
12 px stage and a compact-trunk Inception stage) converted from JAX
detecting a small frame, the Inception stage's byte-bounded chunks and
the live detector's walk of only the chunks that hold a live slot, a
static serving bundle of it against the live detector, the 299 px stage
sent to K1 under ``dyn_reextract="on"`` as the JAX gate sends it, and the
stage's checkpoints read across the packages.
Weights come from the JAX trees through the bridge, never drawn again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import inception as jinc
from rapidobjectdetectionusingcascadedcnns_tpu.ops import windows as jwin
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jckpt
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch import serve as tserve
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import inception as tinc
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows as twin
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda
from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_dyn as twin_dyn
from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint as tckpt

import torch_parity as tp
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

# stage 0 keeps every window of the 24x28 frame (98), the Inception stage
# gates at 0.5; small custom stage
CASCADE_CFG = dict(window_scale_factor=1.3, conv_filter_sizes=[4], fc1_size=8,
                   foreground_confidence_threshold=[0.0, 0.5])


# stage 0 keeps 39 and 41 of the 98 windows of frames 3 and 4, fewer than
# the capacity (98), so that an Inception stage cut into small chunks holds
# no live slot in its last chunks
LIVE_CFG = dict(CASCADE_CFG, foreground_confidence_threshold=[0.75, 0.5])

_CORE = tcascade.cascade_core
_BACKBONE = tinc.apply_backbone


def _frame(seed=3):
    return synthetic.make_scene(24, 28, 1, seed=seed, min_face=16, max_face=20).image


def _chunk_rows(monkeypatch, rows):
    """Cut the Inception stage into chunks of ``rows`` rows (a smaller byte
    budget)."""
    per_row = tinc.CHUNK_BYTES // tinc.rows_per_chunk()
    monkeypatch.setattr(tinc, "CHUNK_BYTES", rows * per_row + 1)
    assert tinc.rows_per_chunk() == rows


@pytest.fixture(scope="module")
def models():
    """The JAX 2-stage cascade (12 px, then a compact-trunk Inception stage
    reading stage 0's bottleneck), its detection of the frame, the port's
    converted copy, the port's live detection of the frame and K1's
    launches in it."""
    tp.configure(**CASCADE_CFG)
    s0 = jcnn.StageConfig.from_config(12)
    s1 = jcnn.StageConfig.from_config(
        299, bottleneck_in_size=s0.bottleneck_out_size, backbone="inception"
    )
    # stage 0 from the JAX init; the Inception stage's JAX tree (HWIO) holds
    # a compact trunk drawn once (the port's draw, in the JAX layout) and a
    # Glorot-uniform fc2 from numpy: the JAX init of the trunk compiles for
    # 5-7 s on this CPU
    trunk = jinc.params_from_flat(tinc.backbone_to_flat(
        tinc.init_backbone(torch.Generator().manual_seed(0))))
    fc2_in, limit = s1.bottleneck_out_size, np.sqrt(6.0 / (s1.bottleneck_out_size + 2))
    fc2 = {"W": np.random.RandomState(1).uniform(-limit, limit, (fc2_in, 2)).astype(np.float32),
           "b": np.zeros(2, np.float32)}
    params = [jcnn.init_stage(jax.random.PRNGKey(0), s0), {"backbone": trunk, "fc2": fc2}]
    means = [np.full((s, s, 3), 127.5, np.float32) for s in (12, 299)]
    stds = [np.full((s, s, 3), 64.0, np.float32) for s in (12, 299)]
    jmodel = jcascade.CascadeModel(params, [s0, s1], means, stds)
    ref = jcascade.CascadeDetector(jmodel).detect(_frame())
    tmodel = bridge.cascade_model_from_jax_arrays(
        jmodel.stage_params, jmodel.stage_configs, means, stds, device="cpu"
    )
    before = windows_cuda.LAUNCHES
    live = tcascade.CascadeDetector(tmodel).detect(_frame())
    launched = windows_cuda.LAUNCHES - before
    jcf.reset()
    tcf.reset()
    return jmodel, tmodel, ref, live, launched


def test_k1_plain_at_299_matches_jax():
    """K1's plain version at the Inception stage's 299 px (what the banded
    kernel is held to on the card) equals the jitted JAX resampler bit for
    bit: the u8 lattice values of boxes smaller and larger than the window
    on a fractional frame."""
    rng = np.random.RandomState(299)
    img = (rng.rand(60, 80, 3) * 255.0).astype(np.float32)
    boxes = np.array([[3.5, 2.0, 40.25, 50.0], [0.0, 0.0, 80.0, 60.0],
                      [10.0, 7.5, 30.0, 21.0]], np.float32)
    ref = np.asarray(jax.jit(
        lambda i, b: jwin.crop_and_resize(i, b, out_h=299, out_w=299)
    )(jnp.asarray(img), jnp.asarray(boxes)))
    got = twin.crop_and_resize_plain(
        torch.from_numpy(img)[None], torch.from_numpy(boxes)[None], 299, 299
    )[0].numpy()
    assert got.shape == (3, 299, 299, 3)
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255


def test_two_stage_cascade_matches_jax(models):
    """The converted cascade detects the frame as the JAX detector does
    (``torch_parity.assert_results_close``), through K1's plain version."""
    _, tmodel, ref, got, launched = models
    assert tmodel.stage_configs[1].backbone == "inception"
    assert launched == 0  # CPU tensors: the plain version ran
    assert got.n_survivors_per_stage[0] == got.n_windows == 98
    assert 0 < got.n_survivors_per_stage[1] < 98
    tp.assert_results_close(got, ref)


def test_inception_stage_chunks_give_the_same_result(models, monkeypatch):
    """Cut into chunks of 7 boxes (a smaller byte budget), the Inception
    stage's re-extraction and trunk give the one-chunk result: rows are
    independent."""
    _, tmodel, _, whole, _ = models
    tp.configure(**CASCADE_CFG)
    _chunk_rows(monkeypatch, 7)
    chunked = tcascade.CascadeDetector(tmodel).detect(_frame())
    np.testing.assert_array_equal(chunked.raw_window_ids, whole.raw_window_ids)
    np.testing.assert_allclose(chunked.raw_confidences, whole.raw_confidences, atol=1e-6)
    assert chunked.n_survivors_per_stage == whole.n_survivors_per_stage


def test_static_bundle_equals_live_detector(models, tmp_path):
    """A static bundle of the Inception cascade (one rung; the trunk's
    leaves flattened in a fixed order), saved and loaded on the CPU,
    serves the live detector's result; its meta records each stage's
    trunk (None for a custom stage)."""
    _, tmodel, _, live, _ = models
    tp.configure(**CASCADE_CFG)
    bundle = tserve.export_detector(tmodel, 24, 28, batch=1, n_rungs=1)
    assert bundle.meta["trunks"] == [None, "compact"]
    tserve.save_bundle(bundle, str(tmp_path))
    tcf.reset()
    served = tserve.load_bundle(str(tmp_path), device="cpu").detect(_frame())
    np.testing.assert_array_equal(served.raw_window_ids, live.raw_window_ids)
    np.testing.assert_array_equal(served.raw_confidences, live.raw_confidences)
    np.testing.assert_array_equal(served.boxes, live.boxes)
    assert served.n_survivors_per_stage == live.n_survivors_per_stage


@pytest.mark.parametrize("threshold", [0.75, 1.0])
def test_live_prefix_runs_only_chunks_with_a_live_slot(models, monkeypatch, threshold):
    """With the Inception stage cut into chunks of 5 slots a frame (10 rows
    for 2 frames), ``cascade_core``'s live prefix runs the chunks up to the
    last slot alive in either frame (the second frame's 41st: 9 chunks, where
    the first frame's 39 slots take 8) and no more, and gives the full walk's
    window ids, alive mask, survivor counts and live confidences bit for
    bit, and so its detections, which the JAX detector's match. The
    counters hold the rows run and the rows skipped, adding up to the
    capacity. At threshold 1.0 no window survives stage 0: no trunk chunk
    runs, and the empty result is the full walk's."""
    jmodel, tmodel, _, _, _ = models
    tp.configure(**dict(LIVE_CFG, foreground_confidence_threshold=[threshold, 0.5]))
    _chunk_rows(monkeypatch, 10)
    frames = [_frame(3), _frame(4)]

    def run(live_prefix):
        outs, trunk_rows = [], []

        def core(*args, **kwargs):
            outs.append(_CORE(*args, **dict(kwargs, live_prefix=live_prefix)))
            return outs[-1]

        def backbone(params, x, **kwargs):
            trunk_rows.append(x.shape[0])
            return _BACKBONE(params, x, **kwargs)

        monkeypatch.setattr(tcascade, "cascade_core", core)
        monkeypatch.setattr(tinc, "apply_backbone", backbone)
        det = tcascade.CascadeDetector(tmodel)
        results = det.detect_batch(frames)
        assert len(outs) == 1
        return outs[0], det.counters, results, trunk_rows

    ((ids_f, conf_f, alive_f, diag_f), slots_f), counts_f, res_f, trunk_f = run(False)
    ((ids, conf, alive, diag), slots), counts, res, trunk = run(True)
    assert torch.equal(ids, ids_f) and torch.equal(alive, alive_f) and torch.equal(diag, diag_f)
    assert torch.equal(conf[alive], conf_f[alive_f])
    for got, ref in zip(res, res_f):
        np.testing.assert_array_equal(got.raw_window_ids, ref.raw_window_ids)
        np.testing.assert_array_equal(got.raw_confidences, ref.raw_confidences)
        np.testing.assert_array_equal(got.boxes, ref.boxes)
    cap = tcascade.default_capacity_schedule(98, 2)[0]
    n_live = max(r.n_survivors_per_stage[0] for r in res_f)
    ran = -(-n_live // 5) * 5
    assert cap == 98 and ran < cap
    assert counts_f["rows_launched"] == [2 * 98, 2 * cap] and counts_f["rows_skipped"] == [0, 0]
    assert counts["rows_launched"] == [2 * 98, 2 * ran]
    assert counts["rows_skipped"] == [0, 2 * (cap - ran)]
    assert slots_f == [98, cap] and slots == [98, ran]
    assert trunk_f == [10] * 19 + [6] and trunk == [10] * (ran // 5)
    if threshold == 0.75:
        assert [r.n_survivors_per_stage[0] for r in res] == [39, 41] and ran == 45
        for got, ref in zip(res, jcascade.CascadeDetector(jmodel).detect_batch(frames)):
            tp.assert_results_close(got, ref)
    else:
        assert n_live == 0 and not trunk
        assert all(len(r.raw_window_ids) == len(r.boxes) == 0 for r in res)


def test_one_chunk_inception_stage_reads_no_live_count(models, monkeypatch):
    """At the default byte budget (176 rows at 299 px) the Inception
    stage's 98 slots fit one chunk: the live detector reads no live count,
    runs every slot and skips none."""
    _, tmodel, _, _, _ = models
    tp.configure(**LIVE_CFG)

    def refuse(alive):
        raise AssertionError("a live count read for a stage run in one chunk")

    monkeypatch.setattr(tcascade, "_live_slots", refuse)
    det = tcascade.CascadeDetector(tmodel)
    det.detect(_frame())
    assert det.counters["rows_launched"] == [98, 98]
    assert det.counters["rows_skipped"] == [0, 0]


def test_static_bundle_equals_live_detector_skipping_chunks(models, tmp_path, monkeypatch):
    """With the Inception stage cut into chunks of 33 slots (33, 33, 32)
    before the export and the live run, a static bundle (every chunk)
    serves the result of the live detector, which ran the two chunks that
    hold the 39 live slots and skipped the third: the same windows,
    confidences and boxes, bit for bit."""
    _, tmodel, _, _, _ = models
    tp.configure(**LIVE_CFG)
    _chunk_rows(monkeypatch, 33)
    bundle = tserve.export_detector(tmodel, 24, 28, batch=1, n_rungs=1)
    tserve.save_bundle(bundle, str(tmp_path))
    det = tcascade.CascadeDetector(tmodel)
    live = det.detect(_frame())
    assert live.n_survivors_per_stage[0] == 39
    assert det.counters["rows_launched"][1] == 66 and det.counters["rows_skipped"][1] == 32
    tcf.reset()
    served = tserve.load_bundle(str(tmp_path), device="cpu").detect(_frame())
    np.testing.assert_array_equal(served.raw_window_ids, live.raw_window_ids)
    np.testing.assert_array_equal(served.raw_confidences, live.raw_confidences)
    np.testing.assert_array_equal(served.boxes, live.boxes)
    assert served.n_survivors_per_stage == live.n_survivors_per_stage


def test_dyn_reextract_sends_the_inception_stage_to_k1(models):
    """With ``dyn_reextract="on"`` the 299 px stage is re-extracted by K1,
    as the JAX package's gate (``dyn_supported``: a tile of windows x 299
    columns exceeds 4,096) sends it there: on a 256x128 frame, tall and
    wide enough for K4's lattice, the port's cascade with K4 on equals the
    port with it off bit for bit and the JAX detector (64 boxes reach the
    Inception stage, truncated alike by both packages)."""
    jmodel, tmodel, _, _, _ = models
    tp.configure(**dict(CASCADE_CFG, window_scale_factor=1.6, cascade_capacity_schedule=[64],
                        cascade_saturation_redispatch=False))
    frame = synthetic.make_scene(256, 128, 1, seed=3, min_face=40, max_face=80).image
    assert not twin_dyn.dyn_supported(256, 128, 299, 299, 64)
    ref = jcascade.CascadeDetector(jmodel).detect(frame)
    off = tcascade.CascadeDetector(tmodel).detect(frame)
    tcf.set("dyn_reextract", "on")
    assert tcascade.resolve_resample_impl() == "pallas2dyn"
    on = tcascade.CascadeDetector(tmodel).detect(frame)
    assert on.n_survivors_per_stage[0] > 64 and on.reextract_overflows == [0]
    np.testing.assert_array_equal(on.raw_window_ids, off.raw_window_ids)
    np.testing.assert_array_equal(on.raw_confidences, off.raw_confidences)
    np.testing.assert_array_equal(on.boxes, off.boxes)
    tp.assert_results_close(on, ref)


def test_compact_stage_checkpoints_cross_read(models, tmp_path):
    """The Inception stage saved by the port loads in the JAX package (its
    ``backbone/`` leaves in HWIO, ``"backbone": "inception"``) and equals
    the JAX tree; the JAX package's save of it loads in the port as the
    same tensors."""
    jmodel, tmodel, _, _, _ = models
    cfg, params = tmodel.stage_configs[1], tmodel.stage_params[1]
    mean, std = tmodel.stage_means[1], tmodel.stage_stds[1]
    port_path = tckpt.save_stage(str(tmp_path / "port_stage"), params, cfg, mean, std)
    jparams, jcfg, jmean, _, _ = jckpt.load_stage(port_path)
    assert jcfg.backbone == "inception" and jcfg.bottleneck_in_size == cfg.bottleneck_in_size
    ref = jax.tree_util.tree_leaves_with_path(jmodel.stage_params[1])
    got = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(got) == len(ref) == len(tinc.flat_keys("compact")) + 2
    for path, leaf in ref:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    np.testing.assert_array_equal(jmean, mean)
    jax_path = str(tmp_path / "jax_stage")
    jckpt.save_stage(jax_path, jmodel.stage_params[1], jmodel.stage_configs[1], mean, std)
    back, back_cfg, _, _, _ = bridge.load_stage(jax_path, device="cpu")
    assert back_cfg == cfg
    for a, b in zip(tinc.backbone_leaves(back["backbone"]),
                    tinc.backbone_leaves(params["backbone"])):
        assert torch.equal(a, b)
    assert torch.equal(back["fc2"]["W"], params["fc2"]["W"])
