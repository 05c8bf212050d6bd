"""Port vs JAX: the train apps over a disk corpus, their checkpoints, the
prefetch thread of the training loop, and the train apps' narrowed catch.

Both packages' ``TrainCascadeApp`` (3 nets, 12/24/48 px) and ``TrainApp``
(one 24 px net) train on the same label-folder corpus of 24 PNGs through
their ``DiskDatasetProvider`` (conv [8], fc1 32, f32, batch 8, Adam,
dropout 1, augmentation off, 2 epochs), from the same initial parameters:
the port's ``init_stage`` is replaced, in this file only, by the JAX
initialization, as in tests/test_torch_cascade_trainer.py. Tolerances are
that file's: every update's loss within rtol 1e-4; the final parameters all
but 1e-4 of the values within rtol 1e-3 and atol 1e-4, the rest within 10
learning rates; the evaluation results and the collage PNG equal.
"""

import contextlib
import os
import threading

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import train_apps as japps
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jcheckpoint
from rapidobjectdetectionusingcascadedcnns_tpu.train import train_step as jstep
from rapidobjectdetectionusingcascadedcnns_tpu.utils import log as jlog
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.apps import train_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.data import prefetch, synthetic
from rapidobjectdetectionusingcascadedcnns_torch.data.loader import DiskDatasetProvider
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct
from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as tstep
from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as ttrainer
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CFG = {
    "conv_filter_sizes": [8], "fc1_size": 32, "batch_size": 8, "max_batch_size": 40,
    "epochs_total": 2, "compute_dtype": "float32", "data_augmentation_online": False,
    "optimizer": 1, "learning_rate_init": 0.003, "dropout_rate": 1.0,
    "n_max_constant_evals": 4, "dataset_keys": ["faces"], "class_min_images": None,
    "log_auto_save": False, "session_key": "apps",
}


def _jax_init(cfg, generator):
    """The JAX trainer's initial parameters for the seed the port's trainer
    seeds its init generator with."""
    key = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
    jcfg = jcnn.StageConfig.from_config(cfg.input_size, bottleneck_in_size=cfg.bottleneck_in_size)
    return bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcnn.init_stage(key, jcfg)), "cpu")


def _configure(root, **extra):
    for c, sub in ((jcf, "jax"), (tcf, "torch")):
        for key, value in {**CFG, "dataset_path_root": os.path.join(root, "data"),
                           "output_graph_dir": os.path.join(root, "models_" + sub),
                           "cache_path_root": os.path.join(root, "cache_" + sub),
                           "collages_dir": os.path.join(root, "collages_" + sub),
                           **extra}.items():
            c.set(key, value)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_apps"))
    synthetic.write_label_folder_corpus(os.path.join(root, "data"), "faces", 14, 10, seed=3)
    jlog.set_echo(False)
    tlog.set_echo(False)
    losses = {"cascade": [], "single": []}
    orig_step = jstep.make_train_step
    target = []

    def recording_step(*args, **kwargs):
        step, record = orig_step(*args, **kwargs), []
        losses[target[-1]].append(record)

        def run(*a, **k):
            state, loss = step(*a, **k)
            record.append(float(loss))
            return state, loss

        return run

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jstep, "make_train_step", recording_step)
            mp.setattr(tcnn, "init_stage", _jax_init)
            _configure(root)
            target.append("cascade")
            jc = japps.TrainCascadeApp()
            tc = tapps.TrainCascadeApp(device="cpu")
            _configure(root, img_width=24)
            target.append("single")
            js = japps.TrainApp()
            ts = tapps.TrainApp(device="cpu")
        yield {"root": root, "jc": jc, "tc": tc, "js": js, "ts": ts, "losses": losses}
    finally:
        jlog.set_echo(True)
        tlog.set_echo(True)
        jcf.reset()
        tcf.reset()


def _assert_params_close(got_params, ref_params):
    lr = CFG["learning_rate_init"]
    got = np.concatenate([t.detach().cpu().numpy().ravel()
                          for t in tstep.param_leaves(got_params)])
    ref = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(ref_params)])
    diff = np.abs(got - ref)
    outside = diff > 1e-4 + 1e-3 * np.abs(ref)
    assert outside.mean() <= 1e-4, (int(outside.sum()), got.size)
    assert diff.max() <= 10 * lr, float(diff.max())


def test_train_cascade_app_matches_jax(trained):
    """``TrainCascadeApp`` over the disk corpus: the same losses, combined
    results (``final_results`` with the JAX keys) and parameters, the
    dataset cache written per size and the stages exported."""
    jc, tc = trained["jc"], trained["tc"]
    ref_losses = trained["losses"]["cascade"]
    assert len(ref_losses) == len(tc.cascade_trainer.stage_trainers) == 3
    for ref, st in zip(ref_losses, tc.cascade_trainer.stage_trainers):
        assert len(st.losses()) == len(ref) == 6
        np.testing.assert_allclose(st.losses(), ref, rtol=1e-4)
    assert sorted(tc.final_results) == sorted(jc.final_results) == ["test", "train", "valid"]
    assert tc.final_results == jc.final_results
    for jp, tp in zip(jc.model.stage_params, tc.model.stage_params):
        _assert_params_close(tp, jp)
    root = trained["root"]
    assert sorted(os.listdir(os.path.join(root, "cache_torch", "v1"))) == [
        "12x12", "24x24", "48x48"]
    assert [os.path.exists(p) for p in tc.exported_paths] == [True] * 3


def test_train_app_matches_jax(trained):
    """``TrainApp``: the same losses, final evaluation and parameters, the
    evaluation collage byte-equal and the single net exported."""
    js, ts = trained["js"], trained["ts"]
    (ref,) = trained["losses"]["single"]
    np.testing.assert_allclose(ts.trainer.losses(), ref, rtol=1e-4)
    assert sorted(ts.final_results) == sorted(js.final_results)
    assert ts.final_results == js.final_results
    _assert_params_close(ts.trainer.state.params, js.trainer.state.params)
    root = trained["root"]
    (tname,) = os.listdir(os.path.join(root, "collages_torch"))
    (jname,) = os.listdir(os.path.join(root, "collages_jax"))
    assert tname == jname == "apps_single_eval.png"
    with open(os.path.join(root, "collages_torch", tname), "rb") as f, \
            open(os.path.join(root, "collages_jax", jname), "rb") as g:
        assert f.read() == g.read()
    assert os.path.exists(ts.exported_path)


def _port_leaves(params):
    return [t.detach().cpu().numpy() for t in tstep.param_leaves(params)]


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def test_checkpoints_read_across(trained):
    """The JAX ``checkpoint.load_cascade`` reads what the port's app wrote,
    and the port's ``bridge.load_cascade`` what the JAX app wrote: the same
    parameters, configurations and standardisation either way."""
    root = trained["root"]
    from_port = jcheckpoint.load_cascade(os.path.join(root, "models_torch"), "apps")
    from_jax = bridge.load_cascade(os.path.join(root, "models_jax"), "apps", device="cpu")
    for got, ref, got_leaves, ref_leaves in (
        (from_port, trained["tc"].model, _jax_leaves, _port_leaves),
        (from_jax, trained["jc"].model, _port_leaves, _jax_leaves),
    ):
        assert got.n_nets == ref.n_nets == 3
        for gp, rp in zip(got.stage_params, ref.stage_params):
            for a, b in zip(got_leaves(gp), ref_leaves(rp)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(got.stage_means + got.stage_stds, ref.stage_means + ref.stage_stds):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [c.input_size for c in from_port.stage_configs] == [12, 24, 48]
    single = bridge.load_single(os.path.join(root, "models_jax"), "apps", device="cpu")
    assert single[1].input_size == 24


def test_prefetch_keeps_the_batch_stream(trained, monkeypatch):
    """The loop's ``PrefetchIterator`` gives the batches in the order the
    iterator gives them, re-raises a producer's error in the consumer,
    stops its thread on ``close()`` and when the loop leaves an epoch early,
    and leaves a trainer's losses as they are without it."""
    _configure(trained["root"], img_width=24)
    ds = DiskDatasetProvider().dataset(24)
    plain = [b.indices.copy() for b in ds.train.new_default_iterator(8, seed=5)]
    fetched = [b.indices.copy() for b in
               prefetch.PrefetchIterator(iter(ds.train.new_default_iterator(8, seed=5)), 2)]
    assert len(plain) == len(fetched) == 3
    for a, b in zip(plain, fetched):
        np.testing.assert_array_equal(a, b)

    def failing():
        yield 1
        raise ValueError("producer failed")

    it = prefetch.PrefetchIterator(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)

    def endless():
        while True:
            yield np.zeros(4)

    with prefetch.PrefetchIterator(endless(), depth=2) as it:
        assert next(it).shape == (4,)
    assert not it._thread.is_alive()

    def prefetch_threads():
        return [t for t in threading.enumerate() if t.name == "PrefetchIterator"]

    assert not prefetch_threads()
    tcf.set("timeout_minutes", 1e-9)  # the loop leaves after its first step
    early = ttrainer.SingleNetTrainer(ds, seed=0, device="cpu")
    early.train()
    assert len(early.losses()) == 1
    assert not prefetch_threads()
    tcf.set("timeout_minutes", 0)

    def train():
        t = ttrainer.SingleNetTrainer(ds, seed=0, device="cpu")
        t.train()
        return t.losses()

    with_thread = train()
    monkeypatch.setattr(ttrainer, "PrefetchIterator",
                        lambda batches, depth: contextlib.nullcontext(batches))
    np.testing.assert_array_equal(train(), with_thread)


def test_finalize_lets_a_predict_error_propagate(trained, monkeypatch):
    """``TrainApp._finalize`` isolates only the collage rendering: a failed
    collage is logged and the export still happens, but an error of
    ``trainer.predict`` (on the card in a real run) propagates, where the
    JAX app logs it; the abort save re-raises a CUDA error."""
    app = trained["ts"]
    _configure(trained["root"], img_width=24)

    def broken_collage(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tapps, "evaluation_collage", broken_collage)
    tlog.log_clear()
    app._finalize()
    assert any("collage skipped: disk full" in line for line in tlog.log_lines())

    def failed_predict(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(app.trainer, "predict", failed_predict)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        app._finalize()
    tcf.set("auto_save_on_abort", True)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        app._on_cancel()
    # the JAX app logs the same error and goes on
    jtrainer = trained["js"].trainer
    monkeypatch.setattr(jtrainer, "predict", failed_predict)
    trained["js"]._finalize()


def test_default_provider_and_device():
    """``_default_provider``: the synthetic corpus for ``["synthetic"]``, the
    disk provider otherwise, as in the JAX app; the apps run on the card
    unless given the CPU, so without a card they raise when made."""
    tcf.set("dataset_keys", ["synthetic"])
    tcf.set("class_min_images", 30)
    provider = tapps._default_provider()
    assert isinstance(provider, tct.SyntheticProvider)
    assert [provider.dataset(size).n_samples for size in (12, 24, 48)] == [60] * 3
    tcf.set("dataset_keys", ["faces"])
    assert isinstance(tapps._default_provider(), DiskDatasetProvider)
    if not torch.cuda.is_available():
        for app_cls in (tapps.TrainApp, tapps.TrainCascadeApp):
            with pytest.raises(RuntimeError, match="is_available"):
                app_cls(run_now=False)
            assert app_cls(run_now=False, device="cpu").device.type == "cpu"
