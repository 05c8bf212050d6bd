"""Port vs JAX: the boosted 3-stage cascade trainer end to end.

Both packages train a 12/24/48 px cascade (conv [8], fc1 32, f32, batch 64,
Adam, dropout 1, augmentation off, 2 epochs, AdaBoost-like re-weighting,
bottleneck reuse) on the same synthetic corpus. They see the same batch
stream (the seeded numpy iterators are copies) and start from the same
parameters: the port's ``init_stage`` is replaced, in this test only, by
the JAX package's initialization for the key the JAX trainer draws
(``PRNGKey(seed + nr)`` split once). Compared:

  * every update's loss, rtol 1e-4 (f32 in other summation orders over 30
    Adam updates and the evaluations' best-snapshot choices);
  * the re-weighted sample distributions after stages 1 and 2, rtol 1e-9
    (float64 from equal predictions);
  * the final parameters: all but 1e-4 of the values within rtol 1e-3 and
    atol 1e-4, the rest within 10 learning rates. Adam moves a weight by
    about the learning rate per update whatever its gradient, so a weight
    whose gradient is near Adam's eps (1e-8) follows the gradient's last
    bits (see tests/test_torch_train_step.py);
  * the combined cascade evaluation, equal;
  * a scene detected by the port's detector with each trained cascade,
    equal up to borderline flips (tests/torch_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.train import cascade_trainer as jct
from rapidobjectdetectionusingcascadedcnns_tpu.train import train_step as jstep
from rapidobjectdetectionusingcascadedcnns_tpu.utils import log as jlog
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct
from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as tstep
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog

from torch_parity import assert_results_close, reset_port_config  # noqa: F401

torch.set_num_threads(2)

CFG = {
    # max_batch_size 40: every evaluation and prediction batch has one shape
    # (fewer JAX compilations)
    "conv_filter_sizes": [8], "fc1_size": 32, "batch_size": 64, "max_batch_size": 40,
    "epochs_total": 2, "compute_dtype": "float32", "data_augmentation_online": False,
    "optimizer": 1, "learning_rate_init": 0.003, "dropout_rate": 1.0,
    # the F-beta stages predict all-foreground at their first evaluations;
    # with 4 evaluations per stage, the guard must not stop them
    "n_max_constant_evals": 4,
}
N_POS, N_NEG = 150, 250  # 320 / 40 / 40 samples: 5 updates per epoch


def _jax_init(cfg, generator):
    """The JAX trainer's initial parameters for the seed the port's trainer
    seeds its init generator with."""
    key = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
    jcfg = jcnn.StageConfig.from_config(cfg.input_size, bottleneck_in_size=cfg.bottleneck_in_size)
    return bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcnn.init_stage(key, jcfg)), "cpu")


@pytest.fixture(scope="module")
def trained():
    for key, value in CFG.items():
        jcf.set(key, value)
        tcf.set(key, value)
    jlog.set_echo(False)
    tlog.set_echo(False)
    jax_losses, jax_weights = [], []
    orig_step, orig_reweight = jstep.make_train_step, jct.reweight_adaboost_like

    def recording_step(*args, **kwargs):
        step, record = orig_step(*args, **kwargs), []
        jax_losses.append(record)

        def run(*a, **k):
            state, loss = step(*a, **k)
            record.append(float(loss))
            return state, loss

        return run

    def recording_reweight(*args):
        out = orig_reweight(*args)
        jax_weights.append(out)
        return out

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jstep, "make_train_step", recording_step)
            mp.setattr(jct, "reweight_adaboost_like", recording_reweight)
            mp.setattr(tcnn, "init_stage", _jax_init)
            jtrainer = jct.CascadeTrainer(jct.SyntheticProvider(N_POS, N_NEG, [12, 24, 48], 1),
                                          seed=0)
            jmodel = jtrainer.train()
            ttrainer = tct.CascadeTrainer(tct.SyntheticProvider(N_POS, N_NEG, [12, 24, 48], 1),
                                          seed=0, device="cpu")
            tmodel = ttrainer.train()
        yield jtrainer, jmodel, jax_losses, jax_weights, ttrainer, tmodel
    finally:
        jlog.set_echo(True)
        tlog.set_echo(True)
        jcf.reset()
        tcf.reset()


def test_loss_histories_match(trained):
    jtrainer, _, jax_losses, _, ttrainer, _ = trained
    assert len(jax_losses) == len(ttrainer.stage_trainers) == 3
    for ref, st in zip(jax_losses, ttrainer.stage_trainers):
        got = st.losses()
        assert len(got) == len(ref) == 10
        np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert [t.f_beta for t in ttrainer.stage_trainers] == [
        t.f_beta for t in jtrainer.stage_trainers]


def test_reweighted_distributions_match(trained):
    jtrainer, _, _, jax_weights, ttrainer, _ = trained
    got = [w[key] for w in ttrainer.weight_history for key in ("train", "valid", "test")]
    assert len(got) == len(jax_weights) == 6
    for g, r in zip(got, jax_weights):
        np.testing.assert_allclose(g, r, rtol=1e-9)
    for key in ("train", "valid", "test"):
        np.testing.assert_allclose(ttrainer._weights[key], jtrainer._weights[key], rtol=1e-9)


def test_final_parameters_match(trained):
    _, jmodel, _, _, _, tmodel = trained
    lr = CFG["learning_rate_init"]
    for jp, tp, jc, tc in zip(jmodel.stage_params, tmodel.stage_params,
                              jmodel.stage_configs, tmodel.stage_configs):
        assert bridge.stage_config_from_jax(jc) == tc
        got = np.concatenate([t.detach().numpy().ravel() for t in tstep.param_leaves(tp)])
        ref = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(jp)])
        diff = np.abs(got - ref)
        outside = diff > 1e-4 + 1e-3 * np.abs(ref)
        assert outside.mean() <= 1e-4, (int(outside.sum()), got.size)
        assert diff.max() <= 10 * lr, float(diff.max())
    for a, b in zip(tmodel.stage_means + tmodel.stage_stds,
                    jmodel.stage_means + jmodel.stage_stds):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_combined_evaluation_matches(trained):
    jtrainer, _, _, _, ttrainer, _ = trained
    assert ttrainer.combined_results == jtrainer.combined_results
    assert ttrainer.combined_results["test"]["accuracy"] > 0.8


def test_trained_cascades_detect_alike(trained):
    _, jmodel, _, _, _, tmodel = trained
    for key, value in CFG.items():
        tcf.set(key, value)
    tcf.set("nms", tcf.NMS_OPENCV)
    tcf.set("nms_opencv_min_neighbors", 0)
    from_jax = bridge.cascade_model_from_jax_arrays(
        jmodel.stage_params, jmodel.stage_configs, jmodel.stage_means, jmodel.stage_stds,
        device="cpu")
    scene = synthetic.make_scene(64, 64, n_faces=1, seed=21, min_face=30, max_face=40)
    caps = [1280, 1280]  # open (1,178 windows): no saturation re-runs
    ref = tcascade.CascadeDetector(from_jax, capacity_schedule=caps).detect(scene.image)
    got = tcascade.CascadeDetector(tmodel, capacity_schedule=caps).detect(scene.image)
    assert ref.n_survivors_per_stage[-1] > 0
    assert_results_close(got, ref)


def test_single_net_trainer_guards(tmp_path):
    """The port trainer's guards: NaN-loss abort, the timeout, rollback to
    the best snapshot after ``restore_after`` stagnant updates, and
    ConstantPredictionException."""
    from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as ttrainer

    for key, value in {**CFG, "conv_filter_sizes": [4], "fc1_size": 8, "batch_size": 16,
                       "epochs_total": 2, "optimizer": 0,
                       "snapshot_dir": str(tmp_path)}.items():
        tcf.set(key, value)
    ds = tct.SyntheticProvider(30, 50, [12], seed=2).dataset(12)

    def run(**settings):
        for key, value in settings.items():
            tcf.set(key, value)
        tlog.log_clear()
        trainer = ttrainer.SingleNetTrainer(ds, seed=0, device="cpu")
        trainer.train()
        return trainer, "\n".join(tlog.log_lines())

    trainer, lines = run(learning_rate_init=1e38)
    assert "loss value is nan" in lines and np.isnan(trainer._last_loss)
    trainer, lines = run(learning_rate_init=0.003, timeout_minutes=1e-9)
    assert "TIMEOUT" in lines and len(trainer.losses()) == 1
    trainer, lines = run(timeout_minutes=0, restore_after=0)
    assert "Step back: restoring best parameters" in lines
    assert trainer.best_val_results is not None

    init = tcnn.init_stage

    def background_only(cfg, generator):
        params = init(cfg, generator)
        params["fc2"]["b"] = torch.tensor([1e3, 0.0])
        return params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcnn, "init_stage", background_only)
        tcf.set("learning_rate_init", 0.0)
        tcf.set("n_max_constant_evals", 1)
        with pytest.raises(ttrainer.ConstantPredictionException, match="background"):
            run(restore_after=None)
