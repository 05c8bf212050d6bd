"""Data-parallel training of the port over a 4-shard CPU mesh
(``SingleNetTrainer(mesh=)``, ``CascadeTrainer(mesh=)``,
``train_mesh_devices``) against the port's single-device trainer and the
JAX package's mesh trainer on a JAX ``get_mesh(4)``.

The batches are ragged (a 110-sample split in batches of 48 over 4
shards), so the padded and masked rows take part in every step. Both
packages see the same batches (the seeded iterators are copies) and start
from the same weights: the port's ``init_stage`` is replaced, in this file
only, by the JAX initialization for the key the JAX trainer draws.
Compared: evaluation counts equal; parameters within JAX's own mesh
tolerance, rtol 1e-2 and atol 1e-4 (tests/test_training_mesh.py); the
port's mesh losses within 1e-5 of its single-device ones (f32 sums over
other row groupings).
"""

import os

import jax
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.parallel import mesh as jmesh
from rapidobjectdetectionusingcascadedcnns_tpu.train import cascade_trainer as jct
from rapidobjectdetectionusingcascadedcnns_tpu.train import trainer as jtrainer
from rapidobjectdetectionusingcascadedcnns_tpu.utils import log as jlog
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.apps import train_apps as tapps
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn
from rapidobjectdetectionusingcascadedcnns_torch.parallel import mesh as tmesh
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct
from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as tstep
from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as ttrainer
from rapidobjectdetectionusingcascadedcnns_torch.utils import log as tlog

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)

CPU4 = ("cpu",) * 4
CFG = {
    "conv_filter_sizes": [8], "fc1_size": 32, "batch_size": 48, "max_batch_size": 256,
    "epochs_total": 2, "compute_dtype": "float32", "data_augmentation_online": False,
    "optimizer": 1, "learning_rate_init": 0.003, "dropout_rate": 1.0,
}
COUNT_KEYS = ("true_positives", "false_positives", "true_negatives", "false_negatives")


def _configure(**extra):
    for c in (jcf, tcf):
        for key, value in {**CFG, **extra}.items():
            c.set(key, value)


def _jax_init(cfg, generator):
    """The JAX trainer's initial parameters for the seed the port's trainer
    seeds its init generator with."""
    key = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
    jcfg = jcnn.StageConfig.from_config(cfg.input_size, bottleneck_in_size=cfg.bottleneck_in_size)
    return bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcnn.init_stage(key, jcfg)), "cpu")


def _counts(res):
    return {k: res[k] for k in COUNT_KEYS}


def _assert_params_close(a_leaves, b_leaves):
    for a, b in zip(a_leaves, b_leaves, strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-4)


def _port_leaves(trainer):
    return [t.detach().numpy() for t in tstep.param_leaves(trainer.state.params)]


@pytest.fixture(scope="module")
def trained():
    """The JAX mesh trainer, the port's mesh trainer and the port's
    single-device trainer, each trained on the same ragged corpus from the
    JAX initialization."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual JAX devices")
    _configure()
    jlog.set_echo(False)
    tlog.set_echo(False)
    ds = tct.SyntheticProvider(69, 69, [12], seed=3).dataset(12)
    jds = jct.SyntheticProvider(69, 69, [12], seed=3).dataset(12)
    assert ds.train.n_samples % 48 % 4 != 0  # the last batch pads
    jax_trainer = jtrainer.SingleNetTrainer(jds, f_beta=None, seed=0, mesh=jmesh.get_mesh(4))
    jax_trainer.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcnn, "init_stage", _jax_init)
        mesh = ttrainer.SingleNetTrainer(ds, f_beta=None, seed=0, mesh=CPU4)
        single = ttrainer.SingleNetTrainer(ds, f_beta=None, seed=0, device="cpu")
    mesh.train()
    single.train()
    out = {
        "ds": ds,
        "jax": (_counts(jax_trainer.evaluate_split(jds.valid)),
                jax.tree_util.tree_leaves(jax_trainer.state.params)),
        "mesh": mesh,
        "single": single,
    }
    jcf.reset()
    tcf.reset()
    jlog.set_echo(True)
    tlog.set_echo(True)
    return out


def test_single_net_mesh_matches_one_device_and_jax(trained):
    """Counts, losses and parameters of the mesh trainer against the
    single-device trainer and the JAX mesh trainer; ``predict`` equal."""
    ds, mesh, single = trained["ds"], trained["mesh"], trained["single"]
    _configure()
    assert mesh.mesh == tmesh.Mesh(CPU4)
    res = _counts(mesh.evaluate_split(ds.valid))
    assert res == _counts(single.evaluate_split(ds.valid)) == trained["jax"][0]
    assert len(mesh.losses()) == len(single.losses()) == mesh.iterations_total
    np.testing.assert_allclose(mesh.losses(), single.losses(), rtol=0, atol=1e-5)
    _assert_params_close(_port_leaves(mesh), _port_leaves(single))
    _assert_params_close(_port_leaves(mesh), trained["jax"][1])
    labels_m, probs_m = mesh.predict(ds.test, return_probabilities=True)
    labels_s, probs_s = single.predict(ds.test, return_probabilities=True)
    np.testing.assert_array_equal(labels_m, labels_s)
    np.testing.assert_allclose(probs_m, probs_s, rtol=0, atol=1e-5)


def test_mesh_draws_augmentation_and_dropout_as_one_device():
    """With online augmentation and dropout 0.5, a 4-shard run draws what
    the single-device run of the same seed draws (for the batch's real
    rows, before the split): the same losses and parameters."""
    _configure(data_augmentation_online=True, dropout_rate=0.5, epochs_total=1)
    ds = tct.SyntheticProvider(40, 40, [12], seed=5).dataset(12)
    runs = []
    for kwargs in ({"mesh": CPU4}, {"device": "cpu"}):
        trainer = ttrainer.SingleNetTrainer(ds, f_beta=8.0, seed=2, **kwargs)
        trainer.train()
        runs.append(trainer)
    np.testing.assert_allclose(runs[0].losses(), runs[1].losses(), rtol=0, atol=1e-5)
    _assert_params_close(_port_leaves(runs[0]), _port_leaves(runs[1]))


def test_cascade_trainer_mesh_matches_one_device():
    """The cascade driver (bottleneck hand-off, re-weighting, the combined
    evaluation) over the mesh gives the single-device results."""
    _configure(cascade_n_nets=2, img_width=24, epochs_total=1, max_beta=4,
               n_max_constant_evals=None)
    provider = tct.SyntheticProvider(40, 120, [12, 24], seed=7)
    models = []
    for kwargs in ({"mesh": CPU4}, {"device": "cpu"}):
        trainer = tct.CascadeTrainer(provider, seed=0, **kwargs)
        models.append((trainer.train(), trainer.combined_results))
    (model_m, combined_m), (model_s, combined_s) = models
    assert {k: _counts(v) for k, v in combined_m.items()} == {
        k: _counts(v) for k, v in combined_s.items()}
    for pm, ps in zip(model_m.stage_params, model_s.stage_params, strict=True):
        _assert_params_close([t.numpy() for t in tstep.param_leaves(pm)],
                             [t.numpy() for t in tstep.param_leaves(ps)])


def test_train_mesh_devices_reaches_the_trainers_and_apps(tmp_path):
    """``train_mesh_devices`` gives the trainers (and so the train apps) a
    CPU mesh when the device is the CPU; a device that is not mesh device
    0 and a count the CPU cannot have raise."""
    _configure(epochs_total=1, output_graph_dir=str(tmp_path / "models"),
               collages_dir=str(tmp_path / "collages"), snapshot_dir=str(tmp_path / "snap"),
               summary_dir=str(tmp_path / "summary"))
    provider = tct.SyntheticProvider(24, 24, [12], seed=4)
    ds = provider.dataset(12)
    assert ttrainer.SingleNetTrainer(ds, seed=0, device="cpu").mesh == tmesh.Mesh(["cpu"])
    tcf.set("train_mesh_devices", 2)
    assert ttrainer.SingleNetTrainer(ds, seed=0, device="cpu").mesh == tmesh.Mesh(("cpu",) * 2)
    assert tct.CascadeTrainer(provider, seed=0, device="cpu").mesh.size == 2
    app = tapps.TrainApp(provider=provider, device="cpu")
    assert app.trainer.mesh.size == 2 and os.path.exists(app.exported_path)
    tcf.set("train_mesh_devices", "all")
    with pytest.raises(ValueError, match="count"):
        ttrainer.SingleNetTrainer(ds, seed=0, device="cpu")
    tcf.set("train_mesh_devices", None)
    with pytest.raises((ValueError, RuntimeError)):
        ttrainer.SingleNetTrainer(ds, seed=0, mesh=CPU4, device="cuda:0")
