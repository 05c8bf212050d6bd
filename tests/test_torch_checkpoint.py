"""Checkpoints interchange between the port and the JAX package: a stage or
a cascade saved by one loads in the other with equal arrays (exact) and an
equal architecture record."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jckpt
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as tcascade
from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint as tckpt
from rapidobjectdetectionusingcascadedcnns_torch.train import trainer as ttrainer
from rapidobjectdetectionusingcascadedcnns_torch.train.cascade_trainer import (
    SyntheticProvider,
)

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

torch.set_num_threads(2)


def _jax_leaves(params):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port_leaves(params):
    return tckpt._flatten(params)


def _assert_same_stage(port, jax_stage):
    (tp, tcfg, tmean, tstd), (jp, jcfg_, jmean, jstd) = port, jax_stage
    got, ref = _port_leaves(tp), _jax_leaves(jp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert tckpt.stage_config_to_json(tcfg) == jckpt._stage_config_to_json(jcfg_)
    np.testing.assert_array_equal(tmean, jmean)
    np.testing.assert_array_equal(tstd, jstd)


@pytest.fixture(scope="module")
def stages():
    """A bf16 stage with a bottleneck input and an f32 stage with two conv
    layers, as JAX parameters."""
    out = []
    for i, (convs, bneck, dtype) in enumerate(
        [((8,), 16, jnp.bfloat16), ((4, 6), None, jnp.float32)]
    ):
        cfg = jcnn.StageConfig(input_size=12 * (i + 1), conv_filter_sizes=convs, fc1_size=16,
                               bottleneck_in_size=bneck, compute_dtype=dtype)
        rng = np.random.RandomState(i)
        shapes = jax.eval_shape(lambda: jcnn.init_stage(jax.random.PRNGKey(i), cfg))
        params = jax.tree_util.tree_map(
            lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)
        size = cfg.input_size
        out.append((params, cfg, rng.rand(size, size, 3).astype(np.float32),
                    rng.rand(size, size, 3).astype(np.float32) + 1))
    return out


def test_port_stage_loads_in_jax(stages, tmp_path):
    for i, (params, jcfg_, mean, std) in enumerate(stages):
        tparams = bridge.params_from_numpy(params, "cpu")
        tcfg = bridge.stage_config_from_jax(jcfg_)
        path = tckpt.save_stage(str(tmp_path / "stage{}".format(i)), tparams, tcfg, mean, std,
                                extra_meta={"note": i})
        jp, jcfg_loaded, jmean, jstd, meta = jckpt.load_stage(path)
        assert jcfg_loaded == jcfg_ and meta["note"] == i
        _assert_same_stage((tparams, tcfg, mean, std), (jp, jcfg_loaded, jmean, jstd))
        with open(path[:-4] + ".json") as f:
            assert json.load(f)["stage_config"] == jckpt._stage_config_to_json(jcfg_)


def test_jax_stage_loads_in_port(stages, tmp_path):
    for i, (params, jcfg_, mean, std) in enumerate(stages):
        path = jckpt.save_stage(str(tmp_path / "stage{}".format(i)), params, jcfg_, mean, std)
        tparams, tcfg, tmean, tstd, _ = bridge.load_stage(path, device="cpu")
        assert tcfg == bridge.stage_config_from_jax(jcfg_)
        _assert_same_stage((tparams, tcfg, tmean, tstd), (params, jcfg_, mean, std))


def test_cascades_interchange(tmp_path):
    """A JAX cascade saved, loaded by the port, saved again by the port and
    loaded by the JAX package: every stage unchanged both ways."""
    for cf in (jcf, tcf):
        cf.set("conv_filter_sizes", [4])
        cf.set("fc1_size", 8)
    jmodel = jcascade.build_cascade_model(seed=0)
    jckpt.save_cascade(str(tmp_path / "a"), "k", jmodel)
    tmodel = bridge.load_cascade(str(tmp_path / "a"), "k", device="cpu")
    assert isinstance(tmodel, tcascade.CascadeModel) and tmodel.n_nets == jmodel.n_nets
    paths = tckpt.save_cascade(str(tmp_path / "b"), "k", tmodel)
    assert len(paths) == 3
    back = jckpt.load_cascade(str(tmp_path / "b"), "k")
    for i in range(3):
        _assert_same_stage(
            (tmodel.stage_params[i], tmodel.stage_configs[i], tmodel.stage_means[i],
             tmodel.stage_stds[i]),
            (back.stage_params[i], back.stage_configs[i], back.stage_means[i],
             back.stage_stds[i]))
        _assert_same_stage(
            (tmodel.stage_params[i], tmodel.stage_configs[i], tmodel.stage_means[i],
             tmodel.stage_stds[i]),
            (jmodel.stage_params[i], jmodel.stage_configs[i], jmodel.stage_means[i],
             jmodel.stage_stds[i]))
    with pytest.raises(FileNotFoundError):
        bridge.load_cascade(str(tmp_path / "b"), "missing", device="cpu")


def test_trainer_snapshot_export_and_resume(tmp_path):
    """A port trainer's best snapshot and exported stage load in the JAX
    package; a new port trainer resumes from the exported stage."""
    for key, value in {"conv_filter_sizes": [8], "fc1_size": 32, "batch_size": 64,
                       "max_batch_size": 256, "epochs_total": 1, "compute_dtype": "float32",
                       "data_augmentation_online": False, "dropout_rate": 1.0,
                       "snapshot_dir": str(tmp_path / "snap")}.items():
        tcf.set(key, value)
    ds = SyntheticProvider(40, 60, [12], seed=4).dataset(12)
    trainer = ttrainer.SingleNetTrainer(ds, seed=0, device="cpu")
    trainer.train()
    snaps = sorted((tmp_path / "snap").rglob("*.npz"))
    assert snaps, "no best snapshot written"
    jp, jcfg_, jmean, jstd, meta = jckpt.load_stage(str(snaps[-1]))
    assert "val_results" in meta and jcfg_.input_size == 12
    path = trainer.export(str(tmp_path / "models"), "s")
    jp, jcfg_, jmean, jstd, _ = jckpt.load_single(str(tmp_path / "models"), "s")
    mean, std = trainer.mean_std()
    _assert_same_stage((trainer.state.params, trainer.stage_config, mean, std),
                       (jp, jcfg_, jmean, jstd))
    resumed = ttrainer.SingleNetTrainer(ds, seed=0, snapshot_full_path=path, device="cpu")
    for a, b in zip(_port_leaves(resumed.state.params).values(),
                    _port_leaves(trainer.state.params).values()):
        np.testing.assert_array_equal(a, b)
