"""Port vs JAX: the cascade-stage CNN and the weight bridge.

The same numpy inputs and the same JAX-initialized parameters (converted,
never re-drawn) go through ``cnn.apply_stage`` of both packages.
Tolerances: f32 probabilities 1e-5 (both sides run true f32 on the CPU;
only summation order differs); bf16 probabilities 2e-2 (bf16 keeps ~3
significant digits and the two frameworks round at the same points but
accumulate in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.models import cascade as jcascade
from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn

torch.set_num_threads(2)

N = 7
BNECK = 10
PROB_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _jax_stage(dtype, filters, pool_stride, bottleneck, size=12):
    cfg = jcnn.StageConfig(
        input_size=size,
        conv_filter_sizes=tuple(filters),
        pooling_stride=pool_stride,
        fc1_size=16,
        bottleneck_in_size=BNECK if bottleneck else None,
        compute_dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16,
    )
    params = jax.tree_util.tree_map(np.asarray, jcnn.init_stage(jax.random.PRNGKey(3), cfg))
    return cfg, params


def _run_both(jcfg, jparams, x, bn):
    ref = jcnn.apply_stage(
        jparams, jcfg, jnp.asarray(x), None if bn is None else jnp.asarray(bn)
    )
    got = tcnn.apply_stage(
        bridge.params_from_numpy(jparams),
        bridge.stage_config_from_jax(jcfg),
        torch.from_numpy(x),
        None if bn is None else torch.from_numpy(bn),
    )
    return ref, got


@pytest.mark.parametrize("pool_stride", [1, 2])
@pytest.mark.parametrize("filters", [[8], [8, 8]])
@pytest.mark.parametrize("bottleneck", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_stage_matches_jax(dtype, bottleneck, filters, pool_stride):
    rng = np.random.RandomState(11)
    jcfg, jparams = _jax_stage(dtype, filters, pool_stride, bottleneck)
    x = rng.standard_normal((N, 12, 12, 3)).astype(np.float32)
    bn = rng.uniform(0, 2, (N, BNECK)).astype(np.float32) if bottleneck else None
    ref, got = _run_both(jcfg, jparams, x, bn)
    assert got["probs"].dtype == torch.float32
    assert tuple(got["bottleneck"].shape) == (N, jcfg.bottleneck_out_size)
    np.testing.assert_allclose(
        got["probs"].numpy(), np.asarray(ref["probs"]), atol=PROB_ATOL[dtype]
    )
    if dtype == "float32":
        np.testing.assert_allclose(
            got["bottleneck"].numpy(), np.asarray(ref["bottleneck"]), atol=1e-4
        )


def test_checkpoint_round_trip(tmp_path):
    """JAX ``save_stage`` -> port ``load_stage``: identical parameters, and
    the standardized forward pass agrees with the JAX one."""
    rng = np.random.RandomState(5)
    jcfg, jparams = _jax_stage("float32", [8], 1, True)
    mean = rng.uniform(100, 150, (12, 12, 3)).astype(np.float32)
    std = rng.uniform(40, 70, (12, 12, 3)).astype(np.float32)
    path = checkpoint.save_stage(str(tmp_path / "stage0"), jparams, jcfg, mean, std)
    params, cfg, mean_t, std_t, meta = bridge.load_stage(path)
    assert cfg == bridge.stage_config_from_jax(jcfg)
    assert "stage_config" in meta
    np.testing.assert_array_equal(mean_t, mean)
    np.testing.assert_array_equal(std_t, std)
    np.testing.assert_array_equal(params["fc1"]["W"].numpy(), jparams["fc1"]["W"])
    img = rng.uniform(0, 255, (N, 12, 12, 3)).astype(np.float32)
    bn = rng.uniform(0, 2, (N, BNECK)).astype(np.float32)
    x = (img - mean) / std
    ref = jcnn.apply_stage(jparams, jcfg, jnp.asarray(x), jnp.asarray(bn))
    got = tcnn.apply_stage(
        params,
        cfg,
        (torch.from_numpy(img) - torch.from_numpy(mean_t)) / torch.from_numpy(std_t),
        torch.from_numpy(bn),
    )
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]), atol=1e-5)


def test_load_cascade_round_trip(tmp_path):
    """JAX ``save_cascade`` -> port ``load_cascade``: same stages, configs,
    standardization stats and bottleneck chaining."""
    from rapidobjectdetectionusingcascadedcnns_tpu import config as cf

    cf.set("conv_filter_sizes", [8])
    cf.set("fc1_size", 16)
    cf.set("compute_dtype", "float32")
    jmodel = jcascade.build_cascade_model(seed=1)
    checkpoint.save_cascade(str(tmp_path), "sess", jmodel)
    tmodel = bridge.load_cascade(str(tmp_path), "sess")
    assert tmodel.n_nets == jmodel.n_nets == 3
    assert tmodel.input_sizes == [12, 24, 48]
    for i in range(3):
        assert tmodel.stage_configs[i] == bridge.stage_config_from_jax(jmodel.stage_configs[i])
        np.testing.assert_array_equal(tmodel.stage_means[i], jmodel.stage_means[i])
        np.testing.assert_array_equal(
            tmodel.stage_params[i]["fc2"]["W"].numpy(),
            np.asarray(jmodel.stage_params[i]["fc2"]["W"]),
        )
    with pytest.raises(FileNotFoundError):
        bridge.load_cascade(str(tmp_path), "missing")


def test_init_stage_shapes_and_seed():
    """The port's own init: JAX shapes, Glorot bounds, zero biases, and the
    same weights from the same generator seed."""
    cfg = tcnn.StageConfig(input_size=24, conv_filter_sizes=(8,), fc1_size=16,
                           bottleneck_in_size=BNECK, compute_dtype=torch.float32)
    p1 = tcnn.init_stage(cfg, torch.Generator().manual_seed(4))
    p2 = tcnn.init_stage(cfg, torch.Generator().manual_seed(4))
    assert tuple(p1["conv"][0]["W"].shape) == (3, 3, 3, 8)
    assert tuple(p1["fc1"]["W"].shape) == (24 * 24 * 8, 16)
    assert tuple(p1["fc2"]["W"].shape) == (16 + BNECK, 2)
    limit = np.sqrt(6.0 / (24 * 24 * 8 + 16))
    assert float(p1["fc1"]["W"].abs().max()) <= limit
    assert float(p1["fc1"]["b"].abs().max()) == 0.0
    torch.testing.assert_close(p1["fc1"]["W"], p2["fc1"]["W"], rtol=0, atol=0)
