"""The port's Inception trunks against the JAX package on the CPU: the full
InceptionV3 trunk and its weight converter (models/inception_v3.py), the
compact trunk and an Inception stage with bottleneck concat
(models/inception.py, models/cnn.py). Parameters come across from the JAX
trees through models/bridge.py and are never drawn again; inputs are
seeded numpy draws. The trunks run at 63-99 px here (the trunks pool
globally, so any size above the stem's works); 299 px runs on the card
(chip_smoke.py phase 29).
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu.models import cnn as jcnn
from rapidobjectdetectionusingcascadedcnns_tpu.models import inception as jinc
from rapidobjectdetectionusingcascadedcnns_tpu.models import inception_v3 as jv3
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import cnn as tcnn
from rapidobjectdetectionusingcascadedcnns_torch.models import inception as tinc
from rapidobjectdetectionusingcascadedcnns_torch.models import inception_v3 as tv3
from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the JAX package's own bound against torch (tests/test_inception_v3.py)
F32_TOL = dict(atol=5e-4, rtol=1e-3)
# bf16 through InceptionV3's 94 convs: a value of the 2048-wide output (up
# to about 6 here) may differ by a few bf16 ulps (0.03 at 4-8), since
# F.conv2d rounds its accumulator to bf16 before the f32 bias add
V3_BF16_TOL = dict(atol=0.1, rtol=0.05)
# bf16 through the compact trunk's 21 convs and the head
STAGE_BF16_TOL = dict(atol=2e-3, rtol=2e-2)


@pytest.fixture(scope="module")
def v3():
    """The converted fixture state dict, the JAX trunk's outputs on a
    99 px batch in both dtypes, and the port's copy of the trunk."""
    params = jv3.convert_torchvision_state_dict(jv3.random_state_dict(seed=0))
    x = np.random.RandomState(1).rand(2, 99, 99, 3).astype(np.float32) * 2 - 1
    ref = {name: np.asarray(jax.jit(lambda p, a, jd=jd: jv3.apply_v3(p, a, dtype=jd))(
        params, jnp.asarray(x))) for name, (jd, _) in DTYPES.items()}
    return params, x, ref, tinc.backbone_from_numpy({"v3": params}, "cpu")


@pytest.fixture(scope="module")
def compact_stage():
    """A JAX Inception stage (compact trunk, 16 incoming bottleneck
    columns) per dtype, its logits, probs and bottleneck on 63 px input
    and on 2-D embedded rows, and the port's converted stage. The JAX tree
    (HWIO) holds a compact trunk drawn once (the port's draw, in the JAX
    layout) and a Glorot-uniform fc2 from numpy: the JAX init of the trunk
    compiles for 5-7 s on this CPU."""
    x = np.random.RandomState(2).rand(3, 63, 63, 3).astype(np.float32) * 2 - 1
    emb = np.random.RandomState(3).rand(3, 2048).astype(np.float32)
    bn = np.random.RandomState(4).rand(3, 16).astype(np.float32)
    limit = np.sqrt(6.0 / (2048 + 16 + 2))
    params = {
        "backbone": jinc.params_from_flat(tinc.backbone_to_flat(
            tinc.init_backbone(torch.Generator().manual_seed(5)))),
        "fc2": {"W": np.random.RandomState(5).uniform(-limit, limit, (2048 + 16, 2))
                .astype(np.float32), "b": np.full(2, 0.1, np.float32)},
    }
    out = {}
    for name, (jd, _) in DTYPES.items():
        cfg = jcnn.StageConfig(input_size=299, backbone="inception",
                               bottleneck_in_size=16, compute_dtype=jd)
        apply = jax.jit(lambda p, a, e, b, cfg=cfg: (jcnn.apply_stage(p, cfg, a, b),
                                                     jcnn.apply_stage(p, cfg, e, b)))
        image, embedded = apply(params, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(bn))
        ref = {k: {n: np.asarray(v) for n, v in r.items()}
               for k, r in (("image", image), ("embedded", embedded))}
        out[name] = (cfg, jax.tree_util.tree_map(np.asarray, params), ref)
    return x, emb, bn, out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_v3_trunk_matches_jax(v3, dtype):
    """The port's ``apply_v3`` (cuDNN-style NCHW convs over OIHW weights)
    against the JAX trunk through every block family, with the dispatch
    of ``inception.apply_backbone``."""
    params, x, ref, port = v3
    got = tinc.apply_backbone(port, torch.from_numpy(x), dtype=DTYPES[dtype][1])
    assert got.dtype == torch.float32 and got.shape == (2, 2048)
    tol = F32_TOL if dtype == "float32" else V3_BF16_TOL
    np.testing.assert_allclose(got.numpy(), ref[dtype], **tol)


def test_converter_bit_equal_and_archive_round_trip(tmp_path, monkeypatch, capsys):
    """``random_state_dict(3)`` is the same draw in both packages and
    converts to bit-equal arrays; the ``v3/`` archive the port's tool
    (run as a script) writes loads in the JAX package, and the JAX package's archive loads
    in the port as the same trunk."""
    sd = tv3.random_state_dict(3)
    jsd = jv3.random_state_dict(3)
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    got = tv3.convert_torchvision_state_dict(sd)
    ref = jv3.convert_torchvision_state_dict(jsd)
    assert list(got) == list(ref) == list(tv3.conv_table())
    for path in ref:
        for leaf in "Wb":
            assert got[path][leaf].dtype == ref[path][leaf].dtype
            np.testing.assert_array_equal(got[path][leaf], ref[path][leaf], err_msg=path)
    assert tv3.n_params(got) == jv3.n_params(ref)

    src = str(tmp_path / "sd.npz")
    np.savez(src, **sd)
    port_archive = str(tmp_path / "port_v3.npz")
    monkeypatch.setattr(sys, "argv", ["convert_torch_inception.py", src, port_archive])
    runpy.run_path(os.path.join(REPO, "tools", "convert_torch_inception.py"),
                   run_name="__main__")
    assert "converted 94 convs" in capsys.readouterr().out
    jax_loaded = jinc.load_backbone_weights(port_archive)
    jax_archive = str(tmp_path / "jax_v3.npz")
    jv3.save_npz(jax_archive, ref)
    port_loaded = tinc.load_backbone_weights(jax_archive, device="cpu")
    assert tinc.trunk_kind(port_loaded) == "v3"
    flat = tinc.backbone_to_flat(port_loaded)
    with np.load(port_archive) as a, np.load(jax_archive) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(flat)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(flat[k], b[k])
            path, leaf = k.split("/")[1:]
            np.testing.assert_array_equal(np.asarray(jax_loaded["v3"][path][leaf]), b[k])
    # OIHW inside the port: the transposed HWIO weight
    w = port_loaded["v3"]["Conv2d_1a_3x3"]["W"]
    assert w.shape == (32, 3, 3, 3) and w.is_contiguous()


def test_converter_errors_match_jax():
    """A weight of the wrong shape, a module the trunk does not have and a
    missing weight are refused by both converters with the same error."""
    base = tv3.random_state_dict(seed=1)
    bad_shape = dict(base, **{"Conv2d_1a_3x3.conv.weight": np.zeros((32, 3, 5, 5), np.float32)})
    unknown = dict(base, **{"Mystery_8a.conv.weight": np.zeros((1,), np.float32)})
    missing = {k: v for k, v in base.items() if k != "Mixed_7c.branch_pool.bn.bias"}
    for sd, err in ((bad_shape, ValueError), (unknown, ValueError), (missing, KeyError)):
        with pytest.raises(err) as port_err:
            tv3.convert_torchvision_state_dict(sd)
        with pytest.raises(err) as jax_err:
            jv3.convert_torchvision_state_dict(sd)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_compact_stage_matches_jax(compact_stage, dtype):
    """An Inception stage with the compact trunk (TF SAME convs and pools,
    uneven at stride 2 on 63 px) and bottleneck concat, against the JAX
    ``apply_stage``: on images, and on 2-D already-embedded rows (only the
    head runs); the inference pre-cast (``cast_params``) gives the same."""
    x, emb, bn, out = compact_stage
    jcfg, jparams, ref = out[dtype]
    cfg = bridge.stage_config_from_jax(jcfg)
    assert cfg.backbone == "inception" and cfg.bottleneck_out_size == 2048 + 16
    params = bridge.params_from_numpy(jparams, device="cpu")
    assert params["backbone"]["stem"][0]["W"].shape == (32, 3, 3, 3)
    tol = F32_TOL if dtype == "float32" else STAGE_BF16_TOL
    for key, a in (("image", x), ("embedded", emb)):
        got = tcnn.apply_stage(params, cfg, torch.from_numpy(a), torch.from_numpy(bn))
        cast = tcnn.apply_stage(tcnn.cast_params(params, cfg), cfg, torch.from_numpy(a),
                                torch.from_numpy(bn))
        for name in ("logits", "probs", "bottleneck"):
            np.testing.assert_allclose(got[name].numpy(), ref[key][name], **tol,
                                       err_msg="{} {}".format(key, name))
            assert torch.equal(cast[name], got[name])
