"""Training a cascade with the appended Inception stage in the port, against
the JAX package on the CPU: tests/test_inception_composition.py's workflow
(a converted InceptionV3 fixture archive as the frozen trunk, embed-once
head training, the combined evaluation, checkpoints), the compact trunk
trained end to end with augmentation, and the provider's on-demand 299 px
rendering. The port's composition runs in a fresh interpreter, which must
load neither jax nor the JAX package; this process holds its outputs
against the JAX package's.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.models import inception as jinc
from rapidobjectdetectionusingcascadedcnns_tpu.models import inception_v3 as jv3
from rapidobjectdetectionusingcascadedcnns_tpu.train import cascade_trainer as jct
from rapidobjectdetectionusingcascadedcnns_tpu.train import checkpoint as jckpt
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
from rapidobjectdetectionusingcascadedcnns_torch.models import inception as tinc
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as tct

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_inception_composition.py's configuration (one custom 12 px stage)
COMPOSITION_CFG = {
    "append_inception": True, "cascade_n_nets": 1, "img_width": 12,
    "conv_filter_sizes": [4], "fc1_size": 8, "epochs_total": 1, "batch_size": 8,
    "n_max_constant_evals": None,
    "data_augmentation_online": True,  # must be turned off for the frozen trunk
}
N_POS, N_NEG = 6, 10

# The port's composition, in a fresh interpreter: train, save, and write
# the embedded splits and what the trainer reports.
CHILD = r"""
import json, sys
import numpy as np
import torch
from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.models import inception
from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct, checkpoint

torch.set_num_threads(2)
archive, out_dir, settings = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
for k, v in settings.items():
    cf.set(k, v)
cf.set("inception_weights_path", archive)
cf.set("summary_dir", out_dir + "/summary")
cf.set("snapshot_dir", out_dir + "/snapshots")
provider = ct.SyntheticProvider({n_pos}, {n_neg}, [12], seed=0, source="patches")
trainer = ct.CascadeTrainer(provider, seed=0, device="cpu")
model = trainer.train()
inc = trainer.stage_trainers[-1]
trunk = model.stage_params[1]["backbone"]
frozen = inception.load_backbone_weights(archive, device="cpu")
np.savez(out_dir + "/embedded.npz", train=inc.ds.train.images, valid=inc.ds.valid.images,
         test=inc.ds.test.images)
checkpoint.save_cascade(out_dir + "/model", "inc", model)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "rapidobjectdetectionusingcascadedcnns_tpu"))
print(json.dumps({{
    "n_nets": model.n_nets,
    "sizes": trainer.sizes,
    "backbone": model.stage_configs[1].backbone,
    "input_size": model.stage_configs[1].input_size,
    "trunk": inception.trunk_kind(trunk),
    "frozen": inc._frozen_trunk,
    "augment": inc._augment is not None,
    "trunk_equal": all(torch.equal(a, b) for a, b in zip(
        inception.backbone_leaves(trunk), inception.backbone_leaves(frozen))),
    "trunk_requires_grad": any(t.requires_grad for t in inception.backbone_leaves(
        inc.state.params["backbone"])),
    "steps": inc.state.step,
    "last_loss": inc._last_loss,
    "fc2_in": model.stage_params[1]["fc2"]["W"].shape[0],
    "bneck0": model.stage_configs[0].bottleneck_out_size,
    "combined": trainer.combined_results,
    "jax_modules": bad,
}}))
""".format(n_pos=N_POS, n_neg=N_NEG)


@pytest.fixture(scope="module")
def composition(tmp_path_factory):
    """The JAX fixture archive (``random_state_dict(3)`` converted), the
    port's composition run on it in a child process, and the JAX trunk's
    bf16 embeddings of the same standardized 299 px splits."""
    tmp = tmp_path_factory.mktemp("inception_composition")
    converted = jv3.convert_torchvision_state_dict(jv3.random_state_dict(seed=3))
    archive = str(tmp / "inception_v3_fixture.npz")
    jv3.save_npz(archive, converted)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, archive, str(tmp), json.dumps(COMPOSITION_CFG)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    # meanwhile, the JAX package's embed pass on the same splits
    # (trainer.py:218-256)
    for k, v in COMPOSITION_CFG.items():
        jcf.set(k, v)
    ds = jct.SyntheticProvider(N_POS, N_NEG, [12], seed=0, source="patches").dataset(299)
    mean = np.broadcast_to(np.asarray(ds.preprocessor.mean_image, np.float32), (299, 299, 3))
    std = np.broadcast_to(np.asarray(ds.preprocessor.std, np.float32), (299, 299, 3))
    embed = jax.jit(lambda u8: jinc.apply_backbone(
        {"v3": converted}, (u8.astype(jnp.float32) - mean) / std))
    # the three splits in one call (one compile of the trunk), then apart
    splits = [ds.split(k).images for k in ("train", "valid", "test")]
    rows = np.asarray(embed(jnp.asarray(np.concatenate(splits))))
    ends = np.cumsum([len(x) for x in splits])
    ref = dict(zip(("train", "valid", "test"), np.split(rows, ends[:-1])))
    jcf.reset()
    stdout, stderr = child.communicate(timeout=600)
    assert child.returncode == 0, stderr[-3000:]
    report = json.loads(stdout.strip().splitlines()[-1])
    return tmp, converted, report, ref, (mean, std)


def test_frozen_v3_trunk_composes_into_cascade(composition):
    """tests/test_inception_composition.py in the port: two stages, the
    second a 299 px InceptionV3 trunk that stays bit-frozen (no gradient),
    online augmentation off for it, the head trained for at least one step
    with a finite loss on 2048-wide embedded rows, fc2 reading 2048 +
    stage 0's bottleneck, and the combined evaluation done; the port's
    calls loaded neither jax nor the JAX package."""
    _, _, report, _, _ = composition
    assert report["jax_modules"] == []
    assert report["n_nets"] == 2 and report["sizes"] == [12, 299]
    assert report["backbone"] == "inception" and report["input_size"] == 299
    assert report["trunk"] == "v3"
    assert report["frozen"] and not report["augment"]
    assert report["trunk_equal"] and not report["trunk_requires_grad"]
    assert report["steps"] >= 1 and np.isfinite(report["last_loss"])
    assert report["fc2_in"] == 2048 + report["bneck0"]
    assert set(report["combined"]) == {"train", "valid", "test"}
    for res in report["combined"].values():
        assert "accuracy" in res


def test_embedded_splits_match_jax(composition):
    """Each split became (N, 2048) float32 rows equal to the JAX trunk's
    bf16 embeddings of the same standardized images: within 1% of the
    largest magnitude plus 2% of each value (bf16 through 94 convs)."""
    tmp, _, _, ref, _ = composition
    with np.load(os.path.join(tmp, "embedded.npz")) as got:
        for k in ("train", "valid", "test"):
            assert got[k].dtype == np.float32 and got[k].shape == (len(ref[k]), 2048)
            np.testing.assert_allclose(got[k], ref[k], rtol=0.02,
                                       atol=0.01 * np.abs(ref[k]).max(), err_msg=k)


def test_composition_checkpoints_cross_read(composition):
    """The port's saved cascade: stage 0 loads in the JAX package; the v3
    stage's file holds exactly the JAX package's leaves for the converted
    trunk (``backbone/v3/...``, HWIO), and the port reads it back as the
    frozen trunk; a stage the JAX package saves with that trunk loads in
    the port. The stage keeps the statistics its trunk embedded with (the
    JAX trainer exports the identity there; ROADMAP Queue C)."""
    tmp, converted, _, _, (mean, std) = composition
    stage0 = os.path.join(tmp, "model", "model_inc_0")
    jparams0, jcfg0, _, _, _ = jckpt.load_stage(stage0)
    assert jcfg0.backbone == "custom" and jcfg0.input_size == 12
    stage1 = os.path.join(tmp, "model", "model_inc_1.npz")
    with np.load(stage1) as z:
        flat = {k: z[k] for k in z.files}
    np.testing.assert_allclose(flat.pop("__mean__"), mean, rtol=1e-6)
    np.testing.assert_allclose(flat.pop("__std__"), std, rtol=1e-6)
    fc2 = {"W": flat["fc2/W"], "b": flat["fc2/b"]}
    ref = jckpt._flatten({"backbone": {"v3": converted}, "fc2": fc2})
    assert sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    params, cfg, _, _, meta = bridge.load_stage(stage1, device="cpu")
    assert cfg.backbone == "inception" and meta["stage_config"]["backbone"] == "inception"
    trunk = tinc.load_backbone_weights(os.path.join(tmp, "inception_v3_fixture.npz"), "cpu")
    for a, b in zip(tinc.backbone_leaves(params["backbone"]), tinc.backbone_leaves(trunk)):
        assert torch.equal(a, b)
    jax_path = str(tmp / "jax_stage")
    jckpt.save_stage(jax_path, {"backbone": {"v3": converted}, "fc2": fc2},
                     jckpt._stage_config_from_json(meta["stage_config"]), mean, std)
    back, _, _, _, _ = bridge.load_stage(jax_path, device="cpu")
    for a, b in zip(tinc.backbone_leaves(back["backbone"]), tinc.backbone_leaves(trunk)):
        assert torch.equal(a, b)
    assert torch.equal(back["fc2"]["W"], params["fc2"]["W"])


def test_compact_trunk_trains_end_to_end():
    """Without a weights path the compact trunk trains with its head,
    augmentation on at 299 px: its leaves move, the loss stays finite;
    ``conv_filter_sizes_per_stage`` counts the custom stages only."""
    for k, v in {**COMPOSITION_CFG, "conv_filter_sizes_per_stage": [[4]]}.items():
        tcf.set(k, v)
    provider = tct.SyntheticProvider(3, 5, [12], seed=1, source="patches")
    trainer = tct.CascadeTrainer(provider, seed=0, device="cpu")
    assert trainer.n_nets == 2 and trainer.sizes == [12, 299]
    model = trainer.train()
    inc = trainer.stage_trainers[-1]
    assert not inc._frozen_trunk and inc._augment is not None
    assert inc.ds.train.images.shape[1:] == (299, 299, 3)
    losses = inc.losses()
    assert len(losses) >= 1 and np.isfinite(losses).all()
    init = tinc.init_backbone(torch.Generator().manual_seed(inc._seed))
    moved = [not torch.equal(a, b) for a, b in zip(
        tinc.backbone_leaves(model.stage_params[1]["backbone"]), tinc.backbone_leaves(init))]
    assert tinc.trunk_kind(model.stage_params[1]["backbone"]) == "compact" and any(moved)
    tcf.set("conv_filter_sizes_per_stage", [])
    with pytest.raises(ValueError, match="one entry per custom cascade stage"):
        tct.CascadeTrainer(provider, seed=0, device="cpu").train()


def test_provider_renders_299_on_demand_like_jax():
    """A size the corpus lacks is rendered from its largest one, the sample
    order kept, bit-equal to the JAX provider's rendering."""
    for cf_mod in (tcf, jcf):
        cf_mod.set("img_width", 24)
    got = tct.SyntheticProvider(3, 4, [12, 24], seed=2).dataset(299)
    ref = jct.SyntheticProvider(3, 4, [12, 24], seed=2).dataset(299)
    jcf.reset()
    assert got.images.shape == (7, 299, 299, 3) and got.images.dtype == np.uint8
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
