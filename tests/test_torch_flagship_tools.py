"""Port vs JAX: the flagship, mining and sweep tools.

A tiny cascade (conv [4], fc1 8, f32) is built by the JAX package and its
weights go through the port's bridge, so both tools run the same weights
on the same 2 scenes (survivor buffers fixed at [2048, 2048], above every
survivor count, so no frame is re-dispatched):

  * ``apply_recorded_overrides`` and ``capacity_schedule_from_quality``
    equal the JAX tool's (recipe, config, capacities);
  * ``evaluate_on_scenes`` at threshold 0.32 and min_neighbors 0 (recall
    0.5: three missed faces, one dying at stage 0 and two lost to NMS)
    equals the JAX tool's stats: counts, survivors and each miss record,
    its stage probe included; the probe's probabilities, rounded to 3
    decimals by both tools, within 1.5e-3 (one rounding step and f32
    noise), its counts and stage of death equal;
  * the mining tools give the same patches, bit for bit;
  * the sweep's ``operating_sweep`` chooses and its ``rank_key`` orders
    candidates as the JAX sweep does.

The JAX references are computed once for the module: the evaluation (the
longest, its stage probes run eagerly) in a process of its own
(``torch_parity.Reference``) started with the module's first test, the
mining here; the mining tests come first, so that both packages' mining
and the port's evaluation overlap the JAX evaluation.
"""

import copy
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf

import torch_parity as tp
from torch_parity import configure, jax_and_port_models, reset_port_config  # noqa: F401

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import mine_hard_negatives as jneg  # noqa: E402
import mine_hard_positives as jpos  # noqa: E402
import mine_torch_hard_negatives as tneg  # noqa: E402
import mine_torch_hard_positives as tpos  # noqa: E402
import sweep_torch_flagship as tsweep  # noqa: E402
import train_flagship as jtool  # noqa: E402
import train_torch_flagship as ttool  # noqa: E402

CFG = {"conv_filter_sizes": [4], "fc1_size": 8, "cascade_capacity_schedule": [2048, 2048]}
THRESHOLD = 0.32
N_SCENES = 2
PROBE_TOL = 1.5e-3


def _jax_sweep(monkeypatch, tmp_path):
    """The JAX sweep module, loaded without its jit-cache set-up (which
    would write a cache directory and turn on JAX's persistent cache for
    the rest of the process)."""
    import jax

    monkeypatch.setenv("RODC_JIT_CACHE", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *args: None)
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_flagship", os.path.join(TOOLS, "sweep_flagship.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def models():
    configure(**CFG)
    return jax_and_port_models(seed=0)


def _jax_evaluation():
    """The JAX tool's evaluation of the JAX cascade, from both
    configurations' defaults (run by ``torch_parity.Reference``)."""
    configure(**CFG)
    return jtool.evaluate_on_scenes(jax_and_port_models(seed=0)[0], n_scenes=N_SCENES,
                                    threshold=THRESHOLD, min_neighbors=0, miss_analysis=True)


@pytest.fixture(scope="module", autouse=True)
def jax_evaluation(tmp_path_factory):
    """Starts the JAX evaluation with the module's first test; yields a
    function that waits for it."""
    job = tp.Reference(tmp_path_factory.mktemp("jax_reference"), "test_torch_flagship_tools",
                       "_jax_evaluation")
    yield job.result
    job.close()


def test_recipe_and_capacities_match_jax():
    """The recorded recipe sets the same config and recipe in both tools;
    the capacity policy gives the same schedules ([512, 128] for the JAX
    flagship's recorded maxima [273, 76, 59])."""
    recipes = []
    for tool, cf in ((jtool, jcf), (ttool, tcf)):
        tool.flagship_config(cf)
        recipes.append((tool.apply_recorded_overrides(cf),
                        {k: cf.get(k) for k in ("conv_filter_sizes", "fc1_size", "max_beta",
                                                "min_beta", "epochs_total", "batch_size",
                                                "dao_crop_probability", "cascade_n_nets")}))
    assert recipes[0] == recipes[1]
    assert recipes[1][0] == {"hard_negatives": 4, "hard_positives": 4, "n_pos": 5000,
                             "n_neg": 40000, "seed": 0}
    for maxima in ([273, 76, 59], [0, 0, 0], [85, 86, 1], [5061, 4096, 10], [128, 127, 3]):
        quality = {"survivors_max": maxima}
        assert (ttool.capacity_schedule_from_quality(quality)
                == jtool.capacity_schedule_from_quality(quality))
    assert ttool.capacity_schedule_from_quality({"survivors_max": [273, 76, 59]}) == [512, 128]


@pytest.mark.parametrize("kind", ["negatives", "positives"])
def test_mining_matches_jax(models, kind):
    configure(**CFG)
    if kind == "negatives":
        got = tneg.mine(models[1], n_scenes=N_SCENES, threshold=THRESHOLD)
        ref = jneg.mine(models[0], n_scenes=N_SCENES, threshold=THRESHOLD)
        assert tneg.MINE_SEED0 == jneg.MINE_SEED0 == 5000
        assert (tneg.MAX_PER_SCENE, tneg.IOU_NEG_MAX) == (jneg.MAX_PER_SCENE, jneg.IOU_NEG_MAX)
    else:
        got, n_missed = tpos.mine(models[1], n_scenes=N_SCENES, threshold=THRESHOLD)
        ref, ref_missed = jpos.mine(models[0], n_scenes=N_SCENES, threshold=THRESHOLD)
        assert n_missed == ref_missed > 0
        assert tpos.MINE_SEED0 == jpos.MINE_SEED0 == 20000
        assert tpos.IOU_DETECTED == jpos.IOU_DETECTED
    assert got.shape == ref.shape and got.shape[0] > 0 and got.shape[1:] == (48, 48, 3)
    np.testing.assert_array_equal(got, ref)


def _assert_probe_close(got, ref):
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if key.startswith("p") and "_max_" in key and value is not None:
            assert abs(got[key] - value) <= PROBE_TOL, (key, got[key], value)
        else:
            assert got[key] == value, key


def test_evaluate_on_scenes_matches_jax(models, jax_evaluation):
    configure(**CFG)
    got = ttool.evaluate_on_scenes(models[1], n_scenes=N_SCENES, threshold=THRESHOLD,
                                   min_neighbors=0, miss_analysis=True)
    ref = copy.deepcopy(jax_evaluation())
    got_misses, ref_misses = got.pop("misses"), ref.pop("misses")
    assert got == ref
    assert ref["recall"] == 0.5 and ref["misses_stage0_blind"] == 1
    assert len(got_misses) == len(ref_misses) == 3
    for g, r in zip(got_misses, ref_misses):
        g_probe, r_probe = g.pop("stage_analysis"), r.pop("stage_analysis")
        assert g == r
        _assert_probe_close(g_probe, r_probe)
    assert sorted(str(r["stage_analysis"]["stage_of_death"])
                  for r in jax_evaluation()["misses"]) \
        == ["0", "nms", "nms"]


def test_sweep_ranks_as_jax(monkeypatch, tmp_path):
    """``operating_sweep`` picks the same point and ``rank_key`` sorts the
    same candidates in the same order as the JAX sweep: feasible points
    first, then recall, then false positives traded against the stage-0
    survivor maximum; a candidate with no feasible point ranks by its
    fewest false positives."""
    jsweep = _jax_sweep(monkeypatch, tmp_path)
    assert tsweep.OP_THRESHOLDS == jsweep.OP_THRESHOLDS
    assert tsweep.FP_BUDGET == jsweep.FP_BUDGET
    assert [c[0] for c in tsweep.CANDIDATES] == [c[0] for c in jsweep.CANDIDATES]
    rng = np.random.RandomState(3)
    candidates = []
    for i in range(12):
        curve = {t: {"recall": float(rng.choice([0.9, 0.95, 0.99])),
                     "false_pos_per_scene": float(rng.choice([0.0, 0.3, 0.5, 0.6, 1.2])),
                     "survivors_max": [int(rng.randint(100, 3000)), 50, 40]}
                 for t in tsweep.OP_THRESHOLDS}

        def evaluate(model, threshold, miss_analysis, curve=curve):
            assert not miss_analysis
            return dict(copy.deepcopy(curve[threshold]), threshold=threshold)

        picks = []
        for sweep in (tsweep, jsweep):
            points, best = sweep.operating_sweep(evaluate, None)
            picks.append((points, best))
        assert picks[0] == picks[1]
        candidates.append(dict(picks[0][1], candidate=i))
        candidates.append({"best_feasible": picks[0][1], "candidate": 100 + i})
    order_t = [c["candidate"] for c in sorted(candidates, key=tsweep.rank_key)]
    order_j = [c["candidate"] for c in sorted(candidates, key=jsweep.rank_key)]
    assert order_t == order_j
    assert [tsweep.rank_key(c) for c in candidates] == [jsweep.rank_key(c) for c in candidates]
