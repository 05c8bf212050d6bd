"""The port's hyper-parameter tuners (``train/tuner.py``) against the JAX
package's: the same grids, the same seeded draws and best, the same
keep/drop decisions of the successive sweep, state round trips, the
cross-parameter overrides, and a tuner session that loads no jax."""

import os
import subprocess
import sys

import pytest

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.train import tuner as jtuner
from rapidobjectdetectionusingcascadedcnns_torch import config as tcf
from rapidobjectdetectionusingcascadedcnns_torch.train import tuner as ttuner

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["learning_rate_init", "batch_size", "momentum", "conv_filter_sizes",
        "dao_max_rotation_angle", "dropout_rate"]


def _run(tuner, cf, scores, key="f1_score"):
    """Tune once per score and report it; returns each round's config."""
    cf.set("tuning_main_criteria", key)
    seen = []
    for score in scores:
        tuner.tune()
        seen.append({k: cf.get(k) for k in ("optimizer", "data_augmentation_online",
                                             *tuner.param_keys)})
        tuner.receive_results({key: score})
    tuner.tune()
    return seen


def test_value_grids_equal_jax():
    assert ttuner.value_grids() == jtuner.value_grids()
    assert ttuner.MIN_VAL_ACCURACY_TO_KEEP == jtuner.MIN_VAL_ACCURACY_TO_KEEP


@pytest.mark.parametrize("seed", [0, 7])
def test_random_tuner_draws_as_jax(seed):
    """Seeded, the port's random tuner applies the JAX tuner's
    configurations round for round and keeps the same best."""
    scores = [0.41, 0.77, 0.52, 0.91, 0.60]
    jt = jtuner.HyperTunerRandom(KEYS + ["not_a_param"], seed=seed)
    tt = ttuner.HyperTunerRandom(KEYS + ["not_a_param"], seed=seed)
    assert tt.param_keys == jt.param_keys == KEYS
    assert _run(tt, tcf, scores) == _run(jt, jcf, scores)
    assert tt.best == jt.best and tt.best["score"] == 0.91
    assert tt.results == jt.results
    jcf.reset()


def test_successive_tuner_keeps_and_drops_as_jax():
    """A scripted result sequence: the first parameter's best clears
    ``MIN_VAL_ACCURACY_TO_KEEP`` and is kept, the second's does not and is
    dropped; every round applies the JAX tuner's values."""
    keys = ["dropout_rate", "pooling_size", "conv_stride"]
    scores = [0.55, 0.80, 0.60, 0.58, 0.40, 0.52, 0.54, 0.70, 0.53]
    jt, tt = jtuner.HyperTunerSuccessive(keys), ttuner.HyperTunerSuccessive(keys)
    assert tt.required_iterations() == jt.required_iterations() == 9
    assert _run(tt, tcf, scores, "accuracy") == _run(jt, jcf, scores, "accuracy")
    assert tt.best_values == jt.best_values == {
        "dropout_rate": tt.grids["dropout_rate"][1], "conv_stride": tt.grids["conv_stride"][1]}
    assert tt.finished and jt.finished
    jcf.reset()


def test_state_round_trip(tmp_path):
    """Saved mid-sweep and loaded into fresh tuners, both kinds resume with
    the same position, results and next draws."""
    tcf.set("tuning_main_criteria", "f1_score")
    t = ttuner.HyperTunerRandom(KEYS, seed=3)
    for score in (0.4, 0.9):
        t.tune()
        t.receive_results({"f1_score": score})
    path = str(tmp_path / "random.json")
    t.save_state(path)
    t2 = ttuner.HyperTunerRandom(KEYS, seed=0)
    t2.load_state(path)
    assert t2.best == t.best and t2._current == t._current and t2.results == t.results
    t.tune()
    t2.tune()
    assert t._current == t2._current
    assert isinstance(t2._current["conv_filter_sizes"], list)

    s = ttuner.HyperTunerSuccessive(["dropout_rate", "pooling_size"])
    tcf.set("tuning_main_criteria", "accuracy")
    for score in (0.55, 0.80, 0.60, 0.58):
        s.tune()
        s.receive_results({"accuracy": score})
    s.tune()
    s.save_state(str(tmp_path / "successive.json"))
    s2 = ttuner.HyperTunerSuccessive(["dropout_rate", "pooling_size"])
    s2.load_state(str(tmp_path / "successive.json"))
    assert s2.best_values == s.best_values and s2.current_param == "pooling_size"
    tcf.reset()
    s2._apply_current_settings()
    assert tcf.get("dropout_rate") == s.grids["dropout_rate"][1]
    with pytest.raises(ValueError):
        ttuner.HyperTunerRandom(["dropout_rate", "pooling_size"], seed=0).load_state(
            str(tmp_path / "successive.json"))


def test_overrides():
    """Momentum forces the Momentum optimizer; a ``dao_*`` option enables
    online augmentation, and the fast color mode enables color
    distortion."""
    tcf.set("optimizer", tcf.OPTIMIZER_ADAM)
    ttuner.HyperTuner.override_configuration_entry("momentum", 0.5)
    assert tcf.get("optimizer") == tcf.OPTIMIZER_MOMENTUM and tcf.get("momentum") == 0.5
    tcf.set("data_augmentation_online", False)
    tcf.set("dao_color_distortion", False)
    ttuner.HyperTuner.override_configuration_entry("dao_color_distortion_fast_mode", True)
    assert tcf.get("data_augmentation_online") is True
    assert tcf.get("dao_color_distortion") is True


def test_tuner_session_loads_no_jax():
    """A random and a successive session in a fresh interpreter: neither
    jax nor any module of the JAX package is loaded."""
    code = (
        "import sys\n"
        "from rapidobjectdetectionusingcascadedcnns_torch.train import tuner\n"
        "for t in (tuner.HyperTunerRandom(['dropout_rate', 'momentum'], seed=1),\n"
        "          tuner.HyperTunerSuccessive(['pooling_size'])):\n"
        "    while not t.finished:\n"
        "        t.tune()\n"
        "        t.receive_results({'f1_score': 0.6})\n"
        "    t.log_best_values()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'rapidobjectdetectionusingcascadedcnns_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
