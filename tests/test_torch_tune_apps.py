"""The port's TuneSingleApp / TuneCascadeApp sweeps, held to the
cases of tests/test_tune_apps.py (config isolation per session, failure
tolerance, global-best tracking, sweep resume via ``state_path``), plus the
port's own: failed sessions counted with their tracebacks, and a CUDA error
re-raised (simulated here: this host has no card). Sessions are stubbed, so
nothing trains; the results are exact."""

import os

import pytest

from rapidobjectdetectionusingcascadedcnns_tpu import config as jcf
from rapidobjectdetectionusingcascadedcnns_tpu.apps import tune_apps as jtune
from rapidobjectdetectionusingcascadedcnns_torch import config as cf
from rapidobjectdetectionusingcascadedcnns_torch.apps import tune_apps

from torch_parity import reset_port_config  # noqa: F401 (autouse fixture)


class _StubTrainer:
    """Stands in for TrainApp: returns a canned score per dropout value so
    the sweep logic is exercised without training."""

    scores = {0.25: 0.56, 0.75: 0.81, 0.5: 0.61, 1.0: 0.58}
    raise_on = {}
    calls = 0
    config = cf

    def __init__(self, provider=None, run_now=False, device=None):
        pass

    def run(self):
        type(self).calls += 1
        rate = self.config.get("dropout_rate")
        if rate in self.raise_on:
            raise self.raise_on[rate]
        self.final_results = {"valid": {"accuracy": self.scores[rate]}}


class _StubTuneApp(tune_apps.TuneSingleApp):
    trainer_class = _StubTrainer

    def _create_trainer(self):
        return _StubTrainer()


def _setup(raise_on=None):
    cf.set("tuning_main_criteria", "accuracy")
    cf.set("n_repeat_same_session", 1)
    _StubTrainer.calls = 0
    _StubTrainer.raise_on = raise_on or {}


def test_sweep_tracks_global_best_and_restores_config():
    _setup()
    before = cf.get("dropout_rate")
    app = _StubTuneApp(["dropout_rate"], device="cpu")
    assert app.best_score == 0.81
    assert app.best_config_snapshot["dropout_rate"] == 0.75
    # per-session mutations must not leak out of the sweep
    assert cf.get("dropout_rate") == before
    assert _StubTrainer.calls == 4
    assert app.n_sessions == 4 and app.n_failed == 0 and app.failures == []


def test_failed_session_does_not_stop_the_sweep():
    """As in the JAX app; the port also counts the failure and keeps its
    traceback."""
    _setup({0.75: RuntimeError("session blew up")})
    app = _StubTuneApp(["dropout_rate"], device="cpu")
    # the winner crashed, so the next best value wins
    assert app.best_score == 0.61
    assert _StubTrainer.calls == 4
    assert app.n_failed == 1 and "session blew up" in app.failures[0]
    assert "Traceback" in app.failures[0]


def test_sweep_resumes_from_state_path(tmp_path):
    """An interrupted sweep picks up where it left off in a new app."""
    _setup()
    path = str(tmp_path / "sweep.json")
    first = _StubTuneApp(["dropout_rate"], max_sessions=2, state_path=path, device="cpu")
    assert _StubTrainer.calls == 2
    assert os.path.exists(path)
    assert first.best_score == 0.81

    resumed = _StubTuneApp(["dropout_rate"], state_path=path, device="cpu")
    # only the remaining grid values run
    assert _StubTrainer.calls == 2 + 2
    # the kept winner reflects the FULL grid's history
    assert resumed.tuner.best_values["dropout_rate"] == 0.75


def test_cascade_variant_shares_the_sweep():
    _setup()

    class _StubCascadeApp(tune_apps.TuneCascadeApp):
        def _create_trainer(self):
            return _StubTrainer()

    app = _StubCascadeApp(["dropout_rate"], device="cpu")
    assert app.best_score == 0.81
    assert tune_apps.TuneCascadeApp.trainer_class.__name__ == "TrainCascadeApp"


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("K1 launch failed: cudaError 700"),
], ids=["cuda-runtime", "kernel-launch"])
def test_cuda_error_is_reraised(error):
    """A CUDA error stops the sweep (the card's context may be unusable),
    with the configuration restored; the JAX app logs it and goes on."""
    _setup({0.5: error})
    before = cf.get("dropout_rate")
    with pytest.raises(RuntimeError, match=str(error)[:20]):
        _StubTuneApp(["dropout_rate"], device="cpu")
    assert _StubTrainer.calls == 3  # 0.25, 0.75, then 0.5 failed
    assert cf.get("dropout_rate") == before

    class _JaxStub(_StubTrainer):
        config = jcf

    class _JaxTuneApp(jtune.TuneSingleApp):
        def _create_trainer(self):
            return _JaxStub()

    jcf.set("tuning_main_criteria", "accuracy")
    jcf.set("n_repeat_same_session", 1)
    _JaxStub.calls = 0
    assert _JaxTuneApp(["dropout_rate"]).best_score == 0.81
    assert _JaxStub.calls == 4
