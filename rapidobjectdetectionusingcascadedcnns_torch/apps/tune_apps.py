"""Hyper-parameter tuning applications (counterpart of the JAX package's
``apps/tune_apps.py``).

Re-design of ``TuneSingleApp`` / ``TuneCascadeApp`` (app/tune_single_app.py,
app/tune_cascade_app.py): drive a tuner (train/tuner.py) over training
sessions, track the global best on the main validation criteria, and
survive per-session errors (tune_single_app.py:74-88). Config state is
snapshot/restored per session instead of reloading the config module.

Each session trains on ``device`` (default: the CUDA card; ``"cpu"`` for
the CPU). Deliberate difference from the JAX package, which logs any
session's exception and goes on: a failed session is still isolated, but
counted (``n_failed``, with each traceback in ``failures``), and a CUDA
error (``utils.device.is_cuda_error``) is re-raised, because the card's
context may be unusable after one.
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

from .. import config as cf
from ..train.tuner import HyperTuner, HyperTunerRandom, HyperTunerSuccessive
from ..utils import log
from ..utils.device import is_cuda_error, resolve_device
from .base import BaseApp
from .train_apps import TrainApp, TrainCascadeApp


class TuneSingleApp(BaseApp):
    trainer_class = TrainApp

    def __init__(
        self,
        param_keys: List[str],
        random: bool = False,
        max_sessions: Optional[int] = None,
        provider=None,
        state_path: Optional[str] = None,
        run_now: bool = True,
        device=None,
    ):
        """``state_path``: optional JSON file persisting the sweep position +
        results after every session; when it already exists, the sweep
        RESUMES from it (long sweeps survive process restarts — the
        reference tuner lives and dies with one process)."""
        self.device = resolve_device(device)
        self.tuner: HyperTuner = (
            HyperTunerRandom(param_keys) if random else HyperTunerSuccessive(param_keys)
        )
        self.state_path = state_path
        if state_path and os.path.exists(state_path):
            self.tuner.load_state(state_path)
            log.log("resumed tuner state from {}".format(state_path))
        self.max_sessions = max_sessions
        self.provider = provider
        self.best_score = float("-inf")
        self.best_config_snapshot = None
        self.n_sessions = 0
        self.n_failed = 0
        self.failures: List[str] = []  # the traceback of each failed session
        BaseApp.__init__(self, run_now)

    def _create_trainer(self):
        return self.trainer_class(provider=self.provider, run_now=False, device=self.device)

    def _session_results(self, trainer) -> dict:
        if trainer.final_results is None:
            return {}
        return dict(trainer.final_results.get("valid", {}))

    def _main(self):
        base_snapshot = cf.snapshot()
        limit = self.max_sessions or self.tuner.required_iterations()
        repeats = cf.get("n_repeat_same_session")

        while not self.tuner.finished and self.n_sessions < limit:
            cf.restore(base_snapshot)
            cf.set("session_key", "{}_tune{:03d}".format(
                base_snapshot["session_key"], self.n_sessions
            ))
            self.tuner.tune()
            if self.tuner.finished:
                break

            for _rep in range(max(1, repeats)):
                self.n_sessions += 1
                try:
                    trainer = self._create_trainer()
                    trainer.run()
                    results = self._session_results(trainer)
                    self.tuner.receive_results(results)
                    self._track_global_best(results)
                    if self.state_path:
                        self.tuner.save_state(self.state_path)
                except Exception as exc:
                    if is_cuda_error(exc):
                        cf.restore(base_snapshot)
                        raise
                    # a session whose drawn configuration fails must not stop
                    # the sweep (tune_single_app.py:74-88)
                    self.n_failed += 1
                    self.failures.append(traceback.format_exc())
                    log.log("tuning session failed:\n{}".format(self.failures[-1]))
                if self.n_sessions >= limit:
                    break

        self.tuner.log_best_values()
        log.log("tuning: {} sessions, {} failed".format(self.n_sessions, self.n_failed))
        cf.restore(base_snapshot)

    def _track_global_best(self, results: dict) -> None:
        main = cf.get("tuning_main_criteria")
        score = results.get(main)
        if score is not None and score > self.best_score:
            self.best_score = score
            self.best_config_snapshot = cf.snapshot()
            log.log(
                "new global tuning best: {} = {:.4f}".format(main, score)
            )


class TuneCascadeApp(TuneSingleApp):
    """Same sweep driving cascade training (app/tune_cascade_app.py:5-9)."""

    trainer_class = TrainCascadeApp

    def _session_results(self, trainer) -> dict:
        if not trainer.final_results:
            return {}
        return dict(trainer.final_results.get("valid", {}))
