"""Hyper-parameter tuning: predefined value grids, random and successive
search (the port's copy of the JAX package's ``train/tuner.py``; host
logic only, on the port's ``config``).

Re-design of the reference tuners (network/hyper_tuner.py,
hyper_tuner_random.py, hyper_tuner_successive.py):
  * the same ~25-parameter value grids (hyper_tuner.py:65-142);
  * cross-parameter consistency overrides (momentum forces the Momentum
    optimizer, dao_* options enable online augmentation;
    hyper_tuner.py:172-199);
  * :class:`HyperTunerRandom` samples one full random configuration per
    round and reports the best (hyper_tuner_random.py:36-79); with the same
    seed it draws the JAX tuner's configurations (``random.Random``);
  * :class:`HyperTunerSuccessive` sweeps one parameter at a time, keeping a
    prior value only when its best result clears a minimum validation
    accuracy (hyper_tuner_successive.py:96-125).

Configuration changes go through ``cf.set`` against the process-global
config; callers snapshot/restore around sessions (config.snapshot/restore).
The tune apps (``apps/tune_apps.py``) drive them over training sessions,
and ``tools/tune_torch_session.py`` records such a sweep.
"""

from __future__ import annotations

import abc
import json
import os
import random
from typing import Any, Dict, List, Optional

from .. import config as cf
from ..utils import log

MIN_VAL_ACCURACY_TO_KEEP = 0.53  # hyper_tuner_successive.py:96-125


def value_grids() -> Dict[str, List[Any]]:
    """Predefined value sets per tunable parameter (hyper_tuner.py:65-142)."""
    return {
        "learning_rate_init": [0.00001, 0.0001, 0.001, 0.01, 0.1, 0.5, 0.05, 0.005],
        "batch_size": [128, 256, 400, 500, 600, 1000, 2000, 5000],
        "learning_rate_decay": [0.5, 0.7, 0.9, 0.95, 0.99, 1],
        "momentum": [0, 0.25, 0.5, 0.72, 1],
        "dropout_rate": [0.25, 0.75, 0.5, 1.0],
        "optimizer": [1, 0, 2],
        "standardization": [True, False],
        "fc1_size": [16, 32, 64, 128, 256, 512],
        "L2_regularization_strength": [1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
        "L1_regularization_strength": [1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
        "cascade_n_nets": [3, 4, 5, 6, 7, 10, 15],
        "f_beta_cascade_loss_very_last": [True, False],
        "min_beta": [0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
        "max_beta": [16, 20, 24, 28, 32, 36, 48],
        "pooling_size": [2, 3],
        "pooling_stride": [1, 2, 3],
        "conv_stride": [1, 2, 3],
        "conv_filter_size": [2, 3, 4, 5, 6],
        "conv_filter_sizes": [
            [6], [9], [32], [64], [128],
            [6, 6], [9, 9], [32, 32], [64, 64], [32, 64], [64, 32], [128, 128],
            [6, 6, 6], [32, 32, 32], [3, 6, 9], [9, 6, 3], [9, 9, 9],
            [6, 6, 6], [12, 12, 12],
        ],
        "data_augmentation_online": [True, False],
        "dao_horizontal_flip": [True, False],
        "dao_vertical_flip": [True, False],
        "dao_max_rotation_angle": [
            0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 45.0, 60.0, 90.0,
            120.0, 180.0,
        ],
        "dao_max_foreground_rotation_angle": [
            0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 45.0,
        ],
        "dao_crop_probability": [0.25, 0.5, 0.75, 0.9],
        "dao_crop_min_percent": [0.75, 0.8, 0.85, 0.9, 0.95],
        "dao_color_distortion": [True, False],
        "dao_color_distortion_fast_mode": [True, False],
    }


def _jsonify(value: Any) -> Any:
    """JSON-shape of a value (tuples -> lists, recursively) for comparing a
    round-tripped value against its original grid object."""
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


class HyperTuner(abc.ABC):
    """Base tuner over a subset of the value grids."""

    def __init__(self, param_keys: Optional[List[str]] = None):
        self.grids = value_grids()
        self.param_keys = []
        for key in param_keys or []:
            if key in self.grids:
                self.param_keys.append(key)
            else:
                log.log(
                    "Error: Can't tune parameter {}, because of missing "
                    "preconfiguration.".format(key)
                )
        self._iter_total = 0
        self._required_iterations = sum(len(self.grids[k]) for k in self.param_keys)

    @abc.abstractmethod
    def _get_next_changes(self) -> None:
        ...

    @abc.abstractmethod
    def _apply_current_settings(self) -> None:
        ...

    @abc.abstractmethod
    def receive_results(self, latest_results: Dict[str, float]) -> None:
        ...

    @abc.abstractmethod
    def log_best_values(self) -> None:
        ...

    def required_iterations(self) -> int:
        return self._required_iterations

    @property
    def finished(self) -> bool:
        return self._iter_total > self.required_iterations()

    def tune(self, repeat_last_one: bool = False) -> None:
        if not repeat_last_one:
            self._get_next_changes()
            self._iter_total += 1
        if not self.finished:
            log.log("HYPER TUNING")
            log.log(
                " - iteration {}/{} in total".format(
                    self._iter_total, self.required_iterations()
                )
            )
            self._apply_current_settings()

    def finalize(self) -> None:
        if not self.finished:
            self._iter_total = self.required_iterations() + 1
        log.log("Hypertuning disabled")

    # -- persistence (survives interrupted sweeps across sessions) --------
    # The reference tuner lives and dies with one process; long sweeps on
    # shared accelerators need resume, so tuners serialize their full
    # position + results to JSON.

    def state_dict(self) -> Dict[str, Any]:
        return {
            "kind": type(self).__name__,
            "param_keys": list(self.param_keys),
            "iter_total": self._iter_total,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != type(self).__name__:
            raise ValueError(
                "tuner state is for {}, not {}".format(
                    state.get("kind"), type(self).__name__
                )
            )
        if state.get("param_keys") != list(self.param_keys):
            raise ValueError("tuner state covers different param_keys")
        self._iter_total = int(state["iter_total"])

    def save_state(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state_dict(), f, indent=1)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        with open(path) as f:
            self.load_state_dict(json.load(f))

    def canonicalize_value(self, key: str, value: Any) -> Any:
        """Map a JSON-round-tripped value back to its original grid object so
        a resumed sweep re-applies the value with the exact type the original
        run used (JSON turns tuples into lists silently)."""
        for gv in self.grids.get(key, ()):
            if gv == value or _jsonify(gv) == _jsonify(value):
                return gv
        return value

    @staticmethod
    def override_configuration_entry(cf_key: str, value: Any) -> None:
        """cf.set with the reference's consistency side effects
        (hyper_tuner.py:172-199)."""
        cf.set(cf_key, value)
        if cf_key == "momentum":
            log.log("Automatically overriding the optimizer to Momentum (2).")
            cf.set("optimizer", cf.OPTIMIZER_MOMENTUM)
        elif cf_key.startswith("dao_") and not cf.get("data_augmentation_online"):
            log.log("Enabling data_augmentation_online to allow tuning subconfigs.")
            cf.set("data_augmentation_online", True)
        if cf_key == "dao_color_distortion_fast_mode" and not cf.get(
            "dao_color_distortion"
        ):
            log.log("Enabling color distortions to tune the associated fast mode.")
            cf.set("dao_color_distortion", True)


class HyperTunerRandom(HyperTuner):
    """One full random configuration per round (hyper_tuner_random.py)."""

    def __init__(self, param_keys=None, seed: Optional[int] = None):
        super().__init__(param_keys)
        self._rng = random.Random(cf.get("seed") if seed is None else seed)
        self._current: Dict[str, Any] = {}
        self.results: List[Dict[str, Any]] = []
        self.best: Optional[Dict[str, Any]] = None

    def _get_next_changes(self) -> None:
        self._current = {
            key: self._rng.choice(self.grids[key]) for key in self.param_keys
        }

    def _apply_current_settings(self) -> None:
        for key, value in self._current.items():
            log.log(" - {} = {}".format(key, value))
            self.override_configuration_entry(key, value)

    def receive_results(self, latest_results: Dict[str, float]) -> None:
        main = cf.get("tuning_main_criteria")
        record = {
            "config": dict(self._current),
            "results": dict(latest_results),
            "score": latest_results.get(main, float("-inf")),
        }
        self.results.append(record)
        if self.best is None or record["score"] > self.best["score"]:
            self.best = record

    def log_best_values(self) -> None:
        if self.best is None:
            log.log("no tuning results yet")
            return
        log.log("best random configuration (score {:.4f}):".format(self.best["score"]))
        for key, value in self.best["config"].items():
            log.log(" - {} = {}".format(key, value))

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        rng_state = self._rng.getstate()
        state.update(
            {
                "rng_state": [rng_state[0], list(rng_state[1]), rng_state[2]],
                "current": self._current,
                "results": self.results,
                "best": self.best,
            }
        )
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        version, internal, gauss = state["rng_state"]
        self._rng.setstate((version, tuple(internal), gauss))
        self._current = {
            k: self.canonicalize_value(k, v) for k, v in state["current"].items()
        }
        self.results = [
            {
                **r,
                "config": {
                    k: self.canonicalize_value(k, v)
                    for k, v in r.get("config", {}).items()
                },
            }
            for r in state["results"]
        ]
        self.best = state["best"]
        if self.best is not None:
            self.best = {
                **self.best,
                "config": {
                    k: self.canonicalize_value(k, v)
                    for k, v in self.best.get("config", {}).items()
                },
            }


class HyperTunerSuccessive(HyperTuner):
    """One parameter at a time, sequential over its grid
    (hyper_tuner_successive.py)."""

    def __init__(self, param_keys=None):
        super().__init__(param_keys)
        self._param_idx = 0
        self._value_idx = -1
        self._scores: Dict[str, List[float]] = {k: [] for k in self.param_keys}
        self.best_values: Dict[str, Any] = {}

    @property
    def current_param(self) -> Optional[str]:
        if self._param_idx < len(self.param_keys):
            return self.param_keys[self._param_idx]
        return None

    def _finish_param(self) -> None:
        """Keep the best value for the finished parameter, but only when its
        result clears the minimum accuracy guard
        (hyper_tuner_successive.py:96-125)."""
        key = self.current_param
        scores = self._scores[key]
        if scores:
            best_i = max(range(len(scores)), key=lambda i: scores[i])
            if scores[best_i] >= MIN_VAL_ACCURACY_TO_KEEP:
                self.best_values[key] = self.grids[key][best_i]
                self.override_configuration_entry(key, self.best_values[key])
                log.log(
                    "keeping best value for {}: {}".format(key, self.best_values[key])
                )
            else:
                log.log(
                    "discarding results for {} (best score {:.3f} below "
                    "guard)".format(key, scores[best_i])
                )
        self._param_idx += 1
        self._value_idx = -1

    def _get_next_changes(self) -> None:
        if self.current_param is None:
            return
        self._value_idx += 1
        while (
            self.current_param is not None
            and self._value_idx >= len(self.grids[self.current_param])
        ):
            self._finish_param()
            self._value_idx = 0

    def _apply_current_settings(self) -> None:
        key = self.current_param
        if key is None:
            return
        # re-apply every previously kept winner first: the app resets config
        # between sessions, and the reference restores best values on every
        # application (hyper_tuner_successive.py:57-76 restore_best_values)
        for prev_key, prev_value in self.best_values.items():
            if prev_key != key:
                log.log("Restoring {} to {}.".format(prev_key, prev_value))
                self.override_configuration_entry(prev_key, prev_value)
        value = self.grids[key][self._value_idx]
        log.log(" - {} = {} ({}/{})".format(key, value, self._value_idx + 1, len(self.grids[key])))
        self.override_configuration_entry(key, value)

    def receive_results(self, latest_results: Dict[str, float]) -> None:
        key = self.current_param
        if key is None:
            return
        main = cf.get("tuning_main_criteria")
        self._scores[key].append(latest_results.get(main, float("-inf")))

    def log_best_values(self) -> None:
        log.log("best successive values so far:")
        for key, value in self.best_values.items():
            log.log(" - {} = {}".format(key, value))

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state.update(
            {
                "param_idx": self._param_idx,
                "value_idx": self._value_idx,
                "scores": self._scores,
                "best_values": self.best_values,
            }
        )
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._param_idx = int(state["param_idx"])
        self._value_idx = int(state["value_idx"])
        self._scores = {k: list(v) for k, v in state["scores"].items()}
        self.best_values = {
            k: self.canonicalize_value(k, v)
            for k, v in state["best_values"].items()
        }
        # (kept winners are re-applied by _apply_current_settings each
        # session, mirroring the reference's restore_best_values)
