#!/usr/bin/env python3
"""Record an end-to-end random-tuning session of the port:
artifacts/torch_tuning_random.json (the port's counterpart of
tools/tune_session.py).

Runs the port's ``TuneCascadeApp(random=True)`` — the reference's
run_tune_cascade.py + app/tune_single_app.py:42-167 flow — for N full
cascade-training sessions on the card over the synthetic mixed corpus,
drawing each session's configuration from the reference's value grids
(train/tuner.py), and writes every session's drawn configuration,
validation metrics and seconds, the winner, the failed sessions and the
card's ``nvidia-smi`` name and power limit.

Param keys: the run_tune_cascade.py defaults minus ``cascade_n_nets``, as
tools/tune_session.py chose (that grid reaches 15 nets, which halve a 48 px
input below 1 px); the corpus stays at the 2-stage 12/24 px geometry so
that the sessions are comparable.

Usage, from the repository root on a machine with a card:

    python3 tools/tune_torch_session.py [--sessions 4] [--n-pos 300]
        [--n-neg 900] [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARTIFACT_DIR = os.path.join(REPO, "artifacts")
OUT_FILE = "torch_tuning_random.json"

PARAM_KEYS = [
    "learning_rate_init",
    "batch_size",
    "max_beta",
    "min_beta",
    "fc1_size",
    "conv_filter_sizes",
]


def session_config(cf) -> None:
    """tools/tune_session.py's small-but-real training budget a session."""
    cf.set("cascade_n_nets", 2)
    cf.set("img_width", 24)
    cf.set("epochs_total", 3)
    cf.set("n_max_constant_evals", None)
    cf.set("data_augmentation_online", False)
    cf.set("seed", 11)


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def run_session(sessions: int, n_pos: int, n_neg: int, device, state_path=None):
    """The tune app over the mixed corpus; returns (app, seconds a session,
    corpus seconds, wall)."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.apps import train_apps
    from rapidobjectdetectionusingcascadedcnns_torch.apps.tune_apps import TuneCascadeApp
    from rapidobjectdetectionusingcascadedcnns_torch.train.cascade_trainer import (
        SyntheticProvider,
    )

    session_config(cf)
    t0 = time.perf_counter()
    provider = SyntheticProvider(n_pos, n_neg, [12, 24], seed=9, source="mixed")
    corpus_s = time.perf_counter() - t0

    seconds = []
    real_run = train_apps.TrainCascadeApp.run

    def timed_run(self):
        start = time.perf_counter()
        try:
            return real_run(self)
        finally:
            seconds.append(time.perf_counter() - start)

    train_apps.TrainCascadeApp.run = timed_run
    try:
        t0 = time.perf_counter()
        app = TuneCascadeApp(PARAM_KEYS, random=True, max_sessions=sessions, provider=provider,
                             state_path=state_path, device=device)
        wall = time.perf_counter() - t0
    finally:
        train_apps.TrainCascadeApp.run = real_run
    return app, seconds, corpus_s, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--n-pos", type=int, default=300)
    ap.add_argument("--n-neg", type=int, default=900)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    log.set_echo(True)
    device = resolve_device(args.device)
    app, seconds, corpus_s, wall = run_session(args.sessions, args.n_pos, args.n_neg, device)
    tuner = app.tuner
    record = {
        "experiment": "random hyper-parameter sweep via the port's TuneCascadeApp "
                      "(reference run_tune_cascade.py + app/tune_single_app.py:42-167)",
        "param_keys": PARAM_KEYS,
        "n_sessions": app.n_sessions,
        "n_failed": app.n_failed,
        "failures": [f.strip().splitlines()[-1] for f in app.failures],
        "corpus": {"n_pos": args.n_pos, "n_neg": args.n_neg, "sizes": [12, 24],
                   "source": "mixed", "host_secs": corpus_s},
        "epochs_per_session": cf.get("epochs_total"),
        "tuning_main_criteria": cf.get("tuning_main_criteria"),
        "device": str(device),
        "card": card_line(device),
        "wall_secs": wall,
        "secs_per_session": seconds,
        "sessions": [
            {
                "config": r["config"],
                "score": None if r["score"] == float("-inf") else r["score"],
                "valid_metrics": {k: v for k, v in r["results"].items()
                                  if isinstance(v, (int, float))},
            }
            for r in tuner.results
        ],
        "best": ({"config": tuner.best["config"], "score": tuner.best["score"]}
                 if tuner.best is not None else None),
        "global_best_score": None if app.best_score == float("-inf") else app.best_score,
    }
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    dst = os.path.join(ARTIFACT_DIR, OUT_FILE)
    with open(dst, "w") as f:
        json.dump(record, f, indent=1)
    print("wrote", dst)
    print(json.dumps({"n_sessions": record["n_sessions"], "n_failed": record["n_failed"],
                      "best": record["best"], "secs_per_session": seconds,
                      "card": record["card"]}))


if __name__ == "__main__":
    main()
