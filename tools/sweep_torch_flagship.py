#!/usr/bin/env python3
"""Sweep flagship training recipes with the PyTorch port and keep the best
(the port's counterpart of tools/sweep_flagship.py).

Trains several candidate cascades (seed / corpus-size / epoch / trunk
variants) on the card, evaluates each with the benchmark-scene harness
(``train_torch_flagship.evaluate_on_scenes``) at several operating
thresholds, and ranks them by recall at their best feasible point, then by
false positives traded against the stage-0 survivor maximum (the
VGA-throughput lever). A winner that beats the incumbent port flagship
(``artifacts/torch_flagship_eval.json``) is promoted: its checkpoint
(``artifacts/model_torch_flagship_*``), its eval and its recipe
(``artifacts/torch_flagship_overrides.json``, which
tools/train_torch_flagship.py then rebuilds). Every candidate's record
merges into ``artifacts/torch_flagship_sweep.json``. The JAX package's
artifacts (``artifacts/flagship_*``) are never written.

Usage, from the repository root on a machine with a card:

    python3 tools/sweep_torch_flagship.py [candidate names...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import train_torch_flagship as tf_mod

CANDIDATES = [
    # (name, n_pos, n_neg, epochs, seed, config_overrides)
    ("base-s0", 3000, 24000, 16, 0, {}),
    ("big-s0", 5000, 40000, 20, 0, {}),
    ("big-s1", 5000, 40000, 20, 1, {}),
    ("huge-s0", 8000, 64000, 24, 0, {}),
    # deeper stage trunks: two conv/pool blocks per net
    ("deep2-s0", 5000, 40000, 20, 0, {"conv_filter_sizes": [32, 32]}),
    # a 4th (6px) front stage: cheaper early rejection, denser grid
    ("stage4-s0", 5000, 40000, 20, 0, {"cascade_n_nets": 4}),
    # recall-heavier boosting schedule
    ("beta4-s0", 5000, 40000, 20, 0, {"max_beta": 4}),
    # hard-negative bootstrap rounds: deep2 retrained with the mined false
    # positives replicated Nx against the 40k base negatives
    ("deep2-hnm-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes": [32, 32], "_hard_negatives": 8}),
    ("deep2-hnm4-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes": [32, 32], "_hard_negatives": 4}),
    ("deep2-hnm2-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes": [32, 32], "_hard_negatives": 2}),
    # cheaper trunks with the same mined hard negatives
    ("hnm4-s0", 5000, 40000, 20, 0, {"_hard_negatives": 4}),
    ("deep24-hnm4-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes": [24, 24], "_hard_negatives": 4}),
    # pooled trunk: pooling_stride 2 shrinks every fc1 4x
    ("deep2-pool2-hnm4-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes": [32, 32], "pooling_stride": 2, "_hard_negatives": 4}),
    # mixed-width trunk: stage 0 keeps the single-block trunk, stages 1/2
    # the deep2 one
    ("mix32-hnm4-s0", 5000, 40000, 20, 0,
     {"conv_filter_sizes_per_stage": [[32], [32, 32], [32, 32]], "_hard_negatives": 4}),
]

# the quality bar is an OPERATING POINT, not a fixed threshold: a candidate
# is scored by its best recall among thresholds whose false-positive rate
# stays within budget; the chosen threshold ships in the eval artifact
OP_THRESHOLDS = (0.3, 0.5, 0.7, 0.9)
FP_BUDGET = 0.5  # false positives a scene
SWEEP_FILE = "torch_flagship_sweep.json"
OVERRIDES_FILE = "torch_flagship_overrides.json"


def operating_sweep(evaluate, model):
    """Evaluate ``model`` at each operating threshold; returns (points,
    best_feasible), where best_feasible has the most recall (then the
    fewest false positives) within ``FP_BUDGET``, or, when no point is
    feasible, the fewest false positives, so degenerate candidates still
    rank deterministically."""
    points = []
    for t in OP_THRESHOLDS:
        stats = evaluate(model, threshold=t, miss_analysis=False)
        stats["threshold"] = t
        points.append(stats)
    feasible = [p for p in points if p["false_pos_per_scene"] <= FP_BUDGET]
    if feasible:
        best = max(feasible, key=lambda p: (p["recall"], -p["false_pos_per_scene"]))
    else:
        best = min(points, key=lambda p: p["false_pos_per_scene"])
    return points, best


def rank_key(stats):
    """Sort key, smaller first: feasible before infeasible (false positives
    over budget at every threshold), then more recall at the point, then
    false positives traded against the stage-0 survivor maximum (which
    sets the capacity schedule)."""
    point = stats.get("best_feasible", stats)
    infeasible = point["false_pos_per_scene"] > FP_BUDGET
    return (
        infeasible,
        -point["recall"],
        point["false_pos_per_scene"] + point["survivors_max"][0] / 2000.0,
    )


def _write(name, obj):
    with open(os.path.join(tf_mod.ARTIFACT_DIR, name), "w") as f:
        json.dump(obj, f, indent=1)


def main():
    only = set(sys.argv[1:])  # optional candidate-name filter
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint
    from rapidobjectdetectionusingcascadedcnns_torch.utils import log

    log.set_echo(True)
    results = []
    best = None
    for name, n_pos, n_neg, epochs, seed, overrides in CANDIDATES:
        if only and name not in only:
            continue
        cf.reset()
        tf_mod.flagship_config(cf)
        cf.set("epochs_total", epochs)
        recipe = {"hard_negatives": 0, "hard_positives": 0}
        for k, v in overrides.items():
            if k == "_hard_negatives":
                recipe["hard_negatives"] = int(v)
            else:
                cf.set(k, v)
        provider = tf_mod.flagship_provider(n_pos, n_neg, seed, recipe)
        trainer = ct.CascadeTrainer(provider, seed=seed)
        t0 = time.time()
        try:
            model = trainer.train()
        except Exception as exc:  # a degenerate recipe must not end the sweep
            print(f"{name}: FAILED ({exc!r})", flush=True)
            results.append({"candidate": name, "error": repr(exc)})
            continue
        train_secs = time.time() - t0
        points, chosen = operating_sweep(tf_mod.evaluate_on_scenes, model)
        # headline the CHOSEN operating point; keep every point on record
        stats = dict(chosen)
        stats["operating_points"] = [
            {k: v for k, v in p.items() if k != "misses"} for p in points
        ]
        stats["fp_budget"] = FP_BUDGET
        stats["candidate"] = name
        stats["train_secs"] = round(train_secs, 1)
        stats["overrides"] = overrides
        print(f"{name}: " + json.dumps(
            {k: v for k, v in stats.items() if k not in ("misses", "operating_points")}),
            flush=True)
        results.append(stats)
        if best is None or rank_key(stats) < rank_key(best[1]):
            # the FULL recipe, so tools/train_torch_flagship.py rebuilds it
            best = (model, stats, dict(
                overrides, _n_pos=n_pos, _n_neg=n_neg, _epochs=epochs, _seed=seed,
            ))

    # merge this run's candidates into the record (a partial rerun with a
    # name filter extends the record, not erases it)
    sweep_path = os.path.join(tf_mod.ARTIFACT_DIR, SWEEP_FILE)
    prior = {"candidates": [], "winner": None}
    if os.path.exists(sweep_path):
        with open(sweep_path) as f:
            prior = json.load(f)
    names = {r.get("candidate") for r in results}
    merged = [c for c in prior["candidates"] if c.get("candidate") not in names] + results

    if best is None:
        _write(SWEEP_FILE, {"candidates": merged, "winner": prior.get("winner")})
        raise SystemExit(
            "no candidate completed (filter={}); sweep record updated, "
            "incumbent untouched".format(sorted(only) or "none")
        )
    model, stats, win_overrides = best

    # promote only if the run's best beats the incumbent port flagship, each
    # at its headline operating point
    incumbent = tf_mod.load_flagship_quality()
    if incumbent is not None and rank_key(incumbent) <= rank_key(stats):
        print(f"incumbent flagship stays (recall={incumbent['recall']} "
              f"fp={incumbent['false_pos_per_scene']} @thr {incumbent.get('threshold')} "
              f"vs challenger {stats['recall']}/{stats['false_pos_per_scene']} "
              f"@thr {stats.get('threshold')})")
        _write(SWEEP_FILE, {"candidates": merged, "winner": prior.get("winner")})
        return

    checkpoint.save_cascade(tf_mod.ARTIFACT_DIR, tf_mod.SESSION_KEY, model)
    # re-evaluate the winner at its shipped threshold WITH the per-miss
    # analysis for the headline artifact
    headline = tf_mod.evaluate_on_scenes(model, threshold=stats["threshold"], miss_analysis=True)
    for key in ("fp_budget", "operating_points", "train_secs", "overrides"):
        headline[key] = stats[key]
    _write(tf_mod.EVAL_FILE, headline)
    _write(SWEEP_FILE, {"candidates": merged, "winner": stats["candidate"]})
    _write(OVERRIDES_FILE, win_overrides)
    print(f"winner: {stats['candidate']} recall={stats['recall']} "
          f"fp/scene={stats['false_pos_per_scene']} "
          f"survivors_max={stats['survivors_max']} "
          f"grid_limited_misses={headline.get('misses_grid_limited')}")


if __name__ == "__main__":
    main()
