#!/usr/bin/env python3
"""Train the flagship cascade with the PyTorch port on a CUDA card, then
measure its detection quality and survivor distribution on the benchmark
scenes (the port's counterpart of tools/train_flagship.py).

The flagship is the reference default architecture (12/24/48 px nets,
bottleneck chaining, boosted soft-F-beta stages) with the recorded recipe
of ``artifacts/flagship_overrides.json`` (conv [32, 32], 5,000 faces and
40,000 backgrounds, 20 epochs, seed 0, the committed mined hard examples
replicated x4) on the "mixed" synthetic corpus. A port sweep's promoted
recipe (``artifacts/torch_flagship_overrides.json``, written by
tools/sweep_torch_flagship.py) takes its place where it exists.

Writes under port-only names, never the JAX artifacts that bench.py reads:
the checkpoint ``artifacts/model_torch_flagship_<stage>.npz`` (+ json, the
JAX npz+json format; gitignored, regenerate with this script) and
``artifacts/torch_flagship_eval.json``. The operating point is the most
recall within 0.2 false positives a scene, over thresholds (0.5, 0.4, 0.3)
x min_neighbors (1, 0).

Usage, from the repository root on a machine with a card:

    python3 tools/train_torch_flagship.py [--force] [--mined committed|port]

``--force`` retrains over a cached checkpoint; ``--mined port`` trains on
the port's own mined files (``artifacts/torch_hard_negatives.npz``,
``torch_hard_positives.npz``, from tools/mine_torch_hard_*.py) instead of
the committed JAX ones.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts"
)
SESSION_KEY = "torch_flagship"
EVAL_FILE = "torch_flagship_eval.json"
# the port's promoted sweep recipe first, else the committed JAX recipe
OVERRIDES_FILES = ("torch_flagship_overrides.json", "flagship_overrides.json")
# the committed JAX mining results, or the port's own
MINED_FILES = {
    "committed": ("hard_negatives.npz", "hard_positives.npz"),
    "port": ("torch_hard_negatives.npz", "torch_hard_positives.npz"),
}
FP_BUDGET = 0.2  # false positives a scene at the shipped operating point


def flagship_config(cf):
    """Benchmark configuration: reference default architecture + the training
    recipe that makes synthetic cascades detect (low max_beta so stage 0
    discriminates; positional augmentation so nets fire on neighbouring
    pyramid windows and NMS clusters form)."""
    cf.set("conv_filter_sizes", [32])
    cf.set("fc1_size", 512)
    cf.set("cascade_n_nets", 3)
    cf.set("img_width", 48)
    cf.set("max_beta", 2)
    cf.set("min_beta", 1)
    cf.set("epochs_total", 16)
    cf.set("batch_size", 512)
    cf.set("n_max_constant_evals", None)
    cf.set("data_augmentation_online", True)
    cf.set("dao_crop_probability", 1.0)
    cf.set("dao_crop_min_percent", 0.6)
    cf.set("dao_max_rotation_angle", 10.0)
    cf.set("dao_max_foreground_rotation_angle", 10.0)


def apply_recorded_overrides(cf):
    """Apply the recorded recipe (the first of ``OVERRIDES_FILES`` that
    exists) so this script rebuilds the architecture and recipe the
    recorded numbers describe. Returns a recipe dict: the hard-example
    replication counts plus any recorded corpus/epoch/seed parameters
    (underscore keys)."""
    recipe = {"hard_negatives": 0, "hard_positives": 0}
    for name in OVERRIDES_FILES:
        path = os.path.join(ARTIFACT_DIR, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            overrides = json.load(f)
        for k, v in overrides.items():
            if k == "_hard_negatives":
                recipe["hard_negatives"] = int(v)
            elif k == "_hard_positives":
                recipe["hard_positives"] = int(v)
            elif k in ("_n_pos", "_n_neg", "_seed"):
                recipe[k[1:]] = int(v)
            elif k == "_epochs":
                cf.set("epochs_total", int(v))
            elif not k.startswith("_"):
                cf.set(k, v)
        print(f"applied recorded flagship overrides from {name}: {overrides}")
        break
    return recipe


def load_mined(kind, replication, mined="committed"):
    """The mined ``kind`` ("negatives" or "positives") windows of
    ``MINED_FILES[mined]``, each repeated ``replication`` times, or None
    when none are asked for or the file is absent."""
    if not replication:
        return None
    name = MINED_FILES[mined][0 if kind == "negatives" else 1]
    path = os.path.join(ARTIFACT_DIR, name)
    if not os.path.exists(path):
        print(f"WARNING: the recipe wants hard {kind} but artifacts/{name} is absent "
              "- training without them")
        return None
    with np.load(path) as z:
        images = np.repeat(z["images"], replication, axis=0)
    print(f"{len(images)} hard-{kind[:-1]} samples from {name} (x{replication} replication)")
    return images


def flagship_provider(n_pos, n_neg, seed, recipe, mined="committed"):
    """The recipe's corpus: ``SyntheticProvider(source="mixed")`` with the
    mined hard examples appended."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models.cnn import stage_input_sizes
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct

    sizes = stage_input_sizes(cf.get("cascade_n_nets"), cf.get("img_width"), True)
    # procedural patches + patches sampled from full scenes: the
    # scene-sampled negatives teach stage 0 to reject pyramid windows
    return ct.SyntheticProvider(
        n_pos, n_neg, sizes, seed=seed, source="mixed",
        hard_negatives=load_mined("negatives", recipe["hard_negatives"], mined),
        hard_positives=load_mined("positives", recipe["hard_positives"], mined),
    )


def train_flagship(n_pos=3000, n_neg=24000, seed=0, device=None, mined="committed"):
    """Train the recorded recipe on ``device`` (default: the card) and save
    the checkpoint. Returns (model, trainer, train seconds, corpus
    seconds); the recorded corpus size and seed take the place of the
    arguments."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train import checkpoint

    flagship_config(cf)
    recipe = apply_recorded_overrides(cf)
    n_pos = recipe.get("n_pos", n_pos)
    n_neg = recipe.get("n_neg", n_neg)
    seed = recipe.get("seed", seed)
    t0 = time.time()
    provider = flagship_provider(n_pos, n_neg, seed, recipe, mined)
    corpus_secs = time.time() - t0
    trainer = ct.CascadeTrainer(provider, seed=seed, device=device)
    t0 = time.time()
    model = trainer.train()
    train_secs = time.time() - t0
    paths = checkpoint.save_cascade(ARTIFACT_DIR, SESSION_KEY, model)
    print(f"corpus of {n_pos}/{n_neg} (+ mined) built in {corpus_secs:.1f} s; trained in "
          f"{train_secs:.1f} s; saved {len(paths)} stages to {ARTIFACT_DIR}")
    return model, trainer, train_secs, corpus_secs


def load_flagship(device=None):
    """The cached checkpoint on ``device`` (default: the card), or None
    when absent or incompatible."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge

    try:
        return bridge.load_cascade(ARTIFACT_DIR, SESSION_KEY, device=device)
    except (FileNotFoundError, KeyError, ValueError):
        return None


def load_flagship_quality():
    """The eval artifact (operating threshold, measured survivor maxima,
    quality numbers), or None when absent."""
    path = os.path.join(ARTIFACT_DIR, EVAL_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def capacity_schedule_from_quality(quality):
    """The deployment capacity policy: each survivor buffer sized from the
    trained model's MEASURED per-stage survivor maxima with 1.5x headroom,
    rounded up to a multiple of 128; saturation re-dispatch remains the
    correctness net if a frame exceeds them."""
    return [
        ((int(m * 1.5) + 127) // 128) * 128 for m in quality["survivors_max"][:-1]
    ]


_SCENE_CACHE = {}


def benchmark_scenes(n_scenes=100, seed0=100):
    """Deterministic eval scenes (480x640, 3 faces of 48-120 px), cached:
    scene synthesis is host work, and sweeps evaluate many candidates on
    the same set."""
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic

    key = (n_scenes, seed0)
    if key not in _SCENE_CACHE:
        _SCENE_CACHE[key] = [
            synthetic.make_scene(480, 640, n_faces=3, seed=seed0 + s, min_face=48, max_face=120)
            for s in range(n_scenes)
        ]
    return _SCENE_CACHE[key]


def _miss_stage_probe(detector, image, gt, grid_boxes, plan, boxes_float, thr, iou_floor=0.3):
    """Counterfactual per-stage foreground probabilities of the pyramid
    windows overlapping one missed ground-truth face: WHERE in the cascade
    a missed face dies.

    Stage 0 runs the detector's extraction over the full plan (then selects
    the overlapping rows); stages 1 and 2 re-extract the selected boxes
    with kernel K1 (``crop_and_resize_impl``) and run ``_apply_stage_rows``
    with the bottleneck chaining, as detection does. Every window is scored
    at every stage whether or not an earlier gate would have killed it, so
    the record tells "stage 0 never fires" from "survives stage 0, dies
    later" from "survives all gates, lost to NMS clustering"."""
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.ops import rectangles as rect_ops
    from rapidobjectdetectionusingcascadedcnns_torch.ops.windows import (
        crop_and_resize_impl,
        to_planes_bf16,
    )

    model = detector.model
    win_iou = rect_ops.iou_matrix(grid_boxes, np.asarray(gt, np.float64)[None])[:, 0]
    sel = np.nonzero(win_iou >= iou_floor)[0]
    out = {"n_windows_iou30": int(len(sel))}
    if not len(sel):
        out["stage_of_death"] = "no_overlapping_window"
        return out

    device = detector.device
    image_f = torch.as_tensor(np.asarray(image), device=device).float()[None]
    chunk = int(cf.get("inference_chunk_size"))
    emode = casc.resolve_extraction_mode(plan)
    impl = casc.resolve_resample_impl()
    params = detector._params_device
    stats = detector._stats_device
    cfgs = model.stage_configs
    indices = None
    if emode == "gather":
        indices = detector._level_indices(detector._plan_and_table(*image_f.shape[1:3]))

    probs0, bneck0, ids0, valid0 = casc._stage0_apply(
        image_f, torch.as_tensor(boxes_float, dtype=torch.float32, device=device), plan,
        params[0], cfgs[0], stats[0][0], stats[0][1], chunk, emode, impl, False, indices,
    )
    p0_rows = probs0[0, :, 1].float().cpu().numpy()
    b0_rows = bneck0[0]
    if ids0 is not None:
        ids = ids0[valid0]
        p0 = np.full(plan.n_windows, np.nan)
        p0[ids.cpu().numpy()] = p0_rows[valid0.cpu().numpy()]
        b0 = torch.zeros((plan.n_windows, b0_rows.shape[1]), dtype=b0_rows.dtype, device=device)
        b0[ids] = b0_rows[valid0]
    else:
        p0, b0 = p0_rows, b0_rows
    sel_t = torch.as_tensor(sel, device=device)
    sel_boxes = torch.as_tensor(np.asarray(boxes_float)[sel], dtype=torch.float32,
                                device=device)[None]
    planes = to_planes_bf16(image_f)

    bneck = b0[sel_t]
    stage_probs = [p0[sel]]
    for s in range(1, model.n_nets):
        size = cfgs[s].input_size
        wins = crop_and_resize_impl(image_f, sel_boxes, size, size, False, planes)[0]
        bneck_in = bneck if cfgs[s].bottleneck_in_size is not None else None
        probs_s, bneck = casc._apply_stage_rows(
            params[s], cfgs[s], wins, bneck_in, stats[s][0], stats[s][1], chunk
        )
        stage_probs.append(probs_s[:, 1].float().cpu().numpy())

    alive = np.ones(len(sel), bool)
    stage_of_death = None
    for s, ps in enumerate(stage_probs):
        out[f"p{s}_max_all"] = round(float(np.nanmax(ps)), 3)
        gated = np.where(alive, ps, -np.inf)
        out[f"p{s}_max_surviving"] = (
            round(float(gated.max()), 3) if np.isfinite(gated.max()) else None
        )
        alive = alive & (ps > thr)
        out[f"n_alive_after_stage{s}"] = int(alive.sum())
        if stage_of_death is None and not alive.any():
            stage_of_death = s
    if stage_of_death is None:
        # windows passed every gate but no detection matched: the cluster
        # fell to NMS (min_neighbors / averaging / containment)
        stage_of_death = "nms"
    out["stage_of_death"] = stage_of_death
    out["best_window_iou"] = round(float(win_iou[sel].max()), 3)
    return out


def evaluate_on_scenes(model, n_scenes=100, seed0=100, threshold=0.5,
                       miss_analysis=True, min_neighbors=1):
    """Scene-level recall / false positives + survivor stats at the
    benchmark inference config (default 100 scenes, 300 faces).

    ``miss_analysis``: per missed face, record the best IoU a detection
    achieved AND the geometric ceiling (the best IoU ANY window of the
    pyramid grid could achieve), separating model-limited misses from
    window-grid-limited ones, and the stage probe. Sets the port's global
    config (pyramid, threshold, NMS) as the JAX tool does."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.ops import rectangles as rect_ops
    from rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid import build_plan, window_table

    cf.set("window_scale_factor", 1.1)
    cf.set("min_window_length", 0.075)
    cf.set("foreground_confidence_threshold", threshold)
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_opencv_min_neighbors", min_neighbors)

    detector = casc.CascadeDetector(model)
    scenes = benchmark_scenes(n_scenes, seed0)
    results = detector.detect_batch([s.image for s in scenes])

    grid_boxes = None
    if miss_analysis:
        plan = build_plan(480, 640, model.input_sizes[0], model.input_sizes[0],
                          cf.get("min_window_length"), cf.get("window_scale_factor"))
        table = window_table(plan)
        grid_boxes = table["coords_norm"].astype(np.float64)
        boxes_float = table["boxes_float"]

    tp = fn = fp = 0
    survivors = []
    misses = []
    for si, (scene, res) in enumerate(zip(scenes, results)):
        survivors.append(res.n_survivors_per_stage)
        matched = set()
        for gt in scene.boxes:
            hit = False
            for k, box in enumerate(res.boxes):
                if rect_ops.iou_single(gt, box) > 0.3:
                    hit = True
                    matched.add(k)
            tp += int(hit)
            fn += int(not hit)
            if not hit and miss_analysis:
                best_det = max((rect_ops.iou_single(gt, b) for b in res.boxes), default=0.0)
                best_raw = max((rect_ops.iou_single(gt, b) for b in res.raw_boxes), default=0.0)
                ceiling = float(
                    rect_ops.iou_matrix(np.asarray(gt, np.float64)[None], grid_boxes).max()
                )
                miss = {
                    "scene": si,
                    "gt": [float(v) for v in gt],
                    "best_detection_iou": round(float(best_det), 3),
                    "best_raw_window_iou": round(float(best_raw), 3),
                    "grid_ceiling_iou": round(ceiling, 3),
                }
                miss["stage_analysis"] = _miss_stage_probe(
                    detector, scene.image, gt, grid_boxes, plan, boxes_float, threshold,
                )
                misses.append(miss)
        fp += len(res.boxes) - len(matched)

    survivors = np.asarray(survivors)
    stats = {
        "n_scenes": n_scenes,
        "n_faces": int(tp + fn),
        "threshold": threshold,
        "min_neighbors": min_neighbors,
        "recall": round(tp / max(tp + fn, 1), 3),
        "false_pos_per_scene": round(fp / n_scenes, 2),
        "n_windows": int(results[0].n_windows),
        "survivors_mean": [round(float(x), 1) for x in survivors.mean(axis=0)],
        "survivors_max": [int(x) for x in survivors.max(axis=0)],
    }
    if miss_analysis:
        stats["misses"] = misses
        stats["misses_grid_limited"] = sum(1 for m in misses if m["grid_ceiling_iou"] <= 0.3)
        stats["misses_stage0_blind"] = sum(
            1 for m in misses if m.get("stage_analysis", {}).get("stage_of_death") == 0
        )
    return stats


def choose_operating_point(model, n_scenes=100, seed0=100):
    """The shipped operating point: the most recall (then the fewest false
    positives) within ``FP_BUDGET`` false positives a scene, over
    thresholds (0.5, 0.4, 0.3) x min_neighbors (1, 0), without miss
    analysis; (0.5, 1) when none is within budget. Returns ((threshold,
    min_neighbors), every point's stats)."""
    best_cfg, best_key, points = None, None, []
    for mn in (1, 0):
        for thr in (0.5, 0.4, 0.3):
            stats = evaluate_on_scenes(model, n_scenes, seed0, threshold=thr,
                                       min_neighbors=mn, miss_analysis=False)
            points.append(stats)
            print("thr {} mn {}: recall {} @ {} FP/scene, survivors mean {} max {}".format(
                thr, mn, stats["recall"], stats["false_pos_per_scene"],
                stats["survivors_mean"], stats["survivors_max"]), flush=True)
            key = (stats["recall"], -stats["false_pos_per_scene"])
            if stats["false_pos_per_scene"] <= FP_BUDGET and (best_key is None or key > best_key):
                best_key, best_cfg = key, (thr, mn)
    return (best_cfg if best_cfg is not None else (0.5, 1)), points


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--force", action="store_true", help="retrain over a cached checkpoint")
    parser.add_argument("--mined", choices=sorted(MINED_FILES), default="committed",
                        help="which mined hard examples to train on")
    args = parser.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    model = None if args.force else load_flagship()
    train_secs = corpus_secs = None
    if model is None:
        model, _trainer, train_secs, corpus_secs = train_flagship(mined=args.mined)
    else:
        flagship_config(cf)
        print("loaded cached flagship checkpoint")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("card:", card)
    (thr, mn), points = choose_operating_point(model)
    t0 = time.time()
    stats = evaluate_on_scenes(model, threshold=thr, min_neighbors=mn)
    stats["eval_secs"] = round(time.time() - t0, 1)
    stats["operating_point_policy"] = (
        "max recall s.t. false_pos_per_scene <= {} over thresholds "
        "(0.5, 0.4, 0.3) x min_neighbors (1, 0)".format(FP_BUDGET)
    )
    stats["operating_points"] = points
    stats["capacities"] = capacity_schedule_from_quality(stats)
    stats["card"] = card
    if train_secs is not None:
        stats["train_secs"] = round(train_secs, 1)
        stats["corpus_secs"] = round(corpus_secs, 1)
    print(json.dumps({k: v for k, v in stats.items() if k not in ("misses", "operating_points")},
                     indent=2))
    with open(os.path.join(ARTIFACT_DIR, EVAL_FILE), "w") as f:
        json.dump(stats, f, indent=2)


if __name__ == "__main__":
    main()
