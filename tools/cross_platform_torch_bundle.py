#!/usr/bin/env python3
"""One serving bundle run on the card and on the CPU (the port's
counterpart of tools/cross_platform_bundle.py, with its checks).

1. On the card: export the cascade with ``platforms=("cuda", "cpu")``,
   save it, load it and detect N synthetic scenes (240x320, 2 faces of
   40-100 px); K1 and K3 run as the bundle's custom operators.
2. In a child process with ``CUDA_VISIBLE_DEVICES=""``: load the same
   on-disk bundle with ``--device cpu`` (its programs moved to the CPU,
   where the operators run their plain versions) and detect the same
   scenes.
3. Compare with the JAX tool's matched-box tolerances: detections matched
   greedily per scene must agree within 1 px and 0.05 confidence. Every
   unmatched detection is reported with the stage probabilities, on both
   devices, of the survivor windows that differ between them, beside each
   stage's gate; it is explained when each such window sits within 0.05
   of the gate where the devices' decisions part (a flip at the gate).

The weights are the port-trained flagship at its operating point, or
random weights without its checkpoint (see tools/serve_torch_bundle_check.py).
Writes ``artifacts/torch_cross_platform_check.json`` with the card's
``nvidia-smi`` name and power limit.

Usage, from the repository root on a machine with a card:

    python3 tools/cross_platform_torch_bundle.py [--scenes 8]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line  # noqa: E402
from serve_torch_bundle_check import load_operating_model  # noqa: E402

OUT_FILE = "torch_cross_platform_check.json"
IMG_H, IMG_W = 240, 320
BATCH = 4
BOX_TOL = 1.0  # px, matched detections
CONF_EPS = 0.05  # matched confidences; and a flip's distance to its gate


def scenes(n):
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic

    return [synthetic.make_scene(IMG_H, IMG_W, n_faces=2, seed=s, min_face=40,
                                 max_face=100).image for s in range(n)]


def jsonable(results):
    return [{
        "boxes": [[float(v) for v in b] for b in r.boxes],
        "confidences": [float(c) for c in r.confidences],
        "raw_ids": [int(v) for v in r.raw_window_ids],
        "raw_confs": [float(v) for v in r.raw_confidences],
    } for r in results]


def export_bundle(model, dir_path):
    """A ("cuda", "cpu") bundle of ``model`` (on the card) saved to
    ``dir_path``; returns its metadata."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    bundle = serve.export_detector(model, IMG_H, IMG_W, batch=BATCH, n_rungs=3,
                                   platforms=("cuda", "cpu"))
    serve.save_bundle(bundle, dir_path)
    return bundle.meta


def stage_probabilities(model, image, window_ids, meta, device):
    """Each window's foreground probability at every stage (window id ->
    list) in ``image`` (RGB, or a YUV420 (Y, UV) pair), with the bundle's
    recorded knobs: stage 0 over the whole pyramid, then each later stage
    on the windows re-extracted alone (in their own small batch, not the
    bundle's survivor batch)."""
    import numpy as np
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade as casc
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.ops.color import yuv420_to_rgb
    from rapidobjectdetectionusingcascadedcnns_torch.ops.pyramid import build_plan, window_table
    from rapidobjectdetectionusingcascadedcnns_torch.ops.windows import (
        crop_and_resize_impl,
        level_indices,
        to_planes_bf16,
    )

    sel = np.asarray(sorted(int(w) for w in window_ids), np.int64)
    if not len(sel):
        return {}
    size0 = model.input_sizes[0]
    plan = build_plan(meta["img_h"], meta["img_w"], size0, size0, meta["min_window_length"],
                      meta["window_scale_factor"])
    table = window_table(plan)
    hp, chunk = bool(meta["high_precision"]), int(meta["chunk"])
    params = [cnn.cast_params(p, c) for p, c in zip(model.stage_params, model.stage_configs)]
    stats = [(torch.as_tensor(m, device=device), torch.as_tensor(s, device=device))
             for m, s in zip(model.stage_means, model.stage_stds)]
    if isinstance(image, (tuple, list)):  # a YUV420 frame, decoded as the program decodes it
        y, uv = (torch.as_tensor(np.asarray(a)[None], device=device) for a in image)
        images = yuv420_to_rgb(y, uv).float()
    else:
        images = torch.as_tensor(np.asarray(image)[None], device=device).float()
    boxes_float = torch.as_tensor(table["boxes_float"], device=device)
    indices = level_indices(plan, device) if meta["extraction_mode"] == "gather" else None
    with torch.no_grad():
        probs0, bneck0, ids0, valid0 = casc._stage0_apply(
            images, boxes_float, plan, params[0], model.stage_configs[0], *stats[0], chunk,
            meta["extraction_mode"], meta["resample_impl"], hp, indices)
        p_rows, b_rows = probs0[0, :, 1].cpu().numpy(), bneck0[0]
        if ids0 is not None:  # K2's scheduled order back to plan order
            ids, valid = ids0.cpu().numpy(), valid0.cpu().numpy()
            p0 = np.full(plan.n_windows, np.nan)
            p0[ids[valid]] = p_rows[valid]
            order = np.full(plan.n_windows, -1, np.int64)
            order[ids[valid]] = np.nonzero(valid)[0]
            bneck = b_rows[torch.as_tensor(order[sel], device=device)]
        else:
            p0, bneck = p_rows, b_rows[torch.as_tensor(sel, device=device)]
        stage_probs = [p0[sel]]
        boxes = torch.as_tensor(table["coords_norm"][sel].astype(np.float32), device=device)[None]
        planes = None if hp else to_planes_bf16(images)
        for s in range(1, model.n_nets):
            cfg = model.stage_configs[s]
            wins = crop_and_resize_impl(images, boxes, cfg.input_size, cfg.input_size, hp, planes)
            probs, bneck = casc._apply_stage_rows(
                params[s], cfg, wins.reshape(len(sel), cfg.input_size, cfg.input_size, -1),
                bneck if cfg.bottleneck_in_size is not None else None, *stats[s], chunk)
            stage_probs.append(probs[:, 1].cpu().numpy())
    return {int(w): [float(p[j]) for p in stage_probs] for j, w in enumerate(sel)}


def _flip_evidence(window, p_a, p_b, thresholds, conf_eps):
    """Where one survivor flip parts the devices: the first stage whose
    gate the two probabilities fall on different sides of, else the stage
    with the least margin; borderline when both probabilities there lie
    within ``conf_eps`` of the gate."""
    best = None
    for stage, (a, b) in enumerate(zip(p_a, p_b)):
        thr = thresholds[stage]
        rec = {"window_id": window, "stage": stage, "threshold": thr,
               "p_card": a, "p_cpu": b, "worst_margin": max(abs(a - thr), abs(b - thr))}
        if (a > thr) != (b > thr):
            rec["mechanism"] = "gate decisions differ"
            best = rec
            break
        if best is None or rec["worst_margin"] < best["worst_margin"]:
            best = dict(rec, mechanism="same side of every gate; least margin")
    best["borderline"] = best["worst_margin"] <= conf_eps
    best["stage_probabilities"] = {"card": p_a, "cpu": p_b}
    return best


def compare_detections(card, cpu, thresholds, probes=None, box_tol=BOX_TOL, conf_eps=CONF_EPS):
    """Per scene: match the shorter side's detections greedily to the
    longer side's (nearest box by max-coordinate distance); matched boxes
    must agree within ``box_tol`` px and confidences within ``conf_eps``.
    Each unmatched detection is reported with the survivor windows that
    differ between the sides and, where ``probes`` ({"card": {scene:
    {window: probs}}, "cpu": ...}) has them, their stage probabilities
    beside the gates; it is explained when there is at least one such
    window and every one is borderline (:func:`_flip_evidence`). Each
    scene's record holds the same evidence for all its survivor flips, so
    a matched box that drifted past ``box_tol`` is reported with it too."""
    import numpy as np

    probes = probes or {"card": {}, "cpu": {}}
    scenes_out, unmatched, max_box, max_conf, ok = [], [], 0.0, 0.0, True
    for i, (a, b) in enumerate(zip(card, cpu)):
        if len(a["boxes"]) >= len(b["boxes"]):
            short, long_, long_side = b, a, "card"
        else:
            short, long_, long_side = a, b, "cpu"
        sb = np.asarray(short["boxes"], float).reshape(-1, 4)
        lb = np.asarray(long_["boxes"], float).reshape(-1, 4)
        free = list(range(len(lb)))
        box_d = conf_d = 0.0
        for j in range(len(sb)):
            dists = [np.abs(sb[j] - lb[k]).max() for k in free]
            k = free.pop(int(np.argmin(dists)))
            box_d = max(box_d, float(np.abs(sb[j] - lb[k]).max()))
            conf_d = max(conf_d, abs(short["confidences"][j] - long_["confidences"][k]))
        max_box, max_conf = max(max_box, box_d), max(max_conf, conf_d)
        flips = sorted(set(a["raw_ids"]) ^ set(b["raw_ids"]))
        evidence = []
        for w in flips:
            p_a = probes["card"].get(i, {}).get(w)
            p_b = probes["cpu"].get(i, {}).get(w)
            if p_a is None or p_b is None:
                evidence.append({"window_id": w, "borderline": False,
                                 "mechanism": "not probed"})
            else:
                evidence.append(_flip_evidence(w, p_a, p_b, thresholds, conf_eps))
        explained = bool(flips) and all(e["borderline"] for e in evidence)
        for k in free:
            unmatched.append({"scene": i, "side": long_side,
                              "box": [float(v) for v in lb[k]],
                              "confidence": float(long_["confidences"][k]),
                              "explained": explained, "survivor_flips": evidence})
        scene_ok = box_d <= box_tol and conf_d <= conf_eps and (not free or explained)
        ok = ok and scene_ok
        scenes_out.append({"scene": i, "card_n": len(a["boxes"]), "cpu_n": len(b["boxes"]),
                           "box_delta": box_d, "conf_delta": conf_d,
                           "survivor_flips": len(flips), "flip_evidence": evidence,
                           "ok": scene_ok})
    return {"box_tol": box_tol, "conf_eps": conf_eps, "max_box_delta": max_box,
            "max_conf_delta": max_conf, "unmatched": unmatched, "scenes": scenes_out, "ok": ok}


def _child(args):
    """The CPU leg: load the bundle on the CPU, detect, probe."""
    from rapidobjectdetectionusingcascadedcnns_torch import serve

    with open(args.child_request) as f:
        request = json.load(f)
    det = serve.load_bundle(args.bundle_dir, device="cpu")
    frames = scenes(request["n_scenes"])
    t0 = time.perf_counter()
    results = det.detect_batch(frames)
    detect_s = time.perf_counter() - t0
    model, _, _ = load_operating_model(args.checkpoint, "cpu")
    probes = {}
    for i, r in enumerate(results):
        ids = set(request["card_raw_ids"][i]) | set(int(v) for v in r.raw_window_ids)
        probes[i] = stage_probabilities(model, frames[i], ids, det.meta, det.device)
    with open(args.child_out, "w") as f:
        json.dump({"detect_s": detect_s, "detections": jsonable(results),
                   "probes": {i: {str(w): p for w, p in pr.items()} for i, pr in probes.items()}},
                  f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--bundle-dir", help=argparse.SUPPRESS)
    ap.add_argument("--child-request", help=argparse.SUPPRESS)
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child_out:
        return _child(args)

    from rapidobjectdetectionusingcascadedcnns_torch import serve
    from rapidobjectdetectionusingcascadedcnns_torch.ops import nms_cuda, windows_cuda
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(None)
    model, weights, _ = load_operating_model(args.checkpoint, device)
    frames = scenes(args.scenes)
    with tempfile.TemporaryDirectory() as work:
        bundle_dir = os.path.join(work, "bundle")
        t0 = time.perf_counter()
        meta = export_bundle(model, bundle_dir)
        export_s = time.perf_counter() - t0
        det = serve.load_bundle(bundle_dir, device=device)
        det.detect_batch(frames[:BATCH])  # warm-up
        k1, k3 = windows_cuda.LAUNCHES, nms_cuda.LAUNCHES
        t0 = time.perf_counter()
        card = det.detect_batch(frames)
        card_s = time.perf_counter() - t0
        launches = {"K1": windows_cuda.LAUNCHES - k1, "K3": nms_cuda.LAUNCHES - k3}
        assert launches["K1"] > 0 and launches["K3"] > 0, launches
        request = os.path.join(work, "request.json")
        with open(request, "w") as f:
            json.dump({"n_scenes": args.scenes,
                       "card_raw_ids": [[int(v) for v in r.raw_window_ids] for r in card]}, f)
        child_out = os.path.join(work, "cpu.json")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--checkpoint",
                        args.checkpoint, "--bundle-dir", bundle_dir, "--child-request", request,
                        "--child-out", child_out], env=env, check=True, timeout=1800)
        child_s = time.perf_counter() - t0
        with open(child_out) as f:
            cpu_side = json.load(f)
    card_probes = {}
    for i, r in enumerate(card):
        ids = set(int(v) for v in r.raw_window_ids) | set(cpu_side["detections"][i]["raw_ids"])
        card_probes[i] = stage_probabilities(model, frames[i], ids, meta, device)
    probes = {"card": card_probes,
              "cpu": {int(i): {int(w): p for w, p in pr.items()}
                      for i, pr in cpu_side["probes"].items()}}
    comparison = compare_detections(jsonable(card), cpu_side["detections"], meta["thresholds"],
                                    probes)
    out = {"card": card_line(device), "weights": weights, "n_scenes": args.scenes,
           "img": [IMG_H, IMG_W], "batch": BATCH, "platforms": meta["platforms"],
           "capacity_rungs": meta["capacity_rungs"], "thresholds": meta["thresholds"],
           "export_s": export_s, "card_detect_s": card_s, "card_launches": launches,
           "cpu_detect_s": cpu_side["detect_s"], "cpu_process_s": child_s,
           "detections_card": sum(len(r.boxes) for r in card),
           "detections_cpu": sum(len(d["boxes"]) for d in cpu_side["detections"]),
           **comparison}
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k not in ("scenes", "unmatched")}))
    for u in comparison["unmatched"]:
        print("unmatched:", json.dumps(u))
    assert comparison["ok"], "card and CPU detections disagree beyond the tolerances"


if __name__ == "__main__":
    main()
