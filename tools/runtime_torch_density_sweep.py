#!/usr/bin/env python3
"""Cascade against single net across pyramid densities on the card: the
reference's thesis experiment (early rejection makes detection faster,
reference README.md:69-71, app/evaluate_runtime_app.py:50-97), swept over
window density (the port's counterpart of tools/runtime_density_sweep.py).

Staged throughput, as the JAX tool measures it: every batch's frames are
on the card before the clock starts; every batch is dispatched, then the
packed rows come to the host and are unpacked, host NMS included; a warm-up
call first; the median of ``--reps`` passes. The cascade is the
port-trained flagship (``--checkpoint``) at the operating threshold of
``artifacts/torch_flagship_eval.json`` (0.5 without it), min_neighbors 1,
minimum window 0.075, run as its batched program once per batch
(``CascadeDetector._run_chunk``) at the default capacity schedule: a frame
whose survivors overflow a capacity is reported as ``saturated`` and is not
re-dispatched inside the clock. The single net is the flagship's 48 px
architecture (conv [32], fc1 512) trained on the same mixed synthetic
corpus (``SyntheticProvider(3000, 24000, [48], seed=0, source="mixed")``),
cached at ``artifacts/model_torch_single48.*`` (gitignored) through the
port's checkpoint functions; its CNN takes windows in chunks of
``max(512, inference_chunk_size * (12 / 48)^2)`` = 1,024, which bounds its
conv intermediates as the cascade's 12 px stage-0 chunk is bounded.

Sizes 480x640 and 450x450, scale factors 1.1, 1.02 and 1.005, frames a
batch as the JAX tool (cascade 16 / 8 / 4, single 16 / 4 / 2; 6 / 4 / 3
cascade batches). At 1.02 and 1.005 both stage 0s run in crop mode: kernel
K2 at 12 px for the cascade and at 48 px for the single net. The result
goes into ``artifacts/torch_runtime_eval.json`` under ``density_sweep``
with the weights, the threshold, ``native.available()`` (host NMS falls
back to numpy without a word) and the card's ``nvidia-smi`` name and power
limit; ``artifacts/runtime_eval.json`` is the JAX package's.

Usage, from the repository root on a machine with a card:

    python3 tools/runtime_torch_density_sweep.py [--quick] [--reps 3]
        [--checkpoint artifacts/model_torch_flagship] [--device cpu]

``--quick``: 480x640 only, at 1.1 and 1.02.
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, DEFAULT_CHECKPOINT, card_line, load_checkpoint  # noqa: E402

OUT_FILE = "torch_runtime_eval.json"
SINGLE_KEY = "torch_single48"
SIZES = ((480, 640), (450, 450))
DENSITIES = (1.1, 1.02, 1.005)
# per scale factor: (cascade frames a call, single-net frames a call,
# cascade batches). The cascade's stage-0 windows take (12 / 48)^2 of the
# single net's memory a window, so the single net runs fewer frames a call
# at high density
BATCHES = {1.1: (16, 16, 6), 1.02: (8, 4, 4), 1.005: (4, 2, 3)}
N_SCENES = 12


def train_or_load_single48(device, artifact_dir=ARTIFACT_DIR):
    """The single-net counterpart of the flagship on ``device``: loaded from
    ``<artifact_dir>/model_torch_single48.*``, else trained (the flagship's
    configuration, its mixed corpus at 48 px, seed 0) and saved there."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import bridge
    from rapidobjectdetectionusingcascadedcnns_torch.models.single import SingleNetDetector

    try:
        params, scfg, mean, std, _ = bridge.load_single(artifact_dir, SINGLE_KEY, device)
        print("loaded the cached single48 checkpoint")
        return SingleNetDetector(params, scfg, mean, std, device)
    except (FileNotFoundError, KeyError, ValueError):
        pass

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch.train import cascade_trainer as ct
    from rapidobjectdetectionusingcascadedcnns_torch.train.trainer import SingleNetTrainer

    flagship.flagship_config(cf)
    t0 = time.time()
    provider = ct.SyntheticProvider(3000, 24000, [48], seed=0, source="mixed")
    corpus_s = time.time() - t0
    t0 = time.time()
    trainer = SingleNetTrainer(provider.dataset(48), f_beta=None, seed=0, device=device)
    trainer.train()
    print("single48: corpus {:.1f} s, trained in {:.1f} s".format(corpus_s, time.time() - t0))
    trainer.export(artifact_dir, SINGLE_KEY)
    params, scfg, mean, std, _ = bridge.load_single(artifact_dir, SINGLE_KEY, device)
    return SingleNetDetector(params, scfg, mean, std, device)


def single_window_chunk(input_size: int) -> int:
    """The single net's windows a CNN call: the cascade's 12 px stage-0
    chunk scaled to the same bytes at ``input_size``, at least 512."""
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf

    return max(512, int(int(cf.get("inference_chunk_size")) * (12.0 / input_size) ** 2))


def measure_staged(dispatch, unpack, staged, reps, sync):
    """(median frames/s, sorted rates) over ``reps`` passes: every staged
    batch dispatched, then every batch's rows read back and unpacked, on
    the host clock. A warm-up call first."""
    dispatch(staged[0]).cpu()
    n_frames = sum(x.shape[0] for x in staged)
    rates = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        packed = [dispatch(x) for x in staged]
        for p in packed:
            for row in p.cpu().numpy():
                unpack(row)
        rates.append(n_frames / (time.perf_counter() - t0))
    rates.sort()
    return statistics.median(rates), rates


def density_sweep(model, single, threshold, sizes=SIZES, densities=DENSITIES, reps=3,
                  batches=BATCHES):
    """{"<h>x<w>@wsf<f>": entry} of the cascade ``model`` and the
    ``single`` net (a ``SingleNetDetector``) on the model's device, with
    the JAX tool's fields (unrounded), and each family's device calls
    (the warm-up's included) with the kernel launches they made.
    ``batches``: frames a call and batches per scale factor, as
    :data:`BATCHES`. Sets the port's config as the JAX tool does."""
    import numpy as np
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade
    from rapidobjectdetectionusingcascadedcnns_torch.ops import windows_cuda, windows_sched_cuda

    device = model.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cf.set("min_window_length", 0.075)
    cf.set("foreground_confidence_threshold", float(threshold))
    cf.set("nms", cf.NMS_OPENCV)
    cf.set("nms_opencv_min_neighbors", 1)
    detector = cascade.CascadeDetector(model)

    def counts():
        return {"K1": windows_cuda.LAUNCHES, "K2": windows_sched_cuda.LAUNCHES}

    def launches_since(before):
        return {k: n - before[k] for k, n in counts().items()}

    sweep = {}
    for img_h, img_w in sizes:
        scenes = [
            synthetic.make_scene(img_h, img_w, n_faces=3, seed=100 + s, min_face=48,
                                 max_face=120).image
            for s in range(N_SCENES)
        ]

        def make_staged(batch, count):
            return [
                torch.as_tensor(np.stack([scenes[(b * batch + i) % len(scenes)]
                                          for i in range(batch)]), device=device)
                for b in range(count)
            ]

        for wsf in densities:
            cf.set("window_scale_factor", wsf)
            batch, sbatch, count = batches[wsf]
            key = "{}x{}@wsf{}".format(img_h, img_w, wsf)
            entry = {"batch_frames": batch, "n_frames": batch * count}
            staged = make_staged(batch, count)

            # ---- cascade: one batched program a batch ----
            plan_entry = detector._plan_and_table(img_h, img_w)
            plan = plan_entry[0]
            caps = tuple(cascade.default_capacity_schedule(plan.n_windows, model.n_nets))
            seen = []

            def unpack_cascade(row):
                res = detector._unpack_row(row, caps, plan, plan_entry[1])
                seen.append(res.n_survivors_per_stage)

            before = counts()
            fps, rates = measure_staged(
                lambda x: detector._run_chunk(x, False, caps, plan_entry, None),
                unpack_cascade, staged, reps, sync)
            last = np.asarray(seen[-entry["n_frames"]:])
            entry["cascade"] = {
                "fps": fps,
                "rates": rates,
                "n_windows": plan.n_windows,
                "extraction_mode": cascade.resolve_extraction_mode(plan),
                "capacities": list(caps),
                "survivors_max": last.max(axis=0).tolist(),
                "saturated": any(detector._is_saturated(s, caps) for s in seen),
                "calls": reps * count + 1,
                "launches": launches_since(before),
            }
            print(key, "cascade", entry["cascade"], flush=True)

            # ---- single net ----
            sstaged = (staged if sbatch == batch
                       else make_staged(sbatch, entry["n_frames"] // sbatch))
            splan, stable, sboxes = single._plan_and_table(img_h, img_w)
            ssched = single._schedule(splan)
            wchunk = single_window_chunk(single.stage_config.input_size)
            single_surv = []

            def unpack_single(row):
                res = single._unpack_row(row, splan, stable, ssched)
                single_surv.append(res.n_survivors_per_stage[0])

            before = counts()
            sfps, srates = measure_staged(
                lambda x: single._infer(x, splan, sboxes, wchunk),
                unpack_single, sstaged, reps, sync)
            entry["single"] = {
                "fps": sfps,
                "rates": srates,
                "batch_frames": sbatch,
                "n_windows": splan.n_windows,
                "n_slots": ssched.n_slots if ssched is not None else splan.n_windows,
                "extraction_mode": cascade.resolve_extraction_mode(splan),
                "window_chunk": wchunk,
                "survivors_max": int(max(single_surv)),
                "calls": reps * len(sstaged) + 1,
                "launches": launches_since(before),
            }
            entry["speedup_cascade_vs_single"] = fps / sfps
            print(key, "single", entry["single"], "speedup",
                  entry["speedup_cascade_vs_single"], flush=True)
            sweep[key] = entry
    return sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="480x640 only, at 1.1 and 1.02")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch import native
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model, weights = load_checkpoint(args.checkpoint, device)
    flagship.flagship_config(cf)
    quality = flagship.load_flagship_quality()
    single = train_or_load_single48(device)
    threshold = float(quality["threshold"]) if quality else 0.5
    print("host NMS: native.available() {}".format(native.available()))

    sweep = density_sweep(
        model, single, threshold,
        sizes=SIZES[:1] if args.quick else SIZES,
        densities=DENSITIES[:2] if args.quick else DENSITIES,
        reps=args.reps,
    )
    path = os.path.join(ARTIFACT_DIR, OUT_FILE)
    payload = {}
    if os.path.exists(path):
        with open(path) as f:
            payload = json.load(f)
    payload["density_sweep"] = {
        "methodology": (
            "staged throughput: every batch's frames on the device before the clock starts, "
            "every batch dispatched, then every batch's packed rows read back and unpacked "
            "(host NMS included); a warm-up call first; the median of the passes. The cascade "
            "runs its batched program once a batch at the default capacities (saturated "
            "frames are reported, not re-dispatched)"
        ),
        "weights": {"cascade": weights, "single": {"kind": "trained", "session_key": SINGLE_KEY}},
        "threshold": threshold,
        "min_neighbors": 1,
        "native_nms": native.available(),
        "device": str(device),
        "card": card_line(device),
        "results": sweep,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
