#!/usr/bin/env python3
"""Where a training update of the port goes on the card (the port's
counterpart of tools/profile_train.py), and where the flagship corpus
build goes on the host.

1. Step times: for each cascade stage's architecture (12 / 24 / 48 px,
   and 48 px with online augmentation; conv [32], fc1 512, the configured
   compute dtype) at ``batch_size``: ms a step and samples/s over
   ``steps`` chained updates (each update reads the parameters the last
   one wrote) between two CUDA events, after a warm-up.
2. The split of one update (48 px with augmentation): the augmentation
   (``ops/augment.py``: the color chain and the dense two-tap affine warp),
   the forward pass with the loss, autograd's backward, the optimizer; ms
   of each between CUDA events, and its kernel launches and kernel time
   from one ``torch.profiler`` session over a further update, each part in
   a ``record_function`` range owning the kernels launched within it on
   any thread ("not measured" where the profiler saw no device activity). The update is the body of ``train_step.train_step``,
   cut at its parts, and must give the same loss.
3. The flagship corpus build on the host (``--corpus``): seconds of each
   part of ``train_torch_flagship.flagship_provider`` -- the procedural
   patches, the scene render, the rejection sampling of background
   patches, the crop resizes, the mined examples (file read and aligned
   views) -- by host timers around those functions.

Writes ``artifacts/torch_train_profile.json`` with the card's
``nvidia-smi`` name and power limit.

Usage, from the repository root on a machine with a card:

    python3 tools/profile_torch_train.py [--steps 8] [--batch N] [--corpus]
        [--device cpu]
"""

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import ARTIFACT_DIR, card_line  # noqa: E402

OUT_FILE = "torch_train_profile.json"
STAGES = ((12, False), (24, False), (48, False), (48, True))
NOT_MEASURED = "not measured"


def profile_config(cf):
    """The architecture profiled: the reference default stage (conv [32],
    fc1 512) with its default training settings."""
    cf.set("conv_filter_sizes", [32])
    cf.set("fc1_size", 512)


def stage_setup(size, augment, batch, device, seed=0):
    """A fresh stage trainer's pieces on ``device``: (config, state, loss
    settings, augmentation config, uint8 batch, labels, mean, std, host and
    device generators)."""
    import numpy as np
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.ops import augment as augment_ops
    from rapidobjectdetectionusingcascadedcnns_torch.train import optimizer as opt_mod
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as ts
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import set_numerics

    scfg = cnn.StageConfig.from_config(size)
    set_numerics(scfg.compute_dtype)
    state = ts.init_train_state(scfg, seed, lambda p: opt_mod.optimizer_from_config(p, 1000),
                                device)
    settings = ts.LossSettings(
        f_beta=None, positive_proportion=0.5, weighted=cf.get("weighted_cross_entropy"),
        normalize=cf.get("weighted_cross_entropy_normalize"),
        l2_strength=float(cf.get("L2_regularization_strength")),
        l1_strength=float(cf.get("L1_regularization_strength")),
        dropout_keep=float(cf.get("dropout_rate")),
    )
    aug = augment_ops.AugmentConfig.from_config() if augment else None
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randint(0, 256, size=(batch, size, size, 3)).astype(np.uint8),
                        device=device)
    y = torch.as_tensor((rng.rand(batch) < 0.5).astype(np.int64), device=device)
    mean = torch.full((size, size, 3), 127.5, device=device)
    std = torch.full((size, size, 3), 64.0, device=device)
    gens = (torch.Generator().manual_seed(seed), torch.Generator(device=device).manual_seed(seed))
    return scfg, state, settings, aug, x, y, mean, std, gens


def _elapsed_s(fn, device):
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def step_times(device, batch, steps=8, warmup=2, stages=STAGES):
    """ms a step and samples/s of ``steps`` chained updates per stage."""
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as ts

    out = []
    for size, augment in stages:
        scfg, state, settings, aug, x, y, mean, std, (hg, dg) = stage_setup(
            size, augment, batch, device)

        def run(n):
            for _ in range(n):
                ts.train_step(state, scfg, settings, aug, x, y, None, mean, std, hg, dg)

        run(warmup)
        seconds = _elapsed_s(lambda: run(steps), device)
        out.append({"size": size, "augment": augment, "batch": batch, "steps": steps,
                    "ms_per_step": seconds / steps * 1e3,
                    "samples_per_s": batch * steps / seconds})
    return out


def _profiled_parts(parts, device):
    """Run ``parts`` ((name, fn) pairs) in order under one
    ``torch.profiler`` session, each inside a ``record_function`` range
    of its name. Returns ({name: (kernel launches, kernel ms)}, launches in
    all): a part owns the device activities whose launch call started
    within its range on any thread (autograd launches the backward from
    its own thread); (None, None) where the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for name, fn in parts:
            with record_function(name):
                fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    cpu_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    names = [name for name, _ in parts]
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in cpu_events
              if e.name in names}
    counts = {name: [0, 0.0] for name in names}
    for e in cpu_events:  # the launch calls, which the profiler gives their kernels
        for name, (start, end) in ranges.items():
            if e.kernels and start <= e.time_range.start <= end:
                counts[name][0] += len(e.kernels)
                counts[name][1] += sum(k.duration for k in e.kernels) / 1e3
                break
    total = sum(len(e.kernels) for e in cpu_events)
    return {name: (n, ms) if n else (None, None) for name, (n, ms) in counts.items()}, total


def update_split(device, batch, size=48, augment=True):
    """One update cut at its parts, each timed between CUDA events and
    profiled; its loss against ``train_step``'s on a copy of the state."""
    import copy

    from rapidobjectdetectionusingcascadedcnns_torch.models import cnn
    from rapidobjectdetectionusingcascadedcnns_torch.ops import augment as augment_ops
    from rapidobjectdetectionusingcascadedcnns_torch.train import losses
    from rapidobjectdetectionusingcascadedcnns_torch.train import train_step as ts

    scfg, state, settings, aug, x, y, mean, std, (hg, dg) = stage_setup(
        size, augment, batch, device)
    ts.train_step(state, scfg, settings, aug, x, y, None, mean, std, hg, dg)  # warm-up
    twin = copy.deepcopy((state, hg.get_state(), dg.get_state()))
    box = {}

    def augment_part():
        xs = ts.standardize(x, mean, std)
        box["x"] = xs if aug is None else augment_ops.draw_and_augment(hg, xs, y, aug)

    def forward_part():
        out = cnn.apply_stage(state.params, scfg, box["x"], None,
                              dropout_keep=settings.dropout_keep, generator=dg)
        box["loss"] = losses.total_loss(
            out, y, state.params, f_beta=settings.f_beta,
            positive_proportion=settings.positive_proportion, weighted=settings.weighted,
            normalize=settings.normalize, l2_strength=settings.l2_strength,
            l1_strength=settings.l1_strength)

    def backward_part():
        state.optimizer.zero_grad()
        box["loss"].backward()

    def optimizer_part():
        state.optimizer.step(state.step)
        state.step += 1

    parts = (("augment", augment_part), ("forward_and_loss", forward_part),
             ("backward", backward_part), ("optimizer", optimizer_part))
    split = {}
    for name, fn in parts:
        ms = _elapsed_s(fn, device) * 1e3
        split[name] = {"ms": ms}
    loss_parts = float(box["loss"].detach())
    # the same update by train_step on the twin state and generators
    t_state, h_state, d_state = twin
    hg.set_state(h_state)
    dg.set_state(d_state)
    loss_step = float(ts.train_step(t_state, scfg, settings, aug, x, y, None, mean, std, hg, dg))
    # launches and kernel time of each part, on a further update
    profiled, launches_all = _profiled_parts(parts, device)
    for name, (launches, kernel_ms) in profiled.items():
        split[name]["launches"] = NOT_MEASURED if launches is None else launches
        split[name]["kernel_ms"] = NOT_MEASURED if kernel_ms is None else kernel_ms
    return {"size": size, "augment": augment, "batch": batch, "parts": split,
            "total_ms": sum(p["ms"] for p in split.values()),
            "launches": launches_all if launches_all else NOT_MEASURED,
            "loss_parts": loss_parts, "loss_train_step": loss_step,
            "same_loss": loss_parts == loss_step}


@contextlib.contextmanager
def host_timers(targets):
    """Accumulate host seconds and calls of the named functions while the
    block runs: ``targets`` maps a part's name to (module, attribute)."""
    acc = {name: {"s": 0.0, "calls": 0} for name in targets}
    saved = []
    for name, (module, attr) in targets.items():
        real = getattr(module, attr)

        def timed(*args, _real=real, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                acc[_name]["s"] += time.perf_counter() - t0
                acc[_name]["calls"] += 1

        saved.append((module, attr, real))
        setattr(module, attr, timed)
    try:
        yield acc
    finally:
        for module, attr, real in saved:
            setattr(module, attr, real)


def corpus_split(n_pos, n_neg, seed=0):
    """Host seconds of the flagship corpus build's parts (the recorded
    recipe at ``n_pos``/``n_neg``). Parts nest: the scene-sampled corpus
    holds the scene renders, the sampling and the crop resizes."""
    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.data import image_io, synthetic
    from rapidobjectdetectionusingcascadedcnns_torch.ops import sampling

    flagship.flagship_config(cf)
    recipe = flagship.apply_recorded_overrides(cf)
    targets = {
        "procedural_patches": (synthetic, "make_multiresolution_patch_dataset"),
        "scene_sampled_corpus": (synthetic, "make_multiresolution_scene_patch_dataset"),
        "scene_render": (synthetic, "make_scene"),
        "background_sampling": (sampling, "random_img_patch"),
        "crop_resize": (image_io, "resize_rgb"),
        "aligned_views": (synthetic, "aligned_views"),
        "mined_examples_read": (flagship, "load_mined"),
    }
    with host_timers(targets) as acc:
        t0 = time.perf_counter()
        provider = flagship.flagship_provider(n_pos, n_neg, seed, recipe)
        total = time.perf_counter() - t0
    return {"n_pos": n_pos, "n_neg": n_neg, "samples": int(len(provider._labels)),
            "total_s": total, "parts": acc}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None, help="default: batch_size")
    ap.add_argument("--corpus", action="store_true",
                    help="also time the flagship corpus build (the recorded 5,000/40,000)")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cf.reset()
    profile_config(cf)
    batch = args.batch or int(cf.get("batch_size"))
    out = {"card": card_line(device), "device": str(device),
           "compute_dtype": cf.get("compute_dtype"),
           "step_times": step_times(device, batch, args.steps),
           "update_split": update_split(device, batch)}
    if args.corpus:
        cf.reset()
        out["corpus"] = corpus_split(5000, 40000)
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
