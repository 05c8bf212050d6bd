#!/usr/bin/env python3
"""The stage-0 CNN's parts at pyramid density, each timed alone on the
card (the port's counterpart of tools/profile_cnn.py).

Over ``n_windows`` 12 px windows (default 131,903, a 450x450 frame at
scale factor 1.005) in chunks of ``chunk`` rows (default 16,384, the
detector's ``inference_chunk_size``), as ``models/cascade._apply_stage_rows``
cuts them, it times, in bf16 with the stage's own parameters:

  * conv: the first conv layer with its bias and relu (cuDNN);
  * max-pool: the first layer's SAME max-pool over the conv output;
  * fc1: the bf16 GEMM with bias and relu over the flattened features of
    the last layer;
  * the whole stage: standardization and ``cnn.apply_stage`` (every
    layer, fc1, fc2 and the softmax) over the windows.

Each time is the median of ``--iters`` passes over every chunk between two
CUDA events, after a warm-up pass; the inputs are seeded random values of
each part's shape. The stage is stage 0 of the port-trained flagship
(``--checkpoint``), or of random weights from seed 0 where there is no
checkpoint, as the JAX tool runs it (the output says which). Prints the
table and writes it to ``chiprun_out/profile_cnn.json`` with the card's
``nvidia-smi`` name and power limit. Run from the repository root on a
machine with a card:

    python3 tools/profile_torch_cnn.py [n_windows] [chunk]
        [--checkpoint artifacts/model_torch_flagship] [--iters 5] [--device cpu]

With ``--device cpu`` the passes are timed on the host clock.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from fddb_torch_roc import DEFAULT_CHECKPOINT, card_line, load_checkpoint  # noqa: E402
from profile_torch_batch import call_ms  # noqa: E402

OUT_DIR = "chiprun_out"
OUT_FILE = "profile_cnn.json"


def stage_parts(model, n_windows=131903, chunk=16384, iters=5):
    """{part: ms} of stage 0 of ``model`` over ``n_windows`` windows in
    chunks of ``chunk`` rows, on the model's device, each part alone:
    "conv", "max_pool", "fc1", "stage"."""
    import torch

    from rapidobjectdetectionusingcascadedcnns_torch.models import cascade, cnn

    device = model.device
    cfg = model.stage_configs[0]
    cdt = cfg.compute_dtype
    params = cnn.cast_params(model.stage_params[0], cfg)
    mean = torch.as_tensor(model.stage_means[0], dtype=torch.float32, device=device)
    std = torch.as_tensor(model.stage_stds[0], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    size, layer = cfg.input_size, params["conv"][0]
    n_out = layer["W"].shape[3]
    windows = torch.rand((n_windows, size, size, cfg.channels), generator=gen,
                         device=device) * 255.0
    conv_in = windows.to(cdt)
    conv_out = torch.randn((n_windows, n_out, size, size), generator=gen, device=device).to(cdt)
    flat = torch.randn((n_windows, cfg.flat_features()), generator=gen, device=device).to(cdt)
    starts = range(0, n_windows, chunk)

    def conv():
        for s in starts:
            h = cnn._conv_same(conv_in[s : s + chunk].permute(0, 3, 1, 2), layer["W"],
                               cfg.conv_stride)
            torch.relu(h + layer["b"][:, None, None])

    def max_pool():
        for s in starts:
            cnn._max_pool_same(conv_out[s : s + chunk], cfg.pooling_size, cfg.pooling_stride)

    def fc1():
        for s in starts:
            torch.relu(torch.matmul(flat[s : s + chunk], params["fc1"]["W"]) + params["fc1"]["b"])

    def stage():
        cascade._apply_stage_rows(params, cfg, windows, None, mean, std, chunk)

    out = {}
    for name, fn in (("conv", conv), ("max_pool", max_pool), ("fc1", fc1), ("stage", stage)):
        out[name] = call_ms(fn, device, iters)
        print("{:9s} {:10.4f} ms over {} windows in chunks of {}".format(
            name, out[name], n_windows, chunk), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_windows", type=int, nargs="?", default=131903)
    ap.add_argument("chunk", type=int, nargs="?", default=16384)
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT,
                    help="path stem <dir>/model_<session key> of the cascade")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu'")
    args = ap.parse_args(argv)

    import train_torch_flagship as flagship
    from rapidobjectdetectionusingcascadedcnns_torch import config as cf
    from rapidobjectdetectionusingcascadedcnns_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    flagship.flagship_config(cf)
    model, weights = load_checkpoint(args.checkpoint, device, random_seed=0)
    out = {"parts_ms": stage_parts(model, args.n_windows, args.chunk, args.iters),
           "n_windows": args.n_windows, "chunk": args.chunk, "weights": weights,
           "conv_filter_sizes": list(model.stage_configs[0].conv_filter_sizes),
           "fc1_size": model.stage_configs[0].fc1_size, "device": str(device),
           "card": card_line(device)}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, OUT_FILE), "w") as f:
        json.dump(out, f, indent=1)
    print("card:", out["card"])


if __name__ == "__main__":
    main()
