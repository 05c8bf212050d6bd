#!/usr/bin/env python3
"""Convert InceptionV3 weights that a user already has into the archive the
cascade's appended Inception stage loads (``cf.set("inception_weights_path",
...)``; the port's counterpart of tools/convert_inception.py).

The input is a torchvision ``inception_v3`` state dict: a ``torch.save``d
file (.pth/.pt, read with ``torch.load(weights_only=True)``, a
``{"state_dict": ...}`` wrapper accepted) or an .npz of the same tensors.
The batch norms are folded into the convs and the result is written as the
``v3/`` archive (HWIO, float32), which the JAX package and the port both
load. Nothing is downloaded.

Usage:
    python tools/convert_torch_inception.py <state_dict.pth|.npz> <out.npz>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_state_dict(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return dict(sd.items())


def convert(src: str, dst: str) -> dict:
    """Convert ``src`` and write ``dst``; returns the converted tree."""
    from rapidobjectdetectionusingcascadedcnns_torch.models import inception_v3

    params = inception_v3.convert_torchvision_state_dict(load_state_dict(src))
    inception_v3.save_npz(dst, params)
    return params


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    from rapidobjectdetectionusingcascadedcnns_torch.models import inception_v3

    params = convert(argv[0], argv[1])
    print(
        "converted {} convs / {:.1f}M folded parameters -> {}".format(
            len(params), inception_v3.n_params(params) / 1e6, argv[1]
        )
    )
    print('use with: cf.set("inception_weights_path", {!r})'.format(argv[1]))


if __name__ == "__main__":
    main()
