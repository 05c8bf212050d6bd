"""A configuration's weights, drawn from the run seed on the device.

Each stage's weights come from one ``torch.rand`` call on the device's
generator, cut into leaves and scaled: the custom stages Glorot-uniform
(the reference net's Xavier initialiser), biases 0; the InceptionV3
trunk's folded convolutions uniform with the fan-in limit ``sqrt(6 /
fan_in)``, biases 0, so the trunk's relu activations keep their scale
through the 94 convolutions and the head's logits stay of order one.

``stages`` returns them as the plain reference reads them (float32, conv
``W`` in HWIO, fc ``W`` as (in, out); the trunk in torchvision's OIHW by
module path); ``systems/cascade.py`` hands the same tensors to the
detector in the layout it loads.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..reference import inception_v3 as ref_v3


def stage_sizes(config: dict) -> List[int]:
    """Input sizes of the custom stages: the largest halved per earlier
    stage (48 with 3 nets -> 12, 24, 48)."""
    n, top = int(config["cascade_n_nets"]), int(config["img_width"])
    return [top >> (n - 1 - i) for i in range(n)]


def _flat_features(size: int, config: dict) -> int:
    hw = size
    for _ in config["conv_filter_sizes"]:
        hw = math.ceil(hw / config["conv_stride"])
        hw = math.ceil(hw / config["pooling_stride"])
    return hw * hw * config["conv_filter_sizes"][-1]


class _Draw:
    """Leaves cut from one uniform draw on the device."""

    def __init__(self, shapes, generator, device):
        total = sum(math.prod(s) for s in shapes)
        self.u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
        self.at = 0

    def take(self, shape, limit):
        n = math.prod(shape)
        t = self.u[self.at:self.at + n].view(shape) * limit
        self.at += n
        return t


def _custom_stage(size, bneck_in, config, generator, device):
    k, convs = config["conv_filter_size"], config["conv_filter_sizes"]
    fc1, flat = config["fc1_size"], _flat_features(size, config)
    fc2_in = fc1 + (bneck_in or 0)
    shapes, cin = [], 3
    for cout in convs:
        shapes.append((k, k, cin, cout))
        cin = cout
    shapes += [(flat, fc1), (fc2_in, 2)]
    d = _Draw(shapes, generator, device)
    params, cin = {"conv": []}, 3
    for cout in convs:
        lim = math.sqrt(6.0 / (k * k * cin + k * k * cout))
        params["conv"].append({"W": d.take((k, k, cin, cout), lim),
                               "b": torch.zeros(cout, device=device)})
        cin = cout
    params["fc1"] = {"W": d.take((flat, fc1), math.sqrt(6.0 / (flat + fc1))),
                     "b": torch.zeros(fc1, device=device)}
    params["fc2"] = {"W": d.take((fc2_in, 2), math.sqrt(6.0 / (fc2_in + 2))),
                     "b": torch.zeros(2, device=device)}
    return params, fc2_in


def _inception_stage(bneck_in, generator, device):
    specs = ref_v3.conv_specs()
    fc2_in = ref_v3.WIDTH + (bneck_in or 0)
    shapes = [(cout, cin, kh, kw) for cin, cout, kh, kw, *_ in specs.values()] + [(fc2_in, 2)]
    d = _Draw(shapes, generator, device)
    trunk = {}
    for path, (cin, cout, kh, kw, *_rest) in specs.items():
        trunk[path] = {"W": d.take((cout, cin, kh, kw), math.sqrt(6.0 / (cin * kh * kw))),
                       "b": torch.zeros(cout, device=device)}
    fc2 = {"W": d.take((fc2_in, 2), math.sqrt(6.0 / (fc2_in + 2))),
           "b": torch.zeros(2, device=device)}
    return {"trunk": trunk, "fc2": fc2}, fc2_in


def stages(config: dict, seed: int, device) -> List[dict]:
    """The reference's stages: ``{"size", "kind", "params", "arch", "mean",
    "std", "bneck_in"}`` each, weights drawn from ``seed``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) % (1 << 63))
    mean, std = config["standardization"]["mean"], config["standardization"]["std"]
    arch = {k: config[k] for k in ("conv_stride", "pooling_size", "pooling_stride")}
    out, bneck = [], None
    for size in stage_sizes(config):
        params, width = _custom_stage(size, bneck, config, generator, device)
        out.append({"size": size, "kind": "custom", "params": params, "arch": arch,
                    "mean": mean, "std": std, "bneck_in": bneck})
        bneck = width if config["reuse_bottlenecks"] else None
    if config.get("append_inception"):
        params, _ = _inception_stage(bneck, generator, device)
        out.append({"size": 299, "kind": "inception", "params": params, "arch": arch,
                    "mean": mean, "std": std, "bneck_in": bneck})
    return out
