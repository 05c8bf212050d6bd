"""The Inception backbone of the appended cascade stage (the
``append_inception`` option; counterpart of models/inception.py of the JAX
package).

The reference appends one stage built on the pretrained Inception-2015
graph: 299x299 input, the 2048-wide ``pool_3`` bottleneck, a trainable head
(network/inception_builder.py:20-96). Nothing is downloaded, so the trunk
is either

  * the compact trainable trunk (a factorized stride-2 stem, three mixed
    1x1 / 3x3 / 5x5 / pool blocks, the global mean and a projection to
    2048), trained end to end with its stage; or
  * the weights at ``cf.get("inception_weights_path")``: an archive of the
    compact trunk, or the ``v3/`` archive of converted InceptionV3 weights
    (models/inception_v3.py), which routes :func:`apply_backbone` to the
    full trunk. Such a trunk stays frozen while the head trains
    (train/trainer.py).

The trunk's parameters: ``{"stem": [{"W", "b"}], "blocks": [{"b1",
"b3_reduce", "b3", "b5_reduce", "b5", "bp"}], "proj": {"W", "b"}}``, or
``{"v3": {path: {"W", "b"}}}``. Conv weights are OIHW in the port (the
layout ``F.conv2d`` takes) and HWIO in the JAX package, its checkpoints and
the archives: :func:`backbone_from_numpy` and :func:`backbone_to_flat`
transpose at that boundary, once.

The compact trunk's rounding points follow the JAX function: every conv
(TF ``SAME``, uneven padding at stride 2), its bias add and relu run in
the compute dtype; the global mean accumulates in f32 and rounds once to
the compute dtype; the projection is a compute-dtype product cast to f32,
plus an f32 bias, then relu.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from . import inception_v3
from .cnn import _glorot_uniform, _max_pool_same, _same_pads

MODEL_INPUT_WIDTH = 299
MODEL_INPUT_HEIGHT = 299
BOTTLENECK_TENSOR_SIZE = 2048

Params = Dict[str, object]

# (branch_1x1, branch_3x3, branch_5x5, branch_pool) output channels per block
_BLOCKS: Tuple[Tuple[int, int, int, int], ...] = (
    (32, 48, 16, 16),
    (64, 96, 32, 32),
    (96, 128, 48, 48),
)
_STEM = ((32, 3, 2), (48, 3, 2), (64, 3, 2))  # (channels, kernel, stride)
_BLOCK_CONVS = ("b1", "b3_reduce", "b3", "b5_reduce", "b5", "bp")

# Rows of an Inception stage handled at once, by device memory: a row's f32
# window (K1's output) and its standardized copy, 8 * s * s * C bytes, plus
# the widest trunk layer held up to four times in f32 (the conv's output,
# its bias sum, the relu and the cast): InceptionV3's Conv2d_2b, 147 x 147 x
# 64 values at 299 px (the compact trunk's widest, its first stem conv, has
# 150 x 150 x 32). 2,145,624 + 22,127,616 bytes a row at 299 px: 176 rows
# in 4 GiB.
CHUNK_BYTES = 4 << 30


def rows_per_chunk(size: int = MODEL_INPUT_WIDTH, channels: int = 3) -> int:
    """Rows of a ``size`` px Inception stage whose windows and trunk
    activations fit :data:`CHUNK_BYTES`."""
    widest = max(64 * ((size - 3) // 2 - 1) ** 2, 32 * (-(-size // 2)) ** 2)
    return max(1, CHUNK_BYTES // (8 * size * size * channels + 16 * widest))


def _conv_init(generator: torch.Generator, k: int, cin: int, cout: int) -> dict:
    w = _glorot_uniform(generator, (k, k, cin, cout), k * k * cin, k * k * cout)
    return {"W": w.permute(3, 2, 0, 1).contiguous(), "b": torch.zeros(cout)}


def init_backbone(generator: torch.Generator) -> Params:
    """The compact trunk with Glorot-uniform float32 weights and zero
    biases, drawn from ``generator`` in the JAX tree's order."""
    params: Params = {"stem": [], "blocks": [], "proj": {}}
    cin = 3
    for cout, k, _stride in _STEM:
        params["stem"].append(_conv_init(generator, k, cin, cout))
        cin = cout
    for b1, b3, b5, bp in _BLOCKS:
        params["blocks"].append({
            "b1": _conv_init(generator, 1, cin, b1),
            "b3_reduce": _conv_init(generator, 1, cin, b3 // 2),
            "b3": _conv_init(generator, 3, b3 // 2, b3),
            "b5_reduce": _conv_init(generator, 1, cin, b5 // 2),
            "b5": _conv_init(generator, 5, b5 // 2, b5),
            "bp": _conv_init(generator, 1, cin, bp),
        })
        cin = b1 + b3 + b5 + bp
    params["proj"] = {
        "W": _glorot_uniform(
            generator, (cin, BOTTLENECK_TENSOR_SIZE), cin, BOTTLENECK_TENSOR_SIZE
        ),
        "b": torch.zeros(BOTTLENECK_TENSOR_SIZE),
    }
    return params


def _conv(x: torch.Tensor, p: dict, stride: int, dtype: torch.dtype) -> torch.Tensor:
    w = p["W"].to(dtype)
    k = w.shape[2]
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    out = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
    return torch.relu(out + p["b"].to(dtype)[:, None, None])


def apply_backbone(params: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(N, 299, 299, 3) standardized input -> (N, 2048) float32
    bottleneck: the full InceptionV3 trunk for a ``v3`` tree, else the
    compact trunk."""
    if "v3" in params:
        return inception_v3.apply_v3(params["v3"], x, dtype=dtype)
    h = x.to(dtype).permute(0, 3, 1, 2)
    for p, (_c, _k, stride) in zip(params["stem"], _STEM):
        h = _conv(h, p, stride, dtype)
    h = _max_pool_same(h, 3, 2)
    for block in params["blocks"]:
        b1 = _conv(h, block["b1"], 1, dtype)
        b3 = _conv(_conv(h, block["b3_reduce"], 1, dtype), block["b3"], 1, dtype)
        b5 = _conv(_conv(h, block["b5_reduce"], 1, dtype), block["b5"], 1, dtype)
        bp = _conv(_max_pool_same(h, 3, 1), block["bp"], 1, dtype)
        h = _max_pool_same(torch.cat([b1, b3, b5, bp], dim=1), 3, 2)
    pooled = h.float().mean(dim=(2, 3)).to(dtype)  # the pool_3 analog
    out = torch.matmul(pooled, params["proj"]["W"].to(dtype)).float()
    return torch.relu(out + params["proj"]["b"].float())


def cast_backbone(params: Params, dtype: torch.dtype) -> Params:
    """The trunk pre-cast for inference: weights in ``dtype``; biases in
    ``dtype`` where the add runs in it (the compact convs), f32 where it
    runs in f32 (InceptionV3's convs, the projection)."""
    if "v3" in params:
        return {"v3": {path: {"W": p["W"].to(dtype), "b": p["b"].float()}
                       for path, p in params["v3"].items()}}
    return {
        "stem": [{k: v.to(dtype) for k, v in p.items()} for p in params["stem"]],
        "blocks": [{n: {k: v.to(dtype) for k, v in blk[n].items()} for n in _BLOCK_CONVS}
                   for blk in params["blocks"]],
        "proj": {"W": params["proj"]["W"].to(dtype), "b": params["proj"]["b"].float()},
    }


# --------------------------------------------------------------------------
# leaves: archives, checkpoints, bundles
# --------------------------------------------------------------------------


def trunk_kind(params: Params) -> str:
    """``"v3"`` for the full InceptionV3 trunk, else ``"compact"``."""
    return "v3" if "v3" in params else "compact"


def flat_keys(kind: str) -> List[str]:
    """The trunk's leaf paths in a fixed order: the JAX package's
    checkpoint keys (below ``backbone/``) and the archive's."""
    if kind == "v3":
        return ["v3/{}/{}".format(p, leaf) for p in inception_v3.conv_table() for leaf in "Wb"]
    keys = ["stem/{}/{}".format(i, leaf) for i in range(len(_STEM)) for leaf in "Wb"]
    keys += ["blocks/{}/{}/{}".format(i, n, leaf)
             for i in range(len(_BLOCKS)) for n in _BLOCK_CONVS for leaf in "Wb"]
    return keys + ["proj/W", "proj/b"]


def _leaf(params, key: str):
    node = params
    for part in key.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def backbone_leaves(params: Params) -> List[torch.Tensor]:
    """The trunk's tensors in :func:`flat_keys` order."""
    return [_leaf(params, k) for k in flat_keys(trunk_kind(params))]


def backbone_from_leaves(leaves, kind: str) -> Params:
    """The inverse of :func:`backbone_leaves` (no copy, no transpose)."""
    keys = flat_keys(kind)
    if len(leaves) != len(keys):
        raise ValueError("a {} trunk has {} leaves, got {}".format(kind, len(keys), len(leaves)))
    if kind == "v3":
        tree: Dict[str, dict] = {}
        for key, t in zip(keys, leaves):
            _, path, leaf = key.split("/")
            tree.setdefault(path, {})[leaf] = t
        return {"v3": tree}
    it = iter(leaves)
    params: Params = {
        "stem": [{"W": next(it), "b": next(it)} for _ in _STEM],
        "blocks": [{n: {"W": next(it), "b": next(it)} for n in _BLOCK_CONVS} for _ in _BLOCKS],
    }
    params["proj"] = {"W": next(it), "b": next(it)}
    return params


def backbone_to_flat(params: Params) -> Dict[str, np.ndarray]:
    """The trunk as float32 numpy leaves keyed by :func:`flat_keys`, conv
    weights back in HWIO: the JAX package's checkpoint and archive
    layout."""
    flat = {}
    for key in flat_keys(trunk_kind(params)):
        v = _leaf(params, key).detach().float().cpu()
        if v.dim() == 4:
            v = v.permute(2, 3, 1, 0)
        flat[key] = np.ascontiguousarray(v.numpy())
    return flat


def backbone_from_numpy(tree, device) -> Params:
    """A JAX-layout trunk (arrays with an ``__array__``: the JAX tree, a
    checkpoint's or an archive's leaves) -> the port's float32 tensors on
    ``device``, each conv weight transposed HWIO -> OIHW once."""
    kind = "v3" if "v3" in tree else "compact"
    leaves = []
    for key in flat_keys(kind):
        t = torch.tensor(np.asarray(_leaf(tree, key), dtype=np.float32), device=device)
        leaves.append(t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t)
    return backbone_from_leaves(leaves, kind)


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Rebuild the compact trunk's (numpy, HWIO) tree from path-flattened
    leaves."""
    return backbone_from_leaves([flat[k] for k in flat_keys("compact")], "compact")


def tree_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, object]:
    """An archive's or a checkpoint's trunk leaves -> the (numpy, HWIO)
    tree: the ``v3/`` namespace gives the full trunk, else the compact."""
    if any(k.startswith("v3/") for k in flat):
        return {"v3": inception_v3.params_from_flat(flat)}
    return params_from_flat(flat)


def load_backbone_weights(path: str, device=None) -> Params:
    """Load trunk weights a user provides: an .npz of the compact trunk, or
    a converted InceptionV3 archive (``v3/`` namespace,
    tools/convert_torch_inception.py), which routes :func:`apply_backbone`
    to the full trunk. The tensors land on ``device`` (default: the CUDA
    card; ``"cpu"`` for the CPU)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return backbone_from_numpy(tree_from_flat(flat), resolve_device(device))
