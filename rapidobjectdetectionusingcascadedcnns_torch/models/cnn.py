"""Cascade-stage CNN: init/apply over plain parameter dictionaries.

Counterpart of models/cnn.py of the JAX package (architecture of the
reference net, network/net.py:101-240):

    X -> [conv(kxk, SAME, stride s) -> relu -> maxpool(p, SAME, stride q)]*
      -> fc1 (relu)                                    # the "bottleneck"
      -> concat(prev-stage bottleneck)  (optional)
      -> dropout (training only)
      -> fc2 (2 logits) -> softmax

Parameters keep the JAX layout, ``{"conv": [{"W", "b"}], "fc1", "fc2"}``
with conv weights in HWIO, so a JAX pytree converts leaf by leaf
(models/bridge.py). ``apply_stage`` takes NHWC input like the JAX function;
the conv stack runs in NCHW and flattens back in NHWC order, because fc1's
rows are laid out that way.

The rounding points follow the JAX function in bf16 mode: the conv output
plus its bias rounds in the compute dtype; fc1 runs in the compute dtype and
is cast to f32 after the relu; the bottleneck concat is f32; fc2 runs in the
compute dtype, is cast to f32 and then gets its f32 bias; softmax runs in
f32. Convolutions and matmuls go to ``F.conv2d``/``torch.matmul``, as the
JAX package leaves them to XLA.

An Inception stage (``backbone="inception"``, the ``append_inception``
option) is ``{"backbone": trunk, "fc2"}``: the trunk of models/inception.py
in place of the conv stack and fc1, its 2048-wide output the hidden
representation, then the same head.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate

Params = Dict[str, object]


@dataclass(frozen=True)
class StageConfig:
    """Static architecture description of one cascade stage."""

    input_size: int  # square input resolution (12 / 24 / 48)
    channels: int = 3
    conv_filter_sizes: Tuple[int, ...] = (32,)
    conv_kernel: int = 3
    conv_stride: int = 1
    pooling_size: int = 3
    pooling_stride: int = 1
    fc1_size: int = 512
    n_classes: int = 2
    bottleneck_in_size: Optional[int] = None  # previous stage's fc1(+in) width
    compute_dtype: torch.dtype = torch.bfloat16
    backbone: str = "custom"  # "custom" conv stack | "inception" trunk

    @classmethod
    def from_config(
        cls,
        input_size: int,
        bottleneck_in_size: Optional[int] = None,
        backbone: str = "custom",
    ):
        from .. import config as cf

        dtype = (
            torch.bfloat16 if cf.get("compute_dtype") == "bfloat16" else torch.float32
        )
        return cls(
            input_size=input_size,
            conv_filter_sizes=tuple(cf.get("conv_filter_sizes")),
            conv_kernel=cf.get("conv_filter_size"),
            conv_stride=cf.get("conv_stride"),
            pooling_size=cf.get("pooling_size"),
            pooling_stride=cf.get("pooling_stride"),
            fc1_size=cf.get("fc1_size"),
            bottleneck_in_size=bottleneck_in_size,
            compute_dtype=dtype,
            backbone=backbone,
        )

    @property
    def hidden_width(self) -> int:
        """Width of the hidden ("fc1") representation before any concat."""
        if self.backbone == "inception":
            from . import inception

            return inception.BOTTLENECK_TENSOR_SIZE
        return self.fc1_size

    @property
    def bottleneck_out_size(self) -> int:
        """The hidden representation concatenated with the incoming
        bottleneck (net.py:139-146)."""
        return self.hidden_width + (self.bottleneck_in_size or 0)

    def conv_output_hw(self) -> int:
        """Spatial size after the conv/pool stack (SAME padding)."""
        hw = self.input_size
        for _ in self.conv_filter_sizes:
            hw = math.ceil(hw / self.conv_stride)
            hw = math.ceil(hw / self.pooling_stride)
        return hw

    def flat_features(self) -> int:
        return self.conv_output_hw() ** 2 * (
            self.conv_filter_sizes[-1] if self.conv_filter_sizes else self.channels
        )


def _glorot_uniform(generator: torch.Generator, shape, fan_in: int, fan_out: int):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a parameter tree (nested dicts and
    lists), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """A stage's tensors in a fixed order: conv layers, fc1, fc2; for an
    Inception stage the trunk's (``inception.flat_keys`` order), then fc2."""
    if "backbone" in params:
        from . import inception

        return inception.backbone_leaves(params["backbone"]) + [
            params["fc2"]["W"], params["fc2"]["b"]
        ]
    leaves = []
    for layer in params["conv"]:
        leaves += [layer["W"], layer["b"]]
    return leaves + [params["fc1"]["W"], params["fc1"]["b"], params["fc2"]["W"], params["fc2"]["b"]]


def init_stage(cfg: StageConfig, generator: torch.Generator) -> Params:
    """Glorot-uniform float32 master weights (the reference's
    ``xavier_initializer``, net_builder.py:38,85), zero biases, drawn from
    ``generator`` on its device."""
    if cfg.backbone == "inception":
        return _init_inception_stage(cfg, generator)
    params: Params = {"conv": [], "fc1": {}, "fc2": {}}
    in_ch = cfg.channels
    k = cfg.conv_kernel
    for n_out in cfg.conv_filter_sizes:
        params["conv"].append(
            {
                "W": _glorot_uniform(
                    generator, (k, k, in_ch, n_out), k * k * in_ch, k * k * n_out
                ),
                "b": torch.zeros(n_out),
            }
        )
        in_ch = n_out
    n_flat = cfg.flat_features()
    params["fc1"] = {
        "W": _glorot_uniform(generator, (n_flat, cfg.fc1_size), n_flat, cfg.fc1_size),
        "b": torch.zeros(cfg.fc1_size),
    }
    fc2_in = cfg.bottleneck_out_size
    params["fc2"] = {
        "W": _glorot_uniform(generator, (fc2_in, cfg.n_classes), fc2_in, cfg.n_classes),
        "b": torch.zeros(cfg.n_classes),
    }
    return params


def _init_inception_stage(cfg: StageConfig, generator: torch.Generator) -> Params:
    """Trunk and classifier head. The trunk is the weights at
    ``cf.get("inception_weights_path")`` when that is set (the reference's
    pretrained download, network/inception_builder.py:39-65, replaced by a
    file the user provides), else the compact trunk drawn from
    ``generator``; then fc2 is drawn."""
    from .. import config as cf
    from . import inception

    weights_path = cf.get("inception_weights_path") if cf.has("inception_weights_path") else None
    if weights_path:
        backbone = inception.load_backbone_weights(weights_path, generator.device)
    else:
        backbone = inception.init_backbone(generator)
    fc2_in = cfg.bottleneck_out_size
    return {
        "backbone": backbone,
        "fc2": {
            "W": _glorot_uniform(generator, (fc2_in, cfg.n_classes), fc2_in, cfg.n_classes),
            "b": torch.zeros(cfg.n_classes),
        },
    }


def cast_params(params: Params, cfg: StageConfig) -> Params:
    """Weights pre-cast to the compute dtype, so repeated ``apply_stage``
    calls do not re-read the f32 masters (the stage-2 fc1 alone is 151 MB).
    fc2's bias stays f32: it is added to the f32 logits."""
    cdt = cfg.compute_dtype
    if cfg.backbone == "inception":
        from . import inception

        return {
            "backbone": inception.cast_backbone(params["backbone"], cdt),
            "fc2": {"W": params["fc2"]["W"].to(cdt), "b": params["fc2"]["b"].float()},
        }
    return {
        "conv": [{k: v.to(cdt) for k, v in layer.items()} for layer in params["conv"]],
        "fc1": {k: v.to(cdt) for k, v in params["fc1"].items()},
        "fc2": {"W": params["fc2"]["W"].to(cdt), "b": params["fc2"]["b"].float()},
    }


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF/XLA SAME padding: the lower side gets ``total // 2``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv_same(h: torch.Tensor, w_hwio: torch.Tensor, stride: int) -> torch.Tensor:
    k = w_hwio.shape[0]
    top, bottom = _same_pads(h.shape[2], k, stride)
    left, right = _same_pads(h.shape[3], k, stride)
    h = F.pad(h, (left, right, top, bottom))
    return F.conv2d(h, w_hwio.permute(3, 2, 0, 1), stride=stride)


def _max_pool_same(h: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max-pool with SAME padding and -inf fill (net_builder.py:6-17)."""
    top, bottom = _same_pads(h.shape[2], size, stride)
    left, right = _same_pads(h.shape[3], size, stride)
    h = F.pad(h, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(h, size, stride)


def dropout_keep_mask(shape, dropout_keep: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """The keep mask of inverted dropout, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < dropout_keep


def apply_stage(
    params: Params,
    cfg: StageConfig,
    x: torch.Tensor,
    bottleneck_in: Optional[torch.Tensor] = None,
    *,
    dropout_keep: float = 1.0,
    generator: Optional[torch.Generator] = None,
    dropout_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Forward pass.

    ``x``: (N, H, W, C) float32, already standardized; for an Inception
    stage also (N, 2048), rows the trunk already embedded (the frozen
    trunk's embed-once training, train/trainer.py), where only the head
    runs. Returns ``logits`` (N, 2), ``probs`` (N, 2) and ``bottleneck``
    (N, bottleneck_out_size), all float32.

    Training passes the f32 master weights: the casts to the compute dtype
    happen here, so gradients reach the masters through them (the
    inference path pre-casts with :func:`cast_params` instead). With
    ``dropout_keep`` < 1 the classifier input goes through inverted dropout
    with keep-probability semantics (tf.nn.dropout, JAX ``cnn.py:252-280``),
    its mask drawn from ``generator`` on the input's device
    (:func:`dropout_keep_mask`), or given as ``dropout_mask`` (a shard of a
    mask drawn for a whole batch); the bottleneck returned is the tensor
    before dropout.
    """
    cdt = cfg.compute_dtype
    if cfg.backbone == "inception":
        from . import inception

        if x.dim() == 2:
            fc1 = x.float()
        else:
            with annotate("rodc.trunk"):
                fc1 = inception.apply_backbone(params["backbone"], x, dtype=cdt)
    else:
        h = x.to(cdt).permute(0, 3, 1, 2)
        for layer in params["conv"]:
            h = _conv_same(h, layer["W"].to(cdt), cfg.conv_stride)
            h = h + layer["b"].to(cdt)[:, None, None]
            h = torch.relu(h)
            h = _max_pool_same(h, cfg.pooling_size, cfg.pooling_stride)
        h = h.permute(0, 2, 3, 1).flatten(1)  # no inferred size: a traced row count may be 0
        fc1 = torch.matmul(h, params["fc1"]["W"].to(cdt)) + params["fc1"]["b"].to(cdt)
        fc1 = torch.relu(fc1).float()

    if cfg.bottleneck_in_size is not None:
        if bottleneck_in is None:
            raise ValueError("stage expects a bottleneck_in tensor")
        bottleneck = torch.cat([fc1, bottleneck_in.float()], dim=1)
    else:
        bottleneck = fc1
    h2 = bottleneck
    if dropout_keep < 1.0:
        keep = dropout_mask
        if keep is None:
            if generator is None:
                raise ValueError("dropout requires a generator")
            keep = dropout_keep_mask(h2.shape, dropout_keep, generator, h2.device)
        h2 = torch.where(keep, h2 / dropout_keep, torch.zeros_like(h2))
    logits = (
        torch.matmul(h2.to(cdt), params["fc2"]["W"].to(cdt)).float()
        + params["fc2"]["b"].float()
    )
    probs = torch.softmax(logits, dim=-1)
    return {"logits": logits, "probs": probs, "bottleneck": bottleneck}


def stage_input_sizes(n_nets: int, img_size_max: int, increasing: bool = True) -> list:
    """Per-stage input resolutions: the halving rule of the reference's
    ``TrainCascadeApp.update_img_dimensions`` (48 with 3 nets -> [12, 24, 48])."""
    sizes = []
    for i in range(n_nets):
        size = img_size_max
        if increasing:
            for _ in range(n_nets - i - 1):
                size = int(size / 2)
        sizes.append(size)
    return sizes
