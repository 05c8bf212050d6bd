"""Weight bridge: JAX-package parameters and checkpoints into the port.

Parameters are converted, never re-drawn: a JAX stage pytree (numpy or jax
arrays, ``{"conv": [{"W", "b"}], "fc1", "fc2"}``, conv weights in HWIO)
becomes the same dictionary of float32 tensors, and the npz+json stage
format of train/checkpoint.py:102-194 is read with numpy alone, so a
checkpoint written by the JAX trainer runs in the port unchanged. An
Inception stage's ``{"backbone", "fc2"}`` tree (the compact trunk or the
``v3`` one) comes across the same way, its trunk's conv weights transposed
once to OIHW (models/inception.py).
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .cnn import Params, StageConfig


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def params_from_numpy(tree, device=None) -> Params:
    """One stage's pytree (array leaves with an ``__array__``) -> port params
    on ``device`` (default: the CUDA card; ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    if "backbone" in tree:
        from . import inception

        return {
            "backbone": inception.backbone_from_numpy(tree["backbone"], device),
            "fc2": {k: _tensor(tree["fc2"][k], device) for k in ("W", "b")},
        }
    return {
        "conv": [
            {"W": _tensor(layer["W"], device), "b": _tensor(layer["b"], device)}
            for layer in tree["conv"]
        ],
        "fc1": {k: _tensor(tree["fc1"][k], device) for k in ("W", "b")},
        "fc2": {k: _tensor(tree["fc2"][k], device) for k in ("W", "b")},
    }


def _dtype_from_name(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def stage_config_from_jax(cfg) -> StageConfig:
    """A JAX ``StageConfig`` (read by attribute, jax is not imported)."""
    return StageConfig(
        input_size=cfg.input_size,
        channels=cfg.channels,
        conv_filter_sizes=tuple(cfg.conv_filter_sizes),
        conv_kernel=cfg.conv_kernel,
        conv_stride=cfg.conv_stride,
        pooling_size=cfg.pooling_size,
        pooling_stride=cfg.pooling_stride,
        fc1_size=cfg.fc1_size,
        n_classes=cfg.n_classes,
        bottleneck_in_size=cfg.bottleneck_in_size,
        compute_dtype=_dtype_from_name(cfg.compute_dtype.__name__),
        backbone=getattr(cfg, "backbone", "custom"),
    )


def cascade_model_from_jax_arrays(
    stage_params: Sequence, stage_configs: Sequence, stage_means, stage_stds,
    device=None,
):
    """The fields of a JAX ``CascadeModel`` -> the port's ``CascadeModel`` on
    ``device`` (default: the CUDA card; ``"cpu"`` for the CPU)."""
    from .cascade import CascadeModel

    device = resolve_device(device)
    return CascadeModel(
        [params_from_numpy(p, device) for p in stage_params],
        [stage_config_from_jax(c) for c in stage_configs],
        # copies: a jax array's numpy view is read-only, and the detector
        # wraps these arrays as CPU tensors without copying
        [np.array(m, np.float32) for m in stage_means],
        [np.array(s, np.float32) for s in stage_stds],
    )


def _stage_config_from_json(d: dict) -> StageConfig:
    return StageConfig(
        input_size=d["input_size"],
        channels=d["channels"],
        conv_filter_sizes=tuple(d["conv_filter_sizes"]),
        conv_kernel=d["conv_kernel"],
        conv_stride=d["conv_stride"],
        pooling_size=d["pooling_size"],
        pooling_stride=d["pooling_stride"],
        fc1_size=d["fc1_size"],
        n_classes=d["n_classes"],
        bottleneck_in_size=d["bottleneck_in_size"],
        compute_dtype=_dtype_from_name(d["compute_dtype"]),
        backbone=d.get("backbone", "custom"),
    )


def load_stage(
    path: str, device=None
) -> Tuple[Params, StageConfig, np.ndarray, np.ndarray, dict]:
    """Read one stage written by the JAX package's ``checkpoint.save_stage``:
    ``<path>.npz`` (path-flattened leaves plus ``__mean__``/``__std__``) and
    its ``<path>.json`` sidecar. Returns (params, config, mean, std, meta),
    the parameters on ``device`` (default: the CUDA card). An Inception
    stage's trunk is read from its ``backbone/`` leaves, compact or ``v3``
    (the JAX package's own reader rebuilds only the compact one)."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with open(npz_path[:-4] + ".json") as f:
        meta = json.load(f)
    cfg = _stage_config_from_json(meta["stage_config"])
    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    mean = flat.pop("__mean__")
    std = flat.pop("__std__")
    if cfg.backbone == "inception":
        from . import inception

        trunk = {k[len("backbone/"):]: v for k, v in flat.items() if k.startswith("backbone/")}
        tree = {
            "backbone": inception.tree_from_flat(trunk),
            "fc2": {"W": flat["fc2/W"], "b": flat["fc2/b"]},
        }
        return params_from_numpy(tree, device), cfg, mean, std, meta
    tree = {
        "conv": [
            {"W": flat["conv/{}/W".format(i)], "b": flat["conv/{}/b".format(i)]}
            for i in range(len(cfg.conv_filter_sizes))
        ],
        "fc1": {"W": flat["fc1/W"], "b": flat["fc1/b"]},
        "fc2": {"W": flat["fc2/W"], "b": flat["fc2/b"]},
    }
    return params_from_numpy(tree, device), cfg, mean, std, meta


def load_cascade(model_dir: str, session_key: str, device=None):
    """Load ``model_<session_key>_<stage>.npz`` stages until one is missing
    (the JAX package's ``checkpoint.load_cascade`` naming and probing),
    onto ``device`` (default: the CUDA card; ``"cpu"`` for the CPU)."""
    from .cascade import CascadeModel

    device = resolve_device(device)
    params_list, cfg_list, means, stds = [], [], [], []
    while True:
        p = os.path.join(
            model_dir, "model_{}_{}.npz".format(session_key, len(params_list))
        )
        if not os.path.exists(p):
            break
        params, cfg, mean, std, _ = load_stage(p, device)
        params_list.append(params)
        cfg_list.append(cfg)
        means.append(mean)
        stds.append(std)
    if len(params_list) < 2:
        raise FileNotFoundError(
            "a cascade needs at least two stage files for session {} in {}; "
            "found {}".format(session_key, model_dir, len(params_list))
        )
    return CascadeModel(params_list, cfg_list, means, stds)


def load_single(
    model_dir: str, session_key: str, device=None
) -> Tuple[Params, StageConfig, np.ndarray, np.ndarray, dict]:
    """Load the single-net artifact ``model_<session_key>.npz`` (the JAX
    package's ``checkpoint.load_single`` naming) onto ``device`` (default:
    the CUDA card; ``"cpu"`` for the CPU). Returns (params, config, mean,
    std, meta), as :func:`load_stage`."""
    device = resolve_device(device)
    path = os.path.join(model_dir, "model_{}.npz".format(session_key))
    if not os.path.exists(path):
        raise FileNotFoundError("Could not find the required model file: " + path)
    return load_stage(path, device)
