"""Checkpoints in the JAX package's npz+json format (counterpart of
train/checkpoint.py of the JAX package).

One ``.npz`` per stage with path-flattened leaf names (``conv/0/W``,
``conv/0/b``, ..., ``fc1/W``, ``fc2/b``) plus ``__mean__``/``__std__``, and
a ``.json`` sidecar holding the architecture (``stage_config``) and any
extra metadata. The files are the JAX package's own, so checkpoints
interchange: a stage saved here loads with the JAX package's
``checkpoint.load_stage``, and the reverse. The port reads the format with
``models/bridge.py`` (``load_stage``, ``load_cascade``), its one reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import cnn


def _flatten(params: cnn.Params) -> Dict[str, np.ndarray]:
    flat = {}
    for i, layer in enumerate(params["conv"]):
        for k in ("W", "b"):
            flat["conv/{}/{}".format(i, k)] = layer[k]
    for name in ("fc1", "fc2"):
        for k in ("W", "b"):
            flat["{}/{}".format(name, k)] = params[name][k]
    return {k: np.asarray(v.detach().float().cpu().numpy()) for k, v in flat.items()}


def stage_config_to_json(cfg: cnn.StageConfig) -> dict:
    """The JAX package's ``stage_config`` record of a stage."""
    return {
        "input_size": cfg.input_size,
        "channels": cfg.channels,
        "conv_filter_sizes": list(cfg.conv_filter_sizes),
        "conv_kernel": cfg.conv_kernel,
        "conv_stride": cfg.conv_stride,
        "pooling_size": cfg.pooling_size,
        "pooling_stride": cfg.pooling_stride,
        "fc1_size": cfg.fc1_size,
        "n_classes": cfg.n_classes,
        "bottleneck_in_size": cfg.bottleneck_in_size,
        "compute_dtype": "bfloat16" if cfg.compute_dtype == torch.bfloat16 else "float32",
        "backbone": "custom",
    }


def save_stage(
    path: str,
    params: cnn.Params,
    cfg: cnn.StageConfig,
    mean: np.ndarray,
    std: np.ndarray,
    extra_meta: Optional[dict] = None,
) -> str:
    """Persist one cascade stage (params + architecture + standardization);
    returns the ``.npz`` path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stem = path[:-4] if path.endswith(".npz") else path
    flat = _flatten(params)
    flat["__mean__"] = np.asarray(mean, np.float32)
    flat["__std__"] = np.asarray(std, np.float32)
    np.savez(stem + ".npz", **flat)
    meta = {"stage_config": stage_config_to_json(cfg)}
    if extra_meta:
        meta.update(extra_meta)
    with open(stem + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return stem + ".npz"


def cascade_stage_path(model_dir: str, session_key: str, stage: int) -> str:
    """Per-stage artifact path (the reference's ``graph_<key>_<stage>.pb``
    naming, train_cascade_app.py:183-201)."""
    return os.path.join(model_dir, "model_{}_{}.npz".format(session_key, stage))


def single_model_path(model_dir: str, session_key: str) -> str:
    return os.path.join(model_dir, "model_{}.npz".format(session_key))


def save_cascade(model_dir: str, session_key: str, model) -> List[str]:
    """Persist a ``CascadeModel`` as per-stage artifacts."""
    paths = []
    for i in range(model.n_nets):
        p = cascade_stage_path(model_dir, session_key, i)
        save_stage(
            p,
            model.stage_params[i],
            model.stage_configs[i],
            model.stage_means[i],
            model.stage_stds[i],
            extra_meta={"stage_index": i, "n_nets": model.n_nets},
        )
        paths.append(p)
    return paths
