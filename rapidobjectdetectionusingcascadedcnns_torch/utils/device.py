"""Compute-device selection and numerics (counterpart of utils/device.py).

The device is an explicit ``torch.device`` passed to whatever allocates.
Asking for CUDA on a host without a card raises: there is no quiet fallback
to the CPU, so a run never reports CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> CPU; ``"cuda"``/``"cuda:N"`` -> that card, or raise."""
    device = torch.device("cpu" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but torch.cuda.is_available() is False".format(
                str(device)
            )
        )
    return device


def set_numerics(compute_dtype: torch.dtype) -> None:
    """Counterpart of ``Precision.HIGHEST`` (models/cnn.py:205-208 of the JAX
    package): float32 compute runs float32 matmuls and convolutions, so
    TF32 is turned off for both cuBLAS and cuDNN. bfloat16 compute leaves
    the flags as they are."""
    if compute_dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
