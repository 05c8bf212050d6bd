"""Compute-device selection and numerics (counterpart of utils/device.py).

The device is an explicit ``torch.device`` passed to whatever allocates.
The default is the CUDA card; the CPU is used only when a caller asks for
it (``device="cpu"``, as the CPU tests do). Asking for CUDA, or leaving the
default, on a host without a card raises: there is no quiet fallback to the
CPU, so a run never reports CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the CUDA card; ``"cuda"``/``"cuda:N"`` -> that card;
    ``"cpu"`` -> the CPU. Asking for a card where there is none raises."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but torch.cuda.is_available() is False".format(
                str(device)
            )
        )
    return device


def upload(frames: Sequence, device: torch.device) -> torch.Tensor:
    """One batch tensor on ``device`` of host frames (numpy arrays) or of
    frames already on the card (tensors, stacked there, so that a caller
    that stages its frames keeps the upload out of what it times).

    To a card, host frames are stacked into pinned memory and copied with
    ``non_blocking=True`` on the current stream, so the host goes on
    enqueueing while the copy runs, as ``jnp.asarray`` returns at once in
    the JAX package; a copy from pageable memory would wait for the stream
    to drain. The pinned block comes from PyTorch's caching host
    allocator, which records the copy's event and reuses the block only
    after it. To the CPU the stack is used as it is."""
    if torch.is_tensor(frames[0]):
        return torch.stack(list(frames)).to(device)
    stacked = torch.from_numpy(np.stack(frames))
    if device.type == "cuda":
        return stacked.pin_memory().to(device, non_blocking=True)
    return stacked.to(device)


def set_numerics(compute_dtype: torch.dtype) -> None:
    """Counterpart of ``Precision.HIGHEST`` (models/cnn.py:205-208 of the JAX
    package): float32 compute runs float32 matmuls and convolutions, so
    TF32 is turned off for both cuBLAS and cuDNN. bfloat16 compute leaves
    the flags as they are."""
    if compute_dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


# what the CUDA runtime and its libraries put in the messages of the
# RuntimeErrors torch raises, and the port's kernel wrappers' launch errors
# ("K1 launch failed: cudaError 700")
_CUDA_ERROR_MARKS = ("CUDA error", "CUDA driver error", "cudaError", "CUBLAS_STATUS",
                     "CUDNN_STATUS", "cuDNN error")


def is_cuda_error(exc: BaseException) -> bool:
    """True for an error of the CUDA runtime (``torch.AcceleratorError``, or
    a ``RuntimeError`` whose message comes from CUDA, cuBLAS, cuDNN or a
    kernel launch). After one, the card's context may be unusable, so a
    caller that isolates failures re-raises these."""
    if isinstance(exc, getattr(torch, "AcceleratorError", ())):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _CUDA_ERROR_MARKS)
