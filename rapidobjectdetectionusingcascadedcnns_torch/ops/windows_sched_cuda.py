"""Kernel K2 on Hopper: stage-0 extraction of a scheduled (static) window
set, every window resampled inside its tile's aligned image cell.

Replaces the Pallas TPU kernel ``ops/windows_sched.py::_sched_kernel``
(driven by ``_run_class``/``extract_scheduled``) of the JAX package. The
CUDA source is ``csrc/sched.cu`` (per-element arithmetic in
``csrc/cell_resample.cuh``).

What bounds it on an H100: the output. At FDDB density a 450x450 frame has
132,480 scheduled slots of 12x12x3 bf16 values, 114.5 MB of stores per
frame (about 34 us at 3.35 TB/s); the 1.2 MB bf16 frame sits in L2. The
design writes bf16 (half K1's f32 stores), one launch for every class and
frame, one CTA per (tile, frame) with contiguous, coalesced stores.

The cell-local positions are computed in Python by the same torch
expressions the plain version uses (``windows_sched.scheduled_positions``),
so the kernel does only the taps, the gather, the two passes and the
quantization. Its plain version is ``windows_sched.resample_sched_plain``
at the same interface. A CUDA tensor goes to the kernel, a CPU tensor to
the plain version; there is no fallback between them.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0


def resample_sched_cuda(
    planes: torch.Tensor,
    sy_local: torch.Tensor,
    sx_local: torch.Tensor,
    tiles: torch.Tensor,
    tile: int,
) -> torch.Tensor:
    """Launch K2: ``planes`` (B, C, H, W) bf16, ``sy_local`` (n_slots,
    out_h) and ``sx_local`` (n_slots, out_w) f32, ``tiles`` (n_tiles, 4)
    int32, all contiguous on one CUDA device, n_slots = n_tiles * tile ->
    (B, n_slots, out_h, out_w, C) bf16 on the u8 lattice."""
    global LAUNCHES
    if not planes.is_cuda:
        raise ValueError("K2 runs on CUDA tensors only; got {}".format(planes.device))
    if (
        planes.dtype != torch.bfloat16
        or sy_local.dtype != torch.float32
        or sx_local.dtype != torch.float32
        or tiles.dtype != torch.int32
    ):
        raise TypeError(
            "K2 takes bf16 planes, f32 positions and an int32 tile table; got "
            "{}, {}, {}, {}".format(planes.dtype, sy_local.dtype, sx_local.dtype, tiles.dtype)
        )
    if planes.dim() != 4 or sy_local.dim() != 2 or sx_local.dim() != 2 or tiles.dim() != 2:
        raise ValueError(
            "K2 takes planes (B, C, H, W), sy (n_slots, oh), sx (n_slots, ow), tiles (n_tiles, 4)"
        )
    b, c, h, w = planes.shape
    n_slots = sy_local.shape[0]
    if sx_local.shape[0] != n_slots or tiles.shape != (n_slots // tile, 4) or n_slots % tile:
        raise ValueError(
            "slot shapes {} / {} / {} do not match tile {}".format(
                tuple(sy_local.shape), tuple(sx_local.shape), tuple(tiles.shape), tile
            )
        )
    if not (planes.device == sy_local.device == sx_local.device == tiles.device):
        raise ValueError("K2 operands must lie on one device")
    for t in (planes, sy_local, sx_local, tiles):
        if not t.is_contiguous():
            raise ValueError("K2 operands must be contiguous")
    out_h, out_w = sy_local.shape[1], sx_local.shape[1]
    out = torch.empty((b, n_slots, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    from . import _build

    fn = _build.load("sched").rodc_sched
    err = fn(
        planes.data_ptr(), sy_local.data_ptr(), sx_local.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), b, n_slots, c, h, w, out_h, out_w, tile,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K2 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out
