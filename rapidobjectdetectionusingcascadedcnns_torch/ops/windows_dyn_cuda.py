"""Kernel K4 on Hopper: re-extraction of dynamic survivor boxes with the
contraction rows bounded to a 128-row lattice cell.

Replaces the Pallas TPU kernel ``ops/windows_dyn.py::_dyn_kernel`` (its
``pallas_call`` in ``extract_rowbound``) of the JAX package. The CUDA source
is ``csrc/rowbound.cu`` (per-element arithmetic in
``csrc/cell_resample.cuh``). It reads the original bf16 planes: the TPU's
four row-shifted lattice copies are a block-addressing device that a
per-element gather does not need.

What bounds it on an H100: the bf16 output stores (57 MB per frame for
16,512 boxes at 24 px); the bf16 frame sits in L2. One launch for all
frames, one CTA per (tile, frame).

The bookkeeping around the kernel (sort by cell, the big class through K1,
the overflow count, the merge) stays in PyTorch in ``ops/windows_dyn.py``.
Its plain version is ``windows_dyn.resample_rowbound_plain`` at the same
interface. A CUDA tensor goes to the kernel, a CPU tensor to the plain
version; there is no fallback between them.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0


def resample_rowbound_cuda(
    planes: torch.Tensor,
    sy_local: torch.Tensor,
    sx: torch.Tensor,
    cell_start: torch.Tensor,
    tile: int,
    cell_rows: int,
    w_pad: int,
) -> torch.Tensor:
    """Launch K4: ``planes`` (B, C, H, W) bf16, ``sy_local`` (B, n_pad,
    out_h) f32 rows relative to each tile's cell, ``sx`` (B, n_pad, out_w)
    f32 image columns, ``cell_start`` (B, n_tiles) int32 first row of each
    tile's cell, all contiguous on one CUDA device -> (B, n_pad, out_h,
    out_w, C) bf16 on the u8 lattice."""
    global LAUNCHES
    if not planes.is_cuda:
        raise ValueError("K4 runs on CUDA tensors only; got {}".format(planes.device))
    if (
        planes.dtype != torch.bfloat16
        or sy_local.dtype != torch.float32
        or sx.dtype != torch.float32
        or cell_start.dtype != torch.int32
    ):
        raise TypeError(
            "K4 takes bf16 planes, f32 positions and int32 cell starts; got "
            "{}, {}, {}, {}".format(planes.dtype, sy_local.dtype, sx.dtype, cell_start.dtype)
        )
    if planes.dim() != 4 or sy_local.dim() != 3 or sx.dim() != 3 or cell_start.dim() != 2:
        raise ValueError(
            "K4 takes planes (B, C, H, W), sy (B, n_pad, oh), sx (B, n_pad, ow), "
            "cell_start (B, n_tiles)"
        )
    b, c, h, w = planes.shape
    n_pad = sy_local.shape[1]
    if (
        sy_local.shape[0] != b
        or sx.shape[:2] != (b, n_pad)
        or n_pad % tile
        or cell_start.shape != (b, n_pad // tile)
    ):
        raise ValueError(
            "shapes {} / {} / {} do not match {} frames and tile {}".format(
                tuple(sy_local.shape), tuple(sx.shape), tuple(cell_start.shape), b, tile
            )
        )
    if not (planes.device == sy_local.device == sx.device == cell_start.device):
        raise ValueError("K4 operands must lie on one device")
    for t in (planes, sy_local, sx, cell_start):
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    out_h, out_w = sy_local.shape[2], sx.shape[2]
    out = torch.empty((b, n_pad, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    from . import _build

    fn = _build.load("rowbound").rodc_rowbound
    err = fn(
        planes.data_ptr(), sy_local.data_ptr(), sx.data_ptr(), cell_start.data_ptr(),
        out.data_ptr(), b, n_pad, c, h, w, out_h, out_w, tile, cell_rows, w_pad,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K4 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out
