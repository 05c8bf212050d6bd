"""Kernel K4 on Hopper: re-extraction of dynamic survivor boxes with the
contraction rows bounded to a 128-row lattice cell.

Replaces the Pallas TPU kernel ``ops/windows_dyn.py::_dyn_kernel`` (its
``pallas_call`` in ``extract_rowbound``) of the JAX package. The CUDA source
is ``csrc/rowbound.cu`` (the tap rule and the sums in
``csrc/cell_resample.cuh``). It reads the original bf16 planes: the TPU's
four row-shifted lattice copies are a block-addressing device that a gather
does not need.

What bounds it on an H100: the bytes, mostly its bf16 stores (57 MB per
frame for 16,512 boxes at 24 px); the bf16 frame sits in L2. A first port
computed every value alone, with four runtime divisions, its taps and a
2x2 gather each, and ran at about 6% of that bound. The design is K1's
(``ops/windows_cuda.py``): a block stages a few consecutive slots through
shared memory -- taps once per row and column, a vertical pass over
neighbouring columns of one plane, a horizontal pass into a bf16 output
tile -- and moves the tile with one bulk copy. :func:`launch_geometry`
says how many slots a block takes and how much shared memory it needs; a
block may span two tiles, and each slot reads its own tile's cell.

The bookkeeping around the kernel (sort by cell, the big class through K1,
the overflow count, the merge) stays in PyTorch in ``ops/windows_dyn.py``.
Its plain version is ``windows_dyn.resample_rowbound_plain`` at the same
interface. A CUDA tensor goes to the kernel, a CPU tensor to the plain
version; there is no fallback between them.
"""

from __future__ import annotations

from typing import Tuple

import torch

# a block takes consecutive slots until it has at least MIN_BLOCK_VALUES
# output values (12 px: 5 slots; 24 px: 2; 48 px: 1), as K1's boxes
from .windows_cuda import MIN_BLOCK_VALUES, SMEM_LIMIT

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0


def launch_geometry(out_h: int, out_w: int, c: int) -> Tuple[int, int]:
    """(slots per block, dynamic shared-memory bytes) of a K4 launch.

    Per slot: the bf16 output tile (2 bytes a value; the block's tile
    rounded up to 16 bytes), the bf16 intermediate of 2 * out_w columns (4
    bytes a value), 24 bytes a row (taps, slot, frame), 16 a column (source
    columns, weights) and 4 (the cell's first row); ``csrc/rowbound.cu``
    checks the same sum. Raises ``ValueError`` when one slot does not
    fit."""
    per_slot = out_h * out_w * c

    def smem(n: int) -> int:
        tile_bytes = -(-2 * n * per_slot // 16) * 16
        return tile_bytes + n * (4 * per_slot + 24 * out_h + 16 * out_w + 4)

    if smem(1) > SMEM_LIMIT:
        raise ValueError(
            "K4 stages a slot through shared memory: {}x{}x{} needs {} bytes, more than "
            "the {}-byte shared-memory limit".format(out_h, out_w, c, smem(1), SMEM_LIMIT)
        )
    per_block = max(1, -(-MIN_BLOCK_VALUES // per_slot))
    while smem(per_block) > SMEM_LIMIT:
        per_block -= 1
    return per_block, smem(per_block)


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
    if not 1 <= c <= 4:
        raise ValueError("K4 takes frames of 1 to 4 channels; got {}".format(c))
    if not (planes.device == sy_local.device == sx.device == cell_start.device):
        raise ValueError("K4 operands must lie on one device")
    for t in (planes, sy_local, sx, cell_start):
        if not t.is_contiguous():
            raise ValueError("K4 operands must be contiguous")
    out_h, out_w = sy_local.shape[2], sx.shape[2]
    per_block, smem = launch_geometry(out_h, out_w, c)
    out = torch.empty((b, n_pad, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    if out.numel() == 0:  # nothing to launch
        return out
    from . import _build

    fn = _build.load("rowbound").rodc_rowbound
    err = fn(
        planes.data_ptr(), sy_local.data_ptr(), sx.data_ptr(), cell_start.data_ptr(),
        out.data_ptr(), b, n_pad, c, h, w, out_h, out_w, tile, cell_rows, w_pad,
        per_block, smem, torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K4 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out
