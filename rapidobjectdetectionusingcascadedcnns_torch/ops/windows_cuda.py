"""Kernel K1 on Hopper: batched crop + bilinear resize of survivor boxes.

Replaces the Pallas TPU kernel ``ops/windows_pallas.py::_resample_kernel``
(driven by ``crop_and_resize_pallas``) of the JAX package. The CUDA source
is ``csrc/resample.cu``; its header says what it computes per value.

What bounds it on an H100: its f32 stores (the stage-2 output at 16 frames
x 256 boxes x 48x48x3 is 113 MB); the 2x2 bf16 gathers mostly hit the
L2. The design stages each box through shared memory -- taps once per row
and column, a vertical pass over neighbouring columns of one plane, a
horizontal pass into an output tile -- and writes the box's contiguous
output with one bulk copy, where the TPU kernel had to build dense tap
matrices for its matmul unit. :func:`launch_geometry` says how many boxes
a block takes and how much shared memory it needs.

The sampling positions are computed here by the same torch expressions the
plain version uses (``windows.sample_positions``), so the kernel does only
the taps, the gather, the two passes and the quantization. Its plain
version is ``windows.resample_plain`` at the same interface
(``windows.crop_and_resize_plain`` at the box interface). A CUDA tensor
goes to the kernel; a CPU tensor to the plain version; there is no
fallback between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import windows

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0

# a block takes consecutive boxes until it has at least this many output
# values (12 px: 5 boxes; 24 px: 2; 48 px: 1)
MIN_BLOCK_VALUES = 2048
SMEM_LIMIT = 232448  # dynamic shared memory one block may have on Hopper (227 KB)


def launch_geometry(out_h: int, out_w: int, c: int) -> Tuple[int, int]:
    """(boxes per block, dynamic shared-memory bytes) of a K1 launch.

    Per box: the f32 output tile (4 bytes a value), the bf16 intermediate
    of 2 * out_w columns (4 bytes a value), 16 bytes of taps per column and
    24 per row (taps, the row's box and frame). Raises ``ValueError`` when
    one box does not fit."""
    per_box = out_h * out_w * c
    box_bytes = 8 * per_box + 24 * out_h + 16 * out_w
    if box_bytes > SMEM_LIMIT:
        raise ValueError(
            "K1 stages a box through shared memory: {}x{}x{} needs {} bytes, more than "
            "{}".format(out_h, out_w, c, box_bytes, SMEM_LIMIT)
        )
    per_block = max(1, min(-(-MIN_BLOCK_VALUES // per_box), SMEM_LIMIT // box_bytes))
    return per_block, per_block * box_bytes


def crop_and_resize_cuda(
    planes: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
) -> torch.Tensor:
    """Launch K1: ``planes`` (B, C, H, W) bf16, ``sy`` (B, N, out_h) f32,
    ``sx`` (B, N, out_w) f32, all contiguous on one CUDA device ->
    (B, N, out_h, out_w, C) float32 on the u8 lattice. One launch for all
    frames."""
    global LAUNCHES
    if not planes.is_cuda:
        raise ValueError("K1 runs on CUDA tensors only; got {}".format(planes.device))
    if planes.dtype != torch.bfloat16 or sy.dtype != torch.float32 or sx.dtype != torch.float32:
        raise TypeError(
            "K1 takes bf16 planes and f32 positions; got {}, {}, {}".format(
                planes.dtype, sy.dtype, sx.dtype
            )
        )
    if planes.dim() != 4 or sy.dim() != 3 or sx.dim() != 3:
        raise ValueError("K1 takes planes (B, C, H, W), sy (B, N, oh), sx (B, N, ow)")
    b, c, h, w = planes.shape
    if sy.shape[:2] != (b, sx.shape[1]) or sx.shape[0] != b:
        raise ValueError(
            "position shapes {} / {} do not match {} frames".format(
                tuple(sy.shape), tuple(sx.shape), b
            )
        )
    if not (planes.device == sy.device == sx.device):
        raise ValueError("K1 operands must lie on one device")
    for t in (planes, sy, sx):
        if not t.is_contiguous():
            raise ValueError("K1 operands must be contiguous")
    if not 1 <= c <= 4:
        raise ValueError("K1 takes frames of 1 to 4 channels; got {}".format(c))
    n, out_h, out_w = sy.shape[1], sy.shape[2], sx.shape[2]
    per_block, smem = launch_geometry(out_h, out_w, c)
    out = torch.empty((b, n, out_h, out_w, c), dtype=torch.float32, device=planes.device)
    if out.numel() == 0:  # nothing to launch (a frame with no boxes)
        return out
    from . import _build

    fn = _build.load("resample").rodc_resample
    err = fn(
        planes.data_ptr(), sy.data_ptr(), sx.data_ptr(), out.data_ptr(),
        b, n, c, h, w, out_h, out_w, per_block, smem,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K1 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out


def crop_and_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_h: int,
    out_w: int,
    planes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1's wrapper at the box interface: ``images`` (B, H, W, C) float32,
    ``boxes`` (B, N, 4) xyxy -> (B, N, out_h, out_w, C) float32 on the u8
    lattice. Through the ``rodc::resample`` operator (ops/library.py):
    the kernel for a CUDA tensor, the plain version for a CPU tensor.

    ``planes``: the frames' ready bf16 planes
    (``windows.to_planes_bf16(images)``), so that a caller that samples the
    same frames several times converts them once."""
    from . import library  # noqa: F401 (registers the operator)

    sy, sx = windows.sample_positions(
        boxes, images.shape[1], images.shape[2], out_h, out_w
    )
    if planes is None:
        planes = windows.to_planes_bf16(images)
    return torch.ops.rodc.resample(planes, sy.contiguous(), sx.contiguous())
