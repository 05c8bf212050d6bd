"""Kernel K1 on Hopper: batched crop + bilinear resize of survivor boxes.

Replaces the Pallas TPU kernel ``ops/windows_pallas.py::_resample_kernel``
(driven by ``crop_and_resize_pallas``) of the JAX package. The CUDA source
is ``csrc/resample.cu``; its header says what it computes per element.

What bounds it on an H100: a gather of 4 bf16 pixels per output element and
one f32 store, so memory and latency, not arithmetic. A VGA bf16 frame is
1.8 MB and sits in the 50 MB L2; the stage-2 output at 16 frames x 256 boxes
x 48x48x3 is 113 MB of f32 stores. The design reads only each element's
2x2 support, where the TPU kernel had to build dense tap matrices for its
matmul unit.

The sampling positions are computed here by the same torch expressions the
plain version uses (``windows.sample_positions``), so the kernel does only
the taps, the gather, the two passes and the quantization. Its plain
version is ``windows.resample_plain`` at the same interface
(``windows.crop_and_resize_plain`` at the box interface). A CUDA tensor
goes to the kernel; a CPU tensor to the plain version; there is no
fallback between them.
"""

from __future__ import annotations

import torch

from . import windows

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0


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
    n, out_h, out_w = sy.shape[1], sy.shape[2], sx.shape[2]
    out = torch.empty((b, n, out_h, out_w, c), dtype=torch.float32, device=planes.device)
    from . import _build

    fn = _build.load("resample").rodc_resample
    err = fn(
        planes.data_ptr(), sy.data_ptr(), sx.data_ptr(), out.data_ptr(),
        b, n, c, h, w, out_h, out_w,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K1 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out


def crop_and_resize(
    images: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """K1's wrapper at the box interface: ``images`` (B, H, W, C) float32,
    ``boxes`` (B, N, 4) xyxy -> (B, N, out_h, out_w, C) float32 on the u8
    lattice. Through the ``rodc::resample`` operator (ops/library.py):
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    from . import library  # noqa: F401 (registers the operator)

    sy, sx = windows.sample_positions(
        boxes, images.shape[1], images.shape[2], out_h, out_w
    )
    planes = windows.to_planes_bf16(images)
    return torch.ops.rodc.resample(planes, sy.contiguous(), sx.contiguous())
