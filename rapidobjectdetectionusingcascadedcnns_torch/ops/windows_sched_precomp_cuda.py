"""Kernel K2p on Hopper: scheduled stage-0 extraction with tap matrices
precomputed once per plan and read from device memory.

Replaces the Pallas TPU kernel ``tools/profile_sched_precomp.py:62``
(``_sched_kernel_pre``, driven by ``_run_class_pre``) of the JAX
package's profiling tool. The CUDA source is ``csrc/sched_precomp.cu``;
its plain version is ``windows_sched.resample_sched_precomp_plain`` at the
same interface, and the taps come from ``windows_sched.precompute_tap_matrices``.

What bounds it on an H100: the weight bytes. At FDDB density the tap
matrices of the 4,140 tiles are 1.6 GB, read once per launch set; the four
frames' bf16 output is 4 x 114.5 MB. One CTA per tile streams its RY rows
and RX columns once (16-byte loads), keeps each row's and column's two
nonzero taps in shared memory and computes every frame's outputs from
their 2x2 support, bit-equal to the dense contraction and to K2. One
launch per cell class (the classes' cells differ in size). A CUDA tensor
goes to the kernel, a CPU tensor to the plain version; there is no
fallback between them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

# Kernel launches since the last reset: incremented only where the kernel
# is launched (once per cell class), so a run can show that its path went
# through the kernel.
LAUNCHES = 0


def resample_sched_precomp_cuda(
    planes: torch.Tensor,
    taps: List[Tuple[torch.Tensor, torch.Tensor]],
    tiles: torch.Tensor,
    sched,
) -> torch.Tensor:
    """Launch K2p once per cell class of ``sched``: ``planes`` (B, C, H, W)
    bf16, ``taps`` the per-class (RY, RX) bf16 matrices, ``tiles``
    (n_tiles, 4) int32, all contiguous on one CUDA device -> (B, n_slots,
    out_h, out_w, C) bf16 on the u8 lattice in scheduled order."""
    global LAUNCHES
    if not planes.is_cuda:
        raise ValueError("K2p runs on CUDA tensors only; got {}".format(planes.device))
    if planes.dtype != torch.bfloat16 or tiles.dtype != torch.int32:
        raise TypeError(
            "K2p takes bf16 planes and an int32 tile table; got {}, {}".format(
                planes.dtype, tiles.dtype
            )
        )
    if planes.dim() != 4 or tiles.shape != (sched.n_tiles, 4):
        raise ValueError("K2p takes planes (B, C, H, W) and tiles (n_tiles, 4)")
    if len(taps) != len(sched.classes):
        raise ValueError("one (RY, RX) pair per cell class: {} for {}".format(
            len(taps), len(sched.classes)))
    tile, out_h, out_w = sched.tile, sched.out_h, sched.out_w
    if (tile * out_h) % 8 or (tile * out_w) % 8:
        raise ValueError("K2p needs tile * out_h and tile * out_w to be multiples of 8")
    for t in [planes, tiles] + [m for pair in taps for m in pair]:
        if t.device != planes.device or not t.is_contiguous():
            raise ValueError("K2p operands must be contiguous on one device")
    for cls, (ry, rx) in zip(sched.classes, taps):
        if ry.dtype != torch.bfloat16 or rx.dtype != torch.bfloat16:
            raise TypeError("K2p taps must be bf16")
        if ry.shape != (cls.n_tiles * tile * out_h, cls.cell_r) or rx.shape != (
            cls.cell_c, cls.n_tiles * tile * out_w
        ):
            raise ValueError("tap shapes {} / {} do not match class {}x{} of {} tiles".format(
                tuple(ry.shape), tuple(rx.shape), cls.cell_r, cls.cell_c, cls.n_tiles))
        if cls.n_tiles and int(cls.sel[-1]) - int(cls.sel[0]) + 1 != cls.n_tiles:
            raise ValueError("a class's tiles must be contiguous in slot order")
    b, c, h, w = planes.shape
    n_slots = sched.n_slots
    out = torch.empty((b, n_slots, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    from . import _build

    fn = _build.load("sched_precomp").rodc_sched_precomp
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    for cls, (ry, rx) in zip(sched.classes, taps):
        if cls.n_tiles == 0:
            continue
        tile0 = int(cls.sel[0])
        err = fn(
            planes.data_ptr(), ry.data_ptr(), rx.data_ptr(), tiles.data_ptr(), out.data_ptr(),
            b, n_slots, tile0 * tile, tile0, cls.n_tiles, c, h, w, out_h, out_w, tile,
            cls.cell_r, cls.cell_c, stream,
        )
        if err != 0:
            raise RuntimeError("K2p launch failed: cudaError {}".format(err))
        LAUNCHES += 1
    return out
