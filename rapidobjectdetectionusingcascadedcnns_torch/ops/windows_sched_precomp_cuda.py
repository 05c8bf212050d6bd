"""Kernel K2p on Hopper: scheduled stage-0 extraction with tap matrices
precomputed once per plan and read from device memory.

Replaces the Pallas TPU kernel ``tools/profile_sched_precomp.py:62``
(``_sched_kernel_pre``, driven by ``_run_class_pre``) of the JAX
package's profiling tool. The CUDA source is ``csrc/sched_precomp.cu``;
its plain version is ``windows_sched.resample_sched_precomp_plain`` at the
same interface, and the taps come from ``windows_sched.precompute_tap_matrices``.

What bounds it on an H100: the tap bytes. At FDDB density the tap
matrices of the 4,140 tiles are 1.6 GB, read once per call; the four
frames' bf16 output is 4 x 114.5 MB. One launch covers every cell class
and frame: :func:`class_table` numbers the blocks through the classes,
largest tiles first. A block streams its tile's RY and RX blocks through a
ring of bulk copies in shared memory, reduces each row and column to its
two taps (the first nonzero and the one after it), then samples every
frame through K2's staged support (``csrc/sched_tile.cuh``), bit-equal to
the dense contraction and to K2. Nonzero taps besides a row's or column's
two are counted on the device into :data:`VIOLATIONS`. A CUDA tensor goes
to the kernel, a CPU tensor to the plain version; there is no fallback
between them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import windows_sched_cuda

# Kernel launches since the last reset: incremented only where the kernel
# is launched (once per call), so a run can show that its path went
# through the kernel.
LAUNCHES = 0

# Two-tap violations since the last reset, per device: an int32 tensor on
# the device to which every launch adds the nonzero taps that lie outside
# [lo, lo + 1] of their row or column (lo its first nonzero). Reading it
# synchronises (violation_count); the launch does not. Reset by clearing
# the dict.
VIOLATIONS: Dict[torch.device, torch.Tensor] = {}

STAGES = 3  # ring stages of the tap stream (kStages)


def violation_count() -> int:
    """The two-tap violations counted since the last reset, on every
    device (synchronises with each)."""
    return sum(int(v.item()) for v in VIOLATIONS.values())


def launch_geometry(
    tile: int, out_h: int, out_w: int, c: int, stages: int = STAGES
) -> Tuple[int, int, int]:
    """(dynamic shared-memory bytes, staging budget, ring stage bytes) of a
    K2p launch: K2's block (``windows_sched_cuda.launch_geometry``) with
    the ring's two barriers a stage and the block's violation count, 8
    bytes. The ring of ``stages`` stages (the kernel's kStages) fills the
    output tile and the staging region, which phases 2-5 use only once the
    stream is done. ``csrc/sched_precomp.cu`` checks the same sums. Raises
    ``ValueError`` where K2's block does not fit."""
    smem, budget = windows_sched_cuda.launch_geometry(tile, out_h, out_w, c)
    ring = -(-2 * tile * out_h * out_w * c // 16) * 16 + budget
    return smem + 16 * stages + 8, budget, ring // stages // 16 * 16


def class_table(sched, taps: List[Tuple[torch.Tensor, torch.Tensor]]) -> np.ndarray:
    """(n_classes, 8) int64 rows of the kernel's class table, one per
    class with tiles: the addresses of its RY and RX matrices, RX's row
    stride in values, its first tile in slot order, its tile count, its
    first block, ``cell_r`` and ``cell_c``. The rows go by tap bytes a tile
    (RY's tile * out_h * cell_r and RX's cell_c * tile * out_w values),
    largest first, ties in schedule order, and number the blocks through
    them: block ``block0 + i`` takes tile ``tile0 + i``."""
    n_rows, n_cols = sched.tile * sched.out_h, sched.tile * sched.out_w
    rows = [
        [ry.data_ptr(), rx.data_ptr(), rx.shape[1], int(cls.sel[0]), cls.n_tiles, 0,
         cls.cell_r, cls.cell_c]
        for cls, (ry, rx) in zip(sched.classes, taps) if cls.n_tiles
    ]
    rows.sort(key=lambda r: -(n_rows * r[6] + r[7] * n_cols))
    table = np.array(rows, dtype=np.int64).reshape(-1, 8)
    table[:, 5] = np.concatenate([[0], np.cumsum(table[:-1, 4])]) if len(table) else []
    return table


def _device_table(sched, taps, device: torch.device) -> torch.Tensor:
    """The class table on ``device``, built and uploaded once per schedule
    and set of tap matrices (kept with the schedule's device tables)."""
    key = ("k2p classes", str(device))
    ptrs = tuple(m.data_ptr() for pair in taps for m in pair)
    cached = sched._device_tables.get(key)
    if cached is None or cached[0] != ptrs:
        cached = (ptrs, torch.as_tensor(class_table(sched, taps), device=device))
        sched._device_tables[key] = cached
    return cached[1]


def resample_sched_precomp_cuda(
    planes: torch.Tensor,
    taps: List[Tuple[torch.Tensor, torch.Tensor]],
    tiles: torch.Tensor,
    sched,
) -> torch.Tensor:
    """Launch K2p once over every cell class of ``sched``: ``planes`` (B,
    C, H, W) bf16, ``taps`` the per-class (RY, RX) bf16 matrices, ``tiles``
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
    b, c, h, w = planes.shape
    if not 1 <= c <= 4:
        raise ValueError("K2p takes frames of 1 to 4 channels; got {}".format(c))
    tile, out_h, out_w = sched.tile, sched.out_h, sched.out_w
    if (tile * out_h) % 8 or (tile * out_w) % 8:
        raise ValueError("K2p needs tile * out_h and tile * out_w to be multiples of 8")
    smem, budget, stage_bytes = launch_geometry(tile, out_h, out_w, c)
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
        # the bulk copies move 16-byte multiples between 16-byte aligned
        # addresses, and a ring stage holds at least one RY and one RX row
        if cls.cell_r % 8 or ry.data_ptr() % 16 or rx.data_ptr() % 16:
            raise ValueError("K2p needs cell_r a multiple of 8 and 16-byte aligned taps")
        if 2 * max(cls.cell_r, tile * out_w) > stage_bytes:
            raise ValueError("a {}-byte ring stage cannot hold a row of class {}x{}".format(
                stage_bytes, cls.cell_r, cls.cell_c))
    n_slots = sched.n_slots
    out = torch.empty((b, n_slots, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    if out.numel() == 0:  # nothing to launch
        return out
    table = _device_table(sched, taps, planes.device)
    violations = VIOLATIONS.get(planes.device)
    if violations is None:
        violations = torch.zeros(1, dtype=torch.int32, device=planes.device)
        VIOLATIONS[planes.device] = violations
    from . import _build

    fn = _build.load("sched_precomp").rodc_sched_precomp
    err = fn(
        planes.data_ptr(), table.data_ptr(), tiles.data_ptr(), out.data_ptr(),
        violations.data_ptr(), b, n_slots, table.shape[0], c, h, w, out_h, out_w, tile, budget,
        stage_bytes, smem, torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K2p launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out
