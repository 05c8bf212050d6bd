"""Kernel K2 on Hopper: stage-0 extraction of a scheduled (static) window
set, every window resampled inside its tile's aligned image cell.

Replaces the Pallas TPU kernel ``ops/windows_sched.py::_sched_kernel``
(driven by ``_run_class``/``extract_scheduled``) of the JAX package. The
CUDA source is ``csrc/sched.cu`` (the tap rule and the sums in
``csrc/cell_resample.cuh``).

What bounds it on an H100: the bytes. At FDDB density a 450x450 frame has
132,480 scheduled slots of 12x12x3 bf16 values, 114.5 MB of stores per
frame; the 1.2 MB bf16 frame sits in L2. A first port gathered the 2x2
support of every value from the L2 with per-value index arithmetic and ran
at about 6% of that bound. Now one block takes a tile and loops over the
frames: it builds the tile's taps once, compacts the source rows and
columns its taps use (bitmaps and ``__popc`` prefix counts), stages that
support from each frame into shared memory (about 15,200 L2 reads a tile
at the median instead of 55,296), samples every value from shared memory
into a bf16 output tile, and moves the tile with one bulk copy. A tile
whose support exceeds the staging budget of :func:`launch_geometry` is
sampled by gathers from the planes in the same kernel, with the same
values; :func:`staging_bytes` counts such tiles on the host.

The cell-local positions are computed in Python by the same torch
expressions the plain version uses (``windows_sched.scheduled_positions``),
so the kernel does only the taps, the gather, the two passes and the
quantization. Its plain version is ``windows_sched.resample_sched_plain``
at the same interface. A CUDA tensor goes to the kernel, a CPU tensor to
the plain version; there is no fallback between them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .windows_cuda import SMEM_LIMIT

# Kernel launches since the last reset: incremented only where the kernel
# is launched, so a run can show that its path went through the kernel.
LAUNCHES = 0

STAGING_BUDGET = 65536  # bytes of compacted support a block stages at most
MAP_BITS = 4096  # cell-local rows (columns) the kernel's bitmaps cover (kMapBits)


def launch_geometry(tile: int, out_h: int, out_w: int, c: int) -> Tuple[int, int]:
    """(dynamic shared-memory bytes, staging budget in bytes) of a K2
    launch: the bf16 output tile of ``tile`` slots (rounded up to 16
    bytes), the staging budget, 24 bytes a row entry and 24 a column entry
    (tables and lists), the two bitmaps with their prefix counts and two
    counts; ``csrc/sched.cu`` checks the same sum. The budget is
    :data:`STAGING_BUDGET`, or what is left under the 227 KB a block may
    have. Raises ``ValueError`` when the output tile and tables alone do
    not fit."""
    fixed = (
        -(-2 * tile * out_h * out_w * c // 16) * 16 + 24 * tile * out_h + 24 * tile * out_w
        + 16 * (MAP_BITS // 32) + 8
    )
    if fixed > SMEM_LIMIT:
        raise ValueError(
            "K2 keeps a tile of {} windows of {}x{}x{} in shared memory: {} bytes, more "
            "than {}".format(tile, out_h, out_w, c, fixed, SMEM_LIMIT)
        )
    budget = min(STAGING_BUDGET, (SMEM_LIMIT - fixed) // 16 * 16)
    return fixed + budget, budget


def _live_taps(s: np.ndarray, extent: np.ndarray, limit: np.ndarray) -> np.ndarray:
    """The kernel's tap rule (``rodc::cell_taps``) in float32 numpy: for
    positions ``s`` (n_tiles, k), the cell-local indices floor(s) and
    floor(s) + 1 of taps whose weight is not 0 (inside [0, extent)) and
    whose pixel lies before ``limit``, else -1; (n_tiles, 2 k)."""
    f = np.floor(s)
    out = []
    for k in (0, 1):
        i = f.astype(np.int64) + k
        w = np.maximum(np.float32(0), np.float32(1) - np.abs((f + np.float32(k)) - s))
        live = (w > 0) & (i >= 0) & (i < extent) & (i < limit)
        out.append(np.where(live, i, -1))
    return np.concatenate(out, axis=1)


def _distinct(idx: np.ndarray) -> np.ndarray:
    srt = np.sort(idx, axis=1)
    new = (np.diff(srt, axis=1) != 0) & (srt[:, 1:] >= 0)
    return new.sum(axis=1) + (srt[:, 0] >= 0)


def staging_bytes(sy_local, sx_local, tiles, tile: int, c: int, h: int, w: int) -> np.ndarray:
    """Each tile's compacted support in bytes by the kernel's rule, on the
    host: (distinct live source rows) x (distinct live source columns) x
    ``c`` x 2. ``sy_local`` (n_slots, out_h), ``sx_local`` (n_slots, out_w)
    and ``tiles`` (n_tiles, 4) as K2 takes them (tensors or arrays), frames
    of ``h`` x ``w``. A tile whose cell reaches more than :data:`MAP_BITS`
    rows or columns into the image has no bitmap and gets -1. The kernel
    stages a tile when 0 <= bytes <= its budget and samples the others from
    the planes."""
    sy = np.asarray(torch.as_tensor(sy_local).cpu(), dtype=np.float32)
    sx = np.asarray(torch.as_tensor(sx_local).cpu(), dtype=np.float32)
    tab = np.asarray(torch.as_tensor(tiles).cpu(), dtype=np.int64)
    n_tiles = tab.shape[0]
    row0, col0, cell_r, cell_c = (tab[:, k : k + 1] for k in range(4))
    rows = _live_taps(sy.reshape(n_tiles, -1), cell_r, h - row0)
    cols = _live_taps(sx.reshape(n_tiles, -1), cell_c, w - col0)
    out = _distinct(rows) * _distinct(cols) * c * 2
    mapped = (np.minimum(cell_r, h - row0) <= MAP_BITS) & (np.minimum(cell_c, w - col0) <= MAP_BITS)
    return np.where(mapped[:, 0], out, -1)


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
    if not 1 <= c <= 4:
        raise ValueError("K2 takes frames of 1 to 4 channels; got {}".format(c))
    if not (planes.device == sy_local.device == sx_local.device == tiles.device):
        raise ValueError("K2 operands must lie on one device")
    for t in (planes, sy_local, sx_local, tiles):
        if not t.is_contiguous():
            raise ValueError("K2 operands must be contiguous")
    out_h, out_w = sy_local.shape[1], sx_local.shape[1]
    smem, budget = launch_geometry(tile, out_h, out_w, c)
    out = torch.empty((b, n_slots, out_h, out_w, c), dtype=torch.bfloat16, device=planes.device)
    if out.numel() == 0:  # nothing to launch
        return out
    from . import _build

    fn = _build.load("sched").rodc_sched
    err = fn(
        planes.data_ptr(), sy_local.data_ptr(), sx_local.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), b, n_slots, c, h, w, out_h, out_w, tile, budget, smem,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K2 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    return out
