"""The port's kernels as PyTorch custom operators, so that ``torch.export``
records each one as a single graph node and a serving bundle runs the same
kernels as the live detector.

  * ``rodc::resample`` -- K1 (``windows_cuda.crop_and_resize_cuda``);
  * ``rodc::sched`` -- K2 (``windows_sched_cuda.resample_sched_cuda``);
  * ``rodc::cluster`` -- K3 (``nms_cuda.group_rectangles_cuda``).

Each op has a fake implementation (output shapes and dtypes, for tracing),
a CUDA implementation that launches the kernel and a CPU implementation
that is the kernel's plain version. The fakes take every size from their
inputs' shapes and make none a Python int, so they hold under the
symbolic frame count of a dynamic-batch bundle; a program moved to
another device dispatches each op to that device's implementation. K4 is not an op: its overflow policy
lives on the host, and bundles refuse it.

Importing this module registers the ops; a loader imports it before
``torch.export.load``. Nothing is built at import time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import nms, nms_cuda, windows, windows_cuda, windows_sched, windows_sched_cuda

Tensor = torch.Tensor


@torch.library.custom_op("rodc::resample", mutates_args=(), device_types="cpu")
def resample(planes: Tensor, sy: Tensor, sx: Tensor) -> Tensor:
    """K1: ``planes`` (B, C, H, W) bf16, ``sy`` (B, N, oh), ``sx`` (B, N,
    ow) f32 -> (B, N, oh, ow, C) f32 on the u8 lattice."""
    return windows.resample_plain(planes, sy, sx)


@resample.register_kernel("cuda")
def _(planes, sy, sx):
    return windows_cuda.crop_and_resize_cuda(planes, sy.contiguous(), sx.contiguous())


@resample.register_fake
def _(planes, sy, sx):
    b, c = planes.shape[0], planes.shape[1]
    return planes.new_empty((b, sy.shape[1], sy.shape[2], sx.shape[2], c), dtype=torch.float32)


@torch.library.custom_op("rodc::sched", mutates_args=(), device_types="cpu")
def sched(planes: Tensor, sy_local: Tensor, sx_local: Tensor, tiles: Tensor, tile: int) -> Tensor:
    """K2: ``planes`` (B, C, H, W) bf16, cell-local ``sy_local`` (n_slots,
    oh) and ``sx_local`` (n_slots, ow) f32, ``tiles`` (n_tiles, 4) int32 ->
    (B, n_slots, oh, ow, C) bf16 in scheduled order."""
    return windows_sched.resample_sched_plain(planes, sy_local, sx_local, tiles, tile)


@sched.register_kernel("cuda")
def _(planes, sy_local, sx_local, tiles, tile):
    return windows_sched_cuda.resample_sched_cuda(
        planes, sy_local.contiguous(), sx_local.contiguous(), tiles.contiguous(), tile
    )


@sched.register_fake
def _(planes, sy_local, sx_local, tiles, tile):
    b, c = planes.shape[0], planes.shape[1]
    return planes.new_empty(
        (b, sy_local.shape[0], sy_local.shape[1], sx_local.shape[1], c), dtype=torch.bfloat16
    )


@torch.library.custom_op("rodc::cluster", mutates_args=(), device_types="cpu")
def cluster(
    rects: Tensor, valid: Tensor, min_neighbors: int, eps: float
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K3: ``rects`` (B, N, 4) f32 xywh, ``valid`` (B, N) bool -> avg (B,
    N, 4) int32, counts (B, N) int32, keep (B, N) bool, labels (B, N)
    int64."""
    return nms.group_rectangles_device_plain(rects, valid, min_neighbors, eps)


@cluster.register_kernel("cuda")
def _(rects, valid, min_neighbors, eps):
    return nms_cuda.group_rectangles_cuda(
        rects.contiguous(), valid.contiguous(), min_neighbors, eps
    )


@cluster.register_fake
def _(rects, valid, min_neighbors, eps):
    b, n = valid.shape
    return (
        rects.new_empty((b, n, 4), dtype=torch.int32),
        rects.new_empty((b, n), dtype=torch.int32),
        rects.new_empty((b, n), dtype=torch.bool),
        rects.new_empty((b, n), dtype=torch.int64),
    )
