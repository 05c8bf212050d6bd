"""Kernel K3 on Hopper: groupRectangles clustering of the cascade's
last-stage survivors, batched over frames (the on-device NMS tail).

Replaces the Pallas TPU kernel ``ops/nms_pallas.py::_cluster_kernel``
(driven by ``group_rectangles_pallas``) of the JAX package, together with
the containment pass its caller applies: it computes the JAX package's
``group_rectangles_jax`` with eps as an argument and the labels at their
fixed point, the connected components of the SimilarRects graph (see
``nms.group_rectangles_device_plain``). The CUDA source is
``csrc/cluster.cu``; its header says what each launch computes.

What bounds it on an H100: the pair tests, B * N(N-1)/2 * ~16 f32
operations (0.032 ms at 16 frames of N = 4096); the bytes in and out are
B * N * ~46. The TPU kernel keeps an (N, N) adjacency in VMEM and
propagates labels step by step; here a lock-free union-find (hook to the
smaller root) reaches the components in one pass over the pairs, with no
adjacency stored: the workspace is O(B * N) (:func:`workspace_bytes`). A
call is four launches whatever the data, in one ctypes call, and one host
synchronisation, on the status word.

Its plain version is ``nms.group_rectangles_device_plain`` at the same
interface. A CUDA tensor goes to the kernel, a CPU tensor to the plain
version; there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

# Tail calls since the last reset (one per call, whatever the number of
# launches inside): incremented only where the kernel is launched.
LAUNCHES = 0


def workspace_bytes(b: int, n: int) -> int:
    """Device workspace of one call, one allocation: int64 sums (4 per
    row), int32 parents and counts (1 each per row), the int32 status
    word. O(B * N): no adjacency is stored."""
    return b * n * (4 * 8 + 2 * 4) + 4


def group_rectangles_cuda(
    rects: torch.Tensor, valid: torch.Tensor, min_neighbors: int, eps: float = 0.2
):
    """Launch K3: ``rects`` (B, N, 4) float32 xywh with integer values and
    ``valid`` (B, N) bool, contiguous on one CUDA device -> ``avg`` (B, N,
    4) int32, ``counts`` (B, N) int32, ``keep`` (B, N) bool, ``labels``
    (B, N) int64, as :func:`nms.group_rectangles_device_plain`.

    Raises ``ValueError`` when a valid coordinate is not an integer or a
    cluster sum reaches 2^24. Synchronises once, to read the status word."""
    global LAUNCHES
    if not rects.is_cuda:
        raise ValueError("K3 runs on CUDA tensors only; got {}".format(rects.device))
    if rects.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            "K3 takes f32 rects and a bool mask; got {}, {}".format(rects.dtype, valid.dtype)
        )
    if rects.dim() != 3 or rects.shape[2] != 4 or valid.shape != rects.shape[:2]:
        raise ValueError(
            "K3 takes rects (B, N, 4) and valid (B, N); got {} / {}".format(
                tuple(rects.shape), tuple(valid.shape)
            )
        )
    if rects.device != valid.device:
        raise ValueError("K3 operands must lie on one device")
    if not (rects.is_contiguous() and valid.is_contiguous()):
        raise ValueError("K3 operands must be contiguous")
    b, n = valid.shape
    dev = rects.device
    avg = torch.empty(b, n, 4, dtype=torch.int32, device=dev)
    counts = torch.empty(b, n, dtype=torch.int32, device=dev)
    keep = torch.empty(b, n, dtype=torch.bool, device=dev)
    labels = torch.empty(b, n, dtype=torch.int64, device=dev)
    if b * n == 0:  # nothing to launch
        return avg, counts, keep, labels
    workspace = torch.empty((workspace_bytes(b, n) + 7) // 8, dtype=torch.int64, device=dev)
    # the status word follows the sums (8 int32 a row), parents and counts
    status = workspace.view(torch.int32)[b * n * 10]
    from . import _build

    err = _build.load("cluster").rodc_cluster(
        rects.data_ptr(), valid.data_ptr(), workspace.data_ptr(), avg.data_ptr(),
        counts.data_ptr(), keep.data_ptr(), labels.data_ptr(), b, n, int(min_neighbors),
        ctypes.c_float(eps * 0.5), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("K3 launch failed: cudaError {}".format(err))
    LAUNCHES += 1
    flags = int(status.item())
    if flags & 1:
        raise ValueError("the device NMS tail takes integer coordinates")
    if flags & 2:
        raise ValueError("a cluster's coordinate sum reaches 2^24")
    return avg, counts, keep, labels


def group_rectangles(
    rects: torch.Tensor, valid: torch.Tensor, min_neighbors: int, eps: float = 0.2
):
    """K3's wrapper, through the ``rodc::cluster`` operator
    (ops/library.py): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    from . import library  # noqa: F401 (registers the operator)

    return torch.ops.rodc.cluster(rects, valid, int(min_neighbors), float(eps))
