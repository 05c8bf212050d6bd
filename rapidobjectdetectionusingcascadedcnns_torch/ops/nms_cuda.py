"""Kernel K3 on Hopper: groupRectangles clustering of the cascade's
last-stage survivors, batched over frames (the on-device NMS tail).

Replaces the Pallas TPU kernel ``ops/nms_pallas.py::_cluster_kernel``
(driven by ``group_rectangles_pallas``) of the JAX package, together with
the containment pass its caller applies: it computes the JAX package's
``group_rectangles_jax`` with eps as an argument and the label
propagation run to convergence (see ``nms.group_rectangles_device_plain``).
The CUDA source is ``csrc/cluster.cu``; its header says what each launch
computes.

What bounds it on an H100: the SimilarRects adjacency, B * N^2 * ~16 f32
operations (about 0.06 ms at 16 frames of N = 4096); the bytes in and out
are B * N * ~42. The TPU kernel keeps an (N, N) adjacency in VMEM, which
caps N near 1536; the tail meets N = 4096 on the VGA path's open rung and
N = 131,903 on the dense path's, so the adjacency is a bitmask in global
memory (32 MB at 16 x 4096, L2-resident).

Its plain version is ``nms.group_rectangles_device_plain`` at the same
interface. A CUDA tensor goes to the kernel, a CPU tensor to the plain
version; there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from . import nms

# Tail calls since the last reset (one per call, whatever the number of
# launches inside): incremented only where the kernel is launched.
LAUNCHES = 0
# propagation steps per call after the JAX tail's count, until one changes nothing
EXTRA_STEPS = 4
# propagation steps the last call ran (the JAX tail's count, or more)
LAST_STEPS = 0


def workspace_bytes(b: int, n: int) -> int:
    """Device workspace of one call: the adjacency bitmask, two label
    buffers, the per-slot counts and int64 sums, the status word."""
    words = (n + 31) // 32
    return b * n * words * 4 + b * n * (3 * 4 + 4 * 8) + 4


def group_rectangles_cuda(
    rects: torch.Tensor, valid: torch.Tensor, min_neighbors: int, eps: float = 0.2
):
    """Launch K3: ``rects`` (B, N, 4) float32 xywh with integer values and
    ``valid`` (B, N) bool, contiguous on one CUDA device -> ``avg`` (B, N,
    4) int32, ``counts`` (B, N) int32, ``keep`` (B, N) bool, ``labels``
    (B, N) int64, as :func:`nms.group_rectangles_device_plain`.

    Raises ``ValueError`` when the workspace does not fit in the card's
    free memory, and when a valid coordinate is not an integer or a
    cluster sum reaches 2^24. Synchronises once per round of propagation
    steps (to test convergence) and once on the status word."""
    global LAUNCHES, LAST_STEPS
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
    need = workspace_bytes(b, n)
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    if need > free:
        raise ValueError(
            "K3 at N = {} ({} frames) needs {} bytes of workspace; {} are free".format(
                n, b, need, free
            )
        )
    words = (n + 31) // 32
    adj = torch.empty(b * n * words, dtype=torch.int32, device=dev)
    label_a = torch.empty(b, n, dtype=torch.int32, device=dev)
    label_b = torch.empty(b, n, dtype=torch.int32, device=dev)
    counts_ws = torch.zeros(b, n, dtype=torch.int32, device=dev)
    sums_ws = torch.zeros(b, n, 4, dtype=torch.int64, device=dev)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    avg = torch.empty(b, n, 4, dtype=torch.int32, device=dev)
    counts = torch.empty(b, n, dtype=torch.int32, device=dev)
    keep = torch.empty(b, n, dtype=torch.bool, device=dev)
    labels = torch.empty(b, n, dtype=torch.int64, device=dev)
    from . import _build

    fn = _build.load("cluster").rodc_cluster
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(phase, steps=0):
        err = fn(
            phase, rects.data_ptr(), valid.data_ptr(), adj.data_ptr(), label_a.data_ptr(),
            label_b.data_ptr(), counts_ws.data_ptr(), sums_ws.data_ptr(), status.data_ptr(),
            changed.data_ptr(), avg.data_ptr(), counts.data_ptr(), keep.data_ptr(),
            labels.data_ptr(), b, n, steps, int(min_neighbors), ctypes.c_float(eps * 0.5),
            stream,
        )
        if err != 0:
            raise RuntimeError("K3 launch failed (phase {}): cudaError {}".format(phase, err))

    launch(0)
    steps, LAST_STEPS = nms.propagation_steps(n), 0
    while True:  # until a step leaves every label where it was
        changed.zero_()
        launch(1, steps)
        LAST_STEPS += steps
        if not int(changed.item()):
            break
        steps = EXTRA_STEPS
    launch(2)
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
