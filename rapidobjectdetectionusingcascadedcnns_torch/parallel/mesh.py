"""Device meshes of one process (counterpart of parallel/mesh.py of the JAX
package).

The JAX mesh is single-controller: one process drives every local device,
and ``jit`` inserts the collectives. The port keeps that model. A mesh is
an ordered tuple of ``torch.device``s of this process (:class:`Mesh`),
whose one axis keeps the JAX name :data:`DATA_AXIS`:

  * sharding splits a leading axis (frames, windows or a training batch)
    into one chunk per mesh position (:func:`shard_batch`); each chunk runs
    on its device, and the per-row results come back to mesh device 0 with
    ``.to()`` (:func:`gather`), the explicit all-gather of the JAX
    package's ``window_shard.py``. Callers enqueue every shard before they
    read any back, so two cards overlap;
  * parameters are replicated: one copy per distinct device
    (:func:`replicate`);
  * a mesh may name one device more than once, e.g. ``("cpu",) * 4`` or
    ``("cuda:0", "cuda:0")``, the counterpart of the virtual CPU devices
    the JAX tests run on: a real multi-shard mesh on the CPU or on one card.

A mesh that names a device which does not exist raises; nothing falls back
to another device. Only ``parallel/multihost.py`` spans processes, through
``torch.distributed``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"

DeviceLike = Union[str, torch.device]


def _checked_device(spec: DeviceLike) -> torch.device:
    """``spec`` as a ``torch.device`` that exists in this process; raises
    otherwise. A bare ``"cuda"`` names the current card."""
    device = torch.device(spec)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type != "cuda":
        raise ValueError("a mesh holds CUDA cards or the CPU, not {!r}".format(str(device)))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mesh device {!r} requested but torch.cuda.is_available() is False".format(
                str(device))
        )
    index = torch.cuda.current_device() if device.index is None else device.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(
            "mesh device cuda:{} does not exist ({} visible)".format(
                index, torch.cuda.device_count())
        )
    return torch.device("cuda", index)


class Mesh(tuple):
    """An ordered tuple of this process's devices, one per shard."""

    axis_names = (DATA_AXIS,)

    def __new__(cls, devices: Sequence[DeviceLike]):
        devices = tuple(_checked_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devices)

    @property
    def size(self) -> int:
        return len(self)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self))

    def __repr__(self) -> str:
        return "Mesh({})".format(", ".join(str(d) for d in self))


def as_mesh(mesh: Union[Mesh, Sequence[DeviceLike]]) -> Mesh:
    """``mesh`` as a :class:`Mesh`: a tuple or list of devices is checked
    and converted; anything else raises ``TypeError``."""
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (tuple, list)) and all(
        isinstance(d, (str, torch.device)) for d in mesh
    ):
        return Mesh(mesh)
    raise TypeError(
        "a mesh is a tuple of devices (parallel.mesh.get_mesh), not {!r}".format(
            type(mesh).__name__)
    )


def get_mesh(n_devices: Optional[int] = None,
             devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D data mesh over ``devices`` (default: every visible CUDA card;
    there is no CPU default), or their first ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_mesh() takes the CUDA cards by default, and "
                "torch.cuda.is_available() is False; pass devices=(...) for a CPU mesh"
            )
        devices = ["cuda:{}".format(i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError("{} devices asked of a mesh of {}".format(n_devices, len(devices)))
        devices = devices[:n_devices]
    return Mesh(devices)


def mesh_from_config(device: Optional[DeviceLike] = None) -> Optional[Mesh]:
    """The training mesh of ``train_mesh_devices``: ``None``/``0``/``1``
    give None (one device); ``"all"``/``-1`` every CUDA card; ``n`` the
    first n cards. A mesh of one device is None too. With ``device`` the
    CPU (the caller asked for it), ``n`` gives n shards on the CPU and
    ``"all"`` raises: the CPU has no device count."""
    from .. import config as cf
    from ..utils.device import resolve_device

    want = cf.get("train_mesh_devices")
    if want in (None, 0, 1, False):
        return None
    device = resolve_device(device)
    every = want in ("all", -1, True)
    if device.type == "cpu":
        if every:
            raise ValueError(
                "train_mesh_devices={!r} names every CUDA card; a CPU mesh needs a "
                "count".format(want)
            )
        n = int(want)
        return Mesh(["cpu"] * n) if n > 1 else None
    available = torch.cuda.device_count()
    n = available if every else int(want)
    if n > available:
        raise RuntimeError(
            "train_mesh_devices={} but {} CUDA card(s) are visible".format(n, available))
    return get_mesh(n) if n > 1 else None


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad ``array`` (numpy or torch) along ``axis`` with copies of its last
    entry (``mode="edge"``) to a multiple of ``multiple``; returns
    ``(padded, original_length)``. Padding rows are masked or dropped by
    the caller."""
    length = array.shape[axis]
    target = ((length + multiple - 1) // multiple) * multiple
    if target == length:
        return array, length
    if isinstance(array, torch.Tensor):
        last = array.narrow(axis, length - 1, 1)
        reps = [1] * array.dim()
        reps[axis] = target - length
        return torch.cat([array, last.repeat(*reps)], dim=axis), length
    pad_widths = [(0, 0)] * array.ndim
    pad_widths[axis] = (0, target - length)
    return np.pad(array, pad_widths, mode="edge"), length


def split_rows(n: int, mesh: Mesh) -> List[slice]:
    """The row slice of each mesh position for ``n`` rows, ``n`` a multiple
    of the mesh size."""
    if n % mesh.size:
        raise ValueError("{} rows do not split over a mesh of {}".format(n, mesh.size))
    per = n // mesh.size
    return [slice(k * per, (k + 1) * per) for k in range(mesh.size)]


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's leading axis (a multiple of the mesh size; see
    :func:`pad_to_multiple`) into one chunk per mesh position, each on its
    device. Returns, per array, the tuple of chunks (one array: its tuple)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append(tuple(t[s].to(d, non_blocking=True)
                         for s, d in zip(split_rows(t.shape[0], mesh), mesh)))
    return tuple(out) if len(out) > 1 else out[0]


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-shard results concatenated on mesh device 0 (differentiable:
    ``.to()`` carries gradients back to each shard's device); a mesh of
    one device gives its part itself."""
    if len(parts) == 1:
        return parts[0].to(mesh[0])
    return torch.cat([p.to(mesh[0]) for p in parts])


def replicate(mesh: Mesh, tree: Any) -> Tuple[Any, ...]:
    """``tree`` (nested dicts, lists and tuples of tensors) copied to every
    distinct mesh device once; returns one tree per mesh position
    (positions naming one device share its copy). ``.to()`` is
    differentiable, so a training forward can replicate the master
    weights of device 0 and its gradients reach them."""
    copies: Dict[torch.device, Any] = {d: _tree_to(tree, d) for d in mesh.distinct}
    return tuple(copies[d] for d in mesh)


def _tree_to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def on_device(device: torch.device):
    """A context in which ``device`` is the current card (kernels launched
    by the port's wrappers go to the current card's stream); nothing for
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def local_device_count(mesh: Optional[Mesh] = None) -> int:
    """Shards of ``mesh``, or the CUDA cards of this process without one."""
    if mesh is None:
        return torch.cuda.device_count()
    return mesh.size
