"""Support-bounded scheduled extraction of a *static* window set: the
crop-mode stage 0 of dense pyramids (counterpart of ops/windows_sched.py).

Host part (copied from the JAX package, the arrays equal its own):
:func:`build_schedule` bins every window of a static box table into the
smallest aligned image cell (R rows x C cols from a fixed ladder) that holds
its guard-banded two-tap support, groups same-cell windows, pads each group
to the kernel tile by replicating its last window, and concatenates groups
into classes by cell size. :func:`schedule_for_plan` caches it per plan.

Device part: :func:`extract_scheduled` computes the sampling positions of
every scheduled slot with ``windows.sample_positions`` (the jitted JAX
rounding), moves them into cell-local coordinates (an exact integer
subtraction) and resamples every slot inside its tile's cell: kernel K2
(``ops/windows_sched_cuda.py``, ``csrc/sched.cu``) for a CUDA tensor, its
plain version :func:`resample_sched_plain` for a CPU tensor. Taps on rows
or columns outside the tile's cell contribute nothing, as in the TPU
kernel; pixels past the image are zero. So on every real slot K2 equals K1
bit for bit: cell-local coordinates differ from the global ones by an
exact integer, and the schedule's cells hold each window's support.

Precomputed taps (the profiling tool ``tools/profile_torch_sched_precomp.py``,
counterpart of the JAX package's ``tools/profile_sched_precomp.py``):
:func:`precompute_tap_matrices` builds every tile's two-tap triangle weight
matrices once per plan, RY (tile * out_h, cell_r) and RX (cell_c, tile *
out_w) in bf16, kept in device memory; :func:`extract_scheduled_precomp`
resamples with them: kernel K2p (``ops/windows_sched_precomp_cuda.py``,
``csrc/sched_precomp.cu``) for a CUDA tensor, the dense two-pass
contraction :func:`resample_sched_precomp_plain` for a CPU tensor. Both
equal K2 bit for bit.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import windows


def _tile_windows(out_h: int, out_w: int) -> int:
    """Windows per kernel tile (the JAX package's
    ``windows_pallas._tile_windows``): ``tile * out_w`` a multiple of 128
    and at least 256, ``tile * out_h`` a multiple of 8. The schedule's
    padding and slot order depend on it, so the port keeps it exactly."""
    t = 128 // math.gcd(out_w, 128)
    while t * out_w < 256:
        t *= 2
    while (t * out_h) % 8:
        t *= 2
    return t


def _estimate_sample_positions(
    boxes: np.ndarray, h: int, w: int, out_h: int, out_w: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host float32 estimate of the sampling positions (same formulas; may
    differ from the device values in the last ulp -- only used for support
    classing, with a guard band)."""
    boxes = boxes.astype(np.float32)
    xmin, ymin, xmax, ymax = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    box_w = xmax - xmin
    box_h = ymax - ymin
    oy = (np.arange(out_h, dtype=np.float32) + np.float32(0.5))[None, :]
    ox = (np.arange(out_w, dtype=np.float32) + np.float32(0.5))[None, :]
    local_y = oy * (box_h[:, None] / np.float32(out_h)) - np.float32(0.5)
    local_x = ox * (box_w[:, None] / np.float32(out_w)) - np.float32(0.5)
    local_y = np.clip(local_y, 0.0, np.maximum(box_h[:, None] - 1.0, 0.0))
    local_x = np.clip(local_x, 0.0, np.maximum(box_w[:, None] - 1.0, 0.0))
    sy = np.clip(local_y + ymin[:, None], 0.0, np.float32(h - 1))
    sx = np.clip(local_x + xmin[:, None], 0.0, np.float32(w - 1))
    return sy.astype(np.float32), sx.astype(np.float32)


@dataclass
class _ClassSchedule:
    cell_r: int  # cell rows (a ladder rung dividing h_pad)
    cell_c: int  # cell cols (a ladder rung dividing w_pad)
    sel: np.ndarray  # (tiles,) int64 tile indices assigned to this class
    offs: np.ndarray  # (2, tiles) int32 per-tile (row, col) offsets in CELL units

    @property
    def n_tiles(self) -> int:
        return int(self.sel.size)


@dataclass
class ExtractionSchedule:
    """Host-precomputed extraction program for one static window set."""

    img_h: int
    img_w: int
    h_pad: int  # rows padded so every row-ladder rung divides them
    w_pad: int  # cols padded so every col-ladder rung divides them
    out_h: int
    out_w: int
    tile: int
    n_windows: int
    classes: List[_ClassSchedule] = field(default_factory=list)
    positions: Optional[np.ndarray] = None  # (n,) output row of ORIGINAL window i
    order: Optional[np.ndarray] = None  # (n_slots,) original window id per slot
    # scheduled-order metadata (reorder=False consumers): original window id
    # per output row (== order), and a validity mask (False on replicated
    # group-padding rows)
    ids: Optional[np.ndarray] = None  # (n_slots,)
    valid: Optional[np.ndarray] = None  # (n_slots,) bool
    # device copies of the per-tile cell table and the slot order, per device
    _device_tables: Dict[str, tuple] = field(default_factory=dict, repr=False)

    @property
    def n_slots(self) -> int:
        return int(self.order.size)

    @property
    def n_tiles(self) -> int:
        return self.n_slots // self.tile

    def tile_table(self) -> np.ndarray:
        """(n_tiles, 4) int32 rows (row0, col0, cell_r, cell_c) in slot
        order: the pixel offsets and the size of each tile's cell."""
        table = np.empty((self.n_tiles, 4), np.int32)
        for cls in self.classes:
            table[cls.sel, 0] = cls.offs[0] * cls.cell_r
            table[cls.sel, 1] = cls.offs[1] * cls.cell_c
            table[cls.sel, 2] = cls.cell_r
            table[cls.sel, 3] = cls.cell_c
        return table

    def device_tables(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(order (n_slots,) int64, tiles (n_tiles, 4) int32, valid
        (n_slots,) bool)`` on ``device``, built once per schedule and
        device."""
        key = str(device)
        cached = self._device_tables.get(key)
        if cached is None:
            cached = (
                torch.as_tensor(self.order, dtype=torch.int64, device=device),
                torch.as_tensor(self.tile_table(), device=device),
                torch.as_tensor(self.valid, device=device),
            )
            self._device_tables[key] = cached
        return cached


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_schedule(
    boxes: np.ndarray,
    img_h: int,
    img_w: int,
    out_h: int,
    out_w: int,
) -> Optional[ExtractionSchedule]:
    """Build the cell-grouped schedule for a static (N, 4) float box array.

    Each window is binned into the smallest aligned ladder cell containing
    its (guard-banded) two-tap support; same-cell windows are grouped and
    tiled together, groups padded to the kernel tile by replicating their
    last window (masked via ``valid``).

    Returns None when the geometry cannot profit from cell bounding (tiny
    images) or the tile shape degenerates; callers then use K1.
    """
    tile = _tile_windows(out_h, out_w)
    if tile * out_w > 4096:
        return None
    if img_h < 128 or img_w < 256:
        return None  # cells would cover the whole image anyway

    n = boxes.shape[0]
    if n == 0:
        return None
    h_pad = _ceil_to(img_h, 256)
    w_pad = _ceil_to(img_w, 256)
    sy, sx = _estimate_sample_positions(boxes, img_h, img_w, out_h, out_w)

    # per-WINDOW two-tap support, widened by a one-row/col guard band (the
    # device f32 positions may differ in the last ulp, which can flip a
    # floor() at integer boundaries)
    y_lo = np.floor(sy).astype(np.int64)
    x_lo = np.floor(sx).astype(np.int64)
    rlo = np.maximum(y_lo.min(axis=1) - 1, 0)
    rhi = np.minimum(y_lo.max(axis=1) + 2, img_h - 1)
    clo = np.maximum(x_lo.min(axis=1) - 1, 0)
    chi = np.minimum(x_lo.max(axis=1) + 2, img_w - 1)

    # only rungs that DIVIDE the padded dim are admissible, so every cell of
    # a class lies inside the padded image
    r_ladder = [r for r in (64, 128, 256, 512) if r < h_pad and h_pad % r == 0]
    r_ladder += [h_pad]
    c_ladder = [c for c in (256, 512) if c < w_pad and w_pad % c == 0] + [w_pad]

    # smallest rung whose aligned grid contains the support in one cell
    cell_r = np.full(n, h_pad, np.int64)
    for r in reversed(r_ladder):
        cell_r[(rlo // r) == (rhi // r)] = r
    cell_c = np.full(n, w_pad, np.int64)
    for c in reversed(c_ladder):
        cell_c[(clo // c) == (chi // c)] = c
    roff = rlo // cell_r  # block units
    coff = clo // cell_c

    sched = ExtractionSchedule(
        img_h=img_h, img_w=img_w, h_pad=h_pad, w_pad=w_pad,
        out_h=out_h, out_w=out_w, tile=tile, n_windows=n,
    )

    slot_ids: List[np.ndarray] = []  # original window id per output slot
    valid_parts: List[np.ndarray] = []
    tile_counter = 0
    for r in r_ladder:
        for c in c_ladder:
            in_class = (cell_r == r) & (cell_c == c)
            if not in_class.any():
                continue
            idx = np.nonzero(in_class)[0]
            # group by cell block index; stable order keeps plan order
            key = roff[idx] * (w_pad // c) + coff[idx]
            grp_order = np.argsort(key, kind="stable")
            idx = idx[grp_order]
            key = key[grp_order]
            starts = np.concatenate(
                [[0], np.nonzero(np.diff(key))[0] + 1, [idx.size]]
            )
            offs_tiles = []
            for g in range(starts.size - 1):
                members = idx[starts[g] : starts[g + 1]]
                g_tiles = -(-members.size // tile)
                padded = np.concatenate(
                    [members, np.repeat(members[-1:], g_tiles * tile - members.size)]
                )
                slot_ids.append(padded)
                v = np.zeros(g_tiles * tile, np.bool_)
                v[: members.size] = True
                valid_parts.append(v)
                offs_tiles.append(
                    np.stack(
                        [
                            np.repeat(roff[members[0]], g_tiles),
                            np.repeat(coff[members[0]], g_tiles),
                        ]
                    )
                )
            n_tiles_cls = sum(o.shape[1] for o in offs_tiles)
            sched.classes.append(
                _ClassSchedule(
                    cell_r=int(r),
                    cell_c=int(c),
                    sel=np.arange(tile_counter, tile_counter + n_tiles_cls),
                    offs=np.concatenate(offs_tiles, axis=1).astype(np.int32),
                )
            )
            tile_counter += n_tiles_cls

    order = np.concatenate(slot_ids)  # (n_slots,) original id per slot
    valid = np.concatenate(valid_parts)
    positions = np.empty(n, np.int64)
    positions[order] = np.arange(order.size)  # any duplicate row is identical
    sched.order = order
    sched.ids = order.copy()
    sched.valid = valid
    sched.positions = positions
    return sched


@functools.lru_cache(maxsize=64)
def schedule_for_plan(plan, out_h: int, out_w: int) -> Optional[ExtractionSchedule]:
    """Schedule for a pyramid plan's full static window set (stage-0
    extraction). Cached per plan; plans are frozen and hashable."""
    from .pyramid import window_table

    table = window_table(plan)
    return build_schedule(
        table["boxes_float"].astype(np.float32),
        plan.img_h,
        plan.img_w,
        out_h,
        out_w,
    )


# ---------------------------------------------------------------------------
# device part


def _bounded_taps(s: torch.Tensor, lo: torch.Tensor, size: int, bound: torch.Tensor):
    """The two-tap support of positions ``s`` (cell-local) clipped to the
    cell ``[0, bound)``: returns (global index, weight) for taps at floor(s)
    and floor(s) + 1, each weight ``bf16(max(0, 1 - |i - s|))`` or 0 where
    the tap leaves the cell or the image (``lo`` is the cell's offset on
    the image, ``size`` the image's extent). Out-of-image indices are
    clamped and their weights zeroed, which reads a zero pixel."""
    i0 = torch.floor(s)
    taps = []
    for i in (i0, i0 + 1.0):
        w = torch.clamp(1.0 - torch.abs(i - s), min=0.0).to(torch.bfloat16).float()
        g = i.long() + lo
        inside = (i >= 0) & (i < bound) & (g < size)
        taps.append((torch.clamp(g, 0, size - 1), torch.where(inside, w, torch.zeros_like(w))))
    return taps


def resample_cells_plain(
    planes: torch.Tensor,
    sy_local: torch.Tensor,
    sx_local: torch.Tensor,
    row0: torch.Tensor,
    col0: torch.Tensor,
    cell_r: torch.Tensor,
    cell_c: torch.Tensor,
) -> torch.Tensor:
    """Cell-bounded bilinear resample with K1's rounding points, the
    function K2 and K4 compute.

    ``planes`` (B, C, H, W) bf16; ``sy_local`` (B|1, N, out_h) and
    ``sx_local`` (B|1, N, out_w) f32 positions relative to each window's
    cell; ``row0``/``col0``/``cell_r``/``cell_c`` (B|1, N) int64: the cell's
    pixel offset and size per window. Returns (B, N, out_h, out_w, C) bf16
    on the u8 lattice: taps ``bf16(max(0, 1 - |i - s|))`` over the rows and
    columns inside the cell, vertical sum in f32 rounded to bf16,
    horizontal sum in f32, round half to even and clip. A two-tap gather,
    not a dense tap matrix.
    """
    b, c, h, w = planes.shape
    n, out_h, out_w = sy_local.shape[1], sy_local.shape[2], sx_local.shape[2]
    (y0, wy0), (y1, wy1) = _bounded_taps(sy_local, row0[..., None], h, cell_r[..., None])
    (x0, wx0), (x1, wx1) = _bounded_taps(sx_local, col0[..., None], w, cell_c[..., None])
    y0, y1, wy0, wy1 = (t.expand(b, n, out_h) for t in (y0, y1, wy0, wy1))
    x0, x1, wx0, wx1 = (t.expand(b, n, out_w) for t in (x0, x1, wx0, wx1))
    flat = planes.float().permute(0, 2, 3, 1).reshape(b, h * w, c)
    bidx = torch.arange(b, device=planes.device)[:, None, None, None]

    def pixels(yi, xi):  # (B, N, out_h, out_w, C)
        return flat[bidx, yi[:, :, :, None] * w + xi[:, :, None, :]]

    def vertical(xi):
        v = wy0[..., None, None] * pixels(y0, xi) + wy1[..., None, None] * pixels(y1, xi)
        return v.to(torch.bfloat16).float()

    out = wx0[:, :, None, :, None] * vertical(x0) + wx1[:, :, None, :, None] * vertical(x1)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.bfloat16)


def scheduled_positions(
    boxes: torch.Tensor, sched: ExtractionSchedule, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cell-local sampling positions of every slot: ``sy_local``
    (n_slots, out_h), ``sx_local`` (n_slots, out_w) f32, and the tile table
    (n_tiles, 4) int32 (row0, col0, cell_r, cell_c) on ``device``."""
    order, tiles, _ = sched.device_tables(device)
    sy, sx = windows.sample_positions(
        boxes.to(device), sched.img_h, sched.img_w, sched.out_h, sched.out_w
    )
    per_slot = torch.repeat_interleave(tiles, sched.tile, dim=0)  # (n_slots, 4)
    sy_local = sy[order] - per_slot[:, 0:1].float()
    sx_local = sx[order] - per_slot[:, 1:2].float()
    return sy_local.contiguous(), sx_local.contiguous(), tiles


def resample_sched_plain(
    planes: torch.Tensor,
    sy_local: torch.Tensor,
    sx_local: torch.Tensor,
    tiles: torch.Tensor,
    tile: int,
) -> torch.Tensor:
    """Plain version of kernel K2 at its interface: ``planes`` (B, C, H, W)
    bf16, ``sy_local`` (n_slots, out_h), ``sx_local`` (n_slots, out_w) f32
    cell-local positions, ``tiles`` (n_tiles, 4) int32 -> (B, n_slots,
    out_h, out_w, C) bf16 in scheduled slot order."""
    per_slot = torch.repeat_interleave(tiles.long(), tile, dim=0)[None]  # (1, n, 4)
    return resample_cells_plain(
        planes, sy_local[None], sx_local[None],
        per_slot[..., 0], per_slot[..., 1], per_slot[..., 2], per_slot[..., 3],
    )


def precompute_tap_matrices(
    sched: ExtractionSchedule, boxes: torch.Tensor
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per cell class, the tap matrices of all its tiles on ``boxes``'
    device: ``RY`` (n_tiles_cls * tile * out_h, cell_r) and ``RX`` (cell_c,
    n_tiles_cls * tile * out_w), both ``bf16(max(0, 1 - |i - s|))`` of the
    cell-local positions of :func:`scheduled_positions` (the expressions of
    the JAX tool's ``precompute_weights``). ``boxes`` is the (N, 4) float32
    window set the schedule was built from."""
    device = boxes.device
    sy_local, sx_local, _ = scheduled_positions(boxes, sched, device)
    tile, out_h, out_w = sched.tile, sched.out_h, sched.out_w
    sy_t = sy_local.reshape(sched.n_tiles, tile * out_h)
    sx_t = sx_local.reshape(sched.n_tiles, tile * out_w)
    out = []
    for cls in sched.classes:
        sel = torch.as_tensor(cls.sel, device=device)
        sy_c = sy_t[sel].reshape(-1, 1)  # (tiles * tile * out_h, 1)
        sx_c = sx_t[sel].reshape(1, -1)  # (1, tiles * tile * out_w)
        r_iota = torch.arange(cls.cell_r, dtype=torch.float32, device=device)[None, :]
        c_iota = torch.arange(cls.cell_c, dtype=torch.float32, device=device)[:, None]
        ry = torch.clamp(1.0 - torch.abs(r_iota - sy_c), min=0.0).to(torch.bfloat16)
        rx = torch.clamp(1.0 - torch.abs(c_iota - sx_c), min=0.0).to(torch.bfloat16)
        out.append((ry, rx))
    return out


def tap_bytes(taps: List[Tuple[torch.Tensor, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for pair in taps for t in pair)


def resample_sched_precomp_plain(
    planes: torch.Tensor,
    taps: List[Tuple[torch.Tensor, torch.Tensor]],
    tiles: torch.Tensor,
    sched: ExtractionSchedule,
    chunk: int = 16,
) -> torch.Tensor:
    """Plain version of kernel K2p: ``planes`` (B, C, H, W) bf16, ``taps``
    of :func:`precompute_tap_matrices`, ``tiles`` (n_tiles, 4) int32 ->
    (B, n_slots, out_h, out_w, C) bf16 on the u8 lattice in scheduled
    order. Per tile the dense two-pass contraction of the JAX tool's
    kernel: the tile's image cell (zero past the image) contracted with RY
    in f32, rounded to bf16, contracted with RX in f32, the diagonal
    (window, window) blocks kept, rounded half to even and clipped.
    ``chunk`` tiles at a time bound the memory."""
    b, c, h, w = planes.shape
    tile, out_h, out_w = sched.tile, sched.out_h, sched.out_w
    padded = torch.zeros((b, c, sched.h_pad, sched.w_pad), dtype=torch.float32,
                         device=planes.device)
    padded[:, :, :h, :w] = planes.float()
    tiles = tiles.long()
    outs = []
    for cls, (ry, rx) in zip(sched.classes, taps):
        ry = ry.float().reshape(cls.n_tiles, tile * out_h, cls.cell_r)
        rx = rx.float().reshape(cls.cell_c, cls.n_tiles, tile * out_w).permute(1, 0, 2)
        r_iota = torch.arange(cls.cell_r, device=planes.device)
        c_iota = torch.arange(cls.cell_c, device=planes.device)
        for s in range(0, cls.n_tiles, chunk):
            sel = torch.as_tensor(cls.sel[s : s + chunk], device=planes.device)
            rows = tiles[sel, 0][:, None] + r_iota  # (nt, cell_r)
            cols = tiles[sel, 1][:, None] + c_iota  # (nt, cell_c)
            block = padded[:, :, rows[:, :, None], cols[:, None, :]]  # (B, C, nt, R, Cc)
            v = torch.matmul(ry[s : s + chunk], block).to(torch.bfloat16).float()
            p = torch.matmul(v, rx[s : s + chunk])  # (B, C, nt, tile*oh, tile*ow)
            nt = p.shape[2]
            p = p.reshape(b, c, nt, tile, out_h, tile, out_w)
            p = torch.diagonal(p, dim1=3, dim2=5)  # (B, C, nt, oh, ow, tile)
            p = p.permute(0, 2, 5, 3, 4, 1).reshape(b, nt * tile, out_h, out_w, c)
            outs.append(torch.clamp(torch.round(p), 0.0, 255.0).to(torch.bfloat16))
    return torch.cat(outs, dim=1)


def extract_scheduled_precomp(
    images: torch.Tensor,
    taps: List[Tuple[torch.Tensor, torch.Tensor]],
    sched: ExtractionSchedule,
) -> torch.Tensor:
    """Extract every scheduled window of (B, H, W, C) frames with
    precomputed taps: (B, n_slots, out_h, out_w, C) bf16 in scheduled
    order, equal to :func:`extract_scheduled`. Kernel K2p for CUDA frames,
    its plain version for CPU frames."""
    h, w = images.shape[1], images.shape[2]
    if (h, w) != (sched.img_h, sched.img_w):
        raise ValueError(
            "schedule built for {}x{}, frames are {}x{}".format(sched.img_h, sched.img_w, h, w)
        )
    _, tiles, _ = sched.device_tables(images.device)
    planes = windows.to_planes_bf16(images)
    if images.is_cuda:
        from . import windows_sched_precomp_cuda

        return windows_sched_precomp_cuda.resample_sched_precomp_cuda(planes, taps, tiles, sched)
    return resample_sched_precomp_plain(planes, taps, tiles, sched)


def extract_scheduled(
    images: torch.Tensor,
    boxes: torch.Tensor,
    sched: ExtractionSchedule,
    reorder: bool = False,
) -> torch.Tensor:
    """Extract every scheduled window from (B, H, W, C) frames.

    ``boxes`` must be the (N, 4) float32 window set the schedule was built
    from (the plan's ``boxes_float``). Returns (B, n_slots, out_h, out_w, C)
    bf16 u8-lattice windows in scheduled order (see ``sched.ids`` and
    ``sched.valid``), or with ``reorder=True`` (B, N, ...) in the original
    window order. Kernel K2 for CUDA frames, its plain version for CPU
    frames; one launch for all frames and classes.
    """
    h, w = images.shape[1], images.shape[2]
    if (h, w) != (sched.img_h, sched.img_w):
        raise ValueError(
            "schedule built for {}x{}, frames are {}x{}".format(
                sched.img_h, sched.img_w, h, w
            )
        )
    from . import library  # noqa: F401 (registers the operator)

    sy_local, sx_local, tiles = scheduled_positions(boxes, sched, images.device)
    planes = windows.to_planes_bf16(images)
    out = torch.ops.rodc.sched(planes, sy_local, sx_local, tiles, sched.tile)
    if reorder:
        return out[:, torch.as_tensor(sched.positions, device=out.device)]
    return out
