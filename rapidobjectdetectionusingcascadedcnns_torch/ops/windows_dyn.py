"""Support-bounded re-extraction of DYNAMIC survivor boxes (stage 1/2),
counterpart of ops/windows_dyn.py, batched over frames.

Survivor boxes are runtime values, so the binning happens on the device:

  * each window's lattice cell ``m = floor(support_start / G)`` is computed
    from the same sampling positions the kernel uses (``windows.
    sample_positions``, one-row guard band); cell m covers image rows
    [m G, m G + R) with R = 128 and G = 32, so a window whose support is at
    most R - G + 1 rows tall fits one cell;
  * windows are argsorted by cell (stable, too-tall windows last) so tiles
    are cell-coherent, the tail is padded with replicas of the last sorted
    window, and kernel K4 (``ops/windows_dyn_cuda.py``, ``csrc/rowbound.cu``)
    resamples every tile inside its first window's cell;
  * windows that do not fit, or that share a tile with another cell, form
    the big class, extracted by kernel K1 up to ``big_cap`` windows; the
    count beyond it is returned as ``overflow``, so the cascade re-runs the
    frame with K1 (never silent garbage).

Taps outside a tile's cell are exactly zero and in-cell taps equal the
global ones (cell-local coordinates differ by an exact integer), so every
small-class window equals K1's, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import windows
from .windows_sched import _tile_windows, resample_cells_plain

ROW_RUNG = 128  # R: cell rows
SHIFT_G = 32  # G: lattice granularity; V = R/G shifted cells per R rows
N_VARIANTS = ROW_RUNG // SHIFT_G


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dyn_supported(img_h: int, img_w: int, out_h: int, out_w: int, n: int) -> bool:
    """Geometry gate: the lattice pays only when the row rung actually cuts
    the contraction (small images fit one cell anyway) and the tile shape is
    alignable (the same limit as the schedule's)."""
    tile = _tile_windows(out_h, out_w)
    return (
        img_h >= 2 * ROW_RUNG
        and img_w >= 128
        and tile * out_w <= 4096
        and n >= 4 * tile
    )


def default_big_cap(cap: int, out_h: int, out_w: int, img_h: int) -> int:
    """Static big-class capacity: a tall-window share (cap//4) plus the exact
    worst case of group-boundary demotions (#lattice cells x (tile-1): every
    cell boundary can strand at most tile-1 windows in a mixed tile);
    tile-aligned, clamped to cap."""
    tile = _tile_windows(out_h, out_w)
    n_cells = _ceil_to(img_h, ROW_RUNG) // SHIFT_G
    demotion_bound = n_cells * (tile - 1)
    return min(
        _ceil_to(cap, tile),
        _ceil_to(max(2 * tile, cap // 4 + demotion_bound), tile),
    )


def resample_rowbound_plain(
    planes: torch.Tensor,
    sy_local: torch.Tensor,
    sx: torch.Tensor,
    cell_start: torch.Tensor,
    tile: int,
    cell_rows: int,
    w_pad: int,
) -> torch.Tensor:
    """Plain version of kernel K4 at its interface: ``planes`` (B, C, H, W)
    bf16, ``sy_local`` (B, n_pad, out_h) f32 rows relative to each tile's
    cell, ``sx`` (B, n_pad, out_w) f32 image columns, ``cell_start``
    (B, n_tiles) int32 -> (B, n_pad, out_h, out_w, C) bf16: rows bounded to
    [cell_start, cell_start + cell_rows), columns to [0, w_pad)."""
    row0 = torch.repeat_interleave(cell_start.long(), tile, dim=1)
    col0 = torch.zeros_like(row0)
    return resample_cells_plain(
        planes, sy_local, sx, row0, col0,
        torch.full_like(row0, cell_rows), torch.full_like(row0, w_pad),
    )


def small_class(
    images: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int
) -> dict:
    """The cell-sorted layout and the raw row-bounded extraction.

    ``images`` (B, H, W, C) float32, ``boxes`` (B, N, 4) float32. Returns
    ``perm`` (B, n_pad) sorted slot -> box (tail replicas included),
    ``small_ok`` (B, n_pad) slots the row-bounded output serves,
    ``boxes_sorted`` (B, n_pad, 4), ``n_big`` (B,) real windows of the big
    class, ``raw`` (B, n_pad, out_h, out_w, C) bf16: K4's output (its
    plain version on a CPU tensor) on every sorted slot, and K4's operands
    (``planes``, ``sy_local``, ``sx``, ``cell_start``, ``tile``, ``w_pad``).
    """
    b, h, w, _ = images.shape
    n = boxes.shape[1]
    tile = _tile_windows(out_h, out_w)
    h_pad = _ceil_to(h, ROW_RUNG)
    w_pad = _ceil_to(w, 128)
    n_pad = _ceil_to(n, tile)
    n_tiles = n_pad // tile
    boxes = boxes.float()

    sy, sx = windows.sample_positions(boxes, h, w, out_h, out_w)  # (B, N, oh/ow)
    # support rows (positions are monotone along the output axis), one-row
    # guard band, as in the JAX package
    rlo = torch.clamp(torch.floor(sy[..., 0]) - 1, 0, h - 1)
    rhi = torch.clamp(torch.floor(sy[..., -1]) + 2, 0, h - 1)
    m = torch.div(rlo, SHIFT_G, rounding_mode="floor").long()  # lattice cell
    fits = (rhi - m.float() * SHIFT_G) < ROW_RUNG

    # cell-coherent ordering: small windows grouped by lattice cell, big last
    n_cells = N_VARIANTS * (h_pad // ROW_RUNG)
    key = torch.where(fits, m, torch.full_like(m, n_cells + 1))
    perm = torch.argsort(key, dim=1, stable=True)
    if n_pad != n:  # pad with replicas of the last sorted window
        perm = torch.cat([perm, perm[:, -1:].expand(b, n_pad - n)], dim=1)
    m_sorted = torch.gather(key, 1, perm)
    sy_s = torch.gather(sy, 1, perm[..., None].expand(b, n_pad, out_h))
    sx_s = torch.gather(sx, 1, perm[..., None].expand(b, n_pad, out_w))
    boxes_s = torch.gather(boxes, 1, perm[..., None].expand(b, n_pad, 4))

    # a window is served by the row-bounded kernel iff it fits AND shares
    # its tile's cell; the tail replicas are not counted as big
    tile_m = m_sorted.reshape(b, n_tiles, tile)[:, :, 0]
    small_ok = (m_sorted <= n_cells) & (
        m_sorted == torch.repeat_interleave(tile_m, tile, dim=1)
    )
    slot_real = torch.arange(n_pad, device=boxes.device) < n
    n_big = (~small_ok & slot_real).sum(dim=1)

    cell_start = (torch.clamp(tile_m, 0, n_cells - 1) * SHIFT_G).to(torch.int32)
    sy_local = (
        sy_s - torch.repeat_interleave(cell_start, tile, dim=1)[..., None].float()
    ).contiguous()
    planes = windows.to_planes_bf16(images)
    sx_s = sx_s.contiguous()
    cell_start = cell_start.contiguous()
    if images.is_cuda:
        from . import windows_dyn_cuda

        raw = windows_dyn_cuda.resample_rowbound_cuda(
            planes, sy_local, sx_s, cell_start, tile, ROW_RUNG, w_pad
        )
    else:
        raw = resample_rowbound_plain(planes, sy_local, sx_s, cell_start, tile, ROW_RUNG, w_pad)
    return {
        "perm": perm,
        "small_ok": small_ok,
        "boxes_sorted": boxes_s,
        "n_big": n_big,
        "raw": raw,
        "planes": planes,
        "sy_local": sy_local,
        "sx": sx_s,
        "cell_start": cell_start,
        "tile": tile,
        "w_pad": w_pad,
    }


def extract_rowbound(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    big_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extract all N windows per frame with row-bounded contractions.

    ``images`` (B, H, W, C) float32, ``boxes`` (B, N, 4) float32 survivor
    boxes. Returns ``(windows (B, N, out_h, out_w, C) bf16 in the original
    box order, n_big (B,) windows that needed the big class, overflow (B,)
    big windows beyond big_cap; > 0 means that many windows carry another
    window's pixels and the caller must re-dispatch)``.
    """
    n = boxes.shape[1]
    tile = _tile_windows(out_h, out_w)
    if big_cap % tile:
        raise ValueError("big_cap {} is not a multiple of the tile {}".format(big_cap, tile))
    s = small_class(images, boxes, out_h, out_w)
    perm, small_ok, raw = s["perm"], s["small_ok"], s["raw"]
    b, n_pad = perm.shape
    overflow = torch.clamp(s["n_big"] - big_cap, min=0)

    # big class: K1 over the first big_cap big windows in sorted order
    big = ~small_ok
    k = min(big_cap, n_pad)
    big_order = torch.argsort((~big).to(torch.int8), dim=1, stable=True)[:, :k]
    big_boxes = torch.gather(s["boxes_sorted"], 1, big_order[..., None].expand(b, k, 4))
    from . import windows_cuda

    big_out = windows_cuda.crop_and_resize(images, big_boxes, out_h, out_w).to(torch.bfloat16)

    # combine in sorted space, then un-permute to the original order (the
    # real slots perm[:, :n] are a permutation; the replicas are dropped)
    big_src = torch.clamp(torch.cumsum(big.long(), dim=1) - 1, 0, k - 1)
    big_rows = torch.gather(
        big_out, 1, big_src[:, :, None, None, None].expand(b, n_pad, *big_out.shape[2:])
    )
    merged = torch.where(small_ok[:, :, None, None, None], raw, big_rows)
    inv = torch.empty((b, n), dtype=torch.long, device=perm.device)
    inv.scatter_(1, perm[:, :n], torch.arange(n, device=perm.device).expand(b, n))
    out = torch.gather(merged, 1, inv[:, :, None, None, None].expand(b, n, *merged.shape[2:]))
    return out, s["n_big"], overflow
