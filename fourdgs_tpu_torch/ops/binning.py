"""Tile binning: duplicate Gaussians per overlapped tile, sort, tile ranges.

Counterpart of ``fourdgs_tpu/ops/binning.py``:

- ``bin_gaussians_fast`` (``:231-364``), the ``pallas`` backend's: pre-sort
  the Gaussians by depth, duplicate each over its tile rect into a static
  budget of K slots, then one **stable** sort on the tile id alone yields
  the (tile, depth) order of the reference's radix sort. Slots at or past
  ``num_rendered`` get the sentinel tile T; demand above K is truncated
  (the deepest instances drop), as on the JAX side. With ``means2d``,
  ``lam_min`` and ``cull_c`` (``tpu.ellipse_tile_cull``) the ellipse-vs-tile
  cull of :func:`_rect_cull_mask` runs before the slots are allocated, so
  dead corner cells take no slot and ``num_rendered`` is the demand after
  the cull.
- ``bin_gaussians`` (``:92-153``), the ``tile`` backend's: the lexicographic
  (tile, depth, slot) sort, as two stable sorts.

Integer bookkeeping only; index tensors are int64 (torch's index type), the
tile ranges int32 (the blend kernel's type). torch has no unsigned 32-bit
type and no popcount, so the cull's 32-cell masks live in int64 and are
counted with a SWAR popcount.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops import constants as C


class BinningOut(NamedTuple):
    gauss_id: torch.Tensor      # [K] int64 Gaussian index per sorted instance
    tile_id: torch.Tensor       # [K] int64 sorted tile id (T = padding)
    tile_start: torch.Tensor    # [T] int32 first instance of each tile
    tile_stop: torch.Tensor     # [T] int32 one past the last instance
    num_rendered: torch.Tensor  # [] int64 true instance demand (may exceed K)
    # segment bookkeeping for the training slice's gradient reduction:
    # (None from bin_gaussians, whose callers differentiate the gather)
    slot: torch.Tensor | None = None        # [K] int64 pre-sort slot of each sorted instance
    seg_starts: torch.Tensor | None = None  # [P] int64 first slot per depth rank
    seg_counts: torch.Tensor | None = None  # [P] int64 slots per depth rank
    order: torch.Tensor | None = None       # [P] int64 depth rank -> Gaussian


_MASK_CELLS = 32  # rect cells representable in the per-Gaussian cull bitmask


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a 32-bit pattern (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _select_bit(mask: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Position of the ``rank``-th (0-based) set bit of each 32-bit mask
    (int64 tensors), by JAX's 5-step binary reduction (``binning.py:156-176``):
    at each step, if the low ``w`` bits hold at most ``rank`` set bits, skip
    past them. Undefined (but in 0..31) when rank ≥ popcount(mask)."""
    m, r = mask, rank
    pos = torch.zeros_like(m)
    for w in (16, 8, 4, 2, 1):
        low = m & ((1 << w) - 1)
        c = popcount32(low)
        go_hi = c <= r
        r = r - torch.where(go_hi, c, 0)
        pos = pos + torch.where(go_hi, w, 0)
        m = torch.where(go_hi, m >> w, low)
    return pos


def _rect_cull_mask(tile_min, tile_max, tiles_touched, means2d, lam_min,
                    cull_c, tile_row_offset=0, tile_row_stride: int = 1):
    """(mask [P] int64, big [P] bool, tiles [P] int64): the rect cells of
    each Gaussian that survive the ellipse-vs-tile test, as the bits of a
    32-bit mask, and the resulting exact tile count (``binning.py:181-228``).

    A cell dies when ½·λmin·‖d‖² > c, d the distance from the mean to the
    tile's box dilated by a pixel (the dilation absorbs the bf16 payload's
    rounding): no pixel of it reaches α = 1/255, so the blend's own α-floor
    gate would zero the instance. Rects of more than 32 cells keep their full
    rect (``big``). One broadcast pass over [P, 32] cells; the float
    operations are JAX's, in its order, so the cells agree bit for bit."""
    area = tiles_touched.long()
    rect_w = torch.clamp(tile_max[:, 0].long() - tile_min[:, 0].long(), min=1)
    mx = means2d[:, 0].detach()[:, None]
    my = means2d[:, 1].detach()[:, None]
    lam = lam_min.detach()[:, None]
    cc = cull_c.detach()[:, None]
    j = torch.arange(_MASK_CELLS, device=area.device)
    jy = torch.div(j[None, :], rect_w[:, None], rounding_mode="floor")
    jx = j[None, :] - jy * rect_w[:, None]
    tx = tile_min[:, 0].long()[:, None] + jx
    ty = tile_min[:, 1].long()[:, None] + jy
    px0 = (tx * C.TILE_X).to(torch.float32) - 1.0
    py0 = ((ty * tile_row_stride + tile_row_offset) * C.TILE_Y).to(torch.float32) - 1.0
    dx = mx - torch.minimum(torch.maximum(mx, px0), px0 + (C.TILE_X + 1.0))
    dy = my - torch.minimum(torch.maximum(my, py0), py0 + (C.TILE_Y + 1.0))
    live = (j[None, :] < area[:, None]) & ~(0.5 * lam * (dx * dx + dy * dy) > cc)
    mask = torch.sum(live.long() << j[None, :], dim=1)
    big = area > _MASK_CELLS
    return mask, big, torch.where(big, area, popcount32(mask))


def bin_gaussians_fast(
    tile_min: torch.Tensor,       # [P,2] int32 inclusive rect min (x, y)
    tile_max: torch.Tensor,       # [P,2] int32 exclusive rect max
    tiles_touched: torch.Tensor,  # [P] int32
    depths: torch.Tensor,         # [P] f32 view-space z (sort key)
    grid_x: int,
    grid_y: int,
    budget: int,
    means2d: torch.Tensor | None = None,   # [P, 2] pixel centres (the cull)
    lam_min: torch.Tensor | None = None,   # [P] conic min eigenvalue
    cull_c: torch.Tensor | None = None,    # [P] ln(255·op)
    tile_row_offset=0,
    tile_row_stride: int = 1,
) -> BinningOut:
    """Depth-presorted, single-key binning into ``budget`` slots; with
    ``means2d``, ``lam_min`` and ``cull_c`` the ellipse cull runs first, its
    tile rows at ``tile_row_offset + j·tile_row_stride`` (a shard's slab)."""
    dev = tiles_touched.device
    T = grid_x * grid_y
    tt = tiles_touched.long()
    cull = means2d is not None and lam_min is not None
    if cull:
        cmask, cbig, tt = _rect_cull_mask(
            tile_min, tile_max, tt, means2d, lam_min, cull_c,
            tile_row_offset, tile_row_stride)
    key = torch.where(tt > 0, depths, torch.full_like(depths, float("inf")))
    order = torch.argsort(key, stable=True)
    tt_s = tt[order]
    tmin_s = tile_min.long()[order]
    tmax_s = tile_max.long()[order]

    offsets = torch.cumsum(tt_s, 0)
    num_rendered = tt_s.sum()
    starts = offsets - tt_s

    # rank of the Gaussian owning slot k: mark each nonempty Gaussian's first
    # slot, prefix-sum the marks (the nonempty starts are strictly increasing
    # because empty Gaussians sort last)
    k = torch.arange(budget, device=dev)
    head_at = starts[(tt_s > 0) & (starts < budget)]
    head = torch.zeros(budget, dtype=torch.long, device=dev)
    head.index_add_(0, head_at, torch.ones_like(head_at))
    rank = torch.cumsum(head, 0) - 1
    in_range = k < num_rendered
    rank_safe = torch.where(in_range, rank, 0)

    rect_w_all = torch.clamp(tmax_s[:, 0] - tmin_s[:, 0], min=1)
    local = k - starts[rank_safe]
    rect_w = rect_w_all[rank_safe]
    if cull:
        # slot-local rank → surviving cell: the local-th set bit of the mask
        # (the identity for the big rects, which keep their full rect)
        g = order[rank_safe]
        cell = torch.where(cbig[g], local, _select_bit(cmask[g], local))
    else:
        cell = local
    tx = tmin_s[rank_safe, 0] + cell % rect_w
    ty = tmin_s[rank_safe, 1] + cell // rect_w
    tile = torch.where(in_range, ty * grid_x + tx, T)
    gid_slot = torch.where(in_range, order[rank_safe], 0)

    tile_s, slot_s = torch.sort(tile, stable=True)
    bounds = torch.searchsorted(
        tile_s, torch.arange(T + 1, device=dev), side="left"
    ).to(torch.int32)
    return BinningOut(
        gauss_id=gid_slot[slot_s],
        tile_id=tile_s,
        tile_start=bounds[:T],
        tile_stop=bounds[1:],
        num_rendered=num_rendered,
        slot=slot_s,
        seg_starts=starts,
        seg_counts=tt_s,
        order=order,
    )


def bin_gaussians(
    tile_min: torch.Tensor,       # [P,2] int32 inclusive rect min (x, y)
    tile_max: torch.Tensor,       # [P,2] int32 exclusive rect max
    tiles_touched: torch.Tensor,  # [P] int32
    depths: torch.Tensor,         # [P] f32 view-space z (sort key)
    grid_x: int,
    grid_y: int,
    budget: int,
) -> BinningOut:
    """The (tile, depth)-sorted instance list with a static budget
    (``binning.py:92-153``): slot k belongs to the Gaussian whose
    [start, offset) interval holds k (a ``searchsorted`` over the prefix
    sum), its rect enumerated row-major; then the lexicographic sort on
    (tile, depth, slot), done as a stable sort on depth followed by a
    stable sort on tile. Instances beyond ``budget`` are dropped; padding
    slots carry the sentinel tile T and sort last."""
    dev = tiles_touched.device
    T = grid_x * grid_y
    tt = tiles_touched.long()
    depths = depths.detach()
    offsets = torch.cumsum(tt, 0)
    num_rendered = offsets[-1] if tt.numel() else torch.zeros((), dtype=torch.long, device=dev)
    starts = offsets - tt
    k = torch.arange(budget, device=dev)
    g = torch.searchsorted(offsets, k, right=True)
    in_range = k < num_rendered
    g_safe = torch.where(in_range, g, 0)
    local = k - starts[g_safe]
    tmin = tile_min.long()[g_safe]
    rect_w = torch.clamp(tile_max.long()[g_safe, 0] - tmin[:, 0], min=1)
    tile = (tmin[:, 1] + local // rect_w) * grid_x + tmin[:, 0] + local % rect_w
    tile = torch.where(in_range, tile, T)
    depth_k = torch.where(in_range, depths[g_safe], torch.inf)
    by_depth = torch.sort(depth_k, stable=True).indices
    by_tile = torch.sort(tile[by_depth], stable=True).indices
    perm = by_depth[by_tile]
    tile_s = tile[perm]
    bounds = torch.searchsorted(
        tile_s, torch.arange(T + 1, device=dev), side="left").to(torch.int32)
    return BinningOut(
        gauss_id=g_safe[perm],
        tile_id=tile_s,
        tile_start=bounds[:T],
        tile_stop=bounds[1:],
        num_rendered=num_rendered,
    )
