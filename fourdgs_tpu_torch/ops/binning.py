"""Tile binning: duplicate Gaussians per overlapped tile, sort, tile ranges.

Counterpart of ``bin_gaussians_fast`` (``fourdgs_tpu/ops/binning.py:231-364``)
without the ellipse cull: pre-sort the Gaussians by depth, duplicate each
over its tile rect into a static budget of K slots, then one **stable** sort
on the tile id alone yields the (tile, depth) order of the reference's radix
sort. Slots at or past ``num_rendered`` get the sentinel tile T; demand
above K is truncated (the deepest instances drop), as on the JAX side.

Integer bookkeeping only; index tensors are int64 (torch's index type), the
tile ranges int32 (the blend kernel's type).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BinningOut(NamedTuple):
    gauss_id: torch.Tensor      # [K] int64 Gaussian index per sorted instance
    tile_id: torch.Tensor       # [K] int64 sorted tile id (T = padding)
    tile_start: torch.Tensor    # [T] int32 first instance of each tile
    tile_stop: torch.Tensor     # [T] int32 one past the last instance
    num_rendered: torch.Tensor  # [] int64 true instance demand (may exceed K)
    # segment bookkeeping for the training slice's gradient reduction:
    slot: torch.Tensor          # [K] int64 pre-sort slot of each sorted instance
    seg_starts: torch.Tensor    # [P] int64 first slot per depth rank
    seg_counts: torch.Tensor    # [P] int64 slots per depth rank
    order: torch.Tensor         # [P] int64 depth rank -> Gaussian


def bin_gaussians_fast(
    tile_min: torch.Tensor,       # [P,2] int32 inclusive rect min (x, y)
    tile_max: torch.Tensor,       # [P,2] int32 exclusive rect max
    tiles_touched: torch.Tensor,  # [P] int32
    depths: torch.Tensor,         # [P] f32 view-space z (sort key)
    grid_x: int,
    grid_y: int,
    budget: int,
) -> BinningOut:
    """Depth-presorted, single-key binning into ``budget`` slots."""
    dev = tiles_touched.device
    T = grid_x * grid_y
    tt = tiles_touched.long()
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
    tx = tmin_s[rank_safe, 0] + local % rect_w
    ty = tmin_s[rank_safe, 1] + local // rect_w
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
