"""The tiled rasterizer (the ``tile`` backend). PyTorch.

Counterpart of ``fourdgs_tpu/ops/tiled.py:72-241``: the lexicographic
binning (``ops/binning.py::bin_gaussians``), a differentiable payload gather
into sorted-instance order, per-tile padded [T, L] slices of the instance
list (L = ``tile_budget``), and a front-to-back blend vectorized over every
tile × 256 pixels whose only loop walks the lists ``chunk`` instances at a
time, with the transmittance inside a chunk as a ``cumprod``. The blend math
is the oracle's (``ops/reference.py``). Its gradients are autograd's; each
chunk runs under ``torch.utils.checkpoint`` as JAX's under
``jax.checkpoint``, so the backward keeps one chunk's [T, chunk, 256]
intermediates at a time and recomputes the rest.

``max_tile_len`` reports the longest tile: lists longer than L are
truncated, as on the JAX side.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops.binning import bin_gaussians
from fourdgs_tpu_torch.ops.preprocess import preprocess
from fourdgs_tpu_torch.ops.rasterize import RasterOut, untile
from fourdgs_tpu_torch.ops.reference import cap_alpha


def tile_pixel_grid(grid_x: int, grid_y: int, device) -> torch.Tensor:
    """Pixel centres of every tile: [T, 256, 2] float32, row-major tiles and
    row-major pixels in a tile."""
    t = torch.arange(grid_x * grid_y, device=device)
    base = torch.stack([(t % grid_x) * C.TILE_X, (t // grid_x) * C.TILE_Y],
                       dim=-1).to(torch.float32)
    dy, dx = torch.meshgrid(torch.arange(C.TILE_Y, dtype=torch.float32, device=device),
                            torch.arange(C.TILE_X, dtype=torch.float32, device=device),
                            indexing="ij")
    off = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)
    return base[:, None, :] + off[None, :, :]


def _blend_chunk(T_carry, col, dep, xy, conic, rgb, z, op, m, pix):
    """One chunk of every tile's list: the carried (T, colour, depth) after
    it."""
    d = pix[:, None, :, :] - xy[:, :, None, :]              # [T, G, 256, 2]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = cap_alpha(op[..., None] * torch.exp(power))
    keep = (power <= 0.0) & (alpha >= C.ALPHA_FLOOR) & m[..., None]
    alpha = torch.where(keep, alpha, 0.0)
    one_minus = 1.0 - alpha
    t_incl = T_carry[:, None, :] * torch.cumprod(one_minus, dim=1)
    contrib = t_incl >= C.T_STOP
    t_excl = torch.cat([T_carry[:, None, :], t_incl[:, :-1, :]], dim=1)
    w = torch.where(contrib, alpha * t_excl, 0.0)          # [T, G, 256]
    col = col + torch.einsum("tgc,tgn->tcn", rgb, w)
    dep = dep + torch.einsum("tg,tgn->tn", z, w)
    T_new = T_carry * torch.prod(torch.where(contrib, one_minus, 1.0), dim=1)
    return T_new, col, dep


def blend_tiles(tile_xy, tile_conic, tile_rgb, tile_depth, tile_opac,
                tile_mask, pix, bg, chunk: int = 256):
    """Front-to-back blend of the padded per-tile lists [T, L, ...] over the
    pixels ``pix`` [T, 256, 2]; returns per-tile (colour [T, 3, 256] with
    the background composited, depth [T, 256], alpha [T, 256])."""
    T, L = tile_mask.shape
    if L % chunk:
        raise ValueError(f"tile budget {L} is not a multiple of chunk {chunk}")
    n_px = pix.shape[1]
    dev = pix.device
    carry = (torch.ones((T, n_px), dtype=torch.float32, device=dev),
             torch.zeros((T, 3, n_px), dtype=torch.float32, device=dev),
             torch.zeros((T, n_px), dtype=torch.float32, device=dev))
    for lo in range(0, L, chunk):
        xs = tuple(x[:, lo:lo + chunk] for x in (
            tile_xy, tile_conic, tile_rgb, tile_depth, tile_opac, tile_mask))
        if torch.is_grad_enabled():
            carry = checkpoint(_blend_chunk, *carry, *xs, pix, use_reentrant=False)
        else:
            carry = _blend_chunk(*carry, *xs, pix)
    T_fin, col, dep = carry
    col = col + T_fin[:, None, :] * bg[None, :, None]
    return col, dep, 1.0 - T_fin


def rasterize_tiled(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, bg: torch.Tensor,
    instance_budget: int, tile_budget: int,
    colors_precomp=None, cov3d_precomp=None, means2d_offset=None,
    alive=None, chunk: int = 256,
) -> RasterOut:
    """Render one camera through the tiled pipeline (differentiable).
    ``instance_budget``: the cap K on (Gaussian, tile) pairs;
    ``tile_budget``: the cap L on instances per tile (a multiple of
    ``min(chunk, L)``)."""
    opac = opacities.reshape(-1)
    pre = preprocess(
        means3d, scales, rotations, shs, camera_center, world_view,
        full_proj, tanfovx, tanfovy, width, height, sh_degree,
        alive=alive, cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp,
    )
    means2d = pre.means2d if means2d_offset is None else pre.means2d + means2d_offset
    grid_x = (width + C.TILE_X - 1) // C.TILE_X
    grid_y = (height + C.TILE_Y - 1) // C.TILE_Y
    T = grid_x * grid_y
    bins = bin_gaussians(pre.tile_min, pre.tile_max, pre.tiles_touched,
                         pre.depths, grid_x, grid_y, instance_budget)

    # the differentiable payload gather into sorted-instance order, then the
    # per-tile padded slices of it
    gid = bins.gauss_id
    L = tile_budget
    idx = bins.tile_start.long()[:, None] + torch.arange(L, device=gid.device)[None, :]
    mask = idx < bins.tile_stop.long()[:, None]
    idx_c = torch.clamp(idx, max=instance_budget - 1)
    mask = mask & (bins.tile_id < T)[idx_c]
    tiles = [x[gid][idx_c] for x in (means2d, pre.conic, pre.rgb, pre.depths, opac)]

    pix = tile_pixel_grid(grid_x, grid_y, gid.device)
    col, dep, acc = blend_tiles(*tiles, mask, pix, bg, chunk=min(chunk, L))
    tile_len = bins.tile_stop - bins.tile_start
    return RasterOut(
        color=untile(col, grid_x, grid_y, width, height),
        depth=untile(dep[:, None, :], grid_x, grid_y, width, height),
        alpha=untile(acc[:, None, :], grid_x, grid_y, width, height),
        radii=pre.radii,
        means2d=pre.means2d,
        num_rendered=bins.num_rendered,
        max_tile_len=tile_len.max(),
    )
