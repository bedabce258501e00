"""Rasterizer: preprocess → binning → payload gather → tile blend.

Counterpart of the forward of ``rasterize_pallas``
(``fourdgs_tpu/ops/rasterize.py:151-219``), ``build_table`` (:222-248) and
``rasterize_from_table`` (:251-397). The payload gather ``table[gauss_id].T``
is plain ``index_select`` (an XLA op on the JAX side); the blend is the CUDA
kernel behind :func:`fourdgs_tpu_torch.ops.blend.blend_forward`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops.binning import BinningOut, bin_gaussians_fast
from fourdgs_tpu_torch.ops.blend import blend_forward
from fourdgs_tpu_torch.ops.preprocess import PreprocessOut, preprocess


class RasterOut(NamedTuple):
    color: torch.Tensor         # [3, H, W], bg composited
    depth: torch.Tensor         # [1, H, W]
    alpha: torch.Tensor         # [1, H, W]
    radii: torch.Tensor         # [P] int32
    means2d: torch.Tensor       # [P, 2]
    num_rendered: torch.Tensor  # [] int64 instance demand (may exceed K)
    max_tile_len: torch.Tensor  # [] int32


class BlendInputs(NamedTuple):
    """Everything the blend kernel reads, plus the binning it came from."""

    feat: torch.Tensor          # [16, K] float32 payload
    row_off: torch.Tensor       # [2] int32 = (offset, stride)
    bins: BinningOut
    pre: PreprocessOut
    grid_x: int
    grid_y: int


def build_table(pre: PreprocessOut, opac: torch.Tensor,
                means2d: torch.Tensor) -> torch.Tensor:
    """[P, 16] payload table: x, y, conic a/b/c, opacity, r, g, b, depth,
    6 zero pad columns."""
    P = means2d.shape[0]
    return torch.cat(
        [
            means2d,
            pre.conic,
            opac[:, None],
            pre.rgb,
            pre.depths[:, None],
            torch.zeros((P, C.FEAT_ROWS - 10), dtype=torch.float32,
                        device=means2d.device),
        ],
        dim=1,
    )


def blend_inputs(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, instance_budget: int,
    alive=None,
) -> BlendInputs:
    """Preprocess, bin and gather one camera's blend inputs (activated
    Gaussian parameters in, as ``rasterize_pallas`` takes them)."""
    opac = opacities.reshape(-1)
    pre = preprocess(
        means3d, scales, rotations, shs, camera_center, world_view,
        full_proj, tanfovx, tanfovy, width, height, sh_degree,
        opacities=opac, alive=alive,
    )
    table = build_table(pre, opac, pre.means2d)
    grid_x = (width + C.TILE_X - 1) // C.TILE_X
    grid_y = (height + C.TILE_Y - 1) // C.TILE_Y
    # K: the budget rounded up to a CHUNK multiple (rasterize.py:286)
    K = -(-instance_budget // C.CHUNK) * C.CHUNK
    bins = bin_gaussians_fast(
        pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths,
        grid_x, grid_y, K,
    )
    # padding slots gather Gaussian 0's (finite) row; the blend's range gates
    # make them inert
    feat = table.index_select(0, bins.gauss_id).T.contiguous()   # [16, K]
    row_off = torch.tensor([0, 1], dtype=torch.int32, device=feat.device)
    return BlendInputs(feat, row_off, bins, pre, grid_x, grid_y)


def untile(x: torch.Tensor, grid_x: int, grid_y: int, width: int,
           height: int) -> torch.Tensor:
    """[T, ch, 256] tile blocks → [ch, H, W] image."""
    ch = x.shape[1]
    img = x.reshape(grid_y, grid_x, ch, C.TILE_Y, C.TILE_X)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        ch, grid_y * C.TILE_Y, grid_x * C.TILE_X)
    return img[:, :height, :width]


def rasterize_pallas(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, bg: torch.Tensor,
    instance_budget: int, alive=None,
) -> RasterOut:
    """Render one camera; keeps the JAX name so the counterpart is easy to
    find (the blend here is the CUDA kernel, or its plain version on CPU)."""
    bi = blend_inputs(
        means3d, scales, rotations, opacities, shs, camera_center,
        world_view, full_proj, tanfovx, tanfovy, width, height, sh_degree,
        instance_budget, alive=alive,
    )
    bins = bi.bins
    out5 = blend_forward(
        bi.feat, bins.tile_start, bins.tile_stop, bi.row_off,
        bg.to(torch.float32).contiguous(), bi.grid_x,
    )
    tile_len = bins.tile_stop - bins.tile_start

    def img(x):
        return untile(x, bi.grid_x, bi.grid_y, width, height)

    return RasterOut(
        color=img(out5[:, 0:3]),
        depth=img(out5[:, 3:4]),
        alpha=img(1.0 - out5[:, 4:5]),
        radii=bi.pre.radii,
        means2d=bi.pre.means2d,
        num_rendered=bins.num_rendered,
        max_tile_len=tile_len.max(),
    )
