"""Rasterizer: preprocess → binning → payload gather → tile blend.

Counterpart of ``rasterize_pallas`` (``fourdgs_tpu/ops/rasterize.py:151-219``),
``build_table`` (:222-248, :func:`payload_table` with the payload's dtype),
``rasterize_from_table`` (:251-397) and the
payload gather with its scatter-free backward (``_gathered_payload``,
:84-148), with JAX's optional bf16 payload (``payload_bf16``) and its
optional ellipse-vs-tile cull before slot allocation (``ellipse_tile_cull``,
:203-208, ``ops/binning.py::_rect_cull_mask``), and the tile-row slab of the sharded
trainer (``tile_row_offset``, ``tile_rows``, ``tile_row_stride``: the rows
``offset + j·stride``, :291-321). The
gather ``table[gauss_id].T`` is plain ``index_select``; its gradient is a
deterministic segment sum over the binning's slot order (no ``index_add_``,
no atomics). The blend is the CUDA kernels behind
:func:`fourdgs_tpu_torch.ops.blend.blend`. Everything is differentiable with
respect to the Gaussians' parameters and ``means2d_offset``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops.binning import BinningOut, bin_gaussians_fast
from fourdgs_tpu_torch.ops.blend import blend
from fourdgs_tpu_torch.ops.preprocess import PreprocessOut, preprocess

# gradient containment bound (rasterize.py:127-130, loop.py:183-193)
GRAD_CLAMP = 1e12


class RasterOut(NamedTuple):
    color: torch.Tensor         # [3, H, W] bg composited; [T, 5, 256] in tile space
    depth: torch.Tensor         # [1, H, W]; [T, 1, 256] in tile space
    alpha: torch.Tensor         # [1, H, W]; [T, 1, 256] in tile space
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


def contain(g: torch.Tensor) -> torch.Tensor:
    """NaN → 0, ±inf → ±1e12, then a clip to ±1e12: the identity on every
    finite gradient within the bound; it keeps a local float blow-up out of
    sums over other elements and out of Adam's squared moments."""
    return torch.nan_to_num(g, nan=0.0, posinf=GRAD_CLAMP,
                            neginf=-GRAD_CLAMP).clamp_(-GRAD_CLAMP, GRAD_CLAMP)


def payload_grad(d_feat: torch.Tensor, bins: BinningOut, P: int) -> torch.Tensor:
    """``d_table`` [P, 16] from the per-instance ``d_feat`` [16, K]: the
    backward of ``_gathered_payload`` (rasterize.py:108-145).

    1. :func:`contain`, so one non-finite instance gradient stays in its
       own Gaussian's row.
    2. The rows go to pre-sort slot order (``slot`` is a permutation of the
       K slots, so each is written once), where each depth-ranked Gaussian's
       slots are contiguous: ``[seg_starts, seg_starts + seg_counts)``,
       clipped at K (demand above the budget keeps the slots it got, as the
       JAX clip does, :72-77).
    3. ``torch.segment_reduce`` sums each segment on its own, in slot order
       (no running prefix across Gaussians, no scatter, no atomics: two runs
       give the same bits); ``order`` maps the sums back to Gaussians. The
       segments cover the slots below the demand; the padding slots after
       them are never read (``unsafe=True`` skips the check that the
       lengths cover every row, which would also cost a host sync).
    """
    K = d_feat.shape[1]
    d = contain(d_feat.to(torch.float32))
    ordered = torch.empty((K, C.FEAT_ROWS), dtype=torch.float32,
                          device=d.device).index_copy_(0, bins.slot, d.T)
    beg = bins.seg_starts.clamp(max=K)
    lengths = (bins.seg_starts + bins.seg_counts).clamp(max=K) - beg
    seg = torch.segment_reduce(ordered, "sum", lengths=lengths, axis=0,
                               unsafe=True)                         # [P, 16] by rank
    return torch.empty_like(seg).index_copy_(0, bins.order, seg)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even, as XLA's ``astype``) and
    held as float32; differentiable, and its backward rounds the gradient
    to bfloat16 too."""
    return x.to(torch.bfloat16).to(torch.float32)


class _GatheredPayload(torch.autograd.Function):
    """``feat = table[gauss_id].T`` with :func:`payload_grad` as its
    backward (``_gathered_payload``'s custom VJP). With ``bf16`` the
    incoming ``d_feat`` is rounded to bfloat16 first: JAX's blend backward
    casts its cotangent to the payload's dtype (``pallas_blend.py:885-886``)
    before ``_gathered_payload``'s backward upcasts it (``rasterize.py:112``)."""

    @staticmethod
    def forward(ctx, table, bins: BinningOut, bf16: bool = False):
        ctx.bins = bins
        ctx.P = table.shape[0]
        ctx.bf16 = bf16
        # padding slots gather Gaussian 0's (finite) row; the blend's range
        # gates make them inert and K2 leaves their gradient 0
        return table.index_select(0, bins.gauss_id).T.contiguous()

    @staticmethod
    def backward(ctx, d_feat):
        if ctx.bf16:
            d_feat = round_bf16(d_feat)
        return payload_grad(d_feat, ctx.bins, ctx.P), None, None


def payload_table(pre: PreprocessOut, opac: torch.Tensor, means2d: torch.Tensor,
                  payload_bf16: bool = False) -> torch.Tensor:
    """:func:`build_table` in the payload's dtype (``rasterize.py:248``): with
    ``payload_bf16`` a bfloat16 tensor, whose autograd rounds ``d_table`` to
    bfloat16 as JAX's cast does (``rasterize.py:142``). The one place the
    port rounds the payload; :func:`rasterize_from_table` reads it in
    float32, so the kernels see the values JAX's kernels see after their
    upcast (``pallas_blend.py:318-325``)."""
    table = build_table(pre, opac, means2d)
    return table.to(torch.bfloat16) if payload_bf16 else table


def slab_rects(tile_min: torch.Tensor, tile_max: torch.Tensor, tiles_touched: torch.Tensor,
               tile_row_offset: int, tile_rows: int, tile_row_stride: int):
    """The rects clipped to a slab's rows ``offset + j·stride``, j in
    [0, ``tile_rows``), in local ``j`` coordinates, and their new
    ``tiles_touched`` (``rasterize.py:291-321``): j covers the global rows
    in [tmin_y, tmax_y) from ⌈(tmin_y − offset)/stride⌉ to
    ⌈(tmax_y − offset)/stride⌉, clipped to the slab. A row whose incoming
    ``tiles_touched`` is 0 (dead, transparent or off screen: ``preprocess``'s
    gate) stays at 0, as the whole-image path leaves it; JAX's clip
    recounts it from the rect and bins it (a fault the port does not
    copy)."""
    off, s = int(tile_row_offset), int(tile_row_stride)

    def local(y):
        return torch.clamp(torch.div(y - off + s - 1, s, rounding_mode="floor"),
                           0, tile_rows)

    tmin_y, tmax_y = local(tile_min[:, 1]), local(tile_max[:, 1])
    tile_min = torch.stack([tile_min[:, 0], tmin_y], dim=-1)
    tile_max = torch.stack([tile_max[:, 0], tmax_y], dim=-1)
    tiles_touched = torch.where(
        (tmax_y > tmin_y) & (tiles_touched > 0),
        (tile_max[:, 0] - tile_min[:, 0]) * (tmax_y - tmin_y), 0).to(torch.int32)
    return tile_min, tile_max, tiles_touched


def table_inputs(
    table, tile_min, tile_max, tiles_touched, depths,
    width: int, height: int, instance_budget: int,
    tile_row_offset: int = 0, tile_rows: int | None = None,
    tile_row_stride: int = 1, means2d=None, lam_min=None, cull_c=None,
):
    """Bin a payload table's Gaussians into the tiles of the image, or of
    the slab ``tile_rows`` names, and gather the blend's payload: ``(feat
    [16, K], row_off [2] = (offset, stride), bins, grid_x, grid_y)``, the
    half of ``rasterize_from_table`` before the blend (:282-354). A
    bfloat16 ``table`` is read in float32 and the gather's backward rounds
    ``d_feat`` to bfloat16 (``pallas_blend.py:885-886``). With ``means2d``,
    ``lam_min`` and ``cull_c`` the binning runs the ellipse cull first, on
    the slab's rows."""
    grid_x = (width + C.TILE_X - 1) // C.TILE_X
    grid_y = (height + C.TILE_Y - 1) // C.TILE_Y
    # K: the budget rounded up to a CHUNK multiple (rasterize.py:286)
    K = -(-instance_budget // C.CHUNK) * C.CHUNK
    if tile_rows is not None:
        tile_min, tile_max, tiles_touched = slab_rects(
            tile_min, tile_max, tiles_touched, tile_row_offset, tile_rows, tile_row_stride)
        grid_y = tile_rows
    cull_kw = {}
    if means2d is not None and lam_min is not None:
        cull_kw = dict(means2d=means2d.detach(), lam_min=lam_min, cull_c=cull_c,
                       tile_row_offset=tile_row_offset,
                       tile_row_stride=tile_row_stride)
    bins = bin_gaussians_fast(tile_min, tile_max, tiles_touched, depths.detach(),
                              grid_x, grid_y, K, **cull_kw)
    bf16 = table.dtype == torch.bfloat16
    feat = _GatheredPayload.apply(table.to(torch.float32), bins, bf16)   # [16, K]
    row_off = torch.tensor([int(tile_row_offset), int(tile_row_stride)],
                           dtype=torch.int32, device=feat.device)
    return feat, row_off, bins, grid_x, grid_y


def blend_inputs(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, instance_budget: int,
    alive=None, means2d_offset=None, payload_bf16: bool = False,
    ellipse_tile_cull: bool = False, tile_row_offset: int = 0,
    tile_rows: int | None = None, tile_row_stride: int = 1,
) -> BlendInputs:
    """Preprocess, bin and gather one camera's blend inputs (activated
    Gaussian parameters in, as ``rasterize_pallas`` takes them);
    ``means2d_offset`` [P, 2] is added to the means before the table.

    ``payload_bf16``: the table is bfloat16 (:func:`payload_table`).

    ``ellipse_tile_cull``: the binning drops the rect cells no pixel of
    which reaches α = 1/255 before it allocates slots, from the (detached)
    means, ``lam_min`` and ``cull_c``; output-exact, ``num_rendered`` then
    counts the demand after the cull.

    ``tile_rows``: only the slab of rows ``tile_row_offset + j·
    tile_row_stride`` is binned (:func:`table_inputs`)."""
    opac = opacities.reshape(-1)
    pre = preprocess(
        means3d, scales, rotations, shs, camera_center, world_view,
        full_proj, tanfovx, tanfovy, width, height, sh_degree,
        opacities=opac, alive=alive, cull_bounds=ellipse_tile_cull,
    )
    means2d = pre.means2d if means2d_offset is None else pre.means2d + means2d_offset
    table = payload_table(pre, opac, means2d, payload_bf16)
    cull_kw = {}
    if ellipse_tile_cull:
        cull_kw = dict(means2d=means2d, lam_min=pre.lam_min, cull_c=pre.cull_c)
    feat, row_off, bins, grid_x, grid_y = table_inputs(
        table, pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths,
        width, height, instance_budget, tile_row_offset, tile_rows,
        tile_row_stride, **cull_kw)
    return BlendInputs(feat, row_off, bins, pre, grid_x, grid_y)


def untile(x: torch.Tensor, grid_x: int, grid_y: int, width: int,
           height: int) -> torch.Tensor:
    """[T, ch, 256] tile blocks → [ch, H, W] image."""
    ch = x.shape[1]
    img = x.reshape(grid_y, grid_x, ch, C.TILE_Y, C.TILE_X)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        ch, grid_y * C.TILE_Y, grid_x * C.TILE_X)
    return img[:, :height, :width]


def _blend_out(feat, row_off, bins, grid_x, grid_y, width, height, bg, radii,
               means2d_out, tile_space) -> RasterOut:
    """The blend of :func:`table_inputs`' payload, as ``rasterize_from_table``
    returns it (:354-397)."""
    out5 = blend(feat, bins.tile_start, bins.tile_stop, row_off,
                 bg.to(torch.float32).contiguous(), grid_x)
    tile_len = bins.tile_stop - bins.tile_start
    common = dict(radii=radii, means2d=means2d_out,
                  num_rendered=bins.num_rendered, max_tile_len=tile_len.max())
    if tile_space:
        return RasterOut(color=out5, depth=out5[:, 3:4],
                         alpha=1.0 - out5[:, 4:5], **common)

    def img(x):
        return untile(x, grid_x, grid_y, width, height)

    return RasterOut(color=img(out5[:, 0:3]), depth=img(out5[:, 3:4]),
                     alpha=img(1.0 - out5[:, 4:5]), **common)


def rasterize_pallas(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, bg: torch.Tensor,
    instance_budget: int, alive=None, means2d_offset=None,
    tile_space: bool = False, payload_bf16: bool = False,
    ellipse_tile_cull: bool = False, tile_row_offset: int = 0,
    tile_rows: int | None = None, tile_row_stride: int = 1,
) -> RasterOut:
    """Render one camera; keeps the JAX name so the counterpart is easy to
    find (the blend here is the CUDA kernels, or their plain versions on
    CPU). ``tile_space=True`` returns the packed channel-major [T, 5, 256]
    block (r, g, b, depth, t_fin) as ``color`` and [T, 1, 256] views as
    depth and alpha (rasterize.py:359-376), the layout the training loss
    reads. With ``tile_rows`` only the slab of rows ``tile_row_offset + j·
    tile_row_stride`` is rendered: the image is [C, 16·tile_rows, W] (cut at
    ``height``), its row 16·j + p the pixel row p of slab row j."""
    bi = blend_inputs(
        means3d, scales, rotations, opacities, shs, camera_center,
        world_view, full_proj, tanfovx, tanfovy, width, height, sh_degree,
        instance_budget, alive=alive, means2d_offset=means2d_offset,
        payload_bf16=payload_bf16, ellipse_tile_cull=ellipse_tile_cull,
        tile_row_offset=tile_row_offset, tile_rows=tile_rows,
        tile_row_stride=tile_row_stride,
    )
    return _blend_out(bi.feat, bi.row_off, bi.bins, bi.grid_x, bi.grid_y, width,
                      height, bg, bi.pre.radii, bi.pre.means2d, tile_space)


def rasterize_from_table(
    table: torch.Tensor,          # [P, 16] payload (float32 or bfloat16)
    tile_min: torch.Tensor,       # [P, 2] int32
    tile_max: torch.Tensor,       # [P, 2] int32
    tiles_touched: torch.Tensor,  # [P] int32
    depths: torch.Tensor,         # [P] float32 sort key (not differentiated)
    radii: torch.Tensor,          # [P] int32
    means2d_out: torch.Tensor,    # [P, 2] reported means2d
    width: int,
    height: int,
    bg: torch.Tensor,
    instance_budget: int,
    tile_row_offset: int = 0,
    tile_rows: int | None = None,
    tile_row_stride: int = 1,
    tile_space: bool = False,
    means2d=None,
    lam_min=None,
    cull_c=None,
) -> RasterOut:
    """Binning, payload gather and blend from a packed table
    (``rasterize.py:251-397``), the second half of :func:`rasterize_pallas`;
    gradients flow into ``table``. The sharded trainer's table arrives
    all-gathered over ``model`` and everything here is local to the slab."""
    feat, row_off, bins, grid_x, grid_y = table_inputs(
        table, tile_min, tile_max, tiles_touched, depths, width, height,
        instance_budget, tile_row_offset, tile_rows, tile_row_stride,
        means2d=means2d, lam_min=lam_min, cull_c=cull_c)
    return _blend_out(feat, row_off, bins, grid_x, grid_y, width, height, bg,
                      radii, means2d_out, tile_space)
