"""Per-Gaussian forward preprocess: project, EWA 2D covariance, conic, radius,
tile rect, color. PyTorch.

Counterpart of ``fourdgs_tpu/ops/preprocess.py:41-304`` (the reference's
``preprocessCUDA``, forward.cu:156-256): vectorized over [P] Gaussians in
plain tensor code, as the JAX side leaves it to XLA. With ``opacities`` it
also gives the tight α ≥ 1/255 tile rects and the ellipse cull's
``lam_min``/``cull_c`` (``:262-291``), which ``ops/binning.py`` reads when
``tpu.ellipse_tile_cull`` is on; without them (the ``tile`` and
``reference`` backends) the rects are the reference's 3σ squares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.utils import quaternion as quat
from fourdgs_tpu_torch.utils import sh as sh_lib


class PreprocessOut(NamedTuple):
    """Per-Gaussian screen-space quantities (all [P, ...])."""

    means2d: torch.Tensor        # [P,2] pixel-space centers
    depths: torch.Tensor         # [P] view-space z
    conic: torch.Tensor          # [P,3] inverse 2D covariance (a, b, c)
    rgb: torch.Tensor            # [P,3] view-dependent color (clamped >= 0)
    radii: torch.Tensor          # [P] int32 screen radius in pixels (0 = culled)
    tile_min: torch.Tensor       # [P,2] int32 inclusive tile rect min (x, y)
    tile_max: torch.Tensor       # [P,2] int32 exclusive tile rect max (x, y)
    tiles_touched: torch.Tensor  # [P] int32 number of tiles overlapped
    lam_min: torch.Tensor | None = None  # [P] conic min eigenvalue (slot cull)
    cull_c: torch.Tensor | None = None   # [P] ln(255·op), detached


def project_points(means3d, world_view, full_proj):
    """World → (view-space point [P,3], NDC point [P,3]); row-vector
    convention p_hom = [p, 1] @ M."""
    ones = torch.ones_like(means3d[..., :1])
    p_hom4 = torch.cat([means3d, ones], dim=-1)
    p_view = p_hom4 @ world_view[:4, :3]
    p_clip = p_hom4 @ full_proj
    p_w = 1.0 / (p_clip[..., 3:4] + C.W_EPS)
    return p_view, p_clip[..., :3] * p_w


def compute_cov2d(p_view, cov6, world_view, tanfovx, tanfovy, focal_x, focal_y):
    """EWA splatting: 3D covariance [P,6] → 2D screen covariance
    [P,3] = (xx, xy, yy), with the ±1.3·tanfov clamp and +0.3 dilation."""
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    limx = C.EWA_CLAMP_FACTOR * tanfovx
    limy = C.EWA_CLAMP_FACTOR * tanfovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    # world→view rotation: world_view is stored transposed (row vectors)
    R = world_view[:3, :3].T
    m00 = j00 * R[0, 0] + j02 * R[2, 0]
    m01 = j00 * R[0, 1] + j02 * R[2, 1]
    m02 = j00 * R[0, 2] + j02 * R[2, 2]
    m10 = j11 * R[1, 0] + j12 * R[2, 0]
    m11 = j11 * R[1, 1] + j12 * R[2, 1]
    m12 = j11 * R[1, 2] + j12 * R[2, 2]

    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    s00 = m00 * xx + m01 * xy + m02 * xz
    s01 = m00 * xy + m01 * yy + m02 * yz
    s02 = m00 * xz + m01 * yz + m02 * zz
    s10 = m10 * xx + m11 * xy + m12 * xz
    s11 = m10 * xy + m11 * yy + m12 * yz
    s12 = m10 * xz + m11 * yz + m12 * zz
    c_xx = s00 * m00 + s01 * m01 + s02 * m02 + C.COV2D_DILATION
    c_xy = s00 * m10 + s01 * m11 + s02 * m12
    c_yy = s10 * m10 + s11 * m11 + s12 * m12 + C.COV2D_DILATION
    return torch.stack([c_xx, c_xy, c_yy], dim=-1)


def _tile_index(v, grid: int):
    return torch.clamp(torch.floor(v), 0, grid).to(torch.int32)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    shs: torch.Tensor,
    camera_center: torch.Tensor,
    world_view: torch.Tensor,
    full_proj: torch.Tensor,
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    sh_degree: int,
    opacities: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    cull_bounds: bool = False,
) -> PreprocessOut:
    """Vectorized forward preprocess over all P Gaussians.

    ``opacities`` (activated, [P]) gives the exact-safe tight tile rects of
    the JAX side: the rect of the α ≥ 1/255 ellipse, +0.5 px, intersected
    with the reference's 3σ square rect; with ``cull_bounds`` also the
    cull's ``lam_min`` and ``cull_c`` (XLA drops them when unread; here they
    are computed only when asked for, to keep their launches off the main
    path). ``radii`` keep the 3σ semantics. ``cov3d_precomp`` ([P, 6]
    upper triangles or [P, 3, 3]) replaces the covariance of ``scales`` and
    ``rotations``, ``colors_precomp`` [P, 3] the SH colour.
    """
    focal_y = height / (2.0 * tanfovy)
    focal_x = width / (2.0 * tanfovx)

    p_view, p_proj = project_points(means3d, world_view, full_proj)
    depths = p_view[..., 2]
    in_front = depths > C.NEAR_PLANE_Z

    if cov3d_precomp is None:
        cov6 = quat.covariance_vec6(scales, rotations, scale_modifier)
    elif cov3d_precomp.shape[-1] == 6:
        cov6 = cov3d_precomp
    else:   # symmetric [P, 3, 3] → (xx, xy, xz, yy, yz, zz)
        iu = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
        cov6 = torch.stack([cov3d_precomp[..., i, j] for i, j in iu], dim=-1)
    cov2d = compute_cov2d(
        p_view, cov6, world_view, tanfovx, tanfovy, focal_x, focal_y
    )

    # conic; det == 0 ⇒ culled
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    # screen radius from the max eigenvalue
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=C.DET_FLOOR))
    lambda1 = mid + disc
    radius_f = torch.ceil(
        C.RADIUS_SIGMA * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    means2d = torch.stack(
        [
            ((p_proj[..., 0] + 1.0) * width - 1.0) * 0.5,
            ((p_proj[..., 1] + 1.0) * height - 1.0) * 0.5,
        ],
        dim=-1,
    )

    # square 3σ tile rect: inclusive min, exclusive max, clamped
    grid_x = (width + C.TILE_X - 1) // C.TILE_X
    grid_y = (height + C.TILE_Y - 1) // C.TILE_Y
    r = radius_f
    mx, my = means2d[..., 0], means2d[..., 1]
    tmin_x = _tile_index((mx - r) / C.TILE_X, grid_x)
    tmin_y = _tile_index((my - r) / C.TILE_Y, grid_y)
    tmax_x = _tile_index((mx + r + C.TILE_X - 1) / C.TILE_X, grid_x)
    tmax_y = _tile_index((my + r + C.TILE_Y - 1) / C.TILE_Y, grid_y)

    valid = in_front & det_ok
    if alive is not None:
        valid = valid & alive
    tiles_sq = torch.where(
        valid, (tmax_x - tmin_x) * (tmax_y - tmin_y), 0).to(torch.int32)
    alive = valid & (tiles_sq > 0)
    radii = torch.where(alive, radius_f, 0.0).to(torch.int32)

    lam_min = cull_c = None
    if opacities is None:
        tiles = torch.where(alive, tiles_sq, 0).to(torch.int32)
    else:
        # tight rect: per-axis extents of the α ≥ 1/255 ellipse, +0.5 px
        op = opacities.reshape(-1)
        c2 = 2.0 * torch.log(torch.clamp(op, min=1e-12) * (1.0 / C.ALPHA_FLOOR))
        c2 = torch.clamp(c2, min=0.0)
        ext_x = torch.sqrt(c2 * torch.clamp(a, min=0.0)) + 0.5
        ext_y = torch.sqrt(c2 * torch.clamp(c, min=0.0)) + 0.5
        tmin_x = torch.maximum(tmin_x, _tile_index((mx - ext_x) / C.TILE_X, grid_x))
        tmin_y = torch.maximum(tmin_y, _tile_index((my - ext_y) / C.TILE_Y, grid_y))
        tmax_x = torch.minimum(
            tmax_x, torch.clamp(torch.floor((mx + ext_x) / C.TILE_X) + 1, 0, grid_x
                                ).to(torch.int32))
        tmax_y = torch.minimum(
            tmax_y, torch.clamp(torch.floor((my + ext_y) / C.TILE_Y) + 1, 0, grid_y
                                ).to(torch.int32))
        vis = alive & (op > C.ALPHA_FLOOR)
        tiles = torch.where(
            vis & (tmax_x > tmin_x) & (tmax_y > tmin_y),
            (tmax_x - tmin_x) * (tmax_y - tmin_y), 0).to(torch.int32)
    if opacities is not None and cull_bounds:
        # the cull's bound (:271-291): ½·dᵀ·conic·d ≥ ½·λmin·‖d‖², so a tile
        # farther than √(2c/λmin) from the mean holds no pixel with α ≥ 1/255
        with torch.no_grad():
            ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
            half_tr = 0.5 * (ca + cc)
            lam_min = torch.clamp(half_tr - torch.sqrt(torch.clamp(
                (0.5 * (ca - cc)) ** 2 + cb * cb, min=0.0)), min=0.0)
            cull_c = torch.log(torch.clamp(op.detach(), min=1e-12)
                               * (1.0 / C.ALPHA_FLOOR))

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - camera_center[None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
        rgb = sh_lib.sh_to_rgb(sh_degree, shs, dirs)

    return PreprocessOut(
        means2d=means2d,
        depths=depths,
        conic=conic,
        rgb=rgb,
        radii=radii,
        tile_min=torch.stack([tmin_x, tmin_y], dim=-1),
        tile_max=torch.stack([tmax_x, tmax_y], dim=-1),
        tiles_touched=tiles,
        lam_min=lam_min,
        cull_c=cull_c,
    )
