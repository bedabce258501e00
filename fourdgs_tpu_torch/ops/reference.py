"""The whole-image oracle rasterizer (the ``reference`` backend). PyTorch.

Counterpart of ``fourdgs_tpu/ops/reference.py:35-197``: a direct,
vectorized transcription of the reference CUDA pipeline's blend
(forward.cu:300-379) over every (Gaussian, pixel) pair, O(P·H·W),
differentiable through autograd. It shares none of the binning, payload or
blend code of the ``pallas`` backend (``ops/rasterize.py``, K1 and K2),
which makes it the port's independent check of them, on the CPU and on the
card (``fourdgs_tpu_torch/scripts/render_oracle_gt.py``).

Per pixel, the Gaussians blend in depth order (culled ones last), each only
inside its 3σ tile rect: power = −½(A·dx² + C·dy²) − B·dx·dy, skipped if
positive; α = min(0.99, op·exp(power)), skipped below 1/255; the walk stops
(and skips the stopping Gaussian) once T·(1−α) < 1e-4, expressed through
the inclusive transmittance product T̃_i = Π_{j≤i}(1−α_j): instance i is
kept iff T̃_i ≥ 1e-4. ``chunk`` Gaussians at a time go through a Python
loop, as JAX's ``lax.scan`` walks them, with the transmittance carried.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops.preprocess import preprocess


def cap_alpha(x: torch.Tensor) -> torch.Tensor:
    """α = min(0.99, x) in value, the identity in gradient: the CUDA
    backward does not gate on the cap (backward.cu:478-487), and JAX writes
    it as ``x + stop_gradient(min(x, cap) − x)``, which this repeats to the
    bit."""
    return x + (torch.clamp(x, max=C.ALPHA_CAP) - x).detach()


def _pixel_alpha(means2d, conic, opacity, pix):
    """α of every (Gaussian, pixel) pair [G, N]; 0 where skipped."""
    d = pix[None, :, :] - means2d[:, None, :]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = cap_alpha(opacity[:, None] * torch.exp(power))
    keep = (power <= 0.0) & (alpha >= C.ALPHA_FLOOR)
    return torch.where(keep, alpha, 0.0)


class RasterOut(NamedTuple):
    color: torch.Tensor    # [3, H, W]
    depth: torch.Tensor    # [1, H, W]
    alpha: torch.Tensor    # [1, H, W] accumulated opacity (1 − final T)
    radii: torch.Tensor    # [P] int32
    means2d: torch.Tensor  # [P, 2]


def rasterize_reference(
    means3d, scales, rotations, opacities, shs,
    camera_center, world_view, full_proj, tanfovx, tanfovy,
    width: int, height: int, sh_degree: int, bg: torch.Tensor,
    colors_precomp=None, cov3d_precomp=None, means2d_offset=None,
    alive_mask=None, chunk: int = 128,
) -> RasterOut:
    """Render one camera; differentiable with respect to every Gaussian
    input and ``means2d_offset`` (an all-zeros [P, 2] carrier whose gradient
    is the pixel-space gradient of the means)."""
    opac = opacities.reshape(-1)
    pre = preprocess(
        means3d, scales, rotations, shs, camera_center, world_view,
        full_proj, tanfovx, tanfovy, width, height, sh_degree,
        alive=alive_mask, cov3d_precomp=cov3d_precomp,
        colors_precomp=colors_precomp,
    )
    means2d = pre.means2d if means2d_offset is None else pre.means2d + means2d_offset
    dev = means2d.device
    P = means3d.shape[0]
    n_pad = (-P) % chunk

    # depth order, culled Gaussians last; stable, as CUB's radix sort
    alive = pre.radii > 0
    order = torch.argsort(torch.where(alive, pre.depths, torch.inf), stable=True)

    def gather(x):
        g = x[order]
        return F.pad(g, (0, 0) * (g.dim() - 1) + (0, n_pad)) if n_pad else g

    s_xy, s_conic, s_rgb = gather(means2d), gather(pre.conic), gather(pre.rgb)
    s_depth = gather(pre.depths)
    s_opac = gather(torch.where(alive, opac, 0.0))
    s_tmin, s_tmax = gather(pre.tile_min), gather(pre.tile_max)

    # pixel centres (x, y) = the pixel's integer coordinates (forward.cu:286)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    pix = torch.stack([xs.repeat(height), ys.repeat_interleave(width)], dim=-1)
    pix_tile = torch.stack([torch.div(pix[:, 0], C.TILE_X, rounding_mode="floor"),
                            torch.div(pix[:, 1], C.TILE_Y, rounding_mode="floor")],
                           dim=-1).to(torch.int32)
    N = width * height

    T = torch.ones(N, dtype=torch.float32, device=dev)
    col = torch.zeros((3, N), dtype=torch.float32, device=dev)
    dep = torch.zeros(N, dtype=torch.float32, device=dev)
    for lo in range(0, P + n_pad, chunk):
        sl = slice(lo, lo + chunk)
        alpha = _pixel_alpha(s_xy[sl], s_conic[sl], s_opac[sl], pix)  # [G, N]
        tmin, tmax = s_tmin[sl], s_tmax[sl]
        # a Gaussian blends only into the tiles of its rect
        # (duplicateWithKeys, rasterizer_impl.cu:70-111)
        in_rect = ((pix_tile[None, :, 0] >= tmin[:, None, 0])
                   & (pix_tile[None, :, 0] < tmax[:, None, 0])
                   & (pix_tile[None, :, 1] >= tmin[:, None, 1])
                   & (pix_tile[None, :, 1] < tmax[:, None, 1]))
        alpha = torch.where(in_rect, alpha, 0.0)
        one_minus = 1.0 - alpha
        t_incl = T[None, :] * torch.cumprod(one_minus, dim=0)
        contrib = t_incl >= C.T_STOP
        t_excl = torch.cat([T[None, :], t_incl[:-1]], dim=0)
        w = torch.where(contrib, alpha * t_excl, 0.0)
        col = col + torch.einsum("gc,gn->cn", s_rgb[sl], w)
        dep = dep + torch.einsum("g,gn->n", s_depth[sl], w)
        # T advances only over contributing factors (the stop freezes it)
        T = T * torch.prod(torch.where(contrib, one_minus, 1.0), dim=0)

    color = (col + T[None, :] * bg[:, None]).reshape(3, height, width)
    return RasterOut(
        color=color,
        depth=dep.reshape(1, height, width),
        alpha=(1.0 - T).reshape(1, height, width),
        radii=pre.radii,
        means2d=pre.means2d,
    )
