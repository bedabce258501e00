"""HexPlane spatio-temporal feature field, PyTorch.

Counterpart of ``fourdgs_tpu/models/hexplane.py:40-243`` with the same
semantics and the same ``[Ra, Rb, F]`` plane layout (feature-last):

- 6 planes per scale from ``itertools.combinations(range(4), 2)`` over
  (x, y, z, t): (xy, xz, xt, yz, yt, zt);
- multires multipliers scale the spatial resolutions only;
- time planes init to 1, spatial planes uniform(0.1, 0.5);
- xyz is normalized to the AABB stored ``[max, min]`` (the inverted mapping:
  max → −1, min → +1), raw t is appended unnormalized (t ∈ [0, 1] reads the
  upper half of the temporal axis);
- bilinear sampling with align_corners=True and border clamping, **product**
  over the 6 planes within a scale, **concat** across scales.

Sampling follows the JAX formulas (one gather of a corner-stacked table for
a spatial plane, a two-nonzero matrix product for a temporal plane at one
shared time), not ``F.grid_sample`` (which wants [F, H, W] planes and swaps
x and y).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F_

from fourdgs_tpu_torch.utils.losses import abs_, clip

SPATIAL_PLANES = (0, 1, 3)   # xy, xz, yz
TEMPORAL_PLANES = (2, 4, 5)  # xt, yt, zt
COO_COMBS = tuple(itertools.combinations(range(4), 2))


def init_hexplane(rng: np.random.Generator, kcfg, multires, a=0.1, b=0.5):
    """Plane arrays keyed ``grid_s{scale}_p{plane}``, float32 numpy, drawn
    from ``rng`` (the JAX side draws from a jax.random key: same
    distributions, other numbers)."""
    planes = {}
    for s, mult in enumerate(multires):
        reso = [r * mult for r in kcfg.resolution[:3]] + [kcfg.resolution[3]]
        for p, comb in enumerate(COO_COMBS):
            shape = (reso[comb[0]], reso[comb[1]], kcfg.output_coordinate_dim)
            if 3 in comb:
                planes[f"grid_s{s}_p{p}"] = np.ones(shape, np.float32)
            else:
                planes[f"grid_s{s}_p{p}"] = rng.uniform(a, b, shape).astype(
                    np.float32)
    return planes


def feat_dim(kcfg, multires) -> int:
    """Concatenated feature width."""
    return kcfg.output_coordinate_dim * len(multires)


def _grid_coord(u: torch.Tensor, R: int):
    """Normalized u ∈ [−1, 1] → (clamped texel coordinate, floor index).
    The clip splits the gradient at a tie as JAX's does. Ties are real here:
    the AABB is the points' own max and min, so the extreme points of each
    axis normalize to exactly ∓1 and land on the clip."""
    x = clip((u + 1.0) * 0.5 * (R - 1), 0.0, R - 1)
    return x, torch.floor(x)    # x ∈ [0, R−1]: the floor is in range


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums the gradient rows of each table
    row in index order, with a stable sort and ``torch.segment_reduce``: no
    atomics, the same bits on every run, and no serialized accumulation of
    duplicate indices (PyTorch's indexed accumulation took ~3.5 ms per
    plane for 65,536 points on the H100, ``profile_train_torch.py``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        sorted_idx, order = torch.sort(idx, stable=True)
        bounds = torch.searchsorted(
            sorted_idx, torch.arange(ctx.n_rows + 1, device=idx.device))
        return torch.segment_reduce(g[order], "sum", lengths=bounds.diff(),
                                    axis=0, unsafe=True), None


def _bilinear_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample [Ra, Rb, F] at normalized (u, v) ∈ [−1, 1]² → [N, F].

    As on the JAX side (hexplane.py:75-118), the four corners come as one
    row of a corner-shifted stacked table [Ra·Rb, 4F] (zero past the
    edges), so the backward is one indexed accumulation per plane, not four.
    The border mask on wx/wy zeroes the weight of a corner past the edge
    and its derivative (grid_sample's border semantics).
    """
    Ra, Rb, F = plane.shape
    x, x0f = _grid_coord(u, Ra)
    y, y0f = _grid_coord(v, Rb)
    x0 = x0f.long()
    y0 = y0f.long()
    wx = ((x - x0f) * (x0 < Ra - 1).to(x.dtype))[:, None]
    wy = ((y - y0f) * (y0 < Rb - 1).to(y.dtype))[:, None]
    # corners (a, b), (a, b+1), (a+1, b), (a+1, b+1), zero past the edges
    pp = F_.pad(plane, (0, 0, 0, 1, 0, 1))
    stacked = torch.cat([pp[:-1, :-1], pp[:-1, 1:], pp[1:, :-1], pp[1:, 1:]],
                        dim=-1).reshape(Ra * Rb, 4 * F)
    rows = _GatherRows.apply(stacked, x0 * Rb + y0)       # [N, 4F]
    return (
        rows[:, :F] * (1 - wx) * (1 - wy)
        + rows[:, F:2 * F] * (1 - wx) * wy
        + rows[:, 2 * F:3 * F] * wx * (1 - wy)
        + rows[:, 3 * F:] * wx * wy
    )


def _bilinear_tslice(plane: torch.Tensor, u: torch.Tensor, t: torch.Tensor):
    """Temporal plane [Ra, Rt, F] sampled at per-point u and one shared
    (0-d) t: lerp the two t-columns into a table [Ra, F], then contract a
    two-nonzero interpolation matrix [N, Ra] with it, as the JAX side does
    (hexplane.py:121-157). Its backward is two matrix products, not a
    scatter-add of N rows into Ra ≪ N rows."""
    Ra, Rt, _ = plane.shape
    ty, t0f = _grid_coord(t, Rt)
    t0 = t0f.long()
    t1 = torch.clamp(t0 + 1, max=Rt - 1)
    wt = ty - t0f
    table = plane[:, t0] * (1.0 - wt) + plane[:, t1] * wt  # [Ra, F]

    x, x0f = _grid_coord(u, Ra)
    wx = (x - x0f)[:, None]
    x0 = x0f.long()[:, None]
    lanes = torch.arange(Ra, device=u.device)
    # x0 == Ra−1 implies wx == 0, and the lane x0+1 does not exist: the
    # border point keeps the gradient −table[x0] through wx, as in JAX
    A = torch.where(lanes == x0, 1.0 - wx,
                    torch.where(lanes == x0 + 1, wx, 0.0))
    return A @ table


def normalize_aabb(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """(xyz − aabb[0]) · 2/(aabb[1] − aabb[0]) − 1, with aabb = [max, min]."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def query_hexplane(
    planes,                 # mapping grid_s{s}_p{p} -> [Ra, Rb, F]
    aabb: torch.Tensor,     # [2,3] = [xyz_max, xyz_min]
    xyz: torch.Tensor,      # [N,3]
    t: torch.Tensor,        # 0-d (shared camera time) or [N] / [N,1]
    multires_len: int,
) -> torch.Tensor:
    """Multi-scale interpolated features → [N, F_total].

    A 0-d ``t`` (one camera time for all points: the render path) takes the
    factorized temporal sampler :func:`_bilinear_tslice`.
    """
    t_scalar = t.dim() == 0
    xyzn = normalize_aabb(xyz, aabb)
    pts = xyzn if t_scalar else torch.cat([xyzn, t.reshape(-1, 1)], dim=-1)
    feats = []
    for s in range(multires_len):
        prod = None
        for p, comb in enumerate(COO_COMBS):
            plane = planes[f"grid_s{s}_p{p}"]
            if t_scalar and comb[1] == 3:
                v = _bilinear_tslice(plane, pts[:, comb[0]], t)
            else:
                v = _bilinear_plane(plane, pts[:, comb[0]], pts[:, comb[1]])
            prod = v if prod is None else prod * v
        feats.append(prod)
    return torch.cat(feats, dim=-1)


def hexplane_regularization(
    planes,
    multires_len: int,
    plane_tv_weight: float,
    time_smoothness_weight: float,
    l1_time_planes_weight: float,
) -> torch.Tensor:
    """The fine stage's grid regularizers (``hexplane.py:209-243``): the mean
    squared second difference along each plane's second axis, weighted by
    ``plane_tv_weight`` on the spatial planes and ``time_smoothness_weight``
    on the temporal ones, plus ``l1_time_planes_weight`` · mean |1 − g| on
    the temporal planes."""
    total_tv = total_time = total_l1 = 0.0
    for s in range(multires_len):
        for p in range(len(COO_COMBS)):
            g = planes[f"grid_s{s}_p{p}"]                  # [Ra, Rb, F]
            d2 = g[:, 2:, :] - 2.0 * g[:, 1:-1, :] + g[:, :-2, :]
            if p in SPATIAL_PLANES:
                total_tv = total_tv + torch.mean(d2 * d2)
            else:
                total_time = total_time + torch.mean(d2 * d2)
                total_l1 = total_l1 + torch.mean(abs_(1.0 - g))
    return (plane_tv_weight * total_tv
            + time_smoothness_weight * total_time
            + l1_time_planes_weight * total_l1)
