"""HexPlane spatio-temporal feature field, PyTorch.

Counterpart of ``fourdgs_tpu/models/hexplane.py:40-206`` with the same
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

Sampling is a direct 4-corner gather of the JAX formula, not
``F.grid_sample`` (which wants [F, H, W] planes and swaps x and y).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

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
    """Normalized u ∈ [−1, 1] → (clamped texel coordinate, floor index)."""
    x = torch.clamp((u + 1.0) * 0.5 * (R - 1), 0.0, R - 1)
    x0 = torch.clamp(torch.floor(x), 0, R - 1)
    return x, x0


def _bilinear_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample [Ra, Rb, F] at normalized (u, v) ∈ [−1, 1]² → [N, F].

    The border mask on wx/wy (hexplane.py:102-105) zeroes the weight of the
    corner past the edge, so the clamped corner index contributes exactly 0,
    as the JAX side's zero-padded corner does.
    """
    Ra, Rb, F = plane.shape
    x, x0f = _grid_coord(u, Ra)
    y, y0f = _grid_coord(v, Rb)
    x0 = x0f.long()
    y0 = y0f.long()
    wx = ((x - x0f) * (x0 < Ra - 1).to(x.dtype))[:, None]
    wy = ((y - y0f) * (y0 < Rb - 1).to(y.dtype))[:, None]
    x1 = torch.clamp(x0 + 1, max=Ra - 1)
    y1 = torch.clamp(y0 + 1, max=Rb - 1)
    flat = plane.reshape(Ra * Rb, F)
    c00 = flat[x0 * Rb + y0]
    c01 = flat[x0 * Rb + y1]
    c10 = flat[x1 * Rb + y0]
    c11 = flat[x1 * Rb + y1]
    return (
        c00 * (1 - wx) * (1 - wy)
        + c01 * (1 - wx) * wy
        + c10 * wx * (1 - wy)
        + c11 * wx * wy
    )


def _bilinear_tslice(plane: torch.Tensor, u: torch.Tensor, t: torch.Tensor):
    """Temporal plane [Ra, Rt, F] sampled at per-point u and one shared
    (0-d) t: lerp the two t-columns into a table [Ra, F], then lerp that
    table at each u (hexplane.py:121-157; the JAX side contracts a
    two-nonzero [N, Ra] matrix on the MXU, which is the same sum)."""
    Ra, Rt, _ = plane.shape
    ty, t0f = _grid_coord(t, Rt)
    t0 = t0f.long()
    t1 = torch.clamp(t0 + 1, max=Rt - 1)
    wt = ty - t0f
    table = plane[:, t0] * (1.0 - wt) + plane[:, t1] * wt  # [Ra, F]

    x, x0f = _grid_coord(u, Ra)
    wx = (x - x0f)[:, None]
    x0 = x0f.long()
    # x0 == Ra−1 implies wx == 0: the clamped second corner carries no weight
    x1 = torch.clamp(x0 + 1, max=Ra - 1)
    return table[x0] * (1.0 - wx) + table[x1] * wx


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
