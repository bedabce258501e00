"""DenseGrid: a trilinearly sampled dense 3D voxel grid. PyTorch.

Counterpart of ``fourdgs_tpu/models/grid.py:15-59`` (the reference's
scene/grid.py:14-54): a C-channel grid over an AABB, sampled trilinearly
with border clamping, the optional ``empty_voxel`` occupancy mask of the
deformation net. ``empty_voxel`` does nothing on either side
(``models/deformation.py``), so nothing calls these yet.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch import resolve_device


def init_dense_grid(channels: int = 1, world_size: tuple[int, int, int] = (64, 64, 64),
                    device="cuda") -> torch.Tensor:
    """Grid parameter [X, Y, Z, C], zero-initialised as in the reference."""
    return torch.zeros((*world_size, channels), dtype=torch.float32,
                       device=resolve_device(device))


def sample_dense_grid(grid: torch.Tensor, aabb: torch.Tensor,
                      xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear sample at world points [N, 3] → [N, C]. ``aabb`` is [2, 3]
    = [max, min] (the project's convention): min maps to index 0, max to
    R − 1, and points outside clamp to the border."""
    X, Y, Z, Cc = grid.shape
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=grid.device)
    span = aabb[0] - aabb[1]
    u = (xyz - aabb[1]) / torch.where(span == 0, 1.0, span)
    coords = torch.minimum(torch.maximum(u * hi, torch.zeros_like(hi)), hi)
    c0 = torch.floor(coords).long()
    c1 = torch.minimum(c0 + 1, hi.long())
    w = coords - c0.to(torch.float32)
    flat = grid.reshape(-1, Cc)

    def g(ix, iy, iz):
        return flat[(ix * Y + iy) * Z + iz]

    x0, y0, z0 = c0[:, 0], c0[:, 1], c0[:, 2]
    x1, y1, z1 = c1[:, 0], c1[:, 1], c1[:, 2]
    wx, wy, wz = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    return (
        g(x0, y0, z0) * (1 - wx) * (1 - wy) * (1 - wz)
        + g(x1, y0, z0) * wx * (1 - wy) * (1 - wz)
        + g(x0, y1, z0) * (1 - wx) * wy * (1 - wz)
        + g(x0, y0, z1) * (1 - wx) * (1 - wy) * wz
        + g(x1, y1, z0) * wx * wy * (1 - wz)
        + g(x1, y0, z1) * wx * (1 - wy) * wz
        + g(x0, y1, z1) * (1 - wx) * wy * wz
        + g(x1, y1, z1) * wx * wy * wz
    )
