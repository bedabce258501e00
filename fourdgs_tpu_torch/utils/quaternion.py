"""Quaternion math (wxyz convention), PyTorch.

Counterpart of ``fourdgs_tpu/utils/quaternion.py:13-99``. All functions are
batched over leading dims.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize quaternions [..., 4]."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def _rotation_entries(q: torch.Tensor):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
        2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
        2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y),
    )


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w,x,y,z) → rotation matrix [..., 3, 3], applied to
    the quaternion as given (callers normalize first)."""
    r = _rotation_entries(q)
    return torch.stack(
        [torch.stack(r[0:3], dim=-1), torch.stack(r[3:6], dim=-1),
         torch.stack(r[6:9], dim=-1)],
        dim=-2,
    )


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4], normalized."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return normalize(torch.stack([w, x, y, z], dim=-1))


def covariance_vec6(
    scale: torch.Tensor, q: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Σ = (R S)(R S)ᵀ upper triangle → [..., 6] (xx, xy, xz, yy, yz, zz),
    written component-wise as on the JAX side."""
    s = scale * scaling_modifier
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotation_entries(q)
    s0 = s[..., 0] * s[..., 0]
    s1 = s[..., 1] * s[..., 1]
    s2 = s[..., 2] * s[..., 2]
    # Σ_ij = Σ_k s_k² R_ik R_jk
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)
