"""Densification statistics of the fixed-capacity Gaussian set. PyTorch.

Counterpart of ``fourdgs_tpu/models/densify.py:30-96``: the per-step
accumulation of view-space gradient norms and max screen radii, and their
average. Clone, split, prune and the opacity reset are not ported yet.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch.models.gaussians import GaussianState


def add_densification_stats(
    state: GaussianState,
    means2d_grad_px: torch.Tensor,   # [P, 2] dL/d(pixel-space means2D)
    radii: torch.Tensor,             # [P] int32 from the render
    width: int,
    height: int,
) -> GaussianState:
    """Accumulate the view-space gradient norm of each visible, live
    Gaussian and update ``max_radii2d``. The pixel-space gradient is scaled
    by (W/2, H/2) to the NDC scale the reference's screen-space tensor
    receives, so ``densify_grad_threshold`` keeps its meaning."""
    update = (radii > 0) & state.alive
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=means2d_grad_px.device)
    norm = torch.linalg.vector_norm(means2d_grad_px * scale, dim=-1)
    return state._replace(
        xyz_gradient_accum=state.xyz_gradient_accum + torch.where(update, norm, 0.0),
        denom=state.denom + update.to(torch.float32),
        max_radii2d=torch.where(
            update, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d),
    )


def compute_grads(state: GaussianState) -> torch.Tensor:
    """Average view-space gradient norm since the last reset; 0 where a
    Gaussian was never seen."""
    g = state.xyz_gradient_accum / state.denom
    return torch.where(torch.isnan(g) | (state.denom == 0), 0.0, g)
