"""Adaptive density control of the fixed-capacity Gaussian set. PyTorch.

Counterpart of ``fourdgs_tpu/models/densify.py:30-290``: the per-step
statistics (view-space gradient norms, max screen radii) and the
maintenance that reads them. Clone and split write into dead slots found by
a free list and zero the Adam moments of every primitive leaf there; prune
clears the alive mask; the opacity reset clamps opacity and zeroes its
moments. Nothing is resized (``models/gaussians.py::grow_capacity`` does
that between steps).

JAX's scatters drop writes at the sentinel index ``cap``
(``.at[dest].set(..., mode="drop")``); here the sentinel entries are masked
out before the write, so when free slots run short the writes beyond the
supply are dropped the same way. The maintenance functions return new
tensors and new dicts; ``moments`` is the pair ``(mu, nu)`` of
``train/adam.py::AdamState``. Thresholds that are products of two
arguments (``percent_dense · extent``, ``0.1 · extent``) are taken in
float32, as the JAX loop's traced float32 scalars give them.

The density-based ``grow`` (the ``--add_point`` path, ``densify.py:228``)
is ported with its draws explicit; neither loop calls it (``add_point``
does nothing on either side).
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models.gaussians import PRIMITIVE_KEYS, GaussianState
from fourdgs_tpu_torch.ops.knn import mean_sq_dist_3nn
from fourdgs_tpu_torch.utils import quaternion as quat


def _f32_product(a: float, b: float) -> float:
    """a·b of float32 operands, rounded to float32."""
    return float(np.float32(a) * np.float32(b))


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


def _free_list(alive: torch.Tensor) -> torch.Tensor:
    """The dead slots in ascending order, [n_free] int64 (a host sync, as
    ``torch.nonzero`` is). JAX pads its list to ``cap`` entries with the
    sentinel ``cap``; the callers here index it only below n_free."""
    return torch.nonzero(~alive).squeeze(1)


def _destinations(sel: torch.Tensor, slot_rank: torch.Tensor,
                  free: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, dest): the selected rows whose slot rank lies within the free
    supply, and the free slot each goes to (``jnp.take(free, rank)`` where
    the rank is below n_free, the dropped sentinel elsewhere)."""
    ok = sel & (slot_rank < free.shape[0])
    rows = torch.nonzero(ok).squeeze(1)
    return rows, free[slot_rank[rows]]


def _scatter_copy(params, moments, rows, dest, extra=None):
    """``densify.py:72-96``: the primitive rows ``rows`` (or the rows of
    ``extra``'s leaves) written to the slots ``dest``, the moments of every
    primitive leaf zeroed there. Returns new (params, moments)."""
    params = dict(params)
    moments = tuple(dict(m) for m in moments)
    for k in PRIMITIVE_KEYS:
        val = params[k] if extra is None or k not in extra else extra[k]
        params[k] = params[k].index_put((dest,), val[rows])
        for m in moments:
            m[k] = m[k].index_fill(0, dest, 0.0)
    return params, moments


def _postfix_reset(state: GaussianState) -> GaussianState:
    """Zero every accumulator (``densify.py:99-107``)."""
    return state._replace(
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom),
        deformation_accum=torch.zeros_like(state.deformation_accum),
        max_radii2d=torch.zeros_like(state.max_radii2d),
    )


def densify_and_clone(state: GaussianState, moments: tuple, grads: torch.Tensor,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float, isotropic: bool = False):
    """Copy the small, high-gradient live Gaussians into free slots
    (``densify.py:110-139``); ``isotropic`` sizes them by the first scale
    (:func:`~fourdgs_tpu_torch.models.gaussians.get_scaling`). Returns
    (state, moments, n_new) with the accumulators reset; n_new is an int."""
    scaling = G.get_scaling(state.params, isotropic)
    sel = ((grads >= grad_threshold)
           & (torch.amax(scaling, dim=1) <= _f32_product(percent_dense, scene_extent))
           & state.alive)
    free = _free_list(state.alive)
    rank = torch.cumsum(sel, 0) - 1
    rows, dest = _destinations(sel, rank, free)
    params, moments = _scatter_copy(state.params, moments, rows, dest)
    state = state._replace(
        params=params,
        alive=state.alive.index_fill(0, dest, True),
        deformation_table=state.deformation_table.index_put(
            (dest,), state.deformation_table[rows]),
    )
    return _postfix_reset(state), moments, int(dest.shape[0])


def split_normals(generator: torch.Generator, n_split: int, cap: int,
                  device) -> torch.Tensor:
    """[n_split, cap, 3] standard normals for :func:`densify_and_split`
    from ``generator``."""
    return torch.randn((n_split, cap, 3), generator=generator,
                       dtype=torch.float32, device=device)


def densify_and_split(state: GaussianState, moments: tuple, grads: torch.Tensor,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float, normals: torch.Tensor,
                      n_split: int = 2, isotropic: bool = False):
    """Split the large, high-gradient live Gaussians into ``n_split``
    children each, drawn from the parent's own distribution, and prune the
    parents whose children were all placed (``densify.py:142-198``).

    ``normals`` [n_split, cap, 3] are the standard normals of the children
    (child j of row p takes ``normals[j, p]``): :func:`split_normals`, or
    JAX's ``jax.random.normal(fold_in(key, j), (cap, 3))`` to reproduce a
    JAX run. ``isotropic`` takes the repeated first scale for the selection,
    the samples and the children's three log-scales (``densify.py:158-176``).
    Returns (state, moments, n_new as an int) with the accumulators reset."""
    cap = state.alive.shape[0]
    if tuple(normals.shape) != (n_split, cap, 3):
        raise ValueError(f"normals {tuple(normals.shape)} != {(n_split, cap, 3)}")
    scaling = G.get_scaling(state.params, isotropic)
    sel = ((grads >= grad_threshold)
           & (torch.amax(scaling, dim=1) > _f32_product(percent_dense, scene_extent))
           & state.alive)
    free = _free_list(state.alive)
    rank = torch.cumsum(sel, 0) - 1
    R = quat.to_rotation_matrix(G.get_rotation(state.params))
    child_scaling = torch.log(torch.clamp(scaling / (0.8 * n_split), min=1e-30))
    params, alive, table = state.params, state.alive, state.deformation_table
    for j in range(n_split):
        samples = normals[j] * scaling
        child_xyz = params["xyz"] + torch.einsum("pij,pj->pi", R, samples)
        rows, dest = _destinations(sel, rank * n_split + j, free)
        params, moments = _scatter_copy(
            params, moments, rows, dest,
            extra={"xyz": child_xyz, "scaling": child_scaling})
        alive = alive.index_fill(0, dest, True)
        table = table.index_put((dest,), state.deformation_table[rows])
    placed = sel & (rank * n_split + (n_split - 1) < free.shape[0])
    state = state._replace(params=params, alive=alive & ~placed,
                           deformation_table=table)
    return _postfix_reset(state), moments, int(placed.sum()) * n_split


def prune(state: GaussianState, min_opacity: float, scene_extent: float,
          size_threshold_on: bool, max_screen_size: float = 20.0,
          isotropic: bool = False):
    """Clear the live Gaussians whose opacity is below ``min_opacity`` and,
    with ``size_threshold_on`` (after the first opacity reset), those wider
    than ``max_screen_size`` px on screen or 0.1·extent in the world
    (``densify.py:201-225``; ``isotropic``: by the first scale). Returns
    (state, n_pruned as a 0-d tensor)."""
    mask = G.get_opacity(state.params)[:, 0] < min_opacity
    if size_threshold_on:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = (torch.amax(G.get_scaling(state.params, isotropic), dim=1)
                  > _f32_product(0.1, scene_extent))
        mask = mask | big_vs | big_ws
    mask = mask & state.alive
    return state._replace(alive=state.alive & ~mask), mask.sum()


def grow(state: GaussianState, moments: tuple, density_threshold: float = 5.0,
         displacement_scale: float = 5.0, *, generator: torch.Generator | None = None,
         normals: torch.Tensor | None = None):
    """Density-based point growth (``densify.py:228-276``, the reference's
    ``upsample_point_cloud``): each live Gaussian whose nearest-neighbour
    distance (√ of the 3-NN mean squared distance, dead slots pushed 1e6
    away) exceeds ``density_threshold`` spawns a copy displaced by
    ``normals · displacement_scale``, kept if inside the deformation AABB,
    written into a free slot with zeroed moments.

    The [cap, 3] standard ``normals`` come from ``generator`` unless given
    (the tests pass JAX's draws). Returns (state, moments, n_new as an int)
    with the accumulators reset."""
    cap = state.alive.shape[0]
    xyz = state.params["xyz"]
    if normals is None:
        if generator is None:
            raise ValueError("grow needs a generator or the normals")
        normals = torch.randn((cap, 3), generator=generator, dtype=torch.float32,
                              device=xyz.device)
    far = torch.where(state.alive[:, None], xyz, 1e6)
    nn_d = torch.sqrt(torch.clamp(mean_sq_dist_3nn(far), min=0.0))
    new_xyz = xyz + normals * displacement_scale
    in_aabb = torch.all((new_xyz < state.aabb[0]) & (new_xyz > state.aabb[1]), dim=-1)
    sel = (nn_d > density_threshold) & state.alive & in_aabb
    rows, dest = _destinations(sel, torch.cumsum(sel, 0) - 1, _free_list(state.alive))
    params, moments = _scatter_copy(state.params, moments, rows, dest,
                                    extra={"xyz": new_xyz})
    state = state._replace(
        params=params,
        alive=state.alive.index_fill(0, dest, True),
        deformation_table=state.deformation_table.index_put(
            (dest,), state.deformation_table[rows]),
    )
    return _postfix_reset(state), moments, int(dest.shape[0])


def reset_opacity(state: GaussianState, moments: tuple):
    """Clamp every opacity to at most 0.01 and zero its Adam moments
    (``densify.py:277-290``). Returns (state, moments)."""
    params = dict(state.params)
    params["opacity"] = G.inverse_sigmoid(
        torch.clamp(G.get_opacity(state.params), max=0.01))
    moments = tuple(dict(m, opacity=torch.zeros_like(m["opacity"]))
                    for m in moments)
    return state._replace(params=params), moments
