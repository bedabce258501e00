"""Gaussian primitive set: fixed-capacity parameters with an alive mask.

Counterpart of ``fourdgs_tpu/models/gaussians.py:31-224``. Every per-primitive
tensor has a static capacity P and the ``alive`` mask says which rows are
real. Dead rows hold the inert fill values of ``DEAD_FILL``. The SH features
are stored rank-2 as on the JAX side: ``f_dc [P,3]`` and ``f_rest [P,3(K−1)]``
coefficient-major.

``params`` is a dict of tensors ``xyz, f_dc, f_rest, scaling, rotation,
opacity`` plus ``deform``, the :class:`~fourdgs_tpu_torch.models.deformation.Deformation`
module.

The set starts from a point cloud (:func:`create_from_pcd`) in a capacity
sized by the cloud, and :func:`grow_capacity` pads every per-primitive
tensor, statistic and Adam moment when densification fills it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.ops.knn import mean_sq_dist_3nn
from fourdgs_tpu_torch.utils.sh import rgb_to_sh

PRIMITIVE_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
# values of a dead slot (create_from_pcd / grow_capacity / load_snapshot)
DEAD_FILL = {"scaling": -10.0, "opacity": -15.0}


class GaussianState(NamedTuple):
    """Parameters plus the auxiliary state the trainer owns."""

    params: dict[str, Any]
    alive: torch.Tensor               # [P] bool
    max_radii2d: torch.Tensor         # [P] f32
    xyz_gradient_accum: torch.Tensor  # [P] f32
    denom: torch.Tensor               # [P] f32
    deformation_accum: torch.Tensor   # [P,3] f32
    deformation_table: torch.Tensor   # [P] bool
    aabb: torch.Tensor                # [2,3] = [xyz_max, xyz_min]
    active_sh_degree: int
    spatial_lr_scale: float


def num_sh_coeffs(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2


def inverse_sigmoid(x):
    """logit; numpy for numpy input, torch for a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1.0 - x))
    return np.log(x / (1.0 - x))


def _fill_dead(prim: dict[str, torch.Tensor], start: int) -> None:
    """Write the dead-slot values into rows ``start:`` of ``prim``."""
    for k in PRIMITIVE_KEYS:
        prim[k][start:] = DEAD_FILL.get(k, 0.0)
    prim["rotation"][start:, 0] = 1.0


def pad_primitives(prim: dict[str, np.ndarray], cap: int) -> dict[str, np.ndarray]:
    """Unpadded primitive arrays [n, ...] → capacity rows, dead rows filled
    with the inert values (rotation (1, 0, 0, 0))."""
    n = prim["xyz"].shape[0]
    if n > cap:
        raise ValueError(f"{n} primitives exceed capacity {cap}")
    out = {}
    for k in PRIMITIVE_KEYS:
        x = np.asarray(prim[k], np.float32)
        widths = [(0, cap - n)] + [(0, 0)] * (x.ndim - 1)
        out[k] = np.pad(x, widths, constant_values=DEAD_FILL.get(k, 0.0))
    out["rotation"][n:, 0] = 1.0
    return out


def state_from_numpy(
    prim: dict[str, np.ndarray],
    deform,
    alive: np.ndarray,
    aabb: np.ndarray,
    active_sh_degree: int,
    deformation_table: np.ndarray | None = None,
    spatial_lr_scale: float = 1.0,
    device="cuda",
) -> GaussianState:
    """Build a :class:`GaussianState` on ``device`` from capacity-sized numpy
    primitive arrays and a :class:`Deformation` module (moved there too)."""
    dev = resolve_device(device)
    params: dict[str, Any] = {
        k: torch.tensor(np.asarray(prim[k], np.float32), device=dev)
        for k in PRIMITIVE_KEYS
    }
    params["deform"] = deform.to(dev)
    alive_t = torch.tensor(np.asarray(alive, bool), device=dev)
    cap = alive_t.shape[0]
    table = alive_t.clone() if deformation_table is None else torch.tensor(
        np.asarray(deformation_table, bool), device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return GaussianState(
        params=params,
        alive=alive_t,
        max_radii2d=zeros(cap),
        xyz_gradient_accum=zeros(cap),
        denom=zeros(cap),
        deformation_accum=zeros(cap, 3),
        deformation_table=table,
        aabb=torch.tensor(np.asarray(aabb, np.float32), device=dev),
        active_sh_degree=int(active_sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
    )


def initial_capacity(cfg, n: int) -> int:
    """``gaussians.py:68-74``: ``cfg.tpu.capacity_init``, or when it is 0
    the multiple of 16,384 covering 4n; at least n, at most
    ``cfg.tpu.capacity``."""
    cap = cfg.tpu.capacity_init
    if cap <= 0:
        cap = -(-max(4 * n, 16384) // 16384) * 16384
    cap = min(max(cap, n), cfg.tpu.capacity)
    if n > cap:
        raise ValueError(f"init cloud ({n}) exceeds capacity ({cap})")
    return cap


def create_from_pcd(cfg, points: np.ndarray, colors: np.ndarray,
                    spatial_lr_scale: float, seed: int = 0,
                    device="cuda") -> GaussianState:
    """A state on ``device`` from a point cloud ``points`` [N, 3] with
    ``colors`` [N, 3] in [0, 1] (``gaussians.py:55-132``): log-scales from
    the 3-NN mean squared distance, identity rotations, opacity 0.1, the DC
    band from the colours, in :func:`initial_capacity` rows whose dead rows
    hold the inert fill; the AABB of the cloud stored [max, min];
    ``active_sh_degree`` 0; the :class:`Deformation` built from ``seed``."""
    dev = resolve_device(device)
    n = points.shape[0]
    cap = initial_capacity(cfg, n)
    k_sh = num_sh_coeffs(cfg.model.sh_degree)
    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp(mean_sq_dist_3nn(pts), min=1e-7)
    log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    params: dict[str, Any] = {
        k: torch.zeros((cap, w), dtype=torch.float32, device=dev)
        for k, w in (("xyz", 3), ("f_dc", 3), ("f_rest", 3 * (k_sh - 1)),
                     ("scaling", 3), ("rotation", 4), ("opacity", 1))
    }
    params["xyz"][:n] = pts
    params["f_dc"][:n] = rgb_to_sh(
        torch.tensor(np.asarray(colors, np.float32), device=dev))
    params["scaling"][:n] = log_scales
    params["rotation"][:n, 0] = 1.0
    params["opacity"][:n] = inverse_sigmoid(
        0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev))
    _fill_dead(params, n)
    params["deform"] = Deformation(cfg.hidden, k_sh, seed=seed, device=dev)
    alive = torch.arange(cap, device=dev) < n

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return GaussianState(
        params=params,
        alive=alive,
        max_radii2d=zeros(cap),
        xyz_gradient_accum=zeros(cap),
        denom=zeros(cap),
        deformation_accum=zeros(cap, 3),
        deformation_table=alive.clone(),
        aabb=torch.stack([pts.amax(dim=0), pts.amin(dim=0)]),
        active_sh_degree=0,
        spatial_lr_scale=float(spatial_lr_scale),
    )


def get_scaling(params, isotropic: bool = False) -> torch.Tensor:
    """exp of the log-scales (``gaussians.py:135-142``). ``isotropic`` (the
    Instant4D mode) repeats the first column into all three: the stored
    log-scales keep three columns, and only the first reaches the result."""
    s = torch.exp(params["scaling"])
    if isotropic:
        s = s[:, :1].repeat(1, 3)
    return s


def get_rotation(params) -> torch.Tensor:
    """Unit quaternions (``gaussians.py:145``)."""
    q = params["rotation"]
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def get_opacity(params) -> torch.Tensor:
    return torch.sigmoid(params["opacity"])


def get_features(params) -> torch.Tensor:
    """[P, K, 3] SH coefficients from the rank-2 stored features."""
    P = params["f_dc"].shape[0]
    return torch.cat(
        [params["f_dc"][:, None, :], params["f_rest"].reshape(P, -1, 3)],
        dim=1,
    )


def count_alive(state: GaussianState) -> torch.Tensor:
    """[] int32 number of live Gaussians."""
    return state.alive.sum(dtype=torch.int32)


def grow_capacity(state: GaussianState, adam_state, new_cap: int):
    """Pad every [P]-shaped tensor to ``new_cap`` rows (``gaussians.py:163-211``):
    the primitives with the dead-slot fill, the statistics and masks with 0
    and False, and the Adam moments of every primitive leaf with 0;
    ``deform`` and its moments stay as they are. Returns ``(state,
    adam_state)`` holding new tensors (the old ones are not written):
    whoever kept the old params dict or moments must take the new ones."""
    old = state.alive.shape[0]
    if new_cap <= old:
        return state, adam_state

    def pad(x, fill=0.0):
        out = torch.full((new_cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[:old] = x.detach()
        return out

    params = {k: pad(state.params[k]) for k in PRIMITIVE_KEYS}
    _fill_dead(params, old)
    params["deform"] = state.params["deform"]

    def pad_moments(tree):
        return {k: (v if k == "deform" else pad(v)) for k, v in tree.items()}

    adam_state = adam_state._replace(mu=pad_moments(adam_state.mu),
                                     nu=pad_moments(adam_state.nu))
    state = state._replace(
        params=params,
        alive=pad(state.alive, False),
        max_radii2d=pad(state.max_radii2d),
        xyz_gradient_accum=pad(state.xyz_gradient_accum),
        denom=pad(state.denom),
        deformation_accum=pad(state.deformation_accum),
        deformation_table=pad(state.deformation_table, False),
    )
    return state, adam_state


def one_up_sh_degree(state: GaussianState, max_sh_degree: int) -> GaussianState:
    """Anneal the active SH degree by one, at most ``max_sh_degree``
    (``gaussians.py:214``)."""
    return state._replace(
        active_sh_degree=min(state.active_sh_degree + 1, max_sh_degree))
