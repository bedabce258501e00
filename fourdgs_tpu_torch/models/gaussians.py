"""Gaussian primitive set: fixed-capacity parameters with an alive mask.

Counterpart of ``fourdgs_tpu/models/gaussians.py:31-160``. Every per-primitive
tensor has a static capacity P and the ``alive`` mask says which rows are
real. Dead rows hold the inert fill values of ``DEAD_FILL``. The SH features
are stored rank-2 as on the JAX side: ``f_dc [P,3]`` and ``f_rest [P,3(K−1)]``
coefficient-major.

``params`` is a dict of tensors ``xyz, f_dc, f_rest, scaling, rotation,
opacity`` plus ``deform``, the :class:`~fourdgs_tpu_torch.models.deformation.Deformation`
module.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device

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
    return np.log(x / (1.0 - x))


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
