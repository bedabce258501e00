"""Render API: apply deformation, activations, rasterize. PyTorch.

Counterpart of ``fourdgs_tpu/render.py:32-153``:

- stage "coarse" rasterizes the raw canonical parameters;
- stage "fine" first warps them through the deformation network at the
  camera's time;
- the activations (exp / normalize / sigmoid) come **after** deformation.

The backend is ``cfg.tpu.backend`` unless the caller names one
(``render.py:121-198``): ``pallas``, the production pipeline with its blend
as the CUDA kernels K1 and K2 (``ops/rasterize.py``, with the optional
``tpu.ellipse_tile_cull``); ``tile``, the padded per-tile lists in plain
PyTorch (``ops/tiled.py``); ``reference``, the whole-image oracle
(``ops/reference.py``). The last two are what the config or the caller
chose, never a fallback: on a CUDA device ``pallas`` launches its kernels or
raises.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.ops import rasterize as R
from fourdgs_tpu_torch.ops.reference import rasterize_reference
from fourdgs_tpu_torch.ops.tiled import rasterize_tiled
from fourdgs_tpu_torch.utils.losses import tile_image


class CameraArrays(NamedTuple):
    """Camera data as float32 tensors on the render device."""

    world_view: torch.Tensor     # [4,4]
    full_proj: torch.Tensor      # [4,4]
    camera_center: torch.Tensor  # [3]
    tanfovx: torch.Tensor        # []
    tanfovy: torch.Tensor        # []
    time: torch.Tensor           # []

    @staticmethod
    def from_camera(cam, device="cuda") -> "CameraArrays":
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return CameraArrays(
            world_view=f32(cam.world_view),
            full_proj=f32(cam.full_proj),
            camera_center=f32(cam.camera_center),
            tanfovx=f32(cam.tanfovx),
            tanfovy=f32(cam.tanfovy),
            time=f32(cam.time),
        )


class RenderOut(NamedTuple):
    color: torch.Tensor         # [3, H, W]; packed [T, 5, 256] in tile space
    depth: torch.Tensor         # [1, H, W]; [T, 1, 256] in tile space
    alpha: torch.Tensor         # [1, H, W]; [T, 1, 256] in tile space
    radii: torch.Tensor         # [P] int32
    num_rendered: torch.Tensor  # []
    max_tile_len: torch.Tensor  # []
    dxyz_abs: torch.Tensor      # [P, 3] |Δxyz|


BACKENDS = ("pallas", "tile", "reference")


def _pack_tiles(color, depth, alpha):
    """Image-space (color, depth, alpha) → the ``pallas`` backend's packed
    channel-major tile-space contract (``render.py:201-209``): color =
    [T, 5, 256] (r, g, b, depth, t_fin), depth and alpha [T, 1, 256]."""
    tc, td, ta = map(tile_image, (color, depth, alpha))
    return torch.cat([tc, td, 1.0 - ta], dim=1), td, ta


def activated_gaussians(params: dict[str, Any], state: G.GaussianState,
                        cam: CameraArrays, stage: str, isotropic: bool = False):
    """(means3d, scales, rotations, opacities, shs, dxyz_abs): the stage's
    (deformed) parameters after their activations. ``isotropic``
    (``cfg.model.use_isotropic_gaussian``) repeats the first activated scale
    into all three columns after the deformation and the ``exp``
    (``render.py:113-115``): the deformation's scale head moves all three
    log-scales, and only the first counts."""
    xyz = params["xyz"]
    scaling = params["scaling"]
    rotation = params["rotation"]
    opacity = params["opacity"]
    shs = G.get_features(params)
    if stage == "fine":
        xyz, scaling, rotation, opacity, shs = params["deform"](
            state.aabb, xyz, scaling, rotation, opacity, shs, cam.time)
    elif stage != "coarse":
        raise ValueError(f"unknown stage {stage!r}")
    dxyz_abs = torch.abs(xyz - params["xyz"])
    scales_act = torch.exp(scaling)
    if isotropic:
        scales_act = scales_act[:, :1].repeat(1, 3)
    rot_act = rotation / torch.clamp(
        torch.linalg.vector_norm(rotation, dim=-1, keepdim=True), min=1e-12)
    return xyz, scales_act, rot_act, torch.sigmoid(opacity), shs, dxyz_abs


def render(
    params: dict[str, Any],
    state: G.GaussianState,
    cam: CameraArrays,
    cfg,
    width: int,
    height: int,
    stage: str,
    bg: torch.Tensor,
    active_sh_degree: int,
    device="cuda",
    means2d_offset: torch.Tensor | None = None,
    tile_space: bool = False,
    backend: str | None = None,
) -> RenderOut:
    """Render one camera on ``device`` (the parameters, state, camera and
    background must lie there).

    Differentiable, like the JAX ``render``: callers that only serve turn
    gradients off themselves (``torch.no_grad``). ``means2d_offset`` [P, 2]
    is added to the screen-space means before the payload table (the train
    step's zero carrier, whose gradient is the view-space gradient);
    ``tile_space=True`` returns the packed tile layout of
    :func:`~fourdgs_tpu_torch.ops.rasterize.rasterize_pallas`, which the
    ``tile`` and ``reference`` backends tile their images into.
    ``backend`` overrides ``cfg.tpu.backend``; an unknown one raises
    ``ValueError``.
    """
    dev = resolve_device(device)
    for name, x in (("params['xyz']", params["xyz"]), ("state.alive", state.alive),
                    ("cam.world_view", cam.world_view), ("bg", bg)):
        if x.device.type != dev.type:
            raise ValueError(f"{name} lies on {x.device}, not on {dev}")
    backend = backend or cfg.tpu.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    xyz, scales, rots, opac, shs, dxyz_abs = activated_gaussians(
        params, state, cam, stage, cfg.model.use_isotropic_gaussian)
    common = dict(
        camera_center=cam.camera_center, world_view=cam.world_view,
        full_proj=cam.full_proj, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        width=width, height=height, sh_degree=active_sh_degree, bg=bg,
        means2d_offset=means2d_offset,
    )
    if backend == "pallas":
        out = R.rasterize_pallas(
            xyz, scales, rots, opac, shs, **common,
            instance_budget=cfg.tpu.instance_budget,
            alive=state.alive,
            tile_space=tile_space,
            payload_bf16=cfg.tpu.payload_bf16,
            ellipse_tile_cull=cfg.tpu.ellipse_tile_cull,
        )
        return RenderOut(
            color=out.color, depth=out.depth, alpha=out.alpha, radii=out.radii,
            num_rendered=out.num_rendered, max_tile_len=out.max_tile_len,
            dxyz_abs=dxyz_abs,
        )
    if backend == "tile":
        out = rasterize_tiled(
            xyz, scales, rots, opac, shs, **common,
            instance_budget=cfg.tpu.instance_budget,
            tile_budget=cfg.tpu.tile_budget, chunk=cfg.tpu.blend_chunk,
            alive=state.alive,
        )
        num_rendered, max_tile_len = out.num_rendered, out.max_tile_len
    else:
        out = rasterize_reference(xyz, scales, rots, opac, shs, **common,
                                  alive_mask=state.alive)
        num_rendered = max_tile_len = torch.zeros((), dtype=torch.int32, device=dev)
    color, depth, alpha = out.color, out.depth, out.alpha
    if tile_space:
        color, depth, alpha = _pack_tiles(color, depth, alpha)
    return RenderOut(
        color=color, depth=depth, alpha=alpha, radii=out.radii,
        num_rendered=num_rendered, max_tile_len=max_tile_len,
        dxyz_abs=dxyz_abs,
    )
