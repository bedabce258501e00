"""Render API: apply deformation, activations, rasterize. PyTorch.

Counterpart of ``fourdgs_tpu/render.py:32-153``:

- stage "coarse" rasterizes the raw canonical parameters;
- stage "fine" first warps them through the deformation network at the
  camera's time;
- the activations (exp / normalize / sigmoid) come **after** deformation.

The rasterizer is the ``pallas`` backend's pipeline with its blend as the
CUDA kernel; the config's other rasterizer options are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.ops import rasterize as R


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
    color: torch.Tensor         # [3, H, W]
    depth: torch.Tensor         # [1, H, W]
    alpha: torch.Tensor         # [1, H, W]
    radii: torch.Tensor         # [P] int32
    num_rendered: torch.Tensor  # []
    max_tile_len: torch.Tensor  # []
    dxyz_abs: torch.Tensor      # [P, 3] |Δxyz|


def _check_config(cfg) -> None:
    if cfg.tpu.backend != "pallas":
        raise NotImplementedError(
            f"backend {cfg.tpu.backend!r} is not ported (only 'pallas')")
    if cfg.tpu.payload_bf16:
        raise NotImplementedError("payload_bf16 is not ported")
    if cfg.tpu.ellipse_tile_cull:
        raise NotImplementedError("ellipse_tile_cull is not ported")
    if cfg.model.use_isotropic_gaussian:
        raise NotImplementedError("use_isotropic_gaussian is not ported")


def activated_gaussians(params: dict[str, Any], state: G.GaussianState,
                        cam: CameraArrays, stage: str):
    """(means3d, scales, rotations, opacities, shs, dxyz_abs): the stage's
    (deformed) parameters after their activations."""
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
    rot_act = rotation / torch.clamp(
        torch.linalg.vector_norm(rotation, dim=-1, keepdim=True), min=1e-12)
    return xyz, scales_act, rot_act, torch.sigmoid(opacity), shs, dxyz_abs


@torch.no_grad()
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
) -> RenderOut:
    """Render one camera on ``device`` (the parameters, state, camera and
    background must lie there)."""
    dev = resolve_device(device)
    for name, x in (("params['xyz']", params["xyz"]), ("state.alive", state.alive),
                    ("cam.world_view", cam.world_view), ("bg", bg)):
        if x.device.type != dev.type:
            raise ValueError(f"{name} lies on {x.device}, not on {dev}")
    _check_config(cfg)
    xyz, scales, rots, opac, shs, dxyz_abs = activated_gaussians(
        params, state, cam, stage)
    out = R.rasterize_pallas(
        xyz, scales, rots, opac, shs,
        camera_center=cam.camera_center,
        world_view=cam.world_view,
        full_proj=cam.full_proj,
        tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy,
        width=width,
        height=height,
        sh_degree=active_sh_degree,
        bg=bg,
        instance_budget=cfg.tpu.instance_budget,
        alive=state.alive,
    )
    return RenderOut(
        color=out.color, depth=out.depth, alpha=out.alpha, radii=out.radii,
        num_rendered=out.num_rendered, max_tile_len=out.max_tile_len,
        dxyz_abs=dxyz_abs,
    )
