"""The train step, PyTorch.

Counterpart of ``fourdgs_tpu/train/loop.py::make_train_step`` (:51-220).
One step renders each camera of the batch in tile space with a zero
``means2d_offset`` carrier (its gradient is the view-space gradient), takes
the masked L1 loss against the GT tiled 5-wide, adds the fine stage's grid
regularizers, and then, from one ``torch.autograd.grad`` call over every
parameter leaf and the carrier: ``sanitize_grads``, Adam with the per-group
learning rates, the densification statistics and the deformation
accumulator. The backward runs K2 (the backward tile blend) and the
deterministic per-Gaussian segment sum of ``ops/rasterize.py``.

``scene_reconstruction``, the maintenance steps and SSIM (``lambda_dssim``)
are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models import densify as dens
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models import hexplane as hp
from fourdgs_tpu_torch.ops.rasterize import contain
from fourdgs_tpu_torch.render import CameraArrays, render
from fourdgs_tpu_torch.train import adam
from fourdgs_tpu_torch.utils import losses


def sanitize_grads(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """``loop.py:183-193``: :func:`~fourdgs_tpu_torch.ops.rasterize.contain`
    on every leaf (``payload_grad`` does the same per instance)."""
    return [contain(g) for g in grads]


def make_train_step(cfg, width: int, height: int, stage: str,
                    active_sh_degree: int, spatial_lr_scale: float = 1.0,
                    device="cuda") -> Callable:
    """Build ``step(params, adam_state, state, cams, gts, step) →
    (params, adam_state, state, metrics)`` for a (resolution, stage, SH
    degree) on ``device``.

    - ``params``: the port's parameter dict (primitives and the
      ``Deformation`` module), updated in place and returned;
    - ``adam_state``: :class:`~fourdgs_tpu_torch.train.adam.AdamState`, its
      moments updated in place;
    - ``state``: the :class:`~fourdgs_tpu_torch.models.gaussians.GaussianState`
      whose statistics the step accumulates (returned anew);
    - ``cams``: a :class:`~fourdgs_tpu_torch.render.CameraArrays` whose
      tensors carry a leading batch dimension B;
    - ``gts``: the GT batch in any form ``loop.py:97-132`` accepts: float
      [B, C, H, W] (C ≥ 3), uint8 [B, H, W, C], or pre-tiled [B, T, 3, 256]
      uint8 or [B, T, 5, 256] float;
    - ``step``: the 1-based iteration number for the schedules.

    The metrics are 0-d tensors: ``loss``, ``l1``, ``psnr``,
    ``num_rendered``, ``max_tile_len``, ``n_points``.
    """
    dev = resolve_device(device)
    if cfg.opt.lambda_dssim != 0:
        raise NotImplementedError("lambda_dssim != 0 (SSIM) is not ported yet")
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    padded = (height % 16 != 0) or (width % 16 != 0)
    n_px = 3 * height * width
    n_tiles = (-(-height // 16)) * (-(-width // 16))
    # the loss reads the colour channels of the packed (r, g, b, depth,
    # t_fin) render, and no tile-grid padding pixel
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None]
    if padded:
        mask = mask * losses.tile_pixel_mask(height, width, device=dev)
    regularize = stage == "fine" and cfg.hidden.time_smoothness_weight != 0

    def gt_tiles(gts: torch.Tensor) -> torch.Tensor:
        """Any accepted GT form → float [B, T, 5, 256]."""
        if gts.dim() == 4 and gts.shape[1] == n_tiles and gts.shape[3] == 256:
            if gts.dtype == torch.uint8:
                return F.pad(gts.to(torch.float32) / 255.0, (0, 0, 0, 2))
            return gts
        if gts.dtype == torch.uint8:
            gts = gts.to(torch.float32).permute(0, 3, 1, 2) / 255.0
        return torch.stack([losses.tile_image(g[:3], pad_cols=2) for g in gts])

    def loss_fn(leaves, carrier, state, cams, gts_cmp):
        """(loss, l1, psnr, per-camera render outputs) of the batch."""
        B = gts_cmp.shape[0]
        outs = [
            render(leaves, state, CameraArrays(*(x[i] for x in cams)), cfg,
                   width, height, stage, bg, active_sh_degree, device=dev,
                   means2d_offset=carrier[i], tile_space=True)
            for i in range(B)
        ]
        colors = torch.stack([o.color for o in outs])         # [B, T, 5, 256]
        diff = (colors - gts_cmp) * mask
        # the same values as the image-space means: the denominators count
        # the true colour pixels only
        l1 = torch.sum(losses.abs_(diff)) / (B * n_px)
        with torch.no_grad():
            mse = torch.sum(diff * diff, dim=(1, 2, 3)) / n_px
            psnr = torch.mean(
                20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-20))))
        loss = l1
        if regularize:
            loss = loss + hp.hexplane_regularization(
                leaves["deform"].grids, len(cfg.hidden.multires),
                cfg.hidden.plane_tv_weight, cfg.hidden.time_smoothness_weight,
                cfg.hidden.l1_time_planes)
        return loss, l1, psnr, outs

    def train_step(params, adam_state: adam.AdamState, state: G.GaussianState,
                   cams: CameraArrays, gts: torch.Tensor, step: int):
        B = gts.shape[0]
        P = params["xyz"].shape[0]
        prim = {k: params[k].detach().requires_grad_() for k in G.PRIMITIVE_KEYS}
        leaves = dict(prim, deform=params["deform"])
        carrier = torch.zeros((B, P, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        loss, l1, psnr, outs = loss_fn(leaves, carrier, state, cams, gt_tiles(gts))

        # every parameter leaf and the carrier in one call; leaves the loss
        # does not reach (the unused heads, timenet) get zeros
        named = adam.named_leaves(leaves)
        grads = torch.autograd.grad(
            loss, [x for _, x in named] + [carrier], materialize_grads=True)
        g_leaves, g_carrier = list(grads[:-1]), grads[-1]
        if cfg.tpu.sanitize_grads:
            g_leaves = sanitize_grads(g_leaves)
        lrs = adam.learning_rates(step, cfg.opt, spatial_lr_scale)
        params, adam_state = adam.update(
            params, adam.tree_like(params, g_leaves), adam_state,
            adam.lr_tree_for_params(params, lrs))

        radii = torch.stack([o.radii for o in outs]).amax(dim=0)  # max over batch
        vs_grad = g_carrier.sum(dim=0)                            # sum over batch
        state = dens.add_densification_stats(state, vs_grad, radii, width, height)
        state = state._replace(deformation_accum=state.deformation_accum
                               + torch.stack([o.dxyz_abs.detach() for o in outs]).mean(dim=0))
        metrics = {
            "loss": loss.detach(),
            "l1": l1.detach(),
            "psnr": psnr,
            "num_rendered": torch.stack([o.num_rendered for o in outs]).amax(),
            "max_tile_len": torch.stack([o.max_tile_len for o in outs]).amax(),
            "n_points": G.count_alive(state),
        }
        return params, adam_state, state, metrics

    train_step.loss_fn = loss_fn     # the step's parts, for profiling
    train_step.gt_tiles = gt_tiles
    return train_step
