"""The sharded train step: one step of the trainer over a
``('data', 'model')`` grid of ranks.

Counterpart of ``fourdgs_tpu/parallel/trainer.py``:

  data  — cameras of the batch (its size must divide by the axis)
  model — interleaved 16-pixel tile rows: rank m renders the rows
          {m, m + M, m + 2M, ...} of every camera against the whole
          primitive set (K1 and K2 with tile-row offset m and stride M)

The parameters are replicated on every rank, or, with
``cfg.tpu.shard_primitives``, the per-Gaussian leaves and their Adam
moments are sharded on ``model`` (rank m holds rows [m·P/M, (m+1)·P/M))
and all-gathered inside the loss, whose backward reduce-scatters their
gradients. With ``cfg.tpu.shard_preprocess`` (the default; it applies when
M > 1) each rank deforms and preprocesses only its [P/M] slice, and the
[P, 16] payload table is all-gathered over ``model`` in its place.

Each rank computes its additive share of the loss (``local_loss``: L1 over
all B·3·H·W pixels, the grid regularizer over D·M, D-SSIM on the gathered
rows weighted B_local/(B·M)), takes the gradient of that share, and the
gradients are summed over the grid: the per-Gaussian leaves over ``data``
alone under ``shard_primitives`` (the reduce-scatter already summed
``model``), every other leaf over both axes. Adam then runs on every rank
from the same gradients, so the state stays identical on every rank. Like
JAX's, this step does not sanitize the gradients (the single-device step
does, ``train/loop.py::sanitize_grads``).
"""

from __future__ import annotations

from typing import Callable

import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.models import densify as dens
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models import hexplane as hp
from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops import rasterize as R
from fourdgs_tpu_torch.ops.preprocess import preprocess
from fourdgs_tpu_torch.parallel.collectives import all_gather, broadcast_, pmax, psum
from fourdgs_tpu_torch.parallel.mesh import Mesh
from fourdgs_tpu_torch.render import CameraArrays, activated_gaussians
from fourdgs_tpu_torch.train import adam
from fourdgs_tpu_torch.utils import losses

# Per-Gaussian parameter leaves ([P, ...], shardable on 'model'); "deform"
# (the field and its MLPs) does not grow with P and stays replicated.
PRIM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def interleave_gt_rows(gts: torch.Tensor, n_model: int) -> torch.Tensor:
    """Reorder a [B, C, H, W] GT so that its contiguous split of H into
    ``n_model`` parts hands part s the interleaved tile rows {s, s + N,
    ...} (``trainer.py:102-124``): part s's slab row j is global tile row
    s + j·N. A shape whose tile rows do not divide (or H % 16 != 0) is
    returned untouched, as the step rejects it."""
    if n_model == 1:
        return gts
    B, Cc, H, W = gts.shape
    ty = C.TILE_Y
    grid_y = -(-H // ty)
    if grid_y % n_model != 0 or H % ty != 0:
        return gts
    rows_per = grid_y // n_model
    g = gts.reshape(B, Cc, rows_per, n_model, ty, W)
    return g.permute(0, 1, 3, 2, 4, 5).reshape(B, Cc, H, W)


def deinterleave_rows(img: torch.Tensor, n_model: int) -> torch.Tensor:
    """Inverse of :func:`interleave_gt_rows` on a [..., H, W] image whose
    H is the shard-major concatenation of the slabs (``trainer.py:127-142``)."""
    if n_model == 1:
        return img
    *lead, H, W = img.shape
    ty = C.TILE_Y
    rows_per = H // ty // n_model
    g = img.reshape(*lead, n_model, rows_per, ty, W)
    n = len(lead)
    perm = list(range(n)) + [n + 1, n, n + 2, n + 3]
    return g.permute(perm).reshape(*lead, H, W)


def data_slice(global_batch: int, mesh: Mesh) -> slice:
    """The cameras of a global batch on this rank's ``data`` coordinate
    (contiguous runs, ``multihost.py:121-137``)."""
    n_data = mesh.shape["data"]
    if global_batch % n_data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"data axis {n_data}")
    per = global_batch // n_data
    return slice(mesh.d * per, (mesh.d + 1) * per)


def slab_rows(gts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's interleaved slab of a [B, C, H, W] GT's rows: part m of
    :func:`interleave_gt_rows`' H."""
    n_model = mesh.shape["model"]
    g = interleave_gt_rows(gts, n_model)
    H = g.shape[2]
    if H % n_model != 0:
        raise ValueError(f"{H} rows do not split over the model axis {n_model}")
    h = H // n_model
    return g[:, :, mesh.m * h:(mesh.m + 1) * h]


def place_batch(mesh: Mesh, cams: CameraArrays, gts: torch.Tensor):
    """This rank's cameras of a global batch and its interleaved slab of
    their GT rows (``trainer.py:145-152``)."""
    sl = data_slice(gts.shape[0], mesh)
    return CameraArrays(*(x[sl] for x in cams)), slab_rows(gts[sl], mesh)


def tensor_leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a state, Adam state or params tree (a module's
    parameters and buffers included), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` overwritten in place with the grid's first
    rank's (``trainer.py:155-161``, a broadcast); returns ``tree``."""
    broadcast_(tensor_leaves(tree), mesh.world, src=mesh.world_ranks[0])
    return tree


def _prim_slice(mesh: Mesh, P: int) -> slice:
    n_model = mesh.shape["model"]
    if P % n_model != 0:
        raise ValueError(f"{P} rows do not split over the model axis {n_model}")
    p = P // n_model
    return slice(mesh.m * p, (mesh.m + 1) * p)


def shard_primitives(mesh: Mesh, params_or_moments: dict) -> dict:
    """This rank's [P/M] rows of each per-Gaussian leaf of a params-shaped
    dict (new tensors); the other entries as they are
    (``trainer.py:181-190``)."""
    out = dict(params_or_moments)
    for k in PRIM_KEYS:
        x = params_or_moments[k]
        out[k] = x[_prim_slice(mesh, x.shape[0])].clone()
    return out


def _gather_prims(mesh: Mesh, tree: dict) -> dict:
    """The per-Gaussian leaves of ``tree`` all-gathered over ``model`` in one
    collective (packed as columns), differentiable."""
    cols = [tree[k].shape[1] for k in PRIM_KEYS]
    full = all_gather(torch.cat([tree[k] for k in PRIM_KEYS], dim=1), mesh.model)
    return dict(zip(PRIM_KEYS, full.split(cols, dim=1)))


def unshard_primitives(mesh: Mesh, params_or_moments: dict) -> dict:
    """The full per-Gaussian leaves back on every rank (an all-gather over
    ``model``), for the maintenance and the checkpoints
    (``trainer.py:193-196``)."""
    out = dict(params_or_moments)
    with torch.no_grad():
        out.update({k: v.contiguous() for k, v in
                    _gather_prims(mesh, params_or_moments).items()})
    return out


def shard_adam(mesh: Mesh, adam_state: adam.AdamState) -> adam.AdamState:
    """The moments sharded like the parameters (``trainer.py:199-207``)."""
    return adam_state._replace(mu=shard_primitives(mesh, adam_state.mu),
                               nu=shard_primitives(mesh, adam_state.nu))


def unshard_adam(mesh: Mesh, adam_state: adam.AdamState) -> adam.AdamState:
    return adam_state._replace(mu=unshard_primitives(mesh, adam_state.mu),
                               nu=unshard_primitives(mesh, adam_state.nu))


def make_sharded_train_step(cfg, mesh: Mesh, width: int, height: int, stage: str,
                            active_sh_degree: int, spatial_lr_scale: float = 1.0,
                            device="cuda") -> Callable:
    """``step(params, adam_state, state, cams, gts, step) → (params,
    adam_state, state, metrics)`` on this rank (``trainer.py:216-544``), the
    contract of :func:`fourdgs_tpu_torch.train.loop.make_train_step` with:

    - ``cams``: this rank's cameras, ``gts``: float [B_local, C, H/M, W],
      this rank's interleaved slab of their rows (:func:`place_batch`);
    - ``params`` and the moments hold this rank's [P/M] rows of the
      per-Gaussian leaves under ``cfg.tpu.shard_primitives``
      (:func:`shard_primitives`), the whole set otherwise; ``state``'s other
      tensors are whole.

    Requires the tile rows ⌈H/16⌉ to divide by ``model``, and the capacity
    too under ``shard_primitives`` or ``shard_preprocess``. The metrics are
    the same on every rank."""
    dev = resolve_device(device)
    n_data, n_sp = mesh.shape["data"], mesh.shape["model"]
    shard_prim = bool(cfg.tpu.shard_primitives)
    grid_y = (height + C.TILE_Y - 1) // C.TILE_Y
    if grid_y % n_sp != 0:
        raise ValueError(f"tile rows {grid_y} not divisible by model axis {n_sp}")
    rows_per = grid_y // n_sp
    slab_h = rows_per * C.TILE_Y
    if shard_prim and cfg.tpu.capacity % n_sp != 0:
        raise ValueError(f"shard_primitives needs capacity {cfg.tpu.capacity} "
                         f"divisible by model axis {n_sp}")
    shard_pre = bool(cfg.tpu.shard_preprocess) and n_sp > 1
    if (shard_pre or shard_prim) and cfg.tpu.capacity % n_sp != 0:
        raise ValueError(f"sharded preprocess/primitives need capacity "
                         f"{cfg.tpu.capacity} divisible by model axis {n_sp}")
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    iso = cfg.model.use_isotropic_gaussian
    regularize = stage == "fine" and cfg.hidden.time_smoothness_weight != 0
    # this rank's slab: global tile rows m + j·M (interleave_gt_rows)
    slab = dict(tile_row_offset=mesh.m, tile_rows=rows_per, tile_row_stride=n_sp)

    def render_slab(params, state, cam, carrier):
        """(the slab's render, |Δxyz| [P, 3]) of one camera; ``carrier``
        [P, 2] is the means' zero offset whose gradient is the view-space
        gradient."""
        if not shard_pre:
            xyz, sc, rot, op, shs, dxyz = activated_gaussians(params, state, cam, stage, iso)
            out = R.rasterize_pallas(
                xyz, sc, rot, op, shs, cam.camera_center, cam.world_view,
                cam.full_proj, cam.tanfovx, cam.tanfovy, width, height,
                active_sh_degree, bg, cfg.tpu.instance_budget, alive=state.alive,
                means2d_offset=carrier, payload_bf16=cfg.tpu.payload_bf16,
                ellipse_tile_cull=cfg.tpu.ellipse_tile_cull, **slab)
            return out, dxyz
        # 'model'-sharded deformation and preprocess (trainer.py:291-364):
        # this rank's [P/M] slice, its payload table all-gathered in the
        # payload's dtype; the gather's backward hands each rank its slice's
        # table gradient. As in JAX, this path bins without the ellipse cull.
        P_l = params["xyz"].shape[0] // (1 if shard_prim else n_sp)
        sl = slice(mesh.m * P_l, (mesh.m + 1) * P_l)
        prim_l = params if shard_prim else dict(
            {k: params[k][sl] for k in PRIM_KEYS}, deform=params["deform"])
        xyz, sc, rot, op, shs, dxyz_l = activated_gaussians(prim_l, state, cam, stage, iso)
        op = op.reshape(-1)
        pre = preprocess(xyz, sc, rot, shs, cam.camera_center, cam.world_view,
                         cam.full_proj, cam.tanfovx, cam.tanfovy, width, height,
                         active_sh_degree, opacities=op, alive=state.alive[sl])
        table = all_gather(R.payload_table(pre, op, pre.means2d + carrier[sl],
                                           cfg.tpu.payload_bf16), mesh.model)
        with torch.no_grad():
            # the rects, tile counts and radii (int32, as their bits), the
            # depths and |Δxyz|: one gather of [P/M, 10] words
            ints = torch.cat([pre.tile_min, pre.tile_max, pre.tiles_touched[:, None],
                              pre.radii[:, None]], dim=1).to(torch.int32)
            aux = all_gather(torch.cat([ints.view(torch.float32), pre.depths[:, None],
                                        dxyz_l], dim=1), mesh.model)
            ints = aux[:, 0:6].contiguous().view(torch.int32)
        out = R.rasterize_from_table(
            table, ints[:, 0:2], ints[:, 2:4], ints[:, 4], aux[:, 6], ints[:, 5],
            table[:, 0:2].to(torch.float32), width, height, bg,
            cfg.tpu.instance_budget, **slab)
        return out, aux[:, 7:10]

    def local_loss(params, carrier, state, cams, gts):
        """This rank's additive share of the loss, and what the metrics and
        statistics need (``trainer.py:366-437``)."""
        if shard_prim and not shard_pre:
            # the [P]-sharded mode: the leaves gathered for the render; the
            # gather's backward is the reduce-scatter of their gradients
            params = dict(_gather_prims(mesh, params), deform=params["deform"])
        B_local = gts.shape[0]
        B_total = B_local * n_data
        colors, radii, nrend, tlen = [], [], [], []
        dxyz = 0.0
        for i in range(B_local):
            out, dxyz_abs = render_slab(params, state,
                                        CameraArrays(*(x[i] for x in cams)), carrier[i])
            colors.append(out.color[:, :slab_h])
            radii.append(out.radii)
            nrend.append(out.num_rendered)
            tlen.append(out.max_tile_len)
            dxyz = dxyz + dxyz_abs.detach() / B_total
        colors = torch.stack(colors)                  # [B_local, 3, slab_h, W]
        gts = gts[:, :3]
        # L1 on this rank's pixels over the global count: an additive share
        l1_share = torch.sum(losses.abs_(colors - gts)) / (B_total * 3 * height * width)
        loss = l1_share
        if regularize:
            # replicated compute, counted once by the sum over the grid
            loss = loss + hp.hexplane_regularization(
                params["deform"].grids, len(cfg.hidden.multires),
                cfg.hidden.plane_tv_weight, cfg.hidden.time_smoothness_weight,
                cfg.hidden.l1_time_planes) / (n_data * n_sp)
        with torch.no_grad():
            sq = torch.sum((colors - gts) ** 2, dim=(1, 2, 3))
        if cfg.opt.lambda_dssim != 0:
            # 11×11 windows straddle the slabs: the rows gathered over
            # 'model' and put back in image order
            full_c = deinterleave_rows(all_gather(colors, mesh.model, axis=2), n_sp)
            with torch.no_grad():
                full_g = deinterleave_rows(all_gather(gts, mesh.model, axis=2), n_sp)
            ssim_term = 1.0 - losses.ssim(full_c[:, :, :height], full_g[:, :, :height])
            loss = loss + cfg.opt.lambda_dssim * ssim_term * (B_local / (B_total * n_sp))
        aux = (l1_share.detach(), sq, torch.stack(radii), torch.stack(nrend).amax(),
               torch.stack(tlen).amax(), dxyz)
        return loss, aux

    def train_step(params, adam_state: adam.AdamState, state: G.GaussianState,
                   cams: CameraArrays, gts: torch.Tensor, step: int):
        B_local = gts.shape[0]
        # under shard_primitives params["xyz"] holds this rank's rows; the
        # carrier spans the whole set
        Pn = params["xyz"].shape[0] * (n_sp if shard_prim else 1)
        prim = {k: params[k].detach().requires_grad_() for k in G.PRIMITIVE_KEYS}
        leaves = dict(prim, deform=params["deform"])
        carrier = torch.zeros((B_local, Pn, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        loss_sh, (l1_sh, sq, radii_l, nrend, tlen, dxyz) = local_loss(
            leaves, carrier, state, cams, gts)
        named = adam.named_leaves(leaves)
        grads = torch.autograd.grad(
            loss_sh, [x for _, x in named] + [carrier], materialize_grads=True)
        g_leaves, g_carrier = list(grads[:-1]), grads[-1]

        # the step's one parameter-sized sum (trainer.py:450-463): over both
        # axes, but for the per-Gaussian leaves under shard_primitives, over
        # 'data' alone; with it the view-space gradients (summed over the
        # batch too), the loss and the L1
        n_prim = len(G.PRIMITIVE_KEYS)
        by_world = g_leaves[n_prim:] if shard_prim else g_leaves
        summed = psum(by_world + [g_carrier.sum(dim=0), loss_sh.detach().reshape(1),
                                  l1_sh.reshape(1)], mesh.world)
        train_step.grad_allreduce_bytes = sum(t.numel() * 4 for t in summed)
        *by_world, vs_grad, loss, l1 = summed
        # per-camera squared error over the whole image, then PSNR's mean
        # over every camera (a pmean over 'data')
        mse = psum(sq, mesh.model) / (3 * height * width)
        psnr_d = torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12)))
        by_data = psum((g_leaves[:n_prim] if shard_prim else [])
                       + [dxyz, psnr_d.reshape(1)], mesh.data)
        *prim_g, dxyz, psnr = by_data
        g_leaves = prim_g + by_world if shard_prim else by_world
        radii = pmax(radii_l.amax(dim=0), mesh.data)
        nrend, tlen = pmax(torch.stack([nrend.to(torch.int64), tlen.to(torch.int64)]),
                           mesh.world)

        lrs = adam.learning_rates(step, cfg.opt, spatial_lr_scale)
        params, adam_state = adam.update(
            params, adam.tree_like(params, g_leaves), adam_state,
            adam.lr_tree_for_params(params, lrs))
        state = dens.add_densification_stats(state, vs_grad, radii, width, height)
        state = state._replace(deformation_accum=state.deformation_accum + dxyz)
        metrics = {
            "loss": loss[0],
            "l1": l1[0],
            "psnr": psnr[0] / n_data,
            "num_rendered": nrend,
            "max_tile_len": tlen,
            "n_points": G.count_alive(state),
        }
        return params, adam_state, state, metrics

    train_step.grad_allreduce_bytes = 0
    return train_step
