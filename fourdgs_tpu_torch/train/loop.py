"""The training loop, PyTorch: the train step, the maintenance and the
coarse→fine schedule.

Counterpart of ``fourdgs_tpu/train/loop.py``: ``make_train_step``
(:51-220), ``make_maintenance`` (:274-307) and ``scene_reconstruction``
(:317-888), on one device or, with a ``mesh``, on a grid of ranks through
the sharded step of ``parallel/trainer.py``.

One step renders each camera of the batch in tile space with a zero
``means2d_offset`` carrier (its gradient is the view-space gradient), takes
the masked L1 loss against the GT tiled 5-wide, adds the fine stage's grid
regularizers and, with ``opt.lambda_dssim != 0``, λ·(1 − SSIM) (on the
tiles, or on the images where the tile grid is padded), and then, from one
``torch.autograd.grad`` call over every parameter leaf and the carrier:
``sanitize_grads``, Adam with the per-group learning rates, the
densification statistics and the deformation accumulator. The backward runs K2 (the backward tile blend) and the
deterministic per-Gaussian segment sum of ``ops/rasterize.py``.

``scene_reconstruction`` runs one stage on the reference schedule: the
random-stack (or FineSampler) camera batches of JAX's ``random.Random``, the
GT cached on the device (or, for lazy frames, decoded per batch on the
native prefetcher while the previous step runs), SH annealing,
instance-budget and capacity growth, densify / prune / opacity reset on
their gates, metrics read on the host
only on a gate or log iteration, and the NaN watchdog. It takes one step
per call. Where JAX scans ``cfg.tpu.scan_steps`` steps as one program (GT
cached on the device) and reads a chunk's ``num_rendered`` and
``max_tile_len`` as their max over the chunk (``loop.py:547-624``), the
port forms the same chunks on the host and replaces those two metrics by
the chunk's max at its last step, so the budget gate and the log read
JAX's values. A ``utils/timer.py`` ``DetailedTimer`` times its phases and an
``utils/observability.py`` ``EventLog`` records the growths, as in JAX;
``debug_mode`` and ``cfg.model.render_process`` write JAX's debug panels and
progress frames (``utils/debug_images.py``); a ``gradient_tracker``
(``utils/gradient_tracker.py``) records the step's gradient statistics, and a
``viewer`` (``viewer.py``, the SIBR network viewer) is polled before each
iteration and served renders of the current state.
"""

from __future__ import annotations

import random as pyrandom
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.data.fastloader import PrefetchPool
from fourdgs_tpu_torch.data.samplers import fine_sampler_order
from fourdgs_tpu_torch.models import densify as dens
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models import hexplane as hp
from fourdgs_tpu_torch.ops.rasterize import contain
from fourdgs_tpu_torch.render import CameraArrays, render
from fourdgs_tpu_torch.train import adam
from fourdgs_tpu_torch.utils import debug_images, forensics, losses
from fourdgs_tpu_torch.utils.gradient_tracker import compute_grad_stats

# at most this many instance-budget growths per stage (loop.py:48)
_MAX_BUDGET_GROWTHS = 4
# GT that fits in this many bytes is cached on the device (loop.py:486)
_GT_CACHE_CAP = 2 << 30


def sanitize_grads(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """``loop.py:183-193``: :func:`~fourdgs_tpu_torch.ops.rasterize.contain`
    on every leaf (``payload_grad`` does the same per instance)."""
    return [contain(g) for g in grads]


def make_train_step(cfg, width: int, height: int, stage: str,
                    active_sh_degree: int, spatial_lr_scale: float = 1.0,
                    device="cuda", track_grads: bool = False) -> Callable:
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
    ``num_rendered``, ``max_tile_len``, ``n_points``. With ``track_grads``
    (``loop.py:211-215``) they also carry ``grad_stats``, the per-group
    statistics of the (sanitized) parameter gradients
    (:func:`~fourdgs_tpu_torch.utils.gradient_tracker.compute_grad_stats`),
    and ``vs_grad_norm`` [P], the norm of each Gaussian's view-space
    gradient summed over the batch.
    """
    dev = resolve_device(device)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    padded = (height % 16 != 0) or (width % 16 != 0)
    # the loss runs on the tiles, except for D-SSIM on a padded grid, whose
    # windows the padding pixels would reach (loop.py:69-76): that case
    # keeps the images
    tile_mode = cfg.opt.lambda_dssim == 0 or not padded
    n_px = 3 * height * width
    grid_x, grid_y = -(-width // 16), -(-height // 16)
    n_tiles = grid_x * grid_y
    # the loss reads the colour channels of the packed (r, g, b, depth,
    # t_fin) render, and no tile-grid padding pixel
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=dev)[:, None]
    if padded:
        mask = mask * losses.tile_pixel_mask(height, width, device=dev)
    regularize = stage == "fine" and cfg.hidden.time_smoothness_weight != 0

    def gt_images(gts: torch.Tensor) -> torch.Tensor:
        """A GT batch as images → float [B, 3, H, W] (the image-space
        loss)."""
        if gts.dtype == torch.uint8:
            gts = gts.to(torch.float32).permute(0, 3, 1, 2) / 255.0
        return gts[:, :3]

    def gt_tiles(gts: torch.Tensor) -> torch.Tensor:
        """Any accepted GT form → float [B, T, 5, 256]."""
        if gts.dim() == 4 and gts.shape[1] == n_tiles and gts.shape[3] == 256:
            if gts.dtype == torch.uint8:
                return F.pad(gts.to(torch.float32) / 255.0, (0, 0, 0, 2))
            return gts
        return torch.stack([losses.tile_image(g, pad_cols=2) for g in gt_images(gts)])

    def loss_fn(leaves, carrier, state, cams, gts_cmp):
        """(loss, l1, psnr, per-camera render outputs) of the batch;
        ``gts_cmp`` is :func:`gt_tiles`'s block, or :func:`gt_images`'s
        images on a padded grid with D-SSIM."""
        B = gts_cmp.shape[0]
        outs = [
            render(leaves, state, CameraArrays(*(x[i] for x in cams)), cfg,
                   width, height, stage, bg, active_sh_degree, device=dev,
                   means2d_offset=carrier[i], tile_space=tile_mode)
            for i in range(B)
        ]
        colors = torch.stack([o.color for o in outs])  # [B, T, 5, 256] / [B, 3, H, W]
        if tile_mode:
            diff = (colors - gts_cmp) * mask
            # the same values as the image-space means: the denominators
            # count the true colour pixels only
            l1 = torch.sum(losses.abs_(diff)) / (B * n_px)
            with torch.no_grad():
                mse = torch.sum(diff * diff, dim=(1, 2, 3)) / n_px
                psnr = torch.mean(20.0 * torch.log10(
                    1.0 / torch.sqrt(torch.clamp(mse, min=1e-20))))
        else:
            l1 = losses.l1_loss(colors, gts_cmp)
            with torch.no_grad():
                psnr = torch.mean(losses.psnr(colors, gts_cmp))
        loss = l1
        if regularize:
            loss = loss + hp.hexplane_regularization(
                leaves["deform"].grids, len(cfg.hidden.multires),
                cfg.hidden.plane_tv_weight, cfg.hidden.time_smoothness_weight,
                cfg.hidden.l1_time_planes)
        if cfg.opt.lambda_dssim != 0:
            if tile_mode:
                ssim = losses.ssim_tiles(colors[:, :, 0:3], gts_cmp[:, :, 0:3],
                                         grid_x, grid_y)
            else:
                ssim = losses.ssim(colors, gts_cmp)
            loss = loss + cfg.opt.lambda_dssim * (1.0 - ssim)
        return loss, l1, psnr, outs

    gt_prepare = gt_tiles if tile_mode else gt_images

    def train_step(params, adam_state: adam.AdamState, state: G.GaussianState,
                   cams: CameraArrays, gts: torch.Tensor, step: int):
        B = gts.shape[0]
        P = params["xyz"].shape[0]
        prim = {k: params[k].detach().requires_grad_() for k in G.PRIMITIVE_KEYS}
        leaves = dict(prim, deform=params["deform"])
        carrier = torch.zeros((B, P, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        loss, l1, psnr, outs = loss_fn(leaves, carrier, state, cams, gt_prepare(gts))

        # every parameter leaf and the carrier in one call; leaves the loss
        # does not reach (the unused heads, timenet) get zeros
        named = adam.named_leaves(leaves)
        grads = torch.autograd.grad(
            loss, [x for _, x in named] + [carrier], materialize_grads=True)
        g_leaves, g_carrier = list(grads[:-1]), grads[-1]
        if cfg.tpu.sanitize_grads:
            g_leaves = sanitize_grads(g_leaves)
        grad_stats = (compute_grad_stats(adam.tree_like(params, g_leaves))
                      if track_grads else None)
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
        if track_grads:
            metrics["grad_stats"] = grad_stats
            metrics["vs_grad_norm"] = torch.linalg.vector_norm(vs_grad, dim=-1)
        return params, adam_state, state, metrics

    train_step.loss_fn = loss_fn     # the step's parts, for profiling
    train_step.gt_tiles = gt_prepare
    return train_step


def make_maintenance(cfg):
    """``(densify_fn, prune_fn, reset_fn)`` over :mod:`models.densify`
    (``loop.py:274-307``):

    - ``densify_fn(state, adam_state, grad_threshold, extent, normals) →
      (state, adam_state, n_cloned, n_split)``: clone, then split with the
      children's ``normals`` [2, cap, 3], both from the gradients of the
      state before them;
    - ``prune_fn(state, opacity_threshold, extent, size_threshold_on) →
      (state, n_pruned)``;
    - ``reset_fn(state, adam_state) → (state, adam_state)``.

    Each passes ``cfg.model.use_isotropic_gaussian`` on as ``isotropic``."""
    percent_dense = cfg.opt.percent_dense
    iso = cfg.model.use_isotropic_gaussian

    def densify_fn(state, adam_state, grad_threshold, extent, normals):
        grads = dens.compute_grads(state)
        moments = (adam_state.mu, adam_state.nu)
        state, moments, n_cloned = dens.densify_and_clone(
            state, moments, grads, grad_threshold, extent, percent_dense,
            isotropic=iso)
        state, moments, n_split = dens.densify_and_split(
            state, moments, grads, grad_threshold, extent, percent_dense,
            normals, isotropic=iso)
        return (state, adam_state._replace(mu=moments[0], nu=moments[1]),
                n_cloned, n_split)

    def prune_fn(state, opacity_threshold, extent, size_threshold_on):
        return dens.prune(state, opacity_threshold, extent, size_threshold_on,
                          isotropic=iso)

    def reset_fn(state, adam_state):
        state, (mu, nu) = dens.reset_opacity(state, (adam_state.mu, adam_state.nu))
        return state, adam_state._replace(mu=mu, nu=nu)

    return densify_fn, prune_fn, reset_fn


@dataclass
class TrainLog:
    """What a stage reports: the logged metrics by iteration (``loop.py:311``),
    their moving averages, and, beyond JAX's, the maintenance events (one
    dict per growth, densify, prune or reset, with its counts), the
    seconds the maintenance took and, when the GT was lazy frames read by
    the native prefetcher, its counts (``PrefetchPool.counts``)."""

    iterations: list = field(default_factory=list)
    ema_loss: float = 0.0
    ema_psnr: float = 0.0
    events: list = field(default_factory=list)
    maintenance_s: float = 0.0
    prefetch: dict | None = None


def scan_chunks(cfg, train_iter: int, log_interval: int = 50,
                extra_log_iters: frozenset | set = frozenset(),
                debug_mode: bool = False) -> list[tuple[int, int]]:
    """JAX's chunks of a stage of ``train_iter`` steps (loop.py:547-598): the
    (first, last) steps of each run of up to ``cfg.tpu.scan_steps`` steps
    with no host gate strictly inside. A gate follows a step that logs, ends
    the stage, densifies, prunes, resets the opacity or saves a debug image
    (loop.py:552-565), or precedes one that anneals the SH degree."""
    opt = cfg.opt

    def gate_after(j: int) -> bool:
        due = (j % log_interval == 0 or j in extra_log_iters or j == train_iter
               or j % opt.densification_interval == 0)
        if j < opt.densify_until_iter:
            due = (due or j % opt.pruning_interval == 0
                   or j % opt.opacity_reset_interval == 0)
        if debug_mode and j % 100 == 0:
            due = True
        if cfg.model.render_process and debug_images.should_save_progress(j):
            due = True
        return due

    chunks, j = [], 1
    while j <= train_iter:
        n = 1
        while (n < cfg.tpu.scan_steps and j + n <= train_iter
               and not gate_after(j + n - 1) and (j + n) % 1000 != 0):
            n += 1
        chunks.append((j, j + n - 1))
        j += n
    return chunks


def scene_reconstruction(
    cfg,
    state: G.GaussianState,
    adam_state: adam.AdamState,
    train_cameras: list,
    stage: str,
    train_iter: int,
    cameras_extent: float,
    rng_seed: int = 6666,
    log_interval: int = 50,
    log_fn: Callable | None = None,
    max_sh_degree: int | None = None,
    extra_log_iters: frozenset | set = frozenset(),
    model_path: str = "",
    device="cuda",
    *,
    source_path: str = "",
    split_normals: Callable | None = None,
    timer=None,
    event_log=None,
    mesh=None,
    viewer=None,
    gradient_tracker=None,
    debug_mode: bool = False,
) -> tuple[G.GaussianState, adam.AdamState, TrainLog]:
    """Train one stage (``"coarse"`` or ``"fine"``) of ``train_iter``
    iterations on ``device`` (``loop.py:317-888``). Returns the state, the
    Adam state and the :class:`TrainLog`.

    ``train_cameras``: ``(graphics.Camera, GT)`` pairs of one resolution,
    the GT a uint8 [H, W, C] or float [C, H, W] array, or a lazy frame: a
    callable that returns one, with its ``shape`` and ``ndim``
    (``data/dynerf.py::ImageRef``). Lazy frames are never stacked or cached
    on the device (``loop.py:471-506``); frames with a ``path`` and ``size``
    are decoded by a :class:`~fourdgs_tpu_torch.data.fastloader.PrefetchPool`,
    batch t + 1 while step t runs, and the others by calling them.
    ``log_fn(iteration, stage, metrics, state, adam_state)`` runs on every
    log iteration, after that iteration's maintenance. ``cfg.tpu.instance_budget`` grows in
    place, as in JAX.

    ``split_normals(cap)`` gives the [2, cap, 3] normals of each split in
    turn, to reproduce another generator's children (the tests pass JAX's);
    by default they come from a ``torch.Generator`` seeded with
    ``rng_seed``. ``timer`` (a ``utils/timer.py`` ``DetailedTimer``, or any
    object with its methods) times each iteration's
    data loading, render (the step), densification and logging phases and
    logs every logged iteration (``loop.py:584-883``); ``event_log`` (an
    ``EventLog``) records each budget and capacity growth. ``debug_mode``
    writes a render|GT panel of the batch's first camera every 100
    iterations, and ``cfg.model.render_process`` a GT|render|depth frame on
    ``debug_images.should_save_progress``'s schedule with the seconds since
    the stage began, under ``model_path`` (``loop.py:679-698``).
    ``gradient_tracker`` (a ``utils/gradient_tracker.py`` ``GradientTracker``)
    records the step's gradient statistics every ``record_interval``
    iterations (``loop.py:750-755``). ``viewer`` (a ``viewer.py``
    ``NetworkGUI``) is polled before each iteration and served the render of
    its camera by the current state, with ``source_path`` as the verify
    string (``loop.py:574-582``). Either turns the chunks off, as JAX's
    ``scan_ok`` does (``loop.py:547-550``): the poll is a host gate before
    every step.

    ``mesh`` (a ``parallel/mesh.py`` ``Mesh``; every rank of it runs this
    call with the same arguments) runs the stage through the sharded step
    (``loop.py:360-395``): the state and the Adam state broadcast from the
    grid's first rank, the batch rounded up to a multiple of ``data``, each
    rank loading only its own cameras' frames (no GT cache, no chunks) and
    taking its slab of their rows. Under ``cfg.tpu.shard_primitives`` the
    per-Gaussian leaves and moments are sharded between the maintenance
    gates, the maintenance, ``log_fn`` and the returned state see them
    whole. The maintenance runs on every rank from the same state and the
    same seeded split normals, so the ranks' states stay equal bit for bit.
    The grid's first rank alone writes files (debug panels, progress frames,
    the NaN snapshot); the caller gives it alone a ``viewer`` and an
    ``event_log``. A ``gradient_tracker`` under a mesh raises ``ValueError``,
    as in JAX. Under ``shard_primitives`` with ``model`` > 1 the viewer's
    frames need the whole primitive set, which JAX's one controller sees:
    every rank learns at the stage's start whether the first rank serves a
    viewer, and if it does, the first rank broadcasts a flag before each
    frame it serves (its ``model`` group then gathers the primitives, and it
    renders them) and a last one when the poll ends, so that every rank
    joins each gather in the same iteration.
    """
    dev = resolve_device(device)
    if not train_cameras:
        return state, adam_state, TrainLog()
    ptrainer = None
    shard_prim = False
    is_main = True
    if mesh is not None:
        from fourdgs_tpu_torch.parallel import multihost
        from fourdgs_tpu_torch.parallel import trainer as ptrainer

        if gradient_tracker is not None:
            raise ValueError("gradient tracking is not supported under a mesh; run "
                             "the tracker on a single-device stage")
        shard_prim = bool(cfg.tpu.shard_primitives)
        is_main = mesh.rank == 0
        state = ptrainer.replicate(mesh, state)
        adam_state = ptrainer.replicate(mesh, adam_state)
        if shard_prim:
            state = state._replace(params=ptrainer.shard_primitives(mesh, state.params))
            adam_state = ptrainer.shard_adam(mesh, adam_state)

    def resharded(sharded: bool) -> None:
        """Move the parameters and moments between this rank's shard and the
        whole set (``loop.py:379-394``): the maintenance and checkpoints run
        on the whole set."""
        nonlocal state, adam_state
        if not shard_prim:
            return
        if sharded:
            state = state._replace(params=ptrainer.shard_primitives(mesh, state.params))
            adam_state = ptrainer.shard_adam(mesh, adam_state)
        else:
            state = state._replace(params=ptrainer.unshard_primitives(mesh, state.params))
            adam_state = ptrainer.unshard_adam(mesh, adam_state)

    def whole_params() -> dict:
        """The parameters with the whole primitive set (collective under
        ``shard_primitives``: every rank calls it)."""
        if shard_prim:
            return ptrainer.unshard_primitives(mesh, state.params)
        return state.params

    # whether the viewer's frames gather the sharded primitives (see above)
    viewer_gathers = (shard_prim and mesh.shape["model"] > 1
                      and ptrainer.flag_from_first_rank(mesh, viewer is not None, dev))
    opt = cfg.opt
    max_sh = cfg.model.sh_degree if max_sh_degree is None else max_sh_degree
    img0 = train_cameras[0][1]
    if not callable(img0):
        img0 = np.asarray(img0)
    if img0.ndim == 3 and img0.shape[-1] in (3, 4):   # HWC uint8 loader format
        height, width = img0.shape[:2]
    else:                                             # CHW float format
        height, width = img0.shape[-2:]
    rng = pyrandom.Random(rng_seed)
    generator = torch.Generator(device=dev).manual_seed(rng_seed)

    # zerostamp_init: the coarse stage trains only timestamp-0 cameras
    cams = train_cameras
    if stage == "coarse" and opt.zerostamp_init:
        t0 = cams[0][0].time
        cams = [c for c in cams if abs(c[0].time - t0) < 1e-9]
    cam_arrays = [CameraArrays.from_camera(c, device=dev) for c, _ in cams]
    # uint8 HWC, float CHW, or lazy callables (data/dynerf.py::ImageRef)
    gt_list = [g if callable(g) else np.asarray(g) for _, g in cams]
    lazy = any(callable(g) for g in gt_list)
    densify_fn, prune_fn, reset_fn = make_maintenance(cfg)

    # FineSampler (loop.py:430-450): n_poses from the distinct centres
    use_fine = opt.custom_sampler in ("fine", "FineSampler", True)
    n_poses = 0
    if use_fine:
        n_poses = max(len({tuple(np.round(c.camera_center, 5)) for c, _ in cams}), 1)
        use_fine = len(cams) % n_poses == 0 and n_poses < len(cams)
        if not use_fine:
            print(f"[sampler] WARNING: custom_sampler={opt.custom_sampler!r} "
                  f"requested but the camera-major layout could not be "
                  f"inferred ({len(cams)} cameras, {n_poses} distinct "
                  f"centers); falling back to random-stack sampling")
    B = opt.batch_size
    if mesh is not None and B % mesh.shape["data"] != 0:
        # the batch splits over 'data': rounded up rather than padded with
        # repeated cameras (loop.py:423-428)
        B = -(-B // mesh.shape["data"]) * mesh.shape["data"]
        print(f"[mesh] batch_size {opt.batch_size} -> {B} "
              f"(multiple of data axis {mesh.shape['data']})")
    # the cameras of a batch whose frames this process loads: under a mesh
    # its rank's (loop.py:630-671, multihost.local_batch_slice)
    local = (slice(0, B) if mesh is None
             else multihost.local_batch_slice(B, mesh))
    stack: list[int] = []
    fine_order: list[int] = []

    def draw_batch() -> list[int]:
        """The next batch of camera indices, in the order of JAX's draws."""
        nonlocal stack, fine_order
        idx = []
        for _ in range(B):
            if use_fine:
                if not fine_order:
                    fine_order = fine_sampler_order(len(cams), n_poses, rng)
                idx.append(fine_order.pop(0))
            else:   # random pop without replacement, the stack refilled
                if not stack:
                    stack = list(range(len(cams)))
                idx.append(stack.pop(rng.randrange(len(stack))))
        return idx

    # GT on the device when every frame is an array and they fit: uint8
    # pre-tiled to [N, T, 3, 256], the tile-space loss's layout
    # (loop.py:486-502), unless D-SSIM on a padded grid keeps the loss on
    # the images; else per batch, as always under a mesh
    cams_dev = gt_cache = None
    if (mesh is None and not lazy
            and sum(g.nbytes for g in gt_list) <= _GT_CACHE_CAP):
        cams_dev = CameraArrays(*(torch.stack(xs) for xs in zip(*cam_arrays)))
        tile_ok = opt.lambda_dssim == 0 or (height % 16 == 0 and width % 16 == 0)
        if tile_ok and gt_list[0].dtype == np.uint8:
            gt_cache = torch.from_numpy(
                np.stack([losses.tile_image_np(g) for g in gt_list])).to(dev)
        else:
            gt_cache = torch.from_numpy(np.stack(gt_list)).to(dev)

    # the draws do not depend on the training, so every batch is drawn up
    # front and the cached path's indices go to the device once (a
    # per-step upload would wait for the stream)
    batches = [draw_batch() for _ in range(train_iter)]
    batches_dev = (torch.tensor(batches, device=dev) if gt_cache is not None
                   else None)
    # lazy frames with a path: batch t + 1 decodes on the native threads
    # while step t runs (loop.py:471-478, :635-647)
    prefetcher = None
    if lazy and all(hasattr(g, "path") and hasattr(g, "size") for g in gt_list):
        prefetcher = PrefetchPool(n_threads=8)
        prefetcher.submit_batch([gt_list[i] for i in batches[0][local]])

    # JAX's chunks (loop.py:547-598), when the GT is cached on the device
    # and no host work runs between steps
    scan = (cfg.tpu.scan_steps > 1 and gt_cache is not None
            and gradient_tracker is None and viewer is None)

    chunk_ends = ({last for _, last in scan_chunks(cfg, train_iter, log_interval,
                                                   extra_log_iters, debug_mode)}
                  if scan else set())

    sh_deg = state.active_sh_degree
    spatial_lr = float(state.spatial_lr_scale)
    steps: dict[int, Callable] = {}
    peaks: list[tuple[torch.Tensor, torch.Tensor]] = []   # the chunk's so far
    budget_growths = 0
    log = TrainLog()

    def event(kind: str, **counts) -> None:
        log.events.append({"iter": iteration, "stage": stage, "kind": kind, **counts})

    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)

    def aux_render(cam: CameraArrays, w: int = width, h: int = height,
                   params=None) -> tuple[np.ndarray, np.ndarray]:
        """(colour [3, H, W], depth [1, H, W]) of ``cam`` by the current
        state (loop.py:522-533), or by ``params``."""
        with torch.no_grad():
            out = render(state.params if params is None else params, state, cam, cfg,
                         w, h, stage, bg, sh_deg, device=dev)
        return out.color.cpu().numpy(), out.depth.cpu().numpy()

    def viewer_render(vcam) -> np.ndarray:
        """The viewer's camera by the current state (loop.py:575-580), the
        sharded primitives gathered first where they are."""
        params = None
        if viewer_gathers:
            ptrainer.flag_from_first_rank(mesh, True, dev)
            params = whole_params()
        return aux_render(CameraArrays.from_camera(vcam, device=dev),
                          vcam.width, vcam.height, params)[0]

    def viewer_poll() -> None:
        """The viewer's poll on the first rank; under ``viewer_gathers`` the
        other ranks join each of its gathers until the poll's last flag."""
        if viewer is not None:
            viewer.poll(viewer_render, source_path, training_done=iteration == train_iter)
        if not viewer_gathers:
            return
        if viewer is not None:
            ptrainer.flag_from_first_rank(mesh, False, dev)
            return
        while ptrainer.flag_from_first_rank(mesh, False, dev):
            if mesh.d == 0:      # the first rank's model group
                whole_params()

    def gt_np(i: int) -> np.ndarray:
        """Camera ``i``'s GT as float CHW, as JAX's ``_gt_np`` (loop.py:535-539)."""
        g = np.asarray(gt_list[i]() if callable(gt_list[i]) else gt_list[i])
        if g.dtype == np.uint8:
            g = g.astype(np.float32).transpose(2, 0, 1) / 255.0
        return g[:3]

    t_start = time.time()
    iteration = 0
    while iteration < train_iter:
        iteration += 1
        viewer_poll()
        if timer:
            timer.start_iteration(iteration)
            timer.start_timer(f"{stage}_data_loading")
        if iteration % 1000 == 0:   # SH annealing (loop.py:587-589)
            state = G.one_up_sh_degree(state, max_sh)
            sh_deg = state.active_sh_degree
        batch_idx = batches[iteration - 1]
        load_idx = batch_idx[local]
        if gt_cache is not None:
            idx = batches_dev[iteration - 1]
            gts = gt_cache[idx]
            batch_cams = CameraArrays(*(x[idx] for x in cams_dev))
        else:
            if prefetcher is not None:
                gts_np = prefetcher.wait_batch()
                if iteration < train_iter:
                    prefetcher.submit_batch([gt_list[i] for i in batches[iteration][local]])
            else:
                gts_np = np.stack([np.asarray(g() if callable(g) else g)
                                   for g in (gt_list[i] for i in load_idx)])
            gts = torch.from_numpy(gts_np).to(dev)
            batch_cams = CameraArrays(*(torch.stack(xs) for xs in
                                        zip(*(cam_arrays[i] for i in load_idx))))
            if mesh is not None:
                if gts.dtype == torch.uint8:
                    # the sharded step takes float CHW (loop.py:650-655)
                    gts = gts.to(torch.float32).permute(0, 3, 1, 2) / 255.0
                batch_cams, gts = multihost.host_local_batch(mesh, batch_cams, gts)
        if timer:
            timer.end_timer(f"{stage}_data_loading")
            timer.start_timer(f"{stage}_render")
        if sh_deg not in steps:
            if mesh is not None:
                steps[sh_deg] = ptrainer.make_sharded_train_step(
                    cfg, mesh, width, height, stage, sh_deg,
                    spatial_lr_scale=spatial_lr, device=dev)
            else:
                steps[sh_deg] = make_train_step(cfg, width, height, stage, sh_deg,
                                                spatial_lr_scale=spatial_lr, device=dev,
                                                track_grads=gradient_tracker is not None)
        with torch.enable_grad():
            params, adam_state, state, metrics = steps[sh_deg](
                state.params, adam_state, state, batch_cams, gts, iteration)
        state = state._replace(params=params)
        if scan:
            peaks.append((metrics["num_rendered"], metrics["max_tile_len"]))
            if iteration in chunk_ends:
                if len(peaks) > 1:
                    # JAX's reduction (loop.py:620-624): the two metrics at a
                    # chunk's last step are their max over it, on the device
                    metrics["num_rendered"], metrics["max_tile_len"] = (
                        torch.stack(v).amax() for v in zip(*peaks))
                peaks = []

        # debug panels every 100 iterations and progress frames on the dense
        # early schedule, of the batch's first camera (loop.py:679-698); under
        # a mesh every rank gathers the parameters, the first renders
        if debug_mode and iteration % 100 == 0:
            i = batch_idx[0]
            whole = whole_params()
            if is_main:
                debug_images.save_debug_image(
                    aux_render(cam_arrays[i], params=whole)[0], gt_np(i), stage,
                    iteration, float(cam_arrays[i].time), model_path)
        if cfg.model.render_process and debug_images.should_save_progress(iteration):
            i = batch_idx[0]
            whole = whole_params()
            if is_main:
                color, depth = aux_render(cam_arrays[i], params=whole)
                debug_images.render_training_image(
                    color, gt_np(i), depth, stage, iteration, time.time() - t_start,
                    model_path)

        # instance-budget growth on the densify cadence (loop.py:708-749);
        # the render reads cfg.tpu.instance_budget on every call
        if iteration % opt.densification_interval == 0:
            demand = int(metrics["num_rendered"])
            budget = cfg.tpu.instance_budget
            if demand > 0.7 * budget and budget < cfg.tpu.instance_budget_max:
                if budget_growths >= _MAX_BUDGET_GROWTHS:
                    if budget_growths == _MAX_BUDGET_GROWTHS:
                        budget_growths += 1
                        print(f"[budget] growth cap ({_MAX_BUDGET_GROWTHS}) "
                              f"reached at {stage} it {iteration}; demand "
                              f"{demand} stays on budget {budget} (overflow "
                              "drops instances)")
                else:
                    new_budget = min(max(budget * 2, int(demand * 1.6)), budget * 4,
                                     max(cfg.tpu.instance_budget_max, budget))
                    new_budget = -(-new_budget // 65536) * 65536
                    cfg.tpu.instance_budget = new_budget
                    budget_growths += 1
                    print(f"[budget] instances {demand} > 70% of {budget}; "
                          f"growing to {new_budget} "
                          f"({budget_growths}/{_MAX_BUDGET_GROWTHS})")
                    event("budget", demand=demand, budget=new_budget)
                    if event_log is not None:
                        event_log.add_scalar("budget/demand", demand, iteration)
                        event_log.add_scalar("budget/instance_budget", new_budget,
                                             iteration)
        if gradient_tracker is not None:
            grad_stats = metrics.pop("grad_stats")
            metrics.pop("vs_grad_norm")
            if iteration % gradient_tracker.record_interval == 0:
                gradient_tracker.record(iteration, stage, grad_stats)
        if timer:
            timer.end_timer(f"{stage}_render")
            timer.start_timer(f"{stage}_densification")

        # densify / prune / opacity reset on the reference schedule
        # (loop.py:762-835); the live count is read only on their gates
        if iteration < opt.densify_until_iter:
            if stage == "coarse":
                opacity_threshold = opt.opacity_threshold_coarse
                densify_threshold = opt.densify_grad_threshold_coarse
            else:
                frac = iteration / opt.densify_until_iter
                opacity_threshold = opt.opacity_threshold_fine_init - frac * (
                    opt.opacity_threshold_fine_init - opt.opacity_threshold_fine_after)
                densify_threshold = opt.densify_grad_threshold_fine_init - frac * (
                    opt.densify_grad_threshold_fine_init - opt.densify_grad_threshold_after)
            size_on = iteration > opt.opacity_reset_interval
            densify_due = (iteration > opt.densify_from_iter
                           and iteration % opt.densification_interval == 0)
            prune_due = (iteration > opt.pruning_from_iter
                         and iteration % opt.pruning_interval == 0)
            reset_due = iteration % opt.opacity_reset_interval == 0
            n_points = int(metrics["n_points"]) if (densify_due or prune_due) else 0
            densify_due = densify_due and n_points < 360_000
            prune_due = prune_due and n_points > 200_000
            t_gate = time.perf_counter()
            surgery = densify_due or prune_due or reset_due
            if surgery:
                resharded(False)
            cur_cap = state.alive.shape[0]
            # capacity growth at 60% before densifying (loop.py:799-815)
            if densify_due and n_points > 0.6 * cur_cap and cur_cap < cfg.tpu.capacity:
                new_cap = min(cur_cap * 2, cfg.tpu.capacity)
                state, adam_state = G.grow_capacity(state, adam_state, new_cap)
                if mesh is not None:
                    state = ptrainer.replicate(mesh, state)
                    adam_state = ptrainer.replicate(mesh, adam_state)
                print(f"[capacity] {n_points} alive > 60% of {cur_cap}; "
                      f"growing to {new_cap}")
                event("capacity", n_points=n_points, capacity=new_cap)
                if event_log is not None:
                    event_log.add_scalar("budget/capacity", new_cap, iteration)
            if densify_due:
                cap = state.alive.shape[0]
                normals = (split_normals(cap) if split_normals is not None
                           else dens.split_normals(generator, 2, cap, dev))
                state, adam_state, n_cloned, n_split = densify_fn(
                    state, adam_state, densify_threshold, cameras_extent, normals)
                event("densify", n_points=n_points, cloned=n_cloned, split=n_split)
            if prune_due:
                state, n_pruned = prune_fn(state, opacity_threshold,
                                           cameras_extent, size_on)
                event("prune", n_points=n_points, pruned=int(n_pruned))
            if reset_due:
                state, adam_state = reset_fn(state, adam_state)
                event("reset")
            if surgery:
                resharded(True)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                log.maintenance_s += time.perf_counter() - t_gate
        if timer:
            timer.end_timer(f"{stage}_densification")

        if (iteration % log_interval == 0 or iteration == train_iter
                or iteration in extra_log_iters):
            if timer:
                timer.start_timer(f"{stage}_logging")
            m = {k: float(v) for k, v in metrics.items()}
            log.ema_loss = 0.4 * m["loss"] + 0.6 * log.ema_loss
            log.ema_psnr = 0.4 * m["psnr"] + 0.6 * log.ema_psnr
            log.iterations.append({"iter": iteration, "stage": stage, **m})
            if timer:
                timer.log_iteration(
                    iteration=iteration, loss=m["loss"], psnr=m["psnr"],
                    l1_loss=m["l1"], stage=stage, total_points=int(m["n_points"]),
                    ema_loss=log.ema_loss, ema_psnr=log.ema_psnr)
            if log_fn:
                if shard_prim:
                    resharded(False)
                    log_fn(iteration, stage, m, state, adam_state)
                    resharded(True)
                else:
                    log_fn(iteration, stage, m, state, adam_state)
            if np.isnan(m["loss"]):
                # NaN watchdog (loop.py:856-879): a replayable snapshot first,
                # by the grid's first rank
                whole = whole_params()
                snap = None if not is_main else forensics.dump_snapshot(
                    model_path, f"nan_{stage}_{iteration}", whole,
                    state=state, cams=batch_cams, metrics=m,
                    extra={"iteration": iteration,
                           "instance_budget": cfg.tpu.instance_budget,
                           "capacity": state.alive.shape[0],
                           "batch_idx": np.asarray(batch_idx)})
                raise FloatingPointError(
                    f"loss is NaN at {stage} iteration {iteration}; "
                    f"forensic snapshot: {snap}")
            if timer:
                timer.end_timer(f"{stage}_logging")
        if timer:
            timer.end_iteration(iteration, stage)
    if prefetcher is not None:
        log.prefetch = prefetcher.counts()
        prefetcher.close()
    # the whole set back (checkpoints and a following stage start from it)
    resharded(False)
    return state, adam_state, log
