#!/usr/bin/env python3
"""DyNeRF-shaped quality benchmark of the PyTorch + CUDA port: the dynerf
preset trained on a synthetic multi-view video, with the held-out PSNR.

The port's counterpart of ``bench_quality_dynerf.py``, the same workload:

- 12 fixed ring cameras × 150 timestamps of ``bench_quality_torch.py``'s
  moving ground-truth scene, camera-major (all frames of camera 1, then
  camera 2, …), camera 0 held out (the reference's eval_index=0 holdout),
  15 of its frames as the test views;
- 676×507 frames (half DyNeRF's 1352×1014), so the tile grid is padded
  (43×32 tiles) and the loss masks the padding pixels;
- the dynerf preset (K-planes [64, 64, 64, 150] × 16, multires (1, 2),
  ``net_width`` 128, ``defor_depth`` 0, batch 4, the grid regularizers)
  with every override of ``bench_quality_dynerf.py:68-103``: the schedule
  (3k coarse + 14k fine) and the densify/prune edges scaled by ``--scale``,
  the 3k opacity-reset cadence kept (the documented deviation from the
  preset's 60k), the FineSampler, the pallas backend, the bf16 payload, a
  256k instance budget capped at 2M, ``zero_init_heads``, and a fresh 512k
  budget for the fine stage;
- an 8,000-point init cloud: 4,000 near the GT surface, 4,000 uniform;
- ``--instant4d``: isotropic Gaussians and SH degree 0.

GT is rendered by K1 (``rasterize_pallas``) on black within a 64k instance
budget (its overflow raises), rounded to uint8 and held in memory (1,650
frames, 1.7 GB, cached on the device by the loop). Training renders on the
preset's white background, as JAX's script does; the eval renders on black,
the GT's.

Prints one JSON line with ``bench_quality_dynerf.py``'s keys and the port's
counts (K1/K2 launches, budget and capacity growths, stage seconds). Its
``"backend"`` is the card's name; ``chip_minutes_vs_host_budget``, a ratio
to a TPU host's budget, is null. It writes ``--out`` when given, never
``BENCH_QUALITY_DYNERF.json`` (the JAX script's file).

Usage (from the repo root):
    python3 bench_quality_dynerf_torch.py                # full 3k + 14k
    python3 bench_quality_dynerf_torch.py --scale 0.05   # smoke
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np

from bench_quality_torch import (Trained, gt_raster_args, instant4d_config,
                                 make_gt_scene, ring_camera)

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESET = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "dynerf", "default.py")
N_CAM = 12
N_T = 150
GT_BUDGET = 64 * 1024


def configure(cfg, scale: float) -> None:
    """``bench_quality_dynerf.py:68-100``: the dynerf preset's schedule and
    edges scaled by ``scale``, the kept 3k reset cadence, the FineSampler,
    the bf16 payload, a 256k budget capped at 2M and zeroed head layers."""
    cfg.opt.coarse_iterations = max(int(3000 * scale), 50)
    cfg.opt.iterations = max(int(14000 * scale), 100)
    cfg.opt.densify_until_iter = min(cfg.opt.densify_until_iter, int(10000 * scale))
    cfg.opt.densify_from_iter = int(cfg.opt.densify_from_iter * scale)
    cfg.opt.pruning_from_iter = int(cfg.opt.pruning_from_iter * scale)
    cfg.opt.position_lr_max_steps = cfg.opt.iterations
    # the documented deviation: the preset's 60k interval never resets
    # within the schedule; the synthetic ring scene then falls into the fog
    # minimum, so the global 3k cadence is kept
    cfg.opt.opacity_reset_interval = max(int(3000 * scale), 100)
    cfg.opt.custom_sampler = "fine"
    cfg.tpu.backend = "pallas"
    cfg.tpu.payload_bf16 = True
    cfg.tpu.instance_budget = 256 * 1024
    cfg.tpu.instance_budget_max = 2 * 1024 * 1024
    cfg.hidden.zero_init_heads = True


def camera_poses():
    """The ring's (angle, elevation) per camera (``bench_quality_dynerf.py:128-130``)."""
    rng = np.random.default_rng(7)
    return [(rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 0.8)) for _ in range(N_CAM)]


def init_cloud(pts_gt):
    """(points, colours) of the 8,000-point init: 4,000 GT surface points
    with N(0, 0.05) noise, 4,000 uniform in [-1.1, 1.1]³
    (``bench_quality_dynerf.py:164-173``)."""
    rng = np.random.default_rng(0)
    surf = pts_gt[rng.choice(len(pts_gt), 4000)] + rng.normal(
        0, 0.05, (4000, 3)).astype(np.float32)
    pts = np.concatenate([surf, rng.uniform(-1.1, 1.1, (4000, 3))]).astype(np.float32)
    cols = rng.uniform(0, 1, (8000, 3)).astype(np.float32)
    return pts, cols


def run(scale: float = 1.0, width: int = 676, height: int = 507, n_test_t: int = 15,
        instant4d: bool = False, log_interval: int = 500, device="cuda",
        adjust: Callable | None = None) -> tuple[dict, Trained]:
    """Train and evaluate; returns the result dict and the :class:`Trained`
    model (its ``bg`` the training background). ``adjust(cfg)`` runs after
    the workload's config is set (a smaller model for a CPU run)."""
    import torch

    from fourdgs_tpu_torch import resolve_device, scripts
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays, render
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import scene_reconstruction
    from fourdgs_tpu_torch.utils import losses

    dev = resolve_device(device)
    cfg = load_config(PRESET)
    configure(cfg, scale)
    if instant4d:
        instant4d_config(cfg)
    if adjust is not None:
        adjust(cfg)
    W, H = width, height
    black = torch.zeros(3, device=dev)     # the GT's and the eval's background
    bg = torch.ones(3, device=dev) if cfg.model.white_background else black

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- GT: N_CAM ring cameras, camera-major, camera 0 held out
    pts_gt, cols_gt, scales_gt, offsets = make_gt_scene()
    extra = {k: torch.tensor(v, device=dev)
             for k, v in gt_raster_args(pts_gt, cols_gt, scales_gt).items()}
    poses = camera_poses()

    @torch.no_grad()
    def render_pair(ci, t):
        cam = ring_camera(*poses[ci], W, H, t)
        c = CameraArrays.from_camera(cam, device=dev)
        out = rasterize_pallas(
            torch.tensor(pts_gt + offsets(t), device=dev), extra["scales"],
            extra["rotations"], extra["opacities"], extra["shs"],
            c.camera_center, c.world_view, c.full_proj, c.tanfovx, c.tanfovy,
            W, H, 0, black, instance_budget=GT_BUDGET)
        if int(out.num_rendered) > GT_BUDGET:
            raise RuntimeError(f"GT render overflowed its instance budget: "
                               f"{int(out.num_rendered)} > {GT_BUDGET}")
        img8 = (out.color.permute(1, 2, 0) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        return cam, img8.cpu().numpy()

    blend.blend_forward.launches = 0
    sync()
    t0 = time.perf_counter()
    train_cams = [render_pair(ci, ti / (N_T - 1))
                  for ci in range(1, N_CAM) for ti in range(N_T)]
    test_cams = [render_pair(0, ti / (N_T - 1))
                 for ti in np.linspace(0, N_T - 1, n_test_t).astype(int)]
    gt_s = time.perf_counter() - t0
    gt_launches = blend.blend_forward.launches
    gt_bytes = sum(g.nbytes for _, g in train_cams)
    print(f"GT: {len(train_cams)} train frames ({N_CAM - 1} cams x {N_T} t) + "
          f"{len(test_cams)} held-out cam-0 frames in {gt_s:.1f} s "
          f"({gt_bytes / 1e9:.2f} GB)", flush=True)

    # ---- init: a surface-informed cloud
    init_pts, init_cols = init_cloud(pts_gt)
    state = G.create_from_pcd(cfg, init_pts, init_cols, 5.0, seed=6666, device=dev)
    adam_state = adam.init(state.params)

    # ---- train
    logged: list[dict] = []

    def log_fn(it, stage, m, *_):
        logged.append({"iter": it, "stage": stage, "t": time.perf_counter() - t1, **m})
        print(f"[{stage} {it}] loss={m['loss']:.4f} psnr={m['psnr']:.2f} "
              f"pts={int(m['n_points'])} inst={int(m['num_rendered'])} "
              f"({time.perf_counter() - t1:.0f}s)", flush=True)

    blend.blend_forward.launches = blend.blend_backward.launches = 0
    sync()
    t1 = time.perf_counter()
    stage_s, events, maintenance_s = {}, [], 0.0
    for stage, iters, seed in (("coarse", cfg.opt.coarse_iterations, 6666),
                               ("fine", cfg.opt.iterations, 6667)):
        if stage == "fine":
            # a fresh budget for the fine stage (bench_quality_dynerf.py:193-198)
            cfg.tpu.instance_budget = 512 * 1024
        ts = time.perf_counter()
        state, adam_state, log = scene_reconstruction(
            cfg, state, adam_state, train_cams, stage, iters, cameras_extent=5.0,
            rng_seed=seed, log_interval=log_interval, log_fn=log_fn, device=dev)
        sync()
        stage_s[stage] = time.perf_counter() - ts
        events += log.events
        maintenance_s += log.maintenance_s
    n_points = int(G.count_alive(state))
    wall = time.perf_counter() - t1

    # ---- held-out evaluation on the GT's black background
    t2 = time.perf_counter()
    psnrs = []
    for cam, img in test_cams:
        with torch.no_grad():
            out = render(state.params, state, CameraArrays.from_camera(cam, device=dev),
                         cfg, W, H, "fine", black, state.active_sh_degree, device=dev)
        g = torch.tensor(img, device=dev).to(torch.float32).permute(2, 0, 1) / 255.0
        psnrs.append(float(losses.psnr(out.color[None], g[None])[0]))
    eval_s = time.perf_counter() - t2
    test_psnr = float(np.mean(psnrs))
    iters = cfg.opt.coarse_iterations + cfg.opt.iterations

    def count(kind):
        return sum(1 for e in events if e["kind"] == kind)

    return {
        "scene": "synthetic-multiview-video (DyNeRF-shaped)",
        "instant4d": instant4d,
        "resolution": [W, H],
        "cams_train": N_CAM - 1,
        "timestamps": N_T,
        "holdout": "camera 0 (eval_index=0 convention)",
        "preset_deviation": "opacity_reset_interval 60000 -> "
                            f"{cfg.opt.opacity_reset_interval} (synthetic scene "
                            "falls into the fog minimum without resets)",
        "batch_size": cfg.opt.batch_size,
        "fine_sampler": True,
        "schedule": {"coarse": cfg.opt.coarse_iterations, "fine": cfg.opt.iterations},
        "scale": scale,
        "train_wall_clock_s": wall,
        "test_psnr_db": test_psnr,
        "final_points": n_points,
        "it_per_s": iters / wall,
        "ref_30min_equivalent_s": 1800 * scale,
        "chip_minutes_vs_host_budget": None,   # a TPU host's budget
        "backend": scripts.card() if dev.type == "cuda" else "cpu",
        "device": dev.type,
        "payload": "bf16" if cfg.tpu.payload_bf16 else "f32",
        "sh_degree": cfg.model.sh_degree,
        "isotropic": cfg.model.use_isotropic_gaussian,
        "eval_views": len(test_cams),
        "gt_launches": gt_launches,
        "k1_launches": blend.blend_forward.launches,
        "k2_launches": blend.blend_backward.launches,
        "budget_growths": count("budget"),
        "final_instance_budget": cfg.tpu.instance_budget,
        "capacity_growths": count("capacity"),
        "final_capacity": int(state.alive.shape[0]),
        "resets": count("reset"),
        "densify_events": [e for e in events if e["kind"] in ("densify", "prune")],
        "growth_events": [e for e in events if e["kind"] in ("budget", "capacity")],
        "first_train_psnr": logged[0]["psnr"],
        "last_train_psnr": logged[-1]["psnr"],
        "train_log": [{k: e[k] for k in ("iter", "stage", "t", "loss", "psnr", "n_points",
                                         "num_rendered")} for e in logged],
        "stage_s": {"gt": gt_s, **stage_s, "maintenance": maintenance_s,
                    "eval": eval_s},
        "test_psnrs_db": psnrs,
    }, Trained(cfg, state, train_cams, bg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="schedule scale (1.0 = full 3k + 14k)")
    ap.add_argument("--width", type=int, default=676)
    ap.add_argument("--height", type=int, default=507)
    ap.add_argument("--n_test_t", type=int, default=15)
    ap.add_argument("--instant4d", action="store_true",
                    help="the Instant4D ablation: isotropic Gaussians and sh_degree 0")
    ap.add_argument("--log_interval", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    args = ap.parse_args(argv)
    result, _ = run(args.scale, args.width, args.height, args.n_test_t, args.instant4d,
                    args.log_interval, args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
