#!/usr/bin/env python3
"""Quality benchmark of the PyTorch + CUDA port: the D-NeRF bouncingballs
schedule trained from a random point cloud on a synthetic scene, with the
held-out PSNR.

The port's counterpart of ``bench_quality.py``: the same synthetic scene
(coloured balls on bouncing trajectories), the same ring cameras, the
bouncingballs preset (K-planes 64³×75 × 32, multires (1, 2), ``net_width``
64, sh 3), 2,000 random points in [-1.3, 1.3]³ as the init cloud
(``create_from_pcd``), then ``scene_reconstruction``'s coarse and fine
stages with densification, pruning, opacity reset, capacity and budget
growth and SH annealing, and the mean PSNR over the test views. Every train
step runs the blend kernels K1 and K2, every eval view K1.

GT, by ``--gt``:

- ``oracle``: the 800×800 frames of ``gt_cache/oracle_gt_800_100_10.npz``,
  rendered by the JAX package's independent whole-image oracle, on a black
  background (the cache's); the K1 render of the first test view is
  compared with its frame (``gt_pallas_vs_oracle``);
- ``kernel``: frames rendered by the port's ``rasterize_pallas`` (K1) from
  the known Gaussians on the preset's white background, within a 64k
  instance budget (its overflow raises): the trainer recovers a scene its
  own rasterizer drew.

The payload table is rounded to bfloat16 (``"payload": "bf16"``), as
``bench_quality.py:164`` sets it. ``--instant4d`` trains the reference's
Instant4D ablation (``bench_quality.py:123-125, 168-172``): isotropic
Gaussians and SH degree 0. Prints one JSON line with
``bench_quality.py``'s keys (less its TPU-host budget) and the port's
counts, and writes it to ``--out``.

Usage (from the repo root):
    python3 bench_quality_torch.py --gt oracle      # full 3k+20k schedule
    python3 bench_quality_torch.py --scale 0.25     # 750+5000, GT from K1
    python3 bench_quality_torch.py --scale 0.25 --instant4d
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESET = os.path.join(ROOT, "fourdgs_tpu", "configs", "presets", "dnerf",
                      "bouncingballs.py")
ORACLE = os.path.join(ROOT, "gt_cache", "oracle_gt_{size}_{n_train}_{n_test}.npz")
GT_BUDGET = 64 * 1024   # GT demand ≈ 2.2k Gaussians × ≲ 9 tiles ≈ 20k
N_INIT = 2000


def make_gt_scene(seed=0, n_balls=6, per_ball=360):
    """A bouncingballs-like ground-truth Gaussian scene: colored balls on
    independent bouncing (|sin|) trajectories inside [-1,1]^3 over t in
    [0,1], as position offsets applied to a canonical cloud."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.7, 0.7, (n_balls, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(-0.2, 0.2, n_balls)  # near the "floor" plane
    radius = rng.uniform(0.12, 0.22, n_balls).astype(np.float32)
    colors = rng.uniform(0.15, 0.95, (n_balls, 3)).astype(np.float32)
    amp = rng.uniform(0.3, 0.7, n_balls).astype(np.float32)
    freq = rng.integers(1, 3, n_balls)
    phase = rng.uniform(0, np.pi, n_balls).astype(np.float32)

    pts, cols, ball_id = [], [], []
    for b in range(n_balls):
        # points on the sphere surface + a few interior
        v = rng.normal(size=(per_ball, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        rr = radius[b] * (0.85 + 0.15 * rng.uniform(0, 1, (per_ball, 1)))
        pts.append(centers[b] + v * rr)
        shade = 0.85 + 0.3 * v[:, 1:2]  # simple top-lit shading
        cols.append(np.clip(colors[b] * shade, 0, 1))
        ball_id.append(np.full(per_ball, b))
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    ball_id = np.concatenate(ball_id)

    def offsets(t: float) -> np.ndarray:
        """Per-point displacement at time t (bounce along +y)."""
        dy = amp * np.abs(np.sin(np.pi * freq * t + phase)) - amp * np.abs(
            np.sin(phase)
        )
        disp = np.zeros((len(pts), 3), np.float32)
        disp[:, 1] = dy[ball_id]
        return disp

    scale0 = np.full((len(pts), 3), 0.022, np.float32)
    return pts, cols, scale0, offsets


def gt_raster_args(pts, cols, scales):
    """The GT Gaussians' activated attributes as numpy: scales, identity
    rotations, opacity 0.95 and degree-3 SH with the colours in the DC band."""
    n = len(pts)
    sh0 = (cols - 0.5) / 0.28209479177387814  # RGB2SH (utils/sh_utils.py:115)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = sh0
    return {
        "scales": np.asarray(scales, np.float32),
        "rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "opacities": np.full(n, 0.95, np.float32),
        "shs": shs,
    }


def ring_camera(ang, elev, width, height, time, dist=4.0):
    from fourdgs_tpu_torch.utils import graphics

    eye = np.array([
        dist * math.cos(elev) * math.sin(ang),
        dist * math.sin(elev),
        -dist * math.cos(elev) * math.cos(ang),
    ])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd); right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)
    T = -R.T @ eye
    fov = 0.6911112070083618  # blender camera_angle_x of the D-NeRF scenes
    return graphics.make_camera(R, T, fov, fov, width, height, time=time)


def oracle_path(size: int, n_train: int, n_test: int) -> str:
    return ORACLE.format(size=size, n_train=n_train, n_test=n_test)


def load_oracle(size: int, n_train: int, n_test: int):
    """(train, test) lists of (camera, uint8 [H, W, 3] frame) from the
    oracle cache, the cameras rebuilt from the stored (ang, elev, t)."""
    path = oracle_path(size, n_train, n_test)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing (scripts/render_oracle_gt.py "
                                f"renders it)")
    with np.load(path) as data:
        def split(imgs, meta):
            return [(ring_camera(float(a), float(e), size, size, float(t)), img)
                    for img, (a, e, t) in zip(imgs, meta)]
        return (split(data["train_imgs"], data["train_meta"]),
                split(data["test_imgs"], data["test_meta"]))


def configure(cfg, scale: float) -> None:
    """The bouncingballs schedule scaled by ``scale`` (``bench_quality.py:157-167``)
    with the bf16 payload and a 256k starting budget."""
    cfg.opt.coarse_iterations = max(int(3000 * scale), 50)
    cfg.opt.iterations = max(int(20000 * scale), 100)
    cfg.opt.densify_until_iter = min(cfg.opt.densify_until_iter, int(15000 * scale))
    cfg.opt.position_lr_max_steps = cfg.opt.iterations
    cfg.tpu.backend = "pallas"
    cfg.tpu.payload_bf16 = True
    cfg.tpu.instance_budget = 256 * 1024


def instant4d_config(cfg) -> None:
    """The Instant4D ablation (``bench_quality.py:168-172``): isotropic
    Gaussians and SH degree 0."""
    cfg.model.use_isotropic_gaussian = True
    cfg.model.sh_degree = 0


class Trained(NamedTuple):
    """The model a run trained: its config (with the grown instance budget),
    state, the train views as (camera, GT frame) and the background."""
    cfg: Any
    state: Any
    train_cams: list
    bg: Any


def run(scale: float = 1.0, size: int = 800, n_train: int = 100, n_test: int = 10,
        gt: str = "kernel", log_interval: int = 500, device="cuda",
        adjust: Callable | None = None, instant4d: bool = False) -> tuple[dict, Trained]:
    """Train and evaluate; returns the result dict and the :class:`Trained`
    model. ``adjust(cfg)`` runs after the schedule is set (a shorter or
    denser schedule for a smoke run)."""
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
    if gt not in ("kernel", "oracle"):
        raise ValueError(f"--gt {gt!r}: kernel or oracle")
    cfg = load_config(PRESET)
    configure(cfg, scale)
    if instant4d:
        instant4d_config(cfg)
    if gt == "oracle":   # the oracle cache composites on black
        cfg.model.white_background = False
    if adjust is not None:
        adjust(cfg)
    bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- GT
    pts_gt, cols_gt, scales_gt, offsets = make_gt_scene()
    extra = {k: torch.tensor(v, device=dev)
             for k, v in gt_raster_args(pts_gt, cols_gt, scales_gt).items()}

    @torch.no_grad()
    def gt_render(cam, t):
        c = CameraArrays.from_camera(cam, device=dev)
        out = rasterize_pallas(
            torch.tensor(pts_gt + offsets(t), device=dev), extra["scales"],
            extra["rotations"], extra["opacities"], extra["shs"],
            c.camera_center, c.world_view, c.full_proj, c.tanfovx, c.tanfovy,
            size, size, 0, bg, instance_budget=GT_BUDGET)
        if int(out.num_rendered) > GT_BUDGET:
            raise RuntimeError(f"GT render overflowed its instance budget: "
                               f"{int(out.num_rendered)} > {GT_BUDGET}")
        return out.color.cpu().numpy()

    def make_split(n, seed):
        r = np.random.default_rng(seed)
        cams = []
        for i in range(n):
            t = i / max(n - 1, 1)
            ang, elev = r.uniform(0, 2 * np.pi), r.uniform(0.15, 0.9)
            cam = ring_camera(ang, elev, size, size, t)
            cams.append((cam, gt_render(cam, t)))
        return cams

    t0 = time.perf_counter()
    gt_diff = None
    if gt == "oracle":
        train_cams, test_cams = load_oracle(size, n_train, n_test)
        cam0, frame0 = test_cams[0]
        d = np.abs(gt_render(cam0, cam0.time)
                   - frame0.astype(np.float32).transpose(2, 0, 1) / 255.0)
        gt_diff = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
                   "note": "K1 render vs oracle uint8 frame (includes the "
                           "1/255 quantization floor)"}
    else:
        train_cams = make_split(n_train, seed=1)
        test_cams = make_split(n_test, seed=2)
    gt_s = time.perf_counter() - t0
    print(f"GT ready: {len(train_cams)} train + {len(test_cams)} test in "
          f"{gt_s:.1f} s" + (f"; K1 vs oracle max|Δ| {gt_diff['max_abs']:.4f}"
                             if gt_diff else ""), flush=True)

    # ---- init: the reference's random synthetic cloud
    rng = np.random.default_rng(0)
    init_pts = rng.uniform(-1.3, 1.3, (N_INIT, 3)).astype(np.float32)
    init_cols = rng.uniform(0, 1, (N_INIT, 3)).astype(np.float32)
    state = G.create_from_pcd(cfg, init_pts, init_cols, 5.0, seed=6666, device=dev)
    adam_state = adam.init(state.params)

    # ---- train
    logged: list[dict] = []

    def log_fn(it, stage, m, *_):
        logged.append({"iter": it, "stage": stage, **m})
        print(f"[{stage} {it}] loss={m['loss']:.4f} psnr={m['psnr']:.2f} "
              f"pts={int(m['n_points'])} inst={int(m['num_rendered'])} "
              f"({time.perf_counter() - t1:.0f}s)", flush=True)

    blend.blend_forward.launches = blend.blend_backward.launches = 0
    sync()
    t1 = time.perf_counter()
    stage_s, events, maintenance_s = {}, [], 0.0
    for stage, iters, seed in (("coarse", cfg.opt.coarse_iterations, 6666),
                               ("fine", cfg.opt.iterations, 6667)):
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

    # ---- held-out evaluation
    t2 = time.perf_counter()
    psnrs = []
    for cam, img in test_cams:
        with torch.no_grad():
            out = render(state.params, state, CameraArrays.from_camera(cam, device=dev),
                         cfg, size, size, "fine", bg, state.active_sh_degree,
                         device=dev)
        g = torch.tensor(img, device=dev)
        if g.dtype == torch.uint8:
            g = g.to(torch.float32).permute(2, 0, 1) / 255.0
        psnrs.append(float(losses.psnr(out.color[None], g[None])[0]))
    eval_s = time.perf_counter() - t2
    test_psnr = float(np.mean(psnrs))
    iters = cfg.opt.coarse_iterations + cfg.opt.iterations

    def count(kind):
        return sum(1 for e in events if e["kind"] == kind)

    return {
        "scene": "synthetic-bouncingballs",
        "gt_renderer": gt,
        "gt_pallas_vs_oracle": gt_diff,
        "background": ("black (oracle cache convention)" if gt == "oracle"
                       else ("white" if cfg.model.white_background else "black")),
        "instant4d": instant4d,
        "resolution": size,
        "schedule": {"coarse": cfg.opt.coarse_iterations, "fine": cfg.opt.iterations},
        "scale": scale,
        "train_wall_clock_s": wall,
        "test_psnr_db": test_psnr,
        "final_points": n_points,
        "it_per_s": iters / wall,
        "ref_8min_equivalent_s": 480 * scale,
        "backend": dev.type,
        "device": scripts.card() if dev.type == "cuda" else "cpu",
        "payload": "bf16" if cfg.tpu.payload_bf16 else "f32",
        "batch_size": cfg.opt.batch_size,   # K1 and K2 launch once per camera
        "eval_views": len(test_cams),
        "k1_launches": blend.blend_forward.launches,
        "k2_launches": blend.blend_backward.launches,
        "budget_growths": count("budget"),
        "final_instance_budget": cfg.tpu.instance_budget,
        "capacity_growths": count("capacity"),
        "final_capacity": int(state.alive.shape[0]),
        "resets": count("reset"),
        "densify_events": [e for e in events if e["kind"] in ("densify", "prune")],
        "growth_events": [e for e in events if e["kind"] in ("budget", "capacity")],
        "last_train_psnr": logged[-1]["psnr"],
        "train_log": [{k: e[k] for k in ("iter", "stage", "loss", "psnr", "n_points")}
                      for e in logged],
        "stage_s": {"gt": gt_s, **stage_s, "maintenance": maintenance_s,
                    "eval": eval_s},
        "test_psnrs_db": psnrs,
    }, Trained(cfg, state, train_cams, bg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="schedule scale (1.0 = full 3k+20k)")
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_test", type=int, default=10)
    ap.add_argument("--gt", choices=("kernel", "oracle"), default="kernel")
    ap.add_argument("--instant4d", action="store_true",
                    help="the Instant4D ablation: isotropic Gaussians and sh_degree 0")
    ap.add_argument("--log_interval", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    ap.add_argument("--out", default=None, help="result JSON (default "
                    "BENCH_QUALITY_TORCH[_ORACLE].json)")
    args = ap.parse_args(argv)
    out = args.out or ("BENCH_QUALITY_TORCH_ORACLE.json" if args.gt == "oracle"
                       else "BENCH_QUALITY_TORCH.json")
    result, _ = run(args.scale, args.size, args.n_train, args.n_test, args.gt,
                    args.log_interval, args.device, instant4d=args.instant4d)
    print(json.dumps(result))
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
