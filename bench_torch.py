#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: end-to-end train-step throughput on
``bench.py``'s D-NeRF-class workload.

Prints ONE JSON line, with ``bench.py``'s keys:
``{"metric": "trained_pixels_per_s_per_chip", "value", "unit": "pixel/s",
"vs_baseline"}``, and on stderr the it/s, the loss and the card's name and
power limit.

Workload (``bench.py:29-128``): the fine-stage train step (HexPlane and
deformation MLP, preprocess, binning, the payload gather, the tile blends K1
and K2, the L1 loss, the grid regularizers, Adam) of the default config with
``bench.py``'s overrides (multires (1, 2), ``net_width`` 64, ``defor_depth``
1, sh 3, batch 1, the bf16 payload, a 384k instance budget) over 60,000
random points in 65,536 rows with scales U(0.005, 0.02), at 800×800 on one
ring camera, against a GT frame that K1 renders from
``bench_quality_torch.py``'s ground-truth scene. 3 warm-up steps, then 20
timed steps between host syncs; trained pixels/s = H·W·batch·steps ÷ wall,
``vs_baseline`` = value / 3.07e7 (``bench.py:12-16``, ``BASELINE.md``).
The port takes one step per call where ``bench.py`` scans 10: the line is
per-step wall either way, and the metrics are read on the host only after
the timed loop. A demand above the instance budget raises after the loop,
as ``bench.py``'s assert does.

Usage (from the repo root):
    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # the plain path (slow at 800x800)
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, NamedTuple

import numpy as np

BASELINE_PX_PER_S = 23_000 * 800 * 800 / 480.0  # ≈ 3.07e7 (reference, 1 GPU)
INSTANCE_BUDGET = 384 * 1024
GT_BUDGET = 64 * 1024


class Workload(NamedTuple):
    """What ``build_workload`` returns: the step, its inputs and config."""
    step: Any
    state: Any
    adam_state: Any
    cams: Any        # CameraArrays with a leading batch dimension
    gts: Any         # [B, T, 5, 256] float32 pre-tiled GT
    cfg: Any
    cameras: list    # graphics.Camera per batch element


def configure(cfg, capacity: int, batch: int,
              instance_budget: int = INSTANCE_BUDGET) -> None:
    """``bench.py:40-62``'s overrides of the default config."""
    cfg.tpu.capacity = capacity
    cfg.tpu.instance_budget = instance_budget
    cfg.tpu.tile_budget = 2048
    cfg.tpu.blend_chunk = 256
    cfg.hidden.multires = (1, 2)
    cfg.hidden.net_width = 64
    cfg.hidden.defor_depth = 1
    cfg.hidden.no_dx = False
    cfg.model.sh_degree = 3
    cfg.opt.batch_size = batch
    cfg.tpu.backend = "pallas"
    cfg.tpu.payload_bf16 = True


def bench_camera(i: int, batch: int, width: int, height: int):
    """``bench.py:78-90``: camera ``i`` of the ring, fov π/3, at time
    i / batch."""
    from fourdgs_tpu_torch.utils import graphics

    ang = 0.3 + 0.5 * i
    eye = np.array([3.2 * math.sin(ang), 0.5, -3.2 * math.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)
    T = -R.T @ eye
    fov = math.pi / 3
    return graphics.make_camera(R, T, fov, fov, width, height,
                                time=i / max(batch, 1))


def build_workload(height=800, width=800, n_points=60_000, capacity=65_536,
                   batch=1, seed=0, instance_budget=INSTANCE_BUDGET,
                   device="cuda") -> Workload:
    """``bench.py::build_workload`` on the port, on ``device``."""
    import torch

    import bench_quality_torch as BQ
    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_train_step
    from fourdgs_tpu_torch.utils.losses import tile_image

    dev = resolve_device(device)
    cfg = load_config()
    configure(cfg, capacity, batch, instance_budget)

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n_points, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_points, 3)).astype(np.float32)
    state = G.create_from_pcd(cfg, pts, cols, 1.0, seed=seed, device=dev)
    # bench.py's override of create_from_pcd's 3-NN scales (which make a
    # random cloud's Gaussians ~30 tiles wide) with trained-scene-like
    # sizes, on every row of the capacity, dead rows included
    scales = rng.uniform(0.005, 0.02, (cfg.tpu.capacity, 3)).astype(np.float32)
    if state.alive.shape[0] != cfg.tpu.capacity:
        raise ValueError(f"the cloud's capacity {state.alive.shape[0]} is not "
                         f"cfg.tpu.capacity {cfg.tpu.capacity}")
    state.params["scaling"] = torch.log(torch.tensor(scales, device=dev))
    adam_state = adam.init(state.params)

    cameras = [bench_camera(i, batch, width, height) for i in range(batch)]
    cam_arrays = [CameraArrays.from_camera(c, device=dev) for c in cameras]
    cams = CameraArrays(*(torch.stack(xs) for xs in zip(*cam_arrays)))

    # GT: K1's render of the ground-truth scene (bench.py:92-127), black
    # background, degree-0 SH, tiled 5-wide as the step's loss reads it
    pts_gt, cols_gt, scales_gt, offsets = BQ.make_gt_scene()
    extra = {k: torch.tensor(v, device=dev)
             for k, v in BQ.gt_raster_args(pts_gt, cols_gt, scales_gt).items()}
    bg = torch.zeros(3, device=dev)
    gts = []
    with torch.no_grad():
        for i, c in enumerate(cam_arrays):
            out = rasterize_pallas(
                torch.tensor(pts_gt + offsets(i / max(batch, 1)), device=dev),
                extra["scales"], extra["rotations"], extra["opacities"],
                extra["shs"], c.camera_center, c.world_view, c.full_proj,
                c.tanfovx, c.tanfovy, width, height, 0, bg,
                instance_budget=GT_BUDGET)
            if int(out.num_rendered) > GT_BUDGET:
                raise RuntimeError(f"GT render overflowed its instance budget: "
                                   f"{int(out.num_rendered)} > {GT_BUDGET}")
            gts.append(tile_image(out.color, pad_cols=2))
    step = make_train_step(cfg, width, height, "fine",
                           active_sh_degree=cfg.model.sh_degree, device=dev)
    return Workload(step, state, adam_state, cams, torch.stack(gts), cfg, cameras)


def run(device="cuda", warmup: int = 3, iters: int = 20,
        **workload) -> tuple[dict, dict, Workload]:
    """Build the workload (``build_workload``'s keywords), take ``warmup``
    steps, then ``iters`` timed steps. Returns (the JSON line, its details:
    steps, seconds, it/s, final loss, the largest demand, the device; the
    workload with the state and Adam state after the last step)."""
    import torch

    from fourdgs_tpu_torch import resolve_device, scripts

    dev = resolve_device(device)
    w = build_workload(device=dev, **workload)
    height, width = int(w.cameras[0].height), int(w.cameras[0].width)
    batch = w.cfg.opt.batch_size

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params, opt, state = w.state.params, w.adam_state, w.state
    metrics = []
    with torch.enable_grad():
        for it in range(1, warmup + 1):
            params, opt, state, m = w.step(params, opt, state, w.cams, w.gts, it)
            metrics.append(m)
        sync()
        t0 = time.perf_counter()
        for it in range(warmup + 1, warmup + iters + 1):
            params, opt, state, m = w.step(params, opt, state, w.cams, w.gts, it)
            metrics.append(m)
        sync()
        dt = time.perf_counter() - t0
    # host reads only after the timed loop
    final_loss = float(metrics[-1]["loss"])
    demand = int(torch.stack([m["num_rendered"] for m in metrics]).max())
    budget = w.cfg.tpu.instance_budget
    if demand > budget:
        raise AssertionError(f"budget overflow would distort the bench: "
                             f"{demand} > {budget}")
    px_per_s = height * width * batch * iters / dt
    line = {
        "metric": "trained_pixels_per_s_per_chip",
        "value": round(px_per_s, 1),
        "unit": "pixel/s",
        "vs_baseline": round(px_per_s / BASELINE_PX_PER_S, 4),
    }
    info = {"steps": iters, "warmup": warmup, "seconds": dt, "it_per_s": iters / dt,
            "loss": final_loss, "max_num_rendered": demand,
            "device": scripts.card() if dev.type == "cuda" else "cpu"}
    return line, info, w._replace(state=state._replace(params=params), adam_state=opt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    args = ap.parse_args(argv)
    line, info, _ = run(device=args.device)
    print(json.dumps(line), flush=True)
    print(f"# {info['steps']} steps in {info['seconds']:.3f}s = "
          f"{info['it_per_s']:.2f} it/s ({line['value'] / 1e6:.2f} Mpx/s), "
          f"loss={info['loss']:.4f}, max instances {info['max_num_rendered']}",
          file=sys.stderr)
    print(f"# card: {info['device']}", file=sys.stderr)
    return line


if __name__ == "__main__":
    main()
