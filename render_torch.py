#!/usr/bin/env python3
"""Offline rendering of a saved model with the PyTorch + CUDA port.

The port's ``render.py``:

    python3 render_torch.py --model_path output/<expname> [--iteration N]
                            [--skip_train] [--skip_test] [--skip_video]
                            [--configs ...] [--device cuda|cpu]

For each split, renders every camera through the fine stage, prints the
measured FPS ((n−1)/elapsed after one warm-up view, render.py:69-70) and
writes ``<split>/ours_<iter>/{renders,gt}/%05d.png`` for ``metrics_torch.py``,
and ``masks/%05d.png`` for a split whose cameras carry covisible masks
(HyperNeRF's test views), which ``metrics_torch.py`` reads for the masked
PSNR.
The training config is replayed from ``cfg_args.json`` unless ``--configs``
is given. The video split's frames are rendered, but ``video_rgb.mp4`` is not
written: its writer (imageio) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def render_set(model_path, name, iteration, cameras, gts, render_fn, sync,
               mask_paths=None):
    """Render ``cameras`` with ``render_fn(cam) → [3, H, W]`` and write the
    renders and ``gts`` (uint8 [H, W, 3], float [3, H, W], or lazy frames,
    which are called) as PNGs, and the covisible masks of ``mask_paths``
    (render.py:33-45; a mask of another size is resized to its camera's with
    BILINEAR, as JAX's is with Pillow).
    Returns (the uint8 frames, FPS)."""
    import numpy as np

    from fourdgs_tpu_torch.data.hypernerf import read_mask
    from fourdgs_tpu_torch.utils import png

    base = os.path.join(model_path, name, f"ours_{iteration}")
    rdir = os.path.join(base, "renders")
    gdir = os.path.join(base, "gt")
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(gdir, exist_ok=True)
    if mask_paths and any(mask_paths):
        mdir = os.path.join(base, "masks")
        os.makedirs(mdir, exist_ok=True)
        for i, mp in enumerate(mask_paths):
            if mp and os.path.exists(mp):
                png.write_png(os.path.join(mdir, f"{i:05d}.png"),
                              read_mask(mp, cameras[i].width, cameras[i].height))

    if cameras:                      # warm-up, then the timed loop
        render_fn(cameras[0])
        sync()
    t0 = time.time()
    outs = [render_fn(cam) for cam in cameras]
    sync()
    dt = time.time() - t0
    fps = (len(cameras) - 1) / dt if len(cameras) > 1 and dt > 0 else 0.0
    print(f"{name}: {len(cameras)} views, FPS: {fps:.2f}")

    frames = []
    for i, out in enumerate(outs):
        img = out.cpu().numpy().transpose(1, 2, 0)
        img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        png.write_png(os.path.join(rdir, f"{i:05d}.png"), img8)
        frames.append(img8)
        if gts is not None and i < len(gts):
            g = np.asarray(gts[i]() if callable(gts[i]) else gts[i])
            if g.dtype != np.uint8:
                g = (np.clip(g.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
            png.write_png(os.path.join(gdir, f"{i:05d}.png"), g)
    return frames, fps


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--configs", type=str, default=None)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    args = parser.parse_args(argv)

    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import config_from_dict, load_config
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.render import CameraArrays, render
    from fourdgs_tpu_torch.train import checkpoint

    dev = resolve_device(args.device)
    cfg_dump = os.path.join(args.model_path, "cfg_args.json")
    if os.path.exists(cfg_dump) and args.configs is None:
        # replay the saved training config (get_combined_args)
        with open(cfg_dump) as f:
            cfg = config_from_dict(json.load(f))
    else:
        cfg = load_config(args.configs)
    if args.source_path:
        cfg.model.source_path = args.source_path

    pc_dir = os.path.join(args.model_path, "point_cloud")
    iters = [int(d.rsplit("_", 1)[1]) for d in os.listdir(pc_dir)
             if d.startswith("iteration_")]
    iteration = args.iteration if args.iteration > 0 else max(iters)
    snap = os.path.join(pc_dir, f"iteration_{iteration}")
    print(f"rendering snapshot {snap}")
    state = checkpoint.load_snapshot(snap, cfg, device=dev)
    data = load_scene(cfg)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def render_fn(cam):
        return render(state.params, state, CameraArrays.from_camera(cam, device=dev),
                      cfg, cam.width, cam.height, "fine", bg,
                      active_sh_degree=cfg.model.sh_degree, device=dev).color

    fps = {}
    splits = []
    if not args.skip_train:
        splits.append(("train", data.train_cameras))
    if not args.skip_test:
        splits.append(("test", data.test_cameras))
    for name, cams_gt in splits:
        if cams_gt:
            _, fps[name] = render_set(args.model_path, name, iteration,
                                      [lc.camera for lc in cams_gt],
                                      [lc.image for lc in cams_gt], render_fn, sync,
                                      [getattr(lc, "mask_path", None) for lc in cams_gt])
    if not args.skip_video and data.video_cameras:
        _, fps["video"] = render_set(args.model_path, "video", iteration,
                                     data.video_cameras, None, render_fn, sync)
        print(f"video_rgb.mp4 not written: its writer (imageio) is not ported; "
              f"the frames are in video/ours_{iteration}/renders")
    return {"iteration": iteration, "fps": fps}


if __name__ == "__main__":
    main()
