"""Render and cache ``bench_quality_torch.py``'s oracle GT frames with the
port's independent rasterizer.

Counterpart of ``scripts/render_oracle_gt.py``: the same camera splits (the
seeds 1 and 2, elevations in [0.15, 0.9]) over the same ground-truth
Gaussian scene (``bench_quality_torch.make_gt_scene``, SH degree 0, black
background), rendered by ``ops/reference.py::rasterize_reference``, the
whole-image O(P·H·W) oracle that shares none of the binning, payload or
blend code of the ``pallas`` backend (K1, K2), on ``--device`` (default
``cuda``). The frames are written as uint8, rounded as JAX's script rounds
them, to ``<out_dir>/oracle_gt_<size>_<n_train>_<n_test>.npz`` with its keys
(``train_imgs``, ``train_meta``, ``test_imgs``, ``test_meta``, ``size``), the
file ``bench_quality_torch.py --gt oracle`` reads.

    python -m fourdgs_tpu_torch.scripts.render_oracle_gt [--size 800] \\
        [--n_train 100] [--n_test 10] [--out_dir gt_cache] [--device cuda]

Run from the repository's root (``bench_quality_torch.py`` lies there).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ELEVATION = (0.15, 0.9)
SPLIT_SEEDS = {"train": 1, "test": 2}


def oracle_renderer(size: int, device):
    """``render(points, cam) → uint8 [size, size, 3]``: the oracle frame of
    the GT scene's Gaussians at ``points`` (their positions at a time)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_quality_torch import gt_raster_args, make_gt_scene

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.ops.reference import rasterize_reference

    dev = resolve_device(device)
    pts_gt, cols_gt, scales_gt, offsets = make_gt_scene()
    extra = {k: torch.from_numpy(v).to(dev)
             for k, v in gt_raster_args(pts_gt, cols_gt, scales_gt).items()}
    bg = torch.zeros(3, device=dev)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    @torch.no_grad()
    def render(t: float, cam) -> np.ndarray:
        img = rasterize_reference(
            f32(pts_gt + offsets(t)), extra["scales"], extra["rotations"],
            extra["opacities"], extra["shs"], f32(cam.camera_center),
            f32(cam.world_view), f32(cam.full_proj), f32(cam.tanfovx),
            f32(cam.tanfovy), size, size, 0, bg).color
        return np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255.0 + 0.5,
                       0, 255).astype(np.uint8)

    return render


def render_split(render, size: int, n: int, seed: int, tag: str):
    """``bench_quality.make_split``'s cameras (the same RNG stream) rendered
    by ``render``: (uint8 [n, size, size, 3], float64 [n, 3] of (angle,
    elevation, time))."""
    from bench_quality_torch import ring_camera

    r = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    meta = []
    for i in range(n):
        t = i / max(n - 1, 1)
        ang = r.uniform(0, 2 * np.pi)
        elev = r.uniform(*ELEVATION)
        t0 = time.time()
        imgs[i] = render(t, ring_camera(ang, elev, size, size, t))
        meta.append((ang, elev, t))
        print(f"[{tag} {i + 1}/{n}] {time.time() - t0:.1f}s", flush=True)
    return imgs, np.asarray(meta, np.float64)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_test", type=int, default=10)
    ap.add_argument("--out_dir", default="gt_cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    render = oracle_renderer(args.size, args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir,
                       f"oracle_gt_{args.size}_{args.n_train}_{args.n_test}.npz")
    t_all = time.time()
    train_imgs, train_meta = render_split(render, args.size, args.n_train,
                                          SPLIT_SEEDS["train"], "train")
    test_imgs, test_meta = render_split(render, args.size, args.n_test,
                                        SPLIT_SEEDS["test"], "test")
    np.savez_compressed(out, train_imgs=train_imgs, train_meta=train_meta,
                        test_imgs=test_imgs, test_meta=test_meta, size=args.size)
    print(f"wrote {out} in {(time.time() - t_all) / 60:.1f} min")
    return out


if __name__ == "__main__":
    main()
