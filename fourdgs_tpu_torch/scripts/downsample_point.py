"""Voxel-downsample an initial point cloud to a target size.

Counterpart of ``scripts/downsample_point.py`` (the reference's open3d
voxel downsample that keeps initial clouds under ~40k points): the port's
``data/grid_pruning.py::voxel_downsample`` with a binary search over the
voxel size.

    python -m fourdgs_tpu_torch.scripts.downsample_point in.ply out.ply [--target 40000]
"""

from __future__ import annotations

import argparse

import numpy as np

from fourdgs_tpu_torch.data.grid_pruning import voxel_downsample
from fourdgs_tpu_torch.data.ply import fetch_pointcloud, store_pointcloud


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--target", type=int, default=40_000)
    args = p.parse_args(argv)

    pc = fetch_pointcloud(args.input)
    pts, cols = pc.points, pc.colors
    print(f"input: {pts.shape[0]} points")
    if pts.shape[0] > args.target:
        diag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
        lo, hi = diag / 10000.0, diag
        for _ in range(24):   # binary search of the voxel size for the target
            mid = (lo * hi) ** 0.5
            down_p, _ = voxel_downsample(pts, cols, mid)
            if down_p.shape[0] > args.target:
                lo = mid
            else:
                hi = mid
        pts, cols = voxel_downsample(pts, cols, hi)
    print(f"output: {pts.shape[0]} points")
    store_pointcloud(args.output, pts, np.clip(cols, 0, 1) * 255)


if __name__ == "__main__":
    main()
