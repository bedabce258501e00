"""Instant4D grid pruning: adaptive voxel downsampling of the init cloud.

A copy of ``fourdgs_tpu/data/grid_pruning.py`` on the port's ``data/ply.py``.

Parity target: utils/grid_pruning.py in the reference (−92% points, 4× train
speed, 6× render speed per README_INSTANT4D.txt:6):

- adaptive voxel size = median camera depth / mean focal · scale_factor, with
  scale = (static 4 + dynamic 3)/2 = 3.5 and clamping to [0.001, 1.0]
  (grid_pruning.py:44-97, 124-131)
- fallback without cameras: bbox diagonal / 100 (grid_pruning.py:133-137)
- open3d voxel_down_sample → implemented natively: points bucketed by voxel
  index, one surviving point per voxel at the **centroid** of its members
  (open3d semantics), colors averaged, normals nearest-neighbor transferred.
"""

from __future__ import annotations

import numpy as np

from fourdgs_tpu_torch.data.ply import PointCloud


def voxel_downsample(
    points: np.ndarray, colors: np.ndarray, voxel_size: float
) -> tuple[np.ndarray, np.ndarray]:
    """Average points/colors per occupied voxel (open3d voxel_down_sample)."""
    vmin = points.min(axis=0)
    idx = np.floor((points - vmin) / voxel_size).astype(np.int64)
    # unique voxel key per point
    dims = idx.max(axis=0) + 1
    key = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.flatnonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(key_s)]]))
    sums_p = np.add.reduceat(points[order], starts, axis=0)
    sums_c = np.add.reduceat(colors[order], starts, axis=0)
    return (sums_p / counts[:, None]).astype(np.float32), (
        sums_c / counts[:, None]
    ).astype(np.float32)


def compute_adaptive_voxel_size(
    points: np.ndarray,
    cameras: list | None = None,
    scale_factor: float = 3.5,
) -> float:
    """voxel = median depth / mean focal · scale (grid_pruning.py:44-97)."""
    if cameras:
        depths, focals = [], []
        for lc in cameras:
            cam = lc.camera if hasattr(lc, "camera") else lc
            center = np.asarray(cam.camera_center)
            depths.append(
                float(np.median(np.linalg.norm(points - center[None], axis=1)))
            )
            fx = cam.width / (2.0 * cam.tanfovx)
            fy = cam.height / (2.0 * cam.tanfovy)
            focals.append((fx + fy) / 2.0)
        depth_mean = float(np.mean(depths))
        focal_mean = float(np.mean(focals))
    else:
        depth_mean = float(
            np.percentile(
                np.linalg.norm(points - points.mean(axis=0), axis=1), 50
            )
        )
        focal_mean = 1000.0
    voxel = depth_mean / focal_mean * scale_factor
    return float(np.clip(voxel, 0.001, 1.0))


def grid_prune_pointcloud(
    pcd: PointCloud,
    scene_data=None,
    use_adaptive: bool = True,
    static_scale: float = 4.0,
    dynamic_scale: float = 3.0,
) -> PointCloud:
    """Main entry (grid_pruning.py:99-162), hooked before create_from_pcd
    (scene/__init__.py:106-119)."""
    points = np.asarray(pcd.points)
    colors = np.asarray(pcd.colors)
    cams = scene_data.train_cameras if scene_data is not None else None
    if use_adaptive and cams:
        voxel = compute_adaptive_voxel_size(
            points, cams, scale_factor=(static_scale + dynamic_scale) / 2.0
        )
    else:
        diag = float(np.linalg.norm(points.max(axis=0) - points.min(axis=0)))
        voxel = diag / 100.0
    down_p, down_c = voxel_downsample(points, colors, voxel)

    normals = np.asarray(pcd.normals)
    if normals.shape[0] == points.shape[0] and np.abs(normals).sum() > 0:
        # nearest-neighbor normal transfer (grid_pruning.py:142-148)
        d2 = (
            np.sum(down_p**2, axis=1)[:, None]
            + np.sum(points**2, axis=1)[None, :]
            - 2.0 * down_p @ points.T
        )
        down_n = normals[np.argmin(d2, axis=1)]
    else:
        down_n = np.zeros_like(down_p)
    return PointCloud(points=down_p, colors=down_c, normals=down_n)
