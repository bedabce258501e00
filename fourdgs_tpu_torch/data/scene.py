"""Scene orchestrator: dataset sniffing, loading, model initialization.

Counterpart of ``fourdgs_tpu/data/scene.py`` (reference scene/__init__.py:
26-157): detect the dataset format by marker file, load cameras and the
init point cloud, apply the Instant4D grid pruning, and build the Gaussian
state on a device. ``build_scene`` takes a seed or a ``torch.Generator``
(for the deformation's initial weights) where the JAX function takes a key.

Every dataset type of the JAX package loads: Blender (D-NeRF), DyNeRF
(Neu3D), HyperNeRF (Nerfies), COLMAP, PanopticSports and MultipleView.

Marker-file registry (scene/__init__.py:48-68 + dataset_readers.py:680-687):
  sparse/                     → colmap
  transforms_train.json       → blender (D-NeRF)
  poses_bounds.npy            → dynerf (Neu3D)
  dataset.json                → nerfies (HyperNeRF)
  train_meta.json             → PanopticSports
  points3D_multipleview.ply   → MultipleView
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch.data import (blender, colmap, dynerf, hypernerf, multipleview,
                                    panoptic)
from fourdgs_tpu_torch.data.blender import SceneData
from fourdgs_tpu_torch.data.grid_pruning import grid_prune_pointcloud
from fourdgs_tpu_torch.models import gaussians as G

# the Blender loader's frame size (JAX's default; a frame of another size
# is resized to it with BICUBIC, as JAX's is with Pillow)
TARGET_SIZE = (800, 800)
# the DyNeRF loader's frame size, (W, H): JAX's default (scene.py:58-60,
# dynerf.py); frames of another size are resized when they are read
DYNERF_SIZE = (1352, 1014)


def sniff_dataset_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
        return "dynerf"
    if os.path.exists(os.path.join(path, "dataset.json")):
        return "nerfies"
    if os.path.exists(os.path.join(path, "train_meta.json")):
        return "PanopticSports"
    if os.path.exists(os.path.join(path, "points3D_multipleview.ply")):
        return "MultipleView"
    raise ValueError(f"could not recognize dataset type at {path!r}")


def load_scene(cfg, path: str | None = None,
               rng: np.random.Generator | None = None) -> SceneData:
    """The scene at ``path`` (default ``cfg.model.source_path``). The
    Blender loader draws the random init cloud of a scene without a
    ``fused.ply`` from ``rng`` (unseeded if None, as JAX always draws it;
    :func:`build_scene` passes one seeded by its ``seed``), and resizes its
    frames to :data:`TARGET_SIZE`; the DyNeRF loader's lazy
    frames to :data:`DYNERF_SIZE`, the HyperNeRF loader's to half the
    cameras' ``image_size`` and the others' to their cameras' size, as JAX
    resizes them with Pillow (``utils/resample.py``)."""
    path = path or cfg.model.source_path
    kind = sniff_dataset_type(path)
    if kind == "blender":
        return blender.load_blender_scene(
            path,
            white_background=cfg.model.white_background,
            eval_split=cfg.model.eval,
            extension=cfg.model.extension,
            target_size=TARGET_SIZE,
            rng=rng,
        )
    if kind == "dynerf":
        return dynerf.load_dynerf_scene(path, cfg, target_wh=DYNERF_SIZE)
    return {"nerfies": hypernerf.load_hypernerf_scene,
            "colmap": colmap.load_colmap_scene,
            "PanopticSports": panoptic.load_panoptic_scene,
            "MultipleView": multipleview.load_multipleview_scene}[kind](path, cfg)


class Scene(NamedTuple):
    data: SceneData
    state: G.GaussianState
    cameras_extent: float


def build_scene(cfg, seed: int | torch.Generator = 0, path: str | None = None,
                scene_data: SceneData | None = None, device="cuda") -> Scene:
    """Load (or accept) scene data and initialize the Gaussian state on
    ``device``, the deformation from ``seed`` (or a seed drawn from the
    generator) and a Blender scene's random init cloud from
    ``np.random.default_rng(seed)``, so that one seed gives one cloud (JAX
    draws that cloud unseeded). The Instant4D grid pruning runs before
    ``create_from_pcd`` when enabled (scene/__init__.py:103-119); the AABB
    comes from the (possibly pruned) cloud."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=seed))
    data = scene_data or load_scene(cfg, path, rng=np.random.default_rng(seed))
    extent = float(data.nerf_normalization["radius"])
    pcd = data.point_cloud
    if cfg.model.use_grid_pruning:
        pcd = grid_prune_pointcloud(pcd, data)
    state = G.create_from_pcd(cfg, pcd.points, pcd.colors, extent, seed=seed,
                              device=device)
    return Scene(data=data, state=state, cameras_extent=extent)
