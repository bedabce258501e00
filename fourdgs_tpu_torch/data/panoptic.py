"""PanopticSports (Dynamic3DGaussians-format) dataset loader.

A copy of ``fourdgs_tpu/data/panoptic.py`` on the port's lazy
:class:`~fourdgs_tpu_torch.data.dynerf.ImageRef`, which reads its PNG or JPEG
frames with the port's codecs and resizes a frame of another size with
LANCZOS, as JAX's does with Pillow.

Parity target: readPanopticSportsinfos + readPanopticmeta + setup_camera in
the reference (scene/dataset_readers.py:522-632):

- train_meta.json / test_meta.json: per-timestep lists of intrinsics ``k``
  (3×3), extrinsics ``w2c`` (4×4), file names ``fn``, cam ids; frames under
  ims/; time = timestep / n_timesteps
- camera built directly from K + w2c with znear 0.01 / zfar 100
  (setup_camera, :522-547): tanfov = w/(2fx), principal-point offsets
  (cx, cy) folded into the projection matrix exactly as the reference's
  opengl_proj — off-center captures render unshifted
- init cloud from init_pt_cld.npz ``data[:, :3]`` xyz + ``[:, 3:6]`` rgb
- scene radius = 1.1 · max camera-center spread of timestep 0
"""

from __future__ import annotations

import json
import os

import numpy as np

from fourdgs_tpu_torch.data.blender import SceneData
from fourdgs_tpu_torch.data.dynerf import ImageRef, LoadedCamera
from fourdgs_tpu_torch.data.ply import PointCloud
from fourdgs_tpu_torch.utils import graphics


def _read_meta(datadir: str, json_path: str):
    with open(os.path.join(datadir, json_path)) as f:
        meta = json.load(f)
    w, h = meta["w"], meta["h"]
    n_t = len(meta["fn"])
    cams = []
    for index in range(n_t):
        time = index / n_t
        for K, w2c, fn in zip(meta["k"][index], meta["w2c"][index],
                              meta["fn"][index]):
            cam = graphics.make_camera_from_k(
                K, w2c, w, h, time=time, znear=0.01, zfar=100.0
            )
            cams.append(LoadedCamera(
                camera=cam,
                image=ImageRef(os.path.join(datadir, "ims", fn), (w, h)),
            ))
    centers = np.linalg.inv(np.asarray(meta["w2c"][0], np.float64))[:, :3, 3]
    radius = 1.1 * float(
        np.max(np.linalg.norm(centers - centers.mean(0)[None], axis=-1))
    )
    return cams, float(n_t), radius


def load_panoptic_scene(path: str, cfg=None) -> SceneData:
    train, max_time, radius = _read_meta(path, "train_meta.json")
    test, _, _ = _read_meta(path, "test_meta.json")

    data = np.load(os.path.join(path, "init_pt_cld.npz"))["data"]
    pcd = PointCloud(
        points=data[:, :3].astype(np.float32),
        colors=data[:, 3:6].astype(np.float32),
        normals=np.ones((data.shape[0], 3), np.float32),
    )
    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=[lc.camera for lc in test],
        point_cloud=pcd,
        nerf_normalization={"radius": radius,
                            "translate": np.zeros(3, np.float32)},
        maxtime=max_time,
        dataset_type="PanopticSports",
    )
