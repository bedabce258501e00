"""COLMAP (static / monocular) scene loader.

A copy of ``fourdgs_tpu/data/colmap.py`` on the port's lazy
:class:`~fourdgs_tpu_torch.data.dynerf.ImageRef`, which reads its PNG or JPEG
frames with the port's codecs and resizes a frame of another size with
LANCZOS, as JAX's does with Pillow.

Parity target: readColmapSceneInfo + readColmapCameras in the reference
(scene/dataset_readers.py:108-233): sparse/0 binary-or-text model, cameras
sorted by image name, llffhold eval split (every 8th test), per-image time
= idx/N (monocular default), init cloud from points3D.{ply,bin,txt},
maxtime 0, video split = train cameras.
"""

from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.data import colmap_io
from fourdgs_tpu_torch.data.blender import SceneData, get_nerfpp_norm
from fourdgs_tpu_torch.data.dynerf import ImageRef, LoadedCamera
from fourdgs_tpu_torch.data.ply import fetch_pointcloud, store_pointcloud
from fourdgs_tpu_torch.utils import graphics


def load_colmap_scene(
    path: str, cfg=None, images: str | None = None,
    eval_split: bool = True, llffhold: int = 8,
) -> SceneData:
    if cfg is not None:
        images = images or cfg.model.images
        eval_split = cfg.model.eval
        llffhold = cfg.model.llffhold
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, imgs, _ = colmap_io.read_model(sparse)

    reading_dir = os.path.join(path, images or "images")
    infos = []
    keys = list(imgs)
    for idx, key in enumerate(keys):
        extr = imgs[key]
        intr = cams[extr.camera_id]
        R = colmap_io.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = intr.params[0]
        elif intr.model in ("PINHOLE", "OPENCV"):
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model} — undistort first"
            )
        fovx = graphics.focal2fov(fx, intr.width)
        fovy = graphics.focal2fov(fy, intr.height)
        img_path = os.path.join(reading_dir, os.path.basename(extr.name))
        # monocular default: time = idx/N (dataset_readers.py:148)
        cam = graphics.make_camera(
            R, T, fovx, fovy, intr.width, intr.height,
            time=float(idx / len(keys)),
        )
        infos.append((os.path.basename(img_path).split(".")[0],
                      LoadedCamera(cam, ImageRef(img_path,
                                                 (intr.width, intr.height)))))
    infos.sort(key=lambda x: x[0])
    ordered = [lc for _, lc in infos]

    if eval_split:
        train = [c for i, c in enumerate(ordered) if i % llffhold != 0]
        test = [c for i, c in enumerate(ordered) if i % llffhold == 0]
    else:
        train, test = ordered, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        pts = colmap_io.read_points3d_binary(
            os.path.join(sparse, "points3D.bin")
        ) if os.path.exists(os.path.join(sparse, "points3D.bin")) else (
            colmap_io.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        )
        store_pointcloud(ply_path, pts[0], pts[1].astype(np.float64))
    pcd = fetch_pointcloud(ply_path)

    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=[lc.camera for lc in train],
        point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train),
        maxtime=0.0,
        dataset_type="colmap",
    )
