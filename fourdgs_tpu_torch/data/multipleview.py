"""MultipleView dataset loader (COLMAP extrinsics + per-camera frame trees).

A copy of ``fourdgs_tpu/data/multipleview.py`` on the port's lazy
:class:`~fourdgs_tpu_torch.data.dynerf.ImageRef`, which reads its PNG or JPEG
frames with the port's codecs and resizes a frame of another size with
LANCZOS, as JAX's does with Pillow.

Parity target: scene/multipleview_dataset.py + readMultipleViewinfos in the
reference: COLMAP model under sparse_/ (or sparse/), frames at
cam##/frame_#####.jpg; test split = frames {0, ⅓, ⅔} of each camera
(multipleview_dataset.py:50-53); time = frame_idx/frame_count; spiral video
path over poses_bounds_multipleview.npy (:65-96); init cloud from
points3D_multipleview.ply.
"""

from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.data import colmap_io
from fourdgs_tpu_torch.data.blender import SceneData, get_nerfpp_norm
from fourdgs_tpu_torch.data.dynerf import ImageRef, LoadedCamera, _spiral_cameras
from fourdgs_tpu_torch.data.ply import fetch_pointcloud
from fourdgs_tpu_torch.utils import graphics


def load_multipleview_scene(path: str, cfg=None) -> SceneData:
    sparse = os.path.join(path, "sparse_", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse", "0")
    cams, imgs, _ = colmap_io.read_model(sparse)

    intr = cams[min(cams)]
    focal = intr.params[0]
    fovx = graphics.focal2fov(focal, intr.width)
    fovy = graphics.focal2fov(focal, intr.height)
    size = (intr.width, intr.height)

    cam01 = os.path.join(path, "cam01")
    n_frames = len([f for f in os.listdir(cam01) if f.endswith(".jpg")])

    train, test = [], []
    for key in imgs:
        extr = imgs[key]
        R = colmap_io.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        number = os.path.basename(extr.name)[5:-4]
        folder = os.path.join(path, "cam" + number.zfill(2))
        test_idx = {0, n_frames // 3, (n_frames * 2) // 3}
        for i in range(n_frames):
            cam = graphics.make_camera(
                R, T, fovx, fovy, intr.width, intr.height,
                time=float(i / n_frames),
            )
            img_path = os.path.join(folder, f"frame_{i + 1:05d}.jpg")
            lc = LoadedCamera(cam, ImageRef(img_path, size))
            train.append(lc)
            if i in test_idx:
                test.append(lc)

    # spiral video path over the dedicated pose bounds file
    video = []
    pb = os.path.join(path, "poses_bounds_multipleview.npy")
    if os.path.exists(pb):
        poses_arr = np.load(pb)
        poses = poses_arr[:, :-2].reshape(-1, 3, 5)
        near_fars = poses_arr[:, -2:]
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], axis=-1
        )
        video = _spiral_cameras(
            poses, near_fars, focal, intr.width, intr.height, fovx, fovy
        )

    pcd = fetch_pointcloud(os.path.join(path, "points3D_multipleview.ply"))
    per_cam = [lc for lc in train if lc.camera.time == 0.0]
    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=video,
        point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(per_cam or train),
        maxtime=float(n_frames),
        dataset_type="MultipleView",
    )
