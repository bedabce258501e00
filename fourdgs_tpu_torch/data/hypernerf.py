"""HyperNeRF (Nerfies-format) dataset loader.

A copy of ``fourdgs_tpu/data/hypernerf.py`` on the port's lazy
:class:`~fourdgs_tpu_torch.data.dynerf.ImageRef`: a frame whose size is
not ``int(image_size × ratio)`` is resized with LANCZOS when it is read, as
JAX's is. Covisible masks keep their paths here; the eval
(``train_torch.py``) and ``render_torch.py`` read them with the port's PNG
codec (:func:`read_mask`) and resize a mask of another size with BILINEAR,
as JAX's ``train.py`` and ``render.py`` do with Pillow.

Parity target: scene/hyper_loader.py + readHyperDataInfos in the reference:

- scene.json (near/far/scale/center), metadata.json (camera_id, warp_id),
  dataset.json (ids, val_ids/train_ids), camera/<id>.json Nerfies cameras
- warp_id / max(warp_id) → normalized time (hyper_loader.py:79-81)
- no val_ids ⇒ 4:1 split: train = ids[0::4], test = train+2 (minus last)
  (hyper_loader.py:62-66)
- pose: R = orientationᵀ, T = −position·R (hyper_loader.py:160-161);
  FoV from focal_length at the ratio-scaled resolution
- images at rgb/<1/ratio>x/<id>.png (default ratio 0.5 ⇒ rgb/2x);
  covisible/2x/val masks attached to test cameras and consumed by the
  masked test PSNR (train.py eval + metrics.py)
- video split: slerp+lerp smoothed camera path (hyper_loader.py:108-116)

Like the reference's rasterization path, the rendered camera is the pinhole
part of the Nerfies model: the reference parses the distortion coefficients
into scene/utils.py Camera objects but builds CameraInfo from
orientation/position/focal only (hyper_loader.py:160-164), i.e. radial/
tangential terms never reach the rasterizer — the released rgb/2x images
are rectified. The full distortion camera (project/undistort/pixel-to-ray,
scene/utils.py:98-428) lives in ``data/nerfies_camera.py`` for the
preprocessing tools.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch.data.blender import SceneData, get_nerfpp_norm
from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.data.ply import PointCloud, fetch_pointcloud
from fourdgs_tpu_torch.utils import graphics, png, resample
from fourdgs_tpu_torch.utils.pose_utils import smooth_camera_poses


class LoadedCamera(NamedTuple):
    camera: graphics.Camera
    image: ImageRef
    mask_path: str | None = None


def load_hypernerf_scene(path: str, cfg=None, ratio: float = 0.5) -> SceneData:
    path = os.path.expanduser(path)
    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        ds = json.load(f)

    all_ids = ds["ids"]
    val_ids = ds.get("val_ids", [])
    if len(val_ids) == 0:
        i_train = np.array([i for i in range(len(all_ids)) if i % 4 == 0])
        i_test = (i_train + 2)[:-1]
    else:
        train_ids = ds["train_ids"]
        i_train = [i for i, x in enumerate(all_ids) if x in train_ids]
        i_test = [i for i, x in enumerate(all_ids) if x in val_ids]

    warp = [meta[i]["warp_id"] for i in all_ids]
    max_warp = max(warp)
    times = [w / max_warp for w in warp]

    scale_dir = int(1 / ratio)
    covis_dir = os.path.join(path, "covisible", "2x", "val")
    has_covis = os.path.isdir(covis_dir)

    poses: dict[int, tuple] = {}  # idx → (orientation, position, focal, w, h)

    def make(idx, with_mask=False):
        img_id = all_ids[idx]
        with open(os.path.join(path, "camera", f"{img_id}.json")) as f:
            cj = json.load(f)
        orientation = np.asarray(cj["orientation"], np.float64)
        position = np.asarray(cj["position"], np.float64)
        focal = float(cj["focal_length"]) * ratio
        W0, H0 = cj["image_size"]
        w, h = int(W0 * ratio), int(H0 * ratio)
        poses[idx] = (orientation, position, focal, w, h)
        R = orientation.T
        T = -position @ R
        fovx = graphics.focal2fov(focal, w)
        fovy = graphics.focal2fov(focal, h)
        cam = graphics.make_camera(R, T, fovx, fovy, w, h, time=times[idx])
        img_path = os.path.join(path, "rgb", f"{scale_dir}x", f"{img_id}.png")
        mask = (
            os.path.join(covis_dir, f"{img_id}.png")
            if with_mask and has_covis else None
        )
        return LoadedCamera(cam, ImageRef(img_path, (w, h)), mask)

    train = [make(i) for i in i_train]
    test = [make(i, with_mask=True) for i in i_test]

    # video split: slerp+lerp smoothed path over the camera poses
    # (generate_video_path → smooth_camera_poses, hyper_loader.py:108-116
    # with utils/pose_utils.py:35-67; capped at 500 poses like the ref)
    key_idx = list(i_train)
    Rs = [poses[i][0] for i in key_idx]
    ps = [poses[i][1] for i in key_idx]
    video = []
    if len(Rs) >= 2:
        sR, sp, _ = smooth_camera_poses(Rs, ps, num_interpolations=10)
        sR, sp = sR[:500], sp[:500]
        _, _, focal, w, h = poses[key_idx[0]]
        fovx = graphics.focal2fov(focal, w)
        fovy = graphics.focal2fov(focal, h)
        n_v = len(sR)
        for k, (Rk, pk) in enumerate(zip(sR, sp)):
            R = Rk.T
            T = -pk @ R
            video.append(graphics.make_camera(
                R, T, fovx, fovy, w, h, time=k / max(n_v - 1, 1)
            ))
    else:
        video = [lc.camera for lc in test]

    # init cloud: points.npy (Nerfies) or points3D_downsample.ply
    pts_npy = os.path.join(path, "points.npy")
    ply = os.path.join(path, "points3D_downsample.ply")
    ply2 = os.path.join(path, "points3D_downsample2.ply")
    if os.path.exists(ply2):
        pcd = fetch_pointcloud(ply2)
    elif os.path.exists(ply):
        pcd = fetch_pointcloud(ply)
    elif os.path.exists(pts_npy):
        xyz = np.load(pts_npy).astype(np.float32)
        xyz = (xyz - np.asarray(scene_json["center"])) * scene_json["scale"]
        pcd = PointCloud(
            points=xyz.astype(np.float32),
            colors=np.full_like(xyz, 0.5),
            normals=np.zeros_like(xyz),
        )
    else:
        raise FileNotFoundError(f"no init point cloud found in {path}")

    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=video,
        point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train),
        maxtime=float(max_warp),
        dataset_type="nerfies",
    )


def read_mask(path: str, width: int, height: int) -> np.ndarray:
    """A covisible mask as uint8 [H, W] (Pillow's ``convert("L")``) for a
    ``width`` × ``height`` view; a mask of another size is resized with
    BILINEAR in mode L, as JAX's ``train.py:193-194`` and ``render.py:42-43``
    resize it with Pillow."""
    return resample.resize(png.convert(png.read_png(path), "L"), (width, height),
                           "bilinear")
