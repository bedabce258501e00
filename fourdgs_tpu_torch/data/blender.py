"""Blender / D-NeRF synthetic dataset loader.

A copy of ``fourdgs_tpu/data/blender.py`` whose frames are read by the
port's PNG codec (``utils/png.py``) and resized by its Pillow-exact
resampler (``utils/resample.py``) instead of Pillow: a frame whose size
differs from ``target_size`` (800×800 by default, as in JAX) is resized as
RGBA with Pillow's default filter, BICUBIC, premultiplied as Pillow
resamples RGBA, before the background composite.

Parity target: readNerfSyntheticInfo + readCamerasFromTransforms +
read_timeline in the reference (scene/dataset_readers.py:294-386):

- transforms_{train,test}.json with per-frame ``time``; timestamps normalized
  by the global max over train+test (read_timeline, :332-346)
- pose convention: M = inv(transform_matrix); R = −Mᵀ[:3,:3] with the first
  column re-negated; T = −M[:3,3] (:305-309)
- RGBA composited onto the configured background, resized to 800×800 (:315-321)
- random 2000-point init cloud in [−1.3, 1.3]³ when no fused.ply exists
  (:361-370); pass ``rng`` for a repeatable cloud

Images are kept as uint8 [H,W,3] host arrays (the training loop normalizes
per batch on device) — ~4× less host RAM than the reference's float tensors.
"""

from __future__ import annotations

import json
import math
import os
from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch.data.ply import PointCloud, fetch_pointcloud
from fourdgs_tpu_torch.utils import graphics, png, resample
from fourdgs_tpu_torch.utils.sh import C0


class LoadedCamera(NamedTuple):
    camera: graphics.Camera
    image: np.ndarray   # uint8 [H,W,3]


class SceneData(NamedTuple):
    train_cameras: list
    test_cameras: list
    video_cameras: list          # Camera only (no gt)
    point_cloud: PointCloud
    nerf_normalization: dict
    maxtime: float
    dataset_type: str


def read_timeline(path: str):
    tl = []
    for split in ("transforms_train.json", "transforms_test.json"):
        with open(os.path.join(path, split)) as f:
            tl += [fr["time"] for fr in json.load(f)["frames"]]
    times = sorted(set(tl))
    max_time = max(times)
    return {t: t / max_time for t in times}, max_time


def _pose_from_transform(transform_matrix):
    m = np.linalg.inv(np.array(transform_matrix, np.float64))
    R = -m[:3, :3].T
    R[:, 0] = -R[:, 0]
    T = -m[:3, 3]
    return R, T


def read_cameras_from_transforms(
    path: str,
    transformsfile: str,
    white_background: bool,
    extension: str,
    mapper: dict,
    target_size: tuple[int, int] = (800, 800),
) -> list[LoadedCamera]:
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    if "camera_angle_x" in contents:
        fovx = contents["camera_angle_x"]
    else:
        fovx = graphics.focal2fov(contents["fl_x"], contents["w"])
    bg = np.array([1.0, 1.0, 1.0]) if white_background else np.zeros(3)

    out = []
    for frame in contents["frames"]:
        img_path = os.path.join(path, frame["file_path"] + extension)
        time = mapper[frame["time"]]
        R, T = _pose_from_transform(frame["transform_matrix"])

        img = png.convert(png.read_png(img_path), "RGBA")
        if (img.shape[1], img.shape[0]) != tuple(target_size):
            img = resample.resize(img, target_size, "bicubic")
        data = img.astype(np.float32) / 255.0
        rgb = data[:, :, :3] * data[:, :, 3:4] + bg * (1.0 - data[:, :, 3:4])
        rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

        h, w = rgb_u8.shape[:2]
        fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
        cam = graphics.make_camera(R, T, fovx, fovy, w, h, time=time)
        out.append(LoadedCamera(camera=cam, image=rgb_u8))
    return out


def pose_spherical(azimuth_deg: float, elevation_deg: float, radius: float):
    """Spherical camera-to-world pose for the video render path
    (dataset_readers.py:234-260 trans/rot composition)."""
    def trans_t(t):
        m = np.eye(4)
        m[2, 3] = t
        return m

    def rot_phi(phi):
        m = np.eye(4)
        c, s = math.cos(phi), math.sin(phi)
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
        return m

    def rot_theta(th):
        m = np.eye(4)
        c, s = math.cos(th), math.sin(th)
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        return m

    c2w = trans_t(radius)
    c2w = rot_phi(elevation_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(azimuth_deg / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]) @ c2w
    return c2w


def generate_video_cameras(
    path: str, transformsfile: str, max_time: float, n_frames: int = 160,
    target_size: tuple[int, int] = (800, 800),
) -> list[graphics.Camera]:
    """Spherical orbit with time sweep (generateCamerasFromTransforms)."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    w, h = target_size
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    cams = []
    times = np.linspace(0, 1, n_frames)
    for i, az in enumerate(np.linspace(-180, 180, n_frames + 1)[:-1]):
        c2w = pose_spherical(az, -30.0, 4.0)
        m = np.linalg.inv(c2w)
        R = -m[:3, :3].T
        R[:, 0] = -R[:, 0]
        T = -m[:3, 3]
        cams.append(
            graphics.make_camera(R, T, fovx, fovy, w, h, time=float(times[i]))
        )
    return cams


def get_nerfpp_norm(cameras: list) -> dict:
    """Camera-extent normalization (getNerfppNorm, dataset_readers.py:86-107)."""
    centers = np.stack([lc.camera.camera_center for lc in cameras], axis=0)
    avg = centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=-1)
    diagonal = float(dist.max())
    radius = diagonal * 1.1
    return {"translate": -avg[0], "radius": radius}


def load_blender_scene(
    path: str,
    white_background: bool = True,
    eval_split: bool = True,
    extension: str = ".png",
    target_size: tuple[int, int] = (800, 800),
    rng: np.random.Generator | None = None,
) -> SceneData:
    mapper, max_time = read_timeline(path)
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension, mapper,
        target_size,
    )
    test = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension, mapper,
        target_size,
    )
    video = generate_video_cameras(
        path, "transforms_train.json", max_time, target_size=target_size
    )
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "fused.ply")
    if os.path.exists(ply_path):
        pcd = fetch_pointcloud(ply_path)
    else:
        # random init cloud in the Blender scene bounds (:361-370); colors via
        # SH2RGB of tiny random coefficients.
        rng = rng or np.random.default_rng()
        num_pts = 2000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        pcd = PointCloud(
            points=xyz.astype(np.float32),
            colors=(shs * C0 + 0.5).astype(np.float32),
            normals=np.zeros((num_pts, 3), np.float32),
        )

    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=video,
        point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train),
        maxtime=max_time,
        dataset_type="blender",
    )
