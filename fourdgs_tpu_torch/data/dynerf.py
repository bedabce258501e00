"""Neu3D / DyNeRF multi-view video loader.

A copy of ``fourdgs_tpu/data/dynerf.py`` whose frames are read by the
port's PNG codec (``utils/png.py``) or JPEG decoder (``utils/jpeg.py``) and
resized by its Pillow-exact resampler (``utils/resample.py``) instead of
Pillow; its :class:`ImageRef` is the lazy frame of every loader but
Blender's.

Parity target: scene/neural_3D_dataset_NDC.py + readdynerfInfo
(dataset_readers.py:479-520) in the reference:

- ``poses_bounds.npy`` LLFF poses → [N,3,5]; axis fix
  [pose[:,1], −pose[:,0], pose[:,2:4]]; per-camera R = −P[:3,:3] with first
  column re-negated, T = −P[:3,3]·R (neural_3D_dataset_NDC.py:271, 352-356)
- focal from poses[0,:,-1] divided by (2704 / target width); default
  resolution 1352×1014 (:228-231)
- frames already extracted into cam*/images/%04d.png; time = frame_idx/300
- camera eval_index=0 held out as the test view (:289-292)
- init cloud from points3D_downsample2.ply; maxtime 300 (:482, 518)
- spiral validation path for the video split (get_spiral, :185-207)

A frame whose size is not ``target_wh`` is resized with LANCZOS when it is
read (:class:`ImageRef`), as JAX's is. One step of JAX's loader is not
ported: the extraction of ``cam*.mp4`` into ``cam*/images`` (cv2): a scene
with videos and no extracted frames raises ``NotImplementedError`` naming
the step.

Images are **lazy** (path-backed refs read at batch time): a full Neu3D
scene is ~6k frames ≈ 23 GB decoded. The training loop decodes the next
batch on the native prefetcher (``data/fastloader.py``) while a step runs.
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np

from fourdgs_tpu_torch.data.blender import SceneData, get_nerfpp_norm
from fourdgs_tpu_torch.data.ply import fetch_pointcloud
from fourdgs_tpu_torch.utils import graphics, jpeg, png, resample


class ImageRef:
    """Lazy uint8 [H, W, 3] frame of ``size`` = (W, H); called by the loop
    when batching. Decodes a PNG with the port's PNG codec and a JPEG with
    its JPEG decoder, chosen by the file's first bytes (alpha dropped, gray
    replicated, as Pillow's ``convert("RGB")``), and resizes a frame of
    another size with LANCZOS, as JAX's ``Image.resize`` does."""

    __slots__ = ("path", "size")

    def __init__(self, path: str, size: tuple[int, int]):
        self.path = path
        self.size = tuple(size)

    def __call__(self) -> np.ndarray:
        with open(self.path, "rb") as f:
            magic = f.read(len(png.SIGNATURE))
        if magic == png.SIGNATURE:
            img = png.read_png(self.path, "RGB")
        elif magic.startswith(jpeg.SOI):
            img = png.convert(jpeg.read_jpeg(self.path), "RGB")
        else:
            raise ValueError(f"{self.path}: neither a PNG nor a JPEG file")
        if (img.shape[1], img.shape[0]) != self.size:
            img = resample.resize(img, self.size, "lanczos")
        return img

    @property
    def shape(self):
        return (self.size[1], self.size[0], 3)

    @property
    def ndim(self):
        return 3


class LoadedCamera(NamedTuple):
    camera: graphics.Camera
    image: ImageRef


def load_dynerf_scene(
    path: str, cfg=None, eval_index: int = 0, n_frames: int = 300,
    target_wh: tuple[int, int] = (1352, 1014),
) -> SceneData:
    poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)
    near_fars = poses_arr[:, -2:]
    H0, W0, focal0 = poses[0, :, -1]
    downsample = 2704.0 / target_wh[0]
    focal = focal0 / downsample
    # LLFF axis permutation (neural_3D_dataset_NDC.py:271)
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], axis=-1
    )

    videos = sorted(glob.glob(os.path.join(path, "cam*.mp4")))
    if videos and len(videos) != poses.shape[0]:
        raise ValueError(
            f"{len(videos)} videos vs {poses.shape[0]} poses in {path}"
        )
    cam_dirs = (
        [v.split(".")[0] for v in videos]
        if videos
        else sorted(
            d for d in glob.glob(os.path.join(path, "cam*")) if os.path.isdir(d)
        )
    )

    W, H = target_wh
    fovx = graphics.focal2fov(focal, W)
    fovy = graphics.focal2fov(focal, H)

    train, test = [], []
    for ci, cam_dir in enumerate(cam_dirs):
        img_dir = os.path.join(cam_dir, "images")
        if not os.path.isdir(img_dir) and videos:
            raise NotImplementedError(
                f"{videos[ci]}: no extracted frames in {img_dir}; extracting "
                f"them from the video (fourdgs_tpu/data/dynerf.py::"
                f"_extract_video_frames, cv2 and Pillow) is not ported")
        frames = sorted(os.listdir(img_dir))[:n_frames]
        pose = poses[ci]
        R = -pose[:3, :3]
        R[:, 0] = -R[:, 0]
        T = -pose[:3, 3].dot(R)
        split = test if ci == eval_index else train
        for fi, fname in enumerate(frames):
            cam = graphics.make_camera(
                R, T, fovx, fovy, W, H, time=fi / n_frames
            )
            split.append(LoadedCamera(
                camera=cam,
                image=ImageRef(os.path.join(img_dir, fname), target_wh),
            ))

    # spiral video path over the held-out-style trajectory
    video_cams = _spiral_cameras(poses, near_fars, focal, W, H, fovx, fovy)

    pcd = fetch_pointcloud(os.path.join(path, "points3D_downsample2.ply"))
    # one camera per time-0 frame for the extent estimate
    per_cam = [lc for lc in train if lc.camera.time == 0.0]

    return SceneData(
        train_cameras=train,
        test_cameras=test,
        video_cameras=video_cams,
        point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(per_cam or train),
        maxtime=float(n_frames),
        dataset_type="dynerf",
    )


def _spiral_cameras(poses, near_fars, focal, W, H, fovx, fovy, n_views=300):
    """Spiral render path (get_spiral, neural_3D_dataset_NDC.py:185-207)."""
    c2w = _average_pose(poses)
    up = poses[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    dt = 0.75
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal_spiral = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, axis=0)
    cams = []
    times = np.linspace(0.0, 1.0, n_views)
    for i, theta in enumerate(
        np.linspace(0.0, 2.0 * np.pi * 2, n_views + 1)[:-1]
    ):
        c = np.dot(
            c2w[:3, :4],
            np.array(
                [np.cos(theta), -np.sin(theta),
                 -np.sin(theta * 0.5), 1.0]
            ) * np.array([*rads, 1.0]),
        )
        z = c - np.dot(c2w[:3, :4], np.array([0, 0, -focal_spiral, 1.0]))
        z = z / np.linalg.norm(z)
        pose = np.eye(3, 5)
        pose[:3, :4] = _viewmatrix(z, up, c)
        R = -pose[:3, :3]
        R[:, 0] = -R[:, 0]
        T = -pose[:3, 3].dot(R)
        cams.append(graphics.make_camera(
            R, T, fovx, fovy, W, H, time=float(times[i])
        ))
    return cams


def _viewmatrix(z, up, pos):
    vec2 = z / np.linalg.norm(z)
    vec1_avg = up
    vec0 = np.cross(vec1_avg, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _average_pose(poses):
    center = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].sum(0)
    z = z / np.linalg.norm(z)
    up = poses[:, :3, 1].sum(0)
    m = np.eye(4)
    m[:3, :4] = _viewmatrix(z, up, center)
    return m
