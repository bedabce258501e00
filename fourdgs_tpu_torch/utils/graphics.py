"""Camera / projection math.

Parity targets in the reference: utils/graphics_utils.py:32-79
(getWorld2View2, getProjectionMatrix, fov2focal/focal2fov), scene/cameras.py:17-66
(matrix assembly conventions), and cuda_rasterizer/auxiliary.h:41-44 (ndc2Pix).

Convention (identical to the reference's torch side): matrices are stored
**transposed** so points transform as row vectors — ``p_hom = [p, 1] @ M``.
``world_view`` maps world → view; ``full_proj = world_view @ proj`` maps
world → clip. The rasterizer consumes exactly these two matrices plus the
camera center.

The port's own numpy copy of ``fourdgs_tpu/utils/graphics.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World→view matrix in row-vector (transposed) convention.

    ``R`` is the camera-to-world rotation and ``t`` the COLMAP-style
    translation, as in the reference's getWorld2View2
    (utils/graphics_utils.py:38-49): W2C has rotation Rᵀ and translation t,
    with an optional recentering (translate, scale) applied to the camera
    center in world space.
    """
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    W2C = np.linalg.inv(C2W)
    return W2C.T.astype(np.float32)  # transposed for row-vector convention


def projection_matrix(
    znear: float, zfar: float, fovx: float, fovy: float
) -> np.ndarray:
    """Perspective projection, transposed (row-vector) convention.

    Parity: getProjectionMatrix (utils/graphics_utils.py:51-71): z maps to
    [0, zfar/(zfar-znear)·(z-znear)] with w = z_view (z_sign = +1).
    """
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.T.astype(np.float32)


def projection_matrix_from_intrinsics(
    znear: float, zfar: float,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
) -> np.ndarray:
    """Projection from a pinhole K with (possibly off-center) principal
    point, transposed (row-vector) convention.

    Parity: setup_camera's opengl_proj (scene/dataset_readers.py:528-532):
    the (cx, cy) offsets fold into the [0,2]/[1,2] entries
    -(w-2cx)/w and -(h-2cy)/h; centered principal point reduces to
    :func:`projection_matrix`.
    """
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * fx / width
    P[0, 2] = -(width - 2.0 * cx) / width
    P[1, 1] = 2.0 * fy / height
    P[1, 2] = -(height - 2.0 * cy) / height
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.T.astype(np.float32)


def make_camera_from_k(
    K: np.ndarray,
    w2c: np.ndarray,
    width: int,
    height: int,
    time: float = 0.0,
    znear: float = 0.01,
    zfar: float = 100.0,
) -> "Camera":
    """Camera directly from intrinsics K + extrinsics w2c, principal-point
    offsets folded into the projection (setup_camera,
    scene/dataset_readers.py:522-547)."""
    K = np.asarray(K, np.float64)
    w2c = np.asarray(w2c, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    wv = w2c.T.astype(np.float32)  # row-vector convention
    proj = projection_matrix_from_intrinsics(
        znear, zfar, fx, fy, cx, cy, width, height
    )
    full = (wv.astype(np.float64) @ proj.astype(np.float64)).astype(
        np.float32
    )
    cam_center = np.linalg.inv(w2c)[:3, 3].astype(np.float32)
    return Camera(
        world_view=wv,
        full_proj=full,
        camera_center=cam_center,
        tanfovx=float(width / (2.0 * fx)),
        tanfovy=float(height / (2.0 * fy)),
        width=int(width),
        height=int(height),
        time=float(time),
    )


def ndc2pix(v, size):
    """NDC [-1,1] → continuous pixel coordinate ((v+1)·S − 1)/2.

    Parity: auxiliary.h:41-44.
    """
    return ((v + 1.0) * size - 1.0) * 0.5


class Camera(NamedTuple):
    """A render-ready camera: the exact inputs the rasterizer consumes.

    Mirrors GaussianRasterizationSettings (reference
    diff_gaussian_rasterization/__init__.py:157-169) minus bg/scale_modifier,
    plus the per-camera normalized timestamp used by the deformation field
    (scene/cameras.py:31, gaussian_renderer/__init__.py:52).

    All array fields are plain float32 numpy/jax arrays so a batch of cameras
    stacks into a pytree that shards over a mesh 'data' axis.
    """

    world_view: np.ndarray  # [4,4] world→view, row-vector convention
    full_proj: np.ndarray   # [4,4] world→clip (= world_view @ proj)
    camera_center: np.ndarray  # [3]
    tanfovx: float
    tanfovy: float
    width: int
    height: int
    time: float  # normalized timestamp in [0,1]


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    time: float = 0.0,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> Camera:
    """Assemble a Camera the way scene/cameras.py:17-66 does."""
    wv = world_to_view(R, t, translate, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full = (wv.astype(np.float64) @ proj.astype(np.float64)).astype(np.float32)
    cam_center = np.linalg.inv(wv.astype(np.float64)).T[:3, 3].astype(np.float32)
    return Camera(
        world_view=wv,
        full_proj=full,
        camera_center=cam_center,
        tanfovx=float(math.tan(fovx / 2.0)),
        tanfovy=float(math.tan(fovy / 2.0)),
        width=int(width),
        height=int(height),
        time=float(time),
    )
