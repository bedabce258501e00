"""Nerfies camera model: full pinhole + radial/tangential distortion.

A copy of ``fourdgs_tpu/data/nerfies_camera.py`` (numpy only).

Parity target: scene/utils.py:28-428 + scene/camera.py in the reference —
the camera model HyperNeRF datasets ship per-image JSONs for (orientation,
position, focal_length, principal_point, skew, pixel_aspect_ratio,
radial_distortion [k1,k2,k3], tangential_distortion [p1,p2], image_size).

The rasterizer consumes only the pinhole part (see data/hypernerf.py);
this class exists for the preprocessing tools — undistortion, ray
generation, depth → point lifting, scaling cameras between rgb/<N>x levels,
and the hypernerf→colmap converter.

Math: the standard OpenCV Brown–Conrady model. ``project`` applies
  d(r²) = 1 + k1 r² + k2 r⁴ + k3 r⁶
  x' = x·d + 2 p1 xy + p2 (r² + 2x²)
  y' = y·d + 2 p2 xy + p1 (r² + 2y²)
and ``undistort`` inverts it with a vectorized 2×2 Newton iteration
(10 steps, as the reference's _radial_and_tangential_undistort).
"""

from __future__ import annotations

import json

import numpy as np


def _distort(x, y, k1, k2, k3, p1, p2):
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    xd = x * d + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * d + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return xd, yd


def undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
              iterations: int = 10, eps: float = 1e-9):
    """Invert the Brown–Conrady map by Newton on F(x,y) = distort(x,y)−(xd,yd).

    Vectorized over arbitrary shapes. 10 iterations is the reference's
    budget (scene/utils.py:64-97); convergence is quadratic for the mild
    distortions in released captures.
    """
    x = np.array(xd, np.float64, copy=True)
    y = np.array(yd, np.float64, copy=True)
    for _ in range(iterations):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
        dd = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # ∂d/∂r²  (·2x, ·2y below)
        fx, fy = _distort(x, y, k1, k2, k3, p1, p2)
        fx -= xd
        fy -= yd
        # Jacobian of the distortion map
        j00 = d + 2.0 * x * x * dd + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = 2.0 * x * y * dd + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = 2.0 * x * y * dd + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = d + 2.0 * y * y * dd + 2.0 * p2 * x + 6.0 * p1 * y
        det = j00 * j11 - j01 * j10
        safe = np.abs(det) > eps
        inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
        x = x - inv * (j11 * fx - j01 * fy)
        y = y - inv * (j00 * fy - j10 * fx)
    return x, y


class NerfiesCamera:
    """np-backed camera with the full Nerfies parameter set."""

    def __init__(self, orientation, position, focal_length, principal_point,
                 image_size, skew=0.0, pixel_aspect_ratio=1.0,
                 radial_distortion=None, tangential_distortion=None):
        self.orientation = np.asarray(orientation, np.float64)  # world→cam R
        self.position = np.asarray(position, np.float64)
        self.focal_length = float(focal_length)
        self.principal_point = np.asarray(principal_point, np.float64)
        self.image_size = np.asarray(image_size, np.int64)  # (W, H)
        self.skew = float(skew)
        self.pixel_aspect_ratio = float(pixel_aspect_ratio)
        self.radial_distortion = (
            np.zeros(3) if radial_distortion is None
            else np.asarray(radial_distortion, np.float64)
        )
        self.tangential_distortion = (
            np.zeros(2) if tangential_distortion is None
            else np.asarray(tangential_distortion, np.float64)
        )

    # -- serialization (scene/utils.py from_json/to_json) --------------------
    @classmethod
    def from_json(cls, path: str) -> "NerfiesCamera":
        with open(path) as f:
            cj = json.load(f)
        if "tangential" in cj:  # old-format fixup, scene/utils.py:137-139
            cj["tangential_distortion"] = cj["tangential"]
        return cls(
            orientation=cj["orientation"],
            position=cj["position"],
            focal_length=cj["focal_length"],
            principal_point=cj["principal_point"],
            image_size=cj["image_size"],
            skew=cj.get("skew", 0.0),
            pixel_aspect_ratio=cj.get("pixel_aspect_ratio", 1.0),
            radial_distortion=cj.get("radial_distortion"),
            tangential_distortion=cj.get("tangential_distortion"),
        )

    def to_json(self) -> dict:
        return {
            "orientation": self.orientation.tolist(),
            "position": self.position.tolist(),
            "focal_length": self.focal_length,
            "principal_point": self.principal_point.tolist(),
            "skew": self.skew,
            "pixel_aspect_ratio": self.pixel_aspect_ratio,
            "radial_distortion": self.radial_distortion.tolist(),
            "tangential_distortion": self.tangential_distortion.tolist(),
            "image_size": self.image_size.tolist(),
        }

    # -- geometry -------------------------------------------------------------
    @property
    def optical_axis(self):
        return self.orientation[2]

    @property
    def translation(self):
        """COLMAP-convention t = −R·c (scene/utils.py:213-214)."""
        return -self.orientation @ self.position

    @property
    def has_distortion(self) -> bool:
        return bool(
            np.any(self.radial_distortion != 0)
            or np.any(self.tangential_distortion != 0)
        )

    def project(self, points: np.ndarray) -> np.ndarray:
        """World points [..., 3] → pixel positions [..., 2]
        (scene/utils.py:275-306)."""
        pts = np.asarray(points, np.float64)
        shape = pts.shape[:-1]
        local = (self.orientation @ (pts.reshape(-1, 3) - self.position).T).T
        x = local[:, 0] / local[:, 2]
        y = local[:, 1] / local[:, 2]
        k1, k2, k3 = self.radial_distortion
        p1, p2 = self.tangential_distortion
        xd, yd = _distort(x, y, k1, k2, k3, p1, p2)
        px = self.focal_length * xd + self.skew * yd + self.principal_point[0]
        py = (self.focal_length * self.pixel_aspect_ratio * yd
              + self.principal_point[1])
        return np.stack([px, py], axis=-1).reshape(*shape, 2)

    def pixel_to_local_rays(self, pixels: np.ndarray) -> np.ndarray:
        """Pixels [..., 2] → unit ray directions in camera frame
        (scene/utils.py:216-233)."""
        pix = np.asarray(pixels, np.float64)
        fy = self.focal_length * self.pixel_aspect_ratio
        y = (pix[..., 1] - self.principal_point[1]) / fy
        x = (pix[..., 0] - self.principal_point[0] - y * self.skew) / (
            self.focal_length
        )
        if self.has_distortion:
            k1, k2, k3 = self.radial_distortion
            p1, p2 = self.tangential_distortion
            x, y = undistort(x, y, k1, k2, k3, p1, p2)
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
        """Pixels → unit ray directions in world frame
        (scene/utils.py:235-260)."""
        local = self.pixel_to_local_rays(pixels)
        world = local @ self.orientation  # R.T @ d, batched
        return world / np.linalg.norm(world, axis=-1, keepdims=True)

    def pixels_to_points(self, pixels: np.ndarray,
                         depth: np.ndarray) -> np.ndarray:
        """Lift pixels to world points at optical-axis depth
        (scene/utils.py:262-268)."""
        rays = self.pixels_to_rays(pixels)
        cosa = rays @ self.optical_axis
        return rays * (np.asarray(depth) / cosa)[..., None] + self.position

    def get_pixel_centers(self) -> np.ndarray:
        """[H, W, 2] pixel-center grid (scene/utils.py:308-312)."""
        w, h = int(self.image_size[0]), int(self.image_size[1])
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        return np.stack([xx, yy], axis=-1) + 0.5

    def scale(self, factor: float) -> "NerfiesCamera":
        """Rescaled camera for a different rgb/<N>x level
        (scene/utils.py:314-334)."""
        if factor <= 0:
            raise ValueError("scale must be positive")
        return NerfiesCamera(
            orientation=self.orientation.copy(),
            position=self.position.copy(),
            focal_length=self.focal_length * factor,
            principal_point=self.principal_point * factor,
            image_size=np.round(self.image_size * factor).astype(np.int64),
            skew=self.skew,
            pixel_aspect_ratio=self.pixel_aspect_ratio,
            radial_distortion=self.radial_distortion.copy(),
            tangential_distortion=self.tangential_distortion.copy(),
        )
