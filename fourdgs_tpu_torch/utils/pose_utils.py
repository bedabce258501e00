"""Camera-pose interpolation for smooth video paths.

A copy of ``fourdgs_tpu/utils/pose_utils.py`` (numpy only).

Parity target: utils/pose_utils.py in the reference (smooth_camera_poses,
:35-67): slerp on orientations + linear interpolation on positions between
consecutive cameras, ``num_interpolations`` inserted frames per segment, with
the reference's time parameterization. Used by the HyperNeRF video path
(scene/hyper_loader.py:110-116).
"""

from __future__ import annotations

import numpy as np


def rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w) — scipy's convention."""
    m = R
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (m[2, 1] - m[1, 2]) * s
        y = (m[0, 2] - m[2, 0]) * s
        z = (m[1, 0] - m[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (m[k, j] - m[j, k]) / s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def quaternion_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def quaternion_slerp(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    """Shortest-path slerp (pose_utils.py:11-29)."""
    dot = float(np.dot(q1, q2))
    if dot < 0.0:
        q1 = -q1
        dot = -dot
    dot = np.clip(dot, -1.0, 1.0)
    theta = np.arccos(dot) * t
    q3 = q2 - q1 * dot
    n = np.linalg.norm(q3)
    if n < 1e-12:
        return q1
    q3 = q3 / n
    return np.cos(theta) * q1 + np.sin(theta) * q3


def linear_interpolation(v1, v2, t):
    return (1 - t) * v1 + t * v2


def smooth_camera_poses(
    orientations: list[np.ndarray],
    positions: list[np.ndarray],
    num_interpolations: int = 5,
):
    """Interpolate (orientation, position) key poses → smooth path.

    Returns (orientations, positions, times) with times in the reference's
    parameterization (pose_utils.py:38-66). Works on raw pose arrays rather
    than Nerfies Camera objects so every loader can use it.
    """
    out_R: list[np.ndarray] = []
    out_p: list[np.ndarray] = []
    out_t: list[float] = []
    n = len(orientations)
    total = (n - 1) + (n - 1) * num_interpolations
    time_increment = 10.0 / max(total, 1)
    for i in range(n - 1):
        q1 = rotation_matrix_to_quaternion(orientations[i])
        q2 = rotation_matrix_to_quaternion(orientations[i + 1])
        for j in range(num_interpolations + 1):
            t = j / (num_interpolations + 1)
            out_R.append(
                quaternion_to_rotation_matrix(quaternion_slerp(q1, q2, t))
            )
            out_p.append(
                linear_interpolation(positions[i], positions[i + 1], t)
            )
            out_t.append(i * 10.0 / (n - 1) + time_increment * j)
    out_R.append(orientations[-1])
    out_p.append(positions[-1])
    out_t.append(1.0)
    return out_R, out_p, out_t
