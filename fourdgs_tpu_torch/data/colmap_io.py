"""COLMAP sparse-reconstruction parsers (binary + text).

A copy of ``fourdgs_tpu/data/colmap_io.py`` (numpy and ``struct``), with
its readers and writers.

Equivalent of scene/colmap_loader.py in the reference: cameras.bin/.txt,
images.bin/.txt, points3D.bin/.ply readers plus quaternion helpers. The
formats are COLMAP's public on-disk layouts.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

# camera model id → (name, n_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion → rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cid = int(tok[0])
            out[cid] = ColmapCamera(
                cid, tok[1], int(tok[2]), int(tok[3]),
                np.array(list(map(float, tok[4:]))),
            )
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            rec = np.frombuffer(
                f.read(24 * n_pts),
                dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
            )
            xys = np.stack([rec["x"], rec["y"]], axis=-1)
            ids = rec["id"].copy()
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"), xys, ids
            )
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [
            line.strip() for line in f
            if line.strip() and not line.startswith("#")
        ]
    for i in range(0, len(lines), 2):
        tok = lines[i].split()
        iid = int(tok[0])
        qvec = np.array(list(map(float, tok[1:5])))
        tvec = np.array(list(map(float, tok[5:8])))
        cam_id = int(tok[8])
        name = tok[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [list(map(float, pts[j:j + 2])) for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)])
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_points3d_binary(path: str):
    """Returns (xyz [N,3], rgb [N,3] uint8, errors [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _ = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyz.append(list(map(float, tok[1:4])))
            rgb.append(list(map(int, tok[4:7])))
            err.append(float(tok[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def read_model(sparse_dir: str):
    """Load (cameras, images, points) preferring binary."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts = None
    if os.path.exists(os.path.join(sparse_dir, "points3D.bin")):
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    elif os.path.exists(os.path.join(sparse_dir, "points3D.txt")):
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


# -- writers (scripts/colmap_converter.py parity: full binary+text model
#    write-out, enabling .bin <-> .txt conversion and synthetic model dumps)


class ColmapPoint3D(NamedTuple):
    id: int
    xyz: np.ndarray          # [3] float64
    rgb: np.ndarray          # [3] uint8
    error: float
    image_ids: np.ndarray    # [track] int32
    point2d_idxs: np.ndarray # [track] int32


def read_points3d_full(path: str) -> dict[int, ColmapPoint3D]:
    """points3D with ids + tracks preserved (for lossless conversion)."""
    out = {}
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            (n,) = _read(f, 8, "Q")
            for _ in range(n):
                pid = _read(f, 8, "Q")[0]
                xyz = np.array(_read(f, 24, "ddd"))
                rgb = np.array(_read(f, 3, "BBB"), np.uint8)
                err = _read(f, 8, "d")[0]
                (tl,) = _read(f, 8, "Q")
                track = np.array(_read(f, 8 * tl, "ii" * tl), np.int32)
                out[pid] = ColmapPoint3D(
                    int(pid), xyz, rgb, float(err),
                    track[0::2].copy(), track[1::2].copy(),
                )
    else:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                tok = line.split()
                pid = int(tok[0])
                track = np.array(list(map(int, tok[8:])), np.int32)
                out[pid] = ColmapPoint3D(
                    pid, np.array(list(map(float, tok[1:4]))),
                    np.array(list(map(int, tok[4:7])), np.uint8),
                    float(tok[7]), track[0::2].copy(), track[1::2].copy(),
                )
    return out


_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def write_cameras_text(cameras: dict[int, ColmapCamera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cid in sorted(cameras):
            c = cameras[cid]
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_cameras_binary(cameras: dict[int, ColmapCamera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid in sorted(cameras):
            c = cameras[cid]
            f.write(struct.pack("<iiQQ", c.id, _MODEL_IDS[c.model],
                                c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params),
                                *map(float, c.params)))


def write_images_text(images: dict[int, ColmapImage], path: str):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for iid in sorted(images):
            im = images[iid]
            head = [im.id, *map(float, im.qvec), *map(float, im.tvec),
                    im.camera_id, im.name]
            f.write(" ".join(map(str, head)) + "\n")
            pts = []
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                pts += [repr(float(x)), repr(float(y)), str(int(pid))]
            f.write(" ".join(pts) + "\n")


def write_images_binary(images: dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid in sorted(images):
            im = images[iid]
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *map(float, im.qvec)))
            f.write(struct.pack("<ddd", *map(float, im.tvec)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3d_ids)))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def write_points3d_text(points: dict[int, ColmapPoint3D], path: str):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for pid in sorted(points):
            p = points[pid]
            track = []
            for img_id, p2d in zip(p.image_ids, p.point2d_idxs):
                track += [str(int(img_id)), str(int(p2d))]
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            f.write(
                f"{p.id} {xyz} "
                f"{int(p.rgb[0])} {int(p.rgb[1])} {int(p.rgb[2])} "
                f"{float(p.error)!r} " + " ".join(track) + "\n"
            )


def write_points3d_binary(points: dict[int, ColmapPoint3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid in sorted(points):
            p = points[pid]
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *map(float, p.xyz)))
            f.write(struct.pack("<BBB", *map(int, p.rgb)))
            f.write(struct.pack("<d", float(p.error)))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img_id, p2d in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(img_id), int(p2d)))


def read_model_full(sparse_dir: str, ext: str | None = None):
    """(cameras, images, points3D-with-tracks); ext '.bin'/'.txt' or auto."""
    if ext is None:
        ext = ".bin" if os.path.exists(
            os.path.join(sparse_dir, "cameras.bin")
        ) else ".txt"
    if ext == ".bin":
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts_path = os.path.join(sparse_dir, "points3D" + ext)
    pts = read_points3d_full(pts_path) if os.path.exists(pts_path) else {}
    return cams, imgs, pts


def write_model(cameras, images, points, out_dir: str, ext: str = ".bin"):
    os.makedirs(out_dir, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(out_dir, "cameras.bin"))
        write_images_binary(images, os.path.join(out_dir, "images.bin"))
        write_points3d_binary(points, os.path.join(out_dir, "points3D.bin"))
    elif ext == ".txt":
        write_cameras_text(cameras, os.path.join(out_dir, "cameras.txt"))
        write_images_text(images, os.path.join(out_dir, "images.txt"))
        write_points3d_text(points, os.path.join(out_dir, "points3D.txt"))
    else:
        raise ValueError(f"ext must be '.bin' or '.txt', got {ext!r}")
