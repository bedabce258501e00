"""PLY I/O: point-cloud reading and 3DGS-standard model snapshots.

Replaces the reference's plyfile dependency (gaussian_model.py:250-314
save_ply/load_ply, dataset_readers.py fetchPly/storePly) with a small native
reader/writer for ascii and binary_little_endian PLY. The Gaussian snapshot
uses the 3DGS-standard vertex attribute list (x,y,z, nx,ny,nz, f_dc_*,
f_rest_*, opacity, scale_*, rot_* — construct_list_of_attributes,
gaussian_model.py:214-231) so snapshots interoperate with stock 3DGS viewers.

The port's own numpy copy of ``fourdgs_tpu/data/ply.py``: snapshots written
by either package load in the other.
"""

from __future__ import annotations

import io
from typing import NamedTuple

import numpy as np


class PointCloud(NamedTuple):
    points: np.ndarray   # [N,3] f32
    colors: np.ndarray   # [N,3] f32 in [0,1]
    normals: np.ndarray  # [N,3] f32


_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the vertex element of an ascii/binary_little_endian PLY file.

    Returns {property_name: [N] array}.
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n_vertex = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2], _DTYPES[tok[1]]))

    dtype = np.dtype([(name, dt) for name, dt in props])
    if fmt == "binary_little_endian":
        arr = np.frombuffer(body, dtype=dtype, count=n_vertex)
    elif fmt == "ascii":
        arr = np.loadtxt(
            io.BytesIO(body), dtype=dtype, max_rows=n_vertex, ndmin=1
        )
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return {name: np.ascontiguousarray(arr[name]) for name, _ in props}


def write_ply(path: str, fields: dict[str, np.ndarray]):
    """Write a binary_little_endian PLY vertex element from named columns."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    dtype = np.dtype([(k, "<f4") for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = np.asarray(fields[k], np.float32).reshape(n)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {k}" for k in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def fetch_pointcloud(path: str) -> PointCloud:
    """fetchPly equivalent (dataset_readers.py): xyz + rgb/255 + normals."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=-1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.5:  # uchar colors
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return PointCloud(points=pts, colors=cols, normals=normals)


def store_pointcloud(path: str, points: np.ndarray, colors_255: np.ndarray):
    """storePly equivalent: xyz + normals + uchar rgb."""
    n = points.shape[0]
    dtype = np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ])
    rec = np.zeros(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = points.T.astype(np.float32)
    c = np.clip(colors_255, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = c.T
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property float nx", "property float ny", "property float nz",
              "property uchar red", "property uchar green", "property uchar blue",
              "end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def save_gaussian_ply(path: str, params: dict, alive: np.ndarray):
    """3DGS-standard model snapshot (gaussian_model.py:250-267).

    Only alive primitives are written; attribute order matches
    construct_list_of_attributes so stock 3DGS viewers load it.
    """
    alive = np.asarray(alive)
    xyz = np.asarray(params["xyz"])[alive]
    f_dc = np.asarray(params["f_dc"])[alive]      # [N,3] (rank-2 storage)
    f_rest = np.asarray(params["f_rest"])[alive]  # [N,3(K-1)] coeff-major
    opacity = np.asarray(params["opacity"])[alive]
    scaling = np.asarray(params["scaling"])[alive]
    rotation = np.asarray(params["rotation"])[alive]
    n = xyz.shape[0]

    fields: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        fields[k] = xyz[:, i]
    for k in ("nx", "ny", "nz"):
        fields[k] = np.zeros(n, np.float32)
    # torch layout: features transposed to [N, 3, K] then flattened
    # (save_ply, gaussian_model.py:256-257)
    for i in range(f_dc.shape[1]):
        fields[f"f_dc_{i}"] = f_dc[:, i]
    rest_t = f_rest.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_t.shape[1]):
        fields[f"f_rest_{i}"] = rest_t[:, i]
    fields["opacity"] = opacity[:, 0]
    for i in range(scaling.shape[1]):
        fields[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        fields[f"rot_{i}"] = rotation[:, i]
    write_ply(path, fields)


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """Inverse of save_gaussian_ply (load_ply, gaussian_model.py:274-314).

    Returns unpadded param arrays (caller pads to capacity).
    """
    v = read_ply(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=-1)
    n_dc = sum(1 for k in v if k.startswith("f_dc_"))
    n_rest = sum(1 for k in v if k.startswith("f_rest_"))
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(n_dc)], axis=-1)
    if n_rest:
        rest = np.stack([v[f"f_rest_{i}"] for i in range(n_rest)], axis=-1)
        # ply channel-major [N,3,K-1] → stored coeff-major [N,3(K-1)]
        f_rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1).reshape(
            n, -1
        )
    else:
        f_rest = np.zeros((n, 0), np.float32)
    n_scale = sum(1 for k in v if k.startswith("scale_"))
    n_rot = sum(1 for k in v if k.startswith("rot_"))
    return {
        "xyz": xyz.astype(np.float32),
        "f_dc": f_dc.astype(np.float32),
        "f_rest": f_rest.astype(np.float32),
        "opacity": v["opacity"][:, None].astype(np.float32),
        "scaling": np.stack(
            [v[f"scale_{i}"] for i in range(n_scale)], axis=-1
        ).astype(np.float32),
        "rotation": np.stack(
            [v[f"rot_{i}"] for i in range(n_rot)], axis=-1
        ).astype(np.float32),
    }
