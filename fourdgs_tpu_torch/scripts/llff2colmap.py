"""Convert an LLFF ``poses_bounds.npy`` to COLMAP text-model inputs.

Counterpart of ``scripts/llff2colmap.py`` (the reference's): writes
``<workdir>/colmap/images`` (the first frame of each camera) and
``<workdir>/colmap/sparse_custom/{cameras,images,points3D}.txt`` for
``colmap point_triangulator`` (``colmap.sh``).

    python -m fourdgs_tpu_torch.scripts.llff2colmap <scene dir>
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

from fourdgs_tpu_torch.data.colmap_io import rotmat2qvec


def main(workdir: str) -> None:
    poses_arr = np.load(os.path.join(workdir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, -1]
    # the LLFF axis fix (as the Neu3D loader's)
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], axis=-1)

    out_img = os.path.join(workdir, "colmap", "images")
    out_sparse = os.path.join(workdir, "colmap", "sparse_custom")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_sparse, exist_ok=True)
    with open(os.path.join(out_sparse, "cameras.txt"), "w") as f:
        f.write(f"1 SIMPLE_PINHOLE {int(W)} {int(H)} {focal} {W/2} {H/2}\n")
    with open(os.path.join(out_sparse, "images.txt"), "w") as f:
        for i in range(poses.shape[0]):
            pose = poses[i]
            R = -pose[:3, :3]
            R[:, 0] = -R[:, 0]
            T = -pose[:3, 3].dot(R)
            qvec = rotmat2qvec(R.T)
            name = f"cam{i:02d}.png"
            f.write(f"{i+1} " + " ".join(map(str, qvec)) + " "
                    + " ".join(map(str, T)) + f" 1 {name}\n\n")
            # the first frame of each camera feeds the triangulation
            src = os.path.join(workdir, f"cam{i:02d}", "images", "0000.png")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_img, name))
    open(os.path.join(out_sparse, "points3D.txt"), "w").close()
    print(f"wrote COLMAP inputs → {out_sparse}")


if __name__ == "__main__":
    main(sys.argv[1])
