"""Convert a Blender/D-NeRF scene's cameras to COLMAP text-model inputs.

Counterpart of ``scripts/blender2colmap.py`` (the reference's): copies every
train frame to ``colmap/images`` and writes
``colmap/sparse_custom/{cameras,images,points3D}.txt`` for triangulation by
``colmap.sh``. The frame size is read with the port's PNG decoder.

    python -m fourdgs_tpu_torch.scripts.blender2colmap <scene dir>
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys

from fourdgs_tpu_torch.data.blender import _pose_from_transform
from fourdgs_tpu_torch.data.colmap_io import rotmat2qvec
from fourdgs_tpu_torch.utils.png import read_png


def main(workdir: str) -> None:
    with open(os.path.join(workdir, "transforms_train.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    out_img = os.path.join(workdir, "colmap", "images")
    out_sparse = os.path.join(workdir, "colmap", "sparse_custom")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_sparse, exist_ok=True)

    H, W = read_png(os.path.join(workdir, frames[0]["file_path"] + ".png")).shape[:2]
    focal = W / (2.0 * math.tan(meta["camera_angle_x"] / 2.0))
    with open(os.path.join(out_sparse, "cameras.txt"), "w") as f:
        f.write(f"1 SIMPLE_PINHOLE {W} {H} {focal} {W/2} {H/2}\n")
    with open(os.path.join(out_sparse, "images.txt"), "w") as f:
        for i, fr in enumerate(frames):
            R, T = _pose_from_transform(fr["transform_matrix"])
            qvec = rotmat2qvec(R.T)
            name = f"r_{i:04d}.png"
            f.write(f"{i+1} " + " ".join(map(str, qvec)) + " "
                    + " ".join(map(str, T)) + f" 1 {name}\n\n")
            shutil.copy(os.path.join(workdir, fr["file_path"] + ".png"),
                        os.path.join(out_img, name))
    open(os.path.join(out_sparse, "points3D.txt"), "w").close()
    print(f"wrote COLMAP inputs → {out_sparse}")


if __name__ == "__main__":
    main(sys.argv[1])
