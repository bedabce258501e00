"""Convert HyperNeRF (Nerfies) cameras to COLMAP text-model inputs.

Counterpart of ``scripts/hypernerf2colmap.py`` (the reference's): the
``rgb/<1/ratio>x`` frames and the pinhole part of ``camera/<id>.json``
become ``colmap/images`` and ``colmap/sparse_custom`` for triangulation.

    python -m fourdgs_tpu_torch.scripts.hypernerf2colmap <scene dir>
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

from fourdgs_tpu_torch.data.colmap_io import rotmat2qvec


def main(workdir: str, ratio: float = 0.5) -> None:
    with open(os.path.join(workdir, "dataset.json")) as f:
        ids = json.load(f)["ids"]
    out_img = os.path.join(workdir, "colmap", "images")
    out_sparse = os.path.join(workdir, "colmap", "sparse_custom")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_sparse, exist_ok=True)
    scale_dir = int(1 / ratio)

    with open(os.path.join(workdir, "camera", f"{ids[0]}.json")) as f:
        cam0 = json.load(f)
    W, H = [int(v * ratio) for v in cam0["image_size"]]
    focal = cam0["focal_length"] * ratio
    with open(os.path.join(out_sparse, "cameras.txt"), "w") as f:
        f.write(f"1 SIMPLE_PINHOLE {W} {H} {focal} {W/2} {H/2}\n")
    with open(os.path.join(out_sparse, "images.txt"), "w") as f:
        for i, img_id in enumerate(ids):
            with open(os.path.join(workdir, "camera", f"{img_id}.json")) as cf:
                cj = json.load(cf)
            orientation = np.asarray(cj["orientation"])
            position = np.asarray(cj["position"])
            # the w2c rotation is the orientation itself; t = −orientation @ position
            qvec = rotmat2qvec(orientation)
            T = -orientation @ position
            name = f"{img_id}.png"
            f.write(f"{i+1} " + " ".join(map(str, qvec)) + " "
                    + " ".join(map(str, T)) + f" 1 {name}\n\n")
            shutil.copy(os.path.join(workdir, "rgb", f"{scale_dir}x", name),
                        os.path.join(out_img, name))
    open(os.path.join(out_sparse, "points3D.txt"), "w").close()
    print(f"wrote COLMAP inputs → {out_sparse}")


if __name__ == "__main__":
    main(sys.argv[1])
