"""Build ``poses_bounds_multipleview.npy`` from a COLMAP sparse model.

Counterpart of ``scripts/llff_poses_from_colmap.py`` (the pose-export step
of the reference's ``multipleviewprogress.sh``): the LLFF-format [N, 17]
rows (a 3×5 pose with its HWF column, then near and far bounds) that the
MultipleView loader's spiral video path reads.

    python -m fourdgs_tpu_torch.scripts.llff_poses_from_colmap <scene dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fourdgs_tpu_torch.data import colmap_io


def main(workdir: str) -> None:
    cams, imgs, pts = colmap_io.read_model(os.path.join(workdir, "sparse_", "0"))
    intr = cams[min(cams)]
    focal = intr.params[0]
    rows = []
    xyz = pts[0] if pts else np.zeros((0, 3))
    for key in sorted(imgs):
        im = imgs[key]
        R = colmap_io.qvec2rotmat(im.qvec)
        t = im.tvec
        c2w = np.eye(4)                     # w2c → c2w
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        # COLMAP (right, down, forward) → LLFF (down, right, back)
        m = np.concatenate([c2w[:3, 1:2], c2w[:3, 0:1], -c2w[:3, 2:3], c2w[:3, 3:4]],
                           axis=1)
        hwf = np.array([[intr.height], [intr.width], [focal]])
        pose = np.concatenate([m, hwf], axis=1)     # [3, 5]
        if len(xyz):
            z = (R @ xyz.T + t[:, None])[2]
            near, far = np.percentile(z, 0.5), np.percentile(z, 99.5)
        else:
            near, far = 0.1, 10.0
        rows.append(np.concatenate([pose.flatten(), [near, far]]))
    out = os.path.join(workdir, "poses_bounds_multipleview.npy")
    np.save(out, np.stack(rows))
    print(f"wrote {out} ({len(rows)} cameras)")


if __name__ == "__main__":
    main(sys.argv[1])
