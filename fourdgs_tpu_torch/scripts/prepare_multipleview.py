"""Stage MultipleView frames for COLMAP mapping.

Counterpart of ``scripts/prepare_multipleview.py`` (the image-staging step
of the reference's ``multipleviewprogress.sh``): ``frame_00001.jpg`` of each
``cam##`` (else its first JPEG) is copied to ``image_colmap/frame####.jpg``
so that ``colmap mapper`` can register the static rig.

    python -m fourdgs_tpu_torch.scripts.prepare_multipleview <scene dir>
"""

from __future__ import annotations

import glob
import os
import shutil
import sys


def main(workdir: str) -> None:
    out = os.path.join(workdir, "image_colmap")
    os.makedirs(out, exist_ok=True)
    cams = sorted(glob.glob(os.path.join(workdir, "cam[0-9][0-9]")))
    for i, cam in enumerate(cams):
        src = os.path.join(cam, "frame_00001.jpg")
        if not os.path.exists(src):
            frames = sorted(glob.glob(os.path.join(cam, "*.jpg")))
            src = frames[0] if frames else None
        if src:
            shutil.copy(src, os.path.join(out, f"frame{i+1:04d}.jpg"))
    print(f"staged {len(cams)} first frames → {out}")


if __name__ == "__main__":
    main(sys.argv[1])
