"""Write known camera intrinsics into a COLMAP sqlite database.

Counterpart of ``scripts/database.py`` (the reference's ``database.py``):
after ``colmap feature_extractor`` has created ``database.db``, the camera
rows are overwritten with the intrinsics of ``sparse_custom/cameras.txt`` so
that the triangulation uses the calibrated values.

    python -m fourdgs_tpu_torch.scripts.database --database_path db --txt_path cameras.txt
"""

from __future__ import annotations

import argparse
import sqlite3

import numpy as np

MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
             "RADIAL": 3, "OPENCV": 4}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--database_path", required=True)
    parser.add_argument("--txt_path", required=True)
    args = parser.parse_args(argv)

    cameras = []
    with open(args.txt_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cameras.append((int(tok[0]), MODEL_IDS[tok[1]], int(tok[2]), int(tok[3]),
                            np.asarray(list(map(float, tok[4:])), np.float64)))

    db = sqlite3.connect(args.database_path)
    try:
        for cid, model, w, h, params in cameras:
            db.execute(
                "UPDATE cameras SET model=?, width=?, height=?, params=?, "
                "prior_focal_length=1 WHERE camera_id=?",
                (model, w, h, params.tobytes(), cid),
            )
        db.commit()
        print(f"updated {len(cameras)} cameras in {args.database_path}")
    finally:
        db.close()


if __name__ == "__main__":
    main()
