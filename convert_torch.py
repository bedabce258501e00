#!/usr/bin/env python3
"""Stock 3DGS conversion driver: COLMAP mapping + undistortion for captures.

The PyTorch + CUDA port's copy of ``convert.py``: the same COLMAP command
lines, so that a capture converted here loads in the port's COLMAP loader
(``fourdgs_tpu_torch/data/colmap.py``); it imports nothing of either
package.

Parity: convert.py in the reference (the original 3DGS script): runs
feature extraction, matching, mapping, and image undistortion over
<source>/input images, producing the sparse/0 + images layout the COLMAP
loader reads. Requires the `colmap` binary.

    python convert_torch.py -s <source> [--no_gpu] [--skip_matching]
"""

import argparse
import os
import shutil
import subprocess


def run(cmd):
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    args = p.parse_args(argv)
    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"

    if shutil.which("colmap") is None:
        raise SystemExit("colmap binary not found in PATH")

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run(["colmap", "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run(["colmap", "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run(["colmap", "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance", "0.000001"])
    run(["colmap", "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])
    # move sparse model into sparse/0 (3DGS layout)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    print("done")


if __name__ == "__main__":
    main()
