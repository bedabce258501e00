#!/usr/bin/env bash
# Build sparse poses + LLFF pose bounds for a MultipleView capture, with the
# PyTorch + CUDA port's preprocessing scripts: multipleviewprogress.sh's
# COLMAP command lines, its python steps run as
# `python -m fourdgs_tpu_torch.scripts.<name>` (feature_extractor -> matcher
# -> mapper -> model converter -> LLFF poses). Run from the repository's root.
#
#   ./multipleviewprogress_torch.sh <workdir>   # expects <workdir>/cam01..camNN
set -euo pipefail
workdir=${1:?usage: multipleviewprogress_torch.sh <workdir>}
command -v colmap >/dev/null || { echo "colmap binary not found in PATH"; exit 1; }
mkdir -p "$workdir/image_colmap" "$workdir/sparse_"
python -m fourdgs_tpu_torch.scripts.prepare_multipleview "$workdir"
colmap feature_extractor --database_path "$workdir/database.db" --image_path "$workdir/image_colmap"
colmap exhaustive_matcher --database_path "$workdir/database.db"
colmap mapper --database_path "$workdir/database.db" --image_path "$workdir/image_colmap" --output_path "$workdir/sparse_"
colmap model_converter --input_path "$workdir/sparse_/0" --output_path "$workdir/sparse_/0" --output_type TXT
python -m fourdgs_tpu_torch.scripts.llff_poses_from_colmap "$workdir"
