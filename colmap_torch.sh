#!/usr/bin/env bash
# COLMAP sparse+dense reconstruction for a captured scene, with the
# PyTorch + CUDA port's preprocessing scripts: colmap.sh's COLMAP command
# lines, its python steps run as `python -m fourdgs_tpu_torch.scripts.<name>`
# (feature_extractor -> matcher -> point_triangulator -> image_undistorter ->
# patch_match_stereo -> stereo_fusion producing
# <workdir>/colmap/dense/workspace/fused.ply). Run from the repository's root.
#
#   ./colmap_torch.sh <workdir> <llff|hypernerf|blender>
set -euo pipefail
workdir=${1:?usage: colmap_torch.sh <workdir> <datatype>}
datatype=${2:?usage: colmap_torch.sh <workdir> <datatype>}
command -v colmap >/dev/null || { echo "colmap binary not found in PATH"; exit 1; }
python -m fourdgs_tpu_torch.scripts."${datatype}"2colmap "$workdir"
rm -rf "$workdir/colmap/sparse/0"
colmap feature_extractor --database_path "$workdir/colmap/database.db" --image_path "$workdir/colmap/images"
python -m fourdgs_tpu_torch.scripts.database --database_path "$workdir/colmap/database.db" --txt_path "$workdir/colmap/sparse_custom/cameras.txt"
colmap exhaustive_matcher --database_path "$workdir/colmap/database.db"
mkdir -p "$workdir/colmap/sparse/0"
colmap point_triangulator \
  --database_path "$workdir/colmap/database.db" \
  --image_path "$workdir/colmap/images" \
  --input_path "$workdir/colmap/sparse_custom" \
  --output_path "$workdir/colmap/sparse/0" \
  --clear_points 1
mkdir -p "$workdir/colmap/dense/workspace"
colmap image_undistorter --image_path "$workdir/colmap/images" \
  --input_path "$workdir/colmap/sparse/0" --output_path "$workdir/colmap/dense/workspace"
colmap patch_match_stereo --workspace_path "$workdir/colmap/dense/workspace"
colmap stereo_fusion --workspace_path "$workdir/colmap/dense/workspace" \
  --output_path "$workdir/colmap/dense/workspace/fused.ply"
