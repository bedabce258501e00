#!/usr/bin/env bash
# Instant4D ablation smoke matrix on the PyTorch + CUDA port: 5 configs x
# 300 iterations of train_torch.py on the JAX package's dynerf debug
# presets, read by path, with the wall-clock and final point count of each
# (scripts/debug_test.sh's loop). Run from the repository's root.
#
#   fourdgs_tpu_torch/scripts/debug_test.sh <dataset_path> [output_root]
set -euo pipefail
DATA=${1:?usage: debug_test.sh <dataset_path> [output_root]}
OUT=${2:-output/debug_test}
PRESETS=fourdgs_tpu/configs/presets/dynerf
mkdir -p "$OUT"
SUMMARY="$OUT/summary.txt"
echo "config wall_s final_points" > "$SUMMARY"
for cfg in debug_baseline debug_pruning debug_isotropic debug_simplified debug_all; do
  echo "=== $cfg ==="
  t0=$(date +%s)
  python train_torch.py -s "$DATA" --configs "$PRESETS/$cfg.py" \
    --expname "debug_test/$cfg" --quiet \
    --test_iterations 300 --save_iterations 300 2>&1 | tail -5
  t1=$(date +%s)
  pts=$(python - <<PY
import json
logs = json.load(open("$OUT/$cfg/training_logs.json"))
print(logs[-1]["total_points"] if logs else "?")
PY
) || pts="?"
  echo "$cfg $((t1-t0)) $pts" >> "$SUMMARY"
done
column -t "$SUMMARY"
