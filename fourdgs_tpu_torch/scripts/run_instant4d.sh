#!/usr/bin/env bash
# Full Instant4D ablation harness on the PyTorch + CUDA port: per config
# train (14k) -> render -> metrics with train_torch.py, render_torch.py and
# metrics_torch.py on the JAX package's dynerf presets, read by path
# (scripts/run_instant4d.sh's loop). Run from the repository's root.
#
#   fourdgs_tpu_torch/scripts/run_instant4d.sh <dataset_path> [output_root]
set -euo pipefail
DATA=${1:?usage: run_instant4d.sh <dataset_path> [output_root]}
OUT=${2:-output/instant4d}
PRESETS=fourdgs_tpu/configs/presets/dynerf
for cfg in sear_steak sear_steak_pruning sear_steak_isotropic sear_steak_simplified sear_steak_all; do
  echo "=== $cfg ==="
  exp="instant4d/$cfg"
  t0=$(date +%s)
  python train_torch.py -s "$DATA" --configs "$PRESETS/$cfg.py" --expname "$exp" --quiet
  echo "$cfg train wall: $(( $(date +%s) - t0 ))s"
  python render_torch.py --model_path "output/$exp" --source_path "$DATA" --skip_video
  python metrics_torch.py --model_path "output/$exp"
done
python - <<'PY'
import glob, json, os
print(f"{'config':28s} {'PSNR':>7s} {'SSIM':>7s} {'MS-SSIM':>8s}")
for p in sorted(glob.glob("output/instant4d/*/results.json")):
    r = json.load(open(p))
    for method, vals in r.items():
        name = os.path.basename(os.path.dirname(p))
        print(f"{name:28s} {vals['PSNR']:7.3f} {vals['SSIM']:7.4f} {vals['MS-SSIM']:8.4f}")
PY
