"""Offline analysis of a training run's ``gradient_report.json``.

Counterpart of ``scripts/analyze_gradients.py`` (the reference's
``analyze_gradients.py``): per-group trends of the tracker's history (the
late over the early mean norm), vanishing and exploding groups, a table,
``gradient_analysis.json`` and, with ``--plot``, ``gradient_trends.png``
(matplotlib).

    python -m fourdgs_tpu_torch.scripts.analyze_gradients --model_path output/<expname>
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from fourdgs_tpu_torch.scripts import pyplot
from fourdgs_tpu_torch.utils.gradient_tracker import EXPLODE_THRESHOLD, VANISH_THRESHOLD


def analyze(report: dict) -> dict:
    history = report.get("history", {})
    iters = report.get("iterations", [])
    out = {"groups": {}, "vanishing": [], "exploding": [], "notes": []}
    for key, vals in sorted(history.items()):
        if not key.endswith("/norm") or not vals:
            continue
        group = key.split("/")[0]
        arr = np.asarray(vals, np.float64)
        n = len(arr)
        head = arr[: max(n // 5, 1)].mean()
        tail = arr[-max(n // 5, 1):].mean()
        trend = float(tail / head) if head > 0 else float("inf")
        g = {
            "first_norm": float(arr[0]),
            "last_norm": float(arr[-1]),
            "mean_norm": float(arr.mean()),
            "max_norm": float(arr.max()),
            "trend_late_over_early": round(trend, 4),
            "records": n,
        }
        if np.all(arr[-10:] < VANISH_THRESHOLD):
            out["vanishing"].append(group)
            g["status"] = "VANISHING"
        elif np.any(arr[-10:] > EXPLODE_THRESHOLD):
            out["exploding"].append(group)
            g["status"] = "EXPLODING"
        elif trend < 0.01:
            g["status"] = "decaying-fast"
        elif trend > 100:
            g["status"] = "growing-fast"
        else:
            g["status"] = "healthy"
        out["groups"][group] = g
    out["iterations_analyzed"] = len(iters)
    if not out["groups"]:
        out["notes"].append("no /norm histories found in the report")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--plot", action="store_true", help="also write gradient_trends.png")
    args = ap.parse_args(argv)

    path = os.path.join(args.model_path, "gradient_report.json")
    if not os.path.exists(path):
        print(f"no {path}; run train_torch.py --gradient_tracking first")
        return 1
    with open(path) as f:
        report = json.load(f)
    result = analyze(report)

    print(f"{'group':14s} {'first':>10s} {'last':>10s} {'trend':>8s} status")
    for group, g in result["groups"].items():
        print(f"{group:14s} {g['first_norm']:10.3e} {g['last_norm']:10.3e} "
              f"{g['trend_late_over_early']:8.3f} {g['status']}")
    if result["vanishing"]:
        print(f"!! vanishing gradients: {', '.join(result['vanishing'])}")
    if result["exploding"]:
        print(f"!! exploding gradients: {', '.join(result['exploding'])}")

    out_path = os.path.join(args.model_path, "gradient_analysis.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out_path}")

    if args.plot and result["groups"]:
        plt = pyplot("analyze_gradients")
        iters = report.get("iterations", [])
        fig, ax = plt.subplots(figsize=(10, 6))
        for key, vals in sorted(report["history"].items()):
            if key.endswith("/norm") and vals:
                ax.plot(iters[: len(vals)], vals, label=key.split("/")[0])
        ax.set_yscale("log")
        ax.axhline(VANISH_THRESHOLD, ls="--", c="gray", lw=0.8)
        ax.axhline(EXPLODE_THRESHOLD, ls="--", c="red", lw=0.8)
        ax.legend(fontsize=8)
        ax.set_xlabel("iteration")
        ax.set_ylabel("norm")
        fig.tight_layout()
        p = os.path.join(args.model_path, "gradient_trends.png")
        fig.savefig(p, dpi=100)
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
