"""Plot a training run's ``events.jsonl`` observability stream.

Counterpart of ``scripts/plot_events.py`` (the reference's tensorboard
views; the runs stream JSONL, ``utils/observability.py``, and this plots it
offline): ``<model_path>/plots/{scalars,histograms}.png``. Needs matplotlib.

    python -m fourdgs_tpu_torch.scripts.plot_events --model_path output/<expname>
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from fourdgs_tpu_torch.scripts import pyplot
from fourdgs_tpu_torch.utils.observability import read_events


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", "-m", required=True)
    args = ap.parse_args(argv)

    plt = pyplot("plot_events")
    events = read_events(args.model_path)
    if not events:
        print("no events.jsonl found")
        return
    out_dir = os.path.join(args.model_path, "plots")
    os.makedirs(out_dir, exist_ok=True)

    scalars = defaultdict(list)
    hists = defaultdict(list)
    for e in events:
        if "scalar" in e:
            scalars[e["tag"]].append((e["iter"], e["scalar"]))
        elif "hist" in e:
            hists[e["tag"]].append((e["iter"], e["hist"]))

    if scalars:
        n = len(scalars)
        cols = min(n, 3)
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows), squeeze=False)
        for ax, (tag, pts) in zip(axes.flat, sorted(scalars.items())):
            pts = sorted(pts)
            ax.plot([q[0] for q in pts], [q[1] for q in pts], lw=1.2)
            ax.set_title(tag, fontsize=8)
            ax.set_xlabel("iteration", fontsize=7)
            ax.grid(alpha=0.3)
        for ax in axes.flat[n:]:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "scalars.png"), dpi=110)
        plt.close(fig)
        print(f"wrote {out_dir}/scalars.png ({n} scalar tags)")

    if hists:
        n = len(hists)
        fig, axes = plt.subplots(n, 1, figsize=(7, 3 * n), squeeze=False)
        for ax, (tag, series) in zip(axes.flat, sorted(hists.items())):
            series = sorted(series, key=lambda q: q[0])
            # the histogram's evolution as a waterfall: a filled curve a record
            cmap = plt.get_cmap("viridis")
            for k, (it, h) in enumerate(series):
                edges = np.asarray(h["edges"])
                centers = (edges[:-1] + edges[1:]) / 2
                counts = np.asarray(h["counts"], float)
                if counts.max() > 0:
                    counts = counts / counts.max()
                ax.fill_between(centers, counts, alpha=0.35,
                                color=cmap(k / max(len(series) - 1, 1)),
                                label=f"iter {it}" if len(series) <= 6 else None)
            ax.set_title(tag, fontsize=9)
            if len(series) <= 6:
                ax.legend(fontsize=7)
            ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "histograms.png"), dpi=110)
        plt.close(fig)
        print(f"wrote {out_dir}/histograms.png ({n} histogram tags)")


if __name__ == "__main__":
    main()
