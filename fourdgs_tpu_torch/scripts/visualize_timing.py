"""Plot a training run's ``timing_report.json``.

Counterpart of ``scripts/visualize_timing.py`` (the reference's
``visualize_timing.py`` suite): iteration-time curves, the per-stage
comparison, the operation breakdown, operation trends and a phase ×
iteration heatmap, over the ``DetailedTimer`` JSON schema
(``utils/timer.py``), and a text summary. Needs matplotlib, which it
imports in :func:`main`; each plot function takes its ``plt``.

    python -m fourdgs_tpu_torch.scripts.visualize_timing output/<expname>/timing_report.json
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from fourdgs_tpu_torch.scripts import pyplot


def plot_iteration_curve(plt, iters: list[dict], out: str):
    fig, ax = plt.subplots(figsize=(10, 4))
    by_stage = defaultdict(list)
    for it in iters:
        by_stage[it["stage"]].append((it["iteration"], it["total_time"]))
    for stage, pts in by_stage.items():
        xs, ys = zip(*pts)
        ax.plot(xs, np.asarray(ys) * 1000, label=stage, lw=0.7)
    ax.set_xlabel("iteration")
    ax.set_ylabel("iteration time (ms)")
    ax.set_yscale("log")
    ax.legend()
    ax.set_title("per-iteration wall time")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def plot_operation_breakdown(plt, summary: dict, out: str):
    ops = summary.get("operations", {})
    if not ops:
        return
    names = sorted(ops, key=lambda k: -ops[k]["total_time"])[:14]
    totals = [ops[n]["total_time"] for n in names]
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.barh(names[::-1], totals[::-1])
    ax.set_xlabel("total seconds")
    ax.set_title(
        f"operation breakdown (wall {summary['total_wall_time']:.1f}s, "
        f"unaccounted {summary['unaccounted_time']:.1f}s)"
    )
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def plot_iteration_curve_broken_axis(plt, iters: list[dict], out: str,
                                     pct: float = 99.0):
    """Linear-scale curve with a broken y-axis isolating compile/IO spikes
    (the reference's _plot_iteration_timing_curve_broken_axis)."""
    if not iters:
        return
    times = np.asarray([it["total_time"] for it in iters]) * 1000
    xs = np.asarray([it["iteration"] for it in iters])
    cut = np.percentile(times, pct)
    hi = times[times > cut * 1.5]
    if hi.size == 0:
        # no outliers — a single linear panel
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(xs, times, lw=0.7)
        ax.set_xlabel("iteration"); ax.set_ylabel("ms")
        ax.set_title("per-iteration wall time (linear)")
        fig.tight_layout(); fig.savefig(out, dpi=110); plt.close(fig)
        return
    fig, (ax_top, ax_bot) = plt.subplots(
        2, 1, sharex=True, figsize=(10, 5),
        gridspec_kw={"height_ratios": [1, 3], "hspace": 0.08},
    )
    for ax in (ax_top, ax_bot):
        ax.plot(xs, times, lw=0.7)
    ax_bot.set_ylim(0, cut * 1.2)
    ax_top.set_ylim(hi.min() * 0.9, times.max() * 1.05)
    ax_top.spines.bottom.set_visible(False)
    ax_bot.spines.top.set_visible(False)
    ax_top.tick_params(bottom=False, labelbottom=False)
    ax_bot.set_xlabel("iteration"); ax_bot.set_ylabel("ms")
    ax_top.set_title(
        f"per-iteration wall time (broken axis, {len(hi)} spikes "
        f"above {cut*1.5:.0f} ms)"
    )
    fig.savefig(out, dpi=110)
    plt.close(fig)


def plot_stage_comparison(plt, iters: list[dict], out: str):
    """Mean per-phase ms for coarse vs fine side by side
    (plot_stage_time_comparison, visualize_timing.py:443-493)."""
    if not iters:
        return
    stages = sorted({it["stage"] for it in iters})
    phases = sorted({p for it in iters for p in it["phases"]})
    # strip the stage prefix for shared labels ("coarse_render" → "render")
    short = sorted({p.split("_", 1)[-1] for p in phases})
    means = np.zeros((len(stages), len(short)))
    for si, st in enumerate(stages):
        rows = [it for it in iters if it["stage"] == st]
        for pi, ph in enumerate(short):
            vals = [
                v * 1000
                for it in rows
                for p, v in it["phases"].items()
                if p.split("_", 1)[-1] == ph
            ]
            means[si, pi] = np.mean(vals) if vals else 0.0
    x = np.arange(len(short))
    width = 0.8 / max(len(stages), 1)
    fig, ax = plt.subplots(figsize=(10, 4.5))
    for si, st in enumerate(stages):
        ax.bar(x + si * width, means[si], width, label=st)
    ax.set_xticks(x + width * (len(stages) - 1) / 2, short,
                  rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("mean ms / iteration")
    ax.legend()
    ax.set_title("stage time comparison")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def plot_operation_trends(plt, iters: list[dict], out: str, window: int = 50):
    """Rolling-mean per-phase time over iterations
    (plot_operation_trends, visualize_timing.py:577-669)."""
    if not iters:
        return
    phases = sorted({p for it in iters for p in it["phases"]})
    fig, ax = plt.subplots(figsize=(10, 5))
    for ph in phases:
        xs, ys = [], []
        for it in iters:
            if ph in it["phases"]:
                xs.append(it["iteration"])
                ys.append(it["phases"][ph] * 1000)
        if len(ys) < 2:
            continue
        ys = np.asarray(ys)
        w = min(window, len(ys))
        smooth = np.convolve(ys, np.ones(w) / w, mode="valid")
        ax.plot(xs[w - 1:], smooth, label=ph, lw=0.9)
    ax.set_xlabel("iteration")
    ax.set_ylabel("ms (rolling mean)")
    ax.set_yscale("log")
    ax.legend(fontsize=7, ncol=2)
    ax.set_title("operation trends")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def write_summary_report(data: dict, out: str):
    """Text summary with percentage accounting
    (generate_summary_report, visualize_timing.py:749-790)."""
    summary = data.get("summary", {})
    iters = data.get("iterations", [])
    lines = ["=== timing summary ===", ""]
    wall = summary.get("total_wall_time", 0.0)
    lines.append(f"total wall time: {wall:.1f}s over {len(iters)} iterations")
    if iters:
        times = np.asarray([it["total_time"] for it in iters]) * 1000
        lines.append(
            f"iteration time: mean {times.mean():.1f} ms, median "
            f"{np.median(times):.1f} ms, p99 {np.percentile(times, 99):.1f} "
            f"ms, max {times.max():.1f} ms"
        )
    ops = summary.get("operations", {})
    if ops and wall > 0:
        lines.append("")
        lines.append(f"{'operation':28s} {'total s':>9s} {'% wall':>7s} "
                     f"{'calls':>7s} {'ms/call':>9s}")
        for name in sorted(ops, key=lambda k: -ops[k]["total_time"]):
            o = ops[name]
            calls = o.get("count", 0) or 1
            lines.append(
                f"{name:28s} {o['total_time']:9.2f} "
                f"{100 * o['total_time'] / wall:6.1f}% {calls:7d} "
                f"{1000 * o['total_time'] / calls:9.2f}"
            )
        un = summary.get("unaccounted_time", 0.0)
        lines.append(f"{'(unaccounted)':28s} {un:9.2f} "
                     f"{100 * un / wall:6.1f}%")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")


def plot_phase_heatmap(plt, iters: list[dict], out: str, max_cols: int = 400):
    if not iters:
        return
    phases = sorted({p for it in iters for p in it["phases"]})
    stride = max(len(iters) // max_cols, 1)
    sampled = iters[::stride]
    mat = np.zeros((len(phases), len(sampled)))
    for j, it in enumerate(sampled):
        for i, p in enumerate(phases):
            mat[i, j] = it["phases"].get(p, 0.0) * 1000
    fig, ax = plt.subplots(figsize=(11, 4))
    im = ax.imshow(mat, aspect="auto", cmap="magma")
    ax.set_yticks(range(len(phases)), phases, fontsize=7)
    ax.set_xlabel(f"iteration (x{stride})")
    fig.colorbar(im, label="ms")
    ax.set_title("phase time heatmap")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("report", help="path to timing_report.json")
    parser.add_argument("--out_dir", default=None)
    args = parser.parse_args(argv)

    plt = pyplot("visualize_timing")
    with open(args.report) as f:
        data = json.load(f)
    out_dir = args.out_dir or os.path.join(
        os.path.dirname(args.report) or ".", "timing_plots"
    )
    os.makedirs(out_dir, exist_ok=True)
    plot_iteration_curve(
        plt, data.get("iterations", []), os.path.join(out_dir, "iteration_times.png")
    )
    plot_operation_breakdown(
        plt, data.get("summary", {}), os.path.join(out_dir, "operation_breakdown.png")
    )
    plot_phase_heatmap(
        plt, data.get("iterations", []), os.path.join(out_dir, "phase_heatmap.png")
    )
    plot_iteration_curve_broken_axis(
        plt, data.get("iterations", []),
        os.path.join(out_dir, "iteration_times_broken.png"),
    )
    plot_stage_comparison(
        plt, data.get("iterations", []),
        os.path.join(out_dir, "stage_comparison.png"),
    )
    plot_operation_trends(
        plt, data.get("iterations", []),
        os.path.join(out_dir, "operation_trends.png"),
    )
    write_summary_report(data, os.path.join(out_dir, "timing_analysis.txt"))
    print(f"plots → {out_dir}")


if __name__ == "__main__":
    main()
