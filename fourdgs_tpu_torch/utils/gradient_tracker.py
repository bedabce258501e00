"""Gradient tracking and its reports (``--gradient_tracking``).

A copy of ``fourdgs_tpu/utils/gradient_tracker.py`` (the reference fork's
GradientTracker, utils/gradient_tracker.py:33-900, and
analyze_gradients.py): per-group gradient statistics (mean, std, min, max,
norm, with the deformation MLP and the grid apart) recorded every N
iterations, vanishing and exploding detection, an end-of-run JSON report,
norm curves, 3-D |∇xyz| snapshots, and a per-timestamp gradient timeline.

As in JAX, the statistics are reductions on the device inside the train
step (``train/loop.py::make_train_step(track_grads=True)`` attaches
``grad_stats`` to the step's metrics); the host reads them only on a
recorded iteration. The JSON files are JAX's, key for key, so
``scripts/analyze_gradients.py`` reads the port's reports.

**Plots.** JAX draws the PNGs with matplotlib, imported when a plot is
drawn. The port imports it the same way; where matplotlib is not installed,
a plot prints one line naming the PNG it did not write and returns None.
The JSON files are written either way. This concerns a host plotting
library only: no device work or kernel has another path.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
          "deformation", "grid")

VANISH_THRESHOLD = 1e-7
EXPLODE_THRESHOLD = 1e2


def compute_grad_stats(grads: dict) -> dict:
    """Per-group gradient statistics of the port's gradient tree
    (``{primitive: tensor, "deform": {parameter name: tensor}}``, as
    ``train/adam.py::tree_like`` builds it): ``{group: {mean, std, min, max,
    norm}}`` of 0-d tensors on the gradients' device, without a host sync.
    The ``deform`` leaves split by JAX's grid-in-key rule (reference
    deformation.py:149-160) on their top-level name: ``grids.*`` is the
    grid, the rest the deformation MLP."""

    def stats_of(leaves):
        flat = torch.cat([x.reshape(-1) for x in leaves])
        return {"mean": flat.mean(), "std": flat.std(correction=0), "min": flat.min(),
                "max": flat.max(), "norm": torch.linalg.vector_norm(flat)}

    out = {}
    for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        if grads[k].numel() > 0:   # f_rest is empty when sh_degree == 0
            out[k] = stats_of([grads[k]])
    mlp_leaves, grid_leaves = [], []
    for name, g in grads.get("deform", {}).items():
        (grid_leaves if "grid" in name.split(".")[0] else mlp_leaves).append(g)
    if mlp_leaves:
        out["deformation"] = stats_of(mlp_leaves)
    if grid_leaves:
        out["grid"] = stats_of(grid_leaves)
    return out


def _pyplot(png_path: str):
    """matplotlib's pyplot on the Agg backend, or None (with one line naming
    ``png_path``) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"[gradient_tracker] matplotlib is not installed: {png_path} not written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class GradientTracker:
    """Host-side history and reports over the step's statistics."""

    def __init__(self, model_path: str | None = None, enable: bool = True,
                 record_interval: int = 10):
        self.model_path = model_path
        self.enable = enable
        self.record_interval = record_interval
        self.history: dict[str, list] = defaultdict(list)
        self.iterations: list[int] = []
        self.stages: list[str] = []

    def record(self, iteration: int, stage: str, grad_stats: dict):
        """Record one step's statistics (``{group: {stat: scalar}}``)."""
        if not self.enable:
            return
        self.iterations.append(iteration)
        self.stages.append(stage)
        for group, stats in grad_stats.items():
            for stat, v in stats.items():
                self.history[f"{group}/{stat}"].append(float(v))

    def detect_anomalies(self) -> dict:
        """Vanishing and exploding groups over the last 10 records
        (reference analyze_gradients.py)."""
        out = {"vanishing": [], "exploding": []}
        for key, vals in self.history.items():
            if not key.endswith("/norm") or not vals:
                continue
            group = key.split("/")[0]
            recent = np.asarray(vals[-10:])
            if np.all(recent < VANISH_THRESHOLD):
                out["vanishing"].append(group)
            if np.any(recent > EXPLODE_THRESHOLD):
                out["exploding"].append(group)
        return out

    def generate_report(self, path: str | None = None) -> str:
        """Write ``gradient_report.json`` (JAX's keys); returns its path."""
        path = path or os.path.join(self.model_path or ".", "gradient_report.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        summary = {}
        for key, vals in self.history.items():
            if vals:
                arr = np.asarray(vals)
                summary[key] = {"last": float(arr[-1]), "mean": float(arr.mean()),
                                "max": float(arr.max()), "min": float(arr.min())}
        with open(path, "w") as f:
            json.dump({"iterations": self.iterations, "stages": self.stages,
                       "history": dict(self.history), "summary": summary,
                       "anomalies": self.detect_anomalies()}, f, indent=1)
        return path

    def visualize_gradient_curves(self, path: str | None = None):
        """Per-group norm curves as ``gradient_curves.png``; returns its
        path, or None without records or without matplotlib."""
        if not self.iterations:
            return None
        path = path or os.path.join(self.model_path or ".", "gradient_curves.png")
        plt = _pyplot(path)
        if plt is None:
            return None
        fig, ax = plt.subplots(figsize=(10, 6))
        for key, vals in sorted(self.history.items()):
            if key.endswith("/norm") and vals:
                ax.plot(self.iterations[: len(vals)], vals, label=key.split("/")[0])
        ax.set_yscale("log")
        ax.set_xlabel("iteration")
        ax.set_ylabel("gradient norm")
        ax.legend(fontsize=8)
        ax.set_title("per-group gradient norms")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def visualize_gradient_3d(self, xyz: np.ndarray, grad_norm: np.ndarray,
                              iteration: int, stage: str = "", max_points: int = 2000,
                              path: str | None = None):
        """A 3-D |∇xyz| scatter snapshot; returns its path, or None without
        matplotlib."""
        path = path or os.path.join(self.model_path or ".",
                                    f"gradient_3d_{stage}_{iteration}.png")
        plt = _pyplot(path)
        if plt is None:
            return None
        n = xyz.shape[0]
        if n > max_points:
            sel = np.random.default_rng(0).choice(n, max_points, replace=False)
            xyz, grad_norm = xyz[sel], grad_norm[sel]
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        sc = ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                        c=np.log10(grad_norm + 1e-12), s=2, cmap="viridis")
        fig.colorbar(sc, label="log10 |∇xyz|")
        ax.set_title(f"xyz gradient magnitude @ {stage} {iteration}")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path


def gradient_timeline(cfg, state, camera, gt_chw, model_path: str, time_points=None,
                      max_points: int = 2000, stage: str = "fine", device="cuda"):
    """The per-timestamp gradient timeline (gradient_tracker.py:817-900):
    at each of 10 times, the port's render of ``camera`` (K1 on the card),
    the L1 loss against ``gt_chw`` and its gradient by autograd (K2), and
    the deformed xyz. Writes ``gradient_timeline.json`` (JAX's records) and
    a panel grid ``gradient_timeline.png``; returns their paths (the PNG's
    None without matplotlib)."""
    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.render import CameraArrays, render
    from fourdgs_tpu_torch.utils import losses

    dev = resolve_device(device)
    if time_points is None:
        time_points = [i * 0.1 for i in range(10)]
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    gt = torch.tensor(np.asarray(gt_chw, np.float32)[:3], device=dev)
    h, w = gt.shape[-2:]
    sh_deg = int(state.active_sh_degree)
    cam0 = CameraArrays.from_camera(camera, device=dev)
    alive = state.alive.cpu().numpy().astype(bool)
    params = state.params

    records, panels = [], []
    for t in time_points:
        cam_t = cam0._replace(time=torch.tensor(np.float32(t), device=dev))
        xyz = params["xyz"].detach().requires_grad_()
        with torch.enable_grad():
            out = render(dict(params, xyz=xyz), state, cam_t, cfg, w, h, stage, bg,
                         sh_deg, device=dev)
            loss = losses.l1_loss(out.color, gt)
            (g_xyz,) = torch.autograd.grad(loss, [xyz])
        gnorm = torch.linalg.vector_norm(g_xyz, dim=-1).cpu().numpy()[alive]
        with torch.no_grad():
            tt = torch.full((xyz.shape[0],), np.float32(t), device=dev)
            xyz_t = params["deform"](state.aabb, params["xyz"], params["scaling"],
                                     params["rotation"], params["opacity"],
                                     G.get_features(params), tt)[0]
        xyz_t = xyz_t.cpu().numpy()[alive]
        records.append({"t": float(t), "loss": float(loss.detach()),
                        "grad_norm_mean": float(gnorm.mean()),
                        "grad_norm_max": float(gnorm.max()),
                        "n_points": int(alive.sum())})
        panels.append((float(t), xyz_t, gnorm))

    os.makedirs(model_path, exist_ok=True)
    json_path = os.path.join(model_path, "gradient_timeline.json")
    with open(json_path, "w") as f:
        json.dump(records, f, indent=1)

    png_path = os.path.join(model_path, "gradient_timeline.png")
    plt = _pyplot(png_path)
    if plt is None:
        return json_path, None
    n = len(panels)
    cols = min(n, 5)
    rows = -(-n // cols)
    fig = plt.figure(figsize=(3.2 * cols, 3.2 * rows))
    rng = np.random.default_rng(0)
    for i, (t, xyz_t, gnorm) in enumerate(panels):
        if len(xyz_t) > max_points:
            sel = rng.choice(len(xyz_t), max_points, replace=False)
            xyz_t, gnorm = xyz_t[sel], gnorm[sel]
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        sc = ax.scatter(xyz_t[:, 0], xyz_t[:, 1], xyz_t[:, 2],
                        c=np.log10(gnorm + 1e-12), s=1.5, cmap="viridis")
        ax.set_title(f"t={t:.1f}", fontsize=8)
        ax.tick_params(labelsize=5)
    fig.colorbar(sc, ax=fig.axes, shrink=0.5, label="log10 |∇xyz|")
    fig.savefig(png_path, dpi=100)
    plt.close(fig)
    return json_path, png_path
