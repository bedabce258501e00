"""Tensorboard-class observability: scalars, histograms, image dumps.

Counterpart of ``fourdgs_tpu/utils/observability.py``: ``EventLog`` is a
copy that writes its PNGs with the port's codec (``utils/png.py``), and
``log_scene_stats`` reads the port's state. Parity target: the reference's
training_report (train.py:488-538) logs per-iteration scalars (l1/total
loss), eval scalars (per-split l1/psnr), the first 5 eval renders + ground
truths as images, an opacity histogram, total_points, deformation_rate
(_deformation_table.sum()/P) and a motion histogram
(_deformation_accum.mean(-1)/100).

A dependency-free event stream:
  - scalars + histograms to <model_path>/events.jsonl (one JSON per record:
    {"iter", "tag", "scalar"|"hist"}; histograms stored as counts + edges)
  - eval renders/gt as PNGs under <model_path>/eval_images/
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fourdgs_tpu_torch.utils import png


class EventLog:
    """Append-only JSONL scalar/histogram stream + PNG image dumps."""

    def __init__(self, model_path: str):
        self.model_path = model_path
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, "events.jsonl")
        self._f = open(self.path, "a")

    def add_scalar(self, tag: str, value, iteration: int):
        self._f.write(json.dumps(
            {"iter": int(iteration), "tag": tag, "scalar": float(value)}
        ) + "\n")
        self._f.flush()

    def add_histogram(self, tag: str, values, iteration: int, bins: int = 64):
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        counts, edges = np.histogram(v, bins=bins)
        self._f.write(json.dumps({
            "iter": int(iteration), "tag": tag,
            "hist": {"counts": counts.tolist(),
                     "edges": np.round(edges, 6).tolist(),
                     "mean": float(v.mean()), "min": float(v.min()),
                     "max": float(v.max())},
        }) + "\n")
        self._f.flush()

    def add_image(self, tag: str, img_chw, iteration: int):
        """Save an eval render/gt panel (train.py:513-516 add_images)."""
        out_dir = os.path.join(self.model_path, "eval_images")
        os.makedirs(out_dir, exist_ok=True)
        img = np.clip(np.asarray(img_chw), 0.0, 1.0)
        u8 = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
        safe = tag.replace("/", "_")
        png.write_png(os.path.join(out_dir, f"{safe}_{iteration:06d}.png"), u8)

    def close(self):
        self._f.close()


def log_scene_stats(ev: EventLog, state, stage: str, iteration: int):
    """The reference's scene histograms/scalars block (train.py:532-536)."""
    alive = state.alive.cpu().numpy().astype(bool)
    opacity = torch.sigmoid(state.params["opacity"][:, 0].detach()).cpu().numpy()
    ev.add_histogram(f"{stage}/scene/opacity_histogram", opacity[alive], iteration)
    n = max(int(alive.sum()), 1)
    ev.add_scalar(f"{stage}/total_points", n, iteration)
    ev.add_scalar(
        f"{stage}/deformation_rate",
        float(state.deformation_table.cpu().numpy().astype(np.float64)[alive].sum())
        / n,
        iteration,
    )
    motion = state.deformation_accum.cpu().numpy().astype(np.float64)
    if motion.ndim > 1:
        motion = motion.mean(axis=-1)
    ev.add_histogram(
        f"{stage}/scene/motion_histogram", motion[alive] / 100.0, iteration,
        bins=500,
    )


def read_events(model_path: str) -> list[dict]:
    path = os.path.join(model_path, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
