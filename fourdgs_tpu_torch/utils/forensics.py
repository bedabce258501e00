"""Trainer-state forensics: a replayable snapshot written on a NaN loss.

Counterpart of ``fourdgs_tpu/utils/forensics.py:42-83``, in the same npz
format: flat ``group.leaf`` keys, ``params.*`` in the JAX parameter layout
(the deformation's leaves named by ``interop``'s JAX paths, e.g.
``params.deform.feature_out.0.w`` with the weight [in, out]), ``state.*``,
``cams.*``, ``metrics.*`` and ``extra.*``, so one replay tool reads the
dumps of both packages. Load with ``np.load(path, allow_pickle=False)``.

Unlike the JAX function this one does not swallow its own errors: the
caller raises the original failure after it, and a failed dump surfaces as
its own exception.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.models.gaussians import PRIMITIVE_KEYS

STATE_FIELDS = ("alive", "max_radii2d", "xyz_gradient_accum", "denom",
                "deformation_accum", "aabb")


def _flatten(prefix: str, tree: Any, out: dict) -> None:
    """A tree of dicts, lists and arrays → '{prefix}.{path}' numpy entries."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}.{i}", v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def dump_snapshot(model_path: str, tag: str, params: dict, state=None,
                  cams=None, metrics: dict | None = None,
                  extra: dict | None = None) -> str:
    """Write ``snapshot_<tag>_<unix time>.npz`` under ``model_path`` (or the
    working directory) and return its path. ``params`` is the port's
    parameter dict, ``state`` a ``GaussianState``, ``cams`` a
    ``CameraArrays`` (any leading batch dimension)."""
    out: dict[str, np.ndarray] = {}
    tree = {k: params[k] for k in PRIMITIVE_KEYS}
    tree["deform"] = interop.deform_to_tree(params["deform"])
    _flatten("params", tree, out)
    if state is not None:
        for field in STATE_FIELDS:
            _flatten(f"state.{field}", getattr(state, field), out)
    if cams is not None:
        _flatten("cams", cams._asdict(), out)
    for group, values in (("metrics", metrics), ("extra", extra)):
        for k, v in (values or {}).items():
            _flatten(f"{group}.{k}", v, out)
    d = model_path or "."
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"snapshot_{tag}_{int(time.time())}.npz")
    np.savez_compressed(path, **out)
    return path
