"""Training checkpoints and model snapshots.

Counterpart of ``fourdgs_tpu/train/checkpoint.py``. Two formats:

1. **Training checkpoint** (``save_checkpoint``/``load_checkpoint``/
   ``find_stage_checkpoint``, ``checkpoint.py:41-88``): the whole
   :class:`GaussianState`, :class:`AdamState` and the iteration, under JAX's
   ``chkpnt_<stage>_<iter>`` name, so a resume is exact (Adam moments,
   ``alive``, the densification statistics, the SH degree). JAX writes it
   with orbax; the port, which has no orbax, writes one
   ``chkpnt_<stage>_<iter>/checkpoint.npz`` whose keys name the leaves:
   ``state.params.<primitive>``, ``state.params.deform.<parameter name>``,
   ``state.<field>``, ``adam.mu.…``, ``adam.nu.…``, ``adam.count``,
   ``iteration``. ``interop`` maps the deformation's parameter names to the
   JAX tree.
2. **Model snapshot for rendering** (``save_snapshot``/``load_snapshot``,
   ``checkpoint.py:90-174``), in the JAX package's format. A snapshot directory
``point_cloud/[coarse_]iteration_<k>/`` holds

- ``point_cloud.ply``: the alive primitives, 3DGS-standard PLY;
- ``deformation.npz``: ``aabb`` and the deformation leaves ``leaf_{i}`` in
  ``jax.tree.flatten`` order of the JAX ``deform`` tree (dict keys sorted,
  lists in order, each Linear ``b`` before ``w``, weights [in, out]);
- ``deformation_table.npy`` and ``deformation_accum.npy`` of the alive rows.

Snapshots written by either package load in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.data import ply as ply_lib
from fourdgs_tpu_torch.interop import (
    deform_to_tree, flatten_tree, load_deform_tree, unflatten_like)
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.train.adam import AdamState

# GaussianState's per-primitive fields and the AABB, in field order
_STATE_ARRAYS = ("alive", "max_radii2d", "xyz_gradient_accum", "denom",
                 "deformation_accum", "deformation_table", "aabb")
CHECKPOINT_FILE = "checkpoint.npz"


def _tree_arrays(prefix: str, tree) -> dict[str, np.ndarray]:
    """A params-shaped tree (primitives and ``deform``, a module or a dict
    of tensors by parameter name) as flat ``prefix.<name>`` arrays."""
    deform = tree["deform"]
    named = (deform.named_parameters() if isinstance(deform, torch.nn.Module)
             else deform.items())
    out = {f"{prefix}.{k}": tree[k].detach().cpu().numpy() for k in G.PRIMITIVE_KEYS}
    out.update({f"{prefix}.deform.{n}": x.detach().cpu().numpy() for n, x in named})
    return out


def save_checkpoint(path: str, state: G.GaussianState, adam_state: AdamState,
                    iteration: int, stage: str) -> str:
    """Write ``chkpnt_<stage>_<iteration>`` under ``path`` (train.py:393-395
    naming); returns its directory. The file is written under a temporary
    name and then renamed, so a checkpoint that exists is whole."""
    out = os.path.abspath(os.path.join(path, f"chkpnt_{stage}_{iteration}"))
    os.makedirs(out, exist_ok=True)
    arrays = _tree_arrays("state.params", state.params)
    arrays.update({f"state.{f}": getattr(state, f).cpu().numpy() for f in _STATE_ARRAYS})
    arrays["state.active_sh_degree"] = np.int64(state.active_sh_degree)
    arrays["state.spatial_lr_scale"] = np.float64(state.spatial_lr_scale)
    arrays.update(_tree_arrays("adam.mu", adam_state.mu))
    arrays.update(_tree_arrays("adam.nu", adam_state.nu))
    arrays["adam.count"] = np.int64(adam_state.count)
    arrays["iteration"] = np.int64(iteration)
    tmp = os.path.join(out, CHECKPOINT_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(out, CHECKPOINT_FILE))
    return out


def load_checkpoint(path: str, cfg, device="cuda") -> tuple[G.GaussianState, AdamState, int]:
    """Restore ``(state, adam_state, iteration)`` from a checkpoint directory
    onto ``device``. The deformation is built from ``cfg`` (its width, depth,
    planes and SH degree must be those it was trained with; a parameter
    missing, extra or of another shape raises) and its values loaded."""
    dev = resolve_device(device)
    with np.load(os.path.join(path, CHECKPOINT_FILE)) as data:
        arrays = {k: data[k] for k in data.files}

    def t(key, dtype=None):
        x = torch.from_numpy(np.array(arrays[key]))
        return x.to(device=dev, dtype=dtype) if dtype else x.to(dev)

    deform = Deformation(cfg.hidden, G.num_sh_coeffs(cfg.model.sh_degree), device=dev)
    names = [n for n, _ in deform.named_parameters()]
    stored = sorted(k[len("state.params.deform."):] for k in arrays
                    if k.startswith("state.params.deform."))
    if stored != sorted(names):
        raise ValueError(f"checkpoint {path}: deformation parameters "
                         f"{stored} do not match the config's {sorted(names)}")
    deform.load_state_dict(
        {n: torch.from_numpy(arrays[f"state.params.deform.{n}"]) for n in names},
        strict=True)

    def tree(prefix):
        out = {k: t(f"{prefix}.{k}") for k in G.PRIMITIVE_KEYS}
        out["deform"] = {n: t(f"{prefix}.deform.{n}") for n in names}
        return out

    params = {k: t(f"state.params.{k}") for k in G.PRIMITIVE_KEYS}
    params["deform"] = deform
    state = G.GaussianState(
        params=params,
        **{f: t(f"state.{f}") for f in _STATE_ARRAYS},
        active_sh_degree=int(arrays["state.active_sh_degree"]),
        spatial_lr_scale=float(arrays["state.spatial_lr_scale"]),
    )
    adam_state = AdamState(mu=tree("adam.mu"), nu=tree("adam.nu"),
                           count=int(arrays["adam.count"]))
    return state, adam_state, int(arrays["iteration"])


def find_stage_checkpoint(model_path: str, stage: str) -> str | None:
    """Latest ``chkpnt_<stage>_*`` under ``model_path``, or None: the resume
    gate (train.py:49-57), where a fine checkpoint skips the coarse stage."""
    if not os.path.isdir(model_path):
        return None
    best, best_iter = None, -1
    for name in os.listdir(model_path):
        if name.startswith(f"chkpnt_{stage}_"):
            try:
                it = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if it > best_iter:
                best, best_iter = os.path.join(model_path, name), it
    return best


def save_snapshot(model_path: str, state: G.GaussianState, iteration: int,
                  stage: str = "") -> str:
    """Write ``state`` as a snapshot; returns its directory."""
    prefix = "coarse_" if stage == "coarse" else ""
    out = os.path.join(model_path, "point_cloud", f"{prefix}iteration_{iteration}")
    os.makedirs(out, exist_ok=True)
    alive = state.alive.cpu().numpy()
    params = {k: state.params[k].detach().cpu().numpy() for k in G.PRIMITIVE_KEYS}
    ply_lib.save_gaussian_ply(os.path.join(out, "point_cloud.ply"), params, alive)
    leaves = flatten_tree(deform_to_tree(state.params["deform"]))
    np.savez(
        os.path.join(out, "deformation.npz"),
        # the JAX side stores its treedef's repr here and never reads it back
        treedef=np.array("fourdgs_tpu_torch deform tree, jax.tree.flatten order"),
        aabb=state.aabb.cpu().numpy(),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )
    np.save(os.path.join(out, "deformation_table.npy"),
            state.deformation_table.cpu().numpy()[alive])
    np.save(os.path.join(out, "deformation_accum.npy"),
            state.deformation_accum.cpu().numpy()[alive])
    return out


def load_snapshot(snapshot_dir: str, cfg, device="cuda") -> G.GaussianState:
    """Rebuild a state of capacity ``cfg.tpu.capacity`` from a snapshot; the
    leaf structure comes from a fresh :class:`Deformation` of the same
    config, whose leaves are then replaced."""
    device = resolve_device(device)
    prim = ply_lib.load_gaussian_ply(os.path.join(snapshot_dir, "point_cloud.ply"))
    n = prim["xyz"].shape[0]
    cap = cfg.tpu.capacity
    with np.load(os.path.join(snapshot_dir, "deformation.npz")) as data:
        deform = Deformation(
            cfg.hidden, G.num_sh_coeffs(cfg.model.sh_degree), device="cpu")
        template = deform_to_tree(deform)
        n_leaves = len(flatten_tree(template))
        n_file = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_file != n_leaves:
            raise ValueError(
                f"snapshot has {n_file} deformation leaves, the config "
                f"builds {n_leaves}")
        leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
        aabb = data["aabb"]
    load_deform_tree(deform, unflatten_like(template, leaves))
    table = np.zeros(cap, bool)
    table[:n] = np.load(os.path.join(snapshot_dir, "deformation_table.npy"))
    alive = np.zeros(cap, bool)
    alive[:n] = True
    return G.state_from_numpy(
        G.pad_primitives(prim, cap), deform, alive, aabb,
        active_sh_degree=cfg.model.sh_degree, deformation_table=table,
        device=device,
    )
