"""Model snapshots for rendering, in the JAX package's format.

Counterpart of ``save_snapshot``/``load_snapshot``
(``fourdgs_tpu/train/checkpoint.py:90-174``). A snapshot directory
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

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.data import ply as ply_lib
from fourdgs_tpu_torch.interop import (
    deform_to_tree, flatten_tree, load_deform_tree, unflatten_like)
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models.deformation import Deformation


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
