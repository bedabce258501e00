"""Parameters carried across between the JAX package's layout and the port's.

The JAX package keeps the model as a params pytree (``GaussianState.params``):
the primitive arrays ``xyz, f_dc, f_rest, scaling, rotation, opacity`` and the
nested ``deform`` dict ``feature_out[i].{w,b}``, ``grid_s*_p*``,
``head_*[j].{w,b}``, ``timenet[j].{w,b}``, with Linear weights stored
[in, out]. The port keeps the primitives as tensors and the deformation as a
:class:`Deformation` module whose ``nn.Linear`` weights are [out, in]; the
functions here transpose explicitly. Everything crosses as numpy: the port
never sees JAX (callers convert with ``jax.tree.map(np.asarray, ...)``).

``flatten_tree`` reproduces ``jax.tree.flatten``'s leaf order on these trees
(dict keys sorted, lists in order), which the snapshot format relies on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models.deformation import HEADS, Deformation


def _linear_tree(lin: torch.nn.Linear) -> dict[str, np.ndarray]:
    return {"w": lin.weight.detach().cpu().numpy().T.copy(),
            "b": lin.bias.detach().cpu().numpy().copy()}


def deform_to_tree(deform: Deformation) -> dict[str, Any]:
    """The module's parameters as the JAX ``params["deform"]`` tree."""
    tree: dict[str, Any] = {
        k: v.detach().cpu().numpy().copy() for k, v in deform.grids.items()
    }
    tree["feature_out"] = [_linear_tree(l) for l in deform.feature_out]
    for h in HEADS:
        tree[f"head_{h}"] = [_linear_tree(l) for l in deform.heads[h]]
    tree["timenet"] = [_linear_tree(l) for l in deform.timenet]
    return tree


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src, np.float32)
    if tuple(dst.shape) != src.shape:
        raise ValueError(f"{name}: shape {src.shape} != expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(src))


def load_deform_tree(deform: Deformation, tree: dict[str, Any]) -> Deformation:
    """Copy a JAX-layout ``deform`` tree into ``deform`` (shapes checked)."""
    expected = set(deform_to_tree(deform))
    if set(tree) != expected:
        raise ValueError(
            f"deform tree keys {sorted(tree)} != expected {sorted(expected)}")
    for k, p in deform.grids.items():
        _copy(p, tree[k], k)

    def load_layers(layers, entries, name):
        if len(entries) != len(layers):
            raise ValueError(f"{name}: {len(entries)} layers != {len(layers)}")
        for i, (lin, e) in enumerate(zip(layers, entries)):
            _copy(lin.weight, np.asarray(e["w"]).T, f"{name}[{i}].w")
            _copy(lin.bias, e["b"], f"{name}[{i}].b")

    load_layers(deform.feature_out, tree["feature_out"], "feature_out")
    for h in HEADS:
        load_layers(deform.heads[h], tree[f"head_{h}"], f"head_{h}")
    load_layers(deform.timenet, tree["timenet"], "timenet")
    return deform


def flatten_tree(tree) -> list[np.ndarray]:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_tree(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten_tree(v)]
    return [tree]


def unflatten_like(template, leaves: list):
    """Inverse of :func:`flatten_tree` on a tree shaped like ``template``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def from_jax_numpy(params_np: dict[str, Any], alive, aabb, cfg,
                   device="cuda") -> G.GaussianState:
    """The JAX ``GaussianState.params`` (as numpy) with its alive mask and
    AABB → a port :class:`GaussianState` on ``device``."""
    k_sh = G.num_sh_coeffs(cfg.model.sh_degree)
    deform = Deformation(cfg.hidden, k_sh, device="cpu")
    load_deform_tree(deform, params_np["deform"])
    return G.state_from_numpy(
        {k: params_np[k] for k in G.PRIMITIVE_KEYS}, deform, alive, aabb,
        active_sh_degree=cfg.model.sh_degree, device=device,
    )


def to_numpy(state: G.GaussianState):
    """A port state → (JAX-layout params tree as numpy, alive, aabb)."""
    params = {k: state.params[k].detach().cpu().numpy()
              for k in G.PRIMITIVE_KEYS}
    params["deform"] = deform_to_tree(state.params["deform"])
    return (params, state.alive.cpu().numpy(), state.aabb.cpu().numpy())
