"""Parameters carried across between the JAX package's layout and the port's.

The JAX package keeps the model as a params pytree (``GaussianState.params``):
the primitive arrays ``xyz, f_dc, f_rest, scaling, rotation, opacity`` and the
nested ``deform`` dict ``feature_out[i].{w,b}``, ``grid_s*_p*``,
``head_*[j].{w,b}``, ``timenet[j].{w,b}``, with Linear weights stored
[in, out]. The port keeps the primitives as tensors and the deformation as a
:class:`Deformation` module whose ``nn.Linear`` weights are [out, in]; the
functions here transpose explicitly. Everything crosses as numpy: the port
never sees JAX (callers convert with ``jax.tree.map(np.asarray, ...)``).

The whole ``GaussianState`` crosses at any capacity (:func:`state_from_jax`,
:func:`state_to_numpy`): the parameters, alive mask, deformation table,
the four statistics, the AABB, ``active_sh_degree`` and
``spatial_lr_scale``. The Adam state crosses with the same leaf mapping
(:func:`adam_from_jax_numpy`, :func:`adam_to_numpy`), at whatever capacity
its moments have: the moments of ``deform`` are keyed by the module's
parameter names on the port's side.

``flatten_tree`` reproduces ``jax.tree.flatten``'s leaf order on these trees
(dict keys sorted, lists in order), which the snapshot format relies on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.models.deformation import Deformation
from fourdgs_tpu_torch.train import adam


def _jax_path(name: str) -> tuple[tuple, bool]:
    """A :class:`Deformation` parameter name → (its path in the JAX
    ``deform`` tree, whether the array is transposed there):
    ``grids.grid_s0_p1`` → ``("grid_s0_p1",)``, ``feature_out.0.weight`` →
    ``("feature_out", 0, "w")``, ``heads.pos.1.bias`` → ``("head_pos", 1,
    "b")``, ``timenet.0.weight`` → ``("timenet", 0, "w")``."""
    parts = name.split(".")
    if parts[0] == "grids":
        return (parts[1],), False
    if parts[0] == "heads":
        parts = [f"head_{parts[1]}"] + parts[2:]
    key, i, kind = parts
    return (key, int(i), "w" if kind == "weight" else "b"), kind == "weight"


def named_to_tree(named) -> dict[str, Any]:
    """``{parameter name: tensor}`` of a :class:`Deformation` (its
    parameters, or moments or gradients shaped like them) → the JAX
    ``deform`` tree as numpy, Linear weights transposed to [in, out]."""
    tree: dict[str, Any] = {}
    for name, x in named.items():
        (key, *rest), transposed = _jax_path(name)
        a = x.detach().cpu().numpy()
        a = (a.T if transposed else a).copy()
        if not rest:
            tree[key] = a
            continue
        layers = tree.setdefault(key, [])
        layers.extend({} for _ in range(rest[0] + 1 - len(layers)))
        layers[rest[0]][rest[1]] = a
    return tree


def tree_to_named(tree, deform: Deformation) -> dict[str, np.ndarray]:
    """Inverse of :func:`named_to_tree` for ``deform``'s parameters, with
    the tree's keys, layer counts and shapes checked."""
    expected = named_to_tree(dict(deform.named_parameters()))
    if set(tree) != set(expected):
        raise ValueError(
            f"deform tree keys {sorted(tree)} != expected {sorted(expected)}")
    for k, v in expected.items():
        if isinstance(v, list) and len(tree[k]) != len(v):
            raise ValueError(f"{k}: {len(tree[k])} layers != {len(v)}")
    out = {}
    for name, p in deform.named_parameters():
        (key, *rest), transposed = _jax_path(name)
        a = tree[key] if not rest else tree[key][rest[0]][rest[1]]
        a = np.asarray(a, np.float32)
        a = a.T if transposed else a
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != expected {tuple(p.shape)}")
        out[name] = a
    return out


def deform_to_tree(deform: Deformation) -> dict[str, Any]:
    """The module's parameters as the JAX ``params["deform"]`` tree."""
    return named_to_tree(dict(deform.named_parameters()))


def load_deform_tree(deform: Deformation, tree: dict[str, Any]) -> Deformation:
    """Copy a JAX-layout ``deform`` tree into ``deform`` (shapes checked)."""
    arrays = tree_to_named(tree, deform)
    with torch.no_grad():
        for name, p in deform.named_parameters():
            p.copy_(torch.tensor(arrays[name]))
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


def state_from_jax(state_np, cfg, device="cuda") -> G.GaussianState:
    """A JAX ``GaussianState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``, or any object with its fields) →
    a port :class:`GaussianState` on ``device``, every field carried."""
    st = from_jax_numpy(state_np.params, state_np.alive, state_np.aabb, cfg,
                        device=device)
    dev = st.alive.device

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return st._replace(
        max_radii2d=t(state_np.max_radii2d, torch.float32),
        xyz_gradient_accum=t(state_np.xyz_gradient_accum, torch.float32),
        denom=t(state_np.denom, torch.float32),
        deformation_accum=t(state_np.deformation_accum, torch.float32),
        deformation_table=t(state_np.deformation_table, torch.bool),
        active_sh_degree=int(state_np.active_sh_degree),
        spatial_lr_scale=float(state_np.spatial_lr_scale),
    )


def state_to_numpy(state: G.GaussianState) -> G.GaussianState:
    """A port state → a :class:`GaussianState` of numpy leaves in the JAX
    layout (the params tree of :func:`to_numpy`), field for field the JAX
    ``GaussianState``'s: ``jax_gaussians.GaussianState(*state_to_numpy(s))``
    rebuilds it."""
    params, alive, aabb = to_numpy(state)

    def a(x):
        return x.detach().cpu().numpy()

    return G.GaussianState(
        params=params, alive=alive, max_radii2d=a(state.max_radii2d),
        xyz_gradient_accum=a(state.xyz_gradient_accum), denom=a(state.denom),
        deformation_accum=a(state.deformation_accum),
        deformation_table=a(state.deformation_table), aabb=aabb,
        active_sh_degree=state.active_sh_degree,
        spatial_lr_scale=state.spatial_lr_scale,
    )


def adam_from_jax_numpy(mu, nu, count, params) -> adam.AdamState:
    """A JAX ``AdamState`` (its ``mu``, ``nu`` trees as numpy and
    ``count``) → a port :class:`~fourdgs_tpu_torch.train.adam.AdamState`
    for ``params``, on their device, with the leaf mapping of the
    parameters."""
    dev = params["xyz"].device

    def moments(tree):
        out = {k: torch.tensor(np.asarray(tree[k], np.float32), device=dev)
               for k in G.PRIMITIVE_KEYS}
        out["deform"] = {n: torch.tensor(a, device=dev) for n, a in
                         tree_to_named(tree["deform"], params["deform"]).items()}
        return out

    return adam.AdamState(mu=moments(mu), nu=moments(nu), count=int(count))


def adam_to_numpy(state: adam.AdamState):
    """A port Adam state → (``mu``, ``nu`` as JAX-layout numpy trees,
    ``count``)."""
    def tree(m):
        out = {k: m[k].detach().cpu().numpy() for k in G.PRIMITIVE_KEYS}
        out["deform"] = named_to_tree(m["deform"])
        return out

    return tree(state.mu), tree(state.nu), state.count
