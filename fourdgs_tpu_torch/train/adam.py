"""Adam with explicit moments and the per-group learning-rate schedules.

Counterpart of ``fourdgs_tpu/train/adam.py:23-207``. The moments are plain
tensors shaped like the parameters, so a later densification can scatter
into them, and the update is the JAX formula written out,
``p − lr·(m/c1)/(√(v/c2) + eps)`` with eps 1e-15, over ``torch._foreach_*``
lists. Trees here are shaped like the port's ``params``: the primitive
tensors by name and ``"deform"``, which in ``params`` is the
:class:`~fourdgs_tpu_torch.models.deformation.Deformation` module and in the
moments, gradients and learning rates a dict keyed by the module's parameter
names.

Unlike the JAX function, :func:`update` writes the new parameters and moments
in place (the port keeps one copy of each on the card) and returns them.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from fourdgs_tpu_torch.models.deformation import split_param_labels
from fourdgs_tpu_torch.models.gaussians import PRIMITIVE_KEYS


class AdamState(NamedTuple):
    mu: dict[str, Any]   # first moments, shaped like params
    nu: dict[str, Any]   # second moments
    count: int           # steps taken


def named_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of a params-shaped tree: the primitives
    in ``PRIMITIVE_KEYS`` order, then ``deform.<parameter name>`` in the
    module's parameter order."""
    deform = tree["deform"]
    named = (deform.named_parameters() if isinstance(deform, torch.nn.Module)
             else deform.items())
    return ([(k, tree[k]) for k in PRIMITIVE_KEYS]
            + [(f"deform.{n}", x) for n, x in named])


def tree_like(params, leaves) -> dict[str, Any]:
    """A params-shaped tree of ``leaves`` (in :func:`named_leaves` order)."""
    leaves = list(leaves)
    n = len(PRIMITIVE_KEYS)
    names = [name for name, _ in params["deform"].named_parameters()]
    if len(leaves) != n + len(names):
        raise ValueError(f"{len(leaves)} leaves for {n + len(names)} parameters")
    tree: dict[str, Any] = dict(zip(PRIMITIVE_KEYS, leaves[:n]))
    tree["deform"] = dict(zip(names, leaves[n:]))
    return tree


def init(params) -> AdamState:
    zeros = lambda: tree_like(
        params, [torch.zeros_like(x, memory_format=torch.contiguous_format)
                 for _, x in named_leaves(params)])
    return AdamState(mu=zeros(), nu=zeros(), count=0)


def update(params, grads, state: AdamState, lr_tree, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-15):
    """One Adam step with a per-leaf learning rate (``lr_tree`` shaped like
    ``params``, Python floats). Updates ``params`` and the moments in place;
    returns ``(params, AdamState)``."""
    count = state.count + 1
    # bias corrections in float32, as the JAX step computes them
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
    p = [x for _, x in named_leaves(params)]
    g = [x for _, x in named_leaves(grads)]
    m = [x for _, x in named_leaves(state.mu)]
    v = [x for _, x in named_leaves(state.nu)]
    lrs = [float(x) for _, x in named_leaves(lr_tree)]
    with torch.no_grad():
        torch._foreach_mul_(m, b1)                       # m = b1·m + (1−b1)·g
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(v, b2)                       # v = b2·v + (1−b2)·g²
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, c2)                # √(v/c2) + eps
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(m, c1)                 # lr·(m/c1)/denom
        torch._foreach_mul_(step, lrs)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(p, step)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear interpolation from ``lr_init`` to ``lr_final`` over
    ``max_steps`` with an optional sine delay, in float32 as the JAX
    schedule (``adam.py:129-156``)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    s = torch.tensor(float(step), dtype=torch.float32)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0.0, 1.0))
    else:
        delay = 1.0
    t = torch.clamp(s / max_steps, 0.0, 1.0)
    log_lerp = torch.exp((1 - t) * math.log(max(lr_init, 1e-30))
                         + t * math.log(max(lr_final, 1e-30)))
    return float(delay * log_lerp)


def learning_rates(step, opt, spatial_lr_scale: float) -> dict[str, float]:
    """Per-group learning rates at ``step``: xyz, deformation and grid
    follow their schedules, the rest are constant, f_rest = feature_lr/20."""
    sls = spatial_lr_scale
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))
    return {
        "xyz": expon_lr(step, opt.position_lr_init * sls,
                        opt.position_lr_final * sls,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps),
        "deformation": expon_lr(step, opt.deformation_lr_init * sls,
                                opt.deformation_lr_final * sls,
                                lr_delay_mult=opt.deformation_lr_delay_mult,
                                max_steps=opt.position_lr_max_steps),
        "grid": expon_lr(step, opt.grid_lr_init * sls, opt.grid_lr_final * sls,
                         lr_delay_mult=opt.deformation_lr_delay_mult,
                         max_steps=opt.position_lr_max_steps),
        "f_dc": f32(opt.feature_lr),
        "f_rest": f32(opt.feature_lr / 20.0),
        "opacity": f32(opt.opacity_lr),
        "scaling": f32(opt.scaling_lr),
        "rotation": f32(opt.rotation_lr),
    }


def lr_tree_for_params(params, lrs: dict[str, float]) -> dict[str, Any]:
    """The group rates on a params-shaped tree: primitives by name, the
    deformation's parameters by :func:`split_param_labels`."""
    tree: dict[str, Any] = {k: lrs[k] for k in PRIMITIVE_KEYS}
    tree["deform"] = {n: lrs[label] for n, label in
                      split_param_labels(params["deform"]).items()}
    return tree
