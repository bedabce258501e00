"""Collectives on a process group: the port's counterpart of
``jax.lax.all_gather``, ``psum``, ``pmax`` and ``pmean`` under
``shard_map``.

:func:`all_gather` is differentiable: its backward is the reduce-scatter of
the cotangent over the same group along the same axis, JAX's transpose of
the gather. The sharded trainer's row gather for D-SSIM, its parameter
gather under ``shard_primitives`` and its table gather under
``shard_preprocess`` rely on it. The reductions are taken outside the loss
(as the JAX step takes them after ``value_and_grad``) and are not
differentiable. :func:`psum` and :func:`pmax` of several tensors pack them
into one buffer per dtype, one collective each, as XLA combines a tree's
``psum``.

The backend is the group's: ``nccl`` (one GPU per rank) or ``gloo``,
which the caller chose when it opened the process group
(``parallel/multihost.py``). gloo ran every collective used here
(``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``) on CUDA tensors, float32 and bfloat16, under
torch 2.11 on the H100's host, so no call is routed through host memory by
this module. Each call is counted with its bytes (:data:`counts`).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

# calls and bytes of each collective of this process since the last reset
counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


def _count(op: str, t: torch.Tensor) -> None:
    counts[op] += 1
    counts[f"{op}_bytes"] += t.numel() * t.element_size()


def group_size(group) -> int:
    return dist.get_world_size(group)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n0, ...] of every rank of ``group`` concatenated on dim 0, in
    the group's rank order."""
    n = group_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count("all_gather", out)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of dim 0 of the sum of ``x`` over ``group``."""
    n = group_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count("reduce_scatter", x)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _gather0(x.movedim(axis, 0), group).movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter0(g.movedim(ctx.axis, 0), ctx.group)
                .movedim(0, ctx.axis), None, None)


def all_gather(x: torch.Tensor, group, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis_name, axis=axis, tiled=tiled)``: the
    ranks' ``x`` concatenated along ``axis`` in the group's rank order
    (``tiled``), or stacked on a new ``axis``. Differentiable where ``x``
    requires a gradient; every rank of the group must then run the backward,
    since it is collective."""
    axis = axis % (x.dim() + (0 if tiled else 1))
    if not tiled:
        x = x.unsqueeze(axis)
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(x, group, axis)
    return _gather0(x.movedim(axis, 0), group).movedim(0, axis)


def _reduce(tensors, group, op, name: str) -> list[torch.Tensor]:
    """Reduce each tensor over ``group``: one collective per dtype over the
    tensors packed flat. Returns new tensors; the inputs are not written."""
    tensors = [t.detach() for t in tensors]
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _count(name, flat)
        dist.all_reduce(flat, op=op, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def psum(tensors, group):
    """``jax.lax.psum`` of a tensor, or of a list of them, over ``group``."""
    if isinstance(tensors, torch.Tensor):
        return _reduce([tensors], group, dist.ReduceOp.SUM, "psum")[0]
    return _reduce(tensors, group, dist.ReduceOp.SUM, "psum")


def pmax(tensors, group):
    """``jax.lax.pmax`` of a tensor, or of a list of them, over ``group``."""
    if isinstance(tensors, torch.Tensor):
        return _reduce([tensors], group, dist.ReduceOp.MAX, "pmax")[0]
    return _reduce(tensors, group, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.pmean``: :func:`psum` over the group's size."""
    return psum(x, group) / group_size(group)


def broadcast_(tensors, group, src: int) -> None:
    """Overwrite each tensor, in place, with global rank ``src``'s: one
    collective per dtype over the tensors packed flat (a bool tensor
    travels as its bytes)."""
    with torch.no_grad():
        tensors = [t.view(torch.uint8) if t.dtype == torch.bool else t
                   for t in tensors]
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            _count("broadcast", flat)
            dist.broadcast(flat, src=src, group=group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))
