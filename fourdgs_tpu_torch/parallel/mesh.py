"""The ``('data', 'model')`` grid of ranks of the sharded trainer.

Counterpart of ``fourdgs_tpu/parallel/mesh.py``. JAX's mesh is a grid of
the local devices of one process (``mesh.py:23-31``); here it is a grid of
the ranks of a ``torch.distributed`` world, one process each:

  data  — cameras of the step's batch
  model — interleaved tile rows of the image (``parallel/trainer.py``)

Rank ``r < D·M`` sits at ``(d, m) = divmod(r, M)``, JAX's row-major
``reshape(n_data, n_model)`` of its device list. Each rank holds three
process groups: ``model`` (the ranks of its ``d``), ``data`` (the ranks of
its ``m``) and ``world`` (all D·M ranks), on the backend of the default
group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its process groups."""

    shape: dict            # {"data": D, "model": M}
    d: int                 # this rank's data coordinate
    m: int                 # this rank's model coordinate
    world: object          # ProcessGroup of the D·M ranks
    data: object           # ProcessGroup of the ranks with this rank's m
    model: object          # ProcessGroup of the ranks with this rank's d
    world_ranks: tuple     # global ranks of the grid, row-major

    @property
    def rank(self) -> int:
        """This rank's index in the grid, d·M + m."""
        return self.d * self.shape["model"] + self.m

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def grid_ranks(n_data: int, n_model: int, world_size: int) -> list[list[int]]:
    """The global ranks of a ``n_data × n_model`` grid over the first
    ``n_data·n_model`` ranks; raises when the world is smaller, as
    ``mesh.py:28-29`` does for devices."""
    need = n_data * n_model
    if world_size < need:
        raise ValueError(f"need {need} ranks, have {world_size}")
    return [[d * n_model + m for m in range(n_model)] for d in range(n_data)]


def make_mesh(n_data: int = 1, n_model: int = 1) -> Mesh | None:
    """The ``('data', 'model')`` grid over the first ``n_data·n_model``
    ranks of the default process group, which must be open. Every rank of
    the world calls it (``new_group`` is collective: each rank creates every
    group, in the same order); a rank outside the grid gets ``None``, as a
    device JAX's mesh leaves out idles."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an open process group "
                           "(parallel.multihost.initialize)")
    grid = grid_ranks(n_data, n_model, dist.get_world_size())
    flat = [r for row in grid for r in row]
    model_groups = [dist.new_group(row) for row in grid]
    data_groups = [dist.new_group([row[m] for row in grid]) for m in range(n_model)]
    world = (dist.group.WORLD if len(flat) == dist.get_world_size()
             else dist.new_group(flat))
    rank = dist.get_rank()
    if rank not in flat:
        return None
    d, m = divmod(flat.index(rank), n_model)
    return Mesh(shape={"data": n_data, "model": n_model}, d=d, m=m, world=world,
                data=data_groups[m], model=model_groups[d], world_ranks=tuple(flat))


def parse_mesh_arg(spec: str) -> dict[str, int]:
    """Parse a CLI mesh spec like ``data=2,model=4`` into axis sizes.

    Unknown axis names are rejected; omitted axes default to 1.
    """
    sizes = {"data": 1, "model": 1}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, val = part.partition("=")
        if name not in sizes or not val:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected e.g. 'data=2,model=4'"
            )
        sizes[name] = int(val)
        if sizes[name] < 1:
            raise ValueError(f"mesh axis {name} must be >= 1")
    return sizes
