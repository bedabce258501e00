"""The process group's bring-up and the grid's layout across hosts.

Counterpart of ``fourdgs_tpu/parallel/multihost.py``. JAX runs one process
per host over all of its devices; ``torch.distributed`` runs one process
per rank, and a host runs ``LOCAL_WORLD_SIZE`` of them (one per GPU):

- :func:`initialize`: ``init_process_group`` over ``tcp://`` (or a
  ``file://`` store) with explicit arguments, or ``env://`` with torchrun's
  variables; idempotent, and a group the caller opened is kept;
- :func:`make_hybrid_mesh`: the ``('data', 'model')`` grid laid out so
  that the ``model`` axis, whose collectives run inside the loss, stays
  inside one host;
- :func:`local_batch_slice` and :func:`host_local_batch`: each rank loads
  and decodes only its own cameras' frames.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from fourdgs_tpu_torch.parallel import trainer
from fourdgs_tpu_torch.parallel.mesh import Mesh, grid_ranks, make_mesh

_initialized = False
# how long a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 1800.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> bool:
    """Open the default process group, once (``multihost.py:40-80``).

    With ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``), ``num_processes`` and ``process_id`` the group is
    opened with exactly these; a failure raises. Without them it is opened
    from torchrun's environment (``env://``: ``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``), or, when that is absent too, as a world of this one
    process (JAX's single-process case). A group that is already open, by
    an earlier call or by the caller, is kept as it is.

    ``backend``: ``nccl`` by default where ``device`` is a CUDA device (one
    GPU per rank), ``gloo`` otherwise; gloo with CUDA tensors only when
    named. A CUDA ``device`` becomes the current device. Returns whether
    this call opened the group."""
    global _initialized
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    if _initialized or dist.is_initialized():
        _initialized = True
        return False
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if backend == "nccl" and dev is not None:
        kw["device_id"] = dev
    given = (coordinator_address, num_processes, process_id)
    if any(x is not None for x in given):
        if any(x is None for x in given):
            raise ValueError("--distributed needs --coordinator_address, "
                             "--num_processes and --process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(init_method=url, rank=int(process_id),
                                world_size=int(num_processes), **kw)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        print("[multihost] no coordinator and no torchrun environment: "
              "a world of this one process")
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)
    _initialized = True
    return True


def shutdown() -> None:
    """Close the default process group and forget it (the counterpart of an
    :func:`initialize` that returned True)."""
    global _initialized
    if dist.is_initialized():
        if dist.get_world_size() > 1:
            # every rank done with its collectives before any closes its
            # connections (as parallel/launch.py's ranks end)
            dist.barrier()
        dist.destroy_process_group()
    _initialized = False


def local_world_size() -> int:
    """Ranks per host: torchrun's ``LOCAL_WORLD_SIZE``, else the whole
    world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def hybrid_layout(n_data: int, n_model: int, world: int, local: int) -> list[list[int]]:
    """The grid's global ranks under ``make_hybrid_mesh``'s rules
    (``multihost.py:83-118``), with ``local`` ranks on each of
    ``world / local`` hosts: on one host, the first ``n_data·n_model`` ranks
    (a subset is allowed); across hosts, every rank, with ``n_model``
    dividing ``local`` so that each ``model`` row lies in one host (ranks
    are numbered host-major, as torchrun numbers them)."""
    if world % local != 0:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    hosts = world // local
    if hosts == 1:
        return grid_ranks(n_data, n_model, world)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks "
                         f"({hosts} hosts x {local} local)")
    if n_model > local or local % n_model != 0:
        raise ValueError(f"model axis {n_model} must divide the {local} local "
                         "ranks so tile slabs stay inside one host")
    return grid_ranks(n_data, n_model, world)


def make_hybrid_mesh(n_data: int, n_model: int) -> Mesh | None:
    """The ``('data', 'model')`` grid over the world's ranks, checked
    against :func:`hybrid_layout`'s rules; every rank calls it."""
    hybrid_layout(n_data, n_model, dist.get_world_size(), local_world_size())
    return make_mesh(n_data, n_model)


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """The cameras of the global batch whose frames this rank loads: its
    ``data`` coordinate's contiguous run (``multihost.py:121-137``)."""
    return trainer.data_slice(global_batch, mesh)


def host_local_batch(mesh: Mesh, local_cams, local_gts):
    """This rank's batch from its own cameras (:func:`local_batch_slice`)
    and their GT ``[B_local, C, H, W]``: the cameras and the rank's
    interleaved slab of the rows (``multihost.py:140-169``). With one rank
    it equals ``trainer.place_batch``."""
    if isinstance(local_gts, np.ndarray):
        local_gts = torch.from_numpy(local_gts)
    return local_cams, trainer.slab_rows(local_gts, mesh)
