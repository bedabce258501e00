"""The data × tile-row sharded trainer on ``torch.distributed``.

Counterpart of ``fourdgs_tpu/parallel/``. JAX drives every device of a host
from one process through ``shard_map``; here each device of the
``('data', 'model')`` grid is one rank, a process of its own:

- :mod:`.mesh`: the grid of ranks and its process groups;
- :mod:`.collectives`: ``all_gather`` (differentiable, its backward the
  reduce-scatter of the cotangent), ``psum``, ``pmax``, ``pmean`` and
  ``broadcast`` on a group;
- :mod:`.trainer`: the sharded train step and the layouts of its inputs;
- :mod:`.multihost`: the process group's bring-up and the layout across
  hosts;
- :mod:`.launch`: starting the ranks of a world on one host, each joined
  with a timeout.
"""
