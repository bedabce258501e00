"""Experiment: what a grid of T = 2500 tiles costs on the card.

Counterpart of ``scripts/exp_grid_cost.py``: times each grid-cost probe of
``ops/grid_cost.py`` (K4–K10, its table :data:`~fourdgs_tpu_torch.ops.grid_cost.PROBES`;
the port's blocks in place of the TPU's grid steps) per call,
beside the floor of the same launch with one block (K4 ``parallel`` at
T = 1: one block of 256 threads in which one warp stores and seven return).
Per-block cost = (time − floor) / blocks. K10 runs with zero loop counts, as
the JAX script does. A probe whose output ``torch.ones`` computes in one call
(``Probe.ones``) is timed in turns with that call: probe, ``torch.ones``,
``torch.ones``, probe, so that the ratio compares readings of one moment.
Times: see :mod:`fourdgs_tpu_torch.scripts`.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.ops import grid_cost as G
from fourdgs_tpu_torch.scripts import header, main_with, time_ms


def run(device="cuda", T=2500) -> dict:
    """Returns ``{"device", "clock", "T", "floor_ms", "probes": {wrapper
    name: {"ms", "wall_ms", "blocks", "per_block_us", "ones_ms",
    "vs_ones"}}}``: ``ms`` and ``ones_ms`` the means of the probe's and
    ``torch.ones``'s two readings in turns, ``vs_ones = ms / ones_ms``;
    both None for a probe without that yardstick."""
    dev = resolve_device(device)
    floor_ms, _ = time_ms(lambda: G.ones_parallel(1, dev), dev)
    res = dict(header(dev), T=T, floor_ms=floor_ms, probes={})
    print(f"floor: 1 block, parallel   {floor_ms:9.5f} ms")
    for p in G.PROBES:
        args = p.args(T, dev)

        def probe():
            return p.fn(*args)

        if p.ones:
            def ones():
                return torch.ones((T, G.N, p.floats), dtype=torch.float32, device=dev)

            (a, wa), (o1, _), (o2, _), (b, wb) = [
                time_ms(f, dev) for f in (probe, ones, ones, probe)]
            ms, wall_ms, ones_ms = (a + b) / 2, (wa + wb) / 2, (o1 + o2) / 2
            vs_ones = ms / ones_ms
        else:
            (ms, wall_ms), ones_ms, vs_ones = time_ms(probe, dev), None, None
        blocks = p.blocks(T, dev)
        per_block = None if not blocks else (ms - floor_ms) / blocks * 1e3
        res["probes"][p.fn.__name__] = dict(
            ms=ms, wall_ms=wall_ms, blocks=blocks, per_block_us=per_block,
            ones_ms=ones_ms, vs_ones=vs_ones)
        pb = "n/a" if per_block is None else f"{per_block:.5f} us/block"
        yard = "" if ones_ms is None else f"; torch.ones {ones_ms:.5f} ms ({vs_ones:.3f}x)"
        print(f"{p.label:26s} {ms:9.5f} ms  ({blocks} blocks, {pb}; "
              f"wall {wall_ms:.5f} ms/call{yard})")
    return res


def main():
    main_with(run, "Grid-cost probes (K4-K10) on the card")


if __name__ == "__main__":
    main()
