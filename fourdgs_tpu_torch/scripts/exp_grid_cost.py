"""Experiment: what a grid of T = 2500 tiles costs on the card.

Counterpart of ``scripts/exp_grid_cost.py``: times each grid-cost probe of
``ops/grid_cost.py`` (K4–K10, its table :data:`~fourdgs_tpu_torch.ops.grid_cost.PROBES`;
the port's blocks in place of the TPU's grid steps) per call,
beside the floor of the same launch with one block (K4 ``parallel`` at
T = 1: one block of 256 threads in which one warp stores and seven return).
Per-block cost = (time − floor) / blocks. K10 runs with zero loop counts, as
the JAX script does. Each probe is timed in turns with ``torch.ones`` of the
bytes it writes, ``(T, 256, floats)``: probe, ``torch.ones``, ``torch.ones``,
probe, so that the ratio compares readings of one moment. That fill is the
floor a store of those bytes reaches on the card; where it is also the
probe's output (``Probe.ones``), it is the one PyTorch call that computes the
same function. Times: see :mod:`fourdgs_tpu_torch.scripts`.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.ops import grid_cost as G
from fourdgs_tpu_torch.scripts import header, main_with, time_ms


def run(device="cuda", T=2500) -> dict:
    """Returns ``{"device", "clock", "T", "floor_ms", "probes": {wrapper
    name: {"ms", "wall_ms", "blocks", "per_block_us", "fill_ms", "vs_fill",
    "ones_ms", "vs_ones"}}}``: ``ms`` and ``fill_ms`` the means of the
    probe's and its same-bytes ``torch.ones``'s two readings in turns,
    ``vs_fill = ms / fill_ms``; ``ones_ms`` and ``vs_ones`` the same two
    numbers where ``torch.ones`` computes the probe's output, else None."""
    dev = resolve_device(device)
    floor_ms, _ = time_ms(lambda: G.ones_parallel(1, dev), dev)
    res = dict(header(dev), T=T, floor_ms=floor_ms, probes={})
    print(f"floor: 1 block, parallel   {floor_ms:9.5f} ms")
    for p in G.PROBES:
        args = p.args(T, dev)

        def probe():
            return p.fn(*args)

        def fill():
            return torch.ones((T, G.N, p.floats), dtype=torch.float32, device=dev)

        (a, wa), (f1, _), (f2, _), (b, wb) = [
            time_ms(f, dev) for f in (probe, fill, fill, probe)]
        ms, wall_ms, fill_ms = (a + b) / 2, (wa + wb) / 2, (f1 + f2) / 2
        vs_fill = ms / fill_ms
        blocks = p.blocks(T, dev)
        per_block = None if not blocks else (ms - floor_ms) / blocks * 1e3
        res["probes"][p.fn.__name__] = dict(
            ms=ms, wall_ms=wall_ms, blocks=blocks, per_block_us=per_block,
            fill_ms=fill_ms, vs_fill=vs_fill,
            ones_ms=fill_ms if p.ones else None, vs_ones=vs_fill if p.ones else None)
        pb = "n/a" if per_block is None else f"{per_block:.5f} us/block"
        what = "torch.ones" if p.ones else "same-bytes fill"
        print(f"{p.label:26s} {ms:9.5f} ms  ({blocks} blocks, {pb}; "
              f"wall {wall_ms:.5f} ms/call; {what} {fill_ms:.5f} ms ({vs_fill:.3f}x))")
    return res


def main():
    main_with(run, "Grid-cost probes (K4-K10) on the card")


if __name__ == "__main__":
    main()
