"""Experiment: the per-tile fixed cost of the blend kernels K1 and K2.

Counterpart of ``scripts/exp_kernel_overhead.py``. On T = 2500 tiles of a
50-wide grid (800×800) with the script's payload (K = 393,216 slots; x, y
uniform over the grid, conic a, c in U(0.01, 0.3), b = 0, opacity
U(0.3, 0.9), colours and depth U(0, 1); background 0) it runs three tile
grids: all tiles empty, 98 instances per tile and 128 per tile. For each it
times K1 alone (``ops/blend.py::blend_forward``), K2 alone
(``blend_backward`` with the cotangent of ``out[:, :3].sum()``) and the
forward plus backward through the autograd function ``ops/blend.py::blend``
with ``torch.autograd.grad(out[:, :3].sum(), feat)``: the gradient of the
sum of the colour channels, which is the JAX script's intent.

The JAX script's backward line does not run on today's JAX package: its
``loss`` (``scripts/exp_kernel_overhead.py:62-64``) unpacks
``col, dep, _ = PB.blend_pallas(...)``, but ``blend_pallas`` returns one
packed [T, 5, 256] array, so ``jax.grad`` raises ``ValueError: too many
values to unpack``; only its forward timings run.

It reports ms per call, the per-tile fixed cost (the empty grid's time / T)
and the per-instance cost ((uniform − empty) / instances) of each. Times: see
:mod:`fourdgs_tpu_torch.scripts`.
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.ops import blend as B
from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.scripts import SEED, header, main_with, time_ms

GRIDS = (("empty", 0), ("uniform98", 98), ("uniform128", 128))


def payload(T: int, gx: int, K: int, dev: torch.device) -> torch.Tensor:
    """The script's feat [16, K] (``exp_kernel_overhead.py:44-51``), x and y
    spread over the tile grid (800×800 at its sizes)."""
    rng = np.random.default_rng(SEED)
    feat = np.zeros((C.FEAT_ROWS, K), np.float32)
    feat[0] = rng.uniform(0, C.TILE_X * gx, K)
    feat[1] = rng.uniform(0, C.TILE_Y * -(-T // gx), K)
    feat[2] = rng.uniform(0.01, 0.3, K)
    feat[4] = rng.uniform(0.01, 0.3, K)
    feat[5] = rng.uniform(0.3, 0.9, K)
    feat[6:10] = rng.uniform(0, 1, (4, K))
    return torch.from_numpy(feat).to(dev)


def tile_ranges(T: int, per_tile: int, dev: torch.device):
    """(starts, stops) [T] int32 of ``per_tile`` consecutive instances per
    tile."""
    stops = torch.arange(1, T + 1, dtype=torch.int32, device=dev) * per_tile
    return stops - per_tile, stops


def cotangent(T: int, dev: torch.device) -> torch.Tensor:
    """The cotangent of ``out[:, :3].sum()``: 1 on the colour channels."""
    g = torch.zeros((T, C.OUT5, C.N_PIX), dtype=torch.float32, device=dev)
    g[:, 0:3] = 1.0
    return g


def inputs(T: int, gx: int, K: int, dev: torch.device) -> dict:
    """{grid: (feat, starts, stops, row_off, bg, g_out)} for the three tile
    grids."""
    if 128 * T > K:
        raise ValueError(f"K = {K} holds fewer than 128 instances for each of {T} tiles")
    feat = payload(T, gx, K, dev)
    row_off = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    g_out = cotangent(T, dev)
    return {name: (feat, *tile_ranges(T, n, dev), row_off, bg, g_out)
            for name, n in GRIDS}


def run(device="cuda", T=2500, gx=50, K=384 * 1024) -> dict:
    """Returns ``{"device", "clock", "T", "gx", "K", "grids": {grid:
    {"instances", "fwd_ms", "bwd_ms", "fwd_bwd_ms"}}, "per_tile_us": {"fwd",
    "bwd", "fwd_bwd"}, "per_instance_ns": {grid: {"fwd", "bwd", "fwd_bwd"}}}``
    (per instance for each uniform grid)."""
    dev = resolve_device(device)
    res = dict(header(dev), T=T, gx=gx, K=K, grids={})
    for name, (feat, starts, stops, row_off, bg, g_out) in inputs(T, gx, K, dev).items():
        out = B.blend_forward(feat, starts, stops, row_off, bg, gx)
        feat_g = feat.clone().requires_grad_()

        def fwd_bwd():
            with torch.enable_grad():   # also under a caller's no_grad
                o = B.blend(feat_g, starts, stops, row_off, bg, gx)
                return torch.autograd.grad(o[:, :3].sum(), feat_g)

        times = {
            "fwd_ms": lambda: B.blend_forward(feat, starts, stops, row_off, bg, gx),
            "bwd_ms": lambda: B.blend_backward(feat, starts, stops, row_off, bg, out,
                                               g_out, gx),
            "fwd_bwd_ms": fwd_bwd,
        }
        row = {"instances": int((stops - starts).sum())}
        for key, fn in times.items():
            row[key] = time_ms(fn, dev)[0]
        res["grids"][name] = row
        print(f"{name:12s} fwd {row['fwd_ms']:8.4f} ms  bwd {row['bwd_ms']:8.4f} ms  "
              f"fwd+bwd {row['fwd_bwd_ms']:8.4f} ms  ({row['instances']} inst)")
    empty = res["grids"]["empty"]
    keys = ("fwd_ms", "bwd_ms", "fwd_bwd_ms")
    res["per_tile_us"] = {k[:-3]: empty[k] / T * 1e3 for k in keys}
    res["per_instance_ns"] = {
        name: {k[:-3]: (row[k] - empty[k]) / row["instances"] * 1e6 for k in keys}
        for name, row in res["grids"].items() if row["instances"]}
    print(f"per-tile fixed cost (empty / T), us: {res['per_tile_us']}")
    print(f"per-instance cost ((uniform - empty) / instances), ns: "
          f"{res['per_instance_ns']}")
    return res


def main():
    main_with(run, "Per-tile fixed cost of the blend kernels K1 and K2 on the card")


if __name__ == "__main__":
    main()
