"""The sharded trainer's per-rank work on one card: T_slab(1/N)
(``scripts/measure_scaling.py``'s slab half).

    python -m fourdgs_tpu_torch.scripts.measure_scaling [--device cuda]
        [--size 800] [--shards 1,2,4,5,10] [--out scaling.json]

A rank of the sharded step with ``model`` = N does two things of its own
(``parallel/trainer.py``, ``shard_preprocess``): it deforms, preprocesses
and packs the payload table of its [P/N] slice of the Gaussians, and it
bins and blends its interleaved tile rows {s + j·N} against the whole
gathered table. On ``bench_torch.py``'s workload (800×800: 50 tile rows,
which N = 1, 2, 4, 5 and 10 divide; 60,000 Gaussians in 65,536 rows, the
bf16 payload) this times, for each N, on shard 0:

  A(P/N): deformation, activations, preprocess and table, forward and
          backward, over the first P/N rows;
  B(N):   ``rasterize_from_table``, forward and backward, over the slab's
          rows at the per-shard instance budget (the slab's demand × 1.4,
          rounded up to 65,536), with K1 and K2 on the slab;

and the whole single-rank train step T_full, whose rest T_rest = T_full −
A(P) − B(1) is the per-rank work N does not divide (Adam, the loss). The
JAX script's estimate is

  efficiency(N) ≈ T_full / (N · (A(P/N) + B(N) + T_rest + T_comm(N))),
  T_comm(N) = 2(N − 1)/N · (gradient bytes + 2 · table bytes) / BW,

whose bandwidth BW (the link the ``model`` axis's collectives cross) is not
measured here: the script prints the bytes and leaves BW as an assumption,
and prints no efficiency. Times are device ms from
``fourdgs_tpu_torch.scripts.time_ms``. On the card each half also gets its
wall ms (``time_ms``, back to back), its busy ms and device events per call
from a ``torch.profiler`` trace (``profile_render_torch.device_time``) and
its idle share, 1 − busy / wall: how much of the half the card waits on the
host. The traces come after every timing: a profiler session slows the
host's launches for the rest of the process. Writes only ``--out``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

# calls of each half under torch.profiler
PROFILE_REPS = 3


def slab_budget(demand: int) -> int:
    """The per-shard instance budget: the demand × 1.4, rounded up to
    65,536 (``measure_scaling.py:153``)."""
    return max(-(-int(demand * 1.4) // 65536) * 65536, 65536)


def run(device="cuda", size: int = 800, shards=(1, 2, 4, 5, 10), n_points: int = 60_000,
        capacity: int = 65_536, iters: int | None = None, reps: int | None = None) -> dict:
    import torch

    import bench_torch
    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.ops import constants as C
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.ops.preprocess import preprocess
    from fourdgs_tpu_torch.render import CameraArrays, activated_gaussians
    from fourdgs_tpu_torch.scripts import header, time_ms

    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    to_trace = []

    def measure(fn) -> dict:
        """Device ms and wall ms of ``fn`` (on the card, ``fn`` is traced
        at the end)."""
        dev_ms, wall_ms = time_ms(fn, dev, **timing)
        out = {"ms": dev_ms, "wall_ms": wall_ms}
        if cuda:
            to_trace.append((out, fn))
        return out

    w = bench_torch.build_workload(height=size, width=size, n_points=n_points,
                                   capacity=capacity, device=dev)
    cfg, state = w.cfg, w.state
    params = state.params
    cam = CameraArrays(*(x[0] for x in w.cams))
    sh = cfg.model.sh_degree
    grid_y = (size + C.TILE_Y - 1) // C.TILE_Y
    P = params["xyz"].shape[0]
    timing = dict(iters=iters, reps=reps)

    def pre_table(prim, alive):
        xyz, sc, rot, op, shs, _ = activated_gaussians(prim, state, cam, "fine")
        op = op.reshape(-1)
        pre = preprocess(xyz, sc, rot, shs, cam.camera_center, cam.world_view,
                         cam.full_proj, cam.tanfovx, cam.tanfovy, size, size, sh,
                         opacities=op, alive=alive)
        return R.payload_table(pre, op, pre.means2d, cfg.tpu.payload_bf16), pre

    keys = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
    a_half_of = {}
    for n in shards:
        pl = P // n
        leaves = {k: params[k][:pl].detach().requires_grad_() for k in keys}
        prim = dict(leaves, deform=params["deform"])

        def a_half(prim=prim, leaves=leaves, pl=pl):
            table, _ = pre_table(prim, state.alive[:pl])
            return torch.autograd.grad(table.to(torch.float32).sum(),
                                       list(leaves.values()))

        with torch.enable_grad():
            a_half_of[n] = measure(a_half)
        print(f"deform+preprocess+table P/{n} ({pl}): {a_half_of[n]['ms']:.3f} ms")

    with torch.no_grad():
        table, pre = pre_table(params, state.alive)
    rects = (pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths, pre.radii)
    bg = torch.zeros(3, device=dev)
    results = []
    for n in shards:
        rows = -(-grid_y // n)
        slab = dict(tile_row_offset=0, tile_rows=rows, tile_row_stride=n)
        with torch.no_grad():
            demand = int(R.rasterize_from_table(
                table, *rects, table[:, 0:2].to(torch.float32), size, size, bg,
                bench_torch.INSTANCE_BUDGET, tile_space=True, **slab).num_rendered)
        budget = slab_budget(demand)
        tab = table.detach().requires_grad_()

        def b_half(tab=tab, budget=budget, slab=slab):
            out = R.rasterize_from_table(tab, *rects, tab[:, 0:2].to(torch.float32),
                                         size, size, bg, budget, tile_space=True, **slab)
            return torch.autograd.grad(out.color[:, :4].sum(), tab)

        with torch.enable_grad():
            blend = measure(b_half)
        results.append(({"n_model": n, "tile_rows": rows, "row_stride": n,
                         "demand": demand, "budget": budget,
                         "pre_fwd_bwd_ms": a_half_of[n]["ms"],
                         "blend_fwd_bwd_ms": blend["ms"]}, a_half_of[n], blend))
        print(f"model={n}: rows={rows} demand={demand} budget={budget} "
              f"blend-half fwd+bwd {blend['ms']:.3f} ms (+pre {a_half_of[n]['ms']:.3f})")

    opt = w.adam_state
    it = [0]

    def full_step():
        nonlocal state, opt
        it[0] += 1
        p, opt, state, _ = w.step(state.params, opt, state, w.cams, w.gts, it[0])
        state = state._replace(params=p)

    with torch.enable_grad():
        full_ms = time_ms(full_step, dev, **timing)[0]
        if to_trace:
            from profile_render_torch import device_time

            for out, fn in to_trace:
                busy, events, _ = device_time(fn, PROFILE_REPS)
                out.update(busy_ms=busy, launches=events, idle=1.0 - busy / out["wall_ms"])
    for row, a, b in results:
        for half, m in (("pre", a), ("blend", b)):
            row.update({f"{half}_{k}": v for k, v in m.items() if k != "ms"})
    slabs = [row for row, _, _ in results]
    rest_ms = max(full_ms - slabs[0]["pre_fwd_bwd_ms"] - slabs[0]["blend_fwd_bwd_ms"], 0.0)
    grad_bytes = sum(x.numel() * 4 for k, x in params.items() if k != "deform") + sum(
        p.numel() * 4 for p in params["deform"].parameters())
    table_bytes = P * (C.FEAT_ROWS * table.element_size() + 10 * 4)
    print(f"full train step: {full_ms:.3f} ms; rest (Adam, loss): {rest_ms:.3f} ms")
    print(f"efficiency(N) ~ T_full / (N * (A(P/N) + B(N) + T_rest + T_comm(N))), "
          f"T_comm(N) = 2(N-1)/N * ({grad_bytes} gradient bytes + 2 * {table_bytes} "
          f"table bytes) / BW; BW, the model axis's link bandwidth, is an assumption "
          f"this script does not measure")
    return {**header(dev), "size": size, "points": n_points, "capacity": P,
            "slabs": slabs, "full_step_ms": full_ms, "rest_ms": rest_ms,
            "gradient_bytes": grad_bytes, "table_bytes": table_bytes,
            "bandwidth": "assumed, not measured"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--shards", default="1,2,4,5,10")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.device, args.size, tuple(int(s) for s in args.shards.split(",")))
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
