"""The parameter-gradient all-reduce of the sharded trainer, timed per
backend (``scripts/measure_multihost.py``'s all-reduce).

    python -m fourdgs_tpu_torch.scripts.measure_multihost [--device cuda]
        [--backends gloo,nccl] [--steps 12] [--out multihost.json]

Per step the sharded trainer sums one gradient tree over the grid
(``parallel/trainer.py``); the JAX script's stand-in for it is a
17.5 MB float32 tree (65,536 × 59 per-Gaussian floats and 500,000 of the
deformation, ``MULTIHOST.json``). For each backend this all-reduces that
tree (``parallel.collectives.psum``: one packed buffer) in a world of one
rank and of two, each rank a process of its own (``parallel/launch.py``),
``--steps`` times after a warm-up, and reports the ms per all-reduce of
the slowest rank and the bytes over that time. gloo's two ranks share one
card; nccl needs a GPU per rank, so its two-rank world runs only where the
host has two (the result says so otherwise). Writes only ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

GRAD_PRIM = (65536, 59)
GRAD_DEFORM = 500_000


def rank_allreduce(device: str, steps: int) -> dict:
    """One rank: the tree's all-reduce, timed on the host around a
    synchronize."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fourdgs_tpu_torch.parallel.collectives import psum

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count()
                           if dist.get_backend() == "nccl" else 0)
        torch.cuda.set_device(dev)
    rng = np.random.default_rng(7)   # the same tree on every rank
    tree = [torch.tensor(rng.standard_normal(GRAD_PRIM, dtype=np.float32), device=dev),
            torch.tensor(rng.standard_normal(GRAD_DEFORM, dtype=np.float32), device=dev)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = psum(tree, dist.group.WORLD)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = psum(tree, dist.group.WORLD)
    sync()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return {"rank": dist.get_rank(), "ms": ms,
            "checksum": float(out[0][0, 0]) / dist.get_world_size()}


def run(device="cuda", backends=("gloo", "nccl"), steps: int = 12) -> dict:
    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.parallel.launch import run_ranks
    from fourdgs_tpu_torch.scripts import header

    dev = resolve_device(device)
    n_gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
    nbytes = (GRAD_PRIM[0] * GRAD_PRIM[1] + GRAD_DEFORM) * 4
    rows = []
    for backend in backends:
        for world in (1, 2):
            if backend == "nccl" and world > n_gpus:
                print(f"{backend} x {world}: not run (nccl needs a GPU per rank; "
                      f"{n_gpus} GPU(s) here)")
                rows.append({"backend": backend, "world": world,
                             "not_run": f"{n_gpus} GPU(s) for {world} ranks"})
                continue
            with tempfile.TemporaryDirectory(prefix="measure_multihost_") as tmp:
                res = run_ranks("fourdgs_tpu_torch.scripts.measure_multihost:rank_allreduce",
                                world, dict(device=str(dev), steps=steps), tmp,
                                backend=backend, timeout=600, threads=4)
            ms = max(r["ms"] for r in res)
            rows.append({"backend": backend, "world": world, "ms": ms,
                         "gb_per_s": nbytes / ms / 1e6,
                         "ranks_agree": len({r["checksum"] for r in res}) == 1})
            print(f"{backend} x {world}: all-reduce of {nbytes / 1e6:.1f} MB "
                  f"{ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s)")
    return {**header(dev), "tree_bytes": nbytes, "steps": steps, "runs": rows,
            "cpus": os.cpu_count()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backends", default="gloo,nccl")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.device, tuple(args.backends.split(",")), args.steps)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
