"""Multi-process smoke test of the sharded trainer: one step across two
processes (``scripts/multihost_smoke.py``). Run it as one rank of a
two-process world:

    python -m fourdgs_tpu_torch.scripts.multihost_smoke <rank> [coordinator]
        [--device cuda|cpu]

``coordinator``: a port on 127.0.0.1 (29517 by default, as in JAX) or a
store URL such as ``file:///tmp/store``. Each process opens its rank of the
world (``parallel.multihost.initialize`` over gloo, the JAX smoke's
transport, so two ranks may share one card), builds
``make_hybrid_mesh(data=2, model=1)``, loads only its own camera and GT
(``local_batch_slice``, ``host_local_batch``), takes one step of the sharded
trainer from the same seeded scene and prints ``RANK <r> OK loss=<v>``. Both
ranks must print the same loss: the step leaves every rank with the same
state. On the card both ranks use ``cuda:0``, or ``cuda:<rank>`` where the
host has two GPUs.
"""

from __future__ import annotations

import argparse

import numpy as np


def tiny_cfg(capacity: int = 256):
    """``__graft_entry__._tiny_cfg`` on the port's config."""
    from fourdgs_tpu_torch.configs.core import KPlanesConfig, load_config

    cfg = load_config()
    cfg.tpu.capacity = capacity
    cfg.tpu.instance_budget = 4096
    cfg.tpu.tile_budget = 128
    cfg.tpu.blend_chunk = 64
    cfg.hidden.kplanes_config = KPlanesConfig(resolution=(8, 8, 8, 4),
                                              output_coordinate_dim=8)
    cfg.hidden.multires = (1, 2)
    cfg.hidden.net_width = 32
    cfg.hidden.defor_depth = 1
    cfg.hidden.no_dx = False
    cfg.model.sh_degree = 1
    cfg.model.white_background = False
    cfg.tpu.backend = "pallas"
    return cfg


def camera(time: float, size: int):
    """``__graft_entry__._camera``: a fixed orbit camera at ``time``."""
    import math

    from fourdgs_tpu_torch.utils import graphics

    ang = 0.7
    eye = np.array([2.5 * math.sin(ang), 0.4, -2.5 * math.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)
    T = -R.T @ eye
    fov = math.pi / 3
    return graphics.make_camera(R, T, fov, fov, size, size, time=time)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("coordinator", nargs="?", default="29517")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.parallel import multihost, trainer
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.train import adam

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
    coord = (args.coordinator if "://" in args.coordinator
             else f"127.0.0.1:{args.coordinator}")
    multihost.initialize(coordinator_address=coord, num_processes=2,
                         process_id=args.rank, backend="gloo", device=dev)
    try:
        mesh = multihost.make_hybrid_mesh(2, 1)
        cfg = tiny_cfg(capacity=256)
        cfg.opt.lambda_dssim = 0.0
        rng = np.random.default_rng(0)
        pts = rng.uniform(-0.8, 0.8, (128, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (128, 3)).astype(np.float32)
        state = G.create_from_pcd(cfg, pts, cols, 1.0, device=dev)
        opt = adam.init(state.params)
        state = trainer.replicate(mesh, state)
        opt = trainer.replicate(mesh, opt)

        size, global_batch = 32, 2
        sl = multihost.local_batch_slice(global_batch, mesh)
        if sl != slice(args.rank, args.rank + 1):
            raise AssertionError(f"rank {args.rank}'s cameras {sl}")
        # each rank makes only its own cameras and frames
        cams = [CameraArrays.from_camera(camera(i / 2, size), device=dev)
                for i in range(global_batch)][sl]
        cams = CameraArrays(*(torch.stack(xs) for xs in zip(*cams)))
        gts = np.random.default_rng(7 + args.rank).uniform(
            0, 1, (sl.stop - sl.start, 3, size, size)).astype(np.float32)
        cams, gts = multihost.host_local_batch(mesh, cams, torch.tensor(gts, device=dev))

        step = trainer.make_sharded_train_step(cfg, mesh, size, size, "fine",
                                               active_sh_degree=1, device=dev)
        xyz0 = state.params["xyz"].clone()
        with torch.enable_grad():
            params, opt, state, metrics = step(state.params, opt, state, cams, gts, 1)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"loss {loss}")
        if not float((params["xyz"] - xyz0).abs().max()) > 0.0:
            raise AssertionError("the step moved no parameter")
        # both ranks done with their collectives before either closes its
        # connections
        torch.distributed.barrier()
        print(f"RANK {args.rank} OK loss={loss:.6f}", flush=True)
        return loss
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
