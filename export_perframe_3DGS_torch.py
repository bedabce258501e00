#!/usr/bin/env python3
"""Export per-timestamp static 3DGS models from a trained 4DGS model, with
the PyTorch + CUDA port.

The port's ``export_perframe_3DGS.py``:

    python3 export_perframe_3DGS_torch.py --model_path output/<expname>
        [--source_path <data>] [--iteration N] [--configs ...] [--device cuda|cpu]

For each test-camera timestamp (the train cameras' where there is no test
split) it runs the deformation alone at that time (:func:`get_state_at_time`,
the reference's utils/render_utils.py:3-17) and writes a 3DGS-standard PLY,
``<model_path>/gaussian_pertimestamp/time_<index:05d>.ply``, that any static
3DGS viewer loads. The training config is replayed from ``cfg_args.json``
unless ``--configs`` is given, as ``render_torch.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os


def get_state_at_time(params, state, time: float):
    """The deformation alone at ``time`` (no rasterization): raw
    (pre-activation) parameters in, deformed raw ``(xyz, scaling, rotation,
    opacity, shs)`` out. As the reference (render_utils.py:17) and JAX's
    copy, the opacity returned is the **undeformed** one."""
    import torch

    from fourdgs_tpu_torch.models import gaussians as G

    xyz = params["xyz"]
    t = torch.full((xyz.shape[0],), float(time), dtype=torch.float32, device=xyz.device)
    with torch.no_grad():
        out_xyz, out_scales, out_rot, _out_op, out_shs = params["deform"](
            state.aabb, xyz, params["scaling"], params["rotation"], params["opacity"],
            G.get_features(params), t)
    return out_xyz, out_scales, out_rot, params["opacity"], out_shs


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--source_path", "-s", default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--configs", type=str, default=None)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = parser.parse_args(argv)

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import config_from_dict, load_config
    from fourdgs_tpu_torch.data import ply as ply_lib
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.train import checkpoint

    dev = resolve_device(args.device)
    cfg_dump = os.path.join(args.model_path, "cfg_args.json")
    if os.path.exists(cfg_dump) and args.configs is None:
        with open(cfg_dump) as f:
            cfg = config_from_dict(json.load(f))
    else:
        cfg = load_config(args.configs)
    if args.source_path:
        cfg.model.source_path = args.source_path

    pc_dir = os.path.join(args.model_path, "point_cloud")
    iters = [int(d.rsplit("_", 1)[1]) for d in os.listdir(pc_dir)
             if d.startswith("iteration_")]
    iteration = args.iteration if args.iteration > 0 else max(iters)
    state = checkpoint.load_snapshot(os.path.join(pc_dir, f"iteration_{iteration}"),
                                     cfg, device=dev)

    data = load_scene(cfg)
    out_dir = os.path.join(args.model_path, "gaussian_pertimestamp")
    os.makedirs(out_dir, exist_ok=True)
    alive = state.alive.cpu().numpy()
    times = ([lc.camera.time for lc in data.test_cameras]
             or [lc.camera.time for lc in data.train_cameras])
    print(f"exporting {len(times)} timestamps ...")
    paths = []
    for index, time in enumerate(times):
        xyz, scales, rot, opacity, shs = get_state_at_time(state.params, state, time)
        n_pts = shs.shape[0]
        params_t = {"xyz": xyz, "f_dc": shs[:, 0, :],
                    "f_rest": shs[:, 1:, :].reshape(n_pts, -1), "scaling": scales,
                    "rotation": rot, "opacity": opacity}
        paths.append(os.path.join(out_dir, f"time_{index:05d}.ply"))
        ply_lib.save_gaussian_ply(
            paths[-1], {k: v.detach().cpu().numpy() for k, v in params_t.items()}, alive)
    print(f"done → {out_dir}")
    return paths


if __name__ == "__main__":
    main()
