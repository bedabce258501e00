#!/usr/bin/env python3
"""Merge several trained 4DGS models into one rendered sequence, with the
PyTorch + CUDA port.

The port's ``merge_many_4dgs.py`` (the reference's merge_many_4dgs.py:59-231):
for each video camera (the test cameras where the scene has no video path),
each model's deformed state at the camera's time
(``export_perframe_3DGS_torch.get_state_at_time``), a per-model rotation,
translation and scale that carries each extra model into the first one's
frame, then every live Gaussian of every model rasterized in one pass:

    python3 merge_many_4dgs_torch.py --model_paths out/a out/b -s <scene>
        [--motion_bias "x,y,z" ...] [--rotation_bias "rotz,roty" ...]
        [--scale_bias s ...] [--iteration N] [--configs ...]
        [--output merged_render] [--device cuda|cpu]

Frames go to ``<output>/<index:05d>.png``. JAX renders the merged set with
its ``tile`` backend (``ops/tiled.py::rasterize_tiled``, plain tensor code
in the port too); the port renders it with ``ops/rasterize.py::rasterize_pallas``
(the CUDA tile blend, K1, once a frame on the card) at JAX's instance budget
of 2^20. The two rasterizers compute the same function in float32 (the
association contract of ``tests/test_pallas_raster.py:14-21``: a pixel
riding T_STOP may flip one instance), except that ``rasterize_tiled`` also
caps each tile at 4,096 instances and the port does not.
"""

from __future__ import annotations

import argparse
import json
import os

# JAX's merged render's instance budget (merge_many_4dgs.py:145)
INSTANCE_BUDGET = 1 << 20


def rotate_point_cloud(xyz, motion_bias, rotation_bias_deg, scale):
    """Uniform scale, then the rotation about Z and Y (degrees), then the
    translation (the reference's rotate_point_cloud)."""
    import numpy as np
    import torch

    rz, ry = [float(a) * np.pi / 180.0 for a in rotation_bias_deg]
    cz, sz = np.cos(rz), np.sin(rz)
    cy, sy = np.cos(ry), np.sin(ry)
    Rz = torch.tensor([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=torch.float32,
                      device=xyz.device)
    Ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=torch.float32,
                      device=xyz.device)
    return (xyz * scale) @ (Rz @ Ry).T + torch.tensor(
        np.asarray(motion_bias, np.float32), device=xyz.device)


def load_model(model_path, iteration, configs, device="cuda"):
    """(config, state) of ``model_path``'s snapshot (the last one unless
    ``iteration`` > 0), its config replayed from ``cfg_args.json`` unless
    ``configs`` is given, as ``render_torch.py`` does."""
    from fourdgs_tpu_torch.configs.core import config_from_dict, load_config
    from fourdgs_tpu_torch.train import checkpoint

    cfg_dump = os.path.join(model_path, "cfg_args.json")
    if os.path.exists(cfg_dump) and configs is None:
        with open(cfg_dump) as f:
            cfg = config_from_dict(json.load(f))
    else:
        cfg = load_config(configs)
    pc_dir = os.path.join(model_path, "point_cloud")
    iters = [int(d.rsplit("_", 1)[1]) for d in os.listdir(pc_dir)
             if d.startswith("iteration_")]
    it = iteration if iteration > 0 else max(iters)
    return cfg, checkpoint.load_snapshot(os.path.join(pc_dir, f"iteration_{it}"), cfg,
                                         device=device)


def merged_gaussians(models, time: float, motion, rot, scl):
    """The activated Gaussians of every model at ``time``, concatenated
    (merge_many_4dgs.py:109-138): the live ones only, the scale bias on the
    activated scales, the quaternions normalised, the opacity undeformed,
    the SH padded with zeros to the largest degree. Returns (xyz, scales,
    rotations, opacities, shs, SH degree)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from export_perframe_3DGS_torch import get_state_at_time

    parts = []
    for mi, (_, state) in enumerate(models):
        alive = state.alive
        xyz, scales, rots_q, opacity, shs = get_state_at_time(state.params, state, time)
        with torch.no_grad():
            scales_act = torch.exp(scales)[alive]
            xyz = xyz[alive]
            if mi > 0:
                xyz = rotate_point_cloud(xyz, motion[mi - 1], rot[mi - 1], scl[mi - 1])
                scales_act = scales_act * scl[mi - 1]
            rots_n = rots_q[alive]
            rots_n = rots_n / torch.clamp(
                torch.linalg.vector_norm(rots_n, dim=-1, keepdim=True), min=1e-12)
            parts.append([xyz, scales_act, rots_n,
                          torch.sigmoid(opacity[alive]).reshape(-1), shs[alive]])
    kmax = max(p[4].shape[1] for p in parts)
    for p in parts:
        p[4] = F.pad(p[4], (0, 0, 0, kmax - p[4].shape[1]))
    merged = [torch.cat(xs) for xs in zip(*parts)]
    return (*merged, int(np.sqrt(kmax)) - 1)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_paths", nargs="+", required=True)
    parser.add_argument("--source_path", "-s", required=True,
                        help="scene supplying the video camera path")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--configs", type=str, default=None)
    parser.add_argument("--motion_bias", nargs="*", default=[],
                        help="per-extra-model 'x,y,z'")
    parser.add_argument("--rotation_bias", nargs="*", default=[],
                        help="per-extra-model 'rotz,roty' degrees")
    parser.add_argument("--scale_bias", nargs="*", type=float, default=[])
    parser.add_argument("--output", type=str, default="merged_render")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = parser.parse_args(argv)

    import time

    import numpy as np
    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.utils import png

    dev = resolve_device(args.device)
    models = [load_model(p, args.iteration, args.configs, dev) for p in args.model_paths]
    cfg0 = models[0][0]
    cfg0.model.source_path = args.source_path
    data = load_scene(cfg0)
    cams = data.video_cameras or [lc.camera for lc in data.test_cameras]
    os.makedirs(args.output, exist_ok=True)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg0.model.white_background else [0.0, 0.0, 0.0],
                      device=dev)

    n_extra = len(models) - 1
    motion = [tuple(map(float, m.split(","))) for m in args.motion_bias]
    motion += [(0.0, 0.0, 0.0)] * (n_extra - len(motion))
    rot = [tuple(m.split(",")) for m in args.rotation_bias]
    rot += [("0", "0")] * (n_extra - len(rot))
    scl = list(args.scale_bias) + [1.0] * (n_extra - len(args.scale_bias))

    t0 = time.perf_counter()
    for fi, cam in enumerate(cams):
        xyz, scales, rots, op, shs, sh_degree = merged_gaussians(
            models, cam.time, motion, rot, scl)
        ca = CameraArrays.from_camera(cam, device=dev)
        with torch.no_grad():
            out = rasterize_pallas(
                xyz, scales, rots, op, shs, ca.camera_center, ca.world_view,
                ca.full_proj, ca.tanfovx, ca.tanfovy, cam.width, cam.height, sh_degree,
                bg, instance_budget=INSTANCE_BUDGET)
        img = (np.clip(out.color.cpu().numpy(), 0, 1).transpose(1, 2, 0)
               * 255).astype(np.uint8)
        png.write_png(os.path.join(args.output, f"{fi:05d}.png"), img)
        if fi % 20 == 0:
            print(f"{fi}/{len(cams)}")
    wall = time.perf_counter() - t0
    print(f"done → {args.output} ({len(cams)} frames in {wall:.2f}s)")
    return {"frames": len(cams), "seconds": wall, "output": args.output}


if __name__ == "__main__":
    main()
