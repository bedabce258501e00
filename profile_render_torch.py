"""Where the time of one fine-stage render of the PyTorch + CUDA port goes.

    python3 profile_render_torch.py [--reps 5]

Renders the scene and cameras of ``chip_smoke.py`` (the ``lego`` preset at
full width, 60,000 Gaussians, 800×800) on one NVIDIA card, then times the
whole render and each of its stages run alone, on the same inputs:

- ``wall_ms``: median milliseconds per call on the host's clock, the call
  run alone and ended by a synchronize (the host's launch time included;
  ``fourdgs_tpu_torch.scripts.time_ms``);
- ``device_ms``: the card's busy time per call, the summed durations of the
  kernels, copies and fills that ``torch.profiler`` records over ``--reps``
  calls;
- ``launches``: kernels, copies and fills per call;
- ``idle``: 1 − device_ms / wall_ms, the share of the call the card waits on
  the host.

Prints the card's name and power limit, a table, and as the last line one
JSON object with the same numbers. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter


def device_time(fn, reps: int):
    """(busy ms per call, device events per call, per-name busy ms per call)
    of ``fn`` over ``reps`` calls, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = Counter()
    n_dev = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] += e.self_device_time_total / 1e3 / reps
            n_dev += e.count
    return sum(by_name.values()), n_dev / reps, by_name


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_render_torch: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)

    import chip_smoke as cs
    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch.ops.binning import bin_gaussians_fast
    from fourdgs_tpu_torch.ops.preprocess import preprocess
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.scripts import time_ms

    card = scripts.card()
    print(card)

    dev = torch.device("cuda")
    cfg = load_config(cs.LEGO)
    cfg.tpu.capacity = cs.CAPACITY
    state = cs.bench_scene(cfg, device=dev)
    bg = torch.ones(3, device=dev)
    cam = TR.CameraArrays.from_camera(
        cs.ring_camera(cs.N_TIMED // 2, cs.N_TIMED), device=dev)
    W, H, deg = cs.WIDTH, cs.HEIGHT, cfg.model.sh_degree

    # the inputs of each stage, made once by the stage before it
    xyz, sc, rot, op, shs, _ = TR.activated_gaussians(state.params, state, cam, "fine")
    op = op.reshape(-1)
    pre_args = (xyz, sc, rot, shs, cam.camera_center, cam.world_view,
                cam.full_proj, cam.tanfovx, cam.tanfovy, W, H, deg)
    pre = preprocess(*pre_args, opacities=op, alive=state.alive)
    table = R.build_table(pre, op, pre.means2d)
    gx, gy = -(-W // 16), -(-H // 16)
    k_pad = -(-cfg.tpu.instance_budget // 128) * 128
    bins = bin_gaussians_fast(pre.tile_min, pre.tile_max, pre.tiles_touched,
                              pre.depths, gx, gy, k_pad)
    feat = table.index_select(0, bins.gauss_id).T.contiguous()
    row_off = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    out5 = blend.blend_forward(feat, bins.tile_start, bins.tile_stop, row_off, bg, gx)

    stages = {
        "render (whole)": lambda: TR.render(
            state.params, state, cam, cfg, W, H, "fine", bg, deg, device=dev),
        "deformation + activations": lambda: TR.activated_gaussians(
            state.params, state, cam, "fine"),
        "preprocess": lambda: preprocess(*pre_args, opacities=op, alive=state.alive),
        "payload table": lambda: R.build_table(pre, op, pre.means2d),
        "binning": lambda: bin_gaussians_fast(
            pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths, gx, gy, k_pad),
        "payload gather": lambda: table.index_select(0, bins.gauss_id).T.contiguous(),
        "blend (K1)": lambda: blend.blend_forward(
            feat, bins.tile_start, bins.tile_stop, row_off, bg, gx),
        "untile": lambda: [R.untile(out5[:, s], gx, gy, W, H).contiguous()
                           for s in (slice(0, 3), slice(3, 4), slice(4, 5))],
    }
    rows = {}
    top = None
    for name, fn in stages.items():
        wall = time_ms(fn, dev, iters=1, reps=args.reps)[1]
        busy, n_dev, by_name = device_time(fn, args.reps)
        rows[name] = {"wall_ms": wall, "device_ms": busy, "launches": n_dev,
                      "idle": 1.0 - busy / wall}
        if top is None:
            top = by_name.most_common(12)
    if rows["render (whole)"]["launches"] == 0:
        raise AssertionError("torch.profiler recorded no device activity")

    print(f"{'stage':28s} {'wall_ms':>10s} {'device_ms':>10s} "
          f"{'launches':>9s} {'idle':>7s}")
    for name, r in rows.items():
        print(f"{name:28s} {r['wall_ms']:10.4f} {r['device_ms']:10.4f} "
              f"{r['launches']:9.1f} {r['idle']:7.3f}")
    print("busiest device work of the whole render (ms per view):")
    for name, ms in top:
        print(f"  {ms:9.4f}  {name[:100]}")
    print(json.dumps({"card": card, "stages": rows,
                      "top_device_ms": [[n[:100], ms] for n, ms in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
