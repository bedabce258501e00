"""Where the time of one fine-stage train step of the PyTorch + CUDA port goes.

    python3 profile_train_torch.py [--reps 5] [--capacity 65536]

Builds the train phase of ``chip_smoke.py`` (the ``lego`` preset at full
width, 60,000 Gaussians, 800×800, batch 1, a GT rendered from a second
seeded scene) on one NVIDIA card, in ``--capacity`` rows (the dead rows
run through every per-Gaussian op, as in training after a capacity
growth), takes 3 warm-up steps, then times the whole step and each of its
parts run alone, on the same inputs:

- the forward (render in tile space with the carrier, loss, regularizer);
- the backward (one ``torch.autograd.grad`` over the step's graph, kept);
- K2 and the per-Gaussian segment sum alone, at the step's shapes; of K2's
  stage, the kernel's own device time apart from the wrapper's zeroing of
  ``dfeat``;
- ``sanitize_grads`` + Adam, and the densification statistics.

Columns as in ``profile_render_torch.py``: ``wall_ms`` (the host's clock
around the call run alone and a synchronize, median), ``device_ms`` (the card's busy time per call from
``torch.profiler``), ``launches`` (device events per call) and ``idle``
(1 − device_ms / wall_ms). Prints the card's name and power limit, a table,
and as the last line one JSON object with the same numbers. Needs CUDA;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--capacity", type=int, default=65_536,
                    help="rows of the Gaussian set (60,000 live)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_torch: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from fourdgs_tpu_torch import render as TR
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.models import densify as dens
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.ops import rasterize as R
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.scripts import time_ms
    from fourdgs_tpu_torch.train import adam
    from fourdgs_tpu_torch.train.loop import make_train_step, sanitize_grads
    from fourdgs_tpu_torch.utils.losses import tile_image
    from profile_render_torch import device_time

    card = scripts.card()
    print(card)

    dev = torch.device("cuda")
    cfg = load_config(cs.LEGO)
    cfg.tpu.capacity = args.capacity
    W, H, deg = cs.WIDTH, cs.HEIGHT, cfg.model.sh_degree
    state = cs.bench_scene(cfg, seed=0, device=dev)
    cam = TR.CameraArrays.from_camera(cs.ring_camera(0, cs.N_TIMED), device=dev)
    cams = TR.CameraArrays(*(x[None] for x in cam))
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        gt_state = cs.bench_scene(cfg, seed=1, device=dev)
        gt = tile_image(TR.render(gt_state.params, gt_state, cam, cfg, W, H,
                                  "fine", bg, deg, device=dev).color,
                        pad_cols=2)[None]
    step_fn = make_train_step(cfg, W, H, "fine", deg, device=dev)
    params, opt = state.params, adam.init(state.params)
    it = 0

    def step():
        nonlocal params, opt, state, it
        it += 1
        with torch.enable_grad():
            params, opt, state, _ = step_fn(params, opt, state, cams, gt, it)

    for _ in range(cs.N_WARM):
        step()

    # the step's parts, on the state after the warm-up
    P = params["xyz"].shape[0]
    gts_cmp = step_fn.gt_tiles(gt)

    def graph():
        prim = {k: params[k].detach().requires_grad_() for k in G.PRIMITIVE_KEYS}
        leaves = dict(prim, deform=params["deform"])
        carrier = torch.zeros((1, P, 2), device=dev, requires_grad=True)
        with torch.enable_grad():
            loss, _, _, outs = step_fn.loss_fn(leaves, carrier, state, cams, gts_cmp)
        return loss, [x for _, x in adam.named_leaves(leaves)] + [carrier], outs

    loss, inputs, outs = graph()

    def backward():
        return torch.autograd.grad(loss, inputs, retain_graph=True,
                                   materialize_grads=True)

    grads = backward()
    g_leaves, g_carrier = list(grads[:-1]), grads[-1]
    lr_tree = adam.lr_tree_for_params(params, adam.learning_rates(it, cfg.opt, 1.0))

    def optimizer():
        adam.update(params, adam.tree_like(params, sanitize_grads(g_leaves)),
                    opt, lr_tree)

    with torch.no_grad():
        xyz, sc, rot, op, shs, _ = TR.activated_gaussians(params, state, cam, "fine")
        bi = R.blend_inputs(xyz, sc, rot, op, shs, cam.camera_center,
                            cam.world_view, cam.full_proj, cam.tanfovx,
                            cam.tanfovy, W, H, deg, cfg.tpu.instance_budget,
                            alive=state.alive)
        fwd = (bi.feat, bi.bins.tile_start, bi.bins.tile_stop, bi.row_off, bg)
        out5 = blend.blend_forward(*fwd, bi.grid_x)
        g_out = torch.randn_like(out5) * 1e-6
        d_feat = blend.blend_backward(*fwd, out5, g_out, bi.grid_x)

    # the whole step runs last: it updates the parameters in place, which
    # the kept graph of the backward stage saved
    stages = {
        "forward: render + loss": graph,
        "backward: autograd.grad": backward,
        "  K2 (blend backward) alone": lambda: blend.blend_backward(
            *fwd, out5, g_out, bi.grid_x),
        "  segment sum alone": lambda: R.payload_grad(d_feat, bi.bins, P),
        "sanitize + Adam": optimizer,
        "densification stats": lambda: dens.add_densification_stats(
            state, g_carrier[0], outs[0].radii, W, H),
        "train step (whole)": step,
    }
    rows = {}
    for name, fn in stages.items():
        wall = time_ms(fn, dev, iters=1, reps=args.reps)[1]
        busy, n_dev, by_name = device_time(fn, args.reps)
        rows[name] = {"wall_ms": wall, "device_ms": busy, "launches": n_dev,
                      "idle": 1.0 - busy / wall}
        if name == "train step (whole)":
            top = by_name.most_common(12)
        if name == "  K2 (blend backward) alone":
            k2_kernel = sum(ms for n, ms in by_name.items() if "blend_backward_kernel" in n)
    rows = {"train step (whole)": rows.pop("train step (whole)"), **rows}
    if rows["train step (whole)"]["launches"] == 0:
        raise AssertionError("torch.profiler recorded no device activity")

    print(f"{'stage':30s} {'wall_ms':>10s} {'device_ms':>10s} "
          f"{'launches':>9s} {'idle':>7s}")
    for name, r in rows.items():
        print(f"{name:30s} {r['wall_ms']:10.4f} {r['device_ms']:10.4f} "
              f"{r['launches']:9.1f} {r['idle']:7.3f}")
    print(f"K2 kernel alone (torch.profiler): {k2_kernel:.4f} ms of the stage's "
          f"{rows['  K2 (blend backward) alone']['device_ms']:.4f} ms of device time "
          f"(the rest zeroes dfeat)")
    print("busiest device work of the whole step (ms per step):")
    for name, ms in top:
        print(f"  {ms:9.4f}  {name[:100]}")
    print(json.dumps({"card": card, "capacity": args.capacity, "stages": rows,
                      "k2_kernel_ms": k2_kernel,
                      "top_device_ms": [[n[:100], ms] for n, ms in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
