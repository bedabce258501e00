#!/usr/bin/env python3
"""Train a 4D Gaussian Splatting model with the PyTorch + CUDA port.

The port's ``train.py``, with its flags and outputs:

    python3 train_torch.py -s <dataset path> --configs <preset.py> --expname <name>
                           [--test_iterations ...] [--save_iterations ...]
                           [--checkpoint_iterations ...] [--start_checkpoint ...]
                           [--override opt.iterations=100 ...] [--device cuda|cpu]

Stages: coarse (static canonical model) then fine (deformation on). Writes
``cfg_args.json``, ``timing_report.json``, ``training_logs.json``,
``events.jsonl``, ``eval_log.jsonl``, ``eval_images/``, snapshots
(``point_cloud/iteration_*``) and checkpoints (``chkpnt_<stage>_<iter>``)
under ``output/<expname>/`` or ``--model_path``; ``--start_checkpoint``
resumes from a checkpoint (a fine one skips the coarse stage). Every
dataset type of ``train.py`` loads; lazy frames (DyNeRF, HyperNeRF, COLMAP,
MultipleView, Panoptic) are decoded per batch by the native prefetcher (a
JPEG frame by the ref's decoder), and the eval calls them. The eval's PSNR
of a test view with a covisible mask (HyperNeRF) is the masked PSNR.
``--debug_mode`` writes render|GT panels to ``debug_images/`` every 100
iterations, and a preset's ``render_process`` GT|render|depth frames to
``train_render/``. ``--port <n>`` serves the SIBR network viewer on
127.0.0.1:<n> (``fourdgs_tpu_torch/viewer.py``; 0 picks a free port), polled
before every iteration. ``--gradient_tracking`` records the per-group
gradient statistics every 10 iterations and writes
``gradient_report.json``, ``gradient_curves.png`` and the per-timestamp
``gradient_timeline.{json,png}`` of the first train camera after the run
(the PNGs only where matplotlib is installed). ``--device cpu`` runs the
plain PyTorch versions of the kernels.

``--mesh data=D,model=M`` trains through the sharded step
(``fourdgs_tpu_torch/parallel/trainer.py``: cameras over ``data``,
interleaved tile rows over ``model``) on D·M ranks, one process each. On
one host the command starts them itself, one per local GPU (it raises when
the host has fewer; nccl needs one GPU per rank), or over CPU gloo with
``--device cpu``; a world of one rank runs in this process.
``--distributed`` makes this process one rank of a larger world, from
``--coordinator_address`` (``host:port``), ``--num_processes`` and
``--process_id``, or from torchrun's environment; its device is
``--device`` where that names an index, else ``cuda:LOCAL_RANK``; a process
group the caller already opened is kept. ``--shard_primitives`` shards the
per-Gaussian parameters and their moments over ``model``. The grid's first
rank alone writes the outputs and serves the viewer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def spawn_local_world(argv: list[str], mesh: str, device: str, n: int) -> None:
    """Start ``n`` ranks of this command on this host, rank r on
    ``cuda:r`` (or the CPU), and wait for them; a failed rank stops the
    others and raises."""
    import tempfile

    import torch

    from fourdgs_tpu_torch.parallel.launch import spawn

    if torch.device(device).type != "cpu":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"--mesh {mesh} needs {n} GPUs, one per rank; this host "
                             f"has {have} (several ranks on one GPU need gloo: "
                             "open the process group and pass --distributed)")
    with tempfile.TemporaryDirectory(prefix="train_torch_ranks_") as tmp:
        cmds = [[sys.executable, os.path.abspath(__file__), *argv, "--distributed",
                 "--coordinator_address", f"file://{tmp}/store",
                 "--num_processes", str(n), "--process_id", str(r)] for r in range(n)]
        envs = [{"LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n)} for r in range(n)]
        spawn(cmds, None, tmp, envs=envs, inherit_first=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-s", "--source_path", type=str, required=True)
    parser.add_argument("--configs", type=str, default=None)
    parser.add_argument("--expname", type=str, default="default")
    parser.add_argument("--model_path", type=str, default="")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[3000, 7000, 14000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[14000, 20000, 30000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=6666)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--gradient_tracking", action="store_true")
    parser.add_argument("--debug_mode", action="store_true")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--shard_primitives", action="store_true")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--override", nargs="*", default=[],
                        help="dotted config overrides, e.g. opt.iterations=100")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.parallel import multihost
    from fourdgs_tpu_torch.parallel.mesh import parse_mesh_arg

    sizes = parse_mesh_arg(args.mesh) if args.mesh else None
    if (sizes and not args.distributed and not dist.is_initialized()
            and sizes["data"] * sizes["model"] > 1):
        spawn_local_world(list(sys.argv[1:] if argv is None else argv), args.mesh,
                          args.device, sizes["data"] * sizes["model"])
        return None
    device = args.device
    if args.distributed and device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    opened = False
    if args.distributed or sizes:
        # before any other collective use (train.py:85-92); a world of one
        # process when --mesh alone asks for one rank
        opened = multihost.initialize(args.coordinator_address, args.num_processes,
                                      args.process_id, device=device)
    try:
        return _train(args, sizes, device)
    finally:
        if opened:
            multihost.shutdown()


def _train(args, sizes, device):
    import numpy as np
    import torch
    import torch.distributed as dist

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import config_to_dict, load_config
    from fourdgs_tpu_torch.data.hypernerf import read_mask
    from fourdgs_tpu_torch.data.scene import build_scene
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.render import CameraArrays, render as render_fn
    from fourdgs_tpu_torch.train import adam, checkpoint
    from fourdgs_tpu_torch.train.loop import scene_reconstruction
    from fourdgs_tpu_torch.utils import losses as loss_lib
    from fourdgs_tpu_torch.utils.observability import EventLog, log_scene_stats
    from fourdgs_tpu_torch.utils.timer import DetailedTimer, Timer

    dev = resolve_device(device)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    overrides = {}   # group.knob=value; JSON-looking values parsed (train.py)
    for item in args.override:
        k, _, v = item.partition("=")
        overrides[k] = json.loads(v) if v and v[0] in "[{0123456789-tf.\"" else v
    cfg = load_config(args.configs, **overrides)
    cfg.model.source_path = args.source_path
    model_path = args.model_path or os.path.join("output", args.expname)
    cfg.model.model_path = model_path
    if main_rank:
        os.makedirs(model_path, exist_ok=True)
        # the config replay dump render_torch.py reads (JSON, not eval())
        with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
            json.dump(config_to_dict(cfg), f, indent=1, default=str)

    mesh = None
    if args.shard_primitives:
        cfg.tpu.shard_primitives = True
    if sizes:
        from fourdgs_tpu_torch.parallel.multihost import make_hybrid_mesh

        mesh = make_hybrid_mesh(sizes["data"], sizes["model"])
        if mesh is None:
            print(f"rank {dist.get_rank()} lies outside the mesh; it does not train")
            return None
        print(f"mesh: data={sizes['data']} x model={sizes['model']} over "
              f"{dist.get_world_size()} rank(s); this rank (d, m) = ({mesh.d}, {mesh.m}) "
              f"on {dev} over {dist.get_backend()}")
        if args.gradient_tracking:
            raise ValueError("--gradient_tracking under --mesh is not supported")

    timer = DetailedTimer(model_path) if main_rank else None
    wall = Timer()
    wall.start()

    print(f"loading scene from {args.source_path} ...")
    scene = build_scene(cfg, args.seed, device=dev)
    state = scene.state
    adam_state = adam.init(state.params)
    print(f"scene: {len(scene.data.train_cameras)} train / "
          f"{len(scene.data.test_cameras)} test cameras, "
          f"extent={scene.cameras_extent:.3f}, "
          f"init points={int(G.count_alive(state))}")

    start_stage, start_iter = "coarse", 0
    if args.start_checkpoint:
        state, adam_state, start_iter = checkpoint.load_checkpoint(
            args.start_checkpoint, cfg, device=dev)
        if "fine" in args.start_checkpoint:
            start_stage = "fine"
        print(f"resumed from {args.start_checkpoint} ({start_stage} @ {start_iter})")

    cams = [(lc.camera, lc.image) for lc in scene.data.train_cameras]
    ev = EventLog(model_path) if main_rank else None
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)

    def run_eval(iteration, stage, cur_state):
        """PSNR/L1 over strided test + train cameras (≤5 each per split;
        training_report, reference train.py:488-538); a view with a
        covisible mask takes the masked PSNR (train.py:189-198)."""
        report = {}
        data = scene.data
        splits = {
            "test": data.test_cameras[::max(len(data.test_cameras) // 5, 1)][:5],
            "train": data.train_cameras[::max(len(data.train_cameras) // 5, 1)][:5],
        }
        for split, lcs in splits.items():
            if not lcs:
                continue
            l1s, psnrs = [], []
            for vi, lc in enumerate(lcs):
                w, h = lc.camera.width, lc.camera.height
                with torch.no_grad():
                    color = render_fn(cur_state.params, cur_state,
                                      CameraArrays.from_camera(lc.camera, device=dev),
                                      cfg, w, h, stage, bg,
                                      cur_state.active_sh_degree, device=dev).color
                gt = np.asarray(lc.image() if callable(lc.image) else lc.image)
                if gt.dtype == np.uint8:
                    gt = gt.astype(np.float32).transpose(2, 0, 1) / 255.0
                gt = torch.tensor(gt[:3], device=dev)
                l1s.append(float(loss_lib.l1_loss(color, gt)))
                mask_path = getattr(lc, "mask_path", None)
                if mask_path and os.path.exists(mask_path):
                    mask = torch.tensor(read_mask(mask_path, w, h), dtype=torch.float32,
                                        device=dev)
                    psnrs.append(float(loss_lib.masked_psnr(color, gt, mask)))
                else:
                    psnrs.append(float(loss_lib.psnr(color[None], gt[None])[0]))
                # first 5 eval views as images (train.py:513-516); the GT
                # once, on the first eval of the run
                ev.add_image(f"{stage}/{split}_view_{vi}/render",
                             color.cpu().numpy(), iteration)
                if iteration == min(args.test_iterations, default=0):
                    ev.add_image(f"{stage}/{split}_view_{vi}/gt",
                                 gt.cpu().numpy(), iteration)
            report[split] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
            ev.add_scalar(f"{stage}/{split}/loss_viewpoint - l1_loss",
                          report[split]["l1"], iteration)
            ev.add_scalar(f"{stage}/{split}/loss_viewpoint - psnr",
                          report[split]["psnr"], iteration)
            print(f"[ITER {iteration}] eval {stage}/{split}: "
                  f"L1 {report[split]['l1']:.5f} PSNR {report[split]['psnr']:.2f}")
        log_scene_stats(ev, cur_state, stage, iteration)
        with open(os.path.join(model_path, "eval_log.jsonl"), "a") as f:
            f.write(json.dumps({"iteration": iteration, "stage": stage, **report}) + "\n")

    def log_fn(iteration, stage, m, cur_state, cur_adam):
        if not main_rank:
            return
        if not args.quiet:
            print(f"[{stage} {iteration:6d}] loss={m['loss']:.5f} "
                  f"psnr={m['psnr']:.2f} points={int(m['n_points'])}")
        ev.add_scalar(f"{stage}/train_loss_patches/l1_loss", m["l1"], iteration)
        ev.add_scalar(f"{stage}/train_loss_patches/total_loss", m["loss"], iteration)
        if iteration in args.test_iterations:
            run_eval(iteration, stage, cur_state)
        if iteration in args.save_iterations:
            checkpoint.save_snapshot(model_path, cur_state, iteration, stage)
        if iteration in args.checkpoint_iterations:
            checkpoint.save_checkpoint(model_path, cur_state, cur_adam, iteration, stage)

    extra_iters = (set(args.save_iterations) | set(args.checkpoint_iterations)
                   | set(args.test_iterations))

    viewer = None
    if args.port is not None and main_rank:
        from fourdgs_tpu_torch.viewer import NetworkGUI

        viewer = NetworkGUI(port=args.port)
        print(f"network viewer listening on 127.0.0.1:{viewer.port}", flush=True)
    tracker = None
    if args.gradient_tracking:
        from fourdgs_tpu_torch.utils.gradient_tracker import GradientTracker

        tracker = GradientTracker(model_path)
    common = dict(timer=timer, event_log=ev, log_fn=log_fn,
                  extra_log_iters=extra_iters, model_path=model_path, device=dev,
                  debug_mode=args.debug_mode, viewer=viewer, gradient_tracker=tracker,
                  source_path=args.source_path, mesh=mesh)

    def report_prefetch(stage, log, iteration):
        """The native prefetcher's frame counts of a stage on lazy frames."""
        if log.prefetch is not None and main_rank:
            print(f"[prefetch] {stage}: {log.prefetch['submitted']} frames submitted, "
                  f"{log.prefetch['native']} decoded natively, "
                  f"{log.prefetch['to_ref']} sent to the ref's decoder")
            for k, v in log.prefetch.items():
                ev.add_scalar(f"{stage}/prefetch/{k}", v, iteration)

    try:
        if start_stage == "coarse":
            state, adam_state, log = scene_reconstruction(
                cfg, state, adam_state, cams, "coarse", cfg.opt.coarse_iterations,
                scene.cameras_extent, rng_seed=args.seed, **common)
            report_prefetch("coarse", log, cfg.opt.coarse_iterations)
        state, adam_state, log = scene_reconstruction(
            cfg, state, adam_state, cams, "fine", cfg.opt.iterations,
            scene.cameras_extent, rng_seed=args.seed + 1, **common)
        report_prefetch("fine", log, cfg.opt.iterations)
    finally:
        if viewer is not None:
            viewer.close()

    if tracker is not None:
        # the report, the curves and the per-timestamp timeline of the first
        # train camera (train.py:278-290)
        from fourdgs_tpu_torch.utils.gradient_tracker import gradient_timeline

        tracker.generate_report()
        tracker.visualize_gradient_curves()
        cam0, gt0 = cams[0]
        gt0 = np.asarray(gt0() if callable(gt0) else gt0)
        if gt0.dtype == np.uint8:
            gt0 = gt0.astype(np.float32).transpose(2, 0, 1) / 255.0
        gradient_timeline(cfg, state, cam0, gt0, model_path, device=dev)
        print(f"gradient report + timeline → {model_path}")

    wall.pause()
    if not main_rank:
        return state, adam_state
    checkpoint.save_snapshot(model_path, state, cfg.opt.iterations, "fine")
    checkpoint.save_checkpoint(model_path, state, adam_state, cfg.opt.iterations, "fine")
    timer.save_timing_report()
    timer.save_training_logs()
    timer.print_summary()
    ev.close()
    print(f"training done in {wall.get_elapsed_time():.1f}s → {model_path}")
    return state, adam_state


if __name__ == "__main__":
    main()
