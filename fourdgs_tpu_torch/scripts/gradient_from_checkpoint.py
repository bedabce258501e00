"""Per-timestamp gradient timeline from a saved checkpoint.

Counterpart of ``scripts/gradient_from_checkpoint.py``, with its
arguments: load a trained model from the port's checkpoint
(``chkpnt_<stage>_<iter>/checkpoint.npz``, ``train/checkpoint.py``),
render one train camera at ``--n_times`` timestamps and take the L1 loss's
gradient at each (K1 and K2 once per timestamp on the card), and write
``gradient_timeline.json`` and the panel grid ``gradient_timeline.png``
(``utils/gradient_tracker.py::gradient_timeline``) without re-running
training:

    python -m fourdgs_tpu_torch.scripts.gradient_from_checkpoint \\
        --checkpoint output/exp/chkpnt_fine_20000 \\
        -s <dataset path> [--configs <preset.py>] \\
        [--out output/exp/grad_from_ckpt] [--n_times 10] [--camera 0] \\
        [--stage fine] [--device cuda]

The config is the run's own ``cfg_args.json`` beside the checkpoint unless
``--configs`` names a preset, so the model's shapes are those it was
trained with. It runs on ``--device`` (``cuda`` by default; ``cpu`` runs
the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> tuple[str, str | None]:
    """Returns the paths of the JSON timeline and the panel grid (None
    without matplotlib)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (chkpnt_<stage>_<iter>)")
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--configs", default=None)
    ap.add_argument("--out", default=None,
                    help="output dir (default: <ckpt parent>/grad_from_ckpt)")
    ap.add_argument("--n_times", type=int, default=10)
    ap.add_argument("--camera", type=int, default=0,
                    help="train-camera index to probe through")
    ap.add_argument("--stage", default="fine")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain path")
    args = ap.parse_args(argv)

    import numpy as np

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import config_from_dict, load_config
    from fourdgs_tpu_torch.data.scene import load_scene
    from fourdgs_tpu_torch.train import checkpoint
    from fourdgs_tpu_torch.utils.gradient_tracker import gradient_timeline

    dev = resolve_device(args.device)
    parent = os.path.dirname(os.path.abspath(args.checkpoint))
    cfg_dump = os.path.join(parent, "cfg_args.json")
    if args.configs is None and os.path.exists(cfg_dump):
        with open(cfg_dump) as f:
            cfg = config_from_dict(json.load(f))
        print(f"config restored from {cfg_dump}")
    else:
        cfg = load_config(args.configs)
    cfg.model.source_path = args.source_path

    data = load_scene(cfg)
    state, _, it = checkpoint.load_checkpoint(args.checkpoint, cfg, device=dev)
    print(f"checkpoint @ iteration {it}: {int(state.alive.sum())} alive points")

    lc = data.train_cameras[args.camera]
    gt = np.asarray(lc.image() if callable(lc.image) else lc.image)
    if gt.dtype == np.uint8:
        gt = gt.astype(np.float32).transpose(2, 0, 1) / 255.0

    out = args.out or os.path.join(parent, "grad_from_ckpt")
    times = [i / max(args.n_times - 1, 1) for i in range(args.n_times)]
    paths = gradient_timeline(cfg, state, lc.camera, gt, out, time_points=times,
                              stage=args.stage, device=dev)
    print(f"gradient timeline ({args.n_times} timestamps) → {out}")
    return paths


if __name__ == "__main__":
    main()
