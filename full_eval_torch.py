#!/usr/bin/env python3
"""Train, render and evaluate a family of scenes with the PyTorch + CUDA
port (the port's ``full_eval.py``).

    python3 full_eval_torch.py --base_dir <datasets_root> --family dnerf
        [--scenes bouncingballs lego] [--output output/full_eval]
        [--skip_train] [--skip_render] [--skip_metrics] [--device cuda|cpu]

For each scene it runs ``train_torch.py`` with the family's preset
(``fourdgs_tpu/configs/presets/<family>/<scene>.py``, else ``default.py``,
read as data), then ``render_torch.py`` and ``metrics_torch.py`` on
``output/<family>/<scene>``, each in a subprocess, with ``full_eval.py``'s
command lines and ``--device``. The scripts and presets are found beside
this file, so it runs from any working directory; the model paths are
relative to the working directory, as in ``full_eval.py``. ``--output`` is
parsed and unused, as in ``full_eval.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FAMILIES = {
    "dnerf": ["bouncingballs", "hellwarrior", "hook", "jumpingjacks",
              "lego", "mutant", "standup", "trex"],
    "dynerf": ["coffee_martini", "cook_spinach", "cut_roasted_beef",
               "flame_salmon_1", "flame_steak", "sear_steak"],
    "hypernerf": ["3dprinter", "banana", "broom2", "chicken"],
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--family", choices=sorted(FAMILIES), required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--output", default="output/full_eval")
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_render", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = parser.parse_args(argv)

    presets = os.path.join(HERE, "fourdgs_tpu", "configs", "presets", args.family)
    scenes = args.scenes or FAMILIES[args.family]
    py = sys.executable

    def script(name):
        return os.path.join(HERE, name)

    for scene in scenes:
        data = os.path.join(args.base_dir, scene)
        cfg = os.path.join(presets, f"{scene}.py")
        if not os.path.exists(cfg):
            cfg = os.path.join(presets, "default.py")
        exp = f"{args.family}/{scene}"
        model_path = os.path.join("output", exp)
        print(f"===== {scene} =====")
        if not args.skip_train:
            t0 = time.time()
            subprocess.run(
                [py, script("train_torch.py"), "-s", data, "--configs", cfg,
                 "--expname", exp, "--quiet", "--device", args.device], check=True)
            print(f"train wall: {time.time()-t0:.0f}s")
        if not args.skip_render:
            subprocess.run(
                [py, script("render_torch.py"), "--model_path", model_path,
                 "--source_path", data, "--skip_train", "--device", args.device],
                check=True)
        if not args.skip_metrics:
            subprocess.run(
                [py, script("metrics_torch.py"), "--model_path", model_path,
                 "--device", args.device], check=True)


if __name__ == "__main__":
    main()
