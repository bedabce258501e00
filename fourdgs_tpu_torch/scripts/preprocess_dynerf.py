"""Extract Neu3D video frames to ``cam*/images/%04d.png`` ahead of training.

Counterpart of ``scripts/preprocess_dynerf.py``: the same flags and the same
skip rule (a camera whose ``images`` directory already holds ``--frames``
files is left alone). The loader (``data/dynerf.py``) also extracts on
first use; this pays the cost ahead. Frames are decoded by the port's H.264
or MPEG-4 Part 2 decoder (by the track's codec) and resized with its Pillow-exact LANCZOS
(``utils/video.py::extract_video_frames``). A camera's directory is its
video's path less the extension, as the port's loader takes it.

    python -m fourdgs_tpu_torch.scripts.preprocess_dynerf --datadir <scene> [--frames 300]
"""

from __future__ import annotations

import argparse
import glob
import os

from fourdgs_tpu_torch.utils.video import extract_video_frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datadir", required=True)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--width", type=int, default=1352)
    p.add_argument("--height", type=int, default=1014)
    args = p.parse_args(argv)
    for video in sorted(glob.glob(os.path.join(args.datadir, "cam*.mp4"))):
        out = os.path.join(os.path.splitext(video)[0], "images")
        if os.path.isdir(out) and len(os.listdir(out)) >= args.frames:
            print(f"skip {video} (already extracted)")
            continue
        print(f"extracting {video} → {out}")
        extract_video_frames(video, out, (args.width, args.height), args.frames)


if __name__ == "__main__":
    main()
