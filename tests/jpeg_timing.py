"""Host time of the port's JPEG decoder (``utils/jpeg.py::read_jpeg``)
against Pillow's, one frame at a time, at the frame sizes of real captures.

    python3 tests/jpeg_timing.py write DIR            # Pillow writes the frames
    python3 tests/jpeg_timing.py time DIR [--reps N]  # times them

``write`` needs Pillow. ``time`` runs without it too (as on a host that has
none), and then times ``read_jpeg`` alone. Each decoder is read in turns
(port, Pillow, Pillow, port, ``reps`` times) on one thread, and the median
of each is reported; Pillow's call is JAX's ``ImageRef`` decode
(``np.asarray(Image.open(path).convert("RGB"))``). ``time`` also reads the
committed 160×120 fixture ``frame_c0_f0.jpg`` of ``chip_smoke.py`` phase 12
(b), so that two hosts' runs can be set side by side. It prints one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))          # the repo's root, run as a script
from fourdgs_tpu_torch.utils.jpeg import read_jpeg  # noqa: E402

FIXTURE = os.path.join(HERE, "torch_fixtures", "jpeg", "frame_c0_f0.jpg")
# (width, height) of the captures the loaders read
SIZES = {
    "panoptic_640x360": (640, 360),        # CMU Panoptic HD frames as Dynamic 3DGS ships them
    "hypernerf_540x960": (540, 960),       # a phone capture at ratio 0.5 (portrait)
    "dynerf_1352x1014": (1352, 1014),      # a DyNeRF camera at half resolution
    "full_hd_1920x1080": (1920, 1080),     # a multi-camera rig's frame (MultipleView, COLMAP)
}
QUALITY = 90


def capture_like(w: int, h: int, seed: int = 0) -> np.ndarray:
    """A frame with smooth shading, hard edges and sensor noise (σ 3
    levels), so that the entropy coder sees about what a photo gives it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([110 + 70 * np.sin(x / (37.0 + 11 * k) + k) * np.cos(y / 53.0 - k)
                    for k in range(3)], -1)
    for _ in range(24):                                # discs of flat colour
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.02, 0.12) * max(w, h)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(20, 235, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_frames(out_dir: str, sizes: dict = SIZES) -> list[str]:
    """Write one capture-like JPEG a size (Pillow, quality 90, 4:2:0)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (name, (w, h)) in enumerate(sizes.items()):
        path = os.path.join(out_dir, f"{name}.jpg")
        Image.fromarray(capture_like(w, h, seed=i)).save(path, quality=QUALITY)
        paths.append(path)
    return paths


def time_frames(paths: list[str], reps: int = 20) -> dict:
    """Median ms of ``read_jpeg`` and of Pillow (None where Pillow is
    missing) on each file, read in turns."""
    try:
        from PIL import Image
    except ImportError:
        Image = None

    def pillow(path):
        return np.asarray(Image.open(path).convert("RGB"))

    def once(fn, path):
        t0 = time.perf_counter()
        fn(path)
        return (time.perf_counter() - t0) * 1e3

    frames = []
    for path in paths:
        got = read_jpeg(path)
        h, w = got.shape[:2]
        if Image is not None:
            assert np.array_equal(got, pillow(path)), path
        port, pil = [], []
        for _ in range(reps):
            port.append(once(read_jpeg, path))
            if Image is not None:
                pil += [once(pillow, path), once(pillow, path)]
            port.append(once(read_jpeg, path))
        port_ms = statistics.median(port)
        pil_ms = statistics.median(pil) if pil else None
        frames.append({
            "file": os.path.basename(path), "width": w, "height": h,
            "bytes": os.path.getsize(path), "port_ms": port_ms, "pillow_ms": pil_ms,
            "port_ns_per_px": port_ms * 1e6 / (w * h),
            "port_vs_pillow": port_ms / pil_ms if pil_ms else None})
    return {"pillow": Image is not None, "reps": reps, "cpu_count": os.cpu_count(),
            "frames": frames}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("action", choices=["write", "time"])
    ap.add_argument("dir")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.action == "write":
        print("\n".join(write_frames(args.dir)))
        return 0
    paths = [FIXTURE] + [os.path.join(args.dir, f"{name}.jpg") for name in SIZES]
    print(json.dumps(time_frames(paths, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
