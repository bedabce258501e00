"""Debug images: render|GT panels and training progress frames.

Counterpart of ``fourdgs_tpu/utils/debug_images.py`` on the port's PNG
writer (``utils/png.py``): the same panels, file names and directories.
JAX captions them with Pillow's default font; the card's host has no
Pillow, so the port draws the caption with a small fixed bitmap font kept
here (5×7 glyphs, descenders below, 6 pixels a character) over the same
black band, rows 0–14 (Pillow's ``rectangle([0, 0, W, 14])``). Outside the
band a panel equals JAX's pixel for pixel.

Parity targets in the reference:
- utils/debug_utils.py:7-90 (save_debug_image): side-by-side render|GT panel
  with a caption (stage, iteration, camera time), saved every 100 iterations
  under <model_path>/debug_images/ when --debug_mode is on (train.py:212-219)
- utils/scene_utils.py:11-58 (render_training_image): labeled GT|render|depth
  progress frame on the dense early schedule (train.py:325-331)
"""

from __future__ import annotations

import os

import numpy as np

from fourdgs_tpu_torch.utils import png

BAND_ROWS = 15            # the caption band: rows 0-14
TEXT_X, TEXT_Y = 4, 3     # the first glyph's top-left pixel
ADVANCE = 6               # pixels a character

# the characters the two captions use; '#' lights a pixel, rows below the
# seventh are descenders
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("####.", "....#", "....#", ".###.", "....#", "....#", "####."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": ("..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."),
    "a": (".....", ".....", ".###.", "....#", ".####", "#...#", ".####"),
    "b": ("#....", "#....", "#.##.", "##..#", "#...#", "#...#", "####."),
    "c": (".....", ".....", ".###.", "#....", "#....", "#...#", ".###."),
    "d": ("....#", "....#", ".##.#", "#..##", "#...#", "#...#", ".####"),
    "e": (".....", ".....", ".###.", "#...#", "#####", "#....", ".###."),
    "f": ("..##.", ".#..#", ".#...", "###..", ".#...", ".#...", ".#..."),
    "g": (".....", ".....", ".####", "#...#", "#...#", ".####", "....#", "....#", ".###."),
    "h": ("#....", "#....", "#.##.", "##..#", "#...#", "#...#", "#...#"),
    "i": ("..#..", ".....", ".##..", "..#..", "..#..", "..#..", ".###."),
    "j": ("...#.", ".....", "..##.", "...#.", "...#.", "...#.", "#..#.", ".##.."),
    "k": ("#....", "#....", "#..#.", "#.#..", "##...", "#.#..", "#..#."),
    "l": (".##..", "..#..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "m": (".....", ".....", "##.#.", "#.#.#", "#.#.#", "#...#", "#...#"),
    "n": (".....", ".....", "#.##.", "##..#", "#...#", "#...#", "#...#"),
    "o": (".....", ".....", ".###.", "#...#", "#...#", "#...#", ".###."),
    "p": (".....", ".....", "####.", "#...#", "#...#", "####.", "#....", "#...."),
    "q": (".....", ".....", ".##.#", "#..##", "#...#", ".####", "....#", "....#"),
    "r": (".....", ".....", "#.##.", "##..#", "#....", "#....", "#...."),
    "s": (".....", ".....", ".###.", "#....", ".###.", "....#", "####."),
    "t": (".#...", ".#...", "###..", ".#...", ".#...", ".#..#", "..##."),
    "u": (".....", ".....", "#...#", "#...#", "#...#", "#..##", ".##.#"),
    "v": (".....", ".....", "#...#", "#...#", "#...#", ".#.#.", "..#.."),
    "w": (".....", ".....", "#...#", "#...#", "#.#.#", "#.#.#", ".#.#."),
    "x": (".....", ".....", "#...#", ".#.#.", "..#..", ".#.#.", "#...#"),
    "y": (".....", ".....", "#...#", "#...#", "#...#", ".####", "....#", ".###."),
    "z": (".....", ".....", "#####", "...#.", "..#..", ".#...", "#####"),
    "=": (".....", ".....", "#####", ".....", "#####", ".....", "....."),
    ".": (".....", ".....", ".....", ".....", ".....", ".##..", ".##.."),
    "|": ("..#..", "..#..", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."),
    " ": (),
}


def _to_u8(img_chw: np.ndarray) -> np.ndarray:
    img = np.clip(np.asarray(img_chw), 0.0, 1.0)
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def _gt_u8(gt: np.ndarray) -> np.ndarray:
    """A GT frame as uint8 HWC: the loader's uint8 frames as they are, float
    CHW ones through :func:`_to_u8`."""
    if gt.ndim == 3 and gt.shape[-1] in (3, 4):
        return np.asarray(gt)[..., :3]
    return _to_u8(gt)


def _caption(panel: np.ndarray, text: str) -> np.ndarray:
    """``panel`` with the black band over rows 0-14 and ``text`` in white
    (clipped at the panel's right edge). Raises ``ValueError`` on a
    character the font does not hold."""
    out = np.array(panel)
    out[:BAND_ROWS] = 0
    width = out.shape[1]
    for i, ch in enumerate(text):
        if ch not in _GLYPHS:
            raise ValueError(f"the caption font has no {ch!r} (in {text!r})")
        x0 = TEXT_X + i * ADVANCE
        for dy, row in enumerate(_GLYPHS[ch]):
            for dx, bit in enumerate(row):
                if bit == "#" and x0 + dx < width:
                    out[TEXT_Y + dy, x0 + dx] = 255
    return out


def save_debug_image(
    render_chw: np.ndarray,
    gt: np.ndarray,
    stage: str,
    iteration: int,
    time: float,
    model_path: str,
) -> str:
    """render|GT side-by-side panel (save_debug_image equivalent) at
    ``debug_images/<stage>_<iteration:06d>.png``."""
    out_dir = os.path.join(model_path, "debug_images")
    os.makedirs(out_dir, exist_ok=True)
    panel = np.concatenate([_to_u8(render_chw), _gt_u8(gt)], axis=1)
    panel = _caption(panel, f"{stage} iter={iteration} t={time:.3f}  render | gt")
    path = os.path.join(out_dir, f"{stage}_{iteration:06d}.png")
    png.write_png(path, panel)
    return path


def render_training_image(
    render_chw: np.ndarray,
    gt: np.ndarray,
    depth_1hw: np.ndarray,
    stage: str,
    iteration: int,
    elapsed_s: float,
    model_path: str,
    split: str = "test",
) -> str:
    """GT|render|depth progress frame (render_training_image equivalent) at
    ``train_render/<stage><split>/<iteration:06d>.png``."""
    out_dir = os.path.join(model_path, "train_render", f"{stage}{split}")
    os.makedirs(out_dir, exist_ok=True)
    d = np.asarray(depth_1hw)[0]
    dmax = d.max() if d.max() > 0 else 1.0
    d_u8 = np.repeat((np.clip(d / dmax, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    panel = np.concatenate([_gt_u8(gt), _to_u8(render_chw), d_u8], axis=1)
    panel = _caption(panel, f"{stage} iter={iteration} {elapsed_s:.0f}s  gt | render | depth")
    path = os.path.join(out_dir, f"{iteration:06d}.png")
    png.write_png(path, panel)
    return path


def should_save_progress(iteration: int) -> bool:
    """The reference's dense early schedule (train.py:325-331)."""
    return (
        (iteration < 1000 and iteration % 10 == 9)
        or (iteration < 3000 and iteration % 50 == 49)
        or (iteration < 60000 and iteration % 100 == 99)
    )
