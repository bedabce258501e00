"""The port's debug images (``utils/debug_images.py``) against the JAX
package's, and ``scene_reconstruction``'s ``render_process`` and
``debug_mode``.

- Both panels (``save_debug_image``'s render|GT, ``render_training_image``'s
  GT|render|depth) on the same arrays: the same paths, and the same pixels
  outside the caption band. JAX writes with Pillow; both are read with
  Pillow here. Pillow's caption (its default font, antialiased) changes no
  pixel below row 14, which is checked; inside the band the port's pixels
  are black or white, with some white, and Pillow's text is not matched.
- ``should_save_progress`` equals JAX's over 0–60,000.
- A port-only ``scene_reconstruction`` run on the CPU (the tiny scene of
  ``tests/test_torch_loop.py``, coarse 100 then fine 20 steps,
  ``scan_steps`` 5) with ``render_process`` and ``debug_mode``: the files
  appear at exactly JAX's iterations, and no chunk of JAX's scan
  (``loop.scan_chunks``) holds a save other than at its last step.
"""

import os

import numpy as np
import pytest
from PIL import Image

from fourdgs_tpu.utils import debug_images as JD
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils import debug_images as TD
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_loop import EXTENT, _port_cfg, _port_start

BAND = TD.BAND_ROWS


def _arrays(seed, h=40, w=56, gt_kind="uint8"):
    rng = np.random.default_rng(seed)
    render = rng.uniform(-0.2, 1.2, (3, h, w)).astype(np.float32)
    if gt_kind == "uint8":
        gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:                                   # float CHW, as the loop passes it
        gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = rng.uniform(0, 4, (1, h, w)).astype(np.float32)
    return render, gt, depth


def _read(path):
    return np.asarray(Image.open(path))


def _check_band(got):
    band = got[:BAND]
    assert set(np.unique(band)) <= {0, 255} and (band == 255).any()


@pytest.mark.parametrize("gt_kind", ["uint8", "float"])
@pytest.mark.parametrize("stage,iteration,t", [("coarse", 100, 0.0), ("fine", 14000, 0.6667)])
def test_debug_panel_matches_jax(tmp_path, gt_kind, stage, iteration, t):
    render, gt, _ = _arrays(1, gt_kind=gt_kind)
    want_path = JD.save_debug_image(render, gt, stage, iteration, t, str(tmp_path / "jax"))
    got_path = TD.save_debug_image(render, gt, stage, iteration, t, str(tmp_path / "port"))
    assert (os.path.relpath(got_path, tmp_path / "port")
            == os.path.relpath(want_path, tmp_path / "jax")
            == os.path.join("debug_images", f"{stage}_{iteration:06d}.png"))
    got, want = _read(got_path), _read(want_path)
    assert got.shape == want.shape == (40, 112, 3)
    np.testing.assert_array_equal(got[BAND:], want[BAND:])
    raw = np.concatenate([JD._to_u8(render), JD._to_u8(gt) if gt_kind == "float" else gt],
                         axis=1)
    np.testing.assert_array_equal(want[BAND:], raw[BAND:])   # Pillow's text stays in the band
    assert (want[:BAND] != 0).any()
    _check_band(got)


@pytest.mark.parametrize("gt_kind", ["uint8", "float"])
@pytest.mark.parametrize("depth_kind", ["positive", "zero"])
def test_progress_frame_matches_jax(tmp_path, gt_kind, depth_kind):
    render, gt, depth = _arrays(2, gt_kind=gt_kind)
    if depth_kind == "zero":
        depth = np.zeros_like(depth)
    args = (render, gt, depth, "fine", 2999, 12.4)
    want_path = JD.render_training_image(*args, str(tmp_path / "jax"))
    got_path = TD.render_training_image(*args, str(tmp_path / "port"))
    assert (os.path.relpath(got_path, tmp_path / "port")
            == os.path.relpath(want_path, tmp_path / "jax")
            == os.path.join("train_render", "finetest", "002999.png"))
    got, want = _read(got_path), _read(want_path)
    assert got.shape == want.shape == (40, 168, 3)
    np.testing.assert_array_equal(got[BAND:], want[BAND:])
    _check_band(got)


def test_caption_font_covers_the_captions():
    for ch in "0123456789abcdefghijklmnopqrstuvwxyz =.|":
        assert ch in TD._GLYPHS
    with pytest.raises(ValueError, match="no 'X'"):
        TD._caption(np.zeros((20, 40, 3), np.uint8), "X")
    narrow = TD._caption(np.full((16, 10, 3), 9, np.uint8), "coarse iter=1")
    assert narrow.shape == (16, 10, 3) and (narrow[15] == 9).all()   # clipped


def test_should_save_progress_matches_jax():
    its = range(0, 60_001)
    assert [TD.should_save_progress(i) for i in its] == \
        [JD.should_save_progress(i) for i in its]


COARSE, FINE = 100, 20


def test_scene_reconstruction_saves_at_jax_iterations(tmp_path):
    cfg = _port_cfg()
    cfg.model.render_process = True
    cfg.tpu.scan_steps = 5
    cfg.opt.densification_interval = cfg.opt.pruning_interval = 1000
    cfg.opt.opacity_reset_interval = 1000
    cams, state, opt = _port_start(cfg)
    for stage, n in (("coarse", COARSE), ("fine", FINE)):
        state, opt, log = tloop.scene_reconstruction(
            cfg, state, opt, cams, stage, n, EXTENT, model_path=str(tmp_path),
            device="cpu", debug_mode=True)
        assert np.isfinite(log.iterations[-1]["loss"])
        frames = sorted(int(f[:-4]) for f in os.listdir(tmp_path / "train_render" /
                                                         f"{stage}test"))
        want = [i for i in range(1, n + 1) if JD.should_save_progress(i)]
        assert frames == want
        chunks = tloop.scan_chunks(cfg, n, 50, frozenset(), debug_mode=True)
        assert [a for a, _ in chunks] == [1] + [b + 1 for _, b in chunks[:-1]]
        assert chunks[-1][1] == n and max(b - a for a, b in chunks) == 4
        saves = set(want) | {i for i in range(1, n + 1) if i % 100 == 0}
        for a, b in chunks:
            assert not saves & set(range(a, b)), (a, b)
    assert sorted(os.listdir(tmp_path / "debug_images")) == ["coarse_000100.png"]
    h, w = np.asarray(cams[0][1]).shape[-2:]
    panel = _read(tmp_path / "debug_images" / "coarse_000100.png")
    frame = _read(tmp_path / "train_render" / "finetest" / "000019.png")
    assert panel.shape == (h, 2 * w, 3) and frame.shape == (h, 3 * w, 3)
    _check_band(panel)
    _check_band(frame)
