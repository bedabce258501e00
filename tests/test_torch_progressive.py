"""The port's JPEG decoder (``native/jpeg.cpp``) on progressive files
(SOF2), bit for bit against Pillow (libjpeg-turbo), and the committed
fixtures of ``tests/torch_fixtures/variants``.

- Files Pillow writes with ``progressive=True`` in the test: 4:4:4, 4:2:2
  and 4:2:0 at 1×1 to 129×97, qualities 30 to 95, ``optimize=True``
  (Huffman tables defined before each scan), restart intervals
  (``restart_marker_blocks``, ``restart_marker_rows``), 16-bit quantization
  tables, grey. Each decodes exactly as Pillow decodes it, and as the
  baseline file of the same picture decodes (a progressive file holds the
  same quantized coefficients).
- A file whose scans leave low-frequency coefficients unrefined (the first
  scans of a Pillow file and EOI) is smoothed as libjpeg smooths it, bit
  for bit; a truncated scan raises ``ValueError``.
- The committed fixtures against Pillow's committed decodes, the generator
  that wrote them, and ``chip_smoke.py`` phase 16 (b)'s check of them
  (``check_decoders``) on the CPU.
"""

import os
import zipfile

import numpy as np
import pytest
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu_torch.utils import jpeg
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_jpeg import make_image
from tests.test_torch_png_variants import PNG_FIXTURES, write_png_fixtures

SIZES = [(1, 1), (7, 5), (37, 23), (129, 97)]


def check_exact(path):
    want = np.asarray(Image.open(path))
    got = jpeg.read_jpeg(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("options", [
    {"quality": 75}, {"quality": 30, "optimize": True}, {"quality": 95},
    {"quality": 80, "restart_marker_blocks": 3}, {"quality": 85, "restart_marker_rows": 1},
], ids=["q75", "q30_optimize", "q95", "rst3", "rows"])
def test_progressive_matches_pillow(tmp_path, size, subsampling, options):
    path = tmp_path / "p.jpg"
    img = make_image(*size, seed=size[0])
    Image.fromarray(img).save(path, progressive=True, subsampling=subsampling, **options)
    data = path.read_bytes()
    assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 1       # SOF2, several scans
    got = check_exact(path)
    base = tmp_path / "b.jpg"
    Image.fromarray(img).save(base, subsampling=subsampling, **options)
    np.testing.assert_array_equal(got, jpeg.read_jpeg(str(base)))


@pytest.mark.parametrize("size", SIZES + [(64, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_grey_and_16_bit_tables(tmp_path, size):
    path = tmp_path / "g.jpg"
    Image.fromarray(make_image(*size, channels=1, seed=2)).save(path, progressive=True,
                                                                quality=85)
    assert check_exact(path).ndim == 2
    Image.fromarray(make_image(*size, seed=3)).save(
        path, progressive=True, qtables=[[300] * 64, list(range(200, 264))])
    assert b"\xff\xc2" in path.read_bytes()
    check_exact(path)


scans_cut = CS.scans_cut


def test_unrefined_scans_raise_and_truncated_ones_fail(tmp_path):
    """Cut after each of a Pillow file's first scans, the refinement scans
    are missing, and libjpeg smooths the blocks (Pillow decodes such a
    file): the port smooths them as libjpeg does, bit for bit (more cases in
    ``tests/test_torch_jpeg_rare.py``). A scan cut inside its data raises
    ``ValueError``."""
    full = tmp_path / "f.jpg"
    Image.fromarray(make_image(64, 48)).save(full, progressive=True, quality=90)
    data = full.read_bytes()
    n_scans = data.count(b"\xff\xda")
    assert n_scans == 10
    cut = tmp_path / "cut.jpg"
    for n in range(1, n_scans):
        cut.write_bytes(scans_cut(data, n))
        assert np.asarray(Image.open(cut)).shape == (48, 64, 3)
        check_exact(cut)
    cut.write_bytes(data[:len(data) * 3 // 4])
    with pytest.raises(ValueError, match="truncated"):
        jpeg.read_jpeg(str(cut))


# -- committed fixtures --------------------------------------------------------


def capture_picture(w, h, seed=0):
    """Smooth shading, discs of flat colour and sensor noise of σ 1 level:
    a capture-like picture whose 1352×1014 progressive JPEG stays under
    200 KB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([110 + 70 * np.sin(x / (37.0 + 11 * k) + k) * np.cos(y / 53.0 - k)
                    for k in range(3)], -1)
    for _ in range(24):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.02, 0.12) * max(w, h)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(20, 235, 3)
    return np.clip(img + rng.normal(0, 1, img.shape), 0, 255).astype(np.uint8)


def write_committed_fixtures(out_dir):
    """Write ``tests/torch_fixtures/variants``: the twelve frames of
    ``tests/torch_fixtures/jpeg`` again as progressive files (the same
    picture and options), six small progressive files of the decoder's
    other cases, a file of a progressive file's first three scans (which
    libjpeg would smooth), the 1352×1014 :func:`capture_picture` as a
    progressive and a baseline file (quality 90, 4:2:0), the PNG variants
    of ``tests/test_torch_png_variants.py::PNG_FIXTURES``, and
    ``pillow_decode.npz``: Pillow's decode of each file by stem (a PNG's
    conversions as ``<stem>.<mode>``), the 1352×1014 picture's as the
    SHA-256 ``capture_1352x1014.sha256``."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    decodes = {}

    def save(name, img, **options):
        path = os.path.join(out_dir, name + ".jpg")
        Image.fromarray(img).save(path, progressive=True, **options)
        return path

    # the baseline frames' pictures and options (test_torch_jpeg.py's
    # generator), so that their committed decodes are these files' too
    for c in range(CS.JPEG_SCENE_CAMS):
        for f in range(CS.JPEG_SCENE_FRAMES):
            cam = CS.jpeg_scene_camera(c, f)[0]
            save(f"prog_frame_c{c}_f{f}", CS.render_gt(cam, torch.device("cpu"), [1.0] * 3),
                 quality=90)
    for name, img, options in (
            ("prog_444_rst_32x24", make_image(32, 24, seed=4),
             dict(quality=95, subsampling=0, restart_marker_blocks=2)),
            ("prog_422_7x5", make_image(7, 5, seed=5), dict(quality=50, subsampling=1)),
            ("prog_420_rows_29x31", make_image(29, 31, seed=7),
             dict(quality=70, restart_marker_rows=1)),
            ("prog_grey_37x23", make_image(37, 23, channels=1, seed=3), dict(quality=75)),
            ("prog_qt16_33x17", make_image(33, 17, seed=6),
             dict(qtables=[[300] * 64, [400] * 64])),
            ("prog_444_odd_45x19", make_image(45, 19, seed=9),
             dict(quality=88, subsampling=0))):
        with Image.open(save(name, img, **options)) as im:
            decodes[name] = np.asarray(im)
    unrefined = save("prog_unrefined", make_image(64, 48, seed=10), quality=90)
    with open(unrefined, "rb") as f:
        data = f.read()
    with open(unrefined, "wb") as f:
        f.write(scans_cut(data, 3))
    picture = capture_picture(1352, 1014)
    for kind in ("progressive", "baseline"):
        path = os.path.join(out_dir, f"{CS.CAPTURE_FRAME}_{kind}.jpg")
        Image.fromarray(picture).save(path, quality=90, progressive=kind == "progressive")
        with Image.open(path) as im:
            sha = CS.decode_sha256(np.asarray(im))
        decodes.setdefault(CS.CAPTURE_FRAME + ".sha256", np.array(sha))
        assert str(decodes[CS.CAPTURE_FRAME + ".sha256"]) == sha
    write_png_fixtures(out_dir, decodes)
    with zipfile.ZipFile(os.path.join(out_dir, "pillow_decode.npz"), "w",
                         zipfile.ZIP_DEFLATED, compresslevel=9) as zf:
        for name, arr in decodes.items():
            with zf.open(name + ".npy", "w") as f:
                np.lib.format.write_array(f, arr)
    return decodes


def test_committed_fixtures_are_pillows():
    """Pillow decodes the committed files as the committed decodes say: the
    progressive frames as the baseline frames' decodes, the 1352×1014
    picture (under 200 KB progressive) both ways to one SHA-256."""
    want = CS.variant_decodes()
    baseline = np.load(os.path.join(CS.JPEG_FIXTURES, "pillow_decode.npz"))
    for c in range(CS.JPEG_SCENE_CAMS):
        for f in range(CS.JPEG_SCENE_FRAMES):
            with Image.open(CS.progressive_frame(c, f)) as im:
                np.testing.assert_array_equal(np.asarray(im), baseline[f"frame_c{c}_f{f}"])
    for kind in ("progressive", "baseline"):
        path = os.path.join(CS.VARIANT_FIXTURES, f"{CS.CAPTURE_FRAME}_{kind}.jpg")
        with Image.open(path) as im:
            assert im.size == (1352, 1014)
            assert CS.decode_sha256(np.asarray(im)) == str(want[CS.CAPTURE_FRAME + ".sha256"])
    assert os.path.getsize(os.path.join(
        CS.VARIANT_FIXTURES, f"{CS.CAPTURE_FRAME}_progressive.jpg")) < 200_000
    for name, arr in want.items():
        stem, _, mode = name.partition(".")
        if mode == "sha256":
            continue
        path = os.path.join(CS.VARIANT_FIXTURES, stem + (".png" if stem in PNG_FIXTURES
                                                        else ".jpg"))
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert(mode) if mode else im), arr)
    total = sum(os.path.getsize(os.path.join(CS.VARIANT_FIXTURES, f))
                for f in os.listdir(CS.VARIANT_FIXTURES))
    assert total < 400_000, total


def test_the_generator_wrote_the_committed_fixtures(tmp_path):
    got = write_committed_fixtures(str(tmp_path))
    want = CS.variant_decodes()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(CS.VARIANT_FIXTURES))


def test_chip_smoke_decoder_phase_on_cpu():
    """Phase 16 (b) on the CPU: every committed variant bit for bit
    (the unrefined file smoothed), the timing and the MultipleView scene of
    progressive frames through ``load_scene``."""
    res = CS.check_decoders(reps=1)
    assert res["jpeg_files"] == 12 + 6 + 1 + 2 and res["png_files"] == len(PNG_FIXTURES)
    assert res["multipleview_frames"] == 12
    assert all(ms > 0 for ms in res["ms"].values())
    assert res["bytes"]["progressive"] < 200_000
