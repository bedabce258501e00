"""The port's JPEG decoder (``utils/jpeg.py`` over
``native/jpeg.cpp``, built here with ``g++``) against Pillow.

Tolerance, against ``np.asarray(PIL.Image.open(path))``: at most 2 levels
per channel and a mean of at most 0.02 levels on every file. Two conforming
decoders may differ by the IDCT's rounding (T.81 leaves it to the decoder),
and the YCbCr→RGB transform multiplies a chroma difference of 1 by up to
1.772. The decoder follows libjpeg's integer path (the islow IDCT, fancy
upsampling, the fixed-point colour tables), so here every file matches
Pillow's libjpeg-turbo exactly; each test prints the share of values that
match exactly.

- Fixtures written by Pillow into ``tmp_path``: quality 50, 75 and 95 by
  subsampling 4:4:4, 4:2:2 and 4:2:0 by sizes 1×1, 7×5, 37×23, 64×48 and
  129×97; grey; restart intervals (``restart_marker_blocks``,
  ``restart_marker_rows``); Huffman tables optimised; 16-bit quantization
  tables (SOF1); an Adobe RGB file.
- Hierarchical files raise ``NotImplementedError``; lossless,
  arithmetic-coded and CMYK files decode (their cases held to Pillow in
  ``tests/test_torch_jpeg_rare.py``, progressive ones in
  ``tests/test_torch_progressive.py``); truncated ones raise
  ``ValueError``, and so do a Huffman table whose codes do not fit their
  lengths and a frame header of more pixels than Pillow opens, as Pillow
  raises on them.
- ``data/dynerf.py::ImageRef`` picks the codec by the file's first bytes, as
  JAX's ``ImageRef`` (Pillow) reads PNG and JPEG.
- The committed fixtures of ``tests/torch_fixtures/jpeg`` (for the card,
  whose host cannot write a JPEG) against their committed Pillow decodes,
  and :func:`write_committed_fixtures`, which wrote them.
- The decoder links no JPEG library.
"""

import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu.data.dynerf import ImageRef as JImageRef
from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.utils import jpeg, native, png
from fourdgs_tpu_torch.utils.resample import resize

SIZES = [(1, 1), (7, 5), (37, 23), (64, 48), (129, 97)]
FIXTURES = CS.JPEG_FIXTURES


def make_image(w, h, channels=3, seed=0):
    """A smooth image with noise, so that every frequency and the chroma
    matter."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                     for k in range(channels)], -1)
    img = np.clip(base + rng.normal(0, 20, (h, w, channels)), 0, 255).astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img



def check_against_pillow(path, want=None):
    """read_jpeg(path) against Pillow's decode (or ``want``) to the
    tolerance; returns the share of exact values."""
    want = np.asarray(Image.open(path)) if want is None else want
    got = jpeg.read_jpeg(str(path))
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= CS.JPEG_MAX_LEVELS and d.mean() <= CS.JPEG_MEAN_LEVELS, \
        (path, d.max(), d.mean())
    exact = float((d == 0).mean())
    print(f"{os.path.basename(str(path))}: max {d.max()} levels, exact share {exact:.6f}")
    return exact


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_matches_pillow(tmp_path, quality, subsampling, size):
    path = tmp_path / "f.jpg"
    Image.fromarray(make_image(*size)).save(path, quality=quality, subsampling=subsampling)
    check_against_pillow(path)


@pytest.mark.parametrize("options", [
    {"restart_marker_blocks": 1}, {"restart_marker_blocks": 3, "subsampling": 2},
    {"restart_marker_rows": 1, "subsampling": 1}, {"optimize": True, "subsampling": 2},
    {"qtables": [[300] * 64, list(range(200, 264))]}, {"keep_rgb": True, "subsampling": 0},
], ids=["rst1", "rst3_420", "rows_422", "optimize", "qt16", "adobe_rgb"])
def test_restart_tables_and_colour_spaces(tmp_path, options):
    path = tmp_path / "f.jpg"
    quality = {} if "qtables" in options else {"quality": 80}   # a quality rescales tables
    Image.fromarray(make_image(129, 97, seed=1)).save(path, **quality, **options)
    data = path.read_bytes()
    if "qtables" in options:
        assert b"\xff\xc1" in data          # extended sequential, 16-bit DQT
    if "restart_marker_blocks" in options or "restart_marker_rows" in options:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    check_against_pillow(path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey(tmp_path, size):
    path = tmp_path / "g.jpg"
    Image.fromarray(make_image(*size, channels=1)).save(path, quality=85)
    assert jpeg.read_jpeg(str(path)).ndim == 2
    check_against_pillow(path)


@pytest.mark.parametrize("marker,feature", [(0xC3, "lossless"), (0xC5, "hierarchical"),
                                            (0xC9, "arithmetic")])
def test_out_of_scope_raises(tmp_path, marker, feature):
    """Hierarchical files (a baseline file's SOF0 renamed) raise
    ``NotImplementedError`` naming the feature, as Pillow refuses them;
    lossless and arithmetic-coded files (``tests/jpeg_writer.py``'s, of the
    same picture) and CMYK files decode as Pillow decodes them (their other
    cases in ``tests/test_torch_jpeg_rare.py``), and so do progressive
    files (``tests/test_torch_progressive.py``)."""
    from tests import jpeg_writer as W

    img = make_image(40, 30)
    path = tmp_path / "f.jpg"
    if feature == "hierarchical":
        path = _patched(tmp_path, 0xC0, lambda seg: b"\xff" + bytes([marker]) + seg[2:])
        with pytest.raises(NotImplementedError, match=feature):
            jpeg.read_jpeg(str(path))
        with pytest.raises(OSError):
            Image.open(path).load()
    else:
        if feature == "lossless":
            path.write_bytes(W.write_lossless(40, 30, [
                W.Component(ord(ch), 1, 1, samples=img[:, :, i]) for i, ch in enumerate("RGB")]))
            np.testing.assert_array_equal(jpeg.read_jpeg(str(path)), img)
        else:
            frame = W.dct_frame(list(W.rgb_to_ycc(img).transpose(2, 0, 1)),
                                [(2, 2), (1, 1), (1, 1)], W.quality_tables(90))
            path.write_bytes(W.write_dct(frame, arithmetic=True))
        assert path.read_bytes().count(b"\xff" + bytes([marker])) == 1
        np.testing.assert_array_equal(jpeg.read_jpeg(str(path)), np.asarray(Image.open(path)))
    img = Image.fromarray(img)
    img.convert("CMYK").save(tmp_path / "c.jpg")
    cmyk = jpeg.read_jpeg(str(tmp_path / "c.jpg"))
    assert cmyk.shape == (30, 40, 4)
    np.testing.assert_array_equal(cmyk, np.asarray(Image.open(tmp_path / "c.jpg")))


@pytest.mark.parametrize("keep", [0.5, 0.98, 60, 3])
def test_truncated_raises(tmp_path, keep):
    full = tmp_path / "f.jpg"
    Image.fromarray(make_image(64, 48)).save(full, quality=90)
    data = full.read_bytes()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:int(len(data) * keep) if keep < 1 else keep])
    with pytest.raises(ValueError, match="truncated"):
        jpeg.read_jpeg(str(cut))
    with pytest.raises(ValueError):
        ImageRef(str(cut), (64, 48))()


def _patched(tmp_path, marker, build):
    """A 64×48 Pillow file whose first ``marker`` segment (DHT or SOF0) is
    replaced by ``build(segment)``, the segment being its bytes from the
    marker on."""
    full = tmp_path / "f.jpg"
    Image.fromarray(make_image(64, 48)).save(full, quality=90)
    data = full.read_bytes()
    at = data.index(b"\xff" + bytes([marker]))
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    path = tmp_path / "patched.jpg"
    path.write_bytes(data[:at] + build(data[at:end]) + data[end:])
    return path


@pytest.mark.parametrize("counts", [[3], [255], [2], [0, 5], [1, 1, 1, 1, 1, 1, 1, 1, 2]],
                         ids=["3x1", "255x1", "all-ones-1", "5x2", "all-ones-9"])
def test_an_oversubscribed_huffman_table_raises(tmp_path, counts):
    """A DHT whose codes do not fit their lengths raises ``ValueError`` before
    any code is stored (3 or 255 codes of length 1 would index past the
    9-bit lookahead table), and so does one that uses a length's all-ones
    code, which libjpeg rejects too: Pillow raises on each."""
    counts = counts + [0] * (16 - len(counts))
    total = sum(counts)
    body = bytes([0x00]) + bytes(counts) + bytes(i % 12 for i in range(total))
    path = _patched(tmp_path, 0xC4,
                    lambda seg: b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body)
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(OSError):
        Image.open(path).load()


@pytest.mark.parametrize("w,h", [(65535, 65535), (65535, 2731)])
def test_an_image_above_pillows_pixel_limit_raises(tmp_path, w, h):
    """A frame header of more pixels than Pillow opens raises ``ValueError``
    from the header alone, before anything of the image's size is allocated;
    Pillow raises ``DecompressionBombError``."""
    def build(seg):
        return seg[:5] + h.to_bytes(2, "big") + w.to_bytes(2, "big") + seg[9:]

    path = _patched(tmp_path, 0xC0, build)
    with pytest.raises(ValueError, match="image too large"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)


def test_timing_script(tmp_path):
    """``tests/jpeg_timing.py`` at a small size: its frames decode exactly as
    Pillow's, and each gets a time from both decoders."""
    from tests import jpeg_timing

    paths = jpeg_timing.write_frames(str(tmp_path), {"a": (33, 17), "b": (48, 64)})
    res = jpeg_timing.time_frames([jpeg_timing.FIXTURE] + paths, reps=1)
    assert res["pillow"] and [(f["width"], f["height"]) for f in res["frames"]] == \
        [(160, 120), (33, 17), (48, 64)]
    assert all(f["port_ms"] > 0 and f["pillow_ms"] > 0 for f in res["frames"])


def test_image_ref_picks_the_codec(tmp_path):
    """PNG and JPEG frames, RGB and grey, through the port's ref and JAX's
    (Pillow): PNG exact, JPEG to the tolerance; a frame of another size
    resized with LANCZOS after the decode, as JAX's ref does."""
    rgb, grey = make_image(37, 23), make_image(37, 23, channels=1, seed=2)
    paths = {}
    for name, img in (("rgb", rgb), ("grey", grey)):
        paths[name + ".png"] = str(tmp_path / f"{name}.png")
        png.write_png(paths[name + ".png"], img)
        paths[name + ".jpg"] = str(tmp_path / f"{name}.jpg")
        Image.fromarray(img).save(paths[name + ".jpg"], quality=90)
    for name, path in paths.items():
        got = ImageRef(path, (37, 23))()
        want = JImageRef(path, (37, 23))()
        assert got.shape == want.shape == (23, 37, 3)
        if name.endswith(".png"):
            np.testing.assert_array_equal(got, want)
        else:
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= CS.JPEG_MAX_LEVELS and d.mean() <= CS.JPEG_MEAN_LEVELS
    got = ImageRef(paths["rgb.jpg"], (38, 23))()
    np.testing.assert_array_equal(got, resize(jpeg.read_jpeg(paths["rgb.jpg"]), (38, 23),
                                              "lanczos"))
    d = np.abs(got.astype(int) - JImageRef(paths["rgb.jpg"], (38, 23))().astype(int))
    assert d.max() <= CS.JPEG_MAX_LEVELS and d.mean() <= CS.JPEG_MEAN_LEVELS
    (tmp_path / "x.bin").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        ImageRef(str(tmp_path / "x.bin"), (1, 1))()


def write_committed_fixtures(out_dir):
    """Write ``tests/torch_fixtures/jpeg``: the twelve 160×120 frames of
    ``chip_smoke.py`` phase 12 (b)'s scenes (K1's plain version renders the
    GT scene on white at each ring camera and time,
    :func:`chip_smoke.jpeg_scene_camera`; Pillow, quality 90, 4:2:0), six
    files of the decoder's other formats (grey, 4:4:4 with restart
    intervals, 4:2:2 at an odd size, 16-bit tables, optimised Huffman
    tables, Adobe RGB), and ``pillow_decode.npz``, Pillow's decode of each
    by file stem."""
    os.makedirs(out_dir, exist_ok=True)
    cpu = torch.device("cpu")
    decodes = {}

    def save(name, img, **options):
        path = os.path.join(out_dir, name + ".jpg")
        Image.fromarray(img).save(path, **options)
        decodes[name] = np.asarray(Image.open(path))

    for c in range(CS.JPEG_SCENE_CAMS):
        for f in range(CS.JPEG_SCENE_FRAMES):
            cam = CS.jpeg_scene_camera(c, f)[0]
            save(f"frame_c{c}_f{f}", CS.render_gt(cam, cpu, [1.0] * 3), quality=90)
    save("grey_q75_37x23", make_image(37, 23, channels=1, seed=3), quality=75)
    save("q95_444_rst_32x24", make_image(32, 24, seed=4), quality=95, subsampling=0,
         restart_marker_blocks=2)
    save("q50_422_7x5", make_image(7, 5, seed=5), quality=50, subsampling=1)
    save("qt16_420_33x17", make_image(33, 17, seed=6), qtables=[[300] * 64, [400] * 64])
    save("optimize_rows_420_29x31", make_image(29, 31, seed=7), quality=70,
         optimize=True, restart_marker_rows=1)
    save("adobe_rgb_16x16", make_image(16, 16, seed=8), quality=85, keep_rgb=True)
    # np.savez_compressed's layout at zlib's highest level, to keep the
    # committed files under 200 KB
    with zipfile.ZipFile(os.path.join(out_dir, "pillow_decode.npz"), "w",
                         zipfile.ZIP_DEFLATED, compresslevel=9) as zf:
        for name, arr in decodes.items():
            with zf.open(name + ".npy", "w") as f:
                np.lib.format.write_array(f, arr)
    return decodes


def committed():
    with np.load(os.path.join(FIXTURES, "pillow_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def test_committed_fixtures_against_their_decodes():
    want = committed()
    names = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    assert names == sorted(want) and len(names) == 18
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 200_000, total
    for name in names:
        path = os.path.join(FIXTURES, name + ".jpg")
        check_against_pillow(path, want[name])
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want[name])
    # the scenes' frames show the balls on white
    frame = want["frame_c0_f0"]
    assert frame.shape == (120, 160, 3) and frame.min() < 128 and frame.max() == 255


def test_the_generator_wrote_the_committed_fixtures(tmp_path):
    got = write_committed_fixtures(str(tmp_path))
    want = committed()
    assert sorted(got) == sorted(want)
    for name in want:
        d = np.abs(got[name].astype(int) - want[name].astype(int))
        assert d.max() <= CS.JPEG_MAX_LEVELS and d.mean() <= CS.JPEG_MEAN_LEVELS, name


def test_links_no_jpeg_library():
    assert not any("jpeg" in f for f in jpeg.LINK_FLAGS + native.CXX_FLAGS)
    lib = native.build(jpeg.SRC, jpeg.LINK_FLAGS)
    code = ("import ctypes, sys; ctypes.CDLL(sys.argv[1]); "
            "print(open('/proc/self/maps').read())")
    maps = subprocess.run([sys.executable, "-c", code, str(lib)], capture_output=True,
                          text=True, check=True).stdout
    assert str(lib) in maps
    assert not re.search(r"lib(turbo)?jpeg\.so", maps)
