"""``fourdgs_tpu_torch/utils/png.py``'s reader on every PNG variant Pillow
opens, bit for bit against Pillow 12: ``read_png(p)`` against
``np.asarray(Image.open(p))`` and ``read_png(p, mode)`` against
``np.asarray(Image.open(p).convert(mode))`` for "L", "RGB" and "RGBA".

- Files Pillow writes: palette files at 1, 2, 4 and 8 bits (with and
  without ``tRNS``), 1-bit gray, 16-bit gray, and 8-bit gray and RGB with a
  ``tRNS`` colour key.
- Files :func:`encode_png` writes, since Pillow writes no 2- or 4-bit gray,
  no 16-bit RGB, gray + alpha or RGBA and no interlaced file: every
  (bit depth, colour type) pair PNG allows, non-interlaced and Adam7, every
  filter type among the rows, odd sizes (1×1 to 37×23), with and without
  ``tRNS``; Pillow decodes each.
- Pillow's rules for 16-bit samples, pinned against Pillow: a 16-bit gray
  file opens as ``I;16`` and its conversions clip to 255; 16-bit RGB, gray +
  alpha and RGBA keep the high byte. The ``tRNS`` key compares its low
  byte with the converted colour.
- The committed fixtures of ``tests/torch_fixtures/variants`` (PNG files
  and their Pillow decodes, for the card's host, which cannot write them).
- What is no PNG (colour type 3 at 16 bits, a bit depth of 3) raises
  ``ValueError``, as Pillow refuses it; 8-bit files read as before
  (``tests/test_torch_png.py``).
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu_torch.utils import png

MODES = ("L", "RGB", "RGBA")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (bit depth, colour type) PNG allows
FORMATS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3),
           (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(px, depth):
    """[h, w, n] samples → [h, stride] bytes of one image or Adam7 pass."""
    h = px.shape[0]
    flat = px.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(rows, bpp, seed):
    """Each row filtered by a type drawn from 0-4."""
    types = np.random.default_rng(seed).integers(0, 5, rows.shape[0])
    out = np.stack([png._filter_rows(rows, bpp, t) for t in range(5)])
    return np.concatenate([types[:, None].astype(np.uint8),
                           out[types, np.arange(rows.shape[0])]], axis=1)


def encode_png(px, depth, ctype, interlace=False, plte=None, trns=None, seed=0):
    """A PNG of the samples ``px`` [h, w, n] at ``depth``, colour type
    ``ctype``, every row filtered by a random type, Adam7 if ``interlace``."""
    h, w, n = px.shape
    bpp = max(1, n * depth // 8)
    if interlace:
        parts = [_filtered(_pack(px[y0::dy, x0::dx], depth), bpp, seed + i)
                 for i, (x0, y0, dx, dy) in enumerate(ADAM7)
                 if w > x0 and h > y0]
        raw = b"".join(p.tobytes() for p in parts)
    else:
        raw = _filtered(_pack(px, depth), bpp, seed).tobytes()
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def variant(depth, ctype, size=(13, 9), interlace=False, with_trns=False, seed=0):
    """The bytes of a PNG of random samples of ``(depth, ctype)``: a palette
    file gets fewer ``PLTE`` entries than its indices reach, and its
    ``tRNS`` fewer than ``PLTE``; a gray or RGB file's ``tRNS`` key is one of
    its own pixels."""
    rng = np.random.default_rng(seed)
    w, h = size
    n = SAMPLES[ctype]
    px = rng.integers(0, 1 << depth, (h, w, n), dtype=np.int64)
    if depth == 16:     # some samples at the clip's edges and under 256
        px.reshape(-1)[::5] = rng.choice([0, 1, 255, 256, 257, 65535], px.size // 5 + 1)[
            :len(px.reshape(-1)[::5])]
    plte = trns = None
    if ctype == 3:
        n_entries = max(1, (1 << depth) - 1)
        plte = rng.integers(0, 256, 3 * n_entries, dtype=np.uint8).tobytes()
        if with_trns:
            trns = rng.integers(0, 256, max(1, n_entries - 1), dtype=np.uint8).tobytes()
    elif with_trns and ctype in (0, 2):
        key = px[h // 2, w // 2]
        trns = struct.pack(f">{n}H", *key)
    return encode_png(px, depth, ctype, interlace, plte, trns, seed)


def check_against_pillow(path):
    """read_png against Pillow's decode and each conversion; returns
    Pillow's decodes by mode (None: ``np.asarray(Image.open(path))``)."""
    with Image.open(path) as im:
        want = {None: np.asarray(im), **{m: np.asarray(im.convert(m)) for m in MODES}}
    for mode, w in want.items():
        g = png.read_png(str(path), mode)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, mode, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{path} {mode}")
    return want


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth,ctype", FORMATS, ids=lambda v: str(v))
def test_every_format_matches_pillow(tmp_path, depth, ctype, interlace):
    for i, (size, with_trns) in enumerate([((13, 9), False), ((37, 23), True),
                                           ((1, 1), True), ((2, 7), False)]):
        path = tmp_path / f"v{i}.png"
        path.write_bytes(variant(depth, ctype, size, interlace, with_trns, seed=i))
        check_against_pillow(path)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
def test_files_pillow_writes(tmp_path):
    """Palette files at each bit depth Pillow writes (``bits``), with one
    transparent index or per-entry alpha; 1-bit and 16-bit gray; gray and
    RGB with a colour key; each also ``optimize``d."""
    rng = np.random.default_rng(3)
    rgb = Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8))
    files = {}
    for bits, colours in ((1, 2), (2, 4), (4, 16), (8, 256)):
        pal = rgb.quantize(colours)
        files[f"p{bits}"] = (pal, {"bits": bits})
        files[f"p{bits}_key"] = (pal, {"bits": bits, "transparency": 1})
        files[f"p{bits}_alpha"] = (pal, {"bits": bits,
                                         "transparency": bytes(range(0, 256, 37))})
    files["bit"] = (rgb.convert("1"), {})
    files["bit_key"] = (rgb.convert("1"), {"transparency": 1})
    grey16 = rng.integers(0, 65536, (23, 37)).astype(np.uint16)
    grey16[0, :6] = [0, 1, 255, 256, 300, 65535]
    files["i16"] = (Image.fromarray(grey16), {})
    files["i16_key"] = (Image.fromarray(grey16), {"transparency": 255})
    files["l_key"] = (rgb.convert("L"), {"transparency": int(np.asarray(rgb.convert("L"))[3, 3])})
    files["rgb_key"] = (rgb, {"transparency": tuple(int(v) for v in np.asarray(rgb)[4, 4])})
    for name, (im, opts) in files.items():
        for optimize in (False, True):
            path = tmp_path / f"{name}_{optimize}.png"
            im.save(path, optimize=optimize, **opts)
            check_against_pillow(path)


def test_pillows_sixteen_bit_rule(tmp_path):
    """The rule Pillow 12 applies to 16-bit samples, established against
    Pillow here rather than assumed: gray opens as ``I;16`` with every bit
    and clips to 255 on conversion; RGB, gray + alpha and RGBA keep each
    sample's high byte (gray + alpha opening as RGBA); a gray key of 256
    matches 0 (its low byte)."""
    grey = np.array([[[0], [1], [255], [256], [300], [65535]]])
    path = tmp_path / "g.png"
    path.write_bytes(encode_png(grey, 16, 0, trns=struct.pack(">H", 256)))
    with Image.open(path) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(np.asarray(im), grey[:, :, 0])
        assert np.asarray(im.convert("L")).tolist() == [[0, 1, 255, 255, 255, 255]]
        assert np.asarray(im.convert("RGBA"))[0, :, 3].tolist() == [0, 255, 255, 255, 255, 255]
    want = check_against_pillow(path)
    assert want["L"].tolist() == [[0, 1, 255, 255, 255, 255]]
    for ctype, n, mode in ((2, 3, "RGB"), (4, 2, "RGBA"), (6, 4, "RGBA")):
        px = np.array([[[258 + 513 * k for k in range(n)], [65535 - k for k in range(n)]]])
        path = tmp_path / f"c{ctype}.png"
        path.write_bytes(encode_png(px, 16, ctype))
        with Image.open(path) as im:
            assert im.mode == mode
            high = (px >> 8)[:, :, [0, 0, 0, 1]] if ctype == 4 else px >> 8
            np.testing.assert_array_equal(np.asarray(im), high)
        check_against_pillow(path)


def test_what_is_no_png_raises(tmp_path):
    for depth, ctype in ((16, 3), (3, 0), (4, 2)):
        path = tmp_path / "bad.png"
        path.write_bytes(png.SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 2, 2, depth, ctype, 0, 0, 0)) + _chunk(b"IDAT", zlib.compress(
                bytes(64))) + _chunk(b"IEND", b""))
        with pytest.raises(ValueError, match="no PNG format"):
            png.read_png(str(path))
        with pytest.raises(Exception):
            Image.open(path).load()


# -- committed fixtures --------------------------------------------------------

# name → (depth, colour type, size, Adam7, tRNS)
PNG_FIXTURES = {
    "palette4_trns_adam7_23x17": (4, 3, (23, 17), True, True),
    "palette1_13x9": (1, 3, (13, 9), False, False),
    "palette8_trns_19x11": (8, 3, (19, 11), False, True),
    "grey2_key_21x13": (2, 0, (21, 13), False, True),
    "grey1_adam7_9x9": (1, 0, (9, 9), True, False),
    "grey16_key_adam7_17x12": (16, 0, (17, 12), True, True),
    "rgb16_key_15x10": (16, 2, (15, 10), False, True),
    "la16_11x7": (16, 4, (11, 7), False, False),
    "rgba16_adam7_14x9": (16, 6, (14, 9), True, False),
    "rgb8_adam7_33x21": (8, 2, (33, 21), True, False),
}


def write_png_fixtures(out_dir, decodes):
    """Write :data:`PNG_FIXTURES` into ``out_dir`` and put Pillow's decodes
    of each in ``decodes`` as ``<name>`` (``np.asarray``) and
    ``<name>.<mode>``."""
    for i, (name, (depth, ctype, size, adam7, trns)) in enumerate(PNG_FIXTURES.items()):
        path = os.path.join(out_dir, name + ".png")
        with open(path, "wb") as f:
            f.write(variant(depth, ctype, size, adam7, trns, seed=100 + i))
        with Image.open(path) as im:
            decodes[name] = np.asarray(im)
            for mode in MODES:
                decodes[f"{name}.{mode}"] = np.asarray(im.convert(mode))


def test_committed_png_fixtures():
    want = CS.variant_decodes()
    for name in PNG_FIXTURES:
        path = os.path.join(CS.VARIANT_FIXTURES, name + ".png")
        for mode in (None, *MODES):
            key = name if mode is None else f"{name}.{mode}"
            np.testing.assert_array_equal(png.read_png(path, mode), want[key], err_msg=key)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGBA")), want[f"{name}.RGBA"])


def test_eight_bit_reads_are_unchanged(tmp_path):
    """An 8-bit RGBA file written by the port reads as before, with and
    without a mode."""
    img = np.random.default_rng(0).integers(0, 256, (9, 11, 4), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.read_png(path, "RGBA"), img)
    np.testing.assert_array_equal(png.read_png(path, "RGB"), png.convert(img, "RGB"))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    (tmp_path / "b.png").write_bytes(buf.getvalue())
    check_against_pillow(tmp_path / "b.png")
