"""``fourdgs_tpu_torch/utils/png.py`` against Pillow: round trips bit for
bit, Pillow reads what it writes, it reads what Pillow writes (whose rows
use each filter type) as Pillow does, and its conversions equal Pillow's.
The other PNG variants: ``tests/test_torch_png_variants.py``."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fourdgs_tpu_torch.utils import png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _image(ch, seed=0, h=37, w=29):
    """Smooth gradients (which the predictors fit) with noisy rows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [x * 7 + y * 3, (x + y) * 4, (x * y) % 251, 255 - 2 * x]
    img = (np.stack(planes[:ch], axis=-1) % 256).astype(np.uint8)
    img[::4] = rng.integers(0, 256, img[::4].shape)
    return img[:, :, 0] if ch == 1 else img


def _filter_types(data: bytes) -> set:
    """The filter type of every row of a PNG file's image data."""
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    return {raw[i * stride] for i in range(h)}


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_round_trip_and_pillow_reads_it(tmp_path, ch, ftype):
    img = _image(ch, seed=ftype)
    path = str(tmp_path / "a.png")
    png.write_png(path, img, filter_type=ftype)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as im:
        assert im.mode == MODES[ch]
        np.testing.assert_array_equal(np.asarray(im), img)
    with open(path, "rb") as f:
        assert _filter_types(f.read()) == {ftype}


def test_reads_pillow_files_as_pillow_does(tmp_path):
    seen = set()
    for ch in (1, 2, 3, 4):
        for seed in range(3):
            img = _image(ch, seed, h=48, w=40)
            path = str(tmp_path / f"p{ch}{seed}.png")
            Image.fromarray(img, MODES[ch]).save(path)
            with open(path, "rb") as f:
                seen |= _filter_types(f.read())
            with Image.open(path) as im:
                want = np.asarray(im)
                for mode in ("L", "RGB", "RGBA"):
                    np.testing.assert_array_equal(
                        png.convert(png.read_png(path), mode),
                        np.asarray(im.convert(mode)), err_msg=f"{ch} {mode}")
            np.testing.assert_array_equal(png.read_png(path), want)
    assert seen >= {0, 1, 2, 4}, seen   # Pillow picks a filter per row


def test_rejects_what_it_does_not_read(tmp_path):
    """Palette and 16-bit files, which the reader once refused, now read as
    Pillow reads them (every variant: ``tests/test_torch_png_variants.py``);
    what is no PNG still raises, and the writer takes uint8 only."""
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(3)).convert("P").save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.read_png(path), np.asarray(im))
        np.testing.assert_array_equal(png.read_png(path, "RGB"), np.asarray(im.convert("RGB")))
    Image.fromarray(_image(1).astype(np.uint16) * 200).save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.read_png(path), np.asarray(im))
        np.testing.assert_array_equal(png.read_png(path, "L"), np.asarray(im.convert("L")))
    with open(path, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(path)
    with pytest.raises(ValueError):
        png.write_png(path, np.zeros((4, 4), np.float32))
