"""PNG reader and writer on ``zlib`` and numpy: the port's only image I/O.

The JAX package reads and writes frames with Pillow (``data/blender.py``,
``render.py``, ``metrics.py``, ``utils/observability.py``); the card's machine
has no Pillow, so the port keeps this codec. It handles what those paths
read and write: 8-bit grayscale, gray + alpha, RGB and RGBA, non-interlaced,
every filter type (0 none, 1 sub, 2 up, 3 average, 4 Paeth) on read; the
writer filters every row with one type (default 2, up). Palette, 16-bit and
interlaced files raise ``NotImplementedError``.

The reader undoes the filters with numpy, one anti-diagonal of pixels at a
time (:func:`_unfilter`): H + W − 1 steps for any mix of filter types.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of every element (int arrays)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row of ``rows`` [H, stride] uint8 with ``ftype``."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                            # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]               # up-left
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    elif ftype == 4:
        pred = _paeth(a, b, c)
    else:
        raise ValueError(f"PNG filter type {ftype} (0-4)")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write ``img``, uint8 [H, W] (gray) or [H, W, C] with C in 1-4 (gray,
    gray + alpha, RGB, RGBA), as a PNG with every row filtered by
    ``filter_type``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], not {img.shape}")
    h, w, ch = img.shape
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    filtered = _filter_rows(rows, ch, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each row's filter. A pixel's reconstruction reads the pixels to
    its left, above and above-left, so the pixels of one anti-diagonal (row
    + column constant) depend only on the two anti-diagonals before it: the
    image is undone one anti-diagonal at a time, each pixel by its row's
    filter, in a skewed copy where every anti-diagonal is one slice."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, not {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    ftypes = data[:, 0]
    if (ftypes > 4).any():
        y = int(np.argmax(ftypes > 4))
        raise ValueError(f"PNG row {y} has filter type {ftypes[y]}")
    w = stride // bpp
    n_diag = h + w - 1
    ys = np.arange(h)
    xs = np.arange(n_diag)[:, None] - ys                        # [D, H]
    filtered = data[:, 1:].reshape(h, w, bpp)[ys, np.clip(xs, 0, w - 1)].astype(np.int16)
    # out[d + 2, y + 1] is pixel (y, d − y); the other cells, outside the
    # image, stay 0 as the filters read them
    out = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    sub, up, avg, paeth = ((ftypes == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4))
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[d + 1, y0 + 1:y1 + 1]                           # left
        b = out[d + 1, y0:y1]                                   # up
        c = out[d, y0:y1]                                       # up-left
        pred = (sub[y0:y1] * a + up[y0:y1] * b + avg[y0:y1] * ((a + b) >> 1)
                + paeth[y0:y1] * _paeth(a, b, c))
        out[d + 2, y0 + 1:y1 + 1] = (filtered[d, y0:y1] + pred) & 0xFF
    return out[ys[:, None] + np.arange(w) + 2, ys[:, None] + 1].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Read a PNG as uint8: [H, W] for grayscale, else [H, W, C] (C 2, 3
    or 4), as ``np.asarray(PIL.Image.open(path))`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} (8-bit gray/gray+alpha/RGB/RGBA, non-interlaced only)")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def convert(img: np.ndarray, mode: str) -> np.ndarray:
    """``PIL.Image.convert(mode)`` of a :func:`read_png` array for ``mode``
    "L" [H, W], "RGB" or "RGBA" [H, W, C]: gray is replicated, alpha is
    dropped or set to 255, and colour goes to gray by Pillow's ITU-R 601-2
    luma in fixed point."""
    if img.ndim == 2:
        img = img[:, :, None]
    ch = img.shape[2]
    color = img[:, :, :1].repeat(3, axis=2) if ch <= 2 else img[:, :, :3]
    alpha = img[:, :, ch - 1:] if ch in (2, 4) else np.full_like(img[:, :, :1], 255)
    if mode == "RGB":
        return np.ascontiguousarray(color)
    if mode == "RGBA":
        return np.concatenate([color, alpha], axis=2)
    if mode == "L":
        if ch <= 2:
            return np.ascontiguousarray(img[:, :, 0])
        r, g, b = (color[:, :, i].astype(np.uint32) for i in range(3))
        return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"convert to {mode!r} (L, RGB or RGBA)")
