"""PNG reader and writer on ``zlib`` and numpy: the port's only image I/O.

The JAX package reads and writes frames with Pillow (``data/blender.py``,
``render.py``, ``metrics.py``, ``utils/observability.py``); the card's machine
has no Pillow, so the port keeps this codec. The reader takes every PNG
Pillow 12 opens (its ``PngImagePlugin._MODES``): gray at 1, 2, 4, 8 and 16
bits, RGB, gray + alpha and RGBA at 8 and 16 bits, palette files at 1, 2, 4
and 8 bits (``PLTE``, with ``tRNS`` alpha), the ``tRNS`` colour key of gray
and RGB files, Adam7 interlacing, and every filter type (0 none, 1 sub, 2
up, 3 average, 4 Paeth). ``read_png(path, mode)`` gives what
``Image.open(path).convert(mode)`` gives, Pillow's rules included (each is
pinned by ``tests/test_torch_png_variants.py``):

- a 16-bit RGB, gray + alpha or RGBA sample is read as its high byte (gray
  + alpha then opens as RGBA), while a 16-bit gray file opens as ``I;16``,
  whose conversions clip each sample to 255;
- 2- and 4-bit gray samples are scaled to 8 bits (× 85, × 17) and 1-bit ones
  to 0 / 255;
- to RGBA, a gray or RGB file's ``tRNS`` key makes alpha 0 where the
  converted 8-bit colour equals the key's low bytes (a 1-bit file's key is
  0 or 255, a 2- or 4-bit file's stays unscaled, as Pillow keeps it);
- a palette entry past ``PLTE`` is black, and one past ``tRNS`` opaque.

The writer filters every row with one type (default 2, up) and writes 8-bit
gray, gray + alpha, RGB or RGBA.

The reader undoes the filters with numpy, one anti-diagonal of pixels at a
time (:func:`_unfilter`): H + W − 1 steps for any mix of filter types.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA)
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the writer's channels → colour type
_COLOR_TYPE = {c: t for t, c in _SAMPLES.items() if t != 3}


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


# (bit depth, colour type) → Pillow's mode (PngImagePlugin._MODES)
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
          (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P", (4, 3): "P",
          (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(path: str, data: bytes) -> tuple[tuple, list[bytes], bytes | None, bytes | None]:
    """(IHDR fields, IDAT bodies, PLTE, tRNS) of a PNG file's bytes; each
    chunk's CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, plte, trns = 8, None, [], None, None
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
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return header, idat, plte, trns


def _samples(raw: bytes, w: int, h: int, depth: int, n: int) -> tuple[np.ndarray, int]:
    """The [h, w, n] samples of a non-interlaced image (or one Adam7 pass)
    at the head of ``raw`` (uint8, or uint16 at depth 16), and the bytes it
    took."""
    stride = -(-w * n * depth // 8)
    size = h * (stride + 1)
    rows = _unfilter(raw[:size], h, stride, max(1, n * depth // 8))
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        px = rows
    else:       # 1, 2, 4 bits, most significant first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=2, dtype=np.uint8)
    return px[:, :w * n].reshape(h, w, n), size


def _decode(path: str) -> tuple[str, np.ndarray, object, np.ndarray | None]:
    """Pillow's image of a PNG file: (mode, pixels as ``np.asarray`` gives
    them, ``info["transparency"]`` or None, the palette [256, 4] RGBA of a
    "P" file)."""
    with open(path, "rb") as f:
        header, idat, plte, trns = _chunks(path, f.read())
    w, h, depth, ctype, _, _, interlace = header
    mode = _MODES.get((depth, ctype))
    if mode is None or interlace > 1:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} is no PNG format")
    n = _SAMPLES[ctype]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        px = _samples(raw, w, h, depth, n)[0]
    else:
        px = np.zeros((h, w, n), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], used = _samples(raw[pos:], pw, ph, depth, n)
                pos += used
    transparency, palette = None, None
    if ctype == 3:
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        entries = np.frombuffer(plte or b"", np.uint8)[:768].reshape(-1, 3)
        palette[:len(entries), :3] = entries
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            palette[:len(alpha), 3] = alpha
        return mode, px[:, :, 0].astype(np.uint8), None, palette
    if trns is not None and ctype in (0, 2):
        key = struct.unpack(f">{n}H", trns[:2 * n])
        transparency = (255 if key[0] else 0) if depth == 1 else (
            key[0] if ctype == 0 else key)
    if depth == 16 and ctype != 0:      # Pillow keeps the high byte
        px = (px >> 8).astype(np.uint8)
    if ctype == 4 and depth == 16:      # LA;16B opens as RGBA
        px = px[:, :, [0, 0, 0, 1]]
    if ctype == 0:
        px = px[:, :, 0]
        if depth == 1:
            return mode, px.astype(bool), transparency, None
        if depth < 8:
            px = px * (255 // ((1 << depth) - 1))
    return mode, px, transparency, None


def read_png(path: str, mode: str | None = None) -> np.ndarray:
    """Read a PNG. Without ``mode``: ``np.asarray(PIL.Image.open(path))``,
    [H, W] for gray (bool for a 1-bit file, uint16 for a 16-bit one, palette
    indices for a palette file), else uint8 [H, W, C] (C 2, 3 or 4). With
    ``mode`` "L", "RGB" or "RGBA": ``np.asarray(Image.open(path).convert(mode))``
    (see the module docstring for Pillow's rules)."""
    pil_mode, px, transparency, palette = _decode(path)
    if mode is None:
        return px
    if pil_mode == "P":
        rgba = palette[px]
        return convert(rgba if mode == "RGBA" else rgba[:, :, :3], mode)
    if pil_mode == "1":
        px = px.astype(np.uint8) * 255
    elif pil_mode == "I;16":
        px = np.minimum(px, 255).astype(np.uint8)
    out = convert(px, mode)
    if mode == "RGBA" and transparency is not None:
        key = np.asarray(transparency, np.int64).reshape(-1) & 0xFF
        out[(out[:, :, :3] == key).all(axis=2), 3] = 0
    return out


def convert(img: np.ndarray, mode: str) -> np.ndarray:
    """``PIL.Image.convert(mode)`` of an 8-bit gray, gray + alpha, RGB or
    RGBA image (a :func:`read_png` array of such a file) for ``mode``
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
