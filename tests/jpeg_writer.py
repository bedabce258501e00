"""A JPEG writer in numpy for the decoder's test fixtures.

The port decodes JPEG files that neither Pillow nor ``cv2.imwrite``
writes: arithmetic-coded (SOF9, SOF10), lossless (SOF3), YCCK, and most
pairs of sampling factors. This module writes them from quantized
DCT coefficients or from samples, after T.81 and libjpeg-turbo's encoder
(jchuff.c and jcphuff.c with optimal tables, jcarith.c, jclhuff.c,
jcpred.c), so that

- the same coefficients written Huffman-coded and arithmetic-coded decode
  equal under Pillow, and
- a lossless file decodes under Pillow to the samples it holds;

the fixtures' generator checks both of each file it writes. It also reads
a baseline file's coefficients back (:func:`read_baseline`), so that a
committed frame can be written again in another coding.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Table D.2: (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS) of each
# state; state 113 is the fixed probability 0.5 (jaricom.c)
QM = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
    (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
    (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
    (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
    (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
    (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
    (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
    (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
    (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0),
]

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def adobe(transform: int) -> bytes:
    """An APP14 Adobe segment with colour ``transform`` (0 none, 1 YCbCr,
    2 YCCK)."""
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int = 0
    coef: np.ndarray | None = None      # DCT: int [bh, bw, 64] natural order, whole MCUs
    samples: np.ndarray | None = None   # lossless: int [dh, dw]
    dw: int = 0
    dh: int = 0


@dataclass
class Frame:
    width: int
    height: int
    comps: list
    qtables: dict = field(default_factory=dict)    # tq -> int [64] natural order
    app: bytes = JFIF                              # APPn segments after SOI

    @property
    def hmax(self):
        return max(c.h for c in self.comps)

    @property
    def vmax(self):
        return max(c.v for c in self.comps)

    def geometry(self, unit=8):
        """Set each component's downsampled size; returns the MCUs per row
        and column of an interleaved scan (``unit`` 8 for DCT, 1 lossless)."""
        hm, vm = self.hmax, self.vmax
        for c in self.comps:
            c.dw = -(-self.width * c.h // hm)
            c.dh = -(-self.height * c.v // vm)
        return -(-self.width // (unit * hm)), -(-self.height // (unit * vm))


# -- coefficients -------------------------------------------------------------

_K = np.arange(8)
DCT8 = np.sqrt(2 / 8) * np.cos((2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16)
DCT8[0] /= np.sqrt(2)


def downsample(plane, factor_h, factor_v, hmax, vmax, rows, cols):
    """The samples of a component ``rows`` × ``cols`` at factors (h, v)
    of a frame whose largest are (hmax, vmax): the mean of the full-size
    samples each covers (whole ratios), or the nearest one (fractional);
    the full-size plane is extended by its edge samples."""
    H, W = plane.shape
    if hmax % factor_h == 0 and vmax % factor_v == 0:
        rh, rv = hmax // factor_h, vmax // factor_v
        ys = np.minimum(np.arange(rows * rv), H - 1)
        xs = np.minimum(np.arange(cols * rh), W - 1)
        full = plane[ys][:, xs]
        return full.reshape(rows, rv, cols, rh).mean(axis=(1, 3))
    ys = np.minimum(np.arange(rows) * vmax // factor_v, H - 1)
    xs = np.minimum(np.arange(cols) * hmax // factor_h, W - 1)
    return plane[ys][:, xs].astype(np.float64)


def dct_frame(planes, factors, qtables, tqs=None, ids=None, app=JFIF) -> Frame:
    """A frame of quantized DCT coefficients: ``planes`` the full-size
    samples of each component (uint8 [H, W], already in the file's colour
    space), ``factors`` each one's (h, v), ``qtables`` tq -> 64 values in
    natural order, ``tqs`` each component's table (0 for the first, else 1)."""
    H, W = planes[0].shape
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    tqs = tqs or [0] + [1] * (n - 1)
    comps = [Component(ids[i], *factors[i], tqs[i]) for i in range(n)]
    frame = Frame(W, H, comps, {k: np.asarray(v, np.int64) for k, v in qtables.items()}, app)
    mcux, mcuy = frame.geometry()
    for c, plane in zip(comps, planes):
        rows, cols = mcuy * 8 * c.v, mcux * 8 * c.h
        # pad the real samples with the last real row and column, as libjpeg does
        real = downsample(plane.astype(np.float64), c.h, c.v, frame.hmax, frame.vmax,
                          c.dh, c.dw)
        s = real[np.minimum(np.arange(rows), c.dh - 1)][:, np.minimum(np.arange(cols),
                                                                        c.dw - 1)]
        blocks = (s - 128.0).reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ui,abij,vj->abuv", DCT8, blocks, DCT8).reshape(rows // 8, cols // 8, 64)
        q = frame.qtables[c.tq]
        c.coef = np.round(f / q).astype(np.int64)
    return frame


def rgb_to_ycc(img):
    """JFIF's RGB -> YCbCr, rounded and clipped (uint8 [H, W, 3])."""
    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


def quality_tables(quality=75):
    """T.81 Annex K's luminance and chrominance tables scaled as libjpeg's
    ``jpeg_set_quality`` scales them, in natural order."""
    lum = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
    chrom = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return {i: np.clip((np.array(t) * scale + 50) // 100, 1, 255)
            for i, t in enumerate((lum, chrom))}


# -- reading a baseline file's coefficients back ---------------------------------

def read_baseline(data: bytes) -> Frame:
    """The quantized coefficients of a baseline or extended Huffman-coded
    file of one interleaved scan (as Pillow writes a frame), with its
    quantization tables and APPn segments."""
    pos, app, qt, huff = 2, b"", {}, {}
    frame = None
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        if marker == 0xD9:
            return frame
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + length]
        if 0xE0 <= marker <= 0xEF:
            app += data[pos:pos + 2 + length]
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                step = 2 if pq else 1
                vals = [int.from_bytes(body[i + 1 + k * step:i + 1 + (k + 1) * step], "big")
                        for k in range(64)]
                t = np.zeros(64, np.int64)
                t[NATURAL] = vals
                qt[tq] = t
                i += 1 + 64 * step
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                counts = body[i + 1:i + 17]
                vals = body[i + 17:i + 17 + sum(counts)]
                huff[body[i] >> 4, body[i] & 15] = canonical_codes(counts, vals, decode=True)
                i += 17 + sum(counts)
        elif marker in (0xC0, 0xC1):
            h, w, nc = (int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"),
                        body[5])
            comps = [Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                               body[8 + 3 * k]) for k in range(nc)]
            frame = Frame(w, h, comps, qt, app)
        elif marker == 0xDD:
            assert int.from_bytes(body[:2], "big") == 0, "restart intervals are not read back"
        elif marker == 0xDA:
            ns = body[0]
            tables = {body[1 + 2 * k]: (body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15)
                      for k in range(ns)}
            assert ns == len(frame.comps)
            pos = _read_baseline_scan(data, pos + 2 + length, frame, tables, huff)
            continue
        pos += 2 + length


def _read_baseline_scan(data, pos, frame, tables, huff):
    end = pos
    while not (data[end] == 0xFF and data[end + 1] not in (0x00,) and
               not 0xD0 <= data[end + 1] <= 0xD7):
        end += 1
    raw = data[pos:end].replace(b"\xff\x00", b"\xff")
    bits = "".join(f"{b:08b}" for b in raw)
    at = 0

    def symbol(table):
        nonlocal at
        code = ""
        while True:
            code += bits[at]
            at += 1
            if code in table:
                return table[code]

    def receive(s):
        nonlocal at
        v = int(bits[at:at + s], 2) if s else 0
        at += s
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v

    mcux, mcuy = frame.geometry()
    for c in frame.comps:
        c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
    pred = [0] * len(frame.comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, c in enumerate(frame.comps):
                td, ta = tables[c.id]
                for vv in range(c.v):
                    for hh in range(c.h):
                        blk = c.coef[my * c.v + vv, mx * c.h + hh]
                        pred[ci] += receive(symbol(huff[0, td]))
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = symbol(huff[1, ta])
                            r, s = rs >> 4, rs & 15
                            if s == 0 and r != 15:
                                break
                            k += r
                            if s:
                                blk[NATURAL[k]] = receive(s)
                            k += 1
    return end


# -- Huffman coding -----------------------------------------------------------------

def optimal_table(freq: dict):
    """jchuff.c's jpeg_gen_optimal_table (T.81 K.2): code lengths of at most
    16 bits for the symbols of ``freq``, none of them all ones; returns the
    counts of each length (16) and the symbols by length."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 10 ** 9
        for i in range(257):
            if f[i] and f[i] <= v:
                v, c1 = f[i], i
        v = 10 ** 9
        for i in range(257):
            if f[i] and f[i] <= v and i != c1:
                v, c2 = f[i], i
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [j for i in range(1, 33) for j in range(256) if codesize[j] == i]
    return bits[1:17], vals


def canonical_codes(counts, vals, decode=False):
    """Symbol -> (code, length) (or the bit string -> symbol) of a table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if decode:
                out[format(code, f"0{length}b")] = vals[k]
            else:
                out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, nbits):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)      # pad with ones

    def marker(self, code):
        self.flush()
        self.out += bytes([0xFF, code])


def category(v):
    """Bits of |v| and the bits sent for v (negative: v - 1, T.81 F.1.2.1)."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v - 1) & ((1 << s) - 1)


class HuffmanScan:
    """The symbols and bits of one Huffman-coded scan, gathered first so
    that each table is optimal for the scan (as ``optimize_coding``)."""

    def __init__(self):
        self.events = []       # ("S", table, symbol) / ("B", value, nbits) / ("R", n)

    def sym(self, table, s):
        self.events.append(("S", table, s))

    def bits(self, value, nbits):
        if nbits:
            self.events.append(("B", value, nbits))

    def restart(self, n):
        self.events.append(("R", n))

    def emit(self) -> tuple[bytes, bytes]:
        """(DHT segments, entropy-coded data)."""
        freq = {}
        for e in self.events:
            if e[0] == "S":
                freq.setdefault(e[1], {}).setdefault(e[2], 0)
                freq[e[1]][e[2]] += 1
        dht, codes = b"", {}
        for (tc, th), f in sorted(freq.items()):
            counts, vals = optimal_table(f)
            dht += segment(0xC4, bytes([tc << 4 | th]) + bytes(counts) + bytes(vals))
            codes[tc, th] = canonical_codes(counts, vals)
        w = BitWriter()
        for e in self.events:
            if e[0] == "S":
                w.put(*codes[e[1]][e[2]])
            elif e[0] == "B":
                w.put(e[1], e[2])
            else:
                w.marker(0xD0 + e[1])
        w.flush()
        return dht, bytes(w.out)


# -- arithmetic coding (jcarith.c) -------------------------------------------------

class ArithEncoder:
    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _byte(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._byte(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe, nm, nl, sw = QM[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):                 # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (sw << 7 | nl)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:                          # renormalization, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _out(self, temp):
        if temp > 0xFF:                      # a carry over the stacked 0xFF bytes
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._byte(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._byte(0xFF)
                    self._byte(0)
                self.sc = 0
            self.buffer = temp & 0xFF

    def finish(self):
        """D.1.8: the shortest tail that ends inside the interval; trailing
        zero bytes are left out (the decoder reads zeros at the marker)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._byte(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._byte(0xFF)
                    self._byte(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self._byte(b)
            if b == 0xFF:
                self._byte(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._byte(b)
                if b == 0xFF:
                    self._byte(0)
        self.zc = 0


class ArithScan:
    """One arithmetic-coded scan: the encoder, the statistics bins of the
    tables it uses and the DC conditioning of each component."""

    def __init__(self, conditioning):
        self.enc = ArithEncoder()
        self.dc_stats, self.ac_stats = {}, {}
        self.fixed = bytearray([113])
        self.cond = conditioning            # (L, U) of each DC table, K of each AC table

    def start(self, dc_tables, ac_tables, comps):
        for t in dc_tables:
            self.dc_stats[t] = bytearray(64)
        for t in ac_tables:
            self.ac_stats[t] = bytearray(256)
        self.last = {c: 0 for c in comps}
        self.context = {c: 0 for c in comps}

    def restart(self, n, dc_tables, ac_tables, comps):
        self.enc.finish()
        self.enc.out += bytes([0xFF, 0xD0 + n])
        out = self.enc.out
        self.enc.reset()
        self.enc.out = out
        self.start(dc_tables, ac_tables, comps)

    def dc(self, comp, table, m):
        """F.1.4.1: the DC value ``m`` (already point-transformed)."""
        enc, stats = self.enc, self.dc_stats[table]
        L, U = self.cond["dc"].get(table, (0, 1))
        st = self.context[comp]
        v = m - self.last[comp]
        if v == 0:
            enc.encode(stats, st, 0)
            self.context[comp] = 0
            return
        self.last[comp] = m
        enc.encode(stats, st, 1)
        if v > 0:
            enc.encode(stats, st + 1, 0)
            st += 2
            self.context[comp] = 4
        else:
            v = -v
            enc.encode(stats, st + 1, 1)
            st += 3
            self.context[comp] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(stats, st, 1)
            m = 1
            v2 = v
            st = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
        enc.encode(stats, st, 0)
        if m < (1 << L) >> 1:
            self.context[comp] = 0
        elif m > (1 << U) >> 1:
            self.context[comp] += 8
        st += 14
        while m > 1:
            m >>= 1
            enc.encode(stats, st, 1 if m & v else 0)

    def _value(self, stats, st, k, v, kx):
        """F.1.4.4.2: a nonzero AC value's sign, category and bits."""
        enc = self.enc
        enc.encode(self.fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        st += 2
        m = 0
        v -= 1
        if v:
            enc.encode(stats, st, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= kx else 217
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        enc.encode(stats, st, 0)
        st += 14
        while m > 1:
            m >>= 1
            enc.encode(stats, st, 1 if m & v else 0)

    def ac(self, table, values, k0, k1):
        """F.1.4.2: the AC values of zigzag positions k0..k1 (point-transformed)."""
        enc, stats = self.enc, self.ac_stats[table]
        kx = self.cond["ac"].get(table, 5)
        ke = k1
        while ke >= k0 and values[ke] == 0:
            ke -= 1
        k = k0
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)
            while values[k] == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            enc.encode(stats, st + 1, 1)
            self._value(stats, st, k, values[k], kx)
            k += 1
        if k <= k1:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, table, values, k0, k1, al):
        """G.1.3.3: the bit ``al`` of each AC value in k0..k1 (``values`` the
        zigzag values)."""
        enc, stats = self.enc, self.ac_stats[table]
        a = [abs(x) >> al for x in values]
        ke = k1
        while ke >= 1 and a[ke] == 0:
            ke -= 1
        kex = ke
        while kex >= 1 and (a[kex] >> 1) == 0:
            kex -= 1
        k = k0
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                if a[k]:
                    if a[k] >> 1:
                        enc.encode(stats, st + 2, a[k] & 1)
                    else:
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0, 0 if values[k] > 0 else 1)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= k1:
            enc.encode(stats, 3 * (k - 1), 1)


# -- DCT files ----------------------------------------------------------------------

SEQUENTIAL = None


def simple_progression(n_comps):
    """libjpeg's jpeg_simple_progression script for YCbCr (3 components)
    or any other count: (component indices, Ss, Se, Ah, Al) per scan."""
    if n_comps == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    comps = tuple(range(n_comps))
    return ([(comps, 0, 0, 0, 1)] + [((c,), 1, 5, 0, 2) for c in comps]
            + [((c,), 6, 63, 0, 2) for c in comps] + [((c,), 1, 63, 2, 1) for c in comps]
            + [(comps, 0, 0, 1, 0)] + [((c,), 1, 63, 1, 0) for c in comps])


def _units(frame, comp_idx, mcux, mcuy, al=0):
    """The blocks of each MCU of a scan: [(component index, zigzag values,
    the AC values divided by 2^al towards zero), ...], as Python lists."""
    zz, tr = {}, {}
    for ci in comp_idx:
        z = frame.comps[ci].coef[..., NATURAL]
        zz[ci] = z.tolist()
        tr[ci] = (np.sign(z) * (np.abs(z) >> al)).tolist()
    if len(comp_idx) == 1:
        ci = comp_idx[0]
        c = frame.comps[ci]
        for by in range(-(-c.dh // 8)):
            for bx in range(-(-c.dw // 8)):
                yield [(ci, zz[ci][by][bx], tr[ci][by][bx])]
        return
    for my in range(mcuy):
        for mx in range(mcux):
            unit = []
            for ci in comp_idx:
                c = frame.comps[ci]
                for vv in range(c.v):
                    for hh in range(c.h):
                        by, bx = my * c.v + vv, mx * c.h + hh
                        unit.append((ci, zz[ci][by][bx], tr[ci][by][bx]))
            yield unit


def _huffman_scan(frame, comp_idx, ss, se, ah, al, progressive, restart, mcux, mcuy):
    hs = HuffmanScan()
    dc_t = {ci: (0, 0 if ci == 0 else 1) for ci in comp_idx}
    ac_t = {ci: (1, 0 if ci == 0 else 1) for ci in comp_idx}
    last = {ci: 0 for ci in comp_idx}
    state = {"eobrun": 0, "be": []}

    def emit_eobrun(table):
        if state["eobrun"]:
            n = state["eobrun"].bit_length() - 1
            hs.sym(table, n << 4)
            hs.bits(state["eobrun"], n)
            state["eobrun"] = 0
            for b in state["be"]:
                hs.bits(b, 1)
            state["be"] = []

    for m, units in enumerate(_units(frame, comp_idx, mcux, mcuy, al)):
        if restart and m and m % restart == 0:
            if ss:
                emit_eobrun(ac_t[comp_idx[0]])
            hs.restart((m // restart - 1) & 7)
            last = {ci: 0 for ci in comp_idx}
        for ci, zz, tr in units:
            if not progressive or (ss == 0 and ah == 0):
                dcv = zz[0] >> al
                s, b = category(dcv - last[ci])
                last[ci] = dcv
                hs.sym(dc_t[ci], s)
                hs.bits(b, s)
            elif ss == 0:
                hs.bits((zz[0] >> al) & 1, 1)
            if not progressive:
                z = zz
                r = 0
                for k in range(1, 64):
                    if z[k] == 0:
                        r += 1
                        continue
                    while r > 15:
                        hs.sym(ac_t[ci], 0xF0)
                        r -= 16
                    s, b = category(z[k])
                    hs.sym(ac_t[ci], r << 4 | s)
                    hs.bits(b, s)
                    r = 0
                if r:
                    hs.sym(ac_t[ci], 0)
            elif ss and ah == 0:                    # jcphuff.c encode_mcu_AC_first
                t = ac_t[ci]
                z = tr
                r = 0
                for k in range(ss, se + 1):
                    if z[k] == 0:
                        r += 1
                        continue
                    emit_eobrun(t)
                    while r > 15:
                        hs.sym(t, 0xF0)
                        r -= 16
                    s, b = category(z[k])
                    hs.sym(t, r << 4 | s)
                    hs.bits(b, s)
                    r = 0
                if r:
                    state["eobrun"] += 1
                    if state["eobrun"] == 0x7FFF:
                        emit_eobrun(t)
            elif ss:                                # jcphuff.c encode_mcu_AC_refine
                t = ac_t[ci]
                absv = [abs(x) >> al for x in zz]
                eob = max([k for k in range(ss, se + 1) if absv[k] == 1], default=0)
                r, br = 0, []
                for k in range(ss, se + 1):
                    temp = absv[k]
                    if temp == 0:
                        r += 1
                        continue
                    while r > 15 and k <= eob:
                        emit_eobrun(t)
                        hs.sym(t, 0xF0)
                        r -= 16
                        for b in br:
                            hs.bits(b, 1)
                        br = []
                    if temp > 1:
                        br.append(temp & 1)
                        continue
                    emit_eobrun(t)
                    hs.sym(t, r << 4 | 1)
                    hs.bits(0 if zz[k] < 0 else 1, 1)
                    for b in br:
                        hs.bits(b, 1)
                    br = []
                    r = 0
                if r > 0 or br:
                    state["eobrun"] += 1
                    state["be"] += br
                    if state["eobrun"] == 0x7FFF or len(state["be"]) > 1000 - 64 + 1:
                        emit_eobrun(t)
    if progressive and ss:
        emit_eobrun(ac_t[comp_idx[0]])
    dht, data = hs.emit()
    tables = {ci: (dc_t[ci][1], ac_t[ci][1]) for ci in comp_idx}
    return dht, data, tables


def _arith_scan(frame, comp_idx, ss, se, ah, al, progressive, restart, mcux, mcuy, cond):
    sc = ArithScan(cond)
    dc_t = {ci: 0 if ci == 0 else 1 for ci in comp_idx}
    ac_t = dict(dc_t)
    dc_used = sorted({dc_t[ci] for ci in comp_idx}) if not progressive or (
        ss == 0 and ah == 0) else []
    ac_used = sorted({ac_t[ci] for ci in comp_idx}) if not progressive or ss else []
    sc.start(dc_used, ac_used, comp_idx)
    for m, units in enumerate(_units(frame, comp_idx, mcux, mcuy, al)):
        if restart and m and m % restart == 0:
            sc.restart((m // restart - 1) & 7, dc_used, ac_used, comp_idx)
        for ci, zz, tr in units:
            if not progressive or (ss == 0 and ah == 0):
                sc.dc(ci, dc_t[ci], zz[0] >> al)
            elif ss == 0:
                sc.enc.encode(sc.fixed, 0, (zz[0] >> al) & 1)
            if not progressive:
                sc.ac(ac_t[ci], zz, 1, 63)
            elif ss and ah == 0:
                sc.ac(ac_t[ci], tr, ss, se)
            elif ss:
                sc.ac_refine(ac_t[ci], zz, ss, se, al)
    sc.enc.finish()
    tables = {ci: (dc_t[ci], ac_t[ci]) for ci in comp_idx}
    return b"", bytes(sc.enc.out), tables


def write_dct(frame: Frame, *, arithmetic=False, scans=SEQUENTIAL, restart=0,
              dac=None, interleaved=True) -> bytes:
    """The frame's coefficients as a sequential (``scans`` None: one
    interleaved scan, or a scan per component) or progressive file
    (``scans`` a list of (component indices, Ss, Se, Ah, Al)), Huffman-coded
    with optimal tables per scan or arithmetic-coded (``dac``: {"dc":
    {table: (L, U)}, "ac": {table: K}}), restart interval ``restart`` MCUs."""
    mcux, mcuy = frame.geometry()
    progressive = scans is not None
    n = len(frame.comps)
    scans = scans or ([(tuple(range(n)), 0, 63, 0, 0)] if interleaved
                      else [((i,), 0, 63, 0, 0) for i in range(n)])
    cond = dac or {"dc": {}, "ac": {}}
    out = b"\xff\xd8" + frame.app
    for tq, t in sorted(frame.qtables.items()):
        wide = int(t.max()) > 255
        vals = t[NATURAL]
        out += segment(0xDB, bytes([(wide << 4) | tq]) + (
            b"".join(int(v).to_bytes(2, "big") for v in vals) if wide else bytes(
                int(v) for v in vals)))
    if arithmetic and dac:
        body = b"".join(bytes([t, u << 4 | lo]) for t, (lo, u) in sorted(cond["dc"].items()))
        body += b"".join(bytes([16 + t, k]) for t, k in sorted(cond["ac"].items()))
        out += segment(0xCC, body)
    if restart:
        out += segment(0xDD, restart.to_bytes(2, "big"))
    sof = (0xCA if progressive else 0xC9) if arithmetic else (0xC2 if progressive else 0xC1)
    out += segment(sof, bytes([8]) + frame.height.to_bytes(2, "big")
                   + frame.width.to_bytes(2, "big") + bytes([len(frame.comps)])
                   + b"".join(bytes([c.id, c.h << 4 | c.v, c.tq]) for c in frame.comps))
    for comp_idx, ss, se, ah, al in scans:
        scan = _arith_scan if arithmetic else _huffman_scan
        args = (cond,) if arithmetic else ()
        dht, data, tables = scan(frame, tuple(comp_idx), ss, se, ah, al, progressive,
                                 restart, mcux, mcuy, *args)
        sos = bytes([len(comp_idx)]) + b"".join(
            bytes([frame.comps[ci].id, tables[ci][0] << 4 | tables[ci][1]]) for ci in comp_idx)
        out += dht + segment(0xDA, sos + bytes([ss, se, ah << 4 | al])) + data
    return out + b"\xff\xd9"


# -- lossless files --------------------------------------------------------------

def predict(s, first_row, psv, pt):
    """jcpred.c's predictions of the samples ``s`` (int [rows, w], already
    point-transformed) for rows whose ``first_row`` is set (1-D, from
    2^(7 - pt) at the left) and the others (predictor ``psv``)."""
    rows, w = s.shape
    p = np.zeros_like(s)
    for y in range(rows):
        if first_row[y]:
            p[y, 0] = 1 << (8 - pt - 1)
            p[y, 1:] = s[y, :-1]
            continue
        ra, rb, rc = s[y, :-1], s[y - 1, 1:], s[y - 1, :-1]
        p[y, 0] = s[y - 1, 0]
        p[y, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
    return p


def pack_bits(values, lengths) -> bytes:
    """The variable-length codes ``values`` (each of ``lengths`` bits, at
    most 32) as one entropy-coded segment: padded with ones to a byte, a
    0x00 stuffed after each 0xFF."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    pad = -total % 8
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    pos = np.arange(total) - starts
    bits = (np.repeat(values, lengths) >> (np.repeat(lengths, lengths) - 1 - pos)) & 1
    raw = np.packbits(np.concatenate([bits.astype(np.uint8), np.ones(pad, np.uint8)]))
    ff = np.flatnonzero(raw == 0xFF)
    return np.insert(raw, ff + 1, 0).tobytes()


def _bit_length(v):
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)


def write_lossless(width, height, comps, *, psv=1, pt=0, restart_rows=0,
                   interleaved=True, app=b"") -> bytes:
    """A lossless file (SOF3, Huffman, optimal tables) of ``comps`` (each a
    :class:`Component` with ``samples`` uint8 [dh, dw] at its factors),
    predictor ``psv``, point transform ``pt``, a restart every
    ``restart_rows`` MCU rows, one interleaved scan or a scan per
    component."""
    frame = Frame(width, height, comps, {}, app)
    mcux, mcuy = frame.geometry(unit=1)
    out = b"\xff\xd8" + app
    scans = [tuple(range(len(comps)))] if interleaved else [(i,) for i in range(len(comps))]
    per_row = {scan: mcux if len(scan) > 1 else comps[scan[0]].dw for scan in scans}
    restarts = {restart_rows * per_row[scan] for scan in scans}
    assert len(restarts) == 1, "one DRI for every scan"
    if restart_rows:
        out += segment(0xDD, restarts.pop().to_bytes(2, "big"))
    out += segment(0xC3, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                   + bytes([len(comps)])
                   + b"".join(bytes([c.id, c.h << 4 | c.v, 0]) for c in comps))
    for scan in scans:
        # each MCU's samples in order: (component, row, column) of every unit
        if len(scan) == 1:
            c = comps[scan[0]]
            rows_per_mcu_row, mcu_rows = {scan[0]: 1}, c.dh
            yy, xx = np.mgrid[0:c.dh, 0:c.dw]
            order = [(scan[0], yy.reshape(c.dh, -1), xx.reshape(c.dh, -1))]
        else:
            rows_per_mcu_row, mcu_rows = {ci: comps[ci].v for ci in scan}, mcuy
            order = []
            for ci in scan:
                c = comps[ci]
                for vv in range(c.v):
                    for hh in range(c.h):
                        my, mx = np.mgrid[0:mcuy, 0:mcux]
                        order.append((ci, my * c.v + vv, mx * c.h + hh))
        diffs = {}
        for ci in scan:
            c = comps[ci]
            assert c.samples.shape == (c.dh, c.dw)
            s = c.samples.astype(np.int64) >> pt
            first = np.zeros(c.dh, bool)
            if restart_rows:
                first[::restart_rows * rows_per_mcu_row[ci]] = True
            first[0] = True
            d = s - predict(s, first, psv, pt)
            # dummy samples of partial MCUs send a zero difference
            diffs[ci] = np.pad(d, ((0, mcuy * c.v + c.dh), (0, mcux * c.h + c.dw)))
        # [mcu_rows, mcus_per_row, units]: each MCU's differences and tables
        d = np.stack([diffs[ci][y, x] for ci, y, x in order], -1)
        tab = np.array([0 if ci == scan[0] else 1 for ci, _, _ in order])
        cat = _bit_length(d)
        extra = np.where(d >= 0, d, d - 1) & ((1 << cat) - 1)
        extra_len = np.where(cat == 16, 0, cat)
        dht, codes = b"", {}
        for t in sorted(set(tab.tolist())):
            counts, vals = optimal_table(
                dict(enumerate(np.bincount(cat[..., tab == t].ravel(), minlength=17).tolist())))
            dht += segment(0xC4, bytes([t]) + bytes(counts) + bytes(vals))
            table = canonical_codes(counts, vals)
            codes[t] = (np.array([table.get(k, (0, 0))[0] for k in range(17)]),
                        np.array([table.get(k, (0, 0))[1] for k in range(17)]))
        code = np.zeros_like(cat)
        code_len = np.zeros_like(cat)
        for t, (cv, cl) in codes.items():
            code[..., tab == t] = cv[cat[..., tab == t]]
            code_len[..., tab == t] = cl[cat[..., tab == t]]
        values = (code << extra_len) | extra
        lengths = code_len + extra_len
        every = restart_rows or mcu_rows
        data = b""
        for i, r0 in enumerate(range(0, mcu_rows, every)):
            if r0:
                data += bytes([0xFF, 0xD0 + (i - 1) % 8])
            data += pack_bits(values[r0:r0 + every].ravel(), lengths[r0:r0 + every].ravel())
        sos = bytes([len(scan)]) + b"".join(bytes([comps[ci].id, (0 if ci == scan[0] else 1)
                                                   << 4]) for ci in scan)
        out += dht + segment(0xDA, sos + bytes([psv, 0, pt])) + data
    return out + b"\xff\xd9"
