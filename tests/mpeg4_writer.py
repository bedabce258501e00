"""An MPEG-4 Part 2 (ISO/IEC 14496-2) writer of random syntax, for the
tests of the port's decoder (``native/mpeg4.cpp``) and phase 18 of
``chip_smoke.py``: numpy only, test code (the port uses none of it).

:func:`write` draws a Simple Profile stream of I- and P-VOPs from a
:class:`Config`: every macroblock type (intra, intra with DQUANT, inter,
inter with DQUANT, inter4v, intra in P-VOPs, not_coded), DQUANT at every
step, AC prediction on and off, the intra DC VLCs and DC coded as a
coefficient (``intra_dc_vlc_thr``), coefficients that need each escape
mode, H.263 and MPEG quantisation (default or loaded matrices), random
``fcode`` and motion vector differences (vectors far outside the
picture), both rounding types, video packets with and without
header_extension_code, N-VOPs, the visual object's video_signal_type and
any size. The decoder's state is not tracked: the vectors and DC levels
are the running sums of random differences, wrapped and clipped as a
decoder reads them. :func:`mp4` wraps a stream in an MP4 file (an
``mp4v`` sample entry whose esds holds the headers), and
:func:`refusal` writes a stream of each feature the decoder refuses.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Tables B-16 and B-17: (code, length) by index, escape last; run and
# level by index; last = 1 from INTRA_LAST / INTER_LAST on
INTRA_VLC = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
    (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
    (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
    (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
    (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7)]
INTRA_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9,
    10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20]
INTRA_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
INTER_VLC = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12),
    (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7)]
INTER_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
INTER_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2,
    3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3,
    1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
INTRA_LAST, INTER_LAST, ESCAPE = 67, 58, 102
# Tables B-6 and B-7: MCBPC (code, length); I: index bit 2 DQUANT; P: bit 2
# intra, bit 3 DQUANT, bit 4 inter4v
INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6)]
INTER_MCBPC = [(1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7), (3, 3), (7, 7),
               (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8)]
MCBPC_STUFFING = (1, 9)
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4),
        (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9),
      (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10),
      (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11),
      (2, 11), (3, 12), (2, 12)]
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
          (1, 9), (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
            (1, 10), (1, 11), (1, 12)]
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
          44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
ALT_HORIZONTAL = [0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24, 25,
                  32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42,
                  43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55,
                  60, 61, 62, 63]
ALT_VERTICAL = [0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,
                11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21, 29,
                36, 44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47,
                55, 63]
# the default MPEG quantisation matrices (raster order)
DEFAULT_INTRA = [8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23,
                 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35,
                 23, 24, 26, 28, 30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32,
                 35, 38, 41, 45]
DEFAULT_INTER = [16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21,
                 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28,
                 21, 22, 23, 24, 26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27,
                 28, 30, 31, 33]
DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]
DQUANT = [-1, -2, 1, 2]


def _tcoef_index(vlc_run, vlc_level, last_at):
    """(last, run, level) -> table index, and LMAX by (last, run), RMAX by
    (last, level)."""
    index, lmax, rmax = {}, {}, {}
    for i in range(102):
        key = (int(i >= last_at), vlc_run[i], vlc_level[i])
        index[key] = i
        lmax[key[:2]] = max(lmax.get(key[:2], 0), key[2])
        rmax[(key[0], key[2])] = max(rmax.get((key[0], key[2]), 0), key[1])
    return index, lmax, rmax


INTRA_TAB = (INTRA_VLC,) + _tcoef_index(INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
INTER_TAB = (INTER_VLC,) + _tcoef_index(INTER_RUN, INTER_LEVEL, INTER_LAST)


class Bits:
    """MSB-first bit writer."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def u(self, n, v):
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        if self.nacc >= 32:
            k = self.nacc // 8
            self.buf += (self.acc >> (self.nacc - 8 * k)).to_bytes(k, "big")
            self.nacc -= 8 * k
            self.acc &= (1 << self.nacc) - 1

    def code(self, c):
        self.u(c[1], c[0])

    @property
    def pos(self):
        return 8 * len(self.buf) + self.nacc

    def stuffing(self):
        """next_start_code / video packet stuffing: a 0, then 1s to the byte
        boundary (a whole byte where aligned)."""
        self.u(1, 0)
        self.u((8 - self.pos % 8) % 8, 0xFF)

    def start(self, code):
        assert self.pos % 8 == 0
        self.u(32, 0x100 | code)

    def bits(self):
        """(int, length) of what was written."""
        return (int.from_bytes(bytes(self.buf), "big") << self.nacc) | self.acc, self.pos

    def tobytes(self):
        assert self.nacc % 8 == 0
        return bytes(self.buf) + (self.acc.to_bytes(self.nacc // 8, "big") if self.nacc else b"")


@dataclasses.dataclass
class Config:
    width: int = 48
    height: int = 32
    frames: int = 3
    seed: int = 0
    gop: int = 12                    # an I-VOP every gop VOPs
    quant_type: int = 0              # 0 H.263, 1 MPEG
    intra_matrix: str = "default"    # "default" or "random" (loaded; MPEG quantisation)
    inter_matrix: str = "default"
    qp: tuple = (2, 31)              # the VOPs' and packets' vop_quant range
    p_dquant: float = 0.3
    p_ac_pred: float = 0.5
    p_coded: float = 0.5             # each block's cbp bit
    p_skip: float = 0.15             # P-VOPs: not_coded
    p_intra: float = 0.1             # P-VOPs: an intra macroblock
    p_4mv: float = 0.3               # P-VOPs: inter4v
    p_stuffing: float = 0.02         # MCBPC stuffing before a macroblock
    p_escape: float = 0.1            # a coefficient drawn to need an escape
    fcode: tuple = (1, 7)            # each P-VOP's vop_fcode_forward range
    p_big_mv: float = 0.1            # a vector difference drawn over its whole range
    rounding: str = "alternate"      # "alternate", "random", "0" or "1"
    dc_thr: tuple = (0, 7)           # intra_dc_vlc_thr code range
    packets: int = 0                 # macroblocks a video packet (0: one packet a VOP)
    p_hec: float = 0.5               # a video packet with header_extension_code
    n_vops: tuple = ()               # VOP numbers coded as N-VOPs (vop_coded 0)
    video_signal: tuple = None       # (video_range, matrix_coefficients or None)
    vol_control: bool = True         # vol_control_parameters (then low_delay)
    low_delay: int = 1
    user_data: bytes = b"Lavc62.28.101"
    time_resolution: int = 25
    in_band: bool = False            # headers in the first sample, not the esds
    row_repeat: bool = False         # one video packet a macroblock row, coded once a VOP
    vol: dict = None                 # header fields outside the decoder's scope (refusal)


class Writer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.mbw = (cfg.width + 15) // 16
        self.mbh = (cfg.height + 15) // 16
        self.mb_num = self.mbw * self.mbh
        self.time_bits = max(1, int(cfg.time_resolution - 1).bit_length())
        self.mb_bits = max(1, int(self.mb_num - 1).bit_length())
        self._quant_cache = {}
        # a loaded matrix (zigzag order): its first n values sent, then a 0
        # (n < 64) and the last value repeating
        self.sent = {}
        for kind in ("intra", "inter"):
            m = None
            if getattr(cfg, kind + "_matrix") == "random":
                n = int(self.rng.integers(1, 65))
                m = [int(v) for v in self.rng.integers(1, 256, n)]
                self.sent[kind] = list(m)
                m += [m[-1]] * (64 - n)
            setattr(self, kind + "_matrix", m)

    # ---------------------------------------------------------- headers

    def headers(self) -> bytes:
        """VOS, VO and VOL headers and user data, as FFmpeg's encoder
        writes them (with the config's variants)."""
        c, b = self.cfg, Bits()
        b.start(0xB0)
        b.u(8, (c.vol or {}).get("profile", 0x01))  # profile_and_level_indication: Simple L1
        b.start(0xB5)
        b.u(1, 1)                            # is_visual_object_identifier
        b.u(4, 1)
        b.u(3, 1)
        b.u(4, 1)                            # visual_object_type: video
        if c.video_signal is None:
            b.u(1, 0)
        else:
            rng_, matrix = c.video_signal
            b.u(1, 1)
            b.u(3, 5)                        # video_format: unspecified
            b.u(1, rng_)
            b.u(1, matrix is not None)
            if matrix is not None:
                b.u(8, 1)
                b.u(8, 1)
                b.u(8, matrix)
        b.stuffing()
        v = c.vol or {}
        verid = 2 if {"quarter_sample", "newpred", "reduced_res"} & set(v) else 1
        b.start(0x00)                        # video_object_start_code
        b.start(0x20)                        # video_object_layer_start_code
        b.u(1, 0)                            # random_accessible_vol
        b.u(8, v.get("vo_type", 1))          # video_object_type_indication: simple
        b.u(1, 1)                            # is_object_layer_identifier
        b.u(4, verid)
        b.u(3, 1)
        b.u(4, 1)                            # aspect_ratio_info: square
        b.u(1, int(c.vol_control))
        if c.vol_control:
            b.u(2, v.get("chroma_format", 1))  # 4:2:0
            b.u(1, c.low_delay)
            b.u(1, 0)                        # vbv_parameters
        b.u(2, v.get("shape", 0))            # rectangular
        b.u(1, 1)
        b.u(16, c.time_resolution)
        b.u(1, 1)
        b.u(1, 0)                            # fixed_vop_rate
        b.u(1, 1)
        b.u(13, c.width)
        b.u(1, 1)
        b.u(13, c.height)
        b.u(1, 1)
        b.u(1, v.get("interlaced", 0))
        b.u(1, 1)                            # obmc_disable
        b.u(verid, v.get("sprite", 0))       # sprite_enable
        if "bit_depth" in v:                 # not_8_bit: quant_precision, bits_per_pixel
            b.u(1, 1)
            b.u(4, 5)
            b.u(4, v["bit_depth"])
        else:
            b.u(1, 0)
        b.u(1, c.quant_type)
        if c.quant_type:
            for kind in ("intra", "inter"):
                m = self.sent.get(kind)
                b.u(1, m is not None)
                if m is not None:
                    for val in m:
                        b.u(8, val)
                    if len(m) < 64:
                        b.u(8, 0)
        if verid != 1:
            b.u(1, v.get("quarter_sample", 0))
        b.u(1, 0 if v.get("complexity") else 1)  # complexity_estimation_disable
        b.u(1, int(c.packets == 0 and not c.row_repeat))  # resync_marker_disable
        b.u(1, v.get("data_partitioned", 0))
        if v.get("data_partitioned"):
            b.u(1, v.get("rvlc", 0))
        if verid != 1:
            b.u(1, v.get("newpred", 0))
            b.u(1, v.get("reduced_res", 0))
        b.u(1, v.get("scalability", 0))
        b.stuffing()
        if c.user_data:
            b.start(0xB2)
            b.buf += c.user_data
        return b.tobytes()

    # ---------------------------------------------------------- VOPs

    def write(self):
        """(headers, samples): the headers (VOS, VO, VOL, user data) and
        one sample a VOP (a GOV header before each I-VOP)."""
        c = self.cfg
        samples = []
        rounding = 0
        for k in range(c.frames):
            intra = k % c.gop == 0
            if not intra and c.rounding == "alternate":
                rounding ^= 1
            elif c.rounding == "random":
                rounding = int(self.rng.integers(0, 2))
            elif c.rounding in ("0", "1"):
                rounding = int(c.rounding)
            b = Bits()
            if intra:
                b.start(0xB3)                # group_of_vop
                b.u(11, 0)                   # time_code: hours, minutes
                b.u(1, 1)
                b.u(6, 0)                    # seconds
                b.u(1, 1)                    # closed_gov
                b.u(1, 0)                    # broken_link
                b.stuffing()
            b.start(0xB6)
            self.vop(b, k, intra, rounding)
            samples.append(b.tobytes())
        return self.headers(), samples

    def vop(self, b, k, intra, rounding):
        c, r = self.cfg, self.rng
        b.u(2, 0 if intra else 1)
        b.u(k // c.time_resolution, (1 << (k // c.time_resolution)) - 1)  # modulo_time_base
        b.u(1, 0)
        b.u(1, 1)
        b.u(self.time_bits, k % c.time_resolution)
        b.u(1, 1)
        if k in c.n_vops:
            b.u(1, 0)                        # vop_coded 0
            b.stuffing()
            return
        b.u(1, 1)
        if not intra:
            b.u(1, rounding)
        thr = int(r.integers(c.dc_thr[0], c.dc_thr[1] + 1))
        b.u(3, thr)
        q = int(r.integers(c.qp[0], c.qp[1] + 1))
        b.u(5, q)
        fcode = 1
        if not intra:
            fcode = int(r.integers(c.fcode[0], c.fcode[1] + 1))
            b.u(3, fcode)
        self.intra, self.fcode, self.thr = intra, fcode, DC_THRESHOLD[thr]
        self.preds = _Pred(self.mbw, self.mbh)
        if c.row_repeat:
            # each row a video packet of its own: its predictions see no
            # other row, so one row's data serves every row
            row, q_row = Bits(), q
            for x in range(self.mbw):
                q_row = self.macroblock(row, q_row, x, 0, 0, 0)
            value, n = row.bits()
            for y in range(self.mbh):
                if y:
                    self.packet_header(b, y * self.mbw, q, k, thr)
                b.u(n, value)
            b.stuffing()
            return
        left = int(r.integers(1, 2 * c.packets + 1)) if c.packets else self.mb_num
        rx = ry = 0
        for mb in range(self.mb_num):
            if mb and left == 0:
                q = int(r.integers(c.qp[0], c.qp[1] + 1))
                self.packet_header(b, mb, q, k, thr)
                left = int(r.integers(1, 2 * c.packets + 1))
                rx, ry = mb % self.mbw, mb // self.mbw
                self.preds = _Pred(self.mbw, self.mbh)
            q = self.macroblock(b, q, mb % self.mbw, mb // self.mbw, rx, ry)
            left -= 1
        b.stuffing()

    def packet_header(self, b, mb, q, k, thr):
        c = self.cfg
        b.stuffing()
        b.u(16 if self.intra else 15 + self.fcode, 0)
        b.u(1, 1)
        b.u(self.mb_bits, mb)
        b.u(5, q)
        hec = bool(self.rng.random() < c.p_hec)
        b.u(1, hec)
        if hec:
            b.u(k // c.time_resolution, (1 << (k // c.time_resolution)) - 1)
            b.u(1, 0)
            b.u(1, 1)
            b.u(self.time_bits, k % c.time_resolution)
            b.u(1, 1)
            b.u(2, 0 if self.intra else 1)
            b.u(3, thr)
            if not self.intra:
                b.u(3, self.fcode)

    # ---------------------------------------------------------- macroblocks

    def macroblock(self, b, q, x, y, rx, ry):
        """Macroblock (x, y) of the video packet that starts at (rx, ry),
        at QP q; returns the QP after it."""
        c, r = self.cfg, self.rng
        self.pos = (x, y, rx, ry)
        while r.random() < c.p_stuffing:
            if not self.intra:
                b.u(1, 0)
            b.code(MCBPC_STUFFING)
        cbp = [bool(r.random() < c.p_coded) for _ in range(6)]
        cbpc = cbp[4] << 1 | cbp[5]
        cbpy = cbp[0] << 3 | cbp[1] << 2 | cbp[2] << 1 | cbp[3]
        dquant = bool(r.random() < c.p_dquant)
        if self.intra:
            b.code(INTRA_MCBPC[dquant << 2 | cbpc])
            return self.intra_body(b, q, dquant, cbp, cbpy)
        if r.random() < c.p_skip:
            b.u(1, 1)
            self.preds.clean(x, y)
            self.preds.q[(x, y)] = q
            return q
        b.u(1, 0)
        if r.random() < c.p_intra:
            b.code(INTER_MCBPC[4 | dquant << 3 | cbpc])
            return self.intra_body(b, q, dquant, cbp, cbpy)
        self.preds.clean(x, y)
        four = bool(r.random() < c.p_4mv)
        dquant = dquant and not four         # MPEG-4 has no inter4v with DQUANT
        b.code(INTER_MCBPC[four << 4 | dquant << 3 | cbpc])
        b.code(CBPY[cbpy ^ 0xF])
        if dquant:
            d = int(r.integers(0, 4))
            b.u(2, d)
            q = min(max(q + DQUANT[d], 1), 31)
        self.preds.q[(x, y)] = q
        for _ in range(8 if four else 2):
            self.mvd(b)
        for n in range(6):
            if cbp[n]:
                raster = self.levels(q, False)
                self.coefs(b, INTER_TAB, np.array([raster[j] for j in ZIGZAG]), 0)
        return q

    def intra_body(self, b, q, dquant, cbp, cbpy):
        r = self.rng
        ac_pred = bool(r.random() < self.cfg.p_ac_pred)
        b.u(1, int(ac_pred))
        b.code(CBPY[cbpy])
        dc_vlc = q < self.thr                # the QP before DQUANT
        if dquant:
            d = int(r.integers(0, 4))
            b.u(2, d)
            q = min(max(q + DQUANT[d], 1), 31)
        x, y, rx, ry = self.pos
        P = self.preds
        for n in range(6):
            scale = (luma_dc_scale if n < 4 else chroma_dc_scale)(q)
            pred, direction = P.dc_pred(n, x, y, rx, ry, scale)
            # a DC level near the predictor, in 0..2047 / scale (libavcodec
            # refuses a negative one)
            level = int(np.clip(pred + np.round(r.normal(0, 6)), 0, 2047 // scale))
            if r.random() < 0.03:
                level = int(r.integers(0, 2047 // scale + 1))
            level = int(np.clip(level, pred - 511, pred + 511))
            # the AC levels the block ends with, its first row or column
            # predicted from a neighbour's (ac_pred)
            scan = ZIGZAG if not ac_pred else ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL
            predicted = P.ac_pred(n, x, y, direction, q) if ac_pred else np.zeros(64, int)
            final = predicted.copy()
            if cbp[n]:
                drawn = self.levels(q, True)
                final[1:] = drawn[1:]
            resid = np.array([final[scan[k]] - predicted[scan[k]] for k in range(64)])
            resid[0] = 0
            if dc_vlc:
                if cbp[n] and not resid.any():
                    k = int(r.integers(1, 64))
                    final[scan[k]] += 1
                    resid[k] = 1
                self.dc(b, n, level - pred)
                if cbp[n]:
                    self.coefs(b, INTRA_TAB, resid, 1)
            else:
                if not cbp[n]:
                    level = pred
                else:
                    resid[0] = level - pred
                    if not resid.any():
                        level = pred + 1 if pred < 2047 // scale else pred - 1
                        resid[0] = level - pred
                    self.coefs(b, INTRA_TAB, resid, 0)
            P.store(n, x, y, level * scale, final)
        P.q[(x, y)] = q
        return q

    def intra_bound(self, q, j):
        """The largest intra level at raster position j whose dequantised
        value stays within the standard's -2048..2047."""
        if self.cfg.quant_type:
            return max(1, min(2047, 16376 // (q * self._matrix(True, j))))
        return max(1, (2047 - ((q - 1) | 1)) // (2 * q))

    def inter_bound(self, q, j):
        if self.cfg.quant_type:
            return max(1, min(2047, (65504 // (2 * q * self._matrix(False, j)) - 1) // 2))
        return max(1, (2047 - ((q - 1) | 1)) // (2 * q))

    def levels(self, q, intra):
        """The AC levels (raster order, DC 0) of a block as an encoder
        quantises them: the DCT of a pixel block (intra: a gradient and
        noise in 0..255 about its mean; inter: a residual of either sign) at
        QP q, each within its position's bound, and with probability
        p_escape one isolated level larger than the rest (an escape code's
        value; dequantised at most 800, so that no IDCT stage leaves 16
        bits, as no 8-bit picture's coefficients make it)."""
        r, c = self.rng, self.cfg
        amp = float(r.choice([4.0, 16.0, 48.0, 110.0]))
        yy, xx = np.mgrid[0:8, 0:8]
        block = amp * (r.uniform(-1, 1) * (xx - 3.5) / 3.5 + r.uniform(-1, 1) * (yy - 3.5) / 3.5)
        block = block / 2 + r.normal(0, amp / 2, (8, 8))
        F = (_DCT @ block @ _DCT.T).reshape(64)
        w, bound = self._quant(q, intra)
        if c.quant_type:
            v = F * 8 / (q * w) if intra else (np.abs(F) * 16 / (q * w) - 1) / 2 * np.sign(F)
        else:
            v = F / (2 * q) if intra else (np.abs(F) - q / 2) / (2 * q) * np.sign(F)
        L = np.clip(np.trunc(v), -bound, bound).astype(int)
        if intra:
            L[0] = 0
        if r.random() < c.p_escape:
            j = int(r.integers(1 if intra else 0, 64))
            big = max(1, min(2047, 6400 // (q * int(w[j])) if c.quant_type else 400 // q))
            L[:] = 0
            L[j] = int(r.integers(1, big + 1)) * int(r.choice([1, -1]))
        if not L.any():
            j = int(r.integers(1 if intra else 0, 64))
            L[j] = int(r.choice([1, -1]))
        return L

    def _quant(self, q, intra):
        """The matrix (raster order; ones under H.263 quantisation) and the
        per-position level bounds at QP q."""
        key = (q, intra)
        if key not in self._quant_cache:
            w = np.array([self._matrix(intra, j) for j in range(64)]) if self.cfg.quant_type \
                else np.ones(64)
            bound = np.array([self.intra_bound(q, j) if intra else self.inter_bound(q, j)
                              for j in range(64)])
            self._quant_cache[key] = (w, bound)
        return self._quant_cache[key]

    def _matrix(self, intra, j):
        m = self.intra_matrix if intra else self.inter_matrix
        if m is not None:
            return m[ZIGZAG.index(j)]
        return (DEFAULT_INTRA if intra else DEFAULT_INTER)[j]

    def dc(self, b, n, diff):
        size = abs(diff).bit_length()
        b.code((DC_LUM if n < 4 else DC_CHROM)[size])
        if size:
            b.u(size, diff if diff > 0 else diff + (1 << size) - 1)
            if size > 8:
                b.u(1, 1)

    def coefs(self, b, tab, levels, start):
        """The nonzero ``levels`` (scan order) from scan position ``start``
        as TCOEF events, the last one marked."""
        vlc, index, lmax, rmax = tab
        nz = [k for k in range(start, 64) if levels[k]]
        prev = start - 1
        for i, k in enumerate(nz):
            self.tcoef(b, vlc, index, lmax, rmax, int(i == len(nz) - 1), k - prev - 1,
                       int(levels[k]))
            prev = k

    def tcoef(self, b, vlc, index, lmax, rmax, last, run, level):
        a, sign = abs(level), int(level < 0)
        i = index.get((last, run, a))
        if i is not None:
            b.code(vlc[i])
            b.u(1, sign)
            return
        b.code(vlc[ESCAPE])
        lm = lmax.get((last, run))
        if lm and (last, run, a - lm) in index:
            b.u(1, 0)                        # escape 1: level - LMAX
            b.code(vlc[index[(last, run, a - lm)]])
            b.u(1, sign)
            return
        rm = rmax.get((last, a))
        if rm is not None and (last, run - rm - 1, a) in index:
            b.u(2, 0b10)                     # escape 2: run - RMAX - 1
            b.code(vlc[index[(last, run - rm - 1, a)]])
            b.u(1, sign)
            return
        b.u(2, 0b11)                         # escape 3
        b.u(1, last)
        b.u(6, run)
        b.u(1, 1)
        b.u(12, level & 0xFFF)
        b.u(1, 1)

    def mvd(self, b):
        r, f = self.rng, self.fcode
        scale = 1 << (f - 1)
        if r.random() < self.cfg.p_big_mv:
            d = int(r.integers(-16 * scale, 16 * scale))
        else:
            d = int(np.clip(np.round(r.normal(0, 3)), -16 * scale, 16 * scale - 1))
        if d == 0:
            b.code(MV[0])
            return
        code = ((abs(d) - 1) >> (f - 1)) + 1
        b.code(MV[code])
        b.u(1, int(d < 0))
        b.u(f - 1, (abs(d) - 1) & (scale - 1))


def luma_dc_scale(q):
    return 8 if q < 5 else 2 * q if q < 9 else q + 8 if q < 25 else 2 * q - 16


def chroma_dc_scale(q):
    return 8 if q < 5 else (q + 13) // 2 if q < 25 else q - 6


# the orthonormal 8-point DCT-II (its 2-D transform puts 8 x the mean at DC,
# as MPEG-4's does)
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def rounded_div(a, b):
    """C's (a +- b / 2) / b, truncating toward zero (libavcodec's ROUNDED_DIV)."""
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


class _Pred:
    """The DC and AC predictors of one video packet as a decoder keeps them
    (each luma block and chroma macroblock with a row above and a column
    left that stay 1024 and 0), and each macroblock's QP, for drawing
    levels near their prediction. A decoder reads nothing of another packet
    but through these borders, so a packet starts from a fresh state."""

    def __init__(self, mbw, mbh):
        self.y = np.full((2 * mbh + 1, 2 * mbw + 1), 1024)
        self.c = [np.full((mbh + 1, mbw + 1), 1024) for _ in range(2)]
        self.ay = np.zeros((2 * mbh + 1, 2 * mbw + 1, 16), int)
        self.ac = [np.zeros((mbh + 1, mbw + 1, 16), int) for _ in range(2)]
        self.q = {}

    def _at(self, n, x, y):
        if n < 4:
            return self.y, self.ay, 2 * y + (n >> 1) + 1, 2 * x + (n & 1) + 1
        return self.c[n - 4], self.ac[n - 4], y + 1, x + 1

    def dc_pred(self, n, x, y, rx, ry, scale):
        """The predictor (in levels) of block n of macroblock (x, y) of the
        packet that starts at (rx, ry), and its direction (0 left, 1 up)."""
        arr, _, i, j = self._at(n, x, y)
        a, b, c = int(arr[i, j - 1]), int(arr[i - 1, j - 1]), int(arr[i - 1, j])
        first_line = y == ry or (y == ry + 1 and x < rx)
        if first_line and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and x == rx:
                b = a = 1024
        if x == rx and y == ry + 1 and n in (0, 4, 5):
            b = 1024
        p, d = (c, 1) if abs(a - b) < abs(b - c) else (a, 0)
        return (p + (scale >> 1)) // scale, d

    def ac_pred(self, n, x, y, d, q):
        """The predicted first column (d 0) or row (d 1), raster order."""
        _, ac, i, j = self._at(n, x, y)
        out = np.zeros(64, int)
        if d == 0:
            nq = self.q.get((x - 1, y), 0)
            same = x == 0 or q == nq or n in (1, 3)
            for k in range(1, 8):
                v = int(ac[i, j - 1, k])
                out[8 * k] = v if same else rounded_div(v * nq, q)
        else:
            nq = self.q.get((x, y - 1), 0)
            same = y == 0 or q == nq or n in (2, 3)
            for k in range(1, 8):
                v = int(ac[i - 1, j, 8 + k])
                out[k] = v if same else rounded_div(v * nq, q)
        return out

    def store(self, n, x, y, dc, final):
        arr, ac, i, j = self._at(n, x, y)
        arr[i, j] = min(max(dc, 0), 2047)
        ac[i, j, 1:8] = final[8:64:8]
        ac[i, j, 9:16] = final[1:8]

    def clean(self, x, y):
        self.y[2 * y + 1:2 * y + 3, 2 * x + 1:2 * x + 3] = 1024
        self.ay[2 * y + 1:2 * y + 3, 2 * x + 1:2 * x + 3] = 0
        for a, c in zip(self.c, self.ac):
            a[y + 1, x + 1] = 1024
            c[y + 1, x + 1] = 0


def write(cfg: Config):
    """``(headers, samples)`` of the stream ``cfg`` draws."""
    return Writer(cfg).write()


# ------------------------------------------------------------------ MP4

def _box(kind, *parts):
    body = b"".join(parts)
    return (8 + len(body)).to_bytes(4, "big") + kind + body


def _full(kind, version, flags, *parts):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big"), *parts)


def _descriptor(tag, body):
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F]) + body


def mp4(headers, samples, width, height, oti=0x20, in_band=False, entry=b"mp4v") -> bytes:
    """An MP4 file of one video track: ``samples`` (the headers leading the
    first with ``in_band``, else in the esds DecoderSpecificInfo), 25
    samples a second, 3 a chunk."""
    if in_band:
        samples = [headers + samples[0]] + list(samples[1:])
    u32 = lambda v: v.to_bytes(4, "big")
    u16 = lambda v: v.to_bytes(2, "big")
    n = len(samples)
    ftyp = _box(b"ftyp", b"isom", u32(512), b"isomiso2mp41")
    payload = b"".join(samples)

    def moov(data_off):
        dsi = b"" if in_band else _descriptor(5, headers)
        dcd = _descriptor(4, bytes([oti, 0x11]) + bytes(3) + u32(0) + u32(0) + dsi)
        esd = _descriptor(3, u16(1) + bytes([0]) + dcd + _descriptor(6, b"\x02"))
        esds = _full(b"esds", 0, 0, esd)
        vse = _box(entry, bytes(6), u16(1), bytes(16), u16(width), u16(height),
                   u32(0x00480000), u32(0x00480000), u32(0), u16(1), bytes(32), u16(24),
                   (0xFFFF).to_bytes(2, "big"), esds)
        stsd = _full(b"stsd", 0, 0, u32(1), vse)
        stts = _full(b"stts", 0, 0, u32(1), u32(n), u32(1))
        chunks = [list(range(i, min(i + 3, n))) for i in range(0, n, 3)]
        runs = []
        for ci, ch in enumerate(chunks):
            if not runs or runs[-1][1] != len(ch):
                runs.append((ci + 1, len(ch)))
        stsc = _full(b"stsc", 0, 0, u32(len(runs)), *[u32(a) + u32(k) + u32(1) for a, k in runs])
        stsz = _full(b"stsz", 0, 0, u32(0), u32(n), *[u32(len(s)) for s in samples])
        offs, pos = [], data_off
        for ch in chunks:
            offs.append(pos)
            pos += sum(len(samples[i]) for i in ch)
        stco = _full(b"stco", 0, 0, u32(len(offs)), *[u32(o) for o in offs])
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dref = _full(b"dref", 0, 0, u32(1), _full(b"url ", 0, 1))
        minf = _box(b"minf", vmhd, _box(b"dinf", dref), stbl)
        hdlr = _full(b"hdlr", 0, 0, u32(0), b"vide", bytes(12), b"VideoHandler\x00")
        mdhd = _full(b"mdhd", 0, 0, u32(0), u32(0), u32(25), u32(n), u16(0x55C4), u16(0))
        matrix = u32(0x10000) + u32(0) * 3 + u32(0x10000) + u32(0) * 3 + u32(0x40000000)
        tkhd = _full(b"tkhd", 0, 3, u32(0), u32(0), u32(1), u32(0), u32(n * 40), bytes(8),
                     u16(0), u16(0), u16(0), u16(0), matrix, u32(width << 16), u32(height << 16))
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        mvhd = _full(b"mvhd", 0, 0, u32(0), u32(0), u32(1000), u32(n * 40), u32(0x10000),
                     u16(0x100), bytes(10), matrix, bytes(24), u32(2))
        return _box(b"moov", mvhd, trak)

    return ftyp + _box(b"mdat", payload) + moov(len(ftyp) + 8)


def video(cfg: Config) -> bytes:
    """The MP4 file of the stream ``cfg`` draws."""
    headers, samples = write(cfg)
    return mp4(headers, samples, cfg.width, cfg.height, in_band=cfg.in_band)


# ------------------------------------------------------------------ refusals

# each feature the decoder refuses: the words its message holds
REFUSALS = {
    "b_vop": "B-VOPs",
    "s_vop": r"S\(GMC\)-VOPs",
    "sprite": "sprites",
    "quarter_sample": "quarter-sample motion",
    "interlaced": "interlaced",
    "data_partitioned": "data partitioning",
    "rvlc": "reversible VLC",
    "shape": "non-rectangular shape",
    "short_header": "short_video_header",
    "reduced_res": "reduced-resolution VOPs",
    "newpred": "NEWPRED",
    "scalability": "scalability",
    "complexity": "complexity estimation",
    "studio_profile": "studio profile",
    "bit_depth": "bit depth 10",
    "chroma_422": "chroma other than 4:2:0",
    "xvid": "Xvid",
    "divx": "DivX",
    "lavc_iedge": "Lavc / FFmpeg build",
    "ffmpeg_old": "Lavc / FFmpeg build",
    "mjpeg": "MJPEG",
    "mpeg2": "MPEG-2 video",
    "mpeg1": "MPEG-1 video",
    "odd_size": "odd VOL width",
    "matrix_9": "matrix_coefficients 9",
    "p_first": "a P-VOP before any I-VOP",
}


def refusal(feature) -> bytes:
    """An MP4 file whose stream holds ``feature`` (a key of REFUSALS): a
    32x32 I-VOP and P-VOP whose headers or a third VOP carry it."""
    vol = {"sprite": {"sprite": 1}, "quarter_sample": {"quarter_sample": 1},
           "interlaced": {"interlaced": 1}, "data_partitioned": {"data_partitioned": 1},
           "rvlc": {"data_partitioned": 1, "rvlc": 1}, "shape": {"shape": 2},
           "reduced_res": {"reduced_res": 1}, "newpred": {"newpred": 1},
           "scalability": {"scalability": 1}, "complexity": {"complexity": 1},
           "studio_profile": {"profile": 0xE1}, "bit_depth": {"bit_depth": 10},
           "chroma_422": {"chroma_format": 2}}.get(feature)
    user = {"xvid": b"XviD0050", "divx": b"DivX503b1393p", "lavc_iedge": b"Lavc56.60.100",
            "ffmpeg_old": b"FFmpeg0.4.9b4707"}.get(feature, b"Lavc62.28.101")
    size = (17, 32) if feature == "odd_size" else (32, 32)
    cfg = Config(width=size[0], height=size[1], frames=2, seed=1, vol=vol, user_data=user,
                 video_signal=(0, 9) if feature == "matrix_9" else None)
    headers, samples = write(cfg)
    if feature in ("b_vop", "s_vop"):
        b = Bits()
        b.start(0xB6)
        b.u(2, 2 if feature == "b_vop" else 3)
        b.u(1, 0)
        b.u(1, 1)
        b.u(5, 2)
        b.u(1, 1)
        b.u(1, 1)
        b.u(24, 0)
        b.stuffing()
        samples.append(b.tobytes())
    if feature == "short_header":
        samples[1] = b"\x00\x00\x80\x02\x08" + bytes(16)
    if feature == "p_first":
        samples = samples[1:]
    oti = {"mjpeg": 0x6C, "mpeg2": 0x61, "mpeg1": 0x6A}.get(feature, 0x20)
    return mp4(headers, samples, *size, oti=oti)
