"""An HEVC writer in Python for the HEVC decoder's test fixtures.

Nothing the tests depend on encodes HEVC (cv2's ``VideoWriter`` opens no
``hvc1`` or ``hev1`` stream here: its FFmpeg has no software HEVC encoder),
so this module writes the streams the port's decoder
(``fourdgs_tpu_torch/native/hevc.cpp``) is held to: 8-bit 4:2:0 streams
of ITU-T H.265 Main, I, P and B slices, in an MP4 file (an ``hvc1`` or
``hev1`` sample entry), whose syntax is drawn at random from a seed and a
:class:`Config`: coding and transform quadtrees, skip, merge and AMVP
prediction units of every partition (AMP too), intra modes through the
most probable modes, residuals (sign data hiding, transform skip, levels
with long escape codes), cu_qp_delta, SAO, deblocking controls, slices,
WPP substreams, scaling lists, weighted prediction, reference picture sets
(inter-RPS prediction, long-term pictures), list modifications, runs of B
pictures, leading pictures of CRA pictures, end-of-sequence NAL units and
``pic_output_flag``. It needs no motion search and no reconstruction: it
writes syntax, and cv2 decodes what it means.

It is a second implementation of the syntax of ITU-T H.265 (v4, 12/2016)
§7.3 and of the CABAC contexts' selection (§9.3.4.2); it shares with the
decoder only the tables of §9.3 (the context initialisation values, and
rangeTabLps and transIdxLps), which it reads out of ``hevc.cpp``. A wrong
entry there makes both disagree with cv2.

Refusal fixtures (:func:`refusal`) hold a parameter set or a slice header
of a feature the decoder does not read.
"""

from __future__ import annotations

import pathlib
import re
from dataclasses import dataclass, field

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DECODER_SRC = ROOT / "fourdgs_tpu_torch" / "native" / "hevc.cpp"


def _table(name, shape):
    src = DECODER_SRC.read_text()
    body = src[src.index(name):]
    body = body[body.index("= {") + 2:body.index("};")]
    return np.array(list(map(int, re.findall(r"-?\d+", body))), np.int64).reshape(shape)


CABAC_INIT = _table("kCabacInit[3][NUM_CTX]", (3, -1))
RANGE_LPS = _table("kRangeLps[64][4]", (64, 4)).tolist()
TRANS_LPS = _table("kTransLps[64]", (64,)).tolist()

# the first context of each syntax element (hevc.cpp's enum Ctx)
SAO_MERGE, SAO_TYPE, SPLIT_CU, TQ_BYPASS, SKIP, PRED_MODE, PART_MODE = 0, 1, 2, 5, 6, 9, 10
PREV_INTRA, CHROMA_MODE, RQT_ROOT_CBF, MERGE_FLAG, MERGE_IDX, INTER_PRED = 14, 15, 16, 17, 18, 19
REF_IDX, MVD_GT0, MVD_GT1, MVP_FLAG, SPLIT_TRANSFORM, CBF_LUMA = 24, 26, 27, 28, 29, 32
CBF_CHROMA, QP_DELTA, TRANSFORM_SKIP, LAST_X, LAST_Y, CSBF, SIG, GT1, GT2 = (
    34, 38, 40, 42, 60, 78, 82, 124, 148)

P_2Nx2N, P_2NxN, P_Nx2N, P_NxN, P_2NxnU, P_2NxnD, P_nLx2N, P_nRx2N = range(8)
CTX_IDX_MAP = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]

# Table 7-6: the default 8x8 scaling lists in up-right diagonal order
DEFAULT_SCALING = (
    [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18, 17, 18, 18, 17, 18, 21,
     19, 20, 21, 20, 19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29,
     31, 35, 35, 31, 29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115],
    [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 20,
     20, 20, 20, 20, 20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28,
     28, 28, 28, 28, 28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91])


def _scans():
    """6.5.3-6.5.5: scan[blk][scanIdx] = [(x, y), ...] for blk 2, 4, 8."""
    out = {}
    for blk in (2, 4, 8):
        diag, x, y = [], 0, 0
        while len(diag) < blk * blk:
            while y >= 0:
                if x < blk and y < blk:
                    diag.append((x, y))
                y -= 1
                x += 1
            y, x = x, 0
        horiz = [(x, y) for y in range(blk) for x in range(blk)]
        vert = [(x, y) for x in range(blk) for y in range(blk)]
        out[blk] = (diag, horiz, vert)
    return out


SCANS = _scans()


# ------------------------------------------------------------------ bits


class Bits:
    """An MSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def u(self, n, v):
        self.bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

    def ue(self, v):
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def trailing(self):
        self.bits.append(1)
        self.align_zero()

    def tobytes(self):
        assert len(self.bits) % 8 == 0
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention of an RBSP."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(ntype, rbsp: bytes, tid=0, layer=0) -> bytes:
    """A NAL unit: its 2-byte header and ``rbsp`` with emulation prevention."""
    return bytes([(ntype << 1) | (layer >> 5), ((layer & 31) << 3) | (tid + 1)]) + escape(rbsp)


class Cabac:
    """9.3.5: the arithmetic encoder over a :class:`Bits`."""

    def __init__(self, bits):
        self.bits = bits
        self.reset()

    def reset(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def init_contexts(self, init_type, qp):
        self.state, self.mps = [0] * 154, [0] * 154
        for i, iv in enumerate(CABAC_INIT[init_type]):
            m, n = (int(iv) >> 4) * 5 - 45, ((int(iv) & 15) << 3) - 16
            pre = min(126, max(1, ((m * min(51, max(0, qp))) >> 4) + n))
            self.state[i], self.mps[i] = (63 - pre, 0) if pre <= 63 else (pre - 64, 1)

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.bits.bits.append(b)
        while self.outstanding:
            self.bits.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, b):
        b = int(b)
        s, m = self.state[ctx], self.mps[ctx]
        lps = RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if b != m:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - m
            self.state[ctx] = TRANS_LPS[s]
        else:
            self.state[ctx] = min(s + 1, 62)
        self._renorm()
        return b

    def bypass(self, b):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def bypass_bits(self, n, v):
        for i in range(n - 1, -1, -1):
            self.bypass((v >> i) & 1)

    def terminate(self, b):
        """A terminating bin; 1 flushes the engine (its last bit written is
        the stop or alignment bit), then zeros align it."""
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bits.u(2, ((self.low >> 7) & 3) | 1)
            self.bits.align_zero()
        else:
            self._renorm()


# ---------------------------------------------------------------- config


@dataclass
class Config:
    """The stream's fixed parameters and the probabilities its syntax is
    drawn with."""
    width: int = 64                 # output (cropped) size; even
    height: int = 48
    frames: int = 3
    seed: int = 0
    log2_ctb: int = 4
    log2_min_cb: int = 3
    log2_min_tb: int = 2
    log2_max_tb: int = 4
    depth_inter: int = 1
    depth_intra: int = 1
    amp: bool = True
    sao: bool = True
    tmvp: bool = True
    strong_smoothing: bool = True
    scaling: str = "off"            # off, default (flat SPS flag), sps, pps
    sign_hiding: bool = True
    transform_skip: bool = True
    cu_qp_delta: bool = True
    qp_delta_depth: int = 1
    chroma_qp: tuple = (0, 0)       # pps_cb_qp_offset, pps_cr_qp_offset
    slice_chroma_qp: bool = True
    weighted_pred: bool = False
    weighted_bipred: bool = False
    wpp: bool = False
    constrained_intra: bool = False
    cabac_init_present: bool = True
    lists_modification: bool = True
    log2_par_mrg: int = 2
    deblock_control: bool = True    # deblocking_filter_control_present_flag
    deblock_disabled: bool = False  # the PPS's
    deblock_override: bool = True
    # a slice's override may disable its deblocking. libavcodec then reads
    # the offsets of the slice header its thread context parsed last, so
    # cv2's frames depend on its thread count: hold such streams to
    # libavcodec on one thread
    slice_disable: bool = False
    loop_filter_across: bool = True
    max_slices: int = 1
    init_qp: int = 30
    qp: tuple = (22, 40)            # slice QPs drawn from
    b_frames: int = 0               # a run of B pictures between anchors
    b_pyramid: bool = False         # the middle B picture of a run a reference
    num_refs: int = 2               # reference pictures kept
    gop: int = 0                    # an IRAP picture every gop frames (0: only the first)
    irap: str = "idr"               # idr, cra or bla: the IRAP pictures after the first
    first: str = "idr"              # idr, cra, or leading (a CRA with RASL and RADL pictures)
    log2_max_poc_lsb: int = 8
    reorder_extra: int = 0          # sps_max_num_reorder_pics above the least that will do
    latency_plus1: int = 0          # sps_max_latency_increase_plus1 (0: no limit)
    tid_b: bool = False             # non-reference B pictures in sub-layer 1 (with sub_layers)
    dpb_extra: int = 0              # sps_max_dec_pic_buffering above it
    inter_rps: bool = True          # SPS RPS sets predicted from the previous one
    long_term: bool = False
    p_no_output: float = 0.0        # pic_output_flag 0
    eos_gops: tuple = ()            # an EOS NAL unit ends these GOPs (1: the first)
    entry: bytes = b"hvc1"
    length_size: int = 4
    ctts: bool = False              # composition offsets and FFmpeg's edit list
    crop: tuple = None              # conformance window (left, right, top, bottom), luma
    vui: dict = None                # matrix, full_range, hrd, sub_layers, default_display
    max_merge: tuple = (1, 5)
    profile: int = 1                # general_profile_idc: 1 Main, 2 Main 10, 3 Main Still Picture
    extra_bits: int = 0             # num_extra_slice_header_bits
    header_ext: bool = False        # slice_segment_header_extension bytes
    # refused features (header-only streams, :func:`refusal`)
    chroma_format: int = 1
    separate_planes: bool = False
    bit_depth: int = 8
    pcm: bool = False
    sps_ext: int = 0                # sps_range/multilayer/3d/scc_extension_flag bits
    pps_ext: int = 0
    tiles: bool = False
    bypass: bool = False            # transquant_bypass_enabled_flag
    dependent_slices: bool = False  # later slice segments dependent
    row_repeat: bool = False        # one slice a CTB row, the first row's data repeated
    # probabilities
    p_split: float = 0.5
    p_skip: float = 0.2
    p_intra: float = 0.15
    p_merge: float = 0.4
    p_cbf: float = 0.6
    p_tsplit: float = 0.4
    p_big: float = 0.02             # a level with a long escape code
    p_big_mv: float = 0.05
    sig_density: float = 0.35
    p_qp_delta: float = 0.5


# ------------------------------------------------------------ the pictures


@dataclass
class Pic:
    poc: int
    nut: int
    kind: str                       # I, P or B
    ref: bool                       # kept as a reference after it
    tid: int = 0
    rps: list = field(default_factory=list)    # [(delta, used)], negatives first
    lt: list = field(default_factory=list)     # [(poc, used, msb)]
    output: bool = True
    eos: bool = False
    disp: int = 0                   # display index in the stream


def plan(cfg: Config, rng):
    """The pictures in decoding order, each with its reference picture set:
    the last ``num_refs`` reference pictures are kept, a random subset of
    them used."""
    n = cfg.frames
    order = []                       # (display index, kind, is_ref, leading)
    gop = cfg.gop or n
    for g0 in range(0, n, gop):
        g1 = min(n, g0 + gop)
        order.append((g0, "I", True))
        prev = g0
        while prev < g1 - 1:
            anchor = min(prev + cfg.b_frames + 1, g1 - 1)
            order.append((anchor, "P" if cfg.b_frames == 0 or rng.random() < 0.7 else "B", True))
            run = list(range(prev + 1, anchor))
            if cfg.b_pyramid and len(run) >= 3:
                mid = run[len(run) // 2]
                order.append((mid, "B", True))
                order += [(d, "B", False) for d in run if d != mid]
            else:
                order += [(d, "B", rng.random() < 0.3) for d in run]
            prev = anchor
    pics = []
    kept = []                        # reference pictures (POC), decoding order
    lt = set()
    base = 0                         # the POC of display index 0 of the GOP
    for i, (disp, kind, is_ref) in enumerate(order):
        if kind == "I":
            idr = (i == 0 and cfg.first == "idr") or (i > 0 and cfg.irap == "idr")
            if idr:
                base = disp
                kept, lt = [], set()
                nut = 19 if rng.random() < 0.5 else 20
            elif i > 0 and cfg.irap == "bla":
                # a BLA picture: its POC is its lsb (past those before it,
                # which libavcodec may still hold), and it keeps no reference
                lsb = (disp - base + int(rng.integers(1, 5))) % (1 << cfg.log2_max_poc_lsb)
                base = disp - lsb
                kept, lt = [], set()
                nut = int(rng.integers(16, 19))
            else:
                nut = 21
            poc = disp - base
            if i == 0 and cfg.first in ("cra", "leading"):
                poc = disp + (1 << (cfg.log2_max_poc_lsb - 2))
                base = disp - poc
            pic = Pic(poc, nut, "I", True, disp=disp)
            if nut == 21:
                pic.rps = [(p - poc, False) for p in sorted(kept, reverse=True) if p < poc]
            pics.append(pic)
            kept, lt = [poc], set()
            continue
        poc = disp - base
        nut = 1 if is_ref else 0
        pic = Pic(poc, nut, kind, is_ref, disp=disp)
        if cfg.tid_b and kind == "B" and not is_ref:
            assert (cfg.vui or {}).get("sub_layers"), "tid_b needs sub-layers"
            pic.tid = 1
        before = sorted([p for p in kept if p < poc and p not in lt], reverse=True)
        after = sorted([p for p in kept if p > poc and p not in lt])
        usable = before + after
        used = {p: rng.random() < 0.8 for p in usable}
        if kind == "B" and not after and before:
            used[before[0]] = True
        if not any(used.values()) and usable:
            used[usable[0]] = True
        pic.rps = [(p - poc, used[p]) for p in before] + [(p - poc, used[p]) for p in after]
        if cfg.long_term:
            for p in sorted(lt):
                if p in kept:
                    pic.lt.append((p, rng.random() < 0.7, rng.random() < 0.5))
        if not any(u for _, u in pic.rps) and not any(u for _, u, _ in pic.lt):
            pic.kind = "I"
        pic.output = rng.random() >= cfg.p_no_output
        pics.append(pic)
        if is_ref:
            kept.append(poc)
            if cfg.long_term and len(kept) >= 2 and not lt and rng.random() < 0.5:
                lt.add(kept[0])
            while len(kept) > cfg.num_refs:
                kept.pop(0)
                lt &= set(kept)
    if cfg.first == "leading":
        _leading(pics, rng)
    iraps = [i for i, p in enumerate(pics) if i and 16 <= p.nut <= 21]
    for g in cfg.eos_gops:
        pics[iraps[g - 1] - 1].eos = True    # the next picture is an IRAP one
    return pics


def _leading(pics, rng):
    """Turns the stream's first CRA into one that leading pictures follow:
    RASL pictures (of a picture before the CRA the stream does not hold,
    named in the CRA's RPS) and RADL pictures (of the CRA only)."""
    cra = pics[0]
    gone = cra.poc - 4
    cra.rps = [(gone - cra.poc, False)]
    lead = [Pic(cra.poc - 3, 9, "B", True, rps=[(gone - cra.poc + 3, True), (3, True)]),
            Pic(cra.poc - 2, 8, "P", False, rps=[(-1, True), (2, True)]),
            Pic(cra.poc - 1, 7, "P", False, rps=[(1, True)])]
    for k, p in enumerate(lead):
        p.disp = cra.disp - 3 + k
    for p in pics:
        p.disp += 3
    rest = pics[1:]
    for p in rest:
        p.rps = [(d, u) for d, u in p.rps if p.poc + d >= cra.poc]
        if not any(u for _, u in p.rps):
            if p.rps:
                p.rps[0] = (p.rps[0][0], True)
            else:
                p.kind = "I"
    pics[:] = [cra] + lead + rest


# ------------------------------------------------------------ the writer


class Writer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        c = cfg
        mcb = 1 << c.log2_min_cb
        self.W = -(-c.width // mcb) * mcb
        self.H = -(-c.height // mcb) * mcb
        crop = c.crop or (0, self.W - c.width, 0, self.H - c.height)
        self.crop = crop
        self.ctb = 1 << c.log2_ctb
        self.cw = -(-self.W // self.ctb)
        self.ch = -(-self.H // self.ctb)
        self.w4 = self.W // 4
        self.pics = plan(cfg, self.rng)
        # the SPS's short-term RPS sets: each picture's own when small
        self.sets = []
        for p in self.pics:
            if p.nut not in (19, 20) and p.rps and tuple(p.rps) not in self.sets and \
                    len(self.sets) < 8:
                self.sets.append(tuple(p.rps))
        self.reorder, self.max_dec = self._dpb_needs()
        self.scaling = None
        if c.scaling in ("sps", "pps"):
            self.scaling = self._random_scaling()

    # -------------------------------------------------- parameter sets

    def _dpb_needs(self):
        """The least sps_max_num_reorder_pics and max_dec_pic_buffering that
        hold the plan in display order (plus the configured extra)."""
        reorder, dpb = 0, 1
        decoded = []
        for i, p in enumerate(self.pics):
            if i and p.nut in (16, 17, 18, 19, 20):
                decoded = []
            decoded.append(p.poc)
            later = [q.poc for q in self.pics[i + 1:] if q.nut not in (19, 20)]
            waiting = [d for d in decoded if any(d > q for q in later[:32])]
            reorder = max(reorder, len(waiting))
            refs = 1 + len(p.rps) + len(p.lt)
            dpb = max(dpb, refs + len(waiting) + 1)
        reorder = max(0, min(15, reorder + self.cfg.reorder_extra))
        return reorder, min(16, max(dpb, reorder + 1) + self.cfg.dpb_extra)

    def _random_scaling(self):
        r = self.rng
        lists = {}
        for s in range(4):
            for m in range(0, 6, 3 if s == 3 else 1):
                n = 16 if s == 0 else 64
                lists[s, m] = ([int(v) for v in r.integers(4, 64, n)],
                               int(r.integers(4, 64)) if s > 1 else None)
        return lists

    def _scaling_data(self, b):
        r = self.rng
        done = {}
        for s in range(4):
            for m in range(0, 6, 3 if s == 3 else 1):
                step = 3 if s == 3 else 1
                choice = r.random()
                if choice < 0.2:
                    b.u(1, 0)
                    b.ue(0)                          # the default list
                    done[s, m] = None
                elif choice < 0.4 and m >= step:
                    delta = int(r.integers(1, m // step + 1))
                    b.u(1, 0)
                    b.ue(delta)
                    done[s, m] = done[s, m - delta * step]
                else:
                    vals, dc = self.scaling[s, m]
                    b.u(1, 1)
                    nxt = 8
                    if s > 1:
                        b.se(dc - 8)
                        nxt = dc
                    for v in vals:
                        d = (v - nxt) % 256
                        if d > 127:
                            d -= 256
                        b.se(d)
                        nxt = v
                    done[s, m] = (vals, dc)

    def vps(self):
        sub = (self.cfg.vui or {}).get("sub_layers", 0)
        b = Bits()
        b.u(4, 0)
        b.u(1, 1)
        b.u(1, 1)
        b.u(6, 0)
        b.u(3, sub)                  # as many sub-layers as the SPS (FFmpeg checks)
        b.u(1, 1)
        b.u(16, 0xFFFF)
        self._ptl(b, sub)
        b.u(1, 1)
        for _ in range(sub + 1):
            b.ue(self.max_dec - 1)
            b.ue(self.reorder)
            b.ue(0)
        b.u(6, 0)
        b.ue(0)
        b.u(1, 0)
        b.u(1, 0)
        b.trailing()
        return nal(32, b.tobytes())

    def _ptl(self, b, sub_layers):
        b.u(2, 0)
        b.u(1, 0)
        b.u(5, self.cfg.profile)
        b.u(32, 0x60000000 | (1 << (31 - self.cfg.profile)))
        b.u(4, 0b1001)               # progressive, frame only
        b.u(43, 0)
        b.u(1, 0)
        b.u(8, 93)
        for _ in range(sub_layers):
            b.u(1, 1)
            b.u(1, 1)
        if sub_layers:
            for _ in range(sub_layers, 8):
                b.u(2, 0)
        for _ in range(sub_layers):
            b.u(2, 0)
            b.u(1, 0)
            b.u(5, 1)
            b.u(32, 0x60000000)
            b.u(48, 0)
            b.u(8, 90)

    def sps(self):
        c, b = self.cfg, Bits()
        vui = c.vui or {}
        sub = vui.get("sub_layers", 0)
        b.u(4, 0)
        b.u(3, sub)
        b.u(1, 1)
        self._ptl(b, sub)
        b.ue(0)
        b.ue(c.chroma_format)        # 1: 4:2:0
        if c.chroma_format == 3:
            b.u(1, c.separate_planes)
        b.ue(self.W)
        b.ue(self.H)
        if any(self.crop):
            b.u(1, 1)
            for v in self.crop:
                b.ue(v // 2)
        else:
            b.u(1, 0)
        b.ue(c.bit_depth - 8)
        b.ue(c.bit_depth - 8)
        b.ue(c.log2_max_poc_lsb - 4)
        b.u(1, 1 if sub else 0)      # sps_sub_layer_ordering_info_present_flag
        for i in range(sub + 1 if sub else 1):
            b.ue(self.max_dec - 1)
            b.ue(self.reorder)
            b.ue(c.latency_plus1)
        b.ue(c.log2_min_cb - 3)
        b.ue(c.log2_ctb - c.log2_min_cb)
        b.ue(c.log2_min_tb - 2)
        b.ue(c.log2_max_tb - c.log2_min_tb)
        b.ue(c.depth_inter)
        b.ue(c.depth_intra)
        b.u(1, c.scaling != "off")
        if c.scaling != "off":
            b.u(1, c.scaling == "sps")
            if c.scaling == "sps":
                self._scaling_data(b)
        b.u(1, c.amp)
        b.u(1, c.sao)
        b.u(1, c.pcm)
        if c.pcm:                    # 8-bit PCM of 8x8 to 16x16 blocks, deblocked
            b.u(4, 7)
            b.u(4, 7)
            b.ue(0)
            b.ue(1)
            b.u(1, 0)
        b.ue(len(self.sets))
        for i, s in enumerate(self.sets):
            self._rps(b, s, i, self.sets)
        b.u(1, c.long_term)
        if c.long_term:
            b.ue(0)
        b.u(1, c.tmvp)
        b.u(1, c.strong_smoothing)
        b.u(1, bool(c.vui))
        if c.vui:
            self._vui(b, vui, sub)
        b.u(1, bool(c.sps_ext))
        if c.sps_ext:
            b.u(8, c.sps_ext)
            b.u(32, 0)               # the extensions' flags, all 0
        b.trailing()
        return nal(33, b.tobytes())

    def _vui(self, b, v, sub):
        b.u(1, 1)
        b.u(8, 1)                    # aspect_ratio_idc 1
        b.u(1, 0)
        if "matrix" in v or "full_range" in v:
            b.u(1, 1)
            b.u(3, 5)
            b.u(1, v.get("full_range", 0))
            b.u(1, 1)
            b.u(8, 1)
            b.u(8, 1)
            b.u(8, v.get("matrix", 2))
        else:
            b.u(1, 0)
        b.u(1, 1)                    # chroma_loc_info
        b.ue(0)
        b.ue(0)
        b.u(1, 0)
        b.u(1, v.get("field_seq", 0))
        b.u(1, 0)
        dd = v.get("default_display")
        b.u(1, bool(dd))
        if dd:
            for x in dd:
                b.ue(x)
        b.u(1, 1)                    # timing
        b.u(32, 1001)
        b.u(32, 60000)
        b.u(1, 0)
        b.u(1, bool(v.get("hrd")))
        if v.get("hrd"):
            b.u(1, 1)
            b.u(1, 1)
            b.u(1, 0)
            b.u(4, 0)
            b.u(4, 0)
            b.u(5, 23)
            b.u(5, 23)
            b.u(5, 23)
            for _ in range(sub + 1):
                b.u(1, 0)
                b.u(1, 0)
                b.u(1, 0)            # low_delay_hrd_flag
                b.ue(1)              # cpb_cnt_minus1
                for _ in range(2):
                    for _ in range(2):
                        b.ue(1000)
                        b.ue(2000)
                        b.u(1, 0)
        b.u(1, 1)                    # bitstream_restriction
        b.u(1, 0)
        b.u(1, 1)
        b.u(1, 1)
        b.ue(0)
        b.ue(2)
        b.ue(1)
        b.ue(15)
        b.ue(15)

    def _rps(self, b, s, idx, sets, in_slice=False):
        """st_ref_pic_set(idx) of ``s`` [(delta, used)]: predicted from the
        previous set where its pictures allow it, else coded explicitly."""
        if idx:
            prev = sets[idx - 1]
            pred = self._inter_rps(prev, s) if self.cfg.inter_rps else None
            b.u(1, pred is not None)
            if pred is not None:
                delta_rps, flags = pred
                if in_slice:
                    b.ue(0)
                b.u(1, delta_rps < 0)
                b.ue(abs(delta_rps) - 1)
                for used, use_delta in flags:
                    b.u(1, used)
                    if not used:
                        b.u(1, use_delta)
                return
        neg = [(d, u) for d, u in s if d < 0]
        pos = [(d, u) for d, u in s if d > 0]
        b.ue(len(neg))
        b.ue(len(pos))
        last = 0
        for d, u in neg:
            b.ue(last - d - 1)
            b.u(1, u)
            last = d
        last = 0
        for d, u in pos:
            b.ue(d - last - 1)
            b.u(1, u)
            last = d
        return

    def _inter_rps(self, ref, s):
        """(deltaRps, [(used, use_delta)]) predicting ``s`` from ``ref``
        (7.4.8), or None when no deltaRps makes every picture of s."""
        want = dict(s)
        refd = [d for d, _ in ref]
        for delta_rps in sorted({w - r for w in want for r in refd + [0]} - {0}, key=abs):
            cand = {r + delta_rps for r in refd} | {delta_rps}
            if not set(want) <= cand:
                continue
            # (7-61, 7-62) build the same order as the decoder: entries of
            # ref in its order, then deltaRps itself
            flags = []
            for r in refd + [0]:
                d = r + delta_rps
                if d in want and d != 0:
                    flags.append((want[d], True))
                else:
                    flags.append((False, False))
            return delta_rps, flags
        return None

    def pps(self):
        c, b = self.cfg, Bits()
        b.ue(0)
        b.ue(0)
        b.u(1, c.dependent_slices)
        b.u(1, c.p_no_output > 0)    # output_flag_present_flag
        b.u(3, c.extra_bits)
        b.u(1, c.sign_hiding)
        b.u(1, c.cabac_init_present)
        b.ue(0)
        b.ue(0)
        b.se(c.init_qp - 26)
        b.u(1, c.constrained_intra)
        b.u(1, c.transform_skip)
        b.u(1, c.cu_qp_delta)
        if c.cu_qp_delta:
            b.ue(c.qp_delta_depth)
        b.se(c.chroma_qp[0])
        b.se(c.chroma_qp[1])
        b.u(1, c.slice_chroma_qp)
        b.u(1, c.weighted_pred)
        b.u(1, c.weighted_bipred)
        b.u(1, c.bypass)             # transquant_bypass_enabled_flag
        b.u(1, c.tiles)
        b.u(1, c.wpp)
        if c.tiles:                  # two columns, uniformly spaced
            b.ue(1)
            b.ue(0)
            b.u(1, 1)
            b.u(1, 1)
        b.u(1, c.loop_filter_across)
        b.u(1, c.deblock_control)
        if c.deblock_control:
            b.u(1, c.deblock_override)
            b.u(1, c.deblock_disabled)
            if not c.deblock_disabled:
                b.se(1)
                b.se(-1)
        b.u(1, c.scaling == "pps")
        if c.scaling == "pps":
            self._scaling_data(b)
        b.u(1, c.lists_modification)
        b.ue(c.log2_par_mrg - 2)
        b.u(1, c.header_ext)
        b.u(1, bool(c.pps_ext))
        if c.pps_ext:
            b.u(8, c.pps_ext)
            b.u(32, 0)
        b.trailing()
        return nal(34, b.tobytes())

    # ------------------------------------------------------- pictures

    def write(self):
        """``(parameter set NAL units, access units)``: each access unit a
        list of NAL units."""
        aus = []
        self.row_cache = {}
        for i, p in enumerate(self.pics):
            au = self.picture(p)
            if p.eos:
                au.append(bytes([36 << 1, 1]))
            aus.append(au)
        return [self.vps(), self.sps(), self.pps()], aus

    def picture(self, p):
        c, r = self.cfg, self.rng
        total = self.cw * self.ch
        if c.row_repeat:
            starts = list(range(0, total, self.cw))
        else:
            n = int(r.integers(1, c.max_slices + 1))
            starts = sorted({0} | {int(v) for v in r.integers(1, max(2, total), n - 1)}) \
                if total > 1 and n > 1 else [0]
        self.slice_of = np.full(total, -1)
        for i, s in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else total
            self.slice_of[s:end] = s
        n4 = self.w4 * (self.H // 4)
        self.ctd = np.zeros(n4, np.int8)
        self.skipf = np.zeros(n4, np.int8)
        self.intra = np.zeros(n4, np.int8)
        self.ipm = np.ones(n4, np.int8)
        self.kind = p.kind
        # per picture: the collocated picture and the lists' sizes
        total_curr = sum(u for _, u in p.rps) + sum(u for _, u, _ in p.lt)
        self.total_curr = total_curr
        self.col = (bool(r.integers(0, 2)), 0)
        self.wpp_saved = None
        self.pic_hdr = None
        nals = []
        for i, s in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else total
            nals.append(self.slice(p, s, end, first=i == 0))
        return nals

    def slice(self, p, start, end, first):
        c, r = self.cfg, self.rng
        stype = {"B": 0, "P": 1, "I": 2}[p.kind]
        if c.row_repeat and self.pic_hdr is not None:
            self.hdr = hdr = self.pic_hdr
            subs = self.slice_data(p, start, end, hdr)
            b = Bits()
            self.slice_header(b, p, start, first, hdr, subs)
            return nal(p.nut, b.tobytes() + b"".join(subs), p.tid)
        hdr = {"type": stype}
        self.pic_hdr = hdr
        hdr["qp"] = int(r.integers(c.qp[0], c.qp[1] + 1))
        hdr["cb"], hdr["cr"] = ((int(r.integers(-3, 4)), int(r.integers(-3, 4)))
                                if c.slice_chroma_qp else (0, 0))
        hdr["sao_luma"] = c.sao and r.random() < 0.8
        hdr["sao_chroma"] = c.sao and r.random() < 0.7
        hdr["num_ref"] = [0, 0]
        if stype != 2:
            hdr["num_ref"][0] = int(r.integers(1, min(4, max(1, self.total_curr) + 2) + 1))
            if stype == 0:
                hdr["num_ref"][1] = int(r.integers(1, min(4, max(1, self.total_curr) + 2) + 1))
        hdr["max_merge"] = int(r.integers(c.max_merge[0], c.max_merge[1] + 1))
        hdr["cabac_init"] = c.cabac_init_present and r.random() < 0.5
        hdr["mvd_l1_zero"] = stype == 0 and r.random() < 0.3
        hdr["tmvp"] = c.tmvp and p.nut not in (19, 20)
        disabled = c.deblock_disabled
        hdr["override"] = c.deblock_control and c.deblock_override and r.random() < 0.5
        if hdr["override"]:
            disabled = c.slice_disable and r.random() < 0.25
            hdr["beta"], hdr["tc"] = int(r.integers(-6, 7)), int(r.integers(-6, 7))
        hdr["disabled"] = disabled
        hdr["across"] = c.loop_filter_across and r.random() < 0.6
        self.hdr = hdr
        # the slice data: one substream a CTB row with WPP
        subs = self.slice_data(p, start, end, hdr)
        for _ in range(4):
            b = Bits()
            self.slice_header(b, p, start, first, hdr, subs)
            head = b.tobytes()
            body = b"".join(subs)
            esc = nal(p.nut, head + body, p.tid)
            if len(subs) <= 1:
                return esc
            # entry points count the escaped bytes of each substream
            sizes, pos, rbsp = [], len(head), head + body
            for s in subs[:-1]:
                a = len(escape(rbsp[:pos]))
                pos += len(s)
                sizes.append(len(escape(rbsp[:pos])) - a)
            if sizes == hdr.get("entries"):
                return esc
            hdr["entries"] = sizes
        raise AssertionError("entry points did not settle")

    def slice_header(self, b, p, start, first, hdr, subs):
        c = self.cfg
        b.u(1, first)
        if 16 <= p.nut <= 23:
            b.u(1, 0)
        b.ue(0)
        if not first:
            if c.dependent_slices:
                b.u(1, 1)            # dependent_slice_segment_flag
            b.u((self.cw * self.ch - 1).bit_length(), start)
        b.u(c.extra_bits, (1 << c.extra_bits) - 1 if c.extra_bits else 0)
        b.ue(hdr["type"])
        if c.p_no_output > 0:
            b.u(1, p.output)
        if p.nut not in (19, 20):
            b.u(c.log2_max_poc_lsb, p.poc % (1 << c.log2_max_poc_lsb))
            s = tuple(p.rps)
            if s in self.sets:
                b.u(1, 1)
                if len(self.sets) > 1:
                    b.u((len(self.sets) - 1).bit_length(), self.sets.index(s))
            else:
                b.u(1, 0)
                self._rps(b, s, len(self.sets), self.sets, in_slice=True)
            if c.long_term:
                b.ue(len(p.lt))
                max_lsb = 1 << c.log2_max_poc_lsb
                prev = 0
                for i, (lpoc, used, msb) in enumerate(p.lt):
                    b.u(c.log2_max_poc_lsb, lpoc % max_lsb)
                    b.u(1, used)
                    b.u(1, msb)
                    if msb:
                        cycle = ((p.poc - p.poc % max_lsb) - (lpoc - lpoc % max_lsb)) // max_lsb
                        b.ue(cycle - (prev if i else 0))
                        prev = cycle
            if c.tmvp:
                b.u(1, hdr["tmvp"])
        if c.sao:
            b.u(1, hdr["sao_luma"])
            b.u(1, hdr["sao_chroma"])
        if hdr["type"] != 2:
            b.u(1, 1)
            b.ue(hdr["num_ref"][0] - 1)
            if hdr["type"] == 0:
                b.ue(hdr["num_ref"][1] - 1)
            if c.lists_modification and self.total_curr > 1:
                bits = (self.total_curr - 1).bit_length()
                for l in range(2 if hdr["type"] == 0 else 1):
                    mod = hdr.setdefault("mod", {}).setdefault(
                        l, [int(v) for v in self.rng.integers(0, self.total_curr,
                                                              hdr["num_ref"][l])]
                        if self.rng.random() < 0.5 else None)
                    b.u(1, mod is not None)
                    if mod is not None:
                        for v in mod:
                            b.u(bits, v)
            if hdr["type"] == 0:
                b.u(1, hdr["mvd_l1_zero"])
            if c.cabac_init_present:
                b.u(1, hdr["cabac_init"])
            if hdr["tmvp"]:
                col_l0 = hdr.setdefault("col_l0", hdr["type"] == 1 or self.col[0])
                if hdr["type"] == 0:
                    b.u(1, col_l0)
                lst = 0 if col_l0 else 1
                if hdr["num_ref"][lst] > 1:
                    b.ue(hdr.setdefault("col_idx", int(self.rng.integers(0, hdr["num_ref"][lst]))))
            if (c.weighted_pred and hdr["type"] == 1) or (c.weighted_bipred and hdr["type"] == 0):
                self._weights(b, hdr)
            b.ue(5 - hdr["max_merge"])
        b.se(hdr["qp"] - c.init_qp)
        if c.slice_chroma_qp:
            b.se(hdr["cb"])
            b.se(hdr["cr"])
        if c.deblock_control and c.deblock_override:
            b.u(1, hdr["override"])
            if hdr["override"]:
                b.u(1, hdr["disabled"])
                if not hdr["disabled"]:
                    b.se(hdr["beta"])
                    b.se(hdr["tc"])
        if c.loop_filter_across and (hdr["sao_luma"] or hdr["sao_chroma"] or not hdr["disabled"]):
            b.u(1, hdr["across"])
        if c.wpp:
            entries = hdr.get("entries") or [1] * (len(subs) - 1)
            b.ue(len(entries))
            if entries:
                n = max(1, max(e - 1 for e in entries).bit_length())
                b.ue(n - 1)
                for e in entries:
                    b.u(n, e - 1)
        if c.header_ext:
            b.ue(3)
            b.u(24, 0xA5C3E1)
        b.trailing()

    def _weights(self, b, hdr):
        r = self.rng
        w = hdr.setdefault("weights", None)
        if w is None:
            ld = int(r.integers(0, 8))
            cd = int(r.integers(0, 8))
            lists = []
            for l in range(2 if hdr["type"] == 0 else 1):
                lists.append([(r.random() < 0.6, r.random() < 0.5,
                               int(r.integers(-128, 128)) if r.random() < 0.3
                               else int(r.integers(-20, 21)), int(r.integers(-128, 128)),
                               [int(r.integers(-40, 41)) for _ in range(2)],
                               [int(r.integers(-512, 512)) for _ in range(2)])
                              for _ in range(hdr["num_ref"][l])])
            w = hdr["weights"] = (ld, cd, lists)
        ld, cd, lists = w
        b.ue(ld)
        b.se(cd - ld)
        for entries in lists:
            for e in entries:
                b.u(1, e[0])
            for e in entries:
                b.u(1, e[1])
            for e in entries:
                if e[0]:
                    b.se(e[2])
                    b.se(e[3])
                if e[1]:
                    for j in range(2):
                        b.se(e[4][j])
                        b.se(e[5][j])

    # ----------------------------------------------------------- slice data

    def avail(self, xn, yn):
        """A neighbour left of or above the current block: in the picture
        and in the current slice (it is then already coded)."""
        if xn < 0 or yn < 0 or xn >= self.W or yn >= self.H:
            return False
        return self.slice_of[(yn >> self.cfg.log2_ctb) * self.cw + (xn >> self.cfg.log2_ctb)] \
            == self.slice_addr

    def at4(self, x, y):
        return (y >> 2) * self.w4 + (x >> 2)

    def fill(self, a, x, y, w, h, v):
        for yy in range(y >> 2, (y + h) >> 2):
            a[yy * self.w4 + (x >> 2):yy * self.w4 + ((x + w) >> 2)] = v

    def slice_data(self, p, start, end, hdr):
        c, r = self.cfg, self.rng
        stype = hdr["type"]
        init_type = 0 if stype == 2 else (2 if hdr["cabac_init"] else 1) if stype == 1 else \
            (1 if hdr["cabac_init"] else 2)
        self.slice_addr = start
        key = None
        if c.row_repeat and (start // self.cw + 1) * self.ctb <= self.H:
            key = (id(self.pic_hdr), self.kind)   # a whole CTB row: its data repeats
            if key in self.row_cache:
                return self.row_cache[key]
        subs = []
        bits = Bits()
        cab = Cabac(bits)
        cab.init_contexts(init_type, hdr["qp"])
        self.cab = cab
        self.qg_coded = False
        for addr in range(start, end):
            rx, ry = addr % self.cw, addr // self.cw
            if c.wpp and addr != start and rx == 0:
                cab.terminate(0)          # end_of_slice_segment_flag
                cab.terminate(1)          # end_of_subset_one_bit, aligned
                subs.append(bits.tobytes())
                bits = Bits()
                cab.bits = bits
                cab.reset()
                if self.cw == 1:
                    cab.init_contexts(init_type, hdr["qp"])
                else:
                    cab.state, cab.mps = list(self.wpp_saved[0]), list(self.wpp_saved[1])
            if hdr["sao_luma"] or hdr["sao_chroma"]:
                self.sao(rx, ry, addr, hdr)
            self.quadtree(rx << c.log2_ctb, ry << c.log2_ctb, c.log2_ctb, 0)
            if c.wpp and self.cw >= 2 and rx == 1:
                self.wpp_saved = (list(cab.state), list(cab.mps))
            if addr == end - 1:
                cab.terminate(1)
            elif not (c.wpp and (addr + 1) % self.cw == 0):
                cab.terminate(0)
        subs.append(bits.tobytes())
        if key is not None:
            self.row_cache[key] = subs
        return subs

    def sao(self, rx, ry, addr, hdr):
        cab, r = self.cab, self.rng
        left = rx > 0 and self.slice_of[addr - 1] == self.slice_addr
        up = ry > 0 and self.slice_of[addr - self.cw] == self.slice_addr
        if left:
            if cab.decision(SAO_MERGE, r.random() < 0.3):
                return
        if up:
            if cab.decision(SAO_MERGE, r.random() < 0.3):
                return
        for ci in range(3):
            if (ci == 0 and not hdr["sao_luma"]) or (ci > 0 and not hdr["sao_chroma"]):
                continue
            if ci < 2:
                t = int(r.integers(0, 3))
                cab.decision(SAO_TYPE, t != 0)
                if t:
                    cab.bypass(t == 2)
                typ = t
                if ci == 1:
                    self.chroma_type = t
            else:
                typ = self.chroma_type
            if not typ:
                continue
            offs = [int(v) for v in r.integers(0, 8, 4)]
            for v in offs:
                for _ in range(v):
                    cab.bypass(1)
                if v < 7:
                    cab.bypass(0)
            if typ == 1:
                for v in offs:
                    if v:
                        cab.bypass(r.random() < 0.5)
                cab.bypass_bits(5, int(r.integers(0, 32)))
            elif ci < 2:
                cab.bypass_bits(2, int(r.integers(0, 4)))

    def quadtree(self, x0, y0, log2, depth):
        c, cab = self.cfg, self.cab
        size = 1 << log2
        if x0 + size <= self.W and y0 + size <= self.H and log2 > c.log2_min_cb:
            inc = int(self.avail(x0 - 1, y0) and self.ctd[self.at4(x0 - 1, y0)] > depth) + \
                int(self.avail(x0, y0 - 1) and self.ctd[self.at4(x0, y0 - 1)] > depth)
            split = cab.decision(SPLIT_CU + inc, self.rng.random() < c.p_split)
        else:
            split = log2 > c.log2_min_cb
        if c.cu_qp_delta and size >= (1 << (c.log2_ctb - c.qp_delta_depth)):
            self.qg_coded = False
        if split:
            h = size >> 1
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                if x0 + dx < self.W and y0 + dy < self.H:
                    self.quadtree(x0 + dx, y0 + dy, log2 - 1, depth + 1)
        else:
            self.cu(x0, y0, log2, depth)

    def cu(self, x0, y0, log2, depth):
        c, cab, r = self.cfg, self.cab, self.rng
        n = 1 << log2
        stype = self.hdr["type"]
        self.cu_log2, self.cu_depth = log2, depth
        self.fill(self.ctd, x0, y0, n, n, depth)
        skip = False
        if stype != 2:
            inc = int(self.avail(x0 - 1, y0) and self.skipf[self.at4(x0 - 1, y0)]) + \
                int(self.avail(x0, y0 - 1) and self.skipf[self.at4(x0, y0 - 1)])
            skip = cab.decision(SKIP + inc, r.random() < c.p_skip)
        if skip:
            self.fill(self.skipf, x0, y0, n, n, 1)
            self.pu(x0, y0, n, n, True)
            return
        intra = stype == 2 or r.random() < c.p_intra
        if stype != 2:
            cab.decision(PRED_MODE, intra)
        part = P_2Nx2N
        if not intra or log2 == c.log2_min_cb:
            part = self.part_mode(log2, intra)
        self.part, self.intra_cu = part, intra
        merge0 = False
        if intra:
            self.fill(self.intra, x0, y0, n, n, 1)
            self.intra_modes(x0, y0, log2, part == P_NxN)
        else:
            h, q = n // 2, n // 4
            parts = {P_2Nx2N: [(0, 0, n, n)], P_2NxN: [(0, 0, n, h), (0, h, n, h)],
                     P_Nx2N: [(0, 0, h, n), (h, 0, h, n)],
                     P_2NxnU: [(0, 0, n, q), (0, q, n, n - q)],
                     P_2NxnD: [(0, 0, n, n - q), (0, n - q, n, q)],
                     P_nLx2N: [(0, 0, q, n), (q, 0, n - q, n)],
                     P_nRx2N: [(0, 0, n - q, n), (n - q, 0, q, n)],
                     P_NxN: [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)]}[part]
            for i, (dx, dy, w, hh) in enumerate(parts):
                m = self.pu(x0 + dx, y0 + dy, w, hh, False)
                if i == 0:
                    merge0 = m
        rqt = True
        if not intra and not (part == P_2Nx2N and merge0):
            rqt = cab.decision(RQT_ROOT_CBF, r.random() < 0.7)
        if rqt:
            self.max_depth = (c.depth_intra + (part == P_NxN)) if intra else c.depth_inter
            self.ttree(x0, y0, x0, y0, log2, 0, 0, False, False)

    def part_mode(self, log2, intra):
        c, cab, r = self.cfg, self.cab, self.rng
        if intra:
            nxn = log2 > 2 and r.random() < 0.4
            cab.decision(PART_MODE, not nxn)
            return P_NxN if nxn else P_2Nx2N
        choices = [P_2Nx2N, P_2NxN, P_Nx2N]
        if log2 == c.log2_min_cb:
            if log2 > 3:
                choices.append(P_NxN)
        elif c.amp:
            choices += [P_2NxnU, P_2NxnD, P_nLx2N, P_nRx2N]
        part = int(r.choice(choices))
        if part == P_2Nx2N:
            cab.decision(PART_MODE, 1)
            return part
        cab.decision(PART_MODE, 0)
        if log2 == c.log2_min_cb:
            cab.decision(PART_MODE + 1, part == P_2NxN)
            if part != P_2NxN and log2 > 3:
                cab.decision(PART_MODE + 2, part == P_Nx2N)
            return part
        if not c.amp:
            cab.decision(PART_MODE + 1, part == P_2NxN)
            return part
        horiz = part in (P_2NxN, P_2NxnU, P_2NxnD)
        cab.decision(PART_MODE + 1, horiz)
        cab.decision(PART_MODE + 3, part in (P_2NxN, P_Nx2N))
        if part in (P_2NxnU, P_2NxnD):
            cab.bypass(part == P_2NxnD)
        elif part in (P_nLx2N, P_nRx2N):
            cab.bypass(part == P_nRx2N)
        return part

    def mpm(self, x, y):
        ctb = self.cfg.log2_ctb
        a = b = 1
        if self.avail(x - 1, y) and self.intra[self.at4(x - 1, y)]:
            a = int(self.ipm[self.at4(x - 1, y)])
        if y - 1 >= ((y >> ctb) << ctb) and self.avail(x, y - 1) and self.intra[self.at4(x, y - 1)]:
            b = int(self.ipm[self.at4(x, y - 1)])
        if a == b:
            return [0, 1, 26] if a < 2 else [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        return [a, b, 0 if (a and b) else (1 if a != 1 and b != 1 else 26)]

    def intra_modes(self, x0, y0, log2, split):
        cab, r = self.cab, self.rng
        n = 1 << log2
        pb = n // 2 if split else n
        codes = []
        for i in range(4 if split else 1):
            x, y = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            cand = self.mpm(x, y)
            mode = int(cand[int(r.integers(0, 3))]) if r.random() < 0.5 else int(r.integers(0, 35))
            if mode in cand:
                codes.append((True, cand.index(mode)))
            else:
                rem = mode - sum(1 for cm in cand if cm < mode)
                codes.append((False, rem))
            self.fill(self.ipm, x, y, pb, pb, mode)
        for prev, _ in codes:
            cab.decision(PREV_INTRA, prev)
        for prev, v in codes:
            if prev:
                cab.bypass(v > 0)
                if v > 0:
                    cab.bypass(v > 1)
            else:
                cab.bypass_bits(5, v)
        c = int(r.integers(0, 5))
        cab.decision(CHROMA_MODE, c != 4)
        if c != 4:
            cab.bypass_bits(2, c)
        luma = int(self.ipm[self.at4(x0, y0)])
        mode = [0, 26, 10, 1][c] if c < 4 else luma
        self.chroma_mode = 34 if c < 4 and mode == luma else mode

    def pu(self, x, y, w, h, skip):
        c, cab, r = self.cfg, self.cab, self.rng
        hdr = self.hdr
        merge = skip or cab.decision(MERGE_FLAG, r.random() < c.p_merge)
        if merge:
            if hdr["max_merge"] > 1:
                idx = int(r.integers(0, hdr["max_merge"]))
                cab.decision(MERGE_IDX, idx > 0)
                for k in range(1, hdr["max_merge"] - 1):
                    if idx < k:
                        break
                    cab.bypass(idx > k)
            return True
        idc = 0
        if hdr["type"] == 0:
            idc = int(r.integers(0, 3 if w + h != 12 else 2))   # L0, L1, BI
            if w + h != 12:
                cab.decision(INTER_PRED + self.cu_depth, idc == 2)
            if idc != 2:
                cab.decision(INTER_PRED + 4, idc == 1)
        for l in range(2):
            if (l == 0 and idc == 1) or (l == 1 and idc == 0):
                continue
            nref = hdr["num_ref"][l]
            if nref > 1:
                ref = int(r.integers(0, nref))
                for k in range(min(nref - 1, 2)):
                    cab.decision(REF_IDX + k, ref > k)
                    if ref <= k:
                        break
                else:
                    for k in range(2, nref - 1):
                        cab.bypass(ref > k)
                        if ref <= k:
                            break
            if not (l == 1 and hdr["mvd_l1_zero"] and idc == 2):
                self.mvd()
            cab.decision(MVP_FLAG, r.random() < 0.5)
        return False

    def mvd(self):
        cab, r = self.cab, self.rng
        big = r.random() < self.cfg.p_big_mv
        v = [int(r.integers(-3000, 3001)) if big else int(r.integers(-24, 25)) for _ in range(2)]
        for k in range(2):
            cab.decision(MVD_GT0, v[k] != 0)
        for k in range(2):
            if v[k]:
                cab.decision(MVD_GT1, abs(v[k]) > 1)
        for k in range(2):
            if not v[k]:
                continue
            if abs(v[k]) > 1:
                self.eg(abs(v[k]) - 2, 1)
            cab.bypass(v[k] < 0)

    def eg(self, v, k):
        cab = self.cab
        while v >= (1 << k):
            cab.bypass(1)
            v -= 1 << k
            k += 1
        cab.bypass(0)
        cab.bypass_bits(k, v)

    def ttree(self, x0, y0, xb, yb, log2, depth, blk, pcb, pcr):
        c, cab, r = self.cfg, self.cab, self.rng
        intra, part = self.intra_cu, self.part
        if log2 <= c.log2_max_tb and log2 > c.log2_min_tb and depth < self.max_depth and \
                not (part == P_NxN and intra and depth == 0):
            split = cab.decision(SPLIT_TRANSFORM + 5 - log2, r.random() < c.p_tsplit)
        else:
            inter_split = c.depth_inter == 0 and not intra and part != P_2Nx2N and depth == 0
            split = log2 > c.log2_max_tb or (intra and part == P_NxN and depth == 0) or inter_split
        ccb, ccr = pcb, pcr
        if log2 > 2:
            ccb = cab.decision(CBF_CHROMA + depth, r.random() < c.p_cbf) if depth == 0 or pcb \
                else False
            ccr = cab.decision(CBF_CHROMA + depth, r.random() < c.p_cbf) if depth == 0 or pcr \
                else False
        if split:
            h = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(((0, 0), (h, 0), (0, h), (h, h))):
                self.ttree(x0 + dx, y0 + dy, x0, y0, log2 - 1, depth + 1, i, ccb, ccr)
            return
        cl = True
        if intra or depth != 0 or ccb or ccr:
            cl = cab.decision(CBF_LUMA + (1 if depth == 0 else 0), r.random() < c.p_cbf)
        if (cl or ccb or ccr) and c.cu_qp_delta and not self.qg_coded:
            v = int(r.integers(-26, 26)) if r.random() < 0.2 else int(r.integers(-3, 4)) \
                if r.random() < c.p_qp_delta else 0
            a = abs(v)
            for k in range(min(a, 5)):
                cab.decision(QP_DELTA + (k > 0), 1)
            if a < 5:
                cab.decision(QP_DELTA + (a > 0), 0)
            else:
                self.eg(a - 5, 0)
            if a:
                cab.bypass(v < 0)
            self.qg_coded = True
        if cl:
            self.residual(x0, y0, log2, 0)
        if log2 > 2 or blk == 3:
            xc, yc = (x0, y0) if log2 > 2 else (xb, yb)
            lc = log2 - 1 if log2 > 2 else 2
            if ccb:
                self.residual(xc // 2, yc // 2, lc, 1)
            if ccr:
                self.residual(xc // 2, yc // 2, lc, 2)

    def residual(self, x0, y0, log2, ci):
        c, cab, r = self.cfg, self.cab, self.rng
        n = 1 << log2
        if c.transform_skip and log2 == 2:
            cab.decision(TRANSFORM_SKIP + (1 if ci else 0), r.random() < 0.3)
        scan = 0
        if self.intra_cu and (log2 == 2 or (log2 == 3 and ci == 0)):
            m = self.chroma_mode if ci else int(self.ipm[self.at4(x0 << (1 if ci else 0),
                                                                y0 << (1 if ci else 0))])
            scan = 2 if 6 <= m <= 14 else 1 if 22 <= m <= 30 else 0
        nsb = n // 4
        sbscan = SCANS[nsb][scan] if nsb > 1 else [(0, 0)]
        scan4 = SCANS[4][scan]
        # the last coefficient: low sub-blocks more often
        last_sb = min(len(sbscan) - 1, int(r.geometric(0.45)) - 1) if r.random() < 0.8 \
            else int(r.integers(0, len(sbscan)))
        last_pos = int(r.integers(0, 16))
        xs, ys = sbscan[last_sb]
        lx, ly = xs * 4 + scan4[last_pos][0], ys * 4 + scan4[last_pos][1]
        cx, cy = (ly, lx) if scan == 2 else (lx, ly)
        for k, v in ((LAST_X, cx), (LAST_Y, cy)):
            self.last_prefix(k, v, log2, ci)
        for v in (cx, cy):
            if v > 3:
                p = self._last_group(v)
                k = (p >> 1) - 1
                cab.bypass_bits(k, v - (1 << k) * (2 + (p & 1)))
        csbf = {}
        greater1_ctx = 1
        for i in range(last_sb, -1, -1):
            xs, ys = sbscan[i]
            right = csbf.get((xs + 1, ys), 0)
            below = csbf.get((xs, ys + 1), 0)
            infer_dc = False
            if 0 < i < last_sb:
                f = r.random() < 0.6
                cab.decision(CSBF + min(right + below, 1) + (2 if ci else 0), f)
                csbf[xs, ys] = int(f)
                infer_dc = True
            else:
                csbf[xs, ys] = 1
            prev = right | (below << 1)
            ps = []
            start = 15
            if i == last_sb:
                ps.append(last_pos)
                start = last_pos - 1
            if csbf[xs, ys]:
                for p in range(start, -1, -1):
                    xp, yp = scan4[p]
                    xc, yc = xs * 4 + xp, ys * 4 + yp
                    if p > 0 or not infer_dc:
                        if log2 == 2:
                            sc = CTX_IDX_MAP[(yc << 2) + xc]
                        elif xc + yc == 0:
                            sc = 0
                        else:
                            if prev == 0:
                                sc = 2 if xp + yp == 0 else 1 if xp + yp < 3 else 0
                            elif prev == 1:
                                sc = 2 if yp == 0 else 1 if yp == 1 else 0
                            elif prev == 2:
                                sc = 2 if xp == 0 else 1 if xp == 1 else 0
                            else:
                                sc = 2
                            if ci == 0:
                                if xs or ys:
                                    sc += 3
                                sc += (9 if scan == 0 else 15) if log2 == 3 else 21
                            else:
                                sc += 9 if log2 == 3 else 12
                        s = r.random() < c.sig_density
                        cab.decision(SIG + (27 if ci else 0) + sc, s)
                        if s:
                            ps.append(p)
                            infer_dc = False
                    else:
                        ps.append(0)
            if not ps:
                continue
            levels = []
            for _ in ps:
                u = r.random()
                if u < c.p_big:
                    levels.append(int(r.integers(100, 3000)))
                elif u < 0.6:
                    levels.append(1)
                elif u < 0.85:
                    levels.append(2)
                else:
                    levels.append(int(r.integers(3, 40)))
            ctx_set = 2 if (i > 0 and ci == 0) else 0
            if i != last_sb and greater1_ctx == 0:
                ctx_set += 1
            greater1_ctx = 1
            first_g1 = -1
            for m in range(min(len(ps), 8)):
                g = levels[m] > 1
                cab.decision(GT1 + (16 if ci else 0) + (ctx_set << 2) + greater1_ctx, g)
                if g:
                    greater1_ctx = 0
                    if first_g1 == -1:
                        first_g1 = m
                elif 0 < greater1_ctx < 3:
                    greater1_ctx += 1
            if first_g1 != -1:
                cab.decision(GT2 + (4 if ci else 0) + ctx_set, levels[first_g1] > 2)
            hidden = c.sign_hiding and ps[0] - ps[-1] > 3
            for m in range(len(ps) - (1 if hidden else 0)):
                cab.bypass(r.random() < 0.5)
            rice = 0
            for m, lv in enumerate(levels):
                if m < 8:
                    base = 1 + (lv > 1) + (m == first_g1 and lv > 2)
                    if base != (3 if m == first_g1 else 2):
                        continue
                else:
                    base = 1
                self.remaining(lv - base, rice)
                if lv > (3 << rice):
                    rice = min(rice + 1, 4)

    def remaining(self, v, rice):
        """9.3.3.11: coeff_abs_level_remaining."""
        cab = self.cab
        if (v >> rice) < 4:
            for _ in range(v >> rice):
                cab.bypass(1)
            cab.bypass(0)
            cab.bypass_bits(rice, v & ((1 << rice) - 1))
            return
        for _ in range(4):
            cab.bypass(1)
        self.eg(v - (4 << rice), rice + 1)

    @staticmethod
    def _last_group(v):
        for p in range(4, 10):
            k = (p >> 1) - 1
            lo = (1 << k) * (2 + (p & 1))
            if lo <= v < lo + (1 << k):
                return p
        raise ValueError(v)

    def last_prefix(self, base, v, log2, ci):
        cab = self.cab
        p = v if v <= 3 else self._last_group(v)
        if ci == 0:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        else:
            off, shift = 15, log2 - 2
        mx = (log2 << 1) - 1
        for i in range(p):
            cab.decision(base + off + (i >> shift), 1)
        if p < mx:
            cab.decision(base + off + (p >> shift), 0)


# ----------------------------------------------------------------- MP4


def _box(kind, *payload):
    body = b"".join(payload)
    return (8 + len(body)).to_bytes(4, "big") + kind + body


def _full(kind, version, flags, *payload):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big"), *payload)


def hvcc(params, length_size=4, entry=b"hvc1"):
    """The hvcC box's payload: the parameter sets as arrays (none for
    ``hev1``, whose samples carry them)."""
    arrays = []
    if entry == b"hvc1":
        for t in (32, 33, 34):
            ns = [p for p in params if (p[0] >> 1) == t]
            arrays.append(bytes([0x80 | t]) + len(ns).to_bytes(2, "big") +
                          b"".join(len(p).to_bytes(2, "big") + p for p in ns))
    head = bytes([1, 0x01]) + (0x60000000).to_bytes(4, "big") + bytes([0x90, 0, 0, 0, 0, 0]) + \
        bytes([93, 0xF0, 0x00, 0xFC, 0xFD, 0xF8, 0xF8, 0, 0, 0x0C | (length_size - 1)])
    return head + bytes([len(arrays)]) + b"".join(arrays)


def mp4(params, aus, width, height, length_size=4, entry=b"hvc1", cts=None, edit=None) -> bytes:
    """An MP4 file of one video track: ``aus`` as samples of
    ``length_size``-byte NAL lengths (with ``hev1`` the parameter sets lead
    the first), 60 samples a second; with ``cts`` each sample's composition
    time (a ctts box) and with ``edit`` an edit list of that media_time."""
    aus = [list(au) for au in aus]
    if entry == b"hev1":
        aus[0] = list(params) + aus[0]
    samples = [b"".join(len(n).to_bytes(length_size, "big") + n for n in au) for au in aus]
    ftyp = _box(b"ftyp", b"isom", (512).to_bytes(4, "big"), b"isomiso2mp41")
    n = len(samples)
    u32 = lambda v: v.to_bytes(4, "big")
    u16 = lambda v: v.to_bytes(2, "big")

    def moov(data_off):
        entry_box = _box(entry, bytes(6), u16(1), bytes(16), u16(width), u16(height),
                         u32(0x00480000), u32(0x00480000), u32(0), u16(1), bytes(32), u16(24),
                         (0xFFFF).to_bytes(2, "big"),
                         _box(b"hvcC", hvcc(params, length_size, entry)))
        stbl = [_full(b"stsd", 0, 0, u32(1), entry_box),
                _full(b"stts", 0, 0, u32(1), u32(n), u32(1))]
        if cts is not None:
            offs = [c - i for i, c in enumerate(cts)]
            stbl.append(_full(b"ctts", 0, 0, u32(n), *[u32(1) + u32(o) for o in offs]))
        stbl += [_full(b"stsc", 0, 0, u32(1), u32(1), u32(n), u32(1)),
                 _full(b"stsz", 0, 0, u32(0), u32(n), *[u32(len(s)) for s in samples]),
                 _full(b"stco", 0, 0, u32(1), u32(data_off))]
        keys = [i + 1 for i, au in enumerate(aus) if any(16 <= (x[0] >> 1) <= 21 for x in au)]
        stbl.append(_full(b"stss", 0, 0, u32(len(keys)), *[u32(k) for k in keys]))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                    _box(b"dinf", _full(b"dref", 0, 0, u32(1), _full(b"url ", 0, 1))),
                    _box(b"stbl", *stbl))
        hdlr = _full(b"hdlr", 0, 0, u32(0), b"vide", bytes(12), b"VideoHandler\x00")
        mdhd = _full(b"mdhd", 0, 0, u32(0), u32(0), u32(60), u32(n), u16(0x55C4), u16(0))
        matrix = u32(0x10000) + u32(0) * 3 + u32(0x10000) + u32(0) * 3 + u32(0x40000000)
        tkhd = _full(b"tkhd", 0, 3, u32(0), u32(0), u32(1), u32(0), u32(n * 1000 // 60),
                     bytes(8), u16(0), u16(0), u16(0), u16(0), matrix,
                     u32(width << 16), u32(height << 16))
        parts = [tkhd]
        if edit is not None:
            parts.append(_box(b"edts", _full(b"elst", 0, 0, u32(1), u32(n * 1000 // 60),
                                             u32(edit), u32(0x10000))))
        trak = _box(b"trak", *parts, _box(b"mdia", mdhd, hdlr, minf))
        mvhd = _full(b"mvhd", 0, 0, u32(0), u32(0), u32(1000), u32(n * 1000 // 60),
                     u32(0x10000), u16(0x100), bytes(10), matrix, bytes(24), u32(2))
        return _box(b"moov", mvhd, trak)

    m = moov(len(ftyp) + 8)
    return ftyp + _box(b"mdat", b"".join(samples)) + m


def display_cts(pics):
    """Each sample's composition time as FFmpeg's muxer writes it with
    B-frames: its display index plus the delay that keeps every
    composition time at or after its decoding time (the edit list's
    media_time)."""
    disp = sorted(range(len(pics)), key=lambda i: pics[i].disp)
    rank = {i: d for d, i in enumerate(disp)}
    delay = max(0, max(i - rank[i] for i in range(len(pics))))
    return [rank[i] + delay for i in range(len(pics))], delay


def write(cfg: Config):
    """``(parameter sets, access units, writer)`` of the stream ``cfg``
    draws."""
    w = Writer(cfg)
    params, aus = w.write()
    return params, aus, w


def video(cfg: Config) -> bytes:
    """The MP4 file of the stream ``cfg`` draws."""
    params, aus, w = write(cfg)
    cts = edit = None
    if cfg.ctts:
        cts, edit = display_cts(w.pics)
    return mp4(params, aus, cfg.width, cfg.height, cfg.length_size, cfg.entry, cts, edit)


def annexb_packets(params, aus):
    """The access units as Annex-B packets, the parameter sets leading the
    first (for cv2's own libavcodec)."""
    pkts = []
    for i, au in enumerate(aus):
        head = b"".join(b"\x00\x00\x00\x01" + p for p in params) if i == 0 else b""
        pkts.append(head + b"".join(b"\x00\x00\x00\x01" + n for n in au))
    return pkts


# --------------------------------------------------------------- refusals

# each feature the decoder refuses: the words its message holds
REFUSALS = {
    "tiles": "tiles",
    "pcm": "PCM",
    "transquant_bypass": "transquant_bypass",
    "dependent_slices": "dependent slice segments",
    "bit_depth_10": "bit depths above 8",
    "chroma_422": "chroma other than 4:2:0",
    "chroma_444": "chroma other than 4:2:0",
    "monochrome": "monochrome",
    "separate_planes": "separate_colour_plane",
    "sps_range_extension": "range extension",
    "sps_multilayer_extension": "multilayer extension",
    "sps_3d_extension": "3D extension",
    "sps_scc_extension": "SCC extension",
    "pps_range_extension": "range extension",
    "pps_scc_extension": "SCC extension",
    "field_seq": "field_seq_flag",
    "matrix_bt2020": "matrix_coefficients 9",
    "missing_reference": "a reference missing from the DPB",
    "edit_list": "edit list",
}


def refusal(feature: str) -> bytes:
    """A short MP4 of the refused ``feature`` (a key of :data:`REFUSALS`):
    parameter sets that set it (their syntax written as far as the decoder
    reads it), or a stream of it."""
    small = dict(width=32, height=32, frames=2, seed=0)
    if feature == "missing_reference":       # the stream without its IDR picture
        params, aus, _ = write(Config(**{**small, "frames": 3, "gop": 0}))
        return mp4(params, aus[1:], 32, 32)
    if feature == "edit_list":               # an edit later than every sample's start
        params, aus, _ = write(Config(**small))
        return mp4(params, aus, 32, 32, edit=1)
    fields = {
        "tiles": {"tiles": True},
        "pcm": {"pcm": True},
        "transquant_bypass": {"bypass": True},
        "dependent_slices": {"dependent_slices": True, "row_repeat": True},
        "bit_depth_10": {"bit_depth": 10},
        "chroma_422": {"chroma_format": 2},
        "chroma_444": {"chroma_format": 3},
        "monochrome": {"chroma_format": 0},
        "separate_planes": {"chroma_format": 3, "separate_planes": True},
        "sps_range_extension": {"sps_ext": 0x80},
        "sps_multilayer_extension": {"sps_ext": 0x40},
        "sps_3d_extension": {"sps_ext": 0x20},
        "sps_scc_extension": {"sps_ext": 0x10},
        "pps_range_extension": {"pps_ext": 0x80},
        "pps_scc_extension": {"pps_ext": 0x10},
        "field_seq": {"vui": {"field_seq": 1}},
        "matrix_bt2020": {"vui": {"matrix": 9}},
    }[feature]
    return video(Config(**small, **fields))
