"""An H.264 writer in Python for the video decoder's test fixtures.

Nothing the tests depend on writes H.264 (cv2's ``VideoWriter`` needs an
encoder its FFmpeg build may lack), so this module writes the streams the
port's decoder (``fourdgs_tpu_torch/native/h264.cpp``) is held to: 8-bit
4:2:0 streams of I, P and B slices coded with CABAC or CAVLC (from the same
draws, so that one seed gives the same pictures in both), progressive or
with ``frame_mbs_only_flag`` 0 (frames coded as frames, as MBAFF frames of
field and frame macroblock pairs, or as field pairs: field POCs, marking
of single fields, field lists and their modifications, the field scans'
CABAC contexts, unpaired fields), as
Annex-B byte streams or as MP4 files (a field pair one sample), whose
syntax is drawn at random from a seed and a :class:`Config`: macroblock
types and partitions, intra modes, motion
vectors (far outside the picture too), reference indices, weights,
residuals, QP deltas, slices and their deblocking controls, scaling lists,
cropping, POC types, memory management operations, long-term references,
VUI colour descriptions, and runs of B pictures between anchor pictures
(direct prediction, bi-prediction, both lists' modifications and weights,
referenced B pictures). It needs no motion search and no reconstruction:
it writes syntax, and cv2 decodes what it means. The vectors it draws
lean on predictions it makes itself, which take a direct-predicted block
for one without motion: they steer the draws and reach no syntax.

It is a second implementation of the syntax in ITU-T H.264 (07/2019)
§7.3, of the CAVLC codes of §9.2 (its own copy of Tables 9-4 to 9-10, as
the standard prints them) and of the CABAC encoder in §9.3.4; it shares
with the decoder only the context initialisation values (Tables 9-12 to
9-33), which it reads out of ``h264.cpp``. A wrong entry there makes both
disagree with cv2.

Refusal fixtures (:func:`header_only`) hold a parameter set or a slice
header of a feature the decoder does not read. :func:`pcm_stream` writes
given samples as I_PCM pictures (for cv2 to convert them).
"""

from __future__ import annotations

import pathlib
import re
from dataclasses import dataclass, field

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DECODER_SRC = ROOT / "fourdgs_tpu_torch" / "native" / "h264.cpp"


def _cabac_init():
    src = DECODER_SRC.read_text()
    body = src[src.index("kCabacInit[4][460][2] = {"):]
    body = body[body.index("{"):body.index("};")]
    return np.array(list(map(int, re.findall(r"-?\d+", body))), np.int64).reshape(4, 460, 2)


CABAC_INIT = _cabac_init()

# Table 9-44: rangeTabLPS[pStateIdx][qCodIRangeIdx]
RANGE_LPS = [
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216), (123, 150, 178, 205),
    (116, 142, 169, 195), (111, 135, 160, 185), (105, 128, 152, 175), (100, 122, 144, 166),
    (95, 116, 137, 158), (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116), (66, 80, 95, 110),
    (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94), (53, 65, 77, 89),
    (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62), (35, 43, 51, 59),
    (33, 41, 48, 56), (32, 39, 46, 53), (30, 37, 43, 50), (29, 35, 41, 48),
    (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33), (19, 23, 27, 31),
    (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27), (15, 19, 22, 25),
    (14, 18, 21, 24), (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18), (10, 12, 15, 17),
    (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14), (8, 10, 12, 14),
    (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2)]
# Table 9-45: transIdxLPS
TRANS_LPS = [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15, 16, 16, 18,
             18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30,
             30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38,
             63]
# Table 9-43: ctxIdxInc of significant_coeff_flag and last_significant_coeff_flag
# of a frame-coded 8x8 block, by scanning position
SIG8 = [0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9,
        10, 9, 8, 7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11, 12, 13, 11, 6, 9,
        14, 10, 9, 11, 12, 13, 11, 14, 10, 12]
# ... of a field-coded 8x8 block (Table 9-43's field column)
SIG8_FIELD = [0, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 7, 7, 8, 4, 5, 6, 9, 10, 10, 8, 11, 12, 11, 9, 9,
              10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 13, 13, 9, 9,
              10, 10, 8, 13, 13, 9, 9, 10, 10, 14, 14, 14, 14, 14]
LAST8 = [0] + [1] * 15 + [2] * 16 + [3] * 8 + [4] * 8 + [5] * 4 + [6] * 4 + [7] * 4 + [8] * 3
ZIGZAG4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
ZIGZAG8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
           30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# Tables 7-3 and 7-4, in zigzag order
DEFAULT4 = ([6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
            [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34])
DEFAULT8 = ([6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23,
             23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29,
             29, 29, 29, 31, 31, 31, 31, 31, 31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38,
             38, 40, 40, 42],
            [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21, 21,
             22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25,
             25, 27, 27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33,
             35])
NORM4 = [(10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18), (16, 25, 20), (18, 29, 23)]
NORM8 = [(20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26), (26, 23, 42, 24, 33, 31),
         (28, 25, 45, 26, 35, 33), (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43)]

# CABAC ctxIdxOffsets (Table 9-34) and ctxBlockCatOffsets (Table 9-40)
CBF_CAT = (0, 4, 8, 12, 16)
SIG_CAT = (0, 15, 29, 44, 47)
ABS_CAT = (0, 10, 20, 30, 39)

# CAVLC (§9.2), as the standard prints its codes
# Table 9-5: coeff_token by (TrailingOnes, TotalCoeff), for 0 <= nC < 2,
# 2 <= nC < 4, 4 <= nC < 8, 8 <= nC and nC == -1 (chroma DC 4:2:0)
COEFF_TOKEN = {
    (0, 0): ('1', '11', '1111', '0000 11', '01'),
    (0, 1): ('0001 01', '0010 11', '0011 11', '0000 00', '0001 11'),
    (0, 2): ('0000 0111', '0001 11', '0010 11', '0001 00', '0001 00'),
    (0, 3): ('0000 0011 1', '0000 111', '0010 00', '0010 00', '0000 11'),
    (0, 4): ('0000 0001 11', '0000 0111', '0001 111', '0011 00', '0000 10'),
    (0, 5): ('0000 0000 111', '0000 0100', '0001 011', '0100 00', None),
    (0, 6): ('0000 0000 0111 1', '0000 0011 1', '0001 001', '0101 00', None),
    (0, 7): ('0000 0000 0101 1', '0000 0001 111', '0001 000', '0110 00', None),
    (0, 8): ('0000 0000 0100 0', '0000 0001 011', '0000 1111', '0111 00', None),
    (0, 9): ('0000 0000 0011 11', '0000 0000 1111', '0000 1011', '1000 00', None),
    (0, 10): ('0000 0000 0010 11', '0000 0000 1011', '0000 0111 1', '1001 00', None),
    (0, 11): ('0000 0000 0001 111', '0000 0000 1000', '0000 0101 1', '1010 00', None),
    (0, 12): ('0000 0000 0001 011', '0000 0000 0111 1', '0000 0100 0', '1011 00', None),
    (0, 13): ('0000 0000 0000 1111', '0000 0000 0101 1', '0000 0011 01', '1100 00', None),
    (0, 14): ('0000 0000 0000 1011', '0000 0000 0011 1', '0000 0010 01', '1101 00', None),
    (0, 15): ('0000 0000 0000 0111', '0000 0000 0010 01', '0000 0001 01', '1110 00', None),
    (0, 16): ('0000 0000 0000 0100', '0000 0000 0001 11', '0000 0000 01', '1111 00', None),
    (1, 1): ('01', '10', '1110', '0000 01', '1'),
    (1, 2): ('0001 00', '0011 1', '0111 1', '0001 01', '0001 10'),
    (1, 3): ('0000 0110', '0010 10', '0110 0', '0010 01', '0000 011'),
    (1, 4): ('0000 0011 0', '0001 10', '0101 0', '0011 01', '0000 0011'),
    (1, 5): ('0000 0001 10', '0000 110', '0100 0', '0100 01', None),
    (1, 6): ('0000 0000 110', '0000 0110', '0011 10', '0101 01', None),
    (1, 7): ('0000 0000 0111 0', '0000 0011 0', '0010 10', '0110 01', None),
    (1, 8): ('0000 0000 0101 0', '0000 0001 110', '0001 110', '0111 01', None),
    (1, 9): ('0000 0000 0011 10', '0000 0001 010', '0000 1110', '1000 01', None),
    (1, 10): ('0000 0000 0010 10', '0000 0000 1110', '0000 1010', '1001 01', None),
    (1, 11): ('0000 0000 0001 110', '0000 0000 1010', '0000 0111 0', '1010 01', None),
    (1, 12): ('0000 0000 0001 010', '0000 0000 0111 0', '0000 0101 0', '1011 01', None),
    (1, 13): ('0000 0000 0000 001', '0000 0000 0101 0', '0000 0011 1', '1100 01', None),
    (1, 14): ('0000 0000 0000 1110', '0000 0000 0010 11', '0000 0011 00', '1101 01', None),
    (1, 15): ('0000 0000 0000 1010', '0000 0000 0010 00', '0000 0010 00', '1110 01', None),
    (1, 16): ('0000 0000 0000 0110', '0000 0000 0001 10', '0000 0001 00', '1111 01', None),
    (2, 2): ('001', '011', '1101', '0001 10', '001'),
    (2, 3): ('0000 101', '0010 01', '0111 0', '0010 10', '0000 010'),
    (2, 4): ('0000 0101', '0001 01', '0101 1', '0011 10', '0000 0010'),
    (2, 5): ('0000 0010 1', '0000 101', '0100 1', '0100 10', None),
    (2, 6): ('0000 0001 01', '0000 0101', '0011 01', '0101 10', None),
    (2, 7): ('0000 0000 101', '0000 0010 1', '0010 01', '0110 10', None),
    (2, 8): ('0000 0000 0110 1', '0000 0001 101', '0001 101', '0111 10', None),
    (2, 9): ('0000 0000 0100 1', '0000 0001 001', '0001 010', '1000 10', None),
    (2, 10): ('0000 0000 0011 01', '0000 0000 1101', '0000 1101', '1001 10', None),
    (2, 11): ('0000 0000 0010 01', '0000 0000 1001', '0000 1001', '1010 10', None),
    (2, 12): ('0000 0000 0001 101', '0000 0000 0110 1', '0000 0110 1', '1011 10', None),
    (2, 13): ('0000 0000 0001 001', '0000 0000 0100 1', '0000 0100 1', '1100 10', None),
    (2, 14): ('0000 0000 0000 1101', '0000 0000 0011 0', '0000 0010 11', '1101 10', None),
    (2, 15): ('0000 0000 0000 1001', '0000 0000 0010 10', '0000 0001 11', '1110 10', None),
    (2, 16): ('0000 0000 0000 0101', '0000 0000 0001 01', '0000 0000 11', '1111 10', None),
    (3, 3): ('0001 1', '0101', '1100', '0010 11', '0001 01'),
    (3, 4): ('0000 11', '0100', '1011', '0011 11', '0000 000'),
    (3, 5): ('0000 100', '0011 0', '1010', '0100 11', None),
    (3, 6): ('0000 0100', '0010 00', '1001', '0101 11', None),
    (3, 7): ('0000 0010 0', '0001 00', '1000', '0110 11', None),
    (3, 8): ('0000 0001 00', '0000 100', '0110 1', '0111 11', None),
    (3, 9): ('0000 0000 100', '0000 0010 0', '0011 00', '1000 11', None),
    (3, 10): ('0000 0000 0110 0', '0000 0001 100', '0001 100', '1001 11', None),
    (3, 11): ('0000 0000 0011 00', '0000 0001 000', '0000 1100', '1010 11', None),
    (3, 12): ('0000 0000 0010 00', '0000 0000 1100', '0000 1000', '1011 11', None),
    (3, 13): ('0000 0000 0001 100', '0000 0000 0110 0', '0000 0110 0', '1100 11', None),
    (3, 14): ('0000 0000 0001 000', '0000 0000 0100 0', '0000 0010 10', '1101 11', None),
    (3, 15): ('0000 0000 0000 1100', '0000 0000 0000 1', '0000 0001 10', '1110 11', None),
    (3, 16): ('0000 0000 0000 1000', '0000 0000 0001 00', '0000 0000 10', '1111 11', None),
}
# Tables 9-7 and 9-8: total_zeros of a 4x4 block by tzVlcIndex 1-15 (index 0
# unused), then by its value; Table 9-9a: of a chroma DC 4:2:0 block
TOTAL_ZEROS = [None,
    ['1', '011', '010', '0011', '0010', '0001 1', '0001 0', '0000 11', '0000 10', '0000 011',
     '0000 010', '0000 0011', '0000 0010', '0000 0001 1', '0000 0001 0', '0000 0000 1'],
    ['111', '110', '101', '100', '011', '0101', '0100', '0011', '0010', '0001 1', '0001 0',
     '0000 11', '0000 10', '0000 01', '0000 00'],
    ['0101', '111', '110', '101', '0100', '0011', '100', '011', '0010', '0001 1', '0001 0',
     '0000 01', '0000 1', '0000 00'],
    ['0001 1', '111', '0101', '0100', '110', '101', '100', '0011', '011', '0010', '0001 0',
     '0000 1', '0000 0'],
    ['0101', '0100', '0011', '111', '110', '101', '100', '011', '0010', '0000 1', '0001',
     '0000 0'],
    ['0000 01', '0000 1', '111', '110', '101', '100', '011', '010', '0001', '001', '0000 00'],
    ['0000 01', '0000 1', '101', '100', '011', '11', '010', '0001', '001', '0000 00'],
    ['0000 01', '0001', '0000 1', '011', '11', '10', '010', '001', '0000 00'],
    ['0000 01', '0000 00', '0001', '11', '10', '001', '01', '0000 1'],
    ['0000 1', '0000 0', '001', '11', '10', '01', '0001'],
    ['0000', '0001', '001', '010', '1', '011'],
    ['0000', '0001', '01', '1', '001'],
    ['000', '001', '1', '01'],
    ['00', '01', '1'],
    ['0', '1'],
]
TOTAL_ZEROS_DC = [None,
    ['1', '01', '001', '000'],
    ['1', '01', '00'],
    ['1', '0'],
]
# Table 9-10: run_before by zerosLeft 1-6 and above 6 (index 7), then by its
# value
RUN_BEFORE = [None,
    ['1', '0'],
    ['1', '01', '00'],
    ['11', '10', '01', '00'],
    ['11', '10', '01', '001', '000'],
    ['11', '10', '011', '010', '001', '000'],
    ['11', '000', '001', '011', '010', '101', '100'],
    ['111', '110', '101', '100', '011', '010', '001', '0001', '0000 1', '0000 01', '0000 001',
     '0000 0001', '0000 0000 1', '0000 0000 01', '0000 0000 001'],
]
# Table 9-4 (ChromaArrayType 1 and 2): coded_block_pattern by codeNum, of
# Intra_4x4 and Intra_8x8 macroblocks and of inter ones
CBP_INTRA = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
]
CBP_INTER = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
]
CBP_CODE = ({v: k for k, v in enumerate(CBP_INTRA)}, {v: k for k, v in enumerate(CBP_INTER)})


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

    def code(self, s):
        """A code as the standard's tables print it (\"0001 01\")."""
        self.bits.extend(int(ch) for ch in s if ch != " ")

    def trailing(self):
        self.bits.append(1)
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self):
        assert len(self.bits) % 8 == 0
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def nal(ref_idc, ntype, rbsp: bytes) -> bytes:
    """A NAL unit: its header and ``rbsp`` with emulation prevention."""
    out = bytearray([(ref_idc << 5) | ntype])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class CabacEncoder:
    """§9.3.4.2-9.3.4.6: the arithmetic encoder over a :class:`Bits`."""

    def __init__(self, bits):
        self.bits = bits
        self.reset()

    def reset(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def init_contexts(self, table, qp, used=None):
        """Initialises the contexts from ``table`` at ``qp``; each context a
        decision then codes is added to the set ``used``."""
        self.used = used if used is not None else set()
        self.state = [0] * 460
        self.mps = [0] * 460
        for i, (m, n) in enumerate(table):
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
        self.used.add(ctx)
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

    def terminate(self, b):
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bits.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()

    # binarizations (§9.3.2)
    def unary(self, v, ctxs, cmax=None):
        """TU/U of ``v``: bin i uses ``ctxs[min(i, len - 1)]``."""
        for i in range(v):
            self.decision(ctxs[min(i, len(ctxs) - 1)], 1)
        if cmax is None or v < cmax:
            self.decision(ctxs[min(v, len(ctxs) - 1)], 0)

    def exp_golomb(self, v, k):
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        for i in range(k - 1, -1, -1):
            self.bypass((v >> i) & 1)


# ---------------------------------------------------------------- parameters


@dataclass
class Config:
    """The stream's fixed parameters and the probabilities its syntax is
    drawn with."""
    width: int = 40                 # output (cropped) size; even
    height: int = 24
    crop: tuple = (0, 0, 0, 0)      # left, right, top, bottom extra pixels, even
    frames: int = 4
    profile: int = 100
    level: int = 30
    transform8x8: bool = True
    sps_scaling: object = None      # None or a list of 8 lists (None: not sent,
    pps_scaling: object = None      # "default": use default, else values)
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 5
    poc1_offsets: tuple = (4,)      # offset_for_ref_frame
    poc1_non_ref: int = 2
    poc1_t2b: int = 0
    bottom_poc: bool = False        # bottom_field_pic_order_in_frame_present_flag
    max_refs: int = 3
    vui: object = None              # None or dict(matrix=, full_range=, reorder=, hrd=)
    qp: int = 28
    qp_range: tuple = (12, 44)
    chroma_qp_offset: int = 0
    second_chroma_qp_offset: int = 0
    constrained_intra: bool = False
    weighted: bool = False
    deblock_control: bool = True
    filter_idcs: tuple = (0, 0, 1, 2)   # disable_deblocking_filter_idc drawn from
    num_ref_default: int = 1
    # per picture
    p_idr: float = 0.0
    p_intra_pic: float = 0.0
    p_nonref: float = 0.0
    p_mmco: float = 0.0
    p_modify: float = 0.0
    max_slices: int = 3
    reorder: bool = False           # decode non-reference pictures after the next one
    # B pictures (b_frames 0: none): runs of up to b_frames B pictures between
    # anchor pictures, each run coded after the anchor that follows it
    b_frames: int = 0
    b_full_runs: bool = False       # every run is b_frames long (as the frames allow)
    b_pyramid: bool = False         # the middle B of a run of 2 or more is a reference
    direct_spatial: object = True   # direct_spatial_mv_pred_flag; None: drawn per slice
    weighted_bipred: int = 0        # weighted_bipred_idc
    direct_8x8_inference: bool = True
    num_ref_l1_default: int = 1
    p_b_slice_mix: float = 0.0      # a slice of a B picture coded as P or I
    p_b_anchor: float = 0.0         # a slice of an anchor picture coded as B
    p_direct: float = 0.15          # B_Direct_16x16 among a B slice's inter MBs
    row_repeat: bool = False        # one slice a macroblock row, every row coded alike
    # parameter-set fields only the refusal streams (:func:`header_only`) change
    chroma_format: int = 1
    bit_depth: int = 8
    bypass: bool = False            # qpprime_y_zero_transform_bypass_flag
    slice_groups: int = 1
    # interlace (frame_mbs_only False): each frame coded as a frame (with
    # probability 1 - field_pics; x264's fake-interlaced form) or as two
    # fields, the bottom one first with probability p_bottom_first; a
    # non-reference field left unpaired with probability p_lone (its frame
    # then coded as one field); mb_adaptive_frame_field_flag (mbaff): each
    # frame picture then of macroblock pairs, each pair field-coded with
    # probability p_field_mb
    frame_mbs_only: bool = True
    mbaff: bool = False
    p_field_mb: float = 0.5
    idr_fields: bool = False        # every IDR frame coded as two fields
    field_pics: float = 0.0
    p_bottom_first: float = 0.0
    p_lone: float = 0.0
    # the temporal-direct twins (mixed_lists 1 and 2): a reference P
    # picture of two slices whose list 0 orders differ (1), or the same
    # pictures with the first slice's list made the second's and its
    # ref_idx remapped (2); their vectors drawn without regard to the
    # predictions, no P_Skip
    mixed_lists: int = 0
    # CAVLC (entropy_coding_mode_flag 0) from the same draws as CABAC, and
    # what only it codes: P_8x8ref0 and an 8x8-transform block whose cbp
    # bit is 1 and whose four 4x4 parses are empty
    cavlc: bool = False
    p_8x8ref0: float = 0.0
    p_empty8x8: float = 0.0
    # per macroblock
    p_skip: float = 0.2
    p_intra_in_p: float = 0.15
    p_pcm: float = 0.04
    p_i16: float = 0.3
    p_i8: float = 0.35
    p_qpd: float = 0.3
    p_far_mv: float = 0.05
    max_level: int = 40
    level_bound: int = 2000         # of a dequantized coefficient; a block's sum 1.5 times it
    seed: int = 0


@dataclass
class MB:
    slice: int
    fld: int = 0                # mb_field_decoding_flag (an MBAFF frame's field MB)
    kind: str = "skip"          # skip, P, I4, I8, I16, PCM
    subs: tuple = ()
    cbpl: int = 0
    cbpc: int = 0
    cmode: int = 0
    t8: int = 0
    i16mode: int = 0
    qpd: int = 0
    ipm: list = field(default_factory=lambda: [2] * 16)
    cbf: list = field(default_factory=lambda: [0] * 16)
    cbf_dc: int = 0
    cbfc_dc: list = field(default_factory=lambda: [0, 0])
    cbfc: list = field(default_factory=lambda: [[0] * 4, [0] * 4])
    ref: list = field(default_factory=lambda: [-1] * 16)
    mv: list = field(default_factory=lambda: [(0, 0)] * 16)
    mvd: list = field(default_factory=lambda: [(0, 0)] * 16)
    # list 1, and the 4x4 blocks predicted in direct mode (B slices)
    ref1: list = field(default_factory=lambda: [-1] * 16)
    mv1: list = field(default_factory=lambda: [(0, 0)] * 16)
    mvd1: list = field(default_factory=lambda: [(0, 0)] * 16)
    direct: list = field(default_factory=lambda: [0] * 16)
    # CAVLC: TotalCoeff of each luma 4x4 block (raster) and chroma AC block
    tc: list = field(default_factory=lambda: [0] * 16)
    tcc: list = field(default_factory=lambda: [[0] * 4, [0] * 4])

    def motion(self, lst):
        """(ref, mv, mvd) of list ``lst``."""
        return (self.ref, self.mv, self.mvd) if lst == 0 else (self.ref1, self.mv1, self.mvd1)

    @property
    def intra(self):
        return self.kind in ("I4", "I8", "I16", "PCM")


def _scaling_list(b, values, size):
    """§7.3.2.1.1.1: ``values`` in zigzag order, or "default"."""
    last = 8
    if values == "default":
        b.se(-8)
        return
    # stop early where the tail repeats
    end = size
    while end > 1 and values[end - 1] == values[end - 2]:
        end -= 1
    for j in range(size):
        if j == end:
            b.se((0 - last + 128) % 256 - 128)
            return
        d = (values[j] - last + 128) % 256 - 128
        b.se(d)
        last = values[j]


def _scaling_lists(b, lists, n):
    for i in range(n):
        present = lists[i] is not None
        b.u(1, present)
        if present:
            _scaling_list(b, lists[i], 16 if i < 6 else 64)


class Writer:
    """Draws and writes one stream (:meth:`write` → access units)."""

    def __init__(self, cfg: Config):
        self.c = cfg
        self.rng = np.random.default_rng(cfg.seed)
        cw, ch = cfg.width + cfg.crop[0] + cfg.crop[1], cfg.height + cfg.crop[2] + cfg.crop[3]
        self.mbw, self.mbh = -(-cw // 16), -(-ch // 16)
        if not cfg.frame_mbs_only:
            self.mbh += self.mbh % 2         # frame height in MB pairs
        self.frame_mbh = self.mbh
        # the crop brings the coded size to whole macroblocks: extra goes right/bottom
        self.crop = (cfg.crop[0], self.mbw * 16 - cfg.width - cfg.crop[0],
                     cfg.crop[2], self.mbh * 16 - cfg.height - cfg.crop[2])
        self.max_frame_num = 1 << cfg.log2_max_frame_num
        self.max_poc_lsb = 1 << cfg.log2_max_poc_lsb
        self.cavlc = cfg.cavlc

    # ------------------------------------------------------- parameter sets
    def sps(self):
        c, b = self.c, Bits()
        b.u(8, c.profile)
        b.u(8, 0)
        b.u(8, c.level)
        b.ue(0)
        if c.profile in (100, 110, 122, 244):
            b.ue(c.chroma_format)
            if c.chroma_format == 3:
                b.u(1, 0)        # separate_colour_plane_flag
            b.ue(c.bit_depth - 8)
            b.ue(c.bit_depth - 8)
            b.u(1, c.bypass)
            b.u(1, c.sps_scaling is not None)
            if c.sps_scaling is not None:
                _scaling_lists(b, c.sps_scaling, 8)
        b.ue(c.log2_max_frame_num - 4)
        b.ue(c.poc_type)
        if c.poc_type == 0:
            b.ue(c.log2_max_poc_lsb - 4)
        elif c.poc_type == 1:
            b.u(1, 0)            # delta_pic_order_always_zero_flag
            b.se(c.poc1_non_ref)
            b.se(c.poc1_t2b)
            b.ue(len(c.poc1_offsets))
            for o in c.poc1_offsets:
                b.se(o)
        b.ue(c.max_refs)
        b.u(1, 0)                # gaps_in_frame_num_value_allowed_flag
        b.ue(self.mbw - 1)
        b.ue(self.mbh // (1 if c.frame_mbs_only else 2) - 1)
        b.u(1, c.frame_mbs_only)
        if not c.frame_mbs_only:
            b.u(1, c.mbaff)      # mb_adaptive_frame_field_flag
        b.u(1, c.direct_8x8_inference)
        crop = any(self.crop)
        b.u(1, crop)
        if crop:
            unit_y = 2 if c.frame_mbs_only else 4     # CropUnitY
            assert all(v % unit_y == 0 for v in self.crop[2:]), self.crop
            for k, v in enumerate(self.crop):
                b.ue(v // (2 if k < 2 else unit_y))
        b.u(1, c.vui is not None)
        if c.vui is not None:
            self._vui(b, c.vui)
        b.trailing()
        return nal(3, 7, b.tobytes())

    def _vui(self, b, v):
        b.u(1, 1)                # aspect_ratio_info_present_flag
        b.u(8, 255)              # Extended_SAR
        b.u(16, 1)
        b.u(16, 1)
        b.u(1, 0)                # overscan_info_present_flag
        signal = "matrix" in v or "full_range" in v
        b.u(1, signal)
        if signal:
            b.u(3, 5)
            b.u(1, v.get("full_range", 0))
            b.u(1, "matrix" in v)
            if "matrix" in v:
                b.u(8, v["matrix"])
                b.u(8, v["matrix"])
                b.u(8, v["matrix"])
        b.u(1, 1)                # chroma_loc_info_present_flag
        b.ue(0)
        b.ue(0)
        b.u(1, 1)                # timing_info_present_flag
        b.u(32, 1)
        b.u(32, 60)
        b.u(1, 1)
        hrd = v.get("hrd", False)
        for _ in range(2):       # nal and vcl HRD
            b.u(1, hrd)
            if hrd:
                b.ue(1)          # cpb_cnt_minus1
                b.u(4, 2)
                b.u(4, 3)
                for k in range(2):
                    b.ue(1000 + k)
                    b.ue(2000 + k)
                    b.u(1, k)
                for _ in range(4):
                    b.u(5, 23)
        if hrd:
            b.u(1, 0)            # low_delay_hrd_flag
        b.u(1, 0)                # pic_struct_present_flag
        reorder = v.get("reorder")
        b.u(1, reorder is not None)
        if reorder is not None:
            b.u(1, 1)
            b.ue(2)
            b.ue(1)
            b.ue(16)
            b.ue(16)
            b.ue(reorder)
            b.ue(max(reorder, self.c.max_refs))

    def pps(self):
        c, b = self.c, Bits()
        b.ue(0)
        b.ue(0)
        b.u(1, not c.cavlc)      # entropy_coding_mode_flag
        b.u(1, c.bottom_poc)
        b.ue(c.slice_groups - 1)
        if c.slice_groups > 1:
            b.ue(0)              # slice_group_map_type 0: interleaved runs
            for _ in range(c.slice_groups):
                b.ue(0)
        b.ue(c.num_ref_default - 1)
        b.ue(c.num_ref_l1_default - 1)
        b.u(1, c.weighted)
        b.u(2, c.weighted_bipred)
        b.se(c.qp - 26)
        b.se(0)
        b.se(c.chroma_qp_offset)
        b.u(1, c.deblock_control)
        b.u(1, c.constrained_intra)
        b.u(1, 0)                # redundant_pic_cnt_present_flag
        if c.profile in (100, 110, 122, 244) and (
                c.transform8x8 or c.pps_scaling is not None
                or c.second_chroma_qp_offset != c.chroma_qp_offset):
            b.u(1, c.transform8x8)
            b.u(1, c.pps_scaling is not None)
            if c.pps_scaling is not None:
                _scaling_lists(b, c.pps_scaling, 6 + 2 * c.transform8x8)
            b.se(c.second_chroma_qp_offset)
        b.trailing()
        return nal(3, 8, b.tobytes())

    # ------------------------------------------------------------- weights
    def _level_scales(self):
        """Per list (Y intra, Cb intra, Cr intra, Y inter, ...; then 8x8 Y
        intra, Y inter) the largest weight in use, for the writer's bound on
        dequantized coefficients."""
        flat4, flat8 = [16] * 16, [16] * 64

        def resolve(lists, fallback, n):
            out = []
            for i in range(n):
                v = lists[i] if lists is not None else None
                if v == "default":
                    v = DEFAULT4[i // 3] if i < 6 else DEFAULT8[i - 6]
                if v is None:
                    v = fallback(i, out)
                out.append(v)
            return out

        seq_fb = lambda i, out: (DEFAULT4[i // 3] if i in (0, 3) else DEFAULT8[i - 6]
                                 if i >= 6 else out[i - 1])
        c = self.c
        if c.sps_scaling is None:
            seq = [flat4] * 6 + [flat8] * 2
        else:
            seq = resolve(c.sps_scaling, seq_fb, 8)
        if c.pps_scaling is None:
            pic = seq
        else:
            fb = (lambda i, out: seq[i] if i in (0, 3, 6, 7) else out[i - 1]) \
                if c.sps_scaling is not None else seq_fb
            pic = resolve(c.pps_scaling, fb, 8)
        return [max(v) for v in pic]

    # -------------------------------------------------------------- stream
    def write(self):
        """Returns ``(sps, pps, access_units)``, each access unit a list of
        NAL units (without start codes; a frame coded as two fields is one
        access unit of both)."""
        self.weights = self._level_scales()
        self.contexts = {}          # init table (0 I, 1 + cabac_init_idc) -> ctxIdx coded
        self.tables = set()         # CAVLC: the (table, class) pairs coded
        # what only some streams code: CAVLC's P_8x8ref0 and empty 8x8
        # parses, field pairs, unpaired fields, and B pictures whose
        # co-located picture is coded in the other structure (a frame's
        # co-located field pair, a field's co-located frame), MBAFF frames,
        # their field and frame MBs, and the B slices of an MBAFF frame
        # whose co-located picture is an MBAFF frame or a field pair, and of
        # a field whose co-located picture is an MBAFF frame
        self.counts = {"8x8ref0": 0, "empty8x8": 0, "field_pairs": 0, "lone": 0,
                       "fld_to_frm": 0, "frm_to_fld": 0, "mbaff_frames": 0, "field_mbs": 0,
                       "frame_mbs": 0, "mbaff_from_mbaff": 0, "mbaff_from_fields": 0,
                       "fields_from_mbaff": 0}
        self.refs = []              # frame stores with a field marked as reference (_picture)
        self.max_long = None        # MaxLongTermFrameIdx (None: no long-term indices)
        self.prev_ref_frame_num = 0
        self.idr_id = -1
        self.uniform = False
        self.field, self.par, self.aff = False, 2, False
        self.mixed, self.remap = False, None
        if self.c.b_frames:
            return self.sps(), self.pps(), self._write_b()
        aus, last_nonref = [], False
        for i in range(self.c.frames):
            idr = i == 0 or self.rng.random() < self.c.p_idr
            # two non-reference pictures in a row would share a POC
            nonref = not idr and not last_nonref and self.rng.random() < self.c.p_nonref
            # a reordered picture may not go back before an IDR or MMCO 5 one
            nonref = nonref and not (self.c.reorder and self.top_poc < 4)
            last_nonref = nonref
            aus.append(self._picture(idr, nonref))
        return self.sps(), self.pps(), aus

    def _write_b(self):
        """Access units of anchors (IDR, P or I pictures, some slices B) each
        followed by the run of B pictures that display before it; POCs count
        up by 2 in display order from each IDR picture."""
        c, rng = self.c, self.rng
        aus, disp = [self._picture(True, False, 0, "anchor")], 0
        while len(aus) < c.frames:
            idr = rng.random() < c.p_idr
            most = min(c.b_frames, c.frames - len(aus) - 1)
            run = 0 if idr else most if c.b_full_runs else int(rng.integers(0, most + 1))
            disp = 0 if idr else disp + run + 1
            aus.append(self._picture(idr, False, 2 * disp, "anchor"))
            order = list(range(1, run + 1))
            mid = (run + 1) // 2 if c.b_pyramid and run >= 2 else None
            if mid is not None:
                order = [mid] + [k for k in order if k != mid]
            for k in order:
                aus.append(self._picture(False, k != mid, 2 * (disp - run - 1 + k), "b"))
        return aus

    def _b_stype(self, role, intra_pic):
        """A slice type of a picture of a B stream: an anchor's P (or I, or
        B) and a B picture's B (or P, or I)."""
        c, rng = self.c, self.rng
        if intra_pic:
            return 2
        if role == "anchor":
            if rng.random() < 0.15:
                return 2
            b = 1 if rng.random() < c.p_b_anchor else 0
            # not the second field of a reference pair, whose list 1 starts
            # with its own first field (_b_slice_header)
            return 0 if self._own_first() else b
        if rng.random() < c.p_b_slice_mix:
            return int(rng.choice([0, 2]))
        return 1

    def _own_first(self):
        """Whether the current picture is the second field of a reference
        pair (its store's first field is marked)."""
        return self.field and any(self.store["marked"])

    def _picture(self, idr, nonref, poc=None, role=None):
        """A frame: one frame store, coded as a frame or, in an interlaced
        stream, as two fields (POCs ``poc`` and ``poc + 1``, either parity
        first; a non-reference one at times left unpaired). Returns the NAL
        units of its pictures. A store is a dict: frame_num, long
        (LongTermFrameIdx or None, the whole store's), fpoc (each field's
        POC or None), poc (the smaller) and marked (each field's marking as
        reference)."""
        c, rng = self.c, self.rng
        if idr:
            self.refs, self.max_long = [], None
            self.idr_id = (self.idr_id + 1) % 65536
            frame_num = 0
            self.top_poc = self.last_ref_poc = 0
        else:
            frame_num = (self.prev_ref_frame_num + 1) % self.max_frame_num
        self.cur_frame_num = frame_num
        ref_idc = 0 if nonref else int(rng.integers(1, 4))
        # POC type 0 counts up by 2, or by 4 with each reordered non-reference
        # picture between the last two reference ones
        if poc is None:
            if idr:
                poc = 0
            elif nonref and c.reorder:
                poc = self.last_ref_poc - 2
            else:
                poc = self.top_poc + (4 if c.reorder else 2)
                self.top_poc = poc
        if not nonref:
            self.last_ref_poc = poc
        pars = [2]
        fields = not c.frame_mbs_only and rng.random() < c.field_pics
        if fields or (idr and c.idr_fields):
            pars = [1, 0] if rng.random() < c.p_bottom_first else [0, 1]
            if nonref and role is None and rng.random() < c.p_lone:
                pars = pars[:1]
                self.counts["lone"] += 1
            else:
                self.counts["field_pairs"] += 1
        self.store = {"frame_num": frame_num, "long": None, "fpoc": [None, None], "poc": None,
                      "marked": [False, False], "fields": pars != [2],
                      "mbaff": pars == [2] and c.mbaff}
        nals = []
        for k, par in enumerate(pars):
            nals += self._coded(idr and k == 0, ref_idc, frame_num, par, poc + k, role)
        return nals

    def _coded(self, idr, ref_idc, frame_num, par, poc, role):
        """One coded picture of the current store: the frame (``par`` 2) or
        its field of parity ``par`` (0 top, 1 bottom); its slices, then its
        marking."""
        c, rng, st = self.c, self.rng, self.store
        self.field, self.par = par != 2, par
        self.aff = c.mbaff and par == 2           # a frame of macroblock pairs
        self.counts["mbaff_frames"] += self.aff
        self.mbh = self.frame_mbh // 2 if self.field else self.frame_mbh
        intra_pic = idr or rng.random() < c.p_intra_pic or not self.refs
        self.poc = poc
        self.delta_bottom = int(rng.integers(0, 3)) if c.bottom_poc and not self.field else 0
        if self.field:
            st["fpoc"][par] = poc
        else:
            st["fpoc"] = [poc, poc + self.delta_bottom]
        st["poc"] = min(v for v in st["fpoc"] if v is not None)
        # the second field of a reference pair
        paired = self.field and any(st["marked"])
        mmco = None
        if ref_idc and not idr:
            mmco = self._mmco_field(paired) if self.field else self._mmco()
        if (ref_idc and not idr and mmco is None and not paired
                and len(self.refs) >= max(c.max_refs, 1)
                and all(r["long"] is not None for r in self.refs)):
            # the sliding window needs a short-term picture to drop
            r = self.refs[0]
            mmco = [(2, r["long"])] if not self.field else \
                [(2, 2 * r["long"] + (f == par)) for f in (0, 1) if r["marked"][f]]
        n_mbs = self.mbw * self.mbh
        unit = 2 if self.aff else 1               # slices of whole pairs
        if c.row_repeat:
            starts = list(range(0, n_mbs, self.mbw * unit))
        else:
            n_units = n_mbs // unit
            n_slices = int(rng.integers(1, min(c.max_slices, n_units) + 1))
            starts = [0] + sorted(unit * int(v) for v in rng.choice(np.arange(1, n_units),
                                                                     n_slices - 1, replace=False))
        # the twins' reference P picture: two P slices (Config.mixed_lists)
        self.mixed = bool(c.mixed_lists and role == "anchor" and ref_idc and not intra_pic
                          and self._n_refs() >= 2)
        self.remap = None
        if self.mixed:
            starts = [0, n_mbs // (2 * unit) * unit]
        self.mbs = [None] * n_mbs
        # a reference picture of a stream that may predict in temporal direct
        # mode codes every slice alike (one slice type, the same lists):
        # libavcodec reads one set of co-located lists a picture
        self.uniform = role is not None and ref_idc != 0 and c.direct_spatial is not True
        nals = []
        for si, first in enumerate(starts):
            last = starts[si + 1] if si + 1 < len(starts) else n_mbs
            if role is not None:
                if si == 0 or not (c.row_repeat or self.uniform):
                    stype = self._b_stype(role, intra_pic)
            elif si == 0 or not c.row_repeat:
                stype = 2 if intra_pic or rng.random() < 0.15 else 0
            if self.mixed:
                stype = 0
            nals.append(self._slice(si, first, last, stype, idr, ref_idc, frame_num, mmco))
        if ref_idc:
            self._mark(idr, mmco, frame_num)
        self.mbh = self.frame_mbh
        self.mixed, self.remap, self.aff = False, None, False
        return nals

    # ------------------------------------------------------------ marking
    def _pic_num(self, r):
        """FrameNumWrap of store ``r``."""
        fn = r["frame_num"]
        return fn - self.max_frame_num if fn > self.cur_frame_num else fn

    def _field_pic_num(self, r, f):
        """PicNum of field ``f`` of short-term store ``r`` (8.2.4.1), or
        LongTermPicNum of a long-term one: twice the frame's number, plus 1
        for the current field's parity."""
        base = self._pic_num(r) if r["long"] is None else r["long"]
        return 2 * base + (f == self.par)

    def _mmco(self):
        """Draws an adaptive marking of a frame (a list of (op, args)) or
        None for the sliding window."""
        c, rng = self.c, self.rng
        if rng.random() >= c.p_mmco:
            return None
        ops = []
        refs = [dict(r) for r in self.refs]
        max_long = self.max_long
        if rng.random() < 0.08 and not c.b_frames:
            return [(5,)]
        for _ in range(int(rng.integers(1, 4))):
            if any(o[0] == 6 for o in ops):
                break                        # MMCO 6 goes last
            shorts = [r for r in refs if r["long"] is None]
            longs = [r for r in refs if r["long"] is not None]
            k = int(rng.choice([1, 2, 3, 4, 6]))
            if k == 1 and shorts:
                r = shorts[rng.integers(len(shorts))]
                ops.append((1, self.cur_frame_num - self._pic_num(r) - 1))
                refs.remove(r)
            elif k == 2 and longs:
                r = longs[rng.integers(len(longs))]
                ops.append((2, r["long"]))
                refs.remove(r)
            elif k == 3 and shorts and max_long is not None:
                r = shorts[rng.integers(len(shorts))]
                idx = int(rng.integers(0, max_long + 1))
                for o in [o for o in refs if o["long"] == idx]:
                    refs.remove(o)
                ops.append((3, self.cur_frame_num - self._pic_num(r) - 1, idx))
                r["long"] = idx
            elif k == 4:
                m = int(rng.integers(0, 3))
                ops.append((4, m))
                max_long = m - 1 if m else None
                refs = [r for r in refs if r["long"] is None
                        or (max_long is not None and r["long"] <= max_long)]
            elif k == 6 and max_long is not None:
                idx = int(rng.integers(0, max_long + 1))
                for o in [o for o in refs if o["long"] == idx]:
                    refs.remove(o)
                ops.append((6, idx))
        # keep room for the current picture (before an MMCO 6)
        tail = [o for o in ops if o[0] == 6]
        ops = [o for o in ops if o[0] != 6]
        while len(refs) + 1 > c.max_refs:
            shorts = [r for r in refs if r["long"] is None]
            if shorts:
                r = min(shorts, key=self._pic_num)
                ops.append((1, self.cur_frame_num - self._pic_num(r) - 1))
            else:
                r = refs[0]
                ops.append((2, r["long"]))
            refs.remove(r)
        return (ops + tail) or None

    def _mmco_field(self, paired):
        """Draws an adaptive marking of a field, in field picture numbers,
        or None for the sliding window. The second field of a reference pair
        marks none but, where its first field is long-term, itself at that
        index (MMCO 6, which libavcodec's MMCO_LONG takes to unmark the first
        field: it takes the store off the long-term list and puts it back
        with the current field alone). A store's two fields are unmarked or made long-term
        together (MMCO 3 always: libavcodec moves the whole store), except
        that MMCO 1 and 2 take single fields in a stream of P field pairs
        only; MMCO 6 (and a long-term IDR field) only in a stream of fields,
        where no frame picture meets the store it leaves half marked."""
        c, rng, st = self.c, self.rng, self.store
        if paired:
            return [(6, st["long"])] if st["long"] is not None else None
        if rng.random() >= c.p_mmco:
            return None
        single = c.field_pics >= 1 and not c.b_frames
        sim = [dict(r, marked=list(r["marked"]), src=r) for r in self.refs]
        cur_pn = 2 * self.cur_frame_num + 1
        max_long, ops = self.max_long, []

        def fields(r):
            fs = [f for f in (0, 1) if r["marked"][f]]
            return [fs[rng.integers(len(fs))]] if single else fs
        for _ in range(int(rng.integers(1, 4))):
            if any(o[0] == 6 for o in ops):
                break
            shorts = [r for r in sim if r["long"] is None]
            longs = [r for r in sim if r["long"] is not None]
            k = int(rng.choice([1, 2, 3, 4, 6]))
            if k == 1 and shorts:
                r = shorts[rng.integers(len(shorts))]
                for f in fields(r):
                    ops.append((1, cur_pn - self._field_pic_num(r, f) - 1))
                    r["marked"][f] = False
            elif k == 2 and longs:
                r = longs[rng.integers(len(longs))]
                for f in fields(r):
                    ops.append((2, self._field_pic_num(r, f)))
                    r["marked"][f] = False
            elif k == 3 and shorts and max_long is not None:
                r = shorts[rng.integers(len(shorts))]
                idx = int(rng.integers(0, max_long + 1))
                for o in sim:
                    if o["long"] == idx:
                        o["marked"] = [False, False]
                for f in (0, 1):
                    if r["marked"][f]:
                        ops.append((3, cur_pn - self._field_pic_num(r, f) - 1, idx))
                r["long"] = idx
            elif k == 4:
                m = int(rng.integers(0, 3))
                ops.append((4, m))
                max_long = m - 1 if m else None
                for o in sim:
                    if o["long"] is not None and (max_long is None or o["long"] > max_long):
                        o["marked"] = [False, False]
            elif k == 6 and max_long is not None and c.field_pics >= 1:
                idx = int(rng.integers(0, max_long + 1))
                for o in sim:
                    if o["long"] == idx:
                        o["marked"] = [False, False]
                ops.append((6, idx))
            sim = [r for r in sim if any(r["marked"])]
        tail = [o for o in ops if o[0] == 6]
        ops = [o for o in ops if o[0] != 6]
        while len(sim) + 1 > c.max_refs:
            shorts = [r for r in sim if r["long"] is None]
            r = min(shorts, key=self._pic_num) if shorts else sim[0]
            for f in (0, 1):
                if r["marked"][f]:
                    ops.append((1, cur_pn - self._field_pic_num(r, f) - 1) if shorts
                               else (2, self._field_pic_num(r, f)))
            sim.remove(r)
        return (ops + tail) or None

    def _mark(self, idr, mmco, frame_num):
        """8.2.5 on the stores: the current frame (both fields) or field."""
        c, st = self.c, self.store
        pars = [self.par] if self.field else [0, 1]
        paired = self.field and any(st["marked"])

        def keep(refs):
            return [r for r in refs if any(r["marked"])]

        def store_of_short(pn):
            if not self.field:
                return next(((r, None) for r in self.refs if r["long"] is None
                             and self._pic_num(r) == pn), (None, None))
            f = self.par if pn & 1 else 1 - self.par
            fn = (pn >> 1) % self.max_frame_num
            return next(((r, f) for r in self.refs if r["long"] is None
                         and r["frame_num"] == fn), (None, None))
        if idr:
            if self.idr_long:
                st["long"] = 0
                self.max_long = 0
            for f in pars:
                st["marked"][f] = True
            self.refs = [st]
            self.prev_ref_frame_num = frame_num
            return
        if mmco is None:
            if not paired and len(self.refs) >= max(c.max_refs, 1):
                shorts = [r for r in self.refs if r["long"] is None]
                oldest = min(shorts, key=self._pic_num)
                self.refs = [r for r in self.refs if r is not oldest]
        else:
            cur_pn = 2 * frame_num + 1 if self.field else frame_num
            max_pn = self.max_frame_num * (2 if self.field else 1)
            for op in mmco:
                if op[0] in (1, 3):
                    r, f = store_of_short((cur_pn - (op[1] + 1)) % max_pn
                                          if self.field else cur_pn - (op[1] + 1))
                    if op[0] == 1:
                        for g in ((0, 1) if f is None else (f,)):
                            r["marked"][g] = False
                    elif r is not None:     # (a second MMCO 3 finds its store long-term)
                        for o in self.refs:
                            if o["long"] == op[2] and o is not r:
                                o["marked"] = [False, False]
                        r["long"] = op[2]
                elif op[0] == 2:
                    if not self.field:
                        for o in self.refs:
                            if o["long"] == op[1]:
                                o["marked"] = [False, False]
                    else:
                        f = self.par if op[1] & 1 else 1 - self.par
                        for o in self.refs:
                            if o["long"] == op[1] >> 1:
                                o["marked"][f] = False
                elif op[0] == 4:
                    self.max_long = op[1] - 1 if op[1] else None
                    for o in self.refs:
                        if o["long"] is not None and (self.max_long is None
                                                      or o["long"] > self.max_long):
                            o["marked"] = [False, False]
                elif op[0] == 5:
                    for o in self.refs:
                        o["marked"] = [False, False]
                    self.max_long = None
                elif op[0] == 6:
                    if paired:
                        # libavcodec's MMCO_LONG drops the long-term first
                        # field of the current store (_mmco_field)
                        st["marked"][1 - self.par] = False
                    for o in self.refs:
                        if o["long"] == op[1] and o is not st:
                            o["marked"] = [False, False]
                    st["long"] = op[1]
                self.refs = keep(self.refs)
        if mmco and any(op[0] == 5 for op in mmco):
            st["frame_num"] = 0
            frame_num = 0
            self.top_poc = self.last_ref_poc = 0
        for f in pars:
            st["marked"][f] = True
        if not any(r is st for r in self.refs):
            self.refs.append(st)
        self.prev_ref_frame_num = frame_num

    # -------------------------------------------------------------- lists
    def _field_views(self, stores):
        """8.2.4.2.5: the fields of ``stores`` as (store, parity),
        alternately of the current parity and the other, each side skipping
        stores without such a marked field."""
        same, opp = self.par, 1 - self.par
        out, i0, i1, n = [], 0, 0, len(stores)
        while i0 < n or i1 < n:
            while i0 < n and not stores[i0]["marked"][same]:
                i0 += 1
            while i1 < n and not stores[i1]["marked"][opp]:
                i1 += 1
            if i0 < n:
                out.append((stores[i0], same))
                i0 += 1
            if i1 < n:
                out.append((stores[i1], opp))
                i1 += 1
        return out

    def _views(self, stores):
        """The reference pictures of ``stores``: frames (stores with both
        fields marked) or, in a field, fields."""
        if self.field:
            return self._field_views(stores)
        return [r for r in stores if all(r["marked"])]

    def _n_refs(self):
        """How many reference pictures the current picture has."""
        if self.field:
            return sum(sum(r["marked"]) for r in self.refs)
        return len(self._views(self.refs))

    @staticmethod
    def _same(a, b):
        if a is None or b is None:
            return False
        if isinstance(a, tuple):
            return a[0] is b[0] and a[1] == b[1]
        return a is b

    def _ref_list(self, nref, mods, init=None):
        """List 0 of a P slice (or the list ``init`` of a B slice) at
        ``nref`` entries after the modifications ``mods``, in picture
        numbers of frames or of fields."""
        if init is None:
            shorts = sorted([r for r in self.refs if r["long"] is None], key=self._pic_num,
                            reverse=True)
            longs = sorted([r for r in self.refs if r["long"] is not None],
                           key=lambda r: r["long"])
            init = self._views(shorts) + self._views(longs)
        lst = init[:nref]
        lst += [None] * (nref - len(lst))
        max_pn = self.max_frame_num * (2 if self.field else 1)
        pred = 2 * self.cur_frame_num + 1 if self.field else self.cur_frame_num
        for i, (idc, v) in enumerate(mods):
            if idc == 2:
                if self.field:
                    f = self.par if v & 1 else 1 - self.par
                    pic = next((r, f) for r in self.refs if r["long"] == v >> 1 and r["marked"][f])
                else:
                    pic = next(r for r in self.refs if r["long"] == v)
            else:
                d = v + 1
                nw = pred - d if idc == 0 else pred + d
                nw %= max_pn
                pred = nw
                if self.field:
                    f = self.par if nw & 1 else 1 - self.par
                    fn = nw >> 1
                    pic = next((r, f) for r in self.refs
                               if r["long"] is None and r["frame_num"] == fn and r["marked"][f])
                else:
                    pn = nw - self.max_frame_num if nw > self.cur_frame_num else nw
                    pic = next(r for r in self.refs
                               if r["long"] is None and self._pic_num(r) == pn)
            lst = lst[:i] + [pic] + [r for r in lst[i:] if not self._same(r, pic)]
            lst = lst[:nref]
        return lst

    def _b_lists(self, n0, n1, mods0, mods1):
        """§8.2.4.2.3-4: the lists of a B slice by POC (of the current frame
        or field, and of each store the smaller of its fields'), list 1 with
        its first two entries swapped where it equals list 0 store for
        store, then truncated and modified."""
        shorts = [r for r in self.refs if r["long"] is None]
        longs = sorted([r for r in self.refs if r["long"] is not None], key=lambda r: r["long"])
        before = sorted([r for r in shorts if r["poc"] <= self.poc], key=lambda r: -r["poc"])
        after = sorted([r for r in shorts if r["poc"] > self.poc], key=lambda r: r["poc"])
        l0 = self._views(before + after) + self._views(longs)
        l1 = self._views(after + before) + self._views(longs)
        store = (lambda v: v[0]) if self.field else (lambda v: v)
        if len(l1) > 1 and len(l0) == len(l1) and all(store(a) is store(b)
                                                      for a, b in zip(l0, l1)):
            l1[0], l1[1] = l1[1], l1[0]
        return self._ref_list(n0, mods0, l0), self._ref_list(n1, mods1, l1)

    def _draw_mods(self, nref):
        rng = self.rng
        if rng.random() >= self.c.p_modify:
            return []
        if self.field:
            pool = [(r, f) for r in self.refs for f in (0, 1) if r["marked"][f]]
            picks = [pool[rng.integers(len(pool))] for _ in range(int(rng.integers(1, nref + 1)))]
        else:
            picks = [self.refs[rng.integers(len(self.refs))]
                     for _ in range(int(rng.integers(1, nref + 1)))]
        return self._mods_for(picks)

    def _mods_for(self, picks):
        """The ref_pic_list_modification operations that name the reference
        pictures ``picks`` (stores, or (store, parity) in a field) in turn."""
        mods, pred = [], self.cur_frame_num
        if self.field:
            pred = 2 * self.cur_frame_num + 1
        max_pn = self.max_frame_num * (2 if self.field else 1)
        for pick in picks:
            if self.field:
                r, f = pick
                num = self._field_pic_num(r, f)
            else:
                r = pick
                num = r["long"] if r["long"] is not None else self._pic_num(r)
            if r["long"] is not None:
                mods.append((2, num))
                continue
            nw = num % max_pn
            if nw < pred:
                mods.append((0, pred - nw - 1))
            elif nw > pred:
                mods.append((1, nw - pred - 1))
            else:
                mods.append((0, max_pn - 1))      # wraps back to pred
            pred = nw
        return mods

    # --------------------------------------------------------------- slice
    def _slice(self, si, first, last, stype, idr, ref_idc, frame_num, mmco):
        c, rng = self.c, self.rng
        b = Bits()
        b.ue(first // 2 if self.aff else first)   # an MBAFF frame counts pairs
        if c.row_repeat and si > 0:
            # a slice's data depends on no other slice: the first row's header
            # (less first_mb_in_slice) and data, which under CABAC start
            # byte-aligned
            b.bits += self._row_header
            if self.cavlc:
                return nal(ref_idc, 5 if idr else 1, self._row_tail(b))
            while len(b.bits) % 8:
                b.bits.append(1)
            return nal(ref_idc, 5 if idr else 1, b.tobytes() + self._row_data)
        b.ue(stype)
        b.ue(0)
        b.u(c.log2_max_frame_num, frame_num)
        if not c.frame_mbs_only:
            b.u(1, self.field)   # field_pic_flag
            if self.field:
                b.u(1, self.par)     # bottom_field_flag
        if idr:
            b.ue(self.idr_id)
        if c.poc_type == 0:
            b.u(c.log2_max_poc_lsb, self.poc % self.max_poc_lsb)
            if c.bottom_poc and not self.field:
                b.se(self.delta_bottom)
        elif c.poc_type == 1:
            b.se(0)
            if c.bottom_poc and not self.field:
                b.se(self.delta_bottom)
        self.list0 = []
        if stype == 1:
            self._b_slice_header(b, si)
        elif stype == 0:
            if (self.uniform or self.mixed) and si > 0:
                nref, override, mods = self._uniform_lists
                self.remap = None
            else:
                nrefs = self._n_refs()
                nref = int(rng.integers(1, min(nrefs, 4) + 1))
                override = nref != c.num_ref_default or rng.random() < 0.2
                if not override:
                    nref = c.num_ref_default
                if self.mixed:
                    # slice 0 on the initial list, slice 1 on it reversed; the
                    # twin codes slice 0 on slice 1's list, its ref_idx
                    # remapped to the same pictures
                    nref, override = max(nref, 2), True
                    init = self._ref_list(nref, [])
                    mods = self._mods_for(init[::-1])
                    self._uniform_lists = (nref, override, mods)
                    if c.mixed_lists == 1:
                        mods = []
                    else:
                        self.remap = {i: nref - 1 - i for i in range(nref)}
                else:
                    mods = self._draw_mods(nref)
                    self._uniform_lists = (nref, override, mods)
            b.u(1, override)
            if override:
                b.ue(nref - 1)
            b.u(1, bool(mods))
            for idc, v in mods:
                b.ue(idc)
                b.ue(v)
            if mods:
                b.ue(3)
            self.list0 = self._ref_list(nref, mods)
            self.nref = nref
            if c.weighted:
                self._weight_table(b, [nref])
        if ref_idc:
            if idr:
                if si == 0:
                    self.idr_long = self.rng.random() < 0.3 and self.c.p_mmco > 0
                    self.idr_long &= not self.field or self.c.field_pics >= 1
                b.u(1, 0)
                b.u(1, self.idr_long)
            else:
                b.u(1, mmco is not None)
                if mmco is not None:
                    for op in mmco:
                        b.ue(op[0])
                        for a in op[1:]:
                            b.ue(a)
                    b.ue(0)
        cabac_init_idc = int(rng.integers(0, 3)) if stype != 2 else 0
        if stype != 2 and not self.cavlc:
            b.ue(cabac_init_idc)
        lo, hi = c.qp_range
        slice_qp = int(rng.integers(lo, hi + 1))
        b.se(slice_qp - c.qp)
        if c.deblock_control:
            idc = int(rng.choice(c.filter_idcs))
            b.ue(idc)
            if idc != 1:
                b.se(int(rng.integers(-6, 7)))
                b.se(int(rng.integers(-6, 7)))
        header_end = len(b.bits)
        self.qp, self.stype, self.bits, self.enc = slice_qp, stype, b, None
        self.prev_mb = None
        if self.cavlc:
            # the data follows the header unaligned; a run of skipped MBs
            # before each coded one (P and B slices) may end the slice
            self.skip_run, self.pcm_pads = 0, []
            for addr in range(first, last, 2 if self.aff else 1):
                if self.aff:
                    self._pair(si, addr)
                else:
                    self._macroblock(si, addr)
            if self.skip_run:
                b.ue(self.skip_run)
            data_end = len(b.bits)
            b.trailing()
            if c.row_repeat:
                # the row's data without the I_PCM alignment bits, which
                # depend on where the data starts, and where they went
                self._row_header = b.bits[1:header_end]
                data, pads, at = [], [], header_end
                for start, n in self.pcm_pads:
                    data += b.bits[at:start]
                    pads.append(len(data))
                    at = start + n
                data += b.bits[at:data_end]
                self._row_data, self._row_pads, self._row_packed = data, pads, {}
            return nal(ref_idc, 5 if idr else 1, b.tobytes())
        while len(b.bits) % 8:
            b.bits.append(1)     # cabac_alignment_one_bit
        data_start = len(b.bits) // 8
        table = 0 if stype == 2 else 1 + cabac_init_idc
        enc = CabacEncoder(b)
        enc.init_contexts(CABAC_INIT[table], slice_qp, self.contexts.setdefault(table, set()))
        self.enc = enc
        for addr in range(first, last, 2 if self.aff else 1):
            if self.aff:     # end_of_slice_flag after each pair
                self._pair(si, addr)
                enc.terminate(1 if addr == last - 2 else 0)
                continue
            self._macroblock(si, addr)
            enc.terminate(1 if addr == last - 1 else 0)
        # the terminate's last bit was rbsp_stop_one_bit
        while len(b.bits) % 8:
            b.bits.append(0)
        if c.row_repeat:
            self._row_header = b.bits[1:header_end]      # after ue(0)
            self._row_data = b.tobytes()[data_start:]
        return nal(ref_idc, 5 if idr else 1, b.tobytes())

    def _row_tail(self, b):
        """A CAVLC slice of the repeated row: the header in ``b``, then the
        first row's data, which follows it unaligned (packed once for each
        bit offset), and the trailing bits."""
        off = len(b.bits) % 8
        if off not in self._row_packed:
            bits, at = [0] * off, 0
            for pad in self._row_pads:
                bits += self._row_data[at:pad]
                bits += [0] * (-len(bits) % 8)       # pcm_alignment_zero_bit
                at = pad
            bits += self._row_data[at:] + [1]
            bits += [0] * (-len(bits) % 8)
            self._row_packed[off] = np.packbits(np.array(bits, np.uint8))
        data = self._row_packed[off].copy()
        if off:
            data[0] |= np.packbits(np.array(b.bits[-off:], np.uint8))[0]
        head = np.packbits(np.array(b.bits[:len(b.bits) - off], np.uint8))
        return head.tobytes() + data.tobytes()

    def _weight_table(self, b, nrefs):
        """pred_weight_table over lists of ``nrefs`` entries. Two lists (a B
        slice) keep every sum of an entry's weight in list 0 and one in list
        1 within [-128, 128] below a denominator of 2^7, as §7.4.3.2 requires
        (libavcodec's x86 bi-prediction saturates 16-bit sums beyond it)."""
        rng = self.rng
        top = 8 if len(nrefs) == 1 else 7
        lim = 127 if len(nrefs) == 1 else 64
        ld, cd = int(rng.integers(0, top)), int(rng.integers(0, top))
        b.ue(ld)
        b.ue(cd)
        for nref in nrefs:
            for _ in range(nref):
                f = rng.random() < 0.7
                b.u(1, f)
                if f:
                    b.se(int(rng.integers(-lim - (lim == 127), lim + 1)) if rng.random() < 0.2
                         else min(lim, (1 << ld) + int(rng.integers(-3, 4))))
                    b.se(int(rng.integers(-128, 128)) if rng.random() < 0.2
                         else int(rng.integers(-10, 11)))
                f = rng.random() < 0.6
                b.u(1, f)
                if f:
                    for _ in range(2):
                        b.se(min(lim, (1 << cd) + int(rng.integers(-4, 5))))
                        b.se(int(rng.integers(-20, 21)))

    def _b_slice_header(self, b, si):
        """A B slice's direct_spatial_mv_pred_flag, list sizes and
        modifications (the same in every slice of a uniform picture) and,
        under weighted_bipred_idc 1, its weights."""
        c, rng = self.c, self.rng
        spatial = c.direct_spatial if c.direct_spatial is not None else bool(rng.random() < 0.5)
        b.u(1, spatial)
        if self.uniform and si > 0:
            n, override, mods = self._uniform_lists
        else:
            nrefs = self._n_refs()
            n = [int(rng.integers(1, min(nrefs, 4) + 1)) for _ in range(2)]
            override = (n[0] != c.num_ref_default or n[1] != c.num_ref_l1_default
                        or rng.random() < 0.2)
            if not override:
                n = [c.num_ref_default, c.num_ref_l1_default]
            mods = [self._draw_mods(n[0]), self._draw_mods(n[1])]
            if self._own_first() and self._b_lists(*n, *mods)[1][0][0] is self.store:
                # libavcodec would read the co-located macroblocks of a
                # field's own first field from the current field's rows of
                # its store, not yet written
                mods[1] = []
            self._uniform_lists = (n, override, mods)
        b.u(1, override)
        if override:
            b.ue(n[0] - 1)
            b.ue(n[1] - 1)
        for m in mods:
            b.u(1, bool(m))
            for idc, v in m:
                b.ue(idc)
                b.ue(v)
            if m:
                b.ue(3)
        self.lists = list(self._b_lists(n[0], n[1], mods[0], mods[1]))
        assert not (self._own_first() and self.lists[1][0][0] is self.store)
        col = self.lists[1][0][0] if self.field else self.lists[1][0]
        if col["fields"] != self.field:
            self.counts["frm_to_fld" if self.field else "fld_to_frm"] += 1
        if self.aff:
            self.counts["mbaff_from_fields" if col["fields"] else "mbaff_from_mbaff"] += \
                col["fields"] or col["mbaff"]
        elif self.field and col["mbaff"]:
            self.counts["fields_from_mbaff"] += 1
        self.nrefs = n
        if c.weighted_bipred == 1:
            self._weight_table(b, n)

    # ----------------------------------------------------------- neighbours
    def _aff_nb(self, addr, xN, yN, maxW=16, maxH=16):
        """§6.4.12.2 (Table 6-4), in an MBAFF frame: ``(MB, xW, yW)`` of the
        sample (xN, yN) relative to MB ``addr`` in its own lines, of a block
        ``maxW`` x ``maxH`` (16 luma, 8 chroma), or None where it is not
        available."""
        cur = self.mbs[addr]
        if 0 <= xN < maxW and 0 <= yN < maxH:
            return cur, xN, yN
        if yN >= maxH or (xN >= maxW and yN >= 0):
            return None
        p = addr // 2
        px, prow = p % self.mbw, p // self.mbw
        top, frame = addr % 2 == 0, not cur.fld

        def pair(dx, dy):
            x, y = px + dx, prow + dy
            if x < 0 or x >= self.mbw or y < 0:
                return None
            a = 2 * (y * self.mbw + x)
            m = self.mbs[a]
            return a if m is not None and m.slice == cur.slice else None
        n, yM = None, yN
        if yN < 0:
            X = pair(-1, -1) if xN < 0 else pair(0, -1) if xN < maxW else pair(1, -1)
            if frame and not top:
                if xN < 0:
                    X = pair(-1, 0)
                    if X is not None and self.mbs[X].fld:
                        n, yM = X + 1, (yN + maxH) >> 1
                    else:
                        n = X
                elif xN < maxW:
                    n = addr - 1
            elif X is not None:
                if frame or not top:
                    n = X + 1
                elif not self.mbs[X].fld:
                    n, yM = X + 1, 2 * yN
                else:
                    n = X
        else:
            A = pair(-1, 0)
            if A is not None:
                af = self.mbs[A].fld
                if frame and not af:
                    n = A if top else A + 1
                elif frame:
                    n, yM = A + (yN & 1), (yN >> 1 if top else (yN + maxH) >> 1)
                elif not af:
                    y2 = 2 * yN + (0 if top else 1)
                    n, yM = (A, y2) if yN < maxH // 2 else (A + 1, y2 - maxH)
                else:
                    n = A if top else A + 1
        if n is None:
            return None
        return self.mbs[n], (xN + maxW) % maxW, (yM + maxH) % maxH

    def mb_nb(self, addr, dx, dy, si):
        if self.aff:
            nb = self._aff_nb(addr, -1 if dx < 0 else 16 if dx > 0 else 0, -1 if dy < 0 else 0)
            return None if nb is None else nb[0]
        x, y = addr % self.mbw + dx, addr // self.mbw + dy
        if x < 0 or x >= self.mbw or y < 0:
            return None
        m = self.mbs[y * self.mbw + x]
        return m if m is not None and m.slice == si else None

    def blk_nb(self, cur, addr, x, y):
        """The MB and 4x4 raster index holding luma sample (x, y) relative to
        the current MB, or None where it is not available."""
        if self.aff:
            nb = self._aff_nb(addr, x, y)
            return None if nb is None else (nb[0], (nb[2] // 4) * 4 + nb[1] // 4)
        if x >= 16 and y >= 0:
            return None
        dx = -1 if x < 0 else (1 if x >= 16 else 0)
        dy = -1 if y < 0 else 0
        m = cur if dx == 0 and dy == 0 else self.mb_nb(addr, dx, dy, cur.slice)
        if m is None:
            return None
        return m, ((y % 16) // 4) * 4 + (x % 16) // 4

    def chroma_nb(self, cur, addr, r, dx, dy):
        """The MB and chroma 4x4 block (raster within the component) at
        (dx, dy) from block ``r``'s corner, or None where it is not
        available."""
        x, y = (r % 2) * 4 + dx, (r // 2) * 4 + dy
        if self.aff:
            nb = self._aff_nb(addr, x, y, 8, 8)
            return None if nb is None else (nb[0], (nb[2] // 4) * 2 + nb[1] // 4)
        m = cur if x >= 0 and y >= 0 else \
            self.mb_nb(addr, -1 if x < 0 else 0, -1 if y < 0 else 0, cur.slice)
        return None if m is None else (m, (y % 8) // 4 * 2 + (x % 8) // 4)

    # ---------------------------------------------------------- macroblock
    def _macroblock(self, si, addr):
        c, rng = self.c, self.rng
        cur = MB(si)
        self.mbs[addr] = cur
        A, B = self.mb_nb(addr, -1, 0, si), self.mb_nb(addr, 0, -1, si)
        if self.stype != 2:
            skip = rng.random() < c.p_skip and not self.mixed
            self._skip(A, B, skip)
            if skip:
                return self._skipped(cur, addr)
        self._body(cur, si, addr, A, B)

    def _skipped(self, cur, addr):
        cur.kind = "skip"
        if self.stype == 1:
            self._b_direct(cur, range(4))
        else:
            self._p_skip_mv(cur, addr)
        self.prev_mb = cur

    def _ab(self, addr, si):
        return self.mb_nb(addr, -1, 0, si), self.mb_nb(addr, 0, -1, si)

    def _pair(self, si, top):
        """An MBAFF frame's macroblock pair ``top``, ``top + 1``. Its
        mb_field_decoding_flag goes with the top MB or, where that is
        skipped, with the bottom one; where both are skipped it is inferred
        (§7.4.4). Under CABAC a skipped top MB's mb_skip_flag is followed by
        the bottom's (its contexts from the inferred flag) and then the
        flag, as libavcodec reads them."""
        c, rng = self.c, self.rng
        inferred = self._infer_fld(top, si)
        fld = int(rng.random() < c.p_field_mb)
        skip = [False, False]
        if self.stype != 2:
            skip = [bool(rng.random() < c.p_skip) for _ in range(2)]
        if skip[0] and skip[1]:
            fld = inferred
        t, b = MB(si, fld=inferred), MB(si, fld=inferred)
        self.mbs[top] = t
        self.counts["field_mbs" if fld else "frame_mbs"] += 2
        if skip[0]:
            self._skip(*self._ab(top, si), True)
            self.mbs[top + 1] = b
            if not self.cavlc:
                self._skip(*self._ab(top + 1, si), skip[1])
            elif not skip[1]:
                self._skip(None, None, False)      # the run before the bottom MB
            if not skip[1]:
                self._field_flag(top, si, fld)
            t.fld = b.fld = fld
            self._skipped(t, top)
            if skip[1]:
                if self.cavlc:
                    self.skip_run += 1
                return self._skipped(b, top + 1)
            return self._body(b, si, top + 1, *self._ab(top + 1, si))
        if self.stype != 2:
            self._skip(*self._ab(top, si), False)
        self._field_flag(top, si, fld)
        t.fld = b.fld = fld
        self._body(t, si, top, *self._ab(top, si))
        self.mbs[top + 1] = b
        if self.stype != 2:
            self._skip(*self._ab(top + 1, si), skip[1])
            if skip[1]:
                return self._skipped(b, top + 1)
        self._body(b, si, top + 1, *self._ab(top + 1, si))

    def _pair_nbs(self, top, si):
        """The top MBs of the pairs left of and above pair ``top`` where
        they are in the slice."""
        p, out = top // 2, []
        for ok, a in ((p % self.mbw > 0, top - 2), (p >= self.mbw, top - 2 * self.mbw)):
            m = self.mbs[a] if ok else None
            out.append(m if m is not None and m.slice == si else None)
        return out

    def _infer_fld(self, top, si):
        left, above = self._pair_nbs(top, si)
        return left.fld if left is not None else above.fld if above is not None else 0

    def _field_flag(self, top, si, fld):
        """mb_field_decoding_flag: u(1), or under CABAC ctxIdx 70 + the
        left and above pairs that are field pairs."""
        if self.cavlc:
            self.bits.u(1, fld)
            return
        inc = sum(1 for m in self._pair_nbs(top, si) if m is not None and m.fld)
        self.enc.decision(70 + inc, fld)

    def _body(self, cur, si, addr, A, B):
        """A macroblock that is not skipped, from its mb_type on."""
        c, rng = self.c, self.rng
        intra = self.stype == 2 or rng.random() < c.p_intra_in_p
        if not intra:
            if self.stype == 1:
                return self._b_inter_mb(cur, addr, A, B)
            return self._inter_mb(cur, addr)
        kind = ("PCM" if rng.random() < c.p_pcm else "I16" if rng.random() < c.p_i16
                else "I8" if c.transform8x8 and rng.random() < c.p_i8 else "I4")
        cur.kind = kind
        if kind == "I16":
            avail = self._intra_avail(cur, addr)
            modes = [m for m, need in ((0, "B"), (1, "A"), (2, ""), (3, "ABD"))
                     if all(avail[n] for n in need)]
            cur.i16mode = int(rng.choice(modes))
            cur.cbpl = 15 if rng.random() < 0.5 else 0
            cur.cbpc = int(rng.integers(0, 3))
        self._i_mb_type(cur, A, B)
        if kind == "PCM":
            self._pcm(cur)
            return
        if kind != "I16":
            if c.transform8x8:
                cur.t8 = int(kind == "I8")
                self._t8(A, B, cur.t8)
            self._intra_nxn_modes(cur, addr)
        self._chroma_mode(cur, addr, A, B)
        if kind != "I16":
            cur.cbpl, cur.cbpc = int(rng.integers(0, 16)), int(rng.integers(0, 3))
            self._cbp(cur, addr)
        self._residual_and_qp(cur, addr)

    def _skip(self, A, B, skip):
        """mb_skip_flag, or under CAVLC the run of skipped MBs before a
        coded one."""
        if self.cavlc:
            if skip:
                self.skip_run += 1
            else:
                self.bits.ue(self.skip_run)
                self.skip_run = 0
            return
        self.enc.decision((11 if self.stype == 0 else 24) + (A is not None and A.kind != "skip")
                          + (B is not None and B.kind != "skip"), skip)

    def _t8(self, A, B, v):
        """transform_size_8x8_flag."""
        if self.cavlc:
            self.bits.u(1, v)
        else:
            self.enc.decision(399 + (A is not None and A.t8) + (B is not None and B.t8), v)

    def _i_mb_type(self, cur, A, B):
        """The mb_type of an I macroblock (Table 7-11), after the inter
        types in a P or B slice."""
        kind, enc = cur.kind, self.enc
        if self.cavlc:
            t = 0 if kind in ("I4", "I8") else 25 if kind == "PCM" else \
                1 + cur.i16mode + 4 * cur.cbpc + 12 * (cur.cbpl != 0)
            self.bits.ue(t + (5, 23, 0)[self.stype])
            return
        if self.stype == 0:
            enc.decision(14, 1)          # the intra prefix
            off, b0 = 17, 17
        elif self.stype == 1:
            self._b_mb_type(A, B, "intra")
            off, b0 = 32, 32
        else:
            off = 3
            b0 = 3 + (A is not None and A.kind not in ("I4", "I8")) \
                + (B is not None and B.kind not in ("I4", "I8"))
        if kind in ("I4", "I8"):
            enc.decision(b0, 0)
            return
        enc.decision(b0, 1)
        enc.terminate(kind == "PCM")
        if kind == "I16":
            # Table 9-39: ctxIdxInc of bins 2.. of an I_16x16 mb_type (prefix
            # or P-slice suffix)
            inc = ([3, 4, 5, 6, 7] if cur.cbpc else [3, 4, 6, 7]) if off == 3 else \
                ([1, 2, 2, 3, 3] if cur.cbpc else [1, 2, 3, 3])
            bins = [cur.cbpl != 0, cur.cbpc != 0] + ([cur.cbpc == 2] if cur.cbpc else []) + \
                [cur.i16mode >> 1, cur.i16mode & 1]
            for i, v in zip(inc, bins):
                enc.decision(off + i, int(v))

    def _intra_ok(self, m, cur):
        return m is not None and (m is cur or m.intra or not self.c.constrained_intra)

    def _left_ok(self, cur, addr, y0, n):
        """Whether the left samples of rows y0 .. y0 + n - 1 are available
        for intra prediction (in an MBAFF frame they may lie in two MBs)."""
        return all(self._intra_ok(None if nb is None else nb[0], cur)
                   for nb in (self._aff_nb(addr, -1, y) for y in range(y0, y0 + n)))

    def _intra_avail(self, cur, addr):
        si = cur.slice
        if self.aff:
            return {"A": self._left_ok(cur, addr, 0, 16),
                    "B": self._intra_ok(self.mb_nb(addr, 0, -1, si), cur),
                    "D": self._intra_ok(self.mb_nb(addr, -1, -1, si), cur)}
        return {"A": self._intra_ok(self.mb_nb(addr, -1, 0, si), cur),
                "B": self._intra_ok(self.mb_nb(addr, 0, -1, si), cur),
                "D": self._intra_ok(self.mb_nb(addr, -1, -1, si), cur)}

    def _pcm(self, cur):
        b = self.bits
        if self.cavlc:
            self.pcm_pads.append((len(b.bits), -len(b.bits) % 8))
        while len(b.bits) % 8:
            b.bits.append(0)     # pcm_alignment_zero_bit
        for v in self.rng.integers(1, 256, 384):
            b.u(8, int(v))
        if not self.cavlc:
            self.enc.reset()
        cur.tc, cur.tcc = [16] * 16, [[16] * 4, [16] * 4]
        cur.cbpl, cur.cbpc = 15, 2
        cur.qpd = 0
        self.prev_mb = cur

    def _intra_nxn_modes(self, cur, addr):
        rng = self.rng
        size = 8 if cur.kind == "I8" else 4
        n = 16 // size
        for blk in range(n * n):
            if size == 4:
                bx = (blk // 4 % 2) * 2 + blk % 2
                by = (blk // 8) * 2 + (blk // 2) % 2
            else:
                bx, by = blk % 2, blk // 2
            x, y = bx * size, by * size
            nbs = {}
            for name, (px, py) in (("A", (x - 1, y)), ("B", (x, y - 1)), ("D", (x - 1, y - 1)),
                                   ("C", (x + size, y - 1))):
                nb = self.blk_nb(cur, addr, px, py)
                ok = nb is not None and self._intra_ok(nb[0], cur)
                if ok and name == "C" and nb[0] is cur:
                    ok = self._decoded_before(nb[1], x // 4, y // 4, size)
                nbs[name] = nb if ok else None
            # predicted mode (from the block holding the sample left of the
            # first row, whose MB may differ from others of the left samples)
            pa, pb = nbs["A"], nbs["B"]
            if self.aff and x == 0 and not self._left_ok(cur, addr, y, size):
                nbs["A"] = None
            if pa is None or pb is None:
                pred = 2
            else:
                def mode_of(nb):
                    # of an Intra_4x4 neighbour of an 8x8 block, its 4x4
                    # block holding the sample (§8.3.2.1's n: 1 for A, 2
                    # for B, 3 for A of block 2 of a frame MB beside a
                    # field pair)
                    m, r = nb
                    return m.ipm[r] if m.kind in ("I4", "I8") else 2
                pred = min(mode_of(pa), mode_of(pb))
            ok = [2]
            if nbs["B"] is not None:
                ok += [0, 3, 7]
            if nbs["A"] is not None:
                ok += [1, 8]
            if nbs["A"] is not None and nbs["B"] is not None and nbs["D"] is not None:
                ok += [4, 5, 6]
            mode = pred if pred in ok and rng.random() < 0.4 else int(rng.choice(ok))
            rem = mode if mode < pred else mode - 1
            if self.cavlc:
                self.bits.u(1, mode == pred)
                if mode != pred:
                    self.bits.u(3, rem)
            elif mode == pred:
                self.enc.decision(68, 1)
            else:
                self.enc.decision(68, 0)
                for i in range(3):
                    self.enc.decision(69, (rem >> i) & 1)
            for yy in range(size // 4):
                for xx in range(size // 4):
                    cur.ipm[(y // 4 + yy) * 4 + x // 4 + xx] = mode

    @staticmethod
    def _decoded_before(r, bx, by, size):
        """Whether 4x4 raster block ``r`` of the current MB precedes the
        block at (bx, by) in decoding order (for a top-right neighbour)."""
        def order(rx, ry):
            return (ry // 2 * 2 + rx // 2) * 4 + (ry % 2) * 2 + rx % 2
        rx, ry = r % 4, r // 4
        if size == 8:
            return (ry // 2 * 2 + rx // 2) < (by // 2 * 2 + bx // 2)
        return order(rx, ry) < order(bx, by)

    def _chroma_mode(self, cur, addr, A, B):
        avail = self._intra_avail(cur, addr)
        modes = [m for m, need in ((0, ""), (1, "A"), (2, "B"), (3, "ABD"))
                 if all(avail[n] for n in need)]
        cur.cmode = int(self.rng.choice(modes))
        if self.cavlc:
            self.bits.ue(cur.cmode)
            return
        enc = self.enc
        inc = sum(1 for N in (A, B) if N is not None and N.intra and N.kind != "PCM"
                  and N.cmode != 0)
        enc.unary(cur.cmode, [64 + inc, 67, 67], cmax=3)

    def _cbp(self, cur, addr):
        if self.cavlc:               # me(v)
            self.bits.ue(CBP_CODE[0 if cur.intra else 1][cur.cbpl | cur.cbpc << 4])
            return
        enc = self.enc
        for b8 in range(4):
            bx, by = (b8 % 2) * 8, (b8 // 2) * 8
            conds = []
            for px, py in ((bx - 1, by), (bx, by - 1)):
                nb = self.blk_nb(cur, addr, px, py)
                if nb is None:
                    conds.append(0)
                    continue
                m, r = nb
                nb8 = (r // 4 // 2) * 2 + (r % 4) // 2
                if m.kind == "PCM":
                    conds.append(0)
                elif m is cur:
                    conds.append(0 if (cur.cbpl >> nb8) & 1 else 1)
                elif m.kind != "skip" and (m.cbpl >> nb8) & 1:
                    conds.append(0)
                else:
                    conds.append(1)
            enc.decision(73 + conds[0] + 2 * conds[1], (cur.cbpl >> b8) & 1)
        A, B = self.mb_nb(addr, -1, 0, cur.slice), self.mb_nb(addr, 0, -1, cur.slice)

        def cond(N, b1):
            if N is None or N.kind == "skip":
                return 0
            if N.kind == "PCM":
                return 1
            return int(N.cbpc == 2) if b1 else int(N.cbpc != 0)
        enc.decision(77 + cond(A, 0) + 2 * cond(B, 0), cur.cbpc != 0)
        if cur.cbpc:
            enc.decision(77 + 4 + cond(A, 1) + 2 * cond(B, 1), cur.cbpc == 2)

    # -------------------------------------------------------------- inter
    def _p_skip_mv(self, cur, addr):
        A = self.blk_nb(cur, addr, -1, 0)
        B = self.blk_nb(cur, addr, 0, -1)
        cur.ref = [0] * 16
        zero = A is None or B is None
        for nb in (A, B):
            if nb is not None and nb[0].ref[nb[1]] == 0 and nb[0].mv[nb[1]] == (0, 0):
                zero = True
        mv = (0, 0) if zero else self._mvp(cur, addr, 0, 0, 16, 16, 0, "16x16", 0)
        cur.mv = [mv] * 16

    def _mv_nb(self, cur, addr, x, y, done, lst=0):
        nb = self.blk_nb(cur, addr, x, y)
        if nb is None:
            return None
        m, r = nb
        if m is cur and not done[r]:
            return None
        if m.intra:
            return (-1, (0, 0))
        ref, mv, _ = m.motion(lst)
        ref, mv = ref[r], mv[r]
        if m.fld != cur.fld and ref >= 0:      # §8.4.1.3.1 across MBAFF structures
            ref, mv = (2 * ref, (mv[0], int(mv[1] / 2))) if cur.fld else \
                (ref >> 1, (mv[0], 2 * mv[1]))
        return (ref, mv)

    def _mvp(self, cur, addr, x, y, w, h, ref, part, idx, done=None, lst=0):
        done = done if done is not None else [False] * 16
        A = self._mv_nb(cur, addr, x - 1, y, done, lst)
        B = self._mv_nb(cur, addr, x, y - 1, done, lst)
        C = self._mv_nb(cur, addr, x + w, y - 1, done, lst)
        if C is None:
            C = self._mv_nb(cur, addr, x - 1, y - 1, done, lst)
        un = (-1, (0, 0))
        if part == "16x8":
            if idx == 0 and B is not None and B[0] == ref:
                return B[1]
            if idx == 1 and A is not None and A[0] == ref:
                return A[1]
        if part == "8x16":
            if idx == 0 and A is not None and A[0] == ref:
                return A[1]
            if idx == 1 and C is not None and C[0] == ref:
                return C[1]
        if B is None and C is None and A is not None:
            return A[1]
        A, B, C = A or un, B or un, C or un
        match = [n for n in (A, B, C) if n[0] == ref]
        if len(match) == 1:
            return match[0][1]
        return tuple(sorted((A[1][k], B[1][k], C[1][k]))[1] for k in range(2))

    P_SUBS = ("8x8", "8x4", "4x8", "4x4")

    def _inter_mb(self, cur, addr):
        c, rng, enc = self.c, self.rng, self.enc
        cur.kind = "P"
        part = str(rng.choice(["16x16", "16x8", "8x16", "8x8"]))
        # P_8x8ref0 (CAVLC only): every quarter on reference index 0
        ref0 = part == "8x8" and self.cavlc and c.p_8x8ref0 > 0 and rng.random() < c.p_8x8ref0
        if self.cavlc:
            self.bits.ue(4 if ref0 else ("16x16", "16x8", "8x16", "8x8").index(part))
            self.counts["8x8ref0"] += ref0
        elif part == "16x16":
            enc.decision(14, 0)
            enc.decision(15, 0)
            enc.decision(16, 0)
        elif part == "8x8":
            enc.decision(14, 0)
            enc.decision(15, 0)
            enc.decision(16, 1)
        else:
            enc.decision(14, 0)
            enc.decision(15, 1)
            enc.decision(17, part == "16x8")
        if part == "8x8":
            subs = tuple(str(rng.choice(["8x8", "8x4", "4x8", "4x4"])) for _ in range(4))
            cur.subs = subs
            for s in subs:
                if self.cavlc:
                    self.bits.ue(self.P_SUBS.index(s))
                elif s == "8x8":
                    enc.decision(21, 1)
                else:
                    enc.decision(21, 0)
                    enc.decision(22, s != "8x4")
                    if s != "8x4":
                        enc.decision(23, s == "4x8")
            parts = [(b8 % 2 * 8, b8 // 2 * 8, 8, 8) for b8 in range(4)]
        else:
            pw, ph = int(part.split("x")[0]), int(part.split("x")[1])
            parts = [(x, y, pw, ph) for y in range(0, 16, ph) for x in range(0, 16, pw)]
        usable = self._usable(self.list0, cur)
        refs = []
        for (x, y, w, h) in parts:
            ref = 0 if ref0 else int(rng.choice(usable))
            if self.remap is not None and self.stype == 0 and not ref0:
                ref = self.remap[ref]
            refs.append(ref)
            if self.nref * (1 + cur.fld * self.aff) > 1 and not ref0:
                self._ref_idx(cur, addr, x, y, ref)
            for yy in range(y // 4, (y + h) // 4):
                for xx in range(x // 4, (x + w) // 4):
                    cur.ref[yy * 4 + xx] = ref
        done = [False] * 16
        for pi, (x, y, w, h) in enumerate(parts):
            if part == "8x8":
                s = cur.subs[pi]
                sw, sh = int(s.split("x")[0]), int(s.split("x")[1])
                subparts = [(x + sx, y + sy, sw, sh) for sy in range(0, 8, sh)
                            for sx in range(0, 8, sw)]
            else:
                subparts = [(x, y, w, h)]
            for (sx, sy, sw, sh) in subparts:
                mvp = self._mvp(cur, addr, sx, sy, sw, sh, refs[pi], part, pi, done)
                if self.mixed:
                    # the twins' vectors, the same whatever the predictions
                    mv = (int(rng.integers(-64, 65)), int(rng.integers(-64, 65)))
                elif rng.random() < c.p_far_mv:
                    mv = (int(rng.integers(-4 * (self.mbw * 16 + 160), 4 * (self.mbw * 16 + 160))),
                          int(rng.integers(-4 * (self.mbh * 16 + 160), 4 * (self.mbh * 16 + 160))))
                else:
                    mv = (mvp[0] + int(rng.integers(-40, 41)), mvp[1] + int(rng.integers(-40, 41)))
                    lim = (4 * (self.mbw * 16 + 200), 4 * (self.mbh * 16 + 200))
                    mv = tuple(max(-lim[k], min(lim[k], mv[k])) for k in range(2))
                mvd = (mv[0] - mvp[0], mv[1] - mvp[1])
                for comp in range(2):
                    self._mvd(cur, addr, sx, sy, comp, mvd[comp])
                for yy in range(sy // 4, (sy + sh) // 4):
                    for xx in range(sx // 4, (sx + sw) // 4):
                        cur.mv[yy * 4 + xx] = mv
                        cur.mvd[yy * 4 + xx] = mvd
                        done[yy * 4 + xx] = True
        cur.cbpl, cur.cbpc = int(rng.integers(0, 16)), int(rng.integers(0, 3))
        self._cbp(cur, addr)
        small = part == "8x8" and any(s != "8x8" for s in cur.subs)
        if cur.cbpl and c.transform8x8 and not small:
            A, B = self.mb_nb(addr, -1, 0, cur.slice), self.mb_nb(addr, 0, -1, cur.slice)
            cur.t8 = int(rng.random() < 0.5)
            self._t8(A, B, cur.t8)
        self._residual_and_qp(cur, addr)

    def _usable(self, lst, cur):
        """The reference indices of list ``lst`` that name a picture; an MBAFF
        field MB's name its frames' fields, the MB's parity first."""
        usable = [i for i, r in enumerate(lst) if r is not None]
        if self.aff and cur.fld:
            usable = [2 * i + k for i in usable for k in (0, 1)]
        return usable

    def _ref_idx(self, cur, addr, x, y, ref, lst=0):
        """ref_idx_lX: te(v) under CAVLC; under CABAC §9.3.3.1.1.6, a
        neighbour partition counts where its refIdxLX exceeds 0 and it is
        neither skipped nor direct-predicted."""
        if self.cavlc:
            nref = self.nrefs[lst] if self.stype == 1 else self.nref
            nref *= 1 + cur.fld * self.aff      # an MBAFF field MB's list of fields
            self.tables.add(("te", nref))
            if nref == 2:
                self.bits.u(1, 1 - ref)
            else:
                self.bits.ue(ref)
            return
        conds = []
        for px, py in ((x - 1, y), (x, y - 1)):
            nb = self.blk_nb(cur, addr, px, py)
            if nb is None or nb[0].kind == "skip" or nb[0].intra or nb[0].direct[nb[1]]:
                conds.append(0)
            else:
                # refIdxZeroFlagN: a field neighbour of a frame MB counts from 2
                conds.append(int(nb[0].motion(lst)[0][nb[1]] > int(nb[0].fld > cur.fld)))
        self.enc.unary(ref, [54 + conds[0] + 2 * conds[1], 58, 59])

    def _mvd(self, cur, addr, x, y, comp, v, lst=0):
        if self.cavlc:
            self.bits.se(v)
            return
        s = 0
        for px, py in ((x - 1, y), (x, y - 1)):
            nb = self.blk_nb(cur, addr, px, py)
            if nb is not None and nb[0].kind not in ("skip",) and not nb[0].intra:
                a = abs(nb[0].motion(lst)[2][nb[1]][comp])
                if comp == 1 and nb[0].fld != cur.fld:    # §9.3.3.1.1.7
                    a = a >> 1 if cur.fld else a << 1
                s += a
        base = 40 if comp == 0 else 47
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        a = abs(v)
        ctxs = [base + inc, base + 3, base + 4, base + 5, base + 6]
        enc = self.enc
        for i in range(min(a, 9)):
            enc.decision(ctxs[min(i, 4)], 1)
        if a < 9:
            enc.decision(ctxs[min(a, 4)], 0)
        else:
            enc.exp_golomb(a - 9, 3)
        if a:
            enc.bypass(v < 0)

    # --------------------------------------------------------- B inter
    # Table 7-14 and 7-18 by their bins (Tables 9-37 and 9-38): mb_type 0
    # B_Direct_16x16, 1-21 (shape, list of partition 0, of partition 1) with
    # shape 16x16, 16x8 or 8x16 and list 1 L0, 2 L1, 3 Bi, 22 B_8x8; and the
    # sub_mb_types 0 B_Direct_8x8, 1-12 (shape, list)
    B_MB = {1: ("16x16", 1, 0), 2: ("16x16", 2, 0), 3: ("16x16", 3, 0),
            4: ("16x8", 1, 1), 5: ("8x16", 1, 1), 6: ("16x8", 2, 2), 7: ("8x16", 2, 2),
            8: ("16x8", 1, 2), 9: ("8x16", 1, 2), 10: ("16x8", 2, 1), 11: ("8x16", 2, 1),
            12: ("16x8", 1, 3), 13: ("8x16", 1, 3), 14: ("16x8", 2, 3), 15: ("8x16", 2, 3),
            16: ("16x8", 3, 1), 17: ("8x16", 3, 1), 18: ("16x8", 3, 2), 19: ("8x16", 3, 2),
            20: ("16x8", 3, 3), 21: ("8x16", 3, 3)}
    B_MB_BINS = {0: "0", 1: "100", 2: "101", 3: "110000", 4: "110001", 5: "110010",
                 6: "110011", 7: "110100", 8: "110101", 9: "110110", 10: "110111",
                 11: "111110", 12: "1110000", 13: "1110001", 14: "1110010", 15: "1110011",
                 16: "1110100", 17: "1110101", 18: "1110110", 19: "1110111", 20: "1111000",
                 21: "1111001", 22: "111111", "intra": "111101"}
    B_SUB = {1: ("8x8", 1), 2: ("8x8", 2), 3: ("8x8", 3), 4: ("8x4", 1), 5: ("4x8", 1),
             6: ("8x4", 2), 7: ("4x8", 2), 8: ("8x4", 3), 9: ("4x8", 3), 10: ("4x4", 1),
             11: ("4x4", 2), 12: ("4x4", 3)}
    B_SUB_BINS = {0: "0", 1: "100", 2: "101", 3: "11000", 4: "11001", 5: "11010", 6: "11011",
                  7: "111000", 8: "111001", 9: "111010", 10: "111011", 11: "11110",
                  12: "11111"}

    def _b_mb_type(self, A, B, t):
        """mb_type ``t`` of a B slice: ctxIdx 27 + 0..2 by the neighbours that
        are neither B_Skip nor B_Direct_16x16, then 30; the third bin 31
        after a 1, 32 after a 0; the rest 32."""
        if self.cavlc:
            assert t != "intra"          # _i_mb_type codes it
            self.bits.ue(t)
            return
        bins = self.B_MB_BINS[t]
        inc = sum(1 for N in (A, B) if N is not None and N.kind not in ("skip", "direct"))
        for i, v in enumerate(bins):
            ctx = 27 + inc if i == 0 else 30 if i == 1 else \
                (31 if bins[1] == "1" else 32) if i == 2 else 32
            self.enc.decision(ctx, int(v))

    def _b_sub_type(self, t):
        if self.cavlc:
            self.bits.ue(t)
            return
        bins = self.B_SUB_BINS[t]
        for i, v in enumerate(bins):
            ctx = 36 if i == 0 else 37 if i == 1 else \
                (38 if bins[1] == "1" else 39) if i == 2 else 39
            self.enc.decision(ctx, int(v))

    @staticmethod
    def _b_direct(cur, quarters):
        """Marks the 8x8 ``quarters`` direct-predicted. The writer does not
        derive their motion: it takes refIdx -1 and a zero vector for its own
        predictions, which only steer the vectors it draws."""
        for q in quarters:
            for k in range(4):
                cur.direct[(q // 2 * 2 + k // 2) * 4 + q % 2 * 2 + k % 2] = 1

    def _b_inter_mb(self, cur, addr, A, B):
        c, rng, enc = self.c, self.rng, self.enc
        if rng.random() < c.p_direct:
            t = 0
        elif rng.random() < 0.3:
            t = 22
        else:
            t = int(rng.integers(1, 22))
        self._b_mb_type(A, B, t)
        small = False
        if t == 0:
            cur.kind = "direct"
            self._b_direct(cur, range(4))
            small = not c.direct_8x8_inference
        else:
            cur.kind = "P"
            if t == 22:
                part = "8x8"
                subs = [int(rng.integers(0, 13)) if rng.random() > 0.25 else 0 for _ in range(4)]
                for st in subs:
                    self._b_sub_type(st)
                self._b_direct(cur, [q for q in range(4) if subs[q] == 0])
                parts = [(q % 2 * 8, q // 2 * 8, 8, 8) for q in range(4)]
                preds = [0 if st == 0 else self.B_SUB[st][1] for st in subs]
                shapes = ["8x8" if st == 0 else self.B_SUB[st][0] for st in subs]
                small = any(not c.direct_8x8_inference if st == 0 else self.B_SUB[st][0] != "8x8"
                            for st in subs)
                cur.subs = tuple(shapes)
            else:
                part, p0, p1 = self.B_MB[t]
                pw, ph = int(part.split("x")[0]), int(part.split("x")[1])
                parts = [(x, y, pw, ph) for y in range(0, 16, ph) for x in range(0, 16, pw)]
                preds = [p0, p1][:len(parts)]
                shapes = [part] * len(parts)
            refs = [[0] * len(parts), [0] * len(parts)]
            for lst in range(2):
                usable = self._usable(self.lists[lst], cur)
                ref_arr = cur.motion(lst)[0]
                for pi, (x, y, w, h) in enumerate(parts):
                    if not (preds[pi] >> lst) & 1:
                        continue
                    ref = int(rng.choice(usable))
                    refs[lst][pi] = ref
                    if self.nrefs[lst] * (1 + cur.fld * self.aff) > 1:
                        self._ref_idx(cur, addr, x, y, ref, lst)
                    for yy in range(y // 4, (y + h) // 4):
                        for xx in range(x // 4, (x + w) // 4):
                            ref_arr[yy * 4 + xx] = ref
            for lst in range(2):
                _, mv_arr, mvd_arr = cur.motion(lst)
                done = [False] * 16
                for pi, (x, y, w, h) in enumerate(parts):
                    if not (preds[pi] >> lst) & 1:
                        for yy in range(y // 4, (y + h) // 4):
                            for xx in range(x // 4, (x + w) // 4):
                                done[yy * 4 + xx] = True
                        continue
                    sw, sh = int(shapes[pi].split("x")[0]), int(shapes[pi].split("x")[1])
                    if part != "8x8":
                        sw, sh = w, h
                    for sy in range(y, y + h, sh):
                        for sx in range(x, x + w, sw):
                            mvp = self._mvp(cur, addr, sx, sy, sw, sh, refs[lst][pi], part, pi,
                                            done, lst)
                            mv = (mvp[0] + int(rng.integers(-40, 41)),
                                  mvp[1] + int(rng.integers(-40, 41)))
                            if rng.random() < c.p_far_mv:
                                mv = (int(rng.integers(-4 * (self.mbw * 16 + 64),
                                                       4 * (self.mbw * 16 + 64))),
                                      int(rng.integers(-4 * (self.mbh * 16 + 64),
                                                       4 * (self.mbh * 16 + 64))))
                            lim = (4 * (self.mbw * 16 + 100), 4 * (self.mbh * 16 + 100))
                            mv = tuple(max(-lim[k], min(lim[k], mv[k])) for k in range(2))
                            mvd = (mv[0] - mvp[0], mv[1] - mvp[1])
                            for comp in range(2):
                                self._mvd(cur, addr, sx, sy, comp, mvd[comp], lst)
                            for yy in range(sy // 4, (sy + sh) // 4):
                                for xx in range(sx // 4, (sx + sw) // 4):
                                    mv_arr[yy * 4 + xx] = mv
                                    mvd_arr[yy * 4 + xx] = mvd
                                    done[yy * 4 + xx] = True
        cur.cbpl, cur.cbpc = int(rng.integers(0, 16)), int(rng.integers(0, 3))
        self._cbp(cur, addr)
        if cur.cbpl and c.transform8x8 and not small:
            cur.t8 = int(rng.random() < 0.5)
            self._t8(A, B, cur.t8)
        self._residual_and_qp(cur, addr)

    # ----------------------------------------------------------- residual
    def _residual_and_qp(self, cur, addr):
        c, rng, enc = self.c, self.rng, self.enc
        if cur.cbpl or cur.cbpc or cur.kind == "I16":
            lo, hi = c.qp_range
            qpd = 0
            if rng.random() < c.p_qpd:
                qpd = int(rng.integers(max(-26, lo - self.qp), min(25, hi - self.qp) + 1))
            p = self.prev_mb
            inc = int(p is not None and p.kind not in ("skip", "PCM")
                      and (p.kind == "I16" or p.cbpl or p.cbpc) and p.qpd != 0)
            if self.cavlc:
                self.bits.se(qpd)
            else:
                enc.unary(2 * qpd - 1 if qpd > 0 else -2 * qpd, [60 + inc, 62, 63])
            cur.qpd = qpd
            self.qp = (self.qp + qpd + 52) % 52
        self.prev_mb = cur
        qp = self.qp
        intra = cur.intra
        if cur.kind == "I16":
            self._block(cur, addr, 0, None, 16, qp, 0)
        for b8 in range(4):
            if not (cur.cbpl >> b8) & 1:
                continue
            if cur.t8:
                self._block(cur, addr, 5, b8, 64, qp, 6 + (not intra))
                continue
            for s in range(4):
                r = ((b8 // 2) * 2 + s // 2) * 4 + (b8 % 2) * 2 + s % 2
                if cur.kind == "I16":
                    self._block(cur, addr, 1, r, 15, qp, 0)
                else:
                    self._block(cur, addr, 2, r, 16, qp, 0 if intra else 3)
        qpc = [self._qpc(qp, c.chroma_qp_offset), self._qpc(qp, c.second_chroma_qp_offset)]
        if cur.cbpc:
            for comp in range(2):
                self._block(cur, addr, 3, comp, 4, qpc[comp], comp + 1 + (0 if intra else 3))
        if cur.cbpc == 2:
            for comp in range(2):
                for r in range(4):
                    self._block(cur, addr, 4, (comp, r), 15, qpc[comp],
                                comp + 1 + (0 if intra else 3))

    @staticmethod
    def _qpc(qp, off):
        qpi = min(51, max(0, qp + off))
        table = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39,
                 39, 39, 39]
        return qpi if qpi < 30 else table[qpi - 30]

    def _cbf_cond(self, cur, addr, cat, which, nbx, nby):
        """condTermFlagN of coded_block_flag (§9.3.3.1.1.9)."""
        if cat in (0, 3):
            m = self.mb_nb(addr, nbx, nby, cur.slice)
            nb = None if m is None else (m, None)
        elif cat == 4:
            nb = self.chroma_nb(cur, addr, which[1], nbx, nby)
        else:
            rx, ry = which % 4, which // 4
            nb = self.blk_nb(cur, addr, rx * 4 + nbx, ry * 4 + nby)
        if nb is None:
            return int(cur.intra)
        m, r = nb
        if m.kind == "PCM":
            return 1
        if m.kind == "skip":
            return 0
        if cat == 0:
            return m.cbf_dc if m.kind == "I16" else 0
        if cat in (1, 2):
            b8 = (r // 4 // 2) * 2 + (r % 4) // 2
            if not (m.cbpl >> b8) & 1:
                return 0
            return 1 if m.t8 else m.cbf[r]
        if cat == 3:
            return m.cbfc_dc[which] if m.cbpc else 0
        return m.cbfc[which[0]][r] if m.cbpc == 2 else 0

    def _block(self, cur, addr, cat, which, n, qp, lst):
        rng, enc = self.rng, self.enc
        # coefficients: a sparse random list within the dequantized bound
        coeffs = [0] * n
        coded = rng.random() < 0.75 or cat == 5
        if cat == 5 and self.cavlc and self.c.p_empty8x8 > 0 and rng.random() < self.c.p_empty8x8:
            coded = False
            self.counts["empty8x8"] += 1
        if coded:
            scale = self.weights[lst] * max(NORM8[qp % 6] if cat == 5 else NORM4[qp % 6])
            unit = scale * (1 << (qp // 6)) / (64 if cat == 5 else 16)
            if cat in (0, 3):
                unit *= 4
            lim = max(1, min(self.c.max_level, int(self.c.level_bound / unit)))
            k = int(rng.integers(1, min(n, 8) + 1)) if rng.random() < 0.8 else n
            pos = rng.choice(n, size=k, replace=False)
            budget = self.c.level_bound * 3 // 2
            for p in pos:
                v = int(rng.integers(1, lim + 1)) if rng.random() < 0.3 else int(rng.integers(1, 3))
                v = min(v, max(1, int(budget / unit)))
                budget -= v * unit
                coeffs[p] = v if rng.random() < 0.5 else -v
                if budget <= 0:
                    break
            if not any(coeffs):
                coeffs[int(pos[0])] = 1
        if self.cavlc:
            self._cavlc_residual(cur, addr, cat, which, coeffs)
            return
        flag = int(any(coeffs))
        if cat != 5:
            ca = self._cbf_cond(cur, addr, cat, which, -1, 0)
            cb = self._cbf_cond(cur, addr, cat, which, 0, -1)
            enc.decision(85 + CBF_CAT[cat] + ca + 2 * cb, flag)
        if cat == 0:
            cur.cbf_dc = flag
        elif cat in (1, 2):
            cur.cbf[which] = flag
        elif cat == 3:
            cur.cbfc_dc[which] = flag
        elif cat == 4:
            cur.cbfc[which[0]][which[1]] = flag
        if not flag:
            return
        last = max(i for i in range(n) if coeffs[i])
        # a field macroblock's significance contexts (ctxIdxOffset 277 and
        # 338; 436 and 451 with Table 9-43's field column for cat 5)
        fld = self.field or cur.fld
        sig0, last0 = (277, 338) if fld else (105, 166)
        sig8, sig80, last80 = (SIG8_FIELD, 436, 451) if fld else (SIG8, 402, 417)
        for i in range(n - 1):
            sig = int(coeffs[i] != 0)
            if cat == 5:
                enc.decision(sig80 + sig8[i], sig)
            else:
                inc = min(i, 2) if cat == 3 else i
                enc.decision(sig0 + SIG_CAT[cat] + inc, sig)
            if sig:
                if cat == 5:
                    enc.decision(last80 + LAST8[i], i == last)
                else:
                    inc = min(i, 2) if cat == 3 else i
                    enc.decision(last0 + SIG_CAT[cat] + inc, i == last)
                if i == last:
                    break
        gt1 = eq1 = 0
        base = 426 if cat == 5 else 227 + ABS_CAT[cat]
        for i in range(last, -1, -1):
            v = coeffs[i]
            if not v:
                continue
            a = abs(v) - 1
            ctx0 = base + (0 if gt1 else min(4, 1 + eq1))
            ctxn = base + 5 + min(4 - (cat == 3), gt1)
            enc.decision(ctx0, a > 0)
            if a > 0:
                for j in range(1, min(a, 14)):
                    enc.decision(ctxn, 1)
                if a < 14:
                    enc.decision(ctxn, 0)
                else:
                    enc.exp_golomb(a - 14, 0)
            enc.bypass(v < 0)
            if a == 0:
                eq1 += 1
            else:
                gt1 += 1


    # -------------------------------------------------------------- CAVLC
    def _nc(self, cur, addr, comp, r):
        """§9.2.1: nC of luma 4x4 block ``r`` (raster; ``comp`` None) or of
        chroma AC block ``r`` of component ``comp``, from the TotalCoeff of
        the blocks left of and above it in the slice."""
        counts = []
        for dx, dy in ((-1, 0), (0, -1)):
            if comp is None:
                nb = self.blk_nb(cur, addr, (r % 4) * 4 + dx, (r // 4) * 4 + dy)
            else:
                nb = self.chroma_nb(cur, addr, r, dx, dy)
            counts.append(None if nb is None else
                          nb[0].tc[nb[1]] if comp is None else nb[0].tcc[comp][nb[1]])
        a, b = counts
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        return a if a is not None else b if b is not None else 0

    def _cavlc_residual(self, cur, addr, cat, which, coeffs):
        """The block of ``_block`` (its ctxBlockCat and ``which``) as CAVLC
        codes it: an 8x8 block as four interleaved 4x4 blocks (coefficient
        4 k + i in the i-th), each block's TotalCoeff kept for later nC."""
        if cat == 0:
            self._cavlc_block(coeffs, self._nc(cur, addr, None, 0), 16)
        elif cat == 3:
            self._cavlc_block(coeffs, -1, 4)
        elif cat == 4:
            comp, r = which
            cur.tcc[comp][r] = self._cavlc_block(coeffs, self._nc(cur, addr, comp, r), 15)
        elif cat == 5:
            for i in range(4):
                r = ((which // 2) * 2 + i // 2) * 4 + (which % 2) * 2 + i % 2
                cur.tc[r] = self._cavlc_block(coeffs[i::4], self._nc(cur, addr, None, r), 16)
        else:
            cur.tc[which] = self._cavlc_block(coeffs, self._nc(cur, addr, None, which),
                                              len(coeffs))

    def _cavlc_block(self, coeffs, nc, max_coeff):
        """§7.3.5.3.2 residual_block_cavlc of ``coeffs`` (scanning order);
        returns TotalCoeff. Each table class it codes goes into
        ``self.tables``."""
        b, used = self.bits, self.tables
        where = [i for i, v in enumerate(coeffs) if v]
        levels = [coeffs[i] for i in reversed(where)]          # highest frequency first
        total, ones = len(where), 0
        while ones < min(3, total) and abs(levels[ones]) == 1:
            ones += 1
        col = 4 if nc < 0 else 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        b.code(COEFF_TOKEN[(ones, total)][col])
        used.add(("coeff_token", col))
        if not total:
            return 0
        suffix = 1 if total > 10 and ones < 3 else 0           # suffixLength
        for i, v in enumerate(levels):
            if i < ones:
                b.u(1, v < 0)
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1         # levelCode
            if i == ones and ones < 3:
                code -= 2
            used.add(("suffix_length", suffix))
            self._level(code, suffix)
            if suffix == 0:
                suffix = 1
            if abs(v) > (3 << (suffix - 1)) and suffix < 6:
                suffix += 1
        zeros = where[-1] + 1 - total
        if total < max_coeff:
            table = TOTAL_ZEROS_DC if max_coeff == 4 else TOTAL_ZEROS
            b.code(table[total][zeros])
            used.add(("total_zeros_dc" if max_coeff == 4 else "total_zeros", total))
        for i in range(total - 1, 0, -1):
            if not zeros:
                break
            run = where[i] - where[i - 1] - 1
            b.code(RUN_BEFORE[min(zeros, 7)][run])
            used.add(("run_before", min(zeros, 7)))
            zeros -= run
        return total

    def _level(self, code, suffix):
        """level_prefix and level_suffix of levelCode ``code`` at
        suffixLength ``suffix`` (§9.2.2.1): the escapes at prefix 14 (its
        4-bit suffix at suffixLength 0) and 15, and above 15 the High
        profiles' longer ones (1 << (prefix - 3)) - 4096 further on."""
        if suffix == 0 and code < 14:
            prefix, size, value = code, 0, 0
        elif suffix == 0 and code < 30:
            prefix, size, value = 14, 4, code - 14
        elif suffix and code < 15 << suffix:
            prefix, size, value = code >> suffix, suffix, code & ((1 << suffix) - 1)
        else:
            value = code - (15 << suffix) - (15 if suffix == 0 else 0)
            prefix = 15
            while value - max(0, (1 << (prefix - 3)) - 4096) >= 1 << (prefix - 3):
                prefix += 1
            value -= max(0, (1 << (prefix - 3)) - 4096)
            size = prefix - 3
            if prefix > 15 and self.c.profile < 100:
                raise ValueError("level_prefix above 15 outside the High profiles")
        self.tables.add(("level_prefix", min(prefix, 16)))
        self.bits.u(prefix, 0)
        self.bits.u(1, 1)
        self.bits.u(size, value)


# ------------------------------------------------------------- containers


def annexb(sps, pps, aus) -> bytes:
    out = bytearray()
    for i, au in enumerate(aus):
        if i == 0:
            out += b"\x00\x00\x00\x01" + sps + b"\x00\x00\x00\x01" + pps
        for n in au:
            out += b"\x00\x00\x01" + n
    return bytes(out)


def _box(kind, *payload):
    body = b"".join(payload)
    return (8 + len(body)).to_bytes(4, "big") + kind + body


def _full(kind, version, flags, *payload):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big"), *payload)


def mp4(sps, pps, aus, width, height, length_size=4, moov_first=False, co64=False,
        stz2=False, chunk=3, codec=b"avc1", edit=None) -> bytes:
    """An MP4 file of one video track: ``aus`` as samples of
    ``length_size``-byte NAL lengths, SPS and PPS in ``avcC``, ``chunk``
    samples a chunk (the last chunk shorter), 60 samples a second."""
    samples = [b"".join(len(n).to_bytes(length_size, "big") + n for n in au) for au in aus]
    ftyp = _box(b"ftyp", b"isom", (512).to_bytes(4, "big"), b"isomiso2avc1mp41")
    mdat_payload = b"".join(samples)

    def moov(mdat_data_off):
        u32 = lambda v: v.to_bytes(4, "big")
        u16 = lambda v: v.to_bytes(2, "big")
        n = len(samples)
        avcc = _box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFC | (length_size - 1), 0xE1]),
                    u16(len(sps)), sps, bytes([1]), u16(len(pps)), pps)
        entry = _box(codec, bytes(6), u16(1), bytes(16), u16(width), u16(height),
                     u32(0x00480000), u32(0x00480000), u32(0), u16(1), bytes(32), u16(24),
                     (0xFFFF).to_bytes(2, "big"), avcc)
        stsd = _full(b"stsd", 0, 0, u32(1), entry)
        stts = _full(b"stts", 0, 0, u32(1), u32(n), u32(1))
        chunks = [list(range(i, min(i + chunk, n))) for i in range(0, n, chunk)]
        runs = []
        for ci, ch in enumerate(chunks):
            if not runs or runs[-1][1] != len(ch):
                runs.append((ci + 1, len(ch)))
        stsc = _full(b"stsc", 0, 0, u32(len(runs)), *[u32(a) + u32(b) + u32(1) for a, b in runs])
        if stz2:
            stsz = _full(b"stz2", 0, 0, bytes(3), bytes([16]), u32(n),
                         *[u16(len(s)) for s in samples])
        else:
            stsz = _full(b"stsz", 0, 0, u32(0), u32(n), *[u32(len(s)) for s in samples])
        offs, pos = [], mdat_data_off
        for ch in chunks:
            offs.append(pos)
            pos += sum(len(samples[i]) for i in ch)
        if co64:
            stco = _full(b"co64", 0, 0, u32(len(offs)), *[o.to_bytes(8, "big") for o in offs])
        else:
            stco = _full(b"stco", 0, 0, u32(len(offs)), *[u32(o) for o in offs])
        keys = [i + 1 for i, au in enumerate(aus) if any((x[0] & 31) == 5 for x in au)]
        stss = _full(b"stss", 0, 0, u32(len(keys)), *[u32(k) for k in keys])
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco, stss)
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dref = _full(b"dref", 0, 0, u32(1), _full(b"url ", 0, 1))
        minf = _box(b"minf", vmhd, _box(b"dinf", dref), stbl)
        hdlr = _full(b"hdlr", 0, 0, u32(0), b"vide", bytes(12), b"VideoHandler\x00")
        mdhd = _full(b"mdhd", 0, 0, u32(0), u32(0), u32(60), u32(n), u16(0x55C4), u16(0))
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        matrix = u32(0x10000) + u32(0) + u32(0) + u32(0) + u32(0x10000) + u32(0) + u32(0) + \
            u32(0) + u32(0x40000000)
        tkhd = _full(b"tkhd", 0, 3, u32(0), u32(0), u32(1), u32(0), u32(n * 1000 // 60),
                     bytes(8), u16(0), u16(0), u16(0), u16(0), matrix,
                     u32(width << 16), u32(height << 16))
        trak_parts = [tkhd]
        if edit is not None:
            elst = _full(b"elst", 0, 0, u32(1), u32(n * 1000 // 60), u32(edit), u32(0x10000))
            trak_parts.append(_box(b"edts", elst))
        trak = _box(b"trak", *trak_parts, mdia)
        mvhd = _full(b"mvhd", 0, 0, u32(0), u32(0), u32(1000), u32(n * 1000 // 60),
                     u32(0x10000), u16(0x100), bytes(10), matrix, bytes(24), u32(2))
        return _box(b"moov", mvhd, trak)

    mdat_len = 8 + len(mdat_payload)
    if moov_first:
        size = len(moov(0))
        m = moov(len(ftyp) + size + 8)
        return ftyp + m + _box(b"mdat", mdat_payload)
    m = moov(len(ftyp) + 8)
    assert mdat_len
    return ftyp + _box(b"mdat", mdat_payload) + m


def write(cfg: Config):
    """``(sps, pps, access_units)`` of the stream ``cfg`` draws."""
    return Writer(cfg).write()


# --------------------------------------------------------------- refusals

# each feature the decoder refuses: the words its message holds
REFUSALS = {
    "chroma_422": "4:2:0",
    "chroma_444": "4:2:0",
    "bit_depth_10": "bit depth",
    "transform_bypass": "lossless transform bypass",
    "slice_groups": "slice groups",
    "arbitrary_slice_order": "arbitrary slice order",
    "sp_slice": "SP and SI slices",
    "si_slice": "SP and SI slices",
    "data_partitioning": "data partitioning",
    "frame_num_gap": "gaps in frame_num",
    "matrix_bt2020": "matrix_coefficients 9",
    "edit_list": "edit list",
    "codec_mp4v": "codecs other than H.264",
    "codec_hevc": "codecs other than H.264",
}


def _slice_header(first_mb, slice_type, frame_num, idr, poc_lsb, cfg):
    """A slice header of an I or P picture and nothing after it (for the
    refusals, which the decoder raises while reading the header)."""
    b = Bits()
    b.ue(first_mb)
    b.ue(slice_type)
    b.ue(0)
    b.u(cfg.log2_max_frame_num, frame_num)
    if idr:
        b.ue(0)
    b.u(cfg.log2_max_poc_lsb, poc_lsb)
    if slice_type % 5 in (0, 3):
        b.u(1, 0)                # num_ref_idx_active_override_flag
        b.u(1, 0)                # ref_pic_list_modification_flag_l0
    if idr:
        b.u(2, 0)
    else:
        b.u(1, 0)                # adaptive_ref_pic_marking_mode_flag
    if slice_type % 5 not in (2, 4):
        b.ue(0)                  # cabac_init_idc
    b.se(0)
    if slice_type % 5 in (3, 4):
        if slice_type % 5 == 3:
            b.u(1, 0)
        b.se(0)
    b.ue(1)                      # disable_deblocking_filter_idc
    b.trailing()
    return nal(2, 5 if idr else 1, b.tobytes())


def header_only(feature: str):
    """``(bytes, suffix)`` of a short stream of the refused ``feature`` (a
    key of :data:`REFUSALS`): parameter sets and a slice header, or a
    picture the writer codes before it."""
    small = dict(width=32, height=32, frames=1, max_slices=1)
    cfg = Config(**small, **{
        "chroma_422": {"chroma_format": 2, "profile": 122},
        "chroma_444": {"chroma_format": 3, "profile": 244},
        "bit_depth_10": {"bit_depth": 10, "profile": 110},
        "transform_bypass": {"bypass": True, "profile": 244},
        "slice_groups": {"slice_groups": 2, "cavlc": True, "profile": 66},
        "matrix_bt2020": {"vui": {"matrix": 9}},
    }.get(feature, {}))
    w = Writer(cfg)
    sps, pps, aus = w.write()
    if feature in ("sp_slice", "si_slice", "data_partitioning", "frame_num_gap"):
        if feature == "data_partitioning":
            extra = nal(2, 2, b"\x80")
        else:
            stype, fn = {"sp_slice": (3, 1), "si_slice": (4, 1), "frame_num_gap": (0, 2)}[feature]
            extra = _slice_header(0, stype, fn, False, 4, cfg)
        aus = aus + [[extra]]
    if feature == "arbitrary_slice_order":
        for seed in range(100):       # the first seed that draws three slices
            sps, pps, aus = Writer(Config(**{**small, "max_slices": 3, "seed": seed})).write()
            if len(aus[0]) == 3:
                break
        aus = [[aus[0][0], aus[0][2], aus[0][1]]]
    if feature == "edit_list":
        return mp4(sps, pps, aus, 32, 32, edit=1), ".mp4"
    if feature.startswith("codec_"):
        return mp4(sps, pps, aus, 32, 32, codec=b"mp4v" if feature == "codec_mp4v"
                   else b"hvc1"), ".mp4"
    return annexb(sps, pps, aus), ".h264"


# ---------------------------------------------------------- sample streams


def pcm_stream(frames, vui=None):
    """An MP4 of progressive IDR pictures of I_PCM macroblocks (Baseline,
    CAVLC, no deblocking) holding the samples ``frames``, each ``(Y, U, V)``
    uint8 planes of one size (even), padded to whole macroblocks and cropped
    back; ``vui`` as :class:`Config`'s. A decoder returns the samples
    themselves, so cv2 reading it converts them to BGR as it converts any
    progressive frame."""
    h, w = frames[0][0].shape
    c = Config(width=w, height=h, profile=66, cavlc=True, transform8x8=False, vui=vui,
               max_refs=1, log2_max_frame_num=4, log2_max_poc_lsb=4)
    wr = Writer(c)
    mbw, mbh = wr.mbw, wr.mbh
    aus = []
    for i, (y, u, v) in enumerate(frames):
        planes = []
        for p, s in ((y, 16), (u, 8), (v, 8)):
            full = np.zeros((mbh * s, mbw * s), np.uint8)
            full[:p.shape[0], :p.shape[1]] = p
            planes.append(full)
        b = Bits()
        b.ue(0)                  # first_mb_in_slice
        b.ue(7)                  # I, every slice of the picture
        b.ue(0)
        b.u(4, 0)                # frame_num
        b.ue(i % 2)              # idr_pic_id
        b.u(4, 0)                # pic_order_cnt_lsb
        b.u(1, 0)                # no_output_of_prior_pics_flag
        b.u(1, 0)                # long_term_reference_flag
        b.se(0)                  # slice_qp_delta
        b.ue(1)                  # disable_deblocking_filter_idc
        for my in range(mbh):
            for mx in range(mbw):
                b.ue(25)         # I_PCM
                while len(b.bits) % 8:
                    b.bits.append(0)
                for p, s in zip(planes, (16, 8, 8)):
                    blk = p[my * s:(my + 1) * s, mx * s:(mx + 1) * s]
                    b.bits.extend(np.unpackbits(blk.reshape(-1)).tolist())
        b.trailing()
        aus.append([nal(3, 5, b.tobytes())])
    return mp4(wr.sps(), wr.pps(), aus, w, h)
