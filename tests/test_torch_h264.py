"""The port's H.264 decoder (``native/h264.cpp``, ``utils/video.py``) bit
for bit against cv2's ``VideoCapture`` (FFmpeg's libavcodec and
libswscale), and the committed fixtures of ``tests/torch_fixtures/h264``.

- The fixtures: streams ``tests/h264_writer.py`` writes (CABAC and CAVLC,
  I, P and B slices) that between them hold every intra mode and partition, the 8x8
  transform, scaling lists by both fall-back rules, explicit weights,
  several references with list modifications, MMCO 1-6 and long-term
  references, several slices with each deblocking control, POC types 0, 1
  and 2 with the wraps of ``frame_num`` and ``pic_order_cnt_lsb``, a reorder
  buffer with and without the VUI's ``max_num_reorder_frames``, cropping,
  the VUI colour variants cv2 converts, the MP4 forms (``moov`` first or
  last, ``co64``, ``stz2``, 1-, 2- and 4-byte NAL lengths) and Annex-B; and
  B slices: every B macroblock and sub-macroblock type, B_Skip, spatial and
  temporal direct prediction (with and without ``direct_8x8_inference``,
  co-located intra blocks, a long-term first list-1 picture), referenced B
  pictures with memory management and list-1 modifications, list 1 equal to
  list 0, and explicit and implicit bi-predictive weights with the latter's
  fall-backs. Each decodes to cv2's committed BGR frames and to cv2's
  decode here, frame by frame with the same count; the writer rewrites some
  of them byte for byte; together they code every CABAC context an I, P or
  B slice of a progressive 4:2:0 stream reaches, and the CAVLC ones every
  table class (coeff_token by nC, total_zeros, run_before, each
  suffixLength, level_prefix 14, 15 and above).
- Interlace (``frame_mbs_only_flag`` 0): fixtures of frame pictures, of
  field pairs (I, P and B, either parity first, field marking and lists,
  POC types 0-2, reorder buffers, unpaired fields) and of both mixed, with
  CABAC and CAVLC, and sixteen random streams of each coding. cv2 returns
  no decode of a frame coded as two fields (its libswscale refuses a frame
  libavcodec flags interlaced): such frames are held to the samples of
  cv2's own libavcodec (``tests/avcodec_oracle.py``) and to cv2's
  conversion of them; frames coded as frames to cv2's frames. MBAFF
  frames (``FIXTURES_MBAFF``) are held to the same in
  ``tests/test_torch_h264_mbaff.py``.
- Temporal direct prediction from a reference picture whose two slices
  order list 0 differently decodes as its twin coded on one list, where
  libavcodec, keeping one set of lists a picture, does not.
- CAVLC: sixteen random streams over the Baseline, Main and High profiles;
  streams coded with CAVLC from a CABAC stream's draws decode to its
  pictures; an 8x8 block of cbp bit 1 and four empty parses deblocks as
  libavcodec deblocks it under both of its loop filters.
- Sixteen more streams of random syntax of I and P slices and sixteen with
  B slices, each against cv2; and streams coded out of display order whose
  frames come out in cv2's order (FFmpeg grows its reorder buffer as it
  meets such pictures and drops one whose turn has passed).
- Each feature out of scope raises ``NotImplementedError`` naming it, on a
  stream of its parameter sets and a slice header; a truncated stream
  raises ``ValueError``.
- A left crop that is not a multiple of 64 luma samples is the standard's
  crop of the uncropped frame (cv2 rescales such a frame: FFmpeg keeps
  the frame's alignment).
- ``chip_smoke.py`` phase 18 on the CPU: (a) as on the card, (b) and (c)
  at a small size.
"""

import os
import tempfile

import cv2
import numpy as np
import pytest

import chip_smoke as CS
from fourdgs_tpu_torch.utils import video
from tests import avcodec_oracle as AO
from tests import h264_writer as HW
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

H264_FIXTURES = CS.H264_FIXTURES

# name: (Config fields, container, container options). Sizes are no
# multiples of 16, and the crops cover every side (a left one of 64).
_SL4 = [list(range(6, 22)), None, [40] * 8 + [9] * 8, "default", None,
        list(range(60, 12, -3)), list(range(8, 72)), None]
FIXTURES = {
    "intra": (dict(width=58, height=42, crop=(0, 4, 2, 0), frames=3, p_intra_pic=1.0,
                   p_pcm=0.06, p_i16=0.35, max_slices=3, qp_range=(0, 51), p_qpd=0.5),
              "mp4", {}),
    "intra_main": (dict(width=46, height=34, frames=3, profile=77, transform8x8=False,
                        p_intra_pic=1.0, qp_range=(4, 30)), "mp4", {}),
    "inter": (dict(width=74, height=38, frames=8, num_ref_default=2, max_refs=4,
                   p_modify=0.4, p_far_mv=0.15, p_skip=0.3, qp_range=(10, 40)), "mp4", {}),
    "inter_main": (dict(width=42, height=26, frames=6, profile=77, transform8x8=False,
                        max_refs=2, p_far_mv=0.1), "mp4", {}),
    "weights": (dict(width=50, height=34, frames=6, weighted=True, num_ref_default=3,
                     max_refs=3, chroma_qp_offset=-5, second_chroma_qp_offset=7,
                     constrained_intra=True, p_intra_in_p=0.3), "mp4", {}),
    "scaling_sps": (dict(width=42, height=30, frames=4, sps_scaling=_SL4, qp_range=(0, 36)),
                    "mp4", {}),
    "scaling_pps": (dict(width=38, height=30, frames=4, sps_scaling=["default"] * 8,
                         pps_scaling=[None, [20] * 16, None, list(range(30, 14, -1)), None,
                                      None, None, list(range(70, 6, -1))],
                         qp_range=(0, 36)), "mp4", {"moov_first": True}),
    "scaling_pps_flat_sps": (dict(width=38, height=22, frames=4,
                                  pps_scaling=[[24] * 16, None, None, None, [9] * 16, None,
                                               "default", None], qp_range=(0, 30)),
                             "mp4", {}),
    "mmco": (dict(width=34, height=18, frames=24, p_mmco=0.6, p_modify=0.5, p_nonref=0.3,
                  max_refs=4, num_ref_default=2, log2_max_frame_num=4, log2_max_poc_lsb=4,
                  p_idr=0.05), "mp4", {"co64": True}),
    "poc1": (dict(width=36, height=26, frames=10, poc_type=1, p_nonref=0.4, bottom_poc=True,
                  log2_max_frame_num=4), "h264", {}),
    "poc2": (dict(width=36, height=26, frames=10, poc_type=2, p_nonref=0.4, p_idr=0.2),
             "mp4", {"stz2": True, "length_size": 2}),
    "reorder": (dict(width=40, height=22, frames=10, reorder=True, p_nonref=0.5,
                     bottom_poc=True, vui={"reorder": 1}), "mp4", {}),
    "slices": (dict(width=90, height=46, frames=3, max_slices=9, filter_idcs=(0, 1, 2),
                    qp_range=(20, 51), p_qpd=0.5), "mp4", {}),
    "bt709": (dict(width=44, height=28, frames=3, vui={"matrix": 1, "hrd": True},
                   p_pcm=0.2), "mp4", {}),
    "full_range": (dict(width=44, height=28, frames=3, vui={"full_range": 1}, p_pcm=0.2),
                   "mp4", {}),
    "fcc_full": (dict(width=28, height=20, frames=2, vui={"matrix": 4, "full_range": 1},
                      p_pcm=0.2), "mp4", {}),
    "smpte240m": (dict(width=28, height=20, frames=2, vui={"matrix": 7}, p_pcm=0.2),
                  "mp4", {}),
    "crop_left64": (dict(width=40, height=22, crop=(64, 6, 4, 2), frames=3), "mp4", {}),
    "annexb_idr": (dict(width=30, height=20, frames=6, p_idr=0.3), "h264", {}),
    "nal_len1": (dict(width=16, height=14, frames=3, max_slices=2, qp_range=(36, 51)),
                 "mp4", {"length_size": 1, "chunk": 1}),
}
# the streams of B slices, and one coded out of display order without the
# VUI's bitstream_restriction; each names its seed
FIXTURES_B = {
    "reorder_novui": (dict(seed=0, width=40, height=22, frames=10, reorder=True, p_nonref=0.5),
                      "mp4", {}),
    "b_spatial": (dict(seed=24, width=64, height=48, frames=12, b_frames=3, max_slices=3,
                       p_skip=0.06, p_direct=0.06, p_intra_in_p=0.05, max_refs=3,
                       num_ref_default=2, p_i16=0.6), "mp4", {}),
    "b_temporal": (dict(seed=0, width=64, height=48, frames=12, b_frames=2, direct_spatial=False,
                        p_intra_in_p=0.25, p_mmco=0.6, p_modify=0.5, max_refs=4, p_direct=0.3,
                        p_skip=0.3), "mp4", {}),
    "b_temporal_4x4": (dict(seed=0, width=64, height=48, frames=10, b_frames=2,
                            direct_spatial=False, direct_8x8_inference=False, p_intra_in_p=0.25,
                            p_direct=0.3, p_skip=0.3, max_refs=3), "mp4", {}),
    "b_pyramid": (dict(seed=0, width=48, height=32, frames=12, b_frames=3, b_pyramid=True,
                       p_mmco=0.5, p_modify=0.5, max_refs=4, num_ref_l1_default=2,
                       p_b_anchor=0.4, direct_spatial=None), "mp4", {}),
    "b_weights_explicit": (dict(seed=0, width=48, height=32, frames=10, b_frames=2,
                                weighted_bipred=1, weighted=True, max_refs=3, num_ref_default=2),
                           "mp4", {}),
    "b_weights_implicit": (dict(seed=3, width=48, height=32, frames=12, b_frames=3,
                                weighted_bipred=2, p_b_anchor=0.5, p_mmco=0.5, p_modify=0.5,
                                max_refs=4, max_slices=2), "mp4", {}),
    "b_novui": (dict(seed=0, width=44, height=30, crop=(0, 0, 2, 0), frames=9, b_frames=3,
                     p_idr=0.15, p_b_slice_mix=0.3, max_slices=2), "h264", {}),
}
# the streams coded with CAVLC (entropy_coding_mode_flag 0), each naming its
# seed: Baseline intra pictures of each type at QPs down to 0 (level_prefix
# 14 and 15); Baseline P pictures with P_8x8ref0, te(v) over lists of 1-4
# entries, skip runs that end slices, several slices and constrained intra
# prediction; High with the 8x8 transform, an 8x8 block of cbp bit 1 and
# four empty parses and scaling lists of small weights (level_prefix above
# 15, suffixLength 6); Main B pictures (spatial and temporal direct, B_8x8,
# explicit weights); and Annex-B
_SMALL = [[1, 2, 2, 3] * 4, None, None, [2] * 16, None, None, [1] * 64, [2, 1] * 32]
FIXTURES_CAVLC = {
    "cavlc_intra": (dict(seed=0, cavlc=True, profile=66, transform8x8=False, width=58, height=42,
                         frames=3, p_intra_pic=1.0, p_pcm=0.06, p_i16=0.35, max_slices=3,
                         qp_range=(0, 51), p_qpd=0.5, max_level=2000), "mp4", {}),
    "cavlc_inter": (dict(seed=0, cavlc=True, profile=66, transform8x8=False, width=74, height=38,
                         frames=8, num_ref_default=2, max_refs=4, p_modify=0.4, p_far_mv=0.15,
                         p_skip=0.35, max_slices=4, constrained_intra=True, p_intra_in_p=0.2,
                         p_8x8ref0=0.4, qp_range=(10, 40)), "mp4", {}),
    "cavlc_t8": (dict(seed=0, cavlc=True, profile=100, width=50, height=34, frames=4,
                      sps_scaling=_SMALL, qp_range=(0, 12), max_level=8000, level_bound=4000,
                      p_empty8x8=0.15), "mp4", {}),
    "cavlc_b": (dict(seed=0, cavlc=True, profile=77, transform8x8=False, width=64, height=48,
                     frames=10, b_frames=2, direct_spatial=None, weighted_bipred=1, weighted=True,
                     max_refs=3, num_ref_default=2, p_direct=0.2, p_skip=0.2), "mp4", {}),
    "cavlc_annexb": (dict(seed=0, cavlc=True, profile=66, transform8x8=False, width=30,
                          height=20, frames=6, p_idr=0.3), "h264", {}),
}
# the streams with frame_mbs_only_flag 0, each naming its seed: frames
# coded as frames only (x264's fake-interlaced form, a bottom crop of 4);
# I/I and I/P field pairs of both parities first; P fields over several
# references with list modifications, MMCO 1-4 and 6 on fields and
# long-term fields; B field pairs with spatial and temporal direct and
# implicit weights; frames and field pairs mixed (PAFF) with temporal
# direct across the two structures; POC types 1 and 2 in fields; fields out
# of display order without the VUI's bitstream_restriction and with it;
# unpaired fields; mb_adaptive_frame_field_flag 1 with field pictures only;
# and CAVLC forms of these
_I = dict(frame_mbs_only=False)
_F = dict(frame_mbs_only=False, field_pics=1.0)
FIXTURES_FIELD = {
    "fake_interlaced": (dict(seed=0, **_I, width=44, height=60, frames=8, b_frames=2,
                             direct_spatial=False, max_refs=3, num_ref_default=2, p_modify=0.4,
                             bottom_poc=True), "mp4", {}),
    "field_intra": (dict(seed=1, **_F, width=40, height=44, frames=4, p_intra_pic=1.0,
                         p_bottom_first=0.5, p_pcm=0.08, max_slices=3, qp_range=(0, 51)), "mp4", {}),
    "field_ip": (dict(seed=0, **_F, width=48, height=32, frames=8, p_idr=0.4, p_bottom_first=0.5,
                      num_ref_default=2, max_refs=3, p_skip=0.3), "mp4", {}),
    "field_mmco": (dict(seed=0, **_F, width=32, height=32, frames=14, p_mmco=0.6, p_modify=0.5,
                        max_refs=4, num_ref_default=3, p_bottom_first=0.3, weighted=True),
                   "mp4", {}),
    "field_b_spatial": (dict(seed=0, **_F, width=48, height=32, frames=9, b_frames=2,
                             b_pyramid=True, p_direct=0.3, p_skip=0.3, max_refs=4,
                             num_ref_default=2, num_ref_l1_default=2, p_bottom_first=0.5),
                        "mp4", {}),
    "field_b_temporal": (dict(seed=0, **_F, width=48, height=32, frames=9, b_frames=3,
                              direct_spatial=False, weighted_bipred=2, p_direct=0.4, p_skip=0.3,
                              max_refs=3, p_mmco=0.4, p_modify=0.4), "mp4", {}),
    "paff_temporal": (dict(seed=2, **_I, field_pics=0.5, width=48, height=32, frames=12,
                           b_frames=2, direct_spatial=False, p_direct=0.4, p_skip=0.3,
                           p_bottom_first=0.5, max_refs=3, num_ref_default=2), "mp4", {}),
    "field_poc1": (dict(seed=0, **_F, width=32, height=32, frames=8, poc_type=1, poc1_t2b=1,
                        p_nonref=0.4), "h264", {}),
    "field_poc2": (dict(seed=0, **_F, width=32, height=32, frames=8, poc_type=2, p_nonref=0.4,
                        p_idr=0.2), "mp4", {}),
    "field_reorder_novui": (dict(seed=0, **_F, width=32, height=32, frames=10, reorder=True,
                                 p_nonref=0.5), "mp4", {}),
    "field_vui": (dict(seed=0, **_F, width=32, height=32, frames=8, b_frames=2,
                       vui={"reorder": 1}), "mp4", {}),
    "field_lone": (dict(seed=0, **_I, field_pics=0.7, width=32, height=32, frames=10,
                        p_nonref=0.5, p_lone=0.8), "mp4", {}),
    "mbaff_fields": (dict(seed=0, **_F, mbaff=True, width=32, height=32, frames=4), "mp4", {}),
    "cavlc_fake_interlaced": (dict(seed=0, **_I, cavlc=True, profile=77, transform8x8=False,
                                   width=44, height=60, frames=6, b_frames=1,
                                   direct_spatial=None), "mp4", {}),
    "cavlc_field_ip": (dict(seed=0, **_F, cavlc=True, profile=77, transform8x8=False, width=48,
                            height=32, frames=8, p_idr=0.3, p_bottom_first=0.5,
                            num_ref_default=2, max_refs=3), "mp4", {}),
    "cavlc_field_mmco": (dict(seed=0, **_F, cavlc=True, profile=100, width=32, height=32,
                              frames=12, p_mmco=0.6, p_modify=0.5, max_refs=4,
                              num_ref_default=3), "mp4", {}),
    "cavlc_field_b": (dict(seed=0, **_F, cavlc=True, profile=77, transform8x8=False, width=48,
                           height=32, frames=8, b_frames=2, direct_spatial=None,
                           weighted_bipred=2, p_direct=0.3), "mp4", {}),
    "cavlc_paff": (dict(seed=0, **_I, cavlc=True, profile=100, field_pics=0.5, width=48,
                        height=32, frames=10, b_frames=2, direct_spatial=False,
                        p_bottom_first=0.5), "h264", {}),
}
# frames of macroblock pairs (mb_adaptive_frame_field_flag 1), each naming
# its seed: I pictures of every intra type and I_PCM in field and frame
# pairs; P pictures over several references with explicit weights and
# constrained intra prediction; MMCO and list modifications; many slices
# deblocked with disable_deblocking_filter_idc 2; B pictures with spatial
# direct and explicit weights, and with temporal direct and implicit
# weights among field pairs (co-location from an MBAFF frame and from a
# field pair, and a field's from an MBAFF frame); CAVLC I, P and B
# (P_8x8ref0, empty 8x8 parses); and MBAFF frames mixed with field pairs
_A = dict(frame_mbs_only=False, mbaff=True)
FIXTURES_MBAFF = {
    "mbaff_intra": (dict(seed=0, **_A, width=48, height=48, frames=3, p_intra_pic=1.0,
                         p_pcm=0.06, p_i16=0.35, max_slices=3, qp_range=(0, 51)), "mp4", {}),
    "mbaff_ip": (dict(seed=0, **_A, p_field_mb=0.6, width=48, height=48, frames=6,
                      num_ref_default=2, max_refs=3,
                      weighted=True, constrained_intra=True, p_intra_in_p=0.3, p_skip=0.3,
                      chroma_qp_offset=-3), "mp4", {}),
    "mbaff_mmco": (dict(seed=0, **_A, width=32, height=32, frames=12, p_mmco=0.6, p_modify=0.5,
                        max_refs=4, num_ref_default=3, p_nonref=0.3), "mp4", {}),
    "mbaff_slices": (dict(seed=0, **_A, width=64, height=32, frames=4, max_slices=6,
                          filter_idcs=(2,), qp_range=(24, 51)), "mp4", {}),
    "mbaff_b_spatial": (dict(seed=0, **_A, width=48, height=32, frames=9, b_frames=2,
                             b_pyramid=True, p_direct=0.3, p_skip=0.3, max_refs=4,
                             num_ref_default=2, num_ref_l1_default=2, weighted_bipred=1,
                             weighted=True), "mp4", {}),
    "mbaff_b_temporal": (dict(seed=5, **_A, field_pics=0.4, width=48, height=32, frames=12,
                              b_frames=2, direct_spatial=False, weighted_bipred=2, p_direct=0.4,
                              p_skip=0.3, max_refs=3, p_bottom_first=0.5), "mp4", {}),
    "cavlc_mbaff": (dict(seed=0, **_A, cavlc=True, profile=100, width=48, height=32, frames=8,
                         b_frames=2, direct_spatial=None, p_8x8ref0=0.3, p_empty8x8=0.2,
                         weighted_bipred=2), "mp4", {}),
    "mbaff_paff": (dict(seed=0, **_A, field_pics=0.5, width=48, height=48, frames=10,
                        p_bottom_first=0.5, num_ref_default=2, max_refs=3, b_frames=1,
                        direct_spatial=None), "h264", {}),
}
ALL_FIXTURES = {**FIXTURES, **FIXTURES_B, **FIXTURES_CAVLC, **FIXTURES_FIELD, **FIXTURES_MBAFF}
# the CABAC contexts an I, P or B slice of a 4:2:0 stream codes (Table
# 9-34): all of 0-459 but SI's mb_type prefix (0-2) and end_of_slice_flag
# (276); 70-72 are MBAFF's mb_field_decoding_flag, 277-398 and 436-459 those
# of field macroblocks
REACHABLE = set(range(3, 276)) | set(range(277, 460))


def fixture_config(name, seed_base=180):
    if name not in FIXTURES:
        return HW.Config(**ALL_FIXTURES[name][0])
    fields, _, _ = FIXTURES[name]
    return HW.Config(seed=seed_base + sorted(FIXTURES).index(name), **fields)


def fixture_stream(name):
    """The fixture ``name``'s ``(sps, pps, access units)`` and its writer."""
    w = HW.Writer(fixture_config(name))
    return w.write(), w


def fixture_bytes(name):
    """The fixture ``name`` as the writer writes it, and the writer."""
    _, kind, options = ALL_FIXTURES[name]
    (sps, pps, aus), w = fixture_stream(name)
    if kind == "h264":
        return HW.annexb(sps, pps, aus), w
    return HW.mp4(sps, pps, aus, w.c.width, w.c.height, **options), w


def has_fields(w) -> bool:
    """Whether the writer ``w`` coded a field picture or an MBAFF frame
    (whose frames libavcodec flags interlaced, and cv2 returns none of)."""
    return w.counts["field_pairs"] + w.counts["lone"] + w.counts["mbaff_frames"] > 0


def avcodec_planes(stream):
    """cv2's libavcodec's decode of ``(sps, pps, access units)`` as planes."""
    return AO.decode(AO.annexb_packets(*stream))


def field_reference(stream, vui):
    """The frames of ``stream`` (which codes field pictures, which cv2
    returns none of) as cv2 converts libavcodec's decode of them (an I_PCM
    stream of its samples, read by cv2), and that decode's planes."""
    planes = avcodec_planes(stream)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pcm.mp4")
        with open(path, "wb") as f:
            f.write(HW.pcm_stream(planes, vui))
        return cv2_frames(path), planes


def fixture_path(name):
    return os.path.join(H264_FIXTURES, name + "." + ALL_FIXTURES[name][1])


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def write_committed_fixtures(out_dir=H264_FIXTURES):
    """Write ``tests/torch_fixtures/h264``: each stream of
    :data:`ALL_FIXTURES` and ``cv2_decode.npz``, cv2's BGR frames of each by
    name ([frames, H, W, 3]); of a stream that codes field pictures, cv2's
    conversion of libavcodec's decode (:func:`field_reference`)."""
    os.makedirs(out_dir, exist_ok=True)
    decodes = {}
    for name in sorted(ALL_FIXTURES):
        data, w = fixture_bytes(name)
        path = os.path.join(out_dir, name + "." + ALL_FIXTURES[name][1])
        with open(path, "wb") as f:
            f.write(data)
        live = cv2_frames(path)
        if has_fields(w):
            frames, _ = field_reference(fixture_stream(name)[0], w.c.vui)
            assert len(frames) == len(live), name
            live = frames
        decodes[name] = np.stack(live)
    np.savez_compressed(os.path.join(out_dir, "cv2_decode.npz"), **decodes)


@pytest.fixture(scope="module")
def committed():
    with np.load(os.path.join(H264_FIXTURES, "cv2_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def _same_planes(got, want, what=""):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        for p in range(3):
            np.testing.assert_array_equal(a[p], b[p], err_msg=f"{what} frame {i} plane {p}")


@pytest.mark.parametrize("name", sorted(set(ALL_FIXTURES) - set(FIXTURES_MBAFF)))
def test_fixture_matches_cv2(name, committed):
    """Each fixture's frames: cv2's committed decode, and cv2's live one in
    number and, of each frame coded as a frame, in value; a frame coded as
    two fields (which cv2 returns none of) has libavcodec's samples."""
    path = fixture_path(name)
    stats = []
    got = np.stack(list(video.read_frames(path, bgr=True, stats=stats)))
    want = committed[name]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    live = cv2_frames(path)
    assert len(live) == len(got)
    for i, frame in enumerate(live):
        if len(stats[i][0]) == 1:
            np.testing.assert_array_equal(got[i], frame, err_msg=f"{name} frame {i}")
    if name in FIXTURES_FIELD and any(len(k) == 2 for k, _ in stats):
        _same_planes(list(video.read_frames(path, planes=True)),
                     avcodec_planes(fixture_stream(name)[0]), name)
    rgb = np.stack(list(video.read_frames(path)))
    np.testing.assert_array_equal(rgb, got[..., ::-1])


@pytest.mark.parametrize("name", ["intra", "mmco", "poc1", "scaling_pps",
                                  *sorted(FIXTURES_CAVLC), "field_mmco", "cavlc_paff"])
def test_writer_rewrites_fixture(name):
    data, _ = fixture_bytes(name)
    with open(fixture_path(name), "rb") as f:
        assert f.read() == data


@pytest.mark.parametrize("name", ["b_spatial", "b_pyramid", "reorder_novui"])
def test_writer_rewrites_b_fixture(name):
    data, _ = fixture_bytes(name)
    with open(fixture_path(name), "rb") as f:
        assert f.read() == data


def test_fixtures_code_every_context():
    used, tables, field = set(), set(), set()
    for name in ALL_FIXTURES:
        _, w = fixture_stream(name)
        for table, ctxs in w.contexts.items():
            used |= ctxs
            tables.add(table)
            if name in FIXTURES_FIELD:
                field |= ctxs
    assert tables == {0, 1, 2, 3}           # I slices and cabac_init_idc 0, 1 and 2
    assert not REACHABLE - used, sorted(REACHABLE - used)
    assert used <= REACHABLE
    # the field macroblocks' significance contexts, from the field streams
    assert set(range(277, 399)) | set(range(436, 460)) <= field


# the CAVLC table classes an I, P or B slice of a progressive 4:2:0 stream
# codes (§9.2): coeff_token by nC 0-1, 2-3, 4-7, 8 and above and -1 (chroma
# DC); total_zeros by tzVlcIndex (1-15, chroma DC 1-3); run_before by
# zerosLeft (1-6, above 6 as 7); each suffixLength; level_prefix 14, 15 and
# above 15 (as 16)
CAVLC_CLASSES = ({("coeff_token", k) for k in range(5)}
                 | {("total_zeros", k) for k in range(1, 16)}
                 | {("total_zeros_dc", k) for k in range(1, 4)}
                 | {("run_before", k) for k in range(1, 8)}
                 | {("suffix_length", k) for k in range(7)}
                 | {("level_prefix", k) for k in (14, 15, 16)})


def test_cavlc_fixtures_code_every_table():
    used = set()
    for name in FIXTURES_CAVLC:
        _, w = fixture_bytes(name)
        used |= w.tables
    assert not CAVLC_CLASSES - used, sorted(CAVLC_CLASSES - used)
    _, w = fixture_bytes("cavlc_inter")
    assert {n for kind, n in w.tables if kind == "te"} >= {2, 4}   # te(v): 1 bit, and ue(v)
    assert w.counts["8x8ref0"] > 0
    _, w = fixture_bytes("cavlc_t8")
    assert w.counts["empty8x8"] > 0


def _random_config(seed):
    rng = np.random.default_rng(seed)
    return HW.Config(
        seed=seed, frames=int(rng.integers(2, 7)), width=int(rng.choice([18, 36, 52, 70])),
        height=int(rng.choice([14, 30, 46])), weighted=bool(rng.random() < 0.4),
        num_ref_default=int(rng.integers(1, 4)), p_mmco=float(rng.choice([0, 0.5])),
        p_modify=float(rng.choice([0, 0.4])), p_nonref=float(rng.choice([0, 0.3])),
        max_refs=int(rng.integers(1, 5)), constrained_intra=bool(rng.random() < 0.3),
        chroma_qp_offset=int(rng.integers(-12, 13)),
        second_chroma_qp_offset=int(rng.integers(-12, 13)),
        qp_range=[(12, 44), (0, 51), (40, 51), (0, 15)][int(rng.integers(4))],
        p_far_mv=float(rng.choice([0, 0.3])), poc_type=int(rng.choice([0, 1, 2])),
        p_skip=float(rng.random() * 0.6), p_pcm=float(rng.random() * 0.1),
        transform8x8=bool(rng.random() < 0.7), max_slices=int(rng.integers(1, 6)),
        max_level=int(rng.choice([4, 40, 2000])))


def _same_as_cv2(tmp_path, cfg, count=None):
    """The stream ``cfg`` draws as MP4: the port's frames equal cv2's, in
    cv2's order and number (``count`` where given)."""
    sps, pps, aus = HW.write(cfg)
    path = tmp_path / "r.mp4"
    path.write_bytes(HW.mp4(sps, pps, aus, cfg.width, cfg.height))
    got = list(video.read_frames(str(path), bgr=True))
    want = cv2_frames(path)
    assert len(got) == len(want), (len(got), len(want))
    if count is not None:
        assert len(got) == count
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


@pytest.mark.parametrize("seed", range(16))
def test_random_streams_match_cv2(tmp_path, seed):
    cfg = _random_config(seed)
    _same_as_cv2(tmp_path, cfg, count=cfg.frames)


def _random_b_config(seed):
    rng = np.random.default_rng(1000 + seed)
    return HW.Config(
        seed=seed, frames=int(rng.integers(4, 10)), width=int(rng.choice([18, 36, 52, 70])),
        height=int(rng.choice([14, 30, 46])), b_frames=int(rng.integers(1, 4)),
        b_pyramid=bool(rng.random() < 0.5), direct_spatial=[True, False, None][int(rng.integers(3))],
        weighted_bipred=int(rng.integers(0, 3)), weighted=bool(rng.random() < 0.3),
        direct_8x8_inference=bool(rng.random() < 0.6), num_ref_default=int(rng.integers(1, 4)),
        num_ref_l1_default=int(rng.integers(1, 3)), p_mmco=float(rng.choice([0, 0.5])),
        p_modify=float(rng.choice([0, 0.4])), max_refs=int(rng.integers(2, 6)),
        constrained_intra=bool(rng.random() < 0.2),
        qp_range=[(12, 44), (0, 51), (30, 51)][int(rng.integers(3))],
        p_far_mv=float(rng.choice([0, 0.2])), p_skip=float(rng.random() * 0.5),
        p_direct=float(rng.random() * 0.4), p_intra_in_p=float(rng.random() * 0.2),
        transform8x8=bool(rng.random() < 0.7), max_slices=int(rng.integers(1, 5)),
        p_b_slice_mix=float(rng.choice([0, 0.3])), p_b_anchor=float(rng.choice([0, 0.4])),
        p_idr=float(rng.choice([0, 0.2])), bottom_poc=bool(rng.random() < 0.3),
        log2_max_frame_num=int(rng.integers(4, 6)))


@pytest.mark.parametrize("seed", range(16))
def test_random_b_streams_match_cv2(tmp_path, seed):
    _same_as_cv2(tmp_path, _random_b_config(seed))


def _random_cavlc_config(seed):
    """CAVLC streams as the random CABAC ones draw them, over the Baseline
    (I and P, no weights), Main (B pictures, weights) and High (the 8x8
    transform, scaling lists of small weights, empty 8x8 parses) profiles."""
    rng = np.random.default_rng(3000 + seed)
    profile = (66, 77, 100)[seed % 3]
    b_frames = int(rng.integers(1, 4)) if profile != 66 and rng.random() < 0.6 else 0
    high = profile == 100
    scaling = None
    if high and rng.random() < 0.4:
        scaling = [[int(v) for v in rng.integers(1, 6, 16 if i < 6 else 64)] for i in range(8)]
    return HW.Config(
        cavlc=True, profile=profile, seed=seed, frames=int(rng.integers(3, 8)),
        width=int(rng.choice([18, 36, 52, 70])), height=int(rng.choice([14, 30, 46])),
        transform8x8=high and bool(rng.random() < 0.7),
        weighted=profile != 66 and bool(rng.random() < 0.3), b_frames=b_frames,
        direct_spatial=[True, False, None][int(rng.integers(3))],
        weighted_bipred=int(rng.integers(0, 3)) if profile != 66 else 0,
        direct_8x8_inference=high or bool(rng.random() < 0.6),
        num_ref_default=int(rng.integers(1, 4)), num_ref_l1_default=int(rng.integers(1, 3)),
        p_mmco=float(rng.choice([0, 0.5])), p_modify=float(rng.choice([0, 0.4])),
        max_refs=int(rng.integers(2, 6)), constrained_intra=bool(rng.random() < 0.3),
        qp_range=[(12, 44), (0, 51), (0, 15), (30, 51)][int(rng.integers(4))],
        p_far_mv=float(rng.choice([0, 0.2])), p_skip=float(rng.random() * 0.6),
        p_pcm=float(rng.random() * 0.1), max_slices=int(rng.integers(1, 6)),
        max_level=int(rng.choice([4, 40, 2000, 5000])), p_8x8ref0=float(rng.choice([0, 0.5])),
        p_empty8x8=float(rng.choice([0, 0.3])) if high else 0.0, sps_scaling=scaling,
        level_bound=4000 if scaling else 2000,
        p_nonref=float(rng.choice([0, 0.3])) if not b_frames else 0.0,
        p_idr=float(rng.choice([0, 0.2])),
        poc_type=int(rng.choice([0, 1, 2])) if not b_frames else 0,
        chroma_qp_offset=int(rng.integers(-12, 13)),
        second_chroma_qp_offset=int(rng.integers(-12, 13)) if high else 0)


@pytest.mark.parametrize("seed", range(16))
def test_random_cavlc_streams_match_cv2(tmp_path, seed):
    _same_as_cv2(tmp_path, _random_cavlc_config(seed))


def _random_field_config(seed, cavlc):
    """Streams with frame_mbs_only_flag 0 as the random ones draw them:
    field pairs of either parity first, frames among them (PAFF) or none,
    B pictures with spatial or temporal direct and each weighting, POC
    types 0-2, several references, modifications and MMCOs."""
    rng = np.random.default_rng(5000 + seed + 100 * cavlc)
    b_frames = int(rng.integers(1, 4)) if rng.random() < 0.5 else 0
    profile = 77 if cavlc and rng.random() < 0.5 else 100
    return HW.Config(
        seed=seed, cavlc=cavlc, profile=profile, frame_mbs_only=False,
        field_pics=float(rng.choice([1.0, 0.5, 0.8])),
        p_bottom_first=float(rng.choice([0, 0.5, 1.0])), frames=int(rng.integers(3, 9)),
        width=int(rng.choice([16, 32, 48, 64])), height=int(rng.choice([32, 48, 64, 28, 44])),
        transform8x8=profile == 100 and bool(rng.random() < 0.7),
        weighted=bool(rng.random() < 0.3), b_frames=b_frames, b_pyramid=bool(rng.random() < 0.5),
        direct_spatial=[True, False, None][int(rng.integers(3))],
        weighted_bipred=int(rng.integers(0, 3)), num_ref_default=int(rng.integers(1, 4)),
        num_ref_l1_default=int(rng.integers(1, 3)), p_mmco=float(rng.choice([0, 0.5])),
        p_modify=float(rng.choice([0, 0.4])), max_refs=int(rng.integers(2, 6)),
        constrained_intra=bool(rng.random() < 0.2),
        qp_range=[(12, 44), (0, 51), (30, 51)][int(rng.integers(3))],
        p_far_mv=float(rng.choice([0, 0.2])), p_skip=float(rng.random() * 0.5),
        p_direct=float(rng.random() * 0.4), p_intra_in_p=float(rng.random() * 0.2),
        max_slices=int(rng.integers(1, 4)), p_b_slice_mix=float(rng.choice([0, 0.3])),
        p_b_anchor=float(rng.choice([0, 0.4])), p_idr=float(rng.choice([0, 0.2])),
        bottom_poc=bool(rng.random() < 0.3),
        p_nonref=0.0 if b_frames else float(rng.choice([0, 0.3])),
        poc_type=0 if b_frames else int(rng.choice([0, 1, 2])), poc1_t2b=1,
        chroma_qp_offset=int(rng.integers(-6, 7)))


def _same_as_avcodec(tmp_path, cfg):
    """The stream ``cfg`` draws as MP4: the port's frames have the samples
    of cv2's libavcodec, as many as cv2 returns, and each frame coded as a
    frame is cv2's BGR frame (but an MBAFF one, which cv2 returns none of)."""
    stream = HW.write(cfg)
    path = tmp_path / "f.mp4"
    path.write_bytes(HW.mp4(*stream, cfg.width, cfg.height))
    stats = []
    got = list(video.read_frames(str(path), bgr=True, stats=stats))
    live = cv2_frames(path)
    assert len(got) == len(live)
    for i, (a, b) in enumerate(zip(got, live)):
        if len(stats[i][0]) == 1 and not cfg.mbaff:
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    _same_planes(list(video.read_frames(str(path), planes=True)), avcodec_planes(stream))


@pytest.mark.parametrize("seed", range(8))
def test_random_field_streams_match_cv2(tmp_path, seed):
    _same_as_avcodec(tmp_path, _random_field_config(seed, cavlc=False))


@pytest.mark.parametrize("seed", range(8))
def test_random_cavlc_field_streams_match_cv2(tmp_path, seed):
    _same_as_avcodec(tmp_path, _random_field_config(seed, cavlc=True))


def test_cv2_returns_no_frame_coded_as_fields(tmp_path):
    """cv2 returns as many frames as the port for a stream of field pairs,
    but none of them is the decode: libswscale refuses to convert a frame
    libavcodec flags interlaced and cv2 returns a buffer it did not write.
    The port's frames are cv2's conversion of libavcodec's decode."""
    cfg = HW.Config(seed=1, width=48, height=32, frames=4, frame_mbs_only=False, field_pics=1.0)
    stream = HW.write(cfg)
    path = tmp_path / "f.mp4"
    path.write_bytes(HW.mp4(*stream, cfg.width, cfg.height))
    got = list(video.read_frames(str(path), bgr=True))
    live = cv2_frames(path)
    want, _ = field_reference(stream, None)
    assert len(got) == len(live) == len(want) == cfg.frames
    for a, b, c in zip(got, want, live):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def test_mbaff_flag_with_field_pictures_decodes(tmp_path):
    """mb_adaptive_frame_field_flag 1 in a stream of field pictures only
    decodes (the ``mbaff_fields`` fixture); among them frame pictures, which
    MBAFF codes as macroblock pairs, decode to libavcodec's samples."""
    cfg = HW.Config(seed=4, width=32, height=32, frames=6, frame_mbs_only=False, mbaff=True,
                    field_pics=0.5)
    w = HW.Writer(cfg)
    w.write()
    assert 0 < w.counts["field_pairs"] < cfg.frames       # a frame picture among the fields
    assert w.counts["mbaff_frames"] > 0
    _same_as_avcodec(tmp_path, cfg)


@pytest.mark.parametrize("structure", ["frame", "field"])
def test_temporal_direct_reads_each_slices_lists(tmp_path, structure):
    """A reference P picture of two slices whose list 0 orders differ, and
    B pictures that predict from it in temporal direct mode; and its twin,
    the first slice coded on the second's list with its ref_idx remapped to
    the same pictures. The port decodes both to the same frames (the
    standard reads each co-located block's reference in its own slice's
    list); cv2 decodes the twin to those frames and the original otherwise
    (libavcodec keeps one set of lists a picture). Field-coded, the same of
    libavcodec's samples, on one thread and on four."""
    field = structure == "field"
    got, ref = {}, {}
    for mode in (1, 2):
        cfg = HW.Config(seed=0, width=64, height=64 if field else 48, frames=7, b_frames=2,
                        b_full_runs=True, direct_spatial=False, mixed_lists=mode, max_refs=4,
                        num_ref_default=3, p_direct=0.6, p_skip=0.4, p_intra_in_p=0.0,
                        max_slices=1, qp_range=(20, 30), frame_mbs_only=not field,
                        field_pics=float(field))
        stream = HW.write(cfg)
        path = tmp_path / f"t{mode}.mp4"
        path.write_bytes(HW.mp4(*stream, cfg.width, cfg.height))
        if field:
            got[mode] = list(video.read_frames(str(path), planes=True))
            ref[mode] = [AO.decode(AO.annexb_packets(*stream), threads=t) for t in (1, 4)]
        else:
            got[mode] = [(f,) for f in video.read_frames(str(path), bgr=True)]
            ref[mode] = [[(f,) for f in cv2_frames(path)]]
    assert len(got[1]) == len(got[2]) == 7

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x[p], y[p]) for x, y in zip(a, b)
                                        for p in range(len(x)))
    assert same(got[1], got[2])
    for twin, original in zip(ref[2], ref[1]):
        assert same(twin, got[2])
        assert not same(original, got[1])


@pytest.mark.parametrize("offsets", [(0, 0), (2, -1)], ids=["fast_filter", "general_filter"])
def test_cavlc_8x8_empty_block_deblocks_as_cv2(tmp_path, offsets):
    """P pictures whose 8x8-transform blocks of cbp bit 1 are at times four
    empty CAVLC parses, deblocked (disable_deblocking_filter_idc 0, QP
    28-40) beside neighbours across each edge: cv2's frames. An empty block
    is a block without coefficients to the loop filter, as libavcodec keeps
    it (cbp_table bits 12-15), except where its x86 filter, taken under
    equal chroma QP offsets, gives a whole MB bS 2 for cbp bits 0-2 set; a
    decoder that reads the cbp bit, as CABAC may, fails here."""
    cfg = HW.Config(seed=0, cavlc=True, profile=100, width=96, height=64, frames=4,
                    p_empty8x8=0.3, p_intra_in_p=0.05, p_skip=0.1, qp_range=(28, 40),
                    filter_idcs=(0,), chroma_qp_offset=offsets[0],
                    second_chroma_qp_offset=offsets[1])
    w = HW.Writer(cfg)
    w.write()
    assert w.counts["empty8x8"] >= 4
    _same_as_cv2(tmp_path, cfg, count=cfg.frames)


@pytest.mark.parametrize("case", ["intra", "inter", "b", "rows"])
def test_cavlc_codes_cabac_pictures(tmp_path, case):
    """A stream written with CAVLC from the draws of a CABAC one decodes
    to the CABAC one's pictures, each equal to cv2's; also one of repeated
    one-row slices (phase 18's streams), whose I_PCM alignment differs from
    row to row."""
    fields = {"intra": dict(p_intra_pic=1.0, p_pcm=0.1, qp_range=(0, 51)),
              "inter": dict(num_ref_default=3, max_refs=4, p_modify=0.4, weighted=True),
              "b": dict(b_frames=3, b_pyramid=True, direct_spatial=None, weighted_bipred=2),
              "rows": dict(row_repeat=True, p_pcm=0.3, b_frames=2, b_full_runs=True)}[case]
    frames = {}
    for cavlc in (False, True):
        cfg = HW.Config(seed=7, width=52, height=30, frames=6, cavlc=cavlc, **fields)
        _same_as_cv2(tmp_path, cfg)
        frames[cavlc] = np.stack(list(video.read_frames(str(tmp_path / "r.mp4"))))
    np.testing.assert_array_equal(frames[True], frames[False])


# streams coded out of display order: non-reference pictures decoded after
# the next reference one (depth 1), without the VUI's bitstream_restriction;
# runs of 1, 2 and 3 B pictures between IDR pictures; MMCO 5; and a level
# whose MaxDpbMbs holds fewer frames than the depth
ORDER_CASES = {
    **{f"novui_{s}": dict(seed=s, width=40, height=22, frames=10, reorder=True, p_nonref=0.5)
       for s in range(6)},
    "novui_level_10": dict(seed=0, width=368, height=288, level=10, frames=6, reorder=True,
                           p_nonref=0.5, max_slices=1),
    "b1_idr": dict(seed=1, width=32, height=16, frames=12, b_frames=1, p_idr=0.3),
    "b2_idr": dict(seed=2, width=32, height=16, frames=12, b_frames=2, p_idr=0.3),
    "b3_pyramid_idr": dict(seed=3, width=32, height=16, frames=12, b_frames=3, b_pyramid=True,
                           max_refs=4, p_idr=0.2),
    "reorder_mmco5": dict(seed=4, width=32, height=16, frames=14, reorder=True, p_nonref=0.5,
                          p_mmco=0.6, max_refs=3, p_idr=0.1),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_output_order_matches_cv2(tmp_path, case):
    _same_as_cv2(tmp_path, HW.Config(**ORDER_CASES[case]))


@pytest.mark.parametrize("feature", sorted(HW.REFUSALS))
def test_refusals_name_their_feature(tmp_path, feature):
    data, suffix = HW.header_only(feature)
    path = tmp_path / ("f" + suffix)
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=HW.REFUSALS[feature]):
        list(video.read_frames(str(path)))


def test_truncated_stream_raises(tmp_path):
    data, _ = fixture_bytes("inter")
    path = tmp_path / "t.mp4"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))
    path.write_bytes(b"not a video")
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))


def test_unaligned_left_crop_is_the_standard_crop(tmp_path):
    """The same coded pictures with a left crop of 6 and without it: the
    cropped frames are columns 6.. of the uncropped ones. cv2 returns a
    rescaled frame here (FFmpeg keeps the data pointers aligned and leaves
    the crop in; cv2 scales the wider frame to the stream's width)."""
    frames = {}
    for crop, width in (((6, 4, 2, 0), 36), ((0, 4, 2, 0), 42)):
        cfg = HW.Config(seed=3, width=width, height=24, crop=crop, frames=3)
        sps, pps, aus = HW.write(cfg)
        path = tmp_path / f"c{crop[0]}.mp4"
        path.write_bytes(HW.mp4(sps, pps, aus, cfg.width, cfg.height))
        frames[crop[0]] = np.stack(list(video.read_frames(str(path), bgr=True)))
    np.testing.assert_array_equal(frames[6], frames[0][:, :, 6:])
    assert not np.array_equal(np.stack(cv2_frames(tmp_path / "c6.mp4")), frames[6])


def test_chip_smoke_phase_18a_on_cpu(committed):
    out = CS.check_h264_fixtures()
    assert out["files"] == len(ALL_FIXTURES)
    assert out["frames"] == sum(len(committed[n]) for n in ALL_FIXTURES)


def test_chip_smoke_phase_18_on_cpu(monkeypatch, capsys):
    """Phase 18 (b) and (c) on the CPU at a small size: the host's times of
    a row-repeated I, P, B, B stream coded with CABAC and with CAVLC, of
    one coded as field pairs and of one of MBAFF frames, and a scene of
    videos (an MPEG-4 Part 2 one, and one coded as a field pair then MBAFF P
    and B frames) extracted by
    ``load_scene`` then trained on the plain path (the dynerf preset's
    widths cut as ``tests/test_torch_dynerf_cli.py`` cuts them), K1 and K2
    held to their plain versions at a step of its model."""
    import torch

    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.data import scene as tscene
    from fourdgs_tpu_torch.ops import blend
    from tests.test_torch_dynerf_cli import OVERRIDES

    host = CS.check_video_host_times(size=(96, 72), frames=4, target=(48, 36))
    assert all(host[k] > 0 for k in ("decode_ms", "decode_i_ms", "decode_p_ms", "decode_b_ms",
                                     "decode_cavlc_i_ms", "decode_cavlc_p_ms",
                                     "decode_cavlc_b_ms", "decode_fields_ms",
                                     "decode_field_i_ms", "decode_field_p_ms",
                                     "decode_field_b_ms", "decode_pair_ip_ms",
                                     "decode_pair_bb_ms", "decode_mbaff_ms",
                                     "decode_mbaff_i_ms", "decode_mbaff_p_ms", "decode_mbaff_b_ms",
                                     "resize_ms",
                                     "png_ms"))
    codings = []
    row_video = CS.row_video
    monkeypatch.setattr(CS, "row_video", lambda *a, **k: codings.append(
        (k.get("b_frames"), k.get("cavlc"), k.get("fields"), k.get("mbaff"))) or
        row_video(*a, **k))
    monkeypatch.setattr(tscene, "DYNERF_SIZE", (48, 36))
    for name in ("ITERS", "REPS", "WARMUP"):
        monkeypatch.setattr(scripts, name, 1)
    monkeypatch.setattr(blend, "k2_reduction",
                        lambda: {"batch": 3, "shuffles": 31, "unbatched": 50})
    chain = CS.check_video_chain(torch.device("cpu"), video_size=(96, 72),
                                 schedule=OVERRIDES)
    out = capsys.readouterr().out
    assert chain["cli"] == (0, 0)                                  # the plain path
    # camera 0 MPEG-4 Part 2 (not this writer's), camera 1 a field pair then
    # MBAFF frames with B
    assert codings == [(2, False, True, True)]
    assert "camera 0 MPEG-4 Part 2 I and P VOPs" in out
    assert "each the resized decode of its video" in out
    assert np.isfinite(chain["psnr"]) and chain["extract_s"] > 0
