"""MBAFF in the port's H.264 decoder (``native/h264.cpp``): frame pictures
with ``mb_adaptive_frame_field_flag`` 1, whose macroblocks come in pairs
each coded as two frame or two field macroblocks, bit for bit against cv2's
libavcodec.

cv2 returns no decode of such a frame (libavcodec flags it interlaced and
cv2's libswscale refuses it, handing back a buffer it did not write), so
the frames are held to the samples of cv2's own libavcodec
(``tests/avcodec_oracle.py``) and to cv2's conversion of them, as
``tests/test_torch_h264.py`` holds frames coded as two fields.

- The committed fixtures ``FIXTURES_MBAFF`` (CABAC and CAVLC, I, P and B,
  spatial and temporal direct with co-location from an MBAFF frame and
  from a field pair, explicit and implicit weights, MMCO, many slices with
  ``disable_deblocking_filter_idc`` 2, MBAFF frames mixed with field
  pictures): each against libavcodec and its committed decode.
- Sixteen random MBAFF streams, CABAC and CAVLC, some mixed with field
  pictures, against libavcodec.
- cv2 itself returns no MBAFF frame.
- An MBAFF picture is deblocked without the bS rule of libavcodec's x86
  fast loop filter (which it keeps for frames without MBAFF).
"""

import numpy as np
import pytest

from fourdgs_tpu_torch.utils import video
from tests import avcodec_oracle as AO
from tests import h264_writer as HW
from tests import test_torch_h264 as TH
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def committed():
    with np.load(TH.os.path.join(TH.H264_FIXTURES, "cv2_decode.npz")) as z:
        return {k: z[k] for k in TH.FIXTURES_MBAFF if k in z.files}


@pytest.mark.parametrize("name", sorted(TH.FIXTURES_MBAFF))
def test_mbaff_fixture_matches_avcodec(name, committed):
    """Each MBAFF fixture: cv2's conversion of libavcodec's decode as
    committed, libavcodec's samples now, and as many frames as cv2 returns."""
    path = TH.fixture_path(name)
    got = np.stack(list(video.read_frames(path, bgr=True)))
    np.testing.assert_array_equal(got, committed[name])
    assert len(TH.cv2_frames(path)) == len(got)
    TH._same_planes(list(video.read_frames(path, planes=True)),
                    TH.avcodec_planes(TH.fixture_stream(name)[0]), name)


@pytest.mark.parametrize("name", ["mbaff_ip", "mbaff_b_temporal", "cavlc_mbaff", "mbaff_paff"])
def test_writer_rewrites_mbaff_fixture(name):
    data, _ = TH.fixture_bytes(name)
    with open(TH.fixture_path(name), "rb") as f:
        assert f.read() == data


def test_mbaff_fixtures_code_their_features():
    """Between them the fixtures code field and frame pairs, MB_field
    decoding flags (contexts 70-72), temporal direct from an MBAFF frame,
    from a field pair and into a field from an MBAFF frame, CAVLC's
    P_8x8ref0 and empty 8x8 parses, and field pictures among MBAFF frames."""
    counts, ctxs = {}, set()
    for name in TH.FIXTURES_MBAFF:
        _, w = TH.fixture_stream(name)
        for k, v in w.counts.items():
            counts[k] = counts.get(k, 0) + v
        for used in w.contexts.values():
            ctxs |= used
    assert {70, 71, 72} <= ctxs
    for key in ("mbaff_frames", "field_mbs", "frame_mbs", "mbaff_from_mbaff",
                "mbaff_from_fields", "fields_from_mbaff", "8x8ref0", "empty8x8", "field_pairs"):
        assert counts[key] > 0, key


def _random_mbaff_config(seed, cavlc):
    """MBAFF streams as the random field streams draw them: field and frame
    pairs in any mix (and field pictures among the frames, at times), B
    pictures with spatial or temporal direct and each weighting, several
    references, modifications, MMCOs, slices and deblocking controls."""
    rng = np.random.default_rng(9000 + seed + 100 * cavlc)
    b_frames = int(rng.integers(1, 4)) if rng.random() < 0.6 else 0
    profile = 77 if cavlc and rng.random() < 0.5 else 100
    return HW.Config(
        seed=seed, cavlc=cavlc, profile=profile, frame_mbs_only=False, mbaff=True,
        field_pics=float(rng.choice([0.0, 0.0, 0.3, 0.5])),
        p_field_mb=float(rng.choice([0.3, 0.5, 0.8])),
        p_bottom_first=float(rng.choice([0, 0.5, 1.0])), frames=int(rng.integers(3, 9)),
        width=int(rng.choice([16, 32, 48, 64])), height=int(rng.choice([32, 48, 64, 28, 44])),
        transform8x8=profile == 100 and bool(rng.random() < 0.7),
        weighted=bool(rng.random() < 0.3), b_frames=b_frames, b_pyramid=bool(rng.random() < 0.5),
        direct_spatial=[True, False, None][int(rng.integers(3))],
        weighted_bipred=int(rng.integers(0, 3)), num_ref_default=int(rng.integers(1, 4)),
        num_ref_l1_default=int(rng.integers(1, 3)), p_mmco=float(rng.choice([0, 0.5])),
        p_modify=float(rng.choice([0, 0.4])), max_refs=int(rng.integers(2, 6)),
        constrained_intra=bool(rng.random() < 0.3),
        qp_range=[(12, 44), (0, 51), (30, 51)][int(rng.integers(3))],
        p_far_mv=float(rng.choice([0, 0.2])), p_skip=float(rng.random() * 0.5),
        p_direct=float(rng.random() * 0.4), p_intra_in_p=float(rng.random() * 0.3),
        max_slices=int(rng.integers(1, 4)), p_b_slice_mix=float(rng.choice([0, 0.3])),
        p_b_anchor=float(rng.choice([0, 0.4])), p_idr=float(rng.choice([0, 0.2])),
        bottom_poc=bool(rng.random() < 0.3),
        p_nonref=0.0 if b_frames else float(rng.choice([0, 0.3])),
        poc_type=0 if b_frames else int(rng.choice([0, 1, 2])), poc1_t2b=1,
        chroma_qp_offset=int(rng.integers(-6, 7)),
        p_8x8ref0=float(rng.choice([0, 0.3])) if cavlc else 0.0,
        p_empty8x8=float(rng.choice([0, 0.3])) if cavlc and profile == 100 else 0.0)


@pytest.mark.parametrize("seed", range(8))
def test_random_mbaff_streams_match_avcodec(tmp_path, seed):
    TH._same_as_avcodec(tmp_path, _random_mbaff_config(seed, cavlc=False))


@pytest.mark.parametrize("seed", range(8))
def test_random_cavlc_mbaff_streams_match_avcodec(tmp_path, seed):
    TH._same_as_avcodec(tmp_path, _random_mbaff_config(seed, cavlc=True))


@pytest.mark.parametrize("cavlc", [False, True], ids=["cabac", "cavlc"])
def test_cv2_returns_no_mbaff_frame(tmp_path, cavlc):
    """cv2 returns as many frames as the port for a stream of MBAFF frames,
    but none of them is the decode (libswscale refuses a frame libavcodec
    flags interlaced); the port's frames are cv2's conversion of
    libavcodec's decode."""
    cfg = HW.Config(seed=1, width=48, height=32, frames=4, frame_mbs_only=False, mbaff=True,
                    cavlc=cavlc)
    stream = HW.write(cfg)
    path = tmp_path / "m.mp4"
    path.write_bytes(HW.mp4(*stream, cfg.width, cfg.height))
    got = list(video.read_frames(str(path), bgr=True))
    live = TH.cv2_frames(path)
    want, _ = TH.field_reference(stream, None)
    assert len(got) == len(live) == len(want) == cfg.frames
    for a, b, c in zip(got, want, live):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def test_mbaff_cavlc_8x8_empty_block_deblocks_as_avcodec(tmp_path):
    """CAVLC P pictures of MBAFF frames whose 8x8-transform blocks of cbp bit
    1 are at times four empty parses, deblocked (idc 0, QP 28-40) under
    equal chroma QP offsets: libavcodec's samples. libavcodec filters an
    MBAFF picture with its general loop filter, so the bS 2 its x86 fast
    filter gives a whole inter 8x8-transform MB of cbp bits 0-2 does not
    hold here; an empty block is a block without coefficients."""
    cfg = HW.Config(seed=0, cavlc=True, profile=100, width=96, height=64, frames=4,
                    frame_mbs_only=False, mbaff=True, p_empty8x8=0.5, p_intra_in_p=0.05,
                    p_skip=0.1, qp_range=(28, 40), filter_idcs=(0,))
    w = HW.Writer(cfg)
    w.write()
    assert w.counts["empty8x8"] >= 4 and w.counts["field_mbs"] and w.counts["frame_mbs"]
    TH._same_as_avcodec(tmp_path, cfg)
