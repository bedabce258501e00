"""The port's HEVC decoder (``native/hevc.cpp``, ``utils/video.py``) bit for
bit against cv2's ``VideoCapture`` (FFmpeg's libavcodec and libswscale),
and the committed fixtures of ``tests/torch_fixtures/hevc``.

- The fixtures: streams ``tests/hevc_writer.py`` writes (``hvc1`` and
  ``hev1`` entries, 1-, 2- and 4-byte NAL lengths) that between them hold
  I, P and B slices, CTBs of 16, 32 and 64, every partition (AMP too),
  skip, merge and AMVP with the temporal candidate, intra modes and their
  filters, residuals with sign data hiding, transform skip and long escape
  codes, cu_qp_delta, chroma QP offsets, scaling lists (default, SPS and
  PPS, predicted), weighted prediction and bi-prediction, long-term
  pictures, list modifications, WPP, slices with each deblocking control,
  SAO, constrained intra prediction, pyramids of B pictures, CRA, BLA and
  IDR pictures, RASL and RADL pictures of a leading CRA, EOS,
  ``pic_output_flag`` 0, sub-layers with the VUI's HRD parameters, colour
  variants cv2 converts, a conformance window, extra slice header bits and
  header extensions, and ``ctts`` with FFmpeg's edit list. Each decodes to
  cv2's committed BGR frames (``cv2_decode.npz``) and to cv2's decode
  here, frame by frame with the same count, and the writer rewrites them
  byte for byte.
- Sixteen random streams of every feature above against cv2; the decoded
  samples (``planes=True``) against cv2's own libavcodec
  (``tests/avcodec_oracle.py``).
- Where libavcodec departs from the standard, a case each: the output order
  (reorder buffer, latency not read, ``pic_output_flag`` 0, RASL pictures
  of a leading CRA not output, EOS before a CRA dropping the pictures still
  waiting, BLA pictures), the deblocking offsets of slices that differ
  (CTBs of 16, 32 and 64) and of a slice that disables its deblocking
  (held to libavcodec on one thread: with frame threads cv2's frames
  depend on its thread count).
- An edit list that starts at the first composition time (FFmpeg's muxer
  writes one for B-frames, with ``ctts``) drops no frame, for H.264 and
  HEVC; one that starts later is refused, naming it.
- Each feature out of scope raises ``NotImplementedError`` naming it; a
  truncated stream raises ``ValueError``.
- ``codec_of`` picks the decoder; the native build key covers the headers
  a source includes.
- ``chip_smoke.py`` phase 18 on the CPU: (a) the HEVC fixtures, (b) the
  host's times of an HEVC stream at a small size.
"""

import os
import shutil

import cv2
import numpy as np
import pytest

import chip_smoke as CS
from fourdgs_tpu_torch.utils import native, video
from tests import avcodec_oracle as AO
from tests import h264_writer as H264W
from tests import hevc_writer as HW

HEVC_FIXTURES = CS.HEVC_FIXTURES

# the writer's fixtures: name -> Config fields
FIXTURES = {
    "intra_scaling": dict(width=48, height=40, frames=2, seed=1, scaling="sps", p_big=0.1,
                          qp=(0, 51), depth_intra=2),
    "p_amp_ctb32": dict(width=64, height=48, frames=4, seed=2, log2_ctb=5, log2_max_tb=5,
                        depth_inter=2, scaling="pps", max_merge=(1, 3)),
    "b_pyramid_weighted": dict(width=48, height=32, frames=8, seed=3, b_frames=3,
                               b_pyramid=True, weighted_pred=True, weighted_bipred=True,
                               num_refs=3),
    "wpp_slices": dict(width=80, height=48, frames=4, seed=4, b_frames=1, wpp=True,
                       max_slices=3, scaling="default"),
    "long_term": dict(width=32, height=32, frames=8, seed=5, long_term=True, num_refs=3,
                      b_frames=1, log2_max_poc_lsb=5),
    "leading_cra_edit": dict(width=32, height=32, frames=6, seed=6, first="leading",
                             b_frames=2, ctts=True),
    "bla_eos": dict(width=32, height=32, frames=10, seed=7, gop=4, irap="bla", b_frames=2,
                    eos_gops=(2,)),
    "cra_eos": dict(width=32, height=32, frames=10, seed=8, gop=5, irap="cra", b_frames=3,
                    eos_gops=(1,), reorder_extra=1),
    "no_output": dict(width=32, height=24, frames=7, seed=9, b_frames=2, p_no_output=0.35,
                      reorder_extra=1),
    "hev1_len2": dict(width=40, height=24, frames=3, seed=10, entry=b"hev1", length_size=2,
                      extra_bits=2, header_ext=True, max_slices=2),
    "ctb64_crop": dict(width=120, height=68, crop=(0, 8, 2, 2), frames=2, seed=11, log2_ctb=6,
                       log2_max_tb=5, log2_min_cb=4, log2_min_tb=3),
    "sublayers_bt709": dict(width=32, height=32, frames=7, seed=12, b_frames=2, tid_b=True,
                            vui={"sub_layers": 1, "hrd": True, "matrix": 1, "full_range": 1}),
    "constrained_qp": dict(width=48, height=32, frames=3, seed=13, constrained_intra=True,
                           p_intra=0.4, log2_ctb=5, qp_delta_depth=2, chroma_qp=(-4, 5), init_qp=34,
                           cabac_init_present=False, lists_modification=False),
    "rows": dict(width=64, height=48, frames=4, seed=14, row_repeat=True, b_frames=2,
                 log2_ctb=5, log2_max_tb=5),
    "ctb64_deep": dict(width=128, height=64, frames=4, seed=16, b_frames=2, log2_ctb=6,
                       log2_max_tb=5, depth_inter=3, depth_intra=3, p_split=0.6, p_tsplit=0.5),
    "len1_main10": dict(width=16, height=16, frames=2, seed=15, length_size=1, profile=2,
                        sao=False, amp=False, tmvp=False, sign_hiding=False,
                        transform_skip=False, cu_qp_delta=False, deblock_control=False),
}


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame)


def write_committed_fixtures(out_dir=HEVC_FIXTURES):
    """Writes the fixtures and cv2's BGR decode of each (``cv2_decode.npz``)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, fields in FIXTURES.items():
        with open(os.path.join(out_dir, name + ".mp4"), "wb") as f:
            f.write(HW.video(HW.Config(**fields)))
    want = {n: np.stack(cv2_frames(os.path.join(out_dir, n + ".mp4"))) for n in FIXTURES}
    np.savez_compressed(os.path.join(out_dir, "cv2_decode.npz"), **want)


@pytest.fixture(scope="module")
def committed():
    with np.load(os.path.join(HEVC_FIXTURES, "cv2_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def _same_as(path, want, stats=None):
    got = list(video.read_frames(str(path), bgr=True, stats=stats))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{path} frame {i}")


def _stream(tmp_path, cfg, name="s.mp4"):
    path = tmp_path / name
    path.write_bytes(HW.video(cfg))
    return path


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_cv2(name, committed):
    """Each committed stream decodes to cv2's committed frames and to its
    decode here."""
    path = os.path.join(HEVC_FIXTURES, name + ".mp4")
    _same_as(path, committed[name])
    _same_as(path, cv2_frames(path))


def test_writer_rewrites_its_fixtures():
    for name, fields in FIXTURES.items():
        with open(os.path.join(HEVC_FIXTURES, name + ".mp4"), "rb") as f:
            assert HW.video(HW.Config(**fields)) == f.read(), name


def test_fixtures_hold_their_features(committed):
    """Slice types and counts: I, P and B pictures; the RASL pictures of the
    leading CRA and the pictures ``pic_output_flag`` holds back not output;
    the pictures an EOS before a CRA leaves waiting dropped."""
    kinds = {}
    for name in FIXTURES:
        stats = []
        list(video.read_frames(os.path.join(HEVC_FIXTURES, name + ".mp4"), stats=stats))
        kinds[name] = "".join(k for k, _ in stats)
        assert len(kinds[name]) == len(committed[name])
    assert set(kinds["b_pyramid_weighted"]) == set("IPB") or set("IB") <= set(
        kinds["b_pyramid_weighted"])
    assert kinds["intra_scaling"][0] == "I" and "P" in kinds["p_amp_ctb32"]
    # the leading CRA's two RASL pictures are decoded and dropped
    assert len(committed["leading_cra_edit"]) == 6 + 3 - 2
    cfg = HW.Config(**FIXTURES["no_output"])
    _, _, w = HW.write(cfg)
    assert len(committed["no_output"]) == sum(p.output for p in w.pics) < cfg.frames
    assert len(committed["cra_eos"]) < FIXTURES["cra_eos"]["frames"]
    assert len(committed["bla_eos"]) == FIXTURES["bla_eos"]["frames"]


def test_fixtures_code_every_context():
    """Between them the fixtures code every CABAC context an I, P or B
    slice reaches (all but transquant_bypass's, a refused feature)."""
    coded = set()
    decision = HW.Cabac.decision

    def counting(self, ctx, b):
        coded.add(ctx)
        return decision(self, ctx, b)

    HW.Cabac.decision = counting
    try:
        for fields in FIXTURES.values():
            HW.video(HW.Config(**fields))
    finally:
        HW.Cabac.decision = decision
    assert coded == set(range(len(HW.CABAC_INIT[0]))) - {HW.TQ_BYPASS}


def random_config(seed):
    """A random stream of every feature the decoder reads."""
    r = np.random.default_rng(2000 + seed)
    log2_ctb = int(r.integers(4, 7))
    log2_min_cb = int(r.integers(3, min(log2_ctb, 5) + 1))
    log2_min_tb = int(r.integers(2, log2_min_cb))
    log2_max_tb = int(r.integers(log2_min_tb, min(log2_ctb, 5) + 1))
    max_depth = min(2, log2_ctb - log2_min_tb)
    mcb = 1 << log2_min_cb
    width = int(r.integers(1, 7)) * mcb + (int(r.integers(1, 4)) * mcb if mcb < 16 else 0)
    height = int(r.integers(1, 5)) * mcb + 8
    height += (-height) % mcb
    b_frames = int(r.integers(0, 4))
    gop = int(r.choice([0, 3, 5]))
    return HW.Config(
        seed=seed, width=width, height=height, frames=int(r.integers(2, 9)),
        log2_ctb=log2_ctb, log2_min_cb=log2_min_cb, log2_min_tb=log2_min_tb,
        log2_max_tb=log2_max_tb, depth_inter=int(r.integers(0, max_depth + 1)),
        depth_intra=int(r.integers(0, max_depth + 1)),
        amp=bool(r.random() < 0.7),
        sao=bool(r.random() < 0.8), tmvp=bool(r.random() < 0.8),
        strong_smoothing=bool(r.random() < 0.7),
        scaling=str(r.choice(["off", "off", "default", "sps", "pps"])),
        sign_hiding=bool(r.random() < 0.6), transform_skip=bool(r.random() < 0.5),
        cu_qp_delta=bool(r.random() < 0.6),
        qp_delta_depth=int(r.integers(0, log2_ctb - log2_min_cb + 1)),
        chroma_qp=(int(r.integers(-6, 7)), int(r.integers(-6, 7))),
        weighted_pred=bool(r.random() < 0.4), weighted_bipred=bool(r.random() < 0.4),
        wpp=bool(r.random() < 0.4), constrained_intra=bool(r.random() < 0.2),
        max_slices=int(r.integers(1, 4)), log2_par_mrg=int(r.integers(2, log2_ctb + 1)),
        qp=(0, 51) if r.random() < 0.3 else (20, 40), b_frames=b_frames,
        b_pyramid=bool(r.random() < 0.5), num_refs=int(r.integers(1, 4)), gop=gop,
        irap=str(r.choice(["idr", "cra", "bla"])), long_term=bool(r.random() < 0.3),
        ctts=bool(b_frames and r.random() < 0.5), max_merge=(1, 5),
        entry=b"hev1" if r.random() < 0.3 else b"hvc1", length_size=int(r.choice([2, 4])))


@pytest.mark.parametrize("seed", range(16))
def test_random_stream_matches_cv2(tmp_path, seed):
    path = _stream(tmp_path, random_config(seed))
    _same_as(path, cv2_frames(path))


@pytest.mark.parametrize("seed", range(4))
def test_planes_match_avcodec(tmp_path, seed):
    """``planes=True``: each frame's decoded samples equal those of cv2's
    own libavcodec, fed one access unit a packet."""
    cfg = random_config(100 + seed)
    params, aus, _ = HW.write(cfg)
    path = _stream(tmp_path, cfg)
    want = AO.decode(HW.annexb_packets(params, aus), codec_id=AO.AV_CODEC_ID_HEVC)
    got = list(video.read_frames(str(path), planes=True))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for p, (gp, wp) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gp, wp, err_msg=f"frame {i} plane {p}")


# the output order: each case's Config fields
ORDER_CASES = {
    "reorder": dict(frames=10, b_frames=3, b_pyramid=True, reorder_extra=2, dpb_extra=1),
    "reorder_short": dict(frames=9, b_frames=3, reorder_extra=-1),
    "latency": dict(frames=9, b_frames=3, latency_plus1=1, reorder_extra=2),
    "pic_output_flag": dict(frames=9, b_frames=2, p_no_output=0.4),
    "leading_cra": dict(frames=7, b_frames=1, first="leading"),
    "eos_cra": dict(frames=12, b_frames=3, gop=6, irap="cra", eos_gops=(1,), reorder_extra=2),
    "eos_idr": dict(frames=12, b_frames=3, gop=6, irap="idr", eos_gops=(1,)),
    "bla": dict(frames=12, b_frames=2, gop=4, irap="bla", log2_max_poc_lsb=4),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_output_order_matches_cv2(tmp_path, case):
    """cv2's frames in its order and number, two seeds a case."""
    for seed in range(2):
        cfg = HW.Config(width=32, height=24, seed=seed, **ORDER_CASES[case])
        path = _stream(tmp_path, cfg, f"{case}{seed}.mp4")
        _same_as(path, cv2_frames(path))


@pytest.mark.parametrize("ctb", [4, 5, 6])
def test_deblocking_offsets_of_slices_match_cv2(tmp_path, ctb):
    """Slices of differing deblocking offsets and loop filtering across
    them: libavcodec's one tc/beta variable through a CTB's edges."""
    for seed in range(3):
        cfg = HW.Config(width=192 if ctb == 6 else 96, height=128 if ctb == 6 else 80, seed=seed,
                        frames=3, b_frames=1, max_slices=4, log2_ctb=ctb,
                        log2_max_tb=min(ctb, 5), sao=False)
        path = _stream(tmp_path, cfg, f"d{seed}.mp4")
        _same_as(path, cv2_frames(path))


@pytest.mark.parametrize("seed", range(2))
def test_disabled_slice_keeps_previous_offsets(tmp_path, seed):
    """A slice that disables its deblocking by its override keeps the
    offsets of the slice header before it, which edges it shares with a
    deblocked slice read: held to libavcodec on one thread (cv2's frame
    threads each keep their own last header)."""
    cfg = HW.Config(width=128, height=96, seed=seed, frames=4, b_frames=1, max_slices=4,
                    log2_ctb=5, slice_disable=True)
    params, aus, _ = HW.write(cfg)
    path = _stream(tmp_path, cfg)
    want = AO.decode(HW.annexb_packets(params, aus), threads=1, codec_id=AO.AV_CODEC_ID_HEVC)
    got = list(video.read_frames(str(path), planes=True))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for p, (gp, wp) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gp, wp, err_msg=f"frame {i} plane {p}")


def _h264_b_stream(seed):
    """An H.264 stream with B-frames and each sample's composition time as
    FFmpeg's muxer writes it (its display rank plus the delay that keeps it
    at or after the decoding time): (sps, pps, aus, cts, delay)."""
    cfg = H264W.Config(width=48, height=32, frames=7, seed=seed, b_frames=2, b_pyramid=True,
                       b_full_runs=True)
    w = H264W.Writer(cfg)
    sps, pps, aus = w.write()
    rank = {i: r for r, i in enumerate(sorted(range(len(aus)), key=lambda i: w.b_display[i]))}
    delay = max(i - rank[i] for i in range(len(aus)))
    return sps, pps, aus, [rank[i] + delay for i in range(len(aus))], delay


@pytest.mark.parametrize("codec", ["h264", "hevc"])
def test_edit_list_of_the_composition_delay_drops_nothing(tmp_path, codec):
    """``ctts`` and an edit list whose media_time is the first picture's
    composition delay, as FFmpeg's muxer writes them for B-frames: every
    frame, as cv2 returns them. An edit that starts one tick later drops a
    sample (cv2 returns one frame fewer): refused, naming it."""
    for seed in range(2):
        if codec == "h264":
            sps, pps, aus, cts, delay = _h264_b_stream(seed)
            data = H264W.mp4(sps, pps, aus, 48, 32, cts=cts, edit=delay)
            later = H264W.mp4(sps, pps, aus, 48, 32, cts=cts, edit=delay + 1)
        else:
            cfg = HW.Config(width=32, height=32, frames=7, seed=seed, b_frames=2)
            params, aus, w = HW.write(cfg)
            cts, delay = HW.display_cts(w.pics)
            data = HW.mp4(params, aus, 32, 32, cts=cts, edit=delay)
            later = HW.mp4(params, aus, 32, 32, cts=cts, edit=delay + 1)
        assert delay > 0
        path = tmp_path / f"e{seed}.mp4"
        path.write_bytes(data)
        want = cv2_frames(path)
        assert len(want) == 7
        _same_as(path, want)
        path.write_bytes(later)
        assert len(cv2_frames(path)) == 6
        with pytest.raises(NotImplementedError, match="an edit list that drops samples"):
            list(video.read_frames(str(path)))


@pytest.mark.parametrize("feature", sorted(HW.REFUSALS))
def test_refusals_name_their_feature(tmp_path, feature):
    path = tmp_path / "f.mp4"
    path.write_bytes(HW.refusal(feature))
    with pytest.raises(NotImplementedError, match=HW.REFUSALS[feature]):
        list(video.read_frames(str(path)))


def test_truncated_stream_raises(tmp_path):
    cfg = HW.Config(width=32, height=32, frames=3, seed=16)
    params, aus, _ = HW.write(cfg)
    path = tmp_path / "t.mp4"
    cut = aus[:2] + [[aus[2][0][:4]]]          # the last slice's header cut short
    path.write_bytes(HW.mp4(params, cut, 32, 32))
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))
    data = HW.mp4(params, aus, 32, 32)
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))


def test_codec_picks_the_decoder():
    for name in ("rows", "hev1_len2"):
        with open(os.path.join(HEVC_FIXTURES, name + ".mp4"), "rb") as f:
            assert video.codec_of(f.read()) == "hevc"
    with open(os.path.join(CS.MPEG4_FIXTURES, "rows.mp4"), "rb") as f:
        assert video.codec_of(f.read()) == "mpeg4"
    with open(os.path.join(CS.H264_FIXTURES, "inter.mp4"), "rb") as f:
        assert video.codec_of(f.read()) == "h264"


def test_build_key_covers_included_headers(tmp_path):
    """``lib_path`` hashes hevc.cpp and the ``native/*.h`` it includes: an
    edited header names another library, an unrelated one does not."""
    for name in ("hevc.cpp", "mp4.h", "yuv420_bgr.h", "jpeg.cpp"):
        shutil.copy(native.NATIVE_DIR / name, tmp_path / name)
    src = tmp_path / "hevc.cpp"
    assert native.local_headers(src) == [tmp_path / "mp4.h", tmp_path / "yuv420_bgr.h"]
    before = native.lib_path(src, ("-O3",))
    assert before == native.lib_path(native.NATIVE_DIR / "hevc.cpp", ("-O3",))
    with open(tmp_path / "mp4.h", "a") as f:
        f.write("// edited\n")
    assert native.lib_path(src, ("-O3",)) != before
    assert native.lib_path(tmp_path / "jpeg.cpp") == native.lib_path(
        native.NATIVE_DIR / "jpeg.cpp")


def test_chip_smoke_phase_18a_hevc_on_cpu(committed):
    out = CS.check_hevc_fixtures()
    assert out["files"] == len(FIXTURES)
    assert out["frames"] == sum(len(v) for v in committed.values())


def test_chip_smoke_phase_18b_hevc_on_cpu():
    """Phase 18 (b)'s HEVC stream on the CPU at a small size: I, P, B, B in
    decoding order, each picture's decode timed."""
    out = CS.check_hevc_host_times(size=(96, 72), frames=4)
    assert all(out[k] > 0 for k in ("decode_hevc_ms", "decode_hevc_i_ms", "decode_hevc_p_ms",
                                    "decode_hevc_b_ms", "hevc_mbytes"))
