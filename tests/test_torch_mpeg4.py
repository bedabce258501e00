"""The port's MPEG-4 Part 2 decoder (``native/mpeg4.cpp``, ``utils/video.py``)
bit for bit against cv2's ``VideoCapture`` (FFmpeg's libavcodec and
libswscale), and the committed fixtures of ``tests/torch_fixtures/mpeg4``.

- The fixtures: an ``mp4v`` stream cv2's ``VideoWriter`` wrote (84x60,
  moving content, 14 frames: a second I-VOP), and streams
  ``tests/mpeg4_writer.py`` writes that between them hold every
  macroblock type (intra, inter, inter4v, intra in P-VOPs, not_coded),
  DQUANT, AC prediction, the DC coded by its VLCs and as a coefficient,
  every escape mode, H.263 and MPEG quantisation with default and loaded
  matrices, fcode 1-7 and vectors far outside the picture, both rounding
  types, video packets with header_extension_code, N-VOPs at the end and
  in the middle with low_delay 1 and 0, in-band headers and the visual
  object's colour variants cv2 converts. Each decodes to cv2's committed
  BGR frames and to cv2's decode here, frame by frame with the same count,
  and the writer rewrites its streams byte for byte.
- Streams cv2 writes here (the fourccs mp4v and XVID, which it writes as
  ``mp4v``) and sixteen random streams of every feature above, each against
  cv2; the decoded samples (``planes=True``) against cv2's own libavcodec
  (``tests/avcodec_oracle.py``).
- Each feature out of scope raises ``NotImplementedError`` naming it; a
  truncated stream raises ``ValueError``.
- The native build key covers the headers a source includes.
- ``chip_smoke.py`` phase 18 on the CPU: (a) the MPEG-4 fixtures, (b) the
  host's times of an MPEG-4 stream at a small size, and the phase's
  sequence of checks.
"""

import os
import shutil

import cv2
import numpy as np
import pytest

import chip_smoke as CS
from fourdgs_tpu_torch.utils import native, video
from tests import avcodec_oracle as AO
from tests import mpeg4_writer as MW

MPEG4_FIXTURES = CS.MPEG4_FIXTURES

# the writer's fixtures: name -> Config fields
FIXTURES = {
    "packets_4mv": dict(width=70, height=54, frames=6, gop=4, seed=1, packets=4, p_4mv=0.6,
                        p_escape=0.3, p_big_mv=0.4, p_dquant=0.5, qp=(1, 31)),
    "mpeg_quant": dict(width=48, height=40, frames=5, seed=2, quant_type=1,
                       intra_matrix="random", inter_matrix="random", p_intra=0.3),
    "mpeg_quant_default": dict(width=42, height=32, frames=4, seed=3, quant_type=1,
                               p_ac_pred=1.0, dc_thr=(6, 7), qp=(10, 31)),
    "dc_coef_rounding": dict(width=48, height=34, frames=5, seed=4, dc_thr=(4, 7),
                             rounding="random", p_skip=0.4, p_stuffing=0.1),
    "nvop_end": dict(width=32, height=32, frames=5, seed=5, n_vops=(2, 4)),
    "nvop_low_delay0": dict(width=32, height=32, frames=5, seed=6, n_vops=(4,), low_delay=0),
    "no_vol_control_inband": dict(width=40, height=24, frames=4, seed=7, vol_control=False,
                                  in_band=True, user_data=b""),
    "bt709_full": dict(width=32, height=32, frames=2, seed=8, video_signal=(1, 1)),
    "fcc": dict(width=32, height=32, frames=2, seed=9, video_signal=(0, 4)),
    "smpte240m_full": dict(width=32, height=32, frames=2, seed=10, video_signal=(1, 7)),
    "rows": dict(width=64, height=48, frames=3, seed=11, row_repeat=True, p_4mv=0.5),
}
CV2_FIXTURE = "cv2_mp4v"


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame)


def scene(width, height, n, seed=0):
    """Moving frames for cv2's writer: a smooth texture panned and a disc
    that moves and changes colour."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (height // 8 + 8, width // 8 + 8, 3)).astype(np.uint8)
    tex = cv2.resize(tex, (tex.shape[1] * 8, tex.shape[0] * 8), interpolation=cv2.INTER_CUBIC)
    frames = []
    for i in range(n):
        f = np.ascontiguousarray(tex[i:i + height, 2 * i:2 * i + width])
        cv2.circle(f, (int(width * (0.3 + 0.03 * i)), height // 2), height // 5,
                   (30 * i % 255, 200, 90), -1)
        frames.append(f)
    return frames


def cv2_video(path, width, height, n, fourcc="mp4v", seed=0):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (width, height))
    for f in scene(width, height, n, seed):
        vw.write(f)
    vw.release()


def write_committed_fixtures(out_dir=MPEG4_FIXTURES):
    """Writes the fixtures and cv2's BGR decode of each
    (``cv2_decode.npz``). cv2's own stream is written only where it is
    missing (another cv2 may encode otherwise)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, fields in FIXTURES.items():
        with open(os.path.join(out_dir, name + ".mp4"), "wb") as f:
            f.write(MW.video(MW.Config(**fields)))
    if not os.path.exists(os.path.join(out_dir, CV2_FIXTURE + ".mp4")):
        cv2_video(os.path.join(out_dir, CV2_FIXTURE + ".mp4"), 84, 60, 14)
    want = {n: np.stack(cv2_frames(os.path.join(out_dir, n + ".mp4")))
            for n in [*FIXTURES, CV2_FIXTURE]}
    np.savez_compressed(os.path.join(out_dir, "cv2_decode.npz"), **want)


@pytest.fixture(scope="module")
def committed():
    with np.load(os.path.join(MPEG4_FIXTURES, "cv2_decode.npz")) as z:
        return {k: z[k] for k in z.files}


def _same_as(path, want, stats=None):
    got = list(video.read_frames(str(path), bgr=True, stats=stats))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{path} frame {i}")


@pytest.mark.parametrize("name", [*FIXTURES, CV2_FIXTURE])
def test_fixture_matches_cv2(name, committed):
    """Each committed stream decodes to cv2's committed frames and to its
    decode here."""
    path = os.path.join(MPEG4_FIXTURES, name + ".mp4")
    _same_as(path, committed[name])
    _same_as(path, cv2_frames(path))


def test_writer_rewrites_its_fixtures(tmp_path):
    for name, fields in FIXTURES.items():
        with open(os.path.join(MPEG4_FIXTURES, name + ".mp4"), "rb") as f:
            assert MW.video(MW.Config(**fields)) == f.read(), name


def test_fixtures_hold_their_features(committed):
    """The cv2 stream's second I-VOP; the N-VOP fixtures' counts (a closing
    N-VOP repeats the last frame at low_delay 1 only)."""
    stats = []
    list(video.read_frames(os.path.join(MPEG4_FIXTURES, CV2_FIXTURE + ".mp4"), stats=stats))
    kinds = "".join(k for k, _ in stats)
    assert len(kinds) == 14 and kinds[0] == "I" and "I" in kinds[1:] and "P" in kinds
    for name, want in (("nvop_end", "IPPN"), ("nvop_low_delay0", "IPPP")):
        stats = []
        list(video.read_frames(os.path.join(MPEG4_FIXTURES, name + ".mp4"), stats=stats))
        assert "".join(k for k, _ in stats) == want
        assert len(committed[name]) == len(want)


@pytest.mark.parametrize("fourcc", ["mp4v", "XVID"])
def test_cv2_written_stream_matches_cv2(tmp_path, fourcc):
    """cv2's VideoWriter at a size no multiple of 16 with motion, 26
    frames (I-VOPs 0, 12, 24): the same frames as cv2 reads."""
    path = tmp_path / "v.mp4"
    cv2_video(path, 100, 76, 26, fourcc, seed=1)
    stats = []
    _same_as(path, cv2_frames(path), stats)
    assert "".join(k for k, _ in stats) == ("I" + "P" * 11) * 2 + "IP"


def random_config(seed):
    """A random stream of every feature the decoder reads."""
    r = np.random.default_rng(1000 + seed)
    return MW.Config(
        seed=seed, width=int(r.integers(1, 6)) * 16 - int(r.choice([0, 2, 6, 10])),
        height=int(r.integers(1, 5)) * 16 - int(r.choice([0, 4, 8, 14])),
        frames=int(r.integers(2, 7)), gop=int(r.integers(2, 6)),
        quant_type=int(r.integers(0, 2)), intra_matrix=str(r.choice(["default", "random"])),
        inter_matrix=str(r.choice(["default", "random"])), p_dquant=float(r.uniform(0, 0.6)),
        p_ac_pred=float(r.uniform(0, 1)), p_coded=float(r.uniform(0.2, 0.9)),
        p_skip=float(r.uniform(0, 0.4)), p_intra=float(r.uniform(0, 0.3)),
        p_4mv=float(r.uniform(0, 0.6)), p_escape=float(r.uniform(0, 0.3)),
        p_big_mv=float(r.uniform(0, 0.3)), rounding=str(r.choice(["alternate", "random"])),
        packets=int(r.choice([0, 1, 2, 5])), qp=(1, 31) if r.random() < 0.5 else (1, 6),
        n_vops=tuple(int(v) for v in r.choice(np.arange(1, 7), int(r.integers(0, 2)),
                                              replace=False)),
        low_delay=int(r.integers(0, 2)))


@pytest.mark.parametrize("seed", range(16))
def test_random_stream_matches_cv2(tmp_path, seed):
    cfg = random_config(seed)
    path = tmp_path / "r.mp4"
    path.write_bytes(MW.video(cfg))
    _same_as(path, cv2_frames(path))


@pytest.mark.parametrize("seed", range(4))
def test_planes_match_avcodec(tmp_path, seed):
    """``planes=True``: each frame's decoded samples equal those of cv2's
    own libavcodec, fed one VOP a packet."""
    cfg = random_config(100 + seed)
    headers, samples = MW.write(cfg)
    path = tmp_path / "p.mp4"
    path.write_bytes(MW.mp4(headers, samples, cfg.width, cfg.height))
    want = AO.decode([headers + samples[0], *samples[1:]], codec_id=AO.AV_CODEC_ID_MPEG4)
    got = list(video.read_frames(str(path), planes=True))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for p, (gp, wp) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gp, wp, err_msg=f"frame {i} plane {p}")


@pytest.mark.parametrize("feature", sorted(MW.REFUSALS))
def test_refusals_name_their_feature(tmp_path, feature):
    path = tmp_path / "f.mp4"
    path.write_bytes(MW.refusal(feature))
    with pytest.raises(NotImplementedError, match=MW.REFUSALS[feature]):
        list(video.read_frames(str(path)))


def test_truncated_stream_raises(tmp_path):
    headers, samples = MW.write(MW.Config(frames=3, seed=12))
    path = tmp_path / "t.mp4"
    cut = samples[:2] + [samples[2][:len(samples[2]) // 3]]
    path.write_bytes(MW.mp4(headers, cut, 48, 32))
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))
    data = MW.mp4(headers, samples, 48, 32)
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError):
        list(video.read_frames(str(path)))


def test_codec_picks_the_decoder():
    with open(os.path.join(MPEG4_FIXTURES, CV2_FIXTURE + ".mp4"), "rb") as f:
        assert video.codec_of(f.read()) == "mpeg4"
    with open(os.path.join(CS.H264_FIXTURES, "inter.mp4"), "rb") as f:
        assert video.codec_of(f.read()) == "h264"
    assert video.codec_of(b"\x00\x00\x00\x01\x67") == "h264"


def test_build_key_covers_included_headers(tmp_path):
    """``lib_path`` hashes a source and the ``native/*.h`` it includes: an
    edited header names another library, an unrelated one does not."""
    for name in ("mpeg4.cpp", "h264.cpp", "mp4.h", "yuv420_bgr.h", "jpeg.cpp"):
        shutil.copy(native.NATIVE_DIR / name, tmp_path / name)
    src = tmp_path / "mpeg4.cpp"
    assert native.local_headers(src) == [tmp_path / "mp4.h", tmp_path / "yuv420_bgr.h"]
    before = native.lib_path(src, ("-O3",))
    assert native.lib_path(tmp_path / "jpeg.cpp") == native.lib_path(
        native.NATIVE_DIR / "jpeg.cpp")
    with open(tmp_path / "yuv420_bgr.h", "a") as f:
        f.write("// edited\n")
    after = native.lib_path(src, ("-O3",))
    assert after != before
    assert native.lib_path(tmp_path / "h264.cpp", ("-O3",)) != native.lib_path(
        native.NATIVE_DIR / "h264.cpp", ("-O3",))
    assert native.lib_path(tmp_path / "jpeg.cpp") == native.lib_path(
        native.NATIVE_DIR / "jpeg.cpp")
    (tmp_path / "mp4.h").unlink()
    with pytest.raises(RuntimeError, match="mp4.h"):
        native.lib_path(src)


def test_chip_smoke_phase_18a_mpeg4_on_cpu(committed):
    out = CS.check_mpeg4_fixtures()
    assert out["files"] == len(FIXTURES) + 1
    assert out["frames"] == sum(len(v) for v in committed.values())


def test_chip_smoke_phase_18_runs_its_checks(monkeypatch):
    """``check_video_extraction`` (phase 18 of ``main``) runs (a) on the
    three codecs' committed streams, the MPEG-4 and HEVC decoders built in
    threads, then (b) and (c) (stubbed here: the rehearsals above,
    ``tests/test_torch_hevc.py`` and ``tests/test_torch_h264.py`` run them at
    a small size)."""
    calls = []
    for name in ("check_h264_fixtures", "check_mpeg4_fixtures", "check_hevc_fixtures"):
        real = getattr(CS, name)
        monkeypatch.setattr(CS, name, lambda real=real, name=name: calls.append(name) or real())
    monkeypatch.setattr(CS, "check_video_host_times", lambda: calls.append("b") or "host")
    monkeypatch.setattr(CS, "check_video_chain", lambda dev: calls.append(("c", dev)) or "chain")
    assert CS.check_video_extraction("dev") == ("host", "chain")
    assert calls == ["check_h264_fixtures", "check_mpeg4_fixtures", "check_hevc_fixtures", "b",
                     ("c", "dev")]


def test_chip_smoke_phase_18b_mpeg4_on_cpu():
    """Phase 18 (b)'s MPEG-4 stream on the CPU at a small size: I, P, P, P,
    each VOP's decode timed."""
    out = CS.check_mpeg4_host_times(size=(96, 72), frames=4)
    assert all(out[k] > 0 for k in ("decode_mpeg4_ms", "decode_mpeg4_i_ms",
                                    "decode_mpeg4_p_ms", "mpeg4_mbytes"))
