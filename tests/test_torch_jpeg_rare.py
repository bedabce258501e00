"""The port's JPEG decoder (``native/jpeg.cpp``) on the rarer files Pillow
reads, bit for bit against Pillow (libjpeg-turbo), and the committed
fixtures of ``tests/torch_fixtures/rare``.

- Block smoothing: Pillow's progressive files (4:4:4, 4:2:2, 4:2:0, grey)
  cut after each of their scans, and the writer's progressive files of
  sampling factors 3 and 4 cut the same way; libjpeg smooths each.
- Sampling factors 1 to 4 in each direction: ``cv2.imwrite``'s 4:1:1 and
  4:4:0, and ``tests/jpeg_writer.py``'s grid of luma and chroma factors;
  fractional ratios and interleaved scans of more than 10 blocks raise
  where Pillow raises.
- Four components: Pillow's CMYK files, the writer's CMYK without an Adobe
  marker and YCCK (Adobe transforms 1 and 2), as Pillow's "CMYK;I" raw
  mode gives them, and ``png.convert``'s CMYK to RGB against Pillow's.
- Arithmetic coding (SOF9, SOF10): the writer's files of the same
  coefficients Huffman-coded and arithmetic-coded, restart intervals, DAC
  conditioning, grey.
- Lossless (SOF3): predictors 1 to 7 by point transforms, one interleaved
  scan or a scan per component, restart intervals, grey, a subsampled
  component, CMYK, and libjpeg's colour rules (ids, JFIF, Adobe).
- What stays refused, each beside Pillow's refusal of the same file:
  12-bit samples, 16-bit lossless, hierarchical files, a DNL height,
  2-component files, arithmetic-coded lossless files, a lossless restart
  interval of part of an MCU row, the colour conversion of a lossless file.
- The committed fixtures against Pillow's decodes, the generator that wrote
  them, the port's ``ImageRef`` against JAX's on each, the MultipleView
  loader against JAX's on ``chip_smoke.py`` phase 17 (b)'s scene, and
  phase 17 itself on the CPU.
"""

import io
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu.configs.core import load_config as jload
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.data.dynerf import ImageRef as JImageRef
from fourdgs_tpu_torch import scripts
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.utils import jpeg, png
from tests import jpeg_writer as W
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_colmap import assert_same_scene
from tests.test_torch_dynerf_cli import OVERRIDES as NARROW
from tests.test_torch_jpeg import make_image

RARE = CS.RARE_FIXTURES


def pillow(data: bytes):
    """Pillow's decode of a file's bytes, or the exception it raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im)
    except (OSError, SyntaxError) as e:
        return e


def port(tmp_path, data: bytes, name="f.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    return jpeg.read_jpeg(str(path))


def check_exact(tmp_path, data: bytes, want=None):
    """read_jpeg of ``data`` equal to Pillow's decode (and to ``want``)."""
    ref = pillow(data)
    assert isinstance(ref, np.ndarray), ref
    got = port(tmp_path, data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return got


def check_refused_alike(tmp_path, data: bytes, error, match):
    """Pillow refuses the file, and the port raises ``error`` matching ``match``."""
    assert isinstance(pillow(data), (OSError, SyntaxError))
    with pytest.raises(error, match=match):
        port(tmp_path, data)


def ycc_planes(w, h, seed):
    return list(W.rgb_to_ycc(make_image(w, h, seed=seed)).transpose(2, 0, 1))


# -- block smoothing --------------------------------------------------------------


@pytest.mark.parametrize("cut", range(1, 10))
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_smoothing_matches_pillow(tmp_path, subsampling, cut):
    """A Pillow progressive file cut after each of its ten scans: libjpeg
    smooths the blocks whose low-frequency coefficients are unrefined (the
    5×5 DC neighbourhood, and the DC itself while no AC coefficient has
    been seen), and so does the port."""
    buf = io.BytesIO()
    Image.fromarray(make_image(67, 45, seed=cut)).save(buf, "JPEG", progressive=True,
                                                       quality=85, subsampling=subsampling)
    data = buf.getvalue()
    assert data.count(b"\xff\xda") == 10
    check_exact(tmp_path, CS.scans_cut(data, cut))


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (40, 8)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_smoothing_grey_and_small(tmp_path, size):
    buf = io.BytesIO()
    Image.fromarray(make_image(*size, channels=1, seed=3)).save(buf, "JPEG", progressive=True,
                                                                quality=60)
    data = buf.getvalue()
    for cut in range(1, data.count(b"\xff\xda")):
        check_exact(tmp_path, CS.scans_cut(data, cut))


@pytest.mark.parametrize("factors", [[(4, 2), (1, 1), (1, 1)], [(1, 3), (1, 1), (1, 1)],
                                     [(2, 4), (1, 1), (1, 1)], [(1, 4), (1, 2), (1, 1)],
                                     [(2, 2)]],
                         ids=["42_11_11", "13_11_11", "24_11_11", "14_12_11", "grey22"])
def test_smoothing_at_factors_3_and_4(tmp_path, factors):
    """The writer's progressive files cut after each scan: libjpeg walks the
    blocks by iMCU rows of each component's v, whose last may be short."""
    planes = ycc_planes(53, 45, seed=4)[:len(factors)]
    frame = W.dct_frame(planes, factors, W.quality_tables(70))
    data = W.write_dct(frame, scans=W.simple_progression(len(factors)))
    for cut in range(1, data.count(b"\xff\xda")):
        check_exact(tmp_path, CS.scans_cut(data, cut))


# -- sampling factors ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["411", "440", "422", "420"])
@pytest.mark.parametrize("progressive", [0, 1], ids=["seq", "prog"])
def test_cv2_sampling_factors(tmp_path, name, progressive):
    """``cv2.imwrite``'s sampling factors, 4:1:1 (luma 4×1) among them."""
    for size in [(64, 48), (37, 23), (5, 3), (33, 7)]:
        ok, enc = cv2.imencode(".jpg", make_image(*size, seed=size[0])[:, :, ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}")])
        assert ok
        check_exact(tmp_path, enc.tobytes())


FACTOR_GRID = list(dict.fromkeys(
    ((yh, yv), c) for yh in range(1, 5) for yv in range(1, 5)
    for c in [(1, 1), (1, 2), (2, 1), (2, 2), (yh, yv)]
    if c[0] <= yh and c[1] <= yv and (c != (yh, yv) or yh * yv <= 3)))


@pytest.mark.parametrize("luma,chroma", FACTOR_GRID, ids=[f"{a[0]}{a[1]}_{b[0]}{b[1]}"
                                                          for a, b in FACTOR_GRID])
def test_sampling_factor_grid(tmp_path, luma, chroma):
    """Luma factors 1 to 4 by chroma factors: each whole ratio decodes as
    Pillow decodes it (h2v1, h1v2 and h2v2 fancy, replication otherwise),
    sequential interleaved, one scan per component and progressive
    arithmetic-coded; a fractional ratio raises ``NotImplementedError``
    and an interleaved scan of more than 10 blocks ``ValueError``, where
    Pillow refuses the file."""
    frame = W.dct_frame(ycc_planes(37, 23, seed=2), [luma, chroma, chroma],
                        W.quality_tables(80))
    fractional = luma[0] % chroma[0] or luma[1] % chroma[1]
    too_many = luma[0] * luma[1] + 2 * chroma[0] * chroma[1] > 10
    for data in (W.write_dct(frame),
                 W.write_dct(frame, arithmetic=True, scans=W.simple_progression(3))):
        if fractional:
            check_refused_alike(tmp_path, data, NotImplementedError, "by a fraction")
        elif too_many:
            check_refused_alike(tmp_path, data, ValueError, "too large for an interleaved")
        else:
            check_exact(tmp_path, data)
    if not fractional:      # one scan per component: no MCU limit
        check_exact(tmp_path, W.write_dct(frame, interleaved=False))


def test_a_sampling_factor_above_4_raises(tmp_path):
    data = bytearray(W.write_dct(W.dct_frame(ycc_planes(16, 16, 1), [(1, 1)] * 3,
                                             W.quality_tables(80))))
    at = data.index(b"\xff\xc1")
    data[at + 11] = 0x51                        # the first component 5x1
    check_refused_alike(tmp_path, bytes(data), ValueError, "bad sampling factors")


# -- four components -----------------------------------------------------------------


@pytest.mark.parametrize("options", [{}, {"progressive": True}, {"subsampling": 2},
                                     {"quality": 30, "optimize": True}],
                         ids=["baseline", "progressive", "420", "q30"])
def test_pillow_cmyk(tmp_path, options):
    """Pillow's CMYK files (Adobe transform 0), read as Pillow opens them
    (inverted, "CMYK;I"); through ``ImageRef``, Pillow's conversion to RGB."""
    for size in [(40, 30), (7, 5)]:
        buf = io.BytesIO()
        Image.fromarray(make_image(*size, seed=5)).convert("CMYK").save(buf, "JPEG", **options)
        got = check_exact(tmp_path, buf.getvalue())
        assert got.shape == (size[1], size[0], 4)
        path = str(tmp_path / "f.jpg")
        np.testing.assert_array_equal(ImageRef(path, size)(), JImageRef(path, size)())


@pytest.mark.parametrize("app", [W.adobe(2), W.adobe(1), W.adobe(0), b""],
                         ids=["ycck", "adobe1_ycck", "cmyk", "no_marker_cmyk"])
@pytest.mark.parametrize("factors", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)]],
                         ids=["4444", "2112"])
def test_ycck_and_cmyk(tmp_path, app, factors):
    """Four components: YCCK under an Adobe marker of any transform but 0
    (libjpeg's ycck_cmyk_convert), CMYK otherwise; Huffman, progressive and
    arithmetic-coded."""
    planes = ycc_planes(37, 23, seed=6) + [make_image(37, 23, channels=1, seed=7)]
    frame = W.dct_frame(planes, factors, W.quality_tables(75), tqs=[0, 1, 1, 0], app=app)
    for data in (W.write_dct(frame), W.write_dct(frame, scans=W.simple_progression(4)),
                 W.write_dct(frame, arithmetic=True)):
        assert check_exact(tmp_path, data).shape == (23, 37, 4)
        path = str(tmp_path / "f.jpg")
        np.testing.assert_array_equal(ImageRef(path, (37, 23))(), JImageRef(path, (37, 23))())


def test_cmyk_to_rgb_is_pillows():
    """``png.convert(img, "RGB", "CMYK")`` against Pillow's cmyk2rgb on every
    pair of a channel and K."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, np.roll(c, 7, 0), np.roll(c, 91, 1), k], -1).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(png.convert(cmyk, "RGB", "CMYK"), want)
    with pytest.raises(ValueError):
        png.convert(cmyk, "L", "CMYK")


# -- arithmetic coding -----------------------------------------------------------------

DAC = {"dc": {0: (1, 3), 1: (0, 0)}, "ac": {0: 2, 1: 12}}


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (37, 23), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("factors", [[(1, 1)] * 3, [(2, 1), (1, 1), (1, 1)],
                                     [(2, 2), (1, 1), (1, 1)]], ids=["444", "422", "420"])
@pytest.mark.parametrize("restart", [0, 1, 3])
def test_arithmetic_matches_pillow(tmp_path, size, factors, restart):
    """The same coefficients arithmetic-coded, sequential (SOF9, with DAC
    conditioning when restarts are off) and progressive (SOF10, libjpeg's
    scan script), decode as their Huffman-coded twins under Pillow and the
    port."""
    frame = W.dct_frame(ycc_planes(*size, seed=size[0]), factors, W.quality_tables(85))
    for scans in (None, W.simple_progression(3)):
        twin = pillow(W.write_dct(frame, scans=scans, restart=restart))
        data = W.write_dct(frame, arithmetic=True, scans=scans, restart=restart,
                           dac=None if restart else DAC)
        assert (b"\xff\xc9" if scans is None else b"\xff\xca") in data
        check_exact(tmp_path, data, twin)


def test_arithmetic_grey(tmp_path):
    frame = W.dct_frame([make_image(37, 23, channels=1, seed=8)], [(1, 1)],
                        {0: W.quality_tables(60)[0]})
    for scans in (None, W.simple_progression(1)):
        twin = pillow(W.write_dct(frame, scans=scans))
        assert check_exact(tmp_path, W.write_dct(frame, arithmetic=True, scans=scans),
                           twin).ndim == 2


# -- lossless ----------------------------------------------------------------------


@pytest.mark.parametrize("pt", [0, 1, 3, 7])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_matches_pillow(tmp_path, psv, pt):
    """Lossless RGB ('R', 'G', 'B' ids: no conversion) by predictor and
    point transform, interleaved and a scan per component, with and without
    restarts, and grey: each decodes to the samples it holds, as Pillow
    decodes it."""
    img = make_image(23, 17, seed=psv)
    want = (img >> pt) << pt
    for interleaved in (True, False):
        for rows in (0, 1, 4):
            comps = [W.Component(ord(ch), 1, 1, samples=img[:, :, i])
                     for i, ch in enumerate("RGB")]
            check_exact(tmp_path, W.write_lossless(23, 17, comps, psv=psv, pt=pt,
                                                   restart_rows=rows, interleaved=interleaved),
                        want)
    grey = [W.Component(1, 1, 1, samples=img[:, :, 0])]
    check_exact(tmp_path, W.write_lossless(23, 17, grey, psv=psv, pt=pt, restart_rows=3),
                want[:, :, 0])


@pytest.mark.parametrize("app,ids,rgb", [
    (b"", (1, 2, 3), True), (W.adobe(0), (1, 2, 3), True), (b"", (5, 6, 7), True),
    (b"", (82, 71, 66), True), (W.JFIF, (1, 2, 3), False), (W.adobe(1), (1, 2, 3), False)],
    ids=["ids123", "adobe0", "other_ids", "RGB_ids", "jfif", "adobe1"])
def test_lossless_colour_rules(tmp_path, app, ids, rgb):
    """libjpeg's colour space of a lossless file: RGB without a marker
    (whatever the ids) and under Adobe transform 0; YCbCr under JFIF or
    Adobe transform 1, whose conversion libjpeg refuses in a lossless file."""
    img = make_image(23, 17, seed=9)
    comps = [W.Component(ids[i], 1, 1, samples=img[:, :, i]) for i in range(3)]
    data = W.write_lossless(23, 17, comps, psv=4, app=app)
    if rgb:
        check_exact(tmp_path, data, img)
    else:
        check_refused_alike(tmp_path, data, NotImplementedError, "conversion of a lossless")


def test_lossless_subsampled_and_four_components(tmp_path):
    """A 2h2v lossless component among 1×1 ones is replicated (no fancy
    upsampling without a DCT); four components are CMYK, and YCCK (Adobe
    transform 2) is refused as libjpeg refuses it."""
    img = make_image(23, 17, seed=10)
    frame = W.Frame(23, 17, [W.Component(ord(ch), h, h) for ch, h in zip("RGB", (1, 2, 1))])
    frame.geometry(unit=1)
    for i, c in enumerate(frame.comps):
        c.samples = img[::2 // c.v, ::2 // c.h, i][:c.dh, :c.dw] if c.h == 1 else img[:, :, 1]
    want = np.stack([np.repeat(np.repeat(c.samples, 2 // c.v, 0), 2 // c.h, 1)[:17, :23]
                     for c in frame.comps], -1)
    check_exact(tmp_path, W.write_lossless(23, 17, frame.comps, psv=6), want)
    four = np.concatenate([img, img[:, :, :1]], 2)
    comps = [W.Component(i + 1, 1, 1, samples=four[:, :, i]) for i in range(4)]
    check_exact(tmp_path, W.write_lossless(23, 17, comps, psv=2), 255 - four)
    check_refused_alike(tmp_path, W.write_lossless(23, 17, comps, psv=2, app=W.adobe(2)),
                        NotImplementedError, "YCCK-to-CMYK conversion")


# -- what stays refused -------------------------------------------------------------


def _with_sof(data: bytes, marker: int, precision=None, height=None) -> bytes:
    at = next(i for i in range(len(data) - 1) if data[i] == 0xFF and 0xC0 <= data[i + 1] <= 0xCF
              and data[i + 1] not in (0xC4, 0xC8, 0xCC))
    out = bytearray(data)
    out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    if height is not None:
        out[at + 5:at + 7] = height.to_bytes(2, "big")
    return bytes(out)


def _baseline():
    buf = io.BytesIO()
    Image.fromarray(make_image(37, 23, seed=11)).save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _lossless():
    img = make_image(23, 17, seed=12)
    return W.write_lossless(23, 17, [W.Component(ord(ch), 1, 1, samples=img[:, :, i])
                                     for i, ch in enumerate("RGB")], psv=1)


REFUSED = {
    "12-bit": (lambda: _with_sof(_baseline(), 0xC1, precision=12), "12-bit samples"),
    "16-bit_lossless": (lambda: _with_sof(_lossless(), 0xC3, precision=16), "16-bit samples"),
    "sof5": (lambda: _with_sof(_baseline(), 0xC5), "hierarchical"),
    "sof6": (lambda: _with_sof(_baseline(), 0xC6), "hierarchical"),
    "sof7": (lambda: _with_sof(_lossless(), 0xC7), "hierarchical"),
    "sof13": (lambda: _with_sof(_baseline(), 0xCD), "hierarchical"),
    "sof14": (lambda: _with_sof(_baseline(), 0xCE), "hierarchical"),
    "sof15": (lambda: _with_sof(_lossless(), 0xCF), "hierarchical"),
    "sof11": (lambda: _with_sof(_lossless(), 0xCB), "arithmetic-coded lossless"),
    "dnl": (lambda: _with_sof(_baseline(), 0xC0, height=0), "DNL"),
    "2-component": (lambda: W.write_dct(W.dct_frame(ycc_planes(16, 8, 13)[:2], [(1, 1)] * 2,
                                                    W.quality_tables(80))), "2-component"),
    "lossless_partial_row_restart": (
        lambda: W.write_lossless(23, 17, [W.Component(1, 1, 1, samples=make_image(
            23, 17, channels=1))]).replace(b"\xff\xc3", b"\xff\xdd\x00\x04\x00\x05\xff\xc3", 1),
        "restart interval"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_beside_pillow(tmp_path, case):
    """What the port does not read raises ``NotImplementedError`` naming it,
    on a file Pillow refuses too."""
    build, match = REFUSED[case]
    check_refused_alike(tmp_path, build(), NotImplementedError, match)


# -- committed fixtures ---------------------------------------------------------------

FACTOR_FIXTURES = [("31_11_11", [(3, 1), (1, 1), (1, 1)], True),
                   ("14_12_11", [(1, 4), (1, 2), (1, 1)], True),
                   ("22_12_21", [(2, 2), (1, 2), (2, 1)], True),
                   ("24_11_11", [(2, 4), (1, 1), (1, 1)], True),
                   ("33_11_11_sep", [(3, 3), (1, 1), (1, 1)], False),
                   ("44_22_11_sep", [(4, 4), (2, 2), (1, 1)], False)]


def _lossless_markers(i):
    """Frame i's lossless markers and ids: Adobe transform 0, 'R' 'G' 'B'
    ids, or ids 1 2 3 without a marker (libjpeg's RGB for lossless)."""
    return [(W.adobe(0), (1, 2, 3)), (b"", (82, 71, 66)), (b"", (1, 2, 3))][i % 3]


def write_committed_fixtures(out_dir):
    """Write ``tests/torch_fixtures/rare``: the twelve committed frames of
    ``tests/torch_fixtures/jpeg`` arithmetic-coded sequential and
    progressive (their coefficients read back by ``tests/jpeg_writer.py``)
    and lossless RGB (their Pillow decodes), each checked to decode under
    Pillow as the committed frame; the pictures of phase 17 (b)'s smoothed,
    4:1:1 and CMYK slots (``chip_smoke.rare_kind``) written by Pillow (a
    progressive file cut after 1 to 9 scans) and ``cv2.imwrite``; small
    files of each case (arithmetic with restarts and DAC conditioning,
    sampling factors, YCCK and CMYK, smoothing at 4:4:4, 4:2:2, 4:2:0 and
    4×2 luma, lossless predictors 1 to 7); and ``pillow_decode.npz``:
    Pillow's decode of each file by stem (but the re-encoded frames', which
    are the committed frames'), a 4-component file's RGB as
    ``<stem>.RGB``, the variants' ``prog_unrefined``, and the SHA-256 of
    the decode of the 1352×1014 progressive picture cut after
    ``chip_smoke.RARE_CUT`` scans. Every arithmetic-coded file is checked
    against its Huffman-coded twin under Pillow, every lossless one against
    the samples it holds."""
    os.makedirs(out_dir, exist_ok=True)
    with np.load(os.path.join(CS.JPEG_FIXTURES, "pillow_decode.npz")) as z:
        baseline = {k: z[k] for k in z.files}
    decodes = {}

    def put(name, data, want=None, twin=None):
        with open(os.path.join(out_dir, name + ".jpg"), "wb") as f:
            f.write(data)
        got = pillow(data)
        assert isinstance(got, np.ndarray), (name, got)
        if twin is not None:
            np.testing.assert_array_equal(got, pillow(twin), err_msg=name)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        scene = "_frame_" in name              # a 160x120 picture: its SHA-256
        if not (scene and name.startswith(CS.RARE_FRAME_KINDS)):
            decodes[name + ".sha256" * scene] = np.array(CS.decode_sha256(got)) if scene else got
        if got.ndim == 3 and got.shape[2] == 4:
            with Image.open(io.BytesIO(data)) as im:
                rgb = np.asarray(im.convert("RGB"))
            decodes[name + ".RGB" + ".sha256" * scene] = (np.array(CS.decode_sha256(rgb))
                                                          if scene else rgb)

    prog = W.simple_progression(3)
    for c in range(CS.JPEG_SCENE_CAMS):
        for f in range(CS.JPEG_SCENE_FRAMES):
            i, stem = c * CS.JPEG_SCENE_FRAMES + f, f"frame_c{c}_f{f}"
            with open(os.path.join(CS.JPEG_FIXTURES, stem + ".jpg"), "rb") as fh:
                frame = W.read_baseline(fh.read())
            rst = (0, 5, 12)[i % 3]
            put(f"arith_{stem}", W.write_dct(frame, arithmetic=True, restart=rst,
                                             dac=DAC if i % 2 else None),
                baseline[stem], W.write_dct(frame, restart=rst))
            rst = (0, 3)[i % 2]
            put(f"arithprog_{stem}", W.write_dct(frame, arithmetic=True, scans=prog,
                                                 restart=rst),
                baseline[stem], W.write_dct(frame, scans=prog, restart=rst))
            app, ids = _lossless_markers(i)
            img = baseline[stem]
            comps = [W.Component(ids[k], 1, 1, samples=img[:, :, k]) for k in range(3)]
            put(f"lossless_{stem}", W.write_lossless(160, 120, comps, psv=1 + i % 7,
                                                     restart_rows=(0, 0, 15)[i % 3], app=app),
                img)
            kind = CS.rare_kind(c, f)
            if kind in CS.RARE_FRAME_KINDS:
                continue
            picture = CS.render_gt(CS.jpeg_scene_camera(c, f)[0], torch.device("cpu"),
                                   [1.0] * 3)
            buf = io.BytesIO()
            if kind == "smooth":
                Image.fromarray(picture).save(buf, "JPEG", progressive=True, quality=90)
                data = CS.scans_cut(buf.getvalue(), 1 + (i * 4) % 9)
            elif kind == "s411":
                ok, enc = cv2.imencode(".jpg", picture[:, :, ::-1], [
                    cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
                data = enc.tobytes()
            else:
                Image.fromarray(picture).convert("CMYK").save(buf, "JPEG", quality=90)
                data = buf.getvalue()
            put(f"{kind}_{stem}", data)

    planes, qt = ycc_planes(37, 23, seed=14), W.quality_tables(75)
    fr = W.dct_frame(planes, [(2, 2), (1, 1), (1, 1)], qt)
    put("arith_seq_rst_dac_420_37x23", W.write_dct(fr, arithmetic=True, restart=2, dac=DAC),
        twin=W.write_dct(fr, restart=2))
    fr = W.dct_frame(ycc_planes(32, 24, seed=15), [(1, 1)] * 3, W.quality_tables(90))
    put("arith_prog_rst_444_32x24", W.write_dct(fr, arithmetic=True, scans=prog, restart=3),
        twin=W.write_dct(fr, scans=prog, restart=3))
    fr = W.dct_frame([make_image(37, 23, channels=1, seed=16)], [(1, 1)], {0: qt[0]})
    put("arith_prog_grey_37x23", W.write_dct(fr, arithmetic=True,
                                             scans=W.simple_progression(1)),
        twin=W.write_dct(fr, scans=W.simple_progression(1)))
    for name, factors, interleaved in FACTOR_FIXTURES:
        put(f"factors_{name}_37x23", W.write_dct(W.dct_frame(planes, factors, qt),
                                                 interleaved=interleaved))
    k = make_image(37, 23, channels=1, seed=17)
    fr = W.dct_frame(planes + [k], [(2, 2), (1, 1), (1, 1), (2, 2)], qt, tqs=[0, 1, 1, 0],
                     app=W.adobe(2))
    put("ycck_2112_37x23", W.write_dct(fr))
    fr.app = b""
    put("cmyk_nomarker_2112_37x23", W.write_dct(fr))
    fr = W.dct_frame(planes + [k], [(1, 1)] * 4, qt, tqs=[0, 1, 1, 0], app=W.adobe(2))
    put("ycck_prog_arith_37x23", W.write_dct(fr, arithmetic=True, scans=W.simple_progression(4)),
        twin=W.write_dct(fr, scans=W.simple_progression(4)))
    for name, sub, cut in (("444_cut1", 0, 1), ("422_cut5", 1, 5), ("420_cut9", 2, 9)):
        buf = io.BytesIO()
        Image.fromarray(make_image(64, 48, seed=18)).save(buf, "JPEG", progressive=True,
                                                          quality=80, subsampling=sub)
        put(f"smooth_{name}_64x48", CS.scans_cut(buf.getvalue(), cut))
    fr = W.dct_frame(ycc_planes(53, 45, seed=19), [(4, 2), (1, 1), (1, 1)], qt)
    put("smooth_42_11_11_cut2_53x45", CS.scans_cut(W.write_dct(fr, scans=prog), 2))
    img = make_image(23, 17, seed=20)
    for psv in range(1, 8):
        pt = (0, 1, 2, 3, 0, 1, 2)[psv - 1]
        comps = [W.Component(ord(ch), 1, 1, samples=img[:, :, i]) for i, ch in enumerate("RGB")]
        put(f"lossless_p{psv}_pt{pt}_23x17",
            W.write_lossless(23, 17, comps, psv=psv, pt=pt, restart_rows=2 * (psv % 2),
                             interleaved=psv != 3), (img >> pt) << pt)
    put("lossless_grey_rst_23x17", W.write_lossless(
        23, 17, [W.Component(1, 1, 1, samples=img[:, :, 0])], psv=7, restart_rows=3),
        img[:, :, 0])
    four = np.concatenate([img, img[:, :, :1]], 2)
    put("lossless_cmyk_23x17", W.write_lossless(
        23, 17, [W.Component(i + 1, 1, 1, samples=four[:, :, i]) for i in range(4)], psv=5),
        255 - four)

    with Image.open(os.path.join(CS.VARIANT_FIXTURES, "prog_unrefined.jpg")) as im:
        decodes["prog_unrefined"] = np.asarray(im)
    with open(os.path.join(CS.VARIANT_FIXTURES, f"{CS.CAPTURE_FRAME}_progressive.jpg"),
              "rb") as fh:
        cut = pillow(CS.scans_cut(fh.read(), CS.RARE_CUT))
    decodes["capture_smooth.sha256"] = np.array(CS.decode_sha256(cut))
    with zipfile.ZipFile(os.path.join(out_dir, "pillow_decode.npz"), "w",
                         zipfile.ZIP_DEFLATED, compresslevel=9) as zf:
        for name, arr in decodes.items():
            with zf.open(name + ".npy", "w") as fh:
                np.lib.format.write_array(fh, arr)
    return decodes


def committed_files():
    return sorted(f[:-4] for f in os.listdir(RARE) if f.endswith(".jpg"))


def test_committed_fixtures_are_pillows():
    """Each committed file decodes under Pillow and the port as its
    committed decode says (the re-encoded frames as the committed frames),
    its RGB as Pillow's conversion; the additions stay small."""
    rare = CS.rare_decodes()
    with np.load(os.path.join(CS.JPEG_FIXTURES, "pillow_decode.npz")) as z:
        baseline = {k: z[k] for k in z.files}
    names = committed_files()
    assert len(names) == 36 + 6 + 3 + len(FACTOR_FIXTURES) + 3 + 4 + 7 + 2
    for name in names:
        path = os.path.join(RARE, name + ".jpg")
        want = CS.rare_want(name, rare, baseline)
        with Image.open(path) as im:
            assert CS.same_decode(np.asarray(im), want), name
            assert CS.same_decode(np.asarray(im.convert("RGB")),
                                  CS.rare_want(name, rare, baseline, "RGB")), name
        assert CS.same_decode(jpeg.read_jpeg(path), want), name
    np.testing.assert_array_equal(
        jpeg.read_jpeg(os.path.join(CS.VARIANT_FIXTURES, "prog_unrefined.jpg")),
        rare["prog_unrefined"])
    total = sum(os.path.getsize(os.path.join(RARE, f)) for f in os.listdir(RARE))
    assert total < 400_000, total


def test_the_generator_wrote_the_committed_fixtures(tmp_path):
    got = write_committed_fixtures(str(tmp_path))
    want = CS.rare_decodes()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert sum(name.endswith(".sha256") for name in want) == 6 + 2 + 1
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(RARE))
    for name in committed_files():
        assert (tmp_path / (name + ".jpg")).read_bytes() == \
            open(os.path.join(RARE, name + ".jpg"), "rb").read(), name


def test_image_ref_matches_jax_on_every_fixture():
    """The port's ``ImageRef`` against JAX's (Pillow's ``convert("RGB")``)
    on every committed file, bit for bit, at the file's size and resized."""
    for name in committed_files():
        path = os.path.join(RARE, name + ".jpg")
        with Image.open(path) as im:
            size = im.size
        for s in (size, (size[0] + 3, size[1])):
            np.testing.assert_array_equal(ImageRef(path, s)(), JImageRef(path, s)(),
                                          err_msg=f"{name} at {s}")


def test_multipleview_loader_matches_jax(tmp_path):
    """Phase 17 (b)'s MultipleView scene of the rarer codings: the port's
    loader against JAX's, every frame bit for bit."""
    root = tmp_path / "scene"
    CS.write_multipleview_scene(str(root), frame=CS.rare_frame)
    got = tscene.load_scene(tload(), str(root))
    want = jscene.load_scene(jload(), str(root))
    assert_same_scene(got, want, "MultipleView")
    for g, w in zip(got.train_cameras + got.test_cameras, want.train_cameras + want.test_cameras):
        np.testing.assert_array_equal(g.image(), w.image(), err_msg=g.image.path)
    assert {CS.rare_kind(c, f) for c in range(CS.JPEG_SCENE_CAMS)
            for f in range(CS.JPEG_SCENE_FRAMES)} == set(CS.RARE_SCENE_KINDS)


def test_chip_smoke_rare_phase_on_cpu(capsys):
    """Phase 17 on the CPU: (a) every committed file and the 1352×1014
    picture in each coding, timed; (b) the MultipleView chain at a narrow
    width on the plain path (every frame through the ref's decoder),
    K1 and K2 held to their plain versions at a step of its model."""
    res = CS.check_rare_decoders(reps=1)
    assert res["files"] == len(committed_files()) + 1
    assert sorted(res["ms"]) == sorted(["smooth", "s411", "cmyk", "ycck", "arith",
                                        "arithprog", "lossless", "baseline"])
    assert all(ms > 0 for ms in res["ms"].values())
    schedule = [o for o in NARROW if not o.startswith(("opt.", "tpu."))] + [
        "opt.coarse_iterations=2", "opt.iterations=3", "opt.position_lr_max_steps=3",
        "tpu.capacity=16384", "tpu.instance_budget=16384", "tpu.tile_budget=256",
        "tpu.blend_chunk=256"]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("ITERS", "REPS", "WARMUP"):
            mp.setattr(scripts, name, 1)
        mp.setattr(blend, "k2_reduction",
                   lambda: {"batch": 3, "shuffles": 31, "unbatched": 50})
        chain = CS.check_rare_chain(torch.device("cpu"), schedule=schedule)
    out = capsys.readouterr().out
    assert chain["cli"] == (0, 0)                                  # the plain path
    assert '"submitted": 5, "native": 0, "to_ref": 5' in out
    assert "every loaded frame equal to Pillow's RGB" in out
    assert np.isfinite(chain["psnr"])
