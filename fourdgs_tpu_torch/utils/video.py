"""Video reader over the port's native decoders: H.264 (``native/h264.cpp``),
MPEG-4 Part 2 (``native/mpeg4.cpp``) and HEVC (``native/hevc.cpp``).

The JAX package reads a Neu3D camera's ``cam*.mp4`` with cv2's
``VideoCapture`` (``data/dynerf.py::_extract_video_frames``); the port
depends on no cv2, PyAV or FFmpeg, so it decodes the video itself. The
decoders are host C++ that link no codec library, each built at first use
with ``g++ -O3 -shared -fPIC`` into ``fourdgs_tpu_torch/_build/`` by the
port's native build helper (``utils/native.py::build``, keyed by a hash
of source, included headers and flags) and loaded with ``ctypes``; all
three have the same C API, and the MP4 track's sample entry picks one
(``mp4v``: MPEG-4 Part 2, ``hvc1`` and ``hev1``: HEVC, anything else and
Annex-B: H.264).

HEVC (what current phones, action cameras and x265 write): an MP4 file's
first video track with an ``hvc1`` or ``hev1`` sample entry of ITU-T H.265
Main (or Main Still Picture, or Main 10 at 8 bits), 8-bit 4:2:0
progressive, I, P and B slices (WPP, SAO, deblocking, AMP, weighted
prediction, scaling lists, long-term references, sign data hiding,
transform skip, cu_qp_delta), frames in cv2's order and number (RASL
pictures of a leading CRA dropped, ``pic_output_flag`` 0 kept back, the
reorder buffer of the highest sub-layer) and equal to cv2's bit for bit;
the decoder's header comment lists where it follows libavcodec. It refuses,
naming them: tiles, PCM, the lossless transquant bypass, dependent slice
segments, bit depths above 8, chroma other than 4:2:0, separate colour
planes, the range, SCC, 3D and multilayer extensions, fields coded as
pictures (``field_seq_flag``) and a reference missing from the buffer.

MPEG-4 Part 2 (what ``cv2.VideoWriter`` writes into an .mp4 for the
fourccs mp4v, FMP4, XVID and DIVX): an MP4 file's first video track with
an ``mp4v`` sample entry of objectTypeIndication 0x20, 8-bit 4:2:0
rectangular progressive I- and P-VOPs of the Simple Profile (H.263 and
MPEG quantisation, 4MV, AC prediction, video packets, N-VOPs), frames in
cv2's order and number and equal to cv2's bit for bit; the decoder's
header comment lists where it follows libavcodec and what it refuses
(B-VOPs, GMC, quarter-sample motion, interlace, data partitioning and the
encoder builds libavcodec works around among them).

H.264: an MP4 file's first video track or an Annex-B byte stream of
8-bit 4:2:0 H.264 coded with CABAC or CAVLC, I, P and B slices (what the
Baseline, Main and High profiles code, B pictures as x264's defaults write
them included), progressive or interlaced: frame pictures of streams
with ``frame_mbs_only_flag`` 0, with or without MBAFF (macroblock pairs
coded as frame or field macroblocks, as x264 codes interlace), and field
pictures (PAFF) among them, a field pair leaving as one frame of
interleaved lines and an unpaired field not at all, as libavcodec has
them; its frames come out in the order and number cv2 returns them
(FFmpeg's reorder buffer, which without the VUI's bitstream_restriction
grows as it meets pictures out of order and drops one whose turn has
passed) and equal cv2's bit for bit after the conversion cv2's libswscale
makes (each chroma sample serving its 2x2 block, the VUI's colour matrix
and range), cropped as the standard says. A frame coded as two fields or
as an MBAFF frame is converted the same way: cv2 returns no decode of it
(its libswscale refuses a frame libavcodec flags interlaced), so such
frames are held to libavcodec's samples in the tests. What the decoder
does not read raises ``NotImplementedError`` naming the feature: chroma
other than 4:2:0, bit depths above 8, the
lossless transform bypass, slice groups, arbitrary slice order, SP and SI
slices, data partitioning, gaps in ``frame_num``, a colour matrix cv2
does not convert, an edit list that drops samples and codecs other than
H.264, MPEG-4 Part 2 and HEVC (AV1, VP9, MJPEG among them). A truncated or
corrupt stream raises ``ValueError``.

An MP4 track's edit list may shift its start by the composition delay of
its first picture, as FFmpeg's muxer writes one for every stream with
B-frames (its ``ctts`` box giving each sample's offset): that drops no
frame, and cv2 returns them all. An edit that starts later than the
earliest composition time drops the samples before it; the decoders refuse
it, naming it.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import numpy as np

from fourdgs_tpu_torch.utils import native, png, resample

SRC = native.NATIVE_DIR / "h264.cpp"
MPEG4_SRC = native.NATIVE_DIR / "mpeg4.cpp"
HEVC_SRC = native.NATIVE_DIR / "hevc.cpp"
FLAGS = ("-O3",)

# each decoder's C API (``hv_*`` of h264.cpp, ``mv_*`` of mpeg4.cpp,
# ``hc_*`` of hevc.cpp):
# (argument types, result type) by name
_API = {
    "open": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
              ctypes.c_int], ctypes.c_void_p),
    "next": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
              ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "take": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], None),
    "take_yuv": ([ctypes.c_void_p] * 4, None),
    "info": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)], ctypes.c_int),
    "close": ([ctypes.c_void_p], None),
}
_CODECS = {"h264": (SRC, "hv_"), "mpeg4": (MPEG4_SRC, "mv_"), "hevc": (HEVC_SRC, "hc_")}
_libs = {}
_lib_locks = {codec: threading.Lock() for codec in _CODECS}


def get_lib(codec: str = "h264") -> dict:
    """The decoder of ``codec`` ("h264", "mpeg4" or "hevc"), built and
    loaded on first use (each under its own lock, so that they can build
    at once): its C API's functions by ``_API``'s names."""
    with _lib_locks[codec]:
        if codec not in _libs:
            src, prefix = _CODECS[codec]
            lib = ctypes.CDLL(str(native.build(src, FLAGS)))
            fns = {}
            for name, (args, res) in _API.items():
                fns[name] = getattr(lib, prefix + name)
                fns[name].argtypes, fns[name].restype = args, res
            _libs[codec] = fns
        return _libs[codec]


def _boxes(data: bytes, start: int, end: int):
    """The ISO-BMFF boxes in data[start:end] as {type: (body, end)} (the
    first of each type)."""
    out, pos = {}, start
    while pos + 8 <= end:
        size, hdr = int.from_bytes(data[pos:pos + 4], "big"), 8
        if size == 1:
            size, hdr = int.from_bytes(data[pos + 8:pos + 16], "big"), 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            break
        out.setdefault(data[pos + 4:pos + 8], (pos + hdr, pos + size))
        pos += size
    return out


def codec_of(data: bytes) -> str:
    """"mpeg4" for an MP4 file whose first video track's sample entry is
    ``mp4v``, "hevc" for ``hvc1`` or ``hev1``, else "h264" (whose decoder
    reads Annex-B and refuses, naming it, any other codec)."""
    moov = _boxes(data, 0, len(data)).get(b"moov")
    pos, end = moov if moov else (0, 0)
    while pos + 8 <= end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        if size < 8:
            break
        if data[pos + 4:pos + 8] == b"trak":
            mdia = _boxes(data, pos + 8, pos + size).get(b"mdia")
            md = _boxes(data, *mdia) if mdia else {}
            hdlr = md.get(b"hdlr")
            if hdlr and data[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                stbl = _boxes(data, *md.get(b"minf", (0, 0))).get(b"stbl", (0, 0))
                stsd = _boxes(data, *stbl).get(b"stsd")
                entry = data[stsd[0] + 12:stsd[0] + 16] if stsd else b""
                if entry == b"mp4v":
                    return "mpeg4"
                return "hevc" if entry in (b"hvc1", b"hev1") else "h264"
        pos += size
    return "h264"


def _raise(rc: int, err, path: str):
    msg = f"{path}: {err.value.decode(errors='replace')}"
    if rc == -2:
        raise NotImplementedError(msg)
    raise ValueError(msg)


def read_frames(path: str, bgr: bool = False, stats=None, planes: bool = False):
    """Yields the video's frames in output order as uint8 [H, W, 3], RGB
    (or BGR, as ``cv2.VideoCapture.read`` gives them). A list ``stats``
    receives for each frame ``(kinds, ms)``: one letter and one float for a
    frame coded as a frame, two for a frame coded as two fields (in
    decoding order), each coded picture's first slice type ("I", "P" or
    "B"; an MPEG-4 VOP's type "I" or "P", "N" for the frame a closing
    N-VOP repeats) and the ms its decoding took, timed when it was decoded
    (a frame the reorder buffer holds comes out later). With ``planes`` each
    frame is instead its decoded samples, cropped: ``(Y [H, W], U, V
    [H/2, W/2])`` uint8."""
    with open(path, "rb") as f:
        data = f.read()
    lib = get_lib(codec_of(data))
    err = ctypes.create_string_buffer(256)
    rc = ctypes.c_int()
    handle = lib["open"](data, len(data), ctypes.byref(rc), err, len(err))
    if not handle:
        _raise(rc.value, err, path)
    try:
        w, h = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = lib["next"](handle, ctypes.byref(w), ctypes.byref(h), err, len(err))
            if rc == 0:
                return
            if rc < 0:
                _raise(rc, err, path)
            if stats is not None:
                kinds, ms = ctypes.create_string_buffer(2), (ctypes.c_double * 2)()
                n = lib["info"](handle, kinds, ms)
                stats.append((kinds.raw[:n].decode(), tuple(ms[:n])))
            if planes:
                yuv = (np.empty((h.value, w.value), np.uint8),
                       *(np.empty((h.value // 2, w.value // 2), np.uint8) for _ in range(2)))
                lib["take_yuv"](handle, *(a.ctypes.data_as(ctypes.c_void_p) for a in yuv))
                yield yuv
                continue
            frame = np.empty((h.value, w.value, 3), np.uint8)
            lib["take"](handle, frame.ctypes.data_as(ctypes.c_void_p), int(bgr))
            yield frame
    finally:
        lib["close"](handle)


def extract_video_frames(video_path: str, out_dir: str, size, n_frames: int = 300) -> int:
    """JAX's ``_extract_video_frames``: the first ``n_frames`` frames of
    ``video_path`` (fewer where the video ends first), each resized to
    ``size`` = (W, H) with LANCZOS and written as ``out_dir/%04d.png``.
    Returns the number of frames written."""
    os.makedirs(out_dir, exist_ok=True)
    if n_frames <= 0:
        return 0
    count = 0
    with contextlib.closing(read_frames(video_path)) as frames:
        for frame in frames:
            img = resample.resize(frame, tuple(size), "lanczos")
            png.write_png(os.path.join(out_dir, "%04d.png" % count), img)
            count += 1
            if count >= n_frames:
                break
    return count
