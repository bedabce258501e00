"""H.264 video reader over the port's native decoder (``native/h264.cpp``).

The JAX package reads a Neu3D camera's ``cam*.mp4`` with cv2's
``VideoCapture`` (``data/dynerf.py::_extract_video_frames``); the port
depends on no cv2, PyAV or FFmpeg, so it decodes the video itself. The
decoder is host C++ that links no codec library, built at first use with
``g++ -O3 -shared -fPIC`` into ``fourdgs_tpu_torch/_build/`` by the port's
native build helper (``utils/native.py::build``, keyed by a hash of source
and flags) and loaded with ``ctypes``.

Scope: an MP4 file's first video track or an Annex-B byte stream of
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
H.264. A truncated or corrupt stream raises ``ValueError``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import numpy as np

from fourdgs_tpu_torch.utils import native, png, resample

SRC = native.NATIVE_DIR / "h264.cpp"
FLAGS = ("-O3",)

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SRC, FLAGS)))
            lib.hv_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.hv_open.restype = ctypes.c_void_p
            lib.hv_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.hv_next.restype = ctypes.c_int
            lib.hv_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.hv_take.restype = None
            lib.hv_take_yuv.argtypes = [ctypes.c_void_p] * 4
            lib.hv_take_yuv.restype = None
            lib.hv_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_double)]
            lib.hv_info.restype = ctypes.c_int
            lib.hv_close.argtypes = [ctypes.c_void_p]
            lib.hv_close.restype = None
            _lib = lib
        return _lib


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
    "B") and the ms its decoding took, timed when it was decoded (a frame
    the reorder buffer holds comes out later). With ``planes`` each frame
    is instead its decoded samples, cropped: ``(Y [H, W], U, V [H/2, W/2])``
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    rc = ctypes.c_int()
    handle = lib.hv_open(data, len(data), ctypes.byref(rc), err, len(err))
    if not handle:
        _raise(rc.value, err, path)
    try:
        w, h = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = lib.hv_next(handle, ctypes.byref(w), ctypes.byref(h), err, len(err))
            if rc == 0:
                return
            if rc < 0:
                _raise(rc, err, path)
            if stats is not None:
                kinds, ms = ctypes.create_string_buffer(2), (ctypes.c_double * 2)()
                n = lib.hv_info(handle, kinds, ms)
                stats.append((kinds.raw[:n].decode(), tuple(ms[:n])))
            if planes:
                yuv = (np.empty((h.value, w.value), np.uint8),
                       *(np.empty((h.value // 2, w.value // 2), np.uint8) for _ in range(2)))
                lib.hv_take_yuv(handle, *(p.ctypes.data_as(ctypes.c_void_p) for p in yuv))
                yield yuv
                continue
            frame = np.empty((h.value, w.value, 3), np.uint8)
            lib.hv_take(handle, frame.ctypes.data_as(ctypes.c_void_p), int(bgr))
            yield frame
    finally:
        lib.hv_close(handle)


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
