"""The decode of cv2's own libavcodec, for frames cv2 cannot return and
for the decoded samples of a stream.

cv2 5.0's ``VideoCapture`` converts each decoded frame with libswscale,
which (9.5) refuses a frame libavcodec flags interlaced ("Cannot convert
interlaced to progressive frames"): for a frame coded as two fields cv2
returns a BGR buffer it never wrote. The tests therefore take such frames
from the libavcodec of cv2's wheel (``opencv_python.libs``), loaded with
ctypes and fed one access unit a packet on one thread, as YUV planes; and
let cv2 convert them by decoding them again from an I_PCM stream of those
samples (:func:`tests.h264_writer.pcm_stream`), whose frames libavcodec
does not flag interlaced. Test code only: the port uses none of this.
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

AV_CODEC_ID_H264 = 27
AV_CODEC_ID_MPEG4 = 12
EAGAIN = -11
# AVPacket: buf, pts, dts, then data and size; AVFrame: data[8],
# linesize[8], extended_data, width, height
_PKT_DATA, _PKT_SIZE = 24, 32
_FRAME_LINESIZE, _FRAME_W, _FRAME_H = 64, 104, 108

_libs = None


def _load():
    global _libs
    if _libs is None:
        import cv2

        d = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        util = ctypes.CDLL(glob.glob(os.path.join(d, "libavutil-*.so*"))[0])
        codec = ctypes.CDLL(glob.glob(os.path.join(d, "libavcodec-*.so*"))[0])
        vp = ctypes.c_void_p
        codec.avcodec_find_decoder.restype = vp
        codec.avcodec_alloc_context3.restype = vp
        codec.avcodec_alloc_context3.argtypes = [vp]
        codec.avcodec_open2.argtypes = [vp, vp, vp]
        codec.av_packet_alloc.restype = vp
        codec.av_new_packet.argtypes = [vp, ctypes.c_int]
        codec.av_packet_unref.argtypes = [vp]
        codec.av_packet_free.argtypes = [ctypes.POINTER(vp)]
        codec.avcodec_send_packet.argtypes = [vp, vp]
        codec.avcodec_receive_frame.argtypes = [vp, vp]
        codec.avcodec_free_context.argtypes = [ctypes.POINTER(vp)]
        util.av_frame_alloc.restype = vp
        util.av_frame_unref.argtypes = [vp]
        util.av_frame_free.argtypes = [ctypes.POINTER(vp)]
        util.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        _libs = codec, util
    return _libs


def _plane(frame, i, w, h):
    ptr = ctypes.c_void_p.from_address(frame + 8 * i).value
    stride = ctypes.c_int.from_address(frame + _FRAME_LINESIZE + 4 * i).value
    buf = (ctypes.c_uint8 * (stride * (h - 1) + w)).from_address(ptr)
    rows = np.frombuffer(buf, np.uint8)
    return np.stack([rows[r * stride:r * stride + w] for r in range(h)])


def decode(packets, threads=1, codec_id=AV_CODEC_ID_H264):
    """Each output frame of the ``packets`` of codec ``codec_id`` (H.264:
    Annex-B access units, parameter sets in band; MPEG-4 Part 2: one VOP a
    packet, the headers leading the first) as (Y, U, V) uint8 planes,
    cropped as libavcodec crops them, in output order."""
    codec, util = _load()
    dec = codec.avcodec_find_decoder(codec_id)
    ctx = ctypes.c_void_p(codec.avcodec_alloc_context3(dec))
    util.av_opt_set_int(ctx, b"threads", threads, 0)
    if codec.avcodec_open2(ctx, dec, None) < 0:
        raise RuntimeError("avcodec_open2 failed")
    pkt = ctypes.c_void_p(codec.av_packet_alloc())
    frame = ctypes.c_void_p(util.av_frame_alloc())
    out = []

    def drain():
        while codec.avcodec_receive_frame(ctx, frame) == 0:
            f = frame.value
            w = ctypes.c_int.from_address(f + _FRAME_W).value
            h = ctypes.c_int.from_address(f + _FRAME_H).value
            cw, ch = (w + 1) // 2, (h + 1) // 2
            out.append((_plane(f, 0, w, h), _plane(f, 1, cw, ch), _plane(f, 2, cw, ch)))
            util.av_frame_unref(frame)
    try:
        for data in packets:
            codec.av_new_packet(pkt, len(data))
            ctypes.memmove(ctypes.c_void_p.from_address(pkt.value + _PKT_DATA).value, data,
                           len(data))
            rc = codec.avcodec_send_packet(ctx, pkt)
            codec.av_packet_unref(pkt)
            if rc < 0 and rc != EAGAIN:
                raise RuntimeError(f"avcodec_send_packet: {rc}")
            drain()
        codec.avcodec_send_packet(ctx, None)
        drain()
    finally:
        util.av_frame_free(ctypes.byref(frame))
        codec.av_packet_free(ctypes.byref(pkt))
        codec.avcodec_free_context(ctypes.byref(ctx))
    return out


def annexb_packets(sps, pps, aus):
    """The writer's access units as Annex-B packets, the parameter sets
    leading the first."""
    pkts = []
    for i, au in enumerate(aus):
        head = b"\x00\x00\x00\x01" + sps + b"\x00\x00\x00\x01" + pps if i == 0 else b""
        pkts.append(head + b"".join(b"\x00\x00\x00\x01" + n for n in au))
    return pkts
