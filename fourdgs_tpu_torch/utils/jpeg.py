"""JPEG reader over the port's native decoder (``native/jpeg.cpp``).

The JAX package reads JPEG frames with Pillow (``data/dynerf.py::ImageRef``
for the MultipleView, Panoptic and COLMAP loaders); the port depends on no
Pillow, imageio, torchvision or ``libjpeg``, so it decodes them itself. The
decoder is host C++ that links no JPEG library, built at first use with
``g++ -O2 -shared -fPIC`` into ``fourdgs_tpu_torch/_build/`` by the port's
native build helper (``utils/native.py::build``, keyed by a hash of source
and flags) and loaded with ``ctypes``.

Scope: every JPEG Pillow 12 (libjpeg-turbo 3.1) reads: sequential
(SOF0, SOF1, SOF9) and progressive (SOF2, SOF10) DCT files, Huffman- or
arithmetic-coded, and lossless files (SOF3), of 8-bit samples, 1, 3 or 4
components (grey, YCbCr or RGB, CMYK or YCCK), sampling factors 1 to 4 in
each direction at whole ratios, 8- or 16-bit quantization tables, restart
intervals, any size. It follows libjpeg's default path (the islow IDCT,
block smoothing of a progressive file whose scans leave a low-frequency
coefficient unrefined, fancy upsampling at a ratio of 2 and replication
otherwise, the fixed-point YCbCr→RGB and YCCK→CMYK tables, lossless
prediction and point transform, the colour space its markers and ids
imply), so its frames equal Pillow's bit for bit; a 4-component file comes
back as Pillow opens it (inverted CMYK), and ``png.convert(img, "RGB",
"CMYK")`` converts it as Pillow does. What libjpeg or Pillow refuses raises
``NotImplementedError`` naming the feature: hierarchical files (SOF5–SOF7,
SOF13–SOF15), arithmetic-coded lossless files (SOF11), 12-bit and 16-bit
samples, a height set by a DNL marker, 2-component files, fractional
sampling ratios, a lossless restart interval of part of an MCU row and the
colour conversion of a lossless file. A truncated or corrupt file raises
``ValueError`` (no missing data is filled in), and so does a frame header
of more pixels than Pillow opens (178,956,970), before anything of the
image's size is allocated.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fourdgs_tpu_torch.utils import native

SRC = native.NATIVE_DIR / "jpeg.cpp"
LINK_FLAGS = ()        # no libjpeg: the decoder is self-contained
SOI = b"\xff\xd8"      # a JPEG file's first two bytes

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SRC, LINK_FLAGS)))
            lib.jd_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int]
            lib.jd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jd_info.restype = lib.jd_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(rc: int, err, path: str) -> None:
    if rc == 0:
        return
    msg = f"{path}: {err.value.decode(errors='replace')}"
    if rc == 2:
        raise NotImplementedError(msg)
    raise ValueError(msg)


def read_jpeg(path: str) -> np.ndarray:
    """Read a JPEG as uint8: [H, W, 3] RGB, [H, W] for a grey file, or
    [H, W, 4] for a CMYK / YCCK file (inverted CMYK, as Pillow's "CMYK;I"
    raw mode opens it), as ``np.asarray(PIL.Image.open(path))`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.jd_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                       err, len(err)), err, path)
    out = np.empty((h.value, w.value) if c.value == 1 else (h.value, w.value, c.value), np.uint8)
    _check(lib.jd_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), err, len(err)),
           err, path)
    return out
