"""JPEG reader over the port's native decoder (``native/jpeg.cpp``).

The JAX package reads JPEG frames with Pillow (``data/dynerf.py::ImageRef``
for the MultipleView, Panoptic and COLMAP loaders); the port depends on no
Pillow, imageio, torchvision or ``libjpeg``, so it decodes them itself. The
decoder is host C++ that links no JPEG library, built at first use with
``g++ -O2 -shared -fPIC`` into ``fourdgs_tpu_torch/_build/`` by the port's
native build helper (``utils/native.py::build``, keyed by a hash of source
and flags) and loaded with ``ctypes``.

Scope: Huffman-coded sequential (SOF0, SOF1) and progressive (SOF2) files of
8-bit samples, 1 or 3 components, sampling factors up to 2×2, 8- or 16-bit
quantization tables, restart intervals, any size. It follows libjpeg's
default path (the islow IDCT, fancy upsampling, the fixed-point YCbCr→RGB
tables), so its frames equal Pillow's bit for bit. Lossless, hierarchical
and arithmetic-coded files, 12-bit samples, CMYK/YCCK, sampling factors
above 2, and a progressive file whose scans leave a low-frequency
coefficient unrefined (libjpeg smooths its blocks, which the decoder does
not) raise ``NotImplementedError`` naming the feature; a truncated or
corrupt file raises ``ValueError``, and so does a frame header of more
pixels than Pillow opens (178,956,970), before anything of the image's size
is allocated.
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
    """Read a JPEG as uint8: [H, W, 3] RGB, or [H, W] for a grey file, as
    ``np.asarray(PIL.Image.open(path))`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.jd_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                       err, len(err)), err, path)
    out = np.empty((h.value, w.value, 3) if c.value == 3 else (h.value, w.value), np.uint8)
    _check(lib.jd_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), err, len(err)),
           err, path)
    return out
