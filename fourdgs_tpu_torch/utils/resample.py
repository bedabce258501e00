"""Pillow-exact image resize over the port's native resampler
(``native/resample.cpp``).

The JAX package resizes with Pillow's ``Image.resize`` where a frame or a
mask is not its view's size: LANCZOS in ``data/dynerf.py::ImageRef`` (the
lazy frame of every loader but Blender's), BICUBIC (Pillow's default) on an
RGBA frame in ``data/blender.py``, BILINEAR on a covisible mask (``train.py``
and ``render.py``). The port depends on no Pillow, so it keeps a copy of
Pillow's 8-bit two-pass convolution in host C++, built at first use with
``g++ -O3 -shared -fPIC`` into ``fourdgs_tpu_torch/_build/`` by
``utils/native.py::build`` (keyed by a hash of source and flags) and loaded
with ``ctypes``. It links nothing.

:func:`resize` gives what ``np.asarray(PIL.Image.fromarray(img).resize(size,
F))`` gives, bit for bit, for L, RGB and RGBA (premultiplied, as Pillow
resamples it). Pillow's ``box``, ``reducing_gap`` and its other filters are
not ported and raise ``NotImplementedError`` by name.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fourdgs_tpu_torch.utils import native

SRC = native.NATIVE_DIR / "resample.cpp"
# -O3 vectorises the integer passes, which -O2 leaves scalar; the weights
# are computed in double as Pillow computes them, so no fused multiply-add
# may change their rounding
FLAGS = ("-O3", "-ffp-contract=off")
FILTERS = {"bilinear": 0, "bicubic": 1, "lanczos": 2}

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded resampler, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SRC, FLAGS)))
            lib.rs_resize.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            lib.rs_resize.restype = ctypes.c_int
            _lib = lib
        return _lib


def resize(img: np.ndarray, size, filter: str, *, box=None,
           reducing_gap=None) -> np.ndarray:
    """``img`` (uint8 [H, W] L, [H, W, 3] RGB or [H, W, 4] RGBA) resized to
    ``size`` = (W, H) with ``filter`` ("bilinear", "bicubic" or "lanczos"),
    as Pillow's ``Image.resize`` gives it. A frame already of ``size`` is
    returned as a copy, as Pillow does."""
    if box is not None:
        raise NotImplementedError("resize: Pillow's box argument is not ported")
    if reducing_gap is not None:
        raise NotImplementedError("resize: Pillow's reducing_gap is not ported")
    if filter not in FILTERS:
        raise NotImplementedError(
            f"resize: filter {filter!r} is not ported (one of {sorted(FILTERS)})")
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize: uint8 image expected, got {img.dtype}")
    if img.ndim == 2:
        c = 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        c = img.shape[2]
    else:
        raise ValueError(f"resize: [H, W], [H, W, 3] or [H, W, 4] expected, got {img.shape}")
    ow, oh = (int(s) for s in size)
    h, w = img.shape[:2]
    if ow <= 0 or oh <= 0 or h == 0 or w == 0:
        raise ValueError(f"resize: {w}x{h} to {ow}x{oh}: sizes must be positive")
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = get_lib().rs_resize(img.ctypes.data, w, h, c, out.ctypes.data, ow, oh,
                             FILTERS[filter], err, len(err))
    if rc != 0:
        raise ValueError(f"resize: {err.value.decode(errors='replace')}")
    return out
