"""The native PNG prefetcher: a C++ thread pool that decodes the frames of
the next training batch while the current step runs.

Counterpart of ``fourdgs_tpu/data/fastloader.py`` over the port's own copy
of ``native/fastloader.cpp`` (8-bit RGB / RGBA, non-interlaced PNGs of the
size the caller names, decoded with zlib into caller buffers). The library
builds at first use with ``g++ -O2 -shared -fPIC … -lz -lpthread`` into
``fourdgs_tpu_torch/_build/`` through ``utils/native.py`` (its name keyed
by a hash of the source and the flags), and loads with ``ctypes``.

Nothing falls back silently, where JAX's module turns to PIL:

- a failed build raises with the compiler's output (JAX runs synchronously
  on PIL instead);
- a frame the native decoder rejects (another colour type, another size, a
  broken file) goes to the ref's own decoder (``data/dynerf.py::ImageRef``
  on ``utils/png.py``, which raises on a frame of another size), and each
  such frame is counted: :class:`PrefetchPool` reports how many frames it
  was given, how many it decoded natively and how many it sent to the ref.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np

from fourdgs_tpu_torch.utils import native

SRC = native.NATIVE_DIR / "fastloader.cpp"
LINK_FLAGS = ("-lz", "-lpthread")

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SRC, LINK_FLAGS)))
            lib.fl_pool_create.restype = ctypes.c_void_p
            lib.fl_pool_create.argtypes = [ctypes.c_int]
            lib.fl_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.fl_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
            _lib = lib
        return _lib


class PrefetchPool:
    """Batch prefetcher over the native thread pool.

    ``submit_batch(refs)`` starts decoding a batch of refs (each with
    ``path`` and ``size`` = (W, H), and callable for its own decode);
    ``wait_batch()`` returns the stacked uint8 [B, H, W, 3]. A frame the
    decoder rejects is decoded by calling its ref. ``submitted``,
    ``native`` and ``to_ref`` count the frames over the pool's life
    (:meth:`counts`)."""

    _pool = None

    def __init__(self, n_threads: int = 8):
        self._lib = get_lib()
        self._pool = self._lib.fl_pool_create(n_threads)
        self._pending = None
        self.submitted = self.native = self.to_ref = 0

    def submit_batch(self, refs: list) -> None:
        if self._pending is not None:
            raise RuntimeError("a batch is already pending")
        outs, statuses = [], []
        for ref in refs:
            w, h = ref.size
            out = np.empty((h, w, 3), np.uint8)
            status = np.zeros(1, np.int32)
            self._lib.fl_submit(self._pool, str(ref.path).encode(),
                                out.ctypes.data_as(ctypes.c_void_p), w, h,
                                status.ctypes.data_as(ctypes.c_void_p))
            outs.append(out)
            statuses.append(status)
        self._pending = (refs, outs, statuses)
        self.submitted += len(refs)

    def wait_batch(self) -> np.ndarray:
        if self._pending is None:
            raise RuntimeError("no batch submitted")
        refs, outs, statuses = self._pending
        self._pending = None
        result = []
        for ref, out, status in zip(refs, outs, statuses):
            while status[0] == 0:
                time.sleep(0.0005)
            if status[0] == 1:
                result.append(out)
                self.native += 1
            else:     # rejected: the ref's own decoder, which raises on what it cannot read
                self.to_ref += 1
                result.append(np.asarray(ref()))
        return np.stack(result)

    def counts(self) -> dict:
        return {"submitted": self.submitted, "native": self.native,
                "to_ref": self.to_ref}

    def close(self) -> None:
        """Join the threads (after the jobs still queued finish)."""
        if self._pool is not None:
            self._lib.fl_pool_destroy(self._pool)
            self._pool = None
            self._pending = None

    def __del__(self):
        self.close()
