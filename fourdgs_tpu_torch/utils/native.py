"""Build helper for the port's host C++ libraries (``native/*.cpp``): the
PNG prefetcher (``data/fastloader.py``), the JPEG decoder
(``utils/jpeg.py``), the H.264 and MPEG-4 Part 2 decoders
(``utils/video.py``) and the resampler (``utils/resample.py``).

A library builds at first use with ``g++ -O2 -shared -fPIC`` followed by
its caller's own flags (link flags; ``-O3`` for the H.264 decoder and the
resampler, which overrides ``-O2``) into ``fourdgs_tpu_torch/_build/``,
its name keyed by a hash of the source, of each ``native/*.h`` it
includes (``#include "name.h"``, followed into the headers' own includes)
and of the flags (as ``ops/_build.py`` keys the kernels), so an edited
source, shared header or flag builds anew. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(src: pathlib.Path) -> list:
    """The headers beside ``src`` that it includes with ``#include "..."``,
    and theirs in turn, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            hdr = src.parent / name.decode()
            if hdr not in seen:
                if not hdr.exists():
                    raise RuntimeError(f"{src.name} includes {hdr.name}, which is missing")
                seen.append(hdr)
                todo.append(hdr)
    return seen


def lib_path(src: pathlib.Path, link_flags: tuple = ()) -> pathlib.Path:
    """The library built from ``src`` (``lib<stem>-<hash>.so``): its name
    carries a hash of the source, of the headers it includes
    (:func:`local_headers`) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in local_headers(src):
        h.update(b"\0" + hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update("\0".join(CXX_FLAGS + tuple(link_flags)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: pathlib.Path, link_flags: tuple = ()) -> pathlib.Path:
    """Build the host C++ file ``src`` with ``g++ -O2 -shared -fPIC``, then
    ``link_flags`` (the caller's flags, which may override those), unless
    its library exists; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    lib = lib_path(src, link_flags)
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on PATH: {src.name} "
                           f"cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp, *link_flags],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{src.name} failed to build "
                           f"({cxx} exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
