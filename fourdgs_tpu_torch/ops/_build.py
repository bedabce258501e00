"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``fourdgs_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (``nvcc -shared``, no PyTorch headers: a
build takes seconds, not minutes) under ``fourdgs_tpu_torch/_build/``. The
library's name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source, header or flag builds
anew and an unchanged one is reused. All sources build
in parallel, one ``nvcc`` each. A missing ``nvcc`` or a failed build raises
with the compiler's output; nothing falls back.

Every source exports plain C entry points that take their pointers and ints,
then the stream, and return ``cudaGetLastError()`` of their launch, plus
``fourdgs_cuda_error_string``. :func:`bind` sets an entry point's argument
types once; :func:`launch` calls it on the device's current stream and
raises on a nonzero return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # source name -> nvcc output of its build


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared by the sources
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Build every source whose library is missing, all nvcc processes at
    once; returns {source stem: library path}."""
    BUILD_DIR.mkdir(exist_ok=True)
    want = {src.stem: (src, _lib_path(src)) for src in sources()}
    todo = {k: v for k, v in want.items() if not v[1].exists()}
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for stem, (src, lib) in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, lib)
        failed = []
        for stem, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            build_logs[stem] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in want.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        lib.fourdgs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fourdgs_cuda_error_string.restype = ctypes.c_char_p
        _loaded[stem] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.fourdgs_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


PTR = ctypes.c_void_p   # a tensor's data_ptr() or the stream
INT = ctypes.c_int


def bind(stem: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<stem>.cu`` with its argument
    types (:data:`PTR` or :data:`INT` each, the stream last) and an int
    return; returns (lib, fn). ctypes would pass an untyped Python int as a
    32-bit int and cut a pointer."""
    lib = load(stem)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, fn


def launch(stem: str, name: str, argtypes, device: torch.device, *args) -> None:
    """Call ``name`` with ``args`` (tensors pass their data pointers) and the
    current stream of ``device``; raise if it returns a CUDA error."""
    lib, fn = bind(stem, name, argtypes)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):   # the C side launches on the current device
        rc = fn(*vals, torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, f"{name} launch")
