"""Column gather of an attribute-major table: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``scripts/exp_gather.py::gk`` (body :88-90, ``pallas_call``
:93), the in-kernel gather that the payload-gather experiment times:
``out[:, k] = table[:, idx[k]]`` for a table [16, P] float32 and ids [K]
int32 (the JAX kernel takes them as [1, K]). :func:`gather_cols` runs
``csrc/gather_cols.cu`` (K3) for CUDA tensors (or raises) and
:func:`gather_cols_plain` for CPU tensors. Ids must lie in [0, P): the plain
version raises on others, the kernel writes NaN columns for them.

K3 is two kernels behind one call. A staging pass writes the table
Gaussian-major, [P, 16] (a scratch the wrapper allocates), so that each id's
16 values are one 64-byte row; a gather pass, launched as a programmatic
dependent of the staging, then reads one row per slot, a quad of lanes each
loading one float4 of it, and stores ``out`` row by row through shared
memory as float4, with streaming stores. Its bound is the function's bytes, 4 K + 64 K + 64 P,
whatever the staging re-reads (9.2 µs at P = 65,536, K = 393,216 at 3.35
TB/s). The private hooks :func:`_stage_rows` and :func:`_gather_rows` run
one pass each, to time them apart; :func:`_gather_rows` on a [P, 16] table
is the render path's ``index_select(0).T.contiguous()``.
``csrc/gather_cols.cu`` gives the designs it was measured against, and why
the old single pass, a thread per slot reading the 16 values where they lie,
was slow.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

_P, _I = _build.PTR, _build.INT


def gather_cols_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, idx]`` [16, K]: one ``index_select`` along the columns."""
    return torch.index_select(table, 1, idx)


def _check(table: torch.Tensor, shape: str, rows_dim: int,
           idx: torch.Tensor | None = None) -> None:
    """Raise unless ``table`` is float32 ``shape`` (16 along ``rows_dim``)
    and ``idx`` int32 [K], both contiguous on one CPU or CUDA device, within
    the kernels' int32 sizes."""
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[rows_dim] != C.FEAT_ROWS):
        raise ValueError(f"table must be float32 {shape}, got "
                         f"{table.dtype} {tuple(table.shape)}")
    K = 0
    if idx is not None:
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise ValueError(f"idx must be int32 [K], got {idx.dtype} {tuple(idx.shape)}")
        if table.device != idx.device:
            raise ValueError(f"table and idx lie on {table.device} and {idx.device}")
        if not idx.is_contiguous():
            raise ValueError("idx must be contiguous")
        K = idx.shape[0]
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type == "cuda" and max(table.numel(), C.FEAT_ROWS * K) >= 2**31:
        raise ValueError("table or output too large for the kernel's int32 sizes")


def _launch(entry: str, argtypes, dev: torch.device, *args) -> None:
    _build.launch("gather_cols", f"fourdgs_{entry}", argtypes, dev, *args)


def gather_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[:, k] = table[:, idx[k]]`` [16, K] float32.

    CUDA tensors launch K3, its staging and its gather pass
    (``gather_cols.launches`` counts the calls), or raise; CPU tensors run
    :func:`gather_cols_plain`. K = 0 launches nothing.
    """
    _check(table, f"[{C.FEAT_ROWS}, P]", 0, idx)
    if table.device.type == "cpu":
        return gather_cols_plain(table, idx)
    P, K = table.shape[1], idx.shape[0]
    out = torch.empty((C.FEAT_ROWS, K), dtype=torch.float32, device=table.device)
    if K == 0:
        return out
    rows = torch.empty((P, C.FEAT_ROWS), dtype=torch.float32, device=table.device)
    _launch("gather_cols", [_P, _P, _P, _P, _I, _I, _P], table.device,
            table, idx, rows, out, P, K)
    gather_cols.launches += 1
    return out


gather_cols.launches = 0


def _stage_rows(table: torch.Tensor) -> torch.Tensor:
    """K3's staging pass alone: ``table.T.contiguous()`` [P, 16] (on the
    card the kernel, not counted in ``gather_cols.launches``)."""
    _check(table, f"[{C.FEAT_ROWS}, P]", 0)
    if table.device.type == "cpu":
        return table.T.contiguous()
    rows = torch.empty((table.shape[1], C.FEAT_ROWS), dtype=torch.float32,
                       device=table.device)
    _launch("gather_stage", [_P, _P, _I, _P], table.device, table, rows, table.shape[1])
    return rows


def _gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3's gather pass alone from a Gaussian-major table ``rows`` [P, 16]:
    ``rows.index_select(0, idx).T.contiguous()`` [16, K] (on the card the
    kernel, NaN columns for ids outside [0, P), not counted in
    ``gather_cols.launches``)."""
    _check(rows, f"[P, {C.FEAT_ROWS}]", 1, idx)
    if rows.device.type == "cpu":
        return rows.index_select(0, idx).T.contiguous()
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (float4 loads)")
    K = idx.shape[0]
    out = torch.empty((C.FEAT_ROWS, K), dtype=torch.float32, device=rows.device)
    _launch("gather_rows", [_P, _P, _P, _I, _I, _P], rows.device,
            rows, idx, out, rows.shape[0], K)
    return out
