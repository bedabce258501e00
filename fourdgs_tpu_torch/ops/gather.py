"""Column gather of an attribute-major table: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``scripts/exp_gather.py::gk`` (body :88-90, ``pallas_call``
:93), the in-kernel gather that the payload-gather experiment times:
``out[:, k] = table[:, idx[k]]`` for a table [16, P] float32 and ids [K]
int32 (the JAX kernel takes them as [1, K]). :func:`gather_cols` runs
``csrc/gather_cols.cu`` (K3) for CUDA tensors (or raises) and
:func:`gather_cols_plain` for CPU tensors. Ids must lie in [0, P): the plain
version raises on others, the kernel writes NaN columns for them.
"""

from __future__ import annotations

import torch

from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

_ARGTYPES = [_build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT, _build.PTR]


def gather_cols_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, idx]`` [16, K]: one ``index_select`` along the columns."""
    return torch.index_select(table, 1, idx)


def _check_inputs(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != C.FEAT_ROWS:
        raise ValueError(f"table must be float32 [{C.FEAT_ROWS}, P], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be int32 [K], got {idx.dtype} {tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table and idx lie on {table.device} and {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type == "cuda" and max(table.numel(), C.FEAT_ROWS * idx.numel()) >= 2**31:
        raise ValueError("table or output too large for the kernel's int32 sizes")


def gather_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[:, k] = table[:, idx[k]]`` [16, K] float32.

    CUDA tensors launch K3 (``gather_cols.launches`` counts the launches) or
    raise; CPU tensors run :func:`gather_cols_plain`.
    """
    _check_inputs(table, idx)
    if table.device.type == "cpu":
        return gather_cols_plain(table, idx)
    K = idx.shape[0]
    out = torch.empty((C.FEAT_ROWS, K), dtype=torch.float32, device=table.device)
    if K == 0:
        return out
    _build.launch("gather_cols", "fourdgs_gather_cols", _ARGTYPES, table.device,
                  table, idx, out, table.shape[1], K)
    gather_cols.launches += 1
    return out


gather_cols.launches = 0
