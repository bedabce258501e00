"""Experiment: the fastest way to materialize the [16, K] payload gather, and
its backward.

Counterpart of ``scripts/exp_gather.py``. At the script's shape (P = 65,536
Gaussians, K = 393,216 slots, uniform ids, float32 and bfloat16) it times:

- ``take axis0 + T``: ``table.index_select(0, idx).T.contiguous()``, the
  render path's gather (``ops/rasterize.py::_GatheredPayload``);
- ``take axis1 [16,P]``: ``tableT.index_select(1, idx)`` on the transposed
  table (the plain version of K3 and its one-call yardstick);
- ``take axis0 (no T)``: ``table.index_select(0, idx)``;
- ``scatter-add bwd``: ``index_add_`` of a [K, 16] cotangent into [P, 16];
- ``sort+segsum bwd``: a stable sort of the ids into the binning's segment
  bookkeeping, then ``ops/rasterize.py::payload_grad`` (its segment sum, in
  float32 whatever the cotangent's type);
- ``K3 gather_cols`` (float32 only, as the TPU kernel): the CUDA kernel
  ``csrc/gather_cols.cu`` on the transposed table, its staging and its
  gather pass;
- ``K3 staging pass`` and ``K3 gather pass`` apart (``ops/gather.py``'s
  hooks; the gather pass on the [P, 16] table is the render path's gather,
  ``take axis0 + T``);
- ``write [16,K] ones``: ``torch.ones`` of K3's output, what writing it
  alone costs.

Then the render's shape: K = 2,097,152 slots (the lego preset's instance
budget) of which ``render_n_ids`` = 250,000 hold uniform ids and every padding
slot holds id 0, as ``ops/rasterize.py`` gathers them; and, as a control,
the same K with every id uniform. Times: see :mod:`fourdgs_tpu_torch.scripts`.
"""

from __future__ import annotations

import numpy as np
import torch

from fourdgs_tpu_torch import resolve_device
from fourdgs_tpu_torch.ops import constants as C
from fourdgs_tpu_torch.ops.binning import BinningOut
from fourdgs_tpu_torch.ops.gather import _gather_rows, _stage_rows, gather_cols
from fourdgs_tpu_torch.ops.rasterize import payload_grad
from fourdgs_tpu_torch.scripts import SEED, header, main_with, time_ms

LABELS = {
    "take_axis0_T": "take axis0 + T   ",
    "take_axis1": "take axis1 [16,P]",
    "take_axis0": "take axis0 (no T)",
    "scatter_add_bwd": "scatter-add bwd  ",
    "sort_segsum_bwd": "sort+segsum bwd  ",
    "gather_cols": "K3 gather_cols   ",
    "stage": "K3 staging pass  ",
    "gather_pass": "K3 gather pass   ",
    "write_out": "write [16,K] ones",
}


def bins_for_ids(idx: torch.Tensor, P: int) -> BinningOut:
    """The segment bookkeeping :func:`payload_grad` reads, for slots that
    hold Gaussian ids ``idx`` [K]: Gaussian r is rank r, its slots are
    contiguous in id order (a stable sort). The tile fields are unused."""
    ids = idx.long()
    by_id = torch.sort(ids, stable=True).indices
    slot = torch.empty_like(by_id)
    slot[by_id] = torch.arange(ids.numel(), device=ids.device)
    counts = torch.bincount(ids, minlength=P)
    return BinningOut(gauss_id=ids, tile_id=None, tile_start=None, tile_stop=None,
                      num_rendered=None, slot=slot, seg_starts=torch.cumsum(counts, 0) - counts,
                      seg_counts=counts, order=torch.arange(P, device=ids.device))


def render_ids(P: int, K: int, n_ids: int, rng, dev) -> torch.Tensor:
    """The render's id layout: ``n_ids`` uniform ids, then K − n_ids
    padding slots of id 0."""
    ids = np.zeros(K, np.int32)
    ids[:n_ids] = rng.integers(0, P, n_ids, dtype=np.int32)
    return torch.from_numpy(ids).to(dev)


def _variants(table, idx, P, dt, with_bwd):
    """{variant: fn} on the [P, 16] table and ids."""
    tableT = table.T.contiguous()
    K = idx.numel()
    fns = {
        "take_axis0_T": lambda: table.index_select(0, idx).T.contiguous(),
        "take_axis1": lambda: tableT.index_select(1, idx),
        "take_axis0": lambda: table.index_select(0, idx),
    }
    if with_bwd:
        g = torch.ones((K, C.FEAT_ROWS), dtype=dt, device=table.device)
        gT = torch.ones((C.FEAT_ROWS, K), dtype=dt, device=table.device)
        fns["scatter_add_bwd"] = lambda: torch.zeros(
            (P, C.FEAT_ROWS), dtype=dt, device=table.device).index_add_(0, idx, g)
        fns["sort_segsum_bwd"] = lambda: payload_grad(gT, bins_for_ids(idx, P), P)
    if dt == torch.float32:
        fns["gather_cols"] = lambda: gather_cols(tableT, idx)
        fns["stage"] = lambda: _stage_rows(tableT)
        fns["gather_pass"] = lambda: _gather_rows(table, idx)
        fns["write_out"] = lambda: torch.ones((C.FEAT_ROWS, K), device=table.device)
    return fns


def run(device="cuda", P=65_536, K=384 * 1024, render_K=2_097_152,
        render_n_ids=250_000) -> dict:
    """Time every variant; returns ``{"device", "clock", "rows": [{"shape",
    "variant", "dtype", "ms", "wall_ms"}], "ms": {"shape/variant/dtype": ms}}``
    for the shapes ``script`` (P, K, uniform ids), ``render`` (P,
    ``render_K``, ``render_n_ids`` uniform ids then zeros) and
    ``render_uniform`` (P, ``render_K``, uniform ids)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    res = dict(header(dev), P=P, K=K, render_K=render_K, render_n_ids=render_n_ids,
               rows=[], ms={})

    def record(shape, variant, dt_name, fn):
        ms, wall_ms = time_ms(fn, dev)
        res["rows"].append(dict(shape=shape, variant=variant, dtype=dt_name,
                                ms=ms, wall_ms=wall_ms))
        res["ms"][f"{shape}/{variant}/{dt_name}"] = ms
        print(f"{shape:14s} {LABELS[variant]} ({dt_name}): {ms:9.4f} ms "
              f"(wall {wall_ms:.4f} ms/call)")

    idx = torch.from_numpy(rng.integers(0, P, K, dtype=np.int32)).to(dev)
    table_np = rng.standard_normal((P, C.FEAT_ROWS), dtype=np.float32)
    for dt, dt_name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        table = torch.from_numpy(table_np).to(dev).to(dt)
        for variant, fn in _variants(table, idx, P, dt, with_bwd=True).items():
            record("script", variant, dt_name, fn)

    table = torch.from_numpy(table_np).to(dev)
    for shape, ids in (
            ("render", render_ids(P, render_K, render_n_ids, rng, dev)),
            ("render_uniform",
             torch.from_numpy(rng.integers(0, P, render_K, dtype=np.int32)).to(dev))):
        for variant, fn in _variants(table, ids, P, torch.float32, with_bwd=False).items():
            record(shape, variant, "float32", fn)
    return res


def main():
    main_with(run, "Payload gather layouts and K3 on the card")


if __name__ == "__main__":
    main()
