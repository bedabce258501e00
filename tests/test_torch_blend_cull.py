"""The blend kernels' per-warp cull (``csrc/blend_common.cuh::strip_mask``)
through its plain mirror ``ops/blend.py::strip_mask``: no pixel of a strip
that the mask leaves out passes the float32 gates of the plain walk
(``_walk_chunks``, the association of the kernels' ``eval_splat``), on
random conics from round to near singular, opacities from 0 to 1 and
sub-pixel means (a hypothesis property), on the cull's edge cases of
``chip_smoke.py`` and on the blend tests' scenes; the mask's fixed cases;
and the wrappers' test hook. The kernels with and without the cull are held
to the same bits on the card (``tests/test_torch_cuda.py``)."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import cull_edge_inputs, synthetic_blend_inputs
from fourdgs_tpu_torch.ops import _build, blend
from fourdgs_tpu_torch.ops import constants as C
from tests.test_torch_blend_backward import CASES, _torch_args
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

FLOOR = float(np.float32(C.ALPHA_FLOOR))


def culled_kept(feat, starts, stops, row_off, gx):
    """(kept pairs in a strip the mask leaves out, kept pairs) over the
    plain walk's chunks."""
    strip = torch.arange(C.N_PIX) // (2 * C.TILE_X)     # the warp of each pixel
    dropped = kept = 0
    for tiles, start, stop, off0, n_chunks in blend._tile_groups(
            starts, stops, feat.shape[1]):
        px, py = blend._pixel_coords(tiles, gx, row_off.long())
        Tv = torch.ones((tiles.shape[0], C.N_PIX))
        for ch in blend._walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            m = blend.strip_mask(*ch.f[0:6], px[ch.act, :1], py[ch.act, :1])
            gated = ((m[:, None, :] >> strip[None, :, None]) & 1).bool()
            dropped += int((ch.keep & ~gated).sum())
            kept += int(ch.keep.sum())
    return dropped, kept


def one_per_tile(insts):
    """Blend inputs with instance t alone in tile t of an 8-wide grid, from
    (angle, log10 λ1, log10 λ2/λ1, opacity, x and y offset from the tile's
    corner) per instance."""
    a = np.array(insts, np.float64).reshape(-1, 6)
    n = a.shape[0]
    th, l1, ratio, op, ox, oy = a.T
    l1 = 10.0 ** l1
    l2 = l1 * 10.0 ** ratio
    cs, sn = np.cos(th), np.sin(th)
    t = np.arange(n)
    feat = np.zeros((C.FEAT_ROWS, -(-n // 8) * 8), np.float32)
    feat[0, :n] = (t % 8) * 16 + ox
    feat[1, :n] = (t // 8) * 16 + oy
    feat[2, :n] = l1 * cs * cs + l2 * sn * sn
    feat[3, :n] = (l1 - l2) * sn * cs
    feat[4, :n] = l1 * sn * sn + l2 * cs * cs
    feat[5, :n] = op
    return (torch.from_numpy(feat), torch.arange(n, dtype=torch.int32),
            torch.arange(1, n + 1, dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), 8)


INSTANCE = st.tuples(
    st.floats(0, math.pi),                 # angle of the first axis
    st.floats(-3, math.log10(2)),          # log10 λ1
    st.floats(-8, 0),                      # log10 λ2/λ1: round to near singular
    st.one_of(st.floats(0, 1), st.floats(0.9, 1),
              st.floats(FLOOR * (1 - 1e-4), FLOOR * (1 + 1e-2))),   # opacity
    st.floats(-24, 40), st.floats(-24, 40))                          # mean


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(INSTANCE, min_size=1, max_size=64))
def test_culled_strips_never_keep(insts):
    dropped, kept = culled_kept(*one_per_tile(insts))
    assert dropped == 0, (dropped, kept)


@pytest.mark.parametrize("case", ["edge0", "edge1", "synthetic", "straddle", "multichunk"])
def test_cull_drops_no_kept_pair(case):
    """On the card's cull checks' inputs (``synthetic`` holds a saturated
    tile) and the blend tests' scenes; the cull still leaves out part of the
    pairs in range."""
    if case.startswith("edge"):
        args = cull_edge_inputs("cpu", seed=int(case[-1]), n_tiles=192)[:6]
        args = (*args[:4], args[5])
    elif case == "synthetic":
        feat, starts, stops, row_off, _, gx = synthetic_blend_inputs("cpu")
        args = (feat, starts, stops, row_off, gx)
    else:
        feat, starts, stops, gx, _, _ = CASES[case]()
        args = (*_torch_args(feat, starts, stops)[:4], gx)
    dropped, kept = culled_kept(*args)
    assert dropped == 0 and kept > 0
    counts = blend.pair_counts(*args)
    assert counts["kept_pairs"] <= counts["gated"] < counts["in_range"]


def test_strip_mask_fixed_cases():
    inf, nan = float("inf"), float("nan")
    # (x, y, a, b, c, opacity) for the tile at (16, 32) -> mask
    cases = [
        ((24, 38.5, 4, 0, 4, 0.5), 0b11100),  # |d| ≤ 1.56 px + 1: rows 4..9
        ((24, 40, 0.05, 0, 0.05, 0.5), 0xFF),  # covers the tile
        ((24, 40, 4, 0, 4, 0.0039), 0),       # opacity < 1/255: never kept
        ((24, 40, 4, 0, 4, 0.0), 0),
        ((24, 40, 4, 0, 4, -1.0), 0),
        ((24, 90, 4, 0, 4, 0.9), 0),          # below the tile
        ((90, 40, 4, 0, 4, 0.9), 0),          # right of it
        ((24, 40, 1, 2, 1, 0.5), 0xFF),       # indefinite: no cull
        ((24, 40, -1, 0, 1, 0.5), 0xFF),
        ((24, 40, 1, 1, 1, 0.5), 0xFF),       # singular
        ((nan, 40, 1, 0, 1, 0.5), 0xFF),      # not finite: no cull
        ((24, 40, inf, 0, 1, 0.5), 0xFF),
        ((24, 40, 1, 0, 1, nan), 0xFF),
    ]
    x, y, a, b, c, o = (torch.tensor(v, dtype=torch.float32)
                        for v in zip(*(p for p, _ in cases)))
    got = blend.strip_mask(x, y, a, b, c, o, 16.0, 32.0)
    assert got.tolist() == [m for _, m in cases]


@pytest.mark.parametrize("case", ["edge0", "synthetic"])
def test_strip_masks_per_slot(case):
    """``strip_masks`` (the masks the card's staging is held to) gives each
    slot of a tile's range the mirror's mask at that tile, as the chunk walk
    meets it, and 0 to the slots of no range; overlapping ranges raise."""
    if case == "edge0":
        feat, starts, stops, row_off, _, gx = cull_edge_inputs("cpu", n_tiles=192)[:6]
    else:
        feat, starts, stops, row_off, _, gx = synthetic_blend_inputs("cpu")
    got = blend.strip_masks(feat, starts, stops, row_off, gx)
    want = torch.zeros_like(got)
    for tiles, start, stop, off0, n_chunks in blend._tile_groups(
            starts, stops, feat.shape[1]):
        px, py = blend._pixel_coords(tiles, gx, row_off.long())
        Tv = torch.ones((tiles.shape[0], C.N_PIX))
        for ch in blend._walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            m = blend.strip_mask(*ch.f[0:6], px[ch.act, :1], py[ch.act, :1])
            want[ch.g[ch.inside]] = m[ch.inside].int()
    assert torch.equal(got, want)
    assert bool(((got > 0) & (got < blend.ALL_STRIPS)).any())
    with pytest.raises(ValueError, match="overlap"):
        blend.strip_masks(feat, starts, stops + 1, row_off, gx)


def test_cull_hook_reaches_the_kernels(monkeypatch):
    """The wrappers pass the cull flag as the int after grid_x; on CPU
    tensors the plain version runs whatever the flag."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs("cpu")
    for cull in (True, False):
        blend._launch("blend_forward", (feat, starts, stops, row_off, bg), 24, 4096, gx, cull)
    assert [c[-1] for c in calls] == [1, 0]
    assert calls[0][2][-5:] == [_build.INT] * 4 + [_build.PTR]
    out = blend.blend_forward(feat, starts, stops, row_off, bg, gx)
    assert torch.equal(out, blend.blend_forward(feat, starts, stops, row_off, bg, gx,
                                                _cull=False))
