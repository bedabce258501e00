"""Tile blend, forward and backward: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd function that joins them.

Counterpart of ``fourdgs_tpu/ops/pallas_blend.py::blend_pallas`` with its
custom VJP (``_blend_fwd``/``_blend_bwd``, :844-898): the forward is
``make_forward`` (:305-460), the backward ``make_backward`` (:463-824).
Inputs, as on the JAX side:

- ``feat`` [16, K] float32, attribute-major payload (rows x, y, conic a/b/c,
  opacity, r, g, b, depth, 6 pad), K a multiple of ``ALIGN``;
- ``starts``/``stops`` [T] int32, tile t's instance range [start, stop);
- ``row_off`` [2] int32 = (offset, stride) of the tile rows;
- ``bg`` [3] float32 background.

Forward output: packed channel-major [T, 5, 256] = (r, g, b, depth, t_fin),
the background composited. The backward takes that output and its cotangent
and returns ``dfeat`` [16, K].

:func:`blend_forward` and :func:`blend_backward` run the CUDA kernels
``csrc/blend_forward.cu`` (K1) and ``csrc/blend_backward.cu`` (K2) for CUDA
tensors (or raise) and the plain versions for CPU tensors. :func:`blend` is
the differentiable blend. :func:`strip_mask` mirrors the kernels' exact cull,
:func:`strip_masks` gives its masks for every slot (the kernels' own staging
on the card) and :func:`pair_counts` counts their data-dependent work; the
tests and ``chip_smoke.py`` use them, the blend does not.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

_TILES_PER_STEP = 512   # tiles per vectorized step of the plain versions

# The plain mirror of the kernels' cull (csrc/blend_common.cuh, where the
# margin is derived): the conic shrunk by CULL_GAMMA of its terms,
# L = ln(255·opacity) grown by CULL_LOG_SLACK, one pixel of padding;
# ALL_STRIPS is the mask that culls nothing, and an opacity below
# _OPACITY_CUT culls everything. The card holds the kernels' masks equal to
# this mirror's (strip_masks; chip_smoke.py, tests/test_torch_cuda.py).
CULL_GAMMA = 1e-6
CULL_LOG_SLACK = 1e-5
CULL_PAD_PX = 1.0
ALL_STRIPS = 0xFF
_OPACITY_CUT = float(np.float32(C.ALPHA_FLOOR)) * (1.0 - 2.0**-18)


def _pixel_coords(t: torch.Tensor, grid_x: int, row_off: torch.Tensor):
    """Pixel coordinates of tiles ``t`` [n] → (px, py) [n, 256] float32,
    tile rows mapped to offset + j·stride (``_pixel_coords``,
    pallas_blend.py:192-205)."""
    sub = torch.arange(C.N_PIX, device=t.device)
    tx = (t % grid_x)[:, None]
    ty = ((t // grid_x) * row_off[1] + row_off[0])[:, None]
    px = (tx * C.TILE_X + sub % C.TILE_X).to(torch.float32)
    py = (ty * C.TILE_Y + sub // C.TILE_X).to(torch.float32)
    return px, py


class _Chunk(NamedTuple):
    """One chunk index of a group of tiles, [a, 256, CHUNK] per pair."""

    act: torch.Tensor        # [a] rows of the group that have this chunk
    g: torch.Tensor          # [a, CH] global instance index of each lane
    inside: torch.Tensor     # [a, CH] lane inside the tile's range
    f: torch.Tensor          # [16, a, CH] payload of the lanes
    dx: torch.Tensor
    dy: torch.Tensor
    exp_power: torch.Tensor
    alpha_raw: torch.Tensor  # opacity·exp(power), uncapped
    alpha: torch.Tensor      # capped, 0 where not kept
    one_minus: torch.Tensor
    keep: torch.Tensor
    t_excl: torch.Tensor
    contrib: torch.Tensor    # t_incl ≥ T_STOP
    w: torch.Tensor          # α·t_excl where contrib, else 0


def _tile_groups(starts, stops, K: int):
    """(tiles, start, stop, off0, n_chunks) per group of tiles: the 8-aligned
    windows ``off0 = min(⌊start/8⌋·8, K−8)``, 128-instance chunks."""
    start_all = starts.long()
    stop_all = stops.long()
    off0_all = torch.clamp((start_all // C.ALIGN) * C.ALIGN, max=K - C.ALIGN)
    n_chunks_all = torch.where(
        stop_all > start_all,
        (stop_all - off0_all + C.CHUNK - 1) // C.CHUNK, 0)
    T = starts.shape[0]
    for t0 in range(0, T, _TILES_PER_STEP):
        tiles = torch.arange(t0, min(t0 + _TILES_PER_STEP, T), device=starts.device)
        yield (tiles, start_all[tiles][:, None], stop_all[tiles][:, None],
               off0_all[tiles], n_chunks_all[tiles])


def _walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
    """The JAX kernel's chunk walk over one group of tiles: per chunk index,
    an exclusive log-space prefix of log(1−α) for the transmittance,
    ``contrib = t_incl ≥ T_STOP``; after the caller has used a chunk, the
    masked-min T carry updates ``Tv`` [n, 256] in place."""
    K = feat.shape[1]
    lane = torch.arange(C.CHUNK, device=feat.device)
    for c in range(int(n_chunks.max()) if n_chunks.numel() > 0 else 0):
        act = torch.nonzero(c < n_chunks).squeeze(1)
        g = (off0[act] + c * C.CHUNK)[:, None] + lane                # [a, CH]
        inside = (g >= start[act]) & (g < stop[act])
        f = feat[:, torch.clamp(g, max=K - 1)]                       # [16, a, CH]
        dx = px[act][:, :, None] - f[0][:, None, :]                  # [a, 256, CH]
        dy = py[act][:, :, None] - f[1][:, None, :]
        power = (-0.5 * (f[2][:, None, :] * dx * dx
                         + f[4][:, None, :] * dy * dy)
                 - f[3][:, None, :] * dx * dy)
        exp_power = torch.exp(power)
        alpha_raw = f[5][:, None, :] * exp_power
        alpha = torch.clamp(alpha_raw, max=C.ALPHA_CAP)
        keep = (power <= 0.0) & (alpha >= C.ALPHA_FLOOR) & inside[:, None, :]
        alpha = torch.where(keep, alpha, 0.0)
        one_minus = 1.0 - alpha
        lg = torch.log(one_minus)
        cum_x = torch.cumsum(lg, dim=-1) - lg                        # exclusive
        T_act = Tv[act][:, :, None]
        t_excl = T_act * torch.exp(cum_x)
        t_incl = t_excl * one_minus
        contrib = t_incl >= C.T_STOP
        w = torch.where(contrib, alpha * t_excl, 0.0)
        yield _Chunk(act, g, inside, f, dx, dy, exp_power, alpha_raw, alpha,
                     one_minus, keep, t_excl, contrib, w)
        Tv[act] = torch.where(contrib, t_incl, T_act).amin(dim=-1)


def blend_forward_plain(feat, starts, stops, row_off, bg, grid_x: int):
    """The JAX forward kernel's algorithm in plain PyTorch: per tile,
    128-instance chunks over the 8-aligned windows and the masked-min T
    carry between chunks (:func:`_walk_chunks`). Vectorized over tiles as
    [tiles, 256, 128] per chunk index."""
    T = starts.shape[0]
    dev = feat.device
    row_off = row_off.long()
    dt = feat.dtype   # float32 as the kernel; float64 gives the tests a reference
    out = torch.empty((T, C.OUT5, C.N_PIX), dtype=dt, device=dev)
    for tiles, start, stop, off0, n_chunks in _tile_groups(starts, stops, feat.shape[1]):
        px, py = _pixel_coords(tiles, grid_x, row_off)
        n = tiles.shape[0]
        Tv = torch.ones((n, C.N_PIX), dtype=dt, device=dev)
        cols = torch.zeros((n, C.N_PIX, 4), dtype=dt, device=dev)
        for ch in _walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            cols[ch.act] += torch.einsum("apc,kac->apk", ch.w, ch.f[6:10])
        out[tiles, 0:3] = (cols[:, :, 0:3] + Tv[:, :, None] * bg).transpose(1, 2)
        out[tiles, 3] = cols[:, :, 3]
        out[tiles, 4] = Tv
    return out


def blend_backward_plain(feat, starts, stops, row_off, bg, out, g_out,
                         grid_x: int):
    """The JAX backward kernel's "vpu" math (pallas_blend.py:618-711) in plain
    PyTorch, over the same chunk walk as :func:`blend_forward_plain`.

    Per pixel and contributing instance: ``combo = Σ_q c_q·g_q``, the
    inclusive prefix ``pw`` of w·combo carried across chunks,
    ``S = ctot − pw``, ``dα = t_excl·combo − (S + T_fin·g_T)/max(1−α, 1e-6)``,
    ``dpower = α_raw·dα`` with α_raw uncapped; the per-instance sums over the
    tile's pixels give rows 0..9 of ``dfeat``. Not autograd of the forward:
    that would clip the gradient at ``ALPHA_CAP``.
    """
    K = feat.shape[1]
    dev = feat.device
    row_off = row_off.long()
    dfeat = torch.zeros((C.FEAT_ROWS, K), dtype=torch.float32, device=dev)
    t_fin = out[:, 4]
    g_rgb = g_out[:, 0:3]
    gT_term = t_fin * (g_out[:, 4] + torch.einsum("q,tqp->tp", bg, g_rgb))
    ctot = (torch.einsum("tqp,tqp->tp", out[:, 0:3] - t_fin[:, None] * bg[:, None], g_rgb)
            + out[:, 3] * g_out[:, 3])
    for tiles, start, stop, off0, n_chunks in _tile_groups(starts, stops, K):
        px, py = _pixel_coords(tiles, grid_x, row_off)
        n = tiles.shape[0]
        Tv = torch.ones((n, C.N_PIX), dtype=torch.float32, device=dev)
        pw_carry = torch.zeros((n, C.N_PIX), dtype=torch.float32, device=dev)
        G = g_out[tiles, 0:4]                                        # [n, 4, 256]
        for ch in _walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            a = ch.act
            Ga = G[a]
            combo = torch.einsum("aqp,qac->apc", Ga, ch.f[6:10])
            pw = torch.cumsum(ch.w * combo, dim=-1) + pw_carry[a][:, :, None]
            S = ctot[tiles[a]][:, :, None] - pw
            inv_om = 1.0 / torch.clamp(ch.one_minus, min=1e-6)
            live = ch.contrib & ch.keep
            dalpha = torch.where(
                live, ch.t_excl * combo - inv_om * (S + gT_term[tiles[a]][:, :, None]),
                0.0)
            dpow = torch.where(live, ch.alpha_raw * dalpha, 0.0)
            ca, cb, cc = (ch.f[r][:, None, :] for r in (2, 3, 4))
            dx, dy = ch.dx, ch.dy
            vals = torch.cat([
                torch.stack([
                    ((ca * dx + cb * dy) * dpow).sum(1),
                    ((cc * dy + cb * dx) * dpow).sum(1),
                    (-0.5 * dx * dx * dpow).sum(1),
                    (-dx * dy * dpow).sum(1),
                    (-0.5 * dy * dy * dpow).sum(1),
                    torch.where(live, ch.exp_power * dalpha, 0.0).sum(1),
                ]),
                torch.einsum("aqp,apc->qac", Ga, ch.w),
            ])                                                       # [10, a, CH]
            # an instance lies in one tile's range: each slot is set once
            dfeat[:10, ch.g[ch.inside]] = vals[:, ch.inside]
            pw_carry[a] = pw[:, :, -1]
    return dfeat


def strip_mask(x, y, a, b, c, o, x0, y0) -> torch.Tensor:
    """The kernels' per-warp cull (``csrc/blend_common.cuh::strip_mask``),
    elementwise over broadcast tensors: an int64 mask whose bit w is set
    when strip w of the tile at pixel (x0, y0) (rows y0 + 2w, y0 + 2w + 1,
    columns x0..x0 + 15) meets the padded pixel box of the instance's
    ellipse d'Q'd ≤ 2L. 0 when opacity < 1/255 (no pixel can keep it), all
    8 bits when a value is not finite or Q' is not positive definite. In
    float64, as the kernels compute it."""
    x, y, a, b, c, o, x0, y0 = (torch.as_tensor(v).double()
                                for v in (x, y, a, b, c, o, x0, y0))
    finite = (torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(a)
              & torch.isfinite(b) & torch.isfinite(c) & torch.isfinite(o))
    bb = b.abs()
    a2 = a - CULL_GAMMA * (a + bb)
    c2 = c - CULL_GAMMA * (c + bb)
    det = a2 * c2 - b * b
    full = ~finite | ~(a2 > 0) | ~(det > 0)
    k = 2.0 * (torch.log(255.0 * o).clamp(min=0.0) + CULL_LOG_SLACK)
    hx = torch.sqrt(k * c2 / det) + CULL_PAD_PX
    hy = torch.sqrt(k * a2 / det) + CULL_PAD_PX
    r_lo = torch.ceil(y - hy - y0).clamp(min=0.0)
    r_hi = torch.floor(y + hy - y0).clamp(max=C.TILE_Y - 1.0)
    hit = ((x + hx >= x0) & (x - hx <= x0 + (C.TILE_X - 1)) & (r_lo <= r_hi)
           & ~full)
    w_lo = torch.where(hit, r_lo, 0.0).long() // 2
    w_hi = torch.where(hit, r_hi, 0.0).long() // 2
    mask = torch.where(hit, (2 << w_hi) - (1 << w_lo), 0)
    mask = torch.where(full, ALL_STRIPS, mask)
    return torch.where(o < _OPACITY_CUT, 0, mask)


def strip_masks_plain(feat, starts, stops, row_off, grid_x: int) -> torch.Tensor:
    """:func:`strip_masks` by the plain mirror :func:`strip_mask`, each slot
    of tile t's range at the tile's first pixel."""
    K = feat.shape[1]
    dev = feat.device
    lens = (stops.long() - starts.long()).clamp(min=0)
    tile = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), lens)
    first = torch.cumsum(lens, 0) - lens                  # tile's first entry
    slot = starts.long()[tile] + torch.arange(tile.shape[0], device=dev) - first[tile]
    row_off = row_off.long()
    x0 = (tile % grid_x) * C.TILE_X
    y0 = ((tile // grid_x) * row_off[1] + row_off[0]) * C.TILE_Y
    masks = torch.zeros(K, dtype=torch.int32, device=dev)
    masks[slot] = strip_mask(*feat[0:6, slot], x0, y0).int()
    return masks


def strip_masks(feat, starts, stops, row_off, grid_x: int) -> torch.Tensor:
    """int32 [K]: for each slot of a tile's range the strip mask the
    kernels stage for it (``csrc/blend_common.cuh::strip_mask`` at the
    tile's first pixel), 0 for a slot of no range. The ranges must not
    overlap, as the binning makes them.

    CUDA tensors run K1's staging of each chunk
    (``fourdgs_blend_forward_strip_masks``, not counted as a K1 launch);
    CPU tensors :func:`strip_masks_plain`. For the cull's checks and counts:
    the blend does not call it."""
    _check_inputs(feat, starts, stops, row_off)
    ne = stops > starts
    s, order = torch.sort(starts[ne].long())
    if bool((stops[ne].long()[order][:-1] > s[1:]).any()):
        raise ValueError("tile ranges overlap")
    if feat.device.type == "cpu":
        return strip_masks_plain(feat, starts, stops, row_off, grid_x)
    masks = torch.zeros(feat.shape[1], dtype=torch.int32, device=feat.device)
    argtypes = [_build.PTR] * 5 + [_build.INT] * 3 + [_build.PTR]
    _build.launch("blend_forward", "fourdgs_blend_forward_strip_masks", argtypes,
                  feat.device, feat, starts, stops, row_off, masks,
                  starts.shape[0], feat.shape[1], grid_x)
    return masks


def k2_reduction() -> dict:
    """K2's warp reduction as built (``csrc/blend_backward.cu``):
    ``batch`` instances per reduce-scatter, its ``shuffles``, and the
    ``unbatched`` shuffles per instance of ten separate warp sums."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    lib, fn = _build.bind("blend_backward", "fourdgs_blend_backward_reduction",
                          [ctypes.POINTER(ctypes.c_int)] * 3)
    _build.check(lib, fn(*(ctypes.byref(v) for v in vals)), "blend_backward reduction")
    return dict(zip(("batch", "shuffles", "unbatched"), (v.value for v in vals)))


def pair_counts(feat, starts, stops, row_off, grid_x: int, k2_batch: int = 0) -> dict:
    """The kernels' data-dependent work on this input, as (pixel, instance)
    pair counts over the chunk walk of :func:`blend_forward_plain` (a
    window's alignment lanes need no work):

    - ``in_range``: a pixel and an instance of its tile's range;
    - ``gated``: the in-range pairs whose strip the cull keeps, which the
      kernels put through the gates, from :func:`strip_masks` (on the card
      the kernels' own masks);
    - ``kept_pairs``: the in-range pairs that pass the gates (power ≤ 0,
      α ≥ 1/255), whatever T;
    - ``reached_pairs``: the kept pairs a pixel's walk reaches before it
      freezes at T_STOP for the rest of the chunk (its T before the pair
      still ≥ T_STOP), the freezing pair included: the kept pairs whose
      gates the kernels need;
    - ``live_pairs``: the kept pairs met before the pixel's T_STOP, which
      blend;
    - ``gated_by_warp``: ``gated`` of each warp's strip (rows 2w, 2w + 1);
    - ``live_warp_instances``: (warp, instance) with a live lane, which K2
      sums over the warp; with ``k2_batch`` (:func:`k2_reduction`) also
      ``k2_reductions``: its reduce-scatters, one per ``k2_batch`` of them
      in a warp's list of a chunk.
    """
    keys = ("in_range", "kept_pairs", "reached_pairs", "live_pairs",
            "live_warp_instances")
    n = dict.fromkeys(keys + (("k2_reductions",) if k2_batch else ()), 0)
    n_warps = C.N_PIX // 32
    for tiles, start, stop, off0, n_chunks in _tile_groups(starts, stops, feat.shape[1]):
        px, py = _pixel_coords(tiles, grid_x, row_off.long())
        Tv = torch.ones((tiles.shape[0], C.N_PIX), dtype=feat.dtype, device=feat.device)
        for ch in _walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            live = ch.contrib & ch.keep                              # [a, 256, CH]
            per_warp = live.reshape(live.shape[0], n_warps, 32, -1).any(2).sum(2)
            n["in_range"] += C.N_PIX * int(ch.inside.sum())
            n["kept_pairs"] += int(ch.keep.sum())
            n["reached_pairs"] += int((ch.keep & (ch.t_excl >= C.T_STOP)).sum())
            n["live_pairs"] += int(live.sum())
            n["live_warp_instances"] += int(per_warp.sum())
            if k2_batch:
                n["k2_reductions"] += int(((per_warp + k2_batch - 1) // k2_batch).sum())
    masks = strip_masks(feat, starts, stops, row_off, grid_x).long()
    bits = torch.arange(n_warps, device=feat.device)
    by_warp = 32 * ((masks[:, None] >> bits) & 1).sum(0)
    n["gated"] = int(by_warp.sum())
    n["gated_by_warp"] = by_warp.tolist()
    return n


def _check_inputs(feat, starts, stops, row_off, bg=None, *packed):
    """Raise on what the kernels do not take; ``packed`` are [T, 5, 256]
    float32 blocks (the saved output and its cotangent). ``bg`` may be
    None for :func:`strip_masks`, which takes none."""
    if feat.dtype != torch.float32 or feat.dim() != 2 or feat.shape[0] != C.FEAT_ROWS:
        raise ValueError(
            f"feat must be float32 [{C.FEAT_ROWS}, K], got {feat.dtype} "
            f"{tuple(feat.shape)}")
    K = feat.shape[1]
    if K < C.ALIGN or K % C.ALIGN:
        raise ValueError(f"K = {K} must be a positive multiple of {C.ALIGN}")
    if (starts.dtype != torch.int32 or stops.dtype != torch.int32
            or starts.dim() != 1 or starts.shape != stops.shape):
        raise ValueError("starts/stops must be int32 [T] of one shape")
    if row_off.dtype != torch.int32 or tuple(row_off.shape) != (2,):
        raise ValueError("row_off must be int32 [2] = (offset, stride)")
    if bg is not None and (bg.dtype != torch.float32 or tuple(bg.shape) != (3,)):
        raise ValueError("bg must be float32 [3]")
    for x in packed:
        if x.dtype != torch.float32 or tuple(x.shape) != (
                starts.shape[0], C.OUT5, C.N_PIX):
            raise ValueError(
                f"out/g_out must be float32 [T, {C.OUT5}, {C.N_PIX}], got "
                f"{x.dtype} {tuple(x.shape)}")
    tensors = (feat, starts, stops, row_off, *([] if bg is None else [bg]), *packed)
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"blend inputs lie on several devices: {devs}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("blend inputs must be contiguous")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feat.device}")
    if feat.device.type == "cuda" and K >= 2**31 // C.FEAT_ROWS:
        raise ValueError(f"K = {K} overflows the kernels' int32 offsets")


def _launch(stem: str, tensors, num_tiles: int, k_pad: int, grid_x: int,
            cull: bool):
    """``fourdgs_<stem>`` of ``csrc/<stem>.cu``: pointers, then num_tiles,
    k_pad, grid_x, cull, then the stream."""
    argtypes = [_build.PTR] * len(tensors) + [_build.INT] * 4 + [_build.PTR]
    _build.launch(stem, f"fourdgs_{stem}", argtypes, tensors[0].device,
                  *tensors, num_tiles, k_pad, grid_x, int(cull))


def blocks_per_sm(stem: str) -> int:
    """How many blocks of K1 (``"blend_forward"``) or K2
    (``"blend_backward"``) one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib, fn = _build.bind(stem, f"fourdgs_{stem}_blocks_per_sm",
                          [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    _build.check(lib, fn(ctypes.byref(n)), f"{stem} occupancy")
    return n.value


def blend_forward(feat, starts, stops, row_off, bg, grid_x: int, *,
                  _cull: bool = True):
    """Packed [T, 5, 256] forward blend.

    CUDA tensors launch K1 (``blend_forward.launches`` counts the launches)
    or raise; CPU tensors run :func:`blend_forward_plain`. ``_cull=False``
    is a test hook, not an option: K1 then walks every in-range instance
    instead of its per-warp cull, which must give the same bits
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
    """
    _check_inputs(feat, starts, stops, row_off, bg)
    if feat.device.type == "cpu":
        return blend_forward_plain(feat, starts, stops, row_off, bg, grid_x)
    T = starts.shape[0]
    out = torch.empty((T, C.OUT5, C.N_PIX), dtype=torch.float32,
                      device=feat.device)
    if T == 0:
        return out
    _launch("blend_forward", (feat, starts, stops, row_off, bg, out),
            T, feat.shape[1], grid_x, _cull)
    blend_forward.launches += 1
    return out


blend_forward.launches = 0


def blend_backward(feat, starts, stops, row_off, bg, out, g_out, grid_x: int,
                   *, _cull: bool = True):
    """``dfeat`` [16, K] from the forward's inputs, its packed output ``out``
    and the cotangent ``g_out`` [T, 5, 256].

    CUDA tensors launch K2 (``blend_backward.launches`` counts the launches)
    or raise; CPU tensors run :func:`blend_backward_plain`. ``_cull=False``
    is the test hook of :func:`blend_forward`.
    """
    _check_inputs(feat, starts, stops, row_off, bg, out, g_out)
    if feat.device.type == "cpu":
        return blend_backward_plain(feat, starts, stops, row_off, bg, out,
                                    g_out, grid_x)
    dfeat = torch.zeros_like(feat)   # slots in no tile's range stay 0
    T = starts.shape[0]
    if T == 0:
        return dfeat
    _launch("blend_backward",
            (feat, starts, stops, row_off, bg, out, g_out, dfeat),
            T, feat.shape[1], grid_x, _cull)
    blend_backward.launches += 1
    return dfeat


blend_backward.launches = 0


class _Blend(torch.autograd.Function):
    """K1 forward, K2 backward; the background cotangent
    ``dbg_q = Σ T_fin·g_out_q`` (pallas_blend.py:892-894) when ``bg`` needs
    one. The integer inputs get no gradient."""

    @staticmethod
    def forward(ctx, feat, starts, stops, row_off, bg, grid_x):
        out = blend_forward(feat, starts, stops, row_off, bg, grid_x)
        ctx.save_for_backward(feat, starts, stops, row_off, bg, out)
        ctx.grid_x = grid_x
        return out

    @staticmethod
    def backward(ctx, g_out):
        feat, starts, stops, row_off, bg, out = ctx.saved_tensors
        g_out = g_out.contiguous()
        dfeat = dbg = None
        if ctx.needs_input_grad[0]:
            dfeat = blend_backward(feat, starts, stops, row_off, bg, out,
                                   g_out, ctx.grid_x)
        if ctx.needs_input_grad[4]:
            dbg = torch.einsum("tp,tqp->q", out[:, 4], g_out[:, 0:3])
        return dfeat, None, None, None, dbg, None


def blend(feat, starts, stops, row_off, bg, grid_x: int):
    """The differentiable blend: :func:`blend_forward`, with
    :func:`blend_backward` as its gradient."""
    return _Blend.apply(feat, starts, stops, row_off, bg, grid_x)
