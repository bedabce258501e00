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
the differentiable blend.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

_TILES_PER_STEP = 512   # tiles per vectorized step of the plain versions


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


def live_pairs(feat, starts, stops, row_off, grid_x: int) -> int:
    """The number of (pixel, instance) pairs that blend: kept by the gates
    and met before the pixel's T_STOP, over the chunk walk of
    :func:`blend_forward_plain`. The part of the kernels' work that depends
    on the data, for their bounds."""
    n = 0
    row_off = row_off.long()
    for tiles, start, stop, off0, n_chunks in _tile_groups(starts, stops, feat.shape[1]):
        px, py = _pixel_coords(tiles, grid_x, row_off)
        Tv = torch.ones((tiles.shape[0], C.N_PIX), dtype=feat.dtype, device=feat.device)
        for ch in _walk_chunks(feat, start, stop, off0, n_chunks, px, py, Tv):
            n += int((ch.contrib & ch.keep).sum())
    return n


def _check_inputs(feat, starts, stops, row_off, bg, *packed):
    """Raise on what the kernels do not take; ``packed`` are [T, 5, 256]
    float32 blocks (the saved output and its cotangent)."""
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
    if bg.dtype != torch.float32 or tuple(bg.shape) != (3,):
        raise ValueError("bg must be float32 [3]")
    for x in packed:
        if x.dtype != torch.float32 or tuple(x.shape) != (
                starts.shape[0], C.OUT5, C.N_PIX):
            raise ValueError(
                f"out/g_out must be float32 [T, {C.OUT5}, {C.N_PIX}], got "
                f"{x.dtype} {tuple(x.shape)}")
    tensors = (feat, starts, stops, row_off, bg, *packed)
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"blend inputs lie on several devices: {devs}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("blend inputs must be contiguous")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feat.device}")
    if feat.device.type == "cuda" and K >= 2**31 // C.FEAT_ROWS:
        raise ValueError(f"K = {K} overflows the kernels' int32 offsets")


def _launch(stem: str, tensors, num_tiles: int, k_pad: int, grid_x: int):
    """``fourdgs_<stem>`` of ``csrc/<stem>.cu``: pointers, then num_tiles,
    k_pad, grid_x, then the stream."""
    argtypes = [_build.PTR] * len(tensors) + [_build.INT] * 3 + [_build.PTR]
    _build.launch(stem, f"fourdgs_{stem}", argtypes, tensors[0].device,
                  *tensors, num_tiles, k_pad, grid_x)


def blend_forward(feat, starts, stops, row_off, bg, grid_x: int):
    """Packed [T, 5, 256] forward blend.

    CUDA tensors launch K1 (``blend_forward.launches`` counts the launches)
    or raise; CPU tensors run :func:`blend_forward_plain`.
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
            T, feat.shape[1], grid_x)
    blend_forward.launches += 1
    return out


blend_forward.launches = 0


def blend_backward(feat, starts, stops, row_off, bg, out, g_out, grid_x: int):
    """``dfeat`` [16, K] from the forward's inputs, its packed output ``out``
    and the cotangent ``g_out`` [T, 5, 256].

    CUDA tensors launch K2 (``blend_backward.launches`` counts the launches)
    or raise; CPU tensors run :func:`blend_backward_plain`.
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
            T, feat.shape[1], grid_x)
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
