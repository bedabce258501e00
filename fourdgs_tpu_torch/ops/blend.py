"""Forward tile blend: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``fourdgs_tpu/ops/pallas_blend.py::blend_pallas`` forward
(``make_forward``, :305-460). Inputs, as on the JAX side:

- ``feat`` [16, K] float32, attribute-major payload (rows x, y, conic a/b/c,
  opacity, r, g, b, depth, 6 pad), K a multiple of ``ALIGN``;
- ``starts``/``stops`` [T] int32, tile t's instance range [start, stop);
- ``row_off`` [2] int32 = (offset, stride) of the tile rows;
- ``bg`` [3] float32 background.

Output: packed channel-major [T, 5, 256] = (r, g, b, depth, t_fin), the
background composited.

:func:`blend_forward` runs the CUDA kernel ``csrc/blend_forward.cu`` for CUDA
tensors (or raises) and :func:`blend_forward_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from fourdgs_tpu_torch.ops import _build
from fourdgs_tpu_torch.ops import constants as C

_TILES_PER_STEP = 512   # tiles per vectorized step of the plain version


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


def blend_forward_plain(feat, starts, stops, row_off, bg, grid_x: int):
    """The JAX kernel's algorithm in plain PyTorch: per tile, 128-instance
    chunks over the 8-aligned windows, an exclusive log-space prefix of
    log(1−α) for the transmittance, ``contrib = t_incl ≥ T_STOP``, and the
    masked-min T carry between chunks. Vectorized over tiles as
    [tiles, 256, 128] per chunk index."""
    K = feat.shape[1]
    T = starts.shape[0]
    dev = feat.device
    start_all = starts.long()
    stop_all = stops.long()
    row_off = row_off.long()
    off0_all = torch.clamp((start_all // C.ALIGN) * C.ALIGN, max=K - C.ALIGN)
    n_chunks_all = torch.where(
        stop_all > start_all,
        (stop_all - off0_all + C.CHUNK - 1) // C.CHUNK, 0)
    lane = torch.arange(C.CHUNK, device=dev)
    out = torch.empty((T, C.OUT5, C.N_PIX), dtype=torch.float32, device=dev)

    for t0 in range(0, T, _TILES_PER_STEP):
        tiles = torch.arange(t0, min(t0 + _TILES_PER_STEP, T), device=dev)
        px, py = _pixel_coords(tiles, grid_x, row_off)
        n = tiles.shape[0]
        start = start_all[tiles][:, None]
        stop = stop_all[tiles][:, None]
        off0 = off0_all[tiles]
        n_chunks = n_chunks_all[tiles]
        Tv = torch.ones((n, C.N_PIX), dtype=torch.float32, device=dev)
        cols = torch.zeros((n, C.N_PIX, 4), dtype=torch.float32, device=dev)
        for c in range(int(n_chunks.max()) if n > 0 else 0):
            act = torch.nonzero(c < n_chunks).squeeze(1)
            g = (off0[act] + c * C.CHUNK)[:, None] + lane          # [a, CH]
            inside = (g >= start[act]) & (g < stop[act])
            f = feat[:, torch.clamp(g, max=K - 1)]                 # [16, a, CH]
            dx = px[act][:, :, None] - f[0][:, None, :]            # [a, 256, CH]
            dy = py[act][:, :, None] - f[1][:, None, :]
            power = (-0.5 * (f[2][:, None, :] * dx * dx
                             + f[4][:, None, :] * dy * dy)
                     - f[3][:, None, :] * dx * dy)
            alpha = torch.clamp(f[5][:, None, :] * torch.exp(power),
                                max=C.ALPHA_CAP)
            keep = (power <= 0.0) & (alpha >= C.ALPHA_FLOOR) & inside[:, None, :]
            alpha = torch.where(keep, alpha, 0.0)
            one_minus = 1.0 - alpha
            lg = torch.log(one_minus)
            cum_x = torch.cumsum(lg, dim=-1) - lg                  # exclusive
            T_act = Tv[act][:, :, None]
            t_excl = T_act * torch.exp(cum_x)
            t_incl = t_excl * one_minus
            contrib = t_incl >= C.T_STOP
            w = torch.where(contrib, alpha * t_excl, 0.0)
            cols[act] += torch.einsum("apc,kac->apk", w, f[6:10])
            Tv[act] = torch.where(contrib, t_incl, T_act).amin(dim=-1)
        out[tiles, 0:3] = (cols[:, :, 0:3] + Tv[:, :, None] * bg).transpose(1, 2)
        out[tiles, 3] = cols[:, :, 3]
        out[tiles, 4] = Tv
    return out


def _check_inputs(feat, starts, stops, row_off, bg):
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
    devs = {x.device for x in (feat, starts, stops, row_off, bg)}
    if len(devs) != 1:
        raise ValueError(f"blend inputs lie on several devices: {devs}")
    if not all(x.is_contiguous() for x in (feat, starts, stops, row_off, bg)):
        raise ValueError("blend inputs must be contiguous")


def _kernel_lib():
    lib = _build.load("blend_forward")
    fn = lib.fourdgs_blend_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def blend_forward(feat, starts, stops, row_off, bg, grid_x: int):
    """Packed [T, 5, 256] forward blend.

    CUDA tensors launch the kernel (``blend_forward.launches`` counts the
    launches) or raise; CPU tensors run :func:`blend_forward_plain`.
    """
    _check_inputs(feat, starts, stops, row_off, bg)
    if feat.device.type == "cpu":
        return blend_forward_plain(feat, starts, stops, row_off, bg, grid_x)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    K = feat.shape[1]
    T = starts.shape[0]
    if K >= 2**31 // C.FEAT_ROWS:
        raise ValueError(f"K = {K} overflows the kernel's int32 offsets")
    out = torch.empty((T, C.OUT5, C.N_PIX), dtype=torch.float32,
                      device=feat.device)
    if T == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(feat.device):   # the C side launches on the current device
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = lib.fourdgs_blend_forward(
            feat.data_ptr(), starts.data_ptr(), stops.data_ptr(),
            row_off.data_ptr(), bg.data_ptr(), out.data_ptr(),
            T, K, grid_x, stream)
    _build.check(lib, rc, "blend_forward launch")
    blend_forward.launches += 1
    return out


blend_forward.launches = 0
