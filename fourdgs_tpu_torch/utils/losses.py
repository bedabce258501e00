"""Image losses, PSNR and the tile layout of the training loss. PyTorch.

Counterpart of ``fourdgs_tpu/utils/losses.py:17-160``: ``l1_loss``, ``psnr``
(20·log10(1/√mse) per image), ``tile_image`` / ``tile_image_np`` (an image to
channel-major [T, C, 256] tile blocks, the rasterizer's packed layout),
``tile_pixel_mask``, ``masked_psnr`` and the windowed ``ssim`` of the
evaluation, with ``abs_`` and ``clip``, which take JAX's derivatives at 0 and
at a tie, and ``ssim_tiles`` (``:162-238``), SSIM on the train step's
channel-major tile blocks, which the D-SSIM term (``lambda_dssim != 0``)
reads.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from fourdgs_tpu_torch import resolve_device


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is +1 (``torch.abs`` gives 0).
    Zeros are common on the train path: a background pixel that equals its
    GT, and the temporal planes, which start at exactly 1 under the
    regularizer's |1 − g|."""
    return torch.where(x >= 0, x, -x)


class _Clip(torch.autograd.Function):
    """``torch.clamp`` forward, JAX's ``clip`` gradient: at a tie with a
    bound half of it passes, as ``jnp.maximum``/``jnp.minimum`` split it
    (``torch.clamp`` passes all of it)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside, tie = x > lo, x == lo
        if hi is not None:
            inside, tie = inside & (x < hi), tie | (x == hi)
        return g * (inside.to(g.dtype) + 0.5 * tie.to(g.dtype)), None, None


def clip(x: torch.Tensor, lo: float, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (``jnp.maximum(x, lo)`` when ``hi`` is None),
    gradient included, in one launch."""
    return _Clip.apply(x, lo, hi)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(abs_(pred - gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over [..., C, H, W]; returns [...]."""
    mse = torch.mean((pred - gt) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-20)))


def tile_image(img: torch.Tensor, tile_x: int = 16, tile_y: int = 16,
               pad_cols: int = 0) -> torch.Tensor:
    """[C, H, W] image → [T, C + pad_cols, tile_y·tile_x] channel-major tile
    blocks (row-major tiles, row-major pixels in a tile). H and W are padded
    to tile multiples with zeros (:func:`tile_pixel_mask` marks the padding);
    ``pad_cols`` appends zero channels, so a GT tiled with ``pad_cols=2``
    lines up with the packed (r, g, b, depth, t_fin) render."""
    c, h, w = img.shape
    gy = -(-h // tile_y)
    gx = -(-w // tile_x)
    img = F.pad(img, (0, gx * tile_x - w, 0, gy * tile_y - h))
    out = img.reshape(c, gy, tile_y, gx, tile_x).permute(1, 3, 0, 2, 4).reshape(
        gy * gx, c, tile_y * tile_x)
    if pad_cols:
        out = F.pad(out, (0, 0, 0, pad_cols))
    return out


def tile_image_np(img: np.ndarray, tile_x: int = 16,
                  tile_y: int = 16) -> np.ndarray:
    """Host-side :func:`tile_image` of an [H, W, C] array of any dtype (a
    loader's uint8 image) → [T, C, tile_y·tile_x]."""
    h, w, c = img.shape
    gy = -(-h // tile_y)
    gx = -(-w // tile_x)
    img = np.pad(img, ((0, gy * tile_y - h), (0, gx * tile_x - w), (0, 0)))
    img = img.reshape(gy, tile_y, gx, tile_x, c)
    return np.ascontiguousarray(
        img.transpose(0, 2, 4, 1, 3).reshape(gy * gx, c, tile_y * tile_x))


def tile_pixel_mask(height: int, width: int, tile_x: int = 16,
                    tile_y: int = 16, device="cuda") -> torch.Tensor:
    """[T, 1, tile_y·tile_x] float mask on ``device``: 1 inside H×W, 0 on
    the tile-grid padding."""
    device = resolve_device(device)
    gy = -(-height // tile_y)
    gx = -(-width // tile_x)
    yy = torch.arange(gy * tile_y, device=device) < height
    xx = torch.arange(gx * tile_x, device=device) < width
    m = (yy[:, None] & xx[None, :]).to(torch.float32)
    return tile_image(m[None], tile_x, tile_y)


def masked_psnr(pred: torch.Tensor, gt: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """PSNR over mask≠0 pixels only (utils/image_utils.py:16-38).

    pred/gt: [C, H, W]; mask: [H, W] (or [1, H, W]): one MSE over all
    selected elements across channels (``losses.py:98-113``)."""
    if mask.dim() == 3:
        mask = mask[0]
    sel = (mask != 0).to(pred.dtype)[None]
    n = torch.clamp(torch.sum(sel) * pred.shape[0], min=1.0)
    mse = torch.sum(((pred - gt) ** 2) * sel) / n
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-20)))


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalized 2-D Gaussian window of SSIM (``losses.py:116-124``)."""
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
                  for x in range(window_size)])
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM (utils/loss_utils.py:32-68, ``losses.py:127-160``):
    per-channel Gaussian window, zero 'same' padding, C1 = 0.01²,
    C2 = 0.03², the mean over everything. img1/img2: [C, H, W] or
    [B, C, H, W]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    C = img1.shape[1]
    w = torch.tensor(gaussian_window(window_size), dtype=img1.dtype,
                     device=img1.device)
    kernel = w[None, None].repeat(C, 1, 1, 1)          # [C, 1, K, K] depthwise

    def conv(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=C)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls on the card without TF32 for the block, as JAX's
    ``Precision.HIGHEST``; the setting is restored after."""
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = old


class _Band(torch.autograd.Function):
    """``x @ w`` over the last axis of ``x`` with TF32 off in the forward and
    in the backward: a backward runs after the forward's block has closed,
    so it turns TF32 off again itself (the gradient of ``w``, a constant, is
    not taken)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        with _no_tf32():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with _no_tf32():
            return g @ w.T, None


def ssim_window_band(window_size: int = 11, n: int = 16) -> np.ndarray:
    """The band matrix [n + 2·half, n] of the separable Gaussian window:
    ``out[j] = Σ_k ext[j + k]·g[k]`` over the halo-extended axis ``ext``."""
    half = window_size // 2
    g1 = np.array([math.exp(-((x - half) ** 2) / (2 * 1.5**2))
                   for x in range(window_size)])
    g1 = (g1 / g1.sum()).astype(np.float32)
    band = np.zeros((n + 2 * half, n), np.float32)
    for j in range(n):
        band[j:j + window_size, j] = g1
    return band


def ssim_tiles(a: torch.Tensor, b: torch.Tensor, grid_x: int, grid_y: int,
               window_size: int = 11) -> torch.Tensor:
    """SSIM equal to :func:`ssim`, computed on channel-major tile blocks
    [B?, T, C, 256] (T = grid_y·grid_x row-major 16×16 tiles), the layout
    the rasterizer's packed render comes in.

    The 11×11 window is separable, and a tile needs a 5-pixel halo from its
    4 edge neighbours: tile rolls t ± 1 and t ± grid_x, with edge masks that
    reproduce the zero 'same' padding. One conv pass runs over the five
    stacked quantities (a, b, a², b², ab): two halo rolls and two band
    products, each a float32 matmul with TF32 off (:class:`_Band`, forward
    and backward), as JAX takes them at ``Precision.HIGHEST``. H and W must
    be multiples of 16 (the train step takes the image-space :func:`ssim`
    on a padded grid)."""
    if a.dim() == 3:
        a, b = a[None], b[None]
    B, T, C, npix = a.shape
    if T != grid_x * grid_y or npix != 256:
        raise ValueError(f"{tuple(a.shape)} is not a [B, {grid_x}·{grid_y}, C, 256] block")
    half = window_size // 2
    dev = a.device
    band = torch.from_numpy(ssim_window_band(window_size)).to(dev)
    t = torch.arange(T, device=dev)
    tcol, trow = t % grid_x, t // grid_x

    def edge(keep):
        return keep.to(a.dtype)[None, :, None, None, None]

    def conv_xy(x):                              # [B, T, C', 16, 16]
        ext = torch.cat([torch.roll(x, 1, dims=1)[..., 16 - half:] * edge(tcol != 0), x,
                         torch.roll(x, -1, dims=1)[..., :half] * edge(tcol != grid_x - 1)],
                        dim=-1)                  # [B, T, C', 16, 16 + 2h]
        x = _Band.apply(ext, band)               # along the rows' pixels
        ext = torch.cat([torch.roll(x, grid_x, dims=1)[..., 16 - half:, :] * edge(trow != 0),
                         x,
                         torch.roll(x, -grid_x, dims=1)[..., :half, :]
                         * edge(trow != grid_y - 1)], dim=-2)   # [B, T, C', 16 + 2h, 16]
        return _Band.apply(ext.transpose(-1, -2), band).transpose(-1, -2)

    va = a.reshape(B, T, C, 16, 16)
    vb = b.reshape(B, T, C, 16, 16)
    cs = conv_xy(torch.cat([va, vb, va * va, vb * vb, va * vb], dim=2))
    mu1, mu2 = cs[:, :, 0:C], cs[:, :, C:2 * C]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = cs[:, :, 2 * C:3 * C] - mu1_sq
    sigma2_sq = cs[:, :, 3 * C:4 * C] - mu2_sq
    sigma12 = cs[:, :, 4 * C:5 * C] - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)
