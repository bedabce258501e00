"""Image losses, PSNR and the tile layout of the training loss. PyTorch.

Counterpart of ``fourdgs_tpu/utils/losses.py:17-95``: ``l1_loss``, ``psnr``
(20·log10(1/√mse) per image), ``tile_image`` / ``tile_image_np`` (an image to
channel-major [T, C, 256] tile blocks, the rasterizer's packed layout) and
``tile_pixel_mask``, with ``abs_`` and ``clip``, which take JAX's
derivatives at 0 and at a tie. ``ssim`` and ``ssim_tiles`` are not ported
yet.
"""

from __future__ import annotations

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
