"""LPIPS (Learned Perceptual Image Patch Similarity) on PyTorch.

A copy of ``fourdgs_tpu/utils/lpips.py``: the reference's vendored
lpipsPyTorch (lpipsPyTorch/modules/lpips.py:8-36, networks.py, utils.py), a
frozen VGG16 or AlexNet feature trunk, per-layer unit normalisation over
channels, squared feature differences, frozen 1×1 "lin" weights, the spatial
mean, summed over layers. The convolutions, ReLUs and max pools are
``torch.nn.functional``'s (JAX computes them with XLA, outside any Pallas
kernel). TF32 is off for the whole package (``fourdgs_tpu_torch/__init__``),
so the card's trunk agrees with the CPU's in float32.

Weights come from one ``.npz`` in JAX's layout (``conv{i}_w`` [O, I, kh, kw],
``conv{i}_b`` [O] per trunk conv, ``lin{j}_w`` [1, C, 1, 1] per tap), which
``scripts/convert_lpips_weights.py`` writes from torchvision's pretrained
trunks and the v0.1 LinLayers on a machine with network access. The port
reads them where JAX does (:func:`default_weight_paths`): under
``$FOURDGS_LPIPS_WEIGHTS_DIR``, then ``fourdgs_tpu/assets/lpips_<net>.npz``,
read as data. None are in the repository, so ``metrics_torch.py``'s LPIPS
columns stay null until they are.

Layer recipe (torchvision ``features`` indices, as networks.py's taps):
  vgg16: taps after ReLUs 4, 9, 16, 23, 30 → channels 64/128/256/512/512
  alex : taps after ReLUs 2, 5, 8, 10, 12  → channels 64/192/384/256/256
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

# (out_ch, kernel, stride, pad) per conv; "M" a 2×2 max pool of stride 2,
# "M3" a 3×3 one: torchvision's vgg16.features and alexnet.features
VGG16_ARCH = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M",
    (128, 3, 1, 1), (128, 3, 1, 1), "M",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M",
]
# the features-list index (0-based, convs, ReLUs and pools each counted)
# after which an activation is tapped
VGG16_TAPS = (3, 8, 15, 22, 29)       # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG16_CHANNELS = (64, 128, 256, 512, 512)

ALEX_ARCH = [
    (64, 11, 4, 2), "M3",
    (192, 5, 1, 2), "M3",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1), "M3",
]
ALEX_TAPS = (1, 4, 7, 9, 11)
ALEX_CHANNELS = (64, 192, 384, 256, 256)

# BaseNet's z-score constants (networks.py:41-44), applied to the raw [0, 1]
# input as the reference's vendored net does (it omits upstream's
# [0, 1] → [-1, 1] scaling layer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# the JAX package's assets directory, where its converted weights go
ASSETS_DIR = pathlib.Path(__file__).resolve().parents[2] / "fourdgs_tpu" / "assets"


def default_weight_paths(net: str = "vgg") -> list[str]:
    """Where JAX's ``load_weights`` looks: ``$FOURDGS_LPIPS_WEIGHTS_DIR``
    first, then ``fourdgs_tpu/assets/lpips_<net>.npz``."""
    paths = []
    env = os.environ.get("FOURDGS_LPIPS_WEIGHTS_DIR")
    if env:
        paths.append(os.path.join(env, f"lpips_{net}.npz"))
    paths.append(str(ASSETS_DIR / f"lpips_{net}.npz"))
    return paths


def load_weights(net: str = "vgg", path: str | None = None):
    """The weights dict for :func:`make_lpips`, or None if no ``.npz`` is
    found."""
    for p in [path] if path else default_weight_paths(net):
        if p and os.path.exists(p):
            data = np.load(p)
            return {k: data[k] for k in data.files}
    return None


def _trunk_layout(net: str):
    if net == "vgg":
        return VGG16_ARCH, VGG16_TAPS, VGG16_CHANNELS
    if net == "alex":
        return ALEX_ARCH, ALEX_TAPS, ALEX_CHANNELS
    raise ValueError(f"net must be 'vgg' or 'alex', got {net!r}")


def make_lpips(weights: dict, net: str = "vgg", device="cuda"):
    """The LPIPS distance ``d(x, y) → 0-d tensor`` on ``device``.

    ``x``, ``y``: [3, H, W] or [B, 3, H, W] float images in [0, 1], tensors
    or arrays (moved to ``device``); the result is the mean over the batch.
    ``weights``: the flat dict of :func:`load_weights`.
    """
    import torch
    import torch.nn.functional as F

    from fourdgs_tpu_torch import resolve_device

    dev = resolve_device(device)
    arch, taps, _ = _trunk_layout(net)
    n_convs = sum(1 for a in arch if not isinstance(a, str))
    for i in range(n_convs):
        if f"conv{i}_w" not in weights:
            raise KeyError(f"missing conv{i}_w")
    for j in range(len(taps)):
        if f"lin{j}_w" not in weights:
            raise KeyError(f"missing lin{j}_w")
    w = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in weights.items()}
    shift = torch.tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=dev)[None, :, None, None]

    def features(x):
        x = (x - shift) / scale
        feats, conv_i, feat_idx = [], 0, 0
        for a in arch:
            if isinstance(a, str):                      # max pool
                x = F.max_pool2d(x, 3 if a == "M3" else 2, stride=2)
                feat_idx += 1
                continue
            _, _, stride, pad = a
            x = F.conv2d(x, w[f"conv{conv_i}_w"], w[f"conv{conv_i}_b"],
                         stride=stride, padding=pad)
            conv_i += 1
            feat_idx += 1                               # the conv
            x = torch.relu(x)
            if feat_idx in taps:                        # unit norm (utils.py:6-8)
                norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                feats.append(x / (norm + 1e-10))
            feat_idx += 1                               # the ReLU
            if len(feats) == len(taps):
                break
        return feats

    @torch.no_grad()
    def distance(x, y):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if x.ndim == 3:
            x, y = x[None], y[None]
        total = 0.0
        for j, (a, b) in enumerate(zip(features(x), features(y))):
            lin = w[f"lin{j}_w"][0, :, 0, 0][None, :, None, None]
            r = torch.sum((a - b) ** 2 * lin, dim=1)
            total = total + torch.mean(r, dim=(1, 2))
        return torch.mean(total)

    return distance


def random_weights(net: str = "vgg", seed: int = 0) -> dict:
    """Random weights in the ``.npz`` layout, the same arrays as JAX's
    ``random_weights(net, seed)``: for architecture and parity tests only,
    never a substitute for the pretrained metric."""
    arch, _, channels = _trunk_layout(net)
    rng = np.random.default_rng(seed)
    out = {}
    in_ch, i = 3, 0
    for a in arch:
        if isinstance(a, str):
            continue
        out_ch, k, _, _ = a
        out[f"conv{i}_w"] = rng.normal(
            0, (2.0 / (in_ch * k * k)) ** 0.5, (out_ch, in_ch, k, k)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(out_ch, np.float32)
        in_ch = out_ch
        i += 1
    for j, c in enumerate(channels):
        out[f"lin{j}_w"] = np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32)
    return out
