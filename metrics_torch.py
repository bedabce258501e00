#!/usr/bin/env python3
"""Evaluate saved renders with the PyTorch port: PSNR / SSIM / MS-SSIM /
D-SSIM / LPIPS.

The port's ``metrics.py``:

    python3 metrics_torch.py --model_path output/<expname> [output/<other> ...]
                             [--device cuda|cpu]

Reads the ``test/ours_<iter>/{renders,gt}`` PNG trees that ``render_torch.py``
writes (and a ``masks/`` tree beside them, for a masked PSNR) and writes
``results.json`` and ``per_view.json`` next to them. D-SSIM = (1 − MS-SSIM)/2
(metrics.py:79). The LPIPS-vgg and LPIPS-alex columns come from
:func:`try_lpips`, in ``metrics.py``'s order: the port's trunk
(``fourdgs_tpu_torch/utils/lpips.py``) with converted pretrained weights,
else the external ``lpips`` package if it imports, else they are null, as
``metrics.py`` writes them. No weights are in the repository, so they are
null until ``fourdgs_tpu/assets/lpips_<net>.npz`` exists (or
``$FOURDGS_LPIPS_WEIGHTS_DIR`` holds it).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# MS-SSIM's level weights (metrics.py:32)
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim(img1, img2, levels: int = 5) -> float:
    """Multi-scale SSIM of [B, C, H, W] tensors with the standard level
    weights (``metrics.py::msssim``): 11×11 Gaussian window, zero padding
    of 5, 2×2 mean pooling between levels."""
    import torch
    import torch.nn.functional as F

    from fourdgs_tpu_torch.utils.losses import gaussian_window

    weights = torch.tensor(MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=img1.device)
    C = img1.shape[1]
    kernel = torch.tensor(gaussian_window(11), device=img1.device)[None, None]
    kernel = kernel.repeat(C, 1, 1, 1)

    def conv(x):
        return F.conv2d(x, kernel, padding=5, groups=C)

    def ssim_parts(a, b):
        mu1, mu2 = conv(a), conv(b)
        s1 = conv(a * a) - mu1 * mu1
        s2 = conv(b * b) - mu2 * mu2
        s12 = conv(a * b) - mu1 * mu2
        C1, C2 = 0.01**2, 0.03**2
        lum = (2 * mu1 * mu2 + C1) / (mu1**2 + mu2**2 + C1)
        cs = (2 * s12 + C2) / (s1 + s2 + C2)
        return torch.mean(lum), torch.mean(cs)

    a, b = img1, img2
    mcs, l_final = [], None
    for i in range(levels):
        l_final, cs = ssim_parts(a, b)
        mcs.append(cs)
        if i < levels - 1:
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    mcs = torch.stack(mcs)
    return float(torch.prod(torch.clamp(mcs[:-1], min=0) ** weights[:-1])
                 * torch.clamp(l_final, min=0) ** weights[-1])


def try_lpips(device="cuda"):
    """{net: LPIPS distance} for "vgg" and "alex", or None (``metrics.py::
    try_lpips``): (1) the port's trunk with converted pretrained weights;
    (2) the external ``lpips`` package, if it imports; (3) None, and the
    columns stay null. Each distance takes [3, H, W] float images in [0, 1]
    on ``device`` and returns a float."""
    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.utils import lpips as tlpips

    dev = resolve_device(device)
    nets = {}
    for net in ("vgg", "alex"):
        w = tlpips.load_weights(net)
        if w is not None:
            nets[net] = tlpips.make_lpips(w, net, dev)
    if nets:
        return nets
    try:
        import lpips
    except ImportError:
        return None

    def wrap(m):
        m = m.to(dev)

        def f(a, b):
            with torch.no_grad():
                return float(m(a[None] * 2 - 1, b[None] * 2 - 1))
        return f

    return {"vgg": wrap(lpips.LPIPS(net="vgg")), "alex": wrap(lpips.LPIPS(net="alex"))}


def read_images(d: str, mode: str = "RGB") -> list[np.ndarray]:
    """The PNGs of ``d`` in name order, as float32 in [0, 1] (``mode`` as
    Pillow's ``convert``)."""
    from fourdgs_tpu_torch.utils import png

    return [png.read_png(os.path.join(d, name), mode).astype(np.float32)
            / 255.0 for name in sorted(os.listdir(d)) if name.endswith(".png")]


def evaluate(model_paths, device="cuda") -> dict:
    """Write ``results.json`` and ``per_view.json`` for each model path;
    returns {model path: results}."""
    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.utils.losses import masked_psnr, psnr, ssim

    dev = resolve_device(device)
    lpips_nets = try_lpips(dev) or {}
    everything = {}
    for model_path in model_paths:
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print(f"{model_path}: no test renders, skipping")
            continue
        full, per_view = {}, {}
        for method in sorted(os.listdir(test_dir)):
            base = os.path.join(test_dir, method)
            renders = read_images(os.path.join(base, "renders"))
            gts = read_images(os.path.join(base, "gt"))
            mdir = os.path.join(base, "masks")
            masks = read_images(mdir, "L") if os.path.isdir(mdir) else None
            rows = []
            for vi, (r, g) in enumerate(zip(renders, gts)):
                rt = torch.tensor(r.transpose(2, 0, 1), device=dev)[None]
                gt = torch.tensor(g.transpose(2, 0, 1), device=dev)[None]
                ms = msssim(rt, gt)
                row = {
                    "PSNR": (float(masked_psnr(rt[0], gt[0],
                                               torch.tensor(masks[vi], device=dev)))
                             if masks and vi < len(masks)
                             else float(psnr(rt, gt)[0])),
                    "SSIM": float(ssim(rt, gt)),
                    "MS-SSIM": ms,
                    "D-SSIM": (1.0 - ms) / 2.0,
                }
                for net in ("vgg", "alex"):
                    fn = lpips_nets.get(net)
                    row[f"LPIPS-{net}"] = float(fn(rt[0], gt[0])) if fn else None
                rows.append(row)
            if not rows:
                continue
            keys = rows[0].keys()
            full[method] = {k: (float(np.mean([r[k] for r in rows]))
                                if rows[0][k] is not None else None) for k in keys}
            per_view[method] = {k: [r[k] for r in rows] for k in keys}
            print(f"{model_path} {method}: " + " ".join(
                f"{k}={v:.4f}" for k, v in full[method].items() if v is not None))
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        everything[model_path] = full
    return everything


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", "-m", nargs="+", required=True)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = parser.parse_args(argv)
    return evaluate(args.model_path, args.device)


if __name__ == "__main__":
    main()
