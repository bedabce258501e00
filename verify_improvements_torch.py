#!/usr/bin/env python3
"""Smoke-test the Instant4D fast-train improvements on the PyTorch + CUDA
port (about a minute).

The port's ``verify_improvements.py``, with its four checks on
``fourdgs_tpu_torch``: build a random 50k-point cloud and grid-prune it
(``data/grid_pruning.py``), check the isotropic-scaling broadcast
(``models/gaussians.py::get_scaling``), build simplified-RGB (DC-only,
SH degree 0) features (``create_from_pcd``), and assert that the three
ModelParams flags exist (``configs/core.py``). The tensors live on
``--device`` (``cuda`` by default; ``cpu`` runs on the host).

    python verify_improvements_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    """Runs the checks; returns their figures (the points before and after
    the pruning, the ``f_rest`` width at SH degree 0)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the host")
    args = ap.parse_args(argv)

    import torch

    from fourdgs_tpu_torch import resolve_device
    from fourdgs_tpu_torch.configs.core import load_config
    from fourdgs_tpu_torch.data.grid_pruning import grid_prune_pointcloud
    from fourdgs_tpu_torch.data.ply import PointCloud
    from fourdgs_tpu_torch.models import gaussians as G

    dev = resolve_device(args.device)
    t0 = time.time()
    rng = np.random.default_rng(0)

    print("=== 1. grid pruning ===")
    pts = rng.normal(0, 0.5, (50_000, 3)).astype(np.float32)
    pcd = PointCloud(
        points=pts,
        colors=rng.uniform(0, 1, (50_000, 3)).astype(np.float32),
        normals=np.zeros((50_000, 3), np.float32),
    )
    pruned = grid_prune_pointcloud(pcd, None)
    reduction = 1 - pruned.points.shape[0] / pts.shape[0]
    print(f"  {pts.shape[0]} → {pruned.points.shape[0]} points "
          f"({reduction*100:.1f}% reduction)")
    assert pruned.points.shape[0] < pts.shape[0]

    print("=== 2. isotropic gaussians ===")
    params = {"scaling": torch.tensor(rng.normal(size=(100, 3)), dtype=torch.float32,
                                      device=dev)}
    iso = G.get_scaling(params, isotropic=True).cpu().numpy()
    assert np.allclose(iso[:, 0], iso[:, 1])
    assert np.allclose(iso[:, 0], iso[:, 2])
    print("  scaling broadcast equal across the three axes ✓")

    print("=== 3. simplified RGB (sh_degree=0) ===")
    cfg = load_config()
    cfg.model.sh_degree = 0
    cfg.tpu.capacity = 1024
    state = G.create_from_pcd(cfg, pts[:512],
                              rng.uniform(0, 1, (512, 3)).astype(np.float32), 1.0,
                              device=dev)
    f_rest_width = int(state.params["f_rest"].shape[1])
    assert f_rest_width == 0
    full = 16 * 3
    dc = 1 * 3
    print(f"  SH coeffs {full//3} → {dc//3} per channel "
          f"(−{(1 - dc/full)*100:.2f}% SH params)")

    print("=== 4. config flags ===")
    cfg = load_config()
    for flag in ("use_grid_pruning", "use_isotropic_gaussian",
                 "use_simplified_rgb"):
        assert hasattr(cfg.model, flag), flag
        print(f"  ModelParams.{flag} ✓")

    print(f"all checks passed in {time.time()-t0:.1f}s")
    return {"points": int(pts.shape[0]), "pruned": int(pruned.points.shape[0]),
            "f_rest_width": f_rest_width}


if __name__ == "__main__":
    main()
