"""3-nearest-neighbour mean squared distance (simple-knn's ``distCUDA2``).

Counterpart of ``fourdgs_tpu/ops/knn.py:20-51``, used once per scene to set
the initial log-scales from the local point density. The same chunked
O(P²) scan: each chunk of queries takes its squared distances to every
point as a Gram product, ‖a‖² + ‖b‖² − 2a·b, masks its own index, and keeps
the mean of the three smallest. The formulation is JAX's so that the
cancellation of the Gram terms (and so the distances of near or duplicate
points) comes out the same.
"""

from __future__ import annotations

import torch


def mean_sq_dist_3nn(points: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """For each point of ``points`` [P, 3] float32, the mean of its squared
    distances to its 3 nearest other points (negative Gram values read 0).
    Returns [P] float32 on the points' device."""
    P = points.shape[0]
    sq = torch.sum(points * points, dim=-1)                      # [P]
    cols = torch.arange(P, device=points.device)
    out = []
    for base in range(0, P, chunk):
        qc, sqc = points[base:base + chunk], sq[base:base + chunk]
        d2 = sqc[:, None] + sq[None, :] - 2.0 * (qc @ points.T)
        rows = torch.arange(base, base + qc.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        neg_top3 = torch.topk(-d2, 3, dim=-1).values
        out.append(torch.mean(torch.clamp(-neg_top3, min=0.0), dim=-1))
    return torch.cat(out)
