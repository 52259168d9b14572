"""Pairwise distances and nearest-center assignment (counterpart of
evflow_tpu/ops/distance.py).

No matmul: the cross term of |a|^2 + |b|^2 - 2 a.b is an explicit sum of
D elementwise products, so no float32 matmul precision setting (TF32 under
`torch.set_float32_matmul_precision("high")`) can reach it. On TPU the same
class of fault, a low-precision 2ab term, inflated neighbor counts 80x
(the JAX module's `pairwise_sqdist` note). With integer coordinates below
2^11 every term is exact in fp32, so neighbor tests on event pixels give
the same bits on the card, on the CPU and in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D), (K, D) -> (M, K) squared Euclidean distances, clamped at 0
    (a NaN stays NaN)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = (a * a).sum(1, keepdim=True)                       # (M, 1)
    b2 = (b * b).sum(1, keepdim=True).T                     # (1, K)
    cross = a[:, :1] * b[:, 0][None, :]
    for k in range(1, a.shape[1]):
        cross = cross + a[:, k:k + 1] * b[:, k][None, :]
    return torch.maximum(a2 + b2 - 2.0 * cross, torch.zeros((), device=a.device))


def pairwise_manhattan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D), (K, D) -> (M, K) L1 distances."""
    return (a[:, None, :].to(torch.float32) - b[None, :, :].to(torch.float32)).abs().sum(-1)


class AssignResult(NamedTuple):
    labels: torch.Tensor   # int32 (M,) nearest center in 0..K-1, or -1 if gated
    dists: torch.Tensor    # float32 (M,) distance to the assigned center (inf if gated)


def assign_to_centers(points: torch.Tensor, centers: torch.Tensor,
                      threshold: float = 50.0) -> AssignResult:
    """Nearest center under a distance gate: the first of equally near
    centers wins (argmin's first index); a point with no center nearer
    than `threshold` gets -1. The exact (M, K, D) difference form, as in
    JAX: K is small, and the matmul form's cancellation could flip labels
    near Voronoi edges."""
    diff = points[:, None, :].to(torch.float32) - centers[None, :, :].to(torch.float32)
    d = torch.sqrt((diff * diff).sum(-1))
    labels = torch.argmin(d, 1).to(torch.int32)
    best = d.amin(1)
    gated = best < threshold
    return AssignResult(torch.where(gated, labels, -1),
                        torch.where(gated, best, torch.inf))


def radius_neighbor_counts(points: torch.Tensor, eps: float,
                           valid: torch.Tensor | None = None,
                           block: int = 2048) -> torch.Tensor:
    """int32 (N,) count of valid points within eps of each point, itself
    included (0 for an invalid point), one (block, N) panel at a time."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    pts = points.to(torch.float32)
    eps2 = torch.full((), eps * eps, dtype=torch.float32, device=pts.device)
    out = []
    for i in range(0, n, block):
        d2 = pairwise_sqdist(pts[i:i + block], pts)
        cnt = ((d2 <= eps2) & valid[None, :]).sum(1, dtype=torch.int32)
        out.append(torch.where(valid[i:i + block], cnt, 0))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=pts.device)


def kth_neighbor_dist(points: torch.Tensor, k: int, eps: float | None = None,
                      block: int = 2048) -> torch.Tensor:
    """(N,) distance to the k-th nearest point, the point itself counted
    (OPTICS' core distance at k = min_pts). With eps, distances beyond it
    are inf, so a point with fewer than k within eps gets inf."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    out = []
    for i in range(0, n, block):
        d = torch.sqrt(pairwise_sqdist(pts[i:i + block], pts))
        if eps is not None:
            d = torch.where(d <= torch.tensor(eps, dtype=torch.float32, device=d.device),
                            d, torch.inf)
        out.append(torch.topk(d, k, 1, largest=False).values[:, k - 1])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float32, device=pts.device)
