"""k-means over event point clouds, app D (counterpart of
evflow_tpu/models/kmeans.py).

The reference's OpenCL k-means: nearest-center assignment under a 50.0
gate, per-cluster sums, centroid = sum / count, repeated while the largest
centroid move exceeds the tolerance. The JAX package's `lax.while_loop` is
a host loop here (one device-to-host read of the move per iteration); the
centroid sums are `ops.segment`'s deterministic segmented sums, so two
calls on the card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import KMeansConfig
from ..ops.distance import assign_to_centers
from ..ops.segment import segment_mean_points


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # float32 (K, 2)
    labels: torch.Tensor      # int32 (N,) 0..K-1 or -1 (gated out)
    counts: torch.Tensor      # int32 (K,)
    iters: torch.Tensor       # int32 ()
    error_max: torch.Tensor   # float32 () final max |centroid delta| per coord


def _assign(pts, centroids, valid, k, cfg: KMeansConfig):
    """Labels (-1 where gated or invalid), the centroids of the assigned
    points and the counts."""
    res = assign_to_centers(pts, centroids, threshold=cfg.assign_threshold)
    labels = torch.where(valid, res.labels, -1)
    mean, counts = segment_mean_points(pts, labels.clamp_min(0), k, labels >= 0)
    return labels, mean, counts


def kmeans(points: torch.Tensor, init_centroids: torch.Tensor,
           valid: torch.Tensor | None = None,
           cfg: KMeansConfig = KMeansConfig()) -> KMeansResult:
    """Iterative k-means on (N, 2) points from (K, 2) initial centroids, on
    the points' device. Iterates while the move exceeds
    cfg.convergence_tol and fewer than cfg.max_iters iterations ran; an
    empty cluster keeps its centroid; one final assignment against the
    last centroids gives the labels and counts."""
    n = points.shape[0]
    k = init_centroids.shape[0]
    dev = points.device
    pts = points.to(torch.float32)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    centroids = init_centroids.to(device=dev, dtype=torch.float32)
    err = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    it = 0
    while it < cfg.max_iters and bool(err > cfg.convergence_tol):
        _, mean, counts = _assign(pts, centroids, valid, k, cfg)
        new_c = torch.where((counts > 0)[:, None], mean, centroids)
        err = (new_c - centroids).abs().amax()
        centroids = new_c
        it += 1
    labels, _, counts = _assign(pts, centroids, valid, k, cfg)
    return KMeansResult(centroids, labels, counts,
                        torch.tensor(it, dtype=torch.int32, device=dev), err)


def compat_labels(labels: torch.Tensor) -> torch.Tensor:
    """0..K-1 / -1 labels in the kernel's byte-pair encoding, 0, 2, .., 14
    and 255."""
    return torch.where(labels >= 0, labels * 2, 255).to(torch.int32)
