"""Plain PyTorch reference of app C's DBSCAN on each slice (`hd_dbscan_slice`).

The algorithm of `point-cloud-clustering/DBSCAN_simple.h:27-90`, on the
(x, y) pixels of a slice's valid events, duplicates kept:

- a point's neighbours are the points within eps, itself included, by the
  exact difference form (x_i - x_j)^2 + (y_i - y_j)^2 <= eps^2 (exact in
  float32 on integer pixels); a point with at least core_min_pts of them
  is a core point;
- clusters are expanded breadth first, each from the lowest-indexed core
  point that no cluster holds yet; a core point reached adds its
  neighbours, a border point reached is added and not expanded, and a
  point already held by an earlier cluster stays there;
- clusters of size outside [min_cluster_size, max_cluster_size] are
  dropped (their points are noise), the rest numbered by size, largest
  first (simple.h:89), ties by the lower seed index; each kept cluster's
  size and float32 mean (x, y).

Departures from DBSCAN_simple.h, each where its behaviour is not the
documented one or depends on the container:
- the header puts a seed's whole neighbourhood into its queue without
  asking whether a point is already in a cluster, so a border point within
  eps of a later seed is listed in both clusters; here it stays in the
  first;
- the header sorts clusters by size alone (simple.h:89), which leaves
  equal sizes in whatever order its sort gives; ties go to the lower seed
  here;
- the breadth-first expansion runs one level at a time over the whole
  frontier, not one queue entry at a time: a cluster's members do not
  depend on the order within a level;
- points are the slice's event pixels, not a `.pcd` cloud, and invalid
  lanes are no points.

Written from these rules alone: it imports nothing of the program, and it
does not propagate labels. It runs on the device it is given, float32,
with TF32 off; `control` rounds the coordinates to bfloat16, the precision
below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 2048


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def within_eps(pts: torch.Tensor, valid: torch.Tensor, eps: float) -> torch.Tensor:
    """bool (N, N): valid points i, j within eps, by the difference form."""
    n = pts.shape[0]
    eps2 = eps * eps
    rows = []
    for i in range(0, n, BLOCK):
        d = pts[i:i + BLOCK, None, :] - pts[None, :, :]
        rows.append((d * d).sum(-1) <= eps2)
    adj = torch.cat(rows) if rows else torch.zeros((0, 0), dtype=torch.bool,
                                                   device=pts.device)
    return adj & valid[:, None] & valid[None, :]


def cluster_slice(x, y, valid, cfg: dict, control: bool = False,
                  counts: dict | None = None) -> dict:
    """One slice, (N,) tensors on one device: labels (N,) int32, core (N,)
    bool, num_clusters, size (K,) int32 and centroid (K, 2) float32 with K =
    N // min_cluster_size, rows past num_clusters 0, as NumPy. `cfg` is the
    configuration file as a dict."""
    _no_tf32()
    db = cfg["dbscan"]
    n = x.shape[0]
    dev = x.device
    pts = torch.stack([x, y], 1).to(torch.float32)
    if control:
        pts = pts.to(torch.bfloat16).to(torch.float32)
    adj = within_eps(pts, valid, float(db["eps"]))
    nbrs = adj.sum(1)
    core = valid & (nbrs >= db["core_min_pts"])

    core_h = core.cpu().numpy()
    held = np.zeros(n, bool)           # points some cluster holds
    clusters = []                      # (seed, member mask), in expansion order
    levels = 0
    for seed in np.flatnonzero(core_h):
        if held[seed]:
            continue
        member = torch.zeros(n, dtype=torch.bool, device=dev)
        member[seed] = True
        frontier, taken = member.clone(), torch.as_tensor(held, device=dev)
        while True:
            grow = torch.nonzero(frontier & core).flatten()
            if not grow.numel():
                break
            frontier = adj[grow].any(0) & ~member & ~taken
            member |= frontier
            levels += 1
        mask = member.cpu().numpy()
        held |= mask
        clusters.append((int(seed), mask))

    lo, hi = db["min_cluster_size"], db["max_cluster_size"]
    kept = sorted((c for c in clusters if lo <= c[1].sum() <= hi),
                  key=lambda c: (-int(c[1].sum()), c[0]))
    k = n // max(lo, 1)
    pts_h = pts.cpu().numpy()
    labels = np.full(n, -1, np.int32)
    size = np.zeros(k, np.int32)
    centroid = np.zeros((k, 2), np.float32)
    for rank, (_, mask) in enumerate(kept):
        labels[mask] = rank
        size[rank] = mask.sum()
        # the sum of float32 pixels, exact in float64; then a float32 mean
        total = pts_h[mask].astype(np.float64).sum(0).astype(np.float32)
        centroid[rank] = total / np.float32(size[rank])
    if counts is not None:
        valid_h = valid.cpu().numpy()
        counts.setdefault("clusters", []).append(len(kept))
        counts.setdefault("components", []).append(len(clusters))
        counts.setdefault("core_points", []).append(int(core_h.sum()))
        counts.setdefault("noise_points", []).append(int((valid_h & (labels < 0)).sum()))
        counts.setdefault("largest_neighbourhood", []).append(int(nbrs.max()) if n else 0)
        counts.setdefault("bfs_levels", []).append(levels)
    return {"labels": labels, "core": core_h, "num_clusters": np.int32(len(kept)),
            "size": size, "centroid": centroid}
