"""Batch clustering with row blocks over the ranks of a process group
(counterpart of evflow_tpu/parallel/batch.py).

The reference's one piece of intra-app parallelism is the multithreaded
OPTICS eps-neighborhood precompute (optics.hpp:456-514): neighbor queries
are independent per point, so rows fan out over threads. Here the rows fan
out over the ranks of a `torch.distributed` group, where JAX shards them
over a device mesh: each rank takes its contiguous block of rows, padded to
equal blocks as `_pad_rows` pads, against the whole point set. There are no
halos and no cross-row dependencies; the only collectives are the ones each
iteration needs anyway.

  - compute_neighbors_sharded: OPTICS' dense table (`optics._dense_rows`,
    the difference form) for the rank's rows; the rows come back to every
    rank by all_gather. Every row is bit-equal to the one-rank table.
  - dbscan_sharded: core counts, min-label propagation rounds and border
    attachment for the rank's rows (`ops.distance.eps_counts` and
    `eps_min_label`: on the card one launch of csrc/dbscan_eps.cu over the
    row block, on the CPU (block, N) panels); each round all_gathers
    the (N,) label vector and all-reduces the changed flag. Labels are
    bit-equal to `dbscan.dbscan` (integer minima).
  - kmeans_sharded: assignment (`ops.distance.assign_to_centers`) on the
    rank's rows; the centroid update all-reduces the per-rank (sum, count)
    partials. The sum of partials reorders the float sums, so centroids
    can differ from `kmeans.kmeans` in the last bits with more than one
    rank; labels and counts on non-degenerate data do not.

Each function takes an optional `group` (a ProcessGroup; the default group
when torch.distributed is initialized). When torch.distributed is not
initialized they run as one rank through the same code, with no
collective; in a group, even of one rank, the collectives run. NCCL
serves ranks on the card, Gloo the CPU: the tensors live on `device`
("cuda" by default), which must be the rank's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import DBSCANConfig, KMeansConfig
from ..models.dbscan import _FAR, DBSCANResult, _finish
from ..models.kmeans import KMeansResult
from ..models.optics import NeighborTable, _dense_rows
from ..ops.distance import NO_LABEL, assign_to_centers, eps_counts, eps_min_label
from ..ops.segment import masked_segment_sum, segment_counts


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> Tuple[int, int]:
    """(size, rank) of `group`; (1, 0) when torch.distributed is not
    initialized."""
    if not _grouped():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _pad_rows(pts: torch.Tensor, mult: int, fill: float) -> torch.Tensor:
    pad = (-pts.shape[0]) % mult
    if pad:
        pts = torch.cat([pts, torch.full((pad,) + pts.shape[1:], fill, dtype=pts.dtype,
                                         device=pts.device)])
    return pts


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' equal blocks `t`, concatenated in rank order (a group of
    one rank runs the collective too)."""
    if not _grouped():
        return t
    flag = t.dtype == torch.bool
    src = (t.to(torch.uint8) if flag else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if flag else out


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    if not _grouped():
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


# --------------------------------------------------------------------------
# OPTICS eps-neighborhood precompute (optics.hpp:456-514 thread fan-out)
# --------------------------------------------------------------------------

def compute_neighbors_sharded(points: np.ndarray, eps: float, min_pts: int,
                              max_neighbors: int = 256, group=None,
                              block: int = 2048, device="cuda") -> NeighborTable:
    """optics.compute_neighbors with the rows split over the group's ranks:
    each rank builds its block, and every rank gets the whole table."""
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    n = pts.shape[0]
    k = min(max_neighbors, n)
    size, rank = world(group)
    blk = -(-n // size)
    rows = _pad_rows(pts, size * blk, float("inf"))[rank * blk:(rank + 1) * blk]
    eps_t = torch.tensor(eps, dtype=torch.float32, device=pts.device)
    part = _dense_rows(rows, pts, eps_t, k, block, min_pts)
    return NeighborTable(*(_all_gather(t, group, size)[:n] for t in part))


# --------------------------------------------------------------------------
# DBSCAN (models/dbscan.dbscan on the rank's row block)
# --------------------------------------------------------------------------

def dbscan_sharded(points, valid: Optional[torch.Tensor] = None,
                   cfg: DBSCANConfig = DBSCANConfig(), group=None,
                   max_iters: int = 64, block: int = 2048,
                   device="cuda") -> DBSCANResult:
    """dbscan.dbscan of (N, D) points (a tensor or array, moved to
    `device`) with its eps tests (core counts, min-label propagation,
    border attachment) on the rank's row block. Bit-equal labels."""
    points = torch.as_tensor(points, device=device)
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.to(dev)
    pts = torch.where(valid[:, None], points.to(torch.float32), _FAR)
    size, rank = world(group)
    nl = -(-n // size)
    lo = rank * nl
    rows = _pad_rows(pts, size * nl, _FAR)[lo:lo + nl]
    vl = _pad_rows(valid, size * nl, False)[lo:lo + nl]
    gid = lo + torch.arange(nl, dtype=torch.int32, device=dev)

    def gather(t):
        return _all_gather(t, group, size)[:n]

    cnt_l = eps_counts(rows, pts, cfg.eps, valid, vl, block)
    core_l = vl & (cnt_l >= cfg.core_min_pts) & (gid < n)
    core = gather(core_l)
    lab_l = torch.where(core_l, gid, NO_LABEL)

    # _propagate's rounds, each reading the whole label vector
    it, changed = 0, True
    while changed and it < max_iters:
        new = eps_min_label(rows, pts, cfg.eps, gather(lab_l), core, lab_l, core_l, block)
        full_new = gather(new)
        jumped = torch.where(new < n, full_new[new.clamp(0, n - 1).long()], new)
        new = torch.minimum(new, jumped)
        changed = bool(_all_reduce_sum((new != lab_l).any().to(torch.int32)[None], group) > 0)
        lab_l = new
        it += 1
    border = eps_min_label(rows, pts, cfg.eps, gather(lab_l), core, block=block)
    lab_l = torch.where(core_l, lab_l, torch.where(vl & (gid < n), border, NO_LABEL))
    return _finish(gather(lab_l), core, it, cfg)


# --------------------------------------------------------------------------
# k-means (models/kmeans.kmeans with row-block assignment, summed partials)
# --------------------------------------------------------------------------

def kmeans_sharded(points, init_centroids, valid: Optional[torch.Tensor] = None,
                   cfg: KMeansConfig = KMeansConfig(), group=None,
                   device="cuda") -> KMeansResult:
    """kmeans.kmeans of (N, 2) points (a tensor or array, moved to
    `device`) with the assignment on the rank's row block and the centroid
    update from the all-reduced per-rank (sum, count) partials."""
    pts = torch.as_tensor(points, device=device).to(torch.float32)
    dev = pts.device
    n = pts.shape[0]
    k = init_centroids.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    size, rank = world(group)
    nl = -(-n // size)
    lo = rank * nl
    rows = _pad_rows(pts, size * nl, _FAR)[lo:lo + nl]
    vl = _pad_rows(valid.to(dev), size * nl, False)[lo:lo + nl]

    def assign(centroids):
        """The rank's labels, and the group's per-cluster sums and counts."""
        res = assign_to_centers(rows, centroids, threshold=cfg.assign_threshold)
        labels = torch.where(vl, res.labels, -1)
        seg, assigned = labels.clamp_min(0), labels >= 0
        sums = masked_segment_sum(rows, seg, k, assigned)
        counts = segment_counts(seg, k, assigned)
        return labels, _all_reduce_sum(sums, group), _all_reduce_sum(counts, group)

    centroids = torch.as_tensor(init_centroids, device=dev).to(torch.float32)
    err = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    it = 0
    while it < cfg.max_iters and bool(err > cfg.convergence_tol):
        _, sums, counts = assign(centroids)
        mean = sums / torch.clamp_min(counts, 1).to(torch.float32)[:, None]
        new_c = torch.where((counts > 0)[:, None], mean, centroids)
        err = (new_c - centroids).abs().amax()
        centroids = new_c
        it += 1
    labels, _, counts = assign(centroids)
    return KMeansResult(centroids, _all_gather(labels, group, size)[:n], counts,
                        torch.tensor(it, dtype=torch.int32, device=dev), err)
