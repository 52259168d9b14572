"""DBSCAN over event and point clouds (counterpart of
evflow_tpu/models/dbscan.py).

Clusters are the connected components of the eps-graph over core points
(at least core_min_pts points within eps, the point itself included);
a border point joins the lowest-numbered component among its core
neighbors. Components come from min-label propagation with pointer
jumping, a host loop that reads one flag per round, as the JAX package's
`lax.while_loop` runs while a label changed and fewer than max_iters
rounds ran. Sizes outside [min_cluster_size, max_cluster_size] are
filtered, then clusters are numbered by size, largest first, ties by the
lower root index.

`dbscan` tests eps-neighbourhoods by `ops.distance`'s matmul-free form:
core counts (`eps_counts`), then each propagation round and the border
attachment as a lowest core label within eps (`eps_min_label`). On the
card (D = 2 or 3: event pixels or point clouds) each is one launch of
csrc/dbscan_eps.cu over all rows, the same bits as the panels on any
float32 input; on the CPU, (block, N) distance panels. On integer pixel coordinates
every term is exact, so labels, core masks and iteration counts are the
same bits on the card, on the CPU and in JAX. `dbscan_grid` precomputes
the neighbor table with OPTICS' grid (`optics.grid_neighbors`) and
propagates over it; it takes the dense path where JAX does: no table, or a
row over the table's width.

`dbscan_slice` is app C on one slice of an event stream already on the
device: dense `dbscan` of the (x, y) pixels of its valid events,
duplicates kept, with each cluster's size and centroid. Its spans
(`utils/profiling.span`): `dbscan` per call, `dbscan.dense` the dense
pass, and `dbscan.round` each propagation round with its sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DBSCANConfig
from ..ops.distance import NO_LABEL, eps_counts, eps_min_label
from ..ops.segment import segment_mean_points
from ..utils.profiling import span
from . import optics

_MAX_NEIGHBORS = 256   # the grid table's width
_MAX_ITERS = 64        # propagation rounds at most
_FAR = 1e30   # invalid lanes are parked here: their distances overflow to inf or nan


class DBSCANResult(NamedTuple):
    labels: torch.Tensor        # int32 (N,) cluster id 0..k-1, -1 noise/filtered
    num_clusters: torch.Tensor  # int32 ()
    core_mask: torch.Tensor     # bool (N,)
    iterations: torch.Tensor    # int32 () propagation rounds used


def _propagate(labels, step, max_iters):
    """Min-label propagation over the cores with pointer jumping (each
    round's jump reads that round's labels), while a label changed and
    fewer than max_iters rounds ran. `step(labels)` is a round's
    where(core, min(labels, lowest core label within eps), labels).
    Returns (labels, rounds)."""
    n = labels.shape[0]
    it, changed = 0, True
    while changed and it < max_iters:
        with span("dbscan.round"):
            new = step(labels)
            jumped = torch.where(new < n, new[new.clamp(0, n - 1).long()], new)
            new = torch.minimum(new, jumped)
            changed = bool((new != labels).any())
        labels = new
        it += 1
    return labels, it


def _finish(labels, core, it, cfg: DBSCANConfig) -> DBSCANResult:
    """Component sizes, the size filter and the size-ordered numbering."""
    n = labels.shape[0]
    dev = labels.device
    member = labels < n
    seg = torch.where(member, labels, n).long()
    sizes = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, member.to(torch.int32))[:n]
    lab_c = labels.clamp(0, n - 1).long()
    size_of = torch.where(member, sizes[lab_c], 0)
    keep = member & (size_of >= cfg.min_cluster_size) & (size_of <= cfg.max_cluster_size)
    root_sizes = torch.where((sizes >= cfg.min_cluster_size)
                             & (sizes <= cfg.max_cluster_size), sizes, 0)
    order = torch.sort(-root_sizes, stable=True).indices
    rank = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
        0, order, torch.arange(n, dtype=torch.int32, device=dev))
    return DBSCANResult(labels=torch.where(keep, rank[lab_c], -1),
                        num_clusters=(root_sizes > 0).sum(dtype=torch.int32),
                        core_mask=core,
                        iterations=torch.full((), it, dtype=torch.int32, device=dev))


def dbscan(points: torch.Tensor, valid: torch.Tensor | None = None,
           cfg: DBSCANConfig = DBSCANConfig(), block: int = 2048,
           max_iters: int = 64) -> DBSCANResult:
    """(N, D) points -> cluster labels, on the points' device; invalid lanes
    get -1. On the card one kernel launch per pass, on the CPU (block, N)
    distance panels (`ops.distance`); `block` sizes the panels only."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    pts = torch.where(valid[:, None], points.to(torch.float32), _FAR)
    counts = eps_counts(pts, pts, cfg.eps, valid, valid, block)
    core = valid & (counts >= cfg.core_min_pts)
    labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=dev), NO_LABEL)

    def step(lab):
        return eps_min_label(pts, pts, cfg.eps, lab, core, lab, core, block)

    labels, it = _propagate(labels, step, max_iters)
    nmin = eps_min_label(pts, pts, cfg.eps, labels, core, block=block)
    labels = torch.where(core, labels, torch.where(valid, nmin, NO_LABEL))
    return _finish(labels, core, it, cfg)


def dbscan_grid(points: np.ndarray, cfg: DBSCANConfig = DBSCANConfig(),
                max_neighbors: int = _MAX_NEIGHBORS, max_iters: int = _MAX_ITERS,
                device="cuda") -> DBSCANResult:
    """DBSCAN of (N, D) numpy points over a grid-bucketed neighbor table
    (O(N 3^d B) once instead of O(N^2) per round), computed on `device`.
    Falls back to `dbscan` (at its default max_iters, as in JAX) when the
    grid does not apply or a neighborhood overflows the table: an
    overflowed row could drop an eps-edge and split a cluster."""
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    table = optics.grid_neighbors(pts, cfg.eps, cfg.core_min_pts, max_neighbors=max_neighbors)
    if table is None or bool((table.count > table.idx.shape[1]).any()):
        return dbscan(pts, cfg=cfg)
    return _dbscan_from_table(table.idx, table.count, cfg, max_iters)


class DBSCANSlice(NamedTuple):
    labels: torch.Tensor        # int32 (N,) cluster 0..k-1 by size, -1 noise/filtered/invalid
    core: torch.Tensor          # bool (N,)
    num_clusters: torch.Tensor  # int32 ()
    iterations: torch.Tensor    # int32 () propagation rounds used
    size: torch.Tensor          # int32 (K,) members of cluster k, 0 past num_clusters
    centroid: torch.Tensor      # float32 (K, 2) mean (x, y) of cluster k, 0 past num_clusters


def dbscan_slice(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                 cfg: DBSCANConfig = DBSCANConfig()) -> DBSCANSlice:
    """App C on one slice: dense DBSCAN of the (x, y) pixels of the valid
    events (labels bit-equal to dbscan_grid at its defaults on those
    pixels), on their device. Clusters are numbered by size and each holds
    at least min_cluster_size events, so K = N // min_cluster_size rows
    hold them all; sizes and float32 centroids by `ops.segment`."""
    n = x.shape[0]
    with span("dbscan"):
        pts = torch.stack([x, y], 1).to(torch.float32)
        with span("dbscan.dense"):
            res = dbscan(pts, valid, cfg)
        k = n // max(cfg.min_cluster_size, 1)
        centroid, size = segment_mean_points(pts, res.labels, k, res.labels >= 0)
    return DBSCANSlice(labels=res.labels, core=res.core_mask, num_clusters=res.num_clusters,
                       iterations=res.iterations, size=size, centroid=centroid)


def _dbscan_from_table(nbr_idx: torch.Tensor, counts: torch.Tensor,
                       cfg: DBSCANConfig, max_iters: int) -> DBSCANResult:
    """Propagation over an (N, K) neighbor table (-1 pads); eps-neighborhoods
    are symmetric, so a border point's row holds its core neighbors."""
    n = nbr_idx.shape[0]
    dev = nbr_idx.device
    core = counts >= cfg.core_min_pts
    valid_nbr = nbr_idx >= 0
    idx_c = nbr_idx.clamp(0, n - 1).long()
    labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=dev), NO_LABEL)

    def nmin_of(lab):
        src = torch.where(core, lab, NO_LABEL)
        return torch.where(valid_nbr, src[idx_c], NO_LABEL).amin(1)

    def step(lab):
        return torch.where(core, torch.minimum(lab, nmin_of(lab)), lab)

    labels, it = _propagate(labels, step, max_iters)
    labels = torch.where(core, labels, nmin_of(labels))
    return _finish(labels, core, it, cfg)
