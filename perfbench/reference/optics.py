"""Plain PyTorch reference of app B's OPTICS on each slice (`hd_optics_slice`).

App B (`optics-clustering/test/cluster_event_data.cpp:449-527`) on the (x, y)
pixels of a slice's valid events, duplicates kept, at the configuration's
min_pts, eps and reachability threshold:

- a point's neighbourhood is every point within eps, itself included:
  d = sqrt((x_i - x_j)^2 + (y_i - y_j)^2) in float32 over (block, N)
  panels, d <= eps; on integer pixels the sum is an exact integer and d its
  correctly rounded square root;
- a point's core distance is the min_pts-th smallest distance of its
  neighbourhood (optics.hpp:286-299), undefined (inf) below min_pts points;
- the sweep (optics.hpp:525-555): points are started in index order; a
  point taken is appended to the order, and if its core distance is
  defined, each unprocessed neighbour o is offered reach max(core(p),
  d(p, o)) (optics.hpp:315-337): inserted into an ordered set of
  (reach, index) if unreached, removed and inserted again if the offer is
  lower (decrease-key); the set's least element is taken next, until the
  set is empty; points never offered a reach are unreached (-1);
- the split (optics.hpp:674-690): a cluster starts at each point of the
  order whose reach is unreached or at least the threshold; clusters are
  numbered as they start;
- each cluster's size, mean x and y, and population variance of x and of
  y (:492-527), in float32: the mean from the exact sum, then the mean of
  the squared deviations from it (two passes).

Departures from optics.hpp, each where its behaviour is not the documented
one or depends on the container:
- optics.hpp fills neighbourhoods from a tree's radius search, in the
  tree's order; the set orders by (reach, index), so the order within a
  neighbourhood changes nothing, and none is kept here;
- distances, core distances and reach are float32 here, the
  configuration's precision (optics.hpp computes in its point type);
- app B prints each cluster's mean and variance from its points; here
  float32, where app B's are of its point type;
- points are the slice's event pixels, not app B's 10-frame CSV windows,
  and invalid lanes are no points.

Written from these rules alone: it imports nothing of the program, and its
ordered set is a sorted Python list (bisect), not a heap with stale
entries. It runs on the device it is given, float32, with TF32 off;
`control` rounds the coordinates to bfloat16, the precision below the
float32 the configuration states.
"""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch

BLOCK = 2048


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def neighbourhoods(pts: torch.Tensor, eps: float, min_pts: int):
    """Per point of (N, 2) float32 `pts` its neighbours within eps (itself
    included) as CSR on the host: (starts int64 (N + 1,), columns int64,
    distances float32), columns ascending in each row, and the core
    distances float32 (N,), inf below min_pts."""
    n = pts.shape[0]
    cols, dists, lens, core = [], [], [], []
    for i in range(0, n, BLOCK):
        diff = pts[i:i + BLOCK, None, :] - pts[None, :, :]
        d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
        within = d <= eps
        rows, c = torch.nonzero(within, as_tuple=True)
        cols.append(c.cpu())
        dists.append(d[rows, c].cpu())
        cnt = within.sum(1)
        lens.append(cnt.cpu())
        masked = torch.where(within, d, torch.inf)
        kth = torch.topk(masked, min(min_pts, n), 1, largest=False).values[:, -1]
        core.append(torch.where(cnt >= min_pts, kth, torch.inf).cpu())
    lens = torch.cat(lens).numpy() if lens else np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    cat = (lambda ts, dt: torch.cat(ts).numpy() if ts else np.zeros(0, dt))
    return (starts, cat(cols, np.int64), cat(dists, np.float32),
            cat(core, np.float32))


def sweep(starts, cols, dists, core):
    """The OPTICS sweep over a CSR table: (order int64 (N,), reach float32
    (N,), -1 where unreached)."""
    n = len(core)
    processed = np.zeros(n, bool)
    reach = np.full(n, -1.0, np.float32)
    order = []
    seeds = []   # the ordered set: (-reach, -index) ascending, its least at the end

    def update(p):
        lo, hi = starts[p], starts[p + 1]
        nbr = cols[lo:hi]
        free = ~processed[nbr]
        nbr = nbr[free]
        offer = np.maximum(core[p], dists[lo:hi][free])
        old = reach[nbr]
        better = (old < 0) | (offer < old)
        for o, r, was in zip(nbr[better].tolist(), offer[better].tolist(),
                             old[better].tolist()):
            if was >= 0:
                del seeds[bisect.bisect_left(seeds, (-was, -o))]
            bisect.insort(seeds, (-r, -o))
            reach[o] = r

    for start in range(n):
        if processed[start]:
            continue
        processed[start] = True
        order.append(start)
        if not math.isfinite(core[start]):
            continue
        update(start)
        while seeds:
            _, q = seeds.pop()
            q = -q
            processed[q] = True
            order.append(q)
            if math.isfinite(core[q]):
                update(q)
    return np.asarray(order, np.int64), reach


def cluster_slice(x, y, valid, cfg: dict, control: bool = False,
                  counts: dict | None = None) -> dict:
    """One slice, (N,) tensors on one device, as NumPy: order (N,) int32 (the
    valid lanes in reachability order, -1 pad), reach (N,) float32 (-1
    unreached or invalid), cluster (N,) int32 (-1 invalid), num_clusters,
    and size (N,) int32, centroid (N, 2) and variance (N, 2) float32 by
    cluster, 0 past num_clusters. `cfg` is the configuration file as a
    dict."""
    _no_tf32()
    op = cfg["optics"]
    min_pts, eps = int(op["min_pts"]), float(op["epsilon"])
    threshold = float(cfg["extraction"]["threshold"])
    n = x.shape[0]
    lanes = torch.nonzero(valid).flatten()
    pts = torch.stack([x[lanes], y[lanes]], 1).to(torch.float32)
    if control:
        pts = pts.to(torch.bfloat16).to(torch.float32)
    nv = pts.shape[0]
    starts, cols, dists, core = neighbourhoods(pts, eps, min_pts)
    order_v, reach_v = sweep(starts, cols, dists, core)

    r_seq = reach_v[order_v].astype(np.float64)
    begins = (r_seq < 0) | (r_seq >= threshold)
    cid = np.cumsum(begins) - 1
    cluster_v = np.empty(nv, np.int32)
    cluster_v[order_v] = cid
    k = int(begins.sum())
    pts_h = pts.cpu().numpy()
    size = np.zeros(n, np.int32)
    size[:k] = np.bincount(cluster_v, minlength=k)
    total = np.zeros((n, 2), np.float64)
    np.add.at(total, cluster_v, pts_h.astype(np.float64))
    centroid = np.zeros((n, 2), np.float32)
    centroid[:k] = total[:k].astype(np.float32) / size[:k, None].astype(np.float32)
    dev = pts_h - centroid[cluster_v]
    sq = np.zeros((n, 2), np.float32)
    np.add.at(sq, cluster_v, dev * dev)
    variance = np.zeros((n, 2), np.float32)
    variance[:k] = sq[:k] / size[:k, None].astype(np.float32)

    lanes_h = lanes.cpu().numpy()
    order = np.full(n, -1, np.int32)
    order[:nv] = lanes_h[order_v]
    reach = np.full(n, -1.0, np.float32)
    reach[lanes_h] = reach_v
    cluster = np.full(n, -1, np.int32)
    cluster[lanes_h] = cluster_v
    if counts is not None:
        lens = np.diff(starts)
        counts.setdefault("points", []).append(nv)
        counts.setdefault("mean_neighbourhood", []).append(float(lens.mean()) if nv else 0.0)
        counts.setdefault("largest_neighbourhood", []).append(int(lens.max()) if nv else 0)
        counts.setdefault("core_points", []).append(int(np.isfinite(core).sum()))
        counts.setdefault("table_entries", []).append(int(lens.sum()))
        counts.setdefault("clusters", []).append(k)
        counts.setdefault("clusters_2_or_more", []).append(int((size >= 2).sum()))
        counts.setdefault("clusters_100_or_more", []).append(int((size >= 100).sum()))
    return {"order": order, "reach": reach, "cluster": cluster, "num_clusters": np.int32(k),
            "size": size, "centroid": centroid, "variance": variance}
