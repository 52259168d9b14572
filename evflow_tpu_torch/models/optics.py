"""OPTICS' grid-bucketed eps-neighborhoods (counterpart of the grid path of
evflow_tpu/models/optics.py): `NeighborTable` and `compute_neighbors_grid`,
which `dbscan.dbscan_grid` uses. The rest of OPTICS (the dense, certified
and cell-pair neighbor backends, reachability, the xi extraction) is not
ported yet (ROADMAP.md).

The grid has cells eps wide, so every eps-neighborhood lies in the 3^g
cells around the query's cell. The bucket size comes from the true largest
cell occupancy, counted on the host, so nothing is dropped: the neighbor
sets are exact. Distances use the exact difference form over all d
coordinates, even where the grid covers only the first g.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class NeighborTable(NamedTuple):
    idx: torch.Tensor        # int32 (N, K) neighbor indices (self included), -1 pad
    dist: torch.Tensor       # float32 (N, K) distances (inf pad)
    count: torch.Tensor      # int32 (N,) true eps-neighborhood size (uncapped)
    core_dist: torch.Tensor  # float32 (N,) min_pts-th distance, inf if undefined


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 1).bit_length()


def _grid_table(pts: torch.Tensor, mins: torch.Tensor, eps: torch.Tensor, dims,
                bucket: int, min_pts: int, block: int, select_k: int):
    """The device half of compute_neighbors_grid: cell ids, each point's
    rank in its cell (a stable sort), the bucket table of coordinates and
    indices, then per block of rows the 3^g windows' distances, masked at
    eps, selected (select_k > 0: the select_k nearest, sorted stably by
    distance) or kept whole (select_k == 0)."""
    n, d = pts.shape
    dev = pts.device
    g = len(dims)
    ncells = int(np.prod(dims))
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    strides = torch.tensor([int(np.prod(dims[j + 1:])) for j in range(g)],
                           dtype=torch.int64, device=dev)
    cell_coord = torch.floor((pts[:, :g] - mins[None, :g]) / eps).to(torch.int64)
    cell_coord = torch.minimum(torch.clamp_min(cell_coord, 0), dims_t - 1)
    cell_id = (cell_coord * strides).sum(1)
    offs = torch.tensor(np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * g), indexing="ij"),
                                 axis=-1).reshape(-1, g), dtype=torch.int64, device=dev)
    noff = offs.shape[0]
    nbr_coord = cell_coord[:, None, :] + offs[None]
    in_grid = ((nbr_coord >= 0) & (nbr_coord < dims_t)).all(-1)
    nbr_cells = torch.where(in_grid, (nbr_coord * strides).sum(-1), ncells)
    m = noff * bucket

    # rank of each point within its cell, in index order
    sc, sl = torch.sort(cell_id, stable=True)
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sc[1:] != sc[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev).scatter_(0, sl, pos - run_start)

    # bucket table, one row per cell: [x | y (| z ..) | index as f32], each
    # bucket wide; row ncells is the out-of-grid pad (inf coords, -1 index)
    width = (d + 1) * bucket
    base = cell_id * width + rank
    tab = torch.full(((ncells + 1) * width,), torch.inf, dtype=torch.float32, device=dev)
    for j in range(d):
        tab[base + j * bucket] = pts[:, j]
    tab[base + d * bucket] = pos.to(torch.float32)
    tab = tab.view(ncells + 1, width)
    tab[ncells, d * bucket:] = -1.0

    out_k = select_k if select_k else m
    idx = torch.empty((n, out_k), dtype=torch.int32, device=dev)
    dist_out = torch.empty((n, out_k), dtype=torch.float32, device=dev)
    cnt_out = torch.empty(n, dtype=torch.int32, device=dev)
    core_out = torch.empty(n, dtype=torch.float32, device=dev)
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    for i in range(0, n, block):
        rows_pts = pts[i:i + block]
        b = rows_pts.shape[0]
        rows = tab[nbr_cells[i:i + block]].view(b, noff, d + 1, bucket)
        d2 = torch.zeros((b, noff, bucket), dtype=torch.float32, device=dev)
        for j in range(d):
            dj = rows[:, :, j, :] - rows_pts[:, j, None, None]
            d2 = d2 + dj * dj
        dist = torch.sqrt(d2).reshape(b, m)
        ci = rows[:, :, d, :].reshape(b, m).to(torch.int32)
        ok = (ci >= 0) & (dist <= eps)
        dist = torch.where(ok, dist, inf)
        ci = torch.where(ok, ci, -1)
        cnt = ok.sum(1, dtype=torch.int32)
        if select_k:
            sd, perm = torch.sort(dist, dim=1, stable=True)
            sd = sd[:, :select_k]
            si = torch.where(torch.isfinite(sd), ci.gather(1, perm[:, :select_k]), -1)
            core = sd[:, min_pts - 1] if min_pts <= select_k else inf.expand(b)
        else:
            sd, si = dist, ci
            core = (torch.topk(dist, min_pts, 1, largest=False).values[:, min_pts - 1]
                    if min_pts <= m else inf.expand(b))
        idx[i:i + b] = si
        dist_out[i:i + b] = sd
        cnt_out[i:i + b] = cnt
        core_out[i:i + b] = torch.where(cnt >= min_pts, core, inf)
    return idx, dist_out, cnt_out, core_out


def compute_neighbors_grid(points: np.ndarray, eps: float, min_pts: int,
                           max_neighbors: int = 256, block: int = 4096,
                           max_bucket: int = 1024,
                           max_cells: int = 1 << 22,
                           approx: bool = False,
                           allow_projected: bool = False,
                           full_window: bool = False,
                           full_window_entry_cap: int = 192 << 20,
                           proj_dims: int = 3,
                           device="cuda") -> Optional[NeighborTable]:
    """Grid-bucketed eps-neighborhoods of (N, d) numpy points, computed on
    `device`; None where the grid does not apply, and the caller takes the
    dense path: no points, d > 4 without allow_projected, more than
    max_cells cells, a cell over max_bucket points, a table too large for
    int32 indices or out of proportion to N, or (selection needed) min_pts
    above max_neighbors. d <= 4: a grid over all d coordinates; d > 4 with
    allow_projected: over the first min(proj_dims, 4).

    Rows hold the whole masked 3^g * bucket window, unsorted, when it fits
    max_neighbors, or with full_window (unless n * window exceeds
    full_window_entry_cap); otherwise the min(max(max_neighbors, min_pts),
    N) nearest, sorted by distance, ties in window order. `approx` is
    accepted for the JAX signature and ignored, as it is on JAX's grid
    path."""
    pts_np = np.asarray(points, dtype=np.float32)
    pts = torch.as_tensor(pts_np, device=device)
    n, d = pts_np.shape
    if n == 0 or (d > 4 and not allow_projected):
        return None
    g = min(d, 4) if d <= 4 else min(proj_dims, 4)
    # fp32 on the host as on the device, so a point on a cell edge is
    # counted in the cell the device puts it in
    mins = pts_np.min(axis=0)
    cell_coord = np.floor((pts_np[:, :g] - mins[None, :g])
                          / np.float32(eps)).astype(np.int64)
    dims = cell_coord.max(axis=0) + 1
    ncells = int(np.prod(dims))
    if ncells > max_cells:
        return None
    cell_id = np.ravel_multi_index(cell_coord.T, dims)
    bucket = _next_pow2(int(np.bincount(cell_id, minlength=ncells).max()))
    if bucket > max_bucket:
        return None
    if (ncells + 1) * (d + 1) * bucket >= 2**31 - 1:
        return None
    if ncells * bucket > max(32 * n, 1 << 20):
        return None
    m = (3 ** g) * bucket
    if full_window and n * m <= full_window_entry_cap:
        select_k = 0
    else:
        if m > max_neighbors and min_pts > max_neighbors:
            return None
        select_k = 0 if m <= max_neighbors else min(max(max_neighbors, min_pts), n)
    table = _grid_table(pts, torch.as_tensor(mins, device=pts.device),
                        torch.tensor(eps, dtype=torch.float32, device=pts.device),
                        tuple(int(v) for v in dims), bucket, min_pts, block, select_k)
    return NeighborTable(*table)
