"""OPTICS reachability clustering, app B (counterpart of
evflow_tpu/models/optics.py): eps-neighborhoods computed on the device,
then the sequential sweep on the host, then cluster extraction.

Reference: event-cam-clustering/optics-clustering/include/optics/optics.hpp.
It precomputes every eps-neighborhood (hpp:441-520), then runs the OPTICS
sweep with a priority queue ordered by (reach_dist, point_index)
(hpp:525-555, comparator hpp:67-69). The split is kept:

  - neighbor tables on `device` ("cuda" by default): the dense (block, N)
    panels (`compute_neighbors`), the grid of eps-wide cells
    (`compute_neighbors_grid`) and its gather-free cell-pair form
    (`compute_neighbors_cellpair`); method "sharded" splits the dense
    table's rows over a process group's ranks (parallel/batch.py);
  - core distance: the distance to the min_pts-th element of the inclusive
    eps-neighborhood (hpp:286-299);
  - the sweep: the host C++ of `native/optics_sweep.cpp`, or the Python
    heap loop it copies, over the table moved to the host once;
  - eps estimation from the bounding-box volume and the unit-ball volume
    (hpp:369-387);
  - extraction: the reachability threshold split (hpp:674-690) and the xi
    steep-area method with its cluster tree (hpp:814-995);
  - app B on one slice of a stream already on the device (`optics_slice`):
    K sized exactly on the device, one table, one copy to the host, the
    native sweep, the split and each cluster's statistics back on the
    device, under the spans `optics`, `optics.table`, `optics.sweep` and
    `optics.extract`.

`build_table` is the one choice among the table builders, made on the
device, that `neighbor_table` and `optics_slice` share.

Selection of the K nearest follows `lax.top_k`: ascending distance, ties
to the lower column. Every float distance is fp32 and no matmul computes
one, so no TF32 setting can reach it.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import OpticsConfig
from ..ops.distance import eps_counts
from ..ops.segment import masked_segment_sum, segment_mean_points
from ..utils.profiling import span


# --------------------------------------------------------------------------
# eps estimation (optics.hpp:369-387)
# --------------------------------------------------------------------------

def epsilon_estimation(points: np.ndarray, min_pts: int) -> float:
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n <= 1:
        return 0.0
    return _estimate_eps(points.min(axis=0), points.max(axis=0), n, min_pts)


def _estimate_eps(bl: np.ndarray, tr: np.ndarray, n: int, min_pts: int) -> float:
    """epsilon_estimation from the bounding box's corners and the count."""
    d = len(bl)
    ext = np.abs(tr - bl)
    volume = float(np.prod(ext)) if d <= 64 else np.inf
    # the direct formula overflows float64 at high d (extent^d at d = 128,
    # math.gamma(d/2+1) at d >= 340): evaluate the same formula in log
    # space there; the direct form stays where the reference's own vectors
    # validate it to 6 decimals
    if d <= 64 and np.isfinite(volume) and volume > 0.0:
        space_per = (volume / n) * min_pts
        unit_ball = math.sqrt(math.pi ** d) / math.gamma(d / 2.0 + 1.0)
        return (space_per / unit_ball) ** (1.0 / d)
    if np.any(ext <= 0.0):
        return 0.0
    log_space_per = float(np.sum(np.log(ext))) - math.log(n) + math.log(min_pts)
    log_unit_ball = 0.5 * d * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)
    return math.exp((log_space_per - log_unit_ball) / d)


# --------------------------------------------------------------------------
# eps-neighborhood tables
# --------------------------------------------------------------------------

class NeighborTable(NamedTuple):
    idx: torch.Tensor        # int32 (N, K) neighbor indices (self included), -1 pad
    dist: torch.Tensor       # float32 (N, K) distances (inf pad)
    count: torch.Tensor      # int32 (N,) true eps-neighborhood size (uncapped)
    core_dist: torch.Tensor  # float32 (N,) min_pts-th distance, inf if undefined


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 1).bit_length()


def k_cap(n: int, k: int) -> int:
    """The widest table of n rows that OPTICS builds, from a width of k:
    the (N, K) memory bound, at most 256M entries and K <= 1024."""
    return max(k, min(1024, (256 << 20) // max(n, 1)))


def _nearest(dist: torch.Tensor, k: int):
    """The k smallest of each row of non-negative float32 `dist` (inf for
    none), ascending, ties to the lower column, as `lax.top_k` orders them:
    (values, int64 columns). Each entry becomes one int64 key, the
    distance's bits above its column, so every key is unique and the order
    does not depend on how `topk` breaks ties."""
    cols = torch.arange(dist.shape[1], dtype=torch.int64, device=dist.device)
    key = (dist.view(torch.int32).to(torch.int64) << 32) | cols
    top = torch.topk(key, k, dim=1, largest=False).values
    return (top >> 32).to(torch.int32).view(torch.float32), top & 0xFFFFFFFF


def _dense_table(pts: torch.Tensor, eps: torch.Tensor, k: int, block: int, min_pts: int):
    """The device half of the dense tables: per (block, N) panel the
    distances, masked at eps, and the k nearest. The distances are the sum
    over d of (a - b)^2, which has no cancellation: JAX's dense panel
    |a|^2 + |b|^2 - 2ab takes its cross term from a matmul, whose bits no
    elementwise form reproduces, and the difference form is the more
    accurate of the two (JAX's certified gate and its two-stage refine)."""
    return _dense_rows(pts, pts, eps, k, block, min_pts)


def _dense_rows(rows_all: torch.Tensor, pts: torch.Tensor, eps: torch.Tensor, k: int,
                block: int, min_pts: int):
    """`_dense_table`'s rows for the query points `rows_all` against all of
    `pts`: each row's entries depend on that row alone, so a row block
    (parallel/batch.py) gets the bits of the whole table's rows."""
    n, d = rows_all.shape
    dev = pts.device
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    for i in range(0, n, block):
        rows = rows_all[i:i + block]
        d2 = None
        for j in range(d):
            dj = rows[:, j, None] - pts[None, :, j]
            d2 = dj * dj if d2 is None else d2 + dj * dj
        dd = torch.sqrt(d2)
        within = dd <= eps
        topd, cols = _nearest(torch.where(within, dd, torch.inf), k)
        idx[i:i + block] = torch.where(torch.isfinite(topd), cols.to(torch.int32), -1)
        dist[i:i + block] = topd
        cnt[i:i + block] = within.sum(1, dtype=torch.int32)
    core = dist[:, min_pts - 1] if min_pts <= k else torch.full((n,), torch.inf, device=dev)
    return idx, dist, cnt, torch.where(cnt >= min_pts, core, torch.inf)


def _dense(points, eps, min_pts, max_neighbors, block, device) -> NeighborTable:
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    k = min(max_neighbors, pts.shape[0])
    eps_t = torch.tensor(eps, dtype=torch.float32, device=pts.device)
    return NeighborTable(*_dense_table(pts, eps_t, k, block, min_pts))


def compute_neighbors(points: np.ndarray, eps: float, min_pts: int,
                      max_neighbors: int = 256, block: int = 2048,
                      approx: bool = False, device="cuda") -> NeighborTable:
    """All eps-neighborhoods and core distances of (N, d) numpy points,
    computed on `device` over (block, N) panels of difference-form
    distances (`_dense_table`). Each row keeps the nearest K =
    min(max_neighbors, N), sorted by distance, ties to the lower index;
    `count` is still the true size. `approx` selects JAX's approximate
    top-k (`lax.approx_max_k`), a TPU primitive with no counterpart here:
    the selection is exact either way."""
    return _dense(points, eps, min_pts, max_neighbors, block, device)


def compute_neighbors_2stage(points: np.ndarray, eps: float, min_pts: int,
                             max_neighbors: int = 256, block: int = 2048,
                             approx: bool = False, device="cuda") -> NeighborTable:
    """JAX's two-stage dense table ("dense2"): a bf16 matmul panel culls,
    then the survivors get difference-form distances. It exists because
    TPU dots with bf16 inputs accumulate at about 2^-6.5 relative error
    (the JAX module's measurement), so an accurate fp32 panel is slow
    there. Here it is the
    exact dense table (`_dense_table`), whose distances are already in
    difference form, so JAX's contract holds with equality where JAX has a
    bound: the same neighbor sets as the dense table, `count` the true
    count (JAX's is no less), and the difference form's core distances."""
    return _dense(points, eps, min_pts, max_neighbors, block, device)


def compute_neighbors_certified(points: np.ndarray, eps: float, min_pts: int,
                                max_neighbors: int = 256, block: int = 2048,
                                recall_target: float = 0.95,
                                straggler_block: int = 512,
                                sort_block: int = 512,
                                gate: str = "diff",
                                _stats: Optional[dict] = None,
                                _force_fallback: bool = False,
                                _force_retry: bool = False,
                                device="cuda") -> NeighborTable:
    """JAX's count-certified table: approximate top-k (`lax.approx_max_k`,
    which drops entries on the TPU) over difference-form distances, with a
    per-row certificate and exact re-selection of the rows it rejects. The
    certificate, its retry and its fallback repair the TPU's approximate
    selection; the exact selection needs none. So this is the exact dense
    table (`_dense_table`): the sets of the dense table, counts equal to
    the true counts, and rows past K holding the exact nearest K, which a
    panel form |a|^2 + |b|^2 - 2ab cannot promise in a tight cluster far
    from the origin (its cancellation error). The other arguments, JAX's
    tuning knobs and test hooks, are accepted and ignored."""
    return _dense(points, eps, min_pts, max_neighbors, block, device)


# --------------------------------------------------------------------------
# Grid-bucketed eps-neighborhoods: O(N * 3^d * B) instead of O(N^2)
# --------------------------------------------------------------------------
#
# The reference speeds neighbor queries up with kd-tree and R*-tree
# backends (optics.hpp:409-410, 441-520). The device's counterpart is a
# grid with cells eps wide: every eps-neighborhood lies in the 3^d cells
# around the query's cell. The bucket size comes from the true largest cell
# occupancy, counted on the device and read back (`grid_neighbors`), so nothing
# is dropped: the neighbor sets are exact. Distances use the exact
# difference form over all d coordinates, even where the grid covers only
# the first g.

def _grid_table(pts: torch.Tensor, cell_coord: torch.Tensor, cell_id: torch.Tensor,
                rank: torch.Tensor, dims_t: torch.Tensor, strides: torch.Tensor,
                eps: torch.Tensor, dims, bucket: int, min_pts: int, block: int,
                select_k: int):
    """The device half of grid_neighbors, from its cell coordinates, cell
    ids and ranks in cell: the bucket table of coordinates and indices,
    then per block of rows the 3^g windows' distances, masked at eps,
    selected (select_k > 0: the select_k nearest, sorted stably by
    distance) or kept whole (select_k == 0)."""
    n, d = pts.shape
    dev = pts.device
    g = len(dims)
    ncells = math.prod(dims)
    offs = torch.tensor(np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * g), indexing="ij"),
                                 axis=-1).reshape(-1, g), dtype=torch.int64, device=dev)
    noff = offs.shape[0]
    nbr_coord = cell_coord[:, None, :] + offs[None]
    in_grid = ((nbr_coord >= 0) & (nbr_coord < dims_t)).all(-1)
    nbr_cells = torch.where(in_grid, (nbr_coord * strides).sum(-1), ncells)
    m = noff * bucket
    pos = torch.arange(n, device=dev)

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


def _rank_in_cell(cell_id: torch.Tensor):
    """Each point's rank among the points of its cell, in index order (a
    stable sort), and the point indices 0..N-1."""
    n = cell_id.shape[0]
    sc, sl = torch.sort(cell_id, stable=True)
    pos = torch.arange(n, device=cell_id.device)
    first = torch.ones(n, dtype=torch.bool, device=cell_id.device)
    first[1:] = sc[1:] != sc[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    return torch.empty_like(pos).scatter_(0, sl, pos - run_start), pos


class Cells(NamedTuple):
    """The eps-wide cells of the first g coordinates of (N, d) device
    points: per point its cell coordinate, id and rank in cell (tensors),
    and the grid's extent and largest occupancy read back to the host."""
    cell: torch.Tensor      # int64 (N, g) floor((p - min) / eps) in fp32
    dims_t: torch.Tensor    # int64 (g,) cells per coordinate
    strides: torch.Tensor   # int64 (g,) row-major strides of the cell id
    cell_id: torch.Tensor   # int64 (N,)
    rank: torch.Tensor      # int64 (N,) rank in cell, in index order
    dims: tuple             # host ints (g,)
    occupancy: int          # host int: the fullest cell's point count


def grid_cells(pts: torch.Tensor, eps_t: torch.Tensor, g: int) -> Cells:
    """The cells that the grid and cell-pair tables bucket by, decided on
    the device: the g extents and the largest occupancy come back as g + 1
    integers in one copy, and the points stay where they are."""
    mins = pts.amin(0)
    cell = torch.floor((pts[:, :g] - mins[None, :g]) / eps_t).to(torch.int64)
    dims_t = cell.amax(0) + 1
    rev = torch.cumprod(torch.flip(dims_t, (0,)), 0)
    strides = torch.cat([torch.flip(rev, (0,))[1:], torch.ones_like(rev[:1])])
    cell_id = (cell * strides).sum(1)
    rank, _ = _rank_in_cell(cell_id)
    head = torch.cat([dims_t, rank.amax()[None] + 1]).tolist()
    return Cells(cell, dims_t, strides, cell_id, rank, tuple(head[:g]), head[g])


def grid_neighbors(pts: torch.Tensor, eps: float, min_pts: int, max_neighbors: int = 256,
                   block: int = 4096, max_bucket: int = 1024, max_cells: int = 1 << 22,
                   allow_projected: bool = False, full_window: bool = False,
                   full_window_entry_cap: int = 192 << 20,
                   proj_dims: int = 3, cells: Optional[Cells] = None) -> Optional[NeighborTable]:
    """compute_neighbors_grid on (N, d) device points, or None where the
    grid does not apply. The decision is made on the device (`grid_cells`,
    or `cells` where the caller has them for the same g): one read-back
    of g + 1 integers, and the points stay where they are."""
    n, d = pts.shape
    if n == 0 or (d > 4 and not allow_projected):
        return None
    g = min(d, 4) if d <= 4 else min(proj_dims, 4)
    eps_t = torch.full((), eps, dtype=torch.float32, device=pts.device)
    if cells is None or len(cells.dims) != g:
        cells = grid_cells(pts, eps_t, g)
    dims = cells.dims
    ncells = math.prod(dims)
    if ncells > max_cells or min(dims) < 1:
        return None
    bucket = _next_pow2(cells.occupancy)
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
    return NeighborTable(*_grid_table(pts, cells.cell, cells.cell_id, cells.rank, cells.dims_t,
                                      cells.strides, eps_t, dims, bucket, min_pts, block,
                                      select_k))


def compute_neighbors_grid(points: np.ndarray, eps: float, min_pts: int, *,
                           approx: bool = False, device="cuda",
                           **kw) -> Optional[NeighborTable]:
    """Grid-bucketed eps-neighborhoods of (N, d) numpy points, computed on
    `device` (`grid_neighbors`, whose limits `kw` are); None where the grid
    does not apply, and the caller takes the dense path: no points, d > 4
    without allow_projected, more than max_cells cells, a cell over
    max_bucket points, a table too large for int32 indices or out of
    proportion to N, or (selection needed) min_pts above max_neighbors.
    d <= 4: a grid over all d coordinates; d > 4 with allow_projected: over
    the first min(proj_dims, 4).

    Rows hold the whole masked 3^g * bucket window, unsorted, when it fits
    max_neighbors (256), or with full_window (unless n * window exceeds
    full_window_entry_cap); otherwise the min(max(max_neighbors, min_pts),
    N) nearest, sorted by distance, ties in window order. `approx` is
    accepted for the JAX signature and ignored, as it is on JAX's grid
    path."""
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    return grid_neighbors(pts, eps, min_pts, **kw)


# --------------------------------------------------------------------------
# Cell-pair eps-neighborhoods: the grid with no per-row gather
# --------------------------------------------------------------------------
#
# The grid path above gathers 3^d bucket rows per point. This form keeps
# the bucket table ON the grid with a one-cell halo, so each cell's 3^d
# neighbor windows are static slices of the padded grid, and computes one
# (bucket, 3^d * bucket) distance panel per cell, in blocks of cells. The
# results live in slot space (cell * bucket + rank) and one row gather at
# the end puts them in point order. A row of the whole window lists its
# candidates window by window in `offs` order, then by slot.

def _cellpair_table(pts: torch.Tensor, mins: torch.Tensor, eps: torch.Tensor, dims,
                    bucket: int, min_pts: int, cellblock: int, select_k: int):
    """The device half of compute_neighbors_cellpair."""
    n, d = pts.shape
    dev = pts.device
    ncells = int(np.prod(dims))
    b = bucket
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    strides = torch.tensor([int(np.prod(dims[j + 1:])) for j in range(d)],
                           dtype=torch.int64, device=dev)
    cell_coord = torch.floor((pts - mins[None, :]) / eps).to(torch.int64)
    cell_coord = torch.minimum(torch.clamp_min(cell_coord, 0), dims_t - 1)
    cell_id = (cell_coord * strides).sum(1)
    rank, lane = _rank_in_cell(cell_id)

    # slot tables, with a one-cell halo per spatial dim: coords (inf pad)
    # and point indices (-1 pad)
    base = cell_id * b + rank
    gc = torch.full(tuple(int(v) + 2 for v in dims) + (b, d), torch.inf,
                    dtype=torch.float32, device=dev)
    gi = torch.full(tuple(int(v) + 2 for v in dims) + (b,), -1, dtype=torch.int32, device=dev)
    interior = tuple(slice(1, 1 + int(v)) for v in dims)
    own_c = torch.full((ncells * b, d), torch.inf, dtype=torch.float32, device=dev)
    own_c[base] = pts
    own_i = torch.full((ncells * b,), -1, dtype=torch.int32, device=dev)
    own_i[base] = lane.to(torch.int32)
    gc[interior] = own_c.view(*dims, b, d)
    gi[interior] = own_i.view(*dims, b)

    # the 3^d neighbor windows, static slices of the padded grid
    offs = np.stack(np.meshgrid(*([np.array([0, 1, 2])] * d), indexing="ij"),
                    axis=-1).reshape(-1, d)
    m = offs.shape[0] * b

    def window(o):
        return tuple(slice(int(o[j]), int(o[j]) + int(dims[j])) for j in range(d))

    cand_c = torch.stack([gc[window(o)].reshape(ncells, b, d) for o in offs], 1)
    cand_c = cand_c.reshape(ncells, m, d)
    cand_i = torch.stack([gi[window(o)].reshape(ncells, b) for o in offs], 1).reshape(ncells, m)
    own_c = own_c.view(ncells, b, d)

    out_k = select_k if select_k else m
    idx_s = torch.empty((ncells * b, out_k), dtype=torch.int32, device=dev)
    dist_s = torch.empty((ncells * b, out_k), dtype=torch.float32, device=dev)
    cnt_s = torch.empty(ncells * b, dtype=torch.int32, device=dev)
    core_s = torch.empty(ncells * b, dtype=torch.float32, device=dev)
    for c0 in range(0, ncells, cellblock):
        blk = slice(c0, c0 + cellblock)
        oc, cc, ci = own_c[blk], cand_c[blk], cand_i[blk]
        rows = oc.shape[0] * b
        d2 = None
        for j in range(d):
            dj = oc[:, :, None, j] - cc[:, None, :, j]
            d2 = dj * dj if d2 is None else d2 + dj * dj
        dist = torch.sqrt(d2)
        ok = (ci[:, None, :] >= 0) & (dist <= eps)
        dist = torch.where(ok, dist, torch.inf).reshape(rows, m)
        civ = torch.where(ok, ci[:, None, :], -1).reshape(rows, m)
        cnt = ok.sum(2, dtype=torch.int32).reshape(rows)
        if select_k:
            sd, posk = _nearest(dist, select_k)
            si = torch.where(torch.isfinite(sd), civ.gather(1, posk), -1)
            core = sd[:, min_pts - 1] if min_pts <= select_k else None
        else:
            sd, si = dist, civ
            core = (torch.topk(dist, min_pts, 1, largest=False).values[:, min_pts - 1]
                    if min_pts <= m else None)
        s = slice(c0 * b, c0 * b + rows)
        idx_s[s] = si
        dist_s[s] = sd
        cnt_s[s] = cnt
        core_s[s] = torch.inf if core is None else torch.where(cnt >= min_pts, core, torch.inf)
    return idx_s[base], dist_s[base], cnt_s[base], core_s[base]


def cellpair_neighbors(pts: torch.Tensor, eps: float, min_pts: int,
                       max_neighbors: int = 256, max_bucket: int = 1024,
                       max_cells: int = 1 << 22, cellblock: int = 1024,
                       cells: Optional[Cells] = None) -> Optional[NeighborTable]:
    """compute_neighbors_cellpair on (N, d) float32 device points, or None
    where it does not apply. The decision is made on the device
    (`grid_cells`, or `cells` where the caller has them for g = d)."""
    n, d = pts.shape
    if d > 4 or n == 0:
        return None
    eps_t = torch.full((), eps, dtype=torch.float32, device=pts.device)
    if cells is None or len(cells.dims) != d:
        cells = grid_cells(pts, eps_t, d)
    dims = cells.dims
    ncells = math.prod(dims)
    if ncells > max_cells or min(dims) < 1:
        return None
    bucket = _next_pow2(cells.occupancy)
    if bucket > max_bucket:
        return None
    m = (3 ** d) * bucket
    # slot space: candidates are (ncells, 3^d * B, d + 1) words and the
    # whole-window table (ncells * B, K)
    if ncells * bucket > max(32 * n, 1 << 20):
        return None
    if ncells * m * (d + 1) * 4 > 1 << 31:
        return None
    if m > max_neighbors and min_pts > max_neighbors:
        return None
    select_k = 0 if m <= 4 * max_neighbors else min(max(max_neighbors, min_pts), n)
    if (not select_k) and ncells * bucket * m * 8 > 1 << 32:
        select_k = min(max(max_neighbors, min_pts), n)
    if select_k > 256:
        # JAX declines here (top_k past ~256 on wide rows is a TPU
        # pathology); the grid and dense paths serve such configurations
        return None
    # each block of cells holds a (cellblock, B, m) fp32 panel: at most
    # 256 MiB, by fewer cells per block, and no block below 8 cells
    panel_bytes = cellblock * bucket * m * 4
    if panel_bytes > 1 << 28:
        cellblock = max((1 << 28) // (bucket * m * 4), 1)
        if cellblock < 8:
            return None
    table = _cellpair_table(pts, pts.amin(0), eps_t, tuple(int(v) for v in dims), bucket,
                            min_pts, cellblock, select_k)
    return NeighborTable(*table)


def compute_neighbors_cellpair(points: np.ndarray, eps: float, min_pts: int,
                               max_neighbors: int = 256,
                               max_bucket: int = 1024,
                               max_cells: int = 1 << 22,
                               cellblock: int = 1024,
                               device="cuda") -> Optional[NeighborTable]:
    """Cell-pair eps-neighborhoods (see the block comment) of (N, d) numpy
    points, computed on `device` (`cellpair_neighbors`): the grid path's
    exact neighbor sets and guards, with None where it does not apply
    (d > 4, no points, too many cells, an over-full cell, a slot space out
    of proportion to N or over 2 GiB of candidates, min_pts above
    max_neighbors where selection is needed, a selection wider than 256,
    or a panel that fits no block of 8 cells); the caller falls back. Rows
    hold the whole masked window when it is at most 4 * max_neighbors wide
    (and its table at most 4 GiB), else the min(max(max_neighbors,
    min_pts), N) nearest, sorted."""
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    return cellpair_neighbors(pts, eps, min_pts, max_neighbors, max_bucket, max_cells,
                              cellblock)


def build_table(pts: torch.Tensor, eps: float, min_pts: int, max_neighbors: int = 256,
                block: int = 2048, method: str = "auto", full_window: bool = False,
                proj_dims: int = 3) -> NeighborTable:
    """The one choice of table builder for (N, d) float32 points on their
    device, made there: "cellpair" (auto at d <= 2), then "grid" (auto up
    to d = 4; forced, the projected grid beyond), each with its own guards
    and falling through where it declines (a forced one raises
    ValueError), else the dense (block, N) panels, whose rows keep the
    min(max_neighbors, N) nearest. The cell-pair and grid guards read one
    set of cells back, once."""
    n, d = pts.shape
    eps_t = torch.full((), eps, dtype=torch.float32, device=pts.device)
    table, cells = None, None
    if method == "cellpair" or (method == "auto" and d <= 2):
        if n and d <= 4:
            cells = grid_cells(pts, eps_t, d)
        table = cellpair_neighbors(pts, eps, min_pts, max_neighbors=max_neighbors, cells=cells)
        if table is None and method == "cellpair":
            raise ValueError("cell-pair neighbor search does not apply "
                             "(dim > 4, degenerate grid, or over-dense cells)")
    if table is None and method in ("auto", "grid"):
        table = grid_neighbors(pts, eps, min_pts, max_neighbors=max_neighbors,
                               full_window=full_window, allow_projected=(method == "grid"),
                               proj_dims=proj_dims, cells=cells)
        if table is None and method == "grid":
            raise ValueError("grid neighbor search does not apply "
                             "(degenerate grid or over-dense cells)")
    # "dense", "dense2", "certified", and "auto" where the grids decline
    # (JAX's certified from 32768 points): one exact dense table
    if table is None:
        table = NeighborTable(*_dense_table(pts, eps_t, min(max_neighbors, n), block, min_pts))
    return table


# --------------------------------------------------------------------------
# Host sweep (optics.hpp:525-565)
# --------------------------------------------------------------------------

class ReachabilityDist(NamedTuple):
    point_index: int
    reach_dist: float


def neighbor_table(points: np.ndarray, min_pts: int, epsilon: float,
                   max_neighbors: int = 256, block: int = 2048,
                   approx: bool = False, method: str = "auto",
                   full_window: bool = False, proj_dims: int = 3,
                   device="cuda") -> NeighborTable:
    """The table compute_reachability_dists sweeps, on `device`: built by
    `method`, then built once more with K raised where a neighborhood
    overflowed it (see there)."""
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    pts = (None if method == "sharded"
           else torch.as_tensor(points.astype(np.float32), device=device))

    def build(max_neighbors):
        if method == "sharded":
            # the dense table's rows split over the ranks of the default
            # process group (parallel/batch.py; one rank without one)
            from ..parallel.batch import compute_neighbors_sharded
            return compute_neighbors_sharded(points, epsilon, min_pts,
                                             max_neighbors=max_neighbors, block=block,
                                             device=device)
        return build_table(pts, epsilon, min_pts, max_neighbors, block, method, full_window,
                           proj_dims)

    table = build(max_neighbors)
    max_cnt = int(table.count.max())
    k_eff = table.idx.shape[1]
    if max_cnt > k_eff:
        k_new = min(_next_pow2(max_cnt), n, k_cap(n, k_eff))
        if k_new > k_eff:
            warnings.warn(
                f"OPTICS neighbor cap {k_eff} < max neighborhood {max_cnt}; "
                f"recomputing with max_neighbors={k_new}", RuntimeWarning)
            table = build(k_new)
            max_cnt = int(table.count.max())
            k_eff = table.idx.shape[1]
        if max_cnt > k_eff:
            warnings.warn(
                f"OPTICS neighborhoods truncated: cap {k_eff} < max true "
                f"neighborhood {max_cnt} — reachability of far neighbors "
                f"relaxes only through closer intermediates (error bound: "
                f"tests/test_optics.py::test_neighbor_cap_truncation)",
                RuntimeWarning)
    return table


def sweep_python(nbr_idx: np.ndarray, nbr_dist: np.ndarray, core_dist: np.ndarray):
    """The OPTICS sweep as a Python heap loop, the rule of
    `native/optics_sweep.cpp`: seeds ordered by (reach, index), stale heap
    entries skipped. Returns (order int64, reach float64, -1 where
    unreached)."""
    n = len(core_dist)
    live = (nbr_idx >= 0) & np.isfinite(nbr_dist)
    core = core_dist.tolist()
    processed = bytearray(n)
    reachability = [-1.0] * n
    ordered: List[int] = []
    seeds: List[Tuple[float, int]] = []

    def update(p: int):
        cd = core[p]
        row = live[p]
        for j, dj in zip(nbr_idx[p][row].tolist(), nbr_dist[p][row].tolist()):
            if processed[j]:
                continue
            new_r = cd if cd > dj else dj
            if reachability[j] < 0.0 or new_r < reachability[j]:
                reachability[j] = new_r
                heapq.heappush(seeds, (new_r, j))

    for start in range(n):
        if processed[start]:
            continue
        processed[start] = True
        ordered.append(start)
        if not math.isfinite(core[start]):
            continue
        update(start)
        while seeds:
            r, s = heapq.heappop(seeds)
            if processed[s] or r != reachability[s]:
                continue  # stale entry
            processed[s] = True
            ordered.append(s)
            if math.isfinite(core[s]):
                update(s)

    assert len(ordered) == n
    return np.asarray(ordered, np.int64), np.asarray(reachability, np.float64)


def table_to_host(table: NeighborTable):
    """The table moved to the host once, as the sweep reads it: (idx int32,
    dist float64, core_dist float64) numpy arrays."""
    return (table.idx.cpu().numpy(), table.dist.cpu().numpy().astype(np.float64),
            table.core_dist.cpu().numpy().astype(np.float64))


def sweep(nbr_idx: np.ndarray, nbr_dist: np.ndarray, core_dist: np.ndarray,
          use_native: bool = True) -> List[ReachabilityDist]:
    """The OPTICS sweep over a host table (`table_to_host`): the native
    build (`native.optics_sweep`, built by g++ at first use; a failed build
    raises) or, with use_native=False, the Python loop (`sweep_python`)."""
    if use_native:
        from .. import native
        order, reach = native.optics_sweep(nbr_idx, nbr_dist, core_dist)
    else:
        order, reach = sweep_python(nbr_idx, nbr_dist, core_dist)
    return [ReachabilityDist(i, r) for i, r in zip(order.tolist(), reach[order].tolist())]


def compute_reachability_dists(points: np.ndarray, min_pts: int,
                               epsilon: float = -1.0,
                               max_neighbors: int = 256,
                               block: int = 2048,
                               use_native: bool = True,
                               approx: bool = False,
                               method: str = "auto",
                               full_window: bool = False,
                               proj_dims: int = 3,
                               device="cuda") -> List[ReachabilityDist]:
    """Full OPTICS: eps-neighborhoods on `device` (`neighbor_table`), moved
    to the host once, and the seed-queue sweep there (`sweep`).

    Returns the ordered list of (point_index, reach_dist); unreached points
    carry -1.0, the reference's output contract. epsilon <= 0 estimates it
    (`epsilon_estimation`).

    method: "cellpair" (the gather-free grid, fastest at d <= 2), "grid"
    (exact full-d grid up to d = 4, the projected grid beyond), "dense"
    (tiled O(N^2) panels), "dense2" and "certified" (JAX's TPU work-arounds,
    the dense table here), "auto" (cellpair at d <= 2, else grid, else
    dense, which JAX replaces by certified from 32768 points, each falling
    through where it declines), and "sharded" (the dense table with its
    rows split over the process group's ranks, parallel/batch.py; one rank
    when torch.distributed is not initialized). "cellpair" and
    "grid" raise ValueError where they decline. full_window lets the grid
    keep its whole masked windows (see compute_neighbors_grid).

    Neighborhoods larger than max_neighbors keep only the nearest K. Where
    the true largest neighborhood exceeds K, the table is built once more
    with K raised to cover it (up to auto_raise_cap, the (N, K) panels'
    memory), with a RuntimeWarning; a RuntimeWarning also reports a
    truncation that remains.
    """
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 0:
        return []
    if epsilon <= 0.0:
        epsilon = epsilon_estimation(points, min_pts)
    assert epsilon > 0
    table = neighbor_table(points, min_pts, epsilon, max_neighbors, block, approx,
                           method, full_window, proj_dims, device)
    return sweep(*table_to_host(table), use_native=use_native)


# --------------------------------------------------------------------------
# Cluster extraction: threshold split (optics.hpp:674-690)
# --------------------------------------------------------------------------

def get_cluster_indices(reach_dists: Sequence[ReachabilityDist],
                        reachability_threshold: float) -> List[List[int]]:
    assert reach_dists[0].reach_dist < 0.0
    result: List[List[int]] = []
    for r in reach_dists:
        if r.reach_dist < 0.0 or r.reach_dist >= reachability_threshold:
            result.append([r.point_index])
        else:
            result[-1].append(r.point_index)
    return result


def get_cluster_points(reach_dists, reachability_threshold, points):
    points = np.asarray(points)
    return [points[np.asarray(c, dtype=int)]
            for c in get_cluster_indices(reach_dists, reachability_threshold)]


def get_cluster_indices_chi(reach_dists: Sequence[ReachabilityDist],
                            clusters: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """Index extraction for chi clusters (optics.hpp:737-755)."""
    return [[reach_dists[i].point_index for i in range(c[0], c[1] + 1)]
            for c in clusters]


def export_reachability_dists(reach_dists: Sequence[ReachabilityDist],
                              csv_path: str, replace_nodists: bool = True) -> None:
    """CSV export with the reference's header (optics.hpp:592-615)."""
    no_dist = -1.0
    if replace_nodists:
        no_dist = max(r.reach_dist for r in reach_dists) + 1
    with open(csv_path, "w") as f:
        f.write("PointIndex;ReachabilityDistance\n")
        for r in reach_dists:
            v = no_dist if r.reach_dist < 0 else r.reach_dist
            f.write(f"{r.point_index};{v}\n")


# --------------------------------------------------------------------------
# App B on one slice of an event stream already on the device
# --------------------------------------------------------------------------

class OpticsSlice(NamedTuple):
    order: torch.Tensor         # int32 (N,) valid lanes in reachability order, -1 pad
    reach: torch.Tensor         # float32 (N,) per lane, -1 unreached or invalid
    cluster: torch.Tensor       # int32 (N,) per lane, numbered as they start, -1 invalid
    num_clusters: torch.Tensor  # int32 ()
    size: torch.Tensor          # int32 (N,) points of cluster j, 0 past num_clusters
    centroid: torch.Tensor      # float32 (N, 2) mean (x, y) of cluster j
    variance: torch.Tensor      # float32 (N, 2) population variance of x and of y


def _to_host(*tensors):
    """Device tensors as NumPy: copied into pinned host memory without a
    wait, then one wait. CPU tensors are returned as they are."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
           for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in out]


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, from pinned memory without a wait."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _slice_eps(pts: torch.Tensor, valid: torch.Tensor, min_pts: int) -> float:
    """epsilon_estimation of the valid points, from their bounding box and
    count read back in one copy; raises where it is undefined (fewer than
    two points, or a box of no extent)."""
    box = torch.cat([torch.where(valid[:, None], pts, torch.inf).amin(0),
                     torch.where(valid[:, None], pts, -torch.inf).amax(0),
                     valid.sum()[None].to(torch.float32)]).tolist() if len(pts) else [0] * 5
    eps = _estimate_eps(np.asarray(box[:2]), np.asarray(box[2:4]), int(box[4]), min_pts)
    if not eps > 0.0:
        raise ValueError("no epsilon can be estimated from fewer than two distinct points")
    return eps


def optics_slice(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, cfg: OpticsConfig,
                 threshold: float, block: int = 2048) -> OpticsSlice:
    """App B on one slice (cluster_event_data.cpp:449-527): OPTICS of the
    (x, y) pixels of the valid events, duplicates kept, then the threshold
    split and each cluster's size, centroid and variance. Order and reach
    are those of compute_reachability_dists on the valid points (invalid
    lanes take no part); the (N,) inputs stay on their device.

    - table (span `optics.table`): every point's inclusive eps-count in one
      pass (`ops.distance.eps_counts`), its maximum and the valid count read
      back as two integers, then one table (`build_table`) at K, the next
      power of two at or above max(max_neighbors, the largest count,
      min_pts): no neighborhood is truncated. A K past `k_cap` raises;
    - sweep (span `optics.sweep`): the float32 table, its core distances
      and its largest count copied to the host at once (a count over the
      table's width raises), and the native sweep (`native.optics_sweep`);
    - extract (span `optics.extract`): the order and reach back on the
      device; a cluster starts at each point of the order whose reach is
      unreached or at least `threshold` (optics.hpp:674-690); sizes, float32
      means and two-pass population variances by `ops.segment`.

    The tables of clusters have N rows, since every point may be one.
    cfg.epsilon <= 0 estimates eps from the valid points' bounding box
    (`epsilon_estimation`), read back first."""
    from .. import native

    n = x.shape[0]
    dev = x.device
    with span("optics"):
        pts = torch.stack([x, y], 1).to(torch.float32)
        with span("optics.table"):
            eps = float(cfg.epsilon)
            if eps <= 0.0:
                eps = _slice_eps(pts, valid, cfg.min_pts)
            counts = eps_counts(pts, pts, eps, valid, valid, block)
            # the valid lanes in index order, first
            pos = torch.cumsum(valid, 0) - 1
            lanes = torch.full((n + 1,), n, dtype=torch.int64, device=dev).scatter_(
                0, torch.where(valid, pos, n), torch.arange(n, device=dev))
            nv, max_count = (torch.stack([valid.sum(), counts.amax().long()]).tolist() if n
                             else (0, 0))
            lanes = lanes[:nv]
            pts_v = pts[lanes]
            k = min(_next_pow2(max(cfg.max_neighbors, max_count, cfg.min_pts)), max(nv, 1))
            cap = k_cap(nv, min(cfg.max_neighbors, nv))
            if max_count > cap:
                raise RuntimeError(f"OPTICS neighborhood of {max_count} points passes the "
                                   f"table's cap of {cap} columns at {nv} points")
            table = build_table(pts_v, eps, cfg.min_pts, k, block) if nv else None
        with span("optics.sweep"):
            if nv:
                idx_h, dist_h, core_h, widest = _to_host(
                    table.idx, table.dist, table.core_dist, table.count.amax())
                if int(widest) > idx_h.shape[1]:
                    raise RuntimeError(f"OPTICS table of {idx_h.shape[1]} columns holds a "
                                       f"neighborhood of {int(widest)}")
                order_h, reach_h = native.optics_sweep(idx_h, dist_h, core_h)
            else:
                order_h, reach_h = np.zeros(0, np.int64), np.zeros(0, np.float32)
        with span("optics.extract"):
            order_v = _to_device(order_h, dev)
            reach_v = _to_device(reach_h, dev)
            r_seq = reach_v[order_v].to(torch.float64)
            start = (r_seq < 0.0) | (r_seq >= threshold)
            cid_seq = torch.cumsum(start, 0, dtype=torch.int32) - 1
            cluster_v = torch.empty(nv, dtype=torch.int32, device=dev).scatter_(
                0, order_v, cid_seq)
            every = torch.ones(nv, dtype=torch.bool, device=dev)
            centroid, size = segment_mean_points(pts_v, cluster_v, n, every)
            dev_v = pts_v - centroid[cluster_v.long()]
            variance = (masked_segment_sum(dev_v * dev_v, cluster_v, n, every)
                        / torch.clamp_min(size, 1).to(torch.float32)[:, None])
            order = torch.full((n,), -1, dtype=torch.int32, device=dev)
            order[:nv] = lanes[order_v].to(torch.int32)
            reach = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
            reach[lanes] = reach_v
            cluster = torch.full((n,), -1, dtype=torch.int32, device=dev)
            cluster[lanes] = cluster_v
            num = start.sum(dtype=torch.int32)
    return OpticsSlice(order=order, reach=reach, cluster=cluster, num_clusters=num, size=size,
                       centroid=centroid, variance=variance)


# --------------------------------------------------------------------------
# xi (chi) steep-area cluster extraction (optics.hpp:814-944)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _SDA:
    begin_idx: int
    end_idx: int
    mib: float


def get_chi_clusters_flat(reach_dists: Sequence[ReachabilityDist], chi: float,
                          min_pts: int, steep_area_min_diff: float = 0.0
                          ) -> List[Tuple[int, int]]:
    n = len(reach_dists)
    max_reach = max((r.reach_dist for r in reach_dists), default=0.0)
    max_reach = max(max_reach, 0.0)

    def rd(idx: int) -> float:
        if idx >= n or idx == 0:
            return max_reach
        r = reach_dists[idx].reach_dist
        return 2 * max_reach if r < 0 else r

    def is_sd(idx: int) -> bool:
        if idx == 0:
            return True
        if idx + 1 >= n:
            return False
        return rd(idx + 1) <= rd(idx) * (1 - chi)

    def is_su(idx: int) -> bool:
        if idx + 1 >= n:
            return True
        return rd(idx + 1) * (1 - chi) >= rd(idx)

    sdas: List[_SDA] = []
    clusters: List[Tuple[int, int]] = []
    mib = 0.0

    def filter_sdas():
        nonlocal sdas
        f = max(chi, steep_area_min_diff)
        sdas = [s for s in sdas if mib <= rd(s.begin_idx) * (1 - f)]
        for s in sdas:
            s.mib = max(s.mib, mib)

    def sda_end(start: int) -> int:
        last = start
        idx = start + 1
        while idx < n:
            if idx - last >= min_pts:
                return last
            if rd(idx) > rd(idx - 1):
                return last
            if is_sd(idx):
                last = idx
            idx += 1
        return max(n - 2, last)

    def sua_end(start: int) -> int:
        last = start
        idx = start + 1
        while idx < n:
            if idx - last >= min_pts:
                return last
            if rd(idx) < rd(idx - 1):
                return last
            if is_su(idx):
                last = idx
            idx += 1
        return max(n - 2, last)

    def cluster_borders(sda: _SDA, sua_b: int, sua_e: int) -> Tuple[int, int]:
        start_reach = rd(sda.begin_idx)
        end_reach = rd(min(sua_e + 1, n - 1))
        # geom::in_range(a, b, tol) is |a-b| <= tol
        if abs(start_reach - end_reach) <= start_reach * chi:
            return (sda.begin_idx, sua_e)
        if start_reach > end_reach:
            s = sda.begin_idx + 1
            while s <= sda.end_idx and rd(s) > end_reach:
                s += 1
            return (s - 1, sua_e)
        # start_reach < end_reach
        e = sua_e
        while e >= sua_b and rd(e) >= start_reach:
            e -= 1
        return (sda.begin_idx, e + 1)

    def valid_combination(sda: _SDA, sua_b: int, sua_e: int) -> bool:
        f = max(chi, steep_area_min_diff)
        if sda.mib > rd(sua_e + 1) * (1 - f):
            return False
        sda_mid = sda.begin_idx + (sda.end_idx - sda.begin_idx) // 2
        sua_mid = sua_b + (sua_e - sua_b) // 2
        if sua_mid - sda_mid < min_pts - 2:
            return False
        return True

    idx = 0
    while idx < n:
        reach_i = rd(idx)
        if is_sd(idx):
            if reach_i > mib:
                mib = reach_i
            filter_sdas()
            se = sda_end(idx)
            if reach_i * (1.0 - steep_area_min_diff) < rd(se + 1):
                idx += 1
                continue
            sdas.append(_SDA(idx, se, 0.0))
            idx = se
            if idx < n - 1:
                mib = rd(idx + 1)
            idx += 1
            continue
        elif is_su(idx):
            filter_sdas()
            ue = sua_end(idx)
            if reach_i > rd(ue + 1) * (1.0 - steep_area_min_diff):
                idx += 1
                continue
            for sda in sdas:
                if valid_combination(sda, idx, ue):
                    clusters.append(cluster_borders(sda, idx, ue))
            idx = ue
            if idx < n - 1:
                mib = rd(idx + 1)
            idx += 1
        else:
            if reach_i > mib:
                mib = reach_i
            idx += 1
    return clusters


# --------------------------------------------------------------------------
# Cluster hierarchy (optics.hpp:948-995 + tree.hpp)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterNode:
    """Node<chi_cluster_indices> equivalent (tree.hpp:15-62)."""
    data: Tuple[int, int]
    children: List["ClusterNode"] = dataclasses.field(default_factory=list)

    def add_child(self, child: "ClusterNode") -> None:
        self.children.append(child)

    def flatten(self) -> List[Tuple[int, int]]:
        out = [self.data]
        for c in self.children:
            out.extend(c.flatten())
        return out

    def depth(self) -> int:
        return 1 + max((c.depth() for c in self.children), default=0)

    def size(self) -> int:
        return 1 + sum(c.size() for c in self.children)

    def __eq__(self, other) -> bool:
        return (self.data == other.data and len(self.children) == len(other.children)
                and all(a == b for a, b in zip(self.children, other.children)))


def flat_clusters_to_tree(clusters_flat: Sequence[Tuple[int, int]]
                          ) -> List[ClusterNode]:
    """Sort children before parents, then attach to the first enclosing parent
    (optics.hpp:948-995)."""
    m = len(clusters_flat)
    sorted_m: List[Optional[Tuple[int, int]]] = [None] * m
    next_free = 0
    for idx in range(m):
        while next_free < m and sorted_m[next_free] is not None:
            next_free += 1
        pos = next_free
        follow = idx + 1
        while follow < m and clusters_flat[follow][1] <= clusters_flat[idx][1]:
            follow += 1
            pos += 1
        sorted_m[pos] = clusters_flat[idx]
    flat_sorted = [c for c in sorted_m if c is not None]
    assert len(flat_sorted) == m

    nodes = [ClusterNode(c) for c in flat_sorted]
    result: List[ClusterNode] = []
    for i, node in enumerate(nodes):
        parent = None
        for j in range(i + 1, len(nodes)):
            pj = nodes[j].data
            if node.data[0] >= pj[0] and node.data[1] <= pj[1]:
                parent = nodes[j]
                break
        if parent is None:
            result.append(node)
        else:
            parent.add_child(node)
    return result


def get_chi_clusters(reach_dists, chi, min_pts, steep_area_min_diff=0.0):
    return flat_clusters_to_tree(
        get_chi_clusters_flat(reach_dists, chi, min_pts, steep_area_min_diff))
