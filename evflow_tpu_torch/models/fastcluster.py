"""Slice-vectorized incremental clustering (counterpart of
evflow_tpu/models/fastcluster.py, single-device `update_slice`).

Per slice:
  1. assign every event to the nearest start-of-slice cluster mean within
     the Manhattan radius — the assign_manhattan kernel;
  2. unassigned events seed new clusters from occupied radius-sized grid
     cells, lowest cell index first, into the lowest free slots;
  3+4. per-cluster member counts, stream-order EWMA means (closed form of
     mu <- (1-a) mu + a x) and coordinate sums into the ring of per-slice
     aggregates — the cluster_stats kernel, then a (C,) update here;
  5. clusters whose means lie within the radius merge onto the lowest
     creation order (8 rounds of label propagation);
  6. centroid flow per persistent cluster id.
Seeding and merging are plain torch, as the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from evflow_tpu.config import ClusterConfig, SensorConfig

from ..ops import cluster_kernels
from ..ops.cluster_kernels import log1m as _log1m

_BIG = 2**31 - 1


class FastState(NamedTuple):
    alive: torch.Tensor          # bool (C,)
    cid: torch.Tensor            # int32 (C,) persistent cluster id
    corder: torch.Tensor         # int32 (C,) creation order key
    mu: torch.Tensor             # float32 (C, 2) EWMA mean
    ring_count: torch.Tensor     # int32 (C, R) per-slice member counts
    ring_sum: torch.Tensor       # float32 (C, R, 2) per-slice coordinate sums
    ring_head: torch.Tensor      # int32 () current ring slot
    centroid_prev: torch.Tensor  # float32 (C, 2) last reported centroid
    has_prev: torch.Tensor       # bool (C,)
    next_cid: torch.Tensor       # int32 ()
    next_order: torch.Tensor     # int32 ()


class SliceOutput(NamedTuple):
    alive: torch.Tensor      # bool (C,) clusters alive after this slice
    reported: torch.Tensor   # bool (C,) n >= min_n (the rendered subset)
    cid: torch.Tensor        # int32 (C,)
    n: torch.Tensor          # int32 (C,) windowed membership
    centroid: torch.Tensor   # float32 (C, 2)
    flow: torch.Tensor       # float32 (C, 2) centroid - prev (0 on first report)
    labels: torch.Tensor     # int32 (N,) per-event cluster slot (-1 none)


def init_state(cfg: ClusterConfig = ClusterConfig(), window_slices: int = 4,
               device="cpu") -> FastState:
    c, r = cfg.max_clusters, window_slices
    i32, f32 = torch.int32, torch.float32
    return FastState(
        alive=torch.zeros(c, dtype=torch.bool, device=device),
        cid=torch.full((c,), -1, dtype=i32, device=device),
        corder=torch.full((c,), _BIG, dtype=i32, device=device),
        mu=torch.zeros((c, 2), dtype=f32, device=device),
        ring_count=torch.zeros((c, r), dtype=i32, device=device),
        ring_sum=torch.zeros((c, r, 2), dtype=f32, device=device),
        ring_head=torch.zeros((), dtype=i32, device=device),
        centroid_prev=torch.zeros((c, 2), dtype=f32, device=device),
        has_prev=torch.zeros(c, dtype=torch.bool, device=device),
        next_cid=torch.zeros((), dtype=i32, device=device),
        next_order=torch.zeros((), dtype=i32, device=device),
    )


def _seed(state: FastState, x, y, valid, assigned, cfg: ClusterConfig,
          sensor: SensorConfig, grid_cells: int):
    """Step 2: one new cluster per occupied grid cell of orphan events (cell
    index order), in the lowest free slots. Returns the seeded state fields
    and each orphan event's new slot (-1 where none)."""
    c = cfg.max_clusters
    dev = x.device
    i32 = torch.int32
    cell_w = max(int(cfg.radius), 1)
    ncx = -(-sensor.width // cell_w)
    cell = (y // cell_w) * ncx + (x // cell_w)
    cell = torch.where(valid & ~assigned, cell % grid_cells, grid_cells)
    # (count, sum x, sum y) per cell, exact in int64
    feats = torch.stack([torch.ones_like(x), x, y], 1).to(torch.int64)
    agg = torch.zeros((grid_cells + 1, 3), dtype=torch.int64, device=dev).index_add(
        0, cell.long(), feats)[:grid_cells]
    cell_cnt = agg[:, 0].to(i32)
    cell_sum = agg[:, 1:].to(torch.float32)
    occupied = cell_cnt > 0
    free = ~state.alive
    n_free = free.sum(dtype=i32)
    n_occ = occupied.sum(dtype=i32)
    n_new = torch.clamp_max(torch.minimum(n_occ, n_free), c)
    occ_rank = torch.cumsum(occupied.to(i32), 0, dtype=i32) - 1
    rank_pos = torch.where(occupied & (occ_rank < c), occ_rank, c).long()
    cell_of_rank = torch.zeros(c + 1, dtype=i32, device=dev).scatter(
        0, rank_pos, torch.arange(grid_cells, dtype=i32, device=dev))[:c]
    seed_mu = cell_sum[cell_of_rank] \
        / torch.clamp_min(cell_cnt[cell_of_rank], 1)[:, None]
    # the k-th free slot takes seeding position k (< n_new)
    free_rank = torch.cumsum(free.to(i32), 0, dtype=i32) - 1
    pos_of_slot = torch.where(free & (free_rank < n_new), free_rank, c)
    seeded = pos_of_slot < c
    pgather = pos_of_slot.clamp(0, c - 1)
    fields = dict(
        alive=state.alive | seeded,
        mu=torch.where(seeded[:, None], seed_mu[pgather], state.mu),
        cid=torch.where(seeded, state.next_cid + pgather, state.cid),
        corder=torch.where(seeded, state.next_order + pgather, state.corder),
        next_cid=state.next_cid + n_new,
        next_order=state.next_order + n_new,
        # fresh slots start with cleared windows and previous centroids
        ring_count=torch.where(seeded[:, None], 0, state.ring_count),
        ring_sum=torch.where(seeded[:, None, None], 0.0, state.ring_sum),
        has_prev=state.has_prev & ~seeded,
        centroid_prev=torch.where(seeded[:, None], 0.0, state.centroid_prev),
    )
    # route orphan events to their cell's seeded slot
    slot_for_pos = torch.full((c + 1,), c, dtype=i32, device=dev).scatter(
        0, pos_of_slot.long(), torch.arange(c, dtype=i32, device=dev))[:c]
    ev_pos = occ_rank[cell.clamp(0, grid_cells - 1)]
    ev_seeded = valid & ~assigned & (cell < grid_cells) & (ev_pos < n_new)
    ev_slot = torch.where(ev_seeded, slot_for_pos[ev_pos.clamp(0, c - 1)], -1)
    return fields, ev_slot


def update_slice(state: FastState, x: torch.Tensor, y: torch.Tensor,
                 valid: torch.Tensor, cfg: ClusterConfig = ClusterConfig(),
                 sensor: SensorConfig = SensorConfig(), grid_cells: int = 4096
                 ) -> Tuple[FastState, SliceOutput]:
    """One slice step over (N,) int32 event coordinates and their validity."""
    c = cfg.max_clusters
    dev = x.device
    i32, f32 = torch.int32, torch.float32
    px, py = x.to(f32), y.to(f32)

    # ---- 1. assignment to start-of-slice means (kernel)
    best, _ = cluster_kernels.assign_manhattan(x, y, state.mu, state.alive,
                                               cfg.radius)
    assigned = valid & (best >= 0)
    labels = torch.where(assigned, best, -1)

    # ---- 2. seeding
    f, ev_slot = _seed(state, x, y, valid, assigned, cfg, sensor, grid_cells)
    labels = torch.where(ev_slot >= 0, ev_slot, labels)
    member = labels >= 0

    # ---- 3+4. EWMA means and this slice's ring aggregates (kernel)
    sums = cluster_kernels.cluster_stats(labels, px, py, cfg.alpha, c)
    k_i = sums[:, 0].to(i32)
    la = _log1m(cfg.alpha)
    decay = torch.exp(torch.clamp(sums[:, 0], 0.0, 80.0) * la)
    mu = torch.where((k_i > 0)[:, None], decay[:, None] * f["mu"] + sums[:, 3:5],
                     f["mu"])
    head = state.ring_head.reshape(1).long()
    rc = f["ring_count"].index_copy(1, head, k_i[:, None])
    rs = f["ring_sum"].index_copy(1, head, sums[:, None, 1:3])
    n_window = rc.sum(1, dtype=i32)

    # ---- 5. merge clusters whose means lie within the radius
    alive, corder = f["alive"], f["corder"]
    dmu = (mu[:, None, 0] - mu[None, :, 0]).abs() + (mu[:, None, 1] - mu[None, :, 1]).abs()
    adj = (dmu <= cfg.radius) & alive[:, None] & alive[None, :]
    comp = torch.where(alive, corder, _BIG)
    for _ in range(8):   # min-order label propagation, C small
        comp = torch.minimum(comp, torch.where(adj, comp[None, :], _BIG).amin(1))
    is_root = alive & (comp == corder)
    # eq[i, j]: alive j is i's root (corder is unique among alive clusters)
    eq = alive[None, :] & (corder[None, :] == comp[:, None])
    root_slot = eq.to(i32).argmax(1)
    merged_into = torch.where(alive, root_slot,
                              torch.arange(c, device=dev)).to(i32)
    eqt = eq.to(f32).T                       # (root, member)
    wm = n_window.to(f32)
    mu_num = eqt @ (wm[:, None] * mu)
    mu_den = eqt @ wm
    r = rc.shape[1]
    rc = (eqt @ rc.to(f32)).to(i32)          # exact: integer-valued f32
    rs = (eqt @ rs.reshape(c, r * 2)).reshape(c, r, 2)
    mu = torch.where(is_root[:, None], mu_num / torch.clamp_min(mu_den, 1.0)[:, None], mu)
    rc = torch.where(is_root[:, None], rc, 0)
    rs = torch.where(is_root[:, None, None], rs, 0.0)
    labels = torch.where(member, merged_into[labels.clamp(0, c - 1)], labels)
    n_window = rc.sum(1, dtype=i32)
    centroid = rs.sum(1) / torch.clamp_min(n_window, 1)[:, None].to(f32)

    # ---- expiry: no members anywhere in the window
    alive = is_root & (n_window > 0)

    # ---- 6. flow vs the previous reported centroid
    reported = alive & (n_window >= cfg.min_n)
    has_prev = f["has_prev"]
    flow = torch.where((reported & has_prev)[:, None],
                       centroid - f["centroid_prev"], 0.0)
    centroid_prev = torch.where(reported[:, None], centroid, f["centroid_prev"])
    has_prev = has_prev | reported

    new_state = FastState(
        alive=alive, cid=f["cid"], corder=torch.where(alive, corder, _BIG), mu=mu,
        ring_count=rc, ring_sum=rs, ring_head=(state.ring_head + 1) % r,
        centroid_prev=centroid_prev, has_prev=has_prev & alive,
        next_cid=f["next_cid"], next_order=f["next_order"],
    )
    out = SliceOutput(alive=alive, reported=reported, cid=f["cid"], n=n_window,
                      centroid=centroid, flow=flow, labels=labels)
    return new_state, out
