"""Spatial tiling of event slices over the ranks of a mesh axis (counterpart
of evflow_tpu/parallel/tiling.py).

Each slice's events are bucketed into vertical pixel bands (tiles), one
band per rank of the tile axis. The per-event stages (dedup, the
assignment and statistics kernels, the SAE scatter, the eFAST ring gather)
run on the rank's own events. The cluster update is
fastcluster.update_slice_distributed: no event crosses the ranks, only
per-cell and per-cluster partials. The corner path gathers only the compact
post-NMS corner lists for the replicated tracker. eFAST needs 4 px of
context across band borders: each rank's SAE slab carries halo columns
refreshed from its neighbours every slice.

Where JAX's shard_map hands each device a (1, cap) block of an (n_tiles,
cap) array, a rank here holds its own tile's (cap,) tensors and its own
slab; the steps return the rank's own labels and slab, and everything
else replicated.

Per-tile dedup: tiles partition pixel space, so exact dedup equals the
one-device dedup; hash mode gets a table per tile (fewer collisions than
one table), as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT, EngineConfig
from ..models import fastcluster, tracker as tracker_mod
from ..models.pipeline import CornerTrackOutput
from ..ops import efast, hash_dedup, nms as nms_ops, sae as sae_ops
from . import mesh as mesh_mod


# --------------------------------------------------------------------------
# Host-side tile bucketing
# --------------------------------------------------------------------------

def bucket_by_tile(x, y, t, p, valid, n_tiles: int, width: int, capacity: int):
    """Split one slice's events into per-tile arrays (host-side, numpy).

    Returns (n_tiles, capacity) arrays + per-tile counts. Events keep stream
    order within a tile. Overflow beyond capacity is dropped (count reports
    the kept number).
    """
    x = np.asarray(x); y = np.asarray(y); t = np.asarray(t); p = np.asarray(p)
    valid = np.asarray(valid)
    tile_w = -(-width // n_tiles)
    tile = np.clip(x // tile_w, 0, n_tiles - 1)
    ox = np.zeros((n_tiles, capacity), np.int32)
    oy = np.zeros((n_tiles, capacity), np.int32)
    ot = np.zeros((n_tiles, capacity), np.int32)
    op = np.zeros((n_tiles, capacity), np.int32)
    cnt = np.zeros((n_tiles,), np.int32)
    for k in range(n_tiles):
        sel = valid & (tile == k)
        c = min(int(sel.sum()), capacity)
        ox[k, :c] = x[sel][:c]
        oy[k, :c] = y[sel][:c]
        ot[k, :c] = t[sel][:c]
        op[k, :c] = p[sel][:c]
        cnt[k] = c
    return ox, oy, ot, op, cnt


def bucket_slices_by_tile(x, y, t, p, valid, n_tiles: int, width: int,
                          capacity: int):
    """bucket_by_tile over all slices at once (host-side numpy).

    x, y, t, p: (S, N); valid: (S, N). Returns (S, n_tiles, capacity) arrays
    (stream order within each tile, overflow beyond capacity dropped) plus
    (S, n_tiles) kept counts — per slice identical to bucket_by_tile, with
    one argsort pass instead of a loop per slice."""
    x = np.asarray(x); y = np.asarray(y); t = np.asarray(t); p = np.asarray(p)
    valid = np.asarray(valid)
    s, n = x.shape
    tile_w = -(-width // n_tiles)
    tile = np.clip(x // tile_w, 0, n_tiles - 1)
    tile = np.where(valid, tile, n_tiles)              # park invalid lanes
    # stable per-slice sort by tile (lane tiebreak keeps stream order)
    order = np.argsort(tile * np.int64(n) + np.arange(n)[None, :], axis=1)
    st = np.take_along_axis(tile, order, axis=1)       # (S, N) sorted tiles
    first = np.concatenate([np.ones((s, 1), bool), st[:, 1:] != st[:, :-1]],
                           axis=1)
    run_start = np.maximum.accumulate(
        np.where(first, np.arange(n)[None, :], 0), axis=1)
    rank = np.arange(n)[None, :] - run_start
    keep = (st < n_tiles) & (rank < capacity)
    srow = np.broadcast_to(np.arange(s)[:, None], (s, n))[keep]
    stile = st[keep]
    srank = rank[keep]
    slane = np.take_along_axis(
        np.broadcast_to(np.arange(n)[None, :], (s, n)), order, axis=1)[keep]
    out = []
    for a, dt in ((x, np.int32), (y, np.int32), (t, t.dtype), (p, np.int32)):
        o = np.zeros((s, n_tiles, capacity), dt)
        o[srow, stile, srank] = a[srow, slane]
        out.append(o)
    cnt = np.zeros((s, n_tiles), np.int32)
    np.add.at(cnt, (srow, stile), 1)
    return (*out, cnt)


# --------------------------------------------------------------------------
# Tiled cluster step: per-tile dedup -> distributed cluster update
# --------------------------------------------------------------------------

def make_tiled_cluster_flow_step(mesh: mesh_mod.Mesh, cfg: EngineConfig = DEFAULT):
    """The tiled cluster+flow step of this rank: step(state, x, y, valid)
    with the rank's tile's (cap,) events and the replicated FastState ->
    (new state, SliceOutput with the local events' labels, unique count,
    repeated count), the counts summed over the tiles."""
    axis = mesh.axis(cfg.parallel.tile_axis)

    def step(state, x, y, valid):
        ded = hash_dedup.dedup_mask(x, y, valid, cfg.dedup, cfg.sensor)
        new_state, out = fastcluster.update_slice_distributed(
            state, x, y, ded.unique_mask, axis, cfg.cluster, cfg.sensor)
        counts = mesh_mod.psum(torch.stack([ded.unique_count, ded.repeated_count]), axis)
        return new_state, out, counts[0], counts[1]

    return step


# --------------------------------------------------------------------------
# Tiled corner step: SAE slabs with halo exchange -> eFAST -> gathered NMS
# and tracker
# --------------------------------------------------------------------------

class TiledCornerState(NamedTuple):
    slab: torch.Tensor                # int32 (H, tile_w + 2*halo), this rank's
    tracks: tracker_mod.TrackState    # replicated
    slice_idx: torch.Tensor           # int32 () replicated


def init_tiled_corner_state(mesh: mesh_mod.Mesh, n_tiles: int,
                            cfg: EngineConfig = DEFAULT, device="cuda") -> TiledCornerState:
    h = cfg.sensor.height
    tile_w = -(-cfg.sensor.width // n_tiles)
    halo = cfg.parallel.halo
    return TiledCornerState(
        slab=torch.zeros((h, tile_w + 2 * halo), dtype=torch.int32, device=device),
        tracks=tracker_mod.init_state(cfg.tracker, device=device),
        slice_idx=torch.zeros((), dtype=torch.int32, device=device))


def tile_local_nms(cx, cy, cvalid, axis: mesh_mod.Axis, my: int, n: int, x0: int,
                   tile_w: int, cfg: EngineConfig) -> nms_ops.NMSResult:
    """Tile-local NMS. The global candidate order is tile-major (each
    tile's candidates in local stream order), so suppression flows strictly
    left to right: a candidate's fate depends only on accepted corners in
    earlier tiles, and box overlap (|dx| <= box_size, tiles wider than
    2*box_size) limits that to the left neighbour's accepted right strip.

    Round 1 is the local greedy NMS; each further round runs it again with
    the left neighbour's current accepted right strip as immune corners.
    After R rounds tile k's result is exact unless an unbroken chain of
    pairwise-overlapping candidates spans R - 1 full tile widths:
    cfg.parallel.nms_exchange_rounds = n_tiles is the exact fixpoint, 2 the
    two-pass scheme (the adversarial chain of the tests shows both)."""
    cap = cfg.nms.max_corners
    box = cfg.nms.box_size
    lane = torch.arange(cap, device=cx.device)
    filt = nms_ops.filter_corners(cx, cy, cvalid, cfg.nms)
    for _ in range(cfg.parallel.nms_exchange_rounds - 1):
        strip_v = (lane < filt.count) & (filt.x >= x0 + tile_w - box)
        got = mesh_mod.ppermute(torch.stack([filt.x, filt.y, strip_v.to(torch.int32)]),
                                axis, 1)
        # the leftmost tile receives wrapped data
        imm_v = (got[2] > 0) & (my > 0)
        filt = nms_ops.filter_corners(cx, cy, cvalid, cfg.nms,
                                      immune_x=got[0], immune_y=got[1], immune_valid=imm_v)
    return filt


def corner_tile_body(sl, tracks, slice_idx, xl, yl, tl, vl, axis: mesh_mod.Axis,
                     tile_w: int, cfg: EngineConfig):
    """One tile's slice step of the corner path (make_tiled_corner_step,
    and each window's loop in parallel/temporal.py). sl is the rank's
    (H, tile_w + 2*halo) SAE slab, xl..vl its tile's events in global
    coordinates, slice_idx > 0 arms detection. Returns (sl, tracks, out)."""
    halo = cfg.parallel.halo
    h = cfg.sensor.height
    my, n = axis.index, axis.size
    x0 = my * tile_w                   # global x of slab core column 0

    # scatter the local events into the slab core (x - x0 + halo)
    lx = xl - x0 + halo
    sl = sae_ops.update_sae(sl, lx, yl, tl, vl)

    # halo exchange: my right core edge -> the right neighbour's left halo,
    # my left core edge -> the left neighbour's right halo (the edge tiles
    # receive wrapped columns, outside the eFAST border in the global frame)
    edges = mesh_mod.all_gather(
        torch.stack([sl[:, halo:2 * halo], sl[:, tile_w:tile_w + halo]]), axis)
    sl[:, :halo] = edges[(my - 1) % n, 1]
    sl[:, tile_w + halo:] = edges[(my + 1) % n, 0]

    # eFAST on the local events against the slab (shifted sensor frame);
    # the border margin in the global frame
    slab_sensor = cfg.sensor.__class__(width=tile_w + 2 * halo, height=h)
    cs = cfg.efast.border
    in_core = vl & (xl >= x0) & (xl < x0 + tile_w)
    gborder = (xl >= cs) & (xl < cfg.sensor.width - cs) & (yl >= cs) & (yl < h - cs)
    corner_mask = efast.detect_corners(sl, lx, yl, in_core & gborder & (slice_idx > 0),
                                       cfg.efast, slab_sensor)
    n_local = corner_mask.sum(dtype=torch.int32)

    # stream-order compaction of the local corners (global coordinates)
    cap = cfg.nms.max_corners
    cx, cy, cvalid = nms_ops.compact(corner_mask, cap, xl, yl)

    n_corners = mesh_mod.psum(n_local, axis)
    filt = tile_local_nms(cx, cy, cvalid, axis, my, n, x0, tile_w, cfg)

    # the survivors of every tile, tile-major, compacted for the replicated
    # tracker
    lane = torch.arange(cap, device=xl.device)
    surv = mesh_mod.all_gather(
        torch.stack([filt.x, filt.y, (lane < filt.count).to(torch.int32)]), axis)
    sv = surv[:, 2].reshape(-1) > 0
    gx, gy, det_valid = nms_ops.compact(sv, cap, surv[:, 0].reshape(-1),
                                        surv[:, 1].reshape(-1))
    n_filtered = sv.sum(dtype=torch.int32)
    tracks, groups = tracker_mod.update(
        tracks, gx.to(torch.float32), gy.to(torch.float32), det_valid, cfg.tracker)

    out = CornerTrackOutput(
        num_corners=n_corners, num_filtered=n_filtered,
        track_active=tracks.active, track_label=tracks.label,
        track_pos=tracks.pos, track_vel=tracks.velocity,
        track_group=tracks.group_id, groups=groups)
    return sl, tracks, out


def make_tiled_corner_step(mesh: mesh_mod.Mesh, n_tiles: int, cfg: EngineConfig = DEFAULT):
    """The tiled corner step of this rank: step(slab, tracks, slice_idx, x,
    y, t, valid) with the rank's slab and tile events -> (slab, tracks,
    slice_idx + 1, CornerTrackOutput)."""
    axis = mesh.axis(cfg.parallel.tile_axis)
    tile_w = -(-cfg.sensor.width // n_tiles)
    # tile-local NMS exactness needs suppression to reach at most one tile
    # boundary (see tile_local_nms)
    assert tile_w > 2 * cfg.nms.box_size, (tile_w, cfg.nms.box_size)

    def step(slab, tracks, slice_idx, x, y, t, valid):
        sl, tracks, out = corner_tile_body(slab, tracks, slice_idx, x, y, t, valid,
                                           axis, tile_w, cfg)
        return sl, tracks, slice_idx + 1, out

    return step
