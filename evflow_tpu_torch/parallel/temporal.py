"""Temporal (data-axis) distribution over a (data x tile) grid of ranks
(counterpart of evflow_tpu/parallel/temporal.py).

The recorded stream is split into `n_windows` contiguous time windows, one
per index of the mesh's data axis. Within a window the per-slice engine
runs as on one device, a loop over the window's slices, each slice split
over the tile axis: per-tile dedup and fastcluster.update_slice_distributed
for the cluster path, tiling.corner_tile_body (halo exchange and gathered
corner lists) for the corner path. Where JAX carries the window's state
through a lax.scan, this is a host loop.

State across window boundaries is handled in two stages.

1. Warm-up overlap. Nearly every engine state has bounded memory: the
   cluster window is a ring of R slices, the EWMA mean forgets at
   (1 - alpha) per member, the tracker keeps a short history and prunes
   after frames_to_skip missed frames. Window w therefore also consumes the
   last `warmup` slices of window w - 1 (outputs discarded), so its state
   at the boundary has converged to the sequential one up to id counters.
   The exception is the SAE time surface, which persists indefinitely
   sequentially: a pixel last written before a window's warm-up reads 0 in
   that window's slab, so a detection near a window start can be missed
   (never added: a windowed detection needs an all-fresh arc, and fresh
   arc times out-rank stale off-arc pixels sequentially too). The miss
   vanishes once warmup reaches back to the stale evidence's last writer
   (the warm-up adversarial case of the tests).

2. Schur-style block reduction for joint track refinement. Each track
   slot accumulates, over its detections in the window, the normal
   equations of the per-window trajectory model

       pos(u) = (1-u) b_w + u b_{w+1} + 4u(1-u) m_w,   u in [0, 1]

   with b_w, b_{w+1} the positions at the window boundaries (shared with the
   neighbour windows) and m_w an interior curvature parameter. After the
   loop the interior parameter is eliminated per window by the Schur
   complement

       S_w = H_bb - H_bm H_mm^-1 H_mb,   g~_w = g_b - H_bm H_mm^-1 g_m,

   tracklets are stitched across boundaries (extrapolated exit against
   entry position, mutual nearest neighbour), and the reduced system over
   each chain's boundary positions, assembled from the data axis'
   all_gather, is solved jointly: one refined trajectory per physical
   track spanning windows.

Clusters are fused the same way without the solve: each window's final
reported centroid table is matched (mutual nearest within the cluster
radius) against the next window's first post-warm-up table, chaining the
windows' cluster slots into stream-global ids.

A rank materializes only its own window (`window_range`) and its own tile.
The per-window streams come back on every rank with JAX's shapes
(W, S_emit, ...), all-gathered over the data axis (KB-scale); the fusion
products are replicated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT, EngineConfig
from ..io.slicing import EventSlices
from ..models import aeclustering, fastcluster, tracker as tracker_mod
from ..models import pipeline as pipeline_mod
from ..ops import hash_dedup
from ..ops.segment import masked_segment_sum
from . import mesh as mesh_mod
from . import tiling
from ..utils.profiling import span

_BIG = 3.0e38


# --------------------------------------------------------------------------
# Per-window tracklet accumulators (carried through the slice loop)
# --------------------------------------------------------------------------

class TrackletBlocks(NamedTuple):
    """Per track slot: observation summary + trajectory normal equations.

    H is the Gram matrix of the basis [(1-u), u, 4u(1-u)] over the slot's
    detections this window; g the corresponding rhs for (x, y). A slot is
    reset whenever its track label changes (slot recycled by a new track).
    """
    label: torch.Tensor      # int32 (T,) current owner's label (-1 empty)
    nobs: torch.Tensor       # int32 (T,)
    u_first: torch.Tensor    # float32 (T,)
    u_last: torch.Tensor     # float32 (T,)
    pos_first: torch.Tensor  # float32 (T, 2)
    pos_last: torch.Tensor   # float32 (T, 2)
    vel_first: torch.Tensor  # float32 (T, 2) velocity at first obs (px/slice)
    vel_last: torch.Tensor   # float32 (T, 2) velocity at last obs
    H: torch.Tensor          # float32 (T, 3, 3)
    g: torch.Tensor          # float32 (T, 3, 2)


def init_blocks(max_tracks: int, device="cuda") -> TrackletBlocks:
    t = max_tracks

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return TrackletBlocks(
        label=torch.full((t,), -1, dtype=torch.int32, device=device),
        nobs=torch.zeros(t, dtype=torch.int32, device=device),
        u_first=z(t), u_last=z(t), pos_first=z(t, 2), pos_last=z(t, 2),
        vel_first=z(t, 2), vel_last=z(t, 2), H=z(t, 3, 3), g=z(t, 3, 2))


def _blocks_update(blocks: TrackletBlocks, tracks: tracker_mod.TrackState,
                   u: torch.Tensor, emit) -> TrackletBlocks:
    """Accumulate this slice's detections (frames_since == 0: the slot's pos
    is a matched or spawned detection) into the normal equations at time u
    (an f32 scalar tensor); `emit` is False on warm-up slices."""
    obs = tracks.active & (tracks.frames_since == 0) & emit
    changed = tracks.label != blocks.label
    nobs = torch.where(changed, 0, blocks.nobs)
    H = torch.where(changed[:, None, None], 0.0, blocks.H)
    g = torch.where(changed[:, None, None], 0.0, blocks.g)

    phi = torch.stack([1.0 - u, u, 4.0 * u * (1.0 - u)])      # (3,)
    Hc = phi[:, None] * phi[None, :]                          # (3, 3)
    gc = phi[None, :, None] * tracks.pos[:, None, :]          # (T, 3, 2)
    H = torch.where(obs[:, None, None], H + Hc[None], H)
    g = torch.where(obs[:, None, None], g + gc, g)

    is_first = obs & (nobs == 0)
    return TrackletBlocks(
        label=torch.where(obs, tracks.label, blocks.label),
        nobs=torch.where(obs, nobs + 1, nobs),
        u_first=torch.where(is_first, u, blocks.u_first),
        u_last=torch.where(obs, u, blocks.u_last),
        pos_first=torch.where(is_first[:, None], tracks.pos, blocks.pos_first),
        pos_last=torch.where(obs[:, None], tracks.pos, blocks.pos_last),
        vel_first=torch.where(is_first[:, None], tracks.velocity, blocks.vel_first),
        vel_last=torch.where(obs[:, None], tracks.velocity, blocks.vel_last),
        H=H, g=g)


# --------------------------------------------------------------------------
# Outputs
# --------------------------------------------------------------------------

class RefinedTracks(NamedTuple):
    """Joint cross-window track refinement. Chains are keyed by the flat id
    (w*T + slot) of their head tracklet; K = n_windows * max_tracks slots."""
    valid: torch.Tensor         # bool (K,)
    n_windows: torch.Tensor     # int32 (K,) chain length in windows
    n_obs: torch.Tensor         # int32 (K,) total detections in the chain
    window_mask: torch.Tensor   # bool (K, W) which windows the chain covers
    boundary_pos: torch.Tensor  # float32 (K, W+1, 2) refined positions at
    #                             window boundaries
    boundary_ok: torch.Tensor   # bool (K, W+1) boundary supported by
    #                             observations reaching it


class TemporalOutput(NamedTuple):
    # per-slice streams, shape (W, S_emit, ...), on every rank
    cl_reported: torch.Tensor   # bool (W, S, C)
    cl_cid: torch.Tensor        # int32 (W, S, C)
    cl_n: torch.Tensor          # int32 (W, S, C)
    cl_centroid: torch.Tensor   # float32 (W, S, C, 2)
    cl_flow: torch.Tensor       # float32 (W, S, C, 2)
    num_corners: torch.Tensor   # int32 (W, S)
    track_active: torch.Tensor  # bool (W, S, T)
    track_label: torch.Tensor   # int32 (W, S, T)
    track_pos: torch.Tensor     # float32 (W, S, T, 2)
    track_vel: torch.Tensor     # float32 (W, S, T, 2)
    # replicated fusion products
    refined: RefinedTracks
    cluster_chain: torch.Tensor  # int32 (W, C) stream-global cluster chain id
    #                              (-1 = slot not reported in that window)


class TemporalExactOutput(NamedTuple):
    """Per-slice exact-engine snapshots (W, S_emit, ...) plus the replicated
    cross-window cluster chain."""
    alive: torch.Tensor          # bool (W, S, C)
    cid: torch.Tensor            # int32 (W, S, C) window-local persistent ids
    n: torch.Tensor              # int32 (W, S, C)
    mu: torch.Tensor             # float32 (W, S, C, 2)
    centroid: torch.Tensor       # float32 (W, S, C, 2)
    digest: torch.Tensor         # int32 (W, S, C) member-set fingerprint
    cluster_chain: torch.Tensor  # int32 (W, C) stream-global chain id of each
    #                              slot at its final report (-1 not reported)


# --------------------------------------------------------------------------
# Host-side prep: stream -> (window, tile, slice, event) arrays with overlap
# --------------------------------------------------------------------------

def window_tile_events(slices: EventSlices, n_windows: int, n_tiles: int,
                       warmup: int, cfg: EngineConfig = DEFAULT,
                       capacity: Optional[int] = None,
                       window_range: Optional[range] = None):
    """Split sliced events into overlapping windows x spatial tiles.

    Returns (x, y, t, valid) of shape (W_local, n_tiles, warmup+n_emit, cap),
    plus emit (W_local, warmup+n_emit) bool (False on warm-up slices) and
    armed (W_local, warmup+n_emit) bool (the sequential `slice_idx > 0`
    corner arming rule, on global slice indices, so window 0's first slice
    behaves as the sequential pipeline's). Each global slice is bucketed
    once; windows gather bucketed rows. `window_range` restricts the output
    to a subset of windows (a rank's own)."""
    s_total = slices.num_slices
    n_emit = -(-s_total // n_windows)
    cap = capacity or slices.slice_capacity
    s_win = warmup + n_emit

    t0 = 0
    if s_total and slices.count[0] > 0:
        t0 = int(slices.t[0, 0])
    bx, by, bt, _bp, cnt = tiling.bucket_slices_by_tile(
        slices.x, slices.y, slices.t.astype(np.int64), slices.p,
        slices.valid_mask(), n_tiles, cfg.sensor.width, cap)
    bt = np.clip(bt - t0, 0, np.iinfo(np.int32).max).astype(np.int32)

    wr = np.arange(n_windows) if window_range is None else np.asarray(
        list(window_range))
    g = wr[:, None] * n_emit - warmup + np.arange(s_win)[None, :]
    ok = (g >= 0) & (g < s_total)                        # (W_local, s_win)
    gc = np.clip(g, 0, max(s_total - 1, 0))
    # gather (W_local, s_win, n_tiles, cap) then put tiles before slices
    tr = lambda a: np.transpose(a[gc], (0, 2, 1, 3))  # noqa: E731
    ox, oy, ot = tr(bx), tr(by), tr(bt)
    ovalid = (np.arange(cap)[None, None, :] < cnt[gc][..., None]) \
        & ok[:, :, None, None]
    ovalid = np.transpose(ovalid, (0, 2, 1, 3))
    zero = ~np.transpose(np.broadcast_to(
        ok[:, :, None, None], ok.shape + (n_tiles, cap)), (0, 2, 1, 3))
    ox = np.where(zero, 0, ox)
    oy = np.where(zero, 0, oy)
    ot = np.where(zero, 0, ot)
    emit = np.broadcast_to(np.arange(s_win)[None, :] >= warmup,
                           g.shape).copy()
    armed = g > 0
    return ox, oy, ot, ovalid, emit, armed


def window_events(slices: EventSlices, n_windows: int, warmup: int,
                  capacity: Optional[int] = None,
                  window_range: Optional[range] = None):
    """Split sliced events into overlapping time windows (no spatial tiling)
    for the exact-engine temporal pipeline, in one vectorized gather.
    `window_range` restricts to a subset of windows.

    Returns (x, y, t, valid) of shape (W, warmup+n_emit, cap) with t rebased
    to the stream origin (int32), plus emit (W, warmup+n_emit) bool."""
    s_total = slices.num_slices
    n_emit = -(-s_total // n_windows)
    s_win = warmup + n_emit
    t0 = 0
    if s_total and slices.count[0] > 0:
        t0 = int(slices.t[0, 0])
    wr = np.arange(n_windows) if window_range is None else np.asarray(
        list(window_range))
    g = (wr[:, None] * n_emit - warmup
         + np.arange(s_win)[None, :])                      # (W, s_win) global
    ok = (g >= 0) & (g < s_total)
    gc = np.clip(g, 0, max(s_total - 1, 0))
    x = slices.x[gc].astype(np.int32)
    y = slices.y[gc].astype(np.int32)
    t = np.clip(slices.t[gc].astype(np.int64) - t0, 0,
                np.iinfo(np.int32).max).astype(np.int32)
    valid = slices.valid_mask()[gc] & ok[:, :, None]
    emit = np.broadcast_to(np.arange(s_win)[None, :] >= warmup,
                           (len(wr), s_win)).copy()
    if capacity and capacity < x.shape[2]:
        x, y, t, valid = (a[:, :, :capacity] for a in (x, y, t, valid))
    return x, y, t, valid, emit


def _window_u(emit: np.ndarray, n_emit: int, device) -> torch.Tensor:
    """u of each slice of a window: emitted slices so far / n_emit, as an
    f32 division, as JAX divides."""
    n_em = np.cumsum(emit).astype(np.float32)
    return torch.as_tensor(n_em / np.float32(n_emit), device=device)


def _gather_streams(streams, axis: mesh_mod.Axis, warmup: int):
    """The window's per-slice streams, warm-up dropped, all-gathered over
    the data axis: (W, S_emit, ...)."""
    return [mesh_mod.all_gather(torch.stack(list(s))[warmup:], axis) for s in streams]


def _fuse_cluster_tables(first_cent, first_ok, final_cent, final_ok,
                         axis: mesh_mod.Axis, cfg: EngineConfig):
    g = [mesh_mod.all_gather(a, axis) for a in (first_cent, first_ok, final_cent, final_ok)]
    return fuse_clusters(*g, cfg)


# --------------------------------------------------------------------------
# The exact engine over windows
# --------------------------------------------------------------------------

def make_temporal_exact_pipeline(mesh: mesh_mod.Mesh, n_windows: int, n_emit: int,
                                 warmup: int, cfg: EngineConfig = DEFAULT):
    """The exact (bit-parity) AEClustering engine over windows, one per
    index of the mesh's data axis, each preceded by a warm-up replay of the
    previous window's tail. Returns run(x, y, t, valid, emit) on this rank's
    window: (S, cap) tensors and an (S,) host bool array.

    Parity argument (bit for bit in the tests):
      - the sliding tMin window holds the last sz_buffer update times: once
        the warm-up holds >= sz_buffer deduped events, tbuf and tMin equal
        the sequential run's;
      - live members all arrived within the last sz_buffer updates, inside
        the warm-up, so memberships replay once the clusters converged;
      - cluster means are EWMAs whose pre-warm-up part halves per add at
        alpha = 0.5: clusters whose members turn over during the warm-up
        reach bit-equal means, up to slot and cid relabeling, which the
        cross-window chain reconciles.
    The engine is sequential per event within a window: the data axis is
    the only parallel axis (tiling would reorder the events)."""
    data_ax = mesh.axis(cfg.parallel.data_axis)
    ccap = cfg.cluster.max_clusters

    def run(x, y, t, valid, emit) -> TemporalExactOutput:
        dev = x.device
        # times are rebased to the stream origin: pin t0 = 0 so every window
        # shares the sequential run's clock
        state = aeclustering.init_state(cfg.cluster, device=dev)._replace(
            has_t0=torch.ones((), dtype=torch.bool, device=dev))
        cum = torch.zeros((), dtype=torch.int32, device=dev)
        first_cent = torch.zeros((ccap, 2), dtype=torch.float32, device=dev)
        first_ok = torch.zeros(ccap, dtype=torch.bool, device=dev)
        streams = [[] for _ in range(6)]
        for s in range(x.shape[0]):
            with span("slice"):
                e_em = bool(emit[s])
                state, view, cum = pipeline_mod.cluster_flow_step_exact(
                    state, x[s], y[s], t[s], valid[s], cfg, cum)
                dig = aeclustering.membership_digest(state, cfg.cluster)
                new_first = view.alive & ~first_ok & e_em
                first_cent = torch.where(new_first[:, None], view.centroid, first_cent)
                first_ok = first_ok | new_first
            for out, v in zip(streams, (view.alive & e_em, view.cid, view.n, view.mu,
                                        view.centroid, dig)):
                out.append(v)
        chain = _fuse_cluster_tables(first_cent, first_ok, streams[4][-1], streams[0][-1],
                                     data_ax, cfg)
        return TemporalExactOutput(*_gather_streams(streams, data_ax, warmup),
                                   cluster_chain=chain)

    return run


def _check_grid(mesh: mesh_mod.Mesh, cfg: EngineConfig, **sizes) -> None:
    got = {k: mesh.axis(getattr(cfg.parallel, f"{k}_axis")).size for k in sizes}
    if got != sizes:
        raise ValueError(f"the mesh's axes {got} do not match {sizes}")


def run_temporal_exact(slices: EventSlices, mesh: mesh_mod.Mesh, n_windows: int,
                       warmup: int = 4, cfg: EngineConfig = DEFAULT,
                       capacity: Optional[int] = None, device="cuda") -> TemporalExactOutput:
    """Window the sliced stream (no tiling) and run the exact engine on this
    rank's window (its data-axis index). Sizing: the warm-up slices must
    together hold >= cfg.cluster.sz_buffer deduped events for tMin parity."""
    _check_grid(mesh, cfg, data=n_windows)
    w = mesh.axis(cfg.parallel.data_axis).index
    x, y, t, valid, emit = window_events(slices, n_windows, warmup, capacity,
                                         window_range=range(w, w + 1))
    n_emit = x.shape[1] - warmup
    run = make_temporal_exact_pipeline(mesh, n_windows, n_emit, warmup, cfg)
    return run(*pipeline_mod._as_tensors(device, x[0], y[0], t[0], valid[0]), emit[0])


# --------------------------------------------------------------------------
# Cross-window fusion (replicated; runs after the per-window loops)
# --------------------------------------------------------------------------

def _chain_forward(next_ptr: torch.Tensor, exists: torch.Tensor) -> torch.Tensor:
    """Propagate head flat-ids forward along next pointers.

    next_ptr: (W, T) int32, the slot in window w+1 that continues (w, i), or
    -1; exists: (W, T) bool, tracklet present. Returns chain ids (W, T)
    int32 (the flat id of the chain's head; -1 absent)."""
    w, t = next_ptr.shape
    dev = next_ptr.device
    i32 = torch.int32
    flat = (torch.arange(w, dtype=i32, device=dev)[:, None] * t
            + torch.arange(t, dtype=i32, device=dev)[None, :])
    # heads: tracklets with no incoming pointer (the pointers are injective:
    # mutual nearest neighbours)
    incoming = torch.zeros((w, t), dtype=torch.bool, device=dev)
    for i in range(w - 1):
        nxt = next_ptr[i]
        incoming[i + 1] = torch.zeros(t + 1, dtype=torch.bool, device=dev).scatter(
            0, torch.where(nxt >= 0, nxt, t).long(), nxt >= 0)[:t]
    chain = torch.where(exists & ~incoming, flat, -1)
    for i in range(w - 1):
        nxt = next_ptr[i]
        src = chain[i]
        ok = (nxt >= 0) & (src >= 0)
        upd = torch.full((t + 1,), -1, dtype=i32, device=dev).scatter(
            0, torch.where(ok, nxt, t).long(), torch.where(ok, src, -1))[:t]
        chain[i + 1] = torch.where(upd >= 0, upd, chain[i + 1])
    return chain


def _stitch_ptrs(tail_pos, head_pos, tail_ok, head_ok, radius):
    """Mutual-nearest-neighbour links between one window's tails and the
    next window's heads: (T, 2) positions -> (T,) int32 next pointers (-1
    none); argmin takes the first index on ties, as jnp.argmin."""
    v = tail_pos[:, None, :] - head_pos[None, :, :]
    d = torch.sqrt((v * v).sum(2))
    d = torch.where(tail_ok[:, None] & head_ok[None, :], d, _BIG)
    j_of_i = d.argmin(1).to(torch.int32)
    i_of_j = d.argmin(0).to(torch.int32)
    best = d.amin(1)
    lane = torch.arange(tail_pos.shape[0], dtype=torch.int32, device=d.device)
    mutual = i_of_j[j_of_i.long()] == lane
    ok = tail_ok & mutual & (best <= radius)
    return torch.where(ok, j_of_i, -1)


def fuse_tracklets(blocks: TrackletBlocks, n_emit: int,
                   cfg: EngineConfig) -> RefinedTracks:
    """Replicated cross-window fusion of all-gathered tracklet blocks
    (fields with a leading window axis, (W, T, ...)): stitch (mutual nearest
    neighbour on boundary-extrapolated positions) -> chain ids -> Schur
    elimination of each window's interior parameter -> the reduced boundary
    system per chain, assembled and solved."""
    w, t = blocks.label.shape
    k = w * t
    dev = blocks.label.device
    f32, i32 = torch.float32, torch.int32
    tcfg = cfg.tracker
    stitch_radius = 2.0 * tcfg.max_distance
    gap = float(tcfg.frames_to_skip + 1) / n_emit

    exists = blocks.nobs > 0
    # extrapolated window-boundary positions (px/slice velocity x slack)
    tail_b = blocks.pos_last + blocks.vel_last * ((1.0 - blocks.u_last) * n_emit)[..., None]
    head_b = blocks.pos_first - blocks.vel_first * (blocks.u_first * n_emit)[..., None]
    tail_ok = exists & (blocks.u_last >= 1.0 - gap)
    head_ok = exists & (blocks.u_first <= gap)

    ptr_rows = [_stitch_ptrs(tail_b[i], head_b[i + 1], tail_ok[i], head_ok[i + 1],
                             stitch_radius) for i in range(w - 1)]
    ptr_rows.append(torch.full((t,), -1, dtype=i32, device=dev))
    chain = _chain_forward(torch.stack(ptr_rows), exists)      # (W, T)

    # --- Schur elimination of the interior parameter m_w (per tracklet)
    lam_m = 1e-6
    Hbb = blocks.H[..., :2, :2]                                # (W, T, 2, 2)
    Hbm = blocks.H[..., :2, 2]                                 # (W, T, 2)
    Hmm = blocks.H[..., 2, 2] + lam_m                          # (W, T)
    gb = blocks.g[..., :2, :]                                  # (W, T, 2, 2)
    gm = blocks.g[..., 2, :]                                   # (W, T, 2)
    S = Hbb - Hbm[..., :, None] * Hbm[..., None, :] / Hmm[..., None, None]
    gt = gb - Hbm[..., :, None] * gm[..., None, :] / Hmm[..., None, None]

    # --- the reduced boundary system per chain: window w couples
    # boundaries (w, w+1)
    contrib_A = torch.zeros((w, t, w + 1, w + 1), dtype=f32, device=dev)
    contrib_b = torch.zeros((w, t, w + 1, 2), dtype=f32, device=dev)
    for i in range(w):
        contrib_A[i, :, i:i + 2, i:i + 2] = S[i]
        contrib_b[i, :, i:i + 2] = gt[i]

    seg = torch.where(exists & (chain >= 0), chain, k).reshape(-1)
    inseg = seg < k

    def segsum(values):
        return masked_segment_sum(values.reshape(k, -1), seg, k, inseg)

    A = segsum(contrib_A).reshape(k, w + 1, w + 1)
    b = segsum(contrib_b).reshape(k, w + 1, 2)
    win_onehot = torch.eye(w, dtype=f32, device=dev)[:, None, :].expand(w, t, w)
    cover = segsum(win_onehot) > 0                             # (K, W)
    # boundary support: does the chain's tracklet in the adjacent window
    # reach the boundary? Within 1.5 slices of it (stricter than the
    # stitch gap, which allows a frames_to_skip coast)
    sup = 1.5 / n_emit
    near_s = win_onehot * (exists & (blocks.u_first <= sup)).to(f32)[..., None]
    near_e = win_onehot * (exists & (blocks.u_last >= 1.0 - sup)).to(f32)[..., None]
    cov_s = segsum(near_s) > 0                                 # (K, W)
    cov_e = segsum(near_e) > 0
    pad = torch.zeros((k, 1), dtype=torch.bool, device=dev)
    interior = torch.cat([pad, cover], 1) & torch.cat([cover, pad], 1)
    boundary_ok = (torch.cat([pad, cov_e], 1) | torch.cat([cov_s, pad], 1)
                   | interior)                                 # (K, W+1)
    n_obs = masked_segment_sum(blocks.nobs.reshape(-1), seg, k, inseg)
    length = cover.sum(1, dtype=i32)

    A = A + 1e-6 * torch.eye(w + 1, dtype=f32, device=dev)[None]
    sol = torch.linalg.solve(A, b)                             # (K, W+1, 2)

    # a chain is keyed at its head's flat id
    flat = (torch.arange(w, dtype=i32, device=dev)[:, None] * t
            + torch.arange(t, dtype=i32, device=dev)[None, :])
    head = torch.where((chain == flat) & exists, chain, k).reshape(-1).long()
    valid = torch.zeros(k + 1, dtype=torch.bool, device=dev).index_fill(0, head, True)[:k]
    return RefinedTracks(valid=valid & (length > 0), n_windows=length, n_obs=n_obs,
                         window_mask=cover, boundary_pos=sol, boundary_ok=boundary_ok)


def fuse_clusters(first_cent, first_ok, final_cent, final_ok,
                  cfg: EngineConfig) -> torch.Tensor:
    """Chain per-window cluster slots into stream-global ids.

    first_cent/final_cent: (W, C, 2) centroid at the first/last post-warm-up
    report of each slot; *_ok: (W, C) slot reported at all. Returns (W, C)
    int32 global chain ids (-1 where not reported)."""
    w, c = first_ok.shape
    radius = cfg.cluster.radius
    ptr_rows = [_stitch_ptrs(final_cent[i], first_cent[i + 1], final_ok[i],
                             first_ok[i + 1], radius) for i in range(w - 1)]
    ptr_rows.append(torch.full((c,), -1, dtype=torch.int32, device=first_ok.device))
    return _chain_forward(torch.stack(ptr_rows), final_ok | first_ok)


# --------------------------------------------------------------------------
# The (data x tile) temporal pipeline
# --------------------------------------------------------------------------

def make_temporal_pipeline(mesh: mesh_mod.Mesh, n_windows: int, n_tiles: int,
                           n_emit: int, warmup: int, cfg: EngineConfig = DEFAULT):
    """The (data, tile) grid's window loop of this rank. Returns run(x, y,
    t, valid, emit, armed): its window's slices of its tile, (S, cap)
    tensors (x, y, t int32, valid bool), and (S,) host bool arrays emit and
    armed -> TemporalOutput."""
    data_ax = mesh.axis(cfg.parallel.data_axis)
    tile_ax = mesh.axis(cfg.parallel.tile_axis)
    tile_w = -(-cfg.sensor.width // n_tiles)
    # tile-local NMS exactness bound (see tiling.tile_local_nms)
    assert tile_w > 2 * cfg.nms.box_size, (tile_w, cfg.nms.box_size)
    ccap = cfg.cluster.max_clusters
    halo = cfg.parallel.halo

    def run(x, y, t, valid, emit, armed) -> TemporalOutput:
        dev = x.device
        cl = fastcluster.init_state(cfg.cluster, device=dev)
        slab = torch.zeros((cfg.sensor.height, tile_w + 2 * halo), dtype=torch.int32,
                           device=dev)
        tracks = tracker_mod.init_state(cfg.tracker, device=dev)
        blocks = init_blocks(cfg.tracker.max_tracks, device=dev)
        first_cent = torch.zeros((ccap, 2), dtype=torch.float32, device=dev)
        first_ok = torch.zeros(ccap, dtype=torch.bool, device=dev)
        us = _window_u(emit, n_emit, dev)
        streams = [[] for _ in range(10)]
        for s in range(x.shape[0]):
            with span("slice"):
                e_em = bool(emit[s])
                # cluster path: per-tile dedup -> distributed slice update
                ded = hash_dedup.dedup_mask(x[s], y[s], valid[s], cfg.dedup, cfg.sensor)
                cl, cl_out = fastcluster.update_slice_distributed(
                    cl, x[s], y[s], ded.unique_mask, tile_ax, cfg.cluster, cfg.sensor)
                # corner path: SAE slab + halos -> eFAST -> NMS -> tracker
                slab, tracks, co_out = tiling.corner_tile_body(
                    slab, tracks, int(armed[s]), x[s], y[s], t[s], valid[s], tile_ax,
                    tile_w, cfg)
                blocks = _blocks_update(blocks, tracks, us[s], e_em)
                new_first = cl_out.reported & ~first_ok & e_em
                first_cent = torch.where(new_first[:, None], cl_out.centroid, first_cent)
                first_ok = first_ok | new_first
            for out, v in zip(streams, (
                    cl_out.reported & e_em, cl_out.cid, cl_out.n, cl_out.centroid,
                    cl_out.flow, co_out.num_corners, co_out.track_active & e_em,
                    co_out.track_label, co_out.track_pos, co_out.track_vel)):
                out.append(v)

        # ---- fusion: the windows' summaries all-gathered over the data axis;
        # the final post-warm-up cluster table is the last emitted slice's
        g_blocks = TrackletBlocks(*(mesh_mod.all_gather(a, data_ax) for a in blocks))
        refined = fuse_tracklets(g_blocks, n_emit, cfg)
        chain = _fuse_cluster_tables(first_cent, first_ok, streams[3][-1], streams[0][-1],
                                     data_ax, cfg)
        return TemporalOutput(*_gather_streams(streams, data_ax, warmup),
                              refined=refined, cluster_chain=chain)

    return run


def run_temporal(slices: EventSlices, mesh: mesh_mod.Mesh, n_windows: int,
                 n_tiles: int, warmup: int = 8, cfg: EngineConfig = DEFAULT,
                 capacity: Optional[int] = None, device="cuda") -> TemporalOutput:
    """Window and tile the sliced stream and run this rank's window and tile
    (its data- and tile-axis indices). Each rank buckets and materializes
    only its own window."""
    _check_grid(mesh, cfg, data=n_windows, tile=n_tiles)
    w = mesh.axis(cfg.parallel.data_axis).index
    k = mesh.axis(cfg.parallel.tile_axis).index
    x, y, t, valid, emit, armed = window_tile_events(
        slices, n_windows, n_tiles, warmup, cfg, capacity, window_range=range(w, w + 1))
    n_emit = x.shape[2] - warmup
    run = make_temporal_pipeline(mesh, n_windows, n_tiles, n_emit, warmup, cfg)
    return run(*pipeline_mod._as_tensors(device, x[0, k], y[0, k], t[0, k], valid[0, k]),
               emit[0], armed[0])
