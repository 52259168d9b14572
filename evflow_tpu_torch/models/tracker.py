"""CornerTracker with grouping (counterpart of evflow_tpu/models/tracker.py).

Fixed (T,) track slots. The reference's two sequential loops are exact
fixpoints: greedy association in creation order as parallel commit rounds,
and star-shaped greedy grouping as a lexicographic maximal independent set
on the group-radius disk graph. Each loop checks convergence on the host,
one device-to-host sync per round.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from evflow_tpu.config import TrackerConfig

_BIG = 2**31 - 1
_F32MAX = 3.0e38


class TrackState(NamedTuple):
    active: torch.Tensor       # bool (T,)
    label: torch.Tensor        # int32 (T,)
    seq: torch.Tensor          # int32 (T,) creation order (deque order key)
    pos: torch.Tensor          # float32 (T, 2)
    frame_count: torch.Tensor  # int32 (T,)
    frames_since: torch.Tensor # int32 (T,) frames since last detection
    hist: torch.Tensor         # float32 (T, H, 2) newest-first position history
    hist_len: torch.Tensor     # int32 (T,)
    velocity: torch.Tensor     # float32 (T, 2)
    dir_cur: torch.Tensor      # float32 (T, 2) damped direction observer
    group_id: torch.Tensor     # int32 (T,)
    next_label: torch.Tensor   # int32 ()
    next_seq: torch.Tensor     # int32 ()


class GroupView(NamedTuple):
    """Per-group outputs, indexed by group id (fixed capacity = T)."""
    exists: torch.Tensor       # bool (T,)
    centroid: torch.Tensor     # float32 (T, 2)
    avg_velocity: torch.Tensor # float32 (T, 2)
    radius: torch.Tensor       # float32 (T,)
    size: torch.Tensor         # int32 (T,)


def init_state(cfg: TrackerConfig = TrackerConfig(), device="cpu") -> TrackState:
    t, h = cfg.max_tracks, cfg.history
    i32, f32 = torch.int32, torch.float32
    return TrackState(
        active=torch.zeros(t, dtype=torch.bool, device=device),
        label=torch.full((t,), -1, dtype=i32, device=device),
        seq=torch.full((t,), _BIG, dtype=i32, device=device),
        pos=torch.zeros((t, 2), dtype=f32, device=device),
        frame_count=torch.zeros(t, dtype=i32, device=device),
        frames_since=torch.zeros(t, dtype=i32, device=device),
        hist=torch.zeros((t, h, 2), dtype=f32, device=device),
        hist_len=torch.zeros(t, dtype=i32, device=device),
        velocity=torch.zeros((t, 2), dtype=f32, device=device),
        dir_cur=torch.zeros((t, 2), dtype=f32, device=device),
        group_id=torch.full((t,), -1, dtype=i32, device=device),
        next_label=torch.zeros((), dtype=i32, device=device),
        next_seq=torch.zeros((), dtype=i32, device=device),
    )


def _norm(v: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """sqrt(sum(v*v)), the form jnp.linalg.norm takes."""
    return torch.sqrt((v * v).sum(dim, keepdim=keepdim))


def _predict(state: TrackState, cfg: TrackerConfig) -> torch.Tensor:
    """predictPosition for every slot (group_track.cpp:304-319)."""
    pred = state.pos + state.velocity
    speed = _norm(state.velocity, 1, keepdim=True)
    conf = torch.clamp_min(
        1.0 - state.frames_since.to(torch.float32) / cfg.frames_to_skip, 0.0)
    coasting = (state.frames_since > 0)[:, None]
    dir_pred = state.pos + state.dir_cur * speed
    blended = pred * (1.0 - conf[:, None]) + dir_pred * conf[:, None]
    return torch.where(coasting, blended, pred)


def _calc_direction(hist: torch.Tensor, hist_len: torch.Tensor,
                    cfg: TrackerConfig) -> torch.Tensor:
    """calculateDirection (:233-271): weighted mean of normalized steps."""
    h = hist.shape[1]
    steps = hist[:, :-1, :] - hist[:, 1:, :]           # (T, H-1, 2) newest first
    mag = _norm(steps, 2)
    k = torch.arange(h - 1, dtype=torch.float32, device=hist.device)
    w = cfg.weight_decay ** k                          # 0.8^(i-1), i from 1
    ii = torch.arange(1, h, device=hist.device)
    valid = (ii[None, :] < hist_len[:, None]) & (mag > 0)
    wv = torch.where(valid, w[None, :], 0.0)
    unit = torch.where(valid[:, :, None],
                       steps / torch.clamp_min(mag, 1e-20)[:, :, None], 0.0)
    wsum = wv.sum(1)
    wd = (unit * wv[:, :, None]).sum(1)
    wd = torch.where((wsum > 0)[:, None],
                     wd / torch.clamp_min(wsum, 1e-20)[:, None], 0.0)
    m = _norm(wd, 1, keepdim=True)
    wd = torch.where(m > 0, wd / torch.clamp_min(m, 1e-20), wd)
    return torch.where((hist_len >= 2)[:, None], wd, 0.0)


def _estimate_velocity(hist, hist_len, dir_cur, cfg: TrackerConfig) -> torch.Tensor:
    """estimateVelocity (:273-302)."""
    h = hist.shape[1]
    steps = hist[:, :-1, :] - hist[:, 1:, :]
    ii = torch.arange(1, h, device=hist.device)
    valid = ii[None, :] < hist_len[:, None]
    cnt = valid.sum(1)
    avg = torch.where(valid[:, :, None], steps, 0.0).sum(1) \
        / torch.clamp_min(cnt, 1)[:, None].to(torch.float32)
    speed = _norm(avg, 1, keepdim=True)
    blended = avg * (1.0 - cfg.smoothing) + dir_cur * speed * cfg.smoothing
    v = torch.where(speed > 0, blended, avg)
    return torch.where((hist_len >= 2)[:, None], v, 0.0)


def _push_history(hist, hist_len, pos, do):
    new_hist = torch.cat([pos[:, None, :], hist[:, :-1, :]], 1)
    hist = torch.where(do[:, None, None], new_hist, hist)
    hist_len = torch.where(do, torch.clamp_max(hist_len + 1, hist.shape[1]), hist_len)
    return hist, hist_len


def _associate(dist_td, reach, eligible, seqv, det_valid, max_distance):
    """Greedy association in seq order as parallel commit rounds (see the
    JAX module for the serial-dictatorship proof). Returns (T,) int32 match
    index, -1 for unmatched tracks."""
    t, d = dist_td.shape
    det_iota = torch.arange(d, dtype=torch.int32, device=dist_td.device)
    match_idx = torch.full((t,), -1, dtype=torch.int32, device=dist_td.device)
    while True:
        matched_t = match_idx >= 0
        det_taken = ((match_idx[:, None] == det_iota[None, :])
                     & matched_t[:, None]).any(0)
        open_t = eligible & ~matched_t
        dmask = torch.where((det_valid & ~det_taken)[None, :], dist_td, _F32MAX)
        best = dmask.argmin(1).to(torch.int32)
        best_dist = dmask.amin(1)
        propose = open_t & (best_dist < max_distance)
        pseq = torch.where(propose, seqv, _BIG)
        onehot = propose[:, None] & (best[:, None] == det_iota[None, :])   # (T, D)
        # reach rule: commit if no earlier-seq OPEN track can reach best
        minseq_reach = torch.where(open_t[:, None] & reach, seqv[:, None],
                                   _BIG).amin(0)                         # (D,)
        reach_ok = ~(onehot & (minseq_reach[None, :] < pseq[:, None])).any(1)
        # prefix rule: the seq-prefix of proposers with distinct proposals
        mindup = torch.where(onehot, pseq[:, None], _BIG).amin(0)       # (D,)
        dup = (onehot & (mindup[None, :] < pseq[:, None])).any(1)
        first_dup = torch.where(dup, pseq, _BIG).amin()
        commit = propose & ((pseq < first_dup) | reach_ok)
        match_idx = torch.where(commit, best, match_idx)
        if not bool(commit.any()):
            return match_idx


def _group_seeds(detected, within, seqd):
    """Lexicographic MIS fixpoint: a detected track seeds iff no earlier-seq
    seed lies within the group radius."""
    is_seed = detected
    while True:
        blocked = (within & is_seed[None, :] & (seqd[None, :] < seqd[:, None])).any(1)
        new = detected & ~blocked
        if torch.equal(new, is_seed):
            return new
        is_seed = new


def _scatter_max(values, segment_ids, num_segments, fill):
    """Per-segment max with `fill` as the floor (segment.py:scatter_max)."""
    init = torch.full((num_segments,), fill, dtype=values.dtype, device=values.device)
    return init.scatter_reduce(0, segment_ids.long(), values, "amax")


def update(state: TrackState, det_x: torch.Tensor, det_y: torch.Tensor,
           det_valid: torch.Tensor, cfg: TrackerConfig = TrackerConfig()
           ) -> Tuple[TrackState, GroupView]:
    """One tracker step over (D,) filtered corner detections."""
    t = state.active.shape[0]
    d = det_x.shape[0]
    dev = det_x.device
    det = torch.stack([det_x, det_y], 1).to(torch.float32)

    predicted = _predict(state, cfg)
    eligible = state.active & (state.frames_since <= cfg.frames_to_skip)

    # ---- greedy association
    dist_td = _norm(predicted[:, None, :] - det[None, :, :], 2)
    seqv = torch.where(eligible, state.seq, _BIG)
    reach = dist_td < cfg.max_distance
    match_idx = _associate(dist_td, reach, eligible, seqv, det_valid,
                           cfg.max_distance)

    matched = match_idx >= 0
    det_iota = torch.arange(d, dtype=torch.int32, device=dev)
    det_matched = ((match_idx[:, None] == det_iota[None, :]) & matched[:, None]).any(0)
    mpos = det[match_idx.clamp(0, d - 1)]

    # ---- correct matched / coast unmatched
    pos = torch.where(matched[:, None], mpos,
                      torch.where((state.active & ~matched)[:, None], predicted,
                                  state.pos))
    frames_since = torch.where(matched, 0,
                               torch.where(state.active, state.frames_since + 1,
                                           state.frames_since))
    frame_count = torch.where(matched, state.frame_count + 1, state.frame_count)
    hist, hist_len = _push_history(state.hist, state.hist_len, pos, state.active)

    new_dir = _calc_direction(hist, hist_len, cfg)
    dir_cur = torch.where(matched[:, None],
                          state.dir_cur * cfg.damping + new_dir * (1.0 - cfg.damping),
                          state.dir_cur)
    velocity = torch.where(state.active[:, None],
                           _estimate_velocity(hist, hist_len, dir_cur, cfg),
                           state.velocity)

    # ---- spawn: the k-th unmatched detection takes the k-th free slot
    free = ~state.active
    unmatched_det = det_valid & ~det_matched
    det_rank = torch.cumsum(unmatched_det.to(torch.int32), 0, dtype=torch.int32) - 1
    n_unmatched = unmatched_det.sum(dtype=torch.int32)
    n_free = free.sum(dtype=torch.int32)
    n_spawned = torch.minimum(n_unmatched, n_free)
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    spawned_slot = free & (free_rank < n_spawned)
    # rank -> detection inverse map; lanes beyond rank t park in slot t
    rank_dst = torch.where(unmatched_det & (det_rank < t), det_rank, t).long()
    det_at_rank = torch.zeros(t + 1, dtype=torch.int32, device=dev).scatter(
        0, rank_dst, det_iota)[:t]
    didx = det_at_rank[free_rank.clamp(0, t - 1)]
    spawn_pos = det[didx.clamp(0, d - 1)]

    active = state.active | spawned_slot
    label = torch.where(spawned_slot, state.next_label + free_rank, state.label)
    seq = torch.where(spawned_slot, state.next_seq + free_rank, state.seq)
    pos = torch.where(spawned_slot[:, None], spawn_pos, pos)
    frame_count = torch.where(spawned_slot, 1, frame_count)
    frames_since = torch.where(spawned_slot, 0, frames_since)
    velocity = torch.where(spawned_slot[:, None], 0.0, velocity)
    dir_cur = torch.where(spawned_slot[:, None], 0.0, dir_cur)
    spawn_hist = torch.cat(
        [spawn_pos[:, None, :], torch.zeros_like(hist[:, 1:, :])], 1)
    hist = torch.where(spawned_slot[:, None, None], spawn_hist, hist)
    hist_len = torch.where(spawned_slot, 1, hist_len)
    next_label = state.next_label + n_spawned
    next_seq = state.next_seq + n_spawned

    # ---- prune
    prune = active & ((frames_since > cfg.frames_to_skip)
                      | (frame_count > cfg.max_frames))
    active = active & ~prune

    # ---- grouping: star-shaped greedy from the first unprocessed detected
    # track; membership = the min-seq seed within radius; group ids number
    # seeds in seq order
    detected = active & (frames_since == 0)
    within = _norm(pos[:, None, :] - pos[None, :, :], 2) <= cfg.group_radius
    seqd = torch.where(detected, seq, _BIG)
    is_seed = _group_seeds(detected, within, seqd)
    seed_seq = torch.where(is_seed, seq, _BIG)
    cand = detected[:, None] & is_seed[None, :] & within
    seed_slot = torch.where(cand, seed_seq[None, :], _BIG).argmin(1)
    has_seed = cand.any(1)
    seq_rank = (is_seed[None, :] & (seq[None, :] < seq[:, None])).sum(
        1, dtype=torch.int32)
    group_id = torch.where(detected & has_seed, seq_rank[seed_slot], -1)

    gid_ok = group_id >= 0
    gids = torch.where(gid_ok, group_id, t)
    # per-group sums as one-hot matmuls: deterministic on the card
    member = (gids[None, :] == torch.arange(t, device=dev)[:, None]).to(torch.float32)
    gsize = member.sum(1)
    gpos = member @ torch.where(gid_ok[:, None], pos, 0.0)
    gvel = member @ torch.where(gid_ok[:, None], velocity, 0.0)
    denom = torch.clamp_min(gsize, 1.0)[:, None]
    centroid = gpos / denom
    avg_vel = gvel / denom
    gclip = group_id.clamp(0, t - 1)
    dist_to_centroid = _norm(pos - centroid[gclip], 1)
    radius = _scatter_max(torch.where(gid_ok, dist_to_centroid, 0.0), gids,
                          t + 1, 0.0)[:t]
    exists = gsize > 0

    # blend member velocities with the group average (:388-397)
    blend = gid_ok & detected
    velocity = torch.where(blend[:, None],
                           velocity * (1.0 - cfg.group_blend)
                           + avg_vel[gclip] * cfg.group_blend,
                           velocity)

    new_state = TrackState(
        active=active, label=label, seq=torch.where(active, seq, _BIG), pos=pos,
        frame_count=frame_count, frames_since=frames_since,
        hist=hist, hist_len=hist_len, velocity=velocity, dir_cur=dir_cur,
        group_id=group_id, next_label=next_label, next_seq=next_seq,
    )
    groups = GroupView(exists=exists, centroid=centroid, avg_velocity=avg_vel,
                       radius=radius, size=gsize.to(torch.int32))
    return new_state, groups
