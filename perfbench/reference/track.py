"""Frozen copy of the program's plain track pipeline (`hd_track_q8`): both
chains per slice, in plain PyTorch on whatever device it is given.

- cluster chain: hash dedup (first occupant per bucket) -> fast clustering
  (gated L1 assignment to the slice-start means, seeding from radius-sized
  grid cells, stream-order EWMA means, a ring of per-slice aggregates, merges
  by min-order label propagation) -> centroid flow;
- corner chain: SAE scatter-max -> one representative candidate per touched
  pixel (its last event), capped in stream order -> eFAST ring test against
  the surface -> stream-order compaction to the NMS capacity -> greedy box
  suppression -> the tracker (`tracker.py`). At q = micro_slices > 1 each
  slice is cut into q sub-slices, each scattered and then detected.

It imports nothing of the program. `cfg` is the configuration file as a
dict. The float math of the cluster chain and the tracker runs in
`fdtype`: float32, as the configuration states, or bfloat16 for the
control. States and outputs are NamedTuples whose field names are the
program's, so a run can hand the program's state over where it must
(PERF.md says where).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import tracker as tracker_mod

_BIG = 2**31 - 1


# --------------------------------------------------------------------------
# dedup
# --------------------------------------------------------------------------

def dedup_mask(x, y, valid, cfg):
    """(first-occupant mask, unique count, repeated count) of one slice."""
    d, s = cfg["dedup"], cfg["sensor"]
    n = x.shape[0]
    if d["exact"]:
        nkeys = (s["width"] + 1) * (s["height"] + 1)
        key = y * (s["width"] + 1) + x
    else:
        nkeys = d["num_buckets"]
        key = (x * d["hash_mul_x"] + y * d["hash_mul_y"]) % nkeys
    ok = valid & (x >= 0) & (x <= s["width"]) & (y >= 0) & (y <= s["height"])
    key = torch.where(ok, key, nkeys).to(torch.int64)
    lane = torch.arange(n, dtype=torch.int64, device=x.device)
    sp = torch.sort(key * n + lane).values
    sk, sl = sp // n, sp % n
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       sk[1:] != sk[:-1]]) & (sk < nkeys)
    mask = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(0, sl, first)
    run2 = first & torch.cat([sk[1:] == sk[:-1],
                              torch.zeros(1, dtype=torch.bool, device=x.device)])
    return mask, first.sum(dtype=torch.int32), run2.sum(dtype=torch.int32)


# --------------------------------------------------------------------------
# fast clustering
# --------------------------------------------------------------------------

class FastState(NamedTuple):
    alive: torch.Tensor
    cid: torch.Tensor
    corder: torch.Tensor
    mu: torch.Tensor
    ring_count: torch.Tensor
    ring_sum: torch.Tensor
    ring_head: torch.Tensor
    centroid_prev: torch.Tensor
    has_prev: torch.Tensor
    next_cid: torch.Tensor
    next_order: torch.Tensor


def init_fast(cfg, device, fdtype=torch.float32) -> FastState:
    c, r = cfg["cluster"]["max_clusters"], cfg["fastcluster"]["window_slices"]
    i32 = torch.int32
    return FastState(
        alive=torch.zeros(c, dtype=torch.bool, device=device),
        cid=torch.full((c,), -1, dtype=i32, device=device),
        corder=torch.full((c,), _BIG, dtype=i32, device=device),
        mu=torch.zeros((c, 2), dtype=fdtype, device=device),
        ring_count=torch.zeros((c, r), dtype=i32, device=device),
        ring_sum=torch.zeros((c, r, 2), dtype=fdtype, device=device),
        ring_head=torch.zeros((), dtype=i32, device=device),
        centroid_prev=torch.zeros((c, 2), dtype=fdtype, device=device),
        has_prev=torch.zeros(c, dtype=torch.bool, device=device),
        next_cid=torch.zeros((), dtype=i32, device=device),
        next_order=torch.zeros((), dtype=i32, device=device))


def _log1m(alpha: float) -> float:
    return float(torch.log1p(torch.tensor(-alpha, dtype=torch.float32)))


def assign_manhattan(x, y, mu, alive, radius):
    """Gated first-index L1 argmin of each event over the alive means."""
    d = (x.to(mu.dtype)[:, None] - mu[None, :, 0]).abs() \
        + (y.to(mu.dtype)[:, None] - mu[None, :, 1]).abs()
    d = torch.where(alive[None, :], d, torch.inf)
    best = d.argmin(1).to(torch.int32)
    return torch.where(d.amin(1) <= radius, best, -1)


def cluster_stats(labels, x, y, alpha, c):
    """(C, 5) [k, sum x, sum y, sum w x, sum w y], w = alpha (1-alpha)^(k-1-rank)
    with rank the member's stream-order position in its cluster."""
    n = labels.shape[0]
    iota = torch.arange(c, dtype=labels.dtype, device=labels.device)
    onehot = (labels[:, None] == iota[None, :]).to(x.dtype)
    p = torch.cumsum(onehot, 0)
    k = p[-1] if n else torch.zeros(c, dtype=x.dtype, device=labels.device)
    expo = torch.clamp(k[None, :] - p, 0.0, 80.0)
    w = (onehot * (alpha * torch.exp(expo * _log1m(alpha)))).sum(1)
    member = (labels >= 0)[:, None]
    feats = torch.stack([torch.ones_like(x), x, y, w * x, w * y], 1)
    return onehot.T @ torch.where(member, feats, 0.0)


def _seed(state: FastState, x, y, valid, assigned, cfg):
    cl = cfg["cluster"]
    c, grid_cells = cl["max_clusters"], cfg["fastcluster"]["grid_cells"]
    dev, i32, fdt = x.device, torch.int32, state.mu.dtype
    cell_w = max(int(cl["radius"]), 1)
    ncx = -(-cfg["sensor"]["width"] // cell_w)
    cell = (y // cell_w) * ncx + (x // cell_w)
    cell = torch.where(valid & ~assigned, cell % grid_cells, grid_cells)
    feats = torch.stack([torch.ones_like(x), x, y], 1).to(torch.int64)
    agg = torch.zeros((grid_cells + 1, 3), dtype=torch.int64, device=dev).index_add(
        0, cell.long(), feats)[:grid_cells]
    cell_cnt = agg[:, 0].to(i32)
    cell_sum = agg[:, 1:].to(fdt)
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
        / torch.clamp_min(cell_cnt[cell_of_rank], 1)[:, None].to(fdt)
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
        ring_count=torch.where(seeded[:, None], 0, state.ring_count),
        ring_sum=torch.where(seeded[:, None, None], 0.0, state.ring_sum),
        has_prev=state.has_prev & ~seeded,
        centroid_prev=torch.where(seeded[:, None], 0.0, state.centroid_prev))
    slot_for_pos = torch.full((c + 1,), c, dtype=i32, device=dev).scatter(
        0, pos_of_slot.long(), torch.arange(c, dtype=i32, device=dev))[:c]
    ev_pos = occ_rank[cell.clamp(0, grid_cells - 1)]
    ev_seeded = valid & ~assigned & (cell < grid_cells) & (ev_pos < n_new)
    ev_slot = torch.where(ev_seeded, slot_for_pos[ev_pos.clamp(0, c - 1)], -1)
    return fields, ev_slot


def fast_update(state: FastState, x, y, valid, cfg, counts=None):
    """One slice of fast clustering: (new state, (alive, reported, cid, n,
    centroid, flow))."""
    cl = cfg["cluster"]
    c, radius, alpha = cl["max_clusters"], cl["radius"], cl["alpha"]
    dev, i32, fdt = x.device, torch.int32, state.mu.dtype
    if counts is not None:
        counts.setdefault("alive_at_start", []).append(int(state.alive.sum()))
    px, py = x.to(fdt), y.to(fdt)
    best = assign_manhattan(x, y, state.mu, state.alive, radius)
    assigned = valid & (best >= 0)
    labels = torch.where(assigned, best, -1)
    f, ev_slot = _seed(state, x, y, valid, assigned, cfg)
    labels = torch.where(ev_slot >= 0, ev_slot, labels)
    member = labels >= 0
    sums = cluster_stats(labels, px, py, alpha, c)
    k_i = sums[:, 0].to(i32)
    decay = torch.exp(torch.clamp(sums[:, 0], 0.0, 80.0) * _log1m(alpha))
    mu = torch.where((k_i > 0)[:, None], decay[:, None] * f["mu"] + sums[:, 3:5], f["mu"])
    head = state.ring_head.reshape(1).long()
    rc = f["ring_count"].index_copy(1, head, k_i[:, None])
    rs = f["ring_sum"].index_copy(1, head, sums[:, None, 1:3])
    n_window = rc.sum(1, dtype=i32)

    alive, corder = f["alive"], f["corder"]
    dmu = (mu[:, None, 0] - mu[None, :, 0]).abs() + (mu[:, None, 1] - mu[None, :, 1]).abs()
    adj = (dmu <= radius) & alive[:, None] & alive[None, :]
    comp = torch.where(alive, corder, _BIG)
    for _ in range(8):
        comp = torch.minimum(comp, torch.where(adj, comp[None, :], _BIG).amin(1))
    is_root = alive & (comp == corder)
    eq = alive[None, :] & (corder[None, :] == comp[:, None])
    root_slot = eq.to(i32).argmax(1)
    merged_into = torch.where(alive, root_slot, torch.arange(c, device=dev)).to(i32)
    eqt = eq.to(fdt).T
    wm = n_window.to(fdt)
    mu_num = eqt @ (wm[:, None] * mu)
    mu_den = eqt @ wm
    r = rc.shape[1]
    rc = (eqt.float() @ rc.float()).to(i32)
    rs = (eqt @ rs.reshape(c, r * 2)).reshape(c, r, 2)
    mu = torch.where(is_root[:, None], mu_num / torch.clamp_min(mu_den, 1.0)[:, None], mu)
    rc = torch.where(is_root[:, None], rc, 0)
    rs = torch.where(is_root[:, None, None], rs, 0.0)
    labels = torch.where(member, merged_into[labels.clamp(0, c - 1)], labels)
    n_window = rc.sum(1, dtype=i32)
    centroid = rs.sum(1) / torch.clamp_min(n_window, 1)[:, None].to(fdt)
    alive = is_root & (n_window > 0)
    reported = alive & (n_window >= cl["min_n"])
    has_prev = f["has_prev"]
    flow = torch.where((reported & has_prev)[:, None], centroid - f["centroid_prev"], 0.0)
    centroid_prev = torch.where(reported[:, None], centroid, f["centroid_prev"])
    has_prev = has_prev | reported
    new_state = FastState(
        alive=alive, cid=f["cid"], corder=torch.where(alive, corder, _BIG), mu=mu,
        ring_count=rc, ring_sum=rs, ring_head=(state.ring_head + 1) % r,
        centroid_prev=centroid_prev, has_prev=has_prev & alive,
        next_cid=f["next_cid"], next_order=f["next_order"])
    return new_state, (alive, reported, f["cid"], n_window, centroid, flow)


# --------------------------------------------------------------------------
# corners: SAE, eFAST, NMS
# --------------------------------------------------------------------------

CIRCLE3 = np.array(
    [[0, 3], [1, 3], [2, 2], [3, 1], [3, 0], [3, -1], [2, -2], [1, -3],
     [0, -3], [-1, -3], [-2, -2], [-3, -1], [-3, 0], [-3, 1], [-2, 2], [-1, 3]],
    dtype=np.int32)
CIRCLE4 = np.array(
    [[0, 4], [1, 4], [2, 3], [3, 2], [4, 1], [4, 0], [4, -1], [3, -2], [2, -3],
     [1, -4], [0, -4], [-1, -4], [-2, -3], [-3, -2], [-4, -1], [-4, 0], [-4, 1],
     [-3, 2], [-2, 3], [-1, 4]],
    dtype=np.int32)


def drop_index(i, dim):
    """A negative index wraps once; what is still outside [0, dim) drops."""
    i = torch.where(i < 0, i + dim, i)
    return i, (i >= 0) & (i < dim)


def update_sae(sae, x, y, t, valid):
    h, w = sae.shape
    yi, oky = drop_index(y, h)
    xi, okx = drop_index(x, w)
    keep = oky & okx
    tval = torch.where(valid & keep, t.to(sae.dtype), torch.iinfo(sae.dtype).min)
    flat = torch.where(keep, yi * w + xi, 0).long()
    return sae.reshape(-1).scatter_reduce(0, flat, tval, "amax").reshape(h, w)


def _sliding(x, length, op, dim):
    w = x.shape[dim]
    p, cur = 1, x
    while 2 * p <= length:
        cur = op(cur.narrow(dim, 0, cur.shape[dim] - p), cur.narrow(dim, p, cur.shape[dim] - p))
        p *= 2
    out_w = w - length + 1
    if p < length:
        return op(cur.narrow(dim, 0, out_w), cur.narrow(dim, length - p, out_w))
    return cur.narrow(dim, 0, out_w)


def streak_any(ring, smin, smax):
    """Some arc of length smin..smax whose every sample is newer than every
    off-arc sample, with the two boundary conditions (indices mod R)."""
    r, dim = ring.shape[1], 1
    ring2 = torch.cat([ring, ring], dim)
    cond1 = ring >= torch.roll(ring, 1, dim)
    found = None
    for s in range(smin, smax + 1):
        arc_min = _sliding(ring2, s, torch.minimum, dim).narrow(dim, 0, r)
        off_max = _sliding(ring2, r - s, torch.maximum, dim).narrow(dim, s, r)
        cond2 = ring2.narrow(dim, s - 1, r) >= ring2.narrow(dim, s, r)
        ok = (cond1 & cond2 & (off_max < arc_min)).any(dim)
        found = ok if found is None else found | ok
    return found


def detect_corners(sae, x, y, valid, cfg):
    e, s = cfg["efast"], cfg["sensor"]
    h, w = sae.shape
    cs = e["border"]
    cand = valid & (x >= cs) & (x < s["width"] - cs) & (y >= cs) & (y < s["height"] - cs)
    dyx = np.concatenate([CIRCLE3, CIRCLE4])
    dy, dx = dyx[:, 0].tolist(), dyx[:, 1].tolist()
    if not e["group_track_axis_order"]:
        dy, dx = dx, dy
    dy = torch.tensor(dy, dtype=y.dtype, device=y.device)
    dx = torch.tensor(dx, dtype=x.dtype, device=x.device)
    rows = (y[:, None] + dy[None, :]).clamp(0, h - 1)
    cols = (x[:, None] + dx[None, :]).clamp(0, w - 1)
    rings = sae[rows, cols]
    n3 = len(CIRCLE3)
    f3 = streak_any(rings[:, :n3], e["streak3_min"], e["streak3_max"])
    f4 = streak_any(rings[:, n3:], e["streak4_min"], e["streak4_max"])
    return cand & f3 & f4


def compact(keep, cap, *cols):
    n = keep.shape[0]
    lane = torch.arange(n, dtype=torch.int32, device=keep.device)
    order = torch.sort(torch.where(keep, lane, n), stable=True).indices
    valid = torch.arange(cap, device=keep.device) \
        < torch.clamp_max(keep.sum(dtype=torch.int32), cap)
    out = []
    for col in cols:
        col = col[order]
        if cap > n:
            col = torch.nn.functional.pad(col, (0, cap - n))
        out.append(torch.where(valid, col[:cap], 0))
    return (*out, valid)


def accept_corners(x, y, valid, cfg):
    """Greedy first-come box suppression as its unique fixpoint."""
    c = x.shape[0]
    reach = 2 * (cfg["nms"]["box_size"] // 2)
    overlap = ((x[:, None] - x[None, :]).abs() <= reach) \
        & ((y[:, None] - y[None, :]).abs() <= reach)
    lane = torch.arange(c, device=x.device)
    sup = overlap & (lane[:, None] > lane[None, :]) & valid[:, None] & valid[None, :]
    acc = valid
    while True:
        new = valid & ~(sup & acc[None, :]).any(1)
        if torch.equal(new, acc):
            return acc, acc.sum(dtype=torch.int32)
        acc = new


def representative_candidates(x, y, valid, m, cfg):
    """Each touched pixel's last lane, compacted in stream order to m lanes:
    (cx, cy, cvalid, dropped)."""
    n = x.shape[0]
    w1 = cfg["sensor"]["width"] + 1
    off = w1 * (cfg["sensor"]["height"] + 1)
    lane = torch.arange(n, dtype=torch.int64, device=x.device)
    pixkey = torch.where(valid, y * w1 + x, off).to(torch.int64)
    order = torch.sort(pixkey * n + (n - 1 - lane)).indices
    skey = pixkey[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       skey[1:] != skey[:-1]]) & (skey < off)
    n_rep = first.sum(dtype=torch.int32)
    keep = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(0, order, first)
    cx, cy, cvalid = compact(keep, m, x, y)
    return cx, cy, cvalid, torch.clamp_min(n_rep - m, 0)


# --------------------------------------------------------------------------
# the two chains
# --------------------------------------------------------------------------

class CornerState(NamedTuple):
    sae: torch.Tensor
    tracks: tracker_mod.TrackState
    slice_idx: torch.Tensor


def init_corner(cfg, device, fdtype=torch.float32) -> CornerState:
    s = cfg["sensor"]
    return CornerState(
        sae=torch.zeros((s["height"], s["width"]), dtype=torch.int32, device=device),
        tracks=tracker_mod.init_state(cfg["tracker"], device, fdtype),
        slice_idx=torch.zeros((), dtype=torch.int32, device=device))


def corner_step(state: CornerState, x, y, t, valid, cfg, counts=None):
    """One slice of the corner chain: (new state, output dict)."""
    e = cfg["efast"]
    m, q = e["max_candidates"], e["micro_slices"]
    armed = state.slice_idx > 0
    n = x.shape[0]
    if q > 1 and n % q == 0 and m:
        nsub, m_sub = n // q, max(m // q, 64)
        sae = state.sae
        cxs, cys, masks, drops = [], [], [], []
        for k in range(q):
            sl = slice(k * nsub, (k + 1) * nsub)
            sae = update_sae(sae, x[sl], y[sl], t[sl], valid[sl])
            cx, cy, cv, dr = representative_candidates(x[sl], y[sl], valid[sl], m_sub, cfg)
            masks.append(detect_corners(sae, cx, cy, cv, cfg))
            cxs.append(cx)
            cys.append(cy)
            drops.append(dr)
        mask, cx, cy = torch.cat(masks), torch.cat(cxs), torch.cat(cys)
        dropped = torch.stack(drops).sum(dtype=torch.int32)
    else:
        sae = update_sae(state.sae, x, y, t, valid)
        if m and m < n:
            cx, cy, cv, dropped = representative_candidates(x, y, valid, m, cfg)
            mask = detect_corners(sae, cx, cy, cv, cfg)
        else:
            cx, cy, dropped = x, y, torch.zeros((), dtype=torch.int32, device=x.device)
            mask = detect_corners(sae, x, y, valid, cfg)
    mask = mask & armed
    n_corners = mask.sum(dtype=torch.int32)
    ccx, ccy, cvalid = compact(mask, cfg["nms"]["max_corners"], cx, cy)
    accepted, n_filtered = accept_corners(ccx.to(torch.int32), ccy.to(torch.int32),
                                          cvalid, cfg)
    fdt = state.tracks.pos.dtype
    tracks, groups = tracker_mod.update(state.tracks, ccx.to(fdt), ccy.to(fdt), accepted,
                                        cfg["tracker"])
    if counts is not None:
        counts.setdefault("raw_corners", []).append(int(n_corners))
        counts.setdefault("nms_corners", []).append(int(n_filtered))
        counts.setdefault("active_tracks", []).append(int(tracks.active.sum()))
        counts.setdefault("dropped_candidates", []).append(int(dropped))
    out = dict(num_corners=n_corners, num_filtered=n_filtered, num_dropped=dropped,
               track_active=tracks.active, track_label=tracks.label,
               track_pos=tracks.pos.float(), track_vel=tracks.velocity.float(),
               track_group=tracks.group_id, track_frames_since=tracks.frames_since,
               track_frame_count=tracks.frame_count, groups_exists=groups.exists,
               groups_centroid=groups.centroid.float(),
               groups_avg_velocity=groups.avg_velocity.float(),
               groups_radius=groups.radius.float(), groups_size=groups.size)
    return CornerState(sae=sae, tracks=tracks, slice_idx=state.slice_idx + 1), out


def cluster_step(state: FastState, x, y, valid, cfg, counts=None):
    """One slice of the cluster chain: (new state, output dict)."""
    mask, uniq, repeated = dedup_mask(x, y, valid, cfg)
    if cfg["dedup"]["compat_stride2"]:
        upos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        mask = mask & (upos % 2 == 0)
    state, (alive, reported, cid, n, centroid, flow) = fast_update(
        state, x, y, mask, cfg, counts)
    if counts is not None:
        counts.setdefault("unique_pixels", []).append(int(uniq))
        counts.setdefault("live_clusters", []).append(int(alive.sum()))
    return state, dict(unique_count=uniq, repeated_count=repeated, reported=reported,
                       cid=cid, n=n, centroid=centroid.float(),
                       flow=(flow * cfg["flow"]["extrapolation"]).float())
