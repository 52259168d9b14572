"""Exact AEClustering (counterpart of evflow_tpu/models/aeclustering.py).

The per-event asynchronous incremental clustering of AEClustering.cpp:47-118
on fixed-capacity state: a member ring of capacity M with per-member cluster
slots, C cluster slots with a creation-order key for deque order, EWMA means,
and a sliding window of the last sz_buffer update times.

- `update_event`: the eager form, one event with explicit forget.
- `update_slice`: one slice as a per-event loop over `_event_body`, with the
  window's tMin precomputed per lane (`_slice_prep`) and forget made lazy
  (a member is live iff its time >= tMin). It is the plain version of the
  CUDA kernel in `aeclustering_kernel.py`, and the engine wherever that
  kernel does not run (CPU tensors, kappa != 0, exact_pallas off).

Every field of `AEState` matches the JAX package's in name, order, shape and
dtype, so `interop` hands a state over in either direction. The loop is
branch-free on tensors: every write is gated by a mask, so it launches the
same ops whatever the data and never reads a value back to the host inside
the loop.

JAX semantics written out: `mode="drop"` scatters are masked first; the
first-index `argmax` of a bool vector is taken on an integer cast; `%` on
possibly negative int32 is floor-mod, as torch's `%` is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from evflow_tpu.config import ClusterConfig

_BIG = 2**31 - 1
_I32 = torch.int32
_F32 = torch.float32


class AEState(NamedTuple):
    t0: torch.Tensor            # int32 () relative-time origin
    has_t0: torch.Tensor        # bool ()
    tbuf: torch.Tensor          # int32 (W,) window of update times
    thead: torch.Tensor         # int32 () pushes so far
    mx: torch.Tensor            # int32 (M,) member ring
    my: torch.Tensor            # int32 (M,)
    mt: torch.Tensor            # int32 (M,) relative time
    mp: torch.Tensor            # int32 (M,) polarity
    mcid: torch.Tensor          # int32 (M,) cluster slot, -1 free
    alive: torch.Tensor         # bool (C,)
    corder: torch.Tensor        # int32 (C,) creation order (deque order key)
    cid: torch.Tensor           # int32 (C,) persistent cluster id
    mu: torch.Tensor            # float32 (C, 2) EWMA mean
    next_order: torch.Tensor    # int32 ()
    next_cid: torch.Tensor      # int32 ()
    event_id: torch.Tensor      # int32 () members appended so far
    last_updated: torch.Tensor  # int32 () slot of the last update, -1 none
    overflow: torch.Tensor      # int32 () dropped new-cluster count


def init_state(cfg: ClusterConfig = ClusterConfig(), device="cpu") -> AEState:
    w, m, c = cfg.sz_buffer, cfg.max_members, cfg.max_clusters

    def full(shape, v, dtype=_I32):
        return torch.full(shape, v, dtype=dtype, device=device)

    return AEState(
        t0=full((), 0), has_t0=full((), False, torch.bool),
        tbuf=full((w,), 0), thead=full((), 0),
        mx=full((m,), 0), my=full((m,), 0), mt=full((m,), 0), mp=full((m,), 0),
        mcid=full((m,), -1),
        alive=full((c,), False, torch.bool), corder=full((c,), _BIG),
        cid=full((c,), -1), mu=full((c, 2), 0.0, _F32),
        next_order=full((), 0), next_cid=full((), 0), event_id=full((), 0),
        last_updated=full((), -1), overflow=full((), 0))


def _at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-d index tensor, without reading i back to the host."""
    return a.index_select(0, i.long().reshape(1))[0]


def _set(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a with row i replaced by v (a new tensor)."""
    return a.index_copy(0, i.long().reshape(1), v.to(a.dtype).reshape(1, *a.shape[1:]))


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a bool vector (0 if none), as jnp.argmax."""
    return b.to(torch.uint8).argmax().to(_I32)


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with ONE rounding, as a fused multiply-add (b, c f32; a
    an f32 value). a*b is exact in f64; TwoSum gives the f64 sum's error;
    rounding that sum to odd, then to f32, rounds the exact value once."""
    p = b.double() * a
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).to(_F32)


def _ewma(mu: torch.Tensor, pix: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 - alpha) * mu + alpha * pix as XLA compiles JAX's jitted
    update_slice on the CPU: one FMA, fma(f32(1 - alpha), mu, f32(alpha *
    pix)). (JAX's eager update_event, and so the port's, rounds twice; the
    two agree whenever both products are exact, as at the default alpha =
    0.5.)"""
    return _fma(float(np.float32(1.0 - alpha)), mu, alpha * pix)


def _slot_ids(mcid: torch.Tensor, member: torch.Tensor, c: int) -> torch.Tensor:
    """Segment ids for per-cluster reductions: mcid for members, c for the rest."""
    return torch.where(member, mcid, c).long()


def _member_stats(mcid, mx, my, px, py, c: int):
    """Per-cluster valid-member counts and min member L1 distance."""
    member = mcid >= 0
    ids = _slot_ids(mcid, member, c)
    n_c = torch.zeros(c + 1, dtype=_I32, device=mcid.device).scatter_add(
        0, ids, member.to(_I32))[:c]
    d = ((mx - px).abs() + (my - py).abs()).to(_F32)
    d = torch.where(member, d, torch.inf)
    dmin_c = torch.full((c + 1,), torch.inf, device=mcid.device).scatter_reduce(
        0, ids, d, "amin")[:c]
    return n_c, dmin_c


def update_event(state: AEState, x, y, t_raw, p,
                 cfg: ClusterConfig = ClusterConfig()) -> AEState:
    """One AEClustering::update step (x, y, t_raw in µs, p: int32 scalars)."""
    dev = state.tbuf.device
    x, y, t_raw, p = (torch.as_tensor(v, dtype=_I32, device=dev)
                      for v in (x, y, t_raw, p))
    w, c, m = cfg.sz_buffer, cfg.max_clusters, cfg.max_members
    cids = torch.arange(c, dtype=_I32, device=dev)

    t0 = torch.where(state.has_t0, state.t0, t_raw)
    t = t_raw - t0

    # updateBuffer_: push t, window = last W entries, tMin = oldest kept
    tbuf = _set(state.tbuf, state.thead % w, t)
    thead = state.thead + 1
    tmin = _at(tbuf, (thead - torch.clamp_max(thead, w)) % w)

    # forget (permanent): members older than tMin are freed
    mcid = torch.where((state.mcid >= 0) & (state.mt >= tmin), state.mcid, -1)
    n_c, dmin_c = _member_stats(mcid, state.mx, state.my, x, y, c)
    empty = state.alive & (n_c == 0)
    live = state.alive & (n_c > 0)

    pix = torch.stack([x, y]).to(_F32)
    mu0 = state.mu
    dist_mu = (pix[0] - mu0[:, 0]).abs() + (pix[1] - mu0[:, 1]).abs()
    near = live & (dist_mu <= cfg.radius)
    if cfg.kappa == 0:
        assigned = near   # deployed default: the sampling branch never matches
    else:
        assigned = near | (live & ~near & (n_c > cfg.min_n) & (dmin_c <= cfg.radius))
    n_assigned = assigned.sum(dtype=_I32)
    any_assigned = n_assigned > 0

    # target = assigned cluster first in deque order (min creation order)
    target_assigned = torch.where(assigned, state.corder, _BIG).argmin().to(_I32)
    free = ~state.alive
    free_slot = _first_true(free)
    have_free = free.any()
    make_new = ~any_assigned & have_free
    overflow = state.overflow + (~any_assigned & ~have_free).to(_I32)
    target = torch.where(any_assigned, target_assigned, free_slot)
    do_add = any_assigned | make_new

    # add the member to the ring
    slot = state.event_id % m
    ring = []
    for field, v in ((state.mx, x), (state.my, y), (state.mt, t), (state.mp, p),
                     (mcid, target)):
        ring.append(_set(field, slot, torch.where(do_add, v, _at(field, slot))))
    mx, my, mt, mp, mcid = ring
    event_id = state.event_id + do_add.to(_I32)

    # cluster bookkeeping for the target
    is_first = torch.where(any_assigned, _at(n_c, target) == 0, True)
    mu_t = _at(mu0, target)
    # two roundings, as JAX's eager update_event computes it
    new_mu_t = torch.where(is_first, pix, (1.0 - cfg.alpha) * mu_t + cfg.alpha * pix)
    mu = _set(mu0, target, torch.where(do_add, new_mu_t, mu_t))
    alive = _set(state.alive, free_slot,
                 torch.where(make_new, True, _at(state.alive, free_slot)))
    corder = _set(state.corder, free_slot,
                  torch.where(make_new, state.next_order, _at(state.corder, free_slot)))
    cid = _set(state.cid, free_slot,
               torch.where(make_new, state.next_cid, _at(state.cid, free_slot)))
    next_order = state.next_order + make_new.to(_I32)
    next_cid = state.next_cid + make_new.to(_I32)

    # merge (>= 2 assigned): weighted mean (weights = post-add counts),
    # members reassigned to the target, the other assigned slots die
    do_merge = n_assigned >= 2
    n_post = n_c + (cids == target).to(_I32)
    wgt = torch.where(assigned, n_post.to(_F32), 0.0)
    merged_mu = (wgt[:, None] * mu).sum(0) / torch.clamp_min(wgt.sum(), 1.0)
    mu = torch.where((do_merge & (cids == target))[:, None], merged_mu[None, :], mu)
    mclip = mcid.clamp(0, c - 1).long()
    mcid = torch.where(do_merge & (mcid >= 0) & assigned[mclip], target, mcid)
    alive = torch.where(do_merge & assigned & (cids != target), False, alive)

    # remove empties (skipped on merge updates, AEClustering.cpp:104)
    alive = torch.where(~do_merge & empty, False, alive)

    # recycle dead slots
    dead = ~alive
    corder = torch.where(dead, _BIG, corder)
    mcid = torch.where((mcid >= 0) & dead[mcid.clamp(0, c - 1).long()], -1, mcid)

    return AEState(
        t0=t0, has_t0=torch.ones((), dtype=torch.bool, device=dev), tbuf=tbuf,
        thead=thead, mx=mx, my=my, mt=mt, mp=mp, mcid=mcid,
        alive=alive, corder=corder, cid=cid, mu=mu,
        next_order=next_order, next_cid=next_cid, event_id=event_id,
        last_updated=torch.where(do_add, target, -1), overflow=overflow)


def _slice_prep(state: AEState, x, y, t, p, valid, cfg: ClusterConfig):
    """Shared pre-loop work: relative times, the window's tMin for every
    lane, and the slice-end push-buffer update. Returns (x, y, tr, p, t0,
    has_any, tmin, tbuf, thead)."""
    w = cfg.sz_buffer
    n = x.shape[0]
    dev = x.device
    x, y, t_raw, p = (a.to(_I32) for a in (x, y, t, p))

    # t0 / relative times (t0 = first valid event's raw time)
    has_any = valid.any()
    t0 = torch.where(state.has_t0, state.t0, _at(t_raw, _first_true(valid)))
    tr = t_raw - t0

    # per-lane update index and precomputed tMin. timeline[j] = push time of
    # global update (thead - w + j), j in [0, w + n): update u was stored at
    # tbuf[u % w]
    upd = torch.cumsum(valid.to(_I32), 0, dtype=_I32) - 1
    gidx = state.thead + upd
    ar_w = torch.arange(w, dtype=_I32, device=dev)
    prev_times = state.tbuf[((state.thead - w + ar_w) % w).long()]
    # invalid lanes write into a spare slot n, cut off below
    slice_times = torch.zeros(n + 1, dtype=_I32, device=dev).scatter(
        0, torch.where(valid, upd, n).long(), torch.where(valid, tr, 0))[:n]
    timeline = torch.cat([prev_times, slice_times])
    tmin_gidx = torch.clamp_min(gidx - w + 1, 0)
    tmin = timeline[torch.clamp(tmin_gidx - state.thead + w, 0, w + n - 1).long()]

    # slice-end push buffer: only each slot's last writer lands; the others
    # write into a spare slot w, cut off below
    n_push = valid.sum(dtype=_I32)
    final_writer = valid & (upd >= n_push - w)
    tbuf = torch.cat([state.tbuf, state.tbuf[:1]]).scatter(
        0, torch.where(final_writer, gidx % w, w).long(),
        torch.where(final_writer, tr, 0))[:w]
    thead = state.thead + n_push
    return x, y, tr, p, t0, has_any, tmin, tbuf, thead


def _event_body(st, ev, cfg: ClusterConfig):
    """One per-event update on the loop carry (alive, corder, cid, mu, ring,
    next_order, next_cid, event_id, last_updated, overflow), ring = (5, M)
    rows [x, y, t, p, cid]. ev = 0-d tensors (x, y, t, p, valid, tmin)."""
    c, m = cfg.max_clusters, cfg.max_members
    (alive, corder, cid, mu, ring,
     next_order, next_cid, event_id, last_updated, overflow) = st
    xi, yi, ti, pi, vi, tmini = ev
    cids = torch.arange(c, dtype=_I32, device=mu.device)
    mcid = ring[4]

    # live members: not yet expired by the window
    live_m = (mcid >= 0) & (ring[2] >= tmini)
    ids = _slot_ids(mcid, live_m, c)
    n_c = torch.zeros(c + 1, dtype=_I32, device=mu.device).scatter_add(
        0, ids, live_m.to(_I32))[:c]
    empty = alive & (n_c == 0)
    live = alive & (n_c > 0)

    pix = torch.stack([xi, yi]).to(_F32)
    dist_mu = (pix[0] - mu[:, 0]).abs() + (pix[1] - mu[:, 1]).abs()
    near = live & (dist_mu <= cfg.radius)
    if cfg.kappa == 0:
        assigned = near   # deployed default: the sampling branch never matches
    else:
        d = ((ring[0] - xi).abs() + (ring[1] - yi).abs()).to(_F32)
        d = torch.where(live_m, d, torch.inf)
        dmin_c = torch.full((c + 1,), torch.inf, device=mu.device).scatter_reduce(
            0, ids, d, "amin")[:c]
        assigned = near | (live & ~near & (n_c > cfg.min_n) & (dmin_c <= cfg.radius))
    n_assigned = assigned.sum(dtype=_I32)
    any_assigned = n_assigned > 0

    target_assigned = torch.where(assigned, corder, _BIG).argmin().to(_I32)
    free = ~alive
    free_slot = _first_true(free)
    have_free = free.any()
    make_new = vi & ~any_assigned & have_free
    overflow = overflow + (vi & ~any_assigned & ~have_free).to(_I32)
    target = torch.where(any_assigned, target_assigned, free_slot)
    do_add = vi & (any_assigned | make_new)

    # one masked column write for the five member fields
    slot = (event_id % m).long().reshape(1)
    newcol = torch.stack([xi, yi, ti, pi, target]).reshape(5, 1)
    ring = ring.index_copy(1, slot, torch.where(do_add, newcol, ring.index_select(1, slot)))
    event_id = event_id + do_add.to(_I32)

    is_first = torch.where(any_assigned, _at(n_c, target) == 0, True)
    tgt_w = (cids == target) & do_add
    new_mu = torch.where(is_first, pix[None, :], _ewma(mu, pix[None, :], cfg.alpha))
    mu = torch.where(tgt_w[:, None], new_mu, mu)
    new_w = (cids == free_slot) & make_new
    alive = alive | new_w
    corder = torch.where(new_w, next_order, corder)
    cid = torch.where(new_w, next_cid, cid)
    next_order = next_order + make_new.to(_I32)
    next_cid = next_cid + make_new.to(_I32)

    # merge (>= 2 assigned): weighted mean, members to the target (by their
    # cluster before this event's write), the others die
    do_merge = vi & (n_assigned >= 2)
    n_post = n_c + (cids == target).to(_I32)
    wgt = torch.where(assigned, n_post.to(_F32), 0.0)
    merged_mu = (wgt[:, None] * mu).sum(0) / torch.clamp_min(wgt.sum(), 1.0)
    mu = torch.where((do_merge & (cids == target))[:, None], merged_mu[None, :], mu)
    member_in_assigned = (ring[4] >= 0) & (mcid >= 0) & assigned[mcid.clamp(0, c - 1).long()]
    ring = torch.cat([ring[:4], torch.where(do_merge & member_in_assigned, target,
                                            ring[4])[None]])
    alive = torch.where(do_merge & assigned & (cids != target), False, alive)

    # remove empties (skipped on merge updates, AEClustering.cpp:104)
    alive = torch.where(vi & ~do_merge & empty, False, alive)
    corder = torch.where(alive, corder, _BIG)

    last_updated = torch.where(vi, torch.where(do_add, target, -1), last_updated)
    return (alive, corder, cid, mu, ring,
            next_order, next_cid, event_id, last_updated, overflow)


def _carry0(state: AEState):
    ring0 = torch.stack([state.mx, state.my, state.mt, state.mp, state.mcid])
    return (state.alive, state.corder, state.cid, state.mu, ring0,
            state.next_order, state.next_cid, state.event_id,
            state.last_updated, state.overflow)


def _finalize(state: AEState, carry, t0, has_any, tmin, tbuf, thead, valid,
              cfg: ClusterConfig) -> AEState:
    """The state after the loop, with lazily forgotten members cleared so it
    equals the eager form's bit for bit."""
    c = cfg.max_clusters
    n = valid.shape[0]
    (alive, corder, cid, mu, ring,
     next_order, next_cid, event_id, last_updated, overflow) = carry
    mx, my, mt, mp, mcid = ring.unbind(0)
    last_valid = (n - 1) - _first_true(valid.flip(0))
    final_tmin = torch.where(has_any, _at(tmin, torch.where(has_any, last_valid, 0)),
                             torch.iinfo(torch.int32).min)
    mcid = torch.where((mcid >= 0) & (mt >= final_tmin), mcid, -1)
    # members of dead slots are expired or reassigned by construction; clear
    # the expired ones above, then drop any residue pointing at dead slots
    mcid = torch.where((mcid >= 0) & ~alive[mcid.clamp(0, c - 1).long()], -1, mcid)
    return AEState(
        t0=t0, has_t0=state.has_t0 | has_any, tbuf=tbuf, thead=thead,
        mx=mx.contiguous(), my=my.contiguous(), mt=mt.contiguous(),
        mp=mp.contiguous(), mcid=mcid, alive=alive, corder=corder, cid=cid,
        mu=mu, next_order=next_order, next_cid=next_cid, event_id=event_id,
        last_updated=last_updated, overflow=overflow)


def update_slice(state: AEState, x, y, t, p, valid,
                 cfg: ClusterConfig = ClusterConfig()) -> AEState:
    """One slice, event by event (masked lanes are no-ops): bit-equal to
    running `update_event` on each valid lane.

    The plain version of `aeclustering_kernel.update_slice_kernel`. The
    window's tMin of every lane depends only on push times, so it is
    precomputed; forget is lazy (a member is live iff mt >= tMin, and tMin
    is monotone); per-cluster counts are one scatter-add per event. Invalid
    lanes change nothing, so the loop visits the valid ones only: the mask
    is read back to the host once per slice."""
    x, y, tr, p, t0, has_any, tmin, tbuf, thead = _slice_prep(
        state, x, y, t, p, valid, cfg)
    evs = torch.stack([x, y, tr, p, tmin], 1)
    vflag = torch.ones((), dtype=torch.bool, device=x.device)
    carry = _carry0(state)
    for i in valid.cpu().nonzero().flatten().tolist():
        xi, yi, ti, pi, tmini = evs[i].unbind(0)
        carry = _event_body(carry, (xi, yi, ti, pi, vflag, tmini), cfg)
    return _finalize(state, carry, t0, has_any, tmin, tbuf, thead, valid, cfg)


def membership_digest(state: AEState, cfg: ClusterConfig = ClusterConfig()) -> torch.Tensor:
    """Order-independent per-cluster member-set fingerprint: the wrapping
    int32 sum of a per-member mix of (x, y, t)."""
    c = cfg.max_clusters
    member = state.mcid >= 0
    # int32 products wrap as XLA's do
    mix = state.mx * 131071 + state.my * 8191 + state.mt * 31 + 1
    return torch.zeros(c + 1, dtype=_I32, device=state.mx.device).scatter_add(
        0, _slot_ids(state.mcid, member, c), torch.where(member, mix, 0))[:c]


class ClusterView(NamedTuple):
    """Snapshot of live clusters (fixed shape, masked)."""
    alive: torch.Tensor      # bool (C,)
    cid: torch.Tensor        # int32 (C,)
    order: torch.Tensor      # int32 (C,) deque order key
    n: torch.Tensor          # int32 (C,)
    mu: torch.Tensor         # float32 (C, 2) EWMA mean
    centroid: torch.Tensor   # float32 (C, 2) arithmetic mean of live members


def snapshot(state: AEState, cfg: ClusterConfig = ClusterConfig()) -> ClusterView:
    c = cfg.max_clusters
    member = state.mcid >= 0
    ids = _slot_ids(state.mcid, member, c)
    zeros = torch.zeros(c + 1, dtype=_F32, device=state.mx.device)
    n_c = torch.zeros(c + 1, dtype=_I32, device=state.mx.device).scatter_add(
        0, ids, member.to(_I32))[:c]
    sx = zeros.scatter_add(0, ids, torch.where(member, state.mx, 0).to(_F32))[:c]
    sy = zeros.scatter_add(0, ids, torch.where(member, state.my, 0).to(_F32))[:c]
    denom = torch.clamp_min(n_c, 1).to(_F32)
    return ClusterView(alive=state.alive, cid=state.cid, order=state.corder,
                       n=n_c, mu=state.mu,
                       centroid=torch.stack([sx / denom, sy / denom], 1))
