"""End-to-end pipelines (counterpart of evflow_tpu/models/pipeline.py).

- cluster+flow (`cluster_flow_step`): hash dedup -> fast clustering ->
  centroid flow x extrapolation;
- exact cluster+flow (`cluster_flow_step_exact`, `cluster_flow_scan_exact`,
  `ClusterFlowPipeline(mode="exact")`): compacting hash dedup -> the exact
  per-event AEClustering engine (the update_slice_pallas kernel's CUDA
  counterpart on the card) -> flow per persistent cluster id;
- corner+track (`corner_track_step`): SAE scatter-max -> one representative
  candidate per touched pixel -> eFAST -> stream-order compaction -> NMS ->
  tracker; at q = 1 the tile-predicated stencil, at q > 1 (micro slices)
  per sub-slice scatter + detection;
- `corner_track_step_event_exact`: the per-event-exact detector, the
  reference semantics the q > 1 path is measured against;
- `full_scan`: both chains per slice over a slice sequence — the main path.

The JAX package's `lax.scan` over slices is an eager Python loop here.
Not ported yet (ROADMAP queue 1): the snapshot-stack q > 1 backend
(`micro_stack=True`).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from evflow_tpu.config import DEFAULT, EngineConfig
from evflow_tpu.io.events import EventStream
from evflow_tpu.io.slicing import slice_by_count, slice_by_time

from ..ops import efast, hash_dedup, nms as nms_ops, sae as sae_ops
from . import aeclustering, aeclustering_kernel, fastcluster, tracker as tracker_mod

_STACK_TODO = ("efast.micro_stack=True is not ported yet (ROADMAP queue 1, still "
               "to port, item 1: the snapshot-stack q>1 backend)")


def _as_tensors(device, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


def _stack(outs: Sequence[NamedTuple]):
    """Stack per-slice outputs along a new leading axis, as lax.scan does."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*[_stack([o[i] for o in outs]) for i in range(len(first))])
    return torch.stack([torch.as_tensor(o) for o in outs])


def _to_cpu(out):
    if isinstance(out, tuple):
        return type(out)(*[_to_cpu(o) for o in out])
    return out.cpu()


# --------------------------------------------------------------------------
# cluster + flow
# --------------------------------------------------------------------------

class ClusterFlowOutput(NamedTuple):
    unique_count: torch.Tensor    # int32 ()
    repeated_count: torch.Tensor  # int32 ()
    reported: torch.Tensor        # bool (C,)
    cid: torch.Tensor             # int32 (C,)
    n: torch.Tensor               # int32 (C,)
    centroid: torch.Tensor        # float32 (C, 2)
    flow: torch.Tensor            # float32 (C, 2) extrapolated displacement


def cluster_flow_step(state: fastcluster.FastState, x: torch.Tensor,
                      y: torch.Tensor, valid: torch.Tensor,
                      cfg: EngineConfig = DEFAULT
                      ) -> Tuple[fastcluster.FastState, ClusterFlowOutput]:
    """One slice of the flagship pipeline (fast mode). The first-occupant
    mask is the clustering's validity, so labels index input events."""
    ded = hash_dedup.dedup_mask(x, y, valid, cfg.dedup, cfg.sensor)
    uvalid = ded.unique_mask
    if cfg.dedup.compat_stride2:
        # the reference consumes every 2nd unique coordinate
        upos = torch.cumsum(uvalid.to(torch.int32), 0, dtype=torch.int32) - 1
        uvalid = uvalid & (upos % 2 == 0)
    state, out = fastcluster.update_slice(state, x, y, uvalid, cfg.cluster,
                                          cfg.sensor)
    return state, ClusterFlowOutput(
        unique_count=ded.unique_count, repeated_count=ded.repeated_count,
        reported=out.reported, cid=out.cid, n=out.n, centroid=out.centroid,
        flow=out.flow * cfg.flow.extrapolation)


def cluster_flow_scan(state, xs, ys, valids, cfg: EngineConfig = DEFAULT):
    """All slices in order: (final state, stacked ClusterFlowOutput)."""
    outs = []
    for s in range(xs.shape[0]):
        state, out = cluster_flow_step(state, xs[s], ys[s], valids[s], cfg)
        outs.append(out)
    return state, _stack(outs)


@dataclasses.dataclass
class ClusterFlowPipeline:
    cfg: EngineConfig = DEFAULT
    mode: str = "fast"   # "fast" | "exact" (the per-event engine)
    device: str = "cpu"

    def init_state(self):
        if self.mode == "exact":
            # (engine, cum_unique, per-lane flow memory keyed by cid), as the
            # JAX package carries it, so flow survives a resume split
            c = self.cfg.cluster.max_clusters
            return (aeclustering.init_state(self.cfg.cluster, device=self.device),
                    torch.zeros((), dtype=torch.int32, device=self.device),
                    torch.full((c,), -1, dtype=torch.int32, device=self.device),
                    torch.zeros((c, 2), dtype=torch.float32, device=self.device))
        return fastcluster.init_state(self.cfg.cluster, device=self.device)

    def run(self, stream: EventStream, state=None,
            t0: Optional[int] = None) -> List[ClusterFlowOutput]:
        """Iterate recorded slices; per-slice outputs come back on the CPU.
        `self.final_state` afterwards is the state to resume from. In exact
        mode `t0` rebases the engine clock (the stream's first time by
        default; keep `self.t0` to resume); fast mode ignores it."""
        cfg = self.cfg
        if cfg.slicing.mode == "n_us":
            slices = slice_by_time(stream, cfg.slicing.n_us, cfg.slicing.n_events)
        else:
            slices = slice_by_count(stream, cfg.slicing.n_events)
        if state is None:
            state = self.init_state()
        if self.mode == "exact":
            return self._run_exact(slices, state, stream, t0)
        xs, ys, vs = _as_tensors(self.device, slices.x, slices.y, slices.valid_mask())
        outs = []
        for s in range(slices.num_slices):
            state, out = cluster_flow_step(state, xs[s], ys[s], vs[s], cfg)
            outs.append(_to_cpu(out))
        self.final_state = state
        return outs

    def _run_exact(self, slices, state, stream: EventStream,
                   t0: Optional[int]) -> List[ClusterFlowOutput]:
        """cluster_flow_scan_exact over all slices, times rebased by t0."""
        if t0 is None:
            t0 = int(stream.t[0]) if len(stream) else 0
        self.t0 = t0
        if slices.num_slices == 0:
            self.final_state = state
            return []
        ts_rel = (slices.t.astype(np.int64) - t0).astype(np.int32)
        xs, ys, ts, vs = _as_tensors(self.device, slices.x, slices.y, ts_rel,
                                     slices.valid_mask())
        self.final_state, outs = cluster_flow_scan_exact(state, xs, ys, ts, vs, self.cfg)
        outs = _to_cpu(outs)
        return [ClusterFlowOutput(*[leaf[s] for leaf in outs])
                for s in range(slices.num_slices)]


# --------------------------------------------------------------------------
# exact cluster + flow
# --------------------------------------------------------------------------

def cluster_flow_step_exact(state: aeclustering.AEState, x: torch.Tensor,
                            y: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                            cfg: EngineConfig = DEFAULT, cum_unique=None):
    """One slice of the exact path: returns (state, ClusterView,
    new_cum_unique).

    The unique coordinates, compacted in stream order, feed the engine
    (`exact_engine_lanes`); in hash mode at most num_buckets of them exist,
    so the lanes are cut there. Every unique lane carries the slice's latest
    valid time, or, with cfg.dedup.compat_fabricated_ts, the cumulative
    unique count (the reference's uniqueCount/1000.0 clock, exact as a count
    since the window only compares clock values).

    Engine: the update_slice_pallas kernel's counterpart
    (`aeclustering_kernel.update_slice_kernel`) when exact_pallas and kappa
    == 0, which on CPU tensors runs the plain version; otherwise the plain
    `aeclustering.update_slice`. exact_block > 0 takes the same engine: the
    JAX package's update_slice_blocked is bit-equal to update_slice by its
    own tests, so the port has no blocked form (exact_pallas_interpret,
    a JAX interpret-mode switch, likewise changes nothing here)."""
    lanes, new_cum = exact_engine_lanes(x, y, t, valid, cfg, cum_unique)
    if cfg.cluster.exact_pallas and cfg.cluster.kappa == 0:
        state = aeclustering_kernel.update_slice_kernel(state, *lanes, cfg.cluster)
    else:
        state = aeclustering.update_slice(state, *lanes, cfg.cluster)
    return state, aeclustering.snapshot(state, cfg.cluster), new_cum


def exact_engine_lanes(x, y, t, valid, cfg: EngineConfig = DEFAULT, cum_unique=None):
    """The exact engine's input for one slice, ((x, y, t, p, valid) lanes,
    new_cum_unique): the unique coordinates in stream order, cut at
    num_buckets in hash mode, each stamped with the slice's latest valid
    time or, with compat_fabricated_ts, the cumulative unique count."""
    ded = hash_dedup.dedup(x, y, valid, cfg.dedup, cfg.sensor)
    ux, uy = ded.unique_x, ded.unique_y
    if not cfg.dedup.exact and cfg.dedup.num_buckets < x.shape[0]:
        ux = ux[:cfg.dedup.num_buckets]
        uy = uy[:cfg.dedup.num_buckets]
    uvalid = torch.arange(ux.shape[0], device=x.device) < ded.unique_count
    if cum_unique is None:
        cum_unique = torch.zeros((), dtype=torch.int32, device=x.device)
    new_cum = cum_unique + ded.unique_count
    if cfg.dedup.compat_fabricated_ts:
        tt = torch.where(uvalid, new_cum, 0)
    else:
        tt = torch.where(uvalid, torch.where(valid, t, 0).amax(), 0)
    return (ux, uy, tt.to(torch.int32), torch.zeros_like(ux), uvalid), new_cum


def cluster_flow_scan_exact(state, xs, ys, ts, valids, cfg: EngineConfig = DEFAULT):
    """The exact path over all slices with the cid-keyed flow memory:
    state = (AEState, cum_unique, prev_cid, prev_centroid). Returns (final
    state, stacked ClusterFlowOutput). A flow is reported only where the
    same cluster (same cid on the lane) was reported before: the engine
    reuses lanes within a slice, so occupancy alone would pair a new cluster
    with a dead occupant's centroid."""
    min_n = cfg.cluster.min_n
    extrap = cfg.flow.extrapolation
    ae_state, cum, prev_cid, prev_cent = state
    outs = []
    for s in range(xs.shape[0]):
        ae_state, view, new_cum = cluster_flow_step_exact(
            ae_state, xs[s], ys[s], ts[s], valids[s], cfg, cum)
        uniq = new_cum - cum
        reported = view.alive & (view.n >= min_n)
        same = reported & (prev_cid == view.cid) & (prev_cid >= 0)
        flow = torch.where(same[:, None], (view.centroid - prev_cent) * extrap, 0.0)
        prev_cent = torch.where(reported[:, None], view.centroid, prev_cent)
        prev_cid = torch.where(reported, view.cid,
                               torch.where(view.alive, prev_cid, -1)).to(torch.int32)
        outs.append(ClusterFlowOutput(
            unique_count=uniq, repeated_count=valids[s].sum(dtype=torch.int32) - uniq,
            reported=reported, cid=view.cid, n=view.n, centroid=view.centroid,
            flow=flow.to(torch.float32)))
        cum = new_cum
    return (ae_state, cum, prev_cid, prev_cent), _stack(outs)


# --------------------------------------------------------------------------
# corner + track
# --------------------------------------------------------------------------

class CornerTrackState(NamedTuple):
    sae: torch.Tensor
    tracks: tracker_mod.TrackState
    slice_idx: torch.Tensor   # int32 () — detection starts after first slice


class CornerTrackOutput(NamedTuple):
    num_corners: torch.Tensor     # int32 () raw eFAST detections
    num_filtered: torch.Tensor    # int32 () after NMS
    track_active: torch.Tensor    # bool (T,)
    track_label: torch.Tensor     # int32 (T,)
    track_pos: torch.Tensor       # float32 (T, 2)
    track_vel: torch.Tensor       # float32 (T, 2)
    track_group: torch.Tensor     # int32 (T,)
    groups: tracker_mod.GroupView
    # touched pixels beyond cfg.efast.max_candidates, dropped in stream order
    num_dropped: torch.Tensor = np.int32(0)          # int32 ()
    # renderer fields (group_track.cpp:592,615-617)
    track_frames_since: torch.Tensor = np.int32(-1)  # int32 (T,)
    track_frame_count: torch.Tensor = np.int32(-1)   # int32 (T,)


def init_corner_state(cfg: EngineConfig = DEFAULT, device="cpu") -> CornerTrackState:
    return CornerTrackState(
        sae=sae_ops.init_sae(cfg.sensor, device=device),
        tracks=tracker_mod.init_state(cfg.tracker, device=device),
        slice_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _corners_to_tracks(corner_mask, x, y, state: CornerTrackState, new_sae,
                       cfg: EngineConfig, n_dropped=None):
    """Compact the detected corners in stream order to the NMS capacity,
    suppress, and advance the tracker on the accepted candidate lanes."""
    n_corners = corner_mask.sum(dtype=torch.int32)
    cx, cy, cvalid = nms_ops.compact(corner_mask, cfg.nms.max_corners, x, y)
    accepted, n_filtered = nms_ops.accept_corners(cx, cy, cvalid, cfg.nms)
    tracks, groups = tracker_mod.update(
        state.tracks, cx.to(torch.float32), cy.to(torch.float32), accepted,
        cfg.tracker)
    if n_dropped is None:
        n_dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    out = CornerTrackOutput(
        num_corners=n_corners, num_filtered=n_filtered,
        track_active=tracks.active, track_label=tracks.label,
        track_pos=tracks.pos, track_vel=tracks.velocity,
        track_group=tracks.group_id, groups=groups, num_dropped=n_dropped,
        track_frames_since=tracks.frames_since,
        track_frame_count=tracks.frame_count)
    return CornerTrackState(sae=new_sae, tracks=tracks,
                            slice_idx=state.slice_idx + 1), out


def _representative_candidates(x, y, valid, m, cfg: EngineConfig):
    """One representative lane per touched pixel — the pixel's LAST event in
    stream order, which carries its newest timestamp — compacted in stream
    order to m lanes. Returns (cx, cy, cvalid, n_dropped)."""
    n = x.shape[0]
    w1 = cfg.sensor.width + 1
    off = w1 * (cfg.sensor.height + 1)
    lane = torch.arange(n, dtype=torch.int64, device=x.device)
    pixkey = torch.where(valid, y * w1 + x, off).to(torch.int64)
    # (pixel, reversed lane) as one int64 key: each pixel's last lane first
    order = torch.sort(pixkey * n + (n - 1 - lane)).indices
    skey = pixkey[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       skey[1:] != skey[:-1]]) & (skey < off)
    n_rep = first.sum(dtype=torch.int32)
    keep = torch.zeros(n, dtype=torch.bool, device=x.device).scatter(0, order, first)
    cx, cy, cvalid = nms_ops.compact(keep, m, x, y)
    return cx, cy, cvalid, torch.clamp_min(n_rep - m, 0)


def corner_track_step(state: CornerTrackState, x: torch.Tensor, y: torch.Tensor,
                      t: torch.Tensor, valid: torch.Tensor,
                      cfg: EngineConfig = DEFAULT
                      ) -> Tuple[CornerTrackState, CornerTrackOutput]:
    """One slice of the corner pipeline. Detection is skipped on the first
    slice.

    q = 1 (slice-synchronous): the whole slice is scattered into the SAE
    first, then every touched pixel is tested once against it. With q =
    micro_slices > 1, N % q == 0 and a candidate cap, the slice is split
    into q sub-slices in order, each scattered and then detected against
    the surface so far (at most one sub-slice of "future" writes per
    detection); other shapes take the q = 1 path, as in JAX."""
    m = cfg.efast.max_candidates
    q = cfg.efast.micro_slices
    armed = state.slice_idx > 0
    if q > 1 and x.shape[0] % q == 0 and m:
        return _micro_step(state, x, y, t, valid, armed, cfg)
    new_sae = sae_ops.update_sae(state.sae, x, y, t, valid)
    if m and m < x.shape[0]:
        cx, cy, cvalid, n_dropped = _representative_candidates(x, y, valid, m, cfg)
        if cfg.efast.dense_detect:
            corner_mask = efast.detect_corners_dense(
                new_sae, ev_y=cy, ev_valid=cvalid, x=cx, y=cy, valid=cvalid,
                cfg=cfg.efast, sensor=cfg.sensor, ev_x=cx)
        else:
            corner_mask = efast.detect_corners(new_sae, cx, cy, cvalid,
                                               cfg.efast, cfg.sensor)
        return _corners_to_tracks(corner_mask & armed, cx, cy, state, new_sae,
                                  cfg, n_dropped)
    corner_mask = efast.detect_corners(new_sae, x, y, valid, cfg.efast, cfg.sensor)
    return _corners_to_tracks(corner_mask & armed, x, y, state, new_sae, cfg)


def _micro_step(state: CornerTrackState, x, y, t, valid, armed, cfg: EngineConfig):
    """The q > 1 serial micro-slice path: per sub-slice, update the SAE,
    pick at most max(m // q, 64) representative candidates, detect them
    against the surface so far (the per-candidate ring gather, or with
    micro_dense the tile-predicated stencil); then the candidates of all
    sub-slices, in order, go to NMS and the tracker."""
    q = cfg.efast.micro_slices
    if cfg.efast.micro_stack and not cfg.efast.micro_dense:
        raise NotImplementedError(_STACK_TODO)
    nsub = x.shape[0] // q
    m_sub = max(cfg.efast.max_candidates // q, 64)
    sae = state.sae
    cxs, cys, masks, drops = [], [], [], []
    for k in range(q):
        sl = slice(k * nsub, (k + 1) * nsub)
        sx, sy, sv = x[sl], y[sl], valid[sl]
        sae = sae_ops.update_sae(sae, sx, sy, t[sl], sv)
        scx, scy, scv, sdrop = _representative_candidates(sx, sy, sv, m_sub, cfg)
        if cfg.efast.micro_dense:
            mask = efast.detect_corners_dense(sae, sy, sv, scx, scy, scv,
                                              cfg.efast, cfg.sensor, ev_x=sx)
        else:
            mask = efast.detect_corners(sae, scx, scy, scv, cfg.efast, cfg.sensor)
        cxs.append(scx)
        cys.append(scy)
        masks.append(mask)
        drops.append(sdrop)
    corner_mask = torch.cat(masks) & armed
    return _corners_to_tracks(corner_mask, torch.cat(cxs), torch.cat(cys), state,
                              sae, cfg, torch.stack(drops).sum(dtype=torch.int32))


def corner_track_step_event_exact(state: CornerTrackState, x: torch.Tensor,
                                  y: torch.Tensor, t: torch.Tensor,
                                  valid: torch.Tensor, cfg: EngineConfig = DEFAULT
                                  ) -> Tuple[CornerTrackState, CornerTrackOutput]:
    """Per-event-exact corner path — the reference's semantics
    (group_track.cpp:884-1070): each event in stream order writes
    `sae.at(y, x) = t` and is then tested against the evolving surface.
    Meant for validation; the slice-synchronous step is the throughput
    path."""
    new_sae, corner_mask = event_exact_corner_mask(
        state.sae, x, y, t, valid, state.slice_idx > 0, cfg)
    return _corners_to_tracks(corner_mask, x, y, state, new_sae, cfg)


def event_exact_corner_mask(sae: torch.Tensor, x, y, t, valid, armed,
                            cfg: EngineConfig = DEFAULT):
    """The event-exact detector: (new SAE, (N,) corner mask), equal to
    scanning the events in order, each writing its pixel and then running
    eFAST on the 9x9 patch at its pixel.

    Vectorized instead of scanned: the value event i sees at ring pixel q is
    the time of the last valid event j <= i that wrote q (a write is a set,
    the last writer wins), else the surface before the slice. One sort of
    the written (pixel, lane) keys and a binary search per (event, ring
    point) find j. As JAX's dynamic_slice does, the patch's start is clamped
    into the surface, so near the border the patch shifts rather than
    being cut; the ring offsets follow group_track_axis_order."""
    h, w = sae.shape
    n = x.shape[0]
    dev = sae.device
    cs = cfg.efast.border
    dy, dx = efast._ring_offsets(cfg.efast)
    dy = torch.tensor(dy, dtype=torch.int64, device=dev)
    dx = torch.tensor(dx, dtype=torch.int64, device=dev)
    x64, y64 = x.long(), y.long()

    # writes: masked out-of-range lanes dropped, negative indices wrapped
    # once (JAX mode="drop")
    yi, oky = sae_ops.drop_index(torch.where(valid, y64, h), h)
    xi, okx = sae_ops.drop_index(x64, w)
    writes = valid & oky & okx
    wpix = torch.where(writes, yi * w + xi, h * w)           # h*w: no write
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    keys, order = torch.sort(wpix * n + lane)
    wt = t.to(sae.dtype)[order]

    # ring pixels of each event's (start-clamped) 9x9 patch
    y0 = torch.clamp(y64 - 4, 0, h - 9)
    x0 = torch.clamp(x64 - 4, 0, w - 9)
    qpix = (y0[:, None] + 4 + dy[None, :]) * w + (x0[:, None] + 4 + dx[None, :])
    # last write to qpix by a lane <= i
    pos = torch.searchsorted(keys, qpix * n + lane[:, None], right=True) - 1
    posc = pos.clamp_min(0)
    hit = (pos >= 0) & (keys[posc] // n == qpix)
    ring = torch.where(hit, wt[posc], sae.reshape(-1)[qpix])   # (N, 36)

    n3 = len(efast.CIRCLE3)
    f3 = efast._streak_any(ring[:, :n3], cfg.efast.streak3_min, cfg.efast.streak3_max)
    f4 = efast._streak_any(ring[:, n3:], cfg.efast.streak4_min, cfg.efast.streak4_max)
    in_b = valid & armed & (x >= cs) & (x < w - cs) & (y >= cs) & (y < h - cs)

    # the final surface: each written pixel's last writer
    last = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, wpix, torch.where(writes, lane, -1), "amax")[:h * w]
    new_sae = torch.where(last >= 0, t.to(sae.dtype)[last.clamp_min(0)], sae.reshape(-1))
    return new_sae.reshape(h, w), in_b & f3 & f4


def corner_track_scan(state, xs, ys, ts, valids, cfg: EngineConfig = DEFAULT):
    """All slices in order: (final state, stacked CornerTrackOutput)."""
    outs = []
    for s in range(xs.shape[0]):
        state, out = corner_track_step(state, xs[s], ys[s], ts[s], valids[s], cfg)
        outs.append(out)
    return state, _stack(outs)


@dataclasses.dataclass
class CornerTrackPipeline:
    cfg: EngineConfig = DEFAULT
    device: str = "cpu"

    def run(self, stream: EventStream, state: Optional[CornerTrackState] = None,
            t0: Optional[int] = None) -> List[CornerTrackOutput]:
        """Iterate recorded slices; per-slice outputs come back on the CPU.
        Times are rebased by `t0` (the stream's first time by default) so the
        int32 SAE never wraps; `self.final_state` and `self.t0` are what a
        resume needs."""
        cfg = self.cfg
        slices = slice_by_count(stream, cfg.slicing.n_events)
        if t0 is None:
            t0 = int(stream.t[0]) if len(stream) else 0
        if state is None:
            state = init_corner_state(cfg, device=self.device)
        xs, ys, ts, vs = _as_tensors(self.device, slices.x, slices.y,
                                     (slices.t - t0).astype(np.int32),
                                     slices.valid_mask())
        outs = []
        for s in range(slices.num_slices):
            state, out = corner_track_step(state, xs[s], ys[s], ts[s], vs[s], cfg)
            outs.append(_to_cpu(out))
        self.final_state = state
        self.t0 = t0
        return outs


# --------------------------------------------------------------------------
# both chains
# --------------------------------------------------------------------------

def full_scan(cl_state, co_state, xs, ys, ts, valids, cfg: EngineConfig = DEFAULT):
    """Both pipelines per slice over (S, N) slices: returns
    ((cl_state, co_state), (stacked ClusterFlowOutput, stacked
    CornerTrackOutput)), the shape of the JAX package's full_scan."""
    cl_outs, co_outs = [], []
    for s in range(xs.shape[0]):
        cl_state, cl_out = cluster_flow_step(cl_state, xs[s], ys[s], valids[s], cfg)
        co_state, co_out = corner_track_step(co_state, xs[s], ys[s], ts[s],
                                             valids[s], cfg)
        cl_outs.append(cl_out)
        co_outs.append(co_out)
    return (cl_state, co_state), (_stack(cl_outs), _stack(co_outs))
